// Fused LeakyReLU + grouped PixelNorm for NCHW tensors, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pair in neuron_gan_tpu/ops/pallas_kernels.py
// (_grouped_fwd_kernel and _grouped_bwd_kernel).  Computes, for each pixel
// and each group of C_g = C / n_groups contiguous channels:
//
//   forward:  y = lrelu(x);  out = y * rsqrt(sum_g(y^2) / C_g + eps)
//   backward: r = rsqrt(sum_g(y^2) / C_g + eps);  s = sum_g(g * y)
//             dx = lrelu'(x) * (g * r - y * r^3 * s / C_g)
//
// Statistics in float32 whatever the storage type (float or bfloat16).
//
// Bound: bytes.  The forward reads x once and writes out once; the
// backward reads x and g once and writes dx once.  At (8, 16, 512, 512)
// float32 that is 268 MB and 403 MB, about 80 us and 120 us at the H100's
// 3.35 TB/s; the arithmetic is a few operations per byte.
//
// Design: one thread per (batch, pixel).  The thread walks its channels at
// stride H*W, so the 32 threads of a warp read 32 adjacent pixels of one
// channel: every load and store is coalesced without a transpose, and the
// channel reduction needs no shared memory and no cross-thread step.  Each
// group is walked twice (statistics, then output); the second walk finds
// the thread's values in L1.  Indices are 64-bit.
//
// Entry points have a plain C interface (loaded with ctypes); each returns
// the cudaError_t of its launch, 0 on success.  They launch on the stream
// they are given and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.0f ? v : v * slope;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrelu_pn_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                    int64_t n_pix, int64_t hw, int64_t channels,
                    int64_t group, float slope, float eps) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const int64_t b = p / hw;
  const int64_t base = b * channels * hw + (p - b * hw);
  const float fgroup = (float)group;
  for (int64_t c0 = 0; c0 < channels; c0 += group) {
    float ss = 0.0f;
    for (int64_t c = c0; c < c0 + group; ++c) {
      const float y = lrelu(load_f32(x + base + c * hw), slope);
      ss += y * y;
    }
    const float r = rsqrtf(ss / fgroup + eps);
    for (int64_t c = c0; c < c0 + group; ++c) {
      const int64_t i = base + c * hw;
      store_f32(out + i, lrelu(load_f32(x + i), slope) * r);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrelu_pn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    T* __restrict__ dx, int64_t n_pix, int64_t hw,
                    int64_t channels, int64_t group, float slope, float eps) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const int64_t b = p / hw;
  const int64_t base = b * channels * hw + (p - b * hw);
  const float fgroup = (float)group;
  for (int64_t c0 = 0; c0 < channels; c0 += group) {
    float ss = 0.0f, sg = 0.0f;
    for (int64_t c = c0; c < c0 + group; ++c) {
      const int64_t i = base + c * hw;
      const float y = lrelu(load_f32(x + i), slope);
      ss += y * y;
      sg += load_f32(g + i) * y;
    }
    const float r = rsqrtf(ss / fgroup + eps);
    const float k = r * r * r * (sg / fgroup);
    for (int64_t c = c0; c < c0 + group; ++c) {
      const int64_t i = base + c * hw;
      const float xv = load_f32(x + i);
      const float dy = load_f32(g + i) * r - lrelu(xv, slope) * k;
      store_f32(dx + i, xv >= 0.0f ? dy : dy * slope);
    }
  }
}

// dtype codes shared with ops/lrelu_pixel_norm.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

bool bad_shape(int64_t batch, int64_t channels, int64_t hw, int64_t n_groups,
               int64_t* blocks) {
  if (batch < 0 || channels <= 0 || hw < 0 || n_groups <= 0 ||
      channels % n_groups != 0)
    return true;
  *blocks = (batch * hw + kThreads - 1) / kThreads;
  return *blocks > 0x7fffffff;
}

}  // namespace

extern "C" int lrelu_pixel_norm_fwd(const void* x, void* out, int64_t batch,
                                    int64_t channels, int64_t hw,
                                    int64_t n_groups, float slope, float eps,
                                    int dtype, void* stream) {
  int64_t blocks = 0;
  if (bad_shape(batch, channels, hw, n_groups, &blocks))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  const int64_t n_pix = batch * hw, group = channels / n_groups;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32) {
    lrelu_pn_fwd_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)x, (float*)out, n_pix, hw, channels, group, slope, eps);
  } else if (dtype == kBFloat16) {
    lrelu_pn_fwd_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)out, n_pix, hw, channels,
        group, slope, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int lrelu_pixel_norm_bwd(const void* x, const void* g, void* dx,
                                    int64_t batch, int64_t channels,
                                    int64_t hw, int64_t n_groups, float slope,
                                    float eps, int dtype, void* stream) {
  int64_t blocks = 0;
  if (bad_shape(batch, channels, hw, n_groups, &blocks))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  const int64_t n_pix = batch * hw, group = channels / n_groups;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32) {
    lrelu_pn_bwd_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)x, (const float*)g, (float*)dx, n_pix, hw, channels,
        group, slope, eps);
  } else if (dtype == kBFloat16) {
    lrelu_pn_bwd_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (__nv_bfloat16*)dx,
        n_pix, hw, channels, group, slope, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
