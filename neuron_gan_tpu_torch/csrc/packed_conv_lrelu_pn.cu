// Fused packed conv3x3 + LeakyReLU + 4-group PixelNorm (forward), and the
// one-pass dz of its backward, for NCHW float32 tensors on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pair in neuron_gan_tpu/ops/pallas_conv.py:
// _fwd_kernel (launched by _call_fwd) and _dz_kernel (launched by
// _dz_call).  The input is a space-to-depth packed activation, so its N
// output channels are 4 parity groups of C = N / 4 original channels.
//
//   forward:  z = conv3x3(x, W) (zero padding 1, float32 accumulation)
//             u = lrelu(z);  r_g = rsqrt(sum_{c in g} u_c^2 / C + eps)
//             y = u * r_g  (B, N, H, W);  r (B, 4, H, W)
//   dz:       s = r_g;  u = y / s;  t = sum_{c in g} ct_y * u + ct_r_g
//             dz = lrelu'(u) * (ct_y * s - u * s^3 * t / C)
//
// The pre-activation z never reaches device memory: the backward rebuilds
// u from (y, r), and dx / dw come from the conv's own adjoints outside.
//
// Bound.  The forward is bound by its operations: 2 * 9 * K * N FLOP per
// output pixel against (K + N + 4) * 4 bytes of activations.  At the
// largest shape of the training path, x (8, 64, 256, 256), that is 38.7
// GFLOP (0.58 ms at the H100's 67 TFLOP/s of float32 outside the tensor
// cores) against 277 MB (0.083 ms at 3.35 TB/s).  The dz kernel is bound
// by its bytes (y, ct_y and dz once each, r and ct_r once each): 419 MB,
// 0.125 ms at that shape.
//
// Forward design: one thread owns one output pixel and one parity group,
// so its C accumulators (16 or 32 on the training path) and that group's
// PixelNorm stay in registers.  A block is an 8 x 32 tile of output pixels
// of one group of one image (one warp per tile row); over chunks of 8
// input channels it stages the input tile with its 1-pixel halo (zeros
// outside the image) and the group's slice of the weights in shared
// memory.  Weights arrive pre-transposed to (K, 3, 3, N), so a group's C
// weights of one tap are contiguous: each thread reads them as float4,
// the same address across the warp (a broadcast), and the input pixel
// with stride 1 across the warp (no bank conflict).  w_packed is 3/4
// zeros by construction; this kernel multiplies them like any weight.
// The card's float32 FMA pipes do the work, not the tensor cores.
//
// dz design: one thread per (batch, pixel), walking each group's channels
// at stride H*W twice (the sum t, then dz), as the LeakyReLU+PixelNorm
// backward kernel does: every access is coalesced across the warp.
//
// Entry points have a plain C interface (loaded with ctypes); each returns
// the cudaError_t of its launch, 0 on success.  They launch on the stream
// they are given and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kConvThreads = kTileH * kTileW;
constexpr int kChunk = 8;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kDzThreads = 256;

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.0f ? v : v * slope;
}

template <int C>
__global__ void __launch_bounds__(kConvThreads)
packed_conv_fwd_kernel(const float* __restrict__ x,   // (B, K, H, W)
                       const float* __restrict__ wt,  // (K, 3, 3, 4C)
                       float* __restrict__ y,         // (B, 4C, H, W)
                       float* __restrict__ r,         // (B, 4, H, W)
                       int k_in, int height, int width, int tiles_w,
                       float slope, float eps) {
  static_assert(C % 4 == 0, "C must be a multiple of 4 (float4 weights)");
  constexpr int N = 4 * C;
  __shared__ float xs[kChunk][kHaloH][kHaloW];
  __shared__ __align__(16) float ws[kChunk][9][C];

  const int group = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / kTileW;
  const int tx = threadIdx.x % kTileW;
  const int oy0 = (blockIdx.x / tiles_w) * kTileH;
  const int ox0 = (blockIdx.x % tiles_w) * kTileW;
  const int64_t hw = (int64_t)height * width;
  const float* xb = x + (int64_t)b * k_in * hw;

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  for (int k0 = 0; k0 < k_in; k0 += kChunk) {
    // input tile with halo; zeros outside the image and past the last
    // channel, so the inner loop needs no bounds
    for (int i = threadIdx.x; i < kChunk * kHaloH * kHaloW;
         i += kConvThreads) {
      const int kk = i / (kHaloH * kHaloW);
      const int rem = i - kk * (kHaloH * kHaloW);
      const int hy = rem / kHaloW;
      const int hx = rem - hy * kHaloW;
      const int iy = oy0 - 1 + hy;
      const int ix = ox0 - 1 + hx;
      float v = 0.0f;
      if (k0 + kk < k_in && iy >= 0 && iy < height && ix >= 0 && ix < width)
        v = xb[(int64_t)(k0 + kk) * hw + (int64_t)iy * width + ix];
      xs[kk][hy][hx] = v;
    }
    for (int i = threadIdx.x; i < kChunk * 9 * C; i += kConvThreads) {
      const int kk = i / (9 * C);
      const int rem = i - kk * (9 * C);
      const int tap = rem / C;
      const int c = rem - tap * C;
      float v = 0.0f;
      if (k0 + kk < k_in)
        v = wt[((int64_t)(k0 + kk) * 9 + tap) * N + group * C + c];
      ws[kk][tap][c] = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float xv = xs[kk][ty + dy][tx + dx];
          const float4* w4 =
              reinterpret_cast<const float4*>(&ws[kk][dy * 3 + dx][0]);
#pragma unroll
          for (int c4 = 0; c4 < C / 4; ++c4) {
            const float4 wv = w4[c4];
            acc[4 * c4 + 0] = fmaf(xv, wv.x, acc[4 * c4 + 0]);
            acc[4 * c4 + 1] = fmaf(xv, wv.y, acc[4 * c4 + 1]);
            acc[4 * c4 + 2] = fmaf(xv, wv.z, acc[4 * c4 + 2]);
            acc[4 * c4 + 3] = fmaf(xv, wv.w, acc[4 * c4 + 3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = oy0 + ty;
  const int ox = ox0 + tx;
  if (oy >= height || ox >= width) return;
  float ss = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    acc[c] = lrelu(acc[c], slope);
    ss += acc[c] * acc[c];
  }
  const float rg = rsqrtf(ss / (float)C + eps);
  const int64_t pix = (int64_t)oy * width + ox;
  float* yp = y + ((int64_t)b * N + group * C) * hw + pix;
#pragma unroll
  for (int c = 0; c < C; ++c) yp[c * hw] = acc[c] * rg;
  r[((int64_t)b * 4 + group) * hw + pix] = rg;
}

__global__ void __launch_bounds__(kDzThreads)
packed_dz_kernel(const float* __restrict__ y, const float* __restrict__ r,
                 const float* __restrict__ g, const float* __restrict__ ct_r,
                 float* __restrict__ dz, int64_t n_pix, int64_t hw,
                 int64_t c_group, float slope) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const int64_t b = p / hw;
  const int64_t pix = p - b * hw;
  const float fc = (float)c_group;
  for (int grp = 0; grp < 4; ++grp) {
    const int64_t gi = (b * 4 + grp) * hw + pix;
    const int64_t base = (b * 4 + grp) * c_group * hw + pix;
    const float s = r[gi];
    float t = 0.0f;
    for (int64_t c = 0; c < c_group; ++c) {
      const int64_t i = base + c * hw;
      t += g[i] * (y[i] / s);
    }
    t += ct_r[gi];
    const float k = s * s * s * (t / fc);
    for (int64_t c = 0; c < c_group; ++c) {
      const int64_t i = base + c * hw;
      const float u = y[i] / s;
      const float du = g[i] * s - u * k;
      dz[i] = u >= 0.0f ? du : du * slope;
    }
  }
}

template <int C>
cudaError_t launch_fwd(const float* x, const float* wt, float* y, float* r,
                       int64_t batch, int64_t k_in, int64_t height,
                       int64_t width, float slope, float eps,
                       cudaStream_t stream) {
  const int64_t tiles_h = (height + kTileH - 1) / kTileH;
  const int64_t tiles_w = (width + kTileW - 1) / kTileW;
  if (tiles_h * tiles_w > 0x7fffffff || batch > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles_h * tiles_w), 4, (unsigned)batch);
  packed_conv_fwd_kernel<C><<<grid, kConvThreads, 0, stream>>>(
      x, wt, y, r, (int)k_in, (int)height, (int)width, (int)tiles_w, slope,
      eps);
  return cudaGetLastError();
}

}  // namespace

// x (B, K, H, W); wt = w_packed transposed to (K, 3, 3, N); y (B, N, H, W);
// r (B, 4, H, W).  N / 4 must be 4, 8, 16 or 32.
extern "C" int packed_conv_lrelu_pn_fwd(const void* x, const void* wt,
                                        void* y, void* r, int64_t batch,
                                        int64_t k_in, int64_t n_out,
                                        int64_t height, int64_t width,
                                        float slope, float eps, void* stream) {
  if (batch < 0 || k_in <= 0 || height < 0 || width < 0 ||
      k_in > 0x7fffffff || height > 0x7fffffff || width > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || height == 0 || width == 0) return 0;
  const float* xp = (const float*)x;
  const float* wp = (const float*)wt;
  float* yp = (float*)y;
  float* rp = (float*)r;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_out) {
    case 16:
      return (int)launch_fwd<4>(xp, wp, yp, rp, batch, k_in, height, width,
                                slope, eps, s);
    case 32:
      return (int)launch_fwd<8>(xp, wp, yp, rp, batch, k_in, height, width,
                                slope, eps, s);
    case 64:
      return (int)launch_fwd<16>(xp, wp, yp, rp, batch, k_in, height, width,
                                 slope, eps, s);
    case 128:
      return (int)launch_fwd<32>(xp, wp, yp, rp, batch, k_in, height, width,
                                 slope, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// y, g, dz (B, N, H, W); r, ct_r (B, 4, H, W).
extern "C" int packed_conv_lrelu_pn_dz(const void* y, const void* r,
                                       const void* g, const void* ct_r,
                                       void* dz, int64_t batch, int64_t n_out,
                                       int64_t hw, float slope, void* stream) {
  if (batch < 0 || hw < 0 || n_out <= 0 || n_out % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n_pix = batch * hw;
  const int64_t blocks = (n_pix + kDzThreads - 1) / kDzThreads;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  packed_dz_kernel<<<(unsigned)blocks, kDzThreads, 0, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)r, (const float*)g, (const float*)ct_r,
      (float*)dz, n_pix, hw, n_out / 4, slope);
  return (int)cudaGetLastError();
}
