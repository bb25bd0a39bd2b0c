// Fused LeakyReLU + grouped PixelNorm for NCHW tensors, forward (K1) and
// backward (K2), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pair in neuron_gan_tpu/ops/pallas_kernels.py:
// _grouped_fwd_kernel (K1) and _grouped_bwd_kernel (K2), both launched by
// _rows_call.  For each pixel and each group of C_g = C / n_groups
// contiguous channels:
//
//   forward:  y = lrelu(x);  out = y * rsqrt(sum_g(y^2) / C_g + eps)
//   backward: r = rsqrt(sum_g(y^2) / C_g + eps);  s = sum_g(g * y)
//             dx = lrelu'(x) * (g * r - y * r^3 * s / C_g)
//
// Statistics in float32 whatever the storage type (float or bfloat16); the
// output is rounded once to the storage type.
//
// Bound: bytes.  K1 reads x once and writes out once; K2 reads x and g once
// and writes dx once: at (8, 16, 512, 512) float32 268 MB and 403 MB, 0.080
// and 0.120 ms at the H100's 3.35 TB/s.  The arithmetic is about 6 (K1) and
// 12 (K2) float32 operations an element, at most 3 per byte, where the
// card's float32 pipes do 20 per byte of memory traffic.
//
// Design (that of the packed dz kernel in packed_conv_lrelu_pn.cu, for a
// kernel that forms r itself):
// - Fixed widths: C_g is a template argument for every power of two from 1
//   to 512 (the training paths take 16 to 512), so the channel loops
//   unroll.
// - Work item: a thread takes one 16-byte vector of V consecutive pixels
//   (V = 4 in float32, 8 in bfloat16) of S channels of one group and loads
//   it once into registers (bfloat16 stays packed, two values a register,
//   widened where used).  The L = C_g / S threads of a (pixel vector,
//   group) are consecutive lanes of one warp: each sums its slice in
//   channel order, then a __shfl_xor_sync butterfly over the L lanes gives
//   every lane the group's sums (lrelu_pixel_norm_sliced in
//   ops/lrelu_pixel_norm.py sums in this order).  A warp's load covers
//   32 / L vectors of each of L channel rows: whole 128-byte lines at
//   L <= 4.
// - S, by measurement on an H100 (k12_variants.py, PERF.md): in float32
//   min(C_g, 4); in bfloat16 min(C_g, 8), but 4 at C_g >= 64.  Widths of
//   64 and more occur only at the 16^2-32^2 images, where threads are few
//   (at x (8, 128, 16, 16) 16,384 in float32, where one thread a pixel
//   gave 2,048): there S = 4 ran 28-30% faster than S = 8 in float32 and
//   8-15% in bfloat16.  In float32 S = 4 also ran 17-22% faster at the
//   1M-element C_g = 32 shapes and tied or won at C_g = 16; in bfloat16
//   S = 4 at C_g = 32 (half lines) ran up to 14% slower.
// - One pass: x (and g) are read once with streaming loads (__ldcs) and
//   the output written once (__stcs), from registers.
// - One grid dimension over (image x group, pixel vector, lane), so a 2-D
//   (rows, C) input with many rows meets no grid-y limit.  Indices are
//   32-bit: the launcher checks that every offset fits.
// - A tail in the same kernel: when H*W is not a multiple of V or a pointer
//   is not 16-byte aligned (a 2-D input has H*W = 1; a view may start at a
//   storage offset), each thread takes the same V pixels with scalar loads
//   and stores, masked at H*W.
// - The wide instances, C_g 256 and 512 (Karras et al.'s PGGAN, 512 and
//   256 channels from 4^2 to 64^2): S = C_g / 32, so a vector's 32 lanes
//   are one warp (S 8 and 16 in both types).  They are kernels of their
//   own name (lrelu_pn_wide_fwd_kernel, lrelu_pn_wide_bwd_kernel), so a
//   device trace tells them from the narrow instances.  At those shapes
//   the runtime-width instance gives one thread a whole group: at 512 x
//   4^2 and batch 4 in bfloat16, 8 threads walk 512 channels twice
//   (PERF.md, kernel table: its time beside theirs).
// - Any other group width (24, 96) goes to the runtime-width instance
//   (template argument 0): one thread a (pixel vector, group) walks the
//   group's channels twice, once for the sums and once for the output,
//   which reads x (and g) again, mostly from L2.  No training path
//   launches it; ``lrelu_pixel_norm_runtime`` launches it at any width,
//   for the comparison above.
//
// Entry points have a plain C interface (loaded with ctypes); each launch
// returns the cudaError_t of its launch, 0 on success.  They launch on the
// stream they are given and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;

// dtype codes shared with ops/lrelu_pixel_norm.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// A thread's work in the instance for type T and group width CG (see the
// note above); CG = 0 is the runtime-width instance (S = 0: the whole
// group, one lane).
template <typename T, int CG>
struct Shape {
  static constexpr int V = 16 / (int)sizeof(T);
  // S as measured (see the note above)
  static constexpr int kSlice = sizeof(T) == 4 || CG >= 64 ? 4 : 8;
  // the wide instances: the 32 lanes of a warp, S = C_g / 32
  static constexpr bool kWide = CG >= 256;
  static constexpr int kSliceOf = kWide ? CG / 32 : kSlice;
  static constexpr int S = CG == 0 ? 0 : CG < kSliceOf ? CG : kSliceOf;
  static constexpr int L = CG == 0 ? 1 : CG / S;
  static_assert(L <= 32, "a vector's lanes must lie in one warp");
};

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.0f ? v : v * slope;
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// V pixels of one channel row as loaded: float32 values, or bfloat16
// values two to a register (the lower pixel in the low half).  load takes
// 16 bytes at a 16-byte aligned p; load_masked the first n pixels one by
// one, zeros past them.
template <typename T>
struct Raw;

template <>
struct Raw<float> {
  float w[4];
  __device__ __forceinline__ float at(int v) const { return w[v]; }
  __device__ __forceinline__ void load(const float* p) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
  }
  __device__ __forceinline__ void load_masked(const float* p, int n) {
#pragma unroll
    for (int v = 0; v < 4; ++v) w[v] = v < n ? __ldcs(p + v) : 0.0f;
  }
};

template <>
struct Raw<__nv_bfloat16> {
  uint32_t w[4];
  __device__ __forceinline__ float at(int v) const {
    const uint32_t u = w[v >> 1];
    return __uint_as_float((v & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
  }
  __device__ __forceinline__ void load_masked(const __nv_bfloat16* p, int n) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = 2 * i < n ? __ldcs(q + 2 * i) : 0u;
      const uint32_t hi = 2 * i + 1 < n ? __ldcs(q + 2 * i + 1) : 0u;
      w[i] = lo | (hi << 16);
    }
  }
};

__device__ __forceinline__ void store_vec(float* p, const float (&d)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(d[0], d[1], d[2], d[3]));
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&d)[8]) {
  __stcs(reinterpret_cast<uint4*>(p),
         make_uint4(pack2(bf16_bits(d[0]), bf16_bits(d[1])),
                    pack2(bf16_bits(d[2]), bf16_bits(d[3])),
                    pack2(bf16_bits(d[4]), bf16_bits(d[5])),
                    pack2(bf16_bits(d[6]), bf16_bits(d[7]))));
}
__device__ __forceinline__ void store_one(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p), bf16_bits(v));
}

// d's first n pixels at p: 16 bytes at once where ``aligned``
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&d)[V], bool aligned,
                                      int n) {
  if (aligned) {
    store_vec(p, d);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < n) store_one(p + v, d[v]);
  }
}

// A template instance's thread (CG > 0).  Thread t takes work item t / L
// (n_items of them: row = image * n_groups + group, then the row's n_vec
// pixel vectors, the last one partial where H*W is not a multiple of V) and
// slice t % L.  ``aligned``: H*W is a multiple of V and every pointer
// 16-byte aligned.
template <typename T, int CG, bool kBwd>
__device__ __forceinline__ void one_pass(const T* __restrict__ x,
                                         const T* __restrict__ g,
                                         T* __restrict__ out, int hw,
                                         int n_vec, int n_items, bool aligned,
                                         float slope, float eps) {
  using Sh = Shape<T, CG>;
  constexpr int V = Sh::V, S = Sh::S, L = Sh::L;
  static_assert(CG % S == 0 && 32 % L == 0,
                "a pixel vector's lanes lie in one warp");
  const int t = blockIdx.x * kThreads + threadIdx.x;
  // the L lanes of a vector are live together, and every lane takes part
  // in the shuffles
  const bool live = t / L < n_items;
  const int item = live ? t / L : 0;
  const int row = item / n_vec;
  const int p0 = (item - row * n_vec) * V;
  const int base = (row * CG + (t % L) * S) * hw + p0;
  const int n = live ? min(V, hw - p0) : 0;

  Raw<T> xr[S], gr[kBwd ? S : 1];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (aligned && live) {
      xr[i].load(x + base + i * hw);
      if constexpr (kBwd) gr[i].load(g + base + i * hw);
    } else {
      xr[i].load_masked(x + base + i * hw, n);
      if constexpr (kBwd) gr[i].load_masked(g + base + i * hw, n);
    }
  }

  // sum_group y^2 (and g * y): the slice's sums, then the butterfly
  float ss[V], sg[V];
#pragma unroll
  for (int v = 0; v < V; ++v) ss[v] = sg[v] = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float y = lrelu(xr[i].at(v), slope);
      ss[v] += y * y;
      if constexpr (kBwd) sg[v] += gr[i].at(v) * y;
    }
#pragma unroll
  for (int m = 1; m < L; m *= 2)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      ss[v] += __shfl_xor_sync(0xffffffffu, ss[v], m);
      if constexpr (kBwd) sg[v] += __shfl_xor_sync(0xffffffffu, sg[v], m);
    }
  if (!live) return;

  float r[V], k[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    r[v] = rsqrtf(ss[v] * (1.0f / CG) + eps);
    k[v] = r[v] * r[v] * r[v] * (sg[v] * (1.0f / CG));
  }
#pragma unroll
  for (int i = 0; i < S; ++i) {
    float d[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float xv = xr[i].at(v);
      const float y = lrelu(xv, slope);
      if constexpr (kBwd) {
        const float dy = gr[i].at(v) * r[v] - y * k[v];
        d[v] = xv >= 0.0f ? dy : dy * slope;
      } else {
        d[v] = y * r[v];
      }
    }
    store(out + base + i * hw, d, aligned, n);
  }
}

// The runtime-width instance's thread: work item t (one pixel vector of
// one row, as above) and the row's ``cg`` channels, walked twice.
template <typename T, bool kBwd>
__device__ __forceinline__ void two_pass(const T* __restrict__ x,
                                         const T* __restrict__ g,
                                         T* __restrict__ out, int hw,
                                         int n_vec, int n_items, int cg,
                                         bool aligned, float slope,
                                         float eps) {
  constexpr int V = Shape<T, 0>::V;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_items) return;
  const int row = t / n_vec;
  const int p0 = (t - row * n_vec) * V;
  const int base = row * cg * hw + p0;
  const int n = min(V, hw - p0);

  float ss[V], sg[V];
#pragma unroll
  for (int v = 0; v < V; ++v) ss[v] = sg[v] = 0.0f;
  for (int c = 0; c < cg; ++c) {
    Raw<T> xr, gr;
    if (aligned) {
      xr.load(x + base + c * hw);
      if constexpr (kBwd) gr.load(g + base + c * hw);
    } else {
      xr.load_masked(x + base + c * hw, n);
      if constexpr (kBwd) gr.load_masked(g + base + c * hw, n);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float y = lrelu(xr.at(v), slope);
      ss[v] += y * y;
      if constexpr (kBwd) sg[v] += gr.at(v) * y;
    }
  }
  float r[V], k[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    r[v] = rsqrtf(ss[v] / (float)cg + eps);
    k[v] = r[v] * r[v] * r[v] * (sg[v] / (float)cg);
  }
  for (int c = 0; c < cg; ++c) {
    Raw<T> xr, gr;
    if (aligned) {
      xr.load(x + base + c * hw);
      if constexpr (kBwd) gr.load(g + base + c * hw);
    } else {
      xr.load_masked(x + base + c * hw, n);
      if constexpr (kBwd) gr.load_masked(g + base + c * hw, n);
    }
    float d[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float xv = xr.at(v);
      const float y = lrelu(xv, slope);
      if constexpr (kBwd) {
        const float dy = gr.at(v) * r[v] - y * k[v];
        d[v] = xv >= 0.0f ? dy : dy * slope;
      } else {
        d[v] = y * r[v];
      }
    }
    store(out + base + c * hw, d, aligned, n);
  }
}

template <typename T, int CG>
__global__ void __launch_bounds__(kThreads)
lrelu_pn_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, int hw,
                    int n_vec, int n_items, int cg, bool aligned, float slope,
                    float eps) {
  if constexpr (CG == 0)
    two_pass<T, false>(x, nullptr, out, hw, n_vec, n_items, cg, aligned,
                       slope, eps);
  else
    one_pass<T, CG, false>(x, nullptr, out, hw, n_vec, n_items, aligned,
                           slope, eps);
}

template <typename T, int CG>
__global__ void __launch_bounds__(kThreads)
lrelu_pn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    T* __restrict__ dx, int hw, int n_vec, int n_items, int cg,
                    bool aligned, float slope, float eps) {
  if constexpr (CG == 0)
    two_pass<T, true>(x, g, dx, hw, n_vec, n_items, cg, aligned, slope, eps);
  else
    one_pass<T, CG, true>(x, g, dx, hw, n_vec, n_items, aligned, slope, eps);
}

// the wide instances' kernels: the same thread work, another name
template <typename T, int CG>
__global__ void __launch_bounds__(kThreads)
lrelu_pn_wide_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, int hw,
                         int n_vec, int n_items, int cg, bool aligned,
                         float slope, float eps) {
  one_pass<T, CG, false>(x, nullptr, out, hw, n_vec, n_items, aligned, slope,
                         eps);
}

template <typename T, int CG>
__global__ void __launch_bounds__(kThreads)
lrelu_pn_wide_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         T* __restrict__ dx, int hw, int n_vec, int n_items,
                         int cg, bool aligned, float slope, float eps) {
  one_pass<T, CG, true>(x, g, dx, hw, n_vec, n_items, aligned, slope, eps);
}

// the forward (kBwd false) or backward kernel of the instance <T, CG>
template <typename T, int CG, bool kBwd>
constexpr auto kernel_of() {
  if constexpr (kBwd) {
    if constexpr (Shape<T, CG>::kWide)
      return lrelu_pn_wide_bwd_kernel<T, CG>;
    else
      return lrelu_pn_bwd_kernel<T, CG>;
  } else {
    if constexpr (Shape<T, CG>::kWide)
      return lrelu_pn_wide_fwd_kernel<T, CG>;
    else
      return lrelu_pn_fwd_kernel<T, CG>;
  }
}

bool bad_shape(int64_t batch, int64_t channels, int64_t hw,
               int64_t n_groups) {
  return batch < 0 || channels <= 0 || hw < 0 || n_groups <= 0 ||
         channels % n_groups != 0;
}

// K1 (g null) or K2 (g given) of the instance <T, CG> on x (batch,
// channels, hw) in n_groups groups
template <typename T, int CG>
cudaError_t launch(const void* x, const void* g, void* out, int64_t batch,
                   int64_t channels, int64_t hw, int64_t n_groups, float slope,
                   float eps, cudaStream_t stream) {
  using Sh = Shape<T, CG>;
  const int64_t n_vec = (hw + Sh::V - 1) / Sh::V;
  const int64_t n_items = batch * n_groups * n_vec;
  // 32-bit indices: every offset a live thread forms (masked pixels past
  // the end included), and every thread index
  if (batch * channels * hw > 0x7fffffff - 2 * Sh::V ||
      n_items * Sh::L > 0x7fffffff - kThreads)
    return cudaErrorInvalidValue;
  if (n_items == 0) return cudaSuccess;
  const bool aligned =
      hw % Sh::V == 0 &&
      ((uintptr_t)x | (uintptr_t)g | (uintptr_t)out) % 16 == 0;
  const unsigned blocks =
      (unsigned)((n_items * Sh::L + kThreads - 1) / kThreads);
  const int cg = (int)(channels / n_groups);
  if (g == nullptr)
    kernel_of<T, CG, false>()<<<blocks, kThreads, 0, stream>>>(
        (const T*)x, (T*)out, (int)hw, (int)n_vec, (int)n_items, cg, aligned,
        slope, eps);
  else
    kernel_of<T, CG, true>()<<<blocks, kThreads, 0, stream>>>(
        (const T*)x, (const T*)g, (T*)out, (int)hw, (int)n_vec, (int)n_items,
        cg, aligned, slope, eps);
  return cudaGetLastError();
}

template <typename T>
struct Type {
  using type = T;
};
template <int N>
using Width = std::integral_constant<int, N>;

// f(Type<T>{}, Width<CG>{}) for the instance that takes groups of ``cg``
// channels of the dtype code: a template instance for a power of two up to
// 512, else the runtime-width one (CG = 0; every width where ``runtime``);
// ``bad`` for another dtype.
template <class F>
int dispatch(int64_t cg, int dtype, int bad, F f, bool runtime = false) {
  auto widths = [&](auto type) {
    if (runtime) return f(type, Width<0>{});
    switch (cg) {
      case 1: return f(type, Width<1>{});
      case 2: return f(type, Width<2>{});
      case 4: return f(type, Width<4>{});
      case 8: return f(type, Width<8>{});
      case 16: return f(type, Width<16>{});
      case 32: return f(type, Width<32>{});
      case 64: return f(type, Width<64>{});
      case 128: return f(type, Width<128>{});
      case 256: return f(type, Width<256>{});
      case 512: return f(type, Width<512>{});
      default: return f(type, Width<0>{});
    }
  };
  if (dtype == kFloat32) return widths(Type<float>{});
  if (dtype == kBFloat16) return widths(Type<__nv_bfloat16>{});
  return bad;
}

int launch_any(const void* x, const void* g, void* out, int64_t batch,
               int64_t channels, int64_t hw, int64_t n_groups, float slope,
               float eps, int dtype, void* stream, bool runtime = false) {
  if (bad_shape(batch, channels, hw, n_groups))
    return (int)cudaErrorInvalidValue;
  return dispatch(
      channels / n_groups, dtype, (int)cudaErrorInvalidValue,
      [&](auto type, auto width) {
        using T = typename decltype(type)::type;
        return (int)launch<T, decltype(width)::value>(
            x, g, out, batch, channels, hw, n_groups, slope, eps,
            (cudaStream_t)stream);
      },
      runtime);
}

}  // namespace

// x, out (B, C, H*W) contiguous, float32 (dtype 0) or bfloat16 (dtype 1);
// C a multiple of n_groups.  Any alignment and H*W are taken.
extern "C" int lrelu_pixel_norm_fwd(const void* x, void* out, int64_t batch,
                                    int64_t channels, int64_t hw,
                                    int64_t n_groups, float slope, float eps,
                                    int dtype, void* stream) {
  return launch_any(x, nullptr, out, batch, channels, hw, n_groups, slope,
                    eps, dtype, stream);
}

// x, g, dx as x and out above.
extern "C" int lrelu_pixel_norm_bwd(const void* x, const void* g, void* dx,
                                    int64_t batch, int64_t channels,
                                    int64_t hw, int64_t n_groups, float slope,
                                    float eps, int dtype, void* stream) {
  if (g == nullptr) return (int)cudaErrorInvalidValue;
  return launch_any(x, g, dx, batch, channels, hw, n_groups, slope, eps,
                    dtype, stream);
}

// K1 (g null) or K2 of the runtime-width instance at any group width, as
// the two entry points above take their arguments: the comparison the
// wide instances were chosen by.  No training path calls it.
extern "C" int lrelu_pixel_norm_runtime(const void* x, const void* g,
                                        void* out, int64_t batch,
                                        int64_t channels, int64_t hw,
                                        int64_t n_groups, float slope,
                                        float eps, int dtype, void* stream) {
  return launch_any(x, g, out, batch, channels, hw, n_groups, slope, eps,
                    dtype, stream, true);
}

// Channels S a thread of the instance for group width cg and the dtype
// code takes (0: the runtime-width instance), or -1 for a bad argument.
extern "C" int lrelu_pixel_norm_slice(int64_t cg, int dtype) {
  if (cg <= 0) return -1;
  return dispatch(cg, dtype, -1, [](auto type, auto width) {
    return Shape<typename decltype(type)::type, decltype(width)::value>::S;
  });
}

// Registers a thread of the forward (bwd 0) or backward (bwd 1) kernel
// instance for group width cg and the dtype code uses, or -1.
extern "C" int lrelu_pixel_norm_regs(int64_t cg, int dtype, int bwd) {
  if (cg <= 0) return -1;
  return dispatch(cg, dtype, -1, [&](auto type, auto width) {
    using T = typename decltype(type)::type;
    constexpr int CG = decltype(width)::value;
    cudaFuncAttributes attr;
    const cudaError_t err =
        bwd ? cudaFuncGetAttributes(&attr, kernel_of<T, CG, true>())
            : cudaFuncGetAttributes(&attr, kernel_of<T, CG, false>());
    return err == cudaSuccess ? attr.numRegs : -1;
  });
}
