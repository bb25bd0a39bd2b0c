// The Karras critic's LeakyReLU, alone and before its level-end 2x2 average
// pool, as three kernels whose adjoints close every order of the WGAN-GP,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no Karras critic.  It takes
// out of models/karras.py's D the composed torch.where(z >= 0, z, 0.2 z)
// (a ge, a mul and a where forward; two wheres, a mul and an add backward)
// and F.avg_pool2d with its backward.
//
// Write d(z) = 1 where z >= 0, else the slope.  Then
//
//   LeakyReLU:           y = d(z) z;       dz = d(z) g
//   LeakyReLU + pool:    y = P(d(z) z);    dz = d(z) P^T(g)
//
// with P the 2x2 mean and P^T the x2 nearest unpool times 1/4.  Both maps
// are linear in what they multiply and d carries no gradient (the
// condition of torch.where carries none), so "d v" is its own adjoint, and
// "P(d v)" and "d P^T(g)" are each other's: three kernels serve the
// forward, the first order and the GP's second order.
//
//   critic_act_kernel        y = d v over a flat tensor
//   critic_act_pool_kernel   y = P(d v), (B, C, H, W) -> (B, C, H/2, W/2)
//   critic_act_unpool_kernel dz = d P^T(g), the pooled map's adjoint
//
// The first two take d from v's sign (v = z: the forward, which writes the
// sign as a bit mask) or from the mask (v a cotangent); the third reads the
// mask.  The mask, one bit an element, is all the autograd Functions of
// ops/critic_act.py save.
//
// Roundings are the composed path's, in the storage type T (float or
// bfloat16), so the forward, first and second order equal it bit for bit,
// up to the sign of zeros:
//   d v where d is the slope: T(slope * float(v)) (torch's mul by a
//     scalar, in float);
//   P: the four rounded activations summed in float in F.avg_pool2d's
//     order, (0,0), (0,1), (1,0), (1,1), from 0, then times 1/4, rounded
//     once to T;
//   P^T(g): T(0 + float(g) / 4) (avg_pool2d's backward), then d as above.
//
// Bound: bytes; a few float operations an element.  Per element in
// bfloat16: the flat kernel reads v (2 B) and writes y (2 B) and a mask
// bit; the pooled forward reads z (2 B) and writes a quarter of y (0.5 B)
// and a bit; the adjoint reads a quarter of g, a bit, and writes dz (2 B).
// At (4, 32, 1024, 1024) bfloat16: 352 MB, 0.105 ms at the H100's
// 3.35 TB/s, for the pooled forward and its adjoint each.
//
// Design: no shared memory, no tensor cores.
// - A thread takes one 32-bit mask word: 32 elements in 32 / (2 V)
//   slots (pooled; 2 rows of V columns each) or 32 / V slots (flat; V
//   consecutive elements), V = 16 bytes of T.  Slot k of lane l of warp w
//   is unit (w * K + k) * 32 + l, so a warp's load of one slot takes 32
//   consecutive 16-byte vectors of a row: whole lines.  The word of the
//   thread's elements is mask[thread], so a warp writes or reads 128
//   consecutive bytes of mask.  A warp covers 1024 elements; the mask has
//   32 words for every 1024 elements, the last group padded.
// - A thread issues its loads for every slot first, then computes and
//   stores: K independent 16-byte loads (two rows each where pooled) in
//   flight a thread.
// - The pooled kernels take W a multiple of V (every level of the Karras
//   critic at 1024^2, 8^2 included: 8 columns of bfloat16 are one vector);
//   the launcher refuses other widths.  A pointer not 16-byte aligned, or the warp of a flat tensor's last partial 1024
//   elements, takes scalar loads and stores of the same elements: the
//   mask's layout depends on the shape alone, so the forward and its
//   adjoints agree whatever their pointers.
// - Indices are 32-bit: the launcher checks that every offset fits.
//
// Entry points have a plain C interface (loaded with ctypes); each returns
// the cudaError_t of its launch, 0 on success.  They launch on the stream
// they are given and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// dtype codes shared with ops/critic_act.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// elements a thread takes: the bits of one mask word
constexpr int kBits = 32;
// elements a warp takes
constexpr int kWarpElements = 32 * kBits;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T, as a float
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

template <int W>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[W]) {
  static_assert(W == 2 || W == 4, "8- or 16-byte vectors");
  if constexpr (W == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    w[0] = q.x;
    w[1] = q.y;
  }
}

template <int W>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[W]) {
  static_assert(W == 2 || W == 4, "8- or 16-byte vectors");
  if constexpr (W == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// N consecutive values of T as floats, N * sizeof(T) 8 or 16 bytes (half a
// pooled unit's row, or a whole one).  load and store move one vector
// where ``vec``, else the first n values one by one (zeros past them on a
// load).
template <typename T, int N>
struct Pack {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kWords = N * (int)sizeof(T) / 4;
  float x[N];

  __device__ __forceinline__ void load(const T* p, bool vec, int n) {
    if (vec) {
      uint32_t w[kWords];
      load_words(p, w);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if constexpr (kF32) {
          x[i] = __uint_as_float(w[i]);
        } else {
          const uint32_t u = w[i >> 1];
          x[i] = __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
        }
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = i < n ? to_float(p[i]) : 0.0f;
  }

  __device__ __forceinline__ void store(T* p, bool vec, int n) const {
    if (vec) {
      uint32_t w[kWords];
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        if constexpr (kF32) {
          w[i] = __float_as_uint(x[i]);
        } else {
          const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16(x[2 * i]));
          const uint32_t hi =
              __bfloat16_as_ushort(__float2bfloat16(x[2 * i + 1]));
          w[i] = lo | (hi << 16);
        }
      }
      store_words(p, w);
      return;
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < n) p[i] = from_float<T>(x[i]);
  }
};

// d v for one value: v where ``keep``, else T(slope * v)
template <typename T>
__device__ __forceinline__ float scaled(float v, bool keep, float slope) {
  return keep ? v : round_to<T>(v * slope);
}

// One thread of critic_act_kernel: its K slots of V elements, each a 16-byte
// vector where kFull (the warp's 1024 elements all inside v, every pointer
// aligned), else value by value, masked at n.
template <typename T, bool kRead, bool kFull>
__device__ __forceinline__ void act_slots(const T* __restrict__ v,
                                          const uint32_t* __restrict__ mask_in,
                                          T* __restrict__ y,
                                          uint32_t* __restrict__ mask_out,
                                          int n, int t, float slope) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int K = kBits / V;
  const int warp = t / 32, lane = t % 32;

  Pack<T, V> p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e0 = ((warp * K + k) * 32 + lane) * V;
    p[k].load(v + e0, kFull, kFull ? V : n - e0);
  }
  uint32_t bits = 0u;
  if constexpr (kRead) bits = mask_in[t];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e0 = ((warp * K + k) * 32 + lane) * V;
    const int cnt = kFull ? V : n - e0;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int b = k * V + i;
      bool keep;
      if constexpr (kRead) {
        keep = (bits >> b) & 1u;
      } else {
        keep = p[k].x[i] >= 0.0f;
        if (keep && (kFull || i < cnt)) bits |= 1u << b;
      }
      p[k].x[i] = scaled<T>(p[k].x[i], keep, slope);
    }
    p[k].store(y + e0, kFull, cnt);
  }
  if constexpr (!kRead) mask_out[t] = bits;
}

// y = d v over n elements; d from v >= 0 (kRead false: the bits written to
// mask_out) or from mask_in.  The vector path is a whole warp's choice.
template <typename T, bool kRead>
__global__ void __launch_bounds__(kThreads)
critic_act_kernel(const T* __restrict__ v, const uint32_t* __restrict__ mask_in,
                  T* __restrict__ y, uint32_t* __restrict__ mask_out, int n,
                  int n_words, bool aligned, float slope) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_words) return;
  if (aligned && (t / 32 + 1) * kWarpElements <= n)
    act_slots<T, kRead, true>(v, mask_in, y, mask_out, n, t, slope);
  else
    act_slots<T, kRead, false>(v, mask_in, y, mask_out, n, t, slope);
}

// y = P(d v): v (planes, 2 * rows, w) -> y (planes, rows, w / 2), the
// pair-rows flattened; d as in critic_act_kernel.  A unit is VU columns of
// one pair of rows, one 16-byte vector a row.
template <typename T, bool kRead>
__global__ void __launch_bounds__(kThreads)
critic_act_pool_kernel(const T* __restrict__ v,
                       const uint32_t* __restrict__ mask_in,
                       T* __restrict__ y, uint32_t* __restrict__ mask_out,
                       int n_units, int n_words, int w, bool aligned,
                       float slope) {
  constexpr int VU = 16 / (int)sizeof(T);
  constexpr int K = kBits / (2 * VU);
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_words) return;
  const int warp = t / 32, lane = t % 32;
  const int nu = w / VU, wo = w / 2;

  Pack<T, VU> r[K][2];
  int u[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    u[k] = (warp * K + k) * 32 + lane;
    if (u[k] < n_units) {
      const int pr = u[k] / nu;
      const T* src = v + 2 * pr * w + (u[k] - pr * nu) * VU;
      r[k][0].load(src, aligned, VU);
      r[k][1].load(src + w, aligned, VU);
    }
  }
  uint32_t bits = 0u;
  if constexpr (kRead) bits = mask_in[t];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (u[k] >= n_units) continue;
#pragma unroll
    for (int row = 0; row < 2; ++row)
#pragma unroll
      for (int c = 0; c < VU; ++c) {
        const int b = (k * 2 + row) * VU + c;
        bool keep;
        if constexpr (kRead) {
          keep = (bits >> b) & 1u;
        } else {
          keep = r[k][row].x[c] >= 0.0f;
          if (keep) bits |= 1u << b;
        }
        r[k][row].x[c] = scaled<T>(r[k][row].x[c], keep, slope);
      }
    Pack<T, VU / 2> o;
#pragma unroll
    for (int q = 0; q < VU / 2; ++q) {
      // F.avg_pool2d's sum: from 0, row by row, in float
      float acc = 0.0f;
      acc += r[k][0].x[2 * q];
      acc += r[k][0].x[2 * q + 1];
      acc += r[k][1].x[2 * q];
      acc += r[k][1].x[2 * q + 1];
      o.x[q] = acc * 0.25f;
    }
    const int pr = u[k] / nu;
    o.store(y + pr * wo + (u[k] - pr * nu) * (VU / 2), aligned, VU / 2);
  }
  if constexpr (!kRead) mask_out[t] = bits;
}

// dz = d P^T(g): g (planes, rows, w / 2) -> dz (planes, 2 * rows, w), the
// adjoint of critic_act_pool_kernel, d from the mask it wrote.
template <typename T>
__global__ void __launch_bounds__(kThreads)
critic_act_unpool_kernel(const T* __restrict__ g,
                         const uint32_t* __restrict__ mask,
                         T* __restrict__ dz, int n_units, int n_words, int w,
                         bool aligned, float slope) {
  constexpr int VU = 16 / (int)sizeof(T);
  constexpr int K = kBits / (2 * VU);
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_words) return;
  const int warp = t / 32, lane = t % 32;
  const int nu = w / VU, wo = w / 2;

  Pack<T, VU / 2> gi[K];
  int u[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    u[k] = (warp * K + k) * 32 + lane;
    if (u[k] < n_units) {
      const int pr = u[k] / nu;
      gi[k].load(g + pr * wo + (u[k] - pr * nu) * (VU / 2), aligned, VU / 2);
    }
  }
  const uint32_t bits = mask[t];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (u[k] >= n_units) continue;
    float a[VU / 2];
#pragma unroll
    for (int q = 0; q < VU / 2; ++q)
      // avg_pool2d's backward: from 0, plus g / 4, rounded to T
      a[q] = round_to<T>(0.0f + gi[k].x[q] * 0.25f);
    Pack<T, VU> r[2];
#pragma unroll
    for (int row = 0; row < 2; ++row)
#pragma unroll
      for (int c = 0; c < VU; ++c) {
        const int b = (k * 2 + row) * VU + c;
        r[row].x[c] = scaled<T>(a[c / 2], (bits >> b) & 1u, slope);
      }
    const int pr = u[k] / nu;
    T* dst = dz + 2 * pr * w + (u[k] - pr * nu) * VU;
    r[0].store(dst, aligned, VU);
    r[1].store(dst + w, aligned, VU);
  }
}

template <typename T>
struct Type {
  using type = T;
};

// f(Type<T>{}) for the dtype code, or ``bad``
template <class F>
int dispatch(int dtype, int bad, F f) {
  if (dtype == kFloat32) return f(Type<float>{});
  if (dtype == kBFloat16) return f(Type<__nv_bfloat16>{});
  return bad;
}

bool aligned16(const void* a, const void* b, const void* c) {
  return ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) % 16 == 0;
}

// 32-bit indices: every element offset, and every thread index
bool too_large(int64_t n) {
  return n > 0x7fffffffLL - 2 * kWarpElements;
}

int64_t words_of(int64_t n) {
  return (n + kWarpElements - 1) / kWarpElements * 32;
}

unsigned blocks_of(int64_t n_words) {
  return (unsigned)((n_words + kThreads - 1) / kThreads);
}

// The flat kernel: exactly one of mask_in, mask_out given
template <typename T>
cudaError_t launch_act(const void* v, const void* mask_in, void* y,
                       void* mask_out, int64_t n, float slope,
                       cudaStream_t stream) {
  const int64_t n_words = words_of(n);
  const bool aligned = aligned16(v, y, nullptr);
  if (mask_in != nullptr)
    critic_act_kernel<T, true><<<blocks_of(n_words), kThreads, 0, stream>>>(
        (const T*)v, (const uint32_t*)mask_in, (T*)y, nullptr, (int)n,
        (int)n_words, aligned, slope);
  else
    critic_act_kernel<T, false><<<blocks_of(n_words), kThreads, 0, stream>>>(
        (const T*)v, nullptr, (T*)y, (uint32_t*)mask_out, (int)n,
        (int)n_words, aligned, slope);
  return cudaGetLastError();
}

// The pooled forward (unpool false; one of mask_in, mask_out given) or
// its adjoint (unpool true; mask_in given): src, dst as the kernels take
// them
template <typename T>
cudaError_t launch_pooled(const void* src, const void* mask_in, void* dst,
                          void* mask_out, int64_t n, int64_t w, bool unpool,
                          float slope, cudaStream_t stream) {
  constexpr int VU = 16 / (int)sizeof(T);
  const int64_t n_words = words_of(n);
  const int n_units = (int)(n / (2 * VU));
  const bool aligned = aligned16(src, dst, nullptr);
  const unsigned blocks = blocks_of(n_words);
  if (unpool)
    critic_act_unpool_kernel<T><<<blocks, kThreads, 0, stream>>>(
        (const T*)src, (const uint32_t*)mask_in, (T*)dst, n_units,
        (int)n_words, (int)w, aligned, slope);
  else if (mask_in != nullptr)
    critic_act_pool_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        (const T*)src, (const uint32_t*)mask_in, (T*)dst, nullptr, n_units,
        (int)n_words, (int)w, aligned, slope);
  else
    critic_act_pool_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        (const T*)src, nullptr, (T*)dst, (uint32_t*)mask_out, n_units,
        (int)n_words, (int)w, aligned, slope);
  return cudaGetLastError();
}

// n = planes * h * w elements of the full-resolution side, w a multiple
// of 16 bytes of the dtype
int launch_pooled_any(const void* src, const void* mask_in, void* dst,
                      void* mask_out, int64_t planes, int64_t h, int64_t w,
                      bool unpool, float slope, int dtype, void* stream) {
  if (planes < 0 || h <= 0 || w <= 0 || h % 2 || w % 2)
    return (int)cudaErrorInvalidValue;
  const int64_t n = planes * h * w;
  if (too_large(n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  return dispatch(dtype, (int)cudaErrorInvalidValue, [&](auto type) {
    using T = typename decltype(type)::type;
    if (w % (16 / (int)sizeof(T)) != 0) return (int)cudaErrorInvalidValue;
    return (int)launch_pooled<T>(src, mask_in, dst, mask_out, n, w, unpool,
                                 slope, (cudaStream_t)stream);
  });
}

}  // namespace

// y = d v over v's n elements (contiguous), float32 (dtype 0) or bfloat16
// (dtype 1).  With mask_out (mask_in null), d from v >= 0 and its bits
// written there; with mask_in (mask_out null), d from those bits.  A mask
// holds critic_act_mask_words(n) 32-bit words.
extern "C" int critic_act(const void* v, const void* mask_in, void* y,
                          void* mask_out, int64_t n, float slope, int dtype,
                          void* stream) {
  if (n < 0 || too_large(n) || (mask_in == nullptr) == (mask_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  return dispatch(dtype, (int)cudaErrorInvalidValue, [&](auto type) {
    using T = typename decltype(type)::type;
    return (int)launch_act<T>(v, mask_in, y, mask_out, n, slope,
                              (cudaStream_t)stream);
  });
}

// y (planes, h / 2, w / 2) = P(d v), v (planes, h, w) contiguous, h even,
// w a multiple of 16 bytes of the dtype (8 bfloat16, 4 float32); the mask
// as critic_act's, of v's planes * h * w elements.
extern "C" int critic_act_pool(const void* v, const void* mask_in, void* y,
                               void* mask_out, int64_t planes, int64_t h,
                               int64_t w, float slope, int dtype,
                               void* stream) {
  if ((mask_in == nullptr) == (mask_out == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_pooled_any(v, mask_in, y, mask_out, planes, h, w, false,
                           slope, dtype, stream);
}

// dz (planes, h, w) = d P^T(g), g (planes, h / 2, w / 2) contiguous, d from
// the mask critic_act_pool wrote for (planes, h, w).
extern "C" int critic_act_unpool(const void* g, const void* mask, void* dz,
                                 int64_t planes, int64_t h, int64_t w,
                                 float slope, int dtype, void* stream) {
  if (mask == nullptr) return (int)cudaErrorInvalidValue;
  return launch_pooled_any(g, mask, dz, nullptr, planes, h, w, true, slope,
                           dtype, stream);
}

// The 32-bit words of a mask of n elements.
extern "C" int64_t critic_act_mask_words(int64_t n) {
  return n < 0 ? -1 : words_of(n);
}
