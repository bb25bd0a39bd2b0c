// Fused packed conv3x3 + LeakyReLU + 4-group PixelNorm (forward), and the
// one-pass dz of its backward, for NCHW float32 tensors on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pair in neuron_gan_tpu/ops/pallas_conv.py:
// _fwd_kernel (launched by _call_fwd) and _dz_kernel (launched by
// _dz_call).  The input is a space-to-depth packed activation, so its K
// input and N output channels are 4 parity groups of K0 = K / 4 and
// C = N / 4 original channels.
//
//   forward:  z = conv3x3(x, W) (zero padding 1, float32-accurate)
//             u = lrelu(z);  r_g = rsqrt(sum_{c in g} u_c^2 / C + eps)
//             y = u * r_g  (B, N, H, W);  r (B, 4, H, W)
//   dz:       s = r_g;  u = y / s;  t = sum_{c in g} ct_y * u + ct_r_g
//             dz = lrelu'(u) * (ct_y * s - u * s^3 * t / C)
//
// The pre-activation z never reaches device memory: the backward rebuilds
// u from (y, r), and dx / dw come from the conv's own adjoints outside.
//
// Forward: which taps it computes.  W is a packed kernel
// (ops/packed.py::pack_conv3x3_weight), 3/4 zeros by construction: for
// output parity g = (a, b) and original tap (ty, tx), exactly one packed
// tap (P, Q) and one input parity (a', b') carry the weight, with
// (P, a') = divmod(a + ty - 1, 2) and (Q, b') = divmod(b + tx - 1, 2).
// The kernel takes only those weights, gathered by the wrapper into
// wc[g][ty][tx][k0][c] (4 * 9 * K0 * C floats), and computes per group an
// implicit GEMM: rows = output pixels, columns = the group's C channels,
// reduction over 9 taps x K0 channels.  PRECONDITION: W is zero off those
// taps (every W on the training path comes from pack_conv3x3_weight); a
// W with other nonzeros gives a different function, unchecked here.
//
// Bound.  At the largest shape of the training path, x (8, 64, 256, 256),
// N = 64, the nonzero taps are 9.66 GFLOP of multiply-adds, 29 GFLOP as
// the three products below: 0.059 ms at the H100's 495 TFLOP/s of TF32;
// the activations are 277 MB (x read once, y and r written once): 0.083
// ms at 3.35 TB/s.  So the kernel is bound by its bytes.  The dz kernel
// is bound by its bytes (y, ct_y and dz once each, r and ct_r once each):
// 419 MB, 0.125 ms at that shape.
//
// Forward design.
// - Tensor cores at float32 accuracy (3xTF32): each operand v is split
//   into hi = tf32(v) and lo = tf32(v - hi), both rounded to nearest (as
//   cvt.rna does; a raw float32 handed to a TF32 mma is truncated), and
//   mma.sync m16n8k8 TF32 sums lo*hi + hi*lo + hi*hi.  The dropped lo*lo
//   is about 2^-22 of a product, the order of float32's own rounding.
//   The tensor cores' float32 accumulation truncates, so each (group,
//   tap) slot's products of a stage go into a fresh accumulator that a
//   float32 add folds into the running sum; kept in the tensor cores
//   across the whole reduction, that bias left the result 3.6x further
//   from float64 than the float32 plain version (k3_variants.py).
// - A block is an 8 x 16 tile of output pixels of one image, for all four
//   groups, so x with its halo is read from device memory once.  Warp w
//   owns tile row w: one m16 tile of pixels and all 4 groups x C
//   channels of accumulators (4 * ceil(C/8) n8 tiles, zero-padded past C).
// - The reduction runs over stages of 16 input channels of one input
//   parity (a', b') (two mma k-steps; zero-filled past K0).  A stage
//   holds those channels' halo tile and the B fragments of the 9 (group,
//   tap) slots that read that parity (each parity serves exactly 9 of the
//   36).  The slots come at 4 distinct packed offsets, so a warp loads and
//   splits 4 A fragments per k-step.
// - Staging: a 3-buffer cp.async ring, one __syncthreads per stage.  x
//   arrives raw, 4 bytes a copy, zero-filled (src-size 0) outside the
//   image; each thread copies one halo position through the 16 channels.
//   The weights arrive split and in fragment order, 16 bytes a copy: a
//   small kernel (split_weights_kernel) writes them once per call into
//   scratch the wrapper allocates.
// - Shared memory: x as [channel][halo row][halo col] with the channel
//   stride padded to 24 (mod 32) floats, so an A fragment's loads (4
//   channels x 8 pixels) hit 32 distinct banks; the weights as one float4
//   (b0 hi, b1 hi, b0 lo, b1 lo) per lane, n8 tile and slot: 512
//   contiguous bytes a warp.
// - Epilogue in registers: a pixel's C channels lie over the 4 lanes of
//   a quad and the n8 tiles; two __shfl_xor give the group's sum of
//   squares.  y is written straight from the fragments (8 pixels of 4
//   channels per store: whole 32-byte sectors), r once per pixel.
// Design choices, timed against variants of this source by
// k3_variants.py (PERF.md): 16-channel stages ran 4% faster than
// 8-channel ones at the largest site; 4-row tiles were faster only at
// x (8, 128, 32, 32), by 6 us a call, and one tile size is kept.
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

constexpr int kTileH = 8;   // output rows of a block
constexpr int kTileW = 16;  // output pixels of a row: one m16 tile
constexpr int kHaloW = kTileW + 2;
constexpr int kChunk = 16;  // input channels of a stage
constexpr int kKSteps = kChunk / 8;  // mma k-steps of a stage
constexpr int kStages = 3;  // the cp.async ring
constexpr int kDzThreads = 256;

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.0f ? v : v * slope;
}

// Slot s (0..2) of one dimension among the taps that read input parity
// ap: the output parity a and original tap t, and the packed offset
// divmod(a + t - 1, 2)[0].  ap = 0: (a, t) = (0, 1), (1, 0), (1, 2);
// ap = 1: (0, 0), (0, 2), (1, 1).
__host__ __device__ constexpr int slot_a(int ap, int s) {
  return ap == 0 ? (s > 0) : (s == 2);
}
__host__ __device__ constexpr int slot_t(int ap, int s) {
  return ap == 0 ? (s == 0 ? 1 : s == 1 ? 0 : 2) : (s == 0 ? 0 : s == 1 ? 2 : 1);
}
__host__ __device__ constexpr int tap_off(int a, int t) {
  return (a + t + 1) / 2 - 1;
}

__device__ __forceinline__ uint32_t f2u(float v) { return __float_as_uint(v); }

// float32 -> TF32 as cvt.rna.tf32.f32 rounds a finite value: to 10
// explicit mantissa bits, ties away from zero (the low 13 bits cleared).
// Two integer operations: at the largest site the forward ran 3% slower
// with the instruction itself (k3_variants.py).
__device__ __forceinline__ float tf32(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ float2 split_tf32(float v) {
  const float hi = tf32(v);
  return make_float2(hi, tf32(v - hi));
}

// d += a * b, and d = a * b: one m16n8k8 TF32 product, float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// Blocks per SM the compiler must leave room for: 2 (at most 128
// registers a thread) where C <= 16, which ran 6-9% faster than without
// the cap; at C = 32 the kernel spills more under that cap and ran
// 30-40% slower with it (k3_variants.py).
template <int C>
constexpr int kMinBlocks = C <= 16 ? 2 : 1;

template <int C>
struct Tile {
  static constexpr int kThreads = kTileH * 32;   // warp w: tile row w
  static constexpr int kNt = (C + 7) / 8;        // n8 tiles per group
  static constexpr int kPlane0 = (kTileH + 2) * kHaloW;
  // channel stride == 24 (mod 32) floats: an A fragment's loads (4
  // channels x 8 pixels) hit 32 distinct banks
  static constexpr int kPlane = kPlane0 + (56 - kPlane0 % 32) % 32;
  static constexpr int kXs = kChunk * kPlane;     // floats per stage
  static constexpr int kWs = 9 * kKSteps * kNt * 32;  // float4 per stage
  static constexpr int kSmem = kStages * (kXs * 4 + kWs * 16);
  static_assert(kPlane % 32 == 24, "A-fragment loads must not conflict");
  static_assert(kPlane0 <= kThreads, "one halo position per thread");
};

template <int C>
using Acc = float[4][Tile<C>::kNt][4];

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Issue the copies of stage s -- channels (s / 4) * 16.. of input parity
// s % 4 and that stage's B fragments -- into one buffer: x with its halo,
// 4 bytes a copy, one halo position per thread (``pos``: its offset in a
// channel plane of x, or -1 outside the image), zero-filled outside the
// image and past K0; the weights, already split and in fragment order,
// 16 bytes a copy.
template <int C>
__device__ __forceinline__ void issue_stage(int s, float* xs, float4* ws,
                                            const float* xb,
                                            const float4* wf, int k0,
                                            int64_t hw, int pos) {
  using T = Tile<C>;
  const int kc = s >> 2, p = s & 3;
  if (threadIdx.x < T::kPlane0) {
    const float* src = xb + (int64_t)(p * k0 + kc * kChunk) * hw + pos;
    const uint32_t dst = smem_addr(xs + threadIdx.x);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const bool in = pos >= 0 && kc * kChunk + k < k0;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                       dst + 4 * k * T::kPlane),
                   "l"(in ? src + k * hw : xb), "r"(in ? 4 : 0));
    }
  }
  const float4* wsrc = wf + (int64_t)s * T::kWs;
  for (int e = threadIdx.x; e < T::kWs; e += T::kThreads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_addr(ws + e)),
                 "l"(wsrc + e));
}

// One stage's products: input parity P = a' * 2 + b', the 9 (group, tap)
// slots that read it, taken by packed offset (P, Q): 4 distinct offsets,
// so 4 A fragments per k-step, each split into (hi, lo) once.  Each
// slot's 3 x kKSteps products go into a fresh accumulator, added to the
// running sum by a float32 add: the tensor cores' own accumulation
// truncates, and over a whole reduction that bias would exceed float32's
// rounding.
template <int P, int C>
__device__ __forceinline__ void mma_stage(Acc<C>& acc, const float* xs,
                                          const float4* ws, int warp,
                                          int lane) {
  using T = Tile<C>;
  constexpr int ap = P >> 1, bp = P & 1;
  const float* xl =
      xs + (lane & 3) * T::kPlane + (warp + 1) * kHaloW + 1 + (lane >> 2);
  const float4* wl = ws + lane;
#pragma unroll
  for (int oyi = 0; oyi < 2; ++oyi) {
#pragma unroll
    for (int oxi = 0; oxi < 2; ++oxi) {
      // the two packed offsets of a dimension: {0, 1} from parity 0,
      // {-1, 0} from parity 1
      const int oy = oyi - ap, ox = oxi - bp;
      uint32_t hi[kKSteps][4], lo[kKSteps][4];
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const float* xa = xl + ks * 8 * T::kPlane + oy * kHaloW + ox;
        const float v[4] = {xa[0], xa[8], xa[4 * T::kPlane],
                            xa[4 * T::kPlane + 8]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 s = split_tf32(v[i]);
          hi[ks][i] = f2u(s.x);
          lo[ks][i] = f2u(s.y);
        }
      }
#pragma unroll
      for (int sy = 0; sy < 3; ++sy) {
#pragma unroll
        for (int sx = 0; sx < 3; ++sx) {
          if (tap_off(slot_a(ap, sy), slot_t(ap, sy)) != oy ||
              tap_off(slot_a(bp, sx), slot_t(bp, sx)) != ox)
            continue;
          const int g = 2 * slot_a(ap, sy) + slot_a(bp, sx);
#pragma unroll
          for (int nt = 0; nt < T::kNt; ++nt) {
            float d[4];
#pragma unroll
            for (int ks = 0; ks < kKSteps; ++ks) {
              const float4 bw =
                  wl[(((sy * 3 + sx) * kKSteps + ks) * T::kNt + nt) * 32];
              if (ks == 0)
                mma_tf32_zero(d, lo[ks], f2u(bw.x), f2u(bw.y));
              else
                mma_tf32(d, lo[ks], f2u(bw.x), f2u(bw.y));
              mma_tf32(d, hi[ks], f2u(bw.z), f2u(bw.w));
              mma_tf32(d, hi[ks], f2u(bw.x), f2u(bw.y));
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[g][nt][i] += d[i];
          }
        }
      }
    }
  }
}

// Stage s = 4 * kc + P: wait for its copies, start those of stage s + 2
// into the buffer stage s - 1 used, and run its products.  The parity P is
// a template argument, so every slot's group, offsets and accumulators
// are compile-time.
template <int P, int C>
__device__ __forceinline__ void run_stage(int s, int n_stages, Acc<C>& acc,
                                          float* xs, float4* ws,
                                          const float* xb, const float4* wf,
                                          int k0, int64_t hw, int pos,
                                          int warp, int lane) {
  using T = Tile<C>;
  asm volatile("cp.async.wait_group 1;" ::: "memory");
  __syncthreads();
  if (s + 2 < n_stages) {
    const int nb = (s + 2) % kStages;
    issue_stage<C>(s + 2, xs + nb * T::kXs, ws + nb * T::kWs, xb, wf, k0, hw,
                   pos);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  const int cb = s % kStages;
  mma_stage<P, C>(acc, xs + cb * T::kXs, ws + cb * T::kWs, warp, lane);
}

template <int C>
__global__ void __launch_bounds__(Tile<C>::kThreads, kMinBlocks<C>)
packed_conv_fwd_kernel(const float* __restrict__ x,    // (B, K, H, W)
                       const float4* __restrict__ wf,  // split_weights_kernel
                       float* __restrict__ y,          // (B, 4C, H, W)
                       float* __restrict__ r,          // (B, 4, H, W)
                       int k_in, int height, int width, int tiles_w,
                       float slope, float eps) {
  using T = Tile<C>;
  extern __shared__ float4 smem[];
  float4* ws = smem;                                            // [kStages][kWs]
  float* xs = reinterpret_cast<float*>(smem + kStages * T::kWs);  // [kStages][kXs]

  const int k0 = k_in / 4;
  const int n_kc = (k0 + kChunk - 1) / kChunk;
  const int n_stages = 4 * n_kc;
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * kTileH;
  const int ox0 = (blockIdx.x % tiles_w) * kTileW;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t hw = (int64_t)height * width;
  const float* xb = x + (int64_t)b * k_in * hw;

  // this thread's halo position: its offset in a channel plane of x
  int pos = -1;
  if (threadIdx.x < T::kPlane0) {
    const int iy = oy0 - 1 + threadIdx.x / kHaloW;
    const int ix = ox0 - 1 + threadIdx.x % kHaloW;
    if (iy >= 0 && iy < height && ix >= 0 && ix < width) pos = iy * width + ix;
  }

  Acc<C> acc;
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int nt = 0; nt < T::kNt; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][nt][i] = 0.0f;

  // stages 0 and 1 in flight (n_stages >= 4)
  issue_stage<C>(0, xs, ws, xb, wf, k0, hw, pos);
  asm volatile("cp.async.commit_group;" ::: "memory");
  issue_stage<C>(1, xs + T::kXs, ws + T::kWs, xb, wf, k0, hw, pos);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int kc = 0; kc < n_kc; ++kc) {
    const int s = 4 * kc;
    run_stage<0, C>(s, n_stages, acc, xs, ws, xb, wf, k0, hw, pos, warp,
                    lane);
    run_stage<1, C>(s + 1, n_stages, acc, xs, ws, xb, wf, k0, hw, pos, warp,
                    lane);
    run_stage<2, C>(s + 2, n_stages, acc, xs, ws, xb, wf, k0, hw, pos, warp,
                    lane);
    run_stage<3, C>(s + 3, n_stages, acc, xs, ws, xb, wf, k0, hw, pos, warp,
                    lane);
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");

  // epilogue: accumulator i of an n8 tile is pixel (lane / 4) + 8 * (i / 2)
  // of the warp's row, channel nt * 8 + 2 * (lane % 4) + i % 2
  const int oy = oy0 + warp;
  const int tig = lane & 3;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ss = 0.0f;
#pragma unroll
      for (int nt = 0; nt < T::kNt; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float u = lrelu(acc[g][nt][2 * h + j], slope);
          acc[g][nt][2 * h + j] = u;
          if (nt * 8 + 2 * tig + j < C) ss += u * u;
        }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      const float rg = rsqrtf(ss / (float)C + eps);
      const int ox = ox0 + (lane >> 2) + 8 * h;
      if (oy < height && ox < width) {
        const int64_t pix = (int64_t)oy * width + ox;
        float* yp = y + ((int64_t)b * 4 * C + g * C) * hw + pix;
#pragma unroll
        for (int nt = 0; nt < T::kNt; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = nt * 8 + 2 * tig + j;
            if (c < C) yp[c * hw] = acc[g][nt][2 * h + j] * rg;
          }
        if (tig == 0) r[((int64_t)b * 4 + g) * hw + pix] = rg;
      }
    }
  }
}

// The weights of every stage, split and in B-fragment order: for stage s
// (channels (s / 4) * 16.. of input parity s % 4), slot j of that parity,
// k-step ks, n8 tile nt and lane l, the float4 (b0 hi, b1 hi, b0 lo, b1
// lo) with b0 = wc[g][ty][tx][k][c], c = nt * 8 + l / 4, k = (s / 4) * 16
// + ks * 8 + l % 4, b1 at k + 4; zeros past K0 and C.
template <int C>
__global__ void __launch_bounds__(256)
split_weights_kernel(const float* __restrict__ wc, float4* __restrict__ wf,
                     int k0, int n_stages) {
  using T = Tile<C>;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_stages * T::kWs) return;
  const int s = e / T::kWs;
  const int j = (e - s * T::kWs) / (kKSteps * T::kNt * 32);
  const int rem = e - s * T::kWs - j * (kKSteps * T::kNt * 32);
  const int ks = rem / (T::kNt * 32);
  const int rem2 = rem - ks * (T::kNt * 32);
  const int c = (rem2 >> 5) * 8 + ((rem2 & 31) >> 2);
  const int ch = (s >> 2) * kChunk + ks * 8 + (rem2 & 3);
  float v0 = 0.0f, v1 = 0.0f;
  if (c < C) {
    const int ap = (s & 3) >> 1, bp = s & 1;
    const int sy = j / 3, sx = j - 3 * (j / 3);
    const int g = 2 * slot_a(ap, sy) + slot_a(bp, sx);
    const int tap = 3 * slot_t(ap, sy) + slot_t(bp, sx);
    const float* w = wc + ((int64_t)(g * 9 + tap) * k0 + ch) * C + c;
    if (ch < k0) v0 = w[0];
    if (ch + 4 < k0) v1 = w[4 * C];
  }
  const float2 b0 = split_tf32(v0), b1 = split_tf32(v1);
  wf[e] = make_float4(b0.x, b1.x, b0.y, b1.y);
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
int64_t scratch_floats(int64_t k_in) {
  return 4 * ((k_in / 4 + kChunk - 1) / kChunk) * Tile<C>::kWs * 4;
}

template <int C>
cudaError_t launch_fwd(const float* x, const float* wc, float* scratch,
                       float* y, float* r, int64_t batch, int64_t k_in,
                       int64_t height, int64_t width, float slope, float eps,
                       cudaStream_t stream) {
  using T = Tile<C>;
  const int64_t tiles_h = (height + kTileH - 1) / kTileH;
  const int64_t tiles_w = (width + kTileW - 1) / kTileW;
  const int64_t n_stages = 4 * ((k_in / 4 + kChunk - 1) / kChunk);
  if (tiles_h * tiles_w > 0x7fffffff || batch > 65535 ||
      height * width > 0x7fffffff || n_stages * T::kWs > 0x7fffffff)
    return cudaErrorInvalidValue;
  float4* wf = reinterpret_cast<float4*>(scratch);
  const int64_t n_w = n_stages * T::kWs;
  split_weights_kernel<C><<<(unsigned)((n_w + 255) / 256), 256, 0, stream>>>(
      wc, wf, (int)(k_in / 4), (int)n_stages);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(packed_conv_fwd_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(tiles_h * tiles_w), (unsigned)batch);
  packed_conv_fwd_kernel<C><<<grid, T::kThreads, T::kSmem, stream>>>(
      x, wf, y, r, (int)k_in, (int)height, (int)width, (int)tiles_w, slope,
      eps);
  return cudaGetLastError();
}

}  // namespace

// The forward kernel's dynamic shared memory in bytes for N output
// channels, or -1 for a width it does not take.
extern "C" int packed_conv_lrelu_pn_fwd_smem(int64_t n_out) {
  switch (n_out) {
    case 16: return Tile<4>::kSmem;
    case 32: return Tile<8>::kSmem;
    case 64: return Tile<16>::kSmem;
    case 128: return Tile<32>::kSmem;
    default: return -1;
  }
}

// Floats of scratch the forward needs for K input and N output channels
// (its split weights), or -1 for a width it does not take.
extern "C" int64_t packed_conv_lrelu_pn_fwd_scratch(int64_t k_in,
                                                    int64_t n_out) {
  if (k_in <= 0 || k_in % 4) return -1;
  switch (n_out) {
    case 16: return scratch_floats<4>(k_in);
    case 32: return scratch_floats<8>(k_in);
    case 64: return scratch_floats<16>(k_in);
    case 128: return scratch_floats<32>(k_in);
    default: return -1;
  }
}

// x (B, K, H, W); wc (4, 3, 3, K / 4, N / 4), the compact weights of a
// packed kernel (see the note above); scratch of
// packed_conv_lrelu_pn_fwd_scratch floats, 16-byte aligned; y (B, N, H,
// W); r (B, 4, H, W).  K must be a multiple of 4; N / 4 must be 4, 8, 16
// or 32.  Launches two kernels: the weight split, then the conv.
extern "C" int packed_conv_lrelu_pn_fwd(const void* x, const void* wc,
                                        void* scratch, void* y, void* r,
                                        int64_t batch, int64_t k_in,
                                        int64_t n_out, int64_t height,
                                        int64_t width, float slope, float eps,
                                        void* stream) {
  if (batch < 0 || k_in <= 0 || k_in % 4 || height < 0 || width < 0 ||
      k_in > 0x7fffffff || height > 0x7fffffff || width > 0x7fffffff ||
      (uintptr_t)scratch % 16)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || height == 0 || width == 0) return 0;
  const float* xp = (const float*)x;
  const float* wp = (const float*)wc;
  float* sp = (float*)scratch;
  float* yp = (float*)y;
  float* rp = (float*)r;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_out) {
    case 16:
      return (int)launch_fwd<4>(xp, wp, sp, yp, rp, batch, k_in, height, width,
                                slope, eps, s);
    case 32:
      return (int)launch_fwd<8>(xp, wp, sp, yp, rp, batch, k_in, height, width,
                                slope, eps, s);
    case 64:
      return (int)launch_fwd<16>(xp, wp, sp, yp, rp, batch, k_in, height,
                                 width, slope, eps, s);
    case 128:
      return (int)launch_fwd<32>(xp, wp, sp, yp, rp, batch, k_in, height,
                                 width, slope, eps, s);
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
