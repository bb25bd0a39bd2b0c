// Fused packed conv3x3 + LeakyReLU + 4-group PixelNorm (forward), and the
// one-pass dz of its backward, for NCHW float32 or bfloat16 tensors on
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pair in neuron_gan_tpu/ops/pallas_conv.py:
// _fwd_kernel (launched by _call_fwd) and _dz_kernel (launched by
// _dz_call).  The input is a space-to-depth packed activation, so its K
// input and N output channels are 4 parity groups of K0 = K / 4 and
// C = N / 4 original channels.
//
//   forward:  z = conv3x3(x, W) (zero padding 1, float32 accumulation)
//             u = lrelu(z);  r_g = rsqrt(sum_{c in g} u_c^2 / C + eps)
//             y = u * r_g  (B, N, H, W) in x's type;  r (B, 4, H, W) f32
//   dz:       s = r_g;  u = y / s;  t = sum_{c in g} ct_y * u + ct_r_g
//             dz = lrelu'(u) * (ct_y * s - u * s^3 * t / C)
//             y, ct_y, dz in one type; r, ct_r float32; math in float32
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
// N = 64, the nonzero taps are 9.66 GFLOP of multiply-adds.  float32: 29
// GFLOP as the three products below, 0.059 ms at the H100's 495 TFLOP/s
// of TF32, against 277 MB of activations (x read once, y and r written
// once), 0.083 ms at 3.35 TB/s.  bfloat16: one product, 0.010 ms at 989
// TFLOP/s, against 143 MB, 0.043 ms.  So the kernel is bound by its bytes
// in both types.
//
// Forward design, both types.
// - A block is an 8 x 16 tile of output pixels of one image, for all four
//   groups, so x with its halo is read from device memory once.  Warp w
//   owns tile row w: one m16 tile of pixels and all 4 groups x C
//   channels of accumulators (4 * ceil(C/8) n8 tiles, zero-padded past C).
// - The reduction runs over stages of 16 input channels of one input
//   parity (a', b') (zero-filled past K0).  A stage holds those channels'
//   halo tile and the B fragments of the 9 (group, tap) slots that read
//   that parity (each parity serves exactly 9 of the 36).  The slots come
//   at 4 distinct packed offsets, so a warp loads 4 A fragments per
//   k-step.
// - Staging: a 3-buffer cp.async ring, one __syncthreads per stage; x
//   arrives raw, zero-filled (src-size 0) outside the image; the weights
//   arrive in fragment order, 16 bytes a copy: a small kernel
//   (split_weights_kernel) writes them once per call into scratch the
//   wrapper allocates.
// - Epilogue in registers: a pixel's C channels lie over the 4 lanes of
//   a quad and the n8 tiles; two __shfl_xor give the group's sum of
//   squares.  y is written straight from the fragments, r once per pixel.
//
// float32 (F32Taps): tensor cores at float32 accuracy (3xTF32).  Each
// operand v is split into hi = tf32(v) and lo = tf32(v - hi), both rounded
// to nearest (as cvt.rna does; a raw float32 handed to a TF32 mma is
// truncated), and mma.sync m16n8k8 TF32 sums lo*hi + hi*lo + hi*hi.  The
// dropped lo*lo is about 2^-22 of a product, the order of float32's own
// rounding.  The tensor cores' float32 accumulation truncates, so each
// (group, tap) slot's products of a stage go into a fresh accumulator
// that a float32 add folds into the running sum; kept in the tensor cores
// across the whole reduction, that bias left the result 3.6x further from
// float64 than the float32 plain version (k3_variants.py).  x is staged 4
// bytes (one pixel) a copy, one halo position per thread, as [channel]
// [halo row][halo col] with the channel stride padded to 24 (mod 32)
// floats, so an A fragment's loads (4 channels x 8 pixels) hit 32
// distinct banks; the weights as one float4 (b0 hi, b1 hi, b0 lo, b1 lo)
// per lane, n8 tile and slot.  A stage is two m16n8k8 k-steps.
// Design choices, timed against variants of this source by
// k3_variants.py (PERF.md): 16-channel stages ran 4% faster than
// 8-channel ones at the largest site; 4-row tiles were faster only at
// x (8, 128, 32, 32), by 6 us a call, and one tile size is kept.
//
// bfloat16 (Bf16Taps), the JAX package's numerics (bf16 x bf16 products,
// float32 accumulation, a float32 epilogue, y rounded once): a 16-channel
// stage is exactly one mma.sync m16n8k16 bf16 k-step per slot, no split
// and no fresh accumulator (a truncated float32 add is 2^-23 of the sum,
// far below y's bfloat16 rounding).  The weights are rounded to bfloat16
// (to nearest even, as torch's cast) by the split kernel.  x is staged 4
// bytes (two pixels of one channel) a copy, so a halo row is the 20-pixel
// window from two left of the tile, aligned to pixel pairs: the kernel
// needs an even width.  An A register holds two channels of one pixel,
// loaded as two 16-bit values from [channel][halo row][halo col] with the
// channel stride 8 (mod 32) halves: a load's 4 channels (2 apart) x 8
// pixels then hit distinct banks.
//
// dz (replaces _dz_kernel).  Bound: it reads y, ct_y (B, N, H, W) and r,
// ct_r (B, 4, H, W) once each and writes dz once -- at y (8, 64, 256,
// 256) 218 MB in bfloat16, 419 MB in float32: 0.065 / 0.125 ms at 3.35
// TB/s -- and does about 12 float32 operations per element of y, 2 per
// byte in bfloat16, where the card's float32 pipes do 20 per byte of
// memory traffic: it is bound by its bytes at every shape.  Design:
// - Fixed widths: C = N / 4 is a template argument (4, 8, 16 or 32, the
//   forward's widths), so every channel loop unrolls.
// - Work item: a thread takes one 16-byte vector of V consecutive pixels
//   (V = 4 in float32, 8 in bfloat16) of S = min(C, 8) channels of one
//   group, and keeps the slice's y and ct_y in registers (64 values in
//   float32, 128 in bfloat16).  The L = C / S threads of one (pixel
//   vector, group) are consecutive lanes of a warp and add up t with
//   __shfl_xor_sync: each its slice's sum in channel order, then a
//   butterfly over the L lanes (packed_dz_sliced in
//   ops/packed_conv_lrelu_pn.py sums in this order).  L <= 4, so a warp's
//   load instruction covers 32 / L consecutive vectors of each of L
//   channel rows: whole 128-byte lines.  In bfloat16, S = 4 (half lines,
//   twice the warps: 1,024 at y (8, 128, 32, 32) against 512) ran slower
//   at three of the four path shapes on an H100 (PERF.md).  Blocks of 128
//   threads; grid (pixel vectors * L / 128, B * 4).
// - One pass: y, ct_y, r and ct_r are read once each with streaming loads
//   (__ldcs), dz written once (__stcs).  s's reciprocal is computed once
//   per pixel in each thread (correctly rounded), and u = y * (1 / s) in
//   place of the division, within the plain version's tolerances.
//   Indices are 32-bit: the launcher checks that every offset fits.
// - A tail in the same kernel: when H*W is not a multiple of V or a base
//   pointer is not 16-byte aligned, each thread takes the same V pixels
//   with scalar loads and stores, masked at H*W.
// - ct_r may be null (r has no cotangent, as in every first-order pass):
//   the kernel then adds 0, and no zero tensor is filled to be read.
//
// Entry points have a plain C interface (loaded with ctypes); each returns
// the cudaError_t of its launch, 0 on success.  They launch on the stream
// they are given and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;   // output rows of a block
constexpr int kTileW = 16;  // output pixels of a row: one m16 tile
constexpr int kChunk = 16;  // input channels of a stage
constexpr int kStages = 3;  // the cp.async ring
constexpr int kThreads = kTileH * 32;   // warp w: tile row w
constexpr int kDzThreads = 128;

// dtype codes shared with ops/packed_conv_lrelu_pn.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.0f ? v : v * slope;
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

// The compact weights wc[g][tap][k][c] of slot j (0..8) of stage s, at
// (k, c) = (0, 0): k counts the stage's input parity's channels.
__device__ __forceinline__ const float* slot_weights(const float* wc, int k0,
                                                     int c_out, int s, int j) {
  const int ap = (s & 3) >> 1, bp = s & 1;
  const int sy = j / 3, sx = j - 3 * (j / 3);
  const int g = 2 * slot_a(ap, sy) + slot_a(bp, sx);
  const int tap = 3 * slot_t(ap, sy) + slot_t(bp, sx);
  return wc + (int64_t)(g * 9 + tap) * k0 * c_out;
}

__device__ __forceinline__ uint32_t f2u(float v) { return __float_as_uint(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

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

// d += a * b: one m16n8k16 bfloat16 product, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bfloat16 bit patterns in one register, the first in the low half
__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// Blocks per SM the compiler must leave room for: 2 (at most 128
// registers a thread) where C <= 16, which ran 6-9% faster than without
// the cap; at C = 32 the kernel spills more under that cap and ran
// 30-40% slower with it (k3_variants.py).
template <int C>
constexpr int kMinBlocks = C <= 16 ? 2 : 1;

template <int C>
using Acc = float[4][(C + 7) / 8][4];

// A thread's place in its block's halo tile.
struct Halo {
  int pos;     // float32: its halo position's offset in a channel plane
               // of x, or -1 outside the image (or no position)
  int oy0, ox0, height, width;
};

// ---------------------------------------------------------------------------
// float32: 3xTF32, stages of two m16n8k8 k-steps
// ---------------------------------------------------------------------------

template <int C_>
struct F32Taps {
  static constexpr int C = C_;
  using T = float;            // x and y
  using S = float;            // x in shared memory
  using W = float4;           // one lane's B fragments of a slot's k-step
  static constexpr int kKSteps = kChunk / 8;  // mma k-steps of a stage
  static constexpr int kNt = (C + 7) / 8;     // n8 tiles per group
  static constexpr int kHaloW = kTileW + 2;
  static constexpr int kPlane0 = (kTileH + 2) * kHaloW;
  // channel stride == 24 (mod 32) floats: an A fragment's loads (4
  // channels x 8 pixels) hit 32 distinct banks
  static constexpr int kPlane = kPlane0 + (56 - kPlane0 % 32) % 32;
  static constexpr int kXs = kChunk * kPlane;     // S per stage
  static constexpr int kWs = 9 * kKSteps * kNt * 32;  // W per stage
  static constexpr int kSmem = kStages * (kXs * 4 + kWs * 16);
  static_assert(kPlane % 32 == 24, "A-fragment loads must not conflict");
  static_assert(kPlane0 <= kThreads, "one halo position per thread");

  static __device__ void locate(Halo& h) {
    h.pos = -1;
    if (threadIdx.x < kPlane0) {
      const int iy = h.oy0 - 1 + threadIdx.x / kHaloW;
      const int ix = h.ox0 - 1 + threadIdx.x % kHaloW;
      if (iy >= 0 && iy < h.height && ix >= 0 && ix < h.width)
        h.pos = iy * h.width + ix;
    }
  }

  // Start the copies of stage s -- channels (s / 4) * 16.. of input
  // parity s % 4 and that stage's B fragments -- into one buffer: x with
  // its halo, 4 bytes a copy, one halo position per thread, zero-filled
  // outside the image and past K0; the weights, already split and in
  // fragment order, 16 bytes a copy.
  static __device__ __forceinline__ void load_stage(int s, S* xs, W* ws,
                                               const T* xb, const W* wf,
                                               int k0, int64_t hw,
                                               const Halo& h) {
    const int kc = s >> 2, p = s & 3;
    if (threadIdx.x < kPlane0) {
      const float* src = xb + (int64_t)(p * k0 + kc * kChunk) * hw + h.pos;
      const uint32_t dst = smem_addr(xs + threadIdx.x);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const bool in = h.pos >= 0 && kc * kChunk + k < k0;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                         dst + 4 * k * kPlane),
                     "l"(in ? src + k * hw : xb), "r"(in ? 4 : 0));
      }
    }
    const float4* wsrc = wf + (int64_t)s * kWs;
    for (int e = threadIdx.x; e < kWs; e += kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       smem_addr(ws + e)),
                   "l"(wsrc + e));
  }

  // One stage's products: input parity P = a' * 2 + b', the 9 (group,
  // tap) slots that read it, taken by packed offset (P, Q): 4 distinct
  // offsets, so 4 A fragments per k-step, each split into (hi, lo) once.
  // Each slot's 3 x kKSteps products go into a fresh accumulator, added to
  // the running sum by a float32 add: the tensor cores' own accumulation
  // truncates, and over a whole reduction that bias would exceed
  // float32's rounding.
  template <int P>
  static __device__ __forceinline__ void mma(Acc<C>& acc, const S* xs,
                                             const W* ws, int warp,
                                             int lane) {
    constexpr int ap = P >> 1, bp = P & 1;
    const float* xl =
        xs + (lane & 3) * kPlane + (warp + 1) * kHaloW + 1 + (lane >> 2);
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
          const float* xa = xl + ks * 8 * kPlane + oy * kHaloW + ox;
          const float v[4] = {xa[0], xa[8], xa[4 * kPlane],
                              xa[4 * kPlane + 8]};
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
            for (int nt = 0; nt < kNt; ++nt) {
              float d[4];
#pragma unroll
              for (int ks = 0; ks < kKSteps; ++ks) {
                const float4 bw =
                    wl[(((sy * 3 + sx) * kKSteps + ks) * kNt + nt) * 32];
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

  // Slot j's B fragments of stage s, entry ``e`` (k-step, n8 tile,
  // lane): (b0 hi, b1 hi, b0 lo, b1 lo) with b0 = wc[..][k][c],
  // c = nt * 8 + lane / 4, k = (s / 4) * 16 + ks * 8 + lane % 4, b1 at
  // k + 4; zeros past K0 and C.
  static __device__ W weights(const float* wc, int k0, int s, int j, int e) {
    const int ks = e / (kNt * 32);
    const int rem = e - ks * (kNt * 32);
    const int c = (rem >> 5) * 8 + ((rem & 31) >> 2);
    const int ch = (s >> 2) * kChunk + ks * 8 + (rem & 3);
    float v0 = 0.0f, v1 = 0.0f;
    if (c < C) {
      const float* w = slot_weights(wc, k0, C, s, j) + (int64_t)ch * C + c;
      if (ch < k0) v0 = w[0];
      if (ch + 4 < k0) v1 = w[4 * C];
    }
    const float2 b0 = split_tf32(v0), b1 = split_tf32(v1);
    return make_float4(b0.x, b1.x, b0.y, b1.y);
  }
};

// ---------------------------------------------------------------------------
// bfloat16: one m16n8k16 per slot and stage
// ---------------------------------------------------------------------------

template <int C_>
struct Bf16Taps {
  static constexpr int C = C_;
  using T = __nv_bfloat16;
  using S = uint16_t;
  using W = uint2;            // one lane's (b0, b1) of a slot
  static constexpr int kNt = (C + 7) / 8;
  static constexpr int kRowW = kTileW + 4;     // pixels ox0-2 .. ox0+17
  static constexpr int kPairs = kRowW / 2;
  static constexpr int kPlane0 = (kTileH + 2) * kRowW;
  // channel stride == 8 (mod 32) halves: a load's 4 lanes of a quad read
  // channels 2 apart, kPlane words, so they land 8 banks apart; an even
  // stride keeps cp.async's 4-byte copies aligned
  static constexpr int kPlane = kPlane0 + (40 - kPlane0 % 32) % 32;
  static constexpr int kXs = kChunk * kPlane;  // S per stage
  static constexpr int kWs = 9 * kNt * 32;     // W per stage
  static constexpr int kSmem = kStages * (kXs * 2 + kWs * 8);
  static_assert(kPlane % 32 == 8, "A-fragment loads must not conflict");
  static_assert((kXs * 2) % 16 == 0 && kWs % 2 == 0, "16-byte stages");

  static __device__ void locate(Halo&) {}

  // Stage s's copies: x as pixel pairs, 4 bytes a copy, the pairs of
  // every (channel, halo row) spread over the block's threads,
  // zero-filled outside the image and past K0; the weights 16 bytes a
  // copy.
  static __device__ __forceinline__ void load_stage(int s, S* xs, W* ws,
                                               const T* xb, const W* wf,
                                               int k0, int64_t hw,
                                               const Halo& h) {
    const int kc = s >> 2, p = s & 3;
    const uint16_t* xg = reinterpret_cast<const uint16_t*>(xb);
    const uint16_t* src0 = xg + (int64_t)(p * k0 + kc * kChunk) * hw;
    constexpr int kPerCh = (kTileH + 2) * kPairs;
    for (int e = threadIdx.x; e < kChunk * kPerCh; e += kThreads) {
      const int ch = e / kPerCh;
      const int rem = e - ch * kPerCh;
      const int row = rem / kPairs, pr = rem - row * kPairs;
      const int iy = h.oy0 - 1 + row, ix = h.ox0 - 2 + 2 * pr;
      // the width is even, so a pair lies wholly inside or outside
      const bool in = iy >= 0 && iy < h.height && ix >= 0 && ix < h.width &&
                      kc * kChunk + ch < k0;
      const uint16_t* src =
          in ? src0 + ch * hw + (int64_t)iy * h.width + ix : xg;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                       smem_addr(xs + ch * kPlane + row * kRowW + 2 * pr)),
                   "l"(src), "r"(in ? 4 : 0));
    }
    const uint4* wsrc = reinterpret_cast<const uint4*>(wf + (int64_t)s * kWs);
    uint4* wdst = reinterpret_cast<uint4*>(ws);
    for (int e = threadIdx.x; e < kWs / 2; e += kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       smem_addr(wdst + e)),
                   "l"(wsrc + e));
  }

  // One stage's products, as F32Taps::mma: 4 A fragments (one per packed
  // offset), one m16n8k16 per slot and n8 tile.  A register i holds
  // channels (2 * (lane % 4), +1) (+8 for i >= 2) of pixel lane / 4
  // (+8 for odd i).
  template <int P>
  static __device__ __forceinline__ void mma(Acc<C>& acc, const S* xs,
                                             const W* ws, int warp,
                                             int lane) {
    constexpr int ap = P >> 1, bp = P & 1;
    const uint16_t* xl =
        xs + 2 * (lane & 3) * kPlane + (warp + 1) * kRowW + 2 + (lane >> 2);
    const uint2* wl = ws + lane;
#pragma unroll
    for (int oyi = 0; oyi < 2; ++oyi) {
#pragma unroll
      for (int oxi = 0; oxi < 2; ++oxi) {
        const int oy = oyi - ap, ox = oxi - bp;
        const uint16_t* xa = xl + oy * kRowW + ox;
        const uint32_t a[4] = {
            pack2(xa[0], xa[kPlane]), pack2(xa[8], xa[kPlane + 8]),
            pack2(xa[8 * kPlane], xa[9 * kPlane]),
            pack2(xa[8 * kPlane + 8], xa[9 * kPlane + 8])};
#pragma unroll
        for (int sy = 0; sy < 3; ++sy) {
#pragma unroll
          for (int sx = 0; sx < 3; ++sx) {
            if (tap_off(slot_a(ap, sy), slot_t(ap, sy)) != oy ||
                tap_off(slot_a(bp, sx), slot_t(bp, sx)) != ox)
              continue;
            const int g = 2 * slot_a(ap, sy) + slot_a(bp, sx);
#pragma unroll
            for (int nt = 0; nt < kNt; ++nt) {
              const uint2 bw = wl[((sy * 3 + sx) * kNt + nt) * 32];
              mma_bf16(acc[g][nt], a, bw.x, bw.y);
            }
          }
        }
      }
    }
  }

  // Slot j's B fragments of stage s, entry ``e`` (n8 tile, lane): b0 =
  // wc[..][k, k + 1][c], b1 at k + 8, k + 9, with c = nt * 8 + lane / 4,
  // k = (s / 4) * 16 + 2 * (lane % 4); rounded to bfloat16, zeros past K0
  // and C.
  static __device__ W weights(const float* wc, int k0, int s, int j, int e) {
    const int c = (e >> 5) * 8 + ((e & 31) >> 2);
    const int ch = (s >> 2) * kChunk + 2 * (e & 3);
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (c < C) {
      const float* w = slot_weights(wc, k0, C, s, j) + c;
      const int ks[4] = {ch, ch + 1, ch + 8, ch + 9};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ks[i] < k0) v[i] = w[(int64_t)ks[i] * C];
    }
    return make_uint2(pack2(bf16_bits(v[0]), bf16_bits(v[1])),
                      pack2(bf16_bits(v[2]), bf16_bits(v[3])));
  }
};

// ---------------------------------------------------------------------------
// the forward kernel and the weight split, for either type
// ---------------------------------------------------------------------------

// Stage s = 4 * kc + P: wait for its copies, start those of stage s + 2
// into the buffer stage s - 1 used, and run its products.  The parity P is
// a template argument, so every slot's group, offsets and accumulators
// are compile-time.
template <class Taps, int P>
__device__ __forceinline__ void run_stage(
    int s, int n_stages, Acc<Taps::C>& acc, typename Taps::S* xs,
    typename Taps::W* ws, const typename Taps::T* xb,
    const typename Taps::W* wf, int k0, int64_t hw, const Halo& h, int warp,
    int lane) {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
  __syncthreads();
  if (s + 2 < n_stages) {
    const int nb = (s + 2) % kStages;
    Taps::load_stage(s + 2, xs + nb * Taps::kXs, ws + nb * Taps::kWs, xb, wf, k0,
                hw, h);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  const int cb = s % kStages;
  Taps::template mma<P>(acc, xs + cb * Taps::kXs, ws + cb * Taps::kWs, warp,
                        lane);
}

template <class Taps>
__global__ void __launch_bounds__(kThreads, kMinBlocks<Taps::C>)
packed_conv_fwd_kernel(const typename Taps::T* __restrict__ x,  // (B, K, H, W)
                       const typename Taps::W* __restrict__ wf,  // split
                       typename Taps::T* __restrict__ y,         // (B, 4C, H, W)
                       float* __restrict__ r,                    // (B, 4, H, W)
                       int k_in, int height, int width, int tiles_w,
                       float slope, float eps) {
  constexpr int C = Taps::C;
  using S = typename Taps::S;
  using W = typename Taps::W;
  extern __shared__ float4 smem[];
  W* ws = reinterpret_cast<W*>(smem);                              // [kStages][kWs]
  S* xs = reinterpret_cast<S*>(ws + kStages * Taps::kWs);          // [kStages][kXs]

  const int k0 = k_in / 4;
  const int n_kc = (k0 + kChunk - 1) / kChunk;
  const int n_stages = 4 * n_kc;
  const int b = blockIdx.y;
  Halo h;
  h.oy0 = (blockIdx.x / tiles_w) * kTileH;
  h.ox0 = (blockIdx.x % tiles_w) * kTileW;
  h.height = height;
  h.width = width;
  Taps::locate(h);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t hw = (int64_t)height * width;
  const typename Taps::T* xb = x + (int64_t)b * k_in * hw;

  Acc<C> acc;
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int nt = 0; nt < Taps::kNt; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][nt][i] = 0.0f;

  // stages 0 and 1 in flight (n_stages >= 4)
  Taps::load_stage(0, xs, ws, xb, wf, k0, hw, h);
  asm volatile("cp.async.commit_group;" ::: "memory");
  Taps::load_stage(1, xs + Taps::kXs, ws + Taps::kWs, xb, wf, k0, hw, h);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int kc = 0; kc < n_kc; ++kc) {
    const int s = 4 * kc;
    run_stage<Taps, 0>(s, n_stages, acc, xs, ws, xb, wf, k0, hw, h, warp,
                       lane);
    run_stage<Taps, 1>(s + 1, n_stages, acc, xs, ws, xb, wf, k0, hw, h, warp,
                       lane);
    run_stage<Taps, 2>(s + 2, n_stages, acc, xs, ws, xb, wf, k0, hw, h, warp,
                       lane);
    run_stage<Taps, 3>(s + 3, n_stages, acc, xs, ws, xb, wf, k0, hw, h, warp,
                       lane);
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");

  // epilogue: accumulator i of an n8 tile is pixel (lane / 4) + 8 * (i / 2)
  // of the warp's row, channel nt * 8 + 2 * (lane % 4) + i % 2
  const int oy = h.oy0 + warp;
  const int tig = lane & 3;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float ss = 0.0f;
#pragma unroll
      for (int nt = 0; nt < Taps::kNt; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float u = lrelu(acc[g][nt][2 * hf + j], slope);
          acc[g][nt][2 * hf + j] = u;
          if (nt * 8 + 2 * tig + j < C) ss += u * u;
        }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      const float rg = rsqrtf(ss / (float)C + eps);
      const int ox = h.ox0 + (lane >> 2) + 8 * hf;
      if (oy < height && ox < width) {
        const int64_t pix = (int64_t)oy * width + ox;
        typename Taps::T* yp = y + ((int64_t)b * 4 * C + g * C) * hw + pix;
#pragma unroll
        for (int nt = 0; nt < Taps::kNt; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = nt * 8 + 2 * tig + j;
            if (c < C) store_f32(yp + c * hw, acc[g][nt][2 * hf + j] * rg);
          }
        if (tig == 0) r[((int64_t)b * 4 + g) * hw + pix] = rg;
      }
    }
  }
}

// The weights of every stage in B-fragment order (Taps::weights), for
// stage s (channels (s / 4) * 16.. of input parity s % 4) and slot j of
// that parity.
template <class Taps>
__global__ void __launch_bounds__(256)
split_weights_kernel(const float* __restrict__ wc,
                     typename Taps::W* __restrict__ wf, int k0,
                     int n_stages) {
  constexpr int kPerSlot = Taps::kWs / 9;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_stages * Taps::kWs) return;
  const int s = e / Taps::kWs;
  const int j = (e - s * Taps::kWs) / kPerSlot;
  wf[e] = Taps::weights(wc, k0, s, j, e - s * Taps::kWs - j * kPerSlot);
}

// ---------------------------------------------------------------------------
// the dz kernel
// ---------------------------------------------------------------------------

// A dz thread's work for type T and group width C (see the note above): V
// pixels (16 bytes of one channel row) of S channels of one group; L
// threads, consecutive lanes, share the pixel vector.
template <typename T, int C>
struct DzShape {
  static constexpr int V = 16 / (int)sizeof(T);
  static constexpr int S = C < 8 ? C : 8;
  static constexpr int L = C / S;
  static_assert(C % S == 0 && 32 % L == 0 && kDzThreads % L == 0,
                "a pixel vector's lanes lie in one warp");
};

// 16 bytes at p (16-byte aligned), streamed, as float32 values
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p + i));
    v[i] = q.x;
    v[i + 1] = q.y;
    v[i + 2] = q.z;
    v[i + 3] = q.w;
  }
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  __stcs(reinterpret_cast<uint4*>(p),
         make_uint4(pack2(bf16_bits(v[0]), bf16_bits(v[1])),
                    pack2(bf16_bits(v[2]), bf16_bits(v[3])),
                    pack2(bf16_bits(v[4]), bf16_bits(v[5])),
                    pack2(bf16_bits(v[6]), bf16_bits(v[7]))));
}
__device__ __forceinline__ float load_one(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_one(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)__ldcs(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ void store_one(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p), bf16_bits(v));
}

// Grid (ceil(n_vec * L / kDzThreads), B * 4): blockIdx.y = image * 4 +
// group, and thread t of the row takes pixel vector t / L (n_vec of them,
// the last one partial where H*W is not a multiple of V) and slice t % L.
// ``aligned``: H*W is a multiple of V and every pointer 16-byte aligned.
template <typename T, int C>
__global__ void __launch_bounds__(kDzThreads)
packed_dz_kernel(const T* __restrict__ y, const float* __restrict__ r,
                 const T* __restrict__ g, const float* __restrict__ ct_r,
                 T* __restrict__ dz, int hw, int n_vec, bool aligned,
                 float slope) {
  using Shape = DzShape<T, C>;
  constexpr int V = Shape::V, S = Shape::S, L = Shape::L;
  const int t = blockIdx.x * kDzThreads + threadIdx.x;
  const int p0 = (t / L) * V;
  // the L lanes of a vector are live together, and every lane takes part
  // in the shuffles
  const bool live = t / L < n_vec;
  const int ri = blockIdx.y * hw + p0;                     // r, ct_r
  const int yi = (blockIdx.y * C + (t % L) * S) * hw + p0;  // y, g, dz

  float s[V], ctr[V], u[S][V], gv[S][V];
  if (aligned && live) {
    load_vec(r + ri, s);
    if (ct_r != nullptr) {
      load_vec(ct_r + ri, ctr);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) ctr[v] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      load_vec(y + yi + i * hw, u[i]);
      load_vec(g + yi + i * hw, gv[i]);
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool in = live && p0 + v < hw;
      s[v] = in ? load_one(r + ri + v) : 1.0f;
      ctr[v] = in && ct_r != nullptr ? load_one(ct_r + ri + v) : 0.0f;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        u[i][v] = in ? load_one(y + yi + i * hw + v) : 0.0f;
        gv[i][v] = in ? load_one(g + yi + i * hw + v) : 0.0f;
      }
    }
  }

  // t = sum_group ct_y * u + ct_r: the slice's sum, then the butterfly
  float inv[V], k[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    inv[v] = __frcp_rn(s[v]);
    k[v] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      u[i][v] *= inv[v];
      k[v] += gv[i][v] * u[i][v];
    }
#pragma unroll
  for (int m = 1; m < L; m *= 2)
#pragma unroll
    for (int v = 0; v < V; ++v) k[v] += __shfl_xor_sync(0xffffffffu, k[v], m);
#pragma unroll
  for (int v = 0; v < V; ++v)
    k[v] = s[v] * s[v] * s[v] * ((k[v] + ctr[v]) * (1.0f / C));
  if (!live) return;

#pragma unroll
  for (int i = 0; i < S; ++i) {
    float d[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float du = gv[i][v] * s[v] - u[i][v] * k[v];
      d[v] = u[i][v] >= 0.0f ? du : du * slope;
    }
    if (aligned) {
      store_vec(dz + yi + i * hw, d);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (p0 + v < hw) store_one(dz + yi + i * hw + v, d[v]);
    }
  }
}

template <class Taps>
int64_t scratch_floats(int64_t k_in) {
  return 4 * ((k_in / 4 + kChunk - 1) / kChunk) * Taps::kWs *
         (int64_t)sizeof(typename Taps::W) / 4;
}

template <class Taps>
cudaError_t launch_fwd(const void* x, const float* wc, void* scratch, void* y,
                       float* r, int64_t batch, int64_t k_in, int64_t height,
                       int64_t width, float slope, float eps,
                       cudaStream_t stream) {
  using W = typename Taps::W;
  const int64_t tiles_h = (height + kTileH - 1) / kTileH;
  const int64_t tiles_w = (width + kTileW - 1) / kTileW;
  const int64_t n_stages = 4 * ((k_in / 4 + kChunk - 1) / kChunk);
  if (tiles_h * tiles_w > 0x7fffffff || batch > 65535 ||
      height * width > 0x7fffffff || n_stages * Taps::kWs > 0x7fffffff)
    return cudaErrorInvalidValue;
  W* wf = reinterpret_cast<W*>(scratch);
  const int64_t n_w = n_stages * Taps::kWs;
  split_weights_kernel<Taps><<<(unsigned)((n_w + 255) / 256), 256, 0,
                               stream>>>(wc, wf, (int)(k_in / 4),
                                         (int)n_stages);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(packed_conv_fwd_kernel<Taps>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Taps::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(tiles_h * tiles_w), (unsigned)batch);
  packed_conv_fwd_kernel<Taps><<<grid, kThreads, Taps::kSmem, stream>>>(
      (const typename Taps::T*)x, wf, (typename Taps::T*)y, r, (int)k_in,
      (int)height, (int)width, (int)tiles_w, slope, eps);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_dz(const void* y, const float* r, const void* g,
                      const float* ct_r, void* dz, int64_t batch, int64_t hw,
                      float slope, cudaStream_t stream) {
  using Shape = DzShape<T, C>;
  const int64_t n_vec = (hw + Shape::V - 1) / Shape::V;
  const int64_t blocks = (n_vec * Shape::L + kDzThreads - 1) / kDzThreads;
  // 32-bit indices: every offset a thread forms, past the end included
  if (batch * 4 > 65535 ||
      batch * 4 * C * hw + 2 * kDzThreads * Shape::V > 0x7fffffff)
    return cudaErrorInvalidValue;
  if (blocks == 0 || batch == 0) return cudaSuccess;
  const bool aligned =
      hw % Shape::V == 0 &&
      ((uintptr_t)y | (uintptr_t)r | (uintptr_t)g | (uintptr_t)ct_r |
       (uintptr_t)dz) % 16 == 0;
  const dim3 grid((unsigned)blocks, (unsigned)(batch * 4));
  packed_dz_kernel<T, C><<<grid, kDzThreads, 0, stream>>>(
      (const T*)y, r, (const T*)g, ct_r, (T*)dz, (int)hw, (int)n_vec, aligned,
      slope);
  return cudaGetLastError();
}

// f.template operator()<Taps>() for the kernel of (N, dtype), or ``bad``
// for one it does not take.  The dz kernel takes the same (N, dtype) and
// reads Taps::T and Taps::C alone.
template <class R, class F>
R dispatch(int64_t n_out, int dtype, R bad, F f) {
  if (dtype == kFloat32) {
    switch (n_out) {
      case 16: return f.template operator()<F32Taps<4>>();
      case 32: return f.template operator()<F32Taps<8>>();
      case 64: return f.template operator()<F32Taps<16>>();
      case 128: return f.template operator()<F32Taps<32>>();
    }
  } else if (dtype == kBFloat16) {
    switch (n_out) {
      case 16: return f.template operator()<Bf16Taps<4>>();
      case 32: return f.template operator()<Bf16Taps<8>>();
      case 64: return f.template operator()<Bf16Taps<16>>();
      case 128: return f.template operator()<Bf16Taps<32>>();
    }
  }
  return bad;
}

struct SmemOf {
  template <class Taps>
  int operator()() const { return Taps::kSmem; }
};

struct ScratchOf {
  int64_t k_in;
  template <class Taps>
  int64_t operator()() const { return scratch_floats<Taps>(k_in); }
};

struct LaunchFwd {
  const void* x;
  const float* wc;
  void* scratch;
  void* y;
  float* r;
  int64_t batch, k_in, height, width;
  float slope, eps;
  cudaStream_t stream;
  template <class Taps>
  int operator()() const {
    return (int)launch_fwd<Taps>(x, wc, scratch, y, r, batch, k_in, height,
                                 width, slope, eps, stream);
  }
};

struct LaunchDz {
  const void* y;
  const float* r;
  const void* g;
  const float* ct_r;
  void* dz;
  int64_t batch, hw;
  float slope;
  cudaStream_t stream;
  template <class Taps>
  int operator()() const {
    return (int)launch_dz<typename Taps::T, Taps::C>(y, r, g, ct_r, dz, batch,
                                                     hw, slope, stream);
  }
};

struct DzRegs {
  template <class Taps>
  int operator()() const {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(
            &attr, packed_dz_kernel<typename Taps::T, Taps::C>) != cudaSuccess)
      return -1;
    return attr.numRegs;
  }
};

}  // namespace

// The forward kernel's dynamic shared memory in bytes for N output
// channels and the dtype code, or -1 for one it does not take.
extern "C" int packed_conv_lrelu_pn_fwd_smem(int64_t n_out, int dtype) {
  return dispatch(n_out, dtype, -1, SmemOf{});
}

// Floats of scratch the forward needs for K input and N output channels
// and the dtype code (its weights in fragment order), or -1 for one it
// does not take.
extern "C" int64_t packed_conv_lrelu_pn_fwd_scratch(int64_t k_in,
                                                    int64_t n_out,
                                                    int dtype) {
  if (k_in <= 0 || k_in % 4) return -1;
  return dispatch(n_out, dtype, (int64_t)-1, ScratchOf{k_in});
}

// x (B, K, H, W) float32 (dtype 0) or bfloat16 (dtype 1); wc (4, 3, 3,
// K / 4, N / 4) float32, the compact weights of a packed kernel (see the
// note above); scratch of packed_conv_lrelu_pn_fwd_scratch floats,
// 16-byte aligned; y (B, N, H, W) in x's type; r (B, 4, H, W) float32.  K
// must be a multiple of 4; N / 4 must be 4, 8, 16 or 32; bfloat16 needs
// an even W and a 4-byte aligned x.  Launches two kernels: the weight
// split, then the conv.
extern "C" int packed_conv_lrelu_pn_fwd(const void* x, const void* wc,
                                        void* scratch, void* y, void* r,
                                        int64_t batch, int64_t k_in,
                                        int64_t n_out, int64_t height,
                                        int64_t width, float slope, float eps,
                                        int dtype, void* stream) {
  if (batch < 0 || k_in <= 0 || k_in % 4 || height < 0 || width < 0 ||
      k_in > 0x7fffffff || height > 0x7fffffff || width > 0x7fffffff ||
      (uintptr_t)scratch % 16)
    return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16 && (width % 2 || (uintptr_t)x % 4))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || height == 0 || width == 0) return 0;
  const LaunchFwd launch{x, (const float*)wc, scratch, y, (float*)r,
                         batch, k_in, height, width, slope, eps,
                         (cudaStream_t)stream};
  return dispatch(n_out, dtype, (int)cudaErrorInvalidValue, launch);
}

// y, g, dz (B, N, H, W), float32 (dtype 0) or bfloat16 (dtype 1); r, ct_r
// (B, 4, H, W) float32, ct_r null for a zero cotangent of r.  N must be
// 16, 32, 64 or 128 (the forward's widths).  Any alignment and H*W are
// taken: the kernel loads 16 bytes at a time where every pointer is
// 16-byte aligned and H*W a multiple of 16 bytes' pixels, else one value.
extern "C" int packed_conv_lrelu_pn_dz(const void* y, const void* r,
                                       const void* g, const void* ct_r,
                                       void* dz, int64_t batch, int64_t n_out,
                                       int64_t hw, float slope, int dtype,
                                       void* stream) {
  if (batch < 0 || hw < 0) return (int)cudaErrorInvalidValue;
  const LaunchDz launch{y, (const float*)r, g, (const float*)ct_r, dz,
                        batch, hw, slope, (cudaStream_t)stream};
  return dispatch(n_out, dtype, (int)cudaErrorInvalidValue, launch);
}

// Registers a thread of the dz kernel for N and the dtype code, or -1 for
// one it does not take.
extern "C" int packed_conv_lrelu_pn_dz_regs(int64_t n_out, int dtype) {
  return dispatch(n_out, dtype, -1, DzRegs{});
}
