"""Design checks of K3, the fused packed conv forward, on the GPU.

    python3 -m neuron_gan_tpu_torch.k3_variants

Builds variants of csrc/packed_conv_lrelu_pn.cu that each change one
design choice of the committed source (a substituted constant or line),
all nvcc processes at once.  Then, at every distinct packed conv2 shape of
the packed flagship path (batch 8, float32, TF32 off; the float32
kernel's choices), it times each
build's two forward kernels (the weight split and the conv) by CUDA events
and holds each build's (y, r) against the plain version at the smoke's
tolerance; at the largest shape it also gives each build's largest error
against a float64 plain run, relative to the output's largest magnitude.
Prints one JSON line per shape, then the card's nvidia-smi line.

Variants (the committed build is ``committed``):

    stage8          8 input channels a stage instead of 16
    rows4           4-row tiles instead of 8 (twice the blocks)
    cvt_rna         the cvt.rna.tf32.f32 instruction for the TF32 rounding
                    instead of two integer operations (same results)
    regcap_all      the 128-register cap at every width (C = 32 too)
    no_regcap       no register cap at any width
    tc_accumulate   every product accumulated in the tensor cores over the
                    whole reduction, with no fresh accumulator per slot

Needs a CUDA card and nvcc; exits 2 without a card.
"""

import ctypes
import json
import subprocess
import sys

import torch

from neuron_gan_tpu_torch.flagship import PACKED_SHAPES
from neuron_gan_tpu_torch.ops import packed as pk
from neuron_gan_tpu_torch.ops import packed_conv_lrelu_pn as pcl
from neuron_gan_tpu_torch.runtime import kernels, precision_scope

SHAPES = [(n, h) for _, n, h, _ in PACKED_SHAPES[:4]]  # (N = K, packed side)
TOL = dict(rtol=1e-4, atol=1e-5)    # chip_smoke.PACKED_TOL

_TF32_INT = '''__device__ __forceinline__ float tf32(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}'''
_TF32_CVT = '''__device__ __forceinline__ float tf32(float v) {
  uint32_t t;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(t) : "f"(v));
  return __uint_as_float(t);
}'''
_FRESH = ('              float d[4];\n',
          '              float (&d)[4] = acc[g][nt];\n')
_ZERO = ('''                if (ks == 0)
                  mma_tf32_zero(d, lo[ks], f2u(bw.x), f2u(bw.y));
                else
                  mma_tf32(d, lo[ks], f2u(bw.x), f2u(bw.y));''',
         '''                mma_tf32(d, lo[ks], f2u(bw.x), f2u(bw.y));''')
_FOLD = ('''#pragma unroll
              for (int i = 0; i < 4; ++i) acc[g][nt][i] += d[i];
''', '')

VARIANTS = {
    'stage8': [('constexpr int kChunk = 16;', 'constexpr int kChunk = 8;')],
    'rows4': [('constexpr int kTileH = 8;', 'constexpr int kTileH = 4;')],
    'cvt_rna': [(_TF32_INT, _TF32_CVT)],
    'regcap_all': [('kMinBlocks = C <= 16 ? 2 : 1;', 'kMinBlocks = 2;')],
    'no_regcap': [('kMinBlocks = C <= 16 ? 2 : 1;', 'kMinBlocks = 1;')],
    'tc_accumulate': [_FRESH, _ZERO, _FOLD],
}


def _substitute(src, edits):
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f'variant edit does not match the source once: '
                               f'{old[:60]!r}')
        src = src.replace(old, new)
    return src


SOURCE = 'packed_conv_lrelu_pn'     # the csrc/ source the variants edit


def build_variants(variants, out_name='k3_variants', source=SOURCE):
    """({name: ctypes library}, {name: ptxas register and spill lines}) of
    csrc/<source>.cu with each variant's edits, built under
    build/<out_name>/, all nvcc processes at once.  The caller sets the
    argument types of the entry points it calls."""
    out_dir = kernels.BUILD_DIR.parent / out_name
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (kernels.SOURCE_DIR / f'{source}.cu').read_text()
    procs = {}
    for name, edits in variants.items():
        cu = out_dir / f'{name}.cu'
        cu.write_text(_substitute(src, edits))
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, '-o', str(cu.with_suffix('.so')),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'{name}: nvcc exited {proc.returncode}\n{log}')
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if 'registers' in ln or 'spill' in ln]
        libs[name] = ctypes.CDLL(str(out_dir / f'{name}.so'))
    return libs, ptxas


def cuda_ms(fn, iters=50, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main():
    if not torch.cuda.is_available():
        print('k3_variants: no CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    libs, ptxas = build_variants(VARIANTS)
    ptr, i64, f32, i32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                          ctypes.c_int)
    for lib in libs.values():
        lib.packed_conv_lrelu_pn_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i64,
                                                 i64, i64, i64, i64, f32, f32,
                                                 i32, ptr]
        lib.packed_conv_lrelu_pn_fwd_scratch.argtypes = [i64, i64, i32]
        lib.packed_conv_lrelu_pn_fwd_scratch.restype = i64
    libs = {'committed': pcl._lib(), **libs}
    print(json.dumps({'ptxas': ptxas}), flush=True)
    gen = torch.Generator(device='cuda').manual_seed(0)
    with precision_scope('highest'):
        for n, side in SHAPES:
            x = torch.randn((8, n, side, side), generator=gen, device='cuda')
            w = torch.randn((n // 4, n // 4, 3, 3), generator=gen, device='cuda')
            wp = pk.pack_conv3x3_weight(w, pk._eq_scale3x3(w, 0.2))
            wc = pcl.compact_weight(wp)
            y0, r0 = pcl.packed_conv_lrelu_pn_plain(x, wp)
            ref64 = (pcl.packed_conv_lrelu_pn_plain(x.double(), wp.double())
                     if side == max(s for _, s in SHAPES) else None)
            row = {'x': [8, n, side, side], 'n': n, 'ms': {}, 'ok': {}}
            for name, lib in libs.items():
                scratch = torch.empty(lib.packed_conv_lrelu_pn_fwd_scratch(n, n, 0),
                                      device='cuda')
                y, r = torch.empty_like(y0), torch.empty_like(r0)
                stream = torch.cuda.current_stream().cuda_stream

                def launch():
                    rc = lib.packed_conv_lrelu_pn_fwd(
                        x.data_ptr(), wc.data_ptr(), scratch.data_ptr(),
                        y.data_ptr(), r.data_ptr(), 8, n, n, side, side, 0.2,
                        1e-8, 0, stream)
                    if rc:
                        raise RuntimeError(f'{name}: CUDA error {rc}')

                launch()
                torch.cuda.synchronize()
                row['ok'][name] = (torch.allclose(y, y0, **TOL)
                                   and torch.allclose(r, r0, **TOL))
                row['ms'][name] = cuda_ms(launch)
                if ref64 is not None:
                    row.setdefault('rel_max_err_vs_float64', {})[name] = max(
                        ((a.double() - b).abs().max() / b.abs().max()).item()
                        for a, b in zip((y, r), ref64))
            if ref64 is not None:
                row['rel_max_err_vs_float64']['plain'] = max(
                    ((a.double() - b).abs().max() / b.abs().max()).item()
                    for a, b in zip((y0, r0), ref64))
            print(json.dumps(row), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
