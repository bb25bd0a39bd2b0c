"""Design checks of K4, the packed dz kernel, on the GPU.

    python3 -m neuron_gan_tpu_torch.k4_variants

Builds variants of csrc/packed_conv_lrelu_pn.cu that each change one
design choice of the dz kernel (a substituted line), all nvcc processes at
once (``k3_variants.build_variants``).  Then, at every distinct packed
shape of the flagship paths (y (8, N, H, W)), in float32 and bfloat16, it
holds each build's dz against the plain version (float32 at
chip_smoke.PACKED_TOL['dz'], bfloat16 within 2 bfloat16 ulps of the
output's scale) and times it by its device time (``runtime/timing.py``),
r's cotangent live.  Prints the builds' ptxas register and spill lines,
one JSON line per shape (each build's ms, registers and check, and the
shape's byte bound), then the card's nvidia-smi line.

Variants (the committed build, S = min(C, 8) channels a thread in blocks
of 128 threads, is ``committed``):

    slice4      S = min(C, 4): half 128-byte lines a load where C > 4
                (bfloat16 took this before it was measured)
    slice16     S = min(C, 16): a thread holds twice the values
    regcap128   at most 128 registers a thread (4 blocks an SM)
    threads64   blocks of 64 threads
    threads256  blocks of 256 threads

Needs a CUDA card and nvcc; exits 2 without a card.
"""

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from neuron_gan_tpu_torch.k3_variants import SHAPES, SOURCE, build_variants
from neuron_gan_tpu_torch.ops import packed_conv_lrelu_pn as pcl
from neuron_gan_tpu_torch.runtime.timing import device_ms

TOL = dict(rtol=1e-4, atol=1e-5)                 # chip_smoke.PACKED_TOL['dz']
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM data sheet

_SLICE = 'static constexpr int S = C < 8 ? C : 8;'
_BLOCK = 'constexpr int kDzThreads = 128;'
VARIANTS = {
    'slice4': [(_SLICE, 'static constexpr int S = C < 4 ? C : 4;')],
    'slice16': [(_SLICE, 'static constexpr int S = C < 16 ? C : 16;')],
    'regcap128': [('__launch_bounds__(kDzThreads)\npacked_dz_kernel',
                   '__launch_bounds__(kDzThreads, 4)\npacked_dz_kernel')],
    'threads64': [(_BLOCK, 'constexpr int kDzThreads = 64;')],
    'threads256': [(_BLOCK, 'constexpr int kDzThreads = 256;')],
}


def _dz_entry(lib):
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.packed_conv_lrelu_pn_dz.argtypes = [ptr] * 5 + [
        i64, i64, i64, ctypes.c_float, i32, ptr]
    lib.packed_conv_lrelu_pn_dz_regs.argtypes = [i64, i32]
    return lib


def _ok(got, want):
    if got.dtype == torch.float32:
        return torch.allclose(got, want, **TOL)
    ulp = 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
    return (got.float() - want.float()).abs().max().item() <= 2 * ulp


def main():
    if not torch.cuda.is_available():
        print('k4_variants: no CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    libs, ptxas = build_variants(VARIANTS, 'k4_variants', SOURCE)
    libs = {'committed': pcl._lib(),
            **{name: _dz_entry(lib) for name, lib in libs.items()}}
    print(json.dumps({'ptxas': ptxas}), flush=True)
    gen = torch.Generator(device='cuda').manual_seed(0)
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for n, side in SHAPES:
            shape = (8, n, side, side)
            y = torch.randn(shape, generator=gen, device='cuda').to(dtype)
            g = torch.randn(shape, generator=gen, device='cuda').to(dtype)
            r = 0.5 + torch.rand((8, 4, side, side), generator=gen, device='cuda')
            ct_r = torch.randn((8, 4, side, side), generator=gen, device='cuda')
            want = pcl.packed_dz_plain(y, r, g, ct_r)
            n_bytes = 3 * y.numel() * y.element_size() + 2 * r.numel() * 4
            row = {'dtype': str(dtype).removeprefix('torch.'), 'y': list(shape),
                   'bound_ms': n_bytes / HBM_BYTES_PER_S * 1e3,
                   'ms': {}, 'regs': {}, 'ok': {}}
            for name, lib in libs.items():
                dz = torch.empty_like(y)
                stream = torch.cuda.current_stream().cuda_stream

                def launch():
                    rc = lib.packed_conv_lrelu_pn_dz(
                        y.data_ptr(), r.data_ptr(), g.data_ptr(),
                        ct_r.data_ptr(), dz.data_ptr(), 8, n, side * side,
                        0.2, code, stream)
                    if rc:
                        raise RuntimeError(f'{name}: CUDA error {rc}')

                launch()
                torch.cuda.synchronize()
                row['ok'][name] = bool(_ok(dz, want))
                row['ms'][name] = device_ms(launch)
                row['regs'][name] = lib.packed_conv_lrelu_pn_dz_regs(n, code)
            print(json.dumps(row), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
