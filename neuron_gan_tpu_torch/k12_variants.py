"""Design checks of K1 and K2, the LeakyReLU + PixelNorm kernel pair, on
the GPU.

    python3 -m neuron_gan_tpu_torch.k12_variants

Builds variants of csrc/lrelu_pixel_norm.cu that each change one design
choice of both kernels (a substituted line), all nvcc processes at once
(``k3_variants.build_variants``).  Then, at every (x shape, grouping) a
flagship path gives K1/K2 (``SHAPES``), in float32 and bfloat16, it holds
each build's forward and backward against the plain versions (float32 at
chip_smoke.py's tolerances, bfloat16 within 2 bfloat16 ulps of the
output's scale) and times them by their device time
(``runtime/timing.py``).  Prints the builds' ptxas register and spill
lines, one JSON line per shape and dtype (each build's ms, registers and
check, and the byte bounds), then the card's nvidia-smi line.

Variants (the committed build, S = min(C_g, 4) channels a thread in
float32 and min(C_g, 8) in bfloat16 but 4 at C_g >= 64, in blocks of 128
threads, is ``committed``):

    slice_half    S halved where a vector's lanes still fit a warp (C_g =
                  128 keeps S = 4): twice the threads, half the values
    slice_double  S doubled: half the threads
    regcap128     at most 128 registers a thread (4 blocks an SM)
    threads64     blocks of 64 threads
    threads256    blocks of 256 threads

Needs a CUDA card and nvcc; exits 2 without a card.
"""

import json
import subprocess
import sys

import numpy as np
import torch

from neuron_gan_tpu_torch.flagship import epilogue_shapes
from neuron_gan_tpu_torch.k3_variants import build_variants
from neuron_gan_tpu_torch.ops import lrelu_pixel_norm as lpn
from neuron_gan_tpu_torch.runtime.timing import device_ms

SOURCE = 'lrelu_pixel_norm'
TOL = {'fwd': dict(rtol=1e-5, atol=1e-6),          # chip_smoke.py's
       'bwd': dict(rtol=1e-4, atol=1e-5)}
HBM_BYTES_PER_S = 3.35e12                          # H100 SXM data sheet
# every (x shape, grouping) of K1/K2 on the flagship paths: those of the
# float32 paths (unpacked and packed) hold the mixed path's bfloat16 ones
SHAPES = sorted(epilogue_shapes(torch.float32))

_SLICE = 'static constexpr int kSlice = sizeof(T) == 4 || CG >= 64 ? 4 : 8;'
_BLOCK = 'constexpr int kThreads = 128;'
VARIANTS = {
    'slice_half': [(_SLICE, 'static constexpr int kSlice = sizeof(T) == 4 '
                            '|| CG >= 64 ? (CG == 128 ? 4 : 2) : 4;')],
    'slice_double': [(_SLICE, 'static constexpr int kSlice = '
                              'sizeof(T) == 4 || CG >= 64 ? 8 : 16;')],
    'regcap128': [('__launch_bounds__(kThreads)\nlrelu_pn_fwd_kernel',
                   '__launch_bounds__(kThreads, 4)\nlrelu_pn_fwd_kernel'),
                  ('__launch_bounds__(kThreads)\nlrelu_pn_bwd_kernel',
                   '__launch_bounds__(kThreads, 4)\nlrelu_pn_bwd_kernel')],
    'threads64': [(_BLOCK, 'constexpr int kThreads = 64;')],
    'threads256': [(_BLOCK, 'constexpr int kThreads = 256;')],
}


def _ok(got, want, tol):
    if got.dtype == torch.float32:
        return torch.allclose(got, want, **tol)
    ulp = 2.0 ** (np.floor(np.log2(want.float().abs().max().item())) - 7)
    return (got.float() - want.float()).abs().max().item() <= 2 * ulp


def main():
    if not torch.cuda.is_available():
        print('k12_variants: no CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    libs, ptxas = build_variants(VARIANTS, 'k12_variants', SOURCE)
    libs = {'committed': lpn._lib(),
            **{name: lpn.declare_entry_points(lib) for name, lib in libs.items()}}
    print(json.dumps({'ptxas': ptxas}), flush=True)
    gen = torch.Generator(device='cuda').manual_seed(0)
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for shape, n_groups in SHAPES:
            x = torch.randn(shape, generator=gen, device='cuda').to(dtype)
            g = torch.randn(shape, generator=gen, device='cuda').to(dtype)
            want = {'fwd': lpn.lrelu_pixel_norm_plain(x, n_groups),
                    'bwd': lpn.lrelu_pixel_norm_bwd_plain(x, g, n_groups)}
            b, c, h, w = shape
            n_bytes = x.numel() * x.element_size()
            row = {'dtype': str(dtype).removeprefix('torch.'), 'x': list(shape),
                   'n_groups': n_groups,
                   'bound_ms': {'fwd': 2 * n_bytes / HBM_BYTES_PER_S * 1e3,
                                'bwd': 3 * n_bytes / HBM_BYTES_PER_S * 1e3},
                   'ms': {}, 'regs': {}, 'ok': {}}
            for name, lib in libs.items():
                out = {'fwd': torch.empty_like(x), 'bwd': torch.empty_like(x)}
                stream = torch.cuda.current_stream().cuda_stream

                def check(rc):
                    if rc:
                        raise RuntimeError(f'{name}: CUDA error {rc}')

                launch = {
                    'fwd': lambda: check(lib.lrelu_pixel_norm_fwd(
                        x.data_ptr(), out['fwd'].data_ptr(), b, c, h * w,
                        n_groups, 0.2, 1e-8, code, stream)),
                    'bwd': lambda: check(lib.lrelu_pixel_norm_bwd(
                        x.data_ptr(), g.data_ptr(), out['bwd'].data_ptr(), b,
                        c, h * w, n_groups, 0.2, 1e-8, code, stream))}
                for kind, fn in launch.items():
                    fn()
                    torch.cuda.synchronize()
                    row['ok'][f'{name}_{kind}'] = bool(
                        _ok(out[kind], want[kind], TOL[kind]))
                    row['ms'][f'{name}_{kind}'] = device_ms(fn)
                    row['regs'][f'{name}_{kind}'] = lib.lrelu_pixel_norm_regs(
                        c // n_groups, code, int(kind == 'bwd'))
            print(json.dumps(row), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
