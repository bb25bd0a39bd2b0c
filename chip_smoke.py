#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (neuron_gan_tpu_torch) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py [--seed N]

Four paths of the port are driven, all at the flagship geometry (16^2 ..
512^2; ``flagship.PATHS``): the unpacked layout (``flagship_config``) and
the 2x2 packed layout with every kernel on (``flagship_packed_config``),
both float32 with TF32 off; the JAX package's shipping numerics on the 2x2
layout (``flagship_mixed_config``: 'mixed' at precision=None, fused level
boundaries, every kernel in bfloat16); and the JAX package's shipping step
(``flagship_shipping_config``: the mixed path with its 16-channel levels in
the 2x4 layout, their epilogues in K1/K2 at 8 groups, and the fast
augmentation with the shear warp).

Phases, each printing one JSON line:

1. env        torch/CUDA versions and the card (nvidia-smi name, power
              limit);
2. build      every CUDA kernel of the port, built from csrc/ with nvcc,
              all sources at once;
3. train      for each path: the PGGAN, random weights from --seed, trained
              with WGAN-GP + drift through the epoch runner under a
              schedule that visits every phase and fade-in and ends at
              steady 512^2; stats must be finite and every kernel's launch
              counter must rise by exactly the count the path implies (by
              dtype, K1/K2 also by grouping; over the steady steps every
              kernel also by shape, and K4 by live or absent r cotangent),
              and K1/K2 launch only their template instances;
              then steps/s over steady 512^2 steps.  It runs before any
              kernel is timed: the profiler has not run in the process;
4. kernels    each kernel against its plain PyTorch version on the card, in
              float32 and in bfloat16, at every shape a training path gives
              it (plus ragged cases): forward, backward and a GP-style
              second order, compared in the working type; K1/K2 also at
              group widths 1, 2 and 64, a width that takes the
              runtime-width instance, a 2-D input of more than 65,535
              rows and a storage offset, with each instance's registers
              and slice width read from the library; K4 also with r's
              cotangent absent, at H*W off its 16-byte vectors and on
              tensors with a storage offset; the packed conv forward (K3)
              also against a float64 run at the largest shape.  Device
              times (``runtime/timing.py::device_ms``: the kernels' own
              durations from torch.profiler, the L2 cache overwritten
              before each call)
              of K1/K2 at every path shape and of each kernel and its plain
              version at the largest; of K3 (and its plain version and
              F.conv2d) and of K4 (and its plain version) at every
              distinct packed shape, each beside its bound;
5. boundaries each fused level boundary of the mixed and shipping paths
              (the 2x4 ones too) against its decomposed chain at those
              paths' shapes (float32, TF32 off), and both forms' bfloat16
              times;
6. parity     for each path, one 512^2 batch step with the kernels, with the
              plain ops and with a reference (float32 paths: the plain ops
              in float64, and for the packed path also the plain unpacked
              step, TF32 off; the mixed path: the float32 plain packed
              step; the shipping path: the same at float32 'highest' with
              its boundaries fused), same parameters and draws: each
              network's gradient must lie within the path's relative-L2
              bound of the plain path and of the reference, and two
              planted faults must fail that bound (see ``parity``);
7. augment    the shipping augmentation (fast, shear 'auto') on the card
              against the same function on the CPU over the flagship
              stack at out 512, 256 and 32: source indices equal and
              values within 1e-5 except at rounding ties, which are
              counted (``check_augment``); its device time.

Then the kernel table (one JSON line: a float32 and a bfloat16 row for each
kernel, each with its launches per steady 512^2 step, as counted, and the
sum of their bounds; K4's with every shape's times), the card's nvidia-smi
line, and last ``{"ok": true, "device":
{...}}``.  Any failed check raises and the script
exits non-zero without that line; without CUDA it exits 2 at once.
"""

import argparse
import collections
import dataclasses
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

from neuron_gan_tpu_torch.flagship import (
    D_SHAPES, G_SHAPES, PACKED8_SHAPES, PACKED_SHAPES, PATHS,
    UNPACKED_OF_PACKED, epilogue_shapes, steady_step_sites)
from neuron_gan_tpu_torch.runtime.timing import device_ms


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=30, warmup=3):
    """Mean device time of ``fn`` in ms, by CUDA events over ``iters`` calls."""
    import torch
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


HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12     # H100 SXM bfloat16 tensor cores, dense

def epilogue_bound_ms(kernel, shape, itemsize):
    """Least time of K1 (x read, y written, about 6 float32 operations an
    element) or K2 (x and the cotangent read, dx written, about 12) on x of
    ``shape``: bound by its bytes."""
    numel = int(np.prod(shape))
    n_io, ops = (2, 6) if kernel == 'k1' else (3, 12)
    return max(n_io * numel * itemsize / HBM_BYTES_PER_S,
               ops * numel / F32_OPS_PER_S) * 1e3


def dz_bytes(shape, itemsize, live=True):
    """Bytes K4 must move for y of ``shape``: y and ct_y read, dz written
    (``itemsize`` each), r read and, when live, ct_r (float32)."""
    b, n, h, w = shape
    return 3 * b * n * h * w * itemsize + (2 if live else 1) * 4 * b * 4 * h * w


def dz_bound_ms(shape, itemsize, live=True):
    """Least time of K4: its bytes, against about 12 float32 operations an
    element of y (bound by the bytes)."""
    return max(dz_bytes(shape, itemsize, live) / HBM_BYTES_PER_S,
               12 * int(np.prod(shape)) / F32_OPS_PER_S) * 1e3


def ulp_bf16(t):
    """One bfloat16 ulp (8 significant bits) at the largest magnitude of t."""
    return 2.0 ** (np.floor(np.log2(t.float().abs().max().item())) - 7)


def within_ulps(torch, got, want, n=2):
    """got within n bfloat16 ulps of want's scale, elementwise; returns the
    largest error."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= n * ulp_bf16(want), (err, n * ulp_bf16(want))
    return err


def rel_l2(xs, ys):
    """Relative L2 distance of two lists of tensors, taken as one vector."""
    num = sum(((x.double() - y.double()) ** 2).sum() for x, y in zip(xs, ys))
    den = sum((y.double() ** 2).sum() for y in ys)
    return (num / den).sqrt().item()


def at_offset(torch, t, offset):
    """t's values in a view ``offset`` elements into its storage (t itself
    for 0): off 16-byte alignment, the kernels' scalar path."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


# ---------------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_epilogue_kernels(torch, lpn, seed):
    """K1/K2 (the LReLU + PixelNorm pair) against their plain versions:
    float32 by tolerance, bfloat16 within 2 bfloat16 ulps of the output's
    scale (both compute in float32 and round once)."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    dev = 'cuda'
    # largest errors: absolute on inputs of unit scale; width 2's float32
    # dx by relative L2; the small-x width-1 case relative to max |ref|
    err = {'fwd': 0.0, 'bwd': 0.0, 'fwd_bf16': 0.0, 'bwd_bf16': 0.0,
           'gp_bf16_rel_l2': 0.0, 'bwd_rel_l2': 0.0, 'small_x_rel': 0.0}
    checked = []

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(shape, n_groups, dtype, tol_f, tol_b, offset=False,
              x_scale=1.0, dx_rel_l2=None):
        x, g = (randn(shape) * x_scale).to(dtype), randn(shape, dtype)
        if offset:
            x, g = at_offset(torch, x, 1), at_offset(torch, g, 1)
            assert x.data_ptr() % 16 and g.data_ptr() % 16
        before = collections.Counter(lpn.launches_by_case)
        out = lpn._fwd(x, n_groups, 0.2, 1e-8)
        dx = lpn._bwd(x, g, n_groups, 0.2, 1e-8)
        torch.cuda.synchronize()
        # the instance the rule picks for this width launched
        runtime = lpn.kernel_instance(shape[1] // n_groups, dtype)[0] is None
        cases = lpn.launches_by_case - before
        assert cases == {(f'k{i}{"/runtime" if runtime else ""}', str(dtype)
                          .removeprefix('torch.'), tuple(shape), n_groups): 1
                         for i in (1, 2)}, cases
        ref = lpn.lrelu_pixel_norm_plain(x, n_groups)
        ref_dx = lpn.lrelu_pixel_norm_bwd_plain(x, g, n_groups)
        assert out.dtype == dtype and dx.dtype == dtype
        sfx = '' if dtype == torch.float32 else '_bf16'
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, **tol_f)
            e_f, e_b = (out - ref).abs().max().item(), 0.0
            if dx_rel_l2 is None:
                torch.testing.assert_close(dx, ref_dx, **tol_b)
                e_b = (dx - ref_dx).abs().max().item()
            else:
                dist = rel_l2([dx], [ref_dx])
                assert dist <= dx_rel_l2, (shape, n_groups, dist)
                err['bwd_rel_l2'] = max(err['bwd_rel_l2'], dist)
        else:
            e_f = within_ulps(torch, out, ref)
            e_b = within_ulps(torch, dx, ref_dx)
        if x_scale != 1.0:
            err['small_x_rel'] = max(
                err['small_x_rel'], e_f / ref.float().abs().max().item(),
                e_b / ref_dx.float().abs().max().item())
        else:
            err['fwd' + sfx] = max(err['fwd' + sfx], e_f)
            err['bwd' + sfx] = max(err['bwd' + sfx], e_b)
        checked.append({'shape': list(shape), 'n_groups': n_groups,
                        'dtype': str(dtype).replace('torch.', ''),
                        'runtime_width': runtime, 'offset': offset})

    f32_f = dict(rtol=1e-5, atol=1e-6)
    f32_b = dict(rtol=1e-4, atol=1e-5)
    for shape in G_SHAPES + D_SHAPES:
        check(shape, 1, torch.float32, f32_f, f32_b)
    for shape in sorted(set(PACKED_SHAPES)):
        check(shape, 4, torch.float32, f32_f, f32_b)
    check((8, 64, 16, 16), 8, torch.float32, f32_f, f32_b)
    check((3, 16, 5, 7), 1, torch.float32, f32_f, f32_b)     # ragged tail
    # every shape of the mixed and shipping paths in bfloat16, the 2x4
    # blocks' at 8 groups
    for shape in sorted(set(UNPACKED_OF_PACKED)):
        check(shape, 1, torch.bfloat16, None, None)
    for shape in sorted(set(PACKED_SHAPES)):
        check(shape, 4, torch.bfloat16, None, None)
    for shape in sorted(set(PACKED8_SHAPES)):
        check(shape, 8, torch.bfloat16, None, None)
    check((3, 16, 5, 7), 1, torch.bfloat16, None, None)
    check((8, 64, 16, 16), 8, torch.bfloat16, None, None)
    # the instances no path shape reaches, in both dtypes: group widths 1,
    # 2, 64 (and 8 above); a width with no template instance (24: the
    # runtime-width one); H*W off the 16-byte vector; a 2-D (rows, C) input
    # with more rows than a grid's y dimension takes; a storage offset.
    # Over one or two channels dx = g * r - y * k cancels where g lies
    # along y (at width 1 always: rounding noise of size g * r unless y^2
    # is of eps's order), so width 1 takes x of scale 1e-4 and width 2's
    # float32 dx is held as one vector, by relative L2 (float32 rounding,
    # 100x over)
    for dtype, tf, tb in ((torch.float32, f32_f, f32_b),
                          (torch.bfloat16, None, None)):
        check((8, 4, 32, 32), 4, dtype, tf, tb, x_scale=1e-4)
        check((8, 8, 32, 32), 4, dtype, tf, tb, dx_rel_l2=1e-5)
        check((8, 256, 16, 16), 4, dtype, tf, tb)
        check((8, 96, 16, 16), 4, dtype, tf, tb)
        check((3, 96, 5, 7), 4, dtype, tf, tb)
        check((2, 64, 9, 33), 4, dtype, tf, tb)
        check((70000, 32), 1, dtype, tf, tb)
        check((70000, 32), 4, dtype, tf, tb)
        check((8, 128, 32, 32), 4, dtype, tf, tb, offset=True)
        check((3, 16, 5, 7), 1, dtype, tf, tb, offset=True)

    # each instance's registers (-Xptxas -v's count, read from the built
    # library) and slice S, which must be the instance rule's
    instances = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix('torch.')
        for c_g in lpn.TEMPLATE_WIDTHS + (24,):
            width, s = lpn.kernel_instance(c_g, dtype)
            assert lpn.kernel_slice(c_g, dtype) == (s if width else 0), (
                dt, c_g, lpn.kernel_slice(c_g, dtype))
            instances[f'{dt}/{width or "runtime"}'] = {
                'slice': s, 'fwd_regs': lpn.kernel_regs(c_g, dtype),
                'bwd_regs': lpn.kernel_regs(c_g, dtype, bwd=True)}

    # GP-style second order through the autograd Functions: the gradient
    # norm of a toy critic (per-channel scale -> epilogue -> random linear
    # readout) w.r.t. its input, differentiated again w.r.t. the scales.
    # (One scalar scale, or a squared readout, would be degenerate:
    # PixelNorm is scale-invariant and fixes each pixel's sum of squares.)
    def gp_grad(epilogue, x, c, w0):
        w = w0.clone().requires_grad_()
        xr = x.clone().requires_grad_()
        gx, = torch.autograd.grad((epilogue(xr * w) * c).sum(), xr,
                                  create_graph=True)
        norms = torch.sqrt((gx ** 2).sum(dim=(1, 2, 3)))
        gw, = torch.autograd.grad(((norms - 1.0) ** 2).sum(), w)
        return gw

    for shape, n_groups in (((2, 16, 3, 3), 1), ((2, 16, 3, 3), 4),
                            ((8, 32, 64, 64), 1)):
        x, c = randn(shape), randn(shape)
        w0 = 0.5 + torch.rand((1, shape[1], 1, 1), generator=gen, device=dev)
        got = gp_grad(lambda v: lpn.lrelu_pixel_norm(v, n_groups), x, c, w0)
        want = gp_grad(lambda v: lpn.lrelu_pixel_norm_plain(v, n_groups),
                       x, c, w0)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        checked.append({'gp_second_order': list(shape), 'n_groups': n_groups})
    # bfloat16: K2 computes the LeakyReLU in float32, the plain backward
    # rounds it to bfloat16 first, so by relative L2
    for shape, n_groups in (((2, 16, 3, 3), 4), ((8, 64, 32, 32), 1),
                            ((8, 128, 32, 32), 4)):
        x, c = randn(shape), randn(shape)
        w0 = 0.5 + torch.rand((1, shape[1], 1, 1), generator=gen, device=dev)
        got = gp_grad(lambda v: lpn.lrelu_pixel_norm(
            v.bfloat16(), n_groups).float(), x, c, w0)
        want = gp_grad(lambda v: lpn.lrelu_pixel_norm_plain(
            v.bfloat16(), n_groups).float(), x, c, w0)
        dist = rel_l2([got], [want])
        assert dist <= BF16_TOL['gp_rel_l2'], (shape, n_groups, dist)
        err['gp_bf16_rel_l2'] = max(err['gp_bf16_rel_l2'], dist)
        checked.append({'gp_second_order': list(shape), 'n_groups': n_groups,
                        'dtype': 'bfloat16'})

    # device times at the largest shape of the unpacked path, (8, 16,
    # 512, 512), and in bfloat16 at the mixed path's largest, (8, 64, 256,
    # 256) at 4 groups (the same bytes); then the kernels alone at every
    # shape a path gives them
    shape, shape_bf16 = (8, 16, 512, 512), (8, 64, 256, 256)
    x, g = randn(shape), randn(shape)
    xb, gb = randn(shape_bf16, torch.bfloat16), randn(shape_bf16, torch.bfloat16)
    times = {
        'fwd_ms': device_ms(lambda: lpn._fwd(x, 1, 0.2, 1e-8)),
        'fwd_plain_ms': device_ms(lambda: lpn.lrelu_pixel_norm_plain(x)),
        'bwd_ms': device_ms(lambda: lpn._bwd(x, g, 1, 0.2, 1e-8)),
        'bwd_plain_ms': device_ms(lambda: lpn.lrelu_pixel_norm_bwd_plain(x, g)),
        'fwd_bf16_ms': device_ms(lambda: lpn._fwd(xb, 4, 0.2, 1e-8)),
        'fwd_bf16_plain_ms': device_ms(
            lambda: lpn.lrelu_pixel_norm_plain(xb, 4)),
        'bwd_bf16_ms': device_ms(lambda: lpn._bwd(xb, gb, 4, 0.2, 1e-8)),
        'bwd_bf16_plain_ms': device_ms(
            lambda: lpn.lrelu_pixel_norm_bwd_plain(xb, gb, 4)),
    }
    bounds = {'fwd': epilogue_bound_ms('k1', shape, 4),
              'bwd': epilogue_bound_ms('k2', shape, 4),
              'fwd_bf16': epilogue_bound_ms('k1', shape_bf16, 2),
              'bwd_bf16': epilogue_bound_ms('k2', shape_bf16, 2)}
    by_shape = []
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix('torch.')
        for shp, n_groups in sorted(epilogue_shapes(dtype)):
            xs, gs = randn(shp, dtype), randn(shp, dtype)
            item = xs.element_size()
            inst = instances[f'{dt}/{shp[1] // n_groups}']
            by_shape.append({
                'dtype': dt, 'x': list(shp), 'n_groups': n_groups,
                'fwd_ms': device_ms(lambda: lpn._fwd(xs, n_groups, 0.2, 1e-8)),
                'bwd_ms': device_ms(
                    lambda: lpn._bwd(xs, gs, n_groups, 0.2, 1e-8)),
                'fwd_plain_ms': device_ms(
                    lambda: lpn.lrelu_pixel_norm_plain(xs, n_groups)),
                'bwd_plain_ms': device_ms(
                    lambda: lpn.lrelu_pixel_norm_bwd_plain(xs, gs, n_groups)),
                'fwd_bound_ms': epilogue_bound_ms('k1', shp, item),
                'bwd_bound_ms': epilogue_bound_ms('k2', shp, item), **inst})
    return {'max_abs_err': err, 'checked': checked, 'timed_shape': list(shape),
            'timed_shape_bf16': list(shape_bf16), 'timed_n_groups_bf16': 4,
            **times, 'bound_ms': bounds, 'instances': instances,
            'by_shape': by_shape}


# Tolerances of the packed conv pair against its plain version (cuDNN's
# float32 conv, TF32 off), set from readings on an H100 (PERF.md).  y, r
# and dz elementwise.  dx and dw elementwise (atol relative to the
# tensor's largest magnitude) against the conv adjoints of the plain dz of
# the kernel's own (y, r); against the fully plain autograd, and for the GP
# second order, only as one vector by relative L2: the kernel's and
# cuDNN's pre-activations differ by rounding, and where one lies within
# that of 0, LeakyReLU's slope differs (1 against 0.2) for that element.
PACKED_TOL = {
    'fwd': dict(rtol=1e-4, atol=1e-5),
    'dz': dict(rtol=1e-4, atol=1e-5),
    # atol / max |ref| for dx, dw on the kernel's y, r: dw sums up to
    # B*H*W = 524,288 products, in an order cuDNN's wgrad may change from
    # run to run (1e-5 of the largest entry failed on an H100)
    'grad': 1e-4,
    'rel_l2': 1e-3,      # dx, dw and the GP gradients against plain autograd
}


# Tolerances of the kernels in bfloat16 against their plain versions, in
# the working type.  y, dz, and K1/K2's outputs elementwise within 2
# bfloat16 ulps of the output's scale (within_ulps).  K3's r against the
# plain version's: relative, since the plain version rounds the
# pre-activation to bfloat16 and the kernel does not.  dx, dw and the GP
# second order by relative L2, as in float32.  About 3x the largest
# reading on an H100 (PERF.md): r 3.6e-3, dx/dw 4.5e-3, GP 6.4e-3.
BF16_TOL = {'r_rtol': 1e-2, 'grad_rel_l2': 1.5e-2, 'gp_rel_l2': 2e-2}


def packed_case(torch, gen, b, k, n, h, w):
    """x (b, k, h, w) and an equalized packed kernel (n, k, 3, 3) built from
    a random original kernel, as the path builds it (3/4 zeros, which the
    forward kernel skips)."""
    from neuron_gan_tpu_torch.ops import packed as pk
    x = torch.randn((b, k, h, w), generator=gen, device='cuda')
    w = torch.randn((n // 4, k // 4, 3, 3), generator=gen, device='cuda')
    return x, pk.pack_conv3x3_weight(w, pk._eq_scale3x3(w, 0.2))


def _close_scaled(torch, got, want, rel_atol):
    atol = rel_atol * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


def check_packed_kernels(torch, pcl, seed):
    """K3/K4 (the fused packed conv pair) against their plain versions."""
    from neuron_gan_tpu_torch.runtime import precision_scope
    gen = torch.Generator(device='cuda').manual_seed(seed + 7)
    err = {'conv': 0.0, 'r': 0.0, 'dz': 0.0, 'dx': 0.0, 'dw': 0.0,
           'grad_rel_l2': 0.0, 'gp_rel_l2': 0.0}
    checked = []

    def pair(fn, x, wp, ct_y, ct_r):
        xr, wr = x.clone().requires_grad_(), wp.clone().requires_grad_()
        y, r = fn(xr, wr)
        dx, dw = torch.autograd.grad((y, r), (xr, wr), (ct_y, ct_r))
        return y.detach(), r.detach(), dx, dw

    def check(b, k, n, h, w):
        x, wp = packed_case(torch, gen, b, k, n, h, w)
        ct_y = torch.randn((b, n, h, w), generator=gen, device='cuda')
        ct_r = torch.randn((b, 4, h, w), generator=gen, device='cuda')
        y, r, dx, dw = pair(lambda a, v: pcl.PackedConvLReluPN.apply(
            a, v, 0.2, 1e-8), x, wp, ct_y, ct_r)
        y0, r0, dx0, dw0 = pair(pcl.packed_conv_lrelu_pn_plain, x, wp, ct_y,
                                ct_r)
        dz = pcl._dz(y, r, ct_y, ct_r, 0.2)
        dz0 = pcl.packed_dz_plain(y, r, ct_y, ct_r)
        dx1, dw1, _ = torch.ops.aten.convolution_backward(
            dz0, x, wp, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [True, True, False])
        torch.cuda.synchronize()
        torch.testing.assert_close(y, y0, **PACKED_TOL['fwd'])
        torch.testing.assert_close(r, r0, **PACKED_TOL['fwd'])
        torch.testing.assert_close(dz, dz0, **PACKED_TOL['dz'])
        _close_scaled(torch, dx, dx1, PACKED_TOL['grad'])
        _close_scaled(torch, dw, dw1, PACKED_TOL['grad'])
        dist = max(rel_l2([dx], [dx0]), rel_l2([dw], [dw0]))
        assert dist <= PACKED_TOL['rel_l2'], (b, k, n, h, w, dist)
        for key, a, b_ in (('conv', y, y0), ('r', r, r0), ('dz', dz, dz0),
                           ('dx', dx, dx1), ('dw', dw, dw1)):
            err[key] = max(err[key], (a - b_).abs().max().item())
        err['grad_rel_l2'] = max(err['grad_rel_l2'], dist)
        checked.append({'x': [b, k, h, w], 'n': n})

    # GP-style second order through both Functions, ct_r live: per-input-
    # channel scales, a random linear readout, gradient w.r.t. the scales
    # and the kernel (the harness of the epilogue check above and of
    # tests/test_torch_packed.py)
    def gp_grads(fn, x, wp, c, s0):
        s, w = s0.clone().requires_grad_(), wp.clone().requires_grad_()
        xr = x.clone().requires_grad_()
        gx, = torch.autograd.grad((fn(xr * s, w)[0] * c).sum(), xr,
                                  create_graph=True)
        norms = torch.sqrt((gx ** 2).sum(dim=(1, 2, 3)))
        return torch.autograd.grad(((norms - 1.0) ** 2).sum(), (s, w))

    def check_gp(b, k, n, h, w):
        x, wp = packed_case(torch, gen, b, k, n, h, w)
        c = 0.1 * torch.randn((b, n, h, w), generator=gen, device='cuda')
        s0 = 0.5 + torch.rand((1, k, 1, 1), generator=gen, device='cuda')
        got = gp_grads(lambda a, v: pcl.PackedConvLReluPN.apply(
            a, v, 0.2, 1e-8), x, wp, c, s0)
        want = gp_grads(pcl.packed_conv_lrelu_pn_plain, x, wp, c, s0)
        dist = max(rel_l2([a], [b_]) for a, b_ in zip(got, want))
        assert dist <= PACKED_TOL['rel_l2'], (b, k, n, h, w, dist)
        err['gp_rel_l2'] = max(err['gp_rel_l2'], dist)
        checked.append({'gp_second_order': [b, k, h, w], 'n': n})

    with precision_scope('highest'):
        for _, n, h, w in PACKED_SHAPES:
            check(8, n, n, h, w)
        check(3, 20, 32, 5, 37)                  # ragged: K, H and W tails
        check(2, 64, 16, 9, 33)                  # the narrowest width
        for shape in ((2, 64, 64, 8, 8), (8, 128, 128, 32, 32),
                      (8, 64, 64, 128, 128)):
            check_gp(*shape)

        # K3 and the plain version against a float64 plain run at the
        # largest site of the path, x (8, 64, 256, 256): K3's largest error
        # (relative to the output's largest magnitude, y and r) may be at
        # most twice the float32 plain version's
        b, k, n, side = 8, 64, 64, 256
        x, wp = packed_case(torch, gen, b, k, n, side, side)
        y, r = pcl._conv_fwd(x, wp, 0.2, 1e-8)
        y0, r0 = pcl.packed_conv_lrelu_pn_plain(x, wp)
        y64, r64 = pcl.packed_conv_lrelu_pn_plain(x.double(), wp.double())

        def rel_max(pair):
            return max(((a.double() - b_).abs().max() / b_.abs().max()).item()
                       for a, b_ in zip(pair, (y64, r64)))

        vs64 = {'conv': rel_max((y, r)), 'plain': rel_max((y0, r0))}
        assert vs64['conv'] <= 2 * vs64['plain'], vs64
        del y64, r64

        by_shape = conv_by_shape(torch, pcl, gen, torch.float32)
    largest = by_shape[[e['x'] for e in by_shape].index([b, k, side, side])]
    times = {'conv_ms': largest['wrapper_ms'],
             'conv_plain_ms': largest['plain_ms'],
             'conv_library_ms': largest['library_ms']}
    # least work: the conv over the nonzero taps of this w_packed as K3
    # does it (conv_bound), against the bytes; beside it the same taps on
    # the float32 pipes (what a float32 kernel would need) and the dense
    # count (every tap of w_packed, its zeros included)
    pix = b * side * side
    nonzero_macs = int(torch.count_nonzero(wp)) * pix
    conv_f32_ops = 2 * nonzero_macs + 8 * pix * n
    conv_dense_ops = 2 * 9 * k * n * pix + 8 * pix * n
    n_bytes = largest['bytes']

    def bound(n_ops):
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
        return (max(t_bytes, t_ops) * 1e3,
                'bytes' if t_bytes > t_ops else 'operations')

    bounds = {'conv': (largest['bound_ms'], largest['bound_by']),
              'conv_f32': bound(conv_f32_ops),
              'conv_dense': bound(conv_dense_ops)}
    return {'max_abs_err': err, 'checked': checked,
            'rel_max_err_vs_float64': vs64,
            'timed_x': [b, k, side, side], 'timed_n': n, **times,
            'conv_by_shape': by_shape,
            'flop': {'conv': largest['flop'], 'conv_f32': conv_f32_ops,
                     'conv_dense': conv_dense_ops},
            'bound_ms': {key: v[0] for key, v in bounds.items()},
            'bound_by': {key: v[1] for key, v in bounds.items()}}


def conv_bound(x_shape, n, nonzero_w, itemsize):
    """(bytes, operations, least ms, 'bytes' or 'operations') of K3 on x
    of ``x_shape`` into N channels: x read and y written in the working
    type, the weights and r float32; the products over w_packed's
    ``nonzero_w`` nonzero taps as K3 runs them on the tensor cores (three
    TF32 products a multiply-add in float32, one bfloat16 product in
    bfloat16)."""
    b, k, h, w = x_shape
    pix = b * h * w
    n_bytes = itemsize * pix * (k + n) + 4 * n * k * 9 + 4 * pix * 4
    if itemsize == 4:
        n_ops, rate = 3 * 2 * nonzero_w * pix, TF32_OPS_PER_S
    else:
        n_ops, rate = 2 * nonzero_w * pix, BF16_OPS_PER_S
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / rate
    return (n_bytes, n_ops, max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes > t_ops else 'operations')


def conv_by_shape(torch, pcl, gen, dtype):
    """K3 at each distinct packed conv2 shape of the path, device times
    (device_ms): its two kernels alone, the whole wrapper (the weight
    gather too), the plain version and F.conv2d (with w_packed in x's
    type); its bound beside."""
    rows = []
    for _, n, h, w in sorted(set(PACKED_SHAPES)):
        xs, wps = packed_case(torch, gen, 8, n, n, h, w)
        xs = xs.to(dtype)
        wds = wps.to(dtype)
        launch, _, _ = pcl.conv_fwd_launcher(xs, wps)
        n_bytes, n_ops, bound_ms, bound_by = conv_bound(
            xs.shape, n, int(torch.count_nonzero(wps)), xs.element_size())
        rows.append({
            'x': [8, n, h, w], 'n': n,
            'smem_bytes': pcl.conv_fwd_smem(n, dtype),
            'kernels_ms': device_ms(launch),
            'wrapper_ms': device_ms(lambda: pcl._conv_fwd(xs, wps, 0.2, 1e-8)),
            'plain_ms': device_ms(
                lambda: pcl.packed_conv_lrelu_pn_plain(xs, wps)),
            'library_ms': device_ms(lambda: torch.nn.functional.conv2d(
                xs, wds, padding=1)),
            'bytes': n_bytes, 'flop': n_ops, 'bound_ms': bound_ms,
            'bound_by': bound_by})
    return rows


def check_packed_kernels_bf16(torch, pcl, seed):
    """K3/K4 in bfloat16 against their plain versions (F.conv2d in
    bfloat16, then the float32 epilogue; the float32 dz math), in the
    working type (BF16_TOL): x, y, the cotangent of y and dz in bfloat16,
    w_packed, r and its cotangent in float32."""
    gen = torch.Generator(device='cuda').manual_seed(seed + 11)
    bf = torch.bfloat16
    err = {'conv': 0.0, 'r_rel': 0.0, 'dz': 0.0, 'dx_dw_rel_l2': 0.0,
           'grad_rel_l2': 0.0, 'gp_rel_l2': 0.0}
    checked = []

    def pair(fn, x, wp, ct_y, ct_r):
        xr, wr = x.clone().requires_grad_(), wp.clone().requires_grad_()
        y, r = fn(xr, wr)
        dx, dw = torch.autograd.grad((y, r), (xr, wr), (ct_y, ct_r))
        return y.detach(), r.detach(), dx, dw

    def check(b, k, n, h, w):
        x, wp = packed_case(torch, gen, b, k, n, h, w)
        x = x.to(bf)
        ct_y = torch.randn((b, n, h, w), generator=gen, device='cuda').to(bf)
        ct_r = torch.randn((b, 4, h, w), generator=gen, device='cuda')
        y, r, dx, dw = pair(lambda a, v: pcl.PackedConvLReluPN.apply(
            a, v, 0.2, 1e-8), x, wp, ct_y, ct_r)
        y0, r0, dx0, dw0 = pair(pcl.packed_conv_lrelu_pn_plain, x, wp, ct_y,
                                ct_r)
        dz = pcl._dz(y, r, ct_y, ct_r, 0.2)
        dz0 = pcl.packed_dz_plain(y, r, ct_y, ct_r)
        dx1, dw1, _ = torch.ops.aten.convolution_backward(
            dz0, x, wp.to(bf), None, [1, 1], [1, 1], [1, 1], False, [0, 0],
            1, [True, True, False])
        torch.cuda.synchronize()
        assert (y.dtype, r.dtype, dz.dtype, dx.dtype, dw.dtype) == (
            bf, torch.float32, bf, bf, torch.float32)
        err['conv'] = max(err['conv'], within_ulps(torch, y, y0))
        r_rel = ((r - r0).abs() / r0.abs()).max().item()
        assert r_rel <= BF16_TOL['r_rtol'], (b, k, n, h, w, r_rel)
        err['r_rel'] = max(err['r_rel'], r_rel)
        err['dz'] = max(err['dz'], within_ulps(torch, dz, dz0))
        own = max(rel_l2([dx], [dx1]), rel_l2([dw], [dw1.float()]))
        dist = max(rel_l2([dx], [dx0]), rel_l2([dw], [dw0]))
        assert max(own, dist) <= BF16_TOL['grad_rel_l2'], (b, k, n, h, w,
                                                          own, dist)
        err['dx_dw_rel_l2'] = max(err['dx_dw_rel_l2'], own)
        err['grad_rel_l2'] = max(err['grad_rel_l2'], dist)
        checked.append({'x': [b, k, h, w], 'n': n, 'dtype': 'bfloat16'})

    def gp_grads(fn, x, wp, c, s0):
        s, w = s0.clone().requires_grad_(), wp.clone().requires_grad_()
        xr = x.clone().requires_grad_()
        y = fn((xr * s).to(bf), w)[0]
        gx, = torch.autograd.grad((y.float() * c).sum(), xr, create_graph=True)
        norms = torch.sqrt((gx ** 2).sum(dim=(1, 2, 3)))
        return torch.autograd.grad(((norms - 1.0) ** 2).sum(), (s, w))

    def check_gp(b, k, n, h, w):
        x, wp = packed_case(torch, gen, b, k, n, h, w)
        c = 0.1 * torch.randn((b, n, h, w), generator=gen, device='cuda')
        s0 = 0.5 + torch.rand((1, k, 1, 1), generator=gen, device='cuda')
        got = gp_grads(lambda a, v: pcl.PackedConvLReluPN.apply(
            a, v, 0.2, 1e-8), x, wp, c, s0)
        want = gp_grads(pcl.packed_conv_lrelu_pn_plain, x, wp, c, s0)
        dist = max(rel_l2([a], [b_]) for a, b_ in zip(got, want))
        assert dist <= BF16_TOL['gp_rel_l2'], (b, k, n, h, w, dist)
        err['gp_rel_l2'] = max(err['gp_rel_l2'], dist)
        checked.append({'gp_second_order': [b, k, h, w], 'n': n,
                        'dtype': 'bfloat16'})

    for _, n, h, w in PACKED_SHAPES:
        check(8, n, n, h, w)
    check(3, 20, 32, 5, 38)                  # ragged: K, H and W tails
    check(2, 64, 16, 9, 34)                  # the narrowest width
    for shape in ((2, 64, 64, 8, 8), (8, 128, 128, 32, 32),
                  (8, 64, 64, 128, 128)):
        check_gp(*shape)

    # K3 and the plain version against float64 on the same bfloat16
    # inputs (x and the weights as the kernel rounds them) at the largest
    # site: K3's largest error, relative to the output's largest
    # magnitude, at most 1.5x the plain bfloat16 version's
    b, k, n, side = 8, 64, 64, 256
    x, wp = packed_case(torch, gen, b, k, n, side, side)
    x = x.to(bf)
    y, r = pcl._conv_fwd(x, wp, 0.2, 1e-8)
    y0, r0 = pcl.packed_conv_lrelu_pn_plain(x, wp)
    y64, r64 = pcl.packed_conv_lrelu_pn_plain(x.double(),
                                              wp.to(bf).double())

    def rel_max(pair_):
        return max(((a.double() - b_).abs().max() / b_.abs().max()).item()
                   for a, b_ in zip(pair_, (y64, r64)))

    vs64 = {'conv': rel_max((y, r)), 'plain': rel_max((y0, r0))}
    assert vs64['conv'] <= 1.5 * vs64['plain'], vs64
    del y64, r64

    by_shape = conv_by_shape(torch, pcl, gen, bf)
    largest = by_shape[[e['x'] for e in by_shape].index([b, k, side, side])]
    times = {'conv_ms': largest['wrapper_ms'],
             'conv_plain_ms': largest['plain_ms'],
             'conv_library_ms': largest['library_ms']}
    return {'max_abs_err': err, 'checked': checked,
            'rel_max_err_vs_float64': vs64,
            'timed_x': [b, k, side, side], 'timed_n': n, **times,
            'conv_by_shape': by_shape,
            'flop': {'conv': largest['flop']},
            'bound_ms': {'conv': largest['bound_ms']},
            'bound_by': {'conv': largest['bound_by']}}


# K4's extra cases, y (B, N, H, W): H*W not a multiple of the kernel's
# 16-byte vector (the smoke's ragged conv cases: its scalar path), and a
# vector-path case whose last warp is partial
DZ_TAILS = {'float32': [(3, 32, 5, 37), (2, 16, 9, 33), (3, 128, 8, 12)],
            'bfloat16': [(3, 32, 5, 38), (2, 16, 9, 34), (3, 128, 8, 12)]}


def check_dz_kernel(torch, pcl, seed):
    """K4 alone against its plain version, float32 elementwise at
    PACKED_TOL['dz'] and bfloat16 within 2 bfloat16 ulps: at every path
    shape and the DZ_TAILS, with r's cotangent live and absent (None: a
    null pointer), and on tensors with a storage offset (not 16-byte
    aligned: the scalar path).  Then, at each path shape, the device times
    of the kernel (ct_r live and absent) and of the plain version, its
    bound and the kernel's registers."""
    gen = torch.Generator(device='cuda').manual_seed(seed + 17)

    def case(shape, dtype, offset=0):
        """y, r, ct_y, ct_r at y's ``shape``, each ``offset`` elements into
        its storage."""
        b, _, h, w = shape
        y = torch.randn(shape, generator=gen, device='cuda').to(dtype)
        g = torch.randn(shape, generator=gen, device='cuda').to(dtype)
        r = 0.5 + torch.rand((b, 4, h, w), generator=gen, device='cuda')
        ct_r = torch.randn((b, 4, h, w), generator=gen, device='cuda')
        return [at_offset(torch, t, offset) for t in (y, r, g, ct_r)]

    err, checked, rows = {}, [], []
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix('torch.')
        err[dt] = 0.0

        def check(y, r, g, ct_r, what):
            got = pcl._dz(y, r, g, ct_r, 0.2)
            want = pcl.packed_dz_plain(y, r, g, ct_r)
            torch.cuda.synchronize()
            assert got.dtype == dtype, (what, got.dtype)
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, **PACKED_TOL['dz'])
                e = (got - want).abs().max().item()
            else:
                e = within_ulps(torch, got, want)
            err[dt] = max(err[dt], e)
            checked.append({'y': list(y.shape), 'dtype': dt, 'case': what})

        shapes = sorted(set(PACKED_SHAPES))
        for shape in shapes + DZ_TAILS[dt]:
            y, r, g, ct_r = case(shape, dtype)
            check(y, r, g, ct_r, 'live')
            check(y, r, g, None, 'absent')
        y, r, g, ct_r = case((8, 128, 32, 32), dtype, offset=1)
        assert y.data_ptr() % 16 and r.data_ptr() % 16
        check(y, r, g, ct_r, 'storage offset, live')
        check(y, r, g, None, 'storage offset, absent')

        for shape in shapes:
            y, r, g, ct_r = case(shape, dtype)
            item = y.element_size()
            rows.append({
                'dtype': dt, 'y': list(shape),
                'ms': device_ms(lambda: pcl._dz(y, r, g, ct_r, 0.2)),
                'ms_ct_r_absent': device_ms(lambda: pcl._dz(y, r, g, None, 0.2)),
                'plain_ms': device_ms(lambda: pcl.packed_dz_plain(y, r, g, ct_r)),
                'bytes': dz_bytes(shape, item),
                'bound_ms': dz_bound_ms(shape, item),
                'bound_ms_ct_r_absent': dz_bound_ms(shape, item, live=False),
                'bound_by': 'bytes',
                'regs': pcl.dz_regs(shape[1], dtype)})
    return {'max_abs_err': err, 'checked': checked, 'by_shape': rows}


# ---------------------------------------------------------------------------
# phase 5: the fused level boundaries against their decomposed chains
# ---------------------------------------------------------------------------

def boundary_cases(cfg):
    """(name, input shape, weight (Co, Ci)) of every fused level boundary of
    a 512^2 step of ``cfg`` at batch 8: G blocks whose convs run packed
    ('up2', or 'up2_p8' into the 2x4 layout), D blocks entered packed
    ('pool2', 'pool2_unpacked'; from the 2x4 layout 'pool2_p8', or
    'pool2_p8_exit' into the 2x2 layout)."""
    from neuron_gan_tpu_torch.models.pggan import (
        _want_packed, _want_packed8_d, _want_packed8_g)
    f_g, f_d, cases = cfg.n_gen_features, cfg.n_dis_features, []
    for i in range(1, cfg.n_layers_max - 1):
        out = cfg.resolution(i + 1)
        if _want_packed(cfg, out):
            r = cfg.resolution(i)
            name = 'up2_p8' if _want_packed8_g(cfg, out, f_g[i + 1]) else 'up2'
            cases.append((name, (8, f_g[i], r, r), (f_g[i + 1], f_g[i])))
    in_p8 = _want_packed8_d(cfg, cfg.image_size_max, f_d[0])
    for i in range(cfg.n_layers_max - 1):
        entry = cfg.image_size_max // 2 ** i
        half, weight = entry // 2, (f_d[i + 1], f_d[i])
        out_p8 = in_p8 and _want_packed8_d(cfg, half, f_d[i + 1])
        if in_p8 and _want_packed(cfg, half):
            name = 'pool2_p8' if out_p8 else 'pool2_p8_exit'
            cases.append((name, (8, 8 * f_d[i], half, half // 2), weight))
        elif _want_packed(cfg, entry):
            name = 'pool2' if _want_packed(cfg, half) else 'pool2_unpacked'
            cases.append((name, (8, 4 * f_d[i], half, half), weight))
        in_p8 = out_p8
    return cases


def check_boundaries(torch, seed, cfgs):
    """Each fused boundary (ops/packed.py) of the paths of ``cfgs`` against
    its decomposed chain at the paths' shapes, float32 with TF32 off:
    forward elementwise (rtol 1e-4, atol 1e-5 of the output's scale),
    input and weight gradients by relative L2 (at most 5e-5: sums
    reordered, the weight gradient's over up to 2^19 products); and the
    bfloat16 times of both forms, forward."""
    from neuron_gan_tpu_torch.ops import equalized_conv2d, upsample2_bilinear
    from neuron_gan_tpu_torch.ops import packed as pk
    from neuron_gan_tpu_torch.runtime import precision_scope
    gen = torch.Generator(device='cuda').manual_seed(seed + 13)

    def pooled(x, w):    # the 2x4 input's decomposed D chain, 2x2 output
        return pk.packed_equalized_conv3x3(
            pk.space_to_depth(pk.packed_avg_pool2(pk.depth_to_space_w(x))), w)

    chains = {
        'up2': (lambda x, w: pk.up2_equalized_conv3x3(x, w),
                lambda x, w: pk.packed_equalized_conv3x3(
                    pk.space_to_depth(upsample2_bilinear(x)), w)),
        'up2_p8': (lambda x, w: pk.up2_equalized_conv3x3_p8(x, w),
                   lambda x, w: pk.space_to_depth_w(pk.packed_equalized_conv3x3(
                       pk.space_to_depth(upsample2_bilinear(x)), w))),
        'pool2': (lambda x, w: pk.pool2_equalized_conv3x3(x, w),
                  lambda x, w: pk.packed_equalized_conv3x3(
                      pk.space_to_depth(pk.packed_avg_pool2(x)), w)),
        'pool2_p8': (lambda x, w: pk.pool2_equalized_conv3x3_p8(x, w),
                     lambda x, w: pk.space_to_depth_w(pooled(x, w))),
        'pool2_p8_exit': (lambda x, w: pk.pool2_equalized_conv3x3_p8(
            x, w, out_packed8=False), pooled),
        'pool2_unpacked': (
            lambda x, w: pk.pool2_unpacked_equalized_conv3x3(x, w),
            lambda x, w: equalized_conv2d(pk.packed_avg_pool2(x), w,
                                          padding=1)),
    }
    cases = list(dict.fromkeys(c for cfg in cfgs for c in boundary_cases(cfg)))
    out = []
    for name, xs, (co, ci) in cases:
        fused, chain = chains[name]
        x = torch.randn(xs, generator=gen, device='cuda')
        w = torch.randn((co, ci, 3, 3), generator=gen, device='cuda')
        res = []
        with precision_scope('highest'):
            for fn in (fused, chain):
                xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
                y = fn(xr, wr)
                ct = torch.randn(y.shape, generator=torch.Generator(
                    device='cuda').manual_seed(seed), device='cuda')
                res.append((y.detach(), *torch.autograd.grad(y, (xr, wr), ct)))
        (y, dx, dw), (y0, dx0, dw0) = res
        close = torch.allclose(y, y0, rtol=1e-4,
                               atol=1e-5 * y0.abs().max().item())
        grad = max(rel_l2([dx], [dx0]), rel_l2([dw], [dw0]))
        xb = x.bfloat16()
        with precision_scope(None):
            ms = {'fused_bf16_ms': cuda_ms(lambda: fused(xb, w)),
                  'decomposed_bf16_ms': cuda_ms(lambda: chain(xb, w))}
        out.append({'boundary': name, 'x': list(xs), 'co': co,
                    'close': close,
                    'max_abs_err': (y - y0).abs().max().item(),
                    'grad_rel_l2': grad, **ms})
    result = {'phase': 'boundaries', 'cases': out}
    assert all(c['close'] and c['grad_rel_l2'] <= 5e-5 for c in out), result
    return result


# ---------------------------------------------------------------------------
# phase 7: the fast augmentation on the card against the CPU
# ---------------------------------------------------------------------------

AUGMENT_TIE = 1e-5     # the CPU tests' rule (tests/test_torch_augment_fast.py)


def check_augment(torch, seed):
    """The shipping augmentation (fast, shear 'auto') on the card against
    the same function on the CPU, over the flagship stack (8, 768, 768, 1)
    at out 512, 256 (shear warp) and 32 (gather warp), the same draws.

    Every window pixel's source index equal, and its value within 1e-5,
    except where one of the warp's coordinates before rounding (the shear
    shifts, or the gather's source coordinates) lies within 1e-5 of a
    half-integer on the CPU: there torch's libm and CUDA's tan/sin/cos may
    round apart.  Those pixels are counted; fewer than 0.1% of them."""
    from neuron_gan_tpu_torch.data import augment as aug
    from neuron_gan_tpu_torch.runtime import precision_scope
    from neuron_gan_tpu_torch.train_step import resolve_shear
    raw = torch.from_numpy(np.random.default_rng(seed + 5).random(
        (8, 768, 768, 1)).astype(np.float32))
    raw_dev = raw.to('cuda')
    rows = []
    for out in (512, 256, 32):
        spec = aug.AugmentSpec(crop_size=512, out_size=out, translation=0.05,
                               fast=True, shear=resolve_shear('auto', out))
        draws = aug.draw_augment(torch.Generator().manual_seed(seed + out), 8,
                                 768, spec)
        draws_dev = {k: v.to('cuda') for k, v in draws.items()}
        want = aug.augment_batch(raw, draws, spec)
        with precision_scope(None):       # as the shipping step runs it
            got = aug.augment_batch(raw_dev, draws_dev, spec)
            ms = cuda_ms(lambda: aug.augment_batch(raw_dev, draws_dev, spec),
                         iters=10)
        p = aug.warp_frame(spec, 768)
        window = (int(round((p - out) / 2.0)), out)
        source = aug.shear_source if spec.shear else aug.affine_source
        geom = [draws[k] for k in ('angle', 'tx', 'ty', 'flip')]
        iy, ix, coords = source(p, window, *geom)
        iy_d, ix_d, _ = source(p, window, *[t.to('cuda') for t in geom])
        tie = ((coords - coords.floor() - 0.5).abs() < AUGMENT_TIE).any(0)
        moved = (iy_d.cpu() != iy) | (ix_d.cpu() != ix)
        err = (got.cpu() - want).abs()[:, 0]
        row = {'out': out, 'frame': p, 'warp': 'shear' if spec.shear
               else 'gather', 'pixels': tie.numel(),
               'tie_pixels': int(tie.sum()),
               'moved_at_ties': int((moved & tie).sum()),
               'moved_elsewhere': int((moved & ~tie).sum()),
               'max_abs_err': err[~tie].max().item(), 'ms': ms}
        rows.append(row)
        assert got.shape == (8, 1, out, out) and torch.isfinite(got).all(), row
        assert not row['moved_elsewhere'] and row['max_abs_err'] <= 1e-5, row
        assert row['tie_pixels'] < 1e-3 * row['pixels'], row
    return {'phase': 'augment', 'cases': rows,
            'shear_fallbacks': sum(aug.shear_fallbacks.values())}


# ---------------------------------------------------------------------------
# phase 3: the main paths
# ---------------------------------------------------------------------------

def launch_key(dtype, n_groups=None):
    """A launch counter's key as reported: 'float32' or 'bfloat16', and for
    K1/K2 the grouping after a slash ('bfloat16/4')."""
    return dtype if n_groups is None else f'{dtype}/{n_groups}'


def block_layouts(cfg, phase):
    """The layout of each block a step of ``cfg`` at ``phase`` runs, G's
    then D's: 'unpacked' (two K1 at 1 group), 'packed' (the 2x2 layout: a
    K1 at 4 groups and a K3) or 'p8' (the 2x4 layout: two K1 at 8
    groups), by the JAX package's routing rules (models/pggan.py's
    predicates): a G block enters the 2x4 layout natively at a fused
    up-conv, a D block stays in it where its input is 2x4, and a 2x2 block
    of 64 packed channels runs its tail in it."""
    from neuron_gan_tpu_torch.models.pggan import (
        _want_packed, _want_packed8_d, _want_packed8_g)
    f_g, f_d, n = cfg.n_gen_features, cfg.n_dis_features, cfg.n_layers_max

    def layout(native, res, feat):
        if not _want_packed(cfg, res):
            return 'unpacked'
        tail8 = (cfg.packed_lanes == 128 and 4 * feat == 64
                 and (res // 2) % 2 == 0)
        return 'p8' if native or tail8 else 'packed'

    g = [layout(_want_packed8_g(cfg, cfg.resolution(i + 1), f_g[i + 1]),
                cfg.resolution(i + 1), f_g[i + 1]) for i in range(phase)]
    d, res = [], cfg.resolution(phase)
    in_p8 = _want_packed8_d(cfg, res, f_d[n - 1 - phase])
    for i in range(n - 1 - phase, n - 1):
        res //= 2
        in_p8 = in_p8 and _want_packed8_d(cfg, res, f_d[i + 1])
        d.append(layout(in_p8, res, f_d[i + 1]))
    return g, d


def expected_launches(cfg, phases_per_step):
    """Kernel launches of batch steps of ``cfg`` at these phases, keyed by
    ``launch_key``, as tests/test_torch_train_step.py and
    tests/test_torch_packed8.py count them on the CPU.

    Per step: G runs 3 forwards and 1 backward; D runs 4 forwards (real,
    fake, the GP's interpolate, the generator step) and 5 backwards (real,
    fake, the GP's inner pass, the GP's outer pass back through the
    interpolate's forward, the generator step).  Each block launches by
    its layout (``block_layouts``); each K1 forward has its K2 in a
    backward, each K3 its K4.  Every launch takes the blocks' dtype
    (cfg.dtype): the fused level boundaries change no count."""
    dt = str(cfg.dtype).removeprefix('torch.')
    k1, k2, k3, k4 = (collections.Counter() for _ in range(4))
    groups = {'unpacked': 1, 'packed': 4, 'p8': 8}
    for p in phases_per_step:
        if not cfg.use_kernels:
            continue
        g, d = block_layouts(cfg, p)
        for layouts, fwd, bwd in ((g, 3, 1), (d, 4, 5)):
            for lay in layouts:
                key = launch_key(dt, groups[lay])
                n = 1 if lay == 'packed' else 2
                k1[key] += n * fwd
                k2[key] += n * bwd
                if lay == 'packed':
                    k3[dt] += fwd
                    k4[dt] += bwd
    return {k: dict(+c) for k, c in
            (('k1', k1), ('k2', k2), ('k3', k3), ('k4', k4))}


def reset_counters():
    import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn
    import neuron_gan_tpu_torch.ops.packed_conv_lrelu_pn as pcl
    for counter in (lpn.fwd_launches, lpn.bwd_launches, pcl.conv_launches,
                    pcl.dz_launches, lpn.launches_by_case,
                    pcl.launches_by_case):
        counter.clear()


def read_counters():
    import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn
    import neuron_gan_tpu_torch.ops.packed_conv_lrelu_pn as pcl
    return {'k1': {launch_key(*k): n for k, n in lpn.fwd_launches.items()},
            'k2': {launch_key(*k): n for k, n in lpn.bwd_launches.items()},
            'k3': dict(pcl.conv_launches), 'k4': dict(pcl.dz_launches)}


def read_cases():
    """Every kernel's launches by (kernel, dtype name, shape, case), as the
    wrappers count them (``launches_by_case``)."""
    import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn
    import neuron_gan_tpu_torch.ops.packed_conv_lrelu_pn as pcl
    return lpn.launches_by_case + pcl.launches_by_case


def train(torch, seed, cfg, name):
    from neuron_gan_tpu_torch.data import augment
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    from neuron_gan_tpu_torch.schedule import TrainSchedule
    from neuron_gan_tpu_torch.train_step import (
        init_train_state, make_epoch_runner, spec_for_chunk)

    init = torch.Generator().manual_seed(seed)
    state = init_train_state(GeneratorPG(cfg, init, device='cuda'),
                             DiscriminatorPG(cfg, init, device='cuda'))
    # a padded 768x768 stack like the real dataset (512 + 2*128), as the
    # JAX package's bench.py builds it
    stack = np.random.default_rng(seed).random((16, 768, 768, 1)).astype(np.float32)
    images = torch.from_numpy(stack).to('cuda')
    rng = torch.Generator(device='cuda').manual_seed(seed)
    sched = TrainSchedule(transit_sch=(2, 4, 6, 8, 10), alpha_step=0.5,
                          n_epochs=12, checkpointing_period=100, lr0=1e-4)
    base = PATHS[name][1](0)
    steps_per_epoch = base.n_images // base.batch_size
    n_timed_epochs = 5

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counters()
    augment.shear_fallbacks.clear()
    chunks, step_phases = [], []
    t_run = time.perf_counter()
    for start, end in sched.plan_chunks(1, sched.n_epochs + 1):
        spec = spec_for_chunk(sched, start, base)
        t0 = time.perf_counter()
        stats = make_epoch_runner(cfg, spec, end - start + 1)(
            state, images, rng, start)
        stats = stats.cpu().numpy()
        assert np.isfinite(stats).all(), (name, start, stats)
        chunks.append({'epochs': [start, end], 'phase': spec.phase,
                       'fading': spec.fading,
                       'seconds': round(time.perf_counter() - t0, 3),
                       'D_loss': stats[:, 2].tolist()})
        step_phases += [spec.phase] * steps_per_epoch * (end - start + 1)
    schedule_s = time.perf_counter() - t_run
    assert chunks[-1]['phase'] == cfg.n_phases - 1 and not chunks[-1]['fading']

    # steady 512^2 throughput: the runner at the schedule's last chunk
    spec = spec_for_chunk(sched, sched.n_epochs, base)
    run = make_epoch_runner(cfg, spec, n_timed_epochs)
    before = read_cases()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = run(state, images, rng, sched.n_epochs + 1).cpu().numpy()
    dt = time.perf_counter() - t0
    assert np.isfinite(stats).all(), (name, stats)
    step_phases += [spec.phase] * steps_per_epoch * n_timed_epochs
    launches = read_counters()
    want = expected_launches(cfg, step_phases)
    assert launches == want, (name, launches, want)
    # every kernel per steady step by shape and case (K1/K2: grouping;
    # K4: r's cotangent live or absent), against the path's launch sites
    # (which the CPU tests hold against expected_launches)
    n_steady = steps_per_epoch * n_timed_epochs
    steady = read_cases()
    steady.subtract(before)
    per_step = {key: n / n_steady for key, n in steady.items() if n}
    dt_name = str(cfg.dtype).removeprefix('torch.')
    want_sites = {(k, dt_name, shape, case): float(n)
                  for (k, shape, case), n in steady_step_sites(name).items()}
    assert per_step == want_sites, (name, per_step, want_sites)
    # over the whole run, K1/K2 launched only their template instances
    runtime = {key: n for key, n in read_cases().items() if '/' in key[0]}
    assert not runtime, (name, runtime)

    with torch.no_grad():
        z = torch.randn(8, cfg.latent_dim, generator=rng, device='cuda')
        img = state.g(z / z.norm(dim=1, keepdim=True), cfg.n_phases - 1)
    assert img.shape == (8, 1, 512, 512) and torch.isfinite(img).all()
    assert img.abs().max().item() <= 1.0
    return {
        'phase': 'train', 'path': name, 'chunks': chunks,
        'steps': len(step_phases),
        'schedule_seconds': round(schedule_s, 3),
        'steady_512_steps': steps_per_epoch * n_timed_epochs,
        'steady_512_steps_per_s': steps_per_epoch * n_timed_epochs / dt,
        'steady_512_stats': stats.mean(axis=0).tolist(),
        'launches': launches,
        # batches whose shear warp met an odd margin and took the gather
        'shear_fallbacks': sum(augment.shear_fallbacks.values()),
        'launches_per_steady_step': [
            {'kernel': k, 'dtype': d, 'x': list(shape), 'case': c, 'n': n}
            for (k, d, shape, c), n in sorted(per_step.items(), key=str)],
        'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
    }


# ---------------------------------------------------------------------------
# phase 6: kernel path against the plain path on one 512^2 step
# ---------------------------------------------------------------------------

# how far each network's gradient, as one vector, may lie from the plain
# path's and from the reference's (float32 paths: float64, and packed
# also the plain unpacked path; mixed and shipping: the float32 plain
# path), by relative L2 error: about 3x the largest reading of a run
# without a fault at 512^2 on an H100 (PERF.md): unpacked D 5.83e-4, G
# 1.01e-3; packed D 5.87e-4, G 1.23e-3; mixed (kernel~plain, bfloat16
# rounding in both) D 0.0248, G 0.171, where its faults read D 0.385 and
# 0.868 (they reach D alone, through the GP); shipping (kernel~plain) D
# 0.0259, G 0.158 (kernel~float32 D 0.0456, G 0.197), where its faults
# read D 0.180 (K1 at 4 groups) and 0.277 (D's exit at stride (2, 2))
REL_L2_BOUND = {'unpacked': {'D': 2e-3, 'G': 3e-3},
                'packed': {'D': 2e-3, 'G': 4e-3},
                'mixed': {'D': 0.075, 'G': 0.5},
                'shipping': {'D': 0.075, 'G': 0.5}}


def _plain(cfg):
    return dataclasses.replace(cfg, use_kernels=False)


def _faults(torch, cfg):
    """Two planted faults on the kernel path of ``cfg``, as mock patches.

    Unpacked path: the epilogue's second order zeroed
    (``LReluPixelNormBwd``'s backward returns zeros); the epilogue run in
    bfloat16.  Packed path: the r cotangent dropped in the fused conv's
    backward (what the GP's outer pass sends back through the saved r);
    the dz kernel's second order zeroed (``Dz``'s backward returns
    zeros).  2x4 layout: the epilogue kernel at 4 groups where the layout
    has 8; D's exit from the 2x4 layout at stride (2, 2) where it is
    (2, 1), its columns repeated back to the 2x2 width."""
    if cfg.packed_lanes == 128:
        import torch.nn.functional as F
        import neuron_gan_tpu_torch.models.pggan as pggan
        from neuron_gan_tpu_torch.ops import packed as pk
        epilogue, boundary = (pggan.fused_lrelu_pixel_norm,
                              pk.pool2_equalized_conv3x3_p8)

        def four_groups(x, n_groups, *a):
            return epilogue(x, 4 if n_groups == 8 else n_groups, *a)

        def exit_stride_2x2(x, w, b=None, *, neg_slope=0.2, out_packed8=True):
            if out_packed8:
                return boundary(x, w, b, neg_slope=neg_slope)
            wf = pk.fuse_pool2_conv3x3_weight_w8_out4(
                w, pk._eq_scale3x3(w, neg_slope))
            y = F.conv2d(x, wf.to(x.dtype), None, stride=(2, 2), padding=1)
            return y.repeat_interleave(2, dim=3)

        return {
            'k1_4_groups_in_p8': [mock.patch.object(
                pggan, 'fused_lrelu_pixel_norm', four_groups)],
            'd_exit_stride_2x2': [mock.patch.object(
                pk, 'pool2_equalized_conv3x3_p8', exit_stride_2x2)],
        }
    if cfg.packed_min_res is not None:
        import neuron_gan_tpu_torch.ops.packed_conv_lrelu_pn as pcl
        real = pcl.PackedConvLReluPN.backward

        def no_ct_r(ctx, ct_y, ct_r):
            return real(ctx, ct_y, None)

        def dz_no_second_order(ctx, ct):
            return (*(None if t is None else torch.zeros_like(t)
                      for t in ctx.saved_tensors), None)

        return {
            'ct_r_dropped': [mock.patch.object(
                pcl.PackedConvLReluPN, 'backward', staticmethod(no_ct_r))],
            'dz_no_second_order': [mock.patch.object(
                pcl.Dz, 'backward', staticmethod(dz_no_second_order))],
        }
    import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn

    def no_second_order(ctx, ct):
        x, g = ctx.saved_tensors
        return torch.zeros_like(x), torch.zeros_like(g), None, None, None

    fwd, bwd = lpn._fwd, lpn._bwd
    return {
        'no_second_order': [mock.patch.object(
            lpn.LReluPixelNormBwd, 'backward', staticmethod(no_second_order))],
        'bf16_epilogue': [
            mock.patch.object(lpn, '_fwd', lambda x, *a: fwd(
                x.bfloat16(), *a).float()),
            mock.patch.object(lpn, '_bwd', lambda x, g, *a: bwd(
                x.bfloat16(), g.bfloat16(), *a).float())],
    }


def parity(torch, seed, cfg_k, spec, raw, name='unpacked'):
    """Kernel path against plain path on one batch step (512^2 on the card).

    Runs of the step on ``raw`` with the same parameters and draws: the
    kernel path; the plain path (composed ops); a reference; and the
    kernel path with each of two planted faults (``_faults``).  For a
    float32 path (TF32 off) the reference is the plain path in float64,
    and for a packed one also the plain unpacked path (packing is exact up
    to reordered sums); for the mixed path it is the float32 plain packed
    path ('highest'), for the shipping path the same with its boundaries
    fused, so its 2x4 region stays native.  The learning rate is 0, so
    every run's generator gradients are taken against the same critic.

    Held: each network's gradient within ``REL_L2_BOUND[name]`` of the
    plain path and of each reference; for a float32 path the stats and G's
    gradients elementwise at rtol 1e-4 / atol 1e-5 against the plain path;
    each faulty run outside the bound.  D's gradients are held only as one
    vector: at 512^2 a few hundred of their elements move beyond the
    elementwise tolerance under a rounding change in the epilogue (the
    counts are reported)."""
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    from neuron_gan_tpu_torch.train_step import (
        draw_batch, init_train_state, make_batch_step)

    dev = raw.device
    cfg_p = _plain(cfg_k)
    draws = draw_batch(torch.Generator(device=dev).manual_seed(seed), cfg_k,
                       spec, raw.shape[0], raw.shape[1])

    def one_step(cfg, dtype=torch.float32):
        init = torch.Generator().manual_seed(seed)
        state = init_train_state(
            GeneratorPG(cfg, init, device=dev).to(dtype),
            DiscriminatorPG(cfg, init, device=dev).to(dtype))
        # the augmentation's draws stay float32: its nearest-pixel warp
        # then picks the same pixels in every run
        d = dict(draws, zg=draws['zg'].to(dtype),
                 critic=[tuple(t.to(dtype) for t in c)
                         for c in draws['critic']])
        stats = make_batch_step(cfg, spec)(state, raw.to(dtype), d, None,
                                           0.0, 0.0)
        return ([p.grad.double() for p in state.d.parameters()],
                [p.grad.double() for p in state.g.parameters()],
                stats.double())

    runs = {'kernel': one_step(cfg_k), 'plain': one_step(cfg_p)}
    if cfg_k.compute_dtype != 'float32':
        ref = dict(compute_dtype='float32', precision='highest')
        if cfg_k.packed_lanes == 128:
            # the fused boundaries at 'highest': the 2x4 region native
            ref.update(fuse_up2_conv=True, fuse_pool_conv=True)
        runs['float32'] = one_step(dataclasses.replace(cfg_p, **ref))
        refs = ['plain', 'float32']
    else:
        runs['float64'] = one_step(cfg_p, torch.float64)
        refs = ['plain', 'float64']
    if cfg_k.packed_min_res is not None and cfg_k.compute_dtype == 'float32':
        runs['unpacked'] = one_step(dataclasses.replace(cfg_p,
                                                        packed_min_res=None))
        refs.append('unpacked')
    faults = _faults(torch, cfg_k)
    for fault, patches in faults.items():
        for p in patches:
            p.start()
        try:
            runs[fault] = one_step(cfg_k)
        finally:
            for p in patches:
                p.stop()

    def n_outside(xs, ys):
        return sum(int((~torch.isclose(x, y, rtol=1e-4, atol=1e-5)).sum())
                   for x, y in zip(xs, ys))

    dist = {}
    for run in runs:
        for ref in refs:
            if run != ref:
                dist[f'{run}~{ref}'] = {
                    'D': rel_l2(runs[run][0], runs[ref][0]),
                    'G': rel_l2(runs[run][1], runs[ref][1]),
                    'D_outside_tol': n_outside(runs[run][0], runs[ref][0]),
                    'G_outside_tol': n_outside(runs[run][1], runs[ref][1])}
    bound = REL_L2_BOUND[name]

    def within_bound(run):
        return all(dist[f'{run}~{ref}'][net] <= b
                   for ref in refs if ref != run
                   for net, b in bound.items())

    (dk, gk, sk), (dp, gp, sp) = runs['kernel'], runs['plain']
    result = {'phase': 'parity', 'path': name,
              'resolution': cfg_k.resolution(spec.phase),
              'leaves': len(dk) + len(gk),
              'D_elements': sum(x.numel() for x in dk),
              'rel_l2_bound': bound, 'grad_rel_l2': dist,
              'stats_kernel': sk.tolist(), 'stats_plain': sp.tolist()}
    failed = [f'{run} outside the bound' for run in runs
              if run not in faults and not within_bound(run)]
    failed += [f'planted fault {f} inside the bound' for f in faults
               if within_bound(f)]
    if cfg_k.compute_dtype == 'float32':
        if not torch.allclose(sk, sp, rtol=1e-4, atol=1e-5):
            failed.append('stats differ')
        if dist['kernel~plain']['G_outside_tol']:
            failed.append("G's gradients differ elementwise")
    if failed:
        raise AssertionError(f'{failed}: {json.dumps(result)}')
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port runs on an NVIDIA GPU',
              file=sys.stderr)
        return 2
    from neuron_gan_tpu_torch.runtime import kernels
    import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn
    import neuron_gan_tpu_torch.ops.packed_conv_lrelu_pn as pcl

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit({'phase': 'env', 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'python': sys.version.split()[0],
          'nvidia_smi': smi, 'device': torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    built = kernels.build()
    emit({'phase': 'build', 'seconds': round(time.perf_counter() - t0, 3),
          'kernels': {n: {'seconds': round(s, 3),
                          'ptxas': [ln.strip() for ln in log.splitlines()
                                    if 'registers' in ln or 'spill' in ln
                                    or 'entry function' in ln]}
                      for n, (s, log) in built.items()}})

    # the main paths first: their steps/s windows run in a process in which
    # the profiler (device_ms) has not run yet
    paths = {name: make() for name, (make, _) in PATHS.items()}
    trained = {}
    for name, cfg in paths.items():
        trained[name] = train(torch, args.seed, cfg, name)
        emit(trained[name])

    epi = check_epilogue_kernels(torch, lpn, args.seed)
    emit({'phase': 'kernels', 'pair': 'lrelu_pixel_norm', **epi})
    conv = check_packed_kernels(torch, pcl, args.seed)
    emit({'phase': 'kernels', 'pair': 'packed_conv_lrelu_pn', **conv})
    conv16 = check_packed_kernels_bf16(torch, pcl, args.seed)
    emit({'phase': 'kernels', 'pair': 'packed_conv_lrelu_pn',
          'dtype': 'bfloat16', **conv16})
    dz = check_dz_kernel(torch, pcl, args.seed)
    emit({'phase': 'kernels', 'kernel': 'packed_dz', **dz})

    emit(check_boundaries(torch, args.seed,
                          [paths['mixed'], paths['shipping']]))
    raw = torch.from_numpy(np.random.default_rng(args.seed + 1).random(
        (8, 768, 768, 1)).astype(np.float32)).to('cuda')
    for name, cfg in paths.items():
        emit(parity(torch, args.seed, cfg,
                    PATHS[name][1](cfg.n_phases - 1), raw, name))
    emit(check_augment(torch, args.seed))

    # each kernel's launches by dtype on each path; a row's launches are
    # those of the path that runs it in that dtype (float32: the packed
    # path, which runs every kernel; bfloat16: the mixed path), and a
    # kernel that never launched on a path that runs it fails
    def total(counts, dtype):
        return sum(n for k, n in counts.items() if k.split('/')[0] == dtype)

    by_path = {(key, dt): {name: total(res['launches'][key], dt)
                           for name, res in trained.items()}
               for key in ('k1', 'k2', 'k3', 'k4')
               for dt in ('float32', 'bfloat16')}
    for key in ('k1', 'k2', 'k3', 'k4'):
        assert by_path[key, 'float32']['packed'] > 0, (key, by_path)
        assert by_path[key, 'bfloat16']['mixed'] > 0, (key, by_path)
        assert by_path[key, 'bfloat16']['shipping'] > 0, (key, by_path)
    for key in ('k1', 'k2'):
        assert by_path[key, 'float32']['unpacked'] > 0, (key, by_path)
        # the 2x4 blocks' epilogues at 8 groups
        assert trained['shipping']['launches'][key].get('bfloat16/8'), key

    # per steady 512^2 step of a path: a kernel's launches as the train
    # phase counted them, and the sum of their bounds
    k3_bound = {(dt, tuple(e['x'])): e['bound_ms']
                for dt, cv in (('float32', conv), ('bfloat16', conv16))
                for e in cv['conv_by_shape']}

    def site_bound_ms(key, dtype, shape, case):
        item = 4 if dtype == 'float32' else 2
        if key in ('k1', 'k2'):
            return epilogue_bound_ms(key, shape, item)
        if key == 'k3':
            return k3_bound[dtype, shape]
        return dz_bound_ms(shape, item, live=case == 'live')

    def per_step(path, key, dtype):
        sites = [e for e in trained[path]['launches_per_steady_step']
                 if e['kernel'] == key and e['dtype'] == dtype]
        return {'path': path, 'launches': sum(e['n'] for e in sites),
                'bound_ms': sum(e['n'] * site_bound_ms(
                    key, dtype, tuple(e['x']), e['case']) for e in sites)}

    def row(name, src, replaces, key, dtype, err, ms, plain_ms, bound_ms,
            bound_by, library_ms, **extra):
        counts = by_path[key, dtype]
        path = 'packed' if dtype == 'float32' else 'mixed'
        steps = [per_step(path, key, dtype)]
        if key in ('k1', 'k2') and dtype == 'float32':
            steps.append(per_step('unpacked', key, dtype))
        if dtype == 'bfloat16':
            steps.append(per_step('shipping', key, dtype))
        return {'name': name, 'route': 'cuda', 'dtype': dtype,
                'source': f'neuron_gan_tpu_torch/csrc/{src}.cu',
                'replaces': f'neuron_gan_tpu/ops/{replaces}',
                'launches': counts[path],
                'launches_by_path': counts, 'max_abs_err': err,
                'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
                'bound_by': bound_by, 'library_ms': library_ms,
                'per_steady_step': steps, **extra}

    rows = []
    for dt, sfx, cv in (('float32', '', conv), ('bfloat16', '_bf16', conv16)):
        e_err, c_err = epi['max_abs_err'], cv['max_abs_err']
        k3_err = (max(c_err['conv'], c_err['r']) if dt == 'float32'
                  else c_err['conv'])
        k4_largest, = [e for e in dz['by_shape'] if e['dtype'] == dt
                       and e['y'] == cv['timed_x']]
        # K1/K2 at the timed shape's group width (f32 16, bf16 64 / 4 = 16)
        inst = epi['instances'][f'{dt}/16']

        def epi_shapes(kind):
            return [{'x': e['x'], 'n_groups': e['n_groups'],
                     **{k: e[f'{kind}_{k}'] for k in (
                         'ms', 'plain_ms', 'bound_ms', 'regs')},
                     'slice': e['slice']}
                    for e in epi['by_shape'] if e['dtype'] == dt]

        rows += [
            row('lrelu_pixel_norm_fwd', 'lrelu_pixel_norm',
                'pallas_kernels.py:65', 'k1', dt, e_err['fwd' + sfx],
                epi[f'fwd{sfx}_ms'], epi[f'fwd{sfx}_plain_ms'],
                epi['bound_ms']['fwd' + sfx], 'bytes', None,
                regs=inst['fwd_regs'], by_shape=epi_shapes('fwd')),
            row('lrelu_pixel_norm_bwd', 'lrelu_pixel_norm',
                'pallas_kernels.py:78', 'k2', dt, e_err['bwd' + sfx],
                epi[f'bwd{sfx}_ms'], epi[f'bwd{sfx}_plain_ms'],
                epi['bound_ms']['bwd' + sfx], 'bytes', None,
                regs=inst['bwd_regs'], by_shape=epi_shapes('bwd')),
            row('packed_conv_lrelu_pn_fwd', 'packed_conv_lrelu_pn',
                'pallas_conv.py:90', 'k3', dt, k3_err, cv['conv_ms'],
                cv['conv_plain_ms'], cv['bound_ms']['conv'],
                cv['bound_by']['conv'], cv['conv_library_ms']),
            row('packed_conv_lrelu_pn_dz', 'packed_conv_lrelu_pn',
                'pallas_conv.py:119', 'k4', dt,
                max(c_err['dz'], dz['max_abs_err'][dt]), k4_largest['ms'],
                k4_largest['plain_ms'], k4_largest['bound_ms'], 'bytes', None,
                regs=k4_largest['regs'],
                by_shape=[{k: e[k] for k in (
                    'y', 'ms', 'ms_ct_r_absent', 'plain_ms', 'bound_ms',
                    'bound_ms_ct_r_absent', 'regs')}
                    for e in dz['by_shape'] if e['dtype'] == dt]),
        ]
    emit({'kernels': rows, 'seconds': round(time.perf_counter() - t_start, 1)})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
