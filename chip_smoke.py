#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (neuron_gan_tpu_torch) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --ranks N     # N >= 2 cards: the dp_nccl phase
    python3 chip_smoke.py --wide        # the wide K1/K2 phase alone
    python3 chip_smoke.py --critic-act  # the Karras critic's LeakyReLU alone


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
              counter must rise by exactly the count the path implies for
              the steps that ran eagerly and the CUDA graphs' captures
              (a replay's kernels are checked in the graphs phase) (by
              dtype, K1/K2 also by grouping; over the steady steps every
              kernel also by shape, and K4 by live or absent r cotangent),
              and K1/K2 launch only their template instances;
              then steps/s over steady 512^2 steps.  It runs before any
              kernel is timed: the profiler has not run in the process;
   bench      the port's benchmark CLI (``neuron_gan_tpu_torch.bench``):
              its headline in this process (the shipping step, steady
              512^2, 5 windows of 10 epochs): K1-K4 launched exactly as
              the steps it ran eagerly or captured imply, most steps
              replayed (G forwards of ``step_passes(
              gp_reuse_fakes=True)``), ``hbm_roofline_pct`` <= 100 and the
              step's bytes counted alike from the kernel and the plain
              configuration; the headline again in a new process (its one
              JSON line); ``--phase 2`` (exact launches), ``--eval`` and
              ``--eval --fast`` (exact K1 / K1 and K3 launches over their
              grids) and ``--measure-torch`` in this process; every rate
              finite (``check_bench``);
   cli        the user's entry points at the flagship geometry, in this
              process (``runpy``, as ``python -m`` runs them): the train CLI
              (``neuron_gan_tpu_torch.train``) on 16 synthetic 512^2 PNGs
              under a config at the port's defaults (the JAX package's
              shipping step) through every phase and fade to epoch 10,
              then resumed (``--resume``) to 16; the eval CLI with ``-swd`` and
              with ``-fast``.  Held: the final checkpoint's meta and loss
              series, session 2 starting from session 1's saved parameters
              and Adam moments bit for bit, the sample grids, the SWD line,
              and the kernels each CLI launched (train: K1-K4 in bfloat16,
              K1/K2 at 8 groups too; eval: K1; eval -fast: K3; never a
              runtime-width instance);
   gp_remat   one shipping 512^2 step with gp_remat off (twice) and on:
              gradients within 3x the off arms' distance, exact launch
              counts, each arm's peak device memory;
   stream     the shipping path at steady 512^2 for 3 epochs on the
              flagship stack, resident (twice) and streamed from the host
              (``streaming.run_epochs_streaming``, one batch a group: what
              a 16 MB budget gives): stats and parameters as close to the
              resident run as the second resident run is (all eager), a
              planted fault (groups swapped) outside that, equal launch
              counts; then a
              train-CLI session with hbm_budget_mb=16 (``check_stream``);
   dp         two ranks sharing the card over gloo, 4 rows each of one
              shipping 512^2 step: reduced gradients against the 1-process
              step within the shipping parity bound, summed stats within
              DP_STATS_BOUND, three planted faults outside, K1-K4 launched
              on each rank (``dp_step_parity``); then the train CLI with
              mesh_shape={'data': 1} under NCCL (``check_dp``);
   tp         the 'model' axis: a grid of one data row and two model ranks
              sharing the card over gloo, each holding its slices of the
              weights and Adam moments (``parallel.shard_state``), two
              shipping 512^2 steps on all 8 rows at the flagship lr: each
              slice's reduced gradient before Adam (both steps) and the
              slices after them against the 1-process steps within the
              shipping parity bound, the stats within DP_STATS_BOUND,
              replicated leaves equal bit for bit on every rank, three
              planted faults outside (the gradient without its / M; model
              rank 1 stepping with model rank 0's slice; D's working copy
              not refreshed after the critic update), K1-K4 launched on
              each rank exactly as on one process (``tp_step_parity``);
              then the train CLI with mesh_shape={'data': 1, 'model': 1}
              under NCCL (``check_tp``);
   legacy     the train CLI under wgan=True at the config_ex geometry,
              epochs 1-4 then resumed to 6: finite stats, the critic within
              +-0.01, family 'wgan', a bit-exact resume, no ported kernel
              launched (``check_legacy``);
   stretch    ``tools/stretch_1024``'s body at 6 epochs: the shipping step
              one level deeper (7 levels to 1024^2, the 1024^2 level in
              the 2x4 layout at 8 channels: K1/K2 at 8 groups of 8),
              batch 4, an EMA shadow; a warm-up and a timed chunk
              (steps/s), peak memory, exact launches by dtype, grouping
              and whole shape (the -ema grid's G forward included), K1/K2
              at C_g 8 launched, no runtime-width instance, 0 < d_ema <
              d_raw, the .npz and the -ema grid; then one 1024^2 step by
              ``parity`` at the shipping bound (``check_stretch``);
   graphs     the shipping and packed paths' steady 512^2 chunk of 8 steps
              through the epoch runner (3 eager, a capture, replays of its
              CUDA graph) against the same chunk run eagerly, cuDNN
              deterministic: stats, parameters, last gradients and Adam
              moments within GRAPH_BOUND (or, where two eager runs differ,
              3x their distance); then 2 epochs of replays under
              torch.profiler: no launch counted by a wrapper, and K1-K4 in
              the device trace by kernel name as often a step as
              ``steady_step_sites`` says (``check_step_graphs``; it opens a
              profiler session, so it runs after every steps/s window);
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
              distinct packed shape, each beside its bound; the wide
              K1/K2 instances (C_g 256 and 512, Karras et al.'s PGGAN at
              batch 4) in both types against the plain versions, the
              second order included, each timed beside its bound, the
              plain version and the runtime-width instance at its shape
              (``check_wide_epilogue``; alone with ``--wide``); the
              Karras critic's LeakyReLU and LeakyReLU + pool kernels
              (ops/critic_act.py) against the composed path, three orders,
              each timed beside its bound, the plain version and the
              composed path (``check_critic_act``; alone with
              ``--critic-act``);
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
              counted (``check_augment``); its device time;
8. tools      (it opens profiler sessions, so it runs after every
              training phase) ``stacked_ab`` cut to 40 epochs at 16^2 ->
              128^2: both arms' SWD finite, the verdict line, each arm's
              launches exactly (reference arm float32, shipping arm
              bfloat16); ``step_profile`` at the shipping path's top phase
              (every stage span of the step, each finite, the gradient
              penalty's kernels on the device); ``op_trace`` at phases 3
              and 5 (categories summing
              to the total, layout kernels and copies listed);
              ``convert_checkpoint`` .npz -> .pth -> .npz on the cli
              phase's checkpoint (what the reference format carries, bit
              for bit); the native loader built with g++ and taken by the
              dataset, its statistics numpy's within 1e-12 and its stack
              numpy's bit for bit (``check_tools``).

Then the kernel table (one JSON line: a float32 and a bfloat16 row for each
kernel, each with its launches per steady 512^2 step, as counted, and the
sum of their bounds, and its launches on the stream, dp, tp and
stretch phases' paths (and the stretch path's per step);
K4's with every shape's times), the card's nvidia-smi
line, and last ``{"ok": true, "device":
{...}}``.  Any failed check raises and the script
exits non-zero without that line; without CUDA it exits 2 at once.

With ``--ranks N`` it runs, after env and build, only this phase, on N
cards, and then prints every card's nvidia-smi line and the same last line:

   dp_nccl    N ranks over NCCL, rank r on cuda:r: the ``dp`` phase's batch
              step, its bounds and planted faults, and for an even N the
              ``tp`` phase's parity (one step) on a grid of N/2 data rows
              and 2 model ranks (all_gather_into_tensor on the model
              groups);
              over each a steady window's steps/s and collective ms a
              step, beside one process's steps/s; then the train CLI's
              sessions under mesh_shape={'data': N} and, for an even N,
              {'data': N/2, 'model': 2}, through every phase to epoch 16
              with the similarity loss on: the ranks' stats equal bit for
              bit, and their states (the grid: replicated leaves, and the
              slices of each model rank), rank 0's checkpoint finite,
              K1-K4 on every rank, the parameters (the grid's as gathered
              into its checkpoint) within the shipping parity bound of a
              1-process session; one process resumes the grid's
              checkpoint (``check_dp_nccl``); then the bench CLI's
              ``--mesh data=N`` and, for an even N, ``--mesh
              data=N/2,model=2``, each a new process: NCCL, finite rates
              (``check_bench_mesh``).
"""

import argparse
import collections
import contextlib
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

from neuron_gan_tpu_torch.flagship import (
    PATHS, SAMPLE_PASSES, epilogue_shapes, site_shapes, steady_step_sites,
    step_passes, step_sites)
from neuron_gan_tpu_torch.runtime.timing import (
    device_ms, nvidia_smi_line, nvidia_smi_lines)


def emit(obj):
    print(json.dumps(obj), flush=True)


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

def epilogue_gp_grad(torch, epilogue, x, c, w0):
    """GP-style second order through an epilogue: the gradient norm of a
    toy critic (per-channel scale -> epilogue -> random linear readout)
    w.r.t. its input, differentiated again w.r.t. the scales.  (One scalar
    scale, or a squared readout, would be degenerate: PixelNorm is
    scale-invariant and fixes each pixel's sum of squares.)"""
    w = w0.clone().requires_grad_()
    xr = x.clone().requires_grad_()
    gx, = torch.autograd.grad((epilogue(xr * w) * c).sum(), xr,
                              create_graph=True)
    norms = torch.sqrt((gx ** 2).sum(dim=(1, 2, 3)))
    gw, = torch.autograd.grad(((norms - 1.0) ** 2).sum(), w)
    return gw


def check_epilogue_kernels(torch, lpn, seed, more_bf16=()):
    """K1/K2 (the LReLU + PixelNorm pair) against their plain versions:
    float32 by tolerance, bfloat16 within 2 bfloat16 ulps of the output's
    scale (both compute in float32 and round once).  ``more_bf16``: (x
    shape, grouping) of another path's bfloat16 launches (the stretch
    path's), checked and timed beside the flagship paths' shapes."""
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
        width = lpn.kernel_instance(shape[1] // n_groups, dtype)[0]
        runtime = width is None
        tag = ('/runtime' if runtime
               else '/wide' if width in lpn.WIDE_WIDTHS else '')
        cases = lpn.launches_by_case - before
        assert cases == {(f'k{i}{tag}', str(dtype)
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
    for shape in site_shapes('unpacked', 'k1'):
        check(shape, 1, torch.float32, f32_f, f32_b)
    for shape in site_shapes('packed', 'k3'):
        check(shape, 4, torch.float32, f32_f, f32_b)
    check((8, 64, 16, 16), 8, torch.float32, f32_f, f32_b)
    check((3, 16, 5, 7), 1, torch.float32, f32_f, f32_b)     # ragged tail
    # every shape of the mixed and shipping paths in bfloat16, the 2x4
    # blocks' at 8 groups
    for shape in site_shapes('mixed', 'k1', 1):
        check(shape, 1, torch.bfloat16, None, None)
    for shape in site_shapes('mixed', 'k3'):
        check(shape, 4, torch.bfloat16, None, None)
    for shape in site_shapes('shipping', 'k1', 8):
        check(shape, 8, torch.bfloat16, None, None)
    for shape, n_groups in sorted(set(more_bf16)):
        check(shape, n_groups, torch.bfloat16, None, None)
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

    # GP-style second order through the autograd Functions
    for shape, n_groups in (((2, 16, 3, 3), 1), ((2, 16, 3, 3), 4),
                            ((8, 32, 64, 64), 1)):
        x, c = randn(shape), randn(shape)
        w0 = 0.5 + torch.rand((1, shape[1], 1, 1), generator=gen, device=dev)
        got = epilogue_gp_grad(
            torch, lambda v: lpn.lrelu_pixel_norm(v, n_groups), x, c, w0)
        want = epilogue_gp_grad(
            torch, lambda v: lpn.lrelu_pixel_norm_plain(v, n_groups), x, c,
            w0)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        checked.append({'gp_second_order': list(shape), 'n_groups': n_groups})
    # bfloat16: K2 computes the LeakyReLU in float32, the plain backward
    # rounds it to bfloat16 first, so by relative L2
    for shape, n_groups in (((2, 16, 3, 3), 4), ((8, 64, 32, 32), 1),
                            ((8, 128, 32, 32), 4)):
        x, c = randn(shape), randn(shape)
        w0 = 0.5 + torch.rand((1, shape[1], 1, 1), generator=gen, device=dev)
        got = epilogue_gp_grad(torch, lambda v: lpn.lrelu_pixel_norm(
            v.bfloat16(), n_groups).float(), x, c, w0)
        want = epilogue_gp_grad(torch, lambda v: lpn.lrelu_pixel_norm_plain(
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
        shapes = epilogue_shapes(dtype)
        if dtype == torch.bfloat16:
            shapes |= set(more_bf16)
        for shp, n_groups in sorted(shapes):
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


# K1/K2 at Karras et al.'s widths: every (x shape) of the epilogues of the
# PGGAN at CelebA-HQ 1024^2 whose group is 256 or 512 channels, at batch 4
WIDE_SHAPES = ((4, 512, 4, 4), (4, 512, 8, 8), (4, 512, 16, 16),
               (4, 512, 32, 32), (4, 256, 64, 64))


def check_wide_epilogue(torch, lpn, seed):
    """The wide K1/K2 instances (C_g 256, 512) at WIDE_SHAPES, in float32
    and bfloat16: forward and backward against the plain versions (float32
    at check_epilogue_kernels' tolerances, bfloat16 within 2 bfloat16 ulps),
    the launch counted as 'k1/wide' / 'k2/wide', the second order through
    the autograd Functions (a GP-style gradient of a gradient), and the
    device time of each beside its byte bound, the plain version's and the
    runtime-width instance's at the same shape (also checked)."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    f32_f, f32_b = dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-4, atol=1e-5)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device='cuda').to(dtype)

    def close(got, want, dtype, tol):
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **tol)
            return (got - want).abs().max().item()
        return within_ulps(torch, got, want)

    rows, instances = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix('torch.')
        for c_g in lpn.WIDE_WIDTHS:
            width, s = lpn.kernel_instance(c_g, dtype)
            assert width == c_g and lpn.kernel_slice(c_g, dtype) == s
            instances[f'{dt}/{c_g}'] = {
                'slice': s, 'fwd_regs': lpn.kernel_regs(c_g, dtype),
                'bwd_regs': lpn.kernel_regs(c_g, dtype, bwd=True)}
        for shape in WIDE_SHAPES:
            x, g = randn(shape, dtype), randn(shape, dtype)
            before = collections.Counter(lpn.launches_by_case)
            out = lpn._fwd(x, 1, 0.2, 1e-8)
            dx = lpn._bwd(x, g, 1, 0.2, 1e-8)
            torch.cuda.synchronize()
            cases = lpn.launches_by_case - before
            assert cases == {(f'k{i}/wide', dt, shape, 1): 1
                             for i in (1, 2)}, cases
            ref = lpn.lrelu_pixel_norm_plain(x)
            ref_dx = lpn.lrelu_pixel_norm_bwd_plain(x, g)
            err = {'fwd': close(out, ref, dtype, f32_f),
                   'bwd': close(dx, ref_dx, dtype, f32_b),
                   'runtime_fwd': close(lpn.runtime_width(x), ref, dtype,
                                        f32_f),
                   'runtime_bwd': close(lpn.runtime_width(x, g), ref_dx,
                                        dtype, f32_b)}
            c = randn(shape)
            w0 = 0.5 + torch.rand((1, shape[1], 1, 1), generator=gen,
                                  device='cuda')
            xf = randn(shape)
            # float32: the kernel sums a group's 256 or 512 channels in
            # another order than the plain version, which moves a few
            # elements of the second order by 1e-3 of their size (an H100,
            # PERF.md): held as one vector, by relative L2
            if dtype == torch.float32:
                got = epilogue_gp_grad(torch, lpn.lrelu_pixel_norm, xf, c,
                                       w0)
                want = epilogue_gp_grad(torch, lpn.lrelu_pixel_norm_plain,
                                        xf, c, w0)
                tol = 1e-4
            else:
                got = epilogue_gp_grad(torch, lambda v: lpn.lrelu_pixel_norm(
                    v.bfloat16()).float(), xf, c, w0)
                want = epilogue_gp_grad(
                    torch, lambda v: lpn.lrelu_pixel_norm_plain(
                        v.bfloat16()).float(), xf, c, w0)
                tol = BF16_TOL['gp_rel_l2']
            err['gp_rel_l2'] = rel_l2([got], [want])
            assert err['gp_rel_l2'] <= tol, (shape, dt, err)
            item = x.element_size()
            rows.append({
                'dtype': dt, 'x': list(shape), 'n_groups': 1,
                'max_abs_err': err,
                'fwd_ms': device_ms(lambda: lpn._fwd(x, 1, 0.2, 1e-8)),
                'bwd_ms': device_ms(lambda: lpn._bwd(x, g, 1, 0.2, 1e-8)),
                'fwd_runtime_ms': device_ms(lambda: lpn.runtime_width(x)),
                'bwd_runtime_ms': device_ms(lambda: lpn.runtime_width(x, g)),
                'fwd_plain_ms': device_ms(
                    lambda: lpn.lrelu_pixel_norm_plain(x)),
                'bwd_plain_ms': device_ms(
                    lambda: lpn.lrelu_pixel_norm_bwd_plain(x, g)),
                'fwd_bound_ms': epilogue_bound_ms('k1', shape, item),
                'bwd_bound_ms': epilogue_bound_ms('k2', shape, item),
                **instances[f'{dt}/{shape[1]}']})
    return {'phase': 'wide_epilogue', 'instances': instances,
            'by_shape': rows}


# the Karras critic's largest LeakyReLU sites at 1024^2, batch 4: from_rgb
# and the first conv1 (16 channels), and the first level's conv2 before
# its pool (32 channels); and small ones, under one warp's 1024 elements
# (the unpooled one off the kernels' vectors)
CRITIC_ACT_SHAPES = (((4, 16, 1024, 1024), False), ((4, 32, 1024, 1024), True))
CRITIC_ACT_SMALL = (((2, 3, 6, 10), False), ((2, 3, 6, 8), True))


def critic_act_bytes(shape, pooled, itemsize):
    """Bytes one launch of the critic's kernels moves at ``shape`` (the
    full-resolution side): unpooled, the input read and the output written
    in full; pooled, the full side once and a quarter for the other; and
    the mask, one bit an element."""
    n = int(np.prod(shape))
    return n * itemsize * (1.25 if pooled else 2) + n / 8


def check_critic_act(torch, ca, seed):
    """The Karras critic's LeakyReLU kernels (ops/critic_act.py) in
    float32 and bfloat16 at CRITIC_ACT_SHAPES, off 16-byte alignment (a
    storage offset) and at CRITIC_ACT_SMALL: the forward, the first order
    and the penalty's second order equal the composed ``torch.where`` +
    ``F.avg_pool2d`` path's (up to the sign of zeros); a pooled width off
    the 16-byte vectors refused; and at
    CRITIC_ACT_SHAPES each kernel's device time beside its byte bound, the
    plain version's and the composed path's (forward; its autograd
    backward)."""
    import torch.nn.functional as F
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def composed(pooled):
        def f(z):
            a = torch.where(z >= 0, z, z * 0.2)
            return F.avg_pool2d(a, 2) if pooled else a
        return f

    def three(f, z, g, gg):
        z, g = z.detach().requires_grad_(), g.detach().requires_grad_()
        y = f(z)
        dz, = torch.autograd.grad(y, z, g, create_graph=True)
        return y, dz, torch.autograd.grad(dz, g, gg)[0]

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix('torch.')
        for (shape, pooled), offset in [*((s, 0) for s in CRITIC_ACT_SHAPES),
                                        (CRITIC_ACT_SHAPES[0], 1),
                                        *((s, 0) for s in CRITIC_ACT_SMALL)]:
            op = ca.critic_act_pool if pooled else ca.critic_act
            z = torch.randn(shape, generator=gen, device='cuda').to(dtype)
            z.view(-1)[::7] = 0.0
            g = torch.randn(composed(pooled)(z).shape, generator=gen,
                            device='cuda').to(dtype)
            gg = torch.randn(shape, generator=gen, device='cuda').to(dtype)
            got = three(op, at_offset(torch, z, offset),
                        at_offset(torch, g, offset), gg)
            want = three(composed(pooled), z, g, gg)
            for what, a, b in zip(('y', 'dz', 'second'), got, want):
                assert torch.equal(a, b), (dt, shape, offset, what)
            if offset or shape[-1] < 1024:
                continue
            item = z.element_size()
            zb = z >= 0
            zr = z.detach().requires_grad_()
            yc = composed(pooled)(zr)
            bound = critic_act_bytes(shape, pooled, item) / HBM_BYTES_PER_S
            fwd = ca._act_pool if pooled else ca._act
            _, mask = fwd(z, None, 0.2)
            row = {
                'dtype': dt, 'x': list(shape), 'pooled': pooled,
                'bound_ms': bound * 1e3,
                'fwd_ms': device_ms(lambda: fwd(z, None, 0.2)),
                'masked_fwd_ms': device_ms(lambda: fwd(gg, mask, 0.2)),
                'library_fwd_ms': device_ms(lambda: composed(pooled)(z)),
                'library_bwd_ms': device_ms(lambda: torch.autograd.grad(
                    yc, zr, g, retain_graph=True))}
            if pooled:
                row['adjoint_ms'] = device_ms(lambda: ca._unpool(g, mask, 0.2))
                row['plain_fwd_ms'] = device_ms(
                    lambda: ca.act_pool_plain(z, z >= 0))
                row['plain_adjoint_ms'] = device_ms(
                    lambda: ca.unpool_act_plain(g, zb))
            else:
                row['plain_fwd_ms'] = device_ms(
                    lambda: ca.act_plain(z, z >= 0))
            rows.append(row)
        try:
            ca.critic_act_pool(torch.zeros((2, 3, 6, 10), dtype=dtype,
                                           device='cuda'))
        except ValueError:
            pass
        else:
            raise AssertionError(f'{dt}: a pooled width of 10 was taken')
    return {'phase': 'critic_act', 'by_shape': rows}


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
        for _, n, h, w in site_shapes('packed', 'k3'):
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
    for _, n, h, w in site_shapes('packed', 'k3'):
        xs, wps = packed_case(torch, gen, 8, n, n, h, w)
        xs = xs.to(dtype)
        wds = wps.to(dtype)
        launch, _, _ = pcl.conv_fwd_launcher(xs, wps)
        nonzero_w = int(torch.count_nonzero(wps))
        n_bytes, n_ops, bound_ms, bound_by = conv_bound(
            xs.shape, n, nonzero_w, xs.element_size())
        rows.append({
            'x': [8, n, h, w], 'n': n, 'nonzero_w': nonzero_w,
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

    for _, n, h, w in site_shapes('packed', 'k3'):
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

        shapes = site_shapes('packed', 'k3')
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


def expected_launches(cfg, phases_per_step, gp_remat=False, passes=None):
    """Kernel launches of batch steps of ``cfg`` at these phases (or of
    other ``passes``, e.g. ``SAMPLE_PASSES``), keyed by ``launch_key``, as
    tests/test_torch_train_step.py and tests/test_torch_packed8.py count
    them on the CPU: ``flagship.step_sites`` summed by kernel, dtype and
    grouping.  Every launch takes the blocks' dtype (cfg.dtype): the fused
    level boundaries change no count."""
    dt = str(cfg.dtype).removeprefix('torch.')
    counts = {k: collections.Counter() for k in ('k1', 'k2', 'k3', 'k4')}
    for p in phases_per_step if cfg.use_kernels else ():
        for (k, _, case), n in step_sites(
                cfg, p, 1, passes or step_passes(gp_remat)).items():
            counts[k][launch_key(dt, case if k in ('k1', 'k2') else None)] += n
    return {k: dict(+c) for k, c in counts.items()}


def reset_counters():
    import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn
    import neuron_gan_tpu_torch.ops.packed_conv_lrelu_pn as pcl
    lpn.launches_by_case.clear()
    pcl.launches_by_case.clear()


def read_counters():
    import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn
    import neuron_gan_tpu_torch.ops.packed_conv_lrelu_pn as pcl
    sums = {**lpn.launches_by_kernel(), **pcl.launches_by_kernel()}
    return {'k1': {launch_key(*k): n for k, n in sums['k1'].items()},
            'k2': {launch_key(*k): n for k, n in sums['k2'].items()},
            'k3': dict(sums['k3']), 'k4': dict(sums['k4'])}


def read_cases():
    """Every kernel's launches by (kernel, dtype name, shape, case), as the
    wrappers count them (``launches_by_case``)."""
    import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn
    import neuron_gan_tpu_torch.ops.packed_conv_lrelu_pn as pcl
    return lpn.launches_by_case + pcl.launches_by_case


@contextlib.contextmanager
def graph_replays():
    """Counts, by phase, the batch steps the epoch runners replay from a
    CUDA graph captured at an earlier step (``train_step.StepGraphs``).
    Their kernels run without passing through the wrappers, whose
    counters hold the eager steps' launches and each capture's, once."""
    from neuron_gan_tpu_torch import train_step as ts
    real = ts.StepGraphs.run
    replays = collections.Counter()

    def run(self, key, *args):
        before = ts.step_graphs['replayed'] - ts.step_graphs['captured']
        out = real(self, key, *args)
        replays[key[0]] += (ts.step_graphs['replayed']
                            - ts.step_graphs['captured'] - before)
        return out

    with mock.patch.object(ts.StepGraphs, 'run', run):
        yield replays


def launched_phases(phases, replays):
    """``phases`` (one a batch step) less the ``replays`` (``graph_replays``):
    the phases of the steps whose launches the wrappers counted."""
    left = collections.Counter(phases)
    left.subtract(replays)
    assert all(n >= 0 for n in left.values()), (left, replays)
    return sorted(left.elements())


def _chunk_record(spec, start, end, stats, t0, name):
    stats = stats.cpu().numpy()
    assert np.isfinite(stats).all(), (name, start, stats)
    return {'epochs': [start, end], 'phase': spec.phase,
            'fading': spec.fading,
            'seconds': round(time.perf_counter() - t0, 3),
            'D_loss': stats[:, 2].tolist()}


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
    with graph_replays() as replays:
        for start, end in sched.plan_chunks(1, sched.n_epochs + 1):
            spec = spec_for_chunk(sched, start, base)
            t0 = time.perf_counter()
            stats = make_epoch_runner(cfg, spec, end - start + 1)(
                state, images, rng, start)
            chunks.append(_chunk_record(spec, start, end, stats, t0, name))
            step_phases += ([spec.phase] * steps_per_epoch
                            * (end - start + 1))
    schedule_s = time.perf_counter() - t_run
    assert chunks[-1]['phase'] == cfg.n_phases - 1 and not chunks[-1]['fading']

    # steady 512^2 throughput: the runner at the schedule's last chunk
    spec = spec_for_chunk(sched, sched.n_epochs, base)
    run = make_epoch_runner(cfg, spec, n_timed_epochs)
    before = read_cases()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with graph_replays() as steady_replays:
        stats = run(state, images, rng, sched.n_epochs + 1).cpu().numpy()
    dt = time.perf_counter() - t0
    assert np.isfinite(stats).all(), (name, stats)
    n_steady = steps_per_epoch * n_timed_epochs
    replays.update(steady_replays)
    step_phases += [spec.phase] * n_steady
    # the wrappers count the eager steps and the captures (a replay's
    # kernels are read from a trace in the graphs phase)
    launches = read_counters()
    want = expected_launches(cfg, launched_phases(step_phases, replays))
    assert launches == want, (name, launches, want)
    # every kernel per counted steady step by shape and case (K1/K2:
    # grouping; K4: r's cotangent live or absent), against the path's
    # launch sites (which the CPU tests hold against expected_launches)
    n_counted = n_steady - steady_replays[spec.phase]
    steady = read_cases()
    steady.subtract(before)
    per_step = {key: n / n_counted for key, n in steady.items() if n}
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
        'graph_replays': dict(replays),
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
# phase bench: the port's benchmark CLI (neuron_gan_tpu_torch/bench.py)
# ---------------------------------------------------------------------------

def bench_line(argv):
    """``python -m neuron_gan_tpu_torch.bench argv`` in this process (its
    launch counters stay readable): its one JSON record."""
    import contextlib
    import io
    from neuron_gan_tpu_torch import bench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(argv)
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1, (argv, lines)
    return json.loads(lines[0])


def bench_subprocess(argv, timeout=600):
    """``python3 -m neuron_gan_tpu_torch.bench argv`` in a new process from
    the checkout's root: its one JSON record."""
    import os
    out = subprocess.run(
        [sys.executable, '-m', 'neuron_gan_tpu_torch.bench', *argv],
        capture_output=True, text=True, timeout=timeout,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = out.stdout.splitlines()
    if out.returncode or len(lines) != 1:
        raise AssertionError(f'bench {argv}: exit {out.returncode}\n'
                             f'{out.stdout[-4000:]}\n{out.stderr[-4000:]}')
    return json.loads(lines[0])


def _finite_rate(rec, key='value'):
    assert np.isfinite(rec[key]) and rec[key] > 0, rec
    return rec


def check_bench(torch):
    """The bench's headline in this process (5 windows): K1-K4 launched
    exactly ``expected_launches`` of the steps it ran (gp_reuse_fakes: G's
    forwards of ``step_passes(gp_reuse_fakes=True)``), the roofline read
    <= 100% and the step's bytes counted alike from the kernel and the
    plain configuration; the headline again as a user runs it (a new
    process, its one line); ``--phase 2`` (exact launches), ``--eval`` (K1
    float32, exact) and ``--eval --fast`` (K1 and K3, exact) and
    ``--measure-torch`` in this process.  Every record's rates finite."""
    from neuron_gan_tpu_torch import bench
    t_phase = time.perf_counter()
    passes = step_passes(gp_reuse_fakes=True)

    cfg, spec = bench.train_setup()
    roofline = {}
    reset_counters()
    with graph_replays() as replays:
        head = bench.bench_train(cfg, spec, windows=5, roofline=roofline)
    launches = read_counters()
    want = expected_launches(cfg, launched_phases(
        [spec.phase] * head['steps'], replays), passes=passes)
    assert launches == want, (launches, want)
    # the steps after the first window's captures are replayed
    assert head['step_graphs'].get('captured') and \
        head['step_graphs']['replayed'] > head['steps'] // 2, head
    assert roofline['hbm_gb_per_step'] > 0, roofline
    assert 0 <= roofline['hbm_roofline_pct'] <= 100, roofline
    raw = bench.synthetic_stack(spec.batch_size, bench.FRAME,
                                torch.device('cuda'))
    plain_bytes = bench.step_bytes(dataclasses.replace(cfg, use_kernels=False),
                                   spec, raw)
    assert plain_bytes == head['step_bytes'], (plain_bytes, head['step_bytes'])
    in_process = {k: head[k] for k in ('value', 'min', 'max', 'windows',
                                       'steps')}
    in_process.update(roofline, step_bytes=head['step_bytes'],
                      launches=launches, step_graphs=head['step_graphs'])

    cli = _finite_rate(bench_subprocess([]))
    assert cli['metric'] == 'wgan_gp_train_steps_per_sec_512', cli
    assert len(cli['windows']) == 5 and cli['hbm_roofline_pct'] <= 100, cli

    reset_counters()
    with graph_replays() as replays:
        low = _finite_rate(bench_line(['--phase', '2']))
    assert low['metric'] == 'wgan_gp_train_steps_per_sec_64', low
    cfg2, spec2 = bench.train_setup(phase=2)
    # the warm-up window and the default 5
    n2 = (1 + 5) * bench.N_EPOCHS_CHUNK * spec2.n_full_batches
    assert read_counters() == expected_launches(
        cfg2, launched_phases([2] * n2, replays), passes=passes)

    evals = {}
    for fast in (False, True):
        reset_counters()
        rec = _finite_rate(bench_line(['--eval'] + ['--fast'] * fast))
        ecfg = bench.eval_config(fast)
        grids = (bench.EVAL_REPS + 1) * bench.EVAL_ITERS
        got = read_counters()
        assert got == expected_launches(ecfg, [ecfg.n_phases - 1] * grids,
                                        passes=SAMPLE_PASSES), (fast, got)
        assert got['k1'] and bool(got['k3']) == fast, (fast, got)
        evals['fast' if fast else 'highest'] = dict(rec, launches=got)

    ref = _finite_rate(bench_line(['--measure-torch']),
                       'torch_ref_steps_per_sec')
    return {'phase': 'bench', 'in_process': in_process, 'cli': cli,
            'phase_64': low, 'eval': evals, 'measure_torch': ref,
            'headline_over_ref': cli['value'] / ref['torch_ref_steps_per_sec'],
            'seconds': round(time.perf_counter() - t_phase, 1)}


def check_bench_mesh(n):
    """``--mesh data=N`` and, for an even N, ``--mesh data=N/2,model=2``,
    each a new process spawning its N NCCL ranks, one card each."""
    shapes = [f'data={n}'] + ([f'data={n // 2},model=2'] if n % 2 == 0 else [])
    out = {}
    for shape in shapes:
        rec = _finite_rate(bench_subprocess(['--mesh', shape]))
        _finite_rate(rec, 'single_device_steps_per_sec')
        assert rec['backend'] == 'nccl' and rec['geometry'] == 'flagship', rec
        out[shape] = rec
    return {'phase': 'bench_mesh', 'records': out}


# ---------------------------------------------------------------------------
# phase cli: the user's entry points (train CLI, resume, eval CLI), then
# gp_remat on one shipping step
# ---------------------------------------------------------------------------

CLI_ID = 'smk1'
# each fade lasts 2 epochs, so transitions lie 3 apart (the config's
# validation asks for more than a fade between them); session 1 ends at
# epoch 10, the last before the transition at 11
CLI_SCHEDULE = dict(transit_sch=[2, 5, 8, 11, 14], alpha_step=0.5, N_epochs=16,
                    checkpointing_period=4, swd_period=6, N_epochs_session=10)


def synthetic_neuron(rng, size=512):
    """A uint8 grayscale frame like the dataset's: a noisy background near
    20, bright branching random-walk processes from a few somata, and
    exact-zero pixels for the loader's noise fill."""
    img = rng.normal(20.0, 5.0, (size, size))
    for _ in range(3):
        y0, x0 = rng.uniform(0.25, 0.75, 2) * size
        img[int(y0) - 6:int(y0) + 6, int(x0) - 6:int(x0) + 6] = 220.0
        for _ in range(6):
            ang = rng.uniform(0.0, 2 * np.pi)
            y, x = y0, x0
            for _ in range(120):
                ang += rng.normal(0.0, 0.25)
                y, x = y + 2.0 * np.sin(ang), x + 2.0 * np.cos(ang)
                iy, ix = int(y), int(x)
                if not (1 <= iy < size - 1 and 1 <= ix < size - 1):
                    break
                img[iy - 1:iy + 2, ix - 1:ix + 2] = rng.normal(180.0, 20.0)
    img = img.clip(0, 255).astype(np.uint8)
    img[:4, :4] = 0
    img[rng.random(img.shape) < 0.002] = 0
    return img


def write_cli_config(path, root, dataset_dir, seed, **extra):
    """The reference's config_ex at the flagship geometry with the port's
    execution knobs at their defaults (the JAX package's shipping step),
    spelled out, under a short schedule through every phase and fade;
    ``extra`` knobs replace those."""
    knobs = dict(
        ID=CLI_ID, dataset_dir=dataset_dir, data_dir=f'{root}/data',
        images_dir=f'{root}/images', weights_dir=f'{root}/weights',
        plots_dir=f'{root}/plots', logs_dir=f'{root}/logs',
        samples_sub_dir=f'{root}/images/{CLI_ID}',
        pggan=True, grad_pen_lambda=10, learning_rate=1e-4, batch_size=8,
        beta1=0.5, drift_epsilon=0.001, n_critic=1, seed=seed,
        translation=0.05, latent_dim=64, image_size=512, N_colors=1,
        LeakyReLU_leak=0.2, N_gen_features=[128, 64, 32, 32, 16, 16],
        N_dis_features=[16, 16, 32, 32, 64, 128], resume=False,
        compute_dtype='mixed', matmul_precision='default', packed_min_res=64,
        packed_lanes=128, fast_augment=True, shear_warp='auto',
        gp_reuse_fakes=True, use_kernels=True, **CLI_SCHEDULE)
    knobs.update(extra)
    with open(path, 'w') as fh:
        fh.write(''.join(f'{k} = {v!r}\n' for k, v in knobs.items()))


def run_cli(module, argv, log):
    """Run a CLI module in this process as ``python -m module argv`` would
    (its launch counters stay readable), its standard output into ``log``;
    returns the output and the wall seconds."""
    import contextlib
    import io
    import runpy
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with mock.patch.object(sys, 'argv', [module] + argv), \
                contextlib.redirect_stdout(buf):
            runpy.run_module(module, run_name='__main__', alter_sys=True)
    finally:
        log.write(f'$ python -m {module} {" ".join(argv)}\n{buf.getvalue()}')
    return buf.getvalue(), time.perf_counter() - t0


def leaves_differ(got, want):
    """Leaves of two train-state trees that differ (shape, dtype or any
    bit), by path; both trees must have the same structure."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        return [p for k in want for p in leaves_differ(got[k], want[k])]
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        return [p for g, w in zip(got, want) for p in leaves_differ(g, w)]
    got, want = np.asarray(got), np.asarray(want)
    same = (got.dtype == want.dtype and got.shape == want.shape
            and got.tobytes() == want.tobytes())
    return [] if same else [f'{want.shape} {want.dtype}']


def write_dataset(path, seed, n=16, size=512):
    """``n`` synthetic ``size``^2 PNGs (``synthetic_neuron``) in ``path``."""
    import os
    from neuron_gan_tpu_torch.utils.png import write_png
    os.makedirs(path)
    rng = np.random.default_rng(seed)
    for i in range(n):
        write_png(os.path.join(path, f'neuron_{i:02d}.png'),
                  synthetic_neuron(rng, size))
    return path


def check_cli(torch, seed, keep):
    """The user's entry points at the flagship geometry on 16 synthetic
    512^2 PNGs (the loader pads them to the 768^2 frame): a train session
    to epoch 10, a resumed one to 16, eval with -swd, eval with -fast.
    The final checkpoint is copied into the directory ``keep``."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp, \
            open(os.path.join(tmp, 'cli.log'), 'w') as log:
        try:
            return _check_cli(torch, seed, tmp, log, keep)
        except BaseException:
            log.flush()
            with open(log.name) as fh:
                print(''.join(fh.readlines()[-80:]), file=sys.stderr)
            raise


def _check_cli(torch, seed, tmp, log, keep):
    size = 512
    import os
    import neuron_gan_tpu_torch.train_step as ts
    from neuron_gan_tpu_torch.checkpoint import load_pytree_npz
    from neuron_gan_tpu_torch.convert import to_jax_state
    from neuron_gan_tpu_torch.data.neuron_dataset import decode_image
    data = write_dataset(os.path.join(tmp, 'data'), seed, size=size)
    root = os.path.join(tmp, 'run')
    cfg_path = os.path.join(tmp, 'cli_config.py')
    write_cli_config(cfg_path, root, data, seed)
    weights = os.path.join(root, 'weights', f'GenDisc_{CLI_ID}.npz')

    # the state and first epoch of session 2's first chunk
    first = {}
    real_runner = ts.make_epoch_runner

    def recording_runner(cfg, spec, n_epochs, dp=None):
        run = real_runner(cfg, spec, n_epochs, dp)

        def recorded(state, images, rng_, first_epoch):
            if not first:
                first.update(epoch=first_epoch, state=to_jax_state(state))
            return run(state, images, rng_, first_epoch)
        return recorded

    reset_counters()
    text, s1 = run_cli('neuron_gan_tpu_torch.train', ['--configs', cfg_path], log)
    swd_lines = [ln for ln in text.splitlines() if ln.startswith('SWD at')]
    saved, saved_meta = load_pytree_npz(weights)
    with mock.patch.object(ts, 'make_epoch_runner', recording_runner):
        text, s2 = run_cli('neuron_gan_tpu_torch.train',
                           ['--configs', cfg_path, '--resume'], log)
    swd_lines += [ln for ln in text.splitlines() if ln.startswith('SWD at')]
    train_launches = read_counters()
    runtime = {str(k): n for k, n in read_cases().items() if '/' in k[0]}

    # resume: session 2 began after session 1's checkpoint, from its
    # parameters and Adam moments bit for bit
    n1 = CLI_SCHEDULE['N_epochs_session']
    assert saved_meta['epoch'] == n1, saved_meta
    assert first['epoch'] == n1 + 1, first['epoch']
    differ = leaves_differ(first['state'], saved['state'])
    assert not differ, differ

    n_all = CLI_SCHEDULE['N_epochs']
    payload, meta = load_pytree_npz(weights)
    assert (meta['epoch'], meta['image_size'], meta['alpha'],
            meta['phase']) == (n_all, size, 1.0, 5), meta
    for name, series in payload['series'].items():
        assert len(series) == n_all and np.isfinite(series).all(), name

    # the sample grids: 16 samples, 4x4 with 2-pixel padding
    side = 4 * (size + 2) + 2
    samples = os.path.join(root, 'images', CLI_ID)
    grids = {f: decode_image(os.path.join(samples, f)).shape
             for f in sorted(os.listdir(samples))}
    assert f'Samples_{CLI_ID}_{n_all}.png' in grids, grids
    assert all(s[:2] == (side, side) for s in grids.values()), grids

    # eval -swd (float32 'highest', unpacked: K1) and -fast (packed, K3)
    evals = {}
    for flag in ('-swd', '-fast'):
        reset_counters()
        grid = os.path.join(root, f'eval{flag}.png')
        argv = ['-n', '16', '-weights', weights, '-output', grid, flag]
        if flag == '-swd':
            argv += ['-dataset_dir', data]
        text, secs = run_cli('neuron_gan_tpu_torch.eval', argv, log)
        evals[flag] = {'seconds': round(secs, 3), 'launches': read_counters(),
                       'grid': list(decode_image(grid).shape)}
        runtime.update({str(k): n for k, n in read_cases().items()
                        if '/' in k[0]})
        if flag == '-swd':
            evals[flag]['swd'] = json.loads(
                [ln for ln in text.splitlines() if '"swd_mean"' in ln][-1])

    # every kernel launched from the CLIs, never a runtime-width instance
    for key in ('k1', 'k2', 'k3', 'k4'):
        assert any(k.split('/')[0] == 'bfloat16' and n
                   for k, n in train_launches[key].items()), (key, train_launches)
    for key in ('k1', 'k2'):
        assert train_launches[key].get('bfloat16/8'), (key, train_launches)
    assert evals['-swd']['launches']['k1'], evals
    assert evals['-fast']['launches']['k3'], evals
    assert not runtime, runtime
    swd = evals['-swd']['swd']
    assert np.isfinite(swd['swd_mean']) and swd['resolution'] == size, swd
    assert all(e['grid'][:2] == [side, side] for e in evals.values()), evals

    import shutil
    kept = shutil.copy(weights, keep)
    smi = nvidia_smi_line()
    return {'phase': 'cli', 'nvidia_smi': smi, 'kept_checkpoint': kept,
            'sessions': [{'epochs': [1, n1], 'seconds': round(s1, 3),
                          'epochs_per_s': n1 / s1},
                         {'epochs': [n1 + 1, n_all], 'seconds': round(s2, 3),
                          'epochs_per_s': (n_all - n1) / s2}],
            'swd_monitor': swd_lines, 'checkpoint_meta': meta,
            'grids': {f: list(s) for f, s in grids.items()},
            'train_launches': train_launches, 'evals': evals}


def check_gp_remat(torch, seed):
    """One 512^2 batch step of the shipping path with gp_remat off (twice)
    and on, same parameters and draws, learning rate 0: each network's
    gradient under remat must lie within 3x the distance between the two
    runs without it (relative L2; a distance of 0 asks for equality), and
    each arm launch exactly ``expected_launches``.  Reports each arm's peak
    device memory over the step."""
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    from neuron_gan_tpu_torch.train_step import (
        draw_batch, init_train_state, make_batch_step)
    make, chunk = PATHS['shipping']
    cfg = make()
    spec_off = chunk(cfg.n_phases - 1)
    raw = torch.from_numpy(np.random.default_rng(seed + 2).random(
        (8, 768, 768, 1)).astype(np.float32)).to('cuda')
    draws = draw_batch(torch.Generator(device='cuda').manual_seed(seed), cfg,
                       spec_off, raw.shape[0], raw.shape[1])

    def one_step(remat):
        spec = dataclasses.replace(spec_off, gp_remat=remat)
        init = torch.Generator().manual_seed(seed)
        state = init_train_state(GeneratorPG(cfg, init, device='cuda'),
                                 DiscriminatorPG(cfg, init, device='cuda'))
        step = make_batch_step(cfg, spec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_counters()
        t0 = time.perf_counter()
        step(state, raw, draws, None, 0.0, 0.0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        return {'D': [p.grad.double() for p in state.d.parameters()],
                'G': [p.grad.double() for p in state.g.parameters()],
                'launches': read_counters(), 'seconds': round(secs, 4),
                'max_memory_allocated_gib': peak / 2 ** 30,
                # over what was allocated before the step (the earlier
                # arms' gradients held here among it)
                'step_peak_gib': (peak - before) / 2 ** 30}

    off1, off2, on = one_step(False), one_step(False), one_step(True)
    dist = {run: {net: rel_l2(arm[net], off1[net]) for net in ('D', 'G')}
            for run, arm in (('off~off', off2), ('remat~off', on))}
    bound = {net: 3 * dist['off~off'][net] for net in ('D', 'G')}
    result = {'phase': 'gp_remat', 'path': 'shipping', 'resolution': 512,
              'rel_l2': dist, 'bound': bound,
              'arms': {name: {k: v for k, v in arm.items() if k not in ('D', 'G')}
                       for name, arm in (('off', off1), ('off_again', off2),
                                         ('remat', on))},
              'expected_launches_remat': expected_launches(cfg, [5], gp_remat=True)}
    failed = [net for net in ('D', 'G')
              if dist['remat~off'][net] > bound[net]]
    if on['launches'] != expected_launches(cfg, [5], gp_remat=True):
        failed.append('remat launches')
    if off1['launches'] != expected_launches(cfg, [5]):
        failed.append('launches')
    if failed:
        raise AssertionError(f'{failed}: {json.dumps(result)}')
    return result


# ---------------------------------------------------------------------------
# phases stream, dp and legacy: host streaming, data parallelism, legacy WGAN
# ---------------------------------------------------------------------------

def _state_of(state):
    """Each net's parameters and its Adam moments, as lists of tensors."""
    out = {}
    for net, module, opt in (('D', state.d, state.d_opt),
                             ('G', state.g, state.g_opt)):
        params = list(module.parameters())
        out[net] = [p.detach().double().clone() for p in params]
        out[f'{net}_moments'] = [opt.state[p][k].double().clone()
                                 for p in params
                                 for k in ('exp_avg', 'exp_avg_sq')]
    return out


def _within_twins(dist, twins):
    """A distance as small as two identical runs allow: 0 where they agree
    bit for bit, else within 3x their distance."""
    return dist == 0 if twins == 0 else dist <= 3 * twins


def check_stream(torch, seed):
    """The shipping path at steady 512^2 for 3 epochs on the flagship
    stack, resident (twice) and streamed from the host through
    ``run_epochs_streaming`` with one batch a group (what a 16 MB budget
    gives: two groups an epoch, so the double buffer turns over).  Held:
    the streamed run's stats, both nets' parameters and their Adam moments
    as close to the resident run as the second resident run is (bit for
    bit where it is, else within 3x its distance); the streamed run's K1-K4
    launches equal to the resident run's; a planted fault (each epoch's two
    groups fed in swapped order) outside that bound.  Then one train-CLI
    session with hbm_budget_mb=16, which must stream."""
    from neuron_gan_tpu_torch import streaming
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    from neuron_gan_tpu_torch.train_step import (
        init_train_state, make_epoch_runner)
    make, chunk = PATHS['shipping']
    cfg = make()
    spec = chunk(cfg.n_phases - 1)
    n_epochs = 3
    host = np.random.default_rng(seed + 3).random(
        (spec.n_images, 768, 768, 1)).astype(np.float32)
    budget = 16 * 2 ** 20
    max_group = streaming.group_batches_for_budget(spec, 768, budget)
    assert max_group == 1 and len(streaming.plan_groups(
        spec.n_full_batches, max_group)) == 2, max_group

    def one_run(stream):
        init = torch.Generator().manual_seed(seed)
        state = init_train_state(GeneratorPG(cfg, init, device='cuda'),
                                 DiscriminatorPG(cfg, init, device='cuda'))
        rng = torch.Generator(device='cuda').manual_seed(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        if stream:
            stats = streaming.run_epochs_streaming(
                cfg, spec, state, host, rng, 1, n_epochs, max_group)
        else:
            # eager, as the streamed steps are (the graphs phase holds the
            # runner's replayed steps to its eager ones)
            images = torch.from_numpy(host).to('cuda')
            stats = make_epoch_runner(cfg, spec, n_epochs, capture=False)(
                state, images, rng, 1)
        stats = stats.cpu().double()
        secs = time.perf_counter() - t0
        assert torch.isfinite(stats).all(), stats
        return {'stats': stats, **_state_of(state), 'launches': read_counters(),
                'seconds': round(secs, 3),
                'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30}

    def dist(run, ref):
        return {'stats': rel_l2([run['stats']], [ref['stats']]),
                **{k: rel_l2(run[k], ref[k])
                   for k in ('D', 'G', 'D_moments', 'G_moments')}}

    plan = streaming.plan_groups
    swapped = mock.patch.object(streaming, 'plan_groups',
                                lambda *a: plan(*a)[::-1])
    result = {'phase': 'stream', 'nvidia_smi': nvidia_smi_line(),
              'path': 'shipping', 'resolution': 512,
              'epochs': n_epochs, 'stack': list(host.shape),
              'budget_mib': budget / 2 ** 20, 'group_batches': max_group}
    runs = {'resident': one_run(False), 'resident_again': one_run(False),
            'streamed': one_run(True)}
    with swapped:
        runs['fault_swapped_groups'] = one_run(True)
    ref = runs['resident']
    dists = {k: dist(run, ref) for k, run in runs.items() if run is not ref}
    twins = dists['resident_again']

    def holds(k):
        return all(_within_twins(dists[k][q], twins[q]) for q in twins)

    result.update({
        'lr': spec.lr0, 'rel_l2_to_resident': dists,
        'runs': {k: {q: run[q] for q in ('seconds', 'peak_mem_gib', 'launches')}
                 for k, run in runs.items()}})
    failed = []
    if not holds('streamed'):
        failed.append("streamed run outside the resident runs' distance")
    if holds('fault_swapped_groups'):
        failed.append('planted fault (swapped groups) inside the bound')
    if runs['streamed']['launches'] != ref['launches']:
        failed.append('launch counts differ from the resident run')
    for key in ('k1', 'k2', 'k3', 'k4'):
        if not ref['launches'][key]:
            failed.append(f'{key} never launched')
    if failed:
        raise AssertionError(f'{failed}: {json.dumps(result)}')

    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp, \
            open(os.path.join(tmp, 'cli.log'), 'w') as log:
        data = write_dataset(os.path.join(tmp, 'data'), seed)
        cfg_path = os.path.join(tmp, 'stream_config.py')
        write_cli_config(cfg_path, os.path.join(tmp, 'run'), data, seed,
                         ID='smks', hbm_budget_mb=16, N_epochs_session=3)
        text, secs = run_cli('neuron_gan_tpu_torch.train',
                             ['--configs', cfg_path], log)
        lines = [ln for ln in text.splitlines() if 'streaming from host' in ln]
        if not lines:
            log.flush()
            raise AssertionError(f'the train CLI did not stream:\n{text[-4000:]}')
    result['cli'] = {'seconds': round(secs, 3), 'message': lines[0]}
    return result


# the summed stats' relative-L2 bound of the dp phases: 3x the largest sound
# reading on the H100 (2 gloo ranks 4.0e-6, 4 NCCL ranks 1.2e-6), below
# what ranks that take another rank's draws read (5.2e-5, 2.4e-5) and far
# below stats summed without the b_r weight (1 - ranks / 8)
DP_STATS_BOUND = 1.2e-5


def _dp_rank(rank, world_size, init_method, seed, arms, backend, out_dir):
    """One rank of a data-parallel group: one shipping 512^2 step (lr 0) of
    each arm on this rank's rows of the global batch of 8.  Over gloo every
    rank shares cuda:0 (NCCL takes one rank a card); over NCCL rank r binds
    cuda:r.  Saves each arm's reduced gradients, this rank's and the summed
    stats, and its launches to ``out_dir``."""
    import os
    import torch
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    from neuron_gan_tpu_torch.parallel import Grid, take_rows
    from neuron_gan_tpu_torch.train_step import (
        draw_batch, init_train_state, make_batch_step)
    dp = Grid.init(rank, world_size, init_method,
                   'cuda:0' if backend == 'gloo' else f'cuda:{rank}',
                   backend=backend)
    device = dp.device
    make, chunk = PATHS['shipping']
    cfg = make()
    spec = chunk(cfg.n_phases - 1)
    raw = torch.from_numpy(np.random.default_rng(seed + 2).random(
        (8, 768, 768, 1)).astype(np.float32)).to(device)
    draws = draw_batch(torch.Generator(device=device).manual_seed(seed), cfg,
                       spec, 8, 768)
    out = {}
    try:
        for arm in arms:
            lo, hi = dp.rows(8)
            rows = (lo, hi)
            patches = []
            if arm == 'fault_unweighted':
                reduce = Grid.reduce_grads
                patches.append(mock.patch.object(
                    Grid, 'reduce_grads',
                    lambda self, params, weight: reduce(self, params, 1.0)))
            if arm == 'fault_other_rows':
                # this rank's images with the next rank's draws
                rows = Grid((rank + 1) % world_size, world_size,
                            device).rows(8)
            init = torch.Generator().manual_seed(seed)
            state = init_train_state(GeneratorPG(cfg, init, device=device),
                                     DiscriminatorPG(cfg, init, device=device))
            step = make_batch_step(cfg, spec, dp)
            reset_counters()
            for p in patches:
                p.start()
            try:
                stats = step(state, raw[lo:hi], take_rows(draws, *rows),
                             None, 0.0, 0.0, 8)
            finally:
                for p in patches:
                    p.stop()
            local = stats.cpu()
            dp.all_reduce_(stats)
            out[arm] = {'D': [p.grad.cpu() for p in state.d.parameters()],
                        'G': [p.grad.cpu() for p in state.g.parameters()],
                        'stats': stats.cpu(), 'stats_local': local,
                        'launches': read_counters(), 'rows': [lo, hi]}
            if arm == 'dp' and backend == 'nccl':
                rows_draws = take_rows(draws, lo, hi)
                out['timing'] = steady_rate(torch, lambda: step(
                    state, raw[lo:hi], rows_draws, None, spec.lr0, 0.0, 8))
        dp.barrier()
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))


def dp_step_parity(torch, seed, world_size, backend):
    """``world_size`` ranks over ``backend`` (``_dp_rank``), one shipping
    512^2 step at lr 0 on their rows of the flagship batch of 8, against the
    1-process step on cuda:0 with the same parameters and draws: the
    reduced gradients of D and G by relative L2 within the shipping parity
    bound, the summed stats within DP_STATS_BOUND, every rank holding the
    same gradients and stats; three planted faults outside (gradients
    summed without the b_r / B weight; each rank taking the next rank's
    rows of the draws; stats summed without the b_r weight, made from the
    sound arm's per-rank stats); each rank launching K1-K4.  Returns the
    readings and the failed checks."""
    import os
    import tempfile
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    from neuron_gan_tpu_torch.parallel import spawn
    from neuron_gan_tpu_torch.train_step import (
        draw_batch, init_train_state, make_batch_step)
    make, chunk = PATHS['shipping']
    cfg = make()
    spec = chunk(cfg.n_phases - 1)
    raw = torch.from_numpy(np.random.default_rng(seed + 2).random(
        (8, 768, 768, 1)).astype(np.float32)).to('cuda')
    draws = draw_batch(torch.Generator(device='cuda').manual_seed(seed), cfg,
                       spec, 8, 768)

    def one_process():
        init = torch.Generator().manual_seed(seed)
        state = init_train_state(GeneratorPG(cfg, init, device='cuda'),
                                 DiscriminatorPG(cfg, init, device='cuda'))
        stats = make_batch_step(cfg, spec)(state, raw, draws, None, 0.0, 0.0)
        return {'D': [p.grad.cpu() for p in state.d.parameters()],
                'G': [p.grad.cpu() for p in state.g.parameters()],
                'stats': stats.cpu()}

    one, one_again = one_process(), one_process()
    arms = ('dp', 'fault_unweighted', 'fault_other_rows')
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_dp_rank, world_size, seed, arms, backend, tmp)
        ranks = [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                            weights_only=False) for r in range(world_size)]
    secs = time.perf_counter() - t0

    def dist(run):
        return {'D': rel_l2(run['D'], one['D']),
                'G': rel_l2(run['G'], one['G']),
                'stats': rel_l2([run['stats']], [one['stats']])}

    bound = dict(REL_L2_BOUND['shipping'], stats=DP_STATS_BOUND)
    dists = {'one~one': dist(one_again)}
    for arm in arms:
        r0 = ranks[0][arm]
        # every rank holds the same reduced gradients and stats
        same = all(torch.equal(a, b) for rk in ranks[1:] for net in ('D', 'G')
                   for a, b in zip(r0[net], rk[arm][net])) and \
            all(torch.equal(r0['stats'], rk[arm]['stats']) for rk in ranks)
        dists[arm] = dict(dist(r0), ranks_equal=same)
    # each rank's stats as a mean over its rows, summed
    unweighted = sum(rk['dp']['stats_local'] / (rk['dp']['rows'][1]
                                                 - rk['dp']['rows'][0])
                     for rk in ranks)
    dists['fault_stats_unweighted'] = {
        'stats': rel_l2([unweighted], [one['stats']])}

    def within(d):
        return all(d[k] <= bound[k] for k in bound if k in d)

    result = {'ranks': world_size, 'backend': backend, 'batch': 8,
              'devices': ['cuda:0' if backend == 'gloo' else f'cuda:{r}'
                          for r in range(world_size)],
              'rows': [rk['dp']['rows'] for rk in ranks],
              'rel_l2_bound': bound, 'rel_l2_to_one_process': dists,
              'spawned_seconds': round(secs, 3),
              'launches': {f'rank{r}': rk['dp']['launches']
                           for r, rk in enumerate(ranks)}}
    if backend == 'nccl':
        result['timing'] = [rk['timing'] for rk in ranks]
    failed = []
    if not within(dists['dp']) or not dists['dp']['ranks_equal']:
        failed.append(f'{world_size} ranks outside the bound of the '
                      '1-process step')
    for arm in (*arms[1:], 'fault_stats_unweighted'):
        if within(dists[arm]):
            failed.append(f'planted fault {arm} inside the bound')
    for r, rk in enumerate(ranks):
        for key in ('k1', 'k2', 'k3', 'k4'):
            if not rk['dp']['launches'][key]:
                failed.append(f'rank {r} never launched {key}')
    return result, failed


def check_dp(torch, seed):
    """Two ranks on the one card (gloo on CUDA tensors: NCCL takes one rank
    a card), 4 rows each of the flagship batch (``dp_step_parity``).  Then
    the train CLI with mesh_shape={'data': 1}: its NCCL path."""
    step, failed = dp_step_parity(torch, seed, 2, 'gloo')
    result = {'phase': 'dp', 'nvidia_smi': nvidia_smi_line(),
              'path': 'shipping', 'resolution': 512, **step}
    if failed:
        raise AssertionError(f'{failed}: {json.dumps(result)}')

    # the CLI's own data-parallel path: one rank, NCCL, a process it spawns
    result['cli'] = cli_one_nccl_rank(seed, {'data': 1}, 'smkd')
    return result


def cli_one_nccl_rank(seed, mesh, run_id):
    """The train CLI (``python -m``, a process of its own) under ``mesh``,
    a grid of one rank, for 4 epochs: it must spawn its one rank over NCCL
    on cuda:0, say so on its rank line and write a finite checkpoint at
    epoch 4."""
    import os
    import tempfile
    from neuron_gan_tpu_torch.checkpoint import load_pytree_npz
    with tempfile.TemporaryDirectory() as tmp:
        data = write_dataset(os.path.join(tmp, 'data'), seed)
        cfg_path = os.path.join(tmp, f'{run_id}.py')
        root = os.path.join(tmp, 'run')
        write_cli_config(cfg_path, root, data, seed, ID=run_id,
                         mesh_shape=mesh, N_epochs_session=4)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, '-m', 'neuron_gan_tpu_torch.train', '--configs',
             cfg_path], capture_output=True, text=True, timeout=600)
        cli_secs = time.perf_counter() - t0
        said = [ln for ln in run.stdout.splitlines()
                if ln.startswith('mesh:')]
        if run.returncode or said != ['mesh: data 1 x model 1, nccl on cuda:0']:
            raise AssertionError(f'train CLI under mesh_shape={mesh}: rc '
                                 f'{run.returncode}, {said}\n'
                                 f'{run.stdout[-3000:]}\n{run.stderr[-3000:]}')
        payload, meta = load_pytree_npz(os.path.join(root, 'weights',
                                                     f'GenDisc_{run_id}.npz'))
    assert meta['epoch'] == 4, meta
    for name, series in payload['series'].items():
        assert np.isfinite(series).all(), name
    return {'mesh': mesh, 'seconds': round(cli_secs, 3), 'said': said[0],
            'checkpoint_epoch': meta['epoch']}


def collective_timer(torch):
    """Patches of torch.distributed's all_reduce and all_gather_into_tensor
    that time each call on the current stream with CUDA events (from the
    end of the work queued before it to the end of the collective, waits
    for other ranks included), and ``read()``: their summed ms."""
    import torch.distributed as dist
    events = []

    def timed(fn):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events.append((start, end))
            return out
        return call

    def read():
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events)

    return [mock.patch.object(dist, name, timed(getattr(dist, name)))
            for name in ('all_reduce', 'all_gather_into_tensor')], read


def steady_rate(torch, one_step, n_warm=2, n=10):
    """Steps/s of ``one_step`` over ``n`` calls after ``n_warm``, ended by a
    synchronize, and the ms a step its collectives take
    (``collective_timer``)."""
    import contextlib
    for _ in range(n_warm):
        one_step()
    patches, read = collective_timer(torch)
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            one_step()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return {'steps': n, 'steps_per_s': n / secs,
            'collective_ms_per_step': read() / n}


# ---------------------------------------------------------------------------
# phase tp and dp_nccl's model arm: the 'model' mesh axis
# ---------------------------------------------------------------------------

TP_ARMS = ('tp', 'fault_without_1/M', 'fault_other_slice', 'fault_stale_d')


def tp_inputs(torch, seed, device, n_steps=2):
    """The shipping path at 512^2: its config, chunk spec, the flagship
    batch of 8 (768^2 frames from ``seed``) and the draws of ``n_steps``
    batch steps."""
    from neuron_gan_tpu_torch.train_step import draw_batch
    make, chunk = PATHS['shipping']
    cfg = make()
    spec = chunk(cfg.n_phases - 1)
    raw = torch.from_numpy(np.random.default_rng(seed + 2).random(
        (8, 768, 768, 1)).astype(np.float32)).to(device)
    rng = torch.Generator(device=device).manual_seed(seed)
    return cfg, spec, raw, [draw_batch(rng, cfg, spec, 8, 768)
                            for _ in range(n_steps)]


def _tp_rank(rank, world_size, init_method, seed, model_size, n_steps,
             backend, out_dir):
    """One rank of a (data, model) grid (``parallel.Grid``; over gloo every
    rank on cuda:0, over NCCL rank r on cuda:r): ``n_steps`` shipping 512^2
    steps at the flagship lr of each arm of TP_ARMS on this rank's rows of
    the batch of 8, its state sharded (``shard_state``).  Saves, per arm, each step's
    reduced local gradients (before Adam), the local tensors after both
    steps, both steps' stats summed over the data group and the launches;
    over NCCL also a steady window's steps/s and collective ms."""
    import contextlib
    import os
    import torch
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    from neuron_gan_tpu_torch.parallel import Grid, shard_state, take_rows
    from neuron_gan_tpu_torch.train_step import (
        init_train_state, make_batch_step)
    device = 'cuda:0' if backend == 'gloo' else f'cuda:{rank}'
    grid = Grid.init(rank, world_size, init_method, device, model_size,
                     backend)
    cfg, spec, raw, draws = tp_inputs(torch, seed, device, n_steps)
    lo, hi = grid.rows(8)
    draws = [take_rows(d, lo, hi) for d in draws]
    out = {'coords': (grid.data_rank, grid.model_rank), 'rows': [lo, hi]}

    def slice0(t):
        return t.reshape(model_size, -1)[0].view(
            (t.shape[0] // model_size,) + tuple(t.shape[1:]))

    try:
        for arm in TP_ARMS:
            init = torch.Generator().manual_seed(seed)
            state = shard_state(init_train_state(
                GeneratorPG(cfg, init, device=device),
                DiscriminatorPG(cfg, init, device=device)), grid)
            sh = state.shards
            patches = []
            if arm == 'fault_without_1/M':
                # the model ranks' sum of one gradient counted M times
                for net in (sh.g, sh.d):
                    patches.append(mock.patch.object(
                        net, 'reduce_grads',
                        lambda w, f=net.reduce_grads: f(w * model_size)))
            if arm == 'fault_other_slice':
                # every model rank steps its slice with model rank 0's
                # slice of the gradient
                patches.append(mock.patch.object(grid, 'shard_of', slice0))
            if arm == 'fault_stale_d':
                # D's working copy never refreshed after the critic update
                patches.append(mock.patch.object(sh.d, 'refresh',
                                                 lambda: None))
            step = make_batch_step(cfg, spec, grid)
            grads, stats = [], []
            reset_counters()
            with contextlib.ExitStack() as stack:
                for patch in patches:
                    stack.enter_context(patch)
                for d in draws:
                    stats.append(step(state, raw[lo:hi], d, None, spec.lr0,
                                      0.0, 8))
                    grads.append({net: [t.grad.cpu() for t in
                                        getattr(sh, net).local]
                                  for net in ('d', 'g')})
            launches = read_counters()
            out[arm] = {'grads': grads,
                        'D': [t.detach().cpu() for t in sh.d.local],
                        'G': [t.detach().cpu() for t in sh.g.local],
                        'stats': grid.all_reduce_(torch.stack(stats)).cpu(),
                        'launches': launches}
            if arm == 'tp' and backend == 'nccl':
                out['timing'] = steady_rate(torch, lambda: step(
                    state, raw[lo:hi], draws[0], None, spec.lr0, 0.0, 8))
        grid.barrier()
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))


def tp_step_parity(torch, seed, world_size, model_size, backend):
    """``world_size`` ranks over ``backend`` in a grid of ``world_size /
    model_size`` data rows and ``model_size`` model ranks (``_tp_rank``):
    shipping 512^2 steps at the flagship lr against the 1-process steps on
    cuda:0 from the same parameters and draws, two on a grid of one data
    row and one on more: there the sums run in another order than one
    process's, Adam's first step turns that rounding into lr-sized moves on
    near-zero gradients, and the bfloat16 gradient of a second step moves
    by the bound's size (G 0.457 of 0.5 on data 2 x model 2 over NCCL).
    Held, by relative L2 within the shipping parity bound: each rank's
    reduced gradient of every slice before Adam (every step) against the
    slice of the 1-process
    gradient (Adam hides a constant factor in the parameters: only the
    gradient before it shows one), and its slices after the steps against
    the 1-process parameters' (largest over the ranks); both steps' stats
    within DP_STATS_BOUND; every rank's replicated leaves (gradients and
    parameters) equal bit for bit, and its slices equal those of every rank
    of its model rank; three planted faults outside the bound (the
    gradient without the ``/ M``; model rank 1 stepping its slice with
    model rank 0's gradient; D's working copy not refreshed after the
    critic update); each rank launching K1-K4 exactly as the 1-process
    steps do.  Returns the readings and the failed checks."""
    import os
    import tempfile
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    from neuron_gan_tpu_torch.parallel import is_sharded, spawn
    from neuron_gan_tpu_torch.train_step import (
        init_train_state, make_batch_step)
    n_steps = 2 if world_size == model_size else 1
    cfg, spec, raw, draws = tp_inputs(torch, seed, 'cuda', n_steps)

    def one_process():
        init = torch.Generator().manual_seed(seed)
        state = init_train_state(GeneratorPG(cfg, init, device='cuda'),
                                 DiscriminatorPG(cfg, init, device='cuda'))
        step = make_batch_step(cfg, spec)
        grads, stats = [], []
        reset_counters()
        for d in draws:
            stats.append(step(state, raw, d, None, spec.lr0, 0.0))
            grads.append({net: [p.grad.cpu() for p in getattr(
                state, net).parameters()] for net in ('d', 'g')})
        return {'grads': grads,
                'D': [p.detach().cpu() for p in state.d.parameters()],
                'G': [p.detach().cpu() for p in state.g.parameters()],
                'stats': torch.stack(stats).cpu(),
                'launches': read_counters()}

    one, one_again = one_process(), one_process()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_tp_rank, world_size, seed, model_size, n_steps, backend, tmp)
        ranks = [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                            weights_only=False) for r in range(world_size)]
    secs = time.perf_counter() - t0
    sharded = {net: [is_sharded(t.shape, model_size) for t in one[net]]
               for net in ('D', 'G')}

    def mine(ts, net, m, n_model):
        """Model rank ``m``'s part of each whole tensor of ``net``."""
        return [t.reshape(n_model, -1)[m].view(
            (t.shape[0] // n_model,) + tuple(t.shape[1:])) if s else t
            for t, s in zip(ts, sharded[net])]

    def dist(run, m, n_model=model_size):
        d = {}
        for k in range(len(draws)):
            for net in ('D', 'G'):
                d[f'{net}_grad_{k + 1}'] = rel_l2(
                    run['grads'][k][net.lower()],
                    mine(one['grads'][k][net.lower()], net, m, n_model))
        for net in ('D', 'G'):
            d[net] = rel_l2(run[net], mine(one[net], net, m, n_model))
        d['stats'] = rel_l2([run['stats']], [one['stats']])
        return d

    def same_across(arm):
        """Every rank's replicated leaves equal bit for bit, its slices
        those of every rank of its model rank (gradients and parameters)."""
        def tensors(rk, net):
            run = rk[arm]
            return [run[net]] + [g[net.lower()] for g in run['grads']]
        for net in ('D', 'G'):
            for rk in ranks[1:]:
                twin = ranks[rk['coords'][1]]   # data row 0, same model rank
                for xs, ys, zs in zip(tensors(rk, net), tensors(ranks[0], net),
                                      tensors(twin, net)):
                    for x, y, z, s in zip(xs, ys, zs, sharded[net]):
                        if not torch.equal(x, z if s else y):
                            return False
        return True

    bound = dict(REL_L2_BOUND['shipping'], stats=DP_STATS_BOUND)

    def within(d):
        return all(v <= bound[k.split('_')[0]] for k, v in d.items())

    dists = {'one~one': dist(one_again, 0, 1)}
    for arm in TP_ARMS:
        per_rank = [dist(rk[arm], rk['coords'][1]) for rk in ranks]
        dists[arm] = {k: max(d[k] for d in per_rank) for k in per_rank[0]}
        dists[arm]['ranks_equal'] = same_across(arm)
    result = {'ranks': world_size,
              'mesh': {'data': world_size // model_size, 'model': model_size},
              'backend': backend, 'batch': 8, 'steps': len(draws),
              'lr': spec.lr0,
              'coords': [list(rk['coords']) for rk in ranks],
              'rows': [rk['rows'] for rk in ranks],
              'sharded_leaves': {net: f'{sum(s)} of {len(s)}'
                                 for net, s in sharded.items()},
              'rel_l2_bound': bound, 'rel_l2_to_one_process': dists,
              'spawned_seconds': round(secs, 3),
              'launches_one_process': one['launches'],
              'launches': {f'rank{r}': rk['tp']['launches']
                           for r, rk in enumerate(ranks)}}
    if backend == 'nccl':
        result['timing'] = [rk['timing'] for rk in ranks]
    failed = []
    sound = {k: v for k, v in dists['tp'].items() if k != 'ranks_equal'}
    if not within(sound) or not dists['tp']['ranks_equal']:
        failed.append(f'the grid {result["mesh"]} outside the bound of the '
                      '1-process steps, or its ranks differ')
    for arm in TP_ARMS[1:]:
        if within({k: v for k, v in dists[arm].items()
                   if k != 'ranks_equal'}):
            failed.append(f'planted fault {arm} inside the bound')
    for r, rk in enumerate(ranks):
        if rk['tp']['launches'] != one['launches']:
            failed.append(f'rank {r} launched {rk["tp"]["launches"]}, one '
                          f'process {one["launches"]}')
        for key in ('k1', 'k2', 'k3', 'k4'):
            if not rk['tp']['launches'][key]:
                failed.append(f'rank {r} never launched {key}')
    return result, failed


def check_tp(torch, seed):
    """The 'model' axis on the one card: a grid of one data row and two
    model ranks sharing cuda:0 over gloo (``tp_step_parity``).  Then the
    train CLI with mesh_shape={'data': 1, 'model': 1}: the grid's NCCL
    path."""
    step, failed = tp_step_parity(torch, seed, 2, 2, 'gloo')
    result = {'phase': 'tp', 'nvidia_smi': nvidia_smi_line(),
              'path': 'shipping', 'resolution': 512, **step}
    if failed:
        raise AssertionError(f'{failed}: {json.dumps(result)}')

    result['cli'] = cli_one_nccl_rank(seed, {'data': 1, 'model': 1}, 'smkt')
    return result


def recording_chunks(stats):
    """``TrainSession._run_chunk`` patched to append each chunk's stats."""
    from neuron_gan_tpu_torch.train import TrainSession
    run_chunk = TrainSession._run_chunk

    def recorded(self, *args):
        stats.append(run_chunk(self, *args))
        return stats[-1]
    return mock.patch.object(TrainSession, '_run_chunk', recorded)


def _local_state(state):
    """A rank's own tensors under a model axis, as numpy: per net its local
    parameters and both Adam moments, and which are slices."""
    sh = state.shards
    out = {}
    for net, opt in (('G', state.g_opt), ('D', state.d_opt)):
        shards = getattr(sh, net.lower())
        out[net] = {'sharded': list(shards.sharded),
                    'params': [t.detach().cpu().numpy() for t in shards.local],
                    **{key: [opt.state[t][key].cpu().numpy()
                             for t in shards.local]
                       for key in ('exp_avg', 'exp_avg_sq')}}
    return out


def _cli_rank(rank, world_size, init_method, argv, out_dir):
    """A rank of the train CLI's parallel session (``_train_rank``, as the
    CLI spawns it) that keeps what ``check_dp_nccl`` compares: its final
    state (the JAX layout; under a model axis its own tensors,
    ``_local_state``), every epoch's stats, its launches and its place in
    the grid.  Its standard output goes to ``out_dir``."""
    import contextlib
    import os
    import torch
    from neuron_gan_tpu_torch import train as ttrain
    from neuron_gan_tpu_torch.convert import to_jax_state
    stats = []
    reset_counters()
    with open(os.path.join(out_dir, f'rank{rank}.log'), 'w') as log, \
            contextlib.redirect_stdout(log), recording_chunks(stats):
        session = ttrain._train_rank(rank, world_size, init_method, argv)
    state = (to_jax_state(session.state) if session.state.shards is None
             else _local_state(session.state))
    grid = session.grid
    torch.save((state, np.concatenate(stats), read_counters(),
                (grid.data_rank, grid.model_rank)),
               os.path.join(out_dir, f'rank{rank}.pt'))


def state_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in state_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in state_leaves(v)]
    return [np.asarray(tree)]


def _grid_session(torch, tmp, data, seed, mesh, run_id, **knobs):
    """The train CLI's session under ``mesh`` (``train.main``, its ranks
    spawned as the CLI spawns them, each through ``_cli_rank``) in
    ``tmp/<run_id>``.  Returns the wall seconds, every rank's saved tuple,
    rank 0's rank line and its checkpoint (payload, meta)."""
    import os
    from neuron_gan_tpu_torch import train as ttrain
    from neuron_gan_tpu_torch.checkpoint import load_pytree_npz
    from neuron_gan_tpu_torch.parallel import mesh_ranks, spawn
    n = mesh_ranks(mesh)
    out_dir = os.path.join(tmp, f'{run_id}_ranks')
    os.makedirs(out_dir)
    root = os.path.join(tmp, run_id)
    cfg_path = os.path.join(tmp, f'{run_id}.py')
    write_cli_config(cfg_path, root, data, seed, ID=run_id, mesh_shape=mesh,
                     **knobs)
    spawned = []

    def spawn_recording(target, world, argv):
        assert target is ttrain._train_rank and world == n
        spawned.append(world)
        spawn(_cli_rank, world, argv, out_dir)

    t0 = time.perf_counter()
    with mock.patch.object(ttrain, 'spawn', spawn_recording):
        ttrain.main(['--configs', cfg_path])
    secs = time.perf_counter() - t0
    assert spawned == [n], spawned
    ranks = [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                        weights_only=False) for r in range(n)]
    with open(os.path.join(out_dir, 'rank0.log')) as fh:
        said = [ln for ln in fh.read().splitlines() if ln.startswith('mesh:')]
    return secs, ranks, said, load_pytree_npz(
        os.path.join(root, 'weights', f'GenDisc_{run_id}.npz'))


def check_dp_nccl(torch, seed, world_size):
    """``world_size`` ranks over NCCL, rank r on cuda:r.  First the batch
    step of ``dp_step_parity`` and, for an even ``world_size``,
    ``tp_step_parity`` on a grid of ``world_size / 2`` data rows and 2
    model ranks; over each, a steady window's steps/s and collective
    ms a step, beside one process's steps/s on the same batch.  Then the
    train CLI's sessions on 16 synthetic 512^2 PNGs through every phase to
    epoch 16, with the similarity loss on (its images and z gathered over
    NCCL), under mesh_shape={'data': world_size} and, for an even
    ``world_size``, {'data': world_size / 2, 'model': 2}.  Held for each:
    every rank's stats equal bit for bit (and its state, or its
    replicated leaves and the slices of its model rank), finite stats,
    rank 0's checkpoint at epoch 16 with finite series, each rank
    launching K1-K4, and D's and G's parameters (the grid's gathered into
    the checkpoint) within the shipping parity bound of a 1-process session
    of the same config on cuda:0, the distance between two such sessions
    printed beside it.  The grid's checkpoint is resumed by one process
    for an epoch 17."""
    import contextlib
    import os
    import tempfile
    from neuron_gan_tpu_torch import train as ttrain
    from neuron_gan_tpu_torch.convert import to_jax_state
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    from neuron_gan_tpu_torch.train_step import (
        init_train_state, make_batch_step)
    if torch.cuda.device_count() < world_size:
        raise AssertionError(f'{world_size} ranks need {world_size} cards, '
                             f'have {torch.cuda.device_count()}')
    model_arm = world_size % 2 == 0
    step, failed = dp_step_parity(torch, seed, world_size, 'nccl')
    result = {'phase': 'dp_nccl', 'nvidia_smi': nvidia_smi_lines(),
              'path': 'shipping', 'resolution': 512, 'step': step}
    if model_arm:
        tp_step, tp_failed = tp_step_parity(torch, seed, world_size, 2,
                                            'nccl')
        result['tp_step'] = tp_step
        failed += tp_failed
    cfg, spec, raw, draws = tp_inputs(torch, seed, 'cuda')
    init = torch.Generator().manual_seed(seed)
    state = init_train_state(GeneratorPG(cfg, init, device='cuda'),
                             DiscriminatorPG(cfg, init, device='cuda'))
    one_step = make_batch_step(cfg, spec)
    result['one_process_timing'] = steady_rate(torch, lambda: one_step(
        state, raw, draws[0], None, spec.lr0, 0.0))
    if failed:
        raise AssertionError(f'{failed}: {json.dumps(result)}')

    knobs = dict(sim_loss_lambda=0.1, N_epochs_session=None)
    meshes = {'dp': {'data': world_size}}
    if model_arm:
        meshes['tp'] = {'data': world_size // 2, 'model': 2}
    with tempfile.TemporaryDirectory() as tmp:
        data = write_dataset(os.path.join(tmp, 'data'), seed)
        runs = {}
        for name, run_id in (('one', 'smko'), ('one_again', 'smkp')):
            cfg_path = os.path.join(tmp, f'{name}.py')
            write_cli_config(cfg_path, os.path.join(tmp, name), data, seed,
                             ID=run_id, **knobs)
            stats = []
            t0 = time.perf_counter()
            with open(os.path.join(tmp, f'{name}.log'), 'w') as log, \
                    contextlib.redirect_stdout(log), recording_chunks(stats):
                session = ttrain.main(['--configs', cfg_path])
            runs[name] = {'state': to_jax_state(session.state),
                          'stats': np.concatenate(stats),
                          'seconds': time.perf_counter() - t0}
        sessions = {arm: _grid_session(torch, tmp, data, seed, mesh,
                                       f'smk{arm}', **knobs)
                    for arm, mesh in meshes.items()}
        if model_arm:
            # one process resumes the grid's checkpoint, for one epoch more
            cfg_path = os.path.join(tmp, 'resume.py')
            write_cli_config(cfg_path, os.path.join(tmp, 'smktp'), data, seed,
                             ID='smktp', resume=True, N_epochs=17,
                             N_epochs_session=None)
            stats = []
            with open(os.path.join(tmp, 'resume.log'), 'w') as log, \
                    contextlib.redirect_stdout(log), recording_chunks(stats):
                session = ttrain.main(['--configs', cfg_path])
            resumed = {'epoch_init': session.epoch_init,
                       'stats': np.concatenate(stats)}

    def params(state, net):
        return [torch.from_numpy(np.array(x)) for x in
                state_leaves(state[f'{net.lower()}_params'])]

    def dist(state):
        return {net: rel_l2(params(state, net),
                            params(runs['one']['state'], net))
                for net in ('D', 'G')}

    def stats_dist(s):
        return rel_l2([torch.from_numpy(s)],
                      [torch.from_numpy(runs['one']['stats'])])

    def grid_equal(ranks):
        """Every rank's replicated leaves equal, its slices those of the
        rank of its model rank on data row 0."""
        for saved in ranks[1:]:
            local, twin = saved[0], ranks[saved[3][1]][0]
            for net in ('G', 'D'):
                for key in ('params', 'exp_avg', 'exp_avg_sq'):
                    for x, y, z, s in zip(local[net][key],
                                          ranks[0][0][net][key],
                                          twin[net][key],
                                          local[net]['sharded']):
                        if not np.array_equal(x, z if s else y):
                            return False
        return True

    bound = REL_L2_BOUND['shipping']
    result['rel_l2_bound'] = bound
    result['one_process_seconds'] = [round(r['seconds'], 3)
                                     for r in runs.values()]
    result['one_again'] = {'params_rel_l2': dist(runs['one_again']['state']),
                           'stats_rel_l2': stats_dist(
                               runs['one_again']['stats'])}
    for arm, (secs, ranks, said, (payload, meta)) in sessions.items():
        state0, stats0 = ranks[0][0], ranks[0][1]
        sharded = arm == 'tp'
        gathered = payload['state'] if sharded else state0
        cli = {'mesh': meshes[arm], 'seconds': round(secs, 3), 'said': said,
               'checkpoint_epoch': int(meta['epoch']),
               'params_rel_l2_to_one_process': dist(gathered),
               'stats_rel_l2_to_one_process': stats_dist(stats0),
               'ranks_equal': all(np.array_equal(stats0, rk[1])
                                  for rk in ranks[1:]) and (
                   grid_equal(ranks) if sharded else all(
                       all(np.array_equal(x, y) for x, y in zip(
                           state_leaves(state0), state_leaves(rk[0])))
                       for rk in ranks[1:])),
               'launches': {f'rank{r}': rk[2] for r, rk in enumerate(ranks)}}
        if sharded:
            cli['resumed'] = {'epoch_init': resumed['epoch_init'],
                              'stats_finite': bool(np.isfinite(
                                  resumed['stats']).all())}
        result[f'cli_{arm}'] = cli
        mesh = meshes[arm]
        want = (f'mesh: data {mesh["data"]} x model {mesh.get("model", 1)}, '
                'nccl on cuda:0')
        d = cli['params_rel_l2_to_one_process']
        if said != [want]:
            failed.append(f'{arm}: rank 0 said {said}')
        if meta['epoch'] != 16 or not all(
                np.isfinite(s).all() for s in payload['series'].values()) or \
                not all(np.isfinite(x).all() for x in state_leaves(gathered)):
            failed.append(f'{arm}: checkpoint at epoch {meta["epoch"]}, or '
                          'not finite')
        if not np.isfinite(stats0).all() or not cli['ranks_equal']:
            failed.append(f'{arm}: stats not finite, or the ranks differ')
        if d['D'] > bound['D'] or d['G'] > bound['G']:
            failed.append(f"{arm}: the ranks' parameters outside the bound "
                          'of the 1-process session')
        for r, rk in enumerate(ranks):
            for key in ('k1', 'k2', 'k3', 'k4'):
                if not rk[2][key]:
                    failed.append(f'{arm}: rank {r} never launched {key}')
        if sharded and (resumed['epoch_init'] != 17
                        or not cli['resumed']['stats_finite']):
            failed.append(f'one process did not resume the grid: {resumed}')
    if failed:
        raise AssertionError(f'{failed}: {json.dumps(result)}')
    return result


LEGACY_KNOBS = dict(wgan=True, pggan=False, n_critic=1, checkpointing_period=2,
                    N_epochs_session=None)


def check_legacy(torch, seed):
    """The train CLI under wgan=True at the config_ex geometry (512^2, G
    (128, 64, 32, 32, 16, 16), D (16, 16, 32, 32, 64, 128), latent 64,
    batch 8) on 16 synthetic PNGs: epochs 1-4, then resumed to 6.  Held:
    finite stats, every critic parameter within +-0.01, family 'wgan' in
    the checkpoint's meta, the resumed session starting from the saved
    state bit for bit.  The legacy nets are cuDNN/ATen layers: no ported
    kernel launches, and none must."""
    import os
    import tempfile
    import neuron_gan_tpu_torch.legacy_train as lt
    from neuron_gan_tpu_torch.checkpoint import load_pytree_npz
    from neuron_gan_tpu_torch.convert import to_jax_legacy_state
    first = {}
    real_runner = lt.make_wgan_epoch_runner

    def recording_runner(**kw):
        run = real_runner(**kw)

        def recorded(state, images, rng):
            if not first:
                first['state'] = to_jax_legacy_state(state)
            return run(state, images, rng)
        return recorded

    with tempfile.TemporaryDirectory() as tmp, \
            open(os.path.join(tmp, 'cli.log'), 'w') as log:
        data = write_dataset(os.path.join(tmp, 'data'), seed)
        root = os.path.join(tmp, 'run')
        sessions = []
        reset_counters()
        for n_epochs, flags in ((4, []), (6, ['--resume'])):
            cfg_path = os.path.join(tmp, f'legacy{n_epochs}.py')
            write_cli_config(cfg_path, root, data, seed, ID='smkl',
                             N_epochs=n_epochs, **LEGACY_KNOBS)
            if flags:
                saved, saved_meta = load_pytree_npz(
                    os.path.join(root, 'weights', 'GenDisc_smkl.npz'))
            with mock.patch.object(lt, 'make_wgan_epoch_runner',
                                   recording_runner if flags else real_runner):
                text, secs = run_cli('neuron_gan_tpu_torch.train',
                                     ['--configs', cfg_path] + flags, log)
            sessions.append({'epochs': n_epochs, 'seconds': round(secs, 3),
                             'lines': [ln for ln in text.splitlines()
                                       if ln.startswith('Epoch: ')]})
        payload, meta = load_pytree_npz(
            os.path.join(root, 'weights', 'GenDisc_smkl.npz'))
        grids = sorted(f for f in os.listdir(os.path.join(root, 'images'))
                       if f.startswith('Samples_smkl'))
    launches = read_counters()
    differ = leaves_differ(first['state'], saved['state'])
    d_max = max(float(np.abs(np.asarray(x)).max())
                for x in _tree_leaves(payload['state']['d_params']))
    result = {'phase': 'legacy', 'nvidia_smi': nvidia_smi_line(),
              'family': meta.get('family'),
              'geometry': {'image_size': 512, 'G': [128, 64, 32, 32, 16, 16],
                           'D': [16, 16, 32, 32, 64, 128], 'latent': 64,
                           'batch': 8},
              'sessions': sessions, 'checkpoint_epoch': meta['epoch'],
              'resumed_from_epoch': saved_meta['epoch'],
              'critic_abs_max': d_max, 'grids': grids,
              'kernels': 'none: the legacy nets are cuDNN/ATen layers',
              'launches': launches}
    failed = []
    if meta.get('family') != 'wgan' or meta['epoch'] != 6:
        failed.append('checkpoint meta')
    if not all(np.isfinite(v).all() and len(v) == 6
               for v in payload['series'].values()):
        failed.append('stats not finite')
    if d_max > 0.01:
        failed.append('a critic parameter outside +-0.01')
    if differ:
        failed.append(f'resumed state differs from the saved one: {differ}')
    if any(launches.values()):
        failed.append('a ported kernel launched')
    if failed:
        raise AssertionError(f'{failed}: {json.dumps(result)}')
    return result


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# phase stretch: the 1024^2 EMA run (tools/stretch_1024.py)
# ---------------------------------------------------------------------------

STRETCH_EPOCHS = 6


def _add_counts(a, b):
    """Launch counts ``a`` + ``b`` (``expected_launches``' structure)."""
    out = {k: dict(v) for k, v in a.items()}
    for key, counts in b.items():
        for k, n in counts.items():
            out.setdefault(key, {})[k] = out.get(key, {}).get(k, 0) + n
    return out


def per_step_sites(cases, dtype, n_steps, other_sites):
    """Launches per step by (kernel, shape, case), as counted: the
    ``cases`` (``read_cases``) of ``dtype`` less ``other_sites`` (launches
    outside the steps, by ``step_sites``' key), over ``n_steps``."""
    counted = collections.Counter(
        {(k, shape, case): n for (k, d, shape, case), n in cases.items()
         if d == dtype})
    counted.subtract(other_sites)
    return {key: n / n_steps for key, n in counted.items() if n}


def check_stretch(torch, seed, work):
    """``tools/stretch_1024``'s body at 6 epochs (a warm-up chunk and a
    timed chunk at 1024^2, batch 4, the EMA shadow, the .npz and the -ema
    grid of 4 samples), then one 1024^2 step by ``parity``.  Held: every
    kernel's launches exactly (by dtype and grouping, and by whole shape
    and case: the grid's G forward and 24 steps of ``step_sites`` each), the
    1024^2 level's K1/K2 at 8 groups of 8 channels launched, no
    runtime-width instance, 0 < d_ema < d_raw (the tool's own check), the
    grid's size, and the parity bound with its two planted faults."""
    import os
    from neuron_gan_tpu_torch.data.neuron_dataset import decode_image
    from neuron_gan_tpu_torch.tools import stretch_1024 as s1k
    args = s1k.parse_args(['--epochs', str(STRETCH_EPOCHS), '--seed', str(seed),
                           '--out', os.path.join(work, 'stretch')])
    cfg, spec = s1k.stretch_config(args.batch, args.ema_beta)
    top, res = cfg.n_phases - 1, cfg.image_size_max
    n_steps = 2 * args.epochs * spec.n_full_batches
    n_samples = 4

    reset_counters()
    with graph_replays() as replays:
        result, state = s1k.run(args)
    torch.cuda.synchronize()
    launches, cases = read_counters(), read_cases()
    del state
    dt = str(cfg.dtype).removeprefix('torch.')
    # the wrappers count the eager steps and the captures, not the replays
    counted = launched_phases([top] * n_steps, replays)
    want = _add_counts(expected_launches(cfg, counted),
                       expected_launches(cfg, [top], passes=SAMPLE_PASSES))
    per_step = per_step_sites(cases, dt, len(counted),
                              step_sites(cfg, top, n_samples, SAMPLE_PASSES))
    want_per_step = {key: float(n) for key, n in
                     step_sites(cfg, top, args.batch).items()}
    top_x = (args.batch, 8 * cfg.n_gen_features[-1], res // 2, res // 4)
    c_g8 = {k: cases[k, dt, top_x, 8] for k in ('k1', 'k2')}
    runtime = {str(k): n for k, n in cases.items() if '/' in k[0]}
    grid = decode_image(result['ema_grid']).shape
    side = 2 * (res + 2) + 2

    raw = s1k.padded_stack(cfg, args.batch, seed + 1, 'cuda')
    par = parity(torch, seed, cfg, dataclasses.replace(spec, ema_beta=0.0),
                 raw, 'stretch')
    out = {'phase': 'stretch', 'nvidia_smi': nvidia_smi_line(),
           'resolution': res, 'batch': args.batch, 'steps': n_steps,
           'graph_replays': dict(replays),
           'steps_per_s': result['value'], 'timed_steps': result['steps'],
           'timed_seconds': result['seconds'],
           'peak_mem_gib': result['peak_mem_gib'],
           'd_ema_vs_d_raw': result['d_ema_vs_d_raw'],
           'stats_mean': result['stats_mean'], 'ema_grid': list(grid),
           'launches': launches, 'c_g8_launches': c_g8,
           'c_g8_x': list(top_x), 'runtime_width_launches': runtime,
           'launches_per_step': [
               {'kernel': k, 'dtype': dt, 'x': list(shape), 'case': c, 'n': n}
               for (k, shape, c), n in sorted(per_step.items(), key=str)],
           'parity': par}
    failed = []
    if launches != want:
        failed.append(f'launches {launches} != {want}')
    if per_step != want_per_step or any(k[1] != dt for k in cases):
        failed.append('launches by shape differ from step_sites')
    if not (c_g8['k1'] and c_g8['k2']):
        failed.append('K1/K2 at C_g 8 not launched')
    if runtime:
        failed.append('runtime-width instance launched')
    if grid[:2] != (side, side):
        failed.append(f'-ema grid {grid}')
    if failed:
        raise AssertionError(f'{failed}: {json.dumps(out)}')
    return out


# ---------------------------------------------------------------------------
# phase graphs: the steady step replayed from its CUDA graph
# ---------------------------------------------------------------------------

# relative L2 of a replayed chunk to the same chunk run eagerly, cuDNN
# deterministic, where two eager runs agree bit for bit (the shipping
# path); a float32 path's bilinear upsample (F.interpolate) accumulates its
# gradient with atomics, so there the bound is 3x the eager runs' distance
GRAPH_BOUND = 1e-5
# each kernel's name in a device trace (csrc/), and the kernel whose
# launches it follows: K3 splits its weights, then convolves
GRAPH_KERNELS = {'lrelu_pn_fwd_kernel': 'k1', 'lrelu_pn_bwd_kernel': 'k2',
                 'split_weights_kernel': 'k3', 'packed_conv_fwd_kernel': 'k3',
                 'packed_dz_kernel': 'k4'}


def check_step_graphs(torch, seed, name, n_epochs=4, n_traced=2):
    """A steady 512^2 chunk of path ``name`` through the epoch runner, which
    replays it from its CUDA graph after 3 eager steps and a capture,
    against the same chunk run eagerly (``capture=False``) from the same
    parameters, draws and capturable optimizers, cuDNN deterministic: every
    epoch's stats, both nets' parameters, their last gradients and Adam
    moments within GRAPH_BOUND, or within 3x the distance between two
    eager runs where they differ.  Then ``n_traced`` epochs of replays
    under torch.profiler: the wrappers count no launch, and the device
    trace holds each of K1-K4 by name as often a step as
    ``steady_step_sites`` says."""
    from neuron_gan_tpu_torch import train_step as ts
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    make, chunk = PATHS[name]
    cfg = make()
    spec = chunk(cfg.n_phases - 1)
    images = torch.from_numpy(np.random.default_rng(seed + 5).random(
        (spec.n_images, 768, 768, 1)).astype(np.float32)).to('cuda')

    def one_run(capture):
        init = torch.Generator().manual_seed(seed)
        state = ts.init_train_state(GeneratorPG(cfg, init, device='cuda'),
                                    DiscriminatorPG(cfg, init, device='cuda'))
        for opt in (state.d_opt, state.g_opt):
            ts._capturable(opt, True)
        rng = torch.Generator(device='cuda').manual_seed(seed)
        before = collections.Counter(ts.step_graphs)
        stats = ts.make_epoch_runner(cfg, spec, n_epochs, capture=capture)(
            state, images, rng, 1)
        out = {'stats': [stats.cpu()], **_state_of(state),
               'D_grads': [p.grad.cpu() for p in state.d.parameters()],
               'G_grads': [p.grad.cpu() for p in state.g.parameters()],
               'step_graphs': dict(ts.step_graphs - before)}
        return out, state, rng

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager, _, _ = one_run(False)
        eager_again, _, _ = one_run(False)
        graphed, state, rng = one_run(True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    keys = ('stats', 'D', 'G', 'D_grads', 'G_grads', 'D_moments', 'G_moments')
    dist = {k: rel_l2(graphed[k], eager[k]) for k in keys}
    twins = {k: rel_l2(eager_again[k], eager[k]) for k in keys}

    # replays only, traced
    n_steps = n_traced * spec.n_full_batches
    run = ts.make_epoch_runner(cfg, spec, n_traced)
    reset_counters()
    before = collections.Counter(ts.step_graphs)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        stats = run(state, images, rng, 1 + n_epochs)
        torch.cuda.synchronize()
    traced_graphs = dict(ts.step_graphs - before)
    counted = {str(k): n for k, n in read_cases().items() if n}
    kernels = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kernels[e.name()] += 1
    by_name = {k: sum(n for full, n in kernels.items() if k in full) / n_steps
               for k in GRAPH_KERNELS}
    sites = collections.Counter()
    for (k, _, _), n in steady_step_sites(name).items():
        sites[k] += n
    want = {k: float(sites[kernel]) for k, kernel in GRAPH_KERNELS.items()}
    out = {'phase': 'graphs', 'path': name, 'resolution': cfg.image_size_max,
           'steps': n_epochs * spec.n_full_batches, 'bound': GRAPH_BOUND,
           'rel_l2': dist, 'rel_l2_eager_twins': twins,
           'step_graphs': graphed['step_graphs'],
           'traced_steps': n_steps, 'traced_step_graphs': traced_graphs,
           'traced_counted_launches': counted,
           'traced_kernels_per_step': by_name, 'want_per_step': want,
           'traced_kernels_total': sum(kernels.values()),
           'traced_stats_finite': bool(torch.isfinite(stats).all())}
    failed = [k for k, d in dist.items()
              if not (d <= GRAPH_BOUND or d <= 3 * twins[k])]
    if graphed['step_graphs'] != {'eager:warmup': 3, 'captured': 1,
                                  'replayed': out['steps'] - 3}:
        failed.append('the chunk did not capture once and replay')
    if traced_graphs != {'replayed': n_steps}:
        failed.append('the traced chunk did not only replay')
    if counted:
        failed.append('a wrapper counted a replayed launch')
    if by_name != want:
        failed.append('K1-K4 in the trace differ from steady_step_sites')
    if not out['traced_stats_finite']:
        failed.append('traced stats not finite')
    if failed:
        raise AssertionError(f'{failed}: {json.dumps(out)}')
    return out


# ---------------------------------------------------------------------------
# phase tools: the A/B harness, the profilers, the converter, the native
# loader (neuron_gan_tpu_torch/tools, runtime/native.py)
# ---------------------------------------------------------------------------

AB_ARGV = ['--epochs', '40', '--transits', '10', '20', '30', '--alpha_step',
           '0.25', '--res', '128']


def _quiet(fn, *a):
    """fn(*a) with its standard output captured; returns (result, text)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a)
    return out, buf.getvalue()


def ab_arm_launches(args, n_images, precision_name, kw, replays=()):
    """(kernel launches, batch steps) of one arm of ``precision_ab.run_arm``
    (its keyword arguments ``kw``) under ``args``: every step of the
    schedule at its phase, batch 8, less the ``replays`` of CUDA graphs
    (``graph_replays``), then the final samples' G forward."""
    from neuron_gan_tpu_torch.tools import precision_ab as pab
    cfg = pab.arm_config(precision_name, kw['compute_dtype'], kw['packed_lanes'])
    sched = pab.arm_schedule(args)
    phases = []
    for start, end in sched.plan_chunks(1, args.epochs + 1):
        phases += [sched.phase_at(start)] * (end - start + 1) * -(-n_images // 8)
    passes = step_passes(gp_reuse_fakes=kw['gp_reuse_fakes'])
    return _add_counts(
        expected_launches(cfg, launched_phases(phases, replays), passes=passes),
        expected_launches(cfg, [cfg.n_phases - 1], passes=SAMPLE_PASSES)), len(phases)


def check_ab(torch, seed, work):
    """``stacked_ab`` cut to 40 epochs (16^2 -> 128^2): both arms finite,
    the verdict line parses, each arm's launches exactly
    ``expected_launches`` over its steps and final samples (reference
    arm: float32, K1-K4; shipping arm: bfloat16)."""
    import os
    from neuron_gan_tpu_torch.tools import precision_ab as pab
    from neuron_gan_tpu_torch.tools import stacked_ab
    argv = AB_ARGV + ['--seed', str(seed + 1),
                      '--out', os.path.join(work, 'stacked_ab')]
    args = pab.make_quality_ab_parser('stacked_ab').parse_args(argv)
    arms = {}
    real_run_arm = pab.run_arm

    def counted(precision_name, dataset, args_, out_dir, device, tag=None,
                **kw):
        reset_counters()
        with graph_replays() as replays:
            out = real_run_arm(precision_name, dataset, args_, out_dir, device,
                               tag=tag, **kw)
        torch.cuda.synchronize()
        want, steps = ab_arm_launches(args, len(dataset), precision_name, kw,
                                      replays)
        arms[tag] = {'launches': read_counters(), 'want': want, 'steps': steps,
                     'graph_replays': dict(replays)}
        return out

    with mock.patch.object(pab, 'run_arm', counted):
        results, text = _quiet(stacked_ab.main, argv)
    lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith('{')]
    verdict = lines[-1]
    out = {'arms': {tag: {**results[tag], **arms[tag]} for tag in results},
           'verdict': verdict}
    failed = [f'{tag} launches' for tag, a in arms.items()
              if a['launches'] != a['want']]
    failed += [f'{tag} SWD' for tag, r in results.items()
               if not np.isfinite(r['swd_mean'])]
    if 'seed_verdict_hint' not in verdict or not set(results) <= set(verdict):
        failed.append('verdict line')
    ref, ship = arms['reference']['launches'], arms['shipping']['launches']
    if not all(any(key.split('/')[0] == 'float32' and n
                   for key, n in ref[k].items())
               for k in ('k1', 'k2', 'k3', 'k4')):
        failed.append('reference arm: not every kernel in float32')
    if any(k.split('/')[0] != 'bfloat16' for c in ship.values() for k in c) \
            or not ship['k1']:
        failed.append('shipping arm: not bfloat16')
    if failed:
        raise AssertionError(f'{failed}: {json.dumps(out)}')
    return out


def check_profilers(torch):
    """``step_profile`` at the shipping path's top phase: a row for every
    stage span of the shipping step, each finite, the gradient penalty's
    kernels' device time above 0; ``op_trace`` at phases 3 and 5: the
    categories sum to the total, and the layout table is not empty."""
    from neuron_gan_tpu_torch.tools import op_trace, step_profile
    rows, _ = _quiet(step_profile.main, ['--reps', '6'])
    stages = {r['span']: r for r in rows[1:]}
    failed = sorted({'step.draws', 'step.augment', 'step.critic_fakes',
                     'step.critic_loss', 'step.grad_penalty',
                     'step.critic_backward', 'step.critic_adam',
                     'step.gen_loss', 'step.gen_backward',
                     'step.gen_adam'} - set(stages))
    failed += [name for name, r in stages.items()
               if not all(np.isfinite(r[k]) for k in (
                   'host_ms', 'idle_ms', 'launches', 'device_ms'))]
    if not stages.get('step.grad_penalty', {}).get('device_ms', 0) > 0:
        failed.append('no kernel of the gradient penalty')
    traces = {}
    for phase in (3, 5):
        tr, _ = _quiet(op_trace.main, ['--phase', str(phase)])
        cats = sum(tr['by_category_ms_per_step'].values())
        if not (tr['total_ms_per_step'] > 0 and abs(
                cats - tr['total_ms_per_step']) <= 1e-9 * cats):
            failed.append(f'op_trace phase {phase}: categories {cats}')
        if not (tr['layout_kernels'] and tr['copies']):
            failed.append(f'op_trace phase {phase}: no layout kernel or copy')
        traces[phase] = {k: tr[k] for k in (
            'resolution', 'wall_ms_per_step', 'total_ms_per_step',
            'by_category_ms_per_step', 'calls_per_step_by_category')}
        traces[phase].update(top=tr['top'][:8],
                             layout_kernels=tr['layout_kernels'][:8],
                             copies=tr['copies'][:6])
    out = {'step_profile': rows, 'op_trace': traces}
    if failed:
        raise AssertionError(f'{failed}: {json.dumps(out)}')
    return out


def check_convert(ckpt, work):
    """``convert_checkpoint`` .npz -> .pth -> .npz on the cli phase's
    checkpoint: everything the reference format carries (G's and D's state
    dicts at the checkpoint's growth: the blocks, the stem and head, the
    current and higher levels' rgb layers) bit for bit."""
    import os
    from neuron_gan_tpu_torch.checkpoint import (
        export_discriminator_state, export_generator_state, load_pytree_npz)
    from neuron_gan_tpu_torch.models import GrowthState, PGConfig
    from neuron_gan_tpu_torch.tools import convert_checkpoint
    pth = os.path.join(work, 'cli.pth')
    back = os.path.join(work, 'cli_round_trip.npz')
    _quiet(convert_checkpoint.main, [ckpt, pth])
    _quiet(convert_checkpoint.main, [pth, back])
    orig, meta = load_pytree_npz(ckpt)
    got, _ = load_pytree_npz(back)
    cfg = PGConfig(n_gen_features=tuple(meta['N_gen_features']),
                   n_dis_features=tuple(meta['N_dis_features']),
                   latent_dim=int(meta['latent_dim']),
                   image_size_init=int(meta['image_size_init']))
    growth = GrowthState(cfg)
    growth.set_resolution(int(meta['image_size']), float(meta['alpha']))
    differ, carried = {}, {}
    for net, export in (('g_params', export_generator_state),
                        ('d_params', export_discriminator_state)):
        want = export(orig['state'][net], cfg, growth)
        have = export(got['state'][net], cfg, growth)
        carried[net] = len(want)
        differ[net] = sorted(set(want) ^ set(have)) + [
            k for k in want if k in have and (
                want[k].shape != have[k].shape
                or want[k].tobytes() != have[k].tobytes())]
    out = {'pth_bytes': os.path.getsize(pth), 'meta': meta,
           'carried_tensors': carried, 'differ': differ}
    if any(differ.values()):
        raise AssertionError(f'round trip differs: {json.dumps(out)}')
    return out


def check_native(seed, work):
    """The native loader built with g++ and taken by the dataset
    (``_stats_impl == 'native'``) on 16 synthetic 512^2 frames: its noise
    statistics against numpy's (thresholds by the numpy DP, then the mean
    and the two-pass std of the selected pixels) within 1e-12, and the
    stack against the numpy path's bit for bit."""
    import os
    from neuron_gan_tpu_torch.data import neuron_dataset as nd
    from neuron_gan_tpu_torch.runtime import build, native
    data = write_dataset(os.path.join(work, 'native_data'), seed)
    t0 = time.perf_counter()
    ds = nd.NeuronDataset(data, image_size=512, seed=seed)
    secs = time.perf_counter() - t0
    with mock.patch.object(native, 'native_available', lambda: False):
        t0 = time.perf_counter()
        ds_np = nd.NeuronDataset(data, image_size=512, seed=seed)
        secs_np = time.perf_counter() - t0
        err = 0.0
        for i, f in enumerate(ds.filenames):
            arr = nd.decode_image(f)
            t = nd.threshold_multiotsu(arr)
            sel = arr[(arr > 0) & (arr < t[0])]
            err = max(err, abs(sel.mean() - ds.images_noise_mean[i]),
                      abs(sel.std() - ds.images_noise_std[i]))
    out = {'stats_impl': ds._stats_impl, 'library': build.library_path().name,
           'max_abs_err': err, 'stack_equal': bool(np.array_equal(
               ds.images, ds_np.images)),
           'build_and_load_seconds': secs, 'numpy_load_seconds': secs_np}
    if not (ds._stats_impl == 'native' and err <= 1e-12 and out['stack_equal']):
        raise AssertionError(f'native loader: {json.dumps(out)}')
    return out


def check_tools(torch, seed, work, cli_ckpt):
    """Phase tools (it opens profiler sessions: after every training
    phase)."""
    t0 = time.perf_counter()
    out = {'phase': 'tools', 'nvidia_smi': nvidia_smi_line(),
           'stacked_ab': check_ab(torch, seed, work)}
    out.update(check_profilers(torch))
    out['convert_checkpoint'] = check_convert(cli_ckpt, work)
    out['native'] = check_native(seed, work)
    out['seconds'] = time.perf_counter() - t0
    return out


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
# the stretch path (the shipping step one level deeper, 1024^2) is held
# to the shipping path's bound
REL_L2_BOUND['stretch'] = REL_L2_BOUND['shipping']


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
    ap.add_argument('--ranks', type=int, default=None,
                    help='run only the dp_nccl phase, over this many cards')
    ap.add_argument('--wide', action='store_true',
                    help='run only the wide K1/K2 phase (C_g 256 and 512)')
    ap.add_argument('--critic-act', action='store_true',
                    help="run only the Karras critic's LeakyReLU phase")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port runs on an NVIDIA GPU',
              file=sys.stderr)
        return 2
    from neuron_gan_tpu_torch.runtime import kernels

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit({'phase': 'env', 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'python': sys.version.split()[0],
          'nvidia_smi': smi, 'device': torch.cuda.get_device_name(0),
          # the host packages the CLIs use where present
          'imports': {m: importlib.util.find_spec(m) is not None
                      for m in ('PIL', 'matplotlib', 'psutil')}})

    t0 = time.perf_counter()
    built = kernels.build()
    emit({'phase': 'build', 'seconds': round(time.perf_counter() - t0, 3),
          'kernels': {n: {'seconds': round(s, 3),
                          'ptxas': [ln.strip() for ln in log.splitlines()
                                    if 'registers' in ln or 'spill' in ln
                                    or 'entry function' in ln]}
                      for n, (s, log) in built.items()}})

    if args.wide or args.critic_act:
        import neuron_gan_tpu_torch.ops.critic_act as ca
        import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn
        emit(check_wide_epilogue(torch, lpn, args.seed) if args.wide
             else check_critic_act(torch, ca, args.seed))
        print(smi, flush=True)
        emit({'ok': True, 'device': {'platform': 'gpu',
                                     'kind': torch.cuda.get_device_name(0),
                                     'count': torch.cuda.device_count()}})
        return 0

    if args.ranks is not None:
        emit(check_dp_nccl(torch, args.seed, args.ranks))
        emit(check_bench_mesh(args.ranks))
        for line in nvidia_smi_lines():
            print(line, flush=True)
        emit({'ok': True, 'device': {'platform': 'gpu',
                                     'kind': torch.cuda.get_device_name(0),
                                     'count': torch.cuda.device_count()}})
        return 0

    import tempfile
    with tempfile.TemporaryDirectory() as work:
        return smoke(torch, args.seed, smi, t_start, work)


def smoke(torch, seed, smi, t_start, work):
    """Every phase but dp_nccl, in order, on one card; ``work`` a scratch
    directory."""
    import neuron_gan_tpu_torch.ops.critic_act as ca
    import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn
    import neuron_gan_tpu_torch.ops.packed_conv_lrelu_pn as pcl

    # the main paths first, then the bench: their steps/s windows run in a
    # process in which the profiler (device_ms) has not run yet
    paths = {name: make() for name, (make, _) in PATHS.items()}
    trained = {}
    for name, cfg in paths.items():
        trained[name] = train(torch, seed, cfg, name)
        emit(trained[name])
    emit(check_bench(torch))
    # the user's entry points, still before any profiler session
    cli = check_cli(torch, seed, work)
    emit(cli)
    emit(check_gp_remat(torch, seed))
    # the other training paths: host streaming, two ranks, legacy WGAN,
    # the 1024^2 EMA run
    stream = check_stream(torch, seed)
    emit(stream)
    dp = check_dp(torch, seed)
    emit(dp)
    tp = check_tp(torch, seed)
    emit(tp)
    emit(check_legacy(torch, seed))
    stretch = check_stretch(torch, seed, work)
    emit(stretch)
    # (it opens a profiler session: after every steps/s window)
    for name in ('shipping', 'packed'):
        emit(check_step_graphs(torch, seed, name))

    epi = check_epilogue_kernels(
        torch, lpn, seed, more_bf16=[(tuple(e['x']), e['case'])
                                     for e in stretch['launches_per_step']
                                     if e['kernel'] == 'k1'])
    emit({'phase': 'kernels', 'pair': 'lrelu_pixel_norm', **epi})
    emit(check_wide_epilogue(torch, lpn, seed))
    emit(check_critic_act(torch, ca, seed))
    conv = check_packed_kernels(torch, pcl, seed)
    emit({'phase': 'kernels', 'pair': 'packed_conv_lrelu_pn', **conv})
    conv16 = check_packed_kernels_bf16(torch, pcl, seed)
    emit({'phase': 'kernels', 'pair': 'packed_conv_lrelu_pn',
          'dtype': 'bfloat16', **conv16})
    dz = check_dz_kernel(torch, pcl, seed)
    emit({'phase': 'kernels', 'kernel': 'packed_dz', **dz})

    emit(check_boundaries(torch, seed, [paths['mixed'], paths['shipping']]))
    raw = torch.from_numpy(np.random.default_rng(seed + 1).random(
        (8, 768, 768, 1)).astype(np.float32)).to('cuda')
    for name, cfg in paths.items():
        emit(parity(torch, seed, cfg,
                    PATHS[name][1](cfg.n_phases - 1), raw, name))
    emit(check_augment(torch, seed))
    emit(check_tools(torch, seed, work, cli['kept_checkpoint']))

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
    # K3's nonzero taps by (N, H, W), the same at every batch
    k3_taps = {tuple(e['x'][1:]): e['nonzero_w'] for e in conv['conv_by_shape']}

    def site_bound_ms(key, dtype, shape, case):
        item = 4 if dtype == 'float32' else 2
        if key in ('k1', 'k2'):
            return epilogue_bound_ms(key, shape, item)
        if key == 'k3':
            return conv_bound(shape, shape[1], k3_taps[shape[1:]], item)[2]
        return dz_bound_ms(shape, item, live=case == 'live')

    step_sites_of = {path: res['launches_per_steady_step']
                     for path, res in trained.items()}
    step_sites_of['stretch'] = stretch['launches_per_step']

    def per_step(path, key, dtype):
        sites = [e for e in step_sites_of[path]
                 if e['kernel'] == key and e['dtype'] == dtype]
        return {'path': path, 'launches': sum(e['n'] for e in sites),
                'bound_ms': sum(e['n'] * site_bound_ms(
                    key, dtype, tuple(e['x']), e['case']) for e in sites)}

    # the streamed run, each rank (shipping path; tp: two steps) and the
    # stretch run (bfloat16)
    other_paths = {'stream': stream['runs']['streamed']['launches'],
                   **{f'dp_{r}': n for r, n in dp['launches'].items()},
                   **{f'tp_{r}': n for r, n in tp['launches'].items()},
                   'stretch': stretch['launches']}

    def row(name, src, replaces, key, dtype, err, ms, plain_ms, bound_ms,
            bound_by, library_ms, **extra):
        counts = by_path[key, dtype]
        extra['launches_other_paths'] = {
            path: total(c[key], dtype) for path, c in other_paths.items()}
        path = 'packed' if dtype == 'float32' else 'mixed'
        steps = [per_step(path, key, dtype)]
        if key in ('k1', 'k2') and dtype == 'float32':
            steps.append(per_step('unpacked', key, dtype))
        if dtype == 'bfloat16':
            steps += [per_step('shipping', key, dtype),
                      per_step('stretch', key, dtype)]
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
