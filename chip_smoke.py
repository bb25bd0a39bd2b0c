#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (neuron_gan_tpu_torch) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. env      torch/CUDA versions and the card (nvidia-smi name, power limit);
2. build    every CUDA kernel of the port, built from csrc/ with nvcc;
3. kernels  each kernel against its plain PyTorch version on the card, at
            every shape the training path gives it (plus 4 groups and
            bfloat16), forward, backward and a GP-style second order; the
            kernel's and the plain version's times at the largest shape;
4. train    the port's main path: flagship-width PGGAN (16^2 .. 512^2,
            random weights from --seed) trained with WGAN-GP + drift through
            the epoch runner under a schedule that visits every phase and
            fade-in and ends at steady 512^2; stats must be finite and the
            kernels' launch counters must rise by exactly the count the path
            implies; then steps/s over steady 512^2 steps;
5. parity   one 512^2 batch step with the kernels, with the plain composed
            ops, and with the plain ops in float64, same parameters and
            draws, TF32 off: the stats and G's gradients must agree
            elementwise (rtol 1e-4, atol 1e-5), and each network's
            gradient within ``REL_L2_BOUND`` of the plain path and of
            float64; two planted faults in the epilogue must fail that
            bound (see ``parity``).

Then the kernel table (one JSON line), the card's nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero without that line; without CUDA it exits 2 at once.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np


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

# every LReLU + PixelNorm epilogue shape of the flagship path at batch 8:
# G blocks (C, R) and D blocks (C, R)
G_SHAPES = [(64, 32), (32, 64), (32, 128), (16, 256), (16, 512)]
D_SHAPES = [(16, 256), (32, 128), (32, 64), (64, 32), (128, 16)]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(torch, lpn, seed):
    gen = torch.Generator(device='cuda').manual_seed(seed)
    dev = 'cuda'
    err = {'fwd': 0.0, 'bwd': 0.0}
    checked = []

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(shape, n_groups, dtype, tol_f, tol_b):
        x, g = randn(shape, dtype), randn(shape, dtype)
        out = lpn._fwd(x, n_groups, 0.2, 1e-8)
        dx = lpn._bwd(x, g, n_groups, 0.2, 1e-8)
        torch.cuda.synchronize()
        ref = lpn.lrelu_pixel_norm_plain(x, n_groups)
        ref_dx = lpn.lrelu_pixel_norm_bwd_plain(x, g, n_groups)
        assert out.dtype == dtype and dx.dtype == dtype
        torch.testing.assert_close(out, ref, **tol_f)
        torch.testing.assert_close(dx, ref_dx, **tol_b)
        if dtype == torch.float32:
            err['fwd'] = max(err['fwd'], (out - ref).abs().max().item())
            err['bwd'] = max(err['bwd'], (dx - ref_dx).abs().max().item())
        checked.append({'shape': list(shape), 'n_groups': n_groups,
                        'dtype': str(dtype).replace('torch.', '')})

    f32_f = dict(rtol=1e-5, atol=1e-6)
    f32_b = dict(rtol=1e-4, atol=1e-5)
    bf16 = dict(rtol=2e-2, atol=2e-2)
    for c, r in G_SHAPES + D_SHAPES:
        check((8, c, r, r), 1, torch.float32, f32_f, f32_b)
    check((8, 64, 32, 32), 4, torch.float32, f32_f, f32_b)
    check((8, 64, 16, 16), 8, torch.float32, f32_f, f32_b)
    check((3, 16, 5, 7), 1, torch.float32, f32_f, f32_b)     # ragged tail
    check((8, 16, 256, 256), 1, torch.bfloat16, bf16, bf16)
    check((8, 64, 32, 32), 4, torch.bfloat16, bf16, bf16)

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

    # times at the largest shape of the path, (8, 16, 512, 512) float32
    shape = (8, 16, 512, 512)
    x, g = randn(shape), randn(shape)
    numel = x.numel()
    times = {
        'fwd_ms': cuda_ms(lambda: lpn._fwd(x, 1, 0.2, 1e-8)),
        'fwd_plain_ms': cuda_ms(lambda: lpn.lrelu_pixel_norm_plain(x)),
        'bwd_ms': cuda_ms(lambda: lpn._bwd(x, g, 1, 0.2, 1e-8)),
        'bwd_plain_ms': cuda_ms(lambda: lpn.lrelu_pixel_norm_bwd_plain(x, g)),
    }
    # least time: each input read once, each output written once (bytes),
    # against about 6 (fwd) and 12 (bwd) float32 operations per element
    bounds = {
        'fwd': max(2 * numel * 4 / HBM_BYTES_PER_S, 6 * numel / F32_OPS_PER_S),
        'bwd': max(3 * numel * 4 / HBM_BYTES_PER_S, 12 * numel / F32_OPS_PER_S),
    }
    return err, checked, times, bounds, shape


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def expected_launches(phases_per_step):
    """K1/K2 launches of batch steps at these phases: per step, 2*phase
    epilogues per G or D forward; 7 forwards and 6 backwards (the GP's
    inner and outer passes included), as tests/test_torch_train_step.py
    counts on the CPU."""
    return (sum(14 * p for p in phases_per_step),
            sum(12 * p for p in phases_per_step))


def train(torch, seed):
    from neuron_gan_tpu_torch.flagship import flagship_chunk_spec, flagship_config
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    from neuron_gan_tpu_torch.schedule import TrainSchedule
    from neuron_gan_tpu_torch.train_step import (
        init_train_state, make_epoch_runner, spec_for_chunk)
    import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn

    cfg = flagship_config()
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
    base = flagship_chunk_spec(0)
    steps_per_epoch = base.n_images // base.batch_size
    n_timed_epochs = 5

    lpn.fwd_launches = lpn.bwd_launches = 0
    chunks, step_phases = [], []
    t_run = time.perf_counter()
    for start, end in sched.plan_chunks(1, sched.n_epochs + 1):
        spec = spec_for_chunk(sched, start, base)
        t0 = time.perf_counter()
        stats = make_epoch_runner(cfg, spec, end - start + 1)(
            state, images, rng, start)
        stats = stats.cpu().numpy()
        assert np.isfinite(stats).all(), (start, stats)
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = run(state, images, rng, sched.n_epochs + 1).cpu().numpy()
    dt = time.perf_counter() - t0
    assert np.isfinite(stats).all(), stats
    step_phases += [spec.phase] * steps_per_epoch * n_timed_epochs

    launches = {'fwd': lpn.fwd_launches, 'bwd': lpn.bwd_launches}
    want = expected_launches(step_phases)
    assert (launches['fwd'], launches['bwd']) == want, (launches, want)

    with torch.no_grad():
        z = torch.randn(8, cfg.latent_dim, generator=rng, device='cuda')
        img = state.g(z / z.norm(dim=1, keepdim=True), cfg.n_phases - 1)
    assert img.shape == (8, 1, 512, 512) and torch.isfinite(img).all()
    assert img.abs().max().item() <= 1.0
    return {
        'phase': 'train', 'chunks': chunks, 'steps': len(step_phases),
        'schedule_seconds': round(schedule_s, 3),
        'steady_512_steps': steps_per_epoch * n_timed_epochs,
        'steady_512_steps_per_s': steps_per_epoch * n_timed_epochs / dt,
        'steady_512_stats': stats.mean(axis=0).tolist(),
        'launches': launches,
        'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
    }


# ---------------------------------------------------------------------------
# phase 5: kernel path against the plain path on one 512^2 step
# ---------------------------------------------------------------------------

# how far each network's gradient, as one vector, may lie from the plain
# path's and from the float64 reference's, by relative L2 error: about 3x
# the larger of the kernel path's and the float32 plain path's readings at
# 512^2 on an H100 (PERF.md)
REL_L2_BOUND = {'D': 2e-3, 'G': 3e-3}


def parity(torch, seed, cfg_k, spec, raw):
    """Kernel path against plain path on one batch step (512^2 on the card).

    Runs of the step on ``raw`` with the same parameters and draws, TF32
    off: the kernel path; the plain path (composed ops); the plain path in
    float64, the reference; and the kernel path with one of two planted
    faults -- the epilogue's second order zeroed (``LReluPixelNormBwd``'s
    backward returns zeros), or the epilogue run in bfloat16.  The learning
    rate is 0, so every run's generator gradients are taken against the
    same critic.

    Held: the stats and G's gradients elementwise at rtol 1e-4 / atol 1e-5
    against the plain path; each network's gradient within
    ``REL_L2_BOUND`` of the plain path and of float64; and each faulty run
    outside that bound.  D's gradients are held only as one vector: at
    512^2 a few hundred of their elements move beyond the elementwise
    tolerance under a rounding change in the epilogue (the counts are
    reported)."""
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    from neuron_gan_tpu_torch.train_step import (
        draw_batch, init_train_state, make_batch_step)
    import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn

    dev = raw.device
    cfg_p = dataclasses.replace(cfg_k, use_kernels=False)
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

    runs = {'kernel': one_step(cfg_k), 'plain': one_step(cfg_p),
            'float64': one_step(cfg_p, torch.float64)}

    def no_second_order(ctx, ct):
        x, g = ctx.saved_tensors
        return torch.zeros_like(x), torch.zeros_like(g), None, None, None

    fwd, bwd = lpn._fwd, lpn._bwd
    faults = {
        'no_second_order': [mock.patch.object(
            lpn.LReluPixelNormBwd, 'backward', staticmethod(no_second_order))],
        'bf16_epilogue': [
            mock.patch.object(lpn, '_fwd', lambda x, *a: fwd(
                x.bfloat16(), *a).float()),
            mock.patch.object(lpn, '_bwd', lambda x, g, *a: bwd(
                x.bfloat16(), g.bfloat16(), *a).float())],
    }
    for name, patches in faults.items():
        for p in patches:
            p.start()
        try:
            runs[name] = one_step(cfg_k)
        finally:
            for p in patches:
                p.stop()

    def rel_l2(xs, ys):
        num = sum(((x - y) ** 2).sum() for x, y in zip(xs, ys))
        den = sum((y ** 2).sum() for y in ys)
        return (num / den).sqrt().item()

    def n_outside(xs, ys):
        return sum(int((~torch.isclose(x, y, rtol=1e-4, atol=1e-5)).sum())
                   for x, y in zip(xs, ys))

    dist = {}
    for run in ('kernel', 'plain', *faults):
        for ref in ('plain', 'float64'):
            if run != ref:
                dist[f'{run}~{ref}'] = {
                    'D': rel_l2(runs[run][0], runs[ref][0]),
                    'G': rel_l2(runs[run][1], runs[ref][1]),
                    'D_outside_tol': n_outside(runs[run][0], runs[ref][0])}

    def within_bound(run):
        return all(dist[f'{run}~{ref}'][net] <= bound
                   for ref in ('plain', 'float64')
                   for net, bound in REL_L2_BOUND.items())

    (dk, gk, sk), (dp, gp, sp) = runs['kernel'], runs['plain']
    torch.testing.assert_close(sk, sp, rtol=1e-4, atol=1e-5)
    for x, y in zip(gk, gp):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)
    assert within_bound('kernel'), dist
    for name in faults:
        assert not within_bound(name), (name, dist)
    return {'phase': 'parity', 'resolution': cfg_k.resolution(spec.phase),
            'leaves': len(dk) + len(gk),
            'D_elements': sum(x.numel() for x in dk),
            'rel_l2_bound': REL_L2_BOUND, 'grad_rel_l2': dist,
            'stats_kernel': sk.tolist(), 'stats_plain': sp.tolist()}


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

    smi = nvidia_smi_line()
    emit({'phase': 'env', 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'python': sys.version.split()[0],
          'nvidia_smi': smi, 'device': torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    built = kernels.build()
    emit({'phase': 'build', 'seconds': round(time.perf_counter() - t0, 3),
          'kernels': {n: {'seconds': round(s, 3),
                          'ptxas': [ln for ln in log.splitlines()
                                    if 'registers' in ln or 'spill' in ln]}
                      for n, (s, log) in built.items()}})

    err, checked, times, bounds, shape = check_kernels(torch, lpn, args.seed)
    emit({'phase': 'kernels', 'checked': checked, 'max_abs_err': err,
          'timed_shape': list(shape), **times})

    result = train(torch, args.seed)
    emit(result)
    from neuron_gan_tpu_torch.flagship import flagship_chunk_spec, flagship_config
    cfg = flagship_config()
    raw = torch.from_numpy(np.random.default_rng(args.seed + 1).random(
        (8, 768, 768, 1)).astype(np.float32)).to('cuda')
    emit(parity(torch, args.seed, cfg, flagship_chunk_spec(cfg.n_phases - 1),
                raw))

    src = 'neuron_gan_tpu_torch/csrc/lrelu_pixel_norm.cu'
    emit({'kernels': [
        {'name': 'lrelu_pixel_norm_fwd', 'route': 'cuda', 'source': src,
         'replaces': 'neuron_gan_tpu/ops/pallas_kernels.py:65',
         'launches': result['launches']['fwd'], 'max_abs_err': err['fwd'],
         'ms': times['fwd_ms'], 'plain_ms': times['fwd_plain_ms'],
         'bound_ms': bounds['fwd'] * 1e3, 'bound_by': 'bytes',
         'library_ms': None},
        {'name': 'lrelu_pixel_norm_bwd', 'route': 'cuda', 'source': src,
         'replaces': 'neuron_gan_tpu/ops/pallas_kernels.py:78',
         'launches': result['launches']['bwd'], 'max_abs_err': err['bwd'],
         'ms': times['bwd_ms'], 'plain_ms': times['bwd_plain_ms'],
         'bound_ms': bounds['bwd'] * 1e3, 'bound_by': 'bytes',
         'library_ms': None},
    ]})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
