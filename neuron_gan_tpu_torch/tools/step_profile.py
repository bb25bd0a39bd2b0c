"""Stage-by-stage timing of one flagship training step (counterpart of the
JAX package's tools/step_profile.py).

    python -m neuron_gan_tpu_torch.tools.step_profile [--path shipping] \\
        [--phase 5] [--reps 20] [--device cpu]

Times each stage of one step of a ``flagship.PATHS`` configuration (default
the shipping step) at ``--phase`` (default the top) as its own loop of
``--reps`` calls: the augmentation, D's forward, G's forward, the critic
update without the gradient penalty and with it (the GP on fresh fakes,
or on the critic loss's under the spec's ``gp_reuse_fakes``), and the
generator update.
Each call's output feeds a scalar that is read back after the loop, so no
stage is skipped.  Prints a header line and one JSON line per stage: the
wall ms a call (CUDA events around the loop, one synchronize; on the CPU
the host clock) and the device ms a call (the kernels' own durations over
a second loop, by ``profile_step.py``'s torch.profiler capture; "not
measured" on the CPU).
"""

import argparse
import json
import time

import numpy as np
import torch


def parse_args(argv=None):
    from neuron_gan_tpu_torch.flagship import PATHS
    ap = argparse.ArgumentParser()
    ap.add_argument('--path', choices=sorted(PATHS), default='shipping')
    ap.add_argument('--phase', type=int, default=None)
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--device', type=str, default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    return ap.parse_args(argv)


def stages(cfg, spec, device, seed=0):
    """{stage: fn}, each fn one call of the stage returning a scalar
    tensor, on a state from random weights (``seed``) and random inputs:
    the raw padded batch for the augmentation, images at the phase's
    resolution for the rest."""
    from neuron_gan_tpu_torch.data.augment import augment_batch, draw_augment
    from neuron_gan_tpu_torch.losses import d_grad_pen_loss, d_w_loss, g_w_loss
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    from neuron_gan_tpu_torch.train_step import (
        _augment_spec, _grads_into, _set_lr, init_train_state)
    from neuron_gan_tpu_torch.utils.latents import sample_latent_vec

    init = torch.Generator().manual_seed(seed)
    state = init_train_state(GeneratorPG(cfg, init, device=device),
                             DiscriminatorPG(cfg, init, device=device),
                             spec.beta1)
    _set_lr(state.d_opt, spec.lr0)
    _set_lr(state.g_opt, spec.lr0)
    b, res = spec.batch_size, cfg.resolution(spec.phase)
    pad = spec.crop_size + spec.crop_size // 2      # the loader's padded frame
    gen = np.random.default_rng(seed)
    raw = torch.from_numpy(gen.random((b, pad, pad, 1)).astype(np.float32)).to(device)
    imgs = torch.from_numpy(gen.random((b, 1, res, res)).astype(np.float32)
                            * 2 - 1).to(device)
    aug_spec = _augment_spec(cfg, spec)
    rng = torch.Generator(device=device).manual_seed(seed + 1)
    d_params, g_params = list(state.d.parameters()), list(state.g.parameters())

    def g_apply(z):
        return state.g(z, spec.phase)

    def d_apply(x):
        return state.d(x, spec.phase)

    def z():
        return sample_latent_vec(rng, (b, spec.latent_dim))

    def augment():
        return augment_batch(raw, draw_augment(rng, b, pad, aug_spec),
                             aug_spec).sum()

    def d_forward():
        # a perturbed input, so no call can reuse another's result
        with torch.no_grad():
            return d_apply(imgs + torch.rand((), generator=rng, device=device)
                           * 1e-6).float().sum()

    def g_forward():
        with torch.no_grad():
            return g_apply(z()).float().sum()

    def critic_update(with_gp):
        # the GP's fakes as the step draws them: fresh, or the critic
        # loss's under spec.gp_reuse_fakes
        z1, z2 = z(), z()
        eps = torch.rand(b, generator=rng, device=device)
        with torch.no_grad():
            fake = g_apply(z1)
        loss, _ = d_w_loss(d_apply, imgs, fake, spec.drift_epsilon)
        if with_gp:
            if not spec.gp_reuse_fakes:
                with torch.no_grad():
                    fake = g_apply(z2)
            loss = loss + d_grad_pen_loss(d_apply, imgs, fake, eps,
                                          spec.gp_lambda)
        _grads_into(loss, d_params)
        state.d_opt.step()
        return loss.detach()

    def gen_update():
        loss, _ = g_w_loss(g_apply, d_apply, z())
        _grads_into(loss, g_params)
        state.g_opt.step()
        return loss.detach()

    return {f'augment{"_fast" if spec.fast_augment else ""}': augment,
            'd_forward': d_forward, 'g_forward': g_forward,
            'critic_update_no_gp': lambda: critic_update(False),
            'critic_update_with_gp': lambda: critic_update(True),
            'gen_update': gen_update}


def stage_device_ms(fn, reps):
    """Device ms a call of ``fn`` over a loop of ``reps`` calls: the
    summed durations of the kernels it launches, as torch.profiler reads
    them (``profile_step.py``'s capture; a stage's data stays in the L2
    cache between its own kernels, as in a training loop)."""
    from neuron_gan_tpu_torch.profile_step import _device_us, _trace
    prof, _ = _trace(lambda: [fn() for _ in range(reps)], record_shapes=False)
    us = sum(_device_us(e) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError('torch.profiler saw no kernel of the stage')
    return us / reps / 1e3


def time_stage(fn, reps, cuda):
    """(wall ms a call, device ms a call or None, the read-back scalar)."""
    acc = fn().float()                      # warm-up call
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        acc = acc + fn().float()
    if cuda:
        end.record()
    value = acc.item()
    wall_ms = (start.elapsed_time(end) if cuda
               else (time.perf_counter() - t0) * 1e3) / reps
    dev_ms = stage_device_ms(fn, reps) if cuda else None
    return wall_ms, dev_ms, value


def run(args):
    """One dict a stage (and the header first)."""
    from neuron_gan_tpu_torch.flagship import PATHS
    from neuron_gan_tpu_torch.runtime import precision_scope, resolve_device
    from neuron_gan_tpu_torch.runtime.timing import nvidia_smi_line

    device = resolve_device(args.device)
    cuda = device.type == 'cuda'
    make, chunk_spec = PATHS[args.path]
    cfg = make()
    spec = chunk_spec(cfg.n_phases - 1 if args.phase is None else args.phase)
    out = [{'path': args.path, 'phase': spec.phase,
            'resolution': cfg.resolution(spec.phase),
            'batch': spec.batch_size, 'reps': args.reps,
            'device': torch.cuda.get_device_name(device) if cuda else 'cpu',
            'nvidia_smi': nvidia_smi_line() if cuda else None}]
    with precision_scope(cfg.precision):
        for name, fn in stages(cfg, spec, device).items():
            wall_ms, dev_ms, value = time_stage(fn, args.reps, cuda)
            out.append({'stage': name, 'wall_ms': wall_ms,
                        'device_ms': dev_ms if cuda else 'not measured',
                        'value': value})
    return out


def main(argv=None):
    out = run(parse_args(argv))
    for line in out:
        print(json.dumps(line), flush=True)
    return out


if __name__ == '__main__':
    main()
