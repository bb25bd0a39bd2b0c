"""Quality A/B harness: two arms of a full 16->128 progressive growth run,
each judged by multi-scale sliced Wasserstein distance (SWD) against the
real set (counterpart of the JAX package's tools/precision_ab.py).

This module's own arms are the float32 matmul precision: 'highest' (true
float32, the exact-decomposition parity path) against 'default' (TF32
allowed; the fused level boundaries and the 2x4 layout), both with float32
activations under the shipping stack's other knobs.  The arm tools of this
package (``mixed_ab``, ``stacked_ab``, ...) run other pairs through
``run_quality_ab``.

    python -m neuron_gan_tpu_torch.tools.precision_ab [--epochs 2500] \\
        [--seed 1] [--out DIR] [--device cpu]

Prints one JSON line per arm and a final verdict line.  Sample grids and
the synthetic dataset land in --out.  One seed sits inside GAN seed noise:
the promotion decision is ``ab_aggregate`` over several seeds
(``run_multiseed_ab``).
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

# The A/B geometry: 4 levels, 16^2 -> 128^2, the 2x2 packed layout from
# 64^2 (the 2x4 one at 16 channels when packed_lanes=128).  A test may
# replace it with a smaller one.
GEOMETRY = dict(n_gen_features=(64, 32, 16, 16),
                n_dis_features=(16, 16, 32, 64),
                latent_dim=64, image_size_init=16, packed_min_res=64)


def make_synthetic_neurons(n=16, res=512, seed=0):
    """Branching-filament images that mimic the dataset's statistics: dark
    noisy background, bright dendritic arbor (random-walk branches from a
    soma), a few bright blobs.  uint8 grayscale; the JAX package's images
    bit for bit (numpy only)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = np.zeros((res, res), np.float32)
        cy, cx = rng.uniform(res * 0.3, res * 0.7, 2)
        # soma
        ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing='ij')
        img += 200 * np.exp(-(((ys - cy) ** 2 + (xs - cx) ** 2)
                              / (2 * (res * 0.01) ** 2)))
        # branches: biased random walks that occasionally fork
        stack = [(cy, cx, rng.uniform(0, 2 * np.pi), int(res * 0.9))]
        while stack:
            y, x, ang, steps = stack.pop()
            for _ in range(steps):
                y += np.sin(ang)
                x += np.cos(ang)
                ang += rng.normal(0, 0.08)
                if not (0 <= y < res and 0 <= x < res):
                    break
                iy, ix = int(y), int(x)
                img[max(iy - 1, 0):iy + 1, max(ix - 1, 0):ix + 1] = \
                    np.maximum(img[max(iy - 1, 0):iy + 1,
                                   max(ix - 1, 0):ix + 1],
                               rng.uniform(120, 220))
                if rng.random() < 0.01:
                    stack.append((y, x, ang + rng.choice([-1, 1])
                                  * rng.uniform(0.4, 1.2),
                                  int(steps * 0.6)))
        # background noise + guaranteed zero pixels for the Otsu fill path
        img += rng.normal(18, 5, (res, res))
        img[:4, :4] = 0
        out.append(img.clip(0, 255).astype(np.uint8))
    return out


def _write_gray_png(path, img):
    try:
        from PIL import Image
    except ImportError:
        from neuron_gan_tpu_torch.utils.png import write_png
        write_png(path, img[..., None])
        return
    Image.fromarray(img, mode='L').save(path)


def build_dataset_dir(path, res, seed=0, n=16):
    """The synthetic set of (res, seed, n) as PNGs in ``path``, rebuilt
    unless the directory already holds that set."""
    os.makedirs(path, exist_ok=True)
    # keyed on the parameters: counting PNGs alone would reuse a stale set
    # across --seed/--res values and collapse the across-seed spread that
    # ab_aggregate calibrates against
    meta_path = os.path.join(path, '.dataset_meta.json')
    key = {'res': res, 'seed': seed, 'n': n}
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            if json.load(fh) == key and len(
                    [f for f in os.listdir(path) if f.endswith('.png')]) == n:
                return
    for f in os.listdir(path):
        if f.endswith('.png'):
            os.remove(os.path.join(path, f))
    for i, img in enumerate(make_synthetic_neurons(n=n, res=res, seed=seed)):
        _write_gray_png(os.path.join(path, f'n{i:02d}.png'), img)
    with open(meta_path, 'w') as fh:
        json.dump(key, fh)


def arm_config(precision_name='default', compute_dtype='float32',
               packed_lanes=None):
    """The A/B geometry's PGConfig for an arm, every kernel on (on the CPU
    the kernels' plain versions run).  'high' is refused by name, as the
    port's config module refuses it."""
    from neuron_gan_tpu_torch.configs.config import precision_of
    from neuron_gan_tpu_torch.models import PGConfig
    return PGConfig(**GEOMETRY, precision=precision_of(precision_name),
                    compute_dtype=compute_dtype, packed_lanes=packed_lanes,
                    use_kernels=True)


def arm_schedule(args):
    """The arms' schedule: checkpointing_period = the whole run, so chunks
    end only at transitions and fade ends."""
    from neuron_gan_tpu_torch.schedule import TrainSchedule
    return TrainSchedule(transit_sch=tuple(args.transits),
                         alpha_step=args.alpha_step, n_epochs=args.epochs,
                         checkpointing_period=args.epochs, lr0=1e-4)


def run_arm(precision_name, dataset, args, out_dir, device, fast_augment=False,
            tag=None, compute_dtype='float32', gp_reuse_fakes=False,
            shear_warp=False, packed_lanes=None):
    """Train one arm from --seed over the whole schedule; returns (n_fake
    samples at the top resolution, NCHW on ``device``, training seconds)."""
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    from neuron_gan_tpu_torch.runtime import precision_scope
    from neuron_gan_tpu_torch.train_step import (
        ChunkSpec, init_train_state, make_epoch_runner, spec_for_chunk)
    from neuron_gan_tpu_torch.utils.latents import sample_latent_vec
    from neuron_gan_tpu_torch.utils.plotting import save_image_grid

    cfg = arm_config(precision_name, compute_dtype, packed_lanes)
    sched = arm_schedule(args)
    init = torch.Generator().manual_seed(args.seed)
    state = init_train_state(GeneratorPG(cfg, init, device=device),
                             DiscriminatorPG(cfg, init, device=device))
    images = torch.from_numpy(np.asarray(dataset.images)).to(device)
    rng = torch.Generator(device=device).manual_seed(args.seed + 977)
    base = ChunkSpec(
        phase=0, fading=False, n_critic=1, batch_size=8,
        n_images=len(dataset), shuffle=True,
        crop_size=dataset.image_size_max, translation=0.05, augment=True,
        gp_lambda=10.0, drift_epsilon=0.001, sim_lambda0=0.0, sim_decay=0.0,
        beta1=0.5, rmsprop=False, lr0=1e-4, lr_gamma=1.0, lr_boundary=0,
        lr_cap=1, alpha_start=0, alpha_step=args.alpha_step,
        latent_dim=cfg.latent_dim, fast_augment=fast_augment,
        gp_reuse_fakes=gp_reuse_fakes, shear_warp=shear_warp)

    t0 = time.perf_counter()
    for start, end in sched.plan_chunks(1, args.epochs + 1):
        spec = spec_for_chunk(sched, start, base)
        stats = make_epoch_runner(cfg, spec, end - start + 1)(
            state, images, rng, start).cpu().numpy()
        if not np.isfinite(stats).all():
            raise FloatingPointError(f'non-finite stats at epochs {start}-{end}')
        print(f'[{tag or precision_name}] epochs {start}-{end} phase '
              f'{spec.phase} fade={spec.fading} D={stats[-1, 2]:+.3f} '
              f'G={stats[-1, 3]:+.3f}', flush=True)
    train_s = time.perf_counter() - t0

    z = sample_latent_vec(torch.Generator(device=device).manual_seed(7),
                          (args.n_fake, cfg.latent_dim))
    with torch.no_grad(), precision_scope(cfg.precision):
        fake = state.g(z, cfg.n_phases - 1).float()
    save_image_grid(fake[:16].permute(0, 2, 3, 1).cpu().numpy(),
                    os.path.join(out_dir, f'samples_{tag or precision_name}'
                                          f'_s{args.seed}.png'))
    return fake, train_s


def make_quality_ab_parser(name):
    """Shared CLI of the two-arm quality A/B tools; --out defaults to
    ``name`` in the temporary directory."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--epochs', type=int, default=2500)
    ap.add_argument('--transits', type=int, nargs='*', default=[500, 1000, 1500])
    ap.add_argument('--alpha_step', type=float, default=0.0025)
    ap.add_argument('--res', type=int, default=128)
    ap.add_argument('--seed', type=int, default=1)
    ap.add_argument('--n_fake', type=int, default=64)
    ap.add_argument('--out', type=str,
                    default=os.path.join(tempfile.gettempdir(), name))
    ap.add_argument('--device', type=str, default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    return ap


def run_quality_ab(args, arms, verdict_ok, verdict_worse):
    """Shared body of the two-arm quality A/B tools: build the synthetic
    dataset, train each arm with ``run_arm``, score it against the real
    set (crop and renormalisation, no augmentation) by multi-scale SWD, and
    print one JSON line per arm and a verdict line comparing the second
    arm to the first at the 1.15x bar.  ``arms`` = [(tag, run_arm
    kwargs), (tag, run_arm kwargs)].  Returns {tag: result}."""
    from neuron_gan_tpu_torch.data.augment import AugmentSpec, augment_batch
    from neuron_gan_tpu_torch.data.neuron_dataset import NeuronDataset
    from neuron_gan_tpu_torch.metrics import swd_multiscale
    from neuron_gan_tpu_torch.runtime import resolve_device

    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'
    os.makedirs(args.out, exist_ok=True)
    ds_dir = os.path.join(args.out, 'dataset')
    build_dataset_dir(ds_dir, args.res, seed=args.seed)
    dataset = NeuronDataset(ds_dir, image_size=args.res, seed=args.seed)
    real = augment_batch(torch.from_numpy(np.asarray(dataset.images)).to(device),
                         None, AugmentSpec(crop_size=args.res, out_size=args.res,
                                           translation=0.0, augment=False))

    results = {}
    for tag, kw in arms:
        # the shipping defaults (fast augmentation, shear 'auto', 'mixed',
        # GP-fake reuse, the 2x4 layout), which an arm may override, the
        # matmul precision too ('precision_name').  The 2x4 interior gates
        # on packed_lanes alone, so an exact arm pins packed_lanes=None
        # itself (stacked_ab and lanes_ab do)
        kw = {'fast_augment': True, 'shear_warp': 'auto',
              'compute_dtype': 'mixed', 'gp_reuse_fakes': True,
              'packed_lanes': 128, **kw}
        precision_name = kw.pop('precision_name', 'default')
        fake, train_s = run_arm(precision_name, dataset, args, args.out,
                                device, tag=tag, **kw)
        levels, mean = swd_multiscale(
            real, fake, torch.Generator(device=device).manual_seed(123),
            n_patches=2048, n_repeats=8)
        results[tag] = {'swd_mean': mean,
                        'swd_levels': [float(v) for v in levels],
                        'train_seconds': train_s,
                        'device': name}
        print(json.dumps({'arm': tag, **results[tag]}), flush=True)

    (base_tag, _), (cand_tag, _) = arms
    d_b = results[base_tag]['swd_mean']
    d_c = results[cand_tag]['swd_mean']
    print(json.dumps({
        # one seed's ratio sits inside GAN seed noise: the promotion
        # decision is ab_aggregate over several seeds
        'seed_verdict_hint': verdict_ok if d_c <= 1.15 * d_b else verdict_worse,
        base_tag: d_b, cand_tag: d_c,
        'speedup': (results[base_tag]['train_seconds']
                    / results[cand_tag]['train_seconds'])}), flush=True)
    return results


def main(argv=None):
    # the matmul-precision knob under the shipping stack's semantics (fast
    # augment, shear 'auto', GP-fake reuse on both arms) with float32
    # activations on both arms; the 'highest' arm is the exact
    # decomposition path (packed_lanes=None)
    args = make_quality_ab_parser('precision_ab').parse_args(argv)
    return run_quality_ab(
        args,
        arms=[('highest', {'precision_name': 'highest',
                           'compute_dtype': 'float32',
                           'packed_lanes': None}),
              ('default', {'precision_name': 'default',
                           'compute_dtype': 'float32'})],
        verdict_ok='default_ok', verdict_worse='default_worse')


if __name__ == '__main__':
    main()
