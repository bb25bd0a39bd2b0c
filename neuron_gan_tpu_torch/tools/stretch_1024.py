"""1024^2 training with an EMA shadow generator (counterpart of the JAX
package's tools/stretch_1024.py).

The shipping step (``flagship.flagship_shipping_config``) one growth level
deeper: 7 levels 16^2 -> 1024^2, G features (128, 64, 32, 32, 16, 16, 8),
D (8, 16, 16, 32, 32, 64, 128); the 1024^2 level runs in the 2x4 layout at
8 channels, its epilogues in the kernel pair at 8 groups of 8.  Trains a
warm-up chunk of --epochs epochs at the top phase on a seeded padded stack
(8, 1536, 1536, 1), then a timed chunk that continues from it; checks the
stats finite and that the EMA shadow moved, but less than the raw generator;
saves the train state (g_ema included) as a JAX-format ``.npz``, reloads it
and renders the -ema grid.  Prints one JSON line with the steps/s and the
card's name and power limit.

    python -m neuron_gan_tpu_torch.tools.stretch_1024 [--epochs 6] \\
        [--out DIR] [--device cpu]
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

# the JAX tool's growth, one level deeper than the flagship; a test may
# replace it with a smaller one
GEOMETRY = dict(n_gen_features=(128, 64, 32, 32, 16, 16, 8),
                n_dis_features=(8, 16, 16, 32, 32, 64, 128))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--epochs', type=int, default=6)
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--ema_beta', type=float, default=0.999)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--out', type=str,
                    default=os.path.join(tempfile.gettempdir(), 'stretch1024'))
    ap.add_argument('--device', type=str, default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    return ap.parse_args(argv)


def stretch_config(batch=4, ema_beta=0.999):
    """(PGConfig, ChunkSpec of the top phase): the shipping configuration
    and chunk spec at GEOMETRY, the crop the top resolution, 2 batches an
    epoch."""
    from neuron_gan_tpu_torch.flagship import (
        flagship_shipping_chunk_spec, flagship_shipping_config)
    cfg = flagship_shipping_config(**GEOMETRY)
    spec = flagship_shipping_chunk_spec(
        cfg.n_phases - 1, batch_size=batch, n_images=2 * batch,
        crop_size=cfg.image_size_max, lr_gamma=0.9998, lr_cap=1000,
        ema_beta=ema_beta, latent_dim=cfg.latent_dim)
    return cfg, spec


def padded_stack(cfg, n_images, seed, device):
    """A seeded stack padded like the loader's: top + 2 * top // 4."""
    side = cfg.image_size_max + cfg.image_size_max // 2
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((n_images, side, side, 1))
                            .astype(np.float32)).to(device)


def _max_abs_diff(a, b):
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def run(args):
    """The tool's body: returns (the JSON result, the train state)."""
    from neuron_gan_tpu_torch.checkpoint import load_pytree_npz, save_pytree_npz
    from neuron_gan_tpu_torch.convert import load_jax_tree, to_jax_state
    from neuron_gan_tpu_torch.models import (
        DiscriminatorPG, GeneratorPG, GrowthState)
    from neuron_gan_tpu_torch.runtime import resolve_device
    from neuron_gan_tpu_torch.runtime.timing import nvidia_smi_line
    from neuron_gan_tpu_torch.train_step import (
        init_train_state, make_epoch_runner)
    from neuron_gan_tpu_torch.utils.plotting import plot_gen_samples

    device = resolve_device(args.device)
    cuda = device.type == 'cuda'
    os.makedirs(args.out, exist_ok=True)
    cfg, spec = stretch_config(args.batch, args.ema_beta)
    top, res = cfg.n_phases - 1, cfg.image_size_max
    init = torch.Generator().manual_seed(args.seed)
    state = init_train_state(GeneratorPG(cfg, init, device=device),
                             DiscriminatorPG(cfg, init, device=device),
                             ema_beta=args.ema_beta)
    g_old = [p.detach().clone() for p in state.g.parameters()]
    images = padded_stack(cfg, spec.n_images, args.seed, device)
    rng = torch.Generator(device=device).manual_seed(args.seed + 1)
    runner = make_epoch_runner(cfg, spec, args.epochs)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    print(f'warm-up chunk at {res}^2 ...', flush=True)
    stats = runner(state, images, rng, 1).cpu().numpy()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = np.concatenate(
        [stats, runner(state, images, rng, 1 + args.epochs).cpu().numpy()])
    dt = time.perf_counter() - t0
    if not np.isfinite(stats).all():
        raise FloatingPointError(f'non-finite stats: {stats}')
    steps = args.epochs * spec.n_full_batches

    # the shadow moved, less than the raw generator
    d_raw = _max_abs_diff(list(state.g.parameters()), g_old)
    d_ema = _max_abs_diff(list(state.g_ema.parameters()), g_old)
    if not 0 < d_ema < d_raw:
        raise AssertionError(f'EMA check failed: d_ema {d_ema}, d_raw {d_raw}')

    # the train state with g_ema as a JAX-format .npz, reloaded, and the
    # -ema grid from the reloaded shadow
    ckpt = os.path.join(args.out, 'GenDisc_s1k.npz')
    meta = {'epoch': 2 * args.epochs, 'image_size': res, 'alpha': 1.0,
            'phase': top, 'image_size_init': cfg.image_size_init,
            'N_gen_features': list(cfg.n_gen_features),
            'N_dis_features': list(cfg.n_dis_features),
            'latent_dim': cfg.latent_dim}
    save_pytree_npz(ckpt, to_jax_state(state), meta)
    tree, _ = load_pytree_npz(ckpt)
    g_ema = GeneratorPG(cfg, torch.Generator().manual_seed(0), device=device)
    load_jax_tree(g_ema, tree['g_ema'])
    if _max_abs_diff(list(g_ema.parameters()),
                     list(state.g_ema.parameters())) != 0:
        raise AssertionError('g_ema did not survive the .npz round trip')
    grid_path = os.path.join(args.out, 'ema_grid.png')
    samples = plot_gen_samples(g_ema, GrowthState(cfg, phase=top, alpha=1.0),
                               n_images=4, seed=0, filename=grid_path)
    if not np.isfinite(samples).all():
        raise FloatingPointError('non-finite -ema samples')

    result = {
        'metric': 'wgan_gp_train_steps_per_sec_1024_ema',
        'value': steps / dt,
        'unit': f'steps/sec (G+D, batch {args.batch}, {res}^2, EMA shadow, '
                'incl. on-device aug)',
        'steps': steps, 'seconds': dt, 'resolution': res,
        'ema_grid': grid_path, 'checkpoint': ckpt,
        'd_ema_vs_d_raw': [d_ema, d_raw],
        'stats_mean': stats.mean(axis=0).tolist(),
        'peak_mem_gib': (torch.cuda.max_memory_allocated() / 2 ** 30
                         if cuda else None),
        'device': torch.cuda.get_device_name(device) if cuda else 'cpu',
        'nvidia_smi': nvidia_smi_line() if cuda else None,
    }
    return result, state


def main(argv=None):
    result, _ = run(parse_args(argv))
    print(json.dumps(result), flush=True)
    return result


if __name__ == '__main__':
    main()
