"""Evaluation CLI of the port — the JAX package's eval.py interface.

    python -m neuron_gan_tpu_torch.eval -n 20 -weights gen_dis_default.pth \
        -output samples.png [-ema] [-fast] [-swd] [-dataset_dir D] [--device cpu]

Loads generator weights (a reference ``.pth`` or a native ``.npz``, the
architecture read from the file) and saves an n-sample grid.  ``-fast``
runs the generator at precision=None (TF32 allowed, fused level
boundaries) in the packed layouts (``packed_lanes=128``,
``packed_min_res=max(64, 2 * init)``); the kernels follow the
``use_kernels`` knob (on by default).  ``-swd`` scores seed-0 samples at
the generator's native resolution against the real set and prints one
JSON line.  Runs on the card unless ``--device cpu``.
"""

import argparse
import dataclasses
import json
import os
import sys

import torch

from neuron_gan_tpu_torch.checkpoint import (
    import_reference_checkpoint, load_pytree_npz)
from neuron_gan_tpu_torch.configs import config
from neuron_gan_tpu_torch.convert import load_jax_tree
from neuron_gan_tpu_torch.data.augment import AugmentSpec, augment_batch
from neuron_gan_tpu_torch.data.neuron_dataset import NeuronDataset
from neuron_gan_tpu_torch.metrics import swd_multiscale
from neuron_gan_tpu_torch.models import GrowthState, PGConfig, build_generator
from neuron_gan_tpu_torch.runtime import resolve_device
from neuron_gan_tpu_torch.utils.plotting import gen_samples, plot_gen_samples


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('-n', type=int, default=16, help='Number of samples created')
    parser.add_argument('-output', type=str, default='samples_default.png',
                        help='Filename of the output image file stored in ./images')
    parser.add_argument('-weights', type=str, default='gen_dis_default.pth',
                        help='Filename of the weights stored in ./weights')
    parser.add_argument('-ema', action='store_true', default=False,
                        help='Sample from the EMA shadow generator when the '
                             'checkpoint contains one (native .npz only)')
    parser.add_argument('-fast', action='store_true', default=False,
                        help='Fast inference: packed layouts, TF32 allowed '
                             '(default: true float32, the reference grids)')
    parser.add_argument('-swd', action='store_true', default=False,
                        help='Also score the generated samples against the '
                             'real dataset with multi-scale sliced '
                             'Wasserstein distance and print one JSON line')
    parser.add_argument('-dataset_dir', type=str, default='',
                        help='Real-image directory for -swd '
                             '(default: config.dataset_dir)')
    parser.add_argument('--device', type=str, default='default',
                        choices=['cuda', 'cpu', 'default'])
    return parser


def fast_config(cfg):
    """``cfg`` as ``-fast`` runs it: precision=None (TF32 allowed, fused
    level boundaries) in the packed layouts; Karras et al.'s architecture,
    which takes no packed layout, only TF32."""
    if cfg.architecture == 'karras':
        return dataclasses.replace(cfg, precision=None)
    return dataclasses.replace(
        cfg, precision=None, packed_lanes=128,
        packed_min_res=max(64, 2 * cfg.image_size_init))


def load_generator(weights_filepath, device, fast=False, ema=False,
                   use_kernels=True):
    """(generator module, growth) from a ``.pth`` or ``.npz`` file."""
    if weights_filepath.endswith('.pth'):
        g_params, _, cfg, growth, _ = import_reference_checkpoint(weights_filepath)
    else:
        tree, meta = load_pytree_npz(weights_filepath)
        state = tree if 'g_params' in tree else tree['state']
        g_params = state['g_ema' if (ema and 'g_ema' in state) else 'g_params']
        if 'image_size_init' in meta:
            init = int(meta['image_size_init'])
        elif 'phase' in meta:
            init = int(meta['image_size']) // (2 ** int(meta['phase']))
        else:
            raise ValueError(
                f'{weights_filepath} has no image_size_init/phase metadata — '
                'cannot infer the architecture. Re-save the checkpoint with the '
                'train CLI, or convert it to the reference .pth format.')
        cfg = PGConfig(
            n_gen_features=tuple(meta['N_gen_features']),
            n_dis_features=tuple(meta['N_dis_features']),
            latent_dim=int(meta['latent_dim']),
            image_size_init=init,
            # older checkpoints predate these meta keys; their runs used the
            # then-only defaults, so falling back is exact for them
            n_colors=int(meta.get('N_colors', 1)),
            neg_slope=float(meta.get('LeakyReLU_leak', 0.2)),
            architecture=meta.get('architecture', 'neuron'),
        )
        growth = GrowthState(cfg)
        if int(meta['image_size']) > init or float(meta['alpha']) < 1.0:
            growth.set_resolution(int(meta['image_size']), float(meta['alpha']))
    cfg = dataclasses.replace(cfg, use_kernels=use_kernels)
    if fast:
        cfg = fast_config(cfg)
    growth = GrowthState(cfg, phase=growth.phase, alpha=growth.alpha)
    g = build_generator(cfg, torch.Generator().manual_seed(0), device=device)
    return load_jax_tree(g, g_params), growth


def main(argv=None):
    options = build_parser().parse_args(sys.argv[1:] if argv is None else argv)

    config.reset_configs()     # the defaults, as a fresh process has them

    weights_filepath = os.path.join(config.weights_dir, options.weights)
    output_filepath = os.path.join(config.images_dir, options.output)
    if not os.path.exists(weights_filepath):
        raise FileNotFoundError(f'{weights_filepath} does not exist. Run setup.py.')

    device = resolve_device(options.device)
    g, growth = load_generator(weights_filepath, device, fast=options.fast,
                               ema=options.ema, use_kernels=config.use_kernels)
    samples = plot_gen_samples(g, growth, n_images=options.n,
                               filename=output_filepath)
    print(f'Saved {options.n} samples to {output_filepath}')
    if not options.swd:
        return samples

    # Scored at the generator's NATIVE resolution on the seed-0 latents (the
    # training-time monitor's set): the saved grid is nearest-upsampled
    # mid-growth, which would poison the fine SWD bands
    res = int(growth.image_size)
    fake, _ = gen_samples(g, growth, n_images=options.n, seed=0)
    crop = g.cfg.image_size_max
    dataset = NeuronDataset(options.dataset_dir or config.dataset_dir,
                            image_size=crop, seed=config.seed,
                            preload_limit_mb=config.dataset_preload_limit_mb)
    spec = AugmentSpec(crop_size=crop, out_size=res, translation=0.0,
                       augment=False)
    stack = torch.from_numpy(dataset.images[:]).to(device)
    real = augment_batch(stack, None, spec)
    levels, mean = swd_multiscale(
        real, fake, torch.Generator(device=device).manual_seed(123),
        n_patches=2048, n_repeats=8)
    print(json.dumps({'swd_mean': round(float(mean), 4),
                      'swd_levels': [round(float(v), 4) for v in levels],
                      'n_real': len(dataset), 'n_fake': int(options.n),
                      'resolution': res,
                      'alpha': round(float(min(growth.alpha, 1.0)), 4)}))
    return samples


if __name__ == '__main__':
    main()
