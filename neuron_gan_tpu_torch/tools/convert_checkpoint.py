"""Convert checkpoints between the ``.npz`` format (the JAX package's,
which the port reads and writes) and the reference's torch ``.pth`` format,
both ways: a thin CLI over the port's ``checkpoint.py`` (counterpart of
the JAX package's tools/convert_checkpoint.py).

    python -m neuron_gan_tpu_torch.tools.convert_checkpoint GenDisc_ab12.npz out.pth
    python -m neuron_gan_tpu_torch.tools.convert_checkpoint gen_dis_default.pth out.npz

* npz -> pth: writes the reference's checkpoint schema
  (Generator_state/_attrs, Discriminator_state/_attrs, lr, loss series —
  reference utils.py:158-176) with ``torch.save``, so the weights load in
  the reference's train.py/eval.py.
* pth -> npz: imports the reference checkpoint (incl. legacy-format key
  migration) into the ``.npz`` pytree layout.  Optimizer state is not
  part of the reference format; ``train --resume`` of either package
  restores it tolerantly (fresh optimizer slots, loaded weights).
"""

import argparse
import os

import numpy as np

from neuron_gan_tpu_torch.checkpoint import (
    import_reference_checkpoint, load_pytree_npz, save_pytree_npz,
    save_reference_checkpoint)
from neuron_gan_tpu_torch.models import GrowthState, PGConfig


def npz_to_pth(src, dst):
    payload, meta = load_pytree_npz(src)
    if meta is None or 'image_size_init' not in meta:
        raise SystemExit(f'{src}: missing architecture meta — was this '
                         'written by a Checkpointer of either package?')
    cfg = PGConfig(
        n_gen_features=tuple(meta['N_gen_features']),
        n_dis_features=tuple(meta['N_dis_features']),
        latent_dim=int(meta['latent_dim']),
        image_size_init=int(meta['image_size_init']),
        # propagate the architecture knobs train.py persists; older
        # checkpoints predate the keys and used these defaults
        n_colors=int(meta.get('N_colors', 1)),
        neg_slope=float(meta.get('LeakyReLU_leak', 0.2)),
    )
    growth = GrowthState(cfg)
    if int(meta['image_size']) > cfg.image_size_init or float(meta['alpha']) < 1.0:
        growth.set_resolution(int(meta['image_size']), float(meta['alpha']))
    # bare state trees (e.g. stretch_1024's) are valid checkpoints
    # too — train.py resumes them; accept both layouts here
    state = payload['state'] if 'state' in payload else payload
    series = payload.get('series', {})
    save_reference_checkpoint(
        dst, state['g_params'], state['d_params'], cfg, growth,
        epoch=int(meta.get('epoch', 0)), lr=float(meta.get('lr', 1e-4)),
        series={k: np.asarray(v) for k, v in series.items()})
    print(f'wrote reference-format checkpoint: {dst}')


def pth_to_npz(src, dst):
    g_params, d_params, cfg, growth, meta_in = import_reference_checkpoint(src)
    series = {name: np.asarray(meta_in.get(name, np.zeros(0)))
              for name in ('Loss_real', 'Loss_fake', 'Loss_G', 'Loss_D')}
    meta = {
        'epoch': int(meta_in.get('epoch', 0)),
        'lr': float(meta_in.get('lr', 1e-4)),
        'image_size': growth.image_size,
        'alpha': float(min(growth.alpha, 1.0)),
        'phase': growth.phase,
        'ID': os.path.splitext(os.path.basename(dst))[0],
        'N_gen_features': list(cfg.n_gen_features),
        'N_dis_features': list(cfg.n_dis_features),
        'latent_dim': cfg.latent_dim,
        'image_size_init': cfg.image_size_init,
    }
    save_pytree_npz(dst, {'state': {'g_params': g_params,
                                    'd_params': d_params},
                          'series': series}, meta)
    print(f'wrote .npz checkpoint: {dst} (optimizer state starts fresh '
          'on resume — tolerant restore)')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('src', help='input checkpoint (.npz or .pth)')
    ap.add_argument('dst', help='output checkpoint (.pth or .npz)')
    args = ap.parse_args(argv)
    if args.src.endswith('.npz') and args.dst.endswith('.pth'):
        npz_to_pth(args.src, args.dst)
    elif args.src.endswith('.pth') and args.dst.endswith('.npz'):
        pth_to_npz(args.src, args.dst)
    else:
        raise SystemExit('expected .npz -> .pth or .pth -> .npz')


if __name__ == '__main__':
    main()
