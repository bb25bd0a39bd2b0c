"""The flagship configuration of the port, in one place.

The reference's config_ex.py geometry (counterpart of
neuron_gan_tpu/flagship.py): 6 levels from 16^2 to 512^2, G features
(128, 64, 32, 32, 16, 16), D features (16, 16, 32, 32, 64, 128), latent 64,
batch 8, n_critic 1, lambda_gp 10, drift 1e-3, Adam beta1 0.5, lr 1e-4.

Three executions of that geometry, all with the reference-exact
augmentation; the first two float32 with TF32 off (precision 'highest'):

* ``flagship_config``: the unpacked layout, the CUDA LeakyReLU + PixelNorm
  kernel pair in every G/D block;
* ``flagship_packed_config``: the blocks at 64^2 and above in the 2x2
  packed layout (``packed_min_res=64``; the 2x4 layout is not ported), the
  kernel pair after each packed conv1 at 4 groups and in the unpacked
  blocks, and the fused packed conv kernel pair on each packed conv2 --
  every kernel the JAX package has.  The level boundaries are the
  decomposed ones, which the JAX package's auto rule picks at 'highest';
* ``flagship_mixed_config``: the JAX package's shipping numerics on the
  packed layout -- ``compute_dtype='mixed'`` at ``precision=None`` (TF32
  allowed, bfloat16 activations through the blocks), so the level
  boundaries are fused, and every kernel runs in bfloat16.  It is the JAX
  ``flagship_config(packed_lanes=None)``.

The JAX package's other shipping defaults (the 2x4 layout, the fast/shear
augmentation) are later slices of the port (ROADMAP A6, A11).  No
configuration is a default anywhere until the card has measured it
(ROADMAP B5).

The kernel launch sites of one steady 512^2 step of each execution, by
shape (``steady_step_sites``, ``epilogue_shapes``), are what chip_smoke.py
and the kernel variant scripts check and time.
"""

import collections

import torch

from neuron_gan_tpu_torch.models import PGConfig
from neuron_gan_tpu_torch.train_step import ChunkSpec


def flagship_config(**overrides):
    kw = dict(
        n_gen_features=(128, 64, 32, 32, 16, 16),
        n_dis_features=(16, 16, 32, 32, 64, 128),
        latent_dim=64, image_size_init=16, n_colors=1,
        compute_dtype='float32', precision='highest', use_kernels=True,
    )
    kw.update(overrides)
    return PGConfig(**kw)


def flagship_packed_config(**overrides):
    return flagship_config(**{'packed_min_res': 64, **overrides})


def flagship_mixed_config(**overrides):
    return flagship_packed_config(**{'compute_dtype': 'mixed',
                                     'precision': None, **overrides})


def flagship_chunk_spec(phase, fading=False, **overrides):
    """ChunkSpec for one flagship chunk; lr_gamma/lr_cap mirror config_ex's
    25k-epoch phases, crop_size is the dataset maximum (512)."""
    kw = dict(
        phase=phase, fading=fading, n_critic=1, batch_size=8,
        n_images=16, shuffle=True, crop_size=512, translation=0.05,
        augment=True, gp_lambda=10.0, drift_epsilon=0.001, sim_lambda0=0.0,
        sim_decay=0.0, beta1=0.5, rmsprop=False, lr0=1e-4,
        lr_gamma=0.9998157, lr_boundary=0, lr_cap=12500, alpha_start=0,
        alpha_step=1e-4, latent_dim=64,
        fast_augment=False, shear_warp=False,
    )
    kw.update(overrides)
    return ChunkSpec(**kw)


# every LReLU + PixelNorm epilogue shape of the unpacked flagship path at
# batch 8: G blocks (C, R) and D blocks (C, R)
G_SHAPES = [(64, 32), (32, 64), (32, 128), (16, 256), (16, 512)]
D_SHAPES = [(16, 256), (32, 128), (32, 64), (64, 32), (128, 16)]
# every packed conv2 of the packed flagship path at batch 8, (N, packed
# side): G blocks 1-4, then D blocks 0-2; K = N.  The packed conv1
# epilogues (K1 at 4 groups) take the same shapes.
PACKED_SHAPES = [(128, 32), (128, 64), (64, 128), (64, 256),
                 (64, 128), (128, 64), (128, 32)]
# the unpacked epilogues of the packed and mixed paths (C, R): G block 0,
# D blocks 3 and 4; the mixed path gives K1-K4 the packed path's shapes
UNPACKED_OF_PACKED = [(64, 32), (64, 32), (128, 16)]


def steady_step_sites(path):
    """Every kernel launch of one steady 512^2 step of a path ('unpacked',
    'packed' or 'mixed'), as {(kernel, shape, case): launches}: K1/K2 at
    (8, C, R, R) with case = the grouping, K3 at y's shape with case None,
    K4 at y's shape with case 'live' or 'absent' (r's cotangent).  G runs
    3 forwards and 1 backward a step, D 4 and 5 (chip_smoke.py's
    ``expected_launches``); an unpacked block has two K1 epilogues, a
    packed one a K1 at 4 groups and a K3; a K4 runs in each backward of a
    K3, with a live ct_r in D's GP outer pass alone."""
    sites = collections.Counter()

    def unpacked(c, r, fwd, bwd):
        sites['k1', (8, c, r, r), 1] += 2 * fwd
        sites['k2', (8, c, r, r), 1] += 2 * bwd

    def packed(n, s, fwd, bwd, live):
        y = (8, n, s, s)
        sites['k1', y, 4] += fwd
        sites['k2', y, 4] += bwd
        sites['k3', y, None] += fwd
        sites['k4', y, 'absent'] += bwd - live
        if live:
            sites['k4', y, 'live'] += live

    if path == 'unpacked':
        for c, r in G_SHAPES:
            unpacked(c, r, 3, 1)
        for c, r in D_SHAPES:
            unpacked(c, r, 4, 5)
    else:
        unpacked(*UNPACKED_OF_PACKED[0], 3, 1)
        for c, r in UNPACKED_OF_PACKED[1:]:
            unpacked(c, r, 4, 5)
        for n, s in PACKED_SHAPES[:4]:
            packed(n, s, 3, 1, 0)
        for n, s in PACKED_SHAPES[4:]:
            packed(n, s, 4, 5, 1)
    return dict(sites)


def epilogue_shapes(dtype):
    """(x shape, grouping) of every K1/K2 launch of the paths that run
    them in ``dtype`` (float32: unpacked and packed; bfloat16: mixed)."""
    paths = ('unpacked', 'packed') if dtype == torch.float32 else ('mixed',)
    return {(shape, case) for p in paths
            for (k, shape, case) in steady_step_sites(p) if k == 'k1'}
