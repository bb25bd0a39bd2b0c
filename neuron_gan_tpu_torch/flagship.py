"""The flagship configuration of the port, in one place.

The reference's config_ex.py geometry (counterpart of
neuron_gan_tpu/flagship.py): 6 levels from 16^2 to 512^2, G features
(128, 64, 32, 32, 16, 16), D features (16, 16, 32, 32, 64, 128), latent 64,
batch 8, n_critic 1, lambda_gp 10, drift 1e-3, Adam beta1 0.5, lr 1e-4.

Four executions of that geometry; the first three with the
reference-exact augmentation (``flagship_chunk_spec``), the first two
float32 with TF32 off (precision 'highest'):

* ``flagship_config``: the unpacked layout, the CUDA LeakyReLU + PixelNorm
  kernel pair in every G/D block;
* ``flagship_packed_config``: the blocks at 64^2 and above in the 2x2
  packed layout (``packed_min_res=64``), the kernel pair after each packed
  conv1 at 4 groups and in the unpacked blocks, and the fused packed conv
  kernel pair on each packed conv2.  The level boundaries are the
  decomposed ones, which the JAX package's auto rule picks at 'highest';
* ``flagship_mixed_config``: the JAX package's shipping numerics on the
  2x2 layout -- ``compute_dtype='mixed'`` at ``precision=None`` (TF32
  allowed, bfloat16 activations through the blocks), so the level
  boundaries are fused, and every kernel runs in bfloat16.  It is the JAX
  ``flagship_config(packed_lanes=None)``;
* ``flagship_shipping_config`` with ``flagship_shipping_chunk_spec``: the
  JAX package's shipping step, its ``flagship_config()`` and
  ``flagship_chunk_spec()`` -- the mixed numerics with the 16-channel
  packed levels (G blocks 3-4, D block 0) in the 2x4 layout
  (``packed_lanes=128``), their epilogues in the kernel pair at 8 groups,
  and the fast crop-fused augmentation with the shear warp ('auto').

No configuration is a default anywhere until the card has measured it
(ROADMAP).  The kernel launch sites of one steady 512^2 step of each
execution, by whole shape (``steady_step_sites``, ``epilogue_shapes``),
are what chip_smoke.py and the kernel variant scripts check and time.
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


def flagship_shipping_config(**overrides):
    return flagship_mixed_config(**{'packed_lanes': 128, **overrides})


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


def flagship_shipping_chunk_spec(phase, fading=False, **overrides):
    """flagship_chunk_spec with the JAX package's shipping augmentation:
    fast (crop-fused, resized first), the shear warp at every phase but
    32^2 ('auto')."""
    return flagship_chunk_spec(phase, fading, **{
        'fast_augment': True, 'shear_warp': 'auto', **overrides})


# the configuration and chunk spec of each path chip_smoke.py and
# profile_step.py drive
PATHS = {'unpacked': (flagship_config, flagship_chunk_spec),
         'packed': (flagship_packed_config, flagship_chunk_spec),
         'mixed': (flagship_mixed_config, flagship_chunk_spec),
         'shipping': (flagship_shipping_config, flagship_shipping_chunk_spec)}


# every LReLU + PixelNorm epilogue input of the unpacked flagship path at
# batch 8: G blocks 0-4, then D blocks 0-4
G_SHAPES = [(8, 64, 32, 32), (8, 32, 64, 64), (8, 32, 128, 128),
            (8, 16, 256, 256), (8, 16, 512, 512)]
D_SHAPES = [(8, 16, 256, 256), (8, 32, 128, 128), (8, 32, 64, 64),
            (8, 64, 32, 32), (8, 128, 16, 16)]
# every packed conv2 (its input and output) of the packed and mixed paths
# at batch 8: G blocks 1-4, then D blocks 0-2; the packed conv1 epilogues
# (K1 at 4 groups) take the same shapes
PACKED_SHAPES = [(8, 128, 32, 32), (8, 128, 64, 64), (8, 64, 128, 128),
                 (8, 64, 256, 256), (8, 64, 128, 128), (8, 128, 64, 64),
                 (8, 128, 32, 32)]
# the unpacked epilogues of the packed, mixed and shipping paths: G block
# 0, D blocks 3 and 4
UNPACKED_OF_PACKED = [(8, 64, 32, 32), (8, 64, 32, 32), (8, 128, 16, 16)]
# the shipping path's 2x4 blocks (both epilogues: K1 at 8 groups): G
# blocks 3 and 4, then D block 0; its 2x2 blocks are PACKED_SHAPES' G
# blocks 1-2 and D blocks 1-2
PACKED8_SHAPES = [(8, 128, 128, 64), (8, 128, 256, 128), (8, 128, 128, 64)]


def steady_step_sites(path):
    """Every kernel launch of one steady 512^2 step of a path ('unpacked',
    'packed', 'mixed' or 'shipping'), as {(kernel, shape, case):
    launches}: K1/K2 at x's shape with case = the grouping, K3 at y's
    shape with case None, K4 at y's shape with case 'live' or 'absent'
    (r's cotangent).  G runs 3 forwards and 1 backward a step, D 4 and 5
    (chip_smoke.py's ``expected_launches``); an unpacked block has two K1
    epilogues, a 2x2 one a K1 at 4 groups and a K3, a 2x4 one two K1 at 8
    groups; a K4 runs in each backward of a K3, with a live ct_r in D's
    GP outer pass alone."""
    sites = collections.Counter()

    def epilogues(shape, n_groups, fwd, bwd):
        sites['k1', shape, n_groups] += 2 * fwd
        sites['k2', shape, n_groups] += 2 * bwd

    def packed(y, fwd, bwd, live):
        sites['k1', y, 4] += fwd
        sites['k2', y, 4] += bwd
        sites['k3', y, None] += fwd
        sites['k4', y, 'absent'] += bwd - live
        if live:
            sites['k4', y, 'live'] += live

    if path == 'unpacked':
        for shape in G_SHAPES:
            epilogues(shape, 1, 3, 1)
        for shape in D_SHAPES:
            epilogues(shape, 1, 4, 5)
        return dict(sites)
    epilogues(UNPACKED_OF_PACKED[0], 1, 3, 1)
    for shape in UNPACKED_OF_PACKED[1:]:
        epilogues(shape, 1, 4, 5)
    if path == 'shipping':
        g_packed, d_packed = PACKED_SHAPES[:2], PACKED_SHAPES[5:]
        for shape in PACKED8_SHAPES[:2]:
            epilogues(shape, 8, 3, 1)
        epilogues(PACKED8_SHAPES[2], 8, 4, 5)
    else:
        g_packed, d_packed = PACKED_SHAPES[:4], PACKED_SHAPES[4:]
    for y in g_packed:
        packed(y, 3, 1, 0)
    for y in d_packed:
        packed(y, 4, 5, 1)
    return dict(sites)


def epilogue_shapes(dtype):
    """(x shape, grouping) of every K1/K2 launch of the paths that run
    them in ``dtype`` (float32: unpacked and packed; bfloat16: mixed and
    shipping)."""
    paths = (('unpacked', 'packed') if dtype == torch.float32
             else ('mixed', 'shipping'))
    return {(shape, case) for p in paths
            for (k, shape, case) in steady_step_sites(p) if k == 'k1'}
