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
are what chip_smoke.py and the kernel variant scripts check and time;
``step_sites`` gives them for any configuration, phase and batch (the
1024^2 run of tools/stretch_1024.py).
"""

import collections

import torch

from neuron_gan_tpu_torch.models import PGConfig
from neuron_gan_tpu_torch.models.pggan import (
    _want_packed, _want_packed8_d, _want_packed8_g)
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


# G's forward alone, no backward, no D: a sample grid
SAMPLE_PASSES = ((1, 0), (0, 0))


def step_passes(gp_remat=False, gp_reuse_fakes=False):
    """((G forwards, G backwards), (D forwards, D backwards)) of one batch
    step: G runs 3 forwards (the critic loss's fakes, the GP's fakes, the
    generator step), 2 under ``gp_reuse_fakes`` (the GP takes the critic
    loss's fakes), and 1 backward; D runs 4 forwards (real, fake, the GP's
    interpolate, the generator step) and 5 backwards (real, fake, the GP's
    inner pass, the GP's outer pass back through the interpolate's
    forward, the generator step).  Under ``gp_remat`` D runs the
    interpolate's forward three times: checkpointed (nothing saved), then
    recomputed in each of the GP's two backward passes (the outer pass
    unpacks the inner one's saved tensors, which the checkpoint recomputes
    again)."""
    return (2 if gp_reuse_fakes else 3, 1), (6 if gp_remat else 4, 5)


def block_layouts(cfg, phase):
    """The layout of each block a step of ``cfg`` at ``phase`` runs, G's
    then D's: 'unpacked' (two K1 at 1 group), 'packed' (the 2x2 layout: a
    K1 at 4 groups and a K3) or 'p8' (the 2x4 layout: two K1 at 8
    groups), by the JAX package's routing rules (models/pggan.py's
    predicates): a G block enters the 2x4 layout natively at a fused
    up-conv, a D block stays in it where its input is 2x4, and a 2x2 block
    of 64 packed channels runs its tail in it."""
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


def step_sites(cfg, phase, batch, passes=None):
    """Every kernel launch of one batch step of ``cfg`` at ``phase`` with
    ``batch`` rows (or of other ``passes``, e.g. ``SAMPLE_PASSES``), by
    whole shape: {(kernel, shape, case): launches}, K1/K2 at x's shape
    with case = the grouping, K3 at y's shape with case None, K4 at y's
    shape with case 'live' or 'absent' (r's cotangent: live in D's GP
    outer pass alone).  Each block launches by its layout
    (``block_layouts``): an unpacked block two K1 at 1 group, a 2x2 one a
    K1 at 4 groups and a K3, a 2x4 one two K1 at 8 groups; each K1
    forward has its K2 in a backward, each K3 its K4.  A G block of
    output resolution r and f features, or a D block at r (after its
    pool) of f output features, runs at (batch, f, r, r) unpacked,
    (batch, 4f, r/2, r/2) in the 2x2 layout and (batch, 8f, r/2, r/4) in
    the 2x4 one."""
    (gf, gb), (df, db) = passes or step_passes()
    g, d = block_layouts(cfg, phase)
    sites = collections.Counter()

    def block(lay, feat, res, fwd, bwd, live):
        if lay == 'unpacked':
            shape, n, groups = (batch, feat, res, res), 2, 1
        elif lay == 'p8':
            shape, n, groups = (batch, 8 * feat, res // 2, res // 4), 2, 8
        else:
            shape, n, groups = (batch, 4 * feat, res // 2, res // 2), 1, 4
        sites['k1', shape, groups] += n * fwd
        sites['k2', shape, groups] += n * bwd
        if lay == 'packed':
            sites['k3', shape, None] += fwd
            sites['k4', shape, 'absent'] += bwd - live
            sites['k4', shape, 'live'] += live

    for i, lay in enumerate(g):
        block(lay, cfg.n_gen_features[i + 1], cfg.resolution(i + 1), gf, gb, 0)
    res, n = cfg.resolution(phase), cfg.n_layers_max
    for lay, i in zip(d, range(n - 1 - phase, n - 1)):
        res //= 2
        block(lay, cfg.n_dis_features[i + 1], res, df, db, min(db, 1))
    return {k: v for k, v in sites.items() if v}


def steady_step_sites(path):
    """``step_sites`` of one steady 512^2 step of a path ('unpacked',
    'packed', 'mixed' or 'shipping') at batch 8."""
    cfg = PATHS[path][0]()
    return step_sites(cfg, cfg.n_phases - 1, 8)


def site_shapes(path, kernel, case=None):
    """The distinct shapes, sorted, at which a steady 512^2 step of a
    path launches ``kernel`` (K1/K2: at the grouping ``case``, or at any
    grouping)."""
    return sorted({shape for (k, shape, c) in steady_step_sites(path)
                   if k == kernel and case in (None, c)})


def epilogue_shapes(dtype):
    """(x shape, grouping) of every K1/K2 launch of the paths that run
    them in ``dtype`` (float32: unpacked and packed; bfloat16: mixed and
    shipping)."""
    paths = (('unpacked', 'packed') if dtype == torch.float32
             else ('mixed', 'shipping'))
    return {(shape, case) for p in paths
            for (k, shape, case) in steady_step_sites(p) if k == 'k1'}
