"""The JAX package's shipping step in the port, on the CPU: 'mixed' at
``precision=None`` with the 2x4 layout (``packed_lanes=128``) and the fast
augmentation with the shear warp ('auto'); its launch counts, the
flagship configuration and chip_smoke.py's shipping checks.

Inputs are numpy arrays from a seed, handed to both sides, with the JAX
package's random draws injected into the port.  Tolerances: under 'mixed'
gradients and the post-Adam parameter updates by relative L2 distance, no
further from the JAX package than twice its own bfloat16-vs-float32
distance (tests/test_torch_mixed.py's rule); the augmented images atol
1e-5.
"""

import collections
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuron_gan_tpu import losses as jl
from neuron_gan_tpu.data.augment import (
    AugmentSpec as JAugmentSpec, augment_batch as j_augment_batch)
from neuron_gan_tpu.models import (
    PGConfig as JPGConfig, discriminator_pg, generator_pg,
    init_discriminator_pg, init_generator_pg)

from neuron_gan_tpu_torch import train_step as tts
from neuron_gan_tpu_torch.convert import to_jax_tree
from neuron_gan_tpu_torch.data.augment import warp_frame
from neuron_gan_tpu_torch.models import PGConfig

from test_torch_mixed import f32, rel_l2
from test_torch_packed import nhwc
from test_torch_packed8 import ARCH8
from test_torch_train_step import (
    SPEC, count_launches, grads_of, jax_batch_draws, load_chip_smoke,
    port_state, run_jax_step)


@pytest.fixture(scope='module')
def params8():
    kg, kd = jax.random.split(jax.random.PRNGKey(8))
    jcfg = JPGConfig(**ARCH8)
    return (jax.tree.map(np.asarray, init_generator_pg(kg, jcfg)),
            jax.tree.map(np.asarray, init_discriminator_pg(kd, jcfg)))


# ---------------------------------------------------------------------------
# the shipping step: 'mixed', precision=None, 2x4 layout, fast/shear
# ---------------------------------------------------------------------------

SHIP = dict(compute_dtype='mixed', precision=None)
SHIP_SPEC = dict(SPEC, crop_size=32, fast_augment=True, shear_warp='auto')
SHIP_FRAME = 48


@pytest.mark.parametrize('phase,fading', [(2, True), (3, False)])
def test_shipping_batch_step_tracks_jax(params8, phase, fading):
    # one make_batch_step; 'auto' takes the shear warp at 16^2 and the
    # gather warp at 32^2.  Gradients and post-Adam parameters of the port
    # no further from JAX-mixed than twice JAX-mixed from JAX-float32
    # (two independent roundings of one size lie about sqrt(2) of it
    # apart); the augmented images at the images' tolerance
    spec = dict(SHIP_SPEC, phase=phase, fading=fading)
    jcfg, j32 = JPGConfig(**ARCH8, **SHIP), JPGConfig(**ARCH8, precision=None)
    tcfg = PGConfig(**ARCH8, **SHIP, use_kernels=True)
    raw = np.random.default_rng(phase).random((2, SHIP_FRAME, SHIP_FRAME, 1)).astype(np.float32)
    k_batch = jax.random.PRNGKey(30 + phase)
    alpha = 0.5 if fading else 1.0
    aug_spec = tts._augment_spec(tcfg, tts.ChunkSpec(**spec))
    assert aug_spec.fast and aug_spec.shear == (phase == 2)
    draws = jax_batch_draws(k_batch, spec, 2, warp_frame(aug_spec, SHIP_FRAME))

    state = port_state(params8, spec, tcfg)
    tts.make_batch_step(tcfg, tts.ChunkSpec(**spec))(
        state, torch.from_numpy(raw), draws, alpha, 1e-3, 0.0)
    t_grads = [f32(v) for net in (state.d, state.g)
               for v in jax.tree.leaves(grads_of(net))]
    t_after = [f32(v) for net in (state.d, state.g)
               for v in jax.tree.leaves(to_jax_tree(net))]
    d_after = to_jax_tree(state.d)

    res = jcfg.resolution(phase)
    jspec = JAugmentSpec(crop_size=32, out_size=res, translation=0.05,
                         fast=True, shear=aug_spec.shear)
    images = j_augment_batch(jnp.asarray(raw), jax.random.fold_in(k_batch, 0), jspec)
    port_images = tts.augment_batch(torch.from_numpy(raw), draws['augment'], aug_spec)
    np.testing.assert_allclose(nhwc(port_images), np.asarray(images), rtol=0, atol=1e-5)
    z1, z2, eps = (jnp.asarray(v.numpy()) for v in draws['critic'][0])
    zg = jnp.asarray(draws['zg'].numpy())
    a = alpha if fading else None

    def jax_grads(cfg):
        g_apply = lambda p, z: generator_pg(p, z, cfg, phase, a)  # noqa: E731
        d_apply = lambda p, x: discriminator_pg(p, x, cfg, phase, a)  # noqa: E731
        g0, d0 = params8

        def d_total(dp):
            loss_w, _ = jl.d_w_loss(d_apply, g_apply, dp, g0, images, z1, 0.001)
            fake = jax.lax.stop_gradient(g_apply(g0, z2))
            return loss_w + jl.d_grad_pen_loss(d_apply, dp, images, fake, eps, 10.0)

        dg = jax.jit(jax.grad(d_total))(d0)
        gg = jax.jit(jax.grad(lambda gp: jl.g_w_loss(
            g_apply, d_apply, gp, d_after, zg)[0]))(g0)
        return [f32(v) for v in jax.tree.leaves(dg) + jax.tree.leaves(gg)]

    def jax_after(cfg):
        st, _ = run_jax_step(params8, spec, raw, k_batch, alpha, 1e-3, 0.0, cfg)
        return [f32(v) for v in jax.tree.leaves(st['d_params'])
                + jax.tree.leaves(st['g_params'])]

    before = [f32(v) for v in jax.tree.leaves(params8[1]) + jax.tree.leaves(params8[0])]
    for got, want, ref in ((t_grads, jax_grads(jcfg), jax_grads(j32)),
                           ([a - b for a, b in zip(t_after, before)],
                            [a - b for a, b in zip(jax_after(jcfg), before)],
                            [a - b for a, b in zip(jax_after(j32), before)])):
        bound = 2 * rel_l2(want, ref)
        assert 0 < bound and rel_l2(got, want) <= bound, (rel_l2(got, want), bound)
        assert rel_l2(got, ref) <= bound, (rel_l2(got, ref), bound)


@pytest.mark.parametrize('phase,fading', [(1, False), (2, True), (3, False)])
@pytest.mark.parametrize('dtype', ['float32', 'mixed'])
def test_shipping_launches_per_step(params8, monkeypatch, phase, fading, dtype):
    # the counts chip_smoke.py expects on the card: a 2x4 block runs two
    # K1 at 8 groups and no K3
    cfg = PGConfig(**ARCH8, compute_dtype=dtype, precision=None, use_kernels=True)
    spec = dict(SHIP_SPEC, phase=phase, fading=fading)
    calls, smoke = count_launches(monkeypatch, cfg, spec, params8, frame=SHIP_FRAME)
    assert calls == smoke.expected_launches(cfg, [phase])
    dt = str(cfg.dtype).removeprefix('torch.')
    if phase >= 2:
        assert calls['k1'][f'{dt}/8'] and calls['k3'][dt]


def test_flagship_shipping_config_is_the_jax_flagship():
    # the JAX package's flagship_config() and flagship_chunk_spec() as
    # they ship, with every kernel on
    from neuron_gan_tpu.flagship import (
        flagship_chunk_spec as jchunk, flagship_config as jflag)
    from neuron_gan_tpu_torch import flagship
    cfg, jcfg = flagship.flagship_shipping_config(), jflag()
    for f in ('n_gen_features', 'n_dis_features', 'latent_dim', 'image_size_init',
              'n_colors', 'neg_slope', 'compute_dtype', 'precision',
              'packed_min_res', 'packed_lanes', 'fused_up2', 'fused_pool', 'mixed'):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.use_kernels and cfg.packed_lanes == 128
    assert cfg == dataclasses.replace(flagship.flagship_mixed_config(), packed_lanes=128)
    spec, jspec = flagship.flagship_shipping_chunk_spec(5), jchunk(5)
    for f in (f.name for f in dataclasses.fields(jspec)):
        if hasattr(spec, f):
            assert getattr(spec, f) == getattr(jspec, f), f
    assert spec.fast_augment and spec.shear_warp == 'auto'
    # a steady 512^2 step: G blocks 3-4 and D block 0 in the 2x4 layout
    assert load_chip_smoke().expected_launches(cfg, [5]) == {
        'k1': {'bfloat16/1': 22, 'bfloat16/4': 14, 'bfloat16/8': 20},
        'k2': {'bfloat16/1': 22, 'bfloat16/4': 12, 'bfloat16/8': 14},
        'k3': {'bfloat16': 14}, 'k4': {'bfloat16': 12}}


def test_shipping_launch_sites_match_expected_launches():
    # the smoke's per-shape sites of a steady 512^2 shipping step sum to
    # its launch counts; the 2x4 epilogues at (8, 128, 128, 64) and
    # (8, 128, 256, 128), K3/K4 only at the 2x2 shapes
    from neuron_gan_tpu_torch import flagship
    smoke = load_chip_smoke()
    cfg = flagship.flagship_shipping_config()
    sites = flagship.steady_step_sites('shipping')
    want = smoke.expected_launches(cfg, [cfg.n_phases - 1])
    for key in ('k1', 'k2', 'k3', 'k4'):
        got = collections.Counter()
        for (k, _, case), n in sites.items():
            if k == key:
                got[smoke.launch_key('bfloat16', case if key in ('k1', 'k2') else None)] += n
        assert dict(got) == want[key], (key, got, want)
    assert {shape for (k, shape, case) in sites if case == 8} == {
        (8, 128, 128, 64), (8, 128, 256, 128)}
    assert {shape for (k, shape, _) in sites if k in ('k3', 'k4')} == {
        (8, 128, 32, 32), (8, 128, 64, 64)}
    assert flagship.epilogue_shapes(torch.bfloat16) >= {
        ((8, 128, 128, 64), 8), ((8, 128, 256, 128), 8)}


def test_chip_smoke_boundary_cases_of_the_shipping_path():
    # the fused boundaries the smoke holds against their decomposed chains:
    # G blocks 1-2 and D blocks 2-3 as on the mixed path, the 2x4 ones at
    # G blocks 3-4 and D blocks 0 (staying) and 1 (leaving the region)
    from neuron_gan_tpu_torch import flagship
    smoke = load_chip_smoke()
    cases = smoke.boundary_cases(flagship.flagship_shipping_config())
    assert cases == [
        ('up2', (8, 64, 32, 32), (32, 64)), ('up2', (8, 32, 64, 64), (32, 32)),
        ('up2_p8', (8, 32, 128, 128), (16, 32)), ('up2_p8', (8, 16, 256, 256), (16, 16)),
        ('pool2_p8', (8, 128, 256, 128), (16, 16)),
        ('pool2_p8_exit', (8, 128, 128, 64), (32, 16)),
        ('pool2', (8, 128, 64, 64), (32, 32)),
        ('pool2_unpacked', (8, 128, 32, 32), (64, 32))]
    mixed = smoke.boundary_cases(flagship.flagship_mixed_config())
    assert [c for c in mixed if c[0] == 'up2'][:2] == cases[:2] and mixed[-2:] == cases[-2:]


def test_chip_smoke_parity_small_shipping_on_cpu():
    # the shipping path's parity phase at a small size: kernel path, plain
    # path and the float32 reference (fused boundaries at 'highest') within
    # the bound; both planted faults (K1 at 4 groups in the 2x4 layout;
    # D's exit from it at stride (2, 2)) outside it
    from neuron_gan_tpu_torch import flagship
    smoke = load_chip_smoke()
    arch = {k: v for k, v in ARCH8.items() if k != 'packed_lanes'}
    cfg = flagship.flagship_shipping_config(**arch)
    chunk = flagship.flagship_shipping_chunk_spec(3, crop_size=32, latent_dim=8,
                                                  batch_size=2, n_images=2)
    raw = torch.from_numpy(np.random.default_rng(4).random(
        (2, SHIP_FRAME, SHIP_FRAME, 1)).astype(np.float32))
    out = smoke.parity(torch, 0, cfg, chunk, raw, 'shipping')
    dists, bound = out['grad_rel_l2'], out['rel_l2_bound']
    assert out['resolution'] == 32
    for name in ('kernel~plain', 'kernel~float32', 'plain~float32'):
        assert all(dists[name][n] <= b for n, b in bound.items()), (name, dists)
    for fault in ('k1_4_groups_in_p8', 'd_exit_stride_2x2'):
        assert dists[f'{fault}~float32']['D'] > bound['D'], (fault, dists)
