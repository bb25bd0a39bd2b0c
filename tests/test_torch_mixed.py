"""The port at the JAX package's shipping numerics, on the CPU: the fused
packed level boundaries, ``precision=None`` and ``compute_dtype`` 'mixed'
and 'bfloat16'.

Inputs are numpy arrays from a seed, handed to both sides.  JAX runs its
Pallas kernels interpreted (``use_pallas``, ``pallas_epilogue``,
``pallas_conv``) at ``precision=None``, where its auto rule fuses the
packed level boundaries; the port runs ``use_kernels=True`` at
``precision=None`` (its kernel Functions take their plain versions here).

Tolerances.  float32: rtol 1e-4 / atol 1e-5 on outputs and gradients (the
packed tests' bound; the fused boundaries reorder sums).  bfloat16 rounds
at other places in the two frameworks (a conv with a bias rounds once or
twice; autodiff decomposes ops differently), and a LeakyReLU kink flips where a rounding crosses 0, so the
port is held against the JAX package at the same ``compute_dtype`` by
relative L2 distance over a batch of 8: no further from it than the JAX
package's own run in that dtype lies from its float32 run (gradients
where the two cannot round at the same points: twice that, as the tests
say), and under 'mixed' within tests/test_mixed_precision.py's bounds
(image max 0.15 / mean 0.02, scores 0.05 of their scale).  The
kernels' plain versions in bfloat16 lie within 2 bfloat16 ulps of the
output's scale of the interpreted Pallas kernels.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuron_gan_tpu.models import (
    PGConfig as JPGConfig, discriminator_pg, generator_pg,
    init_discriminator_pg, init_generator_pg)
from neuron_gan_tpu.ops import packed as jpk
from neuron_gan_tpu.ops.pallas_conv import _call_fwd, _dz_call, _fused_pair

import neuron_gan_tpu_torch.ops.packed_conv_lrelu_pn as pcl
from neuron_gan_tpu_torch.ops import equalized_conv2d, upsample2_bilinear
from neuron_gan_tpu_torch.ops import packed as tpk
from neuron_gan_tpu_torch.models import (
    DiscriminatorPG, GeneratorPG, PGConfig)

from test_torch_models import CASES, PACKED_ARCH, grads_tree, port_models
from test_torch_packed import hwio, nchw, nhwc, oihw, r_as_jax, rand

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = dict(n_gen_features=(16, 8, 8), n_dis_features=(8, 8, 16),
            latent_dim=8, image_size_init=4)
B = 8
KERNELS_J = dict(use_pallas=True, pallas_epilogue=True, pallas_conv=True)


def rel_l2(xs, ys):
    """Relative L2 distance of two lists of arrays, taken as one vector."""
    num = sum(np.sum((np.asarray(x, np.float64) - np.asarray(y, np.float64)) ** 2)
              for x, y in zip(xs, ys))
    den = sum(np.sum(np.asarray(y, np.float64) ** 2) for y in ys)
    return math.sqrt(num / den)


def bf16_ulp(scale):
    """One bfloat16 ulp (8 significant bits) at magnitude ``scale``."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the fused level boundaries, float32
# ---------------------------------------------------------------------------

def _boundary(name):
    """(JAX op, port op, port decomposed chain, input side of n, bias?)."""
    if name == 'up2':
        return (jpk.up2_equalized_conv3x3, tpk.up2_equalized_conv3x3,
                lambda x, w, b: tpk.packed_equalized_conv3x3(
                    tpk.space_to_depth(upsample2_bilinear(x)), w),
                lambda n: n, False)
    if name == 'pool2':
        return (jpk.pool2_equalized_conv3x3, tpk.pool2_equalized_conv3x3,
                lambda x, w, b: tpk.packed_equalized_conv3x3(
                    tpk.space_to_depth(tpk.packed_avg_pool2(x)), w, b),
                lambda n: 2 * n, True)
    return (jpk.pool2_unpacked_equalized_conv3x3,
            tpk.pool2_unpacked_equalized_conv3x3,
            lambda x, w, b: equalized_conv2d(tpk.packed_avg_pool2(x), w, b,
                                             padding=1),
            lambda n: n, True)


@pytest.mark.parametrize('n', [2, 3, 5, 8])
@pytest.mark.parametrize('name', ['up2', 'pool2', 'pool2_unpacked'])
def test_fused_boundary_matches_jax_and_decomposed_chain(name, n):
    jfn, tfn, chain, side, bias = _boundary(name)
    ci, co = 3, 5
    c_in = ci if name == 'up2' else 4 * ci
    x = rand((2, side(n), side(n), c_in), 100 + n)
    w, b = rand((3, 3, ci, co), 101), rand((co,), 102)
    params = {'w': jnp.asarray(w), **({'b': jnp.asarray(b)} if bias else {})}
    out_shape = jax.eval_shape(lambda x: jfn(x, params), jnp.asarray(x)).shape
    cot = rand(out_shape, 103)

    def jloss(x, p):
        y = jfn(x, p, precision=None)
        return jnp.sum(y * cot), y

    (_, jy), (jgx, jgp) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), params)
    xt, wt = nchw(x).requires_grad_(), oihw(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_() if bias else None
    ty = tfn(xt, wt) if name == 'up2' else tfn(xt, wt, bt)
    (ty * nchw(cot)).sum().backward()
    np.testing.assert_allclose(nhwc(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(hwio(wt.grad), np.asarray(jgp['w']), **TOL)
    if bias:
        np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jgp['b']), **TOL)
    # the same function as the port's own decomposed chain
    want = chain(nchw(x), oihw(w), torch.from_numpy(b) if bias else None)
    torch.testing.assert_close(ty.detach(), want, **TOL)


def test_fused_up2_refuses_other_inputs():
    with pytest.raises(ValueError, match='square'):
        tpk.up2_equalized_conv3x3(torch.zeros(1, 3, 4, 6), torch.zeros(5, 3, 3, 3))
    with pytest.raises(ValueError, match='square'):
        tpk.up2_equalized_conv3x3(torch.zeros(1, 3, 1, 1), torch.zeros(5, 3, 3, 3))


# ---------------------------------------------------------------------------
# the bfloat16 rounding points of the composed ops
# ---------------------------------------------------------------------------

def test_bf16_upsample_rounds_as_jax():
    # the shift-and-add form rounds after every product and sum, as JAX's
    # _up2_1d does: bit for bit; in float32 the port keeps F.interpolate
    from neuron_gan_tpu.ops.resize import upsample2_bilinear as j_up
    x = jnp.asarray(rand((2, 5, 6, 3), 110)).astype(jnp.bfloat16)
    got = upsample2_bilinear(torch_bf16(x))
    np.testing.assert_array_equal(nhwc(got.float()), f32(j_up(x)))
    xf = torch.from_numpy(rand((2, 3, 5, 6), 111))
    from neuron_gan_tpu_torch.ops.resize import up2_1d
    torch.testing.assert_close(up2_1d(up2_1d(xf, 2), 3), upsample2_bilinear(xf),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('c', [4, 32])
def test_bf16_packed_epilogue_and_pool_round_as_jax_fast_path(c):
    # packed_pixel_norm under 'mixed' and packed_avg_pool2 in bfloat16
    # against the JAX package's precision=None forms (the _mxu einsums;
    # c=32 takes packed_pixel_norm_mxu's same-group branch): within one
    # bfloat16 ulp of the output's scale (sums in another order)
    x = jnp.asarray(rand((2, 3, 4, 4 * c), 120 + c)).astype(jnp.bfloat16)
    assert_within_ulps(nhwc(tpk.packed_pixel_norm(torch_bf16(x), f32_stats=True).float()),
                       f32(jpk.packed_pixel_norm_mxu(x, f32_stats=True)), n=1)
    assert_within_ulps(nhwc(tpk.packed_avg_pool2(torch_bf16(x)).float()),
                       f32(jpk.packed_avg_pool2_mxu(x)), n=1)


# ---------------------------------------------------------------------------
# G and D against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def packed_params():
    kg, kd = jax.random.split(jax.random.PRNGKey(1))
    jcfg = JPGConfig(**PACKED_ARCH)
    return (jax.tree.map(np.asarray, init_generator_pg(kg, jcfg)),
            jax.tree.map(np.asarray, init_discriminator_pg(kd, jcfg)))


@pytest.fixture(scope='module')
def params():
    kg, kd = jax.random.split(jax.random.PRNGKey(0))
    jcfg = JPGConfig(**ARCH)
    return (jax.tree.map(np.asarray, init_generator_pg(kg, jcfg)),
            jax.tree.map(np.asarray, init_discriminator_pg(kd, jcfg)))


def configs(arch, dtype):
    return (JPGConfig(**arch, precision=None, compute_dtype=dtype, **KERNELS_J),
            PGConfig(**arch, precision=None, compute_dtype=dtype,
                     use_kernels=True))


def net_inputs(net, cfg, phase, seed):
    rng = np.random.default_rng(seed)
    res = cfg.resolution(phase)
    if net == 'G':
        return (rng.standard_normal((B, cfg.latent_dim)).astype(np.float32),
                rng.standard_normal((B, res, res, 1)).astype(np.float32))
    return (rng.uniform(-1, 1, (B, res, res, 1)).astype(np.float32),
            rng.standard_normal((B, 1)).astype(np.float32))


def jax_net(net, tree, jcfg, inp, cot, phase, alpha):
    """(output as float32, its dtype, the parameter gradients' leaves)."""
    fn = generator_pg if net == 'G' else discriminator_pg

    def loss(p):
        y = fn(p, jnp.asarray(inp), jcfg, phase, alpha)
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(tree)
    return f32(y), y.dtype, [f32(v) for v in jax.tree.leaves(g)]


def port_net(net, module, inp, cot, phase, alpha):
    x = torch.from_numpy(inp if net == 'G' else inp.transpose(0, 3, 1, 2).copy())
    y = module(x, phase, alpha)
    c = torch.from_numpy(cot if net == 'D' else cot.transpose(0, 3, 1, 2).copy())
    (y.float() * c).sum().backward()
    yf = y.detach().float().numpy()
    if net == 'G':
        yf = yf.transpose(0, 2, 3, 1)
    return yf, y.dtype, [f32(v) for v in jax.tree.leaves(grads_tree(module))]


@pytest.mark.parametrize('phase,alpha', CASES)
@pytest.mark.parametrize('net', ['G', 'D'])
def test_fused_boundaries_float32_match_jax(packed_params, net, phase, alpha):
    # precision=None, float32: the fused boundaries on both sides
    jcfg, tcfg = configs(PACKED_ARCH, 'float32')
    assert tcfg.fused_up2 and tcfg.fused_pool and jcfg.fused_up2 and jcfg.fused_pool
    inp, cot = net_inputs(net, jcfg, phase, 40 + phase)
    jy, _, jg = jax_net(net, packed_params[net == 'D'], jcfg, inp, cot, phase, alpha)
    mod = port_models(packed_params, tcfg)[net == 'D']
    ty, _, tg = port_net(net, mod, inp, cot, phase, alpha)
    np.testing.assert_allclose(ty, jy, **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(b).max())))


@pytest.mark.parametrize('phase,alpha', CASES)
@pytest.mark.parametrize('net', ['G', 'D'])
@pytest.mark.parametrize('layout,dtype', [('packed', 'mixed'),
                                          ('packed', 'bfloat16'),
                                          ('unpacked', 'mixed')])
def test_reduced_precision_tracks_jax(params, packed_params, layout, net, dtype,
                                      phase, alpha):
    arch, tree = ((ARCH, params) if layout == 'unpacked'
                  else (PACKED_ARCH, packed_params))
    jcfg, tcfg = configs(arch, dtype)
    j32, _ = configs(arch, 'float32')
    inp, cot = net_inputs(net, jcfg, phase, 50 + phase)
    jy, jdt, jg = jax_net(net, tree[net == 'D'], jcfg, inp, cot, phase, alpha)
    ry, _, rg = jax_net(net, tree[net == 'D'], j32, inp, cot, phase, alpha)
    mod = port_models(tree, tcfg)[net == 'D']
    ty, tdt, tg = port_net(net, mod, inp, cot, phase, alpha)

    # the dtype contract: float32 parameters; under 'mixed' a float32 image
    # and float32 scores, under 'bfloat16' both half width
    want = torch.float32 if dtype == 'mixed' else torch.bfloat16
    assert tdt == want and str(jdt) == str(want).removeprefix('torch.')
    assert all(p.dtype == torch.float32 for p in mod.parameters())

    assert rel_l2([ty], [jy]) <= rel_l2([jy], [ry]), (rel_l2([ty], [jy]), rel_l2([jy], [ry]))
    # gradients: where the two round at the same points (the packed
    # layout under 'mixed'), as far as the JAX package's own bfloat16
    # error; where they cannot, twice that (two independent roundings of
    # one size lie about sqrt(2) of it apart): the unpacked blocks' K1
    # keeps the LeakyReLU in float32 where JAX's composed mixed epilogue
    # rounds it, and in 'bfloat16' every backward op rounds, at points
    # that autodiff places differently in the two frameworks
    same_points = layout == 'packed' and dtype == 'mixed'
    bound = (1.0 if same_points else 2.0) * rel_l2(jg, rg)
    assert rel_l2(tg, jg) <= bound, (rel_l2(tg, jg), rel_l2(jg, rg))
    if dtype == 'bfloat16':
        return     # test_mixed_precision.py's bounds are the mixed recipe's
    err = np.abs(ty - jy)
    if net == 'G':
        assert err.max() < 0.15 and err.mean() < 0.02, (err.max(), err.mean())
    else:
        assert err.max() / max(1.0, np.abs(jy).max()) < 0.05, err.max()


def test_config_routes_like_jax():
    # the auto rule and the overrides resolve as in the JAX package
    for kw in (dict(), dict(precision=None), dict(fuse_up2_conv=True),
               dict(precision=None, fuse_pool_conv=False),
               dict(compute_dtype='mixed'), dict(compute_dtype='bfloat16')):
        j, t = JPGConfig(**PACKED_ARCH, **kw), PGConfig(**PACKED_ARCH, **kw)
        assert (t.fused_up2, t.fused_pool, t.mixed) == (j.fused_up2, j.fused_pool, j.mixed)
        assert str(t.dtype).removeprefix('torch.') == str(j.dtype)


# ---------------------------------------------------------------------------
# the fused packed conv pair's plain versions in bfloat16
# ---------------------------------------------------------------------------

def bf16_case(c=4, h=8, w=8, seed=0):
    x = jnp.asarray(rand((2, h, w, 4 * c), seed)).astype(jnp.bfloat16)
    wp = np.asarray(jpk.pack_conv3x3_weight(jnp.asarray(rand((3, 3, c, c), seed + 1, 0.3)), 0.7))
    return x, wp


def torch_bf16(a):
    """A bfloat16 JAX array as the port's NCHW bfloat16 tensor (exact)."""
    return nchw(f32(a)).bfloat16()


def assert_within_ulps(got, want, n=2):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=n * bf16_ulp(np.abs(want).max()))


@pytest.mark.parametrize('c,h,w', [(4, 8, 8), (8, 6, 10)])
def test_fused_conv_plain_bf16_matches_pallas(c, h, w):
    x, wp = bf16_case(c, h, w, seed=c + h)
    jy, jr = _call_fwd(x, jnp.asarray(wp), 0.2, 1e-8, True)
    assert jy.dtype == jnp.bfloat16 and jr.dtype == jnp.float32
    ty, tr = pcl.PackedConvLReluPN.apply(torch_bf16(x), oihw(wp), 0.2, 1e-8)
    assert ty.dtype == torch.bfloat16 and tr.dtype == torch.float32
    assert_within_ulps(nhwc(ty.float()), f32(jy))
    assert_within_ulps(r_as_jax(tr), np.asarray(jr))


def test_dz_plain_bf16_matches_pallas():
    y = jnp.asarray(rand((2, 4, 6, 16), 23)).astype(jnp.bfloat16)
    g = jnp.asarray(rand((2, 4, 6, 16), 24)).astype(jnp.bfloat16)
    r = (0.5 + np.random.default_rng(25).random((2, 24, 4))).astype(np.float32)
    ct_r = rand((2, 24, 4), 26)
    jdz = _dz_call(y, jnp.asarray(r), g, jnp.asarray(ct_r), 0.2, 1e-8, True)
    assert jdz.dtype == jnp.bfloat16

    def r_nchw(a):
        return torch.from_numpy(a.reshape(2, 4, 6, 4).transpose(0, 3, 1, 2).copy())

    tdz = pcl.Dz.apply(torch_bf16(y), r_nchw(r), torch_bf16(g), r_nchw(ct_r), 0.2)
    assert tdz.dtype == torch.bfloat16
    assert_within_ulps(nhwc(tdz.float()), f32(jdz))


@pytest.mark.parametrize('n', pcl.KERNEL_WIDTHS)
def test_dz_sliced_bf16_tracks_pallas(n):
    # the dz kernel's order of summation in bfloat16: no further from the
    # interpreted Pallas kernel in bfloat16 than that lies from itself in
    # float32 on the same inputs, ct_r live and absent
    h, w = 5, 8
    y = jnp.asarray(rand((2, h, w, n), 100 + n)).astype(jnp.bfloat16)
    g = jnp.asarray(rand((2, h, w, n), 101 + n)).astype(jnp.bfloat16)
    r = (0.5 + np.random.default_rng(102 + n).random((2, h * w, 4))).astype(np.float32)

    def r_nchw(a):
        return torch.from_numpy(a.reshape(2, h, w, 4).transpose(0, 3, 1, 2).copy())

    for ct_r in (rand((2, h * w, 4), 103 + n), None):
        jct = jnp.asarray(np.zeros_like(r) if ct_r is None else ct_r)
        want = _dz_call(y, jnp.asarray(r), g, jct, 0.2, 1e-8, True)
        ref = _dz_call(y.astype(jnp.float32), jnp.asarray(r), g.astype(jnp.float32), jct,
                       0.2, 1e-8, True)
        got = pcl.packed_dz_sliced(torch_bf16(y), r_nchw(r), torch_bf16(g),
                                   None if ct_r is None else r_nchw(ct_r))
        assert got.dtype == torch.bfloat16
        dist, own = rel_l2([nhwc(got.float())], [f32(want)]), rel_l2([f32(want)], [f32(ref)])
        assert 0 < own and dist <= own, (dist, own)


def test_fused_conv_bf16_absent_ct_r_equals_explicit_zeros():
    x, wp = bf16_case(seed=104)
    ct_y = torch_bf16(jnp.asarray(rand((2, 8, 8, 16), 105)).astype(jnp.bfloat16))
    grads = []
    for explicit in (False, True):
        xt, wt = torch_bf16(x).requires_grad_(), oihw(wp).requires_grad_()
        y, r = pcl.PackedConvLReluPN.apply(xt, wt, 0.2, 1e-8)
        outs, cts = ((y, r), (ct_y, torch.zeros_like(r))) if explicit else ((y,), (ct_y,))
        grads.append(torch.autograd.grad(outs, (xt, wt), cts))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fused_conv_gp_second_order_bf16_tracks_pallas():
    # the GP-style second order of tests/test_torch_packed.py in bfloat16:
    # the port no further from JAX-bf16 than JAX-bf16 from JAX-float32
    x, wp = bf16_case(seed=41)
    c = rand((2, 8, 8, 16), 42, 0.1)
    s0 = (0.5 + np.random.default_rng(40).random(16)).astype(np.float32)

    def jax_gp(xx, dtype):
        def gp(s, w):
            def score(xi):
                y = _fused_pair((xi * s).astype(dtype), w, 0.2, 1e-8, True)[0]
                return jnp.sum(y.astype(jnp.float32) * c)
            gx = jax.grad(score)(xx)
            return jnp.sum((jnp.sqrt(jnp.sum(gx ** 2, axis=(1, 2, 3))) - 1.0) ** 2)
        return [f32(v) for v in jax.grad(gp, argnums=(0, 1))(jnp.asarray(s0), jnp.asarray(wp))]

    xf = jnp.asarray(f32(x))
    want, ref = jax_gp(xf, jnp.bfloat16), jax_gp(xf, jnp.float32)
    s = torch.from_numpy(s0.reshape(1, -1, 1, 1).copy()).requires_grad_()
    w = oihw(wp).requires_grad_()
    xt = nchw(f32(x)).requires_grad_()
    y = pcl.PackedConvLReluPN.apply((xt * s).bfloat16(), w, 0.2, 1e-8)[0]
    gx, = torch.autograd.grad((y.float() * nchw(c)).sum(), xt, create_graph=True)
    loss = ((gx.pow(2).sum(dim=(1, 2, 3)).sqrt() - 1.0) ** 2).sum()
    gs, gw = torch.autograd.grad(loss, (s, w))
    got = [gs.numpy().reshape(-1), hwio(gw)]
    assert np.abs(want[0]).max() > 1.0                 # not rounding noise
    assert rel_l2(got, want) <= rel_l2(want, ref), (rel_l2(got, want), rel_l2(want, ref))


# ---------------------------------------------------------------------------
# one mixed packed batch step against the JAX package
# ---------------------------------------------------------------------------

def test_mixed_packed_batch_step_tracks_jax(packed_params):
    from test_torch_train_step import (
        PACKED_FRAME, PACKED_SPEC, jax_batch_draws, port_state, grads_of)
    from neuron_gan_tpu import losses as jl
    from neuron_gan_tpu.data.augment import (
        AugmentSpec as JAugmentSpec, augment_batch as j_augment_batch)
    from neuron_gan_tpu_torch import train_step as tts
    from neuron_gan_tpu_torch.convert import to_jax_tree

    jcfg, tcfg = configs(PACKED_ARCH, 'mixed')
    j32, _ = configs(PACKED_ARCH, 'float32')
    spec, frame = dict(PACKED_SPEC), PACKED_FRAME
    raw = np.random.default_rng(0).random((2, frame, frame, 1)).astype(np.float32)
    k_batch = jax.random.PRNGKey(3)
    alpha, phase = 0.5, spec['phase']
    draws = jax_batch_draws(k_batch, spec, 2, frame)

    state = port_state(packed_params, spec, tcfg)
    tts.make_batch_step(tcfg, tts.ChunkSpec(**spec))(
        state, torch.from_numpy(raw), draws, alpha, 1e-3, 0.0)
    assert all(p.dtype == torch.float32 for p in state.d.parameters())
    t_d = [f32(v) for v in jax.tree.leaves(grads_of(state.d))]
    t_g = [f32(v) for v in jax.tree.leaves(grads_of(state.g))]
    d_after = to_jax_tree(state.d)

    images = j_augment_batch(jnp.asarray(raw), jax.random.fold_in(k_batch, 0),
                             JAugmentSpec(crop_size=spec['crop_size'],
                                          out_size=jcfg.resolution(phase),
                                          translation=0.05))
    z1, z2, eps = (jnp.asarray(v.numpy()) for v in draws['critic'][0])
    zg = jnp.asarray(draws['zg'].numpy())

    def jax_grads(cfg):
        g_apply = lambda p, z: generator_pg(p, z, cfg, phase, alpha)  # noqa: E731
        d_apply = lambda p, x: discriminator_pg(p, x, cfg, phase, alpha)  # noqa: E731
        g0, d0 = packed_params

        def d_total(dp):
            loss_w, _ = jl.d_w_loss(d_apply, g_apply, dp, g0, images, z1, 0.001)
            fake = jax.lax.stop_gradient(g_apply(g0, z2))
            return loss_w + jl.d_grad_pen_loss(d_apply, dp, images, fake, eps, 10.0)

        dg = jax.jit(jax.grad(d_total))(d0)
        gg = jax.jit(jax.grad(lambda gp: jl.g_w_loss(
            g_apply, d_apply, gp, d_after, zg)[0]))(g0)
        return ([f32(v) for v in jax.tree.leaves(dg)],
                [f32(v) for v in jax.tree.leaves(gg)])

    # a step's gradients pass the GP's double backward, whose bfloat16
    # roundings autodiff places differently in the two frameworks: held
    # within twice the JAX package's own bfloat16 distance (two independent
    # roundings of one size lie about sqrt(2) of it apart), from its mixed
    # and from its float32 run
    (j_d, j_g), (r_d, r_g) = jax_grads(jcfg), jax_grads(j32)
    for got, want, ref in ((t_d, j_d, r_d), (t_g, j_g, r_g)):
        bound = 2 * rel_l2(want, ref)
        assert rel_l2(got, want) <= bound, (rel_l2(got, want), bound)
        assert rel_l2(got, ref) <= bound, (rel_l2(got, ref), bound)


def test_mixed_train_runs_on_cpu_with_float32_master_weights():
    # 'mixed' and 'bfloat16' train when asked for the CPU; parameters and
    # Adam state stay float32 and move (the JAX package's
    # tests/test_mixed_precision.py::test_mixed_train_step_learns_and_stays_finite)
    from test_torch_train_step import PACKED_SPEC
    from neuron_gan_tpu_torch import train_step as tts
    for dtype in ('mixed', 'bfloat16'):
        _, cfg = configs(PACKED_ARCH, dtype)
        rng = torch.Generator().manual_seed(0)
        state = tts.init_train_state(GeneratorPG(cfg, rng, device='cpu'),
                                     DiscriminatorPG(cfg, rng, device='cpu'))
        w0 = state.g.stem['conv'].weight.detach().clone()
        d0 = state.d.head['conv'].weight.detach().clone()
        spec = tts.ChunkSpec(**dict(PACKED_SPEC, n_images=4))
        images = torch.rand(4, 96, 96, 1, generator=torch.Generator().manual_seed(1))
        stats = tts.make_epoch_runner(cfg, spec, 2)(
            state, images, torch.Generator().manual_seed(2), 1)
        assert stats.shape == (2, len(tts.STAT_NAMES)) and torch.isfinite(stats).all()
        for opt in (state.g_opt, state.d_opt):
            for st in opt.state.values():
                assert st['exp_avg'].dtype == st['exp_avg_sq'].dtype == torch.float32
        assert not torch.equal(w0, state.g.stem['conv'].weight)
        assert not torch.equal(d0, state.d.head['conv'].weight)


def test_mixed_losses_reduce_in_float32_and_interpolate_images_in_float32():
    # the JAX package's losses.py: scores and the GP's norm reduce in
    # float32 and the GP interpolates in the images' dtype (float32); the
    # critic casts its input to bfloat16 itself
    from neuron_gan_tpu_torch import losses
    _, cfg = configs(PACKED_ARCH, 'mixed')
    rng = torch.Generator().manual_seed(0)
    g = GeneratorPG(cfg, rng, device='cpu')
    d = DiscriminatorPG(cfg, rng, device='cpu')
    seen = []

    def d_apply(x):
        seen.append(x.dtype)
        return d(x, 1)

    real = torch.rand(2, 1, 32, 32) * 2 - 1
    fake = g(torch.randn(2, 8), 1).detach()
    assert fake.dtype == torch.float32
    gp = losses.d_grad_pen_loss(d_apply, real, fake, torch.rand(2), 10.0)
    loss, (sr, sf) = losses.d_w_loss(d_apply, real, g(torch.randn(2, 8), 1),
                                     0.001)
    assert seen == [torch.float32] * 3
    assert gp.dtype == loss.dtype == sr.dtype == sf.dtype == torch.float32
    assert torch.isfinite(gp) and torch.isfinite(loss)
