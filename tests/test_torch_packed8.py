"""The port's 2x4 packed layout (``packed_lanes=128``) against the JAX
package, on the CPU: its ops, the 8-group epilogue and G and D.

Inputs are numpy arrays from a seed, handed to both sides; JAX runs NHWC
float32, the port NCHW float32 (its kernel Functions take their plain
versions here).  Tolerances.  Layout moves and weight scatters: exact.
The 2x4 convs and boundaries at 'highest': rtol 1e-5 / atol 1e-5 on
outputs (tests/test_packed.py's; sums of up to 16*8*Ci products in
another order), gradients rtol 1e-4 with atol 1e-5 times the tensor's
largest magnitude.  The 8-group epilogue: rtol 1e-5 / atol 1e-6 forward,
1e-4 / 1e-5 backward (tests/test_torch_ops.py's K1/K2 bounds).  G and D:
tests/test_torch_models.py's (rtol 1e-4 / atol 1e-5 outputs, gradients
scale-relative).  The shipping step on this layout:
tests/test_torch_shipping.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuron_gan_tpu.models import (
    PGConfig as JPGConfig, init_discriminator_pg, init_generator_pg)
from neuron_gan_tpu.ops import leaky_relu as j_leaky_relu
from neuron_gan_tpu.ops import packed as jpk
from neuron_gan_tpu.ops.pallas_kernels import grouped_lrelu_pixel_norm_pallas

import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn
from neuron_gan_tpu_torch.models import PGConfig
from neuron_gan_tpu_torch.ops import equalized_conv2d, upsample2_bilinear
from neuron_gan_tpu_torch.ops import packed as tpk
from neuron_gan_tpu_torch.runtime import precision_scope

from test_torch_models import port_models
from test_torch_packed import hwio, nchw, nhwc, oihw, rand

OUT = dict(rtol=1e-5, atol=1e-5)
# 4^2 .. 32^2: G block 0 (32 channels at 8^2) in the 2x2 layout, blocks 1
# and 2 (16 channels) in the 2x4 one; D from_rgb and block 0 in the 2x4
# layout, block 1 leaving it into the 2x2 layout, block 2 unpacked --
# every kind of block of the shipping flagship
ARCH8 = dict(n_gen_features=(32, 32, 16, 16), n_dis_features=(16, 16, 32, 32),
             latent_dim=8, image_size_init=4, packed_min_res=8,
             packed_lanes=128)
CASES = [(1, None), (2, None), (3, None), (2, 0.4), (3, 0.4)]


def grad_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


def jax_and_port(jfn, tfn, x, params, cot):
    """Outputs and input/parameter gradients of a JAX op (NHWC, HWIO
    params) and the port's (NCHW, OIHW) on the same numbers."""
    def loss(x, p):
        y = jfn(x, p)
        return jnp.sum(y * cot), y

    (_, jy), (jgx, jgp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
    xt = nchw(x).requires_grad_()
    wt = oihw(params['w']).requires_grad_()
    bt = torch.from_numpy(params['b']).requires_grad_() if 'b' in params else None
    with precision_scope('highest'):
        ty = tfn(xt, wt, bt)
        (ty * nchw(cot)).sum().backward()
    return (jy, jgx, jgp), (ty, xt.grad, wt.grad, bt)


def assert_op_close(j, t):
    (jy, jgx, jgp), (ty, gx, gw, bt) = j, t
    np.testing.assert_allclose(nhwc(ty), np.asarray(jy), **OUT)
    grad_close(nhwc(gx), np.asarray(jgx))
    grad_close(hwio(gw), np.asarray(jgp['w']))
    if bt is not None:
        grad_close(bt.grad.numpy(), np.asarray(jgp['b']))


# ---------------------------------------------------------------------------
# layout moves and weight scatters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape', [(2, 4, 8, 12), (1, 2, 4, 8), (3, 6, 16, 8)])
def test_space_to_depth8_and_w_match_jax_and_round_trip(shape):
    x = rand(shape, sum(shape))                    # NHWC
    xt = nchw(x)
    np.testing.assert_array_equal(nhwc(tpk.space_to_depth_w(xt)),
                                  np.asarray(jpk.space_to_depth_w(jnp.asarray(x))))
    np.testing.assert_array_equal(nhwc(tpk.space_to_depth8(xt)),
                                  np.asarray(jpk.space_to_depth8(jnp.asarray(x))))
    assert torch.equal(tpk.space_to_depth8(xt),
                       tpk.space_to_depth_w(tpk.space_to_depth(xt)))
    assert torch.equal(tpk.depth_to_space_w(tpk.space_to_depth_w(xt)), xt)
    assert torch.equal(tpk.depth_to_space8(tpk.space_to_depth8(xt)), xt)
    y = rand((2, 3, 5, 8 * 4), 7)                  # a 2x4 tensor, NHWC
    np.testing.assert_array_equal(nhwc(tpk.depth_to_space8(nchw(y))),
                                  np.asarray(jpk.depth_to_space8(jnp.asarray(y))))


@pytest.mark.parametrize('name', ['pack_w', 'pool_w8', 'pool_w8_out4', 'up2_w8'])
def test_weight_scatters_match_jax(name):
    w = rand((3, 3, 3, 5), 11)                     # HWIO (Ci 3, Co 5)
    if name == 'pack_w':
        w4 = jpk.pack_conv3x3_weight(jnp.asarray(w), 0.7)
        want = jpk.pack_conv3x3_weight_w(w4)
        got = tpk.pack_conv3x3_weight_w(tpk.pack_conv3x3_weight(oihw(w), 0.7))
    else:
        jfn, tfn = {'pool_w8': (jpk.fuse_pool2_conv3x3_weight_w8,
                                tpk.fuse_pool2_conv3x3_weight_w8),
                    'pool_w8_out4': (jpk.fuse_pool2_conv3x3_weight_w8_out4,
                                     tpk.fuse_pool2_conv3x3_weight_w8_out4),
                    'up2_w8': (jpk.fuse_up2_conv3x3_weight_w8,
                               tpk.fuse_up2_conv3x3_weight_w8)}[name]
        want, got = jfn(jnp.asarray(w), 0.7), tfn(oihw(w), 0.7)
    if name == 'up2_w8':
        # a scatter of fuse_up2_conv3x3_weight, whose tap composition
        # sums in another order than JAX's three-operand einsum
        np.testing.assert_allclose(hwio(got), np.asarray(want), rtol=1e-6, atol=1e-7)
        return
    np.testing.assert_array_equal(hwio(got), np.asarray(want))


# ---------------------------------------------------------------------------
# the 2x4 ops against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('bias', [False, True])
@pytest.mark.parametrize('h,w', [(4, 4), (3, 6), (8, 2)])
def test_packed8_conv3x3_matches_jax(bias, h, w):
    ci, co = 3, 5
    x = rand((2, h, w, 8 * ci), 20 + h)
    params = {'w': rand((3, 3, ci, co), 21)}
    if bias:
        params['b'] = rand((co,), 22)
    cot = rand((2, h, w, 8 * co), 23)
    assert_op_close(*jax_and_port(
        lambda x, p: jpk.packed8_equalized_conv3x3(x, p, precision='highest'),
        lambda x, w, b: tpk.packed8_equalized_conv3x3(x, w, b), x, params, cot))


def test_packed8_conv3x3_is_the_unpacked_conv():
    x = torch.from_numpy(rand((2, 5, 8, 16), 24))
    w = torch.from_numpy(rand((7, 5, 3, 3), 25))
    with precision_scope('highest'):
        want = equalized_conv2d(x, w, padding=1)
        got = tpk.depth_to_space8(tpk.packed8_equalized_conv3x3(tpk.space_to_depth8(x), w))
    torch.testing.assert_close(got, want, **OUT)


@pytest.mark.parametrize('bias', [False, True])
def test_packed8_conv1x1_matches_jax(bias):
    x = rand((2, 3, 4, 8 * 4), 30)
    params = {'w': rand((1, 1, 4, 2), 31)}
    if bias:
        params['b'] = rand((2,), 32)
    cot = rand((2, 3, 4, 16), 33)
    assert_op_close(*jax_and_port(
        lambda x, p: jpk.packed8_conv1x1(x, p, precision='highest'),
        lambda x, w, b: tpk.packed8_conv1x1(x, w, b), x, params, cot))


@pytest.mark.parametrize('c', [2, 16])
def test_packed8_pixel_norm_matches_jax(c):
    x = rand((2, 3, 4, 8 * c), 40 + c)
    g = rand((2, 3, 4, 8 * c), 41)
    jy, vjp = jax.vjp(jpk.packed8_pixel_norm, jnp.asarray(x))
    xt = nchw(x).requires_grad_()
    ty = tpk.packed_pixel_norm(xt, n_groups=8)
    ty.backward(nchw(g))
    np.testing.assert_allclose(nhwc(ty), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-4, atol=1e-5)
    # the JAX fast path's same-group dot computes the same function
    np.testing.assert_allclose(nhwc(ty), np.asarray(jpk.packed8_pixel_norm_mxu(
        jnp.asarray(x))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('out_packed8', [True, False])
@pytest.mark.parametrize('bias', [False, True])
def test_pool2_conv_p8_matches_jax(out_packed8, bias):
    ci, co = 3, 5
    x = rand((2, 8, 4, 8 * ci), 50)                # the 2x4 rep of 16^2
    params = {'w': rand((3, 3, ci, co), 51)}
    if bias:
        params['b'] = rand((co,), 52)
    out_shape = (2, 4, 2, 8 * co) if out_packed8 else (2, 4, 4, 4 * co)
    cot = rand(out_shape, 53)
    j, t = jax_and_port(
        lambda x, p: jpk.pool2_equalized_conv3x3_p8(
            x, p, precision='highest', out_packed8=out_packed8),
        lambda x, w, b: tpk.pool2_equalized_conv3x3_p8(
            x, w, b, out_packed8=out_packed8), x, params, cot)
    assert tuple(t[0].shape) == (out_shape[0], out_shape[3], *out_shape[1:3])
    assert_op_close(j, t)
    # the 2x2 fused boundary's function on the repacked operands
    with precision_scope('highest'):
        want = tpk.pool2_equalized_conv3x3(
            tpk.depth_to_space_w(nchw(x)), oihw(params['w']), t[3])
    got = tpk.depth_to_space_w(t[0]) if out_packed8 else t[0]
    torch.testing.assert_close(got.detach(), want.detach(), **OUT)


@pytest.mark.parametrize('n,ci,co', [(2, 3, 5), (4, 3, 5), (8, 5, 7), (6, 2, 4)])
def test_up2_conv_p8_matches_jax(n, ci, co):
    x = rand((2, n, n, ci), 60 + n)
    params = {'w': rand((3, 3, ci, co), 61)}
    cot = rand((2, n, n // 2, 8 * co), 62)
    j, t = jax_and_port(
        lambda x, p: jpk.up2_equalized_conv3x3_p8(x, p, precision='highest'),
        lambda x, w, b: tpk.up2_equalized_conv3x3_p8(x, w), x, params, cot)
    assert_op_close(j, t)
    # the 2x2 fused up-conv repacked (its bands are the same expressions)
    # and the decomposed chain
    xt, wt = nchw(x), oihw(params['w'])
    with precision_scope('highest'):
        repacked = tpk.space_to_depth_w(tpk.up2_equalized_conv3x3(xt, wt))
        chain = tpk.space_to_depth8(equalized_conv2d(upsample2_bilinear(xt), wt,
                                                     padding=1))
    torch.testing.assert_close(t[0].detach(), repacked, rtol=0, atol=0)
    torch.testing.assert_close(t[0].detach(), chain, **OUT)


def test_up2_conv_p8_refuses_other_inputs():
    with pytest.raises(ValueError, match='even side'):
        tpk.up2_equalized_conv3x3_p8(torch.zeros(1, 3, 6, 8), torch.zeros(5, 3, 3, 3))
    with pytest.raises(ValueError, match='even side'):
        tpk.up2_equalized_conv3x3_p8(torch.zeros(1, 3, 5, 5), torch.zeros(5, 3, 3, 3))


# ---------------------------------------------------------------------------
# the 8-group epilogue: K1/K2's plain and sliced versions at 8 groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('c', [2, 16])
def test_epilogue_at_8_groups_matches_pallas_and_composed_ops(c):
    x = rand((2, 3, 4, 8 * c), 70 + c)
    g = rand((2, 3, 4, 8 * c), 71)
    pallas = lambda v: grouped_lrelu_pixel_norm_pallas(v, 8, 0.2, 1e-8, True)  # noqa: E731
    jy, vjp = jax.vjp(pallas, jnp.asarray(x))
    jdx = np.asarray(vjp(jnp.asarray(g))[0])
    composed = np.asarray(jpk.packed8_pixel_norm(j_leaky_relu(jnp.asarray(x), 0.2)))
    xt = nchw(x).requires_grad_()
    ty = lpn.lrelu_pixel_norm(xt, 8)
    ty.backward(nchw(g))
    for got in (ty.detach(), lpn.lrelu_pixel_norm_sliced(nchw(x), 8)):
        np.testing.assert_allclose(nhwc(got), np.asarray(jy), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(nhwc(got), composed, rtol=1e-5, atol=1e-6)
    for got in (xt.grad, lpn.lrelu_pixel_norm_bwd_sliced(nchw(x), nchw(g), 8)):
        np.testing.assert_allclose(nhwc(got), jdx, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# G and D at packed_lanes=128 against the JAX package
# ---------------------------------------------------------------------------

ROUTES = {
    # the native 2x4 region at the fused boundaries (precision=None)
    'native': dict(precision=None),
    # the decomposed 'highest' parity path: a 2x4 block tail repacked
    # around the 2x2 layout
    'sandwich': dict(precision='highest'),
}


@pytest.fixture(scope='module')
def params8():
    kg, kd = jax.random.split(jax.random.PRNGKey(8))
    jcfg = JPGConfig(**ARCH8)
    return (jax.tree.map(np.asarray, init_generator_pg(kg, jcfg)),
            jax.tree.map(np.asarray, init_discriminator_pg(kd, jcfg)))


def test_routes_are_the_jax_routes():
    # the predicates pick the layouts the JAX package picks
    from neuron_gan_tpu.models import pggan as jm
    from neuron_gan_tpu_torch.models import pggan as tm
    for kw in (*ROUTES.values(), dict(precision=None, packed_lanes=64),
               dict(precision=None, packed_lanes=None)):
        j, t = JPGConfig(**dict(ARCH8, **kw)), PGConfig(**dict(ARCH8, **kw))
        for res in (4, 8, 16, 32, 64, 24):
            for feat in (8, 16, 32):
                assert tm._want_packed8_g(t, res, feat) == jm._want_packed8_g(j, res, feat)
                assert tm._want_packed8_d(t, res, feat) == jm._want_packed8_d(j, res, feat)
        for c4, w in ((64, 8), (64, 6), (128, 8), (32, 8)):
            assert (tm._use_packed8(t, torch.zeros(1, c4, 2, w))
                    == jm._use_packed8(j, jnp.zeros((1, 2, w, c4))))
    with pytest.raises(ValueError, match='packed_lanes'):
        PGConfig(**dict(ARCH8, packed_lanes=96))


@pytest.mark.parametrize('phase,alpha', CASES)
@pytest.mark.parametrize('route', list(ROUTES))
@pytest.mark.parametrize('net', ['G', 'D'])
def test_packed_lanes_128_nets_match_jax(params8, net, route, phase, alpha):
    from test_torch_mixed import jax_net, net_inputs, port_net
    jcfg = JPGConfig(**dict(ARCH8, **ROUTES[route]))
    tcfg = PGConfig(**dict(ARCH8, **ROUTES[route]), use_kernels=True)
    assert tcfg.fused_up2 == tcfg.fused_pool == (route == 'native')
    inp, cot = net_inputs(net, jcfg, phase, 80 + phase)
    jy, _, jg = jax_net(net, params8[net == 'D'], jcfg, inp, cot, phase, alpha)
    ty, _, tg = port_net(net, port_models(params8, tcfg)[net == 'D'], inp, cot,
                         phase, alpha)
    np.testing.assert_allclose(ty, jy, rtol=1e-4, atol=1e-5)
    for a, b in zip(tg, jg):
        grad_close(a, b)


def test_native_region_blocks_hand_on_p8():
    # G blocks 1-2 and D's from_rgb and block 0 live in the 2x4 layout;
    # D block 1 leaves it into the 2x2 layout
    cfg = PGConfig(**ARCH8, precision=None)
    g, d = port_models(jax.tree.map(np.asarray, (
        init_generator_pg(jax.random.PRNGKey(0), JPGConfig(**ARCH8)),
        init_discriminator_pg(jax.random.PRNGKey(1), JPGConfig(**ARCH8)))), cfg)
    x, packed, states = g._stem(torch.zeros(2, 8)), False, []
    for i in range(3):
        x, packed = g._block(x, packed, i)
        states.append(packed)
    assert states == [True, 'p8', 'p8'] and tuple(x.shape) == (2, 128, 16, 8)
    y, packed = d._from_rgb(torch.zeros(2, 1, 32, 32), 32, 0)
    states = [packed]
    for i, res in ((0, 32), (1, 16), (2, 8)):
        y, packed = d._block(y, packed, i, res)
        states.append(packed)
    assert states == ['p8', 'p8', True, False]
