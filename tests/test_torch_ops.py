"""The port's ops and its fused epilogue against the JAX package, on the CPU.

Inputs are numpy arrays from a seed, handed to both sides; JAX runs NHWC
float32 at 'highest' precision, the port NCHW float32.  The epilogue is
held against the JAX package's Pallas kernel run interpreted, at the
tolerances of tests/test_pallas_kernels.py (rtol 1e-5 / atol 1e-6 forward,
1e-4 / 1e-5 for gradients).
"""

import collections

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuron_gan_tpu import ops as jops
from neuron_gan_tpu.ops.pallas_kernels import (
    _bwd_call, grouped_lrelu_pixel_norm_pallas)

from neuron_gan_tpu_torch import ops as tops
import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn
from neuron_gan_tpu_torch.ops.pixelnorm import lrelu_pixel_norm as composed_lrelu_pn


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# ops/equalized.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('nonlin,param', [('leaky_relu', 0.2), ('leaky_relu', 0.1),
                                          ('linear', None), ('relu', None),
                                          ('tanh', None)])
def test_calculate_gain(nonlin, param):
    kw = {} if param is None else {'param': param}
    assert tops.calculate_gain(nonlin, **kw) == pytest.approx(
        jops.calculate_gain(nonlin, **kw), rel=1e-12)


@pytest.mark.parametrize('k,padding,bias', [(3, 1, False), (3, 1, True),
                                            (4, 0, True), (1, 0, False)])
def test_equalized_conv2d_forward_and_grad(k, padding, bias):
    x = rand((2, 8, 8, 6), 0)
    w = rand((k, k, 6, 5), 1)
    b = rand((5,), 2)
    cot = rand((2, 8 - k + 1 + 2 * padding, 8 - k + 1 + 2 * padding, 5), 3)

    def jf(x, w, b):
        p = {'w': w, 'b': b} if bias else {'w': w}
        y = jops.equalized_conv2d(x, p, padding=padding, precision='highest')
        return jnp.sum(y * cot), y

    (_, jy), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt = nchw(x).requires_grad_()
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    ty = tops.equalized_conv2d(xt, wt, bt if bias else None, padding=padding)
    (ty * nchw(cot)).sum().backward()
    np.testing.assert_allclose(nhwc(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jg[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(jg[1]), rtol=1e-5, atol=1e-5)
    if bias:
        np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jg[2]),
                                   rtol=1e-5, atol=1e-5)


def test_plain_conv2d_matches():
    x = rand((2, 5, 5, 3), 4)
    w = rand((1, 1, 3, 4), 5)
    b = rand((4,), 6)
    jy = jops.conv2d(jnp.asarray(x), {'w': jnp.asarray(w), 'b': jnp.asarray(b)},
                     padding=0, precision='highest')
    ty = tops.conv2d(nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                     torch.from_numpy(b))
    np.testing.assert_allclose(nhwc(ty), np.asarray(jy), rtol=1e-6, atol=1e-6)


def test_equalized_linear_forward_and_grad():
    x, w = rand((3, 8), 7), rand((8, 12), 8)
    cot = rand((3, 12), 9)
    jy, jg = jax.value_and_grad(
        lambda x, w: jnp.sum(jops.equalized_linear(x, {'w': w},
                                                   precision='highest') * cot),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w.T.copy()).requires_grad_()
    ty = (tops.equalized_linear(xt, wt) * torch.from_numpy(cot)).sum()
    ty.backward()
    np.testing.assert_allclose(ty.item(), float(jy), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy().T, np.asarray(jg[1]), rtol=1e-5, atol=1e-6)


def test_kaiming_init_stds():
    rng = torch.Generator().manual_seed(0)
    w = tops.init_conv2d(16, 32, 3, generator=rng, neg_slope=0.2)
    assert w.shape == (32, 16, 3, 3)
    std = tops.calculate_gain('leaky_relu', 0.2) / np.sqrt(16 * 9)
    assert float(w.std()) == pytest.approx(std, rel=0.05)
    lin = tops.init_linear(64, 256, generator=rng)
    assert lin.shape == (256, 64)
    assert float(lin.std()) == pytest.approx(
        tops.calculate_gain('leaky_relu', 0.2) / 8.0, rel=0.05)


# ---------------------------------------------------------------------------
# ops/pixelnorm.py
# ---------------------------------------------------------------------------

def test_leaky_relu_gradient_at_zero_is_one():
    # JAX's where(x >= 0, ...) gives 1 at exactly 0; F.leaky_relu gives slope
    x = np.array([[-1.0, 0.0, 2.0]], np.float32)
    jg = jax.grad(lambda x: jnp.sum(jops.leaky_relu(x, 0.2)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tops.leaky_relu(xt, 0.2).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    assert xt.grad[0, 1] == 1.0


@pytest.mark.parametrize('f32_stats', [False, True])
def test_lrelu_pixel_norm_forward_and_grad(f32_stats):
    x = rand((2, 4, 4, 8), 10)
    cot = rand((2, 4, 4, 8), 11)
    jy, jg = jax.value_and_grad(
        lambda x: jnp.sum(jops.lrelu_pixel_norm(x, 0.2, 1e-8, f32_stats) * cot))(
            jnp.asarray(x))
    xt = nchw(x).requires_grad_()
    ty = (composed_lrelu_pn(xt, 0.2, 1e-8, f32_stats) * nchw(cot)).sum()
    ty.backward()
    np.testing.assert_allclose(ty.item(), float(jy), rtol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jg), rtol=1e-4, atol=1e-5)


def test_pixel_norm_f32_stats_bfloat16():
    x = rand((2, 3, 3, 16), 12)
    jy = jops.pixel_norm(jnp.asarray(x).astype(jnp.bfloat16), f32_stats=True)
    ty = tops.pixel_norm(nchw(x).to(torch.bfloat16), f32_stats=True)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(ty.float()), np.asarray(jy, np.float32),
                               rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# ops/resize.py and ops/fadein.py
# ---------------------------------------------------------------------------

def test_upsample2_bilinear_forward_and_grad():
    x = rand((2, 5, 6, 3), 13)
    cot = rand((2, 10, 12, 3), 14)
    jy, jg = jax.value_and_grad(
        lambda x: jnp.sum(jops.upsample2_bilinear(x) * cot))(jnp.asarray(x))
    xt = nchw(x).requires_grad_()
    ty = tops.upsample2_bilinear(xt)
    np.testing.assert_allclose(nhwc(ty), np.asarray(jops.upsample2_bilinear(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    (ty * nchw(cot)).sum().backward()
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jg), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('k', [2, 4])
def test_avg_pool_and_downsample(k):
    x = rand((2, 8, 8, 3), 15)
    np.testing.assert_allclose(nhwc(tops.avg_pool(nchw(x), k)),
                               np.asarray(jops.avg_pool(jnp.asarray(x), k)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(nhwc(tops.downsample2_bilinear(nchw(x))),
                               np.asarray(jops.downsample2_bilinear(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_avg_pool_rejects_indivisible():
    with pytest.raises(ValueError):
        tops.avg_pool(torch.zeros(1, 1, 5, 4), 2)


@pytest.mark.parametrize('in_size,out_size', [(48, 16), (32, 8), (24, 24),
                                              (16, 32), (30, 7)])
def test_resize_antialias(in_size, out_size):
    x = rand((2, in_size, in_size, 1), 16)
    np.testing.assert_allclose(
        nhwc(tops.resize_antialias(nchw(x), out_size)),
        np.asarray(jops.resize_antialias(jnp.asarray(x), out_size)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('out_size', [5, 16, 3])
def test_resize_nearest(out_size):
    x = rand((1, 8, 8, 2), 17)
    np.testing.assert_array_equal(
        nhwc(tops.resize_nearest(nchw(x), out_size)),
        np.asarray(jops.resize_nearest(jnp.asarray(x), out_size)))


def test_fade_in():
    a, b = rand((2, 3), 18), rand((2, 3), 19)
    np.testing.assert_allclose(
        tops.fade_in(torch.from_numpy(a), torch.from_numpy(b), 0.3).numpy(),
        np.asarray(jops.fade_in(jnp.asarray(a), jnp.asarray(b), 0.3)),
        rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# ops/lrelu_pixel_norm.py: the epilogue's Functions (plain launch on the CPU)
# against the JAX Pallas kernel (interpreted)
# ---------------------------------------------------------------------------

def jax_epilogue(n_groups):
    return lambda x: grouped_lrelu_pixel_norm_pallas(x, n_groups, 0.2, 1e-8, True)


def port_epilogue(n_groups):
    return lambda x: lpn.lrelu_pixel_norm(x, n_groups, 0.2, 1e-8)


@pytest.mark.parametrize('n_groups', [1, 4])
def test_epilogue_forward_matches_pallas(n_groups):
    x = rand((2, 5, 7, 16), 20)
    want = jax_epilogue(n_groups)(jnp.asarray(x))
    got = port_epilogue(n_groups)(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('n_groups', [1, 4])
def test_epilogue_backward_matches_pallas(n_groups):
    x = rand((2, 3, 3, 16), 21)
    jg = jax.grad(lambda x: jnp.sum(jnp.sin(jax_epilogue(n_groups)(x))))(
        jnp.asarray(x))
    xt = nchw(x).requires_grad_()
    torch.sin(port_epilogue(n_groups)(xt)).sum().backward()
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jg), rtol=1e-4, atol=1e-5)


W_CH = (0.5 + np.random.default_rng(11).random(16)).astype(np.float32)


def _jax_gp_second_order(epilogue, x, c):
    # the harness of tests/test_pallas_kernels.py::_gp_style_second_order
    # with per-channel scales and a random linear readout: PixelNorm is
    # scale-invariant and fixes each pixel's sum of squares, so one scalar
    # scale or a squared readout leaves a gradient of rounding noise
    def gp(w):
        g = jax.grad(lambda xi: jnp.sum(epilogue(xi * w) * c))(x)
        norms = jnp.sqrt(jnp.sum(g ** 2, axis=(1, 2, 3)))
        return jnp.sum((norms - 1.0) ** 2)
    return jax.grad(gp)(jnp.asarray(W_CH))


def _port_gp_second_order(epilogue, x, c):
    w = torch.from_numpy(W_CH.reshape(1, -1, 1, 1).copy()).requires_grad_()
    xt = x.clone().requires_grad_()
    g, = torch.autograd.grad((epilogue(xt * w) * c).sum(), xt,
                             create_graph=True)
    norms = torch.sqrt((g ** 2).sum(dim=(1, 2, 3)))
    gw, = torch.autograd.grad(((norms - 1.0) ** 2).sum(), w)
    return gw


@pytest.mark.parametrize('n_groups', [1, 4])
def test_epilogue_gp_second_order_matches_pallas(n_groups):
    x, c = rand((2, 3, 3, 16), 5), rand((2, 3, 3, 16), 9)
    want = _jax_gp_second_order(jax_epilogue(n_groups), jnp.asarray(x),
                                jnp.asarray(c))
    got = _port_gp_second_order(port_epilogue(n_groups), nchw(x), nchw(c))
    assert np.abs(np.asarray(want)).max() > 1.0   # not rounding noise
    np.testing.assert_allclose(got.numpy().reshape(-1), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('n_groups', [1, 4, 8])
def test_epilogue_plain_versions_match_composed(n_groups):
    # the plain forward/backward (the kernels' CPU and on-card references)
    # agree with autodiff of the composed ops, group by group
    x = torch.from_numpy(rand((2, 16, 3, 3), 22))
    g = torch.from_numpy(rand((2, 16, 3, 3), 23))

    def composed(x):
        b = x.shape[0]
        xg = x.reshape(b, n_groups, 16 // n_groups, 3, 3)
        return composed_lrelu_pn(xg.flatten(0, 1), 0.2, 1e-8).reshape(x.shape)

    torch.testing.assert_close(lpn.lrelu_pixel_norm_plain(x, n_groups),
                               composed(x), rtol=1e-5, atol=1e-6)
    xr = x.clone().requires_grad_()
    want, = torch.autograd.grad(composed(xr), xr, g)
    torch.testing.assert_close(lpn.lrelu_pixel_norm_bwd_plain(x, g, n_groups),
                               want, rtol=1e-4, atol=1e-5)


# every template width of the kernels, and a width that takes the
# runtime-width instance
SLICED_WIDTHS = lpn.TEMPLATE_WIDTHS + (24,)


def _sliced_case(c_g, dtype):
    """x, g (2, 3, 5, 2 * c_g) NHWC in 2 groups, as JAX arrays of ``dtype``,
    and the interpreted Pallas forward and backward on them."""
    x = jnp.asarray(rand((2, 3, 5, 2 * c_g), 40 + c_g)).astype(dtype)
    g = jnp.asarray(rand((2, 3, 5, 2 * c_g), 41 + c_g)).astype(dtype)
    out = grouped_lrelu_pixel_norm_pallas(x, 2, 0.2, 1e-8, True)
    dx = _bwd_call(x.reshape(-1, 2 * c_g), g.reshape(-1, 2 * c_g), 2, 0.2,
                   1e-8, True).reshape(x.shape)
    return x, g, out, dx


def _port_sliced(x, g):
    """The sliced forward and backward on NHWC JAX arrays, as NHWC
    float32 numpy arrays (and the port's output dtype)."""
    tx = nchw(np.asarray(x.astype(jnp.float32)))
    tg = nchw(np.asarray(g.astype(jnp.float32)))
    if x.dtype == jnp.bfloat16:
        tx, tg = tx.bfloat16(), tg.bfloat16()
    out = lpn.lrelu_pixel_norm_sliced(tx, 2)
    dx = lpn.lrelu_pixel_norm_bwd_sliced(tx, tg, 2)
    assert out.dtype == dx.dtype == tx.dtype
    return nhwc(out.float()), nhwc(dx.float())


@pytest.mark.parametrize('c_g', SLICED_WIDTHS)
def test_epilogue_sliced_matches_pallas(c_g):
    # the kernels' order of summation (slice sums, then the lanes'
    # butterfly; the runtime-width instance in channel order) against the
    # interpreted Pallas kernels, float32, at this file's forward and
    # gradient tolerances (at C_g = 1, dx = g * r * (1 - y^2 r^2) cancels)
    x, g, out, dx = _sliced_case(c_g, jnp.float32)
    got_out, got_dx = _port_sliced(x, g)
    np.testing.assert_allclose(got_out, np.asarray(out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_dx, np.asarray(dx), rtol=1e-4, atol=1e-5)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.sum((a - b) ** 2) / np.sum(b ** 2))


@pytest.mark.parametrize('c_g', SLICED_WIDTHS)
def test_epilogue_sliced_bf16_tracks_pallas(c_g):
    # bfloat16: no further from the interpreted Pallas kernels in bfloat16
    # than they lie from themselves in float32 on the same inputs
    x, g, out, dx = _sliced_case(c_g, jnp.bfloat16)
    x32, g32 = x.astype(jnp.float32), g.astype(jnp.float32)
    out32 = grouped_lrelu_pixel_norm_pallas(x32, 2, 0.2, 1e-8, True)
    dx32 = _bwd_call(x32.reshape(-1, 2 * c_g), g32.reshape(-1, 2 * c_g), 2,
                     0.2, 1e-8, True).reshape(x.shape)
    got_out, got_dx = _port_sliced(x, g)
    for got, want, ref in ((got_out, out, out32), (got_dx, dx, dx32)):
        want = np.asarray(want.astype(jnp.float32))
        dist, own = _rel_l2(got, want), _rel_l2(want, np.asarray(ref))
        assert 0 < own and dist <= own, (dist, own)


def test_epilogue_kernel_instance_rule():
    # a template instance for each power of two up to 512, a thread taking
    # S channels (float32 min(C_g, 4); bfloat16 min(C_g, 8), 4 at C_g >=
    # 64; C_g / 32 at the wide widths 256 and 512) and the L = C_g / S
    # lanes of a vector inside one warp; every other width the
    # runtime-width instance, one thread walking the group
    for dtype, want in ((torch.float32, [1, 2, 4, 4, 4, 4, 4, 4, 8, 16]),
                        (torch.bfloat16, [1, 2, 4, 8, 8, 8, 4, 4, 8, 16])):
        assert len(want) == len(lpn.TEMPLATE_WIDTHS)
        for c_g, s_want in zip(lpn.TEMPLATE_WIDTHS, want):
            width, s = lpn.kernel_instance(c_g, dtype)
            assert (width, s) == (c_g, s_want)
            assert c_g % s == 0 and 32 % (c_g // s) == 0
        for c_g in (3, 24, 96, 384):
            assert lpn.kernel_instance(c_g, dtype) == (None, c_g)
    assert lpn.WIDE_WIDTHS == (256, 512)
    # the flagship paths' widths all have template instances
    assert {16, 32, 64, 128} <= set(lpn.TEMPLATE_WIDTHS)
    with pytest.raises(TypeError):
        lpn.kernel_instance(16, torch.float64)


def test_epilogue_two_dimensional_rows():
    # (rows, C) tensors, as the JAX kernel sees its input
    x = rand((64, 32), 1)
    jg = jax.grad(lambda x: jnp.sum(jnp.sin(jax_epilogue(1)(x))))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    torch.sin(port_epilogue(1)(xt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


def test_epilogue_bfloat16_keeps_dtype():
    x = rand((2, 16, 2, 2), 6)
    got = port_epilogue(4)(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = lpn.lrelu_pixel_norm_plain(torch.from_numpy(x), 4)
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


def test_epilogue_third_order_raises():
    x = torch.from_numpy(rand((1, 4, 2, 2), 7)).requires_grad_()
    # second order is defined; keeping its graph for a third is refused
    g, = torch.autograd.grad(port_epilogue(1)(x).pow(2).sum(), x, create_graph=True)
    with pytest.raises(NotImplementedError, match='third-order'):
        torch.autograd.grad(g.pow(2).sum(), x, create_graph=True)


@pytest.mark.parametrize('bad', ['dtype', 'contiguous', 'groups', 'shape'])
def test_kernel_argument_checks_raise(bad):
    x = torch.zeros(2, 8, 4, 4)
    if bad == 'dtype':
        x = x.double()
    elif bad == 'contiguous':
        x = x.transpose(2, 3)
    n_groups = 3 if bad == 'groups' else 1
    others = (torch.zeros(2, 8, 4, 5),) if bad == 'shape' else ()
    with pytest.raises((TypeError, ValueError)):
        lpn._kernel_args(n_groups, x, *others)


def test_epilogue_refuses_a_device_without_kernel():
    with pytest.raises(RuntimeError, match='no kernel'):
        lpn._fwd(torch.zeros(1, 4, 2, 2, device='meta'), 1, 0.2, 1e-8)


def test_cpu_launch_does_not_count():
    def counters():
        sums = lpn.launches_by_kernel()
        return [dict(sums['k1']), dict(sums['k2']),
                dict(lpn.launches_by_case)]
    before = counters()
    x = torch.from_numpy(rand((1, 4, 2, 2), 8)).requires_grad_()
    port_epilogue(1)(x).sum().backward()
    assert counters() == before


def test_launches_by_kernel_sums_the_cases(monkeypatch):
    cases = {('k1', 'bfloat16', (8, 64, 32, 32), 4): 3,
             ('k1', 'bfloat16', (8, 64, 16, 16), 4): 2,
             ('k1/runtime', 'float32', (8, 24, 8, 8), 1): 1,
             ('k1/wide', 'bfloat16', (4, 512, 8, 8), 1): 2,
             ('k2', 'bfloat16', (8, 64, 32, 32), 8): 5}
    monkeypatch.setattr(lpn, 'launches_by_case', collections.Counter(cases))
    assert lpn.launches_by_kernel() == {
        'k1': {('bfloat16', 4): 5, ('float32', 1): 1, ('bfloat16', 1): 2},
        'k2': {('bfloat16', 8): 5}}
    assert lpn._case('k2', torch.zeros(4, 512, 2, 2), 2) == (
        'k2/wide', 'float32', (4, 512, 2, 2), 2)
    assert lpn._case('k1', torch.zeros(4, 96, 2, 2), 1)[0] == 'k1/runtime'
