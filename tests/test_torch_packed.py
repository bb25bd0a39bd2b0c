"""The port's 2x2 packed layout and its fused packed conv kernel pair
(K3/K4) against the JAX package, on the CPU.

Inputs are numpy arrays from a seed, handed to both sides; JAX runs NHWC
float32 at 'highest' precision (the Pallas kernels interpreted, as
tests/test_pallas_conv.py runs them), the port NCHW float32, where the
kernel Functions take their plain launches.  Tolerances: the layout ops
rtol 1e-5 / atol 1e-6 (the weight scatter exact); the fused conv those of
tests/test_pallas_conv.py -- y and r rtol 1e-5 / atol 1e-5, dx rtol 1e-4 /
atol 1e-5, dw rtol 1e-4 / atol 1e-4, the GP second order rtol 1e-4 /
atol 1e-3 (sums of 9*K products in another order, differentiated twice).
The forward kernel's compact weights, tap formulation and 3xTF32 numerics
are held here too, since the kernel itself runs only on the card.
"""

import collections

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuron_gan_tpu.ops import packed as jpk
from neuron_gan_tpu.ops.pallas_conv import _dz_call, _fused_pair

import neuron_gan_tpu_torch.ops.packed_conv_lrelu_pn as pcl
from neuron_gan_tpu_torch.ops import packed as tpk


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


def hwio(t):
    return t.detach().numpy().transpose(2, 3, 1, 0)


def rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def r_as_jax(r):
    """(B, 4, H, W) -> the JAX kernel's (B, H*W, 4)."""
    b, g, h, w = r.shape
    return r.detach().permute(0, 2, 3, 1).reshape(b, h * w, g).numpy()


# ---------------------------------------------------------------------------
# ops/packed.py
# ---------------------------------------------------------------------------

def test_space_to_depth_matches_jax_and_round_trips():
    x = rand((2, 6, 8, 3), 0)
    got = tpk.space_to_depth(nchw(x))
    np.testing.assert_array_equal(nhwc(got), np.asarray(jpk.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(nhwc(tpk.depth_to_space(got)), x)
    p = rand((2, 3, 4, 12), 1)
    np.testing.assert_array_equal(nhwc(tpk.depth_to_space(nchw(p))),
                                  np.asarray(jpk.depth_to_space(jnp.asarray(p))))


@pytest.mark.parametrize('scale', [1.0, 0.37])
def test_pack_conv3x3_weight_is_jax_exactly(scale):
    w = rand((3, 3, 5, 7), 2)
    want = np.asarray(jpk.pack_conv3x3_weight(jnp.asarray(w), scale))
    got = tpk.pack_conv3x3_weight(oihw(w), scale)
    assert got.shape == (28, 20, 3, 3)
    np.testing.assert_array_equal(hwio(got), want)


def test_pack_conv3x3_weight_gradient_reaches_original_weight():
    w = rand((3, 3, 4, 6), 3)
    cot = rand((3, 3, 16, 24), 4)
    jg = jax.grad(lambda w: jnp.sum(jpk.pack_conv3x3_weight(w, 0.5) * cot))(jnp.asarray(w))
    wt = oihw(w).requires_grad_()
    (tpk.pack_conv3x3_weight(wt, 0.5) * oihw(cot)).sum().backward()
    np.testing.assert_allclose(hwio(wt.grad), np.asarray(jg), rtol=1e-6, atol=1e-6)


def test_pack_conv3x3_weight_rejects_other_kernels():
    with pytest.raises(ValueError, match='3x3'):
        tpk.pack_conv3x3_weight(torch.zeros(2, 2, 1, 1))


@pytest.mark.parametrize('bias', [False, True])
def test_packed_equalized_conv3x3_forward_and_grads(bias):
    x = rand((2, 4, 5, 12), 5)                  # packed rep of a 8x10 image
    w, b = rand((3, 3, 3, 4), 6), rand((4,), 7)
    cot = rand((2, 4, 5, 16), 8)
    params = {'w': jnp.asarray(w), 'b': jnp.asarray(b)} if bias else {'w': jnp.asarray(w)}

    def jf(x, p):
        y = jpk.packed_equalized_conv3x3(x, p, precision='highest')
        return jnp.sum(y * cot), y

    (_, jy), (jgx, jgp) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), params)
    xt = nchw(x).requires_grad_()
    wt = oihw(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    ty = tpk.packed_equalized_conv3x3(xt, wt, bt if bias else None)
    (ty * nchw(cot)).sum().backward()
    np.testing.assert_allclose(nhwc(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hwio(wt.grad), np.asarray(jgp['w']), rtol=1e-5, atol=1e-5)
    if bias:
        np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jgp['b']), rtol=1e-5, atol=1e-5)


def test_packed_conv3x3_equals_unpacked_conv():
    # the layout's exactness, on the port's side alone
    from neuron_gan_tpu_torch.ops import equalized_conv2d
    x, w = torch.from_numpy(rand((2, 3, 8, 10), 9)), torch.from_numpy(rand((5, 3, 3, 3), 10))
    want = equalized_conv2d(x, w, padding=1)
    got = tpk.depth_to_space(tpk.packed_equalized_conv3x3(tpk.space_to_depth(x), w))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('jax_fn', ['packed_pixel_norm', 'packed_pixel_norm_mxu'])
@pytest.mark.parametrize('c', [4, 32])
def test_packed_pixel_norm_forward_and_grad(jax_fn, c):
    # both JAX formulations compute the one function the port keeps; c=32
    # takes the _mxu variant's same-group-dot branch (4C >= 128)
    x = rand((2, 3, 4, 4 * c), 11 + c)
    cot = rand((2, 3, 4, 4 * c), 12)
    fn = getattr(jpk, jax_fn)
    jy, jg = jax.value_and_grad(lambda x: jnp.sum(fn(x) * cot))(jnp.asarray(x))
    xt = nchw(x).requires_grad_()
    ty = (tpk.packed_pixel_norm(xt) * nchw(cot)).sum()
    ty.backward()
    np.testing.assert_allclose(ty.item(), float(jy), rtol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jg), rtol=1e-4, atol=1e-5)


def test_packed_conv1x1_forward_and_grads():
    x = rand((2, 3, 3, 8), 13)
    w, b = rand((1, 1, 2, 3), 14), rand((3,), 15)
    cot = rand((2, 3, 3, 12), 16)
    (jy, jg) = jax.value_and_grad(
        lambda x, p: jnp.sum(jpk.packed_conv1x1(x, p, precision='highest') * cot),
        argnums=(0, 1))(jnp.asarray(x), {'w': jnp.asarray(w), 'b': jnp.asarray(b)})
    xt, wt = nchw(x).requires_grad_(), oihw(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    ty = (tpk.packed_conv1x1(xt, wt, bt) * nchw(cot)).sum()
    ty.backward()
    np.testing.assert_allclose(ty.item(), float(jy), rtol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jg[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hwio(wt.grad), np.asarray(jg[1]['w']), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jg[1]['b']), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('op', ['packed_avg_pool2', 'packed_upsample2_bilinear'])
def test_packed_resampling_forward_and_grad(op):
    x = rand((2, 4, 6, 12), 17)
    out_shape = jax.eval_shape(getattr(jpk, op), jnp.asarray(x)).shape
    cot = rand(out_shape, 18)
    jy, jg = jax.value_and_grad(
        lambda x: jnp.sum(getattr(jpk, op)(x) * cot))(jnp.asarray(x))
    xt = nchw(x).requires_grad_()
    ty = getattr(tpk, op)(xt)
    assert nhwc(ty).shape == out_shape
    (ty * nchw(cot)).sum().backward()
    np.testing.assert_allclose(nhwc(ty), np.asarray(getattr(jpk, op)(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jg), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# ops/packed_conv_lrelu_pn.py against the Pallas kernel pair (interpreted)
# ---------------------------------------------------------------------------

def conv_case(c=4, h=8, w=8, seed=0):
    """Packed x (B=2, 4c, h, w) NHWC and an equalized packed kernel."""
    x = rand((2, h, w, 4 * c), seed)
    w3 = rand((3, 3, c, c), seed + 1, 0.3)
    wp = np.asarray(jpk.pack_conv3x3_weight(jnp.asarray(w3), 0.7))
    return x, wp


def jax_pair(x, wp):
    return _fused_pair(x, wp, 0.2, 1e-8, True)


def port_pair(x, wp):
    return pcl.PackedConvLReluPN.apply(x, wp, 0.2, 1e-8)


@pytest.mark.parametrize('c,h,w', [(4, 8, 8), (2, 64, 8), (8, 5, 7)])
def test_fused_conv_forward_matches_pallas(c, h, w):
    # (2, 64, 8) runs the Pallas kernel over several row tiles; (8, 5, 7)
    # is ragged
    x, wp = conv_case(c, h, w, seed=c + h)
    jy, jr = jax_pair(jnp.asarray(x), jnp.asarray(wp))
    for fn in (port_pair, pcl.packed_conv_lrelu_pn_plain):
        ty, tr = fn(nchw(x), oihw(wp))
        assert tr.shape == (2, 4, h, w) and tr.dtype == torch.float32
        np.testing.assert_allclose(nhwc(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r_as_jax(tr), np.asarray(jr), rtol=1e-5, atol=1e-5)
    assert jax.eval_shape(lambda: jr).shape == (2, h * w, 4)


@pytest.mark.parametrize('live_ct_r', [False, True])
def test_fused_conv_gradients_match_pallas(live_ct_r):
    # dx and dw for cotangents of y and (under the GP) of r
    x, wp = conv_case(seed=20)
    ct_y = rand((2, 8, 8, 16), 21)
    ct_r = rand((2, 64, 4), 22) if live_ct_r else np.zeros((2, 64, 4), np.float32)
    _, vjp = jax.vjp(jax_pair, jnp.asarray(x), jnp.asarray(wp))
    jdx, jdw = vjp((jnp.asarray(ct_y), jnp.asarray(ct_r)))
    xt, wt = nchw(x).requires_grad_(), oihw(wp).requires_grad_()
    ty, tr = port_pair(xt, wt)
    grads = [nchw(ct_y)]
    outs = [ty]
    if live_ct_r:
        outs.append(tr)
        grads.append(torch.from_numpy(ct_r.reshape(2, 8, 8, 4).transpose(0, 3, 1, 2).copy()))
    dx, dw = torch.autograd.grad(outs, (xt, wt), grads)
    np.testing.assert_allclose(nhwc(dx), np.asarray(jdx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hwio(dw), np.asarray(jdw), rtol=1e-4, atol=1e-4)


def test_dz_matches_pallas_forward_and_vjp():
    y, g = rand((2, 4, 6, 16), 23), rand((2, 4, 6, 16), 24)
    r = (0.5 + np.random.default_rng(25).random((2, 24, 4))).astype(np.float32)
    ct_r, ct = rand((2, 24, 4), 26), rand((2, 4, 6, 16), 27)
    args = [jnp.asarray(a) for a in (y, r, g, ct_r)]
    jdz, vjp = jax.vjp(lambda *a: _dz_call(*a, 0.2, 1e-8, True), *args)
    jgrads = vjp(jnp.asarray(ct))

    def r_nchw(a):
        return torch.from_numpy(a.reshape(2, 4, 6, 4).transpose(0, 3, 1, 2).copy())

    targs = [nchw(y).requires_grad_(), r_nchw(r).requires_grad_(),
             nchw(g).requires_grad_(), r_nchw(ct_r).requires_grad_()]
    tdz = pcl.Dz.apply(*targs, 0.2)
    np.testing.assert_allclose(nhwc(tdz), np.asarray(jdz), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nhwc(pcl.packed_dz_plain(*targs)), np.asarray(jdz),
                               rtol=1e-5, atol=1e-5)
    tgrads = torch.autograd.grad(tdz, targs, nchw(ct))
    np.testing.assert_allclose(nhwc(tgrads[0]), np.asarray(jgrads[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r_as_jax(tgrads[1]), np.asarray(jgrads[1]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(nhwc(tgrads[2]), np.asarray(jgrads[2]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r_as_jax(tgrads[3]), np.asarray(jgrads[3]), rtol=1e-4, atol=1e-5)


def test_plain_versions_match_autodiff_of_the_composed_block():
    # the plain dz is the VJP of the plain forward, ct_r included
    x, wp = conv_case(seed=30)
    xt, wt = nchw(x).requires_grad_(), oihw(wp)
    y, r = pcl.packed_conv_lrelu_pn_plain(xt, wt)
    ct_y = torch.from_numpy(rand(tuple(y.shape), 31))
    ct_r = torch.from_numpy(rand(tuple(r.shape), 32))
    want, = torch.autograd.grad((y, r), xt, (ct_y, ct_r))
    dz = pcl.packed_dz_plain(y.detach(), r.detach(), ct_y, ct_r)
    got = torch.nn.grad.conv2d_input(xt.shape, wt, dz, padding=1)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# GP-style second order: per-input-channel scales and a random linear
# readout (one scalar scale or a squared readout leaves PixelNorm's
# gradient at rounding noise: it is scale-invariant and fixes each pixel's
# sum of squares); the gradient is taken w.r.t. the scales and the kernel,
# as the WGAN-GP takes it w.r.t. the critic's parameters
W_CH = (0.5 + np.random.default_rng(40).random(16)).astype(np.float32)


def _jax_gp(x, wp, c):
    def gp(s, wp):
        gx = jax.grad(lambda xi: jnp.sum(jax_pair(xi * s, wp)[0] * c))(x)
        norms = jnp.sqrt(jnp.sum(gx ** 2, axis=(1, 2, 3)))
        return jnp.sum((norms - 1.0) ** 2)
    return jax.grad(gp, argnums=(0, 1))(jnp.asarray(W_CH), wp)


def _port_gp(x, wp, c):
    s = torch.from_numpy(W_CH.reshape(1, -1, 1, 1).copy()).requires_grad_()
    w = wp.clone().requires_grad_()
    xt = x.clone().requires_grad_()
    gx, = torch.autograd.grad((port_pair(xt * s, w)[0] * c).sum(), xt,
                              create_graph=True)
    norms = torch.sqrt((gx ** 2).sum(dim=(1, 2, 3)))
    return torch.autograd.grad(((norms - 1.0) ** 2).sum(), (s, w))


def _gp_case():
    x, wp = conv_case(seed=41)
    # readout scale 0.1: gradient norms near 1, as the penalty aims for
    return x, wp, rand((2, 8, 8, 16), 42, 0.1)


def test_fused_conv_gp_second_order_matches_pallas():
    x, wp, c = _gp_case()
    js, jw = _jax_gp(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(c))
    ts, tw = _port_gp(nchw(x), oihw(wp), nchw(c))
    assert np.abs(np.asarray(js)).max() > 1.0       # not rounding noise
    np.testing.assert_allclose(ts.numpy().reshape(-1), np.asarray(js), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(hwio(tw), np.asarray(jw), rtol=1e-4, atol=1e-3)


def test_dropping_ct_r_breaks_the_gp_second_order(monkeypatch):
    # a planted fault: the backward ignores the r cotangent that the GP's
    # outer differentiation sends; the harness must see it
    real = pcl.PackedConvLReluPN.backward

    def no_ct_r(ctx, ct_y, ct_r):
        return real(ctx, ct_y, None)

    x, wp, c = _gp_case()
    js, jw = _jax_gp(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(c))
    monkeypatch.setattr(pcl.PackedConvLReluPN, 'backward', staticmethod(no_ct_r))
    ts, tw = _port_gp(nchw(x), oihw(wp), nchw(c))
    far = [not np.allclose(a, b, rtol=1e-4, atol=1e-3)
           for a, b in ((ts.numpy().reshape(-1), np.asarray(js)), (hwio(tw), np.asarray(jw)))]
    assert all(far)


def test_fused_conv_third_order_raises():
    x, wp = conv_case(seed=50)
    xt = nchw(x).requires_grad_()
    g, = torch.autograd.grad(port_pair(xt, oihw(wp))[0].pow(2).sum(), xt,
                             create_graph=True)
    with pytest.raises(NotImplementedError, match='third-order'):
        torch.autograd.grad(g.pow(2).sum(), xt, create_graph=True)


@pytest.mark.parametrize('bad', ['dtype', 'contiguous', 'width', 'kernel', 'channels',
                                 'parity_groups'])
def test_conv_kernel_argument_checks_raise(bad):
    x, w = torch.zeros(2, 16, 4, 4), torch.zeros(16, 16, 3, 3)
    if bad == 'dtype':
        x, w = x.double(), w.double()
    elif bad == 'contiguous':
        x = x.transpose(2, 3)
    elif bad == 'width':
        w = torch.zeros(12, 16, 3, 3)
    elif bad == 'kernel':
        w = torch.zeros(16, 16, 1, 1)
    elif bad == 'parity_groups':
        x, w = torch.zeros(2, 18, 4, 4), torch.zeros(16, 18, 3, 3)
    else:
        w = torch.zeros(16, 8, 3, 3)
    with pytest.raises((TypeError, ValueError)):
        pcl._check_conv_args(x, w)


@pytest.mark.parametrize('bad', ['dtype', 'contiguous', 'r_shape', 'groups',
                                 'width'])
def test_dz_kernel_argument_checks_raise(bad):
    y, r = torch.zeros(2, 16, 4, 4), torch.ones(2, 4, 4, 4)
    g, ct_r = torch.zeros(2, 16, 4, 4), torch.zeros(2, 4, 4, 4)
    if bad == 'dtype':
        y, g = y.half(), g.half()
    elif bad == 'contiguous':
        g = g.transpose(2, 3)
    elif bad == 'r_shape':
        r = torch.ones(2, 4, 16)
    elif bad == 'width':
        # 4 parity groups, but C = 6 is none of the kernel's widths
        y, g = torch.zeros(2, 24, 4, 4), torch.zeros(2, 24, 4, 4)
    else:
        y, g = torch.zeros(2, 14, 4, 4), torch.zeros(2, 14, 4, 4)
    with pytest.raises((TypeError, ValueError)):
        pcl._check_dz_args(y, r, g, ct_r)


def test_dz_kernel_argument_checks_take_absent_ct_r():
    # a None ct_r is a zero cotangent of r (a null pointer to the kernel)
    y, r = torch.zeros(2, 16, 4, 4), torch.ones(2, 4, 4, 4)
    pcl._check_dz_args(y, r, y, None)
    pcl._check_dz_args(y.bfloat16(), r, y.bfloat16(), None)
    with pytest.raises(ValueError, match='takes N in'):
        pcl._check_dz_args(torch.zeros(2, 8, 4, 4), r, torch.zeros(2, 8, 4, 4), None)


def test_kernel_argument_checks_take_bfloat16():
    # bfloat16 x, y and g pass (w_packed, r and ct_r stay float32); the
    # bfloat16 forward stages pixel pairs, so it refuses an odd width
    x, w = torch.zeros(2, 16, 4, 4, dtype=torch.bfloat16), torch.zeros(16, 16, 3, 3)
    pcl._check_conv_args(x, w)
    with pytest.raises(TypeError):
        pcl._check_conv_args(x, w.bfloat16())
    with pytest.raises(ValueError, match='even width'):
        pcl._check_conv_args(torch.zeros(2, 16, 4, 5, dtype=torch.bfloat16), w)
    pcl._check_conv_args(torch.zeros(2, 16, 4, 5), w)
    y, r = torch.zeros(2, 16, 4, 4, dtype=torch.bfloat16), torch.ones(2, 4, 4, 4)
    pcl._check_dz_args(y, r, y, r)
    with pytest.raises(TypeError):
        pcl._check_dz_args(y, r.bfloat16(), y, r)
    with pytest.raises(TypeError):
        pcl._check_dz_args(y, r, y.float(), r)


def test_fused_conv_refuses_a_device_without_kernel():
    with pytest.raises(RuntimeError, match='no kernel'):
        pcl._conv_fwd(torch.zeros(1, 16, 2, 2, device='meta'),
                      torch.zeros(16, 16, 3, 3, device='meta'), 0.2, 1e-8)
    with pytest.raises(RuntimeError, match='no kernel'):
        z = torch.zeros(1, 16, 2, 2, device='meta')
        r = torch.zeros(1, 4, 2, 2, device='meta')
        pcl._dz(z, r, z, r, 0.2)


def test_cpu_launches_do_not_count():
    def counters():
        sums = pcl.launches_by_kernel()
        return [dict(sums['k3']), dict(sums['k4']),
                dict(pcl.launches_by_case)]
    before = counters()
    x, wp = conv_case(seed=60)
    xt = nchw(x).requires_grad_()
    port_pair(xt, oihw(wp))[0].sum().backward()
    assert counters() == before


def test_launches_by_kernel_sums_the_cases(monkeypatch):
    cases = {('k3', 'bfloat16', (8, 64, 128, 128), None): 4,
             ('k3', 'float32', (8, 64, 128, 128), None): 1,
             ('k4', 'bfloat16', (8, 64, 128, 128), 'absent'): 2,
             ('k4', 'bfloat16', (8, 64, 64, 64), 'live'): 3}
    monkeypatch.setattr(pcl, 'launches_by_case', collections.Counter(cases))
    assert pcl.launches_by_kernel() == {
        'k3': {'bfloat16': 4, 'float32': 1}, 'k4': {'bfloat16': 5}}


# ---------------------------------------------------------------------------
# an absent r cotangent, and the dz kernel's order of summation
# ---------------------------------------------------------------------------

def r_nchw(a, h, w):
    """The JAX kernel's (B, H*W, 4) -> the port's (B, 4, H, W)."""
    return torch.from_numpy(a.reshape(a.shape[0], h, w, 4).transpose(0, 3, 1, 2).copy())


def test_dz_with_absent_ct_r_equals_explicit_zeros():
    y, g = torch.from_numpy(rand((2, 16, 3, 5), 84)), torch.from_numpy(rand((2, 16, 3, 5), 85))
    r = torch.from_numpy((0.5 + np.random.default_rng(86).random((2, 4, 3, 5))).astype(np.float32))
    ct = torch.from_numpy(rand((2, 16, 3, 5), 87))
    outs = []
    for ct_r in (None, torch.zeros_like(r)):
        leaves = [t.clone().requires_grad_() for t in (y, r, g)]
        dz = pcl.Dz.apply(*leaves, ct_r, 0.2)
        outs.append((dz, *torch.autograd.grad(dz, leaves, ct)))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fused_conv_sends_no_zero_ct_r(monkeypatch):
    # only y feeds the loss: r's cotangent is absent and reaches the dz
    # kernel as None; dx and dw equal those of an explicit zero cotangent
    seen = []
    real = pcl._dz

    def spy(y, r, g, ct_r, neg_slope):
        seen.append(ct_r)
        return real(y, r, g, ct_r, neg_slope)

    monkeypatch.setattr(pcl, '_dz', spy)
    x, wp = conv_case(seed=88)
    ct_y = nchw(rand((2, 8, 8, 16), 89))
    grads = []
    for explicit in (False, True):
        xt, wt = nchw(x).requires_grad_(), oihw(wp).requires_grad_()
        y, r = port_pair(xt, wt)
        if explicit:
            grads.append(torch.autograd.grad((y, r), (xt, wt), (ct_y, torch.zeros_like(r))))
        else:
            grads.append(torch.autograd.grad(y, (xt, wt), ct_y))
    assert seen[0] is None and isinstance(seen[1], torch.Tensor)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize('n', pcl.KERNEL_WIDTHS)
def test_dz_sliced_matches_pallas(n):
    # the kernel's order (slice sums, then the lanes' butterfly) against
    # the interpreted Pallas kernel, ct_r live and absent
    h, w = 5, 7
    y, g = rand((2, h, w, n), 90 + n), rand((2, h, w, n), 91 + n)
    r = (0.5 + np.random.default_rng(92 + n).random((2, h * w, 4))).astype(np.float32)
    for ct_r in (rand((2, h * w, 4), 93 + n), None):
        jct = np.zeros_like(r) if ct_r is None else ct_r
        jdz = _dz_call(*(jnp.asarray(a) for a in (y, r, g, jct)), 0.2, 1e-8, True)
        tdz = pcl.packed_dz_sliced(nchw(y), r_nchw(r, h, w), nchw(g),
                                   None if ct_r is None else r_nchw(ct_r, h, w))
        np.testing.assert_allclose(nhwc(tdz), np.asarray(jdz), rtol=1e-5, atol=1e-5)


def test_dz_slice_keeps_64_values_and_a_warp_per_vector():
    # S = min(C, 8) channels of 16 bytes of pixels a thread (y and ct_y:
    # 64 values in float32, 128 in bfloat16); the L = C / S <= 4 threads
    # of a vector fit a warp's butterfly, so a load covers whole lines
    for n in pcl.KERNEL_WIDTHS:
        c = n // 4
        s = pcl.dz_slice(c)
        assert c % s == 0 and (c // s) in (1, 2, 4)
        for v in (4, 8):
            assert 2 * s * v in (64, 128) or s == c
    assert [pcl.dz_slice(n // 4) for n in pcl.KERNEL_WIDTHS] == [4, 8, 8, 8]


# ---------------------------------------------------------------------------
# the forward kernel's compact weights, index map and numerics
# ---------------------------------------------------------------------------

# (K, N) of every packed conv2 on the flagship path (K = N), the ragged
# K0 = 5 case and the narrowest width that chip_smoke.py checks
@pytest.mark.parametrize('k,n', [(128, 128), (64, 64), (20, 32), (64, 16)])
def test_compact_weight_round_trips_and_holds_every_nonzero(k, n):
    w = torch.from_numpy(rand((n // 4, k // 4, 3, 3), 70 + k))
    wp = tpk.pack_conv3x3_weight(w, tpk._eq_scale3x3(w, 0.2))
    wc = pcl.compact_weight(wp)
    assert wc.shape == (4, 3, 3, k // 4, n // 4)
    idx = pcl._compact_index(k, n, wp.device).reshape(-1)
    assert idx.unique().numel() == idx.numel() == wp.numel() // 4
    back = torch.zeros(wp.numel())
    back[idx] = wc.reshape(-1)
    assert torch.equal(back.view_as(wp), wp)             # bit for bit
    off = torch.ones(wp.numel(), dtype=torch.bool)
    off[idx] = False
    assert torch.count_nonzero(wp.reshape(-1)[off]) == 0  # exactly 0


@pytest.mark.parametrize('ci,co,h,w', [(4, 4, 8, 8), (5, 8, 5, 7), (16, 4, 3, 9)])
def test_tap_formulation_matches_plain_and_pallas(ci, co, h, w):
    # the kernel's index map on the CPU: 9 shifted slices per group of the
    # compact weights, then the epilogue, against the plain version (dense
    # packed conv) and the JAX fused pair, odd H and W included
    x = rand((2, h, w, 4 * ci), 80 + ci)
    wp = np.asarray(jpk.pack_conv3x3_weight(jnp.asarray(rand((3, 3, ci, co), 81, 0.3)), 0.7))
    jy, jr = jax_pair(jnp.asarray(x), jnp.asarray(wp))
    xt, wt = nchw(x), oihw(wp)
    ty, tr = pcl.lrelu_pn_groups(pcl.packed_conv3x3_taps(xt, pcl.compact_weight(wt)))
    py, pr = pcl.packed_conv_lrelu_pn_plain(xt, wt)
    torch.testing.assert_close(ty, py, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tr, pr, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nhwc(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r_as_jax(tr), np.asarray(jr), rtol=1e-5, atol=1e-5)


def test_tf32_round_is_cvt_rna():
    # round to 10 mantissa bits, ties away from zero (round-to-even would
    # send 1 + 2^-11 to 1)
    got = pcl.tf32_round(torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                                       1 + 3 * 2 ** -11, 3.0, 0.0]))
    assert got.tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -9, 3.0, 0.0]
    hi, lo = pcl.split_tf32(torch.tensor([1 + 2 ** -11 + 2 ** -20]))
    assert (hi + lo).item() == 1 + 2 ** -11 + 2 ** -20


@pytest.mark.parametrize('k0', [16, 32])
def test_3xtf32_is_float32_accurate_and_1xtf32_is_not(k0):
    # reductions of depth 9 * K0 = 144 and 288, as at the path's K = 64
    # and 128.  Distance from float64 by relative L2 over z.  Plain float32
    # (the plain version's conv) lies ~1e-7 away.  3xTF32 drops lo*lo
    # (~2^-22 of a product) and rounds lo to TF32 (~2^-22 again), the
    # order of float32's own rounding: within 3x of plain float32.  One
    # TF32 product keeps 11 bits (~2^-12 relative per product; ~3e-4
    # measured here): over 1000x further, so at least 30x is asked.
    x = torch.from_numpy(rand((2, 4 * k0, 8, 8), 90 + k0))
    w = torch.from_numpy(rand((8, k0, 3, 3), 91))
    wp = tpk.pack_conv3x3_weight(w, tpk._eq_scale3x3(w, 0.2))
    wc = pcl.compact_weight(wp)
    z64 = pcl.packed_conv3x3_taps(x.double(), wc.double())

    def dist(z):
        return ((z.double() - z64).norm() / z64.norm()).item()

    d32 = dist(torch.nn.functional.conv2d(x, wp, padding=1))
    d3 = dist(pcl.packed_conv3x3_taps(x, wc, '3xtf32'))
    d1 = dist(pcl.packed_conv3x3_taps(x, wc, '1xtf32'))
    assert 0 < d32 < 1e-6
    assert d3 <= 3 * d32, (d3, d32)
    assert d1 >= 30 * d32, (d1, d32)
