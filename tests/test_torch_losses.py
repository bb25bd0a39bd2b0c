"""The port's losses against the JAX package on the CPU, including the
gradient penalty's second-order D-parameter gradients through the fused
epilogue.

Same numpy parameters (convert.py) and inputs on both sides; JAX runs
``use_pallas=True`` (interpreted Pallas) at 'highest' precision, the port
``use_kernels=True``.  Tolerances: rtol 1e-4 / atol 1e-5 on loss values;
parameter gradients rtol 1e-4 with atol 1e-5 times the leaf's largest
magnitude (float32 cancellation far below a leaf's scale).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuron_gan_tpu import losses as jl
from neuron_gan_tpu.models import (
    PGConfig as JPGConfig, discriminator_pg, generator_pg,
    init_discriminator_pg, init_generator_pg)

from neuron_gan_tpu_torch import losses as tl
from neuron_gan_tpu_torch.convert import load_jax_tree, to_jax_tree
from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG, PGConfig

ARCH = dict(n_gen_features=(16, 8, 8), n_dis_features=(8, 8, 16),
            latent_dim=8, image_size_init=4)
JCFG = JPGConfig(**ARCH, use_pallas=True, precision='highest')
TCFG = PGConfig(**ARCH, use_kernels=True)
B = 2


@pytest.fixture(scope='module')
def setup():
    kg, kd = jax.random.split(jax.random.PRNGKey(0))
    g = jax.tree.map(np.asarray, init_generator_pg(kg, JCFG))
    d = jax.tree.map(np.asarray, init_discriminator_pg(kd, JCFG))
    rng = np.random.default_rng(0)
    z = rng.standard_normal((B, 8)).astype(np.float32)
    eps = rng.random(B).astype(np.float32)
    real = {p: np.tanh(rng.standard_normal((B, 4 * 2 ** p, 4 * 2 ** p, 1)))
            .astype(np.float32) for p in range(3)}
    return g, d, z, eps, real


def port(setup):
    g, d = setup[:2]
    rng = torch.Generator().manual_seed(0)
    return (load_jax_tree(GeneratorPG(TCFG, rng, device='cpu'), g),
            load_jax_tree(DiscriminatorPG(TCFG, rng, device='cpu'), d))


def t(a):
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.transpose(0, 3, 1, 2) if a.ndim == 4
                                     else a))


def assert_grads_close(module, jgrads):
    want = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    holder = type(module)(module.cfg, torch.Generator(), device='cpu')
    with torch.no_grad():
        for h, p in zip(holder.parameters(), module.parameters()):
            h.copy_(torch.zeros_like(p) if p.grad is None else p.grad)
    for path, leaf in jax.tree_util.tree_leaves_with_path(to_jax_tree(holder)):
        ref = np.asarray(want[path])
        np.testing.assert_allclose(
            leaf, ref, rtol=1e-4, atol=1e-5 * max(1.0, float(np.abs(ref).max())),
            err_msg=jax.tree_util.keystr(path))


PHASES = [(1, None), (2, 0.5)]


@pytest.mark.parametrize('phase,alpha', PHASES)
def test_d_w_loss_and_grads(setup, phase, alpha):
    g, d, z, _, real = setup
    x = real[phase]
    ja = lambda p, x_: discriminator_pg(p, x_, JCFG, phase, alpha)  # noqa: E731
    jg_apply = lambda p, z_: generator_pg(p, z_, JCFG, phase, alpha)  # noqa: E731
    (jloss, (jsr, jsf)), jgrad = jax.jit(jax.value_and_grad(
        lambda dp: jl.d_w_loss(ja, jg_apply, dp, g, jnp.asarray(x),
                               jnp.asarray(z), 0.001), has_aux=True))(d)
    tg, td = port(setup)
    # the fake batch is handed over with its graph: d_w_loss detaches it
    loss, (sr, sf) = tl.d_w_loss(lambda x_: td(x_, phase, alpha), t(x),
                                 tg(t(z), phase, alpha), 0.001)
    loss.backward()
    for a, b in ((loss, jloss), (sr, jsr), (sf, jsf)):
        assert a.item() == pytest.approx(float(b), rel=1e-4, abs=1e-5)
    assert all(p.grad is None for p in tg.parameters())   # fakes detached
    assert_grads_close(td, jgrad)


@pytest.mark.parametrize('phase,alpha', PHASES)
def test_g_w_loss_and_grads(setup, phase, alpha):
    g, d, z, _, _ = setup
    ja = lambda p, x_: discriminator_pg(p, x_, JCFG, phase, alpha)  # noqa: E731
    jg_apply = lambda p, z_: generator_pg(p, z_, JCFG, phase, alpha)  # noqa: E731
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(
        lambda gp: jl.g_w_loss(jg_apply, ja, gp, d, jnp.asarray(z)),
        has_aux=True))(g)
    tg, td = port(setup)
    loss, zz = tl.g_w_loss(lambda z_: tg(z_, phase, alpha),
                           lambda x_: td(x_, phase, alpha), t(z))
    loss.backward()
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4, abs=1e-5)
    assert torch.equal(zz, t(z))
    assert_grads_close(tg, jgrad)


@pytest.mark.parametrize('phase,alpha', PHASES)
def test_grad_pen_loss_and_second_order_d_grads(setup, phase, alpha):
    g, d, z, eps, real = setup
    x = real[phase]
    fake = np.asarray(generator_pg(g, jnp.asarray(z), JCFG, phase, alpha))
    ja = lambda p, x_: discriminator_pg(p, x_, JCFG, phase, alpha)  # noqa: E731
    jgp, jgrad = jax.jit(jax.value_and_grad(
        lambda dp: jl.d_grad_pen_loss(ja, dp, jnp.asarray(x), jnp.asarray(fake),
                                      jnp.asarray(eps), 10.0)))(d)
    _, td = port(setup)
    gp = tl.d_grad_pen_loss(lambda x_: td(x_, phase, alpha), t(x), t(fake),
                            t(eps), 10.0)
    gp.backward()
    assert float(gp) == pytest.approx(float(jgp), rel=1e-4, abs=1e-5)
    assert_grads_close(td, jgrad)


def test_grad_pen_zero_lambda_and_remat():
    x = torch.zeros(2, 1, 4, 4)
    assert float(tl.d_grad_pen_loss(lambda v: v.sum((1, 2, 3)), x, x,
                                    torch.zeros(2), 0.0)) == 0.0
    # remat recomputes the critic's forward inside the penalty's gradient:
    # the same values and second-order gradients, bit for bit on the CPU
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(1, 1, 4, 4, generator=gen, requires_grad=True)
    real, fake = torch.rand(2, 1, 4, 4, generator=gen), torch.rand(2, 1, 4, 4, generator=gen)
    eps = torch.rand(2, generator=gen)

    def critic(v):
        return torch.tanh(v * w).pow(2).sum((1, 2, 3))

    runs = []
    for remat in (False, True):
        gp = tl.d_grad_pen_loss(critic, real, fake, eps, 10.0, remat=remat)
        runs.append((gp, *torch.autograd.grad(gp, w)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize('dtype,rel', [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_grad_pen_matches_closed_form(dtype, rel):
    # linear critic D(x) = <w, x>: grad = w everywhere, penalty known
    # exactly; float32 accumulation, float64 kept (a reference run)
    w = torch.randn(1, 1, 4, 4, generator=torch.Generator().manual_seed(0),
                    dtype=dtype)
    x = torch.rand(3, 1, 4, 4, dtype=dtype)
    gp = tl.d_grad_pen_loss(lambda v: (v * w).sum((1, 2, 3)), x, -x,
                            torch.rand(3), 10.0)
    want = 10.0 * (w.norm() - 1.0) ** 2
    assert gp.dtype == dtype
    assert float(gp) == pytest.approx(float(want), rel=rel)


def test_similarity_loss():
    rng = np.random.default_rng(4)
    im = rng.standard_normal((3, 4, 4, 1)).astype(np.float32)
    z = rng.standard_normal((3, 8)).astype(np.float32)
    want = jl.similarity_loss(jnp.asarray(im), jnp.asarray(z), 0.7)
    got = tl.similarity_loss(t(im), t(z), 0.7)
    assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-7)


def test_ls_losses(setup):
    g, d, z, _, real = setup
    ja = lambda p, x_: discriminator_pg(p, x_, JCFG, 1)  # noqa: E731
    jg_apply = lambda p, z_: generator_pg(p, z_, JCFG, 1)  # noqa: E731
    jd, (jr, jf) = jl.d_ls_loss(ja, jg_apply, d, g, jnp.asarray(real[1]),
                                jnp.asarray(z))
    jgl, jmean = jl.g_ls_loss(jg_apply, ja, g, d, jnp.asarray(z))
    tg, td = port(setup)
    ta, tga = (lambda x_: td(x_, 1)), (lambda z_: tg(z_, 1))
    dl, (r, f) = tl.d_ls_loss(ta, tga, t(real[1]), t(z))
    gl, mean = tl.g_ls_loss(tga, ta, t(z))
    for a, b in ((dl, jd), (r, jr), (f, jf), (gl, jgl), (mean, jmean)):
        assert a.item() == pytest.approx(float(b), rel=1e-4, abs=1e-5)
