"""The port's PGGAN G and D against the JAX package, at every phase, on
the CPU.

Both sides get the same numpy parameters (through convert.py) and the same
numpy inputs.  JAX runs with ``use_pallas=True`` (its Pallas epilogue,
interpreted on the CPU) at 'highest' precision; the port with
``use_kernels=True`` (its kernel Functions, which take their plain launch
on the CPU).  Tolerances: rtol 1e-4 / atol 1e-5 on outputs; parameter
gradients rtol 1e-4 with atol 1e-5 times the leaf's largest magnitude --
float32 sums taken in another order through up to ten layers cancel to
entries far below the leaf's scale, where only a scale-relative bound is
meaningful.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuron_gan_tpu.models import (
    GrowthState as JGrowthState, PGConfig as JPGConfig, discriminator_pg,
    generator_pg, init_discriminator_pg, init_generator_pg)

from neuron_gan_tpu_torch.convert import load_jax_tree, to_jax_tree
from neuron_gan_tpu_torch.models import (
    DiscriminatorPG, GeneratorPG, GrowthState, PGConfig)

ARCH = dict(n_gen_features=(16, 8, 8), n_dis_features=(8, 8, 16),
            latent_dim=8, image_size_init=4)
JCFG = JPGConfig(**ARCH, use_pallas=True, precision='highest')
TCFG = PGConfig(**ARCH, use_kernels=True)
CASES = [(0, None), (1, None), (2, None), (1, 0.3), (2, 0.3)]
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope='module')
def params():
    kg, kd = jax.random.split(jax.random.PRNGKey(0))
    return (jax.tree.map(np.asarray, init_generator_pg(kg, JCFG)),
            jax.tree.map(np.asarray, init_discriminator_pg(kd, JCFG)))


def port_models(params, cfg=TCFG):
    rng = torch.Generator().manual_seed(0)
    g = load_jax_tree(GeneratorPG(cfg, rng, device='cpu'), params[0])
    d = load_jax_tree(DiscriminatorPG(cfg, rng, device='cpu'), params[1])
    return g, d


def assert_tree_close(got, want, rtol, atol, scaled=False):
    """Leafwise allclose; ``scaled`` makes atol relative to each leaf's
    largest magnitude (gradients)."""
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        ref = np.asarray(flat_want[path])
        a = atol * max(1.0, float(np.abs(ref).max())) if scaled else atol
        np.testing.assert_allclose(leaf, ref, rtol=rtol, atol=a,
                                   err_msg=jax.tree_util.keystr(path))


def grads_tree(module):
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    holder = type(module)(module.cfg, torch.Generator(), device='cpu')
    with torch.no_grad():
        for h, p in zip(holder.parameters(), module.parameters()):
            h.copy_(p.grad)
    return to_jax_tree(holder)


@pytest.mark.parametrize('phase,alpha', CASES)
def test_generator_forward_and_param_grads(params, phase, alpha):
    rng = np.random.default_rng(phase)
    z = rng.standard_normal((2, 8)).astype(np.float32)
    res = JCFG.resolution(phase)
    cot = rng.standard_normal((2, res, res, 1)).astype(np.float32)

    def loss(p):
        y = generator_pg(p, jnp.asarray(z), JCFG, phase, alpha)
        return jnp.sum(y * cot), y

    (_, jy), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(params[0])
    g, _ = port_models(params)
    ty = g(torch.from_numpy(z), phase, alpha)
    (ty * torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(jy), **TOL)
    assert_tree_close(grads_tree(g), jg, **TOL, scaled=True)


@pytest.mark.parametrize('phase,alpha', CASES)
def test_discriminator_forward_and_param_grads(params, phase, alpha):
    rng = np.random.default_rng(10 + phase)
    res = JCFG.resolution(phase)
    x = rng.standard_normal((2, res, res, 1)).astype(np.float32)
    cot = rng.standard_normal((2, 1)).astype(np.float32)

    def loss(p):
        y = discriminator_pg(p, jnp.asarray(x), JCFG, phase, alpha)
        return jnp.sum(y * cot), y

    (_, jy), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(params[1])
    _, d = port_models(params)
    ty = d(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), phase, alpha)
    (ty * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    assert_tree_close(grads_tree(d), jg, **TOL, scaled=True)


def test_kernel_path_matches_composed_path(params):
    # use_kernels on/off: the same function (the plain path is what the
    # kernel path is held against on the card)
    g1, d1 = port_models(params)
    g0, d0 = port_models(params, dataclasses.replace(TCFG, use_kernels=False))
    z = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 8)).astype(np.float32))
    torch.testing.assert_close(g1(z, 2, 0.6), g0(z, 2, 0.6), rtol=1e-5, atol=1e-6)
    x = g0(z, 2).detach()
    torch.testing.assert_close(d1(x, 2), d0(x, 2), rtol=1e-5, atol=1e-6)


def test_parameter_names_and_shapes_follow_jax_paths(params):
    g, d = port_models(params)
    names = [n for n, _ in g.named_parameters()]
    assert names[:3] == ['stem.linear.weight', 'stem.conv.weight',
                         'blocks.0.conv1.weight']
    assert 'to_rgb.2.weight' in names
    dnames = [n for n, _ in d.named_parameters()]
    assert dnames[:4] == ['head.conv.weight', 'head.conv.bias',
                          'head.conv_out.weight', 'head.conv_out.bias']
    assert 'from_rgb.0.bias' in dnames
    # init: same structure and shapes as the JAX pytree
    assert jax.tree.map(np.shape, to_jax_tree(g)) == jax.tree.map(np.shape, params[0])
    assert jax.tree.map(np.shape, to_jax_tree(d)) == jax.tree.map(np.shape, params[1])


def test_converter_round_trip(params):
    g, d = port_models(params)
    for mod, tree in ((g, params[0]), (d, params[1])):
        back = to_jax_tree(mod)
        assert_tree_close(back, tree, rtol=0, atol=0)
        fresh = type(mod)(TCFG, torch.Generator().manual_seed(7), device='cpu')
        load_jax_tree(fresh, back)
        for a, b in zip(fresh.parameters(), mod.parameters()):
            assert torch.equal(a, b)


def test_converter_rejects_wrong_shape(params):
    g, _ = port_models(params)
    bad = jax.tree.map(np.copy, params[0])
    bad['to_rgb'][0]['w'] = np.zeros((1, 1, 3, 1), np.float32)
    with pytest.raises(ValueError, match='to_rgb.0.weight'):
        load_jax_tree(g, bad)


def test_init_stds_match_jax(params):
    # same structure and per-leaf stds as the JAX init (different streams)
    cfg = PGConfig(n_gen_features=(64, 64), n_dis_features=(64, 64),
                   latent_dim=64, image_size_init=4)
    jcfg = JPGConfig(n_gen_features=(64, 64), n_dis_features=(64, 64),
                     latent_dim=64, image_size_init=4)
    rng = torch.Generator().manual_seed(1)
    port = to_jax_tree(GeneratorPG(cfg, rng, device='cpu'))
    ref = init_generator_pg(jax.random.PRNGKey(1), jcfg)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(port),
                            jax.tree.leaves(ref)):
        assert a.shape == b.shape, path
        if a.size >= 4096:   # enough draws for a 10% std comparison
            assert np.std(a) == pytest.approx(float(jnp.std(b)), rel=0.1), path
    dport = to_jax_tree(DiscriminatorPG(cfg, rng, device='cpu'))
    assert np.all(dport['head']['conv']['b'] == 0)


@pytest.mark.parametrize('field,value', [('compute_dtype', 'mixed'),
                                         ('compute_dtype', 'bfloat16'),
                                         ('precision', None)])
def test_unported_config_fields_raise(field, value):
    # once unported, these values now construct on a packed config and
    # resolve as in the JAX package; an unknown value of the field raises
    cfg = PGConfig(**ARCH, packed_min_res=8, **{field: value})
    jcfg = JPGConfig(**ARCH, packed_min_res=8, **{field: value})
    assert (cfg.mixed, cfg.fused_up2, cfg.fused_pool) == \
        (jcfg.mixed, jcfg.fused_up2, jcfg.fused_pool)
    assert str(cfg.dtype).removeprefix('torch.') == str(jcfg.dtype)
    with pytest.raises(ValueError, match=field):
        PGConfig(**ARCH, packed_min_res=8,
                 **{field: 'float16' if field == 'compute_dtype' else 'high'})


def test_packed_config_checks():
    # packed_min_res must exceed the stem/head resolution, as in JAX; the
    # level boundaries fuse iff precision is None unless set
    with pytest.raises(ValueError, match='packed_min_res'):
        PGConfig(**ARCH, packed_min_res=4)
    cfg = PGConfig(**ARCH, packed_min_res=8, precision=None)
    assert cfg.fused_up2 and cfg.fused_pool
    cfg = PGConfig(**ARCH, packed_min_res=8)
    assert not cfg.fused_up2 and not cfg.fused_pool
    cfg = PGConfig(**ARCH, packed_min_res=8, precision=None, fuse_pool_conv=False)
    assert cfg.fused_up2 and not cfg.fused_pool
    assert PGConfig(**ARCH).dtype == torch.float32



# ---------------------------------------------------------------------------
# the 2x2 packed layout: blocks at 32^2 and above packed, so every branch
# of the level boundaries runs (G: unpacked -> packed at block 0, packed
# -> packed at block 1; D at phase 2: packed -> packed at block 0, packed
# -> unpacked at block 1).  JAX runs its packed kernels interpreted at
# precision=None (its pallas_conv gate needs it; XLA:CPU computes float32
# convs in float32 at either precision), fused boundaries off.
# ---------------------------------------------------------------------------

PACKED_ARCH = dict(n_gen_features=(16, 8, 8), n_dis_features=(8, 8, 16),
                   latent_dim=8, image_size_init=16, packed_min_res=32)
JCFG_P = JPGConfig(**PACKED_ARCH, precision=None, use_pallas=True,
                   pallas_epilogue=True, pallas_conv=True,
                   fuse_up2_conv=False, fuse_pool_conv=False)
TCFG_P = PGConfig(**PACKED_ARCH, use_kernels=True)


@pytest.fixture(scope='module')
def packed_params():
    kg, kd = jax.random.split(jax.random.PRNGKey(1))
    return (jax.tree.map(np.asarray, init_generator_pg(kg, JCFG_P)),
            jax.tree.map(np.asarray, init_discriminator_pg(kd, JCFG_P)))


@pytest.mark.parametrize('phase,alpha', CASES)
def test_packed_generator_forward_and_param_grads(packed_params, phase, alpha):
    rng = np.random.default_rng(20 + phase)
    z = rng.standard_normal((2, 8)).astype(np.float32)
    res = JCFG_P.resolution(phase)
    cot = rng.standard_normal((2, res, res, 1)).astype(np.float32)

    def loss(p):
        y = generator_pg(p, jnp.asarray(z), JCFG_P, phase, alpha)
        return jnp.sum(y * cot), y

    (_, jy), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(packed_params[0])
    g, _ = port_models(packed_params, TCFG_P)
    ty = g(torch.from_numpy(z), phase, alpha)
    (ty * torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(jy), **TOL)
    assert_tree_close(grads_tree(g), jg, **TOL, scaled=True)


@pytest.mark.parametrize('phase,alpha', CASES)
def test_packed_discriminator_forward_and_param_grads(packed_params, phase, alpha):
    rng = np.random.default_rng(30 + phase)
    res = JCFG_P.resolution(phase)
    x = rng.standard_normal((2, res, res, 1)).astype(np.float32)
    cot = rng.standard_normal((2, 1)).astype(np.float32)

    def loss(p):
        y = discriminator_pg(p, jnp.asarray(x), JCFG_P, phase, alpha)
        return jnp.sum(y * cot), y

    (_, jy), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(packed_params[1])
    _, d = port_models(packed_params, TCFG_P)
    ty = d(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), phase, alpha)
    (ty * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    assert_tree_close(grads_tree(d), jg, **TOL, scaled=True)


@pytest.mark.parametrize('knobs', [
    dict(use_kernels=False),
    dict(packed_min_res=None)])
def test_packed_kernel_path_matches_plain_paths(packed_params, knobs):
    # the packed kernel path against the plain packed path (what it is
    # held against on the card) and against the unpacked path (packing is
    # exact up to reordered sums)
    g1, d1 = port_models(packed_params, TCFG_P)
    g0, d0 = port_models(packed_params, dataclasses.replace(TCFG_P, **knobs))
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 8)).astype(np.float32))
    torch.testing.assert_close(g1(z, 2, 0.6), g0(z, 2, 0.6), rtol=1e-5, atol=1e-5)
    x = g0(z, 2).detach()
    torch.testing.assert_close(d1(x, 2), d0(x, 2), rtol=1e-5, atol=1e-5)


def test_packed_kernel_path_refuses_a_biased_conv(packed_params):
    # the fused packed conv kernel takes no bias: a biased conv2 raises on
    # the kernel path instead of leaving it for the plain ops
    g, _ = port_models(packed_params, TCFG_P)
    conv = g.blocks[1]['conv2']
    conv.bias = torch.nn.Parameter(torch.zeros(conv.weight.shape[0]))
    z = torch.zeros(2, 8)
    with pytest.raises(NotImplementedError, match='bias'):
        g(z, 2)
    g.cfg = dataclasses.replace(TCFG_P, use_kernels=False)
    assert torch.isfinite(g(z, 2)).all()


def test_growth_state_replays_jax():
    for res, alpha in ((16, 0.5), (8, 1.0), (4, 1.0)):
        a, b = GrowthState(TCFG), JGrowthState(JCFG)
        a.set_resolution(res, alpha)
        b.set_resolution(res, alpha)
        assert (a.phase, a.alpha, a.fading, a.image_size) == \
            (b.phase, b.alpha, b.fading, b.image_size)
    s = GrowthState(TCFG)
    s.increase_resolution()
    s.advance_transition(0.5)
    with pytest.raises(ValueError):
        s.increase_resolution()


def test_default_device_raises_without_cuda():
    code = ('import torch\n'
            'torch.cuda.is_available = lambda: False\n'
            'from neuron_gan_tpu_torch.models import GeneratorPG, PGConfig\n'
            'cfg = PGConfig((8, 8), (8, 8), latent_dim=4)\n'
            'try:\n'
            '    GeneratorPG(cfg, torch.Generator())\n'
            'except RuntimeError as e:\n'
            '    assert "CUDA is not available" in str(e), e\n'
            '    print("raised")\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'raised'
