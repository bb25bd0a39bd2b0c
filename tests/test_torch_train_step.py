"""The port's training step, epoch runner and schedule against the JAX
package, on the CPU.

The JAX package draws its randoms from fold_in keys (train_step.py:285-306,
data/augment.py:273-309); the tests recompute those draws and inject them
into the port's step, the only honest comparison between two RNG streams.
JAX runs ``use_pallas=True`` (interpreted) at 'highest' precision, the port
``use_kernels=True``.

Tolerances: gradients before the optimizer step rtol 1e-4 with atol 1e-5
times the leaf's largest magnitude; parameters after Adam within 2.5 lr
(Adam's first step moves every coordinate by about lr * sign(grad), so
float noise on a near-zero gradient can flip a coordinate by up to 2 lr --
tests/test_packed.py:245), and 99% of them within 1e-6; the per-epoch
scalars rtol 1e-6 (float32 arithmetic on both sides).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuron_gan_tpu import losses as jl
from neuron_gan_tpu import schedule as jsched
from neuron_gan_tpu import train_step as jts
from neuron_gan_tpu.data.augment import augment_batch as j_augment_batch
from neuron_gan_tpu.models import (
    PGConfig as JPGConfig, discriminator_pg, generator_pg,
    init_discriminator_pg, init_generator_pg)
from neuron_gan_tpu.utils.latents import sample_latent_vec as j_sample_latent

import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn
from neuron_gan_tpu_torch import schedule as tsched
from neuron_gan_tpu_torch import train_step as tts
from neuron_gan_tpu_torch.convert import load_jax_tree, to_jax_tree
from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG, PGConfig

ARCH = dict(n_gen_features=(16, 8, 8), n_dis_features=(8, 8, 16),
            latent_dim=8, image_size_init=4)
JCFG = JPGConfig(**ARCH, use_pallas=True, precision='highest')
TCFG = PGConfig(**ARCH, use_kernels=True)
LR = 1e-3
SPEC = dict(phase=2, fading=True, n_critic=1, batch_size=2, n_images=2,
            shuffle=False, crop_size=16, translation=0.05, augment=True,
            gp_lambda=10.0, drift_epsilon=0.001, sim_lambda0=0.0,
            sim_decay=0.0, beta1=0.5, rmsprop=False, lr0=LR, lr_gamma=0.99,
            lr_boundary=0, lr_cap=50, alpha_start=0, alpha_step=0.25,
            latent_dim=8)
FRAME = 24


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def jax_augment_draws(key, batch, frame, translation, degrees=180.0):
    out = {k: [] for k in ('angle', 'tx', 'ty', 'flip', 'brightness_first',
                           'brightness', 'contrast')}
    max_t = translation * frame
    for k in jax.random.split(key, batch):
        k_a, k_t1, k_t2, k_f, k_j = jax.random.split(k, 5)
        k_order, k_b, k_c = jax.random.split(k_j, 3)
        out['angle'].append(jax.random.uniform(k_a, (), minval=-degrees, maxval=degrees))
        out['tx'].append(jnp.round(jax.random.uniform(k_t1, (), minval=-max_t, maxval=max_t)))
        out['ty'].append(jnp.round(jax.random.uniform(k_t2, (), minval=-max_t, maxval=max_t)))
        out['flip'].append(jax.random.bernoulli(k_f))
        out['brightness'].append(jax.random.uniform(k_b, (), minval=0.75, maxval=1.25))
        out['contrast'].append(jax.random.uniform(k_c, (), minval=0.75, maxval=1.25))
        out['brightness_first'].append(jax.random.bernoulli(k_order))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def jax_batch_draws(k_batch, spec, batch, frame=FRAME):
    """The draws JAX's batch_body takes from ``k_batch``, as the port's
    draw_batch returns them."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    critic = []
    for j in range(max(spec['n_critic'], 1)):
        kj = jax.random.fold_in(k_batch, 1 + j)
        z1 = j_sample_latent(jax.random.fold_in(kj, 0), (batch, spec['latent_dim']))
        z2 = z1 if spec.get('gp_reuse_fakes') else j_sample_latent(
            jax.random.fold_in(kj, 1), (batch, spec['latent_dim']))
        eps = jax.random.uniform(jax.random.fold_in(kj, 2), (batch,))
        critic.append((t(z1), t(z2), t(eps)))
    zg = j_sample_latent(jax.random.fold_in(k_batch, 101), (batch, spec['latent_dim']))
    return {'augment': jax_augment_draws(jax.random.fold_in(k_batch, 0), batch,
                                         frame, spec['translation']),
            'critic': critic, 'zg': t(zg)}


@pytest.fixture(scope='module')
def params():
    kg, kd = jax.random.split(jax.random.PRNGKey(0))
    return (jax.tree.map(np.asarray, init_generator_pg(kg, JCFG)),
            jax.tree.map(np.asarray, init_discriminator_pg(kd, JCFG)))


def port_state(params, spec, cfg=TCFG):
    rng = torch.Generator().manual_seed(0)
    g = load_jax_tree(GeneratorPG(cfg, rng, device='cpu'), params[0])
    d = load_jax_tree(DiscriminatorPG(cfg, rng, device='cpu'), params[1])
    return tts.init_train_state(g, d, spec['beta1'], spec['rmsprop'],
                                spec.get('ema_beta', 0.0))


def grads_of(module):
    holder = type(module)(module.cfg, torch.Generator(), device='cpu')
    with torch.no_grad():
        for h, p in zip(holder.parameters(), module.parameters()):
            h.copy_(p.grad)
    return to_jax_tree(holder)


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def assert_grads_close(got, want):
    want = dict(leaves(want))
    for path, leaf in leaves(got):
        ref = np.asarray(want[path])
        np.testing.assert_allclose(
            leaf, ref, rtol=1e-4, atol=1e-5 * max(1.0, float(np.abs(ref).max())),
            err_msg=jax.tree_util.keystr(path))


def assert_params_close(got, want, lr):
    want = dict(leaves(want))
    close, total = 0, 0
    for path, leaf in leaves(got):
        ref = np.asarray(want[path])
        np.testing.assert_allclose(leaf, ref, rtol=0, atol=2.5 * lr,
                                   err_msg=jax.tree_util.keystr(path))
        close += int(np.sum(np.abs(leaf - ref) <= 1e-6))
        total += ref.size
    assert close >= 0.99 * total, (close, total)


def run_jax_step(params, spec, raw, k_batch, alpha, lr, lam, jcfg=JCFG):
    jspec = jts.ChunkSpec(**spec)
    state = jts.init_train_state(params[0], params[1],
                                 jts.make_optimizer(spec['beta1'], spec['rmsprop']),
                                 spec.get('ema_beta', 0.0))
    body = jax.jit(jts.make_batch_step(jcfg, jspec))
    new_state, stats = body(state, (jnp.asarray(raw), k_batch),
                            jnp.float32(alpha), jnp.float32(lr), jnp.float32(lam))
    return jax.tree.map(np.asarray, new_state), np.asarray(stats)


# ---------------------------------------------------------------------------
# one batch step
# ---------------------------------------------------------------------------

def check_batch_step(params, jcfg, tcfg, spec, frame):
    """One batch step of the port against the JAX package's, same draws."""
    raw = np.random.default_rng(0).random((2, frame, frame, 1)).astype(np.float32)
    k_batch = jax.random.PRNGKey(3)
    alpha, lr, lam = 0.5, LR, 0.0
    draws = jax_batch_draws(k_batch, spec, 2, frame)

    state = port_state(params, spec, tcfg)
    step = tts.make_batch_step(tcfg, tts.ChunkSpec(**spec))
    stats = step(state, torch.from_numpy(raw), draws, alpha, lr, lam).numpy()
    port_d_grads, port_g_grads = grads_of(state.d), grads_of(state.g)
    port_d_after = to_jax_tree(state.d)

    # JAX gradients at the same points: D at the initial params, G at the
    # port's updated critic (the step's G update sees the new D)
    g0, d0 = params
    phase = spec['phase']
    g_apply = lambda p, z: generator_pg(p, z, jcfg, phase, alpha)  # noqa: E731
    d_apply = lambda p, x: discriminator_pg(p, x, jcfg, phase, alpha)  # noqa: E731
    from neuron_gan_tpu.data.augment import AugmentSpec as JAugmentSpec
    res = jcfg.resolution(phase)
    images = j_augment_batch(jnp.asarray(raw), jax.random.fold_in(k_batch, 0),
                             JAugmentSpec(crop_size=spec['crop_size'], out_size=res,
                                          translation=0.05))
    z1, z2, eps = (jnp.asarray(v.numpy()) for v in draws['critic'][0])

    def d_total(dp):
        loss_w, _ = jl.d_w_loss(d_apply, g_apply, dp, g0, images, z1, 0.001)
        fake = jax.lax.stop_gradient(g_apply(g0, z2))
        return loss_w + jl.d_grad_pen_loss(d_apply, dp, images, fake, eps, 10.0)

    jd_grads = jax.jit(jax.grad(d_total))(d0)
    jg_grads = jax.jit(jax.grad(lambda gp: jl.g_w_loss(
        g_apply, d_apply, gp, port_d_after,
        jnp.asarray(draws['zg'].numpy()))[0]))(g0)
    assert_grads_close(port_d_grads, jd_grads)
    assert_grads_close(port_g_grads, jg_grads)

    jstate, jstats = run_jax_step(params, spec, raw, k_batch, alpha, lr, lam, jcfg)
    assert_params_close(port_d_after, jstate['d_params'], lr)
    assert_params_close(to_jax_tree(state.g), jstate['g_params'], lr)
    # critic-side stats before any update; G_loss after the critic's step
    np.testing.assert_allclose(stats[[0, 1, 2, 4, 5]], jstats[[0, 1, 2, 4, 5]],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(stats[3], jstats[3], rtol=0, atol=5e-3)


def test_batch_step_matches_jax(params):
    check_batch_step(params, JCFG, TCFG, dict(SPEC), FRAME)


# the packed configuration at a small size: blocks at 32^2 and above in the
# 2x2 layout with every packed kernel on (JAX: its Pallas kernels
# interpreted, at precision=None, which its pallas_conv gate needs)
PACKED_ARCH = dict(n_gen_features=(16, 8, 8), n_dis_features=(8, 8, 16),
                   latent_dim=8, image_size_init=16, packed_min_res=32)
JCFG_P = JPGConfig(**PACKED_ARCH, precision=None, use_pallas=True,
                   pallas_epilogue=True, pallas_conv=True,
                   fuse_up2_conv=False, fuse_pool_conv=False)
TCFG_P = PGConfig(**PACKED_ARCH, use_kernels=True)
PACKED_SPEC = dict(SPEC, crop_size=64)
PACKED_FRAME = 96


@pytest.fixture(scope='module')
def packed_params():
    kg, kd = jax.random.split(jax.random.PRNGKey(1))
    return (jax.tree.map(np.asarray, init_generator_pg(kg, JCFG_P)),
            jax.tree.map(np.asarray, init_discriminator_pg(kd, JCFG_P)))


def test_packed_batch_step_matches_jax(packed_params):
    check_batch_step(packed_params, JCFG_P, TCFG_P, dict(PACKED_SPEC), PACKED_FRAME)


@pytest.mark.parametrize('variant', [
    dict(phase=1, fading=False, n_critic=2, gp_reuse_fakes=True, ema_beta=0.9,
         sim_lambda0=0.5, sim_decay=0.1),
    dict(phase=0, fading=False, n_critic=0, rmsprop=True, augment=False),
])
def test_batch_step_variants_match_jax(params, variant):
    spec = dict(SPEC, **variant)
    raw = np.random.default_rng(1).random((2, FRAME, FRAME, 1)).astype(np.float32)
    k_batch = jax.random.PRNGKey(4)
    alpha, lr, lam = tts.epoch_scalars(tts.ChunkSpec(**spec), 3)
    draws = jax_batch_draws(k_batch, spec, 2)
    if not spec['augment']:
        draws['augment'] = None
    state = port_state(params, spec)
    step = tts.make_batch_step(TCFG, tts.ChunkSpec(**spec))
    stats = step(state, torch.from_numpy(raw), draws, alpha, lr, lam).numpy()
    jstate, jstats = run_jax_step(params, spec, raw, k_batch, alpha, lr, lam)
    assert_params_close(to_jax_tree(state.d), jstate['d_params'], lr)
    assert_params_close(to_jax_tree(state.g), jstate['g_params'], lr)
    if spec.get('ema_beta'):
        assert_params_close(to_jax_tree(state.g_ema), jstate['g_ema'], lr)
    np.testing.assert_allclose(stats, jstats, rtol=1e-3, atol=5e-3)


@pytest.mark.parametrize('shear_warp', [False, True, 'auto'])
def test_resolve_shear_matches_jax(shear_warp):
    for out_size in (16, 32, 64):
        assert tts.resolve_shear(shear_warp, out_size) == \
            jts.resolve_shear(shear_warp, out_size)
    for resolve in (tts.resolve_shear, jts.resolve_shear):
        with pytest.raises(ValueError, match='shear_warp must be'):
            resolve('always', 64)


def _one_step(params, spec, draws, raw):
    """(stats, D gradients, G gradients) of one port batch step."""
    state = port_state(params, spec)
    stats = tts.make_batch_step(TCFG, tts.ChunkSpec(**spec))(
        state, raw, draws, 0.5, LR, 0.0)
    return stats, [p.grad.clone() for p in state.d.parameters()], \
        [p.grad.clone() for p in state.g.parameters()]


def _assert_same_step(a, b):
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    for xs, ys in zip(a[1:], b[1:]):
        for x, y in zip(xs, ys):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize('shear_warp', ['auto', True])
def test_shear_without_fast_augment_runs_the_exact_path(params, shear_warp):
    # as the JAX package: the shear switch acts only on the fast path, so
    # with fast_augment off any shear_warp gives the exact augmentation
    spec = dict(SPEC, fast_augment=False, shear_warp=shear_warp)
    exact = dict(spec, shear_warp=False)
    aug = tts._augment_spec(TCFG, tts.ChunkSpec(**spec))
    assert aug == tts._augment_spec(TCFG, tts.ChunkSpec(**exact))
    assert not aug.shear and not aug.fast
    raw = torch.from_numpy(np.random.default_rng(2).random(
        (2, FRAME, FRAME, 1)).astype(np.float32))
    draws = tts.draw_batch(torch.Generator().manual_seed(1), TCFG,
                           tts.ChunkSpec(**spec), 2, FRAME)
    _assert_same_step(_one_step(params, spec, draws, raw),
                      _one_step(params, exact, draws, raw))


def test_gp_reuse_fakes_runs_the_generator_once_less(params, monkeypatch):
    # gp_reuse_fakes draws z2 = z1, and the penalty then takes the critic
    # loss's fake batch: a critic step runs G once where it ran twice, and
    # the step equals the knob off with an equal z2 injected.  Where the
    # injected z2 differs from z1 the penalty takes G(z2), as in JAX
    spec = dict(SPEC, n_critic=2, gp_reuse_fakes=True)
    raw = torch.from_numpy(np.random.default_rng(3).random(
        (2, FRAME, FRAME, 1)).astype(np.float32))
    draws = tts.draw_batch(torch.Generator().manual_seed(2), TCFG,
                           tts.ChunkSpec(**spec), 2, FRAME)
    assert all(z1 is z2 for z1, z2, _ in draws['critic'])
    copied = dict(draws, critic=[(z1, z1.clone(), eps)
                                 for z1, _, eps in draws['critic']])
    apart = tts.draw_batch(torch.Generator().manual_seed(2), TCFG,
                           tts.ChunkSpec(**dict(spec, gp_reuse_fakes=False)),
                           2, FRAME)
    calls = []
    forward = GeneratorPG.forward
    monkeypatch.setattr(GeneratorPG, 'forward', lambda self, *a, **kw: (
        calls.append(1), forward(self, *a, **kw))[1])
    runs, g_forwards = [], []
    for reuse, ds in ((True, draws), (False, copied), (True, apart),
                      (False, apart)):
        n0 = len(calls)
        runs.append(_one_step(params, dict(spec, gp_reuse_fakes=reuse),
                              ds, raw))
        g_forwards.append(len(calls) - n0)
    # G(z1) and G(z2) per critic step unless z2 is z1; the generator step
    # runs G once more
    assert g_forwards == [2 + 1, 2 * 2 + 1, 2 * 2 + 1, 2 * 2 + 1]
    _assert_same_step(*runs[:2])
    _assert_same_step(*runs[2:])


def test_step_restores_tf32_flags():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    from neuron_gan_tpu_torch.models import precision_scope
    with precision_scope('highest'):
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    with precision_scope(None):
        assert torch.backends.cudnn.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


@pytest.mark.parametrize('phase,fading', [(1, False), (2, False), (2, True)])
def test_epilogue_launches_per_step(params, monkeypatch, phase, fading):
    # the counts chip_smoke.py expects on the card: per step, 2*phase
    # epilogues per G or D forward; 7 forwards (critic: G, D, D, G, D;
    # generator: G, D) and 6 backwards (critic: D real, D fake, the GP's
    # inner and outer pass; generator: D, G)
    calls = {'fwd': 0, 'bwd': 0}
    real_fwd, real_bwd = lpn._fwd, lpn._bwd

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(lpn, '_fwd', count('fwd', real_fwd))
    monkeypatch.setattr(lpn, '_bwd', count('bwd', real_bwd))
    spec = dict(SPEC, phase=phase, fading=fading)
    state = port_state(params, spec)
    gen = torch.Generator().manual_seed(0)
    draws = tts.draw_batch(gen, TCFG, tts.ChunkSpec(**spec), 2, FRAME)
    tts.make_batch_step(TCFG, tts.ChunkSpec(**spec))(
        state, torch.rand(2, FRAME, FRAME, 1, generator=gen), draws, 0.5, LR, 0.0)
    assert calls == {'fwd': 14 * phase, 'bwd': 12 * phase}


def load_chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / 'chip_smoke.py'
    spec_ = importlib.util.spec_from_file_location('chip_smoke', path)
    smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(smoke)
    return smoke


def count_launches(monkeypatch, cfg, spec, params, frame=None):
    """Every kernel wrapper's launches in one batch step of ``cfg`` on raw
    frames of side ``frame`` (default PACKED_FRAME), keyed as
    chip_smoke.py keys its counters, counted by wrapping each launch."""
    frame = frame or PACKED_FRAME
    import neuron_gan_tpu_torch.ops.packed_conv_lrelu_pn as pcl
    smoke = load_chip_smoke()
    calls = {'k1': {}, 'k2': {}, 'k3': {}, 'k4': {}}

    def count(name, fn, grouped):
        def wrapped(x, *a):
            # (x, ..., n_groups, neg_slope, eps) for the grouped epilogue
            key = smoke.launch_key(lpn.dtype_name(x), a[-3] if grouped else None)
            calls[name][key] = calls[name].get(key, 0) + 1
            return fn(x, *a)
        return wrapped

    monkeypatch.setattr(lpn, '_fwd', count('k1', lpn._fwd, True))
    monkeypatch.setattr(lpn, '_bwd', count('k2', lpn._bwd, True))
    monkeypatch.setattr(pcl, '_conv_fwd', count('k3', pcl._conv_fwd, False))
    monkeypatch.setattr(pcl, '_dz', count('k4', pcl._dz, False))
    state = port_state(params, spec, cfg)
    gen = torch.Generator().manual_seed(0)
    draws = tts.draw_batch(gen, cfg, tts.ChunkSpec(**spec), 2, frame)
    tts.make_batch_step(cfg, tts.ChunkSpec(**spec))(
        state, torch.rand(2, frame, frame, 1, generator=gen), draws, 0.5, LR, 0.0)
    return calls, smoke


@pytest.mark.parametrize('phase,fading', [(1, False), (2, False), (2, True)])
def test_packed_launches_per_step(packed_params, monkeypatch, phase, fading):
    # the counts chip_smoke.py expects on the card for the packed path
    # (chip_smoke.expected_launches)
    spec = dict(PACKED_SPEC, phase=phase, fading=fading)
    calls, smoke = count_launches(monkeypatch, TCFG_P, spec, packed_params)
    assert calls == smoke.expected_launches(TCFG_P, [phase])
    assert calls['k3'] and calls['k4'] and calls['k1'].get('float32/4')
    # the unpacked path's counts, as test_epilogue_launches_per_step has them
    assert smoke.expected_launches(TCFG, [phase]) == {
        'k1': {'float32/1': 14 * phase}, 'k2': {'float32/1': 12 * phase},
        'k3': {}, 'k4': {}}


@pytest.mark.parametrize('phase,fading', [(1, False), (2, True)])
def test_mixed_launches_per_step(packed_params, monkeypatch, phase, fading):
    # the mixed path (fused level boundaries at precision=None): the
    # packed path's counts, every launch in bfloat16
    cfg = dataclasses.replace(TCFG_P, compute_dtype='mixed', precision=None)
    assert cfg.fused_up2 and cfg.fused_pool
    spec = dict(PACKED_SPEC, phase=phase, fading=fading)
    calls, smoke = count_launches(monkeypatch, cfg, spec, packed_params)
    want = smoke.expected_launches(cfg, [phase])
    assert calls == want
    f32 = smoke.expected_launches(TCFG_P, [phase])
    assert want == {k: {n.replace('float32', 'bfloat16'): c for n, c in v.items()}
                    for k, v in f32.items()}



def test_flagship_packed_launches_per_512_step():
    # the packed flagship differs from the unpacked one only in its layout
    # (use_kernels gates all four kernels); a steady 512^2 step launches
    # the counts PERF.md lists
    from neuron_gan_tpu_torch.flagship import (
        flagship_config, flagship_packed_config)
    cfg = flagship_packed_config()
    assert cfg == dataclasses.replace(flagship_config(), packed_min_res=64)
    assert load_chip_smoke().expected_launches(cfg, [5]) == {
        'k1': {'float32/1': 22, 'float32/4': 24},
        'k2': {'float32/1': 22, 'float32/4': 19},
        'k3': {'float32': 24}, 'k4': {'float32': 19}}

# ---------------------------------------------------------------------------
# epoch runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shuffle', [False, True])
def test_epoch_runner_partial_batch_and_draw_order(params, shuffle):
    # 3 images, batch 2: one full batch and a partial batch of 1, stats
    # weighted by true batch sizes over n_images; the runner's draws are
    # the permutation, then each batch's draw_batch, from one generator
    spec = dict(SPEC, phase=1, fading=False, n_images=3, shuffle=shuffle)
    cs = tts.ChunkSpec(**spec)
    images = torch.rand(3, FRAME, FRAME, 1, generator=torch.Generator().manual_seed(9))
    run = tts.make_epoch_runner(TCFG, cs, n_epochs=2)
    got = run(port_state(params, spec), images, torch.Generator().manual_seed(5), 4)

    state = port_state(params, spec)
    step = tts.make_batch_step(TCFG, cs)
    gen = torch.Generator().manual_seed(5)
    want = []
    for epoch in (4, 5):
        alpha, lr, lam = tts.epoch_scalars(cs, epoch)
        order = torch.randperm(3, generator=gen) if shuffle else torch.arange(3)
        total = 0
        for rows in (order[:2], order[2:]):
            draws = tts.draw_batch(gen, TCFG, cs, len(rows), FRAME)
            total = total + step(state, images[rows], draws, alpha, lr, lam)
        want.append(total / 3)
    assert got.shape == (2, len(tts.STAT_NAMES))
    torch.testing.assert_close(got, torch.stack(want), rtol=1e-6, atol=1e-6)
    assert torch.isfinite(got).all()


# ---------------------------------------------------------------------------
# schedule and per-epoch scalars
# ---------------------------------------------------------------------------

SCHEDULES = [
    dict(transit_sch=(2, 4, 6, 8, 10), alpha_step=0.5, n_epochs=12,
         checkpointing_period=100, lr0=1e-4),
    dict(transit_sch=(5, 10), alpha_step=0.25, n_epochs=20,
         checkpointing_period=6, lr0=1e-3),
    dict(transit_sch=(100, 300), alpha_step=0.01, n_epochs=700,
         checkpointing_period=50, lr0=2e-4),
]


@pytest.mark.parametrize('kw', SCHEDULES)
def test_schedule_copy_matches_jax(kw):
    a, b = tsched.TrainSchedule(**kw), jsched.TrainSchedule(**kw)
    for e in range(1, kw['n_epochs'] + 1):
        assert a.phase_at(e) == b.phase_at(e)
        assert a.fading_at(e) == b.fading_at(e)
        assert a.alpha_at(e) == b.alpha_at(e)
        assert a.lr_at(e) == b.lr_at(e)
    assert list(a.plan_chunks(1, kw['n_epochs'] + 1)) == \
        list(b.plan_chunks(1, kw['n_epochs'] + 1))
    assert tsched.sim_lambda_at(7, 0.5, 0.1) == jsched.sim_lambda_at(7, 0.5, 0.1)
    with pytest.raises(ValueError, match='fade'):
        tsched.TrainSchedule(transit_sch=(10, 12), alpha_step=0.1, n_epochs=20,
                             checkpointing_period=5, lr0=1e-4)


@pytest.mark.parametrize('kw', SCHEDULES)
def test_spec_for_chunk_drives_schedule_lr_and_alpha(kw):
    # the per-epoch scalars of every chunk's spec reproduce the host
    # schedule's lr and alpha at every epoch (the JAX package's
    # traced-vs-host property, tests/test_train_step.py)
    sched = tsched.TrainSchedule(**kw)
    base = tts.ChunkSpec(**SPEC)
    for start, end in sched.plan_chunks(1, kw['n_epochs'] + 1):
        spec = tts.spec_for_chunk(sched, start, base)
        assert spec.phase == sched.phase_at(start)
        for e in range(start, end + 1):
            alpha, lr, _ = tts.epoch_scalars(spec, e)
            assert lr == pytest.approx(sched.lr_at(e), rel=1e-5)
            assert alpha == pytest.approx(sched.alpha_at(e), rel=1e-6)


@pytest.mark.parametrize('over', [
    dict(fading=False),
    dict(fading=True, alpha_start=3, alpha_step=0.3),
    dict(lr_boundary=4, lr_prev_final=3.3e-4, lr_cap=2, lr_gamma=0.7),
    dict(sim_lambda0=0.5, sim_decay=0.1),
    dict(sim_lambda0=0.5, sim_decay=0.0),
    dict(sim_lambda0=1e-4, sim_decay=0.9),
])
def test_epoch_scalars_match_jax(over):
    spec = dict(SPEC, **over)
    js, ts = jts.ChunkSpec(**spec), tts.ChunkSpec(**spec)
    for epoch in range(1, 12):
        want = [float(v) for v in jts.epoch_scalars(js, jnp.int32(epoch))]
        got = tts.epoch_scalars(ts, epoch)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_adam_matches_jax_optimizer_two_steps():
    # torch.optim semantics == the JAX package's optax scale_by_adam + lr
    w = np.array([1.0, -2.0, 3.0], np.float32)
    grads = [np.array([0.1, 0.2, -0.3], np.float32),
             np.array([-0.05, 0.4, 0.0], np.float32)]
    opt = jts.make_optimizer(beta1=0.5)
    jw, st = jnp.asarray(w), None
    st = opt.init(jw)
    p = torch.nn.Parameter(torch.from_numpy(w.copy()))
    topt = tts.make_optimizer([p], beta1=0.5)
    for g in grads:
        upd, st = opt.update(jnp.asarray(g), st, jw)
        jw = jw - 1e-3 * upd
        tts._set_lr(topt, 1e-3)
        p.grad = torch.from_numpy(g.copy())
        topt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jw), rtol=1e-5, atol=1e-7)


def test_flagship_mixed_config_is_the_jax_shipping_numerics():
    # the JAX package's flagship_config(packed_lanes=None): 'mixed' at
    # precision=None on the 2x2 layout, fused boundaries, every kernel on
    from neuron_gan_tpu.flagship import flagship_config as jflag
    from neuron_gan_tpu_torch.flagship import (
        flagship_mixed_config, flagship_packed_config)
    cfg, jcfg = flagship_mixed_config(), jflag(packed_lanes=None)
    for f in ('n_gen_features', 'n_dis_features', 'latent_dim', 'image_size_init',
              'n_colors', 'neg_slope', 'compute_dtype', 'precision',
              'packed_min_res', 'fused_up2', 'fused_pool', 'mixed'):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.use_kernels and cfg.fused_up2 and cfg.fused_pool
    assert cfg == dataclasses.replace(flagship_packed_config(), compute_dtype='mixed',
                                      precision=None)
    assert load_chip_smoke().expected_launches(cfg, [5]) == {
        'k1': {'bfloat16/1': 22, 'bfloat16/4': 24},
        'k2': {'bfloat16/1': 22, 'bfloat16/4': 19},
        'k3': {'bfloat16': 24}, 'k4': {'bfloat16': 19}}


def test_flagship_geometry():
    from neuron_gan_tpu.flagship import flagship_config as jflag
    from neuron_gan_tpu_torch.flagship import flagship_chunk_spec, flagship_config
    cfg, jcfg = flagship_config(), jflag()
    for f in ('n_gen_features', 'n_dis_features', 'latent_dim',
              'image_size_init', 'n_colors', 'neg_slope'):
        assert getattr(cfg, f) == getattr(jcfg, f)
    assert cfg.use_kernels and cfg.precision == 'highest'
    assert cfg.compute_dtype == 'float32'
    spec = flagship_chunk_spec(5)
    assert (spec.batch_size, spec.n_critic, spec.gp_lambda,
            spec.drift_epsilon, spec.lr0) == (8, 1, 10.0, 0.001, 1e-4)
    assert not spec.fast_augment and not spec.shear_warp
