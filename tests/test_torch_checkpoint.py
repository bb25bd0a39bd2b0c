"""The port's checkpoints against the JAX package's, on the CPU: the
native ``.npz`` train state (parameters, Adam or RMSprop state, the EMA
generator) in both directions, the tree spec's namedtuple strings, one
Adam step after a load, reference ``.pth`` files in both directions at a
steady and a fading growth state, and the eval grids both packages render
from one checkpoint.

Tolerances: loads are exact (every leaf bit for bit); one Adam step rtol
1e-5 / atol 1e-7 (torch.optim and optax order the update's float32
arithmetic differently; tests/test_torch_train_step.py's Adam test); the
rendered images atol 1e-5 (both at float32 'highest').
"""

import json
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuron_gan_tpu import checkpoint as jck
from neuron_gan_tpu import train_step as jts
from neuron_gan_tpu.models import GrowthState as JGrowthState
from neuron_gan_tpu.models import PGConfig as JPGConfig
from neuron_gan_tpu.utils.plotting import plot_gen_samples as j_plot_gen_samples

from neuron_gan_tpu_torch import checkpoint as tck
from neuron_gan_tpu_torch import train_step as tts
from neuron_gan_tpu_torch.convert import load_jax_state, to_jax_state
from neuron_gan_tpu_torch.eval import load_generator
from neuron_gan_tpu_torch.utils.plotting import plot_gen_samples

from test_torch_train_step import (  # noqa: F401  (fixtures)
    ARCH, FRAME, LR, SPEC, TCFG, params, port_state)

OPTIMIZERS = {'adam': dict(rmsprop=False), 'rmsprop': dict(rmsprop=True),
              'adam_ema': dict(rmsprop=False, ema_beta=0.9)}


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def assert_trees_equal(got, want):
    """Same structure (dict keys, sequence lengths), every leaf bit for bit
    with the same dtype."""
    assert (jax.tree_util.tree_structure(jax.tree.map(lambda _: 0, tuple_free(got)))
            == jax.tree_util.tree_structure(jax.tree.map(lambda _: 0, tuple_free(want))))
    for (path, a), (_, b) in zip(leaves(tuple_free(got)), leaves(tuple_free(want))):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), jax.tree_util.keystr(path)


def tuple_free(tree):
    """Namedtuples and tuples as lists (a loaded tree rebuilds them as
    plain tuples)."""
    if isinstance(tree, dict):
        return {k: tuple_free(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tuple_free(v) for v in tree]
    return np.asarray(tree)


def stepped_port_state(params, kind):
    """The port's train state after one batch step (Adam/RMSprop state
    live)."""
    spec = dict(SPEC, **OPTIMIZERS[kind])
    state = port_state(params, spec)
    raw = torch.from_numpy(np.random.default_rng(0).random(
        (2, FRAME, FRAME, 1)).astype(np.float32))
    draws = tts.draw_batch(torch.Generator().manual_seed(0), TCFG,
                           tts.ChunkSpec(**spec), 2, FRAME)
    tts.make_batch_step(TCFG, tts.ChunkSpec(**spec))(state, raw, draws, 0.5,
                                                    LR, 0.0)
    return state, spec


def jax_state(params, kind, seed=None):
    """JAX's train state; with ``seed``, every optimizer moment and the EMA
    generator drawn at random (and Adam's count 3), as after some steps."""
    o = OPTIMIZERS[kind]
    state = jts.init_train_state(params[0], params[1],
                                 jts.make_optimizer(0.5, o['rmsprop']),
                                 o.get('ema_beta', 0.0))
    if seed is None:
        return state
    rng = np.random.default_rng(seed)

    def draw(tree):
        return jax.tree.map(lambda a: np.abs(rng.standard_normal(
            np.shape(a))).astype(np.float32) * 1e-3, tree)

    for opt in ('g_opt', 'd_opt'):
        s = state[opt]
        state[opt] = ({'nu': draw(s['nu'])} if o['rmsprop'] else
                      type(s)(np.asarray(3, np.int32), draw(s.mu), draw(s.nu)))
    if 'g_ema' in state:
        state['g_ema'] = draw(state['g_ema'])
    return jax.tree.map(np.asarray, state)


@pytest.mark.parametrize('kind', sorted(OPTIMIZERS))
def test_port_npz_loads_in_jax(params, tmp_path, kind):
    state, _ = stepped_port_state(params, kind)
    tree = to_jax_state(state)
    ck = tck.Checkpointer(str(tmp_path / 'GenDisc_t.npz'), n_epochs=5,
                          verbose=False)
    ck.loss_real[:] = np.arange(5.0)
    ck.save_state(3, tree, {'image_size': 16, 'alpha': 0.5})
    payload, meta = jck.load_pytree_npz(str(tmp_path / 'GenDisc_t.npz'))
    assert meta['epoch'] == 3 and list(payload['series']['Loss_real']) == [0, 1, 2]
    merged, report = jck.merge_state_tolerant(jax_state(params, kind),
                                              payload['state'])
    assert report == {'missing': [], 'unexpected': [], 'mismatched': []}
    assert_trees_equal(merged, tree)
    if kind != 'rmsprop':
        assert type(merged['d_opt']).__name__ == 'ScaleByAdamState'
        assert merged['d_opt'].count.dtype == np.int32 and merged['d_opt'].count == 1


@pytest.mark.parametrize('kind', sorted(OPTIMIZERS))
def test_jax_npz_loads_in_port(params, tmp_path, kind):
    spec = dict(SPEC, **OPTIMIZERS[kind])
    jstate = jax_state(params, kind, seed=3)
    path = str(tmp_path / 'j.npz')
    jck.save_pytree_npz(path, {'state': jstate, 'series': {}}, {'epoch': 1})
    tree, _ = tck.load_pytree_npz(path)
    state = port_state(params, spec)
    report = load_jax_state(state, tree['state'])
    assert report == {'missing': [], 'unexpected': [], 'mismatched': []}
    assert_trees_equal(to_jax_state(state), jstate)


def test_tree_spec_strings_match_jax(params, tmp_path):
    # the spec the port writes is the one JAX writes for the same state,
    # namedtuple module and name included, read from a JAX-written file
    state, _ = stepped_port_state(params, 'adam_ema')
    jck.save_pytree_npz(str(tmp_path / 'j.npz'),
                        {'state': jax_state(params, 'adam_ema')}, None)
    tck.save_pytree_npz(str(tmp_path / 't.npz'), {'state': to_jax_state(state)})
    specs = [json.loads(bytes(np.load(tmp_path / f)['__treedef__']).decode())
             for f in ('j.npz', 't.npz')]
    assert specs[1] == specs[0]
    adam = [v for k, v in specs[0]['items'][0][1]['items'] if k == 'd_opt'][0]
    assert (adam['module'], adam['name']) == ('optax._src.transform',
                                              'ScaleByAdamState')


def test_one_adam_step_after_load_matches_jax(params, tmp_path):
    # JAX's state after some steps, saved by JAX, loaded by the port; then
    # one more Adam step with the same gradients and lr in each package
    spec = dict(SPEC)
    jstate = jax_state(params, 'adam', seed=4)
    jck.save_pytree_npz(str(tmp_path / 'j.npz'), {'state': jstate}, None)
    state = port_state(params, spec)
    load_jax_state(state, tck.load_pytree_npz(str(tmp_path / 'j.npz'))[0]['state'])

    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                         jstate['d_params'])
    opt = jts.make_optimizer(0.5)
    want, _ = jts._apply_update(jstate['d_params'], jstate['d_opt'],
                                jax.tree.map(jnp.asarray, grads), opt, 2e-3)
    holder = port_state(params, spec).d
    from neuron_gan_tpu_torch.convert import load_jax_tree, to_jax_tree
    load_jax_tree(holder, grads)
    for p, g in zip(state.d.parameters(), holder.parameters()):
        p.grad = g.detach().clone()
    tts._set_lr(state.d_opt, 2e-3)
    state.d_opt.step()
    got = to_jax_tree(state.d)
    for (path, a), (_, b) in zip(leaves(got), leaves(jax.tree.map(np.asarray, want))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# reference .pth
# ---------------------------------------------------------------------------

JCFG_REF = JPGConfig(**ARCH)


def _growth(cls, cfg, phase, alpha):
    g = cls(cfg)
    g.set_resolution(cfg.resolution(phase), alpha)
    return g


@pytest.mark.parametrize('writer', ['jax', 'port'])
@pytest.mark.parametrize('phase,alpha', [(2, 1.0), (2, 0.5)])
def test_reference_pth_across_packages(params, tmp_path, writer, phase, alpha):
    from neuron_gan_tpu_torch.models import GrowthState, PGConfig
    g, d = params
    path = str(tmp_path / 'ref.pth')
    series = {'Loss_real': np.arange(4.0), 'Loss_G': np.ones(4)}
    if writer == 'jax':
        jck.save_reference_checkpoint(path, g, d, JCFG_REF,
                                      _growth(JGrowthState, JCFG_REF, phase, alpha),
                                      epoch=4, lr=3e-4, series=series)
    else:
        cfg = PGConfig(**ARCH)
        tck.save_reference_checkpoint(path, g, d, cfg,
                                      _growth(GrowthState, cfg, phase, alpha),
                                      epoch=4, lr=3e-4, series=series)
    jg, jd, jcfg, jgrowth, jmeta = jck.import_reference_checkpoint(path)
    tg, td, tcfg, tgrowth, tmeta = tck.import_reference_checkpoint(path)
    assert_trees_equal(tg, jg)
    assert_trees_equal(td, jd)
    # the weights the growth state reaches are the ones written
    assert np.array_equal(tg['blocks'][1]['conv2']['w'], g['blocks'][1]['conv2']['w'])
    assert np.array_equal(td['head']['conv_out']['b'], d['head']['conv_out']['b'])
    assert (tgrowth.phase, tgrowth.alpha) == (jgrowth.phase, jgrowth.alpha) == (phase, alpha)
    for f in ('n_gen_features', 'n_dis_features', 'latent_dim',
              'image_size_init', 'n_colors', 'neg_slope'):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert (tmeta['epoch'], tmeta['lr']) == (jmeta['epoch'], jmeta['lr']) == (4, 3e-4)
    for k in ('Loss_real', 'Loss_fake', 'Loss_G', 'Loss_D'):
        assert np.array_equal(tmeta[k], jmeta[k]), k


class _Evil:
    def __reduce__(self):
        return (print, ('unpickled',))


def test_load_pth_refuses_other_globals(tmp_path):
    torch.save({'x': _Evil()}, tmp_path / 'evil.pth')
    with pytest.raises(pickle.UnpicklingError):
        tck.load_pth(str(tmp_path / 'evil.pth'))


# ---------------------------------------------------------------------------
# the eval grid from one checkpoint, in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('fmt', ['npz', 'pth'])
@pytest.mark.parametrize('phase,alpha', [(2, 1.0), (1, 0.5)])
def test_eval_grids_match_jax(params, tmp_path, fmt, phase, alpha):
    from neuron_gan_tpu_torch.models import GrowthState, PGConfig
    g, d = params
    cfg = PGConfig(**ARCH)
    path = str(tmp_path / f'w.{fmt}')
    if fmt == 'pth':
        tck.save_reference_checkpoint(path, g, d, cfg,
                                      _growth(GrowthState, cfg, phase, alpha))
        jg, _, jcfg, jgrowth, _ = jck.import_reference_checkpoint(path)
    else:
        meta = {'image_size': cfg.resolution(phase), 'alpha': alpha,
                'phase': phase, 'N_gen_features': list(ARCH['n_gen_features']),
                'N_dis_features': list(ARCH['n_dis_features']),
                'latent_dim': ARCH['latent_dim'],
                'image_size_init': ARCH['image_size_init']}
        tck.save_pytree_npz(path, {'state': {'g_params': g, 'd_params': d},
                                   'series': {}}, meta)
        tree, _ = jck.load_pytree_npz(path)
        jg, jcfg = tree['state']['g_params'], JCFG_REF
        jgrowth = _growth(JGrowthState, jcfg, phase, alpha)
    z = np.random.default_rng(9).standard_normal((4, ARCH['latent_dim']))
    z = (z / np.linalg.norm(z, axis=1, keepdims=True)).astype(np.float32)
    want = j_plot_gen_samples(jax.tree.map(jnp.asarray, jg), jcfg, jgrowth,
                              eval_noise=jnp.asarray(z),
                              filename=str(tmp_path / 'j.png'))
    tg, tgrowth = load_generator(path, 'cpu')
    got = plot_gen_samples(tg, tgrowth, eval_noise=torch.from_numpy(z),
                           filename=str(tmp_path / 't.png'))
    assert got.shape == want.shape == (4, 16, 16, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    from PIL import Image
    a = np.array(Image.open(tmp_path / 'j.png')).astype(int)
    b = np.array(Image.open(tmp_path / 't.png')).astype(int)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1
