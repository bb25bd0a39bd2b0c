"""The legacy DCGAN / WGAN families of the port (models/legacy.py,
legacy_train.py, the legacy converters of convert.py) against the JAX
package's (neuron_gan_tpu/models/legacy.py, the root legacy_train.py) on
the CPU, at small sizes.

The nets take the JAX package's parameters through ``load_legacy``: their
outputs in train and eval mode and the BN running statistics after a
train-mode forward agree at rtol 1e-5 / atol 1e-6 (JAX at 'highest').

The WGAN trainer runs on the JAX package's draws, rebuilt from its keys
(``fold_in(kb, 0)`` for the augmentation, ``fold_in(kb, 1 + j)`` for critic
step j, ``fold_in(kb, 101)`` for the generator) and its permutation: the
stats at rtol 1e-5 / atol 1e-6; the parameters after the optimizer steps
and the clamp 99% within 1e-6 and all within 2.5 times the largest move
of those steps (an optimizer's first steps move a coordinate by about
lr * sign(grad) for Adam, 10 lr * sign(grad) for RMSprop, so float noise
on a near-zero gradient moves it by up to twice that, as in
test_torch_train_step.py); the BN running variances at rtol 1e-5 / atol
1e-6 and the running means within that bound (a conv bias ahead of a
BatchNorm has a gradient of zero up to rounding, so it moves by noise;
the running mean, an average of batch means with weights summing to at
most 1, carries the bias's offset and no more).

Legacy ``.npz`` checkpoints load across the packages, and the train CLI
runs ``wgan=True``: a resumed session continues the run bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import legacy_train as jlt
from neuron_gan_tpu.checkpoint import Checkpointer as JCheckpointer
from neuron_gan_tpu.models import legacy as jlegacy
from neuron_gan_tpu.train_step import make_optimizer as j_make_optimizer
from neuron_gan_tpu.utils.latents import sample_latent_vec as j_sample_latent

from neuron_gan_tpu_torch import legacy_train as tlt
from neuron_gan_tpu_torch import train as ttrain
from neuron_gan_tpu_torch.checkpoint import Checkpointer, load_pytree_npz
from neuron_gan_tpu_torch.convert import (
    legacy_to_jax, load_jax_legacy_state, load_legacy, to_jax_legacy_state)
from neuron_gan_tpu_torch.models.legacy import (
    DiscriminatorDCGAN, DiscriminatorWGAN, GeneratorDCGAN, GeneratorWGAN)

from test_torch_cli import flat, write_config
from test_torch_train_step import jax_augment_draws

HIGHEST = jax.lax.Precision.HIGHEST
LATENT = 8
G_FEATS, D_FEATS, SIZE = (16, 8, 8), (8, 8, 16), 32
DC_FEATS = (16, 8, 8, 8, 8, 8, 8)


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def assert_trees_close(got, want, rtol=1e-5, atol=1e-6):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for x, y in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


def assert_params_close(got, want, bound):
    close = total = 0
    for x, y in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(x, y, rtol=0, atol=bound)
        close += int(np.sum(np.abs(x - y) <= 1e-6))
        total += y.size
    assert close >= 0.99 * total, (close, total)


def nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def jax_nets(family, key=0):
    """((params, bn_states, meta) of G, of D, G's and D's forward), the
    trees as numpy arrays (JAX's epoch runner donates its state)."""
    kg, kd = jax.random.split(jax.random.PRNGKey(key))
    if family == 'wgan':
        g = jlegacy.init_generator_wgan(kg, G_FEATS, latent_dim=LATENT,
                                        image_size=SIZE)
        d = jlegacy.init_discriminator_wgan(kd, D_FEATS, image_size=SIZE)
        fns = jlegacy.generator_wgan, jlegacy.discriminator_wgan
    else:
        g = jlegacy.init_generator_dcgan(kg, DC_FEATS, latent_dim=LATENT)
        d = jlegacy.init_discriminator_dcgan(kd, DC_FEATS)
        fns = jlegacy.generator_dcgan, jlegacy.discriminator_dcgan
    host = lambda net: (*jax.tree.map(np.asarray, net[:2]), net[2])  # noqa: E731
    return (host(g), host(d), *fns)


def port_nets(family, jg, jd):
    rng = torch.Generator().manual_seed(0)
    if family == 'wgan':
        g = GeneratorWGAN(G_FEATS, rng, latent_dim=LATENT, image_size=SIZE)
        d = DiscriminatorWGAN(D_FEATS, rng, image_size=SIZE)
    else:
        g = GeneratorDCGAN(DC_FEATS, rng, latent_dim=LATENT)
        d = DiscriminatorDCGAN(DC_FEATS, rng)
    return load_legacy(g, *jg[:2]), load_legacy(d, *jd[:2])


@pytest.mark.parametrize('family', ['wgan', 'dcgan'])
def test_nets_match_jax_in_train_and_eval_mode(family):
    jg, jd, g_fn, d_fn = jax_nets(family)
    g, d = port_nets(family, jg, jd)
    # the converters are exact both ways
    for module, want in ((g, jg), (d, jd)):
        got = legacy_to_jax(module)
        for x, y in zip(leaves(got), leaves(want[:2])):
            assert np.array_equal(x, y)
        assert jax.tree.structure(got) == jax.tree.structure(tuple(want[:2]))

    z = np.random.default_rng(0).standard_normal((3, LATENT)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    zt = torch.from_numpy(z)
    for training in (True, False):
        g.train(training)
        d.train(training)
        j_img, j_gbn = g_fn(jg[0], jg[1], jnp.asarray(z), jg[2],
                            training=training, precision=HIGHEST)
        j_score, j_dbn = d_fn(jd[0], jd[1], j_img, jd[2], training=training,
                              precision=HIGHEST)
        with torch.no_grad():
            img = g(zt)
            score = d(nchw(j_img))
        np.testing.assert_allclose(nhwc(img), np.asarray(j_img),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(score.numpy(), np.asarray(j_score),
                                   rtol=1e-5, atol=1e-6)
        # train mode advanced the running statistics as JAX's batch_norm
        assert_trees_close(legacy_to_jax(g)[1], j_gbn)
        assert_trees_close(legacy_to_jax(d)[1], j_dbn)
        # the next forward (eval mode) starts from them on both sides
        jg, jd = (jg[0], j_gbn, jg[2]), (jd[0], j_dbn, jd[2])


def test_init_distributions():
    rng = torch.Generator().manual_seed(3)
    g = GeneratorWGAN((64, 32, 32), rng, latent_dim=64, image_size=32)
    w = g.blocks[0].conv.weight
    assert abs(float(w.std()) - 0.02) < 0.002 and abs(float(w.mean())) < 0.002
    assert abs(float(g.bn0.weight.mean()) - 1.0) < 0.01
    assert not g.bn0.bias.any() and not g.blocks[0].conv.bias.any()
    bound = 1 / np.sqrt(64)
    assert float(g.linear.weight.abs().max()) <= bound
    assert float(g.linear.weight.abs().max()) > 0.9 * bound
    torch.testing.assert_close(g.bn0.running_var, torch.ones(64))
    with pytest.raises(ValueError, match='7 feature entries'):
        GeneratorDCGAN((8, 8), rng)


# ---------------------------------------------------------------------------
# the WGAN trainer against JAX's make_wgan_epoch_runner
# ---------------------------------------------------------------------------

FRAME = 48


def jax_epoch_draws(key, n_images, batch, n_critic, translation):
    """JAX's permutation and each batch's draws (legacy_train.py:38-117)."""
    perm = np.asarray(jax.random.permutation(jax.random.fold_in(key, 7),
                                             n_images))
    n_steps = -(-n_images // batch)
    bkeys = jax.random.split(jax.random.fold_in(key, 11), n_steps)
    draws = []
    for i, kb in enumerate(bkeys):
        b = min(batch, n_images - i * batch)
        t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
        draws.append({
            'augment': jax_augment_draws(jax.random.fold_in(kb, 0), b, FRAME,
                                         translation),
            'z': [t(j_sample_latent(jax.random.fold_in(kb, 1 + j), (b, LATENT)))
                  for j in range(n_critic)],
            'zg': t(j_sample_latent(jax.random.fold_in(kb, 101), (b, LATENT)))})
    return perm, draws


@pytest.mark.parametrize('run', [
    dict(n_images=3, batch_size=3, n_critic=2, sim_lambda=0.5, rmsprop=False),
    dict(n_images=5, batch_size=2, n_critic=1, sim_lambda=0.0, rmsprop=True),
], ids=['one_batch_step', 'epoch_partial_batch'])
def test_wgan_runner_matches_jax(monkeypatch, run):
    lr, key = 1e-4, jax.random.PRNGKey(5)
    kw = dict(n_critic=run['n_critic'], batch_size=run['batch_size'],
              n_images=run['n_images'], latent_dim=LATENT, drift_epsilon=1e-3,
              sim_lambda=run['sim_lambda'], lr=lr, crop_size=SIZE,
              out_size=SIZE, translation=0.05)
    images = np.random.default_rng(2).random(
        (run['n_images'], FRAME, FRAME, 1)).astype(np.float32)
    jg, jd, _, _ = jax_nets('wgan')

    opt = j_make_optimizer(0.5, run['rmsprop'])
    jstate = {'g_params': jg[0], 'd_params': jd[0], 'g_bn': jg[1],
              'd_bn': jd[1], 'g_opt': opt.init(jg[0]), 'd_opt': opt.init(jd[0])}
    jrun = jlt.make_wgan_epoch_runner(jg[2], jd[2], beta1=0.5,
                                      rmsprop=run['rmsprop'], **kw)
    jstate, jstats = jrun(jstate, jnp.asarray(images), key)

    g, d = port_nets('wgan', jg, jd)
    state = tlt.init_legacy_state(g, d, 0.5, run['rmsprop'])
    perm, draws = jax_epoch_draws(key, run['n_images'], run['batch_size'],
                                  run['n_critic'], 0.05)
    feed = iter(draws)
    monkeypatch.setattr(tlt, 'draw_wgan_batch', lambda *a: next(feed))
    monkeypatch.setattr(torch, 'randperm', lambda n, **k: torch.from_numpy(perm))
    stats = tlt.make_wgan_epoch_runner(**kw)(
        state, torch.from_numpy(images), torch.Generator())
    assert next(feed, None) is None

    np.testing.assert_allclose(stats.numpy(), np.asarray(jstats),
                               rtol=1e-5, atol=1e-6)
    got = to_jax_legacy_state(state)
    n_batches = len(draws)
    for net, n_steps in (('g', n_batches), ('d', n_batches * run['n_critic'])):
        bound = 2.5 * lr * (10 if run['rmsprop'] else 1) * n_steps
        want_bn = jstate[f'{net}_bn']
        assert sorted(got[f'{net}_bn']) == sorted(want_bn)
        for name, stats in got[f'{net}_bn'].items():
            np.testing.assert_allclose(stats['var'], want_bn[name]['var'],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(stats['mean'], want_bn[name]['mean'],
                                       rtol=0, atol=bound)
        assert_params_close(got[f'{net}_params'], jstate[f'{net}_params'],
                            bound)
    # every critic parameter, BN scale and bias too, within the clamp
    assert max(float(np.abs(x).max()) for x in leaves(got['d_params'])) <= 0.01
    # the optimizer state in the JAX trainer's layout (the port's Adam
    # state is its own namedtuple of optax's fields)
    for net in ('g', 'd'):
        paths = [[jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(t)[0]]
                 for t in (got[f'{net}_opt'], jstate[f'{net}_opt'])]
        assert paths[0] == paths[1]


# ---------------------------------------------------------------------------
# checkpoints across the packages, and the train CLI
# ---------------------------------------------------------------------------

def test_legacy_checkpoints_load_across_packages(tmp_path):
    jg, jd, _, _ = jax_nets('wgan', key=7)
    opt = j_make_optimizer(0.5, False)
    # a state a few steps in: nonzero moments and count
    g, d = port_nets('wgan', jg, jd)
    state = tlt.init_legacy_state(g, d, 0.5, False)
    step = tlt.make_wgan_batch_step(
        n_critic=1, drift_epsilon=1e-3, sim_lambda=0.0, lr=1e-4,
        aug_spec=tlt.AugmentSpec(crop_size=SIZE, out_size=SIZE, translation=0.05))
    raw = torch.rand(2, FRAME, FRAME, 1, generator=torch.Generator().manual_seed(1))
    spec = tlt.AugmentSpec(crop_size=SIZE, out_size=SIZE, translation=0.05)
    for i in range(2):
        rng = torch.Generator().manual_seed(i)
        step(state, raw, tlt.draw_wgan_batch(rng, 2, FRAME, LATENT, 1, spec))
    tree = to_jax_legacy_state(state)
    meta = {'family': 'wgan', 'lr': 1e-4}

    # port -> JAX: JAX's reader rebuilds its own state's structure
    ckpt = Checkpointer(str(tmp_path / 'port.npz'), n_epochs=4, verbose=False)
    ckpt.save_state(2, tree, meta)
    jtree, jmeta = JCheckpointer(str(tmp_path / 'port.npz'), n_epochs=4,
                                 verbose=False).load_state()
    fresh = {'g_params': jg[0], 'd_params': jd[0], 'g_bn': jg[1],
             'd_bn': jd[1], 'g_opt': opt.init(jg[0]), 'd_opt': opt.init(jd[0])}
    assert jax.tree.structure(jtree) == jax.tree.structure(fresh)
    assert jmeta['family'] == 'wgan' and jmeta['epoch'] == 2
    for x, y in zip(leaves(jtree), leaves(tree)):
        assert x.dtype == y.dtype and np.array_equal(x, y)

    # JAX -> port: every leaf restored bit for bit
    JCheckpointer(str(tmp_path / 'jax.npz'), n_epochs=4,
                  verbose=False).save_state(2, jtree, meta)
    loaded, _ = Checkpointer(str(tmp_path / 'jax.npz'), n_epochs=4,
                             verbose=False).load_state()
    g2, d2 = port_nets('wgan', jax_nets('wgan', key=9)[0], jax_nets('wgan', key=9)[1])
    state2 = tlt.init_legacy_state(g2, d2, 0.5, False)
    load_jax_legacy_state(state2, loaded)
    for x, y in zip(leaves(to_jax_legacy_state(state2)), leaves(tree)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_wgan_cli_trains_resumes_and_clamps(tmp_path, tiny_dataset_dir, capsys):
    root = tmp_path / 'run'
    knobs = dict(wgan=True, pggan=False, n_critic=2, checkpointing_period=2,
                 N_epochs=6, matmul_precision='highest', mesh_shape={'data': 2})
    whole = write_config(tmp_path / 'whole.py', tiny_dataset_dir, root,
                         ID='w1', **knobs)
    state = ttrain.main(['--configs', whole, '--device', 'cpu'])
    out = capsys.readouterr().out
    assert 'mesh_shape is ignored' in out
    assert out.count('Epoch: ') == 6

    # the same run in two sessions: 1-4, then resumed to 6
    split = write_config(tmp_path / 'split.py', tiny_dataset_dir, root,
                         ID='s1', **dict(knobs, N_epochs=4))
    ttrain.main(['--configs', split, '--device', 'cpu'])
    split6 = write_config(tmp_path / 'split6.py', tiny_dataset_dir, root,
                          ID='s1', **knobs)
    ttrain.main(['--configs', split6, '--device', 'cpu', '--resume'])

    (w_tree, w_meta), (s_tree, s_meta) = (
        load_pytree_npz(str(root / 'weights' / f'GenDisc_{i}.npz'))
        for i in ('w1', 's1'))
    assert w_meta['family'] == 'wgan' and w_meta['epoch'] == 6
    assert dict(s_meta, ID='w1') == w_meta
    for x, y in zip(flat(w_tree), flat(s_tree)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    series = w_tree['series']
    assert all(np.isfinite(series[k]).all() and len(series[k]) == 6
               for k in series)
    d_params = w_tree['state']['d_params']
    assert max(float(np.abs(x).max()) for x in flat(d_params)) <= 0.01
    for x, y in zip(flat(to_jax_legacy_state(state)), flat(w_tree['state'])):
        assert np.array_equal(x, y)
    for epoch in (2, 4, 6):
        assert (root / 'images' / f'Samples_w1_{epoch}.png').exists()
