"""The port's ``gp_remat`` (the critic's forward in the gradient penalty
under ``torch.utils.checkpoint``) against its own path without it and
against the JAX package's ``gp_remat=True`` epoch runner, on the CPU.

Tolerances: against the path without remat, bit for bit (the same
operations in the same order); against JAX as tests/test_torch_train_step.py
holds a batch step (parameters after Adam within 2.5 lr, 99% within 1e-6;
stats rtol 1e-4, atol 1e-5, G_loss atol 5e-3).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuron_gan_tpu import train_step as jts

from neuron_gan_tpu_torch import train_step as tts
from neuron_gan_tpu_torch.convert import to_jax_tree

from test_torch_train_step import (  # noqa: F401  (fixtures)
    FRAME, JCFG, LR, PACKED_FRAME, PACKED_SPEC, SPEC, TCFG, TCFG_P,
    assert_params_close, count_launches, jax_batch_draws, packed_params,
    params, port_state)

MIXED_P = dataclasses.replace(TCFG_P, compute_dtype='mixed', precision=None)


@pytest.mark.parametrize('cfg', [TCFG_P, MIXED_P], ids=['float32', 'mixed'])
@pytest.mark.parametrize('phase,fading', [(1, False), (2, True)])
def test_gp_remat_equals_no_remat_and_counts(packed_params, monkeypatch, cfg,
                                             phase, fading):
    # one batch step with and without remat, same parameters and draws:
    # gradients, stats and updated parameters bit for bit; the kernel
    # launches chip_smoke.expected_launches counts (remat runs D's GP
    # forward three times)
    raw = torch.from_numpy(np.random.default_rng(5).random(
        (2, PACKED_FRAME, PACKED_FRAME, 1)).astype(np.float32))
    runs = []
    for remat in (False, True):
        spec = dict(PACKED_SPEC, phase=phase, fading=fading, gp_remat=remat)
        tspec = tts.ChunkSpec(**spec)
        draws = tts.draw_batch(torch.Generator().manual_seed(1), cfg, tspec,
                               2, PACKED_FRAME)
        state = port_state(packed_params, spec, cfg)
        stats = tts.make_batch_step(cfg, tspec)(state, raw, draws, 0.5, LR, 0.0)
        runs.append([stats] + [p.grad for p in state.d.parameters()]
                    + [p.grad for p in state.g.parameters()]
                    + [p.detach() for p in state.d.parameters()]
                    + [p.detach() for p in state.g.parameters()])
        calls, smoke = count_launches(monkeypatch, cfg, spec, packed_params)
        assert calls == smoke.expected_launches(cfg, [phase], gp_remat=remat)
        monkeypatch.undo()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_gp_remat_matches_jax_epoch_runner(params):
    # JAX's jitted epoch runner with gp_remat=True (one epoch of one
    # batch) against the port's remat step on the draws that runner takes
    # from its keys (epoch -> fold_in 11 -> the batch's key)
    spec = dict(SPEC, gp_remat=True)
    jspec, tspec = jts.ChunkSpec(**spec), tts.ChunkSpec(**spec)
    raw = np.random.default_rng(7).random((2, FRAME, FRAME, 1)).astype(np.float32)
    key, epoch = jax.random.PRNGKey(11), 3
    state = jts.init_train_state(params[0], params[1], jts.make_optimizer(0.5))
    run = jts.make_epoch_runner(JCFG, jspec, 1, donate=False)
    jstate, jstats = run(state, jnp.asarray(raw), key, epoch)
    k_batch = jax.random.split(jax.random.fold_in(
        jax.random.fold_in(key, epoch), 11), 1)[0]

    tstate = port_state(params, spec)
    alpha, lr, lam = tts.epoch_scalars(tspec, epoch)
    stats = tts.make_batch_step(TCFG, tspec)(
        tstate, torch.from_numpy(raw), jax_batch_draws(k_batch, spec, 2),
        alpha, lr, lam).numpy() / spec['n_images']
    jstats = np.asarray(jstats)[0]
    assert_params_close(to_jax_tree(tstate.d), jax.tree.map(
        np.asarray, jstate['d_params']), lr)
    assert_params_close(to_jax_tree(tstate.g), jax.tree.map(
        np.asarray, jstate['g_params']), lr)
    np.testing.assert_allclose(stats[[0, 1, 2, 4, 5]], jstats[[0, 1, 2, 4, 5]],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(stats[3], jstats[3], rtol=0, atol=5e-3)
