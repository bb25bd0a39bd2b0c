"""The 'model' mesh axis of the port (neuron_gan_tpu_torch/parallel/mesh.py)
on the CPU, over gloo.

- The sharding rule and the shards against JAX's own: for the flagship G
  and D, the leaves the port shards are those ``param_partition_spec``
  shards, and each grid rank's slices, in the JAX layout, equal the shard
  that ``shard_params`` places on the device at the same mesh position, bit
  for bit.
- One batch step under ``{'data': 1, 'model': 2}`` (``torch_grid_ranks``):
  the reduced gradient of each slice, before Adam, against the same slice
  of the 1-process gradient (rtol 1e-5, atol 1e-6); with the ``/ M``
  dropped the check fails (Adam would hide that factor after the step).
- The train CLI under ``{'data': 2, 'model': 2}`` against the 1-process
  session, at JAX ``tests/test_parallel.py``'s tolerances: stats rtol 1e-5
  / atol 1e-6, the gathered state rtol 1e-4 / atol 1e-6; every rank's
  replicated leaves equal, the slices of one model rank equal across the
  data rows and, put together, rank 0's checkpoint, which the JAX package's
  loader reads and one process resumes; and a 1-process checkpoint resumed
  under the grid.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax

from neuron_gan_tpu.checkpoint import load_pytree_npz as jax_load_npz
from neuron_gan_tpu.parallel import make_mesh, param_partition_spec, shard_params

from neuron_gan_tpu_torch import train as ttrain
from neuron_gan_tpu_torch.checkpoint import load_pytree_npz
from neuron_gan_tpu_torch.convert import to_jax_state, to_jax_tree
from neuron_gan_tpu_torch.flagship import flagship_config
from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
from neuron_gan_tpu_torch.parallel import Grid, NetShards, is_sharded, spawn

import torch_grid_ranks as ranks
from test_torch_cli import write_config
from test_torch_parallel import FLOAT32, dataset, leaves, recording_chunks


def paths(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize('mesh_shape', [{'data': 4, 'model': 2},
                                        {'data': 2, 'model': 4}],
                         ids=['model2', 'model4'])
def test_rule_and_shards_match_jax(mesh_shape):
    mesh = make_mesh(mesh_shape)
    n_data, n_model = mesh_shape['data'], mesh_shape['model']
    init = torch.Generator().manual_seed(0)
    cfg = flagship_config()
    for module in (GeneratorPG(cfg, init, device='cpu'),
                   DiscriminatorPG(cfg, init, device='cpu')):
        tree = to_jax_tree(module)
        flags = to_jax_tree((name, torch.tensor(float(
            is_sharded(p.shape, n_model)))) for name, p in module.named_parameters())
        picked = [float('model' in param_partition_spec(np.shape(leaf), mesh))
                  for _, leaf in paths(tree)]
        assert picked == [float(f) for _, f in paths(flags)]
        assert 0 < sum(picked) < len(picked)

        placed = paths(shard_params(tree, mesh))
        for d in range(n_data):
            for m in range(n_model):
                grid = Grid(d * n_model + m, n_data * n_model, 'cpu', n_model)
                assert (grid.data_rank, grid.model_rank) == (d, m)
                device = mesh.devices[d, m]
                local = paths(to_jax_tree(NetShards(module, grid).named_local()))
                assert len(local) == len(placed)
                for (path, got), (_, leaf) in zip(local, placed):
                    want, = [s.data for s in leaf.addressable_shards
                             if s.device == device]
                    assert np.array_equal(got, np.asarray(want)), (
                        jax.tree_util.keystr(path), d, m)


def _close(got, want):
    return all(np.allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
               for a, b in zip(got, want))


def test_reduced_shard_gradients_match_one_process(tmp_path):
    spawn(ranks.step_rank, 2, 2, str(tmp_path))
    one, stats = ranks.one_process_step()
    want = {'g_grad': [p.grad for p in one.g.parameters()],
            'd_grad': [p.grad for p in one.d.parameters()],
            'g': list(one.g.parameters()), 'd': list(one.d.parameters()),
            'ema': list(one.g_ema.parameters())}
    for r in range(2):
        got = torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
        grid = Grid(r, 2, 'cpu', 2)
        assert got['coords'] == (0, r)

        def mine(ts):
            return [grid.shard_of(t.detach()) if is_sharded(t.shape, 2)
                    else t.detach() for t in ts]

        for key in ('g_grad', 'd_grad'):
            assert _close(got['sound'][key], mine(want[key])), (r, key)
            # twice the gradient: the model ranks' sum counted M times
            assert not _close(got['fault_without_1/M'][key],
                              mine(want[key])), (r, key)
        for key in ('g', 'd', 'ema'):
            for a, b in zip(got['sound'][key], mine(want[key])):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got['sound']['stats'], stats, rtol=1e-5,
                                   atol=1e-6)


def _spawn_into(monkeypatch, out_dir, n):
    def spawn_recording(target, world, argv):
        # the CLI's own ranks, each saving what the test compares
        assert target is ttrain._train_rank and world == n
        spawn(ranks.cli_rank, world, argv, str(out_dir))
    monkeypatch.setattr(ttrain, 'spawn', spawn_recording)


def _session(cfg, stats=None):
    with recording_chunks([] if stats is None else stats):
        return ttrain.main(['--configs', cfg, '--device', 'cpu'])


GRID = {'data': 2, 'model': 2}


@pytest.mark.parametrize('n_images,knobs,resumed', [
    (5, dict(batch_size=3, sim_loss_lambda=0.5, ema_beta=0.9), False),
    (4, dict(batch_size=3, hbm_budget_mb=1e-6), True),
], ids=['uneven_sim_ema', 'resumed_streamed_empty_rank'])
def test_grid_of_four_gloo_ranks_matches_one_process(
        tmp_path, capfd, monkeypatch, n_images, knobs, resumed):
    data = dataset(tmp_path / 'data', n_images)

    def config(name, **extra):
        return write_config(tmp_path / f'{name}.py', data, tmp_path / name,
                            ID=name, **dict(FLOAT32, **knobs, **extra))

    if resumed:
        # epochs 1-2 in one process, then 3-4 resumed in one process and
        # under the grid from its checkpoint
        _session(config('one'))
        os.makedirs(tmp_path / 'grid' / 'weights')
        shutil.copy(tmp_path / 'one' / 'weights' / 'GenDisc_one.npz',
                    tmp_path / 'grid' / 'weights' / 'GenDisc_grid.npz')
    one_stats = []
    one = _session(config('one', resume=resumed), one_stats)
    _spawn_into(monkeypatch, tmp_path, 4)
    assert _session(config('grid', resume=resumed, mesh_shape=GRID)) is None
    out = capfd.readouterr().out
    assert 'mesh: data 2 x model 2, gloo on cpu' in out

    saved = [torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
             for r in range(4)]
    assert [s[2] for s in saved] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    stats = saved[0][1]
    assert all(np.array_equal(s[1], stats) for s in saved)
    np.testing.assert_allclose(stats, np.concatenate(one_stats), rtol=1e-5,
                               atol=1e-6)

    # the checkpoint: what rank 0 gathered, against the 1-process state
    path = tmp_path / 'grid' / 'weights' / 'GenDisc_grid.npz'
    payload, meta = load_pytree_npz(str(path))
    state = payload['state']
    assert meta['epoch'] == (4 if resumed else 2)
    want = to_jax_state(one.state)
    assert len(leaves(state)) == len(leaves(want))
    for x, y in zip(leaves(state), leaves(want)):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-6)
    jtree, jmeta = jax_load_npz(str(path))
    assert jmeta == meta
    for x, y in zip(jax.tree.leaves(jtree['state']), leaves(state)):
        assert np.array_equal(x, y)

    # each rank's tensors: replicated leaves equal on every rank, slices
    # equal across the data rows, the model ranks' slices making up the
    # checkpoint's leaf
    whole = {'g_params': state['g_params'], 'd_params': state['d_params']}
    for net in ('g', 'd'):
        for key, i in (('exp_avg', 1), ('exp_avg_sq', 2)):
            whole[f'{net}_{key}'] = state[f'{net}_opt'][i]
    if 'ema_beta' in knobs:
        whole['g_ema'] = state['g_ema']
    n_sharded = 0
    for key, tree in whole.items():
        local = [paths(s[0][key]) for s in saved]
        for i, (path, leaf) in enumerate(paths(tree)):
            got = [loc[i][1] for loc in local]
            assert local[0][i][0] == path
            if got[0].shape == leaf.shape:
                assert all(np.array_equal(g, leaf) for g in got), path
                continue
            n_sharded += 1
            assert np.array_equal(got[0], got[2]) and np.array_equal(
                got[1], got[3]), path
            assert np.array_equal(np.concatenate(got[:2], axis=-1), leaf), path
    assert n_sharded

    if not resumed:
        # one process resumes the grid's checkpoint as it resumes its own
        resumed_stats = {}
        for name in ('one', 'grid'):
            resumed_stats[name] = []
            session = _session(config(name, resume=True, N_epochs_session=1),
                               resumed_stats[name])
            assert session.epoch_init == 3
        np.testing.assert_allclose(resumed_stats['grid'][0],
                                   resumed_stats['one'][0], rtol=1e-4,
                                   atol=1e-6)
