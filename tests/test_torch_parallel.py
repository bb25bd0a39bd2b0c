"""Data parallelism over processes (neuron_gan_tpu_torch/parallel/) on the
CPU: two gloo ranks, spawned by the train CLI itself
(``mesh_shape={'data': 2}``, ``--device cpu``; each rank runs the CLI's
``_train_rank`` through ``rank_result``, which saves what is compared),
against the 1-process run of the same config.

Every rank draws the global batch and takes its rows, and each gradient is
the ranks' ``b_r / B``-weighted sum, so the 2-rank run is the 1-process
run up to the order of its sums: at JAX ``tests/test_parallel.py``'s
tolerances, the stats of every epoch at rtol 1e-5 / atol 1e-6 and every
parameter and Adam moment at rtol 1e-4 / atol 1e-6; the two ranks' states
equal bit for bit.  Cases: a partial last batch split unevenly (3 rows
over 2 ranks) with the similarity loss on, and a last batch of one row
(rank 1 takes none) streamed from the host.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

from neuron_gan_tpu_torch import train as ttrain
from neuron_gan_tpu_torch.convert import to_jax_state
from neuron_gan_tpu_torch.parallel import Grid, mesh_ranks, spawn, take_rows

from test_torch_cli import write_config

# two epochs of two batches each, as JAX's test runs (a phase in its fade)
FLOAT32 = dict(compute_dtype='float32', matmul_precision='highest',
               N_epochs=5, transit_sch=[1, 4], N_epochs_session=2,
               checkpointing_period=5)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite's
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [np.asarray(tree)]


def dataset(path, n):
    path.mkdir()
    rng = np.random.default_rng(42)
    for i in range(n):
        img = rng.normal(20, 5, (16, 16)).clip(0, 255)
        img[3 + i:11 + i, 5:12] = rng.normal(180, 20, (8, 7)).clip(0, 255)
        img[0:2, 0:2] = 0
        Image.fromarray(img.astype(np.uint8), mode='L').save(path / f'im{i}.png')
    return str(path)


def test_rows_partition_every_batch():
    for world in (1, 2, 3, 4):
        for b in range(0, 11):
            rows = [Grid(r, world, 'cpu').rows(b) for r in range(world)]
            assert rows[0][0] == 0 and rows[-1][1] == b
            assert all(r0[1] == r1[0] for r0, r1 in zip(rows, rows[1:]))
            sizes = [hi - lo for lo, hi in rows]
            assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]


def test_take_rows_keeps_shared_draws_shared():
    z = torch.arange(8.0).reshape(4, 2)
    draws = {'critic': [(z, z, torch.arange(4.0))], 'augment': None,
             'zg': torch.zeros(4, 2)}
    got = take_rows(draws, 1, 3)
    z1, z2, eps = got['critic'][0]
    assert z1 is z2 and torch.equal(z1, z[1:3])
    assert torch.equal(eps, torch.tensor([1.0, 2.0])) and got['augment'] is None


def test_data_ranks():
    assert mesh_ranks(None) is None and mesh_ranks({}) is None
    assert mesh_ranks({'data': 3}) == 3
    assert mesh_ranks({'data': 2, 'model': 2}) == 4
    assert mesh_ranks({'data': 1, 'model': 2}) == 2
    # JAX's step fails on a mesh without a data axis
    with pytest.raises(ValueError, match=r"needs a 'data' axis.*"
                                         r"tests/test_parallel\.py"):
        mesh_ranks({'model': 2})
    for bad in ({'data': 0}, {'data': 0, 'model': 2}, {'data': 2, 'model': 0}):
        with pytest.raises(ValueError, match='at least one rank'):
            mesh_ranks(bad)
    with pytest.raises(ValueError, match='unknown axes'):
        mesh_ranks({'data': 2, 'pipe': 2})


def recording_chunks(stats):
    """``TrainSession._run_chunk`` patched to append each chunk's stats."""
    run_chunk = ttrain.TrainSession._run_chunk

    def recorded(self, *args):
        stats.append(run_chunk(self, *args))
        return stats[-1]
    return mock.patch.object(ttrain.TrainSession, '_run_chunk', recorded)


def rank_result(rank, world_size, init_method, argv, out_dir):
    """A rank of the train CLI's data-parallel session (``_train_rank``)
    that saves its final state (the JAX layout) and every epoch's stats.
    Spawned: it imports nothing of the JAX package."""
    stats = []
    with recording_chunks(stats):
        session = ttrain._train_rank(rank, world_size, init_method, argv)
    torch.save((to_jax_state(session.state), np.concatenate(stats)),
               os.path.join(out_dir, f'rank{rank}.pt'))


@pytest.mark.parametrize('n_images,knobs', [
    (5, dict(batch_size=3, sim_loss_lambda=0.5)),
    (4, dict(batch_size=3, hbm_budget_mb=1e-6)),
], ids=['uneven_sim', 'empty_rank_streamed'])
def test_two_gloo_ranks_match_one_process(tmp_path, capfd, monkeypatch,
                                          n_images, knobs):
    data = dataset(tmp_path / 'data', n_images)

    def spawn_recording(target, n, argv):
        # the CLI's own ranks, each saving what this test compares
        assert target is ttrain._train_rank and n == 2
        spawn(rank_result, n, argv, str(tmp_path))

    monkeypatch.setattr(ttrain, 'spawn', spawn_recording)
    one_stats = []
    for name, mesh in (('one', None), ('two', {'data': 2})):
        root = tmp_path / name
        cfg = write_config(tmp_path / f'{name}.py', data, root, ID=name,
                           mesh_shape=mesh, **FLOAT32, **knobs)
        with recording_chunks(one_stats if mesh is None else []):
            session = ttrain.main(['--configs', cfg, '--device', 'cpu'])
        if mesh is None:
            one = session
        assert (root / 'weights' / f'GenDisc_{name}.npz').exists()
    out = capfd.readouterr().out
    # the 1-process run and rank 0 say so; rank 1 prints nothing
    assert out.count('streaming from host per epoch') == (
        2 if 'hbm_budget_mb' in knobs else 0)

    (state0, stats0), (state1, stats1) = (
        torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
        for r in range(2))
    for x, y in zip(leaves(state0), leaves(state1)):
        assert np.array_equal(x, y)
    assert np.array_equal(stats0, stats1)
    np.testing.assert_allclose(stats0, np.concatenate(one_stats), rtol=1e-5,
                               atol=1e-6)
    want = leaves(to_jax_state(one.state))
    assert len(want) == len(leaves(state0))
    for x, y in zip(leaves(state0), want):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-6)


def test_launcher_world_size_must_match(tmp_path, monkeypatch):
    data = dataset(tmp_path / 'data', 2)
    cfg = write_config(tmp_path / 'c.py', data, tmp_path / 'run',
                       mesh_shape={'data': 2})
    monkeypatch.setenv('WORLD_SIZE', '3')
    monkeypatch.setenv('RANK', '0')
    with pytest.raises(ValueError, match='asks for 2 ranks; the launcher '
                                         'started 3'):
        ttrain.main(['--configs', cfg, '--device', 'cpu'])


def test_more_ranks_than_gpus_is_an_error(tmp_path, monkeypatch):
    data = dataset(tmp_path / 'data', 2)
    cfg = write_config(tmp_path / 'c.py', data, tmp_path / 'run',
                       mesh_shape={'data': 2})
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match=r"needs 2 GPUs, have 1"):
        ttrain.main(['--configs', cfg])
    assert not os.path.exists(tmp_path / 'run' / 'weights' / 'GenDisc_cli1.npz')
