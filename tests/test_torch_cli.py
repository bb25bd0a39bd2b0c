"""The port's CLIs (``python -m neuron_gan_tpu_torch.train`` / ``.eval``)
end to end on the CPU (``--device cpu``), at a tiny size: the tiny
dataset, 3 levels (4^2 .. 16^2), batch 2.

Held exactly: checkpoint meta and series, the resumed run against the
uninterrupted one (every leaf of the final state, every loss, bit for bit),
the SWD monitor's series across a resume.  The CLIs' other outputs (grids,
JSON line) by presence, shape and finiteness.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from neuron_gan_tpu_torch import eval as teval
from neuron_gan_tpu_torch import train as ttrain
from neuron_gan_tpu_torch.checkpoint import load_pytree_npz

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def write_config(path, dataset_dir, root, **extra):
    knobs = dict(
        ID='cli1', data_dir=f'{root}/data', images_dir=f'{root}/images',
        weights_dir=f'{root}/weights', plots_dir=f'{root}/plots',
        logs_dir=f'{root}/logs', dataset_dir=dataset_dir,
        samples_sub_dir=f'{root}/images/cli1', pggan=True, grad_pen_lambda=10,
        transit_sch=[3, 6], alpha_step=0.5, learning_rate=1e-3, batch_size=2,
        N_epochs=8, beta1=0.5, drift_epsilon=0.001, n_critic=1, seed=1,
        checkpointing_period=4, translation=0.05, latent_dim=8, image_size=16,
        N_colors=1, N_gen_features=[16, 8, 8], N_dis_features=[8, 8, 16],
        resume=False, swd_period=0)
    knobs.update(extra)
    if 'ID' in extra:
        knobs['samples_sub_dir'] = f"{root}/images/{extra['ID']}"
    path.write_text(''.join(f'{k} = {v!r}\n' for k, v in knobs.items()))
    return str(path)


def train(cfg, *flags):
    return ttrain.main(['--configs', cfg, '--device', 'cpu', *flags])


def flat(tree):
    """Every leaf of a loaded tree in order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat(v)]
    return [np.asarray(tree)]


def test_resume_on_chunk_boundary_equals_uninterrupted_run_then_eval(
        tmp_path, tiny_dataset_dir, capsys):
    root = tmp_path / 'run'
    whole = write_config(tmp_path / 'whole.py', tiny_dataset_dir, root, ID='w1')
    split = write_config(tmp_path / 'split.py', tiny_dataset_dir, root, ID='s1',
                         N_epochs_session=5)
    train(whole)
    train(split)
    _, meta = load_pytree_npz(str(root / 'weights' / 'GenDisc_s1.npz'))
    # epoch 5 ends a chunk of the uninterrupted plan (the transition at 6)
    assert (meta['epoch'], meta['image_size'], meta['alpha']) == (5, 8, 1.0)
    train(split, '--resume')
    got, got_meta = load_pytree_npz(str(root / 'weights' / 'GenDisc_s1.npz'))
    want, want_meta = load_pytree_npz(str(root / 'weights' / 'GenDisc_w1.npz'))
    assert got_meta == dict(want_meta, ID='s1')
    assert (got_meta['epoch'], got_meta['image_size'], got_meta['alpha'],
            got_meta['phase']) == (8, 16, 1.0, 2)
    assert len(flat(got)) == len(flat(want))
    for a, b in zip(flat(got), flat(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(got['series']['Loss_real']) == 8
    assert np.isfinite(got['series']['Loss_D']).all()
    assert (root / 'images' / 's1' / 'Samples_s1_8.png').exists()
    assert (root / 'plots' / 'Training_summary_s1.png').exists()

    weights = str(root / 'weights' / 'GenDisc_s1.npz')
    grid = teval.main(['-n', '4', '-weights', weights, '-output',
                       str(root / 'grid.png'), '--device', 'cpu', '-swd',
                       '-dataset_dir', tiny_dataset_dir])
    # four samples at image_size_max, grid 2 x 2 with 2-pixel padding
    assert grid.shape == (4, 16, 16, 1) and np.isfinite(grid).all()
    from neuron_gan_tpu_torch.data.neuron_dataset import decode_image
    assert decode_image(str(root / 'grid.png')).shape == (38, 38)
    line = [ln for ln in capsys.readouterr().out.splitlines() if '"swd_mean"' in ln]
    rec = json.loads(line[-1])
    assert rec['resolution'] == 16 and np.isfinite(rec['swd_mean'])
    fast = teval.main(['-n', '4', '-weights', weights, '-output',
                       str(root / 'grid_fast.png'), '--device', 'cpu', '-fast'])
    np.testing.assert_allclose(fast, grid, rtol=0, atol=1e-4)


def test_session_clamp_trailing_save_and_float_transits(tmp_path, tiny_dataset_dir):
    # N_epochs_session past the end clamps to N_epochs; the last chunk,
    # off the checkpoint period, still saves; --transit_sch parses floats
    root = tmp_path / 'run'
    cfg = write_config(tmp_path / 'c.py', tiny_dataset_dir, root, N_epochs=9,
                       N_epochs_session=50)
    session = train(cfg, '--transit_sch', '3.0', '6.0')
    assert (session.epoch_init, session.epoch_final) == (1, 10)
    _, meta = load_pytree_npz(str(root / 'weights' / 'GenDisc_cli1.npz'))
    assert (meta['epoch'], meta['image_size']) == (9, 16)


def test_adapt_critic(tmp_path, tiny_dataset_dir):
    from neuron_gan_tpu.utils.monitor import calculate_d_steps as jsteps
    from neuron_gan_tpu_torch.utils.monitor import calculate_d_steps
    root = tmp_path / 'run'
    cfg = write_config(tmp_path / 'c.py', tiny_dataset_dir, root, n_critic=2,
                       N_epochs_session=4, transit_sch=[30, 60], N_epochs=100)
    session = train(cfg, '--adapt_critic')
    # chunks align to the 100-epoch adaptation window and the checkpoints
    assert session.next_chunk_end(1) == 4 and session.config.adapt_critic
    _, meta = load_pytree_npz(str(root / 'weights' / 'GenDisc_cli1.npz'))
    assert meta['epoch'] == 4
    rng = np.random.default_rng(0)
    for _ in range(5):
        real, fake = rng.standard_normal((2, 150))
        assert calculate_d_steps(real, fake, 0, 5, 100) == jsteps(real, fake, 0, 5, 100)


def test_swd_monitor_drops_scores_past_the_checkpoint_on_resume(
        tmp_path, tiny_dataset_dir):
    root = tmp_path / 'run'
    cfg = write_config(tmp_path / 'c.py', tiny_dataset_dir, root, swd_period=2,
                       N_epochs_session=4)
    train(cfg)
    log = root / 'logs' / 'SWD_cli1.jsonl'
    records = [json.loads(ln) for ln in log.read_text().splitlines()]
    # scored where a chunk crossed a multiple of 2 (chunks end before the
    # transitions at 3 and 6 and at the fades' ends)
    assert [r['epoch'] for r in records] == [2, 4]
    # a session that trained past its last checkpoint before it stopped
    with open(log, 'a') as fh:
        fh.write(json.dumps(dict(records[-1], epoch=6)) + '\n')
    train(cfg, '--resume')
    epochs = [json.loads(ln)['epoch'] for ln in log.read_text().splitlines()]
    assert epochs == [2, 4, 7, 8]
    assert all(np.isfinite(json.loads(ln)['swd_mean'])
               for ln in log.read_text().splitlines())


def test_weights_init_from_reference_pth_and_npz(tmp_path, tiny_dataset_dir):
    import torch
    from neuron_gan_tpu_torch.checkpoint import save_reference_checkpoint
    from neuron_gan_tpu_torch.convert import to_jax_tree
    from neuron_gan_tpu_torch.models import (
        DiscriminatorPG, GeneratorPG, GrowthState, PGConfig)
    root = tmp_path / 'run'
    os.makedirs(root / 'weights')
    cfg = PGConfig(n_gen_features=(16, 8, 8), n_dis_features=(8, 8, 16),
                   latent_dim=8, image_size_init=4)
    rng = torch.Generator().manual_seed(7)
    g, d = to_jax_tree(GeneratorPG(cfg, rng, 'cpu')), to_jax_tree(DiscriminatorPG(cfg, rng, 'cpu'))
    growth = GrowthState(cfg)
    growth.set_resolution(8, 0.5)
    save_reference_checkpoint(str(root / 'weights' / 'init.pth'), g, d, cfg, growth)
    for name in ('init.pth', 'GenDisc_w1.npz'):
        config = ttrain.load_config([
            '--configs', write_config(tmp_path / 'c.py', tiny_dataset_dir, root,
                                      weights_init=name), '--device', 'cpu'])
        session = ttrain.TrainSession(config)
        assert np.array_equal(to_jax_tree(session.state.g)['blocks'][0]['conv1']['w'],
                              g['blocks'][0]['conv1']['w'])
        assert np.array_equal(to_jax_tree(session.state.d)['head']['conv']['b'],
                              d['head']['conv']['b'])
        assert session.dataset.image_size == 8
        session.save_checkpoint(2, growth)
        os.replace(session.weights_path, root / 'weights' / 'GenDisc_w1.npz')


@pytest.mark.parametrize('knobs,error,named', [
    (dict(mesh_shape={'model': 2}), ValueError, "needs a 'data' axis"),
    (dict(pggan=False), Exception, 'dcgan training is not implemented'),
    (dict(mesh_shape={'data': 0, 'model': 2}), ValueError, 'at least one rank'),
    (dict(matmul_precision='high'), ValueError, 'matmul_precision'),
])
def test_refused_configurations(tmp_path, tiny_dataset_dir, knobs, error, named):
    cfg = write_config(tmp_path / 'c.py', tiny_dataset_dir, tmp_path / 'run',
                       **knobs)
    with pytest.raises(error, match=named):
        train(cfg)


def test_missing_weights_and_the_card_by_default(tmp_path, tiny_dataset_dir):
    with pytest.raises(FileNotFoundError, match='absent.npz does not exist'):
        teval.main(['-weights', str(tmp_path / 'absent.npz'), '--device', 'cpu'])
    # python -m, without --device: the card, which this host lacks
    cfg = write_config(tmp_path / 'c.py', tiny_dataset_dir, tmp_path / 'run')
    run = subprocess.run(
        [sys.executable, '-m', 'neuron_gan_tpu_torch.train', '--configs', cfg],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert run.returncode != 0
    assert 'CUDA is not available' in run.stderr
