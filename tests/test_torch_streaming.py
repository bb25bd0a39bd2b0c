"""The port's host-streamed runner (neuron_gan_tpu_torch/streaming.py) on
the CPU.

Its planning functions equal the JAX package's over a grid of inputs.  A
streamed run is the same run as the resident runner (the same permutation
call on the same generator, the same draws in the same order, the same sums
in the same order), so on the CPU every stat, parameter and optimizer
moment after a chunk equals the resident run's bit for bit: shuffled and
in order, groups of one batch, two batches and all of them, a partial last
batch, and a memmap source.
"""

import dataclasses

import numpy as np
import pytest
import torch

from neuron_gan_tpu import streaming as jstreaming
from neuron_gan_tpu import train_step as jts

from neuron_gan_tpu_torch import streaming, train_step as tts
from neuron_gan_tpu_torch.convert import to_jax_state
from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG, PGConfig

CFG = PGConfig(n_gen_features=(8, 8, 8), n_dis_features=(8, 8, 8),
               latent_dim=8, image_size_init=4)
SPEC = dict(phase=2, fading=True, n_critic=1, batch_size=2, n_images=9,
            shuffle=True, crop_size=16, translation=0.05, augment=True,
            gp_lambda=10.0, drift_epsilon=1e-3, sim_lambda0=0.0,
            sim_decay=0.0, beta1=0.5, rmsprop=False, lr0=1e-3,
            lr_gamma=0.99, lr_boundary=0, lr_cap=5, alpha_start=0,
            alpha_step=0.25, latent_dim=8)
FRAME = 24


def fresh_state():
    init = torch.Generator().manual_seed(0)
    return tts.init_train_state(GeneratorPG(CFG, init, device='cpu'),
                                DiscriminatorPG(CFG, init, device='cpu'))


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [np.asarray(tree)]


def assert_same_run(a, b):
    (state_a, stats_a), (state_b, stats_b) = a, b
    assert torch.equal(stats_a, stats_b)
    for x, y in zip(leaves(to_jax_state(state_a)), leaves(to_jax_state(state_b))):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def resident(spec, host, n_epochs, seed=42):
    state = fresh_state()
    run = tts.make_epoch_runner(CFG, spec, n_epochs)
    return state, run(state, torch.from_numpy(np.array(host)),
                      torch.Generator().manual_seed(seed), 1)


def streamed(spec, host, n_epochs, max_group, seed=42):
    state = fresh_state()
    return state, streaming.run_epochs_streaming(
        CFG, spec, state, host, torch.Generator().manual_seed(seed), 1,
        n_epochs, max_group)


def host_stack(n):
    return np.random.default_rng(0).random((n, FRAME, FRAME, 1)).astype(np.float32)


def test_plan_groups_and_budget_equal_jax():
    for n_full in range(0, 12):
        for max_group in range(1, 6):
            assert streaming.plan_groups(n_full, max_group) == \
                jstreaming.plan_groups(n_full, max_group)
    for n_images in (1, 7, 32, 33):
        for batch in (1, 4, 8):
            spec = dict(SPEC, n_images=n_images, batch_size=batch)
            tspec, jspec = tts.ChunkSpec(**spec), jts.ChunkSpec(**spec)
            for frame in (12, 24, 768):
                for budget in (1, 4 * 2304, 2 ** 20, 16 * 2 ** 20, 1e12):
                    assert streaming.group_batches_for_budget(
                        tspec, frame, budget) == \
                        jstreaming.group_batches_for_budget(jspec, frame, budget)


@pytest.mark.parametrize('max_group', [1, 2, 4])
@pytest.mark.parametrize('shuffle', [True, False])
def test_streamed_run_equals_resident_bit_for_bit(max_group, shuffle):
    # 4 full batches of 2 and a partial batch of 1
    spec = tts.ChunkSpec(**dict(SPEC, shuffle=shuffle))
    host = host_stack(spec.n_images)
    assert_same_run(streamed(spec, host, 2, max_group),
                    resident(spec, host, 2))


def test_streamed_from_memmap_equals_resident(tmp_path):
    spec = tts.ChunkSpec(**dict(SPEC, n_images=6))
    np.save(tmp_path / 'stack.npy', host_stack(6))
    mm = np.load(tmp_path / 'stack.npy', mmap_mode='r')
    assert_same_run(streamed(spec, mm, 2, 2), resident(spec, mm, 2))


def test_streaming_checks_the_stack():
    spec = tts.ChunkSpec(**SPEC)
    with pytest.raises(ValueError, match='host stack of 8 images'):
        streamed(spec, host_stack(8), 1, 1)
    # a stack whose batches are all full, one group each
    spec = dataclasses.replace(spec, n_images=8)
    assert_same_run(streamed(spec, host_stack(8), 1, 1),
                    resident(spec, host_stack(8), 1))


def test_train_cli_streams_an_oversize_stack(tmp_path, tiny_dataset_dir, capsys):
    """The train CLI above ``hbm_budget_mb`` (the stack also above the
    loader's preload limit: a memmap source) trains the run it trains with
    the stack on the device, bit for bit."""
    from neuron_gan_tpu_torch import train as ttrain
    from neuron_gan_tpu_torch.checkpoint import load_pytree_npz

    from test_torch_cli import flat, write_config
    trees = {}
    for name, knobs in (('res', {}), ('str', dict(hbm_budget_mb=1e-6,
                                                  dataset_preload_limit_mb=1e-6))):
        cfg = write_config(tmp_path / f'{name}.py', tiny_dataset_dir,
                           tmp_path / 'run', ID=name, **knobs)
        ttrain.main(['--configs', cfg, '--device', 'cpu'])
        out = capsys.readouterr().out
        assert ('streaming from host per epoch' in out) == (name == 'str')
        trees[name] = load_pytree_npz(
            str(tmp_path / 'run' / 'weights' / f'GenDisc_{name}.npz'))
    (res, res_meta), (got, got_meta) = trees['res'], trees['str']
    assert dict(got_meta, ID='res') == res_meta
    for x, y in zip(flat(got), flat(res)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
