"""Rank bodies that ``tests/test_torch_model_axis.py`` spawns under a
(data, model) grid of gloo ranks on the CPU.  Spawned ranks import this
module by its path, so it imports nothing of the JAX package."""

import contextlib
import os
from unittest import mock

import numpy as np
import torch

from neuron_gan_tpu_torch import train as ttrain
from neuron_gan_tpu_torch.convert import to_jax_tree
from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG, PGConfig
from neuron_gan_tpu_torch.parallel import Grid, NetShards, shard_state, take_rows
from neuron_gan_tpu_torch.train_step import (
    ChunkSpec, draw_batch, init_train_state, make_batch_step)

from test_torch_parallel import recording_chunks

CFG = PGConfig(n_gen_features=(16, 8, 8), n_dis_features=(8, 8, 16),
               latent_dim=8, image_size_init=4, use_kernels=True)
SPEC = ChunkSpec(phase=2, fading=True, n_critic=1, batch_size=4, n_images=4,
                 shuffle=False, crop_size=16, translation=0.05, augment=True,
                 gp_lambda=10.0, drift_epsilon=0.001, sim_lambda0=0.5,
                 sim_decay=0.0, beta1=0.5, rmsprop=False, lr0=1e-3,
                 lr_gamma=0.99, lr_boundary=0, lr_cap=50, alpha_start=0,
                 alpha_step=0.25, latent_dim=8, ema_beta=0.9)
FRAME = 24
STEP_ARGS = dict(alpha=0.5, lr=1e-3, sim_lam=0.5)


def fresh_state():
    init = torch.Generator().manual_seed(0)
    return init_train_state(GeneratorPG(CFG, init, device='cpu'),
                            DiscriminatorPG(CFG, init, device='cpu'),
                            SPEC.beta1, ema_beta=SPEC.ema_beta)


def step_inputs():
    """The global batch of ``SPEC`` and its draws, from fixed seeds."""
    raw = torch.from_numpy(np.random.default_rng(3).random(
        (SPEC.batch_size, FRAME, FRAME, 1)).astype(np.float32))
    draws = draw_batch(torch.Generator().manual_seed(1), CFG, SPEC,
                       SPEC.batch_size, FRAME)
    return raw, draws


def one_step(state, grid=None):
    """One batch step of ``SPEC`` on this rank's rows; returns the stats."""
    raw, draws = step_inputs()
    lo, hi = (0, SPEC.batch_size) if grid is None else grid.rows(SPEC.batch_size)
    return make_batch_step(CFG, SPEC, grid)(
        state, raw[lo:hi], take_rows(draws, lo, hi), *STEP_ARGS.values(),
        SPEC.batch_size)


def step_rank(rank, world_size, init_method, model_size, out_dir):
    """One step under the grid, sound and with the gradient's ``/ M``
    dropped; saves each arm's reduced local gradients (before Adam) and
    its local tensors after the step."""
    torch.set_num_threads(1)
    grid = Grid.init(rank, world_size, init_method, 'cpu', model_size)
    reduce = NetShards.reduce_grads
    arms = {'sound': contextlib.nullcontext(),
            'fault_without_1/M': mock.patch.object(
                NetShards, 'reduce_grads',
                lambda self, w: reduce(self, w * self.grid.model_size))}
    out = {'coords': (grid.data_rank, grid.model_rank)}
    try:
        for arm, patch in arms.items():
            state = shard_state(fresh_state(), grid)
            with patch:
                stats = one_step(state, grid)
            sh = state.shards
            out[arm] = {'stats': grid.all_reduce_(stats),
                        'ema': [e.clone() for e in sh.g_ema]}
            for net in ('g', 'd'):
                local = getattr(sh, net).local
                out[arm][f'{net}_grad'] = [t.grad.clone() for t in local]
                out[arm][net] = [t.detach().clone() for t in local]
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))


def local_tree(state):
    """This rank's tensors in the JAX layout: its slices of the nets, both
    Adam moments and the EMA generator, and the replicated leaves."""
    sh = state.shards
    tree = {}
    if sh.g_ema is not None:
        tree['g_ema'] = to_jax_tree(zip(sh.g.names, sh.g_ema))
    for net, opt in (('g', state.g_opt), ('d', state.d_opt)):
        shards = getattr(sh, net)
        tree[f'{net}_params'] = to_jax_tree(shards.named_local())
        for key in ('exp_avg', 'exp_avg_sq'):
            tree[f'{net}_{key}'] = to_jax_tree(zip(
                shards.names, [opt.state[t][key] for t in shards.local]))
    return tree


def cli_rank(rank, world_size, init_method, argv, out_dir):
    """A rank of the train CLI's session (``_train_rank``, as the CLI
    spawns it); saves its local tensors, every epoch's stats and its place
    in the grid."""
    stats = []
    with recording_chunks(stats):
        session = ttrain._train_rank(rank, world_size, init_method, argv)
    grid = session.grid
    torch.save((local_tree(session.state), np.concatenate(stats),
                (grid.data_rank, grid.model_rank)),
               os.path.join(out_dir, f'rank{rank}.pt'))
