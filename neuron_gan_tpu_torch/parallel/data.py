"""Data parallelism over processes: the JAX package's 'data' mesh axis.

Counterpart of the 'data' axis of neuron_gan_tpu/parallel/mesh.py.  JAX is
single-controller: XLA shards the batch over the mesh and all-reduces the
gradients.  PyTorch runs one process per rank, so here every rank holds the
whole model and trains on a contiguous slice of each batch's rows:

- every rank draws the global batch's permutation and draws from the same
  seeded generator, then takes its rows of the batch and of every
  per-sample draw (``rows``, ``take_rows``), so an N-rank run is the
  1-process run up to the order of its sums;
- after each gradient and before each optimizer step the gradients of one
  network are flattened into one buffer, scaled by ``b_r / B`` (this
  rank's rows over the global batch) and summed over the ranks
  (``reduce_grads``): each loss term is a mean over samples, so the sum is
  the global batch's mean gradient, as in JAX's SPMD step.

The nets are not wrapped in ``DistributedDataParallel``: the gradient
penalty is a gradient of a gradient taken with ``torch.autograd.grad``,
and DDP's reducer hooks only ``.backward()``.

A rank whose slice of a partial batch is empty still joins every
collective, with zero gradients.  Ranks bind ``cuda:<local rank>`` with
NCCL, or run on the CPU with gloo.
"""

import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist


def data_ranks(mesh_shape) -> Optional[int]:
    """The number of data-parallel ranks a config's ``mesh_shape`` asks for:
    None without a mesh.  Only the 'data' axis is ported."""
    if not mesh_shape:
        return None
    axes = dict(mesh_shape)
    if set(axes) != {'data'}:
        raise ValueError(
            f'mesh_shape={mesh_shape!r}: only the data axis is ported; the '
            "'model' axis (conv output channels sharded) is not (ROADMAP A9.3)")
    n = int(axes['data'])
    if n < 1:
        raise ValueError(f'mesh_shape={mesh_shape!r}: the data axis needs '
                         'at least one rank')
    return n


class DataParallel:
    """This process's rank of a data-parallel group (the default process
    group, already initialized)."""

    def __init__(self, rank: int, world_size: int, device: torch.device):
        self.rank = rank
        self.world_size = world_size
        self.device = torch.device(device)

    @classmethod
    def init(cls, rank, world_size, init_method, device):
        """Join the group as ``rank`` of ``world_size``: NCCL on a CUDA
        device, gloo on the CPU."""
        device = torch.device(device)
        if device.type == 'cuda':
            torch.cuda.set_device(device)
        dist.init_process_group(
            'nccl' if device.type == 'cuda' else 'gloo',
            init_method=init_method, world_size=world_size, rank=rank)
        return cls(rank, world_size, device)

    def rows(self, batch: int):
        """This rank's contiguous rows [lo, hi) of a batch of ``batch``
        rows; the first ``batch % world_size`` ranks take one more."""
        base, extra = divmod(batch, self.world_size)
        lo = self.rank * base + min(self.rank, extra)
        return lo, lo + base + (self.rank < extra)

    def reduce_grads(self, params, weight: float):
        """Sum ``weight * p.grad`` over the ranks into every ``p.grad``,
        through one flat buffer."""
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads]) * weight
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def gather_rows(self, x, batch: int):
        """The (batch, ...) tensor whose rows ``rows(batch)`` are this
        rank's ``x``: an all-reduce of a zero-filled buffer (NCCL and gloo
        both take it on CUDA tensors; gloo's all_gather does not)."""
        lo, hi = self.rows(batch)
        buf = x.new_zeros((batch,) + tuple(x.shape[1:]))
        buf[lo:hi] = x
        dist.all_reduce(buf)
        return buf

    def all_reduce_(self, t):
        dist.all_reduce(t)
        return t

    def barrier(self):
        if dist.get_backend() == 'nccl':
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def broadcast_state(self, state):
        """Every rank takes rank 0's nets (parameters and buffers), EMA
        generator and optimizer state."""
        tensors = []
        for module in (state.g, state.d, state.g_ema):
            if module is not None:
                tensors += list(module.parameters()) + list(module.buffers())
        for opt in (state.g_opt, state.d_opt):
            for group in opt.param_groups:
                for p in group['params']:
                    s = opt.state.get(p, {})
                    tensors += [s[k] for k in sorted(s)
                                if isinstance(s[k], torch.Tensor)]
        with torch.no_grad():
            for t in tensors:
                # Adam keeps its step count on the host; NCCL takes only
                # tensors on the card
                on = t if t.device == self.device else t.to(self.device)
                dist.broadcast(on, 0)
                if on is not t:
                    t.copy_(on)


def take_rows(draws, lo, hi, taken=None):
    """Rows [lo, hi) of every tensor in ``draws`` (each has the batch as
    its leading axis); a tensor that appears twice (z2 is z1 under
    gp_reuse_fakes) stays one tensor."""
    taken = {} if taken is None else taken
    if isinstance(draws, torch.Tensor):
        if id(draws) not in taken:
            taken[id(draws)] = draws[lo:hi]
        return taken[id(draws)]
    if isinstance(draws, dict):
        return {k: take_rows(v, lo, hi, taken) for k, v in draws.items()}
    if isinstance(draws, (list, tuple)):
        return type(draws)(take_rows(v, lo, hi, taken) for v in draws)
    return draws


def spawn(target, world_size, *args):
    """Run ``target(rank, world_size, init_method, *args)`` in
    ``world_size`` new processes (start method 'spawn'), where
    ``init_method`` is a file rendezvous in a fresh temporary directory.
    ``target`` must be importable by its module path.  If a rank raises,
    the others are terminated and its traceback is raised here."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(
            target, nprocs=world_size, join=True, start_method='spawn',
            args=(world_size, 'file://' + os.path.join(tmp, 'rendezvous'),
                  *args))
