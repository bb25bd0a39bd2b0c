"""Data parallelism over processes: the JAX package's 'data' mesh axis.

Counterpart of the 'data' axis of neuron_gan_tpu/parallel/mesh.py.  JAX is
single-controller: XLA shards the batch over the mesh and all-reduces the
gradients.  PyTorch runs one process per rank (``mesh.Grid``), so here
every data rank trains on a contiguous slice of each batch's rows:

- every rank draws the global batch's permutation and draws from the same
  seeded generator, then takes its rows of the batch and of every
  per-sample draw (``Grid.rows``, ``take_rows``), so an N-rank run is the
  1-process run up to the order of its sums;
- after each gradient and before each optimizer step the gradients of one
  network are flattened into one buffer, scaled by ``b_r / B`` (this
  rank's rows over the global batch) and summed over the ranks
  (``Grid.reduce_grads``; under a model axis ``mesh.NetShards``): each
  loss term is a mean over samples, so the sum is the global batch's mean
  gradient, as in JAX's SPMD step.

The nets are not wrapped in ``DistributedDataParallel``: the gradient
penalty is a gradient of a gradient taken with ``torch.autograd.grad``,
and DDP's reducer hooks only ``.backward()``.

A rank whose slice of a partial batch is empty still joins every
collective, with zero gradients.  Ranks bind ``cuda:<local rank>`` with
NCCL, or run on the CPU with gloo.
"""

import os
import tempfile

import torch


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
