"""Device-memory-bounded training: stream the image stack from the host.

Counterpart of neuron_gan_tpu/streaming.py.  The resident runner
(``train_step.make_epoch_runner``) keeps the whole padded stack on the
device.  Here the stack stays on the host (RAM or a read-only memmap, as
the loader opens it above ``dataset_preload_limit_mb``); each epoch its
batches are gathered on the host group by group and copied to the device
while the previous group trains.

It is the same run as the resident runner: the permutation is drawn with
the same call on the same generator, ``draw_batch`` is called once per
batch in the same order, the host copies consume nothing from the
generator, and the stats are summed batch by batch in the same order.  On
the CPU a streamed run equals the resident one bit for bit.

Double buffering on CUDA: group k+1 is gathered into one of two pinned
host buffers and copied into one of two device buffers on a side stream
while group k computes.  The compute stream waits on the copy's event
before it reads a device buffer; the side stream waits on the compute
stream's event before it overwrites one; the host waits on the copy's
event before it overwrites a pinned buffer.
"""

import numpy as np
import torch

from neuron_gan_tpu_torch.train_step import (
    STAT_NAMES, ChunkSpec, PGConfig, batch_draws, epoch_order,
    epoch_scalars, epoch_stats, make_batch_step)


def plan_groups(n_full_batches: int, max_group_batches: int):
    """Split ``n_full_batches`` into contiguous groups of at most
    ``max_group_batches`` (the last may be smaller)."""
    groups = []
    start = 0
    while start < n_full_batches:
        end = min(start + max_group_batches, n_full_batches)
        groups.append((start, end))
        start = end
    return groups


def group_batches_for_budget(spec: ChunkSpec, frame: int,
                             budget_bytes: float) -> int:
    """Largest group size (in batches) such that two in-flight groups fit in
    ``budget_bytes`` (double buffering keeps at most two groups resident)."""
    bytes_per_batch = spec.batch_size * frame * frame * 4
    g = int(budget_bytes / (2 * bytes_per_batch))
    return max(1, min(g, spec.n_full_batches or 1))


class _Feeder:
    """Two slots, each holding one group of host rows on the device."""

    def __init__(self, host_images, max_rows, device):
        self.host = host_images
        self.cuda = device.type == 'cuda'
        self.groups = [None, None]
        if self.cuda:
            shape = (max_rows,) + tuple(host_images.shape[1:])
            self.pinned = [torch.empty(shape, pin_memory=True)
                           for _ in range(2)]
            self.dev = [torch.empty(shape, device=device) for _ in range(2)]
            self.copied = [torch.cuda.Event() for _ in range(2)]
            self.consumed = [None, None]
            self.side = torch.cuda.Stream(device)

    def put(self, slot, idx):
        """Start moving ``host[idx]`` into ``slot``."""
        if not self.cuda:
            self.groups[slot] = torch.from_numpy(
                np.take(self.host, idx, axis=0))
            return
        n = len(idx)
        # the copy that last read this pinned buffer has finished
        self.copied[slot].synchronize()
        np.take(self.host, idx, axis=0, out=self.pinned[slot].numpy()[:n])
        with torch.cuda.stream(self.side):
            if self.consumed[slot] is not None:
                # the computation that last read this device buffer
                self.side.wait_event(self.consumed[slot])
            self.dev[slot][:n].copy_(self.pinned[slot][:n], non_blocking=True)
            self.copied[slot].record(self.side)
        self.groups[slot] = self.dev[slot][:n]

    def get(self, slot):
        """``slot``'s rows, readable on the current stream."""
        if self.cuda:
            torch.cuda.current_stream().wait_event(self.copied[slot])
        return self.groups[slot]

    def release(self, slot):
        """The current stream has enqueued its last read of ``slot``."""
        if self.cuda:
            self.consumed[slot] = torch.cuda.Event()
            self.consumed[slot].record(torch.cuda.current_stream())


def run_epochs_streaming(cfg: PGConfig, spec: ChunkSpec, state, host_images,
                         rng: torch.Generator, first_epoch: int,
                         n_epochs: int, max_group_batches: int, grid=None):
    """Drop-in for ``make_epoch_runner(cfg, spec, n_epochs, grid)``'s run
    on a host stack: ``host_images`` is an (N, P, P, C) float32 numpy array
    or read-only memmap.  Returns the per-epoch stats (n_epochs, 6).  Under
    ``grid`` each rank gathers only its rows of each batch (the ranks of
    one grid row the same rows)."""
    if len(host_images) != spec.n_images:
        raise ValueError(f'host stack of {len(host_images)} images for a '
                         f'spec of {spec.n_images}')
    device = next(state.g.parameters()).device
    step = make_batch_step(cfg, spec, grid)
    B, frame = spec.batch_size, host_images.shape[1]
    n_full = spec.n_full_batches
    lo, hi = (0, B) if grid is None else grid.rows(B)
    groups = plan_groups(n_full, max_group_batches)
    feeder = _Feeder(host_images, max_group_batches * (hi - lo), device)

    totals = []
    for epoch in range(first_epoch, first_epoch + n_epochs):
        alpha, lr, lam = epoch_scalars(spec, epoch)
        order = epoch_order(spec, rng)
        perm = (np.arange(spec.n_images) if order is None
                else order.cpu().numpy())

        def rows_of(b0, b1):
            return np.concatenate([perm[i * B + lo:i * B + hi]
                                   for i in range(b0, b1)])

        total = torch.zeros(len(STAT_NAMES), device=device)
        if groups:
            feeder.put(0, rows_of(*groups[0]))
        for k, (g0, g1) in enumerate(groups):
            if k + 1 < len(groups):
                feeder.put((k + 1) % 2, rows_of(*groups[k + 1]))
            group = feeder.get(k % 2).view(g1 - g0, hi - lo,
                                           *host_images.shape[1:])
            for j in range(g1 - g0):
                draws = batch_draws(rng, cfg, spec, B, frame, grid)
                total = total + step(state, group[j], draws, alpha, lr, lam, B)
            feeder.release(k % 2)
        rem = spec.batch_remainder
        if rem:
            # the final partial batch, as the JAX package's rem_runner
            r_lo, r_hi = (0, rem) if grid is None else grid.rows(rem)
            tail = np.take(host_images, perm[n_full * B + r_lo:n_full * B + r_hi],
                           axis=0)
            draws = batch_draws(rng, cfg, spec, rem, frame, grid)
            total = total + step(state, torch.from_numpy(tail).to(device),
                                 draws, alpha, lr, lam, rem)
        totals.append(total)
    return epoch_stats(totals, spec, grid)
