"""The (data, model) grid of processes: the JAX package's device mesh.

Counterpart of neuron_gan_tpu/parallel/mesh.py.  JAX declares a mesh
``{'data': D, 'model': M}``, places each array with a PartitionSpec and
lets XLA insert the collectives.  Here a training session runs D·M
processes; rank r sits at (data rank r // M, model rank r % M), the model
axis minor, as ``mesh_utils`` places it.

- **data axis** (``parallel/data.py``): the D rows of the grid train on
  contiguous slices of each batch; the M ranks of one row take the same
  rows.  Gradients are reduced over every rank, the similarity loss's rows
  and the stats over the data group (the ranks of one model rank).
- **model axis**: every weight that JAX's ``param_partition_spec`` shards
  is held in M slices along its output channels, one a rank: the last
  axis of a JAX leaf, which is dim 0 of the port's tensor (the converter
  only transposes).  At rest a rank keeps its slice of each such weight,
  of both Adam moments and of the EMA generator (``shard_state``); the
  other leaves (biases, Adam's count, a layer with one output channel)
  stay whole on every rank.

The nets compute on a whole-weight working copy: the module's own
parameters, which autograd differentiates.  After each gradient one flat
all-reduce over every rank, weighted ``(b_r / B) / M``, gives every rank
the global batch's gradient (the M ranks of a row computed the same one
from the same rows; the ``/ M`` counts it once), of which it keeps its
slice; the optimizer steps the slices, and one flat all-gather over the
model group refreshes the working copy (``NetShards``).  No collective
runs inside autograd, so a rank without rows, which skips the forward,
still joins every collective, and the gradient penalty's double backward
meets none.  The world-wide reduction keeps the replicated leaves bit for
bit equal on every rank.

JAX also shards activations by channel; the port computes whole
activations from the whole working copy, so the step keeps its meaning
and every kernel runs unchanged.
"""

import copy
import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist

MIN_SHARD_CHANNELS = 2


def mesh_ranks(mesh_shape) -> Optional[int]:
    """The number of processes a config's ``mesh_shape`` asks for (D·M),
    or None without a mesh.  Takes ``{'data': D}`` and ``{'data': D,
    'model': M}``."""
    if not mesh_shape:
        return None
    axes = dict(mesh_shape)
    unknown = set(axes) - {'data', 'model'}
    if unknown:
        raise ValueError(f'mesh_shape={mesh_shape!r}: unknown axes '
                         f'{sorted(unknown)}; the axes are data and model')
    if 'data' not in axes:
        raise ValueError(
            f"mesh_shape={mesh_shape!r}: a 'model' axis needs a 'data' axis "
            "beside it (for model parallelism alone, {'data': 1, 'model': "
            f"{axes['model']}}}). The JAX package's step fails on such a "
            "mesh: its batch PartitionSpec('data', ...) names an axis the "
            'mesh lacks, and its tests (tests/test_parallel.py) run only '
            "meshes with a 'data' axis")
    sizes = [int(axes['data']), int(axes.get('model', 1))]
    if min(sizes) < 1:
        raise ValueError(f'mesh_shape={mesh_shape!r}: every axis needs at '
                         'least one rank')
    return sizes[0] * sizes[1]


def is_sharded(shape, model_size: int) -> bool:
    """JAX's ``param_partition_spec`` rule on the port's layout: a tensor
    of two or more dimensions whose dim 0 (the output channels) divides
    into ``model_size`` slices of at least MIN_SHARD_CHANNELS."""
    return (len(shape) >= 2 and shape[0] % model_size == 0
            and shape[0] // model_size >= MIN_SHARD_CHANNELS)


class Grid:
    """This process's place in a (data, model) grid of ``world_size``
    ranks, ``model_size`` along the model axis.  Without a model axis
    (``model_size`` 1) it is plain data parallelism: every group is the
    world."""

    def __init__(self, rank: int, world_size: int, device,
                 model_size: int = 1, backend: Optional[str] = None,
                 data_group=None, model_group=None):
        if world_size % model_size:
            raise ValueError(f'{world_size} ranks do not make a grid with a '
                             f'model axis of {model_size}')
        self.rank = rank
        self.world_size = world_size
        self.device = torch.device(device)
        self.model_size = model_size
        self.data_size = world_size // model_size
        self.data_rank, self.model_rank = divmod(rank, model_size)
        self.backend = backend
        self.data_group = data_group
        self.model_group = model_group

    @classmethod
    def init(cls, rank, world_size, init_method, device, model_size=1,
             backend=None):
        """Join the group as ``rank`` of ``world_size`` (NCCL on a CUDA
        device and gloo on the CPU, unless ``backend`` says) and build the
        grid's data and model groups."""
        device = torch.device(device)
        if device.type == 'cuda':
            torch.cuda.set_device(device)
        backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
        data_group = model_group = None
        if model_size > 1:
            # every rank creates every group, in the same order
            n_data = world_size // model_size
            for m in range(model_size):
                group = dist.new_group([d * model_size + m
                                        for d in range(n_data)])
                if rank % model_size == m:
                    data_group = group
            for d in range(n_data):
                group = dist.new_group([d * model_size + m
                                        for m in range(model_size)])
                if rank // model_size == d:
                    model_group = group
        return cls(rank, world_size, device, model_size, backend,
                   data_group, model_group)

    # ------------------------------------------------------------ data axis
    def rows(self, batch: int):
        """This rank's contiguous rows [lo, hi) of a batch of ``batch``
        rows: its data rank's; the first ``batch % data_size`` data ranks
        take one more."""
        base, extra = divmod(batch, self.data_size)
        lo = self.data_rank * base + min(self.data_rank, extra)
        return lo, lo + base + (self.data_rank < extra)

    def reduce_grads(self, params, weight: float):
        """Sum ``weight * p.grad`` over the ranks into every ``p.grad``,
        through one flat buffer (whole parameters: no model axis)."""
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads]) * weight
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def gather_rows(self, x, batch: int):
        """The (batch, ...) tensor whose rows ``rows(batch)`` are this
        rank's ``x``: an all-reduce of a zero-filled buffer over the data
        group (NCCL and gloo both take it on CUDA tensors; gloo's
        all_gather does not)."""
        lo, hi = self.rows(batch)
        buf = x.new_zeros((batch,) + tuple(x.shape[1:]))
        buf[lo:hi] = x
        dist.all_reduce(buf, group=self.data_group)
        return buf

    def all_reduce_(self, t):
        """Sum ``t`` over the data group, in place: each row's sum counted
        once."""
        dist.all_reduce(t, group=self.data_group)
        return t

    def barrier(self):
        if self.backend == 'nccl':
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def broadcast_state(self, state):
        """Every rank takes rank 0's nets (parameters and buffers), EMA
        generator and optimizer state (a whole state, before
        ``shard_state``)."""
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

    # ----------------------------------------------------------- model axis
    def shard_of(self, t):
        """This rank's slice of ``t`` along dim 0 (a view)."""
        m = self.model_size
        return t.reshape(m, -1)[self.model_rank].view(
            (t.shape[0] // m,) + tuple(t.shape[1:]))

    def all_gather_model(self, row):
        """(model_size, n): every model rank's flat ``row`` of n elements,
        gathered over the model group.  NCCL gathers; gloo, which has no
        all-gather into one tensor, all-reduces a zero-filled buffer (exact:
        each element is one rank's value plus zeros)."""
        out = row.new_empty((self.model_size, row.numel()))
        if self.backend == 'nccl':
            dist.all_gather_into_tensor(out, row, group=self.model_group)
        else:
            out.zero_()
            out[self.model_rank] = row
            dist.all_reduce(out, group=self.model_group)
        return out


class NetShards:
    """One net's parameters under a grid's model axis: ``whole``, the
    module's parameters (the working copy, which autograd differentiates),
    and ``local``, what this rank keeps and the optimizer steps: its slice
    of each leaf ``is_sharded`` picks, a whole copy of each other leaf."""

    def __init__(self, module: torch.nn.Module, grid: Grid):
        self.grid = grid
        named = list(module.named_parameters())
        self.names = [name for name, _ in named]
        self.whole = [p for _, p in named]
        self.sharded = [is_sharded(p.shape, grid.model_size)
                        for p in self.whole]
        self.local = [self.keep(p.detach(), i).clone()
                      for i, p in enumerate(self.whole)]

    def keep(self, t, i):
        """What this rank keeps of a tensor shaped like parameter ``i``:
        its slice (a view), or all of it."""
        return self.grid.shard_of(t) if self.sharded[i] else t

    def named_local(self):
        return zip(self.names, self.local)

    def reduce_grads(self, weight: float):
        """From the working copy's gradients (this rank's rows), the global
        batch's gradient of each local tensor in its ``.grad``: one flat
        all-reduce over every rank of ``weight / model_size`` times them,
        of which this rank keeps its slices."""
        flat = torch.cat([p.grad.reshape(-1) for p in self.whole]) * (
            weight / self.grid.model_size)
        dist.all_reduce(flat)
        offset = 0
        for i, (p, t) in enumerate(zip(self.whole, self.local)):
            g = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
            t.grad = self.keep(g, i)

    def gather(self, tensors):
        """Whole tensors from ``tensors`` (aligned with ``local``): the
        slices all-gathered over the model group through one flat buffer,
        the replicated ones as they are."""
        mine = [t for t, s in zip(tensors, self.sharded) if s]
        if not mine:   # a model axis wider than every layer's slices
            return list(tensors)
        full = self.grid.all_gather_model(
            torch.cat([t.reshape(-1) for t in mine]))
        out, offset = [], 0
        for t, s in zip(tensors, self.sharded):
            if not s:
                out.append(t)
                continue
            n = t.numel()
            out.append(full[:, offset:offset + n].reshape(
                (self.grid.model_size * t.shape[0],) + tuple(t.shape[1:])))
            offset += n
        return out

    @torch.no_grad()
    def refresh(self):
        """The working copy from the local tensors (after each optimizer
        step)."""
        for p, w in zip(self.whole, self.gather(self.local)):
            p.copy_(w)


@dataclasses.dataclass
class ShardedState:
    """What a rank keeps of a train state under a model axis."""
    grid: Grid
    g: NetShards
    d: NetShards
    g_ema: Optional[List[torch.Tensor]] = None   # aligned with g.local


def _opt_like(opt, params, states):
    """An optimizer of ``opt``'s class and settings over ``params``, with
    ``states`` (one dict a parameter) as its state."""
    new = type(opt)(params, **opt.defaults)
    for p, s in zip(params, states):
        if s:
            new.state[p] = s
    return new


def shard_state(state, grid: Grid):
    """A whole train state (``train_step.TrainState``, the same on every
    rank) as this rank keeps it under ``grid``: the nets stay whole as the
    working copy, the optimizers step the local tensors, with their state
    sliced like them, and the EMA generator is kept as local tensors.
    Without a model axis the state stays as it is."""
    if grid.model_size == 1:
        return state
    shards = ShardedState(grid, NetShards(state.g, grid),
                          NetShards(state.d, grid))
    opts = []
    for net, opt in ((shards.g, state.g_opt), (shards.d, state.d_opt)):
        states = [{k: (net.keep(v, i).clone() if v.dim() else v.clone())
                   for k, v in opt.state.get(p, {}).items()}
                  for i, p in enumerate(net.whole)]
        opts.append(_opt_like(opt, net.local, states))
    if state.g_ema is not None:
        shards.g_ema = [shards.g.keep(e.detach(), i).clone()
                        for i, e in enumerate(state.g_ema.parameters())]
    return dataclasses.replace(state, g_opt=opts[0], d_opt=opts[1],
                               g_ema=None, shards=shards)


def gather_state(state):
    """A sharded train state made whole (every rank of a model group must
    call it): the nets' working copies, optimizers over them holding the
    gathered state, and the EMA generator gathered into a module; what
    ``convert.to_jax_state`` writes.  A whole state is returned as it
    is."""
    shards = state.shards
    if shards is None:
        return state
    opts = []
    for net, opt in ((shards.g, state.g_opt), (shards.d, state.d_opt)):
        states = [opt.state.get(t, {}) for t in net.local]
        whole = [{} for _ in net.whole]
        for key in (states[0] if states else {}):
            values = [s[key] for s in states]
            if values[0].dim():
                values = net.gather(values)
            for w, v in zip(whole, values):
                w[key] = v
        opts.append(_opt_like(opt, net.whole, whole))
    g_ema = None
    if shards.g_ema is not None:
        g_ema = copy.deepcopy(state.g).requires_grad_(False)
        with torch.no_grad():
            for p, e in zip(g_ema.parameters(), shards.g.gather(shards.g_ema)):
                p.copy_(e)
    return dataclasses.replace(state, g_opt=opts[0], d_opt=opts[1],
                               g_ema=g_ema, shards=None)
