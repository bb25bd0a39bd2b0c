"""WGAN-GP training: one G+D batch step and the epoch runner around it.

Counterpart of neuron_gan_tpu/train_step.py.  Per batch, as in the
reference's hot loop (train.py:350-394): augmentation of the raw batch,
``n_critic`` critic updates -- each the Wasserstein loss + drift + gradient
penalty and an optimizer step -- then one generator update.

PyTorch runs eagerly, so there is no compiled chunk: the runner is a
Python loop over epochs and batches that never waits for the device (the
stats stay on it until the caller reads them).  The models and optimizers
are updated in place.

Randomness is drawn apart from the computation: ``draw_batch`` takes every
random number of one batch step from a torch.Generator (augmentation
parameters, z1/z2/eps per critic step, zg), and the step is a function of
those draws -- so tests can inject the JAX package's draws (its fold_in
keys at train_step.py:285-306), the only honest comparison between two RNG
streams that never agree.

Optimizers are torch.optim's Adam(beta1, beta2, eps=1e-8) -- beta2 0.999
unless the chunk says otherwise (Karras et al. train with 0.99) -- and
RMSprop(alpha=0.99, eps=1e-8), the semantics the JAX package replicates;
the per-epoch lr is written into their param groups before each step, and
the chunk's beta2 before each chunk.

On CUDA the epoch runner replays its steady batch step as a CUDA graph
(``StepGraphs``): one launch a step in place of the eager step's
thousands, the draws still made eagerly and copied into the graph's
static inputs.  ``step_graphs`` counts how each step ran.
"""

import collections
import copy
import dataclasses
from typing import Optional

import numpy as np
import torch

from neuron_gan_tpu_torch.data.augment import (
    AugmentSpec, augment_batch, draw_augment)
from neuron_gan_tpu_torch.losses import (
    d_grad_pen_loss, d_w_loss, g_w_loss, similarity_loss)
from neuron_gan_tpu_torch.models import (
    DiscriminatorPG, GeneratorPG, PGConfig, precision_scope)
from neuron_gan_tpu_torch.parallel.mesh import ShardedState
from neuron_gan_tpu_torch.runtime.timing import span
from neuron_gan_tpu_torch.schedule import TrainSchedule
from neuron_gan_tpu_torch.utils.latents import sample_latent_vec

STAT_NAMES = ('score_real', 'score_fake', 'D_loss', 'G_loss', 'D_grad_pen',
              'G_sim_loss')

# the epoch runner's batch steps by how they ran: 'captured' (CUDA graphs
# recorded), 'replayed', 'eager:<reason>' (``eager_reason``, or 'warmup':
# the eager steps of a graph key before its capture)
step_graphs = collections.Counter()
# eager steps a graph key runs before its capture: they make the
# optimizers' state, the libraries' handles and the constant caches
WARMUP_STEPS = 3


# --------------------------------------------------------------------------
# State and optimizers
# --------------------------------------------------------------------------

def make_optimizer(params, beta1=0.5, rmsprop=False, beta2=0.999):
    """torch.optim optimizer with the reference's settings; its lr is set
    per step (``_set_lr``)."""
    if rmsprop:
        return torch.optim.RMSprop(params, lr=0.0, alpha=0.99, eps=1e-8)
    return torch.optim.Adam(params, lr=0.0, betas=(beta1, beta2), eps=1e-8)


def _capturable(opt, on):
    """Make ``opt`` capturable, or not, where it is not so already.  A
    capturable optimizer keeps its lr in a 0-d tensor and its step counts
    on the parameters' device, so a CUDA graph can replay its step; the
    epoch runner turns it on where it replays its steps and off where it
    runs them eagerly (a capturable step launches more kernels)."""
    for group in opt.param_groups:
        if group['capturable'] == on:
            continue
        group['capturable'] = on
        dev = group['params'][0].device
        group['lr'] = (torch.tensor(float(group['lr']), device=dev) if on
                       else float(group['lr']))
        for p in group['params']:
            st = opt.state.get(p, {})
            if 'step' in st:
                st['step'] = st['step'].to(p.device if on else 'cpu')


@dataclasses.dataclass
class TrainState:
    g: GeneratorPG
    d: DiscriminatorPG
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    g_ema: Optional[GeneratorPG] = None   # shadow generator when ema_beta > 0
    # under a grid's model axis (parallel.shard_state): what this rank
    # keeps; g_opt and d_opt then step its tensors, and g_ema is in it
    shards: Optional[ShardedState] = None
    # the epoch runner's CUDA graphs of this state's steps (a state that
    # dataclasses.replace makes starts without any)
    graphs: 'StepGraphs' = dataclasses.field(
        default_factory=lambda: StepGraphs(), init=False, repr=False,
        compare=False)


def init_train_state(g, d, beta1=0.5, rmsprop=False, ema_beta=0.0,
                     beta2=0.999):
    g_ema = None
    if ema_beta > 0:
        g_ema = copy.deepcopy(g).requires_grad_(False)
    return TrainState(g, d,
                      make_optimizer(g.parameters(), beta1, rmsprop, beta2),
                      make_optimizer(d.parameters(), beta1, rmsprop, beta2),
                      g_ema)


# --------------------------------------------------------------------------
# Chunk description and per-epoch scalars
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChunkSpec:
    """Everything fixed over one chunk of epochs (field meanings as in the
    JAX package's ChunkSpec, which also documents the reference lines)."""
    phase: int
    fading: bool
    n_critic: int
    batch_size: int
    n_images: int
    shuffle: bool
    crop_size: int            # dataset max resolution (CenterCrop target)
    translation: float
    augment: bool
    gp_lambda: float
    drift_epsilon: float
    sim_lambda0: float
    sim_decay: float
    beta1: float
    rmsprop: bool
    lr0: float
    lr_gamma: float           # per-phase decay factor
    lr_boundary: int          # epoch where this phase began
    lr_cap: int               # floor(phase_len / 2)
    alpha_start: int          # transition start epoch (fading chunks)
    alpha_step: float
    latent_dim: int
    # lr while training the transition epoch itself (= the previous phase's
    # final lr; the reference resets only from the following epoch)
    lr_prev_final: float = -1.0
    ema_beta: float = 0.0
    fast_augment: bool = False      # AugmentSpec.fast
    shear_warp: object = False      # True, False or 'auto' (resolve_shear)
    # penalize the critic-loss fake batch (z1) instead of a fresh z2
    gp_reuse_fakes: bool = False
    # D's forward in the penalty under torch.utils.checkpoint
    # (d_grad_pen_loss's remat)
    gp_remat: bool = False
    # Adam's second-moment decay, written into the optimizers each chunk
    beta2: float = 0.999
    # the augmentation is the horizontal flip alone (AugmentSpec.mirror)
    mirror_augment: bool = False

    @property
    def n_full_batches(self):
        return self.n_images // self.batch_size

    @property
    def batch_remainder(self):
        """Size of the final partial batch (reference DataLoader
        drop_last=False; weighted by its true size)."""
        return self.n_images % self.batch_size


def spec_for_chunk(sched: TrainSchedule, epoch: int, base: ChunkSpec):
    """``base`` with the schedule's phase, fade and lr-phase fields for the
    chunk that starts at ``epoch`` (as the JAX package's train.py builds
    its specs)."""
    fading, t0 = sched.fading_at(epoch)
    lrp = sched.lr_phase_of_chunk(epoch)
    return dataclasses.replace(
        base, phase=sched.phase_at(epoch), fading=fading, alpha_start=t0,
        alpha_step=float(sched.alpha_step), lr0=float(sched.lr0),
        lr_gamma=float(sched.gammas[lrp]),
        lr_boundary=int(sched.boundaries[lrp]),
        lr_cap=int(sched.phase_lens[lrp] // 2),
        lr_prev_final=float(sched.lr_at(epoch)))


def _lr(spec: ChunkSpec, epoch):
    """lr in effect at ``epoch`` in float32 arithmetic (the JAX package's
    _traced_lr); the transition epoch itself keeps the previous phase's
    final lr."""
    e_since = epoch - 1 - spec.lr_boundary
    if e_since < 0:
        prev = spec.lr_prev_final if spec.lr_prev_final >= 0 else spec.lr0
        return float(np.float32(prev))
    steps = np.float32(min(e_since, spec.lr_cap))
    return float(np.float32(spec.lr0)
                 * np.power(np.float32(spec.lr_gamma), steps))


def epoch_scalars(spec: ChunkSpec, epoch):
    """(alpha, lr, sim_lambda) for ``epoch`` as Python floats holding the
    float32 values the JAX package computes in-graph."""
    lr = _lr(spec, epoch)
    if spec.fading:
        a = np.float32(epoch - spec.alpha_start) * np.float32(spec.alpha_step)
        alpha = float(np.clip(a, np.float32(0.0), np.float32(1.0)))
    else:
        alpha = 1.0
    if spec.sim_lambda0 > 0 and spec.sim_decay > 0:
        lam = np.float32(spec.sim_lambda0) * np.power(
            np.float32(1.0 - spec.sim_decay), np.float32(epoch - 1))
        lam = float(lam) if lam > 1e-5 else 0.0
    else:
        lam = float(np.float32(spec.sim_lambda0))
    return alpha, lr, lam


# --------------------------------------------------------------------------
# Batch step
# --------------------------------------------------------------------------

def resolve_shear(shear_warp, out_size):
    """Resolve the warp backend for one phase (the JAX package's rule): a
    bool forces it; 'auto' picks the shear warp at every phase resolution
    but 32^2, where the JAX package measured the gather faster."""
    if isinstance(shear_warp, bool):
        return shear_warp
    if shear_warp == 'auto':
        return out_size != 32
    raise ValueError(f'shear_warp must be True, False or "auto"; '
                     f'got {shear_warp!r}')


def _augment_spec(cfg: PGConfig, spec: ChunkSpec):
    """The phase's AugmentSpec; the shear warp only on the fast path, as
    the JAX package builds it."""
    out_size = cfg.resolution(spec.phase)
    if spec.mirror_augment:
        return AugmentSpec(crop_size=spec.crop_size, out_size=out_size,
                           augment=spec.augment, mirror=True)
    return AugmentSpec(crop_size=spec.crop_size, out_size=out_size,
                       translation=spec.translation, augment=spec.augment,
                       fast=spec.fast_augment,
                       shear=(resolve_shear(spec.shear_warp, out_size)
                              and spec.fast_augment))


def draw_batch(rng: torch.Generator, cfg: PGConfig, spec: ChunkSpec,
               batch: int, frame: int):
    """Every random number of one batch step, drawn from ``rng`` on its
    device: augmentation parameters, (z1, z2, eps) per critic step (one set
    when n_critic is 0: the monitoring loss), and the generator's zg."""
    size = (batch, spec.latent_dim)
    critic = []
    for _ in range(max(spec.n_critic, 1)):
        z1 = sample_latent_vec(rng, size)
        z2 = z1 if spec.gp_reuse_fakes else sample_latent_vec(rng, size)
        eps = torch.rand(batch, generator=rng, device=rng.device)
        critic.append((z1, z2, eps))
    return {'augment': draw_augment(rng, batch, frame,
                                    _augment_spec(cfg, spec)),
            'critic': critic,
            'zg': sample_latent_vec(rng, size)}


def _map_tensors(tree, fn, memo=None):
    """``tree`` (dicts, lists and tuples) with each tensor t as fn(t); a
    tensor that appears twice (z2 is z1 under gp_reuse_fakes) maps to one
    result, kept in ``memo`` by the tensor's id."""
    memo = {} if memo is None else memo
    if isinstance(tree, torch.Tensor):
        if id(tree) not in memo:
            memo[id(tree)] = fn(tree)
        return memo[id(tree)]
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn, memo) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn, memo) for v in tree)
    return tree


def _to(draws, device):
    """``draws`` on ``device``; a tensor that appears twice stays one."""
    return _map_tensors(draws, lambda t: t.to(device))


def _tensors(tree):
    """The distinct tensors of ``tree``, in the order first met."""
    memo = {}
    _map_tensors(tree, lambda t: t, memo)
    return list(memo.values())


def _set_lr(opt, lr):
    """``lr`` into ``opt``'s param groups: into the 0-d tensor a capturable
    optimizer holds there (outside any CUDA graph, which reads it), else as
    the Python float."""
    for group in opt.param_groups:
        if isinstance(group['lr'], torch.Tensor):
            group['lr'].fill_(lr)
        else:
            group['lr'] = lr


def _set_beta2(opt, beta2):
    """``beta2`` as Adam's second-moment decay of ``opt``'s param groups
    (an RMSprop has none)."""
    for group in opt.param_groups:
        if 'betas' in group:
            group['betas'] = (group['betas'][0], beta2)


def _grads_into(loss, params):
    """Gradients of ``loss`` w.r.t. ``params`` only, stored in ``.grad``.
    A parameter the phase does not reach gets a zero gradient, not None:
    the optimizer then steps it every time, as optax steps the whole
    pytree, so its Adam step count stays that of the run."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g


def make_batch_step(cfg: PGConfig, spec: ChunkSpec, grid=None):
    """Build ``step(state, raw_batch, draws, alpha, lr, sim_lam[, batch])``:
    one full G+D update on one raw batch (B, P, P, C) in [0, 1].  Returns
    the stats (STAT_NAMES) weighted by the batch size, on the device.  After
    it, the parameters' ``.grad`` hold the last critic step's and the
    generator step's gradients, taken before their optimizer steps.  An
    ``lr`` of None leaves the optimizers' lr as it is set (``StepGraphs``
    writes it outside the graph); ``sim_lam`` may be a 0-d tensor.

    With ``grid`` (parallel.Grid), ``raw_batch`` and ``draws`` are this
    rank's rows ``grid.rows(batch)`` of a global batch of ``batch`` rows
    (possibly none): each gradient is reduced over the ranks before its
    optimizer step, the similarity loss sees the global batch, and the
    stats are this rank's rows' share of the global batch's (their sum over
    the data group is the 1-process step's).  Under a model axis
    (``state.shards``) the reduced gradients are this rank's slices, in
    the ``.grad`` of the tensors the optimizers step, and each optimizer
    step is followed by the refresh of its net's working copy."""
    aug_spec = _augment_spec(cfg, spec)

    def step(state: TrainState, raw_batch, draws, alpha, lr, sim_lam,
             batch=None):
        if lr is not None:
            _set_lr(state.d_opt, lr)
            _set_lr(state.g_opt, lr)
        with precision_scope(cfg.precision):
            return _step(state, raw_batch, _to(draws, raw_batch.device),
                         alpha, sim_lam,
                         raw_batch.shape[0] if batch is None else batch)

    def _step(state, raw_batch, draws, alpha, sim_lam, batch):
        b = raw_batch.shape[0]
        a = alpha if spec.fading else None

        def g_apply(z):
            return state.g(z, spec.phase, a)

        def d_apply(x):
            return state.d(x, spec.phase, a)

        with span('step.augment'):
            images = (augment_batch(raw_batch, draws['augment'], aug_spec)
                      if b else None)
        d_params = list(state.d.parameters())
        g_params = list(state.g.parameters())
        zero = torch.zeros((), device=raw_batch.device)

        def d_total_loss(z1, z2, eps):
            with torch.no_grad(), span('step.critic_fakes'):
                fake = g_apply(z1)
            with span('step.critic_loss'):
                loss_w, (sr, sf) = d_w_loss(d_apply, images, fake,
                                            spec.drift_epsilon)
            gp = zero
            if spec.gp_lambda > 0:
                # z2 is z1 under gp_reuse_fakes: the critic loss's fake
                # batch is the penalty's too (the JAX package's CSE)
                if z2 is not z1:
                    with torch.no_grad(), span('step.critic_fakes'):
                        fake = g_apply(z2)
                with span('step.grad_penalty'):
                    gp = d_grad_pen_loss(d_apply, images, fake, eps,
                                         spec.gp_lambda, remat=spec.gp_remat)
            return loss_w + gp, (sr, sf, gp)

        shards = state.shards
        d_net, g_net = (None, None) if shards is None else (shards.d, shards.g)

        def grads_into(loss, params, net):
            # a rank without rows still joins the reduction
            if b:
                _grads_into(loss, params)
            else:
                for p in params:
                    p.grad = torch.zeros_like(p)
            if net is not None:
                net.reduce_grads(b / batch)
            elif grid is not None:
                grid.reduce_grads(params, b / batch)

        def opt_step(opt, net):
            opt.step()
            if net is not None:
                # the working copy from the stepped slices
                net.refresh()

        sr = sf = gp = d_loss = zero
        for j in range(spec.n_critic):
            if b:
                d_loss, (sr, sf, gp) = d_total_loss(*draws['critic'][j])
            with span('step.critic_backward'):
                grads_into(d_loss, d_params, d_net)
            with span('step.critic_adam'):
                opt_step(state.d_opt, d_net)
        if spec.n_critic == 0 and b:
            # loss computed for monitoring only (reference train.py:369-372)
            d_loss, (sr, sf, gp) = d_total_loss(*draws['critic'][0])

        g_loss = g_sim = zero
        with span('step.gen_loss'):
            if b:
                g_loss, z = g_w_loss(g_apply, d_apply, draws['zg'])
            if spec.sim_lambda0 > 0:
                if grid is None:
                    sim_images, sim_z = images, z
                else:
                    # pairwise over the global batch: its rows from every rank
                    res = cfg.resolution(spec.phase)
                    sim_images = grid.gather_rows(
                        images.reshape(b, -1) if b else
                        raw_batch.new_zeros((0, cfg.n_colors * res * res)),
                        batch)
                    sim_z = grid.gather_rows(
                        z.reshape(b, -1) if b else
                        raw_batch.new_zeros((0, spec.latent_dim)), batch)
                g_sim = similarity_loss(sim_images, sim_z, 1.0) * sim_lam
                g_loss = g_loss + g_sim
        with span('step.gen_backward'):
            grads_into(g_loss, g_params, g_net)
        with span('step.gen_adam'):
            opt_step(state.g_opt, g_net)

        if spec.ema_beta > 0:
            # elementwise: under a model axis on this rank's slices
            pairs = (zip(state.g_ema.parameters(), g_params) if shards is None
                     else zip(shards.g_ema, shards.g.local))
            with torch.no_grad(), span('step.ema'):
                for e, p in pairs:
                    e.mul_(spec.ema_beta).add_(p, alpha=1.0 - spec.ema_beta)
        stats = torch.stack([sr, sf, d_loss, g_loss, gp, g_sim]).detach()
        return stats * b

    return step


# --------------------------------------------------------------------------
# CUDA graphs of the batch step
# --------------------------------------------------------------------------

def eager_reason(device, grid, shards, fading):
    """Why the epoch runner runs its steps eagerly, or None where it
    replays them as CUDA graphs: on CUDA, with no grid, no model axis and
    in a steady chunk (a fading chunk's alpha changes every epoch and
    reaches ``fade_in`` as a Python float)."""
    if torch.device(device).type != 'cuda':
        return 'cpu'
    if grid is not None:
        return 'grid'
    if shards is not None:
        return 'shards'
    if fading:
        return 'fading'
    return None


def graph_key(cfg: PGConfig, spec: ChunkSpec, raw):
    """What a captured step bakes in besides the state's tensors: the
    phase first, the batch's rows, the stack's frame and dtype, the
    augmentation, n_critic and the loss constants; not the lr, the epoch
    or the similarity weight, which it reads from the device."""
    return (spec.phase, raw.shape, raw.dtype, cfg, _augment_spec(cfg, spec),
            spec.n_critic, spec.gp_lambda, spec.drift_epsilon,
            spec.sim_lambda0 > 0, spec.ema_beta, spec.gp_reuse_fakes,
            spec.gp_remat, spec.latent_dim, spec.beta2)


def _params(state):
    return [*state.g.parameters(), *state.d.parameters()]


def _state_tensors(state):
    """The tensors a captured step reads or updates in place: the nets'
    parameters and buffers, the EMA's, the optimizers' state and lr."""
    out = _params(state) + [*state.g.buffers(), *state.d.buffers()]
    if state.g_ema is not None:
        out += [*state.g_ema.parameters(), *state.g_ema.buffers()]
    for opt in (state.g_opt, state.d_opt):
        for group in opt.param_groups:
            out.append(group['lr'])
            for p in group['params']:
                out += [v for v in opt.state.get(p, {}).values()
                        if isinstance(v, torch.Tensor)]
    return out


def _same(a, b):
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


class GraphStep:
    """One batch step over static inputs: ``load`` copies a batch's raw
    rows, its draws and the similarity weight into them, and the step
    reads only them; the optimizers' lr is set by the caller.  Eagerly
    (``eager``) it is the batch step itself; on CUDA ``capture`` records
    it into a CUDA graph that ``replay`` runs again."""

    def __init__(self, step, raw, draws, sim):
        self.step = step
        self.raw = raw.clone()
        self.draws = _map_tensors(draws, torch.clone)
        self.inputs = [self.raw] + _tensors(self.draws)
        self.lam = torch.zeros((), device=raw.device) if sim else None
        self.graph = self.out = self.grads = None
        self.warm = 0

    def load(self, raw, draws, lam):
        for dst, src in zip(self.inputs, [raw] + _tensors(draws)):
            dst.copy_(src)
        if self.lam is not None:
            self.lam.fill_(lam)

    def _call(self, state):
        lam = 0.0 if self.lam is None else self.lam
        return self.step(state, self.raw, self.draws, 1.0, None, lam,
                         self.raw.shape[0])

    def eager(self, state):
        """The step run eagerly, on CUDA on a side stream (as
        torch.cuda.graphs asks of the steps before a capture)."""
        if not self.raw.is_cuda:
            return self._call(state)
        side = torch.cuda.Stream(self.raw.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = self._call(state)
        torch.cuda.current_stream().wait_stream(side)
        return out

    def capture(self, state):
        """Record the step into a CUDA graph (which runs nothing: replay
        it).  The kernels' wrappers count the capture's launches, once; a
        replay launches them again without passing through Python."""
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = self._call(state)
        self.grads = [p.grad for p in _params(state)]

    def replay(self):
        self.graph.replay()
        return self.out


class StepGraphs:
    """A train state's captured batch steps (``TrainState.graphs``), a
    ``GraphStep`` a ``graph_key``, and the state's tensors they were
    captured on."""

    def __init__(self):
        self.steps = {}
        self.tensors = None
        # the step replayed last: the parameters' .grad are its gradients
        self.last = None

    def check(self, state, phase):
        """Drop every graph when the state's tensors, or the gradients of
        the step replayed last, are no longer those the graphs hold (a
        checkpoint restore replaces the optimizers' state; an eager step
        the gradients), and the graphs of other phases."""
        if self.tensors is not None and (
                not _same(self.tensors, _state_tensors(state))
                or (self.last is not None and not _same(
                    self.last.grads, [p.grad for p in _params(state)]))):
            self.steps.clear()
            self.tensors = self.last = None
        for key in [k for k in self.steps if k[0] != phase]:
            del self.steps[key]

    def run(self, key, step, state, raw, draws, lr, lam):
        """One batch step of the graph ``key``: eager for its first
        WARMUP_STEPS, then captured and replayed.  ``lam`` is the
        similarity weight, None where the step has no similarity loss."""
        g = self.steps.get(key)
        if g is None:
            g = self.steps[key] = GraphStep(step, raw, draws, lam is not None)
        g.load(raw, draws, lam)
        _set_lr(state.d_opt, lr)
        _set_lr(state.g_opt, lr)
        if g.graph is None and g.warm < WARMUP_STEPS:
            g.warm += 1
            step_graphs['eager:warmup'] += 1
            self.last = None
            return g.eager(state)
        if g.graph is None:
            g.capture(state)
            self.tensors = _state_tensors(state)
            step_graphs['captured'] += 1
        out = g.replay()
        step_graphs['replayed'] += 1
        if self.last is not g:
            for p, grad in zip(_params(state), g.grads):
                p.grad = grad
            self.last = g
        return out


# --------------------------------------------------------------------------
# Epoch runner
# --------------------------------------------------------------------------

def epoch_order(spec: ChunkSpec, rng: torch.Generator):
    """The epoch's permutation of the stack, the epoch's first draw from
    ``rng`` (None when ``spec.shuffle`` is off: the stack's order)."""
    if not spec.shuffle:
        return None
    return torch.randperm(spec.n_images, generator=rng, device=rng.device)


def batch_draws(rng, cfg, spec, batch, frame, grid=None):
    """``draw_batch`` for a global batch of ``batch`` rows, and this rank's
    rows of it under ``grid``: every rank draws the whole batch."""
    draws = draw_batch(rng, cfg, spec, batch, frame)
    if grid is None:
        return draws
    from neuron_gan_tpu_torch.parallel import take_rows
    return take_rows(draws, *grid.rows(batch))


def make_epoch_runner(cfg: PGConfig, spec: ChunkSpec, n_epochs: int,
                      grid=None, capture=True):
    """Build ``run(state, images_stack, rng, first_epoch)`` -> per-epoch
    stats (n_epochs, 6), each epoch's batch-weighted sums over n_images.

    ``images_stack`` is (N, P, P, C) in [0, 1] on the models' device; each
    epoch draws a permutation (when ``spec.shuffle``), then the batch
    draws, from ``rng``.  The last batch may be partial.  With ``grid``
    each rank trains on its rows of every batch and the stats are summed
    over the data group.

    Where ``eager_reason`` finds none, the steps run through the state's
    CUDA graphs (``StepGraphs``) and its optimizers are capturable, else
    the steps run eagerly and, on CUDA, the optimizers are not capturable
    (``_capturable``); ``step_graphs`` counts both.  ``capture=False`` runs
    every step eagerly, leaves the optimizers as they are and counts
    nothing: the step-profiling tools, which read the eager step's stage
    spans, build their runner so."""
    step = make_batch_step(cfg, spec, grid)

    def run(state: TrainState, images_stack, rng: torch.Generator,
            first_epoch: int):
        frame = images_stack.shape[1]
        for opt in (state.d_opt, state.g_opt):
            _set_beta2(opt, spec.beta2)
        reason = graphs = None
        if capture:
            reason = eager_reason(images_stack.device, grid, state.shards,
                                  spec.fading)
            if reason != 'cpu':
                _capturable(state.d_opt, reason is None)
                _capturable(state.g_opt, reason is None)
            if reason is None:
                graphs = state.graphs
                graphs.check(state, spec.phase)
        totals = []
        for epoch in range(first_epoch, first_epoch + n_epochs):
            alpha, lr, lam = epoch_scalars(spec, epoch)
            order = epoch_order(spec, rng)
            if order is not None:
                order = order.to(images_stack.device)
            total = torch.zeros(len(STAT_NAMES), device=images_stack.device)
            for start in range(0, spec.n_images, spec.batch_size):
                b = min(spec.batch_size, spec.n_images - start)
                rows = slice(start, start + b)
                if grid is not None:
                    lo, hi = grid.rows(b)
                    rows = slice(start + lo, start + hi)
                raw = (images_stack[order[rows]] if order is not None
                       else images_stack[rows])
                with span('step.draws'):
                    draws = batch_draws(rng, cfg, spec, b, frame, grid)
                if graphs is not None:
                    out = graphs.run(graph_key(cfg, spec, raw), step, state,
                                     raw, draws, lr,
                                     lam if spec.sim_lambda0 > 0 else None)
                else:
                    if reason is not None:
                        step_graphs['eager:' + reason] += 1
                    out = step(state, raw, draws, alpha, lr, lam, b)
                total = total + out
            totals.append(total)
        return epoch_stats(totals, spec, grid)

    return run


def epoch_stats(totals, spec: ChunkSpec, grid=None):
    """Per-epoch stats from each epoch's batch-weighted sums (summed over
    the data group under ``grid``)."""
    totals = torch.stack(totals)
    if grid is not None:
        grid.all_reduce_(totals)
    return totals / spec.n_images
