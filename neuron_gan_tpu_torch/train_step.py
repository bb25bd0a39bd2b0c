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

Optimizers are torch.optim's Adam(beta1, 0.999, eps=1e-8) and
RMSprop(alpha=0.99, eps=1e-8), the semantics the JAX package replicates;
the per-epoch lr is written into their param groups before each step.
"""

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
from neuron_gan_tpu_torch.schedule import TrainSchedule
from neuron_gan_tpu_torch.utils.latents import sample_latent_vec

STAT_NAMES = ('score_real', 'score_fake', 'D_loss', 'G_loss', 'D_grad_pen',
              'G_sim_loss')


# --------------------------------------------------------------------------
# State and optimizers
# --------------------------------------------------------------------------

def make_optimizer(params, beta1=0.5, rmsprop=False):
    """torch.optim optimizer with the reference's settings; its lr is set
    per step."""
    if rmsprop:
        return torch.optim.RMSprop(params, lr=0.0, alpha=0.99, eps=1e-8)
    return torch.optim.Adam(params, lr=0.0, betas=(beta1, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    g: GeneratorPG
    d: DiscriminatorPG
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    g_ema: Optional[GeneratorPG] = None   # shadow generator when ema_beta > 0


def init_train_state(g, d, beta1=0.5, rmsprop=False, ema_beta=0.0):
    g_ema = None
    if ema_beta > 0:
        g_ema = copy.deepcopy(g).requires_grad_(False)
    return TrainState(g, d, make_optimizer(g.parameters(), beta1, rmsprop),
                      make_optimizer(d.parameters(), beta1, rmsprop), g_ema)


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
    gp_remat: bool = False          # ROADMAP (gp_remat)

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


def _to(draws, device, moved=None):
    """``draws`` on ``device``; a tensor that appears twice (z2 is z1 under
    gp_reuse_fakes) stays one tensor."""
    moved = {} if moved is None else moved
    if isinstance(draws, torch.Tensor):
        if id(draws) not in moved:
            moved[id(draws)] = draws.to(device)
        return moved[id(draws)]
    if isinstance(draws, dict):
        return {k: _to(v, device, moved) for k, v in draws.items()}
    if isinstance(draws, (list, tuple)):
        return type(draws)(_to(v, device, moved) for v in draws)
    return draws


def _set_lr(opt, lr):
    for group in opt.param_groups:
        group['lr'] = lr


def _grads_into(loss, params):
    """Gradients of ``loss`` w.r.t. ``params`` only, stored in ``.grad``.
    A parameter the phase does not reach gets a zero gradient, not None:
    the optimizer then steps it every time, as optax steps the whole
    pytree, so its Adam step count stays that of the run."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g


def make_batch_step(cfg: PGConfig, spec: ChunkSpec):
    """Build ``step(state, raw_batch, draws, alpha, lr, sim_lam)``: one full
    G+D update on one raw batch (B, P, P, C) in [0, 1].  Returns the stats
    (STAT_NAMES) weighted by the batch size, on the device.  After it, the
    parameters' ``.grad`` hold the last critic step's and the generator
    step's gradients, taken before their optimizer steps."""
    if spec.gp_remat:
        raise NotImplementedError('gp_remat is not ported yet (ROADMAP)')
    aug_spec = _augment_spec(cfg, spec)

    def step(state: TrainState, raw_batch, draws, alpha, lr, sim_lam):
        with precision_scope(cfg.precision):
            return _step(state, raw_batch, _to(draws, raw_batch.device),
                         alpha, lr, sim_lam)

    def _step(state, raw_batch, draws, alpha, lr, sim_lam):
        b = raw_batch.shape[0]
        a = alpha if spec.fading else None

        def g_apply(z):
            return state.g(z, spec.phase, a)

        def d_apply(x):
            return state.d(x, spec.phase, a)

        images = augment_batch(raw_batch, draws['augment'], aug_spec)
        d_params = list(state.d.parameters())
        g_params = list(state.g.parameters())
        _set_lr(state.d_opt, lr)
        _set_lr(state.g_opt, lr)
        zero = torch.zeros((), device=images.device)

        def d_total_loss(z1, z2, eps):
            with torch.no_grad():
                fake = g_apply(z1)
            loss_w, (sr, sf) = d_w_loss(d_apply, images, fake,
                                        spec.drift_epsilon)
            gp = zero
            if spec.gp_lambda > 0:
                # z2 is z1 under gp_reuse_fakes: the critic loss's fake
                # batch is the penalty's too (the JAX package's CSE)
                if z2 is not z1:
                    with torch.no_grad():
                        fake = g_apply(z2)
                gp = d_grad_pen_loss(d_apply, images, fake, eps,
                                     spec.gp_lambda)
            return loss_w + gp, (sr, sf, gp)

        sr = sf = gp = d_loss = zero
        for j in range(spec.n_critic):
            d_loss, (sr, sf, gp) = d_total_loss(*draws['critic'][j])
            _grads_into(d_loss, d_params)
            state.d_opt.step()
        if spec.n_critic == 0:
            # loss computed for monitoring only (reference train.py:369-372)
            d_loss, (sr, sf, gp) = d_total_loss(*draws['critic'][0])

        g_loss, z = g_w_loss(g_apply, d_apply, draws['zg'])
        g_sim = zero
        if spec.sim_lambda0 > 0:
            g_sim = similarity_loss(images, z, 1.0) * sim_lam
            g_loss = g_loss + g_sim
        _grads_into(g_loss, g_params)
        state.g_opt.step()

        if spec.ema_beta > 0:
            with torch.no_grad():
                for e, p in zip(state.g_ema.parameters(), g_params):
                    e.mul_(spec.ema_beta).add_(p, alpha=1.0 - spec.ema_beta)
        stats = torch.stack([sr, sf, d_loss, g_loss, gp, g_sim]).detach()
        return stats * b

    return step


# --------------------------------------------------------------------------
# Epoch runner
# --------------------------------------------------------------------------

def make_epoch_runner(cfg: PGConfig, spec: ChunkSpec, n_epochs: int):
    """Build ``run(state, images_stack, rng, first_epoch)`` -> per-epoch
    stats (n_epochs, 6), each epoch's batch-weighted sums over n_images.

    ``images_stack`` is (N, P, P, C) in [0, 1] on the models' device; each
    epoch draws a permutation (when ``spec.shuffle``), then the batch
    draws, from ``rng``.  The last batch may be partial."""
    step = make_batch_step(cfg, spec)

    def run(state: TrainState, images_stack, rng: torch.Generator,
            first_epoch: int):
        bs, frame = spec.batch_size, images_stack.shape[1]
        n_steps = spec.n_full_batches + (1 if spec.batch_remainder else 0)
        out = []
        for epoch in range(first_epoch, first_epoch + n_epochs):
            alpha, lr, lam = epoch_scalars(spec, epoch)
            order = None
            if spec.shuffle:
                order = torch.randperm(spec.n_images, generator=rng,
                                       device=rng.device)
                order = order.to(images_stack.device)
            total = torch.zeros(len(STAT_NAMES), device=images_stack.device)
            for i in range(n_steps):
                rows = slice(i * bs, min((i + 1) * bs, spec.n_images))
                raw = (images_stack[order[rows]] if order is not None
                       else images_stack[rows])
                draws = draw_batch(rng, cfg, spec, raw.shape[0], frame)
                total = total + step(state, raw, draws, alpha, lr, lam)
            out.append(total / spec.n_images)
        return torch.stack(out)

    return run
