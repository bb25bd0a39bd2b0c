"""Legacy fixed-resolution WGAN trainer (the reference's train.py:454-537).

Counterpart of the JAX package's root legacy_train.py, run by the train CLI
under ``wgan=True`` / ``--wgan``.  Per batch: ``n_critic`` critic updates,
each the Wasserstein loss + drift, an Adam/RMSprop step and then every
critic parameter (BN scale and bias too) clamped to [-0.01, 0.01] for the
Lipschitz condition (train.py:486-487); then one generator update with the
optional (non-decaying) similarity loss.  The learning rate is constant
(the reference's scheduler runs only in the PGGAN path) and the epoch
stats are plain sums over batches, as the reference keeps them.

BatchNorm runs in training mode throughout.  The generator runs in train
mode inside the critic step too, so its running statistics advance there;
per critic step the BN order is D(real), G(z), D(fake), then G(zg) and
D(fake) in the generator step, as in the reference's module calls.

Randomness is drawn apart from the computation (``draw_wgan_batch``), as
in ``train_step``: the batch step takes the augmentation parameters, z per
critic step and zg as arguments, so tests inject the JAX package's draws.
The CLI draws each epoch from ``train.chunk_rng(seed, epoch)``, so a
resumed run draws what the uninterrupted one drew.  Checkpoints are the
JAX legacy trainer's ``.npz`` (``family='wgan'``): either package resumes
the other's run.
"""

import dataclasses
import os

import numpy as np
import torch

from neuron_gan_tpu_torch.checkpoint import Checkpointer
from neuron_gan_tpu_torch.convert import (
    load_jax_legacy_state, to_jax_legacy_state)
from neuron_gan_tpu_torch.data.augment import (
    AugmentSpec, augment_batch, draw_augment)
from neuron_gan_tpu_torch.losses import similarity_loss
from neuron_gan_tpu_torch.models.legacy import (
    DiscriminatorWGAN, GeneratorWGAN)
from neuron_gan_tpu_torch.runtime import precision_scope
from neuron_gan_tpu_torch.train_step import (
    _grads_into, _set_lr, _to, make_optimizer)
from neuron_gan_tpu_torch.utils.latents import sample_latent_vec
from neuron_gan_tpu_torch.utils.monitor import calculate_d_steps
from neuron_gan_tpu_torch.utils.plotting import (
    plot_scores, save_image_grid, seeded_latents)

FILENAME_FORMAT = '{prefix}_{ID}.{ext}'
STAT_NAMES = ('score_real', 'score_fake', 'D_loss', 'G_loss')


@dataclasses.dataclass
class LegacyState:
    g: torch.nn.Module
    d: torch.nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer


def init_legacy_state(g, d, beta1=0.5, rmsprop=False):
    return LegacyState(g, d, make_optimizer(g.parameters(), beta1, rmsprop),
                       make_optimizer(d.parameters(), beta1, rmsprop))


def draw_wgan_batch(rng: torch.Generator, batch, frame, latent_dim,
                    n_critic, aug_spec: AugmentSpec):
    """Every random number of one batch step, drawn from ``rng``: the
    augmentation parameters, z per critic step and the generator's zg."""
    return {'augment': draw_augment(rng, batch, frame, aug_spec),
            'z': [sample_latent_vec(rng, (batch, latent_dim))
                  for _ in range(n_critic)],
            'zg': sample_latent_vec(rng, (batch, latent_dim))}


def make_wgan_batch_step(*, n_critic, drift_epsilon, sim_lambda, lr,
                         aug_spec: AugmentSpec, clamp=0.01, precision=None):
    """Build ``step(state, raw_batch, draws)``: one legacy WGAN update on a
    raw batch (B, P, P, C) in [0, 1].  Returns the stats (STAT_NAMES) of
    the batch, on the device: the last critic step's scores and loss and
    the generator's loss."""

    def step(state: LegacyState, raw_batch, draws):
        with precision_scope(precision):
            return _step(state, raw_batch, _to(draws, raw_batch.device))

    def _step(state, raw_batch, draws):
        images = augment_batch(raw_batch, draws['augment'], aug_spec)
        d_params = list(state.d.parameters())
        g_params = list(state.g.parameters())
        _set_lr(state.d_opt, lr)
        _set_lr(state.g_opt, lr)
        sr = sf = d_loss = torch.zeros((), device=images.device)
        for j in range(n_critic):
            real_scores = state.d(images)
            with torch.no_grad():
                fake = state.g(draws['z'][j])
            fake_scores = state.d(fake)
            sr, sf = real_scores.mean(), fake_scores.mean()
            d_loss = -sr + sf
            if drift_epsilon > 0:
                d_loss = d_loss + drift_epsilon * torch.mean(real_scores ** 2)
            _grads_into(d_loss, d_params)
            state.d_opt.step()
            with torch.no_grad():
                for p in d_params:
                    p.clamp_(-clamp, clamp)

        scores = state.d(state.g(draws['zg']))
        g_loss = -scores.mean()
        if sim_lambda > 0:
            g_loss = g_loss + similarity_loss(images, draws['zg'], sim_lambda)
        _grads_into(g_loss, g_params)
        state.g_opt.step()
        return torch.stack([sr, sf, d_loss, g_loss]).detach()

    return step


def make_wgan_epoch_runner(*, n_critic, batch_size, n_images, latent_dim,
                           drift_epsilon, sim_lambda, lr, crop_size, out_size,
                           translation, clamp=0.01, precision=None):
    """Build ``run(state, images_stack, rng)`` -> the epoch's stats (4,),
    raw sums over its batches.  Each epoch draws a permutation, then each
    batch's draws, from ``rng``; the last batch may be partial (the
    reference's DataLoader keeps it)."""
    aug_spec = AugmentSpec(crop_size=crop_size, out_size=out_size,
                           translation=translation, augment=True)
    step = make_wgan_batch_step(n_critic=n_critic, drift_epsilon=drift_epsilon,
                                sim_lambda=sim_lambda, lr=lr,
                                aug_spec=aug_spec, clamp=clamp,
                                precision=precision)

    def run(state: LegacyState, images_stack, rng: torch.Generator):
        order = torch.randperm(n_images, generator=rng, device=rng.device)
        order = order.to(images_stack.device)
        total = torch.zeros(len(STAT_NAMES), device=images_stack.device)
        for start in range(0, n_images, batch_size):
            raw = images_stack[order[start:start + batch_size]]
            draws = draw_wgan_batch(rng, raw.shape[0], raw.shape[1],
                                    latent_dim, n_critic, aug_spec)
            total = total + step(state, raw, draws)
        return total

    return run


def wgan_train(config, dataset, device):
    """The legacy WGAN training loop over epochs [checkpoint + 1, N_epochs],
    on ``device``.  Returns the train state."""
    from neuron_gan_tpu_torch.train import chunk_rng
    if config.mesh_shape:
        # the legacy fixed-resolution WGAN path is single-device, like the
        # reference; say so instead of silently idling the other cards
        print('wgan path: mesh_shape is ignored — legacy WGAN trains '
              'single-device; use the PGGAN path for data/model parallelism')
    init = torch.Generator().manual_seed(config.seed)
    g = GeneratorWGAN(config.N_gen_features, init, latent_dim=config.latent_dim,
                      image_size=config.image_size, n_colors=config.N_colors,
                      device=device)
    d = DiscriminatorWGAN(config.N_dis_features, init,
                          image_size=config.image_size,
                          n_colors=config.N_colors, device=device)
    state = init_legacy_state(g, d, config.beta1, config.RMSprop)

    weights = os.path.join(config.weights_dir, FILENAME_FORMAT.format(
        prefix='GenDisc', ID=config.ID, ext='npz'))
    checkpoint = Checkpointer(weights, n_epochs=config.N_epochs,
                              extra_checkpoint_period=1e3)
    if config.resume and os.path.exists(weights):
        tree, _ = checkpoint.load_state()
        load_jax_legacy_state(state, tree)

    images_stack = torch.from_numpy(np.array(dataset.images)).to(device)
    eval_noise = seeded_latents(16, config.latent_dim, config.seed).to(device)
    summary = os.path.join(config.plots_dir,
                           'Training_summary_{}.png'.format(config.ID))
    precision = config.precision_of(config.matmul_precision)

    runner = None
    n_critic = config.n_critic
    for epoch in range(checkpoint.epoch + 1, config.N_epochs + 1):
        if config.adapt_critic:
            n_c = calculate_d_steps(checkpoint.loss_real[:epoch - 1],
                                    checkpoint.loss_fake[:epoch - 1],
                                    1, config.n_critic, 10)
        else:
            n_c = config.n_critic
        if runner is None or n_c != n_critic:
            n_critic = n_c
            runner = make_wgan_epoch_runner(
                n_critic=n_critic, batch_size=config.batch_size,
                n_images=len(dataset), latent_dim=config.latent_dim,
                drift_epsilon=config.drift_epsilon,
                sim_lambda=config.sim_loss_lambda, lr=config.learning_rate,
                crop_size=dataset.image_size_max,
                out_size=dataset.image_size_max,
                translation=config.translation, precision=precision)
        stats = runner(state, images_stack,
                       chunk_rng(device, config.seed, epoch)).cpu().numpy()
        print('Epoch: %d, N_D_steps: %d | Loss_real (<D(x)>_x): %.4f, '
              'Loss_fake (<D(G(z))>): %.4f, G_loss: %.4f, D_loss: %.4f'
              % (epoch, n_critic, stats[0], stats[1], stats[3], stats[2]))

        checkpoint.loss_real[epoch - 1] = stats[0]
        checkpoint.loss_fake[epoch - 1] = stats[1]
        checkpoint.loss_d[epoch - 1] = stats[2]
        checkpoint.loss_g[epoch - 1] = stats[3]

        if epoch % config.checkpointing_period == 0:
            checkpoint.save_state(epoch, to_jax_legacy_state(state), meta={
                'family': 'wgan', 'lr': config.learning_rate,
                'image_size': config.image_size, 'alpha': 1.0, 'phase': 0,
                'ID': config.ID,
                'N_gen_features': list(config.N_gen_features),
                'N_dis_features': list(config.N_dis_features),
                'latent_dim': config.latent_dim})
            state.g.eval()
            with torch.no_grad(), precision_scope(precision):
                fake = state.g(eval_noise)
            state.g.train()
            path = os.path.join(config.images_dir,
                                'Samples_{}_{:d}.png'.format(config.ID, epoch))
            save_image_grid(fake.permute(0, 2, 3, 1).cpu().numpy(), path,
                            nrow=4, normalize=True)
            plot_scores(checkpoint.loss_real[:epoch],
                        checkpoint.loss_fake[:epoch], summary)
    return state
