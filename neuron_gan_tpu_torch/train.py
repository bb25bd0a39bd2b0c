"""Training CLI of the port — the JAX package's train.py interface.

    python -m neuron_gan_tpu_torch.train --configs my_config [--flag value ...]

Flag set, precedence (defaults < config module < explicit CLI flags), ID
collision prompt, seeding, dataset/model construction, checkpoint/resume,
monitoring line and checkpoint-time artifacts mirror the JAX package's
train.py (itself the reference's train.py:39-451).  Training runs as epoch
chunks through ``train_step.make_epoch_runner``, cut where the schedule
changes (``TrainSchedule.chunk_end``).

Runs on the card unless ``--device cpu`` (or the ``device`` knob) asks for
the CPU; without CUDA the default raises.

``mesh_shape={'data': D}`` trains data-parallel over D processes
(``parallel/data.py``), and ``mesh_shape={'data': D, 'model': M}`` over a
grid of D·M, each rank holding its slice of the weights that JAX's rule
shards, of their Adam moments and of the EMA generator
(``parallel/mesh.py``): the command spawns the ranks itself, one per card
(NCCL; gloo under ``--device cpu``), or joins the group of a launcher that
set ``WORLD_SIZE`` (``torchrun``).  A dataset stack above ``hbm_budget_mb``
streams from the host (``streaming.py``).  ``wgan=True`` runs the legacy
fixed-resolution WGAN trainer (``legacy_train.py``).

Randomness: each chunk draws from a fresh torch.Generator on the device,
seeded from (seed + 977, the chunk's first epoch) — the counterpart of
the JAX package's ``fold_in(PRNGKey(seed + 977), epoch)`` — so a session
that resumes on a chunk boundary of the uninterrupted run draws what that
run drew.  The weights come from a CPU generator seeded with ``seed``.
"""

import argparse
import json
import os
import re
import sys
import time
import uuid
from collections import OrderedDict

import numpy as np
import torch

from neuron_gan_tpu_torch import train_step
from neuron_gan_tpu_torch.checkpoint import (
    Checkpointer, import_reference_checkpoint, load_pytree_npz, report_merge)
from neuron_gan_tpu_torch.configs import config as config_module
from neuron_gan_tpu_torch.convert import (
    load_jax_state, load_jax_tree, to_jax_state)
from neuron_gan_tpu_torch.data.augment import (
    AugmentSpec, augment_batch, draw_augment)
from neuron_gan_tpu_torch.data.neuron_dataset import NeuronDataset
from neuron_gan_tpu_torch.losses import d_w_loss, g_w_loss
from neuron_gan_tpu_torch.metrics import swd_multiscale
from neuron_gan_tpu_torch.models import GrowthState, PGConfig, build_nets
from neuron_gan_tpu_torch.parallel import (
    Grid, gather_state, mesh_ranks, shard_state, spawn)
from neuron_gan_tpu_torch.runtime import precision_scope, resolve_device
from neuron_gan_tpu_torch.schedule import TrainSchedule
from neuron_gan_tpu_torch.streaming import (
    group_batches_for_budget, run_epochs_streaming)
from neuron_gan_tpu_torch.utils.crashdump import save_vars
from neuron_gan_tpu_torch.utils.io import validated_input
from neuron_gan_tpu_torch.utils.latents import sample_latent_vec
from neuron_gan_tpu_torch.utils.monitor import calculate_d_steps
from neuron_gan_tpu_torch.utils.plotting import (
    gen_samples, plot_gen_samples, plot_grad_norm, plot_scores, plot_swd,
    pyplot_or_skip)

FILENAME_FORMAT = '{prefix}_{ID}.{ext}'
DISC_ADAPT_UPDATE_PERIOD = 100
MONITORING_PERIOD = 10


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('--configs', type=str, default='',
                        help='Filename of configurations stored in ./configs')
    parser.add_argument('--root_dir', type=str, default=os.path.dirname(__file__))
    parser.add_argument('--dataset_dir', type=str, default='./data/real_images',
                        help='Dataset directory where real images are stored')
    parser.add_argument('--images_dir', type=str, default='./images')
    parser.add_argument('--weights_dir', type=str, default='./weights')
    parser.add_argument('--plots_dir', type=str, default='./plots')

    # WGAN config
    parser.add_argument('--wgan', action='store_true',
                        help='Use the Wasserstein loss function and network')
    parser.add_argument('--n_critic', type=int, default=5,
                        help='Number of critic learning iterations in wgan training')
    parser.add_argument('--adapt_critic', action='store_true', default=False,
                        help='Adapt the number critic training steps')
    parser.add_argument('--unroll_steps', type=int, default=0,
                        help='Number of unrolled discriminator steps (Unrolled GAN)')
    parser.add_argument('--weights_init', type=str, default='',
                        help='Path to weights dict used to initialize networks')
    parser.add_argument('--dis_weights', type=str, default='',
                        help='Path to weights of discriminator')

    # PGGAN config
    parser.add_argument('--pggan', action='store_true',
                        help='Use the Progressively Growing network')
    parser.add_argument('--grad_pen_lambda', type=float, default=0.0)
    parser.add_argument('--transit_sch', type=float,
                        default=[50, 100, 150, 200, 250, 300, 350], nargs='*')
    parser.add_argument('--transit_period', type=int, default=None)
    parser.add_argument('--alpha_step', type=float, default=0.05)

    # Training
    parser.add_argument('--RMSprop', action='store_true', default=False)
    parser.add_argument('--learning_rate', type=float, default=0.00002)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--N_epochs', type=int, default=1000)
    parser.add_argument('--beta1', type=float, default=0.8)
    parser.add_argument('--sim_loss_lambda', type=float, default=0.0)
    parser.add_argument('--sim_loss_lambda_decay_rate', type=float, default=0.0)
    parser.add_argument('--drift_epsilon', type=float, default=0.001)

    # Misc
    parser.add_argument('--ID', type=str, default=uuid.uuid4().hex[:4])
    parser.add_argument('--resume', action='store_true', default=False)
    parser.add_argument('--seed', type=int, default=1)
    parser.add_argument('--checkpointing_period', type=int, default=100)
    parser.add_argument('--translation', type=float, default=0.0)
    parser.add_argument('--device', type=str, default='default',
                        choices=['cuda', 'cpu', 'default'])
    parser.add_argument('--N_workers', type=int, default=2)
    parser.add_argument('--pin_memory', action='store_true', default=False)
    return parser


def load_config(argv, interactive=True):
    """Parse ``argv`` and merge the configuration: defaults < config file <
    explicitly typed CLI flags.  Returns the config module."""
    options = build_parser().parse_args(argv)
    config = config_module
    input_args = [arg[2:].split('=')[0] for arg in argv
                  if arg.startswith('--') and arg != '--configs']
    if options.configs:
        overwritten = {arg: getattr(options, arg) for arg in input_args
                       if hasattr(options, arg)}
        config.import_configs(options.configs, overwritten_configs=overwritten,
                              interactive=interactive)
    else:
        config.reset_configs()
        for arg in input_args:
            if hasattr(options, arg):
                setattr(config, arg, getattr(options, arg))
        config.define_ID_dependent_configs()
        config.validate_configs(interactive=interactive)
    return config


def confirm_id(config):
    """Offer a new ID when a fresh run's ID already names weights (the
    reference's prompt; a non-interactive session keeps the ID)."""
    if config.resume:
        return
    existent = [f for f in os.listdir(config.weights_dir)
                if f.endswith(('.pth', '.npz'))]
    ids_existent = set()
    for f in existent:
        # also the Checkpointer's immutable snapshot files
        # (GenDisc_ab12_1k.npz), so an ID whose rolling file was
        # deleted still registers as taken
        m = re.match(r'(?P<prefix>[^_]+)_(?P<ID>[^_.]+?)(?:_\d+k)?\.(pth|npz)$', f)
        if m:
            ids_existent.add(m.group('ID'))
    if config.ID in ids_existent:
        ans = validated_input(
            'ID={} already exists. Use a new ID(y/n)?'.format(config.ID),
            lambda x: x in ['y', 'n'], default='n')
        if ans == 'y':
            config.ID = validated_input('Type a new ID:',
                                        lambda x: x not in ids_existent,
                                        'ID already exists.')
            config.define_ID_dependent_configs()


def load_dataset(config):
    return NeuronDataset(directory=config.dataset_dir,
                         image_size=config.image_size,
                         augmentations=True,
                         im_translation=config.translation,
                         seed=config.seed,
                         preload_limit_mb=config.dataset_preload_limit_mb,
                         n_colors=config.N_colors)


def chunk_rng(device, seed, first_epoch):
    """The generator a chunk draws from: a function of (seed + 977, the
    chunk's first epoch) alone."""
    state = np.random.SeedSequence([seed + 977, first_epoch]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class TrainSession:
    """One training session: the configuration, dataset, models, optimizers
    and checkpointer, and ``train()`` over [epoch_init, epoch_final).

    With ``grid`` (parallel.Grid) it is one rank of a parallel run: it
    trains on its rows of every batch, under a model axis it keeps its
    slices of the state (``self.state.shards``), and rank 0 alone writes
    checkpoints, grids, plots and the SWD series."""

    def __init__(self, config, grid=None):
        self.config = config
        self.grid = grid
        self.writer = grid is None or grid.rank == 0
        config.print_configs()
        if grid is None:
            # 'default' and 'cuda' are the card, which must exist
            self.device = resolve_device(config.device)
            confirm_id(config)
        else:
            self.device = grid.device

        # ------------------------------------------------------ dataset
        # rank 0 first: it may build the loader's memmap cache
        if grid is not None and grid.rank != 0:
            grid.barrier()
        self.dataset = load_dataset(config)
        if grid is not None and grid.rank == 0:
            grid.barrier()
        self.n_images = len(self.dataset)

        # ------------------------------------------------------ networks
        if not config.pggan:
            raise Exception('dcgan training is not implemented with new configs')
        n_upsamples = len(config.N_gen_features) - 1
        self.model_cfg = PGConfig(
            n_gen_features=tuple(config.N_gen_features),
            n_dis_features=tuple(config.N_dis_features),
            latent_dim=config.latent_dim,
            image_size_init=self.dataset.image_size_max // (2 ** n_upsamples),
            n_colors=config.N_colors,
            neg_slope=config.LeakyReLU_leak,
            compute_dtype=config.compute_dtype,
            precision=config.precision_of(config.matmul_precision),
            packed_min_res=config.packed_min_res,
            packed_lanes=config.packed_lanes,
            use_kernels=config.use_kernels,
            architecture=config.architecture,
        )
        init = torch.Generator().manual_seed(config.seed)
        g, d = build_nets(self.model_cfg, init, device=self.device)
        self.state = train_step.init_train_state(g, d, config.beta1, config.RMSprop,
                                      ema_beta=config.ema_beta,
                                      beta2=config.beta2)
        growth = GrowthState(self.model_cfg)
        print('Generator params: {:,}'.format(sum(p.numel() for p in g.parameters())))
        print('Discriminator params: {:,}'.format(sum(p.numel() for p in d.parameters())))

        # ------------------------------------------------ checkpoint/resume
        self.weights_path = os.path.join(
            config.weights_dir, FILENAME_FORMAT.format(prefix='GenDisc', ID=config.ID,
                                                       ext='npz'))
        self.checkpoint = Checkpointer(self.weights_path, n_epochs=config.N_epochs,
                                       extra_checkpoint_period=1e3)
        meta = None
        if config.resume and not os.path.exists(self.weights_path):
            # a deleted/renamed rolling file would otherwise silently
            # restart a run the user believes is resuming
            print('resume: no checkpoint at {} — starting a fresh run'.format(
                self.weights_path))
        if config.resume and os.path.exists(self.weights_path):
            tree, meta = self.checkpoint.load_state()
            self._restore(tree, 'resume')
            growth = self._growth_from_meta(meta)
        elif config.weights_init:
            growth = self._weights_init(os.path.join(config.weights_dir,
                                                     config.weights_init), growth)
        if grid is not None:
            # every rank loads whole leaves, takes rank 0's, then keeps
            # its slices
            grid.broadcast_state(self.state)
            self.state = shard_state(self.state, grid)
        self.dataset.set_image_size(growth.image_size)

        # the stack lives on the device, or above the budget on the host,
        # streamed per epoch (the reference re-reads oversize datasets from
        # disk per item, NeuronDataset.py:128-146)
        stack_bytes = self.n_images * self.dataset.padded_size ** 2 * 4
        self.streaming = bool(config.hbm_budget_mb) and \
            stack_bytes > config.hbm_budget_mb * 2 ** 20
        if self.streaming:
            print('dataset stack {:.0f} MB exceeds hbm_budget_mb={} — streaming '
                  'from host per epoch'.format(stack_bytes / 2 ** 20,
                                               config.hbm_budget_mb))
            # a bounded sample on the device: checkpoint artifacts and the
            # SWD real set
            self.images_stack = torch.from_numpy(
                np.array(self.dataset.images[:64])).to(self.device)
        else:
            self.images_stack = torch.from_numpy(
                np.array(self.dataset.images)).to(self.device)

        # ------------------------------------------------------ schedule
        self.sched = TrainSchedule(transit_sch=tuple(config.transit_sch),
                                   alpha_step=config.alpha_step,
                                   n_epochs=config.N_epochs,
                                   checkpointing_period=config.checkpointing_period,
                                   lr0=config.learning_rate)
        self.epoch_init = self.checkpoint.epoch + 1
        # the lr is a pure function of epoch; a mismatch means the
        # checkpoint was written under a different schedule
        if meta is not None and self.checkpoint.epoch > 0:
            saved_lr = meta.get('lr')
            lr_now = self.sched.lr_at(self.checkpoint.epoch)
            if saved_lr is not None and not np.isclose(float(saved_lr), lr_now,
                                                       rtol=1e-5):
                print('resume: checkpoint meta lr {:.6g} != schedule lr {:.6g} at '
                      'epoch {} — resuming with the schedule value'.format(
                          float(saved_lr), lr_now, self.checkpoint.epoch))
        if config.N_epochs_session:
            # the schedule (and the loss series) end at N_epochs
            self.epoch_final = min(self.epoch_init + config.N_epochs_session,
                                   config.N_epochs + 1)
        else:
            self.epoch_final = config.N_epochs + 1

        self.summary_path = os.path.join(
            config.plots_dir, 'Training_summary_{}.png'.format(config.ID))
        self.swd_log_path = os.path.join(config.logs_dir,
                                         'SWD_{}.jsonl'.format(config.ID))
        self.swd_plot_path = os.path.join(config.plots_dir,
                                          'SWD_{}.png'.format(config.ID))
        self.swd_records = []
        if config.swd_period > 0 and self.writer:
            if config.resume and os.path.exists(self.swd_log_path):
                with open(self.swd_log_path) as fh:
                    records = [json.loads(line) for line in fh if line.strip()]
                # a resumed run re-trains epochs after the checkpoint; drop
                # (and rewrite the series without) their now-stale scores
                self.swd_records = [r for r in records
                                    if r['epoch'] <= self.checkpoint.epoch]
            with open(self.swd_log_path, 'w') as fh:
                for r in self.swd_records:
                    fh.write(json.dumps(r) + '\n')

    # ------------------------------------------------------------ restore
    def _growth_from_meta(self, meta):
        growth = GrowthState(self.model_cfg)
        if meta['image_size'] > self.model_cfg.image_size_init or meta['alpha'] < 1.0:
            growth.set_resolution(int(meta['image_size']), float(meta['alpha']))
        return growth

    def _seed_ema(self, restored_without_ema):
        # a shadow generator the file did not hold starts from the restored
        # generator, not from the fresh initialization
        if self.state.g_ema is not None and restored_without_ema:
            self.state.g_ema.load_state_dict(self.state.g.state_dict())

    def _restore(self, tree, where):
        """Tolerant restore of a JAX-layout train state (the reference loads
        with strict=False, utils.py:213-218)."""
        report = load_jax_state(self.state, tree)
        report_merge(report, where=where)
        self._seed_ema(any(p.startswith('state.g_ema') for p in report['missing']))

    def _weights_init(self, wpath, growth):
        if wpath.endswith('.pth'):
            g_imp, d_imp, cfg_imp, growth, _ = import_reference_checkpoint(wpath)
            assert cfg_imp.n_gen_features == self.model_cfg.n_gen_features, \
                'weights_init architecture mismatch'
            load_jax_tree(self.state.g, g_imp)
            load_jax_tree(self.state.d, d_imp)
            self._seed_ema(True)
        else:
            tree, meta = load_pytree_npz(wpath)
            self._restore(tree if 'g_params' in tree else tree['state'],
                          'weights_init')
            if meta and 'image_size' in meta:
                growth = self._growth_from_meta(meta)
        print('Loaded weights from {}'.format(wpath))
        return growth

    # ------------------------------------------------------------ schedule
    def growth_at(self, e):
        return GrowthState(self.model_cfg, phase=self.sched.phase_at(e),
                           alpha=self.sched.alpha_at(e))

    def next_chunk_end(self, e):
        # adapt_critic recomputes N_D once per window-aligned chunk
        return self.sched.chunk_end(
            e, self.epoch_final,
            adapt_period=(DISC_ADAPT_UPDATE_PERIOD if self.config.adapt_critic
                          else None))

    def make_spec(self, e, n_critic):
        config, sched = self.config, self.sched
        fading, t0 = sched.fading_at(e)
        lrp = sched.lr_phase_of_chunk(e)
        return train_step.ChunkSpec(
            phase=sched.phase_at(e), fading=fading, n_critic=n_critic,
            batch_size=config.batch_size, n_images=self.n_images,
            shuffle=(config.image_preprocessing != 'device'),
            crop_size=self.dataset.image_size_max, translation=config.translation,
            augment=self.dataset.augmentations,
            fast_augment=bool(config.fast_augment),
            shear_warp=(config.shear_warp if config.shear_warp == 'auto'
                        else bool(config.shear_warp)),
            gp_reuse_fakes=bool(config.gp_reuse_fakes),
            gp_lambda=float(config.grad_pen_lambda),
            drift_epsilon=float(config.drift_epsilon),
            sim_lambda0=float(config.sim_loss_lambda),
            sim_decay=float(config.sim_loss_lambda_decay_rate),
            beta1=float(config.beta1), rmsprop=bool(config.RMSprop),
            lr0=float(config.learning_rate), lr_gamma=float(sched.gammas[lrp]),
            lr_boundary=int(sched.boundaries[lrp]),
            lr_cap=int(sched.phase_lens[lrp] // 2),
            lr_prev_final=float(sched.lr_at(e)),
            alpha_start=t0, alpha_step=float(config.alpha_step),
            latent_dim=config.latent_dim,
            ema_beta=float(config.ema_beta),
            beta2=float(config.beta2),
            mirror_augment=bool(config.mirror_augment),
        )

    # ------------------------------------------------------------ artifacts
    def checkpoint_artifacts(self, epoch, growth):
        config = self.config
        samples_path = os.path.join(
            config.samples_sub_dir, 'Samples_{}_{:d}.png'.format(config.ID, epoch))
        plot_gen_samples(self.state.g, growth, n_images=16, seed=0,
                         filename=samples_path)
        plot_scores(self.checkpoint.loss_real[:epoch],
                    self.checkpoint.loss_fake[:epoch], self.summary_path)
        if pyplot_or_skip('gradient-norm') is None:
            return
        # fresh gradient histograms (the reference plots the .grad left on
        # the parameters, train.py:450-451)
        try:
            g_grads, d_grads = self._fresh_grads(epoch, growth)
            plot_grad_norm(g_grads, d_grads, os.path.join(
                config.plots_dir, 'Gradient_norms_{}.png'.format(config.ID)))
        except Exception as exc:  # plots must never kill training
            print(f'grad-norm plot skipped: {exc}')

    def _fresh_grads(self, epoch, growth):
        config, g, d = self.config, self.state.g, self.state.d
        alpha = growth.alpha if growth.fading else None
        rng = torch.Generator(device=self.device).manual_seed(epoch)
        spec = AugmentSpec(crop_size=self.dataset.image_size_max,
                           out_size=growth.image_size,
                           translation=config.translation, augment=True)
        raw = self.images_stack[:config.batch_size]
        batch = augment_batch(raw, draw_augment(rng, raw.shape[0], raw.shape[1],
                                                spec), spec)
        z = sample_latent_vec(rng, (raw.shape[0], config.latent_dim))

        def d_apply(x):
            return d(x, growth.phase, alpha)

        def g_apply(zz):
            return g(zz, growth.phase, alpha)

        def grads(loss, module):
            return [t for t in torch.autograd.grad(
                loss, list(module.parameters()), allow_unused=True)
                if t is not None]

        with precision_scope(self.model_cfg.precision):
            with torch.no_grad():
                fake = g_apply(z)
            d_grads = grads(d_w_loss(d_apply, batch, fake,
                                     config.drift_epsilon)[0], d)
            g_grads = grads(g_w_loss(g_apply, d_apply, z)[0], g)
        return g_grads, d_grads

    def swd_monitor(self, epoch, growth):
        """Score 64 seeded samples at the native resolution against the real
        set (the JAX package's training-time monitor), append to the
        resume-safe JSONL series and refresh the curve."""
        res = int(growth.image_size)
        fake, _ = gen_samples(self.state.g, growth, n_images=64, seed=0)
        spec = AugmentSpec(crop_size=self.dataset.image_size_max, out_size=res,
                           translation=0.0, augment=False)
        real = augment_batch(self.images_stack, None, spec)
        levels, mean = swd_multiscale(
            real, fake, torch.Generator(device=self.device).manual_seed(123),
            n_patches=2048, n_repeats=4)
        rec = {'epoch': int(epoch), 'swd_mean': round(float(mean), 4),
               'levels': [round(float(v), 4) for v in levels],
               'resolution': res,
               'alpha': round(float(min(growth.alpha, 1.0)), 4)}
        self.swd_records.append(rec)
        with open(self.swd_log_path, 'a') as fh:
            fh.write(json.dumps(rec) + '\n')
        plot_swd(self.swd_records, self.swd_plot_path)
        print('SWD at epoch {}: mean {:.4f} (finest {:.4f}, {}x{})'.format(
            epoch, mean, levels[0], res, res))

    def save_checkpoint(self, epoch, growth):
        """Rank 0 writes the train state at ``epoch``.  Under a model axis
        every rank calls it: each model group gathers the sharded leaves
        (rank 0's writes them)."""
        state = gather_state(self.state)
        if not self.writer:
            return
        config = self.config
        meta = {
            # the lr in effect at the checkpointed epoch (the reference
            # saves the current decayed lr, utils.py:166)
            'lr': float(self.sched.lr_at(epoch)),
            'image_size': growth.image_size,
            'alpha': float(min(growth.alpha, 1.0)),
            'phase': growth.phase,
            'ID': config.ID,
            'N_gen_features': list(config.N_gen_features),
            'N_dis_features': list(config.N_dis_features),
            'latent_dim': config.latent_dim,
            'image_size_init': self.model_cfg.image_size_init,
            # architecture knobs eval must reproduce exactly
            'N_colors': self.model_cfg.n_colors,
            'LeakyReLU_leak': self.model_cfg.neg_slope,
        }
        if self.model_cfg.architecture != 'neuron':
            meta['architecture'] = self.model_cfg.architecture
        self.checkpoint.save_state(epoch, to_jax_state(state), meta)

    # ------------------------------------------------------------ training
    def _run_chunk(self, spec, epoch, n_epochs, profile):
        rng = chunk_rng(self.device, self.config.seed, epoch)
        if self.streaming:
            max_group = group_batches_for_budget(
                spec, self.dataset.padded_size,
                self.config.hbm_budget_mb * 2 ** 20)

            def runner(state, _, rng_, first_epoch):
                return run_epochs_streaming(
                    self.model_cfg, spec, state, self.dataset.images, rng_,
                    first_epoch, n_epochs, max_group, self.grid)
        else:
            # looked up at call time, so a caller may wrap it
            runner = train_step.make_epoch_runner(self.model_cfg, spec,
                                                  n_epochs, self.grid)
        if not profile:
            return runner(self.state, self.images_stack, rng, epoch).cpu().numpy()
        from torch.profiler import ProfilerActivity, profile as profiler
        activities = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        with profiler(activities=activities) as prof:
            stats = runner(self.state, self.images_stack, rng, epoch).cpu().numpy()
        os.makedirs(self.config.profile_dir, exist_ok=True)
        path = os.path.join(self.config.profile_dir, f'trace_epoch{epoch}.json')
        prof.export_chrome_trace(path)
        print(f'Profiler trace written to {path}')
        return stats

    def train(self):
        config, sched, ckpt = self.config, self.sched, self.checkpoint
        start_time = time.time()
        monitored = OrderedDict()
        epoch = self.epoch_init
        profiled = False
        n_critic = config.n_critic

        while epoch < self.epoch_final:
            self.dataset.set_image_size(self.growth_at(epoch).image_size)
            # gate on the populated loss-series length, as the reference
            # gates on len(Score_real_series) (train.py:336)
            if config.adapt_critic and (epoch - 1) > DISC_ADAPT_UPDATE_PERIOD:
                n_critic = calculate_d_steps(
                    ckpt.loss_real[:epoch - 1], ckpt.loss_fake[:epoch - 1],
                    0, config.n_critic, DISC_ADAPT_UPDATE_PERIOD)
            else:
                n_critic = config.n_critic

            chunk_end = self.next_chunk_end(epoch)
            n_epochs_chunk = chunk_end - epoch + 1
            spec = self.make_spec(epoch, n_critic)
            # one trace of a steady chunk (not the session's first)
            profile = (bool(config.profile_dir) and epoch > self.epoch_init
                       and not profiled and self.writer)
            stats = self._run_chunk(spec, epoch, n_epochs_chunk, profile)
            profiled = profiled or profile

            # NaN guard (reference loss_functions.py:35-41, host-side here)
            if not np.isfinite(stats).all():
                save_vars({'stats': stats, 'epoch': epoch, 'spec': str(spec)})
                bad = np.argwhere(~np.isfinite(stats))
                raise ValueError(f'NaN/Inf in training stats at chunk epoch '
                                 f'{epoch + int(bad[0][0])}: '
                                 f'{train_step.STAT_NAMES[int(bad[0][1])]}')

            for i in range(n_epochs_chunk):
                e = epoch + i
                ckpt.loss_real[e - 1] = stats[i, 0]
                ckpt.loss_fake[e - 1] = stats[i, 1]
                ckpt.loss_d[e - 1] = stats[i, 2]
                ckpt.loss_g[e - 1] = stats[i, 3]
                if e % MONITORING_PERIOD == 0:
                    self._monitor_line(monitored, e, n_critic, stats[i], start_time)

            chunk_start = epoch
            epoch = chunk_end + 1
            # save on the period, and at session end so trailing epochs of
            # a run off the period are never trained then discarded
            if (chunk_end % config.checkpointing_period == 0
                    or chunk_end == self.epoch_final - 1):
                growth_end = self.growth_at(chunk_end)
                self.save_checkpoint(chunk_end, growth_end)
                if self.writer:
                    self.checkpoint_artifacts(chunk_end, growth_end)
            # quality monitor: when this chunk crossed a multiple of
            # swd_period (chunks need not land on multiples)
            if self.writer and config.swd_period > 0 and (
                    chunk_end // config.swd_period
                    > (chunk_start - 1) // config.swd_period):
                try:
                    self.swd_monitor(chunk_end, self.growth_at(chunk_end))
                except Exception as exc:  # monitoring must never kill training
                    print(f'SWD monitor skipped: {exc}')
            if self.grid is not None:
                # the other ranks wait while rank 0 writes
                self.grid.barrier()
        return self

    def _monitor_line(self, monitored, e, n_critic, st, start_time):
        config = self.config
        fading_e, t0e = self.sched.fading_at(e)
        alpha_e = min((e - t0e) * config.alpha_step, 1.0) if fading_e else 1.0
        res_e = self.model_cfg.resolution(self.sched.phase_at(e))
        monitored['Epoch'] = '{}'.format(e)
        n_completed = e - self.epoch_init
        monitored['time(s)/iter'] = ('{:.1f}'.format(
            (time.time() - start_time) / n_completed)
            if n_completed > 0 else '----')
        monitored['lr'] = '{:.4g}'.format(self.sched.lr_at(e))
        if config.adapt_critic:
            monitored['N_D_steps'] = '{}'.format(n_critic)
        monitored['alpha'] = '{: >5.3f}'.format(alpha_e)
        monitored['Res'] = '{}x{}'.format(res_e, res_e)
        monitored['Loss_real (<D(x)>_x)'] = '{: >#7.4g}'.format(st[0])
        monitored['Loss_fake (<D(G(z))>)'] = '{: >#7.4g}'.format(st[1])
        monitored['G_loss'] = '{: >#7.4g}'.format(st[3])
        monitored['D_loss'] = '{: >#7.4g}'.format(st[2])
        for key, value in (('D_grad_pen', st[4]), ('G_sim_loss', st[5])):
            if value != 0:
                monitored[key] = '{: >#7.4g}'.format(value)
            else:  # don't let a stale value keep printing once it hits 0
                monitored.pop(key, None)
        print(', '.join(s + ':' + v for s, v in monitored.items()))


def _train_rank(rank, world_size, init_method, argv, local_rank=None):
    """One rank of a parallel session (the config's ``mesh_shape``); rank
    0 alone prints.  Returns the rank's finished session."""
    if rank != 0:
        sys.stdout = open(os.devnull, 'w')
    config = load_config(argv, interactive=False)
    if resolve_device(config.device).type == 'cuda':
        local = rank if local_rank is None else local_rank
        if local >= torch.cuda.device_count():
            raise ValueError(f'mesh_shape={config.mesh_shape!r} needs '
                             f'{world_size} GPUs, have '
                             f'{torch.cuda.device_count()}')
        device = torch.device('cuda', local)
    else:
        # CPU ranks share the host's cores
        torch.set_num_threads(1)
        device = torch.device('cpu')
    grid = Grid.init(rank, world_size, init_method, device,
                     model_size=int(dict(config.mesh_shape).get('model', 1)))
    print(f'mesh: data {grid.data_size} x model {grid.model_size}, '
          f'{grid.backend} on {device}')
    try:
        return TrainSession(config, grid).train()
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None):
    """Run one training session; returns it (its state, checkpointer and
    schedule) to an in-process caller: under a launcher, this rank's; none
    when it spawned the ranks itself.  The legacy WGAN path returns its
    train state."""
    argv = sys.argv[1:] if argv is None else list(argv)
    config = load_config(argv)
    if config.wgan:
        from neuron_gan_tpu_torch.legacy_train import wgan_train
        confirm_id(config)
        return wgan_train(config, load_dataset(config),
                          resolve_device(config.device))
    n = mesh_ranks(config.mesh_shape)
    if n is None:
        return TrainSession(config).train()
    if 'WORLD_SIZE' in os.environ:
        # a launcher (torchrun) started this rank
        world = int(os.environ['WORLD_SIZE'])
        if world != n:
            raise ValueError(f'mesh_shape={config.mesh_shape!r} asks for {n} '
                             f'ranks; the launcher started {world}')
        return _train_rank(int(os.environ['RANK']), world, 'env://', argv,
                           int(os.environ.get('LOCAL_RANK', os.environ['RANK'])))
    device = resolve_device(config.device)
    if device.type == 'cuda' and n > torch.cuda.device_count():
        raise ValueError(f'mesh_shape={config.mesh_shape!r} needs {n} GPUs, '
                         f'have {torch.cuda.device_count()}')
    confirm_id(config)
    spawn(_train_rank, n, argv + ['--ID', config.ID])


if __name__ == '__main__':
    main()
