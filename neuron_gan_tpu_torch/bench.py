"""Benchmark of the port: G+D WGAN-GP train-step throughput and generator
images/s, on the card.

Counterpart of the JAX package's bench.py, with its flags and, for the same
flags, its JSON records (metric names, units and keys):

    python -m neuron_gan_tpu_torch.bench              # shipping step, steady 512^2
        [--batch B] [--no-shear] [--lanes-64] [--remat-gp]
        [--pallas-epilogue] [--pallas-conv]
    python -m neuron_gan_tpu_torch.bench --phase N [--fading] [--exact-augment]
    python -m neuron_gan_tpu_torch.bench --all-phases [--exact-augment]
    python -m neuron_gan_tpu_torch.bench --eval [--fast]     # or --metric=eval
    python -m neuron_gan_tpu_torch.bench --mesh data=D[,model=M] [--phase N]
    python -m neuron_gan_tpu_torch.bench --preset
    python -m neuron_gan_tpu_torch.bench --measure-torch [--phase N]

and in every mode ``--device cpu`` (default: the card) and, in the timed
training modes, ``--windows W`` (default 5).  Each mode prints one JSON
line; ``--all-phases`` one a row (11: 16^2-512^2, steady and fading).

The training modes run the shipping step (``flagship_shipping_config``,
``flagship_shipping_chunk_spec`` with ``gp_reuse_fakes=True``, as bench.py
sets it) through ``make_epoch_runner`` on a synthetic (n_images, 768, 768,
1) stack from numpy's seed 0, with weights from a seeded torch.Generator.
Where this differs from bench.py, on purpose:

- ``value`` is the median steps/s of ``--windows`` windows of 10 epochs
  each, after one warm-up window; ``min``, ``max`` and ``windows`` (every
  window's steps/s) are added.  bench.py times one scanned window, which
  is steady under jit; the eager loop's single windows spread by up to a
  third between runs.  Each window ends on the host copy of its stats.
  ``step_graphs`` says how the runner ran the steps: eagerly (and why) or
  as CUDA graphs captured and replayed (``train_step.step_graphs``).
- ``n_images`` is rounded up to a multiple of the batch, so every batch of
  an epoch has one geometry (bench.py keeps 16, and with ``--batch 12``
  trains a batch of 12 and one of 4 while counting one step).
- ``--unroll`` is refused: it sets a ``lax.scan`` unroll, which an eager
  loop has no counterpart of.  ``--pallas-epilogue`` and ``--pallas-conv``
  name the JAX package's kernels; the port's are on by default
  (``use_kernels``), so the flags change only the metric's name, as
  bench.py names them.  A flag the chosen mode does not take is refused by
  name (bench.py ignores some).
- ``hbm_gb_per_step`` counts the bytes of every input and output tensor of
  every ATen op that is not a view (a ``TorchDispatchMode``) over one batch
  step of the same configuration with ``use_kernels=False``, so the count
  is the same whatever implements the step; bench.py takes XLA's
  HLO-level 'bytes accessed'.  Both are upper bounds of the memory
  traffic.  ``hbm_roofline_pct`` divides by the card's peak from
  ``HBM_PEAK_GBPS``; on a device not in it both keys are left out and
  ``roofline_error`` says why.
- ``--eval`` runs a Python loop of ``n_iters`` grids with one sync at the
  end; bench.py runs them in one jitted scan.
- ``--mesh`` runs one process per rank (``parallel.spawn``, ``Grid``,
  ``shard_state``): NCCL, one card a rank, and raises with fewer cards
  than ranks.  Only under ``--device cpu`` do the ranks run gloo on the
  host, at bench.py's reduced geometry (backend 'cpu-gloo'); there is no
  virtual mesh.  ``--mesh`` takes ``--phase`` (bench.py would run its
  ``--phase`` branch instead).
- ``vs_baseline`` divides by ``TORCH_REF_STEPS_PER_SEC``, the reference's
  step measured by ``--measure-torch`` on the card named beside it; on
  another device it is null.

The process opens no torch.profiler session.
"""

import argparse
import collections
import dataclasses
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from neuron_gan_tpu_torch.eval import fast_config
from neuron_gan_tpu_torch.flagship import (
    flagship_config, flagship_shipping_chunk_spec, flagship_shipping_config)
from neuron_gan_tpu_torch.models import (
    DiscriminatorPG, GeneratorPG, PGConfig, precision_scope)
from neuron_gan_tpu_torch.parallel import Grid, mesh_ranks, shard_state, spawn
from neuron_gan_tpu_torch.runtime import resolve_device
from neuron_gan_tpu_torch.train_step import (
    draw_batch, epoch_scalars, init_train_state, make_batch_step,
    make_epoch_runner, step_graphs)
from neuron_gan_tpu_torch.utils.latents import sample_latent_vec

# The reference's step (``--measure-torch``: 512^2, batch 8) on the card
# named below, steps/s: the divisor of ``vs_baseline``.  Measured by
# ``python3 -m neuron_gan_tpu_torch.bench --measure-torch`` on an NVIDIA
# H100 80GB HBM3 at a 700.00 W power limit (nvidia-smi); two more runs in
# the same call read 5.149 and 5.176.
TORCH_REF_STEPS_PER_SEC = 5.141392628918646
TORCH_REF_DEVICE = 'NVIDIA H100 80GB HBM3'

# Peak device memory rate, GB/s, by torch.cuda.get_device_name(): the H100
# SXM5 (700 W), NVIDIA H100 Tensor Core GPU datasheet.
HBM_PEAK_GBPS = {'NVIDIA H100 80GB HBM3': 3352}

# weights, stacks and draws: bench.py's seed 0
SEED = 0
# a padded 768x768 stack like the real dataset (512 + 2*128)
FRAME = 768
N_EPOCHS_CHUNK = 10
EVAL_IMAGES, EVAL_ITERS, EVAL_REPS = 20, 20, 3
MESH_EPOCHS_CHUNK = 5
# bench.py's virtual-mesh geometry (:170-178), for gloo ranks on the host
MESH_REDUCED = dict(n_gen_features=(16, 8, 8), n_dis_features=(8, 8, 16),
                    latent_dim=16, image_size_init=16, packed_min_res=64,
                    packed_lanes=128, precision=None, compute_dtype='mixed',
                    use_kernels=True)


def device_name(device):
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else device.type)


# --------------------------------------------------------------------------
# Training throughput
# --------------------------------------------------------------------------

def n_images_for(batch):
    """bench.py's stack of max(16, batch) images, rounded up to a multiple
    of the batch."""
    return -(-max(16, batch) // batch) * batch


def train_setup(phase=None, fading=False, fast_augment=True,
                shear_warp='auto', packed_lanes=128, gp_remat=False, batch=8):
    """(PGConfig, ChunkSpec) of one flagship training chunk with bench.py's
    knobs (the shipping step; ``packed_lanes=None`` the 2x2 layout)."""
    cfg = flagship_shipping_config(packed_lanes=packed_lanes)
    if phase is None:
        phase = cfg.n_phases - 1
    spec = flagship_shipping_chunk_spec(
        phase, fading, fast_augment=fast_augment, shear_warp=shear_warp,
        gp_reuse_fakes=True, gp_remat=gp_remat, batch_size=batch,
        n_images=n_images_for(batch))
    return cfg, spec


def _fresh_state(cfg, spec, device):
    init = torch.Generator().manual_seed(SEED)
    return init_train_state(GeneratorPG(cfg, init, device=device),
                            DiscriminatorPG(cfg, init, device=device),
                            beta1=spec.beta1, rmsprop=spec.rmsprop)


def synthetic_stack(n_images, frame, device):
    rng = np.random.default_rng(SEED)
    return torch.from_numpy(
        rng.random((n_images, frame, frame, 1)).astype(np.float32)).to(device)


def _host_finite(stats):
    """The stats on the host (which waits for the device); raises if any
    is not finite."""
    host = stats.cpu().numpy()
    if not np.isfinite(host).all():
        raise RuntimeError(f'non-finite training stats: {host}')
    return host


def train_windows(cfg, spec, device, windows, n_epochs_chunk, frame,
                  grid=None):
    """Train ``cfg`` from seeded weights on a seeded stack: one warm-up
    window, then ``windows`` timed windows of ``n_epochs_chunk`` epochs,
    each ended by the host copy of its stats.  Returns (steps/s of each
    window, steps run in all, the train state)."""
    if spec.n_images % spec.batch_size:
        raise ValueError(f'n_images {spec.n_images} is not a multiple of the '
                         f'batch {spec.batch_size}')
    state = _fresh_state(cfg, spec, device)
    if grid is not None:
        state = shard_state(state, grid)
    images = synthetic_stack(spec.n_images, frame, device)
    rng = torch.Generator(device=device).manual_seed(SEED)
    run = make_epoch_runner(cfg, spec, n_epochs_chunk, grid=grid)
    steps = n_epochs_chunk * spec.n_full_batches
    _host_finite(run(state, images, rng, 1))
    rates = []
    for w in range(1, windows + 1):
        t0 = time.perf_counter()
        _host_finite(run(state, images, rng, 1 + w * n_epochs_chunk))
        rates.append(steps / (time.perf_counter() - t0))
    return rates, (windows + 1) * steps, state


def _summary(rates):
    return {'value': float(np.median(rates)), 'min': min(rates),
            'max': max(rates), 'windows': rates}


def bench_train(cfg, spec, device=None, windows=5, roofline=None):
    """Steps/s of ``cfg`` at ``spec``'s phase (the counterpart of
    bench.py's ``bench_tpu``): a dict of the median ``value``, ``min``,
    ``max`` and ``windows``, the ``steps`` run (warm-up included), the
    final train ``state`` and, with ``roofline`` (a dict the roofline keys
    go into), the ``step_bytes`` counted, and ``step_graphs``: how the
    runner ran its steps (``train_step.step_graphs``)."""
    device = resolve_device(device)
    before = collections.Counter(step_graphs)
    rates, steps, state = train_windows(cfg, spec, device, windows,
                                        N_EPOCHS_CHUNK, FRAME)
    out = dict(_summary(rates), steps=steps, state=state, step_bytes=None,
               step_graphs=dict(step_graphs - before))
    if roofline is not None:
        name = device_name(device)
        peak = HBM_PEAK_GBPS.get(name)
        if peak is None:
            roofline['roofline_error'] = (
                f'no peak memory rate for {name} in HBM_PEAK_GBPS')
        else:
            raw = synthetic_stack(spec.batch_size, FRAME, device)
            per_step = step_bytes(cfg, spec, raw)
            out['step_bytes'] = per_step
            roofline['hbm_gb_per_step'] = round(per_step / 1e9, 3)
            roofline['hbm_roofline_pct'] = round(
                100.0 * per_step * out['value'] / (peak * 1e9), 1)
    return out


class ByteCount(TorchDispatchMode):
    """Counts, for every ATen op run under it that is not a view, the
    bytes of each tensor among its inputs and outputs (elements times
    element size): XLA's 'bytes accessed' (operands plus outputs), an upper
    bound of the memory traffic."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def step_bytes(cfg, spec, raw):
    """``ByteCount`` of one batch step (its draws included) of ``cfg`` with
    ``use_kernels=False`` on the raw batch ``raw``, from seeded weights,
    after one step not counted (which creates Adam's state)."""
    cfg = dataclasses.replace(cfg, use_kernels=False)
    state = _fresh_state(cfg, spec, raw.device)
    step = make_batch_step(cfg, spec)
    rng = torch.Generator(device=raw.device).manual_seed(SEED)
    alpha, lr, lam = epoch_scalars(spec, 1)

    def one():
        draws = draw_batch(rng, cfg, spec, raw.shape[0], raw.shape[1])
        return step(state, raw, draws, alpha, lr, lam)

    _host_finite(one())
    with ByteCount() as count:
        one()
    return count.bytes


def bench_all_phases(fast_augment=True, device=None, windows=5):
    """The per-phase table: one row a phase and fade, 16^2-512^2, each
    printed as one JSON line as it is measured."""
    rows = []
    for phase in range(6):
        res = 16 * 2 ** phase
        for fading in ((False,) if phase == 0 else (False, True)):
            r = bench_train(*train_setup(phase=phase, fading=fading,
                                         fast_augment=fast_augment),
                            device=device, windows=windows)
            rows.append({'resolution': res, 'fading': fading,
                         'fast_augment': fast_augment,
                         'steps_per_sec': round(r['value'], 3),
                         **_spread(r)})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def _spread(r):
    out = {'min': round(r['min'], 3), 'max': round(r['max'], 3),
           'windows': r['windows']}
    if 'step_graphs' in r:
        out['step_graphs'] = r['step_graphs']
    return out


# --------------------------------------------------------------------------
# Generator inference throughput
# --------------------------------------------------------------------------

def eval_config(fast=False):
    """The eval CLI's configuration of the flagship generator: unpacked,
    float32 at 'highest', the kernels on (K1); ``fast`` as ``-fast`` builds
    it."""
    cfg = flagship_config()
    return fast_config(cfg) if fast else cfg


def grid_images(g, z):
    """One grid: ``g`` at its top phase on the latents ``z``."""
    cfg = g.cfg
    with torch.no_grad(), precision_scope(cfg.precision):
        return g(z, cfg.n_phases - 1)


def bench_eval(fast=False, device=None):
    """Images/s of ``EVAL_ITERS`` grids of ``EVAL_IMAGES`` at 512^2, the
    best of ``EVAL_REPS`` after a warm-up (bench.py's ``bench_eval``): a
    dict of the ``value`` and the ``grids`` generated in all."""
    device = resolve_device(device)
    cfg = eval_config(fast)
    g = GeneratorPG(cfg, torch.Generator().manual_seed(SEED), device=device)
    rng = torch.Generator(device=device).manual_seed(SEED)

    def grids():
        total = torch.zeros((), device=device)
        for _ in range(EVAL_ITERS):
            z = sample_latent_vec(rng, (EVAL_IMAGES, cfg.latent_dim))
            total = total + grid_images(g, z).float().mean()
        return _host_finite(total)

    grids()
    best = math.inf
    for _ in range(EVAL_REPS):
        t0 = time.perf_counter()
        grids()
        best = min(best, time.perf_counter() - t0)
    return {'value': EVAL_IMAGES * EVAL_ITERS / best,
            'grids': (EVAL_REPS + 1) * EVAL_ITERS}


# --------------------------------------------------------------------------
# Mesh
# --------------------------------------------------------------------------

def mesh_setup(mesh_shape, phase, backend):
    """(cfg, spec, frame, geometry) of bench.py's mesh measurement: the
    shipping step at the flagship geometry, or under 'cpu-gloo' bench.py's
    reduced one (its dry-run geometry, 64^2 top).  The batch is
    D * max(1, 8 // D)."""
    if backend == 'cpu-gloo':
        cfg = PGConfig(**MESH_REDUCED)
        phase = min(phase, cfg.n_phases - 1)
        geometry = ('reduced (dryrun-scale, packed_lanes=128 native-2x4 '
                    '64^2 top)')
        crop = cfg.resolution(cfg.n_phases - 1)   # 64 + 2*16 crop padding
        frame = crop + crop // 2
    else:
        cfg = flagship_shipping_config()
        geometry = 'flagship'
        crop, frame = 512, FRAME
    data = int(mesh_shape.get('data', 1))
    batch = data * max(1, 8 // data)
    spec = flagship_shipping_chunk_spec(
        phase, batch_size=batch, crop_size=crop, latent_dim=cfg.latent_dim,
        n_images=n_images_for(batch))
    return cfg, spec, frame, geometry


def _mesh_rank(rank, world_size, init_method, mesh_shape, phase, device_type,
               windows, n_epochs_chunk, out_dir):
    """One rank of ``bench_mesh``; rank 0 writes its window rates."""
    if device_type == 'cuda':
        device = torch.device('cuda', rank)
    else:
        torch.set_num_threads(1)   # the ranks share the host's cores
        device = torch.device('cpu')
    grid = Grid.init(rank, world_size, init_method, device,
                     model_size=int(mesh_shape.get('model', 1)))
    try:
        cfg, spec, frame, _ = mesh_setup(
            mesh_shape, phase, 'nccl' if device_type == 'cuda' else 'cpu-gloo')
        rates, _, _ = train_windows(cfg, spec, device, windows,
                                    n_epochs_chunk, frame, grid=grid)
        if rank == 0:
            with open(os.path.join(out_dir, 'rates.json'), 'w') as f:
                json.dump(rates, f)
    finally:
        torch.distributed.destroy_process_group()


def bench_mesh(mesh_shape, phase=2, device=None, windows=5):
    """Steps/s of the shipping step over a (data, model) grid of processes
    beside one process of the same geometry (bench.py's ``bench_mesh``),
    each over windows of ``MESH_EPOCHS_CHUNK`` epochs: its JSON record."""
    n_epochs_chunk = MESH_EPOCHS_CHUNK
    n = mesh_ranks(mesh_shape)
    device = resolve_device(device)
    if device.type == 'cuda':
        if n > torch.cuda.device_count():
            raise ValueError(f'--mesh {mesh_shape!r} needs {n} GPUs, have '
                             f'{torch.cuda.device_count()}')
        backend = 'nccl'
    else:
        backend = 'cpu-gloo'
    cfg, spec, frame, geometry = mesh_setup(mesh_shape, phase, backend)
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_mesh_rank, n, dict(mesh_shape), phase, device.type, windows,
              n_epochs_chunk, tmp)
        with open(os.path.join(tmp, 'rates.json')) as f:
            sharded = json.load(f)
    single, _, _ = train_windows(cfg, spec, device, windows, n_epochs_chunk,
                                 frame)
    res = cfg.resolution(spec.phase)
    s = _summary(sharded)
    return {
        'metric': f'mesh_train_steps_per_sec_{res}',
        'value': round(s['value'], 3),
        'unit': f'steps/sec (G+D, batch {spec.batch_size}, {res}x{res}, '
                f'sharded over {mesh_shape})',
        'vs_baseline': None,
        'mesh_shape': mesh_shape,
        'backend': backend,
        'geometry': geometry,
        'single_device_steps_per_sec': round(float(np.median(single)), 3),
        'note': ('mechanism measurement: gloo ranks share the host CPU, '
                 'not NVLink' if backend == 'cpu-gloo' else
                 'real multi-device mesh'),
        **_spread(s),
    }


# --------------------------------------------------------------------------
# The reference's step
# --------------------------------------------------------------------------

def reference_nets(phase, device):
    """The reference's G and D truncated to ``phase`` (resolution 16 *
    2**phase) as plain torch modules, bench.py's ``bench_torch_reference``
    nets (:298-350), default-initialized under ``SEED``."""
    feats_g = [128, 64, 32, 32, 16, 16][:phase + 1]
    feats_d = [16, 16, 32, 32, 64, 128][-(phase + 1):]
    latent, init = 64, 16
    gain = torch.nn.init.calculate_gain('leaky_relu', 0.2)

    class EqConv(nn.Conv2d):
        def forward(self, x):
            fan = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
            return super().forward((gain / math.sqrt(fan)) * x)

    def pn(x):
        return x / torch.sqrt(torch.mean(x ** 2, dim=1, keepdim=True) + 1e-8)

    class G(nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(latent, feats_g[0] * init * init, bias=False)
            self.conv0 = EqConv(feats_g[0], feats_g[0], 3, padding=1, bias=False)
            self.blocks = nn.ModuleList()
            for i in range(len(feats_g) - 1):
                self.blocks.append(nn.ModuleList([
                    EqConv(feats_g[i], feats_g[i + 1], 3, padding=1, bias=False),
                    EqConv(feats_g[i + 1], feats_g[i + 1], 3, padding=1, bias=False)]))
            self.to_rgb = nn.Conv2d(feats_g[-1], 1, 1, bias=False)

        def forward(self, z):
            x = self.lin((gain / math.sqrt(latent)) * z)
            x = x.view(-1, feats_g[0], init, init)
            x = pn(F.leaky_relu(x, 0.2))
            x = pn(F.leaky_relu(self.conv0(x), 0.2))
            for c1, c2 in self.blocks:
                x = F.interpolate(x, scale_factor=2, mode='bilinear')
                x = pn(F.leaky_relu(c1(x), 0.2))
                x = pn(F.leaky_relu(c2(x), 0.2))
            return torch.tanh(self.to_rgb(x))

    class D(nn.Module):
        def __init__(self):
            super().__init__()
            self.from_rgb = nn.Conv2d(1, feats_d[0], 1)
            self.blocks = nn.ModuleList()
            for i in range(len(feats_d) - 1):
                self.blocks.append(nn.ModuleList([
                    EqConv(feats_d[i], feats_d[i + 1], 3, padding=1, bias=False),
                    EqConv(feats_d[i + 1], feats_d[i + 1], 3, padding=1, bias=False)]))
            self.conv = EqConv(feats_d[-1], feats_d[-1], 3, padding=1)
            self.out = EqConv(feats_d[-1], 1, init)

        def forward(self, x):
            y = self.from_rgb(x)
            for c1, c2 in self.blocks:
                y = F.avg_pool2d(y, 2)
                y = pn(F.leaky_relu(c1(y), 0.2))
                y = pn(F.leaky_relu(c2(y), 0.2))
            y = pn(F.leaky_relu(self.conv(y), 0.2))
            return self.out(y).flatten(1)

    # torch's default initialization draws from the global generator
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        return G().to(device), D().to(device)


def reference_step(g, d, opt_g, opt_d, images, rng, latent=64):
    """One batch step of the reference's hot loop (bench.py :357-376): a
    critic step (Wasserstein loss + drift + the GP's double backward, Adam)
    and a generator step; draws from ``rng``.  Returns the two losses."""
    batch, dev = images.shape[0], images.device
    d.zero_grad()
    z = torch.randn(batch, latent, generator=rng, device=dev)
    fake = g(z).detach()
    loss = -d(images).mean() + d(fake).mean() + 1e-3 * d(images).pow(2).mean()
    eps = torch.rand(batch, 1, 1, 1, generator=rng, device=dev)
    x_hat = (eps * images + (1 - eps) * fake).requires_grad_()
    grad = torch.autograd.grad(d(x_hat).sum(), x_hat, create_graph=True)[0]
    loss = loss + 10.0 * ((grad.norm(2, dim=(1, 2, 3)) - 1) ** 2).mean()
    loss.backward()
    opt_d.step()
    g.zero_grad()
    gl = -d(g(torch.randn(batch, latent, generator=rng, device=dev))).mean()
    gl.backward()
    opt_g.step()
    return torch.stack([loss.detach(), gl.detach()])


def bench_torch_reference(n_steps=2, phase=5, device=None, windows=5):
    """Steps/s of the reference's step (bench.py's
    ``bench_torch_reference``) at PyTorch's own precision flags, as the
    reference ran: one warm-up step, then the median of ``windows``
    windows of ``n_steps`` steps, each ended by the host copy of its
    losses.  Returns ``_summary``'s dict."""
    device = resolve_device(device)
    g, d = reference_nets(phase, device)
    opt_g = torch.optim.Adam(g.parameters(), lr=1e-4, betas=(0.5, 0.999))
    opt_d = torch.optim.Adam(d.parameters(), lr=1e-4, betas=(0.5, 0.999))
    rng = torch.Generator(device=device).manual_seed(SEED)
    res = 16 * 2 ** phase
    images = torch.randn(8, 1, res, res, generator=rng, device=device)
    _host_finite(reference_step(g, d, opt_g, opt_d, images, rng))
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            losses = reference_step(g, d, opt_g, opt_d, images, rng)
        _host_finite(losses)
        rates.append(n_steps / (time.perf_counter() - t0))
    return _summary(rates)


# --------------------------------------------------------------------------
# Command line
# --------------------------------------------------------------------------

# the flags each mode takes (--device in every one)
MODE_FLAGS = {
    'measure_torch': {'phase', 'windows'},
    'all_phases': {'exact_augment', 'windows'},
    'phase': {'phase', 'fading', 'exact_augment', 'windows'},
    'eval': {'fast', 'metric'},
    'mesh': {'phase', 'windows'},
    'preset': {'windows'},
    'headline': {'batch', 'no_shear', 'pallas_epilogue', 'pallas_conv',
                 'lanes_64', 'remat_gp', 'windows'},
}
# headline knobs named in the metric, in bench.py's order (:543-550)
KNOB_KEYS = (('pallas_conv', 'pallas_conv'),
             ('pallas_epilogue', 'pallas_epilogue'),
             ('lanes_64', 'packed_lanes_64'),
             ('remat_gp', 'gp_remat'),
             ('no_shear', 'no_shear'))


def parse_mesh(text):
    try:
        return {k: int(v) for k, v in
                (kv.split('=') for kv in text.split(','))}
    except ValueError:
        raise argparse.ArgumentTypeError(
            f'bad mesh shape {text!r}; expected e.g. data=4,model=2')


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--measure-torch', action='store_true',
                    help="the reference's step (the vs_baseline divisor)")
    ap.add_argument('--all-phases', action='store_true',
                    help='steps/s at every phase, steady and fading')
    ap.add_argument('--phase', type=int, help='growth phase (res 16 * 2**N)')
    ap.add_argument('--fading', action='store_true')
    ap.add_argument('--exact-augment', action='store_true',
                    help="the reference-exact augmentation order")
    ap.add_argument('--eval', action='store_true',
                    help='generator images/s on 20-image 512^2 grids')
    ap.add_argument('--metric', choices=['eval'], help='--metric=eval: --eval')
    ap.add_argument('--fast', action='store_true', help="eval's -fast")
    ap.add_argument('--mesh', type=parse_mesh,
                    help='data=D[,model=M]: steps/s over D*M ranks')
    ap.add_argument('--preset', action='store_true',
                    help='the config_fast preset')
    ap.add_argument('--unroll', type=int, help='refused (see the docstring)')
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--no-shear', action='store_true')
    ap.add_argument('--pallas-epilogue', action='store_true')
    ap.add_argument('--pallas-conv', action='store_true')
    ap.add_argument('--lanes-64', action='store_true',
                    help='the 2x2 layout at every packed level')
    ap.add_argument('--remat-gp', action='store_true')
    ap.add_argument('--windows', type=int, default=5,
                    help='timed windows; value is their median')
    ap.add_argument('--device', type=str, default='default',
                    choices=['cuda', 'cpu', 'default'])
    return ap


def parse_args(argv):
    """(mode, args); a flag the mode does not take is an error."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.unroll is not None:
        ap.error("--unroll is refused: it sets bench.py's lax.scan unroll "
                 'factor, and the eager epoch loop has no counterpart')
    modes = [m for m, on in (('measure_torch', args.measure_torch),
                             ('all_phases', args.all_phases),
                             ('eval', args.eval or args.metric == 'eval'),
                             ('mesh', args.mesh is not None),
                             ('preset', args.preset)) if on]
    if len(modes) > 1:
        ap.error('one mode at a time: ' + ', '.join(
            '--' + m.replace('_', '-') for m in modes))
    mode = modes[0] if modes else (
        'phase' if args.phase is not None else 'headline')
    for flag in ('phase', 'fading', 'exact_augment', 'fast', 'metric',
                 'batch', 'no_shear', 'pallas_epilogue', 'pallas_conv',
                 'lanes_64', 'remat_gp', 'windows'):
        if (getattr(args, flag) != ap.get_default(flag)
                and flag not in MODE_FLAGS[mode]):
            ap.error(f"--{flag.replace('_', '-')} does not apply to "
                     f"{'the headline measurement' if mode == 'headline' else '--' + mode.replace('_', '-')}")
    if args.batch < 1 or args.windows < 1:
        ap.error('--batch and --windows must be >= 1')
    if args.phase is not None and not 0 <= args.phase <= 5:
        ap.error('--phase must lie in 0..5 (16^2..512^2)')
    return mode, args


def baseline_for(device):
    """``TORCH_REF_STEPS_PER_SEC`` on the card it was measured on, else
    None."""
    return (TORCH_REF_STEPS_PER_SEC
            if device_name(resolve_device(device)) == TORCH_REF_DEVICE
            else None)


def records(mode, args):
    """Run one mode; its JSON records (``--all-phases`` prints its rows as
    it goes and returns them)."""
    device = None if args.device == 'default' else args.device
    if mode == 'measure_torch':
        if args.phase is None:
            r = bench_torch_reference(device=device, windows=args.windows)
            return [{'torch_ref_steps_per_sec': r['value'], **_spread(r)}]
        r = bench_torch_reference(n_steps=max(2, 2 ** (6 - args.phase)),
                                  phase=args.phase, device=device,
                                  windows=args.windows)
        return [{'torch_ref_steps_per_sec': r['value'],
                 'resolution': 16 * 2 ** args.phase, **_spread(r)}]
    if mode == 'all_phases':
        return bench_all_phases(fast_augment=not args.exact_augment,
                                device=device, windows=args.windows)
    if mode == 'phase':
        r = bench_train(*train_setup(phase=args.phase, fading=args.fading,
                                     fast_augment=not args.exact_augment),
                        device=device, windows=args.windows)
        return [{'metric': f'wgan_gp_train_steps_per_sec_{16 * 2 ** args.phase}'
                           + ('_fading' if args.fading else ''),
                 'value': round(r['value'], 3),
                 'unit': 'steps/sec (G+D, batch 8, incl. on-device aug)',
                 'vs_baseline': None, **_spread(r)}]
    if mode == 'eval':
        r = bench_eval(fast=args.fast, device=device)
        return [{'metric': 'eval_images_per_sec_512'
                           + ('_fast' if args.fast else ''),
                 'value': round(r['value'], 2),
                 'unit': 'images/sec (20-image grids, 512x512)',
                 'vs_baseline': None}]
    if mode == 'mesh':
        return [bench_mesh(args.mesh, phase=2 if args.phase is None
                           else args.phase, device=device,
                           windows=args.windows)]
    baseline = baseline_for(device)
    if mode == 'preset':
        # config_fast pins the shipping step's knobs (the port's defaults)
        r = bench_train(*train_setup(shear_warp=True), device=device,
                        windows=args.windows)
        return [{'metric': 'wgan_gp_train_steps_per_sec_512_config_fast',
                 'value': round(r['value'], 3),
                 'unit': 'steps/sec (G+D, batch 8, 512x512, incl. on-device aug)',
                 'vs_baseline': (round(r['value'] / baseline, 2)
                                 if baseline else None),
                 **_spread(r)}]
    roofline = {}
    r = bench_train(*train_setup(shear_warp=False if args.no_shear else 'auto',
                                 packed_lanes=None if args.lanes_64 else 128,
                                 gp_remat=args.remat_gp, batch=args.batch),
                    device=device, windows=args.windows, roofline=roofline)
    batch = args.batch
    vs = r['value'] / baseline if baseline and batch == 8 else None
    record = {
        'metric': 'wgan_gp_train_steps_per_sec_512',
        'value': round(r['value'], 3),
        'unit': f'steps/sec (G+D, batch {batch}, 512x512, '
                'incl. on-device aug)',
        'vs_baseline': round(vs, 2) if vs else None,
    }
    if batch != 8:
        record['metric'] += f'_batch{batch}'
        record['batch'] = batch
        record['samples_per_sec'] = round(r['value'] * batch, 1)
    record.update(roofline)
    for flag, key in KNOB_KEYS:
        if getattr(args, flag):
            record['metric'] += '_' + key
            record[key] = True
    record.update(_spread(r))
    return [record]


def main(argv=None):
    mode, args = parse_args(sys.argv[1:] if argv is None else argv)
    out = records(mode, args)
    if mode != 'all_phases':
        for rec in out:
            print(json.dumps(rec), flush=True)
    return out


if __name__ == '__main__':
    main()
