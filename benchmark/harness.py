"""The benchmark's runs: a cell's set-up, its measured window, its traced
part, and the comparison with the plain reference that decides
``correct``.

Everything that belongs to one configuration, one cell or one per-layer
metric is data found by name under the benchmark's directory:

  configs/<config>.json      the architecture's name, the model, the
                             training hyperparameters, the port's execution
                             knobs, the peak its MFU divides by, ``source``,
                             ``reduced``, ``assumed``;
  architectures/<arch>.py    everything that depends on the model: its
                             inputs, draws, plain reference, the port's
                             objects that run it, its FLOPs and kernel
                             sites (architectures/__init__.py);
  workloads/<cell>.json      the configuration's name, the traffic (a
                             'train' or a 'sample' mix and its
                             parameters), the ``why`` and the limits of the
                             numbers ``correct`` compares;
  metrics/<metric>.py        ``read(reading)``: one per-layer metric from a
                             traced run (``Reading``), or None;
  ../BENCHMARK.json          which metrics each cell reports.

The program under test is ``neuron_gan_tpu_torch``; this module imports it
only inside the functions that drive it.  The references (each
architecture's) import nothing of it.
"""

import dataclasses
import importlib.util
import json
import math
import random
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import architectures
from benchmark import trace as tracing

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'neuron_gan_tpu')
# the reference follows the first steps of a training cell
REF_STEPS = 3
# latent batches a sampling run draws in set-up and cycles through
LATENT_POOL = 1024


# --------------------------------------------------------------------------
# Finding things by name
# --------------------------------------------------------------------------

class Bench:
    """The benchmark's files under ``repo`` (BENCHMARK.json at its root,
    the rest under benchmark/)."""

    def __init__(self, repo=REPO):
        self.repo = Path(repo)
        self.dir = self.repo / 'benchmark'
        self._archs = {}

    def spec(self):
        return json.loads((self.repo / 'BENCHMARK.json').read_text())

    def _json(self, kind, name):
        path = self.dir / kind / f'{name}.json'
        if not path.is_file():
            raise KeyError(f'no {kind[:-1]} named {name!r} ({path})')
        return json.loads(path.read_text())

    def cell(self, name):
        """(cell, its configuration) by the cell's name; the configuration's
        ``arch`` is its architecture's module."""
        cell = self._json('workloads', name)
        cell['name'] = name
        cfg = self._json('configs', cell['config'])
        cfg['name'] = cell['config']
        if 'architecture' not in cfg:
            raise KeyError(f"configuration {cell['config']!r} names no "
                           f"architecture "
                           f"({self.dir / 'configs' / cell['config']}.json)")
        cfg['arch'] = self.architecture(cfg['architecture'])
        return cell, cfg

    def architecture(self, name):
        """The module architectures/<name>.py, loaded once."""
        if name not in self._archs:
            self._archs[name] = architectures.get(
                name, self.dir / 'architectures')
        return self._archs[name]

    def reader(self, metric):
        path = self.dir / 'metrics' / f'{metric}.py'
        spec = importlib.util.spec_from_file_location(
            'benchmark_metric_' + metric.replace('.', '_'), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def metrics_of(self, cell_name, section):
        """The ``section`` ('end_to_end' or 'per_layer') metrics that
        BENCHMARK.json gives the cell."""
        spec = self.spec()
        return [m for m in spec[section]
                if cell_name in m.get('workloads', [cell_name])]


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is the JAX package's or JAX's,
    compared whole."""
    import sys
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split('.')[0] in FORBIDDEN)


# --------------------------------------------------------------------------
# Inputs from the seed
# --------------------------------------------------------------------------

def train_seed(seed):
    """The seed of the training steps' draws, the program's generator's and
    the reference's alike (weights and stack take ``seed`` itself)."""
    return (seed + 1) % 2 ** 64


# --------------------------------------------------------------------------
# The comparison
# --------------------------------------------------------------------------

def _leaf_gaps(prog, ref, keep):
    """({leaf: | |prog| - |ref| | / max(|ref|, the median leaf's |ref|)},
    {leaf: (|prog|, |ref|)}) over ``keep``."""
    norms = {k: (float(prog[k].norm()), float(ref[k].norm())) for k in keep}
    med = statistics.median(r for _, r in norms.values())
    return ({k: abs(p - r) / max(r, med) for k, (p, r) in norms.items()},
            norms)


def _rel_l2(prog, ref, keep):
    """The relative L2 gap of the leaves ``keep`` taken as one vector."""
    diff = math.sqrt(sum(float((prog[k] - ref[k]).norm()) ** 2 for k in keep))
    whole = math.sqrt(sum(float(ref[k].norm()) ** 2 for k in keep))
    return diff / whole


def _worst(gaps):
    """(largest gap, its leaf); a gap that is not finite is the largest."""
    k = max(gaps, key=lambda k: gaps[k] if math.isfinite(gaps[k])
            else math.inf)
    return gaps[k] if math.isfinite(gaps[k]) else math.inf, k


def _step_look(prog, ref, keeps):
    """Where the program's weights part from the reference's over the first
    steps: after each step, each net's worst and median leaf gap of the
    change's norm; after the first, the elements whose change has the
    other sign, and the largest reference first gradient among them over
    the root mean square of its leaf's."""
    look = []
    for i, (ps, rs) in enumerate(zip(prog['steps'], ref['steps'])):
        row = {}
        for net, keep in keeps.items():
            init = ref['init'][net]
            dp = {k: ps[net][k] - init[k] for k in keep}
            dr = {k: rs[net][k] - init[k] for k in keep}
            gaps, _ = _leaf_gaps(dp, dr, keep)
            row[net] = {'worst': _worst(gaps),
                        'median': statistics.median(gaps.values())}
            if i == 0:
                flipped, largest = 0, 0.0
                for k in keep:
                    other = ((torch.sign(dp[k]) != torch.sign(dr[k]))
                             & (dr[k] != 0))
                    g = ref['first_grads'][net][k]
                    if bool(other.any()):
                        flipped += int(other.sum())
                        rms = float(g.pow(2).mean().sqrt())
                        largest = max(largest,
                                      float(g[other].abs().max()) / rms)
                row[net]['flipped'] = flipped
                row[net]['elements'] = sum(dr[k].numel() for k in keep)
                row[net]['flipped_grad_over_rms'] = largest
        look.append(row)
    return look


def train_numbers(prog, ref):
    """The numbers ``correct`` compares for a training cell, and the
    detail behind them.  ``prog`` and ``ref`` each hold 'epoch1' (the first
    epoch's stats), 'first_grads' {net: {leaf: gradient of the first
    step}}, 'init' {net: {leaf: tensor}} (the weights before the first
    step), 'steps' [{net: {leaf: tensor}}] (the weights after each of the
    first REF_STEPS steps) and 'first_fake' (the first batch G generated).
    For a configuration whose stated precision is below float32, ``ref``
    also holds 'stated': the first step's 'first_fake' and 'first_grads'
    computed in that precision.

    * loss_gap: the larger gap of the first epoch's critic and generator
      losses, over the critic loss;
    * fake_gap: the relative L2 gap of the first fake batch (a batch of
      another shape: infinite); fake_ratio: fake_gap over the stated
      precision's own gap from float32 on the same weights;
    * grad_gap: the median D leaf's gap between the norms of the first
      gradients, over the larger of the reference leaf's norm and the
      median leaf's;
    * grad_ratio: the relative L2 gap of D's first gradient over the
      stated precision's own;
    * change_gap: the median leaf's gap, so measured, between the norms of
      the change over the first three steps.

    A leaf whose reference first gradient is under a thousandth of its
    net's median leaf's moves by round-off alone under Adam and is left
    out.  The cell's ``limits`` say which of the numbers are compared."""
    p1, r1 = prog['epoch1'], ref['epoch1']
    out = {'loss_gap': max(abs(float(p1[i]) - float(r1[i])) for i in (2, 3))
           / abs(float(r1[2]))}
    detail = {'stats': {'program': [float(v) for v in p1],
                        'reference': [float(v) for v in r1]}}
    stated = ref.get('stated')
    pf, rf = prog['first_fake'], ref['first_fake']
    if pf is None or pf.shape != rf.shape:
        out['fake_gap'] = math.inf
        if stated:
            out['fake_ratio'] = math.inf
    else:
        out['fake_gap'] = float((pf - rf).norm() / rf.norm())
        if stated:
            sf = stated['first_fake']
            out['fake_ratio'] = out['fake_gap'] / float((sf - rf).norm()
                                                        / rf.norm())
        dims = tuple(range(1, pf.dim()))
        detail['fake_image_gaps'] = sorted(
            (torch.linalg.vector_norm(pf - rf, dim=dims)
             / torch.linalg.vector_norm(rf, dim=dims)).tolist())
    grads, changes, keeps = {}, {}, {}
    for net in ('d', 'g'):
        rg = ref['first_grads'][net]
        size = {k: float(v.norm()) for k, v in rg.items()}
        med = statistics.median(size.values())
        keep = keeps[net] = [k for k in rg if size[k] >= 1e-3 * med]
        pg = prog['first_grads'].get(net, {})
        if len(prog['steps']) < REF_STEPS or any(k not in pg for k in keep):
            out.update(grad_gap=math.inf, change_gap=math.inf)
            if stated:
                out['grad_ratio'] = math.inf
            return out, detail
        gaps, _ = _leaf_gaps(pg, rg, keep)
        detail[f'{net}_grad_rel_l2'] = _rel_l2(pg, rg, keep)
        grads.update({f'{net}.{k}': v for k, v in gaps.items()})
        last_p, last_r = prog['steps'][-1][net], ref['steps'][-1][net]
        dp = {k: last_p[k] - prog['init'][net][k] for k in keep}
        dr = {k: last_r[k] - ref['init'][net][k] for k in keep}
        gaps, _ = _leaf_gaps(dp, dr, keep)
        changes.update({f'{net}.{k}': v for k, v in gaps.items()})
    out['grad_gap'] = statistics.median(v for k, v in grads.items()
                                        if k.startswith('d.'))
    if stated:
        detail['stated_d_grad_rel_l2'] = _rel_l2(
            stated['first_grads']['d'], ref['first_grads']['d'], keeps['d'])
        out['grad_ratio'] = (detail['d_grad_rel_l2']
                             / detail['stated_d_grad_rel_l2'])
        for net in ('d', 'g'):
            detail[f'{net}_grad_vs_stated'] = _rel_l2(
                prog['first_grads'][net], stated['first_grads'][net],
                keeps[net])
    out['change_gap'] = statistics.median(changes.values())
    detail['worst_grad'] = _worst(grads)
    detail['worst_change'] = _worst(changes)
    detail['steps'] = _step_look(prog, ref, keeps)
    return out, detail


def reference_run(cfg, traffic, seed, g_w, d_w, stack, device,
                  precision='float32'):
    """The reference's first steps from the benchmark's weights, stack and
    draws: the same record as the program's StepProbe."""
    arch = cfg['arch']
    n_batches = -(-traffic['n_images'] // cfg['training']['batch_size'])
    n = max(REF_STEPS, n_batches)
    steps = arch.reference_steps(cfg, traffic, train_seed(seed), device, n)
    tr = arch.Trainer(g_w, d_w, cfg, traffic, precision)
    init = {'g': {k: v.clone() for k, v in tr.g.items()},
            'd': {k: v.clone() for k, v in tr.d.items()}}
    total, after = 0.0, []
    with ref_precision(precision == 'tf32'):
        for i, (rows, d) in enumerate(steps):
            epoch = 1 + i // n_batches
            stats = tr.step(stack[rows], d, epoch)
            if epoch == 1:
                total = total + stats * rows.shape[0]
            if i < REF_STEPS:
                after.append({'g': {k: v.clone() for k, v in tr.g.items()},
                              'd': {k: v.clone() for k, v in tr.d.items()}})
    out = {'epoch1': (total / traffic['n_images']).cpu(),
           'first_grads': tr.first_grads, 'init': init, 'steps': after,
           'first_fake': tr.first_fake}
    stated = cfg.get('stated_precision', 'float32')
    if precision == 'float32' and stated != 'float32':
        # the first step in the configuration's own precision: how far
        # that precision alone lies from float32 on this seed's weights
        # and draws
        st = arch.Trainer(g_w, d_w, cfg, traffic, stated)
        rows, d = steps[0]
        with ref_precision():
            st.step(stack[rows], d, 1)
        out['stated'] = {'first_fake': st.first_fake,
                         'first_grads': st.first_grads}
    return out


class ref_precision:
    """TF32 off for the reference's products, whatever the program left
    set; on (``tf32``) for the TF32 control."""

    def __init__(self, tf32=False):
        self.tf32 = tf32

    def __enter__(self):
        self.old = (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.old


# --------------------------------------------------------------------------
# Training cells
# --------------------------------------------------------------------------

class StepProbe:
    """Hooks on the program's train state over its first steps: the first
    batch G generates (the critic's fakes of the first step), the first
    gradient of each net as its optimizer got it, worked out from Adam's
    first moment after one step (exp_avg = (1 - beta1) g), and every
    weight after each of the first REF_STEPS steps."""

    def __init__(self, state, beta1):
        self.named = {'d': dict(state.d.named_parameters()),
                      'g': dict(state.g.named_parameters())}
        self.beta1 = beta1
        self.calls = {'d': 0, 'g': 0}
        self.first_grads, self.steps, self.first_fake = {}, [], None
        self.handles = [
            state.d_opt.register_step_post_hook(self._hook('d')),
            state.g_opt.register_step_post_hook(self._hook('g')),
            state.g.register_forward_hook(self._fake)]

    def _fake(self, module, args, output):
        if self.first_fake is None:
            self.first_fake = output.detach().float().clone()

    def _hook(self, net):
        def hook(opt, args, kwargs):
            self.calls[net] += 1
            if self.calls[net] == 1:
                self.first_grads[net] = {
                    k: opt.state[p]['exp_avg'].detach() / (1.0 - self.beta1)
                    for k, p in self.named[net].items() if p in opt.state}
            if net == 'g' and self.calls['g'] <= REF_STEPS:
                self.steps.append({n: {k: p.detach().clone()
                                       for k, p in ps.items()}
                                   for n, ps in self.named.items()})
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()


@dataclasses.dataclass
class Reading:
    """What a per-layer reader sees of a traced run."""
    kind: str                  # 'train' or 'sample'
    trace: tracing.Trace
    units: int                 # steps (train) or images (sample) traced
    rate: float                # the window's steps/s or images/s
    flops_per_unit: float      # model FLOPs of a step or an image
    peak_flops: float          # the configuration's MFU peak
    peaks: dict                # the card's peaks (peaks.json), or None
    sites: dict                # kernel launch sites of one step
    itemsize: int              # the kernels' working type's bytes
    # the architecture's own kernels beside K1-K4 (its KERNELS)
    kernels: dict = dataclasses.field(default_factory=dict)


def _peaks(device):
    table = json.loads((Path(__file__).parent / 'peaks.json').read_text())
    if torch.device(device).type != 'cuda':
        return None
    return table.get(torch.cuda.get_device_name(device))


def _itemsize(cfg):
    return 4 if cfg['execution']['compute_dtype'] == 'float32' else 2


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def train_setup(cfg, traffic, seed, device, patch=None, marks=None):
    """The program's train state and epoch runner from the seed, driven
    through its first chunk (the warm-up, whose first steps the probe
    records).  ``patch`` (tests, calibration) may wrap the runner's
    construction to plant a fault.  Returns a dict of it all; ``marks``
    gets the clock at the end of each part of the set-up."""
    marks = {} if marks is None else marks
    from neuron_gan_tpu_torch.train_step import make_epoch_runner
    arch = cfg['arch']
    g_w, d_w, stack = arch.train_inputs(cfg, traffic, seed, device)
    _sync(device)
    marks['inputs'] = time.perf_counter()
    pg, g, d = arch.port_nets(cfg, g_w, d_w, device)
    _sync(device)
    marks['nets'] = time.perf_counter()
    spec, state, beta1 = arch.port_train(cfg, traffic, g, d)
    marks['optimizers'] = time.perf_counter()
    rng = torch.Generator(device=device).manual_seed(train_seed(seed))
    make = make_epoch_runner if patch is None else patch(make_epoch_runner)
    run = make(pg, spec, traffic['epochs_per_chunk'])
    probe = StepProbe(state, beta1)
    _sync(device)
    marks['runner'] = time.perf_counter()
    stats = run(state, stack, rng, 1).cpu()
    marks['warm_up'] = time.perf_counter()
    probe.remove()
    record = {'epoch1': stats[0], 'first_grads': probe.first_grads,
              'init': {'g': g_w, 'd': d_w}, 'steps': probe.steps,
              'first_fake': probe.first_fake}
    batches = -(-spec.n_images // spec.batch_size)
    return {'pg': pg, 'state': state, 'run': run, 'stack': stack, 'rng': rng,
            'g_w': g_w, 'd_w': d_w, 'record': record,
            'finite': bool(torch.isfinite(stats).all()),
            'steps_per_chunk': traffic['epochs_per_chunk'] * batches}


def run_train(cell, cfg, seed, seconds, trace, device, t0, patch=None):
    traffic = cell['traffic']
    marks = {}
    s = train_setup(cfg, traffic, seed, device, patch, marks)
    run, state, stack, rng = s['run'], s['state'], s['stack'], s['rng']
    per_chunk, epochs = s['steps_per_chunk'], traffic['epochs_per_chunk']
    epoch = 1 + epochs
    setup_s = marks['warm_up'] - t0
    done = failed = 0
    chunks, cpus = [], []
    start, cpu_start = time.perf_counter(), time.process_time()
    while True:
        stats = run(state, stack, rng, epoch).cpu()
        chunks.append(time.perf_counter())
        cpus.append(time.process_time())
        epoch += epochs
        done += per_chunk
        if not torch.isfinite(stats).all():
            failed += per_chunk
        if time.perf_counter() - start >= seconds:
            break
    window_s = time.perf_counter() - start
    rate = done / window_s
    out = {'attempted': done, 'failed': failed + (0 if s['finite'] else per_chunk),
           'window_s': window_s, 'setup_s': setup_s,
           'e2e': {'train_steps_per_s': rate, 'setup_s': setup_s},
           'memory_peak_bytes': _peak_memory(device), 'marks': marks,
           'chunk_s': [b - a for a, b in zip([start] + chunks, chunks)],
           # the process's CPU time (all threads) of each chunk
           'chunk_cpu_s': [b - a for a, b in zip([cpu_start] + cpus, cpus)]}
    out['forbidden'] = forbidden_modules()
    if trace:
        arch = cfg['arch']
        _, tr = tracing.capture(
            lambda: run(state, stack, rng, epoch).cpu(), arch.KERNELS)
        out['reading'] = Reading(
            'train', tr, per_chunk, rate,
            arch.train_step_flops(cfg, traffic),
            cfg['mfu_peak']['flops_per_s'], _peaks(device),
            arch.kernel_sites(cfg, traffic), _itemsize(cfg),
            arch.KERNELS)
    record, g_w, d_w = s['record'], s['g_w'], s['d_w']
    del s, run, state, rng
    _free(device)
    ref = reference_run(cfg, traffic, seed, g_w, d_w, stack, device)
    out['numbers'], out['detail'] = train_numbers(record, ref)
    return out


# --------------------------------------------------------------------------
# Sampling cells
# --------------------------------------------------------------------------

def latent_pool(cfg, traffic, gen):
    b = traffic['batch']
    z = cfg['arch'].latent(gen, LATENT_POOL * b, cfg)
    return z.view(LATENT_POOL, b, -1)


def run_sample(cell, cfg, seed, seconds, trace, device, t0, patch=None):
    """A closed loop of one client: batches of latents through the port's
    G at the cell's phase, each copied to the host as the eval CLI does
    before writing its grid."""
    from neuron_gan_tpu_torch.models import precision_scope
    traffic, arch = cell['traffic'], cfg['arch']
    gen = torch.Generator(device=device).manual_seed(seed)
    g_w, _ = arch.make_weights(cfg, gen)
    pool = latent_pool(cfg, traffic, gen)
    _sync(device)
    marks = {'inputs': time.perf_counter()}
    pg, g, _ = arch.port_nets(cfg, g_w, None, device)
    if patch is not None:
        g = patch(g)
    phase = traffic['phase']
    _sync(device)
    marks['nets'] = time.perf_counter()

    def call(z):
        with torch.no_grad(), precision_scope(pg.precision):
            images = g(z, phase)
        return images.float().permute(0, 2, 3, 1).cpu().numpy()

    for i in range(2):
        call(pool[i])
    marks['warm_up'] = time.perf_counter()
    setup_s = marks['warm_up'] - t0
    keep, k = [], traffic['check_batches']
    pick = random.Random(seed)
    done = failed = 0
    start = time.perf_counter()
    while True:
        images = call(pool[done % LATENT_POOL])
        if not np.isfinite(images).all():
            failed += 1
        # a uniform sample of k batches of the window (reservoir)
        if len(keep) < k:
            keep.append((done, images))
        else:
            j = pick.randrange(done + 1)
            if j < k:
                keep[j] = (done, images)
        done += 1
        if time.perf_counter() - start >= seconds:
            break
    window_s = time.perf_counter() - start
    b = traffic['batch']
    rate = done * b / window_s
    out = {'attempted': done, 'failed': failed, 'window_s': window_s,
           'setup_s': setup_s,
           'e2e': {'gen_images_per_s': rate, 'setup_s': setup_s},
           'memory_peak_bytes': _peak_memory(device), 'marks': marks}
    out['forbidden'] = forbidden_modules()
    if trace:
        n = traffic['traced_batches']
        _, tr = tracing.capture(
            lambda: [call(pool[i % LATENT_POOL]) for i in range(n)],
            arch.KERNELS)
        out['reading'] = Reading(
            'sample', tr, n * b, rate, arch.g_forward_flops(cfg, phase, 1),
            cfg['mfu_peak']['flops_per_s'], _peaks(device), {},
            _itemsize(cfg), arch.KERNELS)
    del g
    _free(device)
    out['numbers'] = sample_numbers(keep, pool, g_w, cfg, phase)
    return out


def sample_numbers(keep, pool, g_w, cfg, phase):
    """The widest gap between a kept batch's images and the reference's."""
    worst = 0.0
    with torch.no_grad(), ref_precision():
        for i, images in keep:
            ref = cfg['arch'].generator(g_w, pool[i % LATENT_POOL], phase,
                                        cfg)
            ref = ref.permute(0, 2, 3, 1).cpu().numpy()
            gap = float(np.abs(images - ref).max())
            worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return {'image_gap': worst}


# --------------------------------------------------------------------------
# A whole run
# --------------------------------------------------------------------------

DRIVERS = {'train': run_train, 'sample': run_sample}


def _peak_memory(device):
    if torch.device(device).type == 'cuda':
        return torch.cuda.max_memory_allocated(device)
    return 0


def _free(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run_cell(name, seed, seconds, trace, device='cuda', t0=None,
             bench=None, patch=None):
    """One run of the cell ``name``: the result's dict (``result_line``
    prints it) and the checks."""
    bench = bench or Bench()
    t0 = time.perf_counter() if t0 is None else t0
    cell, cfg = bench.cell(name)
    out = DRIVERS[cell['traffic']['kind']](cell, cfg, seed, seconds, trace,
                                           device, t0, patch)
    limits = cell['limits']
    checks = {k: {'value': out['numbers'].get(k, math.inf), 'limit': v}
              for k, v in limits.items()}
    correct = (out['failed'] == 0
               and all(math.isfinite(c['value']) and c['value'] <= c['limit']
                       for c in checks.values()))
    section = 'per_layer' if trace else 'end_to_end'
    metrics = {}
    for m in bench.metrics_of(name, section):
        if trace:
            value = bench.reader(m['name'])(out['reading'])
        else:
            value = out['e2e'].get(m['name'])
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    dev = {'platform': 'gpu' if torch.device(device).type == 'cuda' else 'cpu',
           'kind': (torch.cuda.get_device_name(device)
                    if torch.device(device).type == 'cuda' else 'cpu'),
           'count': 1, 'memory_peak_bytes': out['memory_peak_bytes']}
    result = {'correct': correct, 'attempted': out['attempted'],
              'failed': out['failed'], 'metrics': metrics, 'device': dev}
    if trace:
        tr = out['reading'].trace
        dev['busy_s'], dev['window_s'] = tr.busy_s, tr.window_s
        result['breakdown'] = tr.breakdown()
    result['checks'] = checks
    return result, out
