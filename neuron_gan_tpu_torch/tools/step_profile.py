"""Stage-by-stage profile of the flagship training step (counterpart of the
JAX package's tools/step_profile.py).

    python -m neuron_gan_tpu_torch.tools.step_profile [--path shipping] \\
        [--phase 5] [--reps 20] [--device cpu]

Traces ``--reps`` steps (whole epochs, rounded up) of the real epoch runner
(``train_step.make_epoch_runner``) of a ``flagship.PATHS`` configuration
(default the shipping step) at ``--phase`` (default the top), after one
warm-up epoch, with ``profile_step.py``'s capture, and reads the stage
spans the step marks itself with (``step.*``, ``runtime/timing.py::span``)
from the trace.  Prints a header line, then one JSON line per span name,
in the order the step first opens them, each a step:

* ``host_ms``: the span's duration on the host;
* ``idle_ms``: the time the device was idle (no kernel, copy or fill)
  while the span was open;
* ``launches``: kernel launch calls made while the span was open, on any
  thread (a backward's come from the autograd engine's device thread);
* ``device_ms``: the device time of the kernels those launches started,
  matched by correlation id (the header's ``device_ms_per_step`` is that
  of every kernel of the window).

On the CPU the last three read "not measured".
"""

import argparse
import bisect
import json
import math

import numpy as np
import torch

LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
                'cuLaunchKernelEx', 'cudaLaunchCooperativeKernel',
                'cudaGraphLaunch', 'cuGraphLaunch')
NOT_MEASURED = 'not measured'


def parse_args(argv=None):
    from neuron_gan_tpu_torch.flagship import PATHS
    ap = argparse.ArgumentParser()
    ap.add_argument('--path', choices=sorted(PATHS), default='shipping')
    ap.add_argument('--phase', type=int, default=None)
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--device', type=str, default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    return ap.parse_args(argv)


def _union(intervals):
    """Sorted disjoint [start, end] lists covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def stage_totals(events):
    """({span name: [host ns, idle ns, launches, device ns]}, device ns of
    every kernel) over a trace's raw kineto events, the names in the order
    the spans first open.  Every device event is a kernel, a copy or a
    fill (torch 2.11's events carry no activity type: copies and fills
    are told by name); a kernel and its launch share a correlation id."""
    spans, busy, launches, kernels = [], [], [], []
    for e in events:
        name, s, d = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            busy.append((s, s + d))
            if not name.startswith(('Memcpy', 'Memset')):
                kernels.append((e.correlation_id(), d))
        elif name.startswith('step.'):
            spans.append((s, s + d, name))
        elif name.startswith(LAUNCH_CALLS):
            launches.append((s, e.correlation_id()))
    spans.sort()
    starts = [s for s, _, _ in spans]
    busy = _union(busy)
    ends = [e for _, e in busy]
    out = {}
    for s, e, name in spans:
        row = out.setdefault(name, [0, 0, 0, 0])
        covered = sum(min(b1, e) - max(b0, s)
                      for b0, b1 in busy[bisect.bisect_right(ends, s):]
                      if b0 < e)
        row[0] += e - s
        row[1] += e - s - covered

    def span_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and spans[i][1] >= t else None

    launched = {}
    for t, corr in launches:
        name = span_at(t)
        if name is not None:
            out[name][2] += 1
            launched[corr] = name
    for corr, d in kernels:
        if corr in launched:
            out[launched[corr]][3] += d
    return out, sum(d for _, d in kernels)


def run(args):
    """The header, then one dict a span name."""
    from neuron_gan_tpu_torch.flagship import PATHS
    from neuron_gan_tpu_torch.profile_step import SEED, _trace, warm_runner
    from neuron_gan_tpu_torch.runtime import resolve_device
    from neuron_gan_tpu_torch.runtime.timing import nvidia_smi_line

    device = resolve_device(args.device)
    cuda = device.type == 'cuda'
    make, chunk_spec = PATHS[args.path]
    cfg = make()
    phase = cfg.n_phases - 1 if args.phase is None else args.phase
    # the flagship's padded stack (512 + 2 * 128), as op_trace's
    images = torch.from_numpy(np.random.default_rng(SEED).random(
        (16, 768, 768, 1)).astype(np.float32)).to(device)
    epochs, steps = warm_runner(cfg, chunk_spec, images, phase)
    n_epochs = math.ceil(args.reps / steps)
    prof, wall_us = _trace(epochs(2, n_epochs), record_shapes=False,
                           cuda=cuda)
    n_steps = steps * n_epochs
    out = [{'path': args.path, 'phase': phase,
            'resolution': cfg.resolution(phase),
            'batch': chunk_spec(phase).batch_size, 'steps': n_steps,
            'wall_ms_per_step': wall_us / n_steps / 1e3,
            'device': torch.cuda.get_device_name(device) if cuda else 'cpu',
            'nvidia_smi': nvidia_smi_line() if cuda else None}]
    per_step = 1e6 * n_steps
    stages, kernel_ns = stage_totals(prof.profiler.kineto_results.events())
    if cuda:
        out[0]['device_ms_per_step'] = kernel_ns / per_step
    for name, (host, idle, n, dev) in stages.items():
        out.append({'span': name, 'host_ms': host / per_step,
                    'idle_ms': idle / per_step if cuda else NOT_MEASURED,
                    'launches': n / n_steps if cuda else NOT_MEASURED,
                    'device_ms': dev / per_step if cuda else NOT_MEASURED})
    return out


def main(argv=None):
    out = run(parse_args(argv))
    for line in out:
        print(json.dumps(line), flush=True)
    return out


if __name__ == '__main__':
    main()
