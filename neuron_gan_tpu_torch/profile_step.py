"""Where a steady 512^2 training step of the port spends its time, on the GPU.

    python3 -m neuron_gan_tpu_torch.profile_step

Runs the flagship trainer (``flagship.py``) at steady 512^2 from random
weights (seed 0) and a synthetic (16, 768, 768, 1) stack, once for each of
its four paths (unpacked, the 2x2 packed layout, 'mixed' on the packed
layout, and the shipping step: 'mixed' with the 2x4 layout and the
fast/shear augmentation; kernels on in all), the packed and mixed ones again
with the kernels off (``use_kernels=False``), which gives the kernel
path's gain over the plain path, and the mixed one with its level
boundaries decomposed (``fuse_up2_conv=fuse_pool_conv=False``), which
gives the fused boundaries' gain.  After one warm-up epoch it traces two
epochs of 2 steps each with torch.profiler, then two more with input
shapes recorded.  Prints one JSON line per configuration: from the first
window, wall and device time per step, the device's idle share of the
wall time, the kernels launched per step (what a host-bound step pays
for) and among them the fill kernels (zeros and ones tensors), device time
and launches by kind (cuDNN/ATen convolution, the LeakyReLU+PixelNorm
kernels K1 and K2, the fused packed conv kernels K3 -- its weight split
included -- and K4, the rest), K1 and K2 also by the group width of their
template instance (on the shipping path width 16 is its 8-group launches,
the 2x4 blocks' epilogues) and the top kernels by device time; from the
second, the top ATen ops by the device time of the kernels they launch,
with their input shapes; and the card's nvidia-smi name and power limit.

Needs a CUDA card; exits 2 without one.
"""

import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from neuron_gan_tpu_torch.flagship import PATHS
from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
from neuron_gan_tpu_torch.train_step import init_train_state, make_epoch_runner

SEED = 0


def _kind(name):
    low = name.lower()
    if 'packed_conv_fwd' in low or 'split_weights' in low:
        return 'k3_packed_conv_fwd'
    if 'packed_dz' in low:
        return 'k4_packed_dz'
    if 'lrelu_pn_fwd' in low:
        return 'k1_lrelu_pn_fwd'
    if 'lrelu_pn_bwd' in low:
        return 'k2_lrelu_pn_bwd'
    if any(k in low for k in ('conv', 'cudnn', 'xmma', 'implicit', 'winograd',
                              'fft', 'dgrad', 'wgrad', 'fprop', 'cutlass',
                              'nchwtonhwc', 'nhwctonchw')):
        return 'convolution'
    return 'other'


def _k12_width(name):
    """'fwd/16' for K1's instance of group width 16 ('bwd/...' for K2,
    '/0' the runtime-width instance), or None for another kernel."""
    m = re.search(r'lrelu_pn_(fwd|bwd)_kernel<[^,>]+,\s*(\d+)', name)
    return f'{m.group(1)}/{m.group(2)}' if m else None


def _device_us(evt):
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    return 0.0


def _trace(run_epochs, record_shapes):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts,
                                record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        run_epochs()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us


def profile(name, cfg, chunk_spec, images, smi):
    init = torch.Generator().manual_seed(SEED)
    state = init_train_state(GeneratorPG(cfg, init, device='cuda'),
                             DiscriminatorPG(cfg, init, device='cuda'))
    spec = chunk_spec(cfg.n_phases - 1)
    rng = torch.Generator(device='cuda').manual_seed(SEED)
    one_epoch = make_epoch_runner(cfg, spec, 1)
    one_epoch(state, images, rng, 1)                # warm-up epoch
    torch.cuda.synchronize()

    def epochs(first):
        return lambda: [one_epoch(state, images, rng, e)
                        for e in (first, first + 1)]

    steps = 2 * spec.n_images // spec.batch_size
    prof, wall_us = _trace(epochs(2), record_shapes=False)
    by_kind, n_by_kind, top, launches, fills = {}, {}, [], 0, 0
    k12 = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = _kind(evt.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + us
        n_by_kind[kind] = n_by_kind.get(kind, 0) + evt.count
        width = _k12_width(evt.key)
        if width:
            ms, n = k12.get(width, (0.0, 0))
            k12[width] = (ms + us / steps / 1e3, n + evt.count / steps)
        top.append((us, evt.key, evt.count))
        launches += evt.count
        if 'fill' in evt.key.lower():
            fills += evt.count
    busy_us = sum(by_kind.values())
    top.sort(reverse=True)
    # a second window with input shapes recorded (which costs host time,
    # so the first window alone gives wall time and idle share): each
    # kernel's time on the op that launched it (self time, no double count
    # through the op's parents), by op and input shapes
    prof, _ = _trace(epochs(4), record_shapes=True)
    ops = sorted(((_device_us(e), e.key, str(e.input_shapes), e.count)
                  for e in prof.key_averages(group_by_input_shape=True)
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and _device_us(e) > 0), reverse=True)
    return {
        'phase': 'profile', 'config': name, 'nvidia_smi': smi,
        'resolution': cfg.resolution(spec.phase), 'steps': steps,
        'wall_ms_per_step': wall_us / steps / 1e3,
        'device_ms_per_step': busy_us / steps / 1e3 if busy_us else None,
        'device_idle_share': 1 - busy_us / wall_us if busy_us else None,
        'kernels_per_step': launches / steps,
        'fill_kernels_per_step': fills / steps,
        'device_ms_per_step_by_kind': {k: v / steps / 1e3
                                       for k, v in by_kind.items()},
        'kernels_per_step_by_kind': {k: v / steps
                                     for k, v in n_by_kind.items()},
        'k12_by_group_width': {k: {'ms_per_step': ms, 'calls_per_step': n}
                               for k, (ms, n) in sorted(k12.items())},
        'top_kernels': [{'name': n[:120], 'ms_per_step': us / steps / 1e3,
                         'calls_per_step': c / steps}
                        for us, n, c in top[:15]],
        'top_ops': [{'op': n, 'input_shapes': shapes[:200],
                     'ms_per_step': us / steps / 1e3,
                     'calls_per_step': c / steps}
                    for us, n, shapes, c in ops[:15]],
    }


def main():
    if not torch.cuda.is_available():
        print('profile_step: no CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    images = torch.from_numpy(np.random.default_rng(SEED).random(
        (16, 768, 768, 1)).astype(np.float32)).to('cuda')
    runs = []
    for name, (make, chunk_spec) in PATHS.items():
        cfg = make()
        runs.append((name, cfg, chunk_spec))
        if name in ('packed', 'mixed'):
            runs.append((f'{name}_plain',
                         dataclasses.replace(cfg, use_kernels=False),
                         chunk_spec))
        if name == 'mixed':
            runs.append(('mixed_decomposed',
                         dataclasses.replace(cfg, fuse_up2_conv=False,
                                             fuse_pool_conv=False),
                         chunk_spec))
    for name, cfg, chunk_spec in runs:
        print(json.dumps(profile(name, cfg, chunk_spec, images, smi)),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
