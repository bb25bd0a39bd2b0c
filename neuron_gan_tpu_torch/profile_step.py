"""Where a steady 512^2 training step of the port spends its time, on the GPU.

    python3 -m neuron_gan_tpu_torch.profile_step

Runs the flagship trainer (``flagship.py``, kernels on) at steady 512^2
from random weights (seed 0) and a synthetic (16, 768, 768, 1) stack, and
after one warm-up epoch traces two epochs of 2 steps each with
torch.profiler.  Prints one JSON line: device time per step, the device's
idle share of the traced wall time, device time by kind (convolution, the
LeakyReLU+PixelNorm kernels, the rest), the top kernels by device time and
the card's nvidia-smi name and power limit.

Needs a CUDA card; exits 2 without one.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from neuron_gan_tpu_torch.flagship import flagship_chunk_spec, flagship_config
from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
from neuron_gan_tpu_torch.train_step import init_train_state, make_epoch_runner

SEED = 0


def _kind(name):
    low = name.lower()
    if 'lrelu_pn' in low:
        return 'lrelu_pixel_norm'
    if any(k in low for k in ('conv', 'cudnn', 'xmma', 'implicit', 'winograd',
                              'fft', 'dgrad', 'wgrad', 'fprop')):
        return 'convolution'
    return 'other'


def _device_us(evt):
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    return 0.0


def main():
    if not torch.cuda.is_available():
        print('profile_step: no CUDA device', file=sys.stderr)
        return 2

    images = torch.from_numpy(np.random.default_rng(SEED).random(
        (16, 768, 768, 1)).astype(np.float32)).to('cuda')
    cfg = flagship_config()
    init = torch.Generator().manual_seed(SEED)
    state = init_train_state(GeneratorPG(cfg, init, device='cuda'),
                             DiscriminatorPG(cfg, init, device='cuda'))
    spec = flagship_chunk_spec(cfg.n_phases - 1)
    rng = torch.Generator(device='cuda').manual_seed(SEED)
    one_epoch = make_epoch_runner(cfg, spec, 1)
    one_epoch(state, images, rng, 1)                # warm-up epoch
    torch.cuda.synchronize()

    steps = 2 * spec.n_images // spec.batch_size
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        one_epoch(state, images, rng, 2)
        one_epoch(state, images, rng, 3)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kind, top = {}, []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_kind[_kind(evt.key)] = by_kind.get(_kind(evt.key), 0.0) + us
        top.append((us, evt.key, evt.count))
    busy_us = sum(by_kind.values())
    top.sort(reverse=True)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({
        'phase': 'profile', 'nvidia_smi': smi,
        'resolution': cfg.resolution(spec.phase), 'steps': steps,
        'wall_ms_per_step': wall_us / steps / 1e3,
        'device_ms_per_step': busy_us / steps / 1e3 if busy_us else None,
        'device_idle_share': 1 - busy_us / wall_us if busy_us else None,
        'device_ms_per_step_by_kind': {k: v / steps / 1e3
                                       for k, v in by_kind.items()},
        'top_kernels': [{'name': n[:120], 'ms_per_step': us / steps / 1e3,
                         'calls_per_step': c / steps}
                        for us, n, c in top[:15]],
    }), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
