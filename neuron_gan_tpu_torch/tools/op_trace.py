"""Op-level time breakdown of the flagship trainer's steps (counterpart of
the JAX package's tools/op_trace.py, with tools/hlo_inspect.py folded in:
PyTorch has no HLO, so the layout ops it listed are the trace's layout
kernels here).

    python -m neuron_gan_tpu_torch.tools.op_trace [--path shipping] \\
        [--phase 5] [--epochs 2] [--top 25] [--device cpu]

Traces ``--epochs`` epochs of one path of ``flagship.PATHS`` (default the
shipping step) at ``--phase`` (default the top) after one warm-up epoch,
with ``profile_step.py``'s capture, and prints one JSON line, per step:

* the time by category: cuDNN convolutions, K1-K4, GEMMs, elementwise
  kernels, reductions, copies and layout conversions, fills, other (they
  sum to the total);
* the top ``--top`` kernels;
* the layout work: the NCHW<->NHWC conversion, copy and transpose kernels
  by name, and the ATen copies (``copy_``: contiguous, clone, casts) by
  shapes and dtypes with the bytes each moves and its kernels' time.

On the GPU the times are device self times of the kernels; with
``--device cpu`` they are the CPU self times of the ATen ops (never a
device time).
"""

import argparse
import collections
import json
import math

import numpy as np
import torch

CATEGORIES = ('conv', 'k1', 'k2', 'k3', 'k4', 'gemm', 'elementwise',
              'reduction', 'layout', 'fill', 'other')
_KERNELS = (('k1', ('lrelu_pn_fwd',)), ('k2', ('lrelu_pn_bwd',)),
            ('k3', ('packed_conv_fwd', 'split_weights')), ('k4', ('packed_dz',)))
_LAYOUT = ('nchwtonhwc', 'nhwctonchw', 'transpose', 'copy', 'contiguous',
           'clone', 'permute', 'catarraybatched', 'aten::cat')
_CONV = ('conv', 'fprop', 'dgrad', 'wgrad', 'implicit', 'winograd', 'fft',
         'cudnn')
_GEMM = ('gemm', 'gemv', 'aten::mm', 'aten::bmm', 'aten::addmm',
         'aten::matmul', 'aten::linear')
_FILL = ('fill', 'zero')
_REDUCTION = ('reduce', 'aten::sum', 'aten::mean', 'aten::norm', 'aten::max',
              'aten::amax', 'aten::min', 'norm_kernel')
_ELEMENTWISE = ('elementwise', 'vectorized', 'unrolled', 'aten::add',
                'aten::sub', 'aten::mul', 'aten::div', 'aten::where',
                'aten::leaky_relu', 'aten::rsqrt', 'aten::sqrt', 'aten::pow',
                'aten::lerp', 'aten::addcmul', 'aten::addcdiv', 'aten::clamp',
                'aten::neg', 'aten::exp', 'aten::abs', 'aten::ge',
                'aten::lt', 'aten::gt', 'aten::le', 'aten::eq', 'aten::round')


def category(name):
    """The category of a kernel (GPU) or ATen op (CPU) name."""
    low = name.lower()
    for cat, keys in _KERNELS:
        if any(k in low for k in keys):
            return cat
    for cat, keys in (('layout', _LAYOUT), ('conv', _CONV), ('gemm', _GEMM),
                      ('fill', _FILL), ('reduction', _REDUCTION),
                      ('elementwise', _ELEMENTWISE)):
        if any(k in low for k in keys):
            return cat
    return 'other'


def _self_us(evt, cuda):
    from neuron_gan_tpu_torch.profile_step import _device_us
    return _device_us(evt) if cuda else evt.self_cpu_time_total


def _numel(shape):
    return math.prod(shape) if shape else 1


_ITEMSIZE = {'float': 4, 'c10::BFloat16': 2, 'c10::Half': 2, 'double': 8,
             'long int': 8, 'int': 4, 'bool': 1, 'unsigned char': 1}


def _copies(prof, cuda):
    """{(shapes, dtypes): [calls, us, bytes a call]} of the ATen copies
    (``copy_``: contiguous, clone, casts) in the trace, from its Chrome
    export, which records every op's input shapes and types: bytes = the
    destination written and the source read once; us = the kernels each
    copy launched (their 'External id' is the copy's), or on the CPU the
    copy's own time."""
    import os
    import tempfile
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)['traceEvents']
    finally:
        os.remove(path)
    kernel_us = collections.Counter()
    for e in events:
        if e.get('cat') == 'kernel':
            kernel_us[e.get('args', {}).get('External id')] += e.get('dur', 0)
    copies = collections.defaultdict(lambda: [0, 0.0, 0])
    for e in events:
        args = e.get('args', {})
        if e.get('name') != 'aten::copy_' or 'Input Dims' not in args:
            continue
        shapes = tuple(tuple(d) for d in args['Input Dims'][:2])
        dtypes = tuple(args.get('Input type', [])[:2])
        row = copies[shapes, dtypes]
        row[0] += 1
        row[1] += kernel_us[args.get('External id')] if cuda else e.get('dur', 0)
        row[2] = sum(_numel(d) * _ITEMSIZE.get(t, 4) for d, t in zip(shapes, dtypes))
    return copies


def summarize(prof, n_steps, top=25, cuda=True):
    """Per-step times by category, the top kernels (ops on the CPU) and the
    layout work from a torch.profiler trace of ``n_steps`` steps."""
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    rows = [(e.key, _self_us(e, cuda), e.count) for e in prof.key_averages()
            if e.device_type == kind and _self_us(e, cuda) > 0]
    by_cat = collections.Counter()
    calls = collections.Counter()
    for name, us, count in rows:
        by_cat[category(name)] += us
        calls[category(name)] += count
    total = sum(us for _, us, _ in rows)
    rows.sort(key=lambda r: -r[1])
    copies = _copies(prof, cuda)
    per_step = 1e3 * n_steps
    return {
        'time': 'device self time' if cuda else 'CPU self time of ATen ops',
        'steps': n_steps,
        'total_ms_per_step': total / per_step,
        'by_category_ms_per_step': {c: by_cat[c] / per_step
                                    for c in CATEGORIES if by_cat[c]},
        'calls_per_step_by_category': {c: calls[c] / n_steps
                                       for c in CATEGORIES if calls[c]},
        'top': [{'name': n[:160], 'category': category(n),
                 'ms_per_step': us / per_step, 'calls_per_step': c / n_steps}
                for n, us, c in rows[:top]],
        'layout_kernels': [{'name': n[:160], 'ms_per_step': us / per_step,
                            'calls_per_step': c / n_steps}
                           for n, us, c in rows if category(n) == 'layout'],
        'copies': sorted(({'shapes': [list(s) for s in shapes],
                           'dtypes': list(dtypes), 'bytes': nbytes,
                           'calls_per_step': n / n_steps,
                           'ms_per_step': us / per_step,
                           'bytes_per_step': nbytes * n / n_steps}
                          for (shapes, dtypes), (n, us, nbytes)
                          in copies.items()),
                         key=lambda r: -r['bytes_per_step']),
    }


def parse_args(argv=None):
    from neuron_gan_tpu_torch.flagship import PATHS
    ap = argparse.ArgumentParser()
    ap.add_argument('--path', choices=sorted(PATHS), default='shipping')
    ap.add_argument('--phase', type=int, default=None)
    ap.add_argument('--epochs', type=int, default=2)
    ap.add_argument('--top', type=int, default=25)
    ap.add_argument('--device', type=str, default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    return ap.parse_args(argv)


def run(args):
    from neuron_gan_tpu_torch.flagship import PATHS
    from neuron_gan_tpu_torch.profile_step import SEED, _trace, warm_runner
    from neuron_gan_tpu_torch.runtime import resolve_device
    from neuron_gan_tpu_torch.runtime.timing import nvidia_smi_line

    device = resolve_device(args.device)
    cuda = device.type == 'cuda'
    make, chunk_spec = PATHS[args.path]
    cfg = make()
    phase = cfg.n_phases - 1 if args.phase is None else args.phase
    # the flagship's padded stack (512 + 2 * 128), as profile_step's
    images = torch.from_numpy(np.random.default_rng(SEED).random(
        (16, 768, 768, 1)).astype(np.float32)).to(device)
    epochs, steps = warm_runner(cfg, chunk_spec, images, phase)
    prof, wall_us = _trace(epochs(2, args.epochs), record_shapes=True,
                           cuda=cuda)
    n_steps = steps * args.epochs
    return {'path': args.path, 'phase': phase,
            'resolution': cfg.resolution(phase), 'epochs': args.epochs,
            'wall_ms_per_step': wall_us / n_steps / 1e3,
            'device': torch.cuda.get_device_name(device) if cuda else 'cpu',
            'nvidia_smi': nvidia_smi_line() if cuda else None,
            **summarize(prof, n_steps, args.top, cuda)}


def main(argv=None):
    result = run(parse_args(argv))
    print(json.dumps(result), flush=True)
    return result


if __name__ == '__main__':
    main()
