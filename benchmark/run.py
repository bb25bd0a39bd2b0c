"""Run one cell of the benchmark of neuron_gan_tpu_torch on this machine's
card and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (BENCHMARK.json), read from a torch.profiler trace of a
part after the measured window.  Inputs and weights come from ``--seed``.
Every run compares what its timed path produced with the plain reference
of its configuration's architecture (benchmark/architectures/<name>.py)
and prints each number compared beside its limit, as the last lines of
standard error and under the result's last key, ``checks``.  Exits non-zero with no result when there is no CUDA card, too
few of them, or when JAX or the JAX package is loaded once the window has
closed.  Kernel and compiler caches stay under build/ in the checkout.
"""

import os
import sys
import time
from pathlib import Path


def _process_age():
    """Seconds since this process started (Linux), else 0."""
    try:
        with open('/proc/self/stat') as f:
            start_ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _process_age()
REPO = Path(__file__).resolve().parents[1]
# the repository's root, not this directory, so that 'benchmark' is a
# package and its module names shadow nothing of the standard library
sys.path[0] = str(REPO)
for var, sub in (('CUDA_CACHE_PATH', 'nv'), ('TRITON_CACHE_DIR', 'triton'),
                 ('TORCHINDUCTOR_CACHE_DIR', 'inductor')):
    os.environ.setdefault(var, str(REPO / 'build' / 'bench_cache' / sub))

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402


def nvidia_smi_line():
    """The first card's name and power limit, as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    import torch
    marks = {'torch_import': time.perf_counter()}
    from benchmark.harness import Bench, forbidden_modules, run_cell
    bench = Bench(REPO)
    chips = {w['name']: w['chips'] for w in bench.spec()['workloads']}
    if args.workload not in chips:
        print(f'run.py: no workload {args.workload!r} in BENCHMARK.json',
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('run.py: no CUDA device', file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips[args.workload]:
        print(f'run.py: {args.workload} needs {chips[args.workload]} cards, '
              f'this machine has {torch.cuda.device_count()}',
              file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    torch.zeros(1, device=device)
    marks['cuda_context'] = time.perf_counter()
    import neuron_gan_tpu_torch.train_step  # noqa: F401
    from neuron_gan_tpu_torch.runtime import kernels
    marks['port_import'] = time.perf_counter()
    for name in kernels.kernel_names():
        kernels.load(name)
    marks['kernel_load'] = time.perf_counter()
    result, out = run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device, T0, bench)
    marks.update(out['marks'])
    smi = nvidia_smi_line()
    print(f'run.py: {smi}', file=sys.stderr)
    parts, last = {}, T0
    for name, t in sorted(marks.items(), key=lambda kv: kv[1]):
        parts[name], last = t - last, t
    loaded = sorted(set(out['forbidden']) | set(forbidden_modules()))
    if loaded:
        print(f'run.py: JAX or the JAX package is loaded: {loaded}',
              file=sys.stderr)
        return 3
    result = {'nvidia_smi': smi, 'window_s': out['window_s'],
              'setup_parts_s': parts, **result}
    for key in ('chunk_s', 'chunk_cpu_s'):
        if key in out:
            result[key] = out[key]
    if args.trace:
        r = out['reading']
        result['traced'] = {'units': r.units, 'kernels': r.trace.kernels,
                            'launch_calls': r.trace.launch_calls}
    result['checks'] = result.pop('checks')
    for name, c in result['checks'].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
