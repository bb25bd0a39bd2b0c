"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds ...] [--fault-seeds ...] [--out FILE]

For each seed of ``--seeds``, the numbers ``correct`` compares for a sound
run of the program: a training cell's set-up and first chunk (no measured
window: the comparison covers its first steps), a sampling cell's run
with a one-second window.  For each of ``--control-seeds``, the same
numbers with the reference computed in the configuration's
``control_precision`` put in the program's place.  For each of
``--fault-seeds``, the program with each fault of benchmark/faults.py that
the cell's kind can have planted (a training cell's ``unchanged`` fault
needs no run: its change gap reads 1).  Prints one JSON line a reading and
a summary: the largest sound reading (the lower) and the smallest control
or fault reading (the upper) of each number.
"""

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[0] = str(REPO)

import argparse  # noqa: E402

import torch  # noqa: E402

from benchmark import faults, harness  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(',') if s]


def train_reading(cell, cfg, seed, device, patch=None, control=None):
    traffic, arch = cell['traffic'], cfg['arch']
    augment = None
    if control is None:
        with arch.augment_look(cfg, traffic) as augment:
            s = harness.train_setup(cfg, traffic, seed, device, patch)
        record, g_w, d_w, stack = s['record'], s['g_w'], s['d_w'], s['stack']
        del s
        harness._free(device)
    else:
        g_w, d_w, stack = arch.train_inputs(cfg, traffic, seed, device)
        record = harness.reference_run(cfg, traffic, seed, g_w, d_w, stack,
                                       device, precision=control)
    ref = harness.reference_run(cfg, traffic, seed, g_w, d_w, stack, device)
    numbers, detail = harness.train_numbers(record, ref)
    detail['augment'] = augment
    return numbers, detail


def sample_reading(cell, cfg, seed, device, patch=None, control=None):
    if control is None:
        out = harness.run_sample(cell, cfg, seed, 1.0, False, device,
                                 time.perf_counter(), patch)
        return out['numbers'], None
    traffic, arch = cell['traffic'], cfg['arch']
    gen = torch.Generator(device=device).manual_seed(seed)
    g_w, _ = arch.make_weights(cfg, gen)
    pool = harness.latent_pool(cfg, traffic, gen)
    keep = []
    with torch.no_grad(), harness.ref_precision(control == 'tf32'):
        for i in range(traffic['check_batches']):
            images = arch.generator(g_w, pool[i], traffic['phase'], cfg,
                                    precision=control)
            keep.append((i, images.permute(0, 2, 3, 1).cpu().numpy()))
    return harness.sample_numbers(keep, pool, g_w, cfg, traffic['phase']), None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=_seeds, default=[])
    ap.add_argument('--control-seeds', type=_seeds, default=[])
    ap.add_argument('--fault-seeds', type=_seeds, default=[])
    ap.add_argument('--control', default=None,
                    help="the control's precision (default: the "
                         "configuration's control_precision)")
    ap.add_argument('--set', action='append', default=[],
                    help='override a configuration value, '
                         'e.g. execution.packed_min_res=null (JSON)')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cell, cfg = harness.Bench(REPO).cell(args.workload)
    for item in args.set:
        path, value = item.split('=', 1)
        section, key = path.split('.')
        cfg[section][key] = json.loads(value)
    kind = cell['traffic']['kind']
    read = train_reading if kind == 'train' else sample_reading
    planted = faults.TRAIN if kind == 'train' else faults.SAMPLE
    runs = [('program', s, None, None) for s in args.seeds]
    control = args.control or cfg['control_precision']
    runs += [('control', s, None, control) for s in args.control_seeds]
    runs += [(f, s, planted[f], None) for s in args.fault_seeds
             for f in planted if f != 'unchanged']
    lower, upper, lines = {}, {}, []
    for what, seed, patch, control in runs:
        t = time.perf_counter()
        numbers, detail = read(cell, cfg, seed, device, patch, control)
        line = {'workload': args.workload, 'set': args.set,
                'control': control, 'reading': what, 'seed': seed,
                'numbers': numbers, 'detail': detail,
                'seconds': time.perf_counter() - t}
        lines.append(line)
        print(json.dumps(line), flush=True)
        for k, v in numbers.items():
            if what == 'program':
                lower[k] = max(lower.get(k, 0.0), v)
            else:
                upper.setdefault(what, {})
                upper[what][k] = min(upper[what].get(k, float('inf')), v)
    summary = {'workload': args.workload, 'lower': lower, 'upper': upper,
               'device': (torch.cuda.get_device_name(device)
                          if device.type == 'cuda' else 'cpu')}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, 'a') as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
