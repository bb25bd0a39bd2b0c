"""Run a two-arm quality A/B over several seeds and aggregate the verdict
(counterpart of the JAX package's tools/run_multiseed_ab.sh).

    python -m neuron_gan_tpu_torch.tools.run_multiseed_ab <tool-stem> \\
        <base-arm-tag> <log-file> <seeds...> [-- tool arguments]

    python -m neuron_gan_tpu_torch.tools.run_multiseed_ab stacked_ab \\
        reference stacked.jsonl 1 2 3 4 5 6

Each seed runs both arms of ``python -m neuron_gan_tpu_torch.tools.<stem>
--seed S --out <tmp>/<stem>_sS`` (arguments after ``--`` are passed on,
e.g. ``--device cpu``), its output shown and appended to <log-file>; a
failed seed is reported and the study goes on (``ab_aggregate`` drops an
incomplete seed rather than mis-pair).  The verdict comes from
``ab_aggregate``, the candidate arm being the other tag in the log.
"""

import json
import os
import subprocess
import sys
import tempfile

from neuron_gan_tpu_torch.tools import ab_aggregate


def run_seed(stem, seed, log, tool_args):
    """One seed of the tool, its stdout echoed and appended to ``log``;
    returns the exit code."""
    out = os.path.join(tempfile.gettempdir(), f'{stem}_s{seed}')
    cmd = [sys.executable, '-m', f'neuron_gan_tpu_torch.tools.{stem}',
           '--seed', str(seed), '--out', out, *tool_args]
    with open(log, 'a') as fh, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, text=True) as proc:
        for line in proc.stdout:
            sys.stdout.write(line)
            fh.write(line)
            fh.flush()
    return proc.returncode


def arm_tags(log):
    tags = []
    with open(log) as fh:
        for line in fh:
            if line.startswith('{'):
                try:
                    arm = json.loads(line).get('arm')
                except json.JSONDecodeError:
                    continue
                if arm is not None and arm not in tags:
                    tags.append(arm)
    return tags


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    tool_args = []
    if '--' in argv:
        cut = argv.index('--')
        argv, tool_args = argv[:cut], argv[cut + 1:]
    if len(argv) < 4:
        sys.exit(__doc__)
    stem, base, log, seeds = argv[0], argv[1], argv[2], argv[3:]
    for seed in seeds:
        print(f'=== {stem} seed {seed} ===', file=sys.stderr, flush=True)
        rc = run_seed(stem, int(seed), log, tool_args)
        if rc:
            print(f'=== seed {seed} FAILED (exit {rc}) — continuing ===',
                  file=sys.stderr, flush=True)
    cands = [t for t in arm_tags(log) if t != base]
    if not cands:
        sys.exit(f'no arm other than {base!r} in {log}')
    ab_aggregate.main([log, '--base', base, '--cand', cands[0]])


if __name__ == '__main__':
    main()
