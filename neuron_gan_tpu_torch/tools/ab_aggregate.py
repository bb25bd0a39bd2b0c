"""Aggregate multi-seed quality A/B results into a promotion decision
(a copy of the JAX package's tools/ab_aggregate.py: pure Python, so the
port keeps its own).

The single-seed A/B harnesses (shear_ab, mixed_ab, gp_reuse_ab,
precision_ab and the others of this package) print one JSON line per arm; with two
seeds the binary "never worse across seeds" bar rejects any change whose
true effect is zero whenever metric/seed noise flips one comparison (a
coin toss per seed).  The precision promotion (BASELINE.md "Precision
quality A/B") already reasoned past this — "the across-seed spread of
``highest`` itself dwarfs any arm effect" — and this tool applies the same
standard quantitatively:

  - pair the arms within each seed (same dataset, same training seed);
  - compare the mean paired difference against the across-seed spread of
    the BASELINE arm (the seed-noise scale GAN training itself exhibits;
    within-seed pairing does NOT remove this noise — the arms' training
    trajectories diverge at the first augmentation draw — so the baseline's
    own across-seed spread is the correct null scale);
  - flag catastrophic seeds: candidate value outside the baseline's
    observed across-seed support (> max(base) + spread).  A fixed per-pair
    ratio bar (the single-seed harness's 1.15x) is NOT used here: the
    baseline arm fails it against its own reruns (seed-2 gather 0.288 vs
    seed-1 gather 0.345 is already 1.20x; the precision A/B's 'highest'
    arm varied 2.3x on the finest band across seeds).

Promotion verdict:
  - 'promote'  : |mean paired diff| < spread AND no catastrophic seed AND
                 candidate is not worse in a majority of seeds by more
                 than the spread;
  - 'reject'   : mean paired diff > spread (systematically worse) or any
                 catastrophic seed;
  - 'keep-opt-in' : otherwise (underpowered / ambiguous).

Usage:
    python -m neuron_gan_tpu_torch.tools.ab_aggregate --base gather --cand shear LOG [LOG2 ...]

Each input file holds JSON lines; non-JSON lines are ignored, so a raw
tool log works directly.  Seeds pair by order of appearance: one base
line + one cand line (either order) form a seed; an incomplete seed —
e.g. one arm crashed before printing — is dropped with a warning rather
than shifting later seeds out of alignment.
"""

import argparse
import json
import math
import sys


def load_pairs(paths, base, cand):
    """Return [(base_swd, cand_swd), ...] one per seed, in file order.

    Seeds pair sequentially: one ``base`` + one ``cand`` line (either
    order) complete a seed.  A repeated arm before its partner arrived
    means the previous seed is incomplete (one arm crashed before
    printing); that seed is dropped with a warning instead of silently
    pairing across seeds — a cross-seed "paired" difference is exactly
    the noise this tool exists to calibrate away.
    """
    lines = []
    for p in paths:
        with open(p) as f:
            lines += f.readlines()
    pairs = []
    pending = {}
    for ln in lines:
        ln = ln.strip()
        if not ln.startswith('{'):
            continue
        try:
            d = json.loads(ln)
        except json.JSONDecodeError:
            continue
        arm = d.get('arm')
        if arm not in (base, cand) or 'swd_mean' not in d:
            continue
        if arm in pending:
            print(f'warning: dropping incomplete seed (saw {arm} twice '
                  f'with no intervening partner arm)', file=sys.stderr)
            pending = {}
        pending[arm] = float(d['swd_mean'])
        if base in pending and cand in pending:
            pairs.append((pending[base], pending[cand]))
            pending = {}
    if pending:
        print(f'warning: dropping trailing incomplete seed '
              f'({list(pending)[0]} without a partner arm)', file=sys.stderr)
    return pairs


def decide(pairs):
    base = [b for b, _ in pairs]
    cand = [c for _, c in pairs]
    n = len(pairs)
    diffs = [c - b for b, c in pairs]
    mean_d = sum(diffs) / n
    mb = sum(base) / n
    # seed-noise scale: the baseline arm's own across-seed std (ddof=1)
    spread = (math.sqrt(sum((b - mb) ** 2 for b in base) / (n - 1))
              if n > 1 else float('inf'))
    # catastrophic = outside the baseline's observed across-seed support
    cat_bar = max(base) + spread if n > 1 else float('inf')
    catastrophic = [i for i, c in enumerate(cand) if c > cat_bar]
    worse_by_spread = sum(1 for d in diffs if d > spread)
    if catastrophic or (n > 1 and mean_d > spread):
        verdict = 'reject'
    elif n >= 4 and mean_d < spread and worse_by_spread <= n // 2:
        # covers both "no detectable difference" (|mean_d| < spread) and
        # "candidate better beyond seed noise" (mean_d < -spread) — the
        # latter previously fell through to keep-opt-in, a blind spot the
        # round-4 shear regeneration hit (shear better by 0.068 vs spread
        # 0.059 got 'keep-opt-in' despite being the favorable tail)
        verdict = 'promote'
    else:
        verdict = 'keep-opt-in'
    return {
        'n_seeds': n,
        'base_mean': round(mb, 4),
        'cand_mean': round(sum(cand) / n, 4),
        'mean_paired_diff': round(mean_d, 4),
        'base_seed_spread': round(spread, 4) if n > 1 else None,
        'catastrophic_bar': round(cat_bar, 4) if n > 1 else None,
        'catastrophic_seeds': catastrophic,
        'seeds_worse_by_more_than_spread': worse_by_spread,
        'pairs': [[round(b, 4), round(c, 4)] for b, c in pairs],
        'verdict': verdict,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('files', nargs='+', help='files containing JSON lines')
    ap.add_argument('--base', required=True)
    ap.add_argument('--cand', required=True)
    args = ap.parse_args(argv)
    pairs = load_pairs(args.files, args.base, args.cand)
    if not pairs:
        sys.exit('no paired arm results found')
    print(json.dumps(decide(pairs), indent=1))


if __name__ == '__main__':
    main()
