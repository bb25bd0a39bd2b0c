"""Quality A/B: compute_dtype='float32' against 'mixed' (bfloat16 activations through
the conv blocks, float32 stem, PixelNorm statistics, to_rgb image and
critic head).

Judged by multi-scale SWD over a full 16->128 growth run
(``precision_ab.run_quality_ab``; counterpart of the JAX package's
tools/mixed_ab.py).

    python -m neuron_gan_tpu_torch.tools.mixed_ab [--epochs 2500] [--seed 1] \\
        [--out DIR] [--device cpu]
"""

from neuron_gan_tpu_torch.tools.precision_ab import (
    make_quality_ab_parser, run_quality_ab)

ARMS = [('f32', {'compute_dtype': 'float32'}),
        ('mixed', {'compute_dtype': 'mixed'})]


def main(argv=None):
    args = make_quality_ab_parser('mixed_ab').parse_args(argv)
    return run_quality_ab(args, arms=ARMS, verdict_ok='mixed_ok',
                          verdict_worse='mixed_worse')


if __name__ == '__main__':
    main()
