"""Quality A/B: the point-gather affine warp of the fast augmentation against the
shear-decomposed warp (three integer-shift shears after the nearest
quarter turn): the same rotation, translation and flip family with
rounding per shear pass instead of per point.

Judged by multi-scale SWD over a full 16->128 growth run
(``precision_ab.run_quality_ab``; counterpart of the JAX package's
tools/shear_ab.py).

    python -m neuron_gan_tpu_torch.tools.shear_ab [--epochs 2500] [--seed 1] \\
        [--out DIR] [--device cpu]
"""

from neuron_gan_tpu_torch.tools.precision_ab import (
    make_quality_ab_parser, run_quality_ab)

ARMS = [('gather', {'shear_warp': False}),
        ('shear', {'shear_warp': True})]


def main(argv=None):
    args = make_quality_ab_parser('shear_ab').parse_args(argv)
    return run_quality_ab(args, arms=ARMS, verdict_ok='shear_ok',
                          verdict_worse='shear_worse')


if __name__ == '__main__':
    main()
