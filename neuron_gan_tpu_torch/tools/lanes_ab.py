"""Quality A/B: the reference arm of ``stacked_ab`` against every shipping default
together with the 2x4 layout (packed_lanes=128) named explicitly: the
stacked study of the 2x4 layout's promotion.

Judged by multi-scale SWD over a full 16->128 growth run
(``precision_ab.run_quality_ab``; counterpart of the JAX package's
tools/lanes_ab.py).

    python -m neuron_gan_tpu_torch.tools.lanes_ab [--epochs 2500] [--seed 1] \\
        [--out DIR] [--device cpu]
"""

from neuron_gan_tpu_torch.tools.precision_ab import (
    make_quality_ab_parser, run_quality_ab)

ARMS = [('reference', {'precision_name': 'highest',
                        'compute_dtype': 'float32',
                        'fast_augment': False, 'shear_warp': False,
                        'gp_reuse_fakes': False,
                        # the 2x4 interior gates on packed_lanes
                        # alone: the 2x2 layout keeps this arm the
                        # exact reference-semantics path
                        'packed_lanes': None}),
        ('shipping_lanes', {'packed_lanes': 128})]


def main(argv=None):
    args = make_quality_ab_parser('lanes_ab').parse_args(argv)
    return run_quality_ab(args, arms=ARMS, verdict_ok='stack_ok',
                          verdict_worse='stack_worse')


if __name__ == '__main__':
    main()
