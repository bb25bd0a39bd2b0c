"""Quality A/B: the reference-order augmentation (warp at the full padded resolution,
then resize; reference data/NeuronDataset.py:113-126) against the fast
path (resize first, jitter and the crop-fused warp at phase scale).  The
shear warp is off in both arms, so the arms differ in the order alone
(shear is inert on the exact path; shear_ab covers it).

Judged by multi-scale SWD over a full 16->128 growth run
(``precision_ab.run_quality_ab``; counterpart of the JAX package's
tools/augment_ab.py).

    python -m neuron_gan_tpu_torch.tools.augment_ab [--epochs 2500] [--seed 1] \\
        [--out DIR] [--device cpu]
"""

from neuron_gan_tpu_torch.tools.precision_ab import (
    make_quality_ab_parser, run_quality_ab)

ARMS = [('exact', {'fast_augment': False, 'shear_warp': False}),
        ('fast', {'fast_augment': True, 'shear_warp': False})]


def main(argv=None):
    args = make_quality_ab_parser('augment_ab').parse_args(argv)
    return run_quality_ab(args, arms=ARMS, verdict_ok='fast_ok',
                          verdict_worse='fast_worse')


if __name__ == '__main__':
    main()
