"""Quality A/B: every shipping default together against every reference semantic
together.  Reference arm: precision 'highest', compute_dtype 'float32',
the reference-order augmentation without shear, fresh GP fakes, the 2x2
layout (reference loss_functions.py:166, data/NeuronDataset.py:113-126,
true float32).  Shipping arm: the defaults of ``run_quality_ab`` (fast
augmentation, shear 'auto', 'mixed', GP-fake reuse, the 2x4 layout), at
precision 'default'.  Each knob passed its own multi-seed study in the JAX
package; this one holds their combination, which in the port also runs
the port's own numerics (the kernels, cuDNN's algorithms).

Judged by multi-scale SWD over a full 16->128 growth run
(``precision_ab.run_quality_ab``; counterpart of the JAX package's
tools/stacked_ab.py).

    python -m neuron_gan_tpu_torch.tools.stacked_ab [--epochs 2500] [--seed 1] \\
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
        ('shipping', {})]


def main(argv=None):
    args = make_quality_ab_parser('stacked_ab').parse_args(argv)
    return run_quality_ab(args, arms=ARMS, verdict_ok='stack_ok',
                          verdict_worse='stack_worse')


if __name__ == '__main__':
    main()
