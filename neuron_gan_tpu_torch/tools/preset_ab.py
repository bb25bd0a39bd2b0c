"""Quality A/B: the quality-default configuration against the config_fast preset
(compute_dtype='mixed' and gp_reuse_fakes together), since speed and
quality trades need not compose.

Judged by multi-scale SWD over a full 16->128 growth run
(``precision_ab.run_quality_ab``; counterpart of the JAX package's
tools/preset_ab.py).

    python -m neuron_gan_tpu_torch.tools.preset_ab [--epochs 2500] [--seed 1] \\
        [--out DIR] [--device cpu]
"""

from neuron_gan_tpu_torch.tools.precision_ab import (
    make_quality_ab_parser, run_quality_ab)

ARMS = [('default', {}),
        ('preset', {'compute_dtype': 'mixed', 'gp_reuse_fakes': True})]


def main(argv=None):
    args = make_quality_ab_parser('preset_ab').parse_args(argv)
    return run_quality_ab(args, arms=ARMS, verdict_ok='preset_ok',
                          verdict_worse='preset_worse')


if __name__ == '__main__':
    main()
