"""Quality A/B: fresh gradient-penalty fakes (the reference draws new latents inside
D_grad_pen_loss, loss_functions.py:166) against reusing the critic
loss's fake batch for the GP interpolates (the original WGAN-GP
formulation, Gulrajani et al. 2017), which runs G once a critic step.

Judged by multi-scale SWD over a full 16->128 growth run
(``precision_ab.run_quality_ab``; counterpart of the JAX package's
tools/gp_reuse_ab.py).

    python -m neuron_gan_tpu_torch.tools.gp_reuse_ab [--epochs 2500] [--seed 1] \\
        [--out DIR] [--device cpu]
"""

from neuron_gan_tpu_torch.tools.precision_ab import (
    make_quality_ab_parser, run_quality_ab)

ARMS = [('fresh', {'gp_reuse_fakes': False}),
        ('reuse', {'gp_reuse_fakes': True})]


def main(argv=None):
    args = make_quality_ab_parser('gp_reuse_ab').parse_args(argv)
    return run_quality_ab(args, arms=ARMS, verdict_ok='reuse_ok',
                          verdict_worse='reuse_worse')


if __name__ == '__main__':
    main()
