"""Faults planted in the program under test, for the calibration of the
limits (calibrate.py) and the tests that see ``correct`` come out false.
Nothing a benchmark run executes imports this module.

Each training fault wraps ``train_step.make_epoch_runner`` (the ``patch``
of ``harness.train_setup``); the sampling fault wraps the generator.

* ``unchanged``: every step leaves the state as it was (the optimizers
  step with a learning rate of 0);
* ``half_batch``: each batch step sees the first half of its rows and
  draws, its means over those, its stats weighted as a whole batch's;
* ``half_loss``: the critic's losses (the Wasserstein loss with its drift,
  and the penalty) are means over the first half of the batch's rows
  alone; D and G still run on every row, so every shape the step sees is
  the sound step's;
* ``altered``: the generator hands back a batch whose first two images
  are swapped (answers to the wrong requests).
"""

import torch


def _rows(draws, h, memo=None):
    """``draws`` cut to their first ``h`` rows; a tensor that appears twice
    (z2 is z1) stays one tensor."""
    memo = {} if memo is None else memo
    if isinstance(draws, torch.Tensor):
        if id(draws) not in memo:
            memo[id(draws)] = draws[:h]
        return memo[id(draws)]
    if isinstance(draws, dict):
        return {k: _rows(v, h, memo) for k, v in draws.items()}
    if isinstance(draws, (list, tuple)):
        return type(draws)(_rows(v, h, memo) for v in draws)
    return draws


def half_batch(make_epoch_runner):
    from neuron_gan_tpu_torch import train_step as ts

    def build(cfg, spec, n_epochs):
        inner = ts.make_batch_step

        def make_step(cfg, spec, grid=None):
            step = inner(cfg, spec, grid)

            def half(state, raw, draws, alpha, lr, lam, batch=None):
                b = raw.shape[0]
                h = b // 2
                out = step(state, raw[:h], _rows(draws, h), alpha, lr, lam, h)
                return out * (b / h)
            return half

        ts.make_batch_step = make_step
        try:
            return make_epoch_runner(cfg, spec, n_epochs)
        finally:
            ts.make_batch_step = inner
    return build


def _during_calls(make_epoch_runner, patches):
    """The runner with ``train_step``'s names in ``patches`` replaced
    while each call runs (the batch step looks them up at call time)."""
    from neuron_gan_tpu_torch import train_step as ts

    def build(cfg, spec, n_epochs):
        run = make_epoch_runner(cfg, spec, n_epochs)

        def patched(*args, **kwargs):
            inner = {k: getattr(ts, k) for k in patches}
            for k, wrap in patches.items():
                setattr(ts, k, wrap(inner[k]))
            try:
                return run(*args, **kwargs)
            finally:
                for k, v in inner.items():
                    setattr(ts, k, v)
        return patched
    return build


def _twice_first_half(x):
    h = x.shape[0] // 2
    return torch.cat([x[:h], x[:h]])


def half_loss(make_epoch_runner):
    def w_loss(inner):
        def half(d_apply, real, fake, drift_epsilon=0.0):
            # D scores every row; the means see the first half twice
            return inner(lambda x: _twice_first_half(d_apply(x)), real, fake,
                         drift_epsilon)
        return half

    def pen_loss(inner):
        def half(d_apply, real, fake, eps, gp_lambda, remat=False):
            # the penalty's rows: the first half twice, a batch of B rows
            return inner(d_apply, _twice_first_half(real),
                         _twice_first_half(fake), _twice_first_half(eps),
                         gp_lambda, remat)
        return half

    return _during_calls(make_epoch_runner, {'d_w_loss': w_loss,
                                             'd_grad_pen_loss': pen_loss})


def unchanged(make_epoch_runner):
    def frozen(set_lr):
        return lambda opt, lr: set_lr(opt, 0.0)

    return _during_calls(make_epoch_runner, {'_set_lr': frozen})


def altered(g):
    forward = g.forward

    def swapped(z, phase, alpha=None):
        out = forward(z, phase, alpha)
        return out[torch.tensor([1, 0, *range(2, out.shape[0])],
                                device=out.device)]

    g.forward = swapped
    return g


TRAIN = {'unchanged': unchanged, 'half_batch': half_batch,
         'half_loss': half_loss}
SAMPLE = {'altered': altered}
