"""Device-idle ms a traced training step while the host runs the optimizer
steps and the EMA update (the step.critic_adam, step.gen_adam and step.ema
spans; benchmark/spans.py)."""

from benchmark import spans


def read(r):
    return spans.idle_ms_per_step(r, 'optimizer')
