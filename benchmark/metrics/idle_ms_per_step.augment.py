"""Device-idle ms a traced training step while the port draws the batch's
random numbers and augments it on the host (its step.draws and
step.augment spans; benchmark/spans.py)."""

from benchmark import spans


def read(r):
    return spans.idle_ms_per_step(r, 'augment')
