"""Device-idle ms a traced training step while the host runs the generator
update's loss and backward (the step.gen_loss and step.gen_backward spans;
benchmark/spans.py)."""

from benchmark import spans


def read(r):
    return spans.idle_ms_per_step(r, 'generator')
