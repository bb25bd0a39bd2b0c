"""Device-idle ms a traced training step while no step.* span of the port
is open: the epoch runner's own work between the stages, and whatever no
span names (benchmark/spans.py).  With the four stage groups it adds up
to the window's idle time."""

from benchmark import spans


def read(r):
    return spans.idle_ms_per_step(r, 'outside')
