"""Share of a traced training chunk in which no kernel, copy or fill runs
on the device (the union of their intervals, not their sum), in %."""


def read(r):
    if r.kind != 'train' or not r.trace.window_s:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
