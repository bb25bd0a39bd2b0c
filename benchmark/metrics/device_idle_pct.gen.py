"""Share of a traced run of sampling batches in which no kernel, copy or
fill runs on the device (the union of their intervals), in %."""


def read(r):
    if r.kind != 'sample' or not r.trace.window_s:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
