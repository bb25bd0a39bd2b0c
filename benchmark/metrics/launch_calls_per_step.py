"""Host-side CUDA launch calls (kernel and graph launches of the runtime
and the driver, as the profiler's runtime events record them) per training
step of the traced chunk: what the eager step costs the host."""


def read(r):
    if r.kind != 'train' or not r.trace.launch_calls:
        return None
    return r.trace.launch_calls / r.units
