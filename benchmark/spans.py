"""The device's idle time inside the stages of the port's training step.

The port marks each stage of its batch step and epoch runner with a span
(``neuron_gan_tpu_torch/runtime/timing.py::span``): a range named
``step.<stage>`` on the host's main thread, recorded while a profiler runs
as a host operator on the same clock as the device's activity.  ``Trace``
keeps each thread's outermost host ranges, and the spans are flat, so
they are among them.  ``idle_s`` charges every stretch of the
traced window in which the device is idle (no kernel, copy or fill) to
the ``step.*`` span open on the host at that time, and what no span
covers to 'outside'.  The parts add up to the window's idle time.

A program without the spans (an older commit) gives no reading.
"""

import bisect

PREFIX = 'step.'
GROUPS = {
    'augment': ('step.draws', 'step.augment'),
    'critic': ('step.critic_fakes', 'step.critic_loss', 'step.grad_penalty',
               'step.critic_backward'),
    'generator': ('step.gen_loss', 'step.gen_backward'),
    'optimizer': ('step.critic_adam', 'step.gen_adam', 'step.ema'),
}


def spans(trace):
    """The ``step.*`` ranges of ``trace`` as sorted (start_ns, end_ns,
    name), each cut to start where the one before it ended, so no instant
    is counted twice."""
    found = sorted((s, e, name) for _, ops in trace._outer
                   for s, e, name in ops if name.startswith(PREFIX))
    out, end = [], None
    for s, e, name in found:
        s = s if end is None else max(s, end)
        if e > s:
            out.append((s, e, name))
            end = e
    return out


def _busy_ns(busy, ends, s, e):
    """Nanoseconds of [s, e] that the sorted disjoint intervals ``busy``
    (``ends`` their ends) cover."""
    total = 0
    for b0, b1 in busy[bisect.bisect_right(ends, s):]:
        if b0 >= e:
            break
        total += min(b1, e) - max(b0, s)
    return total


def idle_s(trace):
    """{span name: device-idle seconds while it was open, 'outside': the
    window's idle seconds while none was}, or None when ``trace`` holds no
    ``step.*`` span."""
    found = spans(trace)
    if not found:
        return None
    ends = [b[1] for b in trace._busy]
    out = {}
    for s, e, name in found:
        idle = (e - s - _busy_ns(trace._busy, ends, s, e)) * 1e-9
        out[name] = out.get(name, 0.0) + idle
    out['outside'] = (trace.window_s - trace.busy_s) - sum(out.values())
    return out


def idle_ms_per_step(r, group):
    """Device-idle ms a traced step inside ``group``'s spans (GROUPS) or,
    for 'outside', inside none; None for a sampling run or a trace with no
    ``step.*`` span."""
    if r.kind != 'train':
        return None
    idle = idle_s(r.trace)
    if idle is None:
        return None
    if group == 'outside':
        seconds = idle['outside']
    else:
        seconds = sum(idle.get(name, 0.0) for name in GROUPS[group])
    return seconds / r.units * 1e3
