"""Device time of a function's kernels on the GPU, for the design and smoke
scripts (chip_smoke.py, k4_variants.py)."""

import time

import torch

_flush = {}


def _l2_flush():
    """A function that overwrites the card's 50 MB L2 cache: one
    bitwise_not over 256 MB, a kernel no timed function launches."""
    if not _flush:
        buf = torch.zeros(64 * 2 ** 20, dtype=torch.int32, device='cuda')
        _flush['fn'] = buf.bitwise_not_
    return _flush['fn']


def _kernel_us(fn, iters, before):
    """{kernel name: (summed device us, launches)} of ``iters`` calls of
    ``fn``, each after ``before``, by torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            before()
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(evt, 'self_device_time_total',
                    getattr(evt, 'self_cuda_time_total', 0.0))
        us, n = out.get(evt.key, (0.0, 0))
        out[evt.key] = (us + t, n + evt.count)
    return out


def device_ms(fn, iters=10, warmup=2):
    """Device time of one call of ``fn`` in ms: the summed durations of the
    kernels it launches, as torch.profiler (CUPTI) reads them, over
    ``iters`` calls, each after the L2 cache was overwritten, so every call
    reads its inputs from device memory.  Launch gaps and host time do not
    count: at small shapes an event-timed loop of eager calls reads the
    host's launch rate, not the kernel.  A window in which the profiler
    missed a flush or saw no kernel of ``fn`` is read again, after a pause
    that grows with each miss (CUPTI on an H100 has dropped every event
    for some seconds), seven times at most, then raises."""
    flush = _l2_flush()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(8):
        if attempt:
            time.sleep(0.5 * attempt)
        seen = _kernel_us(fn, iters, flush)
        flushes = sum(n for k, (_, n) in seen.items() if 'bitwise_not' in k)
        us = sum(t for k, (t, _) in seen.items() if 'bitwise_not' not in k)
        if flushes == iters and us > 0:
            return us / iters / 1e3
    raise RuntimeError(f'torch.profiler saw {flushes} of {iters} flushes '
                       f'and {us} us of kernels: {seen}')
