"""A device trace of part of a run, reduced to what the per-layer readers
and the result's ``breakdown`` need.

``capture(fn)`` runs ``fn`` under torch.profiler (CPU and CUDA activity,
no shapes, no stacks) and reads the profiler's raw events, not its parsed
tree, which takes minutes at a few hundred thousand events.  ``Trace``
keeps:

* the device's activity: every kernel, copy and fill, as intervals;
  ``busy_s`` is the length of their union, ``window_s`` the span from the
  first event of the trace to its last, so the idle share is that of the
  traced window (the profiler's own host cost is in it);
* the kernels' device time by name and by category (``category``, a frozen
  copy of the port's tools/op_trace.py name lists, and the kernels an
  architecture names beside K1-K4, its ``KERNELS``);
* the host's launch calls (kernel and graph launches of the CUDA runtime
  and driver);
* the host's operators, so an idle gap on the device is charged to the
  outermost operator running at its midpoint on any thread ('python' when
  none is).
"""

import bisect
import collections
import re

import torch

LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
                'cuLaunchKernelEx', 'cudaLaunchCooperativeKernel',
                'cudaGraphLaunch', 'cuGraphLaunch')
DEVICE_ACTIVITY = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_OPS = ('cpu_op', 'user_annotation', 'python_function')

_KERNELS = (('k1', ('lrelu_pn_fwd',)), ('k2', ('lrelu_pn_bwd',)),
            ('k3', ('packed_conv_fwd', 'split_weights')),
            ('k4', ('packed_dz',)))
_LAYOUT = ('nchwtonhwc', 'nhwctonchw', 'transpose', 'copy', 'contiguous',
           'clone', 'permute', 'catarraybatched', 'aten::cat')
_CONV = ('conv', 'fprop', 'dgrad', 'wgrad', 'implicit', 'winograd', 'fft',
         'cudnn')
_GEMM = ('gemm', 'gemv', 'aten::mm', 'aten::bmm', 'aten::addmm',
         'aten::matmul', 'aten::linear')
_FILL = ('fill', 'zero')
_REDUCTION = ('reduce', 'aten::sum', 'aten::mean', 'aten::norm', 'aten::max',
              'aten::amax', 'aten::min', 'norm_kernel')
_ELEMENTWISE = ('elementwise', 'vectorized', 'unrolled', 'aten::add',
                'aten::sub', 'aten::mul', 'aten::div', 'aten::where',
                'aten::leaky_relu', 'aten::rsqrt', 'aten::sqrt', 'aten::pow',
                'aten::lerp', 'aten::addcmul', 'aten::addcdiv', 'aten::clamp',
                'aten::neg', 'aten::exp', 'aten::abs', 'aten::ge',
                'aten::lt', 'aten::gt', 'aten::le', 'aten::eq', 'aten::round')


def category(name, own=None):
    """The category of a kernel name (tools/op_trace.py's rule); ``own``
    {name: (substrings, least_s)} (an architecture's KERNELS) comes after
    K1-K4."""
    low = name.lower()
    kinds = _KERNELS + tuple((k, v[0]) for k, v in (own or {}).items())
    for cat, keys in kinds:
        if any(k in low for k in keys):
            return cat
    for cat, keys in (('layout', _LAYOUT), ('conv', _CONV), ('gemm', _GEMM),
                      ('fill', _FILL), ('reduction', _REDUCTION),
                      ('elementwise', _ELEMENTWISE)):
        if any(k in low for k in keys):
            return cat
    return 'other'


def _union(intervals):
    """Sorted disjoint intervals covering ``intervals`` [(start, end)]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """The reduced trace (times in seconds).  Build one from raw events,
    each (activity, name, start_ns, end_ns, thread), and the
    architecture's own kernels (``category``)."""

    def __init__(self, events, own=None):
        self.own = own or {}
        device, host, starts, ends = [], collections.defaultdict(list), [], []
        self.kernel_s = collections.Counter()
        self.launch_calls = self.kernels = 0
        for act, name, s, e, thread in events:
            starts.append(s)
            ends.append(e)
            if act in DEVICE_ACTIVITY:
                device.append((s, e))
                if act == 'kernel':
                    self.kernel_s[name] += (e - s) * 1e-9
                    self.kernels += 1
            elif name.startswith(LAUNCH_CALLS):
                self.launch_calls += 1
            elif act in HOST_OPS and not _RUNTIME.match(name):
                host[thread].append((s, e, name))
        self.window_s = (max(ends) - min(starts)) * 1e-9 if starts else 0.0
        self._busy = _union(device)
        self.busy_s = sum(e - s for s, e in self._busy) * 1e-9
        self._outer = self._outermost(host)

    @staticmethod
    def _outermost(host):
        """Each thread's outermost operators, disjoint and sorted:
        [(starts, ops)]."""
        out = []
        for ops in host.values():
            keep, end = [], None
            for s, e, name in sorted(ops):
                if end is None or s >= end:
                    keep.append((s, e, name))
                    end = e
            out.append(([k[0] for k in keep], keep))
        return out

    def category_s(self):
        out = collections.Counter()
        for name, t in self.kernel_s.items():
            out[category(name, self.own)] += t
        return out

    def kernels_matching(self, keys):
        return sum(t for name, t in self.kernel_s.items()
                   if any(k in name.lower() for k in keys))

    def _host_at(self, t):
        """The outermost operator running at ``t`` that started last, over
        all threads, or 'python'."""
        best = None
        for starts, ops in self._outer:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ops[i][1] >= t and (best is None
                                               or ops[i][0] > best[0]):
                best = ops[i]
        return 'python' if best is None else best[2]

    def idle_gaps(self):
        """{host operator: idle seconds}: every gap between device activity,
        charged to the host's operator at its midpoint (``_host_at``)."""
        out = collections.Counter()
        for (_, e0), (s1, _) in zip(self._busy, self._busy[1:]):
            out[self._host_at((e0 + s1) / 2)[:80]] += (s1 - e0) * 1e-9
        return out

    def breakdown(self, top=10):
        ops = sorted(self.category_s().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])[:top]
        return {'device_ops': [[k, v] for k, v in ops],
                'idle_gaps': [[k, v] for k, v in gaps]}


_RUNTIME = re.compile(r'^cu(da)?[A-Z]')


def _activity(e):
    """The kineto activity of a raw event: its own name for it where the
    event has one, else 'kernel', 'gpu_memcpy' or 'gpu_memset' on the
    device and 'cuda_runtime' or 'cpu_op' on the host, by name."""
    if hasattr(e, 'activity_type'):
        return e.activity_type()
    name = e.name()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if name.startswith('Memcpy'):
            return 'gpu_memcpy'
        return 'gpu_memset' if name.startswith('Memset') else 'kernel'
    return 'cuda_runtime' if _RUNTIME.match(name) else 'cpu_op'


def _raw(prof):
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        yield (_activity(e), e.name(), start, start + e.duration_ns(),
               e.start_thread_id())


def capture(fn, own=None):
    """(fn's result, Trace) of ``fn`` run under torch.profiler; ``fn``
    ends by waiting for the device; ``own`` as ``category``'s."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    return out, Trace(_raw(prof), own)
