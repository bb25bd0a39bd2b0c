"""K1/K2 (the LeakyReLU + PixelNorm pair) against their roofline: the
summed least time of one step's K1 and K2 launch sites (benchmark/kernels.py,
the configuration's layouts) over the device time of the traced chunk's
lrelu_pn kernels per step, in %."""

from benchmark import kernels


def read(r):
    if r.kind != 'train' or r.peaks is None:
        return None
    busy = sum(r.trace.kernels_matching(kernels.KERNEL_NAMES[k])
               for k in ('k1', 'k2'))
    least = kernels.least_s_per_step(r.sites, ('k1', 'k2'), r.itemsize,
                                     r.peaks)
    if not busy or not least:
        return None
    return 100.0 * least / (busy / r.units)
