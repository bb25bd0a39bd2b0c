"""K3/K4 (the fused packed conv3x3 + LeakyReLU + PixelNorm pair) against
their roofline: the summed least time of one step's K3 and K4 launch
sites (benchmark/kernels.py; K3's least time the larger of its operations'
and its bytes') over the device time of the traced chunk's packed_conv_fwd,
split_weights and packed_dz kernels per step, in %."""

from benchmark import kernels


def read(r):
    if r.kind != 'train' or r.peaks is None:
        return None
    busy = sum(r.trace.kernels_matching(kernels.KERNEL_NAMES[k])
               for k in ('k3', 'k4'))
    least = kernels.least_s_per_step(r.sites, ('k3', 'k4'), r.itemsize,
                                     r.peaks)
    if not busy or not least:
        return None
    return 100.0 * least / (busy / r.units)
