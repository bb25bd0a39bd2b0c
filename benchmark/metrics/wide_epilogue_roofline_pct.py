"""The wide K1/K2 instances (the LeakyReLU + PixelNorm pair at a group
width of 256 or 512) against their roofline: the summed least time of one
step's 'k1_wide' and 'k2_wide' launch sites (an architecture's KERNELS and
kernel_sites) over the device time of the traced chunk's
lrelu_pn_wide_fwd and lrelu_pn_wide_bwd kernels per step, in %.  The
narrow instances' launches are epilogue_roofline_pct's."""

from benchmark import kernels

WIDE = ('k1_wide', 'k2_wide')


def read(r):
    if r.kind != 'train' or r.peaks is None:
        return None
    names = [k for k in WIDE if k in r.kernels]
    if not names:
        return None
    busy = sum(r.trace.kernels_matching(r.kernels[k][0]) for k in names)
    least = kernels.least_s_per_step(r.sites, names, r.itemsize, r.peaks,
                                     r.kernels)
    if not busy or not least:
        return None
    return 100.0 * least / (busy / r.units)
