"""G's forward's share of the chip's peak: 2 MAC of G's convs and dense
layer per image (benchmark/flops.py) times the window's images/s over the
configuration's peak, in %."""


def read(r):
    if r.kind != 'sample':
        return None
    return 100.0 * r.flops_per_unit * r.rate / r.peak_flops
