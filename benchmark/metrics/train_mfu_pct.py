"""The whole training step's share of the chip's peak: the step's model
FLOPs (benchmark/flops.py, from the configuration's shapes) times the
window's steps/s over the configuration's peak, in %."""


def read(r):
    if r.kind != 'train':
        return None
    return 100.0 * r.flops_per_unit * r.rate / r.peak_flops
