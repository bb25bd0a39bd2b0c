"""Device self time of the convolution kernels (the 'conv' category of
benchmark/trace.py) per training step of the traced chunk, in ms."""


def read(r):
    if r.kind != 'train':
        return None
    s = r.trace.category_s()['conv']
    return s / r.units * 1e3 if s else None
