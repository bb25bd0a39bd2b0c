"""The ported kernels' launch sites in one batch step, and each launch's
least time: the numerators of the kernels' roofline shares.

A frozen copy of the routing rules of the port as this benchmark was
written (models/pggan.py's packed-layout predicates, flagship.step_sites):
where a configuration puts its LeakyReLU + PixelNorm pair K1/K2 and its
fused packed conv pair K3/K4, and at which shapes.  The sites are the work
of the step at the configuration's layouts, so a later program that
implements that work with other kernels is measured against the same
numerator.

Least time of a launch: the larger of its bytes over the chip's memory
rate and its operations over the peak of its arithmetic; each input read
once and each output written once.

* K1 (forward) reads x and writes y; K2 (backward) reads x and the
  cotangent and writes dx; about 6 and 12 float32 operations an element.
* K3 reads x (B, K, H, W) and writes y (B, N, H, W) in the working type,
  reads the float32 weights (N, K, 3, 3) and writes the float32 scales r
  (B, 4, H, W); its products are the packed weight's nonzero taps,
  36 C_in C_out = 2.25 K N, two operations a multiply-add, at the bfloat16
  tensor-core peak (float32: three TF32 products each, at the TF32 peak).
* K4 reads y and its cotangent and writes dz in the working type, and
  reads r (and, where the penalty's outer pass makes one, r's cotangent)
  in float32; about 12 float32 operations an element.
"""

import collections
import math

# K1-K4 kernel names, as they appear in a device trace
KERNEL_NAMES = {'k1': ('lrelu_pn_fwd',), 'k2': ('lrelu_pn_bwd',),
                'k3': ('packed_conv_fwd', 'split_weights'),
                'k4': ('packed_dz',)}


def _fused(x, precision):
    return precision is None if x is None else x


def _want_packed(ex, res):
    return ex.get('packed_min_res') is not None and res >= ex['packed_min_res']


def _p8_g(ex, out_res, feat):
    return (ex.get('packed_lanes') == 128
            and _fused(ex.get('fuse_up2_conv'), ex['precision'])
            and _want_packed(ex, out_res) and feat * 4 < 128
            and out_res % 8 == 0)


def _p8_d(ex, res, feat):
    return (ex.get('packed_lanes') == 128
            and _fused(ex.get('fuse_pool_conv'), ex['precision'])
            and _want_packed(ex, res) and feat * 4 < 128 and res % 8 == 0)


def block_layouts(model, ex, phase):
    """The layout of each block a step at ``phase`` runs, G's then D's:
    'unpacked', 'packed' (2x2) or 'p8' (2x4)."""
    fg, fd, n = model['n_gen_features'], model['n_dis_features'], len(model['n_gen_features'])
    init = model['image_size_init']

    def layout(native, res, feat):
        if not _want_packed(ex, res):
            return 'unpacked'
        tail8 = (ex.get('packed_lanes') == 128 and 4 * feat == 64
                 and (res // 2) % 2 == 0)
        return 'p8' if native or tail8 else 'packed'

    g = [layout(_p8_g(ex, init * 2 ** (i + 1), fg[i + 1]),
                init * 2 ** (i + 1), fg[i + 1]) for i in range(phase)]
    d, res = [], init * 2 ** phase
    in_p8 = _p8_d(ex, res, fd[n - 1 - phase])
    for i in range(n - 1 - phase, n - 1):
        res //= 2
        in_p8 = in_p8 and _p8_d(ex, res, fd[i + 1])
        d.append(layout(in_p8, res, fd[i + 1]))
    return g, d


def step_passes(reuse_fakes):
    """((G forwards, G backwards), (D forwards, D backwards)) of a batch
    step; D's backwards: real, fake, the penalty's inner and outer passes,
    the generator update."""
    return (2 if reuse_fakes else 3, 1), (4, 5)


def sites(model, ex, phase, batch, passes):
    """{(kernel, shape, case): launches} of one step with ``passes``: K1/K2
    by x's shape and grouping, K3 by y's shape, K4 by y's shape and
    'live' or 'absent' (r's cotangent: live in D's penalty outer pass)."""
    if not ex.get('use_kernels'):
        return {}
    (gf, gb), (df, db) = passes
    g, d = block_layouts(model, ex, phase)
    out = collections.Counter()

    def block(lay, feat, res, fwd, bwd, live):
        if lay == 'unpacked':
            shape, n, groups = (batch, feat, res, res), 2, 1
        elif lay == 'p8':
            shape, n, groups = (batch, 8 * feat, res // 2, res // 4), 2, 8
        else:
            shape, n, groups = (batch, 4 * feat, res // 2, res // 2), 1, 4
        out['k1', shape, groups] += n * fwd
        out['k2', shape, groups] += n * bwd
        if lay == 'packed':
            out['k3', shape, None] += fwd
            out['k4', shape, 'absent'] += bwd - live
            out['k4', shape, 'live'] += live

    init, n_lv = model['image_size_init'], len(model['n_gen_features'])
    for i, lay in enumerate(g):
        block(lay, model['n_gen_features'][i + 1], init * 2 ** (i + 1), gf, gb, 0)
    res = init * 2 ** phase
    for lay, i in zip(d, range(n_lv - 1 - phase, n_lv - 1)):
        res //= 2
        block(lay, model['n_dis_features'][i + 1], res, df, db, min(db, 1))
    return {k: v for k, v in out.items() if v}


def least_s(kernel, shape, case, itemsize, peaks):
    """Least seconds of one launch (the module docstring)."""
    numel = math.prod(shape)
    hbm = peaks['hbm_bytes_per_s']
    if kernel in ('k1', 'k2'):
        n_io, ops = (2, 6) if kernel == 'k1' else (3, 12)
        return max(n_io * numel * itemsize / hbm,
                   ops * numel / peaks['float32_flops_per_s'])
    b, n, h, w = shape
    if kernel == 'k3':
        pix = b * h * w
        nbytes = itemsize * pix * 2 * n + 4 * n * n * 9 + 4 * pix * 4
        if itemsize == 2:
            t_ops = 2 * 2.25 * n * n * pix / peaks['bfloat16_flops_per_s']
        else:
            t_ops = 3 * 2 * 2.25 * n * n * pix / peaks['tf32_flops_per_s']
        return max(nbytes / hbm, t_ops)
    nbytes = 3 * numel * itemsize + (2 if case == 'live' else 1) * 4 * b * 4 * h * w
    return max(nbytes / hbm, 12 * numel / peaks['float32_flops_per_s'])


def least_s_per_step(step_sites, kernels, itemsize, peaks, own=None):
    """Summed least time of one step's launches of ``kernels``; a kernel
    other than K1-K4 takes its least time from ``own`` {name: (substrings,
    least_s(shape, case, itemsize, peaks))}, an architecture's KERNELS."""
    def least(k, shape, case):
        if k in KERNEL_NAMES:
            return least_s(k, shape, case, itemsize, peaks)
        return own[k][1](shape, case, itemsize, peaks)
    return sum(n * least(k, shape, case)
               for (k, shape, case), n in step_sites.items() if k in kernels)
