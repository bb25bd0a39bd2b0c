"""The 2x2 and 2x4 space-to-depth packed layouts, NCHW.

Counterpart of neuron_gan_tpu/ops/packed.py (kept as a copy: that module
imports jax), with its fused level boundaries.  A packed
tensor is (B, 4C, H/2, W/2): the 2x2 pixel block at (2p+a, 2q+b) moves
into channels, with packed channel index ``(a*2 + b) * C + i``
(parity-major, original channel minor) -- the JAX package's channel
order, so a grouped PixelNorm with 4 groups normalizes each parity's C
channels, as the unpacked PixelNorm does.

The transform is exact: a stride-1 zero-padded 3x3 conv on the original
grid equals a 3x3 conv on the packed grid with a scattered kernel
(``pack_conv3x3_weight``; derivation in the JAX module).  Parameters stay
in the original OIHW layout; the scatter is differentiable, so gradients
land on the original weights.

The fused level boundaries compose a resampling and the first conv of a
block into one conv (derivations in the JAX module): G's upsample + conv
(``up2_equalized_conv3x3``), D's avg-pool + repack + conv
(``pool2_equalized_conv3x3``) and avg-pool + conv where D leaves the packed
layout (``pool2_unpacked_equalized_conv3x3``).  Each computes its
decomposed chain's function with the sums in another order.

The 2x4 layout packs the 2x2 one once more along W: (B, 8C, H/2, W/4),
packed channel ``b2 * 4C + (a*2 + b1) * C + i`` for the pixel at
(2p + a, 4q + 2*b2 + b1) -- the JAX package's order, so its 8 parity
groups are contiguous blocks of C channels.  Its convs, 1x1 convs and
native level boundaries (``packed8_*``, ``*_p8``) scatter the 2x2
kernels along W, exactly; the spatial extent is H/2 x W/4, not square.
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from neuron_gan_tpu_torch.ops.equalized import calculate_gain
from neuron_gan_tpu_torch.ops.pixelnorm import pixel_norm
from neuron_gan_tpu_torch.ops.resize import edge_pad1, upsample2_bilinear
from neuron_gan_tpu_torch.runtime.device import precision_scope


def space_to_depth(x):
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channel order (a, b, i)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


def depth_to_space(x):
    """(B, 4C, H, W) -> (B, C, 2H, 2W), inverse of space_to_depth."""
    b, c4, h, w = x.shape
    c = c4 // 4
    x = x.reshape(b, 2, 2, c, h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(b, c, 2 * h, 2 * w)


def _pack_transfer_tensor():
    """Constant 0/1 tensor T[P+1, Q+1, a', b', a, b, ty, tx]: the packed
    kernel's tap (P, Q) from input parity (a', b') to output parity (a, b)
    is the original tap (ty, tx) where T is 1 (at most one per entry)."""
    t = np.zeros((3, 3, 2, 2, 2, 2, 3, 3), np.float32)
    for a in (0, 1):
        for b in (0, 1):
            for dy in (-1, 0, 1):
                P, ap = divmod(a + dy, 2)
                for dx in (-1, 0, 1):
                    Q, bp = divmod(b + dx, 2)
                    t[P + 1, Q + 1, ap, bp, a, b, dy + 1, dx + 1] = 1.0
    return t


def _up2_taps():
    """T[p, ty, dy + 1]: the upsampled row 2J + p + ty - 1 as taps on input
    rows J + dy (the fused upsample + conv, below; composed over both
    axes in _CONSTS)."""
    t = np.zeros((2, 3, 3), np.float32)
    t[0, 0, :2] = 0.75, 0.25
    t[0, 1, :2] = 0.25, 0.75
    t[0, 2, 1:] = 0.75, 0.25
    t[1, 0, :2] = 0.25, 0.75
    t[1, 1, 1:] = 0.75, 0.25
    t[1, 2, 1:] = 0.25, 0.75
    return t


def _pool_taps():
    """T[ty, a, dy] = 1 where ty = a + dy (the fused pool + conv, below;
    composed over both axes in _CONSTS)."""
    t = np.zeros((4, 2, 3), np.float32)
    for a in (0, 1):
        for d in (0, 1, 2):
            t[a + d, a, d] = 1.0
    return t


def _pack_w_transfer_tensor():
    """Constant 0/1 tensor T[Q2+1, b2', b2, q1+1]: the W-only pack of a
    packed kernel's taps, the 1-D analogue of _pack_transfer_tensor."""
    t = np.zeros((3, 2, 2, 3), np.float32)
    for b2 in (0, 1):
        for q1 in (-1, 0, 1):
            q2, bp = divmod(b2 + q1, 2)
            t[q2 + 1, bp, b2, q1 + 1] = 1.0
    return t


def _pool_w8_transfer(out_packed8):
    """t[delta+1, b2i, (b2o,) tx]: the fused pool kernel's W taps over 2x4
    input columns (and output columns when ``out_packed8``)."""
    if out_packed8:
        t = np.zeros((4, 2, 2, 4), np.float32)
        for b2o in (0, 1):
            for tx in range(4):
                d, b2i = divmod(2 * b2o + tx - 1, 2)
                t[d + 1, b2i, b2o, tx] = 1.0
        return t
    t = np.zeros((3, 2, 4), np.float32)
    for tx in range(4):
        d, b2i = divmod(tx - 1, 2)
        t[d + 1, b2i, tx] = 1.0
    return t


def _up2_w8_taps():
    """T[tx, b2, dx+1]: the fused up-conv's W taps for 2x4 output columns
    (a stride-2 window of 4 over the edge-padded input)."""
    t = np.zeros((4, 2, 3), np.float32)
    for b2 in (0, 1):
        for dx in (-1, 0, 1):
            t[b2 + dx + 1, b2, dx + 1] = 1.0
    return t


_CONSTS = {'pack': _pack_transfer_tensor(),
           'up2': np.einsum('ptd,qse->pqdets', _up2_taps(), _up2_taps()),
           'pool': np.einsum('pad,qbe->padqbe', _pool_taps(), _pool_taps()),
           'pack_w': _pack_w_transfer_tensor(),
           'pool_w8': _pool_w8_transfer(True),
           'pool_w8_out4': _pool_w8_transfer(False),
           'up2_w8': _up2_w8_taps()}


@functools.lru_cache(maxsize=None)
def _const(name, dtype, device):
    # cached per device: a host-to-device copy in every step would make
    # the host wait for the device
    return torch.tensor(_CONSTS[name], dtype=dtype, device=device)


def pack_conv3x3_weight(w, scale=1.0):
    """OIHW 3x3 kernel (Co, Ci, 3, 3) -> packed kernel (4Co, 4Ci, 3, 3)
    such that conv(s2d(x), W, padding=1) == s2d(conv(x, w, padding=1)).

    One einsum against the constant 0/1 tensor; its adjoint carries the
    gradient to ``w``.  Each output entry is one weight times one (or no)
    1, so the result is exact as long as the contraction runs in full
    float32: the forward runs with TF32 off (the JAX package's
    ``Precision.HIGHEST`` here); its backward runs under the caller's
    precision."""
    co, ci, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f'pack_conv3x3_weight needs a 3x3 kernel, got '
                         f'{kh}x{kw}')
    with precision_scope('highest'):
        out = torch.einsum('PQcdabts,oits->abocdiPQ',
                           _const('pack', w.dtype, w.device), w * scale)
    return out.reshape(4 * co, 4 * ci, 3, 3)


def _eq_scale3x3(w, neg_slope):
    """Equalized-LR factor of an OIHW 3x3 kernel: gain / sqrt(Ci * 9),
    with the ORIGINAL fan-in."""
    if w.dim() != 4 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f'expected an OIHW 3x3 kernel, got {tuple(w.shape)}')
    return calculate_gain('leaky_relu', neg_slope) / math.sqrt(w.shape[1] * 9)


def packed_equalized_conv3x3(x_packed, weight, bias=None, *, neg_slope=0.2):
    """Equalized-LR 3x3 conv in the packed domain; ``weight`` is the
    ORIGINAL (Co, Ci, 3, 3) kernel, ``bias`` the original (Co,)."""
    w_packed = pack_conv3x3_weight(weight, _eq_scale3x3(weight, neg_slope))
    b = None if bias is None else bias.repeat(4).to(x_packed.dtype)
    return torch.nn.functional.conv2d(x_packed, w_packed.to(x_packed.dtype),
                                      b, padding=1)


def packed_pixel_norm(x_packed, eps=1e-8, f32_stats=False, n_groups=4):
    """PixelNorm over the ORIGINAL channels: each parity group's C channels
    normalized on their own (the JAX package's packed_pixel_norm and
    packed_pixel_norm_mxu compute this same function; ``n_groups=8``
    their packed8_ forms, for the 2x4 layout).

    bfloat16 with ``f32_stats`` rounds where the JAX package's fast path
    (packed_pixel_norm_mxu) does: x^2 in bfloat16 (its MXU operand), the
    group sums in float32, the scale rounded to bfloat16, then one
    bfloat16 product."""
    b, c4, h, w = x_packed.shape
    xg = x_packed.reshape(b * n_groups, c4 // n_groups, h, w)
    if f32_stats and x_packed.dtype == torch.bfloat16:
        m = torch.mean((xg * xg).float(), dim=1, keepdim=True)
        out = xg * torch.rsqrt(m + eps).to(xg.dtype)
    else:
        out = pixel_norm(xg, eps, f32_stats=f32_stats)
    return out.reshape(b, c4, h, w)


def packed_conv1x1(x_packed, weight, bias=None):
    """1x1 conv (to_rgb / from_rgb, no runtime scale) on each parity group:
    a block-diagonal 1x1 conv in the packed domain.  ``weight`` is the
    original (Co, Ci, 1, 1)."""
    co, ci = weight.shape[:2]
    w2 = weight.reshape(co, ci)
    wb = torch.block_diag(w2, w2, w2, w2).reshape(4 * co, 4 * ci, 1, 1)
    b = None if bias is None else bias.repeat(4).to(x_packed.dtype)
    return torch.nn.functional.conv2d(x_packed, wb.to(x_packed.dtype), b)


def packed_avg_pool2(x_packed):
    """2x2 average pooling of the original image == the mean over the 4
    parity groups at each packed pixel.  The output is UNPACKED at half
    the original resolution.  A bfloat16 mean sums in float32 and rounds
    once, as the JAX package's packed_avg_pool2_mxu does."""
    b, c4, h, w = x_packed.shape
    return x_packed.reshape(b, 4, c4 // 4, h, w).mean(dim=1)


def packed_upsample2_bilinear(x_packed):
    """x2 bilinear upsample in the packed domain: packed rep of res R in,
    packed rep of res 2R out (unpack, upsample, repack; exact)."""
    return space_to_depth(upsample2_bilinear(depth_to_space(x_packed)))


# --------------------------------------------------------------------------
# Fused upsample + conv: s2d(conv3x3(zeropad(up2(x)))) as ONE 3x3 conv
# --------------------------------------------------------------------------
#
# Each output parity p of upsample-then-conv reads input rows J + dy,
# dy in {-1, 0, 1}, through the 2-tap upsample (coefficients _up2_taps),
# so the chain is one 3x3 conv from Ci to 4Co channels (parity-major) on
# the edge-padded input -- except where the conv's zero padding of the
# upsampled frame applies: the first and last output row and column, four
# one-pixel bands recomputed exactly and written over the fused result.

def fuse_up2_conv3x3_weight(w, scale=1.0):
    """OIHW (Co, Ci, 3, 3) kernel -> the fused upsample + conv kernel
    (4Co, Ci, 3, 3), output channels (p, q, o)."""
    co, ci = w.shape[:2]
    with precision_scope('highest'):   # the tap composition in float32
        wf = torch.einsum('pqdets,oits->pqoide',
                          _const('up2', w.dtype, w.device), w * scale)
    return wf.reshape(4 * co, ci, 3, 3)


def _up2_border(x, w_s, dim):
    """The decomposed chain's first and last output row (``dim`` 2) or
    column (3), exactly: the upsampled frame's two outer lines at each
    border come from the input's two outer lines (one upsample of them,
    stacked), and a padding-1 conv of those four lines gives both border
    lines with the conv's zero padding beyond them.  Returns the two as
    (B, Co, 2n) each."""
    n = x.shape[dim]
    u = upsample2_bilinear(torch.cat([x.narrow(dim, 0, 2),
                                      x.narrow(dim, n - 2, 2)], dim))
    # lines 0, 1 of u are the frame's 0, 1 and lines 6, 7 its 2n-2, 2n-1
    # (lines 2..5 mix the two ends and are never read by lines 0 and 7)
    z = F.conv2d(u, w_s.to(x.dtype), padding=1)
    return z.select(dim, 0), z.select(dim, 7)


def up2_equalized_conv3x3(x, weight, *, neg_slope=0.2):
    """s2d(conv3x3_zero-pad(upsample2_bilinear(x))) * eq_scale as one conv.

    ``x`` is UNPACKED (B, Ci, n, n), n >= 2; the output is the packed rep
    of resolution 2n, (B, 4Co, n, n).  ``weight`` is the original bias-free
    (Co, Ci, 3, 3) kernel."""
    b, _, n, n2 = x.shape
    if n != n2 or n < 2:
        raise ValueError(f'fused up2-conv needs a square input of side >= '
                         f'2, got {tuple(x.shape)}')
    scale = _eq_scale3x3(weight, neg_slope)
    co = weight.shape[0]
    y = F.conv2d(edge_pad1(x),
                 fuse_up2_conv3x3_weight(weight, scale).to(x.dtype))
    w_s = weight * scale
    # an output line (B, Co, 2n) of the original grid as its two parities
    # (B, 2, Co, n): position 2K + q -> parity q at K
    par = lambda t: t.reshape(b, co, n, 2).permute(0, 3, 1, 2)  # noqa: E731
    top, bot = (par(t) for t in _up2_border(x, w_s, 2))
    lf, rt = (par(t) for t in _up2_border(x, w_s, 3))
    # written over the conv's output, which its backward does not need;
    # the columns claim the corners, as in the JAX package
    y[:, :2 * co, 0] = top.reshape(b, 2 * co, n)                 # p=0, J=0
    y[:, 2 * co:, n - 1] = bot.reshape(b, 2 * co, n)             # p=1, J=n-1
    y.view(b, 2, 2, co, n, n)[:, :, 0, :, :, 0] = lf             # q=0, K=0
    y.view(b, 2, 2, co, n, n)[:, :, 1, :, :, n - 1] = rt         # q=1, K=n-1
    return y


# --------------------------------------------------------------------------
# Fused avg-pool + (repack) + conv: D's level boundary as ONE conv
# --------------------------------------------------------------------------
#
# Packed -> packed: s2d(conv3x3(group_mean(y))) is a 4x4 stride-2 conv of
# the once-zero-padded y whose kernel is 0.25 w spread over taps
# ty = a + dy and broadcast over the four input parities.  Packed ->
# unpacked: the pooled grid is y's grid, so the group mean folds into the
# kernel as a 0.25-weighted broadcast over the input parities.

def fuse_pool2_conv3x3_weight(w, scale=1.0):
    """OIHW (Co, Ci, 3, 3) kernel -> the fused pool + repack + conv kernel
    (4Co, 4Ci, 4, 4): output channels (a, b, o), input channels (s, t, i)."""
    co, ci = w.shape[:2]
    with precision_scope('highest'):
        wf = torch.einsum('padqbe,oide->aboipq',
                          _const('pool', w.dtype, w.device), w * (0.25 * scale))
    wf = wf[:, :, :, None, None].expand(2, 2, co, 2, 2, ci, 4, 4)
    return wf.reshape(4 * co, 4 * ci, 4, 4)


def pool2_equalized_conv3x3(x_packed, weight, bias=None, *, neg_slope=0.2):
    """packed_equalized_conv3x3(s2d(packed_avg_pool2(x))) as one conv:
    (B, 4Ci, m, m) -> (B, 4Co, m/2, m/2)."""
    wf = fuse_pool2_conv3x3_weight(weight, _eq_scale3x3(weight, neg_slope))
    b = None if bias is None else bias.repeat(4).to(x_packed.dtype)
    return F.conv2d(x_packed, wf.to(x_packed.dtype), b, stride=2, padding=1)


def pool2_unpacked_equalized_conv3x3(x_packed, weight, bias=None, *,
                                     neg_slope=0.2):
    """equalized conv3x3(packed_avg_pool2(x), padding 1) as one conv:
    (B, 4Ci, m, m) -> (B, Co, m, m)."""
    co, ci = weight.shape[:2]
    w = weight * (0.25 * _eq_scale3x3(weight, neg_slope))
    wf = w[:, None, None].expand(co, 2, 2, ci, 3, 3).reshape(co, 4 * ci, 3, 3)
    b = None if bias is None else bias.to(x_packed.dtype)
    return F.conv2d(x_packed, wf.to(x_packed.dtype), b, padding=1)


# --------------------------------------------------------------------------
# The 2x4 layout: a second, W-only pack over the 2x2 one
# --------------------------------------------------------------------------
#
# A packed conv's output column J of W-parity b2 reads 2x2 columns
# 2J + b2 + q1 for its taps q1 in {-1, 0, 1}; (Q2, b2') = divmod(b2 + q1, 2)
# maps each (b2, q1) to one 2x4 tap and input parity, so the 2x4 kernel is
# a collision-free scatter of the 2x2 one, 3x3 again, and its zero padding
# is exact (derivation in the JAX module).

def space_to_depth_w(x):
    """(B, K, H, W) -> (B, 2K, H, W/2), channel order (b2, k)."""
    b, k, h, w = x.shape
    x = x.reshape(b, k, h, w // 2, 2)
    return x.permute(0, 4, 1, 2, 3).reshape(b, 2 * k, h, w // 2)


def depth_to_space_w(x):
    """(B, 2K, H, W) -> (B, K, H, 2W), inverse of space_to_depth_w."""
    b, k2, h, w = x.shape
    x = x.reshape(b, 2, k2 // 2, h, w)
    return x.permute(0, 2, 3, 4, 1).reshape(b, k2 // 2, h, 2 * w)


def space_to_depth8(x):
    """(B, C, H, W) -> (B, 8C, H/2, W/4) in one copy, channel order
    (b2, a, b1, i): space_to_depth_w(space_to_depth(x))."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 4, 2, 2)   # (i, p, a, q, b2, b1)
    x = x.permute(0, 5, 3, 6, 1, 2, 4)            # (b2, a, b1, i, p, q)
    return x.reshape(b, 8 * c, h // 2, w // 4)


def depth_to_space8(x):
    """(B, 8C, H, W) -> (B, C, 2H, 4W), inverse of space_to_depth8."""
    b, c8, h, w = x.shape
    c = c8 // 8
    x = x.reshape(b, 2, 2, 2, c, h, w)            # (b2, a, b1, i, p, q)
    x = x.permute(0, 4, 5, 2, 6, 1, 3)            # (i, p, a, q, b2, b1)
    return x.reshape(b, c, 2 * h, 4 * w)


def pack_conv3x3_weight_w(w4):
    """Packed kernel (K_o, K_i, 3, 3) -> the 2x4 kernel (2K_o, 2K_i, 3, 3)
    such that conv(s2dw(x), W8, padding=1) == s2dw(conv(x, W4,
    padding=1)); exact, as pack_conv3x3_weight."""
    ko, ki = w4.shape[:2]
    with precision_scope('highest'):
        out = torch.einsum('qcbt,oipt->bocipq',
                           _const('pack_w', w4.dtype, w4.device), w4)
    return out.reshape(2 * ko, 2 * ki, 3, 3)


def packed8_equalized_conv3x3(x_p8, weight, bias=None, *, neg_slope=0.2):
    """Equalized-LR 3x3 conv in the 2x4 layout; ``weight`` is the ORIGINAL
    (Co, Ci, 3, 3) kernel, ``bias`` the original (Co,)."""
    w8 = pack_conv3x3_weight_w(
        pack_conv3x3_weight(weight, _eq_scale3x3(weight, neg_slope)))
    b = None if bias is None else bias.repeat(8).to(x_p8.dtype)
    return F.conv2d(x_p8, w8.to(x_p8.dtype), b, padding=1)


def packed8_conv1x1(x_p8, weight, bias=None):
    """1x1 conv on each of the 2x4 layout's 8 parity groups: block-diagonal
    over the 8 groups.  ``weight`` is the original (Co, Ci, 1, 1)."""
    co, ci = weight.shape[:2]
    wb = torch.block_diag(*[weight.reshape(co, ci)] * 8)
    b = None if bias is None else bias.repeat(8).to(x_p8.dtype)
    return F.conv2d(x_p8, wb.reshape(8 * co, 8 * ci, 1, 1).to(x_p8.dtype), b)


# --------------------------------------------------------------------------
# The native 2x4 level boundaries
# --------------------------------------------------------------------------
#
# D: the fused pool kernel reads 2x2 columns 2c + tx - 1, tx in 0..3.  With
# 2x4 output columns (c = 2J + b2o) the input column 2*j8 + b2i has
# (j8 - 2J, b2i) = divmod(2*b2o + tx - 1, 2): a 4-tap stride-2 window over
# 2x4 columns; with 2x2 output columns (the region's exit) divmod(tx - 1,
# 2): 3 taps, stride 1 along W (H keeps stride 2).  G: the fused up-conv's
# 2x2 output column K = 2*K8 + b2 reads edge-padded input columns K + dx,
# i.e. 2*K8 + tx - 1 with tx = b2 + dx + 1: a 4-tap stride-2 window.
# Both scatters are collision-free (derivations in the JAX module).

def fuse_pool2_conv3x3_weight_w8(w, scale=1.0):
    """OIHW (Co, Ci, 3, 3) kernel -> the fused pool + conv kernel for 2x4
    input and output (8Co, 8Ci, 4, 4), strides (2, 2), padding 1."""
    k4 = fuse_pool2_conv3x3_weight(w, scale)
    ko, ki = k4.shape[:2]
    with precision_scope('highest'):
        out = torch.einsum('qcbt,oipt->bocipq',
                           _const('pool_w8', w.dtype, w.device), k4)
    return out.reshape(2 * ko, 2 * ki, 4, 4)


def fuse_pool2_conv3x3_weight_w8_out4(w, scale=1.0):
    """OIHW (Co, Ci, 3, 3) kernel -> the fused pool + conv kernel for 2x4
    input and 2x2 output (4Co, 8Ci, 4, 3), strides (2, 1), padding 1: the
    2x4 region's exit."""
    k4 = fuse_pool2_conv3x3_weight(w, scale)
    ko, ki = k4.shape[:2]
    with precision_scope('highest'):
        out = torch.einsum('qct,oipt->ocipq',
                           _const('pool_w8_out4', w.dtype, w.device), k4)
    return out.reshape(ko, 2 * ki, 4, 3)


def pool2_equalized_conv3x3_p8(x_p8, weight, bias=None, *, neg_slope=0.2,
                               out_packed8=True):
    """D's level boundary in the 2x4 layout: the 2x4 rep of resolution R,
    (B, 8Ci, R/2, R/4), to the 2x4 rep of R/2, (B, 8Co, R/4, R/8), or
    with ``out_packed8=False`` the 2x2 rep, (B, 4Co, R/4, R/4).  The
    function of pool2_equalized_conv3x3 on the repacked operands."""
    scale = _eq_scale3x3(weight, neg_slope)
    if out_packed8:
        wf, stride, n = fuse_pool2_conv3x3_weight_w8(weight, scale), (2, 2), 8
    else:
        wf, stride, n = (fuse_pool2_conv3x3_weight_w8_out4(weight, scale),
                         (2, 1), 4)
    b = None if bias is None else bias.repeat(n).to(x_p8.dtype)
    return F.conv2d(x_p8, wf.to(x_p8.dtype), b, stride=stride, padding=1)


def fuse_up2_conv3x3_weight_w8(w, scale=1.0):
    """OIHW (Co, Ci, 3, 3) kernel -> the fused upsample + conv kernel
    emitting the 2x4 layout, (8Co, Ci, 3, 4): H stride 1, W stride 2 over
    the edge-padded input."""
    wf = fuse_up2_conv3x3_weight(w, scale)               # (4Co, Ci, 3, 3)
    co4, ci = wf.shape[:2]
    with precision_scope('highest'):
        out = torch.einsum('qbt,oipt->boipq',
                           _const('up2_w8', w.dtype, w.device), wf)
    return out.reshape(2 * co4, ci, 3, 4)


def up2_equalized_conv3x3_p8(x, weight, *, neg_slope=0.2):
    """s2dw(up2_equalized_conv3x3(x)) as one conv: G's level boundary
    emitting the 2x4 layout.  ``x`` is UNPACKED (B, Ci, n, n), n even and
    >= 2; the output is the 2x4 rep of resolution 2n, (B, 8Co, n, n/2).
    The border bands are up2_equalized_conv3x3's (the same float
    expressions, ``_up2_border``), their columns split into (K8, b2)."""
    b, _, n, n2 = x.shape
    if n != n2 or n < 2 or n % 2:
        raise ValueError(f'fused up2-conv into the 2x4 layout needs a '
                         f'square input of even side, got {tuple(x.shape)}')
    scale = _eq_scale3x3(weight, neg_slope)
    co, m = weight.shape[0], n // 2
    y = F.conv2d(edge_pad1(x),
                 fuse_up2_conv3x3_weight_w8(weight, scale).to(x.dtype),
                 stride=(1, 2))
    w_s = weight * scale
    # an output line (B, Co, 2n) of the original grid as its two parities
    # (B, 2, Co, n): position 2K + q -> parity q at K
    par = lambda t: t.reshape(b, co, n, 2).permute(0, 3, 1, 2)  # noqa: E731
    top, bot = (par(t) for t in _up2_border(x, w_s, 2))
    lf, rt = (par(t) for t in _up2_border(x, w_s, 3))
    # y's channels (b2, p, q, o), spatial (J, K8): 2x2 column K = 2*K8 + b2
    yv = y.view(b, 2, 2, 2, co, n, m)

    def by_b2(t):
        # (B, q, Co, K) -> (B, b2, q, Co, K8)
        return t.reshape(b, 2, co, m, 2).permute(0, 4, 1, 2, 3)

    # written over the conv's output, which its backward does not need;
    # the columns claim the corners, as in the JAX package
    yv[:, :, 0, :, :, 0] = by_b2(top)                          # p=0, J=0
    yv[:, :, 1, :, :, n - 1] = by_b2(bot)                      # p=1, J=n-1
    yv[:, 0, :, 0, :, :, 0] = lf                    # K=0: b2=0, q=0, K8=0
    yv[:, 1, :, 1, :, :, m - 1] = rt                # K=2n-1: b2=1, q=1
    return y
