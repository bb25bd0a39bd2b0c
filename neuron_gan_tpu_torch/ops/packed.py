"""The 2x2 space-to-depth packed layout, NCHW.

Counterpart of the 2x2 part of neuron_gan_tpu/ops/packed.py (kept as a
copy: that module imports jax).  A packed tensor is (B, 4C, H/2, W/2): the
2x2 pixel block at (2p+a, 2q+b) moves into channels, with packed channel
index ``(a*2 + b) * C + i`` (parity-major, original channel minor) -- the
JAX package's channel order, so a grouped PixelNorm with 4 groups
normalizes each parity's C channels, as the unpacked PixelNorm does.

The transform is exact: a stride-1 zero-padded 3x3 conv on the original
grid equals a 3x3 conv on the packed grid with a scattered kernel
(``pack_conv3x3_weight``; derivation in the JAX module).  Parameters stay
in the original OIHW layout; the scatter is differentiable, so gradients
land on the original weights.
"""

import functools
import math

import numpy as np
import torch

from neuron_gan_tpu_torch.ops.equalized import calculate_gain
from neuron_gan_tpu_torch.ops.pixelnorm import pixel_norm
from neuron_gan_tpu_torch.ops.resize import upsample2_bilinear
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


_PACK_T = _pack_transfer_tensor()


@functools.lru_cache(maxsize=None)
def _pack_t(dtype, device):
    # cached per device: a host-to-device copy in every step would make
    # the host wait for the device
    return torch.tensor(_PACK_T, dtype=dtype, device=device)


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
                           _pack_t(w.dtype, w.device), w * scale)
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


def packed_pixel_norm(x_packed, eps=1e-8, f32_stats=False):
    """PixelNorm over the ORIGINAL channels: each parity group's C channels
    normalized on their own (the JAX package's packed_pixel_norm and
    packed_pixel_norm_mxu compute this same function)."""
    b, c4, h, w = x_packed.shape
    xg = x_packed.reshape(b * 4, c4 // 4, h, w)
    return pixel_norm(xg, eps, f32_stats=f32_stats).reshape(b, c4, h, w)


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
    the original resolution."""
    b, c4, h, w = x_packed.shape
    return x_packed.reshape(b, 4, c4 // 4, h, w).mean(dim=1)


def packed_upsample2_bilinear(x_packed):
    """x2 bilinear upsample in the packed domain: packed rep of res R in,
    packed rep of res 2R out (unpack, upsample, repack; exact)."""
    return space_to_depth(upsample2_bilinear(depth_to_space(x_packed)))
