"""Resampling ops with exact torch semantics, NCHW.

Counterpart of neuron_gan_tpu/ops/resize.py:

* ``upsample2_bilinear``: ``F.interpolate(scale_factor=2, mode='bilinear')``
  with align_corners=False (reference models.py:257, :335, :507);
  ``up2_1d`` the same along one axis: the JAX package's shift-and-add
  ``_up2_1d``, which ``upsample2_bilinear`` takes in bfloat16;
* ``avg_pool`` / ``downsample2_bilinear``: 2x2 average pooling, which is
  what x0.5 bilinear with half-pixel centers computes;
* ``resize_antialias``: torchvision ``Resize(size, antialias=True)`` as two
  products with separable triangle-filter matrices (reference
  data/NeuronDataset.py:152);
* ``resize_nearest``: ``F.interpolate(size=...)``'s default nearest rule.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from neuron_gan_tpu_torch.runtime.device import precision_scope


def upsample2_bilinear(x):
    """NCHW x2 bilinear upsample, align_corners=False.  bfloat16 takes the
    shift-and-add form, one axis after the other, which rounds where the
    JAX package's does (after every product and sum); F.interpolate
    rounds once."""
    if x.dtype == torch.bfloat16:
        return up2_1d(up2_1d(x, 2), 3)
    return F.interpolate(x, scale_factor=2, mode='bilinear',
                         align_corners=False)


def up2_1d(x, dim):
    """Double the length of ``dim`` (2 or 3 of NCHW) with torch bilinear
    (align_corners=False): out[2k] = 0.25 x[k-1] + 0.75 x[k],
    out[2k+1] = 0.75 x[k] + 0.25 x[k+1], edge-clamped."""
    n = x.shape[dim]
    xp = F.pad(x, (1, 1, 0, 0) if dim == 3 else (0, 0, 1, 1), mode='replicate')
    x75 = 0.75 * x
    even = 0.25 * xp.narrow(dim, 0, n) + x75
    odd = x75 + 0.25 * xp.narrow(dim, 2, n)
    return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)


def avg_pool(x, k):
    """NCHW kxk average pooling (stride k); H and W divisible by k."""
    h, w = x.shape[-2:]
    if h % k or w % k:
        raise ValueError(f'avg_pool: {h}x{w} not divisible by {k}')
    return F.avg_pool2d(x, k)


def downsample2_bilinear(x):
    """x0.5 bilinear (align_corners=False) == 2x2 average pooling."""
    return avg_pool(x, 2)


@functools.lru_cache(maxsize=None)
def _resize_weights_np(in_size: int, out_size: int):
    """Antialiased-bilinear resize weights as a dense (out, in) matrix.

    ATen's upsample_*_aa rule: half-pixel centers, a triangle filter of
    support max(1, in/out), window bounds by int() truncation."""
    scale = in_size / out_size
    support = max(1.0, scale)
    inv_filter_scale = 1.0 / max(scale, 1.0)
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        js = np.arange(xmin, xmax)
        t = (js + 0.5 - center) * inv_filter_scale
        vals = np.clip(1.0 - np.abs(t), 0.0, None)
        s = vals.sum()
        if s > 0:
            vals = vals / s
        else:  # degenerate: nearest
            vals = np.zeros_like(vals)
            vals[np.argmin(np.abs(t))] = 1.0
        w[i, xmin:xmax] = vals
    w.setflags(write=False)
    return w


@functools.lru_cache(maxsize=None)
def _resize_weights(in_size, out_size, dtype, device):
    # cached per device: a host-to-device copy in every training step would
    # make the host wait for the device each time
    return torch.tensor(_resize_weights_np(in_size, out_size), dtype=dtype,
                        device=device)


def resize_antialias(x, out_size):
    """NCHW separable antialiased bilinear resize to (out_size, out_size)
    (or an (h, w) pair); plain bilinear when upscaling."""
    h, w = x.shape[-2:]
    oh, ow = (out_size, out_size) if isinstance(out_size, int) else out_size
    if (oh, ow) == (h, w):
        return x
    dtype = torch.promote_types(x.dtype, torch.float32)
    wh = _resize_weights(h, oh, dtype, x.device)
    ww = _resize_weights(w, ow, dtype, x.device)
    # TF32 off whatever the caller allows, as the JAX package's HIGHEST
    # einsums (a data-pipeline resize, not a layer)
    with precision_scope('highest'):
        y = torch.matmul(wh, x.to(dtype))      # (..., oh, w)
        y = torch.matmul(y, ww.T)              # (..., oh, ow)
    return y.to(x.dtype)


def resize_nearest(x, out_size):
    """NCHW nearest resize with torch's rule src = floor(i * in / out)."""
    h, w = x.shape[-2:]
    oh, ow = (out_size, out_size) if isinstance(out_size, int) else out_size
    hi = torch.arange(oh, device=x.device) * h // oh
    wi = torch.arange(ow, device=x.device) * w // ow
    return x[..., hi, :][..., wi]
