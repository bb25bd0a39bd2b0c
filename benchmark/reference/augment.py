"""Plain PyTorch batch augmentation: the benchmark's reference.

The reference's per-image torchvision stack (data/NeuronDataset.py):
RandomAffine(degrees=180, translate=(t, t), fill=0) with nearest sampling
and the vertical flip folded in, ColorJitter(brightness=0.25,
contrast=0.25) in a random order, CenterCrop, (0, 1) -> (-1, 1), and an
antialiased Resize to the phase's resolution.  ``fast`` is the shipping
order of the port: the frame is resized to phase scale first, the jitter
comes before the warp, and the warp computes only the crop window; with
``shear`` the rotation is the three-shear decomposition (integer shifts
after the nearest quarter turn), which is a different nearest-neighbour
rule than the plain rotation and so part of the function computed.

Every index is computed in float32 in the order written below and rounded
half to even, so the same draws select the same source pixels on any
device.
"""

import math

import numpy as np
import torch


def shear_for(execution, out_size):
    """Whether an execution's augmentation takes the shear warp at a phase
    resolution: on its fast path, with ``shear_warp`` True, or 'auto' at
    every resolution but 32^2."""
    s = execution['shear_warp']
    return execution['fast_augment'] and (
        s is True or (s == 'auto' and out_size != 32))


def warp_frame(out_size, crop_size, frame, fast, shear):
    """Side of the frame the warp sees: the raw frame, or on the fast path
    below the crop size the frame resized to phase scale, plus one where
    the shear warp would otherwise meet an odd margin."""
    if not (fast and out_size < crop_size):
        return frame
    small = int(round(frame * out_size / crop_size))
    if shear and (small - out_size) % 2 and (frame - crop_size) % 2 == 0:
        small += 1
    return small


def resize_matrix(n_in, n_out):
    """(n_out, n_in) weights of an antialiased bilinear resize: half-pixel
    centres, a triangle filter of support max(1, n_in / n_out), each row
    normalised (torchvision's Resize(antialias=True))."""
    scale = n_in / n_out
    support = max(1.0, scale)
    inv = 1.0 / max(scale, 1.0)
    w = np.zeros((n_out, n_in))
    for i in range(n_out):
        centre = (i + 0.5) * scale
        lo = max(int(centre - support + 0.5), 0)
        hi = min(int(centre + support + 0.5), n_in)
        j = np.arange(lo, hi)
        v = np.clip(1.0 - np.abs((j + 0.5 - centre) * inv), 0.0, None)
        w[i, lo:hi] = v / v.sum()
    return w


def resize(x, n_out):
    """(B, C, H, H) -> (B, C, n_out, n_out), float32 products without TF32
    (the caller turns it off)."""
    n_in = x.shape[-1]
    if n_in == n_out:
        return x
    m = torch.tensor(resize_matrix(n_in, n_out), dtype=torch.float32,
                     device=x.device)
    return torch.matmul(torch.matmul(m, x), m.T)


def _gather(img, iy, ix):
    """out[b, :, y, x] = img[b, :, iy, ix], 0 off the frame."""
    b, c, p, _ = img.shape
    s = iy.shape[-1]
    inside = (iy >= 0) & (iy < p) & (ix >= 0) & (ix < p)
    flat = (iy.clamp(0, p - 1) * p + ix.clamp(0, p - 1)).reshape(b, 1, s * s)
    out = torch.gather(img.reshape(b, c, p * p), 2, flat.expand(b, c, s * s))
    out = out.reshape(b, c, s, s)
    return torch.where(inside[:, None], out, torch.zeros_like(out))


def rotate_source(p, top, size, angle, tx, ty, flip):
    """Source pixel (iy, ix) of each pixel of the size x size window at
    ``top`` of a p x p frame: out(y, x) = img(R(-angle) ((y', x) - c - t)
    + c), y' the row after the vertical flip, c = (p - 1) / 2."""
    c = (p - 1) / 2.0
    grid = torch.arange(size, dtype=torch.float32, device=angle.device) + top
    rows = torch.where(flip[:, None], (p - 1) - grid, grid)
    uy = (rows - c) - ty[:, None]
    ux = (grid - c)[None, :] - tx[:, None]
    rad = angle * (math.pi / 180.0)
    cos = torch.cos(rad)[:, None, None]
    sin = torch.sin(rad)[:, None, None]
    qx = cos * ux[:, None, :] + sin * uy[:, :, None] + c
    qy = (-sin) * ux[:, None, :] + cos * uy[:, :, None] + c
    return torch.round(qy).long(), torch.round(qx).long()


def shear_source(p, top, size, angle, tx, ty, flip):
    """Source pixel of each window pixel under the shear rotation: the
    quarter turn m = round(rad / (pi/2)) mod 4, the residual angle r in
    [-45, 45] degrees, a = tan(r/2), b = -sin(r); on centred window
    coordinates x3 = xc + round(a yc), y1 = yc + round(b x3 + dy),
    x0 = x3 + round(a y1 + (dx - a dy)), with (dx, dy) the translation
    turned by -r; then the quarter turn as an index permutation."""
    dev = angle.device
    rad = angle * (math.pi / 180.0)
    quarter = torch.round(rad / torch.tensor(math.pi / 2.0, device=dev))
    m = torch.remainder(quarter.to(torch.int64), 4)[:, None, None]
    r = rad - quarter * (math.pi / 2.0)
    a = torch.tan(r / 2.0)[:, None, None]
    b = (-torch.sin(r))[:, None, None]
    cos_r, sin_r = torch.cos(r), torch.sin(r)
    dx = (-(cos_r * tx + sin_r * ty))[:, None, None]
    dy = (sin_r * tx - cos_r * ty)[:, None, None]
    c = (p - 1) / 2.0
    k = torch.arange(size, device=dev)
    rows = torch.where(flip[:, None], (size - 1) - k, k)
    yc = (rows + top).to(torch.float32)[:, :, None] - c
    xc = (k + top).to(torch.float32)[None, None, :] - c
    x3 = xc + torch.round(a * yc)
    y1 = yc + torch.round(b * x3 + dy)
    x0 = x3 + torch.round(a * y1 + (dx - a * dy))
    jy, jx = (y1 + c).long(), (x0 + c).long()
    last = p - 1
    iy = torch.where(m == 0, jy, torch.where(
        m == 1, last - jx, torch.where(m == 2, last - jy, jx)))
    ix = torch.where(m == 0, jx, torch.where(
        m == 1, jy, torch.where(m == 2, last - jx, last - jy)))
    return iy, ix


def jitter(x, brightness, contrast, brightness_first):
    """Brightness and contrast in a per-image order, each clamped to
    [0, 1]; the contrast's mean is over the whole image."""
    bf = brightness.reshape(-1, 1, 1, 1)
    cf = contrast.reshape(-1, 1, 1, 1)

    def bright(v):
        return torch.clamp(v * bf, 0.0, 1.0)

    def contr(v):
        mean = v.mean(dim=(1, 2, 3), keepdim=True)
        return torch.clamp(cf * v + (1.0 - cf) * mean, 0.0, 1.0)

    return torch.where(brightness_first.reshape(-1, 1, 1, 1),
                       contr(bright(x)), bright(contr(x)))


def augment(images, draws, out_size, crop_size, augment=True, fast=False,
            shear=False):
    """images (B, P, P, C) in [0, 1] -> (B, C, out, out) in [-1, 1]."""
    x = images.permute(0, 3, 1, 2)
    if fast and out_size < crop_size:
        x = resize(x, warp_frame(out_size, crop_size, x.shape[-1], fast,
                                 shear))
        crop_size = out_size
    p, s = x.shape[-1], crop_size
    top = int(round((p - s) / 2.0))
    d = draws
    if augment and fast:
        x = jitter(x, d['brightness'], d['contrast'], d['brightness_first'])
        source = (shear_source if shear and (p - s) % 2 == 0
                  else rotate_source)
        x = _gather(x, *source(p, top, s, d['angle'], d['tx'], d['ty'],
                               d['flip']))
    else:
        if augment:
            x = _gather(x, *rotate_source(p, 0, p, d['angle'], d['tx'],
                                          d['ty'], d['flip']))
            x = jitter(x, d['brightness'], d['contrast'],
                       d['brightness_first'])
        x = x[:, :, top:top + s, top:top + s]
    x = x * 2.0 - 1.0
    if out_size < s:
        x = resize(x, out_size)
    return x
