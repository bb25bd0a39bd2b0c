"""Batch data augmentation on the device (counterpart of
neuron_gan_tpu/data/augment.py).

Reproduces the reference's per-item torchvision stack
(data/NeuronDataset.py:113-126 plus the progressive Resize at :152):

1. RandomAffine(degrees=180, translate=(t, t), fill=0): inverse-matrix warp
   about the image center, half-pixel convention, NEAREST sampling,
   translations drawn uniform then rounded to integers;
2. RandomVerticalFlip(p=0.5), folded into the warp;
3. ColorJitter(brightness=0.25, contrast=0.25): factors U(0.75, 1.25) in
   random order, each blend clamped to [0, 1]; the contrast mean is over
   the whole padded frame (jitter precedes the crop);
4. CenterCrop(crop_size);  5. (0, 1) -> (-1, 1);
6. antialiased Resize(out_size) when out_size < crop_size.

With ``fast`` (the JAX package's fast path) the padded stack is resized
to phase scale first, the jitter runs before the warp (its contrast mean
is then over the unwarped padded frame) and the warp computes only the
crop window.  With ``shear`` as well, the warp is the JAX package's
shear-decomposed rotation (three integer-shift shears after the nearest
quarter turn), computed here as its pointwise composition: one index
computation and one gather per batch, where the JAX package runs
butterfly passes of static shifts (a point gather is the TPU's slowest
op; on a GPU it is cheap).  An odd crop margin takes the windowed gather
warp instead, as there; ``shear_fallbacks`` counts those batches.

With ``mirror`` the augmentation is Karras et al.'s ``mirror_augment``
alone: each image flipped horizontally with probability 1/2, then the
centre crop, (0, 1) -> (-1, 1) and the resize; no warp, margin or
jitter, and one draw an image (``flip``).

Drawing is separate from computing: ``draw_augment`` takes the random
parameters from a torch.Generator, and ``augment_batch`` is a function of
the images and those draws, so tests can inject the JAX package's draws.
"""

import collections
import dataclasses
import functools
import math

import torch

from neuron_gan_tpu_torch.ops.resize import resize_antialias

# batches whose shear warp took the windowed gather warp (odd crop
# margin), by (frame, crop)
shear_fallbacks = collections.Counter()


@dataclasses.dataclass(frozen=True)
class AugmentSpec:
    crop_size: int            # CenterCrop target (= dataset image_size_max)
    out_size: int             # current phase resolution
    translation: float = 0.0  # RandomAffine translate fraction
    augment: bool = True      # False = crop + renorm + resize only
    degrees: float = 180.0
    fast: bool = False
    shear: bool = False
    mirror: bool = False      # the horizontal flip alone (the module doc)

    def __post_init__(self):
        if self.shear and not self.fast:
            # as the JAX package: the exact order has no shear path, and a
            # silent fall-through would run the gather warp while the
            # caller believes it selected shear
            raise ValueError('AugmentSpec.shear requires fast=True '
                             '(the reference-exact order has no shear path)')


def warp_frame(spec: AugmentSpec, frame: int) -> int:
    """Side of the frame the warp sees for a raw frame of side ``frame``:
    the raw frame, or on the fast path below the crop size the frame
    resized to phase scale, round(frame * out / crop), plus one where the
    shear warp would otherwise meet an odd margin that the raw frame does
    not have (the JAX package's augment_batch)."""
    if not (spec.fast and spec.out_size < spec.crop_size):
        return frame
    p_small = int(round(frame * spec.out_size / spec.crop_size))
    if (spec.shear and (p_small - spec.out_size) % 2
            and (frame - spec.crop_size) % 2 == 0):
        p_small += 1
    return p_small


def draw_augment(rng: torch.Generator, batch: int, frame: int,
                 spec: AugmentSpec):
    """Per-image random parameters for ``augment_batch`` on raw frames of
    side ``frame`` (tensors of shape (batch,) on ``rng``'s device), or None
    when ``spec.augment`` is off.  The translation range is a fraction of
    the frame the warp sees (``warp_frame``)."""
    if not spec.augment:
        return None

    def uniform(lo, hi):
        u = torch.rand(batch, generator=rng, device=rng.device)
        return lo + (hi - lo) * u

    if spec.mirror:
        return {'flip': uniform(0.0, 1.0) < 0.5}
    max_t = spec.translation * warp_frame(spec, frame)
    return {
        'angle': uniform(-spec.degrees, spec.degrees),
        'tx': torch.round(uniform(-max_t, max_t)),
        'ty': torch.round(uniform(-max_t, max_t)),
        'flip': uniform(0.0, 1.0) < 0.5,
        'brightness_first': uniform(0.0, 1.0) < 0.5,
        'brightness': uniform(0.75, 1.25),
        'contrast': uniform(0.75, 1.25),
    }


def affine_source(p, window, angle_deg, tx, ty, flip):
    """The gather warp's source pixel for every output pixel of frames of
    side ``p``: (iy, ix, coords), ``iy``/``ix`` (B, S, S) int64 (off the
    frame: zero fill) and ``coords`` their values before rounding, (2, B,
    S, S).  out[p] = img[R(-a)(p_c - t) + c] with the vertical flip
    composed into the output row (torchvision F.affine on tensors:
    grid_sample nearest, align_corners=False), over the whole frame or,
    with ``window=(top, size)``, its centred size x size block."""
    top, size = (0, p) if window is None else window
    c_half = (p - 1) / 2.0
    grid = torch.arange(size, dtype=torch.float32,
                        device=angle_deg.device) + top
    ys_eff = torch.where(flip[:, None], (p - 1) - grid, grid)     # (B, S)
    uy_t = (ys_eff - c_half) - ty[:, None]                        # (B, S)
    ux_t = (grid - c_half)[None, :] - tx[:, None]                 # (B, S)
    rad = angle_deg * (math.pi / 180.0)
    cos = torch.cos(rad)[:, None, None]
    sin = torch.sin(rad)[:, None, None]
    # [b, y, x]: inverse rotation of the translated output coordinates
    qx = cos * ux_t[:, None, :] + sin * uy_t[:, :, None] + c_half
    qy = (-sin) * ux_t[:, None, :] + cos * uy_t[:, :, None] + c_half
    return (torch.round(qy).long(), torch.round(qx).long(),
            torch.stack([qy, qx]))


def _affine_warp_nearest(img, angle_deg, tx, ty, flip, window=None):
    """Warp (B, C, P, P) (``affine_source``); ``window=(top, size)``
    computes only the centred block: the values of warping the whole
    frame and slicing ``[top:top + size, top:top + size]``."""
    iy, ix, _ = affine_source(img.shape[-1], window, angle_deg, tx, ty, flip)
    return _gather(img, iy, ix)


def _gather(img, iy, ix):
    """out[b, :, y, x] = img[b, :, iy, ix] where (iy, ix) lies in the
    frame, else 0; ``iy``, ``ix`` (B, S, S)."""
    b, c, p, _ = img.shape
    size = iy.shape[-1]
    valid = (ix >= 0) & (ix < p) & (iy >= 0) & (iy < p)
    idx = iy.clamp(0, p - 1) * p + ix.clamp(0, p - 1)
    n = size * size
    out = torch.gather(img.reshape(b, c, p * p), 2,
                       idx.reshape(b, 1, n).expand(b, c, n))
    out = out.reshape(b, c, size, size)
    return torch.where(valid[:, None], out, torch.zeros_like(out))


@functools.lru_cache(maxsize=None)
def _half_pi(device):
    # cached per device: a host-to-device copy in every step would make
    # the host wait, and a CUDA graph cannot capture it
    return torch.tensor(math.pi / 2.0, device=device)


def shear_source(p, window, angle_deg, tx, ty, flip):
    """The shear warp's source pixel for every window pixel of frames of
    side ``p``: (iy, ix, shifts), ``iy``/``ix`` (B, S, S) int64 in the
    frame's coordinates (off the frame: zero fill), ``shifts`` the three
    shear shifts before rounding, each broadcast to (B, S, S).

    The JAX package's _shear_warp_nearest as its pointwise composition
    (tests/test_data.py's _shear_reference): the residual angle
    res = rad - quarter * pi/2 in [-45, 45] degrees, a = tan(res/2),
    b = -sin(res); on centred coordinates (xc, yc) of the window
    x3 = xc + round(a*yc), y1 = yc + round(b*x3 + dy),
    x0 = x3 + round(a*y1 + (dx - a*dy)), in float32 in that order; the
    quarter turn, an exact permutation, is folded into the index and the
    vertical flip is a reversal of the window's rows."""
    top, s = window
    dev = angle_deg.device
    rad = angle_deg * (math.pi / 180.0)
    # a true division, as JAX's (CUDA multiplies by the reciprocal of a
    # Python-number divisor)
    quarter = torch.round(rad / _half_pi(dev))
    m = torch.remainder(quarter.to(torch.int64), 4)[:, None, None]
    res = rad - quarter * (math.pi / 2.0)
    a = torch.tan(res / 2.0)[:, None, None]
    b = (-torch.sin(res))[:, None, None]
    cos_r, sin_r = torch.cos(res), torch.sin(res)
    dx = (-(cos_r * tx + sin_r * ty))[:, None, None]
    dy = (sin_r * tx - cos_r * ty)[:, None, None]
    c = (p - 1) / 2.0
    r = torch.arange(s, device=dev)
    rows = torch.where(flip[:, None], (s - 1) - r, r)                # (B, S)
    yc = (rows + top).to(torch.float32)[:, :, None] - c           # (B, S, 1)
    xc = (r + top).to(torch.float32)[None, None, :] - c           # (1, 1, S)
    u3 = a * yc
    x3 = xc + torch.round(u3)
    u2 = b * x3 + dy
    y1 = yc + torch.round(u2)
    u1 = a * y1 + (dx - a * dy)
    x0 = x3 + torch.round(u1)
    jy, jx = (y1 + c).long(), (x0 + c).long()
    # img_m[jy, jx] = img[iy, ix] for the frame turned by m quarter turns
    iy = torch.where(m == 0, jy, torch.where(m == 1, (p - 1) - jx,
                     torch.where(m == 2, (p - 1) - jy, jx)))
    ix = torch.where(m == 0, jx, torch.where(m == 1, jy,
                     torch.where(m == 2, (p - 1) - jx, (p - 1) - jy)))
    shape = x0.shape
    return iy, ix, torch.stack([u3.expand(shape), u2, u1])


def _shear_warp_nearest(img, angle_deg, tx, ty, flip, window):
    """Shear-warp the window of (B, C, P, P) (``shear_source``)."""
    iy, ix, _ = shear_source(img.shape[-1], window, angle_deg, tx, ty, flip)
    return _gather(img, iy, ix)


def _color_jitter(img, brightness, contrast, brightness_first):
    """Brightness/contrast jitter in per-image random order, clamp [0, 1]
    after each blend; the contrast mean is over the whole image."""
    bf = brightness.reshape(-1, 1, 1, 1)
    cf = contrast.reshape(-1, 1, 1, 1)

    def bright(x):
        return torch.clamp(x * bf, 0.0, 1.0)

    def contr(x):
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        return torch.clamp(cf * x + (1.0 - cf) * mean, 0.0, 1.0)

    return torch.where(brightness_first.reshape(-1, 1, 1, 1),
                       contr(bright(img)), bright(contr(img)))


def _mirror_batch(x, draws, spec: AugmentSpec):
    """The mirror-only augmentation of (B, C, P, P) in [0, 1]."""
    if spec.augment:
        x = torch.where(draws['flip'].reshape(-1, 1, 1, 1), x.flip(3), x)
    s = spec.crop_size
    top = int(round((x.shape[-1] - s) / 2.0))
    x = x[:, :, top:top + s, top:top + s] * 2.0 - 1.0
    if spec.out_size < s:
        x = resize_antialias(x, spec.out_size)
    return x.contiguous()


def augment_batch(images, draws, spec: AugmentSpec):
    """images (B, P, P, C) in [0, 1] -> (B, C, out, out) in [-1, 1]."""
    x = images.permute(0, 3, 1, 2)
    if spec.mirror:
        return _mirror_batch(x, draws, spec)
    if spec.fast and spec.out_size < spec.crop_size:
        # the fast path: resize first, then crop at phase scale
        x = resize_antialias(x, warp_frame(spec, x.shape[-1]))
        spec = dataclasses.replace(spec, crop_size=spec.out_size)
    p = x.shape[-1]
    s = spec.crop_size
    top = int(round((p - s) / 2.0))  # CenterCrop: top = round((P - S) / 2)
    if spec.augment and spec.fast:
        # jitter before the warp, and the warp only over the crop window
        x = _color_jitter(x, draws['brightness'], draws['contrast'],
                          draws['brightness_first'])
        warp = _affine_warp_nearest
        if spec.shear and (p - s) % 2 == 0:
            warp = _shear_warp_nearest
        elif spec.shear:
            shear_fallbacks[p, s] += 1
        x = warp(x, draws['angle'], draws['tx'], draws['ty'], draws['flip'],
                 window=(top, s))
    else:
        if spec.augment:
            x = _affine_warp_nearest(x, draws['angle'], draws['tx'],
                                     draws['ty'], draws['flip'])
            x = _color_jitter(x, draws['brightness'], draws['contrast'],
                              draws['brightness_first'])
        x = x[:, :, top:top + s, top:top + s]
    x = x * 2.0 - 1.0
    if spec.out_size < s:
        x = resize_antialias(x, spec.out_size)
    return x.contiguous()
