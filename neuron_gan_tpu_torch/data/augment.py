"""Batch data augmentation on the device (counterpart of
neuron_gan_tpu/data/augment.py, the reference-exact path).

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

Drawing is separate from computing: ``draw_augment`` takes the random
parameters from a torch.Generator, and ``augment_batch`` is a function of
the images and those draws, so tests can inject the JAX package's draws.
The fused fast path and the shear warp are ROADMAP A6.2-3.
"""

import dataclasses
import math

import torch

from neuron_gan_tpu_torch.ops.resize import resize_antialias


@dataclasses.dataclass(frozen=True)
class AugmentSpec:
    crop_size: int            # CenterCrop target (= dataset image_size_max)
    out_size: int             # current phase resolution
    translation: float = 0.0  # RandomAffine translate fraction
    augment: bool = True      # False = crop + renorm + resize only
    degrees: float = 180.0
    fast: bool = False
    shear: bool = False

    def __post_init__(self):
        if self.shear and not self.fast:
            # as the JAX package: the exact order has no shear path, and a
            # silent fall-through would run the gather warp while the
            # caller believes it selected shear
            raise ValueError('AugmentSpec.shear requires fast=True '
                             '(the reference-exact order has no shear path)')
        if self.fast:
            raise NotImplementedError(
                'the fast/shear augmentation is not ported yet '
                '(ROADMAP A6.2-3); use the exact path')


def draw_augment(rng: torch.Generator, batch: int, frame: int,
                 spec: AugmentSpec):
    """Per-image random parameters for ``augment_batch`` (tensors of shape
    (batch,) on ``rng``'s device), or None when ``spec.augment`` is off."""
    if not spec.augment:
        return None

    def uniform(lo, hi):
        u = torch.rand(batch, generator=rng, device=rng.device)
        return lo + (hi - lo) * u

    max_t = spec.translation * frame
    return {
        'angle': uniform(-spec.degrees, spec.degrees),
        'tx': torch.round(uniform(-max_t, max_t)),
        'ty': torch.round(uniform(-max_t, max_t)),
        'flip': uniform(0.0, 1.0) < 0.5,
        'brightness_first': uniform(0.0, 1.0) < 0.5,
        'brightness': uniform(0.75, 1.25),
        'contrast': uniform(0.75, 1.25),
    }


def _affine_warp_nearest(img, angle_deg, tx, ty, flip):
    """Warp (B, C, P, P): out[p] = img[R(-a)(p_c - t) + c], zero fill, with
    the vertical flip composed into the output row (torchvision F.affine on
    tensors: grid_sample nearest, align_corners=False)."""
    b, c, p, _ = img.shape
    c_half = (p - 1) / 2.0
    grid = torch.arange(p, dtype=torch.float32, device=img.device)
    ys_eff = torch.where(flip[:, None], (p - 1) - grid, grid)     # (B, P)
    uy_t = (ys_eff - c_half) - ty[:, None]                        # (B, P)
    ux_t = (grid - c_half)[None, :] - tx[:, None]                 # (B, P)
    rad = angle_deg * (math.pi / 180.0)
    cos = torch.cos(rad)[:, None, None]
    sin = torch.sin(rad)[:, None, None]
    # [b, y, x]: inverse rotation of the translated output coordinates
    qx = cos * ux_t[:, None, :] + sin * uy_t[:, :, None] + c_half
    qy = (-sin) * ux_t[:, None, :] + cos * uy_t[:, :, None] + c_half
    ix = torch.round(qx).long()
    iy = torch.round(qy).long()
    valid = (ix >= 0) & (ix < p) & (iy >= 0) & (iy < p)
    idx = iy.clamp(0, p - 1) * p + ix.clamp(0, p - 1)
    out = torch.gather(img.reshape(b, c, p * p), 2,
                       idx.reshape(b, 1, p * p).expand(b, c, p * p))
    out = out.reshape(b, c, p, p)
    return torch.where(valid[:, None], out, torch.zeros_like(out))


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


def augment_batch(images, draws, spec: AugmentSpec):
    """images (B, P, P, C) in [0, 1] -> (B, C, out, out) in [-1, 1]."""
    x = images.permute(0, 3, 1, 2)
    p = x.shape[-1]
    s = spec.crop_size
    if spec.augment:
        x = _affine_warp_nearest(x, draws['angle'], draws['tx'], draws['ty'],
                                 draws['flip'])
        x = _color_jitter(x, draws['brightness'], draws['contrast'],
                          draws['brightness_first'])
    top = int(round((p - s) / 2.0))  # CenterCrop: top = round((P - S) / 2)
    x = x[:, :, top:top + s, top:top + s] * 2.0 - 1.0
    if spec.out_size < s:
        x = resize_antialias(x, spec.out_size)
    return x.contiguous()
