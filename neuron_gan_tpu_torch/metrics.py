"""Sample-quality metrics: multi-scale sliced Wasserstein distance (SWD)
(counterpart of neuron_gan_tpu/metrics.py).

The PGGAN paper's evaluation metric (Karras et al. 2018, §5): compare the
distributions of local image patches between a generated set and the real
set, at every level of a Laplacian pyramid, via the sliced Wasserstein
distance — project patch descriptors onto random unit directions, sort both
sets, and average the L1 gap between the sorted projections.

Images are NCHW tensors in [-1, 1]; a patch descriptor is laid out
(patch, patch, channel), as the JAX package lays it out.  The random draws
(patch positions, projection directions) come from a torch.Generator, or
are passed in: JAX's and torch's random streams never agree, so the tests
hold this module against the JAX one on injected draws.
"""

import numpy as np
import torch

from neuron_gan_tpu_torch.runtime import precision_scope


def _downsample2(x):
    """2x2 average pooling — the pyramid's coarsening step."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def _upsample2(x):
    """Nearest x2 (cheap pyramid expand; adequate for band-pass residuals)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def laplacian_pyramid(x, n_levels):
    """List of band-pass levels, finest first; the last entry is the
    low-pass residual."""
    levels = []
    for _ in range(n_levels - 1):
        down = _downsample2(x)
        levels.append(x - _upsample2(down))
        x = down
    levels.append(x)
    return levels


def draw_patches(rng, x_shape, patch_size, n_patches):
    """Random patch positions (image, top, left), each (n_patches,) int64."""
    b, _, h, w = x_shape
    patch_size = min(patch_size, h, w)

    def randint(hi):
        return torch.randint(0, hi, (n_patches,), generator=rng,
                             device=rng.device)

    return randint(b), randint(h - patch_size + 1), randint(w - patch_size + 1)


def _extract_patches(x, idx, patch_size):
    """Patch descriptors at positions ``idx`` = (image, top, left):
    (n_patches, patch^2 * C), normalized per CHANNEL over the whole
    descriptor set (mean/std across all patches — Karras et al.'s
    finalize_descriptors)."""
    _, c, h, w = x.shape
    # levels smaller than the patch (early growth phases: 4x4) degrade to
    # whole-image "patches" instead of slicing out of bounds
    patch_size = min(patch_size, h, w)
    bi, yi, xi = (t.to(x.device) for t in idx)
    offs = torch.arange(patch_size, device=x.device)
    rows = (yi[:, None] + offs)[:, :, None]           # (n, p, 1)
    cols = (xi[:, None] + offs)[:, None, :]           # (n, 1, p)
    nhwc = x.permute(0, 2, 3, 1)
    patches = nhwc[bi[:, None, None], rows, cols]     # (n, p, p, c)
    mu = patches.mean(dim=(0, 1, 2), keepdim=True)
    sd = patches.std(dim=(0, 1, 2), keepdim=True, unbiased=False)
    return ((patches - mu) / (sd + 1e-8)).reshape(idx[0].shape[0], -1)


def draw_directions(rng, d, n_projections=128, dtype=torch.float32):
    """(d, n_projections) standard normals: the projections before
    normalization."""
    return torch.randn(d, n_projections, generator=rng, device=rng.device,
                       dtype=dtype)


def sliced_wasserstein(a, b, dirs):
    """SWD between two equally-sized descriptor sets (n, d) along the
    directions ``dirs`` (d, n_projections), normalized here: mean over the
    directions of the L1 distance between sorted 1-D projections."""
    dirs = dirs.to(a)
    dirs = dirs / (torch.linalg.norm(dirs, dim=0, keepdim=True) + 1e-12)
    pa = torch.sort(a @ dirs, dim=0).values
    pb = torch.sort(b @ dirs, dim=0).values
    return torch.mean(torch.abs(pa - pb))


def draw_swd(rng, real_shape, fake_shape, n_levels, patch_size=7,
             n_patches=2048, n_projections=128, n_repeats=4):
    """Every random draw of ``swd_multiscale``: for each repeat, for each
    pyramid level, the real and fake patch positions and the directions."""
    draws = []
    for _ in range(n_repeats):
        levels = []
        for lvl in range(n_levels):
            scale = 2 ** lvl
            rs = (*real_shape[:2], real_shape[2] // scale, real_shape[3] // scale)
            fs = (*fake_shape[:2], fake_shape[2] // scale, fake_shape[3] // scale)
            d = min(patch_size, rs[2], rs[3]) ** 2 * real_shape[1]
            levels.append({'real': draw_patches(rng, rs, patch_size, n_patches),
                           'fake': draw_patches(rng, fs, patch_size, n_patches),
                           'dirs': draw_directions(rng, d, n_projections)})
        draws.append(levels)
    return draws


def swd_levels(real, fake, levels_draws, patch_size=7):
    """Per-level SWD of one repeat on its draws (finest band first)."""
    out = []
    for r, f, dr in zip(laplacian_pyramid(real, len(levels_draws)),
                        laplacian_pyramid(fake, len(levels_draws)),
                        levels_draws):
        out.append(sliced_wasserstein(_extract_patches(r, dr['real'], patch_size),
                                      _extract_patches(f, dr['fake'], patch_size),
                                      dr['dirs']))
    return torch.stack(out)


def swd_multiscale(real, fake, rng=None, *, patch_size=7, n_patches=2048,
                   n_projections=128, n_levels=None, n_repeats=4, draws=None):
    """Multi-scale SWD between two NCHW image sets in [-1, 1].

    Returns (per_level, mean): per-pyramid-level SWD values (finest band
    first, low-pass last, numpy) and their mean — lower is better; 0 for
    identical sets.  ``n_repeats`` averages over independent patch /
    projection draws, taken from ``rng`` (a torch.Generator on the images'
    device) unless ``draws`` (``draw_swd``'s structure) are given.
    """
    real = real.float()
    fake = fake.float()
    assert real.shape[1:] == fake.shape[1:], (real.shape, fake.shape)
    res = int(real.shape[-1])
    if n_levels is None:
        # pyramid down to 16x16, like the paper's coarsest 16x16 level
        n_levels = max(1, int(np.log2(res)) - 3)
    if draws is None:
        draws = draw_swd(rng, real.shape, fake.shape, n_levels, patch_size,
                         n_patches, n_projections, n_repeats)
    # projections in true float32 whatever the caller's TF32 setting
    with torch.no_grad(), precision_scope('highest'):
        acc = sum(swd_levels(real, fake, d, patch_size) for d in draws)
    per_level = acc.cpu().double().numpy() / len(draws)
    return per_level, float(per_level.mean())
