"""The port's fast augmentation (crop-fused, resize first) and its shear
warp against the JAX package, on the CPU, with the JAX package's random
draws injected into the port (``jax_augment_draws``, taken over the frame
the warp sees: ``warp_frame``).

Tolerances.  Images in [-1, 1]: atol 1e-5 (float32; the nearest-pixel
indices must agree for that to hold).  The shear warp against the JAX
package's ``_shear_warp_nearest`` (its butterfly of static shifts): equal
bit for bit on every pixel except where one of the three shear shifts,
before rounding, lies within 1e-5 of a half-integer in the JAX
computation (a, b, dx and dy come from XLA's tan/sin/cos there and from
torch's here, and a last-ulp difference moves a value that lies on a
rounding tie); such pixels are counted and must stay under 0.1% of the
window.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuron_gan_tpu.data.augment import (
    AugmentSpec as JAugmentSpec, _affine_warp_nearest as j_affine_warp,
    _shear_warp_nearest as j_shear_warp, augment_batch as j_augment_batch)

import neuron_gan_tpu_torch.data.augment as aug
from neuron_gan_tpu_torch.data.augment import AugmentSpec, augment_batch, warp_frame

from test_torch_data import jax_augment_draws, stack

TIE = 1e-5


def one_draw(angle, tx, ty, flip):
    return (torch.tensor([angle], dtype=torch.float32),
            torch.tensor([tx], dtype=torch.float32),
            torch.tensor([ty], dtype=torch.float32), torch.tensor([flip]))


def port_image(img_hw):
    """(P, P) numpy -> the port's (1, 1, P, P)."""
    return torch.from_numpy(np.ascontiguousarray(img_hw))[None, None]


def jax_shifts(p, window, angle, tx, ty, flip):
    """The three shear shifts before rounding at every window pixel, (3, S,
    S), in the JAX package's computation: its a, b, dx, dy as
    _shear_warp_nearest computes them (XLA), the chain in float32 as
    tests/test_data.py's _shear_reference takes it, rows reversed for the
    flip."""
    top, s = window
    f32 = np.float32
    rad = jnp.float32(angle) * (np.pi / 180.0)
    quarter = jnp.round(rad / (np.pi / 2.0))
    res = rad - quarter * (np.pi / 2.0)
    a, b = f32(jnp.tan(res / 2.0)), f32(-jnp.sin(res))
    cos_r, sin_r = jnp.cos(res), jnp.sin(res)
    dx = f32(-(cos_r * jnp.float32(tx) + sin_r * jnp.float32(ty)))
    dy = f32(sin_r * jnp.float32(tx) - cos_r * jnp.float32(ty))
    c = (p - 1) / 2.0
    idx = np.arange(s)
    yc = ((idx + top) - c).astype(f32)[:, None]
    xc = ((idx + top) - c).astype(f32)[None, :]
    u3 = np.broadcast_to(a * yc, (s, s))
    x3 = xc + np.round(a * yc)
    u2 = b * x3 + dy
    y1 = yc + np.round(u2)
    u1 = a * y1 + (dx - a * dy)
    u = np.stack([u3, u2, u1]).astype(f32)
    return u[:, ::-1] if flip else u


def ties(u):
    """Window pixels where any shift before rounding lies within TIE of a
    half-integer."""
    return (np.abs(u - np.floor(u) - 0.5) < TIE).any(axis=0)


# ---------------------------------------------------------------------------
# the windowed gather warp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('p,top,size', [(24, 4, 16), (25, 4, 16), (16, 0, 16),
                                        (36, 6, 24), (48, 16, 16)])
@pytest.mark.parametrize('seed', [0, 1])
def test_windowed_gather_equals_the_full_warp_sliced(p, top, size, seed):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.random((3, 1, p, p)).astype(np.float32))
    angle = torch.from_numpy(rng.uniform(-180, 180, 3).astype(np.float32))
    tx, ty = (torch.from_numpy(np.round(rng.uniform(-2, 2, 3)).astype(np.float32))
              for _ in range(2))
    flip = torch.tensor([True, False, True])
    full = aug._affine_warp_nearest(img, angle, tx, ty, flip)
    got = aug._affine_warp_nearest(img, angle, tx, ty, flip, window=(top, size))
    assert torch.equal(got, full[:, :, top:top + size, top:top + size])
    # and the JAX package's windowed warp, image by image
    for i in range(3):
        want = j_affine_warp(jnp.asarray(img[i, 0, :, :, None].numpy()), angle[i].item(),
                             tx[i].item(), ty[i].item(), bool(flip[i]), window=(top, size))
        np.testing.assert_allclose(got[i, 0].numpy(), np.asarray(want)[..., 0],
                                   rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the shear warp
# ---------------------------------------------------------------------------

SWEEP_FRAMES = [(24, 16), (20, 16), (16, 16), (48, 16), (36, 24)]
SWEEP_ANGLES = [-179.3, -135.0, -89.9, -45.2, -44.8, -1.0, 0.4, 43.9, 45.1,
                90.2, 136.6, 178.2]


@pytest.mark.parametrize('p,s', SWEEP_FRAMES)
@pytest.mark.parametrize('angle', SWEEP_ANGLES)
def test_shear_warp_matches_jax_geometry_sweep(p, s, angle):
    # tests/test_data.py's sweep (frames that pad the JAX canvas and
    # frames that crop it, residuals near +-45 degrees), each angle at a
    # drawn translation and at both largest-magnitude ones
    rng = np.random.default_rng(int(1000 * (angle + 180)) + p * 31 + s)
    img = rng.random((p, p)).astype(np.float32)
    top, max_t = (p - s) // 2, 0.05 * p
    t_max = float(np.round(max_t))
    drawn = (float(np.round(rng.uniform(-max_t, max_t))),
             float(np.round(rng.uniform(-max_t, max_t))), bool(rng.integers(2)))
    n_ties = n_pixels = 0
    for tx, ty, flip in (drawn, (t_max, -t_max, False), (-t_max, t_max, True)):
        want = np.asarray(j_shear_warp(
            jnp.asarray(img[..., None]), jnp.float32(angle), jnp.float32(tx),
            jnp.float32(ty), jnp.asarray(flip), window=(top, s), max_t=max_t))[..., 0]
        got = aug._shear_warp_nearest(port_image(img), *one_draw(angle, tx, ty, flip),
                                      window=(top, s))[0, 0].numpy()
        tie = ties(jax_shifts(p, (top, s), angle, tx, ty, flip))
        assert np.array_equal(got[~tie], want[~tie]), (tx, ty, flip)
        n_ties += int(tie.sum())
        n_pixels += tie.size
    assert n_ties < 1e-3 * n_pixels, (n_ties, n_pixels)


@pytest.mark.parametrize('angle', [0.0, 90.0, -90.0, 180.0, -180.0])
def test_shear_warp_equals_gather_warp_at_quarter_turns(angle):
    # no residual angle: a permutation, exactly the gather warp's (port
    # and JAX package)
    img = np.random.default_rng(3).random((24, 24)).astype(np.float32)
    for tx, ty, flip in [(0.0, 0.0, False), (2.0, -3.0, True), (-1.0, 1.0, False)]:
        draw = one_draw(angle, tx, ty, flip)
        shear = aug._shear_warp_nearest(port_image(img), *draw, window=(4, 16))
        gather = aug._affine_warp_nearest(port_image(img), *draw, window=(4, 16))
        assert torch.equal(shear, gather), (tx, ty, flip)
        want = j_affine_warp(jnp.asarray(img[..., None]), jnp.float32(angle),
                             jnp.float32(tx), jnp.float32(ty), jnp.asarray(flip),
                             window=(4, 16))
        assert np.array_equal(shear[0, 0].numpy(), np.asarray(want)[..., 0])


def test_shear_source_shifts_are_the_jax_chain():
    # the shifts the port rounds are the JAX computation's, to float32
    # rounding of a, b, dx, dy (tan/sin/cos of two libraries)
    for angle, tx, ty, flip in [(37.0, 2.0, -1.0, False), (-120.0, -3.0, 3.0, True)]:
        _, _, u = aug.shear_source(24, (4, 16), *one_draw(angle, tx, ty, flip))
        np.testing.assert_allclose(u[:, 0].numpy(),
                                   jax_shifts(24, (4, 16), angle, tx, ty, flip),
                                   rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the fast augment_batch
# ---------------------------------------------------------------------------

FAST_CASES = [  # (frame, crop, out, translation, augment)
    (24, 16, 16, 0.05, True),
    (24, 16, 8, 0.05, True),
    (48, 32, 8, 0.1, True),
    (48, 32, 32, 0.05, True),
    (48, 32, 16, 0.05, True),
    (25, 16, 16, 0.05, True),     # odd margin at out = crop
    (25, 16, 4, 0.0, True),       # odd raw margin below the crop size
    (26, 16, 8, 0.05, True),      # phase-scale margin parity flipped
    (24, 16, 8, 0.05, False),
]


@pytest.mark.parametrize('frame,crop,out,translation,augment', FAST_CASES)
@pytest.mark.parametrize('shear', [False, True])
@pytest.mark.parametrize('seed', [0, 1])
def test_fast_augment_batch_matches_jax(frame, crop, out, translation, augment,
                                        shear, seed):
    images = stack(4, frame, seed)
    kw = dict(crop_size=crop, out_size=out, translation=translation,
              augment=augment, fast=True, shear=shear)
    jspec, spec = JAugmentSpec(**kw), AugmentSpec(**kw)
    key = jax.random.PRNGKey(200 + seed)
    want = np.asarray(j_augment_batch(jnp.asarray(images), key, jspec))
    draws = (jax_augment_draws(key, 4, frame, jspec)
             if augment else None)
    got = augment_batch(torch.from_numpy(images), draws, spec)
    assert got.shape == (4, 1, out, out)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize('frame,crop,out,shear,want', [
    (24, 16, 16, False, 24), (24, 16, 8, False, 12), (48, 32, 8, True, 12),
    (768, 512, 256, True, 384), (768, 512, 16, True, 24),
    (26, 16, 8, False, 13), (26, 16, 8, True, 14),      # parity kept even
    (25, 16, 8, True, 12),                              # odd raw margin
])
def test_warp_frame_is_the_phase_scale_frame(frame, crop, out, shear, want):
    spec = AugmentSpec(crop_size=crop, out_size=out, fast=True, shear=shear)
    assert warp_frame(spec, frame) == want
    assert warp_frame(AugmentSpec(crop_size=crop, out_size=out), frame) == frame


def test_odd_margin_takes_the_gather_warp_and_is_counted():
    # JAX's rule (augment.py:311-321): an odd margin cannot take the shear
    # warp, whose flip is a reversal of the centred window's rows
    images = torch.from_numpy(stack(2, 21, 5))
    key = jax.random.PRNGKey(0)
    spec = AugmentSpec(crop_size=16, out_size=16, translation=0.05, fast=True,
                       shear=True)
    draws = jax_augment_draws(key, 2, 21, spec)
    aug.shear_fallbacks.clear()
    got = augment_batch(images, draws, spec)
    assert aug.shear_fallbacks == {(21, 16): 1}
    gather = augment_batch(images, draws, AugmentSpec(
        crop_size=16, out_size=16, translation=0.05, fast=True))
    assert torch.equal(got, gather)
    aug.shear_fallbacks.clear()
    augment_batch(images, draws, dataclasses.replace(spec, crop_size=17, out_size=17))
    assert not aug.shear_fallbacks



def test_resize_runs_with_tf32_off_whatever_the_caller_allows(monkeypatch):
    # as the JAX package's HIGHEST resize einsums: the fast path resizes
    # the padded stack inside a precision=None step
    from neuron_gan_tpu_torch.ops.resize import resize_antialias
    from neuron_gan_tpu_torch.runtime import precision_scope
    seen, matmul = [], torch.matmul

    def spy(a, b):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return matmul(a, b)

    monkeypatch.setattr(torch, 'matmul', spy)
    with precision_scope(None):
        resize_antialias(torch.rand(1, 1, 12, 12), 8)
        assert torch.backends.cuda.matmul.allow_tf32
    assert seen == [(False, False)] * 2
