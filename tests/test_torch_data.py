"""The port's augmentation and latent sampling against the JAX package, on
the CPU, with the JAX package's random draws injected into the port.

The JAX draws are recomputed from its keys exactly as
neuron_gan_tpu/data/augment.py consumes them (split per image, then
split(key, 5) and the jitter's split(k_j, 3)).  Tolerance: atol 1e-5 on
images in [-1, 1] (float32; the nearest-neighbour warp indices must agree
exactly for that to hold).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuron_gan_tpu.data.augment import (
    AugmentSpec as JAugmentSpec, augment_batch as j_augment_batch)
from neuron_gan_tpu.utils.latents import sample_latent_vec as j_sample_latent

from neuron_gan_tpu_torch.data.augment import (
    AugmentSpec, augment_batch, draw_augment, warp_frame)
from neuron_gan_tpu_torch.utils.latents import sample_latent_vec


def jax_augment_draws(key, batch, frame, spec):
    """The JAX package's per-image augmentation draws for ``key`` on raw
    frames of side ``frame``: its translation range is a fraction of the
    frame the warp sees (``warp_frame``, the fast path's phase-scale
    frame)."""
    out = {k: [] for k in ('angle', 'tx', 'ty', 'flip', 'brightness_first',
                           'brightness', 'contrast')}
    max_t = spec.translation * warp_frame(spec, frame)
    for k in jax.random.split(key, batch):
        k_a, k_t1, k_t2, k_f, k_j = jax.random.split(k, 5)
        k_order, k_b, k_c = jax.random.split(k_j, 3)
        out['angle'].append(jax.random.uniform(
            k_a, (), minval=-spec.degrees, maxval=spec.degrees))
        out['tx'].append(jnp.round(jax.random.uniform(
            k_t1, (), minval=-max_t, maxval=max_t)))
        out['ty'].append(jnp.round(jax.random.uniform(
            k_t2, (), minval=-max_t, maxval=max_t)))
        out['flip'].append(jax.random.bernoulli(k_f))
        out['brightness'].append(jax.random.uniform(k_b, (), minval=0.75, maxval=1.25))
        out['contrast'].append(jax.random.uniform(k_c, (), minval=0.75, maxval=1.25))
        out['brightness_first'].append(jax.random.bernoulli(k_order))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def stack(n, p, seed):
    rng = np.random.default_rng(seed)
    return rng.random((n, p, p, 1)).astype(np.float32)


CASES = [  # (frame, crop, out, translation, augment)
    (24, 16, 16, 0.05, True),
    (24, 16, 8, 0.05, True),
    (48, 32, 8, 0.1, True),
    (25, 16, 4, 0.0, True),
    (24, 16, 8, 0.05, False),
]


@pytest.mark.parametrize('frame,crop,out,translation,augment', CASES)
@pytest.mark.parametrize('seed', [0, 1])
def test_augment_batch_matches_jax_with_injected_draws(frame, crop, out,
                                                       translation, augment,
                                                       seed):
    images = stack(4, frame, seed)
    jspec = JAugmentSpec(crop_size=crop, out_size=out, translation=translation,
                         augment=augment)
    key = jax.random.PRNGKey(100 + seed)
    want = np.asarray(j_augment_batch(jnp.asarray(images), key, jspec))
    spec = AugmentSpec(crop_size=crop, out_size=out, translation=translation,
                       augment=augment)
    draws = jax_augment_draws(key, 4, frame, jspec) if augment else None
    got = augment_batch(torch.from_numpy(images), draws, spec)
    assert got.shape == (4, 1, out, out)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=0, atol=1e-5)


def test_augment_quarter_turn_flip_is_a_permutation():
    # 90 degrees, no translation, flip: every output pixel is a source pixel
    img = torch.arange(36, dtype=torch.float32).reshape(1, 6, 6, 1) / 36
    spec = AugmentSpec(crop_size=6, out_size=6, translation=0.0)
    draws = {'angle': torch.tensor([90.0]), 'tx': torch.zeros(1),
             'ty': torch.zeros(1), 'flip': torch.tensor([True]),
             'brightness_first': torch.tensor([True]),
             'brightness': torch.ones(1), 'contrast': torch.ones(1)}
    got = augment_batch(img, draws, spec)[0, 0]
    src = img[0, :, :, 0] * 2 - 1
    assert torch.equal(torch.sort(got.flatten()).values,
                       torch.sort(src.flatten()).values)
    assert not torch.equal(got, src)


def test_draw_augment_ranges_and_determinism():
    spec = AugmentSpec(crop_size=32, out_size=16, translation=0.05)
    a = draw_augment(torch.Generator().manual_seed(3), 64, 48, spec)
    b = draw_augment(torch.Generator().manual_seed(3), 64, 48, spec)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a['angle'].abs().max() <= 180
    assert a['tx'].abs().max() <= round(0.05 * 48)
    assert torch.equal(a['tx'], torch.round(a['tx']))
    assert 0.75 <= float(a['brightness'].min()) and float(a['contrast'].max()) <= 1.25
    assert a['flip'].dtype == torch.bool
    assert draw_augment(torch.Generator(), 4, 48, AugmentSpec(32, 16, augment=False)) is None


def test_shear_without_fast_raises_as_jax():
    # the exact order has no shear path: both packages refuse the pair
    with pytest.raises(ValueError, match='requires fast'):
        JAugmentSpec(crop_size=16, out_size=16, shear=True)
    with pytest.raises(ValueError, match='requires fast'):
        AugmentSpec(crop_size=16, out_size=16, shear=True)


def test_sample_latent_vec_semantics():
    z = sample_latent_vec(torch.Generator().manual_seed(0), (64, 16))
    torch.testing.assert_close(z.norm(dim=1), torch.ones(64), rtol=1e-6, atol=1e-6)
    # the clamp-then-normalize rule, on the same normals as JAX's
    key = jax.random.PRNGKey(5)
    want = np.asarray(j_sample_latent(key, (8, 4)))
    normals = np.asarray(jax.random.normal(key, (8, 4)))
    clamped = np.clip(normals, -5, 5)
    np.testing.assert_allclose(want, clamped / np.linalg.norm(clamped, axis=1,
                                                              keepdims=True),
                               rtol=1e-6)
    r = sample_latent_vec(torch.Generator().manual_seed(0), (1000, 3), mode='rand')
    assert -1 <= float(r.min()) and float(r.max()) <= 1
    with pytest.raises(ValueError):
        sample_latent_vec(torch.Generator(), (2, 2), mode='bogus')
