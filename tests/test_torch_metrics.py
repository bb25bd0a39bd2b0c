"""The port's SWD (metrics.py) against the JAX package's, on the CPU, on
the JAX package's own random draws (patch positions and projection
directions recomputed from its keys and injected): JAX's and torch's
random streams never agree.

Tolerances: the pyramid and the descriptors atol 1e-6 (float32, the same
operations); SWD values rtol 1e-5 (float32 matmul and mean, reordered
sums)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuron_gan_tpu import metrics as jm

from neuron_gan_tpu_torch import metrics as tm

from test_metrics import _structured_set


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()


def jax_patch_draws(key, shape_nhwc, patch_size, n_patches):
    """The (image, top, left) positions JAX's _extract_patches draws."""
    b, h, w, _ = shape_nhwc
    p = min(patch_size, h, w)
    k_img, k_y, k_x = jax.random.split(key, 3)
    return tuple(torch.from_numpy(np.asarray(a).astype(np.int64)) for a in (
        jax.random.randint(k_img, (n_patches,), 0, b),
        jax.random.randint(k_y, (n_patches,), 0, h - p + 1),
        jax.random.randint(k_x, (n_patches,), 0, w - p + 1)))


def jax_swd_draws(key, real, fake, n_levels, patch_size, n_patches,
                  n_projections, n_repeats):
    """Every draw of JAX's swd_multiscale, in draw_swd's structure."""
    pyr_r = jm.laplacian_pyramid(real, n_levels)
    pyr_f = jm.laplacian_pyramid(fake, n_levels)
    draws = []
    for rep in range(n_repeats):
        levels = []
        for lvl, (r, f) in enumerate(zip(pyr_r, pyr_f)):
            kr, kf, kp = jax.random.split(jax.random.fold_in(
                jax.random.fold_in(key, rep), lvl), 3)
            d = min(patch_size, r.shape[1], r.shape[2]) ** 2 * r.shape[3]
            levels.append({
                'real': jax_patch_draws(kr, r.shape, patch_size, n_patches),
                'fake': jax_patch_draws(kf, f.shape, patch_size, n_patches),
                'dirs': torch.from_numpy(np.array(jax.random.normal(
                    kp, (d, n_projections), dtype=jnp.float32)))})
        draws.append(levels)
    return draws


def test_pyramid_matches_jax():
    x = _structured_set(0, n=3, res=32, noise=0.1)
    for got, want in zip(tm.laplacian_pyramid(nchw(x), 3),
                         jm.laplacian_pyramid(x, 3)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize('res', [32, 4])
def test_patches_and_sliced_wasserstein_match_jax(res):
    x = _structured_set(1, n=4, res=32, noise=0.2)
    if res == 4:   # below the patch size: whole-image descriptors
        x = x[:, ::8, ::8]
    y = _structured_set(2, n=4, res=32)[:, :res, :res]
    key = jax.random.PRNGKey(5)
    ka, kb, kp = jax.random.split(key, 3)
    da = jm._extract_patches(x, ka, 7, 256)
    db = jm._extract_patches(y, kb, 7, 256)
    ta = tm._extract_patches(nchw(x), jax_patch_draws(ka, x.shape, 7, 256), 7)
    tb = tm._extract_patches(nchw(y), jax_patch_draws(kb, y.shape, 7, 256), 7)
    np.testing.assert_allclose(ta.numpy(), np.asarray(da), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(db), rtol=0, atol=1e-6)
    dirs = jax.random.normal(kp, (da.shape[1], 64), dtype=jnp.float32)
    want = float(jm.sliced_wasserstein(da, db, kp, n_projections=64))
    got = float(tm.sliced_wasserstein(ta, tb, torch.from_numpy(np.array(dirs))))
    assert got == pytest.approx(want, rel=1e-5)


def test_swd_multiscale_matches_jax_on_injected_draws():
    real = _structured_set(3, n=6, res=32)
    fake = _structured_set(4, n=6, res=32, noise=0.3)
    key = jax.random.PRNGKey(123)
    kw = dict(patch_size=7, n_patches=512, n_projections=64, n_repeats=2)
    want, want_mean = jm.swd_multiscale(real, fake, key, **kw)
    draws = jax_swd_draws(key, real, fake, 2, kw['patch_size'], kw['n_patches'],
                          kw['n_projections'], kw['n_repeats'])
    got, got_mean = tm.swd_multiscale(nchw(real), nchw(fake), draws=draws, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got_mean == pytest.approx(want_mean, rel=1e-5)


def test_swd_own_draws_deterministic_and_discriminating():
    real = nchw(_structured_set(5, n=8, res=32))
    alike = nchw(_structured_set(6, n=8, res=32))
    noisy = nchw(_structured_set(6, n=8, res=32, noise=0.5))

    def score(a, b, seed=1):
        return tm.swd_multiscale(a, b, torch.Generator().manual_seed(seed),
                                 n_patches=512, n_repeats=2)

    assert np.array_equal(score(real, noisy)[0], score(real, noisy)[0])
    assert score(real, alike)[1] < score(real, noisy)[1]
    d = torch.randn(64, 49, generator=torch.Generator().manual_seed(0))
    assert float(tm.sliced_wasserstein(d, d, torch.randn(49, 8))) == 0.0
