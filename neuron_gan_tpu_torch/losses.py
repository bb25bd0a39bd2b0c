"""GAN loss functions (counterpart of neuron_gan_tpu/losses.py).

``d_apply`` and ``g_apply`` are callables on tensors -- a model with its
phase and alpha bound.  Parity map to the reference (loss_functions.py):

* ``d_w_loss``: ``-<D(x)> + <D(G(z))>`` with the fakes detached, plus the
  drift ``eps * <D(x)^2>`` on the real scores (:7-47); it takes the fake
  batch G(z), which the batch step also hands the penalty;
* ``g_w_loss``: ``-<D(G(z))>`` (:51-74);
* ``d_grad_pen_loss``: WGAN-GP on per-sample interpolates,
  ``lambda * <(||dD/dx_hat||_2 - 1)^2>`` with the norm over (C, H, W)
  (:148-180).  The inner gradient keeps its graph (``create_graph``), so
  differentiating the penalty is a gradient of a gradient.  ``remat``
  runs the critic's forward over the interpolates under
  ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``): the
  same operations, recomputed when the inner gradient needs them;
* ``similarity_loss`` (:185-205) and the LSGAN losses (:79-143).
"""

import torch
import torch.utils.checkpoint


def _f32(t):
    """``t`` in float32 for the reductions, or as it is when wider (a
    float64 reference run keeps its precision)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def d_w_loss(d_apply, real_images, fake_images, drift_epsilon=0.0):
    """Critic Wasserstein loss on the generator's batch ``fake_images``
    (G(z), detached here). Returns (loss, (score_real, score_fake))."""
    real_scores = _f32(d_apply(real_images))
    score_real = real_scores.mean()
    score_fake = _f32(d_apply(fake_images.detach())).mean()
    loss = -score_real + score_fake
    if drift_epsilon > 0:
        loss = loss + drift_epsilon * torch.mean(real_scores * real_scores)
    return loss, (score_real, score_fake)


def g_w_loss(g_apply, d_apply, z):
    """Generator Wasserstein loss. Returns (loss, z)."""
    loss = -_f32(d_apply(g_apply(z))).mean()
    return loss, z


def d_grad_pen_loss(d_apply, real_images, fake_images, epsilon, gp_lambda,
                    remat=False):
    """Gradient penalty on interpolates.  ``epsilon`` is (B,) or
    (B, 1, 1, 1) uniform; ``fake_images`` carry no gradient.

    With ``remat`` the critic's forward runs under a non-reentrant
    ``torch.utils.checkpoint`` (the reentrant form refuses
    ``autograd.grad``): its activations are recomputed inside the inner
    gradient, in the same precision and autocast state.  The outer
    backward then holds the recomputed graph, so unlike JAX's
    ``jax.checkpoint`` this may save little memory; the values are the
    same."""
    if gp_lambda <= 0:
        return torch.zeros((), dtype=real_images.dtype,
                           device=real_images.device)
    eps = epsilon.reshape(-1, 1, 1, 1).to(real_images.dtype)
    x_hat = (eps * real_images + (1.0 - eps) * fake_images.detach())
    x_hat = x_hat.detach().requires_grad_(True)

    def score(x):
        return d_apply(x).sum()

    if remat:
        total = torch.utils.checkpoint.checkpoint(score, x_hat,
                                                  use_reentrant=False)
    else:
        total = score(x_hat)
    grad, = torch.autograd.grad(total, x_hat, create_graph=True)
    grad = _f32(grad)  # f32 accumulation for the norm reduction
    norms = torch.sqrt(torch.sum(grad * grad, dim=(1, 2, 3)))
    return gp_lambda * torch.mean((norms - 1.0) ** 2)


def similarity_loss(images, z, sim_lambda=1.0):
    """Anti-mode-collapse cosine-similarity matching."""
    b = images.shape[0]
    im = images.reshape(b, -1)
    zm = z.reshape(b, -1)
    im = im / torch.linalg.norm(im, dim=1, keepdim=True)
    zm = zm / torch.linalg.norm(zm, dim=1, keepdim=True)
    z_cos = zm @ zm.T
    im_cos = im @ im.T
    return sim_lambda * torch.sum((z_cos - im_cos) ** 2) / (b * (b - 1))


def d_ls_loss(d_apply, g_apply, real_images, z):
    """LSGAN critic loss ``<(D(x)-1)^2> + <D(G(z))^2>``."""
    real_scores = d_apply(real_images)
    with torch.no_grad():
        fake_images = g_apply(z)
    fake_scores = d_apply(fake_images)
    loss = (torch.mean((real_scores - 1.0) ** 2)
            + torch.mean(fake_scores ** 2))
    return loss, (real_scores.mean(), fake_scores.mean())


def g_ls_loss(g_apply, d_apply, z):
    """LSGAN generator loss ``<(D(G(z))-1)^2>``."""
    fake_scores = d_apply(g_apply(z))
    return torch.mean((fake_scores - 1.0) ** 2), fake_scores.mean()
