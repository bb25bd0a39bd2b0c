"""The random inputs of the training steps, drawn by the benchmark itself.

The program under test takes one ``torch.Generator`` and draws every random
number of a chunk from it; the reference must see the same numbers without
calling the program's draw code.  Both sides start from a generator seeded
with the same value by the benchmark, and this module draws the same
quantities, in the same order, with the same torch calls, so a generator in
the same state yields the same values on the same device.  The order is the
protocol a training run's inputs follow:

  each epoch:  the permutation of the stack (torch.randperm(n_images));
  each batch:  for each critic step: z1 = latent(); z2 = latent() unless the
               penalty reuses the critic loss's fakes; eps = rand(b);
               then the augmentation: angle U(-180, 180), tx and ty
               round(U(-m, m)) with m = translation * the warped frame's
               side, flip U(0, 1) < 0.5, brightness_first U(0, 1) < 0.5,
               brightness U(0.75, 1.25), contrast U(0.75, 1.25);
               then zg = latent();

latent() = randn(b, latent_dim) clamped to [-5, 5], each row divided by
its L2 norm; U(lo, hi) = lo + (hi - lo) * rand(b).  A program that draws in
another order trains on other inputs, and ``correct`` reads false.
"""

import torch


def latent(gen, b, dim):
    z = torch.randn((b, dim), generator=gen, device=gen.device)
    z = torch.clamp(z, -5.0, 5.0)
    return z / torch.linalg.norm(z, ord=2, dim=1, keepdim=True)


def _uniform(gen, b, lo, hi):
    return lo + (hi - lo) * torch.rand(b, generator=gen, device=gen.device)


def batch_draws(gen, b, latent_dim, n_critic, reuse_fakes, max_shift,
                augment=True, degrees=180.0):
    """One batch step's draws: {'critic': [(z1, z2, eps)], 'augment':
    {...} or None, 'zg'}."""
    critic = []
    for _ in range(max(n_critic, 1)):
        z1 = latent(gen, b, latent_dim)
        z2 = z1 if reuse_fakes else latent(gen, b, latent_dim)
        eps = torch.rand(b, generator=gen, device=gen.device)
        critic.append((z1, z2, eps))
    aug = None
    if augment:
        aug = {
            'angle': _uniform(gen, b, -degrees, degrees),
            'tx': torch.round(_uniform(gen, b, -max_shift, max_shift)),
            'ty': torch.round(_uniform(gen, b, -max_shift, max_shift)),
            'flip': _uniform(gen, b, 0.0, 1.0) < 0.5,
            'brightness_first': _uniform(gen, b, 0.0, 1.0) < 0.5,
            'brightness': _uniform(gen, b, 0.75, 1.25),
            'contrast': _uniform(gen, b, 0.75, 1.25),
        }
    return {'critic': critic, 'augment': aug,
            'zg': latent(gen, b, latent_dim)}


def steps(gen, n_steps, n_images, batch, shuffle=True, **kw):
    """The first ``n_steps`` batch steps of a run from epoch 1: a list of
    (rows of the stack, draws)."""
    out = []
    while len(out) < n_steps:
        order = (torch.randperm(n_images, generator=gen, device=gen.device)
                 if shuffle else torch.arange(n_images, device=gen.device))
        for start in range(0, n_images, batch):
            b = min(batch, n_images - start)
            rows = order[start:start + b]
            out.append((rows, batch_draws(gen, b, **kw)))
    return out[:n_steps]
