"""Latent-vector sampling (counterpart of neuron_gan_tpu/utils/latents.py).

Reference semantics (utils.py:57-92): standard normals clamped to [-5, 5],
then each row L2-normalized -- points uniform on the unit hypersphere.
"""

import torch


def sample_latent_vec(rng: torch.Generator, size, mode='randn',
                      dtype=torch.float32):
    """A batch of latent vectors, ``size`` = (batch, latent_dim), drawn from
    ``rng`` on its device."""
    if mode == 'rand':
        return 2.0 * torch.rand(size, generator=rng, device=rng.device,
                                dtype=dtype) - 1.0
    if mode == 'randn':
        z = torch.randn(size, generator=rng, device=rng.device, dtype=dtype)
        z = torch.clamp(z, -5.0, 5.0)
        return z / torch.linalg.norm(z, ord=2, dim=1, keepdim=True)
    raise ValueError(f'{mode} is not supported')
