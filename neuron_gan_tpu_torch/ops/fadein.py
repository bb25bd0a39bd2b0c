"""Fade-in blend used during progressive-growth transitions (counterpart of
neuron_gan_tpu/ops/fadein.py; reference models.py:344-351, :516-524)."""


import torch


def fade_in(start, end, alpha):
    # alpha rounded to start's dtype first, as the JAX package casts it
    alpha = torch.tensor(alpha, dtype=start.dtype).item()
    return start + alpha * (end - start)
