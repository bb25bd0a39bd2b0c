"""Fade-in blend used during progressive-growth transitions (counterpart of
neuron_gan_tpu/ops/fadein.py; reference models.py:344-351, :516-524)."""


def fade_in(start, end, alpha):
    return start + alpha * (end - start)
