"""PixelNorm and LeakyReLU (functional, NCHW: channels are dim 1).

Counterpart of neuron_gan_tpu/ops/pixelnorm.py.  These composed ops are the
plain path; the fused CUDA epilogue is ops/lrelu_pixel_norm.py.
"""

import torch


def leaky_relu(x, neg_slope=0.2):
    # Not F.leaky_relu: its gradient at exactly 0 takes the slope, while the
    # JAX package's where(x >= 0, ...) (and the fused kernel) take 1.
    return torch.where(x >= 0, x, x * neg_slope)


def pixel_norm(x, eps=1e-8, f32_stats=False):
    """Per-pixel feature normalization over the channel axis.

    ``f32_stats`` computes the mean of squares and the normalization in
    float32 and casts back to ``x.dtype`` (the ``compute_dtype='mixed'``
    recipe)."""
    if f32_stats and x.dtype != torch.float32:
        xf = x.float()
        ms = torch.mean(xf * xf, dim=1, keepdim=True)
        return (xf * torch.rsqrt(ms + eps)).to(x.dtype)
    ms = torch.mean(x * x, dim=1, keepdim=True)
    return x * torch.rsqrt(ms + eps)


def lrelu_pixel_norm(x, neg_slope=0.2, eps=1e-8, f32_stats=False):
    return pixel_norm(leaky_relu(x, neg_slope), eps, f32_stats=f32_stats)
