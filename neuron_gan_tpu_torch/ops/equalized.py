"""Equalized-learning-rate convolution and linear ops (functional, NCHW).

Counterpart of neuron_gan_tpu/ops/equalized.py.  The reference rescales the
layer INPUT by ``gain / sqrt(fan_in)`` at every forward (reference
models.py:172-241); scaling the weight is the same linear map, so the scale
goes on the weight side here, as in the JAX package -- an O(params)
multiply instead of an O(activations) one.

Layout: NCHW activations, OIHW conv weights, linear weights (out, in).
"""

import math

import torch
import torch.nn.functional as F

from neuron_gan_tpu_torch.ops import conv


def calculate_gain(nonlinearity='leaky_relu', param=0.2):
    """torch.nn.init.calculate_gain for the subset the reference uses."""
    if nonlinearity == 'leaky_relu':
        return math.sqrt(2.0 / (1.0 + param ** 2))
    if nonlinearity == 'linear':
        return 1.0
    if nonlinearity == 'relu':
        return math.sqrt(2.0)
    if nonlinearity == 'tanh':
        return 5.0 / 3.0
    raise ValueError(f'unsupported nonlinearity: {nonlinearity}')


def _conv_fan_in(weight):
    """fan_in of an OIHW conv weight: in_channels * prod(kernel)."""
    _, c_in, kh, kw = weight.shape
    return c_in * kh * kw


def init_conv2d(c_in, c_out, kernel_size, *, generator, neg_slope=0.2,
                device=None, dtype=torch.float32):
    """Kaiming-normal conv weight (fan_in, leaky_relu gain; reference
    models.py:31-34), OIHW, std = gain/sqrt(fan_in)."""
    fan_in = c_in * kernel_size * kernel_size
    std = calculate_gain('leaky_relu', neg_slope) / math.sqrt(fan_in)
    w = torch.randn((c_out, c_in, kernel_size, kernel_size),
                    generator=generator, device=generator.device,
                    dtype=dtype)
    return (std * w).to(device)


def init_linear(d_in, d_out, *, generator, neg_slope=0.2, device=None,
                dtype=torch.float32):
    """Kaiming-normal linear weight, stored (out, in)."""
    std = calculate_gain('leaky_relu', neg_slope) / math.sqrt(d_in)
    w = torch.randn((d_out, d_in), generator=generator,
                    device=generator.device, dtype=dtype)
    return (std * w).to(device)


def conv2d(x, weight, bias=None, *, padding=0):
    """Plain NCHW conv (to_rgb / from_rgb carry no runtime scale --
    reference models.py:133-168); weight and bias cast to ``x.dtype``.
    Its second order is ops/conv.py's."""
    b = None if bias is None else bias.to(x.dtype)
    return conv.conv2d(x, weight.to(x.dtype), b, padding=padding)


def equalized_conv2d(x, weight, bias=None, *, padding=0, neg_slope=0.2,
                     gain_nonlinearity='leaky_relu'):
    """Conv with the equalized-LR scale applied to the weight; the bias is
    unscaled, as in the reference."""
    scale = (calculate_gain(gain_nonlinearity, neg_slope)
             / math.sqrt(_conv_fan_in(weight)))
    return conv2d(x, weight * scale, bias, padding=padding)


def equalized_linear(x, weight, bias=None, *, neg_slope=0.2,
                     gain_nonlinearity='leaky_relu'):
    """Linear with the equalized-LR scale on the (out, in) weight."""
    scale = (calculate_gain(gain_nonlinearity, neg_slope)
             / math.sqrt(weight.shape[1]))
    b = None if bias is None else bias.to(x.dtype)
    return F.linear(x, (weight * scale).to(x.dtype), b)
