"""Legacy model families: DCGAN and fixed-resolution WGAN nets, NCHW.

Counterpart of neuron_gan_tpu/models/legacy.py (the reference's
models.py:622-790), as ``nn.Module``s of cuDNN/ATen layers: the JAX
package builds them from plain convs, transposed convs, BatchNorm and
Linear layers and runs no Pallas kernel in them, so neither does the port.

- ``nn.ConvTranspose2d`` / ``nn.Conv2d`` (kernel 4; stride 2, padding 1
  unless stated), ``nn.BatchNorm2d(eps=1e-5, momentum=0.1)`` (training
  mode normalizes with the biased batch variance and keeps the unbiased
  one in ``running_var``, as the JAX ``batch_norm`` copies) and
  ``nn.Linear``;
- images cross the boundary as the port's PGGAN takes them, (B, C, H, W);
  G's linear output is reshaped to (f0, init, init) and D flattens in
  (C, H, W) order, as the reference does;
- init from an explicit ``torch.Generator`` with the reference's
  distributions (utils.py:96-101): conv weights N(0, 0.02), BN scale
  N(1, 0.02), biases 0, Linear weight and bias U(+-1/sqrt(fan_in)).

Each net's children name the JAX pytree: ``linear``, ``bn0``, ``stem``,
``conv0``, ``blocks.{i}.conv`` / ``.bn``, ``final``;
``convert.legacy_to_jax`` / ``load_legacy`` map one onto the other.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def _normal_(t, rng, mean, std):
    with torch.no_grad():
        t.copy_(mean + std * torch.randn(t.shape, generator=rng).to(t))


def _uniform_(t, rng, bound):
    with torch.no_grad():
        t.copy_((2 * torch.rand(t.shape, generator=rng) - 1).to(t) * bound)


def _conv(cls, c_in, c_out, rng, device, stride=2, padding=1, bias=True):
    m = cls(c_in, c_out, 4, stride, padding, bias=bias, device=device)
    _normal_(m.weight, rng, 0.0, 0.02)
    if bias:
        nn.init.zeros_(m.bias)
    return m


def _bn(c, rng, device):
    m = nn.BatchNorm2d(c, eps=1e-5, momentum=0.1, device=device)
    _normal_(m.weight, rng, 1.0, 0.02)
    nn.init.zeros_(m.bias)
    return m


def _linear(d_in, d_out, rng, device):
    m = nn.Linear(d_in, d_out, device=device)
    bound = 1.0 / math.sqrt(d_in)
    _uniform_(m.weight, rng, bound)
    _uniform_(m.bias, rng, bound)
    return m


class Block(nn.Module):
    """A conv (or transposed conv) and the BatchNorm after it."""

    def __init__(self, conv, bn):
        super().__init__()
        self.conv = conv
        self.bn = bn

    def forward(self, x):
        return self.bn(self.conv(x))


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class GeneratorWGAN(nn.Module):
    """z (B, latent) -> tanh image (B, C, S, S), S = image_size: Linear to
    (f0, init, init), BN, then ``len(n_features) - 1`` transposed-conv
    blocks and a final transposed conv, each doubling the side."""

    def __init__(self, n_features, rng, latent_dim=512, image_size=512,
                 n_colors=1, device=None):
        super().__init__()
        n = len(n_features)
        self.n_features = tuple(n_features)
        self.init = image_size // 2 ** n
        self.linear = _linear(latent_dim, n_features[0] * self.init ** 2,
                              rng, device)
        self.bn0 = _bn(n_features[0], rng, device)
        self.blocks = nn.ModuleList(
            Block(_conv(nn.ConvTranspose2d, n_features[i], n_features[i + 1],
                        rng, device),
                  _bn(n_features[i + 1], rng, device))
            for i in range(n - 1))
        self.final = _conv(nn.ConvTranspose2d, n_features[-1], n_colors,
                           rng, device)

    def forward(self, z):
        x = self.linear(z).view(-1, self.n_features[0], self.init, self.init)
        x = _lrelu(self.bn0(x))
        for block in self.blocks:
            x = _lrelu(block(x))
        return torch.tanh(self.final(x))


class DiscriminatorWGAN(nn.Module):
    """image (B, C, S, S) -> critic score (B, 1): a conv, ``len(n_features)
    - 1`` conv blocks, each halving the side, and a Linear."""

    def __init__(self, n_features, rng, image_size=512, n_colors=1,
                 device=None):
        super().__init__()
        n = len(n_features)
        self.conv0 = _conv(nn.Conv2d, n_colors, n_features[0], rng, device)
        self.blocks = nn.ModuleList(
            Block(_conv(nn.Conv2d, n_features[i], n_features[i + 1], rng,
                        device),
                  _bn(n_features[i + 1], rng, device))
            for i in range(n - 1))
        final = image_size // 2 ** n
        self.linear = _linear(n_features[-1] * final ** 2, 1, rng, device)

    def forward(self, x):
        y = _lrelu(self.conv0(x))
        for block in self.blocks:
            y = _lrelu(block(y))
        return self.linear(y.flatten(1))


class GeneratorDCGAN(nn.Module):
    """z (B, latent) -> tanh image (B, C, 512, 512): a 4x4 transposed-conv
    stem, six stride-2 blocks and a final stride-2 transposed conv, ReLU
    after each BN; no biases."""

    def __init__(self, n_features, rng, latent_dim=512, n_colors=1,
                 device=None):
        super().__init__()
        if len(n_features) != 7:
            raise ValueError('dcgan generator expects 7 feature entries')
        self.stem = Block(_conv(nn.ConvTranspose2d, latent_dim, n_features[0],
                                rng, device, stride=1, padding=0, bias=False),
                          _bn(n_features[0], rng, device))
        self.blocks = nn.ModuleList(
            Block(_conv(nn.ConvTranspose2d, n_features[i], n_features[i + 1],
                        rng, device, bias=False),
                  _bn(n_features[i + 1], rng, device))
            for i in range(len(n_features) - 1))
        self.final = _conv(nn.ConvTranspose2d, n_features[-1], n_colors, rng,
                           device, bias=False)

    def forward(self, z):
        x = torch.relu(self.stem(z.view(z.shape[0], -1, 1, 1)))
        for block in self.blocks:
            x = torch.relu(block(x))
        return torch.tanh(self.final(x))


class DiscriminatorDCGAN(nn.Module):
    """image (B, C, 512, 512) -> sigmoid score (B, 1): a conv, six conv
    blocks and a final 4x4 VALID conv; no biases."""

    def __init__(self, n_features, rng, n_colors=1, device=None):
        super().__init__()
        if len(n_features) != 7:
            raise ValueError('dcgan discriminator expects 7 feature entries')
        self.conv0 = _conv(nn.Conv2d, n_colors, n_features[0], rng, device,
                           bias=False)
        self.blocks = nn.ModuleList(
            Block(_conv(nn.Conv2d, n_features[i], n_features[i + 1], rng,
                        device, bias=False),
                  _bn(n_features[i + 1], rng, device))
            for i in range(len(n_features) - 1))
        self.final = _conv(nn.Conv2d, n_features[-1], 1, rng, device,
                           stride=1, padding=0, bias=False)

    def forward(self, x):
        y = _lrelu(self.conv0(x))
        for block in self.blocks:
            y = _lrelu(block(y))
        return torch.sigmoid(self.final(y)).flatten(1)
