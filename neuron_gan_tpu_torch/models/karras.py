"""Karras et al.'s PGGAN (ICLR 2018, arXiv:1710.10196) as PyTorch modules,
NCHW: ``networks.py::G_paper`` and ``D_paper`` of
github.com/tkarras/progressive_growing_of_gans, selected by
``PGConfig(architecture='karras')``.  Same interface as models/pggan.py:
every phase's parameters exist from the start, the forward takes
``(phase, alpha)`` (``alpha=None`` steady, a float the fade-in blend), and
the names follow the port's paths, so checkpoints and ``convert.py`` take
them as they take the neuron variant's.

* G stem     = PixelNorm of the latent, dense (latent -> F0*init^2, gain
               sqrt(2)/4) + reshape + LReLU + PixelNorm, conv3x3 + LReLU
               + PixelNorm
* G block i  = nearest x2, then 2x [conv3x3 + LReLU + PixelNorm]
* to_rgb[i]  = conv1x1, gain 1, no activation
* D from_rgb = conv1x1 + LReLU
* D block i  = conv3x3 F_i -> F_i + LReLU, conv3x3 F_i -> F_{i+1} + LReLU,
               both at the level's own resolution, then a 2x2 average pool
* D head     = minibatch stddev (groups of 4), conv3x3
               (F+1 -> F) + LReLU, dense (F*init^2 -> F) + LReLU, dense
               (F -> 1, gain 1)

Every layer has a bias (zeros at the start) and draws its weight N(0, 1),
scaled at run time by gain / sqrt(fan_in), gain sqrt(2) unless said; D has
no PixelNorm.  D's levels run conv, LeakyReLU, conv, LeakyReLU, then the
pool (networks.py's unfused form; its default ``fused_scale`` pools inside
the second conv and applies the bias and LeakyReLU after the pool).
G's nearest upsample and conv are also unfused (``upscale2d_conv2d`` is
the same map).

Precision follows models/pggan.py: ``compute_dtype`` is the blocks'
activation type; under 'mixed' the latent norm and the dense stem layer,
the image G hands out and D's head run in float32.  With ``use_kernels``
every LeakyReLU + PixelNorm of G, the stem's included, runs in the CUDA
kernel pair (ops/lrelu_pixel_norm.py), and every LeakyReLU of D in the
critic's kernel family (ops/critic_act.py), each level's last one with the
level's 2x2 pool; the fade-in's pool of the image stays ``avg_pool``.  The
packed layouts are refused (``PGConfig``).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from neuron_gan_tpu_torch.models.pggan import PGConfig, _epilogue
from neuron_gan_tpu_torch.ops import (
    avg_pool, conv2d, fade_in, leaky_relu, minibatch_stddev, pixel_norm,
    upsample2_nearest)
from neuron_gan_tpu_torch.ops.critic_act import critic_act, critic_act_pool
from neuron_gan_tpu_torch.runtime import resolve_device

GAIN = math.sqrt(2.0)
# the samples a minibatch-stddev group takes (networks.py's mbstd_group_size)
MBSTD_GROUP = 4


def _normal(shape, rng, device):
    w = torch.randn(shape, generator=rng, device=rng.device)
    return nn.Parameter(w.to(device))


class Conv(nn.Module):
    """Equalized conv (``networks.py::conv2d`` with use_wscale and
    ``apply_bias``): OIHW ``weight`` N(0, 1), zero ``bias``, 'same'
    padding."""

    def __init__(self, c_in, c_out, k, *, rng, device, gain=GAIN):
        super().__init__()
        self.weight = _normal((c_out, c_in, k, k), rng, device)
        self.bias = nn.Parameter(torch.zeros(c_out, device=device))
        self.scale = gain / math.sqrt(c_in * k * k)
        self.padding = k // 2

    def forward(self, x):
        return conv2d(x, self.weight * self.scale, self.bias,
                      padding=self.padding)


class Dense(nn.Module):
    """Equalized dense layer (``networks.py::dense``): (out, in)
    ``weight`` N(0, 1), zero ``bias``; the input flattened."""

    def __init__(self, d_in, d_out, *, rng, device, gain=GAIN):
        super().__init__()
        self.weight = _normal((d_out, d_in), rng, device)
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))
        self.scale = gain / math.sqrt(d_in)

    def forward(self, x):
        x = x.flatten(1)
        return F.linear(x, (self.weight * self.scale).to(x.dtype),
                        self.bias.to(x.dtype))


class GeneratorKarras(nn.Module):
    """``G_paper``; weights drawn from ``rng`` in the order of the
    parameters."""

    def __init__(self, cfg: PGConfig, rng: torch.Generator, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        f, init = cfg.n_gen_features, cfg.image_size_init
        kw = dict(rng=rng, device=device)
        self.stem = nn.ModuleDict({
            'linear': Dense(cfg.latent_dim, f[0] * init * init,
                            gain=GAIN / 4, **kw),
            'conv': Conv(f[0], f[0], 3, **kw)})
        self.blocks = nn.ModuleList(
            nn.ModuleDict({'conv1': Conv(f[i], f[i + 1], 3, **kw),
                           'conv2': Conv(f[i + 1], f[i + 1], 3, **kw)})
            for i in range(len(f) - 1))
        self.to_rgb = nn.ModuleList(Conv(f[i], cfg.n_colors, 1, gain=1.0, **kw)
                                    for i in range(len(f)))

    def _stem(self, z):
        cfg = self.cfg
        x = self.stem['linear'](pixel_norm(z.float()))
        x = x.reshape(-1, cfg.n_gen_features[0], cfg.image_size_init,
                      cfg.image_size_init).to(cfg.dtype)
        x = _epilogue(x, cfg)
        return _epilogue(self.stem['conv'](x), cfg)

    def _block(self, x, i):
        p = self.blocks[i]
        x = _epilogue(p['conv1'](upsample2_nearest(x)), self.cfg)
        return _epilogue(p['conv2'](x), self.cfg)

    def _to_rgb(self, x, i):
        y = self.to_rgb[i](x)
        return y.float() if self.cfg.mixed else y

    def forward(self, z, phase: int, alpha=None):
        """z (B, latent) -> image (B, C, R, R), R = init * 2**phase."""
        x = self._stem(z)
        if alpha is None:
            for i in range(phase):
                x = self._block(x, i)
            return self._to_rgb(x, phase)
        if phase < 1:
            raise ValueError('fade-in requires phase >= 1')
        for i in range(phase - 1):
            x = self._block(x, i)
        start = upsample2_nearest(self._to_rgb(x, phase - 1))
        return fade_in(start, self._to_rgb(self._block(x, phase - 1), phase),
                       alpha)


class DiscriminatorKarras(nn.Module):
    """``D_paper``; at phase k it takes (B, C, init*2^k, init*2^k) and uses
    from_rgb[L-1-k] and blocks[L-1-k .. L-2]."""

    def __init__(self, cfg: PGConfig, rng: torch.Generator, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        f, init = cfg.n_dis_features, cfg.image_size_init
        kw = dict(rng=rng, device=device)
        self.from_rgb = nn.ModuleList(Conv(cfg.n_colors, f[i], 1, **kw)
                                      for i in range(len(f)))
        self.blocks = nn.ModuleList(
            nn.ModuleDict({'conv1': Conv(f[i], f[i], 3, **kw),
                           'conv2': Conv(f[i], f[i + 1], 3, **kw)})
            for i in range(len(f) - 1))
        self.head = nn.ModuleDict({
            'conv': Conv(f[-1] + 1, f[-1], 3, **kw),
            'dense0': Dense(f[-1] * init * init, f[-1], **kw),
            'dense1': Dense(f[-1], 1, gain=1.0, **kw)})

    def _act(self, x):
        if self.cfg.use_kernels:
            return critic_act(x, self.cfg.neg_slope)
        return leaky_relu(x, self.cfg.neg_slope)

    def _from_rgb(self, x, i):
        return self._act(self.from_rgb[i](x))

    def _block(self, y, i):
        p = self.blocks[i]
        y = p['conv2'](self._act(p['conv1'](y)))
        if self.cfg.use_kernels:
            return critic_act_pool(y, self.cfg.neg_slope)
        return avg_pool(self._act(y), 2)

    def _head(self, y):
        if self.cfg.mixed:
            y = y.float()       # float32 head: full-precision scores
        y = minibatch_stddev(y, MBSTD_GROUP)
        y = self._act(self.head['conv'](y))
        y = self._act(self.head['dense0'](y))
        return self.head['dense1'](y)

    def forward(self, x, phase: int, alpha=None):
        """x (B, C, R, R) -> critic score (B, 1)."""
        x = x.to(self.cfg.dtype)
        n = self.cfg.n_layers_max
        first = n - 1 - phase
        y = self._from_rgb(x, first)
        if alpha is not None:
            if phase < 1:
                raise ValueError('fade-in requires phase >= 1')
            start = self._from_rgb(avg_pool(x, 2), first + 1)
            y = fade_in(start, self._block(y, first), alpha)
            first += 1
        for i in range(first, n - 1):
            y = self._block(y, i)
        return self._head(y)
