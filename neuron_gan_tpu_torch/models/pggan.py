"""Progressively-growing GAN (PGGAN) as PyTorch modules, NCHW.

Counterpart of neuron_gan_tpu/models/pggan.py in its unpacked float32
layout.  As there, the parameters of every phase exist from the start and
the forward takes ``(phase, alpha)``: ``alpha=None`` is the steady state,
a float the fade-in blend (reference models.py:344-351 for G, :516-524 for
D).  Parameter names follow the JAX pytree paths (``stem.linear``,
``blocks.{i}.conv1``, ``to_rgb.{i}``, ``head.conv_out``, ``from_rgb.{i}``;
``weight``/``bias`` for the JAX ``w``/``b``), so ``convert.py`` maps one
onto the other leaf by leaf.

* stem       = eq-Linear(latent -> F0*init^2) + reshape to (F0, init, init)
               + LReLU + PixelNorm + eq-Conv3x3 + LReLU + PixelNorm
* G block i  = up2 bilinear, then 2x [eq-Conv3x3 + LReLU + PixelNorm]
* to_rgb[i]  = plain 1x1 conv + tanh
* D block i  = AvgPool2, then 2x [eq-Conv3x3 + LReLU + PixelNorm]
* from_rgb[i]= plain 1x1 conv with bias
* D head     = eq-Conv3x3 (bias) + LReLU + PixelNorm + eq-Conv(init x init,
               bias, VALID) -> (B, 1) critic score

With ``use_kernels`` every LReLU + PixelNorm of the G and D blocks runs in
the fused CUDA kernel pair (ops/lrelu_pixel_norm.py), as ``use_pallas``
routes them through the Pallas kernel in the JAX package; the stem and the
head keep the composed ops, as there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from neuron_gan_tpu_torch.ops import (
    avg_pool, conv2d, equalized_conv2d, equalized_linear, fade_in,
    init_conv2d, init_linear, leaky_relu, pixel_norm, upsample2_bilinear,
)
from neuron_gan_tpu_torch.ops.lrelu_pixel_norm import (
    lrelu_pixel_norm as fused_lrelu_pixel_norm)
from neuron_gan_tpu_torch.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class PGConfig:
    """Static architecture description shared by G and D."""
    n_gen_features: tuple
    n_dis_features: tuple
    latent_dim: int = 512
    image_size_init: int = 4
    n_colors: int = 1
    neg_slope: float = 0.2
    # only 'float32' so far; 'mixed' and 'bfloat16' are ROADMAP A5
    compute_dtype: str = 'float32'
    # 'highest' runs convs and matmuls in true float32 (TF32 off);
    # None allows TF32 -- see precision_scope
    precision: Optional[str] = 'highest'
    # LReLU + PixelNorm of the G/D blocks in the CUDA kernel pair (the
    # counterpart of the JAX package's use_pallas)
    use_kernels: bool = False
    # the space-to-depth packed layout is ROADMAP A11
    packed_min_res: Optional[int] = None
    packed_lanes: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, 'n_gen_features', tuple(self.n_gen_features))
        object.__setattr__(self, 'n_dis_features', tuple(self.n_dis_features))
        if len(self.n_gen_features) != len(self.n_dis_features):
            raise ValueError('G and D need the same number of levels')
        if self.compute_dtype != 'float32':
            raise NotImplementedError(
                f"compute_dtype={self.compute_dtype!r} is not ported yet "
                "(ROADMAP A5); use 'float32'")
        if self.packed_min_res is not None or self.packed_lanes is not None:
            raise NotImplementedError(
                'the packed layout is not ported yet (ROADMAP A11)')
        if self.precision not in ('highest', None):
            raise ValueError(f"precision must be 'highest' or None, got "
                             f'{self.precision!r}')

    @property
    def n_layers_max(self) -> int:
        return len(self.n_gen_features)

    @property
    def n_phases(self) -> int:
        return self.n_layers_max

    @property
    def image_size_max(self) -> int:
        return self.image_size_init * 2 ** (self.n_layers_max - 1)

    def resolution(self, phase: int) -> int:
        return self.image_size_init * 2 ** phase

    def phase_of_resolution(self, res: int) -> int:
        p = int(math.log2(res / self.image_size_init))
        if self.resolution(p) != res:
            raise ValueError(f'{res} is not a phase resolution')
        return p


@contextlib.contextmanager
def precision_scope(precision):
    """Run a block with TF32 off (``'highest'``) or allowed (``None``) for
    cuDNN convolutions and cuBLAS matmuls, restoring both flags after.
    cuDNN's float32 convs default to TF32, which would break parity with
    the JAX package's 'highest' precision."""
    allow = precision is None
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

class Conv(nn.Module):
    """One conv: OIHW ``weight`` (kaiming-normal), optional zero ``bias``,
    the equalized-LR weight scale when ``equalized``."""

    def __init__(self, c_in, c_out, kernel_size, *, bias, equalized, padding,
                 neg_slope, rng, device):
        super().__init__()
        self.weight = nn.Parameter(init_conv2d(
            c_in, c_out, kernel_size, generator=rng, neg_slope=neg_slope,
            device=device))
        self.bias = (nn.Parameter(torch.zeros(c_out, device=device))
                     if bias else None)
        self.equalized = equalized
        self.padding = padding
        self.neg_slope = neg_slope

    def forward(self, x):
        if self.equalized:
            return equalized_conv2d(x, self.weight, self.bias,
                                    padding=self.padding,
                                    neg_slope=self.neg_slope)
        return conv2d(x, self.weight, self.bias, padding=self.padding)


class EqualizedLinear(nn.Module):
    """Bias-free equalized-LR linear layer; ``weight`` is (out, in)."""

    def __init__(self, d_in, d_out, *, neg_slope, rng, device):
        super().__init__()
        self.weight = nn.Parameter(init_linear(
            d_in, d_out, generator=rng, neg_slope=neg_slope, device=device))
        self.neg_slope = neg_slope

    def forward(self, x):
        return equalized_linear(x, self.weight, neg_slope=self.neg_slope)


def _block_pair(f_in, f_out, cfg, rng, device):
    kw = dict(bias=False, equalized=True, padding=1, neg_slope=cfg.neg_slope,
              rng=rng, device=device)
    return nn.ModuleDict({'conv1': Conv(f_in, f_out, 3, **kw),
                          'conv2': Conv(f_out, f_out, 3, **kw)})


def _epilogue(x, cfg: PGConfig):
    """The LReLU -> PixelNorm after every block conv: the CUDA kernel pair
    when cfg.use_kernels, the composed ops otherwise."""
    if cfg.use_kernels:
        return fused_lrelu_pixel_norm(x, 1, cfg.neg_slope, 1e-8)
    return pixel_norm(leaky_relu(x, cfg.neg_slope))


# --------------------------------------------------------------------------
# Generator and discriminator
# --------------------------------------------------------------------------

class GeneratorPG(nn.Module):
    """PGGAN generator; weights drawn from ``rng`` (a torch.Generator) in
    the JAX package's order with its standard deviations."""

    def __init__(self, cfg: PGConfig, rng: torch.Generator, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        f, init, s = cfg.n_gen_features, cfg.image_size_init, cfg.neg_slope
        self.stem = nn.ModuleDict({
            'linear': EqualizedLinear(cfg.latent_dim, f[0] * init * init,
                                      neg_slope=s, rng=rng, device=device),
            'conv': Conv(f[0], f[0], 3, bias=False, equalized=True,
                         padding=1, neg_slope=s, rng=rng, device=device),
        })
        self.blocks = nn.ModuleList(_block_pair(f[i], f[i + 1], cfg, rng,
                                                device)
                                    for i in range(len(f) - 1))
        self.to_rgb = nn.ModuleList(
            Conv(f[i], cfg.n_colors, 1, bias=False, equalized=False,
                 padding=0, neg_slope=s, rng=rng, device=device)
            for i in range(len(f)))

    def _stem(self, z):
        cfg = self.cfg
        x = self.stem['linear'](z)
        # NCHW: the plain reshape gives the reference's Unflatten order
        x = x.reshape(-1, cfg.n_gen_features[0], cfg.image_size_init,
                      cfg.image_size_init)
        x = pixel_norm(leaky_relu(x, cfg.neg_slope))
        return pixel_norm(leaky_relu(self.stem['conv'](x), cfg.neg_slope))

    def _block(self, x, i):
        p = self.blocks[i]
        x = upsample2_bilinear(x)
        x = _epilogue(p['conv1'](x), self.cfg)
        return _epilogue(p['conv2'](x), self.cfg)

    def _to_rgb(self, x, i):
        return torch.tanh(self.to_rgb[i](x))

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
        im_start = upsample2_bilinear(self._to_rgb(x, phase - 1))
        im_end = self._to_rgb(self._block(x, phase - 1), phase)
        return fade_in(im_start, im_end, alpha)


class DiscriminatorPG(nn.Module):
    """PGGAN critic; at phase k it takes (B, C, init*2^k, init*2^k) and
    uses from_rgb[L-1-k] and blocks[L-1-k .. L-2]."""

    def __init__(self, cfg: PGConfig, rng: torch.Generator, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        f, init, s = cfg.n_dis_features, cfg.image_size_init, cfg.neg_slope
        self.head = nn.ModuleDict({
            'conv': Conv(f[-1], f[-1], 3, bias=True, equalized=True,
                         padding=1, neg_slope=s, rng=rng, device=device),
            'conv_out': Conv(f[-1], 1, init, bias=True, equalized=True,
                             padding=0, neg_slope=s, rng=rng, device=device),
        })
        self.blocks = nn.ModuleList(_block_pair(f[i], f[i + 1], cfg, rng,
                                                device)
                                    for i in range(len(f) - 1))
        self.from_rgb = nn.ModuleList(
            Conv(cfg.n_colors, f[i], 1, bias=True, equalized=False,
                 padding=0, neg_slope=s, rng=rng, device=device)
            for i in range(len(f)))

    def _block(self, y, i):
        p = self.blocks[i]
        y = avg_pool(y, 2)
        y = _epilogue(p['conv1'](y), self.cfg)
        return _epilogue(p['conv2'](y), self.cfg)

    def _head(self, y):
        s = self.cfg.neg_slope
        y = pixel_norm(leaky_relu(self.head['conv'](y), s))
        y = self.head['conv_out'](y)
        return y.reshape(y.shape[0], -1)

    def forward(self, x, phase: int, alpha=None):
        """x (B, C, R, R) -> critic score (B, 1)."""
        L = self.cfg.n_layers_max
        if alpha is None:
            y = self.from_rgb[L - 1 - phase](x)
            for i in range(L - 1 - phase, L - 1):
                y = self._block(y, i)
            return self._head(y)
        if phase < 1:
            raise ValueError('fade-in requires phase >= 1')
        y_start = self.from_rgb[L - phase](avg_pool(x, 2))
        y_end = self._block(self.from_rgb[L - 1 - phase](x), L - 1 - phase)
        y = fade_in(y_start, y_end, alpha)
        for i in range(L - phase, L - 1):
            y = self._block(y, i)
        return self._head(y)


# --------------------------------------------------------------------------
# Growth state machine (host side; reference models.py:355-392)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class GrowthState:
    """Tracks (phase, alpha) like the reference's mutable nets; ``fading``
    while alpha < 1."""
    cfg: PGConfig
    phase: int = 0
    alpha: float = 1.0

    @property
    def image_size(self) -> int:
        return self.cfg.resolution(self.phase)

    @property
    def fading(self) -> bool:
        return self.alpha < 1.0

    def increase_resolution(self):
        if self.alpha < 1:
            raise ValueError('The previous transition has not ended.')
        self.alpha = 0.0
        self.phase += 1
        if self.image_size > self.cfg.image_size_max:
            raise ValueError(f'The image size ({self.image_size}) is greater '
                             f'than the maximum ({self.cfg.image_size_max})')

    def advance_transition(self, alpha_step=0.1):
        self.alpha += alpha_step

    def set_resolution(self, res: int, alpha=1.0):
        if res % self.image_size:
            raise ValueError(f'The resolution must be divisible by '
                             f'{self.image_size}')
        if not math.log2(res / self.image_size).is_integer():
            raise ValueError(f'{res} is not a power-of-two multiple of '
                             f'{self.image_size}')
        if res > self.cfg.image_size_max:
            raise ValueError(f'{res} exceeds {self.cfg.image_size_max}')
        while self.image_size < res:
            self.increase_resolution()
            self.advance_transition(alpha if self.image_size == res else 1.0)
