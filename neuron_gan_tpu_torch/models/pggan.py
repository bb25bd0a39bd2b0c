"""Progressively-growing GAN (PGGAN) as PyTorch modules, NCHW.

Counterpart of neuron_gan_tpu/models/pggan.py, unpacked or in the 2x2 and
2x4 packed layouts, in float32, 'mixed' or bfloat16.  As there, the
parameters of every phase exist from
the start and the forward takes ``(phase, alpha)``: ``alpha=None`` is the
steady state, a float the fade-in blend (reference models.py:344-351 for
G, :516-524 for D).  Parameter names follow the JAX pytree paths
(``stem.linear``, ``blocks.{i}.conv1``, ``to_rgb.{i}``, ``head.conv_out``,
``from_rgb.{i}``; ``weight``/``bias`` for the JAX ``w``/``b``), so
``convert.py`` maps one onto the other leaf by leaf.

* stem       = eq-Linear(latent -> F0*init^2) + reshape to (F0, init, init)
               + LReLU + PixelNorm + eq-Conv3x3 + LReLU + PixelNorm
* G block i  = up2 bilinear, then 2x [eq-Conv3x3 + LReLU + PixelNorm]
* to_rgb[i]  = plain 1x1 conv + tanh
* D block i  = AvgPool2, then 2x [eq-Conv3x3 + LReLU + PixelNorm]
* from_rgb[i]= plain 1x1 conv with bias
* D head     = eq-Conv3x3 (bias) + LReLU + PixelNorm + eq-Conv(init x init,
               bias, VALID) -> (B, 1) critic score

With ``use_kernels`` every LReLU + PixelNorm of the unpacked G and D blocks
runs in the fused CUDA kernel pair (ops/lrelu_pixel_norm.py), as
``use_pallas`` routes them through the Pallas kernel in the JAX package;
the stem and the head keep the composed ops, as there.

With ``packed_min_res`` the blocks whose convs run at that resolution or
above run in the 2x2 space-to-depth layout (ops/packed.py; the JAX
package's ``_gen_block_any`` / ``_dis_block_any``).  Their level
boundaries are fused into one conv each when ``fused_up2`` /
``fused_pool`` (the default at ``precision=None``), else decomposed.
There ``use_kernels`` also puts the LReLU + 4-group PixelNorm after each
conv1 in the same kernel pair, and runs each conv2 with its epilogue in
the fused packed conv kernel pair (ops/packed_conv_lrelu_pn.py) -- what
``pallas_epilogue`` and ``pallas_conv`` do in the JAX package.

With ``packed_lanes=128`` the packed blocks of 16 channels run in the 2x4
layout (ops/packed.py; JAX ``_use_packed8``, ``_want_packed8_g/_d``): at
fused boundaries natively from the level boundary on (G from the fused
up-conv to to_rgb, D from from_rgb through its 2x4 levels to the exit
into the 2x2 layout), at decomposed ones as a repack around the block's
epilogues and conv2.  The packed state a block hands on is False, True
(2x2) or 'p8' (2x4).  Under ``use_kernels`` both epilogues of a 2x4
block run in the LReLU + PixelNorm pair at 8 groups, conv2 a plain conv
before the second (the JAX package has no 2x4 Pallas kernel).

``compute_dtype`` sets the activations' dtype (``PGConfig.dtype``); the
parameters stay float32 and every conv casts its weight to the
activation's dtype, as the JAX package does.  Under 'mixed' the stem, the
to_rgb image and the critic head run in float32 and the composed
PixelNorms keep float32 statistics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from neuron_gan_tpu_torch.ops import (
    avg_pool, conv2d, equalized_conv2d, equalized_linear, fade_in,
    init_conv2d, init_linear, leaky_relu, pixel_norm, upsample2_bilinear,
)
from neuron_gan_tpu_torch.ops import packed as pk
from neuron_gan_tpu_torch.ops.lrelu_pixel_norm import (
    lrelu_pixel_norm as fused_lrelu_pixel_norm)
from neuron_gan_tpu_torch.ops.packed_conv_lrelu_pn import (
    packed_conv3x3_lrelu_pn)
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
    # 'float32'; 'mixed': bfloat16 activations through the blocks, float32
    # in the stem, the PixelNorm statistics, the to_rgb image and the
    # critic head; 'bfloat16': everything half width.  Parameters and
    # optimizer state stay float32 in every mode.
    compute_dtype: str = 'float32'
    # 'highest' runs float32 convs and matmuls in true float32 (TF32 off);
    # None allows TF32 -- see precision_scope
    precision: Optional[str] = 'highest'
    # every block's LReLU + PixelNorm in the CUDA kernel pairs: unpacked
    # blocks, conv1 of 2x2 ones and both convs of 2x4 ones (at 8 groups)
    # in the LReLU + PixelNorm pair (the JAX package's use_pallas /
    # pallas_epilogue); conv2 of 2x2 blocks fused with its conv
    # (pallas_conv).  The JAX pallas_conv gate also
    # needs precision=None, because its MXU dot runs at default (bf16
    # pass) precision; the fused conv kernel accumulates in true float32,
    # so here it runs at 'highest' too.  Under 'mixed' the unpacked blocks
    # and the 2x4 ones keep the kernel pair, where the JAX package runs its
    # composed f32-stats epilogue: both compute lrelu -> PixelNorm with
    # float32 statistics, up to one bfloat16 rounding (of the lrelu).
    use_kernels: bool = False
    # blocks whose convs run at this resolution or above run in the 2x2
    # space-to-depth packed layout (ops/packed.py); None disables
    packed_min_res: Optional[int] = None
    # 128: packed blocks of 16 channels (64 packed) in the 2x4 layout, as
    # in the JAX package; 64 or None keep the 2x2 layout
    packed_lanes: Optional[int] = None
    # the packed level boundaries fused into one conv each
    # (ops/packed.py::up2_equalized_conv3x3, pool2_*): None = fused iff
    # precision is None, as in the JAX package
    fuse_up2_conv: Optional[bool] = None
    fuse_pool_conv: Optional[bool] = None
    # 'neuron': the neuron-gan variant of this module; 'karras': Karras et
    # al.'s G_paper/D_paper (models/karras.py), which takes no packed layout
    architecture: str = 'neuron'

    def __post_init__(self):
        object.__setattr__(self, 'n_gen_features', tuple(self.n_gen_features))
        object.__setattr__(self, 'n_dis_features', tuple(self.n_dis_features))
        if len(self.n_gen_features) != len(self.n_dis_features):
            raise ValueError('G and D need the same number of levels')
        if self.compute_dtype not in ('float32', 'mixed', 'bfloat16'):
            raise ValueError(f"compute_dtype must be 'float32', 'mixed' or "
                             f"'bfloat16', got {self.compute_dtype!r}")
        if self.precision not in ('highest', None):
            raise ValueError(f"precision must be 'highest' or None, got "
                             f'{self.precision!r}')
        if (self.packed_min_res is not None
                and self.packed_min_res <= self.image_size_init):
            raise ValueError('packed_min_res must exceed the stem/head '
                             'resolution (image_size_init)')
        if self.packed_lanes not in (None, 64, 128):
            raise ValueError(f'packed_lanes must be None, 64 or 128, got '
                             f'{self.packed_lanes}')
        if self.architecture not in ('neuron', 'karras'):
            raise ValueError(f"architecture must be 'neuron' or 'karras', "
                             f'got {self.architecture!r}')
        if self.architecture == 'karras' and self.packed_min_res is not None:
            # the packed layouts build in bilinear upsampling and a critic
            # that pools before its convs
            raise ValueError("architecture 'karras' takes no packed layout: "
                             'packed_min_res must be None')

    @property
    def dtype(self) -> torch.dtype:
        """The activations' dtype through the blocks."""
        return torch.float32 if self.compute_dtype == 'float32' \
            else torch.bfloat16

    @property
    def mixed(self) -> bool:
        return self.compute_dtype == 'mixed'

    @property
    def fused_up2(self) -> bool:
        if self.fuse_up2_conv is None:
            return self.precision is None
        return self.fuse_up2_conv

    @property
    def fused_pool(self) -> bool:
        if self.fuse_pool_conv is None:
            return self.precision is None
        return self.fuse_pool_conv

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
    """The LReLU -> PixelNorm after every unpacked block conv: the CUDA
    kernel pair when cfg.use_kernels, the composed ops otherwise.  Under
    'mixed' the JAX package takes its composed f32-stats epilogue here
    even with its kernels on; the kernel pair computes the same function
    (float32 statistics in every mode) up to one bfloat16 rounding: it
    keeps the LeakyReLU in float32."""
    if cfg.use_kernels:
        return fused_lrelu_pixel_norm(x, 1, cfg.neg_slope, 1e-8)
    return pixel_norm(leaky_relu(x, cfg.neg_slope), f32_stats=cfg.mixed)


def _want_packed(cfg: PGConfig, res: int) -> bool:
    return cfg.packed_min_res is not None and res >= cfg.packed_min_res


def _packed_epilogue(x, cfg: PGConfig):
    """LReLU -> 4-group PixelNorm in the packed domain: the CUDA kernel
    pair at n_groups=4 when cfg.use_kernels, the composed ops otherwise."""
    if cfg.use_kernels:
        return fused_lrelu_pixel_norm(x, 4, cfg.neg_slope, 1e-8)
    return pk.packed_pixel_norm(leaky_relu(x, cfg.neg_slope),
                                f32_stats=cfg.mixed)


def _use_packed8(cfg: PGConfig, x_packed) -> bool:
    """Run this 2x2 block's epilogues and conv2 in the 2x4 layout (the
    decomposed routes' repack)?  Only 64 packed channels (16 original)
    gain lanes in the JAX package's rule; the 2x2 width must be even."""
    return (cfg.packed_lanes == 128 and x_packed.shape[1] == 64
            and x_packed.shape[3] % 2 == 0)


def _want_packed8_g(cfg: PGConfig, out_res: int, feat: int) -> bool:
    """Enter the 2x4 layout natively at this G level boundary: the fused
    up-conv, fewer than 32 channels, and a 2x4 width that is even."""
    return (cfg.packed_lanes == 128 and cfg.fused_up2
            and _want_packed(cfg, out_res) and feat * 4 < 128
            and out_res % 8 == 0)


def _want_packed8_d(cfg: PGConfig, res: int, feat: int) -> bool:
    """Enter or stay in the 2x4 layout at this D level: the fused pool
    boundary, fewer than 32 channels, and a 2x4 width that survives the
    stride-2 pool."""
    return (cfg.packed_lanes == 128 and cfg.fused_pool
            and _want_packed(cfg, res) and feat * 4 < 128
            and res % 8 == 0)


def _packed8_epilogue(x, cfg: PGConfig):
    """LReLU -> 8-group PixelNorm in the 2x4 layout: the CUDA kernel pair
    at n_groups=8 when cfg.use_kernels, the composed ops otherwise.  Under
    'mixed' the JAX package rounds the LeakyReLU to bfloat16 before its
    float32-statistics PixelNorm; the kernel pair keeps it in float32 (as
    in the unpacked blocks, ``_epilogue``)."""
    if cfg.use_kernels:
        return fused_lrelu_pixel_norm(x, 8, cfg.neg_slope, 1e-8)
    return pk.packed_pixel_norm(leaky_relu(x, cfg.neg_slope),
                                f32_stats=cfg.mixed, n_groups=8)


def _packed8_conv_epilogue(x, conv: Conv, cfg: PGConfig):
    """2x4 stride-1 conv3x3 (a plain conv) -> LReLU -> 8-group
    PixelNorm."""
    return _packed8_epilogue(
        pk.packed8_equalized_conv3x3(x, conv.weight, conv.bias,
                                     neg_slope=cfg.neg_slope), cfg)


def _packed_block_tail(x, block, cfg: PGConfig):
    """A 2x2 block after its conv1: epilogue, conv2 and its epilogue, in
    the 2x4 layout when ``_use_packed8`` (repacked around it)."""
    if _use_packed8(cfg, x):
        x = _packed8_epilogue(pk.space_to_depth_w(x), cfg)
        return pk.depth_to_space_w(
            _packed8_conv_epilogue(x, block['conv2'], cfg))
    x = _packed_epilogue(x, cfg)
    return _packed_conv_epilogue(x, block['conv2'], cfg)


def _packed_conv_epilogue(x, conv: Conv, cfg: PGConfig):
    """Packed stride-1 conv3x3 -> LReLU -> 4-group PixelNorm: one fused
    kernel Function when cfg.use_kernels, the composed packed conv and
    epilogue otherwise."""
    if cfg.use_kernels:
        if conv.bias is not None:
            raise NotImplementedError('the fused packed conv kernel takes '
                                      'no bias (block convs have none)')
        w = conv.weight
        scale = pk._eq_scale3x3(w, cfg.neg_slope)
        w_packed = pk.pack_conv3x3_weight(w, scale)
        return packed_conv3x3_lrelu_pn(x, w_packed, cfg.neg_slope, 1e-8)
    return _packed_epilogue(
        pk.packed_equalized_conv3x3(x, conv.weight, conv.bias,
                                    neg_slope=cfg.neg_slope), cfg)


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

    def _block(self, x, packed_in, i: int):
        """Block i (upsample, then two convs at resolution(i+1)); returns
        (x, packed_out): False below packed_min_res, 'p8' where the fused
        up-conv enters the 2x4 layout, else True (2x2)."""
        p, cfg = self.blocks[i], self.cfg
        out_res = cfg.resolution(i + 1)
        if not _want_packed(cfg, out_res):
            x = upsample2_bilinear(x)
            x = _epilogue(p['conv1'](x), cfg)
            return _epilogue(p['conv2'](x), cfg), False
        c1 = p['conv1']
        if cfg.fused_up2 and c1.bias is None:
            # upsample + conv1 as one conv (JAX: 4x fewer MACs, no
            # interleave; sums reordered against the decomposed ops)
            if packed_in == 'p8':
                x = pk.depth_to_space8(x)
            elif packed_in:
                x = pk.depth_to_space(x)
            if _want_packed8_g(cfg, out_res, c1.weight.shape[0]):
                # the level lives in the 2x4 layout from the boundary on
                x = _packed8_epilogue(pk.up2_equalized_conv3x3_p8(
                    x, c1.weight, neg_slope=cfg.neg_slope), cfg)
                return _packed8_conv_epilogue(x, p['conv2'], cfg), 'p8'
            x = pk.up2_equalized_conv3x3(x, c1.weight,
                                         neg_slope=cfg.neg_slope)
        else:
            if packed_in:
                x = pk.packed_upsample2_bilinear(x)
            else:
                x = pk.space_to_depth(upsample2_bilinear(x))
            x = pk.packed_equalized_conv3x3(x, c1.weight, c1.bias,
                                            neg_slope=cfg.neg_slope)
        return _packed_block_tail(x, p, cfg), True

    def _to_rgb(self, x, packed, i: int):
        conv = self.to_rgb[i]
        if packed == 'p8':
            y = pk.packed8_conv1x1(x, conv.weight, conv.bias)
        elif packed:
            y = pk.packed_conv1x1(x, conv.weight, conv.bias)
        else:
            y = conv(x)
        if self.cfg.mixed:
            y = y.float()       # the image leaves G in float32
        y = torch.tanh(y)
        if packed == 'p8':
            return pk.depth_to_space8(y)
        return pk.depth_to_space(y) if packed else y

    def forward(self, z, phase: int, alpha=None):
        """z (B, latent) -> image (B, C, R, R), R = init * 2**phase."""
        cfg = self.cfg
        if cfg.mixed:
            # float32 stem (init-resolution tensors), bfloat16 blocks
            x = self._stem(z.float()).to(cfg.dtype)
        else:
            x = self._stem(z.to(cfg.dtype))
        packed = False
        if alpha is None:
            for i in range(phase):
                x, packed = self._block(x, packed, i)
            return self._to_rgb(x, packed, phase)
        if phase < 1:
            raise ValueError('fade-in requires phase >= 1')
        for i in range(phase - 1):
            x, packed = self._block(x, packed, i)
        im_start = upsample2_bilinear(self._to_rgb(x, packed, phase - 1))
        x2, packed2 = self._block(x, packed, phase - 1)
        return fade_in(im_start, self._to_rgb(x2, packed2, phase), alpha)


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

    def _from_rgb(self, x, res: int, i: int):
        """from_rgb[i] of an image at resolution ``res``; returns
        (y, packed), packed False, True (2x2) or 'p8' (2x4)."""
        conv, cfg = self.from_rgb[i], self.cfg
        if not _want_packed(cfg, res):
            return conv(x), False
        if _want_packed8_d(cfg, res, conv.weight.shape[0]):
            return pk.packed8_conv1x1(pk.space_to_depth8(x), conv.weight,
                                      conv.bias), 'p8'
        return pk.packed_conv1x1(pk.space_to_depth(x), conv.weight,
                                 conv.bias), True

    def _block(self, y, packed_in, i: int, entry_res: int):
        """Block i: pool to entry_res/2, then two convs there; returns
        (y, packed_out): False below packed_min_res, 'p8' where a 2x4 input
        stays in the 2x4 layout, else True (2x2)."""
        p, cfg = self.blocks[i], self.cfg
        c1 = p['conv1']
        packed_out = _want_packed(cfg, entry_res // 2)
        if packed_in == 'p8' and cfg.fused_pool and packed_out:
            # the native 2x4 boundary: stay in the 2x4 layout, or exit
            # into the 2x2 layout with a stride (2, 1) conv
            out_p8 = _want_packed8_d(cfg, entry_res // 2, c1.weight.shape[0])
            y = pk.pool2_equalized_conv3x3_p8(y, c1.weight, c1.bias,
                                              neg_slope=cfg.neg_slope,
                                              out_packed8=out_p8)
            if out_p8:
                y = _packed8_epilogue(y, cfg)
                return _packed8_conv_epilogue(y, p['conv2'], cfg), 'p8'
            return _packed_block_tail(y, p, cfg), True
        if packed_in == 'p8':
            # no native boundary for this exit: repack to the 2x2 layout
            y = pk.depth_to_space_w(y)
        if packed_in and cfg.fused_pool:
            # avg-pool (+ repack) + conv1 as one conv
            fused = (pk.pool2_equalized_conv3x3 if packed_out
                     else pk.pool2_unpacked_equalized_conv3x3)
            y = fused(y, c1.weight, c1.bias, neg_slope=cfg.neg_slope)
        else:
            y = pk.packed_avg_pool2(y) if packed_in else avg_pool(y, 2)
            y = (pk.packed_equalized_conv3x3(pk.space_to_depth(y), c1.weight,
                                             c1.bias, neg_slope=cfg.neg_slope)
                 if packed_out else c1(y))
        if not packed_out:
            y = _epilogue(y, cfg)
            return _epilogue(p['conv2'](y), cfg), False
        return _packed_block_tail(y, p, cfg), True

    def _head(self, y):
        s = self.cfg.neg_slope
        if self.cfg.mixed:
            y = y.float()       # float32 head: full-precision scores
        y = pixel_norm(leaky_relu(self.head['conv'](y), s))
        y = self.head['conv_out'](y)
        return y.reshape(y.shape[0], -1)

    def forward(self, x, phase: int, alpha=None):
        """x (B, C, R, R) -> critic score (B, 1)."""
        x = x.to(self.cfg.dtype)
        L = self.cfg.n_layers_max
        res = self.cfg.resolution(phase)
        if alpha is None:
            y, packed = self._from_rgb(x, res, L - 1 - phase)
            first = L - 1 - phase
        else:
            if phase < 1:
                raise ValueError('fade-in requires phase >= 1')
            y_start, _ = self._from_rgb(avg_pool(x, 2), res // 2, L - phase)
            y, packed = self._from_rgb(x, res, L - 1 - phase)
            y, packed = self._block(y, packed, L - 1 - phase, res)
            y = fade_in(y_start, y, alpha)
            res //= 2
            first = L - phase
        for i in range(first, L - 1):
            y, packed = self._block(y, packed, i, res)
            res //= 2
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
