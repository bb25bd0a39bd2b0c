"""Plain PyTorch PGGAN generator and critic: the benchmark's reference.

Written from the model's equations (oliviertrottier/neuron-gan, models.py),
NCHW, float32, with ``torch.nn.functional`` ops only: no packed layout, no
fused kernel, no cast.  Parameters are a flat dict of tensors under the
names the port's modules give them, so the benchmark makes one set of
weights and hands the same values to both sides.

* G stem: equalized linear (latent -> F0*init^2, no bias), reshape,
  LReLU, PixelNorm, equalized conv3x3 (no bias), LReLU, PixelNorm;
* G block i: bilinear x2 upsample (align_corners=False), then twice an
  equalized conv3x3 (no bias), LReLU, PixelNorm;
* to_rgb[i]: plain 1x1 conv (no bias), tanh;
* D from_rgb[i]: plain 1x1 conv with bias;
* D block i: 2x2 average pool, then twice an equalized conv3x3 (no bias),
  LReLU, PixelNorm;
* D head: equalized conv3x3 with bias, LReLU, PixelNorm, equalized conv of
  the whole init x init map with bias -> (B, 1).

Equalized layers scale the weight by sqrt(2 / (1 + slope^2)) / sqrt(fan_in)
at every forward; LReLU is where(x >= 0, x, slope * x); PixelNorm divides by
sqrt(mean over channels of x^2 + 1e-8).  A fade (``alpha``) blends the
previous level's output, upsampled (G) or pooled first (D), as the
reference's progressive growth does.

``precision`` is 'float32'; 'bf16', a 'mixed' program's own recipe: what it
keeps in bfloat16 (the blocks' activations, weights and gradients, the
to_rgb and from_rgb convs, D's input) rounded to bfloat16 (``low``), the
stem and the head in float32, which measures how far that precision alone
lies from float32 on given weights; or one of the two controls that a
correct program must beat: 'tf32' rounds every product's operands to
TF32's 10-bit mantissa (``quantize``; on the card the caller also lets
cuDNN and cuBLAS run the backward's products in TF32), 'fp8' takes the
'bf16' recipe one step lower, float8 in place of bfloat16.
"""

import math

import torch
import torch.nn.functional as F

PN_EPS = 1e-8


def gain(slope):
    return math.sqrt(2.0 / (1.0 + slope * slope))


def _round_tf32(x):
    """x rounded to the nearest value with a 10-bit mantissa (ties to
    even), as TF32 tensor cores read a float32 operand."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def _round_fp8(x, dtype=torch.float8_e4m3fn):
    """x through an 8-bit float type (e4m3 by default) with a per-tensor
    scale that maps its largest magnitude to the type's largest value."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = torch.finfo(dtype).max / amax
    return (x * s).to(dtype).to(x.dtype) / s


def quantize(x, precision):
    """``x`` as a product's operand in ``precision`` ('float32' or
    'tf32'), its gradient passed straight through."""
    if precision != 'tf32':
        return x
    return x + (_round_tf32(x.detach()) - x.detach())


class _GradFp8(torch.autograd.Function):
    """Identity; the gradient that flows back through it is rounded to
    float8 e5m2 (per-tensor scale), as an fp8 backward carries it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g + (_round_fp8(g.detach(), torch.float8_e5m2) - g.detach())


class _GradBf16(torch.autograd.Function):
    """Identity; the gradient that flows back through it is rounded to
    bfloat16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g + (g.detach().bfloat16().float() - g.detach())


def low(x, precision):
    """``x`` as a 'mixed' program keeps a block's activation or weight:
    for 'bf16' its value and gradient through bfloat16, for 'fp8' one step
    lower, its value through e4m3 and its gradient through e5m2; unchanged
    in any other precision."""
    if precision == 'bf16':
        return _GradBf16.apply(x + (x.detach().bfloat16().float() - x.detach()))
    if precision != 'fp8':
        return x
    return _GradFp8.apply(x + (_round_fp8(x.detach()) - x.detach()))


def _conv(x, w, b=None, padding=0, precision='float32'):
    if precision in ('fp8', 'bf16'):
        q = precision
        return low(F.conv2d(low(x, q), low(w, q),
                            None if b is None else low(b, q),
                            padding=padding), q)
    return F.conv2d(quantize(x, precision), quantize(w, precision), b,
                    padding=padding)


def _lrelu(x, slope):
    return torch.where(x >= 0, x, x * slope)


def _pn(x):
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + PN_EPS)


def _act(x, slope):
    return _pn(_lrelu(x, slope))


def _eq(w, slope):
    fan_in = w[0].numel()
    return w * (gain(slope) / math.sqrt(fan_in))


def resolution(model, phase):
    return model['image_size_init'] * 2 ** phase


def param_specs(model):
    """[(net, name, shape, init std)] of every parameter, G's then D's, in
    a fixed order; a std of 0 is a bias, which starts at zero.  Weights
    start as kaiming normals (fan_in, the LReLU gain), as the model's init
    does."""
    fg, fd = model['n_gen_features'], model['n_dis_features']
    lat, init, c = model['latent_dim'], model['image_size_init'], model['n_colors']
    g_ = gain(model['neg_slope'])
    out = []

    def w(net, name, shape):
        out.append((net, name, tuple(shape),
                    g_ / math.sqrt(math.prod(shape[1:]))))

    def b(net, name, n):
        out.append((net, name, (n,), 0.0))

    w('g', 'stem.linear.weight', (fg[0] * init * init, lat))
    w('g', 'stem.conv.weight', (fg[0], fg[0], 3, 3))
    for i in range(len(fg) - 1):
        w('g', f'blocks.{i}.conv1.weight', (fg[i + 1], fg[i], 3, 3))
        w('g', f'blocks.{i}.conv2.weight', (fg[i + 1], fg[i + 1], 3, 3))
    for i in range(len(fg)):
        w('g', f'to_rgb.{i}.weight', (c, fg[i], 1, 1))
    w('d', 'head.conv.weight', (fd[-1], fd[-1], 3, 3))
    b('d', 'head.conv.bias', fd[-1])
    w('d', 'head.conv_out.weight', (1, fd[-1], init, init))
    b('d', 'head.conv_out.bias', 1)
    for i in range(len(fd) - 1):
        w('d', f'blocks.{i}.conv1.weight', (fd[i + 1], fd[i], 3, 3))
        w('d', f'blocks.{i}.conv2.weight', (fd[i + 1], fd[i + 1], 3, 3))
    for i in range(len(fd)):
        w('d', f'from_rgb.{i}.weight', (fd[i], c, 1, 1))
        b('d', f'from_rgb.{i}.bias', fd[i])
    return out


def make_weights(model, generator):
    """({name: G tensor}, {name: D tensor}) drawn from ``generator`` on its
    device in one call: float32, as the port keeps its parameters."""
    specs = param_specs(model)
    n = sum(math.prod(s) for _, _, s, std in specs if std)
    flat = torch.randn(n, generator=generator, device=generator.device)
    nets, at = {'g': {}, 'd': {}}, 0
    for net, name, shape, std in specs:
        if std:
            k = math.prod(shape)
            nets[net][name] = flat[at:at + k].view(shape) * std
            at += k
        else:
            nets[net][name] = torch.zeros(shape, device=generator.device)
    return nets['g'], nets['d']


def _fade(start, end, alpha):
    return start + alpha * (end - start)


def generator(p, z, phase, model, alpha=None, precision='float32'):
    """G: latents (B, latent) -> images (B, C, R, R) at ``phase``."""
    s, init = model['neg_slope'], model['image_size_init']
    f0 = model['n_gen_features'][0]
    q = precision
    # the stem runs in float32 in a 'mixed' program: fp8 leaves it alone
    q_stem = q if q == 'tf32' else 'float32'
    w = _eq(p['stem.linear.weight'], s)
    x = F.linear(quantize(z, q_stem), quantize(w, q_stem))
    x = _act(x.reshape(-1, f0, init, init), s)
    x = _act(_conv(x, _eq(p['stem.conv.weight'], s), padding=1,
                   precision=q_stem), s)

    x = low(x, q)

    def block(x, i):
        x = low(F.interpolate(x, scale_factor=2, mode='bilinear',
                              align_corners=False), q)
        for c in ('conv1', 'conv2'):
            x = low(_act(_conv(x, _eq(p[f'blocks.{i}.{c}.weight'], s),
                               padding=1, precision=q), s), q)
        return x

    def to_rgb(x, i):
        return torch.tanh(_conv(x, p[f'to_rgb.{i}.weight'], precision=q))

    if alpha is None:
        for i in range(phase):
            x = block(x, i)
        return to_rgb(x, phase)
    for i in range(phase - 1):
        x = block(x, i)
    start = F.interpolate(to_rgb(x, phase - 1), scale_factor=2,
                          mode='bilinear', align_corners=False)
    return _fade(start, to_rgb(block(x, phase - 1), phase), alpha)


def critic(p, x, phase, model, alpha=None, precision='float32'):
    """D: images (B, C, R, R) at ``phase`` -> scores (B, 1)."""
    s, q = model['neg_slope'], precision
    n = len(model['n_dis_features'])

    def from_rgb(x, i):
        return _conv(x, p[f'from_rgb.{i}.weight'], p[f'from_rgb.{i}.bias'],
                     precision=q)

    def block(y, i):
        y = low(F.avg_pool2d(y, 2), q)
        for c in ('conv1', 'conv2'):
            y = low(_act(_conv(y, _eq(p[f'blocks.{i}.{c}.weight'], s),
                               padding=1, precision=q), s), q)
        return y

    x = low(x, q)
    first = n - 1 - phase
    y = from_rgb(x, first)
    if alpha is not None:
        start = from_rgb(F.avg_pool2d(x, 2), first + 1)
        y = _fade(start, block(y, first), alpha)
        first += 1
    for i in range(first, n - 1):
        y = block(y, i)
    # the head runs in float32 in a 'mixed' program, as the stem
    q_head = q if q == 'tf32' else 'float32'
    y = _act(_conv(y, _eq(p['head.conv.weight'], s), p['head.conv.bias'],
                   padding=1, precision=q_head), s)
    y = _conv(y, _eq(p['head.conv_out.weight'], s), p['head.conv_out.bias'],
              precision=q_head)
    return y.reshape(y.shape[0], -1)
