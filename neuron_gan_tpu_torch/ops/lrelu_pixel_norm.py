"""Fused LeakyReLU + grouped PixelNorm: the CUDA kernel pair and its plain
PyTorch version.

Replaces neuron_gan_tpu/ops/pallas_kernels.py::_grouped_fwd_kernel (the
forward) and ::_grouped_bwd_kernel (the backward); the CUDA source is
csrc/lrelu_pixel_norm.cu.  Channels are dim 1 (NCHW, or (rows, C) for a 2-D
tensor); ``n_groups`` splits them into contiguous groups, each normalized
on its own (1 = plain PixelNorm, 4 = the packed layout's parity groups).
Statistics in float32; output in ``x.dtype`` (float32 or bfloat16).

Bound: bytes, not operations.  At the largest shape of the training path,
(8, 16, 512, 512) float32, the forward moves 268 MB (about 80 us at the
H100's 3.35 TB/s) and the backward 403 MB (about 120 us); in bfloat16
half of that.  The measured times are in PERF.md.

Gradients mirror the JAX package's two custom VJPs:

* ``LReluPixelNorm``: forward = the forward kernel; backward = the second
  Function below.
* ``LReluPixelNormBwd``: forward = the backward kernel; its own backward
  autodiffs the plain backward ``lrelu_pixel_norm_bwd_plain`` (the
  counterpart of ``_grouped_bwd_pure``), so the WGAN-GP's gradient of a
  gradient composes through the kernel.  Third order is not defined.

The same two Functions run on both devices; only the innermost launch
differs.  A CPU tensor takes the plain version; a CUDA tensor launches the
kernel, or raises if the kernel cannot take it -- never a silent fall back.
``fwd_launches`` and ``bwd_launches`` count kernel launches by (dtype
name, ``n_groups``), and nothing else; ``launches_by_case`` counts the
same launches by ('k1' or 'k2', dtype name, x's shape, ``n_groups``).
"""

import collections
import ctypes

import torch

from neuron_gan_tpu_torch.runtime import kernels

fwd_launches = collections.Counter()
bwd_launches = collections.Counter()
launches_by_case = collections.Counter()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _grouped(t, n_groups):
    b, c = t.shape[:2]
    return t.reshape(b, n_groups, c // n_groups, *t.shape[2:])


def lrelu_pixel_norm_plain(x, n_groups=1, neg_slope=0.2, eps=1e-8):
    """Plain version of the forward kernel."""
    xf = x.float()
    y = _grouped(torch.where(xf >= 0, xf, xf * neg_slope), n_groups)
    m = torch.mean(y * y, dim=2, keepdim=True)
    return (y * torch.rsqrt(m + eps)).reshape(x.shape).to(x.dtype)


def lrelu_pixel_norm_bwd_plain(x, g, n_groups=1, neg_slope=0.2, eps=1e-8):
    """Plain version of the backward kernel: dx for cotangent g.
    Differentiable (it supplies the backward's own gradient)."""
    c = x.shape[1] // n_groups
    y = torch.where(x >= 0, x, x * neg_slope)
    yf = _grouped(y.float(), n_groups)
    gf = _grouped(g.float(), n_groups)
    m = torch.mean(yf * yf, dim=2, keepdim=True)
    s = torch.sum(gf * yf, dim=2, keepdim=True)
    r = torch.rsqrt(m + eps)
    dy = (gf * r - yf * (r * r * r) * (s / c)).reshape(x.shape)
    return torch.where(x >= 0, dy, dy * neg_slope).to(x.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _kernel_args(n_groups, *tensors):
    x = tensors[0]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'lrelu_pixel_norm kernel takes float32 or bfloat16, '
                        f'got {x.dtype}')
    if x.dim() < 2:
        raise ValueError(f'lrelu_pixel_norm needs (B, C, ...), got '
                         f'{tuple(x.shape)}')
    for t in tensors:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError('lrelu_pixel_norm kernel inputs must share '
                             'shape, dtype and device')
        if not t.is_contiguous():
            raise ValueError('lrelu_pixel_norm kernel needs contiguous '
                             'NCHW inputs')
    b, c = x.shape[:2]
    if n_groups < 1 or c % n_groups:
        raise ValueError(f'{c} channels do not split into {n_groups} groups')
    hw = x[0, 0].numel() if b else 0
    return (ctypes.c_int64(b), ctypes.c_int64(c), ctypes.c_int64(hw),
            ctypes.c_int64(n_groups))


def _lib():
    lib = kernels.load('lrelu_pixel_norm')
    if lib.lrelu_pixel_norm_fwd.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        f32, i32 = ctypes.c_float, ctypes.c_int
        lib.lrelu_pixel_norm_fwd.argtypes = [ptr, ptr, i64, i64, i64, i64,
                                             f32, f32, i32, ptr]
        lib.lrelu_pixel_norm_bwd.argtypes = [ptr, ptr, ptr, i64, i64, i64,
                                             i64, f32, f32, i32, ptr]
        lib.lrelu_pixel_norm_fwd.restype = ctypes.c_int
        lib.lrelu_pixel_norm_bwd.restype = ctypes.c_int
    return lib


def dtype_name(t):
    """'float32' or 'bfloat16': the launch counters' key for ``t``."""
    return str(t.dtype).removeprefix('torch.')


def _check_device(x):
    if x.device.type != 'cuda':
        raise RuntimeError(f'lrelu_pixel_norm has no kernel for device '
                           f'{x.device}')


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f'{what} kernel launch failed with CUDA error {rc}')


def _fwd(x, n_groups, neg_slope, eps):
    if x.device.type == 'cpu':
        return lrelu_pixel_norm_plain(x, n_groups, neg_slope, eps)
    _check_device(x)
    shape = _kernel_args(n_groups, x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().lrelu_pixel_norm_fwd(
            x.data_ptr(), out.data_ptr(), *shape, neg_slope, eps,
            _DTYPE_CODES[x.dtype], stream)
    _raise_on(rc, 'lrelu_pixel_norm forward')
    fwd_launches[dtype_name(x), n_groups] += 1
    launches_by_case['k1', dtype_name(x), tuple(x.shape), n_groups] += 1
    return out


def _bwd(x, g, n_groups, neg_slope, eps):
    if x.device.type == 'cpu':
        return lrelu_pixel_norm_bwd_plain(x, g, n_groups, neg_slope, eps)
    _check_device(x)
    shape = _kernel_args(n_groups, x, g)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().lrelu_pixel_norm_bwd(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), *shape, neg_slope,
            eps, _DTYPE_CODES[x.dtype], stream)
    _raise_on(rc, 'lrelu_pixel_norm backward')
    bwd_launches[dtype_name(x), n_groups] += 1
    launches_by_case['k2', dtype_name(x), tuple(x.shape), n_groups] += 1
    return dx


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class LReluPixelNormBwd(torch.autograd.Function):
    """dx = backward kernel (x, g); differentiable once more through the
    plain backward (the GP's second order)."""

    @staticmethod
    def forward(ctx, x, g, n_groups, neg_slope, eps):
        ctx.save_for_backward(x, g)
        ctx.cfg = (n_groups, neg_slope, eps)
        return _bwd(x, g, n_groups, neg_slope, eps)

    @staticmethod
    def backward(ctx, ct):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                'lrelu_pixel_norm: third-order gradients are not defined')
        x, g = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            gd = g.detach().requires_grad_()
            dx = lrelu_pixel_norm_bwd_plain(xd, gd, *ctx.cfg)
            gx, gg = torch.autograd.grad(dx, (xd, gd), ct)
        return gx, gg, None, None, None


class LReluPixelNorm(torch.autograd.Function):
    """out = forward kernel (x); backward = LReluPixelNormBwd."""

    @staticmethod
    def forward(ctx, x, n_groups, neg_slope, eps):
        ctx.save_for_backward(x)
        ctx.cfg = (n_groups, neg_slope, eps)
        return _fwd(x, n_groups, neg_slope, eps)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        dx = LReluPixelNormBwd.apply(x, g.contiguous(), *ctx.cfg)
        return dx, None, None, None


def lrelu_pixel_norm(x, n_groups=1, neg_slope=0.2, eps=1e-8):
    """Fused LeakyReLU + grouped PixelNorm over dim 1; first- and
    second-order differentiable."""
    return LReluPixelNorm.apply(x, n_groups, neg_slope, eps)
