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

Each group width C_g = C / n_groups that is a power of two up to 512 has
its own instance of each kernel (a thread takes 16 bytes of pixels of S
channels, the group's sums formed across lanes); the wide ones, 256 and
512, are kernels of their own name (``WIDE_WIDTHS``); any other width
launches the runtime-width instance (``kernel_instance``).  ``lrelu_pixel_norm_sliced``
and ``lrelu_pixel_norm_bwd_sliced`` repeat the kernels' order of summation
on the CPU.

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
``launches_by_case`` counts kernel launches, and nothing else, by ('k1'
or 'k2', dtype name, x's shape, ``n_groups``), a launch of the
runtime-width instance as 'k1/runtime' or 'k2/runtime', of a wide one as
'k1/wide' or 'k2/wide';
``launches_by_kernel`` sums it by kernel, dtype name and ``n_groups``.
"""

import collections
import ctypes

import torch

from neuron_gan_tpu_torch.runtime import kernels

launches_by_case = collections.Counter()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# group widths with a template instance of each kernel
# (csrc/lrelu_pixel_norm.cu); any other width takes the runtime-width one.
# The wide ones are kernels of their own name (lrelu_pn_wide_fwd_kernel,
# lrelu_pn_wide_bwd_kernel), a thread taking C_g / 32 channels
WIDE_WIDTHS = (256, 512)
TEMPLATE_WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128) + WIDE_WIDTHS


def kernel_instance(c_g, dtype=torch.float32):
    """(template width, S) of the kernel instance that takes groups of
    ``c_g`` channels in ``dtype``: for a width in TEMPLATE_WIDTHS (c_g, S),
    a thread summing S channels before the lanes' butterfly, as measured
    on an H100 -- min(c_g, 4) in float32; min(c_g, 8) in bfloat16, but 4
    at c_g >= 64; c_g / 32 at the wide widths, whose vector's lanes are a
    whole warp; else (None, c_g), the runtime-width instance, whose
    thread walks the whole group (csrc/lrelu_pixel_norm.cu, ``Shape``)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f'lrelu_pixel_norm kernel takes float32 or bfloat16, '
                        f'got {dtype}')
    if c_g not in TEMPLATE_WIDTHS:
        return None, c_g
    if c_g in WIDE_WIDTHS:
        return c_g, c_g // 32
    return c_g, min(c_g, 4 if dtype == torch.float32 or c_g >= 64 else 8)


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


def _sliced_sums(t, s):
    """Sums over dim 2 of a grouped (B, G, C_g, ...) float32 ``t`` in the
    kernels' order: each thread's slice of ``s`` channels in channel order,
    then the slices by a butterfly (pairs, then pairs of pairs: the lanes'
    ``__shfl_xor_sync``).  Returns (B, G, 1, ...)."""
    b, n_groups, c_g = t.shape[:3]
    t = t.reshape(b, n_groups, c_g // s, s, *t.shape[3:])
    acc = t[:, :, :, 0]
    for i in range(1, s):
        acc = acc + t[:, :, :, i]
    while acc.shape[2] > 1:
        acc = acc[:, :, 0::2] + acc[:, :, 1::2]
    return acc


def _sliced_stats(x, n_groups, neg_slope, eps):
    """(x in float32, y grouped, r, C_g, S) as the kernels form them."""
    xf = x.float()
    y = _grouped(torch.where(xf >= 0, xf, xf * neg_slope), n_groups)
    c_g = y.shape[2]
    _, s = kernel_instance(c_g, x.dtype)
    r = torch.rsqrt(_sliced_sums(y * y, s) / c_g + eps)
    return xf, y, r, c_g, s


def lrelu_pixel_norm_sliced(x, n_groups=1, neg_slope=0.2, eps=1e-8):
    """The forward kernel's arithmetic on the CPU, in its order of
    summation (``kernel_instance``'s S, ``_sliced_sums``).  Runs on nothing
    on the card's main path: the CPU tests hold the kernel's order against
    the JAX package with it."""
    _, y, r, _, _ = _sliced_stats(x, n_groups, neg_slope, eps)
    return (y * r).reshape(x.shape).to(x.dtype)


def lrelu_pixel_norm_bwd_sliced(x, g, n_groups=1, neg_slope=0.2, eps=1e-8):
    """The backward kernel's arithmetic on the CPU, in its order of
    summation: k = r^3 * s / C_g, dx = lrelu'(x) * (g * r - y * k)."""
    xf, y, r, c_g, s = _sliced_stats(x, n_groups, neg_slope, eps)
    gf = _grouped(g.float(), n_groups)
    k = r * r * r * (_sliced_sums(gf * y, s) / c_g)
    dy = (gf * r - y * k).reshape(x.shape)
    return torch.where(xf >= 0, dy, dy * neg_slope).to(x.dtype)


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


def declare_entry_points(lib):
    """Set the ctypes argument and result types of a library built from
    csrc/lrelu_pixel_norm.cu (or a variant of it); returns ``lib``."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    f32, i32 = ctypes.c_float, ctypes.c_int
    lib.lrelu_pixel_norm_fwd.argtypes = [ptr, ptr, i64, i64, i64, i64,
                                         f32, f32, i32, ptr]
    lib.lrelu_pixel_norm_bwd.argtypes = [ptr, ptr, ptr, i64, i64, i64,
                                         i64, f32, f32, i32, ptr]
    lib.lrelu_pixel_norm_slice.argtypes = [i64, i32]
    lib.lrelu_pixel_norm_regs.argtypes = [i64, i32, i32]
    fns = [lib.lrelu_pixel_norm_fwd, lib.lrelu_pixel_norm_bwd,
           lib.lrelu_pixel_norm_slice, lib.lrelu_pixel_norm_regs]
    if hasattr(lib, 'lrelu_pixel_norm_runtime'):
        lib.lrelu_pixel_norm_runtime.argtypes = [ptr, ptr, ptr, i64, i64, i64,
                                                 i64, f32, f32, i32, ptr]
        fns.append(lib.lrelu_pixel_norm_runtime)
    for fn in fns:
        fn.restype = ctypes.c_int
    return lib


def _lib():
    lib = kernels.load('lrelu_pixel_norm')
    if lib.lrelu_pixel_norm_fwd.argtypes is None:
        declare_entry_points(lib)
    return lib


def dtype_name(t):
    """'float32' or 'bfloat16': the launch counters' key for ``t``."""
    return str(t.dtype).removeprefix('torch.')


def kernel_slice(c_g, dtype=torch.float32):
    """S of the built kernel instance for group width ``c_g`` (0: the
    runtime-width instance), as the CUDA source defines it."""
    return _lib().lrelu_pixel_norm_slice(c_g, _DTYPE_CODES[dtype])


def kernel_regs(c_g, dtype=torch.float32, bwd=False):
    """Registers a thread of the forward (or backward) kernel instance for
    group width ``c_g`` and ``dtype`` uses."""
    return _lib().lrelu_pixel_norm_regs(c_g, _DTYPE_CODES[dtype], int(bwd))


def _case(kernel, x, n_groups):
    """``launches_by_case``'s key of a launch of ``kernel`` ('k1', 'k2')."""
    c_g = x.shape[1] // n_groups
    if c_g not in TEMPLATE_WIDTHS:
        kernel += '/runtime'
    elif c_g in WIDE_WIDTHS:
        kernel += '/wide'
    return kernel, dtype_name(x), tuple(x.shape), n_groups


def launches_by_kernel():
    """{'k1': {(dtype name, n_groups): launches}, 'k2': ...}: the sums of
    ``launches_by_case`` over shapes and instances."""
    out = {'k1': collections.Counter(), 'k2': collections.Counter()}
    for (kernel, dtype, _, n_groups), n in launches_by_case.items():
        out[kernel.split('/')[0]][dtype, n_groups] += n
    return out


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
    launches_by_case[_case('k1', x, n_groups)] += 1
    return out


def runtime_width(x, g=None, n_groups=1, neg_slope=0.2, eps=1e-8):
    """K1 (``g`` None) or K2 of the runtime-width instance at any group
    width: what the wide instances were measured against (chip_smoke.py).
    Counted nowhere; no training path calls it."""
    _check_device(x)
    shape = _kernel_args(n_groups, x, *(() if g is None else (g,)))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().lrelu_pixel_norm_runtime(
            x.data_ptr(), None if g is None else g.data_ptr(),
            out.data_ptr(), *shape, neg_slope, eps, _DTYPE_CODES[x.dtype],
            stream)
    _raise_on(rc, 'lrelu_pixel_norm runtime-width')
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
    launches_by_case[_case('k2', x, n_groups)] += 1
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
