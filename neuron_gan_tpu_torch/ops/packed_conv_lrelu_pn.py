"""Fused packed conv3x3 + LeakyReLU + 4-group PixelNorm: the CUDA kernel
pair and its plain PyTorch version.

Replaces neuron_gan_tpu/ops/pallas_conv.py: ``_fwd_kernel`` (the forward,
K3) and ``_dz_kernel`` (the one-pass dz of its backward, K4); the CUDA
source is csrc/packed_conv_lrelu_pn.cu.  The input is a packed activation
(B, K, H, W) and ``w_packed`` a packed (N, K, 3, 3) kernel with the
equalized-LR scale folded in (ops/packed.py::pack_conv3x3_weight); the N
output channels are 4 parity groups of C = N / 4.  The forward returns

    y (B, N, H, W)   lrelu(conv(x)) normalized per group, float32
    r (B, 4, H, W)   each group's rsqrt scale, float32 (the JAX package
                     keeps it as (B, H*W, 4): the same numbers, transposed)

so the backward never needs the pre-activation: u = y / r.

Gradients mirror the JAX package's two custom VJPs:

* ``PackedConvLReluPN`` (``_fused_pair``): forward = K3, saving
  (x, w_packed, y, r); backward takes (ct_y, ct_r), runs ``Dz`` (K4) and
  then the conv's own adjoints for dx and dw, kept differentiable
  (``aten.convolution_backward``: what autograd of ``F.conv2d`` calls,
  without re-running the forward conv).
* ``Dz`` (``_dz_call``): forward = K4; its own backward autodiffs the plain
  mirror ``packed_dz_plain`` (``_dz_pure``), so the WGAN-GP's gradient of
  a gradient composes.  Third order is not defined.

``ct_r`` is zero in a first-order pass but live under the GP: the backward
consumes the saved r, so the outer differentiation sends a cotangent into
it, and the Function's backward runs again with that cotangent.  Unused
outputs' cotangents arrive as zeros (``set_materialize_grads(True)``).

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
or raises if they cannot take it -- never a silent fall back.  Both kernels
are float32 only: bfloat16 arrives with ``compute_dtype='mixed'`` (ROADMAP
A5).  ``conv_launches`` and ``dz_launches`` count kernel launches, and
nothing else.
"""

import ctypes

import torch
import torch.nn.functional as F

from neuron_gan_tpu_torch.runtime import kernels

conv_launches = 0
dz_launches = 0

# output widths N the forward kernel is instantiated for (C = N / 4)
KERNEL_WIDTHS = (16, 32, 64, 128)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _groups(t):
    b, n = t.shape[:2]
    return t.reshape(b, 4, n // 4, *t.shape[2:])


def packed_conv_lrelu_pn_plain(x, w_packed, neg_slope=0.2, eps=1e-8):
    """Plain version of the forward kernel: (y, r).  Differentiable."""
    z = F.conv2d(x, w_packed.to(x.dtype), padding=1).float()
    u = _groups(torch.where(z >= 0, z, z * neg_slope))
    r = torch.rsqrt(torch.mean(u * u, dim=2) + eps)          # (B, 4, H, W)
    y = (u * r.unsqueeze(2)).reshape(z.shape).to(x.dtype)
    return y, r


def packed_dz_plain(y, r, g, ct_r, neg_slope=0.2):
    """Plain version of the dz kernel (mirror of ``_dz_pure``): dz from the
    block output y, the scales r, the cotangent g of y and the cotangent
    ct_r of r.  Differentiable (it supplies the dz kernel's gradient)."""
    c = y.shape[1] // 4
    yf, gf = _groups(y.float()), _groups(g.float())
    s = r.unsqueeze(2)
    u = yf / s
    t = torch.sum(gf * u, dim=2, keepdim=True) + ct_r.unsqueeze(2)
    du = gf * s - u * (s ** 3) * (t / c)
    dz = torch.where(u >= 0, du, du * neg_slope)
    return dz.reshape(y.shape).to(y.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check_conv_args(x, w_packed):
    if x.dtype != torch.float32 or w_packed.dtype != torch.float32:
        raise TypeError(f'packed_conv_lrelu_pn kernel takes float32 (bfloat16 '
                        f'is ROADMAP A5), got {x.dtype} and {w_packed.dtype}')
    if x.dim() != 4 or w_packed.dim() != 4:
        raise ValueError('packed_conv_lrelu_pn needs x (B, K, H, W) and '
                         'w_packed (N, K, 3, 3)')
    n, k, kh, kw = w_packed.shape
    if (kh, kw) != (3, 3) or k != x.shape[1]:
        raise ValueError(f'w_packed {tuple(w_packed.shape)} does not fit x '
                         f'{tuple(x.shape)}')
    if n not in KERNEL_WIDTHS:
        raise ValueError(f'packed_conv_lrelu_pn kernel takes N in '
                         f'{KERNEL_WIDTHS} output channels, got {n}')
    if x.device != w_packed.device:
        raise ValueError('x and w_packed must share a device')
    if not x.is_contiguous():
        raise ValueError('packed_conv_lrelu_pn kernel needs a contiguous '
                         'NCHW x')


def _check_dz_args(y, r, g, ct_r):
    for t in (y, r, g, ct_r):
        if t.dtype != torch.float32:
            raise TypeError(f'packed dz kernel takes float32 (bfloat16 is '
                            f'ROADMAP A5), got {t.dtype}')
        if t.device != y.device or not t.is_contiguous():
            raise ValueError('packed dz kernel inputs must be contiguous and '
                             'share a device')
    if y.dim() != 4 or y.shape[1] % 4:
        raise ValueError(f'packed dz needs y (B, 4C, H, W), got '
                         f'{tuple(y.shape)}')
    b, _, h, w = y.shape
    if g.shape != y.shape or r.shape != (b, 4, h, w) or \
            ct_r.shape != r.shape:
        raise ValueError('packed dz: g must match y, and r, ct_r be '
                         '(B, 4, H, W)')


def _lib():
    lib = kernels.load('packed_conv_lrelu_pn')
    if lib.packed_conv_lrelu_pn_fwd.argtypes is None:
        ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        lib.packed_conv_lrelu_pn_fwd.argtypes = [ptr, ptr, ptr, ptr, i64, i64,
                                                 i64, i64, i64, f32, f32, ptr]
        lib.packed_conv_lrelu_pn_dz.argtypes = [ptr, ptr, ptr, ptr, ptr, i64,
                                                i64, i64, f32, ptr]
        lib.packed_conv_lrelu_pn_fwd.restype = ctypes.c_int
        lib.packed_conv_lrelu_pn_dz.restype = ctypes.c_int
    return lib


def _check_device(x):
    if x.device.type != 'cuda':
        raise RuntimeError(f'packed_conv_lrelu_pn has no kernel for device '
                           f'{x.device}')


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f'{what} kernel launch failed with CUDA error {rc}')


def _conv_fwd(x, w_packed, neg_slope, eps):
    global conv_launches
    if x.device.type == 'cpu':
        return packed_conv_lrelu_pn_plain(x, w_packed, neg_slope, eps)
    _check_device(x)
    _check_conv_args(x, w_packed)
    b, k, h, w = x.shape
    n = w_packed.shape[0]
    # (K, 3, 3, N): a group's C weights of one tap lie side by side
    wt = w_packed.permute(1, 2, 3, 0).contiguous()
    y = torch.empty((b, n, h, w), dtype=x.dtype, device=x.device)
    r = torch.empty((b, 4, h, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().packed_conv_lrelu_pn_fwd(
            x.data_ptr(), wt.data_ptr(), y.data_ptr(), r.data_ptr(), b, k, n,
            h, w, neg_slope, eps, stream)
    _raise_on(rc, 'packed_conv_lrelu_pn forward')
    conv_launches += 1
    return y, r


def _dz(y, r, g, ct_r, neg_slope):
    global dz_launches
    if y.device.type == 'cpu':
        return packed_dz_plain(y, r, g, ct_r, neg_slope)
    _check_device(y)
    _check_dz_args(y, r, g, ct_r)
    b, n, h, w = y.shape
    dz = torch.empty_like(y)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = _lib().packed_conv_lrelu_pn_dz(
            y.data_ptr(), r.data_ptr(), g.data_ptr(), ct_r.data_ptr(),
            dz.data_ptr(), b, n, h * w, neg_slope, stream)
    _raise_on(rc, 'packed_conv_lrelu_pn dz')
    dz_launches += 1
    return dz


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class Dz(torch.autograd.Function):
    """dz = dz kernel (y, r, ct_y, ct_r); differentiable once more through
    the plain mirror (the GP's second order)."""

    @staticmethod
    def forward(ctx, y, r, g, ct_r, neg_slope):
        ctx.save_for_backward(y, r, g, ct_r)
        ctx.neg_slope = neg_slope
        return _dz(y, r, g, ct_r, neg_slope)

    @staticmethod
    def backward(ctx, ct):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                'packed_conv_lrelu_pn: third-order gradients are not defined')
        saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            dz = packed_dz_plain(*saved, ctx.neg_slope)
            grads = torch.autograd.grad(dz, saved, ct)
        return (*grads, None)


class PackedConvLReluPN(torch.autograd.Function):
    """(y, r) = forward kernel (x, w_packed); backward = Dz, then the
    conv's adjoints for dx and dw."""

    @staticmethod
    def forward(ctx, x, w_packed, neg_slope, eps):
        y, r = _conv_fwd(x, w_packed, neg_slope, eps)
        ctx.save_for_backward(x, w_packed, y, r)
        ctx.neg_slope = neg_slope
        ctx.set_materialize_grads(True)
        return y, r

    @staticmethod
    def backward(ctx, ct_y, ct_r):
        x, w_packed, y, r = ctx.saved_tensors
        dz = Dz.apply(y, r, ct_y.contiguous(), ct_r.contiguous(),
                      ctx.neg_slope)
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dz, x, w_packed, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None


def packed_conv3x3_lrelu_pn(x, w_packed, neg_slope=0.2, eps=1e-8):
    """Fused packed conv3x3 + LeakyReLU + 4-group PixelNorm (module doc);
    returns y.  First- and second-order differentiable."""
    y, _ = PackedConvLReluPN.apply(x, w_packed, neg_slope, eps)
    return y
