"""Fused packed conv3x3 + LeakyReLU + 4-group PixelNorm: the CUDA kernel
pair and its plain PyTorch version.

Replaces neuron_gan_tpu/ops/pallas_conv.py: ``_fwd_kernel`` (the forward,
K3) and ``_dz_kernel`` (the one-pass dz of its backward, K4); the CUDA
source is csrc/packed_conv_lrelu_pn.cu.  The input is a packed activation
(B, K, H, W) and ``w_packed`` a packed (N, K, 3, 3) kernel with the
equalized-LR scale folded in (ops/packed.py::pack_conv3x3_weight); the N
output channels are 4 parity groups of C = N / 4.  The forward returns

    y (B, N, H, W)   lrelu(conv(x)) normalized per group, in x's dtype
    r (B, 4, H, W)   each group's rsqrt scale, float32 (the JAX package
                     keeps it as (B, H*W, 4): the same numbers, transposed)

so the backward never needs the pre-activation: u = y / r.

The forward kernel multiplies only the entries of ``w_packed`` that
``pack_conv3x3_weight`` can make nonzero (a quarter of them), gathered by
``compact_weight`` into wc (4, 3, 3, K/4, N/4); it assumes the rest are
zero, as on every call site.  It runs the products on tensor cores: in
float32 at float32 accuracy (3xTF32, emulated by ``packed_conv3x3_taps``),
in bfloat16 as bf16 x bf16 products (``w_packed`` rounded to bfloat16, as
the JAX package casts it) with float32 accumulation and epilogue.

Gradients mirror the JAX package's two custom VJPs:

* ``PackedConvLReluPN`` (``_fused_pair``): forward = K3, saving
  (x, w_packed, y, r); backward takes (ct_y, ct_r), runs ``Dz`` (K4) and
  then the conv's own adjoints for dx and dw, kept differentiable
  (ops/conv.py's ``ConvAdjoints``: the ``aten.convolution_backward`` that
  autograd of ``F.conv2d`` calls, without re-running the forward conv, for
  the inputs the running backward uses; its second order is cuDNN's
  forward and weight-gradient convs), in x's dtype with ``w_packed`` cast
  to it, dw cast back to ``w_packed``'s.
* ``Dz`` (``_dz_call``): forward = K4; its own backward autodiffs the plain
  mirror ``packed_dz_plain`` (``_dz_pure``), so the WGAN-GP's gradient of
  a gradient composes.  Third order is not defined.

``ct_r`` is absent in a first-order pass (r feeds nothing) but live under
the GP: the backward consumes the saved r, so the outer differentiation
sends a cotangent into it, and the Function's backward runs again with
that cotangent.  An absent cotangent arrives as None
(``set_materialize_grads(False)``): a None ``ct_r`` goes to ``Dz`` as None
and to the dz kernel as a null pointer (it adds 0), so no zero tensor is
filled for it; a None cotangent of y becomes zeros.

x, y, dz and the cotangent of y are float32 or bfloat16; r, its
cotangent and ``w_packed`` float32; N one of ``KERNEL_WIDTHS``.  A CPU
tensor takes the plain versions; a CUDA tensor launches the kernels or
raises if they cannot take it -- never a silent fall back.
``launches_by_case`` counts kernel launches, and nothing else, by
(kernel, dtype name, y's shape, case): ('k3', ..., None) and ('k4', ...,
'live' or 'absent' ct_r); one forward launch is the weight split and the
conv kernel after it.  ``launches_by_kernel`` sums it by kernel and dtype
name.
"""

import collections
import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from neuron_gan_tpu_torch.ops.conv import ConvAdjoints, engine_will_use
from neuron_gan_tpu_torch.ops.lrelu_pixel_norm import dtype_name
from neuron_gan_tpu_torch.runtime import kernels

launches_by_case = collections.Counter()

# output widths N both kernels are instantiated for (C = N / 4)
KERNEL_WIDTHS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _groups(t):
    b, n = t.shape[:2]
    return t.reshape(b, 4, n // 4, *t.shape[2:])


def lrelu_pn_groups(z, neg_slope=0.2, eps=1e-8, dtype=None):
    """The forward's epilogue on a pre-activation z (B, N, H, W): (y, r),
    y in ``dtype`` (z's by default)."""
    z = z.to(torch.promote_types(z.dtype, torch.float32))
    u = _groups(torch.where(z >= 0, z, z * neg_slope))
    r = torch.rsqrt(torch.mean(u * u, dim=2) + eps)          # (B, 4, H, W)
    y = (u * r.unsqueeze(2)).reshape(z.shape)
    return y.to(dtype or y.dtype), r


def packed_conv_lrelu_pn_plain(x, w_packed, neg_slope=0.2, eps=1e-8):
    """Plain version of the forward kernel: (y, r).  Differentiable.  A
    bfloat16 conv rounds z to bfloat16 before the float32 epilogue."""
    z = F.conv2d(x, w_packed.to(x.dtype), padding=1)
    return lrelu_pn_groups(z, neg_slope, eps, x.dtype)


def packed_dz_plain(y, r, g, ct_r, neg_slope=0.2):
    """Plain version of the dz kernel (mirror of ``_dz_pure``): dz from the
    block output y, the scales r, the cotangent g of y and the cotangent
    ct_r of r (None: zero).  Differentiable (it supplies the dz kernel's
    gradient)."""
    c = y.shape[1] // 4
    yf, gf = _groups(y.float()), _groups(g.float())
    s = r.unsqueeze(2)
    u = yf / s
    t = torch.sum(gf * u, dim=2, keepdim=True)
    if ct_r is not None:
        t = t + ct_r.unsqueeze(2)
    du = gf * s - u * (s ** 3) * (t / c)
    dz = torch.where(u >= 0, du, du * neg_slope)
    return dz.reshape(y.shape).to(y.dtype)


def dz_slice(c):
    """Channels S of one group that a dz kernel thread takes at group
    width ``c``, in either dtype: S = min(c, 8)
    (csrc/packed_conv_lrelu_pn.cu, ``DzShape``)."""
    return min(c, 8)


def packed_dz_sliced(y, r, g, ct_r, neg_slope=0.2):
    """The dz kernel's arithmetic on the CPU, in its order: u = y * (1 /
    s); t summed over each thread's slice of ``dz_slice`` channels in
    channel order, then over the slices by a butterfly (pairs, then pairs
    of pairs: the lanes' ``__shfl_xor_sync``), then ct_r (None: zero)
    added; dz = lrelu'(u) * (g * s - u * k), k = s^3 * t / C.  Runs on
    nothing on the card's main path: the CPU tests hold the kernel's
    order against the JAX package with it."""
    b, n, h, w = y.shape
    c = n // 4
    sl = dz_slice(c)
    s = r.unsqueeze(2)
    u = _groups(y.float()) * (1.0 / s)
    gf = _groups(g.float())
    gu = (gf * u).reshape(b, 4, c // sl, sl, h, w)
    t = gu[:, :, :, 0]
    for i in range(1, sl):
        t = t + gu[:, :, :, i]
    while t.shape[2] > 1:
        t = t[:, :, 0::2] + t[:, :, 1::2]
    if ct_r is not None:
        t = t + ct_r.unsqueeze(2)
    k = s * s * s * (t / c)
    du = gf * s - u * k
    dz = torch.where(u >= 0, du, du * neg_slope)
    return dz.reshape(y.shape).to(y.dtype)


# ---------------------------------------------------------------------------
# the forward kernel's compact weights and its tap formulation
# ---------------------------------------------------------------------------

def _tap_source(a, t):
    """Output parity a, original tap t -> (packed offset P, input parity
    a'): divmod(a + t - 1, 2), as ops/packed.py::_pack_transfer_tensor."""
    return divmod(a + t - 1, 2)


@functools.lru_cache(maxsize=None)
def _compact_index(k, n, device):
    """Flat indices into a contiguous (N, K, 3, 3) packed kernel of the
    compact weights wc[g, ty, tx, k0, c], g = a * 2 + b: the one packed tap
    and input parity that carry original tap (ty, tx) from input channel k0
    to output channel c of group g.  Cached per device: a host-to-device
    copy in every step would make the host wait for the device."""
    k0, c = k // 4, n // 4
    idx = np.empty((4, 3, 3, k0, c), np.int64)
    for a in (0, 1):
        for b in (0, 1):
            for ty in range(3):
                p, ap = _tap_source(a, ty)
                for tx in range(3):
                    q, bp = _tap_source(b, tx)
                    o = (a * 2 + b) * c + np.arange(c)
                    i = (ap * 2 + bp) * k0 + np.arange(k0)
                    idx[a * 2 + b, ty, tx] = ((o[None, :] * k + i[:, None]) * 3
                                              + p + 1) * 3 + q + 1
    return torch.from_numpy(idx).to(device)


def compact_weight(w_packed):
    """(N, K, 3, 3) packed kernel -> wc (4, 3, 3, K/4, N/4), the weights
    the forward kernel multiplies.  Precondition: ``w_packed`` is zero off
    those entries, as every ``pack_conv3x3_weight`` output is (a CPU test
    proves it for the path's shapes); it is not checked at run time, which
    would stall the host in every step."""
    n, k = w_packed.shape[:2]
    return w_packed.reshape(-1)[_compact_index(k, n, w_packed.device)]


def tf32_round(t):
    """Float32 to TF32 as ``cvt.rna.tf32.f32`` rounds a finite value, and
    as the forward kernel does it: to 10 explicit mantissa bits, ties away
    from zero (the low 13 bits cleared)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1fff).view(torch.float32)


def split_tf32(t):
    """(hi, lo) = (tf32(t), tf32(t - hi)): the forward kernel's 3xTF32
    operands."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def _tap_product(xs, wt, products):
    def mm(a, w):
        return torch.einsum('bkhw,kc->bchw', a, w)
    if products == 'exact':
        return mm(xs, wt)
    (xh, xl), (wh, wl) = split_tf32(xs), split_tf32(wt)
    if products == '1xtf32':
        return mm(xh, wh)
    if products == '3xtf32':
        return mm(xl, wh) + mm(xh, wl) + mm(xh, wh)
    raise ValueError(f'unknown products {products!r}')


def packed_conv3x3_taps(x, wc, products='exact'):
    """z = conv3x3(x, w_packed) from the compact weights ``wc`` (see
    ``compact_weight``), tap by tap as the forward kernel indexes them:
    for each output group g = (a, b) and original tap (ty, tx), one
    shifted slice of input parity (a', b') times wc[g, ty, tx].

    ``products``: 'exact' multiplies in x's dtype; '3xtf32' emulates the
    kernel's tensor-core products (lo*hi + hi*lo + hi*hi of TF32 splits,
    float32 sums); '1xtf32' one TF32 product.  Runs on nothing on the
    card's main path: the CPU tests hold the kernel's index map and
    numerics with it."""
    b, k, h, w = x.shape
    k0 = k // 4
    xp = F.pad(x, (1, 1, 1, 1))
    zs = []
    for a in (0, 1):
        for bb in (0, 1):
            z = 0
            for ty in range(3):
                p, ap = _tap_source(a, ty)
                for tx in range(3):
                    q, bp = _tap_source(bb, tx)
                    c0 = (ap * 2 + bp) * k0
                    xs = xp[:, c0:c0 + k0, 1 + p:1 + p + h, 1 + q:1 + q + w]
                    z = z + _tap_product(xs, wc[a * 2 + bb, ty, tx], products)
            zs.append(z)
    return torch.cat(zs, dim=1)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check_conv_args(x, w_packed):
    if x.dtype not in _DTYPE_CODES or w_packed.dtype != torch.float32:
        raise TypeError(f'packed_conv_lrelu_pn kernel takes x in float32 or '
                        f'bfloat16 and w_packed in float32, got {x.dtype} '
                        f'and {w_packed.dtype}')
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
    if k % 4:
        raise ValueError(f'packed_conv_lrelu_pn kernel needs 4 parity groups '
                         f'of input channels, got K = {k}')
    if x.device != w_packed.device:
        raise ValueError('x and w_packed must share a device')
    if not x.is_contiguous():
        raise ValueError('packed_conv_lrelu_pn kernel needs a contiguous '
                         'NCHW x')
    if x.dtype == torch.bfloat16 and x.shape[3] % 2:
        raise ValueError(f'the bfloat16 packed_conv_lrelu_pn kernel stages '
                         f'pixel pairs and needs an even width, got '
                         f'{x.shape[3]}')


def _check_dz_args(y, r, g, ct_r):
    """ct_r may be None (a zero cotangent of r)."""
    given = [t for t in (y, r, g, ct_r) if t is not None]
    if y.dtype not in _DTYPE_CODES or g.dtype != y.dtype or \
            r.dtype != torch.float32 or \
            (ct_r is not None and ct_r.dtype != torch.float32):
        raise TypeError(f'packed dz kernel takes y and g in float32 or '
                        f'bfloat16 (one dtype), r and ct_r in float32, got '
                        f'{[t.dtype for t in given]}')
    for t in given:
        if t.device != y.device or not t.is_contiguous():
            raise ValueError('packed dz kernel inputs must be contiguous and '
                             'share a device')
    if y.dim() != 4 or y.shape[1] % 4:
        raise ValueError(f'packed dz needs y (B, 4C, H, W), got '
                         f'{tuple(y.shape)}')
    b, n, h, w = y.shape
    if g.shape != y.shape or r.shape != (b, 4, h, w) or \
            (ct_r is not None and ct_r.shape != r.shape):
        raise ValueError('packed dz: g must match y, and r, ct_r be '
                         '(B, 4, H, W)')
    if n not in KERNEL_WIDTHS:
        raise ValueError(f'packed dz kernel takes N in {KERNEL_WIDTHS} '
                         f'channels, got {n}')


def _lib():
    lib = kernels.load('packed_conv_lrelu_pn')
    if lib.packed_conv_lrelu_pn_fwd.argtypes is None:
        ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        i32 = ctypes.c_int
        lib.packed_conv_lrelu_pn_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i64,
                                                 i64, i64, i64, i64, f32, f32,
                                                 i32, ptr]
        lib.packed_conv_lrelu_pn_dz.argtypes = [ptr, ptr, ptr, ptr, ptr, i64,
                                                i64, i64, f32, i32, ptr]
        lib.packed_conv_lrelu_pn_fwd_smem.argtypes = [i64, i32]
        lib.packed_conv_lrelu_pn_dz_regs.argtypes = [i64, i32]
        lib.packed_conv_lrelu_pn_fwd_scratch.argtypes = [i64, i64, i32]
        lib.packed_conv_lrelu_pn_fwd_scratch.restype = i64
        lib.packed_conv_lrelu_pn_fwd.restype = ctypes.c_int
        lib.packed_conv_lrelu_pn_dz.restype = ctypes.c_int
        lib.packed_conv_lrelu_pn_fwd_smem.restype = ctypes.c_int
        lib.packed_conv_lrelu_pn_dz_regs.restype = ctypes.c_int
    return lib


def _check_device(x):
    if x.device.type != 'cuda':
        raise RuntimeError(f'packed_conv_lrelu_pn has no kernel for device '
                           f'{x.device}')


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f'{what} kernel launch failed with CUDA error {rc}')


def conv_fwd_launcher(x, w_packed, neg_slope=0.2, eps=1e-8):
    """(launch, y, r) for CUDA tensors: the forward's outputs, allocated,
    and a function that launches its kernels (the weight split, then the
    conv) on these inputs into them.  The wrapper's work less the launch
    count; chip_smoke.py times the kernels with it."""
    _check_device(x)
    _check_conv_args(x, w_packed)
    b, k, h, w = x.shape
    n = w_packed.shape[0]
    lib = _lib()
    code = _DTYPE_CODES[x.dtype]
    wc = compact_weight(w_packed.contiguous())
    # the kernel's weights in fragment order (float32: split into TF32
    # (hi, lo); bfloat16: rounded)
    scratch = torch.empty(lib.packed_conv_lrelu_pn_fwd_scratch(k, n, code),
                          dtype=torch.float32, device=x.device)
    y = torch.empty((b, n, h, w), dtype=x.dtype, device=x.device)
    r = torch.empty((b, 4, h, w), dtype=torch.float32, device=x.device)

    def launch():
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.packed_conv_lrelu_pn_fwd(
                x.data_ptr(), wc.data_ptr(), scratch.data_ptr(), y.data_ptr(),
                r.data_ptr(), b, k, n, h, w, neg_slope, eps, code, stream)
        _raise_on(rc, 'packed_conv_lrelu_pn forward')
    return launch, y, r


def launches_by_kernel():
    """{'k3': {dtype name: launches}, 'k4': ...}: the sums of
    ``launches_by_case`` over shapes and cases."""
    out = {'k3': collections.Counter(), 'k4': collections.Counter()}
    for (kernel, dtype, _, _), n in launches_by_case.items():
        out[kernel][dtype] += n
    return out


def _conv_fwd(x, w_packed, neg_slope, eps):
    if x.device.type == 'cpu':
        return packed_conv_lrelu_pn_plain(x, w_packed, neg_slope, eps)
    launch, y, r = conv_fwd_launcher(x, w_packed, neg_slope, eps)
    launch()
    launches_by_case['k3', dtype_name(x), tuple(y.shape), None] += 1
    return y, r


def conv_fwd_smem(n, dtype=torch.float32):
    """Dynamic shared memory, in bytes, of the forward kernel for N output
    channels and x of ``dtype``."""
    return _lib().packed_conv_lrelu_pn_fwd_smem(n, _DTYPE_CODES[dtype])


def dz_regs(n, dtype=torch.float32):
    """Registers a thread of the dz kernel uses for N channels and y of
    ``dtype``."""
    return _lib().packed_conv_lrelu_pn_dz_regs(n, _DTYPE_CODES[dtype])


def _dz(y, r, g, ct_r, neg_slope):
    """dz by the kernel (ct_r None: zero, passed as a null pointer)."""
    if y.device.type == 'cpu':
        return packed_dz_plain(y, r, g, ct_r, neg_slope)
    _check_device(y)
    _check_dz_args(y, r, g, ct_r)
    b, n, h, w = y.shape
    dz = torch.empty_like(y)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = _lib().packed_conv_lrelu_pn_dz(
            y.data_ptr(), r.data_ptr(), g.data_ptr(),
            None if ct_r is None else ct_r.data_ptr(), dz.data_ptr(), b, n,
            h * w, neg_slope, _DTYPE_CODES[y.dtype], stream)
    _raise_on(rc, 'packed_conv_lrelu_pn dz')
    launches_by_case['k4', dtype_name(y), tuple(y.shape),
                     'absent' if ct_r is None else 'live'] += 1
    return dz


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class Dz(torch.autograd.Function):
    """dz = dz kernel (y, r, ct_y, ct_r); differentiable once more through
    the plain mirror (the GP's second order).  ct_r may be None (zero): it
    then gets no gradient."""

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
        saved = [None if t is None else t.detach().requires_grad_()
                 for t in ctx.saved_tensors]
        given = [t for t in saved if t is not None]
        with torch.enable_grad():
            dz = packed_dz_plain(*saved, ctx.neg_slope)
            grads = iter(torch.autograd.grad(dz, given, ct))
        return (*(None if t is None else next(grads) for t in saved), None)


class PackedConvLReluPN(torch.autograd.Function):
    """(y, r) = forward kernel (x, w_packed); backward = Dz, then the
    conv's adjoints for dx and dw."""

    @staticmethod
    def forward(ctx, x, w_packed, neg_slope, eps):
        y, r = _conv_fwd(x, w_packed, neg_slope, eps)
        ctx.save_for_backward(x, w_packed, y, r)
        ctx.neg_slope = neg_slope
        ctx.set_materialize_grads(False)
        return y, r

    @staticmethod
    def backward(ctx, ct_y, ct_r):
        x, w_packed, y, r = ctx.saved_tensors
        ct_y = torch.zeros_like(y) if ct_y is None else ct_y.contiguous()
        dz = Dz.apply(y, r, ct_y, None if ct_r is None else ct_r.contiguous(),
                      ctx.neg_slope)
        dx, dw, _ = ConvAdjoints.apply(dz, x, w_packed.to(x.dtype), [1, 1],
                                       [1, 1], engine_will_use(ctx)[:2]
                                       + [False])
        return dx, None if dw is None else dw.to(w_packed.dtype), None, None


def packed_conv3x3_lrelu_pn(x, w_packed, neg_slope=0.2, eps=1e-8):
    """Fused packed conv3x3 + LeakyReLU + 4-group PixelNorm (module doc);
    returns y.  First- and second-order differentiable."""
    y, _ = PackedConvLReluPN.apply(x, w_packed, neg_slope, eps)
    return y
