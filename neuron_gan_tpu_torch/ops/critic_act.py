"""The Karras critic's LeakyReLU, alone and before its level-end 2x2 average
pool: the CUDA kernel family and its plain PyTorch version.

Replaces no TPU kernel (the JAX package has no Karras critic): it takes
``torch.where(z >= 0, z, z * slope)`` and ``F.avg_pool2d`` with their
autograd nodes out of ``models/karras.py``'s D.  The CUDA source is
csrc/critic_lrelu_pool.cu.  With d(z) = 1 where z >= 0, else the slope (the
``where`` rule, so the derivative at 0 is 1):

* ``critic_act``:      y = d(z) z;     its backward d(z) g, the same map;
* ``critic_act_pool``: y = P(d(z) z);  its backward d(z) P^T(g), whose
  backward is P(d(z) gg) again,

P the 2x2 mean (NCHW, H and W even), P^T the x2 nearest unpool times 1/4.
d carries no gradient, so these maps close every order of the WGAN-GP: the
forward, the first order and the penalty's second order each launch one
kernel.  Three Functions hold them: ``CriticAct`` (its own backward),
``CriticActPool`` and ``CriticActPoolAdjoint`` (each the other's).  Each
saves only the mask of z's signs: on the card one bit an element, in
32-bit words laid out by the CUDA source (``critic_act_mask_words`` there
gives their count), on the CPU a bool tensor.

The numbers are the composed ops', rounding for rounding in float32 and
bfloat16 (the CUDA source lists where); ``act_plain``, ``act_pool_plain``
and ``unpool_act_plain`` are the plain versions.  The same Functions run
on both devices; only the innermost launch differs.  A CPU tensor takes
the plain version; a CUDA tensor launches the kernel, or raises if the
kernel cannot take it -- never a silent fall back.

``launches_by_case`` counts kernel launches, and nothing else, on the host
(a CUDA graph's capture counts, a replay does not), by (kernel, dtype name,
full-resolution shape, pooled): kernel 'fwd' (d from the input's signs,
the mask written), 'masked' (d from a saved mask: a backward of the
unpooled map, every second order) or 'adjoint' (the pooled map's
backward).
"""

import collections
import ctypes

import torch
import torch.nn.functional as F

from neuron_gan_tpu_torch.ops.lrelu_pixel_norm import dtype_name
from neuron_gan_tpu_torch.ops.resize import upsample2_nearest
from neuron_gan_tpu_torch.runtime import kernels

launches_by_case = collections.Counter()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def act_plain(v, mask, neg_slope=0.2):
    """d v: ``v`` where ``mask`` (bool, v's shape), else ``v * neg_slope``."""
    return torch.where(mask, v, v * neg_slope)


def act_pool_plain(v, mask, neg_slope=0.2):
    """P(d v): the 2x2 mean of ``act_plain``."""
    return F.avg_pool2d(act_plain(v, mask, neg_slope), 2)


def unpool_act_plain(g, mask, neg_slope=0.2):
    """d P^T(g): ``g / 4`` repeated 2x2, then d from ``mask`` (of the
    full-resolution shape)."""
    return act_plain(upsample2_nearest(g * 0.25), mask, neg_slope)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _lib():
    lib = kernels.load('critic_lrelu_pool')
    if lib.critic_act.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        f32, i32 = ctypes.c_float, ctypes.c_int
        lib.critic_act.argtypes = [ptr, ptr, ptr, ptr, i64, f32, i32, ptr]
        lib.critic_act_pool.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i64,
                                        f32, i32, ptr]
        lib.critic_act_unpool.argtypes = [ptr, ptr, ptr, i64, i64, i64, f32,
                                          i32, ptr]
        lib.critic_act_mask_words.argtypes = [i64]
        for fn in (lib.critic_act, lib.critic_act_pool,
                   lib.critic_act_unpool):
            fn.restype = ctypes.c_int
        lib.critic_act_mask_words.restype = i64
    return lib


def _check(t, what):
    if t.device.type != 'cuda':
        raise RuntimeError(f'critic_act has no kernel for device {t.device}')
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f'critic_act kernel takes float32 or bfloat16, got '
                        f'{t.dtype}')
    if not t.is_contiguous():
        raise ValueError(f'critic_act kernel needs a contiguous {what}')


def _pooled_shape(shape):
    if len(shape) != 4 or shape[2] % 2 or shape[3] % 2:
        raise ValueError(f'critic_act_pool needs (B, C, H, W) with H and W '
                         f'even, got {tuple(shape)}')
    return shape[0] * shape[1], shape[2], shape[3]


def _check_width(w, t):
    """The pooled kernels take rows of whole 16-byte vectors."""
    if (w * t.element_size()) % 16:
        raise ValueError(f'critic_act_pool kernel needs W a multiple of '
                         f'{16 // t.element_size()} in {t.dtype}, got {w}')


def _mask_ptrs(v, mask, n):
    """(mask, pointer read, pointer written) for ``n`` elements: a new
    mask where ``mask`` is None."""
    words = _lib().critic_act_mask_words(n)
    if mask is None:
        mask = torch.empty(words, dtype=torch.int32, device=v.device)
        return mask, None, mask.data_ptr()
    if (mask.dtype != torch.int32 or mask.numel() != words
            or mask.device != v.device):
        raise ValueError('critic_act: the mask is not one of this shape')
    return mask, mask.data_ptr(), None


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f'{what} kernel launch failed with CUDA error {rc}')


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _act(v, mask, neg_slope):
    """(d v, mask); d from v's signs where ``mask`` is None."""
    if v.device.type == 'cpu':
        if mask is None:
            mask = v >= 0
        return act_plain(v, mask, neg_slope), mask
    _check(v, 'input')
    kind = 'fwd' if mask is None else 'masked'
    mask, m_in, m_out = _mask_ptrs(v, mask, v.numel())
    y = torch.empty_like(v)
    with torch.cuda.device(v.device):
        rc = _lib().critic_act(v.data_ptr(), m_in, y.data_ptr(), m_out,
                               v.numel(), neg_slope, _DTYPE_CODES[v.dtype],
                               _stream(v))
    _raise_on(rc, 'critic_act')
    launches_by_case[kind, dtype_name(v), tuple(v.shape), False] += 1
    return y, mask


def _act_pool(v, mask, neg_slope):
    """(P(d v), mask); d from v's signs where ``mask`` is None."""
    planes, h, w = _pooled_shape(v.shape)
    if v.device.type == 'cpu':
        if mask is None:
            mask = v >= 0
        return act_pool_plain(v, mask, neg_slope), mask
    _check(v, 'input')
    _check_width(w, v)
    kind = 'fwd' if mask is None else 'masked'
    mask, m_in, m_out = _mask_ptrs(v, mask, v.numel())
    y = v.new_empty((*v.shape[:2], h // 2, w // 2))
    with torch.cuda.device(v.device):
        rc = _lib().critic_act_pool(v.data_ptr(), m_in, y.data_ptr(), m_out,
                                    planes, h, w, neg_slope,
                                    _DTYPE_CODES[v.dtype], _stream(v))
    _raise_on(rc, 'critic_act_pool')
    launches_by_case[kind, dtype_name(v), tuple(v.shape), True] += 1
    return y, mask


def _unpool(g, mask, neg_slope):
    """d P^T(g), d from ``mask``."""
    shape = (*g.shape[:2], 2 * g.shape[2], 2 * g.shape[3])
    planes, h, w = _pooled_shape(shape)
    if g.device.type == 'cpu':
        return unpool_act_plain(g, mask, neg_slope)
    _check(g, 'cotangent')
    _check_width(w, g)
    mask, m_in, _ = _mask_ptrs(g, mask, planes * h * w)
    dz = g.new_empty(shape)
    with torch.cuda.device(g.device):
        rc = _lib().critic_act_unpool(g.data_ptr(), m_in, dz.data_ptr(),
                                      planes, h, w, neg_slope,
                                      _DTYPE_CODES[g.dtype], _stream(g))
    _raise_on(rc, 'critic_act_unpool')
    launches_by_case['adjoint', dtype_name(g), shape, True] += 1
    return dz


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class CriticAct(torch.autograd.Function):
    """d v, d from v's signs (``mask`` None) or from ``mask``; its
    backward is itself on the cotangent, with the same mask."""

    @staticmethod
    def forward(ctx, v, mask, neg_slope):
        y, mask = _act(v, mask, neg_slope)
        ctx.save_for_backward(mask)
        ctx.neg_slope = neg_slope
        return y

    @staticmethod
    def backward(ctx, g):
        mask, = ctx.saved_tensors
        return CriticAct.apply(g.contiguous(), mask, ctx.neg_slope), None, None


class CriticActPool(torch.autograd.Function):
    """P(d v), d from v's signs (``mask`` None) or from ``mask``; backward =
    CriticActPoolAdjoint with the same mask."""

    @staticmethod
    def forward(ctx, v, mask, neg_slope):
        y, mask = _act_pool(v, mask, neg_slope)
        ctx.save_for_backward(mask)
        ctx.neg_slope = neg_slope
        return y

    @staticmethod
    def backward(ctx, g):
        mask, = ctx.saved_tensors
        dz = CriticActPoolAdjoint.apply(g.contiguous(), mask, ctx.neg_slope)
        return dz, None, None


class CriticActPoolAdjoint(torch.autograd.Function):
    """d P^T(g), d from ``mask``; backward = CriticActPool with the same
    mask."""

    @staticmethod
    def forward(ctx, g, mask, neg_slope):
        ctx.save_for_backward(mask)
        ctx.neg_slope = neg_slope
        return _unpool(g, mask, neg_slope)

    @staticmethod
    def backward(ctx, gg):
        mask, = ctx.saved_tensors
        dv = CriticActPool.apply(gg.contiguous(), mask, ctx.neg_slope)
        return dv, None, None


def critic_act(z, neg_slope=0.2):
    """LeakyReLU with the ``where(z >= 0, ...)`` rule; differentiable to
    every order."""
    return CriticAct.apply(z.contiguous(), None, neg_slope)


def critic_act_pool(z, neg_slope=0.2):
    """LeakyReLU, then the 2x2 average pool, of NCHW ``z``; differentiable
    to every order."""
    return CriticActPool.apply(z.contiguous(), None, neg_slope)
