"""2-D convolution (NCHW, OIHW, groups 1, dilation 1) with its own second
order: a pair of autograd Functions over cuDNN's three conv kernels.

``conv2d`` is ``F.conv2d``'s function and forward call.  Its first-order
backward is the one ``aten.convolution_backward`` that autograd's own node
makes.  What changes is the second order, which the WGAN-GP's gradient of a
gradient runs through every conv of the critic.  PyTorch's
``_convolution_double_backward`` forms the weight's second-order term as a
FORWARD conv with batch and channels swapped, whose "filter" is the whole
image: (C_in, B, H, W) against (C_out, B, H', W') to a k x k output.  That
conv has only C_out * C_in * k^2 outputs, each a reduction over B*H*W
products, a shape cuDNN's forward kernels run slowly.  It is the contraction
of a conv's weight gradient, so here it is one: given the cotangents
(ggI, ggW, ggb) of the first-order outputs (dx, dW, db) and the saved
(gO, x, W),

* gO gets conv(ggI, W) + conv(x, ggW) + ggb: forward convs with the
  layer's stride and padding;
* W gets convolution_backward(gO, ggI, W) for dW alone: the wgrad kernel
  with ggI as its input;
* x gets convolution_backward(gO, x, ggW) for dx alone, where ggW is live.

An absent cotangent stays None (``set_materialize_grads(False)``): no zero
tensor is filled or convolved.  Third order is not defined.

Each Function asks for the gradients that the running backward will use,
as autograd's own node does: ``torch._C._will_engine_execute_node`` on the
node of each input (``register_multi_grad_hook``'s test), and
``needs_input_grad`` where the engine refuses the question (a leaf under
``autograd.grad``).  So the penalty's inner gradient, taken w.r.t. the
interpolates alone, and the generator's update, taken w.r.t. G's
parameters, launch no weight gradient of the critic's convs.

Counted on the host (a replayed CUDA graph counts nothing), as the
kernels' wrappers count launches, by case = (weight shape, dtype name,
stride): ``adjoints_by_case[case + (mask,)]`` for each first-order call,
mask the (dx, dW, db) it computes, and ``second_order_by_case[case +
(terms,)]`` for each second-order call, terms the inputs among ('gO',
'x', 'W') that it computes a gradient for.
"""

import collections

import torch
import torch.nn.functional as F

from neuron_gan_tpu_torch.ops.lrelu_pixel_norm import dtype_name

adjoints_by_case = collections.Counter()
second_order_by_case = collections.Counter()

_convolution = torch.ops.aten.convolution.default
_convolution_backward = torch.ops.aten.convolution_backward.default


def _pair(v):
    return [v, v] if isinstance(v, int) else list(v)


def _case(weight, stride):
    return tuple(weight.shape), dtype_name(weight), tuple(stride)


def _fwd(x, weight, bias, stride, padding):
    """The forward conv, as ``F.conv2d`` calls it."""
    return _convolution(x, weight, bias, stride, padding, [1, 1], False,
                        [0, 0], 1)


def engine_will_use(ctx):
    """Whether the running backward will use the gradient of each tensor
    input of ``ctx``'s Function, in order (those inputs come first)."""
    live = []
    for (node, _), needed in zip(ctx.next_functions, ctx.needs_input_grad):
        if not needed or node is None:
            live.append(False)
            continue
        try:
            live.append(bool(torch._C._will_engine_execute_node(node)))
        except RuntimeError:   # a leaf under autograd.grad
            live.append(True)
    return live


class ConvAdjoints(torch.autograd.Function):
    """(dx, dW, db) = one ``aten.convolution_backward`` of the conv
    (x, W, stride, padding), each None where ``mask`` leaves it out;
    once more differentiable by the rule in the module doc."""

    @staticmethod
    def forward(ctx, g_out, x, weight, stride, padding, mask):
        ctx.save_for_backward(g_out, x, weight)
        ctx.stride, ctx.padding = stride, padding
        ctx.set_materialize_grads(False)
        adjoints_by_case[_case(weight, stride) + (tuple(mask),)] += 1
        bias_sizes = [weight.shape[0]] if mask[2] else None
        return _convolution_backward(g_out, x, weight, bias_sizes, stride,
                                     padding, [1, 1], False, [0, 0], 1,
                                     list(mask))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gg_x, gg_w, gg_b):
        g_out, x, weight = ctx.saved_tensors
        stride, padding = ctx.stride, ctx.padding
        want_g, want_x, want_w = engine_will_use(ctx)
        d_g = d_x = d_w = None
        if want_g and (gg_x is not None or gg_w is not None
                       or gg_b is not None):
            if gg_x is not None:
                d_g = _fwd(gg_x, weight, gg_b, stride, padding)
            if gg_w is not None:
                term = _fwd(x, gg_w, None if gg_x is not None else gg_b,
                            stride, padding)
                d_g = term if d_g is None else d_g + term
            if d_g is None:
                d_g = gg_b.reshape(1, -1, 1, 1).expand_as(g_out)
        if want_x and gg_w is not None:
            d_x = _convolution_backward(g_out, x, gg_w, None, stride,
                                        padding, [1, 1], False, [0, 0], 1,
                                        [True, False, False])[0]
        if want_w and gg_x is not None:
            d_w = _convolution_backward(g_out, gg_x, weight, None, stride,
                                        padding, [1, 1], False, [0, 0], 1,
                                        [False, True, False])[1]
        terms = tuple(name for name, d in (('gO', d_g), ('x', d_x),
                                           ('W', d_w)) if d is not None)
        second_order_by_case[_case(weight, stride) + (terms,)] += 1
        return d_g, d_x, d_w, None, None, None


class Conv2d(torch.autograd.Function):
    """y = the forward conv; backward = ConvAdjoints."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.padding = stride, padding
        ctx.set_materialize_grads(False)
        return _fwd(x, weight, bias, stride, padding)

    @staticmethod
    def backward(ctx, g_out):
        if g_out is None:
            return None, None, None, None, None
        x, weight = ctx.saved_tensors
        mask = engine_will_use(ctx)
        mask += [False] * (3 - len(mask))   # no bias: no third input
        d_x, d_w, d_b = ConvAdjoints.apply(g_out, x, weight, ctx.stride,
                                           ctx.padding, mask)
        return d_x, d_w, d_b, None, None


def conv2d(x, weight, bias=None, *, stride=1, padding=0):
    """``F.conv2d(x, weight, bias, stride, padding)`` with the second order
    of the module doc.  Where no input carries a gradient it is the plain
    call (sampling, the generator under ``no_grad``)."""
    if not (torch.is_grad_enabled()
            and any(t is not None and t.requires_grad
                    for t in (x, weight, bias))):
        return F.conv2d(x, weight, bias, stride=stride, padding=padding)
    return Conv2d.apply(x, weight, bias, _pair(stride), _pair(padding))
