"""ops/conv.py: the port's conv2d and its second order through cuDNN's
forward, data- and weight-gradient convs.

On the CPU, in float64 at tiny shapes: gradcheck and gradgradcheck of
``conv2d`` over the strides, paddings and kernels the nets use; the
critic's WGAN-GP gradient through the new rule against PyTorch's own
(``F.conv2d`` autograd) for the neuron critic, unpacked and packed with
the kernel Functions, and Karras et al.'s; and on one Karras critic step,
which convs take the second order and what each first-order call
computes.  On the card (marked ``chip``, skipped without one), at the
Karras cell's 1024^2 critic shapes: the two rules equal in float64, each
in bfloat16 and float32 held to float64, and no whole-image conv in a
profiled penalty of the new rule.  Run those there with
``python -m pytest --noconftest -m chip tests/test_torch_conv_grad.py``
(this file imports no JAX; the tests' conftest does).
"""

import collections
import math

import pytest
import torch
import torch.nn.functional as F

from neuron_gan_tpu_torch import train_step
from neuron_gan_tpu_torch.losses import d_grad_pen_loss
from neuron_gan_tpu_torch.models import PGConfig, build_nets
from neuron_gan_tpu_torch.ops import conv, packed
from neuron_gan_tpu_torch.ops import packed_conv_lrelu_pn as pcl
from neuron_gan_tpu_torch.runtime.device import precision_scope


def rel_l2(xs, ys):
    """Relative L2 gap of the tensors ``xs`` to ``ys``, as one vector."""
    num = math.sqrt(sum(float((x.double() - y.double()).norm()) ** 2
                        for x, y in zip(xs, ys)))
    return num / math.sqrt(sum(float(y.double().norm()) ** 2 for y in ys))


class AutogradAdjoints:
    """``ConvAdjoints.apply``'s call with PyTorch's own rule: the bare
    differentiable ``aten.convolution_backward``."""

    @staticmethod
    def apply(g_out, x, weight, stride, padding, mask):
        return torch.ops.aten.convolution_backward(
            g_out, x, weight, None, stride, padding, [1, 1], False, [0, 0],
            1, mask)


def autograd_conv2d(x, weight, bias=None, *, stride=1, padding=0):
    return F.conv2d(x, weight, bias, stride=stride, padding=padding)


def autograd_rule(monkeypatch):
    """Every site of ops/conv.py back on PyTorch's own second order."""
    monkeypatch.setattr(conv, 'conv2d', autograd_conv2d)
    monkeypatch.setattr(packed, 'conv2d', autograd_conv2d)
    monkeypatch.setattr(pcl, 'ConvAdjoints', AutogradAdjoints)


# ---------------------------------------------------------------------------
# the Functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('bias', [False, True])
@pytest.mark.parametrize('stride', [1, 2, (2, 1)])
@pytest.mark.parametrize('padding', [0, 1])
@pytest.mark.parametrize('k', [1, 3, 4])
def test_conv2d_gradients_to_second_order(k, padding, stride, bias):
    gen = torch.Generator().manual_seed(k * 10 + padding)
    x = torch.randn((2, 2, 4, 5), generator=gen, dtype=torch.float64)
    w = torch.randn((2, 2, k, k), generator=gen, dtype=torch.float64)
    b = torch.randn(2, generator=gen, dtype=torch.float64)
    inputs = [t.requires_grad_() for t in (x, w, b)[:3 if bias else 2]]

    def f(*ts):
        return conv.conv2d(*ts, stride=stride, padding=padding)

    with torch.no_grad():
        want = F.conv2d(*inputs, stride=stride, padding=padding)
    assert torch.equal(f(*inputs), want)
    assert torch.autograd.gradcheck(f, inputs, fast_mode=True)
    assert torch.autograd.gradgradcheck(f, inputs, fast_mode=True)


def test_plain_call_without_gradients():
    x, w = torch.randn(1, 2, 5, 5), torch.randn(3, 2, 3, 3)
    conv.adjoints_by_case.clear()
    y = conv.conv2d(x, w, padding=1)
    assert y.grad_fn is None
    with torch.no_grad():
        y = conv.conv2d(x.requires_grad_(), w, padding=1)
    assert y.grad_fn is None
    y = conv.conv2d(x, w, padding=1)
    assert type(y.grad_fn).__name__ == 'Conv2dBackward'


# ---------------------------------------------------------------------------
# the critic's penalty through the new rule and PyTorch's
# ---------------------------------------------------------------------------

# the benchmark's TINY cuts: 3 levels 4^2 to 16^2 at 16^2, batch 8
TINY = {'n_gen_features': (16, 8, 8), 'n_dis_features': (8, 8, 16),
        'latent_dim': 8, 'image_size_init': 4}
CRITICS = {
    'neuron': dict(n_colors=1),
    'neuron_packed_kernels': dict(n_colors=1, packed_min_res=8,
                                  use_kernels=True),
    'karras': dict(n_colors=3, architecture='karras'),
}


def penalty_grads(d, colors, seed=1):
    """D's gradient of the WGAN-GP on float64 interpolates."""
    gen = torch.Generator().manual_seed(seed)
    shape = (8, colors, 16, 16)
    real = torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1
    fake = torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1
    eps = torch.rand(8, generator=gen, dtype=torch.float64)
    gp = d_grad_pen_loss(lambda x: d(x, 2), real, fake, eps, 10.0)
    return torch.autograd.grad(gp, list(d.parameters()), allow_unused=True)


@pytest.mark.parametrize('critic', sorted(CRITICS))
def test_penalty_gradient_matches_autograds_rule(critic, monkeypatch):
    cfg = PGConfig(**TINY, **CRITICS[critic])
    # the nets in float64 end to end: D casts its input to cfg.dtype
    monkeypatch.setattr(PGConfig, 'dtype', property(
        lambda self: torch.float64))
    _, d = build_nets(cfg, torch.Generator().manual_seed(0), 'cpu')
    d.double()
    conv.second_order_by_case.clear()
    pcl.launches_by_case.clear()
    got = penalty_grads(d, cfg.n_colors)
    assert sum(conv.second_order_by_case.values()) > 0
    with monkeypatch.context() as m:
        autograd_rule(m)
        conv.second_order_by_case.clear()
        want = penalty_grads(d, cfg.n_colors)
        assert not conv.second_order_by_case
    assert [a is None for a in got] == [b is None for b in want]
    live = [(a, b) for a, b in zip(got, want) if b is not None]
    assert live
    gap = rel_l2(*zip(*live))
    assert gap <= 1e-10, gap


# ---------------------------------------------------------------------------
# what one Karras critic step runs
# ---------------------------------------------------------------------------

def test_karras_step_second_order_and_masks(monkeypatch):
    """On one batch step of the Karras critic (n_critic 1): the penalty's
    inner gradient asks no conv for its weight gradient; D's update takes
    the second order once per conv the phase runs, with no x term (its
    weight cotangent is absent); G's update takes none, and asks D's convs
    for dx alone and G's for their weight gradients."""
    cfg = PGConfig(**TINY, n_colors=3, architecture='karras',
                   compute_dtype='float32', precision='highest')
    g, d = build_nets(cfg, torch.Generator().manual_seed(0), 'cpu')
    ran = {'g': collections.Counter(), 'd': collections.Counter()}
    for net, module in (('g', g), ('d', d)):
        for m in module.modules():
            if hasattr(m, 'weight') and m.weight.dim() == 4:
                m.register_forward_hook(
                    lambda m, _i, _o, net=net: ran[net].update(
                        [tuple(m.weight.shape)])
                    if torch.is_grad_enabled() else None)

    snaps = []

    def snap(tag):
        snaps.append((tag, collections.Counter(conv.adjoints_by_case),
                      collections.Counter(conv.second_order_by_case),
                      {k: collections.Counter(v) for k, v in ran.items()}))

    grads_into = train_step._grads_into

    def spy(loss, params):
        snap('before')
        grads_into(loss, params)
        snap('after')

    monkeypatch.setattr(train_step, '_grads_into', spy)
    spec = train_step.ChunkSpec(
        phase=2, fading=False, n_critic=1, batch_size=4, n_images=4,
        shuffle=False, crop_size=16, translation=0.0, augment=True,
        gp_lambda=10.0, drift_epsilon=0.001, sim_lambda0=0.0, sim_decay=0.0,
        beta1=0.0, rmsprop=False, lr0=1e-3, lr_gamma=1.0, lr_boundary=0,
        lr_cap=1000, alpha_start=0, alpha_step=0.0, latent_dim=8,
        gp_reuse_fakes=True, beta2=0.99, mirror_augment=True)
    state = train_step.init_train_state(g, d, beta1=0.0)
    raw = torch.rand((4, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    draws = train_step.draw_batch(torch.Generator().manual_seed(2), cfg,
                                  spec, 4, 16)
    conv.adjoints_by_case.clear()
    conv.second_order_by_case.clear()
    train_step.make_batch_step(cfg, spec)(state, raw, draws, None, 1e-3, 0.0)
    snap('end')
    assert [s[0] for s in snaps] == ['before', 'after', 'before', 'after',
                                     'end']

    def shapes(counter, keep=lambda key: True):
        out = collections.Counter()
        for key, n in counter.items():
            if keep(key):
                out[key[0]] += n
        return out

    def weight_term(key):
        return key[3][1]

    # each D conv the phase runs: the critic loss's two passes and the
    # penalty's one, all with gradients; G's forward there is no_grad
    d_convs = collections.Counter({s: n // 3 for s, n in
                                   snaps[0][3]['d'].items()})
    assert d_convs and all(n % 3 == 0 for n in snaps[0][3]['d'].values())
    assert not snaps[0][3]['g']
    # the penalty's inner gradient: dx alone, once a conv
    inner = snaps[0][1]
    assert shapes(inner) == d_convs
    assert not any(weight_term(k) for k in inner)
    # D's update: the second order once a conv, no x term
    second = snaps[1][2] - snaps[0][2]
    assert shapes(second) == d_convs
    assert {k[3] for k in second} == {('gO', 'W')}
    # G's update: no second order; D's convs for dx alone
    assert snaps[4][2] == snaps[1][2]
    g_pass = snaps[3][1] - snaps[2][1]
    g_convs = snaps[4][3]['g']
    d_again = snaps[4][3]['d'] - snaps[1][3]['d']
    assert g_convs and d_again == d_convs
    assert shapes(g_pass, weight_term) == g_convs
    assert shapes(g_pass, lambda k: not weight_term(k)) == d_convs


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    """Skips the test without a CUDA card (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


# the Karras cell's critic before its first pool: from_rgb 3 -> 16 (1x1),
# then 16 -> 16 and 16 -> 32 (3x3), at 1024^2, batch 4
KARRAS_D_1024 = ((3, 16, 1), (16, 16, 3), (16, 32, 3))


def card_penalty_grads(conv2d, x, params, dtype):
    """The penalty's gradient w.r.t. the three convs' weights and biases,
    activations in ``dtype`` (each conv's weight cast to it)."""
    x_hat = x.to(dtype).requires_grad_()
    h = x_hat
    for w, b in params:
        h = F.leaky_relu(conv2d(h, w.to(dtype), b.to(dtype),
                                padding=w.shape[-1] // 2), 0.2)
    grad, = torch.autograd.grad(h.float().mean(dim=(1, 2, 3)).sum(), x_hat,
                                create_graph=True)
    norms = grad.float().flatten(1).norm(dim=1)
    gp = 10.0 * ((norms - 1.0) ** 2).mean()
    return torch.autograd.grad(gp, [t for wb in params for t in wb])


@pytest.mark.chip
@pytest.mark.parametrize('dtype,precision,tol', [
    # the chip smoke's GP bounds: BF16_TOL['gp_rel_l2'], PACKED_TOL['rel_l2']
    (torch.bfloat16, None, 2e-2),
    (torch.float32, 'highest', 1e-3),
])
def test_card_penalty_matches_autograds_rule(cuda, dtype, precision, tol):
    """The two rules agree in float64 to rounding; in the working dtype
    each is held to PyTorch's rule in float64.  PyTorch's own rule is not
    the yardstick there: its float32 whole-image forward conv reads
    8e-4 to 1.7e-3 from float64 on an H100, the weight-gradient kernel
    1.4e-6 (PERF.md)."""
    gen = torch.Generator(cuda).manual_seed(3)
    x = torch.rand((4, 3, 1024, 1024), generator=gen, device=cuda) * 2 - 1
    params = []
    for ci, co, k in KARRAS_D_1024:
        w = torch.randn((co, ci, k, k), generator=gen, device=cuda)
        params.append(((w / math.sqrt(ci * k * k)).requires_grad_(),
                       (0.1 * torch.randn(co, generator=gen, device=cuda))
                       .requires_grad_()))
    p64 = [tuple(t.detach().double().requires_grad_() for t in wb)
           for wb in params]
    with precision_scope('highest'):
        want = card_penalty_grads(autograd_conv2d, x.double(), p64,
                                  torch.float64)
        got64 = card_penalty_grads(conv.conv2d, x.double(), p64,
                                   torch.float64)
    with precision_scope(precision):
        got = card_penalty_grads(conv.conv2d, x, params, dtype)
        theirs = card_penalty_grads(autograd_conv2d, x, params, dtype)
        ops = {name: profiled_ops(lambda: card_penalty_grads(
                   fn, x, params, dtype))
               for name, fn in (('new', conv.conv2d),
                                ('autograd', autograd_conv2d))}
    # held as one vector: the biases' gradients are exactly 0 on both
    # rules (LeakyReLU's derivative has none)
    assert rel_l2(got64, want) <= 1e-10, rel_l2(got64, want)
    gap, their_gap = rel_l2(got, want), rel_l2(theirs, want)
    print(f'{dtype} {precision}: new rule {gap:.3g}, '
          f'PyTorch\'s rule {their_gap:.3g} from float64')
    assert gap <= tol, gap
    assert gap <= 2 * their_gap, (gap, their_gap)
    # a conv whose weight spans its input: the swapped-axis form, which
    # PyTorch's rule runs and the new one does not
    for name, whole in (('new', False), ('autograd', True)):
        convs = ops[name]['aten::convolution']
        assert len(convs) >= 2 * len(KARRAS_D_1024)
        assert any(len(w) == 4 and w[2:] == i[2:]
                   for i, w in convs) == whole, (name, convs)
    assert ops['new']['aten::convolution_backward']


def profiled_ops(fn):
    """{op name: [input shapes of each call]} of ``fn`` under the
    profiler, on the host."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    out = collections.defaultdict(list)
    for e in prof.events():
        out[e.name].append(e.input_shapes[:2])
    return out
