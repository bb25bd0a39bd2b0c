"""ops/critic_act.py: the Karras critic's LeakyReLU, alone and before its
level-end 2x2 average pool, and the Functions whose adjoints close the
WGAN-GP's second order.

On the CPU (the plain versions): gradcheck and gradgradcheck in float64;
the forward, first and second order against the composed
``leaky_relu`` + ``avg_pool`` in each dtype; the mask rule at +0, -0 and
negatives whose product with the slope underflows; the penalty's D
gradient of a Karras critic at the benchmark's ``TINY`` cut against the
composition; which calls one Karras batch step makes at each D site; and
the kernels' names against the benchmark's trace categories.  On the card
(marked ``chip``, skipped without one), at the 1024^2 critic's shapes in
bfloat16 and float32: the kernels against the composed path bit for bit
(up to the sign of zeros), a Karras step's CUDA graph against the eager
step, the launch counter at every D site, and no ``avg_pool2d`` kernel in
a profiled step.  Run those there with ``python -m pytest --noconftest -m
chip tests/test_torch_critic_act.py`` (this file imports no JAX; the
tests' conftest does).
"""

import collections
import json
import math
import re
from pathlib import Path

import pytest
import torch

from benchmark import trace
from benchmark.architectures import karras_pggan
from neuron_gan_tpu_torch import train_step
from neuron_gan_tpu_torch.losses import d_grad_pen_loss
from neuron_gan_tpu_torch.models import PGConfig, build_nets
from neuron_gan_tpu_torch.ops import avg_pool, leaky_relu
from neuron_gan_tpu_torch.ops import critic_act as ca

ROOT = Path(__file__).resolve().parents[1]


def composed(pooled):
    """The parent's ops at a site: LeakyReLU, then (pooled) the pool."""
    if pooled:
        return lambda z: avg_pool(leaky_relu(z), 2)
    return leaky_relu


def new_op(pooled):
    return ca.critic_act_pool if pooled else ca.critic_act


def three_orders(f, z, g, gg):
    """(y, dz, the gradient w.r.t. g of <dz, gg>) of ``f`` at ``z``: the
    forward, the first order and the penalty's second order."""
    z = z.detach().requires_grad_()
    g = g.detach().requires_grad_()
    y = f(z)
    dz, = torch.autograd.grad(y, z, g, create_graph=True)
    dg, = torch.autograd.grad(dz, g, gg)
    return y.detach(), dz.detach(), dg


# ---------------------------------------------------------------------------
# the Functions on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('pooled', [False, True])
def test_gradients_to_second_order(pooled):
    gen = torch.Generator().manual_seed(int(pooled))
    z = torch.randn((2, 3, 4, 6), generator=gen, dtype=torch.float64)
    assert torch.autograd.gradcheck(new_op(pooled), (z.requires_grad_(),))
    assert torch.autograd.gradgradcheck(new_op(pooled), (z,))


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize('pooled', [False, True])
def test_three_orders_equal_the_composition(pooled, dtype):
    gen = torch.Generator().manual_seed(3)
    z = torch.randn((2, 3, 8, 6), generator=gen).to(dtype)
    z.view(-1)[::5] = 0.0
    g = torch.randn(composed(pooled)(z).shape, generator=gen).to(dtype)
    gg = torch.randn(z.shape, generator=gen).to(dtype)
    got = three_orders(new_op(pooled), z, g, gg)
    want = three_orders(composed(pooled), z, g, gg)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize('pooled', [False, True])
def test_mask_rule_at_zeros_and_underflow(pooled):
    """d is 1 exactly where z >= 0: at +0 and -0 too; a negative whose
    product with the slope underflows to -0 keeps the slope."""
    tiny = torch.finfo(torch.float32).smallest_normal * 2.0 ** -23
    vals = torch.tensor([0.0, -0.0, -tiny, -2 * tiny, 1.5, -1.5, 2.0, -0.0])
    z = vals.reshape(1, 2, 2, 2) if pooled else vals
    assert float(torch.tensor(-tiny) * 0.2) == 0.0
    dz, = torch.autograd.grad(new_op(pooled)(z.requires_grad_()).sum(), z)
    keep = vals >= 0
    assert keep.tolist() == [True, True, False, False, True, False, True,
                             True]
    want = torch.where(keep, 1.0, 0.2) * (0.25 if pooled else 1.0)
    assert torch.equal(dz.flatten(), want)
    if not pooled:
        y = ca.critic_act(vals)
        assert torch.equal(y, torch.where(keep, vals, vals * 0.2))
        assert (torch.signbit(y) == torch.signbit(vals)).all()


def test_cpu_counts_no_launch_and_other_devices_raise():
    ca.launches_by_case.clear()
    ca.critic_act_pool(torch.randn(1, 2, 4, 4)).sum()
    assert not ca.launches_by_case
    for fn in (ca._act, ca._act_pool):
        with pytest.raises(RuntimeError, match='no kernel for device meta'):
            fn(torch.empty((1, 2, 4, 4), device='meta'), None, 0.2)
    with pytest.raises(ValueError, match='H and W even'):
        ca.critic_act_pool(torch.randn(1, 2, 4, 5))


@pytest.mark.parametrize('dtype, w, taken', [
    (torch.bfloat16, 8, True), (torch.bfloat16, 1024, True),
    (torch.bfloat16, 4, False), (torch.bfloat16, 10, False),
    (torch.float32, 4, True), (torch.float32, 8, True),
    (torch.float32, 6, False), (torch.float32, 2, False)])
def test_pooled_kernels_take_whole_vectors_a_row(dtype, w, taken):
    """The pooled kernels' rows are whole 16-byte vectors: 8 bfloat16 or
    4 float32 columns, which every pooled width of the Karras critic at
    1024^2 is (8^2 the narrowest); another width is refused before a
    launch."""
    t = torch.empty(0, dtype=dtype)
    if taken:
        ca._check_width(w, t)
    else:
        with pytest.raises(ValueError, match='W a multiple of'):
            ca._check_width(w, t)


# ---------------------------------------------------------------------------
# in the Karras critic
# ---------------------------------------------------------------------------

TINY = {k: tuple(v) if isinstance(v, list) else v
        for k, v in karras_pggan.TINY['model'].items()}


def penalty_grads(d, colors, seed=1):
    """D's gradient of the WGAN-GP on float64 interpolates."""
    gen = torch.Generator().manual_seed(seed)
    shape = (8, colors, 16, 16)
    real = torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1
    fake = torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1
    eps = torch.rand(8, generator=gen, dtype=torch.float64)
    gp = d_grad_pen_loss(lambda x: d(x, 2), real, fake, eps, 10.0)
    return torch.autograd.grad(gp, list(d.parameters()), allow_unused=True)


def rel_l2(xs, ys):
    num = math.sqrt(sum(float((x - y).norm()) ** 2 for x, y in zip(xs, ys)))
    return num / math.sqrt(sum(float(y.norm()) ** 2 for y in ys))


def test_penalty_gradient_matches_the_composition(monkeypatch):
    """The penalty's D gradient through the new op (``use_kernels``)
    against the composed leaky_relu + avg_pool, in float64, biases drawn so
    that every pre-activation's sign is exercised."""
    monkeypatch.setattr(PGConfig, 'dtype', property(
        lambda self: torch.float64))
    grads, calls = [], collections.Counter()
    for use_kernels in (True, False):
        cfg = PGConfig(**TINY, architecture='karras', use_kernels=use_kernels)
        _, d = build_nets(cfg, torch.Generator().manual_seed(0), 'cpu')
        d.double()
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for name, p in d.named_parameters():
                if name.endswith('bias'):
                    p.copy_(0.3 * torch.randn(p.shape, generator=gen))
        with monkeypatch.context() as m:
            for name in ('_act', '_act_pool', '_unpool'):
                def spy(*a, fn=getattr(ca, name), name=name):
                    calls[use_kernels, name] += 1
                    return fn(*a)
                m.setattr(ca, name, spy)
            grads.append(penalty_grads(d, cfg.n_colors))
    assert calls[True, '_act'] and calls[True, '_act_pool']
    assert calls[True, '_unpool']
    assert not any(k[0] is False for k in calls)
    got, want = grads
    assert [a is None for a in got] == [b is None for b in want]
    live = [(a, b) for a, b in zip(got, want) if b is not None]
    gap = rel_l2(*zip(*live))
    assert gap <= 1e-12, gap


def karras_sites(cfg, phase, batch):
    """{(dtype name, shape, pooled, below): sites} of D's activations at a
    steady ``phase``: from_rgb, each level's conv1 and its pooled conv2
    (``below`` the head's minibatch stddev), the head's conv and dense0
    (float32 under 'mixed')."""
    f, n = cfg.n_dis_features, cfg.n_layers_max
    first = n - 1 - phase
    r = cfg.image_size_init * 2 ** phase
    body = str(cfg.dtype).removeprefix('torch.')
    head = 'float32' if cfg.mixed else body
    sites = collections.Counter([(body, (batch, f[first], r, r), False,
                                  True)])
    for i in range(first, n - 1):
        sites[body, (batch, f[i], r, r), False, True] += 1
        sites[body, (batch, f[i + 1], r, r), True, True] += 1
        r //= 2
    sites[head, (batch, f[-1], r, r), False, False] += 1
    sites[head, (batch, f[-1]), False, False] += 1
    return sites


def expected_launches(sites):
    """A batch step's calls at each site (n_critic 1, the penalty on the
    critic loss's fakes).  D runs forward on the reals, the fakes, the
    interpolates and G's fakes (4 'fwd'), and first order back through
    each; below the head's minibatch stddev once more through the
    interpolates, since the penalty's second order carries the stddev's
    second derivative back into their forward; and the penalty's second
    order once.  Unpooled: 'masked' 4 + 1 + 1 below the stddev, 4 + 1 in
    the head; pooled: 5 'adjoint', 1 'masked'."""
    out = collections.Counter()
    for (dt, shape, pooled, below), n in sites.items():
        first = 4 + below
        out['fwd', dt, shape, pooled] += 4 * n
        out['masked', dt, shape, pooled] += (1 if pooled else first + 1) * n
        if pooled:
            out['adjoint', dt, shape, pooled] += first * n
    return out


def test_karras_step_routes_every_d_activation(monkeypatch):
    """One Karras batch step on the CPU: every D site's calls, as the card's
    launch counter would count them, and no call from G."""
    cfg = PGConfig(**TINY, architecture='karras', compute_dtype='float32',
                   precision='highest', use_kernels=True)
    g, d = build_nets(cfg, torch.Generator().manual_seed(0), 'cpu')
    calls = collections.Counter()

    def spy(kind_of, fn, pooled):
        def call(v, mask, neg_slope):
            out = fn(v, mask, neg_slope)
            shape = (tuple(v.shape) if kind_of != 'adjoint' else
                     (*v.shape[:2], 2 * v.shape[2], 2 * v.shape[3]))
            kind = kind_of or ('fwd' if mask is None else 'masked')
            calls[kind, str(v.dtype).removeprefix('torch.'), shape,
                  pooled] += 1
            return out
        return call

    monkeypatch.setattr(ca, '_act', spy(None, ca._act, False))
    monkeypatch.setattr(ca, '_act_pool', spy(None, ca._act_pool, True))
    monkeypatch.setattr(ca, '_unpool', spy('adjoint', ca._unpool, True))
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
    train_step.make_batch_step(cfg, spec)(state, raw, draws, None, 1e-3, 0.0)
    assert calls == expected_launches(karras_sites(cfg, 2, 4))


# ---------------------------------------------------------------------------
# the kernels' names in a trace
# ---------------------------------------------------------------------------

def kernel_names():
    src = (ROOT / 'neuron_gan_tpu_torch' / 'csrc' /
           'critic_lrelu_pool.cu').read_text()
    return sorted(set(re.findall(r'^(critic_\w+_kernel)\(', src, re.M)))


def test_kernel_names_stay_out_of_the_metrics_categories():
    """A trace's name of each kernel (demangled, template arguments and
    all) falls in 'other' or 'elementwise': not in K1-K4, the wide K1/K2,
    'conv', 'layout', 'fill' or 'reduction', so conv_ms_per_step and the
    epilogue rooflines measure what they measured."""
    names = kernel_names()
    assert names == ['critic_act_kernel', 'critic_act_pool_kernel',
                     'critic_act_unpool_kernel']
    for name in names:
        for t in ('float', '__nv_bfloat16'):
            full = (f'void (anonymous namespace)::{name}<{t}, 8, false>('
                    f'{t} const*, unsigned int const*, {t}*, unsigned int*, '
                    f'int, int, int, bool, float)')
            for n in (name, full):
                cat = trace.category(n, karras_pggan.KERNELS)
                assert cat in ('other', 'elementwise'), (n, cat)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    """Skips the test without a CUDA card (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


def cell_config():
    return json.loads((ROOT / 'benchmark' / 'configs' /
                       'pggan_celebahq1024.json').read_text())


def mask_bits(mask, shape, pooled, dtype):
    """The mask's bits as a bool tensor of ``shape``, by the layout of
    csrc/critic_lrelu_pool.cu."""
    v = 16 // torch.tensor([], dtype=dtype).element_size()
    dev = mask.device
    words = mask.to(torch.int64) & 0xffffffff
    if not pooled:
        e = torch.arange(math.prod(shape), device=dev)
        u, i = e // v, e % v
        k_of = 32 // v
        bit = ((u % (32 * k_of)) // 32) * v + i
    else:
        planes, h, w = math.prod(shape[:2]), shape[2], shape[3]
        k_of = 32 // (2 * v)
        p, r, c = torch.meshgrid(*(torch.arange(s, device=dev)
                                   for s in (planes, h, w)), indexing='ij')
        u = ((p * (h // 2) + r // 2) * (w // v) + c // v).flatten()
        bit = ((((u % (32 * k_of)) // 32) * 2 + (r % 2).flatten()) * v
               + (c % v).flatten())
    t = (u // (32 * k_of)) * 32 + u % 32
    return ((words[t] >> bit) & 1).bool().reshape(shape)


@pytest.mark.chip
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_card_kernels_equal_the_composition(cuda, dtype):
    """Every site of the 1024^2 critic: forward, first order and the
    penalty's second order equal the composed ops' on the card (torch.equal:
    up to the sign of zeros), each through its kernel; the mask's bits are
    z >= 0, also at +0, -0 and underflowing negatives."""
    cfg = karras_pggan.port_config(cell_config())
    gen = torch.Generator(cuda).manual_seed(11)
    # the least subnormal of the type: times the slope, it rounds to -0
    tiny = 2.0 ** (-149 if dtype == torch.float32 else -133)
    shapes = sorted({(s, p) for (_, s, p, _) in karras_sites(cfg, 8, 4)})
    for shape, pooled in shapes:
        z = torch.randn(shape, generator=gen, device=cuda).to(dtype)
        flat = z.view(-1)
        flat[::7] = 0.0
        flat[3::11] = -0.0
        flat[5::13] = -tiny
        g_shape = composed(pooled)(z).shape
        g = torch.randn(g_shape, generator=gen, device=cuda).to(dtype)
        gg = torch.randn(shape, generator=gen, device=cuda).to(dtype)
        ca.launches_by_case.clear()
        got = three_orders(new_op(pooled), z, g, gg)
        key = (str(dtype).removeprefix('torch.'), shape, pooled)
        # forward; first order ('adjoint' pooled, else 'masked'); second
        want_calls = collections.Counter([('fwd', *key), ('masked', *key),
                                          ('adjoint' if pooled else 'masked',
                                           *key)])
        assert ca.launches_by_case == want_calls, ca.launches_by_case
        want = three_orders(composed(pooled), z, g, gg)
        for what, a, b in zip(('y', 'dz', 'second'), got, want):
            assert torch.equal(a, b), (shape, dtype, what)
        _, mask = (ca._act_pool if pooled else ca._act)(z, None, 0.2)
        assert torch.equal(mask_bits(mask, shape, pooled, dtype), z >= 0)
    torch.cuda.synchronize()


def karras_card_setup(cuda, n_images=4):
    """The cell's configuration, nets from a seed, a chunk spec of
    ``n_images`` (one batch an epoch) and a uniform stack."""
    cell = cell_config()
    traffic = json.loads((ROOT / 'benchmark' / 'workloads' /
                          'pggan_celebahq1024.steady1024.json')
                         .read_text())['traffic']
    traffic = {**traffic, 'n_images': n_images}
    pg = karras_pggan.port_config(cell)
    g, d = build_nets(pg, torch.Generator().manual_seed(0), cuda)
    spec, state, _ = karras_pggan.port_train(cell, traffic, g, d)
    stack = torch.rand((n_images, 1024, 1024, 3), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(6))
    return pg, spec, state, stack


def karras_chunk(pg, spec, state, stack, capture, n_epochs, first=1):
    gen = torch.Generator(stack.device).manual_seed(7 + first)
    return train_step.make_epoch_runner(pg, spec, n_epochs, capture=capture)(
        state, stack, gen, first)


def all_tensors(state):
    out = {}
    for net in ('g', 'd', 'g_ema'):
        for name, p in getattr(state, net).named_parameters():
            out[f'{net}.{name}'] = p.detach()
            if p.grad is not None:
                out[f'{net}.{name}.grad'] = p.grad
    return out


@pytest.mark.chip
def test_card_karras_graph_replays_the_eager_step(cuda, monkeypatch):
    """The 1024^2 cell's step replayed from its CUDA graph against the same
    step run eagerly on the graphs' own path (static inputs, a side stream;
    WARMUP_STEPS never reached), bit for bit, cuDNN deterministic: two
    equal states take the same 3 eager steps, then one is captured and
    replayed for 3 steps while the other runs them eagerly.  The launch
    counter counts the eager steps and the capture, not the replays.

    A scratch state takes the process's first Karras step, uncompared: in
    a process that ran the composed LeakyReLU and pool at these shapes
    first (as this file's kernels test does), the next Karras chunk reads
    differently from every later one, with or without the critic's
    kernels (PERF.md, section 7); alone in its process it does not."""
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    pg, spec, scratch, stack = karras_card_setup(cuda)
    with monkeypatch.context() as m:
        m.setattr(train_step, 'WARMUP_STEPS', 10 ** 9)
        karras_chunk(pg, spec, scratch, stack, True, 1, 20)
    del scratch
    _, _, eager, _ = karras_card_setup(cuda)
    _, _, graphed, _ = karras_card_setup(cuda)

    def both(first):
        with monkeypatch.context() as m:
            m.setattr(train_step, 'WARMUP_STEPS', 10 ** 9)
            want = karras_chunk(pg, spec, eager, stack, True, 3, first)
        got = karras_chunk(pg, spec, graphed, stack, True, 3, first)
        a, b = all_tensors(eager), all_tensors(graphed)
        assert a.keys() == b.keys()
        return [k for k in a if not torch.equal(a[k], b[k])], got, want

    before = collections.Counter(train_step.step_graphs)
    ca.launches_by_case.clear()
    differ, got, want = both(1)
    assert torch.equal(got, want) and not differ, ('eager steps', differ)
    differ, got, want = both(4)
    # 9 eager steps (6 of the eager state, 3 of the graphed) and a capture
    assert train_step.step_graphs - before == {
        'eager:warmup': 9, 'captured': 1, 'replayed': 3}
    per_step = expected_launches(karras_sites(pg, 8, 4))
    assert ca.launches_by_case == {k: 10 * n for k, n in per_step.items()}
    assert torch.equal(got, want) and not differ, ('replayed steps', differ)


@pytest.mark.chip
def test_card_karras_step_launches_and_trace(cuda):
    """One eager 1024^2 step: every D site through the kernels, by the
    launch counter; in its device trace the three kernels and no
    avg_pool2d kernel."""
    pg, spec, state, stack = karras_card_setup(cuda)
    karras_chunk(pg, spec, state, stack, False, 1)   # builds, warms up
    torch.cuda.synchronize()
    ca.launches_by_case.clear()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        karras_chunk(pg, spec, state, stack, False, 1)
        torch.cuda.synchronize()
    assert ca.launches_by_case == expected_launches(karras_sites(pg, 8, 4))
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert not [n for n in names if 'avg_pool' in n.lower()], names
    for kernel in kernel_names():
        assert any(kernel in n for n in names), (kernel, names)
