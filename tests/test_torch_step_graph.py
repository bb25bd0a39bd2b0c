"""The epoch runner's CUDA graphs of the batch step (train_step.StepGraphs).

On the CPU: which runs take the graph (``eager_reason``), the static-input
step's eager form against the plain batch step (bit for bit), and the
shear warp's cached pi/2 against a fresh constant.  On the card (marked
``chip``, skipped without one): replayed runners against eager ones, what
``step_graphs`` counts, and when a state's graphs are captured again.
Run those there with ``python -m pytest --noconftest -m chip
tests/test_torch_step_graph.py`` (this file imports no JAX; the tests'
conftest does).
"""

import collections
import dataclasses
import math

import pytest
import torch

from neuron_gan_tpu_torch import train_step as tts
from neuron_gan_tpu_torch.data import augment
from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG, PGConfig

# test_torch_train_step.py's packed architecture: levels 16^2, 32^2, 64^2,
# the 2x2 layout from 32^2
ARCH = dict(n_gen_features=(16, 8, 8), n_dis_features=(8, 8, 16),
            latent_dim=8, image_size_init=16, packed_min_res=32)
SPEC = dict(phase=1, fading=False, n_critic=1, batch_size=2, n_images=4,
            shuffle=True, crop_size=64, translation=0.05, augment=True,
            gp_lambda=10.0, drift_epsilon=0.001, sim_lambda0=0.0,
            sim_decay=0.0, beta1=0.5, rmsprop=False, lr0=1e-3,
            lr_gamma=0.99, lr_boundary=0, lr_cap=50, alpha_start=0,
            alpha_step=0.25, latent_dim=8)
FRAME = 96
# the shipping step's knobs, and the float32 step's (with the similarity
# loss and the EMA, whose weights the graph reads from the device)
VARIANTS = {
    'shipping': (dict(compute_dtype='mixed', precision=None),
                 dict(fast_augment=True, shear_warp=True,
                      gp_reuse_fakes=True)),
    'float32': ({}, dict(sim_lambda0=0.5, sim_decay=0.1, ema_beta=0.9)),
}


def make_state(cfg, spec, device='cpu'):
    init = torch.Generator().manual_seed(0)
    return tts.init_train_state(GeneratorPG(cfg, init, device=device),
                                DiscriminatorPG(cfg, init, device=device),
                                spec.beta1, spec.rmsprop, spec.ema_beta)


def state_tensors(state):
    """Every tensor a step leaves behind, by name."""
    out = {}
    for net in ('g', 'd', 'g_ema'):
        module = getattr(state, net)
        for name, p in (module.named_parameters() if module else ()):
            out[f'{net}.{name}'] = p.detach()
            if p.grad is not None:
                out[f'{net}.{name}.grad'] = p.grad
    for net in ('g', 'd'):
        opt = getattr(state, f'{net}_opt')
        for name, p in getattr(state, net).named_parameters():
            for k, v in opt.state.get(p, {}).items():
                out[f'{net}_opt.{name}.{k}'] = v
    return out


# ---------------------------------------------------------------------------
# where the graph engages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('device,grid,shards,fading,reason', [
    ('cuda', None, None, False, None),
    ('cuda', None, None, True, 'fading'),
    ('cuda', 'grid', None, False, 'grid'),
    ('cuda', None, 'shards', False, 'shards'),
    ('cuda', 'grid', 'shards', True, 'grid'),
    ('cpu', None, None, False, 'cpu'),
    ('cpu', 'grid', None, True, 'cpu'),
])
def test_eager_reason(device, grid, shards, fading, reason):
    assert tts.eager_reason(torch.device(device), grid, shards,
                            fading) == reason


def test_cpu_runner_counts_its_eager_steps():
    cfg = PGConfig(**ARCH, use_kernels=True)
    spec = tts.ChunkSpec(**dict(SPEC, phase=0, crop_size=16))
    stack = torch.rand(4, 24, 24, 1, generator=torch.Generator().manual_seed(1))
    state = make_state(cfg, spec)
    before = collections.Counter(tts.step_graphs)
    tts.make_epoch_runner(cfg, spec, 1)(state, stack,
                                        torch.Generator().manual_seed(2), 1)
    tts.make_epoch_runner(cfg, spec, 1, capture=False)(
        state, stack, torch.Generator().manual_seed(2), 2)
    assert tts.step_graphs - before == {'eager:cpu': 2}
    assert not state.graphs.steps


# ---------------------------------------------------------------------------
# the static-input step, eagerly: the plain batch step bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_static_input_step_is_the_batch_step(variant):
    over_cfg, over_spec = VARIANTS[variant]
    cfg = PGConfig(**ARCH, use_kernels=True, **over_cfg)
    spec = tts.ChunkSpec(**dict(SPEC, **over_spec))
    stack = torch.rand(4, FRAME, FRAME, 1,
                       generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    batches = []
    for epoch in (1, 2, 3):
        _, lr, lam = tts.epoch_scalars(spec, epoch)
        rows = torch.randperm(4, generator=gen)[:2]
        batches.append((stack[rows], tts.draw_batch(gen, cfg, spec, 2, FRAME),
                        lr * epoch, lam))
    step = tts.make_batch_step(cfg, spec)

    plain = make_state(cfg, spec)
    want = [step(plain, raw, draws, 1.0, lr, lam)
            for raw, draws, lr, lam in batches]

    static = make_state(cfg, spec)
    graphs = static.graphs
    before = collections.Counter(tts.step_graphs)
    got = []
    for raw, draws, lr, lam in batches:
        key = tts.graph_key(cfg, spec, raw)
        got.append(graphs.run(key, step, static, raw, draws, lr,
                              lam if spec.sim_lambda0 > 0 else None))
    assert tts.step_graphs - before == {'eager:warmup': 3}
    g, = graphs.steps.values()
    # the step read its own buffers, z2 still z1 where the spec reuses fakes
    z1, z2, _ = g.draws['critic'][0]
    assert (z2 is z1) == spec.gp_reuse_fakes
    assert all(t is not s for t, s in zip(g.inputs, tts._tensors(
        [batches[-1][0], batches[-1][1]])))
    for w, o in zip(want, got):
        assert torch.equal(w, o)
    a, b = state_tensors(plain), state_tensors(static)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for opt in ('g_opt', 'd_opt'):
        assert [gr['lr'] for gr in getattr(static, opt).param_groups] == \
            [batches[-1][2]]


def test_set_lr_writes_a_tensor_lr_in_place():
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([p], lr=torch.zeros(()), capturable=False)
    held = opt.param_groups[0]['lr']
    tts._set_lr(opt, 2.5e-4)
    assert opt.param_groups[0]['lr'] is held
    assert float(held) == pytest.approx(2.5e-4)
    cpu = tts.make_optimizer([p])
    tts._set_lr(cpu, 1e-3)
    assert cpu.param_groups[0]['lr'] == 1e-3
    assert not cpu.defaults.get('capturable')


def test_capturable_turns_on_and_off():
    p = torch.nn.Parameter(torch.ones(3))
    opt = tts.make_optimizer([p])
    group = opt.param_groups[0]
    assert not group['capturable']
    tts._set_lr(opt, 1e-3)
    p.grad = torch.ones(3)
    opt.step()
    tts._capturable(opt, True)
    held = group['lr']
    assert group['capturable'] and isinstance(held, torch.Tensor)
    assert float(held) == float(torch.tensor(1e-3))
    tts._capturable(opt, True)
    assert group['lr'] is held
    tts._set_lr(opt, 2e-3)
    tts._capturable(opt, False)
    assert not group['capturable'] and group['lr'] == float(torch.tensor(2e-3))
    step = opt.state[p]['step']
    assert step.device.type == 'cpu' and float(step) == 1.0


# ---------------------------------------------------------------------------
# the shear warp's cached constant
# ---------------------------------------------------------------------------

def test_cached_half_pi_gives_the_same_shear_indices(monkeypatch):
    gen = torch.Generator().manual_seed(5)
    # angles at and next to the quarter turns' rounding boundaries (45
    # degrees off a multiple of 90) and uniform ones
    edges = torch.tensor([-135.0, -45.0, 45.0, 135.0, 180.0, -180.0])
    angle = torch.cat([edges, torch.nextafter(edges, edges + 1),
                       torch.nextafter(edges, edges - 1),
                       torch.rand(64, generator=gen) * 360 - 180])
    n = angle.shape[0]
    tx = torch.round(torch.rand(n, generator=gen) * 6 - 3)
    ty = torch.round(torch.rand(n, generator=gen) * 6 - 3)
    flip = torch.rand(n, generator=gen) < 0.5
    cached = augment.shear_source(40, (4, 32), angle, tx, ty, flip)
    assert augment._half_pi(angle.device) is augment._half_pi(angle.device)
    assert float(augment._half_pi(angle.device)) == \
        float(torch.tensor(math.pi / 2.0))
    monkeypatch.setattr(augment, '_half_pi', lambda dev: torch.tensor(
        math.pi / 2.0, device=dev))
    fresh = augment.shear_source(40, (4, 32), angle, tx, ty, flip)
    for c, f in zip(cached, fresh):
        assert torch.equal(c, f)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    """Skips the test without a CUDA card (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


class OneRankGrid:
    """A grid of one rank: its rows are the batch, its reductions nothing."""

    def rows(self, b):
        return 0, b

    def reduce_grads(self, params, share):
        pass

    def all_reduce_(self, t):
        return t


def card_setup(cuda, phase=2, n_images=16):
    """The shipping configuration at a small level (64^2, the 2x2 layout),
    a 20-step chunk, cuDNN deterministic so two runs can agree bit for
    bit."""
    from neuron_gan_tpu_torch.flagship import (
        flagship_shipping_chunk_spec, flagship_shipping_config)
    cfg = flagship_shipping_config()
    spec = flagship_shipping_chunk_spec(phase, n_images=n_images)
    stack = torch.rand(n_images, 768, 768, 1, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(6))
    return cfg, spec, stack


def chunk(cfg, spec, stack, state, first, capture=True, n_epochs=10):
    gen = torch.Generator(stack.device).manual_seed(7 + first)
    return tts.make_epoch_runner(cfg, spec, n_epochs, capture=capture)(
        state, stack, gen, first)


@pytest.mark.chip
def test_replayed_chunk_is_the_eager_chunk(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    cfg, spec, stack = card_setup(cuda)
    eager, graphed = make_state(cfg, spec, cuda), make_state(cfg, spec, cuda)
    # the graph's optimizers, run eagerly: only the replay differs
    for opt in (eager.d_opt, eager.g_opt):
        tts._capturable(opt, True)
    want = chunk(cfg, spec, stack, eager, 1, capture=False)
    before = collections.Counter(tts.step_graphs)
    got = chunk(cfg, spec, stack, graphed, 1)
    assert tts.step_graphs - before == {'eager:warmup': 3, 'captured': 1,
                                        'replayed': 17}
    assert all(opt.param_groups[0]['capturable']
               for opt in (graphed.d_opt, graphed.g_opt))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    a, b = state_tensors(eager), state_tensors(graphed)
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=1e-5, atol=1e-7,
                                   msg=k)

    # a second run and a second runner of the phase replay the same graph
    before = collections.Counter(tts.step_graphs)
    chunk(cfg, spec, stack, graphed, 11, n_epochs=2)
    chunk(cfg, spec, stack, graphed, 13, n_epochs=2)
    assert tts.step_graphs - before == {'replayed': 8}
    assert len(graphed.graphs.steps) == 1

    # a restored optimizer state (new tensors) is captured anew
    graphed.d_opt.load_state_dict(graphed.d_opt.state_dict())
    before = collections.Counter(tts.step_graphs)
    chunk(cfg, spec, stack, graphed, 15, n_epochs=3)
    assert tts.step_graphs - before == {'eager:warmup': 3, 'captured': 1,
                                        'replayed': 3}

    # another phase drops this phase's graph
    spec2 = dataclasses.replace(spec, phase=3)
    chunk(cfg, spec2, stack, graphed, 18, n_epochs=3)
    assert [k[0] for k in graphed.graphs.steps] == [3]


@pytest.mark.chip
def test_fading_and_grid_chunks_stay_eager(cuda):
    # 4 images: one batch (of 4 rows) an epoch
    cfg, spec, stack = card_setup(cuda, n_images=4)
    state = make_state(cfg, spec, cuda)
    before = collections.Counter(tts.step_graphs)
    fading = dataclasses.replace(spec, phase=3, fading=True, alpha_start=1)
    chunk(cfg, fading, stack[:4], state, 1, n_epochs=1)
    grid = tts.make_epoch_runner(cfg, spec, 1, grid=OneRankGrid())
    grid(state, stack[:4], torch.Generator(cuda).manual_seed(8), 2)
    assert tts.step_graphs - before == {'eager:fading': 1, 'eager:grid': 1}
    assert not state.graphs.steps
    # a steady chunk makes the optimizers capturable, an eager one undoes it
    chunk(cfg, spec, stack[:4], state, 3, n_epochs=1)
    assert state.d_opt.param_groups[0]['capturable']
    chunk(cfg, fading, stack[:4], state, 4, n_epochs=1)
    assert not any(opt.param_groups[0]['capturable']
                   for opt in (state.d_opt, state.g_opt))
    assert all(st['step'].device.type == 'cpu'
               for st in state.d_opt.state.values())
