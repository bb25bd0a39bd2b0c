"""Karras et al.'s PGGAN on the port's normal path (``PGConfig(architecture=
'karras')``) against the plain reference (tests/karras_pggan_reference.py),
on the CPU at a tiny size in float32: 3 levels (4^2 to 16^2), RGB, batch 8
(two minibatch-stddev groups of 4), weights N(0, 1) and biases drawn too,
so a bias the port dropped shows.

Tolerances: the port and the reference run the same float32 operations on
the CPU, up to the order of a few sums (F.linear against a matmul, the
EMA's update against a lerp), which part them by float32 rounding, about
1e-7 relative (5e-6 in the weights' change over four Adam steps, whose
first steps are sign-like).  Each comparison is a relative L2 gap held
20x or more over the largest reading; the architecture's mistakes
(bilinear for nearest, groups of consecutive samples, PixelNorm in D, the
penalty on fresh fakes, beta2 0.999) read 1.4e-3 or more.
"""

import math

import numpy as np
import pytest
import torch

from neuron_gan_tpu_torch import train_step
from neuron_gan_tpu_torch.checkpoint import load_pytree_npz, save_pytree_npz
from neuron_gan_tpu_torch.convert import load_jax_state, to_jax_state
from neuron_gan_tpu_torch.data.augment import augment_batch
from neuron_gan_tpu_torch.losses import d_grad_pen_loss
from neuron_gan_tpu_torch.models import (
    DiscriminatorKarras, GeneratorKarras, PGConfig, build_nets)
from neuron_gan_tpu_torch.ops import minibatch_stddev, upsample2_nearest
from neuron_gan_tpu_torch.ops import stddev as mbstd_module

import karras_pggan_reference as ref

MODEL = {'n_gen_features': (16, 8, 8), 'n_dis_features': (8, 8, 16),
         'latent_dim': 8, 'image_size_init': 4, 'n_colors': 3}
B = 8


def config(**kw):
    return PGConfig(architecture='karras', compute_dtype='float32',
                    precision='highest', **{**MODEL, **kw})


def nets(seed=0, **kw):
    """The port's G and D with every bias drawn N(0, 0.1), and the
    reference's copies of their parameters."""
    g, d = build_nets(config(**kw), torch.Generator().manual_seed(seed), 'cpu')
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in [*g.named_parameters(), *d.named_parameters()]:
            if name.endswith('bias'):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return g, d, params(g), params(d)


def params(module):
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def rel(a, b):
    return float((a - b).norm() / b.norm())


def rel_all(a, b, keys):
    num = math.sqrt(sum(float((a[k] - b[k]).norm()) ** 2 for k in keys))
    return num / math.sqrt(sum(float(b[k].norm()) ** 2 for k in keys))


def latents(seed, n=B):
    return ref.latent(torch.Generator().manual_seed(seed), n,
                      MODEL['latent_dim'])


def test_published_geometry():
    """The CelebA-HQ 1024^2 widths (networks.py nf), 23.1 M parameters in
    each net, and the packed layouts refused."""
    fg = [ref.nf(s) for s in range(1, 10)]
    assert fg == [512, 512, 512, 512, 256, 128, 64, 32, 16]
    shapes_g, shapes_d = ref.param_shapes(
        {'n_gen_features': fg, 'n_dis_features': fg[::-1], 'latent_dim': 512,
         'image_size_init': 4, 'n_colors': 3})
    n_g = sum(math.prod(s) for s in shapes_g.values())
    n_d = sum(math.prod(s) for s in shapes_d.values())
    assert round(n_g / 1e6, 1) == 23.1 and round(n_d / 1e6, 1) == 23.1
    with torch.device('meta'):
        g, d = build_nets(config(n_gen_features=fg, n_dis_features=fg[::-1],
                                 latent_dim=512),
                          torch.Generator(), 'meta')
    assert {k: tuple(v.shape) for k, v in g.named_parameters()} == shapes_g
    assert {k: tuple(v.shape) for k, v in d.named_parameters()} == shapes_d
    with pytest.raises(ValueError, match='packed_min_res must be None'):
        config(packed_min_res=8)


@pytest.mark.parametrize('use_kernels', (True, False))
@pytest.mark.parametrize('alpha', (None, 0.3))
def test_generator_matches_reference(alpha, use_kernels):
    g, _, pg, _ = nets(1, use_kernels=use_kernels)
    z = latents(2)
    with torch.no_grad(), ref.exact():
        for phase in (1, 2):
            got = g(z, phase, alpha)
            want = ref.generator(pg, z, phase, MODEL, alpha)
            assert got.shape == (B, 3, 4 * 2 ** phase, 4 * 2 ** phase)
            assert rel(got, want) < 1e-5, (phase, rel(got, want))


@pytest.mark.parametrize('alpha', (None, 0.6))
def test_critic_matches_reference_over_two_groups(alpha):
    _, d, _, pd = nets(3)
    x = torch.randn((B, 3, 16, 16), generator=torch.Generator().manual_seed(4))
    with torch.no_grad(), ref.exact():
        got, want = d(x, 2, alpha), ref.critic(pd, x, 2, MODEL, alpha)
    assert got.shape == (B, 1)
    assert rel(got, want) < 1e-5, rel(got, want)


def test_penalty_gradient_through_the_stddev():
    """D's gradient of the penalty (a gradient of a gradient through the
    minibatch stddev) on the port's losses.py against the reference's."""
    _, d, _, pd = nets(5)
    gen = torch.Generator().manual_seed(6)
    real = torch.rand((B, 3, 16, 16), generator=gen) * 2 - 1
    fake = torch.rand((B, 3, 16, 16), generator=gen) * 2 - 1
    eps = torch.rand(B, generator=gen)
    gp = d_grad_pen_loss(lambda x: d(x, 2), real, fake, eps, 10.0)
    got = dict(zip(pd, torch.autograd.grad(gp, list(d.parameters()),
                                           allow_unused=True)))
    pr = {k: v.requires_grad_() for k, v in pd.items()}
    mixed = (eps.reshape(-1, 1, 1, 1) * real
             + (1 - eps.reshape(-1, 1, 1, 1)) * fake).requires_grad_()
    grad, = torch.autograd.grad(ref.critic(pr, mixed, 2, MODEL).sum(), mixed,
                                create_graph=True)
    want_gp = 10.0 * ((grad.pow(2).sum(dim=(1, 2, 3)).sqrt() - 1) ** 2).mean()
    want = dict(zip(pr, torch.autograd.grad(want_gp, list(pr.values()),
                                            allow_unused=True)))
    keys = [k for k in want if want[k] is not None]
    assert keys and all(got[k] is not None for k in keys)
    assert 'head.conv.weight' in keys
    assert abs(float(gp.detach()) - float(want_gp.detach())) <= 1e-5 * float(want_gp.detach())
    assert rel_all(got, want, keys) < 1e-4, rel_all(got, want, keys)


def test_minibatch_stddev_groups_and_counter():
    x = torch.randn((8, 5, 3, 3), generator=torch.Generator().manual_seed(7))
    mbstd_module.calls_by_case.clear()
    y = minibatch_stddev(x, 4)
    assert mbstd_module.calls_by_case == {(4, (8, 5, 3, 3)): 1}
    # sample n in group n mod 2: rows 0, 2, 4, 6 and 1, 3, 5, 7
    for m in (0, 1):
        rows = x[m::2].double()
        want = (rows.var(dim=0, unbiased=False) + 1e-8).sqrt().mean()
        assert torch.allclose(y[m::2, 5].double(), want.expand(4, 3, 3)
                              .to(torch.float64), rtol=1e-6, atol=0)
    torch.testing.assert_close(y, ref.minibatch_stddev(x, 4))
    torch.testing.assert_close(upsample2_nearest(x),
                               torch.nn.functional.interpolate(x, scale_factor=2))


def _spec(**kw):
    base = dict(
        phase=2, fading=False, n_critic=1, batch_size=B, n_images=2 * B,
        shuffle=True, crop_size=16, translation=0.0, augment=True,
        gp_lambda=10.0, drift_epsilon=0.001, sim_lambda0=0.0, sim_decay=0.0,
        beta1=0.0, rmsprop=False, lr0=1e-3, lr_gamma=1.0, lr_boundary=0,
        lr_cap=1000, alpha_start=0, alpha_step=0.0, latent_dim=8,
        ema_beta=0.999, gp_reuse_fakes=True, beta2=0.99,
        mirror_augment=True)
    base.update(kw)
    return train_step.ChunkSpec(**base)


def test_mirror_draws_and_augmentation():
    """The port's batch draws in mirror mode are the reference's, the
    flips included, and its augmentation of them too."""
    spec, cfg = _spec(), config()
    got = train_step.draw_batch(torch.Generator().manual_seed(8), cfg, spec,
                                B, 16)
    want = ref.batch_draws(torch.Generator().manual_seed(8), B, 8)
    assert set(got['augment']) == {'flip'}
    assert torch.equal(got['augment']['flip'], want['flip'])
    assert 0 < int(want['flip'].sum()) < B
    (z1, z2, eps), = got['critic']
    assert z2 is z1 and torch.equal(z1, want['z'])
    assert torch.equal(eps, want['eps']) and torch.equal(got['zg'], want['zg'])
    raw = torch.rand((B, 16, 16, 3), generator=torch.Generator().manual_seed(9))
    out = augment_batch(raw, got['augment'], train_step._augment_spec(cfg, spec))
    assert torch.equal(out, ref.mirror(raw, want['flip']))


def test_train_steps_match_reference():
    """Four steps of the epoch runner (two epochs of two batches): both
    nets' parameters after Adam (beta1 0, beta2 0.99), the EMA and the
    losses, against the reference's steps on the same draws."""
    g, d, pg, pd = nets(10)
    spec = _spec()
    state = train_step.init_train_state(g, d, beta1=0.0, ema_beta=0.999)
    stack = torch.rand((2 * B, 16, 16, 3),
                       generator=torch.Generator().manual_seed(11))
    run = train_step.make_epoch_runner(config(), spec, 2)
    stats = run(state, stack, torch.Generator().manual_seed(12), 1)
    assert state.g_opt.param_groups[0]['betas'] == (0.0, 0.99)

    tr = ref.Trainer(pg, pd, MODEL, beta2=0.99, ema=0.999)
    gen = torch.Generator().manual_seed(12)
    losses = []
    with ref.exact():
        for _ in range(2):
            epoch = torch.zeros(3)
            for rows, draws in ref.epoch_steps(gen, 2 * B, B, 8):
                epoch += torch.stack(tr.step(stack[rows], draws, 1e-3, 2))
            losses.append(epoch / 2)
    # D_loss, G_loss, the penalty of each epoch
    torch.testing.assert_close(stats[:, [2, 3, 4]], torch.stack(losses),
                               rtol=1e-4, atol=1e-5)
    # the EMA moves 1e-3 of the weights' change a step, about 1e-5 of
    # their scale, where float32 rounds each update at 6e-8: its change is
    # held to 5%, its value as the weights'
    for net, init, got, want, tol in (
            ('d', pd, params(d), tr.d, 1e-4),
            ('g', pg, params(g), tr.g, 1e-4),
            ('ema', pg, params(state.g_ema), tr.g_ema, 0.05)):
        keys = [k for k in init if not torch.equal(want[k], init[k])]
        assert keys, net
        dg = {k: got[k] - init[k] for k in keys}
        dw = {k: want[k] - init[k] for k in keys}
        assert rel_all(dg, dw, keys) < tol, (net, rel_all(dg, dw, keys))
        assert rel_all(got, want, keys) < 2e-6, net


def test_checkpoint_round_trip(tmp_path):
    """The train state (both nets, both Adams, the EMA) through the
    port's .npz and back into a state built from other weights."""
    g, d, _, _ = nets(13)
    state = train_step.init_train_state(g, d, beta1=0.0, ema_beta=0.999,
                                        beta2=0.99)
    stack = torch.rand((B, 16, 16, 3), generator=torch.Generator().manual_seed(14))
    train_step.make_epoch_runner(config(), _spec(n_images=B), 1)(
        state, stack, torch.Generator().manual_seed(15), 1)
    path = str(tmp_path / 'k.npz')
    save_pytree_npz(path, to_jax_state(state), {'architecture': 'karras'})
    tree, meta = load_pytree_npz(path)
    g2, d2, _, _ = nets(16)
    other = train_step.init_train_state(g2, d2, beta1=0.0, ema_beta=0.999,
                                        beta2=0.99)
    report = load_jax_state(other, tree)
    assert not any(report.values()) and meta == {'architecture': 'karras'}
    for a, b in ((state.g, other.g), (state.d, other.d),
                 (state.g_ema, other.g_ema)):
        for (k, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p, q), k
    for o1, o2 in ((state.g_opt, other.g_opt), (state.d_opt, other.d_opt)):
        for p1, p2 in zip(o1.param_groups[0]['params'],
                          o2.param_groups[0]['params']):
            for key in ('exp_avg', 'exp_avg_sq', 'step'):
                assert torch.equal(o1.state[p1][key], o2.state[p2][key])


def _rgb_dataset(path, n=8):
    from PIL import Image
    rng = np.random.default_rng(17)
    path.mkdir()
    for i in range(n):
        img = rng.integers(10, 250, (16, 16, 3)).astype(np.uint8)
        Image.fromarray(img, mode='RGB').save(path / f'im{i}.png')
    return str(path)


def test_train_session_through_the_config_module(tmp_path):
    """The train CLI's path: a config module naming the architecture, a
    TrainSession over an RGB dataset, its chunks, a checkpoint, and the
    eval CLI's generator loaded back from it."""
    from neuron_gan_tpu_torch import eval as teval
    from neuron_gan_tpu_torch import train as ttrain
    root = tmp_path / 'run'
    knobs = dict(
        ID='k1', data_dir=f'{root}/data', images_dir=f'{root}/images',
        weights_dir=f'{root}/weights', plots_dir=f'{root}/plots',
        logs_dir=f'{root}/logs', samples_sub_dir=f'{root}/images/k1',
        dataset_dir=_rgb_dataset(tmp_path / 'rgb'), pggan=True,
        transit_sch=[2, 5], alpha_step=0.5, learning_rate=1e-3, batch_size=4,
        N_epochs=6, beta1=0.0, beta2=0.99, ema_beta=0.999, seed=1,
        checkpointing_period=3, translation=0.0, mirror_augment=True,
        architecture='karras', latent_dim=8, image_size=16, N_colors=3,
        N_gen_features=[16, 8, 8], N_dis_features=[8, 8, 16],
        packed_min_res=None, packed_lanes=None, swd_period=0)
    cfg = tmp_path / 'karras_tiny.py'
    cfg.write_text(''.join(f'{k} = {v!r}\n' for k, v in knobs.items()))
    config = ttrain.load_config(['--configs', str(cfg), '--device', 'cpu'])
    session = ttrain.TrainSession(config)
    assert isinstance(session.state.g, GeneratorKarras)
    assert isinstance(session.state.d, DiscriminatorKarras)
    assert session.images_stack.shape == (8, 24, 24, 3)
    spec = session.make_spec(6, 1)
    assert (spec.beta2, spec.mirror_augment, spec.phase) == (0.99, True, 2)
    stats = session._run_chunk(spec, 6, 1, False)
    assert np.isfinite(stats).all()
    assert session.state.d_opt.param_groups[0]['betas'] == (0.0, 0.99)
    growth = session.growth_at(6)
    session.save_checkpoint(6, growth)
    g, got_growth = teval.load_generator(session.weights_path, 'cpu', ema=True)
    assert isinstance(g, GeneratorKarras) and got_growth.phase == 2
    for p, q in zip(g.parameters(), session.state.g_ema.parameters()):
        assert torch.equal(p, q)
    # a packed layout is refused by name
    knobs['packed_min_res'] = 8
    cfg.write_text(''.join(f'{k} = {v!r}\n' for k, v in knobs.items()))
    with pytest.raises(AssertionError, match='packed_min_res = None'):
        ttrain.load_config(['--configs', str(cfg), '--device', 'cpu'])
