"""The 1024^2 EMA run (``tools/stretch_1024.py``) on the CPU: its geometry's
last levels against the JAX package, its routing against the JAX
package's predicates, and its body at a tiny geometry with the launch
bookkeeping chip_smoke.py holds on the card.

Inputs are numpy arrays from a seed, handed to both sides.  Tolerances:
G and D as tests/test_torch_packed8.py holds them (outputs rtol 1e-4 /
atol 1e-5; gradients rtol 1e-4 with atol 1e-5 times the leaf's largest
magnitude), the gradients at the LeakyReLU slope 0.2 by relative L2 (see
``test_stretch_tail_nets_match_jax``); the .npz and the EMA shadow
exactly.
"""

import collections

import numpy as np
import pytest

import jax
import torch

from neuron_gan_tpu.models import (
    PGConfig as JPGConfig, init_discriminator_pg, init_generator_pg)

import neuron_gan_tpu_torch.ops.lrelu_pixel_norm as lpn
import neuron_gan_tpu_torch.ops.packed_conv_lrelu_pn as pcl
from neuron_gan_tpu_torch import flagship
from neuron_gan_tpu_torch.models import PGConfig
from neuron_gan_tpu_torch.tools import stretch_1024 as s1k

from test_torch_packed8 import ROUTES, grad_close
from test_torch_train_step import load_chip_smoke

@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite's
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the stretch geometry's last levels at 4^2 -> 64^2: 16 channels, then the
# 8-channel top level, both in the 2x4 layout (8 groups of 8 at the top)
TAIL = dict(n_gen_features=(32, 32, 16, 16, 8), n_dis_features=(8, 16, 16, 32, 32),
            latent_dim=8, image_size_init=4, packed_min_res=8, packed_lanes=128)


# (route, phase, alpha, LeakyReLU slope): both routes steady at 64^2, the
# native one also fading in and at the model's slope
TAIL_CASES = [('native', 4, None, 1.0), ('sandwich', 4, None, 1.0),
              ('native', 4, 0.4, 1.0), ('native', 4, None, 0.2)]


@pytest.mark.parametrize('route,phase,alpha,neg_slope', TAIL_CASES)
@pytest.mark.parametrize('net', ['G', 'D'])
def test_stretch_tail_nets_match_jax(net, route, phase, alpha, neg_slope):
    # At the model's slope 0.2 a pre-activation within float32 rounding of
    # 0 (at batch 8 a few of the 2x4 levels' 131k lie within 1e-7 of it)
    # takes the LeakyReLU's other derivative in one package: a flip at one
    # pixel moves every earlier layer's weight gradient by about 1e-2
    # (relative L2), and G's gradients then fail the elementwise bound for
    # 10 of 16 seeds, JAX's as far from the port's float32 run as from its
    # own.  So: slope 1 (no kink) holds outputs and gradients elementwise;
    # slope 0.2 holds the outputs elementwise and each gradient leaf within
    # 0.05 relative L2 (a slope applied wrongly moves them by 0.3 or more).
    from test_torch_mixed import jax_net, net_inputs, port_net
    arch = dict(TAIL, neg_slope=neg_slope)
    kg, kd = jax.random.split(jax.random.PRNGKey(10))
    jcfg = JPGConfig(**dict(arch, **ROUTES[route]))
    tcfg = PGConfig(**dict(arch, **ROUTES[route]), use_kernels=True)
    tree = jax.tree.map(np.asarray, (init_generator_pg(kg, jcfg) if net == 'G'
                                     else init_discriminator_pg(kd, jcfg)))
    inp, cot = net_inputs(net, jcfg, phase, 80 + phase)   # test_torch_packed8.py's seeds
    jy, _, jg = jax_net(net, tree, jcfg, inp, cot, phase, alpha)
    ty, _, tg = port_net(net, port_net_module(net, tree, tcfg), inp, cot, phase, alpha)
    np.testing.assert_allclose(ty, jy, rtol=1e-4, atol=1e-5)
    for a, b in zip(tg, jg):
        if neg_slope == 1.0:
            grad_close(a, b)
        else:
            assert np.linalg.norm(a - b) <= 0.05 * np.linalg.norm(b)


def port_net_module(net, tree, cfg):
    from neuron_gan_tpu_torch.convert import load_jax_tree
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    cls = GeneratorPG if net == 'G' else DiscriminatorPG
    return load_jax_tree(cls(cfg, torch.Generator().manual_seed(0), device='cpu'), tree)


def test_stretch_routes_are_the_jax_routes():
    # the 1024^2 flagship one level deeper: every level's layout by the
    # port's predicates and the JAX package's, the top G level in the 2x4
    # layout at 8 channels (K1/K2 at 8 groups of 8 on (4, 64, 512, 256))
    from neuron_gan_tpu.flagship import flagship_config as jflag
    from neuron_gan_tpu.models import pggan as jm
    from neuron_gan_tpu_torch.models import pggan as tm
    smoke = load_chip_smoke()
    cfg, spec = s1k.stretch_config()
    jcfg = jflag(**s1k.GEOMETRY)
    assert cfg.image_size_max == 1024 and spec.crop_size == 1024
    assert (spec.batch_size, spec.n_images, spec.ema_beta) == (4, 8, 0.999)
    for i in range(1, cfg.n_phases):
        res = cfg.resolution(i)
        for feat in (cfg.n_gen_features[i], cfg.n_dis_features[i]):
            assert tm._want_packed8_g(cfg, res, feat) == jm._want_packed8_g(jcfg, res, feat)
            assert tm._want_packed8_d(cfg, res, feat) == jm._want_packed8_d(jcfg, res, feat)
            assert tm._want_packed(cfg, res) == jm._want_packed(jcfg, res)
    assert flagship.block_layouts(cfg, 6) == (
        ['unpacked', 'packed', 'packed', 'p8', 'p8', 'p8'],
        ['p8', 'p8', 'packed', 'packed', 'unpacked', 'unpacked'])
    sites = flagship.step_sites(cfg, 6, 4)
    assert sites['k1', (4, 64, 512, 256), 8] == 6 and sites['k2', (4, 64, 512, 256), 8] == 2
    assert lpn.kernel_instance(64 // 8, torch.bfloat16) == (8, 8)
    assert smoke.expected_launches(cfg, [6]) == {
        'k1': {'bfloat16/1': 22, 'bfloat16/4': 14, 'bfloat16/8': 34},
        'k2': {'bfloat16/1': 22, 'bfloat16/4': 12, 'bfloat16/8': 26},
        'k3': {'bfloat16': 14}, 'k4': {'bfloat16': 12}}


def count_cases(monkeypatch):
    """Every kernel wrapper's calls, keyed as ``launches_by_case`` keys
    the card's launches: (kernel, dtype, shape, grouping or r's case)."""
    cases = collections.Counter()

    def wrap(mod, attr, key_of):
        fn = getattr(mod, attr)

        def wrapped(*a):
            out = fn(*a)
            cases[key_of(a, out)] += 1
            return out
        monkeypatch.setattr(mod, attr, wrapped)

    wrap(lpn, '_fwd', lambda a, out: ('k1', lpn.dtype_name(a[0]), tuple(a[0].shape), a[-3]))
    wrap(lpn, '_bwd', lambda a, out: ('k2', lpn.dtype_name(a[0]), tuple(a[0].shape), a[-3]))
    wrap(pcl, '_conv_fwd', lambda a, out: ('k3', lpn.dtype_name(a[0]),
                                           tuple(out[0].shape), None))
    wrap(pcl, '_dz', lambda a, out: ('k4', lpn.dtype_name(a[0]), tuple(a[0].shape),
                                     'absent' if a[3] is None else 'live'))
    return cases


def test_stretch_body_on_the_cpu(tmp_path, monkeypatch):
    # the tool's body at TAIL's geometry: its checks (finite stats, 0 <
    # d_ema < d_raw), an .npz the JAX package reads with g_ema exactly,
    # the -ema grid, and every kernel call as chip_smoke.py's stretch phase
    # expects it: the steps by step_sites, then the grid's G forward
    from neuron_gan_tpu.checkpoint import load_pytree_npz as j_load
    from neuron_gan_tpu_torch.convert import to_jax_state
    from neuron_gan_tpu_torch.data.neuron_dataset import decode_image
    smoke = load_chip_smoke()
    monkeypatch.setattr(s1k, 'GEOMETRY', {k: TAIL[k] for k in (
        'n_gen_features', 'n_dis_features', 'image_size_init', 'packed_min_res')})
    cases = count_cases(monkeypatch)
    args = s1k.parse_args(['--epochs', '1', '--device', 'cpu', '--out', str(tmp_path)])
    result, state = s1k.run(args)
    d_ema, d_raw = result['d_ema_vs_d_raw']
    assert 0 < d_ema < d_raw and result['resolution'] == 64
    assert result['steps'] == 2 and np.isfinite(result['stats_mean']).all()

    tree, meta = j_load(result['checkpoint'])
    want = to_jax_state(state)
    for key in ('g_ema', 'g_params', 'd_params'):
        flat, flat_want = jax.tree.leaves(tree[key]), jax.tree.leaves(want[key])
        assert len(flat) == len(flat_want)
        assert all(np.array_equal(a, b) for a, b in zip(flat, flat_want))
    assert (meta['image_size'], meta['phase'], meta['epoch']) == (64, 4, 2)
    assert decode_image(result['ema_grid']).shape == (2 * 66 + 2,) * 2

    cfg, spec = s1k.stretch_config(args.batch, args.ema_beta)
    assert cfg.packed_lanes == 128 and cfg.dtype == torch.bfloat16
    n_steps = 2 * args.epochs * spec.n_full_batches
    want_cases = collections.Counter()
    for (k, shape, case), n in flagship.step_sites(cfg, 4, args.batch).items():
        want_cases[k, 'bfloat16', shape, case] += n * n_steps
    for (k, shape, case), n in flagship.step_sites(cfg, 4, 4, flagship.SAMPLE_PASSES).items():
        want_cases[k, 'bfloat16', shape, case] += n
    assert cases == want_cases
    assert cases['k1', 'bfloat16', (4, 64, 32, 16), 8] > 0       # C_g 8
    # the per-step sites the smoke reports, read from the counts
    samples = flagship.step_sites(cfg, 4, 4, flagship.SAMPLE_PASSES)
    assert smoke.per_step_sites(cases, 'bfloat16', n_steps, samples) == {
        key: float(n) for key, n in flagship.step_sites(cfg, 4, args.batch).items()}
