"""The karras_pggan architecture (Karras et al.'s PGGAN at CelebA-HQ
1024^2): its FLOPs frozen at the published geometry and held against
torch's FlopCounterMode over its reference at a small size, its K1/K2 sites
against the port's launches on an eager step, and its cell at the tiny
size through run_cell, traced and not."""

import collections
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import architectures
from benchmark.harness import Bench, run_cell
from benchmark.tests.conftest import REPO

ARCH = architectures.get('karras_pggan')
CELL = 'pggan_celebahq1024.steady1024'


def _cfg(reuse=True, **model):
    cfg = json.loads(
        (REPO / 'benchmark' / 'configs' / 'pggan_celebahq1024.json').read_text())
    for section, keys in ARCH.TINY.items():
        cfg[section].update(keys)
    cfg['model'].update(model)
    cfg['execution']['gp_reuse_fakes'] = reuse
    return cfg


def test_published_flops():
    """G's forward at 1024^2, a MAC a multiply-add of a conv or dense layer
    (no bias), an image: the dense stem 512 * 8192 = 4,194,304; the stem
    conv 512 * 512 * 9 * 16 = 37,748,736; the levels 8^2, 16^2, 32^2 at
    512 channels 301,989,888, 1,207,959,552 and 4,831,838,208; each of the
    five from 64^2 to 1024^2 (C -> C/2, then C/2 -> C/2 at 4x the pixels)
    7,247,757,312; to_rgb 16 * 3 * 1024^2 = 50,331,648.  In all
    42,672,848,896 MAC.  D's: from_rgb 50,331,648; the five levels from
    1024^2 to 64^2 (C -> C, then C -> 2C) 7,247,757,312 each; 32^2, 16^2,
    8^2 at 512 channels 4,831,838,208, 1,207,959,552 and 301,989,888; the
    head conv 513 * 512 * 9 * 16 = 37,822,464, dense 8192 * 512 =
    4,194,304, the score 512: 42,672,923,136 MAC."""
    cfg = Bench().cell(CELL)[1]
    mac_g = (4194304 + 37748736 + 301989888 + 1207959552 + 4831838208
             + 5 * 7247757312 + 50331648)
    assert mac_g == 42672848896
    assert ARCH.g_forward_flops(cfg, 8, 1) == 2 * mac_g
    mac_d = (50331648 + 5 * 7247757312 + 4831838208 + 1207959552
             + 301989888 + 37822464 + 4194304 + 512)
    assert mac_d == 42672923136
    assert sum(m for _, m in ARCH.d_layers(cfg['model'], 8)) == mac_d
    # batch 4: (1 + 3) F_G - f_lin + 14 F_D - 3 f_in - 3 f_out - 2 f_post
    step = ARCH.train_step_flops(cfg, {'phase': 8, 'fading': False})
    assert step == 4 * 2 * (4 * mac_g - 4194304 + 14 * mac_d
                            - 3 * 50331648 - 3 * 512
                            - 2 * (37822464 + 4194304))


@pytest.mark.parametrize('reuse', (True, False))
@pytest.mark.parametrize('fading', (False, True))
def test_train_step_flops(reuse, fading):
    cfg = _cfg(reuse)
    traffic = {'phase': 2, 'fading': fading, 'alpha_step': 0.25,
               'n_images': 8, 'frame': 24}
    g, d, stack = ARCH.train_inputs(cfg, traffic, 3, 'cpu')
    tr = ARCH.Trainer(g, d, cfg, traffic)
    (rows, draws), = ARCH.reference_steps(cfg, traffic, 4, 'cpu', 1)
    with FlopCounterMode(display=False) as count:
        tr.step(stack[rows], draws, 1)
    assert count.get_total_flops() == ARCH.train_step_flops(cfg, traffic)


@pytest.mark.parametrize('phase', (0, 1, 2))
def test_generator_flops(phase):
    cfg = _cfg()
    gen = torch.Generator().manual_seed(4)
    g, _ = ARCH.make_weights(cfg, gen)
    z = ARCH.latent(gen, 5, cfg)
    with FlopCounterMode(display=False) as count:
        ARCH.generator(g, z, phase, cfg)
    assert count.get_total_flops() == ARCH.g_forward_flops(cfg, phase, 5)


def test_kernel_sites_are_the_launches_of_an_eager_step(monkeypatch):
    """At widths that reach the wide instances (512 and 256 channels at
    4^2 and 8^2), the sites are what the port's wrappers count on one
    eager batch step: its K1/K2 calls routed as on the card (the CPU's
    plain versions, counted by the card's case key)."""
    from neuron_gan_tpu_torch.ops import lrelu_pixel_norm as lpn
    from neuron_gan_tpu_torch.train_step import make_batch_step

    def counted(kernel, plain):
        def launch(x, *args):
            lpn.launches_by_case[lpn._case(kernel, x, args[-3])] += 1
            return plain(x, *args)
        return launch

    monkeypatch.setattr(lpn, '_fwd', counted('k1', lpn._fwd))
    monkeypatch.setattr(lpn, '_bwd', counted('k2', lpn._bwd))
    monkeypatch.setattr(lpn, 'launches_by_case', collections.Counter())
    cfg = _cfg(n_gen_features=[512, 256, 16], latent_dim=8)
    cfg['training']['batch_size'] = 4
    traffic = {'phase': 2, 'fading': False, 'n_images': 4, 'frame': 16}
    g_w, d_w, stack = ARCH.train_inputs(cfg, traffic, 5, 'cpu')
    pg, g, d = ARCH.port_nets(cfg, g_w, d_w, 'cpu')
    spec, state, _ = ARCH.port_train(cfg, traffic, g, d)
    (rows, draws), = ARCH.reference_steps(cfg, traffic, 6, 'cpu', 1)
    draws = dict(draws, critic=[tuple(c) for c in draws['critic']])
    make_batch_step(pg, spec)(state, stack[rows], draws, 1.0, 1e-3, 0.0)
    got = collections.Counter()
    for (kernel, _, shape, groups), n in lpn.launches_by_case.items():
        got[kernel.replace('/', '_'), shape, groups] += n
    sites = ARCH.kernel_sites(cfg, traffic)
    assert dict(got) == sites
    assert {k for k, _, _ in sites} == {'k1', 'k2', 'k1_wide', 'k2_wide'}


@pytest.mark.parametrize('trace', (0, 1))
def test_cell_at_the_tiny_size(tiny, trace):
    res, out = run_cell(CELL, 2 ** 31 + 23, 0.2, bool(trace), 'cpu',
                        bench=tiny)
    assert res['correct'], res['checks']
    if trace:
        assert {'train_mfu_pct', 'idle_ms_per_step.outside'} <= set(
            res['metrics'])
        # the wide instances' kernels are a category of their own
        assert set(out['reading'].kernels) == {'k1_wide', 'k2_wide'}
    else:
        assert set(res['metrics']) == {'train_steps_per_s', 'setup_s'}
