"""The yardstick's arithmetic at a small size: the analytic model FLOPs
against torch's FlopCounterMode over the reference, the frozen kernel
launch sites against the port's own, and the kernels' least times against
their shapes.  The counts of an architecture are reached through its
module (architectures/<name>.py)."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import architectures, kernels, trace
from benchmark.harness import Bench

PEAKS = {'hbm_bytes_per_s': 3.35e12, 'float32_flops_per_s': 67e12,
         'tf32_flops_per_s': 495e12, 'bfloat16_flops_per_s': 989e12}
ARCH = architectures.get('neuron_pggan')


def _cfg(reuse):
    return {'model': ARCH.TINY['model'],
            'training': dict(n_critic=1, gp_lambda=10.0, drift_epsilon=1e-3,
                             beta1=0.5, lr0=1e-4, lr_gamma=0.9998157,
                             lr_cap=12500, crop_size=16, augment=True,
                             translation=0.05, batch_size=4),
            'execution': dict(fast_augment=False, shear_warp=False,
                              gp_reuse_fakes=reuse)}


# phases whose resolution is the crop's: the augmentation then runs no
# resize, whose matmuls are not model FLOPs
@pytest.mark.parametrize('reuse', (True, False))
@pytest.mark.parametrize('fading', (False, True))
def test_train_step_flops(reuse, fading):
    cfg = _cfg(reuse)
    traffic = {'phase': 2, 'fading': fading, 'alpha_step': 0.25,
               'n_images': 4, 'frame': 24}
    g, d, stack = ARCH.train_inputs(cfg, traffic, 3, 'cpu')
    tr = ARCH.Trainer(g, d, cfg, traffic)
    (rows, draws), = ARCH.reference_steps(cfg, traffic, 4, 'cpu', 1)
    with FlopCounterMode(display=False) as count:
        tr.step(stack[rows], draws, 1)
    assert count.get_total_flops() == ARCH.train_step_flops(cfg, traffic)


@pytest.mark.parametrize('phase', (0, 1, 2))
def test_generator_flops(phase):
    cfg = _cfg(True)
    gen = torch.Generator().manual_seed(4)
    g, _ = ARCH.make_weights(cfg, gen)
    z = ARCH.latent(gen, 5, cfg)
    with FlopCounterMode(display=False) as count:
        ARCH.generator(g, z, phase, cfg)
    assert count.get_total_flops() == ARCH.g_forward_flops(cfg, phase, 5)


def test_flagship_flops():
    """The 512^2 geometry: G 4.467 and D 1.518 GFLOP an image."""
    cfg = Bench().cell('neuron512_ship.steady512')[1]
    assert ARCH.g_forward_flops(cfg, 5, 1) == 4466933760
    assert 2 * sum(x for _, x in ARCH.flops.d_layers(cfg['model'], 5)) \
        == 1518403584


@pytest.mark.parametrize('config,phase', [('neuron512_ship', 5),
                                          ('neuron512_ship', 3),
                                          ('neuron512_f32', 5)])
def test_sites_match_the_port(config, phase):
    """The frozen sites are the port's flagship.step_sites at the
    configuration, phase and batch."""
    from neuron_gan_tpu_torch import flagship
    cfg = Bench()._json('configs', config)
    batch = cfg['training']['batch_size']
    reuse = cfg['execution']['gp_reuse_fakes']
    ours = ARCH.kernel_sites(cfg, {'phase': phase})
    port = flagship.step_sites(ARCH.port_config(cfg), phase, batch,
                               flagship.step_passes(gp_reuse_fakes=reuse))
    assert ours == port and ours


def test_least_times():
    shape = (8, 64, 128, 128)
    n = math.prod(shape)
    assert kernels.least_s('k1', shape, 4, 2, PEAKS) == 2 * n * 2 / 3.35e12
    assert kernels.least_s('k2', shape, 1, 4, PEAKS) == 3 * n * 4 / 3.35e12
    live = kernels.least_s('k4', shape, 'live', 2, PEAKS)
    absent = kernels.least_s('k4', shape, 'absent', 2, PEAKS)
    assert live - absent == pytest.approx(4 * 8 * 4 * 128 * 128 / 3.35e12)
    # K3: 2.25 K N nonzero taps a packed pixel, its bytes: x, y, w, r
    k3 = kernels.least_s('k3', shape, None, 2, PEAKS)
    pix = 8 * 128 * 128
    assert k3 == max((2 * pix * 128 + 4 * 64 * 64 * 9 + 16 * pix) / 3.35e12,
                     2 * 2.25 * 64 * 64 * pix / 989e12)
    # a packed 2x2 conv3x3 weight has 36 nonzero taps an input and output
    # channel pair of the original conv
    from neuron_gan_tpu_torch.ops import packed as pk
    w = pk.pack_conv3x3_weight(torch.randn(16, 16, 3, 3), 1.0)
    assert int((w != 0).sum()) == 2.25 * 64 * 64


def test_an_architectures_own_kernels():
    """A kernel an architecture names in its KERNELS gets its own category
    in a trace and its least time from its own function."""
    own = {'k5': (('fused_head',), lambda shape, case, itemsize, peaks:
                  math.prod(shape) * itemsize / peaks['hbm_bytes_per_s'])}
    assert trace.category('void fused_head_kernel<float>', own) == 'k5'
    assert trace.category('void fused_head_kernel<float>') != 'k5'
    assert trace.category('lrelu_pn_fwd_kernel', own) == 'k1'
    sites = {('k5', (2, 8, 4, 4), None): 3, ('k1', (2, 8, 4, 4), 1): 2}
    assert kernels.least_s_per_step(sites, ('k5',), 2, PEAKS, own) == \
        3 * 256 * 2 / 3.35e12
    assert kernels.least_s_per_step(sites, ('k1',), 2, PEAKS, own) == \
        2 * kernels.least_s('k1', (2, 8, 4, 4), 1, 2, PEAKS)
