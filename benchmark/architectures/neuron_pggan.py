"""neuron-gan's variant of the PGGAN (oliviertrottier/neuron-gan, models.py),
as the port's ``models/pggan.py`` runs it: G upsamples bilinearly and ends
in a plain 1x1 to_rgb with tanh; D pools before its two convs, has
PixelNorm in every block and a conv head.  The interface of
architectures/__init__.py over the benchmark's reference of it
(reference/model.py, train.py, draws.py, augment.py), its FLOP count
(flops.py) and its K1-K4 sites (kernels.py).

The program's functions import ``neuron_gan_tpu_torch`` inside themselves
only; the rest imports nothing of it.
"""

import contextlib

import torch

from benchmark import flops, kernels
from benchmark.reference import augment as ref_augment
from benchmark.reference import draws as ref_draws
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train

# the cut of the CPU tests: three levels of 4^2-16^2 and a few channels; a
# key that is null in a configuration stays null (an unpacked one stays so)
TINY = {'model': {'n_gen_features': [16, 8, 8], 'n_dis_features': [8, 8, 16],
                  'latent_dim': 8, 'image_size_init': 4, 'n_colors': 1,
                  'neg_slope': 0.2},
        'training': {'crop_size': 16},
        'execution': {'packed_min_res': 8}}

Trainer = ref_train.Trainer


# --------------------------------------------------------------------------
# Inputs and draws
# --------------------------------------------------------------------------

def make_weights(cfg, gen):
    return ref_model.make_weights(cfg['model'], gen)


def latent(gen, n, cfg):
    return ref_draws.latent(gen, n, cfg['model']['latent_dim'])


def train_inputs(cfg, traffic, seed, device):
    """(G weights, D weights, stack) from ``seed``, made on ``device`` in
    three calls."""
    gen = torch.Generator(device=device).manual_seed(seed)
    g_w, d_w = make_weights(cfg, gen)
    p = traffic['frame']
    stack = torch.rand((traffic['n_images'], p, p, cfg['model']['n_colors']),
                       generator=gen, device=device)
    return g_w, d_w, stack


def _max_shift(cfg, traffic):
    t, ex = cfg['training'], cfg['execution']
    res = ref_model.resolution(cfg['model'], traffic['phase'])
    return t['translation'] * ref_augment.warp_frame(
        res, t['crop_size'], traffic['frame'], ex['fast_augment'],
        ref_augment.shear_for(ex, res))


def reference_steps(cfg, traffic, seed, device, n):
    t = cfg['training']
    gen = torch.Generator(device=device).manual_seed(seed)
    return ref_draws.steps(
        gen, n, traffic['n_images'], t['batch_size'],
        latent_dim=cfg['model']['latent_dim'], n_critic=t['n_critic'],
        reuse_fakes=cfg['execution']['gp_reuse_fakes'],
        max_shift=_max_shift(cfg, traffic), augment=t['augment'])


@contextlib.contextmanager
def augment_look(cfg, traffic):
    """Records the program's first augmentation call while open; on close,
    the dict it yields gets the pixels where the reference's augmentation
    of that batch and draws differs from the program's, and the largest
    gap."""
    from benchmark.harness import ref_precision
    from neuron_gan_tpu_torch import train_step as ts
    seen, inner, look = [], ts.augment_batch, {}

    def probe(images, draws, spec):
        out = inner(images, draws, spec)
        if not seen:
            seen.append((images.clone(), draws, out.clone()))
        return out

    ts.augment_batch = probe
    try:
        yield look
    finally:
        ts.augment_batch = inner
    raw, draws, out = seen[0]
    t, ex = cfg['training'], cfg['execution']
    res = ref_model.resolution(cfg['model'], traffic['phase'])
    with ref_precision():
        ref = ref_augment.augment(
            raw, draws, res, t['crop_size'], augment=t['augment'],
            fast=ex['fast_augment'], shear=ref_augment.shear_for(ex, res))
    gap = (out.float() - ref).abs()
    look.update(pixels=int((gap > 0).sum()), max=float(gap.max()))


# --------------------------------------------------------------------------
# The reference
# --------------------------------------------------------------------------

def generator(p, z, phase, cfg, alpha=None, precision='float32'):
    return ref_model.generator(p, z, phase, cfg['model'], alpha, precision)


# --------------------------------------------------------------------------
# The program
# --------------------------------------------------------------------------

def port_config(cfg):
    from neuron_gan_tpu_torch.models import PGConfig
    m, ex = cfg['model'], cfg['execution']
    return PGConfig(
        n_gen_features=tuple(m['n_gen_features']),
        n_dis_features=tuple(m['n_dis_features']),
        latent_dim=m['latent_dim'], image_size_init=m['image_size_init'],
        n_colors=m['n_colors'], neg_slope=m['neg_slope'],
        compute_dtype=ex['compute_dtype'], precision=ex['precision'],
        use_kernels=ex['use_kernels'], packed_min_res=ex['packed_min_res'],
        packed_lanes=ex['packed_lanes'])


def _chunk_spec(cfg, traffic):
    from neuron_gan_tpu_torch.train_step import ChunkSpec
    t, ex = cfg['training'], cfg['execution']
    return ChunkSpec(
        phase=traffic['phase'], fading=traffic['fading'],
        n_critic=t['n_critic'], batch_size=t['batch_size'],
        n_images=traffic['n_images'], shuffle=True,
        crop_size=t['crop_size'], translation=t['translation'],
        augment=t['augment'], gp_lambda=t['gp_lambda'],
        drift_epsilon=t['drift_epsilon'], sim_lambda0=0.0, sim_decay=0.0,
        beta1=t['beta1'], rmsprop=False, lr0=t['lr0'],
        lr_gamma=t['lr_gamma'], lr_boundary=0, lr_cap=t['lr_cap'],
        alpha_start=traffic.get('alpha_start', 0),
        alpha_step=traffic.get('alpha_step', 1e-4),
        latent_dim=cfg['model']['latent_dim'],
        fast_augment=ex['fast_augment'], shear_warp=ex['shear_warp'],
        gp_reuse_fakes=ex['gp_reuse_fakes'])


def port_nets(cfg, g_w, d_w, device):
    """The port's G (and D when ``d_w``) holding the benchmark's weights."""
    from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
    pg = port_config(cfg)
    host = torch.Generator().manual_seed(0)
    g = GeneratorPG(pg, host, device=device)
    g.load_state_dict(g_w)
    if d_w is None:
        return pg, g, None
    d = DiscriminatorPG(pg, host, device=device)
    d.load_state_dict(d_w)
    return pg, g, d


def port_train(cfg, traffic, g, d):
    from neuron_gan_tpu_torch.train_step import init_train_state
    spec = _chunk_spec(cfg, traffic)
    return spec, init_train_state(g, d, beta1=spec.beta1), spec.beta1


# --------------------------------------------------------------------------
# Counts
# --------------------------------------------------------------------------

def train_step_flops(cfg, traffic):
    return flops.train_step(cfg['model'], traffic['phase'],
                            cfg['training']['batch_size'],
                            cfg['execution']['gp_reuse_fakes'],
                            traffic['fading'])


def g_forward_flops(cfg, phase, batch):
    return flops.g_forward(cfg['model'], phase, batch)


def kernel_sites(cfg, traffic):
    ex = cfg['execution']
    return kernels.sites(cfg['model'], ex, traffic['phase'],
                         cfg['training']['batch_size'],
                         kernels.step_passes(ex['gp_reuse_fakes']))
