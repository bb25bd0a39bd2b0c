"""Karras et al.'s PGGAN (ICLR 2018, arXiv:1710.10196;
github.com/tkarras/progressive_growing_of_gans networks.py G_paper, D_paper,
minibatch_stddev_layer; loss.py D_wgangp_acgan, G_wgan_acgan; train.py's
Adam and Gs), as the port's ``models/karras.py`` runs it: the interface of
architectures/__init__.py with its own plain reference, draws, FLOP count
and K1/K2 sites.

* G: PixelNorm of the latent, dense (gain sqrt(2)/4) + LReLU + PixelNorm,
  conv3x3 + LReLU + PixelNorm; each level nearest x2, then twice conv3x3 +
  LReLU + PixelNorm; to_rgb a 1x1 conv, gain 1, no activation.
* D: from_rgb 1x1 conv + LReLU; each level conv3x3 + LReLU at its width,
  conv3x3 + LReLU to the next width, then a 2x2 average pool; no
  PixelNorm; head: minibatch stddev (groups of 4: sample n in group n
  mod M), conv3x3 (F+1 -> F) + LReLU, dense (F*16 -> F) +
  LReLU, dense (F -> 1, gain 1).
* Every layer has a bias; weights N(0, 1), scaled at run time by
  gain / sqrt(fan_in), gain sqrt(2) unless said; biases start at zero.
* Loss: -<D(x)> + <D(G(z))> + 0.001 <D(x)^2> + 10 <(||dD/dx_hat|| - 1)^2>
  on x_hat = e x + (1 - e) G(z), the critic loss's own fakes (loss.py);
  G: -<D(G(zg))>.  Adam (beta1, beta2, eps 1e-8) at a constant lr, then
  G's EMA Gs = beta Gs + (1 - beta) G.
* Augmentation: each image flipped left-right where its draw says, the
  centre crop, (0, 1) -> (-1, 1), the antialiased resize below the crop.

Departures from the TensorFlow code, the port's too: D's second conv and
its pool unfused (conv, bias, LReLU, pool; networks.py's default
``fused_scale`` pools inside the conv and applies the bias and LReLU after
it), G's nearest upsample and conv unfused (the same map); torch's Adam
(eps added to sqrt(v) / sqrt(1 - beta2^t)); the latents are the port's
draws (normals clamped to [-5, 5] and normalised: G's latent PixelNorm
makes them a normal latent's, up to the clamp and eps).

``precision`` of the reference: 'float32'; 'bf16', the port's 'mixed'
recipe: the blocks' activations, weights and gradients through bfloat16
(the epilogues in float32 from bfloat16 inputs, rounded once), the latent
norm and the dense stem layer, the image G hands out and D's head in
float32; 'fp8' that recipe with float8 in place of bfloat16; 'tf32'
every product's operands rounded to TF32 (benchmark/reference/model.py's
``low`` and ``quantize``).

The program's functions import ``neuron_gan_tpu_torch`` inside themselves
only; the rest imports nothing of it.
"""

import contextlib
import math

import torch
import torch.nn.functional as F

from benchmark import kernels
from benchmark.reference import augment as ref_augment
from benchmark.reference import draws as ref_draws
from benchmark.reference.model import low, quantize
from benchmark.reference.train import Adam, alpha_at

GAIN = math.sqrt(2.0)
# the samples a minibatch-stddev group takes (networks.py's mbstd_group_size)
MBSTD_GROUP = 4

# the cut of the CPU tests: three levels of 4^2-16^2, a few channels, RGB,
# batch 8 (two minibatch-stddev groups of 4), in float32: torch's CPU
# bfloat16 conv (2.13) gets the double backward of a padded conv wrong
# with respect to its weight (it misses most of the penalty's gradient
# there), which the card's cuDNN convs do not
TINY = {'model': {'n_gen_features': [16, 8, 8], 'n_dis_features': [8, 8, 16],
                  'latent_dim': 8, 'image_size_init': 4, 'n_colors': 3,
                  'neg_slope': 0.2},
        'training': {'crop_size': 16, 'batch_size': 8},
        'execution': {'compute_dtype': 'float32', 'precision': 'highest'}}

# the wide K1/K2 instances (C_g 256 and 512), kernels of their own name
KERNELS = {
    'k1_wide': (('lrelu_pn_wide_fwd',),
                lambda shape, case, itemsize, peaks:
                kernels.least_s('k1', shape, case, itemsize, peaks)),
    'k2_wide': (('lrelu_pn_wide_bwd',),
                lambda shape, case, itemsize, peaks:
                kernels.least_s('k2', shape, case, itemsize, peaks)),
}
WIDE = (256, 512)


def resolution(model, phase):
    return model['image_size_init'] * 2 ** phase


# --------------------------------------------------------------------------
# The reference
# --------------------------------------------------------------------------

def param_shapes(model):
    """[(net, name, shape)] of G's and D's parameters in a fixed order; a
    1-D shape is a bias."""
    fg, fd = model['n_gen_features'], model['n_dis_features']
    init, c, lat = model['image_size_init'], model['n_colors'], model['latent_dim']
    out = []

    def layer(net, name, w):
        out.extend([(net, name + '.weight', w), (net, name + '.bias', (w[0],))])

    layer('g', 'stem.linear', (fg[0] * init * init, lat))
    layer('g', 'stem.conv', (fg[0], fg[0], 3, 3))
    for i in range(len(fg) - 1):
        layer('g', f'blocks.{i}.conv1', (fg[i + 1], fg[i], 3, 3))
        layer('g', f'blocks.{i}.conv2', (fg[i + 1], fg[i + 1], 3, 3))
    for i in range(len(fg)):
        layer('g', f'to_rgb.{i}', (c, fg[i], 1, 1))
    for i in range(len(fd)):
        layer('d', f'from_rgb.{i}', (fd[i], c, 1, 1))
    for i in range(len(fd) - 1):
        layer('d', f'blocks.{i}.conv1', (fd[i], fd[i], 3, 3))
        layer('d', f'blocks.{i}.conv2', (fd[i + 1], fd[i], 3, 3))
    layer('d', 'head.conv', (fd[-1], fd[-1] + 1, 3, 3))
    layer('d', 'head.dense0', (fd[-1], fd[-1] * init * init))
    layer('d', 'head.dense1', (1, fd[-1]))
    return out


def make_weights(cfg, gen):
    """({name: G tensor}, {name: D tensor}) on ``gen``'s device: every
    weight N(0, 1) from one draw, every bias zero."""
    specs = param_shapes(cfg['model'])
    n = sum(math.prod(s) for _, _, s in specs if len(s) > 1)
    flat = torch.randn(n, generator=gen, device=gen.device)
    nets, at = {'g': {}, 'd': {}}, 0
    for net, name, shape in specs:
        if len(shape) > 1:
            k = math.prod(shape)
            nets[net][name] = flat[at:at + k].view(shape)
            at += k
        else:
            nets[net][name] = torch.zeros(shape, device=gen.device)
    return nets['g'], nets['d']


def _lrelu(x, slope=0.2):
    return torch.where(x >= 0, x, x * slope)


def _pn(x):
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-8)


def _conv(x, p, name, q, gain=GAIN):
    """Equalized conv with bias, its products in ``q``."""
    w = p[name + '.weight']
    w = w * (gain / math.sqrt(w[0].numel()))
    b, pad = p[name + '.bias'], w.shape[-1] // 2
    if q in ('bf16', 'fp8'):
        return low(F.conv2d(low(x, q), low(w, q), low(b, q), padding=pad), q)
    return F.conv2d(quantize(x, q), quantize(w, q), b, padding=pad)


def _dense(x, p, name, q, gain=GAIN):
    w = p[name + '.weight']
    w = w * (gain / math.sqrt(w.shape[1]))
    x = x.reshape(x.shape[0], -1)
    return quantize(x, q) @ quantize(w, q).t() + p[name + '.bias']


def _upscale(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def minibatch_stddev(x, group_size):
    """networks.py::minibatch_stddev_layer (float32): groups
    x.reshape(G, M, ...), sample n in group n mod M."""
    g = min(group_size, x.shape[0])
    s = x.shape
    y = x.reshape(g, -1, s[1], s[2], s[3])
    y = y - y.mean(dim=0, keepdim=True)
    y = torch.sqrt((y ** 2).mean(dim=0) + 1e-8)
    y = y.mean(dim=(1, 2, 3), keepdim=True).repeat(g, 1, s[2], s[3])
    return torch.cat([x, y], dim=1)


def _fade(start, end, alpha):
    return start + alpha * (end - start)


def generator(p, z, phase, cfg, alpha=None, precision='float32'):
    """G: latents (B, latent) -> images (B, C, R, R) at ``phase``."""
    m, q = cfg['model'], precision
    f0, init = m['n_gen_features'][0], m['image_size_init']
    # the latent norm and the dense layer in float32 under the 'mixed'
    # recipe; the rest in the blocks' type
    q_stem = q if q == 'tf32' else 'float32'
    x = _dense(_pn(z), p, 'stem.linear', q_stem, gain=GAIN / 4)
    x = low(x.reshape(-1, f0, init, init), q)

    def act(x):
        return low(_pn(_lrelu(x)), q)

    x = act(x)
    x = act(_conv(x, p, 'stem.conv', q))

    def block(x, i):
        x = _upscale(x)
        x = act(_conv(x, p, f'blocks.{i}.conv1', q))
        return act(_conv(x, p, f'blocks.{i}.conv2', q))

    def to_rgb(x, i):
        return _conv(x, p, f'to_rgb.{i}', q, gain=1.0)

    if alpha is None:
        for i in range(phase):
            x = block(x, i)
        return to_rgb(x, phase)
    for i in range(phase - 1):
        x = block(x, i)
    return _fade(_upscale(to_rgb(x, phase - 1)),
                 to_rgb(block(x, phase - 1), phase), alpha)


def critic(p, x, phase, cfg, alpha=None, precision='float32'):
    """D: images (B, C, R, R) at ``phase`` -> scores (B, 1)."""
    m, q = cfg['model'], precision
    n = len(m['n_dis_features'])

    def act(y):
        return low(_lrelu(y), q)

    def from_rgb(y, i):
        return act(_conv(y, p, f'from_rgb.{i}', q))

    def block(y, i):
        y = act(_conv(y, p, f'blocks.{i}.conv1', q))
        y = act(_conv(y, p, f'blocks.{i}.conv2', q))
        return low(F.avg_pool2d(y, 2), q)

    x = low(x, q)
    first = n - 1 - phase
    y = from_rgb(x, first)
    if alpha is not None:
        start = from_rgb(low(F.avg_pool2d(x, 2), q), first + 1)
        y = _fade(start, block(y, first), alpha)
        first += 1
    for i in range(first, n - 1):
        y = block(y, i)
    # the head runs in float32 under the 'mixed' recipe
    q_head = q if q == 'tf32' else 'float32'
    y = minibatch_stddev(y, MBSTD_GROUP)
    y = _lrelu(_conv(y, p, 'head.conv', q_head))
    y = _lrelu(_dense(y, p, 'head.dense0', q_head))
    return _dense(y, p, 'head.dense1', q_head, gain=1.0)


def mirror(raw, flip, out_size, crop_size, augment=True):
    """raw (B, P, P, C) in [0, 1] -> (B, C, out, out) in [-1, 1]: the flip
    where drawn, the centre crop, the resize below the crop."""
    x = raw.permute(0, 3, 1, 2)
    if augment:
        x = torch.where(flip[:, None, None, None], torch.flip(x, dims=(3,)), x)
    top = int(round((x.shape[-1] - crop_size) / 2.0))
    x = x[:, :, top:top + crop_size, top:top + crop_size] * 2.0 - 1.0
    return ref_augment.resize(x, out_size) if out_size < crop_size else x


class Trainer:
    """The reference's G, D, Adams and G's EMA from a copy of the weights;
    ``step`` runs one batch step: ``n_critic`` critic updates, then one
    generator update and the EMA.  Stats are (score_real, score_fake,
    D_loss, G_loss, GP, 0)."""

    def __init__(self, g, d, cfg, traffic, precision='float32'):
        self.cfg, self.traffic, self.precision = cfg, traffic, precision
        t = cfg['training']
        self.g = {k: v.detach().clone() for k, v in g.items()}
        self.d = {k: v.detach().clone() for k, v in d.items()}
        self.g_ema = {k: v.clone() for k, v in self.g.items()}
        self.g_opt = Adam(self.g, t['beta1'], t['beta2'])
        self.d_opt = Adam(self.d, t['beta1'], t['beta2'])
        self.first_grads = self.first_fake = None

    @staticmethod
    def _grads(loss, params):
        live = {k: v for k, v in params.items() if v.requires_grad}
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
        return {k: g for k, g in zip(live, grads) if g is not None}

    def step(self, raw, draws, epoch):
        cfg, t, q = self.cfg, self.cfg['training'], self.precision
        phase, alpha = self.traffic['phase'], alpha_at(self.traffic, epoch)
        # the lr as the program holds it: float32
        lr = float(torch.tensor(t['lr0'], dtype=torch.float32))
        images = mirror(raw, (draws['augment'] or {}).get('flip'),
                        resolution(cfg['model'], phase), t['crop_size'],
                        t['augment'])

        def G(z):
            return generator(self.g, z, phase, cfg, alpha, q)

        def D(x):
            return critic(self.d, x, phase, cfg, alpha, q)

        for v in self.d.values():
            v.requires_grad_(True)
        for z1, z2, eps in draws['critic'][:t['n_critic']]:
            with torch.no_grad():
                fake = G(z1)
            if self.first_fake is None:
                self.first_fake = fake.clone()
            sr, sf = D(images), D(fake)
            score_real, score_fake = sr.mean(), sf.mean()
            d_loss = -score_real + score_fake
            d_loss = d_loss + t['drift_epsilon'] * torch.mean(sr * sr)
            if z2 is not z1:
                with torch.no_grad():
                    fake = G(z2)
            e = eps.reshape(-1, 1, 1, 1)
            x_hat = (e * images + (1.0 - e) * fake).detach().requires_grad_()
            grad, = torch.autograd.grad(D(x_hat).sum(), x_hat,
                                        create_graph=True)
            norms = torch.sqrt(torch.sum(grad * grad, dim=(1, 2, 3)))
            gp = t['gp_lambda'] * torch.mean((norms - 1.0) ** 2)
            d_loss = d_loss + gp
            grads = self._grads(d_loss, self.d)
            if self.first_grads is None:
                self.first_grads = {'d': {k: g.detach() for k, g in grads.items()}}
            self.d_opt.step(grads, lr)
        for v in self.d.values():
            v.requires_grad_(False)
        for v in self.g.values():
            v.requires_grad_(True)
        g_loss = -D(G(draws['zg'])).mean()
        grads = self._grads(g_loss, self.g)
        if 'g' not in self.first_grads:
            self.first_grads['g'] = {k: g.detach() for k, g in grads.items()}
        self.g_opt.step(grads, lr)
        for v in self.g.values():
            v.requires_grad_(False)
        beta = t['ema_beta']
        with torch.no_grad():
            for k, v in self.g.items():
                self.g_ema[k].mul_(beta).add_(v, alpha=1.0 - beta)
        zero = torch.zeros((), device=raw.device)
        return torch.stack([score_real, score_fake, d_loss, g_loss, gp,
                            zero]).detach()


# --------------------------------------------------------------------------
# Inputs and draws
# --------------------------------------------------------------------------

def latent(gen, n, cfg):
    return ref_draws.latent(gen, n, cfg['model']['latent_dim'])


def train_inputs(cfg, traffic, seed, device):
    """(G weights, D weights, stack) from ``seed``, made on ``device``: the
    stack (n_images, frame, frame, colours) uniform in [0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    g_w, d_w = make_weights(cfg, gen)
    p = traffic['frame']
    stack = torch.rand((traffic['n_images'], p, p, cfg['model']['n_colors']),
                       generator=gen, device=device)
    return g_w, d_w, stack


def batch_draws(gen, b, cfg):
    """One batch step's draws in the port's order: for each critic step z1,
    z2 (unless the penalty takes the critic loss's fakes), eps; then the
    flips; then zg."""
    t, dim = cfg['training'], cfg['model']['latent_dim']
    critic_draws = []
    for _ in range(max(t['n_critic'], 1)):
        z1 = ref_draws.latent(gen, b, dim)
        z2 = (z1 if cfg['execution']['gp_reuse_fakes']
              else ref_draws.latent(gen, b, dim))
        eps = torch.rand(b, generator=gen, device=gen.device)
        critic_draws.append((z1, z2, eps))
    flips = None
    if t['augment']:
        flips = {'flip': ref_draws._uniform(gen, b, 0.0, 1.0) < 0.5}
    return {'critic': critic_draws, 'augment': flips,
            'zg': ref_draws.latent(gen, b, dim)}


def reference_steps(cfg, traffic, seed, device, n):
    """The first ``n`` batch steps: each epoch's permutation, then each
    batch's draws."""
    gen = torch.Generator(device=device).manual_seed(seed)
    batch, out = cfg['training']['batch_size'], []
    while len(out) < n:
        order = torch.randperm(traffic['n_images'], generator=gen,
                               device=gen.device)
        for start in range(0, traffic['n_images'], batch):
            rows = order[start:start + batch]
            out.append((rows, batch_draws(gen, rows.shape[0], cfg)))
    return out[:n]


@contextlib.contextmanager
def augment_look(cfg, traffic):
    """Records the program's first augmentation call while open; on close,
    the dict it yields gets the pixels where the reference's augmentation
    of that batch and draws differs from the program's, and the largest
    gap."""
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
    t = cfg['training']
    with torch.no_grad():
        ref = mirror(raw, (draws or {}).get('flip'),
                     resolution(cfg['model'], traffic['phase']),
                     t['crop_size'], t['augment'])
    gap = (out.float() - ref).abs()
    look.update(pixels=int((gap > 0).sum()), max=float(gap.max()))


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
        packed_lanes=ex['packed_lanes'], architecture='karras')


def port_nets(cfg, g_w, d_w, device):
    """The port's G (and D when ``d_w``) holding the benchmark's weights."""
    from neuron_gan_tpu_torch.models import (
        DiscriminatorKarras, GeneratorKarras)
    pg = port_config(cfg)
    host = torch.Generator().manual_seed(0)
    g = GeneratorKarras(pg, host, device=device)
    g.load_state_dict(g_w)
    if d_w is None:
        return pg, g, None
    d = DiscriminatorKarras(pg, host, device=device)
    d.load_state_dict(d_w)
    return pg, g, d


def port_train(cfg, traffic, g, d):
    from neuron_gan_tpu_torch.train_step import ChunkSpec, init_train_state
    t, ex = cfg['training'], cfg['execution']
    spec = ChunkSpec(
        phase=traffic['phase'], fading=traffic['fading'],
        n_critic=t['n_critic'], batch_size=t['batch_size'],
        n_images=traffic['n_images'], shuffle=True,
        crop_size=t['crop_size'], translation=0.0, augment=t['augment'],
        gp_lambda=t['gp_lambda'], drift_epsilon=t['drift_epsilon'],
        sim_lambda0=0.0, sim_decay=0.0, beta1=t['beta1'], rmsprop=False,
        lr0=t['lr0'], lr_gamma=1.0, lr_boundary=0, lr_cap=0,
        alpha_start=traffic.get('alpha_start', 0),
        alpha_step=traffic.get('alpha_step', 1e-4),
        latent_dim=cfg['model']['latent_dim'], ema_beta=t['ema_beta'],
        gp_reuse_fakes=ex['gp_reuse_fakes'], beta2=t['beta2'],
        mirror_augment=t['mirror_augment'])
    state = init_train_state(g, d, beta1=t['beta1'], ema_beta=t['ema_beta'],
                             beta2=t['beta2'])
    return spec, state, t['beta1']


# --------------------------------------------------------------------------
# Counts
# --------------------------------------------------------------------------

def g_layers(model, phase, fading=False):
    """[(name, MACs per image)] of G's dense and conv layers at ``phase``
    (no bias)."""
    fg, init, c = model['n_gen_features'], model['image_size_init'], model['n_colors']
    out = [('linear', model['latent_dim'] * fg[0] * init * init),
           ('stem', fg[0] * fg[0] * 9 * init * init)]
    for i in range(phase):
        r = resolution(model, i + 1)
        out += [(f'b{i}.conv1', fg[i] * fg[i + 1] * 9 * r * r),
                (f'b{i}.conv2', fg[i + 1] * fg[i + 1] * 9 * r * r)]
    r = resolution(model, phase)
    out.append(('to_rgb', fg[phase] * c * r * r))
    if fading:
        rp = resolution(model, phase - 1)
        out.append(('to_rgb_prev', fg[phase - 1] * c * rp * rp))
    return out


def d_layers(model, phase, fading=False):
    """[(name, MACs per image)] of D's conv and dense layers at ``phase``:
    the first is from_rgb, the last the score layer."""
    fd, init, c = model['n_dis_features'], model['image_size_init'], model['n_colors']
    n, r = len(fd), resolution(model, phase)
    first = n - 1 - phase
    out = [('from_rgb', c * fd[first] * r * r)]
    if fading:
        out.append(('from_rgb_prev', c * fd[first + 1] * (r // 2) ** 2))
    for i in range(first, n - 1):
        out += [(f'b{i}.conv1', fd[i] * fd[i] * 9 * r * r),
                (f'b{i}.conv2', fd[i] * fd[i + 1] * 9 * r * r)]
        r //= 2
    f = fd[-1]
    out += [('head', (f + 1) * f * 9 * init * init),
            ('dense0', f * init * init * f), ('score', f)]
    return out


def g_forward_flops(cfg, phase, batch):
    return 2 * batch * sum(m for _, m in g_layers(cfg['model'], phase))


def train_step_flops(cfg, traffic):
    """Model FLOPs of one WGAN-GP batch step, counted as benchmark/flops.py
    counts them (its docstring), with one difference in the penalty's
    outer pass: with no PixelNorm in D, the inner gradient depends on D's
    forward activations only through the minibatch stddev (LeakyReLU's
    slope is piecewise constant), so the pass back through D's forward on
    x_hat reaches only the layers below it: weights F_D - f_post - f_out,
    inputs F_D - f_post - f_out - f_in, where f_post are the head's conv
    and dense layer; and the pass back through the inner one makes no
    forward product of the score layer's incoming gradient (the constant
    seed).  Total: (n_G + 3) F_G - f_lin + 14 F_D - 3 f_in - 3 f_out -
    2 f_post, with F_G, F_D the forwards, f_in D's from_rgb (both in a
    fade), f_out its score layer, f_lin G's dense stem layer.  The CPU
    test holds it against torch's FlopCounterMode over the reference's
    step."""
    model, batch = cfg['model'], cfg['training']['batch_size']
    fading = traffic['fading']
    gl = dict(g_layers(model, traffic['phase'], fading))
    dl = d_layers(model, traffic['phase'], fading)
    f_g = 2 * batch * sum(gl.values())
    f_d = 2 * batch * sum(m for _, m in dl)
    f_in = 2 * batch * sum(m for k, m in dl if k.startswith('from_rgb'))
    f_out = 2 * batch * dl[-1][1]
    f_post = 2 * batch * sum(m for k, m in dl if k in ('head', 'dense0'))
    f_lin = 2 * batch * gl['linear']
    n_g = 1 if cfg['execution']['gp_reuse_fakes'] else 2
    return ((n_g + 3) * f_g - f_lin + 14 * f_d - 3 * f_in - 3 * f_out
            - 2 * f_post)


def kernel_sites(cfg, traffic):
    """{(kernel, x's shape, groups): launches} of one step: G's LReLU +
    PixelNorm pairs, two a level (the stem's at init^2 included), K1 in
    each G forward (the critic's fakes, the generator update's; and the
    penalty's fresh fakes where it takes them), K2 in its backward; at a
    width of 256 or 512 the wide instances ('k1_wide', 'k2_wide').  D has
    no PixelNorm."""
    ex, model = cfg['execution'], cfg['model']
    if not ex['use_kernels']:
        return {}
    batch = cfg['training']['batch_size']
    fwd = 2 if ex['gp_reuse_fakes'] else 3
    out = {}
    for level in range(traffic['phase'] + 1):
        feat, r = model['n_gen_features'][level], resolution(model, level)
        wide = '_wide' if feat in WIDE else ''
        shape = (batch, feat, r, r)
        for kernel, n in (('k1', 2 * fwd), ('k2', 2)):
            key = (kernel + wide, shape, 1)
            out[key] = out.get(key, 0) + n
    return out
