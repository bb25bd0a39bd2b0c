"""Karras et al.'s PGGAN in plain PyTorch, float32: the CPU tests' reference
for the port's ``architecture='karras'``.

Written from github.com/tkarras/progressive_growing_of_gans (networks.py
``G_paper``, ``D_paper``, ``minibatch_stddev_layer``; loss.py
``D_wgangp_acgan``, ``G_wgan_acgan``; train.py's Adam and ``Gs``), NCHW,
with ``torch.nn.functional`` ops only, TF32 off (``exact``).  It imports
nothing of the port or of JAX.  Parameters are a flat dict of tensors
under the port's names (``stem.linear.weight``, ``blocks.{i}.conv1.bias``,
``head.dense0.weight``, ...), so one set of weights feeds both.

Departures from the TensorFlow code, each the port's too:

* the second conv of a D level and its pool are unfused: conv, bias,
  LeakyReLU, then the 2x2 average pool (``fused_scale`` pools inside the
  conv and applies the bias and LeakyReLU after it); G's nearest upsample
  and conv are unfused as well (the same map as ``upscale2d_conv2d``);
* the latents are the port's draws: normals clamped to [-5, 5], each row
  divided by its norm; G's latent PixelNorm makes them what a normal
  latent gives, up to the clamp and eps;
* the penalty's interpolate is eps * real + (1 - eps) * fake (loss.py's
  lerp(real, fake, t) with t = 1 - eps: the same distribution), on the
  critic loss's own fakes, as loss.py;
* Adam is torch's (eps added to sqrt(v) / sqrt(1 - beta2^t)), not
  TensorFlow's (eps added to sqrt(v) with the bias correction in the lr);
* LeakyReLU is where(x >= 0, x, 0.2 x) (its gradient at 0 is 1).
"""

import math

import torch
import torch.nn.functional as F

GAIN = math.sqrt(2.0)
SLOPE = 0.2


class exact:
    """TF32 off for the reference's products."""

    def __enter__(self):
        self.old = (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.old


def nf(stage, fmap_base=8192, fmap_max=512):
    return min(int(fmap_base / 2.0 ** stage), fmap_max)


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

def conv(x, p, name, gain=GAIN):
    w = p[name + '.weight']
    scale = gain / math.sqrt(w[0].numel())
    return F.conv2d(x, w * scale, p[name + '.bias'], padding=w.shape[-1] // 2)


def dense(x, p, name, gain=GAIN):
    w = p[name + '.weight']
    x = x.reshape(x.shape[0], -1)
    return x @ (w * (gain / math.sqrt(w.shape[1]))).t() + p[name + '.bias']


def lrelu(x):
    return torch.where(x >= 0, x, x * SLOPE)


def pixel_norm(x):
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-8)


def upscale2d(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def downscale2d(x):
    return F.avg_pool2d(x, 2)


def minibatch_stddev(x, group_size=4):
    """networks.py::minibatch_stddev_layer: groups are x.reshape(G, M, ...),
    so sample n belongs to group n mod M."""
    g = min(group_size, x.shape[0])
    s = x.shape
    y = x.reshape(g, -1, s[1], s[2], s[3])
    y = y - y.mean(dim=0, keepdim=True)
    y = (y ** 2).mean(dim=0)
    y = torch.sqrt(y + 1e-8)
    y = y.mean(dim=(1, 2, 3), keepdim=True)             # (M, 1, 1, 1)
    y = y.repeat(g, 1, s[2], s[3])                      # (N, 1, H, W)
    return torch.cat([x, y], dim=1)


def lerp(a, b, t):
    return a + (b - a) * t


# --------------------------------------------------------------------------
# Networks
# --------------------------------------------------------------------------

def param_shapes(model):
    """{name: shape} of G's and D's parameters for ``model`` (n_gen_features,
    n_dis_features, latent_dim, image_size_init, n_colors)."""
    fg, fd = model['n_gen_features'], model['n_dis_features']
    init, c, lat = model['image_size_init'], model['n_colors'], model['latent_dim']
    g, d = {}, {}

    def layer(net, name, w):
        net[name + '.weight'] = w
        net[name + '.bias'] = (w[0],)

    layer(g, 'stem.linear', (fg[0] * init * init, lat))
    layer(g, 'stem.conv', (fg[0], fg[0], 3, 3))
    for i in range(len(fg) - 1):
        layer(g, f'blocks.{i}.conv1', (fg[i + 1], fg[i], 3, 3))
        layer(g, f'blocks.{i}.conv2', (fg[i + 1], fg[i + 1], 3, 3))
    for i in range(len(fg)):
        layer(g, f'to_rgb.{i}', (c, fg[i], 1, 1))
    for i in range(len(fd)):
        layer(d, f'from_rgb.{i}', (fd[i], c, 1, 1))
    for i in range(len(fd) - 1):
        layer(d, f'blocks.{i}.conv1', (fd[i], fd[i], 3, 3))
        layer(d, f'blocks.{i}.conv2', (fd[i + 1], fd[i], 3, 3))
    layer(d, 'head.conv', (fd[-1], fd[-1] + 1, 3, 3))
    layer(d, 'head.dense0', (fd[-1], fd[-1] * init * init))
    layer(d, 'head.dense1', (1, fd[-1]))
    return g, d


def generator(p, z, phase, model, alpha=None):
    """G_paper: latents (B, latent) -> images (B, C, R, R) at ``phase``."""
    f0, init = model['n_gen_features'][0], model['image_size_init']
    x = dense(pixel_norm(z), p, 'stem.linear', gain=GAIN / 4)
    x = pixel_norm(lrelu(x.reshape(-1, f0, init, init)))
    x = pixel_norm(lrelu(conv(x, p, 'stem.conv')))

    def block(x, i):
        x = upscale2d(x)
        x = pixel_norm(lrelu(conv(x, p, f'blocks.{i}.conv1')))
        return pixel_norm(lrelu(conv(x, p, f'blocks.{i}.conv2')))

    def torgb(x, i):
        return conv(x, p, f'to_rgb.{i}', gain=1.0)

    if alpha is None:
        for i in range(phase):
            x = block(x, i)
        return torgb(x, phase)
    for i in range(phase - 1):
        x = block(x, i)
    # the 'linear' structure: the lower level's image, upscaled, blended
    # into the new level's by alpha
    low = upscale2d(torgb(x, phase - 1))
    return lerp(low, torgb(block(x, phase - 1), phase), alpha)


def critic(p, x, phase, model, alpha=None):
    """D_paper: images (B, C, R, R) at ``phase`` -> scores (B, 1)."""
    n = len(model['n_dis_features'])

    def fromrgb(x, i):
        return lrelu(conv(x, p, f'from_rgb.{i}'))

    def block(y, i):
        y = lrelu(conv(y, p, f'blocks.{i}.conv1'))
        y = lrelu(conv(y, p, f'blocks.{i}.conv2'))
        return downscale2d(y)

    first = n - 1 - phase
    y = fromrgb(x, first)
    if alpha is not None:
        y = lerp(fromrgb(downscale2d(x), first + 1), block(y, first), alpha)
        first += 1
    for i in range(first, n - 1):
        y = block(y, i)
    y = minibatch_stddev(y, 4)
    y = lrelu(conv(y, p, 'head.conv'))
    y = lrelu(dense(y, p, 'head.dense0'))
    return dense(y, p, 'head.dense1', gain=1.0)


# --------------------------------------------------------------------------
# Draws, augmentation, training
# --------------------------------------------------------------------------

def latent(gen, b, dim):
    z = torch.clamp(torch.randn((b, dim), generator=gen, device=gen.device),
                    -5.0, 5.0)
    return z / torch.linalg.norm(z, ord=2, dim=1, keepdim=True)


def batch_draws(gen, b, latent_dim):
    """One batch step's draws in the port's order, the penalty on the
    critic loss's fakes: z1, eps, the flips, then zg."""
    z1 = latent(gen, b, latent_dim)
    eps = torch.rand(b, generator=gen, device=gen.device)
    flip = torch.rand(b, generator=gen, device=gen.device) < 0.5
    return {'z': z1, 'eps': eps, 'flip': flip, 'zg': latent(gen, b, latent_dim)}


def epoch_steps(gen, n_images, batch, latent_dim):
    """One epoch's (rows, draws), the permutation first."""
    order = torch.randperm(n_images, generator=gen, device=gen.device)
    return [(order[s:s + batch], batch_draws(gen, len(order[s:s + batch]),
                                             latent_dim))
            for s in range(0, n_images, batch)]


def mirror(raw, flip):
    """raw (B, P, P, C) in [0, 1], flipped left-right where ``flip`` ->
    (B, C, P, P) in [-1, 1] (train.py's mirror_augment, no resize)."""
    x = raw.permute(0, 3, 1, 2)
    x = torch.where(flip[:, None, None, None], torch.flip(x, dims=(3,)), x)
    return x * 2.0 - 1.0


class Adam:
    """torch's Adam over a dict of tensors, updated in place."""

    def __init__(self, params, beta1=0.0, beta2=0.99, eps=1e-8):
        self.params, self.b1, self.b2, self.eps = params, beta1, beta2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads, lr):
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                m = self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                v = self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                denom = (v.sqrt() / math.sqrt(c2)).add_(self.eps)
                self.params[k].addcdiv_(m, denom, value=-lr / c1)


def d_loss(pd, pg, images, d, phase, model, alpha, gp_lambda=10.0,
           drift=0.001, target=1.0):
    """D_wgangp_acgan, its mean over the batch: D(fake) - D(real), the
    penalty on the interpolates of the reals and the same fakes, and the
    drift."""
    with torch.no_grad():
        fake = generator(pg, d['z'], phase, model, alpha)
    real_scores = critic(pd, images, phase, model, alpha)
    fake_scores = critic(pd, fake, phase, model, alpha)
    e = d['eps'].reshape(-1, 1, 1, 1)
    mixed = (e * images + (1.0 - e) * fake).requires_grad_()
    grad, = torch.autograd.grad(critic(pd, mixed, phase, model, alpha).sum(),
                                mixed, create_graph=True)
    norms = torch.sqrt(torch.sum(grad ** 2, dim=(1, 2, 3)))
    gp = (norms - target) ** 2 * (gp_lambda / target ** 2)
    loss = fake_scores - real_scores + gp[:, None] + drift * real_scores ** 2
    return loss.mean(), gp.mean()


def g_loss(pd, pg, d, phase, model, alpha):
    """G_wgan_acgan: -D(G(z)), its mean."""
    return -critic(pd, generator(pg, d['zg'], phase, model, alpha), phase,
                   model, alpha).mean()


def _zero_unused(params, grads):
    """{name: gradient}, zeros where the phase does not reach the
    parameter (the port steps every parameter; a zero gradient moves
    nothing under Adam)."""
    return {k: torch.zeros_like(params[k]) if g is None else g
            for k, g in zip(params, grads)}


class Trainer:
    """G, D, their Adams and G's EMA (Gs = lerp(G, Gs, beta)) from a copy
    of the weights; ``step`` is one D update then one G update."""

    def __init__(self, g, d, model, beta2=0.99, ema=0.999):
        self.model = model
        self.g = {k: v.detach().clone() for k, v in g.items()}
        self.d = {k: v.detach().clone() for k, v in d.items()}
        self.g_ema = {k: v.clone() for k, v in self.g.items()}
        self.g_opt = Adam(self.g, 0.0, beta2)
        self.d_opt = Adam(self.d, 0.0, beta2)
        self.ema = ema

    def step(self, raw, draws, lr, phase, alpha=None):
        images = mirror(raw, draws['flip'])
        pd = {k: v.requires_grad_() for k, v in self.d.items()}
        loss, gp = d_loss(pd, self.g, images, draws, phase, self.model, alpha)
        grads = torch.autograd.grad(loss, list(pd.values()), allow_unused=True)
        for v in pd.values():
            v.requires_grad_(False)
        self.d_opt.step(_zero_unused(pd, grads), lr)
        pg = {k: v.requires_grad_() for k, v in self.g.items()}
        gl = g_loss(self.d, pg, draws, phase, self.model, alpha)
        grads = torch.autograd.grad(gl, list(pg.values()), allow_unused=True)
        for v in pg.values():
            v.requires_grad_(False)
        self.g_opt.step(_zero_unused(pg, grads), lr)
        with torch.no_grad():
            for k, v in self.g.items():
                self.g_ema[k].copy_(lerp(v, self.g_ema[k], self.ema))
        return loss.detach(), gl.detach(), gp.detach()
