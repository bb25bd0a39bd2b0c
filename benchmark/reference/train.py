"""Plain PyTorch WGAN-GP training steps: the benchmark's reference.

One step on one raw batch, as the reference trainer (train.py,
loss_functions.py) defines it: augment the batch; ``n_critic`` critic
updates, each on the Wasserstein loss -<D(x)> + <D(G(z1))>, the drift
eps * <D(x)^2> and the gradient penalty lambda * <(||dD/dx_hat|| - 1)^2>
on x_hat = e x + (1 - e) G(z2) (z2 = z1 when the penalty reuses the critic
loss's fakes), the norm over (C, H, W); then one generator update on
-<D(G(zg))>.  Each update is Adam (beta1, 0.999, eps 1e-8) with the bias
corrections.  Stats are (score_real, score_fake, D_loss, G_loss, GP, 0).

The learning rate of epoch e is lr0 * gamma^min(e - 1, cap) in float32;
alpha, for a fading phase, clip((e - alpha_start) * alpha_step, 0, 1).
"""

import numpy as np
import torch

from benchmark.reference import augment as aug
from benchmark.reference import model as net


def lr_at(training, epoch):
    steps = np.float32(min(epoch - 1, training['lr_cap']))
    return float(np.float32(training['lr0'])
                 * np.power(np.float32(training['lr_gamma']), steps))


def alpha_at(traffic, epoch):
    if not traffic.get('fading'):
        return None
    a = (np.float32(epoch - traffic.get('alpha_start', 0))
         * np.float32(traffic['alpha_step']))
    return float(np.clip(a, np.float32(0.0), np.float32(1.0)))


class Adam:
    """Adam over a dict of tensors, updated in place."""

    def __init__(self, params, beta1, beta2=0.999, eps=1e-8):
        self.params, self.b1, self.b2, self.eps = params, beta1, beta2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads, lr):
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                m = self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                v = self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                denom = (v.sqrt() / c2 ** 0.5).add_(self.eps)
                self.params[k].addcdiv_(m, denom, value=-lr / c1)


class Trainer:
    """The reference's G, D and their Adam states from a copy of the
    initial weights; ``step`` runs one batch step.  ``precision`` rounds
    the products' operands (model.quantize): the lower-precision control."""

    def __init__(self, g, d, config, traffic, precision='float32'):
        self.model, self.training = config['model'], config['training']
        self.execution, self.traffic = config['execution'], traffic
        self.g = {k: v.detach().clone() for k, v in g.items()}
        self.d = {k: v.detach().clone() for k, v in d.items()}
        beta1 = self.training['beta1']
        self.g_opt, self.d_opt = Adam(self.g, beta1), Adam(self.d, beta1)
        self.precision = precision
        self.first_grads = self.first_fake = None

    def _grads(self, loss, params):
        """Gradients of the parameters the loss reaches (others stay put
        under Adam: a zero gradient moves nothing)."""
        live = {k: v for k, v in params.items() if v.requires_grad}
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
        return {k: g for k, g in zip(live, grads) if g is not None}

    def step(self, raw, draws, epoch):
        phase, m, q = self.traffic['phase'], self.model, self.precision
        t, ex = self.training, self.execution
        alpha, lr = alpha_at(self.traffic, epoch), lr_at(t, epoch)
        res = net.resolution(m, phase)
        images = aug.augment(raw, draws['augment'], res, t['crop_size'],
                             augment=t['augment'], fast=ex['fast_augment'],
                             shear=aug.shear_for(ex, res))

        def G(z):
            return net.generator(self.g, z, phase, m, alpha, q)

        def D(x):
            return net.critic(self.d, x, phase, m, alpha, q)

        for p in self.d.values():
            p.requires_grad_(True)
        for (z1, z2, eps) in draws['critic'][:t['n_critic']]:
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
        for p in self.d.values():
            p.requires_grad_(False)
        for p in self.g.values():
            p.requires_grad_(True)
        g_loss = -D(G(draws['zg'])).mean()
        grads = self._grads(g_loss, self.g)
        if 'g' not in self.first_grads:
            self.first_grads['g'] = {k: g.detach() for k, g in grads.items()}
        self.g_opt.step(grads, lr)
        for p in self.g.values():
            p.requires_grad_(False)
        zero = torch.zeros((), device=raw.device)
        return torch.stack([score_real, score_fake, d_loss, g_loss, gp,
                            zero]).detach()

