"""Model FLOPs of a configuration, from its shapes alone.

A forward counts 2 * MAC of every convolution and dense layer (no
elementwise op, no pooling or resampling).  The passes are those of the
algorithm as the configuration states it, counted layer by layer for the
gradients each pass computes: a weight gradient and an input gradient
each cost one forward of their layer, and a pass computes only those its
outputs need.  Work a program adds (recomputation) or saves (a fused
boundary that convolves at half resolution) does not change the count.

One WGAN-GP batch step (one critic update, one generator update), with
F_G and F_D the forwards of G and D at the step's phase, f_in D's first
layer (from_rgb, whose input needs no gradient except in the penalty's
inner pass and the generator update), f_out D's last (the head's score
conv, whose forward output the penalty's outer pass never reaches) and
f_lin G's dense stem layer (whose input, z, needs no gradient):

  G forwards without gradient for the critic: 1, or 2 when the penalty
    takes fresh fakes (z2)                                   n_G * F_G
  D on the real and the fake batch                           2 F_D
  their backward to D's weights: weights 2 F_D, inputs
    2 (F_D - f_in)                                           4 F_D - 2 f_in
  the penalty: D on x_hat                                    F_D
    its inner gradient dD/dx_hat (input gradients only)      F_D
    the outer pass back through the inner one: per layer a
      forward conv of the incoming gradient and a weight
      gradient                                               2 F_D
    and back through D's forward on x_hat, its score conv
      omitted: weights F_D - f_out, inputs F_D - f_out - f_in 2 F_D - 2 f_out - f_in
  the generator update: G forward F_G, D on its images F_D,
    D's input gradients F_D, G's weights F_G and inputs
    F_G - f_lin                                              3 F_G + 2 F_D - f_lin

Total: (n_G + 3) F_G - f_lin + 14 F_D - 3 f_in - 2 f_out.  The CPU test
holds it against torch's FlopCounterMode over the reference's step.
"""


def _res(model, phase):
    return model['image_size_init'] * 2 ** phase


def g_layers(model, phase, fading=False):
    """[(name, MACs per image)] of G's dense and conv layers at ``phase``."""
    fg, init, c = model['n_gen_features'], model['image_size_init'], model['n_colors']
    out = [('linear', model['latent_dim'] * fg[0] * init * init),
           ('stem', fg[0] * fg[0] * 9 * init * init)]
    for i in range(phase):
        r = _res(model, i + 1)
        out += [(f'b{i}.conv1', fg[i] * fg[i + 1] * 9 * r * r),
                (f'b{i}.conv2', fg[i + 1] * fg[i + 1] * 9 * r * r)]
    r = _res(model, phase)
    out.append(('to_rgb', fg[phase] * c * r * r))
    if fading:
        rp = _res(model, phase - 1)
        out.append(('to_rgb_prev', fg[phase - 1] * c * rp * rp))
    return out


def d_layers(model, phase, fading=False):
    """[(name, MACs per image)] of D's conv layers at ``phase``: the first
    is from_rgb, the last the score conv."""
    fd, init, c = model['n_dis_features'], model['image_size_init'], model['n_colors']
    n = len(fd)
    r = _res(model, phase)
    out = [('from_rgb', c * fd[n - 1 - phase] * r * r)]
    if fading:
        out.append(('from_rgb_prev', c * fd[n - phase] * (r // 2) ** 2))
    for i in range(n - 1 - phase, n - 1):
        r //= 2
        out += [(f'b{i}.conv1', fd[i] * fd[i + 1] * 9 * r * r),
                (f'b{i}.conv2', fd[i + 1] * fd[i + 1] * 9 * r * r)]
    out += [('head', fd[-1] * fd[-1] * 9 * init * init),
            ('score', fd[-1] * init * init)]
    return out


def g_forward(model, phase, batch, fading=False):
    return 2 * batch * sum(m for _, m in g_layers(model, phase, fading))


def train_step(model, phase, batch, reuse_fakes, fading=False):
    """Model FLOPs of one WGAN-GP batch step (the module docstring)."""
    gl = dict(g_layers(model, phase, fading))
    dl = d_layers(model, phase, fading)
    F_G = 2 * batch * sum(gl.values())
    F_D = 2 * batch * sum(m for _, m in dl)
    f_in = 2 * batch * sum(m for k, m in dl if k.startswith('from_rgb'))
    f_out = 2 * batch * dl[-1][1]
    f_lin = 2 * batch * gl['linear']
    n_g = 1 if reuse_fakes else 2
    return (n_g + 3) * F_G - f_lin + 14 * F_D - 3 * f_in - 2 * f_out
