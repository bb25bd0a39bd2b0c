"""Parameters between the JAX package's pytree and the port's modules.

The JAX pytree is nested dicts and lists of numpy arrays: conv weights HWIO,
linear weights (in, out), leaves named ``w`` and ``b``.  The port's module
parameters carry the same paths (``blocks.0.conv1.weight`` is
``tree['blocks'][0]['conv1']['w']``) with conv weights OIHW and linear
weights (out, in).  Checkpoints of either package therefore load in the
other.

The train state crosses the same way (``to_jax_state`` /
``load_jax_state``): ``{g_params, d_params, g_opt, d_opt[, g_ema]}`` with
torch.optim's Adam state as optax's ``ScaleByAdamState(count, mu, nu)``
(``step`` <-> ``count``, ``exp_avg`` <-> ``mu``, ``exp_avg_sq`` <-> ``nu``,
the moments in the weights' layout) and RMSprop's as the JAX package's
``{'nu': ...}`` (``square_avg``).
"""

from typing import NamedTuple

import numpy as np
import torch

_LEAF_TO_JAX = {'weight': 'w', 'bias': 'b'}


def _to_jax_layout(t: np.ndarray):
    if t.ndim == 4:
        return np.ascontiguousarray(t.transpose(2, 3, 1, 0))   # OIHW -> HWIO
    if t.ndim == 2:
        return np.ascontiguousarray(t.T)                       # (out, in) -> (in, out)
    return t


def _from_jax_layout(a: np.ndarray):
    if a.ndim == 4:
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1))   # HWIO -> OIHW
    if a.ndim == 2:
        return np.ascontiguousarray(a.T)
    return a


def _path(name):
    *parents, leaf = name.split('.')
    keys = [int(p) if p.isdigit() else p for p in parents]
    return keys + [_LEAF_TO_JAX[leaf]]


def _numpy(t):
    """A float32 copy of ``t`` on the host (never a view of a CPU tensor,
    which training goes on to update in place)."""
    return t.detach().to('cpu', torch.float32, copy=True).numpy()


def _tree_of(named):
    """A JAX-layout pytree from (parameter name, numpy array) pairs."""
    tree = {}
    for name, value in named:
        keys = _path(name)
        node = tree
        for k, nxt in zip(keys[:-1], keys[1:]):
            if isinstance(node, list):
                while len(node) <= k:
                    node.append(None)
                if node[k] is None:
                    node[k] = [] if isinstance(nxt, int) else {}
                node = node[k]
            else:
                node = node.setdefault(k, [] if isinstance(nxt, int) else {})
        node[keys[-1]] = _to_jax_layout(value)
    return tree


def to_jax_tree(module: torch.nn.Module):
    """The module's parameters as a JAX-layout pytree of numpy arrays."""
    return _tree_of((name, _numpy(p)) for name, p in module.named_parameters())


def _leaf(tree, name):
    node = tree
    for k in _path(name):
        node = node[k]
    return torch.from_numpy(np.array(_from_jax_layout(np.asarray(node))))


def load_jax_tree(module: torch.nn.Module, tree):
    """Copy a JAX-layout pytree into the module's parameters, in place.
    Every parameter must be present with the matching shape."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            value = _leaf(tree, name)
            if value.shape != p.shape:
                raise ValueError(f'{name}: shape {tuple(value.shape)} does '
                                 f'not match {tuple(p.shape)}')
            p.copy_(value.to(p.dtype))
    return module


class ScaleByAdamState(NamedTuple):
    """optax's Adam state, as the JAX package's checkpoints hold it."""
    count: np.ndarray
    mu: dict
    nu: dict


# the class a checkpoint's tree spec names for it (the JAX package's
# checkpoint.py records namedtuples by module and qualified name)
ScaleByAdamState.spec_module = 'optax._src.transform'
ScaleByAdamState.spec_name = 'ScaleByAdamState'


def _scalar_dtype():
    # torch.optim's dtype for 'step' (its _get_scalar_dtype)
    return (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)


def _opt_tree(module, opt):
    named = list(module.named_parameters())
    states = [opt.state.get(p, {}) for _, p in named]

    def moment(key):
        return _tree_of((name, _numpy(s[key]) if key in s
                         else np.zeros(p.shape, np.float32))
                        for (name, p), s in zip(named, states))

    if isinstance(opt, torch.optim.RMSprop):
        return {'nu': moment('square_avg')}
    steps = {int(s['step']) for s in states if 'step' in s}
    if len(steps) > 1:
        raise ValueError(f'Adam steps differ across parameters: {steps}')
    count = np.asarray(steps.pop() if steps else 0, np.int32)
    return ScaleByAdamState(count, moment('exp_avg'), moment('exp_avg_sq'))


def _load_opt(module, opt, tree):
    for name, p in module.named_parameters():
        if isinstance(opt, torch.optim.RMSprop):
            # torch's RMSprop counts steps but no update reads the count
            opt.state[p] = {'step': torch.zeros((), dtype=_scalar_dtype()),
                            'square_avg': _leaf(tree['nu'], name).to(p)}
        else:
            count, mu, nu = tree
            opt.state[p] = {
                'step': torch.tensor(float(np.asarray(count)),
                                     dtype=_scalar_dtype()),
                'exp_avg': _leaf(mu, name).to(p),
                'exp_avg_sq': _leaf(nu, name).to(p)}


def to_jax_state(state):
    """The train state (train_step.TrainState) as the JAX package's train
    state pytree of numpy arrays."""
    tree = {'g_params': to_jax_tree(state.g), 'd_params': to_jax_tree(state.d),
            'g_opt': _opt_tree(state.g, state.g_opt),
            'd_opt': _opt_tree(state.d, state.d_opt)}
    if state.g_ema is not None:
        tree['g_ema'] = to_jax_tree(state.g_ema)
    return tree


def load_jax_state(state, tree):
    """Restore ``state`` in place from a JAX-layout train-state pytree,
    tolerantly (checkpoint.merge_state_tolerant): every leaf whose path and
    shape match is restored, everything else keeps its value.  Returns the
    merge report."""
    from neuron_gan_tpu_torch.checkpoint import merge_state_tolerant
    merged, report = merge_state_tolerant(to_jax_state(state), tree)
    load_jax_tree(state.g, merged['g_params'])
    load_jax_tree(state.d, merged['d_params'])
    _load_opt(state.g, state.g_opt, merged['g_opt'])
    _load_opt(state.d, state.d_opt, merged['d_opt'])
    if state.g_ema is not None:
        load_jax_tree(state.g_ema, merged['g_ema'])
    return report
