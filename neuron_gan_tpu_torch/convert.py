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

The legacy WGAN/DCGAN nets (models/legacy.py) cross as the JAX package's
``(params, bn_states)`` pair (``legacy_to_jax`` / ``load_legacy``): BN
scale/bias under ``bn`` in the params, running mean/var in ``bn_states``
under ``bn0``, ``stem`` or ``block{i}``; transposed-conv weights as the
JAX ``conv_transpose2d`` takes them, (kh, kw, in, out).  Their train state
(``to_jax_legacy_state`` / ``load_jax_legacy_state``) is the JAX legacy
trainer's ``{g_params, d_params, g_bn, d_bn, g_opt, d_opt}``.
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


def to_jax_tree(module):
    """The module's parameters as a JAX-layout pytree of numpy arrays; or,
    for (parameter name, tensor) pairs (a rank's slices under a model
    axis: ``parallel.NetShards.named_local``), those tensors."""
    named = (module.named_parameters() if isinstance(module, torch.nn.Module)
             else module)
    return _tree_of((name, _numpy(p)) for name, p in named)


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
    names = [name for name, _ in module.named_parameters()]
    return _opt_state(opt, [p for _, p in module.named_parameters()],
                      lambda arrays: _tree_of(zip(names, arrays)))


def _opt_state(opt, params, tree_of):
    """``opt``'s state of ``params`` as the JAX package's optimizer state;
    ``tree_of`` maps arrays in the parameters' order to a JAX-layout
    tree."""
    states = [opt.state.get(p, {}) for p in params]

    def moment(key):
        return tree_of([_numpy(s[key]) if key in s
                        else np.zeros(p.shape, np.float32)
                        for p, s in zip(params, states)])

    if isinstance(opt, torch.optim.RMSprop):
        return {'nu': moment('square_avg')}
    steps = {int(s['step']) for s in states if 'step' in s}
    if len(steps) > 1:
        raise ValueError(f'Adam steps differ across parameters: {steps}')
    count = np.asarray(steps.pop() if steps else 0, np.int32)
    return ScaleByAdamState(count, moment('exp_avg'), moment('exp_avg_sq'))


def _load_opt(module, opt, tree):
    names = [name for name, _ in module.named_parameters()]
    _load_opt_state(opt, [p for _, p in module.named_parameters()], tree,
                    lambda t, i: _leaf(t, names[i]))


def _load_opt_state(opt, params, tree, leaf):
    """Restore ``opt``'s state of ``params`` from the JAX package's
    optimizer state; ``leaf(tree, i)`` is parameter i's tensor in a
    moment tree."""
    for i, p in enumerate(params):
        # a capturable optimizer keeps its count on the parameter's device
        dev = p.device if opt.param_groups[0]['capturable'] else None
        if isinstance(opt, torch.optim.RMSprop):
            # torch's RMSprop counts steps but no update reads the count
            opt.state[p] = {'step': torch.zeros((), dtype=_scalar_dtype(),
                                                device=dev),
                            'square_avg': leaf(tree['nu'], i).to(p)}
        else:
            count, mu, nu = tree
            opt.state[p] = {
                'step': torch.tensor(float(np.asarray(count)),
                                     dtype=_scalar_dtype(), device=dev),
                'exp_avg': leaf(mu, i).to(p),
                'exp_avg_sq': leaf(nu, i).to(p)}


def _whole(state):
    if getattr(state, 'shards', None) is not None:
        raise ValueError('a sharded train state: make it whole first '
                         '(parallel.gather_state)')


def to_jax_state(state):
    """The train state (train_step.TrainState, whole) as the JAX package's
    train state pytree of numpy arrays."""
    _whole(state)
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
    _whole(state)
    merged, report = merge_state_tolerant(to_jax_state(state), tree)
    load_jax_tree(state.g, merged['g_params'])
    load_jax_tree(state.d, merged['d_params'])
    _load_opt(state.g, state.g_opt, merged['g_opt'])
    _load_opt(state.d, state.d_opt, merged['d_opt'])
    if state.g_ema is not None:
        load_jax_tree(state.g_ema, merged['g_ema'])
    return report


# --------------------------------------------------------------------------
# Legacy WGAN/DCGAN nets
# --------------------------------------------------------------------------

# weight permutations torch -> JAX (each its own inverse but the Conv2d one)
_CONV_TO_HWIO = (2, 3, 1, 0)       # Conv2d (out, in, kh, kw)
_HWIO_TO_CONV = (3, 2, 0, 1)
_CONVT_TO_JAX = (2, 3, 0, 1)       # ConvTranspose2d (in, out, kh, kw)


def _legacy_entries(module):
    """``(params, buffers)`` of a legacy net: (path in the JAX tree, tensor,
    to-JAX permutation or 'T' or None) for every parameter, (path in the
    bn_states tree, tensor) for every BN running statistic."""
    params, buffers = [], []

    def conv(m, path):
        perm = (_CONVT_TO_JAX if isinstance(m, torch.nn.ConvTranspose2d)
                else _CONV_TO_HWIO)
        params.append((path + ('w',), m.weight, perm))
        if m.bias is not None:
            params.append((path + ('b',), m.bias, None))

    def bn(m, path, state_path):
        params.extend([(path + ('scale',), m.weight, None),
                       (path + ('bias',), m.bias, None)])
        buffers.extend([(state_path + ('mean',), m.running_mean),
                        (state_path + ('var',), m.running_var)])

    for name, child in module.named_children():
        if name == 'blocks':
            for i, block in enumerate(child):
                conv(block.conv, ('blocks', i))
                bn(block.bn, ('blocks', i, 'bn'), (f'block{i}',))
        elif isinstance(child, torch.nn.Linear):
            params.extend([((name, 'w'), child.weight, 'T'),
                           ((name, 'b'), child.bias, None)])
        elif isinstance(child, torch.nn.BatchNorm2d):
            bn(child, (name,), (name,))
        elif isinstance(child, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            conv(child, (name,))
        else:   # the DCGAN generator's stem: a conv and its BN
            conv(child.conv, (name,))
            bn(child.bn, (name, 'bn'), (name,))
    return params, buffers


def _legacy_to_layout(a, perm):
    if perm == 'T':
        return np.ascontiguousarray(a.T)
    return a if perm is None else np.ascontiguousarray(a.transpose(perm))


def _legacy_from_layout(a, perm):
    if perm == _CONV_TO_HWIO:
        perm = _HWIO_TO_CONV
    return _legacy_to_layout(np.asarray(a), perm)


def _set_path(tree, path, value):
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        default = [] if isinstance(nxt, int) else {}
        if isinstance(node, list):
            while len(node) <= k:
                node.append(None)
            if node[k] is None:
                node[k] = default
            node = node[k]
        else:
            node = node.setdefault(k, default)
    node[path[-1]] = value


def _get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _legacy_tree(entries, arrays):
    tree = {}
    for (path, _, perm), a in zip(entries, arrays):
        _set_path(tree, path, _legacy_to_layout(a, perm))
    return tree


def legacy_to_jax(module):
    """A legacy net as the JAX package's ``(params, bn_states)`` pytrees of
    numpy arrays."""
    params, buffers = _legacy_entries(module)
    bn_states = {}
    for path, t in buffers:
        _set_path(bn_states, path, _numpy(t))
    return _legacy_tree(params, [_numpy(t) for _, t, _ in params]), bn_states


def load_legacy(module, params, bn_states):
    """Copy the JAX package's ``(params, bn_states)`` into a legacy net, in
    place.  Every leaf must be present with the matching shape."""
    entries, buffers = _legacy_entries(module)
    with torch.no_grad():
        for path, t, perm in entries:
            value = torch.from_numpy(np.array(_legacy_from_layout(
                _get_path(params, path), perm)))
            if value.shape != t.shape:
                raise ValueError(f'{path}: shape {tuple(value.shape)} does '
                                 f'not match {tuple(t.shape)}')
            t.copy_(value)
        for path, t in buffers:
            t.copy_(torch.from_numpy(np.array(_get_path(bn_states, path))))
    return module


def to_jax_legacy_state(state):
    """A legacy train state (legacy_train.LegacyState) as the JAX legacy
    trainer's state pytree."""
    tree = {}
    for net in ('g', 'd'):
        module, opt = getattr(state, net), getattr(state, f'{net}_opt')
        entries, _ = _legacy_entries(module)
        tree[f'{net}_params'], tree[f'{net}_bn'] = legacy_to_jax(module)
        tree[f'{net}_opt'] = _opt_state(
            opt, [t for _, t, _ in entries],
            lambda arrays, entries=entries: _legacy_tree(entries, arrays))
    return tree


def load_jax_legacy_state(state, tree):
    """Restore a legacy train state in place from the JAX legacy trainer's
    state pytree (every leaf present)."""
    for net in ('g', 'd'):
        module, opt = getattr(state, net), getattr(state, f'{net}_opt')
        load_legacy(module, tree[f'{net}_params'], tree[f'{net}_bn'])
        entries, _ = _legacy_entries(module)
        _load_opt_state(
            opt, [t for _, t, _ in entries], tree[f'{net}_opt'],
            lambda t, i, entries=entries: torch.from_numpy(np.array(
                _legacy_from_layout(_get_path(t, entries[i][0]),
                                    entries[i][2]))))
