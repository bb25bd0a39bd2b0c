"""Parameters between the JAX package's pytree and the port's modules.

The JAX pytree is nested dicts and lists of numpy arrays: conv weights HWIO,
linear weights (in, out), leaves named ``w`` and ``b``.  The port's module
parameters carry the same paths (``blocks.0.conv1.weight`` is
``tree['blocks'][0]['conv1']['w']``) with conv weights OIHW and linear
weights (out, in).  Checkpoints of either package therefore load in the
other.
"""

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


def to_jax_tree(module: torch.nn.Module):
    """The module's parameters as a JAX-layout pytree of numpy arrays."""
    tree = {}
    for name, p in module.named_parameters():
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
        node[keys[-1]] = _to_jax_layout(p.detach().cpu().float().numpy())
    return tree


def load_jax_tree(module: torch.nn.Module, tree):
    """Copy a JAX-layout pytree into the module's parameters, in place.
    Every parameter must be present with the matching shape."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            node = tree
            for k in _path(name):
                node = node[k]
            value = torch.from_numpy(np.array(_from_jax_layout(np.asarray(node))))
            if value.shape != p.shape:
                raise ValueError(f'{name}: shape {tuple(value.shape)} does '
                                 f'not match {tuple(p.shape)}')
            p.copy_(value.to(p.dtype))
    return module
