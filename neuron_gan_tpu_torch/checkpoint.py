"""Checkpointing: the native ``.npz`` format and reference ``.pth`` files
(counterpart of neuron_gan_tpu/checkpoint.py).

Native format, the JAX package's own, so each package loads the other's
files: a single ``.npz`` holding the flattened train-state pytree (leaves
in ``jax.tree.flatten`` order: dict keys sorted, sequences in order) with
its JSON-encoded structure and a JSON meta dict.  The train state is
``{'state': {g_params, d_params, g_opt, d_opt[, g_ema]}, 'series': {...}}``
in the JAX layout (``convert.to_jax_state``).  ``Checkpointer`` keeps the
rolling file plus immutable ``_<N>k`` snapshots (reference utils.py:158-179).

Namedtuples (optax's ``ScaleByAdamState``) are recorded by module and
qualified name, as JAX writes them; the port has no optax to resolve
them with, so on load it rebuilds every namedtuple as a plain tuple, as
the JAX package does when it cannot resolve one.

Reference import/export: the reference's torch ``.pth`` files, read with
``torch.load(weights_only=True)`` (numpy loss series allowed by name,
``_reference_globals``) and written with ``torch.save``; the growth replay,
the legacy-key migration and the positional key mapping are the JAX
package's (see its checkpoint.py docstring for the key table).
"""

import codecs
import json
import os
import re
from collections import OrderedDict

import numpy as np
import torch

from neuron_gan_tpu_torch.models import GrowthState, PGConfig


# --------------------------------------------------------------------------
# Native .npz checkpoint
# --------------------------------------------------------------------------

def _flatten(tree, out):
    if isinstance(tree, dict):
        for _, v in sorted(tree.items()):
            _flatten(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flatten(v, out)
    else:
        out.append(tree)
    return out


def save_pytree_npz(path, tree, meta=None):
    """Save a pytree of arrays + a JSON-able meta dict."""
    leaves = _flatten(tree, [])
    arrays = {f'leaf_{i}': np.asarray(leaf) for i, leaf in enumerate(leaves)}
    arrays['__treedef__'] = np.frombuffer(
        json.dumps(_treedef_to_spec(tree)).encode(), dtype=np.uint8)
    if meta is not None:
        arrays['__meta__'] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_pytree_npz(path):
    """Returns (tree, meta)."""
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(bytes(z['__treedef__']).decode())
        meta = json.loads(bytes(z['__meta__']).decode()) if '__meta__' in z else None
        leaves = []
        i = 0
        while f'leaf_{i}' in z:
            leaves.append(z[f'leaf_{i}'])
            i += 1
    return _spec_to_tree(spec, iter(leaves)), meta


def _treedef_to_spec(tree):
    """JSON-able structural spec of a pytree of dict/list/tuple/namedtuple/arrays."""
    if isinstance(tree, dict):
        return {'__kind__': 'dict',
                'items': [[k, _treedef_to_spec(v)] for k, v in sorted(tree.items())]}
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):  # NamedTuple
        cls = type(tree)
        return {'__kind__': 'namedtuple',
                'module': getattr(cls, 'spec_module', cls.__module__),
                'name': getattr(cls, 'spec_name', cls.__qualname__),
                'items': [_treedef_to_spec(v) for v in tree]}
    if isinstance(tree, (list, tuple)):
        return {'__kind__': 'list' if isinstance(tree, list) else 'tuple',
                'items': [_treedef_to_spec(v) for v in tree]}
    return {'__kind__': 'leaf'}


def _spec_to_tree(spec, leaf_iter):
    kind = spec['__kind__']
    if kind == 'dict':
        return {k: _spec_to_tree(v, leaf_iter) for k, v in spec['items']}
    if kind in ('list', 'tuple', 'namedtuple'):
        seq = [_spec_to_tree(v, leaf_iter) for v in spec['items']]
        return seq if kind == 'list' else tuple(seq)
    return next(leaf_iter)


def merge_state_tolerant(target, loaded, path='state'):
    """Tolerant weight restore — the reference's ``load_state_dict(strict=False)``
    analog (reference utils.py:213-218): every loaded leaf whose path exists in
    ``target`` with a matching shape replaces the target's leaf; everything
    else keeps the target's (freshly initialized) value and is reported.

    Returns ``(merged, report)`` where report is a dict with keys
    ``missing`` (paths present in target but absent from the loaded tree),
    ``unexpected`` (paths only in the loaded tree) and ``mismatched``
    (paths whose shapes differ, kept at the target value).  When the two
    trees are structurally identical the merged tree is exactly the loaded
    one (bit-for-bit — leaves are not copied).
    """
    report = {'missing': [], 'unexpected': [], 'mismatched': []}

    def is_leaf(x):
        return not isinstance(x, (dict, list, tuple))

    def rec(t, l, p):
        if is_leaf(t) or is_leaf(l):
            if is_leaf(t) != is_leaf(l):
                report['mismatched'].append(
                    (p, 'leaf/subtree kind differs'))
                return t
            ts = np.shape(t)
            ls = np.shape(l)
            if ts != ls:
                report['mismatched'].append((p, f'{ls} vs {ts}'))
                return t
            return l
        if isinstance(t, dict):
            if not isinstance(l, dict):
                report['mismatched'].append((p, 'dict vs sequence'))
                return t
            out = {}
            for k in t:
                if k in l:
                    out[k] = rec(t[k], l[k], f'{p}.{k}')
                else:
                    report['missing'].append(f'{p}.{k}')
                    out[k] = t[k]
            for k in l:
                if k not in t:
                    report['unexpected'].append(f'{p}.{k}')
            return out
        # list / tuple / namedtuple: positional merge over the shared prefix
        if not isinstance(l, (list, tuple)):
            report['mismatched'].append((p, 'sequence vs dict'))
            return t
        n = min(len(t), len(l))
        children = [rec(t[i], l[i], f'{p}[{i}]') for i in range(n)]
        for i in range(n, len(t)):
            report['missing'].append(f'{p}[{i}]')
            children.append(t[i])
        for i in range(n, len(l)):
            report['unexpected'].append(f'{p}[{i}]')
        if isinstance(t, tuple) and hasattr(t, '_fields'):
            return type(t)(*children)
        return type(t)(children)

    merged = rec(target, loaded, path)
    return merged, report


def report_merge(report, where='checkpoint'):
    """Print a torch-style strict=False summary of what was not restored."""
    n_issues = sum(len(v) for v in report.values())
    if n_issues == 0:
        return
    for kind in ('missing', 'unexpected', 'mismatched'):
        for item in report[kind]:
            print(f'[{where}] {kind}: {item}')
    print(f'[{where}] tolerant load: {n_issues} entr{"y" if n_issues == 1 else "ies"} '
          'not restored (kept at their initialized values).')


class Checkpointer:
    """Rolling + periodic-immutable checkpoints (reference utils.py:142-223).

    It saves and loads JAX-layout trees; ``convert.to_jax_state`` /
    ``load_jax_state`` cross to and from the port's train state, so this
    class stays agnostic of it.
    """

    def __init__(self, filename, n_epochs=100, verbose=True,
                 extra_checkpoint_period=50e3):
        self.filename = filename
        self.epoch = 0
        self.loss_real = np.zeros(n_epochs)
        self.loss_fake = np.zeros(n_epochs)
        self.loss_g = np.zeros(n_epochs)
        self.loss_d = np.zeros(n_epochs)
        self.verbose = verbose
        self.extra_checkpoint_period = extra_checkpoint_period

    def save_state(self, epoch, tree, meta):
        self.epoch = epoch
        meta = dict(meta)
        meta['epoch'] = int(epoch)
        series = {
            'Loss_real': self.loss_real[:epoch],
            'Loss_fake': self.loss_fake[:epoch],
            'Loss_G': self.loss_g[:epoch],
            'Loss_D': self.loss_d[:epoch],
        }
        save_pytree_npz(self.filename, {'state': tree, 'series': series}, meta)
        if self.extra_checkpoint_period and epoch % self.extra_checkpoint_period == 0:
            base, ext = os.path.splitext(self.filename)
            save_pytree_npz(base + '_{:d}k'.format(int(epoch / 1000)) + ext,
                            {'state': tree, 'series': series}, meta)
        if self.verbose:
            print('Training state at epoch {} saved in {}.'.format(epoch, self.filename))

    def load_state(self, filename=None):
        """Returns (tree, meta); restores epoch + loss series on the rolling file."""
        path = filename or self.filename
        payload, meta = load_pytree_npz(path)
        tree, series = payload['state'], payload['series']
        if filename is None:
            self.epoch = int(meta['epoch'])
            for name, buf in (('Loss_real', self.loss_real), ('Loss_fake', self.loss_fake),
                              ('Loss_G', self.loss_g), ('Loss_D', self.loss_d)):
                n = min(self.epoch, len(series[name]), len(buf))
                buf[:n] = series[name][:n]
            if self.verbose:
                print('Loaded training state from {}'.format(path))
        elif self.verbose:
            print('Loaded weights from {}'.format(path))
        return tree, meta


# --------------------------------------------------------------------------
# Reference .pth import
# --------------------------------------------------------------------------

def _reference_globals():
    """The globals a reference ``.pth`` may name beyond tensors: those the
    JAX package's torch-free reader admits for numpy arrays (pth.py's
    ``find_class``), under both of numpy's module paths, and the numpy
    dtype classes whose state torch's weights-only unpickler must set when
    it rebuilds an array's dtype."""
    try:
        from numpy._core import multiarray
    except ImportError:     # numpy < 2
        from numpy.core import multiarray
    rec = multiarray._reconstruct
    return [(rec, 'numpy.core.multiarray._reconstruct'),
            (rec, 'numpy._core.multiarray._reconstruct'),
            (np.ndarray, 'numpy.ndarray'),
            (np.ndarray, 'numpy.core.numeric.ndarray'),
            (np.dtype, 'numpy.dtype'),
            (codecs.encode, '_codecs.encode'), bytes, bytearray,
            *{type(np.dtype(t)) for t in (
                np.float32, np.float64, np.float16, np.int64, np.int32,
                np.int16, np.int8, np.uint8, np.bool_)}]


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, OrderedDict):
        return OrderedDict((k, _to_numpy(v)) for k, v in obj.items())
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_numpy(v) for v in obj]
    return obj


def load_pth(path):
    """A torch ``.pth`` checkpoint as plain Python + numpy objects, loaded
    with ``weights_only=True``."""
    with torch.serialization.safe_globals(_reference_globals()):
        saved = torch.load(path, map_location='cpu', weights_only=True)
    return _to_numpy(saved)


def _oihw_to_hwio(w):
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _scalar(x):
    return float(np.asarray(x).reshape(()))


def _pop_legacy_modules(state, prefix, n_delete, from_start=True):
    """Reference legacy-format migration (models.py:38-63): drop + reindex
    numbered module entries under ``prefix``."""
    patt = re.compile(re.escape(prefix) + r'\.(\d+)')
    keys = [k for k in state if patt.match(k)]
    if not keys:
        return state
    idx = {k: int(patt.match(k).group(1)) for k in keys}
    n_max = max(idx.values()) + 1
    if n_delete == 'all':
        n_delete = n_max
    if n_delete <= 0:
        return state
    removed = set(range(0, n_delete)) if from_start else \
        set(range(n_max - n_delete, n_max))
    out = OrderedDict()
    for k, v in state.items():
        if k in idx:
            if idx[k] in removed:
                continue
            if from_start:
                m = patt.match(k)
                k = f'{prefix}.{idx[k] - n_delete}' + k[m.end():]
        out[k] = v
    return out


def _count_numbered(state, prefix):
    patt = re.compile(re.escape(prefix) + r'\.(\d+)')
    ids = {int(patt.match(k).group(1)) for k in state if patt.match(k)}
    return (max(ids) + 1) if ids else 0


def import_generator_pg(saved, cfg: PGConfig = None):
    """Map a loaded reference checkpoint dict onto (params, cfg, growth).

    ``saved`` is the dict returned by ``load_pth``.
    """
    attrs = saved['Generator_attrs']
    feats = [int(v) for v in np.asarray(attrs['N_features_per_layer']).tolist()] \
        if not isinstance(attrs['N_features_per_layer'], list) else list(attrs['N_features_per_layer'])
    if cfg is None:
        cfg = PGConfig(
            n_gen_features=tuple(feats),
            n_dis_features=tuple(feats),  # D side unknown here; G-only import
            latent_dim=int(attrs.get('latent_dim', 512)),
            image_size_init=int(attrs.get('image_size_init', 4)),
            n_colors=int(attrs.get('N_colors', 1)),
            neg_slope=float(attrs.get('LeakyReLU_neg_slope', 0.2)),
        )
    L = len(feats)
    growth = GrowthState(cfg)
    growth.set_resolution(int(attrs['image_size']), _scalar(attrs['alpha']))

    state = OrderedDict(saved['Generator_state'])

    # Legacy-format migration (reference models.py:411-436)
    n_toim_list = _count_numbered(state, 'ToIm_list')
    n_cbl = _count_numbered(state, 'conv_block_list')
    expected_toim_list = L - (1 + _n_completed(growth))
    if n_toim_list > expected_toim_list:
        state = _pop_legacy_modules(state, 'ToIm_list',
                                    n_toim_list - expected_toim_list, from_start=True)
        state = _pop_legacy_modules(state, 'conv_block_list',
                                    n_cbl - (L - 1 - _n_grown(growth)), from_start=True)
        state = _pop_legacy_modules(state, 'ToIm_prev', 'all', from_start=True)
        state = _pop_legacy_modules(state, 'last_conv_block', 'all', from_start=True)

    m = _n_grown(growth)           # blocks grown into `layers`
    p = 1 + _n_completed(growth)   # ToIm pops

    params = {
        'stem': {
            'linear': {'w': np.ascontiguousarray(np.asarray(state['layers.0.weight']).T)},
            'conv': {'w': _oihw_to_hwio(state['layers.4.weight'])},
        },
        'blocks': [],
        'to_rgb': [None] * L,
    }
    for i in range(L - 1):
        if i < m:
            k1, k2 = f'layers.{7 + i}.1.weight', f'layers.{7 + i}.4.weight'
        else:
            j = i - m
            k1, k2 = f'conv_block_list.{j}.1.weight', f'conv_block_list.{j}.4.weight'
        params['blocks'].append({'conv1': {'w': _oihw_to_hwio(state[k1])},
                                 'conv2': {'w': _oihw_to_hwio(state[k2])}})
    params['to_rgb'][p - 1] = {'w': _oihw_to_hwio(state['ToIm.layers.0.weight'])}
    for j in range(L - p):
        params['to_rgb'][p + j] = {'w': _oihw_to_hwio(state[f'ToIm_list.{j}.layers.0.weight'])}
    # Popped-and-discarded earlier to_rgb heads are gone from the reference's
    # state dict; fill with zeros (they are unreachable at/after this phase).
    for i in range(p - 1):
        c = feats[i]
        params['to_rgb'][i] = {'w': np.zeros((1, 1, c, cfg.n_colors), np.float32)}
    return params, cfg, growth


def import_discriminator_pg(saved, cfg: PGConfig):
    attrs = saved['Discriminator_attrs']
    feats = [int(v) for v in np.asarray(attrs['N_features_per_layer']).tolist()] \
        if not isinstance(attrs['N_features_per_layer'], list) else list(attrs['N_features_per_layer'])
    L = len(feats)
    growth = GrowthState(cfg)
    growth.set_resolution(int(attrs['image_size']), _scalar(attrs['alpha']))

    state = OrderedDict(saved['Discriminator_state'])

    n_fromim_list = _count_numbered(state, 'FromIm_list')
    expected_fromim_list = L - (1 + _n_completed(growth))
    if n_fromim_list > expected_fromim_list:
        n_cbl = _count_numbered(state, 'conv_block_list')
        state = _pop_legacy_modules(state, 'FromIm_list',
                                    n_fromim_list - expected_fromim_list, from_start=False)
        state = _pop_legacy_modules(state, 'conv_block_list',
                                    n_cbl - (L - 1 - _n_grown(growth)), from_start=False)
        state = _pop_legacy_modules(state, 'FromIm_prev', 'all', from_start=False)
        state = _pop_legacy_modules(state, 'first_conv_block', 'all', from_start=False)

    m = _n_grown(growth)
    r = L - (1 + _n_completed(growth))  # len(FromIm_list)

    params = {
        'head': {
            'conv': {'w': _oihw_to_hwio(state[f'layers.{m}.weight']),
                     'b': np.asarray(state[f'layers.{m}.bias'])},
            'conv_out': {'w': _oihw_to_hwio(state[f'layers.{m + 3}.weight']),
                         'b': np.asarray(state[f'layers.{m + 3}.bias'])},
        },
        'blocks': [None] * (L - 1),
        'from_rgb': [None] * L,
    }
    # Grown blocks: layers.i (i<m) maps to blocks[L-1-m+i]
    for i in range(m):
        params['blocks'][L - 1 - m + i] = {
            'conv1': {'w': _oihw_to_hwio(state[f'layers.{i}.1.weight'])},
            'conv2': {'w': _oihw_to_hwio(state[f'layers.{i}.4.weight'])},
        }
    for j in range(L - 1 - m):
        params['blocks'][j] = {
            'conv1': {'w': _oihw_to_hwio(state[f'conv_block_list.{j}.1.weight'])},
            'conv2': {'w': _oihw_to_hwio(state[f'conv_block_list.{j}.4.weight'])},
        }
    params['from_rgb'][r] = {'w': _oihw_to_hwio(state['FromIm.conv.weight']),
                             'b': np.asarray(state['FromIm.conv.bias'])}
    for j in range(r):
        params['from_rgb'][j] = {'w': _oihw_to_hwio(state[f'FromIm_list.{j}.conv.weight']),
                                 'b': np.asarray(state[f'FromIm_list.{j}.conv.bias'])}
    # Discarded later from_rgb heads (above current resolution) -> zeros.
    for i in range(r + 1, L):
        c = feats[i]
        params['from_rgb'][i] = {'w': np.zeros((1, 1, cfg.n_colors, c), np.float32),
                                 'b': np.zeros((c,), np.float32)}
    return params, growth


def _n_completed(growth: GrowthState) -> int:
    """Completed transitions = phase minus the one still fading (if any)."""
    return growth.phase - (1 if growth.fading else 0)


def _n_grown(growth: GrowthState) -> int:
    """Blocks moved into `layers` in the reference = completed transitions."""
    return _n_completed(growth)


# --------------------------------------------------------------------------
# Reference-layout export (inverse of the import mapping) — lets a user carry
# weights back to the reference's .pth key naming.
# --------------------------------------------------------------------------

def _hwio_to_oihw(w):
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def export_generator_state(params, cfg: PGConfig, growth: GrowthState):
    """Build the reference's Generator state-dict key layout (numpy values)."""
    L = cfg.n_layers_max
    m = _n_grown(growth)
    p = 1 + _n_completed(growth)
    state = OrderedDict()
    state['layers.0.weight'] = np.ascontiguousarray(
        np.asarray(params['stem']['linear']['w']).T)
    state['layers.4.weight'] = _hwio_to_oihw(params['stem']['conv']['w'])
    for i in range(L - 1):
        b = params['blocks'][i]
        if i < m:
            pre = f'layers.{7 + i}'
        else:
            pre = f'conv_block_list.{i - m}'
        state[f'{pre}.1.weight'] = _hwio_to_oihw(b['conv1']['w'])
        state[f'{pre}.4.weight'] = _hwio_to_oihw(b['conv2']['w'])
    state['ToIm.layers.0.weight'] = _hwio_to_oihw(params['to_rgb'][p - 1]['w'])
    for j in range(L - p):
        state[f'ToIm_list.{j}.layers.0.weight'] = _hwio_to_oihw(params['to_rgb'][p + j]['w'])
    return state


def export_discriminator_state(params, cfg: PGConfig, growth: GrowthState):
    L = cfg.n_layers_max
    m = _n_grown(growth)
    r = L - (1 + _n_completed(growth))
    state = OrderedDict()
    state['alpha'] = np.asarray(min(growth.alpha, 1.0), np.float32)
    for i in range(m):
        b = params['blocks'][L - 1 - m + i]
        state[f'layers.{i}.1.weight'] = _hwio_to_oihw(b['conv1']['w'])
        state[f'layers.{i}.4.weight'] = _hwio_to_oihw(b['conv2']['w'])
    state[f'layers.{m}.weight'] = _hwio_to_oihw(params['head']['conv']['w'])
    state[f'layers.{m}.bias'] = np.asarray(params['head']['conv']['b'])
    state[f'layers.{m + 3}.weight'] = _hwio_to_oihw(params['head']['conv_out']['w'])
    state[f'layers.{m + 3}.bias'] = np.asarray(params['head']['conv_out']['b'])
    for j in range(L - 1 - m):
        b = params['blocks'][j]
        state[f'conv_block_list.{j}.1.weight'] = _hwio_to_oihw(b['conv1']['w'])
        state[f'conv_block_list.{j}.4.weight'] = _hwio_to_oihw(b['conv2']['w'])
    state['FromIm.conv.weight'] = _hwio_to_oihw(params['from_rgb'][r]['w'])
    state['FromIm.conv.bias'] = np.asarray(params['from_rgb'][r]['b'])
    for j in range(r):
        state[f'FromIm_list.{j}.conv.weight'] = _hwio_to_oihw(params['from_rgb'][j]['w'])
        state[f'FromIm_list.{j}.conv.bias'] = np.asarray(params['from_rgb'][j]['b'])
    return state


def make_reference_attrs(cfg: PGConfig, growth: GrowthState, latent=True):
    """Generator_attrs / Discriminator_attrs as the reference saves them
    (introspected attr list, models.py:337-342/:509-514)."""
    attrs = {
        'N_features_per_layer': list(cfg.n_gen_features if latent else cfg.n_dis_features),
        'N_layers': growth.phase + 1,
        'N_layers_max': cfg.n_layers_max,
        'N_colors': cfg.n_colors,
        'image_size_init': cfg.image_size_init,
        'image_size': growth.image_size,
        'image_size_max': cfg.image_size_max,
        'LeakyReLU_neg_slope': cfg.neg_slope,
        'alpha': np.asarray(min(growth.alpha, 1.0), np.float32),
    }
    if latent:
        attrs['latent_dim'] = cfg.latent_dim
    return attrs


def save_reference_checkpoint(path, g_params, d_params, cfg: PGConfig,
                              growth: GrowthState, epoch=0, lr=1e-4,
                              series=None):
    """Write a checkpoint in the reference's torch ``.pth`` format (state
    dicts of tensors, loss series as numpy arrays) with ``torch.save``."""

    def to_tensors(state):
        return OrderedDict((k, torch.from_numpy(np.array(v, copy=True)))
                           for k, v in state.items())

    g_attrs = make_reference_attrs(cfg, growth, latent=True)
    d_attrs = make_reference_attrs(cfg, growth, latent=False)
    # the reference stores alpha as a 0-d tensor buffer (models.py:465)
    g_attrs['alpha'] = torch.tensor(np.float32(g_attrs['alpha']))
    d_attrs['alpha'] = torch.tensor(np.float32(d_attrs['alpha']))
    series = series or {}
    ckpt = {
        'epoch': int(epoch),
        'Generator_state': to_tensors(export_generator_state(g_params, cfg, growth)),
        'Generator_attrs': g_attrs,
        'Discriminator_state': to_tensors(export_discriminator_state(d_params, cfg, growth)),
        'Discriminator_attrs': d_attrs,
        'lr': float(lr),
        'Loss_real': np.asarray(series.get('Loss_real', np.zeros(0))),
        'Loss_fake': np.asarray(series.get('Loss_fake', np.zeros(0))),
        'Loss_G': np.asarray(series.get('Loss_G', np.zeros(0))),
        'Loss_D': np.asarray(series.get('Loss_D', np.zeros(0))),
    }
    torch.save(ckpt, path)
    return path


def import_reference_checkpoint(path):
    """Load a reference ``.pth`` and return (g_params, d_params, cfg, growth,
    meta) where meta carries epoch/lr/loss series when present."""
    saved = load_pth(path)
    g_attrs = saved['Generator_attrs']
    d_attrs = saved['Discriminator_attrs']
    g_feats = list(np.asarray(g_attrs['N_features_per_layer']).tolist()) \
        if not isinstance(g_attrs['N_features_per_layer'], list) else list(g_attrs['N_features_per_layer'])
    d_feats = list(np.asarray(d_attrs['N_features_per_layer']).tolist()) \
        if not isinstance(d_attrs['N_features_per_layer'], list) else list(d_attrs['N_features_per_layer'])
    cfg = PGConfig(
        n_gen_features=tuple(int(f) for f in g_feats),
        n_dis_features=tuple(int(f) for f in d_feats),
        latent_dim=int(g_attrs.get('latent_dim', 512)),
        image_size_init=int(g_attrs.get('image_size_init', 4)),
        n_colors=int(g_attrs.get('N_colors', 1)),
        neg_slope=float(g_attrs.get('LeakyReLU_neg_slope', 0.2)),
    )
    g_params, _, growth = import_generator_pg(saved, cfg)
    d_params, d_growth = import_discriminator_pg(saved, cfg)
    assert d_growth.image_size == growth.image_size, \
        'The generator and discriminator are at different resolution'
    meta = {k: saved[k] for k in ('epoch', 'lr', 'Loss_real', 'Loss_fake',
                                  'Loss_G', 'Loss_D') if k in saved}
    return g_params, d_params, cfg, growth, meta
