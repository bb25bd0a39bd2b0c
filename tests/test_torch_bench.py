"""The port's benchmark (neuron_gan_tpu_torch/bench.py) against the JAX
package's bench.py, on the CPU.

bench.py's ``__main__`` block runs here with its measuring functions
replaced by stubs (``run_jax_main``), so its records, and the arguments its
flags hand ``bench_tpu``, come from its own code; the port's ``main`` runs
with its measuring functions stubbed the same way.  The runs that measure
are tiny: 3 levels (16^2-64^2), batch 2, windows of one epoch.
Tolerances: the eval grid against JAX's ``generator_pg`` at 'highest' rtol
1e-5 with atol 3e-5 on the [-1, 1] image (three times the largest
deviation read, 1.005e-5, where the to_rgb sums near 0 meet float32
rounding in another order; relative L2 1.1e-6), relative L2 1e-5 under
``--fast`` (fused level boundaries); everything else exact.
"""

import ast
import contextlib
import dataclasses
import inspect
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from neuron_gan_tpu.flagship import (
    flagship_chunk_spec as j_chunk_spec, flagship_config as j_config)
from neuron_gan_tpu.models import (
    PGConfig as JPGConfig, generator_pg, init_generator_pg)

from neuron_gan_tpu_torch import bench
from neuron_gan_tpu_torch.convert import load_jax_tree
from neuron_gan_tpu_torch.flagship import (
    flagship_shipping_chunk_spec, flagship_shipping_config)
from neuron_gan_tpu_torch.models import DiscriminatorPG, GeneratorPG
from neuron_gan_tpu_torch.train_step import init_train_state, make_epoch_runner

ROOT = Path(__file__).resolve().parents[1]
VALUE = 1.23456
# the PGConfig knobs the port renamed: JAX's three kernel gates are its one
RENAMED = {'use_pallas': 'use_kernels', 'pallas_epilogue': 'use_kernels',
           'pallas_conv': 'use_kernels'}
# ChunkSpec fields the port has not: its ranks take their rows themselves
JAX_ONLY_SPEC = {'data_axis'}
# keys the port's records add (module docstring)
PORT_KEYS = {'min', 'max', 'windows', 'roofline_error'}
TINY = dict(n_gen_features=(32, 16, 16), n_dis_features=(16, 16, 32),
            latent_dim=16)


# ---------------------------------------------------------------------------
# bench.py's own code, with its measuring functions stubbed
# ---------------------------------------------------------------------------

def jax_bench_namespace():
    """bench.py's module body without its ``__main__`` block, and that
    block's statements."""
    tree = ast.parse((ROOT / 'bench.py').read_text())
    main_if = tree.body[-1]
    assert isinstance(main_if, ast.If) and '__main__' in ast.unparse(main_if.test)
    ns = {'__name__': 'jax_bench'}
    exec(compile(ast.Module(body=tree.body[:-1], type_ignores=[]),
                 str(ROOT / 'bench.py'), 'exec'), ns)
    return ns, compile(ast.Module(body=main_if.body, type_ignores=[]),
                       str(ROOT / 'bench.py'), 'exec')


def run_jax_main(argv, monkeypatch):
    """(printed JSON lines, kwargs of every bench_tpu call) of bench.py's
    ``__main__`` under ``argv``, every measuring function returning VALUE
    (bench_tpu also filling its roofline dict)."""
    ns, main = jax_bench_namespace()
    calls = []

    def bench_tpu(**kw):
        calls.append(kw)
        if kw.get('roofline') is not None:
            kw['roofline'].update(hbm_gb_per_step=2.5, hbm_roofline_pct=7.5)
        return VALUE

    ns.update(bench_tpu=bench_tpu, bench_eval=lambda **kw: VALUE,
              bench_torch_reference=lambda **kw: VALUE)
    monkeypatch.setattr(sys, 'argv', ['bench.py'] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.suppress(SystemExit):
        exec(main, ns)
    return [json.loads(ln) for ln in out.getvalue().splitlines()], calls


def stub_port(monkeypatch):
    """The port's measuring functions returning VALUE; returns the
    (cfg, spec) of every bench_train call."""
    calls = []

    def bench_train(cfg, spec, device=None, windows=5, roofline=None):
        calls.append((cfg, spec))
        if roofline is not None:
            roofline.update(hbm_gb_per_step=2.5, hbm_roofline_pct=7.5)
        return {'value': VALUE, 'min': VALUE, 'max': VALUE, 'windows': [VALUE],
                'steps': 0, 'state': None, 'step_bytes': None}

    summary = {'value': VALUE, 'min': VALUE, 'max': VALUE, 'windows': [VALUE]}
    monkeypatch.setattr(bench, 'bench_train', bench_train)
    monkeypatch.setattr(bench, 'bench_eval', lambda **kw: {'value': VALUE, 'grids': 0})
    monkeypatch.setattr(bench, 'bench_torch_reference', lambda **kw: summary)
    # bench.py's divisor, so vs_baseline compares too
    monkeypatch.setattr(bench, 'baseline_for', lambda device: 0.0127)
    return calls


def run_port_main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main(argv + ['--device', 'cpu'])
    return [json.loads(ln) for ln in out.getvalue().splitlines()]


# ---------------------------------------------------------------------------
# Records: metric names, units and keys for each flag set (bench.py:409-551)
# ---------------------------------------------------------------------------

FLAG_SETS = [
    [], ['--batch', '12'], ['--batch', '8'], ['--no-shear'], ['--lanes-64'],
    ['--remat-gp'], ['--pallas-epilogue'], ['--pallas-conv'],
    ['--pallas-conv', '--pallas-epilogue', '--no-shear', '--batch', '16'],
    ['--phase', '3'], ['--phase', '3', '--fading'],
    ['--phase', '5', '--exact-augment'], ['--eval'], ['--eval', '--fast'],
    ['--metric=eval'], ['--preset'], ['--measure-torch'],
    ['--measure-torch', '--phase', '2'], ['--all-phases'],
    ['--all-phases', '--exact-augment'],
]


@pytest.mark.parametrize('argv', FLAG_SETS, ids=' '.join)
def test_records_are_bench_pys(argv, monkeypatch):
    want, _ = run_jax_main(argv, monkeypatch)
    stub_port(monkeypatch)
    got = run_port_main(argv)
    assert len(got) == len(want) == (11 if '--all-phases' in argv else 1)
    for g, w in zip(got, want):
        assert set(g) - PORT_KEYS == set(w), (g, w)
        for key in w:
            assert g[key] == w[key], (key, g, w)
        if 'value' in g or 'steps_per_sec' in g or 'torch_ref_steps_per_sec' in g:
            if '--eval' not in argv and '--metric=eval' not in argv:
                assert {'min', 'max', 'windows'} <= set(g)


def test_mesh_record_keys_are_bench_pys(monkeypatch):
    # bench.py's bench_mesh builds its record inside (:218-237): its keys
    # from the source; the run: two gloo ranks at the reduced geometry
    fn = next(n for n in ast.parse((ROOT / 'bench.py').read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == 'bench_mesh')
    ret, = [n.value for n in ast.walk(fn)
            if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    want = {k.value for k in ret.keys}
    monkeypatch.setattr(bench, 'MESH_EPOCHS_CHUNK', 1)
    rec, = run_port_main(['--mesh', 'data=2', '--windows', '1'])
    assert set(rec) - PORT_KEYS == want
    assert rec['metric'] == 'mesh_train_steps_per_sec_64'
    assert rec['unit'] == "steps/sec (G+D, batch 8, 64x64, sharded over {'data': 2})"
    assert rec['backend'] == 'cpu-gloo' and rec['mesh_shape'] == {'data': 2}
    assert rec['value'] > 0 and rec['single_device_steps_per_sec'] > 0
    # bench.py's reduced geometry (:170-178), its phase and batch (:183)
    cfg, spec, frame, _ = bench.mesh_setup({'data': 2}, 2, 'cpu-gloo')
    assert (cfg.n_gen_features, cfg.n_dis_features, cfg.latent_dim,
            cfg.packed_lanes, cfg.compute_dtype, cfg.precision) == (
        (16, 8, 8), (8, 8, 16), 16, 128, 'mixed', None)
    assert (spec.phase, spec.batch_size, spec.crop_size, frame) == (2, 8, 64, 96)
    assert bench.mesh_setup({'data': 4}, 2, 'nccl')[1].batch_size == 8
    assert bench.mesh_setup({'data': 16}, 2, 'nccl')[1].batch_size == 16


def test_mesh_needs_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        bench.main(['--mesh', 'data=2'])
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match='needs 4 GPUs, have 1'):
        bench.main(['--mesh', 'data=2,model=2'])


@pytest.mark.parametrize('argv, message', [
    (['--unroll', '2'], '--unroll is refused'),
    (['--phase', '3', '--unroll', '2'], '--unroll is refused'),
    (['--exact-augment'], '--exact-augment does not apply'),
    (['--fast'], '--fast does not apply'),
    (['--phase', '2', '--batch', '16'], '--batch does not apply'),
    (['--eval', '--windows', '3'], '--windows does not apply'),
    (['--eval', '--preset'], 'one mode at a time'),
    (['--mesh', 'data=x'], 'bad mesh shape'),
])
def test_refusals(argv, message, capsys):
    with pytest.raises(SystemExit):
        bench.parse_args(argv)
    assert message in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Configuration parity: what bench_tpu builds (bench.py:55-70) for each flag
# set, field by field
# ---------------------------------------------------------------------------

def jax_config_and_spec(kw):
    """bench.py's bench_tpu :55-70 for the captured call ``kw``, with its
    defaults."""
    ns, _ = jax_bench_namespace()
    a = inspect.signature(ns['bench_tpu']).bind(**kw)
    a.apply_defaults()
    a = a.arguments
    cfg = j_config(compute_dtype=a['compute_dtype'],
                   pallas_epilogue=a['pallas_epilogue'],
                   pallas_conv=a['pallas_conv'], packed_lanes=a['packed_lanes'])
    phase = cfg.n_phases - 1 if a['phase'] is None else a['phase']
    spec = j_chunk_spec(phase, fading=a['fading'],
                        fast_augment=a['fast_augment'],
                        shear_warp=a['shear_warp'],
                        gp_reuse_fakes=a['gp_reuse_fakes'],
                        gp_remat=a['gp_remat'], batch_size=a['batch'],
                        n_images=max(16, a['batch']))
    return cfg, spec


@pytest.mark.parametrize('argv', [
    [], ['--phase', '3', '--fading'], ['--phase', '5', '--exact-augment'],
    ['--no-shear'], ['--lanes-64'], ['--remat-gp'], ['--batch', '12'],
    ['--pallas-conv', '--pallas-epilogue'], ['--preset']], ids=' '.join)
def test_configuration_is_bench_pys(argv, monkeypatch):
    _, jcalls = run_jax_main(argv, monkeypatch)
    calls = stub_port(monkeypatch)
    run_port_main(argv)
    (cfg, spec), = calls
    jcfg, jspec = jax_config_and_spec(jcalls[0])
    for f in dataclasses.fields(jcfg):
        if f.name in RENAMED:
            assert getattr(cfg, RENAMED[f.name])   # the port's kernels are on
        else:
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for f in dataclasses.fields(jspec):
        if f.name in JAX_ONLY_SPEC:
            assert getattr(jspec, f.name) is None
        elif f.name == 'n_images':
            # rounded up to a multiple of the batch (bench.py: max(16, batch))
            batch = spec.batch_size
            assert spec.n_images == -(-jspec.n_images // batch) * batch
        else:
            assert getattr(spec, f.name) == getattr(jspec, f.name), f.name
    assert spec.gp_reuse_fakes
    assert spec.n_images == (24 if '12' in argv else 16)


# ---------------------------------------------------------------------------
# No work left out: the bench's run is the epoch runner's
# ---------------------------------------------------------------------------

def tiny_flagship(monkeypatch):
    monkeypatch.setattr(bench, 'flagship_shipping_config',
                        lambda **kw: flagship_shipping_config(**{**TINY, **kw}))
    monkeypatch.setattr(
        bench, 'flagship_shipping_chunk_spec',
        lambda phase, fading=False, **kw: flagship_shipping_chunk_spec(
            phase, fading, **{'crop_size': 64, 'latent_dim': 16, **kw}))
    monkeypatch.setattr(bench, 'FRAME', 96)
    monkeypatch.setattr(bench, 'N_EPOCHS_CHUNK', 1)


def test_bench_train_is_the_epoch_runner(monkeypatch):
    tiny_flagship(monkeypatch)
    runs = []
    real = bench.bench_train
    monkeypatch.setattr(bench, 'bench_train',
                        lambda *a, **kw: runs.append(real(*a, **kw)) or runs[-1])
    rec, = run_port_main(['--batch', '2', '--windows', '2'])
    assert rec['metric'] == 'wgan_gp_train_steps_per_sec_512_batch2'
    assert len(rec['windows']) == 2 and rec['min'] <= rec['value'] <= rec['max']
    assert 'hbm_gb_per_step' not in rec and 'cpu' in rec['roofline_error']
    assert runs[0]['steps'] == 3 * 8

    # the same epochs straight through make_epoch_runner
    cfg, spec = bench.train_setup(batch=2)
    assert (cfg.resolution(spec.phase), spec.n_images) == (64, 16)
    init = torch.Generator().manual_seed(0)
    state = init_train_state(GeneratorPG(cfg, init, device='cpu'),
                             DiscriminatorPG(cfg, init, device='cpu'))
    images = torch.from_numpy(np.random.default_rng(0).random(
        (16, 96, 96, 1)).astype(np.float32))
    rng = torch.Generator().manual_seed(0)
    run = make_epoch_runner(cfg, spec, 1)
    for epoch in (1, 2, 3):
        run(state, images, rng, epoch)
    got = runs[0]['state']
    for net in ('g', 'd'):
        for (name, p), q in zip(getattr(state, net).named_parameters(),
                                getattr(got, net).parameters()):
            assert torch.equal(p, q), (net, name)
    for opt in ('g_opt', 'd_opt'):
        mine, theirs = getattr(state, opt).state, getattr(got, opt).state
        for p, q in zip(getattr(state, opt).param_groups[0]['params'],
                        getattr(got, opt).param_groups[0]['params']):
            for key in ('exp_avg', 'exp_avg_sq', 'step'):
                assert torch.equal(mine[p][key], theirs[q][key]), (opt, key)


# ---------------------------------------------------------------------------
# The byte count
# ---------------------------------------------------------------------------

def test_byte_count_of_a_conv():
    x, w = torch.randn(2, 3, 8, 8), torch.randn(4, 3, 3, 3)
    with bench.ByteCount() as count:
        y = F.conv2d(x, w, padding=1)
    assert count.bytes == 4 * (x.numel() + w.numel() + y.numel())
    with bench.ByteCount() as count:
        x.reshape(2, -1).t()   # views move no bytes
    assert count.bytes == 0


def test_step_bytes_repeat_and_ignore_the_kernels(monkeypatch):
    tiny_flagship(monkeypatch)
    cfg, spec = bench.train_setup(batch=2)
    raw = torch.from_numpy(np.random.default_rng(1).random(
        (2, 96, 96, 1)).astype(np.float32))
    counts = [bench.step_bytes(cfg, spec, raw) for _ in range(2)]
    counts.append(bench.step_bytes(dataclasses.replace(cfg, use_kernels=False),
                                   spec, raw))
    assert counts[0] > 0 and len(set(counts)) == 1, counts


# ---------------------------------------------------------------------------
# Eval: the grid against JAX's generator_pg
# ---------------------------------------------------------------------------

def jax_eval_config(fast, **widths):
    """bench.py's bench_eval configuration (:250-255)."""
    kw = dict(n_gen_features=(128, 64, 32, 32, 16, 16),
              n_dis_features=(16, 16, 32, 32, 64, 128),
              latent_dim=64, image_size_init=16, n_colors=1,
              **({'precision': None, 'packed_min_res': 64, 'packed_lanes': 128}
                 if fast else {}))
    kw.update(widths)
    return JPGConfig(**kw)


@pytest.mark.parametrize('fast', [False, True], ids=['highest', 'fast'])
def test_eval_grid_is_jaxs(fast):
    cfg, jcfg = bench.eval_config(fast), jax_eval_config(fast)
    for f in dataclasses.fields(jcfg):
        if f.name not in RENAMED:
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.use_kernels and cfg.compute_dtype == 'float32'
    # at 3 levels (16^2-64^2): the 64^2 level packed under --fast
    cfg = dataclasses.replace(cfg, **TINY)
    jcfg = jax_eval_config(fast, **TINY)
    params = jax.tree.map(np.asarray,
                          init_generator_pg(jax.random.PRNGKey(3), jcfg))
    g = load_jax_tree(GeneratorPG(cfg, torch.Generator().manual_seed(0),
                                  device='cpu'), params)
    z = np.random.default_rng(3).normal(size=(2, 16)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    want = np.asarray(generator_pg(params, jnp.asarray(z), jcfg, 2)
                      ).transpose(0, 3, 1, 2)   # NHWC -> NCHW
    got = bench.grid_images(g, torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 1, 64, 64)
    if fast:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=3e-5)


# ---------------------------------------------------------------------------
# The reference's nets and step
# ---------------------------------------------------------------------------

def bench_py_reference_shapes(phase, monkeypatch):
    """Parameter shapes of bench.py's bench_torch_reference nets at
    ``phase``, read from the optimizers it builds (no step runs)."""
    ns, _ = jax_bench_namespace()
    shapes = []

    class Stop(Exception):
        pass

    def adam(params, **kw):
        shapes.append([tuple(p.shape) for p in params])
        if len(shapes) == 2:
            raise Stop
    monkeypatch.setattr(torch.optim, 'Adam', adam)
    monkeypatch.setattr(torch, 'set_num_threads', lambda n: None)
    with pytest.raises(Stop):
        ns['bench_torch_reference'](phase=phase)
    return shapes


def test_reference_nets_are_bench_pys(monkeypatch):
    for phase in range(6):
        want = bench_py_reference_shapes(phase, monkeypatch)
        g, d = bench.reference_nets(phase, 'cpu')
        assert [[tuple(p.shape) for p in g.parameters()],
                [tuple(p.shape) for p in d.parameters()]] == want, phase
    monkeypatch.undo()
    g, d = bench.reference_nets(1, 'cpu')
    opts = [torch.optim.Adam(n.parameters(), lr=1e-4, betas=(0.5, 0.999))
            for n in (g, d)]
    rng = torch.Generator().manual_seed(0)
    images = torch.randn(8, 1, 32, 32, generator=rng)
    before = [p.clone() for p in g.parameters()]
    losses = bench.reference_step(g, d, *opts, images, rng)
    assert torch.isfinite(losses).all()
    assert not all(torch.equal(p, q) for p, q in zip(before, g.parameters()))
    r = bench.bench_torch_reference(n_steps=2, phase=0, device='cpu', windows=2)
    assert len(r['windows']) == 2 and r['value'] > 0
