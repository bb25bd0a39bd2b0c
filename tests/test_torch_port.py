"""Boundaries of the PyTorch port: it imports no JAX and nothing of the JAX
package, its entry points default to CUDA, its kernels build from the
repository's sources, and chip_smoke.py refuses to run without a card."""

import ast
import importlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

from neuron_gan_tpu_torch.runtime import kernels, resolve_device

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'optax', 'neuron_gan_tpu')


def _run(code, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=180, cwd=str(ROOT), env=env, **kw)


def test_port_modules_import_no_jax():
    code = (
        'import importlib, pkgutil, sys\n'
        'import neuron_gan_tpu_torch as pkg\n'
        'names = [m.name for m in pkgutil.walk_packages(pkg.__path__, '
        '"neuron_gan_tpu_torch.")]\n'
        'for n in names:\n'
        '    importlib.import_module(n)\n'
        f'bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})\n'
        'print(len(names), bad)\n'
        'assert not bad, bad\n')
    out = _run(code)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 15


@pytest.mark.parametrize('path', ['chip_smoke.py', 'neuron_gan_tpu_torch'])
def test_sources_name_no_jax_import(path):
    files = [ROOT / path] if path.endswith('.py') else \
        sorted((ROOT / path).rglob('*.py'))
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or '']
            else:
                continue
            for m in mods:
                assert m.split('.')[0] not in FORBIDDEN, (f, m)


def test_default_device_is_cuda_or_an_error(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device()
    assert resolve_device('cpu') == torch.device('cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert resolve_device() == torch.device('cuda')


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_refuses_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run([sys.executable, str(ROOT / 'chip_smoke.py')],
                         capture_output=True, text=True, timeout=180,
                         cwd=str(ROOT), env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    lone = tmp_path / 'chip_smoke.py'
    lone.write_text((ROOT / 'chip_smoke.py').read_text())
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, timeout=180, cwd=str(tmp_path), env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_parity_small_on_cpu():
    # the smoke's parity phase at a small size: on the CPU the kernel path's
    # Functions take the plain epilogue, so every distance but a planted
    # fault's is rounding, and each fault lies outside the bound
    import numpy as np
    import torch
    from neuron_gan_tpu_torch.flagship import flagship_chunk_spec, flagship_config
    smoke = load_chip_smoke()
    cfg = flagship_config(n_gen_features=(16, 8, 8),
                          n_dis_features=(8, 8, 16), latent_dim=8,
                          image_size_init=4)
    chunk = flagship_chunk_spec(2, crop_size=16, latent_dim=8, batch_size=2,
                                n_images=2)
    raw = torch.from_numpy(np.random.default_rng(1).random(
        (2, 24, 24, 1)).astype(np.float32))
    out = smoke.parity(torch, 0, cfg, chunk, raw)
    assert out['resolution'] == 16 and out['leaves'] == 23
    dists = out['grad_rel_l2']
    for name in ('kernel~plain', 'kernel~float64', 'plain~float64'):
        dist = dists[name]
        assert dist['D'] < 1e-5 and dist['G'] < 1e-5, (name, dist)
        assert dist['D_outside_tol'] == 0, (name, dist)
    for fault in ('no_second_order', 'bf16_epilogue'):
        assert dists[f'{fault}~float64']['D'] > out['rel_l2_bound']['D'], dists


def test_chip_smoke_parity_small_packed_on_cpu():
    # the packed path's parity at a small size: kernel path, plain packed
    # path, float64 and the plain unpacked path agree to rounding; both
    # planted faults (the r cotangent dropped; the dz kernel's second
    # order zeroed) lie outside the bound
    import numpy as np
    import torch
    from neuron_gan_tpu_torch.flagship import flagship_chunk_spec, flagship_packed_config
    smoke = load_chip_smoke()
    cfg = flagship_packed_config(n_gen_features=(16, 8, 8),
                                 n_dis_features=(8, 8, 16), latent_dim=8,
                                 image_size_init=8, packed_min_res=16)
    chunk = flagship_chunk_spec(2, crop_size=32, latent_dim=8, batch_size=2,
                                n_images=2)
    raw = torch.from_numpy(np.random.default_rng(2).random(
        (2, 48, 48, 1)).astype(np.float32))
    out = smoke.parity(torch, 0, cfg, chunk, raw, 'packed')
    assert out['resolution'] == 32
    dists = out['grad_rel_l2']
    for name in ('kernel~plain', 'kernel~float64', 'plain~float64',
                 'kernel~unpacked', 'plain~unpacked', 'float64~unpacked'):
        dist = dists[name]
        assert dist['D'] < 1e-5 and dist['G'] < 1e-5, (name, dist)
    for fault in ('ct_r_dropped', 'dz_no_second_order'):
        assert dists[f'{fault}~float64']['D'] > out['rel_l2_bound']['D'], dists


@pytest.mark.parametrize('path', ['unpacked', 'packed', 'mixed'])
def test_chip_smoke_launch_sites_match_expected_launches(path):
    # the smoke's per-shape launch sites of a steady 512^2 step sum to its
    # launch counts by kernel and dtype; K4 runs 6/6/6/1 times a step at
    # the four packed shapes, with a live r cotangent once per D block
    import collections
    from neuron_gan_tpu_torch import flagship
    smoke = load_chip_smoke()
    cfg = {'unpacked': flagship.flagship_config(),
           'packed': flagship.flagship_packed_config(),
           'mixed': flagship.flagship_mixed_config()}[path]
    dt = str(cfg.dtype).removeprefix('torch.')
    sites = smoke.steady_step_sites(path)
    want = smoke.expected_launches(cfg, [cfg.n_phases - 1])
    for key in ('k1', 'k2', 'k3', 'k4'):
        got = collections.Counter()
        for (k, _, case), n in sites.items():
            if k == key:
                got[smoke.launch_key(dt, case if key in ('k1', 'k2') else None)] += n
        assert dict(got) == want.get(key, {}), (key, got, want)
    k4 = collections.Counter()
    for (k, y, case), n in sites.items():
        if k == 'k4':
            k4[y[1:3]] += n
            assert case == 'absent' or y[1:3] in ((64, 128), (128, 64), (128, 32))
    if path != 'unpacked':
        assert k4 == {(128, 32): 6, (128, 64): 6, (64, 128): 6, (64, 256): 1}
        assert sum(n for (k, _, c), n in sites.items() if k == 'k4' and c == 'live') == 3


def test_kernel_sources_and_library_names():
    assert kernels.kernel_names() == ['critic_lrelu_pool', 'lrelu_pixel_norm',
                                     'packed_conv_lrelu_pn']
    path = kernels.library_path('lrelu_pixel_norm')
    # content-addressed: the name changes with the source or the flags
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith('lrelu_pixel_norm-') and path.suffix == '.so'
    assert path == kernels.library_path('lrelu_pixel_norm')
    assert 'arch=compute_90a,code=sm_90a' in kernels.NVCC_FLAGS
    assert str(kernels.BUILD_DIR.relative_to(ROOT)) == os.path.join('build', 'kernels')


@pytest.mark.parametrize('script', ['k3_variants', 'k4_variants',
                                    'k12_variants'])
def test_kernel_variants_each_edit_the_committed_source(script):
    # every design variant still applies to the source as it stands: each
    # of its edits matches exactly once and changes the text
    from neuron_gan_tpu_torch import k3_variants
    mod = importlib.import_module(f'neuron_gan_tpu_torch.{script}')
    src = (kernels.SOURCE_DIR / f'{mod.SOURCE}.cu').read_text()
    for name, edits in mod.VARIANTS.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, (name, old)
        assert k3_variants._substitute(src, edits) != src, name


def test_build_skips_existing_library(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, 'BUILD_DIR', tmp_path)
    for name in kernels.kernel_names():
        kernels.library_path(name).write_bytes(b'')
    # nothing to compile, so no compiler is looked for or run
    monkeypatch.setattr(kernels, '_nvcc', lambda: pytest.fail('nvcc called'))
    assert kernels.build() == {}


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, 'BUILD_DIR', tmp_path)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'no-cuda'))
    monkeypatch.setenv('PATH', str(tmp_path))
    if Path('/usr/local/cuda/bin/nvcc').exists():
        pytest.skip('this host has a CUDA toolkit')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        kernels.build()
