"""``correct`` at a tiny size on the CPU: sound runs pass the cells'
limits, the lower-precision control and every planted fault a cell can
have fail them, and a result line has the keys the contract names."""

import json
import math
import subprocess
import sys

import pytest
import torch

from benchmark import calibrate, faults
from benchmark.harness import forbidden_modules, run_cell
from benchmark.tests.conftest import REPO

SPEC = json.loads((REPO / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in SPEC['workloads']]


def _kind(tiny, name):
    return tiny.cell(name)[0]['traffic']['kind']


@pytest.mark.parametrize('name', CELLS)
def test_sound_run_is_correct(tiny, name):
    res, _ = run_cell(name, 2 ** 31 + 17, 0.2, False, 'cpu', bench=tiny)
    assert res['correct'], res['checks']


FAULTS = [(c, f) for c in CELLS
          for f in (faults.SAMPLE if 'sample' in c else faults.TRAIN)]


@pytest.mark.parametrize('name,fault', FAULTS)
def test_planted_fault_is_not_correct(tiny, name, fault):
    planted = {**faults.TRAIN, **faults.SAMPLE}[fault]
    res, _ = run_cell(name, 2 ** 31 + 19, 0.2, False, 'cpu', bench=tiny,
                      patch=planted)
    assert not res['correct'], (fault, res['checks'])


@pytest.mark.parametrize('name', CELLS)
def test_control_is_not_correct(tiny, name):
    """The reference in the configuration's control precision, put in the
    program's place, fails one of the cell's limits."""
    cell, cfg = tiny.cell(name)
    read = (calibrate.train_reading if cell['traffic']['kind'] == 'train'
            else calibrate.sample_reading)
    numbers, _ = read(cell, cfg, 23, torch.device('cpu'),
                      control=cfg['control_precision'])
    assert any(not numbers[k] <= v for k, v in cell['limits'].items()), numbers


@pytest.mark.parametrize('trace', (0, 1))
def test_result_keys(tiny, trace):
    res, _ = run_cell('neuron512_ship.steady512', 7, 0.2, bool(trace), 'cpu',
                      bench=tiny)
    assert list(res)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                             'device']
    assert list(res)[-1] == 'checks'
    assert set(res['device']) >= {'platform', 'kind', 'count',
                                  'memory_peak_bytes'}
    assert all(set(m) == {'value', 'unit'} for m in res['metrics'].values())
    assert all(set(c) == {'value', 'limit'} and math.isfinite(c['value'])
               for c in res['checks'].values())
    if trace:
        assert {'busy_s', 'window_s'} <= set(res['device'])
        assert set(res['breakdown']) == {'device_ops', 'idle_gaps'}
    else:
        assert set(res['metrics']) == {'train_steps_per_s', 'setup_s'}
    json.dumps(res)


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(['neuron_gan_tpu_torch', 'neuron_gan_tpu_torch.ops',
                              'jaxtyping', 'flaxen', 'torch']) == []
    assert forbidden_modules(['jax', 'jaxlib.xla_client', 'flax.linen',
                              'neuron_gan_tpu.models']) == [
        'flax.linen', 'jax', 'jaxlib.xla_client', 'neuron_gan_tpu.models']


def _python(code):
    return subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_reference_imports_nothing_of_the_program(tmp_path):
    """Every cell's architecture module, its inputs, draws, reference
    (a training cell's first steps, a sampling cell's images) and counts,
    run at the tiny size, load nothing of the program or of JAX."""
    from benchmark.tests.conftest import make_tiny
    make_tiny(tmp_path)
    out = _python(
        'import sys, torch\n'
        'from benchmark.harness import Bench, reference_run\n'
        f'b = Bench({str(tmp_path)!r})\n'
        'for w in b.spec()["workloads"]:\n'
        '    cell, cfg = b.cell(w["name"])\n'
        '    t, a = cell["traffic"], cfg["arch"]\n'
        '    if t["kind"] == "train":\n'
        '        g, d, stack = a.train_inputs(cfg, t, 5, "cpu")\n'
        '        reference_run(cfg, t, 5, g, d, stack, "cpu")\n'
        '        a.train_step_flops(cfg, t), a.kernel_sites(cfg, t)\n'
        '    else:\n'
        '        gen = torch.Generator().manual_seed(5)\n'
        '        g, _ = a.make_weights(cfg, gen)\n'
        '        a.generator(g, a.latent(gen, 2, cfg), t["phase"], cfg)\n'
        '        a.g_forward_flops(cfg, t["phase"], 1)\n'
        'print(sorted({m.split(".")[0] for m in sys.modules}'
        ' & {"neuron_gan_tpu_torch", "neuron_gan_tpu", "jax", "jaxlib", "flax"}))')
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def test_a_run_loads_no_jax(tmp_path):
    from benchmark.tests.conftest import make_tiny
    make_tiny(tmp_path)
    out = _python(
        'from benchmark.harness import Bench, run_cell, forbidden_modules\n'
        f'b = Bench({str(tmp_path)!r})\n'
        'for w in ("neuron512_ship.steady512", "neuron512_f32.sample16"):\n'
        '    run_cell(w, 3, 0.1, False, "cpu", bench=b)\n'
        'print(forbidden_modules())')
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('this machine has a CUDA card')
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                          CELLS[0], '--seed', '1', '--seconds', '1'],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ''


@pytest.mark.chip
@pytest.mark.parametrize('name', CELLS)
def test_cell_on_the_card(cuda, name):
    """A short run of each cell on the card: its last line is correct."""
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                          name, '--seed', str(2 ** 31 + 3), '--seconds', '3'],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['correct'] and res['device']['platform'] == 'gpu', res
