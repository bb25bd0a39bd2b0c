"""BENCHMARK.json against the benchmark's files, and cells, configurations
and metrics found by name: a cell added as new files alone runs."""

import json
import re

import pytest

from benchmark.harness import Bench, run_cell
from benchmark.tests.conftest import REPO

SPEC = json.loads((REPO / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_keys_and_names():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['benchmark']
    assert SPEC['command'][1] == 'benchmark/run.py'
    assert 1 <= SPEC['run_seconds'] <= 51
    names = [m['name'] for m in SPEC['end_to_end'] + SPEC['per_layer']]
    names += [c['name'] for c in SPEC['configs'] + SPEC['workloads']]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC['end_to_end'] + SPEC['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for m in SPEC['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert any(m['name'] == 'setup_s' for m in SPEC['end_to_end'])
    for m in SPEC['per_layer']:
        assert '\n' not in m['layer'] and len(m['layer']) <= 200
    assert all(w['chips'] == 1 for w in SPEC['workloads'])


@pytest.mark.parametrize('w', SPEC['workloads'], ids=lambda w: w['name'])
def test_cell_files(w):
    cell, cfg = Bench().cell(w['name'])
    assert cell['config'] == w['config']
    assert w['name'] == f"{w['config']}.{w['traffic']}"
    assert cell['why'] == w['why'] and len(w['why']) <= 200
    entry = next(c for c in SPEC['configs'] if c['name'] == w['config'])
    assert entry['file'] == f"benchmark/configs/{w['config']}.json"
    assert entry['source'] == cfg['source'] and entry['reduced'] == cfg['reduced']
    # every limit is set, and every cell reports setup_s, another end-to-end
    # metric and a per-layer metric
    assert all(isinstance(v, float) and v > 0 for v in cell['limits'].values())
    bench = Bench()
    e2e = {m['name'] for m in bench.metrics_of(w['name'], 'end_to_end')}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert bench.metrics_of(w['name'], 'per_layer')


@pytest.mark.parametrize('m', SPEC['per_layer'], ids=lambda m: m['name'])
def test_metric_readers(m):
    assert callable(Bench().reader(m['name']))
    moves = {e['name']: e for e in SPEC['end_to_end']}[m['moves']]
    assert set(m['workloads']) <= set(moves.get('workloads', m['workloads']))


def test_a_cell_added_as_files_alone(tiny):
    """A new configuration, cell and per-layer metric, each a new file and
    an entry of BENCHMARK.json, are found by name and run."""
    d = tiny.dir
    cfg = json.loads((d / 'configs' / 'neuron512_f32.json').read_text())
    cfg['source'] = 'a copy for the test'
    (d / 'configs' / 'copy_f32.json').write_text(json.dumps(cfg))
    cell = json.loads(
        (d / 'workloads' / 'neuron512_f32.steady512.json').read_text())
    cell['config'] = 'copy_f32'
    cell['traffic']['phase'] = 1
    cell['why'] = 'a new cell of the test'
    (d / 'workloads' / 'copy_f32.steady.json').write_text(json.dumps(cell))
    (d / 'metrics' / 'traced_steps.py').write_text(
        'def read(r):\n    return r.units if r.kind == "train" else None\n')
    spec = tiny.spec()
    spec['configs'].append({'name': 'copy_f32', 'source': cfg['source'],
                            'file': 'benchmark/configs/copy_f32.json',
                            'reduced': [], 'why': 'test'})
    spec['workloads'].append({'name': 'copy_f32.steady', 'config': 'copy_f32',
                              'traffic': 'steady', 'chips': 1,
                              'why': cell['why']})
    for m in spec['end_to_end']:
        if m['name'] == 'train_steps_per_s':
            m['workloads'].append('copy_f32.steady')
    spec['per_layer'].append({'name': 'traced_steps', 'unit': 'steps',
                              'better': 'higher', 'source': 'device_trace',
                              'layer': 'test', 'moves': 'train_steps_per_s',
                              'workloads': ['copy_f32.steady']})
    (tiny.repo / 'BENCHMARK.json').write_text(json.dumps(spec))
    res, _ = run_cell('copy_f32.steady', 11, 0.2, True, 'cpu', bench=tiny)
    assert res['metrics']['traced_steps']['value'] == 4
    res, _ = run_cell('copy_f32.steady', 11, 0.2, False, 'cpu', bench=tiny)
    assert set(res['metrics']) == {'train_steps_per_s', 'setup_s'}
    assert res['correct']
