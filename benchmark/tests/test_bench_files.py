"""BENCHMARK.json against the benchmark's files, and cells, configurations,
architectures and metrics found by name: a cell, and an architecture with
its configuration and cells, added as new files alone run."""

import ast
import hashlib
import json
import re

import pytest

from benchmark import architectures, calibrate
from benchmark.harness import Bench, run_cell
from benchmark.tests.conftest import REPO, cut

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
    # the configuration names an architecture whose module has the interface
    path = REPO / 'benchmark' / 'architectures' / f"{cfg['architecture']}.py"
    assert path.is_file()
    arch = architectures.get(cfg['architecture'])
    assert all(callable(getattr(arch, k)) for k in architectures.INTERFACE)
    assert set(arch.TINY) <= {'model', 'training', 'execution'}
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


@pytest.mark.parametrize('fault', ('no key', 'no module'))
def test_an_architecture_is_named_and_found(tiny, fault):
    """A configuration without ``architecture``, or naming one with no
    module, is an error that names the file looked for."""
    path = tiny.dir / 'configs' / 'neuron512_f32.json'
    cfg = json.loads(path.read_text())
    if fault == 'no key':
        del cfg['architecture']
        want = str(path)
    else:
        cfg['architecture'] = 'absent_gan'
        want = str(tiny.dir / 'architectures' / 'absent_gan.py')
    path.write_text(json.dumps(cfg))
    with pytest.raises(KeyError, match=re.escape(want)):
        tiny.cell('neuron512_f32.sample16')


def _model_reach(path):
    """The imports of a model's reference, FLOPs or sites in ``path``, and
    its subscripts ['model']."""
    banned = {'benchmark.reference.model', 'benchmark.reference.train',
              'benchmark.reference.draws', 'benchmark.reference.augment',
              'benchmark.flops', 'benchmark.kernels'}
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if a.name in banned]
        elif isinstance(node, ast.ImportFrom) and node.module:
            found += [f'{node.module}.{a.name}' for a in node.names
                      if node.module in banned
                      or f'{node.module}.{a.name}' in banned]
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.slice, ast.Constant)
              and node.slice.value == 'model'):
            found.append(f"['model'] at line {node.lineno}")
    return found


@pytest.mark.parametrize('name', ('harness.py', 'calibrate.py',
                                  'tests/conftest.py'))
def test_shared_files_reach_no_model(name):
    """The shared files reach a model only through its architecture's
    module: no import of a reference, FLOP or site module, no ['model']."""
    assert _model_reach(REPO / 'benchmark' / name) == []


def test_the_seam_guard_sees_a_reach(tmp_path):
    bad = tmp_path / 'bad.py'
    bad.write_text('from benchmark import flops, trace\n'
                   'import benchmark.kernels\n'
                   'from benchmark.reference import draws as d\n'
                   'x = cfg["model"]\n')
    assert _model_reach(bad) == ['benchmark.flops', 'benchmark.kernels',
                                 'benchmark.reference.draws',
                                 "['model'] at line 4"]


TOY = '''"""A second architecture for the test: neuron_pggan's functions behind
spies, with its own cut."""

from pathlib import Path

from benchmark import architectures

BASE = architectures.get('neuron_pggan', Path(__file__).parent)
CALLS = []
SEEN = {}
TINY = {'model': {'n_gen_features': [12, 8, 6], 'n_dis_features': [6, 8, 12],
                  'latent_dim': 6, 'image_size_init': 4, 'n_colors': 3,
                  'neg_slope': 0.2},
        'training': {'crop_size': 16}, 'execution': {'packed_min_res': 8}}


def _spy(name):
    inner = getattr(BASE, name)

    def spy(*args, **kwargs):
        CALLS.append(name)
        out = inner(*args, **kwargs)
        SEEN.setdefault(name, out)
        return out
    return spy


for _name in architectures.INTERFACE:
    globals()[_name] = _spy(_name)
'''


def _hashes(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in root.rglob('*')
            if p.is_file() and '__pycache__' not in p.parts}


def test_an_architecture_added_as_files_alone(tiny):
    """A second architecture (a module that spies on neuron_pggan's
    functions, 3 colours, other widths), its configuration and a train and
    a sample cell, added as new files and BENCHMARK.json entries, run
    through run_cell and calibrate.py: every interface function is called
    through the module and no file that was there changes but
    BENCHMARK.json."""
    d = tiny.dir
    before = _hashes(tiny.repo)
    (d / 'architectures' / 'toy_pggan.py').write_text(TOY)
    toy = tiny.architecture('toy_pggan')
    cfg = json.loads((d / 'configs' / 'neuron512_f32.json').read_text())
    cfg.update(architecture='toy_pggan', source='a second architecture')
    (d / 'configs' / 'toy_f32.json').write_text(json.dumps(cut(cfg, toy.TINY)))
    spec = tiny.spec()
    spec['configs'].append({'name': 'toy_f32', 'source': cfg['source'],
                            'file': 'benchmark/configs/toy_f32.json',
                            'reduced': [], 'why': 'test'})
    for kind, traffic in (('steady512', 'steady'), ('sample16', 'sample')):
        cell = json.loads(
            (d / 'workloads' / f'neuron512_f32.{kind}.json').read_text())
        cell.update(config='toy_f32', why=f'a {traffic} cell of the test')
        (d / 'workloads' / f'toy_f32.{traffic}.json').write_text(
            json.dumps(cell))
        spec['workloads'].append({'name': f'toy_f32.{traffic}',
                                  'config': 'toy_f32', 'traffic': traffic,
                                  'chips': 1, 'why': cell['why']})
    for m in spec['end_to_end'] + spec['per_layer']:
        for kind, traffic in (('steady512', 'steady'), ('sample16', 'sample')):
            if f'neuron512_f32.{kind}' in m.get('workloads', ()):
                m['workloads'].append(f'toy_f32.{traffic}')
    (tiny.repo / 'BENCHMARK.json').write_text(json.dumps(spec))
    for name in ('toy_f32.steady', 'toy_f32.sample'):
        for trace in (False, True):
            res, _ = run_cell(name, 29, 0.2, trace, 'cpu', bench=tiny)
            assert res['correct'], (name, res['checks'])
            assert res['metrics']
        cell, cfg = tiny.cell(name)
        assert cfg['arch'] is toy
        read = (calibrate.train_reading if 'steady' in name
                else calibrate.sample_reading)
        read(cell, cfg, 31, 'cpu')
        read(cell, cfg, 31, 'cpu', control=cfg['control_precision'])
    assert set(toy.CALLS) == set(architectures.INTERFACE)
    assert toy.SEEN['train_inputs'][2].shape[-1] == 3
    after = _hashes(tiny.repo)
    changed = {k for k in before if after.get(k) != before[k]}
    assert changed == {'BENCHMARK.json'}
