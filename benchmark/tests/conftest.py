"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at a
tiny size (every cell of BENCHMARK.json, its configuration cut as its
architecture's ``TINY`` says, its traffic to two epochs a chunk on 24^2
frames) that the harness runs on the CPU in a second."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

def cut(cfg, tiny):
    """``cfg`` with each key of its architecture's ``tiny`` {section: {key:
    value}} set, except where the configuration has it null."""
    for section, keys in tiny.items():
        for k, v in keys.items():
            if cfg[section].get(k, v) is not None:
                cfg[section][k] = v
    return cfg


def make_tiny(root, limits=True):
    """A tiny copy of the benchmark under ``root``; ``limits`` keeps the
    cells' limits (else they are 1.0)."""
    from benchmark import architectures
    root = Path(root)
    shutil.copytree(REPO / 'benchmark', root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    shutil.copy(REPO / 'BENCHMARK.json', root / 'BENCHMARK.json')
    for path in (root / 'benchmark' / 'configs').glob('*.json'):
        cfg = json.loads(path.read_text())
        arch = architectures.get(cfg['architecture'],
                                 root / 'benchmark' / 'architectures')
        path.write_text(json.dumps(cut(cfg, arch.TINY)))
    for path in (root / 'benchmark' / 'workloads').glob('*.json'):
        cell = json.loads(path.read_text())
        t = cell['traffic']
        t['phase'] = 2 if t['phase'] == 5 else 1
        if t['kind'] == 'train':
            t['frame'], t['epochs_per_chunk'] = 24, 2
        else:
            t['traced_batches'] = 4
        if not limits:
            cell['limits'] = {k: 1.0 for k in cell['limits']}
        path.write_text(json.dumps(cell))
    return root


@pytest.fixture
def tiny(tmp_path):
    from benchmark.harness import Bench
    return Bench(make_tiny(tmp_path))


@pytest.fixture
def cuda():
    """Skips the test without a CUDA card (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)
