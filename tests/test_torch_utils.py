"""The port's host utilities on the CPU: the sample grid with and without
PIL (exact: the same bytes decoded), the plots' skip without matplotlib,
MemoryLogger's refusal without psutil, and the copies of the JAX
package's io / crashdump / monitor helpers against the originals."""

import pickle
import sys

import numpy as np
import pytest
from PIL import Image

from neuron_gan_tpu.utils.plotting import make_grid as j_make_grid

from neuron_gan_tpu_torch.utils import plotting
from neuron_gan_tpu_torch.utils.crashdump import save_vars
from neuron_gan_tpu_torch.utils.io import validated_input
from neuron_gan_tpu_torch.utils.monitor import MemoryLogger, ProgressBar


def test_grid_with_and_without_pil(tmp_path, monkeypatch):
    imgs = np.random.default_rng(0).standard_normal((5, 6, 7, 1)).astype(np.float32)
    np.testing.assert_array_equal(plotting.make_grid(imgs, nrow=2, normalize=True),
                                  j_make_grid(imgs, nrow=2, normalize=True))
    plotting.save_image_grid(imgs, str(tmp_path / 'pil.png'), nrow=2)
    monkeypatch.setitem(sys.modules, 'PIL', None)
    plotting.save_image_grid(imgs, str(tmp_path / 'png.png'), nrow=2)
    monkeypatch.undo()
    a, b = (np.array(Image.open(tmp_path / f)) for f in ('pil.png', 'png.png'))
    assert a.shape == (3 * 8 + 2, 2 * 9 + 2) and np.array_equal(a, b)


def test_plots_skip_once_without_matplotlib(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setattr(plotting, '_skipped', set())
    for _ in range(2):
        plotting.plot_scores([1.0, 2.0], [0.5, 0.1], str(tmp_path / 's.png'))
        plotting.plot_swd([{'epoch': 1, 'swd_mean': 0.1, 'levels': [0.1],
                            'resolution': 4}], str(tmp_path / 'w.png'))
        plotting.plot_grad_norm([np.ones(3)], [np.ones(2)], str(tmp_path / 'g.png'))
    out = capsys.readouterr().out.splitlines()
    assert out == ['score plot skipped: matplotlib is not installed',
                   'SWD plot skipped: matplotlib is not installed',
                   'gradient-norm plot skipped: matplotlib is not installed']
    assert not list(tmp_path.iterdir())


def test_memory_logger_needs_psutil(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'psutil', None)
    with pytest.raises(ImportError, match='psutil'):
        MemoryLogger(logs_dir=str(tmp_path))


def test_host_helpers(tmp_path, monkeypatch, capsys):
    bar = ProgressBar(2)
    bar.step()
    bar.step()
    with pytest.raises(AssertionError, match='exceeded'):
        bar.step()
    path = save_vars({'x': np.arange(3), 'f': lambda: 0}, out_dir=str(tmp_path))
    with open(path, 'rb') as fh:
        saved = pickle.load(fh)
    assert np.array_equal(saved['x'], np.arange(3))
    assert saved['f'] == 'ERROR: variable cannot be saved'
    assert 'test_host_helpers' in path
    monkeypatch.setattr(sys.stdin, 'isatty', lambda: False)
    assert validated_input('go?', lambda a: a in 'yn', default='n') == 'n'
