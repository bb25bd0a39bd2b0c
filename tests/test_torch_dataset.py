"""The port's dataset loader and PNG codec against the JAX package's
loader (its numpy path) and PIL, on the CPU.  Every comparison is exact:
the stacks bit for bit, the decodes bit for bit."""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import neuron_gan_tpu.runtime as jax_runtime
from neuron_gan_tpu.data.neuron_dataset import NeuronDataset as JNeuronDataset

from neuron_gan_tpu_torch.data import neuron_dataset as tnd
from neuron_gan_tpu_torch.utils.png import PngError, png_size, read_png, write_png


@pytest.fixture
def jax_numpy_path(monkeypatch):
    # the JAX package's numpy noise statistics (its native library, where
    # built, computes the std by the moment identity)
    monkeypatch.setattr(jax_runtime, 'native_available', lambda: False)


@pytest.fixture(scope='module')
def mixed_dir(tmp_path_factory):
    """Frames of unequal sizes and types: uint8 and uint16 grayscale, RGB."""
    d = tmp_path_factory.mktemp('mixed_frames')
    rng = np.random.default_rng(3)
    g8 = rng.normal(30, 8, (20, 14)).clip(0, 255).astype(np.uint8)
    g8[:3, :3] = 0
    Image.fromarray(g8).save(d / 'a.png')
    g16 = (rng.normal(9000, 2000, (12, 18)).clip(0, 65535)).astype(np.uint16)
    g16[5:9, 5:9] = 0
    Image.fromarray(g16).save(d / 'b.png')
    rgb = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
    rgb[0, :, 0] = 0
    Image.fromarray(rgb).save(d / 'c.png')
    return str(d)


@pytest.mark.parametrize('which', ['tiny', 'mixed'])
def test_stack_equals_jax_numpy_path(jax_numpy_path, tiny_dataset_dir, mixed_dir,
                                     which):
    d = tiny_dataset_dir if which == 'tiny' else mixed_dir
    jds = JNeuronDataset(d, image_size=16, seed=5)
    tds = tnd.NeuronDataset(d, image_size=16, seed=5)
    assert tds.padded_size == jds.padded_size and len(tds) == len(jds)
    assert np.array_equal(tds.images, jds.images)
    assert np.array_equal(tds.images_noise_mean, jds.images_noise_mean)
    assert np.array_equal(tds.images_noise_std, jds.images_noise_std)


def test_stack_without_pil_equals_with_pil(monkeypatch, mixed_dir, tmp_path):
    with_pil = tnd.NeuronDataset(mixed_dir, image_size=16, seed=1).images
    monkeypatch.setattr(tnd, '_pil_image', lambda: None)
    assert np.array_equal(tnd.NeuronDataset(mixed_dir, image_size=16,
                                            seed=1).images, with_pil)
    # a file the PNG codec cannot read names itself and the package
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(tmp_path / 'x.tif')
    with pytest.raises(ValueError, match=r'x\.tif.*PIL'):
        tnd.NeuronDataset(str(tmp_path), image_size=16)


def test_memmap_cache_shared_with_jax(jax_numpy_path, tiny_dataset_dir, tmp_path):
    import shutil
    d = tmp_path / 'data'
    shutil.copytree(tiny_dataset_dir, d)
    ram = tnd.NeuronDataset(str(d), image_size=16, seed=2)
    cached = tnd.NeuronDataset(str(d), image_size=16, seed=2, preload_limit_mb=0)
    assert not cached.preloaded and isinstance(cached.images, np.memmap)
    assert np.array_equal(np.asarray(cached.images), ram.images)
    stack = d / '.neuron_gan_cache' / 'stack.npy'
    built = os.stat(stack).st_mtime_ns
    # reopened, not rebuilt: by the port and by the JAX package's numpy path
    again = tnd.NeuronDataset(str(d), image_size=16, seed=2, preload_limit_mb=0)
    jds = JNeuronDataset(str(d), image_size=16, seed=2, preload_limit_mb=0)
    assert os.stat(stack).st_mtime_ns == built
    assert np.array_equal(np.asarray(again.images), ram.images)
    assert np.array_equal(np.asarray(jds.images), ram.images)
    assert np.array_equal(again.images_noise_std, ram.images_noise_std)


def _png(path, rows, width, depth, ctype, filters):
    """A PNG of the raw scanlines ``rows`` ((H, stride) uint8), each row
    filtered with the given filter type (0-4), as an encoder would."""
    bpp = {0: 1, 2: 3, 6: 4}[ctype] * depth // 8
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for row, kind in zip(rows.astype(np.int64), filters):
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([kind]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body)))

    ihdr = struct.pack('>IIBBBBB', width, rows.shape[0], depth, ctype, 0, 0, 0)
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', ihdr)
                + chunk(b'IDAT', zlib.compress(b''.join(out)))
                + chunk(b'IEND', b''))


@pytest.mark.parametrize('depth,ctype', [(8, 0), (16, 0), (8, 2), (16, 2),
                                         (8, 6), (16, 6)])
def test_png_decode_equals_pil(tmp_path, depth, ctype):
    rng = np.random.default_rng(depth + ctype)
    width, height = 13, 10
    channels = {0: 1, 2: 3, 6: 4}[ctype]
    # smooth rows, so every filter's prediction matters
    rows = np.cumsum(rng.integers(0, 9, (height, width * channels * depth // 8)),
                     axis=1).astype(np.uint8)
    path = tmp_path / 'f.png'
    _png(path, rows, width, depth, ctype, [i % 5 for i in range(height)])
    want = np.array(Image.open(path))
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert png_size(path) == (height, width)


def test_png_pil_written_and_writer_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    gray = np.cumsum(rng.integers(0, 5, (31, 47)), axis=0).astype(np.uint8)
    rgb = rng.integers(0, 256, (9, 21, 3)).astype(np.uint8)
    Image.fromarray(gray).save(tmp_path / 'pil.png')
    assert np.array_equal(read_png(tmp_path / 'pil.png'), gray)
    for name, arr in (('g.png', gray), ('rgb.png', rgb)):
        write_png(tmp_path / name, arr)
        assert np.array_equal(np.array(Image.open(tmp_path / name)), arr)
    # a palette PNG is refused by name
    Image.fromarray(gray).convert('P').save(tmp_path / 'p.png')
    with pytest.raises(PngError, match=r'p\.png: colour type 3'):
        read_png(tmp_path / 'p.png')
