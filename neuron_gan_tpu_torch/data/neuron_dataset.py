"""Host-side dataset loading (one-time), device-resident thereafter
(counterpart of neuron_gan_tpu/data/neuron_dataset.py, whose numpy code
this copies).

Reference pipeline (data/NeuronDataset.py:45-167): per image —
  1. decode (PIL where it imports; otherwise the PNG codec in
     ``utils/png.py``, which decodes what PIL does, bit for bit);
  2. 4-class multi-Otsu threshold on the raw array; noise pixels are
     ``0 < v < thresh[0]``; record their mean/std (:92-97);
  3. pad by ``image_size // 4`` with zeros (:70-71, :101);
  4. replace zero pixels with Gaussian noise drawn from that image's
     background statistics (:13-20, :104);
  5. convert to float in [0, 1] (ToTensor).

The processed stack is one (N, P, P, 1) float32 array on the host, which
the training CLI copies to the device once.  The Otsu thresholds and the
noise statistics go to the native library (``runtime/native.py``) where
g++ is, else numpy; both give numpy's numbers (the std by two passes,
never the moment identity; ``runtime/native.py``).
"""

import json
import os

import numpy as np

from neuron_gan_tpu_torch.runtime import native
from neuron_gan_tpu_torch.utils.png import png_size, read_png


def _pil_image():
    """PIL's Image module, or None where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _is_png(path):
    with open(path, 'rb') as f:
        return f.read(8) == b'\x89PNG\r\n\x1a\n'


def _no_decoder(path):
    return ValueError(f'cannot decode {path}: PIL (the Pillow package) is '
                      'not installed, and without it only PNG files are read')


def image_size_of(path):
    """(height, width) of an image file, from its header."""
    image = _pil_image()
    if image is not None:
        with image.open(path) as img:
            w, h = img.size
        return h, w
    if not _is_png(path):
        raise _no_decoder(path)
    return png_size(path)


def decode_image(path):
    """The image as the array PIL's ``np.array(Image.open(path))`` gives."""
    image = _pil_image()
    if image is not None:
        with image.open(path) as img:
            return np.array(img)
    if not _is_png(path):
        raise _no_decoder(path)
    return read_png(path)


def threshold_multiotsu(image: np.ndarray, classes: int = 4, nbins: int = 256):
    """Multi-Otsu thresholds (classes-1 values), histogram-DP formulation.

    Maximizes sum over classes of w_k * mu_k^2 (equivalently between-class
    variance) where bins partition into ``classes`` contiguous groups.
    Dispatches to the native library where it is available.
    """
    vals = image.ravel()
    vmin, vmax = vals.min(), vals.max()
    if vmin == vmax:
        return np.full(classes - 1, vmin, dtype=np.float64)

    if np.issubdtype(image.dtype, np.integer) and (int(vmax) - int(vmin)) < nbins:
        # integer data with small range: one bin per integer value
        centers = np.arange(int(vmin), int(vmax) + 1, dtype=np.float64)
        hist = np.bincount((vals.astype(np.int64) - int(vmin)),
                           minlength=centers.size).astype(np.float64)
    else:
        hist, edges = np.histogram(vals, bins=nbins, range=(vmin, vmax))
        hist = hist.astype(np.float64)
        centers = (edges[:-1] + edges[1:]) / 2.0
    if native.native_available():
        return native.multi_otsu_hist(hist, centers, classes)
    return _multiotsu_from_hist(hist, centers, classes)


def _multiotsu_from_hist(hist, centers, classes):
    """numpy DP over a prepared histogram (also the native library's
    stand-in where it has no partition)."""
    n = centers.size
    p = hist / hist.sum()
    # cumulative moments: P[i..j] and S[i..j] via prefix sums
    cp = np.concatenate([[0.0], np.cumsum(p)])
    cs = np.concatenate([[0.0], np.cumsum(p * centers)])

    def seg_score(i, j):
        """w * mu^2 of bins [i, j] inclusive; -inf for empty weight."""
        w = cp[j + 1] - cp[i]
        s = cs[j + 1] - cs[i]
        with np.errstate(divide='ignore', invalid='ignore'):
            val = np.where(w > 0, (s * s) / np.where(w > 0, w, 1.0), 0.0)
        return val

    # score[i, j] for all segments (n x n upper-triangular)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing='ij')
    score = seg_score(ii, jj)

    # DP over number of segments: f[k][j] = best score of splitting bins
    # [0..j] into k+1 segments; arg tracks the split point.
    k_classes = classes
    f = np.full((k_classes, n), -np.inf)
    arg = np.zeros((k_classes, n), dtype=np.int64)
    f[0] = score[0]
    # score_next[i, j] = score of segment [i+1 .. j]
    score_next = np.vstack([score[1:], np.full((1, n), -np.inf)])
    lower = np.arange(n)[:, None] >= np.arange(n)[None, :]  # i >= j invalid
    for k in range(1, k_classes):
        # f[k][j] = max_{i<j} f[k-1][i] + score[i+1, j]
        cmat = f[k - 1][:, None] + score_next
        cmat[lower] = -np.inf
        arg[k] = np.argmax(cmat, axis=0)
        f[k] = cmat[arg[k], np.arange(n)]

    # Backtrack split points
    thresholds = []
    j = n - 1
    for k in range(k_classes - 1, 0, -1):
        i = int(arg[k][j])
        thresholds.append(centers[i])
        j = i
    return np.array(thresholds[::-1], dtype=np.float64)


def replace_zero_with_noise(arr: np.ndarray, noise_mean, noise_std, rng):
    """Fill zero pixels with N(mean, std) noise (reference NeuronDataset.py:13-20).

    Like the reference (which writes noise back into the integer PIL image),
    noise is cast to the array dtype before insertion.
    """
    out = arr.copy()
    is_zero = out == 0
    noise = noise_std * rng.standard_normal(out.shape) + noise_mean
    out[is_zero] = noise[is_zero].astype(out.dtype)
    return out


def _to_unit_float(arr: np.ndarray) -> np.ndarray:
    """ToTensor scaling: uint8 -> /255, uint16 -> /65535, float passthrough."""
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(np.float32) / 65535.0
    if np.issubdtype(arr.dtype, np.integer):
        return arr.astype(np.float32) / float(np.iinfo(arr.dtype).max)
    return arr.astype(np.float32)


class NeuronDataset:
    """Loads every image in a directory into one padded, noise-filled stack.

    Attributes mirror the reference where meaningful: ``image_size`` is the
    current output resolution (progressive growth calls ``set_image_size``,
    reference NeuronDataset.py:149-164 — here it just records the target; the
    resize happens in the augmentation on the device).

    Large datasets: when the processed float32 stack would exceed
    ``preload_limit_mb``, the stack is materialized once into an on-disk
    ``.npy`` cache and opened as a read-only memmap.  The cache is keyed on
    the file list, mtimes, pad, seed and the noise-statistics backend, in
    the JAX package's format, so either package reuses a cache the other
    built from the same numpy statistics.

    Images of unequal sizes are accepted: each is zero-padded (after the
    reference's ``image_size // 4`` border) up to the largest square frame,
    and the per-image background-noise fill then covers the extra border.
    """

    def __init__(self, directory: str, image_size: int = 512,
                 augmentations: bool = True, im_translation: float = 0.0,
                 seed: int = 0, preload_limit_mb: float = 100.0,
                 n_colors: int = 1):
        if not os.path.exists(directory):
            raise ValueError('The dataset path {} does not exist.'.format(directory))
        self.dir = directory
        self.image_size = image_size
        self.image_size_max = image_size
        self.augmentations = augmentations
        self.im_translation = im_translation
        self.seed = seed
        # colour planes of the stack: 1 collapses an image to its first
        # plane; 3 keeps RGB (a grey image repeated), each plane padded and
        # filled with the first plane's noise statistics
        self.n_colors = n_colors
        # noise-statistics backend, decided once per dataset build
        self._stats_impl = 'native' if native.native_available() else 'numpy'

        self.filenames = sorted(
            os.path.join(directory, f) for f in os.listdir(directory)
            if not f.startswith('.')
            and os.path.isfile(os.path.join(directory, f)))
        if not self.filenames:
            raise ValueError(f'No images found in {directory}')

        pad = image_size // 4
        n = len(self.filenames)
        sizes = [image_size_of(f) for f in self.filenames]
        frame = max(max(h, w) for h, w in sizes) + 2 * pad
        self.padded_size = frame

        self.images_noise_mean = np.empty(n)
        self.images_noise_std = np.empty(n)

        est_bytes = n * frame * frame * 4 * n_colors
        self.preloaded = est_bytes <= preload_limit_mb * 2 ** 20
        if self.preloaded:
            self.images = np.empty((n, frame, frame, n_colors), np.float32)
            self._fill_stack(self.images, frame)
        else:
            try:
                self.images = self._open_or_build_cache(frame)
            except OSError as exc:
                # read-only dataset mounts can't host the memmap cache —
                # fall back to the in-RAM path rather than failing
                print(f'dataset cache unavailable ({exc}); '
                      'loading the full stack into RAM instead')
                self.preloaded = True
                self.images = np.empty((n, frame, frame, n_colors), np.float32)
                self._fill_stack(self.images, frame)

    # ------------------------------------------------------------- processing
    def _process_one(self, index: int, frame: int) -> np.ndarray:
        """One image: decode, Otsu noise stats, pad, noise-fill, to [0,1]."""
        arr = decode_image(self.filenames[index])
        # the first n_colors planes (1: collapse to single channel like the
        # 1-color config), a grey image repeated; noise stats from the first
        arr = arr if arr.ndim == 3 else arr[..., None]
        planes = [arr[..., min(c, arr.shape[-1] - 1)]
                  for c in range(self.n_colors)]
        arr = planes[0]
        thresh = threshold_multiotsu(arr, classes=4)
        # two passes: the std over (v - mean)^2, never the moment identity
        if self._stats_impl == 'native' and arr.dtype == np.uint8:
            (self.images_noise_mean[index],
             self.images_noise_std[index]) = native.noise_stats_u8(
                 arr, float(thresh[0]))
        else:
            is_noise = np.logical_and(arr > 0, arr < thresh[0])
            noise_vals = arr[is_noise]
            self.images_noise_mean[index] = (noise_vals.mean()
                                             if noise_vals.size else 0.0)
            self.images_noise_std[index] = (noise_vals.std()
                                            if noise_vals.size else 0.0)

        return np.stack([self._pad_fill(p, frame, index, c)
                         for c, p in enumerate(planes)], axis=-1)

    def _pad_fill(self, arr, frame, index, plane):
        """One plane: the reference border pad, centred in the common
        frame, its zeros filled with the image's noise."""
        h, w = arr.shape
        top = (frame - h) // 2
        left = (frame - w) // 2
        padded = np.pad(arr, ((top, frame - h - top), (left, frame - w - left)),
                        mode='constant', constant_values=0)
        # per-image RNG stream: identical output whether the stack is built
        # in RAM or streamed into the cache (and independent of order)
        rng = np.random.default_rng([self.seed, index] + [plane] * (plane > 0))
        filled = replace_zero_with_noise(padded, self.images_noise_mean[index],
                                         self.images_noise_std[index], rng)
        return _to_unit_float(filled)

    def _fill_stack(self, out, frame: int):
        for i in range(len(self.filenames)):
            out[i] = self._process_one(i, frame)

    # ---------------------------------------------------------------- caching
    def _cache_key(self, frame: int):
        entries = [(os.path.basename(f), os.path.getmtime(f), os.path.getsize(f))
                   for f in self.filenames]
        # frame = max image dim + 2*pad, so it pins the padded geometry;
        # 'stats' names the noise statistics' numbers: the port's native
        # library gives numpy's (runtime/native.py), so it is 'numpy'
        # either way (the JAX package's native library, whose std differs
        # at ~1e-15, writes 'native')
        key = {'frame': frame, 'seed': self.seed, 'files': entries,
               'stats': 'numpy'}
        if self.n_colors != 1:
            key['colors'] = self.n_colors
        return key

    def _open_or_build_cache(self, frame: int):
        cache_dir = os.path.join(self.dir, '.neuron_gan_cache')
        os.makedirs(cache_dir, exist_ok=True)
        stack_path = os.path.join(cache_dir, 'stack.npy')
        meta_path = os.path.join(cache_dir, 'stack.json')
        key = self._cache_key(frame)

        if os.path.exists(stack_path) and os.path.exists(meta_path):
            with open(meta_path) as fh:
                meta = json.load(fh)
            if meta.get('key') == json.loads(json.dumps(key)):
                self.images_noise_mean = np.array(meta['noise_mean'])
                self.images_noise_std = np.array(meta['noise_std'])
                return np.load(stack_path, mmap_mode='r')

        # Build incrementally: one decoded image in RAM at a time.
        out = np.lib.format.open_memmap(
            stack_path, mode='w+', dtype=np.float32,
            shape=(len(self.filenames), frame, frame, self.n_colors))
        self._fill_stack(out, frame)
        out.flush()
        del out
        with open(meta_path, 'w') as fh:
            json.dump({'key': key,
                       'noise_mean': self.images_noise_mean.tolist(),
                       'noise_std': self.images_noise_std.tolist()}, fh)
        return np.load(stack_path, mmap_mode='r')

    def __len__(self):
        return len(self.filenames)

    def set_image_size(self, size: int):
        assert size <= self.image_size_max, \
            'The image size ({}) must be < {}.'.format(size, self.image_size_max)
        self.image_size = size
