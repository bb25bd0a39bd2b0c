"""ctypes bindings of the native preprocessing library (``preproc.cpp``;
counterpart of neuron_gan_tpu/runtime/native.py).

The library is built by ``build.py`` at the first call, never at import.
It is available wherever g++ is (or the library was built before); the
dataset then takes it (``NeuronDataset._stats_impl == 'native'``), and a
failed build raises.  Its results are the numpy path's, summed in the
order of numpy's generic pairwise loop (``preproc.cpp``): bit for bit
with numpy 2.0.2; a numpy whose vector loops sum in another order differs
in the std's last bit (4.4e-16 measured on an H100 host), which the
dataset's uint8 noise fill did not see (the stacks were equal).
"""

import ctypes

import numpy as np

from neuron_gan_tpu_torch.runtime import build

_lib = {}


def native_available() -> bool:
    return build.library_path().exists() or build.compiler() is not None


def _load():
    lib = _lib.get('preproc')
    if lib is None:
        lib = ctypes.CDLL(str(build.build()))
        lib.multi_otsu_hist.restype = ctypes.c_int
        lib.multi_otsu_hist.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.noise_stats_u8.restype = ctypes.c_longlong
        lib.noise_stats_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double,
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double)]
        _lib['preproc'] = lib
    return lib


def multi_otsu_hist(hist, centers, classes=4):
    """Thresholds (classes-1,) from a histogram.  A histogram with fewer
    bins than classes, or no count, has no partition the native DP takes;
    it goes to the numpy DP, as in the JAX package."""
    hist = np.ascontiguousarray(hist, dtype=np.float64)
    centers = np.ascontiguousarray(centers, dtype=np.float64)
    if centers.shape != hist.shape:
        raise ValueError(f'hist {hist.shape} and centers {centers.shape} differ')
    out = np.empty(classes - 1, dtype=np.float64)
    rc = _load().multi_otsu_hist(hist.ctypes.data, centers.ctypes.data,
                                 len(hist), classes, out.ctypes.data)
    if rc == 0:
        return out
    from neuron_gan_tpu_torch.data.neuron_dataset import _multiotsu_from_hist
    return _multiotsu_from_hist(hist, centers, classes)


def noise_stats_u8(img_u8, thresh):
    """(mean, std) of the pixels 0 < v < thresh of a uint8 image: the
    reference's background-noise statistics (NeuronDataset.py:94-97),
    numpy's ``sel.mean()`` and two-pass ``sel.std()`` (see above); (0, 0)
    for none."""
    img = np.ascontiguousarray(img_u8)
    if img.dtype != np.uint8:
        raise TypeError(f'noise_stats_u8 needs uint8, got {img.dtype}')
    mean, std = ctypes.c_double(), ctypes.c_double()
    _load().noise_stats_u8(img.ctypes.data, img.size, float(thresh),
                           np.getbufsize(), ctypes.byref(mean),
                           ctypes.byref(std))
    return mean.value, std.value
