"""Build the port's CUDA kernels with nvcc at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone into a
shared library, ``build/kernels/<name>-<hash>.so`` at the root of the
checkout (a directory git ignores); the hash covers the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
Sources build in parallel, one nvcc process each.  The libraries are loaded
with ctypes; nothing here includes PyTorch's headers, so a build takes
seconds.

Nothing is compiled or loaded at import time: the CPU tests import every
module, and this host may have no nvcc.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE_DIR = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_loaded = {}


def kernel_names():
    return sorted(p.stem for p in SOURCE_DIR.glob('*.cu'))


def _nvcc():
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and (Path(cand) / 'bin' / 'nvcc').exists():
            return str(Path(cand) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on '
                           'PATH); the CUDA kernels cannot be built')
    return found


def library_path(name) -> Path:
    src = (SOURCE_DIR / f'{name}.cu').read_bytes()
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'{name}-{digest[:16]}.so'


def build(names=None):
    """Compile every named source whose library is missing, all nvcc
    processes at once.  Returns {name: (seconds, compiler log)} for the
    sources it compiled; raises RuntimeError naming the first failure."""
    names = kernel_names() if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(SOURCE_DIR / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'{name}: nvcc exited {proc.returncode}\n{log}')
            continue
        os.replace(tmp, out)
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return done


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
