"""Build the native preprocessing library (``preproc.cpp``) with g++.

    python -m neuron_gan_tpu_torch.runtime.build

The library goes to ``build/native/libngpreproc-<hash>.so`` at the root of
the checkout (a directory git ignores); the hash covers the source and the
flags, so an edited source is rebuilt and a stale library never loaded.
``native.py`` calls ``build`` at first use, never at import.
"""

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / 'preproc.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'
FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')


def compiler():
    """The g++ on PATH, or None."""
    return shutil.which('g++')


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + ' '.join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'libngpreproc-{digest[:16]}.so'


def build(verbose=False) -> Path:
    """Compile the library unless it exists; returns its path.  Raises
    RuntimeError when g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError('g++ not found: the native preprocessing library '
                           'cannot be built')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [cxx, *FLAGS, str(SOURCE), '-o', str(tmp)]
    if verbose:
        print(' '.join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'g++ exited {proc.returncode}:\n{proc.stderr}')
    os.replace(tmp, out)   # atomic: a concurrent build never loads half a file
    return out


if __name__ == '__main__':
    print(f'built {build(verbose=True)}')
    sys.exit(0)
