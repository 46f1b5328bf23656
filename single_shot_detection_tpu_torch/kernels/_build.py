"""Build the CUDA kernels from the sources in this directory.

Each ``<name>.cu`` has a plain C interface and is compiled by ``nvcc`` into
``build/lib<name>-<hash>.so`` beside it (the directory is git-ignored), then
loaded with ``ctypes``.  The hash covers the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.  The build happens
at first use, never when a module is imported.  A failed build raises: there
is no fallback to the plain PyTorch version on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / 'build'

# sm_90a: Hopper with its architecture-specific features.  --fmad=false keeps
# the arithmetic bit-identical to the plain PyTorch versions; never
# --use_fast_math.
NVCC_FLAGS = ('-gencode=arch=compute_90a,code=sm_90a', '-O3', '-std=c++17',
              '--fmad=false', '-shared', '-Xcompiler', '-fPIC')


def find_nvcc() -> str:
    for candidate in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError('nvcc not found: the CUDA kernels are built from '
                       'source at first use and need the CUDA toolkit')


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{source.stem}-{digest}.so'


def build(name: str) -> Path:
    """Compile ``<name>.cu`` of this directory unless an up-to-date library
    exists; return its path."""
    return build_source(KERNEL_DIR / f'{name}.cu')


def build_source(source: Path) -> Path:
    """Compile the CUDA source file ``source`` (this directory's or another
    checkout's) into the build directory unless an up-to-date library
    exists; return the library's path."""
    source = Path(source).resolve()
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, '-o', tmp, str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {source} '
                               f'(exit {proc.returncode}):\n{proc.stderr}')
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library ``<name>``."""
    return ctypes.CDLL(str(build(name)))
