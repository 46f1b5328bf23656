"""Build the CUDA kernels from the sources in this directory, and the host
JPEG decoder (``native/decode.cpp``).

Each ``<name>.cu`` has a plain C interface and is compiled by ``nvcc`` into
``build/lib<name>-<hash>.so`` beside it (the directory is git-ignored), then
loaded with ``ctypes``.  The hash covers the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.  The build happens
at first use, never when a module is imported.  A failed build raises: there
is no fallback to the plain PyTorch version on a CUDA tensor.

:func:`build_host` compiles a C++ source for the host CPU with ``g++
-shared`` into the same directory (``-march=native``: the hash also covers
this CPU's model and flags, so a build directory copied to another machine
is never loaded there).  Every build writes a temporary file and renames
it, so several processes building at once never see half a library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

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
    if not out.exists():
        _compile([find_nvcc(), *NVCC_FLAGS], source, (), out, 'nvcc')
    return out


# native/Makefile's flags for the host decoder
HOST_FLAGS = ('-O3', '-std=c++17', '-fPIC', '-Wall', '-march=native',
              '-shared')


def _host_cpu() -> str:
    """This CPU's identity for ``-march=native`` builds: the machine, and
    the model name and feature flags of its first processor."""
    lines = []
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith(('model name', 'flags', 'Features')):
                    lines.append(line.strip())
                if not line.strip() and lines:
                    break
    except OSError:
        pass
    return '|'.join([platform.machine(), *lines])


def host_library_path(source: Path, libs: Sequence[str] = (),
                      headers: Sequence[Path] = ()) -> Path:
    """Where :func:`build_host` puts its library: the hash covers the
    source, the flags, ``libs``, the bytes of each of ``headers`` and this
    CPU, so a changed header never reuses a stale build."""
    source = Path(source).resolve()
    key = (source.read_bytes() + ' '.join((*HOST_FLAGS, *libs)).encode()
           + b''.join(Path(h).name.encode() + Path(h).read_bytes()
                      for h in headers)
           + _host_cpu().encode())
    return BUILD_DIR / f'lib{source.stem}-{hashlib.sha256(key).hexdigest()[:16]}.so'


def build_host(source: Path, libs: Sequence[str] = (),
               headers: Sequence[Path] = ()) -> Path:
    """Compile the C++ source ``source`` for this CPU with ``g++ -shared``
    and ``HOST_FLAGS``, with ``-I`` to the directory of each of
    ``headers`` and linking ``libs`` (say ``('-ljpeg',)``), into the build
    directory unless an up-to-date library exists; return its path.
    Raises ``RuntimeError`` with the compiler's message when it fails."""
    source = Path(source).resolve()
    out = host_library_path(source, libs, headers)
    if not out.exists():
        cxx = shutil.which('g++') or shutil.which('c++')
        if not cxx:
            raise RuntimeError('no C++ compiler (g++) found')
        includes = [f'-I{d}' for d in
                    dict.fromkeys(str(Path(h).resolve().parent) for h in headers)]
        _compile([cxx, *HOST_FLAGS, *includes], source, libs, out,
                 Path(cxx).name)
    return out


def _compile(cmd: list, source: Path, libs: Sequence[str], out: Path,
             tool: str) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, '-o', tmp, str(source), *libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'{tool} failed for {source} '
                               f'(exit {proc.returncode}):\n{proc.stderr}')
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library ``<name>``."""
    return ctypes.CDLL(str(build(name)))
