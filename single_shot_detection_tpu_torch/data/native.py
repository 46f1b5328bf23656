"""ctypes bindings of the C++ batch JPEG decoder (``native/decode.cpp``).

Port of the JAX package's ``data/native.py``.  The decoder decodes a batch
of JPEG files on a thread pool with libjpeg and writes each straight into
one preallocated staging buffer: RGB ``[B, H, W, 3]`` after a bilinear
resize of its own, or packed planar YUV420 ``[B, H*W*3/2]``.  libjpeg
always decodes at the smallest DCT scale (1/8, 1/4, 1/2 or 1) whose output
still covers the staging size, and the resize does the rest: the C entry
points' ``fast_scale`` flag is passed as 1, the only value the JAX loader
uses.  The loader
(``data/loader.py``) takes this path exactly where the JAX loader does, for
a batch whose every path is a ``.jpg``/``.jpeg``, so the port's JPEG
batches equal the JAX package's bit for bit.

The library is the port's own copy of the source, built at first use with
``native/Makefile``'s flags (``kernels/_build.py::build_host``: ``g++
-shared -O3 -march=native``) into the git-ignored ``kernels/build/``;
never at import, never into the JAX package's ``native/``.  Two routes
(:func:`build_args`), chosen by what the compiler finds: ``'system'``
links ``-ljpeg -lpthread`` where ``jpeglib.h`` is on its include path;
``'vendored'`` compiles against the four libjpeg-turbo 2.1.5 headers in
``native/include/`` (ABI 62, with their licence) and links Pillow's
bundled ``pillow.libs/libjpeg-*.so.62*`` by its path, with an rpath to
its directory, on a machine with no libjpeg headers.  Both stage the
committed fixtures to the same bytes (``tools/make_jpeg_fixtures.py``'s
digest).  :data:`route` says which was taken.  When neither builds or
loads, a warning with the build's error is logged once and the loader
decodes with PIL, as the JAX loader does without its library (its batches
then differ from the native path's: another decoder and resize).
:data:`COUNTS` counts the images each path staged (``'python'`` includes
datasets of inline images, which only stage).
"""

from __future__ import annotations

import collections
import ctypes
import logging
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / 'native' / 'decode.cpp'
LIBS = ('-ljpeg', '-lpthread')
INCLUDE_DIR = SOURCE.parent / 'include'
HEADERS = tuple(INCLUDE_DIR / name for name in
                ('jpeglib.h', 'jconfig.h', 'jmorecfg.h', 'jerror.h'))
ROUTES = ('system', 'vendored')

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()
# why the library is unavailable (the build's or the loader's message)
error: Optional[str] = None
# the route the loaded library was built by (:data:`ROUTES`)
route: Optional[str] = None
# images staged by the native library and by the Python path
COUNTS: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()


def count(path: str, n: int) -> None:
    """Add ``n`` images to ``COUNTS[path]`` (``'native'`` or ``'python'``)."""
    with _COUNT_LOCK:
        COUNTS[path] += n


def is_jpeg(path: str) -> bool:
    return path.lower().endswith(('.jpg', '.jpeg'))


def system_has_jpeglib() -> bool:
    """True when the C++ compiler finds ``jpeglib.h`` on its own include
    path."""
    cxx = shutil.which('g++') or shutil.which('c++')
    if not cxx:
        return False
    proc = subprocess.run([cxx, '-E', '-x', 'c++', '-', '-o', '/dev/null'],
                          input='#include <cstdio>\n#include <jpeglib.h>\n',
                          capture_output=True, text=True)
    return proc.returncode == 0


def pillow_libjpeg() -> Path:
    """Pillow's bundled libjpeg (``pillow.libs/libjpeg-<hash>.so.62*``,
    the hash differing between Pillow builds), found from ``PIL.__file__``;
    ``RuntimeError`` where Pillow bundles none."""
    import PIL
    libs = Path(PIL.__file__).resolve().parent.parent / 'pillow.libs'
    found = sorted(libs.glob('libjpeg*.so.62*'))
    if not found:
        raise RuntimeError(f'no jpeglib.h on the include path and no '
                           f'libjpeg*.so.62* in {libs}')
    return found[0]


def build_args(which: str) -> Tuple[Tuple[str, ...], Tuple[Path, ...]]:
    """``(libs, headers)`` of ``build_host`` for a route of :data:`ROUTES`."""
    if which == 'system':
        return LIBS, ()
    if which != 'vendored':
        raise ValueError(f'unknown route {which!r} (routes: {ROUTES})')
    lib = pillow_libjpeg()
    return (str(lib), f'-Wl,-rpath,{lib.parent}', '-lpthread'), HEADERS


def set_argtypes(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the decoder's two batch entry points on ``lib``."""
    lib.decode_batch.restype = ctypes.c_int
    lib.decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
    ]
    lib.decode_batch_yuv420.restype = ctypes.c_int
    lib.decode_batch_yuv420.argtypes = lib.decode_batch.argtypes
    return lib


def load(which: str) -> ctypes.CDLL:
    """Build (unless built) and load the decoder by route ``which``."""
    from single_shot_detection_tpu_torch.kernels import _build
    libs, headers = build_args(which)
    return set_argtypes(ctypes.CDLL(str(_build.build_host(SOURCE, libs,
                                                          headers))))


def get_library() -> Optional[ctypes.CDLL]:
    """The decoder's library, built and loaded at the first call by the
    route the compiler allows; None when that failed (logged once, the
    reason in :data:`error`)."""
    global _LIB, _TRIED, error, route
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        which = 'system' if system_has_jpeglib() else 'vendored'
        try:
            _LIB = load(which)
            route = which
            logging.info(f'===> native decode library loaded ({which}: '
                         + ('-ljpeg' if which == 'system' else
                            f'native/include headers, {pillow_libjpeg().name}')
                         + ')')
        except (OSError, RuntimeError, AttributeError) as exc:
            error = str(exc).strip()
            logging.warning(f'WW native JPEG decode unavailable ({which} '
                            f'route: {error}); '
                            'JPEGs decode with PIL, whose staged pixels '
                            'differ from the native path\'s')
        return _LIB


def _call(fn, paths: List[str], out: np.ndarray, w: int, h: int,
          num_threads: int) -> Tuple[int, np.ndarray]:
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    sizes = np.zeros((len(paths), 2), np.int32)
    rc = fn(arr, len(paths), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            w, h, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            num_threads, 1)
    return rc, sizes


def decode_batch_into(paths: List[str], out: np.ndarray,
                      num_threads: int = 8) -> Optional[np.ndarray]:
    """Decode and stage JPEGs into ``out [B, H, W, 3]`` uint8 (B at least
    ``len(paths)``).  Returns each image's original (w, h) as ``[n, 2]``
    int32, or None when the library is unavailable or a path is not a
    JPEG.  A slot that failed to decode is zeroed with size 0: the caller
    stages it another way."""
    lib = get_library()
    if lib is None or not all(is_jpeg(p) for p in paths):
        return None
    b, h, w, _ = out.shape
    assert len(paths) <= b and out.dtype == np.uint8 and out.flags.c_contiguous
    return _call(lib.decode_batch, paths, out, w, h, num_threads)[1]


def decode_batch_into_yuv420(paths: List[str], out: np.ndarray,
                             size: Tuple[int, int],
                             num_threads: int = 8) -> Optional[np.ndarray]:
    """Decode and stage JPEGs as packed planar YUV420 into ``out [B,
    H*W*3//2]``: per slot the Y plane at (h, w), then Cb and Cr at (h/2,
    w/2).  ``size`` is the staging (w, h), both even.  Returns as
    :func:`decode_batch_into` (None also for odd sizes)."""
    lib = get_library()
    if lib is None or not all(is_jpeg(p) for p in paths):
        return None
    w, h = size
    if (w % 2) or (h % 2):
        return None
    assert out.dtype == np.uint8 and out.flags.c_contiguous
    assert out.shape[0] >= len(paths) and out.shape[1] == w * h * 3 // 2
    rc, sizes = _call(lib.decode_batch_yuv420, paths, out, w, h, num_threads)
    return None if rc < 0 else sizes


def rgb_to_yuv420(img: np.ndarray) -> np.ndarray:
    """Staged RGB uint8 ``[H, W, 3]`` -> packed planar YUV420 (BT.601 full
    range, 2x2 mean chroma subsampling): the Python path's staging of what
    the native decoder cannot serve."""
    h, w = img.shape[:2]
    f = img.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b

    def sub(p):
        return p.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    parts = [np.clip(np.round(y), 0, 255).ravel(),
             np.clip(np.round(sub(cb)), 0, 255).ravel(),
             np.clip(np.round(sub(cr)), 0, 255).ravel()]
    return np.concatenate(parts).astype(np.uint8)
