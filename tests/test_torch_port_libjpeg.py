"""The native JPEG decoder's two builds (``data/native.py``): ``'system'``
(``-ljpeg`` where the compiler finds ``jpeglib.h``) and ``'vendored'`` (the
libjpeg-turbo headers in ``native/include/`` and Pillow's bundled
``libjpeg-*.so.62*``), held to the committed digest of the JPEG fixtures'
staged batches (``data/jpeg_fixtures/staged_sha256.json``: RGB and
YUV420 at 300, 150, 64 and 38 px, written by ``tools/make_jpeg_fixtures.py
--digest`` from the JAX package's ``native/libssd_decode.so``), which this
file recomputes from that library.  Tolerance: none, the digests are
sha256 of the bytes.
"""

import json
import os
import subprocess
import sys

import pytest

from single_shot_detection_tpu.data import native as jax_native
from single_shot_detection_tpu_torch.data import native
from single_shot_detection_tpu_torch.kernels import _build
from single_shot_detection_tpu_torch.tools import make_jpeg_fixtures
from _torch_port_fixtures import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def committed() -> dict:
    return json.loads(make_jpeg_fixtures.DIGEST_FILE.read_text())


def test_digest_is_the_jax_librarys():
    """The committed digest is what the JAX package's library stages, at
    every mode and size."""
    lib = jax_native.get_library()
    assert lib is not None
    digests = make_jpeg_fixtures.staged_digests(lib)
    assert sorted(digests) == sorted(
        f'{kind}_{s}' for kind in ('rgb', 'yuv420')
        for s in make_jpeg_fixtures.DIGEST_SIZES)
    assert digests == committed()


@pytest.mark.parametrize('route', native.ROUTES)
def test_each_build_stages_the_digest(route):
    """Each route's build, alone in a fresh process with the JAX package
    blocked, stages the fixtures to the committed digest, linked against
    its own libjpeg: Pillow's for ``'vendored'``, the system's for
    ``'system'``."""
    code = (
        "import json, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack',\n"
        "             'single_shot_detection_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from single_shot_detection_tpu_torch.data import native\n"
        "from single_shot_detection_tpu_torch.tools import make_jpeg_fixtures\n"
        f"lib = native.load({route!r})\n"
        "digests = make_jpeg_fixtures.staged_digests(lib)\n"
        "maps = open('/proc/self/maps').read().splitlines()\n"
        "jpeg = sorted({l.split()[-1] for l in maps if 'libjpeg' in l})\n"
        "print(json.dumps({'digests': digests, 'libjpeg': jpeg}))\n")
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out['digests'] == committed()
    assert out['libjpeg']
    bundled = [p for p in out['libjpeg'] if '/pillow.libs/' in p]
    assert bundled == (out['libjpeg'] if route == 'vendored' else [])


def test_a_header_change_changes_the_build(tmp_path):
    """The build's name hashes the headers' bytes (not where they are), so
    an edited header never reuses a library built against the old one."""
    libs, headers = native.build_args('vendored')
    path = _build.host_library_path(native.SOURCE, libs, headers)
    copies = []
    for h in headers:
        copy = tmp_path / h.name
        copy.write_bytes(h.read_bytes())
        copies.append(copy)
    assert _build.host_library_path(native.SOURCE, libs, copies) == path
    edited = tmp_path / 'jconfig.h'
    edited.write_bytes(edited.read_bytes() + b'\n/* edited */\n')
    assert _build.host_library_path(native.SOURCE, libs, copies) != path
    assert (_build.host_library_path(native.SOURCE, native.LIBS)
            != path != _build.host_library_path(native.SOURCE, libs))


@pytest.mark.parametrize('has_header', [True, False], ids=['system', 'vendored'])
def test_the_loader_takes_the_route_the_compiler_allows(monkeypatch, has_header):
    """``get_library`` links ``-ljpeg`` where ``jpeglib.h`` is found and
    builds against the vendored headers otherwise, and says which."""
    assert native.system_has_jpeglib()  # this machine has the headers
    assert native.pillow_libjpeg().name.startswith('libjpeg')
    monkeypatch.setattr(native, 'system_has_jpeglib', lambda: has_header)
    for name, value in (('_TRIED', False), ('_LIB', None), ('error', None),
                        ('route', None)):
        monkeypatch.setattr(native, name, value)
    assert native.get_library() is not None, native.error
    assert native.route == ('system' if has_header else 'vendored')
