"""Port parity for the data path's extras: the native JPEG decode, YUV420
staging, the on-disk staging cache and the device-resident dataset's epoch
order, against the JAX package on the same inputs.

The JPEG inputs are the committed fixtures
(``single_shot_detection_tpu_torch/data/jpeg_fixtures``: 16 VOC-like JPEGs,
one grayscale), staged at sizes that make libjpeg decode at the full, 1/2,
1/4 and 1/8 DCT scales.  Tolerances: every staged byte, size, box, mask and
id exactly equal; ``yuv420_to_rgb`` exactly equal to JAX's (no value off by
one at any size tried); the yuv420 ``Pipeline`` outputs within 1e-4 on the
0-255 scale of JAX's (the RGB pipeline's own tolerance at these ops: the
reconstructed images are bit-equal, so what is left is the chain's float
arithmetic) with masks equal and boxes within 1e-4 px.
"""

import json
import logging
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_shot_detection_tpu.data import datasets as jax_datasets
from single_shot_detection_tpu.data import native as jax_native
from single_shot_detection_tpu.data import transforms as jt
from single_shot_detection_tpu.data.device_cache import \
    DeviceDatasetCache as JaxDeviceCache
from single_shot_detection_tpu.data.loader import Loader as JaxLoader
from single_shot_detection_tpu_torch.data import datasets as pt_datasets
from single_shot_detection_tpu_torch.data import native
from single_shot_detection_tpu_torch.data import transforms as pt
from single_shot_detection_tpu_torch.data.cache import StagingCache
from single_shot_detection_tpu_torch.data.device_cache import (
    DeviceDatasetCache, budget, make_device_cache)
from single_shot_detection_tpu_torch.data.loader import Loader, create_loaders

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / 'single_shot_detection_tpu_torch' / 'data' / 'jpeg_fixtures'
# staging sizes at which the fixtures (300-640 px) decode at libjpeg's
# full, 1/2, 1/4 and 1/8 DCT scales, and an uneven one
STAGING = {'full': (300, 300), 'half': (160, 160), 'quarter': (64, 64),
           'eighth': (40, 40), 'uneven': (128, 96)}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    processes, and torch's default of one thread per core makes them
    contend for the CPU, tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def voc(module, image_set='all'):
    return module.Voc(str(FIXTURES), [(2007, image_set)])


def fixture_paths():
    return [a['image_path'] for a in voc(pt_datasets).annotations]


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_fixtures_are_as_documented():
    """16 JPEGs at VOC-like sizes, one grayscale, every box inside its
    image; the train and eval image sets list 256 and 64 entries."""
    from PIL import Image
    ds = voc(pt_datasets)
    assert len(ds) == 16
    modes = []
    for ann in ds.annotations:
        with Image.open(ann['image_path']) as im:
            assert im.format == 'JPEG' and im.size == (ann['width'], ann['height'])
            modes.append(im.mode)
        boxes = ann['boxes']
        assert len(boxes) and (boxes[:, 2] < ann['width']).all()
        assert (boxes[:, 4] >= 1).all()
    assert modes.count('L') == 1 and modes.count('RGB') == 15
    assert len(voc(pt_datasets, 'train256')) == 256
    assert len(voc(pt_datasets, 'eval64')) == 64
    total = sum(os.path.getsize(p) for p in FIXTURES.rglob('*') if p.is_file())
    assert total < 400_000


# --------------------------------------------------- the JPEG batch fault

@pytest.mark.parametrize('colorspace', ['rgb', 'yuv420'])
@pytest.mark.parametrize('scale', list(STAGING))
def test_jpeg_loader_equals_jax(colorspace, scale):
    """The port's loader stages a JPEG dataset as the JAX loader does, bit
    for bit: the DCT-scaled native decode wherever JAX takes it
    (the port decoded with PIL and its own resize before, 64.6 % of the
    bytes off by up to 5 at 300x300)."""
    size = STAGING[scale]
    before = native.COUNTS['native']
    got = list(Loader(voc(pt_datasets), 5, size, shuffle=True,
                      staging_colorspace=colorspace))
    want = list(JaxLoader(voc(jax_datasets), 5, size, shuffle=True,
                          staging_colorspace=colorspace))
    assert_batches_equal(got, want)
    assert native.COUNTS['native'] - before == 16
    if colorspace == 'yuv420':
        assert got[0]['image'].shape == (5, size[0] * size[1] * 3 // 2)


def write_png_named_jpg(path, seed=3, w=90, h=70):
    """A PNG file under a ``.jpg`` name: libjpeg refuses it, PIL reads it."""
    from PIL import Image
    pixels = np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)
    Image.fromarray(pixels).save(path, format='PNG')


def csv_dataset(module, tmp_path, paths):
    rows = [f'{p},5,6,40,50,dog' for p in paths]
    (tmp_path / 'set.csv').write_text('\n'.join(rows) + '\n')
    return module.Csv(str(tmp_path / 'set.csv'), labels=['background', 'dog'])


@pytest.mark.parametrize('colorspace', ['rgb', 'yuv420'])
def test_mixed_dataset_takes_each_path_as_jax_does(colorspace, tmp_path):
    """A batch with a non-JPEG path decodes in Python whole, a batch of
    JPEGs natively, and a JPEG the native decoder fails on (a PNG named
    ``.jpg``) per sample in Python: all equal to JAX's loader."""
    from PIL import Image
    jpegs = fixture_paths()
    png = tmp_path / 'plain.png'
    Image.open(jpegs[3]).save(png)
    bad = tmp_path / 'not_really.jpg'
    write_png_named_jpg(bad)
    # batches of 4: [3 JPEGs + the PNG], [4 JPEGs], [3 JPEGs + the bad one]
    paths = jpegs[:3] + [str(png)] + jpegs[3:7] + jpegs[7:10] + [str(bad)]
    counts = dict(native.COUNTS)
    got = list(Loader(csv_dataset(pt_datasets, tmp_path, paths), 4, (96, 96),
                      staging_colorspace=colorspace))
    want = list(JaxLoader(csv_dataset(jax_datasets, tmp_path, paths), 4,
                          (96, 96), staging_colorspace=colorspace))
    assert_batches_equal(got, want)
    assert native.COUNTS['native'] - counts.get('native', 0) == 7
    assert native.COUNTS['python'] - counts.get('python', 0) == 5


# -------------------------------------------------------- native decode

@pytest.mark.parametrize('threads', [1, 8])
def test_native_decode_equals_jax(threads, tmp_path):
    """``decode_batch_into`` and ``decode_batch_into_yuv420`` equal the JAX
    package's bindings of the committed library bit for bit; a slot that
    fails to decode is zeroed with size 0."""
    bad = tmp_path / 'bad.jpg'
    write_png_named_jpg(bad)
    paths = fixture_paths() + [str(bad)]
    n = len(paths)
    for size in ((300, 300), (64, 48)):
        w, h = size
        got = np.full((n, h, w, 3), 7, np.uint8)
        want = np.full((n, h, w, 3), 7, np.uint8)
        sizes = native.decode_batch_into(paths, got, num_threads=threads)
        np.testing.assert_array_equal(
            sizes, jax_native.decode_batch_into(paths, want, num_threads=threads))
        np.testing.assert_array_equal(got, want)
        assert (sizes[-1] == 0).all() and not got[-1].any()
        assert (sizes[:-1] == [(a['width'], a['height']) for a in
                               voc(pt_datasets).annotations]).all()
        got = np.zeros((n, w * h * 3 // 2), np.uint8)
        want = np.zeros_like(got)
        np.testing.assert_array_equal(
            native.decode_batch_into_yuv420(paths, got, size, num_threads=threads),
            jax_native.decode_batch_into_yuv420(paths, want, size,
                                                num_threads=threads))
        np.testing.assert_array_equal(got, want)
    assert native.decode_batch_into_yuv420(paths, got, (63, 48)) is None
    assert native.decode_batch_into(paths[:1] + [str(tmp_path / 'x.png')],
                                    np.zeros((2, 8, 8, 3), np.uint8)) is None


def test_library_is_the_ports_own_build():
    """The port builds its own copy of the decoder into ``kernels/build/``
    (the same source as the JAX package's ``native/decode.cpp``) and loads
    no file of ``native/``, with the JAX package blocked."""
    assert native.SOURCE.read_bytes() == (REPO / 'native' / 'decode.cpp').read_bytes()
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack',\n"
        "             'single_shot_detection_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from single_shot_detection_tpu_torch.data import native\n"
        "assert native.get_library() is not None, native.error\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(sorted({l.split()[-1] for l in maps.splitlines()\n"
        "              if 'decode' in l.split()[-1]}))\n")
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = eval(proc.stdout.strip())  # noqa: S307 — a list of paths
    assert len(loaded) == 1
    assert '/single_shot_detection_tpu_torch/kernels/build/libdecode-' in loaded[0]


def test_unavailable_library_warns_once_and_decodes_in_python(monkeypatch,
                                                              caplog):
    """Without the library the loader decodes every batch in Python, after
    one warning that names the build's error."""
    from single_shot_detection_tpu_torch.kernels import _build

    def no_compiler(*args, **kwargs):
        raise RuntimeError('g++ failed: jpeglib.h: No such file')

    monkeypatch.setattr(_build, 'build_host', no_compiler)
    monkeypatch.setattr(native, '_TRIED', False)
    monkeypatch.setattr(native, '_LIB', None)
    monkeypatch.setattr(native, 'error', None)
    before = dict(native.COUNTS)
    with caplog.at_level(logging.WARNING):
        batches = list(Loader(voc(pt_datasets), 8, (64, 64)))
    warnings = [r.message for r in caplog.records if 'native JPEG' in r.message]
    assert len(warnings) == 1 and 'jpeglib.h' in warnings[0]
    assert native.error.startswith('g++ failed')
    assert native.COUNTS['python'] - before.get('python', 0) == 16
    assert native.COUNTS['native'] == before.get('native', 0)
    assert len(batches) == 2


# ------------------------------------------------------------------ YUV

def test_rgb_to_yuv420_equals_jax():
    rng = np.random.RandomState(5)
    for h, w in ((2, 2), (48, 64), (300, 300), (6, 10)):
        img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(native.rgb_to_yuv420(img),
                                      jax_native.rgb_to_yuv420(img))


@pytest.mark.parametrize('size', [(2, 2), (10, 6), (64, 48), (300, 300),
                                  (512, 512)], ids=str)
def test_yuv420_to_rgb_equals_jax(size):
    """The chroma upsample (``F.interpolate`` bilinear, half-pixel centres)
    has ``jax.image.resize``'s linear weights at 2x, edges included, and
    the matrix rounds alike: exact at every size tried, on random planes
    and on the fixtures' native YUV."""
    w, h = size
    packed = np.random.RandomState(w + h).randint(
        0, 256, (3, w * h * 3 // 2), dtype=np.uint8)
    got = pt.yuv420_to_rgb(torch.from_numpy(packed), size)
    want = np.asarray(jt.yuv420_to_rgb(jnp.asarray(packed), size))
    assert got.dtype == torch.uint8 and got.shape == (3, h, w, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_yuv420_to_rgb_of_staged_fixtures_equals_jax():
    batch = next(iter(Loader(voc(pt_datasets), 16, (300, 300),
                             staging_colorspace='yuv420')))['image']
    np.testing.assert_array_equal(
        pt.yuv420_to_rgb(torch.from_numpy(batch), (300, 300)).numpy(),
        np.asarray(jt.yuv420_to_rgb(jnp.asarray(batch), (300, 300))))


SMOKE_AUGMENTATIONS = [
    {'name': 'RandomAdjustBrightness', 'args': {'max_brightness_delta': 0.1}},
    {'name': 'RandomHorizontalFlip'},
]
PREPROCESSING = [
    {'name': 'ToFloatTensor', 'args': {'normalize': True}},
    {'name': 'Normalize',
     'args': {'mean': [0.485, 0.456, 0.406], 'std': [0.229, 0.224, 0.225]}},
]
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def jax_draws(stages, rng, batch):
    """The draws JAX's ``Pipeline._run_batch(rng, ...)`` takes for the
    brightness and flip stages (one key per image, one per stage)."""
    def one(key):
        out = []
        for k, (kind, kw) in zip(jax.random.split(key, len(stages)), stages):
            if kind == 'brightness':
                k1, k2 = jax.random.split(k)
                d = kw['max_delta']
                out.append({'delta': jax.random.uniform(k1, (), minval=-d,
                                                        maxval=d),
                            'u': jax.random.uniform(k2)})
            else:
                assert kind == 'hflip'
                out.append({'u': jax.random.uniform(k)})
        return out
    draws = jax.jit(jax.vmap(one))(jax.random.split(rng, batch))
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), draws)


def test_yuv_pipelines_equal_jax():
    """The train (brightness, flip) and eval ``Pipeline`` on a yuv420 batch
    of the fixtures (staged at 64, out at 48) against JAX's with its draws
    injected."""
    loader = Loader(voc(pt_datasets), 16, (64, 64), staging_colorspace='yuv420')
    batch = next(iter(loader))
    images, boxes, mask = batch['image'], batch['boxes'], batch['box_mask']
    rng = jax.random.PRNGKey(9)
    for train in (True, False):
        augs = SMOKE_AUGMENTATIONS if train else ()
        want_pipe = jt.Pipeline(augs, PREPROCESSING, (48, 48), train=train,
                                staging_yuv=(64, 64))
        want = want_pipe(rng, images, boxes, mask)
        port = pt.Pipeline(augs, PREPROCESSING, (48, 48), train=train,
                           staging_yuv=(64, 64))
        assert port.stages == want_pipe.stages
        draws = jax_draws(want_pipe.stages, rng, 16) if train else []
        if train:
            assert (draws[1]['u'] < 0.5).any() and (draws[1]['u'] >= 0.5).any()
        got = port.apply(draws, torch.from_numpy(images),
                         torch.from_numpy(boxes), torch.from_numpy(mask))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(
            (got[0].numpy().transpose(0, 2, 3, 1) * STD + MEAN) * 255,
            (np.asarray(want[0]) * STD + MEAN) * 255, rtol=0, atol=1e-4)


def test_loader_checks_the_colour_space():
    ds = voc(pt_datasets)
    with pytest.raises(ValueError, match='even staging dims'):
        Loader(ds, 2, (63, 64), staging_colorspace='yuv420')
    with pytest.raises(ValueError, match='expected'):
        Loader(ds, 2, (64, 64), staging_colorspace='yuv444')


# -------------------------------------------------------- staging cache

@pytest.mark.parametrize('colorspace', ['rgb', 'yuv420'])
def test_cached_loader_equals_uncached(colorspace, tmp_path):
    """Two shuffled epochs through a cache (the first fills it, the second
    reads every record) equal two without it; every record is then
    valid."""
    size = (96, 64)
    plain = Loader(voc(pt_datasets), 5, size, shuffle=True,
                   staging_colorspace=colorspace)
    cached = Loader(voc(pt_datasets), 5, size, shuffle=True,
                    staging_colorspace=colorspace, cache_dir=str(tmp_path))
    for epoch in range(2):
        counts = dict(native.COUNTS)
        assert_batches_equal(list(cached), list(plain))
        decoded = (native.COUNTS['native'] - counts.get('native', 0)
                   + native.COUNTS['python'] - counts.get('python', 0))
        assert decoded == (32 if epoch == 0 else 16)  # plain always decodes
    assert cached.cache.complete and cached.cache.hit_count == 16


def fill(loader):
    for _ in loader:
        pass
    loader.cache.flush()


def listing(path):
    return {p.name: p.stat().st_mtime_ns for p in Path(path).iterdir()}


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_cache_directories_cross_between_packages(writer, tmp_path, caplog):
    """A cache that one package's loader wrote is read by the other's with
    no rebuild (same meta, fingerprint and files), and gives its batches."""
    make = {'jax': lambda: JaxLoader(voc(jax_datasets), 8, (64, 64),
                                     staging_colorspace='yuv420',
                                     cache_dir=str(tmp_path)),
            'port': lambda: Loader(voc(pt_datasets), 8, (64, 64),
                                   staging_colorspace='yuv420',
                                   cache_dir=str(tmp_path))}
    reader = 'port' if writer == 'jax' else 'jax'
    first = make[writer]()
    fill(first)
    written = listing(tmp_path)
    meta = json.loads((tmp_path / 'meta.json').read_text())
    with caplog.at_level(logging.WARNING):
        second = make[reader]()
    assert not [r for r in caplog.records if 'staging cache' in r.message]
    assert listing(tmp_path) == written
    assert json.loads((tmp_path / 'meta.json').read_text()) == meta
    assert second.cache.complete
    counts = dict(native.COUNTS)
    got = list(second)
    assert native.COUNTS == counts  # nothing decoded: every record read
    assert_batches_equal(got, list(make[writer]()))


def test_stale_cache_is_rebuilt(tmp_path, caplog):
    """A cache of another staging size is discarded with a warning and
    rebuilt; its batches are then the fresh staging's."""
    fill(Loader(voc(pt_datasets), 8, (64, 64), cache_dir=str(tmp_path)))
    with caplog.at_level(logging.WARNING):
        loader = Loader(voc(pt_datasets), 8, (96, 64), cache_dir=str(tmp_path))
    assert [r for r in caplog.records if 'does not match' in r.message]
    assert loader.cache.hit_count == 0
    assert_batches_equal(list(loader),
                         list(Loader(voc(pt_datasets), 8, (96, 64))))
    loader.cache.flush()
    assert StagingCache(str(tmp_path), voc(pt_datasets), (96, 64)).complete


def test_create_loaders_caches_each_phase(tmp_path):
    loaders = create_loaders({'train': voc(pt_datasets), 'eval': voc(pt_datasets)},
                             4, (64, 64), cache_dir=str(tmp_path))
    assert {p: l.cache.directory for p, l in loaders.items()} == {
        p: str(tmp_path / p) for p in ('train', 'eval')}


# --------------------------------------------------------- device cache

def synthetic(module, n):
    return module.Synthetic(num_images=n, image_size=32, num_classes=5,
                            max_boxes=3, seed=4)


@pytest.mark.parametrize('fused_k, num_batches', [(1, None), (2, None), (2, 5),
                                                  (1, 3)])
def test_epoch_batches_equal_jax(fused_k, num_batches):
    """The cache's epochs (shuffled, ``drop_last`` with 2 rows cut, chunks
    of ``fused_k`` with a shorter remainder, the ``num_batches`` cap) give
    what JAX's ``DeviceDatasetCache`` gives, batch for batch; and what the
    streamed loader gives."""
    kwargs = dict(batch_size=4, staging_size=(32, 32), shuffle=True,
                  drop_last=True, max_gt=5)
    jax_loader = JaxLoader(synthetic(jax_datasets, 30), **kwargs)
    port_loader = Loader(synthetic(pt_datasets, 30), **kwargs)
    jax_cache = JaxDeviceCache(jax_loader)
    port_cache = DeviceDatasetCache(port_loader, torch.device('cpu'),
                                    budget(True))
    for batch in jax_loader:
        jax_cache.observe(batch)
    for batch in port_loader:
        port_cache.observe(batch)
    jax_cache.finalize(jax_loader, jax.device_put)
    port_cache.finalize(port_loader)
    assert port_cache.topped_up == 2
    for epoch in (1, 2):
        want = list(jax_cache.epoch_batches(jax_loader, epoch, fused_k,
                                            num_batches))
        got = list(port_cache.epoch_batches(port_loader, epoch, fused_k,
                                            num_batches))
        assert [k for k, _ in got] == [k for k, _ in want]
        port_loader.epoch = epoch
        streamed = list(port_loader)[:num_batches]
        flat = [t for kind, b in got for t in (b if kind == 'fused' else [b])]
        assert len(flat) == len(streamed) == (num_batches or 7)
        for (kind, g), (_, w) in zip(got, want):
            g = [g] if kind == 'single' else g
            for i, tensors in enumerate(g):
                for key, t in zip(('image', 'boxes', 'box_mask'), tensors):
                    ref = np.asarray(w[key])
                    np.testing.assert_array_equal(
                        t.numpy(), ref[i] if kind == 'fused' else ref)
        for tensors, batch in zip(flat, streamed):
            for key, t in zip(('image', 'boxes', 'box_mask'), tensors):
                np.testing.assert_array_equal(t.numpy(), batch[key])


def test_finalize_tops_up_the_rows_drop_last_cut():
    """The fill epoch of 30 images at b8 yields 24 rows; finalize stages the
    6 others itself, and every record equals the loader's own staging."""
    loader = Loader(synthetic(pt_datasets, 30), 8, (32, 32), shuffle=True,
                    drop_last=True, max_gt=5)
    cache = DeviceDatasetCache(loader, torch.device('cpu'), budget(True))
    seen = []
    for batch in loader:
        cache.observe(batch)
        seen.extend(batch['ids'])
    assert len(seen) == 24 and not cache.seen.all()
    cache.finalize(loader)
    assert cache.ready and cache.topped_up == 6
    with ThreadPoolExecutor(2) as pool:
        want = Loader(synthetic(pt_datasets, 30), 30, (32, 32),
                      max_gt=5)._make_batch(np.arange(30), pool)
    for key in ('image', 'boxes', 'box_mask'):
        np.testing.assert_array_equal(cache.device[key].numpy(), want[key])


def test_over_budget_falls_back_to_streaming(caplog):
    loader = Loader(synthetic(pt_datasets, 30), 8, (32, 32), drop_last=True,
                    max_gt=5)
    record = 32 * 32 * 3 + 5 * 7 * 4 + 5
    assert budget(True) == 4 << 30 and budget({'max_bytes': 7}) == 7
    assert make_device_cache(loader, None, torch.device('cpu')) is None
    fits = make_device_cache(loader, {'max_bytes': 30 * record},
                             torch.device('cpu'))
    assert fits is not None and fits.total_bytes == 30 * record
    with caplog.at_level(logging.WARNING):
        assert make_device_cache(loader, {'max_bytes': 30 * record - 1},
                                 torch.device('cpu')) is None
    assert [r for r in caplog.records if 'falling back to host streaming'
            in r.message]
    assert make_device_cache(loader, True, torch.device('cpu')).total_bytes \
        == JaxDeviceCache(JaxLoader(synthetic(jax_datasets, 30), 8, (32, 32),
                                    drop_last=True, max_gt=5)).total_bytes


def test_stage_dataset_tool_fills_a_cache_the_loader_reads(tmp_path):
    """``tools/stage_dataset.py`` on a config of the fixtures fills each
    phase's cache; a loader then stages nothing and gives the plain
    loader's batches."""
    from single_shot_detection_tpu_torch.tools import stage_dataset
    voc_set = {'name': 'Voc', 'root': str(FIXTURES), 'image_sets': [(2007, 'all')]}
    config = tmp_path / 'fixtures.py'
    config.write_text(
        f'input_size = (96, 96)\n'
        f"dataset = {{'train': {voc_set!r}, 'eval': {voc_set!r}}}\n"
        f"train = {{'staging_colorspace': 'yuv420'}}\n")
    cache = tmp_path / 'cache'
    assert stage_dataset.main(['--config', str(config), '--cache-dir',
                               str(cache), '--batch-size', '6']) == 0
    loader = Loader(voc(pt_datasets), 8, (96, 96), staging_colorspace='yuv420',
                    cache_dir=str(cache / 'train'))
    assert loader.cache.complete
    counts = dict(native.COUNTS)
    got = list(loader)
    assert native.COUNTS == counts
    assert_batches_equal(got, list(Loader(voc(pt_datasets), 8, (96, 96),
                                          staging_colorspace='yuv420')))
