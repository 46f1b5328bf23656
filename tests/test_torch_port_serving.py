"""Port parity and rules for the serving slice: preprocessing, the
``Predictor`` end to end, and the package's independence from JAX.

Tolerances: preprocessing atol 1e-5 against the JAX eval ``Pipeline``; end
to end on the committed checkpoint, ``valid`` masks equal and detections
within atol 1e-3 px of JAX ``make_predict_step`` plus the eval ``Pipeline``.
"""

import ast
import collections
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from single_shot_detection_tpu.data.datasets import Synthetic
from single_shot_detection_tpu.data.loader import stage_image
from single_shot_detection_tpu.data.transforms import (Pipeline, identity_state,
                                                      sample_view)
from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.ops.box_coder import BoxCoder
from single_shot_detection_tpu.ops.postprocess import Postprocessor
from single_shot_detection_tpu.train.step import make_predict_step
from single_shot_detection_tpu.utils.config import load_config as jax_load_config
from single_shot_detection_tpu_torch.data.preprocess import Preprocess, stage_images
from single_shot_detection_tpu_torch.predict import Predictor

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / 'single_shot_detection_tpu_torch'
CKPT_DIR = REPO / 'experiments/2026-08-16-225820'
PREPROCESSING = [
    {'name': 'ToFloatTensor', 'args': {'normalize': True}},
    {'name': 'Normalize',
     'args': {'mean': [0.485, 0.456, 0.406], 'std': [0.229, 0.224, 0.225]}},
]


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    processes, and torch's default of one thread per core makes them
    contend for the CPU, tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_eval_pipeline(images, input_size):
    pipe = Pipeline((), PREPROCESSING, input_size, train=False)
    b = len(images)
    x, _, _ = pipe(jax.random.PRNGKey(0), images, np.zeros((b, 1, 7), np.float32),
                   np.zeros((b, 1), bool))
    return np.asarray(x)


@pytest.fixture(scope='module')
def checkpoint():
    with open(CKPT_DIR / 'ckpt-1800.msgpack', 'rb') as f:
        ckpt = serialization.msgpack_restore(f.read())
    return {'params': ckpt['params'], 'batch_stats': ckpt['batch_stats']}


# ---------------------------------------------------------- preprocessing

def test_eval_sample_view_is_identity_at_input_size():
    """At eval the JAX pipeline's resample is the identity when the staged
    size equals the output size, so the port skips it."""
    img = np.random.RandomState(0).randint(0, 256, (64, 64, 3)).astype(np.float32)
    window = identity_state(64, 64, None, None)[:5]
    out = sample_view(jnp.asarray(img), window, (64, 64), jnp.zeros(3))
    np.testing.assert_array_equal(np.asarray(out), img)


@pytest.mark.parametrize('size', [300, 128])
def test_preprocess_matches_jax_eval_pipeline(size):
    images = np.random.RandomState(1).randint(0, 256, (2, size, size, 3),
                                              dtype=np.uint8)
    want = jax_eval_pipeline(images, (size, size))
    got = Preprocess(PREPROCESSING, (size, size))(torch.from_numpy(images))
    assert got.shape == (2, 3, size, size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=0, atol=1e-5)


def test_stage_images_resize_is_bilinear_and_identity_at_size():
    rng = np.random.RandomState(2)
    img = torch.from_numpy(rng.randint(0, 256, (1, 40, 60, 3), dtype=np.uint8))
    assert stage_images(img, (60, 40)) is img
    # a 2x pixel-repeated image halves back to the original exactly
    up = img.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    assert torch.equal(stage_images(up, (60, 40)), img)
    # equal to cv2's fixed-point INTER_LINEAR, bit for bit
    cv2 = pytest.importorskip('cv2')
    src = rng.randint(0, 256, (97, 131, 3), dtype=np.uint8)
    want = cv2.resize(src, (64, 48), interpolation=cv2.INTER_LINEAR)
    got = stage_images(torch.from_numpy(src)[None], (64, 48))[0].numpy()
    np.testing.assert_array_equal(got, want)


# (h, w) -> (new_h, new_w): request sizes down to 300x300, an upscale, odd
# sizes on both sides, a small case, and an exact 2x downscale (cv2's
# INTER_AREA path)
STAGE_SIZES = [((480, 640), (300, 300)), ((375, 500), (300, 300)),
               ((720, 1280), (300, 300)), ((150, 150), (300, 300)),
               ((299, 301), (300, 300)), ((97, 131), (48, 64)),
               ((600, 600), (300, 300))]


@pytest.mark.parametrize('src_hw,dst_hw', STAGE_SIZES)
def test_stage_images_equals_jax_stage_image(src_hw, dst_hw):
    pytest.importorskip('cv2')  # stage_image falls back to PIL without it
    rng = np.random.RandomState(sum(src_hw))
    src = rng.randint(0, 256, (2, *src_hw, 3), dtype=np.uint8)
    (h, w), (new_h, new_w) = src_hw, dst_hw
    got = stage_images(torch.from_numpy(src), (new_w, new_h)).numpy()
    assert got.shape == (2, new_h, new_w, 3) and got.dtype == np.uint8
    for i in range(2):
        want, _ = stage_image(src[i], np.zeros((0, 4), np.float32),
                              (new_w, new_h))
        np.testing.assert_array_equal(got[i], want)


def test_stage_images_takes_only_uint8_when_resizing():
    img = torch.zeros(1, 20, 30, 3)
    assert stage_images(img, (30, 20)) is img
    with pytest.raises(TypeError):
        stage_images(img, (15, 10))


# ------------------------------------------------------------- end to end

@pytest.fixture(scope='module')
def jax_predict(checkpoint):
    """The JAX serving path on the committed checkpoint: ``(config path,
    input size, staged uint8 -> (detections, valid))``."""
    config = str(CKPT_DIR / 'config.py')
    cfg = jax_load_config(config)
    model = dict(cfg.model)
    bundle = jax_builder.build(
        base=model['base'], anchor_generator=model['anchor_generator'],
        input_size=tuple(cfg.input_size),
        **{k: v for k, v in model['detector'].items()
           if k in ('num_classes', 'use_depthwise', 'features', 'extras')})
    post = Postprocessor(BoxCoder(**cfg.box_coder), use_pallas=False,
                         **cfg.postprocess)
    step = make_predict_step(bundle.module, post, bundle.anchors())
    size = tuple(cfg.input_size)

    def run(staged):
        return tuple(map(np.asarray, step(
            checkpoint, jax_eval_pipeline(staged, size))))

    return config, size, run


def test_predictor_matches_jax_predict_step(checkpoint, jax_predict):
    config, _, run = jax_predict
    data = Synthetic(num_images=6, image_size=128, num_classes=5, max_boxes=3,
                     seed=2)
    staged = np.stack([a['image'] for a in data.annotations])
    want_d, want_v = run(staged)

    pred = Predictor.from_config(config, variables=checkpoint, device='cpu')
    got_d, got_v = pred.predict_batch(staged)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert want_v.sum() >= len(staged)  # the trained model finds objects
    np.testing.assert_allclose(got_d.numpy()[want_v], want_d[want_v],
                               rtol=0, atol=1e-3)

    # predict(): one request of another size, rescaled to its own pixels
    big = np.repeat(np.repeat(staged[0], 2, axis=0), 2, axis=1)
    dets = pred.predict(big)
    want_one = want_d[0][want_v[0]].copy()
    want_one[:, :4] *= 2
    np.testing.assert_allclose(dets, want_one, rtol=0, atol=2e-3)


def test_predict_480x640_request_matches_jax_stage_image(checkpoint,
                                                         jax_predict):
    """A 480x640 request: the port stages it on the device, JAX with cv2
    (``stage_image``); then the same eval pipeline and predict step."""
    pytest.importorskip('cv2')
    config, (in_w, in_h), run = jax_predict
    data = Synthetic(num_images=2, image_size=128, num_classes=5, max_boxes=3,
                     seed=4)
    # nearest-neighbour upscale of a synthetic image to the request size
    img = data.annotations[0]['image']
    request = img[(np.arange(480) * img.shape[0]) // 480][
        :, (np.arange(640) * img.shape[1]) // 640]
    staged, _ = stage_image(request, np.zeros((0, 4), np.float32),
                            (in_w, in_h))
    want_d, want_v = run(staged[None])

    pred = Predictor.from_config(config, variables=checkpoint, device='cpu')
    got_d, got_v = pred.predict_batch(request[None])
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert want_v.sum() >= 1
    np.testing.assert_allclose(got_d.numpy()[want_v], want_d[want_v],
                               rtol=0, atol=1e-3)
    # predict() returns the same rows in the request's own pixels
    dets = pred.predict(request)
    rows = got_d[0][got_v[0]].numpy().copy()
    rows[:, [0, 2]] *= 640 / in_w
    rows[:, [1, 3]] *= 480 / in_h
    np.testing.assert_array_equal(dets, rows)


def test_predictor_random_weights_are_seeded():
    config = str(CKPT_DIR / 'config.py')
    a = Predictor.from_config(config, device='cpu', seed=5)
    b = Predictor.from_config(config, device='cpu', seed=5)
    images = np.random.RandomState(3).randint(0, 256, (2, 128, 128, 3),
                                              dtype=np.uint8)
    da, va = a.predict_batch(images)
    db, vb = b.predict_batch(images)
    assert torch.equal(va, vb) and torch.equal(da, db)
    assert da.shape == (2, 50, 6) and torch.isfinite(da).all()


def test_from_config_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Predictor.from_config(str(CKPT_DIR / 'config.py'))


# ---------------------------------------------------- independence from JAX

def port_sources():
    return sorted(PORT.rglob('*.py')) + [REPO / 'chip_smoke.py']


def test_port_sources_import_no_jax():
    banned = re.compile(r'^\s*(import|from)\s+(jax|flax|optax|msgpack)\b'
                        r'|\bsingle_shot_detection_tpu\.', re.M)
    for path in port_sources():
        hits = banned.findall(path.read_text())
        assert not hits, f'{path.relative_to(REPO)} names {hits}'


def test_port_sources_define_each_top_level_name_once():
    """No module-level function or class of the port or of chip_smoke.py is
    defined twice: the later definition would replace the earlier one for
    every caller (flake8's F811)."""
    for path in port_sources():
        names = collections.Counter(
            node.name for node in ast.parse(path.read_text()).body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)))
        twice = sorted(name for name, n in names.items() if n > 1)
        assert not twice, f'{path.relative_to(REPO)} defines {twice} twice'


def test_package_imports_with_jax_blocked():
    """Every module of the port, ``__main__`` included, imports with
    jax, flax, optax, msgpack and the JAX package blocked; then it serves,
    and restores the committed JAX checkpoint."""
    modules = sorted(
        'single_shot_detection_tpu_torch.' + '.'.join(
            p.relative_to(PORT).with_suffix('').parts)
        for p in PORT.rglob('*.py') if p.name != '__init__.py')
    assert {'single_shot_detection_tpu_torch.__main__',
            'single_shot_detection_tpu_torch.cli',
            'single_shot_detection_tpu_torch.train.checkpoint',
            'single_shot_detection_tpu_torch.utils.flax_msgpack',
            'single_shot_detection_tpu_torch.utils.torch_import'} <= set(modules)
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack',\n"
        "             'single_shot_detection_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from single_shot_detection_tpu_torch.predict import Predictor\n"
        "p = Predictor.from_config('samples/synthetic_smoke.py', device='cpu')\n"
        "import numpy as np\n"
        "d, v = p.predict_batch(np.zeros((1, 128, 128, 3), np.uint8))\n"
        "assert d.shape == (1, 50, 6)\n"
        "from single_shot_detection_tpu_torch.train import checkpoint\n"
        "from single_shot_detection_tpu_torch.trainer import Trainer\n"
        "run = 'experiments/2026-08-16-225820'\n"
        "t = Trainer.from_config(run + '/config.py', device='cpu')\n"
        "_, meta = checkpoint.restore(checkpoint.find_latest(run), t.state)\n"
        "assert t.state.step == 1800 and meta['epoch'] == 149\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith('ok')
