"""Port parity for export (``export/__init__.py``): the NMS custom op, the
port's ``export_model`` -> ``load_exported`` against the JAX package's on
the same variables, each artifact against the port's own eager path, the
int8 artifact, the int8 refusals, the numeric flags recorded in the file,
and ``Experiment.predict`` (the soft-NMS artifact is in
``test_torch_port_deploy.py``).  Everything runs on the CPU at
``samples/synthetic_smoke.py`` (128 px, 5 classes) with the port's seeded
weights and perturbed BN statistics, crossed to JAX by
``utils/weights.py::to_jax_variables``.

Tolerances:
- the plain artifact's probabilities within 1e-5 and boxes within 1e-4
  (absolute) of JAX's: the two forwards differ in f32 rounding only;
- the postprocessed artifact's ``valid`` equal to JAX's, detections within
  1e-4, each image's rows as a set (random weights give scores that tie to
  a float step, and tied rows may swap);
- the standalone artifact against "normalize by hand, then the
  postprocessed artifact": ``valid`` equal, detections within 1e-5 as a
  set, as ``tests/test_engine.py`` holds JAX's at 1e-5 (numpy's
  normalization rounds differently from the artifact's);
- every artifact against the port's eager path on the same inputs: equal
  bit for bit (the same ops on the same CPU), ``Experiment.predict``
  against ``Predictor.predict`` too.
"""

import copy
import json
import os
import shutil
import types
import zipfile

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from single_shot_detection_tpu import export as jax_export
from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.ops.box_coder import BoxCoder as JaxBoxCoder
from single_shot_detection_tpu.ops.postprocess import (
    Postprocessor as JaxPostprocessor)
from single_shot_detection_tpu.utils.config import load_config as jax_load_config
from single_shot_detection_tpu_torch import device as device_mod
from single_shot_detection_tpu_torch import export as pt_export
from single_shot_detection_tpu_torch.export import quantize
from single_shot_detection_tpu_torch.ops import nms_kernel
from single_shot_detection_tpu_torch.predict import Predictor
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.train.step import make_predict_step
from single_shot_detection_tpu_torch.utils.config import load_config
from single_shot_detection_tpu_torch.utils.weights import to_jax_variables
from _torch_port_fixtures import one_torch_thread  # noqa: F401

SMOKE = 'samples/synthetic_smoke.py'
BATCH = 2


@pytest.fixture(autouse=True)
def policy_state():
    """Entry points write torch's precision flags: put them back."""
    flags = device_mod.current_flags()
    last, ambient = device_mod._last_write, device_mod._user_ambient
    yield
    device_mod.set_flags(flags)
    device_mod._last_write, device_mod._user_ambient = last, ambient


def perturb_bn(model, seed=5):
    """Seeded BN statistics, so the eval-mode BNs are not the identity."""
    rng = np.random.RandomState(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            m.running_mean.copy_(torch.from_numpy(
                (rng.randn(c) * 0.1).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                (np.abs(rng.randn(c)) * 0.5 + 0.5).astype(np.float32)))


def port_experiment(cfg=None, **kwargs):
    """The port's experiment on SMOKE's seeded weights, BN perturbed."""
    exp = Experiment(cfg or load_config(SMOKE, phases=('eval',)),
                     phases=('eval',), device='cpu', **kwargs)
    perturb_bn(exp.model)
    return exp


@pytest.fixture(scope='module')
def port_exp():
    return port_experiment()


def jax_stand_in(port_exp):
    """What the JAX package's ``export_model`` reads of an ``Experiment``
    (its module, variables, anchors, coder, serving postprocessor on the
    plain NMS, eval normalization), built from SMOKE on ``port_exp``'s
    variables, with no JAX init compiled."""
    cfg = jax_load_config(SMOKE)
    model = dict(cfg.model)
    bundle = jax_builder.build(
        base=model['base'], anchor_generator=model['anchor_generator'],
        input_size=tuple(cfg.input_size),
        **{k: v for k, v in model['detector'].items()
           if k in ('num_classes', 'use_depthwise', 'features', 'extras')})
    coder = JaxBoxCoder(**cfg.box_coder)
    post = JaxPostprocessor(coder, use_pallas=False, **cfg.postprocess)
    pipe = port_exp.eval_pipeline.preprocess
    variables = to_jax_variables(port_exp.model.state_dict())
    return types.SimpleNamespace(
        cfg=cfg, bundle=bundle, anchors=bundle.anchors(), box_coder=coder,
        serving_postprocessor=lambda: post, input_size=tuple(cfg.input_size),
        eval_pipeline=types.SimpleNamespace(divisor=pipe.divisor,
                                            mean=pipe.mean, std=pipe.std),
        state=types.SimpleNamespace(**variables), variables=variables)


@pytest.fixture(scope='module')
def jax_exp(port_exp):
    """The one JAX model of this file."""
    return jax_stand_in(port_exp)


@pytest.fixture(scope='module')
def raw_images():
    """Raw resized RGB in 0-255, f32 ``[B, 128, 128, 3]``."""
    return (np.random.RandomState(3).rand(BATCH, 128, 128, 3) * 255
            ).astype(np.float32)


def normalize(exp, raw):
    pipe = exp.eval_pipeline.preprocess
    return ((raw / pipe.divisor - np.asarray(pipe.mean))
            / np.asarray(pipe.std)).astype(np.float32)


def eager(exp, images_nhwc, postprocess=True, model=None):
    """The port's eager path on normalized NHWC images (with ``model`` in
    place of the experiment's)."""
    model = (model or exp.model).eval()
    x = torch.from_numpy(images_nhwc).permute(0, 3, 1, 2).contiguous()
    if postprocess:
        return make_predict_step(model, exp.serving_postprocessor,
                                 exp.anchors)(x)
    with torch.no_grad():
        scores, locs = model(x)
    from single_shot_detection_tpu_torch.ops import boxes as box_ops
    return (torch.softmax(scores.float(), -1), box_ops.to_corners(
        exp.postprocessor.box_coder.decode(locs.float(), exp.anchors)))


@pytest.fixture(scope='module')
def artifacts(port_exp, tmp_path_factory):
    """The port's plain, postprocessed and standalone artifacts: ``{kind:
    (path, loaded callable, input specs)}``."""
    root = tmp_path_factory.mktemp('port')
    out = {}
    for kind, kwargs in (('plain', {}), ('pp', {'with_postprocess': True}),
                         ('standalone', {'with_postprocess': True,
                                         'with_preprocess': True,
                                         'bake_variables': True})):
        path = pt_export.export_model(port_exp, str(root / kind),
                                      batch_size=BATCH, **kwargs)
        out[kind] = (path, *pt_export.load_exported_with_spec(path))
    return out


def assert_same_detections(got, want, atol):
    """``valid`` equal, and each image's valid rows equal within ``atol``
    as a set: the random weights give scores that tie to a float step, and
    such rows may come in either order."""
    (got_d, got_v), (want_d, want_v) = [tuple(map(np.asarray, pair))
                                        for pair in (got, want)]
    np.testing.assert_array_equal(got_v, want_v)
    assert want_v.any()
    for g, w in zip(got_d[got_v[..., None].repeat(6, -1)].reshape(-1, 6),
                    want_d[want_v[..., None].repeat(6, -1)].reshape(-1, 6)):
        assert abs(g[5] - w[5]) <= atol   # the scores in the same order
    for i in range(len(want_v)):
        left = list(want_d[i][want_v[i]])
        for row in got_d[i][got_v[i]]:
            match = [j for j, r in enumerate(left)
                     if np.abs(r - row).max() <= atol]
            assert match, f'image {i}: no row within {atol} of {row}'
            left.pop(match[0])


# ------------------------------------------------------------- the NMS op

def nms_inputs(n=6, k=20, seed=0):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, k, 2).astype(np.float32) * 50
    wh = rng.rand(n, k, 2).astype(np.float32) * 30 + 1
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = -np.sort(-rng.rand(n, k).astype(np.float32), axis=-1)
    scores[:, -3:] = -np.inf
    return torch.from_numpy(boxes), torch.from_numpy(scores)


def test_nms_op_passes_opcheck():
    """The custom op's schema, fake implementation and dispatch hold
    ``torch.library.opcheck``'s checks on CPU inputs, and it equals the
    plain version."""
    boxes, scores = nms_inputs()
    torch.library.opcheck(nms_kernel.OP, (boxes, scores, 0.45))
    from single_shot_detection_tpu_torch.ops import nms as nms_ops
    assert torch.equal(nms_kernel.nms_keep_batched(boxes, scores, 0.45),
                       nms_ops.nms_keep_sorted(boxes, scores, 0.45))


def test_nms_op_fake_gives_the_keep_mask_shape():
    with FakeTensorMode() as mode:
        boxes = mode.from_tensor(torch.zeros(7, 33, 4))
        scores = mode.from_tensor(torch.zeros(7, 33))
        keep = nms_kernel.OP(boxes, scores, 0.5)
    assert keep.shape == (7, 33) and keep.dtype == torch.bool
    assert keep.device == scores.device


def test_nms_op_does_not_count_cpu_calls():
    before = nms_kernel.nms_keep_batched.launches
    nms_kernel.nms_keep_batched(*nms_inputs(), 0.45)
    assert nms_kernel.nms_keep_batched.launches == before


# ------------------------------------------------------ against JAX's export

def test_plain_artifact_matches_jax(jax_exp, port_exp, artifacts, raw_images,
                                    tmp_path):
    x = normalize(port_exp, raw_images)
    jax_call = jax_export.load_exported(jax_export.export_model(
        jax_exp, str(tmp_path / 'jax_plain'), batch_size=BATCH))
    want_probs, want_boxes = jax_call(jax_exp.variables, x)
    _, call, specs = artifacts['plain']
    assert specs[-1] == pt_export.InputSpec((BATCH, 128, 128, 3),
                                            torch.float32)
    assert len(specs) == len(port_exp.model.state_dict()) + 1
    probs, boxes = call(port_exp.model.state_dict(), x)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes),
                               rtol=0, atol=1e-4)


def test_postprocess_artifact_matches_jax(jax_exp, port_exp, artifacts,
                                          raw_images, tmp_path):
    x = normalize(port_exp, raw_images)
    jax_call = jax_export.load_exported(jax_export.export_model(
        jax_exp, str(tmp_path / 'jax_pp'), with_postprocess=True,
        batch_size=BATCH))
    want_dets, want_valid = jax_call(jax_exp.variables, x)
    dets, valid = artifacts['pp'][1](port_exp.model.state_dict(), x)
    assert_same_detections((dets, valid), (want_dets, want_valid), 1e-4)


def test_standalone_equals_normalize_then_postprocess_artifact(
        port_exp, artifacts, raw_images):
    _, call, specs = artifacts['standalone']
    assert specs == [pt_export.InputSpec((BATCH, 128, 128, 3), torch.float32)]
    dets_a, valid_a = call(raw_images)
    dets_b, valid_b = artifacts['pp'][1](port_exp.model.state_dict(),
                                         normalize(port_exp, raw_images))
    assert_same_detections((dets_a, valid_a), (dets_b, valid_b), 1e-5)


# ------------------------------------------------- against the eager path

@pytest.mark.parametrize('kind', ['plain', 'pp', 'standalone'])
def test_artifact_equals_eager_bit_for_bit(kind, port_exp, artifacts,
                                           raw_images):
    call = artifacts[kind][1]
    pipe = port_exp.eval_pipeline.preprocess
    x = pipe.normalize(torch.from_numpy(raw_images)).permute(0, 2, 3, 1)
    x = np.ascontiguousarray(x.numpy())
    if kind == 'standalone':
        got = call(raw_images)
    else:
        got = call(port_exp.model.state_dict(), x)
    want = eager(port_exp, x, postprocess=kind != 'plain')
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_unbaked_artifact_takes_other_weights(port_exp, artifacts,
                                              raw_images):
    """One non-baked artifact serves another checkpoint of the config:
    weights scaled in the state_dict move its outputs as the eager model's
    move."""
    state = {k: (v * 1.5 if k.endswith('head0.weight') else v)
             for k, v in port_exp.model.state_dict().items()}
    x = normalize(port_exp, raw_images)
    call = artifacts['plain'][1]
    probs, _ = call(state, x)
    base, _ = call(port_exp.model.state_dict(), x)
    model = copy.deepcopy(port_exp.model)
    model.load_state_dict(state)
    want, _ = eager(port_exp, x, postprocess=False, model=model)
    assert torch.equal(probs, want) and not torch.equal(probs, base)


def test_make_inference_fn_equals_its_artifact(port_exp, artifacts,
                                               raw_images):
    x = torch.from_numpy(normalize(port_exp, raw_images))
    fn = pt_export.make_inference_fn(port_exp, with_postprocess=True)
    port_exp.model.eval()
    with torch.no_grad():
        dets, valid = fn(port_exp.model.state_dict(), x)
    got = artifacts['pp'][1](port_exp.model.state_dict(), x)
    assert torch.equal(dets, got[0]) and torch.equal(valid, got[1])


# ------------------------------------------------------------------- int8

@pytest.fixture(scope='module')
def int8_exp():
    """The smoke config past the gate (an explicit ``int8`` block), the
    experiment calibrated on its eval batches."""
    cfg = load_config(SMOKE, phases=('eval',))
    cfg.config.int8 = {}
    exp = port_experiment(cfg, int8=True)
    exp._ensure_int8()
    assert exp.int8 and exp._int8_amax
    return exp


def test_int8_artifact_equals_eager_int8(int8_exp, raw_images, tmp_path):
    """The int8 artifact reuses the experiment's scales at its step and
    equals the eager int8 predict step on them, bit for bit."""
    path = pt_export.export_model(int8_exp, str(tmp_path / 'int8'),
                                  with_postprocess=True, with_preprocess=True,
                                  bake_variables=True, batch_size=BATCH,
                                  int8=True)
    assert pt_export.read_meta(path)['int8'] is True
    dets, valid = pt_export.load_exported(path)(raw_images)
    x = int8_exp.eval_pipeline.preprocess.normalize(
        torch.from_numpy(raw_images))
    int8_exp.model.eval()
    want = quantize.make_quantized_predict_step(
        int8_exp.model, int8_exp.serving_postprocessor, int8_exp.anchors,
        int8_exp._int8_amax)(x)
    assert torch.equal(dets, want[0]) and torch.equal(valid, want[1])
    program = torch.export.load(path)
    assert any('_int_mm' in str(node.target) for node in program.graph.nodes)


def test_int8_export_refused_by_the_gate(jax_exp, port_exp, tmp_path):
    """MobileNet below b128 without an ``int8`` block: both packages
    refuse the int8 export; past it at b128 the port exports (calibrating
    on the eval batches)."""
    with pytest.raises(ValueError, match='int8 export refused'):
        jax_export.export_model(jax_exp, str(tmp_path / 'jax'), int8=True,
                                batch_size=BATCH)
    with pytest.raises(ValueError, match='int8 export refused: this '
                                         f'backbone at batch {BATCH}'):
        pt_export.export_model(port_exp, str(tmp_path / 'port'), int8=True,
                               batch_size=BATCH)
    with pytest.raises(ValueError, match='config training batch'):
        pt_export.make_inference_fn(port_exp, int8=True)
    assert not os.path.exists(tmp_path / 'port.pt2')


def test_int8_export_refused_with_group_norm(tmp_path):
    cfg = load_config(SMOKE, phases=('eval',))
    cfg.config.int8 = {}
    cfg.config.train = {**cfg.config.train, 'group_norm': True}
    exp = port_experiment(cfg)
    with pytest.raises(ValueError, match='does not compose with '
                                         'train.group_norm'):
        pt_export.export_model(exp, str(tmp_path / 'gn'), int8=True)


# --------------------------------------------------- precision in the file

def test_flags_are_recorded_and_applied_per_call(port_exp, artifacts,
                                                 raw_images):
    """An f32 artifact records TF32 off; its call runs under those flags
    and gives the caller's back."""
    path, call, _ = artifacts['standalone']
    meta = pt_export.read_meta(path)
    assert meta == {'device': 'cpu', 'dtype': 'float32',
                    'matmul_precision': 'highest',
                    'flags': [False, 'highest'], 'with_postprocess': True,
                    'with_preprocess': True, 'bake_variables': True,
                    'int8': False}
    seen = []
    hook = call.module.register_forward_pre_hook(
        lambda *_: seen.append(device_mod.current_flags()))
    try:
        device_mod.set_flags((True, 'high'))
        call(raw_images)
        assert device_mod.current_flags() == (True, 'high')
    finally:
        hook.remove()
    assert seen == [(False, 'highest')]


def test_cuda_artifact_without_a_card_raises(artifacts, tmp_path):
    """No quiet device move: an artifact recorded as exported on a card
    does not load where CUDA is not available."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    src = artifacts['standalone'][0]
    dst = tmp_path / 'cuda.pt2'
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, 'w') as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename.endswith(f'extra/{pt_export.META_FILE}'):
                data = json.dumps({**json.loads(data), 'device': 'cuda'}
                                  ).encode()
            zout.writestr(item, data)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        pt_export.load_exported(str(dst))
    shutil.copy(src, tmp_path / 'copy.pt2')
    pt_export.load_exported(str(tmp_path / 'copy.pt2'))


# ------------------------------------------------------ Experiment.predict

def test_experiment_predict_equals_predictor(port_exp):
    """Stage, eval pipeline, serving predict step, rescale: the port's
    ``Experiment.predict`` (through its own ``Predictor``) equals
    ``Predictor.predict`` from the config (whose path is held against JAX's
    in ``test_torch_port_serving.py``) on the same weights, on an image of
    another size."""
    img = (np.random.RandomState(0).rand(200, 260, 3) * 255).astype(np.uint8)
    pred = Predictor.from_config(SMOKE, device='cpu')
    pred.model.load_state_dict(port_exp.model.state_dict())
    want = pred.predict(img)
    got = port_exp.predict(img)
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)


def test_experiment_predictor_follows_the_int8_calibration(int8_exp,
                                                           raw_images):
    """``Experiment.predictor`` is built once, serves int8 on the
    experiment's scales (equal to the eager int8 predict step, bit for
    bit), and is built again when training has moved the step on."""
    pred = int8_exp.predictor()
    assert int8_exp.predictor() is pred
    images = torch.from_numpy(raw_images.astype(np.uint8))
    got = pred.predict_batch(images)
    x = int8_exp.eval_pipeline.preprocess(images)
    want = quantize.make_quantized_predict_step(
        int8_exp.model, int8_exp.serving_postprocessor, int8_exp.anchors,
        int8_exp._int8_amax)(x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    state = int8_exp.trainer.state
    step = state.step
    try:
        state.step = step + 1
        again = int8_exp.predictor()
        assert again is not pred and int8_exp._int8_calib_step == step + 1
    finally:
        state.step = step
