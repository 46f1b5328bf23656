"""Port parity: anchors, box math, box coder, NMS and the postprocessor.

The same numpy inputs go through the JAX package (on the CPU) and the
PyTorch port (``device='cpu'``, where the NMS wrapper takes its plain
version).  Tolerances: anchors and NMS keep masks exact; box math and coder
rtol = atol = 1e-6; postprocessor valid masks equal, valid rows atol 1e-5
(with rtol 1e-6 for pixel coordinates, about 4 f32 steps at 300 px).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from single_shot_detection_tpu.ops import anchors as jax_anchors
from single_shot_detection_tpu.ops import box_coder as jax_coder
from single_shot_detection_tpu.ops import boxes as jax_boxes
from single_shot_detection_tpu.ops import nms as jax_nms
from single_shot_detection_tpu.ops import nms_pallas
from single_shot_detection_tpu.ops import postprocess as jax_pp
from single_shot_detection_tpu_torch.ops import anchors as pt_anchors
from single_shot_detection_tpu_torch.ops import box_coder as pt_coder
from single_shot_detection_tpu_torch.ops import boxes as pt_boxes
from single_shot_detection_tpu_torch.ops import nms as pt_nms
from single_shot_detection_tpu_torch.ops import nms_kernel
from single_shot_detection_tpu_torch.ops import postprocess as pt_pp
from _torch_port_fixtures import one_torch_thread  # noqa: F401

FLAGSHIP_ANCHORS = dict(type='ssd', num_scales=6, min_scale=0.1, max_scale=1.05,
                        aspect_ratios=[[1.0, 2.0]] + [[1.0, 2.0, 3.0]] * 3
                        + [[1.0, 2.0]] * 2)
FLAGSHIP_FMS = [(18, 18), (9, 9), (5, 5), (3, 3), (2, 2), (1, 1)]
SMOKE_ANCHORS = dict(type='ssd', num_scales=3, min_scale=0.15, max_scale=0.95,
                     aspect_ratios=[[1.0, 2.0]] * 3)
SMOKE_FMS = [(8, 8), (4, 4), (2, 2)]


def t(x):
    return torch.from_numpy(np.asarray(x))


def random_corners(rng, shape):
    xy = rng.rand(*shape, 2).astype(np.float32) * 100
    wh = rng.rand(*shape, 2).astype(np.float32) * 40 + 1
    return np.concatenate([xy, xy + wh], axis=-1)


# ------------------------------------------------------------------ anchors

@pytest.mark.parametrize('cfg,img,fms,count', [
    (FLAGSHIP_ANCHORS, (300, 300), FLAGSHIP_FMS, 2006),
    (SMOKE_ANCHORS, (128, 128), SMOKE_FMS, 336),
])
def test_anchors_exact(cfg, img, fms, count):
    want = jax_anchors.generate_anchors(
        jax_anchors.build_anchor_generators(**cfg), img, fms)
    got = pt_anchors.generate_anchors(
        pt_anchors.build_anchor_generators(**cfg), img, fms)
    assert got.shape == (count, 4)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- box math

def test_box_math_matches_jax():
    rng = np.random.RandomState(0)
    a = random_corners(rng, (3, 7))
    b = random_corners(rng, (3, 5))
    b[0, 0] = 0.0  # an empty box
    cent = np.concatenate([rng.rand(3, 7, 2) * 100, rng.rand(3, 7, 2) * 30 + 1],
                          axis=-1).astype(np.float32)
    pairs = [
        (jax_boxes.to_corners(cent), pt_boxes.to_corners(t(cent))),
        (jax_boxes.to_centroids(a), pt_boxes.to_centroids(t(a))),
        (jax_boxes.area(a), pt_boxes.area(t(a))),
        (jax_boxes.intersection(a, b), pt_boxes.intersection(t(a), t(b))),
        (jax_boxes.intersection(a[:, :5], b, cartesian=False),
         pt_boxes.intersection(t(a[:, :5]), t(b), cartesian=False)),
        (jax_boxes.iou(a, b), pt_boxes.iou(t(a), t(b))),
        (jax_boxes.iou(a[:, :5], b, cartesian=False),
         pt_boxes.iou(t(a[:, :5]), t(b), cartesian=False)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_box_coder_matches_jax():
    rng = np.random.RandomState(1)
    priors = np.concatenate([rng.rand(50, 2) * 300, rng.rand(50, 2) * 100 + 5],
                            axis=-1).astype(np.float32)
    boxes = np.concatenate([rng.rand(2, 50, 2) * 300,
                            rng.rand(2, 50, 2) * 100 + 5],
                           axis=-1).astype(np.float32)
    codes = rng.randn(2, 50, 4).astype(np.float32)
    jc = jax_coder.BoxCoder(xy_scale=10.0, wh_scale=5.0)
    pc = pt_coder.BoxCoder(xy_scale=10.0, wh_scale=5.0)
    np.testing.assert_allclose(pc.encode(t(boxes), t(priors)).numpy(),
                               np.asarray(jc.encode(boxes, priors)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pc.decode(t(codes), t(priors)).numpy(),
                               np.asarray(jc.decode(codes, priors)),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------- NMS

def pallas_keep(boxes, scores, threshold, bn=4):
    """The TPU kernel in interpreter mode (tests/test_nms_pallas.py's way)."""
    n, k, _ = boxes.shape
    k_pad = max(128, ((k + 127) // 128) * 128)
    n_pad = ((n + bn - 1) // bn) * bn
    boxes_t = jnp.pad(jnp.moveaxis(jnp.asarray(boxes), 2, 1),
                      ((0, n_pad - n), (0, 0), (0, k_pad - k)))
    keep = pl.pallas_call(
        functools.partial(nms_pallas._nms_block_kernel,
                          overlap_threshold=threshold, num_valid=k),
        grid=(n_pad // bn,),
        in_specs=[pl.BlockSpec((bn, 4, k_pad), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((bn, k_pad), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_pad, k_pad), jnp.float32),
        scratch_shapes=[pltpu.VMEM((bn, k_pad, k_pad), jnp.float32)],
        interpret=True,
    )(boxes_t)
    return np.asarray(keep[:n, :k] > 0.5) & (scores > -np.inf)


def nms_cases(name, rng):
    """Score-sorted problem groups ``[(boxes [N, K, 4], scores [N, K], thr)]``."""
    if name == 'identical':
        boxes = np.tile(np.array([[10, 10, 50, 50]], np.float32), (2, 8, 1))
        scores = -np.sort(-rng.rand(2, 8).astype(np.float32), axis=1)
        return [(boxes, scores, 0.5)]
    if name == 'at_threshold':
        # a big box, then one inside it at IoU exactly the threshold
        # (9 / 20 = 0.45, 1 / 2 = 0.5): equal, so never suppressed
        scores = np.array([[0.9, 0.8, 0.7, 0.6]], np.float32)
        return [
            (np.array([[[0, 0, 4, 5], [0, 0, 3, 3],
                        [20, 0, 24, 5], [20, 0, 23, 3]]], np.float32),
             scores, 0.45),
            (np.array([[[0, 0, 1, 2], [0, 0, 1, 1],
                        [20, 0, 21, 2], [20, 0, 21, 1]]], np.float32),
             scores, 0.5)]
    n, k = {'random': (6, 50), 'invalid_rows': (3, 30), 'k20': (8, 20),
            'k128': (2, 128)}[name]
    boxes = random_corners(rng, (n, k))
    scores = -np.sort(-rng.rand(n, k).astype(np.float32), axis=1)
    if name == 'invalid_rows':
        scores[:2, 20:] = -np.inf
        boxes[:2, 20:] = 0.0  # zero boxes: NaN IoU with each other
        scores[2] = -np.inf
        boxes[2] = 0.0
    return [(boxes, scores, 0.45)]


@pytest.mark.parametrize('name', ['random', 'invalid_rows', 'identical',
                                  'at_threshold', 'k20', 'k128'])
def test_plain_nms_matches_jax_and_pallas(name):
    for boxes, scores, thr in nms_cases(name, np.random.RandomState(2)):
        got = pt_nms.nms_keep_sorted(t(boxes), t(scores), thr).numpy()
        np.testing.assert_array_equal(got, pallas_keep(boxes, scores, thr))
        for j in range(len(boxes)):
            want = np.asarray(jax_nms.nms_mask(boxes[j], scores[j], thr))
            np.testing.assert_array_equal(got[j], want, err_msg=f'problem {j}')
        # the CPU path of the kernel wrapper is the plain version
        np.testing.assert_array_equal(
            nms_kernel.nms_keep_batched(t(boxes), t(scores), thr).numpy(), got)
        if name == 'identical':
            assert got.sum(axis=1).tolist() == [1, 1] and got[:, 0].all()
        if name == 'at_threshold':
            assert got.all()
        if name == 'invalid_rows':
            assert not got[:2, 20:].any() and not got[2].any()


def test_nms_mask_unsorted_with_ties_matches_jax():
    rng = np.random.RandomState(3)
    boxes = random_corners(rng, (4, 40))
    scores = rng.choice([0.1, 0.5, 0.9], size=(4, 40)).astype(np.float32)
    scores[1, ::3] = -np.inf
    got = pt_nms.nms_mask(t(boxes), t(scores), 0.3).numpy()
    for j in range(4):
        want = np.asarray(jax_nms.nms_mask(boxes[j], scores[j], 0.3))
        np.testing.assert_array_equal(got[j], want)


@settings(max_examples=80, deadline=None, derandomize=True, database=None)
@given(k=st.integers(1, 40), seed=st.integers(0, 2 ** 31 - 1),
       invalid=st.floats(0.0, 1.0), thr=st.sampled_from([0.0, 0.3, 0.45, 0.5]))
def test_nms_keep_needs_only_the_valid_prefix(k, seed, invalid, thr):
    """What the kernel relies on: past the last candidate with a score above
    -inf nothing is kept, and the keep mask of the prefix [0, n_valid) does
    not depend on the candidates after it, wherever -inf stands."""
    rng = np.random.RandomState(seed)
    boxes = random_corners(rng, (k,))
    boxes[rng.rand(k) < 0.2] = boxes[0]  # some identical boxes
    scores = -np.sort(-rng.rand(k).astype(np.float32))
    scores[rng.rand(k) < invalid] = -np.inf
    valid = np.flatnonzero(scores > -np.inf)
    n_valid = valid[-1] + 1 if len(valid) else 0
    full = pt_nms.nms_keep_sorted(t(boxes), t(scores), thr).numpy()
    prefix = np.zeros(k, bool)
    if n_valid:
        prefix[:n_valid] = pt_nms.nms_keep_sorted(
            t(boxes[:n_valid]), t(scores[:n_valid]), thr).numpy()
    np.testing.assert_array_equal(full, prefix)


def test_nms_wrapper_counts_only_kernel_launches():
    rng = np.random.RandomState(4)
    boxes = t(random_corners(rng, (3, 10)))
    scores = t(-np.sort(-rng.rand(3, 10).astype(np.float32), axis=1))
    before = nms_kernel.nms_keep_batched.launches
    nms_kernel.nms_keep_batched(boxes, scores, 0.45)
    assert nms_kernel.nms_keep_batched.launches == before


@pytest.mark.parametrize('boxes,scores,error', [
    (torch.zeros(2, 5, 4, dtype=torch.float64), torch.zeros(2, 5), TypeError),
    (torch.zeros(2, 5, 3), torch.zeros(2, 5), ValueError),
    (torch.zeros(2, 5, 4), torch.zeros(2, 6), ValueError),
    (torch.zeros(2, 4, 5).transpose(1, 2), torch.zeros(2, 5), ValueError),
    (torch.zeros(1, nms_kernel.MAX_K + 1, 4),
     torch.zeros(1, nms_kernel.MAX_K + 1), ValueError),
])
def test_nms_wrapper_rejects_what_the_kernel_does_not_take(boxes, scores, error):
    with pytest.raises(error):
        nms_kernel._check(boxes, scores)


# ----------------------------------------------------------- postprocessor

def head_outputs(rng, batch, num_anchors, num_classes, spread):
    scores = (rng.randn(batch, num_anchors, num_classes) * spread).astype(np.float32)
    locs = (rng.randn(batch, num_anchors, 4) * 0.5).astype(np.float32)
    return scores, locs


PP_CASES = {
    # name: (anchors cfg, img, fms, classes, postprocess kwargs, logit spread)
    'flagship': (FLAGSHIP_ANCHORS, (300, 300), FLAGSHIP_FMS, 21,
                 dict(score_threshold=0.01, max_total=200,
                      nms={'max_per_class': 100, 'overlap_threshold': 0.45}),
                 2.0),
    'smoke': (SMOKE_ANCHORS, (128, 128), SMOKE_FMS, 5,
              dict(score_threshold=0.1, max_total=50,
                   nms={'max_per_class': 20, 'overlap_threshold': 0.45}), 2.0),
    'sigmoid_pre_nms_top_k': (SMOKE_ANCHORS, (128, 128), SMOKE_FMS, 5,
                              dict(score_threshold=0.3, max_total=40,
                                   score_converter='SIGMOID', pre_nms_top_k=100,
                                   nms={'max_per_class': 30,
                                        'overlap_threshold': 0.5}), 1.5),
    # equal logits: every score ties, so top-k order among ties decides the
    # rows; classes below the threshold leave -inf slots
    'ties': (SMOKE_ANCHORS, (128, 128), SMOKE_FMS, 5,
             dict(score_threshold=0.1, max_total=50,
                  nms={'max_per_class': 20, 'overlap_threshold': 0.45}), 0.0),
}


@pytest.mark.parametrize('name', list(PP_CASES))
def test_postprocessor_matches_jax(name):
    cfg, img, fms, classes, kw, spread = PP_CASES[name]
    rng = np.random.RandomState(5)
    anchors = jax_anchors.generate_anchors(
        jax_anchors.build_anchor_generators(**cfg), img, fms)
    scores, locs = head_outputs(rng, 2, len(anchors), classes, spread)
    if name == 'ties':
        scores[..., 3] = -5.0  # class 3 never clears the threshold
    jax_post = jax_pp.Postprocessor(jax_coder.BoxCoder(), use_pallas=False, **kw)
    want_d, want_v = map(np.asarray, jax_post(scores, locs, anchors))
    pt_post = pt_pp.Postprocessor(pt_coder.BoxCoder(), **kw)
    got_d, got_v = pt_post(t(scores), t(locs), t(anchors))
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert want_v.any()
    # atol 1e-5, plus rtol 1e-6 for box corners: near 300 px the f32 spacing
    # is 3.05e-5, and XLA's exp and PyTorch's differ in the last bit
    np.testing.assert_allclose(got_d.numpy()[want_v], want_d[want_v],
                               rtol=1e-6, atol=1e-5)
    # invalid slots too: the same candidates in the same order
    np.testing.assert_allclose(got_d.numpy()[~want_v], want_d[~want_v],
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize('cfg,anchors', [
    ({'score_threshold': 0.01}, 2006),
    ({'score_threshold': 0.01}, 20000),
    ({'score_threshold': 0.01, 'pre_nms_top_k': None}, 20000),
])
def test_serving_preset_matches_jax(cfg, anchors):
    assert (pt_pp.Postprocessor.serving_preset(cfg, anchors)
            == jax_pp.Postprocessor.serving_preset(cfg, anchors))
