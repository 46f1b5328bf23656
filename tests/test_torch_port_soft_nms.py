"""Port parity of the serving options: Gaussian soft-NMS
(``ops/nms.py::soft_nms``) and the soft postprocessor against the JAX
package's (``use_pallas=False``, as JAX runs soft-NMS outside its Pallas
kernel), and the approximate ``pre_nms_top_k`` (``{'k', 'approx',
'recall_target'}``), which ``jax.lax.approx_max_k`` computes exactly off
a TPU, as the port always does.

Tolerances: pick masks and valid masks exact; detections as
``test_torch_port_ops.py`` holds the hard postprocessor (atol 1e-5 with
rtol 1e-6 for pixel coordinates).
"""

import jax
import numpy as np
import pytest
import torch

from single_shot_detection_tpu.ops import anchors as jax_anchors
from single_shot_detection_tpu.ops import box_coder as jax_coder
from single_shot_detection_tpu.ops import nms as jax_nms
from single_shot_detection_tpu.ops import postprocess as jax_pp
from single_shot_detection_tpu_torch.ops import box_coder as pt_coder
from single_shot_detection_tpu_torch.ops import nms as pt_nms
from single_shot_detection_tpu_torch.ops import postprocess as pt_pp

FLAGSHIP_ANCHORS = dict(type='ssd', num_scales=6, min_scale=0.1, max_scale=1.05,
                        aspect_ratios=[[1.0, 2.0]] + [[1.0, 2.0, 3.0]] * 3
                        + [[1.0, 2.0]] * 2)
FLAGSHIP_FMS = [(18, 18), (9, 9), (5, 5), (3, 3), (2, 2), (1, 1)]


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    processes, and torch's default of one thread per core makes them
    contend for the CPU, tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def clustered_boxes(rng, shape, k):
    """Boxes around a few centers per problem (so the decays overlap), a
    duplicate pair and an empty box."""
    centers = rng.rand(*shape, 4, 2) * 80
    pick = rng.randint(0, 4, (*shape, k))
    xy = np.take_along_axis(centers, pick[..., None], axis=-2)
    xy = xy + rng.randn(*shape, k, 2) * 6
    wh = rng.rand(*shape, k, 2) * 30 + 5
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[..., 1, :] = boxes[..., 0, :]
    boxes[..., 2, 2:] = boxes[..., 2, :2]
    return boxes


@pytest.mark.parametrize('threshold,sigma', [(0.01, 0.5), (0.3, 0.5),
                                             (0.05, 0.1), (0.5, 2.0)])
def test_soft_nms_matches_jax(threshold, sigma):
    rng = np.random.RandomState(7)
    shape, k = (3, 4), 40
    boxes = clustered_boxes(rng, shape, k)
    scores = rng.rand(*shape, k).astype(np.float32)
    scores[0, 0, 5:] = 0.0          # a row with only a few candidates
    scores[1, 1] = 0.0              # a row with none
    scores[2, 2, :10] = 0.75        # ties: the lowest index is picked first
    want = jax.vmap(jax.vmap(lambda b, s: jax_nms.soft_nms(
        b, s, threshold, sigma)))(boxes, scores)
    got = pt_nms.soft_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          threshold, sigma)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[1, 1].any() and got.any()


def head_outputs(rng, batch, num_anchors, num_classes, spread):
    scores = (rng.randn(batch, num_anchors, num_classes) * spread).astype(np.float32)
    locs = (rng.randn(batch, num_anchors, 4) * 0.5).astype(np.float32)
    return scores, locs


def postprocess_both(kw, spread: float = 2.0, classes: int = 21):
    rng = np.random.RandomState(5)
    anchors = jax_anchors.generate_anchors(
        jax_anchors.build_anchor_generators(**FLAGSHIP_ANCHORS), (300, 300),
        FLAGSHIP_FMS)
    scores, locs = head_outputs(rng, 2, len(anchors), classes, spread)
    jax_post = jax_pp.Postprocessor(jax_coder.BoxCoder(), use_pallas=False, **kw)
    want = tuple(map(np.asarray, jax_post(scores, locs, anchors)))
    pt_post = pt_pp.Postprocessor(pt_coder.BoxCoder(), **kw)
    got = pt_post(torch.from_numpy(scores), torch.from_numpy(locs),
                  torch.from_numpy(anchors))
    return pt_post, tuple(g.numpy() for g in got), want


def assert_detections_equal(got, want):
    (got_d, got_v), (want_d, want_v) = got, want
    np.testing.assert_array_equal(got_v, want_v)
    assert want_v.any()
    np.testing.assert_allclose(got_d[want_v], want_d[want_v], rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(got_d[~want_v], want_d[~want_v], rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize('kw', [
    dict(score_threshold=0.01, max_total=200,
         nms={'max_per_class': 100, 'overlap_threshold': 0.45, 'soft': True}),
    dict(score_threshold=0.1, max_total=50, pre_nms_top_k=300,
         nms={'max_per_class': 40, 'overlap_threshold': 0.5, 'soft': True,
              'sigma': 0.3}),
], ids=['flagship', 'pre_nms_top_k sigma 0.3'])
def test_soft_postprocessor_matches_jax(kw, monkeypatch):
    """The soft branch runs no hard NMS (neither the kernel nor its plain
    version), and picks keep their original scores."""
    monkeypatch.setattr(pt_pp.Postprocessor, 'nms_keep', None)
    post, got, want = postprocess_both(kw)
    assert post.soft and post.sigma == kw['nms'].get('sigma', 0.5)
    assert_detections_equal(got, want)
    # soft-NMS keeps more than hard NMS at the same threshold
    hard_kw = {**kw, 'nms': {**kw['nms'], 'soft': False}}
    monkeypatch.undo()
    _, hard, _ = postprocess_both(hard_kw)
    assert got[1].sum() >= hard[1].sum()


@pytest.mark.parametrize('pre', [
    {'k': 100, 'approx': True, 'recall_target': 0.95},
    {'k': 500, 'approx': True},
    {'k': 300, 'approx': False},
], ids=['k100 approx', 'k500 approx default recall', 'k300 exact dict'])
def test_approximate_pre_nms_top_k_matches_jax(pre):
    kw = dict(score_threshold=0.01, max_total=200, pre_nms_top_k=pre,
              nms={'max_per_class': 100, 'overlap_threshold': 0.45})
    post, got, want = postprocess_both(kw, spread=1.5)
    assert post.pre_nms_top_k == pre['k']
    assert_detections_equal(got, want)
