"""Port parity for the loss zoo (``ops/losses.py``) and
``ops/boxes.py::generalized_iou`` against the JAX package's, on the same
seeded numpy inputs: each of the 16 losses under each reduction, with a
row mask and label smoothing (``epsilon``, which only the soft-target
losses read), ``generalized_iou`` both ways, and ``MultiboxLoss``'s
soft-target and IoU branches.  Tolerance: rtol 1e-6 (atol 1e-6 for values
that are sums of terms of either sign).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_shot_detection_tpu.ops import box_coder as jax_box_coder
from single_shot_detection_tpu.ops import boxes as jax_boxes
from single_shot_detection_tpu.ops import losses as jax_losses
from single_shot_detection_tpu.ops import matching as jax_matching
from single_shot_detection_tpu.ops import sampling as jax_sampling
from single_shot_detection_tpu_torch.ops import box_coder as pt_box_coder
from single_shot_detection_tpu_torch.ops import boxes as pt_boxes
from single_shot_detection_tpu_torch.ops import losses as pt_losses
from single_shot_detection_tpu_torch.ops import sampling as pt_sampling
from _torch_port_fixtures import one_torch_thread  # noqa: F401

B, A, C = 2, 40, 6
TOL = dict(rtol=1e-6, atol=1e-6)


def corners(rs, shape):
    xy = rs.rand(*shape, 2) * 50
    wh = rs.rand(*shape, 2) * 30 + 1
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def soft_plane(rs):
    """A ``{0, score}`` plane: one positive class on most rows, a few
    rows all zero."""
    plane = np.zeros((B, A, C), np.float32)
    cls = rs.randint(0, C, (B, A))
    plane[np.arange(B)[:, None], np.arange(A)[None], cls] = rs.rand(B, A) * 0.8 + 0.2
    plane[:, :3] = 0.0
    return plane


def inputs(name, rs):
    """``(prediction, target)`` for loss ``name``."""
    logits = (rs.randn(B, A, C) * 3).astype(np.float32)
    labels = rs.randint(-1, C, (B, A)).astype(np.int32)  # -1: ignored
    dense = (rs.randn(B, A, 4) * 2).astype(np.float32)
    if name in ('CrossEntropyLoss', 'NLLLoss', 'SoftmaxFocalLoss'):
        return logits, labels
    if name in ('SmoothL1Loss', 'L1Loss', 'MSELoss', 'HuberLoss'):
        return dense, (rs.randn(B, A, 4) * 2).astype(np.float32)
    if name == 'SoftMarginLoss':
        return dense, np.sign(rs.randn(B, A, 4)).astype(np.float32)
    if name in ('BCEWithLogitsLoss', 'SigmoidFocalLoss',
                'BinaryCrossEntropyWithSoftTargetsLoss',
                'CrossEntropyWithSoftTargetsLoss'):
        return logits, soft_plane(rs)
    if name == 'BCELoss':
        probs = rs.rand(B, A, C).astype(np.float32)
        probs[0, 0, :2] = [0.0, 1.0]  # the -100 clamp
        return probs, soft_plane(rs)
    if name == 'KLDivLoss':
        logp = np.log(rs.dirichlet(np.ones(C), (B, A))).astype(np.float32)
        return logp, soft_plane(rs)
    if name == 'PoissonNLLLoss':
        return (rs.randn(B, A, 4) * 0.5).astype(np.float32), rs.poisson(
            2.0, (B, A, 4)).astype(np.float32)
    if name == 'GeneralizedIoULoss':
        pred = corners(rs, (B, A))
        pred[0, 1] = pred[0, 0] + 200  # disjoint: GIoU below 0
        return pred, corners(rs, (B, A))
    raise KeyError(name)


KWARGS = {
    'SoftmaxFocalLoss': {'gamma': 2.0, 'alpha': 0.25, 'ignore_index': -1},
    'CrossEntropyLoss': {'ignore_index': -1},
    'NLLLoss': {'ignore_index': -1},
    'SmoothL1Loss': {'beta': 0.5},
    'HuberLoss': {'delta': 1.5},
    'SigmoidFocalLoss': {'gamma': 1.5, 'alpha': 0.3},
}


@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
@pytest.mark.parametrize('name', sorted(pt_losses.LOSSES))
def test_loss_matches_jax(name, reduction):
    rs = np.random.RandomState(sorted(pt_losses.LOSSES).index(name))
    pred, target = inputs(name, rs)
    mask = rs.rand(B, A) > 0.3
    kwargs = {'reduction': reduction, 'epsilon': 0.1, **KWARGS.get(name, {})}
    loss_j = jax_losses.build_loss(name, **kwargs)
    loss_p = pt_losses.build_loss(name, **kwargs)
    for flag in ('SOFT_TARGET', 'MULTICLASS', 'IOU_LOSS'):
        assert getattr(loss_p, flag) == getattr(loss_j, flag), flag
    for m in (mask, None):
        want = np.asarray(loss_j(jnp.asarray(pred), jnp.asarray(target),
                                 None if m is None else jnp.asarray(m)))
        got = loss_p(torch.from_numpy(pred), torch.from_numpy(target),
                     None if m is None else torch.from_numpy(m)).numpy()
        assert got.shape == want.shape
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **TOL, err_msg=f'mask {m is not None}')


@pytest.mark.parametrize('pos_weight', [2.0, [0.5, 1, 2, 3, 4, 5]])
def test_bce_with_logits_pos_weight_matches_jax(pos_weight):
    rs = np.random.RandomState(3)
    logits, target = inputs('BCEWithLogitsLoss', rs)
    mask = rs.rand(B, A) > 0.3
    want = jax_losses.BCEWithLogitsLoss(pos_weight=pos_weight, reduction='sum')(
        jnp.asarray(logits), jnp.asarray(target), jnp.asarray(mask))
    got = pt_losses.BCEWithLogitsLoss(pos_weight=pos_weight, reduction='sum')(
        torch.from_numpy(logits), torch.from_numpy(target), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_soften_and_the_options_jax_raises_on():
    """Label smoothing alone, and PoissonNLL's non-default options, which
    the JAX package does not implement either."""
    target = soft_plane(np.random.RandomState(4))
    for eps in (0.0, 0.05, 0.3):
        want = jax_losses._Loss(epsilon=eps)._soften(jnp.asarray(target))
        got = pt_losses._Loss(epsilon=eps)._soften(torch.from_numpy(target))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for kwargs in ({'log_input': False}, {'full': True}):
        with pytest.raises(NotImplementedError):
            jax_losses.PoissonNLLLoss(**kwargs)
        with pytest.raises(NotImplementedError):
            pt_losses.PoissonNLLLoss(**kwargs)


@pytest.mark.parametrize('cartesian', [True, False])
def test_generalized_iou_matches_jax(cartesian):
    rs = np.random.RandomState(5)
    a = corners(rs, (3, 7))
    b = corners(rs, (3, 7 if not cartesian else 5))
    a[0, 0] = b[0, 0]            # identical: 1
    a[0, 1] = b[0, 1] + 500      # far apart: towards -1
    want = np.asarray(jax_boxes.generalized_iou(jnp.asarray(a), jnp.asarray(b),
                                                cartesian=cartesian))
    got = pt_boxes.generalized_iou(torch.from_numpy(a), torch.from_numpy(b),
                                   cartesian=cartesian).numpy()
    assert got.shape == want.shape == ((3, 7, 5) if cartesian else (3, 7))
    np.testing.assert_allclose(got, want, **TOL)
    assert got.min() < -0.5 and got.max() == pytest.approx(1.0)


def multibox_inputs(seed):
    """Anchors, raw heads and assigned targets (positives, negatives and an
    IGNORE band) for the multibox loss."""
    rs = np.random.RandomState(seed)
    a = 300
    cxy = rs.rand(a, 2) * 128
    wh = rs.rand(a, 2) * 60 + 4
    anchors = np.concatenate([cxy, wh], 1).astype(np.float32)
    xy = rs.rand(B, 5, 2) * 90
    gt = np.concatenate([xy, xy + rs.rand(B, 5, 2) * 50 + 8,
                         rs.randint(1, C, (B, 5, 1)),
                         rs.rand(B, 5, 1) * 0.7 + 0.3], -1).astype(np.float32)
    mask = np.ones((B, 5), bool)
    mask[1, 3:] = False
    target = np.array(jax_matching.TargetAssigner(0.5, 0.35)(
        jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(anchors)))
    scores = (rs.randn(B, a, C) * 2).astype(np.float32)
    locs = (rs.randn(B, a, 4) * 0.5).astype(np.float32)
    return scores, locs, anchors, target


@pytest.mark.parametrize('cls_loss,loc_loss', [
    ({'name': 'CrossEntropyWithSoftTargetsLoss', 'epsilon': 0.1},
     {'name': 'GeneralizedIoULoss'}),
    ({'name': 'BinaryCrossEntropyWithSoftTargetsLoss', 'epsilon': 0.05},
     {'name': 'L1Loss'}),
    ({'name': 'SoftmaxFocalLoss', 'gamma': 2.0}, {'name': 'HuberLoss'}),
], ids=['soft-giou', 'binary-soft-l1', 'softmax-focal-huber'])
def test_multibox_branches_match_jax(cls_loss, loc_loss):
    """The soft-target branch (the one-hot at the class carrying the GT
    score, ignored anchors zero), the multiclass one and the IoU branch
    (decoded corners against the raw corner targets), with an image
    mask."""
    scores, locs, anchors, target = multibox_inputs(6)
    image_mask = np.array([True, False])
    sampler = {'name': 'hard_negative_mining', 'negative_per_positive_ratio': 3,
               'min_negative_per_image': 5}

    def build(mod, coder, sampling):
        cfg = dict(sampler)
        return mod.MultiboxLoss(
            sampler=sampling.build_sampler(cfg.pop('name'), **cfg),
            box_coder=coder.BoxCoder(), classification_loss=dict(cls_loss),
            localization_loss=dict(loc_loss), localization_weight=1.5)

    loss_j = build(jax_losses, jax_box_coder, jax_sampling)
    loss_p = build(pt_losses, pt_box_coder, pt_sampling)
    assert (loss_p.soft_target, loss_p.multiclass, loss_p.iou_loss) == (
        loss_j.soft_target, loss_j.multiclass, loss_j.iou_loss)
    for im in (None, image_mask):
        want = loss_j(jnp.asarray(scores), jnp.asarray(locs), jnp.asarray(anchors),
                      jnp.asarray(target), None if im is None else jnp.asarray(im))
        got = loss_p(torch.from_numpy(scores), torch.from_numpy(locs),
                     torch.from_numpy(anchors), torch.from_numpy(target),
                     None if im is None else torch.from_numpy(im))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
            assert np.isfinite(g.numpy())
