"""The port's gradients at a tie against the JAX package's.

At a clamp's bound JAX's ``jnp.minimum``, ``jnp.maximum`` and ``jnp.clip``
pass half the gradient and ``jnp.abs`` passes 1 at 0; ``torch.clamp``
passes all of it and ``torch.abs`` 0 (``F.relu6`` passes none).  Every
clamp and absolute value on a gradient path of the port takes JAX's rule.
Each case below puts inputs exactly at the bound (ReLU6 at 0 and 6, a box
of zero width, two boxes that touch, a logit of 0, a prediction equal to
its target, a probability of 0 or 1 under the BCE's log floor, a BN
channel whose fast variance rounds below 0) beside ordinary ones,
and holds the gradient of a weighted sum of the site's output against
JAX's on the same numpy input: equal up to the last bits of the smooth
terms (rtol 1e-6, atol 1e-7; a tie's share is 0.5 of a term; the BN case
rtol 1e-4, as stated there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from single_shot_detection_tpu.models import layers as jax_layers
from single_shot_detection_tpu.models import mobilenet as jax_mobilenet
from single_shot_detection_tpu.models import mobilenet_v2 as jax_mobilenet_v2
from single_shot_detection_tpu.ops import boxes as jax_boxes
from single_shot_detection_tpu.ops import losses as jax_losses
from single_shot_detection_tpu_torch.models import layers as pt_layers
from single_shot_detection_tpu_torch.models import mobilenet as pt_mobilenet
from single_shot_detection_tpu_torch.models import mobilenet_v2 as pt_mobilenet_v2
from single_shot_detection_tpu_torch.ops import boxes as pt_boxes
from single_shot_detection_tpu_torch.ops import losses as pt_losses
from _torch_port_fixtures import one_torch_thread  # noqa: F401

RELU6_X = np.array([-1.0, 0.0, 6.0, 7.0, 3.0, 5.9999995, -0.0], np.float32)
# zero width, zero height, a point, an ordinary box
BOXES = np.array([[1, 2, 1, 5], [0, 0, 3, 0], [2, 2, 2, 2], [0, 0, 4, 3]],
                 np.float32)
# pairs that touch along x and along y (enclosing box larger than the
# union, so the loss feels the intersection), at a corner, and overlap
GIOU_A = np.array([[0, 0, 2, 2], [0, 0, 2, 2], [0, 0, 2, 2], [0, 0, 3, 3]],
                  np.float32)
GIOU_B = np.array([[2, 0, 4, 3], [0, 2, 3, 4], [2, 2, 3, 3], [1, 1, 4, 4]],
                  np.float32)
LOGITS = np.array([[0.0, 1.5, -2.0], [0.0, 0.0, 0.3]], np.float32)
TARGET = np.array([[1.0, 0.0, 1.0], [0.0, 0.7, 0.0]], np.float32)
PRED = np.array([[1.0, -2.0, 0.5, 0.0], [3.0, 3.0, -1.0, 2.0]], np.float32)
PRED_TARGET = np.array([[1.0, -1.0, 0.5, 1.0], [3.0, 2.0, -1.0, 2.0]],
                       np.float32)
# log 0 lies under the floor of -100 (no f32 probability has a log of
# -100 exactly); both packages' gradients are NaN there
PROBS = np.array([[0.5, 1e-30, 0.999], [0.0, 0.25, 1.0]], np.float32)
PROB_TARGET = np.array([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0]], np.float32)
# one BN channel [2, 1, 2, 2] whose E[x^2] - E[x]^2 rounds to -1 in f32 in
# both packages (the true variance is 9.7e-5): flax clips it to 0 and
# passes no gradient through it
BN_X = np.array([3000.009521484375, 2999.987548828125, 3000.00634765625,
                 3000.01513671875, 3000.021484375, 3000.0068359375,
                 2999.996337890625, 3000.0029296875],
                np.float32).reshape(2, 1, 2, 2)
BN_SCALE, BN_BIAS = np.array([1.5], np.float32), np.array([0.25], np.float32)


def port_sync_bn(x):
    return pt_layers.SyncBatchNormFunction.apply(
        x, torch.from_numpy(BN_SCALE), torch.from_numpy(BN_BIAS), 1e-5)[0]


def flax_bn(x):
    """flax's train-mode ``nn.BatchNorm`` (its ``_compute_stats``), NCHW."""
    variables = {'params': {'scale': BN_SCALE, 'bias': BN_BIAS},
                 'batch_stats': {'mean': jnp.zeros(1), 'var': jnp.ones(1)}}
    z, _ = nn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5).apply(
        variables, x.transpose(0, 2, 3, 1), mutable=['batch_stats'])
    return z.transpose(0, 3, 1, 2)


def site(port_fn, jax_fn, x, *rest, rtol=1e-6):
    return port_fn, jax_fn, x, rest, rtol


SITES = {
    'layers.ACTIVATIONS[ReLU6]': site(
        pt_layers.ACTIVATIONS['ReLU6'], jax_layers.ACTIVATIONS['ReLU6'],
        RELU6_X),
    'mobilenet_v2.relu6': site(pt_mobilenet_v2.relu6,
                               jax_mobilenet_v2._relu6, RELU6_X),
    'mobilenet.relu6': site(pt_mobilenet.relu6, jax_mobilenet._relu6,
                            RELU6_X),
    'boxes.area': site(pt_boxes.area, jax_boxes.area, BOXES),
    'GeneralizedIoULoss': site(
        lambda a, b: pt_losses.GeneralizedIoULoss(reduction='none')(a, b),
        lambda a, b: jax_losses.GeneralizedIoULoss(reduction='none')(a, b),
        GIOU_A, GIOU_B),
    'BCEWithLogitsLoss': site(
        lambda x, t: pt_losses.BCEWithLogitsLoss(reduction='none')(x, t),
        lambda x, t: jax_losses.BCEWithLogitsLoss(reduction='none')(x, t),
        LOGITS, TARGET),
    'SigmoidFocalLoss': site(
        lambda x, t: pt_losses.SigmoidFocalLoss(reduction='none')(x, t),
        lambda x, t: jax_losses.SigmoidFocalLoss(reduction='none')(x, t),
        LOGITS, TARGET),
    'BinaryCrossEntropyWithSoftTargetsLoss': site(
        lambda x, t: pt_losses.BinaryCrossEntropyWithSoftTargetsLoss(
            reduction='none')(x, t),
        lambda x, t: jax_losses.BinaryCrossEntropyWithSoftTargetsLoss(
            reduction='none')(x, t),
        LOGITS, TARGET),
    'L1Loss': site(
        lambda p, t: pt_losses.L1Loss(reduction='none')(p, t),
        lambda p, t: jax_losses.L1Loss(reduction='none')(p, t),
        PRED, PRED_TARGET),
    # rstd = 316 magnifies the rounding of dz - mean(dz) to 2.7e-5 of dx;
    # the gradient through the variance would add up to 5 times dx
    'SyncBatchNormFunction, variance clipped': site(port_sync_bn, flax_bn,
                                                    BN_X, rtol=1e-4),
    'BCELoss': site(
        lambda p, t: pt_losses.BCELoss(reduction='none')(p, t),
        lambda p, t: jax_losses.BCELoss(reduction='none')(p, t),
        PROBS, PROB_TARGET),
}


@pytest.mark.parametrize('name', sorted(SITES))
def test_gradient_at_the_bound_matches_jax(name):
    port_fn, jax_fn, x, rest, rtol = SITES[name]
    want_out = np.asarray(jax.jit(jax_fn)(x, *rest))
    weights = np.random.RandomState(0).uniform(
        0.5, 1.5, want_out.shape).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(
        lambda v, *r: jnp.sum(jax_fn(v, *r) * weights)))(x, *rest))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out = port_fn(xt, *map(torch.from_numpy, rest))
    (out * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-6,
                               atol=1e-7, err_msg=f'{name} forward')
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=rtol, atol=1e-7,
                               err_msg=f'{name} gradient')
    if x is BN_X:  # the case reaches the clip in the port's arithmetic
        xf = torch.from_numpy(x)
        assert float((xf * xf).mean() - xf.mean() ** 2) < 0
    if x is RELU6_X:  # half the gradient at 6, none at 0
        np.testing.assert_array_equal(want[x == 6.0], 0.5 * weights[x == 6.0])
        np.testing.assert_array_equal(want[x == 0.0], 0.0)
