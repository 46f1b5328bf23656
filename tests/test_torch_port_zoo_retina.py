"""Port parity for RetinaNet-ResNet50 (``samples/retina_rn50_500_voc.py``)
at full width and a reduced input of 200 px, whose pyramid levels (25, 13,
7, 4, 2) are not exact halves, against the JAX package on the CPU.

Tolerances: the random initializers per conv as ``_torch_zoo_slice.py``'s
``assert_init_follows_jax`` states; the eval forward with perturbed BNs and
score heads (logits spread over tens) atol 1e-4 of each output's largest
value, heads and the five loc-tower sources; the SIGMOID postprocessor on
the same heads: valid masks equal, detections atol 1e-3 px and 1e-6 in
score; one SGD step (``fused_bn`` on the port's side, its plain kernels on
the CPU, flax's BatchNorm on JAX's) from JAX's own initialization: losses
rtol 1e-4, each head's update within 2e-3 of its own largest update and
every other parameter's within 5e-2 of the step's largest update, BN
running statistics within 1e-4 of max(1, each tensor's largest value)
(``assert_step_matches``).  At random init
the 98 train-mode BNs' backward cancels: the port with PyTorch's BN and
with the BN kernels' plain versions differ by 1.1e-2 of the step's largest
update (the stem conv) and by 12 % of a tower conv's own, JAX and the port
by 2.7e-2; the heads agree within 5.3e-4 of their own.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_zoo_slice import (JaxSide, assert_init_follows_jax,
                              assert_step_matches, batch, perturb, port_bundle,
                              port_overrides)
from single_shot_detection_tpu.ops.box_coder import BoxCoder as JaxBoxCoder
from single_shot_detection_tpu.ops.postprocess import Postprocessor as JaxPostprocessor
from single_shot_detection_tpu_torch.ops import bn_kernel
from single_shot_detection_tpu_torch.ops.box_coder import BoxCoder
from single_shot_detection_tpu_torch.ops.postprocess import Postprocessor
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.weights import from_jax_variables
from _torch_port_fixtures import one_torch_thread  # noqa: F401

CONFIG = 'samples/retina_rn50_500_voc.py'
SIZE = 200


@pytest.fixture(scope='module')
def jax_side():
    return JaxSide(CONFIG, SIZE)


@pytest.fixture(scope='module')
def forward(jax_side):
    """Perturbed variables, a seeded b2 input, and JAX's heads and
    sources on it."""
    rng = np.random.RandomState(7)
    variables = perturb(jax_side.variables, rng, score_gain=100.0)
    x = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    return variables, x, jax_side.forward(variables, x)


def test_random_init_follows_jax_initializers(jax_side):
    """lecun-normal ResNet convs, normal(0.03) FPN convs, normal(0.01)
    towers and heads, the score heads' -4.6 bias; seeded."""
    a = port_bundle(CONFIG, SIZE, seed=5).module
    assert assert_init_follows_jax(a, jax_side.variables) == 53 + 8 + 8 + 10
    b = port_bundle(CONFIG, SIZE, seed=5).module
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name


def test_eval_forward_matches_jax(jax_side, forward):
    variables, x, (want_s, want_l, want_src) = forward
    bundle = port_bundle(CONFIG, SIZE, variables=variables)
    np.testing.assert_array_equal(bundle.anchors, jax_side.bundle.anchors())
    model = bundle.module.eval()
    with torch.no_grad():
        got_s, got_l, got_src = model(
            torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), return_sources=True)
    assert [s.shape[2] for s in got_src] == [25, 13, 7, 4, 2]
    assert float(np.asarray(want_s).std()) > 5  # the logits spread
    pairs = [(got_s, want_s), (got_l, want_l)] + [
        (g, np.asarray(w).transpose(0, 3, 1, 2)) for g, w in zip(got_src, want_src)]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_sigmoid_postprocessor_matches_jax(jax_side, forward):
    """The serving postprocessor (``pre_nms_top_k=1000``, as the preset
    sets above 10,000 anchors) on JAX's heads: the port's plain NMS path
    against JAX's."""
    _, _, heads = forward
    scores, locs = (np.array(h) for h in heads[:2])
    cfg = dict(jax_side.cfg.postprocess, pre_nms_top_k=1000)
    assert cfg['score_converter'] == 'SIGMOID'
    anchors = jax_side.bundle.anchors()
    want_d, want_v = map(np.asarray, JaxPostprocessor(
        JaxBoxCoder(**jax_side.cfg.box_coder), use_pallas=False, **cfg)(
            scores, locs, anchors))
    got_d, got_v = Postprocessor(BoxCoder(**jax_side.cfg.box_coder), **cfg)(
        torch.from_numpy(scores), torch.from_numpy(locs),
        torch.from_numpy(anchors))
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    assert 0 < want_v.sum() and set(np.unique(want_d[want_v][:, 4])) <= set(
        range(1, 21))
    np.testing.assert_allclose(got_d.numpy()[want_v][:, :4],
                               want_d[want_v][:, :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got_d.numpy()[want_v][:, 4:],
                               want_d[want_v][:, 4:], rtol=0, atol=1e-6)


def test_train_step_matches_jax(jax_side):
    """One SGD step from JAX's own initialization, the focal loss over the
    naive sampler's positives."""
    images, boxes, mask = batch(SIZE)
    step_j, state_j = jax_side.train_step()
    trainer = Trainer.from_config(CONFIG, variables=jax_side.variables,
                                  device='cpu', overrides=port_overrides(SIZE))
    for fn in bn_kernel.KERNELS:
        fn.launches = 0
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    before_j = from_jax_variables({'params': state_j.params})
    state_j, metrics_j = step_j(state_j, {'image': images, 'boxes': boxes,
                                          'box_mask': mask},
                                jax.random.PRNGKey(0))
    metrics = trainer.train_step(images, boxes, mask)
    for k in ('loss', 'class_loss', 'loc_loss'):
        np.testing.assert_allclose(metrics[k].item(), float(metrics_j[k]),
                                   rtol=1e-4, err_msg=k)
    assert [fn.launches for fn in bn_kernel.KERNELS] == [0, 0, 0, 0]
    assert_step_matches(trainer, before, state_j, before_j, head_rel=2e-3,
                        step_rel=5e-2)
