"""Port parity for SSD300-VGG16 (``samples/ssd_300_vgg16_voc.py``) at full
width and a reduced input of 160 px (taps at 20 and 10 px, the extras down
to 1 px), against the JAX package on the CPU.

Tolerances: the random initializers per conv as ``_torch_zoo_slice.py``'s
``assert_init_follows_jax`` states; the eval forward with perturbed BNs and
score heads atol 1e-4 of each output's largest value, heads and the six
sources; one SGD step (``fused_bn`` on the port's side, its plain kernels
on the CPU, flax's BatchNorm on JAX's) from JAX's own initialization, hard
negative mining over the softmax cross entropy: losses rtol 1e-4, each
head's update within 5e-4 of its own largest update and every other
parameter's within 2e-2 of the step's largest update, BN running
statistics within 1e-4 of max(1, each tensor's largest value)
(``assert_step_matches``).  Measured: the heads within 4.7e-5 of their
own, the rest within 6.1e-3 of the step (the port with PyTorch's BN and
with the BN kernels' plain versions: 1.0e-3).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_zoo_slice import (JaxSide, assert_init_follows_jax,
                              assert_step_matches, batch, perturb, port_bundle,
                              port_overrides)
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.weights import from_jax_variables
from _torch_port_fixtures import one_torch_thread  # noqa: F401

CONFIG = 'samples/ssd_300_vgg16_voc.py'
SIZE = 160


@pytest.fixture(scope='module')
def jax_side():
    return JaxSide(CONFIG, SIZE)


def test_random_init_follows_jax_initializers(jax_side):
    """lecun-normal VGG convs with zero biases, xavier-normal extras,
    normal(0.01) heads; seeded."""
    a = port_bundle(CONFIG, SIZE, seed=5).module
    assert assert_init_follows_jax(a, jax_side.variables) == 13 + 8 + 12
    b = port_bundle(CONFIG, SIZE, seed=5).module
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name


def test_eval_forward_matches_jax(jax_side):
    rng = np.random.RandomState(8)
    variables = perturb(jax_side.variables, rng, score_gain=30.0)
    x = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    want_s, want_l, want_src = jax_side.forward(variables, x)
    bundle = port_bundle(CONFIG, SIZE, variables=variables)
    np.testing.assert_array_equal(bundle.anchors, jax_side.bundle.anchors())
    with torch.no_grad():
        got_s, got_l, got_src = bundle.module.eval()(
            torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), return_sources=True)
    assert [s.shape[2] for s in got_src] == [20, 10, 5, 3, 2, 1]
    pairs = [(got_s, want_s), (got_l, want_l)] + [
        (g, np.asarray(w).transpose(0, 3, 1, 2)) for g, w in zip(got_src, want_src)]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_train_step_matches_jax(jax_side):
    images, boxes, mask = batch(SIZE)
    step_j, state_j = jax_side.train_step()
    trainer = Trainer.from_config(CONFIG, variables=jax_side.variables,
                                  device='cpu', overrides=port_overrides(SIZE))
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    before_j = from_jax_variables({'params': state_j.params})
    state_j, metrics_j = step_j(state_j, {'image': images, 'boxes': boxes,
                                          'box_mask': mask},
                                jax.random.PRNGKey(0))
    metrics = trainer.train_step(images, boxes, mask)
    for k in ('loss', 'class_loss', 'loc_loss'):
        np.testing.assert_allclose(metrics[k].item(), float(metrics_j[k]),
                                   rtol=1e-4, err_msg=k)
    assert_step_matches(trainer, before, state_j, before_j, head_rel=5e-4,
                        step_rel=2e-2)
