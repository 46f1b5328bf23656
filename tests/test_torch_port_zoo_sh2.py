"""Port parity for SSD300-ShuffleNetV2 (``samples/ssd_sh2_voc.py``): the
channel shuffle, the stride-1 and stride-2 units, the backbone's stages,
then one train step of the detector at full width and the config's own
300 px, against the JAX package on the CPU.  (The eval-mode forward of a
detector is held by the other zoo files; every module here is held in
eval or train mode above.)

Tolerances: the shuffle exactly equal; module outputs rtol 1e-5 with atol
1e-5 of max(1, each output's largest value), BN running statistics after a
train-mode call rtol 1e-5, atol 1e-6; the random initializers per conv as
``_torch_zoo_slice.py``'s ``assert_init_follows_jax`` states; one SGD step (``fused_bn`` on
the port's side, its plain kernels on the CPU, flax's BatchNorm on JAX's)
from the same initial weights: losses rtol 1e-4, each head's update
within 2e-3 of its own largest update and every other parameter's within
5e-2 of the step's largest update (``assert_step_matches``, the scheme of
the other zoo files), BN running statistics within 1e-3 of max(1, each
tensor's largest value) (the deepest extras are 2 and 1 px: a train-mode
BN there normalizes 8 and 2 values per channel of the b2 batch and
magnifies the two packages' convolution rounding; measured 4.3e-4 at
``extra3``, the port's own two BN paths 8.3e-5), and no tolerance
below one f32 step of a parameter's
largest value (``score_head3``, on a 3 px level where mining picks no
anchor of the b2 batch, moves by weight decay alone, about 5e-8 of its
1e-2 weights, and the two packages round that update differently by one
f32 step, 4.7e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo_slice import (JaxSide, as_nchw, assert_close,
                              assert_init_follows_jax, assert_step_matches,
                              batch, nchw, port_bundle,
                              port_overrides, random_variables,
                              to_jax_variables)
from single_shot_detection_tpu.models import shufflenet_v2 as jax_sh2
from single_shot_detection_tpu_torch.models import shufflenet_v2 as pt_sh2
from single_shot_detection_tpu_torch.models.layers import BatchNorm, reset_conv
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.weights import from_jax_variables
from _torch_port_fixtures import one_torch_thread  # noqa: F401

CONFIG = 'samples/ssd_sh2_voc.py'
SIZE = 300


@pytest.fixture(scope='module')
def jax_side():
    """The JAX detector, from the port's seeded initialization (the
    backbone's initializers are held against JAX's in
    ``test_shufflenet_v2_stages_match_jax``)."""
    variables = to_jax_variables(
        port_bundle(CONFIG, SIZE, seed=5).module.state_dict())
    return JaxSide(CONFIG, SIZE, variables=variables)


def test_channel_shuffle_matches_jax():
    x = np.random.RandomState(0).randn(2, 3, 5, 12).astype(np.float32)
    for groups in (2, 3):
        want = jax_sh2.channel_shuffle(jnp.asarray(x), groups)
        got = pt_sh2.channel_shuffle(nchw(x), groups)
        np.testing.assert_array_equal(got.numpy(), as_nchw(want))


@pytest.mark.parametrize('stride,in_channels', [(1, 16), (2, 12)])
def test_shuffle_unit_matches_jax(stride, in_channels):
    """A stride-1 unit (half the channels pass through) and a stride-2 unit
    (both branches on the whole input; no ReLU after the depthwise BNs) on
    a 9 px input, in train mode: outputs and running statistics."""
    jm = jax_sh2.ShuffleUnit(16, stride=stride)
    pm = pt_sh2.ShuffleUnit(in_channels, 16, stride=stride)
    rng = np.random.RandomState(stride)
    x = rng.randn(2, 9, 9, in_channels).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), rng=rng)
    want, updated = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(x), True, mutable=['batch_stats']))(variables)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = pm.train()(nchw(x))
    assert got.shape[1:] == (16, 5 if stride == 2 else 9, 5 if stride == 2 else 9)
    assert_close(got.numpy(), as_nchw(want))
    state = pm.state_dict()
    for k, v in from_jax_variables({'batch_stats': updated['batch_stats']}).items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_shufflenet_v2_stages_match_jax():
    """x0.5's six stages at 67 px (34, 17, 9, 5, 3, 3 px; 24, 24, 48, 96,
    192, 1024 channels), equal to JAX's in eval mode, ``max_stage`` cuts,
    parameter count; and the initializers (lecun-normal) of x1.0's stage-4
    stride unit (232 -> 464) against JAX's own initialization."""
    jm = jax_sh2.ShuffleUnit(464, stride=2)
    init = jax.jit(lambda key: jm.init(key, jnp.zeros((1, 3, 3, 232))))(
        jax.random.PRNGKey(0))
    pm = pt_sh2.ShuffleUnit(232, 464, stride=2)
    generator = torch.Generator().manual_seed(5)
    for m in pm.modules():
        if isinstance(m, torch.nn.Conv2d):
            reset_conv(m, generator)
    assert assert_init_follows_jax(pm, init) == 5

    jm = jax_sh2.ShuffleNetV2(channels=jax_sh2.SHUFFLENET_WIDTHS[0.5])
    pm = pt_sh2.ShuffleNetV2(pt_sh2.SHUFFLENET_WIDTHS[0.5])
    rng = np.random.RandomState(4)
    x = rng.randn(2, 67, 67, 3).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), rng=rng)
    want, _ = jax.jit(lambda v: jm.apply(v, jnp.asarray(x)))(variables)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got, _ = pm.eval()(nchw(x))
        cut, _ = pm(nchw(x), max_stage=3)
    assert [g.shape[2] for g in got] == [34, 17, 9, 5, 3, 3]
    assert [g.shape[1] for g in got] == pm.stage_channels == [24, 24, 48, 96, 192, 1024]
    assert len(cut) == 4
    for g, w in zip(got, want, strict=True):
        assert_close(g.numpy(), as_nchw(w))
    assert sum(p.numel() for p in pm.parameters()) == sum(
        v.size for v in jax.tree_util.tree_leaves(variables['params']))


def test_train_step_matches_jax(jax_side):
    images, boxes, mask = batch(SIZE)
    step_j, state_j = jax_side.train_step()
    trainer = Trainer.from_config(CONFIG, variables=jax_side.variables,
                                  device='cpu', overrides=port_overrides(SIZE))
    assert sum(isinstance(m, BatchNorm) for m in trainer.model.modules()) == 68
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    before_j = from_jax_variables({'params': state_j.params})
    state_j, metrics_j = step_j(state_j, {'image': images, 'boxes': boxes,
                                          'box_mask': mask},
                                jax.random.PRNGKey(0))
    metrics = trainer.train_step(images, boxes, mask)
    for k in ('loss', 'class_loss', 'loc_loss'):
        np.testing.assert_allclose(metrics[k].item(), float(metrics_j[k]),
                                   rtol=1e-4, err_msg=k)
    assert_step_matches(trainer, before, state_j, before_j, head_rel=2e-3,
                        step_rel=5e-2, ulp_floor=True, stats_rel=1e-3)
