"""Port parity for M2Det-512-VGG16 (``samples/m2det_512_vgg16_voc.py``):
the TUM, the SFAM and the MLFPN as modules, then the detector at full
width with 2 of its 8 TUMs (the full depth is held by the geometry test of
``test_torch_port_zoo.py``) at a reduced input of 264 px, against the JAX
package on the CPU.  At 264 px the VGG taps are 33 and 16 px and the TUM
levels 33, 17, 9, 5, 3, 2, so the base feature's and every TUM's
upsamples are non-exact (``jax.image.resize``'s nearest is torch's
``nearest-exact``).  264 px is the least size whose deepest level is not
1x1: a train-mode BN over a 1x1 map of a b2 batch normalizes 2 values per
channel, whose gradient is 0 except where the two nearly tie, and there
up to ``1 / (2 sqrt(eps))`` = 158 times the incoming one; at 168 px that
made the port's own two BN paths differ by the step's largest update.

Tolerances: module outputs rtol 1e-5 with atol 1e-5 of max(1, each
output's largest value), BN running statistics after a train-mode call
rtol 1e-5, atol 1e-6; the MLFPN's random initializers per conv as
``_torch_zoo_slice.py``'s ``assert_init_follows_jax`` states; the eval
forward with perturbed BNs and score heads atol 1e-4 of each output's
largest value, heads and the six sources; one SGD step (``fused_bn`` on
the port's side, its plain kernels on the CPU, flax's BatchNorm on JAX's)
from the same initial weights: losses rtol 1e-4, each head's update within
2e-3 of its own largest update and every other parameter's within 5e-2 of
the step's largest update, BN running statistics within 1e-4 of max(1,
each tensor's largest value) (``assert_step_matches``, the scheme of the
other zoo files: at random init 48 train-mode BNs in series make two
correct f32 steps differ by percents of a tensor's own update; measured
at 264 px, JAX and the port within 1.8e-2 of the step's largest update,
the port's two BN paths within 9.0e-3).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo_slice import (JaxSide, as_nchw, assert_close,
                              assert_init_follows_jax, assert_step_matches,
                              batch, nchw, perturb, port_bundle,
                              port_overrides, random_variables,
                              to_jax_variables)
from single_shot_detection_tpu.models import features as jax_features
from single_shot_detection_tpu.models import mobilenet as jax_mobilenet
from single_shot_detection_tpu.utils.config import load_config as jax_load_config
from single_shot_detection_tpu_torch.models import features as pt_features
from single_shot_detection_tpu_torch.models import mobilenet as pt_mobilenet
from single_shot_detection_tpu_torch.models.layers import BatchNorm, reset_conv
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.weights import from_jax_variables
from _torch_port_fixtures import one_torch_thread  # noqa: F401

CONFIG = 'samples/m2det_512_vgg16_voc.py'
SIZE = 264
TUMS = 2


def reduced_model():
    """The config's ``model`` with ``TUMS`` TUMs."""
    model = copy.deepcopy(dict(jax_load_config(CONFIG).model))
    model['detector']['features']['num_tums'] = TUMS
    return model


@pytest.fixture(scope='module')
def jax_side():
    """The JAX detector, from the port's seeded initialization (the same
    initializers: ``test_mlfpn_initializers_follow_jax`` and the VGG and
    RetinaNet files), which spares the JAX init's compile."""
    variables = to_jax_variables(port_bundle(
        CONFIG, SIZE, seed=5, model=reduced_model()).module.state_dict())
    return JaxSide(CONFIG, SIZE, model=reduced_model(), variables=variables)


def train_mode_pair(jm, pm, x, variables):
    """``jm`` and ``pm`` (weights from ``variables``) in train mode on NHWC
    ``x``: JAX's outputs and updated statistics, the port's outputs and
    ``state_dict``."""
    want, updated = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(x), True, mutable=['batch_stats']))(variables)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = pm.train()(nchw(x))
    return want, updated, got, pm.state_dict()


def assert_stats(state, updated):
    for k, v in from_jax_variables({'batch_stats': updated['batch_stats']}).items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize('use_depthwise', [False, True])
def test_thinned_ushape_module_matches_jax(use_depthwise):
    """4 scales from an 11 px input (11, 6, 3, 2: every upsample
    non-exact), the up convs to the skip's width (12 at the first level),
    the smooth convs named deepest-first, in train mode."""
    kw = dict(inner_channels=8, out_channels=6, num_scales=4,
              use_depthwise=use_depthwise)
    jm = jax_features.ThinnedUshapeModule(**kw)
    pm = pt_features.ThinnedUshapeModule(12, **kw)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 11, 11, 12).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), rng=rng)
    want, updated, got, state = train_mode_pair(jm, pm, x, variables)
    assert [g.shape[2] for g in got] == [2, 3, 6, 11]
    prefix = 'up1.pointwise_conv' if use_depthwise else 'up1.conv'
    assert state[f'{prefix}.weight'].shape[0] == 12
    for g, w in zip(got, want, strict=True):
        assert_close(g.numpy(), as_nchw(w))
    assert_stats(state, updated)


def test_scalewise_feature_aggregation_matches_jax():
    """Per scale: the spatial mean, ``fc1_{i}`` and ``fc2_{i}`` with bias,
    ReLU and sigmoid gates onto the map."""
    jm = jax_features.ScalewiseFeatureAggregationModule(num_scales=3,
                                                        reduction_ratio=4)
    pm = pt_features.ScalewiseFeatureAggregationModule([16, 16, 16],
                                                       reduction_ratio=4)
    rng = np.random.RandomState(2)
    feats = [rng.randn(2, s, s, 16).astype(np.float32) for s in (9, 5, 3)]
    variables = random_variables(jm, [jnp.asarray(f) for f in feats], rng=rng)
    want = jax.jit(lambda v: jm.apply(v, [jnp.asarray(f) for f in feats]))(
        variables)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    assert pm.fc1_2.weight.shape == (4, 16, 1, 1) and pm.fc2_0.bias.shape == (16,)
    with torch.no_grad():
        got = pm([nchw(f) for f in feats])
    for g, w in zip(got, want, strict=True):
        assert_close(g.numpy(), as_nchw(w))


def test_multilevel_feature_pyramid_matches_jax_at_reduced_depth():
    """The MLFPN with 3 depthwise TUMs of 4 scales on MobileNet v1 x0.25
    taps (5, 11) at 88 px (11 and 6 px: a non-exact base upsample, TUM
    levels 11, 6, 3, 2), config dicts filtered as JAX filters them, in
    eval mode: outputs large -> small, ``x`` the smallest.  (In train
    mode 27 BNs of 8 to 64 channels in series, down to 8 values per
    channel, double the two packages' rounding differences at every
    stage: 3e-3 of the output at 88 px.  The TUM test above holds train
    mode.)"""
    kw = dict(out_layers=(5, 11), num_scales=4, num_tums=3,
              base_reduced_channels=(16, 8), reduced_channels=8,
              use_depthwise=True,
              tum={'inner_channels': 16, 'out_channels': 8, 'ignored': 1},
              sfam={'reduction_ratio': 4, 'ignored': 1})
    jm = jax_features.MultilevelFeaturePyramid(
        base=jax_mobilenet.MobileNet(depth_multiplier=0.25), **kw)
    pm = pt_features.MultilevelFeaturePyramid(
        pt_mobilenet.MobileNet(depth_multiplier=0.25), **kw)
    assert pm.channels == [24] * 4 and pm.tum1.down1.depthwise_conv.in_channels == 16
    rng = np.random.RandomState(3)
    x = rng.randn(2, 88, 88, 3).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), rng=rng)
    want, _ = jax.jit(lambda v: jm.apply(v, jnp.asarray(x)))(variables)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got, got_x = pm.eval()(nchw(x))
    assert [g.shape[2] for g in got] == [11, 6, 3, 2]
    assert got_x is got[-1]
    for g, w in zip(got, want, strict=True):
        assert_close(g.numpy(), as_nchw(w))


def test_mlfpn_initializers_follow_jax():
    """xavier-normal convs in a TUM at M2Det's widths (768 in, 256 inner,
    128 out; 3 scales) and in the SFAM's 1024-wide gates, zero biases,
    identity BNs, against JAX's own initialization of the same modules."""
    tum_kw = dict(inner_channels=256, out_channels=128, num_scales=3)
    for jm, pm, inputs in (
            (jax_features.ThinnedUshapeModule(**tum_kw),
             pt_features.ThinnedUshapeModule(768, **tum_kw),
             (jnp.zeros((1, 5, 5, 768)),)),
            (jax_features.ScalewiseFeatureAggregationModule(num_scales=2),
             pt_features.ScalewiseFeatureAggregationModule([1024] * 2),
             ([jnp.zeros((1, 1, 1, 1024))] * 2,))):
        want = jax.jit(lambda key: jm.init(key, *inputs))(jax.random.PRNGKey(0))
        generator = torch.Generator().manual_seed(5)
        for m in pm.modules():
            if isinstance(m, torch.nn.Conv2d):
                reset_conv(m, generator)
        assert assert_init_follows_jax(pm, want) == sum(
            isinstance(m, torch.nn.Conv2d) for m in pm.modules())


def test_eval_forward_matches_jax(jax_side):
    rng = np.random.RandomState(8)
    variables = perturb(jax_side.variables, rng, score_gain=30.0)
    x = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    want_s, want_l, want_src = jax_side.forward(variables, x)
    bundle = port_bundle(CONFIG, SIZE, variables=variables,
                         model=reduced_model())
    np.testing.assert_array_equal(bundle.anchors, jax_side.bundle.anchors())
    assert sum(isinstance(m, BatchNorm) for m in bundle.module.modules()) == (
        13 + 2 + TUMS * 16 + (TUMS - 1))
    with torch.no_grad():
        got_s, got_l, got_src = bundle.module.eval()(nchw(x),
                                                     return_sources=True)
    assert [s.shape[2] for s in got_src] == [33, 17, 9, 5, 3, 2]
    assert [s.shape[1] for s in got_src] == [128 * TUMS] * 6
    pairs = [(got_s, want_s), (got_l, want_l)] + [
        (g, as_nchw(w)) for g, w in zip(got_src, want_src, strict=True)]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_train_step_matches_jax(jax_side):
    images, boxes, mask = batch(SIZE)
    step_j, state_j = jax_side.train_step()
    trainer = Trainer.from_config(CONFIG, variables=jax_side.variables,
                                  device='cpu', overrides=port_overrides(
                                      SIZE, model=reduced_model()))
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
                        step_rel=5e-2)
