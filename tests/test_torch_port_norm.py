"""Port parity for ``train.group_norm`` (``models/norm.py``), MobileNet v1
and the depthwise FPN, against the JAX package on the CPU.

``train.group_norm`` makes every BatchNorm a GroupNorm over its own
parameters in train, eval and serving, and never writes the running
statistics.  MobileNet v1 and the depthwise FPN are held as modules and,
under ``MBV1_DFPN_MODEL`` (``_torch_zoo_slice.py``; no shipped config uses
them), as the detector that the GroupNorm step and evaluation run.

Tolerances: group counts and config values equal; module outputs rtol
1e-5 with atol 1e-5 of max(1, each output's largest value); running
statistics untouched, bit for bit; the initializers per conv as
``_torch_zoo_slice.py``'s ``assert_init_follows_jax`` states; the
detector's GroupNorm eval forward atol 1e-4 of each output's largest
value, heads and the six sources; one SGD step from the same weights:
losses rtol 1e-4, each head's update within 2e-3 of its own largest
update and every other parameter's within 5e-2 of the step's largest
update (``assert_step_matches``, the scheme of the zoo files), and none
below one f32 step of the parameter's largest value (a head of a level
where mining picks no anchor moves by weight decay alone, and the two
packages round that update one step apart).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo_slice import (MBV1_DFPN_MODEL, JaxSide, as_nchw, assert_close,
                              assert_init_follows_jax, assert_step_matches,
                              batch, nchw, perturb, port_bundle,
                              port_overrides, random_variables,
                              to_jax_variables)
from single_shot_detection_tpu.models import features as jax_features
from single_shot_detection_tpu.models import layers as jax_layers
from single_shot_detection_tpu.models import mobilenet as jax_mobilenet
from single_shot_detection_tpu.models import norm as jax_norm
from single_shot_detection_tpu_torch.models import features as pt_features
from single_shot_detection_tpu_torch.models import layers as pt_layers
from single_shot_detection_tpu_torch.models import mobilenet as pt_mobilenet
from single_shot_detection_tpu_torch.models import norm as pt_norm
from single_shot_detection_tpu_torch.models.layers import BatchNorm, reset_conv
from single_shot_detection_tpu_torch.predict import Predictor
from single_shot_detection_tpu_torch.train import checkpoint as ckpt
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.weights import from_jax_variables
from _torch_port_fixtures import one_torch_thread  # noqa: F401

CONFIG = 'samples/ssd_mb2_voc.py'
SMOKE = 'samples/synthetic_smoke.py'
SIZE = 300


def test_group_counts_and_config_values_match_jax():
    for c in (1, 4, 6, 7, 12, 58, 116, 1024):
        for g in (1, 4, 8, 32):
            assert pt_norm.num_groups(c, g) == jax_norm._num_groups(c, g)
    assert pt_norm.groups_from_config(True) == pt_norm.DEFAULT_GROUPS == 8
    assert pt_norm.groups_from_config(4) == 4
    assert pt_norm.groups_from_config({'groups': 6}) == 6
    for off in (None, False, 0, {}):
        assert pt_norm.groups_from_config(off) is None


@pytest.mark.parametrize('train', [False, True])
def test_group_norm_matches_jax_interceptor(train):
    """A ``ConvBn`` of 12 channels at 8 groups (6 groups of 2: 8 does not
    divide 12) through JAX's ``group_norm_apply`` and the port's
    ``set_group_norm``: outputs, and the running statistics untouched."""
    jm = jax_layers.ConvBn(12, kernel_size=3, padding=1, activation=None)
    pm = pt_layers.ConvBn(5, 12, kernel_size=3, padding=1, activation=None)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 9, 5).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), rng=rng)
    gn = jax_norm.group_norm_apply(jm, groups=8)
    want, mutated = jax.jit(lambda v: gn(v, jnp.asarray(x), train=train,
                                         mutable=['batch_stats']))(variables)
    for a, b in zip(jax.tree_util.tree_leaves(mutated['batch_stats']),
                    jax.tree_util.tree_leaves(variables['batch_stats'])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    state = from_jax_variables(variables)
    pm.load_state_dict(state, strict=True)
    assert pt_layers.set_group_norm(pm, 8) == 1
    with torch.no_grad():
        got = pm.train(train)(nchw(x))
    assert_close(got.numpy(), as_nchw(want))
    for k in ('bn.running_mean', 'bn.running_var'):
        assert torch.equal(pm.state_dict()[k], state[k]), k
    pt_layers.set_group_norm(pm, None)
    with torch.no_grad():
        assert not torch.allclose(pm.eval()(nchw(x)), got)


def test_mobilenet_v1_stages_match_jax():
    """x0.25 with ``min_depth=16`` (stage 0's 8 channels become 16) at an
    odd 67 px (TF's asymmetric stride-2 padding: 33, 16, 8, 4, 2 px), its
    14 stages equal to
    JAX's in eval mode and ``max_stage`` cuts; xavier-uniform convs of a
    512-wide block against JAX's own initialization; ``width_overrides``
    narrows a stage and what reads it."""
    jm = jax_mobilenet.MobileNet(depth_multiplier=0.25, min_depth=16)
    pm = pt_mobilenet.MobileNet(depth_multiplier=0.25, min_depth=16)
    assert pm.stage_channels == [16, 16, 32, 32, 64, 64] + [128] * 6 + [256] * 2
    rng = np.random.RandomState(1)
    x = rng.randn(2, 67, 67, 3).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), rng=rng)
    want, _ = jax.jit(lambda v: jm.apply(v, jnp.asarray(x)))(variables)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got, _ = pm.eval()(nchw(x))
        cut, _ = pm(nchw(x), max_stage=5)
    assert [g.shape[2] for g in got] == [33, 33, 16, 16, 8, 8] + [4] * 6 + [2] * 2
    assert len(cut) == 6
    for g, w in zip(got, want, strict=True):
        assert_close(g.numpy(), as_nchw(w))

    jb = jax_mobilenet._SeparableBlock(512)
    init = jax.jit(lambda key: jb.init(key, jnp.zeros((1, 3, 3, 512))))(
        jax.random.PRNGKey(0))
    pb = pt_mobilenet._SeparableBlock(512, 512)
    generator = torch.Generator().manual_seed(5)
    for m in pb.modules():
        if isinstance(m, torch.nn.Conv2d):
            reset_conv(m, generator)
    assert assert_init_follows_jax(pb, init) == 2
    narrow = pt_mobilenet.MobileNet(width_overrides={1: 8})
    assert narrow.stage_channels[1] == 8
    assert narrow.stage1.pointwise_conv.out_channels == 8
    assert narrow.stage2.depthwise_conv.in_channels == 8


@pytest.mark.parametrize('size,levels', [
    # 128 x 96 px: taps 8 x 6 and 4 x 3, then H 3 -> 2 (odd, padded) and
    # W 4 -> 2 (even, padded), then 1 x 1 (not padded)
    ((96, 128), [(6, 8), (3, 4), (2, 2), (1, 1)]),
    # 160 x 64 px: taps 10 x 4 and 5 x 2, then H 2 -> 1 (not padded) while
    # W 5 -> 3 (padded), per axis
    ((64, 160), [(4, 10), (2, 5), (1, 3)]),
])
def test_depthwise_feature_pyramid_matches_jax_at_uneven_sizes(size, levels):
    """The depthwise FPN on MobileNet v1 x0.25 taps (11, 13): laterals,
    the pool and depthwise branches of each extra level with the (0, 1)
    pad decided per axis, the grouped up convs and the lateral adds."""
    kw = dict(out_layers=(11, 13), pyramid_layers=len(levels),
              pyramid_channels=16)
    jm = jax_features.DepthwiseFeaturePyramid(
        base=jax_mobilenet.MobileNet(depth_multiplier=0.25), **kw)
    pm = pt_features.DepthwiseFeaturePyramid(
        pt_mobilenet.MobileNet(depth_multiplier=0.25), **kw)
    rng = np.random.RandomState(2)
    x = rng.randn(1, *size, 3).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), rng=rng)
    want, _ = jax.jit(lambda v: jm.apply(v, jnp.asarray(x)))(variables)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got, last = pm.eval()(nchw(x))
    assert [tuple(g.shape[2:]) for g in got] == levels
    assert last is got[-1] and pm.channels == [16] * len(levels)
    for g, w in zip(got, want, strict=True):
        assert_close(g.numpy(), as_nchw(w))


@pytest.fixture(scope='module')
def gn_config(tmp_path_factory):
    """The flagship's config with ``MBV1_DFPN_MODEL`` and
    ``train.group_norm: True``, as a file."""
    path = tmp_path_factory.mktemp('gn') / 'mbv1_dfpn_gn.py'
    with open(CONFIG) as f:
        path.write_text(f.read() + f'\nmodel = {MBV1_DFPN_MODEL!r}\n'
                        'train = dict(train, group_norm=True)\n')
    return str(path)


@pytest.fixture(scope='module')
def jax_side():
    """The JAX detector under ``MBV1_DFPN_MODEL`` from the port's seeded
    initialization, and JAX's GroupNorm forward of it."""
    variables = to_jax_variables(port_bundle(
        CONFIG, SIZE, seed=5, model=MBV1_DFPN_MODEL).module.state_dict())
    side = JaxSide(CONFIG, SIZE, model=MBV1_DFPN_MODEL, variables=variables)
    return side, jax_norm.group_norm_apply(side.bundle.module,
                                           jax_norm.DEFAULT_GROUPS)


def test_group_norm_serving_forward_matches_jax(jax_side, gn_config):
    """``Predictor`` of a ``train.group_norm`` config: every BatchNorm a
    GroupNorm of 8 groups, the eval forward equal to JAX's
    ``group_norm_apply`` with perturbed parameters, the running statistics
    unused (perturbed too)."""
    side, gn_apply = jax_side
    rng = np.random.RandomState(8)
    variables = perturb(side.variables, rng, score_gain=30.0)
    x = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    want_s, want_l, want_src = side.forward(variables, x, apply_fn=gn_apply)
    pred = Predictor.from_config(gn_config, variables=variables, device='cpu')
    bns = [m for m in pred.model.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 27 + 4 * 3 + 5
    assert {m.group_norm for m in bns} == {8}
    with torch.no_grad():
        got_s, got_l, got_src = pred.model(nchw(x), return_sources=True)
    assert [s.shape[2] for s in got_src] == [18, 9, 5, 3, 2, 1]
    pairs = [(got_s, want_s), (got_l, want_l)] + [
        (g, as_nchw(w)) for g, w in zip(got_src, want_src, strict=True)]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    dets, valid = pred.predict_batch(rng.randint(0, 256, (1, SIZE, SIZE, 3),
                                                 dtype=np.uint8))
    assert dets.shape == (1, 200, 6) and torch.isfinite(dets).all()


def test_group_norm_train_step_matches_jax(jax_side):
    side, gn_apply = jax_side
    images, boxes, mask = batch(SIZE)
    step_j, state_j = side.train_step(apply_fn=gn_apply)
    trainer = Trainer.from_config(
        CONFIG, variables=side.variables, device='cpu',
        overrides=port_overrides(SIZE, fused_bn=False, model=MBV1_DFPN_MODEL,
                                 group_norm=True))
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
                        step_rel=5e-2, ulp_floor=True)
    after = trainer.model.state_dict()
    for k in before:
        if k.endswith(('running_mean', 'running_var')):
            assert torch.equal(after[k], before[k]), k


def test_group_norm_raises_with_fused_bn_and_warns_on_untouched_stats(
        tmp_path, caplog):
    """``fused_bn`` with ``group_norm`` raises, as in the JAX engine; a
    restored checkpoint whose every BN statistic is at 0/1 (a GroupNorm
    run's) warns unless ``group_norm`` is set."""
    with pytest.raises(ValueError, match='group_norm'):
        Trainer.from_config(SMOKE, device='cpu', overrides={
            'train': {'fused_bn': True, 'group_norm': 4}})
    exp = Experiment(SMOKE, phases=('eval',), device='cpu')
    ckpt.save(str(tmp_path), exp.trainer.state, 0)
    with caplog.at_level(logging.WARNING):
        Experiment(SMOKE, phases=('eval',), device='cpu',
                   resume_from=str(tmp_path))
    assert 'train.group_norm' in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        Experiment(SMOKE, phases=('eval',), device='cpu',
                   resume_from=str(tmp_path),
                   overrides={'train': {'group_norm': True}})
    assert 'train.group_norm' not in caplog.text
