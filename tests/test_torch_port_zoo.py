"""Port parity for the model zoo's layers: VGG, ResNet, ResNeXt, SE-ResNet,
the FPN neck, the shared-conv predictor, RetinaNet anchors, the focal loss,
the torchvision weight mappings and the builder's checks; and the geometry
of every shipped config.

The JAX modules (flax, NHWC, on the CPU) and the port's (NCHW) run the same
seeded numpy inputs with the same weights, carried over by
``utils/weights.py::from_jax_variables`` with ``strict=True``.  Geometry
needs no forward: the JAX side is ``jax.eval_shape`` of the detector's
init.  Tolerances: parameter and BN counts, feature-map sizes and anchors
exactly equal (anchors bit for bit); layer probes rtol 1e-5 with atol 1e-5
of the output's scale (atol 2e-5 for the VGG16-BN and ResNet-18 stacks of
13-16 convs, whose outputs reach 10-100); BN running statistics after a
train-mode call rtol 1e-5, atol 1e-6; the focal loss and the multiclass
``MultiboxLoss`` rtol 1e-5 and their gradients rtol 1e-5, atol 1e-7; the
weight import bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import fill_synthetic_state_dict
from _torch_zoo_slice import (MBV1_DFPN_MODEL, as_nchw, assert_close, nchw,
                              random_variables, to_jax_variables)
from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.models import detector as jax_detector
from single_shot_detection_tpu.models import features as jax_features
from single_shot_detection_tpu.models import resnet as jax_resnet
from single_shot_detection_tpu.models import vgg as jax_vgg
from single_shot_detection_tpu.ops import anchors as jax_anchors
from single_shot_detection_tpu.ops import box_coder as jax_box_coder
from single_shot_detection_tpu.ops import losses as jax_losses
from single_shot_detection_tpu.ops import sampling as jax_sampling
from single_shot_detection_tpu.utils import torch_import as jax_torch_import
from single_shot_detection_tpu.utils.config import load_config as jax_load_config
from single_shot_detection_tpu_torch.models import builder as pt_builder
from single_shot_detection_tpu_torch.models import detector as pt_detector
from single_shot_detection_tpu_torch.models import features as pt_features
from single_shot_detection_tpu_torch.models import resnet as pt_resnet
from single_shot_detection_tpu_torch.models import vgg as pt_vgg
from single_shot_detection_tpu_torch.models.layers import BatchNorm
from single_shot_detection_tpu_torch.ops import anchors as pt_anchors
from single_shot_detection_tpu_torch.ops import box_coder as pt_box_coder
from single_shot_detection_tpu_torch.ops import losses as pt_losses
from single_shot_detection_tpu_torch.ops import sampling as pt_sampling
from single_shot_detection_tpu_torch.utils import torch_import
from single_shot_detection_tpu_torch.utils.config import load_config
from single_shot_detection_tpu_torch.utils.weights import from_jax_variables
from _torch_port_fixtures import one_torch_thread  # noqa: F401

# config -> (parameters, train-mode BNs, feature-map sizes, anchors)
ZOO = {
    'samples/ssd_300_vgg16_voc.py': (19703854, 21, [37, 18, 9, 5, 3, 2], 8108),
    'samples/ssd_300_vgg16_coco.py': (None, 21, [37, 18, 9, 5, 3, 2], None),
    'samples/ssd_512_vgg16_voc.py': (20378052, 23, [64, 32, 16, 8, 4, 2, 1],
                                     24564),
    'samples/ssd_512_vgg16_coco.py': (None, 23, [64, 32, 16, 8, 4, 2, 1], None),
    'samples/ssd_vgg16_coco.py': (None, 21, None, None),
    'samples/retina_rn50_500_voc.py': (34608504, 98, [63, 32, 16, 8, 4], 47961),
    'samples/retina_rn50_500_coco.py': (None, 98, [63, 32, 16, 8, 4], 47961),
    'samples/m2det_512_vgg16_voc.py': (52731310, 150, [64, 32, 16, 8, 4, 2],
                                       24528),
    'samples/m2det_512_vgg16_coco.py': (69321910, 150, [64, 32, 16, 8, 4, 2],
                                        24528),
    'samples/ssd_sh2_voc.py': (4209458, 68, [19, 10, 5, 3, 2, 1], 2268),
    'samples/ssd_mb2_coco.py': (15221302, 64, [18, 9, 5, 3, 2, 1], 2006),
    'samples/ssd_mb2_coco_pruning.py': (15221302, 64, [18, 9, 5, 3, 2, 1],
                                        2006),
}


# ---------------------------------------------------------------- geometry

JAX_SHAPES = {}


@pytest.mark.parametrize('config', sorted(ZOO))
def test_zoo_geometry_matches_jax(config):
    """Parameters, train-mode BNs, feature-map sizes and anchors (bit for
    bit) of the port's build against ``jax.eval_shape`` of JAX's."""
    cfg = jax_load_config(config)
    model = dict(cfg.model)
    # ``detector.weight`` (the pruning config's trained checkpoint) is the
    # JAX engine's to read, not its builder's
    args = dict(base=model['base'], anchor_generator=model['anchor_generator'],
                input_size=tuple(cfg.input_size),
                **{k: v for k, v in dict(model['detector']).items()
                   if k != 'weight'})
    jb = jax_builder.build(**args)
    w, h = cfg.input_size
    key = repr(args)  # the pruning config's model is ssd_mb2_coco's: one trace
    if key not in JAX_SHAPES:
        JAX_SHAPES[key] = jax.eval_shape(lambda: jb.module.init_with_output(
            jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)), return_sources=True))
    out, variables = JAX_SHAPES[key]
    jax_params = sum(int(np.prod(x.shape)) for x in
                     jax.tree_util.tree_leaves(variables['params']))
    jax_bns = len(jax.tree_util.tree_leaves(variables['batch_stats'])) // 2
    jax_sizes = [(s.shape[2], s.shape[1]) for s in out[2]]
    jax_anchors_ = jax_anchors.generate_anchors(jb.anchor_generators, (w, h),
                                                jax_sizes)

    with torch.device('meta'):  # shapes alone: no initializer runs
        bundle = pt_builder.from_config(load_config(config))
    params = sum(p.numel() for p in bundle.module.parameters())
    bns = sum(isinstance(m, BatchNorm) for m in bundle.module.modules())
    assert (params, bns) == (jax_params, jax_bns)
    assert bundle.feature_map_sizes == jax_sizes
    np.testing.assert_array_equal(bundle.anchors, jax_anchors_)
    want_params, want_bns, want_sizes, want_anchors = ZOO[config]
    assert bns == want_bns
    if want_params is not None:
        assert params == want_params
    if want_sizes is not None:
        assert [s[0] for s in bundle.feature_map_sizes] == want_sizes
    if want_anchors is not None:
        assert len(bundle.anchors) == want_anchors


# ------------------------------------------------------------------ layers

def test_vgg16_bn_stages_match_jax():
    """44 stages (conv, BN, ReLU, pool each); the configs' taps 32 and 42
    are 37 and 18 px at 300 px (pools floor: 75 -> 37); every stage of a
    64 px forward equal to JAX's."""
    jm = jax_vgg.VGG(config=jax_vgg.VGG_CONFIGS[16], use_bn=True)
    pm = pt_vgg.VGG(pt_vgg.VGG_CONFIGS[16], use_bn=True)
    with torch.device('meta'):
        stages, _ = pt_vgg.VGG(pt_vgg.VGG_CONFIGS[16])(torch.empty(1, 3, 300, 300))
    assert len(stages) == 44 == len(pm.layers)
    assert stages[32].shape[2:] == (37, 37) and stages[42].shape[2:] == (18, 18)
    assert pm.stage_channels[32] == pm.stage_channels[42] == 512
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), rng=rng)
    want, _ = jax.jit(lambda v: jm.apply(v, jnp.asarray(x)))(variables)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got, _ = pm.eval()(nchw(x))
        cut, _ = pm(nchw(x), max_stage=42)
    assert len(got) == len(want) == 44 and len(cut) == 43
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g.numpy(), as_nchw(w), atol=2e-5)


@pytest.mark.parametrize('make_jax,make_pt,sizes', [
    (lambda: jax_resnet.ResNet(**jax_resnet.RESNET_CONFIGS[50]),
     lambda: pt_resnet.ResNet(**pt_resnet.RESNET_CONFIGS[50]),
     [250, 250, 250, 125, 125, 63, 32, 16]),
    (lambda: jax_resnet.SEResNet(layers=(3, 4, 6, 3), groups=32,
                                 width_per_group=4),
     lambda: pt_resnet.SEResNet(layers=(3, 4, 6, 3), groups=32,
                                width_per_group=4), [125, 125, 63, 32, 16]),
])
def test_resnet50_stage_shapes_match_jax(make_jax, make_pt, sizes):
    """ResNet-50's 8 stages and SE-ResNeXt-50's 5 at 500 px (the widths
    the FPN's laterals take), and their parameter counts."""
    (stages, _), variables = jax.eval_shape(lambda: make_jax().init_with_output(
        jax.random.PRNGKey(0), jnp.zeros((1, 500, 500, 3))))
    with torch.device('meta'):
        pm = make_pt()
        got, _ = pm(torch.empty(1, 3, 500, 500))
    assert [tuple(g.shape) for g in got] == [
        (1, s.shape[3], s.shape[1], s.shape[2]) for s in stages]
    assert [g.shape[1] for g in got] == pm.stage_channels
    assert [g.shape[2] for g in got] == sizes
    assert sum(p.numel() for p in pm.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(variables['params']))


@pytest.mark.parametrize('make_jax,make_pt,size,channels,train', [
    # ResNet-18 (BasicBlocks, downsampling shortcuts), all 8 stages
    (lambda: jax_resnet.ResNet(**jax_resnet.RESNET_CONFIGS[18]),
     lambda: pt_resnet.ResNet(**pt_resnet.RESNET_CONFIGS[18]), 40, 3, False),
    # a ResNeXt bottleneck: grouped 3x3 at stride 2 with a projection
    (lambda: jax_resnet.Bottleneck(16, stride=2, downsample=True, groups=4,
                                   base_width=8),
     lambda: pt_resnet.Bottleneck(24, 16, stride=2, downsample=True,
                                  groups=4, base_width=8), 9, 24, False),
    # an SE bottleneck, in train mode (batch statistics)
    (lambda: jax_resnet.SEBottleneck(8, downsample=True, reduction=4),
     lambda: pt_resnet.SEBottleneck(24, 8, downsample=True, reduction=4),
     7, 24, True),
])
def test_resnet_blocks_match_jax(make_jax, make_pt, size, channels, train):
    rng = np.random.RandomState(1)
    x = rng.randn(2, size, size, channels).astype(np.float32)
    jm = make_jax()
    variables = random_variables(jm, jnp.asarray(x), rng=rng)
    if train:
        want, updated = jax.jit(lambda v: jm.apply(
            v, jnp.asarray(x), True, mutable=['batch_stats']))(variables)
    else:
        want = jax.jit(lambda v: jm.apply(v, jnp.asarray(x)))(variables)
    pm = make_pt()
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    pm.train(train)
    with torch.no_grad():
        got = pm(nchw(x))
    if isinstance(got, tuple):  # a backbone: (stages, aux)
        for g, w in zip(got[0], want[0], strict=True):
            assert_close(g.numpy(), as_nchw(w), atol=2e-5)
    else:
        assert_close(got.numpy(), as_nchw(want))
    if train:
        stats = from_jax_variables({'batch_stats': updated['batch_stats']})
        state = pm.state_dict()
        for k, v in stats.items():
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_feature_pyramid_matches_jax_at_uneven_sizes():
    """RetinaNet's FPN (laterals, nearest top-down adds, outputs, P6-P7 at
    stride 2) on a ResNet-18 at 200 px, whose levels are 25, 13, 7, 4, 2:
    not exact halves, where ``jax.image.resize``'s nearest rounds unlike
    torch's ``nearest``."""
    kw = dict(out_layers=(5, 6, 7), pyramid_layers=5, pyramid_channels=16,
              initializer={'name': 'normal_', 'args': {'std': 0.03}})
    jm = jax_features.FeaturePyramid(
        base=jax_resnet.ResNet(**jax_resnet.RESNET_CONFIGS[18]), **kw)
    pm = pt_features.FeaturePyramid(
        pt_resnet.ResNet(**pt_resnet.RESNET_CONFIGS[18]), **kw).eval()
    rng = np.random.RandomState(3)
    x = rng.randn(1, 200, 200, 3).astype(np.float32)
    variables = random_variables(jm, jnp.asarray(x), rng=rng)
    want, _ = jax.jit(lambda v: jm.apply(v, jnp.asarray(x)))(variables)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got, last = pm(nchw(x))
    assert [g.shape[2] for g in got] == [25, 13, 7, 4, 2]
    for g, w in zip(got, want, strict=True):
        assert_close(g.numpy(), as_nchw(w), atol=2e-5)
    assert last is got[-1]
    # the upsample itself, at the sizes where the two nearest rules differ
    for src, dst in ((32, 63), (10, 19), (3, 5)):
        a = rng.randn(1, src, src, 2).astype(np.float32)
        want = jax_features.interpolate(jnp.asarray(a), (dst, dst))
        got = pt_features.interpolate(nchw(a), (dst, dst))
        np.testing.assert_array_equal(got.numpy(), as_nchw(want))


@pytest.mark.parametrize('use_depthwise', [False, True])
def test_shared_conv_predictor_matches_jax(use_depthwise):
    """One conv per (head, layer) on every level, conv -> activation ->
    a BN per level, in train mode: outputs and running statistics."""
    kw = dict(num_layers=2, num_channels=8, kernel_size=3,
              initializer={'name': 'normal_', 'args': {'std': 0.1}})
    jm = jax_detector.SharedConvPredictor(use_depthwise=use_depthwise, **kw)
    pm = pt_detector.SharedConvPredictor(8, 3, use_depthwise=use_depthwise,
                                         activation={'name': 'ReLU'}, **kw)
    rng = np.random.RandomState(4)
    sources = [rng.randn(2, s, s, 8).astype(np.float32) for s in (9, 5, 3)]
    variables = random_variables(jm, sources, rng=rng)
    (want_s, want_l), updated = jax.jit(lambda v: jm.apply(
        v, sources, True, mutable=['batch_stats']))(variables)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    assert ('score_conv1.depthwise_conv.weight' if use_depthwise
            else 'score_conv1.conv.weight') in pm.state_dict()
    assert 'loc_norm1_2.running_var' in pm.state_dict()
    with torch.no_grad():
        got_s, got_l = pm.train()([nchw(s) for s in sources])
    for g, w in zip(got_s + got_l, list(want_s) + list(want_l), strict=True):
        assert_close(g.numpy(), as_nchw(w))
    state = pm.state_dict()
    for k, v in from_jax_variables({'batch_stats': updated['batch_stats']}).items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------------ anchors and losses

def test_retina_anchor_generator_matches_jax():
    kw = dict(aspect_ratios=[1.0, 2.0, 0.5], min_level=3, max_level=7,
              scale=4.0, scales_per_level=3)
    jax_gens = jax_anchors.build_anchor_generators('retina_net', **kw)
    pt_gens = pt_anchors.build_anchor_generators('retina_net', **kw)
    assert [g.num_boxes for g in pt_gens] == [9] * 5
    for size, fms in (((500, 500), [(63, 63), (32, 32), (16, 16), (8, 8), (4, 4)]),
                      ((200, 160), [(25, 20), (13, 10), (7, 5), (4, 3), (2, 2)])):
        np.testing.assert_array_equal(
            pt_anchors.generate_anchors(pt_gens, size, fms),
            jax_anchors.generate_anchors(jax_gens, size, fms))


def test_sigmoid_focal_loss_and_multiclass_multibox_loss_match_jax():
    """Seeded logits and targets with classes 0 (background) and -1
    (ignored) among the positives: the focal loss alone, then
    ``MultiboxLoss`` with the naive sampler (its one-hot at ``class - 1``
    gives zero rows below 1), losses and gradients."""
    rng = np.random.RandomState(5)
    b, a, c = 3, 40, 6
    logits = (rng.randn(b, a, c) * 3).astype(np.float32)
    plane = (rng.rand(b, a, c) < 0.2) * rng.rand(b, a, c).astype(np.float32)
    mask = rng.rand(b, a) < 0.7
    want = jax_losses.SigmoidFocalLoss(gamma=2.0, alpha=0.25, reduction='sum')(
        jnp.asarray(logits), jnp.asarray(plane), jnp.asarray(mask))
    got = pt_losses.build_loss('SigmoidFocalLoss', gamma=2.0, alpha=0.25,
                               reduction='sum', ignore_index=-1)(
        torch.from_numpy(logits), torch.from_numpy(plane), torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)

    anchors = np.concatenate([rng.rand(a, 2) * 100, rng.rand(a, 2) * 40 + 5],
                             1).astype(np.float32)
    xy = rng.rand(b, a, 2) * 80
    target = np.concatenate([xy, xy + rng.rand(b, a, 2) * 30 + 2,
                             rng.randint(-1, c + 1, (b, a, 1)),
                             rng.rand(b, a, 1)], -1).astype(np.float32)
    assert {-1, 0, 1, c}.issubset(set(target[..., 4].ravel().astype(int)))
    locs = rng.randn(b, a, 4).astype(np.float32)
    cfg = dict(classification_loss={'name': 'SigmoidFocalLoss', 'gamma': 2.0,
                                    'alpha': 0.25},
               localization_loss={'name': 'SmoothL1Loss'})
    jax_loss = jax_losses.MultiboxLoss(
        sampler=jax_sampling.build_sampler('naive_sampler'),
        box_coder=jax_box_coder.BoxCoder(xy_scale=10.0, wh_scale=5.0), **cfg)
    pt_loss = pt_losses.MultiboxLoss(
        sampler=pt_sampling.build_sampler('naive_sampler'),
        box_coder=pt_box_coder.BoxCoder(xy_scale=10.0, wh_scale=5.0), **cfg)
    assert pt_loss.multiclass
    want, grads = jax.jit(jax.value_and_grad(
        lambda s, l: jax_loss(s, l, jnp.asarray(anchors), jnp.asarray(target))[0],
        argnums=(0, 1)))(jnp.asarray(logits), jnp.asarray(locs))
    s = torch.from_numpy(logits).requires_grad_()
    l = torch.from_numpy(locs).requires_grad_()
    got = pt_loss(s, l, torch.from_numpy(anchors), torch.from_numpy(target))[0]
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for g, w in ((s.grad, grads[0]), (l.grad, grads[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------- weights, builder

@pytest.mark.parametrize('config,model,backbone,n_convs,n_bns', [
    pytest.param(config, model, backbone, n, n, id=f'{config}-{backbone}-{n}-{n}')
    for config, model, backbone, n in [
        ('samples/ssd_300_vgg16_voc.py', None, 'torchvision_vgg16_bn', 13),
        ('samples/retina_rn50_500_voc.py', None, 'torchvision_resnet50', 53),
        ('samples/ssd_sh2_voc.py', None, 'torchvision_shufflenet_v2_x1_0', 56),
        ('samples/ssd_mb2_voc.py', MBV1_DFPN_MODEL, 'mobilenet_v1', 27)]])
def test_base_weight_import_matches_jax(config, model, backbone, n_convs,
                                        n_bns):
    """A seeded torchvision-layout ``state_dict`` (names and shapes from the
    JAX mapping) into the port's backbone equals JAX ``import_backbone``
    then ``from_jax_variables`` (MobileNet v1: the reference's own layout,
    under ``MBV1_DFPN_MODEL``)."""
    cfg = load_config(config)
    if model is not None:
        cfg.override({'model': model})
    model_state = pt_builder.from_config(cfg).module.state_dict()
    variables = to_jax_variables(model_state)
    mapping = jax_torch_import.resolve_mapping(backbone)
    assert torch_import.resolve_mapping(backbone) == mapping
    sd = fill_synthetic_state_dict(variables['params']['features']['base'],
                                   mapping, np.random.RandomState(6))
    want = from_jax_variables(jax_torch_import.import_backbone(
        sd, variables, backbone))
    got = torch_import.import_backbone(sd, model_state, backbone)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    changed = {k.rsplit('.', 1)[0] for k in got
               if not torch.equal(got[k], model_state[k])}
    assert all(k.startswith('features.base.') for k in changed)
    assert len(changed) == n_convs + n_bns


def test_every_jax_backbone_name_of_the_slice_is_registered():
    """Every backbone of the JAX registry (MobileNetV2 7, MobileNet v1 6,
    VGG 8, ResNet 5, ResNeXt 2, SE-ResNet(Xt) 5, ShuffleNetV2 4) is the
    port's, with JAX's weight mapping."""
    from single_shot_detection_tpu.models import backbones as jax_backbones
    from single_shot_detection_tpu_torch.models import backbones as pt_backbones
    names = jax_backbones.available()
    assert len(names) == 7 + 6 + 8 + 5 + 2 + 5 + 4
    for name in names:
        pt_backbones.get(name)  # a KeyError if it is not registered
        assert (torch_import.resolve_mapping(name)
                == jax_torch_import.resolve_mapping(name)), name


def test_builder_raises_on_what_it_does_not_read():
    """A MobileNetV2 config with an unknown ``model.detector`` key, VGG's
    ``packed_stem`` or an MLFPN with an interpolation mode JAX does not
    have raises rather than building another model (``heads.dtype`` is
    read: ``test_torch_port_bf16.py``); the FPN's ``width_overrides``
    (pruning's narrow widths) and a bilinear neck are read, as the JAX
    builder passes them to the neck.  The models are built on the meta
    device: what is read is structure, not values."""
    with torch.device('meta'):
        cfg = load_config('samples/synthetic_smoke.py')
        cfg.config.model['detector']['frobnicate'] = 3
        with pytest.raises(NotImplementedError, match='frobnicate'):
            pt_builder.from_config(cfg)
        cfg = load_config('samples/ssd_300_vgg16_voc.py')
        cfg.config.model['base']['packed_stem'] = True
        with pytest.raises(NotImplementedError, match='packed_stem'):
            pt_builder.from_config(cfg)
        cfg = load_config('samples/retina_rn50_500_voc.py')
        cfg.config.model['detector']['features']['width_overrides'] = {'lateral': 8}
        cfg.config.model['detector']['features']['interpolation_mode'] = 'bilinear'
        cfg.config.input_size = (64, 64)
        narrow = pt_builder.from_config(cfg).module.features
        assert [narrow.get_submodule(f'lateral{i}').out_channels
                for i in range(3)] == [8] * 3
        assert narrow.output0.conv.in_channels == 8
        assert narrow.interpolation_mode == 'bilinear'
        cfg = load_config('samples/m2det_512_vgg16_voc.py')
        cfg.config.model['detector']['features']['interpolation_mode'] = 'bicubic'
        with pytest.raises(ValueError, match='bicubic'):
            pt_builder.from_config(cfg)
        cfg = load_config('samples/synthetic_smoke.py')
        cfg.config.model['detector']['heads'] = {'dtype': 'float32'}
        cfg.config.model['detector']['torch_weight'] = None
        pt_builder.from_config(cfg)  # float32 heads and an unset key build
