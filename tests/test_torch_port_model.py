"""Port parity: layers, MobileNetV2, Detector, builder and weight import.

The JAX model (flax, NHWC, on the CPU) and the port (NCHW) run the same
numpy inputs with the same weights, carried over by
``utils/weights.py::from_jax_variables``.  Tolerances: head outputs of the
committed checkpoint atol 2e-4, rtol 1e-4; a full-width ``ssd_mb2_voc``
forward atol 1e-3; the layer probes atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from single_shot_detection_tpu.data.datasets import Synthetic
from single_shot_detection_tpu.data.transforms import Pipeline
from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.models import detector as jax_detector
from single_shot_detection_tpu.models import layers as jax_layers
from single_shot_detection_tpu.models import mobilenet_v2 as jax_mbv2
from single_shot_detection_tpu.utils.config import load_config as jax_load_config
from single_shot_detection_tpu_torch.models import builder as pt_builder
from single_shot_detection_tpu_torch.models import detector as pt_detector
from single_shot_detection_tpu_torch.models import layers as pt_layers
from single_shot_detection_tpu_torch.models import mobilenet_v2 as pt_mbv2
from single_shot_detection_tpu_torch.utils.config import load_config
from single_shot_detection_tpu_torch.utils.weights import from_jax_variables

CKPT_DIR = 'experiments/2026-08-16-225820'
FLAGSHIP = 'samples/ssd_mb2_voc.py'


def build_both(config_path):
    """(JAX bundle, port bundle) for one config."""
    cfg = load_config(config_path)
    model = dict(cfg.model)
    det = {k: v for k, v in model['detector'].items()
           if k in ('num_classes', 'use_depthwise', 'features', 'extras')}
    kw = dict(base=model['base'], anchor_generator=model['anchor_generator'],
              input_size=tuple(cfg.input_size), **det)
    return jax_builder.build(**kw), pt_builder.build(**kw)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def perturb_batch_stats(variables, rng):
    """Non-trivial running statistics in a JAX variable tree."""
    stats = jax.tree_util.tree_map(
        lambda v: (rng.rand(*v.shape).astype(np.float32) + 0.5
                   if v.ndim == 1 else v), variables.get('batch_stats', {}))
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.randn(*v.shape).astype(np.float32) * 0.1
                         if path[-1].key == 'mean' else v), stats)
    return {'params': variables.get('params', {}), 'batch_stats': stats}


# ------------------------------------------------------------------ probes

@pytest.mark.parametrize('make_jax,make_pt,size', [
    # backbone stride-2 conv: TF-asymmetric (0, 1, 0, 1) padding
    (lambda: jax_mbv2._ConvBn(8, 3, stride=2),
     lambda: pt_mbv2._ConvBn(3, 8, 3, stride=2), 9),
    (lambda: jax_mbv2.InvertedResidual(6, 2, 6),
     lambda: pt_mbv2.InvertedResidual(3, 6, 2, 6), 8),
    # extras' stride-2 depthwise conv: symmetric padding 1
    (lambda: jax_layers.DepthwiseConvBn(6, kernel_size=3, stride=2, padding=1),
     lambda: pt_layers.DepthwiseConvBn(3, 6, kernel_size=3, stride=2,
                                       padding=1), 9),
    # every extras block type
    (lambda: jax_detector.ExtraLayer('s', 8, use_depthwise=True),
     lambda: pt_detector.ExtraLayer('s', 3, 8, use_depthwise=True), 9),
    (lambda: jax_detector.ExtraLayer('s', 8),
     lambda: pt_detector.ExtraLayer('s', 3, 8), 9),
    (lambda: jax_detector.ExtraLayer('', 8),
     lambda: pt_detector.ExtraLayer('', 3, 8), 7),
    (lambda: jax_detector.ExtraLayer('m', 8),
     lambda: pt_detector.ExtraLayer('m', 3, 8), 7),
])
def test_padding_and_layout_probes(make_jax, make_pt, size):
    rng = np.random.RandomState(0)
    x = rng.randn(2, size, size, 3).astype(np.float32)
    jm = make_jax()
    variables = perturb_batch_stats(
        jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    want = jm.apply(variables, jnp.asarray(x))
    want = want[0] if isinstance(want, tuple) else want
    pm = make_pt().eval()
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = pm(nchw(x))
    got = got[0] if isinstance(got, tuple) else got
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)


def test_weight_layout_depthwise_and_conv():
    rng = np.random.RandomState(1)
    dw = rng.randn(3, 3, 1, 5).astype(np.float32)
    conv = rng.randn(1, 3, 4, 7).astype(np.float32)
    sd = from_jax_variables({'params': {'a': {'kernel': dw},
                                        'b': {'kernel': conv}}})
    assert tuple(sd['a.weight'].shape) == (5, 1, 3, 3)
    assert tuple(sd['b.weight'].shape) == (7, 4, 1, 3)
    np.testing.assert_array_equal(sd['a.weight'][2, 0, 1, 0].item(), dw[1, 0, 0, 2])
    np.testing.assert_array_equal(sd['b.weight'][6, 3, 0, 2].item(), conv[0, 2, 3, 6])
    with pytest.raises(ValueError):  # no dense layers in the ported models
        from_jax_variables({'params': {'d': {'kernel': conv[0, 0]}}})


def test_head_flattening_follows_anchor_order():
    """Scale-major, then (H, W, box): NCHW heads are permuted to NHWC
    before the reshape."""
    _, bundle = build_both(f'{CKPT_DIR}/config.py')
    model = bundle.module.eval()
    nb = bundle.anchor_generators[0].num_boxes
    c = bundle.num_classes
    head = model.score_head0
    with torch.no_grad():
        head.weight.zero_()
        head.bias.copy_(torch.arange(nb * c, dtype=torch.float32))
        scores, _ = model(torch.zeros(1, 3, 128, 128))
    w, h = bundle.feature_map_sizes[0]
    want = np.tile(np.arange(nb * c).reshape(nb, c), (h * w, 1))
    np.testing.assert_array_equal(scores[0, :h * w * nb].numpy(), want)


@pytest.mark.parametrize('config', [FLAGSHIP, f'{CKPT_DIR}/config.py'])
def test_feature_map_sizes_and_anchors_match_jax(config):
    jb, pb = build_both(config)
    assert pb.feature_map_sizes == [tuple(s) for s in jb.feature_map_sizes()]
    np.testing.assert_array_equal(pb.anchors, jb.anchors())
    if config == FLAGSHIP:
        assert pb.feature_map_sizes == [(18, 18), (9, 9), (5, 5), (3, 3),
                                        (2, 2), (1, 1)]
        assert pb.anchors.shape == (2006, 4)


# -------------------------------------------------------------- full model

def test_committed_checkpoint_forward_matches_jax():
    jb, pb = build_both(f'{CKPT_DIR}/config.py')
    with open(f'{CKPT_DIR}/ckpt-1800.msgpack', 'rb') as f:
        ckpt = serialization.msgpack_restore(f.read())
    variables = {'params': ckpt['params'], 'batch_stats': ckpt['batch_stats']}
    cfg = jax_load_config(f'{CKPT_DIR}/config.py')
    data = Synthetic(num_images=4, image_size=128, num_classes=5, max_boxes=3,
                     seed=2)
    staged = np.stack([a['image'] for a in data.annotations])
    pipe = Pipeline((), cfg.preprocessing, tuple(cfg.input_size), train=False)
    x, _, _ = pipe(jax.random.PRNGKey(0), staged,
                   np.zeros((4, 1, 7), np.float32), np.zeros((4, 1), bool))
    want_s, want_l = jb.module.apply(variables, x, train=False)

    model = pb.module.eval()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got_s, got_l = model(nchw(x))
    for got, want in ((got_s, want_s), (got_l, want_l)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        print(f'checkpoint head max abs err {err:.3g}')
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-4)


def test_full_width_flagship_forward_matches_jax():
    jb, pb = build_both(FLAGSHIP)
    rng = np.random.RandomState(2)
    x = rng.randn(1, 300, 300, 3).astype(np.float32)
    # jitted: flax's eager init and apply of the full model take far longer
    init = jax.jit(lambda key: jb.module.init(key, jnp.zeros((1, 300, 300, 3)),
                                              train=False))
    variables = perturb_batch_stats(init(jax.random.PRNGKey(3)), rng)
    want_s, want_l = jax.jit(lambda v, x: jb.module.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    assert want_s.shape == (1, 2006, 21) and want_l.shape == (1, 2006, 4)

    model = pb.module.eval()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got_s, got_l = model(nchw(x))
    for got, want in ((got_s, want_s), (got_l, want_l)):
        want = np.asarray(want)
        print(f'full-width head max abs err {np.abs(got.numpy() - want).max():.3g}')
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_random_init_is_seeded_and_follows_jax_initializers():
    a, b = build_both(FLAGSHIP)[1].module, build_both(FLAGSHIP)[1].module
    a.reset_parameters(torch.Generator().manual_seed(7))
    b.reset_parameters(torch.Generator().manual_seed(7))
    for (name, pa), pb_ in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb_), name
    head = a.score_head0.weight
    assert abs(head.std().item() - 0.01) < 1e-3          # normal(0.01) heads
    assert torch.equal(a.score_head0.bias, torch.zeros_like(a.score_head0.bias))
    stem = a.features.base.stage0.conv.weight            # xavier-uniform
    bound = (6.0 / (3 * 9 + 32 * 9)) ** 0.5
    assert stem.abs().max().item() <= bound
