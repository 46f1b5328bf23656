"""Port parity for int8 serving (``export/quantize.py``): the serving gate,
calibration, the s8 x s8 -> s32 convs, the int8 detector, the engine's
``int8`` evaluation and ``--int8`` in the CLI, against the JAX package's
``export/quantize.py``.

Tolerances:
- the gate's decisions equal JAX's;
- calibration keys equal, amax values within 1e-5 relative (the float
  forwards of the two packages differ in rounding);
- one conv, given the same input and amax: the int8 input, the int8 weight
  and the s32 accumulator equal JAX's, and the dequantized output equals
  JAX's eager ``quantized_apply`` bit for bit (JAX under ``jit`` lands up
  to a few f32 steps off its own eager result: XLA fuses the epilogue and
  rewrites the division by the activation scale);
- the int8 detector against JAX's ``quantized_apply`` with JAX's amax: each
  output within 1 % of JAX's own int8-to-f32 distance (a rounding flip of
  one activation, from the float forwards' rounding, moves the output by
  one quantization step of one conv, far below the whole model's int8
  noise; measured 5e-6 of it);
- the committed checkpoint's int8 mAP above 0.55, the JAX test's bar.
"""

import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from _torch_zoo_slice import random_variables
from single_shot_detection_tpu.export import quantize as jq
from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.utils.config import load_config as jax_load_config
from single_shot_detection_tpu_torch import cli
from single_shot_detection_tpu_torch.export import quantize as pq
from single_shot_detection_tpu_torch.models import builder as pt_builder
from single_shot_detection_tpu_torch.models.layers import conv2d
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.utils.config import load_config
from single_shot_detection_tpu_torch.utils.weights import (from_jax_variables,
                                                           to_jax_variables)

SMOKE = 'samples/synthetic_smoke.py'
CKPT_DIR = 'experiments/2026-08-16-225820'   # SMOKE's model, trained
# the JAX package's int8 detector test (tests/test_quantize.py)
MB2 = dict(base={'name': 'mobilenet_v2', 'depth_multiplier': 0.35},
           anchor_generator={'type': 'ssd', 'num_scales': 2, 'min_scale': 0.2,
                             'max_scale': 0.9,
                             'aspect_ratios': [[1.0, 2.0]] * 2},
           num_classes=4, features={'name': 'Features', 'out_layers': (13, 18)},
           input_size=(96, 96))


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    processes, and torch's default of one thread per core makes them
    contend for the CPU, tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


# ------------------------------------------------------------------ the gate

def _configs(path, explicit, qat):
    cfgs = []
    for load in (jax_load_config, load_config):
        cfg = load(path)
        if explicit:
            cfg.config.int8 = {}
        if qat:
            cfg.config.train = {**dict(cfg.config.train or {}), 'qat': True}
        cfgs.append(cfg)
    return cfgs


@pytest.mark.parametrize('path', sorted(glob.glob('samples/*.py')),
                         ids=os.path.basename)
def test_gate_matches_jax(path):
    """``resolve_int8_opts`` and ``preset_int8`` decide as JAX's at b32 and
    b128 (and the config's own batch), with and without an explicit
    ``int8`` block and ``train.qat``."""
    for explicit in (False, True):
        for qat in (False, True):
            cfg_j, cfg_p = _configs(path, explicit, qat)
            for batch in (None, 32, 128):
                assert (pq.resolve_int8_opts(cfg_p, batch_size=batch)
                        == jq.resolve_int8_opts(cfg_j, batch_size=batch)), (
                    explicit, qat, batch)
                assert (pq.preset_int8(cfg_p, batch_size=batch)
                        == jq.preset_int8(cfg_j, batch_size=batch)), (
                    explicit, qat, batch)
    # a pinned spatial_limit wins over the preset's, as in JAX
    cfg_j, cfg_p = _configs(path, True, False)
    cfg_j.config.int8 = cfg_p.config.int8 = {'spatial_limit': 128}
    assert pq.resolve_int8_opts(cfg_p) == jq.resolve_int8_opts(cfg_j)


def test_gate_constants_are_jax_s():
    for name in ('QMAX', 'QAT_DECAY', 'DEPTHWISE_BACKBONE_PREFIXES',
                 'DEPTHWISE_MIN_BATCH', 'SPATIAL_LIMIT_INPUT',
                 'SPATIAL_LIMIT_DEFAULT', 'INT8_WIN_BACKBONES'):
        assert getattr(pq, name) == getattr(jq, name), name


# ------------------------------------------------------------ one int8 conv

# (cin, cout, kernel, stride, flax padding, bias, input extent, batch)
CONV_CASES = {
    '1x1': (16, 8, 1, 1, ((0, 0), (0, 0)), False, 8, 2),
    '3x3': (32, 64, 3, 1, ((1, 1), (1, 1)), False, 10, 4),
    'stride 2': (8, 24, 3, 2, ((1, 1), (1, 1)), False, 9, 2),
    'asymmetric pad': (3, 16, 3, 2, ((0, 1), (0, 1)), False, 8, 2),
    'biased': (24, 40, 3, 1, ((1, 1), (1, 1)), True, 7, 2),
    'K 27 N 126': (3, 126, 3, 1, ((1, 1), (1, 1)), True, 6, 2),
    'M <= 16': (8, 84, 3, 1, ((0, 0), (0, 0)), True, 3, 1),
    '1x1 stride 2': (16, 32, 1, 2, ((0, 0), (0, 0)), False, 8, 2),
}


class OneConv(nn.Module):
    features: int
    kernel: int
    stride: int
    padding: tuple
    bias: bool

    @nn.compact
    def __call__(self, x, train=False):
        return nn.Conv(self.features, (self.kernel, self.kernel),
                       strides=(self.stride, self.stride),
                       padding=self.padding, use_bias=self.bias, name='c')(x)


def one_conv(case, seed=0):
    """The case's flax module, variables and NHWC input, and the port's
    conv with the same weights."""
    cin, cout, k, stride, padding, bias, hw, b = CONV_CASES[case]
    rng = np.random.RandomState(seed)
    x = rng.randn(b, hw, hw, cin).astype(np.float32)
    w = (rng.randn(cout, cin, k, k) * 0.3).astype(np.float32)
    params = {'kernel': w.transpose(2, 3, 1, 0)}
    (top, bottom), (left, right) = padding
    symmetric = top == bottom == left == right
    conv = conv2d(cin, cout, k, stride=stride, padding=top if symmetric else 0,
                  bias=bias, pad=None if symmetric else (left, right, top, bottom))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        if bias:
            params['bias'] = rng.randn(cout).astype(np.float32)
            conv.bias.copy_(torch.from_numpy(params['bias']))
    module = OneConv(cout, k, stride, padding, bias)
    return module, {'params': {'c': params}}, x, conv


def jax_accumulator(variables, x, amax, case):
    """``_quantized_conv``'s int8 operands and s32 accumulator, its own
    expressions (the JAX function does not return them)."""
    _, _, k, stride, padding, _, _, _ = CONV_CASES[case]
    kernel = jnp.asarray(variables['params']['c']['kernel'])
    w_scale = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)), 1e-12) / jq.QMAX
    w_q = jnp.clip(jnp.round(kernel / w_scale), -jq.QMAX, jq.QMAX).astype(jnp.int8)
    x_scale = max(amax, 1e-12) / jq.QMAX
    x_q = jnp.clip(jnp.round(jnp.asarray(x) / x_scale), -jq.QMAX,
                   jq.QMAX).astype(jnp.int8)
    y = jax.lax.conv_general_dilated(
        x_q, w_q, (stride, stride), padding,
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=jnp.int32)
    return np.asarray(x_q), np.asarray(w_q), np.asarray(y)


@pytest.mark.parametrize('case', list(CONV_CASES))
def test_quantized_conv_matches_jax_bit_for_bit(case):
    module, variables, x, conv = one_conv(case)
    amax = jq.calibrate(module, variables, [jnp.asarray(x)])
    assert pq.calibrate(conv, [nchw(x)]) == {'': amax['c']}
    x_q, w_q, acc = jax_accumulator(variables, x, amax['c'], case)

    q = pq.QuantizedConv(conv, amax['c'])
    got_x = pq.quantize_input(nchw(x), q.x_scale)
    np.testing.assert_array_equal(got_x.permute(0, 2, 3, 1).numpy(), x_q)
    got_w, _ = pq.quantize_weight(conv.weight)
    np.testing.assert_array_equal(got_w.permute(1, 2, 3, 0).numpy(), w_q)
    got_acc = q.accumulator(got_x)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), acc)

    want = np.asarray(jq.quantized_apply(module, amax)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = q(conv, nchw(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_padded_product_equals_int32_matmul():
    """K = 27 and N = 126 are padded to multiples of 8 and M = 5 to 17 rows
    (cuBLASLt's int8 limits, on the CPU as on the card), and the padding
    leaves the product exact."""
    _, _, x, conv = one_conv('K 27 N 126')
    q = pq.QuantizedConv(conv, 3.0)
    assert (q.k, q.k_pad, q.n, tuple(q.w_t.shape)) == (27, 32, 126, (32, 128))
    x_q = pq.quantize_input(nchw(x[:1, :1, :5]), q.x_scale)  # M = 5 rows
    a, (b, ho, wo) = pq.im2col(x_q, q.kernel_size, q.stride, q.padding, q.k_pad)
    assert tuple(a.shape) == (17, 32) and b * ho * wo == 5
    assert not a[5:].any() and not a[:, 27:].any()
    w = pq.quantize_weight(conv.weight)[0].reshape(126, 27)
    want = a[:5, :27].to(torch.int32) @ w.to(torch.int32).t()
    np.testing.assert_array_equal(q.accumulator(x_q).reshape(5, 126).numpy(),
                                  want.numpy())


def test_depthwise_and_uncalibrated_convs_stay_float():
    bundle = pt_builder.build(**MB2)
    bundle.module.reset_parameters(torch.Generator().manual_seed(0))
    model = bundle.module.eval()
    keys = {k for k, _ in pq.supported_convs(model)}
    depthwise = [name for name, m in model.named_modules()
                 if isinstance(m, torch.nn.Conv2d) and m.groups > 1]
    assert depthwise and not keys & {pq.conv_key(n) for n in depthwise}
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 3, 96, 96).astype(np.float32))
    with torch.no_grad():
        float_out = model(x)
        # nothing calibrated: the float model exactly
        for got, want in zip(pq.quantized_apply(model, {})(x), float_out):
            assert torch.equal(got, want)
        amax = pq.calibrate(model, [x])
        assert set(amax) == keys
        # one conv left uncalibrated stays float; the rest run int8
        stem = 'features/base/stage0/conv'
        modes = pq.make_interceptor(model, {k: v for k, v in amax.items()
                                            if k != stem})
        assert stem not in modes and len(modes) == len(keys) - 1
    assert all(m.quant is None for m in model.modules() if hasattr(m, 'quant'))


def test_spatial_limit_is_judged_on_the_unpadded_extent():
    """JAX looks at the conv's unpadded input; the port's MobileNet convs
    pad inside the conv (``Conv2d.pad``), so an input exactly at the limit
    is quantized and one pixel more stays float, in both packages."""
    module, variables, x, conv = one_conv('asymmetric pad')  # 8 px, pad to 9
    amax = jq.calibrate(module, variables, [jnp.asarray(x)])
    with torch.no_grad():
        for limit in (8, 7):
            want = np.asarray(jq.quantized_apply(module, amax, spatial_limit=limit)(
                variables, jnp.asarray(x)))
            got = pq.QuantizedConv(conv, amax['c'], limit)(conv, nchw(x))
            np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
        assert not torch.equal(pq.QuantizedConv(conv, amax['c'], 8)(conv, nchw(x)),
                               conv.float_forward(nchw(x)))

        # the MobileNetV2 stem at 256 px under the preset's limit of 256
        stem = pt_builder.create_base('mobilenet_v2', depth_multiplier=0.35).stage0.conv
        assert stem.pad == (0, 1, 0, 1)
        x256 = torch.randn(1, 3, 256, 256, generator=torch.Generator().manual_seed(0))
        at_limit = pq.QuantizedConv(stem, 2.5, pq.SPATIAL_LIMIT_DEFAULT)
        assert torch.equal(at_limit(stem, x256),
                           pq.QuantizedConv(stem, 2.5)(stem, x256))
        assert not torch.equal(at_limit(stem, x256), stem.float_forward(x256))
        x257 = torch.randn(1, 3, 257, 257, generator=torch.Generator().manual_seed(0))
        assert torch.equal(at_limit(stem, x257), stem.float_forward(x257))


# --------------------------------------------------------------- detectors

@pytest.fixture(scope='module')
def mb2():
    """The JAX test's MobileNetV2-0.35 SSD at 96 px: the port's seeded
    weights with perturbed BN statistics, in both packages."""
    bundle = pt_builder.build(**MB2)
    bundle.module.reset_parameters(torch.Generator().manual_seed(0))
    variables = to_jax_variables(bundle.module.state_dict())
    rng = np.random.RandomState(1)
    variables['batch_stats'] = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.randn(*v.shape) * 0.1 if path[-1].key == 'mean'
                         else rng.rand(*v.shape) + 0.5).astype(np.float32),
        variables['batch_stats'])
    bundle.module.load_state_dict(from_jax_variables(variables))
    images = np.random.RandomState(23).rand(2, 96, 96, 3).astype(np.float32)
    return bundle.module.eval(), jax_builder.build(**MB2).module, variables, images


def test_calibrate_matches_jax(mb2):
    model, module, variables, images = mb2
    want = jq.calibrate(module, variables, [jnp.asarray(images)])
    got = pq.calibrate(model, [nchw(images[:1]), nchw(images[1:])])
    assert set(got) == set(want) and len(got) >= 10
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-5), key
    assert model.training is False


def test_int8_detector_matches_jax_quantized_apply(mb2):
    model, module, variables, images = mb2
    amax = jq.calibrate(module, variables, [jnp.asarray(images)])
    x = jnp.asarray(images)
    ref = jax.jit(lambda v: module.apply(v, x, train=False))(variables)
    want = jax.jit(lambda v: jq.quantized_apply(module, amax)(
        v, x, train=False))(variables)
    with torch.no_grad():
        got = pq.quantized_apply(model, amax)(nchw(images))
    for name, g, w, r in zip(('scores', 'locs'), got, want, ref):
        jax_int8_noise = np.abs(np.asarray(w) - np.asarray(r)).max()
        assert jax_int8_noise > 0
        err = np.abs(g.numpy() - np.asarray(w)).max()
        assert err <= 0.01 * jax_int8_noise, (name, err, jax_int8_noise)


def test_vgg_backbone_int8_matches_jax():
    """SSD300-VGG16's backbone (3x3 convs, K up to 4608) at 64 px."""
    base_j = jax_builder.create_base('torchvision_vgg16_bn')
    x = np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32)
    variables = random_variables(base_j, jnp.zeros((1, 64, 64, 3)),
                                 rng=np.random.RandomState(6))
    base_p = pt_builder.create_base('torchvision_vgg16_bn').eval()
    base_p.load_state_dict(from_jax_variables(variables))
    amax = jq.calibrate(base_j, variables, [jnp.asarray(x)])
    got_amax = pq.calibrate(base_p, [nchw(x)])
    assert set(got_amax) == set(amax) and len(amax) == 13
    for key, value in amax.items():
        assert got_amax[key] == pytest.approx(value, rel=1e-5), key
    ref, _ = jax.jit(lambda v: base_j.apply(v, jnp.asarray(x), train=False))(variables)
    want, _ = jax.jit(lambda v: jq.quantized_apply(base_j, amax)(
        v, jnp.asarray(x), train=False))(variables)
    with torch.no_grad():
        got, _ = pq.quantized_apply(base_p, amax)(nchw(x))
    assert len(got) == len(want)
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        noise = np.abs(w - np.asarray(r).transpose(0, 3, 1, 2)).max()
        err = np.abs(g.numpy() - w).max()
        assert err <= 0.01 * noise, (i, err, noise)


# ----------------------------------------------------------- the engine

def test_experiment_int8_recalibrates_when_training_advances():
    exp = Experiment(SMOKE, device='cpu', int8=True,
                     overrides={'int8': {}, 'train': {'epochs': 1}})
    exp._ensure_int8()
    amax0, step0, modes0 = dict(exp._int8_amax), exp._int8_calib_step, exp._int8_modes
    assert amax0 and step0 == 0
    exp._ensure_int8()  # same step: cached
    assert exp._int8_modes is modes0
    exp.train()
    step = exp.trainer.state.step
    assert step > step0
    exp._ensure_int8()
    assert exp._int8_calib_step == step and exp._int8_modes is not modes0
    assert set(exp._int8_amax) == set(amax0) and exp._int8_amax != amax0
    result = exp.evaluate()
    assert result['int8'] == 1.0 and np.isfinite(result['loss'])


def test_experiment_int8_gate_and_errors():
    """The gate refuses the smoke model (MobileNetV2 at eval batch 16) and
    the evaluation runs float; calibration without a dataset raises;
    ``train.group_norm`` with int8 raises."""
    exp = Experiment(SMOKE, phases=('eval',), device='cpu', int8=True)
    result = exp.evaluate()
    assert exp.int8 is False and exp._int8_amax is None and result['int8'] == 0.0
    assert 'int8' not in Experiment(SMOKE, phases=('eval',),
                                    device='cpu').evaluate()
    with pytest.raises(ValueError, match='int8 calibration'):
        Experiment._calibration_images(types.SimpleNamespace(loaders={}))
    with pytest.raises(ValueError, match='group_norm'):
        Experiment(SMOKE, phases=('eval',), device='cpu', int8=True,
                   overrides={'train': {'group_norm': True}})


def test_cli_int8_eval_of_the_committed_checkpoint(tmp_path):
    """``--int8 --phases eval --cpu`` on the committed JAX run, with an
    explicit ``int8`` block past the gate: its int8 mAP stays above the
    JAX test's 0.55 (float: 0.66936)."""
    config = tmp_path / 'config.py'
    with open(f'{CKPT_DIR}/config.py') as f:
        config.write_text(f.read() + '\nint8 = {}\n')
    exp, result = cli.main(['--cpu', '--int8', '--config', str(config),
                            '--checkpoint', CKPT_DIR, '--phases', 'eval'])
    assert exp.trainer.state.step == 1800
    assert result['int8'] == 1.0 and len(exp._int8_amax) >= 30
    assert result['mAP'] > 0.55, result
