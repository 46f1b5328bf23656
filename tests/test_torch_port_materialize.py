"""Port parity for the physical rebuild of a pruned model
(``train/materialize.py``) and its export.

Each model is pruned by the port from seeded weights, with the spaces of
each package's own analyzer (which must agree), and rebuilt narrow by both
packages from the same masked weights (``to_jax_variables``).  The JAX side
runs ``make_jaxpr`` and one jitted forward per model (its narrow model).
Held: the sliced tensors equal JAX's bit for bit after the layout change;
the port's narrow model equals its masked model at every backbone stage
output (on the kept channels; the pruned ones of the masked output are
exactly 0) and at the heads, atol 1e-5 of each output's scale; and equals
JAX's narrow model at 1e-5 of scale wherever JAX's equals JAX's masked
model.  JAX's narrow MobileNetV2 decides a stage's residual from its
narrowed widths, so where pruning makes a non-residual stride-1 stage's
input and output widths equal it adds a residual the masked model never
had; the port keeps each block's configured structure.  That case is held
against both masked models.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.models.mobilenet_v2 import _MBV2_STAGES
from single_shot_detection_tpu.train import deps as jax_deps
from single_shot_detection_tpu.train import pruning as jax_pruning
from single_shot_detection_tpu.train.materialize import (
    materialize as jax_materialize, materialize_bundle as jax_materialize_bundle)
from single_shot_detection_tpu.train.state import create_train_state
from single_shot_detection_tpu_torch import export as pt_export
from single_shot_detection_tpu_torch.models import builder as pt_builder
from single_shot_detection_tpu_torch.train import deps, materialize, pruning
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.train.state import TrainState
from single_shot_detection_tpu_torch.utils.weights import (from_jax_variables,
                                                           to_jax_variables)

SMOKE = 'samples/synthetic_smoke.py'
CKPT_DIR = 'experiments/2026-08-16-225820'   # SMOKE's model, trained
CKPT = f'{CKPT_DIR}/ckpt-1800.msgpack'
CKPT_CONFIG = f'{CKPT_DIR}/config.py'
SSD2 = {'type': 'ssd', 'num_scales': 2, 'min_scale': 0.2, 'max_scale': 0.9,
        'aspect_ratios': [[1.0, 2.0]] * 2}
# tests/test_materialize.py's models and prunes (builders' arguments,
# include_paths and num), and MobileNet v1's
MODELS = {
    'flagship_like': (dict(
        base={'name': 'mobilenet_v2', 'depth_multiplier': 0.35},
        anchor_generator={'type': 'ssd', 'num_scales': 3, 'min_scale': 0.2,
                          'max_scale': 0.9,
                          'aspect_ratios': [[1.0, 2.0]] * 3},
        num_classes=5, use_depthwise=True,
        features={'name': 'Features', 'out_layers': (13, 18)},
        extras={'layers': (('s', 64),)}, input_size=(96, 96)),
        ['features', 'extra'], 12),
    'vgg_like': (dict(
        base={'name': 'torchvision_vgg16_bn'}, anchor_generator=SSD2,
        num_classes=5, use_depthwise=False,
        features={'name': 'Features', 'out_layers': (32, 42),
                  'last_feature_layer': 42},
        extras=None, input_size=(64, 64)), ['features'], 10),
    'resnet_like': (dict(
        base={'name': 'torchvision_resnet18'}, anchor_generator=SSD2,
        num_classes=5, use_depthwise=False,
        features={'name': 'Features', 'out_layers': (6, 7)},
        extras=None, input_size=(64, 64)), ['features'], 10),
    'fpn_like': (dict(
        base={'name': 'torchvision_resnet18'},
        anchor_generator={'type': 'retina_net', 'min_level': 3,
                          'max_level': 5, 'aspect_ratios': [1.0, 2.0],
                          'scale': 4.0},
        num_classes=5, use_depthwise=False,
        features={'name': 'FeaturePyramid', 'out_layers': (5, 6, 7),
                  'pyramid_layers': 3, 'pyramid_channels': 32},
        extras=None, input_size=(64, 64)), ['features'], 14),
    # MobileNet v1 under the depthwise FPN, whose own widths stay
    'mbv1_dfpn': (dict(
        base={'name': 'mobilenet_v1', 'depth_multiplier': 0.25},
        anchor_generator={'type': 'ssd', 'num_scales': 3, 'min_scale': 0.2,
                          'max_scale': 0.9,
                          'aspect_ratios': [[1.0, 2.0]] * 3},
        num_classes=5, use_depthwise=True,
        features={'name': 'DepthwiseFeaturePyramid', 'out_layers': (11, 13),
                  'pyramid_layers': 3, 'pyramid_channels': 32},
        extras=None, input_size=(64, 64)), ['features.base'], 10),
}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    processes, and torch's default of one thread per core makes them
    contend for the CPU, tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope='module')
def spaces_traced_once():
    """A model's channel spaces depend only on its architecture and input
    size: each one is traced once in this file (the committed checkpoint's
    experiment and the exported one share theirs)."""
    traced = {}
    build = materialize.build_channel_spaces

    def once(model, input_size):
        key = (tuple(input_size), tuple((k, tuple(v.shape)) for k, v in
                                        model.state_dict().items()))
        if key not in traced:
            traced[key] = build(model, input_size)
        return traced[key]

    materialize.build_channel_spaces = once
    yield
    materialize.build_channel_spaces = build


def seeded_bundle(kw, seed=0):
    """The port's model, seeded, its BN statistics and affine parameters
    perturbed so that no BN is the identity."""
    bundle = pt_builder.build(**kw)
    generator = torch.Generator().manual_seed(seed)
    bundle.module.reset_parameters(generator)
    with torch.no_grad():
        for m in bundle.module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(1 + 0.2 * torch.randn(c, generator=generator))
                m.bias.copy_(0.2 * torch.randn(c, generator=generator))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=generator))
                m.running_var.copy_(0.5 + torch.rand(c, generator=generator))
    bundle.module.eval()
    return bundle


def canon(spaces, port: bool):
    return sorted((s.width, s.frozen, tuple(sorted(
        (m.path, deps.jax_axis(m) if port else m.axis, m.offset, m.role)
        for m in s.members))) for s in spaces)


def prune_port(bundle, jax_bundle, include, num):
    """Prune the port's model once with ``MinL1Norm``; returns ``(pruner,
    spaces, the masked JAX variables, JAX's spaces)``.  (The JAX
    ``Pruner``'s dead sets and zeroed parameters equal the port's:
    ``test_torch_port_pruning.py``.)"""
    model = bundle.module
    w, h = bundle.input_size
    spaces = materialize.build_channel_spaces(model, bundle.input_size)
    jax_spaces = jax_deps.analyze_module(
        jax_bundle.module, to_jax_variables(model.state_dict()), (1, h, w, 3))
    assert canon(spaces, True) == canon(jax_spaces, False)
    pruner = pruning.Pruner(pruning.param_tree(model), {'name': 'MinL1Norm'},
                            include_paths=include, num=num, spaces=spaces)
    pruner.prune(TrainState(model, None, mask={}))
    assert pruner.dead
    return pruner, spaces, to_jax_variables(model.state_dict()), jax_spaces


def stage_producers(model):
    """Per backbone stage, the kernel path whose out-channels index it."""
    base = model.features.base
    kind = type(base).__name__
    prefix = ('features', 'base')
    if kind == 'MobileNetV2':
        return [prefix + (f'stage{i}',
                          'conv' if i in (0, 18) else 'project_conv', 'kernel')
                for i in range(19)]
    if kind == 'MobileNet':
        return [prefix + ('stage0_conv', 'kernel')] + [
            prefix + (f'stage{i}', 'pointwise_conv', 'kernel')
            for i in range(1, 14)]
    if kind == 'VGG':
        out, conv = [], None
        for layer in base.layers:
            if layer.startswith('conv'):
                conv = prefix + (layer, 'kernel')
            out.append(conv)
        return out
    blocks = [sum(1 for n, _ in base.named_children()
                  if n.startswith(f'layer{i}_')) for i in range(1, 5)]
    return [prefix + ('conv1', 'kernel')] * 4 + [
        prefix + (f'layer{i + 1}_{n - 1}', 'conv2', 'kernel')
        for i, n in enumerate(blocks)]


def port_outputs(model, x):
    with torch.no_grad():
        scores, locs = model.eval()(x)
        stages, _ = model.features.base(x)
    return [scores, locs], stages


def assert_close(got, want, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale)


def assert_narrow_equals_masked(narrow, masked, dead, producers, x,
                                stages_to_check=None):
    """Heads, and each stage on its kept channels (the pruned channels of
    the masked stage exactly 0)."""
    (heads_n, stages_n), (heads_m, stages_m) = (port_outputs(narrow, x),
                                                port_outputs(masked, x))
    for a, b in zip(heads_n, heads_m):
        assert_close(a, b)
    for i in stages_to_check or range(len(stages_m)):
        gone = sorted(dead.get(producers[i], ()))
        keep = [c for c in range(stages_m[i].shape[1]) if c not in gone]
        assert stages_n[i].shape[1] == len(keep), i
        assert_close(stages_n[i], stages_m[i][:, keep])
        assert torch.all(stages_m[i][:, gone] == 0), i
    return stages_n


def jax_adds_residual(model) -> list:
    """The MobileNetV2 stages where JAX's narrow model, deciding the
    residual from the narrowed widths, adds one that the configuration
    does not have."""
    base = model.features.base
    if type(base).__name__ != 'MobileNetV2':
        return []
    c_cfg, c = base.depth(32), base.stage_channels[0]
    out = []
    for i, (f, s, _) in enumerate(_MBV2_STAGES, start=1):
        f_cfg, f_now = base.depth(f), base.stage_channels[i]
        if s == 1 and c_cfg != f_cfg and c == f_now:
            out.append(i)
        c_cfg, c = f_cfg, f_now
    return out


def jax_forward(module, variables, x):
    """JAX's heads and backbone stages, one jit."""
    def run(v, xx):
        heads = module.apply(v, xx, train=False)
        stages, _ = module.apply(v, xx, train=False,
                                 method=lambda m, y, train:
                                 m.features.base(y, train=train))
        return heads, stages
    heads, stages = jax.jit(run)(variables, x)
    return ([np.asarray(h) for h in heads],
            [np.asarray(s).transpose(0, 3, 1, 2) for s in stages])


@pytest.mark.parametrize('name', sorted(MODELS))
def test_narrow_model_equals_masked_and_jax(name):
    """Spaces equal to JAX's (the ``test_torch_port_deps.py`` comparison,
    for these models here), dead sets equal to JAX's, ``materialize``'s
    tensors equal to JAX's bit for bit, the port's narrow model equal to
    its masked model and to JAX's narrow model, fewer parameters."""
    kw, include, num = MODELS[name]
    bundle = seeded_bundle(kw)
    masked = copy.deepcopy(bundle.module)
    jax_bundle = jax_builder.build(**kw)
    pruner, spaces, jvars, jax_spaces = prune_port(bundle, jax_bundle,
                                                   include, num)
    state = bundle.module.state_dict()

    new_state, widths = materialize.materialize(state, pruner.dead, spaces)
    jnew, jwidths = jax_materialize(jvars, pruner.dead, jax_spaces)
    assert widths == jwidths
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, jnew))
    assert new_state.keys() == want.keys()
    for k, v in new_state.items():
        assert torch.equal(v, want[k]), k

    narrow_bundle, narrow_state = materialize.materialize_bundle(
        bundle, state, pruner.dead, spaces)
    narrow = narrow_bundle.module
    assert not narrow.training
    for k, v in narrow.state_dict().items():
        assert torch.equal(v, narrow_state[k]), k
    assert (sum(p.numel() for p in narrow.parameters())
            < sum(p.numel() for p in masked.parameters()))
    np.testing.assert_array_equal(narrow_bundle.anchors, bundle.anchors)

    w, h = kw['input_size']
    x = np.random.RandomState(1).randn(2, h, w, 3).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    producers = stage_producers(bundle.module)
    stages_n = assert_narrow_equals_masked(narrow, bundle.module, pruner.dead,
                                           producers, xt)
    heads_n, _ = port_outputs(narrow, xt)

    jax_narrow, jax_narrow_vars = jax_materialize_bundle(
        jax_bundle, jvars, pruner.dead, spaces=jax_spaces)
    jheads, jstages = jax_forward(jax_narrow.module, jax_narrow_vars, x)
    diverged = jax_adds_residual(narrow)
    for i, (a, b) in enumerate(zip(stages_n, jstages)):
        if diverged and i >= diverged[0]:
            break
        assert_close(a.numpy(), b)
    if not diverged:
        for a, b in zip(heads_n, jheads):
            assert_close(a.numpy(), b)


def test_residual_case_keeps_the_masked_function():
    """Stage 0 of ``flagship_like`` pruned from 11 to 5 channels, stage 1's
    width (``MinL1Norm``, ``include_paths=['features.base.stage0']``,
    ``num=6``): JAX's narrow model would give stage 1 a residual
    (``jax_adds_residual``); the port's narrow model has none and equals
    the port's masked model and JAX's masked model at stages 1 and 2."""
    kw = MODELS['flagship_like'][0]
    bundle = seeded_bundle(kw)
    jax_bundle = jax_builder.build(**kw)
    pruner, spaces, jvars, _ = prune_port(
        bundle, jax_bundle, ['features.base.stage0'], 6)
    narrow_bundle, _ = materialize.materialize_bundle(
        bundle, bundle.module.state_dict(), pruner.dead, spaces)
    narrow = narrow_bundle.module
    base = narrow.features.base
    assert base.stage_channels[:2] == [5, 5] and not base.stage1.residual
    assert jax_adds_residual(narrow) == [1]

    x = np.random.RandomState(2).randn(2, 96, 96, 3).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    stages_n = assert_narrow_equals_masked(
        narrow, bundle.module, pruner.dead, stage_producers(bundle.module),
        xt, stages_to_check=(0, 1, 2))
    _, jstages = jax_forward(jax_bundle.module, jvars, x)
    for i in (1, 2):  # stage 0's output is not sliced there
        assert_close(stages_n[i].numpy(), jstages[i])


def test_committed_checkpoint_prunes_like_jax():
    """The committed JAX checkpoint (a trained SSD-MobileNetV2 at 0.35),
    pruned once by both packages from the same weights (``MinL1Norm`` over
    ``features`` and ``extra``, 8 picks, 16 channels with their writer
    groups): the same dead sets; the port's masked and narrow models give
    the same eval loss (rtol 1e-5) and mAP (within 1e-4) on the run's
    synthetic eval set (0.63, against 0.67 unpruned)."""
    pruner_cfg = {'include_paths': ['features', 'extra'], 'num': 8}
    exp = Experiment(CKPT_CONFIG, phases=('eval',), device='cpu',
                     resume_from=CKPT, load_weights=True,
                     overrides={'train': {'pruner': pruner_cfg}})
    with open(CKPT, 'rb') as f:
        raw = serialization.msgpack_restore(f.read())
    jax_bundle = jax_builder.build(
        **{k: v for k, v in exp.bundle.build_args.items() if k != 'dtype'})
    jax_spaces = jax_deps.analyze_module(
        jax_bundle.module, {'params': raw['params'],
                            'batch_stats': raw['batch_stats']},
        (1, 128, 128, 3))
    params = jax.tree_util.tree_map(jnp.asarray, raw['params'])
    jstate = create_train_state({'params': params,
                                 'batch_stats': raw['batch_stats']},
                                jax_pruning.masked(optax.sgd(1e-3)))
    jpruner = jax_pruning.Pruner(jstate.params, {'name': 'MinL1Norm'},
                                 spaces=jax_spaces, **pruner_cfg)
    jpruner.prune(jstate)
    exp.pruner.prune(exp.trainer.state)
    assert exp.pruner.dead == jpruner.dead
    assert sum(len(d) for d in exp.pruner.dead.values()) >= 8

    masked = exp.evaluate()
    bundle, _ = exp.materialize_pruned()
    exp.trainer.state.model = bundle.module  # evaluate the narrow model
    narrow = exp.evaluate()
    np.testing.assert_allclose(narrow['loss'], masked['loss'], rtol=1e-5)
    assert abs(narrow['mAP'] - masked['mAP']) <= 1e-4
    assert 0.5 < masked['mAP'] <= 1.0


def test_pruned_export_is_the_narrow_model(tmp_path):
    """A pruned ``Experiment``'s standalone ``.pt2`` holds the narrow
    model's weights and the NMS custom op, and its call equals the eager
    narrow inference function bit for bit."""
    exp = Experiment(SMOKE, phases=('train',), device='cpu', overrides={
        'train': {'epochs': 1, 'num_batches_per_epoch': 1,
                  'pruner': {'include_paths': ['features', 'extra'],
                             'num': 16}}})
    exp.train()
    bundle, state = exp.materialize_pruned()
    path = pt_export.export_model(exp, str(tmp_path / 'narrow'),
                                  with_postprocess=True, with_preprocess=True,
                                  bake_variables=True, batch_size=2)
    # one load: the call's module is the program's graph, unlifted
    call = pt_export.load_exported(path)
    assert any('nms_keep_batched' in str(n.target)
               for n in call.module.graph.nodes if n.op == 'call_function')
    shapes = sorted(tuple(v.shape) for k, v in call.module.state_dict().items()
                    if k.endswith('weight'))
    assert shapes == sorted(tuple(v.shape) for k, v in state.items()
                            if k.endswith('weight'))
    images = np.random.RandomState(3).randint(
        0, 256, (2, 128, 128, 3)).astype(np.float32)
    got = call(images)
    fn = pt_export._make_inference_fn_for(exp, bundle.module, True,
                                          with_preprocess=True,
                                          bake_variables=True)
    with torch.no_grad():
        want = fn(torch.from_numpy(images))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
