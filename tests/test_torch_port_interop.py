"""Port parity for the reference's whole-detector checkpoint
(``utils/torch_import.py``: the ``*_reference_mapping`` functions,
``import_reference_checkpoint``, ``export_state_dict``,
``export_reference_checkpoint``, ``mapping_args_from_config``), the
``model.detector.torch_weight`` path of ``train/engine.py`` and
``tools/export_torch_ckpt.py``, against the JAX package's functions on the
same variables (the port's seeded weights through ``to_jax_variables``,
BN statistics drawn away from 0/1).

Tolerances: none.  Written files, imports and round trips are bit-equal;
serving from imported weights gives the source model's detections bit for
bit.
"""

import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

from single_shot_detection_tpu.utils import torch_import as jax_torch_import
from single_shot_detection_tpu.utils.config import load_config as jax_load_config
from single_shot_detection_tpu_torch.models import builder
from single_shot_detection_tpu_torch.predict import Predictor
from single_shot_detection_tpu_torch.tools import export_torch_ckpt
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.utils import flax_msgpack, torch_import
from single_shot_detection_tpu_torch.utils.config import load_config
from single_shot_detection_tpu_torch.utils.weights import (from_jax_variables,
                                                           to_jax_variables)
from _torch_port_fixtures import one_torch_thread  # noqa: F401

SMOKE = 'samples/synthetic_smoke.py'
CKPT_DIR = 'experiments/2026-08-16-225820'   # SMOKE's model, trained
CKPT = f'{CKPT_DIR}/ckpt-1800.msgpack'
CKPT_CONFIG = f'{CKPT_DIR}/config.py'
# the four families of the reference's mappings: MobileNetV2 + Features,
# VGG16-BN + Features, ResNet50 + FPN + shared towers, VGG16-BN + MLFPN
CONFIGS = ('samples/ssd_mb2_voc.py', 'samples/ssd_300_vgg16_voc.py',
           'samples/retina_rn50_500_voc.py', 'samples/m2det_512_vgg16_voc.py')


def seeded_state(config: str, seed: int = 5) -> dict:
    """The config's detector at the port's seeded init, its BN statistics
    drawn away from 0/1 so that a dropped or fabricated statistic shows."""
    model = builder.from_config(load_config(config), seed=seed).module
    g = torch.Generator().manual_seed(seed)
    state = model.state_dict()
    for k, v in state.items():
        if k.endswith('running_mean'):
            v.copy_(torch.randn(v.shape, generator=g))
        elif k.endswith('running_var'):
            v.copy_(torch.rand(v.shape, generator=g) + 0.5)
    return state


def zeroed(state: dict) -> dict:
    return {k: torch.zeros_like(v) for k, v in state.items()}


def assert_files_equal(got_path: str, want_path: str) -> None:
    got = torch.load(got_path, map_location='cpu', weights_only=True)
    want = torch.load(want_path, map_location='cpu', weights_only=False)
    assert set(got) == set(want) == {'model_dict', 'epoch', 'global_step'}
    assert (got['epoch'], got['global_step']) == (want['epoch'],
                                                  want['global_step'])
    assert list(got['model_dict']) == list(want['model_dict'])
    for k, w in want['model_dict'].items():
        g = got['model_dict'][k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


@pytest.mark.parametrize('config', CONFIGS, ids=os.path.basename)
def test_reference_checkpoint_both_ways_equals_jax(config, tmp_path):
    """Each package writes the same reference checkpoint from the same
    weights, each imports it back bit-equal to the other and to the
    source, and the mappings are the same tables."""
    state = seeded_state(config)
    variables = to_jax_variables(state)
    model_cfg = dict(load_config(config).model)
    args = torch_import.mapping_args_from_config(model_cfg)
    assert args == jax_torch_import.mapping_args_from_config(model_cfg)
    mapping = torch_import.reference_detector_mapping(
        args['extras_spec'], args['num_scales'], args['use_depthwise'],
        torch_import.reference_backbone_mapping(args['backbone']),
        args['fpn'], args['mlfpn'], args['predictor'])
    assert mapping == jax_torch_import.reference_detector_mapping(
        args['extras_spec'], args['num_scales'], args['use_depthwise'],
        jax_torch_import.reference_backbone_mapping(args['backbone']),
        args['fpn'], args['mlfpn'], args['predictor'])

    ours, theirs = str(tmp_path / 'port.pt'), str(tmp_path / 'jax.pt')
    torch_import.export_reference_checkpoint(ours, state, epoch=4,
                                             global_step=77, **args)
    jax_torch_import.export_reference_checkpoint(theirs, variables, epoch=4,
                                                 global_step=77, **args)
    assert_files_equal(ours, theirs)

    got = torch_import.import_reference_checkpoint(ours, zeroed(state), **args)
    want = from_jax_variables(jax_torch_import.import_reference_checkpoint(
        ours, to_jax_variables(zeroed(state)), **args))
    assert got.keys() == state.keys()
    for k, v in state.items():
        if k.endswith('num_batches_tracked'):
            continue
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], v), k


def test_mapping_args_equal_jax_on_every_config():
    """``mapping_args_from_config`` gives JAX's answer on every shipped
    config and the committed run's, and the backbone mapping either
    resolves in both packages to the same table or raises in both."""
    configs = sorted(glob.glob('samples/*.py')) + [CKPT_CONFIG]
    raised = []
    for config in configs:
        model_cfg = dict(load_config(config).model)
        args = torch_import.mapping_args_from_config(model_cfg)
        assert args == jax_torch_import.mapping_args_from_config(model_cfg)
        try:
            want = jax_torch_import.reference_backbone_mapping(args['backbone'])
        except KeyError:
            with pytest.raises(KeyError, match='No reference-checkpoint'):
                torch_import.reference_backbone_mapping(args['backbone'])
            raised.append(os.path.basename(config))
            continue
        assert torch_import.reference_backbone_mapping(args['backbone']) == want
    assert raised == ['ssd_sh2_voc.py']


def test_port_raises_where_jax_raises():
    """ShuffleNet and SE-ResNet(Xt) have no reference layout, and the
    depthwise FPN no neck mapping: both packages raise, the anchored
    ResNet names and the MobileNet v1 aliases resolve."""
    for name in ('shufflenet_v2_x1_0', 'se_resnet50', 'se_resnext50_32x4d',
                 'pretrainedmodels_se_resnet50', 'mobilenet_v3_large'):
        for module in (torch_import, jax_torch_import):
            with pytest.raises(KeyError, match='No reference-checkpoint'):
                module.reference_backbone_mapping(name)
    for name in ('resnet18', 'torchvision_resnext50_32x4d', 'mobilenet_10',
                 'mobilenet_v1', 'vgg16', 'vgg16_bn'):
        assert (torch_import.reference_backbone_mapping(name)
                == jax_torch_import.reference_backbone_mapping(name)), name
    dfpn = {'base': {'name': 'mobilenet_v2'},
            'detector': {'features': {'name': 'DepthwiseFeaturePyramid',
                                      'out_layers': (13, 18),
                                      'pyramid_layers': 6}}}
    for module in (torch_import, jax_torch_import):
        with pytest.raises(KeyError, match='DepthwiseFeaturePyramid'):
            module.mapping_args_from_config(dfpn)
    model_cfg = dict(load_config('samples/ssd_sh2_voc.py').model)
    with pytest.raises(KeyError, match='shufflenet'):
        torch_import.import_reference_checkpoint(
            'unused.pt', {}, **torch_import.mapping_args_from_config(model_cfg))


def test_export_state_dict_fabricates_missing_statistics_as_jax(caplog):
    """A BN without running statistics exports identity ones with JAX's
    warning, and an entry with no source is skipped, as in JAX."""
    state = seeded_state(SMOKE)
    stripped = {k: v for k, v in state.items()
                if not k.startswith('extra0.reduce.bn.running')}
    variables = to_jax_variables(stripped)
    del variables['batch_stats']['extra0']
    mapping = {'a.bn': ('extra0', 'reduce', 'bn'),
               'a.conv': ('extra0', 'reduce', 'conv'),
               'a.gone': ('extra0', 'nothing')}
    with caplog.at_level(logging.WARNING):
        got = torch_import.export_state_dict(stripped, mapping)
    assert 'fabricated identity running stats' in caplog.text
    assert 'no source leaf' in caplog.text
    want = jax_torch_import.export_state_dict(variables, mapping)
    assert list(got) == list(want)
    for k, w in want.items():
        assert torch.equal(got[k], torch.from_numpy(np.array(w))), k


def test_import_is_strict_and_warns_on_unmapped_modules(tmp_path, caplog):
    """A tensor of another shape raises (JAX's ``convert_tensor`` raises
    too); a checkpoint module the mapping never names is warned about."""
    state = seeded_state(SMOKE)
    args = torch_import.mapping_args_from_config(dict(load_config(SMOKE).model))
    path = str(tmp_path / 'ckpt.pt')
    torch_import.export_reference_checkpoint(path, state, **args)
    payload = torch.load(path, weights_only=True)
    payload['model_dict']['predictor.stray.conv.weight'] = torch.zeros(1)
    torch.save(payload, path)
    with caplog.at_level(logging.WARNING):
        torch_import.import_reference_checkpoint(path, zeroed(state), **args)
    assert 'predictor.stray.conv' in caplog.text
    payload['model_dict']['predictor.heads.0.score.weight'] = torch.zeros(3, 3, 3, 3)
    torch.save(payload, path)
    for module, target in ((torch_import, zeroed(state)),
                           (jax_torch_import, to_jax_variables(zeroed(state)))):
        with pytest.raises(ValueError, match='predictor.heads.0.score'):
            module.import_reference_checkpoint(path, target, **args)


def test_torch_weight_in_the_engine(tmp_path):
    """``model.detector.torch_weight`` loads the whole detector after
    ``base.weight`` and before ``detector.weight``, as the JAX engine
    orders them, and the imported model serves the source model's
    detections bit for bit."""
    state = seeded_state(SMOKE, seed=9)
    model_cfg = dict(load_config(SMOKE).model)
    args = torch_import.mapping_args_from_config(model_cfg)
    path = str(tmp_path / 'ref.pt')
    torch_import.export_reference_checkpoint(path, state, **args)

    base_path = str(tmp_path / 'base.pth')
    torch.save(torch_import.export_state_dict(
        {k: torch.ones_like(v) for k, v in state.items()},
        torch_import.mobilenet_v2_mapping(), ('features', 'base')), base_path)
    exp = Experiment(SMOKE, phases=('eval',), device='cpu', overrides={
        'model': {'base': {'name': 'mobilenet_v2', 'depth_multiplier': 0.35,
                           'weight': base_path},
                  'detector': {**model_cfg['detector'], 'torch_weight': path}}})
    got = exp.model.state_dict()
    for k, v in state.items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(got[k], v), k

    images = np.random.RandomState(0).randint(0, 256, (2, 300, 300, 3),
                                              dtype=np.uint8)
    served = exp.predictor().predict_batch(images)
    want = Predictor.from_config(SMOKE, variables=to_jax_variables(state),
                                 device='cpu').predict_batch(images)
    assert bool(want[1].any())
    for g, w in zip(served, want):
        assert torch.equal(g, w)

    # detector.weight goes over torch_weight
    exp = Experiment(SMOKE, phases=('eval',), device='cpu', overrides={
        'model': {'detector': {**model_cfg['detector'], 'torch_weight': path,
                               'weight': CKPT}}})
    want = from_jax_variables(flax_msgpack.read(CKPT))
    got = exp.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want
               if not k.endswith('num_batches_tracked'))


def test_export_torch_ckpt_on_the_committed_run_equals_jax(tmp_path, capsys):
    """The tool on the committed JAX run writes JAX's ``export_state_dict``
    of the same variables, with the sidecar's epoch and step."""
    out = str(tmp_path / 'exported.pt')
    assert export_torch_ckpt.main(['--config', CKPT_CONFIG, '--checkpoint',
                                   CKPT_DIR, '--output', out]) == 0
    assert f'wrote {out}' in capsys.readouterr().out
    raw = flax_msgpack.read(CKPT)
    variables = {'params': raw['params'], 'batch_stats': raw['batch_stats']}
    args = jax_torch_import.mapping_args_from_config(
        dict(jax_load_config(CKPT_CONFIG).model))
    want = str(tmp_path / 'jax.pt')
    with open(f'{CKPT}.meta.json') as f:
        meta = json.load(f)
    jax_torch_import.export_reference_checkpoint(
        want, variables, epoch=meta['epoch'], global_step=meta['global_step'],
        **args)
    assert_files_equal(out, want)


@pytest.mark.parametrize('no_ema', [False, True], ids=['ema', 'no_ema'])
def test_export_torch_ckpt_takes_the_ema_shadow(tmp_path, no_ema):
    """A port ``.pt`` with an EMA shadow exports the shadow's parameters
    and the model's BN statistics, or with ``--no-ema`` the live ones."""
    state = seeded_state(SMOKE, seed=3)
    model = builder.from_config(load_config(SMOKE), seed=3).module
    ema = {k: torch.full_like(p, 0.5) for k, p in model.named_parameters()}
    ckpt_path = str(tmp_path / 'ckpt-6.pt')
    torch.save({'step': 6, 'model': state, 'optimizer': {}, 'lr_scale': 1.0,
                'ema': ema}, ckpt_path)
    out = str(tmp_path / 'out.pt')
    export_torch_ckpt.main(['--config', SMOKE, '--checkpoint', str(tmp_path),
                            '--output', out] + (['--no-ema'] if no_ema else []))
    args = torch_import.mapping_args_from_config(dict(load_config(SMOKE).model))
    want_state = dict(state) if no_ema else {**state, **ema}
    want = str(tmp_path / 'want.pt')
    torch_import.export_reference_checkpoint(want, want_state, global_step=6,
                                             **args)
    assert_files_equal(out, want)
