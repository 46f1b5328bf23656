"""Port parity for the rest of the interop and tool slice: offline
``torchhub://`` backbones (``models/builder.py::resolve_torchhub``), keras
``.h5`` backbones (``utils/keras_import.py``), the necks' bilinear
interpolation (``models/features.py::interpolate``), the
``tools/resize_to_smallest.py`` tool, and ``ReduceLROnPlateau`` under an
explicit ``scheduler_metric: None``, each against the JAX package.

Tolerances: hub resolution, imports, the tool's files and the plateau's
scales exact.  Bilinear resizes within 2e-6 of the input's largest
magnitude: torch computes each output's source coordinate as ``(i + 0.5) *
in / out - 0.5`` from a rounded ``in / out``, JAX by its own rounding, so
at a ratio such as 32 -> 63 a weight differs by up to 1e-6 (one in a few
rows; integer ratios and the edges agree), and the taps sum in another
order.
"""

import importlib.util
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.models import features as jax_features
from single_shot_detection_tpu.train import schedulers as jax_schedulers
from single_shot_detection_tpu.utils import keras_import as jax_keras_import
from single_shot_detection_tpu_torch.models import builder, features
from single_shot_detection_tpu_torch.models.mobilenet import MobileNet
from single_shot_detection_tpu_torch.models.mobilenet_v2 import MobileNetV2
from single_shot_detection_tpu_torch.tools import resize_to_smallest
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.utils import keras_import, torch_import
from single_shot_detection_tpu_torch.utils.config import load_config
from single_shot_detection_tpu_torch.utils.weights import (from_jax_variables,
                                                           to_jax_variables)
from _torch_port_fixtures import one_torch_thread  # noqa: F401

h5py = pytest.importorskip('h5py')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = 'samples/synthetic_smoke.py'
FIXTURES = os.path.join(REPO, 'single_shot_detection_tpu_torch', 'data',
                        'jpeg_fixtures', 'VOC2007')
HUB_MODEL = 'torchhub://pytorch/vision:mobilenet_v2'
BILINEAR_TOL = 2e-6


def random_state(state: dict, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.rand(v.shape, generator=g) + 0.5 if v.is_floating_point()
                else v.clone()) for k, v in state.items()}


# --------------------------------------------------------------- torchhub

def test_resolve_torchhub_matches_jax(tmp_path, monkeypatch):
    """JAX's cases (``tests/test_torch_import.py::
    test_torchhub_offline_resolution``) and the search order: ``hub_dir``,
    then ``$TORCH_HOME/hub``, then ``~/.cache/torch/hub``."""
    ckpts = tmp_path / 'hub' / 'checkpoints'
    ckpts.mkdir(parents=True)
    weight = ckpts / 'mobilenet_v2-b0353104.pth'
    torch.save({'dummy': torch.zeros(1)}, str(weight))
    home = tmp_path / 'home'
    (home / '.cache' / 'torch' / 'hub' / 'checkpoints').mkdir(parents=True)
    cached = home / '.cache' / 'torch' / 'hub' / 'checkpoints' / 'mobilenet_v2-x.pt'
    torch.save({}, str(cached))
    monkeypatch.setenv('HOME', str(home))
    cases = [(HUB_MODEL, str(tmp_path / 'hub')),
             (HUB_MODEL, str(tmp_path / 'missing')),
             ('torchhub://pytorch/vision:mobilenet_v1', str(tmp_path / 'hub')),
             (HUB_MODEL, None)]
    answers = []
    for env in (None, str(tmp_path)):
        if env:
            monkeypatch.setenv('TORCH_HOME', env)
        else:
            monkeypatch.delenv('TORCH_HOME', raising=False)
        for name, hub_dir in cases:
            got = builder.resolve_torchhub(name, hub_dir)
            assert got == jax_builder.resolve_torchhub(name, hub_dir), (name, env)
            answers.append(got)
    assert answers == [('mobilenet_v2', str(weight)), ('mobilenet_v2', None),
                       ('mobilenet_v1', None), ('mobilenet_v2', str(cached))] + [
        ('mobilenet_v2', str(weight)), ('mobilenet_v2', None),
        ('mobilenet_v1', None), ('mobilenet_v2', str(weight))]
    assert isinstance(builder.create_base(HUB_MODEL, hub_dir=str(tmp_path)),
                      MobileNetV2)
    for module in (builder, jax_builder):
        with pytest.raises(ValueError, match='torch-hub'):
            module.resolve_torchhub('torchhub://some/repo:not_a_backbone')


def test_torchhub_backbone_in_the_engine(tmp_path):
    """A ``torchhub://`` backbone takes the hub cache's weights into the
    backbone bit for bit; an explicit ``base.weight`` wins over them."""
    model = builder.from_config(load_config(SMOKE)).module
    mapping = torch_import.mobilenet_v2_mapping()
    written = {}
    for name, seed in (('hub', 1), ('explicit', 2)):
        state = random_state(model.state_dict(), seed)
        written[name] = torch_import.export_state_dict(state, mapping,
                                                       ('features', 'base'))
    (tmp_path / 'checkpoints').mkdir()
    torch.save(written['hub'], str(tmp_path / 'checkpoints' / 'mobilenet_v2-x.pth'))
    torch.save(written['explicit'], str(tmp_path / 'explicit.pth'))
    base = {'name': HUB_MODEL, 'depth_multiplier': 0.35,
            'hub_dir': str(tmp_path)}
    for name, extra in (('hub', {}), ('explicit',
                                      {'weight': str(tmp_path / 'explicit.pth')})):
        exp = Experiment(SMOKE, phases=('eval',), device='cpu',
                         overrides={'model': {'base': {**base, **extra}}})
        got = torch_import.export_state_dict(exp.model.state_dict(), mapping,
                                             ('features', 'base'))
        assert got.keys() == written[name].keys()
        for k, v in written[name].items():
            if not k.endswith('num_batches_tracked'):
                assert torch.equal(got[k], v), (name, k)


# ------------------------------------------------------------------ keras

def write_keras_h5(path, mapping, params, rng, nested: bool) -> dict:
    """An ``.h5`` in keras-applications' layout (``<layer>/<layer>/
    <weight>:0``), shaped from a JAX params tree (JAX's test's writer)."""
    def get(tree, keys):
        for k in keys:
            tree = tree[k]
        return tree

    written = {}
    with h5py.File(path, 'w') as f:
        root = f.create_group('model_weights') if nested else f
        for layer, (our_path, kind) in mapping.items():
            grp = root.create_group(layer).create_group(layer)
            leaf = get(params, our_path)
            arrays = {}
            if kind == keras_import.BN:
                ch = np.asarray(leaf['scale']).shape[0]
                arrays['gamma:0'] = rng.randn(ch).astype(np.float32)
                arrays['beta:0'] = rng.randn(ch).astype(np.float32)
                arrays['moving_mean:0'] = rng.randn(ch).astype(np.float32)
                arrays['moving_variance:0'] = np.abs(rng.randn(ch)).astype(
                    np.float32)
            elif kind == keras_import.DEPTHWISE:
                kh, kw, one, ch = np.asarray(leaf['kernel']).shape
                arrays['depthwise_kernel:0'] = rng.randn(kh, kw, ch, one).astype(
                    np.float32)
            else:
                arrays['kernel:0'] = rng.randn(
                    *np.asarray(leaf['kernel']).shape).astype(np.float32)
            for name, arr in arrays.items():
                grp.create_dataset(name, data=arr)
            written[layer] = arrays
    return written


@pytest.mark.parametrize('nested', [False, True], ids=['weights', 'model'])
@pytest.mark.parametrize('family', ['v1', 'v2'])
def test_keras_import_equals_jax(tmp_path, family, nested):
    """Both layouts (``save_weights`` and a whole model's
    ``model_weights/``), both MobileNet families: the port's import is
    JAX's bit for bit, every mapped array lands (a conv transposed to
    OIHW, a depthwise kernel to ``[ch, 1, kh, kw]``, the moments in the
    running statistics), and the rest keeps its values."""
    model = MobileNet() if family == 'v1' else MobileNetV2()
    state = model.state_dict()
    variables = to_jax_variables(state)
    mapping = keras_import.keras_backbone_mapping(f'mobilenet_{family}')
    assert mapping == jax_keras_import.keras_backbone_mapping(f'mobilenet_{family}')
    path = str(tmp_path / 'w.h5')
    written = write_keras_h5(path, mapping, variables['params'],
                             np.random.RandomState(0), nested)
    got = keras_import.import_keras_backbone(path, state, f'mobilenet_{family}',
                                             base_path=())
    want = from_jax_variables(jax_keras_import.import_keras_backbone(
        path, variables, f'mobilenet_{family}', base_path=()))
    changed = 0
    for k, v in state.items():
        if k.endswith('num_batches_tracked'):
            continue
        assert torch.equal(got[k], want[k]), k
        changed += not torch.equal(got[k], v)
    n_bn = sum(kind == keras_import.BN for _, kind in mapping.values())
    assert changed == len(mapping) + 3 * n_bn  # each layer; BN's 4 leaves
    layer = 'conv_dw_5' if family == 'v1' else 'block_4_depthwise'
    target = 'stage5.depthwise_conv.weight'
    np.testing.assert_array_equal(
        got[target].numpy(),
        written[layer]['depthwise_kernel:0'].transpose(2, 3, 0, 1))


def test_keras_import_raises_as_jax(tmp_path, caplog):
    """A width that does not match the file raises in both packages; a
    backbone keras has no weights for raises ``KeyError``; a ``.h5``
    ``base.weight`` goes through the keras import in the engine."""
    model = MobileNet(depth_multiplier=0.5)
    state = model.state_dict()
    variables = to_jax_variables(state)
    mapping = keras_import.keras_mobilenet_v1_mapping()
    path = str(tmp_path / 'w.h5')
    write_keras_h5(path, mapping, to_jax_variables(MobileNet().state_dict())[
        'params'], np.random.RandomState(1), False)
    with pytest.raises(ValueError, match='shape mismatch'):
        keras_import.import_keras_backbone(path, state, 'mobilenet_v1',
                                           base_path=())
    with pytest.raises(ValueError, match='shape mismatch'):
        jax_keras_import.import_keras_backbone(path, variables, 'mobilenet_v1',
                                               base_path=())
    for module in (keras_import, jax_keras_import):
        with pytest.raises(KeyError, match='keras'):
            module.keras_backbone_mapping('torchvision_vgg16_bn')

    smoke = builder.from_config(load_config(SMOKE)).module.state_dict()
    v2 = keras_import.keras_mobilenet_v2_mapping()
    path = str(tmp_path / 'smoke.hdf5')
    written = write_keras_h5(
        path, v2, to_jax_variables(smoke)['params']['features']['base'],
        np.random.RandomState(2), True)
    exp = Experiment(SMOKE, phases=('eval',), device='cpu', overrides={
        'model': {'base': {'name': 'mobilenet_v2', 'depth_multiplier': 0.35,
                           'weight': path}}})
    np.testing.assert_array_equal(
        exp.model.state_dict()['features.base.stage3.expand_conv.weight'].numpy(),
        written['block_2_expand']['kernel:0'].transpose(3, 2, 0, 1))


# ------------------------------------------------------------------ necks

def neck_resizes(config: str):
    """Every ``(input [h, w], output [h, w])`` a config's neck resizes, from
    a forward of its bilinear detector on the ``meta`` device."""
    cfg = load_config(config)
    model_cfg = dict(cfg.model)
    detector = dict(model_cfg['detector'])
    detector['features'] = {**detector['features'],
                            'interpolation_mode': 'bilinear'}
    with torch.device('meta'):
        model = builder.build(
            base=model_cfg['base'],
            anchor_generator=model_cfg['anchor_generator'],
            input_size=tuple(cfg.input_size),
            **{k: v for k, v in detector.items()
               if k in builder.DETECTOR_KEYS}).module.eval()
    sizes = []
    interpolate = features.interpolate

    def record(x, size, mode='nearest'):
        assert mode == 'bilinear'
        sizes.append((tuple(x.shape[2:]), tuple(size)))
        return interpolate(x, size, mode)

    w, h = cfg.input_size
    features.interpolate = record
    try:
        model(torch.empty(1, 3, h, w, device='meta'))
    finally:
        features.interpolate = interpolate
    return sorted(set(sizes))


def test_bilinear_interpolate_equals_jax_at_the_necks_sizes():
    """RetinaNet-500's FPN (63 <- 32, ...) and M2Det-512's TUMs and SFAM
    input, all enlargements: the port's ``bilinear`` and ``linear`` against
    JAX's ``interpolate`` within ``BILINEAR_TOL`` of the input's scale,
    the edge rows and columns as well; ``nearest`` bit-equal."""
    sizes = (neck_resizes('samples/retina_rn50_500_voc.py')
             + neck_resizes('samples/m2det_512_vgg16_voc.py'))
    assert ((32, 32), (63, 63)) in sizes and len(sizes) >= 6
    rng = np.random.RandomState(0)
    worst = 0.0
    for (hi, wi), (ho, wo) in sizes:
        assert ho >= hi and wo >= wi
        x = rng.randn(2, 8, hi, wi).astype(np.float32)
        nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
        for mode in ('bilinear', 'linear', 'nearest'):
            got = features.interpolate(torch.from_numpy(x), (ho, wo), mode).numpy()
            want = np.asarray(jax_features.interpolate(
                nhwc, (ho, wo), mode)).transpose(0, 3, 1, 2)
            if mode == 'nearest':
                np.testing.assert_array_equal(got, want)
                continue
            err = np.abs(got - want) / np.abs(x).max()
            worst = max(worst, float(err.max()))
            assert err.max() <= BILINEAR_TOL, ((hi, wi), (ho, wo), mode)
            edges = np.concatenate([err[:, :, [0, -1], :].ravel(),
                                    err[:, :, :, [0, -1]].ravel()])
            assert edges.max() <= BILINEAR_TOL
    assert worst > 0.0  # the two differ at all: the comparison is live


# ------------------------------------------------------------ resize tool

def load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        'jax_resize_to_smallest', os.path.join(REPO, 'tools',
                                               'resize_to_smallest.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_resize_to_smallest_equals_jax(tmp_path, monkeypatch, capsys):
    """Four fixtures, each XML beside its JPEG: three shrink (one
    grayscale), one is already at the target; the port's images are JAX's
    byte for byte and its XML equal."""
    src = tmp_path / 'src'
    (src / 'sub').mkdir(parents=True)
    for name, where in (('fx00', src), ('fx06', src), ('fx09', src / 'sub'),
                        ('fx12', src / 'sub')):
        shutil.copy(os.path.join(FIXTURES, 'JPEGImages', f'{name}.jpg'), where)
        shutil.copy(os.path.join(FIXTURES, 'Annotations', f'{name}.xml'), where)
    port_out, jax_out = tmp_path / 'port', tmp_path / 'jax'
    assert resize_to_smallest.main(['--root', str(src), '--size', '300',
                                    '--output', str(port_out),
                                    '--workers', '2']) == 0
    assert 'resized 3/4 images' in capsys.readouterr().out
    monkeypatch.setattr(sys, 'argv', ['resize_to_smallest.py', '--root',
                                      str(src), '--size', '300', '--output',
                                      str(jax_out), '--workers', '2'])
    load_jax_tool().main()
    assert 'resized 3/4 images' in capsys.readouterr().out
    names = sorted(os.listdir(jax_out))
    assert names == sorted(os.listdir(port_out)) == [
        'fx00.jpg', 'fx00.xml', 'fx06.jpg', 'fx06.xml', 'fx12.jpg', 'fx12.xml']
    for name in names:
        assert ((port_out / name).read_bytes()
                == (jax_out / name).read_bytes()), name
    assert b'<width>400</width>' in (port_out / 'fx00.xml').read_bytes()


# ---------------------------------------------------------------- plateau

def test_plateau_with_scheduler_metric_none_follows_jax():
    """``scheduler_metric: None`` feeds the plateau ``eval_loss``, as the
    JAX engine does: the scales after each evaluation are JAX's rule's on
    the same values, and the rate drops."""
    plateau = {'name': 'ReduceLROnPlateau', 'scheduler_metric': None,
               'mode': 'max', 'patience': 0, 'factor': 0.5, 'threshold': 0.5}
    exp = Experiment(SMOKE, device='cpu', overrides={'train': {
        'epochs': 4, 'eval_every': 1, 'num_batches_per_epoch': 1,
        'scheduler': plateau}})
    assert exp.trainer.scheduler_metric is None
    fed = []
    update = exp.trainer.plateau.update

    def recorded(value):
        fed.append((value, update(value)))
        return fed[-1][1]

    exp.trainer.plateau.update = recorded
    rows = exp.train()
    assert [v for v, _ in fed] == [row['eval_loss'] for row in rows]
    rule = jax_schedulers.ReduceLROnPlateau(
        **{k: v for k, v in plateau.items()
           if k not in ('name', 'scheduler_metric')})
    assert [s for _, s in fed] == [rule.update(v) for v, _ in fed]
    assert exp.trainer.state.lr_scale == fed[-1][1] < 1.0
