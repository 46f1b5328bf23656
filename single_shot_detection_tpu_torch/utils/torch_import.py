"""Torch checkpoints into the port and out of it.

Port of ``single_shot_detection_tpu/utils/torch_import.py``.  A
torchvision backbone's pretrained weights (``model.base.weight``;
MobileNetV2, MobileNet v1, VGG, ResNet, ResNeXt, SE-ResNet(Xt),
ShuffleNetV2): :func:`load_torch_state_dict` reads a torch ``state_dict``
file, the ``*_mapping`` functions name torchvision's (and
pretrainedmodels') modules after the port's, and :func:`import_backbone`
fills the backbone of a detector's ``state_dict`` from it.  The
reference's whole detector (``model.detector.torch_weight``, a
``ckpt-N.pt`` global_state with ``model_dict``): the ``*_reference_mapping``
functions, :func:`import_reference_checkpoint` and, the other way,
:func:`export_state_dict` and :func:`export_reference_checkpoint`
(``tools/export_torch_ckpt.py``), with :func:`mapping_args_from_config`
deriving a config's mapping.  A mapping's target is a flax module path,
which is the port's module path, so it names a key prefix of the port's
``state_dict``.  The port's layout is torch's (OIHW kernels,
``running_mean``/``running_var``), so both directions are a renaming with
shape checks, and a written file has the JAX package's keys, dtypes and
layout.
"""

from __future__ import annotations

import functools
import logging
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from single_shot_detection_tpu_torch.models.resnet import RESNET_CONFIGS
from single_shot_detection_tpu_torch.models.vgg import VGG_CONFIGS

# the port's MobileNetV2 backbone names (models/backbones.py)
_MOBILENET_V2 = ('mobilenet_v2', 'torchvision_mobilenet_v2', 'mobilenet_v2_10',
                 'mobilenet_v2_075', 'mobilenet_v2_050', 'mobilenet_v2_05',
                 'mobilenet_v2_035')


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``state_dict`` file, also one nested under ``state_dict`` or
    ``model_dict``; loaded with ``weights_only=True``."""
    payload = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(payload, dict) and 'state_dict' in payload:
        payload = payload['state_dict']
    if isinstance(payload, dict) and 'model_dict' in payload:
        payload = payload['model_dict']
    return dict(payload)


def mobilenet_v2_mapping() -> Dict[str, Tuple[str, ...]]:
    """torchvision mobilenet_v2 state_dict prefix -> the port's module path.

    torchvision: ``features.0`` (conv, BN, ReLU6), ``features.1..17``
    (inverted residuals with ``.conv.N`` submodules), ``features.18``.
    The port: ``stage0``, ``stage1..17`` (expand/depthwise/project),
    ``stage18``.
    """
    m: Dict[str, Tuple[str, ...]] = {}
    m['features.0.0'] = ('stage0', 'conv')
    m['features.0.1'] = ('stage0', 'bn')
    # stage 1 has no expansion: conv.0 = depthwise conv + BN, conv.1 =
    # project conv, conv.2 = project BN
    m['features.1.conv.0.0'] = ('stage1', 'depthwise_conv')
    m['features.1.conv.0.1'] = ('stage1', 'depthwise_bn')
    m['features.1.conv.1'] = ('stage1', 'project_conv')
    m['features.1.conv.2'] = ('stage1', 'project_bn')
    for i in range(2, 18):
        m[f'features.{i}.conv.0.0'] = (f'stage{i}', 'expand_conv')
        m[f'features.{i}.conv.0.1'] = (f'stage{i}', 'expand_bn')
        m[f'features.{i}.conv.1.0'] = (f'stage{i}', 'depthwise_conv')
        m[f'features.{i}.conv.1.1'] = (f'stage{i}', 'depthwise_bn')
        m[f'features.{i}.conv.2'] = (f'stage{i}', 'project_conv')
        m[f'features.{i}.conv.3'] = (f'stage{i}', 'project_bn')
    m['features.18.0'] = ('stage18', 'conv')
    m['features.18.1'] = ('stage18', 'bn')
    return m


def vgg_mapping(config, bn: bool = True) -> Dict[str, Tuple[str, ...]]:
    """torchvision vggN[_bn] ``features.K`` -> the port's ``conv{i}``
    [``bn{i}``].

    With BN each conv block is (conv, bn, relu), stride 3 in the
    ``features`` Sequential; without BN it is (conv, relu), stride 2.
    """
    m: Dict[str, Tuple[str, ...]] = {}
    idx = 0
    conv = 0
    for item in config:
        if item == 'M':
            idx += 1
            continue
        m[f'features.{idx}'] = (f'conv{conv}',)
        if bn:
            m[f'features.{idx + 1}'] = (f'bn{conv}',)
        idx += 3 if bn else 2
        conv += 1
    return m


def vgg_bn_mapping(config) -> Dict[str, Tuple[str, ...]]:
    return vgg_mapping(config, bn=True)


def resnet_mapping(layers: Sequence[int]) -> Dict[str, Tuple[str, ...]]:
    """torchvision resnet/resnext ``layer{L}.{b}.*`` -> the port's
    ``layer{L}_{b}.*`` (BasicBlocks have no ``conv3``/``bn3``; those entries
    find no target)."""
    m: Dict[str, Tuple[str, ...]] = {
        'conv1': ('conv1',), 'bn1': ('bn1',),
    }
    for li, count in enumerate(layers, start=1):
        for b in range(count):
            base = f'layer{li}.{b}'
            ours = f'layer{li}_{b}'
            for name in ('conv1', 'bn1', 'conv2', 'bn2', 'conv3', 'bn3'):
                m[f'{base}.{name}'] = (ours, name)
            m[f'{base}.downsample.0'] = (ours, 'downsample_conv')
            m[f'{base}.downsample.1'] = (ours, 'downsample_bn')
    return m


def shufflenet_v2_mapping(stage_repeats: Sequence[int] = (4, 8, 4)
                          ) -> Dict[str, Tuple[str, ...]]:
    """torchvision shufflenet_v2 -> the port's ``ShuffleNetV2`` names.

    torchvision: ``conv1.{0 conv, 1 bn}``; ``stage{2,3,4}.{i}.branch1.{0 dw,
    1 bn, 2 pw, 3 bn}`` (stride units only) and ``.branch2.{0 pw, 1 bn,
    3 dw, 4 bn, 5 pw, 6 bn}``; ``conv5.{0 conv, 1 bn}``.
    """
    m: Dict[str, Tuple[str, ...]] = {
        'conv1.0': ('conv1',), 'conv1.1': ('conv1_bn',),
        'conv5.0': ('conv5',), 'conv5.1': ('conv5_bn',),
    }
    for si, repeats in enumerate(stage_repeats, start=2):
        for i in range(repeats):
            base = f'stage{si}.{i}'
            ours = f'stage{si}_{i}'
            if i == 0:  # the stride unit has branch1
                m[f'{base}.branch1.0'] = (ours, 'branch1_dw')
                m[f'{base}.branch1.1'] = (ours, 'branch1_dw_bn')
                m[f'{base}.branch1.2'] = (ours, 'branch1_pw')
                m[f'{base}.branch1.3'] = (ours, 'branch1_pw_bn')
            m[f'{base}.branch2.0'] = (ours, 'branch2_pw1')
            m[f'{base}.branch2.1'] = (ours, 'branch2_pw1_bn')
            m[f'{base}.branch2.3'] = (ours, 'branch2_dw')
            m[f'{base}.branch2.4'] = (ours, 'branch2_dw_bn')
            m[f'{base}.branch2.5'] = (ours, 'branch2_pw2')
            m[f'{base}.branch2.6'] = (ours, 'branch2_pw2_bn')
    return m


def mobilenet_v1_mapping() -> Dict[str, Tuple[str, ...]]:
    """The reference's custom MobileNet v1 (``features.0.{conv,bn}``, then 13
    ``features.{i}.{depthwise,pointwise}_{conv,bn}`` blocks) -> the port's
    ``stage0_{conv,bn}`` and ``stage{1..13}`` names."""
    m: Dict[str, Tuple[str, ...]] = {
        'features.0.conv': ('stage0_conv',),
        'features.0.bn': ('stage0_bn',),
    }
    for i in range(1, 14):
        for name in ('depthwise_conv', 'depthwise_bn',
                     'pointwise_conv', 'pointwise_bn'):
            m[f'features.{i}.{name}'] = (f'stage{i}', name)
    return m


def se_resnet_mapping(layers: Sequence[int]) -> Dict[str, Tuple[str, ...]]:
    """pretrainedmodels se_resnet/se_resnext (``layer0.{conv1,bn1}``;
    ``layer{L}.{b}.{conv,bn}{1..3}``, ``.se_module.{fc1,fc2}`` 1x1 convs,
    ``.downsample.{0,1}``) -> the port's ``SEResNet`` names."""
    m: Dict[str, Tuple[str, ...]] = {
        'layer0.conv1': ('conv1',), 'layer0.bn1': ('bn1',),
    }
    for li, count in enumerate(layers, start=1):
        for b in range(count):
            base = f'layer{li}.{b}'
            ours = f'layer{li}_{b}'
            for name in ('conv1', 'bn1', 'conv2', 'bn2', 'conv3', 'bn3'):
                m[f'{base}.{name}'] = (ours, name)
            m[f'{base}.se_module.fc1'] = (ours, 'se', 'fc1')
            m[f'{base}.se_module.fc2'] = (ours, 'se', 'fc2')
            m[f'{base}.downsample.0'] = (ours, 'downsample_conv')
            m[f'{base}.downsample.1'] = (ours, 'downsample_bn')
    return m


SE_LAYERS = {
    'se_resnet50': (3, 4, 6, 3),
    'se_resnet101': (3, 4, 23, 3),
    'se_resnet152': (3, 8, 36, 3),
    'se_resnext50_32x4d': (3, 4, 6, 3),
    'se_resnext101_32x4d': (3, 4, 23, 3),
}

MAPPINGS = {name: mobilenet_v2_mapping for name in _MOBILENET_V2}
MAPPINGS['mobilenet_v1'] = mobilenet_v1_mapping
for _suffix in ('10', '075', '050', '05', '025'):
    MAPPINGS[f'mobilenet_{_suffix}'] = mobilenet_v1_mapping
for _suffix in ('x0_5', 'x1_0', 'x1_5', 'x2_0'):
    MAPPINGS[f'torchvision_shufflenet_v2_{_suffix}'] = shufflenet_v2_mapping
for _name, _layers in SE_LAYERS.items():
    MAPPINGS[f'pretrainedmodels_{_name}'] = functools.partial(
        se_resnet_mapping, _layers)


def resolve_mapping(backbone_name: str) -> Dict[str, Tuple[str, ...]]:
    """torch ``state_dict`` prefix -> the port's module path, for a
    registry backbone."""
    if backbone_name.startswith('torchvision_vgg'):
        depth = int(''.join(ch for ch in backbone_name if ch.isdigit()))
        return vgg_mapping(VGG_CONFIGS[depth],
                           bn=backbone_name.endswith('_bn'))
    if backbone_name.startswith(('torchvision_resnet', 'torchvision_resnext')):
        depth = int(''.join(ch for ch in backbone_name.split('_')[1]
                            if ch.isdigit()))
        return resnet_mapping(RESNET_CONFIGS[depth]['layers'])
    if backbone_name in MAPPINGS:
        return MAPPINGS[backbone_name]()
    raise KeyError(f'No torch mapping for backbone {backbone_name!r}')


_BN_LEAVES = ('weight', 'bias', 'running_mean', 'running_var')


def import_backbone(state_dict: Dict[str, torch.Tensor],
                    model_state: Dict[str, torch.Tensor],
                    backbone_name: str,
                    base_path: Tuple[str, ...] = ('features', 'base'),
                    mapping: Optional[Dict[str, Tuple[str, ...]]] = None
                    ) -> Dict[str, torch.Tensor]:
    """A copy of the detector's ``model_state`` with the backbone (under
    ``base_path``) filled from the torch ``state_dict``.

    Unmatched target modules keep their values (logged); a shape mismatch
    raises ``ValueError``.  An explicit ``mapping`` overrides the name-based
    one."""
    if mapping is None:
        mapping = resolve_mapping(backbone_name)
    out = dict(model_state)

    def put(torch_name: str, target: str) -> None:
        value = state_dict[torch_name]
        if tuple(value.shape) != tuple(out[target].shape):
            raise ValueError(f'{torch_name}: shape {tuple(value.shape)} != '
                             f'target {target} {tuple(out[target].shape)}')
        out[target] = value.detach().to(out[target].dtype).clone()

    filled = 0
    missing = []
    for torch_prefix, our_path in mapping.items():
        target = '.'.join(base_path + our_path)
        if f'{target}.weight' not in out:
            if f'{torch_prefix}.weight' in state_dict:
                missing.append(torch_prefix)
            continue
        if f'{torch_prefix}.running_mean' in state_dict:  # BatchNorm
            for leaf in _BN_LEAVES:
                if f'{torch_prefix}.{leaf}' in state_dict:
                    put(f'{torch_prefix}.{leaf}', f'{target}.{leaf}')
            filled += 1
        elif f'{torch_prefix}.weight' in state_dict:  # conv
            put(f'{torch_prefix}.weight', f'{target}.weight')
            filled += 1
            if f'{torch_prefix}.bias' in state_dict and f'{target}.bias' in out:
                put(f'{torch_prefix}.bias', f'{target}.bias')

    if missing:
        logging.warning(f'WW torch import: no target for {missing[:5]}...'
                        f' ({len(missing)} total)')
    logging.info(f'===> torch import: filled {filled} modules into '
                 f'{".".join(base_path)}')
    return out


# ----------------------------------------------- the reference's detector

def mobilenet_v2_reference_mapping() -> Dict[str, Tuple[str, ...]]:
    """The reference's own MobileNetV2 layout (``features.0.{conv,bn}``,
    ``features.{1..17}.{expand,depthwise,project}_{conv,bn}``,
    ``features.18.{conv,bn}``) -> the port's stage names."""
    m: Dict[str, Tuple[str, ...]] = {
        'features.0.conv': ('stage0', 'conv'),
        'features.0.bn': ('stage0', 'bn'),
        'features.18.conv': ('stage18', 'conv'),
        'features.18.bn': ('stage18', 'bn'),
    }
    for leaf in ('depthwise_conv', 'depthwise_bn',
                 'project_conv', 'project_bn'):
        m[f'features.1.{leaf}'] = ('stage1', leaf)
    for i in range(2, 18):
        for leaf in ('expand_conv', 'expand_bn', 'depthwise_conv',
                     'depthwise_bn', 'project_conv', 'project_bn'):
            m[f'features.{i}.{leaf}'] = (f'stage{i}', leaf)
    return m


def resnet_reference_mapping(layers: Sequence[int]
                             ) -> Dict[str, Tuple[str, ...]]:
    """The reference wraps a torchvision ResNet into an index-keyed
    ``features`` Sequential (conv1, bn1, relu, maxpool, layer1..4 at 0..7),
    so its keys are ``{idx}.{block}.{leaf}``."""
    m: Dict[str, Tuple[str, ...]] = {'0': ('conv1',), '1': ('bn1',)}
    for li, count in enumerate(layers, start=1):
        idx = li + 3  # layer1 lands at Sequential index 4
        for b in range(count):
            base = f'{idx}.{b}'
            ours = f'layer{li}_{b}'
            for name in ('conv1', 'bn1', 'conv2', 'bn2', 'conv3', 'bn3'):
                m[f'{base}.{name}'] = (ours, name)
            m[f'{base}.downsample.0'] = (ours, 'downsample_conv')
            m[f'{base}.downsample.1'] = (ours, 'downsample_bn')
    return m


def fpn_reference_mapping(num_laterals: int,
                          pyramid_layers: int) -> Dict[str, Tuple[str, ...]]:
    """The ``FeaturePyramid`` neck: plain-conv laterals and conv+BN output
    convs, keyed relative to the neck (``predictor.features.``)."""
    m: Dict[str, Tuple[str, ...]] = {}
    for i in range(num_laterals):
        m[f'pyramid_lateral.{i}'] = (f'lateral{i}',)
    for i in range(pyramid_layers):
        m[f'pyramid_output.{i}.conv'] = (f'output{i}', 'conv')
        m[f'pyramid_output.{i}.bn'] = (f'output{i}', 'bn')
    return m


def _convbn_entries(torch_prefix: str, our_path: Tuple[str, ...],
                    use_depthwise: bool = False) -> Dict[str, Tuple[str, ...]]:
    """The entries of one ``ConvBn`` or ``DepthwiseConvBn`` block."""
    if use_depthwise:
        return {f'{torch_prefix}.{leaf}': our_path + (leaf,)
                for leaf in ('depthwise_conv', 'depthwise_bn',
                             'pointwise_conv', 'pointwise_bn')}
    return {f'{torch_prefix}.conv': our_path + ('conv',),
            f'{torch_prefix}.bn': our_path + ('bn',)}


def mlfpn_reference_mapping(num_out_layers: int, num_scales: int,
                            num_tums: int, use_depthwise: bool = False
                            ) -> Dict[str, Tuple[str, ...]]:
    """M2Det's ``MultilevelFeaturePyramid``, keyed relative to the neck:
    the reference's ``down_layers.{j}``/``up_layers.{j}`` serve scale
    ``j + 1`` (the port's ``down{i}``/``up{i}``), ``smooth_layers.{j}`` is
    ``smooth{j}``, ``reducers.{t}`` feeds TUM ``t + 1``."""
    m: Dict[str, Tuple[str, ...]] = {}
    for i in range(num_out_layers):
        m.update(_convbn_entries(f'base_reducers.{i}', (f'base_reducer{i}',)))
    for t in range(num_tums):
        for i in range(1, num_scales):
            m.update(_convbn_entries(f'tums.{t}.down_layers.{i - 1}',
                                     (f'tum{t}', f'down{i}'), use_depthwise))
            m.update(_convbn_entries(f'tums.{t}.up_layers.{i - 1}',
                                     (f'tum{t}', f'up{i}'), use_depthwise))
        for j in range(num_scales):
            m.update(_convbn_entries(f'tums.{t}.smooth_layers.{j}',
                                     (f'tum{t}', f'smooth{j}'), use_depthwise))
    for t in range(1, num_tums):
        m.update(_convbn_entries(f'reducers.{t - 1}', (f'reducer{t}',)))
    for s in range(num_scales):
        m[f'sfam.fc1.{s}'] = ('sfam', f'fc1_{s}')
        m[f'sfam.fc2.{s}'] = ('sfam', f'fc2_{s}')
    return m


def shared_predictor_reference_mapping(num_layers: int, num_levels: int,
                                       use_depthwise: bool = False
                                       ) -> Dict[str, Tuple[str, ...]]:
    """``SharedConvPredictor``'s towers: per-head convs shared across
    levels (``convs.{head}.{l}``) and per-level BNs (``norms.{head}.{l}.{s}``),
    keyed relative to the predictor (``predictor.predictor.``)."""
    m: Dict[str, Tuple[str, ...]] = {}
    for head in ('score', 'loc'):
        for l in range(num_layers):
            if use_depthwise:
                for leaf in ('depthwise_conv', 'pointwise_conv'):
                    m[f'convs.{head}.{l}.{leaf}'] = (f'{head}_conv{l}', leaf)
            else:
                m[f'convs.{head}.{l}.conv'] = (f'{head}_conv{l}', 'conv')
            for s in range(num_levels):
                m[f'norms.{head}.{l}.{s}'] = (f'{head}_norm{l}_{s}',)
    return m


def reference_detector_mapping(extras_spec, num_scales: int,
                               use_depthwise: bool = False,
                               backbone_mapping: Optional[
                                   Dict[str, Tuple[str, ...]]] = None,
                               fpn: Optional[dict] = None,
                               mlfpn: Optional[dict] = None,
                               predictor: Optional[dict] = None,
                               ) -> Dict[str, Tuple[str, ...]]:
    """The whole detector of a reference checkpoint's ``model_dict``:
    ``predictor.features.base.<backbone>`` (the reference's ``Features``
    keeps the backbone's ``features`` children as its own ``base``, so one
    ``features.`` level goes), the neck (``predictor.features.*``: FPN
    with ``fpn = {'num_laterals', 'pyramid_layers'}``, MLFPN with ``mlfpn
    = {'num_out_layers', 'num_scales', 'num_tums'}``), the extras
    (``predictor.extras.{j}.{0,1}``), the shared towers
    (``predictor.predictor.*``, ``predictor = {'num_layers'}``; levels
    default to ``num_scales``) and the heads (``predictor.heads.{i}``)."""
    if backbone_mapping is None:
        backbone_mapping = mobilenet_v2_reference_mapping()
    m: Dict[str, Tuple[str, ...]] = {}
    for k, path in backbone_mapping.items():
        k = k[len('features.'):] if k.startswith('features.') else k
        m[f'predictor.features.base.{k}'] = ('features', 'base') + tuple(path)
    if fpn:
        for k, path in fpn_reference_mapping(
                int(fpn['num_laterals']), int(fpn['pyramid_layers'])).items():
            m[f'predictor.features.{k}'] = ('features',) + tuple(path)
    if mlfpn:
        for k, path in mlfpn_reference_mapping(
                int(mlfpn['num_out_layers']), int(mlfpn['num_scales']),
                int(mlfpn['num_tums']),
                bool(mlfpn.get('use_depthwise', use_depthwise))).items():
            m[f'predictor.features.{k}'] = ('features',) + tuple(path)
    if predictor:
        for k, path in shared_predictor_reference_mapping(
                int(predictor['num_layers']),
                int(predictor.get('num_levels', num_scales)),
                bool(predictor.get('use_depthwise', use_depthwise))).items():
            m[f'predictor.predictor.{k}'] = ('predictor',) + tuple(path)
    for j, (type_, _out) in enumerate(extras_spec):
        if type_ == 'm':  # a max pool: no parameters
            continue
        m[f'predictor.extras.{j}.0.conv'] = (f'extra{j}', 'reduce', 'conv')
        m[f'predictor.extras.{j}.0.bn'] = (f'extra{j}', 'reduce', 'bn')
        if use_depthwise:
            for leaf in ('depthwise_conv', 'depthwise_bn',
                         'pointwise_conv', 'pointwise_bn'):
                m[f'predictor.extras.{j}.1.{leaf}'] = (f'extra{j}', 'expand',
                                                       leaf)
        else:
            m[f'predictor.extras.{j}.1.conv'] = (f'extra{j}', 'expand', 'conv')
            m[f'predictor.extras.{j}.1.bn'] = (f'extra{j}', 'expand', 'bn')
    for i in range(num_scales):
        m[f'predictor.heads.{i}.score'] = (f'score_head{i}',)
        m[f'predictor.heads.{i}.loc'] = (f'loc_head{i}',)
    return m


def reference_backbone_mapping(backbone: str) -> Dict[str, Tuple[str, ...]]:
    """The backbone half of a reference checkpoint, by registry name: the
    reference's own MobileNets, the torchvision VGGs (their ``features``
    indices) and ResNet/ResNeXt (:func:`resnet_reference_mapping`).
    SE-ResNet(Xt) (pretrainedmodels' ``layer0`` layout) and any other name
    raise ``KeyError``."""
    if backbone.startswith('mobilenet_v2'):
        return mobilenet_v2_reference_mapping()
    # v1: 'mobilenet_v1' and the width aliases 'mobilenet_<digits>'; a bare
    # 'mobilenet_' prefix would catch other families
    if backbone.startswith('mobilenet_v1') or (
            backbone.startswith('mobilenet_')
            and backbone[len('mobilenet_'):].isdigit()):
        return mobilenet_v1_mapping()
    if 'vgg' in backbone:
        depth = int(''.join(ch for ch in backbone if ch.isdigit()))
        return vgg_mapping(VGG_CONFIGS[depth], bn=backbone.endswith('_bn'))
    # anchored, so 'se_resnet50' / 'se_resnext50_32x4d' do not match
    m = re.match(r'(?:torchvision_)?(?:resnet|resnext)(\d+)', backbone)
    if m:
        return resnet_reference_mapping(RESNET_CONFIGS[int(m[1])]['layers'])
    raise KeyError(f'No reference-checkpoint mapping for backbone '
                   f'{backbone!r} (supported: mobilenet v1/v2, vgg, '
                   f'resnet/resnext)')


def import_reference_checkpoint(path: str,
                                model_state: Dict[str, torch.Tensor],
                                extras_spec, num_scales: int,
                                use_depthwise: bool = False,
                                backbone: str = 'mobilenet_v2',
                                fpn: Optional[dict] = None,
                                mlfpn: Optional[dict] = None,
                                predictor: Optional[dict] = None
                                ) -> Dict[str, torch.Tensor]:
    """A copy of the detector's ``model_state`` filled from a reference
    training checkpoint (a ``ckpt-N.pt`` global_state with
    ``model_dict``).  Checkpoint modules the mapping does not name are
    warned about: the model keeps its initialization there."""
    mapping = reference_detector_mapping(
        extras_spec, num_scales, use_depthwise,
        backbone_mapping=reference_backbone_mapping(backbone),
        fpn=fpn, mlfpn=mlfpn, predictor=predictor)
    sd = load_torch_state_dict(path)
    unconsumed = sorted({k.rsplit('.', 1)[0] for k in sd
                         if k.rsplit('.', 1)[-1] in
                         ('weight', 'bias', 'running_mean', 'running_var')}
                        - set(mapping))
    if unconsumed:
        logging.warning(
            f'WW torch import: {len(unconsumed)} checkpoint modules have '
            f'no mapping entry and were NOT imported (model keeps its '
            f'init there): {unconsumed[:8]}...')
    return import_backbone(sd, model_state, 'reference_detector',
                           base_path=(), mapping=mapping)


def export_state_dict(model_state: Mapping[str, torch.Tensor],
                      mapping: Dict[str, Tuple[str, ...]],
                      base_path: Tuple[str, ...] = ()
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`import_backbone`: a torch ``state_dict`` in the
    mapping's names from the port's.  A BatchNorm gives ``weight``,
    ``bias``, ``running_mean``, ``running_var`` and ``num_batches_tracked``
    = 0 (identity statistics, warned about, where it has none); a conv its
    ``weight`` (and ``bias``), as f32.  Entries with no source module are
    skipped and logged."""
    out: Dict[str, torch.Tensor] = {}
    missing = []
    fabricated = []

    def f32(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to('cpu', torch.float32).contiguous().clone()

    for torch_prefix, our_path in mapping.items():
        source = '.'.join(base_path + tuple(our_path))
        weight = model_state.get(f'{source}.weight')
        if weight is None:
            missing.append(torch_prefix)
            continue
        out[f'{torch_prefix}.weight'] = f32(weight)
        if weight.ndim == 1:  # BatchNorm
            out[f'{torch_prefix}.bias'] = f32(model_state[f'{source}.bias'])
            mean = model_state.get(f'{source}.running_mean')
            var = model_state.get(f'{source}.running_var')
            if mean is None:
                fabricated.append(torch_prefix)
                mean, var = torch.zeros_like(weight), torch.ones_like(weight)
            out[f'{torch_prefix}.running_mean'] = f32(mean)
            out[f'{torch_prefix}.running_var'] = f32(var)
            out[f'{torch_prefix}.num_batches_tracked'] = torch.tensor(
                0, dtype=torch.int64)
        elif f'{source}.bias' in model_state:
            out[f'{torch_prefix}.bias'] = f32(model_state[f'{source}.bias'])
    if missing:
        logging.warning(f'WW torch export: no source leaf for '
                        f'{missing[:5]}... ({len(missing)} total)')
    if fabricated:
        logging.warning(
            f'WW torch export: fabricated identity running stats '
            f'(mean=0/var=1) for BatchNorms with no batch_stats leaf: '
            f'{fabricated[:5]}... ({len(fabricated)} total) '
            f'— the exported model will normalize differently in eval mode')
    logging.info(f'===> torch export: emitted {len(out)} tensors')
    return out


def export_reference_checkpoint(path: str,
                                model_state: Mapping[str, torch.Tensor],
                                extras_spec, num_scales: int,
                                use_depthwise: bool = False,
                                backbone: str = 'mobilenet_v2',
                                epoch: int = 0, global_step: int = 0,
                                fpn: Optional[dict] = None,
                                mlfpn: Optional[dict] = None,
                                predictor: Optional[dict] = None) -> str:
    """The inverse of :func:`import_reference_checkpoint`: ``torch.save``
    of ``{'model_dict', 'epoch', 'global_step'}`` as the reference writes
    and loads its checkpoints, for SSD, RetinaNet and M2Det over the
    backbones :func:`reference_backbone_mapping` knows."""
    mapping = reference_detector_mapping(
        extras_spec, num_scales, use_depthwise,
        backbone_mapping=reference_backbone_mapping(backbone),
        fpn=fpn, mlfpn=mlfpn, predictor=predictor)
    sd = export_state_dict(model_state, mapping, base_path=())
    torch.save({'model_dict': sd, 'epoch': int(epoch),
                'global_step': int(global_step)}, path)
    logging.info(f'===> wrote reference-format checkpoint {path} '
                 f'({len(sd)} tensors)')
    return path


def mapping_args_from_config(model_cfg: dict) -> dict:
    """The keyword arguments of :func:`import_reference_checkpoint` and
    :func:`export_reference_checkpoint` from a config's ``model`` dict.
    A neck without a mapping (``DepthwiseFeaturePyramid``) raises
    ``KeyError`` rather than leave the neck at its initialization."""
    detector_cfg = dict(model_cfg.get('detector', {}))
    base_name = dict(model_cfg.get('base', {})).get('name', 'mobilenet_v2')
    backbone = base_name[len('torchvision_'):] \
        if base_name.startswith('torchvision_') else base_name
    extras_spec = tuple(dict(detector_cfg.get('extras', {}))
                        .get('layers', ()))
    features_cfg = dict(detector_cfg.get('features', {}))
    fpn = None
    mlfpn = None
    features_name = features_cfg.get('name', 'Features')
    if features_name == 'FeaturePyramid':
        fpn = {'num_laterals': len(features_cfg.get('out_layers', ())),
               'pyramid_layers': int(features_cfg['pyramid_layers'])}
    elif features_name == 'MultilevelFeaturePyramid':
        mlfpn = {'num_out_layers': len(features_cfg.get('out_layers', ())),
                 'num_scales': int(features_cfg['num_scales']),
                 'num_tums': int(features_cfg['num_tums'])}
    elif features_name not in (None, '', 'Features'):
        raise KeyError(
            f'No reference-checkpoint mapping for neck {features_name!r} '
            f"(supported: Features, FeaturePyramid, "
            f"MultilevelFeaturePyramid)")
    predictor_cfg = detector_cfg.get('predictor')
    predictor = ({'num_layers': int(predictor_cfg.get('num_layers', 0))}
                 if predictor_cfg else None)
    if fpn:
        num_sources = fpn['pyramid_layers']
    elif mlfpn:
        num_sources = mlfpn['num_scales']
    else:
        num_sources = len(features_cfg.get('out_layers', ()))
    num_scales = int(dict(model_cfg.get('anchor_generator', {})).get(
        'num_scales', num_sources + len(extras_spec)))
    return dict(extras_spec=extras_spec, num_scales=num_scales,
                use_depthwise=bool(detector_cfg.get('use_depthwise', False)),
                backbone=backbone, fpn=fpn, mlfpn=mlfpn,
                predictor=predictor)
