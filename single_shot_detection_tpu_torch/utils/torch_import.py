"""A torchvision backbone's pretrained weights into the port (``model.base.weight``).

Port of the backbone part of
``single_shot_detection_tpu/utils/torch_import.py`` (MobileNetV2, MobileNet
v1, VGG, ResNet, ResNeXt, SE-ResNet(Xt), ShuffleNetV2):
:func:`load_torch_state_dict` reads a torch ``state_dict`` file, the
``*_mapping`` functions name torchvision's (and pretrainedmodels') modules
after the port's, and :func:`import_backbone` fills the backbone of a
detector's ``state_dict`` from it.  The port's layout is torch's (OIHW
kernels, ``running_mean``/``running_var``), so the import is a renaming
with shape checks.

Keras ``.h5`` files and the full-detector ``detector.torch_weight`` import
are not ported yet (``train/engine.py`` raises on them).
"""

from __future__ import annotations

import functools
import logging
from typing import Dict, Optional, Sequence, Tuple

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
