"""A torchvision backbone's pretrained weights into the port (``model.base.weight``).

Port of the MobileNetV2 part of ``single_shot_detection_tpu/utils/
torch_import.py``: :func:`load_torch_state_dict` reads a torch
``state_dict`` file, :func:`mobilenet_v2_mapping` names torchvision's
MobileNetV2 modules after the port's, and :func:`import_backbone` fills the
backbone of a detector's ``state_dict`` from it.  The port's layout is
torch's (OIHW kernels, ``running_mean``/``running_var``), so the import is a
renaming with shape checks.

The other backbones' mappings, keras ``.h5`` files and the full-detector
``detector.torch_weight`` import raise ``NotImplementedError`` until their
models are ported.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import torch

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


def resolve_mapping(backbone_name: str) -> Dict[str, Tuple[str, ...]]:
    if backbone_name in _MOBILENET_V2:
        return mobilenet_v2_mapping()
    raise NotImplementedError(
        f'importing torch weights for backbone {backbone_name!r} is not '
        'ported yet (ported: MobileNetV2)')


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
