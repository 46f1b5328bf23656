"""Keras ``.h5`` weights for the MobileNet backbones (``model.base.weight``).

Port of ``single_shot_detection_tpu/utils/keras_import.py``: the ``.h5``
file is read with ``h5py`` (imported when a file is read, so a machine
without it can run everything else) and mapped straight into the port's
``state_dict``.  Keras keeps a conv kernel as ``[kh, kw, in, out]`` and a
depthwise one as ``[kh, kw, ch, 1]``; the port's are OIHW ``[out, in, kh,
kw]`` and ``[ch, 1, kh, kw]``.  ``gamma``/``beta`` become a BN's
``weight``/``bias``, ``moving_mean``/``moving_variance`` its running
statistics.  ``train/engine.py`` routes a ``.h5``/``.hdf5``
``base.weight`` here.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# how a keras layer's weight arrays convert
CONV = 'conv'            # kernel:0 [kh, kw, in, out] -> [out, in, kh, kw]
DEPTHWISE = 'depthwise'  # depthwise_kernel:0 [kh, kw, ch, 1] -> [ch, 1, kh, kw]
BN = 'bn'                # gamma/beta -> weight/bias; moving_* -> running_*


def load_keras_h5(path: str) -> Dict[str, np.ndarray]:
    """Every weight dataset of a keras ``.h5`` file by its group path (say
    ``conv1/conv1/kernel:0``), from a whole-model save (under
    ``model_weights/``) or a ``save_weights`` file."""
    import h5py

    out: Dict[str, np.ndarray] = {}
    with h5py.File(path, 'r') as f:
        root = f['model_weights'] if 'model_weights' in f else f

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = np.asarray(obj)

        root.visititems(visit)
    return out


def keras_mobilenet_v1_mapping() -> Dict[str, Tuple[Tuple[str, ...], str]]:
    """keras-applications MobileNet layer -> (the port's module path, kind),
    the names of ``torch_import.mobilenet_v1_mapping``."""
    m: Dict[str, Tuple[Tuple[str, ...], str]] = {
        'conv1': (('stage0_conv',), CONV),
        'conv1_bn': (('stage0_bn',), BN),
    }
    for i in range(1, 14):
        m[f'conv_dw_{i}'] = ((f'stage{i}', 'depthwise_conv'), DEPTHWISE)
        m[f'conv_dw_{i}_bn'] = ((f'stage{i}', 'depthwise_bn'), BN)
        m[f'conv_pw_{i}'] = ((f'stage{i}', 'pointwise_conv'), CONV)
        m[f'conv_pw_{i}_bn'] = ((f'stage{i}', 'pointwise_bn'), BN)
    return m


def keras_mobilenet_v2_mapping() -> Dict[str, Tuple[Tuple[str, ...], str]]:
    """keras-applications MobileNetV2 layer -> (the port's module path,
    kind)."""
    m: Dict[str, Tuple[Tuple[str, ...], str]] = {
        'Conv1': (('stage0', 'conv'), CONV),
        'bn_Conv1': (('stage0', 'bn'), BN),
        'expanded_conv_depthwise': (('stage1', 'depthwise_conv'), DEPTHWISE),
        'expanded_conv_depthwise_BN': (('stage1', 'depthwise_bn'), BN),
        'expanded_conv_project': (('stage1', 'project_conv'), CONV),
        'expanded_conv_project_BN': (('stage1', 'project_bn'), BN),
        'Conv_1': (('stage18', 'conv'), CONV),
        'Conv_1_bn': (('stage18', 'bn'), BN),
    }
    for i in range(2, 18):
        m[f'block_{i - 1}_expand'] = ((f'stage{i}', 'expand_conv'), CONV)
        m[f'block_{i - 1}_expand_BN'] = ((f'stage{i}', 'expand_bn'), BN)
        m[f'block_{i - 1}_depthwise'] = ((f'stage{i}', 'depthwise_conv'),
                                         DEPTHWISE)
        m[f'block_{i - 1}_depthwise_BN'] = ((f'stage{i}', 'depthwise_bn'), BN)
        m[f'block_{i - 1}_project'] = ((f'stage{i}', 'project_conv'), CONV)
        m[f'block_{i - 1}_project_BN'] = ((f'stage{i}', 'project_bn'), BN)
    return m


def keras_backbone_mapping(backbone: str
                           ) -> Dict[str, Tuple[Tuple[str, ...], str]]:
    """The mapping of a registry backbone: keras weights exist for the
    MobileNet v1 and v2 families only; any other raises ``KeyError``."""
    if backbone.startswith('mobilenet_v2'):
        return keras_mobilenet_v2_mapping()
    if backbone.startswith('mobilenet_v1') or (
            backbone.startswith('mobilenet_')
            and backbone[len('mobilenet_'):].isdigit()):
        return keras_mobilenet_v1_mapping()
    raise KeyError(
        f'No keras-weight mapping for backbone {backbone!r} (keras '
        f'pretrained weights exist for mobilenet v1/v2 only)')


def _layer_weights(datasets: Dict[str, np.ndarray],
                   layer: str) -> Dict[str, np.ndarray]:
    """One keras layer's arrays by their last name (``kernel:0``, ...).
    ``layer`` matches a whole group name, so ``conv1`` does not take
    ``conv1_bn``'s arrays."""
    found = {}
    for name, arr in datasets.items():
        parts = name.split('/')
        if layer in parts[:-1]:
            found[parts[-1]] = arr
    return found


def import_keras_backbone(path: str,
                          model_state: Mapping[str, torch.Tensor],
                          backbone: str,
                          base_path: Tuple[str, ...] = ('features', 'base'),
                          ) -> Dict[str, torch.Tensor]:
    """A copy of the detector's ``model_state`` with the backbone (under
    ``base_path``) filled from a keras ``.h5``.  Layers missing from the
    file, or from the model, keep their values (warned); a shape mismatch
    raises ``ValueError``."""
    mapping = keras_backbone_mapping(backbone)
    datasets = load_keras_h5(path)
    prefix = ''.join(f'{part}.' for part in base_path)
    if not any(k.startswith(prefix) for k in model_state):
        raise KeyError(f'no backbone subtree at {"/".join(base_path)}')
    out = dict(model_state)

    filled = 0
    missing_src = []
    missing_dst = []
    for layer, (our_path, kind) in mapping.items():
        weights = _layer_weights(datasets, layer)
        if not weights:
            missing_src.append(layer)
            continue
        target = '.'.join(base_path + our_path)
        if f'{target}.weight' not in out:
            missing_dst.append(layer)
            continue

        def put(leaf, value):
            key = f'{target}.{leaf}'
            if key not in out:
                return
            if tuple(value.shape) != tuple(out[key].shape):
                raise ValueError(
                    f'{layer}: shape mismatch {value.shape} -> '
                    f'{key} {tuple(out[key].shape)} (check '
                    f'depth_multiplier matches the weight file)')
            out[key] = torch.from_numpy(np.ascontiguousarray(value)).to(
                out[key].dtype)

        if kind == BN:
            for array, leaf in (('gamma:0', 'weight'), ('beta:0', 'bias'),
                                ('moving_mean:0', 'running_mean'),
                                ('moving_variance:0', 'running_var')):
                if array in weights:
                    put(leaf, weights[array])
        else:
            if 'kernel:0' in weights:  # [kh, kw, in, out] -> OIHW
                put('weight', weights['kernel:0'].transpose(3, 2, 0, 1))
            elif 'depthwise_kernel:0' in weights:  # -> [ch, 1, kh, kw]
                put('weight',
                    weights['depthwise_kernel:0'].transpose(2, 3, 0, 1))
            if 'bias:0' in weights:
                put('bias', weights['bias:0'])
        filled += 1

    if missing_src:
        logging.warning(f'WW keras import: layers missing in source file: '
                        f'{missing_src[:5]}... ({len(missing_src)} total)')
    if missing_dst:
        logging.warning(f'WW keras import: no target for layers '
                        f'{missing_dst[:5]}... ({len(missing_dst)} total)')
    logging.info(f'===> keras import: filled {filled} layers into '
                 f'{"/".join(base_path)}')
    return out
