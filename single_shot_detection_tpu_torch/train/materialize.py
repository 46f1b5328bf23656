"""Physical pruning materialization: shrink tensors and rebuild a narrow
model.

Port of ``single_shot_detection_tpu/train/materialize.py``.  Masking
(``train/pruning.py``) keeps training shapes static; at deploy time this
module slices the ``state_dict`` along the pruned channels and rebuilds the
detector at the narrower widths.

Channel dependencies come from the graph analyzer (``train/deps.py``): each
*space* lists every tensor range that shares one channel dimension
(producer and depthwise conv weights on axis 0, consumer conv weights on
axis 1, and per-channel vectors such as BN weight, bias and running
statistics and conv biases), with per-segment offsets so consumers of
concatenated features slice correctly.  Spaces the analyzer cannot prove
safe are frozen and skipped with a warning.

The rebuild goes through the models' width overrides: MobileNetV2
(``width_overrides``), MobileNet v1, VGG, ResNet/ResNeXt (per-block
widths), the FPN's laterals and outputs (``features.width_overrides``) and
the SSD extras (``extras_overrides``); other necks keep their own widths
and take the narrowed backbone's as their input.  A block's structure (a
residual, a downsample branch) stays as configured, so the narrow model
computes what the masked one does.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from single_shot_detection_tpu_torch.train import deps
from single_shot_detection_tpu_torch.utils.weights import variable_path

Path = Tuple[str, ...]

def build_channel_spaces(model: torch.nn.Module, input_size) -> List[deps.Space]:
    """Channel spaces of a detector (``deps.analyze_module``) at
    ``input_size = (w, h)``."""
    w, h = input_size
    return deps.analyze_module(model, (1, 3, h, w))


def materialize(state_dict: Mapping[str, torch.Tensor],
                dead: Mapping[Path, set], spaces: List[deps.Space]):
    """Slice away dead channels; returns ``(state_dict, widths)``.

    ``dead`` maps conv *kernel* paths (without the collection, as
    ``Pruner.dead`` gives them) to dead out-channel sets.  ``widths`` maps
    each conv's module path (``('features', 'base', 'stage0', 'conv')``)
    to its new out-channel count, for the rebuild.
    """
    names = {variable_path(name, value.ndim): name
             for name, value in state_dict.items()}
    names.pop(None, None)  # num_batches_tracked
    flat = {path: state_dict[name] for path, name in names.items()}

    writer_index: Dict[Tuple[Path, int], List[Tuple[deps.Member, deps.Space]]] = {}
    for s in spaces:
        for m in s.members:
            if m.role in ('producer', 'depthwise'):
                writer_index.setdefault((m.path, m.axis), []).append((m, s))

    # 1) fold per-kernel dead channels into per-space dead sets
    space_dead: Dict[int, set] = {}
    frozen_hits = set()
    for kernel_path, dead_set in dead.items():
        if not dead_set:
            continue
        entries = writer_index.get((('params',) + tuple(kernel_path), 0), [])
        if not entries:
            logging.warning(f'WW materialize: no channel space for '
                            f'{kernel_path}; skipped')
            continue
        for c in dead_set:
            hit = None
            for m, s in entries:
                if m.offset <= c < m.offset + s.width:
                    hit = (m, s)
                    break
            if hit is None:
                logging.warning(f'WW materialize: channel {c} of '
                                f'{kernel_path} outside every space; skipped')
                continue
            m, s = hit
            if s.frozen:
                frozen_hits.add(kernel_path)
                continue
            space_dead.setdefault(id(s), set()).add(c - m.offset)
    if frozen_hits:
        logging.warning(f'WW materialize: {len(frozen_hits)} pruned kernels '
                        f'live in frozen channel spaces (unsupported '
                        f'topology) and stay masked, not sliced')

    # 2) one keep-mask per (tensor path, axis), combined across all spaces
    keep: Dict[Tuple[Path, int], torch.Tensor] = {}
    by_id = {id(s): s for s in spaces}
    for sid, dead_chs in space_dead.items():
        for m in by_id[sid].members:
            if m.path not in flat:
                continue
            mask = keep.setdefault((m.path, m.axis), torch.ones(
                flat[m.path].shape[m.axis], dtype=torch.bool))
            for d in dead_chs:
                mask[m.offset + d] = False

    out = dict(state_dict)
    for (path, axis), mask in keep.items():
        if mask.all():
            continue
        tensor = out[names[path]]
        index = torch.nonzero(mask).reshape(-1).to(tensor.device)
        out[names[path]] = torch.index_select(tensor, axis, index)

    widths = {path[1:-1]: out[name].shape[0] for path, name in names.items()
              if path[0] == 'params' and path[-1] == 'kernel'
              and out[name].ndim == 4}
    return out, widths


def _stage_convs(widths, prefix: Path) -> Dict[str, Dict[str, int]]:
    """``{child name: {conv name: width}}`` of the convs under ``prefix``
    (``('features', 'base')``), one level down; a conv directly under
    ``prefix`` (VGG's ``conv3``, MobileNet's ``stage0_conv``) has the
    conv name ``''``."""
    out: Dict[str, Dict[str, int]] = {}
    for path, width in widths.items():
        if path[:len(prefix)] == prefix and len(path) in (len(prefix) + 1,
                                                          len(prefix) + 2):
            rest = path[len(prefix):]
            out.setdefault(rest[0], {})[rest[1] if len(rest) > 1 else ''] = width
    return out


def _stage_index(name: str) -> Optional[int]:
    return int(name[5:]) if name.startswith('stage') and name[5:].isdigit() else None


def _mobilenet_v2_overrides(widths):
    overrides = {}
    for name, convs in _stage_convs(widths, ('features', 'base')).items():
        stage = _stage_index(name)
        if stage is None:
            continue
        entry = {}
        for conv in ('conv', 'project_conv'):
            if conv in convs:
                entry['features'] = convs[conv]
        if 'expand_conv' in convs:
            entry['inner'] = convs['expand_conv']
        overrides[stage] = entry
    return overrides


def _mobilenet_overrides(widths):
    overrides = {}
    for name, convs in _stage_convs(widths, ('features', 'base')).items():
        if name == 'stage0_conv':
            overrides[0] = convs['']
        elif _stage_index(name) is not None and 'pointwise_conv' in convs:
            overrides[_stage_index(name)] = convs['pointwise_conv']
    return overrides


def _vgg_overrides(widths):
    return {int(name[4:]): convs[''] for name, convs in
            _stage_convs(widths, ('features', 'base')).items()
            if name.startswith('conv')}


def _resnet_overrides(widths):
    """Per-block inner widths and output width."""
    overrides = {}
    for name, convs in _stage_convs(widths, ('features', 'base')).items():
        if not name.startswith('layer'):
            continue
        entry = {conv: convs[conv] for conv in ('conv1', 'conv2')
                 if conv in convs}
        entry['out'] = convs['conv3' if 'conv3' in convs else 'conv2']
        overrides[name] = entry
    return overrides


_BACKBONE_OVERRIDES = {'MobileNetV2': _mobilenet_v2_overrides,
                       'MobileNet': _mobilenet_overrides,
                       'VGG': _vgg_overrides,
                       'ResNet': _resnet_overrides}


def _copy_modes(old: torch.nn.Module, new: torch.nn.Module) -> None:
    """The old model's per-layer modes on the narrow one: each conv's
    quantization mode (and a QAT ``act_amax`` buffer to load into), each
    BatchNorm's fused path, global statistics and GroupNorm."""
    from single_shot_detection_tpu_torch.models.layers import BatchNorm, Conv2d
    modules = dict(new.named_modules())
    for name, module in old.named_modules():
        target = modules.get(name)
        if isinstance(module, Conv2d) and isinstance(target, Conv2d):
            target.quant = module.quant
            if 'act_amax' in module._buffers:
                target.register_buffer('act_amax',
                                       torch.zeros_like(module.act_amax))
        elif isinstance(module, BatchNorm) and isinstance(target, BatchNorm):
            target.fused = module.fused
            target.sync = module.sync
            target.group_norm = module.group_norm


def materialize_bundle(bundle, state_dict: Mapping[str, torch.Tensor],
                       dead: Mapping[Path, set],
                       spaces: Optional[List[deps.Space]] = None):
    """Rebuild a physically narrow ``DetectorBundle`` from a masked model.

    Returns ``(bundle, state_dict)``: the new bundle's module holds the
    sliced ``state_dict`` (loaded with ``strict=True``) on the old module's
    device, in its layers' modes and in eval mode, ready to serve or
    export; its outputs equal the masked model's (zeroed channels
    contribute exactly nothing; see ``train/pruning.py``).
    """
    from single_shot_detection_tpu_torch.models import builder
    from single_shot_detection_tpu_torch.models.features import FeaturePyramid

    old = bundle.module
    if spaces is None:
        spaces = build_channel_spaces(old, bundle.input_size)
    new_state, widths = materialize(state_dict, dead, spaces)

    backbone = type(old.features.base).__name__
    if backbone not in _BACKBONE_OVERRIDES:
        raise NotImplementedError(f'materialize_bundle: no width-override '
                                  f'support for {backbone}')
    args = dict(bundle.build_args)
    if isinstance(old.features, FeaturePyramid):
        # the laterals share one space (the top-down adds union them); the
        # output convs are per level
        ov = {}
        if ('features', 'lateral0') in widths:
            ov['lateral'] = widths[('features', 'lateral0')]
        outs = []
        while ('features', f'output{len(outs)}', 'conv') in widths:
            outs.append(widths[('features', f'output{len(outs)}', 'conv')])
        if outs:
            ov['output'] = tuple(outs)
        if ov:
            args['features'] = {**args['features'], 'width_overrides': ov}

    extras = []
    for i in range(old.num_extras):
        entry = {}
        if (f'extra{i}', 'reduce', 'conv') in widths:
            entry['reduce'] = widths[(f'extra{i}', 'reduce', 'conv')]
        for conv in ('pointwise_conv', 'conv'):
            if (f'extra{i}', 'expand', conv) in widths:
                entry['out'] = widths[(f'extra{i}', 'expand', conv)]
                break
        extras.append(entry or None)
    new_bundle = builder.build(**args, width_overrides={
        'base': _BACKBONE_OVERRIDES[backbone](widths), 'extras': extras})
    device = next(old.parameters()).device
    _copy_modes(old, new_bundle.module)
    new_bundle.module.to(device)
    new_bundle.module.load_state_dict(new_state, strict=True)
    new_bundle.module.eval()
    return new_bundle, new_state
