"""Training entry point: ``Trainer``.

Port of the train half of the JAX package's ``Experiment``
(``train/engine.py``): the model, target assigner, sampler, multibox loss,
optimizer and learning-rate schedule built from a ``samples/*.py`` config,
and ``make_train_step`` over them.  With ``train.fused_bn`` every train-mode
BatchNorm runs on the four hand-written CUDA kernels of ``kernels/bn.cu``
(the JAX package's ``ops/bn_pallas.py`` path); without it, on PyTorch's own
batch norm.

What is not ported yet raises ``NotImplementedError`` rather than being
skipped: augmentations (the on-device augmentation chain belongs to the
data-path slice; pass ``overrides={'augmentations': []}``), mixup,
``frozen_bn``, EMA, QAT, gradient accumulation and clipping, ``lr_groups``,
pruning, ``fused_steps`` and the multi-device options.

Runs on ``cuda`` unless the caller passes ``device='cpu'``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from single_shot_detection_tpu_torch.data.preprocess import Preprocess
from single_shot_detection_tpu_torch.device import resolve_device
from single_shot_detection_tpu_torch.models import builder
from single_shot_detection_tpu_torch.models.layers import set_fused_bn
from single_shot_detection_tpu_torch.ops.box_coder import BoxCoder
from single_shot_detection_tpu_torch.ops.losses import MultiboxLoss
from single_shot_detection_tpu_torch.ops.matching import TargetAssigner
from single_shot_detection_tpu_torch.ops.sampling import build_sampler
from single_shot_detection_tpu_torch.train import optimizers, schedulers
from single_shot_detection_tpu_torch.train.state import TrainState
from single_shot_detection_tpu_torch.train.step import make_train_step
from single_shot_detection_tpu_torch.utils.config import load_config
from single_shot_detection_tpu_torch.utils.misc import filter_kwargs

# train options of the JAX engine not ported yet: each raises when set
_UNPORTED_TRAIN_OPTIONS = ('mixup', 'frozen_bn', 'ema', 'qat', 'pruner',
                           'group_norm', 'clip_grad_norm', 'tensor_sharding',
                           'spatial_sharding', 'pipeline_sharding',
                           'zero_sharding')


def check_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    for spec in cfg.augmentations or ():
        raise NotImplementedError(
            f'augmentation {spec["name"]!r} is not ported yet: the on-device '
            f'augmentation chain belongs to the data-path slice (ROADMAP '
            f"Queue 1 item 7); pass overrides={{'augmentations': []}}")
    train = dict(cfg.train or {})
    for key in _UNPORTED_TRAIN_OPTIONS:
        if train.get(key):
            raise NotImplementedError(f'train.{key} is not ported yet')
    if int(train.get('fused_steps', 1)) != 1:
        raise NotImplementedError('train.fused_steps is not ported yet')
    if str(train.get('staging_colorspace', 'rgb')) != 'rgb':
        raise NotImplementedError('train.staging_colorspace is not ported yet')


class Trainer:
    """A detector and its optimizer, ready to take train steps on one
    device.  Build it with :meth:`from_config`."""

    def __init__(self, bundle: builder.DetectorBundle, state: TrainState,
                 train_step, device: torch.device):
        self.bundle = bundle
        self.state = state
        self.device = device
        self._train_step = train_step

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    @classmethod
    def from_config(cls, path: str, variables: Optional[Mapping] = None,
                    device: Optional[Union[str, torch.device]] = None,
                    seed: Optional[int] = None,
                    overrides: Optional[Mapping] = None) -> 'Trainer':
        """Build from a ``samples/*.py`` config.

        ``variables`` and ``seed`` as in ``Predictor.from_config``.
        ``overrides`` sets config values before anything is built; a dict
        merges into a dict entry one level deep, e.g.
        ``{'augmentations': [], 'train': {'fused_bn': True}}``.
        """
        device = resolve_device(device)
        cfg = load_config(path, phases=('train',))
        if overrides:
            cfg.override(dict(overrides))
        check_ported(cfg)

        bundle = builder.from_config(cfg, variables, seed)
        model = bundle.module.to(device)
        train_cfg = dict(cfg.train or {})
        set_fused_bn(model, bool(train_cfg.get('fused_bn', False)))

        sampler_cfg = dict(cfg.sampler or {'name': 'naive_sampler'})
        sampler = build_sampler(sampler_cfg.pop('name'), **sampler_cfg)
        box_coder = filter_kwargs(BoxCoder)(**(cfg.box_coder or {}))
        criterion = filter_kwargs(MultiboxLoss)(
            sampler=sampler, box_coder=box_coder, **cfg.loss)
        assigner = filter_kwargs(TargetAssigner)(**(cfg.target_assigner or {}))

        # without a data loader the engine counts one step per epoch
        steps_per_epoch = int(train_cfg.get('num_batches_per_epoch') or 1)
        epochs = int(train_cfg.get('epochs', 1))
        accumulation = int(train_cfg.get('accumulation_steps', 1))
        cfg.update({'epochs': epochs,
                    'total_train_steps': steps_per_epoch * epochs // accumulation})
        train_cfg = dict(cfg.train)  # re-read after interpolation
        opt_cfg = dict(train_cfg.get('optimizer', {'name': 'SGD', 'lr': 1e-3}))
        schedule = schedulers.create_lr_schedule(
            train_cfg.get('scheduler'), opt_cfg.get('lr', 1e-3), steps_per_epoch)
        optimizer = optimizers.create_optimizer(
            opt_cfg, model.parameters(), accumulation_steps=accumulation,
            clip_grad_norm=train_cfg.get('clip_grad_norm'))

        anchors = torch.from_numpy(bundle.anchors).to(device)
        preprocess = Preprocess(cfg.preprocessing, bundle.input_size)
        train_step = make_train_step(criterion, assigner, anchors, schedule,
                                     preprocess)
        return cls(bundle, TrainState(model, optimizer), train_step, device)

    def train_step(self, images: Union[np.ndarray, torch.Tensor],
                   boxes: Union[np.ndarray, torch.Tensor],
                   box_mask: Union[np.ndarray, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One step on staged uint8 ``[B, S, S, 3]`` images, ground truth
        ``boxes [B, G, 6]`` (``[x0, y0, x1, y1, class, score]`` in staged
        pixels) and ``box_mask [B, G]``.  Returns ``{'loss', 'class_loss',
        'loc_loss'}`` as 0-dim tensors on the device."""
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        boxes = torch.as_tensor(boxes, dtype=torch.float32).to(self.device)
        box_mask = torch.as_tensor(box_mask, dtype=torch.bool).to(self.device)
        return self._train_step(self.state, images, boxes, box_mask)
