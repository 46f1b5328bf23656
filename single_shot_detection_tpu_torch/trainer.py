"""Training entry point: ``Trainer``.

Port of the train half of the JAX package's ``Experiment``
(``train/engine.py``): the model, the augmentation ``Pipeline``, target
assigner, sampler, multibox loss, optimizer and learning-rate schedule built
from a ``samples/*.py`` config, and ``make_train_step`` over them.  With
``train.fused_bn`` every train-mode BatchNorm runs on the four hand-written
CUDA kernels of ``kernels/bn.cu`` (the JAX package's ``ops/bn_pallas.py``
path); without it, on PyTorch's own batch norm.

Each step draws its augmentation from a generator seeded from ``(seed,
step)``, as the JAX engine folds the global step index into its key, so a
run that starts at step ``n`` draws what an uninterrupted one draws there.

What is not ported yet raises ``NotImplementedError`` rather than being
skipped: mixup, ``frozen_bn``, EMA, QAT, gradient accumulation and
clipping, ``lr_groups``, pruning, ``fused_steps``, the YUV420 staging and
the multi-device options; an augmentation the ``Pipeline`` does not know
raises as well.

Runs on ``cuda`` unless the caller passes ``device='cpu'``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from single_shot_detection_tpu_torch.data.transforms import Pipeline, draws_to
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
    train = dict(cfg.train or {})
    for key in _UNPORTED_TRAIN_OPTIONS:
        if train.get(key):
            raise NotImplementedError(f'train.{key} is not ported yet')
    if int(train.get('fused_steps', 1)) != 1:
        raise NotImplementedError('train.fused_steps is not ported yet')
    if str(train.get('staging_colorspace', 'rgb')) != 'rgb':
        raise NotImplementedError('train.staging_colorspace is not ported yet')


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of the augmentation draws of global step ``step``."""
    mixed = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))


class Trainer:
    """A detector, its augmentation and its optimizer, ready to take train
    steps on one device.  Build it with :meth:`from_config`."""

    def __init__(self, bundle: builder.DetectorBundle, state: TrainState,
                 pipeline: Pipeline, schedule, criterion: MultiboxLoss,
                 assigner: TargetAssigner, device: torch.device, seed: int,
                 plateau: Optional[schedulers.ReduceLROnPlateau] = None,
                 scheduler_metric: Optional[str] = None):
        self.bundle = bundle
        self.state = state
        self.pipeline = pipeline
        self.schedule = schedule  # optimizer step -> learning rate
        # ReduceLROnPlateau: the engine feeds it ``scheduler_metric`` after
        # each evaluation and writes its scale into ``state.lr_scale``
        self.plateau = plateau
        self.scheduler_metric = scheduler_metric
        self.criterion = criterion
        self.assigner = assigner
        self.device = device
        self.seed = seed
        self.anchors = torch.from_numpy(bundle.anchors).to(device)
        self._train_step = make_train_step(criterion, assigner, self.anchors,
                                           schedule, pipeline)

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    @classmethod
    def from_config(cls, path: str, variables: Optional[Mapping] = None,
                    device: Optional[Union[str, torch.device]] = None,
                    seed: Optional[int] = None,
                    overrides: Optional[Mapping] = None,
                    steps_per_epoch: Optional[int] = None) -> 'Trainer':
        """Build from a ``samples/*.py`` config.

        ``variables`` and ``seed`` as in ``Predictor.from_config``; ``seed``
        also seeds the augmentation draws.  ``overrides`` sets config values
        before anything is built; a dict merges into a dict entry one level
        deep, e.g. ``{'train': {'fused_bn': True}}``.  ``steps_per_epoch``
        (the train loader's length; ``train.num_batches_per_epoch`` wins,
        and without either an epoch is one step) turns per-epoch schedule
        milestones into steps.
        """
        cfg = load_config(path, phases=('train',))
        if overrides:
            cfg.override(dict(overrides))
        return cls.from_cfg(cfg, variables, device, seed, steps_per_epoch)

    @classmethod
    def from_cfg(cls, cfg, variables: Optional[Mapping] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: Optional[int] = None,
                 steps_per_epoch: Optional[int] = None) -> 'Trainer':
        """Build from a loaded config (``utils/config.py::ConfigWrapper``)."""
        device = resolve_device(device)
        check_ported(cfg)
        seed = int(seed if seed is not None else (cfg.seed or 23))

        bundle = builder.from_config(cfg, variables, seed)
        model = bundle.module.to(device)
        train_cfg = dict(cfg.train or {})
        set_fused_bn(model, bool(train_cfg.get('fused_bn', False)))
        pipeline = Pipeline(cfg.augmentations or (), cfg.preprocessing,
                            bundle.input_size, train=True)

        sampler_cfg = dict(cfg.sampler or {'name': 'naive_sampler'})
        sampler = build_sampler(sampler_cfg.pop('name'), **sampler_cfg)
        box_coder = filter_kwargs(BoxCoder)(**(cfg.box_coder or {}))
        criterion = filter_kwargs(MultiboxLoss)(
            sampler=sampler, box_coder=box_coder, **cfg.loss)
        assigner = filter_kwargs(TargetAssigner)(**(cfg.target_assigner or {}))

        steps_per_epoch = int(train_cfg.get('num_batches_per_epoch')
                              or steps_per_epoch or 1)
        epochs = int(train_cfg.get('epochs', 1))
        accumulation = int(train_cfg.get('accumulation_steps', 1))
        cfg.update({'epochs': epochs,
                    'total_train_steps': steps_per_epoch * epochs // accumulation})
        train_cfg = dict(cfg.train)  # re-read after interpolation
        opt_cfg = dict(train_cfg.get('optimizer', {'name': 'SGD', 'lr': 1e-3}))
        schedule, plateau, metric = schedulers.create_lr_schedule(
            train_cfg.get('scheduler'), opt_cfg.get('lr', 1e-3), steps_per_epoch)
        optimizer = optimizers.create_optimizer(
            opt_cfg, model.parameters(), accumulation_steps=accumulation,
            clip_grad_norm=train_cfg.get('clip_grad_norm'))
        return cls(bundle, TrainState(model, optimizer), pipeline, schedule,
                   criterion, assigner, device, seed, plateau, metric)

    def draws(self, step: int, batch: int) -> list:
        """The augmentation draws of global step ``step`` (on the CPU)."""
        return self.pipeline.sample_draws(step_generator(self.seed, step), batch)

    def train_step(self, images: Union[np.ndarray, torch.Tensor],
                   boxes: Union[np.ndarray, torch.Tensor],
                   box_mask: Union[np.ndarray, torch.Tensor],
                   step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """One step on staged uint8 ``[B, S, S, 3]`` images, ground truth
        ``boxes [B, G, R>=6]`` (``[x0, y0, x1, y1, class, score, ...]`` in
        staged pixels) and ``box_mask [B, G]``, augmented with the draws of
        global step ``step`` (default: the optimizer's step count).
        Returns ``{'loss', 'class_loss', 'loc_loss'}`` as 0-dim tensors on
        the device."""
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        boxes = torch.as_tensor(boxes, dtype=torch.float32).to(self.device)
        box_mask = torch.as_tensor(box_mask, dtype=torch.bool).to(self.device)
        step = self.state.step if step is None else step
        draws = draws_to(self.draws(step, images.shape[0]), self.device)
        return self._train_step(self.state, images, boxes, box_mask, draws)
