"""Training entry point: ``Trainer``.

Port of the train half of the JAX package's ``Experiment``
(``train/engine.py``): the model, the augmentation ``Pipeline``, target
assigner, sampler, multibox loss, optimizer and learning-rate schedule built
from a ``samples/*.py`` config, and ``make_train_step`` over them.  With
``train.fused_bn`` every train-mode BatchNorm runs on the four hand-written
CUDA kernels of ``kernels/bn.cu`` (the JAX package's ``ops/bn_pallas.py``
path); without it, on PyTorch's own batch norm.  ``train.group_norm``
(``True`` for 8 groups, a count, or ``{'groups': g}``) makes every
BatchNorm a GroupNorm over its own parameters (``models/norm.py``), in the
train step and the evaluation alike; it does not compose with
``fused_bn``.

Each step draws its augmentation from a generator seeded from ``(seed,
step)``, as the JAX engine folds the global step index into its key, so a
run that starts at step ``n`` draws what an uninterrupted one draws there.

``train.qat`` (``True``, a decay, or ``{'decay', 'spatial_limit'}``)
trains with every dense conv's weight and input fake-quantized to int8
(``export/quantize.py``), each conv's activation scale an EMA buffer
``act_amax`` updated in the train forward; it does not compose with
``fused_bn`` or ``group_norm``.

``train.pruner`` gives the state its pruning mask (``TrainState.mask``,
the JAX package's ``masked`` optimizer wrapper), which each step applies;
``train/engine.py::Experiment`` builds the ``Pruner`` that fills it
(``train/pruning.py``).  It composes with ``fused_bn``.

The rest of the JAX engine's train options (``train/optimizers.py``,
``train/step.py``): ``optimizer`` (the ten rules, ``lr_groups``),
``clip_grad_norm``, ``accumulation_steps`` (the schedule counts updates:
``total_train_steps`` and the steps per epoch are divided by it), ``ema``
(a decay or ``{'decay'}``: the shadow ``state.ema_params``, a copy of the
parameters at the start, evaluated and served as ``eval_model``), ``mixup``
(``{'alpha', 'p'}``, drawn from the step's generator after the
augmentation), ``frozen_bn`` (every BatchNorm in eval mode inside the
step; with ``group_norm`` it raises) and ``fused_steps`` (k steps in one
host call, :meth:`Trainer.fused_train_step`).

``train.staging_colorspace='yuv420'`` gives the ``Pipeline``
``staging_yuv``: a step then also takes packed YUV420 ``[B, S*S*3/2]``
images (``data/loader.py``) and turns them back into RGB on the device.

``process_count`` > 1 (``parallel/mesh.py``; one process a card, in a
``torch.distributed`` group the caller has joined) makes the step the JAX
engine's data-parallel step over the global batch of every rank's ``b``
rows: global BN statistics (``models/layers.py::BatchNorm.sync``; with
``train.fused_bn`` the JAX engine's warning, and these), the global
positive count as the loss's divider, the gradients summed over the ranks
before the optimizer, QAT's activation maximum over the global batch, and
the augmentation and mixup draws of the global batch of the step, of which
rank ``i`` takes rows ``[i * b, (i + 1) * b)`` (mixup pairs rows across
ranks).  ``train.zero_sharding`` then slices the optimizer's buffers and
the EMA update over the ranks (ZeRO-1, ``parallel.zero_state_sharding``);
with one process it changes nothing, as in the JAX engine.

The model axis (``parallel/``; one of ``train.tensor_sharding: m``,
``train.spatial_sharding: m``, ``train.pipeline_sharding: M`` or
``{'microbatches': M, 'stages': S}``) runs over the processes: with ``W``
of them and a model-axis size ``m``, rank ``r`` is model rank ``r % m`` of
data rank ``r // m`` (the JAX package's ``create_mesh`` order).
``batch_size`` is one model group's batch, so the global batch is
``batch_size * W / m`` (with ``W = m`` the JAX engine's one-process global
batch); the ranks of a model group draw the same augmentation of the same
rows.  Tensor sharding slices each ``cout``-divisible leaf (the
optimizer's buffers, the EMA shadow and the mask follow, ZeRO-1 then
slicing a remaining axis over the data axis), its BN statistics and
gradients reducing over the data axis; pipeline sharding runs the GPipe
forward in eval mode (``frozen_bn`` or ``group_norm``), its gradients
summed over the world; spatial sharding slices image heights, its BN
statistics and gradients reducing over the world.  :func:`check_ported`
raises the JAX engine's ``ValueError``s; an augmentation the ``Pipeline``
does not know raises too.

``bf16=True`` runs the activations in bfloat16 under docs/DESIGN.md §10's
policy (parameters, BN statistics, the optimizer's buffers, the EMA
shadow and the losses stay f32;
``fused_bn`` then runs the BN kernels on bf16 activations), and
``matmul_precision`` sets the convolutions' and matmuls' precision
(``device.py::numeric_policy``); each step runs under the trainer's own
flags.

Runs on ``cuda`` unless the caller passes ``device='cpu'``.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from single_shot_detection_tpu_torch import parallel
from single_shot_detection_tpu_torch.parallel import tensor
from single_shot_detection_tpu_torch.data.transforms import Pipeline, draws_to
from single_shot_detection_tpu_torch.device import (NumericPolicy,
                                                    numeric_policy,
                                                    resolve_device)
from single_shot_detection_tpu_torch.export import quantize
from single_shot_detection_tpu_torch.models import builder, norm
from single_shot_detection_tpu_torch.models.layers import (set_fused_bn,
                                                           set_group_norm,
                                                           set_sync_bn)
from single_shot_detection_tpu_torch.ops.box_coder import BoxCoder
from single_shot_detection_tpu_torch.ops.losses import MultiboxLoss
from single_shot_detection_tpu_torch.ops.matching import TargetAssigner
from single_shot_detection_tpu_torch.ops.sampling import build_sampler
from single_shot_detection_tpu_torch.train import optimizers, schedulers
from single_shot_detection_tpu_torch.train.state import (TrainState,
                                                         gather_shadow,
                                                         shadow_module)
from single_shot_detection_tpu_torch.train.step import (make_fused_train_step,
                                                        make_train_step,
                                                        sample_mixup)
from single_shot_detection_tpu_torch.utils.config import load_config
from single_shot_detection_tpu_torch.utils.misc import filter_kwargs

# the JAX engine's warning when train.fused_bn meets several devices
FUSED_BN_MULTI_DEVICE_WARNING = (
    'WW train.fused_bn is single-device only (pallas has no GSPMD '
    'partitioning rule); keeping flax BN')


def _model_axis_owners(train: Mapping) -> list:
    """The ``train`` options that would partition the model axis, as the
    JAX engine counts them: ``tensor_sharding`` or ``spatial_sharding``
    above 1, ``pipeline_sharding`` with microbatches."""
    owners = [key for key in ('tensor_sharding', 'spatial_sharding')
              if int(train.get(key) or 1) > 1]
    pipeline = train.get('pipeline_sharding')
    micro = (int(pipeline.get('microbatches', 2)) if isinstance(pipeline, dict)
             else int(pipeline or 0))
    if micro > 0:
        owners.append('pipeline_sharding')
    return owners


def model_axis_options(train: Mapping) -> Tuple[Optional[str], int, int]:
    """``(mode, model-axis size, microbatches)`` of the ``train`` options:
    ``('tensor', m, 0)``, ``('spatial', m, 0)``, ``('pipeline', S, M)``
    (S stages, 2 by default) or ``(None, 1, 0)``; two owners raise the
    JAX engine's ``ValueError``."""
    owners = _model_axis_owners(train)
    if len(owners) > 1:
        raise ValueError(
            'train.tensor_sharding / spatial_sharding / pipeline_sharding '
            'all partition the model axis — enable at most one')
    if not owners:
        return None, 1, 0
    if owners[0] == 'pipeline_sharding':
        pipeline = train['pipeline_sharding']
        if isinstance(pipeline, dict):
            return ('pipeline', int(pipeline.get('stages', 2)),
                    int(pipeline.get('microbatches', 2)))
        return 'pipeline', 2, int(pipeline)
    key = owners[0]
    return key.split('_')[0], int(train[key]), 0


def check_ported(cfg, process_count: int = 1) -> None:
    """The JAX engine's checks of the model axis, as ``ValueError``s:
    at most one owner; processes take the place of its devices, so fewer
    processes than the axis, or a count it does not divide, has no grid
    (``parallel.check_model_axis``; the JAX engine shrinks its data axis
    instead); spatial sharding with YUV420 staging or a staged height it
    does not divide; pipeline sharding with QAT, without ``frozen_bn`` or
    ``group_norm``, or with microbatches that do not divide the batch
    (``batch_size``, one model group's)."""
    train = dict(cfg.train or {})
    mode, size, micro = model_axis_options(train)
    if mode is None:
        return
    parallel.check_model_axis(size, process_count)
    if mode == 'spatial':
        if str(train.get('staging_colorspace', 'rgb')) == 'yuv420':
            raise ValueError(
                'train.spatial_sharding cannot shard packed YUV420 staging '
                'buffers (plane boundaries); use rgb staging')
        staged_h = tuple(train.get('staging_size', cfg.input_size))[1]
        if staged_h % size:
            raise ValueError(
                f'train.spatial_sharding={size} must divide the staged '
                f'image height ({staged_h})')
    if mode == 'pipeline':
        if quantize.qat_options(train.get('qat')) is not None:
            raise ValueError(
                'train.pipeline_sharding does not compose with train.qat '
                '(activation scales mutate in-forward)')
        if not (train.get('frozen_bn')
                or norm.groups_from_config(train.get('group_norm'))):
            raise ValueError(
                'train.pipeline_sharding trains with a non-mutating forward '
                '(batch statistics cannot update inside the scanned, staged '
                'program) — set train.frozen_bn (the fine-tune recipe) or '
                'train.group_norm')
        batch = int(cfg.batch_size or 32)
        if batch % micro:
            raise ValueError(
                f'train.pipeline_sharding={micro} microbatches must divide '
                f'the per-device batch ({batch})')


def staging_yuv(cfg) -> Optional[Tuple[int, int]]:
    """The staging (w, h) when ``train.staging_colorspace`` is ``'yuv420'``
    (the ``Pipeline``'s ``staging_yuv``), else None."""
    train = dict(cfg.train or {})
    if str(train.get('staging_colorspace', 'rgb')) != 'yuv420':
        return None
    return tuple(train.get('staging_size', cfg.input_size))


def ema_from_config(value) -> Optional[float]:
    """``train.ema``: a decay or ``{'decay': d}``; None when off."""
    if isinstance(value, dict):
        return float(value['decay'])
    return float(value) if value else None


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of the augmentation draws of global step ``step``."""
    mixed = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))


def draw_rows(draws, rows: slice):
    """The draws of rows ``rows`` of a batch: every tensor leaf of a draws
    tree leads with the batch axis."""
    if isinstance(draws, torch.Tensor):
        return draws[rows]
    if isinstance(draws, dict):
        return {k: draw_rows(v, rows) for k, v in draws.items()}
    return [draw_rows(v, rows) for v in draws]


class Trainer:
    """A detector, its augmentation and its optimizer, ready to take train
    steps on one device.  Build it with :meth:`from_config`."""

    def __init__(self, bundle: builder.DetectorBundle, state: TrainState,
                 pipeline: Pipeline, schedule, criterion: MultiboxLoss,
                 assigner: TargetAssigner, device: torch.device, seed: int,
                 policy: NumericPolicy,
                 plateau: Optional[schedulers.ReduceLROnPlateau] = None,
                 scheduler_metric: Optional[str] = None,
                 ema: Optional[float] = None, mixup: Optional[dict] = None,
                 frozen_bn: bool = False, fused_steps: int = 1,
                 process_count: int = 1, process_index: int = 0,
                 tensor_axes: Optional[Dict[str, Optional[int]]] = None,
                 microbatches: int = 0):
        self.bundle = bundle
        self.policy = policy
        self.state = state
        self.pipeline = pipeline
        self.schedule = schedule  # optimizer update count -> learning rate
        # ReduceLROnPlateau: the engine feeds it ``scheduler_metric`` after
        # each evaluation and writes its scale into ``state.lr_scale``
        self.plateau = plateau
        self.scheduler_metric = scheduler_metric
        self.criterion = criterion
        self.assigner = assigner
        self.device = device
        self.seed = seed
        self.anchors = torch.from_numpy(bundle.anchors).to(device)
        self.ema = ema
        self.mixup = dict(mixup) if mixup else None
        self.frozen_bn = frozen_bn
        self.fused_steps = int(fused_steps)
        self.process_count = int(process_count)
        self.process_index = int(process_index)
        # the data axis: the world without a model axis
        self.data_count = parallel.data_count()
        self.data_index = parallel.data_index()
        # tensor sharding's placement, applied by shard_model_axis
        self.tensor_axes = tensor_axes
        self._shadow = None
        if ema is not None:
            self._shadow = shadow_module(state.model)
            state.ema_params = dict(self._shadow.named_parameters())
        self._train_step = make_train_step(
            criterion, assigner, self.anchors, schedule, pipeline, ema,
            frozen_bn, self.data_index,
            'world' if parallel.model_mode() in ('spatial', 'pipeline')
            else 'data',
            microbatches)
        self._fused_train_step = make_fused_train_step(self._train_step,
                                                       self.fused_steps)

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    @property
    def eval_model(self) -> torch.nn.Module:
        """What evaluation and serving run: under ``train.ema`` the shadow
        (a copy of the model whose parameters are ``state.ema_params`` and
        whose buffers are the model's own), else the model."""
        return self.state.model if self._shadow is None else self._shadow

    @classmethod
    def from_config(cls, path: str, variables: Optional[Mapping] = None,
                    device: Optional[Union[str, torch.device]] = None,
                    seed: Optional[int] = None,
                    overrides: Optional[Mapping] = None,
                    steps_per_epoch: Optional[int] = None,
                    bf16: bool = False,
                    matmul_precision: Optional[str] = None,
                    process_count: int = 1,
                    process_index: int = 0,
                    shard: bool = True) -> 'Trainer':
        """Build from a ``samples/*.py`` config.

        ``variables`` and ``seed`` as in ``Predictor.from_config``; ``seed``
        also seeds the augmentation draws.  ``overrides`` sets config values
        before anything is built; a dict merges into a dict entry one level
        deep, e.g. ``{'train': {'fused_bn': True}}``.  ``steps_per_epoch``
        (the train loader's length; ``train.num_batches_per_epoch`` wins,
        and without either an epoch is one step) turns per-epoch schedule
        milestones into steps.  ``bf16`` and ``matmul_precision`` as
        ``device.py::numeric_policy`` takes them.  ``process_count`` and
        ``process_index``: this rank of a run of several processes (the
        class doc); its process group must be joined.  ``shard=False``
        leaves a tensor-sharded state whole until
        :meth:`shard_model_axis` (weights loaded in between are whole).
        """
        cfg = load_config(path, phases=('train',))
        if overrides:
            cfg.override(dict(overrides))
        return cls.from_cfg(cfg, variables, device, seed, steps_per_epoch,
                            bf16, matmul_precision, process_count,
                            process_index, shard)

    @classmethod
    def from_cfg(cls, cfg, variables: Optional[Mapping] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: Optional[int] = None,
                 steps_per_epoch: Optional[int] = None,
                 bf16: bool = False,
                 matmul_precision: Optional[str] = None,
                 process_count: int = 1,
                 process_index: int = 0,
                 shard: bool = True) -> 'Trainer':
        """Build from a loaded config (``utils/config.py::ConfigWrapper``)."""
        device = resolve_device(device)
        check_ported(cfg, process_count)
        parallel.check_group(process_count, process_index)
        seed = int(seed if seed is not None else (cfg.seed or 23))

        train_cfg = dict(cfg.train or {})
        mode, axis_size, microbatches = model_axis_options(train_cfg)
        parallel.set_model_axis(mode, axis_size)
        data_count, data_index = parallel.data_count(), parallel.data_index()
        policy = numeric_policy(bf16, matmul_precision, train_cfg)
        groups = norm.groups_from_config(train_cfg.get('group_norm'))
        if groups is not None and train_cfg.get('fused_bn'):
            raise ValueError('train.fused_bn does not compose with '
                             'train.group_norm (both replace the BatchNorm '
                             'forward)')
        if groups is not None and train_cfg.get('frozen_bn'):
            raise ValueError('train.group_norm replaces BatchNorm entirely: '
                             'train.frozen_bn is meaningless with it')
        quantize.check_composes(train_cfg)
        bundle = builder.from_config(cfg, variables, seed, policy.dtype)
        model = bundle.module.to(device)
        fused_bn = bool(train_cfg.get('fused_bn', False))
        if fused_bn and process_count > 1:
            logging.warning(FUSED_BN_MULTI_DEVICE_WARNING)
            fused_bn = False
        set_fused_bn(model, fused_bn)
        set_sync_bn(model, process_count > 1)
        set_group_norm(model, groups)
        pipeline = Pipeline(cfg.augmentations or (), cfg.preprocessing,
                            bundle.input_size, train=True,
                            staging_yuv=staging_yuv(cfg))

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
        # the schedule counts optimizer updates
        schedule, plateau, metric = schedulers.create_lr_schedule(
            train_cfg.get('scheduler'), opt_cfg.get('lr', 1e-3),
            steps_per_epoch // accumulation if accumulation > 1
            else steps_per_epoch)
        optimizer = optimizers.create_optimizer(
            opt_cfg, model.named_parameters(), accumulation_steps=accumulation,
            clip_grad_norm=train_cfg.get('clip_grad_norm'))
        # train.pruner: the masked optimizer, its mask all ones until the
        # first prune
        mask = {} if train_cfg.get('pruner') else None
        state = TrainState(model, optimizer, mask=mask)
        tensor_axes = (parallel.tensor_state_sharding(
            model.state_dict().items(), axis_size) if mode == 'tensor'
            else None)
        if train_cfg.get('zero_sharding') and data_count > 1:
            named = list(model.named_parameters())
            state.zero = parallel.ZeroLayout(
                parallel.zero_state_sharding(named, data_count, tensor_axes),
                data_count, data_index)
            optimizer.shard(state.zero, named)
            sliced = sum(axis is not None for axis in state.zero.axes.values())
            logging.info(f'II ZeRO-1 sharding: {sliced} optimizer/EMA '
                         f'leaves sharded over {data_count} data-axis '
                         'processes')
        trainer = cls(bundle, state, pipeline,
                      schedule, criterion, assigner, device, seed, policy,
                      plateau, metric, ema_from_config(train_cfg.get('ema')),
                      train_cfg.get('mixup'), bool(train_cfg.get('frozen_bn')),
                      int(train_cfg.get('fused_steps', 1)), process_count,
                      process_index, tensor_axes, microbatches)
        if mode == 'pipeline':
            logging.info(
                f'II pipeline parallelism: {axis_size} stages x '
                f'{microbatches} microbatches (bubble fraction '
                f'{(axis_size - 1) / (microbatches + axis_size - 1):.0%})')
        if shard:
            trainer.shard_model_axis()
        return trainer

    def shard_model_axis(self) -> None:
        """Under tensor sharding, cut the whole state to this rank's model
        slices (``parallel/tensor.py::shard_state_``; once, after the
        weights to start from are loaded); nothing otherwise."""
        if self.tensor_axes is None or self.state.tensor is not None:
            return
        count = tensor.shard_state_(self.state, self.tensor_axes)
        self.state.tensor = self.tensor_axes
        self.state.optimizer.shard_model(
            p for n, p in self.model.named_parameters()
            if self.tensor_axes.get(n) is not None)
        logging.info(f'II tensor sharding: {count} leaves sharded over '
                     f'{parallel.axis_size("model")} model-axis processes'
                     + (' (+ZeRO-1 over data)' if self.state.zero else ''))

    def draws(self, step: int, batch: int) -> list:
        """The augmentation draws of global step ``step`` (on the CPU)."""
        return self.step_draws(step, batch)[0]

    def step_draws(self, step: int, batch: int):
        """``(augmentation draws, mixup draws or None)`` of global step
        ``step``, on the CPU: both from the step's generator, the mixup's
        after the augmentation's.  With several processes the draws are
        the global batch's (``batch`` rows a rank): this rank's rows of the
        augmentation draws, and the mixup draws whole.  With a model axis
        the global batch is the data axis's (``batch`` rows a model group),
        and the ranks of a model group take the same rows."""
        generator = step_generator(self.seed, step)
        total = batch * self.data_count
        draws = self.pipeline.sample_draws(generator, total)
        mixup = None
        if self.mixup is not None:
            mixup = sample_mixup(generator, total, float(self.mixup['alpha']),
                                 float(self.mixup['p']))
        if self.data_count > 1:
            draws = draw_rows(draws, slice(self.data_index * batch,
                                           (self.data_index + 1) * batch))
        return draws, mixup

    def gather_shadow(self) -> None:
        """Under ZeRO-1 with EMA, make the shadow (``eval_model``'s
        parameters) whole from every rank's slice: a collective every rank
        must enter before the shadow is evaluated, served or saved."""
        gather_shadow(self.state)

    def _device_batch(self, images, boxes, box_mask, step: int):
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        boxes = torch.as_tensor(boxes, dtype=torch.float32).to(self.device)
        box_mask = torch.as_tensor(box_mask, dtype=torch.bool).to(self.device)
        draws, mixup = self.step_draws(step, images.shape[0])
        if mixup is not None:
            mixup = {k: v.to(self.device) for k, v in mixup.items()}
        return (images, boxes, box_mask), (draws_to(draws, self.device), mixup)

    def train_step(self, images: Union[np.ndarray, torch.Tensor],
                   boxes: Union[np.ndarray, torch.Tensor],
                   box_mask: Union[np.ndarray, torch.Tensor],
                   step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """One step on staged uint8 ``[B, S, S, 3]`` images, ground truth
        ``boxes [B, G, R>=6]`` (``[x0, y0, x1, y1, class, score, ...]`` in
        staged pixels) and ``box_mask [B, G]``, augmented (and mixed, with
        ``train.mixup``) with the draws of global step ``step`` (default:
        the state's step count).  Returns ``{'loss', 'class_loss',
        'loc_loss'}`` as 0-dim tensors on the device."""
        step = self.state.step if step is None else step
        batch, draws = self._device_batch(images, boxes, box_mask, step)
        with self.policy.scope():
            return self._train_step(self.state, *batch, *draws)

    def fused_train_step(self, batches: Sequence, step: Optional[int] = None
                         ) -> Dict[str, torch.Tensor]:
        """``train.fused_steps`` k steps in one call on k ``(images, boxes,
        box_mask)`` batches, the i-th with the draws of global step ``step
        + i``; returns the metrics summed over the k steps."""
        step = self.state.step if step is None else step
        moved = [self._device_batch(*batch, step + i)
                 for i, batch in enumerate(batches)]
        with self.policy.scope():
            return self._fused_train_step(self.state, [b for b, _ in moved],
                                          [d for _, d in moved])
