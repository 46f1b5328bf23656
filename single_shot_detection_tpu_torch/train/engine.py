"""``Experiment``: a config's datasets, loaders, model and steps, run as the
``train`` and ``eval`` phases on one device, or as one rank of a run of
several processes.

Port of the JAX package's ``train/engine.py::Experiment``:
datasets and loaders from the config, the train ``Trainer`` (augmentation
``Pipeline``, model, loss, optimizer and schedule, with milestones counted
in epochs of the train loader), the eval pipeline and the config-exact
postprocessor, and the training loop: weights at start (``model.base.weight``
for any registry backbone, ``model.detector.weight``, a resumed checkpoint;
a warning when a restored checkpoint's BN statistics all sit at 0/1, the
mark of a ``train.group_norm`` run, and the config does not set it), the
epochs with an evaluation every ``eval_every`` and a
checkpoint every ``save_every`` (default ``eval_every``), ``log.csv``
rewritten each epoch, ``ReduceLROnPlateau`` fed after each evaluation, and
an emergency checkpoint on ``KeyboardInterrupt`` or SIGTERM.  ``evaluate``
gives the loss, VOC mAP and, for other datasets, the COCO sweep.

Unlike the JAX engine, a resumed run keeps the earlier epochs' rows of the
``log.csv`` it resumes in.  Left out: the JAX engine's retry of an epoch
after a transient device failure; a failed step raises.

``train.transfer_ahead`` (default 2, as in the JAX engine; 0 copies
inline) copies the next batches to the device ahead of the step that takes
them (:func:`prefetch_to_device`).  ``int8=True`` evaluates with the
calibrated convs in int8 (``export/quantize.py``), calibrated on eval
batches and again whenever training has advanced, or with the scales a
``train.qat`` run learned; the JAX package's serving gate may refuse it,
and ``evaluate()`` then reports ``int8: 0.0``.

``train.pruner`` (``criterion``, default ``MinL1Norm``; ``include_paths``,
``num``, ``observe_every``) prunes channels at the start of every epoch,
the first and a resumed one included, with the channel spaces of the
traced graph (``train/deps.py``, ``train/pruning.py``); data-dependent
criteria are fed every ``observe_every`` steps of an epoch (activation
means on the eval preprocessing of the step's batch, or the step's
gradients), and :meth:`Experiment.materialize_pruned` rebuilds the
physically narrow model (``train/materialize.py``), which the export
phase exports.  As in the JAX package, ``Pruner.dead`` is not
checkpointed: a resumed run starts with an empty dead set (the mask in the
checkpoint keeps the pruned channels at 0).

``train.ema`` keeps the shadow (``Trainer.eval_model``, whose parameters
are ``state.ema_params`` and whose buffers are the model's): a copy of the
parameters once the weights are loaded (``model.base.weight``), the file's
shadow on a resume or ``load_weights`` (a copy of the file's parameters
when it has none), and what :meth:`Experiment.evaluate`, the int8
calibration, :meth:`Experiment.predictor`, :meth:`Experiment.predict`,
the export and :meth:`Experiment.materialize_pruned` run, as the JAX
engine's ``_eval_params`` serves them.  ``train.fused_steps`` k runs
each k batches of an epoch in one ``Trainer.fused_train_step`` call and a
remainder shorter than k unfused; with ``TaylorExpansion`` pruning, which
needs each step's gradients, it falls back to 1 with a warning.

The data path's options: ``train.staging_colorspace='yuv420'`` and
``train.staging_cache`` (``data/loader.py``, ``data/cache.py``),
``train.device_cache`` (``True`` or ``{'max_bytes': n}``, 4 GiB by
default: the first epoch streams and keeps its rows, every later epoch
gathers its batches on the device, ``data/device_cache.py``, the same batch
stream bit for bit) and the eval replay cache (``eval.device_cache``,
which defaults to ``train.device_cache``: the first evaluation's batches
on the device are kept and every later evaluation replays them, within
what the budget leaves after the train cache; over it, a warning and
streaming).  ``train.async_checkpoint`` writes the scheduled checkpoints
on a background thread (``train/checkpoint.py::AsyncSaver``), waited for
before an emergency save and before :meth:`Experiment.train` returns.
``tensorboard=True`` writes ``train/{k}`` and ``eval/{k}`` scalars per
epoch into ``checkpoint_dir`` (``torch.utils.tensorboard``; without the
``tensorboard`` package a warning, and the run goes on).

The weights to start from, each over the one before (as the JAX engine
takes them): ``model.base.weight``, a torchvision ``state_dict``
(``utils/torch_import.py``) or a keras ``.h5`` (``utils/keras_import.py``),
which a ``torchhub://repo:model`` backbone finds offline in a torch-hub
cache (``models/builder.py::resolve_torchhub``); the reference's whole
detector, ``model.detector.torch_weight``; ``model.detector.weight``;
``resume_from``.

``process_count`` > 1 runs this experiment as rank ``process_index`` of a
data-parallel run (``parallel/mesh.py``; the caller joins the process
group first, the CLI does it for ``--num-processes``): one card a process
(``cuda:{process_index % cards}``), the loaders' per-process shards (the
staging cache in a ``p{index}`` subdirectory, the device cache's row
block, no eval replay cache), the global-batch train step of
``trainer.py``, and an evaluation in which each rank runs the NMS kernel
on its own rows and every rank gathers every rank's detections, so every
rank computes the same mAP and the same plateau decision.  Only process
0 writes checkpoints, ``log.csv``, tensorboard scalars and progress
lines; the gather a save needs (ZeRO-1) runs on every rank before that
gate, and ``train.async_checkpoint`` turns into synchronous saves, with
the JAX engine's warning.  ``batch_size`` is each process's batch, as in
the JAX engine's multi-host runs: the global batch is ``process_count``
times it.  int8 calibration takes each conv's maximum over every rank's
calibration batches.

With a model axis (``train.tensor_sharding``, ``spatial_sharding`` or
``pipeline_sharding``; ``trainer.py``) ``batch_size`` is one model
group's batch and the global batch ``batch_size * process_count / m``:
the loaders shard over the data axis (the ranks of a model group load the
same rows), a tensor-sharded state is cut after the weights to start
from are loaded and gathered whole for each save, and the evaluation
runs on the sharded model (the NMS kernel on every rank), its rows
gathered over the data axis.  What serves one whole model (the int8
evaluation and its calibration, :meth:`Experiment.predictor`,
:meth:`Experiment.predict`, the export and
:meth:`Experiment.materialize_pruned`) runs :meth:`Experiment.whole_model`
under ``parallel.model_axis_off()``: the evaluation model whole on every
rank (under tensor sharding gathered over the model group, once per train
step reached; spatial and pipeline sharding hold whole parameters), so a
sharded run serves, calibrates and exports what one process does from the
same state.  The int8 evaluation's ranks each take their data-axis rows
and gather their detections over the data axis, as the float one's do.
``train.pruner`` runs under every option: its channel spaces are traced
before the state is sliced, the pruner scores and picks on whole
parameters (``train/pruning.py``), and the activation means of
``MeanActivation`` come from the whole model's forward.

``bf16`` runs the activations in bfloat16 (docs/DESIGN.md §10: parameters, BN
statistics, SGD momentum and losses stay f32, so checkpoints are f32 and a
bf16 run resumes an f32 one and the reverse) and ``matmul_precision`` sets
the precision of the convolutions and matmuls, resolved as the JAX engine
resolves it (``device.py::numeric_policy``).

Runs on ``cuda`` unless the caller passes ``device='cpu'``.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import itertools
import logging
import os
import queue
import signal
import threading
import time
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from single_shot_detection_tpu_torch import parallel
from single_shot_detection_tpu_torch.data.datasets import DATASETS
from single_shot_detection_tpu_torch.data import device_cache
from single_shot_detection_tpu_torch.data.loader import create_loaders
from single_shot_detection_tpu_torch.data.transforms import Pipeline
from single_shot_detection_tpu_torch.device import resolve_device
from single_shot_detection_tpu_torch.export import quantize
from single_shot_detection_tpu_torch.models import builder, norm
from single_shot_detection_tpu_torch.ops import metrics as metrics_ops
from single_shot_detection_tpu_torch.ops.box_coder import BoxCoder
from single_shot_detection_tpu_torch.ops.postprocess import Postprocessor
from single_shot_detection_tpu_torch.parallel import tensor
from single_shot_detection_tpu_torch.predict import Predictor
from single_shot_detection_tpu_torch.train import checkpoint as ckpt
from single_shot_detection_tpu_torch.train import materialize, pruning
from single_shot_detection_tpu_torch.train.state import reset_shadow
from single_shot_detection_tpu_torch.train.step import make_eval_step
from single_shot_detection_tpu_torch.trainer import (Trainer, check_ported,
                                                     model_axis_options,
                                                     staging_yuv)
from single_shot_detection_tpu_torch.utils.config import ConfigWrapper, load_config
from single_shot_detection_tpu_torch.utils import keras_import, torch_import
from single_shot_detection_tpu_torch.utils.misc import filter_kwargs

METRIC_KEYS = ('loss', 'class_loss', 'loc_loss')
BATCH_KEYS = ('image', 'boxes', 'box_mask')


def _copy_inline(batch: dict, device: torch.device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(batch[k]).to(device, non_blocking=True)
                 for k in BATCH_KEYS)


def prefetch_to_device(batches: Iterable[dict], device: torch.device,
                       depth: int) -> Iterator[Tuple[dict, Tuple[torch.Tensor, ...]]]:
    """Yield ``(batch, (image, boxes, box_mask) on the device)`` for each
    loader batch, with up to ``depth`` batches copied ahead (port of the JAX
    engine's ``_prefetch_shard``; ``train.transfer_ahead``).

    ``depth`` 0 or less copies inline.  Otherwise a thread takes the
    batches and issues their copies ahead, in order, through a FIFO of
    ``depth``; on a card each copy leaves a pinned host buffer on a side
    stream, and the consumer's stream waits for that copy's event before the
    batch is handed over (the tensors are marked as used on it, so the
    caching allocator keeps them until its work is done).  The batches are
    the same at any depth: only the copy moves.  An error of the loader or
    of a copy reaches the consumer once the batches before it are
    consumed; leaving the loop early stops the thread.  Pinning and the
    side stream have no fallback: a failure raises.
    """
    if depth <= 0:
        for batch in batches:
            yield batch, _copy_inline(batch, device)
        return

    cuda = device.type == 'cuda'
    stream = torch.cuda.Stream(device) if cuda else None
    q: 'queue.Queue' = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: List[BaseException] = []
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def copy_ahead(batch: dict):
        if not cuda:
            return _copy_inline(batch, device), None
        with torch.cuda.device(device), torch.cuda.stream(stream):
            tensors = tuple(torch.from_numpy(batch[k]).pin_memory().to(
                device, non_blocking=True) for k in BATCH_KEYS)
            event = torch.cuda.Event()
            event.record(stream)
        return tensors, event

    def pump():
        it = iter(batches)
        try:
            for batch in it:
                if not put((batch, *copy_ahead(batch))):
                    return
        except BaseException as exc:  # loader and copy errors reach the consumer
            err.append(exc)
        finally:
            close = getattr(it, 'close', None)
            if close is not None:
                close()  # the loader's own thread stops too
            put(end)

    thread = threading.Thread(target=pump, daemon=True, name='transfer-ahead')
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            batch, tensors, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for t in tensors:
                    t.record_stream(current)
            yield batch, tensors
    finally:
        stop.set()
        thread.join(timeout=30)
        if thread.is_alive():
            logging.warning('WW transfer-ahead thread still alive 30 s after '
                            'the consumer finished (a copy or the loader is '
                            'wedged)')
    if err:
        raise err[0]


def bn_stats_look_untouched(model: torch.nn.Module) -> bool:
    """True when the model has BatchNorms and every running mean is exactly
    0 and every running variance exactly 1: the mark of a checkpoint trained
    with ``train.group_norm``, which never writes them."""
    found = False
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            found = True
            if not (torch.all(m.running_mean == 0)
                    and torch.all(m.running_var == 1)):
                return False
    return found


def create_datasets(dataset_cfg: dict, phases) -> dict:
    """Config-driven dataset factory, one dataset per phase present in both
    the config and ``phases``."""
    out = {}
    labels = dataset_cfg.get('labels')
    label_map = dataset_cfg.get('label_map', {})
    for phase in ('train', 'eval'):
        if phase not in dataset_cfg or phase not in phases:
            continue
        spec = dict(dataset_cfg[phase])
        name = spec.pop('name')
        spec.update({'labels': labels, 'label_map': label_map})
        out[phase] = filter_kwargs(DATASETS[name])(**spec)
    return out


class Experiment:
    """Everything assembled from one config, on one device.

    ``cfg`` is a ``samples/*.py`` path or a loaded ``ConfigWrapper``;
    ``variables`` a JAX ``{'params', 'batch_stats'}`` tree of numpy arrays
    to start from; ``seed`` seeds the weights, the loader order and the
    augmentation (default: the config's); ``overrides`` as in
    ``Trainer.from_config``.  ``checkpoint_dir`` receives the checkpoints
    and ``log.csv`` (nothing is written without it or with ``debug``);
    ``resume_from`` is a checkpoint file or directory (its latest
    checkpoint, ``.pt`` or the JAX package's ``.msgpack``) to resume from
    at the epoch after the one it was saved in, or, with ``load_weights``,
    to take the weights of only.  ``bf16`` and ``matmul_precision`` as
    ``device.py::numeric_policy`` takes them; the resolved precision is
    ``matmul_precision`` (None: the bf16 policy's default).
    """

    def __init__(self, cfg: Union[str, ConfigWrapper],
                 phases=('train', 'eval'),
                 device: Optional[Union[str, torch.device]] = None,
                 seed: Optional[int] = None,
                 variables: Optional[Mapping] = None,
                 overrides: Optional[Mapping] = None,
                 checkpoint_dir: Optional[str] = None,
                 resume_from: Optional[str] = None,
                 load_weights: bool = False,
                 debug: bool = False,
                 bf16: bool = False,
                 int8: bool = False,
                 matmul_precision: Optional[str] = None,
                 tensorboard: bool = False,
                 process_count: int = 1,
                 process_index: int = 0):
        self.phases = list(phases)
        if isinstance(cfg, str):
            cfg = load_config(cfg, phases=self.phases)
        else:
            cfg.set_phases(self.phases)
        if overrides:
            cfg.override(dict(overrides))
        self.cfg = cfg
        check_ported(cfg, process_count)  # the model axis's checks first
        parallel.check_group(process_count, process_index)
        self.process_count = int(process_count)
        self.process_index = int(process_index)
        self.device = (parallel.process_device(process_index, device)
                       if process_count > 1 else resolve_device(device))
        self.seed = int(seed if seed is not None else (cfg.seed or 23))

        # --- datasets & loaders -----------------------------------------
        self.datasets = create_datasets(cfg.dataset, self.phases)
        detector = dict(dict(cfg.model).get('detector', {}))
        if 'num_classes' not in detector and self.datasets:
            ref = self.datasets.get('train') or self.datasets.get('eval')
            detector['num_classes'] = ref.num_classes
            cfg.override({'model': {'detector': detector}})
        train_cfg = dict(cfg.train or {})
        quantize.check_composes(train_cfg, int8)
        # the model axis before the loaders: they shard over the data axis
        mode, axis_size, _ = model_axis_options(train_cfg)
        parallel.set_model_axis(mode, axis_size)
        self.data_count = parallel.data_count()
        self.data_index = parallel.data_index()
        self.transfer_ahead = int(train_cfg.get('transfer_ahead', 2) or 0)
        input_size = tuple(cfg.input_size)
        self.input_size = input_size
        self.loaders = {}
        if self.datasets:
            self.loaders = create_loaders(
                self.datasets,
                batch_size=cfg.batch_size or 32,
                staging_size=tuple(train_cfg.get('staging_size', input_size)),
                shuffle=bool(cfg.shuffle),
                num_workers=cfg.num_workers or 4,
                max_gt=train_cfg.get('max_gt', 100),
                seed=self.seed,
                staging_colorspace=str(train_cfg.get('staging_colorspace', 'rgb')),
                cache_dir=_staging_cache_dir(train_cfg.get('staging_cache'),
                                             process_count, process_index),
                staging_device=self.device,
                process_count=self.data_count, process_index=self.data_index)

        # --- train side: pipeline, model, loss, optimizer, schedule ------
        self.epochs = int(train_cfg.get('epochs', 1))
        self.eval_every = int(train_cfg.get('eval_every', 1))
        self.save_every = int(train_cfg.get('save_every', self.eval_every))
        self.num_batches_per_epoch = train_cfg.get('num_batches_per_epoch')
        steps_per_epoch = None
        if 'train' in self.loaders:
            steps_per_epoch = (self.num_batches_per_epoch
                               or len(self.loaders['train']))
        self.trainer = Trainer.from_cfg(cfg, variables, self.device, self.seed,
                                        steps_per_epoch, bf16,
                                        matmul_precision, process_count,
                                        process_index, shard=False)
        self.policy = self.trainer.policy
        self.matmul_precision = self.policy.matmul_precision
        self.bundle = self.trainer.bundle
        self.anchors = self.trainer.anchors

        # --- eval side ----------------------------------------------------
        self.eval_pipeline = Pipeline((), cfg.preprocessing, input_size,
                                      train=False, staging_yuv=staging_yuv(cfg))
        box_coder = filter_kwargs(BoxCoder)(**(cfg.box_coder or {}))
        self.postprocessor = filter_kwargs(Postprocessor)(
            box_coder=box_coder, **cfg.postprocess)
        # the serving paths' (predict, the test phase, export): the
        # preset's pre_nms_top_k on configs of more than 10000 anchors
        self.serving_postprocessor = filter_kwargs(Postprocessor)(
            box_coder=box_coder, **Postprocessor.serving_preset(
                cfg.postprocess, len(self.anchors)))
        self.eval_step = make_eval_step(self.trainer.criterion,
                                        self.trainer.assigner, self.anchors,
                                        self.postprocessor)

        # --- checkpoints and the weights to start from ---------------------
        self.checkpoint_dir = checkpoint_dir
        self.debug = bool(debug)
        self.start_epoch = 0
        self._load_weights(dict(cfg.model or {}), resume_from, load_weights)
        self._whole: Dict[bool, tuple] = {}  # whole_model's, by shadow
        self._build_pruner(train_cfg.get('pruner'))  # on the whole model
        self.trainer.shard_model_axis()
        self._current_epoch = self.start_epoch  # the emergency save's epoch
        self.fused_steps = self.trainer.fused_steps
        if self.fused_steps > 1 and isinstance(
                getattr(self.pruner, 'criterion', None), pruning.TaylorExpansion):
            logging.warning('WW fused_steps is incompatible with '
                            'TaylorExpansion pruning (per-step grads needed); '
                            'running unfused')
            self.fused_steps = 1

        # --- int8 evaluation (export/quantize.py) ---------------------------
        self.int8 = bool(int8)
        self._int8_requested = bool(int8)
        self._int8_amax: Optional[Dict[str, float]] = None
        self._int8_calib_step: Optional[int] = None
        self._int8_modes: Dict[str, quantize.QuantizedConv] = {}
        self._int8_model: Optional[torch.nn.Module] = None
        self._int8_spatial_limit: Optional[int] = None
        self._predictor: Optional[Predictor] = None
        self._predictor_key = None

        # --- the data path's caches, async saves, tensorboard --------------
        dc_cfg = train_cfg.get('device_cache')
        self.device_cache = (device_cache.make_device_cache(
                                 self.loaders['train'], dc_cfg, self.device)
                             if dc_cfg and 'train' in self.loaders else None)
        # eval.device_cache, by default train.device_cache: the first
        # evaluation's device batches, replayed by every later one (one
        # process only, as in the JAX engine)
        self._eval_replay_cfg = (dict(cfg.eval or {}).get('device_cache', dc_cfg)
                                 if process_count == 1 else None)
        self._eval_cache: Optional[list] = None
        self.async_saver = None
        if train_cfg.get('async_checkpoint'):
            if process_count > 1:
                logging.warning('WW train.async_checkpoint is single-process '
                                'only; falling back to synchronous saves')
            else:
                self.async_saver = ckpt.AsyncSaver()
        self.writer = None
        if (tensorboard and not self.debug and checkpoint_dir
                and self.process_index == 0):
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(checkpoint_dir)
            except ImportError:
                logging.warning('WW tensorboard unavailable: no scalars are '
                                'written')

    def _load_weights(self, model_cfg: dict, resume_from: Optional[str],
                      load_weights: bool) -> None:
        """``model.base.weight`` (a torchvision backbone ``state_dict`` or a
        keras ``.h5``; for a ``torchhub://`` backbone without one, the
        hub cache's), then ``model.detector.torch_weight`` (the reference's
        whole detector), then ``model.detector.weight`` (weights only), then
        ``resume_from``, each over the one before."""
        state = self.trainer.state
        base_cfg = dict(model_cfg.get('base', {}))
        if str(base_cfg.get('name', '')).startswith('torchhub://'):
            hub_name, hub_weight = builder.resolve_torchhub(
                base_cfg['name'], base_cfg.get('hub_dir'))
            base_cfg['name'] = hub_name
            if hub_weight and not base_cfg.get('weight'):
                logging.info(f'>> torchhub: resolved {hub_name!r} weights '
                             f'from the local hub cache: {hub_weight}')
                base_cfg['weight'] = hub_weight

        def adopt(model_state: Dict[str, torch.Tensor]) -> None:
            state.model.load_state_dict(model_state, strict=True)
            reset_shadow(state)  # the shadow was a copy of the random init

        base_weight = str(base_cfg.get('weight') or '')
        if base_weight.endswith(('.h5', '.hdf5')):
            adopt(keras_import.import_keras_backbone(
                base_weight, state.model.state_dict(), base_cfg['name']))
        elif base_weight:
            adopt(torch_import.import_backbone(
                torch_import.load_torch_state_dict(base_weight),
                state.model.state_dict(), base_cfg['name']))
        elif base_cfg.get('pretrained'):
            logging.warning(
                'WW base.pretrained=True cannot download torchvision weights; '
                'set base.weight=<path to a torch state_dict> to load '
                'pretrained weights (utils/torch_import.py) — training from '
                'scratch')
        torch_weight = dict(model_cfg.get('detector', {})).get('torch_weight')
        if torch_weight:
            adopt(torch_import.import_reference_checkpoint(
                torch_weight, state.model.state_dict(),
                **torch_import.mapping_args_from_config(model_cfg)))
        weight_file = dict(model_cfg.get('detector', {})).get('weight')
        restored_any = False
        if weight_file:
            ckpt.restore_weights_only(weight_file, state)
            restored_any = True
        if resume_from:
            path = ckpt.find_latest(resume_from)
            if path is None:
                logging.warning(f'WW no checkpoint found under {resume_from}')
            elif load_weights:
                ckpt.restore_weights_only(path, state)
                restored_any = True
            else:
                _, meta = ckpt.restore(path, state)
                self.start_epoch = meta['epoch'] + 1
                restored_any = True
        group_norm = norm.groups_from_config(
            dict(self.cfg.train or {}).get('group_norm'))
        if (restored_any and group_norm is None
                and bn_stats_look_untouched(state.model)):
            # a GroupNorm run never writes the BN running statistics
            logging.warning(
                'WW restored checkpoint has every BN running statistic at '
                'its 0/1 init — if it was trained with train.group_norm, '
                'set it here too or eval will silently use identity '
                'normalization')

    def _build_pruner(self, pruner_cfg) -> None:
        """``train.pruner``: the ``Pruner`` over the channel spaces of the
        model's traced graph (port of the JAX engine's set-up), traced and
        sized on the whole model before a tensor-sharded state is sliced."""
        self.pruner: Optional[pruning.Pruner] = None
        self._observe_means = False
        if not pruner_cfg:
            return
        pruner_cfg = dict(pruner_cfg)
        with parallel.model_axis_off():
            spaces = materialize.build_channel_spaces(self.model,
                                                      self.input_size)
        self.pruner = pruning.Pruner(
            pruning.param_tree(self.model),
            criterion=pruner_cfg.get('criterion', {'name': 'MinL1Norm'}),
            include_paths=pruner_cfg.get('include_paths'),
            num=pruner_cfg.get('num', 1), spaces=spaces)
        self.observe_every = int(pruner_cfg.get('observe_every', 10))
        self._observe_means = self.pruner.criterion.needs_activations

    def _observe(self, tensors) -> None:
        """Feed the pruner's data-dependent criterion after a step: the
        step's loss gradients beside the parameters after it, or the
        per-channel activation means of the batch's eval preprocessing
        (with several processes, the global batch's: the gradients are
        summed over the ranks already, the means are averaged here).  With
        a model axis both come from whole tensors: the parameters and
        gradients gathered under tensor sharding, the means from the whole
        model's forward on the model group's batch."""
        axes = self.trainer.state.tensor
        if isinstance(self.pruner.criterion, pruning.TaylorExpansion):
            params = pruning.param_tree(self.model)
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in params.items()}
            self.pruner.observe_grads(pruning.whole_leaves(params, axes),
                                      pruning.whole_leaves(grads, axes))
        if self._observe_means:
            model = self.whole_model(shadow=False)
            with (torch.no_grad(), self.policy.scope(),
                  parallel.model_axis_off()):
                x, _, _ = self.eval_pipeline.apply([], *tensors)
                means = pruning.activation_means(model, x)
            # the global batch's means: every rank's batch is b rows
            keys = list(means)
            flat = parallel.all_reduce_(torch.from_numpy(np.concatenate(
                [means[k].ravel() for k in keys])).to(self.device))
            parts = np.split((flat / self.data_count).cpu().numpy(),
                             np.cumsum([means[k].size for k in keys])[:-1])
            means = dict(zip(keys, parts))
            self.pruner.observe(means)

    def materialize_pruned(self):
        """The physically narrow model of a pruned run: ``(bundle,
        state_dict)``, the bundle's module loaded, on this experiment's
        device (``train/materialize.py``); with a model axis from
        :meth:`whole_model`, a collective every rank enters."""
        if self.pruner is None or not self.pruner.dead:
            raise ValueError('nothing pruned to materialize')
        whole = self.whole_model()
        with parallel.model_axis_off():
            return materialize.materialize_bundle(
                self.bundle, whole.state_dict(), self.pruner.dead,
                spaces=self.pruner.spaces)

    def whole_model(self, shadow: bool = True) -> torch.nn.Module:
        """The evaluation model (``shadow``; else the trained model) whole
        on this rank, to run under ``parallel.model_axis_off()``: the
        module itself without tensor sharding (spatial and pipeline
        sharding hold whole parameters); under it a copy whose sliced
        leaves are gathered over the model group, a collective every rank
        enters, built once per train step and prune reached."""
        model = self.eval_model if shadow else self.model
        axes = self.trainer.state.tensor
        if axes is None:
            return model
        dead = self.pruner and sum(map(len, self.pruner.dead.values()))
        key = (int(self.trainer.state.step), dead)
        if self._whole.get(shadow, (None,))[0] != key:
            if shadow:
                self.trainer.gather_shadow()  # ZeRO-1 with EMA: every rank
            self._whole[shadow] = (key, tensor.whole_copy(model, axes))
        return self._whole[shadow][1]

    @property
    def model(self) -> torch.nn.Module:
        return self.trainer.model

    @property
    def eval_model(self) -> torch.nn.Module:
        """The model evaluation and serving run: the EMA shadow under
        ``train.ema``, else the model."""
        return self.trainer.eval_model

    def _device_batches(self, batches: Iterable[dict]):
        """``(batch, device tensors)`` with ``train.transfer_ahead``."""
        return prefetch_to_device(batches, self.device, self.transfer_ahead)

    # ------------------------------------------------------------------- int8
    def _calibration_images(self, n_batches: int = 2) -> List[torch.Tensor]:
        """Eval batches through the eval pipeline, for int8 calibration
        (the JAX package's ``export/__init__.py::_calibration_images``)."""
        if not self.loaders:
            raise ValueError(
                'int8 calibration needs real batches but no dataset is '
                'configured for the active phases — include an eval (or '
                'train) dataset when using --int8')
        loader = self.loaders.get('eval') or next(iter(self.loaders.values()))
        images = []
        for batch in itertools.islice(loader, n_batches):
            with torch.no_grad():
                x, _, _ = self.eval_pipeline.apply(
                    [], *_copy_inline(batch, self.device))
            images.append(x)
        return images

    def calibrate_int8(self, model: torch.nn.Module,
                       n_batches: int) -> Dict[str, float]:
        """Each conv's int8 activation maximum ``{key: amax}`` of the whole
        ``model`` (run without a model axis) over ``n_batches`` eval
        batches of every rank: the maximum over the world is a
        collective, so every rank calls it."""
        with self.policy.scope():
            images = self._calibration_images(n_batches)
            with parallel.model_axis_off():
                amax = quantize.calibrate(model, images)
        keys = sorted(amax)
        maxima = parallel.all_reduce_(torch.tensor(
            [amax[k] for k in keys], dtype=torch.float64, device=self.device),
            'max', 'world').tolist()
        return dict(zip(keys, maxima))

    def _ensure_int8(self) -> None:
        """Calibrate on eval batches and switch the evaluation to int8
        (port of the JAX engine's ``_ensure_int8``); calibrate again when
        training has advanced since.  The serving gate is judged at the
        eval loader's batch; a ``train.qat`` run's learned scales are taken
        in place of a calibration.  With a model axis the int8 convs run
        on :meth:`whole_model`: every rank calls this."""
        if not self.int8:
            return
        step = int(self.trainer.state.step)
        model = self.whole_model()
        if (self._int8_amax is not None and self._int8_calib_step == step
                and self._int8_model is model):
            return
        serving_batch = (self.loaders['eval'].batch_size
                         if 'eval' in self.loaders else None)
        enabled, opts = quantize.resolve_int8_opts(self.cfg,
                                                   batch_size=serving_batch)
        if not enabled:
            self.int8 = False
            return
        qat_amax = quantize.amax_from_batch_stats(model.state_dict())
        if qat_amax:
            self._int8_amax = qat_amax
            how = 'QAT-learned scales for'
        else:
            n_batches = int(opts.get('calibration_batches', 2))
            self._int8_amax = self.calibrate_int8(model, n_batches)
            how = f'calibrated (at most {n_batches} batches)'
        self._int8_calib_step = step
        self._int8_model = model
        self._int8_spatial_limit = opts.get('spatial_limit')
        self._int8_modes = quantize.make_interceptor(
            model, self._int8_amax, opts.get('spatial_limit'))
        logging.info(f'>> int8: {how} {len(self._int8_amax)} convs')

    # ---------------------------------------------------------------- serving
    def predictor(self) -> Predictor:
        """The serving ``Predictor`` on this experiment's model: its serving
        postprocessor, eval preprocessing and numeric policy, int8 on the
        scales of ``_ensure_int8`` when the gate allows.  Built once, and
        again when the int8 calibration step or :meth:`whole_model`
        changes; with a model axis every rank calls it first (the whole
        model's gather, the calibration), then any rank may serve."""
        self._ensure_int8()
        model = self.whole_model()
        key = (self.int8, self._int8_calib_step, model)
        if self._predictor is None or self._predictor_key != key:
            self._predictor = Predictor(
                dataclasses.replace(self.bundle, module=model),
                self.serving_postprocessor,
                self.eval_pipeline.preprocess, self.device, self.policy,
                self._int8_amax if self.int8 else None,
                self._int8_spatial_limit)
            self._predictor_key = key
        return self._predictor

    def predict(self, image: np.ndarray) -> np.ndarray:
        """One uint8 ``[H, W, 3]`` RGB image of any size -> ``[n, 6]`` valid
        detections ``[x0, y0, x1, y1, class, score]`` in its own pixels
        (port of the JAX engine's ``predict``), through :meth:`predictor`,
        whose whole model runs without the model axis."""
        predictor = self.predictor()
        predictor.model.eval()
        with parallel.model_axis_off():
            return predictor.predict(image)

    def export(self, int8: bool = False) -> str:
        """The export phase on the config's ``export`` block (``main.py``'s):
        ``standalone`` sets ``with_postprocess``, ``with_preprocess`` and
        ``bake_variables`` unless given, ``path`` (default
        ``exported/model``), ``int8`` (or the ``int8`` argument, ``--int8``)
        and ``batch_size``; an unknown key ends the run.  Returns the
        artifact's path."""
        from single_shot_detection_tpu_torch.export import export_model
        opts = dict(self.cfg.export or {})
        if opts.pop('standalone', False):
            opts.setdefault('with_postprocess', True)
            opts.setdefault('with_preprocess', True)
            opts.setdefault('bake_variables', True)
        path = opts.pop('path', 'exported/model')
        int8 = bool(opts.pop('int8', False)) or int8
        allowed = {'with_postprocess', 'batch_size', 'with_preprocess',
                   'bake_variables'}
        unknown = sorted(set(opts) - allowed)
        if unknown:
            raise SystemExit(
                f"config export block has unknown key(s) {unknown}; "
                f"supported: {sorted(allowed | {'standalone', 'path', 'int8'})}")
        return export_model(self, path, int8=int8, **opts)

    # ------------------------------------------------------------------ train
    def train(self) -> List[Dict[str, float]]:
        """Run the epochs from ``start_epoch``; returns this run's rows, one
        per epoch (``train_*`` epoch means and, after an evaluation,
        ``eval_*``).

        A ``KeyboardInterrupt`` saves an emergency checkpoint of the current
        epoch before it is re-raised (a resume from it starts at the next
        epoch); SIGTERM is turned into one while the epochs run, and the
        previous handler is put back afterwards.  An interrupt that lands
        inside the optimizer's update can leave that one step half
        applied."""
        def _sigterm(signum, frame):
            raise KeyboardInterrupt('SIGTERM')

        prev_handler, installed = None, False
        try:  # only the main thread may set handlers
            prev_handler = signal.signal(signal.SIGTERM, _sigterm)
            installed = True
        except ValueError:
            pass
        try:
            return self._train_epochs()
        except KeyboardInterrupt:
            if (self.checkpoint_dir and not self.debug
                    and self.process_index == 0 and self._emergency_saveable()):
                self._drain_async_saves(swallow=True)
                path = ckpt.save(self.checkpoint_dir, self.trainer.state,
                                 self._current_epoch)
                logging.warning(f'WW interrupted — emergency checkpoint '
                                f'saved to {path}')
            raise
        finally:
            # a save in flight finishes (or reports) however train() exits
            self._drain_async_saves(swallow=True)
            if installed:
                # None: the previous handler was not installed from Python
                signal.signal(signal.SIGTERM, prev_handler
                              if prev_handler is not None else signal.SIG_DFL)

    def _emergency_saveable(self) -> bool:
        """An emergency save runs on one rank, so it cannot gather ZeRO-1's
        slices (a collective): with them sharded over several processes it
        is skipped with a pointer to the last scheduled save, as in the JAX
        engine."""
        if self.trainer.state.zero is None and self.trainer.state.tensor is None:
            return True
        logging.warning(
            'WW state has cross-host-sharded leaves (train.zero_sharding '
            'or tensor_sharding over multiple processes): emergency '
            'checkpoint skipped '
            '(gathering is a collective, unsafe from one rank mid-failure) '
            '— resume from the last scheduled save')
        return False

    def _train_epochs(self) -> List[Dict[str, float]]:
        saves = bool(self.checkpoint_dir and not self.debug)
        writes = saves and self.process_index == 0
        csv_path = None
        if writes:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            csv_path = os.path.join(self.checkpoint_dir, 'log.csv')
        earlier = _read_csv(csv_path, self.start_epoch) if csv_path else []
        trainer = self.trainer
        rows = []
        for epoch in range(self.start_epoch, self.epochs):
            self._current_epoch = epoch
            logging.info(f'Epoch: {epoch}/{self.epochs - 1}')
            if self.pruner is not None:
                self.pruner.prune(trainer.state)
            row = self.train_epoch(epoch)
            self._log_scalars('train', row, epoch)
            if 'eval' in self.phases and (epoch + 1) % self.eval_every == 0:
                metrics = self.evaluate()
                row.update({f'eval_{k}': v for k, v in metrics.items()})
                if trainer.plateau is not None:
                    value = row.get(trainer.scheduler_metric or 'eval_loss')
                    if value is not None:
                        trainer.state.lr_scale = trainer.plateau.update(value)
                self._log_scalars('eval', metrics, epoch)
            rows.append(row)
            if csv_path:
                _write_csv(csv_path, earlier + rows)
            if saves and (epoch + 1) % self.save_every == 0:
                if self.async_saver is not None:
                    self.async_saver.save(self.checkpoint_dir, trainer.state,
                                          epoch)
                else:
                    # every rank gathers (ZeRO-1), process 0 writes
                    saved = ckpt.gather_for_save(trainer.state)
                    if writes:
                        ckpt.write(self.checkpoint_dir, saved, epoch)
        # the last checkpoint is on disk, or its failure raised, on return
        self._drain_async_saves(swallow=False)
        return rows

    def _log_scalars(self, group: str, values: Mapping[str, float],
                     epoch: int) -> None:
        """``{group}/{key}`` tensorboard scalars (the JAX engine's tags: the
        train row's keys keep their ``train_`` prefix)."""
        if self.writer is None:
            return
        for k, v in values.items():
            if k != 'epoch':
                self.writer.add_scalar(f'{group}/{k}', v, epoch)
        self.writer.flush()

    def _drain_async_saves(self, swallow: bool) -> None:
        """Join the async save in flight; ``swallow`` logs its failure
        instead of raising (before an emergency save, which must run)."""
        if self.async_saver is None:
            return
        try:
            self.async_saver.wait()
        except BaseException as exc:  # noqa: BLE001
            if not swallow:
                raise
            logging.warning(f'WW async checkpoint write failed: {exc}')

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """The steps of epoch ``epoch``, each with the draws of its global
        step index (k at a time with ``train.fused_steps``, a remainder
        shorter than k unfused); metric sums stay on the device and are
        read once.  Returns the epoch's row."""
        loader = self.loaders['train']
        num_batches = self.num_batches_per_epoch or len(loader)
        loader.epoch = epoch  # a later start replays no earlier epoch's order
        start = time.perf_counter()
        sums = None
        count = 0
        k = self.fused_steps
        cache = self.device_cache
        batches = () if cache is not None and cache.ready else \
            self._device_batches(itertools.islice(loader, num_batches))

        def groups():
            """('single', tensors) or, with ``fused_steps`` > 1, ('fused',
            k tensors); a remainder shorter than k runs unfused.  From the
            device cache once it is filled, else from the loader (the fill
            epoch keeps each batch's rows)."""
            if cache is not None and cache.ready:
                yield from cache.epoch_batches(loader, epoch, k, num_batches)
                return
            chunk = []
            for batch, tensors in batches:
                if cache is not None:
                    cache.observe(batch)
                if k == 1:
                    yield 'single', tensors
                    continue
                chunk.append(tensors)
                if len(chunk) == k:
                    yield 'fused', chunk
                    chunk = []
            for tensors in chunk:
                yield 'single', tensors

        for kind, tensors in groups():
            step = epoch * num_batches + count
            if kind == 'fused':
                metrics = self.trainer.fused_train_step(tensors, step=step)
                n = k
            else:
                metrics = self.trainer.train_step(*tensors, step=step)
                if self.pruner is not None and count % self.observe_every == 0:
                    self._observe(tensors)
                n = 1
            stacked = torch.stack([metrics[key] for key in METRIC_KEYS])
            sums = stacked if sums is None else sums + stacked
            count += n
        if cache is not None and not cache.ready:
            # the fill epoch is done: stage its drop_last leftovers, upload
            cache.finalize(loader)
        pulled = sums.tolist() if sums is not None else None
        row = {'epoch': epoch}
        for i, key in enumerate(METRIC_KEYS):
            row[f'train_{key}'] = pulled[i] / max(count, 1) if pulled else 0.0
        elapsed = time.perf_counter() - start
        if self.process_index == 0:
            images = count * loader.batch_size * self.data_count
            logging.info(
                f'[train] epoch {epoch}: {count} steps in {elapsed:.2f} s '
                f'({images / max(elapsed, 1e-9):.1f} img/s) '
                + ' '.join(f'{k}={v:.4f}' for k, v in row.items()
                           if k != 'epoch'))
        return row

    # ------------------------------------------------------------------- eval
    def _eval_batches(self) -> Iterator[Tuple[np.ndarray, Tuple[torch.Tensor, ...]]]:
        """``(ids, (image, boxes, box_mask) on the device)`` for each eval
        batch: replayed from the eval replay cache once it holds the first
        evaluation's batches, else streamed (and kept, while the budget
        allows, when the replay cache is on)."""
        if self._eval_cache is not None:
            yield from self._eval_cache
            return
        filling, budget, filled = None, 0, 0
        if self._eval_replay_cfg:
            # the kept batches stay on the device for the run: they charge
            # against the train cache's budget, less what that cache holds
            budget = device_cache.budget(self._eval_replay_cfg)
            if self.device_cache is not None:
                budget -= self.device_cache.total_bytes
            filling = []
        for batch, tensors in self._device_batches(self.loaders['eval']):
            entry = (batch['ids'], tensors)
            if filling is not None:
                filled += batch['ids'].nbytes + sum(t.nbytes for t in tensors)
                if filled > budget:
                    logging.warning(
                        f'WW eval replay cache over budget '
                        f'({filled / 2**30:.2f} GiB cached + train device '
                        f'cache > max_bytes) — streaming every eval instead '
                        f"(raise device_cache['max_bytes'] to override)")
                    filling = None
                    self._eval_replay_cfg = None  # not tried again
                else:
                    filling.append(entry)
            yield entry
        if filling is not None:
            self._eval_cache = filling

    def evaluate(self) -> Dict[str, float]:
        """Loss and mAP over the eval loader (and ``int8``, 1.0 or 0.0, when
        int8 was asked for).  Detections stay on the device until every
        batch has been dispatched."""
        self.trainer.gather_shadow()  # ZeRO-1 with EMA: every rank
        self._ensure_int8()
        start = time.perf_counter()
        sums = None
        count = 0
        pending = []
        model, int8 = self.eval_model, contextlib.nullcontext()
        if self.int8:
            # the int8 convs on the whole model; with a model axis it runs
            # whole on each rank (the loss and the rows still reduce and
            # gather over the data axis)
            model = self.whole_model()
            int8 = quantize.quant_modes(model, self._int8_modes)
            if parallel.model_mode() is not None:
                model = _AxisOff(model)
        with self.policy.scope(), int8:
            for ids, (images, boxes, mask) in self._eval_batches():
                with torch.no_grad():
                    x, full_boxes, mask = self.eval_pipeline.apply(
                        [], images, boxes, mask)
                # padding rows of a partial batch carry id -1 and add no loss
                image_valid = torch.from_numpy(ids >= 0).to(self.device)
                metrics, dets, valid = self.eval_step(
                    model, x, full_boxes[..., :6], mask, image_valid)
                stacked = torch.stack([metrics[k] for k in METRIC_KEYS])
                sums = stacked if sums is None else sums + stacked
                count += 1
                pending.append((dets, valid, mask, full_boxes, ids))

        if sums is not None:
            parallel.all_reduce_(sums)  # each rank's share of each batch
        pulled = sums.tolist() if sums is not None else [0.0] * len(METRIC_KEYS)
        all_preds, all_gts = [], []
        rows = self._gather_eval_rows(pending)
        for i in range(len(rows['ids'])):
            if rows['ids'][i] < 0:
                continue  # padding rows of the last partial batch
            for row in rows['dets'][i][rows['valid'][i]]:
                all_preds.append([len(all_gts), *row])
            all_gts.append(rows['gt'][i][rows['mask'][i]])

        result = {k: v / max(count, 1) for k, v in zip(METRIC_KEYS, pulled)}
        if all_gts:
            preds = np.asarray(all_preds) if all_preds else np.zeros((0, 7))
            is_voc = self.cfg.is_voc('eval')
            result['mAP'] = metrics_ops.mean_average_precision(
                preds, all_gts,
                dict(enumerate(self.datasets['eval'].class_labels)),
                iou_threshold=0.5, voc=is_voc)
            # the COCO sweep for non-VOC datasets, or as the config says
            coco_flag = self.cfg.coco_metrics
            if coco_flag or (coco_flag == {} and not is_voc):
                coco_kwargs = dict(coco_flag) if isinstance(coco_flag, dict) else {}
                result.update(metrics_ops.coco_mean_average_precision(
                    preds, all_gts, **coco_kwargs))
        if self._int8_requested:
            # 1.0: the int8 forward served this evaluation; 0.0: the gate
            # refused it and the evaluation ran in float
            result['int8'] = float(self.int8)
        if self.process_index == 0:
            logging.info(f'[eval] {count} batches in '
                         f'{time.perf_counter() - start:.2f} s: '
                         + ' '.join(f'{k}={v:.4f}' for k, v in result.items()))
        return result

    def _gather_eval_rows(self, pending) -> Dict[str, np.ndarray]:
        """The evaluation's rows on the host, ``dets``, ``valid``,
        ``mask``, ``gt`` and ``ids``, batch by batch; with several
        processes every rank's, gathered in the JAX engine's order (each
        batch's rows rank after rank) on every rank."""
        keys = ('dets', 'valid', 'mask', 'gt', 'ids')
        rows = {k: [] for k in keys + ('batch',)}
        for b, entry in enumerate(pending):
            for k, value in zip(keys, entry):
                rows[k].append(value.cpu().numpy()
                               if isinstance(value, torch.Tensor) else value)
            rows['batch'].append(np.full(len(entry[-1]), b, np.int64))
        if not pending:
            return {k: np.zeros((0,)) for k in keys}
        rows = {k: np.concatenate(v) for k, v in rows.items()}
        rows = parallel.all_gather_host(rows)
        order = np.argsort(rows.pop('batch'), kind='stable')
        return {k: v[order] for k, v in rows.items()}


class _AxisOff(torch.nn.Module):
    """A whole model whose forward runs without the model axis."""

    def __init__(self, module: torch.nn.Module):
        super().__init__()
        self.module = module

    def forward(self, x):
        with parallel.model_axis_off():
            return self.module(x)


def _staging_cache_dir(cache_dir, process_count: int,
                       process_index: int) -> Optional[str]:
    """The staging cache's directory: one subdirectory ``p{index}`` a
    process when there are several (the cache has one writer)."""
    if not cache_dir:
        return None
    if process_count > 1:
        return os.path.join(str(cache_dir), f'p{process_index}')
    return str(cache_dir)


def _read_csv(path: str, before_epoch: int) -> List[Dict[str, str]]:
    """The rows of an existing ``log.csv`` for epochs before
    ``before_epoch``, values as written."""
    if not os.path.exists(path):
        return []
    with open(path, newline='') as f:
        return [{k: v for k, v in row.items() if v != ''}
                for row in csv.DictReader(f) if int(row['epoch']) < before_epoch]


def _write_csv(path: str, rows) -> None:
    """``log.csv`` rewritten with the union of the rows' keys, ``epoch``
    first."""
    keys = sorted({k for row in rows for k in row},
                  key=lambda k: (k != 'epoch', k))
    with open(path, 'w', newline='') as f:
        writer = csv.DictWriter(f, fieldnames=keys)
        writer.writeheader()
        for row in rows:
            writer.writerow(row)
