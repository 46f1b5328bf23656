"""``Experiment``: a config's datasets, loaders, model and steps, run as the
``train`` and ``eval`` phases on one device.

Port of the JAX package's ``train/engine.py::Experiment`` for one card:
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

Not ported yet, each raising ``NotImplementedError`` when asked for: the
asynchronous checkpoint writer, the device-resident dataset and the eval
replay cache, keras ``.h5`` and torch-hub backbones, the reference's whole
detector (``detector.torch_weight``), pruning, EMA, tensorboard and
multi-host runs.

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

from single_shot_detection_tpu_torch.data.datasets import DATASETS
from single_shot_detection_tpu_torch.data.loader import create_loaders
from single_shot_detection_tpu_torch.data.transforms import Pipeline
from single_shot_detection_tpu_torch.device import resolve_device
from single_shot_detection_tpu_torch.export import quantize
from single_shot_detection_tpu_torch.models import norm
from single_shot_detection_tpu_torch.ops import metrics as metrics_ops
from single_shot_detection_tpu_torch.ops.box_coder import BoxCoder
from single_shot_detection_tpu_torch.ops.postprocess import Postprocessor
from single_shot_detection_tpu_torch.predict import Predictor
from single_shot_detection_tpu_torch.train import checkpoint as ckpt
from single_shot_detection_tpu_torch.train.step import make_eval_step
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.config import ConfigWrapper, load_config
from single_shot_detection_tpu_torch.utils import torch_import
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


def check_experiment_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for the engine options the port does
    not run yet (the train options are ``trainer.check_ported``'s)."""
    train = dict(cfg.train or {})
    for key in ('device_cache', 'staging_cache', 'async_checkpoint'):
        if train.get(key):
            raise NotImplementedError(f'train.{key} is not ported yet')
    if dict(cfg.eval or {}).get('device_cache'):
        raise NotImplementedError('eval.device_cache is not ported yet')
    model = dict(cfg.model or {})
    if dict(model.get('detector', {})).get('torch_weight'):
        raise NotImplementedError('model.detector.torch_weight is not ported '
                                  'yet')
    base = dict(model.get('base', {}))
    if str(base.get('name', '')).startswith('torchhub://'):
        raise NotImplementedError('torchhub:// backbones are not ported yet')
    if str(base.get('weight') or '').endswith(('.h5', '.hdf5')):
        raise NotImplementedError('keras .h5 backbone weights are not ported '
                                  'yet')


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
                 process_count: int = 1):
        for name, value in (('tensorboard', tensorboard),
                            ('process_count > 1', process_count != 1)):
            if value:
                raise NotImplementedError(f'Experiment {name} is not ported yet')
        self.device = resolve_device(device)
        self.phases = list(phases)
        if isinstance(cfg, str):
            cfg = load_config(cfg, phases=self.phases)
        else:
            cfg.set_phases(self.phases)
        if overrides:
            cfg.override(dict(overrides))
        check_experiment_ported(cfg)
        self.cfg = cfg
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
                staging_device=self.device)

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
                                        matmul_precision)
        self.policy = self.trainer.policy
        self.matmul_precision = self.policy.matmul_precision
        self.bundle = self.trainer.bundle
        self.anchors = self.trainer.anchors

        # --- eval side ----------------------------------------------------
        self.eval_pipeline = Pipeline((), cfg.preprocessing, input_size,
                                      train=False)
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
        self._current_epoch = self.start_epoch  # the emergency save's epoch

        # --- int8 evaluation (export/quantize.py) ---------------------------
        self.int8 = bool(int8)
        self._int8_requested = bool(int8)
        self._int8_amax: Optional[Dict[str, float]] = None
        self._int8_calib_step: Optional[int] = None
        self._int8_modes: Dict[str, quantize.QuantizedConv] = {}
        self._int8_spatial_limit: Optional[int] = None
        self._predictor: Optional[Predictor] = None
        self._predictor_key = None

    def _load_weights(self, model_cfg: dict, resume_from: Optional[str],
                      load_weights: bool) -> None:
        """``model.base.weight`` (a torchvision backbone ``state_dict``),
        then ``model.detector.weight`` (weights only), then ``resume_from``,
        each over the one before."""
        state = self.trainer.state
        base_cfg = dict(model_cfg.get('base', {}))
        if base_cfg.get('weight'):
            state.model.load_state_dict(torch_import.import_backbone(
                torch_import.load_torch_state_dict(base_cfg['weight']),
                state.model.state_dict(), base_cfg['name']))
        elif base_cfg.get('pretrained'):
            logging.warning(
                'WW base.pretrained=True cannot download torchvision weights; '
                'set base.weight=<path to a torch state_dict> to load '
                'pretrained weights (utils/torch_import.py) — training from '
                'scratch')
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

    @property
    def model(self) -> torch.nn.Module:
        return self.trainer.model

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

    def _ensure_int8(self) -> None:
        """Calibrate on eval batches and switch the evaluation to int8
        (port of the JAX engine's ``_ensure_int8``); calibrate again when
        training has advanced since.  The serving gate is judged at the
        eval loader's batch; a ``train.qat`` run's learned scales are taken
        in place of a calibration."""
        if not self.int8:
            return
        step = int(self.trainer.state.step)
        if self._int8_amax is not None and self._int8_calib_step == step:
            return
        serving_batch = (self.loaders['eval'].batch_size
                         if 'eval' in self.loaders else None)
        enabled, opts = quantize.resolve_int8_opts(self.cfg,
                                                   batch_size=serving_batch)
        if not enabled:
            self.int8 = False
            return
        qat_amax = quantize.amax_from_batch_stats(self.model.state_dict())
        if qat_amax:
            self._int8_amax = qat_amax
            how = 'QAT-learned scales for'
        else:
            n_batches = int(opts.get('calibration_batches', 2))
            with self.policy.scope():
                images = self._calibration_images(n_batches)
                self._int8_amax = quantize.calibrate(self.model, images)
            how = f'calibrated ({len(images)} batches)'
        self._int8_calib_step = step
        self._int8_spatial_limit = opts.get('spatial_limit')
        self._int8_modes = quantize.make_interceptor(
            self.model, self._int8_amax, opts.get('spatial_limit'))
        logging.info(f'>> int8: {how} {len(self._int8_amax)} convs')

    # ---------------------------------------------------------------- serving
    def predictor(self) -> Predictor:
        """The serving ``Predictor`` on this experiment's model: its serving
        postprocessor, eval preprocessing and numeric policy, int8 on the
        scales of ``_ensure_int8`` when the gate allows.  Built once, and
        again when the int8 calibration step changes."""
        self._ensure_int8()
        key = (self.int8, self._int8_calib_step)
        if self._predictor is None or self._predictor_key != key:
            self._predictor = Predictor(
                self.bundle, self.serving_postprocessor,
                self.eval_pipeline.preprocess, self.device, self.policy,
                self._int8_amax if self.int8 else None,
                self._int8_spatial_limit)
            self._predictor_key = key
        return self._predictor

    def predict(self, image: np.ndarray) -> np.ndarray:
        """One uint8 ``[H, W, 3]`` RGB image of any size -> ``[n, 6]`` valid
        detections ``[x0, y0, x1, y1, class, score]`` in its own pixels
        (port of the JAX engine's ``predict``), through :meth:`predictor`."""
        predictor = self.predictor()
        self.model.eval()
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
            if self.checkpoint_dir and not self.debug:
                path = ckpt.save(self.checkpoint_dir, self.trainer.state,
                                 self._current_epoch)
                logging.warning(f'WW interrupted — emergency checkpoint '
                                f'saved to {path}')
            raise
        finally:
            if installed:
                # None: the previous handler was not installed from Python
                signal.signal(signal.SIGTERM, prev_handler
                              if prev_handler is not None else signal.SIG_DFL)

    def _train_epochs(self) -> List[Dict[str, float]]:
        writes = self.checkpoint_dir and not self.debug
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
            row = self.train_epoch(epoch)
            if 'eval' in self.phases and (epoch + 1) % self.eval_every == 0:
                row.update({f'eval_{k}': v for k, v in self.evaluate().items()})
                if trainer.plateau is not None:
                    value = row.get(trainer.scheduler_metric)
                    if value is not None:
                        trainer.state.lr_scale = trainer.plateau.update(value)
            rows.append(row)
            if csv_path:
                _write_csv(csv_path, earlier + rows)
            if writes and (epoch + 1) % self.save_every == 0:
                ckpt.save(self.checkpoint_dir, trainer.state, epoch)
        return rows

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """The steps of epoch ``epoch``, each with the draws of its global
        step index; metric sums stay on the device and are read once.
        Returns the epoch's row."""
        loader = self.loaders['train']
        num_batches = self.num_batches_per_epoch or len(loader)
        loader.epoch = epoch  # a later start replays no earlier epoch's order
        start = time.perf_counter()
        sums = None
        count = 0
        batches = self._device_batches(itertools.islice(loader, num_batches))
        for step_idx, (_, tensors) in enumerate(batches):
            metrics = self.trainer.train_step(
                *tensors, step=epoch * num_batches + step_idx)
            stacked = torch.stack([metrics[k] for k in METRIC_KEYS])
            sums = stacked if sums is None else sums + stacked
            count += 1
        pulled = sums.tolist() if sums is not None else None
        row = {'epoch': epoch}
        for i, k in enumerate(METRIC_KEYS):
            row[f'train_{k}'] = pulled[i] / max(count, 1) if pulled else 0.0
        elapsed = time.perf_counter() - start
        logging.info(f'[train] epoch {epoch}: {count} steps in {elapsed:.2f} s '
                     f'({count * loader.batch_size / max(elapsed, 1e-9):.1f} '
                     'img/s) ' + ' '.join(f'{k}={v:.4f}' for k, v in row.items()
                                          if k != 'epoch'))
        return row

    # ------------------------------------------------------------------- eval
    def evaluate(self) -> Dict[str, float]:
        """Loss and mAP over the eval loader (and ``int8``, 1.0 or 0.0, when
        int8 was asked for).  Detections stay on the device until every
        batch has been dispatched."""
        self._ensure_int8()
        loader = self.loaders['eval']
        start = time.perf_counter()
        sums = None
        count = 0
        pending = []
        int8 = (quantize.quant_modes(self.model, self._int8_modes) if self.int8
                else contextlib.nullcontext())
        with self.policy.scope(), int8:
            for batch, (images, boxes, mask) in self._device_batches(loader):
                with torch.no_grad():
                    x, full_boxes, mask = self.eval_pipeline.apply(
                        [], images, boxes, mask)
                # padding rows of a partial batch carry id -1 and add no loss
                image_valid = torch.from_numpy(
                    batch['ids'] >= 0).to(self.device)
                metrics, dets, valid = self.eval_step(
                    self.model, x, full_boxes[..., :6], mask, image_valid)
                stacked = torch.stack([metrics[k] for k in METRIC_KEYS])
                sums = stacked if sums is None else sums + stacked
                count += 1
                pending.append((dets, valid, mask, full_boxes, batch['ids']))

        pulled = sums.tolist() if sums is not None else [0.0] * len(METRIC_KEYS)
        all_preds, all_gts = [], []
        for dets, valid, mask, gt, ids in pending:
            dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
            mask, gt = mask.cpu().numpy(), gt.cpu().numpy()
            for i in range(dets.shape[0]):
                if ids[i] < 0:
                    continue  # padding rows of the last partial batch
                for row in dets[i][valid[i]]:
                    all_preds.append([len(all_gts), *row])
                all_gts.append(gt[i][mask[i]])

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
        logging.info(f'[eval] {count} batches in {time.perf_counter() - start:.2f} s: '
                     + ' '.join(f'{k}={v:.4f}' for k, v in result.items()))
        return result


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
