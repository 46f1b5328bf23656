"""Port parity for the eval path and the minimal ``Experiment``: mAP
(``ops/metrics.py``), the multibox loss with ``image_mask``, the schedule's
milestones in epochs of the train loader, and ``Experiment.evaluate`` from
the committed checkpoint against the JAX ``Experiment.evaluate``.

Tolerances: metrics equal (the same numpy on the same rows); losses with
``image_mask`` rtol 1e-5; eval losses rtol 1e-4, detections' valid masks
equal and their boxes and scores within 1e-3, mAP equal, with every IoU
between a detection and a ground-truth box of its class at least 1e-4 away
from the 0.5 threshold (checked, so a rounding difference cannot flip a
match); learning rates equal.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from single_shot_detection_tpu.data.loader import Loader as JaxLoader
from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.ops import box_coder as jax_box_coder
from single_shot_detection_tpu.ops import losses as jax_losses
from single_shot_detection_tpu.ops import matching as jax_matching
from single_shot_detection_tpu.ops import metrics as jax_metrics
from single_shot_detection_tpu.ops import sampling as jax_sampling
from single_shot_detection_tpu.train import schedulers as jax_schedulers
from single_shot_detection_tpu.train.engine import Experiment as JaxExperiment
from single_shot_detection_tpu.utils.config import load_config as jax_load_config
from single_shot_detection_tpu_torch.ops import box_coder as pt_box_coder
from single_shot_detection_tpu_torch.ops import losses as pt_losses
from single_shot_detection_tpu_torch.ops import metrics as pt_metrics
from single_shot_detection_tpu_torch.ops import sampling as pt_sampling
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.config import load_config
from _torch_port_fixtures import one_torch_thread  # noqa: F401

SMOKE = 'samples/synthetic_smoke.py'
FLAGSHIP = 'samples/ssd_mb2_voc.py'
CKPT_DIR = 'experiments/2026-08-16-225820'   # SMOKE's model, trained
CKPT_CONFIG = f'{CKPT_DIR}/config.py'
MULTISTEP = {'name': 'MultiStepLR', 'milestones': [2, 3], 'gamma': 0.1}
EVAL_SET = {'name': 'Synthetic', 'num_images': 13, 'image_size': 128,
            'num_classes': 5, 'max_boxes': 3, 'seed': 2}


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------- metrics

def metric_rows(seed, n_images=12, n_classes=4, difficult=True):
    """Ground truth per image and noisy, partly duplicated predictions."""
    rs = np.random.RandomState(seed)
    gts, preds = [], []
    for i in range(n_images):
        g = rs.randint(0, 5)
        xy = rs.rand(g, 2) * 200
        wh = rs.rand(g, 2) * 80 + 5
        rows = np.concatenate([xy, xy + wh, rs.randint(1, n_classes + 1, (g, 1)),
                               np.ones((g, 1))], 1)
        if difficult:
            rows = np.concatenate([rows, (rs.rand(g, 1) < 0.2)], 1)
        gts.append(rows.astype(np.float32))
        for row in rows:
            for _ in range(rs.randint(0, 3)):
                box = row[:4] + rs.randn(4) * 6
                preds.append([i, *box, row[4], rs.rand()])
        for _ in range(rs.randint(0, 3)):   # false positives
            xy = rs.rand(2) * 200
            preds.append([i, *xy, *(xy + 30), rs.randint(1, n_classes + 1), rs.rand()])
    return np.asarray(preds, np.float64).reshape(-1, 7), gts


@pytest.mark.parametrize('name,kwargs', [
    ('voc', dict(iou_threshold=0.5, voc=True)),
    ('continuous', dict(iou_threshold=0.6, voc=False)),
    ('coco', dict(extended=False)),
    ('coco_extended', dict(extended=True)),
    ('loop_voc', dict(iou_threshold=0.5, voc=True)),
    ('no_difficult', dict(iou_threshold=0.5, voc=True)),
])
def test_metrics_match_jax(name, kwargs):
    preds, gts = metric_rows(3, difficult=name != 'no_difficult')
    labels = {i: f'c{i}' for i in range(5)}
    if name.startswith('coco'):
        got = pt_metrics.coco_mean_average_precision(preds, gts, **kwargs)
        want = jax_metrics.coco_mean_average_precision(preds, gts, **kwargs)
        assert got == want and len(got) == (3 if name == 'coco' else 12)
        return
    fn = 'mean_average_precision_loop' if name.startswith('loop') else \
        'mean_average_precision'
    got = getattr(pt_metrics, fn)(preds, gts, labels, **kwargs)
    want = getattr(jax_metrics, fn)(preds, gts, labels, **kwargs)
    assert got == want and 0.0 < got < 1.0
    assert pt_metrics.mean_average_precision_loop(preds, gts, labels, **kwargs) == \
        pytest.approx(got, abs=1e-12)
    assert set(pt_metrics.METRICS) == set(jax_metrics.METRICS)


# ------------------------------------------------------------------ loss

def test_multibox_loss_image_mask_matches_jax_and_ignores_padding():
    """Padded images (``image_mask`` False) add neither loss nor mined
    negatives: the loss over [real, padded, real] equals the loss over the
    two real images alone."""
    rng = np.random.RandomState(4)
    a = 200
    cxy = rng.rand(a, 2) * 128
    anchors = np.concatenate([cxy, rng.rand(a, 2) * 60 + 4], 1).astype(np.float32)
    xy = rng.rand(3, 4, 2) * 90
    gt = np.concatenate([xy, xy + rng.rand(3, 4, 2) * 50 + 8,
                         rng.randint(1, 5, (3, 4, 1)), np.ones((3, 4, 1))], -1)
    gt = gt.astype(np.float32)
    mask = np.array([[1, 1, 0, 0], [0, 0, 0, 0], [1, 1, 1, 0]], bool)
    target = np.asarray(jax_matching.TargetAssigner(0.5, 0.4)(
        jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(anchors)))
    scores = rng.randn(3, a, 5).astype(np.float32)
    locs = rng.randn(3, a, 4).astype(np.float32)
    image_mask = np.array([True, False, True])
    cfg = dict(classification_loss={'name': 'CrossEntropyLoss'},
               localization_loss={'name': 'SmoothL1Loss'})
    sampler = dict(negative_per_positive_ratio=3, min_negative_per_image=5)
    crit_j = jax_losses.MultiboxLoss(
        jax_sampling.build_sampler('hard_negative_mining', **sampler),
        jax_box_coder.BoxCoder(10.0, 5.0), **cfg)
    crit_p = pt_losses.MultiboxLoss(
        pt_sampling.build_sampler('hard_negative_mining', **sampler),
        pt_box_coder.BoxCoder(10.0, 5.0), **cfg)
    want = crit_j(jnp.asarray(scores), jnp.asarray(locs), jnp.asarray(anchors),
                  jnp.asarray(target), image_mask=jnp.asarray(image_mask))
    got = crit_p(t(scores), t(locs), t(anchors), t(target), image_mask=t(image_mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    real = [0, 2]
    alone = crit_p(t(scores[real]), t(locs[real]), t(anchors), t(target[real]))
    for g, w in zip(got, alone):
        np.testing.assert_allclose(g.item(), w.item(), rtol=1e-6)
    unmasked = crit_p(t(scores), t(locs), t(anchors), t(target))
    assert unmasked[1].item() > got[1].item()  # padding would add negatives


# -------------------------------------------------------------- schedule

def test_lr_milestones_in_epochs_of_the_train_loader():
    """The flagship's MultiStepLR milestones count epochs of ``len(loader)``
    steps, as the JAX schedule built with the JAX loader's length."""
    dataset = {'train': {'name': 'Synthetic', 'num_images': 37, 'image_size': 64,
                         'num_classes': 21, 'max_boxes': 2, 'seed': 1}}
    exp = Experiment(FLAGSHIP, phases=('train',), device='cpu', overrides={
        'dataset': dataset, 'batch_size': 4, 'input_size': (64, 64),
        'train': {'epochs': 4, 'scheduler': MULTISTEP}})
    cfg = jax_load_config(FLAGSHIP, phases=('train',))
    from single_shot_detection_tpu.data.datasets import Synthetic
    spec = {k: v for k, v in dataset['train'].items() if k != 'name'}
    steps = len(JaxLoader(Synthetic(**spec), 4, (64, 64), drop_last=True))
    assert steps == len(exp.loaders['train']) == 9
    schedule, _, _ = jax_schedulers.create_lr_schedule(
        MULTISTEP, cfg.train['optimizer']['lr'], steps)
    for step in (0, 17, 18, 19, 26, 27, 35):
        assert exp.trainer.schedule(step) == pytest.approx(float(schedule(step)),
                                                           rel=1e-6), step
    assert exp.trainer.schedule(17) == pytest.approx(1e-3)
    assert exp.trainer.schedule(18) == pytest.approx(1e-4)
    assert exp.trainer.schedule(27) == pytest.approx(1e-5)
    # a Trainer without a loader counts one step per epoch
    assert Trainer.from_config(FLAGSHIP, device='cpu', overrides={
        'input_size': (64, 64), 'train': {'scheduler': MULTISTEP}}).schedule(2) \
        == pytest.approx(1e-4)


def test_flagship_trainer_takes_an_augmented_step():
    """The flagship as shipped (its augmentation chain), at a small input
    size: one step, finite losses."""
    cfg = load_config(FLAGSHIP)
    assert len(cfg.augmentations) == 7
    trainer = Trainer.from_config(FLAGSHIP, device='cpu', overrides={
        'input_size': (96, 96)})
    assert [k for k, _ in trainer.pipeline.stages][-1] == 'hflip'
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    boxes = np.array([[[10, 10, 60, 70, 3, 1, 0]], [[5, 30, 90, 80, 12, 1, 1]]],
                     np.float32)
    metrics = trainer.train_step(images, boxes, np.ones((2, 1), bool))
    assert all(np.isfinite(v.item()) for v in metrics.values())
    assert trainer.state.step == 1


# ------------------------------------------------------------ experiment

@pytest.fixture(scope='module')
def checkpoint():
    with open(f'{CKPT_DIR}/ckpt-1800.msgpack', 'rb') as f:
        ckpt = serialization.msgpack_restore(f.read())
    return {'params': ckpt['params'], 'batch_stats': ckpt['batch_stats']}


def capture(step_fn, out):
    def wrapped(*args, **kwargs):
        result = step_fn(*args, **kwargs)
        out.append(result)
        return result
    return wrapped


def gt_ious(dets, valid, boxes, mask):
    """IoU of every valid detection with every ground-truth box of its class
    in its image."""
    ious = []
    for d, v, b, m in zip(dets, valid, boxes, mask):
        for row in d[v]:
            for g in b[m]:
                if g[4] != row[4]:
                    continue
                iw = max(0.0, min(row[2], g[2]) - max(row[0], g[0]))
                ih = max(0.0, min(row[3], g[3]) - max(row[1], g[1]))
                inter = iw * ih
                union = ((row[2] - row[0]) * (row[3] - row[1])
                         + (g[2] - g[0]) * (g[3] - g[1]) - inter)
                ious.append(inter / union)
    return np.asarray(ious)


def test_experiment_evaluate_matches_jax(checkpoint, monkeypatch):
    """13 eval images in batches of 8 (the last one partial) from the
    committed checkpoint: losses, detections and mAP against the JAX
    ``Experiment.evaluate``.  The JAX model's initializer runs as one jit
    (op by op it compiles some 370 programs); the checkpoint replaces its
    values."""
    eager_init = jax_builder.DetectorBundle.init

    def jitted_init(self, rng, batch_size=1, img_size=None):
        return jax.jit(lambda key: eager_init(self, key, batch_size, img_size))(rng)
    monkeypatch.setattr(jax_builder.DetectorBundle, 'init', jitted_init)
    cfg = jax_load_config(CKPT_CONFIG, phases=('eval',))
    cfg.config.dataset = {'eval': dict(EVAL_SET)}
    cfg.config.batch_size = 4
    cfg.config.model['detector']['weight'] = f'{CKPT_DIR}/ckpt-1800.msgpack'
    jax_exp = JaxExperiment(cfg, phases=('eval',))
    jax_steps = []
    jax_exp.eval_step = capture(jax_exp.eval_step, jax_steps)
    want = jax_exp.evaluate()

    exp = Experiment(CKPT_CONFIG, phases=('eval',), device='cpu',
                     variables=checkpoint, overrides={
                         'dataset': {'eval': dict(EVAL_SET)}, 'batch_size': 4,
                         'train': {'scheduler': MULTISTEP}})
    steps = []
    exp.eval_step = capture(exp.eval_step, steps)
    got = exp.evaluate()

    assert len(exp.loaders['eval']) == len(steps) == len(jax_steps) == 2
    assert set(got) == set(want) >= {'loss', 'mAP', 'mAP@[.5:.95]'}
    for k in ('loss', 'class_loss', 'loc_loss'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    ious = []
    for (_, dets, valid), (_, jdets, jvalid), batch in zip(
            steps, jax_steps, exp.loaders['eval']):
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        np.testing.assert_allclose(dets.numpy(), np.asarray(jdets), rtol=0, atol=1e-3)
        real = batch['ids'] >= 0
        ious.append(gt_ious(dets.numpy()[real], valid.numpy()[real],
                            batch['boxes'][real], batch['box_mask'][real]))
    ious = np.concatenate(ious)
    near = np.abs(ious - 0.5).min()
    assert near > 1e-4, f'an IoU lies within {near:.2g} of the 0.5 threshold'
    for k in want:
        if k.startswith('mAP'):
            assert got[k] == want[k], k
    assert 0.3 < got['mAP'] <= 1.0


def test_experiment_train_returns_epoch_rows_with_eval_map():
    """``Experiment(SMOKE, phases=('train', 'eval'), device='cpu').train()``
    with the ported MultiStepLR: one epoch of 4 augmented steps, then an
    evaluation."""
    exp = Experiment(SMOKE, phases=('train', 'eval'), device='cpu', overrides={
        'train': {'epochs': 2, 'eval_every': 2, 'scheduler': MULTISTEP}})
    assert [k for k, _ in exp.trainer.pipeline.stages] == ['brightness', 'hflip']
    rows = exp.train()
    assert [r['epoch'] for r in rows] == [0, 1]
    assert 'eval_mAP' not in rows[0] and 0.0 <= rows[1]['eval_mAP'] <= 1.0
    assert exp.trainer.state.step == 2 * len(exp.loaders['train']) == 8
    for row in rows:
        assert all(np.isfinite(v) for v in row.values())
    assert {'eval_loss', 'eval_mAP@[.5:.95]', 'train_loss'} <= set(rows[1])


def test_experiment_raises_on_what_is_not_ported(tmp_path, monkeypatch):
    """What the port does not run raises.  The model axis is ported: what
    remains of it are the JAX engine's ``ValueError``s (one process for a
    model axis of 2, two options at once, spatial sharding with YUV420
    staging or a staged height it does not divide), with ``train.pruner``
    and ``int8`` too, which are ported under every option
    (``test_torch_port_model_axis_phases.py`` runs them).  Checkpoints,
    resume, ``ReduceLROnPlateau`` and ``detector.weight`` are ported (their
    tests are in ``test_torch_port_checkpoint.py``), and so are tensorboard,
    the device cache and async checkpoints
    (``test_torch_port_run_extras.py``), ``detector.torch_weight``
    (``test_torch_port_interop.py``), and ``process_count > 1`` and
    ``train.zero_sharding`` (``test_torch_port_multiprocess.py``), which
    raised before."""
    over = {'train': {'scheduler': MULTISTEP}}
    for key in ('tensor_sharding', 'spatial_sharding', 'pipeline_sharding'):
        with pytest.raises(ValueError, match='needs at least 2 processes'):
            Experiment(SMOKE, device='cpu', overrides={
                'train': {**over['train'], key: 2}})
        with pytest.raises(ValueError, match='needs at least 2 processes'):
            Experiment(SMOKE, device='cpu', int8=True, overrides={
                'train': {**over['train'], key: 2,
                          'pruner': {'num': 2}}})
    with pytest.raises(ValueError, match='cannot shard packed YUV420'):
        Experiment(SMOKE, device='cpu', process_count=2, overrides={
            'train': {**over['train'], 'spatial_sharding': 2,
                      'staging_colorspace': 'yuv420'}})
    with pytest.raises(ValueError, match=r'must divide the staged image '
                                         r'height \(128\)'):
        Experiment(SMOKE, device='cpu', process_count=3, overrides={
            'train': {**over['train'], 'spatial_sharding': 3}})
    with pytest.raises(ValueError, match='enable at most one'):
        Experiment(SMOKE, device='cpu', overrides={'train': {
            **over['train'], 'tensor_sharding': 2, 'pipeline_sharding': 2}})
    with pytest.raises(ValueError, match='process_count=2 needs a process'):
        Experiment(SMOKE, device='cpu', overrides=over, process_count=2)
    one = Experiment(SMOKE, device='cpu', overrides={
        'train': {**over['train'], 'zero_sharding': True}})
    assert one.trainer.state.zero is None  # one process: nothing to slice
    # tensorboard's own stand-in for TensorFlow, whose import costs seconds
    monkeypatch.setitem(sys.modules, 'tensorboard.compat.notf',
                        types.ModuleType('tensorboard.compat.notf'))
    ported = Experiment(SMOKE, device='cpu', tensorboard=True,
                        checkpoint_dir=str(tmp_path), overrides={'train': {
                            **over['train'], 'device_cache': True,
                            'async_checkpoint': True}})
    assert ported.device_cache is not None and ported.async_saver is not None
    assert ported.writer is not None
    plateau = {'name': 'ReduceLROnPlateau', 'patience': 0}
    exp = Experiment(SMOKE, phases=('eval',), device='cpu',
                     overrides={'train': {'scheduler': plateau}})
    assert exp.trainer.plateau is not None
    assert exp.trainer.scheduler_metric == 'eval_loss'


def test_is_voc():
    assert load_config(FLAGSHIP).is_voc('eval')
    assert not load_config(SMOKE).is_voc('eval')
    assert not load_config(FLAGSHIP, phases=('train',)).is_voc('eval')
