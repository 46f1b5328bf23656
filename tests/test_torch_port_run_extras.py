"""The run extras of the port's ``Experiment``: the device-resident dataset
(``train.device_cache``), the eval replay cache (``eval.device_cache``),
asynchronous checkpoints (``train.async_checkpoint``) and ``--tensorboard``,
and all of them at once with the YUV420 staging and the staging cache on
the committed JPEG fixtures.

Each is held to the plain run of the same config, bit for bit on the CPU:
weights, buffers, the epoch rows and the evaluation's metrics.  The
tensorboard scalars are held to ``log.csv`` under the JAX engine's tags
(``train/{key}`` for the train row's keys, ``eval/{key}`` for the
evaluation's), stated here rather than run from the JAX engine.
"""

import csv
import logging
import os
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from single_shot_detection_tpu_torch import cli
from single_shot_detection_tpu_torch.data import loader as loader_module
from single_shot_detection_tpu_torch.data import native
from single_shot_detection_tpu_torch.train import checkpoint as ckpt
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.config import load_config

REPO = Path(__file__).resolve().parents[1]
SMOKE = str(REPO / 'samples' / 'synthetic_smoke.py')
FIXTURES = REPO / 'single_shot_detection_tpu_torch' / 'data' / 'jpeg_fixtures'
SYNTHETIC = {'name': 'Synthetic', 'image_size': 128, 'num_classes': 5,
             'max_boxes': 3}
# 28 train images at b8: 3 batches an epoch, 4 rows the fill epoch never sees
DATA = {'train': {**SYNTHETIC, 'num_images': 28, 'seed': 1},
        'eval': {**SYNTHETIC, 'num_images': 12, 'seed': 2}}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    processes, and torch's default of one thread per core makes them
    contend for the CPU, tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope='module')
def tensorboard_without_tensorflow():
    """``tensorboard``'s own TensorFlow stand-in in place of TensorFlow,
    where that is installed: importing it takes seconds of CPU that the
    scalars' writing and reading do not need."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, 'tensorboard.compat.notf',
                   types.ModuleType('tensorboard.compat.notf'))
        yield


@pytest.fixture
def staged(monkeypatch):
    """Counts the loader batches staged from then on."""
    calls = []
    real = loader_module.Loader._make_batch

    def counted(self, idxs, pool):
        calls.append(len(idxs))
        return real(self, idxs, pool)

    monkeypatch.setattr(loader_module.Loader, '_make_batch', counted)
    return calls


def experiment(train=None, phases=('train', 'eval'), evaluation=None, **kw):
    overrides = {'dataset': DATA,
                 'train': {'epochs': 2, 'eval_every': 1, **(train or {})}}
    if evaluation is not None:
        overrides['eval'] = evaluation
    return Experiment(SMOKE, phases=phases, device='cpu', overrides=overrides,
                      **kw)


def assert_same_state(a: Experiment, b: Experiment):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key
    assert a.trainer.state.step == b.trainer.state.step


@pytest.mark.parametrize('fused_steps', [1, 2])
def test_device_cached_training_equals_streamed(fused_steps, staged):
    """Two epochs with ``train.device_cache`` equal two streamed ones bit for
    bit, unfused and with ``fused_steps`` 2 (one pair and a single a
    cached epoch); the cached epoch stages nothing and the fill epoch's
    finalize stages the 4 rows ``drop_last`` cut."""
    train = {'fused_steps': fused_steps, 'eval_every': 2}
    plain = experiment(train)
    plain_rows = plain.train()
    staged.clear()
    cached = experiment({**train, 'device_cache': True})
    rows = []
    for epoch in range(2):
        before = len(staged)
        rows.append(cached.train_epoch(epoch))
        if epoch == 0:
            assert cached.device_cache.ready and cached.device_cache.topped_up == 4
            assert staged[before:] == [8, 8, 8, 4]
        else:
            assert staged[before:] == []
    assert rows == [{k: v for k, v in r.items() if not k.startswith('eval')}
                    for r in plain_rows]
    assert_same_state(cached, plain)
    # the same through train(), with an evaluation after the second epoch
    again = experiment({**train, 'device_cache': True})
    assert again.train() == plain_rows
    assert_same_state(again, plain)


def test_eval_replay_equals_a_streamed_evaluation(staged):
    """The first evaluation keeps its device batches; the second replays
    them without the loader, with the same metrics, which equal a
    streamed evaluation's."""
    exp = experiment({'device_cache': True})
    first = exp.evaluate()
    assert exp._eval_cache is not None and len(exp._eval_cache) == 1
    staged.clear()
    assert exp.evaluate() == first
    assert staged == []
    assert experiment().evaluate() == first


def test_eval_replay_alone_on_an_eval_only_experiment(staged):
    exp = experiment(phases=('eval',), evaluation={'device_cache': True})
    assert exp.device_cache is None
    first = exp.evaluate()
    staged.clear()
    assert exp.evaluate() == first and staged == []


def test_eval_replay_respects_the_joint_budget(staged, caplog):
    """The replay cache charges against ``max_bytes`` less the train
    cache's bytes: one byte short of room for the eval batch, it warns and
    streams every evaluation."""
    train_bytes = 28 * (128 * 128 * 3 + 8 * 7 * 4 + 8)
    eval_bytes = 16 * (128 * 128 * 3 + 8 * 7 * 4 + 8 + 8)  # ids: int64
    for room, replays in ((0, True), (-1, False)):
        exp = experiment({'device_cache': {
            'max_bytes': train_bytes + eval_bytes + room}})
        assert exp.device_cache.total_bytes == train_bytes
        with caplog.at_level(logging.WARNING):
            first = exp.evaluate()
            staged.clear()
            assert exp.evaluate() == first
        assert (exp._eval_cache is not None) == replays
        assert (staged == []) == replays
        warned = [r for r in caplog.records if 'replay cache over budget'
                  in r.message]
        assert bool(warned) != replays
        caplog.clear()


def test_async_checkpoints_equal_synchronous_ones(tmp_path):
    """Scheduled saves on the background thread write what synchronous
    saves write: each file loads bit-equal, and ``train()`` returns with
    the last one on disk."""
    runs = {}
    for name, train in (('sync', {}), ('async', {'async_checkpoint': True})):
        exp = experiment(train, checkpoint_dir=str(tmp_path / name))
        exp.train()
        runs[name] = exp
        assert (exp.async_saver is not None) == (name == 'async')
    names = sorted(os.listdir(tmp_path / 'sync'))
    assert names == sorted(os.listdir(tmp_path / 'async'))
    assert {'ckpt-3.pt', 'ckpt-6.pt', 'log.csv'} <= set(names)
    for name in names:
        if name.endswith('.pt'):
            a = torch.load(tmp_path / 'sync' / name, weights_only=True)
            b = torch.load(tmp_path / 'async' / name, weights_only=True)
            assert_trees_equal(a, b)
    assert runs['async'].async_saver.path == str(tmp_path / 'async' / 'ckpt-6.pt')


def assert_trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    else:
        assert a == b


def test_async_snapshot_holds_the_state_at_the_save(tmp_path, monkeypatch):
    """A step taken while the write is held back does not reach the file:
    the snapshot is a copy of the state at the save."""
    trainer = Trainer.from_config(SMOKE, device='cpu')
    rng = np.random.RandomState(0)
    batch = (rng.randint(0, 256, (2, 128, 128, 3), dtype=np.uint8),
             np.tile(np.array([[10, 10, 60, 70, 1, 1]], np.float32), (2, 1, 1)),
             np.ones((2, 1), bool))
    trainer.train_step(*batch)
    want = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    gate = threading.Event()
    real_write = ckpt.write

    def held_write(*args):
        gate.wait(30)
        return real_write(*args)

    monkeypatch.setattr(ckpt, 'write', held_write)
    saver = ckpt.AsyncSaver()
    saver.save(str(tmp_path), trainer.state, 0)
    trainer.train_step(*batch)  # moves every parameter in place
    gate.set()
    saver.wait()
    saved = torch.load(saver.path, weights_only=True)
    assert saved['step'] == 1
    moved = 0
    for k, v in want.items():
        assert torch.equal(saved['model'][k], v), k
        moved += not torch.equal(trainer.model.state_dict()[k], v)
    assert moved > 100


def test_async_failure_surfaces_at_wait_and_leaves_no_tmp(tmp_path, monkeypatch):
    trainer = Trainer.from_config(SMOKE, device='cpu')

    def broken_save(obj, path):
        with open(path, 'wb') as f:
            f.write(b'half a checkpoint')
        raise OSError('disk full')

    monkeypatch.setattr(ckpt.torch, 'save', broken_save)
    saver = ckpt.AsyncSaver()
    saver.save(str(tmp_path), trainer.state, 0)
    with pytest.raises(OSError, match='disk full'):
        saver.wait()
    saver.wait()  # reported once
    assert os.listdir(tmp_path) == []
    # through train(): the failure of the last save raises from train()
    exp = experiment({'async_checkpoint': True, 'epochs': 1},
                     checkpoint_dir=str(tmp_path / 'run'))
    with pytest.raises(OSError, match='disk full'):
        exp.train()
    assert sorted(os.listdir(tmp_path / 'run')) == ['log.csv']


def event_scalars(directory):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(str(directory))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()['scalars']}


def csv_rows(path):
    with open(path, newline='') as f:
        return list(csv.DictReader(f))


def test_tensorboard_scalars_equal_log_csv(tmp_path):
    """``tensorboard=True`` writes each epoch's row under the JAX engine's
    tags: ``train/train_loss`` ... for the train row, ``eval/loss``,
    ``eval/mAP`` ... for the evaluation; each value equals ``log.csv``'s at
    float32."""
    pytest.importorskip('tensorboard')
    exp = experiment(checkpoint_dir=str(tmp_path), tensorboard=True)
    exp.train()
    scalars = event_scalars(tmp_path)
    rows = csv_rows(tmp_path / 'log.csv')
    assert len(rows) == 2
    want = {}
    for row in rows:
        for key, value in row.items():
            if key == 'epoch':
                continue
            tag = ('train/' + key if key.startswith('train_')
                   else 'eval/' + key[len('eval_'):])
            want.setdefault(tag, []).append(
                (int(row['epoch']), float(np.float32(value))))
    assert {'train/train_loss', 'train/train_class_loss', 'train/train_loc_loss',
            'eval/loss', 'eval/mAP', 'eval/mAP@[.5:.95]'} <= set(want)
    assert scalars == want


def test_no_tensorboard_package_warns_and_runs(tmp_path, monkeypatch, caplog):
    import builtins
    real_import = builtins.__import__

    def blocked(name, *args, **kwargs):
        if name.startswith('torch.utils.tensorboard'):
            raise ImportError('No module named tensorboard')
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, '__import__', blocked)
    with caplog.at_level(logging.WARNING):
        exp = experiment({'epochs': 1}, checkpoint_dir=str(tmp_path),
                         tensorboard=True)
    assert exp.writer is None
    assert [r for r in caplog.records if 'tensorboard unavailable' in r.message]
    exp.train()
    assert not [n for n in os.listdir(tmp_path) if 'tfevents' in n]


def fixture_config(tmp_path, train):
    """The smoke model on the JPEG fixtures at 128 px (21 VOC classes)."""
    detector = dict(load_config(SMOKE).model['detector'], num_classes=21)
    voc = {'name': 'Voc', 'root': str(FIXTURES)}
    return {'model': {**load_config(SMOKE).model, 'detector': detector},
            'dataset': {'train': {**voc, 'image_sets': [(2007, 'all')]},
                        'eval': {**voc, 'image_sets': [(2007, 'all')]}},
            'train': {'epochs': 3, 'eval_every': 1, 'staging_size': (160, 160),
                      'staging_colorspace': 'yuv420', **train}}


def test_every_option_at_once_equals_the_plain_yuv_run(tmp_path, staged):
    """On the JPEG fixtures at yuv420: the staging cache, the device cache,
    the eval replay cache, async checkpoints and tensorboard at once give
    the weights, rows and checkpoints of the run with none of them; epochs
    1 and 2 stage nothing, and a second run reads the staging cache."""
    plain = Experiment(SMOKE, device='cpu', checkpoint_dir=str(tmp_path / 'p'),
                       overrides=fixture_config(tmp_path, {}))
    assert plain.loaders['train'].staging_colorspace == 'yuv420'
    assert plain.trainer.pipeline.staging_yuv == (160, 160)
    assert plain.eval_pipeline.staging_yuv == (160, 160)
    want = plain.train()
    options = {'staging_cache': str(tmp_path / 'stage'), 'device_cache': True,
               'async_checkpoint': True}
    for run in ('a', 'b'):
        staged.clear()
        decoded = dict(native.COUNTS)
        exp = Experiment(SMOKE, device='cpu', tensorboard=True,
                         checkpoint_dir=str(tmp_path / run),
                         overrides=fixture_config(tmp_path, options))
        assert exp.train() == want
        assert_same_state(exp, plain)
        # epoch 0 only: 2 train batches (no row left to top up) and the
        # eval batch; run "b" reads them all from the staging cache
        assert staged == [8, 8, 16]
        assert exp.loaders['train'].cache.complete
        assert (native.COUNTS == decoded) == (run == 'b')
        for name in ('ckpt-2.pt', 'ckpt-6.pt'):
            assert_trees_equal(
                torch.load(tmp_path / run / name, weights_only=True),
                torch.load(tmp_path / 'p' / name, weights_only=True))
    pytest.importorskip('tensorboard')
    assert len(event_scalars(tmp_path / 'a')['eval/mAP']) == 3


def test_cli_tensorboard_writes_events(tmp_path):
    pytest.importorskip('tensorboard')
    exp, rows = cli.main(['--cpu', '--config', SMOKE, '--save-dir',
                          str(tmp_path), '--tensorboard'])
    assert exp.writer is not None
    run_dir = Path(exp.checkpoint_dir)
    assert [n for n in os.listdir(run_dir) if 'tfevents' in n]
    assert len(event_scalars(run_dir)['train/train_loss']) == len(rows)
