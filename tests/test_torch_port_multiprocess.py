"""The port's ``Experiment`` and CLI in two processes on the CPU (gloo,
``_torch_dist.py``), against the port's one-process run, and its
per-process loader order against the JAX loader's.

The config is JAX ``tests/test_multihost.py``'s (no augmentation, 8
synthetic 64 px images, per-process batch 4 against one process at 8), and
so are the tolerances: train loss rel 1e-4, the parameters' digest rel
1e-5, eval mAP abs 1e-3; both ranks report the same numbers.  A device-
cached run equals the streamed one bit for bit, and a ZeRO-1 run the plain
one.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from _torch_dist import digest, start, start_cli
from single_shot_detection_tpu.data.loader import Loader as JaxLoader
from single_shot_detection_tpu_torch.data.loader import Loader
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.utils.config import load_config

N = 2
CFG = """
seed = 23
model = {
    'base': {'name': 'mobilenet_v2', 'depth_multiplier': 0.35},
    'detector': {
        'num_classes': 5,
        'use_depthwise': True,
        'features': {'name': 'Features', 'out_layers': (13, 18)},
        'extras': {'layers': (('s', 128),)},
    },
    'anchor_generator': {'type': 'ssd', 'num_scales': 3, 'min_scale': 0.15,
                         'max_scale': 0.95, 'aspect_ratios': [[1.0, 2.0]] * 3},
}
box_coder = {'xy_scale': 10.0, 'wh_scale': 5.0}
sampler = {'name': 'hard_negative_mining',
           'negative_per_positive_ratio': 3, 'min_negative_per_image': 5}
loss = {
    'classification_loss': {'name': 'CrossEntropyLoss'},
    'localization_loss': {'name': 'SmoothL1Loss'},
}
postprocess = {'score_threshold': 0.1, 'max_total': 10,
               'nms': {'max_per_class': 5, 'overlap_threshold': 0.5},
               'score_converter': 'SOFTMAX'}
target_assigner = {'matched_threshold': 0.5, 'unmatched_threshold': 0.5}
augmentations = []
preprocessing = [{'name': 'ToFloatTensor', 'args': {'normalize': True}}]
input_size = (64, 64)
dataset = {
    'train': {'name': 'Synthetic', 'num_images': 8, 'image_size': 64,
              'num_classes': 5, 'max_boxes': 2, 'seed': 1},
    'eval': {'name': 'Synthetic', 'num_images': 8, 'image_size': 64,
             'num_classes': 5, 'max_boxes': 2, 'seed': 2},
}
batch_size = BATCH
shuffle = False
num_workers = 1
train = {'epochs': 1, 'eval_every': 1, 'max_gt': 4, 'transfer_ahead': 0,
         'optimizer': {'name': 'SGD', 'lr': 1e-3, 'momentum': 0.9}}
"""
ADAM = "'optimizer': {'name': 'Adam', 'lr': 1e-3}"


def config(tmp, name: str, batch: int = 4, **replace) -> str:
    text = CFG.replace('BATCH', str(batch))
    for old, new in replace.items():
        assert old in text, old
        text = text.replace(old, new)
    path = os.path.join(str(tmp), f'{name}.py')
    with open(path, 'w') as f:
        f.write(text)
    return path


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    processes, and torch's default of one thread per core makes them
    contend for the CPU, tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    """The two-process CLI runs, started before anything else: ``{name:
    (directory, wait)}``."""
    runs = {}
    tmp = tmp_path_factory.mktemp('cli')
    runs['plain'] = tmp, start_cli(
        ['--config', config(tmp, 'cli'), '--save-dir', str(tmp / 'runs')], tmp)
    # int8: one image for the test phase, no display, frames under TMPDIR
    tmp = tmp_path_factory.mktemp('cli_int8')
    from PIL import Image
    (tmp / 'frames_in').mkdir()
    Image.fromarray((np.random.RandomState(3).rand(80, 96, 3) * 255)
                    .astype(np.uint8)).save(tmp / 'frames_in' / 'a.png')
    cfg = config(tmp, 'int8')
    with open(cfg, 'a') as f:
        f.write(f"int8 = {{}}\nexport = {{'path': "
                f"{str(tmp / 'exported' / 'model')!r}}}\n")
    (tmp / 'tmp').mkdir()
    runs['int8'] = tmp, start_cli(
        ['--config', cfg, '--save-dir', str(tmp / 'runs'), '--int8',
         '--phases', 'train', 'test', 'export', '--video',
         str(tmp / 'frames_in')], tmp,
        env={'TMPDIR': str(tmp / 'tmp'), 'DISPLAY': None,
             'WAYLAND_DISPLAY': None})
    yield runs
    for _, wait in runs.values():  # none left running when a test is
        try:                       # deselected; a failure is its test's
            wait()
        except AssertionError:
            pass


@pytest.fixture(scope='module')
def launched(tmp_path_factory, cli_runs):
    """Every scenario on 2 ranks, in one launch, started first (after the
    CLI runs)."""
    tmp = tmp_path_factory.mktemp('mp')
    cached = {'shuffle = False': 'shuffle = True', "'epochs': 1": "'epochs': 3",
              "'eval_every': 1": "'eval_every': 99"}
    zero = {"'optimizer': {'name': 'SGD', 'lr': 1e-3, 'momentum': 0.9}":
            ADAM + ", 'zero_sharding': True"}
    inputs = {
        'cfg': config(tmp, 'cfg'),
        'cached_cfg': config(tmp, 'cached', **cached, **{
            "'max_gt': 4,": "'max_gt': 4, 'device_cache': True,"}),
        'streamed_cfg': config(tmp, 'streamed', **cached),
        'zero_cfg': config(tmp, 'zero', **zero),
        'plain_cfg': config(tmp, 'plain', **{
            "'optimizer': {'name': 'SGD', 'lr': 1e-3, 'momentum': 0.9}": ADAM}),
        'pruner_cfg': config(tmp, 'pruner', **{
            "'epochs': 1": "'epochs': 2", "'max_gt': 4,": "'max_gt': 4, "
            "'pruner': {'criterion': {'name': 'MeanActivation'}, "
            "'include_paths': ['features'], 'num': 4, 'observe_every': 1},"}),
    }
    finish = start(['experiment', 'device_cache', 'zero_checkpoint',
                    'rank0_writes', 'pruner'], tmp, inputs)
    return finish, inputs, tmp


@pytest.fixture(scope='module')
def one_process(launched):
    """The port's one-process run at the global batch of 8."""
    _, _, tmp = launched
    exp = Experiment(config(tmp, 'single', batch=8), device='cpu', debug=True)
    rows = exp.train()
    return rows, digest(exp.model)


@pytest.fixture(scope='module')
def ranks(launched, one_process):
    finish, inputs, tmp = launched
    return finish(), inputs, tmp


def test_two_processes_match_one_process(ranks, one_process):
    results, _, _ = ranks
    rows, want_digest = one_process
    got = [r['experiment'] for r in results]
    assert got[0]['batches'] == got[1]['batches'] == 1
    for key in ('train_loss', 'eval_loss', 'eval_mAP'):
        assert got[0]['rows'][-1][key] == got[1]['rows'][-1][key], key
    assert got[0]['digest'] == got[1]['digest']
    assert got[0]['rows'][-1]['train_loss'] == pytest.approx(
        rows[-1]['train_loss'], rel=1e-4)
    assert got[0]['rows'][-1]['eval_loss'] == pytest.approx(
        rows[-1]['eval_loss'], rel=1e-4)
    assert got[0]['digest'] == pytest.approx(want_digest, rel=1e-5)
    assert got[0]['rows'][-1]['eval_mAP'] == pytest.approx(
        rows[-1]['eval_mAP'], abs=1e-3)


@pytest.mark.parametrize('processes', [2, 3])
def test_loader_order_matches_jax(processes):
    """Each process's rows (wrap-padded, ``order[r::P]``) and batch count
    equal the JAX loader's, on an odd dataset, with and without shuffling."""
    class Data:
        annotations = [{}] * 11

        def __len__(self):
            return 11

    for shuffle in (False, True):
        for index in range(processes):
            kw = dict(batch_size=2, staging_size=(8, 8), shuffle=shuffle,
                      drop_last=True, seed=5, process_count=processes,
                      process_index=index)
            port, jax_loader = Loader(Data(), **kw), JaxLoader(Data(), **kw)
            for epoch in (0, 3):
                port.epoch = jax_loader.epoch = epoch
                np.testing.assert_array_equal(port._indices(),
                                              jax_loader._indices())
                assert len(port) == len(jax_loader)


def test_device_cache_two_processes_bit_equal(ranks):
    """``train.device_cache`` over 2 processes: each rank keeps its row
    block, later epochs gather every rank's rows with one integer sum, and
    3 shuffled epochs equal the streamed ones bit for bit."""
    results, _, _ = ranks
    for r in range(N):
        cached = results[r]['device_cache']['cached']
        streamed = results[r]['device_cache']['streamed']
        assert cached['ready'] and not streamed['ready']
        assert [row['train_loss'] for row in cached['rows']] == \
            [row['train_loss'] for row in streamed['rows']]
        for name, value in streamed['state_dict'].items():
            assert torch.equal(cached['state_dict'][name], value), name


def test_zero_checkpoints_restore_both_ways(ranks):
    """A ZeRO-1 run's checkpoint (gathered on every rank, written by rank 0)
    equals the plain run's; it restores into a plain run whole, and the
    plain one into a ZeRO run as each rank's slices."""
    results, _, tmp = ranks
    files = {key: torch.load(glob.glob(os.path.join(str(tmp), f'{key}_run',
                                                    'ckpt-*.pt'))[0])
             for key in ('zero', 'plain')}
    for part in ('model', 'ema'):
        assert (files['zero'].get(part) or {}).keys() == \
            (files['plain'].get(part) or {}).keys()
    for name, value in files['plain']['model'].items():
        assert torch.equal(files['zero']['model'][name], value), name
    saved = {key: f['optimizer']['state'] for key, f in files.items()}
    assert saved['zero'].keys() == saved['plain'].keys() and saved['plain']
    for i, buffers in saved['plain'].items():
        for k, v in buffers.items():
            assert torch.equal(saved['zero'][i][k], v), (i, k)
    names = list(files['plain']['model'])
    for r in range(N):
        run = results[r]['zero_checkpoint']
        assert run['zero']['digest'] == run['plain']['digest']
        whole = run['plain_from_zero']
        assert whole['axes'] is None and whole['start_epoch'] == 1
        sliced = run['zero_from_plain']
        assert sliced['start_epoch'] == 1 and any(
            a is not None for a in sliced['axes'].values())
        params = [n for n in names if n in whole['buffers']]
        for i, name in enumerate(params):
            for key, value in whole['buffers'][name].items():
                assert torch.equal(value, saved['zero'][i][key]), (name, key)
                axis = sliced['axes'][name]
                want = value if axis is None else value.narrow(
                    axis, r * (value.shape[axis] // N), value.shape[axis] // N)
                assert torch.equal(sliced['buffers'][name][key], want), (
                    name, key)


def test_only_rank_0_writes(ranks):
    """Each rank was given a checkpoint directory of its own: rank 0's holds
    the checkpoint, its sidecar and ``log.csv``; rank 1's was never made."""
    results, _, _ = ranks
    first, second = (results[r]['rank0_writes']['dir'] for r in range(N))
    assert sorted(os.listdir(first)) == ['ckpt-1.pt', 'ckpt-1.pt.meta.json',
                                         'log.csv']
    assert not os.path.exists(second)


def test_cli_starts_a_two_process_run(cli_runs):
    """``--coordinator-address``, ``--num-processes`` and ``--process-id``:
    two CLI processes train and evaluate one run; process 0 picks and
    writes the run directory, and both report the same evaluation."""
    tmp, wait = cli_runs['plain']
    wait()
    save = tmp / 'runs'
    runs = os.listdir(save)
    assert len(runs) == 1
    run = save / runs[0]
    assert sorted(os.listdir(run)) == ['ckpt-1.pt', 'ckpt-1.pt.meta.json',
                                       'config.py', 'log.csv', 'train.log']
    evals = [[line for line in open(tmp / f'cli{r}.log')
              if line.startswith('[eval]')] for r in range(N)]
    assert len(evals[0]) == 1 and not evals[1]  # progress lines: rank 0
    meta = json.loads((run / 'ckpt-1.pt.meta.json').read_text())
    assert meta == {'epoch': 0, 'global_step': 1}
    cfg_loaded = load_config(str(tmp / 'cli.py'))
    assert cfg_loaded.batch_size == 4


def test_cli_int8_test_and_export_after_train(cli_runs):
    """``--int8 --phases train test export``: no evaluation ran at the last
    step, so the int8 scales are calibrated after training, their maximum
    taken over both ranks; every rank takes part in it before process 0
    alone saves the test frames, and every rank traces the export that
    process 0 writes."""
    tmp, wait = cli_runs['int8']
    wait()
    assert os.listdir(tmp / 'tmp' / 'ssd_torch_frames') == ['00000.png']
    assert os.listdir(tmp / 'exported') == ['model.pt2']
    from single_shot_detection_tpu_torch.export import read_meta
    assert read_meta(str(tmp / 'exported' / 'model.pt2'))['int8'] is True
    for r in range(N):
        log = open(tmp / f'cli{r}.log').read()
        assert '>> int8: calibrated' in log, log[-3000:]


def test_activation_pruning_agrees_across_ranks(ranks):
    """``MeanActivation`` observes the global batch's means (each rank's
    averaged over the ranks), so every rank prunes the same channels."""
    results, _, _ = ranks
    ema = [r['pruner']['ema'] for r in results]
    assert ema[0] and ema[0].keys() == ema[1].keys()
    for key, value in ema[0].items():
        np.testing.assert_array_equal(ema[1][key], value, err_msg=str(key))
    dead = [r['pruner']['dead'] for r in results]
    assert any(dead[0].values()) and dead[1] == dead[0]
    for name, value in results[0]['pruner']['mask'].items():
        assert torch.equal(results[1]['pruner']['mask'][name], value), name
