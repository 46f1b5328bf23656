"""The port's command line, ``python -m single_shot_detection_tpu_torch``
(``cli.py``), against the JAX package's ``main.py``: the train and eval
phases of ``samples/synthetic_smoke.py`` with its own schedule, the files
they write, a resume with more epochs, ``--debug``, ``--load-weights``
with ``--profile``, ``embed``, the evaluation of the committed JAX
checkpoint against ``Experiment.evaluate()`` from the flax-restored
weights (exactly equal), and the flags not ported yet (``--bf16`` and
``--matmul-precision`` run in ``test_torch_port_precision.py``, the ``test``
and ``export`` phases in ``test_torch_port_deploy.py``); and the emergency
checkpoint of ``Experiment.train()`` on an interrupt.  Everything runs on
the CPU.
"""

import json
import logging
import os
import signal

import pytest
import torch
from flax import serialization

from single_shot_detection_tpu_torch import cli
from single_shot_detection_tpu_torch.train.engine import Experiment

SMOKE = 'samples/synthetic_smoke.py'
CKPT_DIR = 'experiments/2026-08-16-225820'
CKPT_CONFIG = f'{CKPT_DIR}/config.py'


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    processes, and torch's default of one thread per core makes them
    contend for the CPU, tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def root_logger():
    """``cli.main`` configures the root logger as ``main.py`` does (a
    handler on this test's captured stdout, DEBUG with ``--debug``); put it
    back for the tests that follow in this process."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    root.handlers[:] = handlers
    root.setLevel(level)


def listing(root):
    """Every file under ``root`` with its size and modification time."""
    return sorted((os.path.join(d, f), os.stat(os.path.join(d, f)).st_size,
                   os.stat(os.path.join(d, f)).st_mtime_ns)
                  for d, _, files in os.walk(root) for f in files)


def smoke_config(path, **train):
    """SMOKE with ``train`` entries replaced, written to ``path``."""
    text = open(SMOKE).read()
    for key, value in train.items():
        old = {'epochs': "'epochs': 3,", 'eval_every': "'eval_every': 3,"}[key]
        assert old in text
        text = text.replace(old, f"'{key}': {value},")
    path.write_text(text)
    return str(path)


def test_cli_trains_writes_its_files_and_resumes(tmp_path):
    """train+eval of SMOKE writes ``ckpt-12.pt``, its ``.meta.json``,
    ``log.csv``, ``train.log`` and ``config.py`` into a timestamped
    directory; a second call with ``--checkpoint`` on it and a config with
    more epochs starts at epoch 3."""
    exp, rows = cli.main(['--cpu', '--config', SMOKE, '--phases', 'train', 'eval',
                          '--save-dir', str(tmp_path)])
    (run,) = os.listdir(tmp_path)
    run_dir = tmp_path / run
    assert exp.checkpoint_dir == str(run_dir)
    assert sorted(os.listdir(run_dir)) == [
        'ckpt-12.pt', 'ckpt-12.pt.meta.json', 'config.py', 'log.csv', 'train.log']
    assert (run_dir / 'config.py').read_text() == open(SMOKE).read()
    assert [r['epoch'] for r in rows] == [0, 1, 2] and 'eval_mAP' in rows[2]
    assert 'Saved checkpoint' in (run_dir / 'train.log').read_text()

    config = smoke_config(run_dir / 'config.py', epochs=4, eval_every=1)
    exp, rows = cli.main(['--cpu', '--config', config, '--checkpoint', str(run_dir)])
    assert exp.start_epoch == 3 and [r['epoch'] for r in rows] == [3]
    assert exp.trainer.state.step == 16
    assert 'ckpt-16.pt' in os.listdir(run_dir) and len(os.listdir(tmp_path)) == 1
    lines = (run_dir / 'log.csv').read_text().splitlines()
    assert [line.split(',')[0] for line in lines[1:]] == ['0', '1', '2', '3']
    log = (run_dir / 'train.log').read_text()
    assert 'Restored checkpoint' in log and 'Epoch: 3/3' in log
    assert 'Epoch: 0/' not in log.split('Restored checkpoint')[1]


def test_cli_debug_writes_nothing(tmp_path):
    """``--debug`` trains without writing; ``--matmul-precision highest``
    and ``--compilation-cache off`` are accepted."""
    config = smoke_config(tmp_path / 'one_epoch.py', epochs=1)
    exp, rows = cli.main(['--cpu', '--debug', '--config', config,
                          '--save-dir', str(tmp_path / 'save'),
                          '--matmul-precision', 'highest',
                          '--compilation-cache', 'off'])
    assert [r['epoch'] for r in rows] == [0] and exp.debug
    assert sorted(os.listdir(tmp_path)) == ['one_epoch.py']


def test_cli_load_weights_profile_and_embed(tmp_path, monkeypatch):
    """``--load-weights`` from the committed JAX checkpoint into a fresh
    directory (``--new-checkpoint``): the optimizer starts fresh at step 0
    from the trained weights, a ``torch.profiler`` trace lands in the
    ``--profile`` directory, and ``experiments/`` is untouched; ``embed``
    opens a shell with the experiment."""
    before = listing('experiments')
    config = smoke_config(tmp_path / 'one_epoch.py', epochs=1)
    exp, rows = cli.main(['--cpu', '--config', config, '--checkpoint', CKPT_DIR,
                          '--load-weights', '--new-checkpoint', '--phases', 'train',
                          '--save-dir', str(tmp_path / 'save'),
                          '--profile', str(tmp_path / 'trace')])
    assert exp.start_epoch == 0 and exp.trainer.state.step == 4
    assert rows[0]['train_loss'] < 6.0  # from scratch it is about 12
    assert os.listdir(tmp_path / 'trace')[0].endswith('.pt.trace.json')
    (run,) = os.listdir(tmp_path / 'save')
    assert 'ckpt-4.pt' not in os.listdir(tmp_path / 'save' / run)  # save_every 3
    assert listing('experiments') == before

    seen = {}
    monkeypatch.setattr('code.interact', lambda local: seen.update(local))
    exp, result = cli.main(['--cpu', '--config', SMOKE, '--phases', 'embed'])
    assert result is None and seen['experiment'] is exp and 'cfg' in seen


def test_cli_evaluates_the_committed_jax_checkpoint_exactly():
    """``--checkpoint experiments/2026-08-16-225820 --phases eval`` gives
    exactly the losses and mAP of ``Experiment.evaluate()`` on the
    flax-restored weights, and leaves ``experiments/`` as it was."""
    before = listing('experiments')
    exp, got = cli.main(['--cpu', '--config', CKPT_CONFIG, '--checkpoint',
                         CKPT_DIR, '--phases', 'eval'])
    assert listing('experiments') == before
    assert exp.trainer.state.step == 1800 and exp.start_epoch == 150
    with open(f'{CKPT_DIR}/ckpt-1800.msgpack', 'rb') as f:
        raw = serialization.msgpack_restore(f.read())
    want = Experiment(CKPT_CONFIG, phases=('eval',), device='cpu', variables={
        'params': raw['params'], 'batch_stats': raw['batch_stats']}).evaluate()
    assert got == want
    assert got['loss'] == pytest.approx(4.24824, abs=1e-5)
    assert got['mAP'] == pytest.approx(0.66936, abs=1e-5)


@pytest.mark.parametrize('argv', [
    ['--tensorboard'],
    ['train.tensor_sharding'], ['train.spatial_sharding'],
    ['train.pipeline_sharding'], ['--compilation-cache', 'cache_dir'],
], ids=lambda argv: ' '.join(argv))
def test_cli_raises_on_what_is_not_ported(argv, tmp_path):
    """An XLA cache raises ``NotImplementedError`` before anything is
    written, and a config whose model-axis option is larger than the
    process count the JAX engine's ``ValueError`` (the model axis is
    ported; ``test_torch_port_{tensor_sharding,pipeline,spatial}.py`` run
    it);
    ``--tensorboard`` is ported and passes the check (its run is held to
    ``log.csv`` in ``test_torch_port_run_extras.py``), and so are the three
    distributed flags since they were retired from here
    (``test_torch_port_multiprocess.py`` starts a run with them)."""
    if argv == ['--tensorboard']:
        args = cli.get_argparser().parse_args(['--config', SMOKE, *argv])
        cli.check_ported(args)
        assert args.tensorboard
        return
    save = tmp_path / 'runs'
    save.mkdir()
    config = SMOKE
    if argv[0].startswith('train.'):
        config = str(tmp_path / 'model_axis.py')
        with open(SMOKE) as f, open(config, 'w') as out:
            out.write(f.read() + f"\ntrain = {{**train, '{argv[0][6:]}': 2}}\n")
        argv = []
    error = ((ValueError, 'needs at least 2 processes, have 1') if
             config != SMOKE else (NotImplementedError, 'no XLA'))
    with pytest.raises(error[0], match=error[1]):
        cli.main(['--cpu', '--config', config, '--save-dir', str(save), *argv])
    assert not os.listdir(save)


def test_cli_without_a_gpu_raises(tmp_path):
    """Without ``--cpu`` the run is on ``cuda``: with no card it raises
    before anything is written (``--debug``)."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        cli.main(['--debug', '--config', SMOKE, '--save-dir', str(tmp_path)])


@pytest.mark.parametrize('signal_kind', ['KeyboardInterrupt', 'SIGTERM'])
def test_interrupt_saves_an_emergency_checkpoint(tmp_path, signal_kind):
    """An interrupt at the second step of epoch 1 (a ``KeyboardInterrupt``,
    or SIGTERM turned into one) leaves ``ckpt-5.pt`` of epoch 1 and puts
    the SIGTERM handler back; a resume from it starts at epoch 2."""
    exp = Experiment(SMOKE, device='cpu', checkpoint_dir=str(tmp_path))
    step = exp.trainer.train_step
    calls = []

    def interrupted(*args, **kwargs):
        calls.append(1)
        if len(calls) == 6:
            if signal_kind == 'SIGTERM':
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                raise KeyboardInterrupt
        return step(*args, **kwargs)

    exp.trainer.train_step = interrupted
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(KeyboardInterrupt):
        exp.train()
    assert signal.getsignal(signal.SIGTERM) is before
    assert sorted(os.listdir(tmp_path)) == [
        'ckpt-5.pt', 'ckpt-5.pt.meta.json', 'log.csv']
    with open(tmp_path / 'ckpt-5.pt.meta.json') as f:
        assert json.load(f) == {'epoch': 1, 'global_step': 5}
    resumed = Experiment(SMOKE, device='cpu', checkpoint_dir=str(tmp_path),
                         resume_from=str(tmp_path))
    assert resumed.start_epoch == 2 and resumed.trainer.state.step == 5
    rows = resumed.train()
    assert [r['epoch'] for r in rows] == [2] and 'eval_mAP' in rows[0]
    assert resumed.trainer.state.step == 9
    lines = (tmp_path / 'log.csv').read_text().splitlines()
    assert [line.split(',')[0] for line in lines[1:]] == ['0', '2']
