"""The numeric policy (``device.py``): the matmul/conv precision an
``Experiment`` resolves, against the JAX engine's rule as
``tests/test_engine.py::test_matmul_precision_policy`` pins it (an
explicit argument, then ``train.matmul_precision``, then the user's
ambient setting, then ``highest`` for f32 and the default for bf16; one
Experiment's write never leaks into the next one's resolution), the torch
flags each precision sets, each entry point's calls under its own flags,
the bf16 eval step's f32 heads, and the CLI's ``--bf16`` and ``--matmul-precision`` (every choice of
``main.py``) training and evaluating ``samples/synthetic_smoke.py`` on the
CPU.
"""

import logging

import numpy as np
import pytest
import torch

from single_shot_detection_tpu_torch import cli, device
from single_shot_detection_tpu_torch.predict import Predictor
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.train.step import make_eval_step
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.config import load_config
from _torch_port_fixtures import one_torch_thread  # noqa: F401

SMOKE = 'samples/synthetic_smoke.py'
# main.py's --matmul-precision choices
CHOICES = ['default', 'high', 'highest', 'bfloat16', 'tensorfloat32', 'float32']


@pytest.fixture(autouse=True)
def policy_state():
    """The flags and the policy's memory as they were, put back after the
    test (another test in this process must not run under them)."""
    flags = device.current_flags()
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    state = device._last_write, device._user_ambient
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    device.set_flags(flags)
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    device._last_write, device._user_ambient = state
    root.handlers[:] = handlers
    root.setLevel(level)


def reset(ambient=None):
    """A process where no entry point has written yet, its flags torch's
    own (TF32 convolutions, f32 matmuls) or the user's ``ambient``
    precision."""
    device._last_write, device._user_ambient = None, None
    device.set_flags(device.PRECISION_FLAGS[ambient] if ambient
                     else (True, 'highest'))


def experiment(cfg=None, **kwargs) -> Experiment:
    return Experiment(cfg or SMOKE, phases=['train'], device='cpu',
                      debug=True, **kwargs)


def test_matmul_precision_policy():
    reset()
    exp = experiment()
    assert exp.matmul_precision == 'highest'
    assert device.current_flags() == (False, 'highest')

    # an f32 Experiment's write does not leak into a later bf16 one: the
    # bf16 policy's default comes back
    exp = experiment(bf16=True)
    assert exp.matmul_precision is None
    assert device.current_flags() == device.PRECISION_FLAGS['default']

    reset()
    assert experiment(bf16=True, matmul_precision='float32'
                      ).matmul_precision == 'float32'

    # the user's ambient setting is respected
    reset(ambient='tensorfloat32')
    assert experiment().matmul_precision == 'high'

    # the config's knob beats the ambient setting
    reset(ambient='tensorfloat32')
    cfg = load_config(SMOKE, phases=['train'])
    cfg.config.train['matmul_precision'] = 'high'
    assert experiment(cfg).matmul_precision == 'high'

    # an explicit argument beats the config's knob
    reset()
    cfg = load_config(SMOKE, phases=['train'])
    cfg.config.train['matmul_precision'] = 'high'
    assert experiment(cfg, matmul_precision='float32'
                      ).matmul_precision == 'float32'

    # the user's ambient setting survives an earlier Experiment's explicit
    # override
    reset(ambient='high')
    assert experiment(matmul_precision='float32').matmul_precision == 'float32'
    assert experiment().matmul_precision == 'high'

    # the user's change after the first Experiment is honored, and stays
    # the ambient for later ones
    reset()
    assert experiment().matmul_precision == 'highest'
    torch.set_float32_matmul_precision('high')
    torch.backends.cudnn.allow_tf32 = True
    assert experiment().matmul_precision == 'high'
    assert experiment(bf16=True).matmul_precision == 'high'


@pytest.mark.parametrize('name', CHOICES)
def test_precision_sets_the_flags(name):
    reset()
    exp = experiment(matmul_precision=name)
    conv_tf32, matmul = {
        'highest': (False, 'highest'), 'float32': (False, 'highest'),
        'high': (True, 'high'), 'tensorfloat32': (True, 'high'),
        'default': (True, 'high'), 'bfloat16': (True, 'medium')}[name]
    assert exp.matmul_precision == name
    assert torch.backends.cudnn.allow_tf32 is conv_tf32
    assert torch.get_float32_matmul_precision() == matmul
    assert torch.backends.cuda.matmul.allow_tf32 is (matmul != 'highest')


def test_unknown_precision_raises():
    reset()
    with pytest.raises(ValueError, match='matmul precision'):
        experiment(matmul_precision='fp8')


def test_each_entry_point_runs_under_its_own_flags():
    """An f32 Trainer built before a bf16 Predictor still trains with TF32
    off, the Predictor serves under its own flags, and each call puts back
    the flags it found."""
    reset()
    trainer = Trainer.from_config(SMOKE, device='cpu', overrides={
        'augmentations': []})
    pred = Predictor.from_config(SMOKE, device='cpu', bf16=True)
    assert device.current_flags() == (True, 'high')
    seen = []
    for model in (trainer.model, pred.model):
        model.register_forward_pre_hook(
            lambda m, args: seen.append((args[0].dtype, device.current_flags())))
    torch.set_float32_matmul_precision('medium')   # the caller's own
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    boxes = np.array([[[10, 10, 60, 60, 1, 1]]] * 2, np.float32)
    trainer.train_step(images, boxes, np.ones((2, 1), bool))
    pred.predict_batch(images)
    assert seen == [(torch.float32, (False, 'highest')),
                    (torch.float32, (True, 'high'))]
    assert device.current_flags() == (True, 'medium')
    assert pred.model.dtype == torch.bfloat16


@pytest.mark.parametrize('argv', [['--bf16']] + [
    ['--matmul-precision', name] for name in CHOICES
], ids=lambda argv: ' '.join(argv))
def test_cli_runs_with_precision_flags(argv, tmp_path):
    """The config as shipped (3 epochs, an evaluation after the last):
    losses finite, an mAP, an f32 checkpoint."""
    exp, rows = cli.main(['--cpu', '--config', SMOKE, '--phases', 'train',
                          'eval', '--save-dir', str(tmp_path), *argv])
    assert exp.policy.dtype == (torch.bfloat16 if argv == ['--bf16']
                                else torch.float32)
    assert exp.matmul_precision == (None if argv == ['--bf16'] else argv[1])
    assert all(np.isfinite(r['train_loss']) for r in rows)
    assert 0.0 <= rows[-1]['eval_mAP'] <= 1.0
    steps = exp.trainer.state.step
    saved = torch.load(f'{exp.checkpoint_dir}/ckpt-{steps}.pt',
                       weights_only=True)
    assert all(v.dtype == torch.float32 for v in saved['model'].values()
               if v.is_floating_point())


def test_bf16_eval_step_feeds_f32_heads():
    """The eval step casts the bf16 heads to f32 before the loss and the
    postprocessor, as the JAX eval step does."""
    reset()
    exp = Experiment(SMOKE, phases=['eval'], device='cpu', bf16=True)
    seen = []
    criterion, post = exp.trainer.criterion, exp.postprocessor

    def loss(scores, locs, *args, **kwargs):
        seen.append(('loss', scores.dtype, locs.dtype))
        return criterion(scores, locs, *args, **kwargs)

    def postprocess(scores, locs, anchors):
        seen.append(('postprocess', scores.dtype, locs.dtype))
        return post(scores, locs, anchors)

    exp.eval_step = make_eval_step(loss, exp.trainer.assigner, exp.anchors,
                                   postprocess)
    result = exp.evaluate()
    assert np.isfinite(result['loss']) and 0.0 <= result['mAP'] <= 1.0
    assert seen and set(seen) == {('loss', torch.float32, torch.float32),
                                  ('postprocess', torch.float32, torch.float32)}
