"""Port parity of the bf16 train step (docs/DESIGN.md §10): ``Trainer(bf16=True)``
with ``train.fused_bn`` (its kernels' plain versions on the CPU) against
the JAX package's ``make_train_step`` on its bundle built with
``dtype=jnp.bfloat16`` (flax's BatchNorm, which computes in f32 and
returns bf16 as the kernels do; ``test_torch_port_bf16.py`` holds the
fused BN's VJP at bf16 against the Pallas one), from the committed
checkpoint; and bf16 checkpoints, which are f32 files an f32 run
resumes, and the reverse.

Tolerances.  One step of bf16 activations moves the update of a trained
model by a quarter of its size: on this batch the JAX bf16 step's update
lies 0.24 (L2, relative) from the port's f32 step's, which equals JAX's
f32 step at 1e-3 of each tensor's update (``test_torch_port_train.py``).
So the port's bf16 update must lie within twice that distance of JAX's
bf16 update (measured 0.31 against 0.24); the losses rtol 2e-2 (measured
9.1e-4, the class loss 3.0e-3, the loc loss 9.7e-3); per tensor (``assert_step_matches``) each head's update within
0.25 of its own largest update (measured 0.076), every other tensor's
within the step's largest update (measured 0.57: the largest bf16 noise
lands on ``stage1.project_conv``), and the BN running statistics within
2e-2 of max(1, each tensor's largest value) (measured 5.7e-3, the port's
bf16 against its f32 4.6e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_zoo_slice import assert_step_matches
from single_shot_detection_tpu.data.datasets import Synthetic
from single_shot_detection_tpu.data.transforms import Pipeline
from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.ops import box_coder as jax_box_coder
from single_shot_detection_tpu.ops import losses as jax_losses
from single_shot_detection_tpu.ops import matching as jax_matching
from single_shot_detection_tpu.ops import sampling as jax_sampling
from single_shot_detection_tpu.train import optimizers as jax_optimizers
from single_shot_detection_tpu.train import schedulers as jax_schedulers
from single_shot_detection_tpu.train.state import create_train_state
from single_shot_detection_tpu.train.step import make_train_step
from single_shot_detection_tpu.utils.config import load_config as jax_load_config
from single_shot_detection_tpu_torch import device
from single_shot_detection_tpu_torch.ops import bn_kernel
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.weights import from_jax_variables

SMOKE = 'samples/synthetic_smoke.py'
CKPT_DIR = 'experiments/2026-08-16-225820'   # SMOKE's model, trained
OPTIMIZER = {'name': 'SGD', 'lr': 0.01, 'momentum': 0.9, 'weight_decay': 5e-4}
SCHEDULER = {'name': 'MultiStepLR', 'milestones': [1], 'gamma': 0.1}
OVERRIDES = {'augmentations': [],
             'train': {'fused_bn': True, 'optimizer': OPTIMIZER,
                       'scheduler': SCHEDULER}}


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
def precision_flags():
    """The flags and the policy's memory as they were, put back after the
    file: a bf16 entry point leaves TF32 on, and another test in this
    process must not run under it."""
    flags = device.current_flags()
    state = device._last_write, device._user_ambient
    yield
    device.set_flags(flags)
    device._last_write, device._user_ambient = state


def jax_bf16_step(variables):
    """The JAX engine's train step for ``SMOKE`` with ``OVERRIDES`` at
    bf16: the preprocessing-only train Pipeline and flax's BatchNorm."""
    cfg = jax_load_config(SMOKE)
    for key, value in OVERRIDES.items():
        old = getattr(cfg.config, key, None)
        setattr(cfg.config, key, {**old, **value} if isinstance(value, dict)
                and isinstance(old, dict) else value)
    model = dict(cfg.model)
    bundle = jax_builder.build(base=model['base'],
                               anchor_generator=model['anchor_generator'],
                               input_size=tuple(cfg.input_size),
                               dtype=jnp.bfloat16, **model['detector'])
    sampler_cfg = dict(cfg.sampler)
    sampler = jax_sampling.build_sampler(sampler_cfg.pop('name'), **sampler_cfg)
    criterion = jax_losses.MultiboxLoss(
        sampler=sampler, box_coder=jax_box_coder.BoxCoder(**cfg.box_coder),
        **cfg.loss)
    assigner = jax_matching.TargetAssigner(**cfg.target_assigner)
    schedule = jax_schedulers.create_lr_schedule(
        dict(SCHEDULER), OPTIMIZER['lr'], 1)[0]
    tx = jax_optimizers.create_optimizer(dict(OPTIMIZER), lr_schedule=schedule)
    pipeline = Pipeline((), cfg.preprocessing, tuple(cfg.input_size), train=True)
    step = make_train_step(bundle.module, criterion, assigner, bundle.anchors(),
                           tx, pipeline=pipeline, donate=False)
    return step, create_train_state(variables, tx)


def step_batch():
    """Four synthetic images, each with its first rectangle as the only
    GT."""
    data = Synthetic(num_images=4, image_size=128, num_classes=5, max_boxes=3,
                     seed=1)
    images = np.stack([a['image'] for a in data.annotations])
    boxes = np.zeros((4, 8, 6), np.float32)
    mask = np.zeros((4, 8), bool)
    for i, a in enumerate(data.annotations):
        boxes[i, 0] = a['boxes'][0]
        mask[i, 0] = True
    return images, boxes, mask


def test_bf16_train_step_matches_jax():
    with open(f'{CKPT_DIR}/ckpt-1800.msgpack', 'rb') as f:
        ckpt = serialization.msgpack_restore(f.read())
    variables = {'params': ckpt['params'], 'batch_stats': ckpt['batch_stats']}
    images, boxes, mask = step_batch()
    step_j, state_j = jax_bf16_step(variables)
    state_j, metrics_j = step_j(state_j, {
        'image': images, 'boxes': boxes, 'box_mask': mask},
        jax.random.PRNGKey(0))
    trainer = Trainer.from_config(SMOKE, variables=variables, device='cpu',
                                  overrides=OVERRIDES, bf16=True)
    f32 = Trainer.from_config(SMOKE, variables=variables, device='cpu',
                              overrides=OVERRIDES)
    assert trainer.model.dtype == torch.bfloat16
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for fn in bn_kernel.KERNELS:
        fn.launches = 0
    metrics = trainer.train_step(images, boxes, mask)
    f32.train_step(images, boxes, mask)
    assert [fn.launches for fn in bn_kernel.KERNELS] == [0, 0, 0, 0]
    for k in ('loss', 'class_loss', 'loc_loss'):
        assert metrics[k].dtype == torch.float32
        np.testing.assert_allclose(metrics[k].item(), float(metrics_j[k]),
                                   rtol=2e-2, err_msg=k)
    # parameters, BN statistics and momentum stay f32
    assert all(v.dtype == torch.float32
               for v in trainer.model.state_dict().values()
               if v.is_floating_point())
    assert all(s['momentum_buffer'].dtype == torch.float32
               for s in trainer.state.optimizer.state.values())

    before_j = from_jax_variables({'params': ckpt['params']})
    assert_step_matches(trainer, before, state_j, before_j, head_rel=0.25,
                        step_rel=1.0, stats_rel=2e-2)
    after_j = from_jax_variables({'params': state_j.params})
    got, ref = trainer.model.state_dict(), f32.model.state_dict()

    def distance(a, b):
        return float(torch.sqrt(sum(
            ((a[k] - before[k]) - (b[k] - before[k])).double().square().sum()
            for k in before_j)))

    jax_norm = float(torch.sqrt(sum((after_j[k] - before[k]).double()
                                    .square().sum() for k in before_j)))
    f32_gap = distance(ref, after_j) / jax_norm
    assert 0.05 < f32_gap  # bf16 really moved the step
    assert distance(got, after_j) / jax_norm <= 2 * f32_gap


def test_bf16_checkpoint_resumes_in_f32_and_back(tmp_path):
    """A bf16 epoch saves an f32 ``.pt``; an f32 Experiment resumes it at
    the next epoch with those weights, and a bf16 one resumes an f32
    run's checkpoint."""
    overrides = {'train': {'epochs': 2, 'eval_every': 1,
                           'num_batches_per_epoch': 2},
                 'dataset': {'train': {'name': 'Synthetic', 'num_images': 16,
                                       'image_size': 128, 'num_classes': 5,
                                       'max_boxes': 3, 'seed': 1}}}
    for first, second in ((True, False), (False, True)):
        directory = tmp_path / f'bf16_{first}'
        exp = Experiment(SMOKE, phases=('train',), device='cpu',
                         overrides=overrides, checkpoint_dir=str(directory),
                         bf16=first)
        exp.epochs = 1
        rows = exp.train()
        assert np.isfinite(rows[0]['train_loss'])
        saved = torch.load(directory / 'ckpt-2.pt', weights_only=True)
        assert all(v.dtype == torch.float32 for v in saved['model'].values()
                   if v.is_floating_point())
        resumed = Experiment(SMOKE, phases=('train',), device='cpu',
                             overrides=overrides, resume_from=str(directory),
                             bf16=second)
        assert resumed.start_epoch == 1 and resumed.trainer.state.step == 2
        assert resumed.model.dtype == (torch.bfloat16 if second
                                       else torch.float32)
        for k, v in resumed.model.state_dict().items():
            assert torch.equal(v, saved['model'][k]), k
        assert [r['epoch'] for r in resumed.train()] == [1]
