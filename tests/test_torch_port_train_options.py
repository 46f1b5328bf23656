"""Port parity for the rest of the train path (``train/step.py``,
``trainer.py``, ``train/engine.py``, ``train/checkpoint.py``) on the smoke
detector (MobileNetV2 at width 0.35, 128 px, b4) from the committed
checkpoint, against the JAX package's train step (one compiled step):
``frozen_bn`` with mixup (JAX's draws injected), the EMA shadow,
accumulation, ``lr_groups``, clipping and the soft-target and GIoU
losses.  On the port's side only: accumulation in train-mode BN,
``frozen_bn`` with QAT, ``fused_steps`` against single steps bit for bit
(the trainer and the epoch loop with its unfused remainder), the EMA
shadow and the Adam and ``MultiSteps`` states through a JAX ``.msgpack``
and a ``.pt``, and an ``Experiment`` with ``train.ema`` evaluating and
serving on the shadow.

Tolerances as in ``test_torch_port_train.py``: the loss rtol 1e-4; each
parameter tensor's update (and each shadow tensor's move) within 1e-3 of
that tensor's largest or of 1 % of the step's largest, whichever is
larger, each BN bias's within 2e-4 of the step's largest, each plus two
ulps of the tensor (the resolution of a difference of f32 parameters: a
conv whose update is 1e-6 moves by whole ulps); frozen running statistics
bit-equal.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from single_shot_detection_tpu.data.datasets import Synthetic
from single_shot_detection_tpu.data.transforms import Pipeline
from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.ops import box_coder as jax_box_coder
from single_shot_detection_tpu.ops import losses as jax_losses
from single_shot_detection_tpu.ops import matching as jax_matching
from single_shot_detection_tpu.ops import sampling as jax_sampling
from single_shot_detection_tpu.train import checkpoint as jax_ckpt
from single_shot_detection_tpu.train import optimizers as jax_optimizers
from single_shot_detection_tpu.train import schedulers as jax_schedulers
from single_shot_detection_tpu.train import step as jax_step
from single_shot_detection_tpu.utils.config import load_config as jax_load_config
from single_shot_detection_tpu_torch.data.transforms import Pipeline as PortPipeline
from single_shot_detection_tpu_torch.models import layers
from single_shot_detection_tpu_torch.train import step as pt_step
from single_shot_detection_tpu_torch.train import checkpoint as pt_ckpt
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.weights import from_jax_variables
from _torch_port_fixtures import jax_train_state
from _torch_port_fixtures import one_torch_thread  # noqa: F401

SMOKE = 'samples/synthetic_smoke.py'
CKPT = 'experiments/2026-08-16-225820/ckpt-1800.msgpack'
SCHEDULER = {'name': 'MultiStepLR', 'milestones': [1], 'gamma': 0.5}
SGD = {'name': 'SGD', 'lr': 0.01, 'momentum': 0.9, 'weight_decay': 5e-4,
       'lr_groups': {'score_head': 0.02}}
MIXUP = {'alpha': 1.5, 'p': 0.5}
PREPROCESSING = [
    {'name': 'ToFloatTensor', 'args': {'normalize': True}},
    {'name': 'Normalize',
     'args': {'mean': [0.485, 0.456, 0.406], 'std': [0.229, 0.224, 0.225]}},
]


@pytest.fixture(scope='module')
def variables():
    with open(CKPT, 'rb') as f:
        raw = serialization.msgpack_restore(f.read())
    return {'params': raw['params'], 'batch_stats': raw['batch_stats']}


def step_batch():
    """Four synthetic images with all their rectangles as GT."""
    data = Synthetic(num_images=4, image_size=128, num_classes=5, max_boxes=3,
                     seed=1)
    images = np.stack([a['image'] for a in data.annotations])
    boxes = np.zeros((4, 4, 6), np.float32)
    mask = np.zeros((4, 4), bool)
    for i, a in enumerate(data.annotations):
        n = len(a['boxes'])
        boxes[i, :n] = a['boxes'][:, :6]
        mask[i, :n] = True
    return images, boxes, mask


@functools.lru_cache(maxsize=1)
def jax_bundle():
    cfg = jax_load_config(SMOKE)
    model = dict(cfg.model)
    det = {k: v for k, v in model['detector'].items()
           if k in ('num_classes', 'use_depthwise', 'features', 'extras')}
    return jax_builder.build(base=model['base'],
                             anchor_generator=model['anchor_generator'],
                             input_size=tuple(cfg.input_size), **det)


def jax_parts(train, overrides=None):
    """The JAX engine's module, criterion, assigner, tx and preprocessing
    Pipeline for ``SMOKE`` with ``train`` merged into its train block and
    ``overrides`` set."""
    cfg = jax_load_config(SMOKE)
    cfg.config.train = {**cfg.config.train, **train}
    for key, value in (overrides or {}).items():
        setattr(cfg.config, key, value)
    bundle = jax_bundle()
    sampler_cfg = dict(cfg.sampler)
    sampler = jax_sampling.build_sampler(sampler_cfg.pop('name'), **sampler_cfg)
    criterion = jax_losses.MultiboxLoss(
        sampler=sampler, box_coder=jax_box_coder.BoxCoder(**cfg.box_coder),
        **cfg.loss)
    assigner = jax_matching.TargetAssigner(**cfg.target_assigner)
    k = int(train.get('accumulation_steps', 1))
    schedule = jax_schedulers.create_lr_schedule(dict(SCHEDULER),
                                                 train['optimizer']['lr'], 1)[0]
    tx = jax_optimizers.create_optimizer(
        dict(train['optimizer']), lr_schedule=schedule, accumulation_steps=k,
        clip_grad_norm=train.get('clip_grad_norm'))
    pipeline = Pipeline((), cfg.preprocessing, tuple(cfg.input_size), train=True)
    return bundle, criterion, assigner, tx, pipeline


def jax_mixup_draws(step, batch):
    """The mixup draws of JAX's step ``step`` (key ``PRNGKey(step)`` after
    the pipeline's split), as the port's ``sample_mixup`` returns them."""
    _, rng = jax.random.split(jax.random.PRNGKey(step))
    k_lam, k_perm, k_roll = jax.random.split(rng, 3)
    lam = jax.random.beta(k_lam, MIXUP['alpha'], MIXUP['alpha'])
    index = jax.random.permutation(k_perm, batch)
    roll = jax.random.uniform(k_roll, (batch,)) < MIXUP['p']
    return {'lam': torch.tensor(np.asarray(lam)),
            'index': torch.tensor(np.asarray(index)).long(),
            'roll': torch.tensor(np.asarray(roll))}


def assert_updates_close(before, after_p, after_j, names):
    """Each tensor's move against JAX's at the module docstring's
    tolerances, plus two ulps of the tensor before the step (a move is
    resolved only to that)."""
    updates = {n: (after_j[n] - before[n]).numpy() for n in names}
    largest = max(np.abs(u).max() for u in updates.values())
    assert largest > 0
    for name, want in updates.items():
        got = (after_p[name] - before[name]).numpy()
        if name.endswith('bn.bias'):
            atol = 2e-4 * largest
        else:
            atol = 1e-3 * max(np.abs(want).max(), 1e-2 * largest)
        atol = atol + 2 * np.spacing(np.abs(before[name].numpy()))
        gap = np.abs(got - want) / atol
        assert gap.max() <= 1, f'{name}: {gap.max():.3g} of the tolerance'


# ---------------------------- EMA, accumulation, mixup, frozen BN

def mixed_batches(pipeline, steps):
    """Each step's input as JAX's step makes it, computed outside the
    compiled step: the preprocessing ``Pipeline``, then JAX's
    ``apply_mixup`` eagerly on the key the step would split off, and the
    port's ``apply_mixup`` on the same draws and input, which gives the
    same tensors bit for bit (checked here).  Both steps then see one
    input: a compiled step's fused multiply-adds move a quarter of the
    blended pixels (and half of the normalized ones) by an ulp, which a
    train-mode BN over b4 magnifies to many times the update tolerance."""
    images, boxes, mask = step_batch()
    x, b, m = pipeline(jax.random.PRNGKey(0), images, boxes, mask)
    port = (torch.from_numpy(np.array(x)).permute(0, 3, 1, 2),
            torch.from_numpy(np.array(b[..., :6])),
            torch.from_numpy(np.array(m)))
    out = []
    for step in range(steps):
        _, rng = jax.random.split(jax.random.PRNGKey(step))
        mixed = jax_step.apply_mixup(rng, x, b[..., :6], m, MIXUP['alpha'],
                                     MIXUP['p'])
        mine = pt_step.apply_mixup(jax_mixup_draws(step, 4), *port)
        np.testing.assert_array_equal(mine[0].numpy().transpose(0, 2, 3, 1),
                                      np.asarray(mixed[0]))
        np.testing.assert_array_equal(mine[1].numpy(), np.asarray(mixed[1]))
        np.testing.assert_array_equal(mine[2].numpy(), np.asarray(mixed[2]))
        out.append(({'image': mixed[0], 'boxes': mixed[1],
                     'box_mask': mixed[2]}, mine))
    return out


def test_frozen_bn_ema_accumulation_mixup_match_jax(variables, monkeypatch):
    """``frozen_bn`` (with ``fused_bn``: no BN kernel may run) with mixup,
    ``ema`` 0.9, ``accumulation_steps`` 2, ``lr_groups``, clipping and the
    soft-target and GIoU losses, one accumulation window against JAX's
    step: the losses, the parameters (moved on the second micro-step
    only), the shadow,
    and the running statistics bit-equal before and after on both sides.
    (Train-mode BN against JAX's is ``test_torch_port_train.py``'s, on the
    Pallas kernels: here XLA's BN reductions and the mixed images of b4
    leave the stem conv's update 3.7 % apart.)"""
    loss = {'classification_loss': {'name': 'CrossEntropyWithSoftTargetsLoss',
                                    'epsilon': 0.1},
            'localization_loss': {'name': 'GeneralizedIoULoss'},
            'classification_weight': 1.0, 'localization_weight': 1.0}
    train = {'optimizer': SGD, 'scheduler': SCHEDULER, 'frozen_bn': True,
             'accumulation_steps': 2, 'clip_grad_norm': 0.5, 'ema': 0.9,
             'mixup': MIXUP}
    cfg = {'loss': loss, 'sampler': {'name': 'naive_sampler'}}
    bundle, criterion, assigner, tx, pipeline = jax_parts(train, cfg)
    state_j = jax_train_state(variables, tx, ema=True)
    batches = mixed_batches(pipeline, 2)
    # the same HLO program with LLVM at -O0: compiled in 40 % of the time
    step_j = jax.jit(jax_step._train_step_body(
        bundle.module, criterion, assigner, bundle.anchors(), tx, None, None,
        False, frozen_bn=True, ema=0.9)).lower(
            state_j, batches[0][0], jax.random.PRNGKey(0)).compile(
                compiler_options={'xla_backend_optimization_level': '0'})
    frozen = Trainer.from_config(SMOKE, variables=variables, device='cpu',
                                 overrides={'augmentations': [], **cfg, 'train': {
                                     **train, 'fused_bn': True}})
    assert frozen.schedule(0) == 0.01 and frozen.schedule(1) == 0.005
    update = pt_step.make_update_step(frozen.criterion, frozen.assigner,
                                      frozen.anchors, frozen.schedule, 0.9,
                                      frozen_bn=True)

    def no_kernel(*args, **kwargs):
        raise AssertionError('a BN kernel ran under frozen_bn')

    monkeypatch.setattr(layers, 'fused_bn_train', no_kernel)
    before = {k: v.clone() for k, v in frozen.model.state_dict().items()}
    for step, (batch, (x, boxes, mask)) in enumerate(batches):
        params = [p.detach().clone() for p in frozen.model.parameters()]
        state_j, metrics_j = step_j(state_j, batch, jax.random.PRNGKey(step))
        metrics = update(frozen.state, x, boxes, mask)
        for k in ('loss', 'class_loss', 'loc_loss'):
            np.testing.assert_allclose(metrics[k].item(), float(metrics_j[k]),
                                       rtol=1e-4, err_msg=f'step {step} {k}')
        moved = any(not torch.equal(a, p) for a, p in
                    zip(params, frozen.model.parameters()))
        assert moved == (step == 1), step
    assert int(state_j.step) == frozen.state.step == 2
    names = [n for n, _ in frozen.model.named_parameters()]
    after_j = from_jax_variables({'params': state_j.params,
                                  'batch_stats': state_j.batch_stats})
    assert_updates_close(before, frozen.model.state_dict(), after_j, names)
    shadow_j = from_jax_variables({'params': state_j.ema_params})
    assert_updates_close(before, frozen.state.ema_params, shadow_j, names)
    shadow = frozen.state.ema_params['score_head0.weight']
    assert not torch.equal(shadow, frozen.model.score_head0.weight.detach())
    for name, value in frozen.model.state_dict().items():
        if name.endswith(('running_mean', 'running_var')):
            assert torch.equal(value, before[name]), name
            assert torch.equal(value, after_j[name]), name


def test_train_mode_accumulation_and_frozen_bn_with_qat(variables):
    """In train-mode BN under ``accumulation_steps`` 2 the running
    statistics and the shadow's step count move on every micro-step, the
    parameters on every second.  ``frozen_bn`` with ``qat``: the BNs read
    their statistics and write none while the convs, in train mode,
    update ``act_amax`` (the stem's seeded with the largest |input|);
    QAT's step is held against JAX in ``test_torch_port_qat.py``.
    ``frozen_bn`` with ``group_norm`` raises, as in the JAX engine."""
    trainer = Trainer.from_config(SMOKE, variables=variables, device='cpu',
                                  overrides={'augmentations': [], 'train': {
                                      'optimizer': SGD, 'fused_bn': True,
                                      'accumulation_steps': 2, 'ema': 0.9}})
    images, boxes, mask = step_batch()
    for step in range(4):
        params = [p.detach().clone() for p in trainer.model.parameters()]
        stats = trainer.model.state_dict()['extra0.reduce.bn.running_mean'].clone()
        trainer.train_step(images, boxes, mask)
        moved = any(not torch.equal(a, p) for a, p in
                    zip(params, trainer.model.parameters()))
        assert moved == (step % 2 == 1), step
        assert not torch.equal(
            stats, trainer.model.state_dict()['extra0.reduce.bn.running_mean'])
    assert trainer.state.step == 4

    qat = Trainer.from_config(SMOKE, variables=variables, device='cpu',
                              overrides={'augmentations': [], 'train': {
                                  'optimizer': SGD, 'frozen_bn': True,
                                  'qat': True}})
    start = {k: v.clone() for k, v in qat.model.state_dict().items()}
    metrics = qat.train_step(images, boxes, mask)
    assert np.isfinite(metrics['loss'].item())
    after = qat.model.state_dict()
    amax = [k for k in after if k.endswith('act_amax')]
    assert len(amax) == 43 and all(float(after[k]) > 0 for k in amax)
    x = PortPipeline((), PREPROCESSING, (128, 128)).apply(
        [], torch.from_numpy(images), torch.from_numpy(boxes),
        torch.from_numpy(mask))[0]
    assert float(after['features.base.stage0.conv.act_amax']) == float(
        x.abs().amax())
    for name, value in after.items():
        if name.endswith(('running_mean', 'running_var')):
            assert torch.equal(value, start[name]), name
    with pytest.raises(ValueError, match='frozen_bn'):
        Trainer.from_config(SMOKE, device='cpu', overrides={
            'train': {'frozen_bn': True, 'group_norm': True}})


# ------------------------------------------------------ fused steps

def test_fused_steps_equal_single_steps_bit_for_bit(variables):
    """``fused_steps`` 3 in one call against three single steps (mixup and
    EMA on, the draws from each step's own seed): every tensor and the
    summed metrics bit-equal.  Through the epoch loop, 4 batches with
    ``fused_steps`` 3 (one fused call and one unfused step) against 4
    single steps: the rows and every tensor bit-equal."""
    over = {'augmentations': [], 'train': {'optimizer': SGD, 'ema': 0.9,
                                           'mixup': MIXUP}}
    single = Trainer.from_config(SMOKE, variables=variables, device='cpu',
                                 overrides=over)
    fused = Trainer.from_config(SMOKE, variables=variables, device='cpu',
                                overrides={**over, 'train': {**over['train'],
                                                             'fused_steps': 3}})
    images, boxes, mask = step_batch()
    sums = None
    for _ in range(3):
        m = single.train_step(images, boxes, mask)
        sums = m if sums is None else {k: sums[k] + v for k, v in m.items()}
    got = fused.fused_train_step([(images, boxes, mask)] * 3)
    assert fused.state.step == single.state.step == 3
    for k in sums:
        assert torch.equal(got[k], sums[k]), k
    want = single.model.state_dict()
    for k, v in fused.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for k, v in fused.state.ema_params.items():
        assert torch.equal(v, single.state.ema_params[k]), k

    epoch = {'train': {'epochs': 1, 'eval_every': 5, 'ema': 0.9},
             'dataset': {'train': {'name': 'Synthetic', 'num_images': 16,
                                   'image_size': 128, 'num_classes': 5,
                                   'max_boxes': 3, 'seed': 1}},
             'batch_size': 4}
    rows, models = [], []
    for k in (1, 3):
        over = {**epoch, 'train': {**epoch['train'], 'fused_steps': k}}
        exp = Experiment(SMOKE, phases=('train',), device='cpu',
                         overrides=over, variables=variables)
        assert exp.fused_steps == k
        rows.append(exp.train())
        models.append(exp)
    assert rows[0] == rows[1]
    assert models[1].trainer.state.step == 4
    want = models[0].model.state_dict()
    for k, v in models[1].model.state_dict().items():
        assert torch.equal(v, want[k]), k


# ------------------------------------------------------- checkpoints

def test_ema_adam_and_multisteps_cross_checkpoints(variables, tmp_path, caplog):
    """A JAX state with EMA and Adam under ``MultiSteps`` (k = 2, one
    micro-step into its window) saved by the JAX package restores into the
    port's trainer (buffers, running mean, shadow); a ``.pt`` of that
    restores bit for bit; the shadow follows ``restore_weights_only``, a
    run without EMA drops it, and one with EMA seeds a copy from a file
    without."""
    opt = {'name': 'Adam', 'lr': 1e-3, 'weight_decay': 1e-4}
    train = {'optimizer': opt, 'accumulation_steps': 2, 'ema': 0.99,
             'scheduler': SCHEDULER}
    tx = jax_optimizers.create_optimizer(dict(opt), accumulation_steps=2)
    state = jax_train_state(variables, tx, ema=True)
    rs = np.random.RandomState(0)

    def noise(tree, scale=0.01):
        return jax.tree_util.tree_map(
            lambda p: jnp.asarray((rs.rand(*p.shape) * scale).astype(np.float32)),
            tree)

    # one update done, one micro-step into the next window
    opt_state = state.opt_state
    wd, adam, lr = opt_state.inner_opt_state
    adam = adam._replace(count=jnp.int32(1), mu=noise(adam.mu),
                         nu=noise(adam.nu, 1e-4))
    opt_state = opt_state._replace(
        mini_step=jnp.int32(1), gradient_step=jnp.int32(1),
        inner_opt_state=(wd, adam, lr), acc_grads=noise(opt_state.acc_grads))
    ema = noise(state.ema_params, 1.0)
    state = state.replace(step=jnp.int32(3), opt_state=opt_state,
                          ema_params=ema)
    path = jax_ckpt.save(str(tmp_path / 'jax'), state, epoch=0)

    trainer = Trainer.from_config(SMOKE, device='cpu', overrides={
        'augmentations': [], 'train': train})
    pt_ckpt.restore(path, trainer.state)
    assert trainer.state.step == 3
    want_ema = from_jax_variables({'params': ema})
    want_mu = from_jax_variables({'params': adam.mu})
    want_acc = from_jax_variables({'params': opt_state.acc_grads})
    opt_p = trainer.state.optimizer
    for name, p in trainer.model.named_parameters():
        assert torch.equal(trainer.state.ema_params[name], want_ema[name]), name
        assert torch.equal(opt_p.state[p]['mu'], want_mu[name]), name
        assert torch.equal(opt_p.state[p]['acc_grad'], want_acc[name]), name
    assert trainer.eval_model.state_dict()['score_head0.weight'].equal(
        want_ema['score_head0.weight'])

    saved = pt_ckpt.save(str(tmp_path / 'pt'), trainer.state, epoch=0)
    fresh = Trainer.from_config(SMOKE, device='cpu', seed=4, overrides={
        'augmentations': [], 'train': train})
    pt_ckpt.restore(saved, fresh.state)
    for (name, p), q in zip(trainer.model.named_parameters(),
                            fresh.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(trainer.state.ema_params[name],
                           fresh.state.ema_params[name]), name
        for key, buf in opt_p.state[p].items():
            assert torch.equal(buf, fresh.state.optimizer.state[q][key]), (name, key)

    weights_only = Trainer.from_config(SMOKE, device='cpu', seed=4, overrides={
        'augmentations': [], 'train': {'ema': 0.99}})
    pt_ckpt.restore_weights_only(path, weights_only.state)
    assert weights_only.state.step == 0
    assert torch.equal(weights_only.state.ema_params['score_head0.weight'],
                       want_ema['score_head0.weight'])
    caplog.set_level(logging.INFO)
    no_ema = Trainer.from_config(SMOKE, device='cpu', overrides={
        'augmentations': [], 'train': {'optimizer': opt, 'accumulation_steps': 2}})
    pt_ckpt.restore(saved, no_ema.state)
    assert not no_ema.state.ema_params and no_ema.eval_model is no_ema.model
    assert 'disables it: dropped' in caplog.text
    seeded = Trainer.from_config(SMOKE, device='cpu', overrides={
        'augmentations': [], 'train': {'ema': 0.5}})
    pt_ckpt.restore(CKPT, seeded.state)
    assert 'predates EMA: seeded' in caplog.text
    for name, p in seeded.model.named_parameters():
        assert torch.equal(seeded.state.ema_params[name], p.detach()), name
        assert seeded.state.ema_params[name].data_ptr() != p.data_ptr()


# ------------------------------------------------- the engine's shadow

def test_engine_ema_eval_uses_shadow():
    """As JAX ``tests/test_ema.py::test_engine_ema_eval_uses_shadow``: an
    epoch with ``train.ema`` leaves a shadow apart from the parameters,
    and the evaluation and the serving path run it, with the model's own
    BN statistics."""
    exp = Experiment(SMOKE, device='cpu', overrides={
        'train': {'ema': {'decay': 0.99}, 'epochs': 1}})
    exp.train()
    assert exp.trainer.ema == 0.99 and exp.eval_model is not exp.model
    assert any(not torch.allclose(exp.trainer.state.ema_params[n], p)
               for n, p in exp.model.named_parameters())
    for a, b in zip(exp.eval_model.buffers(), exp.model.buffers()):
        assert a is b
    seen = []
    eval_step = exp.eval_step
    exp.eval_step = lambda model, *args: (seen.append(model),
                                          eval_step(model, *args))[1]
    metrics = exp.evaluate()
    assert np.isfinite(metrics['loss']) and 0.0 <= metrics['mAP'] <= 1.0
    assert seen and all(m is exp.eval_model for m in seen)
    assert exp.predictor().model is exp.eval_model
    dets = exp.predict(np.zeros((90, 120, 3), np.uint8))
    assert dets.ndim == 2 and dets.shape[1] == 6


def test_fused_steps_fall_back_under_taylor_pruning(caplog):
    """``TaylorExpansion`` observes each step's gradients, so the engine
    runs ``fused_steps`` unfused with a warning, as the JAX engine does."""
    with caplog.at_level(logging.WARNING):
        exp = Experiment(SMOKE, phases=('train',), device='cpu', overrides={
            'train': {'fused_steps': 2, 'pruner': {
                'criterion': {'name': 'TaylorExpansion'},
                'include_paths': ['features', 'extra'], 'num': 4}}})
    assert exp.trainer.fused_steps == 2 and exp.fused_steps == 1
    assert 'fused_steps is incompatible with TaylorExpansion' in caplog.text


def test_fused_steps_observe_the_unfused_remainder_as_jax_does():
    """With ``fused_steps`` 3 over 5 batches the epoch runs one fused call
    and two single steps; a ``MeanActivation`` pruner observes the single
    steps at its cadence, on the steps where JAX's epoch loop observes
    (its ``_train_batches`` grouping, then ``step_idx % observe_every``)."""
    from types import SimpleNamespace
    from single_shot_detection_tpu.train.engine import Experiment as JaxExperiment
    every, k, num_batches = 2, 3, 5
    exp = Experiment(SMOKE, phases=('train',), device='cpu', overrides={
        'train': {'epochs': 1, 'eval_every': 5, 'fused_steps': k,
                  'pruner': {'criterion': {'name': 'MeanActivation'},
                             'include_paths': ['features', 'extra'],
                             'num': 4, 'observe_every': every}},
        'dataset': {'train': {'name': 'Synthetic', 'num_images': 4 * num_batches,
                              'image_size': 128, 'num_classes': 5,
                              'max_boxes': 3, 'seed': 1}},
        'batch_size': 4})
    assert exp.fused_steps == k
    steps, observed = [], []
    train_step, observe = exp.trainer.train_step, exp._observe

    def counted_step(*tensors, step):
        steps.append(step)
        return train_step(*tensors, step=step)

    def counted_observe(tensors):
        observed.append(steps[-1])
        observe(tensors)

    exp.trainer.train_step = counted_step
    exp._observe = counted_observe
    exp.train()
    assert exp.trainer.state.step == num_batches

    batch = {'image': None, 'boxes': None, 'box_mask': None}
    kinds = [kind for kind, _ in JaxExperiment._train_batches(
        SimpleNamespace(fused_train_step=object(), fused_steps=k),
        [batch] * num_batches, num_batches)]
    want, step_idx = [], 0
    for kind in kinds:
        if kind == 'single' and step_idx % every == 0:
            want.append(step_idx)
        step_idx += k if kind == 'fused' else 1
    assert kinds == ['fused', 'single', 'single']
    assert steps == [3, 4] and observed == want == [4]
    assert exp.pruner.criterion.ema  # the real observation ran
