"""Port parity for the training slice: target assignment, hard-negative
mining, the multibox loss, SGD with MultiStepLR, the train-side
preprocessing and the whole train step (``Trainer``) against the JAX
package's ``make_train_step`` with the Pallas BN (interpret mode).

Tolerances: targets and sampled masks exactly equal; multibox loss and its
gradients rtol 1e-5 (atol 1e-7 for gradients that are exactly 0 on one side
and a rounding residue on the other); SGD parameters rtol 1e-6 after 5
steps; train-side preprocessing atol 1e-4 (the resample is two f32 products
summed in another order); the train step's loss rtol 1e-4, each parameter
tensor's update (after - before) within 1e-3 of that tensor's largest
update or of 1 % of the step's largest update, whichever is larger (a
tensor whose update is far below the rest carries the f32 noise of the
whole backward in absolute terms), each BN bias's within 2e-4 of the
step's largest update (its gradient is a sum of dz over every position, so
its rounding noise is of the step's scale, not its own: at one torch thread
``stage9.expand_bn.bias`` lands 9.4e-5 of the step from JAX's, 1.6e-3 of
its own update), and the BN running statistics atol
1e-5 with rtol 1e-6 (the trained variances reach 157, where one f32 step
is 1.5e-5).  The step's inputs leave a loss gap above 1e-4 at every image's
hard-negative boundary, which the test checks, so a rounding difference
cannot swap a mined negative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from single_shot_detection_tpu.data.datasets import Synthetic
from single_shot_detection_tpu.data.transforms import Pipeline
from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.ops import bn_pallas
from single_shot_detection_tpu.ops import box_coder as jax_box_coder
from single_shot_detection_tpu.ops import losses as jax_losses
from single_shot_detection_tpu.ops import matching as jax_matching
from single_shot_detection_tpu.ops import sampling as jax_sampling
from single_shot_detection_tpu.train import optimizers as jax_optimizers
from single_shot_detection_tpu.train import schedulers as jax_schedulers
from single_shot_detection_tpu.train.step import make_train_step
from single_shot_detection_tpu.utils.config import load_config as jax_load_config
from single_shot_detection_tpu_torch.data.transforms import Pipeline as PortPipeline
from single_shot_detection_tpu_torch.ops import bn_kernel
from single_shot_detection_tpu_torch.ops import box_coder as pt_box_coder
from single_shot_detection_tpu_torch.ops import losses as pt_losses
from single_shot_detection_tpu_torch.ops import matching as pt_matching
from single_shot_detection_tpu_torch.ops import sampling as pt_sampling
from single_shot_detection_tpu_torch.train import optimizers as pt_optimizers
from single_shot_detection_tpu_torch.train import schedulers as pt_schedulers
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.weights import from_jax_variables
from _torch_port_fixtures import jax_train_state
from _torch_port_fixtures import one_torch_thread  # noqa: F401

SMOKE = 'samples/synthetic_smoke.py'
CKPT_DIR = 'experiments/2026-08-16-225820'   # SMOKE's model, trained
PREPROCESSING = [
    {'name': 'ToFloatTensor', 'args': {'normalize': True}},
    {'name': 'Normalize',
     'args': {'mean': [0.485, 0.456, 0.406], 'std': [0.229, 0.224, 0.225]}},
]
OPTIMIZER = {'name': 'SGD', 'lr': 0.01, 'momentum': 0.9, 'weight_decay': 5e-4}
SCHEDULER = {'name': 'MultiStepLR', 'milestones': [1], 'gamma': 0.1}
OVERRIDES = {'augmentations': [],
             'train': {'fused_bn': True, 'optimizer': OPTIMIZER,
                       'scheduler': SCHEDULER}}


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def random_anchors(rng, a):
    """Centroid anchors in a 128-pixel frame."""
    cxy = rng.rand(a, 2) * 128
    wh = rng.rand(a, 2) * 60 + 4
    return np.concatenate([cxy, wh], axis=1).astype(np.float32)


def random_gt(rng, b, g):
    xy = rng.rand(b, g, 2) * 90
    wh = rng.rand(b, g, 2) * 50 + 8
    cls = rng.randint(1, 5, (b, g, 1))
    gt = np.concatenate([xy, xy + wh, cls, np.ones((b, g, 1))], -1)
    return gt.astype(np.float32)


# --------------------------------------------------------------- matching

def test_target_assigner_matches_jax():
    rng = np.random.RandomState(0)
    anchors = random_anchors(rng, 300)
    gt = random_gt(rng, 3, 6)
    mask = np.ones((3, 6), bool)
    mask[0, 4:] = False           # padded rows, finite garbage included
    gt[0, 5] = [1e4, 1e4, -1e4, -1e4, 3, 1]
    mask[1, 2:] = False
    gt[2, 3] = gt[2, 1]           # two GTs share a best anchor: 3 must win
    gt[2, 3, 4] = 4.0
    assigner_j = jax_matching.TargetAssigner(0.5, 0.35)   # an IGNORE band
    assigner_p = pt_matching.TargetAssigner(0.5, 0.35)
    want = np.asarray(assigner_j(jnp.asarray(gt), jnp.asarray(mask),
                                 jnp.asarray(anchors)))
    got = assigner_p(t(gt), t(mask), t(anchors)).numpy()
    assert got.shape == (3, 300, 6)
    np.testing.assert_array_equal(got, want)
    classes = got[..., 4]
    assert (classes == -1).any() and (classes == 0).any() and (classes > 0).any()
    assert (got[2, :, 4] == 4.0).any() and (got[1, :, 4] != -1).any()


@pytest.mark.parametrize('matched,unmatched,force', [(0.5, 0.5, True),
                                                     (0.6, 0.3, True),
                                                     (0.5, 0.4, False)])
def test_match_per_prediction_matches_jax(matched, unmatched, force):
    rng = np.random.RandomState(1)
    w = rng.rand(2, 5, 40).astype(np.float32)
    w[0, 1] = w[0, 3]             # tied rows: force-match conflict
    w[1, :, 7] = 0.55             # a tied column
    mask = np.array([[1, 1, 1, 1, 0], [1, 0, 1, 1, 1]], bool)
    want = np.stack([np.asarray(jax_matching.match_per_prediction(
        jnp.asarray(w[i]), jnp.asarray(mask[i]), matched, unmatched, force))
        for i in range(2)])
    got = pt_matching.match_per_prediction(t(w), t(mask), matched, unmatched,
                                           force).numpy()
    np.testing.assert_array_equal(got, want)


def test_match_bipartite_matches_jax():
    rng = np.random.RandomState(2)
    w = rng.rand(3, 4, 30).astype(np.float32)
    mask = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 1, 1]], bool)
    want = np.stack([np.asarray(jax_matching.match_bipartite(
        jnp.asarray(w[i]), jnp.asarray(mask[i]))) for i in range(3)])
    got = pt_matching.match_bipartite(t(w), t(mask)).numpy()
    np.testing.assert_array_equal(np.where(mask, got, 0), np.where(mask, want, 0))


# --------------------------------------------------------------- sampling

def test_hard_negative_mining_matches_jax_with_ties():
    rng = np.random.RandomState(3)
    b, a, c = 3, 64, 5
    scores = rng.randn(b, a, c).astype(np.float32)
    scores[:, 10:30] = scores[:, 10:11]    # 20 anchors with the same loss
    classes = rng.choice([-1, 0, 0, 0, 1, 2], size=(b, a)).astype(np.int32)
    classes[:, 10:30] = 0
    classes[2] = np.where(classes[2] > 0, 0, classes[2])  # no positives
    for ratio, min_neg in ((3, 5), (1, 12)):
        want = np.asarray(jax_sampling.hard_negative_mining(
            jnp.asarray(scores), jnp.asarray(classes), ratio, min_neg))
        got = pt_sampling.hard_negative_mining(t(scores), t(classes), ratio,
                                               min_neg).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pt_sampling.naive_sampler(t(scores), t(classes)).numpy(),
        np.asarray(jax_sampling.naive_sampler(jnp.asarray(scores),
                                              jnp.asarray(classes))))


# ----------------------------------------------------------------- losses

def test_multibox_loss_and_gradients_match_jax():
    rng = np.random.RandomState(4)
    anchors = random_anchors(rng, 200)
    gt = random_gt(rng, 2, 4)
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    target = np.asarray(jax_matching.TargetAssigner(0.5, 0.4)(
        jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(anchors)))
    scores = rng.randn(2, 200, 5).astype(np.float32)
    locs = rng.randn(2, 200, 4).astype(np.float32)
    loss_cfg = dict(classification_loss={'name': 'CrossEntropyLoss'},
                    localization_loss={'name': 'SmoothL1Loss'},
                    classification_weight=1.0, localization_weight=0.7)

    crit_j = jax_losses.MultiboxLoss(
        jax_sampling.build_sampler('hard_negative_mining',
                                   negative_per_positive_ratio=3,
                                   min_negative_per_image=5),
        jax_box_coder.BoxCoder(10.0, 5.0), **loss_cfg)
    crit_p = pt_losses.MultiboxLoss(
        pt_sampling.build_sampler('hard_negative_mining',
                                  negative_per_positive_ratio=3,
                                  min_negative_per_image=5),
        pt_box_coder.BoxCoder(10.0, 5.0), **loss_cfg)

    def total(s, l):
        return crit_j(s, l, jnp.asarray(anchors), jnp.asarray(target))

    want = jax.jit(total)(scores, locs)
    grads = jax.jit(jax.grad(lambda s, l: total(s, l)[0], argnums=(0, 1)))(
        scores, locs)
    s_t, l_t = t(scores).requires_grad_(), t(locs).requires_grad_()
    got = crit_p(s_t, l_t, t(anchors), t(target))
    got[0].backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    for g, w in ((s_t.grad, grads[0]), (l_t.grad, grads[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


def test_build_loss_raises_on_unported_names():
    """Every loss of the JAX package is ported (their parity is
    ``test_torch_port_losses.py``'s); an unknown name raises with every
    supported name listed."""
    assert isinstance(pt_losses.build_loss('SoftmaxFocalLoss'),
                      pt_losses.SoftmaxFocalLoss)
    with pytest.raises(KeyError) as err:
        pt_losses.build_loss('TripletMarginLoss')
    assert ', '.join(sorted(pt_losses.LOSSES)) in str(err.value)
    assert len(pt_losses.LOSSES) == 16


# -------------------------------------------------------- optimizer, lr

def test_sgd_multistep_matches_optax_chain():
    """5 steps of coupled decay + momentum, crossing two milestones."""
    rng = np.random.RandomState(5)
    params = {'a': rng.randn(3, 4).astype(np.float32),
              'b': rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    sched_cfg = {'name': 'MultiStepLR', 'milestones': [2, 4], 'gamma': 0.1}
    opt_cfg = {'name': 'SGD', 'lr': 0.1, 'momentum': 0.9, 'weight_decay': 5e-3}

    schedule_j = jax_schedulers.create_lr_schedule(dict(sched_cfg), 0.1, 1)[0]
    tx = jax_optimizers.create_optimizer(dict(opt_cfg), lr_schedule=schedule_j)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(p_j)

    p_t = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    opt = pt_optimizers.create_optimizer(dict(opt_cfg), p_t.values())
    schedule_p = pt_schedulers.create_lr_schedule(dict(sched_cfg), 0.1, 1)[0]

    @jax.jit
    def jax_update(g, opt_state, p):
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    for step, g in enumerate(grads):
        p_j, opt_state = jax_update(g, opt_state, p_j)
        for k, p in p_t.items():
            p.grad = t(g[k])
        opt.step(count=step, schedule=schedule_p)
        assert schedule_p(step) == pytest.approx(float(schedule_j(step)))
        for k in params:
            np.testing.assert_allclose(p_t[k].detach().numpy(),
                                       np.asarray(p_j[k]), rtol=1e-6, atol=1e-7)
    assert [schedule_p(s) for s in range(5)] == pytest.approx(
        [0.1, 0.1, 0.01, 0.01, 0.001])


@pytest.mark.parametrize('name', ['Adam', 'CosineAnnealingLR'])
def test_unported_optimizers_and_schedules_raise(name):
    """Every optimizer of the JAX package is ported (Adam among them; their
    parity is ``test_torch_port_optim.py``'s), and so is every schedule
    (CosineAnnealingLR among them); an unknown name raises."""
    if name == 'Adam':
        opt = pt_optimizers.create_optimizer({'name': 'Adam', 'lr': 1e-3},
                                             [torch.nn.Parameter(torch.zeros(1))])
        assert opt.rule_name == 'Adam'
        with pytest.raises(KeyError, match='unknown optimizer'):
            pt_optimizers.create_optimizer({'name': 'Lion', 'lr': 1e-3},
                                           [torch.nn.Parameter(torch.zeros(1))])
        return
    schedule, plateau, _ = pt_schedulers.create_lr_schedule(
        {'name': name, 'T_max': 3}, 0.1, 1)
    assert plateau is None
    assert [schedule(s) for s in (0, 3, 5)] == pytest.approx([0.1, 0.0, 0.0])
    with pytest.raises(KeyError, match='unknown scheduler'):
        pt_schedulers.create_lr_schedule({'name': 'OneCycleLR'}, 0.1, 1)


# ------------------------------------------------------ preprocessing

@pytest.mark.parametrize('staged,out', [(64, 64), (64, 48)])
def test_train_preprocessing_matches_jax_pipeline(staged, out):
    """The train ``Pipeline`` without augmentation: the identity window
    (exact, skipped) and a resample to another size; boxes scaled and
    clipped, the degenerate one dropped."""
    rng = np.random.RandomState(6)
    images = rng.randint(0, 256, (2, staged, staged, 3), dtype=np.uint8)
    boxes = np.zeros((2, 3, 6), np.float32)
    boxes[:, :, :4] = [[5, 6, 40, 50], [-3, 10, 70, 20], [30, 30, 30, 50]]
    boxes[:, :, 4:] = [2, 1]
    mask = np.array([[1, 1, 1], [1, 0, 1]], bool)
    pipe = Pipeline((), PREPROCESSING, (out, out), train=True)
    want = pipe(jax.random.PRNGKey(0), images, boxes, mask)
    got = PortPipeline((), PREPROCESSING, (out, out)).apply(
        [], t(images), t(boxes), t(mask))
    np.testing.assert_allclose(got[0].numpy().transpose(0, 2, 3, 1),
                               np.asarray(want[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert not got[2][:, 2].any()  # the degenerate box left the mask


# --------------------------------------------------------- the train step

def jax_train_step(variables, overrides=OVERRIDES):
    """The JAX engine's train step for ``SMOKE`` with the overrides, the
    preprocessing-only train Pipeline and the Pallas BN."""
    cfg = jax_load_config(SMOKE)
    for key, value in overrides.items():
        old = getattr(cfg.config, key, None)
        setattr(cfg.config, key, {**old, **value} if isinstance(value, dict)
                and isinstance(old, dict) else value)
    model = dict(cfg.model)
    det = {k: v for k, v in model['detector'].items()
           if k in ('num_classes', 'use_depthwise', 'features', 'extras')}
    bundle = jax_builder.build(base=model['base'],
                               anchor_generator=model['anchor_generator'],
                               input_size=tuple(cfg.input_size), **det)
    sampler_cfg = dict(cfg.sampler)
    sampler = jax_sampling.build_sampler(sampler_cfg.pop('name'), **sampler_cfg)
    criterion = jax_losses.MultiboxLoss(
        sampler=sampler, box_coder=jax_box_coder.BoxCoder(**cfg.box_coder),
        **cfg.loss)
    assigner = jax_matching.TargetAssigner(**cfg.target_assigner)
    optimizer = dict(cfg.train['optimizer'])
    schedule = jax_schedulers.create_lr_schedule(
        dict(cfg.train['scheduler']), optimizer['lr'], 1)[0]
    tx = jax_optimizers.create_optimizer(optimizer, lr_schedule=schedule)
    pipeline = Pipeline((), cfg.preprocessing, tuple(cfg.input_size), train=True)
    step = make_train_step(bundle.module, criterion, assigner, bundle.anchors(),
                           tx, pipeline=pipeline,
                           apply_fn=bn_pallas.fused_bn_apply(bundle.module),
                           donate=False)
    return bundle, step, jax_train_state(variables, tx)


def step_batch():
    """Four synthetic images, each with its first rectangle as the only GT:
    few positives, so the hard-negative boundary falls among the hardest
    negatives, whose losses are well apart."""
    data = Synthetic(num_images=4, image_size=128, num_classes=5, max_boxes=3,
                     seed=1)
    images = np.stack([a['image'] for a in data.annotations])
    boxes = np.zeros((4, 8, 6), np.float32)
    mask = np.zeros((4, 8), bool)
    for i, a in enumerate(data.annotations):
        boxes[i, 0] = a['boxes'][0]
        mask[i, 0] = True
    return images, boxes, mask


@pytest.fixture
def mining_gaps(monkeypatch):
    """Records, for every image the port's hard-negative mining sees, the
    loss gap between the last kept and the first dropped negative."""
    gaps = []
    mine = pt_sampling.SAMPLERS['hard_negative_mining']

    def recording(scores, classes, negative_per_positive_ratio,
                  min_negative_per_image):
        loss = -torch.log_softmax(scores.detach(), -1)[..., 0]
        for b in range(loss.shape[0]):
            neg = torch.sort(loss[b][classes[b] == 0], descending=True).values
            pos = int(((classes[b] != 0) & (classes[b] != -1)).sum())
            k = min(max(pos * negative_per_positive_ratio,
                        min_negative_per_image), len(neg))
            if k < len(neg):
                gaps.append(float(neg[k - 1] - neg[k]))
        return mine(scores, classes, negative_per_positive_ratio,
                    min_negative_per_image)

    monkeypatch.setitem(pt_sampling.SAMPLERS, 'hard_negative_mining', recording)
    return gaps


def test_train_step_matches_jax_make_train_step(mining_gaps):
    """Two steps from the committed checkpoint (trained weights: at random
    init the fast-variance BN statistics of near-constant channels make the
    gradients of two correct implementations differ by percents)."""
    with open(f'{CKPT_DIR}/ckpt-1800.msgpack', 'rb') as f:
        ckpt = serialization.msgpack_restore(f.read())
    variables = {'params': ckpt['params'], 'batch_stats': ckpt['batch_stats']}
    images, boxes, mask = step_batch()
    batch = {'image': images, 'boxes': boxes, 'box_mask': mask}
    bn_pallas._INTERPRET[0] = True
    try:
        _, step_j, state_j = jax_train_step(variables)
        trainer = Trainer.from_config(SMOKE, variables=variables, device='cpu',
                                      overrides=OVERRIDES)
        for fn in bn_kernel.KERNELS:
            fn.launches = 0
        before_p = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        before_j = from_jax_variables({'params': state_j.params})
        for step in range(2):
            state_j, metrics_j = step_j(state_j, batch, jax.random.PRNGKey(step))
            metrics = trainer.train_step(images, boxes, mask)
            for k in ('loss', 'class_loss', 'loc_loss'):
                np.testing.assert_allclose(metrics[k].item(), float(metrics_j[k]),
                                           rtol=1e-4, err_msg=f'step {step} {k}')
    finally:
        bn_pallas._INTERPRET[0] = False
    assert trainer.state.step == 2
    assert [fn.launches for fn in bn_kernel.KERNELS] == [0, 0, 0, 0]
    # no rounding difference can swap a mined negative
    assert len(mining_gaps) == 8 and min(mining_gaps) > 1e-4, mining_gaps

    after_p = trainer.model.state_dict()
    after_j = from_jax_variables({'params': state_j.params,
                                  'batch_stats': state_j.batch_stats})
    updates = {name: (after_j[name] - before).numpy()
               for name, before in before_j.items()}
    largest = max(np.abs(u).max() for u in updates.values())
    for name, want in updates.items():
        got = (after_p[name] - before_p[name]).numpy()
        if name.endswith('bn.bias'):  # a sum of dz: noise of the step's scale
            atol = 2e-4 * largest
        else:
            atol = 1e-3 * max(np.abs(want).max(), 1e-2 * largest)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
    stats = [k for k in after_j if k.endswith(('running_mean', 'running_var'))]
    assert len(stats) == 2 * 55  # 52 backbone BNs + 3 in the one extra
    for name in stats:
        np.testing.assert_allclose(after_p[name].numpy(), after_j[name].numpy(),
                                   rtol=1e-6, atol=1e-5, err_msg=name)
        assert not torch.equal(after_p[name], before_p[name]), name


def test_trainer_raises_on_what_is_not_ported():
    with pytest.raises(NotImplementedError, match='Unsupported augmentation'):
        Trainer.from_config(SMOKE, device='cpu', overrides={
            'augmentations': [{'name': 'Mosaic'}]})
    # the model axis is ported: what remains are the JAX engine's
    # ValueErrors, with processes in place of its devices
    for key in ('tensor_sharding', 'spatial_sharding', 'pipeline_sharding'):
        with pytest.raises(ValueError, match='needs at least 2 processes, '
                                             'have 1'):
            Trainer.from_config(SMOKE, device='cpu', overrides={
                'augmentations': [], 'train': {key: 2}})
        with pytest.raises(ValueError, match=r'must divide the process '
                                             r'count \(3\)'):
            Trainer.from_config(SMOKE, device='cpu', overrides={
                'augmentations': [], 'train': {key: 2}}, process_count=3,
                process_index=0)
    pipeline = {'augmentations': [], 'train': {'pipeline_sharding': 2}}
    with pytest.raises(ValueError, match='set train.frozen_bn'):
        Trainer.from_config(SMOKE, device='cpu', overrides=pipeline,
                            process_count=2, process_index=0)
    with pytest.raises(ValueError, match='does not compose with train.qat'):
        Trainer.from_config(SMOKE, device='cpu', overrides={
            'augmentations': [], 'train': {'pipeline_sharding': 2,
                                           'frozen_bn': True, 'qat': True}},
            process_count=2, process_index=0)
    with pytest.raises(ValueError, match=r'3 microbatches must divide the '
                                         r'per-device batch \(32\)'):
        Trainer.from_config(SMOKE, device='cpu', overrides={
            'augmentations': [], 'batch_size': 32, 'train': {
                'pipeline_sharding': 3, 'frozen_bn': True}},
            process_count=2, process_index=0)
    # train.zero_sharding is ported; one process has nothing to slice
    assert Trainer.from_config(SMOKE, device='cpu', overrides={
        'augmentations': [], 'train': {'zero_sharding': True}}).state.zero is None
    # mixup, EMA, frozen BN, fused steps and accumulation are ported
    trainer = Trainer.from_config(SMOKE, device='cpu', overrides={
        'augmentations': [], 'train': {
            'mixup': {'alpha': 0.2, 'p': 0.5}, 'ema': 0.999, 'frozen_bn': True,
            'fused_steps': 2, 'accumulation_steps': 2}})
    assert trainer.state.optimizer.accumulation_steps == 2
    assert trainer.ema == 0.999 and trainer.fused_steps == 2
    # the config's own CosineAnnealingWithWarmupLR is ported
    assert Trainer.from_config(SMOKE, device='cpu').schedule(0) == pytest.approx(1e-4)
    # the YUV420 staging is ported: the pipeline turns packed batches back
    # into RGB first (test_torch_port_data_extras.py holds it to JAX's)
    yuv = Trainer.from_config(SMOKE, device='cpu', overrides={
        'train': {'staging_colorspace': 'yuv420'}})
    assert yuv.pipeline.staging_yuv == (128, 128)


def test_trainer_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Trainer.from_config(SMOKE, overrides=OVERRIDES)
