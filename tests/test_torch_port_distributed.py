"""The port's data-parallel train step (``parallel/mesh.py``) against JAX's
data-parallel step and against its own one-process step, on the CPU.

Two ranks run over gloo in processes of their own (``_torch_dist.py``):
one launch per module runs every scenario, the JAX side runs here, once.

Tolerances:
- against JAX's step on a 2-device mesh, the small detector of
  ``tests/test_sharding.py`` from the same variables, with the tie-free
  ``naive_sampler``: JAX's own tolerances between its sharded and
  single-device steps (loss rtol 1e-4, BN statistics atol 1e-4, parameters
  atol 2e-2: the backward through 19 BNs amplifies reduction noise at
  random init), and besides each parameter's update (after - before)
  within 1e-3 of JAX's largest update, so that a step with no gradient
  all-reduce or no update at all cannot pass;
- against the port's one-process step on the same global batch, from the
  committed checkpoint's trained weights, with hard-negative mining: the
  augmentation draws bit-equal; the loss rtol 1e-4; every parameter's
  update within 5e-2 of the step's largest update (the backward through
  55 BNs amplifies the reduction order of two ranks' partial sums: 2.3 %
  of the largest update measured, in early and depthwise layers, the same
  against a one-process step with the ranks' BN; JAX's own sharded step
  is held at a looser 2e-2 absolute); the BN running statistics, direct
  reductions, rtol 1e-6, atol 1e-5, as ``test_torch_port_train.py`` holds
  them against JAX's (the ranks' BN takes flax's fast variance, one
  process PyTorch's batch norm);
- between the ranks, and between ZeRO-1 and the plain step: bit-equal.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_dist import SMALL, SMALL_LR, ZERO_TRAIN, rows, smoke_trainer, start
from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.ops import losses, matching, sampling
from single_shot_detection_tpu.ops.box_coder import BoxCoder
from single_shot_detection_tpu.parallel import create_mesh, replicated, shard_batch
from single_shot_detection_tpu.train import (create_train_state,
                                             make_train_step, optimizers)
from single_shot_detection_tpu_torch.data.datasets import Synthetic
from single_shot_detection_tpu_torch.models import builder as pt_builder
from single_shot_detection_tpu_torch.trainer import (FUSED_BN_MULTI_DEVICE_WARNING,
                                                     draw_rows)
from single_shot_detection_tpu_torch.utils.weights import (from_jax_variables,
                                                           to_jax_variables)

N = 2
# each parameter's update against JAX's, as a share of JAX's largest
# update (0.174 at lr 1e-2; 6.9e-5 of it measured)
JAX_UPDATE_TOL = 1e-3
SCENARIOS = ['vs_jax', 'planted', 'augmented', 'mixup', 'qat', 'fused_bn',
             'zero']


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    processes, and torch's default of one thread per core makes them
    contend for the CPU, tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_inputs():
    """The small detector's seeded weights and a global batch of 8 whose
    rank-0 images hold 1 GT box each and rank-1 images 3."""
    bundle = pt_builder.build(**SMALL)
    bundle.module.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(23)
    gt = np.array([[10, 10, 40, 40, 1, 1], [5, 30, 30, 60, 2, 1],
                   [35, 5, 60, 35, 1, 1]], np.float32)
    mask = np.zeros((8, 3), bool)
    mask[:4, 0] = True
    mask[4:] = True
    return {'state_dict': bundle.module.state_dict(),
            'image': rng.rand(8, 64, 64, 3).astype(np.float32),
            'boxes': np.tile(gt, (8, 1, 1)), 'box_mask': mask}


def smoke_batch():
    """Eight synthetic 128 px images with all their GT boxes."""
    data = Synthetic(num_images=8, image_size=128, num_classes=5, max_boxes=3,
                     seed=1)
    images = np.stack([a['image'] for a in data.annotations])
    boxes = np.zeros((8, 8, 6), np.float32)
    mask = np.zeros((8, 8), bool)
    for i, a in enumerate(data.annotations):
        boxes[i, :len(a['boxes'])] = a['boxes']
        mask[i, :len(a['boxes'])] = True
    return images, boxes, mask


@pytest.fixture(scope='module')
def launched(tmp_path_factory):
    """Every scenario on 2 ranks, in one launch, started first: the JAX
    step and the one-process references run here meanwhile."""
    images, boxes, mask = smoke_batch()
    inputs = {**small_inputs(), 'smoke': {'image': images, 'boxes': boxes,
                                          'box_mask': mask}}
    return start(SCENARIOS, tmp_path_factory.mktemp('dist'), inputs), inputs


@pytest.fixture(scope='module')
def ranks(launched, jax_step, one_process):
    finish, inputs = launched
    return finish(), inputs


@pytest.fixture(scope='module')
def jax_step(launched):
    """JAX's data-parallel step on a 2-device mesh from the port's seeded
    weights: ``(metrics, variables after)``."""
    _, inputs = launched
    bundle = jax_builder.build(
        base=SMALL['base'], anchor_generator=SMALL['anchor_generator'],
        num_classes=SMALL['num_classes'], features=SMALL['features'],
        input_size=SMALL['input_size'])
    criterion = losses.MultiboxLoss(sampling.naive_sampler, BoxCoder(10.0, 5.0),
                                    {'name': 'CrossEntropyLoss'},
                                    {'name': 'SmoothL1Loss'})
    tx = optimizers.create_optimizer({'name': 'SGD', 'lr': SMALL_LR})
    state = create_train_state(to_jax_variables(inputs['state_dict']), tx)
    step = make_train_step(bundle.module, criterion,
                           matching.TargetAssigner(0.5), bundle.anchors(), tx,
                           donate=False)
    mesh = create_mesh(n_data=N, devices=jax.devices()[:N])
    batch = shard_batch(mesh, {k: inputs[k] for k in
                               ('image', 'boxes', 'box_mask')})
    state, metrics = step(jax.device_put(state, replicated(mesh)), batch,
                          jax.random.PRNGKey(1))
    after = from_jax_variables({'params': jax.device_get(state.params),
                                'batch_stats': jax.device_get(state.batch_stats)})
    return {k: float(v) for k, v in metrics.items()}, after


def assert_matches_jax(result, jax_step, before):
    metrics, after = jax_step
    for k in ('loss', 'class_loss', 'loc_loss'):
        np.testing.assert_allclose(result['metrics'][k], metrics[k], rtol=1e-4,
                                   err_msg=k)
    got = result['state_dict']
    for name, want in after.items():
        atol = 1e-4 if name.endswith(('running_mean', 'running_var')) else 2e-2
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=0,
                                   atol=atol, err_msg=name)
    updates = {name: (want - before[name]).numpy()
               for name, want in after.items()
               if name.endswith(('weight', 'bias'))}
    largest = max(np.abs(u).max() for u in updates.values())
    errs = {name: np.abs((got[name] - before[name]).numpy() - u).max()
            for name, u in updates.items()}
    worst = max(errs, key=errs.get)
    print(f'JAX step: largest update {largest:.4g}; worst update error '
          f'{errs[worst]:.4g} ({errs[worst] / largest:.3g} of it) at {worst}')
    assert errs[worst] <= JAX_UPDATE_TOL * largest, (worst, errs[worst], largest)


def assert_ranks_equal(results, key):
    for r in range(1, N):
        for name, value in results[0][key]['state_dict'].items():
            assert torch.equal(results[r][key]['state_dict'][name], value), name
        assert results[r][key]['metrics'] == results[0][key]['metrics']


def test_two_ranks_match_jax_data_parallel_step(ranks, jax_step):
    results, inputs = ranks
    assert_ranks_equal(results, 'vs_jax')
    assert_matches_jax(results[0]['vs_jax'], jax_step, inputs['state_dict'])
    # the ranks held 4 and 12 positives' boxes: the loss is the global one
    assert results[0]['vs_jax']['metrics']['loss'] > 0


def test_per_rank_normaliser_is_caught(ranks, jax_step):
    """The planted fault: each rank divides by its own positive count (1 GT
    box an image on rank 0, 3 on rank 1).  It trains, and the comparison
    with JAX fails on it."""
    results, inputs = ranks
    planted = results[0]['planted']
    assert np.isfinite(planted['metrics']['loss'])
    with pytest.raises(AssertionError):
        assert_matches_jax(planted, jax_step, inputs['state_dict'])


@pytest.fixture(scope='module')
def one_process(launched):
    """The port's one-process steps on the whole global batch, each
    scenario's trainer at process_count 1."""
    _, inputs = launched
    smoke = inputs['smoke']
    batch = [smoke[k] for k in ('image', 'boxes', 'box_mask')]
    out = {}
    for key, train, over in (('augmented', {}, {}),
                             ('mixup', {'mixup': {'alpha': 0.4, 'p': 0.5}}, {}),
                             ('qat', {'qat': True}, {'augmentations': []})):
        trainer = smoke_trainer(0, 1, train, **over)
        draws = trainer.step_draws(0, len(batch[0]))
        metrics = trainer.train_step(*batch)
        out[key] = {'trainer': trainer, 'draws': draws,
                    'metrics': {k: v.item() for k, v in metrics.items()},
                    'state_dict': {k: v.clone() for k, v
                                   in trainer.model.state_dict().items()}}
    return out


def assert_matches_one_process(result, reference, before):
    for k in ('loss', 'class_loss', 'loc_loss'):
        np.testing.assert_allclose(result['metrics'][0][k],
                                   reference['metrics'][k], rtol=1e-4,
                                   err_msg=k)
    got, want = result['state_dict'], reference['state_dict']
    updates = {name: (want[name] - before[name]).numpy() for name in want
               if name.endswith(('weight', 'bias'))}
    largest = max(np.abs(u).max() for u in updates.values())
    for name, update in updates.items():
        step = (got[name] - before[name]).numpy()
        np.testing.assert_allclose(step, update, rtol=0, atol=5e-2 * largest,
                                   err_msg=name)
    for name in want:
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       rtol=1e-6, atol=1e-5, err_msg=name)


def draws_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(draws_equal(a[k], b[k]) for k in a)
    return len(a) == len(b) and all(draws_equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope='module')
def start_weights():
    return {k: v.clone() for k, v in smoke_trainer(0, 1).model.state_dict().items()}


def test_augmented_step_equals_one_process_step(ranks, one_process,
                                                start_weights):
    """The 2-rank step with the smoke config's augmentation equals the
    one-process step on the same global batch: rank r draws rows [4r, 4r +
    4) of the global batch's draws, bit for bit."""
    results, _ = ranks
    reference = one_process['augmented']
    for r in range(N):
        assert draws_equal(results[r]['augmented']['draws'][0],
                           draw_rows(reference['draws'][0], rows(r, N, 8)))
    assert_ranks_equal_steps(results, 'augmented')
    assert_matches_one_process(results[0]['augmented'], reference,
                               start_weights)


def assert_ranks_equal_steps(results, key):
    for r in range(1, N):
        assert results[r][key]['metrics'] == results[0][key]['metrics']
        for name, value in results[0][key]['state_dict'].items():
            assert torch.equal(results[r][key]['state_dict'][name], value), name


def test_mixup_pairs_rows_across_ranks(ranks, one_process, start_weights):
    """Mixup's draws are the global batch's (one ``lam``, a permutation of
    8 rows): rows pair across the ranks, and the step equals the
    one-process step."""
    results, _ = ranks
    reference = one_process['mixup']
    mixup = reference['draws'][1]
    crossing = [i for i in range(8)
                if bool(mixup['roll'][i]) and int(mixup['index'][i]) // 4 != i // 4]
    assert crossing, 'no mixed row took a partner from the other rank'
    for r in range(N):
        assert draws_equal(results[r]['mixup']['draws'][1], mixup)
    assert_ranks_equal_steps(results, 'mixup')
    assert_matches_one_process(results[0]['mixup'], reference, start_weights)


def test_qat_act_amax_is_the_global_batch_maximum(ranks, one_process):
    """QAT's activation scales are maxima over the global batch (JAX
    ``tests/test_sharding.py::test_qat_ema_train_step_on_mesh_agrees``):
    the stem's, which sees the raw images, equals the one-process one's,
    every other within JAX's rtol 0.5, and the ranks agree bit for bit."""
    results, _ = ranks
    got = results[0]['qat']['amax']
    want = one_process['qat']['trainer']
    from single_shot_detection_tpu_torch.export import quantize
    want = quantize.amax_from_batch_stats(want.model.state_dict())
    assert got and got.keys() == want.keys()
    assert results[1]['qat']['amax'] == got
    stem = 'features/base/stage0/conv'
    np.testing.assert_allclose(got[stem], want[stem], rtol=1e-5)
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=0.5, err_msg=key)


def test_fused_bn_under_two_ranks_warns_and_takes_the_synced_bn(ranks):
    """``train.fused_bn`` with several processes: the JAX engine's warning,
    the BN kernels off, and the synced step bit for bit."""
    results, _ = ranks
    for r in range(N):
        fused = results[r]['fused_bn']
        assert FUSED_BN_MULTI_DEVICE_WARNING in fused['log']
        assert not any(fused['fused'])
        assert fused['metrics'] == results[r]['augmented']['metrics']
        for name, value in results[r]['augmented']['state_dict'].items():
            assert torch.equal(fused['state_dict'][name], value), name


def test_zero_sharding_equals_the_plain_step(ranks):
    """ZeRO-1 (Adam, EMA, two micro-steps of accumulation, clipping): the
    update equals the plain 2-rank one bit for bit; each rank's optimizer
    state holds only its slices, which gather into the plain state."""
    results, _ = ranks
    for r in range(N):
        zero, plain = results[r]['zero']['zero'], results[r]['zero']['plain']
        assert zero['metrics'] == plain['metrics']
        for name, value in plain['state_dict'].items():
            assert torch.equal(zero['state_dict'][name], value), name
        for name, value in plain['ema_whole'].items():
            assert torch.equal(zero['ema_whole'][name], value), name
        axes = zero['axes']
        sliced = [name for name, axis in axes.items() if axis is not None]
        assert len(sliced) > len(axes) // 2
        for name, buffers in plain['buffers'].items():
            axis = axes[name]
            assert set(zero['buffers'][name]) == set(buffers)
            for key, whole in buffers.items():
                got = zero['buffers'][name][key]
                if axis is None:
                    assert torch.equal(got, whole), (name, key)
                    continue
                size = whole.shape[axis] // N
                assert got.shape[axis] == size, (name, key)
                assert torch.equal(got, whole.narrow(axis, r * size, size)), (
                    name, key)
        full, want = zero['full_state']['state'], plain['full_state']['state']
        assert full.keys() == want.keys()
        for i in want:
            for key in want[i]:
                assert torch.equal(full[i][key], want[i][key]), (i, key)
    assert ZERO_TRAIN['accumulation_steps'] == 2
