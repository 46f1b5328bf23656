"""Tensor (channel) sharding over processes (``train.tensor_sharding``,
``parallel/tensor.py``) against the JAX package's ``tensor_state_sharding``
and its sharded step, and against the port's one-process runs, on the CPU.

Two ranks run over gloo (``_torch_dist.py``), one launch for the module;
the JAX side runs here meanwhile.

Tolerances:
- the placement: equal, leaf by leaf, to JAX's on a ``(1, 2)`` and a
  ``(2, 4)`` mesh with ``zero=True`` (parameters, BN statistics, Adam's
  moments, the EMA shadow), matched by flax name;
- the 2-rank step of the small detector against JAX's step under
  ``tensor_state_sharding`` on a ``(1, 2)`` mesh: JAX
  ``test_sharding.py``'s tolerances for that step (loss rtol 1e-4, BN
  statistics atol 1e-4, parameters atol 2e-2; JAX's sharded step is 2.9e-3
  of its largest update from the port's in an early depthwise layer,
  where the backward through the BNs amplifies GSPMD's reduction order);
  the ranks' whole states bit-equal;
- against the port's one-process step (which ``test_torch_port_train.py``
  holds against JAX's): loss rtol 1e-5, each parameter's update within
  1e-4 of the step's largest update, the BN statistics atol 1e-5;
- ``Experiment(process_count=2)`` against one process: JAX
  ``test_engine.py``'s (train and eval loss rtol 2e-4, mAP equal), the
  parameters' digest rel 1e-5;
- checkpoints: a restore is bit-equal to the state saved.
"""

import numpy as np
import pytest
import torch

import jax
from _torch_dist import (SMALL, SMALL_LR, assert_matches_step, axis_step,
                         start)
from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.ops import losses, matching, sampling
from single_shot_detection_tpu.ops.box_coder import BoxCoder
from single_shot_detection_tpu.parallel import (create_mesh, shard_batch,
                                                tensor_state_sharding)
from single_shot_detection_tpu.train import (create_train_state,
                                             make_train_step, optimizers)
from single_shot_detection_tpu_torch import parallel
from single_shot_detection_tpu_torch.models import builder as pt_builder
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.utils.weights import (from_jax_variables,
                                                           to_jax_variables,
                                                           variable_path)
from test_torch_port_multiprocess import config

N = 2
AXIS_CFG = {"'optimizer': {'name': 'SGD', 'lr': 1e-3, 'momentum': 0.9}":
            "'optimizer': {'name': 'SGD', 'lr': 1e-3, 'momentum': 0.9}, "
            "'tensor_sharding': 2"}


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
    first four images hold 1 GT box each and the others 3."""
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


@pytest.fixture(scope='module')
def launched(tmp_path_factory):
    """Every scenario on 2 ranks in one launch, after a one-process run
    wrote the checkpoint they resume."""
    tmp = tmp_path_factory.mktemp('tensor')
    single_dir = tmp / 'one_process'
    Experiment(config(tmp, 'plain1'), phases=('train',), device='cpu',
               checkpoint_dir=str(single_dir)).train()
    inputs = {**small_inputs(), 'axis_cfg': config(tmp, 'axis', **AXIS_CFG),
              'one_process_dir': str(single_dir)}
    finish = start(['tensor_step', 'tensor_planted', 'experiment_axis',
                    'tensor_checkpoints', 'tensor_group_norm'], tmp, inputs)
    return finish, inputs, tmp


def small_jax_bundle():
    return jax_builder.build(
        base=SMALL['base'], anchor_generator=SMALL['anchor_generator'],
        num_classes=SMALL['num_classes'], features=SMALL['features'],
        input_size=SMALL['input_size'])


@pytest.fixture(scope='module')
def jax_side(launched):
    """JAX's step under ``tensor_state_sharding`` on a (1, 2) mesh from the
    port's seeded weights, and the placements of an Adam state with EMA
    on a (1, 2) and a (2, 4) mesh."""
    _, inputs, _ = launched
    bundle = small_jax_bundle()
    variables = to_jax_variables(inputs['state_dict'])
    placements = {}
    adam = optimizers.create_optimizer({'name': 'Adam', 'lr': 1e-3})
    adam_state = create_train_state(variables, adam, ema=True)
    for shape in ((1, 2), (2, 4)):
        mesh = create_mesh(n_data=shape[0], n_model=shape[1],
                           devices=jax.devices()[:shape[0] * shape[1]])
        placements[shape] = (adam_state, tensor_state_sharding(
            mesh, adam_state, zero=True))
    criterion = losses.MultiboxLoss(sampling.naive_sampler, BoxCoder(10.0, 5.0),
                                    {'name': 'CrossEntropyLoss'},
                                    {'name': 'SmoothL1Loss'})
    tx = optimizers.create_optimizer({'name': 'SGD', 'lr': SMALL_LR})
    state = create_train_state(variables, tx)
    mesh = create_mesh(n_data=1, n_model=N, devices=jax.devices()[:N])
    tp = tensor_state_sharding(mesh, state)
    step = make_train_step(bundle.module, criterion,
                           matching.TargetAssigner(0.5), bundle.anchors(), tx,
                           donate=False, state_sharding=tp)
    batch = shard_batch(mesh, {k: inputs[k] for k in
                               ('image', 'boxes', 'box_mask')})
    state, metrics = step(jax.device_put(state, tp), batch,
                          jax.random.PRNGKey(1))
    after = from_jax_variables({'params': jax.device_get(state.params),
                                'batch_stats': jax.device_get(state.batch_stats)})
    return {k: float(v) for k, v in metrics.items()}, after, placements


@pytest.fixture(scope='module')
def ranks(launched, jax_side):
    finish, inputs, tmp = launched
    return finish(), inputs, tmp


def jax_specs(state, sharding) -> dict:
    """``{(attributes, flax keys): spec padded to the leaf's rank}`` of a
    placement tree."""
    out = {}
    leaves = jax.tree_util.tree_leaves(state)
    for (path, s), leaf in zip(
            jax.tree_util.tree_flatten_with_path(sharding)[0], leaves):
        keys = tuple(str(p.key) for p in path if hasattr(p, 'key'))
        attrs = tuple(str(p.name) for p in path if hasattr(p, 'name'))
        spec = tuple(s.spec) + (None,) * (np.ndim(leaf) - len(s.spec))
        out[attrs, keys] = spec
    return out


def port_spec(shape, model_axis, data_axis) -> tuple:
    """A port leaf's model and data axes as the JAX leaf's spec."""
    order = parallel.mesh.jax_axes(len(shape))
    spec = [None] * len(shape)
    if model_axis is not None:
        spec[order.index(model_axis)] = 'model'
    if data_axis is not None:
        spec[order.index(data_axis)] = 'data'
    return tuple(spec)


@pytest.mark.parametrize('shape', [(1, 2), (2, 4)])
def test_placement_matches_jax(jax_side, shape):
    """Parameters and BN statistics slice the JAX last axis over 'model'
    where it divides; Adam's moments and the EMA shadow follow, with ZeRO
    on their largest remaining axis over 'data'."""
    state, sharding = jax_side[2][shape]
    n_data, m = shape
    model = pt_builder.build(**SMALL).module
    model_axes = parallel.tensor_state_sharding(model.state_dict().items(), m)
    zero_axes = parallel.zero_state_sharding(model.named_parameters(), n_data,
                                             model_axes)
    want = {}
    for name, t in model.state_dict().items():
        path = variable_path(name, t.dim())
        if path is None:
            continue
        want[(), path[1:]] = port_spec(t.shape, model_axes[name], None)
    for name, t in model.named_parameters():
        keys = variable_path(name, t.dim())[1:]
        spec = port_spec(t.shape, model_axes[name], zero_axes[name])
        for moment in ('mu', 'nu'):
            want[(moment,), keys] = spec
        want[(), keys + ('ema',)] = spec
    got = {}
    for collection in ('params', 'batch_stats'):
        for (attrs, keys), spec in jax_specs(getattr(state, collection),
                                             getattr(sharding, collection)
                                             ).items():
            got[(), keys] = spec
    for (attrs, keys), spec in jax_specs(state.opt_state,
                                         sharding.opt_state).items():
        if attrs in (('mu',), ('nu',)):
            got[attrs, keys] = spec
    for (attrs, keys), spec in jax_specs(state.ema_params,
                                         sharding.ema_params).items():
        got[(), keys + ('ema',)] = spec
    assert got == want
    assert any('model' in s for s in got.values())
    if n_data > 1:
        assert any('model' in s and 'data' in s for s in got.values())


def assert_matches_jax(result, jax_side, before):
    metrics, after, _ = jax_side
    for k in ('loss', 'class_loss', 'loc_loss'):
        np.testing.assert_allclose(result['metrics'][k], metrics[k], rtol=1e-4,
                                   err_msg=k)
    got = result['state_dict']
    for name, want in after.items():
        atol = 1e-4 if name.endswith(('running_mean', 'running_var')) else 2e-2
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=0,
                                   atol=atol, err_msg=name)


def test_two_rank_tensor_step_matches_jax(ranks, jax_side):
    results, inputs, _ = ranks
    first = results[0]['tensor_step']
    for r in range(1, N):
        assert results[r]['tensor_step']['metrics'] == first['metrics']
        for name, value in first['state_dict'].items():
            assert torch.equal(results[r]['tensor_step']['state_dict'][name],
                               value), name
    assert_matches_jax(first, jax_side, inputs['state_dict'])
    assert_matches_step(first, axis_step(0, 1, inputs, None, 1),
                        inputs['state_dict'])
    # each rank holds its slices: about half the one-process bytes
    whole = sum(t.numel() * 4 for n, t in inputs['state_dict'].items()
                if not n.endswith(('running_mean', 'running_var',
                                   'num_batches_tracked')))
    assert 0.5 * whole <= first['bytes'] < 0.55 * whole
    model = pt_builder.build(**SMALL).module
    assert first['sliced'] == sum(
        a is not None for a in parallel.tensor_state_sharding(
            model.state_dict().items(), N).values())


def test_world_normaliser_is_caught(ranks, jax_side):
    """The planted fault: the loss's positive count summed over the world,
    each model group's count twice.  It trains, and the comparison with
    JAX fails on it."""
    results, inputs, _ = ranks
    planted = results[0]['tensor_planted']
    assert np.isfinite(planted['metrics']['loss'])
    with pytest.raises(AssertionError):
        assert_matches_jax(planted, jax_side, inputs['state_dict'])


def test_experiment_matches_one_process(ranks):
    results, inputs, tmp = ranks
    got = [r['experiment_axis'] for r in results]
    assert got[0] == got[1]
    exp = Experiment(config(tmp, 'single'), device='cpu', debug=True)
    rows_ = exp.train()
    digest = float(sum(p.detach().abs().sum().item()
                       for p in exp.model.parameters()))
    last, want = got[0]['rows'][-1], rows_[-1]
    assert last['train_loss'] == pytest.approx(want['train_loss'], rel=2e-4)
    assert last['eval_loss'] == pytest.approx(want['eval_loss'], rel=2e-4)
    assert last['eval_mAP'] == want['eval_mAP']
    assert got[0]['digest'] == pytest.approx(digest, rel=1e-5)


def test_checkpoints_restore_both_ways(ranks):
    """A tensor-sharded run resumes a one-process checkpoint (its whole
    state bit-equal to the file's), and a one-process run resumes the
    tensor-sharded run's, bit-equal to the state the ranks gathered."""
    results, inputs, tmp = ranks
    from single_shot_detection_tpu_torch.train import checkpoint
    single = torch.load(checkpoint.find_latest(inputs['one_process_dir']),
                        weights_only=False)
    for r in range(N):
        resumed = results[r]['tensor_checkpoints']['resumed']
        assert resumed['step'] == single['step']
        for name, value in single['model'].items():
            assert torch.equal(resumed['state'][name], value), name
    saved = results[0]['tensor_checkpoints']['saved']
    exp = Experiment(config(tmp, 'plain2'), phases=('train',), device='cpu',
                     resume_from=saved['dir'])
    for name, value in exp.model.state_dict().items():
        assert torch.equal(value, saved['model'][name]), name
    momentum = {id(p): s['momentum_buffer']
                for p, s in exp.trainer.state.optimizer.state.items()}
    params = list(exp.model.parameters())
    for i, p in enumerate(params):
        assert torch.equal(momentum[id(p)],
                           saved['optimizer'][i]['momentum_buffer'])


def test_group_norm_step_matches_one_process(ranks):
    """``train.group_norm`` under tensor sharding: a group spans channels
    (gathered with its parameters and cut back); the step
    against the one-process GroupNorm step at the step's tolerances."""
    results, inputs, _ = ranks
    first = results[0]['tensor_group_norm']
    assert results[1]['tensor_group_norm']['metrics'] == first['metrics']
    assert_matches_step(first, axis_step(0, 1, inputs, None, 1, group_norm=8),
                        inputs['state_dict'])
