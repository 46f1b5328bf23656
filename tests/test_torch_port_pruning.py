"""Port parity for structured channel pruning (``train/pruning.py``), its
optimizer mask, its checkpoints and its place in ``Experiment`` and the CLI.

The JAX side (``single_shot_detection_tpu/train/pruning.py``) runs on the
port's seeded weights (``to_jax_variables``) with spaces from
``deps.analyze_module`` (a ``make_jaxpr``), eager numpy and optax, and one
jitted forward (the activation capture).  Tolerances: the criteria's L1 and
L2 norms rtol 1e-6, ``RandomSampling`` and the dead sets identical, the
pruned parameters and masks bit for bit, three masked SGD steps' parameters
and momentum traces rtol 1e-6 with atol 1e-7 (1e-6 of the gradients' 0.1
scale: XLA and torch round ``g + wd * p + m * t`` in their own order) and
every dead entry exactly 0, activation means atol 1e-5 of their scale.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from single_shot_detection_tpu.models import builder as jax_builder
from single_shot_detection_tpu.train import checkpoint as jax_ckpt
from single_shot_detection_tpu.train import deps as jax_deps
from single_shot_detection_tpu.train import optimizers as jax_optimizers
from single_shot_detection_tpu.train import pruning as jax_pruning
from single_shot_detection_tpu.train.state import create_train_state
from single_shot_detection_tpu_torch import cli
from single_shot_detection_tpu_torch.models import builder as pt_builder
from single_shot_detection_tpu_torch.train import checkpoint as ckpt
from single_shot_detection_tpu_torch.train import materialize, pruning
from single_shot_detection_tpu_torch.train import optimizers as pt_optimizers
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.train.state import TrainState
from single_shot_detection_tpu_torch.train.step import apply_gradients
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.weights import (_pruning_mask,
                                                           from_jax_variables,
                                                           to_jax_variables)

SMOKE = 'samples/synthetic_smoke.py'
# tests/test_materialize.py's flagship_like
FLAGSHIP_LIKE = dict(
    base={'name': 'mobilenet_v2', 'depth_multiplier': 0.35},
    anchor_generator={'type': 'ssd', 'num_scales': 3, 'min_scale': 0.2,
                      'max_scale': 0.9, 'aspect_ratios': [[1.0, 2.0]] * 3},
    num_classes=5, use_depthwise=True,
    features={'name': 'Features', 'out_layers': (13, 18)},
    extras={'layers': (('s', 64),)}, input_size=(96, 96))
SGD = {'name': 'SGD', 'lr': 0.1, 'momentum': 0.9, 'weight_decay': 5e-4}
PRUNER = {'include_paths': ['features', 'extra'], 'num': 12}


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
def flagship():
    """The seeded port model (BN statistics and affine parameters
    perturbed), its spaces, and the JAX module, variables and spaces."""
    bundle = pt_builder.build(**FLAGSHIP_LIKE)
    generator = torch.Generator().manual_seed(0)
    bundle.module.reset_parameters(generator)
    with torch.no_grad():
        for m in bundle.module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(1 + 0.2 * torch.randn(c, generator=generator))
                m.bias.copy_(0.2 * torch.randn(c, generator=generator))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=generator))
                m.running_var.copy_(0.5 + torch.rand(c, generator=generator))
    spaces = materialize.build_channel_spaces(bundle.module, bundle.input_size)
    variables = to_jax_variables(bundle.module.state_dict())
    jax_module = jax_builder.build(**FLAGSHIP_LIKE).module
    jax_spaces = jax_deps.analyze_module(jax_module, variables, (1, 96, 96, 3))
    return bundle, spaces, jax_module, variables, jax_spaces


def jax_params(variables):
    """The engine's params: a pytree round trip sorts every dict's keys."""
    return jax.tree_util.tree_map(jnp.asarray, variables['params'])


def port_state(model, mask=True, **sgd):
    return TrainState(model, pt_optimizers.create_optimizer(
        {**SGD, **sgd}, model.named_parameters()), mask={} if mask else None)


def assert_params_equal(model, params, **tol):
    want = from_jax_variables({'params': jax.tree_util.tree_map(np.asarray,
                                                                params)})
    for name, p in model.named_parameters():
        if tol:
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       err_msg=name, **tol)
        else:
            np.testing.assert_array_equal(p.detach().numpy(),
                                          want[name].numpy(), err_msg=name)


def assert_masks_equal(port_mask, jax_opt_state):
    want = _pruning_mask({'inner': jax_opt_state['inner'],
                          'mask': jax.tree_util.tree_map(np.asarray,
                                                         jax_opt_state['mask'])})
    assert port_mask.keys() == want.keys()
    for name, m in port_mask.items():
        assert torch.equal(m, want[name]), name


# ------------------------------------------------------------ order, scores

def test_kernel_order_is_the_engine_state_order(flagship):
    """The JAX engine's params went through pytree round trips, which sort
    each dict's keys, so ``conv_kernel_paths`` sees the kernels in sorted
    path order, not in the model's creation order (``stage10`` before
    ``stage2``); ``param_tree`` gives the port that order, and
    ``RandomSampling`` draws in it identically."""
    bundle, _, _, variables, _ = flagship
    created = jax_pruning.conv_kernel_paths(variables['params'])
    engine = jax_pruning.conv_kernel_paths(jax_params(variables))
    assert engine == sorted(created) and engine != created
    params = pruning.param_tree(bundle.module)
    assert pruning.conv_kernel_paths(params) == engine
    for include in (None, ['features'], ['extra0', 'stage1']):
        got = pruning.RandomSampling(params, include, seed=3)
        want = jax_pruning.RandomSampling(jax_params(variables), include,
                                          seed=3)
        for _ in range(2):  # a second round draws on from the same stream
            a, b = got.scores(params), want.scores(jax_params(variables))
            assert list(a) == list(b)
            for k in a:
                assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize('name', ['MinL1Norm', 'MinL2Norm'])
def test_norm_criteria_match_jax(flagship, name):
    bundle, _, _, variables, _ = flagship
    params = pruning.param_tree(bundle.module)
    for include in (None, ['features', 'extra']):
        got = pruning.CRITERIONS[name](params, include).scores(params)
        want = jax_pruning.CRITERIONS[name](
            jax_params(variables), include).scores(jax_params(variables))
        assert list(got) == list(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=str(k))


# ---------------------------------------------------------------- the pruner

def test_pruner_matches_jax_over_three_rounds(flagship):
    """``prune`` with the traced spaces: the same dead sets as JAX's after
    each of three rounds (writer groups shared), the parameters zeroed bit
    for bit like JAX's, and the port's mask equal to JAX's ``masked``
    state; the structural fallback without spaces and last-channel
    protection pick as JAX's do."""
    bundle, spaces, _, variables, jax_spaces = flagship
    model = copy.deepcopy(bundle.module)
    state = port_state(model)
    params = pruning.param_tree(model)
    pruner = pruning.Pruner(params, {'name': 'MinL1Norm'}, num=12,
                            include_paths=PRUNER['include_paths'],
                            spaces=spaces)
    tx = jax_pruning.masked(optax.sgd(1e-2))
    jstate = create_train_state({'params': jax_params(variables)}, tx)
    jpruner = jax_pruning.Pruner(jstate.params, {'name': 'MinL1Norm'},
                                 include_paths=PRUNER['include_paths'],
                                 num=12, spaces=jax_spaces)
    assert pruner.groups == jpruner.groups
    grouped = 0
    for _ in range(3):
        pruner.prune(state)
        jstate = jpruner.prune(jstate)
        assert pruner.dead == jpruner.dead
        assert_params_equal(model, jstate.params)
        assert_masks_equal(state.mask, jstate.opt_state)
        grouped = max(len(g) for g in pruner.groups.values())
    assert sum(len(d) for d in pruner.dead.values()) > 36 and grouped > 1

    # without spaces: MobileNetV2's residual chains by name
    fallback = pruning.Pruner(pruning.param_tree(bundle.module),
                              {'name': 'MinL2Norm'}, num=20)
    jfallback = jax_pruning.Pruner(jax_params(variables), {'name': 'MinL2Norm'},
                                   num=20)
    assert fallback.groups == jfallback.groups
    assert (fallback.select(pruning.param_tree(bundle.module))
            == jfallback.select(jax_params(variables)))

    # last-channel protection: every channel of the extras asked for
    greedy = pruning.Pruner(params, {'name': 'MinL1Norm'},
                            include_paths=['extra0'], num=10_000,
                            spaces=spaces)
    jgreedy = jax_pruning.Pruner(jstate.params, {'name': 'MinL1Norm'},
                                 include_paths=['extra0'], num=10_000,
                                 spaces=jax_spaces)
    picked = greedy.select(params)
    assert picked == jgreedy.select(jstate.params)
    for k in {k for k, _ in picked}:
        assert sum(1 for kk, _ in picked if kk == k) == params[k].shape[0] - 1


def test_data_dependent_criteria_rank_like_jax(flagship):
    """``activation_means`` (forward hooks, eval mode) against JAX's
    ``capture_intermediates`` means on the same batch; after the same
    observations ``MeanActivation`` and ``TaylorExpansion`` score and pick
    as JAX's do."""
    bundle, spaces, jax_module, variables, jax_spaces = flagship
    model = copy.deepcopy(bundle.module)
    x = np.random.RandomState(4).randn(2, 96, 96, 3).astype(np.float32)
    model.train()
    got = pruning.activation_means(model, torch.from_numpy(
        np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert model.training
    _, tree = jax.jit(lambda v, xx: jax_module.apply(
        v, xx, train=False, capture_intermediates=True,
        mutable=['intermediates']))(variables, x)
    want = {k: np.asarray(v) for k, v in
            jax_pruning.activation_means(tree['intermediates']).items()}
    assert set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(v).max()),
                                   err_msg=str(k))

    params = pruning.param_tree(model)
    jparams = jax_params(variables)
    for name in ('MeanActivation', 'TaylorExpansion'):
        pruner = pruning.Pruner(params, {'name': name}, num=12,
                                include_paths=PRUNER['include_paths'],
                                spaces=spaces)
        jpruner = jax_pruning.Pruner(jparams, {'name': name}, num=12,
                                     include_paths=PRUNER['include_paths'],
                                     spaces=jax_spaces)
        rs = np.random.RandomState(5)
        for _ in range(2):
            if name == 'MeanActivation':
                means = {k: v * rs.rand(*v.shape).astype(np.float32)
                         for k, v in want.items()}
                pruner.observe(means)
                jpruner.observe(means)
            else:
                grads = jax.tree_util.tree_map(
                    lambda p: (rs.randn(*p.shape) * 0.1).astype(np.float32),
                    variables['params'])
                port_grads = from_jax_variables({'params': grads})
                pruner.observe_grads(params, {
                    k: port_grads[pruning.param_name(k)] for k in params})
                jpruner.observe_grads(jparams, grads)
        a, b = pruner.criterion.scores(params), jpruner.criterion.scores(jparams)
        assert a.keys() == b.keys() and len(a) > 20
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=str(k))
        assert pruner.select(params) == jpruner.select(jparams)


# ----------------------------------------------------------- the masked step

def jax_update(tx):
    """The JAX train step's optimizer part, jitted (one compile)."""
    @jax.jit
    def update(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state
    return update


def test_masked_sgd_steps_match_jax(flagship):
    """Three steps (momentum 0.9, weight decay 5e-4) after a prune: the
    port's SGD with the mask applied after each step against JAX's
    ``masked(create_optimizer(...))`` on the same gradients, params and
    traces within the module's tolerance; every dead entry exactly 0; the
    live entries bit for
    bit those of an unmasked port step; a dead BN bias's momentum buffer
    still accumulating its gradient, as optax's trace does."""
    bundle, spaces, _, variables, jax_spaces = flagship
    model = copy.deepcopy(bundle.module)
    state = port_state(model)
    pruner = pruning.Pruner(pruning.param_tree(model), {'name': 'MinL1Norm'},
                            include_paths=PRUNER['include_paths'], num=12,
                            spaces=spaces)
    pruner.prune(state)
    free = port_state(copy.deepcopy(model), mask=False)

    tx = jax_pruning.masked(jax_optimizers.create_optimizer(
        dict(SGD), lr_schedule=lambda count: 0.1))
    jstate = create_train_state({'params': jax_params(variables)}, tx)
    jpruner = jax_pruning.Pruner(jstate.params, {'name': 'MinL1Norm'},
                                 include_paths=PRUNER['include_paths'],
                                 num=12, spaces=jax_spaces)
    jstate = jpruner.prune(jstate)
    params, opt_state = jstate.params, jstate.opt_state
    update = jax_update(tx)
    rs = np.random.RandomState(7)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (rs.randn(*p.shape) * 0.1).astype(np.float32),
            variables['params'])
        params, opt_state = update(params, opt_state, grads)
        port_grads = from_jax_variables({'params': grads})
        for st in (state, free):
            for name, p in st.model.named_parameters():
                p.grad = port_grads[name].clone()
            apply_gradients(st, lambda step: 0.1)
    assert_params_equal(model, params, rtol=1e-6, atol=1e-7)
    trace = from_jax_variables({'params': jax.tree_util.tree_map(
        np.asarray, opt_state['inner'][1].trace)})
    free_params = dict(free.model.named_parameters())
    dead_bias_moved = False
    for name, p in model.named_parameters():
        buf = state.optimizer.state[p]['momentum_buffer']
        np.testing.assert_allclose(buf.numpy(), trace[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        if name not in state.mask:
            assert torch.equal(p, free_params[name]), name
            continue
        live = state.mask[name].expand_as(p) == 1
        assert torch.all(p[~live] == 0), name
        assert torch.equal(p[live], free_params[name][live]), name
        if name.endswith('bn.bias'):
            dead_bias_moved |= bool(torch.any(buf[~live] != 0))
    assert dead_bias_moved


# ------------------------------------------------------------- checkpoints

def test_masked_states_round_trip(flagship, tmp_path):
    """A masked JAX state written by JAX ``checkpoint.save`` (``opt_state =
    {'inner': <SGD chain>, 'mask': tree}``) loads into a pruned port state
    with its mask (HWIO ``[1, 1, 1, C]`` as ``[C, 1, 1, 1]``) and its
    trace; the port's ``.pt`` round-trips the mask; a state without a mask
    (no ``train.pruner``) drops it; ``Pruner.dead`` is not checkpointed.
    ``Trainer`` gives a ``train.pruner`` run its (empty) mask."""
    assert Trainer.from_config(SMOKE, device='cpu', overrides={
        'train': {'pruner': dict(PRUNER)}}).state.mask == {}
    bundle, _, _, variables, jax_spaces = flagship
    tx = jax_pruning.masked(jax_optimizers.create_optimizer(
        dict(SGD), lr_schedule=lambda count: 0.1))
    jstate = create_train_state({'params': jax_params(variables),
                                 'batch_stats': variables['batch_stats']}, tx)
    jpruner = jax_pruning.Pruner(jstate.params, {'name': 'MinL1Norm'}, num=12,
                                 include_paths=PRUNER['include_paths'],
                                 spaces=jax_spaces)
    jstate = jpruner.prune(jstate)
    grads = jax.tree_util.tree_map(
        lambda p: np.full(p.shape, 0.01, np.float32), variables['params'])
    params, opt_state = jax_update(tx)(jstate.params, jstate.opt_state, grads)
    jstate = jstate.replace(params=params, opt_state=opt_state,
                            step=jstate.step + 1)
    path = jax_ckpt.save(str(tmp_path / 'jax'), jstate, epoch=0)
    assert set(serialization.to_state_dict(jstate)['opt_state']) == {
        'inner', 'mask'}

    state = port_state(copy.deepcopy(bundle.module))
    ckpt.restore(path, state)
    assert state.step == 1
    assert_params_equal(state.model, jstate.params)
    assert_masks_equal(state.mask, jstate.opt_state)
    assert len(state.mask) >= 12
    trace = from_jax_variables({'params': jax.tree_util.tree_map(
        np.asarray, jstate.opt_state['inner'][1].trace)})
    for name, p in state.model.named_parameters():
        assert torch.equal(state.optimizer.state[p]['momentum_buffer'],
                           trace[name]), name

    pt = ckpt.save(str(tmp_path / 'port'), state, epoch=0)
    again = port_state(copy.deepcopy(bundle.module))
    ckpt.restore(pt, again)
    assert again.mask.keys() == state.mask.keys()
    for name, m in state.mask.items():
        assert torch.equal(again.mask[name], m), name
    unpruned = port_state(copy.deepcopy(bundle.module), mask=False)
    ckpt.restore(pt, unpruned)
    assert unpruned.mask is None


def test_experiment_prunes_each_epoch_and_the_cli_runs(tmp_path,
                                                       monkeypatch):
    """``Experiment`` with ``train.pruner`` and ``fused_bn``: a prune at
    the start of each epoch (the first included), the mask applied by
    every step (dead entries exactly 0 after training); a resumed run
    prunes again at its first epoch, from an empty dead set; the CLI trains
    a pruned run with ``MeanActivation`` observed on every step and writes
    its mask.  The four runs share one architecture, so its channel spaces
    are traced once."""
    traced = []

    def spaces_once(model, input_size):
        if not traced:
            traced.append(build_spaces(model, input_size))
        return traced[0]

    build_spaces = materialize.build_channel_spaces
    monkeypatch.setattr(materialize, 'build_channel_spaces', spaces_once)
    overrides = {'train': {'epochs': 2, 'fused_bn': True, 'eval_every': 10,
                           'save_every': 2, 'num_batches_per_epoch': 2,
                           'pruner': {**PRUNER, 'num': 5}}}
    exp = Experiment(SMOKE, phases=('train',), device='cpu',
                     overrides=overrides, checkpoint_dir=str(tmp_path / 'a'))
    calls = []
    prune = exp.pruner.prune
    exp.pruner.prune = lambda state: calls.append(state.step) or prune(state)
    exp.train()
    assert calls == [0, 2]
    assert sum(len(d) for d in exp.pruner.dead.values()) >= 10
    params = dict(exp.model.named_parameters())
    for name, m in exp.trainer.state.mask.items():
        assert torch.all(params[name].detach()[m.expand_as(params[name]) == 0]
                         == 0), name

    resumed = Experiment(SMOKE, phases=('train',), device='cpu',
                         overrides={'train': {**overrides['train'],
                                              'epochs': 3}},
                         checkpoint_dir=str(tmp_path / 'a'),
                         resume_from=str(tmp_path / 'a'))
    assert resumed.start_epoch == 2 and not resumed.pruner.dead
    assert resumed.trainer.state.mask.keys() == exp.trainer.state.mask.keys()
    resumed.train()
    assert sum(len(d) for d in resumed.pruner.dead.values()) >= 5

    config = tmp_path / 'pruned.py'
    pruner = {**PRUNER, 'observe_every': 1,
              'criterion': {'name': 'MeanActivation'}}
    with open(SMOKE) as f:
        config.write_text(f.read() + f"\ntrain = {{**train, 'epochs': 2, "
                          f"'num_batches_per_epoch': 2, 'eval_every': 2, "
                          f"'pruner': {pruner!r}}}\n")
    cli_exp, _ = cli.main(['--cpu', '--config', str(config), '--save-dir',
                           str(tmp_path / 'runs'), '--phases', 'train',
                           'eval'])
    assert len(cli_exp.pruner.criterion.ema) > 50
    assert sum(len(d) for d in cli_exp.pruner.dead.values()) >= 12
    assert len(traced) == 1
    saved = torch.load(ckpt.find_latest(cli_exp.checkpoint_dir),
                       weights_only=True)
    assert saved['mask'].keys() == cli_exp.trainer.state.mask.keys()
    assert os.path.exists(os.path.join(cli_exp.checkpoint_dir, 'log.csv'))
