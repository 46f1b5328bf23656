"""Port parity for checkpoints, weight files and schedules: the flax-free
msgpack reader (``utils/flax_msgpack.py``), ``from_jax_state``
(``utils/weights.py``), the SGD state restored from a JAX checkpoint
against optax, every learning-rate schedule and ``ReduceLROnPlateau``
against the JAX ones, ``train/checkpoint.py`` against the JAX module, the
``Experiment``'s resume against an uninterrupted run, and ``model.base.weight`` (``utils/torch_import.py``) against
the JAX import.

Tolerances: the reader's leaves, the restored model and momentum, the
resumed run and the imported backbone exact; an SGD step after a restore
within rtol 1e-6 / atol 1e-8 of optax's; schedules within rtol 1e-6, or
1e-7 of the base rate where the JAX schedule's float32 cosine loses its
relative precision near its minimum; the plateau's scales equal.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from single_shot_detection_tpu.train import checkpoint as jax_ckpt
from single_shot_detection_tpu.train import optimizers as jax_optimizers
from single_shot_detection_tpu.train import schedulers as jax_schedulers
from single_shot_detection_tpu.train.state import create_train_state
from single_shot_detection_tpu.utils import torch_import as jax_torch_import
from single_shot_detection_tpu_torch.train import checkpoint as ckpt
from single_shot_detection_tpu_torch.train import schedulers
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.train.step import apply_gradients
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils import (flax_msgpack, keras_import,
                                                   torch_import)
from single_shot_detection_tpu_torch.utils.weights import (from_jax_state,
                                                           from_jax_variables)

from _torch_helpers import fill_synthetic_state_dict
from _torch_port_fixtures import one_torch_thread  # noqa: F401

SMOKE = 'samples/synthetic_smoke.py'
CKPT_DIR = 'experiments/2026-08-16-225820'   # SMOKE's model, trained
CKPT = f'{CKPT_DIR}/ckpt-1800.msgpack'
CKPT_CONFIG = f'{CKPT_DIR}/config.py'
CKPT_STEPS_PER_EPOCH = 12   # 96 train images in batches of 8


@pytest.fixture(scope='module')
def flax_raw():
    with open(CKPT, 'rb') as f:
        return serialization.msgpack_restore(f.read())


def to_jax_variables(state_dict) -> dict:
    """The inverse of ``from_jax_variables``: a port ``state_dict`` as a
    JAX ``{'params', 'batch_stats'}`` tree of numpy arrays."""
    out = {'params': {}, 'batch_stats': {}}
    for name, value in state_dict.items():
        *module, leaf = name.split('.')
        if leaf == 'num_batches_tracked':
            continue
        arr = value.detach().numpy()
        if leaf in ('running_mean', 'running_var'):
            coll, key = 'batch_stats', {'running_mean': 'mean',
                                        'running_var': 'var'}[leaf]
        elif leaf == 'weight' and arr.ndim == 4:
            coll, key, arr = 'params', 'kernel', arr.transpose(2, 3, 1, 0)
        else:
            coll, key = 'params', {'weight': 'scale', 'bias': 'bias'}[leaf]
        node = out[coll]
        for part in module:
            node = node.setdefault(part, {})
        node[key] = np.array(arr)
    return out


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


# ---------------------------------------------------------- msgpack reader

def test_msgpack_reader_equals_flax_on_the_committed_checkpoint(flax_raw):
    got = flax_msgpack.read(CKPT)
    want = leaves(flax_raw)
    assert [p for p, _ in leaves(got)] == [p for p, _ in want]
    assert len(want) == 467
    for (path, g), (_, w) in zip(leaves(got), want):
        assert type(g) is type(w), path
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


@pytest.mark.parametrize('chunked', [False, True])
def test_msgpack_reader_equals_flax_on_written_trees(chunked, monkeypatch):
    """A tree written by flax ``to_bytes``: numpy scalars, 0-d, empty and
    bf16 arrays, an empty dict, a tuple, ints of every width, floats,
    strings, bytes, None, bools and a complex; with ``chunked``, flax's
    chunked form of large leaves (the limit lowered to 64 bytes)."""
    rs = np.random.RandomState(0)
    tree = {
        'scalar_f32': np.float32(3.5), 'scalar_i8': np.int8(-3),
        'zero_d': np.zeros((), np.int64), 'empty': np.zeros((0, 3), np.float32),
        'bf16': (jnp.asarray(rs.randn(2, 7)) * 3).astype(jnp.bfloat16),
        'f16': rs.randn(5).astype(np.float16), 'u8': np.arange(9, dtype=np.uint8),
        'bools': np.array([True, False]), 'f64': rs.randn(3, 2),
        'big': rs.randn(40, 30).astype(np.float32), 'e': {},
        'tuple': (1, 2.5, 'x', None, True, b'raw'),
        'ints': [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 40, -1,
                 -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 40],
        'complex': 1 + 2j, 'text': 'é' * 40, 'blob': bytes(300),
    }
    if chunked:
        monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)
    data = serialization.to_bytes(tree)
    if chunked:
        assert '__msgpack_chunked_array__' in flax_msgpack.unpackb(data)['big']
    got = flax_msgpack.msgpack_restore(data)
    want = serialization.msgpack_restore(data)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert got['e'] == {} and got['tuple']['5'] == b'raw'
    for (path, g), (_, w) in zip(leaves(got), leaves(want)):
        if getattr(w, 'dtype', None) == jnp.bfloat16:  # widened, exactly
            assert g.dtype == np.float32 and g.shape == w.shape, path
            np.testing.assert_array_equal(g, np.asarray(w, np.float32))
            continue
        assert type(g) is type(w), path
        if isinstance(w, (np.ndarray, np.generic)):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert g.tobytes() == w.tobytes(), path
        else:
            assert g == w, path


def test_msgpack_reader_rejects_what_flax_does_not_write():
    for data, match in ((b'\xc1', 'type byte'), (b'\xd4\x05\x00', 'ext type 5'),
                        (b'\x92\x01', 'truncated'), (b'\x01\x02', 'left after')):
        with pytest.raises(ValueError, match=match):
            flax_msgpack.unpackb(data)


# ---------------------------------------------------------- from_jax_state

def test_from_jax_state_on_the_committed_checkpoint(flax_raw):
    """The model equals ``from_jax_variables``' exactly, each momentum
    buffer is the transposed trace exactly, step 1800, ``lr_scale`` 1; a
    resume from the directory starts at epoch 150 with the buffers in the
    optimizer."""
    state = from_jax_state(flax_msgpack.read(CKPT))
    assert state['step'] == 1800 and state['lr_scale'] == 1.0
    want = from_jax_variables(flax_raw)
    assert state['model'].keys() == want.keys()
    for k in want:
        assert torch.equal(state['model'][k], want[k]), k
    trace = flax_raw['opt_state']['0']['trace']
    assert set(flax_raw['opt_state']) == {'0', '1'}   # no weight decay
    kernel = trace['features']['base']['stage3']['expand_conv']['kernel']
    assert torch.equal(state['momentum']['features.base.stage3.expand_conv.weight'],
                       torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
    flat = dict(leaves(trace))
    assert len(state['momentum']) == len(flat) == 177
    params = from_jax_variables({'params': trace})
    for k, v in state['momentum'].items():
        assert torch.equal(v, params[k]), k

    exp = Experiment(CKPT_CONFIG, phases=('train',), device='cpu',
                     resume_from=CKPT_DIR)
    assert exp.start_epoch == 150 and exp.trainer.state.step == 1800
    opt = exp.trainer.state.optimizer
    for name, p in exp.model.named_parameters():
        assert torch.equal(opt.state[p]['momentum_buffer'], params[name]), name
        assert torch.equal(p.detach(), want[name]), name


def test_from_jax_state_finds_the_trace_by_structure(caplog):
    trace = {'head': {'kernel': np.ones((3, 3, 2, 4), np.float32),
                      'bias': np.zeros(4, np.float32)}}
    base = {'step': np.int32(7), 'lr_scale': np.float32(0.5),
            'params': trace, 'batch_stats': {}}
    count = {'count': np.int32(7)}
    with_wd = from_jax_state({**base, 'opt_state': {'0': {}, '1': {'trace': trace},
                                                    '2': count}})
    assert with_wd['step'] == 7 and with_wd['lr_scale'] == 0.5
    assert with_wd['momentum']['head.weight'].shape == (4, 2, 3, 3)
    assert from_jax_state({**base, 'opt_state': {'0': count}})['momentum'] is None
    # Adam's and multi_transform's states are found by structure too; two
    # traces in one group, or a state no optimizer has, raise
    adam = from_jax_state({**base, 'opt_state': {
        '0': {'count': 1, 'mu': trace, 'nu': trace}, '1': count}})
    assert set(adam['optimizer']['groups']['__default__']['buffers']) == {'mu', 'nu'}
    groups = from_jax_state({**base, 'opt_state': {'inner_states': {
        'a': {'inner_state': count}}}})['optimizer']['groups']
    assert groups['a']['counts'] == [7]
    for opt_state in ({'0': {'trace': trace}, '1': {'trace': trace}},
                      {'0': {'velocity': trace}}):
        with pytest.raises(ValueError):
            from_jax_state({**base, 'opt_state': opt_state})
    ema = from_jax_state({**base, 'opt_state': {'0': count}, 'ema_params': trace})
    assert ema['ema']['head.weight'].shape == (4, 2, 3, 3)


# ------------------------------------------- optimizer parity after restore

def jax_update(tx):
    """The JAX train step's optimizer part (``train/step.py``), jitted:
    ``update(params, opt_state, grads, lr_scale) -> (params, opt_state)``."""
    @jax.jit
    def update(params, opt_state, grads, lr_scale):
        updates, opt_state = tx.update(grads, opt_state, params)
        updates = jax.tree_util.tree_map(lambda u: u * lr_scale, updates)
        return optax.apply_updates(params, updates), opt_state
    return update


def seeded_grads(params, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (rs.randn(*p.shape) * 0.1).astype(np.float32), params)


def assert_port_matches(trainer, params, trace):
    """The port's parameters and momentum buffers against a JAX params and
    trace tree: rtol 1e-6 / atol 1e-8."""
    want_p = from_jax_variables({'params': params})
    want_t = from_jax_variables({'params': trace})
    opt = trainer.state.optimizer
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=name)
        np.testing.assert_allclose(opt.state[p]['momentum_buffer'].numpy(),
                                   want_t[name].numpy(), rtol=1e-6, atol=1e-8,
                                   err_msg=name)


@pytest.mark.parametrize('count', [1800, 900])
def test_restored_sgd_step_matches_optax(flax_raw, count):
    """From the committed checkpoint (its cosine schedule with warmup, no
    weight decay) at optimizer count 1800, where the schedule has reached
    0, and 900: a seeded gradient through JAX ``create_optimizer`` with the
    restored ``opt_state`` and through the port's restored SGD."""
    trainer = Trainer.from_config(CKPT_CONFIG, device='cpu',
                                  steps_per_epoch=CKPT_STEPS_PER_EPOCH)
    ckpt.restore(CKPT, trainer.state)
    trainer.state.step = count
    from single_shot_detection_tpu.utils.config import load_config
    cfg = load_config(CKPT_CONFIG, phases=('train',))
    cfg.update({'total_train_steps': CKPT_STEPS_PER_EPOCH * 150})
    train_cfg = dict(cfg.train)
    lr = train_cfg['optimizer']['lr']
    schedule = jax_schedulers.create_lr_schedule(train_cfg['scheduler'], lr,
                                                 CKPT_STEPS_PER_EPOCH)[0]
    assert trainer.schedule(900) == pytest.approx(float(schedule(900)), rel=1e-6)
    tx = jax_optimizers.create_optimizer(dict(train_cfg['optimizer']),
                                         lr_schedule=schedule)
    params = jax.tree_util.tree_map(jnp.asarray, flax_raw['params'])
    opt_state = serialization.from_state_dict(jax.eval_shape(tx.init, params),
                                              flax_raw['opt_state'])
    opt_state = (opt_state[0], opt_state[1]._replace(count=jnp.int32(count)))
    grads = seeded_grads(flax_raw['params'], 11)
    new_params, new_state = jax_update(tx)(params, opt_state, grads,
                                           jnp.float32(1.0))

    port_grads = from_jax_variables({'params': grads})
    for name, p in trainer.model.named_parameters():
        p.grad = port_grads[name].clone()
    apply_gradients(trainer.state, trainer.schedule)
    assert trainer.state.step == count + 1 == int(new_state[1].count)
    assert_port_matches(trainer, new_params, new_state[0].trace)
    before = from_jax_variables(flax_raw)
    moved = max((p.detach() - before[n]).abs().max().item()
                for n, p in trainer.model.named_parameters())
    assert (moved == 0.0) == (count == 1800)


def test_restored_weight_decay_chain_matches_optax(tmp_path):
    """A JAX state with the flagship's SGD chain (decay, momentum,
    MultiStepLR) and ``lr_scale`` 0.1, one step in and saved by JAX
    ``ckpt.save``; restored into the port, both take the next step."""
    opt_cfg = {'name': 'SGD', 'lr': 1e-3, 'momentum': 0.9, 'weight_decay': 5e-4}
    sched = {'name': 'MultiStepLR', 'milestones': [1, 3], 'gamma': 0.5,
             'run_each_step': True}
    trainer = Trainer.from_config(SMOKE, device='cpu', overrides={
        'train': {'optimizer': opt_cfg, 'scheduler': sched}})
    variables = to_jax_variables(trainer.model.state_dict())
    schedule = jax_schedulers.create_lr_schedule(dict(sched), 1e-3, 1)[0]
    tx = jax_optimizers.create_optimizer(dict(opt_cfg), lr_schedule=schedule)
    state = jax.jit(lambda v: create_train_state(v, tx))(variables)
    update = jax_update(tx)
    params, opt_state = update(state.params, state.opt_state,
                               seeded_grads(variables['params'], 1),
                               jnp.float32(0.1))
    state = state.replace(params=params, opt_state=opt_state, step=state.step + 1,
                          lr_scale=jnp.float32(0.1))
    path = jax_ckpt.save(str(tmp_path), state, epoch=0)
    assert set(serialization.to_state_dict(state)['opt_state']) == {'0', '1', '2'}

    _, meta = ckpt.restore(path, trainer.state)
    assert meta == {'epoch': 0, 'global_step': 1}
    assert trainer.state.step == 1 and trainer.state.lr_scale == pytest.approx(0.1)
    assert_port_matches(trainer, params, opt_state[1].trace)
    grads = seeded_grads(variables['params'], 2)
    params, opt_state = update(params, opt_state, grads, jnp.float32(0.1))
    port_grads = from_jax_variables({'params': grads})
    for name, p in trainer.model.named_parameters():
        p.grad = port_grads[name].clone()
    apply_gradients(trainer.state, trainer.schedule)
    assert_port_matches(trainer, params, opt_state[1].trace)


def test_pt_resume_takes_hyperparameters_from_the_config(tmp_path):
    """A ``.pt`` saved one step into a run with weight decay 5e-4, resumed
    by a config with 1e-3: the next step equals JAX's resume, which builds
    its optax chain from the config and restores only the chain's state
    (the trace and the count).  A config without momentum refuses the
    file's momentum buffers, as the ``.msgpack`` path does."""
    opt_cfg = {'name': 'SGD', 'lr': 1e-3, 'momentum': 0.9, 'weight_decay': 5e-4}
    sched = {'name': 'MultiStepLR', 'milestones': [1, 3], 'gamma': 0.5,
             'run_each_step': True}
    trainer = Trainer.from_config(SMOKE, device='cpu', overrides={
        'train': {'optimizer': opt_cfg, 'scheduler': sched}})
    params = to_jax_variables(trainer.model.state_dict())['params']
    grads = from_jax_variables({'params': seeded_grads(params, 1)})
    for name, p in trainer.model.named_parameters():
        p.grad = grads[name].clone()
    apply_gradients(trainer.state, trainer.schedule)
    path = ckpt.save(str(tmp_path), trainer.state, epoch=0)

    edited = {**opt_cfg, 'weight_decay': 1e-3}
    resumed = Trainer.from_config(SMOKE, device='cpu', overrides={
        'train': {'optimizer': edited, 'scheduler': sched}})
    ckpt.restore(path, resumed.state)
    assert [g['weight_decay'] for g in resumed.state.optimizer.param_groups] == [1e-3]

    schedule = jax_schedulers.create_lr_schedule(dict(sched), 1e-3, 1)[0]
    tx = jax_optimizers.create_optimizer(dict(edited), lr_schedule=schedule)
    params = to_jax_variables(resumed.model.state_dict())['params']
    opt = resumed.state.optimizer
    trace = to_jax_variables({name: opt.state[p]['momentum_buffer'] for name, p
                              in resumed.model.named_parameters()})['params']
    opt_state = tx.init(params)
    opt_state = (opt_state[0], opt_state[1]._replace(trace=trace),
                 opt_state[2]._replace(count=jnp.int32(1)))
    grads = seeded_grads(params, 2)
    new_params, new_state = jax_update(tx)(params, opt_state, grads,
                                           jnp.float32(1.0))
    port_grads = from_jax_variables({'params': grads})
    for name, p in resumed.model.named_parameters():
        p.grad = port_grads[name].clone()
    apply_gradients(resumed.state, resumed.schedule)
    assert_port_matches(resumed, new_params, new_state[1].trace)

    no_momentum = Trainer.from_config(SMOKE, device='cpu', overrides={
        'train': {'optimizer': {**opt_cfg, 'momentum': 0.0}, 'scheduler': sched}})
    with pytest.raises(ValueError, match='momentum'):
        ckpt.restore(path, no_momentum.state)


def test_pt_round_trip_is_exact(tmp_path):
    """``save`` then ``restore`` into a fresh trainer: every tensor and
    momentum buffer equal, step, ``lr_scale`` and the sidecar as saved; the
    file loads with ``weights_only=True``."""
    trainer = Trainer.from_config(SMOKE, device='cpu', steps_per_epoch=4)
    for p in trainer.model.parameters():
        p.grad = torch.randn_like(p)
    apply_gradients(trainer.state, trainer.schedule)
    trainer.state.lr_scale = 0.25
    path = ckpt.save(str(tmp_path), trainer.state, epoch=3)
    assert os.path.basename(path) == 'ckpt-1.pt'
    with open(path + '.meta.json') as f:
        assert json.load(f) == {'epoch': 3, 'global_step': 1}
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {'step', 'model', 'optimizer', 'lr_scale'}

    fresh = Trainer.from_config(SMOKE, device='cpu', seed=5, steps_per_epoch=4)
    _, meta = ckpt.restore(path, fresh.state)
    assert meta == {'epoch': 3, 'global_step': 1}
    assert fresh.state.step == 1 and fresh.state.lr_scale == 0.25
    want = trainer.model.state_dict()
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for p, q in zip(fresh.model.parameters(), trainer.model.parameters()):
        assert torch.equal(fresh.state.optimizer.state[p]['momentum_buffer'],
                           trainer.state.optimizer.state[q]['momentum_buffer'])
    assert not list(tmp_path.glob('*.tmp'))

    weights_only = Trainer.from_config(SMOKE, device='cpu', seed=5)
    ckpt.restore_weights_only(path, weights_only.state)
    assert weights_only.state.step == 0 and not weights_only.state.optimizer.state
    assert torch.equal(weights_only.model.state_dict()['score_head0.weight'],
                       want['score_head0.weight'])


def test_migrate_state_dict_renames_and_refuses_collisions(tmp_path):
    template = {'features.base.x': 1, 'head.w': 2}
    rules = [(r'^features\.base_v1\.', 'features.base.')]
    assert ckpt.migrate_state_dict({'features.base_v1.x': 3, 'head.w': 4},
                                   template, rules) == {'features.base.x': 3,
                                                        'head.w': 4}
    assert ckpt.MIGRATION_RULES == []
    with pytest.raises(ValueError, match='collision'):
        ckpt.migrate_state_dict({'features.base_v1.x': 3, 'features.base.x': 4},
                                template, rules)
    trainer = Trainer.from_config(SMOKE, device='cpu')
    path = ckpt.save(str(tmp_path), trainer.state, epoch=0)
    payload = torch.load(path, weights_only=True)
    payload['model'] = {k.replace('score_head0', 'class_head0'): v
                        for k, v in payload['model'].items()}
    torch.save(payload, path)
    fresh = Trainer.from_config(SMOKE, device='cpu', seed=9)
    with pytest.raises(RuntimeError, match='class_head0'):
        ckpt.restore(path, fresh.state)
    ckpt.restore(path, fresh.state, rules=[(r'^class_head', 'score_head')])
    assert torch.equal(fresh.model.score_head0.weight, trainer.model.score_head0.weight)


# ------------------------------------------------------------- schedules

SCHEDULES = {
    'MultiStepLR': {'milestones': [30, 100, 250], 'gamma': 0.5},
    'StepLR': {'step_size': 40, 'gamma': 0.7},
    # 63/64, exact in float32: the JAX schedule raises float32(0.99) to the
    # 300th power, 3e-6 off 0.99 ** 300 from the constant's rounding alone
    'ExponentialLR': {'gamma': 0.984375},
    'CosineAnnealingLR': {'T_max': 200, 'eta_min': 1e-5},
    'LinearGrowthLR': {'cold_lr': 1e-5, 'steps': 50},
    'ConcatScheduler': {'schedulers': [
        (0, 'LinearGrowthLR', {'cold_lr': 1e-4, 'steps': 20}),
        (20, 'MultiStepLR', {'milestones': [50], 'gamma': 0.3}),
        (100, 'CosineAnnealingLR', {'T_max': 150, 'eta_min': 1e-6})]},
    'CosineAnnealingWithWarmupLR': {'T_max': 280, 'warmup_steps': 10,
                                    'warmup_lr': 1e-5},
}


@pytest.mark.parametrize('run_each_step', [True, False])
@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedules_match_jax(name, run_each_step):
    """Ticks 0-300 (steps 0-300 per step, or 0-902 in epochs of 3)."""
    cfg = {'name': name, 'run_each_step': run_each_step, **SCHEDULES[name]}
    base_lr, steps_per_epoch = 0.1, 3
    got_fn, plateau, metric = schedulers.create_lr_schedule(dict(cfg), base_lr,
                                                            steps_per_epoch)
    want_fn, _, want_metric = jax_schedulers.create_lr_schedule(
        dict(cfg), base_lr, steps_per_epoch)
    assert plateau is None and metric == want_metric == 'eval_loss'
    steps = np.arange(301) * (1 if run_each_step else steps_per_epoch)
    steps = np.unique(np.concatenate([steps, steps + steps_per_epoch - 1]))
    want = np.asarray(jax.jit(jax.vmap(want_fn))(jnp.asarray(steps)))
    got = np.array([got_fn(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * base_lr)
    assert np.ptp(got) > 0.0


def test_no_scheduler_and_plateau_match_jax():
    fn, plateau, metric = schedulers.create_lr_schedule(None, 0.02, 5)
    assert (fn(0), fn(1000), plateau, metric) == (0.02, 0.02, None, None)
    metrics = [5.0, 4.0, 4.0, 3.9999, 4.1, 4.2, 3.0, 3.5, 3.5, 3.5, 3.5, 3.5,
               3.5, 2.0, 2.5, 2.5, 2.5, 2.5]
    for cfg in ({'name': 'ReduceLROnPlateau', 'patience': 2, 'factor': 0.5,
                 'min_lr': 1e-3, 'scheduler_metric': 'eval_mAP'},
                {'name': 'ReduceLROnPlateau', 'mode': 'max', 'patience': 1,
                 'factor': 0.3, 'threshold': 0.01}):
        got_fn, got, got_metric = schedulers.create_lr_schedule(dict(cfg), 0.01, 4)
        want_fn, want, want_metric = jax_schedulers.create_lr_schedule(
            dict(cfg), 0.01, 4)
        assert got_metric == want_metric == cfg.get('scheduler_metric', 'eval_loss')
        assert got_fn(77) == float(want_fn(77)) == 0.01
        scales = [(got.update(m), want.update(m)) for m in metrics]
        assert [g for g, _ in scales] == [w for _, w in scales]
        assert min(g for g, _ in scales) < 1.0


# ------------------------------------------------- checkpoint directories

def test_find_latest_matches_jax(tmp_path):
    """The highest step among ``.pt`` and ``.msgpack`` files, ``.pt`` on a
    tie; temporary and other names never; the JAX module agrees wherever
    only ``.msgpack`` files are present."""
    names = ['ckpt-5.pt', 'ckpt-12.msgpack', 'ckpt-3.msgpack', 'ckpt-40.pt.tmp',
             'ckpt-99.msgpack.tmp', 'ckpt-7.pt.meta.json', 'log.csv', 'ckpt-x.pt']
    for name in names:
        (tmp_path / name).write_bytes(b'')
    assert ckpt.find_latest(str(tmp_path)) == str(tmp_path / 'ckpt-12.msgpack')
    assert jax_ckpt.find_latest(str(tmp_path)) == str(tmp_path / 'ckpt-12.msgpack')
    (tmp_path / 'ckpt-12.pt').write_bytes(b'')
    assert ckpt.find_latest(str(tmp_path)) == str(tmp_path / 'ckpt-12.pt')
    (tmp_path / 'ckpt-13.msgpack').write_bytes(b'')
    assert ckpt.find_latest(str(tmp_path)) == str(tmp_path / 'ckpt-13.msgpack')
    for path in (str(tmp_path / 'ckpt-5.pt'), str(tmp_path / 'missing'),
                 str(tmp_path / 'ckpt-3.msgpack')):
        assert ckpt.find_latest(path) == jax_ckpt.find_latest(path)
    empty = tmp_path / 'empty'
    empty.mkdir()
    assert ckpt.find_latest(str(empty)) is None is jax_ckpt.find_latest(str(empty))
    assert ckpt.find_latest(CKPT_DIR) == jax_ckpt.find_latest(CKPT_DIR) == CKPT


@pytest.mark.parametrize('case', ['train', 'resume', 'new_checkpoint', 'debug',
                                  'eval_only'])
def test_prepare_checkpoint_dir_matches_jax(tmp_path, case):
    """The same directory chosen and the same files written as the JAX
    module, in two copies of one layout."""
    outcomes = []
    for side, module in (('port', ckpt), ('jax', jax_ckpt)):
        root = tmp_path / side
        existing = root / 'old'
        existing.mkdir(parents=True)
        config = root / 'cfg.py'
        config.write_text('seed = 1\n')
        checkpoint = str(existing) if case in ('resume', 'new_checkpoint') else None
        out = module.prepare_checkpoint_dir(
            str(root / 'save'), checkpoint, str(config), debug=case == 'debug',
            train=case != 'eval_only', new_checkpoint=case == 'new_checkpoint')
        rel = os.path.relpath(out, root)
        files = sorted(os.path.relpath(os.path.join(d, f), root)
                       for d, _, fs in os.walk(root) for f in fs)
        outcomes.append((rel.split(os.sep)[0], len(rel.split(os.sep)),
                         [f.split(os.sep)[0] + '/' + f.split(os.sep)[-1]
                          for f in files]))
    assert outcomes[0] == outcomes[1]
    wrote = any(f.endswith('/config.py') for f in outcomes[0][2])
    assert wrote == (case in ('train', 'resume', 'new_checkpoint'))


# ------------------------------------------------------ resume, interrupts

TWO_EPOCHS = {'train': {'epochs': 2, 'eval_every': 1}}


def smoke_experiment(directory, resume=None):
    return Experiment(SMOKE, device='cpu', overrides=TWO_EPOCHS,
                      checkpoint_dir=str(directory), resume_from=resume)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """SMOKE with its own cosine schedule, two epochs with an evaluation
    and a checkpoint after each: straight, against one epoch and then a
    resume from its directory.  Parameters, BN statistics, momentum
    buffers, step, the last checkpoint and ``log.csv`` equal bit for bit."""
    straight = smoke_experiment(tmp_path / 'a')
    rows = straight.train()
    assert [r['epoch'] for r in rows] == [0, 1] and 'eval_mAP' in rows[0]

    first = smoke_experiment(tmp_path / 'b')
    first.epochs = 1  # the same schedule, stopped after epoch 0
    first.train()
    assert sorted(os.listdir(tmp_path / 'b')) == [
        'ckpt-4.pt', 'ckpt-4.pt.meta.json', 'log.csv']
    resumed = smoke_experiment(tmp_path / 'b', resume=str(tmp_path / 'b'))
    assert resumed.start_epoch == 1 and resumed.trainer.state.step == 4
    assert [r['epoch'] for r in resumed.train()] == [1]

    assert resumed.trainer.state.step == straight.trainer.state.step == 8
    want = straight.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    opt_a, opt_b = straight.trainer.state.optimizer, resumed.trainer.state.optimizer
    for p, q in zip(straight.model.parameters(), resumed.model.parameters()):
        assert torch.equal(opt_a.state[p]['momentum_buffer'],
                           opt_b.state[q]['momentum_buffer'])
    assert ((tmp_path / 'a' / 'log.csv').read_text()
            == (tmp_path / 'b' / 'log.csv').read_text())
    a = torch.load(tmp_path / 'a' / 'ckpt-8.pt', weights_only=True)
    b = torch.load(tmp_path / 'b' / 'ckpt-8.pt', weights_only=True)
    for k in a['model']:
        assert torch.equal(a['model'][k], b['model'][k]), k
    assert a['optimizer']['param_groups'] == b['optimizer']['param_groups']


# ------------------------------------------------------------ base.weight

def test_base_weight_import_matches_jax(tmp_path, caplog):
    """A seeded torchvision-layout MobileNetV2 ``state_dict`` (names and
    shapes from the JAX mapping) imported into the port's backbone equals
    JAX ``import_backbone`` then ``from_jax_variables``; an ``Experiment``
    with ``model.base.weight`` starts from it."""
    trainer = Trainer.from_config(SMOKE, device='cpu')
    model_state = trainer.model.state_dict()
    variables = to_jax_variables(model_state)
    mapping = jax_torch_import.mobilenet_v2_mapping()
    assert torch_import.mobilenet_v2_mapping() == mapping
    sd = fill_synthetic_state_dict(variables['params']['features']['base'],
                                   mapping, np.random.RandomState(3))
    sd['features.0.1.num_batches_tracked'] = torch.tensor(7)
    want = from_jax_variables(jax_torch_import.import_backbone(
        sd, variables, 'mobilenet_v2'))
    got = torch_import.import_backbone(sd, model_state, 'mobilenet_v2')
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    changed = [k for k in got if not torch.equal(got[k], model_state[k])]
    assert len(changed) == 52 + 52 * 4 and all(  # 52 convs, 52 BNs
        k.startswith('features.base.') for k in changed)

    path = tmp_path / 'mobilenet_v2.pth'
    torch.save({'state_dict': sd}, path)
    base = {'name': 'mobilenet_v2', 'depth_multiplier': 0.35, 'weight': str(path)}
    exp = Experiment(SMOKE, phases=('eval',), device='cpu',
                     overrides={'model': {'base': base}})
    for k in changed:
        assert torch.equal(exp.model.state_dict()[k], want[k]), k
    with caplog.at_level(logging.WARNING):
        Experiment(SMOKE, phases=('eval',), device='cpu', overrides={
            'model': {'base': {**base, 'weight': None, 'pretrained': True}}})
    assert 'training from scratch' in caplog.text


def test_weight_files_not_ported_raise():
    """Every registry backbone has its mapping now; a name outside the
    registry has none, as in the JAX package.  torch-hub backbones, keras
    ``.h5`` files and the reference's whole-detector checkpoints are
    ported (``test_torch_port_interop*.py``); what JAX refuses there the
    port refuses too: a torch-hub model outside the registry, keras
    weights for a backbone keras has none for."""
    with pytest.raises(KeyError, match='No torch mapping'):
        torch_import.resolve_mapping('torchvision_mobilenet_v3_large')
    with pytest.raises(ValueError, match='torch-hub'):
        Experiment(SMOKE, phases=('eval',), device='cpu', overrides={
            'model': {'base': {'name': 'torchhub://some/repo:not_a_backbone'}}})
    with pytest.raises(KeyError, match='keras'):
        keras_import.keras_backbone_mapping('torchvision_vgg16_bn')
