"""Port parity for the optimizers (``train/optimizers.py``) against the JAX
package's ``create_optimizer`` (optax), on a small parameter tree without
a model: the ten rules with weight decay (and momentum and Nesterov where
they exist) under a warmup schedule and ``lr_scale`` 0.5, ``lr_groups``,
clipping above and below its limit, accumulation at k = 2 and 3, all
three combined, and a JAX state restored mid-run through
``from_jax_state``.  Six points where optax is not ``torch.optim`` each
have a case that ``torch.optim``'s rule fails.

The JAX updates run eagerly (no compiled step).  Tolerance: each
parameter rtol 1e-6, atol 1e-7 after every update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from torch import nn

from single_shot_detection_tpu.train import checkpoint as jax_ckpt
from single_shot_detection_tpu.train import optimizers as jax_optimizers
from single_shot_detection_tpu.train import schedulers as jax_schedulers
from single_shot_detection_tpu.train.state import create_train_state
from single_shot_detection_tpu_torch.train import checkpoint as pt_ckpt
from single_shot_detection_tpu_torch.train import optimizers as pt_optimizers
from single_shot_detection_tpu_torch.train import schedulers as pt_schedulers
from single_shot_detection_tpu_torch.train.state import TrainState
from single_shot_detection_tpu_torch.train.step import apply_gradients
from single_shot_detection_tpu_torch.utils.weights import (from_jax_variables,
                                                           parse_opt_state)
from _torch_port_fixtures import one_torch_thread  # noqa: F401

# lr(0) = 0.02, lr(1) = 0.04, ...: the step each rule reads shows
WARMUP = {'name': 'LinearGrowthLR', 'cold_lr': 0.02, 'steps': 6,
          'run_each_step': True}
BASE_LR = 0.1
LR_SCALE = 0.5
RTOL, ATOL = 1e-6, 1e-7


def make_tree(seed=0):
    """A JAX params tree: a conv kernel and bias, a BN scale, a second conv
    (``headless`` shares the prefix ``head`` as a string)."""
    rs = np.random.RandomState(seed)
    return {'head': {'kernel': rs.randn(3, 3, 2, 4).astype(np.float32),
                     'bias': rs.randn(4).astype(np.float32)},
            'bn': {'scale': (1 + 0.1 * rs.randn(4)).astype(np.float32)},
            'headless': {'kernel': rs.randn(1, 1, 4, 4).astype(np.float32)}}


def grads_like(tree, seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (scale * rs.randn(*p.shape)).astype(np.float32), tree)


class TreeModule(nn.Module):
    """Parameters under the port's names of a JAX tree."""

    def __init__(self, tree):
        super().__init__()
        for name, value in from_jax_variables({'params': tree}).items():
            *path, leaf = name.split('.')
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, nn.Parameter(value))


def schedules(sched=WARMUP, lr=BASE_LR):
    if sched is None:
        # JAX's factories take the constant ``lr``; the port's trainer
        # passes the schedule of no scheduler config, the same constant
        return None, pt_schedulers.create_lr_schedule(None, lr, 1)[0]
    return (jax_schedulers.create_lr_schedule(dict(sched), lr, 1)[0],
            pt_schedulers.create_lr_schedule(dict(sched), lr, 1)[0])


def jax_update(tx, params, opt_state, grads, lr_scale):
    """The JAX train step's optimizer part (``train/step.py``), eager."""
    updates, opt_state = tx.update(grads, opt_state, params)
    updates = jax.tree_util.tree_map(lambda u: u * lr_scale, updates)
    return optax.apply_updates(params, updates), opt_state


class Pair:
    """The same optimizer config on both sides over one tree."""

    def __init__(self, opt_cfg, sched=WARMUP, accumulation=1, clip=None,
                 tree=None):
        tree = make_tree() if tree is None else tree
        sched_j, self.sched_p = schedules(sched, opt_cfg.get('lr', BASE_LR))
        self.tx = jax_optimizers.create_optimizer(
            dict(opt_cfg), lr_schedule=sched_j, accumulation_steps=accumulation,
            clip_grad_norm=clip)
        self.params = jax.tree_util.tree_map(jnp.asarray, tree)
        self.opt_state = self.tx.init(self.params)
        self.model = TreeModule(tree)
        self.state = TrainState(self.model, pt_optimizers.create_optimizer(
            dict(opt_cfg), self.model.named_parameters(),
            accumulation_steps=accumulation, clip_grad_norm=clip))

    def step(self, grads, lr_scale=LR_SCALE):
        self.params, self.opt_state = jax_update(
            self.tx, self.params, self.opt_state, grads, jnp.float32(lr_scale))
        self.state.lr_scale = lr_scale
        port_grads = from_jax_variables({'params': grads})
        for name, p in self.model.named_parameters():
            p.grad = port_grads[name].clone()
        return apply_gradients(self.state, self.sched_p)

    def assert_close(self, what=''):
        want = from_jax_variables({'params': self.params})
        for name, p in self.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f'{what} {name}')


CASES = {
    'SGD': {'momentum': 0.9, 'weight_decay': 1e-2},
    'SGD-nesterov': {'momentum': 0.9, 'nesterov': True, 'weight_decay': 1e-2},
    'SGDW': {'momentum': 0.9, 'weight_decay': 1e-2},
    'SGDW-nesterov': {'momentum': 0.9, 'nesterov': True, 'weight_decay': 1e-2},
    'Adam': {'betas': (0.8, 0.95), 'weight_decay': 1e-2},
    'AdamW': {'betas': (0.8, 0.95), 'weight_decay': 1e-1},
    'RMSprop': {'alpha': 0.9, 'eps': 1e-2, 'weight_decay': 1e-2},
    'RMSprop-momentum': {'alpha': 0.9, 'eps': 1e-2, 'momentum': 0.9,
                         'weight_decay': 1e-2},
    'Adagrad': {'lr_decay': 0.1, 'initial_accumulator_value': 0.1,
                'weight_decay': 1e-2},
    'Adadelta': {'rho': 0.8, 'weight_decay': 1e-2},
    'Adamax': {'betas': (0.8, 0.95), 'weight_decay': 1e-2},
    'NAdam': {'betas': (0.8, 0.95), 'momentum_decay': 0.05,
              'weight_decay': 1e-2},
    # b2 0.8: the rectification starts at update 8
    'RAdam': {'betas': (0.8, 0.8), 'eps': 1e-2, 'weight_decay': 1e-2},
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_optimizer_matches_optax(case):
    """Five updates (RAdam ten, through its rectification) at lr_scale 0.5
    under the warmup schedule, small gradients (the eps terms matter)."""
    name = case.split('-')[0]
    pair = Pair({'name': name, 'lr': BASE_LR, **CASES[case]})
    for i in range(10 if name == 'RAdam' else 5):
        assert pair.step(grads_like(make_tree(), 10 + i, scale=0.05))
        pair.assert_close(f'update {i}')
    assert pair.state.step == (10 if name == 'RAdam' else 5)


def test_buffers_and_counts_match_optax():
    """The port's buffers are optax's state leaves: NAdam's after three
    updates with ``lr_groups`` (its ``m``, ``v`` and ``mu_product`` per
    group)."""
    cfg = {'name': 'NAdam', 'lr': BASE_LR, 'lr_groups': {'bn': 0.05}}
    pair = Pair(cfg)
    for i in range(3):
        pair.step(grads_like(make_tree(), i))
    parsed = parse_opt_state(jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(pair.opt_state)))
    opt = pair.state.optimizer
    names = {p: n for n, p in pair.model.named_parameters()}
    assert {g['label'] for g in opt.param_groups} == set(parsed['groups'])
    for group in opt.param_groups:
        stored = parsed['groups'][group['label']]
        assert stored['counts'] == [3]
        assert group['mu_product'] == pytest.approx(stored['mu_product'],
                                                    rel=1e-6)
        for key in ('m', 'v'):
            for p in group['params']:
                np.testing.assert_allclose(
                    opt.state[p][key].numpy(),
                    stored['buffers'][key][names[p]].numpy(),
                    rtol=RTOL, atol=ATOL, err_msg=f'{key} {names[p]}')


COMBOS = {
    'groups': dict(opt={'name': 'SGD', 'momentum': 0.9,
                        'lr_groups': {'head': 0.05, 'bn': 0.3}}),
    'clip-above': dict(opt={'name': 'Adam'}, clip=0.01),
    'clip-below': dict(opt={'name': 'Adam'}, clip=100.0),
    'accumulate-2': dict(opt={'name': 'SGD', 'momentum': 0.9}, accumulation=2),
    'accumulate-3': dict(opt={'name': 'AdamW', 'weight_decay': 0.1},
                         accumulation=3),
    'combined': dict(opt={'name': 'AdamW', 'weight_decay': 0.1,
                          'lr_groups': {'head': 0.05}},
                     accumulation=2, clip=0.05),
}


@pytest.mark.parametrize('combo', sorted(COMBOS))
def test_groups_clipping_and_accumulation_match_optax(combo):
    """Six micro-steps: ``lr_groups`` (``head`` matches ``headless`` too,
    as a string prefix of the JAX path), the global-norm clip (norm about
    0.3: clipped at 0.01 and 0.05, not at 100), accumulation (the
    parameters move on every k-th micro-step only) and lr_scale changing
    mid-window."""
    spec = COMBOS[combo]
    pair = Pair({'lr': BASE_LR, **spec['opt']},
                accumulation=spec.get('accumulation', 1), clip=spec.get('clip'))
    k = spec.get('accumulation', 1)
    labels = {g['label']: len(g['params'])
              for g in pair.state.optimizer.param_groups}
    assert labels == {'groups': {'head': 3, 'bn': 1},
                      'combined': {'__default__': 1, 'head': 3}}.get(
                          combo, {'__default__': 4})
    for i in range(6):
        before = [p.detach().clone() for p in pair.model.parameters()]
        moved = pair.step(grads_like(make_tree(), 20 + i, scale=0.1),
                          lr_scale=0.5 if i < 3 else 0.25)
        assert moved == ((i + 1) % k == 0)
        assert moved == any(not torch.equal(b, p.detach())
                            for b, p in zip(before, pair.model.parameters()))
        pair.assert_close(f'micro-step {i}')


@pytest.mark.parametrize('cfg,k,split', [
    ({'name': 'Adam', 'weight_decay': 1e-2}, 1, 3),
    ({'name': 'NAdam', 'lr_groups': {'head': 0.05}}, 2, 3),
    ({'name': 'SGD', 'momentum': 0.9, 'weight_decay': 1e-2}, 3, 4),
    ({'name': 'SGDW', 'momentum': 0.9, 'weight_decay': 1e-2}, 1, 2),
    ({'name': 'AdamW', 'weight_decay': 1e-1}, 1, 2),
    ({'name': 'RMSprop', 'momentum': 0.9, 'eps': 1e-2}, 1, 2),
    ({'name': 'Adagrad', 'initial_accumulator_value': 0.1}, 1, 2),
    ({'name': 'Adadelta'}, 1, 2),
    ({'name': 'Adamax'}, 1, 2),
    ({'name': 'RAdam', 'betas': (0.8, 0.8)}, 1, 8),
], ids=['Adam', 'NAdam-groups-k2', 'SGD-k3', 'SGDW', 'AdamW', 'RMSprop',
        'Adagrad', 'Adadelta', 'Adamax', 'RAdam'])
def test_restore_jax_state_mid_run(cfg, k, split, tmp_path):
    """Each optimizer's optax state: ``split`` micro-steps on both sides,
    the JAX state saved by the JAX package's ``ckpt.save`` (the
    ``MultiSteps`` state mid-window for NAdam and SGD) and restored into a
    fresh port state, then three more micro-steps each side."""
    cfg = {'lr': BASE_LR, **cfg}
    pair = Pair(cfg, accumulation=k, clip=1.0)
    for i in range(split):
        pair.step(grads_like(make_tree(), 30 + i, scale=0.1))
    state = create_train_state({'params': pair.params, 'batch_stats': {}},
                               pair.tx).replace(
        step=jnp.int32(split), opt_state=pair.opt_state,
        lr_scale=jnp.float32(LR_SCALE))
    path = jax_ckpt.save(str(tmp_path), state, epoch=0)
    fresh = Pair(cfg, accumulation=k, clip=1.0)
    pt_ckpt.restore(path, fresh.state)
    assert fresh.state.step == split
    fresh.params, fresh.opt_state = pair.params, pair.opt_state
    fresh.assert_close('restored')
    for i in range(3):
        fresh.step(grads_like(make_tree(), 40 + i, scale=0.1))
        fresh.assert_close(f'after restore {i}')


def test_pt_round_trip_of_adam_and_accumulation(tmp_path):
    """A ``.pt`` mid-window restores into a fresh state bit for bit, and
    the two go on equal."""
    cfg = {'name': 'Adam', 'lr': BASE_LR, 'lr_groups': {'bn': 0.3}}
    a = Pair(cfg, accumulation=2)
    for i in range(3):
        a.step(grads_like(make_tree(), 50 + i))
    path = pt_ckpt.save(str(tmp_path), a.state, epoch=0)
    b = Pair(cfg, accumulation=2, tree=make_tree(seed=9))
    pt_ckpt.restore(path, b.state)
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
        for key, buf in a.state.optimizer.state[p].items():
            assert torch.equal(buf, b.state.optimizer.state[q][key]), (n, key)
    g = grads_like(make_tree(), 60)
    a.step(g)
    b.step(g)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


# --------------------------------- where optax is not torch.optim

def torch_optim_run(ctor, kwargs, tree, grads, lrs, clip=None):
    """``torch.optim``'s rule on the same tree: each step at ``lrs[i]``."""
    model = TreeModule(tree)
    opt = ctor(model.parameters(), lr=lrs[0], **kwargs)
    for g, lr in zip(grads, lrs):
        for group in opt.param_groups:
            group['lr'] = lr
        port = from_jax_variables({'params': g})
        for name, p in model.named_parameters():
            p.grad = port[name].clone()
        if clip is not None:
            torch.nn.utils.clip_grad_norm_(model.parameters(), clip)
        opt.step()
    return {n: p.detach() for n, p in model.named_parameters()}


SEMANTICS = {
    # SGDW/AdamW: p -= wd * p after the step, not lr * wd * p before it
    'decoupled-decay': (dict(opt={'name': 'AdamW', 'weight_decay': 0.1}),
                        torch.optim.AdamW, {'weight_decay': 0.1}),
    # RMSprop: g / sqrt(nu + eps), not g / (sqrt(nu) + eps)
    'rmsprop-eps': (dict(opt={'name': 'RMSprop', 'eps': 1e-2}),
                    torch.optim.RMSprop, {'eps': 1e-2}),
    # RAdam: m / (sqrt(v / bc2) + eps), not sqrt(v) / sqrt(bc2) + eps
    'radam-eps': (dict(opt={'name': 'RAdam', 'betas': (0.8, 0.8), 'eps': 1e-2},
                       steps=10),
                  torch.optim.RAdam, {'betas': (0.8, 0.8), 'eps': 1e-2}),
    # Adagrad reads lr(count + 1): the first update takes lr(1)
    'schedule-index': (dict(opt={'name': 'Adagrad'}, sched=WARMUP),
                       torch.optim.Adagrad, {}),
    # an lr_groups group's rate is a constant the schedule does not move
    'constant-group-lr': (dict(opt={'name': 'SGD', 'lr_groups': {'': 0.1}},
                               sched=WARMUP),
                          torch.optim.SGD, {}),
    # clipping scales by max / norm, not max / (norm + 1e-6): a global
    # norm of about 1e-5, clipped to 5e-6, at lr 100
    'clip-no-eps': (dict(opt={'name': 'SGD', 'lr': 100.0}, clip=5e-6,
                         sched=None, scale=1e-6),
                    torch.optim.SGD, {}),
}


@pytest.mark.parametrize('point', sorted(SEMANTICS))
def test_semantics_differ_from_torch_optim(point):
    """The port equals optax where ``torch.optim`` (with the schedule read
    at the torch index, the group rate scheduled and
    ``clip_grad_norm_``'s ``+1e-6``) is off by far more than the
    tolerance."""
    spec, ctor, kwargs = SEMANTICS[point]
    steps = spec.get('steps', 5)
    sched = spec.get('sched', WARMUP)
    opt = {'lr': BASE_LR, **spec['opt']}
    pair = Pair(opt, sched=sched, clip=spec.get('clip'))
    grads = [grads_like(make_tree(), 70 + i, scale=spec.get('scale', 0.05))
             for i in range(steps)]
    for g in grads:
        pair.step(g, lr_scale=1.0)
    pair.assert_close(point)
    want = {n: p.detach().numpy() for n, p in pair.model.named_parameters()}
    _, sched_p = schedules(sched)
    lrs = [sched_p(i) if sched_p else opt['lr'] for i in range(steps)]
    got = torch_optim_run(ctor, kwargs, make_tree(), grads, lrs,
                          clip=spec.get('clip'))
    assert not all(np.allclose(got[n].numpy(), want[n], rtol=RTOL, atol=ATOL)
                   for n in want), point
