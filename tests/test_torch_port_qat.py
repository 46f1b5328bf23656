"""Port parity for quantization-aware training (``train.qat``;
``export/quantize.py``'s QAT section): the straight-through estimator, the
``act_amax`` buffers and their EMA, the fake-quantized forward, one QAT
train step, the checkpoints' ``act_amax`` in both directions, and the
engine's QAT run handing its scales to int8 evaluation, against the JAX
package.

Tolerances:
- the STE's gradient is exactly 1, its forward equal to JAX's;
- the ``act_amax`` keys equal JAX ``qat_init``'s; a conv's EMA update
  within 1e-6 relative of JAX's on the same input (1e-5 inside a detector,
  whose float forwards differ in rounding);
- a QAT step on a small model as ``test_torch_port_train.py`` holds the
  float step: loss rtol 1e-4, each parameter's update within 1e-3 of its
  own largest update or 1 % of the step's, running statistics rtol 1e-6
  atol 1e-5, and ``act_amax`` within 1e-6 relative.

QAT's forward is chaotic in f32 on a real detector: once two rounding
orders put one activation on either side of a quantization boundary, that
flip moves the next conv's inputs by whole quantization steps, and the
flips cascade through the train-mode BNs.  The port's own f32 forward of
the trained smoke detector lies as far from its float64 forward (0.61 and
0.42 of the largest score and loc in train mode, 1.4-2.1 % of the QAT-to-
float distance in eval mode) as from JAX's (0.65 and 0.36; 1.1-1.5 %).  So
the detector is held where a flip cannot reach (the stem's ``act_amax``,
the keys) exactly, and elsewhere at the chaos's scale: ``act_amax`` within
``CHAOS_REL``, the eval forward within 5 % of JAX's QAT-to-float distance;
the step's updates are held on the small model, where no flip occurs.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import serialization
from optax import apply_updates as optax_apply

from _torch_zoo_slice import JaxSide, port_overrides
from single_shot_detection_tpu.export import quantize as jq
from single_shot_detection_tpu.train import checkpoint as jax_ckpt
from single_shot_detection_tpu.train.state import create_train_state
from single_shot_detection_tpu.train import optimizers as jax_optimizers
from single_shot_detection_tpu_torch.export import quantize as pq
from single_shot_detection_tpu_torch.models.layers import batch_norm, conv2d
from single_shot_detection_tpu_torch.train import optimizers as pt_optimizers
from single_shot_detection_tpu_torch.train.state import TrainState
from single_shot_detection_tpu_torch.train.step import apply_gradients
from single_shot_detection_tpu_torch.train import checkpoint as pt_ckpt
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.weights import (from_jax_variables,
                                                           to_jax_variables)
from _torch_port_fixtures import jax_train_state
from _torch_port_fixtures import one_torch_thread  # noqa: F401

SMOKE = 'samples/synthetic_smoke.py'
CKPT_DIR = 'experiments/2026-08-16-225820'   # SMOKE's model, trained
SIZE = 128
OPTIMIZER = {'name': 'SGD', 'lr': 0.1, 'momentum': 0.9, 'weight_decay': 1e-4}
# QAT's forward is chaotic in f32 (module docstring): measured up to 6.2 %
# on the trained detector's act_amax after one train-mode forward
CHAOS_REL = 0.1


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def act_amax_paths(tree, path=()):
    """The conv paths of the ``act_amax`` leaves of a ``batch_stats``
    tree."""
    out = set()
    for key, value in tree.items():
        if key == 'act_amax':
            out.add('/'.join(path))
        elif isinstance(value, dict):
            out |= act_amax_paths(value, path + (key,))
    return out


# ------------------------------------------------------ the estimator, EMA

def test_ste_gradient_is_identity():
    x = torch.linspace(-1.0, 1.0, 11, requires_grad=True)
    y = pq._fake_quant(x, torch.tensor(0.1))
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(11))
    np.testing.assert_array_equal(
        y.detach().numpy(),
        np.asarray(jq._fake_quant(jnp.linspace(-1.0, 1.0, 11), 0.1)))


class Twice(nn.Module):
    """One conv applied twice (as RetinaNet's shared towers are, once per
    level), then a strided one."""

    @nn.compact
    def __call__(self, x, train=False):
        shared = nn.Conv(8, (3, 3), padding=((1, 1), (1, 1)), use_bias=True,
                         name='shared')
        x = shared(nn.relu(shared(x)))
        return nn.Conv(4, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)),
                       use_bias=False, name='down')(x)


class PortTwice(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.shared = conv2d(8, 8, 3, padding=1, bias=True)
        self.down = conv2d(8, 4, 3, stride=2, padding=1)

    def forward(self, x):
        return self.down(self.shared(torch.relu(self.shared(x))))


@pytest.fixture(scope='module')
def twice():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 12, 12, 8).astype(np.float32)
    module = Twice()
    variables = jq.qat_init(module, module.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    port = PortTwice()
    assert pq.qat_init(port) == 2
    port.load_state_dict(from_jax_variables(variables))
    return module, variables, port, x


def test_train_mode_update_matches_jax_with_a_shared_conv(twice):
    """Seeded by the first batch's max, then an EMA, once per application
    of the shared conv, in order; the outputs follow."""
    module, variables, port, x = twice
    apply = jq.qat_apply(module, decay=0.9)
    pq.qat_init(port, decay=0.9)
    port.train()
    stats = variables['batch_stats']
    for i, batch in enumerate((x, 3 * x, 0.5 * x)):
        out, mutated = apply({'params': variables['params'], 'batch_stats': stats},
                             jnp.asarray(batch), train=True,
                             mutable=['batch_stats'])
        stats = mutated['batch_stats']
        with torch.no_grad():
            got = port(nchw(batch))
        for name in ('shared', 'down'):
            assert float(getattr(port, name).act_amax) == pytest.approx(
                float(stats[name]['act_amax']), rel=1e-6), (i, name)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(out), rtol=1e-5, atol=1e-5)
    # the shared conv saw two applications per batch: not a single EMA step
    first = float(np.abs(x).max())
    assert float(port.shared.act_amax) != pytest.approx(first)
    port.eval()  # eval reads the scales only
    before = port.shared.act_amax.clone()
    with torch.no_grad():
        port(nchw(10 * x))
    assert torch.equal(port.shared.act_amax, before)


def test_input_not_quantized_before_calibration(twice):
    """``act_amax`` 0: the weights are fake-quantized, the input is not."""
    module, variables, port, x = twice
    pq.qat_init(port)
    with torch.no_grad():
        port.shared.act_amax.zero_()
        xt = nchw(x)
        got = port.shared(xt)
        w = port.shared.weight
        w_scale = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12) / pq.QMAX
        w_fq = pq._fake_quant(w, w_scale[:, None, None, None])
        want = (port.shared.conv_with(xt, w_fq, None)
                + port.shared.bias[:, None, None])
        assert torch.equal(got, want)
    fresh = jax.tree_util.tree_map(jnp.zeros_like, variables['batch_stats'])
    out = jq.qat_apply(module)({'params': variables['params'],
                                'batch_stats': fresh}, jnp.asarray(x))
    port.eval()
    port.down.act_amax.zero_()
    with torch.no_grad():
        np.testing.assert_allclose(port(nchw(x)).permute(0, 2, 3, 1).numpy(),
                                   np.asarray(out), rtol=1e-5, atol=1e-5)


# ------------------------------------------------ the smoke model, trained

@pytest.fixture(scope='module')
def trained():
    """The committed checkpoint's variables, and the JAX smoke detector at
    128 px with the ``act_amax`` leaves of its ``qat_init`` (zeros)."""
    with open(f'{CKPT_DIR}/ckpt-1800.msgpack', 'rb') as f:
        ckpt = serialization.msgpack_restore(f.read())
    side = JaxSide(SMOKE, SIZE, variables={'params': ckpt['params'],
                                           'batch_stats': ckpt['batch_stats']})
    module = side.bundle.module
    shapes = jax.eval_shape(lambda: jq.qat_init(
        module, module.init, jax.random.PRNGKey(0),
        jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    return side, shapes


def zero_act_amax(stats, shapes):
    """``stats`` with a zero ``act_amax`` wherever ``shapes`` has one."""
    out = dict(stats)
    for key, value in shapes.items():
        if key == 'act_amax':
            out[key] = np.zeros((), np.float32)
        elif isinstance(value, dict):
            out[key] = zero_act_amax(stats.get(key, {}), value)
    return out


def qat_trainer(variables, **train):
    return Trainer.from_config(SMOKE, variables=variables, device='cpu',
                               overrides=port_overrides(SIZE, fused_bn=False,
                                                        qat=True, **train))


def test_act_amax_set_matches_jax_qat_init(trained):
    side, shapes = trained
    want = act_amax_paths(shapes['batch_stats'])
    trainer = qat_trainer(side.variables)
    got = {pq.conv_key(k[:-len('.act_amax')]) for k in trainer.model.state_dict()
           if k.endswith('.act_amax')}
    assert got == want and len(got) >= 30
    assert got == {k for k, _ in pq.supported_convs(trainer.model)}
    # a float model keeps its state_dict as it was
    float_trainer = Trainer.from_config(SMOKE, device='cpu')
    assert not any(k.endswith('act_amax')
                   for k in float_trainer.model.state_dict())


def test_fake_quant_forward_matches_jax_qat_apply(trained):
    """A train-mode forward seeds every ``act_amax`` (as JAX's does), then
    the eval forward reads JAX's learned scales."""
    side, shapes = trained
    module = side.bundle.module
    images = np.random.RandomState(4).rand(2, SIZE, SIZE, 3).astype(np.float32)
    variables = {'params': side.variables['params'],
                 'batch_stats': zero_act_amax(side.variables['batch_stats'],
                                              shapes['batch_stats'])}
    apply = jq.qat_apply(module)
    _, mutated = jax.jit(lambda v, x: apply(v, x, train=True,
                                            mutable=['batch_stats']))(
        variables, jnp.asarray(images))
    trainer = qat_trainer(side.variables)
    model = trainer.model.train()
    with torch.no_grad():
        model(nchw(images))
    learned_j = jq.amax_from_batch_stats(mutated['batch_stats'])
    learned_p = pq.amax_from_batch_stats(model.state_dict())
    assert set(learned_p) == set(learned_j) and len(learned_j) >= 30
    # the image is the stem's input: its amax is exact; past the first
    # quantized activations a flip cascades (module docstring)
    stem = 'features/base/stage0/conv'
    assert learned_p[stem] == learned_j[stem]
    for key, value in learned_j.items():
        assert learned_p[key] == pytest.approx(value, rel=CHAOS_REL), key

    learned = {'params': variables['params'], 'batch_stats': mutated['batch_stats']}
    model.load_state_dict(from_jax_variables(learned))
    model.eval()
    x = jnp.asarray(images)
    want = jax.jit(lambda v: apply(v, x, train=False))(learned)
    ref = jax.jit(lambda v: module.apply(v, x, train=False))(learned)
    with torch.no_grad():
        got = model(nchw(images))
    for name, g, w, r in zip(('scores', 'locs'), got, want, ref):
        noise = np.abs(np.asarray(w) - np.asarray(r)).max()
        err = np.abs(g.numpy() - np.asarray(w)).max()
        assert 0 < noise and err <= 0.05 * noise, (name, err, noise)


class Small(nn.Module):
    """A stem with TF-style padding and a train-mode BN, a conv applied
    twice and a head: every QAT path of a step, on few enough values that
    no activation lands near a rounding boundary."""

    @nn.compact
    def __call__(self, x, train=False):
        x = nn.Conv(8, (3, 3), strides=(2, 2), padding=((0, 1), (0, 1)),
                    use_bias=False, name='stem')(x)
        x = nn.relu(nn.BatchNorm(use_running_average=not train, momentum=0.9,
                                 epsilon=1e-5, name='bn')(x))
        shared = nn.Conv(8, (3, 3), padding=((1, 1), (1, 1)), name='shared')
        x = shared(nn.relu(shared(x)))
        return nn.Conv(4, (1, 1), name='head')(x)


class PortSmall(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = conv2d(3, 8, 3, stride=2, pad=(0, 1, 0, 1))
        self.bn = batch_norm(8)
        self.shared = conv2d(8, 8, 3, padding=1, bias=True)
        self.head = conv2d(8, 4, 1, bias=True)

    def forward(self, x):
        x = torch.relu(self.bn(self.stem(x)))
        return self.head(self.shared(torch.relu(self.shared(x))))


def test_qat_train_step_matches_jax_on_a_small_model():
    """Two QAT steps (SGD with momentum and weight decay) on ``Small``: the
    loss, the parameters, the BN running statistics and each ``act_amax``
    as ``test_torch_port_train.py`` holds the float step."""
    rng = np.random.RandomState(7)
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    target = rng.randn(2, 8, 8, 4).astype(np.float32)
    module = Small()
    variables = jq.qat_init(module, module.init, jax.random.PRNGKey(0),
                            jnp.asarray(x), train=False)
    apply = jq.qat_apply(module)
    tx = jax_optimizers.create_optimizer(dict(OPTIMIZER),
                                         lr_schedule=lambda step: 0.1)
    state_j = jax_train_state(variables, tx)

    @jax.jit
    def step_j(state, x):
        def loss_fn(params):
            y, mutated = apply({'params': params,
                                'batch_stats': state.batch_stats},
                               x, train=True, mutable=['batch_stats'])
            return jnp.mean((y - target) ** 2), mutated['batch_stats']
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return state.replace(params=optax_apply(state.params, updates),
                             batch_stats=stats, opt_state=opt_state), loss

    port = PortSmall()
    pq.qat_init(port)
    port.load_state_dict(from_jax_variables(variables))
    state_p = TrainState(port, pt_optimizers.create_optimizer(
        dict(OPTIMIZER), port.parameters()))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    for i, batch in enumerate((x, 2 * x)):
        state_j, loss_j = step_j(state_j, jnp.asarray(batch))
        port.train()
        loss = torch.mean((port(nchw(batch)) - nchw(target)) ** 2)
        state_p.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        apply_gradients(state_p, lambda step: 0.1)
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4,
                                   err_msg=f'step {i}')
    after_j = from_jax_variables({'params': state_j.params,
                                  'batch_stats': state_j.batch_stats})
    after_p = port.state_dict()
    updates = {k: (after_j[k] - before[k]).numpy() for k in after_j
               if k.endswith(('weight', 'bias'))}
    largest = max(np.abs(u).max() for u in updates.values())
    for name, want in updates.items():
        got = (after_p[name] - before[name]).numpy()
        atol = 1e-3 * max(np.abs(want).max(), 1e-2 * largest)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
    for name in ('bn.running_mean', 'bn.running_var'):
        np.testing.assert_allclose(after_p[name].numpy(), after_j[name].numpy(),
                                   rtol=1e-6, atol=1e-5, err_msg=name)
    for name in ('stem', 'shared', 'head'):
        want = float(after_j[f'{name}.act_amax'])
        assert want > 0 and float(after_p[f'{name}.act_amax']) == pytest.approx(
            want, rel=1e-6), name


# -------------------------------------------------------- checkpoints

def test_act_amax_crosses_weights_and_checkpoints(twice, tmp_path, caplog):
    """``from_jax_variables``/``to_jax_variables`` carry ``act_amax``; a JAX
    QAT ``.msgpack`` restores into a QAT run, and into a float run with the
    leaves dropped; a float ``.pt`` restores into a QAT run with zeros, and
    a QAT ``.pt`` into a float run without them."""
    module, variables, port, x = twice
    learned = jq.qat_apply(module)(variables, jnp.asarray(x), train=True,
                                   mutable=['batch_stats'])[1]['batch_stats']
    qat_vars = {'params': variables['params'], 'batch_stats': learned}
    state = from_jax_variables(qat_vars)
    assert float(state['shared.act_amax']) == float(learned['shared']['act_amax']) > 0
    back = to_jax_variables(state)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)), back, qat_vars))

    tx = jax_optimizers.create_optimizer({'name': 'SGD', 'lr': 1e-2})
    path = jax_ckpt.save(str(tmp_path / 'jax'), create_train_state(qat_vars, tx),
                         epoch=0)

    def port_state(qat: bool):
        model = PortTwice()
        if qat:
            pq.qat_init(model)
        return TrainState(model, pt_optimizers.create_optimizer(
            {'name': 'SGD', 'lr': 1e-2}, model.parameters()))

    caplog.set_level(logging.INFO)
    qat_state, _ = pt_ckpt.restore(path, port_state(True))
    assert float(qat_state.model.shared.act_amax) == float(learned['shared']['act_amax'])
    float_state, _ = pt_ckpt.restore(path, port_state(False))
    assert not any(k.endswith('act_amax') for k in float_state.model.state_dict())
    assert 'disables QAT: dropped 2 leaves' in caplog.text

    saved = pt_ckpt.save(str(tmp_path / 'float'), float_state, epoch=0)
    qat2, _ = pt_ckpt.restore(saved, port_state(True))
    assert float(qat2.model.shared.act_amax) == 0.0
    assert 'predates QAT: 2 act_amax' in caplog.text
    saved = pt_ckpt.save(str(tmp_path / 'qat'), qat_state, epoch=0)
    float2, _ = pt_ckpt.restore(saved, port_state(False))
    for name, value in float2.model.state_dict().items():
        assert torch.equal(value, qat_state.model.state_dict()[name]), name


def test_qat_does_not_compose_with_group_norm_or_fused_bn():
    with pytest.raises(ValueError, match='group_norm'):
        Trainer.from_config(SMOKE, device='cpu', overrides={
            'train': {'qat': True, 'group_norm': True}})
    with pytest.raises(ValueError, match='fused_bn'):
        Trainer.from_config(SMOKE, device='cpu', overrides={
            'train': {'qat': True, 'fused_bn': True}})
    assert pq.qat_options(0.95) == {'decay': 0.95, 'spatial_limit': None}
    assert pq.qat_options(True) == {'decay': pq.QAT_DECAY, 'spatial_limit': None}
    assert pq.qat_options({'spatial_limit': 64}) == {'decay': pq.QAT_DECAY,
                                                    'spatial_limit': 64}
    assert pq.qat_options(False) is None


def test_engine_qat_hands_its_scales_to_int8():
    """``train.qat`` through the ``Experiment``: the scales learn in
    training, eval runs the fake-quantized forward, and ``int8=True`` takes
    the learned scales with no calibration (the gate lets a QAT run
    through)."""
    exp = Experiment(SMOKE, device='cpu', int8=True, overrides={
        'train': {'qat': {'decay': 0.9}, 'epochs': 1}})
    exp.train()
    learned = pq.amax_from_batch_stats(exp.model.state_dict())
    assert learned
    result = exp.evaluate()
    assert result['int8'] == 1.0 and np.isfinite(result['loss'])
    assert exp._int8_amax == learned
