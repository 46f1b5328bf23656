"""Optimizers.

Port of ``single_shot_detection_tpu/train/optimizers.py``: the ten update
rules (``SGD``, ``SGDW``, ``Adam``, ``AdamW``, ``RMSprop``, ``Adagrad``,
``Adadelta``, ``Adamax``, ``NAdam``, ``RAdam``), ``lr_groups``,
``clip_grad_norm`` and gradient accumulation, as :func:`create_optimizer`
builds them.  The reference is the JAX package's optax chains, not
``torch.optim``; where the two differ the port follows optax:

* the whole update is multiplied by ``lr_scale`` (``ReduceLROnPlateau``'s
  factor), the decoupled decay of ``SGDW`` and ``AdamW`` included;
* ``SGDW`` and ``AdamW`` subtract ``weight_decay * p`` (the parameter
  before the step) after the step, not scaled by the rate;
* ``RMSprop`` divides by ``sqrt(nu + eps)`` (optax's ``eps_in_sqrt``),
  ``RAdam`` by ``sqrt(v / bc2) + eps``;
* ``SGD``, ``SGDW``, ``Adam``, ``AdamW`` and ``RMSprop`` take the schedule
  at the update count before it is incremented (optax's
  ``scale_by_learning_rate``), the hand-written five at the count after;
* an ``lr_groups`` group's rate is a constant (the schedule does not move
  it; ``lr_scale`` does), its parameters matched by the prefix of their
  JAX path joined by ``.`` (``utils/weights.py::variable_path``), the
  first prefix in the config's order winning;
* clipping (``optax.clip_by_global_norm``) scales by ``max / norm`` when
  ``norm >= max``, with no ``+1e-6``; under accumulation it clips the
  accumulated mean;
* accumulation (``optax.MultiSteps``, ``use_grad_mean``) keeps the running
  mean of the micro-steps' gradients and runs the update on every k-th
  micro-step; the steps between leave the parameters as they are, and the
  update count (what the schedule and the bias corrections read) counts
  updates, not micro-steps.

Each rule is one functional update over a param group's tensor lists in
``torch._foreach_*`` multi-tensor ops (a handful of launches per step for
all the parameters).  The counts come from the train state's step
(``TrainState.step``, micro-steps): the update count is ``step // k``, the
micro-step within the window ``step % k``, as a run started at 0 has them.
The per-parameter buffers live in ``Optimizer.state`` under the names the
checkpoints carry (``momentum_buffer`` for optax's ``trace``, ``mu``/``nu``,
``acc``, ``square_avg``/``acc_delta``, ``m``/``u``/``v``, and ``acc_grad``
for the accumulation); NAdam's ``mu_product`` is a number in its group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from single_shot_detection_tpu_torch import parallel
from single_shot_detection_tpu_torch.utils import weights

DEFAULT_LABEL = weights.DEFAULT_LABEL
# the per-group entries that are optimizer state, not configuration
GROUP_STATE_KEYS = ('mu_product',)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _bias_correction(decay: float, t: int) -> float:
    """``1 - decay ** t`` in f32, as optax computes it (at ``decay`` near 1
    the f32 cancellation is part of the result)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(t))


def _coupled_decay(group, params, grads):
    """``g + weight_decay * p`` (torch's coupled decay), out of place: the
    parameters' ``.grad`` stay the loss gradients."""
    wd = group['weight_decay']
    return torch._foreach_add(grads, params, alpha=wd) if wd else grads


def _moment(buf, grads, decay):
    """``buf = decay * buf + (1 - decay) * g``."""
    torch._foreach_mul_(buf, decay)
    torch._foreach_add_(buf, grads, alpha=1.0 - decay)


def _second_moment(buf, grads, decay):
    """``buf = decay * buf + (1 - decay) * g * g``."""
    torch._foreach_mul_(buf, decay)
    torch._foreach_addcmul_(buf, grads, grads, value=1.0 - decay)


def _trace(buf, grads, momentum):
    """optax's ``trace``: ``buf = g + momentum * buf``."""
    torch._foreach_mul_(buf, momentum)
    torch._foreach_add_(buf, grads)


def _decay_after(group, params, scale):
    """The decoupled decay of SGDW and AdamW: ``p -= scale * wd * p``,
    before the step's own term is added (both read the parameter before
    the step)."""
    if group['weight_decay']:
        torch._foreach_mul_(params, 1.0 - group['weight_decay'] * scale)


def _sgd(group, params, grads, bufs, count, lr, scale, decoupled=False):
    if not decoupled:
        grads = _coupled_decay(group, params, grads)
    update = grads
    if group['momentum']:
        trace = bufs['momentum_buffer']
        _trace(trace, grads, group['momentum'])
        update = (torch._foreach_add(grads, trace, alpha=group['momentum'])
                  if group['nesterov'] else trace)
    if decoupled:
        _decay_after(group, params, scale)
    torch._foreach_add_(params, update, alpha=-lr * scale)


def _sgdw(group, params, grads, bufs, count, lr, scale):
    _sgd(group, params, grads, bufs, count, lr, scale, decoupled=True)


def _adam(group, params, grads, bufs, count, lr, scale, decoupled=False):
    if not decoupled:
        grads = _coupled_decay(group, params, grads)
    b1, b2 = group['betas']
    mu, nu = bufs['mu'], bufs['nu']
    _moment(mu, grads, b1)
    _second_moment(nu, grads, b2)
    t = count + 1
    denom = torch._foreach_div(nu, _bias_correction(b2, t))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, group['eps'])
    if decoupled:
        _decay_after(group, params, scale)
    torch._foreach_addcdiv_(params, mu, denom,
                            value=-lr * scale / _bias_correction(b1, t))


def _adamw(group, params, grads, bufs, count, lr, scale):
    _adam(group, params, grads, bufs, count, lr, scale, decoupled=True)


def _rmsprop(group, params, grads, bufs, count, lr, scale):
    grads = _coupled_decay(group, params, grads)
    nu = bufs['nu']
    _second_moment(nu, grads, group['alpha'])
    denom = torch._foreach_add(nu, group['eps'])
    torch._foreach_sqrt_(denom)
    update = torch._foreach_div(grads, denom)
    if group['momentum']:
        trace = bufs['momentum_buffer']
        _trace(trace, update, group['momentum'])
        update = trace
    torch._foreach_add_(params, update, alpha=-lr * scale)


def _adagrad(group, params, grads, bufs, count, lr, scale):
    grads = _coupled_decay(group, params, grads)
    acc = bufs['acc']
    torch._foreach_addcmul_(acc, grads, grads)
    lr_t = lr / (1.0 + count * group['lr_decay'])
    denom = torch._foreach_sqrt(acc)
    torch._foreach_add_(denom, group['eps'])
    torch._foreach_addcdiv_(params, grads, denom, value=-lr_t * scale)


def _adadelta(group, params, grads, bufs, count, lr, scale):
    grads = _coupled_decay(group, params, grads)
    rho, eps = group['rho'], group['eps']
    square_avg, acc_delta = bufs['square_avg'], bufs['acc_delta']
    _second_moment(square_avg, grads, rho)
    std = torch._foreach_add(square_avg, eps)
    torch._foreach_sqrt_(std)
    delta = torch._foreach_add(acc_delta, eps)
    torch._foreach_sqrt_(delta)
    torch._foreach_div_(delta, std)
    torch._foreach_mul_(delta, grads)
    _second_moment(acc_delta, delta, rho)
    torch._foreach_add_(params, delta, alpha=-lr * scale)


def _adamax(group, params, grads, bufs, count, lr, scale):
    grads = _coupled_decay(group, params, grads)
    b1, b2 = group['betas']
    m, u = bufs['m'], bufs['u']
    _moment(m, grads, b1)
    # torch's Adamax folds eps inside the max
    norm = torch._foreach_abs(grads)
    torch._foreach_add_(norm, group['eps'])
    torch._foreach_mul_(u, b2)
    torch._foreach_maximum_(u, norm)
    torch._foreach_addcdiv_(params, m, u,
                            value=-lr * scale / _bias_correction(b1, count + 1))


def _nadam(group, params, grads, bufs, count, lr, scale):
    grads = _coupled_decay(group, params, grads)
    b1, b2 = group['betas']
    decay = group['momentum_decay']
    t = count + 1
    mu_t = b1 * (1.0 - 0.5 * 0.96 ** (t * decay))
    mu_next = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * decay))
    # the product is state: f32, as the JAX package keeps it
    mu_product = _f32(group['mu_product'] * _f32(mu_t))
    group['mu_product'] = mu_product
    mu_product_next = mu_product * mu_next
    m, v = bufs['m'], bufs['v']
    _moment(m, grads, b1)
    _second_moment(v, grads, b2)
    denom = torch._foreach_div(v, _bias_correction(b2, t))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, group['eps'])
    torch._foreach_addcdiv_(params, grads, denom,
                            value=-lr * scale * (1.0 - mu_t) / (1.0 - mu_product))
    torch._foreach_addcdiv_(params, m, denom,
                            value=-lr * scale * mu_next / (1.0 - mu_product_next))


def _radam(group, params, grads, bufs, count, lr, scale):
    grads = _coupled_decay(group, params, grads)
    b1, b2 = group['betas']
    rho_inf = 2.0 / (1.0 - b2) - 1.0
    t = count + 1
    m, v = bufs['m'], bufs['v']
    _moment(m, grads, b1)
    _second_moment(v, grads, b2)
    bc1, bc2 = _bias_correction(b1, t), _bias_correction(b2, t)
    rho_t = _f32(rho_inf - 2.0 * t * _f32(np.float32(b2) ** np.float32(t)) / bc2)
    if rho_t > 5.0:
        rect = math.sqrt(((rho_t - 4.0) * (rho_t - 2.0) * rho_inf)
                         / max((rho_inf - 4.0) * (rho_inf - 2.0) * rho_t, 1e-12))
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group['eps'])
        torch._foreach_addcdiv_(params, m, denom, value=-lr * scale * rect / bc1)
    else:
        torch._foreach_add_(params, m, alpha=-lr * scale / bc1)


@dataclasses.dataclass(frozen=True)
class Rule:
    """One update rule: its function, its hyperparameters with their
    defaults, its per-parameter buffers (``name -> initial value``; a
    buffer present only when ``needs(group)``), and the offset of the
    update count at which it reads the schedule (0: before the count is
    incremented, optax's ``scale_by_learning_rate``; 1: after)."""

    update: Callable
    defaults: Dict[str, object]
    buffers: Dict[str, str]
    lr_offset: int = 0
    needs: Callable = lambda group, name: True

    def buffer_names(self, group) -> List[str]:
        return [name for name in self.buffers if self.needs(group, name)]


def _momentum_only(group, name):
    return name != 'momentum_buffer' or bool(group['momentum'])


_SGD = {'momentum': 0.0, 'weight_decay': 0.0, 'nesterov': False}
_ADAM = {'betas': (0.9, 0.999), 'eps': 1e-8, 'weight_decay': 0.0}

RULES = {
    'SGD': Rule(_sgd, _SGD, {'momentum_buffer': 'zeros'}, 0, _momentum_only),
    'SGDW': Rule(_sgdw, _SGD, {'momentum_buffer': 'zeros'}, 0, _momentum_only),
    'Adam': Rule(_adam, _ADAM, {'mu': 'zeros', 'nu': 'zeros'}),
    'AdamW': Rule(_adamw, _ADAM, {'mu': 'zeros', 'nu': 'zeros'}),
    'RMSprop': Rule(_rmsprop, {'alpha': 0.99, 'eps': 1e-8, 'momentum': 0.0,
                               'weight_decay': 0.0},
                    {'nu': 'zeros', 'momentum_buffer': 'zeros'}, 0,
                    _momentum_only),
    'Adagrad': Rule(_adagrad, {'lr_decay': 0.0, 'eps': 1e-10,
                               'weight_decay': 0.0,
                               'initial_accumulator_value': 0.0},
                    {'acc': 'initial_accumulator_value'}, 1),
    'Adadelta': Rule(_adadelta, {'rho': 0.9, 'eps': 1e-6, 'weight_decay': 0.0},
                     {'square_avg': 'zeros', 'acc_delta': 'zeros'}, 1),
    'Adamax': Rule(_adamax, dict(_ADAM), {'m': 'zeros', 'u': 'zeros'}, 1),
    'NAdam': Rule(_nadam, {**_ADAM, 'momentum_decay': 4e-3, 'mu_product': 1.0},
                  {'m': 'zeros', 'v': 'zeros'}, 1),
    'RAdam': Rule(_radam, dict(_ADAM), {'m': 'zeros', 'v': 'zeros'}, 1),
}
OPTIMIZERS = tuple(RULES)


class Optimizer(torch.optim.Optimizer):
    """The optimizer of one rule over param groups (the default group and
    one per ``lr_groups`` prefix, each with its ``label``), with the
    clipping and the accumulation around it.

    ``step(count=, schedule=, lr_scale=)`` takes one micro-step on the
    parameters' ``.grad`` (a parameter without one takes zeros, as every
    JAX parameter has a gradient): ``count`` is the train state's step,
    ``schedule`` maps the update count to the rate of every group without
    a constant rate.  Returns whether the parameters moved (False between the micro-steps
    of an accumulation window)."""

    def __init__(self, rule: str, groups: List[dict],
                 clip_grad_norm: Optional[float] = None,
                 accumulation_steps: int = 1):
        self.rule = RULES[rule]
        self.rule_name = rule
        super().__init__(groups, {**self.rule.defaults, 'lr': 1e-3,
                                  'lr_constant': False,
                                  'label': DEFAULT_LABEL})
        self.clip_grad_norm = (None if clip_grad_norm is None
                               else float(clip_grad_norm))
        self.accumulation_steps = int(accumulation_steps)
        if self.accumulation_steps < 1:
            raise ValueError(f'accumulation_steps must be >= 1, got '
                             f'{accumulation_steps}')

        # ZeRO-1 (train.zero_sharding, :meth:`shard`): None, or the layout
        # and each parameter's name
        self.zero: Optional[parallel.ZeroLayout] = None
        self._names: Dict[torch.Tensor, str] = {}
        # tensor sharding (:meth:`shard_model`): the parameters that hold
        # a model slice, whose squares the clipping norm sums over the
        # model group
        self.model_sliced: set = set()

    def buffer_names(self, group) -> List[str]:
        """The per-parameter buffers ``group`` keeps (``acc_grad`` too
        under accumulation)."""
        names = self.rule.buffer_names(group)
        return names + ['acc_grad'] if self.accumulation_steps > 1 else names

    def shard(self, layout: 'parallel.ZeroLayout',
              named_params: Iterable) -> None:
        """ZeRO-1: from now on this rank keeps each parameter's buffers only
        for its slice of ``layout`` and updates only that slice of the
        parameter, whose whole is then gathered from every rank's slice.
        Every rule is elementwise, so the update is the unsliced one;
        clipping takes the global norm of the whole gradient.  Buffers
        already held whole are sliced (:meth:`shard_state`)."""
        self.zero = layout
        self._names = {p: name for name, p in named_params}
        self.shard_state()

    def shard_model(self, sliced_params: Iterable) -> None:
        """Tensor sharding: ``sliced_params`` hold this rank's model
        slices (the clipping norm counts each slice once over the model
        group, a whole parameter once)."""
        self.model_sliced = set(sliced_params)

    def _slice(self, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if self.zero is None:
            return t
        return self.zero.slice(self._names[p], t)

    def _sliced(self, p: torch.Tensor) -> bool:
        return (self.zero is not None
                and self.zero.axes.get(self._names[p]) is not None)

    def shard_state(self) -> None:
        """Slice every buffer still held whole (a restored checkpoint's)
        down to this rank's slice; nothing without ZeRO."""
        if self.zero is None:
            return
        for p, state in self.state.items():
            if not self._sliced(p):
                continue
            for name, buf in state.items():
                if isinstance(buf, torch.Tensor) and buf.shape == p.shape:
                    state[name] = self._slice(p, buf).clone()

    def full_state_dict(self) -> dict:
        """``state_dict()`` with every sliced buffer gathered whole (under
        ZeRO a collective every rank must enter, in the same order)."""
        saved = self.state_dict()
        if self.zero is None:
            return saved
        params = [p for g in self.param_groups for p in g['params']]
        for i, p in enumerate(params):
            if not self._sliced(p) or i not in saved['state']:
                continue
            axis = self.zero.axes[self._names[p]]
            # state_dict() shares each entry with the live state
            entry = saved['state'][i] = dict(saved['state'][i])
            for name in sorted(entry):
                if isinstance(entry[name], torch.Tensor):
                    entry[name] = parallel.all_gather_slices(entry[name], axis)
        return saved

    def _buffers(self, group) -> Dict[str, List[torch.Tensor]]:
        out = {}
        for name in self.buffer_names(group):
            init = self.rule.buffers.get(name, 'zeros')
            lst = []
            for p in group['params']:
                state = self.state[p]
                if name not in state:
                    fill = 0.0 if init == 'zeros' else float(group[init])
                    state[name] = torch.full_like(
                        self._slice(p, p), fill, dtype=torch.float32,
                        memory_format=torch.contiguous_format
                        if self.zero is not None else torch.preserve_format)
                lst.append(state[name])
            out[name] = lst
        return out

    @torch.no_grad()
    def step(self, closure=None, *, count: int,
             schedule: Callable[[int], float],
             lr_scale: float = 1.0) -> bool:
        if closure is not None:
            raise ValueError('this optimizer takes no closure')
        k = self.accumulation_steps
        updates, window = count // k, count % k
        groups = [(g, self._buffers(g)) for g in self.param_groups]
        grads = [[p.grad if p.grad is not None else torch.zeros_like(p)
                  for p in g['params']] for g, _ in groups]
        if k == 1 and self.clip_grad_norm is not None:
            # the whole gradient, on every rank under ZeRO
            grads = clip_by_global_norm(grads, self.clip_grad_norm,
                                        model_sliced=self._model_mask(groups))
        grads = [[self._slice(p, t) for p, t in zip(g['params'], gs)]
                 for (g, _), gs in zip(groups, grads)]
        if k > 1:
            # optax.MultiSteps(use_grad_mean=True): the running mean
            for (_, bufs), g in zip(groups, grads):
                if window == 0:
                    torch._foreach_copy_(bufs['acc_grad'], g)
                else:
                    torch._foreach_lerp_(bufs['acc_grad'], g, 1.0 / (window + 1))
            if window != k - 1:
                return False
            grads = [bufs['acc_grad'] for _, bufs in groups]
            if self.clip_grad_norm is not None:
                grads = clip_by_global_norm(grads, self.clip_grad_norm,
                                            self._sliced_mask(groups),
                                            self._model_mask(groups))
        for (group, bufs), g in zip(groups, grads):
            lr = (float(group['lr']) if group['lr_constant'] else
                  float(schedule(updates + self.rule.lr_offset)))
            params = [self._slice(p, p) for p in group['params']]
            self.rule.update(group, params, g, bufs, updates, lr,
                             float(lr_scale))
        if self.zero is not None:
            for group in self.param_groups:
                for p in group['params']:
                    self.zero.gather_(self._names[p], p)
        return True

    def _sliced_mask(self, groups) -> Optional[List[List[bool]]]:
        """Which of the groups' leaves are slices (ZeRO), for the global
        norm; None without ZeRO."""
        if self.zero is None:
            return None
        return [[self._sliced(p) for p in g['params']] for g, _ in groups]

    def _model_mask(self, groups) -> Optional[List[List[bool]]]:
        """Which leaves are model slices (tensor sharding); None without."""
        if not self.model_sliced:
            return None
        return [[p in self.model_sliced for p in g['params']]
                for g, _ in groups]


def clip_by_global_norm(grads: List[List[torch.Tensor]],
                        max_norm: float,
                        sliced: Optional[List[List[bool]]] = None,
                        model_sliced: Optional[List[List[bool]]] = None
                        ) -> List[List[torch.Tensor]]:
    """optax's ``clip_by_global_norm`` over the groups' gradient lists:
    each scaled by ``max_norm / norm`` when the global norm is ``>=
    max_norm``, unchanged below it; out of place, without a host sync.
    The norm accumulates in f64: an f32 sum of a detector's millions of
    squares drifts by parts in a million with its order (6e-6 on the
    flagship's 4.4M gradients on the CPU), which would move every update
    by as much between devices.  ``sliced`` (ZeRO-1) marks the leaves that
    are this rank's slices: their squares are summed over the ranks, the
    whole leaves' counted once.  ``model_sliced`` (tensor sharding) marks
    the model slices, summed over the model group (over the world for a
    leaf sliced on both axes)."""
    flat = [t for g in grads for t in g]
    if not flat:
        return grads
    norms = torch.stack(torch._foreach_norm(flat, 2, dtype=torch.float64))
    if sliced is None and model_sliced is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        def flags(marks):
            return [m for g in marks for m in g] if marks else [False] * len(flat)

        squares = norms * norms
        total = squares.new_zeros(())
        for axis, on in ((None, (False, False)), ('data', (True, False)),
                         ('model', (False, True)), ('world', (True, True))):
            keep = [pair == on for pair in zip(flags(sliced),
                                               flags(model_sliced))]
            if not any(keep):
                continue
            part = torch.where(torch.tensor(keep, device=norms.device),
                               squares, 0.0).sum().reshape(1)
            total = total + (part[0] if axis is None else
                             parallel.all_reduce_(part, axis=axis)[0])
        norm = torch.sqrt(total)
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm).to(flat[0].dtype)
    return [torch._foreach_mul(g, factor) if g else g for g in grads]


def jax_path(name: str, ndim: int) -> str:
    """A parameter's JAX path joined by ``.`` (``lr_groups`` matches its
    prefixes), e.g. ``features.base.stage3.expand_conv.kernel``."""
    return '.'.join(weights.variable_path(name, ndim)[1:])


def _hyperparameters(rule: Rule, cfg: dict) -> dict:
    """The rule's hyperparameters from the config; other keys are ignored,
    as the JAX factories' ``**_`` ignores them."""
    out = {}
    for key, default in rule.defaults.items():
        if key in GROUP_STATE_KEYS:
            out[key] = default
        elif key in cfg:
            value = cfg[key]
            out[key] = tuple(value) if key == 'betas' else value
    return out


def create_optimizer(optimizer_params: dict, params: Iterable,
                     accumulation_steps: int = 1,
                     clip_grad_norm=None) -> Optimizer:
    """Config-driven optimizer over ``params``: parameters, or ``(name,
    parameter)`` pairs (``model.named_parameters()``; ``lr_groups`` needs
    the names).  ``optimizer_params`` is the config's ``optimizer`` block:
    ``name``, ``lr`` (the default group's base rate), the rule's
    hyperparameters and ``lr_groups`` (``{JAX path prefix: constant
    rate}``)."""
    cfg = dict(optimizer_params)
    name = cfg.pop('name')
    if name not in RULES:
        raise KeyError(f'unknown optimizer {name!r} (known: '
                       f'{", ".join(OPTIMIZERS)})')
    rule = RULES[name]
    lr = float(cfg.get('lr', 1e-3))
    lr_groups = dict(cfg.pop('lr_groups', None) or {})
    hyper = _hyperparameters(rule, cfg)
    items = list(params)
    named = [item for item in items if isinstance(item, tuple)]
    if lr_groups and len(named) != len(items):
        raise ValueError('lr_groups needs the parameters with their names '
                         '(model.named_parameters())')
    members: Dict[str, List[torch.nn.Parameter]] = {DEFAULT_LABEL: []}
    members.update({prefix: [] for prefix in lr_groups})
    for item in items:
        p = item[1] if isinstance(item, tuple) else item
        label = DEFAULT_LABEL
        if lr_groups:
            path = jax_path(item[0], p.ndim)
            label = next((prefix for prefix in lr_groups
                          if path.startswith(prefix)), DEFAULT_LABEL)
        members[label].append(p)
    groups = []
    for label, ps in members.items():
        if not ps:
            continue
        constant = label != DEFAULT_LABEL
        groups.append({'params': ps, 'label': label, 'lr_constant': constant,
                       'lr': float(lr_groups[label]) if constant else lr,
                       **hyper})
    return Optimizer(name, groups, clip_grad_norm, accumulation_steps)

