"""Train state.

Port of ``single_shot_detection_tpu/train/state.py::TrainState``.  The JAX
state is one immutable pytree; here the model (parameters and BN running
statistics) and the optimizer (its buffers) hold their tensors and are
updated in place, and the state adds the step counter (micro-steps: with
``accumulation_steps`` k the optimizer's update count is ``step // k``,
which the schedule ticks on) and ``lr_scale`` (the ``ReduceLROnPlateau``
multiplier of the whole update).

``ema_params`` is the EMA shadow under ``train.ema``: ``{parameter name:
f32 tensor}``, updated in place after each step (empty without EMA).  The
tensors are the parameters of :func:`shadow_module`'s copy of the model,
which evaluation and serving run.

``mask`` is the pruning mask, the state of the JAX package's ``masked``
optimizer wrapper: None without ``train.pruner``; with it, ``{parameter
name: 0/1 tensor}`` (``[C, 1, 1, 1]`` for a conv weight, ``[C]`` for a
vector; an absent parameter is all ones), applied after each optimizer
step (``train/pruning.py``).

``zero`` is ZeRO-1's layout (``train.zero_sharding`` over several
processes, ``parallel/mesh.py::ZeroLayout``), None without it: the
optimizer keeps only this rank's slices of its buffers, and the EMA update
runs on this rank's slice of each shadow leaf; :func:`gather_shadow` makes
the shadow whole again before it is evaluated or saved.

``tensor`` is tensor sharding's placement (``train.tensor_sharding``,
``parallel/tensor.py``), None without it: ``{state_dict key: axis or
None}``; the model, the optimizer's buffers, the shadow and the mask hold
this rank's model slice of each sliced leaf, and a save gathers them.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import torch

from single_shot_detection_tpu_torch.parallel import ZeroLayout


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    lr_scale: float = 1.0
    ema_params: dict = dataclasses.field(default_factory=dict)
    mask: Optional[Dict[str, torch.Tensor]] = None
    zero: Optional[ZeroLayout] = None
    tensor: Optional[Dict[str, Optional[int]]] = None


def shadow_module(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` whose parameters are a separate shadow (a copy
    of the parameters now, not requiring gradients) and whose buffers are
    ``model``'s own tensors: the JAX package's ``{'params': ema_params,
    'batch_stats': batch_stats}``.  The buffers stay shared as long as
    both are written in place (the BN forward, ``load_state_dict``)."""
    memo = {id(b): b for b in model.buffers()}
    shadow = copy.deepcopy(model, memo)
    shadow.requires_grad_(False)
    return shadow


def reset_shadow(state: TrainState) -> None:
    """Set the EMA shadow to a copy of the parameters (after a weights
    load, or for a checkpoint that has none)."""
    if not state.ema_params:
        return
    params = dict(state.model.named_parameters())
    names = list(state.ema_params)
    torch._foreach_copy_([state.ema_params[n] for n in names],
                         [params[n].detach() for n in names])


def gather_shadow(state: TrainState) -> None:
    """Under ZeRO-1, make every EMA shadow leaf whole from every rank's
    slice (a collective every rank must enter); nothing otherwise."""
    if state.zero is None or not state.ema_params:
        return
    with torch.no_grad():
        for name in sorted(state.ema_params):
            state.zero.gather_(name, state.ema_params[name])
