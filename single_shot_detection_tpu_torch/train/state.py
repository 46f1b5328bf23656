"""Train state.

Port of ``single_shot_detection_tpu/train/state.py::TrainState``.  The JAX
state is one immutable pytree; here the model (parameters and BN running
statistics) and the optimizer (momentum buffers) hold their tensors and are
updated in place, and the state adds the step counter (the optimizer's
step count, which the schedule ticks on) and ``lr_scale`` (the
``ReduceLROnPlateau`` multiplier: the step's rate is ``schedule(step) *
lr_scale``).  ``ema_params`` stays empty: the EMA is not ported yet.

``mask`` is the pruning mask, the state of the JAX package's ``masked``
optimizer wrapper: None without ``train.pruner``; with it, ``{parameter
name: 0/1 tensor}`` (``[C, 1, 1, 1]`` for a conv weight, ``[C]`` for a
vector; an absent parameter is all ones), applied after each optimizer
step (``train/pruning.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    lr_scale: float = 1.0
    ema_params: dict = dataclasses.field(default_factory=dict)
    mask: Optional[Dict[str, torch.Tensor]] = None
