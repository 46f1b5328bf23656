"""Train state.

Port of ``single_shot_detection_tpu/train/state.py::TrainState``.  The JAX
state is one immutable pytree; here the model (parameters and BN running
statistics) and the optimizer (momentum buffers) hold their tensors and are
updated in place, and the state adds the step counter (the optimizer's
step count, which the schedule ticks on) and ``lr_scale`` (the
``ReduceLROnPlateau`` multiplier: the step's rate is ``schedule(step) *
lr_scale``).  ``ema_params`` stays empty: the EMA is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    lr_scale: float = 1.0
    ema_params: dict = dataclasses.field(default_factory=dict)
