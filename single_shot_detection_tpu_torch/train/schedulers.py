"""Learning-rate schedules.

Port of ``single_shot_detection_tpu/train/schedulers.py`` for
``MultiStepLR``.  A schedule is a plain function of the optimizer step
count; it ticks per epoch (``step // steps_per_epoch``) unless
``run_each_step``, as the reference's per-epoch ``scheduler.step()``.  The
other schedules and ``ReduceLROnPlateau`` are not ported yet and raise.
"""

from __future__ import annotations

import bisect
import inspect
from typing import Callable, Sequence


def multi_step_lr(base_lr: float, milestones: Sequence[int],
                  gamma: float = 0.1) -> Callable[[int], float]:
    """torch MultiStepLR: ``lr * gamma ** (milestones passed)``."""
    ms = sorted(milestones)

    def schedule(tick: int) -> float:
        return base_lr * gamma ** bisect.bisect_right(ms, tick)

    return schedule


_FACTORIES = {'MultiStepLR': multi_step_lr}


def create_lr_schedule(scheduler_params, base_lr: float,
                       steps_per_epoch: int) -> Callable[[int], float]:
    """Config-driven schedule: ``schedule(optimizer_step) -> lr``."""
    if scheduler_params is None:
        return lambda step: base_lr
    params = dict(scheduler_params)
    name = params.pop('name')
    run_each_step = params.pop('run_each_step', False)
    params.pop('scheduler_metric', None)
    if name not in _FACTORIES:
        raise NotImplementedError(
            f'scheduler {name!r} is not ported yet (ported: '
            f'{", ".join(sorted(_FACTORIES))})')
    factory = _FACTORIES[name]
    allowed = {k: v for k, v in params.items()
               if k in inspect.signature(factory).parameters}
    inner = factory(base_lr, **allowed)

    def schedule(step: int) -> float:
        tick = step if run_each_step else step // max(steps_per_epoch, 1)
        return inner(tick)

    return schedule
