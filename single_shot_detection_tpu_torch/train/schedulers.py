"""Learning-rate schedules.

Port of ``single_shot_detection_tpu/train/schedulers.py``: ``MultiStepLR``,
``StepLR``, ``ExponentialLR``, ``CosineAnnealingLR``, ``LinearGrowthLR``
(warmup), ``ConcatScheduler`` (a piecewise timeline) and
``CosineAnnealingWithWarmupLR``, each a plain function of a tick, and the
host-side ``ReduceLROnPlateau``.  A schedule built by
:func:`create_lr_schedule` is a function of the optimizer step count; it
ticks per epoch (``step // steps_per_epoch``) unless ``run_each_step``, as
the reference's per-epoch ``scheduler.step()``.  ``ReduceLROnPlateau``
reacts to eval metrics: the engine writes its ``scale`` into the train
state's ``lr_scale``, which multiplies the scheduled rate.

The JAX schedules compute in float32 inside the jitted step; these compute
in Python floats.
"""

from __future__ import annotations

import bisect
import inspect
import math
from typing import Callable, Optional, Sequence, Tuple

Schedule = Callable[[int], float]


def multi_step_lr(base_lr: float, milestones: Sequence[int],
                  gamma: float = 0.1) -> Schedule:
    """torch MultiStepLR: ``lr * gamma ** (milestones passed)``."""
    ms = sorted(milestones)

    def schedule(tick: int) -> float:
        return base_lr * gamma ** bisect.bisect_right(ms, tick)

    return schedule


def step_lr(base_lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    def schedule(tick: int) -> float:
        return base_lr * gamma ** (tick // step_size)

    return schedule


def exponential_lr(base_lr: float, gamma: float) -> Schedule:
    def schedule(tick: int) -> float:
        return base_lr * gamma ** tick

    return schedule


def cosine_annealing_lr(base_lr: float, T_max: int,
                        eta_min: float = 0.0) -> Schedule:
    T_max = max(int(T_max), 1)  # degenerate horizon (e.g. warmup == total)

    def schedule(tick: int) -> float:
        t = min(tick, T_max)
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t / T_max)) / 2

    return schedule


def linear_growth_lr(base_lr: float, cold_lr: float, steps: int) -> Schedule:
    """Warmup from ``cold_lr`` to ``base_lr`` over ``steps`` ticks."""

    def schedule(tick: int) -> float:
        frac = min(max(tick / max(steps - 1, 1), 0.0), 1.0)
        return cold_lr + frac * (base_lr - cold_lr)

    return schedule


def concat_scheduler(base_lr: float, schedulers: Sequence) -> Schedule:
    """Piecewise timeline of sub-schedules: ``schedulers`` entries are
    ``(start_tick, name, kwargs)``; each segment sees a tick counter
    restarted at its start, and the first segment also runs before its
    start."""
    segments = sorted(((start, _build(name, base_lr, kwargs))
                       for start, name, kwargs in schedulers),
                      key=lambda s: s[0])

    def schedule(tick: int) -> float:
        start, seg = segments[0]
        for s, fn in segments[1:]:
            if tick >= s:
                start, seg = s, fn
        return seg(tick - start)

    return schedule


def cosine_annealing_with_warmup_lr(base_lr: float, T_max: int,
                                    eta_min: float = 0.0,
                                    warmup_steps: int = 0,
                                    warmup_lr: float = 0.0) -> Schedule:
    """LinearGrowth warmup, then cosine to ``T_max``."""
    return concat_scheduler(base_lr, [
        (0, 'LinearGrowthLR', {'cold_lr': warmup_lr, 'steps': warmup_steps}),
        (warmup_steps, 'CosineAnnealingLR',
         {'T_max': T_max - warmup_steps, 'eta_min': eta_min}),
    ])


class ReduceLROnPlateau:
    """Host-side plateau controller (torch ``ReduceLROnPlateau``).

    Call ``update(metric)`` after each evaluation; it returns ``scale``,
    which the engine writes into the train state's ``lr_scale``.
    """

    def __init__(self, mode: str = 'min', factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 min_lr: float = 0.0, base_lr: float = 1.0, **_):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_scale = min_lr / base_lr if base_lr else 0.0
        self.best = None
        self.num_bad = 0
        self.scale = 1.0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == 'min':
            return metric < self.best * (1 - self.threshold)
        return metric > self.best * (1 + self.threshold)

    def update(self, metric: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.num_bad = 0
        return self.scale


_FACTORIES = {
    'MultiStepLR': multi_step_lr,
    'StepLR': step_lr,
    'ExponentialLR': exponential_lr,
    'CosineAnnealingLR': cosine_annealing_lr,
    'LinearGrowthLR': linear_growth_lr,
    'ConcatScheduler': concat_scheduler,
    'CosineAnnealingWithWarmupLR': cosine_annealing_with_warmup_lr,
}


def _build(name: str, base_lr: float, kwargs: dict) -> Schedule:
    """The named schedule from the keyword arguments its factory takes."""
    if name not in _FACTORIES:
        raise KeyError(f'unknown scheduler {name!r} (known: '
                       f'{", ".join(sorted(_FACTORIES))}, ReduceLROnPlateau)')
    factory = _FACTORIES[name]
    params = inspect.signature(factory).parameters
    return factory(base_lr, **{k: v for k, v in kwargs.items() if k in params})


def create_lr_schedule(scheduler_params: Optional[dict], base_lr: float,
                       steps_per_epoch: int
                       ) -> Tuple[Schedule, Optional[ReduceLROnPlateau],
                                  Optional[str]]:
    """Config-driven schedule factory: ``(schedule(optimizer_step) -> lr,
    plateau or None, scheduler_metric)``."""
    if scheduler_params is None:
        return (lambda step: base_lr), None, None

    params = dict(scheduler_params)
    name = params.pop('name')
    run_each_step = params.pop('run_each_step', False)
    metric = params.pop('scheduler_metric', 'eval_loss')

    if name == 'ReduceLROnPlateau':
        plateau = ReduceLROnPlateau(base_lr=base_lr, **params)
        return (lambda step: base_lr), plateau, metric

    inner = _build(name, base_lr, params)

    def schedule(step: int) -> float:
        tick = step if run_each_step else step // max(steps_per_epoch, 1)
        return inner(tick)

    return schedule, None, metric
