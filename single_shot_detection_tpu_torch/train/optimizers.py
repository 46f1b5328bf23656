"""Optimizer factory.

Port of ``single_shot_detection_tpu/train/optimizers.py::create_optimizer``
for ``SGD``.  ``torch.optim.SGD`` adds the coupled decay ``wd * p`` to every
gradient, then runs momentum, then steps by ``-lr``: the order of the JAX
package's ``add_decayed_weights -> trace -> scale_by_learning_rate`` chain.
The learning rate is set on the param groups before each step from the
schedule (``train/schedulers.py``).  The other optimizers, ``lr_groups``,
gradient clipping and accumulation are not ported yet and raise.
"""

from __future__ import annotations

from typing import Iterable

import torch


def sgd(params: Iterable[torch.nn.Parameter], lr: float,
        momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False, **_) -> torch.optim.Optimizer:
    """torch.optim.SGD with the JAX package's defaults (no dampening)."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           weight_decay=weight_decay, nesterov=nesterov)


OPTIMIZERS = {'SGD': sgd}


def create_optimizer(optimizer_params: dict,
                     params: Iterable[torch.nn.Parameter],
                     accumulation_steps: int = 1,
                     clip_grad_norm=None) -> torch.optim.Optimizer:
    """Config-driven optimizer factory over ``params``."""
    cfg = dict(optimizer_params)
    name = cfg.pop('name')
    if name not in OPTIMIZERS:
        raise NotImplementedError(
            f'optimizer {name!r} is not ported yet (ported: '
            f'{", ".join(sorted(OPTIMIZERS))})')
    if cfg.pop('lr_groups', None):
        raise NotImplementedError('optimizer lr_groups are not ported yet')
    if accumulation_steps != 1:
        raise NotImplementedError('gradient accumulation is not ported yet')
    if clip_grad_norm is not None:
        raise NotImplementedError('clip_grad_norm is not ported yet')
    return OPTIMIZERS[name](params, **cfg)
