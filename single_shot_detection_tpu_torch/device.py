"""Device resolution and numeric policy.

Entry points default to ``cuda`` and raise when CUDA is absent: nothing
carries on quietly on the CPU.  ``device='cpu'`` is an explicit request (the
tests use it).

The numeric policy (docs/DESIGN.md §10) is a compute dtype and a matmul/conv
precision.  Parameters, BN running statistics, the optimizer's state and
the losses stay f32 under either dtype; ``bfloat16`` is the dtype of the
activations (``models/layers.py``).  The precision is resolved as the JAX
engine resolves ``jax_default_matmul_precision``
(``single_shot_detection_tpu/train/engine.py``): an explicit argument, then
the config's ``train.matmul_precision``, then the user's ambient setting,
then the policy's default, ``highest`` for f32 (true f32, TF32 off) and
XLA's ``default`` for bf16.  Its names map onto torch's flags as JAX maps
them on a GPU:

- ``highest`` / ``float32``: TF32 off for cuDNN convolutions and cuBLAS
  matmuls;
- ``high`` / ``tensorfloat32`` / ``default``: TF32 on for both;
- ``bfloat16``: TF32 for cuDNN convolutions (cuDNN has no f32 mode with
  bf16 internals) and ``torch.set_float32_matmul_precision('medium')``.

The ambient setting is read back from those flags; a state that matches no
name (torch's stock one, TF32 convolutions with f32 matmuls, among them)
counts as unset.  A value this module wrote is never taken for the user's:
an entry point remembers what it wrote, so one Experiment's write does not
leak into the next one's resolution.  Each entry point also runs its own
calls under its own flags and restores the ones it found
(:meth:`NumericPolicy.scope`), so entry points of different policies can
live side by side.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping, Optional, Tuple, Union

import torch

# (cuDNN TF32, torch.get_float32_matmul_precision()) of each precision name
PRECISION_FLAGS = {
    'highest': (False, 'highest'),
    'float32': (False, 'highest'),
    'high': (True, 'high'),
    'tensorfloat32': (True, 'high'),
    'default': (True, 'high'),
    'bfloat16': (True, 'medium'),
}
# the name an ambient state reads back as
_AMBIENT_NAMES = {(False, 'highest'): 'highest', (True, 'high'): 'high',
                  (True, 'medium'): 'bfloat16'}

Flags = Tuple[bool, str]

# what the last entry point wrote, and the user's ambient precision it saw
_last_write: Optional[Flags] = None
_user_ambient: Optional[str] = None


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``.  Raises if a CUDA device is asked for and
    CUDA is not available."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" to run on the CPU')
    return device


def current_flags() -> Flags:
    return (bool(torch.backends.cudnn.allow_tf32),
            torch.get_float32_matmul_precision())


def set_flags(flags: Flags) -> None:
    torch.backends.cudnn.allow_tf32 = flags[0]
    torch.set_float32_matmul_precision(flags[1])


@dataclasses.dataclass(frozen=True)
class NumericPolicy:
    """The compute ``dtype`` and the resolved ``matmul_precision`` (None:
    the bf16 policy's ``default``) with the torch flags it sets."""

    dtype: torch.dtype
    matmul_precision: Optional[str]
    flags: Flags

    @contextlib.contextmanager
    def scope(self):
        """Run under this policy's flags; the flags found are restored."""
        before = current_flags()
        if before == self.flags:
            yield
            return
        set_flags(self.flags)
        try:
            yield
        finally:
            set_flags(before)


def numeric_policy(bf16: bool = False, matmul_precision: Optional[str] = None,
                   train_cfg: Optional[Mapping] = None) -> NumericPolicy:
    """Resolve an entry point's policy and write its flags (they stay set
    until another entry point writes, as the JAX engine's write does)."""
    global _last_write, _user_ambient
    current = current_flags()
    if _last_write is None or current != _last_write:
        # first entry point, or the user changed the flags since the last
        # write: (re-)capture their preference
        _user_ambient = _AMBIENT_NAMES.get(current)
    requested = matmul_precision
    if requested is None:
        requested = dict(train_cfg or {}).get('matmul_precision')
    if requested is None:
        requested = _user_ambient
    if requested is None and not bf16:
        requested = 'highest'
    if requested is not None and requested not in PRECISION_FLAGS:
        raise ValueError(f'matmul precision {requested!r} is none of '
                         f'{", ".join(PRECISION_FLAGS)}')
    flags = PRECISION_FLAGS[requested or 'default']
    set_flags(flags)
    _last_write = flags
    return NumericPolicy(torch.bfloat16 if bf16 else torch.float32,
                         requested, flags)
