"""Device resolution and numeric policy.

Entry points default to ``cuda`` and raise when CUDA is absent: nothing
carries on quietly on the CPU.  ``device='cpu'`` is an explicit request (the
tests use it).

f32 runs as true f32: TF32 is switched off for cuDNN convolutions and for
matmuls, matching the JAX engine's ``matmul_precision='highest'``
(``single_shot_detection_tpu/main.py``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``.  Raises if a CUDA device is asked for and
    CUDA is not available."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" to run on the CPU')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    return device
