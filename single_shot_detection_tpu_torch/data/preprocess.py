"""Serving-side preprocessing: staged uint8 NHWC images -> normalized
float32 NCHW model input, on the device.

Port of the JAX package's eval path: ``data/loader.py::stage_image`` (resize
to the input size) followed by the eval ``data/transforms.py::Pipeline``
(``ToFloatTensor``/``Normalize``/``Resize``).  At eval the pipeline's
``sample_view`` resample is the identity when the staged size equals the
output size, so once an image is staged only the normalization remains.

Resize: ``stage_image`` uses cv2's ``INTER_LINEAR`` (fixed-point weights) on
the host.  Here the resize is ``F.interpolate(mode='bilinear',
align_corners=False)`` on the device, rounded back to uint8 values; the two
can differ by one grey level at some pixels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def stage_images(images: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of uint8 ``[B, H, W, 3]`` to ``size=(w, h)``;
    returns uint8 ``[B, h, w, 3]`` (unchanged when already that size)."""
    new_w, new_h = size
    if images.shape[1:3] == (new_h, new_w):
        return images
    x = images.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(new_h, new_w), mode='bilinear',
                      align_corners=False)
    x = x.round().clamp(0, 255).to(torch.uint8)
    return x.permute(0, 2, 3, 1)


class Preprocess:
    """Config-driven eval preprocessing.

    ``__call__(images)``: uint8 (or float) ``[B, H, W, 3]`` RGB on the
    device -> float32 ``[B, 3, h, w]``, staged to ``input_size`` (or the
    ``Resize`` entry's size) and normalized in the JAX pipeline's order:
    ``x / divisor``, then ``(x - mean) / std``.
    """

    def __init__(self, preprocessing: Sequence[dict] = (),
                 input_size: Tuple[int, int] = (300, 300)):
        self.input_size = tuple(input_size)
        self.divisor = 1.0
        self.mean: Optional[Tuple[float, ...]] = None
        self.std: Optional[Tuple[float, ...]] = None
        for spec in preprocessing:
            name = spec['name']
            args = dict(spec.get('args', {}))
            if name == 'ToFloatTensor':
                if args.get('normalize', False):
                    self.divisor = 255.0
            elif name == 'Normalize':
                self.mean = tuple(args['mean'])
                self.std = tuple(args['std'])
            elif name == 'Resize':
                self.input_size = tuple(args['size'])
            else:
                raise NotImplementedError(f'Unsupported preprocessing: {name}')

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        x = stage_images(images, self.input_size).float() / self.divisor
        if self.mean is not None:
            mean = torch.tensor(self.mean, dtype=torch.float32, device=x.device)
            std = torch.tensor(self.std, dtype=torch.float32, device=x.device)
            x = (x - mean) / std
        return x.permute(0, 3, 1, 2).contiguous()
