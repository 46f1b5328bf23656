"""Preprocessing: staged uint8 NHWC images -> normalized float32 NCHW model
input, on the device, for serving (``__call__``) and for the train step
(``train_batch``).

Port of the JAX package's eval path: ``data/loader.py::stage_image`` (resize
to the input size) followed by the eval ``data/transforms.py::Pipeline``
(``ToFloatTensor``/``Normalize``/``Resize``).  At eval the pipeline's
``sample_view`` resample is the identity when the staged size equals the
output size, so once an image is staged only the normalization remains.

Resize: ``stage_image`` uses cv2's ``INTER_LINEAR`` (fixed-point weights) on
the host.  Here the resize is ``F.interpolate(mode='bilinear',
align_corners=False)`` on the device, rounded back to uint8 values; the two
can differ by one grey level at some pixels.

Train side: the JAX train ``Pipeline`` with no augmentation
(``data/transforms.py::Pipeline._run_one``): the staged image is resampled
to the output size (``sample_view`` of the identity window: bilinear, with
out-of-frame weight blended toward the image's mean colour; the identity
when the sizes agree), boxes are scaled to the output frame and clipped to
``[0, size - 1]``, and boxes that became degenerate leave the mask.
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
        return self._normalize(stage_images(images, self.input_size).float())

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        x = x / self.divisor
        if self.mean is not None:
            mean = torch.tensor(self.mean, dtype=torch.float32, device=x.device)
            std = torch.tensor(self.std, dtype=torch.float32, device=x.device)
            x = (x - mean) / std
        return x.permute(0, 3, 1, 2).contiguous()

    def train_batch(self, images: torch.Tensor, boxes: torch.Tensor,
                    mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Staged ``[B, S, S, 3]`` images, boxes ``[B, G, R>=4]`` in staged
        pixels and mask ``[B, G]`` -> ``(x [B, 3, h, w], boxes, mask)`` with
        boxes in output pixels."""
        cur_h, cur_w = images.shape[1:3]
        out_w, out_h = self.input_size
        x = images.float()
        if (cur_w, cur_h) != (out_w, out_h):
            x = resample_view(x, (out_w, out_h))
        sx = out_w / cur_w
        sy = out_h / cur_h
        resized = torch.stack([
            torch.clamp(boxes[..., 0] * sx, 0, out_w - 1),
            torch.clamp(boxes[..., 1] * sy, 0, out_h - 1),
            torch.clamp(boxes[..., 2] * sx, 0, out_w - 1),
            torch.clamp(boxes[..., 3] * sy, 0, out_h - 1),
        ], dim=-1)
        boxes = torch.cat([resized, boxes[..., 4:]], dim=-1)
        degenerate = ((boxes[..., 0] == boxes[..., 2])
                      | (boxes[..., 1] == boxes[..., 3]))
        return self._normalize(x), boxes, mask & ~degenerate


def resample_view(images: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resample of float ``[B, H, W, 3]`` to ``size=(w, h)`` as the
    JAX ``sample_view`` does it for the identity window: separable weights
    ``relu(1 - |src - j|)`` applied as two products, out-of-frame weight
    filled with each image's mean colour."""
    out_w, out_h = size
    cur_h, cur_w = images.shape[1:3]
    dev = images.device

    def weights(out: int, cur: int) -> torch.Tensor:
        src = (torch.arange(out, dtype=torch.float32, device=dev) + 0.5) \
            * cur / out - 0.5
        grid = torch.arange(cur, dtype=torch.float32, device=dev)
        return torch.relu(1.0 - torch.abs(src[:, None] - grid[None, :]))

    ry, rx = weights(out_h, cur_h), weights(out_w, cur_w)
    out = torch.einsum('yi,bijc,xj->byxc', ry, images, rx)
    coverage = ry.sum(dim=1)[:, None] * rx.sum(dim=1)[None, :]
    fill = images.mean(dim=(1, 2))  # [B, 3]
    return out + (1.0 - coverage)[None, :, :, None] * fill[:, None, None, :]
