"""Preprocessing: staged uint8 NHWC images -> normalized float32 NCHW model
input, on the device.

Port of the JAX package's serving path: ``data/loader.py::stage_image``
(resize to the input size) followed by the eval ``data/transforms.py::
Pipeline`` (``ToFloatTensor``/``Normalize``/``Resize``).  At eval the
pipeline's ``sample_view`` resample is the identity when the staged size
equals the output size, so once an image is staged only the normalization
remains.  The train side, with its augmentation and resample, is
``data/transforms.py::Pipeline``, which normalizes through
:meth:`Preprocess.normalize`.

Resize: ``stage_image`` uses cv2's ``INTER_LINEAR`` on uint8 on the host.
Here the same fixed-point arithmetic runs in int32 tensor ops
(:func:`stage_images`), on the device for serving and on CPU tensors in the
data loader, so the staged pixels are equal to cv2's, bit for bit, without
importing cv2.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


# cv2's fixed-point INTER_LINEAR: 11-bit weights (INTER_RESIZE_COEF_BITS)
_COEF_SCALE = 2048


def _linear_taps(dst: int, src: int, clamp_weight: bool, device):
    """cv2's ``INTER_LINEAR`` taps along one axis: source indices ``(i0, i1)``
    and 11-bit weights ``(w0, w1)`` for each of ``dst`` outputs.

    As ``cv::resize`` computes them: ``scale = 1 / (dst / src)`` in double,
    ``f = float((d + 0.5) * scale - 0.5)``, ``s = floor(f)``, ``f -= s`` in
    float, weights ``rint((1 - f) * 2048)`` and ``rint(f * 2048)``.  Along x
    (``clamp_weight``) a tap outside the image moves to the edge with
    ``f = 0``; along y only the row index is clipped and ``f`` is kept.
    """
    scale = 1.0 / (dst / src)
    f = ((torch.arange(dst, dtype=torch.float64) + 0.5) * scale - 0.5).float()
    s = torch.floor(f)
    f = f - s
    s = s.long()
    if clamp_weight:
        edge = (s < 0) | (s >= src - 1)
        f = torch.where(edge, torch.zeros_like(f), f)
        s = torch.where(s < 0, 0, torch.where(s >= src - 1, src - 1, s))
    w0 = torch.round((1.0 - f) * _COEF_SCALE).int()   # half to even, as rint
    w1 = torch.round(f * _COEF_SCALE).int()
    i0 = s.clamp(0, src - 1)
    i1 = (s + 1).clamp(0, src - 1)
    return [t.to(device) for t in (i0, i1, w0, w1)]


def stage_images(images: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize uint8 ``[B, H, W, 3]`` to ``size=(w, h)`` exactly as
    ``cv2.resize(..., interpolation=cv2.INTER_LINEAR)`` does for uint8;
    returns uint8 ``[B, h, w, 3]`` (the input itself when already that size).

    cv2's arithmetic in int32 on the images' device: rows
    ``r = p0 * w0 + p1 * w1``, then
    ``(((v0 * (r0 >> 4)) >> 16) + ((v1 * (r1 >> 4)) >> 16) + 2) >> 2``.
    Products stay below 2**31: ``r >> 4 <= 32640`` times a weight <= 2048.
    cv2 takes its ``INTER_AREA`` path for an exact 2x downscale; with all
    weights 1024 this arithmetic reduces to the same ``(sum of 4 + 2) >> 2``.
    """
    new_w, new_h = size
    cur_h, cur_w = images.shape[1:3]
    if (cur_h, cur_w) == (new_h, new_w):
        return images
    if images.dtype != torch.uint8:
        raise TypeError(f'stage_images resizes uint8 images, got {images.dtype}')
    x = images.int()
    x0, x1, a0, a1 = _linear_taps(new_w, cur_w, True, images.device)
    y0, y1, b0, b1 = _linear_taps(new_h, cur_h, False, images.device)

    def rows(idx):  # horizontal pass over the source rows ``idx``, >> 4
        r = x[:, idx]
        r = r[:, :, x0] * a0[:, None] + r[:, :, x1] * a1[:, None]
        return r >> 4

    b0, b1 = b0[:, None, None], b1[:, None, None]
    out = (((b0 * rows(y0)) >> 16) + ((b1 * rows(y1)) >> 16) + 2) >> 2
    return out.to(torch.uint8)


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
        return self.normalize(stage_images(images, self.input_size).float())

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """float ``[B, h, w, 3]`` -> normalized ``[B, 3, h, w]``."""
        x = x / self.divisor
        if self.mean is not None:
            mean = torch.tensor(self.mean, dtype=torch.float32, device=x.device)
            std = torch.tensor(self.std, dtype=torch.float32, device=x.device)
            x = (x - mean) / std
        return x.permute(0, 3, 1, 2).contiguous()
