"""SSD box encoding/decoding between centroid boxes and regression targets.

Port of ``single_shot_detection_tpu/ops/box_coder.py``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class BoxCoder:
    """Centroid-offset box coder.

    ``encode``: box (centroid) + prior (centroid) -> regression target
      ``t_xy = (b_xy - p_xy) / p_wh * xy_scale``
      ``t_wh = log(b_wh / p_wh + eps) * wh_scale``
    ``decode`` is the exact inverse (without eps).
    """

    xy_scale: float = 10.0
    wh_scale: float = 5.0
    eps: float = 1e-8

    def encode(self, boxes: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
        """boxes ``[..., A, 4]`` centroid, priors ``[A, 4]`` centroid -> ``[..., A, 4]``."""
        t_xy = (boxes[..., :2] - priors[..., :2]) / priors[..., 2:] * self.xy_scale
        t_wh = torch.log(boxes[..., 2:] / priors[..., 2:] + self.eps) * self.wh_scale
        return torch.cat([t_xy, t_wh], dim=-1)

    def decode(self, codes: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
        """codes ``[..., A, 4]``, priors ``[A, 4]`` centroid -> centroid boxes."""
        xy = priors[..., :2] + priors[..., 2:] * codes[..., :2] / self.xy_scale
        wh = priors[..., 2:] * torch.exp(codes[..., 2:] / self.wh_scale)
        return torch.cat([xy, wh], dim=-1)
