"""Feature neck: plain backbone taps (NCHW).

Port of ``single_shot_detection_tpu/models/features.py::Features``; the
pyramid necks belong to a later slice.
"""

from __future__ import annotations

from typing import List, Sequence

from torch import nn


class Features(nn.Module):
    """Backbone tap selector.

    ``out_layers`` entries are stage indices or ``(stage, inner_name)`` pairs
    (e.g. ``(13, 'expand_relu')``).  ``forward(x)`` returns ``(sources, x)``:
    the tapped maps (large -> small) and the last stage's output, which feeds
    the SSD extras.
    """

    def __init__(self, base: nn.Module, out_layers: Sequence):
        super().__init__()
        self.base = base
        self.out_layers = [tuple(l) if isinstance(l, (tuple, list)) else l
                           for l in out_layers]

    @property
    def channels(self) -> List[int]:
        """Widths of ``sources``."""
        return [self.base.aux_channels[l] if isinstance(l, tuple)
                else self.base.stage_channels[l] for l in self.out_layers]

    @property
    def out_channels(self) -> int:
        """Width of the returned ``x``."""
        return self.base.stage_channels[-1]

    def forward(self, x):
        stages, aux = self.base(x)
        sources = [aux[l] if isinstance(l, tuple) else stages[l]
                   for l in self.out_layers]
        return sources, stages[-1]


NECKS = {'Features': Features}
