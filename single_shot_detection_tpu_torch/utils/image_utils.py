"""Host-side drawing of detections.

Port of ``single_shot_detection_tpu/utils/image_utils.py``: box outlines
(and labels with scores) on a copy of an RGB image, with cv2 when it
imports and plain numpy strokes when it does not.  cv2 and PIL are imported
where they are used, never when this module is imported.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

_COLORS = [(220, 20, 60), (0, 128, 0), (0, 0, 255), (255, 165, 0),
           (128, 0, 128), (0, 255, 255), (255, 0, 255), (128, 128, 0)]


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def draw_boxes(img: np.ndarray, boxes: np.ndarray,
               class_labels=None) -> np.ndarray:
    """Colored box outlines on a copy of ``img``: one row of ``boxes`` is
    ``[x0, y0, x1, y1, class, score]`` (class and score optional); with
    cv2, ``class_labels[class]`` and the score are written above it."""
    out = np.ascontiguousarray(img).copy()
    cv2 = _cv2()
    for row in np.asarray(boxes):
        x0, y0, x1, y1 = [int(v) for v in row[:4]]
        cls = int(row[4]) if len(row) > 4 else 0
        color = _COLORS[cls % len(_COLORS)]
        if cv2 is not None:
            cv2.rectangle(out, (x0, y0), (x1, y1), color, 2)
            if class_labels and cls < len(class_labels):
                text = class_labels[cls]
                if len(row) > 5:
                    text += f' {row[5]:.2f}'
                cv2.putText(out, text, (x0, max(y0 - 4, 10)),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
        else:
            out[y0:y1 + 1, x0:x0 + 2] = color
            out[y0:y1 + 1, max(x1 - 1, 0):x1 + 1] = color
            out[y0:y0 + 2, x0:x1 + 1] = color
            out[max(y1 - 1, 0):y1 + 1, x0:x1 + 1] = color
    return out


def display(img: np.ndarray, boxes: np.ndarray, class_labels=None,
            window: str = 'detections') -> None:
    """Show the image with its boxes in a cv2 window; without cv2 or a
    display, save it as ``ssd_torch_display.png`` in the temporary
    directory."""
    out = draw_boxes(img, boxes, class_labels)
    cv2 = _cv2()
    if cv2 is not None and (os.environ.get('DISPLAY')
                            or os.environ.get('WAYLAND_DISPLAY')):
        cv2.imshow(window, cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
        cv2.waitKey(1)
        return
    from PIL import Image
    Image.fromarray(out).save(os.path.join(tempfile.gettempdir(),
                                           'ssd_torch_display.png'))
