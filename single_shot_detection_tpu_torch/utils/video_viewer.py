"""The test phase: the detector over a video file or an image folder.

Port of ``single_shot_detection_tpu/utils/video_viewer.py``: each frame
goes through ``Experiment.predict`` and ``image_utils.draw_boxes``, then to
a cv2 window (``q`` quits) or, without a display, to a PNG per frame.  An
image folder is read with PIL (``*.jpg``, ``*.jpeg``, ``*.png``, sorted,
subfolders too), a video file with cv2; both are imported where they are
used.
"""

from __future__ import annotations

import glob
import logging
import os
import tempfile
from typing import Iterator, Optional

import numpy as np

from single_shot_detection_tpu_torch.utils.image_utils import _cv2, draw_boxes


class VideoViewer:
    """``run()`` shows or saves each frame of ``path`` with its detections.
    Headless, the frames go to ``out_dir`` (default ``ssd_torch_frames`` in
    the temporary directory) as ``00000.png``, ``00001.png``, ..."""

    def __init__(self, path: Optional[str], experiment,
                 out_dir: Optional[str] = None):
        self.path = path
        self.experiment = experiment
        self.out_dir = out_dir or os.path.join(tempfile.gettempdir(),
                                               'ssd_torch_frames')

    def _frames(self) -> Iterator[np.ndarray]:
        """RGB uint8 frames of the folder or the video."""
        cv2 = _cv2()
        if self.path and os.path.isdir(self.path):
            from PIL import Image
            patterns = ('*.jpg', '*.jpeg', '*.png')
            files = sorted(f for p in patterns for f in glob.glob(
                os.path.join(self.path, '**', p), recursive=True))
            for f in files:
                with Image.open(f) as im:
                    # writable, as cv2's frames are (torch warns on a
                    # read-only array)
                    yield np.array(im.convert('RGB'))
        elif self.path and cv2 is not None:
            cap = cv2.VideoCapture(self.path)
            try:
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            finally:
                cap.release()
        else:
            logging.error(f'XX cannot open {self.path}')

    def run(self) -> int:
        """Returns the number of frames shown or saved."""
        cv2 = _cv2()
        # cv2.imshow aborts the process without a display: never try it
        # headless
        interactive = cv2 is not None and bool(
            os.environ.get('DISPLAY') or os.environ.get('WAYLAND_DISPLAY'))
        labels = None
        datasets = getattr(self.experiment, 'datasets', None) or {}
        ds = datasets.get('eval') or datasets.get('train')
        if ds is not None:
            labels = ds.class_labels
        count = 0
        for i, frame in enumerate(self._frames()):
            out = draw_boxes(frame, self.experiment.predict(frame), labels)
            count += 1
            if interactive:
                cv2.imshow('detections', cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
                if cv2.waitKey(1) & 0xFF in (ord('q'), ord('Q')):
                    break
            else:
                from PIL import Image
                os.makedirs(self.out_dir, exist_ok=True)
                Image.fromarray(out).save(os.path.join(self.out_dir,
                                                       f'{i:05d}.png'))
        return count
