"""single_shot_detection_tpu_torch — the PyTorch/CUDA port of
``single_shot_detection_tpu`` for NVIDIA Hopper (H100).

The port runs the flagship serving path (``samples/ssd_mb2_voc.py``): staged
uint8 images -> preprocessing -> SSD300-MobileNetV2 forward -> postprocessing
with a hand-written CUDA NMS kernel -> ``[B, max_total, 6]`` detections and a
``valid`` mask.  It imports ``torch`` only; the JAX package beside it is the
reference the port's tests hold it against.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``; with
no GPU and no explicit CPU device they raise (see :mod:`.device`).
"""

__version__ = "0.1.0"
