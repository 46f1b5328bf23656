"""single_shot_detection_tpu_torch — the PyTorch/CUDA port of
``single_shot_detection_tpu`` for NVIDIA Hopper (H100).

The port runs the flagship config (``samples/ssd_mb2_voc.py``):
serving (``predict.py::Predictor``: staged uint8 images -> preprocessing ->
SSD300-MobileNetV2 forward -> postprocessing with a hand-written CUDA NMS
kernel -> ``[B, max_total, 6]`` detections and a ``valid`` mask) and the
train step (``trainer.py::Trainer``: preprocessing -> target assignment ->
train-mode forward -> multibox loss -> backward -> SGD, with the train-mode
BatchNorm on four hand-written CUDA kernels under ``train.fused_bn``), and
the config's train and eval phases as users start them
(``python -m single_shot_detection_tpu_torch``, ``cli.py``; checkpoints in
``train/checkpoint.py``, which also reads the JAX package's files), and
export and deployment (``export/__init__.py``: ``torch.export`` artifacts
with the NMS kernel inside, consumed by ``tools/infer_exported.py`` and
``tools/serve.py``).  It
imports ``torch`` only; the JAX package beside it is the reference the
port's tests hold it against.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``; with
no GPU and no explicit CPU device they raise (see :mod:`.device`).
"""

__version__ = "0.1.0"
