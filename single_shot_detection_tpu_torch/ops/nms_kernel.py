"""Batched greedy NMS on the hand-written CUDA kernel (``kernels/nms.cu``).

Port of ``single_shot_detection_tpu/ops/nms_pallas.py::nms_keep_batched``.
A CUDA tensor goes to the kernel; a CPU tensor goes to the plain version
``ops/nms.py::nms_keep_sorted``.  On CUDA there is no fallback: a failed
build or launch raises.  The kernel takes K up to ``MAX_K`` candidates per
problem (its greedy sweep holds one 64-bit word per lane of a warp).

The function is the ``torch.library`` custom op
``ssd_torch::nms_keep_batched`` (:data:`OP`), with a fake implementation
for tracing, so the eager postprocessor and a ``torch.export`` program of it
run the same op, and an exported program carries the op by name.  Loading
such a program needs the op registered: import this module first.
Importing it registers the op and builds nothing (the kernel is built at
its first launch); it imports only ``torch``, ``kernels/_build.py`` and
``ops/nms.py`` (with its ``ops/boxes.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from single_shot_detection_tpu_torch.kernels import _build
from single_shot_detection_tpu_torch.ops import nms as nms_ops


# Candidates per problem the kernel takes: 32 lanes x 64 bits
MAX_K = 2048


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load('nms')
    lib.nms_keep_scratch_words.argtypes = [ctypes.c_int]
    lib.nms_keep_scratch_words.restype = ctypes.c_longlong
    lib.nms_keep_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.nms_keep_launch.restype = ctypes.c_int
    lib.nms_floor_launch.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.nms_floor_launch.restype = ctypes.c_int
    lib.nms_error_string.argtypes = [ctypes.c_int]
    lib.nms_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build and load the kernel now (otherwise it happens at first launch)."""
    _library()


def _check(boxes: torch.Tensor, scores: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f'boxes must be [N, K, 4], got {tuple(boxes.shape)}')
    if scores.shape != boxes.shape[:2]:
        raise ValueError(f'scores must be [N, K] = {tuple(boxes.shape[:2])}, '
                         f'got {tuple(scores.shape)}')
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f'boxes and scores must be float32, got '
                        f'{boxes.dtype} and {scores.dtype}')
    if boxes.device != scores.device:
        raise ValueError(f'boxes on {boxes.device}, scores on {scores.device}')
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError('boxes and scores must be contiguous')
    if boxes.data_ptr() % 16:
        raise ValueError('boxes must be 16-byte aligned (read as float4)')
    if boxes.shape[1] > MAX_K:
        raise ValueError(f'the NMS kernel takes at most {MAX_K} candidates '
                         f'per problem, got {boxes.shape[1]}')


@torch.library.custom_op('ssd_torch::nms_keep_batched', mutates_args=())
def _nms_keep_op(boxes: torch.Tensor, scores: torch.Tensor,
                 overlap_threshold: float) -> torch.Tensor:
    if boxes.device.type == 'cpu':
        return nms_ops.nms_keep_sorted(boxes, scores, overlap_threshold)
    if boxes.device.type != 'cuda':
        raise ValueError(f'no NMS kernel for device {boxes.device}')
    # the kernel reads the boxes as float4: a traced program may hand over
    # a strided view
    boxes, scores = boxes.contiguous(), scores.contiguous()
    _check(boxes, scores)
    n, k = scores.shape
    keep = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    if n == 0 or k == 0:
        return keep
    lib = _library()
    words = lib.nms_keep_scratch_words(k)
    scratch = (torch.empty(n * words, dtype=torch.int64, device=boxes.device)
               if words else None)
    err = lib.nms_keep_launch(
        boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        n, k, overlap_threshold, boxes.device.index,
        torch.cuda.current_stream(boxes.device).cuda_stream)
    if err:
        raise RuntimeError(f'NMS kernel launch failed: '
                           f'{lib.nms_error_string(err).decode()} ({err})')
    nms_keep_batched.launches += 1
    return keep


@_nms_keep_op.register_fake
def _nms_keep_fake(boxes, scores, overlap_threshold):
    return scores.new_empty(scores.shape, dtype=torch.bool)


# the registered op, as a traced or loaded program calls it
OP = torch.ops.ssd_torch.nms_keep_batched.default


def nms_keep_batched(boxes: torch.Tensor, scores: torch.Tensor,
                     overlap_threshold: float) -> torch.Tensor:
    """Exact greedy NMS over ``N`` independent problems (the custom op).

    Args:
      boxes: ``[N, K, 4]`` f32 corner boxes, **sorted by score descending**.
      scores: ``[N, K]`` f32 sorted scores; ``-inf`` marks invalid candidates.
      overlap_threshold: suppress IoU strictly greater than this.
    Returns:
      ``[N, K]`` bool keep mask.
    """
    return OP(boxes, scores, float(overlap_threshold))


# Kernel launches since the count was last set to 0.
nms_keep_batched.launches = 0


def launch_floor(n: int, k: int, device: torch.device) -> None:
    """Launch an empty kernel on the grid, block and shared memory of the
    NMS kernel for ``n`` problems of ``k`` candidates: the least time any
    launch of that shape takes."""
    lib = _library()
    err = lib.nms_floor_launch(n, k, device.index,
                               torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f'NMS floor launch failed: '
                           f'{lib.nms_error_string(err).decode()} ({err})')
