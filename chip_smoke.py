#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``single_shot_detection_tpu_torch``).

    python3 chip_smoke.py [--parent-nms OTHER/kernels/nms.cu]

Needs one CUDA card; exits non-zero without one.  ``--parent-nms`` builds
another version of the NMS kernel (say, from a ``git archive`` of an
earlier commit), calls its ``nms_keep_launch`` directly, and times it
beside this one in phase 5, in turns.  Phases, each fatal:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build: every CUDA kernel (``nms.cu``, ``bn.cu``) from the sources in
   this checkout, one ``nvcc`` per source, started together;
3. kernels against their plain PyTorch versions on the card: exact keep
   masks for NMS (including invalid
   rows, identical boxes, IoU exactly at the threshold and within 3 float
   steps of it, nothing suppressed, ``-inf`` scores in the middle, NaN and
   infinite coordinates, overflowing, tiny and zero areas, K = 1, 63, 64,
   65, 1500 and 2048); the four train-mode BatchNorm kernels K1-K4 on the
   flagship's shapes at b32 from ``[32, 96, 150, 150]`` to
   ``[32, 128, 1, 1]``, a ragged ``[3, 24, 75, 75]`` and a bf16 case, at
   the tolerances stated at ``BN_TOL``;
4. the serving path: ``Predictor`` on ``samples/ssd_mb2_voc.py`` at full
   width with seeded random weights, answering 3 batches of 32 and 4 single
   requests, with launch counts read around that run; outputs checked for
   shape and finiteness, the forward against the CPU, and the kernel
   postprocessor against the plain one;
5. serving times: ``predict_batch`` img/s at b32 and b128, postprocess ms,
   the NMS kernel's device time per launch at the b32 and b128 paths'
   inputs and at a synthetic sparse case (valid prefixes of 0-20 of 100),
   each beside the launch floor (an empty kernel on the same grid), its
   plain version, its bound
   and the valid-prefix lengths; and a profiler table of device time by
   operator at b32;
6. the training path: ``Trainer`` on the flagship at full width (b32,
   300x300) with ``train.fused_bn`` and no augmentation, seeded random
   weights, 5 steps on seeded images and synthetic ground truth, with the
   BN kernels' launch counts read around them (each must equal the number
   of train-mode BNs x 5); losses checked finite, and one step from the
   same state with PyTorch's batch norm (``fused_bn`` off) checked against
   the kernels' step (loss within 1e-4 relative, running statistics within
   1e-4);
7. training times: the b32 train step with the BN kernels and with
   PyTorch's batch norm in turns, each BN kernel's device time per launch
   at ``[32, 96, 150, 150]`` beside its bound, its plain version and the
   PyTorch pair that computes the same function (``native_batch_norm`` for
   K1+K2, its backward for K3+K4), each kernel's device time summed over a
   step beside the step's bound, a profiler table of one train step, and
   the PyTorch pairs' device time summed over the step's 64 BN shapes
   beside the kernel pairs' time per step;
8. the flagship as shipped: ``Experiment`` on ``samples/ssd_mb2_voc.py``
   with its augmentation chain, ``train.fused_bn``, seeded random weights
   and the synthetic data of ``FLAGSHIP_DATA`` (500 px images, so the
   loader stages a real resize to 300x300), one epoch of 8 b32 augmented
   steps and an evaluation of 2 b64 batches, with the kernels' launch counts
   read around that run (each BN kernel 64 x 8, the NMS kernel 2); losses
   and mAP checked finite (mAP in [0, 1]), one augmentation draw applied to
   the same b32 batch on the card and on the CPU (masks and boxes equal,
   pixels within ``AUG_PIXEL_TOL``), and the eval postprocessor with the
   kernel against the plain one (valid masks equal);
9. the slice's times: train epoch img/s with augmentation, eval img/s, the
   train loader alone (staging on the card and on the CPU) and an epoch
   with CPU staging, the augmentation ``Pipeline``'s device and host ms per
   b32 batch and its share of the augmented step, and a profiler table of
   one augmented train step.

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as its
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import copy
import csv
import ctypes
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from single_shot_detection_tpu_torch import cli
from single_shot_detection_tpu_torch.kernels import _build
from single_shot_detection_tpu_torch.models.layers import BatchNorm
from single_shot_detection_tpu_torch.ops import bn_kernel
from single_shot_detection_tpu_torch.ops import nms as nms_ops
from single_shot_detection_tpu_torch.ops import nms_kernel
from single_shot_detection_tpu_torch.data import transforms
from single_shot_detection_tpu_torch.predict import Predictor
from single_shot_detection_tpu_torch.train import checkpoint as ckpt
from single_shot_detection_tpu_torch.train.engine import Experiment
from single_shot_detection_tpu_torch.train.step import make_train_step
from single_shot_detection_tpu_torch.trainer import Trainer

FLAGSHIP = 'samples/ssd_mb2_voc.py'
SEED = 23
REPO = Path(__file__).resolve().parent

# HBM rate by card name (bytes/s), NVIDIA data sheets; H100 SXM otherwise.
HBM_RATE = [('H100 PCIe', 2.0e12), ('H100 NVL', 3.9e12), ('H200', 4.8e12),
            ('H100', 3.35e12)]
FP32_RATE = 67e12  # H100 SXM fp32 outside the tensor cores, dense

# fp32 operations per box pair in the NMS IoU test: 4 min/max, 2 sub,
# 2 clamp, 1 mul (intersection), 1 add + 1 sub (union), 1 div, 1 compare
NMS_OPS_PER_PAIR = 13
# Launches a profiled window of kernels_device_ms may miss, and the windows
# profile_counted takes before it fails
PROFILER_MISSED_LAUNCHES = 2
PROFILER_TRIES = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f'FAIL: {msg}')


def hbm_rate(name: str) -> float:
    for key, rate in HBM_RATE:
        if key in name:
            return rate
    return 3.35e12


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device ms per call of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_window(run):
    """The profiler's trace of one call of ``run`` (which ends in a device
    synchronize), taken after another call of it in the profiler's own
    warm-up step: a trace that starts cold has missed launches, once all of
    a window's."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            run()
            prof.step()
    return prof


def profile_counted(run, kernel_names, expected: int, missed: int = 0):
    """``profile_window(run)`` whose trace holds from ``expected - missed``
    to ``expected`` launches of each kernel in ``kernel_names``.  A window
    outside that range is printed and profiled again, ``PROFILER_TRIES``
    windows at most; a count short of ``expected`` is printed."""
    for _ in range(PROFILER_TRIES):
        prof = profile_window(run)
        counts = {name: device_us(prof, name)[1] for name in kernel_names}
        if all(expected - missed <= c <= expected for c in counts.values()):
            if any(c != expected for c in counts.values()):
                log(f'  profiler saw {counts} of {expected} launches')
            return prof
        log(f'  profiler saw {counts} of {expected} launches; profiling again')
    fail(f'profiler saw {counts} launches, expected {expected} of each')


def kernels_device_ms(fn, kernel_names, iters: int) -> float:
    """Device time per call of ``fn``, summed over the CUDA kernels it
    launches (``kernel_names``, each once per call), from the profiler's
    CUPTI trace (events around back-to-back launches would time the host's
    enqueue instead when the host is the slower of the two).  Each kernel's
    time is averaged over the launches the trace holds, which may fall
    short of ``iters`` by ``PROFILER_MISSED_LAUNCHES``."""
    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    prof = profile_counted(run, kernel_names, iters, PROFILER_MISSED_LAUNCHES)
    return sum(us / count for us, count in
               (device_us(prof, name) for name in kernel_names)) / 1e3


def device_us(prof, kernel_name: str):
    """(summed device µs, launches) of the kernels whose name contains
    ``kernel_name`` in a finished profile."""
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel_name in evt.key:
            us = getattr(evt, 'self_device_time_total', None)
            total_us += evt.self_cuda_time_total if us is None else us
            count += evt.count
    return total_us, count


def busy_us(prof) -> float:
    """Device µs summed over every kernel, copy and fill in a finished
    profile, as its table's "Self CUDA time total" (the window's
    ``ProfilerStep`` annotation spans the step on the device and is left
    out)."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False))


def host_times_ms(fn, iters: int, warmup: int = 3):
    """Host-clock ms of each of ``iters`` calls of ``fn``, each ending in a
    device synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


# ---------------------------------------------------------------- phase 3

def nms_problems(rng: np.random.RandomState, n: int, k: int, thr: float):
    """Random score-sorted problems, with special rows: an invalid tail
    (``-inf`` scores, zero boxes), a fully invalid row, identical boxes, and
    pairs at IoU exactly equal to ``thr`` (0.45 or 0.5)."""
    xy = rng.rand(n, k, 2).astype(np.float32) * 100
    wh = rng.rand(n, k, 2).astype(np.float32) * 40 + 1
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    scores = -np.sort(-rng.rand(n, k).astype(np.float32), axis=1)
    special = {}
    if n >= 4:
        boxes[0, k // 2:] = 0.0
        scores[0, k // 2:] = -np.inf
        boxes[1] = 0.0
        scores[1] = -np.inf
        boxes[2] = [10, 10, 50, 50]
        # big box first, the small one inside it: inter/union == thr
        big, small = {0.45: ([0, 0, 4, 5], [0, 0, 3, 3]),
                      0.5: ([0, 0, 1, 2], [0, 0, 1, 1])}[thr]
        for j in range(k):
            off = 10.0 * (j // 2)
            b = big if j % 2 == 0 else small
            boxes[3, j] = [b[0] + off, b[1], b[2] + off, b[3]]
        special = {'tail': 0, 'invalid': 1, 'identical': 2, 'at_threshold': 3}
    return boxes, scores, special


def nms_ulp_pairs(thr: float):
    """Two-box problems whose IoU lies within a few float steps of ``thr``:
    a box and one inside it at IoU exactly ``thr`` (scaled and shifted),
    with one coordinate of either box nudged by -3..3 float steps.  Returns
    boxes ``[N, 2, 4]``, scores ``[N, 2]`` and each pair's IoU minus ``thr``
    in float steps (the reference's arithmetic in numpy float32)."""
    big, small = {0.45: ([0, 0, 4, 5], [0, 0, 3, 3]),
                  0.5: ([0, 0, 1, 2], [0, 0, 1, 1])}[thr]
    pairs = []
    for scale in (1.0, 1.5, 7.25, 0.3, 33.0):
        for off in (0.0, 17.0):
            base = np.array([big, small], np.float64) * scale + off
            for box in range(2):
                for coord in range(4):
                    for steps in range(-3, 4):
                        pair = base.astype(np.float32)
                        toward = np.float32(np.inf if steps > 0 else -np.inf)
                        for _ in range(abs(steps)):
                            pair[box, coord] = np.nextafter(pair[box, coord],
                                                            toward)
                        pairs.append(pair)
    boxes = np.stack(pairs)
    a, b = boxes[:, 0], boxes[:, 1]
    zero = np.float32(0)
    inter = (np.maximum(np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0]), zero)
             * np.maximum(np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1]), zero))
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iou = inter / (area_a + area_b - inter)
    steps = (iou.view(np.int32).astype(np.int64)
             - np.float32(thr).view(np.int32))
    scores = np.tile(np.array([[0.9, 0.8]], np.float32), (len(boxes), 1))
    return boxes, scores, steps


def nms_disjoint(rng: np.random.RandomState, n: int, k: int):
    """Problems in which no two boxes overlap, so nothing is suppressed and
    the greedy sweep keeps every candidate (its longest chain)."""
    i = np.arange(k)
    x, y = (i % 64) * 10.0, (i // 64) * 10.0
    one = np.stack([x, y, x + 5, y + 5], axis=-1).astype(np.float32)
    scores = -np.sort(-rng.rand(n, k).astype(np.float32), axis=1)
    return np.tile(one, (n, 1, 1)), scores


def nms_ieee_corners(rng: np.random.RandomState, n: int = 60, k: int = 40):
    """Random problems whose rows each hold one kind of awkward box: NaN or
    infinite coordinates, areas that overflow (1e30 px), underflow
    (1e-25 px) or exceed the division-free test's range (1e15 px), and
    zero-area boxes."""
    boxes, scores, _ = nms_problems(rng, n, k, 0.45)
    for p in range(n):
        pick = rng.rand(k) < 0.4
        kind = p % 6
        if kind == 0:
            boxes[p, pick, rng.randint(0, 4)] = np.nan
        elif kind == 1:
            boxes[p, pick, 2] = np.inf
        elif kind in (2, 3, 4):
            boxes[p, pick] *= {2: 1e28, 3: 1e-27, 4: 1e13}[kind]
        else:
            boxes[p, pick, 2] = boxes[p, pick, 0]
    return boxes, scores


def check_nms_kernel(device: torch.device) -> dict:
    """The kernel against the plain version, exactly, on random and special
    problems."""
    rng = np.random.RandomState(SEED)
    cases = []  # (name, boxes, scores, thr, special)
    for name, n, k, thr in [('flagship b32', 32 * 20, 100, 0.45),
                            ('synthetic_smoke', 8 * 4, 20, 0.45),
                            ('K=128', 96, 128, 0.45),
                            ('K=200', 64, 200, 0.5),
                            ('ragged N', 333, 100, 0.45),
                            ('K=1500 scratch path', 5, 1500, 0.45),
                            ('K=1', 8, 1, 0.45), ('K=63', 40, 63, 0.45),
                            ('K=64', 40, 64, 0.45), ('K=65', 40, 65, 0.5),
                            ('K=2048 scratch path', 4, 2048, 0.45)]:
        boxes, scores, special = nms_problems(rng, n, k, thr)
        cases.append((name, boxes, scores, thr, special))
    ulp_steps = {}
    for thr in (0.45, 0.5):
        boxes, scores, steps = nms_ulp_pairs(thr)
        ulp_steps[thr] = steps
        cases.append((f'IoU within 3 float steps of {thr}', boxes, scores,
                      thr, {}))
    for name, n, k in [('nothing suppressed', 640, 100),
                       ('nothing suppressed K=2048', 2, 2048)]:
        cases.append((name, *nms_disjoint(rng, n, k), 0.45, {}))
    for thr in (0.45, 0.0):
        cases.append((f'IEEE corners thr={thr}', *nms_ieee_corners(rng), thr, {}))
    boxes, scores, _ = nms_problems(rng, 64, 100, 0.45)
    middle = rng.rand(64, 100) < 0.2
    middle[:, -1] = False  # the last candidate stays valid
    scores[middle] = -np.inf
    cases.append(('-inf in the middle', boxes, scores, 0.45, {}))

    for thr, steps in ulp_steps.items():
        near = {d: int((steps == d).sum()) for d in range(-3, 4)}
        if not all(near.values()):
            fail(f'the threshold pairs miss a float step of {thr}: {near}')
        log(f'  nms pairs by IoU - {thr} in float steps: {near}')
    worst = 0
    for name, boxes_np, scores_np, thr, special in cases:
        n, k = scores_np.shape
        boxes = torch.from_numpy(boxes_np).to(device)
        scores = torch.from_numpy(scores_np).to(device)
        want = nms_ops.nms_keep_sorted(boxes, scores, thr)
        got = nms_kernel.nms_keep_batched(boxes, scores, thr)
        torch.cuda.synchronize()
        worst = max(worst, (got.int() - want.int()).abs().max().item())
        if not torch.equal(got, want):
            bad = (got != want).any(dim=1).nonzero().flatten().tolist()
            fail(f'NMS kernel != plain on {name}: problems {bad[:10]}')
        if special:
            if got[special['tail'], k // 2:].any() or got[special['invalid']].any():
                fail(f'{name}: an invalid candidate was kept')
            if got[special['identical']].sum().item() != 1:
                fail(f'{name}: identical boxes kept {got[2].sum().item()}')
            if not got[special['at_threshold']].all():
                fail(f'{name}: IoU equal to the threshold suppressed')
        if name.startswith('nothing suppressed') and not got.all():
            fail(f'{name}: a disjoint box was suppressed')
        log(f'  nms {name}: N={n} K={k} thr={thr} exact '
            f'({int(got.sum())} kept)')
    return {'max_abs_err': float(worst)}


BN_CASES = [  # (name, shape, dtype): the flagship's range at b32, ragged, bf16
    ('stage2 expand_bn', (32, 96, 150, 150), torch.float32),
    ('stage13 expand_bn', (32, 576, 19, 19), torch.float32),
    ('stage18 bn', (32, 1280, 10, 10), torch.float32),
    ('extra3 tail', (32, 128, 1, 1), torch.float32),
    ('ragged', (3, 24, 75, 75), torch.float32),
    ('bf16', (8, 96, 75, 75), torch.bfloat16),
]
BN_TIMED_SHAPE = (32, 96, 150, 150)
BN_EPS = 1e-5
# Tolerances of the BN kernels against their plain versions on the same
# inputs, as a fraction of max(1, |largest reference value|): reductions
# (K1, K3) sum up to 720,000 f32 values in another order; elementwise passes
# (K2, K4) round each operation as the plain version does, so they differ
# only where a bf16 output rounds (one bf16 step, 2**-8).
BN_TOL = {'reduce': 1e-4, 'elementwise': 1e-5, 'elementwise_bf16': 2.0 ** -8}
# CUDA kernels behind each wrapper (the reductions launch a partial pass and
# a combine pass) and the bytes each wrapper must move per element of x in
# f32: x read once (K1), x read and z written (K2), dz and x read (K3), dz
# and x read and dx written (K4).
BN_KERNELS = {
    'bn_stats': (('bn_stats_partial_kernel', 'bn_stats_combine_kernel'), 4,
                 'single_shot_detection_tpu/ops/bn_pallas.py:78'),
    'bn_apply': (('bn_apply_kernel',), 8,
                 'single_shot_detection_tpu/ops/bn_pallas.py:94'),
    'bn_grad_sums': (('bn_grad_sums_partial_kernel',
                      'bn_grad_sums_combine_kernel'), 8,
                     'single_shot_detection_tpu/ops/bn_pallas.py:101'),
    'bn_dx': (('bn_dx_kernel',), 12,
               'single_shot_detection_tpu/ops/bn_pallas.py:118'),
}
# f32 operations per element: K1 add, mul, add; K2 sub, mul, mul, add;
# K3 add, sub, mul, mul, add; K4 sub, mul, sub, mul, sub, mul
BN_OPS_PER_ELEMENT = {'bn_stats': 3, 'bn_apply': 4, 'bn_grad_sums': 5,
                      'bn_dx': 6}


def bn_inputs(shape, dtype, generator):
    c = shape[1]
    x = (torch.randn(shape, generator=generator) * 2 + 0.3).cuda().to(dtype)
    dz = torch.randn(shape, generator=generator).cuda().to(dtype)
    scale = (torch.rand(c, generator=generator) + 0.5).cuda()
    bias = (torch.randn(c, generator=generator) * 0.1).cuda()
    return x, dz, scale, bias


def bn_err(got, want, kind: str) -> float:
    """Max abs error; fails beyond ``BN_TOL[kind]`` of max(1, max|want|)."""
    err = (got.float() - want.float()).abs().max().item()
    tol = BN_TOL[kind] * max(1.0, want.float().abs().max().item())
    if not err <= tol:  # NaN fails too
        fail(f'BN kernel differs from its plain version: {err} > {tol} ({kind})')
    return err


def check_bn_kernels() -> dict:
    """K1-K4 against their plain versions on the same inputs; K2 and K4 are
    given the plain K1 and K3 outputs, so each check isolates one kernel."""
    gen = torch.Generator().manual_seed(SEED + 2)
    worst = {name: 0.0 for name in BN_KERNELS}
    for name, shape, dtype in BN_CASES:
        x, dz, scale, bias = bn_inputs(shape, dtype, gen)
        elementwise = ('elementwise_bf16' if dtype == torch.bfloat16
                       else 'elementwise')
        got = bn_kernel.bn_stats(x, BN_EPS)
        want = bn_kernel.bn_stats_plain(x, BN_EPS)
        torch.cuda.synchronize()
        worst['bn_stats'] = max(worst['bn_stats'], *(
            bn_err(g, w, 'reduce') for g, w in zip(got, want)))
        mean, _, rstd = want
        worst['bn_apply'] = max(worst['bn_apply'], bn_err(
            bn_kernel.bn_apply(x, mean, rstd, scale, bias),
            bn_kernel.bn_apply_plain(x, mean, rstd, scale, bias, dtype),
            elementwise))
        got = bn_kernel.bn_grad_sums(dz, x, mean, rstd, scale)
        want = bn_kernel.bn_grad_sums_plain(dz, x, mean, rstd, scale)
        worst['bn_grad_sums'] = max(worst['bn_grad_sums'], *(
            bn_err(g, w, 'reduce') for g, w in zip(got, want)))
        coef = want[2]
        worst['bn_dx'] = max(worst['bn_dx'], bn_err(
            bn_kernel.bn_dx(dz, x, mean, rstd, coef),
            bn_kernel.bn_dx_plain(dz, x, mean, rstd, coef), elementwise))
        torch.cuda.synchronize()
        log(f'  bn {name}: {list(shape)} {str(dtype)[6:]} within tolerance')
        del x, dz
    log('  bn max abs err: ' + ', '.join(f'{k} {v:.3g}' for k, v in worst.items()))
    return worst


def bn_bound_ms(name: str, elements: int, channels: int, card: str) -> Tuple[float, str]:
    """Least time for one launch of BN kernel ``name`` on ``elements`` f32
    values in ``channels`` channels, and what bounds it."""
    per_channel_bytes = {'bn_stats': 12, 'bn_apply': 16, 'bn_grad_sums': 32,
                         'bn_dx': 20}[name]
    nbytes = BN_KERNELS[name][1] * elements + per_channel_bytes * channels
    bytes_ms = nbytes / hbm_rate(card) * 1e3
    ops_ms = BN_OPS_PER_ELEMENT[name] * elements / FP32_RATE * 1e3
    return max(bytes_ms, ops_ms), 'bytes' if bytes_ms >= ops_ms else 'operations'


def time_bn_kernels(card: str) -> dict:
    """Each BN kernel at ``BN_TIMED_SHAPE`` (f32): device time per launch,
    the plain version's time, the bound, and the PyTorch pair that computes
    the same function (``torch.native_batch_norm`` and its backward)."""
    x, dz, scale, bias = bn_inputs(BN_TIMED_SHAPE, torch.float32,
                                   torch.Generator().manual_seed(SEED + 3))
    mean, _, rstd = bn_kernel.bn_stats(x, BN_EPS)
    _, _, coef = bn_kernel.bn_grad_sums(dz, x, mean, rstd, scale)
    calls = {
        'bn_stats': (lambda: bn_kernel.bn_stats(x, BN_EPS),
                     lambda: bn_kernel.bn_stats_plain(x, BN_EPS)),
        'bn_apply': (lambda: bn_kernel.bn_apply(x, mean, rstd, scale, bias),
                     lambda: bn_kernel.bn_apply_plain(x, mean, rstd, scale,
                                                      bias, torch.float32)),
        'bn_grad_sums': (lambda: bn_kernel.bn_grad_sums(dz, x, mean, rstd, scale),
                         lambda: bn_kernel.bn_grad_sums_plain(dz, x, mean, rstd,
                                                              scale)),
        'bn_dx': (lambda: bn_kernel.bn_dx(dz, x, mean, rstd, coef),
                  lambda: bn_kernel.bn_dx_plain(dz, x, mean, rstd, coef)),
    }
    elements, channels = x.numel(), x.shape[1]
    out = {}
    for name, (kernel, plain) in calls.items():
        bound, bound_by = bn_bound_ms(name, elements, channels, card)
        out[name] = {'ms': kernels_device_ms(kernel, BN_KERNELS[name][0], 20),
                     'plain_ms': cuda_ms(plain, iters=5),
                     'bound_ms': bound, 'bound_by': bound_by}
    # the library pairs: native batch norm forward (K1 + K2) and backward
    # (K3 + K4), timed once per pair
    fwd = lambda: torch.native_batch_norm(x, scale, bias, None, None, True,  # noqa: E731
                                          0.0, BN_EPS)
    _, save_mean, save_invstd = fwd()
    bwd = lambda: torch.ops.aten.native_batch_norm_backward(  # noqa: E731
        dz, x, scale, None, None, save_mean, save_invstd, True, BN_EPS,
        [True, True, True])
    pairs = {'K1+K2': cuda_ms(fwd, iters=20), 'K3+K4': cuda_ms(bwd, iters=20)}
    for name, pair in (('bn_stats', 'K1+K2'), ('bn_apply', 'K1+K2'),
                       ('bn_grad_sums', 'K3+K4'), ('bn_dx', 'K3+K4')):
        out[name].update(library_ms=pairs[pair], library_pair=pair)
    return out


# ---------------------------------------------------------------- phase 4

def perturb_bn(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Non-trivial BatchNorm running statistics and affine parameters."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=generator) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=generator) + 0.5)
                m.weight.copy_(1 + torch.randn(c, generator=generator) * 0.1)
                m.bias.copy_(torch.randn(c, generator=generator) * 0.1)


def build_predictor(device: torch.device) -> Predictor:
    pred = Predictor.from_config(FLAGSHIP, device=device, seed=SEED)
    perturb_bn(pred.model, torch.Generator().manual_seed(SEED + 1))
    return pred


def run_main_path(pred: Predictor, batches, singles):
    outs = [pred.predict_batch(b) for b in batches]
    answers = [pred.predict(img) for img in singles]
    torch.cuda.synchronize()
    return outs, answers


def check_main_path(pred, outs, answers, singles) -> None:
    max_total = pred.postprocessor.max_total
    for dets, valid in outs:
        if tuple(dets.shape) != (32, max_total, 6) or tuple(valid.shape) != (32, max_total):
            fail(f'predict_batch shapes {tuple(dets.shape)} {tuple(valid.shape)}')
        if not torch.isfinite(dets).all():
            fail('non-finite detections')
        if not valid.any(dim=1).all():
            fail('an image got no valid detection')
    for img, ans in zip(singles, answers):
        h, w = img.shape[:2]
        if (ans.ndim != 2 or ans.shape[1] != 6 or not 0 < len(ans) <= max_total
                or not np.isfinite(ans).all()):
            fail(f'predict({h}x{w}) gave {ans.shape}')
        if ans[:, [0, 2]].min() < -w or ans[:, [0, 2]].max() > 2 * w:
            fail(f'predict({h}x{w}) boxes not rescaled to the source')


def check_against_cpu_and_plain(pred: Predictor, images: np.ndarray) -> dict:
    """Forward on the card vs the CPU; kernel postprocessor vs plain."""
    x = pred.preprocess(torch.from_numpy(images).to(pred.device))
    cpu_model = copy.deepcopy(pred.model).cpu()
    with torch.inference_mode():
        scores, locs = pred.model(x)
        s_cpu, l_cpu = cpu_model(x[:2].cpu())
    fwd_err = max((scores[:2].cpu() - s_cpu).abs().max().item(),
                  (locs[:2].cpu() - l_cpu).abs().max().item())
    if fwd_err > 1e-3:
        fail(f'forward on the card differs from the CPU by {fwd_err}')
    plain = copy.copy(pred.postprocessor)
    plain.nms_keep = lambda boxes, scores: nms_ops.nms_keep_sorted(
        boxes, scores, plain.overlap_threshold)
    d_k, v_k = pred.postprocessor(scores, locs, pred.anchors)
    d_p, v_p = plain(scores, locs, pred.anchors)
    if not torch.equal(v_k, v_p) or not torch.equal(d_k[v_k], d_p[v_p]):
        fail('kernel postprocessor differs from the plain postprocessor')
    log(f'  forward card vs CPU max abs err {fwd_err:.3g} (tol 1e-3); '
        f'kernel postprocess == plain postprocess')
    return {'scores': scores, 'locs': locs, 'forward_vs_cpu': fwd_err}


# ---------------------------------------------------------------- phase 5

def time_slice(pred: Predictor, heads: dict, rng) -> dict:
    out = {}
    for bs in (32, 128):
        imgs = rng.randint(0, 256, (bs, 300, 300, 3), dtype=np.uint8)
        times = host_times_ms(lambda: pred.predict_batch(imgs), iters=20)
        ms = statistics.median(times)
        out[f'predict_batch_b{bs}_ms'] = ms
        out[f'predict_batch_b{bs}_img_per_s'] = bs * 1e3 / ms
        out[f'predict_batch_b{bs}_min_ms'] = min(times)
        out[f'predict_batch_b{bs}_max_ms'] = max(times)
    out['postprocess_b32_ms'] = cuda_ms(
        lambda: pred.postprocessor(heads['scores'], heads['locs'],
                                   pred.anchors), iters=50)
    with torch.inference_mode():
        x = pred.preprocess(torch.from_numpy(
            rng.randint(0, 256, (32, 300, 300, 3), dtype=np.uint8)).cuda())
        out['forward_b32_ms'] = cuda_ms(lambda: pred.model(x), iters=20)
    return out


def nms_inputs(pred: Predictor, images: np.ndarray):
    """The NMS kernel's inputs (boxes ``[N, K, 4]``, scores ``[N, K]``) on
    the serving path for ``images``."""
    captured = {}
    original = pred.postprocessor.nms_keep

    def capture(boxes, scores):
        captured.update(boxes=boxes.clone(), scores=scores.clone())
        return original(boxes, scores)

    pred.postprocessor.nms_keep = capture
    try:
        pred.predict_batch(images)
    finally:
        del pred.postprocessor.nms_keep
    return captured['boxes'], captured['scores']


def valid_prefix(scores: torch.Tensor) -> torch.Tensor:
    """Per problem, 1 + the index of the last candidate with a score above
    -inf: the candidates the kernel works on."""
    idx = torch.arange(scores.shape[1], device=scores.device)
    return torch.where(scores > float('-inf'), idx, -1).max(dim=1).values + 1


def nms_bound(scores: torch.Tensor, card: str) -> dict:
    """Least time for these inputs: scores read, the valid prefix's boxes
    read, the keep mask written; ``NMS_OPS_PER_PAIR`` per pair of the
    prefixes."""
    n_valid = valid_prefix(scores).double()
    pairs = (n_valid * (n_valid - 1) / 2).sum().item()
    nbytes = scores.numel() * 5 + n_valid.sum().item() * 16
    bytes_ms = nbytes / hbm_rate(card) * 1e3
    ops_ms = NMS_OPS_PER_PAIR * pairs / FP32_RATE * 1e3
    return {'bound_ms': max(bytes_ms, ops_ms),
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
            'bytes': nbytes, 'pairs': pairs,
            'n_valid': {'min': int(n_valid.min()), 'mean': n_valid.mean().item(),
                        'max': int(n_valid.max())}}


def load_parent_nms(source: str) -> ctypes.CDLL:
    """Build another version of ``nms.cu`` and declare the C interface that
    every version has (``nms_keep_scratch_words``, ``nms_keep_launch``)."""
    lib = ctypes.CDLL(str(_build.build_source(Path(source))))
    lib.nms_keep_scratch_words.argtypes = [ctypes.c_int]
    lib.nms_keep_scratch_words.restype = ctypes.c_longlong
    lib.nms_keep_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.nms_keep_launch.restype = ctypes.c_int
    return lib


def parent_launcher(lib: ctypes.CDLL, boxes: torch.Tensor,
                    scores: torch.Tensor, thr: float):
    """A call that launches the other build's kernel on these inputs into a
    keep mask allocated once (the wrapper's launch count is untouched)."""
    n, k = scores.shape
    keep = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    words = lib.nms_keep_scratch_words(k)
    scratch = (torch.empty(n * words, dtype=torch.int64, device=boxes.device)
               if words else None)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream

    def launch():
        err = lib.nms_keep_launch(
            boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, n, k, thr,
            boxes.device.index, stream)
        if err:
            fail(f'parent NMS kernel launch failed ({err})')
        return keep
    return launch


def time_nms(thr: float, inputs: dict, card: str, parent=None) -> dict:
    """The NMS kernel's device time per launch at each input, beside the
    launch floor (an empty kernel on the same grid), the plain version and
    the bound; with ``parent`` (another build of ``nms.cu``, from
    :func:`load_parent_nms`) that kernel too, in turns (parent, this, this,
    parent), after checking that it gives the same keep mask."""
    out = {}
    for name, (boxes, scores) in inputs.items():
        n, k = scores.shape

        def launch():
            return nms_kernel.nms_keep_batched(boxes, scores, thr)

        def device_ms(fn, kernel='nms_keep_kernel'):
            return kernels_device_ms(fn, (kernel,), iters=100)

        row = {'shape': [n, k], **nms_bound(scores, card),
               'kept_mean': launch().sum(dim=1).double().mean().item()}
        if parent is not None:
            parent_launch = parent_launcher(parent, boxes, scores, thr)
            if not torch.equal(parent_launch(), launch()):
                fail(f'the parent NMS kernel and this one differ on {name}')
            turns = {'parent': [], 'this': []}
            for side in ('parent', 'this', 'this', 'parent'):
                turns[side].append(device_ms(
                    parent_launch if side == 'parent' else launch))
            row['ms'] = statistics.mean(turns['this'])
            row['parent_ms'] = statistics.mean(turns['parent'])
            row['turns_ms'] = turns
        else:
            row['ms'] = device_ms(launch)
        row['floor_ms'] = device_ms(
            lambda: nms_kernel.launch_floor(n, k, boxes.device),
            'nms_floor_kernel')
        row['call_ms'] = cuda_ms(launch, iters=200)
        row['plain_ms'] = cuda_ms(
            lambda: nms_ops.nms_keep_sorted(boxes, scores, thr), iters=5)
        out[name] = row
        parent_part = (f'parent {row["parent_ms"] * 1e3:.2f} us, '
                       if parent is not None else '')
        log(f'  nms {name}: N={n} K={k}, n_valid {row["n_valid"]}, '
            f'{row["kept_mean"]:.2f} kept per problem: '
            f'{row["ms"] * 1e3:.2f} us/launch ({parent_part}launch floor '
            f'{row["floor_ms"] * 1e3:.2f} us, bound {row["bound_ms"] * 1e3:.3f} '
            f'us {row["bound_by"]}); {row["call_ms"] * 1e3:.2f} us per wrapper '
            f'call; plain {row["plain_ms"]:.3f} ms')
    return out


def profile_b32(pred: Predictor, rng) -> None:
    """Device time by operator over 5 b32 ``predict_batch`` calls."""
    imgs = rng.randint(0, 256, (32, 300, 300, 3), dtype=np.uint8)

    def run():
        for _ in range(5):
            pred.predict_batch(imgs)
        torch.cuda.synchronize()

    prof = profile_window(run)
    log('  profile of 5 x predict_batch(32):')
    log(prof.key_averages().table(sort_by='self_cuda_time_total', row_limit=25,
                                  max_name_column_width=60))


# ---------------------------------------------------------------- phase 6

TRAIN_STEPS = 5


def train_batch(rng: np.random.RandomState, b: int = 32, g: int = 8):
    """Seeded uint8 images at 300x300 and 1..g synthetic GT boxes each."""
    images = rng.randint(0, 256, (b, 300, 300, 3), dtype=np.uint8)
    xy = rng.rand(b, g, 2) * 200
    wh = rng.rand(b, g, 2) * 90 + 10
    cls = rng.randint(1, 21, (b, g, 1))
    boxes = np.concatenate([xy, xy + wh, cls, np.ones((b, g, 1))], -1)
    mask = np.arange(g)[None, :] < rng.randint(1, g + 1, (b, 1))
    return images, boxes.astype(np.float32), mask


def build_trainer(fused_bn: bool) -> Trainer:
    return Trainer.from_config(FLAGSHIP, device='cuda', seed=SEED, overrides={
        'augmentations': [], 'train': {'fused_bn': fused_bn}})


def run_training_path(trainer: Trainer, batches):
    """``TRAIN_STEPS`` steps with the BN kernels' counts read around them."""
    for fn in bn_kernel.KERNELS:
        fn.launches = 0
    metrics = [trainer.train_step(*batch) for batch in batches]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in bn_kernel.KERNELS}
    return [{k: v.item() for k, v in m.items()} for m in metrics], launches


def check_training_path(metrics, launches, n_bn: int) -> None:
    for step, m in enumerate(metrics):
        if not all(np.isfinite(v) for v in m.values()):
            fail(f'train step {step}: non-finite metrics {m}')
    for name, count in launches.items():
        if count != n_bn * TRAIN_STEPS:
            fail(f'{name} launched {count} times in {TRAIN_STEPS} steps, '
                 f'expected {n_bn} train-mode BNs x {TRAIN_STEPS}')


def check_against_library_bn(trainer: Trainer, batch) -> dict:
    """One step from the same state with the kernels (``fused_bn`` on) and
    with PyTorch's batch norm (off): loss within 1e-4 relative, BN running
    statistics within 1e-4 of max(1, |value|)."""
    library = build_trainer(False)
    library.model.load_state_dict(trainer.model.state_dict())
    library.state.optimizer.load_state_dict(trainer.state.optimizer.state_dict())
    library.state.step = trainer.state.step
    on = trainer.train_step(*batch)['loss'].item()
    off = library.train_step(*batch)['loss'].item()
    loss_rel = abs(on - off) / abs(off)
    if not loss_rel <= 1e-4:
        fail(f'loss with the BN kernels {on} vs PyTorch BN {off}')
    got, want = trainer.model.state_dict(), library.model.state_dict()
    stats_err = 0.0
    for name in want:
        if name.endswith(('running_mean', 'running_var')):
            err = (got[name] - want[name]).abs().max().item()
            if not err <= 1e-4 * max(1.0, want[name].abs().max().item()):
                fail(f'{name}: BN kernels vs PyTorch BN differ by {err}')
            stats_err = max(stats_err, err)
    log(f'  one step, BN kernels vs PyTorch BN: loss {on:.6f} vs {off:.6f} '
        f'(rel {loss_rel:.3g}, tol 1e-4); running statistics max abs err '
        f'{stats_err:.3g}')
    return {'library': library, 'loss_rel_err': loss_rel,
            'stats_max_abs_err': stats_err}


# ---------------------------------------------------------------- phase 7

def time_train_steps(kernels: Trainer, library: Trainer, batch) -> dict:
    """b32 train step, BN kernels vs PyTorch BN, in turns (on, off, off,
    on; 8 steps each), median per side."""
    times = {'on': [], 'off': []}
    for side in ('on', 'off', 'off', 'on'):
        trainer = kernels if side == 'on' else library
        times[side] += host_times_ms(lambda: trainer.train_step(*batch), iters=8,
                                     warmup=2)
    out = {}
    for side, key in (('on', 'fused_bn'), ('off', 'library_bn')):
        ms = statistics.median(times[side])
        out[f'train_step_b32_{key}_ms'] = ms
        out[f'train_step_b32_{key}_img_per_s'] = 32 * 1e3 / ms
        out[f'train_step_b32_{key}_all_ms'] = times[side]
    return out


def profile_train_step(trainer: Trainer, batch, n_bn: int, card: str) -> dict:
    """One profiled b32 train step: each BN kernel's device time in the step
    beside its bound for the step's shapes, the card's busy time, and the
    table of device time by operator."""
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append(tuple(args[0].shape)))
        for m in trainer.model.modules() if isinstance(m, BatchNorm)]
    trainer.train_step(*batch)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    if len(shapes) != n_bn:
        fail(f'{len(shapes)} BN calls in a step, expected {n_bn}')
    walls = []

    def step():
        t = time.perf_counter()
        trainer.train_step(*batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)

    prof = profile_counted(step, [cuda_name for cuda_names, _, _ in
                                  BN_KERNELS.values() for cuda_name in cuda_names],
                           n_bn)
    wall_ms = walls[-1]
    out = {}
    for name, (cuda_names, _, _) in BN_KERNELS.items():
        total = sum(device_us(prof, cuda_name)[0] for cuda_name in cuda_names)
        out[name] = {'step_ms': total / 1e3, 'step_bound_ms': sum(
            bn_bound_ms(name, math.prod(s), s[1], card)[0] for s in shapes)}
    busy_ms = busy_us(prof) / 1e3
    out['device_busy_ms'] = busy_ms
    out['profiled_step_wall_ms'] = wall_ms
    out['bn_elements_per_step'] = sum(math.prod(s) for s in shapes)
    out['bn_shapes'] = shapes
    log(f'  profile of one train_step(32) with the BN kernels '
        f'({busy_ms:.3f} ms of device time in {wall_ms:.3f} ms of wall '
        f'time under the profiler):')
    log(prof.key_averages().table(sort_by='self_cuda_time_total', row_limit=30,
                       max_name_column_width=60))
    return out


def device_busy_ms(fn, iters: int = 3) -> float:
    """Device time per call of ``fn``, summed over every CUDA kernel it
    launches, from the profiler's trace."""
    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    return busy_us(profile_window(run)) / iters / 1e3


def library_bn_step_ms(shapes) -> dict:
    """The PyTorch pairs over one train step's BN shapes (f32, one call per
    shape): ``native_batch_norm`` (K1+K2) and
    ``native_batch_norm_backward`` (K3+K4), device time summed over all of
    their kernels."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 5)
    data = []
    for shape in shapes:
        c = shape[1]
        data.append((torch.randn(shape, device='cuda', generator=gen),
                     torch.randn(shape, device='cuda', generator=gen),
                     torch.rand(c, device='cuda', generator=gen) + 0.5,
                     torch.randn(c, device='cuda', generator=gen) * 0.1))

    def forward():
        return [torch.native_batch_norm(x, scale, bias, None, None, True, 0.0,
                                        BN_EPS) for x, _, scale, bias in data]

    saved = [(mean, invstd) for _, mean, invstd in forward()]

    def backward():
        for (x, dz, scale, _), (mean, invstd) in zip(data, saved):
            torch.ops.aten.native_batch_norm_backward(
                dz, x, scale, None, None, mean, invstd, True, BN_EPS,
                [True, True, True])

    out = {'K1+K2': device_busy_ms(forward), 'K3+K4': device_busy_ms(backward)}
    del data, saved
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 8

# The flagship's data for phases 8-9: the JAX package's procedural dataset
# at 500 px, so the loader stages a real resize to 300x300.
FLAGSHIP_DATA = {
    'train': {'name': 'Synthetic', 'num_images': 256, 'image_size': 500,
              'num_classes': 21, 'max_boxes': 6, 'seed': 1},
    'eval': {'name': 'Synthetic', 'num_images': 128, 'image_size': 500,
             'num_classes': 21, 'max_boxes': 6, 'seed': 2},
}
# Pixels of the augmentation on the card against the CPU, same draws, on the
# 0-255 scale: the image means (the contrast anchor and the expand fill, over
# 90,000 pixels) and the two resample products sum in another order there.
AUG_PIXEL_TOL = 2e-3


def build_experiment() -> Experiment:
    return Experiment(FLAGSHIP, phases=('train', 'eval'), device='cuda',
                      seed=SEED, overrides={
                          'dataset': FLAGSHIP_DATA,
                          'train': {'epochs': 1, 'eval_every': 1,
                                    'fused_bn': True}})


def zero_launches() -> None:
    nms_kernel.nms_keep_batched.launches = 0
    for fn in bn_kernel.KERNELS:
        fn.launches = 0


def read_launches() -> dict:
    out = {fn.__name__: fn.launches for fn in bn_kernel.KERNELS}
    out['nms_keep_batched'] = nms_kernel.nms_keep_batched.launches
    return out


def run_experiment(exp: Experiment):
    """``Experiment.train()`` (one epoch, then ``evaluate()``) with every
    kernel's count read around it."""
    zero_launches()
    t = time.perf_counter()
    rows = exp.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    return rows, read_launches(), seconds


def check_experiment(exp: Experiment, rows, launches, n_bn: int) -> None:
    steps = len(exp.loaders['train'])
    eval_batches = len(exp.loaders['eval'])
    if (steps, eval_batches) != (8, 2) or len(rows) != 1:
        fail(f'{steps} train steps, {eval_batches} eval batches, '
             f'{len(rows)} epoch rows; expected 8, 2 and 1')
    row = rows[0]
    if not all(np.isfinite(v) for v in row.values()):
        fail(f'non-finite epoch row {row}')
    if not 0.0 <= row.get('eval_mAP', -1.0) <= 1.0:
        fail(f'eval mAP {row.get("eval_mAP")} outside [0, 1]')
    want = {fn.__name__: n_bn * steps for fn in bn_kernel.KERNELS}
    want['nms_keep_batched'] = eval_batches
    if launches != want:
        fail(f'kernel launches {launches}, expected {want}')


def first_batch(loader, device):
    batch = next(iter(loader))
    return tuple(torch.from_numpy(batch[k]).to(device)
                 for k in ('image', 'boxes', 'box_mask'))


def check_augmentation_card_vs_cpu(exp: Experiment, batch) -> dict:
    """One draw dict applied to the same b32 batch on the card and on the
    CPU: masks and boxes equal, pixels within ``AUG_PIXEL_TOL`` on the 0-255
    scale."""
    pipeline = exp.trainer.pipeline
    draws = exp.trainer.draws(0, batch[0].shape[0])
    with torch.no_grad():
        card = pipeline.apply(transforms.draws_to(draws, batch[0].device), *batch)
        cpu = pipeline.apply(draws, *(x.cpu() for x in batch))
    x_card, boxes_card, mask_card = (x.cpu() for x in card)
    if not torch.equal(mask_card, cpu[2]):
        fail('augmented masks differ between the card and the CPU')
    if not torch.equal(boxes_card, cpu[1]):
        err = (boxes_card - cpu[1]).abs().max().item()
        fail(f'augmented boxes differ between the card and the CPU by {err}')
    pre = pipeline.preprocess
    std = torch.tensor(pre.std or (1.0, 1.0, 1.0))[:, None, None]
    err = ((x_card - cpu[0]).abs() * std * pre.divisor).max().item()
    if not err <= AUG_PIXEL_TOL:
        fail(f'augmented pixels differ between the card and the CPU by {err} '
             f'> {AUG_PIXEL_TOL} on the 0-255 scale')
    dropped = (batch[2].cpu() & ~cpu[2][:, :batch[2].shape[1]]).sum().item()
    log(f'  augmentation card vs CPU (b{batch[0].shape[0]}, one draw dict): '
        f'masks and boxes equal ({int(mask_card.sum())} boxes kept, '
        f'{dropped} dropped), pixels max abs err {err:.3g} (tol '
        f'{AUG_PIXEL_TOL}, 0-255 scale)')
    return {'aug_card_vs_cpu_pixel_max_abs_err': err}


def check_eval_kernel_vs_plain(exp: Experiment, batch) -> None:
    """The eval postprocessor with the NMS kernel against the plain one on
    one eval batch's heads: valid masks and detections equal."""
    x, _, _ = exp.eval_pipeline.apply([], *batch)
    exp.model.eval()
    with torch.inference_mode():
        scores, locs = exp.model(x)
    plain = copy.copy(exp.postprocessor)
    plain.nms_keep = lambda boxes, scores: nms_ops.nms_keep_sorted(
        boxes, scores, plain.overlap_threshold)
    d_k, v_k = exp.postprocessor(scores.float(), locs.float(), exp.anchors)
    d_p, v_p = plain(scores.float(), locs.float(), exp.anchors)
    if not torch.equal(v_k, v_p) or not torch.equal(d_k[v_k], d_p[v_p]):
        fail('eval postprocessor with the NMS kernel differs from the plain one')
    log(f'  eval postprocess (b{x.shape[0]}) with the NMS kernel == plain: '
        f'{int(v_k.sum())} valid detections')


# ---------------------------------------------------------------- phase 9

def time_experiment(exp: Experiment, batch, card: str) -> dict:
    """Epoch img/s with augmentation, eval img/s, the train loader's img/s
    alone (staging on the card, then on the CPU) and an epoch's with CPU
    staging, the ``Pipeline``'s device and host ms per b32 batch and its
    share of the augmented step, and a profiler table of one augmented
    train step."""
    loader = exp.loaders['train']
    images = len(loader) * loader.batch_size

    def seconds(fn):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    epoch_s = seconds(lambda: exp.train_epoch(1))
    eval_s = seconds(exp.evaluate)
    out = {'train_epoch_s': epoch_s, 'train_epoch_img_per_s': images / epoch_s,
           'eval_s': eval_s,
           'eval_img_per_s': len(exp.datasets['eval']) / eval_s,
           'loader_img_per_s': images / seconds(lambda: list(loader))}
    # the loader staging on the CPU instead of the card
    loader.staging_device = torch.device('cpu')
    out['loader_cpu_staging_img_per_s'] = images / seconds(lambda: list(loader))
    out['train_epoch_cpu_staging_img_per_s'] = images / seconds(
        lambda: exp.train_epoch(2))
    loader.staging_device = batch[0].device

    trainer = exp.trainer
    b = batch[0].shape[0]
    draws = transforms.draws_to(trainer.draws(0, b), batch[0].device)

    def augment():
        with torch.no_grad():
            trainer.pipeline.apply(draws, *batch)

    def step():
        trainer.train_step(*batch)

    def augment_5():
        for _ in range(5):
            augment()
        torch.cuda.synchronize()

    prof = profile_window(augment_5)
    out['pipeline_b32_device_ms'] = busy_us(prof) / 5 / 1e3
    out['pipeline_b32_aten_calls'] = sum(
        e.count for e in prof.key_averages() if e.key.startswith('aten::')) / 5
    out['pipeline_b32_host_ms'] = statistics.median(host_times_ms(augment, 10))
    out['aug_train_step_b32_ms'] = statistics.median(host_times_ms(step, 8))
    # the step on the same batch with the chain and without it (given draws,
    # so neither samples), in turns
    plain = transforms.Pipeline((), exp.cfg.preprocessing,
                                trainer.bundle.input_size)
    sides = {side: (make_train_step(trainer.criterion, trainer.assigner,
                                    trainer.anchors, trainer.schedule, pipe), d)
             for side, pipe, d in (('augmented', trainer.pipeline, draws),
                                   ('plain', plain, []))}
    turns = {side: [] for side in sides}
    for side in ('augmented', 'plain', 'plain', 'augmented'):
        fn, d = sides[side]
        turns[side] += host_times_ms(lambda: fn(trainer.state, *batch, d), 6,
                                     warmup=1)
    for side, times in turns.items():
        out[f'{side}_step_given_draws_b32_ms'] = statistics.median(times)
    walls = []

    def profiled_step():
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)

    prof = profile_window(profiled_step)
    out['aug_train_step_b32_device_busy_ms'] = busy_us(prof) / 1e3
    out['pipeline_share_of_step_device'] = (
        out['pipeline_b32_device_ms'] / out['aug_train_step_b32_device_busy_ms'])
    out['pipeline_share_of_step_wall'] = (
        out['pipeline_b32_host_ms'] / out['aug_train_step_b32_ms'])
    log(f'[9] {card}: train epoch ({images} images, augmented, fused_bn) '
        f'{epoch_s:.3f} s = {out["train_epoch_img_per_s"]:.1f} img/s; '
        f'evaluate ({len(exp.datasets["eval"])} images) {eval_s:.3f} s = '
        f'{out["eval_img_per_s"]:.1f} img/s')
    log(f'  loader alone {out["loader_img_per_s"]:.1f} img/s staging on the '
        f'card, {out["loader_cpu_staging_img_per_s"]:.1f} img/s on the CPU; '
        f'train epoch with CPU staging '
        f'{out["train_epoch_cpu_staging_img_per_s"]:.1f} img/s')
    log(f'  Pipeline b{b}: {out["pipeline_b32_aten_calls"]:.0f} aten calls '
        f'(nested ones counted), {out["pipeline_b32_device_ms"]:.3f} ms of '
        f'device time ({100 * out["pipeline_share_of_step_device"]:.1f} % of the '
        f'augmented step\'s {out["aug_train_step_b32_device_busy_ms"]:.3f} ms), '
        f'{out["pipeline_b32_host_ms"]:.3f} ms of wall time '
        f'({100 * out["pipeline_share_of_step_wall"]:.1f} % of the augmented '
        f'step\'s {out["aug_train_step_b32_ms"]:.3f} ms)')
    log(f'  the step with draws given, in turns: with the chain '
        f'{out["augmented_step_given_draws_b32_ms"]:.3f} ms, without it '
        f'{out["plain_step_given_draws_b32_ms"]:.3f} ms (medians of 12)')
    log(f'  profile of one augmented train_step(32) ({walls[-1]:.3f} ms of '
        f'wall time under the profiler):')
    log(prof.key_averages().table(sort_by='self_cuda_time_total', row_limit=30,
                                  max_name_column_width=60))
    return out


# --------------------------------------------------------------- phase 10

# The flagship's data for phase 10: phase 8's 500 px synthetic set, cut to
# 4 b32 train steps and one b64 eval batch per epoch
CLI_DATA = {
    'train': {**FLAGSHIP_DATA['train'], 'num_images': 128},
    'eval': {**FLAGSHIP_DATA['eval'], 'num_images': 64},
}
CLI_EPOCHS = 2
JAX_RUN = 'experiments/2026-08-16-225820'  # a trained run of the JAX package


def write_cli_config(path: Path, epochs: int) -> str:
    """The flagship config with ``CLI_DATA``, ``epochs``, an evaluation and
    a checkpoint every epoch and ``train.fused_bn``."""
    path.write_text(
        (REPO / FLAGSHIP).read_text()
        + '\n# chip_smoke.py phase 10: synthetic 500 px data, fused BN\n'
        + f'dataset = {CLI_DATA!r}\n'
        + f'train = dict(train, epochs={epochs}, eval_every=1, save_every=1, '
        'fused_bn=True)\n')
    return str(path)


def run_cli(argv):
    """``cli.main(argv)`` with every kernel's count set to 0 just before
    and read just after, and each train epoch timed; returns the
    experiment, its result, the launches, the seconds and the epochs'
    seconds."""
    epoch_s = []
    train_epoch = Experiment.train_epoch

    def timed(self, epoch):
        t = time.perf_counter()
        row = train_epoch(self, epoch)  # reads its sums: waits for the card
        epoch_s.append(time.perf_counter() - t)
        return row

    Experiment.train_epoch = timed
    try:
        zero_launches()
        t = time.perf_counter()
        exp, result = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = read_launches()
    finally:
        Experiment.train_epoch = train_epoch
    return exp, result, launches, seconds, epoch_s


def read_log_csv(path: str):
    with open(path, newline='') as f:
        return list(csv.DictReader(f))


def check_cli_run(exp, rows, launches, n_bn: int, run_dir: str) -> None:
    steps = len(exp.loaders['train'])
    eval_batches = len(exp.loaders['eval'])
    if (steps, eval_batches) != (4, 1) or [r['epoch'] for r in rows] != [0, 1]:
        fail(f'{steps} train steps, {eval_batches} eval batches, epochs '
             f'{[r["epoch"] for r in rows]}; expected 4, 1 and [0, 1]')
    for row in rows:
        if not all(np.isfinite(v) for v in row.values()):
            fail(f'non-finite epoch row {row}')
    want = {fn.__name__: n_bn * steps * CLI_EPOCHS for fn in bn_kernel.KERNELS}
    want['nms_keep_batched'] = eval_batches * CLI_EPOCHS
    if launches != want:
        fail(f'CLI kernel launches {launches}, expected {want}')
    files = sorted(os.listdir(run_dir))
    expected = ['ckpt-4.pt', 'ckpt-4.pt.meta.json', 'ckpt-8.pt',
                'ckpt-8.pt.meta.json', 'config.py', 'log.csv', 'train.log']
    if files != expected:
        fail(f'the CLI wrote {files}, expected {expected}')


def check_round_trip(exp, config: str, path: str) -> dict:
    """``path`` restored into a fresh trainer on the card: every tensor and
    momentum buffer, the step and ``lr_scale`` equal to the run's state bit
    for bit; the restore's ms."""
    fresh = Trainer.from_config(config, device='cuda', seed=SEED + 7,
                                steps_per_epoch=len(exp.loaders['train']))
    torch.cuda.synchronize()
    t = time.perf_counter()
    ckpt.restore(path, fresh.state)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t) * 1e3
    state = exp.trainer.state
    if (fresh.state.step, fresh.state.lr_scale) != (state.step, state.lr_scale):
        fail(f'restored step/lr_scale {fresh.state.step}/{fresh.state.lr_scale}, '
             f'saved {state.step}/{state.lr_scale}')
    want = exp.model.state_dict()
    got = fresh.model.state_dict()
    if got.keys() != want.keys():
        fail('the restored state_dict has other names')
    for k in want:
        if not torch.equal(got[k], want[k]):
            fail(f'{k} differs after the save and restore')
    buffers = 0
    for p, q in zip(fresh.model.parameters(), exp.model.parameters()):
        a = fresh.state.optimizer.state[p]['momentum_buffer']
        b = state.optimizer.state[q]['momentum_buffer']
        if a.device != b.device or not torch.equal(a, b):
            fail('a momentum buffer differs after the save and restore')
        buffers += 1
    log(f'  save -> restore on the card: {len(want)} tensors and {buffers} '
        f'momentum buffers bit-equal; step {state.step}')
    return {'restore_ms': restore_ms, 'tensors': len(want),
            'momentum_buffers': buffers}


def time_checkpoint(exp, directory: str, iters: int = 3) -> dict:
    """``checkpoint.save`` of the run's state, ms per call (median of
    ``iters``) and the file's bytes."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = ckpt.save(directory, exp.trainer.state, 0)
        times.append((time.perf_counter() - t) * 1e3)
    return {'save_ms': statistics.median(times), 'save_all_ms': times,
            'file_bytes': os.path.getsize(path)}


def resume_in_a_fresh_process(run_dir: str) -> dict:
    """``python -m single_shot_detection_tpu_torch --checkpoint run_dir``
    with three epochs: it must start at epoch 2, write ``ckpt-12.pt`` and a
    third ``log.csv`` row with finite losses, and keep the first two."""
    before = read_log_csv(os.path.join(run_dir, 'log.csv'))
    config = write_cli_config(Path(run_dir) / 'config.py', CLI_EPOCHS + 1)
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'single_shot_detection_tpu_torch', '--config',
         config, '--checkpoint', run_dir], cwd=REPO, capture_output=True,
        text=True, timeout=900)
    seconds = time.perf_counter() - t
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-4000:])
        fail(f'the resumed CLI run exited {proc.returncode}')
    out = proc.stdout
    if ('Restored checkpoint' not in out or 'Epoch: 2/2' not in out
            or 'Epoch: 0/' in out or 'Epoch: 1/' in out):
        log(out[-4000:])
        fail('the resumed run did not start at epoch 2')
    if 'ckpt-12.pt' not in os.listdir(run_dir):
        fail(f'the resumed run wrote no ckpt-12.pt: {os.listdir(run_dir)}')
    rows = read_log_csv(os.path.join(run_dir, 'log.csv'))
    if [r['epoch'] for r in rows] != ['0', '1', '2'] or rows[:2] != before:
        fail(f'log.csv after the resume: epochs {[r["epoch"] for r in rows]}')
    losses = {k: float(rows[2][k]) for k in ('train_loss', 'eval_loss')}
    if not all(np.isfinite(v) for v in losses.values()):
        fail(f'non-finite losses after the resume: {losses}')
    log(f'  a fresh process resumed at epoch 2 in {seconds:.2f} s: '
        + json.dumps({**losses, 'eval_mAP': float(rows[2]['eval_mAP'])}))
    return {'resume_process_s': seconds, 'resumed_row': rows[2]}


# --------------------------------------------------------------- phase 11

def listing(root: str):
    return sorted((os.path.join(d, f), os.stat(os.path.join(d, f)).st_size,
                   os.stat(os.path.join(d, f)).st_mtime_ns)
                  for d, _, files in os.walk(root) for f in files)


def eval_jax_checkpoint(device_flag) -> tuple:
    argv = ['--config', f'{JAX_RUN}/config.py', '--checkpoint', JAX_RUN,
            '--phases', 'eval'] + device_flag
    zero_launches()
    exp, metrics = cli.main(argv)
    return exp, metrics, read_launches()


def check_jax_checkpoint(card_metrics, cpu_metrics) -> dict:
    """Loss within 1e-4 relative and mAP within 0.005 of the CPU's."""
    rel = abs(card_metrics['loss'] - cpu_metrics['loss']) / abs(cpu_metrics['loss'])
    gap = abs(card_metrics['mAP'] - cpu_metrics['mAP'])
    if not (rel <= 1e-4 and gap <= 0.005):
        fail(f'the JAX checkpoint on the card: loss {card_metrics["loss"]} mAP '
             f'{card_metrics["mAP"]}, on the CPU loss {cpu_metrics["loss"]} mAP '
             f'{cpu_metrics["mAP"]}')
    last = read_log_csv(f'{JAX_RUN}/log.csv')[-1]
    log(f'  the JAX checkpoint ({JAX_RUN}, step 1800): card loss '
        f'{card_metrics["loss"]!r} mAP {card_metrics["mAP"]!r}; CPU loss '
        f'{cpu_metrics["loss"]!r} mAP {cpu_metrics["mAP"]!r} (loss rel '
        f'{rel:.3g}, tol 1e-4; mAP gap {gap:.3g}, tol 0.005); its log.csv, '
        f'from other hardware, not held: eval_loss {last["eval_loss"]} '
        f'eval_mAP {last["eval_mAP"]}')
    return {'loss_rel_err': rel, 'mAP_gap': gap,
            'log_csv_eval_loss': float(last['eval_loss']),
            'log_csv_eval_mAP': float(last['eval_mAP'])}


def eval_nms_inputs(exp):
    """The NMS kernel's inputs in ``exp.evaluate()``'s first batch."""
    captured = {}
    original = exp.postprocessor.nms_keep

    def capture(boxes, scores):
        if not captured:
            captured.update(boxes=boxes.clone(), scores=scores.clone())
        return original(boxes, scores)

    exp.postprocessor.nms_keep = capture
    try:
        exp.evaluate()
    finally:
        del exp.postprocessor.nms_keep
    return captured['boxes'], captured['scores']


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument(
        '--parent-nms', metavar='NMS_CU',
        help='another version of kernels/nms.cu (e.g. from a git archive '
             'of an earlier commit) to build and time beside this one')
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # 1. environment
    if not torch.cuda.is_available():
        print('FAIL: CUDA is not available', file=sys.stderr)
        return 1
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(f'[1] card: {smi} | torch {torch.__version__} | CUDA '
        f'{torch.version.cuda} | python {sys.version.split()[0]}')
    device = torch.device('cuda')

    # 2. build: one nvcc per source, all started together
    t = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        builds = [pool.submit(m.build) for m in (nms_kernel, bn_kernel)]
        parent = (pool.submit(load_parent_nms, args.parent_nms)
                  if args.parent_nms else None)
        for b in builds:
            b.result()
        parent_nms = parent.result() if parent else None
    log(f'[2] built the nms and bn kernels in {time.perf_counter() - t:.2f} s'
        + (f' (and {args.parent_nms})' if args.parent_nms else ''))

    # 3. kernels against their plain versions
    log('[3] kernels vs plain versions on the card')
    nms_check = check_nms_kernel(device)
    bn_check = check_bn_kernels()

    # 4. the serving path
    t = time.perf_counter()
    pred = build_predictor(device)
    log(f'[4] predictor built in {time.perf_counter() - t:.2f} s: '
        f'{len(pred.anchors)} anchors, {FLAGSHIP}')
    rng = np.random.RandomState(SEED)
    batches = [rng.randint(0, 256, (32, 300, 300, 3), dtype=np.uint8)
               for _ in range(3)]
    singles = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
               for h, w in [(300, 300), (480, 640), (375, 500), (720, 1280)]]
    nms_kernel.nms_keep_batched.launches = 0
    outs, answers = run_main_path(pred, batches, singles)
    launches = nms_kernel.nms_keep_batched.launches
    if launches == 0:
        fail('the serving path launched no NMS kernel')
    check_main_path(pred, outs, answers, singles)
    log(f'  3 x predict_batch(32) + 4 x predict: shapes and values ok, '
        f'{launches} NMS kernel launches')
    heads = check_against_cpu_and_plain(pred, batches[0])

    # 5. serving times
    timing = time_slice(pred, heads, rng)
    log(f'[5] {smi}: ' + ', '.join(f'{k} {v:.4g}' for k, v in timing.items()))
    b32 = nms_inputs(pred, batches[0])
    sparse_scores = b32[1].clone()
    prefix = torch.from_numpy(rng.randint(0, 21, len(sparse_scores))).cuda()
    sparse_scores[torch.arange(sparse_scores.shape[1], device='cuda')[None]
                  >= prefix[:, None]] = float('-inf')
    nms_time = time_nms(pred.postprocessor.overlap_threshold, {
        'b32': b32,
        'b128': nms_inputs(pred, rng.randint(0, 256, (128, 300, 300, 3),
                                             dtype=np.uint8)),
        'sparse b32 (synthetic: valid prefixes of 0-20)': (b32[0], sparse_scores),
    }, card, parent_nms)
    profile_b32(pred, rng)
    forward_err = heads['forward_vs_cpu']
    del pred, heads, outs
    torch.cuda.empty_cache()

    # 6. the training path
    t = time.perf_counter()
    trainer = build_trainer(True)
    n_bn = sum(isinstance(m, BatchNorm) for m in trainer.model.modules())
    log(f'[6] trainer built in {time.perf_counter() - t:.2f} s: {FLAGSHIP} '
        f'with fused_bn, no augmentation, {n_bn} train-mode BNs')
    train_rng = np.random.RandomState(SEED + 4)
    train_batches = [train_batch(train_rng) for _ in range(TRAIN_STEPS)]
    metrics, bn_launches = run_training_path(trainer, train_batches)
    check_training_path(metrics, bn_launches, n_bn)
    log(f'  {TRAIN_STEPS} x train_step(32): losses '
        + ', '.join(f'{m["loss"]:.4f}' for m in metrics)
        + '; BN kernel launches ' + json.dumps(bn_launches))
    library_check = check_against_library_bn(trainer, train_batches[0])

    # 7. training times
    train_timing = time_train_steps(trainer, library_check['library'],
                                    train_batches[0])
    bn_time = time_bn_kernels(card)
    step_profile = profile_train_step(trainer, train_batches[0], n_bn, card)
    library_step = library_bn_step_ms(step_profile.pop('bn_shapes'))
    log(f'[7] {smi}: train_step b32 with the BN kernels '
        f'{train_timing["train_step_b32_fused_bn_ms"]:.3f} ms = '
        f'{train_timing["train_step_b32_fused_bn_img_per_s"]:.1f} img/s; with '
        f'PyTorch BN {train_timing["train_step_b32_library_bn_ms"]:.3f} ms = '
        f'{train_timing["train_step_b32_library_bn_img_per_s"]:.1f} img/s')
    for name in BN_KERNELS:
        k, s = bn_time[name], step_profile[name]
        log(f'  {name}: {k["ms"] * 1e3:.2f} us/launch at {list(BN_TIMED_SHAPE)} '
            f'(bound {k["bound_ms"] * 1e3:.2f} us, {k["bound_by"]}; plain '
            f'{k["plain_ms"] * 1e3:.2f} us; PyTorch {k["library_pair"]} pair '
            f'{k["library_ms"] * 1e3:.2f} us); {s["step_ms"]:.3f} ms per step '
            f'over {n_bn} launches (bound {s["step_bound_ms"]:.3f} ms)')
    pair_steps = {'K1+K2': step_profile['bn_stats']['step_ms']
                  + step_profile['bn_apply']['step_ms'],
                  'K3+K4': step_profile['bn_grad_sums']['step_ms']
                  + step_profile['bn_dx']['step_ms']}
    for pair, ms in library_step.items():
        log(f'  per step over the {n_bn} BN shapes: kernels {pair} {pair_steps[pair]:.3f} ms, '
            f'PyTorch pair {ms:.3f} ms')
    del trainer, library_check['library']
    torch.cuda.empty_cache()

    # 8. the flagship as shipped: Experiment, train and eval
    t = time.perf_counter()
    exp = build_experiment()
    log(f'[8] experiment built in {time.perf_counter() - t:.2f} s: {FLAGSHIP} '
        f'with its augmentation chain ({len(exp.trainer.pipeline.stages)} '
        f'stages), fused_bn, synthetic 500 px data, '
        f'{len(exp.loaders["train"])} train and {len(exp.loaders["eval"])} '
        f'eval batches')
    exp_rows, exp_launches, exp_s = run_experiment(exp)
    check_experiment(exp, exp_rows, exp_launches, n_bn)
    log(f'  Experiment.train() (1 epoch + evaluate) in {exp_s:.2f} s: '
        + json.dumps(exp_rows[0]) + '; kernel launches '
        + json.dumps(exp_launches))
    aug_batch = first_batch(exp.loaders['train'], device)
    aug_check = check_augmentation_card_vs_cpu(exp, aug_batch)
    check_eval_kernel_vs_plain(exp, first_batch(exp.loaders['eval'], device))

    # 9. the slice's times
    exp_timing = time_experiment(exp, aug_batch, smi)
    del exp, aug_batch
    torch.cuda.empty_cache()

    # 10. the port as users start it: the CLI, checkpoints, a resume in a
    # fresh process
    work = tempfile.mkdtemp(prefix='chip_smoke_cli_')
    try:
        config = write_cli_config(Path(work) / 'flagship_cli.py', CLI_EPOCHS)
        cli_exp, cli_rows, cli_launches, cli_s, cli_epoch_s = run_cli(
            ['--config', config, '--phases', 'train', 'eval', '--save-dir',
             os.path.join(work, 'runs')])
        run_dir = cli_exp.checkpoint_dir
        check_cli_run(cli_exp, cli_rows, cli_launches, n_bn, run_dir)
        images = len(cli_exp.loaders['train']) * cli_exp.loaders['train'].batch_size
        log(f'[10] {smi}: python -m single_shot_detection_tpu_torch (in this '
            f'process) on {FLAGSHIP} with fused_bn and synthetic 500 px data: '
            f'{CLI_EPOCHS} epochs of {len(cli_exp.loaders["train"])} b32 steps, '
            f'an evaluation and a checkpoint after each, in {cli_s:.2f} s; '
            'epochs ' + ', '.join(f'{t:.3f} s = {images / t:.1f} img/s'
                                  for t in cli_epoch_s)
            + '; kernel launches ' + json.dumps(cli_launches))
        for row in cli_rows:
            log('  ' + json.dumps(row))
        round_trip = check_round_trip(cli_exp, config,
                                      ckpt.find_latest(run_dir))
        ckpt_timing = time_checkpoint(cli_exp, os.path.join(work, 'timing'))
        log(f'  checkpoint save {ckpt_timing["save_ms"]:.1f} ms (median of 3), '
            f'restore {round_trip["restore_ms"]:.1f} ms, '
            f'{ckpt_timing["file_bytes"]} bytes')
        del cli_exp
        torch.cuda.empty_cache()
        resumed = resume_in_a_fresh_process(run_dir)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 11. the JAX package's trained checkpoint on the card and on the CPU
    before = listing('experiments')
    jax_exp, card_metrics, jax_launches = eval_jax_checkpoint([])
    if jax_launches['nms_keep_batched'] != len(jax_exp.loaders['eval']):
        fail(f'the JAX checkpoint\'s evaluation launched NMS '
             f'{jax_launches["nms_keep_batched"]} times')
    _, cpu_metrics, _ = eval_jax_checkpoint(['--cpu'])
    log(f'[11] {smi}:')
    jax_check = check_jax_checkpoint(card_metrics, cpu_metrics)
    trained = time_nms(jax_exp.postprocessor.overlap_threshold,
                       {'trained smoke eval (b16)': eval_nms_inputs(jax_exp)},
                       card)
    if listing('experiments') != before:
        fail('experiments/ changed')
    log('  experiments/ unchanged')

    log(json.dumps({'slice': {
        'card': smi, **timing, 'forward_vs_cpu_max_abs_err': forward_err,
        **train_timing,
        'train_losses': [m['loss'] for m in metrics],
        'bn_vs_library_loss_rel_err': library_check['loss_rel_err'],
        'bn_vs_library_stats_max_abs_err': library_check['stats_max_abs_err'],
        'train_step_device_busy_ms': step_profile['device_busy_ms'],
        'profiled_train_step_wall_ms': step_profile['profiled_step_wall_ms'],
        'bn_elements_per_step': step_profile['bn_elements_per_step'],
        'experiment_epoch_row': exp_rows[0], 'experiment_s': exp_s,
        **aug_check, **exp_timing,
        'cli': {'seconds': cli_s, 'epoch_s': cli_epoch_s,
                'epoch_img_per_s': [images / t for t in cli_epoch_s],
                'rows': cli_rows, 'launches': cli_launches, **round_trip,
                **ckpt_timing, **resumed},
        'jax_checkpoint': {'card': card_metrics, 'cpu': cpu_metrics,
                           **jax_check, 'launches': jax_launches}}}))
    # ``launches``: the count on this slice's path (phase 10's CLI run);
    # ``launches_by_path``: each path's own run
    kernels = [{
        'name': 'nms_keep_batched',
        'route': 'cuda',
        'source': 'single_shot_detection_tpu_torch/kernels/nms.cu',
        'replaces': 'single_shot_detection_tpu/ops/nms_pallas.py:33',
        'launches': cli_launches['nms_keep_batched'],
        'launches_by_path': {'serving': launches, 'experiment':
                             exp_launches['nms_keep_batched'],
                             'cli': cli_launches['nms_keep_batched'],
                             'cli_jax_checkpoint':
                                 jax_launches['nms_keep_batched']},
        'max_abs_err': nms_check['max_abs_err'],
        **{key: nms_time['b32'][key] for key in (
            'shape', 'ms', 'call_ms', 'plain_ms', 'bound_ms', 'bound_by',
            'floor_ms', 'n_valid')},
        'library_ms': None,
        'by_input': {name: {key: value for key, value in row.items()
                            if key not in ('bytes', 'turns_ms')}
                     for name, row in {**nms_time, **trained}.items()},
    }]
    for name, (_, _, replaces) in BN_KERNELS.items():
        kernels.append({
            'name': name,
            'route': 'cuda',
            'source': 'single_shot_detection_tpu_torch/kernels/bn.cu',
            'replaces': replaces,
            'launches': cli_launches[name],
            'launches_by_path': {'train_step': bn_launches[name],
                                 'experiment': exp_launches[name],
                                 'cli': cli_launches[name]},
            'max_abs_err': bn_check[name],
            'shape': list(BN_TIMED_SHAPE),
            **bn_time[name],
            **step_profile[name],
            'library_step_ms': library_step[bn_time[name]['library_pair']],
        })
    log(json.dumps({'kernels': kernels}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': card,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
