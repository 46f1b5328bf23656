#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``single_shot_detection_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one.  Phases, each fatal:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build: every CUDA kernel (``nms.cu``, ``bn.cu``) from the sources in
   this checkout, one ``nvcc`` per source, started together;
3. kernels against their plain PyTorch versions on the card: exact keep
   masks for NMS (including invalid rows, identical boxes and IoU exactly
   at the threshold); the four train-mode BatchNorm kernels K1-K4 on the
   flagship's shapes at b32 from ``[32, 96, 150, 150]`` to
   ``[32, 128, 1, 1]``, a ragged ``[3, 24, 75, 75]`` and a bf16 case, at
   the tolerances stated at ``BN_TOL``;
4. the serving path: ``Predictor`` on ``samples/ssd_mb2_voc.py`` at full
   width with seeded random weights, answering 3 batches of 32 and 4 single
   requests, with launch counts read around that run; outputs checked for
   shape and finiteness, the forward against the CPU, and the kernel
   postprocessor against the plain one;
5. serving times: ``predict_batch`` img/s at b32 and b128, postprocess ms,
   the NMS kernel's time beside its plain version and its bound, and a
   profiler table of device time by operator at b32;
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
   step beside the step's bound, and a profiler table of one train step.

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as its
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

from single_shot_detection_tpu_torch.models.layers import BatchNorm
from single_shot_detection_tpu_torch.ops import bn_kernel
from single_shot_detection_tpu_torch.ops import nms as nms_ops
from single_shot_detection_tpu_torch.ops import nms_kernel
from single_shot_detection_tpu_torch.predict import Predictor
from single_shot_detection_tpu_torch.trainer import Trainer

FLAGSHIP = 'samples/ssd_mb2_voc.py'
SEED = 23

# HBM rate by card name (bytes/s), NVIDIA data sheets; H100 SXM otherwise.
HBM_RATE = [('H100 PCIe', 2.0e12), ('H100 NVL', 3.9e12), ('H200', 4.8e12),
            ('H100', 3.35e12)]
FP32_RATE = 67e12  # H100 SXM fp32 outside the tensor cores, dense

# fp32 operations per box pair in the NMS IoU test: 4 min/max, 2 sub,
# 2 clamp, 1 mul (intersection), 1 add + 1 sub (union), 1 div, 1 compare
NMS_OPS_PER_PAIR = 13


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


def kernels_device_ms(fn, kernel_names, iters: int) -> float:
    """Device time per call of ``fn``, summed over the CUDA kernels it
    launches (``kernel_names``, each once per call), from the profiler's
    CUPTI trace (events around back-to-back launches would time the host's
    enqueue instead when the host is the slower of the two)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for name in kernel_names:
        us, count = device_us(prof, name)
        if count != iters:
            fail(f'profiler saw {count} launches of {name}, expected {iters}')
        total += us
    return total / iters / 1e3


def device_us(prof, kernel_name: str):
    """(summed device µs, launches) of the kernels whose name contains
    ``kernel_name`` in a finished profile."""
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel_name in evt.key:
            total_us += getattr(evt, 'self_device_time_total', None) or \
                getattr(evt, 'self_cuda_time_total')
            count += evt.count
    return total_us, count


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


def host_median_ms(fn, iters: int, warmup: int = 3) -> float:
    return statistics.median(host_times_ms(fn, iters, warmup))


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


def check_nms_kernel(device: torch.device) -> dict:
    rng = np.random.RandomState(SEED)
    cases = [('flagship b32', 32 * 20, 100, 0.45),
             ('synthetic_smoke', 8 * 4, 20, 0.45),
             ('K=128', 96, 128, 0.45),
             ('K=200', 64, 200, 0.5),
             ('ragged N', 333, 100, 0.45),
             ('K=1500 scratch path', 5, 1500, 0.45)]
    worst = 0.0
    for name, n, k, thr in cases:
        boxes_np, scores_np, special = nms_problems(rng, n, k, thr)
        boxes = torch.from_numpy(boxes_np).to(device)
        scores = torch.from_numpy(scores_np).to(device)
        got = nms_kernel.nms_keep_batched(boxes, scores, thr)
        torch.cuda.synchronize()
        want = nms_ops.nms_keep_sorted(boxes, scores, thr)
        err = (got.int() - want.int()).abs().max().item()
        worst = max(worst, float(err))
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
        log(f'  nms {name}: N={n} K={k} thr={thr} exact '
            f'({int(got.sum())} kept)')
    return {'max_abs_err': worst}


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
        ms = host_median_ms(lambda: pred.predict_batch(imgs), iters=20)
        out[f'predict_batch_b{bs}_ms'] = ms
        out[f'predict_batch_b{bs}_img_per_s'] = bs * 1e3 / ms
    out['postprocess_b32_ms'] = cuda_ms(
        lambda: pred.postprocessor(heads['scores'], heads['locs'],
                                   pred.anchors), iters=50)
    with torch.inference_mode():
        x = pred.preprocess(torch.from_numpy(
            rng.randint(0, 256, (32, 300, 300, 3), dtype=np.uint8)).cuda())
        out['forward_b32_ms'] = cuda_ms(lambda: pred.model(x), iters=20)
    return out


def time_nms(pred: Predictor, heads: dict, card: str) -> dict:
    """The NMS kernel at the main path's inputs (b32), beside its plain
    version and its bound."""
    captured = {}
    original = pred.postprocessor.nms_keep

    def capture(boxes, scores):
        captured.update(boxes=boxes.clone(), scores=scores.clone())
        return original(boxes, scores)

    pred.postprocessor.nms_keep = capture
    pred.postprocessor(heads['scores'], heads['locs'], pred.anchors)
    del pred.postprocessor.nms_keep
    boxes, scores = captured['boxes'], captured['scores']
    thr = pred.postprocessor.overlap_threshold
    n, k = scores.shape
    launch = lambda: nms_kernel.nms_keep_batched(boxes, scores, thr)  # noqa: E731
    ms = kernels_device_ms(launch, ('nms_keep_kernel',), iters=100)
    call_ms = cuda_ms(launch, iters=200)
    plain_ms = cuda_ms(lambda: nms_ops.nms_keep_sorted(boxes, scores, thr),
                       iters=10)
    nbytes = boxes.numel() * 4 + scores.numel() * 4 + n * k  # bool out
    ops = NMS_OPS_PER_PAIR * n * k * (k - 1) / 2
    bytes_ms = nbytes / hbm_rate(card) * 1e3
    ops_ms = ops / FP32_RATE * 1e3
    log(f'  nms inputs from the b32 path: N={n} K={k}, '
        f'{int(torch.isfinite(scores).sum())} of {n * k} candidates valid')
    return {'shape': [n, k], 'ms': ms, 'call_ms': call_ms, 'plain_ms': plain_ms,
            'bound_ms': max(bytes_ms, ops_ms),
            'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
            'bytes': nbytes, 'ops': ops}


def profile_b32(pred: Predictor, rng) -> None:
    """Device time by operator over 5 b32 ``predict_batch`` calls."""
    from torch.profiler import ProfilerActivity, profile
    imgs = rng.randint(0, 256, (32, 300, 300, 3), dtype=np.uint8)
    for _ in range(3):
        pred.predict_batch(imgs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            pred.predict_batch(imgs)
        torch.cuda.synchronize()
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
    from torch.profiler import ProfilerActivity, profile
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append((args[0].numel(), args[0].shape[1])))
        for m in trainer.model.modules() if isinstance(m, BatchNorm)]
    trainer.train_step(*batch)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    if len(shapes) != n_bn:
        fail(f'{len(shapes)} BN calls in a step, expected {n_bn}')
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(*batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    out = {}
    for name, (cuda_names, _, _) in BN_KERNELS.items():
        total = 0.0
        for cuda_name in cuda_names:
            us, count = device_us(prof, cuda_name)
            if count != n_bn:
                fail(f'{cuda_name}: {count} launches in a profiled step, '
                     f'expected {n_bn}')
            total += us
        out[name] = {'step_ms': total / 1e3, 'step_bound_ms': sum(
            bn_bound_ms(name, e, c, card)[0] for e, c in shapes)}
    averages = prof.key_averages()
    busy_us = sum(getattr(e, 'self_device_time_total', 0) for e in averages
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    out['device_busy_ms'] = busy_us / 1e3
    out['profiled_step_wall_ms'] = wall_ms
    out['bn_elements_per_step'] = sum(e for e, _ in shapes)
    log(f'  profile of one train_step(32) with the BN kernels '
        f'({busy_us / 1e3:.3f} ms of device time in {wall_ms:.3f} ms of wall '
        f'time under the profiler):')
    log(averages.table(sort_by='self_cuda_time_total', row_limit=30,
                       max_name_column_width=60))
    return out


def main() -> int:
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
        for build in [pool.submit(m.build) for m in (nms_kernel, bn_kernel)]:
            build.result()
    log(f'[2] built the nms and bn kernels in {time.perf_counter() - t:.2f} s')

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
    nms_time = time_nms(pred, heads, card)
    log(f'[5] {smi}: ' + ', '.join(f'{k} {v:.4g}' for k, v in timing.items()))
    log(f'  nms kernel {nms_time["ms"] * 1e3:.2f} us/launch on the device, '
        f'{nms_time["call_ms"] * 1e3:.2f} us per wrapper call, at N,K='
        f'{nms_time["shape"]}; plain {nms_time["plain_ms"]:.3f} ms per call; '
        f'bound {nms_time["bound_ms"] * 1e3:.3f} us ({nms_time["bound_by"]})')
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

    log(json.dumps({'slice': {
        'card': smi, **timing, 'forward_vs_cpu_max_abs_err': forward_err,
        **train_timing,
        'train_losses': [m['loss'] for m in metrics],
        'bn_vs_library_loss_rel_err': library_check['loss_rel_err'],
        'bn_vs_library_stats_max_abs_err': library_check['stats_max_abs_err'],
        'train_step_device_busy_ms': step_profile['device_busy_ms'],
        'profiled_train_step_wall_ms': step_profile['profiled_step_wall_ms'],
        'bn_elements_per_step': step_profile['bn_elements_per_step']}}))
    kernels = [{
        'name': 'nms_keep_batched',
        'route': 'cuda',
        'source': 'single_shot_detection_tpu_torch/kernels/nms.cu',
        'replaces': 'single_shot_detection_tpu/ops/nms_pallas.py:33',
        'launches': launches,
        'max_abs_err': nms_check['max_abs_err'],
        'ms': nms_time['ms'],
        'call_ms': nms_time['call_ms'],
        'plain_ms': nms_time['plain_ms'],
        'bound_ms': nms_time['bound_ms'],
        'bound_by': nms_time['bound_by'],
        'library_ms': None,
    }]
    for name, (_, _, replaces) in BN_KERNELS.items():
        kernels.append({
            'name': name,
            'route': 'cuda',
            'source': 'single_shot_detection_tpu_torch/kernels/bn.cu',
            'replaces': replaces,
            'launches': bn_launches[name],
            'max_abs_err': bn_check[name],
            'shape': list(BN_TIMED_SHAPE),
            **bn_time[name],
            **step_profile[name],
        })
    log(json.dumps({'kernels': kernels}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': card,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
