#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``single_shot_detection_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one.  Phases, each fatal:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build: every CUDA kernel of the serving path, from the sources in this
   checkout;
3. kernels against their plain PyTorch versions on the card (exact keep
   masks for NMS, including invalid rows, identical boxes and IoU exactly
   at the threshold);
4. the serving path: ``Predictor`` on ``samples/ssd_mb2_voc.py`` at full
   width with seeded random weights, answering 3 batches of 32 and 4 single
   requests, with launch counts read around that run; outputs checked for
   shape and finiteness, the forward against the CPU, and the kernel
   postprocessor against the plain one;
5. times: ``predict_batch`` img/s at b32 and b128, postprocess ms, each
   kernel's time beside its plain version and its bound, and a profiler
   table of device time by operator at b32.

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

import numpy as np
import torch

from single_shot_detection_tpu_torch.ops import nms as nms_ops
from single_shot_detection_tpu_torch.ops import nms_kernel
from single_shot_detection_tpu_torch.predict import Predictor

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


def kernel_device_ms(fn, kernel_name: str, iters: int) -> float:
    """Device time per launch of the CUDA kernel named ``kernel_name`` when
    ``fn`` runs ``iters`` times, from the profiler's CUPTI trace (events
    around back-to-back launches would time the host's enqueue instead
    when the host is the slower of the two)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel_name in evt.key:
            total_us += getattr(evt, 'self_device_time_total', None) or \
                getattr(evt, 'self_cuda_time_total')
            count += evt.count
    if count != iters:
        fail(f'profiler saw {count} launches of {kernel_name}, expected {iters}')
    return total_us / count / 1e3


def host_median_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median host-clock ms of ``fn`` ending in a device synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


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
    ms = kernel_device_ms(launch, 'nms_keep_kernel', iters=100)
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

    # 2. build
    t = time.perf_counter()
    nms_kernel.build()
    log(f'[2] built nms kernel in {time.perf_counter() - t:.2f} s')

    # 3. kernels against their plain versions
    log('[3] kernels vs plain versions on the card')
    nms_check = check_nms_kernel(device)

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

    # 5. times
    timing = time_slice(pred, heads, rng)
    nms_time = time_nms(pred, heads, card)
    log(f'[5] {smi}: ' + ', '.join(f'{k} {v:.4g}' for k, v in timing.items()))
    log(f'  nms kernel {nms_time["ms"] * 1e3:.2f} us/launch on the device, '
        f'{nms_time["call_ms"] * 1e3:.2f} us per wrapper call, at N,K='
        f'{nms_time["shape"]}; plain {nms_time["plain_ms"]:.3f} ms per call; '
        f'bound {nms_time["bound_ms"] * 1e3:.3f} us ({nms_time["bound_by"]})')
    profile_b32(pred, rng)

    log(json.dumps({'slice': {'card': smi, **timing,
                              'forward_vs_cpu_max_abs_err':
                                  heads['forward_vs_cpu']}}))
    log(json.dumps({'kernels': [{
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
    }]}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': card,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
