#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``single_shot_detection_tpu_torch``).

    python3 chip_smoke.py [--parent-nms OTHER/kernels/nms.cu]
                          [--parent-bn OTHER/kernels/bn.cu]

Needs one CUDA card; exits non-zero without one.  ``--parent-nms`` builds
another version of the NMS kernel (say, from a ``git archive`` of an
earlier commit), calls its ``nms_keep_launch`` directly, and times it
beside this one in phase 5, in turns.  ``--parent-bn`` does the same for
K2 and K4 of another ``bn.cu`` with this one's C interface
(``bn_apply_launch``, ``bn_dx_launch``; the commit before their redesign;
a ``bn.cu`` of the two-pass reductions, which exports
``bn_partial_floats``, is refused): its K2 and K4 take the place of this
one's inside each profiled train step (phases 7, 12, 13 and the bf16 step
of 15) and at each shape of phase 14, in turns (parent, this, this,
parent), and each profiled step's wall time is taken in turns too.  The
parent's two launch symbols stand in for this build's on the loaded
library, so both sides run the same wrappers.
Phases, each fatal:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build: every CUDA kernel (``nms.cu``, ``bn.cu``) from the sources in
   this checkout, one ``nvcc`` per source, started together;
3. kernels against their plain PyTorch versions on the card: exact keep
   masks for NMS (including invalid
   rows, identical boxes, IoU exactly at the threshold and within 3 float
   steps of it, nothing suppressed, ``-inf`` scores in the middle, NaN and
   infinite coordinates, overflowing, tiny and zero areas, K = 1, 63, 64,
   65, 1500 and 2048); the four train-mode BatchNorm kernels K1-K4 on
   every distinct BN shape of the flagship's b32 step and on edge shapes
   (b = 1, C = 1, 1x1 planes, ``[64, 16, 300, 300]``, ragged, bf16 at odd
   S, inputs off a 16-byte boundary, bf16 planes of 1 and 4 elements into
   an f32 z; for K2's 16-byte vectors, vectors across plane boundaries at
   S = 5625, 1369, 361, 25 and 9 at f32 and bf16, C = 1 at odd S, 735
   elements, x 1-7 elements off a 16-byte boundary at bf16 and 1-3 at
   f32), at the tolerances stated at ``BN_TOL``, each kernel launched
   twice and bit-equal, K2 and K4 also on each of their paths (vector,
   lanes, scalar) into an output at x's phase; and the JAX package's
   gradients at a clamp's bound (``check_tie_rules``): ReLU6 at f32 and
   bf16, a box of zero width, the BCE on logits of 0, each on the card
   bit for bit against the CPU and against JAX's values;
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
   at ``[32, 96, 150, 150]`` beside its bound, its plain version, the one
   PyTorch call that computes its function (``LIBRARY_CALLS``:
   ``torch.batch_norm_stats``, ``batch_norm_elemt``,
   ``batch_norm_backward_reduce``, ``batch_norm_backward_elemt``) and the
   PyTorch pair that computes it with its partner (``native_batch_norm``
   for K1+K2, its backward for K3+K4), each kernel's device time summed
   over a step beside the step's bound and its own call summed over the
   step's 64 BN shapes, a profiler table of one train step, and the
   pairs' device time per step; the same readings for each profiled step
   of phases 12, 13 and 15, and at the end the steps on which a kernel
   took longer than its own call;
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
   one augmented train step;
10. the CLI in process (``cli.main``) on the flagship with ``fused_bn`` and
    synthetic 500 px data, 2 epochs with checkpoints, then a resume of its
    run directory in a fresh ``python -m single_shot_detection_tpu_torch``
    process, a save -> restore bit-equal on the card and their times;
11. the JAX package's committed checkpoint evaluated through the CLI on the
    card and on the CPU (loss within 1e-4 relative, mAP within 0.005), and
    NMS timed at that trained input;
12. the model zoo at the configs' b16 with seeded random weights:
    ``samples/retina_rn50_500_voc.py`` (500 px, 98 train-mode BNs, sigmoid
    over 20 classes) and ``samples/ssd_300_vgg16_voc.py`` (300 px, 21 BNs):
    3 ``predict_batch`` calls with the NMS count read around them, the
    forward at b2 against the CPU (heads and sources, ``ZOO_FORWARD_RTOL``)
    and the kernel postprocessor against the plain one; 3 ``fused_bn``
    train steps with the BN counts read around them (98 and 21 per step),
    one step against PyTorch's batch norm, the step in turns with and
    without the kernels, K1-K4 against their plain versions on every
    distinct BN shape of the step, each BN kernel's device time summed over
    a step beside the step's bound and the PyTorch pairs over the same
    shapes; RetinaNet through ``cli.main`` (one epoch on synthetic 500 px
    data, an evaluation and a checkpoint); and the NMS kernel at both
    serving inputs;
13. the rest of the zoo with seeded random weights, each at its config's
    input size and batch: ``samples/m2det_512_vgg16_voc.py`` (512 px, b8,
    150 train-mode BNs) and ``samples/ssd_sh2_voc.py`` (300 px, b32, 68),
    served and trained as in phase 12 (the BN counts 150 and 68 per step,
    K1-K4 against their plain versions on every distinct BN shape of both
    steps, the peak of ``torch.cuda.max_memory_allocated``; M2Det's running
    statistics against PyTorch's BN at ``LIBRARY_BN_STATS_TOL``, beside
    K1's batch variance on its 150 BN inputs against float64), M2Det through
    ``cli.main`` (one epoch of 4 b8 steps on synthetic 512 px data, an
    evaluation and a checkpoint); MobileNet v1 under the depthwise FPN with
    ``train.group_norm`` (``MBV1_DFPN_MODEL`` in the flagship's config):
    one b32 ``predict_batch`` and 2 b32 train steps with every BN kernel
    at 0 launches, the running statistics unwritten and the forward
    against the CPU; and the NMS kernel at both serving inputs, its keep
    masks equal to its plain version's (as at every input it is timed at);
14. K1 and K3 (f32), K2 and K4 (f32 and bf16) at every distinct BN
    shape of the five steps (each window repeating its inputs, so those
    that fit the L2 are warm): the grid or plan each launches, device µs
    per launch (with ``--parent-bn`` the parent's K2 and K4 in turns:
    parent, this, this, parent), the bound, the launch floor (an empty
    kernel on the same grid, block and cluster) and, for K2 and K4, their
    own PyTorch calls' device µs; each step's sums (count x µs); K1's
    and K3's split and scalar paths side by side at S = 361 and S = 5625;
    and with ``--parent-bn`` the host µs per call of the K2 and K4
    wrappers at ``HOST_SHAPE``, f32 and bf16, in turns with the parent's
    kernels;
15. bf16 and the precision options (``POLICIES``: f32 with TF32 off, f32
    with TF32, bf16 activations): the flagship's ``Predictor(bf16=True)``
    answering b32 and b128 batches (NMS launched twice, no BN), its heads
    on the card against the port's bf16 forward on the CPU (within twice
    the CPU's bf16-to-f32 distance), the NMS kernel exact on its inputs,
    ``predict_batch`` ms of the three policies in turns at b32 and b128;
    a profiler table of the bf16 b32 call; one soft-NMS b32 call (no NMS
    kernel launch; its pick mask on the card equal to the CPU's on the
    same inputs; the share of detection rows equal end to end) and its ms; the flagship's b32 train step with ``bf16`` and
    ``fused_bn`` (3 steps, each BN kernel launched 64 times a step; one
    step against PyTorch's BN at bf16, the loss within
    ``BF16_LIBRARY_LOSS_RTOL`` and the running statistics within
    ``BF16_STATS_FACTOR`` times their distance to the f32 step; K1-K4 at bf16 on the step's 30 distinct BN
    shapes within ``BN_TOL``, K1 and K3 bit-equal twice; each BN kernel's
    device time over the step beside its bf16 bound and the PyTorch pairs
    at bf16; each kernel per launch at ``BN_TIMED_SHAPE`` in bf16); that
    step and RetinaNet-ResNet50-500's b16 step at the three policies in
    turns, ms and device ms; and ``python -m single_shot_detection_tpu_torch
    --bf16`` (in process) for one synthetic epoch with an evaluation and a
    checkpoint (f32 on disk);
16. int8 serving and QAT (``export/quantize.py``) at ``INT8_POINTS``:
    SSD300-VGG16 at b32 and b128, the flagship at b128 and at b32 past the
    gate with an explicit ``int8`` block, each with seeded weights and
    perturbed BNs, calibrated on 2 batches: at VGG b32 and the flagship
    b128 every quantized conv's s32 accumulator on the card equal to the
    CPU's on the same int8 inputs, the card's int8 heads against the CPU's
    (``INT8_CARD_VS_CPU_SHARE``), the NMS kernel exact on the int8 inputs
    and the int8 call's device split (quantize, im2col, ``torch._int_mm``,
    dequant, float convs, NMS); at every point the NMS count around two
    int8 calls (no BN), the share of f32 detections an int8 one matches
    (``INT8_MATCH_IOU``, same class) and ``predict_batch`` ms in turns
    (f32, bf16, int8, int8, bf16, f32); the flagship's b32 step with
    ``train.qat`` (``QAT_STEPS`` steps, no kernel launched, ``act_amax``
    changing and finite, ms in turns against the float step) and an int8
    ``Predictor`` on its learned scales; the JAX checkpoint through
    ``--int8`` (mAP above 0.55);
17. ``train.transfer_ahead``: the flagship's augmented epoch (phase 8's
    data) at depths 0 and 2 in turns (0, 2, 2, 0), img/s, and the batch
    stream on the card equal at the two depths.
18. export (``export/__init__.py``): the CLI's ``eval export`` phases on
    the committed JAX checkpoint with a standalone ``export`` block, its
    artifact against the eager path on an eval batch, and
    ``tools/infer_exported.py`` on that batch's images in a fresh process
    (each image's printed rows against the artifact's own call, some
    detections required) while ``EXPORT_POINTS`` are exported: the
    flagship with ``torch.export`` (plain at b32, weights an input;
    standalone at b32 and b128, one experiment for the three; bf16
    standalone at b128) and SSD300-VGG16 standalone at int8 b32
    (calibrated on synthetic eval batches, past the gate), each loaded and
    held against the experiment's ``Predictor`` on the same inputs
    (``valid`` equal, values within ``EXPORT_TOL``), called under TF32-on
    flags that it must give back (an f32 program records TF32 off), its
    launches in one call (one NMS, none without the postprocessor, no BN),
    export and load seconds, file bytes; then each one's ms in turns
    against the eager call (eager, artifact, artifact, eager) and the
    standalone b32 call's split against eager (host ms with and without
    the module's input checks, device-busy ms, operators by CPU time);
    ``tools/serve.py::DynamicBatcher`` over that artifact, 64 images from
    8 threads (answers against the artifact's own call, mean batch fill,
    img/s); the HTTP server (``/healthz``, concurrent ``/detect`` uploads,
    ``/stats``, a bad upload) and the ``test`` phase on the JAX checkpoint
    (3 frames, headless).
19. structured channel pruning: ``samples/ssd_mb2_coco_pruning.py`` at
    full width through ``Experiment`` with seeded weights and perturbed
    BNs (its ``detector.weight`` placeholder and ``base.pretrained`` off),
    synthetic 300 px data at the config's b32, ``fused_bn`` and the
    shipped pruner with ``num`` at ``PRUNING_NUM``: two epochs of 3 masked
    steps, a prune before each, and an evaluation, with the kernels'
    counts read around them (each BN kernel 64 a step, NMS once an eval
    batch); every dead entry exactly 0 after the steps and the momentum
    finite; one more masked step with each BN's input and output gradient
    captured, K1's and K3's sums against float64 (within
    ``BN_TOL['reduce']`` of the sums of their terms' magnitudes: a trained
    pruned model's near-constant channels make the sums cancel), K2 and
    K4 against their plain versions at ``BN_TOL``, and y and dx exactly 0
    on the dead channels; ``materialize_pruned``
    (parameters before and after), the narrow model against the masked one
    at the heads and every backbone stage (``PRUNING_TOL`` of scale),
    both ``Predictor``s (``valid`` equal) and their ``predict_batch`` ms in
    turns at b32 and b128; the narrow standalone ``.pt2`` at b32 against
    the eager narrow call, one NMS launch a call; the committed JAX
    checkpoint pruned by ``PRUNING_JAX_NUM`` picks and evaluated masked and
    narrow (mAPs within ``PRUNING_MAP_TOL``);
20. the rest of the train path (``train/optimizers.py``, ``train/step.py``)
    on the flagship at full width, b32 with ``fused_bn``: (a) one update of
    each of the ten optimizers over the flagship's parameters from seeded
    gradients, on the card and on the CPU (warmup schedule, ``lr_scale``
    0.5, an ``lr_groups`` prefix, the global-norm clip active), each
    parameter within ``OPTIMIZER_TOL`` of its tensor's update plus its ulp;
    (b) ``Experiment.train()`` with ``OPTIONS_TRAIN`` (AdamW with
    ``lr_groups``, clipping, accumulation 2, EMA 0.999, mixup) and the
    soft-target CE and GIoU losses, 8 augmented micro-steps and an
    evaluation on the shadow: finite losses, each BN kernel 64 launches a
    micro-step, the parameters moved on every second micro-step only, the
    shadow apart from them, NMS launched by the evaluation, a ``.pt`` save
    restored bit for bit (shadow and accumulation state included); (c)
    ``frozen_bn``: no BN kernel launch, the running statistics bit-equal;
    (d) ``fused_steps`` 4 against 4 single steps under cudnn's
    deterministic algorithms: parameters, buffers, the shadow and the
    summed metrics bit-equal; (e) the step's ms in turns for SGD,
    AdamW, EMA on, a micro-step of accumulation 2 and ``fused_steps`` 4
    per step, and the optimizer's and the EMA's launches and host ms per
    step.
21. the data path and run extras on the flagship at full width (b32,
    ``fused_bn``) through ``Experiment`` with ``staging_colorspace=
    'yuv420'``, ``staging_cache``, ``device_cache`` (and so the eval replay
    cache), ``async_checkpoint`` and ``tensorboard`` at once, over the
    committed JPEG fixtures (``JPEG_FIXTURES``: 256 train and 64 eval
    entries), 3 epochs (the first fills the caches, the other two run
    from the card): each BN kernel 64 launches a step, NMS once an
    evaluation, the loaders staging the fill epoch's batches and one
    evaluation's only, and a cached against a streamed epoch in turns; (a) the port's JPEG decoder built
    from its source by the route the machine allows (``-ljpeg``, or the
    vendored libjpeg headers with Pillow's bundled libjpeg where there is
    no ``jpeglib.h``; the route printed), the fixtures staged to the
    committed digest (``data/jpeg_fixtures/staged_sha256.json``: RGB and
    YUV420 at 300, 150, 64 and 38 px) and bit-equal over two calls and at
    1 and 8 threads; a decoder that does not build, or a digest that
    differs, fails the phase; (b) ``yuv420_to_rgb`` on the
    card bit-equal to the CPU; (c) a cached epoch's batches bit-equal to
    the streamed loader's and copy's, and no host-to-device copy of image
    bytes in a cached epoch (the profiler's memcpy rows, against a streamed
    epoch's); (d) a replayed evaluation: no loader pass, NMS launched as in
    a streamed one, the same loss and mAP; (e) an async save held back
    while 8 steps run restores bit-equal to the state at the save; (f) the
    tensorboard event file's scalars equal ``log.csv``'s rows (or: not
    installed).  Times: loader img/s at b32, native and Python decode, RGB
    and YUV420; a batch's bytes and pinned copy ms; a decoding against a
    staging-cache epoch; the fill against the cached epochs; a streamed
    against a replayed evaluation, in turns; the loop's blocked ms for a
    synchronous against an async save; and both decode counts.
22. interop, at full width: the flagship's seeded weights written as the
    reference's torch checkpoint (``utils/torch_import.py``), imported
    through ``model.detector.torch_weight`` into an ``Experiment`` and
    served at b32: detections and ``valid`` bit-equal to the source
    model's, NMS launched; one b32 ``fused_bn`` step from the imported
    weights, each BN kernel launched once per BN; the committed JAX run
    through ``tools/export_torch_ckpt.py`` and ``torch_weight`` evaluated
    by the CLI: loss and mAP equal to phase 11's; a
    ``torchhub://pytorch/vision:mobilenet_v2`` backbone from a temporary
    hub cache, bit-equal to what was written; RetinaNet-500 with
    ``interpolation_mode='bilinear'`` at b2 against the CPU (heads and
    sources within ``ZOO_FORWARD_RTOL``); a keras ``.h5`` backbone where
    ``h5py`` imports (else a line says so).
23. data parallelism over processes (``parallel/mesh.py``), the flagship
    at full width, 300 px, seeded weights, in two rank processes
    (``chip_smoke.py --dp-worker``): NCCL with a card each where there are
    two cards, else gloo with both ranks on the one card (the line says
    which).  (a) one 2 x b16 step, the flagship's augmentation drawn for the
    global batch, against this process's 1 x b32 step on the same batch:
    the loss within 1e-4 relative, every parameter's update within
    ``DP_UPDATE_TOL`` of the step's largest, the BN running statistics
    within ``DP_STATS_RTOL``/``DP_STATS_ATOL``, the ranks bit-equal; (b)
    ``Experiment(process_count=2)`` for a short epoch on the committed JPEG
    fixtures and an evaluation: the NMS kernel launched on each rank
    (counted per rank), both ranks the same loss and mAP; (c) ZeRO-1 for
    one step with cuDNN deterministic, against the plain 2-rank step on the
    same batch: bit-equal, each rank's optimizer bytes against the plain
    run's; (d) the step's wall ms at 2 ranks, at 1 (b16 and b32), the
    gradient all-reduce's ms and share of the 2-rank step, and one BN's
    forward and backward at ``[16, 96, 150, 150]``, synchronised against
    PyTorch's.  A rank's failure, or a rank still running at
    ``DP_WALL_S``, ends the run.
24. the model axis (``parallel/tensor.py``, ``pipeline.py``,
    ``spatial.py``) in rank processes (``chip_smoke.py --ma-worker``):
    NCCL with a card each where there are four cards, else gloo with
    every rank on the one card (the line says which); the flagship at
    full width, 300 px, seeded weights, b32 a model group.  (a)
    ``tensor_sharding: 2``, one step against this process's one-process
    b32 step on the same batch: the loss, every update and the BN running
    statistics within phase 23's tolerances, the ranks' whole states
    (sliced leaves gathered) bit-equal with cuDNN deterministic, each
    rank's parameter bytes against the one-process model's, and the
    sliced-leaf count equal to JAX's rule; (b) ``pipeline_sharding:
    {'microbatches': 4, 'stages': 2}`` with ``frozen_bn``, one step against
    the one-process frozen-BN step; then M2Det-512 at full width with 4
    stages in four ranks at b4 in 2 microbatches: the pipelined forward
    within ``ZOO_FORWARD_RTOL`` of the one-process forward, and one step;
    (c) ``spatial_sharding: 2``, one step against the one-process step,
    every op's input a rank's own rows (``spatial.global_height`` checks
    it) and its window at most two rows past them; (d)
    ``Experiment(process_count=2)`` with each option for an epoch of one
    step on the committed JPEG fixtures and an evaluation: NMS launched on
    each rank (counted per rank), the ranks' loss and mAP equal, the train
    loss within 1e-4 and the evaluation's within ``MA_EVAL_RTOL``/
    ``MA_MAP_ATOL`` of the one-process run; (e) each
    option's step wall ms at 2 ranks against 1 process, and the bytes each
    moves a step (all-gathers and all-reduces, boundary buffers, halo
    rows), counted from the shapes.  A rank's failure, or a rank still
    running at ``MA_WALL_S``, ends the run.  ``python3 chip_smoke.py
    --model-axis-only`` builds the kernels and runs phase 24 alone.
25. the model axis's other phases in two rank processes (phase 24's
    ``--ma-worker``, NCCL with two cards, else gloo on one; the line says
    which): for each option of phase 24, ``Experiment(process_count=2)``
    on the flagship at full width (b32 a model group, seeded weights, the
    committed JPEG fixtures) with ``train.pruner`` (``MinL1Norm``, 4
    channels) and int8 forced, against one process in this one with cuDNN
    deterministic: (a) one step: every rank's dead set equal to one
    process's, the whole parameters and mask after the prune bit-equal,
    the dead entries still 0 after the step; (b) its int8 evaluation:
    ``int8: 1.0``, the ranks' loss and mAP equal and within
    ``MA_EVAL_RTOL``/``MA_MAP_ATOL`` of one process's, NMS counted per
    rank; (c) the export (standalone, int8, b32): only process 0 writes,
    and its artifact's outputs equal, bit for bit, those of one process's
    artifact exported from the run's gathered checkpoint with the same
    dead set (the same int8 amax first), NMS once a call; (d) the test
    phase on 3 fixture frames: NMS 3 times on process 0, 0 on the other;
    (e) each part's seconds.  K1-K4 stay at 0 on every rank.  A rank's
    failure, or a rank still running at ``MA_WALL_S``, ends the run.
    ``python3 chip_smoke.py --model-axis-phases-only`` builds the kernels
    and runs phase 25 alone.
26. the accuracy protocol's own arm (``tools/parity_run.py``): the
    low-variance protocol staged by the port's tool (512 train and 64
    eval synthetic JPEGs at 128 px), seed 23 of SSD-MobileNetV2-0.35
    trained from scratch through ``cli.main`` with ``train.fused_bn``:
    each BN kernel launched (BNs x steps) times, NMS once per eval batch,
    finite epoch losses, the mAP of ``log.csv`` in [0, 1]; the NMS kernel
    exactly against the plain version on the evaluation's first batch,
    K1-K4 at ``BN_TOL`` on every distinct b8 BN shape of the model at 128
    px; the run's minutes and steps per second.  Here the first
    ``PARITY_SHORT_EPOCHS`` epochs, the last epoch's loss below the
    first's; ``python3 chip_smoke.py --parity-only`` builds the kernels
    and runs the protocol's 60 epochs alone (``--parity-seed N``: another
    seed), its held-out mAP at least ``PARITY_MIN_MAP``.

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as its
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import csv
import ctypes
import functools
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from single_shot_detection_tpu_torch import cli
from single_shot_detection_tpu_torch.kernels import _build
from single_shot_detection_tpu_torch.models.layers import BatchNorm, set_sync_bn
from single_shot_detection_tpu_torch.ops import bn_kernel
from single_shot_detection_tpu_torch.ops import nms as nms_ops
from single_shot_detection_tpu_torch.ops import nms_kernel
from single_shot_detection_tpu_torch.data import transforms
from single_shot_detection_tpu_torch.predict import Predictor
from single_shot_detection_tpu_torch.train import checkpoint as ckpt
from single_shot_detection_tpu_torch.train import pruning
from single_shot_detection_tpu_torch.train.engine import (Experiment,
                                                         prefetch_to_device)
from single_shot_detection_tpu_torch.train.step import make_train_step
from single_shot_detection_tpu_torch.trainer import Trainer
from single_shot_detection_tpu_torch.utils.config import load_config

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
PROFILER_TRIES = 20


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


def group_us(prof, names):
    """(summed device µs, launches) of the kernels whose name contains any
    of ``names`` (one group: a wrapper's CUDA kernels) in a finished
    profile."""
    times = [device_us(prof, name) for name in names]
    return sum(t for t, _ in times), sum(n for _, n in times)


def profile_counted(run, groups, expected: int, missed: int = 0):
    """``profile_window(run)`` whose trace holds from ``expected - missed``
    to ``expected`` launches of each group of kernel names in ``groups``
    (a wrapper launches one of its group's kernels per call, which one by
    shape).  A window outside that range is printed and profiled again,
    ``PROFILER_TRIES`` windows at most; a count short of ``expected`` is
    printed."""
    for _ in range(PROFILER_TRIES):
        prof = profile_window(run)
        counts = {'/'.join(g): group_us(prof, g)[1] for g in groups}
        if all(expected - missed <= c <= expected for c in counts.values()):
            if any(c != expected for c in counts.values()):
                log(f'  profiler saw {counts} of {expected} launches')
            return prof
        log(f'  profiler saw {counts} of {expected} launches; profiling again')
    fail(f'profiler saw {counts} launches, expected {expected} of each')


def groups_device_ms(fn, groups, iters: int):
    """Device time per call of ``fn`` for each group of CUDA kernel names
    in ``groups`` (each group launched once per call), from the profiler's
    CUPTI trace (events around back-to-back launches would time the host's
    enqueue instead when the host is the slower of the two).  Each group's
    time is averaged over the launches the trace holds, which may fall
    short of ``iters`` by ``PROFILER_MISSED_LAUNCHES``."""
    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    prof = profile_counted(run, groups, iters, PROFILER_MISSED_LAUNCHES)
    return [us / count / 1e3 for us, count in
            (group_us(prof, g) for g in groups)]


def kernels_device_ms(fn, groups, iters: int) -> float:
    """``groups_device_ms`` summed over the groups."""
    return sum(groups_device_ms(fn, groups, iters))


def averages(prof):
    """``prof.key_averages()``, aggregated once per finished profile and
    kept on it: over a zoo step's trace each aggregation takes a large
    share of a second, and a step's readings ask for it a dozen times."""
    kept = getattr(prof, 'chip_smoke_averages', None)
    if kept is None:
        kept = prof.chip_smoke_averages = prof.key_averages()
    return kept


def device_us(prof, kernel_name: str):
    """(summed device µs, launches) of the kernels whose name contains
    ``kernel_name`` in a finished profile."""
    total_us, count = 0.0, 0
    for evt in averages(prof):
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
    return sum(e.self_device_time_total for e in averages(prof)
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False))


def busy_launches(prof) -> int:
    """The launches of ``busy_us``'s kernels, copies and fills."""
    return sum(e.count for e in averages(prof)
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


# The distinct BN input shapes [C, H, W] of each path's train step with
# their counts per step, and the step's batch; each profiled step's shapes
# are held against these (phases 7, 12 and 13), and phase 3 and phase 14
# run the kernels on them.
STEP_BN_SHAPES = {
    'flagship': (32, {
        (96, 150, 150): 1, (144, 75, 75): 3, (32, 150, 150): 2,
        (96, 75, 75): 1, (16, 150, 150): 1, (192, 37, 37): 5,
        (144, 37, 37): 1, (576, 18, 18): 5, (24, 75, 75): 2, (384, 18, 18): 8,
        (1280, 9, 9): 1, (960, 9, 9): 6, (192, 18, 18): 1, (576, 9, 9): 1,
        (32, 37, 37): 3, (96, 18, 18): 3, (320, 9, 9): 1, (64, 18, 18): 4,
        (256, 9, 9): 1, (160, 9, 9): 3, (512, 5, 5): 1, (256, 5, 5): 1,
        (128, 5, 5): 1, (256, 3, 3): 1, (128, 3, 3): 2, (256, 2, 2): 1,
        (128, 2, 2): 1, (64, 2, 2): 1, (128, 1, 1): 1, (64, 1, 1): 1}),
    'sh2': (32, {
        (24, 150, 150): 1, (58, 75, 75): 1, (116, 38, 38): 1,
        (1024, 10, 10): 1, (58, 38, 38): 12, (232, 19, 19): 1,
        (116, 19, 19): 25, (24, 38, 38): 1, (232, 10, 10): 13,
        (128, 10, 10): 1, (256, 5, 5): 1, (128, 5, 5): 2, (256, 3, 3): 1,
        (128, 3, 3): 2, (256, 2, 2): 1, (128, 2, 2): 1, (64, 2, 2): 1,
        (128, 1, 1): 1, (64, 1, 1): 1}),
    'retina': (16, {
        (64, 250, 250): 1, (256, 125, 125): 4, (512, 63, 63): 5,
        (128, 125, 125): 1, (1024, 32, 32): 7, (256, 63, 63): 10,
        (64, 125, 125): 6, (512, 32, 32): 1, (2048, 16, 16): 4,
        (128, 63, 63): 7, (256, 32, 32): 20, (512, 16, 16): 5,
        (256, 16, 16): 9, (256, 8, 8): 9, (256, 4, 4): 9}),
    'vgg': (16, {
        (64, 300, 300): 2, (128, 150, 150): 2, (256, 75, 75): 3,
        (512, 37, 37): 3, (512, 18, 18): 3, (256, 18, 18): 1, (512, 9, 9): 1,
        (128, 9, 9): 1, (256, 5, 5): 1, (128, 5, 5): 1, (256, 3, 3): 1,
        (128, 3, 3): 1, (256, 2, 2): 1}),
    'm2det': (8, {
        (64, 512, 512): 2, (128, 256, 256): 2, (256, 128, 128): 3,
        (512, 64, 64): 4, (768, 32, 32): 1, (128, 64, 64): 15,
        (512, 32, 32): 3, (256, 32, 32): 16, (128, 32, 32): 8,
        (256, 16, 16): 16, (128, 16, 16): 8, (256, 8, 8): 16, (128, 8, 8): 8,
        (256, 4, 4): 16, (128, 4, 4): 8, (256, 2, 2): 16, (128, 2, 2): 8}),
}


def step_bn_shapes(key: str):
    """``{(B, C, H, W): count}`` of path ``key``'s train step."""
    batch, shapes = STEP_BN_SHAPES[key]
    return {(batch, *shape): n for shape, n in shapes.items()}


class BnCase(NamedTuple):
    """A shape the BN kernels are held on: activations in ``dtype``, x and
    dz ``offsets`` elements past the start of their allocations, K2's z in
    ``out_dtype`` (default: x's)."""
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    offsets: Tuple[int, int] = (0, 0)
    out_dtype: Optional[torch.dtype] = None


def elementwise_boundary_cases():
    """K2's and K4's 16-byte vectors across plane boundaries at S = 5625,
    1369, 361, 25 and 9, at f32 and bf16; C = 1 at odd S; a total that is
    not a multiple of 8; x 1-7 elements off a 16-byte boundary at bf16 and
    1-3 at f32 (``check_bn_kernels`` also runs K2 and K4 into an output at
    x's phase, so the vector path takes a head and a tail)."""
    shapes = ((8, 24, 75, 75), (8, 32, 37, 37), (32, 116, 19, 19),
              (32, 128, 5, 5), (32, 128, 3, 3))
    cases = [BnCase(f'{label} across planes at S = {h * w}', (b, c, h, w), dtype)
             for b, c, h, w in shapes
             for label, dtype in (('f32', torch.float32),
                                  ('bf16', torch.bfloat16))]
    cases += [BnCase(f'C = 1 at S = 1369, {label}', (16, 1, 37, 37), dtype)
              for label, dtype in (('f32', torch.float32),
                                   ('bf16', torch.bfloat16))]
    cases += [BnCase(f'735 elements, {label}', (3, 5, 7, 7), dtype)
              for label, dtype in (('f32', torch.float32),
                                   ('bf16', torch.bfloat16))]
    cases += [BnCase(f'bf16 x {k} elements off', (4, 24, 19, 19),
                     torch.bfloat16, (k, k)) for k in range(1, 8)]
    cases += [BnCase(f'f32 x {k} elements off', (4, 24, 19, 19),
                     torch.float32, (k, k)) for k in range(1, 4)]
    return cases


# Every distinct BN shape of the flagship's b32 step, then edge shapes: b =
# 1, C = 1, 1x1 planes, a channel of 5.76M elements (704 blocks combined by
# ticket), ragged, bf16 at odd and even S, inputs off a 16-byte boundary
# (alike and unlike, so K3 takes its scalar path), bf16 planes shorter than
# a 16-byte vector of 8 elements into an f32 z, and the elementwise passes'
# boundary cases
BN_CASES = [BnCase(f'flagship {list(shape)}', shape, torch.float32)
            for shape in step_bn_shapes('flagship')] + [
    BnCase('b = 1', (1, 96, 150, 150), torch.float32),
    BnCase('C = 1', (32, 1, 150, 150), torch.float32),
    BnCase('1x1 planes', (32, 1024, 1, 1), torch.float32),
    BnCase('a channel of 5.76M', (64, 16, 300, 300), torch.float32),
    BnCase('ragged', (3, 24, 75, 75), torch.float32),
    BnCase('bf16', (8, 96, 75, 75), torch.bfloat16),
    BnCase('bf16 at S = 361', (32, 116, 19, 19), torch.bfloat16),
    BnCase('bf16 at S = 5625', (8, 58, 75, 75), torch.bfloat16),
    BnCase('bf16 at S = 25', (32, 256, 5, 5), torch.bfloat16),
    BnCase('x and dz 1 element off', (32, 58, 38, 38), torch.float32, (1, 1)),
    BnCase('x 2 elements off, dz not', (32, 116, 19, 19), torch.float32, (2, 0)),
    BnCase('x 3 elements off at S = 9', (32, 128, 3, 3), torch.float32, (3, 3)),
    BnCase('bf16 1x1 into f32', (32, 128, 1, 1), torch.bfloat16,
           out_dtype=torch.float32),
    BnCase('bf16 2x2 into f32', (32, 256, 2, 2), torch.bfloat16,
           out_dtype=torch.float32),
    BnCase('bf16 2x2 at b8 into f32', (8, 64, 2, 2), torch.bfloat16,
           out_dtype=torch.float32),
] + elementwise_boundary_cases()
BN_TIMED_SHAPE = (32, 96, 150, 150)
BN_EPS = 1e-5
# Tolerances of the BN kernels against their plain versions on the same
# inputs, as a fraction of max(1, |largest reference value|): reductions
# (K1, K3) sum up to 720,000 f32 values in another order; elementwise passes
# (K2, K4) round each operation as the plain version does, so they differ
# only where a bf16 output rounds (one bf16 step, 2**-8).
BN_TOL = {'reduce': 1e-4, 'elementwise': 1e-5, 'elementwise_bf16': 2.0 ** -8}
# CUDA kernels behind each wrapper (each call launches one of them: the
# reductions take their narrow kernel for planes under 32 elements) and the
# bytes each wrapper must move per element of x in f32: x read once (K1), x
# read and z written (K2), dz and x read (K3), dz and x read and dx written
# (K4).
BN_KERNELS = {
    'bn_stats': (('bn_stats_kernel', 'bn_stats_narrow_kernel'), 4,
                 'single_shot_detection_tpu/ops/bn_pallas.py:78'),
    'bn_apply': (('bn_apply_kernel',), 8,
                 'single_shot_detection_tpu/ops/bn_pallas.py:94'),
    'bn_grad_sums': (('bn_grad_sums_kernel', 'bn_grad_sums_narrow_kernel'),
                     8, 'single_shot_detection_tpu/ops/bn_pallas.py:101'),
    'bn_dx': (('bn_dx_kernel',), 12,
               'single_shot_detection_tpu/ops/bn_pallas.py:118'),
}
# The reductions K1 and K3
REDUCTIONS = ('bn_stats', 'bn_grad_sums')
# the empty kernels on K1's, K3's, K2's and K4's grids (their launch floors)
FLOOR_KERNELS = {'bn_stats': ('bn_floor_kernel<0>',),
                 'bn_grad_sums': ('bn_floor_kernel<1>',),
                 'bn_apply': ('bn_floor_kernel<2>',),
                 'bn_dx': ('bn_floor_kernel<3>',)}
# The one PyTorch call that computes each kernel's function (the calls
# SyncBatchNorm is built on; CUDA only), and the pair that computes two
LIBRARY_CALLS = {'bn_stats': 'torch.batch_norm_stats',
                 'bn_apply': 'torch.batch_norm_elemt',
                 'bn_grad_sums': 'torch.batch_norm_backward_reduce',
                 'bn_dx': 'torch.batch_norm_backward_elemt'}
LIBRARY_PAIRS = {'bn_stats': 'K1+K2', 'bn_apply': 'K1+K2',
                 'bn_grad_sums': 'K3+K4', 'bn_dx': 'K3+K4'}
# f32 operations per element: K1 add, mul, add; K2 sub, mul, mul, add;
# K3 add, sub, mul, mul, add; K4 sub, mul, sub, mul, sub, mul
BN_OPS_PER_ELEMENT = {'bn_stats': 3, 'bn_apply': 4, 'bn_grad_sums': 5,
                      'bn_dx': 6}


def on_card(t: torch.Tensor, dtype, offset: int = 0) -> torch.Tensor:
    """``t`` on the card in ``dtype``, contiguous, its element 0 ``offset``
    elements past the start of its allocation."""
    flat = torch.empty(t.numel() + offset, dtype=dtype, device='cuda')
    return flat[offset:].view(t.shape).copy_(t)


def bn_inputs(shape, dtype, generator, offsets=(0, 0)):
    c = shape[1]
    x = on_card(torch.randn(shape, generator=generator) * 2 + 0.3, dtype,
                offsets[0])
    dz = on_card(torch.randn(shape, generator=generator), dtype, offsets[1])
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


def plan_text(plan: dict) -> str:
    """``bn_kernel.reduce_plan``'s grid in a few words."""
    combine = ({'cluster': f', clusters of {plan["blocks_per_channel"]}',
                'ticket': f', {plan["blocks_per_channel"]} a channel by '
                          'ticket'}.get(plan['combine'], ''))
    return (f'{plan["path"]} {plan["blocks"]}x{plan["threads"]}' + combine)


def elementwise_text(plan: dict) -> str:
    """``bn_kernel.elementwise_plan``'s launch in a few words."""
    return (f'{plan["path"]} {plan["blocks"]}x{plan["threads"]}, '
            f'{plan["vector"]} x {plan["unroll"]} elements a thread, '
            f'{plan["vectors_per_block"]} vectors a block'
            + (f', head {plan["head"]} tail {plan["tail"]}'
               if plan['head'] or plan['tail'] else ''))


def bit_equal_twice(fn, label: str):
    """``fn()`` (a tuple of tensors) launched twice on the same inputs:
    the two results equal bit for bit (no atomics in the sums)."""
    first, second = fn(), fn()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail(f'{label}: two launches on the same input differ')
    return first


def elementwise_paths(kernel: str, x, dz=None, out=None):
    """The paths K2 (``kernel='bn_apply'``) or K4 (``'bn_dx'``) takes on
    these inputs into ``out``, of vector, lanes and scalar."""
    paths = []
    for path in ('vector', 'lanes', 'scalar'):
        try:
            bn_kernel.elementwise_plan(kernel, x, dz, path=path, out=out)
        except ValueError:
            continue
        paths.append(path)
    return tuple(paths)


def check_elementwise(kernel: str, wrapper, want, out, kind: str, label: str,
                      **inputs):
    """K2 or K4 through its wrapper, launched twice and bit-equal, then on
    each of its paths into ``out`` (at x's phase): the largest error
    against the plain version's ``want`` (within ``BN_TOL[kind]``) and
    those paths."""
    got = bit_equal_twice(lambda: (wrapper(),), label)[0]
    paths = elementwise_paths(kernel, inputs['x'], inputs.get('dz'), out)
    return max(bn_err(got, want, kind), *(
        bn_err(bn_kernel.elementwise_launcher(kernel, path=path, out=out,
                                              **inputs)(), want, kind)
        for path in paths)), paths


def check_bn_kernels(cases=BN_CASES, quiet: bool = False) -> dict:
    """K1-K4 against their plain versions on the same inputs; K2 and K4 are
    given the plain K1 and K3 outputs, so each check isolates one kernel;
    each launched twice, bit-equal; K2 and K4 also on each of their paths
    into an output at x's phase (``check_elementwise``).  ``cases``:
    ``BnCase``s; ``quiet`` logs only the worst errors."""
    gen = torch.Generator().manual_seed(SEED + 2)
    worst = {name: 0.0 for name in BN_KERNELS}
    for name, shape, dtype, offsets, out_dtype in cases:
        out_dtype = out_dtype or dtype
        x, dz, scale, bias = bn_inputs(shape, dtype, gen, offsets)
        got = bit_equal_twice(lambda: bn_kernel.bn_stats(x, BN_EPS),
                              f'K1 on {name}')
        want = bn_kernel.bn_stats_plain(x, BN_EPS)
        torch.cuda.synchronize()
        worst['bn_stats'] = max(worst['bn_stats'], *(
            bn_err(g, w, 'reduce') for g, w in zip(got, want)))
        mean, _, rstd = want
        k2_err, k2_paths = check_elementwise(
            'bn_apply',
            lambda: bn_kernel.bn_apply(x, mean, rstd, scale, bias, out_dtype),
            bn_kernel.bn_apply_plain(x, mean, rstd, scale, bias, out_dtype),
            on_card(torch.zeros(shape), out_dtype, offsets[0]),
            elementwise_tol(out_dtype), f'K2 on {name}', x=x, mean=mean,
            rstd=rstd, scale=scale, bias=bias)
        got = bit_equal_twice(
            lambda: bn_kernel.bn_grad_sums(dz, x, mean, rstd, scale),
            f'K3 on {name}')
        want = bn_kernel.bn_grad_sums_plain(dz, x, mean, rstd, scale)
        worst['bn_grad_sums'] = max(worst['bn_grad_sums'], *(
            bn_err(g, w, 'reduce') for g, w in zip(got, want)))
        coef = want[2]
        k4_err, k4_paths = check_elementwise(
            'bn_dx', lambda: bn_kernel.bn_dx(dz, x, mean, rstd, coef),
            bn_kernel.bn_dx_plain(dz, x, mean, rstd, coef),
            on_card(torch.zeros(shape), dtype, offsets[0]),
            elementwise_tol(dtype), f'K4 on {name}', x=x, dz=dz, mean=mean,
            rstd=rstd, coef=coef)
        worst['bn_apply'] = max(worst['bn_apply'], k2_err)
        worst['bn_dx'] = max(worst['bn_dx'], k4_err)
        torch.cuda.synchronize()
        if not quiet:
            plan = bn_kernel.reduce_plan('bn_grad_sums', x, dz)
            log(f'  bn {name}: {list(shape)} {str(dtype)[6:]}'
                + (f' into {str(out_dtype)[6:]}' if out_dtype != dtype else '')
                + f' within tolerance, each kernel bit-equal twice (K3 '
                f'{plan_text(plan)}; K2 '
                + elementwise_text(bn_kernel.elementwise_plan(
                    'bn_apply', x, out_dtype=out_dtype))
                + '; K4 ' + elementwise_text(bn_kernel.elementwise_plan(
                    'bn_dx', x, dz)) + f'; at the phase of x K2 on '
                f'{", ".join(k2_paths)}, K4 on {", ".join(k4_paths)})')
        del x, dz
    log('  bn max abs err: ' + ', '.join(f'{k} {v:.3g}' for k, v in worst.items()))
    return worst


def elementwise_tol(dtype) -> str:
    """``BN_TOL``'s key for an elementwise output in ``dtype``."""
    return 'elementwise_bf16' if dtype == torch.bfloat16 else 'elementwise'


def bn_bound_ms(name: str, elements: int, channels: int, card: str,
                itemsize: int = 4) -> Tuple[float, str]:
    """Least time for one launch of BN kernel ``name`` on ``elements``
    values of ``itemsize`` bytes (4: f32, 2: bf16; statistics f32) in
    ``channels`` channels, and what bounds it."""
    per_channel_bytes = {'bn_stats': 12, 'bn_apply': 16, 'bn_grad_sums': 32,
                         'bn_dx': 20}[name]
    nbytes = (BN_KERNELS[name][1] * itemsize // 4 * elements
              + per_channel_bytes * channels)
    bytes_ms = nbytes / hbm_rate(card) * 1e3
    ops_ms = BN_OPS_PER_ELEMENT[name] * elements / FP32_RATE * 1e3
    return max(bytes_ms, ops_ms), 'bytes' if bytes_ms >= ops_ms else 'operations'


def library_calls(x, dz, scale, bias, mean, rstd,
                  names=tuple(LIBRARY_CALLS)) -> dict:
    """The one PyTorch call of each BN kernel of ``names``
    (``LIBRARY_CALLS``) on these inputs, with f32 statistics and
    parameters: a callable, or the first line of the error with which the
    call refused the inputs (they are never cast).  K4's call takes the
    sums K3 computes, here in f32 from the plain arithmetic, and the count
    per channel."""
    if 'bn_dx' in names:
        dims = [0] + list(range(2, x.dim()))
        per_channel = (1, -1) + (1,) * (x.dim() - 2)
        g = dz.float()
        sum_dy = g.sum(dims)
        sum_dy_xmu = (g * (x.float() - mean.view(per_channel))).sum(dims)
        count = torch.full((1,), x.numel() // x.shape[1], dtype=torch.int32,
                           device=x.device)
    calls = {
        'bn_stats': lambda: torch.batch_norm_stats(x, BN_EPS),
        'bn_apply': lambda: torch.batch_norm_elemt(x, scale, bias, mean, rstd,
                                                   BN_EPS),
        'bn_grad_sums': lambda: torch.batch_norm_backward_reduce(
            dz, x, mean, rstd, scale, True, True, True),
        'bn_dx': lambda: torch.batch_norm_backward_elemt(
            dz, x, mean, rstd, scale, sum_dy, sum_dy_xmu, count),
    }
    out = {}
    for name in names:
        call = calls[name]
        try:
            call()
            torch.cuda.synchronize()
            out[name] = call
        except RuntimeError as err:
            out[name] = f'refused: {str(err).splitlines()[0]}'
    return out


def library_fields(name: str, ms) -> dict:
    """``library_ms`` (``None`` where the call refused the inputs) and the
    call's name, with its refusal."""
    return {'library_ms': ms if isinstance(ms, float) else None,
            'library_call': LIBRARY_CALLS[name],
            **({} if isinstance(ms, float) else {'library_refused': ms})}


def library_text(k: dict) -> str:
    """``library_fields``'s call and time (or refusal) in a few words."""
    return (f'{k["library_call"]} ' + (f'{k["library_ms"] * 1e3:.2f} us'
                                       if k['library_ms'] is not None
                                       else k['library_refused']))


def time_bn_kernels(card: str, dtype=torch.float32) -> dict:
    """Each BN kernel at ``BN_TIMED_SHAPE`` with activations in ``dtype``:
    device time per launch, the plain version's time, the bound, the one
    PyTorch call that computes the same function (``library_calls``) and
    the PyTorch pair that computes it with its partner
    (``torch.native_batch_norm`` and its backward)."""
    x, dz, scale, bias = bn_inputs(BN_TIMED_SHAPE, dtype,
                                   torch.Generator().manual_seed(SEED + 3))
    mean, _, rstd = bn_kernel.bn_stats(x, BN_EPS)
    _, _, coef = bn_kernel.bn_grad_sums(dz, x, mean, rstd, scale)
    calls = {
        'bn_stats': (lambda: bn_kernel.bn_stats(x, BN_EPS),
                     lambda: bn_kernel.bn_stats_plain(x, BN_EPS)),
        'bn_apply': (lambda: bn_kernel.bn_apply(x, mean, rstd, scale, bias),
                     lambda: bn_kernel.bn_apply_plain(x, mean, rstd, scale,
                                                      bias, dtype)),
        'bn_grad_sums': (lambda: bn_kernel.bn_grad_sums(dz, x, mean, rstd, scale),
                         lambda: bn_kernel.bn_grad_sums_plain(dz, x, mean, rstd,
                                                              scale)),
        'bn_dx': (lambda: bn_kernel.bn_dx(dz, x, mean, rstd, coef),
                  lambda: bn_kernel.bn_dx_plain(dz, x, mean, rstd, coef)),
    }
    library = library_calls(x, dz, scale, bias, mean, rstd)
    elements, channels = x.numel(), x.shape[1]
    out = {}
    for name, (kernel, plain) in calls.items():
        bound, bound_by = bn_bound_ms(name, elements, channels, card,
                                      x.element_size())
        own = library[name]
        out[name] = {'ms': kernels_device_ms(kernel, [BN_KERNELS[name][0]], 20),
                     'plain_ms': cuda_ms(plain, iters=5),
                     'bound_ms': bound, 'bound_by': bound_by,
                     **library_fields(name, cuda_ms(own, iters=20)
                                      if callable(own) else own)}
    # the library pairs: native batch norm forward (K1 + K2) and backward
    # (K3 + K4), timed once per pair
    fwd = lambda: torch.native_batch_norm(x, scale, bias, None, None, True,  # noqa: E731
                                          0.0, BN_EPS)
    _, save_mean, save_invstd = fwd()
    bwd = lambda: torch.ops.aten.native_batch_norm_backward(  # noqa: E731
        dz, x, scale, None, None, save_mean, save_invstd, True, BN_EPS,
        [True, True, True])
    pairs = {'K1+K2': cuda_ms(fwd, iters=20), 'K3+K4': cuda_ms(bwd, iters=20)}
    for name, pair in LIBRARY_PAIRS.items():
        out[name].update(library_pair=pair, library_pair_ms=pairs[pair])
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


def parent_nms_launcher(lib: ctypes.CDLL, boxes: torch.Tensor,
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
    """The NMS kernel's keep mask at each input, exactly equal to its plain
    version's, and its device time per launch beside the launch floor (an
    empty kernel on the same grid), the plain version and the bound; with
    ``parent`` (another build of ``nms.cu``, from :func:`load_parent_nms`)
    that kernel too, in turns (parent, this, this, parent), after checking
    that it gives the same keep mask."""
    out = {}
    for name, (boxes, scores) in inputs.items():
        n, k = scores.shape

        def launch():
            return nms_kernel.nms_keep_batched(boxes, scores, thr)

        if not torch.equal(launch(), nms_ops.nms_keep_sorted(boxes, scores,
                                                             thr)):
            fail(f'the NMS kernel differs from its plain version on {name}')

        def device_ms(fn, kernel='nms_keep_kernel'):
            return kernels_device_ms(fn, [(kernel,)], iters=100)

        row = {'shape': [n, k], **nms_bound(scores, card),
               'kept_mean': launch().sum(dim=1).double().mean().item()}
        if parent is not None:
            parent_launch = parent_nms_launcher(parent, boxes, scores, thr)
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
    log(averages(prof).table(sort_by='self_cuda_time_total', row_limit=25,
                                  max_name_column_width=60))


# ---------------------------------------------------------------- phase 6

TRAIN_STEPS = 5


def train_batch(rng: np.random.RandomState, b: int = 32, g: int = 8,
                size: int = 300):
    """Seeded uint8 images at ``size`` square and 1..g synthetic GT boxes
    each, classes 1..20."""
    images = rng.randint(0, 256, (b, size, size, 3), dtype=np.uint8)
    xy = rng.rand(b, g, 2) * size * 2 / 3
    wh = rng.rand(b, g, 2) * size * 0.3 + size / 30
    cls = rng.randint(1, 21, (b, g, 1))
    boxes = np.concatenate([xy, xy + wh, cls, np.ones((b, g, 1))], -1)
    mask = np.arange(g)[None, :] < rng.randint(1, g + 1, (b, 1))
    return images, boxes.astype(np.float32), mask


def build_trainer(fused_bn: bool, config: str = FLAGSHIP, **policy) -> Trainer:
    """``policy``: ``bf16`` and ``matmul_precision`` as ``Trainer`` takes
    them."""
    return Trainer.from_config(config, device='cuda', seed=SEED, overrides={
        'augmentations': [], 'train': {'fused_bn': fused_bn}}, **policy)


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
        if count != n_bn * len(metrics):
            fail(f'{name} launched {count} times in {len(metrics)} steps, '
                 f'expected {n_bn} train-mode BNs x {len(metrics)}')


def check_against_library_bn(trainer: Trainer, batch,
                             config: str = FLAGSHIP,
                             stats_tol: float = 1e-4) -> dict:
    """One step from the same state with the kernels (``fused_bn`` on) and
    with PyTorch's batch norm (off): loss within 1e-4 relative, BN running
    statistics within ``stats_tol`` of max(1, |value|)."""
    library = build_trainer(False, config)
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
            if not err <= stats_tol * max(1.0, want[name].abs().max().item()):
                fail(f'{name}: BN kernels vs PyTorch BN differ by {err}')
            stats_err = max(stats_err, err)
    log(f'  one step, BN kernels vs PyTorch BN: loss {on:.6f} vs {off:.6f} '
        f'(rel {loss_rel:.3g}, tol 1e-4); running statistics max abs err '
        f'{stats_err:.3g} (tol {stats_tol} of max(1, |value|))')
    return {'library': library, 'loss_rel_err': loss_rel,
            'stats_max_abs_err': stats_err}


# ---------------------------------------------------------------- phase 7

def time_train_steps(kernels: Trainer, library: Trainer, batch,
                     iters: int = 8) -> dict:
    """The train step, BN kernels vs PyTorch BN, in turns (on, off, off,
    on; ``iters`` steps each after 2 warm-up steps), median per side."""
    times = {'on': [], 'off': []}
    for side in ('on', 'off', 'off', 'on'):
        trainer = kernels if side == 'on' else library
        times[side] += host_times_ms(lambda: trainer.train_step(*batch),
                                     iters=iters, warmup=2)
    b = len(batch[0])
    out = {}
    for side, key in (('on', 'fused_bn'), ('off', 'library_bn')):
        ms = statistics.median(times[side])
        out[f'train_step_b{b}_{key}_ms'] = ms
        out[f'train_step_b{b}_{key}_img_per_s'] = b * 1e3 / ms
        out[f'train_step_b{b}_{key}_all_ms'] = times[side]
    return out


def profile_train_step(trainer: Trainer, batch, n_bn: int, card: str,
                       key: str, table: bool = True, parent_bn=None,
                       itemsize: int = 4) -> dict:
    """One profiled train step of path ``key``: its BN shapes held against
    ``STEP_BN_SHAPES``, each BN kernel's device time in the step beside its
    bound for the step's shapes, the card's busy time, (with ``table``) the
    table of device time by operator, and (with ``parent_bn``) the kernels
    of ``ELEMENTWISE`` and the step's wall time in turns against the
    parent build (``bn_step_turns``)."""
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
    if collections.Counter(shapes) != step_bn_shapes(key):
        fail(f'the {key} step\'s BN shapes {collections.Counter(shapes)} differ '
             f'from STEP_BN_SHAPES')
    walls = []

    def step():
        t = time.perf_counter()
        trainer.train_step(*batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)

    prof = profile_counted(step, [cuda_names for cuda_names, _, _ in
                                  BN_KERNELS.values()], n_bn)
    wall_ms = walls[-1]
    out = {}
    for name, (cuda_names, _, _) in BN_KERNELS.items():
        total = group_us(prof, cuda_names)[0]
        out[name] = {'step_ms': total / 1e3, 'step_bound_ms': sum(
            bn_bound_ms(name, math.prod(s), s[1], card, itemsize)[0]
            for s in shapes)}
    busy_ms = busy_us(prof) / 1e3
    out['device_busy_ms'] = busy_ms
    out['profiled_step_wall_ms'] = wall_ms
    if parent_bn is not None:
        turns = bn_step_turns(step, parent_bn, n_bn)
        for name, kernel in turns['kernels'].items():
            out[name]['turns'] = kernel
        out['parent_wall'] = turns['wall']
        wall = turns['wall']
        log(f'  the step with this build\'s {"/".join(ELEMENTWISE)} and the '
            f'parent\'s, in turns: wall median {wall["ms"]:.3f} ms (IQR '
            f'{wall["iqr_ms"]:.3f}), parent {wall["parent_ms"]:.3f} ms (IQR '
            f'{wall["parent_iqr_ms"]:.3f}) ' + json.dumps(wall['turns_ms']))
    out['bn_elements_per_step'] = sum(math.prod(s) for s in shapes)
    out['bn_shapes'] = shapes
    log(f'  profile of one train_step({len(batch[0])}) with the BN kernels '
        f'({busy_ms:.3f} ms of device time in {wall_ms:.3f} ms of wall '
        f'time under the profiler)' + (':' if table else ''))
    if table:
        log(averages(prof).table(sort_by='self_cuda_time_total',
                                      row_limit=30, max_name_column_width=60))
    return out


def device_busy_ms(fn, iters: int = 3) -> float:
    """Device time per call of ``fn``, summed over every CUDA kernel, copy
    and fill it launches, from the profiler's trace.  How many launches
    ``fn`` makes is not known beforehand (a PyTorch call's own), and the
    trace drops launches at random and now and then holds more, so a
    window is read only where its launches are a positive multiple of
    ``iters`` seen in an earlier window too, and either no fewer than any
    such multiple seen, or seen in three windows and no fewer than any
    other multiple seen in two (a window that once held launches of
    something else does not block the reading for good); other windows are
    printed and profiled again, ``2 * PROFILER_TRIES`` windows at most."""
    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    seen = []
    for _ in range(2 * PROFILER_TRIES):
        prof = profile_window(run)
        busy = busy_us(prof)
        launches = busy_launches(prof) if busy > 0 else 0
        whole = [n for n in seen if n % iters == 0]
        if launches > 0 and launches % iters == 0 and launches in seen and (
                launches >= max(whole) or (seen.count(launches) > 1 and all(
                    launches >= n for n in whole if whole.count(n) > 1))):
            return busy / iters / 1e3
        if seen:
            log(f'  profiler saw {launches} launches in {iters} calls '
                f'(earlier windows {seen}); profiling again')
        seen.append(launches)
    fail(f'profiler saw {seen} launches in windows of {iters} calls, never '
         'a count that could be read')


def library_bn_step_ms(shapes, dtype=torch.float32) -> dict:
    """The PyTorch calls over one train step's BN shapes (activations in
    ``dtype``, parameters f32, one call per shape), device time summed over
    all of their kernels: the pairs ``native_batch_norm`` (``'K1+K2'``) and
    ``native_batch_norm_backward`` (``'K3+K4'``), and each kernel's own
    call (``library_calls``; by wrapper name, the refusal where a call
    refuses the inputs)."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 5)
    data = []
    for shape in shapes:
        c = shape[1]
        data.append((torch.randn(shape, device='cuda', generator=gen).to(dtype),
                     torch.randn(shape, device='cuda', generator=gen).to(dtype),
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
    calls = [library_calls(x, dz, scale, bias, mean, invstd)
             for (x, dz, scale, bias), (mean, invstd) in zip(data, saved)]
    for name in BN_KERNELS:
        refused = [c[name] for c in calls if not callable(c[name])]
        out[name] = refused[0] if refused else device_busy_ms(
            lambda: [c[name]() for c in calls])
    del data, saved, calls
    torch.cuda.empty_cache()
    return out


def library_step_fields(name: str, library_step: dict) -> dict:
    """A kernel's own PyTorch call and its pair over a step's shapes
    (``library_bn_step_ms``), for the kernels line."""
    own = library_step[name]
    return {'library_step_ms': own if isinstance(own, float) else None,
            **({} if isinstance(own, float) else {'library_refused': own}),
            'library_pair_step_ms': library_step[LIBRARY_PAIRS[name]]}


def slower_than_library(steps: dict) -> dict:
    """For each BN kernel, the profiled steps (``{key: (profile_train_step
    result, library_bn_step_ms result)}``) over which it took more device
    time than its own PyTorch call over the same shapes."""
    return {name: [key for key, (step, library) in steps.items()
                   if isinstance(library[name], float)
                   and step[name]['step_ms'] > library[name]]
            for name in BN_KERNELS}


def log_bn_kernels(per_launch: dict, label: str) -> None:
    """``time_bn_kernels``'s readings, a line per kernel."""
    for name, k in per_launch.items():
        log(f'  {name} {label}: {k["ms"] * 1e3:.2f} us/launch at '
            f'{list(BN_TIMED_SHAPE)} (bound {k["bound_ms"] * 1e3:.2f} us, '
            f'{k["bound_by"]}, {k["bound_ms"] / k["ms"]:.0%}; plain '
            f'{k["plain_ms"] * 1e3:.2f} us; {library_text(k)}; PyTorch '
            f'{k["library_pair"]} pair {k["library_pair_ms"] * 1e3:.2f} us)')


def log_bn_step(step: dict, library_step: dict, n_bn: int) -> None:
    """Each BN kernel's device ms over a profiled step beside its bound, its
    own PyTorch call over the same shapes (``library_bn_step_ms``) and, with
    the parent build (``--parent-bn``), its time in turns; then the
    pairs."""
    for name in BN_KERNELS:
        k, own = step[name], library_step[name]
        turns = k.get('turns')
        log(f'  {name}: {k["step_ms"]:.3f} ms per step over {n_bn} launches '
            f'(bound {k["step_bound_ms"]:.3f} ms, '
            f'{k["step_bound_ms"] / k["step_ms"]:.0%}; {LIBRARY_CALLS[name]} '
            + (f'{own:.3f} ms' if isinstance(own, float) else own) + ')'
            + (f'; in turns {turns["step_ms"]:.4f} ms, parent '
               f'{turns["step_parent_ms"]:.4f} ms ' + json.dumps(turns['turns_ms'])
               if turns else ''))
    pairs = {'K1+K2': step['bn_stats']['step_ms'] + step['bn_apply']['step_ms'],
             'K3+K4': step['bn_grad_sums']['step_ms'] + step['bn_dx']['step_ms']}
    for pair, ms in pairs.items():
        log(f'  per step over the {n_bn} BN shapes: kernels {pair} {ms:.3f} '
            f'ms, PyTorch pair {library_step[pair]:.3f} ms')


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
        e.count for e in averages(prof) if e.key.startswith('aten::')) / 5
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
    log(averages(prof).table(sort_by='self_cuda_time_total', row_limit=30,
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


# --------------------------------------------------------------- phase 12

# The model zoo on the card: the slice's main path, RetinaNet-ResNet50, and
# SSD300-VGG16, each at full width and its input size, at the configs' b16,
# with seeded random weights.  Each maps to its train-mode BN count.
RETINA = 'samples/retina_rn50_500_voc.py'
VGG = 'samples/ssd_300_vgg16_voc.py'
ZOO = {'retina': (RETINA, 500, 98), 'vgg': (VGG, 300, 21)}
ZOO_BATCH = 16
ZOO_STEPS = 3
# phase 12's results by path -> the kernels line's ``launches_by_path`` names
ZOO_PATHS = (('serving', 'serving'), ('training', 'train'))
# Forward on the card against the CPU, each output (heads and the loc
# heads' sources) as a fraction of its largest CPU value: f32 with TF32 off
# on both, convolutions summed in other orders over up to 4608 terms.
ZOO_FORWARD_RTOL = 1e-4
# RetinaNet's CLI run: phase 8's synthetic 500 px data cut to 4 b16 train
# steps and 32 eval images; ``num_classes`` 21 draws classes 1-20, the
# config's 20 sigmoid classes.
RETINA_CLI_DATA = {
    'train': {**FLAGSHIP_DATA['train'], 'num_images': 64},
    'eval': {**FLAGSHIP_DATA['eval'], 'num_images': 32},
}


def forward_vs_cpu(model: torch.nn.Module, x: torch.Tensor, label: str) -> float:
    """The eval forward of ``x[:2]`` on the card against a CPU copy of
    ``model``, heads and sources, each as a fraction of its largest CPU
    value; fails above ``ZOO_FORWARD_RTOL``."""
    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        card = model(x[:2], return_sources=True)
        ref = cpu_model(x[:2].cpu(), return_sources=True)
    named = [('scores', card[0], ref[0]), ('locs', card[1], ref[1])] + [
        (f'source{i}', a, b) for i, (a, b) in enumerate(zip(card[2], ref[2]))]
    err = 0.0
    for name, got, want in named:
        rel = ((got.cpu() - want).abs().max().item()
               / max(want.abs().max().item(), 1e-30))
        if not rel <= ZOO_FORWARD_RTOL:
            fail(f'{label}: {name} on the card differs from the CPU by {rel} '
                 'of its largest value')
        err = max(err, rel)
    return err


def zoo_serving(config: str, size: int, rng, batch: int = ZOO_BATCH) -> dict:
    """``Predictor`` on ``config``: 3 ``predict_batch`` calls of ``batch``
    with the NMS count (and no BN launch) read around them; the forward at b2
    against the CPU (heads and sources); the kernel postprocessor against
    the plain one at ``batch``; the NMS kernel's inputs; ``predict_batch``
    img/s (median of 10 calls after 3 warm-up calls)."""
    pred = Predictor.from_config(config, device='cuda', seed=SEED)
    perturb_bn(pred.model, torch.Generator().manual_seed(SEED + 1))
    batches = [rng.randint(0, 256, (batch, size, size, 3), dtype=np.uint8)
               for _ in range(3)]
    zero_launches()
    outs = [pred.predict_batch(b) for b in batches]
    torch.cuda.synchronize()
    all_launches = read_launches()
    launches = all_launches['nms_keep_batched']
    if launches == 0:
        fail(f'{config}: the serving path launched no NMS kernel')
    bn_launches = {k: v for k, v in all_launches.items()
                   if k != 'nms_keep_batched' and v}
    if bn_launches:
        fail(f'{config}: the serving path launched BN kernels {bn_launches}')
    max_total = pred.postprocessor.max_total
    for dets, valid in outs:
        if (tuple(dets.shape) != (batch, max_total, 6)
                or tuple(valid.shape) != (batch, max_total)):
            fail(f'{config}: predict_batch shapes {tuple(dets.shape)} '
                 f'{tuple(valid.shape)}')
        if not torch.isfinite(dets).all():
            fail(f'{config}: non-finite detections')

    x = pred.preprocess(torch.from_numpy(batches[0]).cuda())
    forward_err = forward_vs_cpu(pred.model, x, config)
    with torch.inference_mode():
        card = pred.model(x, return_sources=True)
    plain = copy.copy(pred.postprocessor)
    plain.nms_keep = lambda boxes, scores: nms_ops.nms_keep_sorted(
        boxes, scores, plain.overlap_threshold)
    d_k, v_k = pred.postprocessor(card[0].float(), card[1].float(), pred.anchors)
    d_p, v_p = plain(card[0].float(), card[1].float(), pred.anchors)
    if not torch.equal(v_k, v_p) or not torch.equal(d_k[v_k], d_p[v_p]):
        fail(f'{config}: the kernel postprocessor differs from the plain one')
    nms_in = nms_inputs(pred, batches[0])
    times = host_times_ms(lambda: pred.predict_batch(batches[1]), iters=10)
    ms = statistics.median(times)
    out = {'anchors': len(pred.anchors), 'launches': all_launches,
           'forward_vs_cpu_max_rel_err': forward_err,
           'valid_per_image': v_k.sum(dim=1).tolist(),
           f'predict_batch_b{batch}_ms': ms,
           f'predict_batch_b{batch}_img_per_s': batch * 1e3 / ms,
           f'predict_batch_b{batch}_all_ms': times,
           'nms_inputs': nms_in,
           'nms_threshold': pred.postprocessor.overlap_threshold}
    log(f'  {config} serving: {len(pred.anchors)} anchors, 3 x '
        f'predict_batch({batch}) at {size} px, {launches} NMS launches; '
        f'forward card vs CPU (b2, heads and {len(card[2])} sources) max rel '
        f'err {forward_err:.3g} (tol {ZOO_FORWARD_RTOL}); kernel postprocess '
        f'== plain, valid per image {out["valid_per_image"]}; '
        f'{ms:.2f} ms = {batch * 1e3 / ms:.1f} img/s')
    del pred, card, outs
    torch.cuda.empty_cache()
    return out


def zoo_training(config: str, key: str, size: int, n_bn_expected: int,
                 card: str, batch: int = ZOO_BATCH, table: bool = False,
                 parent_bn=None) -> dict:
    """``Trainer`` on ``config`` with ``fused_bn``: ``ZOO_STEPS`` steps of
    ``batch`` with the BN counts read around them, one step against
    PyTorch's batch norm, the step in turns with and without the kernels, the kernels
    against their plain versions on every distinct BN shape of the step,
    and each kernel's device time summed over a step beside the step's
    bound and the PyTorch pairs over the same shapes (with ``table``, the
    step's table of device time by operator); the peak of
    ``torch.cuda.max_memory_allocated`` over the steps."""
    torch.cuda.reset_peak_memory_stats()
    trainer = build_trainer(True, config)
    n_bn = sum(isinstance(m, BatchNorm) for m in trainer.model.modules())
    if n_bn != n_bn_expected:
        fail(f'{config}: {n_bn} train-mode BNs, expected {n_bn_expected}')
    rng = np.random.RandomState(SEED + 6)
    batches = [train_batch(rng, batch, size=size) for _ in range(ZOO_STEPS)]
    zero_launches()
    metrics, launches = run_training_path(trainer, batches)
    launches['nms_keep_batched'] = nms_kernel.nms_keep_batched.launches
    peak = torch.cuda.max_memory_allocated()
    check_training_path(metrics, {k: v for k, v in launches.items()
                                  if k != 'nms_keep_batched'}, n_bn)
    log(f'  {config} training: {ZOO_STEPS} x train_step({batch}) at '
        f'{size} px, losses ' + ', '.join(f'{m["loss"]:.4f}' for m in metrics)
        + '; BN kernel launches ' + json.dumps(launches)
        + f'; peak memory {peak / 2**30:.2f} GiB')
    library = check_against_library_bn(trainer, batches[0], config,
                                       LIBRARY_BN_STATS_TOL.get(config, 1e-4))
    if config in LIBRARY_BN_STATS_TOL:
        library.update(bn_variance_vs_float64(trainer, library['library'],
                                              batches[0]))
    timing = time_train_steps(trainer, library['library'], batches[0], iters=3)
    del library['library']
    torch.cuda.empty_cache()
    # the operator table for the slice's main path only
    step = profile_train_step(trainer, batches[0], n_bn, card, key,
                              table=table, parent_bn=parent_bn)
    step_shapes = step.pop('bn_shapes')
    del trainer
    torch.cuda.empty_cache()
    shapes = sorted(set(step_shapes), key=math.prod, reverse=True)
    bn_check = check_bn_kernels(
        [BnCase(str(list(s)), s, torch.float32) for s in shapes], quiet=True)
    log(f'  K1-K4 vs plain on the {len(shapes)} distinct BN shapes of the '
        f'step, from {list(shapes[0])} to {list(shapes[-1])}: within BN_TOL')
    library_step = library_bn_step_ms(step_shapes)
    log_bn_step(step, library_step, n_bn)
    return {'n_bn': n_bn, 'losses': [m['loss'] for m in metrics],
            'launches': launches, 'peak_memory_bytes': peak,
            **library, **timing,
            'bn_step': step, 'library_step_ms': library_step,
            'bn_shapes': [list(s) for s in shapes], 'bn_max_abs_err': bn_check}


def write_zoo_cli_config(path: Path, config: str, data: dict) -> str:
    """``config`` with the synthetic ``data``, one epoch, an evaluation and
    a checkpoint, and ``train.fused_bn``."""
    path.write_text(
        (REPO / config).read_text()
        + '\n# chip_smoke.py: synthetic data, fused BN\n'
        + f'dataset = {data!r}\n'
        + 'train = dict(train, epochs=1, eval_every=1, save_every=1, '
        'fused_bn=True)\n')
    return str(path)


def zoo_cli(work: str, n_bn: int, config: str = RETINA,
            data: dict = RETINA_CLI_DATA, flags=()) -> dict:
    """``python -m single_shot_detection_tpu_torch`` (in process) on
    ``config`` with the synthetic ``data`` and the CLI's ``flags``: one
    epoch of augmented steps, an evaluation and a checkpoint; losses
    finite, mAP in [0, 1], every kernel's launches as the loaders' lengths
    say."""
    name = Path(config).stem
    config = write_zoo_cli_config(Path(work) / f'{name}_cli.py', config, data)
    exp, rows, launches, seconds, epoch_s = run_cli(
        ['--config', config, '--phases', 'train', 'eval', '--save-dir',
         os.path.join(work, 'runs'), *flags])
    steps = len(exp.loaders['train'])
    eval_batches = len(exp.loaders['eval'])
    if [r['epoch'] for r in rows] != [0]:
        fail(f'{name} CLI epochs {[r["epoch"] for r in rows]}, expected [0]')
    row = rows[0]
    if not all(np.isfinite(v) for v in row.values()):
        fail(f'{name} CLI: non-finite epoch row {row}')
    if not 0.0 <= row.get('eval_mAP', -1.0) <= 1.0:
        fail(f'{name} CLI: eval mAP {row.get("eval_mAP")} outside [0, 1]')
    want = {fn.__name__: n_bn * steps for fn in bn_kernel.KERNELS}
    want['nms_keep_batched'] = eval_batches
    if launches != want:
        fail(f'{name} CLI kernel launches {launches}, expected {want}')
    if f'ckpt-{steps}.pt' not in os.listdir(exp.checkpoint_dir):
        fail(f'{name} CLI wrote {os.listdir(exp.checkpoint_dir)}')
    saved = torch.load(os.path.join(exp.checkpoint_dir, f'ckpt-{steps}.pt'),
                       weights_only=True)['model']
    if any(v.dtype not in (torch.float32, torch.int64) for v in saved.values()):
        fail(f'{name} CLI saved a checkpoint that is not f32')
    images = steps * exp.loaders['train'].batch_size
    log(f'  {name} through python -m single_shot_detection_tpu_torch '
        f'{" ".join(flags)} (in this process), {str(exp.model.dtype)[6:]} '
        f'activations, fused_bn, synthetic {data["train"]["image_size"]} '
        f'px data: {steps} b'
        f'{exp.loaders["train"].batch_size} steps, {eval_batches} eval '
        f'batches, a checkpoint, in {seconds:.2f} s; epoch {epoch_s[0]:.3f} s '
        f'= {images / epoch_s[0]:.1f} img/s; ' + json.dumps(row)
        + '; kernel launches ' + json.dumps(launches))
    dtype = exp.model.dtype
    del exp
    torch.cuda.empty_cache()
    return {'seconds': seconds, 'epoch_s': epoch_s[0],
            'epoch_img_per_s': images / epoch_s[0], 'row': row,
            'launches': launches, 'steps': steps, 'eval_batches': eval_batches,
            'dtype': str(dtype)}


def run_zoo(card: str, smi: str, parent_bn=None) -> dict:
    """Phase 12: serving, training and (RetinaNet) the CLI for each zoo
    config, then the NMS kernel at the RetinaNet serving input."""
    rng = np.random.RandomState(SEED + 8)
    out = {}
    for key, (config, size, n_bn) in ZOO.items():
        t = time.perf_counter()
        serving = zoo_serving(config, size, rng)
        training = zoo_training(config, key, size, n_bn, card,
                                table=config == RETINA, parent_bn=parent_bn)
        out[key] = {'serving': serving, 'training': training}
        log(f'  {config}: {time.perf_counter() - t:.1f} s; {smi}: '
            f'predict_batch b{ZOO_BATCH} '
            f'{serving[f"predict_batch_b{ZOO_BATCH}_img_per_s"]:.1f} img/s; '
            f'train step b{ZOO_BATCH} with the BN kernels '
            f'{training[f"train_step_b{ZOO_BATCH}_fused_bn_ms"]:.2f} ms, with '
            f'PyTorch BN {training[f"train_step_b{ZOO_BATCH}_library_bn_ms"]:.2f} ms')
    work = tempfile.mkdtemp(prefix='chip_smoke_zoo_')
    try:
        out['retina']['cli'] = zoo_cli(work, ZOO['retina'][2])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out['nms'] = {}
    for key, label in (('retina', 'sigmoid'), ('vgg', 'softmax')):
        serving = out[key]['serving']
        out['nms'].update(time_nms(serving.pop('nms_threshold'), {
            f'{key} b{ZOO_BATCH} serving ({label}, 20 classes)':
                serving.pop('nms_inputs')}, card))
    return out


# --------------------------------------------------------------- phase 13

# The rest of the model zoo on the card, each config at full width, its
# input size and its own batch, with seeded random weights: the slice's main
# path M2Det-512-VGG16 (150 train-mode BNs per step, from [8, 64, 512, 512]
# down to the TUMs' [8, 128, 2, 2]) and SSD300-ShuffleNetV2 (68 narrow BNs,
# 24 to 1024 channels, many depthwise); then MobileNet v1 under the
# depthwise FPN with ``train.group_norm``, which runs no BN kernel.
M2DET = 'samples/m2det_512_vgg16_voc.py'
SH2 = 'samples/ssd_sh2_voc.py'
# BN running statistics after one step with the kernels against one with
# PyTorch's batch norm, from the same state, as a fraction of max(1,
# |value|) (1e-4 elsewhere).  On M2Det's 150 BNs in series the two paths'
# inputs drift apart, by up to 1.7e-3 of the variance at the last TUMs' 4x4
# and 2x2 levels, while K1's batch variance of its own input stays within
# 3e-6 of float64 (``bn_variance_vs_float64``); the running
# variances there differed by 1.00e-4, 1.29e-4 and 1.40e-4 in three runs on
# the H100
LIBRARY_BN_STATS_TOL = {M2DET: 1e-3}
# Where that tolerance is looser, ``bn_variance_vs_float64`` holds K1's batch
# variance on every BN input of the step against float64, as a fraction of
# max(variance, eps): flax's f32 ``E[x^2] - E[x]^2`` read within 2.83e-6 on
# M2Det's step
BN_VAR_RTOL = 1e-4


def bn_variance_vs_float64(trainer: Trainer, library: Trainer, batch) -> dict:
    """From one state, a step of each trainer with a hook on every BN: K1's
    batch variance of the kernels' input against its float64 variance
    (fails above ``BN_VAR_RTOL``), and the float64 variances of the two
    paths' inputs against each other (the drift that the BNs in series
    build up between the two paths, reported)."""
    library.model.load_state_dict(trainer.model.state_dict())
    library.state.optimizer.load_state_dict(trainer.state.optimizer.state_dict())
    library.state.step = trainer.state.step
    var64 = {}
    k1_err = 0.0

    def hook(module, args, key):
        nonlocal k1_err
        x = args[0].detach()
        v64 = x.double().var(dim=(0, 2, 3), unbiased=False)
        var64[key] = v64
        if key[0] == 'kernels':
            _, var, _ = bn_kernel.bn_stats(x.contiguous(), module.eps)
            k1_err = max(k1_err, ((var.double() - v64).abs()
                                  / v64.clamp_min(module.eps)).max().item())

    for side, tr in (('kernels', trainer), ('library', library)):
        hooks = [m.register_forward_pre_hook(functools.partial(
            hook, key=(side, name)))
            for name, m in tr.model.named_modules() if isinstance(m, BatchNorm)]
        tr.train_step(*batch)
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
    names = [name for side, name in var64 if side == 'kernels']
    drift = max(((var64['kernels', n] - var64['library', n]).abs()
                 / var64['library', n].clamp_min(BN_EPS)).max().item()
                for n in names)
    if not k1_err <= BN_VAR_RTOL:
        fail(f'K1\'s batch variance on the step\'s BN inputs differs from '
             f'float64 by {k1_err} of max(variance, eps)')
    log(f'  K1\'s batch variance on the {len(names)} BN inputs of a step vs '
        f'float64: max rel err {k1_err:.3g} (tol {BN_VAR_RTOL}); the two '
        f'paths\' inputs drift apart by up to {drift:.3g} of the variance')
    return {'k1_variance_max_rel_err': k1_err, 'input_variance_drift': drift}
ZOO_REST = {'m2det': (M2DET, 512, 8, 150), 'sh2': (SH2, 300, 32, 68)}
# M2Det's CLI run: phase 8's synthetic data at 512 px, cut to 4 b8 train
# steps and 16 eval images
M2DET_CLI_DATA = {
    'train': {**FLAGSHIP_DATA['train'], 'num_images': 32, 'image_size': 512},
    'eval': {**FLAGSHIP_DATA['eval'], 'num_images': 16, 'image_size': 512},
}
# No shipped config uses MobileNet v1 or the depthwise FPN: this ``model``
# goes into the flagship's config (300 px: taps 18 and 9 px, extra levels
# 5, 3, 2, 1), with ``train.group_norm: True``
MBV1_DFPN_MODEL = {
    'base': {'name': 'mobilenet_v1'},
    'detector': {
        'num_classes': 21,
        'features': {'name': 'DepthwiseFeaturePyramid', 'out_layers': (11, 13),
                     'pyramid_layers': 6, 'pyramid_channels': 128},
    },
    'anchor_generator': {
        'type': 'ssd', 'num_scales': 6, 'min_scale': 0.1, 'max_scale': 1.05,
        'aspect_ratios': [[1.0, 2.0]] + [[1.0, 2.0, 3.0]] * 3 + [[1.0, 2.0]] * 2,
    },
}
MBV1_GN_STEPS = 2


def mbv1_group_norm(work: str) -> dict:
    """MobileNet v1 + the depthwise FPN with ``train.group_norm`` (8
    groups): one ``predict_batch`` of 32 and ``MBV1_GN_STEPS`` b32 train
    steps with every kernel's count read around them (the BN kernels must
    read 0: every BatchNorm is a GroupNorm), the serving forward against
    the CPU, the running statistics unwritten."""
    path = Path(work) / 'mbv1_dfpn_gn.py'
    path.write_text((REPO / FLAGSHIP).read_text()
                    + '\n# chip_smoke.py phase 13: MobileNet v1, the '
                    'depthwise FPN, GroupNorm\n'
                    + f'model = {MBV1_DFPN_MODEL!r}\n'
                    + 'train = dict(train, group_norm=True)\n')
    rng = np.random.RandomState(SEED + 9)
    pred = Predictor.from_config(str(path), device='cuda', seed=SEED)
    perturb_bn(pred.model, torch.Generator().manual_seed(SEED + 1))
    trainer = Trainer.from_config(str(path), device='cuda', seed=SEED,
                                  overrides={'augmentations': []})
    groups = {m.group_norm for model in (pred.model, trainer.model)
              for m in model.modules() if isinstance(m, BatchNorm)}
    if groups != {8}:
        fail(f'group_norm config: BatchNorm group counts {groups}, expected {{8}}')
    stats = {k: v.clone() for k, v in trainer.model.state_dict().items()
             if k.endswith(('running_mean', 'running_var'))}
    images = rng.randint(0, 256, (32, 300, 300, 3), dtype=np.uint8)
    batches = [train_batch(rng) for _ in range(MBV1_GN_STEPS)]
    zero_launches()
    dets, valid = pred.predict_batch(images)
    metrics = [trainer.train_step(*b) for b in batches]
    torch.cuda.synchronize()
    launches = read_launches()
    losses = [m['loss'].item() for m in metrics]
    if any(launches[fn.__name__] for fn in bn_kernel.KERNELS):
        fail(f'group_norm path launched BN kernels: {launches}')
    if launches['nms_keep_batched'] == 0:
        fail('group_norm serving launched no NMS kernel')
    if not (torch.isfinite(dets).all() and np.isfinite(losses).all()):
        fail(f'group_norm path: non-finite detections or losses {losses}')
    after = trainer.model.state_dict()
    if not all(torch.equal(after[k], v) for k, v in stats.items()):
        fail('group_norm train steps wrote BN running statistics')
    err = forward_vs_cpu(pred.model, pred.preprocess(torch.from_numpy(
        images).cuda()), 'group_norm')
    log(f'  MobileNet v1 + DepthwiseFeaturePyramid, train.group_norm (8 '
        f'groups): predict_batch(32) valid per image {valid.sum(1).tolist()[:4]}'
        f'...; {MBV1_GN_STEPS} x train_step(32) losses '
        + ', '.join(f'{v:.4f}' for v in losses) + '; kernel launches '
        + json.dumps(launches) + f'; forward card vs CPU max rel err {err:.3g}'
        '; running statistics unwritten')
    del pred, trainer
    torch.cuda.empty_cache()
    return {'launches': launches, 'losses': losses,
            'forward_vs_cpu_max_rel_err': err}


def run_zoo_rest(card: str, smi: str, parent_bn=None) -> dict:
    """Phase 13: serving and training for M2Det-512 (at b8, and its CLI
    run) and SSD300-ShuffleNetV2 (at b32), the group_norm path, then the
    NMS kernel at both serving inputs."""
    rng = np.random.RandomState(SEED + 10)
    out = {}
    for key, (config, size, batch, n_bn) in ZOO_REST.items():
        t = time.perf_counter()
        serving = zoo_serving(config, size, rng, batch=batch)
        training = zoo_training(config, key, size, n_bn, card, batch=batch,
                                table=config == M2DET, parent_bn=parent_bn)
        out[key] = {'serving': serving, 'training': training}
        log(f'  {config}: {time.perf_counter() - t:.1f} s; {smi}: '
            f'predict_batch b{batch} '
            f'{serving[f"predict_batch_b{batch}_img_per_s"]:.1f} img/s; '
            f'train step b{batch} with the BN kernels '
            f'{training[f"train_step_b{batch}_fused_bn_ms"]:.2f} ms, with '
            f'PyTorch BN {training[f"train_step_b{batch}_library_bn_ms"]:.2f} ms')
    work = tempfile.mkdtemp(prefix='chip_smoke_zoo_rest_')
    try:
        out['m2det']['cli'] = zoo_cli(work, ZOO_REST['m2det'][3], M2DET,
                                      M2DET_CLI_DATA)
        out['mbv1_gn'] = mbv1_group_norm(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out['nms'] = {}
    for key, label in (('m2det', 'M2Det b8'), ('sh2', 'ShuffleNetV2 b32')):
        serving = out[key]['serving']
        out['nms'].update(time_nms(serving.pop('nms_threshold'), {
            f'{key} {label} serving (softmax, 20 classes)':
                serving.pop('nms_inputs')}, card))
    return out


# --------------------------------------------------------------- phase 14

# Launches of each kernel in a timed window of phase 14
SHAPE_ITERS = 20
# Planes of S % 4 != 0 (S = 361 and 5625) at which the split and scalar
# paths are timed side by side
ODD_PLANE_SHAPES = ((32, 116, 19, 19), (32, 58, 75, 75))
# The elementwise passes K2 and K4, whose kernels ``--parent-bn`` swaps for
# the parent build's in the profiled steps and times beside this build's
# per shape
ELEMENTWISE = ('bn_apply', 'bn_dx')
# A BN shape of the flagship's step at which a K2 or K4 launch takes less
# device time than its wrapper's host path (phase 14's host µs per call)
HOST_SHAPE = (32, 256, 3, 3)
# The elementwise passes' activation dtypes in phase 14 (z, dz and dx in
# x's)
ELEMENTWISE_DTYPES = {'f32': torch.float32, 'bf16': torch.bfloat16}


def load_parent_bn(source: str) -> ctypes.CDLL:
    """Build another version of ``bn.cu`` (say, a ``git archive`` of the
    commit before the elementwise passes' redesign) and declare its K2 and
    K4 launchers, ``bn_apply_launch`` and ``bn_dx_launch``, whose C
    interface is this build's.  A ``bn.cu`` of the two-pass reductions (it
    exports ``bn_partial_floats``) is refused: that comparison was recorded
    when K1 and K3 became one launch."""
    lib = ctypes.CDLL(str(_build.build_source(Path(source))))
    if hasattr(lib, 'bn_partial_floats'):
        fail(f'{source} has the two-pass reductions; --parent-bn takes a '
             'bn.cu with one-launch K1 and K3')
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bn_apply_launch.argtypes = [p, i, p, p, p, p, p, i, ll, ll, ll, i, p]
    lib.bn_dx_launch.argtypes = [p, i, p, i, p, p, p, p, ll, ll, ll, i, p]
    lib.bn_apply_launch.restype = lib.bn_dx_launch.restype = i
    return lib


@contextlib.contextmanager
def parent_kernels(lib: ctypes.CDLL):
    """For the block, the wrappers of ``ELEMENTWISE`` launch another
    build's K2 and K4 (``load_parent_bn``): its ``bn_apply_launch`` and
    ``bn_dx_launch`` stand in for this build's on the loaded library, so
    both sides run the same Python; the wrappers' launch counts are put
    back at the end."""
    own = bn_kernel._library()
    symbols = ('bn_apply_launch', 'bn_dx_launch')
    saved = {name: getattr(own, name) for name in symbols}
    counts = [bn_kernel.bn_apply.launches, bn_kernel.bn_dx.launches]
    for name in symbols:
        setattr(own, name, getattr(lib, name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(own, name, fn)
        bn_kernel.bn_apply.launches, bn_kernel.bn_dx.launches = counts


def wrapper_call(kernel: str, x, mean, rstd, scale=None, bias=None, dz=None,
                 coef=None):
    """A call of the wrapper of K2 (``kernel='bn_apply'``, z in x's dtype)
    or K4 (``'bn_dx'``) on these inputs."""
    if kernel == 'bn_apply':
        return lambda: bn_kernel.bn_apply(x, mean, rstd, scale, bias)
    return lambda: bn_kernel.bn_dx(dz, x, mean, rstd, coef)


def bn_step_turns(step, parent, n_bn: int) -> dict:
    """The device ms of the kernels of ``ELEMENTWISE`` in one profiled
    call of ``step`` (a train step that ends in a synchronize) with this
    build's kernels and with the parent build's (``parent_kernels``), in
    turns: parent, this, this, parent; then the step's wall time in turns
    (twice that order, 3 steps a turn after a warm-up step): median and
    interquartile range per side."""
    groups = [BN_KERNELS[name][0] for name in ELEMENTWISE]
    turns = {'parent': [], 'this': []}
    walls = {'parent': [], 'this': []}
    order = ('parent', 'this', 'this', 'parent')
    for side in order:
        with (parent_kernels(parent) if side == 'parent'
              else contextlib.nullcontext()):
            prof = profile_counted(step, groups, n_bn)
        turns[side].append([group_us(prof, g)[0] / 1e3 for g in groups])
    for side in order * 2:
        with (parent_kernels(parent) if side == 'parent'
              else contextlib.nullcontext()):
            walls[side] += host_times_ms(step, iters=3, warmup=1)

    def iqr(times):
        quartiles = statistics.quantiles(times, n=4)
        return quartiles[2] - quartiles[0]
    return {'kernels': {name: {
                'step_ms': statistics.mean(t[i] for t in turns['this']),
                'step_parent_ms': statistics.mean(t[i] for t in turns['parent']),
                'turns_ms': {side: [t[i] for t in ts]
                             for side, ts in turns.items()}}
                for i, name in enumerate(ELEMENTWISE)},
            'wall': {'ms': statistics.median(walls['this']),
                     'parent_ms': statistics.median(walls['parent']),
                     'iqr_ms': iqr(walls['this']),
                     'parent_iqr_ms': iqr(walls['parent']),
                     'turns_ms': walls}}


def time_elementwise_shape(kernel: str, card: str, parent=None,
                           weight=None, **inputs) -> dict:
    """K2 (``kernel='bn_apply'``) or K4 (``'bn_dx'``) at one shape, its
    output in x's dtype: its plan, device µs per launch of its wrapper
    (with ``parent``, the parent build's kernel through the same wrapper
    too, in turns: parent, this, this, parent), the bound, the launch floor
    (an empty kernel on the same grid) and its own PyTorch call's device µs
    (with ``weight``, the BN scale); this build's output on its own path
    and the parent's held against the plain version."""
    x = inputs['x']
    plain = {'bn_apply': lambda x, mean, rstd, scale, bias:
             bn_kernel.bn_apply_plain(x, mean, rstd, scale, bias, x.dtype),
             'bn_dx': bn_kernel.bn_dx_plain}[kernel]
    want = plain(**inputs)
    kind = elementwise_tol(x.dtype)
    call = wrapper_call(kernel, **inputs)
    floor = bn_kernel.elementwise_launcher(kernel, floor=True, **inputs)
    row = {'plan': bn_kernel.elementwise_plan(kernel, x, inputs.get('dz')),
           'bound_ms': bn_bound_ms(kernel, x.numel(), x.shape[1], card,
                                   x.element_size())[0],
           'max_abs_err': bn_err(call(), want, kind)}
    groups = [BN_KERNELS[kernel][0], FLOOR_KERNELS[kernel]]
    sides = {'this': lambda: groups_device_ms(lambda: (call(), floor()),
                                              groups, SHAPE_ITERS)}
    if parent is not None:
        with parent_kernels(parent):
            bn_err(call(), want, kind)

        def on_parent():
            with parent_kernels(parent):
                return groups_device_ms(call, groups[:1], SHAPE_ITERS)
        sides['parent'] = on_parent
    # in turns with a parent build; one window of this build's alone
    turns = {side: [] for side in sides}
    for side in (('parent', 'this', 'this', 'parent') if parent is not None
                 else ('this',)):
        turns[side].append(sides[side]())
    row['ms'] = statistics.mean(t[0] for t in turns['this'])
    row['floor_ms'] = statistics.mean(t[1] for t in turns['this'])
    if parent is not None:
        row['parent_ms'] = statistics.mean(t[0] for t in turns['parent'])
        row['turns_ms'] = {side: [t[0] for t in ts] for side, ts in turns.items()}
    own = library_calls(x, inputs.get('dz', x), weight, inputs.get('bias'),
                        inputs['mean'], inputs['rstd'], (kernel,))[kernel]
    row.update(library_fields(kernel, device_busy_ms(own, SHAPE_ITERS)
                              if callable(own) else own))
    return row


def time_bn_shape(shape, card: str, parent=None) -> dict:
    """K1 and K3 at one f32 ``shape``: the grid each launches, device µs
    per launch, the bound and the launch floor (an empty kernel on the same
    grid, block and cluster); K2 and K4 at f32 and bf16
    (``time_elementwise_shape``).  Each window launches the same inputs
    ``SHAPE_ITERS`` times, so inputs that fit the L2 are warm."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 11)
    x = torch.randn(shape, device='cuda', generator=gen) * 2 + 0.3
    dz = torch.randn(shape, device='cuda', generator=gen)
    scale = torch.rand(shape[1], device='cuda', generator=gen) + 0.5
    bias = torch.randn(shape[1], device='cuda', generator=gen) * 0.1
    mean, _, rstd = bn_kernel.bn_stats_plain(x, BN_EPS)
    coef = bn_kernel.bn_grad_sums_plain(dz, x, mean, rstd, scale)[2]
    calls = [lambda: bn_kernel.bn_stats(x, BN_EPS),
             lambda: bn_kernel.bn_grad_sums(dz, x, mean, rstd, scale)]
    calls += [bn_kernel.reduce_launcher(name, x, dz, mean, rstd, scale,
                                        floor=True) for name in REDUCTIONS]
    groups = ([BN_KERNELS[name][0] for name in REDUCTIONS]
              + [FLOOR_KERNELS[name] for name in REDUCTIONS])
    ms = groups_device_ms(lambda: [call() for call in calls], groups,
                          SHAPE_ITERS)
    row = {'shape': list(shape)}
    for i, name in enumerate(REDUCTIONS):
        row[name] = {'plan': bn_kernel.reduce_plan(
            name, x, dz if name == 'bn_grad_sums' else None),
            'bound_ms': bn_bound_ms(name, x.numel(), shape[1], card)[0],
            'ms': ms[i], 'floor_ms': ms[len(REDUCTIONS) + i]}
    for label, dtype in ELEMENTWISE_DTYPES.items():
        xd, dzd = x.to(dtype), dz.to(dtype)
        row.setdefault('bn_apply', {})[label] = time_elementwise_shape(
            'bn_apply', card, parent, scale, x=xd, mean=mean, rstd=rstd,
            scale=scale, bias=bias)
        row.setdefault('bn_dx', {})[label] = time_elementwise_shape(
            'bn_dx', card, parent, scale, x=xd, dz=dzd, mean=mean, rstd=rstd,
            coef=coef)
        del xd, dzd
    del x, dz
    return row


def log_bn_shape(row: dict) -> None:
    """``time_bn_shape``'s row, one line."""
    parts = []
    for name, label in zip(REDUCTIONS, ('K1', 'K3')):
        k, plan = row[name], row[name]['plan']
        parts.append(
            f'{label} {plan_text(plan)}: {k["ms"] * 1e3:.2f} us, bound '
            f'{k["bound_ms"] * 1e3:.2f}, floor {k["floor_ms"] * 1e3:.2f}')
    for name, label in zip(ELEMENTWISE, ('K2', 'K4')):
        for dtype, k in row[name].items():
            parent = (f' (parent {k["parent_ms"] * 1e3:.2f})'
                      if 'parent_ms' in k else '')
            parts.append(
                f'{label} {dtype} {elementwise_text(k["plan"])}: '
                f'{k["ms"] * 1e3:.2f} us{parent}, bound '
                f'{k["bound_ms"] * 1e3:.2f}, floor {k["floor_ms"] * 1e3:.2f}, '
                f'{library_text(k)}')
    log(f'  {row["shape"]}: ' + '; '.join(parts))


def both(calls: dict):
    """One call of K1 then K3 from ``calls`` (by wrapper name)."""
    return lambda: [calls[name]() for name in REDUCTIONS]


def compare_odd_plane_paths(card: str) -> dict:
    """K1 and K3 on the split path (4-element loads between scalar edges)
    and the scalar path at ``ODD_PLANE_SHAPES``, each checked against its
    plain version, device µs per launch in turns (split, scalar, scalar,
    split)."""
    out = {}
    groups = [BN_KERNELS[name][0] for name in REDUCTIONS]
    for shape in ODD_PLANE_SHAPES:
        x, dz, scale, _ = bn_inputs(shape, torch.float32,
                                    torch.Generator().manual_seed(SEED + 12))
        mean, _, rstd = bn_kernel.bn_stats_plain(x, BN_EPS)
        want = {'bn_stats': bn_kernel.bn_stats_plain(x, BN_EPS),
                'bn_grad_sums': bn_kernel.bn_grad_sums_plain(dz, x, mean, rstd,
                                                             scale)}
        calls = {path: {name: bn_kernel.reduce_launcher(
            name, x, dz, mean, rstd, scale, path=path) for name in REDUCTIONS}
            for path in ('split', 'scalar')}
        for path, launchers in calls.items():
            for name in REDUCTIONS:
                for got, ref in zip(launchers[name](), want[name]):
                    bn_err(got, ref, 'reduce')
        turns = {'split': [], 'scalar': []}
        for path in ('split', 'scalar', 'scalar', 'split'):
            turns[path].append(groups_device_ms(both(calls[path]), groups,
                                                SHAPE_ITERS))
        row = {'auto': bn_kernel.reduce_plan('bn_stats', x)['path']}
        for path, ts in turns.items():
            row[path] = {name: statistics.mean(t[i] for t in ts)
                         for i, name in enumerate(REDUCTIONS)}
        out[str(list(shape))] = row
        log(f'  S = {shape[2] * shape[3]} {list(shape)}: ' + '; '.join(
            f'{label} split {row["split"][name] * 1e3:.2f} us, scalar '
            f'{row["scalar"][name] * 1e3:.2f} us'
            for name, label in zip(REDUCTIONS, ('K1', 'K3')))
            + f' (the shape takes {row["auto"]})')
        del x, dz
    return out


def step_sums(rows: dict, counts: dict, get, fields) -> dict:
    """``step_<field>``: the count-weighted sum over a step's shapes of each
    field of ``get(row)``; ``None`` where a shape lacks a number."""
    out = {}
    for field in fields:
        values = [(n, get(rows[shape]).get(field)) for shape, n in counts.items()]
        out[f'step_{field}'] = (None if any(v is None for _, v in values)
                                else sum(n * v for n, v in values))
    return out


def time_bn_shapes(card: str, parent=None) -> dict:
    """Phase 14: K1 and K3 (f32), K2 and K4 (f32 and bf16) at every
    distinct BN shape of the five steps (``time_bn_shape``; with
    ``parent``, the parent build's K2 and K4 in turns), each step's sums
    (count x µs per launch over its shapes) beside its bound, launch floors
    and (K2, K4) their own PyTorch calls, and the odd-plane paths of K1 and
    K3 side by side."""
    rows = {}
    for key in STEP_BN_SHAPES:
        log(f'  {key} step (b{STEP_BN_SHAPES[key][0]}):')
        for shape in step_bn_shapes(key):
            if shape not in rows:
                rows[shape] = time_bn_shape(shape, card, parent)
                torch.cuda.empty_cache()
            log_bn_shape(rows[shape])
    steps = {}
    for key in STEP_BN_SHAPES:
        counts = step_bn_shapes(key)
        steps[key] = {name: step_sums(rows, counts, lambda r, n=name: r[n],
                                      ('ms', 'bound_ms', 'floor_ms'))
                      for name in REDUCTIONS}
        fields = ('ms', 'bound_ms', 'floor_ms', 'library_ms') + (
            ('parent_ms',) if parent is not None else ())
        for name in ELEMENTWISE:
            steps[key][name] = {
                label: step_sums(rows, counts,
                                 lambda r, n=name, d=label: r[n][d], fields)
                for label in ELEMENTWISE_DTYPES}
        parts = [(label, name, steps[key][name])
                 for name, label in zip(REDUCTIONS, ('K1', 'K3'))]
        parts += [(f'{label} {dtype}', name, t)
                  for name, label in zip(ELEMENTWISE, ('K2', 'K4'))
                  for dtype, t in steps[key][name].items()]
        log(f'  {key} step sums over {sum(counts.values())} BNs: ' + '; '.join(
            f'{label} {t["step_ms"]:.4f} ms'
            + (f' (parent {t["step_parent_ms"]:.4f})'
               if t.get('step_parent_ms') is not None else '')
            + f', bound {t["step_bound_ms"]:.4f} '
            f'({100 * t["step_bound_ms"] / t["step_ms"]:.0f} %), floors '
            f'{t["step_floor_ms"]:.4f}'
            + (f', {LIBRARY_CALLS[name]} {t["step_library_ms"]:.4f}'
               if t.get('step_library_ms') is not None else '')
            for label, name, t in parts))
    log('  the odd-plane paths side by side:')
    odd = compare_odd_plane_paths(card)
    out = {'shapes': [rows[s] for s in rows], 'steps': steps,
           'odd_plane_paths': odd}
    if parent is not None:
        log('  host µs per wrapper call, in turns with the parent:')
        out['wrapper_host_us'] = wrapper_host_us(parent)
    return out


def wrapper_host_us(parent, iters: int = 2000) -> dict:
    """Host µs per call of the wrappers of ``ELEMENTWISE`` at f32 and bf16
    (the checks, the output's allocation, the C++ planning and the launch)
    at ``HOST_SHAPE``, where the card keeps up with the host, with this
    build's kernels and with the parent's (``parent_kernels``), in turns:
    parent, this, this, parent; each side's mean of its two turns of
    ``iters`` calls."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 13)
    c = HOST_SHAPE[1]
    mean = torch.randn(c, device='cuda', generator=gen)
    rstd, scale = (torch.rand(c, device='cuda', generator=gen) + 0.5
                   for _ in range(2))
    bias = torch.randn(c, device='cuda', generator=gen)
    coef = torch.randn((3, c), device='cuda', generator=gen)
    out = {}
    for dtype_name, dtype in ELEMENTWISE_DTYPES.items():
        x, dz = (torch.randn(HOST_SHAPE, device='cuda', generator=gen).to(dtype)
                 for _ in range(2))
        for kernel in ELEMENTWISE:
            call = wrapper_call(kernel, x, mean, rstd, scale, bias, dz, coef)
            turns = {'parent': [], 'this': []}
            for side in ('parent', 'this', 'this', 'parent'):
                with (parent_kernels(parent) if side == 'parent'
                      else contextlib.nullcontext()):
                    call()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    for _ in range(iters):
                        call()
                    turns[side].append((time.perf_counter() - t) / iters * 1e6)
                    torch.cuda.synchronize()
            row = {'us': statistics.mean(turns['this']),
                   'parent_us': statistics.mean(turns['parent']),
                   'turns_us': turns}
            out[f'{kernel} {dtype_name}'] = row
            log(f'    {kernel} {dtype_name} {list(HOST_SHAPE)}: '
                f'{row["us"]:.2f} us, parent {row["parent_us"]:.2f} us '
                + json.dumps(turns))
    return out


# --------------------------------------------------------------- phase 15

# The numeric policies phase 15 runs in turns: f32 with TF32 off (the
# default), f32 with TF32 on (``--matmul-precision high``) and bf16
# activations (``--bf16``; its default precision has TF32 on)
POLICIES = {'f32': {}, 'tf32': {'matmul_precision': 'high'},
            'bf16': {'bf16': True}}
# The bf16 train step with the BN kernels against the same step with
# PyTorch's batch norm, both on bf16 activations with f32 statistics: the
# two round each BN output to bf16 from f32 values computed in another
# order, so an element may land one bf16 step (2**-8) apart and carry that
# through the 64 BNs in series (the first run on the H100: loss 1.84e-3
# apart, running statistics 1.85e-2 of max(1, |value|)).  The loss, which
# averages such noise over thousands of anchors, relative; the running
# statistics within ``BF16_STATS_FACTOR`` times the distance from the
# kernels' bf16 step to their f32 step from the same state (the largest
# over every statistic, as a fraction of max(1, |value|)).
BF16_LIBRARY_LOSS_RTOL = 5e-3
BF16_STATS_FACTOR = 2.0
# Soft-NMS on the card against the CPU: the pick mask on the same inputs
# equal; end to end (each device's own softmax and decode) the share of
# detection rows within these tolerances, reported: a last-bit difference
# in a probability can reorder two near-equal candidates
SOFT_NMS_RTOL, SOFT_NMS_ATOL = 1e-6, 1e-5


def in_turns(calls: dict, iters: int, warmup: int = 2) -> dict:
    """Host ms of each call of ``calls`` (name -> fn, each ending in a
    device synchronize) in turns: the names in order, then reversed;
    ``iters`` calls a turn after ``warmup``.  Each side's median and all
    of its times."""
    order = list(calls) + list(reversed(list(calls)))
    times = {name: [] for name in calls}
    for name in order:
        times[name] += host_times_ms(calls[name], iters=iters, warmup=warmup)
    return {name: {'ms': statistics.median(t), 'all_ms': t}
            for name, t in times.items()}


def bf16_forward_vs_cpu(pred: Predictor, x: torch.Tensor) -> dict:
    """The bf16 heads on the card against the port's bf16 forward on the
    CPU, each within twice the CPU's own bf16-to-f32 distance (the CPU
    tests' tolerance against JAX)."""
    with torch.inference_mode(), pred.policy.scope():
        card = pred.model(x[:2])
    cpu_bf16 = copy.deepcopy(pred.model).cpu()
    cpu_f32 = copy.deepcopy(pred.model).cpu()
    cpu_f32.dtype = cpu_f32.head_dtype = torch.float32
    with torch.inference_mode():
        ref = cpu_bf16(x[:2].cpu())
        f32 = cpu_f32(x[:2].cpu())
    out = {}
    for name, got, want, wide in zip(('scores', 'locs'), card, ref, f32):
        if got.dtype != torch.bfloat16:
            fail(f'bf16 serving: {name} in {got.dtype}')
        err = (got.float().cpu() - want.float()).abs().max().item()
        tol = 2 * (want.float() - wide).abs().max().item()
        if not err <= tol:
            fail(f'bf16 serving: {name} on the card differs from the CPU by '
                 f'{err}, more than twice bf16\'s distance from f32 ({tol})')
        out[name] = {'max_abs_err': err, 'tol': tol}
    return out


def bf16_serving(card: str, smi: str) -> dict:
    """The flagship ``Predictor`` at f32, TF32 and bf16: the bf16 one
    answers b32 and b128 batches with the kernels' counts read around
    them, its heads against the CPU, the NMS kernel exact on its inputs;
    ``predict_batch`` ms of the three in turns; one soft-NMS b32 call on
    the bf16 heads against the CPU, and its ms."""
    preds = {name: Predictor.from_config(FLAGSHIP, device='cuda', seed=SEED,
                                         **policy)
             for name, policy in POLICIES.items()}
    for pred in preds.values():
        perturb_bn(pred.model, torch.Generator().manual_seed(SEED + 1))
    pred = preds['bf16']
    rng = np.random.RandomState(SEED + 9)
    batches = {bs: rng.randint(0, 256, (bs, 300, 300, 3), dtype=np.uint8)
               for bs in (32, 128)}
    zero_launches()
    outs = {bs: pred.predict_batch(b) for bs, b in batches.items()}
    torch.cuda.synchronize()
    launches = read_launches()
    if launches['nms_keep_batched'] != 2 or any(
            launches[fn.__name__] for fn in bn_kernel.KERNELS):
        fail(f'bf16 serving launched {launches}, expected NMS 2 and no BN')
    for bs, (dets, valid) in outs.items():
        if (tuple(dets.shape) != (bs, pred.postprocessor.max_total, 6)
                or not torch.isfinite(dets).all() or not valid.any(1).all()):
            fail(f'bf16 predict_batch({bs}): shapes {tuple(dets.shape)}, '
                 'non-finite or empty detections')
    x = pred.preprocess(torch.from_numpy(batches[32]).cuda())
    forward = bf16_forward_vs_cpu(pred, x)
    nms = time_nms(pred.postprocessor.overlap_threshold, {
        'bf16 b32 serving': nms_inputs(pred, batches[32])}, card)
    out = {'launches': launches, 'forward_vs_cpu': forward, 'nms': nms,
           'valid_per_image_b32': outs[32][1].sum(1).tolist()}
    for bs, images in batches.items():
        turns = in_turns({name: (lambda p=p: p.predict_batch(images))
                          for name, p in preds.items()}, iters=8)
        out[f'predict_batch_b{bs}'] = turns
    log(f'  bf16 serving: predict_batch(32) and (128), {launches}; heads card '
        'vs CPU ' + ', '.join(f'{k} {v["max_abs_err"]:.3g} (tol {v["tol"]:.3g})'
                              for k, v in forward.items()))
    for bs in batches:
        log(f'  {smi}: predict_batch b{bs} in turns: ' + ', '.join(
            f'{name} {row["ms"]:.3f} ms = {bs * 1e3 / row["ms"]:.1f} img/s'
            for name, row in out[f'predict_batch_b{bs}'].items()))

    profile_b32(pred, rng)

    # soft-NMS on the bf16 heads (f32, as the postprocessor takes them)
    with torch.inference_mode(), pred.policy.scope():
        scores, locs = (t.float() for t in pred.model(x))
    soft = copy.copy(pred.postprocessor)
    soft.soft = True
    captured = {}
    soft_nms = nms_ops.soft_nms

    def capture(boxes, scores_, threshold, sigma):
        captured.update(boxes=boxes, scores=scores_)
        return soft_nms(boxes, scores_, threshold, sigma)

    nms_ops.soft_nms = capture
    try:
        zero_launches()
        dets, valid = soft(scores, locs, pred.anchors)
        torch.cuda.synchronize()
    finally:
        nms_ops.soft_nms = soft_nms
    if nms_kernel.nms_keep_batched.launches:
        fail('soft-NMS launched the hard NMS kernel')
    # the pick mask on the same inputs on the card and on the CPU
    args = (soft.score_threshold, soft.sigma)
    picks = soft_nms(captured['boxes'], captured['scores'], *args)
    cpu_picks = soft_nms(captured['boxes'].cpu(), captured['scores'].cpu(),
                         *args)
    if not torch.equal(picks.cpu(), cpu_picks):
        fail('soft-NMS picks on the card differ from the CPU\'s on the same '
             f'inputs in {(picks.cpu() != cpu_picks).sum().item()} places')
    # end to end, the softmax and decode of each device: rows that agree
    cpu_dets, cpu_valid = soft(scores.cpu(), locs.cpu(), pred.anchors.cpu())
    close = ((dets.cpu() - cpu_dets).abs()
             <= SOFT_NMS_ATOL + SOFT_NMS_RTOL * cpu_dets.abs()).all(-1)
    same_rows = (close & (valid.cpu() == cpu_valid)).double().mean().item()
    hard_valid = pred.postprocessor(scores, locs, pred.anchors)[1]
    out['soft_nms'] = {
        'b32_ms': cuda_ms(lambda: soft(scores, locs, pred.anchors), iters=10),
        'soft_nms_alone_b32_ms': cuda_ms(
            lambda: soft_nms(captured['boxes'], captured['scores'], *args),
            iters=10),
        'picks': int(picks.sum()), 'rows_equal_to_cpu': same_rows,
        'valid_mean': valid.sum(1).double().mean().item(),
        'hard_valid_mean': hard_valid.sum(1).double().mean().item()}
    log(f'  soft-NMS b32 (sigma {soft.sigma}, K {soft.max_per_class}): '
        f'{out["soft_nms"]["b32_ms"]:.3f} ms per postprocessor call '
        f'({out["soft_nms"]["soft_nms_alone_b32_ms"]:.3f} ms in soft_nms), '
        'no NMS kernel launch; picks on the card == CPU on the same inputs '
        f'({int(picks.sum())} picks); end to end {same_rows:.2%} of the '
        'detection rows equal to the CPU\'s; '
        f'{out["soft_nms"]["valid_mean"]:.1f} detections per image (hard '
        f'NMS {out["soft_nms"]["hard_valid_mean"]:.1f})')
    del preds, pred, outs
    torch.cuda.empty_cache()
    return out


def step_turns(trainers: dict, batch, iters: int) -> dict:
    """Each trainer's step in turns (``in_turns``) and its device time per
    step (every kernel, from the profiler)."""
    out = in_turns({name: (lambda t=t: t.train_step(*batch))
                    for name, t in trainers.items()}, iters=iters)
    for name, t in trainers.items():
        # one step a window: a window's trace takes seconds to read
        out[name]['device_ms'] = device_busy_ms(lambda: t.train_step(*batch),
                                                iters=1)
    return out


def stats_distance(a: Trainer, b: Trainer):
    """The largest difference of the BN running statistics of two
    trainers, as a fraction of max(1, |value|) of each tensor, and its
    tensor."""
    got, want = a.model.state_dict(), b.model.state_dict()
    return max(((got[k] - want[k]).abs().max().item()
                / max(1.0, want[k].abs().max().item()), k)
               for k in want if k.endswith(('running_mean', 'running_var')))


def bf16_against_library_bn(trainer: Trainer, f32: Trainer, batch) -> dict:
    """One step from ``trainer``'s state three ways: bf16 with the BN
    kernels (``trainer``), bf16 with PyTorch's BN, f32 with the kernels
    (``f32``): the two bf16 losses within ``BF16_LIBRARY_LOSS_RTOL``, their
    running statistics within ``BF16_STATS_FACTOR`` times the kernels'
    bf16-to-f32 distance."""
    library = build_trainer(False, bf16=True)
    for other in (library, f32):
        other.model.load_state_dict(trainer.model.state_dict())
        other.state.optimizer.load_state_dict(
            trainer.state.optimizer.state_dict())
        other.state.step = trainer.state.step
    on, off, wide = (t.train_step(*batch)['loss'].item()
                     for t in (trainer, library, f32))
    loss_rel = abs(on - off) / abs(off)
    if not loss_rel <= BF16_LIBRARY_LOSS_RTOL:
        fail(f'bf16 loss with the BN kernels {on} vs PyTorch BN {off}')
    stats_err, worst = stats_distance(trainer, library)
    f32_err, f32_worst = stats_distance(trainer, f32)
    if not stats_err <= BF16_STATS_FACTOR * f32_err:
        fail(f'bf16 running statistics, BN kernels vs PyTorch BN: {stats_err} '
             f'({worst}), over {BF16_STATS_FACTOR} x their distance to f32 '
             f'{f32_err} ({f32_worst})')
    log(f'  one bf16 step, BN kernels vs PyTorch BN: loss {on:.6f} vs '
        f'{off:.6f} (rel {loss_rel:.3g}, tol {BF16_LIBRARY_LOSS_RTOL}; f32 '
        f'{wide:.6f}); running statistics {stats_err:.3g} of max(1, |value|) '
        f'({worst}) against bf16 vs f32 {f32_err:.3g} ({f32_worst})')
    del library
    torch.cuda.empty_cache()
    return {'loss_rel_err': loss_rel, 'f32_loss': wide,
            'stats_max_rel_err': stats_err, 'f32_stats_max_rel_err': f32_err}


def bf16_training(card: str, smi: str, parent_bn=None) -> dict:
    """The flagship's b32 train step with ``bf16`` and ``fused_bn``: 3
    steps with the BN counts read around them, one step against the same
    bf16 step with PyTorch's BN, K1-K4 at bf16 on every distinct BN shape
    of the step, each BN kernel's device time over a step beside its bf16
    bound and the PyTorch pairs at bf16, each kernel per launch at
    ``BN_TIMED_SHAPE`` in bf16; the step at f32, TF32 and bf16 in turns;
    with ``parent_bn``, the parent build's K2 and K4 in the step in turns."""
    trainers = {name: build_trainer(True, **policy)
                for name, policy in POLICIES.items()}
    trainer = trainers['bf16']
    n_bn = sum(isinstance(m, BatchNorm) for m in trainer.model.modules())
    rng = np.random.RandomState(SEED + 10)
    batches = [train_batch(rng) for _ in range(3)]
    zero_launches()
    metrics, launches = run_training_path(trainer, batches)
    check_training_path(metrics, launches, n_bn)
    launches['nms_keep_batched'] = nms_kernel.nms_keep_batched.launches
    log(f'  bf16 train_step(32) x 3 with fused_bn: losses '
        + ', '.join(f'{m["loss"]:.4f}' for m in metrics)
        + '; BN kernel launches ' + json.dumps(launches))
    library = bf16_against_library_bn(trainer, trainers['f32'], batches[0])
    step = profile_train_step(trainer, batches[0], n_bn, card, 'flagship',
                              table=False, parent_bn=parent_bn, itemsize=2)
    shapes = step.pop('bn_shapes')
    distinct = sorted(set(shapes), key=math.prod, reverse=True)
    bn_check = check_bn_kernels(
        [BnCase(str(list(s)), s, torch.bfloat16) for s in distinct], quiet=True)
    log(f'  K1-K4 at bf16 vs plain on the {len(distinct)} distinct BN shapes '
        'of the bf16 step: within BN_TOL, K1, K2 and K3 bit-equal twice')
    turns = step_turns(trainers, batches[0], iters=6)
    del trainers, trainer
    torch.cuda.empty_cache()
    library_step = library_bn_step_ms(shapes, torch.bfloat16)
    per_launch = time_bn_kernels(card, torch.bfloat16)
    log_bn_kernels(per_launch, 'bf16')
    log_bn_step(step, library_step, n_bn)
    log(f'  {smi}: flagship train_step b32 in turns: ' + ', '.join(
        f'{name} {row["ms"]:.2f} ms ({row["device_ms"]:.2f} ms device)'
        for name, row in turns.items()))
    return {'n_bn': n_bn, 'losses': [m['loss'] for m in metrics],
            'launches': launches, **library, 'bn_step': step,
            'library_step_ms': library_step, 'per_launch': per_launch,
            'bn_max_abs_err': bn_check, 'device_busy_ms': step['device_busy_ms'],
            'turns': turns}


def bf16_retina(smi: str) -> dict:
    """RetinaNet-ResNet50-500's b16 train step with ``fused_bn`` at f32,
    TF32 and bf16 in turns: ms and device ms."""
    trainers = {name: build_trainer(True, RETINA, **policy)
                for name, policy in POLICIES.items()}
    batch = train_batch(np.random.RandomState(SEED + 11), ZOO_BATCH, size=500)
    for name, t in trainers.items():
        loss = t.train_step(*batch)['loss'].item()
        if not np.isfinite(loss):
            fail(f'RetinaNet {name} step: loss {loss}')
    turns = step_turns(trainers, batch, iters=3)
    log(f'  {smi}: {RETINA} train_step b{ZOO_BATCH} in turns: ' + ', '.join(
        f'{name} {row["ms"]:.2f} ms ({row["device_ms"]:.2f} ms device)'
        for name, row in turns.items()))
    del trainers
    torch.cuda.empty_cache()
    return turns


def run_precision(card: str, smi: str, parent_bn=None) -> dict:
    """Phase 15: bf16 and the precision options on the main paths."""
    out = {'serving': bf16_serving(card, smi),
           'training': bf16_training(card, smi, parent_bn),
           'retina': bf16_retina(smi)}
    work = tempfile.mkdtemp(prefix='chip_smoke_bf16_')
    try:
        cli_run = zoo_cli(work, out['training']['n_bn'], FLAGSHIP, CLI_DATA,
                          flags=('--bf16',))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if cli_run['dtype'] != str(torch.bfloat16):
        fail(f'--bf16 ran the model in {cli_run["dtype"]}')
    out['cli'] = cli_run
    return out


# --------------------------------------------------------------- phase 16

# The int8 serving points (export/quantize.py): (label, config, batch,
# explicit int8 block).  SSD300-VGG16 at b32 and b128 (the JAX package's
# preset serves the VGG family int8), the flagship at b128 (its gate lets a
# MobileNet through from b128) and at b32 forced past the gate with an
# explicit block, to record what the gate refuses.
INT8_POINTS = (('vgg_b32', VGG, 32, False), ('vgg_b128', VGG, 128, False),
               ('flagship_b128', FLAGSHIP, 128, False),
               ('flagship_b32_forced', FLAGSHIP, 32, True))
INT8_CALIBRATION_BATCHES = 2
# The card's int8 heads against the CPU's, both from the same amax.  The
# s32 accumulators are held exact on the same int8 inputs; end to end the
# float parts between the convs (BN, depthwise convs) round in another
# order on the card, and one activation put on the other side of a
# quantization boundary moves the next conv's input by a whole step, a
# flip that cascades through the layers (the first card run, SSD300-VGG16
# at b2: 0.014 against int8's distance from f32 of 0.023, while the f32
# heads agree to rounding).  So each head is held within this share of the
# CPU's own int8-to-f32 distance: int8 noise of the same size, not a wrong
# product or layout, whose errors are of the heads' own size
INT8_CARD_VS_CPU_SHARE = 1.0
# Detections of the int8 and the f32 forward matched at this IoU with the
# same class (a share, reported)
INT8_MATCH_IOU = 0.5
QAT_STEPS = 5


def int8_predictors(config: str, batches, explicit: bool) -> dict:
    """f32, bf16 and int8 ``Predictor``s of ``config`` with the seeded
    weights and perturbed BNs of phase 4; the int8 one shares the f32 one's
    model, calibrated on ``batches`` (uint8 images) through its eval
    preprocessing, with the gate's options at the batch of ``batches``."""
    from single_shot_detection_tpu_torch.export import quantize
    from single_shot_detection_tpu_torch.utils.config import load_config
    preds = {name: Predictor.from_config(config, device='cuda', seed=SEED,
                                         **policy)
             for name, policy in (('f32', {}), ('bf16', {'bf16': True}))}
    for pred in preds.values():
        perturb_bn(pred.model, torch.Generator().manual_seed(SEED + 1))
    f32 = preds['f32']
    cfg = load_config(config, phases=('eval',))
    if explicit:
        cfg.config.int8 = {}
    enabled, opts = quantize.resolve_int8_opts(cfg, batch_size=len(batches[0]))
    if not enabled:
        fail(f'{config}: the int8 gate refused b{len(batches[0])}')
    with torch.inference_mode():
        amax = quantize.calibrate(f32.model, [
            f32.preprocess(torch.from_numpy(b).cuda()) for b in batches])
    preds['int8'] = Predictor(f32.bundle, f32.postprocessor, f32.preprocess,
                              f32.device, f32.policy, amax,
                              opts.get('spatial_limit'))
    return {'preds': preds, 'amax': amax,
            'spatial_limit': opts.get('spatial_limit')}


def record_int8_inputs(model, amax, x, spatial_limit):
    """One int8 forward of ``x``: each quantized conv's int8 inputs, in
    order of application, and every conv's float input (the split's
    shapes)."""
    from single_shot_detection_tpu_torch.export import quantize
    from single_shot_detection_tpu_torch.models.layers import Conv2d
    modes = quantize.make_interceptor(model, amax, spatial_limit)
    int8_in, float_in = [], []

    def recorder(key, mode):
        def call(conv, x):
            if mode is not None and not quantize._over_limit(x, spatial_limit):
                int8_in.append((key, quantize.quantize_input(x, mode.x_scale)))
                float_in.append((key, 'int8', x))
                return mode(conv, x)
            float_in.append((key, 'float', x))
            return conv.float_forward(x)
        return call

    convs = {name.replace('.', '/'): m for name, m in model.named_modules()
             if isinstance(m, Conv2d)}
    try:
        for key, conv in convs.items():
            conv.quant = recorder(key, modes.get(key))
        with torch.inference_mode():
            model(x)
    finally:
        for conv in convs.values():
            conv.quant = None
    return modes, int8_in, float_in, convs


def int8_accumulators_vs_cpu(pred: Predictor, amax, x, spatial_limit) -> dict:
    """Every quantized conv's s32 accumulator on the card against the CPU's
    on the same int8 inputs (captured on the card), bit for bit; the int8
    weights too."""
    from single_shot_detection_tpu_torch.export import quantize
    modes, int8_in, _, _ = record_int8_inputs(pred.model, amax, x,
                                              spatial_limit)
    cpu_modes = quantize.make_interceptor(copy.deepcopy(pred.model).cpu(),
                                          amax, spatial_limit)
    for key, mode in modes.items():
        if not torch.equal(mode.w_t.cpu(), cpu_modes[key].w_t):
            fail(f'int8 weights of {key} differ between the card and the CPU')
    macs = 0
    with torch.inference_mode():
        for key, x_q in int8_in:
            card = modes[key].accumulator(x_q)
            cpu = cpu_modes[key].accumulator(x_q.cpu())
            if card.dtype != torch.int32 or not torch.equal(card.cpu(), cpu):
                fail(f'the s32 accumulator of {key} differs between the card '
                     f'and the CPU')
            macs += card.numel() * modes[key].k
    return {'convs': len(modes), 'applications': len(int8_in),
            'int8_macs': macs}


def int8_heads_vs_cpu(pred: Predictor, amax, x, spatial_limit) -> dict:
    """The card's int8 heads against the CPU's int8 heads from the same
    amax, within ``INT8_CARD_VS_CPU_SHARE`` of the CPU's int8-to-f32
    distance; the detections' valid masks compared."""
    from single_shot_detection_tpu_torch.export import quantize
    cpu_model = copy.deepcopy(pred.model).cpu()
    with torch.inference_mode():
        card = quantize.quantized_apply(pred.model, amax, spatial_limit)(x)
        card_f32 = pred.model(x)
        cpu = quantize.quantized_apply(cpu_model, amax, spatial_limit)(x.cpu())
        cpu_f32 = cpu_model(x.cpu())
    out = {}
    for i, name in enumerate(('scores', 'locs')):
        err = (card[i].cpu() - cpu[i]).abs().max().item()
        noise = (cpu[i] - cpu_f32[i]).abs().max().item()
        f32_err = (card_f32[i].cpu() - cpu_f32[i]).abs().max().item()
        if not err <= INT8_CARD_VS_CPU_SHARE * noise:
            fail(f'int8 {name} on the card differ from the CPU\'s by {err}, '
                 f'more than {INT8_CARD_VS_CPU_SHARE} of int8\'s distance '
                 f'from f32 ({noise})')
        out[name] = {'max_abs_err': err, 'int8_vs_f32': noise,
                     'f32_card_vs_cpu': f32_err}
    d_card, v_card = pred.postprocessor(card[0].float(), card[1].float(),
                                        pred.anchors)
    d_cpu, v_cpu = nms_plain_postprocess(pred, cpu[0], cpu[1])
    out['detections_matched_card_vs_cpu'] = matched_share(
        d_cpu, v_cpu, d_card.cpu(), v_card.cpu())
    return out


def nms_plain_postprocess(pred: Predictor, scores, locs):
    """The postprocessor on the CPU with the plain NMS."""
    plain = copy.copy(pred.postprocessor)
    plain.nms_keep = lambda boxes, s: nms_ops.nms_keep_sorted(
        boxes, s, plain.overlap_threshold)
    return plain(scores.float(), locs.float(), pred.anchors.cpu())


def matched_share(dets_a, valid_a, dets_b, valid_b) -> float:
    """The share of ``a``'s valid detections that a valid detection of
    ``b`` of the same class matches at IoU >= ``INT8_MATCH_IOU`` (each ``b``
    row matched once, greedily in ``a``'s score order)."""
    from single_shot_detection_tpu_torch.ops.boxes import iou
    hits = total = 0
    for i in range(dets_a.shape[0]):
        a, b = dets_a[i][valid_a[i]], dets_b[i][valid_b[i]]
        total += len(a)
        if not len(a) or not len(b):
            continue
        overlap = iou(a[:, :4], b[:, :4])
        overlap[a[:, 4:5] != b[None, :, 4]] = -1
        used = torch.zeros(len(b), dtype=torch.bool, device=b.device)
        for r in range(len(a)):
            row = overlap[r].masked_fill(used, -1)
            j = int(row.argmax())
            if row[j] >= INT8_MATCH_IOU:
                used[j] = True
                hits += 1
    return hits / max(total, 1)


def int8_split(pred: Predictor, amax, x, spatial_limit, iters: int = 10) -> dict:
    """Device ms of one int8 forward of ``x`` by part, each part timed alone
    with CUDA events on the inputs this forward gives it (warm in the L2
    where they fit), summed over the convs' applications: the quantize
    passes, the im2col, ``torch._int_mm``, the dequant epilogue (the float
    cast, scale, bias and output cast), the float convs (depthwise, and
    convs beyond ``spatial_limit``); and the NMS kernel of the whole call
    and the call's device busy time from the profiler."""
    from single_shot_detection_tpu_torch.export import quantize
    modes, int8_in, float_in, convs = record_int8_inputs(pred.model, amax, x,
                                                         spatial_limit)
    parts = collections.Counter()
    with torch.inference_mode():
        for key, kind, inp in float_in:
            conv = convs[key]
            if kind == 'float':
                parts['float_convs'] += cuda_ms(lambda: conv.float_forward(inp),
                                                iters)
                continue
            mode = modes[key]
            x_q = quantize.quantize_input(inp, mode.x_scale)
            parts['quantize'] += cuda_ms(
                lambda: quantize.quantize_input(inp, mode.x_scale), iters)
            a, (b, ho, wo) = quantize.im2col(x_q, mode.kernel_size, mode.stride,
                                             mode.padding, mode.k_pad)
            parts['im2col'] += cuda_ms(lambda: quantize.im2col(
                x_q, mode.kernel_size, mode.stride, mode.padding, mode.k_pad),
                iters)
            y = torch._int_mm(a, mode.w_t)
            parts['int_mm'] += cuda_ms(lambda: torch._int_mm(a, mode.w_t), iters)
            m = b * ho * wo

            def epilogue():
                out = y[:m, :mode.n].to(torch.float32) * mode.scale
                if mode.bias is not None:
                    out = out + mode.bias
                return out.to(inp.dtype)

            parts['dequant'] += cuda_ms(epilogue, iters)
    # the whole call: its NMS kernel and its device busy time
    prof = profile_window(lambda: (pred.predict_step(x), torch.cuda.synchronize()))
    nms_us, nms_n = device_us(prof, 'nms_keep_kernel')
    out = {k: parts[k] for k in ('quantize', 'im2col', 'int_mm', 'dequant',
                                 'float_convs')}
    out.update(nms=nms_us / 1e3, nms_launches=nms_n,
               call_device_busy_ms=busy_us(prof) / 1e3,
               call_launches=busy_launches(prof))
    return out


def int8_serving_point(label: str, config: str, batch: int, explicit: bool,
                       card: str, exact: bool, split: bool) -> dict:
    """One serving point: calibrate on ``INT8_CALIBRATION_BATCHES``
    batches; with ``exact`` the accumulators and the heads against the CPU
    (at b2) and the NMS kernel exact on the int8 inputs; the NMS count
    around 2 int8 calls (and no BN launch); int8 against f32 detections;
    ``predict_batch`` ms of f32, bf16 and int8 in turns (f32, bf16, int8,
    int8, bf16, f32); with ``split`` the int8 call's device split."""
    size = 300
    rng = np.random.RandomState(SEED + 16)
    calib = [rng.randint(0, 256, (batch, size, size, 3), dtype=np.uint8)
             for _ in range(INT8_CALIBRATION_BATCHES)]
    built = int8_predictors(config, calib, explicit)
    preds, amax, limit = built['preds'], built['amax'], built['spatial_limit']
    int8 = preds['int8']
    images = rng.randint(0, 256, (batch, size, size, 3), dtype=np.uint8)
    out = {'config': config, 'batch': batch, 'explicit_int8_block': explicit,
           'spatial_limit': limit, 'calibrated_convs': len(amax)}
    if exact:
        x2 = int8.preprocess(torch.from_numpy(images[:2]).cuda())
        out['accumulators'] = int8_accumulators_vs_cpu(int8, amax, x2, limit)
        out['heads_vs_cpu'] = int8_heads_vs_cpu(int8, amax, x2, limit)
        out['nms'] = time_nms(int8.postprocessor.overlap_threshold, {
            f'int8 {label}': nms_inputs(int8, images)}, card)
    zero_launches()
    runs = [int8.predict_batch(images) for _ in range(2)]
    torch.cuda.synchronize()
    launches = read_launches()
    if launches['nms_keep_batched'] != 2 or any(
            launches[fn.__name__] for fn in bn_kernel.KERNELS):
        fail(f'int8 serving {label} launched {launches}, expected NMS 2, '
             'no BN')
    dets, valid = runs[0]
    if (tuple(dets.shape) != (batch, int8.postprocessor.max_total, 6)
            or not torch.isfinite(dets).all()):
        fail(f'int8 predict_batch {label}: shape {tuple(dets.shape)} or '
             'non-finite detections')
    if not (torch.equal(runs[0][0], runs[1][0])
            and torch.equal(runs[0][1], runs[1][1])):
        fail(f'int8 predict_batch {label}: two calls differ')
    f32_dets, f32_valid = preds['f32'].predict_batch(images)
    out.update(launches=launches,
               valid_per_image_mean=valid.sum(1).double().mean().item(),
               matched_share_vs_f32=matched_share(f32_dets, f32_valid, dets,
                                                  valid))
    turns = in_turns({name: (lambda p=p: p.predict_batch(images))
                      for name, p in preds.items()}, iters=5)
    out['turns'] = {name: {'ms': t['ms'], 'img_per_s': batch * 1e3 / t['ms'],
                           'all_ms': t['all_ms']} for name, t in turns.items()}
    if split:
        x = int8.preprocess(torch.from_numpy(images).cuda())
        out['split'] = int8_split(int8, amax, x, limit)
    log(f'  int8 {label} ({config}, b{batch}'
        + (', explicit int8 block' if explicit else '')
        + (f', spatial_limit {limit}' if limit else '') + f'): {len(amax)} '
        f'convs calibrated; img/s ' + ', '.join(
            f'{name} {t["img_per_s"]:.1f} ({t["ms"]:.2f} ms)'
            for name, t in out['turns'].items())
        + f'; int8 vs f32 detections matched {out["matched_share_vs_f32"]:.3f}'
        + (f'; s32 accumulators of {out["accumulators"]["applications"]} '
           'applications == CPU; heads vs CPU '
           + json.dumps(out['heads_vs_cpu']) if exact else '')
        + (f'; device split (ms) {json.dumps(out["split"])}' if split else ''))
    del preds, built, int8, runs
    torch.cuda.empty_cache()
    return out


def qat_training(smi: str) -> dict:
    """The flagship's b32 step with ``train.qat`` (``fused_bn`` off, as the
    JAX engine requires): ``QAT_STEPS`` steps with every kernel's count read
    around them (no BN kernel, no NMS), ``act_amax`` changing and finite;
    the step ms in turns against the float step (``fused_bn`` off too);
    then an int8 ``Predictor`` on the QAT-learned scales (no calibration)
    answers a b32 batch with the NMS kernel."""
    from single_shot_detection_tpu_torch.export import quantize
    trainers = {name: Trainer.from_config(FLAGSHIP, device='cuda', seed=SEED,
                                          overrides={'augmentations': [],
                                                     'train': {'fused_bn': False,
                                                               **extra}})
                for name, extra in (('float', {}), ('qat', {'qat': True}))}
    qat = trainers['qat']
    rng = np.random.RandomState(SEED + 17)
    batches = [train_batch(rng) for _ in range(QAT_STEPS)]
    seen = []
    zero_launches()
    metrics = []
    for b in batches:
        metrics.append(qat.train_step(*b))
        seen.append(quantize.amax_from_batch_stats(qat.model.state_dict()))
    torch.cuda.synchronize()
    launches = read_launches()
    if any(launches.values()):
        fail(f'the QAT step launched {launches}, expected no kernel')
    losses = [m['loss'].item() for m in metrics]
    if not all(np.isfinite(losses)):
        fail(f'QAT losses {losses}')
    keys = {k for k, _ in quantize.supported_convs(qat.model)}
    if set(seen[0]) != keys or not all(np.isfinite(v) and v > 0
                                       for v in seen[-1].values()):
        fail('QAT act_amax not seeded on every conv, or not finite')
    changed = sum(seen[-1][k] != seen[0][k] for k in keys)
    if not changed:
        fail('QAT act_amax did not change over the steps')
    turns = in_turns({name: (lambda t=t: (t.train_step(*batches[0]),
                                          torch.cuda.synchronize()))
                      for name, t in trainers.items()}, iters=5)
    # int8 serving on the learned scales
    serving = Predictor.from_config(FLAGSHIP, device='cuda', seed=SEED)
    learned = quantize.amax_from_batch_stats(qat.model.state_dict())
    int8 = Predictor(qat.bundle, serving.postprocessor, serving.preprocess,
                     qat.device, serving.policy, learned)
    images = rng.randint(0, 256, (32, 300, 300, 3), dtype=np.uint8)
    zero_launches()
    dets, valid = int8.predict_batch(images)
    torch.cuda.synchronize()
    eval_launches = read_launches()
    if eval_launches['nms_keep_batched'] != 1 or not torch.isfinite(dets).all():
        fail(f'int8 serving on the QAT scales: launches {eval_launches}')
    out = {'losses': losses, 'launches': launches,
           'act_amax_convs': len(keys), 'act_amax_changed': changed,
           'act_amax_first': seen[0], 'act_amax_last': seen[-1],
           'turns': {name: {'ms': t['ms'], 'all_ms': t['all_ms']}
                     for name, t in turns.items()},
           'int8_eval_launches': eval_launches,
           'int8_eval_valid_mean': valid.sum(1).double().mean().item()}
    log(f'  QAT: {QAT_STEPS} x train_step(32) on {FLAGSHIP}, losses '
        + ', '.join(f'{v:.4f}' for v in losses) + f'; act_amax on {len(keys)} '
        f'convs, {changed} changed over the steps, all finite; launches '
        f'{json.dumps(launches)}; step ms in turns: QAT '
        f'{turns["qat"]["ms"]:.2f}, float {turns["float"]["ms"]:.2f} '
        f'(fused_bn off); int8 b32 on the learned scales: NMS '
        f'{eval_launches["nms_keep_batched"]} launch, '
        f'{out["int8_eval_valid_mean"]:.1f} valid per image')
    del trainers, qat, int8, serving
    torch.cuda.empty_cache()
    return out


def int8_jax_checkpoint(f32_metrics: dict) -> dict:
    """The committed JAX checkpoint through ``--int8`` (``Experiment(int8=
    True)`` with an explicit ``int8`` block) on the card: its int8 mAP
    above the JAX test's 0.55, beside phase 11's f32 mAP on the card."""
    work = tempfile.mkdtemp(prefix='chip_smoke_int8_')
    try:
        config = Path(work) / 'config.py'
        config.write_text((REPO / JAX_RUN / 'config.py').read_text()
                          + '\n# chip_smoke.py phase 16: int8 evaluation\n'
                          + 'int8 = {}\n')
        zero_launches()
        exp, metrics = cli.main(['--config', str(config), '--checkpoint',
                                 JAX_RUN, '--phases', 'eval', '--int8'])
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if metrics.get('int8') != 1.0 or not metrics['mAP'] > 0.55:
        fail(f'the JAX checkpoint at int8: {metrics}')
    if launches['nms_keep_batched'] != len(exp.loaders['eval']):
        fail(f'the int8 evaluation launched {launches}')
    log(f'  the JAX checkpoint through --int8 on the card: mAP '
        f'{metrics["mAP"]!r} (f32 on the card {f32_metrics["mAP"]!r}; bar '
        f'0.55), loss {metrics["loss"]!r}, {len(exp._int8_amax)} convs '
        f'calibrated on {min(2, len(exp.loaders["eval"]))} eval batches; '
        'launches '
        + json.dumps(launches))
    return {'int8': metrics, 'f32_mAP': f32_metrics['mAP'],
            'launches': launches, 'convs': len(exp._int8_amax)}


def run_int8(card: str, smi: str, f32_checkpoint: dict) -> dict:
    """Phase 16: the int8 serving points, QAT and the JAX checkpoint at
    int8."""
    out = {}
    for label, config, batch, explicit in INT8_POINTS:
        out[label] = int8_serving_point(
            label, config, batch, explicit, card,
            exact=label in ('vgg_b32', 'flagship_b128'),
            split=label in ('vgg_b32', 'flagship_b128'))
    out['qat'] = qat_training(smi)
    out['jax_checkpoint'] = int8_jax_checkpoint(f32_checkpoint)
    return out


# --------------------------------------------------------------- phase 17

TRANSFER_DEPTHS = (0, 2, 2, 0)


def run_transfer_ahead(smi: str) -> dict:
    """Phase 17: the flagship's augmented ``Experiment`` epoch (phase 8's
    data) at ``train.transfer_ahead`` 0 and 2 in turns, img/s each; and the
    batch stream on the card at the two depths, equal tensor for tensor."""
    from single_shot_detection_tpu_torch.train.engine import prefetch_to_device
    exp = build_experiment()
    loader = exp.loaders['train']
    streams = {}
    for depth in (0, 2):
        loader.epoch = 0
        streams[depth] = [t for _, t in prefetch_to_device(loader, exp.device,
                                                           depth)]
    torch.cuda.synchronize()
    if len(streams[0]) != len(streams[2]) or not all(
            a.device.type == exp.device.type and torch.equal(a, b)
            for x, y in zip(streams[0], streams[2]) for a, b in zip(x, y)):
        fail('the batch stream differs between transfer_ahead 0 and 2')
    del streams
    exp.train_epoch(0)  # warm-up
    seconds = {0: [], 2: []}
    for i, depth in enumerate(TRANSFER_DEPTHS):
        exp.transfer_ahead = depth
        t = time.perf_counter()
        exp.train_epoch(i + 1)  # reads its sums: waits for the card
        seconds[depth].append(time.perf_counter() - t)
    images = len(loader) * loader.batch_size
    out = {'steps': len(loader), 'epoch_s': seconds,
           'img_per_s': {d: [images / s for s in v] for d, v in seconds.items()},
           'stream_equal': True}
    log(f'[17] {smi}: the flagship\'s augmented epoch ({len(loader)} '
        f'b{loader.batch_size} steps, synthetic 500 px data) in turns '
        f'{TRANSFER_DEPTHS}: '
        + '; '.join(f'transfer_ahead {d}: ' + ', '.join(
            f'{s:.3f} s = {images / s:.1f} img/s' for s in v)
            for d, v in seconds.items())
        + '; the batch stream on the card equal at 0 and 2')
    del exp
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 18

# The JAX package's export path in the port (export/__init__.py): the
# artifacts phase 18 exports on the card, each (label, experiment, batch,
# export_model's options); the three f32 flagship points share one
# experiment.  The standalone ones take raw resized RGB and bake weights,
# normalization and NMS in.
STANDALONE = {'with_postprocess': True, 'with_preprocess': True,
              'bake_variables': True}
EXPORT_POINTS = (
    ('plain_b32', 'flagship', 32, {}),
    ('standalone_b32', 'flagship', 32, STANDALONE),
    ('standalone_b128', 'flagship', 128, STANDALONE),
    ('bf16_standalone_b128', 'flagship_bf16', 128, STANDALONE),
    ('vgg_int8_standalone_b32', 'vgg_int8', 32, {**STANDALONE, 'int8': True}),
)
# each experiment's (config, Experiment options); SSD300-VGG16's int8 one
# calibrates on the eval batches of EXPORT_VGG_DATA at its point's batch,
# so the serving gate is judged there
EXPORT_EXPERIMENTS = {'flagship': (FLAGSHIP, {}),
                      'flagship_bf16': (FLAGSHIP, {'bf16': True}),
                      'vgg_int8': (VGG, {'int8': True})}
EXPORT_VGG_DATA = {'eval': {'name': 'Synthetic', 'num_images': 64,
                            'image_size': 300, 'num_classes': 21,
                            'max_boxes': 6, 'seed': 2}}
# An artifact against the eager path on the same inputs: ``valid`` equal,
# and detections (probabilities and boxes for the plain one) within phase
# 4's agreement of the card's forward with the CPU's
EXPORT_TOL = 1e-3
# calls a side in each turn of an artifact against the eager call: the b32
# points 5, the b128 points (device-bound, 35-40 ms a call) 2
EXPORT_TURN_ITERS = {32: 5, 128: 2}
BATCHER_IMAGES, BATCHER_THREADS = 64, 8


def export_experiment(key: str, batch: int) -> Experiment:
    """``EXPORT_EXPERIMENTS[key]`` on the card, with phase 4's seeded
    weights and perturbed BNs; an ``int8`` one calibrates at ``batch``."""
    config, options = EXPORT_EXPERIMENTS[key]
    overrides, phases = {}, ('export',)
    if options.get('int8'):
        phases = ('eval', 'export')
        overrides = {'dataset': EXPORT_VGG_DATA, 'batch_size': batch}
    exp = Experiment(config, phases=phases, device='cuda', seed=SEED,
                     overrides=overrides, **options)
    perturb_bn(exp.model, torch.Generator().manual_seed(SEED + 1))
    return exp


def export_timed(exp: Experiment, path: str, batch: int, options: dict):
    """``export_model`` then ``load_exported_with_spec``: ``(call, specs,
    {'export_s', 'load_s', 'file_bytes'})``."""
    from single_shot_detection_tpu_torch.export import (export_model,
                                                        load_exported_with_spec)
    t = time.perf_counter()
    path = export_model(exp, path, batch_size=batch, **options)
    export_s = time.perf_counter() - t
    t = time.perf_counter()
    call, specs = load_exported_with_spec(path)
    load_s = time.perf_counter() - t
    return path, call, specs, {'export_s': export_s, 'load_s': load_s,
                               'file_bytes': os.path.getsize(path)}


def plain_eager(pred: Predictor, x: torch.Tensor):
    """The plain artifact's function on the eager path: the forward, f32
    softmax scores and decoded corner boxes."""
    from single_shot_detection_tpu_torch.ops import boxes as box_ops
    with torch.inference_mode(), pred.policy.scope():
        scores, locs = pred.model(x)
        coder = pred.postprocessor.box_coder
        return (torch.softmax(scores.float(), -1), box_ops.to_corners(
            coder.decode(locs.float(), pred.anchors)))


def outputs_agree(label: str, got, want, with_valid: bool) -> dict:
    """``valid`` equal (postprocessed outputs) and the values within
    ``EXPORT_TOL``; whether they are equal bit for bit."""
    if with_valid:
        (dets, valid), (want_d, want_v) = got, want
        if not torch.equal(valid, want_v):
            fail(f'export {label}: valid differs from the eager path in '
                 f'{(valid != want_v).sum().item()} slots')
        pairs = [(dets[valid], want_d[want_v])]
        bit_equal = torch.equal(dets, want_d)
    else:
        pairs = list(zip(got, want))
        bit_equal = all(torch.equal(a, b) for a, b in pairs)
    err = max((a - b).abs().max().item() for a, b in pairs)
    if not err <= EXPORT_TOL:
        fail(f'export {label}: the artifact differs from the eager path by '
             f'{err} (tol {EXPORT_TOL})')
    return {'max_abs_err': err, 'bit_equal': bit_equal}


def artifact_launches(call, *inputs) -> dict:
    """Every kernel's count around one artifact call."""
    zero_launches()
    call(*inputs)
    torch.cuda.synchronize()
    return read_launches()


class ExportPoint(NamedTuple):
    """A checked artifact with what its timing needs."""
    out: dict
    path: str
    call: object
    inputs: tuple
    eager: object


def export_point(label, config, exp, batch, options, work,
                 rng) -> ExportPoint:
    """One artifact: exported on the card, loaded, held against the
    experiment's own ``Predictor`` on the same inputs, its kernel launches
    in one call (one NMS launch a call, none without the postprocessor, no
    BN).  The eager side takes uint8 images on the card, the artifact f32
    ones (raw RGB for the standalone artifacts, normalized NHWC with the
    weights for the plain one), both already on the card."""
    from single_shot_detection_tpu_torch.device import current_flags, set_flags
    pred = exp.predictor()
    if options.get('int8') and not exp.int8:
        fail(f'export {label}: the int8 gate refused b{batch}')
    path, call, specs, info = export_timed(exp, os.path.join(work, label),
                                           batch, options)
    w, h = exp.input_size
    images = torch.from_numpy(rng.randint(0, 256, (batch, h, w, 3),
                                          dtype=np.uint8)).cuda()
    meta = call.meta
    out = {'config': config, 'batch': batch, **info,
           'flags': meta['flags'], 'dtype': meta['dtype'],
           'inputs': len(specs), 'input_shape': list(specs[-1].shape)}
    if options.get('bake_variables'):
        if specs[0].shape != (batch, h, w, 3) or len(specs) != 1:
            fail(f'export {label}: input specs {specs}')
        inputs = (images.float(),)
        want = pred.predict_batch(images)
        eager_fn = lambda: pred.predict_batch(images)  # noqa: E731
    else:
        x = pred.preprocess(images)
        inputs = (dict(exp.model.state_dict()),
                  x.permute(0, 2, 3, 1).contiguous())
        want = plain_eager(pred, x)
        eager_fn = lambda: plain_eager(pred, x)  # noqa: E731
    with_pp = bool(options.get('with_postprocess'))
    # the caller's flags are TF32 on: the artifact runs under its own and
    # gives them back
    before = current_flags()
    set_flags((True, 'high'))
    try:
        got = call(*inputs)
        if current_flags() != (True, 'high'):
            fail(f'export {label}: the call left the flags {current_flags()}')
    finally:
        set_flags(before)
    out['vs_eager'] = outputs_agree(label, got, want, with_pp)
    if meta['dtype'] == 'float32' and meta['flags'] != [False, 'highest']:
        fail(f'export {label}: an f32 artifact records {meta["flags"]}')
    if meta['dtype'] == 'float32' and not with_pp:
        # the same program under TF32: how far the recorded flags keep it
        set_flags((True, 'high'))
        try:
            with torch.inference_mode():
                tf32 = call.module(*inputs)
        finally:
            set_flags(before)
        out['tf32_module_vs_eager_max_abs_err'] = max(
            (a - b).abs().max().item() for a, b in zip(tf32, want))
    launches = artifact_launches(call, *inputs)
    want_nms = 1 if with_pp else 0
    if launches['nms_keep_batched'] != want_nms or any(
            launches[fn.__name__] for fn in bn_kernel.KERNELS):
        fail(f'export {label}: one call launched {launches}, expected NMS '
             f'{want_nms} and no BN')
    out['launches_per_call'] = launches
    log(f'  {label} ({config}, b{batch}, {meta["dtype"]}, flags '
        f'{meta["flags"]}): export {info["export_s"]:.2f} s, load '
        f'{info["load_s"]:.2f} s, {info["file_bytes"]} bytes, {len(specs)} '
        f'input(s); vs eager max abs err {out["vs_eager"]["max_abs_err"]:.3g}'
        f' (bit-equal {out["vs_eager"]["bit_equal"]}); NMS launches a call '
        f'{launches["nms_keep_batched"]}'
        + (f'; the program under TF32 off the eager path by '
           f'{out["tf32_module_vs_eager_max_abs_err"]:.3g}'
           if 'tf32_module_vs_eager_max_abs_err' in out else ''))
    return ExportPoint(out, path, call, inputs, eager_fn)


def time_export_point(label: str, point: ExportPoint, batch: int) -> None:
    """The artifact's ms against the eager call's in turns (eager,
    artifact, artifact, eager), into ``point.out['turns']``."""
    turns = in_turns({'eager': point.eager,
                      'artifact': lambda: point.call(*point.inputs)},
                     iters=EXPORT_TURN_ITERS[batch])
    point.out['turns'] = {name: {'ms': t['ms'],
                                 'img_per_s': batch * 1e3 / t['ms'],
                                 'all_ms': t['all_ms']}
                          for name, t in turns.items()}
    log(f'  {label} ms in turns: eager {point.out["turns"]["eager"]["ms"]:.3f}'
        f', artifact {point.out["turns"]["artifact"]["ms"]:.3f}')


def artifact_call_split(point: ExportPoint, calls: int = 3) -> dict:
    """Where a loaded artifact's call spends the time the eager call does
    not: host ms in turns of the eager call, the artifact's call (numeric
    flags, inference mode, the module's input-checking pre-hooks, its
    pytree flattening and graph) and its module's ``forward`` alone under
    the same flags (no pre-hooks); then device-busy ms, launches, operator
    calls and the operators by self CPU time of ``calls`` calls of the
    eager call and of the artifact's (profiler)."""
    call, inputs = point.call, point.inputs

    def forward_only():
        with call.policy.scope(), torch.inference_mode():
            return call.module.forward(*inputs)

    sides = {'eager': point.eager, 'artifact': lambda: call(*inputs),
             'artifact_forward_only': forward_only}
    turns = in_turns(sides, iters=5)
    out = {name: {'host_ms': turns[name]['ms']} for name in sides}
    for name in ('eager', 'artifact'):
        def run(fn=sides[name]):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        prof = profile_window(run)
        cpu = [e for e in averages(prof)
               if e.device_type == torch.autograd.DeviceType.CPU]
        top = sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:8]
        out[name].update({
            'device_busy_ms': busy_us(prof) / calls / 1e3,
            'launches': busy_launches(prof) / calls,
            'cpu_ops': sum(e.count for e in cpu) / calls,
            # ProfilerStep*'s self time: the host's time outside any
            # operator (Python, hooks, pytree handling)
            'top_self_cpu_us': {e.key: e.self_cpu_time_total / calls
                                for e in top}})
    log('  the standalone b32 artifact\'s call split against eager (per '
        'call): ' + json.dumps(out))
    return out


def infer_exported_start(path: str, images: torch.Tensor, work: str):
    """``python -m single_shot_detection_tpu_torch.tools.infer_exported ART
    IMG... --min-score 0`` started in a fresh process on the card, on
    ``images`` (uint8 at the artifact's size) written as PNG files; it
    runs while the flagship is exported.  ``(process, stdout file, files,
    start time)``."""
    from PIL import Image
    folder = os.path.join(work, 'infer_images')
    os.makedirs(folder)
    files = []
    for i, img in enumerate(images.cpu().numpy()):
        files.append(os.path.join(folder, f'{i:02d}.png'))
        Image.fromarray(img).save(files[-1])
    streams = [open(os.path.join(work, f'infer_exported.{name}'), 'w+')
               for name in ('out', 'err')]
    proc = subprocess.Popen(
        [sys.executable, '-m', 'single_shot_detection_tpu_torch.tools.'
         'infer_exported', path, *files, '--min-score', '0'], cwd=REPO,
        stdout=streams[0], stderr=streams[1], text=True,
        env={**os.environ, 'PYTHONPATH': str(REPO)})
    return proc, streams, files, time.perf_counter()


def infer_exported_finish(started, want, batch: int, h: int, w: int) -> dict:
    """The tool's exit 0 and the JAX tool's lines (a header, a count line
    per image, its rows, a timing line); each image's rows equal to the
    valid detections of the artifact's own call on the same images, to the
    printed rounding (boxes 2 decimals, scores 3); some detections in all."""
    proc, streams, files, t = started
    try:
        code = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t
    for stream in streams:
        stream.seek(0)
    text, errors = (stream.read() for stream in streams)
    for stream in streams:
        stream.close()
    lines = text.strip().splitlines()
    if (code != 0 or not lines
            or lines[0] != f'>> artifact expects [{batch}, {h}, {w}, 3] raw RGB'
            or not lines[-1].endswith(f'for 1 call of batch {batch}')):
        fail(f'infer_exported exit {code}: {text[-3000:]}{errors[-3000:]}')
    dets, valid = (t.cpu().numpy() for t in want)
    rows = iter(lines[1:-1])
    box_err = score_err = 0.0
    total = 0
    for i, name in enumerate(files):
        head = next(rows, '')
        want_rows = dets[i][valid[i]]
        if head != f'{name}: {len(want_rows)} detections':
            fail(f'infer_exported printed "{head}", the artifact has '
                 f'{len(want_rows)} detections for {name}')
        for x1, y1, x2, y2, cls, score in want_rows:
            row = next(rows, '')
            box, rest = row.strip()[1:].split(']')
            got_score, got_cls = (f.split('=')[1] for f in rest.split())
            if int(got_cls) != int(cls):
                fail(f'infer_exported printed "{row}" for class {int(cls)}')
            box_err = max(box_err, float(np.abs(
                np.array(box.split(), np.float64)
                - np.array([x1, y1, x2, y2], np.float64)).max()))
            score_err = max(score_err, abs(float(got_score) - float(score)))
        total += len(want_rows)
    if next(rows, None) is not None:
        fail('infer_exported printed more lines than the artifact has rows')
    if total == 0:
        fail('infer_exported: the artifact found no detection to compare')
    # %.2f and %.3f of float32 values: half a printed step, and the float's
    # own rounding
    if not (box_err <= 0.005 + 1e-6 and score_err <= 0.0005 + 1e-6):
        fail(f'infer_exported rows off the artifact\'s by {box_err} (boxes), '
             f'{score_err} (scores)')
    return {'seconds': seconds, 'timing_line': lines[-1], 'images': len(files),
            'detections': total, 'box_max_abs_err_rounded': box_err,
            'score_max_abs_err_rounded': score_err, 'lines': len(lines)}


def batcher_round_trip(call, batch: int, h: int, w: int, rng) -> dict:
    """``tools/serve.py::DynamicBatcher`` over the b32 artifact, fed
    ``BATCHER_IMAGES`` images from ``BATCHER_THREADS`` threads: every
    answer against the artifact's own call on the image (in its first
    slot), the mean batch fill and images/s."""
    from single_shot_detection_tpu_torch.tools.serve import DynamicBatcher
    images = (rng.rand(BATCHER_IMAGES, h, w, 3) * 255).astype(np.float32)
    batcher = DynamicBatcher(call, batch, (h, w), max_delay_ms=5.0)
    answers = [None] * BATCHER_IMAGES
    try:
        batcher.warmup()

        def client(k):
            for i in range(k, BATCHER_IMAGES, BATCHER_THREADS):
                answers[i] = batcher.submit(images[i])

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(BATCHER_THREADS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        seconds = time.perf_counter() - t
        if any(th.is_alive() for th in threads):
            fail('DynamicBatcher: a client did not finish in 120 s')
        stats = batcher.stats()
    finally:
        batcher.stop()
    err, bit_equal = 0.0, 0
    for i, (dets, valid) in enumerate(answers):
        slot = np.zeros((batch, h, w, 3), np.float32)
        slot[0] = images[i]
        want_d, want_v = (t[0].cpu().numpy() for t in call(slot))
        if not np.array_equal(valid, want_v):
            fail(f'DynamicBatcher: image {i}\'s valid differs from the '
                 'artifact\'s own call')
        err = max(err, float(np.abs(dets[valid] - want_d[want_v]).max()))
        bit_equal += np.array_equal(dets, want_d)
    if not err <= EXPORT_TOL:
        fail(f'DynamicBatcher: answers differ from the artifact by {err}')
    return {'images': BATCHER_IMAGES, 'threads': BATCHER_THREADS,
            **stats, 'seconds': seconds,
            'img_per_s': BATCHER_IMAGES / seconds,
            'max_abs_err_vs_artifact': err, 'bit_equal_answers': bit_equal}


def http_round_trip(path: str, call, batch: int, h: int, w: int,
                    rng) -> dict:
    """``tools/serve.py::make_server`` on the b32 artifact at a local port:
    ``/healthz``, 4 concurrent ``/detect`` PNG uploads of other sizes (each
    answer against the artifact's own call on the decoded image), ``/stats``
    and a 400 on a bad upload."""
    import http.client
    import io
    from PIL import Image
    from single_shot_detection_tpu_torch.tools.serve import make_server
    server, batcher = make_server(path, port=0, max_delay_ms=50.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def request(method, url, body=None):
        conn = http.client.HTTPConnection(*server.server_address, timeout=120)
        try:
            conn.request(method, url, body=body)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read().decode())
        finally:
            conn.close()

    sizes = [(500, 375), (640, 480), (300, 300), (1280, 720)]
    bodies = []
    for src_w, src_h in sizes:
        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 256, (src_h, src_w, 3),
                                    dtype=np.uint8)).save(buf, format='PNG')
        bodies.append(buf.getvalue())
    results = [None] * len(sizes)
    try:
        health = request('GET', '/healthz')
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, request('POST', '/detect?min_score=0.0', bodies[i])))
            for i in range(len(sizes))]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        seconds = time.perf_counter() - t
        stats = request('GET', '/stats')
        bad = request('POST', '/detect', b'not an image')
    finally:
        server.shutdown()
        batcher.stop()
        server.server_close()
        thread.join(timeout=10)
    if health != (200, {'status': 'ok', 'batch': batch, 'input_hw': [h, w]}):
        fail(f'/healthz answered {health}')
    if bad[0] != 400:
        fail(f'a bad upload got {bad}')
    err = 0.0
    for (src_w, src_h), body, res in zip(sizes, bodies, results):
        if res is None or res[0] != 200 or res[1]['size'] != [src_w, src_h]:
            fail(f'/detect of a {src_w}x{src_h} PNG answered {res}')
        with Image.open(io.BytesIO(body)) as im:
            img = np.asarray(im.convert('RGB').resize((w, h), Image.BILINEAR),
                             np.float32)
        slot = np.zeros((batch, h, w, 3), np.float32)
        slot[0] = img
        dets, valid = (t[0].cpu().numpy() for t in call(slot))
        want = dets[valid].astype(np.float64)
        want[:, (0, 2)] *= src_w / w
        want[:, (1, 3)] *= src_h / h
        got = np.asarray(res[1]['detections'], np.float64).reshape(-1, 6)
        if len(got) != len(want):
            fail(f'/detect of a {src_w}x{src_h} PNG: {len(got)} detections, '
                 f'the artifact {len(want)}')
        # the server rounds boxes to 2 decimals and scores to 4
        err = max(err, float(np.abs(got - want).max()))
    if not err <= 0.006:
        fail(f'/detect answers differ from the artifact by {err}')
    return {'requests': len(sizes), 'seconds': seconds, 'stats': stats[1],
            'max_abs_err_vs_artifact_rounded': err}


def run_test_phase(work: str) -> dict:
    """``--phases test --video DIR`` on the committed JAX checkpoint (in
    process, on the card, headless): each image of DIR through
    ``Experiment.predict`` and ``draw_boxes``, saved as a PNG in the
    temporary directory, with the NMS count read around it."""
    from PIL import Image
    folder = os.path.join(work, 'video')
    os.makedirs(folder)
    rng = np.random.RandomState(SEED + 19)
    for i, (h, w) in enumerate([(128, 128), (300, 400), (720, 1280)]):
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(folder, f'{i}.png'))
    before = listing('experiments')
    tmp = tempfile.tempdir
    tempfile.tempdir = os.path.join(work, 'tmp')
    os.makedirs(tempfile.tempdir)
    env = {k: os.environ.pop(k) for k in ('DISPLAY', 'WAYLAND_DISPLAY')
           if k in os.environ}
    try:
        zero_launches()
        t = time.perf_counter()
        cli.main(['--config', f'{JAX_RUN}/config.py', '--checkpoint', JAX_RUN,
                  '--phases', 'test', '--video', folder])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = read_launches()
        frames = sorted(os.listdir(os.path.join(tempfile.tempdir,
                                                'ssd_torch_frames')))
    finally:
        tempfile.tempdir = tmp
        os.environ.update(env)
    if listing('experiments') != before:
        fail('experiments/ changed')
    if frames != ['00000.png', '00001.png', '00002.png'] or launches[
            'nms_keep_batched'] != 3:
        fail(f'the test phase wrote {frames} with launches {launches}')
    return {'frames': len(frames), 'seconds': seconds, 'launches': launches}


def cli_export_jax_checkpoint(work: str):
    """``--phases eval export`` on the committed JAX checkpoint with a
    standalone ``export`` block at its eval batch (twice the config's
    batch): the artifact's detections on the first eval batch against the
    eager ones.  ``(result, artifact path, the batch's uint8 images, the
    artifact's outputs on them)``."""
    from single_shot_detection_tpu_torch.export import load_exported
    config = Path(work) / 'jax_run_export.py'
    out = os.path.join(work, 'jax_run', 'model')
    config.write_text((REPO / JAX_RUN / 'config.py').read_text()
                      + '\n# chip_smoke.py phase 18: a standalone artifact\n'
                      + f"export = {{'standalone': True, 'path': {out!r}, "
                        "'batch_size': 2 * batch_size}\n")
    before = listing('experiments')
    zero_launches()
    t = time.perf_counter()
    exp, metrics = cli.main(['--config', str(config), '--checkpoint', JAX_RUN,
                             '--phases', 'eval', 'export'])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = read_launches()
    if listing('experiments') != before:
        fail('experiments/ changed')
    if launches['nms_keep_batched'] != len(exp.loaders['eval']):
        fail(f'the CLI\'s eval and export launched {launches}')
    call = load_exported(out + '.pt2')
    images, _, _ = first_batch(exp.loaders['eval'], exp.device)
    got = call(images.float())
    want = exp.predictor().predict_batch(images)
    agree = outputs_agree('cli_jax_checkpoint', got, want, True)
    log(f'  the CLI\'s eval and export phases on {JAX_RUN} in {seconds:.2f} '
        f's (mAP {metrics["mAP"]:.5f}), the artifact on its first eval batch '
        f'({int(got[1].sum())} detections) against the eager path: max abs '
        f'err {agree["max_abs_err"]:.3g}, bit-equal {agree["bit_equal"]}')
    return ({'seconds': seconds, 'eval_launches': launches,
             'mAP': metrics['mAP'], 'detections': int(got[1].sum()),
             'file_bytes': os.path.getsize(out + '.pt2'), **agree},
            out + '.pt2', images, got)


def run_export(smi: str) -> dict:
    """Phase 18: the CLI's export phase on the JAX checkpoint, whose
    artifact ``infer_exported`` runs in a fresh process meanwhile;
    ``EXPORT_POINTS`` exported, loaded and held against the eager path,
    then timed against it in turns (the fresh process done), with the
    standalone b32 call's split; the ``DynamicBatcher``, the HTTP server
    and the test phase on that artifact."""
    rng = np.random.RandomState(SEED + 18)
    work = tempfile.mkdtemp(prefix='chip_smoke_export_')
    out, points, started = {}, {}, None
    try:
        log(f'[18] {smi}: export (torch.export, the NMS op in the program), '
            'each artifact against the eager path')
        out['cli_jax_checkpoint'], jax_path, jax_images, jax_got = (
            cli_export_jax_checkpoint(work))
        started = infer_exported_start(jax_path, jax_images, work)
        experiments = {}
        for label, key, batch, options in EXPORT_POINTS:
            if key not in experiments:
                experiments[key] = export_experiment(key, batch)
            points[label] = export_point(
                label, EXPORT_EXPERIMENTS[key][0], experiments[key], batch,
                options, work, rng)
        out['infer_exported'] = infer_exported_finish(
            started, jax_got, *jax_images.shape[:3])
        started = None
        log('  infer_exported on the eval batch\'s PNGs in a fresh process '
            '(while the flagship was exported): '
            + json.dumps(out['infer_exported']))
        for label, _, batch, _ in EXPORT_POINTS:
            time_export_point(label, points[label], batch)
            out[label] = points[label].out
        b32 = points['standalone_b32']
        out['standalone_b32']['call_split'] = artifact_call_split(b32)
        b32_shape = out['standalone_b32']['input_shape'][:3]
        out['batcher'] = batcher_round_trip(b32.call, *b32_shape, rng)
        log('  DynamicBatcher: ' + json.dumps(out['batcher']))
        out['http'] = http_round_trip(b32.path, b32.call, *b32_shape, rng)
        out['test_phase'] = run_test_phase(work)
        log('  HTTP: ' + json.dumps(out['http']) + '; the test phase: '
            + json.dumps(out['test_phase']))
    finally:
        if started is not None and started[0].poll() is None:
            started[0].kill()
            started[0].wait()
        shutil.rmtree(work, ignore_errors=True)
    del points, experiments
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 19

PRUNING = 'samples/ssd_mb2_coco_pruning.py'
# synthetic data at the config's 300 px input (no resize in the loader), 81
# classes; 3 b32 steps an epoch, 2 b32 eval batches
PRUNING_DATA = {
    'train': {'name': 'Synthetic', 'num_images': 96, 'image_size': 300,
              'num_classes': 81, 'max_boxes': 6, 'seed': 1},
    'eval': {'name': 'Synthetic', 'num_images': 64, 'image_size': 300,
             'num_classes': 81, 'max_boxes': 6, 'seed': 2},
}
PRUNING_EPOCHS, PRUNING_STEPS = 2, 3
# channels picked a prune (the config ships 1 a prune over 500 epochs):
# two prunes take a real share of the 17,000-odd out-channels of the
# backbone and the extras
PRUNING_NUM = 400
# the JAX checkpoint's prune (test_torch_port_materialize.py's), and how
# far the narrow model's mAP may be from the masked one's
PRUNING_JAX_NUM = 8
PRUNING_MAP_TOL = 1e-3
# the narrow model against the masked one on the card: heads and stage
# outputs within this share of each output's scale (other convolution
# algorithms on other widths; TF32 off)
PRUNING_TOL = 1e-4
PRUNING_TURN_ITERS = {32: 5, 128: 2}


def pruning_experiment() -> Experiment:
    """``PRUNING`` at full width on the card: seeded weights (its
    ``detector.weight`` placeholder and ``base.pretrained`` off),
    ``PRUNING_DATA``, ``fused_bn``, the shipped pruner with ``num`` at
    ``PRUNING_NUM``."""
    from single_shot_detection_tpu_torch.utils.config import load_config
    cfg = load_config(PRUNING, phases=('train', 'eval'))
    model = copy.deepcopy(dict(cfg.model))
    model['detector'] = {**model['detector'], 'weight': None}
    model['base'] = {**model['base'], 'pretrained': False}
    pruner = {**dict(cfg.train)['pruner'], 'num': PRUNING_NUM}
    return Experiment(cfg, phases=('train', 'eval'), device='cuda', seed=SEED,
                      overrides={'model': model, 'dataset': PRUNING_DATA,
                                 'train': {'epochs': PRUNING_EPOCHS,
                                           'num_batches_per_epoch': PRUNING_STEPS,
                                           'eval_every': PRUNING_EPOCHS,
                                           'save_every': 10 * PRUNING_EPOCHS,
                                           'fused_bn': True,
                                           'pruner': pruner}})


def check_mask_holds(exp: Experiment) -> dict:
    """Every dead entry (kernel slices, BN weights and biases, conv biases)
    exactly 0 after the steps, the momentum buffers finite; the dead share
    of the out-channels the pruner takes."""
    named = dict(exp.model.named_parameters())
    entries = [(named[name], m) for name, m in exp.trainer.state.mask.items()]
    nonzero = sum(int((p.detach()[m.expand_as(p) == 0] != 0).sum())
                  for p, m in entries)
    if not entries or nonzero:
        fail(f'pruning: {nonzero} dead entries not 0 over {len(entries)} '
             'masked tensors after the masked steps')
    opt = exp.trainer.state.optimizer
    if not all(torch.isfinite(opt.state[p]['momentum_buffer']).all()
               for p in exp.model.parameters()):
        fail('pruning: a momentum buffer is not finite')
    params = pruning.param_tree(exp.model)
    total = sum(params[k].shape[0]
                for k in exp.pruner.criterion._included(params))
    dead = {'.'.join(k[:-1]): f'{len(d)}/{params[k].shape[0]}'
            for k, d in exp.pruner.dead.items() if d}
    channels = sum(len(d) for d in exp.pruner.dead.values())
    return {'masked_tensors': len(entries), 'dead_channels': channels,
            'pruned_convs': dead, 'included_channels': total,
            'dead_share': channels / total}


def sums_tol(magnitude: torch.Tensor, n: int) -> torch.Tensor:
    """Tolerance of an f32 per-channel sum (or mean) of ``n`` terms against
    its float64 value: sqrt(n) rounding units of the same sum over the
    terms' magnitudes (at least 1).  An f32 sum is exact only to that
    scale: where a trained step's terms cancel (a pruned model's
    near-constant channels), an f32 reference is as far off as the kernel
    (the plain version was 2.06 from the float64 ``d_gamma`` of one BN
    where K3 was 0.12)."""
    return math.sqrt(n) * 2.0 ** -24 * torch.clamp(magnitude, min=1.0)


def within(name: str, got: torch.Tensor, exact: torch.Tensor,
           tol: torch.Tensor) -> float:
    """Max abs error of ``got`` against float64 ``exact``; fails where a
    channel's error passes its ``tol`` (NaN fails too)."""
    err = (got.double() - exact).abs()
    if not bool((err <= tol).all()):
        worst = int(torch.argmax(err / tol))
        fail(f'{name} differs from its float64 value: {err[worst].item()} > '
             f'{tol[worst].item()} (channel {worst})')
    return err.max().item()


def masked_step_bn_check(exp: Experiment, batch) -> dict:
    """One more masked ``fused_bn`` step with each BatchNorm's input, its
    output's gradient, weight and bias captured; on each, K1's and K3's
    sums against float64 within ``sums_tol`` (``rstd`` against the rsqrt
    of the float64 variance, within the variance's tolerance carried
    through the rsqrt), K2 and K4 against their plain versions at
    ``BN_TOL`` (each kernel given the plain outputs of the one before, as
    phase 3 does), and on the dead channels K2's y and K4's dx exactly 0.
    A planted fault shows the sums' check can fail: each of K1's mean and
    K3's two sums with image 0's terms taken out (one block of work) must
    be flagged on at least half the channels where those terms add to
    anything (``planted_fault``: flagged, such channels)."""
    captured, hooks = [], []
    mask = exp.trainer.state.mask

    def capture(name):
        def hook(module, inputs, output):
            rec = {'name': name, 'x': inputs[0].detach(),
                   'scale': module.weight.detach().clone(),
                   'bias': module.bias.detach().clone()}
            output.register_hook(lambda g: rec.__setitem__('dz', g.detach()))
            captured.append(rec)
        return hook

    for name, m in exp.model.named_modules():
        if isinstance(m, BatchNorm):
            hooks.append(m.register_forward_hook(capture(name)))
    try:
        exp.trainer.train_step(*batch)
    finally:
        for h in hooks:
            h.remove()
    worst = {name: 0.0 for name in BN_KERNELS}
    planted = {q: [0, 0] for q in ('bn_stats mean', 'bn_grad_sums d_beta',
                                   'bn_grad_sums d_gamma')}

    def plant(quantity, got, exact, tol, dropped):
        flagged = (got.double() - dropped - exact).abs() > tol
        live = dropped != 0
        planted[quantity][0] += int((flagged & live).sum())
        planted[quantity][1] += int(live.sum())

    dead_planes, live_dz_planes, shapes = 0, 0, set()
    for rec in captured:
        x, dz, scale, bias = rec['x'], rec['dz'], rec['scale'], rec['bias']
        keep = mask.get(f'{rec["name"]}.weight')
        dead = (keep == 0) if keep is not None else torch.zeros(
            x.shape[1], dtype=torch.bool, device=x.device)
        shapes.add(tuple(x.shape))
        dims, n = (0, 2, 3), x.numel() // x.shape[1]
        x64 = x.double()
        mean64 = x64.sum(dims) / n
        ex2 = (x64 * x64).sum(dims) / n
        var64 = torch.clamp(ex2 - mean64 * mean64, min=0.0)
        rstd64 = torch.rsqrt(var64 + BN_EPS)
        mean_tol = sums_tol(x64.abs().sum(dims) / n, n)
        var_tol = sums_tol(ex2, n)
        # |d rsqrt(v + eps) / dv| at the variance's lowest admitted value
        rstd_tol = (0.5 * (torch.clamp(var64 - var_tol, min=0.0) + BN_EPS)
                    ** -1.5 * var_tol + BN_TOL['elementwise'] * rstd64)
        k_mean, k_var, k_rstd = bn_kernel.bn_stats(x, BN_EPS)
        worst['bn_stats'] = max(
            worst['bn_stats'],
            within('bn_stats mean', k_mean, mean64, mean_tol),
            within('bn_stats var', k_var, var64, var_tol),
            within('bn_stats rstd', k_rstd, rstd64, rstd_tol))
        plant('bn_stats mean', k_mean, mean64, mean_tol, x64[0].sum((1, 2)) / n)
        mean, _, rstd = bn_kernel.bn_stats_plain(x, BN_EPS)
        y = bn_kernel.bn_apply(x, mean, rstd, scale, bias, x.dtype)
        worst['bn_apply'] = max(worst['bn_apply'], bn_err(
            y, bn_kernel.bn_apply_plain(x, mean, rstd, scale, bias, x.dtype),
            'elementwise'))
        got = bn_kernel.bn_grad_sums(dz, x, mean, rstd, scale)
        want = bn_kernel.bn_grad_sums_plain(dz, x, mean, rstd, scale)
        dz64 = dz.double()
        term = dz64 * ((x64 - mean.double()[None, :, None, None])
                       * rstd.double()[None, :, None, None])
        d_gamma, d_beta = term.sum(dims), dz64.sum(dims)
        gamma_tol = sums_tol(term.abs().sum(dims), n)
        beta_tol = sums_tol(dz64.abs().sum(dims), n)
        worst['bn_grad_sums'] = max(
            worst['bn_grad_sums'],
            within('bn_grad_sums d_gamma', got[0], d_gamma, gamma_tol),
            within('bn_grad_sums d_beta', got[1], d_beta, beta_tol),
            bn_err(got[2][0], want[2][0], 'elementwise'),
            within('bn_grad_sums d_beta / n', got[2][1], d_beta / n,
                   sums_tol(dz64.abs().sum(dims) / n, n)),
            within('bn_grad_sums d_gamma / n', got[2][2], d_gamma / n,
                   sums_tol(term.abs().sum(dims) / n, n)))
        plant('bn_grad_sums d_beta', got[1], d_beta, beta_tol,
              dz64[0].sum((1, 2)))
        plant('bn_grad_sums d_gamma', got[0], d_gamma, gamma_tol,
              term[0].sum((1, 2)))
        del x64, dz64, term
        dx = bn_kernel.bn_dx(dz, x, mean, rstd, want[2])
        worst['bn_dx'] = max(worst['bn_dx'], bn_err(
            dx, bn_kernel.bn_dx_plain(dz, x, mean, rstd, want[2]),
            'elementwise'))
        if dead.any():
            if torch.any(y[:, dead] != 0) or torch.any(dx[:, dead] != 0):
                fail(f'pruning: {rec["name"]}: a dead channel\'s y or dx is '
                     'not exactly 0')
            dead_planes += int(dead.sum()) * x.shape[0]
            live_dz_planes += int((dz[:, dead] != 0).flatten(2).any(2).sum())
    for quantity, (flagged, live) in planted.items():
        if flagged < 0.5 * live or not live:
            fail(f'pruning: {quantity} with image 0 dropped was flagged on '
                 f'{flagged} of {live} channels')
    torch.cuda.synchronize()
    return {'bn_layers': len(captured), 'distinct_shapes': len(shapes),
            'dead_planes': dead_planes,
            'dead_planes_with_nonzero_dz': live_dz_planes,
            'max_abs_err': worst, 'planted_fault': planted}


def stage_keep(exp: Experiment):
    """Per MobileNetV2 stage, the channels the narrow model keeps."""
    out = []
    base = exp.model.features.base
    for i, width in enumerate(base.stage_channels):
        path = ('features', 'base', f'stage{i}',
                'conv' if i in (0, 18) else 'project_conv', 'kernel')
        gone = exp.pruner.dead.get(path, set())
        out.append([c for c in range(width) if c not in gone])
    return out


def narrow_vs_masked(exp: Experiment, narrow: torch.nn.Module,
                     images: torch.Tensor) -> dict:
    """Heads and every backbone stage of the narrow model against the
    masked one on the same preprocessed batch, within ``PRUNING_TOL`` of
    each output's scale (the stages on their kept channels; the masked
    stages' pruned channels exactly 0)."""
    x = exp.eval_pipeline.preprocess(images)
    worst = {'heads': 0.0, 'stages': 0.0}
    with torch.inference_mode(), exp.policy.scope():
        masked = exp.model.eval()
        heads = [masked(x), narrow(x)]
        stages = [masked.features.base(x)[0], narrow.features.base(x)[0]]
    for a, b in zip(*heads):
        worst['heads'] = max(worst['heads'], (a - b).abs().max().item()
                             / max(1.0, a.abs().max().item()))
    for i, keep in enumerate(stage_keep(exp)):
        m, n = stages[0][i], stages[1][i]
        gone = [c for c in range(m.shape[1]) if c not in set(keep)]
        if gone and torch.any(m[:, gone] != 0):
            fail(f'pruning: masked stage {i}: a pruned channel is not 0')
        worst['stages'] = max(worst['stages'], (m[:, keep] - n).abs().max().item()
                              / max(1.0, m.abs().max().item()))
    if not max(worst.values()) <= PRUNING_TOL:
        fail(f'pruning: the narrow model differs from the masked one: {worst}')
    return worst


def pruned_jax_checkpoint() -> dict:
    """The committed JAX checkpoint pruned once (``MinL1Norm`` over
    ``features`` and ``extra``, ``PRUNING_JAX_NUM`` picks) and evaluated on
    the card masked and narrow: the two mAPs within ``PRUNING_MAP_TOL``."""
    exp = Experiment(f'{JAX_RUN}/config.py', phases=('eval',), device='cuda',
                     resume_from=f'{JAX_RUN}/ckpt-1800.msgpack',
                     load_weights=True, overrides={'train': {'pruner': {
                         'include_paths': ['features', 'extra'],
                         'num': PRUNING_JAX_NUM}}})
    unpruned = exp.evaluate()
    exp.pruner.prune(exp.trainer.state)
    zero_launches()
    masked = exp.evaluate()
    bundle, _ = exp.materialize_pruned()
    exp.trainer.state.model = bundle.module
    narrow = exp.evaluate()
    torch.cuda.synchronize()
    launches = read_launches()
    if not abs(masked['mAP'] - narrow['mAP']) <= PRUNING_MAP_TOL:
        fail(f'pruning: the JAX checkpoint\'s narrow mAP {narrow["mAP"]} is '
             f'{abs(masked["mAP"] - narrow["mAP"])} from the masked '
             f'{masked["mAP"]}')
    if launches['nms_keep_batched'] != 2 * len(exp.loaders['eval']):
        fail(f'pruning: the JAX checkpoint\'s evaluations launched {launches}')
    return {'unpruned_mAP': unpruned['mAP'], 'masked_mAP': masked['mAP'],
            'narrow_mAP': narrow['mAP'], 'masked_loss': masked['loss'],
            'narrow_loss': narrow['loss'],
            'dead_channels': sum(len(d) for d in exp.pruner.dead.values()),
            'launches': launches}


def run_pruning(smi: str) -> dict:
    """Phase 19: ``PRUNING`` at full width through ``Experiment`` with the
    shipped pruner (``num`` raised) and ``fused_bn``: two epochs of masked
    steps and an evaluation, the kernels' counts read around them; the mask
    held exactly; K1-K4 on a masked step's BN inputs (``masked_step_bn_check``);
    the narrow model (``materialize_pruned``) against the masked
    one, both ``Predictor``s in turns at b32 and b128, its ``.pt2``
    against the eager narrow call; the JAX checkpoint pruned and evaluated
    masked and narrow."""
    from single_shot_detection_tpu_torch import export as pt_export
    rng = np.random.RandomState(SEED + 19)
    out = {}
    work = tempfile.mkdtemp(prefix='chip_smoke_pruning_')
    try:
        t = time.perf_counter()
        exp = pruning_experiment()
        perturb_bn(exp.model, torch.Generator().manual_seed(SEED + 19))
        n_bn = sum(isinstance(m, BatchNorm) for m in exp.model.modules())
        out['build_s'] = time.perf_counter() - t
        rows, launches, seconds = run_experiment(exp)
        steps = PRUNING_EPOCHS * PRUNING_STEPS
        for fn in bn_kernel.KERNELS:
            if launches[fn.__name__] != n_bn * steps:
                fail(f'pruning: {fn.__name__} launched '
                     f'{launches[fn.__name__]} times, not {n_bn} x {steps}')
        if launches['nms_keep_batched'] != len(exp.loaders['eval']):
            fail(f'pruning: the evaluation launched {launches}')
        if not all(math.isfinite(r['train_loss']) for r in rows):
            fail(f'pruning: non-finite losses {rows}')
        out.update({'rows': rows, 'launches': launches, 'seconds': seconds,
                    **check_mask_holds(exp)})
        if not out['dead_channels']:
            # every space frozen: the channel analysis read no conv or BN
            fail('pruning: the pruner found no channel to prune')
        log(f'[19] {smi}: {PRUNING} at full width (built in '
            f'{out["build_s"]:.2f} s, channel spaces included): '
            f'{PRUNING_EPOCHS} epochs of {PRUNING_STEPS} masked b32 steps '
            f'with fused_bn, a prune of {PRUNING_NUM} picks before each, and '
            f'an evaluation in {seconds:.2f} s; {out["dead_channels"]} dead '
            f'channels ({100 * out["dead_share"]:.1f} % of the '
            f'{out["included_channels"]} out-channels of the convs the pruner '
            f'takes), {out["masked_tensors"]} masked tensors exactly 0 after '
            'the steps, momentum finite; launches ' + json.dumps(launches))
        log('  dead/width by conv: ' + json.dumps(out['pruned_convs']))
        for row in rows:
            log('  ' + json.dumps(row))
        batch = next(iter(exp._device_batches(itertools.islice(
            exp.loaders['train'], 1))))[1]
        out['bn_check'] = masked_step_bn_check(exp, batch)
        log(f'  K1 and K3 against float64 sums, K2 and K4 against their '
            f'plain versions, on a masked step\'s '
            f'{out["bn_check"]["bn_layers"]} BN inputs '
            f'({out["bn_check"]["distinct_shapes"]} shapes, '
            f'{out["bn_check"]["dead_planes"]} dead planes, '
            f'{out["bn_check"]["dead_planes_with_nonzero_dz"]} of them with a '
            'non-zero dz: y and dx exactly 0): '
            + json.dumps(out['bn_check']['max_abs_err'])
            + '; image 0 dropped from a sum flagged on (channels, of) '
            + json.dumps(out['bn_check']['planted_fault']))
        del batch

        t = time.perf_counter()
        bundle, _ = exp.materialize_pruned()
        out['materialize_s'] = time.perf_counter() - t
        narrow = bundle.module
        out['parameters'] = {
            'masked': sum(p.numel() for p in exp.model.parameters()),
            'narrow': sum(p.numel() for p in narrow.parameters())}
        w, h = exp.input_size
        images = {b: torch.from_numpy(rng.randint(0, 256, (b, h, w, 3),
                                                  dtype=np.uint8)).cuda()
                  for b in (32, 128)}
        out['narrow_vs_masked'] = narrow_vs_masked(exp, narrow, images[32])
        masked_pred = exp.predictor()
        narrow_pred = Predictor(bundle, exp.serving_postprocessor,
                                exp.eval_pipeline.preprocess, exp.device,
                                exp.policy)
        _, vm = masked_pred.predict_batch(images[32])
        _, vn = narrow_pred.predict_batch(images[32])
        if not torch.equal(vm, vn):
            fail(f'pruning: the narrow Predictor\'s valid differs in '
                 f'{(vm != vn).sum().item()} slots')
        log(f'  {smi}: materialize_pruned in {out["materialize_s"]:.2f} s: '
            f'{out["parameters"]["masked"]} -> '
            f'{out["parameters"]["narrow"]} parameters; narrow against '
            'masked (share of scale): ' + json.dumps(out['narrow_vs_masked'])
            + ', valid equal')
        out['turns'] = {}
        for b, x in images.items():
            turns = in_turns({'masked': lambda: masked_pred.predict_batch(x),
                              'narrow': lambda: narrow_pred.predict_batch(x)},
                             iters=PRUNING_TURN_ITERS[b])
            out['turns'][f'b{b}'] = {name: {'ms': t['ms'],
                                            'img_per_s': b * 1e3 / t['ms'],
                                            'all_ms': t['all_ms']}
                                     for name, t in turns.items()}
            log(f'  {smi}: predict_batch b{b} ms in turns: masked '
                f'{turns["masked"]["ms"]:.3f}, narrow '
                f'{turns["narrow"]["ms"]:.3f}')

        path, call, specs, info = export_timed(
            exp, os.path.join(work, 'narrow'), 32, STANDALONE)
        program = torch.export.load(path)
        program_params = sum(program.state_dict[name].numel() for name in
                             program.graph_signature.parameters)
        del program
        raw = images[32].float()
        eager = pt_export._make_inference_fn_for(
            exp, narrow, True, with_preprocess=True, bake_variables=True)
        with torch.inference_mode(), exp.policy.scope():
            want = eager(raw)
        out['export'] = {**info, 'program_parameters': program_params,
                         'vs_eager': outputs_agree('pruned narrow', call(raw),
                                                   want, True),
                         'launches_per_call': artifact_launches(call, raw)}
        if out['export']['launches_per_call']['nms_keep_batched'] != 1:
            fail(f'pruning: one call of the narrow artifact launched '
                 f'{out["export"]["launches_per_call"]}')
        log(f'  {smi}: the narrow .pt2 (standalone b32): export '
            f'{info["export_s"]:.2f} s, {info["file_bytes"]} bytes, '
            f'{program_params} parameters in the program; against the '
            'eager narrow call ' + json.dumps(out['export']['vs_eager'])
            + '; NMS launches a call 1')
        del exp, masked_pred, narrow_pred, bundle, narrow, call
        torch.cuda.empty_cache()

        out['jax_checkpoint'] = pruned_jax_checkpoint()
        log(f'  {smi}: the JAX checkpoint ({JAX_RUN}) pruned by '
            f'{PRUNING_JAX_NUM} picks: ' + json.dumps(out['jax_checkpoint']))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 20

# The options phase 20 trains the flagship with at full width (b32,
# fused_bn): every option of the rest of the train path at once
OPTIONS_TRAIN = {
    'optimizer': {'name': 'AdamW', 'lr': 1e-3, 'weight_decay': 5e-4,
                  'lr_groups': {'score_head': 2e-3}},
    'clip_grad_norm': 10.0, 'accumulation_steps': 2, 'ema': 0.999,
    'mixup': {'alpha': 1.5, 'p': 0.5}}
OPTIONS_LOSS = {
    'classification_loss': {'name': 'CrossEntropyWithSoftTargetsLoss',
                            'epsilon': 0.1},
    'localization_loss': {'name': 'GeneralizedIoULoss'}}
# (a): each optimizer's base rate, so that one update moves a parameter by
# a share of its own scale (the comparison is against the update's scale,
# and a move far below the parameter's ulp would measure the rounding of
# the parameter instead), and its other hyperparameters
OPTIMIZER_CHECKS = {
    'SGD': {'lr': 1.0, 'momentum': 0.9, 'weight_decay': 5e-4,
            'nesterov': True},
    'SGDW': {'lr': 1.0, 'momentum': 0.9, 'weight_decay': 5e-2},
    'Adam': {'lr': 0.5, 'weight_decay': 5e-4},
    'AdamW': {'lr': 0.5, 'weight_decay': 5e-2},
    'RMSprop': {'lr': 0.05, 'momentum': 0.9, 'weight_decay': 5e-4},
    'Adagrad': {'lr': 0.5, 'lr_decay': 0.1, 'weight_decay': 5e-4},
    'Adadelta': {'lr': 100.0, 'weight_decay': 5e-4},
    'Adamax': {'lr': 5.0, 'weight_decay': 5e-4},
    'NAdam': {'lr': 0.5, 'weight_decay': 5e-4},
    'RAdam': {'lr': 0.5, 'weight_decay': 5e-4}}
# (a): the warmup schedule (lr(0) = 0.2 lr, lr(1) = 0.36 lr), the
# plateau factor and the share of the gradients' global norm clipped to
OPTIMIZER_SCHEDULE = {'name': 'LinearGrowthLR', 'cold_lr': 0.2, 'steps': 6,
                      'run_each_step': True}
OPTIMIZER_LR_SCALE = 0.5
OPTIMIZER_CLIP_SHARE = 0.5
# (a): each parameter on the card within this share of its tensor's
# largest update on the CPU, plus the parameter's own ulp
OPTIMIZER_TOL = 1e-6
OPTIONS_STEPS = 8
OPTIONS_FUSED = 4
OPTIONS_TURN_ITERS = 10


def options_trainer(train: dict, seed: int = SEED, loss=None) -> Trainer:
    """The flagship at full width with ``fused_bn`` and no augmentation,
    the train options ``train`` and the loss overrides ``loss``."""
    overrides = {'augmentations': [],
                 'train': {'fused_bn': True, **train}}
    if loss:
        overrides['loss'] = loss
    return Trainer.from_config(FLAGSHIP, device='cuda', seed=seed,
                               overrides=overrides)


def optimizers_card_vs_cpu() -> dict:
    """(a) One update of each optimizer over the flagship's parameters from
    the same seeded gradients, on the card and on the CPU: the warmup
    schedule, ``lr_scale`` 0.5, an ``lr_groups`` prefix (``score_head``)
    and the global-norm clip at half the gradients' norm.  Each parameter
    within ``OPTIMIZER_TOL`` of its tensor's largest CPU update plus its
    own ulp."""
    from single_shot_detection_tpu_torch.models import builder
    from single_shot_detection_tpu_torch.train import optimizers, schedulers
    from single_shot_detection_tpu_torch.utils.config import load_config
    model = builder.from_config(load_config(FLAGSHIP), None, SEED).module
    names = [n for n, _ in model.named_parameters()]
    start = [p.detach().clone() for p in model.parameters()]
    generator = torch.Generator().manual_seed(SEED + 20)
    grads = [torch.randn(p.shape, generator=generator) for p in start]
    norm = float(torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in grads])))
    clip = OPTIMIZER_CLIP_SHARE * norm
    out = {}
    for name, hyper in OPTIMIZER_CHECKS.items():
        cfg = {'name': name, **hyper,
               'lr_groups': {'score_head': hyper['lr']}}
        schedule = schedulers.create_lr_schedule(
            dict(OPTIMIZER_SCHEDULE), hyper['lr'], 1)[0]
        after = {}
        for side, device in (('cpu', 'cpu'), ('card', 'cuda')):
            params = [torch.nn.Parameter(p.to(device, copy=True))
                      for p in start]
            for p, g in zip(params, grads):
                p.grad = g.to(device, copy=True)
            opt = optimizers.create_optimizer(
                cfg, list(zip(names, params)), clip_grad_norm=clip)
            t = time.perf_counter()
            opt.step(count=0, schedule=schedule, lr_scale=OPTIMIZER_LR_SCALE)
            torch.cuda.synchronize()
            after[side] = ([p.detach().cpu() for p in params],
                           (time.perf_counter() - t) * 1e3)
        worst, worst_name, largest = 0.0, None, 0.0
        for n, p0, cpu, on_card in zip(names, start, after['cpu'][0],
                                       after['card'][0]):
            update = (cpu - p0).abs().max().item()
            largest = max(largest, update)
            bound = (OPTIMIZER_TOL * update
                     + torch.from_numpy(np.spacing(cpu.abs().numpy())))
            gap = ((on_card - cpu).abs() / bound).max().item()
            if gap > worst:
                worst, worst_name = gap, n
        if not worst <= 1.0:
            fail(f'{name}: the card\'s update is {worst:.3g} of the '
                 f'tolerance from the CPU\'s at {worst_name}')
        out[name] = {'worst_share_of_tol': worst, 'worst_tensor': worst_name,
                     'largest_update': largest,
                     'cpu_step_ms': after['cpu'][1],
                     'card_first_step_ms': after['card'][1]}
    return out


def options_experiment() -> Experiment:
    return Experiment(FLAGSHIP, phases=('train', 'eval'), device='cuda',
                      seed=SEED, overrides={
                          'dataset': FLAGSHIP_DATA, 'loss': OPTIONS_LOSS,
                          'train': {'epochs': 1, 'eval_every': 1,
                                    'fused_bn': True, **OPTIONS_TRAIN}})


def flat_params(model: torch.nn.Module) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def combined_run(work: str) -> dict:
    """(b) ``Experiment.train()`` with every option of ``OPTIONS_TRAIN``
    and the soft-target and GIoU losses: one epoch of 8 augmented b32
    micro-steps, then the evaluation on the shadow.  Each micro-step's
    kernel counts and whether it moved the parameters are read around
    it; then a ``.pt`` save restored into a fresh trainer bit for bit."""
    exp = options_experiment()
    n_bn = sum(isinstance(m, BatchNorm) for m in exp.model.modules())
    trainer = exp.trainer
    inner = trainer.train_step
    per_step = []

    def recorded(*args, **kwargs):
        before = read_launches()
        params = flat_params(trainer.model)
        metrics = inner(*args, **kwargs)
        torch.cuda.synchronize()
        after = read_launches()
        per_step.append({
            'launches': {k: after[k] - before[k] for k in after},
            'moved': not torch.equal(params, flat_params(trainer.model)),
            'loss': metrics['loss'].item()})
        return metrics

    trainer.train_step = recorded
    rows, launches, seconds = run_experiment(exp)
    del trainer.train_step
    if len(per_step) != OPTIONS_STEPS:
        fail(f'train options: {len(per_step)} micro-steps, not '
             f'{OPTIONS_STEPS}')
    for i, step in enumerate(per_step):
        if not math.isfinite(step['loss']):
            fail(f'train options: micro-step {i} loss {step["loss"]}')
        for fn in bn_kernel.KERNELS:
            if step['launches'][fn.__name__] != n_bn:
                fail(f'train options: micro-step {i} launched '
                     f'{fn.__name__} {step["launches"][fn.__name__]} times, '
                     f'not {n_bn}')
        if step['moved'] != (i % 2 == 1):
            fail(f'train options: micro-step {i} moved the parameters: '
                 f'{step["moved"]} (accumulation_steps 2)')
    if launches['nms_keep_batched'] != len(exp.loaders['eval']):
        fail(f'train options: the evaluation launched {launches}')
    if not all(math.isfinite(v) for v in rows[0].values()):
        fail(f'train options: non-finite row {rows[0]}')
    if exp.eval_model is exp.model:
        fail('train options: the evaluation did not run the EMA shadow')
    gap = max((exp.trainer.state.ema_params[n] - p.detach()).abs().max().item()
              for n, p in exp.model.named_parameters())
    if not gap > 0:
        fail('train options: the shadow equals the parameters')

    t = time.perf_counter()
    path = ckpt.save(work, exp.trainer.state, 0)
    save_ms = (time.perf_counter() - t) * 1e3
    fresh = options_trainer({**OPTIONS_TRAIN}, seed=SEED + 1,
                            loss=OPTIONS_LOSS)
    t = time.perf_counter()
    ckpt.restore(path, fresh.state)
    restore_ms = (time.perf_counter() - t) * 1e3
    state, again = exp.trainer.state, fresh.state
    if again.step != state.step:
        fail(f'train options: restored step {again.step}, not {state.step}')
    want = exp.model.state_dict()
    for k, v in fresh.model.state_dict().items():
        if not torch.equal(v, want[k]):
            fail(f'train options: restored {k} differs')
    buffers = 0
    for (n, p), q in zip(exp.model.named_parameters(),
                         fresh.model.parameters()):
        if not torch.equal(state.ema_params[n], again.ema_params[n]):
            fail(f'train options: restored shadow of {n} differs')
        for key, buf in state.optimizer.state[p].items():
            buffers += 1
            if not torch.equal(buf, again.optimizer.state[q][key]):
                fail(f'train options: restored {key} of {n} differs')
    kinds = sorted({k for s in state.optimizer.state.values() for k in s})
    if kinds != ['acc_grad', 'mu', 'nu']:
        fail(f'train options: optimizer buffers {kinds}')
    out = {'rows': rows, 'launches': launches, 'seconds': seconds,
           'n_bn': n_bn, 'per_step': per_step, 'shadow_gap': gap,
           'save_ms': save_ms, 'restore_ms': restore_ms,
           'restored_buffers': buffers, 'buffer_kinds': kinds}
    del exp, fresh
    torch.cuda.empty_cache()
    return out


def frozen_bn_run(batches) -> dict:
    """(c) Two steps with ``frozen_bn`` and ``fused_bn``: no BN kernel
    launch, the running statistics bit-equal before and after."""
    trainer = options_trainer({'frozen_bn': True})
    stats = {k: v.clone() for k, v in trainer.model.state_dict().items()
             if k.endswith(('running_mean', 'running_var'))}
    zero_launches()
    losses = [trainer.train_step(*b)['loss'].item() for b in batches[:2]]
    torch.cuda.synchronize()
    launches = read_launches()
    if any(launches[fn.__name__] for fn in bn_kernel.KERNELS):
        fail(f'frozen_bn launched BN kernels: {launches}')
    after = trainer.model.state_dict()
    for k, v in stats.items():
        if not torch.equal(v, after[k]):
            fail(f'frozen_bn wrote {k}')
    if not all(math.isfinite(v) for v in losses):
        fail(f'frozen_bn losses {losses}')
    return {'launches': launches, 'losses': losses,
            'statistics_unchanged': len(stats)}


def fused_against_single(batches) -> dict:
    """(d) ``fused_steps`` 4 in one call against four single steps from the
    same state (SGD, EMA and mixup on), under cudnn's deterministic
    algorithms for this comparison only: the same kernels on the same
    inputs in the same order, so the model's tensors, the shadow and the
    summed metrics must be bit-equal."""
    train = {'ema': 0.999, 'mixup': OPTIONS_TRAIN['mixup']}
    single = options_trainer(train)
    fused = options_trainer({**train, 'fused_steps': OPTIONS_FUSED})
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sums = None
        for b in batches[:OPTIONS_FUSED]:
            m = single.train_step(*b)
            sums = m if sums is None else {k: sums[k] + v for k, v in m.items()}
        got = fused.fused_train_step(batches[:OPTIONS_FUSED])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if fused.state.step != single.state.step:
        fail(f'fused_steps: step {fused.state.step} against '
             f'{single.state.step}')
    want = single.model.state_dict()
    unequal = [k for k, v in fused.model.state_dict().items()
               if not torch.equal(v, want[k])]
    unequal_shadow = [k for k, v in single.state.ema_params.items()
                      if not torch.equal(fused.state.ema_params[k], v)]
    unequal_metrics = [k for k in sums if not torch.equal(got[k], sums[k])]
    if unequal or unequal_shadow or unequal_metrics:
        fail(f'fused_steps: not bit-equal to the single steps: '
             f'{len(unequal)} model tensors, {len(unequal_shadow)} shadow '
             f'tensors, metrics {unequal_metrics}')
    return {'bit_equal': True, 'model_tensors': len(want),
            'shadow_tensors': len(single.state.ema_params),
            'metrics': sorted(sums)}


def launches_of(run) -> int:
    """The kernel launches (kernels, copies, fills) of one call of ``run``:
    the first count above 0 that two of the profiler's windows agree on
    (its trace drops a window's launches at random, once all of them),
    ``2 * PROFILER_TRIES`` windows at most, else the most seen."""
    def once():
        run()
        torch.cuda.synchronize()

    seen = []
    for _ in range(2 * PROFILER_TRIES):
        launches = busy_launches(profile_window(once))
        if launches > 0 and launches in seen:
            return launches
        seen.append(launches)
    log(f'  profiler windows saw {seen} launches of one call, no count '
        'twice: the most is kept')
    return max(seen)


def option_times(batches) -> dict:
    """(e) The b32 step in turns against the plain SGD step (a, b, ..., b,
    a): AdamW, EMA on, a micro-step of accumulation 2, ``fused_steps`` 4
    (its call over 4); the optimizer's and the EMA's launches per step and
    host ms."""
    from single_shot_detection_tpu_torch.train.step import update_ema
    sides = {
        'sgd': options_trainer({}),
        'adamw': options_trainer({'optimizer': OPTIONS_TRAIN['optimizer'],
                                  'clip_grad_norm': 10.0}),
        'ema': options_trainer({'ema': 0.999}),
        'accumulate_2': options_trainer({'accumulation_steps': 2}),
        'fused_4': options_trainer({'fused_steps': OPTIONS_FUSED}),
    }
    batch = batches[0]
    calls = {name: (lambda t=t: t.train_step(*batch))
             for name, t in sides.items() if name != 'fused_4'}
    fused = sides['fused_4']
    calls['fused_4'] = lambda: fused.fused_train_step([batch] * OPTIONS_FUSED)
    turns = in_turns(calls, iters=OPTIONS_TURN_ITERS)
    turns['fused_4'] = {'call_ms': turns['fused_4']['ms'],
                        'ms': turns['fused_4']['ms'] / OPTIONS_FUSED,
                        'all_ms': turns['fused_4']['all_ms']}
    out = {'step_ms': {k: v['ms'] for k, v in turns.items()},
           'all_ms': {k: v['all_ms'] for k, v in turns.items()},
           'fused_4_call_ms': turns['fused_4']['call_ms']}
    per_step = {}
    for name in ('sgd', 'adamw'):
        t = sides[name]
        t.train_step(*batch)  # leaves the gradients in .grad

        def step(t=t):
            t.state.optimizer.step(count=t.state.step, schedule=t.schedule,
                                   lr_scale=t.state.lr_scale)

        per_step[f'optimizer_{name}'] = {
            'launches': launches_of(step),
            'host_ms': statistics.median(host_times_ms(step, iters=10))}
    ema = sides['ema']
    run_ema = lambda: update_ema(ema.state, ema.ema)
    per_step['ema'] = {'launches': launches_of(run_ema),
                       'host_ms': statistics.median(host_times_ms(run_ema,
                                                                  iters=10))}
    out['per_step'] = per_step
    out['parameters'] = sum(p.numel() for p in sides['sgd'].model.parameters())
    out['parameter_tensors'] = len(list(sides['sgd'].model.parameters()))
    del sides, fused, calls
    torch.cuda.empty_cache()
    return out


def run_train_options(smi: str) -> dict:
    """Phase 20: the rest of the train path on the flagship at full width
    (b32, ``fused_bn``): (a) each optimizer on the card against the CPU,
    (b) every option at once through ``Experiment`` with an evaluation on
    the shadow and a ``.pt`` round trip, (c) ``frozen_bn``, (d)
    ``fused_steps`` against single steps, (e) the options' step times in
    turns."""
    rng = np.random.RandomState(SEED + 20)
    batches = [train_batch(rng) for _ in range(OPTIONS_FUSED)]
    out = {}
    work = tempfile.mkdtemp(prefix='chip_smoke_options_')
    try:
        t = time.perf_counter()
        out['optimizers'] = optimizers_card_vs_cpu()
        log(f'[20] {smi}: (a) one update of each optimizer over the '
            f'flagship\'s parameters, card against CPU (warmup schedule, '
            f'lr_scale {OPTIMIZER_LR_SCALE}, lr_groups score_head, clip at '
            f'{OPTIMIZER_CLIP_SHARE} of the norm; worst share of the '
            f'tolerance {OPTIMIZER_TOL} x update + ulp) in '
            f'{time.perf_counter() - t:.1f} s: '
            + json.dumps({k: round(v['worst_share_of_tol'], 4)
                          for k, v in out['optimizers'].items()}))
        t = time.perf_counter()
        out['combined'] = combined_run(work)
        c = out['combined']
        log(f'  (b) Experiment with {json.dumps(OPTIONS_TRAIN)} and the '
            f'soft-target CE + GIoU losses: {OPTIONS_STEPS} augmented b32 '
            f'micro-steps and an evaluation on the shadow in '
            f'{c["seconds"]:.2f} s; each micro-step {c["n_bn"]} launches of '
            'each BN kernel, parameters moved on micro-steps '
            + str([i for i, s in enumerate(c['per_step']) if s['moved']])
            + f'; shadow apart by {c["shadow_gap"]:.3g}; launches '
            + json.dumps(c['launches']) + '; row ' + json.dumps(c['rows'][0])
            + f'; .pt save {c["save_ms"]:.1f} ms, restore '
            f'{c["restore_ms"]:.1f} ms, bit-equal with the shadow and '
            f'{c["restored_buffers"]} optimizer buffers ({c["buffer_kinds"]}) '
            f'({time.perf_counter() - t:.1f} s)')
        out['frozen_bn'] = frozen_bn_run(batches)
        log('  (c) frozen_bn: 2 steps, BN kernel launches '
            + json.dumps(out['frozen_bn']['launches']) + ', '
            f'{out["frozen_bn"]["statistics_unchanged"]} running statistics '
            'bit-equal')
        out['fused'] = fused_against_single(batches)
        log(f'  (d) fused_steps {OPTIONS_FUSED} against {OPTIONS_FUSED} single '
            'steps (cudnn deterministic): ' + json.dumps(out['fused']))
        out['times'] = option_times(batches)
        log(f'  (e) {smi}: step ms in turns: '
            + json.dumps({k: round(v, 3) for k, v in
                          out['times']['step_ms'].items()})
            + f' (fused_4 call {out["times"]["fused_4_call_ms"]:.3f} ms); '
            'per step: ' + json.dumps(out['times']['per_step']))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 21

# The committed JPEG fixtures (tools/make_jpeg_fixtures.py): 16 VOC-like
# JPEGs, one grayscale, listed 256 times for train and 64 for eval
JPEG_FIXTURES = REPO / 'single_shot_detection_tpu_torch' / 'data' / 'jpeg_fixtures'
EXTRAS_SETS = {'train': 'train256', 'eval': 'eval64'}
EXTRAS_EPOCHS = 3
EXTRAS_STAGING = (300, 300)


def extras_dataset() -> dict:
    """The fixtures as Pascal VOC."""
    return {phase: {'name': 'Voc', 'root': str(JPEG_FIXTURES),
                    'image_sets': [(2007, image_set)]}
            for phase, image_set in EXTRAS_SETS.items()}


def libjpeg_present() -> dict:
    """What this machine has of libjpeg, which the native decoder needs to
    build (the header) and to load (a shared library): ``jpeglib.h`` on the
    compiler's default include path, the library the dynamic loader finds,
    whether ``libjpeg.so.62`` loads, and the libjpeg that Pillow bundles (a
    runtime with no header)."""
    import ctypes.util
    import glob
    import sysconfig
    headers = [d for d in ('/usr/include', '/usr/local/include',
                           '/usr/include/x86_64-linux-gnu')
               if os.path.exists(os.path.join(d, 'jpeglib.h'))]
    site = sysconfig.get_paths()['purelib']
    bundled = sorted(os.path.basename(p) for p in
                     glob.glob(os.path.join(site, 'pillow.libs', 'libjpeg*')))
    try:
        from PIL import features
        pil_jpeg = features.version('jpg')
    except Exception as exc:  # Pillow missing or built without JPEG
        pil_jpeg = f'unavailable ({exc})'
    try:  # the soname the JAX package's prebuilt native/ library links
        ctypes.CDLL('libjpeg.so.62')
        so62 = True
    except OSError:
        so62 = False
    return {'jpeglib_h': headers, 'libjpeg_so': ctypes.util.find_library('jpeg'),
            'libjpeg_so_62_loads': so62, 'pillow_bundled': bundled,
            'pillow_libjpeg_version': pil_jpeg}


def native_decode_check() -> dict:
    """(a) The port's decoder built from its source by the route this
    machine allows: the 16 fixtures staged to the committed digest (RGB
    and YUV420 at 300, 150, 64 and 38 px), and at 300x300 bit-equal across
    two calls and at 1 and 8 threads, with each image's original size.
    A decoder that does not build fails."""
    from single_shot_detection_tpu_torch.data import datasets, native
    from single_shot_detection_tpu_torch.tools import make_jpeg_fixtures
    t = time.perf_counter()
    lib = native.get_library()
    if lib is None:
        fail(f'the native JPEG decoder did not build or load: {native.error}; '
             f'libjpeg on this machine: {json.dumps(libjpeg_present())}')
    build_s = time.perf_counter() - t
    want = json.loads(make_jpeg_fixtures.DIGEST_FILE.read_text())
    digests = make_jpeg_fixtures.staged_digests(lib)
    differ = sorted(k for k in want if digests.get(k) != want[k])
    if differ or digests.keys() != want.keys():
        fail(f'the {native.route} build stages the fixtures to another digest '
             f'at {differ}: {digests}')
    ds = datasets.Voc(str(JPEG_FIXTURES), [(2007, 'all')])
    paths = [a['image_path'] for a in ds.annotations]
    want_sizes = np.array([(a['width'], a['height']) for a in ds.annotations])
    w, h = EXTRAS_STAGING
    outs = {}
    for kind, shape, call in (
            ('rgb', (len(paths), h, w, 3), lambda out, n: native.decode_batch_into(
                paths, out, num_threads=n)),
            ('yuv420', (len(paths), w * h * 3 // 2),
             lambda out, n: native.decode_batch_into_yuv420(
                 paths, out, EXTRAS_STAGING, num_threads=n))):
        runs = []
        for threads in (1, 8, 8):
            out = np.zeros(shape, np.uint8)
            sizes = call(out, threads)
            if sizes is None or not np.array_equal(sizes, want_sizes):
                fail(f'native {kind} decode gave sizes {sizes}')
            runs.append(out)
        if not all(np.array_equal(runs[0], r) for r in runs[1:]):
            fail(f'native {kind} decode differs between calls or threads')
        outs[kind] = runs[0]
    return {'route': native.route, 'build_or_load_s': build_s,
            'digests_equal': sorted(digests), 'libjpeg': libjpeg_present(),
            'images': len(paths), 'yuv420_batch': outs['yuv420']}


def yuv_card_vs_cpu(packed: np.ndarray) -> dict:
    """(b) ``yuv420_to_rgb`` on the card against the CPU."""
    cpu = transforms.yuv420_to_rgb(torch.from_numpy(packed), EXTRAS_STAGING)
    card = transforms.yuv420_to_rgb(torch.from_numpy(packed).cuda(),
                                    EXTRAS_STAGING)
    if not torch.equal(card.cpu(), cpu):
        fail('yuv420_to_rgb on the card differs from the CPU: '
             f'{int((card.cpu() != cpu).sum())} values')
    return {'values': cpu.numel(), 'equal': True}


def fixture_train_set():
    from single_shot_detection_tpu_torch.data.datasets import Voc
    return Voc(str(JPEG_FIXTURES), [(2007, EXTRAS_SETS['train'])])


def loader_times(smi: str) -> dict:
    """Loader img/s at b32 over the fixtures' 256 train entries, native
    and Python (PIL) decode, RGB and YUV420 staging (staging on
    the card, as an ``Experiment`` stages); each batch's pinned copy to
    the card, ms and bytes."""
    from single_shot_detection_tpu_torch.data.loader import Loader

    class PythonDecode(Loader):
        def _native_fill(self, idxs, rows_out):
            return None

    ds = fixture_train_set()
    paths = (('native', Loader), ('python', PythonDecode))
    out = {}
    for colorspace in ('rgb', 'yuv420'):
        for path, cls in paths:
            loader = cls(ds, 32, EXTRAS_STAGING, staging_colorspace=colorspace,
                         staging_device=torch.device('cuda'))
            t = time.perf_counter()
            batches = list(loader)
            seconds = time.perf_counter() - t
            out[f'{colorspace}_{path}_img_per_s'] = len(ds) / seconds
        image = batches[0]['image']

        def copy():
            torch.from_numpy(image).pin_memory().to('cuda', non_blocking=True)

        out[f'{colorspace}_batch_bytes'] = image.nbytes
        out[f'{colorspace}_copy_ms'] = statistics.median(host_times_ms(copy, 10))
    log(f'  {smi}: loader b32 over the {len(ds)} fixture entries, img/s: '
        + ', '.join(f'{c} {p} {out[f"{c}_{p}_img_per_s"]:.1f}'
                    for c in ('rgb', 'yuv420') for p, _ in paths)
        + '; a batch\'s pinned copy to the card: '
        + ', '.join(f'{c} {out[f"{c}_batch_bytes"]} B in '
                    f'{out[f"{c}_copy_ms"]:.3f} ms' for c in ('rgb', 'yuv420')))
    return out


def staging_cache_times(work: str) -> dict:
    """A yuv420 loader epoch over the fixtures that decodes and fills the
    staging cache against one that reads it back (staging on the card)."""
    from single_shot_detection_tpu_torch.data.loader import Loader
    ds = fixture_train_set()
    out = {}
    for label in ('decode_epoch_s', 'cache_hit_epoch_s'):
        loader = Loader(ds, 32, EXTRAS_STAGING, staging_colorspace='yuv420',
                        cache_dir=os.path.join(work, 'timed_cache'),
                        staging_device=torch.device('cuda'))
        t = time.perf_counter()
        for _ in loader:
            pass
        out[label] = time.perf_counter() - t
    if not loader.cache.complete:
        fail('the staging cache is not complete after an epoch')
    return out


def count_staged(loader) -> list:
    """Record the size of each batch ``loader`` stages from now on."""
    staged = []
    make_batch = loader._make_batch

    def counted(idxs, pool):
        staged.append(len(idxs))
        return make_batch(idxs, pool)

    loader._make_batch = counted
    return staged


def htod_copies(run) -> list:
    """Bytes of each host-to-device copy in the profiler's trace of one
    call of ``run`` (after a warm-up call), from its memcpy rows."""
    prof = profile_window(run)
    with tempfile.NamedTemporaryFile(suffix='.json') as f:
        prof.export_chrome_trace(f.name)
        with open(f.name) as g:
            events = json.load(g)['traceEvents']
    copies = [e for e in events if e.get('cat') == 'gpu_memcpy'
              and 'HtoD' in e.get('name', '')]
    if copies and any('bytes' not in e.get('args', {}) for e in copies):
        fail('the profiler\'s memcpy rows carry no byte counts')
    return [int(e['args']['bytes']) for e in copies]


def cached_epoch_checks(exp: Experiment, record_bytes: int) -> dict:
    """(c) The batches a cached epoch gathers against the streamed loader's
    and copy's, for the same epoch, tensor for tensor; then the
    host-to-device copies of a cached and of a streamed epoch.  A copy of
    image bytes is one whose size is a whole number of image records
    (``record_bytes``): the streamed epoch copies each batch's images in
    one such copy, the cached one makes none, and its copies (each step's
    augmentation draws and the epoch's indices) stay under one batch of
    images in all."""
    loader = exp.loaders['train']
    cache = exp.device_cache
    gathered = list(cache.epoch_batches(loader, 1, 1))
    loader.epoch = 1
    streamed = [t for _, t in prefetch_to_device(loader, exp.device, 2)]
    if len(gathered) != len(streamed) or not all(
            torch.equal(a, b) for (_, g), s in zip(gathered, streamed)
            for a, b in zip(g, s)):
        fail('a cached epoch\'s batches differ from the streamed ones')
    del gathered, streamed
    copies = {'cached': htod_copies(lambda: (exp.train_epoch(5),
                                             torch.cuda.synchronize()))}
    exp.device_cache = None  # stream the same epoch
    copies['streamed'] = htod_copies(lambda: (exp.train_epoch(5),
                                              torch.cuda.synchronize()))
    exp.device_cache = cache
    batch_bytes = record_bytes * loader.batch_size
    image_copies = {k: [b for b in v if b and b % record_bytes == 0]
                    for k, v in copies.items()}
    if image_copies['cached'] or sum(copies['cached']) >= batch_bytes:
        fail(f'a cached epoch copied {copies["cached"]} bytes to the card '
             f'(an image record is {record_bytes} B, a batch of images '
             f'{batch_bytes} B)')
    if len(image_copies['streamed']) < len(loader):
        fail(f'the profiler saw {len(image_copies["streamed"])} image '
             f'copies of the streamed epoch\'s {len(loader)}')
    return {'batches_equal': len(loader),
            'htod_copies': {k: len(v) for k, v in copies.items()},
            'htod_bytes': {k: sum(v) for k, v in copies.items()},
            'htod_largest_bytes': {k: max(v, default=0)
                                   for k, v in copies.items()},
            'image_copies': {k: len(v) for k, v in image_copies.items()}}


EPOCH_TURNS = ('cached', 'streamed', 'streamed', 'cached')


def epoch_turns(exp: Experiment) -> dict:
    """A device-cached train epoch against a streamed one (the loader
    reading the staging cache, the batches copied ahead), in turns
    (``EPOCH_TURNS``), seconds each."""
    cache = exp.device_cache
    times = {'cached': [], 'streamed': []}
    for i, label in enumerate(EPOCH_TURNS):
        exp.device_cache = cache if label == 'cached' else None
        t = time.perf_counter()
        exp.train_epoch(10 + i)  # reads its sums: waits for the card
        times[label].append(time.perf_counter() - t)
    exp.device_cache = cache
    return times


EVAL_TURNS = ('replayed', 'streamed', 'streamed', 'replayed', 'replayed',
              'streamed')


def eval_replay_checks(exp: Experiment) -> dict:
    """(d) A replayed evaluation against a streamed one: no loader batch,
    the NMS kernel launched alike, the same loss and mAP; their times in
    turns (``EVAL_TURNS``, medians)."""
    loader = exp.loaders['eval']
    cache = exp._eval_cache
    if cache is None:
        fail('the eval replay cache is empty after training')
    exp._eval_replay_cfg = None  # a streamed evaluation keeps nothing
    staged = count_staged(loader)
    runs = {}
    for label in EVAL_TURNS:
        exp._eval_cache = cache if label == 'replayed' else None
        staged.clear()
        zero_launches()
        t = time.perf_counter()
        metrics = exp.evaluate()  # reads its sums: waits for the card
        seconds = time.perf_counter() - t
        if label in runs:
            runs[label]['times_s'].append(seconds)
            if any(metrics[k] != runs[label]['metrics'][k]
                   for k in ('loss', 'mAP')):
                fail(f'{label} evaluations differ: {metrics} against '
                     f'{runs[label]["metrics"]}')
            continue
        runs[label] = {'times_s': [seconds], 'metrics': metrics,
                       'nms_launches': nms_kernel.nms_keep_batched.launches,
                       'loader_batches': len(staged)}
    for run in runs.values():
        run['s'] = statistics.median(run['times_s'])
    replayed, streamed = runs['replayed'], runs['streamed']
    if replayed['loader_batches'] != 0 or streamed['loader_batches'] != len(loader):
        fail(f'eval loader batches: replayed {replayed["loader_batches"]}, '
             f'streamed {streamed["loader_batches"]}')
    if not replayed['nms_launches'] == streamed['nms_launches'] == len(loader):
        fail(f'NMS launches replayed {replayed["nms_launches"]}, streamed '
             f'{streamed["nms_launches"]}, eval batches {len(loader)}')
    for key in ('loss', 'mAP'):
        if replayed['metrics'][key] != streamed['metrics'][key]:
            fail(f'replayed eval {key} {replayed["metrics"][key]} against '
                 f'streamed {streamed["metrics"][key]}')
    return runs


def async_save_checks(exp: Experiment, work: str) -> dict:
    """(e) An async save held back while a cached epoch of 8 steps runs
    restores bit-equal to the state at the save; and the loop's blocked ms
    of a synchronous save against an async one."""
    state = exp.trainer.state
    want = ckpt._map_tensors(ckpt.saved_dict(state),
                             lambda t: t.detach().cpu().clone())
    gate = threading.Event()
    real_write = ckpt.write

    def held_write(*args):
        gate.wait(120)
        return real_write(*args)

    saver = ckpt.AsyncSaver()
    ckpt.write = held_write
    try:
        saver.save(os.path.join(work, 'held'), state, 7)
        exp.train_epoch(6)  # 8 steps while the write waits
        torch.cuda.synchronize()
        in_flight = saver._thread is not None and saver._thread.is_alive()
        gate.set()
        saver.wait()
    finally:
        ckpt.write = real_write
        gate.set()
    if not in_flight:
        fail('the async write finished before the steps it should overlap')
    saved = torch.load(saver.path, map_location='cpu', weights_only=True)
    mismatched = []

    def compare(a, b, name):
        if isinstance(a, dict):
            for k in a:
                compare(a[k], b[k], f'{name}.{k}')
        elif isinstance(a, torch.Tensor):
            if not torch.equal(a, b):
                mismatched.append(name)
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                compare(x, y, f'{name}[{i}]')
    compare(want, saved, 'ckpt')
    moved = sum(not torch.equal(v.cpu(), want['model'][k])
                for k, v in state.model.state_dict().items())
    if mismatched or not moved:
        fail(f'the held async save differs from the state at the save in '
             f'{mismatched[:5]} ({len(mismatched)} tensors); {moved} tensors '
             'moved since')
    ckpt.restore(saver.path, state)
    if not all(torch.equal(v.cpu(), want['model'][k])
               for k, v in state.model.state_dict().items()):
        fail('the async checkpoint does not restore the state at the save')
    blocked = {'sync': [], 'async': [], 'async_wait': []}
    for i in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ckpt.save(os.path.join(work, 'sync'), state, i)
        blocked['sync'].append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        t = time.perf_counter()
        saver.save(os.path.join(work, 'async'), state, i)
        blocked['async'].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        saver.wait()
        blocked['async_wait'].append((time.perf_counter() - t) * 1e3)
    return {'tensors': len(ckpt._tensors(want)), 'moved_since': moved,
            'restored_equal': True,
            'blocked_ms': {k: statistics.median(v) for k, v in blocked.items()}}


def tensorboard_check(run_dir: str) -> dict:
    """(f) The event file's scalars against ``log.csv``'s rows (float32),
    under ``train/{key}`` and ``eval/{key}``."""
    try:
        from tensorboard.backend.event_processing.event_accumulator import \
            EventAccumulator
    except ImportError:
        return {'installed': False}
    acc = EventAccumulator(run_dir)
    acc.Reload()
    got = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
           for tag in acc.Tags()['scalars']}
    want = {}
    for row in read_log_csv(os.path.join(run_dir, 'log.csv')):
        for key, value in row.items():
            if key != 'epoch' and value != '':
                tag = ('train/' + key if key.startswith('train_')
                       else 'eval/' + key[len('eval_'):])
                want.setdefault(tag, []).append(
                    (int(row['epoch']), float(np.float32(value))))
    if got != want:
        fail(f'tensorboard scalars {got} differ from log.csv {want}')
    return {'installed': True, 'tags': len(got),
            'values': sum(len(v) for v in got.values())}


def run_data_extras(smi: str) -> dict:
    """Phase 21: the data path and run extras on the flagship at full width
    (b32, ``fused_bn``) through ``Experiment`` with every option at once."""
    from single_shot_detection_tpu_torch.data import native
    out = {}
    work = tempfile.mkdtemp(prefix='chip_smoke_extras_')
    try:
        t = time.perf_counter()
        decoded = native_decode_check()
        out['native'] = {k: v for k, v in decoded.items()
                         if k != 'yuv420_batch'}
        log(f'[21] {smi}: (a) native: built by the {decoded["route"]} route '
            + ('(-ljpeg)' if decoded['route'] == 'system' else
               '(native/include headers, Pillow\'s '
               f'{native.pillow_libjpeg().name})')
            + f' and loaded in {decoded["build_or_load_s"]:.2f} s; the '
            f'{decoded["images"]} fixtures staged to the committed digest '
            f'({", ".join(decoded["digests_equal"])}), at 300x300 bit-equal '
            'over two calls and at 1 and 8 threads, original sizes right; '
            f'libjpeg on this machine: {json.dumps(decoded["libjpeg"])}')
        out['yuv'] = yuv_card_vs_cpu(decoded['yuv420_batch'])
        dataset_cfg = extras_dataset()
        counts = dict(native.COUNTS)
        exp = Experiment(FLAGSHIP, phases=('train', 'eval'), device='cuda',
                         seed=SEED, checkpoint_dir=os.path.join(work, 'run'),
                         tensorboard=True, overrides={
                             'dataset': dataset_cfg,
                             'train': {'epochs': EXTRAS_EPOCHS, 'eval_every': 1,
                                       'fused_bn': True,
                                       'staging_colorspace': 'yuv420',
                                       'staging_cache': os.path.join(work, 'stage'),
                                       'device_cache': True,
                                       'async_checkpoint': True}})
        log(f'  (b) yuv420_to_rgb on the card bit-equal to the CPU on '
            f'{out["yuv"]["values"]} values')
        n_bn = sum(isinstance(m, BatchNorm) for m in exp.model.modules())
        steps = len(exp.loaders['train'])
        epoch_s = []
        train_epoch = exp.train_epoch

        def timed_epoch(epoch):
            t0 = time.perf_counter()
            row = train_epoch(epoch)  # reads its sums: waits for the card
            epoch_s.append(time.perf_counter() - t0)
            return row

        exp.train_epoch = timed_epoch
        staged = {phase: count_staged(loader)
                  for phase, loader in exp.loaders.items()}
        zero_launches()
        t0 = time.perf_counter()
        rows = exp.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        del exp.train_epoch
        decode_counts = {k: native.COUNTS[k] - counts.get(k, 0)
                         for k in ('native', 'python')}
        want = {fn.__name__: n_bn * steps * EXTRAS_EPOCHS
                for fn in bn_kernel.KERNELS}
        want['nms_keep_batched'] = EXTRAS_EPOCHS * len(exp.loaders['eval'])
        if launches != want:
            fail(f'kernel launches {launches}, expected {want}')
        if not all(np.isfinite(v) for row in rows for v in row.values()):
            fail(f'non-finite rows {rows}')
        if not all(0.0 <= row['eval_mAP'] <= 1.0 for row in rows):
            fail(f'mAP outside [0, 1]: {rows}')
        if not exp.device_cache.ready or exp._eval_cache is None:
            fail('the device cache or the eval replay cache is not filled')
        for loader in exp.loaders.values():
            del loader._make_batch
        # the fill epoch's batches and its top-up, one streamed evaluation
        want_staged = {'train': steps + -(-exp.device_cache.topped_up // 32),
                       'eval': len(exp.loaders['eval'])}
        if {k: len(v) for k, v in staged.items()} != want_staged:
            fail(f'the loaders staged {staged} over {EXTRAS_EPOCHS} epochs, '
                 f'expected {want_staged} batches')
        if decode_counts['native'] != 256 + 64:
            fail(f'decoded {decode_counts}, expected 320 natively')
        out['experiment'] = {
            'seconds': seconds, 'epoch_s': epoch_s, 'rows': rows,
            'launches': launches, 'decoded': decode_counts,
            'steps_per_epoch': steps, 'n_bn': n_bn,
            'staged_batches': {k: len(v) for k, v in staged.items()},
            'topped_up': exp.device_cache.topped_up,
            'device_cache_bytes': exp.device_cache.total_bytes}
        images = steps * exp.loaders['train'].batch_size
        log(f'  Experiment.train(): {EXTRAS_EPOCHS} epochs of {steps} b32 '
            f'steps (yuv420, staging cache, device cache, eval replay, async '
            f'checkpoints, tensorboard) in {seconds:.2f} s; epochs '
            + ', '.join(f'{s:.3f} s = {images / s:.1f} img/s' for s in epoch_s)
            + f' (fill, then from the card); kernel launches '
            + json.dumps(launches) + f' ({n_bn} a step for each BN kernel); '
            f'images decoded {json.dumps(decode_counts)}; device cache '
            f'{exp.device_cache.total_bytes} B, {exp.device_cache.topped_up} '
            'rows topped up')
        for row in rows:
            log('    ' + json.dumps(row))
        record_bytes = exp.device_cache.device['image'][0].nbytes
        batch_bytes = record_bytes * exp.loaders['train'].batch_size
        out['cached_epoch'] = cached_epoch_checks(exp, record_bytes)
        c = out['cached_epoch']
        log(f'  (c) {c["batches_equal"]} cached batches bit-equal to the '
            'streamed loader\'s and copy\'s; host-to-device copies of an '
            'epoch (profiler memcpy rows): cached '
            f'{c["htod_copies"]["cached"]} copies, {c["htod_bytes"]["cached"]} B '
            f'(largest {c["htod_largest_bytes"]["cached"]} B), streamed '
            f'{c["htod_copies"]["streamed"]} copies, '
            f'{c["htod_bytes"]["streamed"]} B ({c["image_copies"]["streamed"]} '
            f'copies of whole {record_bytes} B image records; a batch of '
            f'images is {batch_bytes} B)')
        out['epoch_turns'] = epoch_turns(exp)
        log(f'  {smi}: train epochs in turns {EPOCH_TURNS}: '
            + '; '.join(f'{k} ' + ', '.join(f'{t:.3f} s = {images / t:.1f} img/s'
                                           for t in v)
                        for k, v in out['epoch_turns'].items()))
        out['eval_replay'] = eval_replay_checks(exp)
        r = out['eval_replay']
        log(f'  (d) {smi}: evaluation in turns {EVAL_TURNS}, medians: '
            f'replayed {r["replayed"]["s"]:.3f} s '
            f'({", ".join(f"{t:.3f}" for t in r["replayed"]["times_s"])}), '
            f'streamed {r["streamed"]["s"]:.3f} s '
            f'({", ".join(f"{t:.3f}" for t in r["streamed"]["times_s"])}); '
            f'loader batches '
            f'{r["replayed"]["loader_batches"]} and '
            f'{r["streamed"]["loader_batches"]}; NMS launches '
            f'{r["replayed"]["nms_launches"]} and {r["streamed"]["nms_launches"]}; '
            f'loss {r["replayed"]["metrics"]["loss"]:.6f}, mAP '
            f'{r["replayed"]["metrics"]["mAP"]:.6f} both')
        out['async'] = async_save_checks(exp, work)
        a = out['async']
        log(f'  (e) {smi}: an async save held while 8 steps ran restores '
            f'bit-equal to the state at the save ({a["tensors"]} tensors; '
            f'{a["moved_since"]} model tensors moved since); the loop blocked '
            f'{a["blocked_ms"]["sync"]:.1f} ms by a synchronous save, '
            f'{a["blocked_ms"]["async"]:.1f} ms by an async one (its write '
            f'{a["blocked_ms"]["async_wait"]:.1f} ms more in the background)')
        out['tensorboard'] = tensorboard_check(exp.checkpoint_dir)
        tb = out['tensorboard']
        log('  (f) ' + (f'tensorboard: {tb["values"]} scalars under {tb["tags"]} '
                        'tags equal log.csv\'s rows' if tb['installed'] else
                        'tensorboard is not installed: no event file'))
        del exp
        torch.cuda.empty_cache()
        out['loader'] = loader_times(smi)
        out['staging_cache'] = staging_cache_times(work)
        s = out['staging_cache']
        log(f'  {smi}: a yuv420 loader epoch that decodes and fills the '
            f'staging cache {s["decode_epoch_s"]:.3f} s, one that reads it '
            f'{s["cache_hit_epoch_s"]:.3f} s; decoded in this process: '
            + json.dumps(dict(native.COUNTS)) + f'; phase 21 checks in '
            f'{time.perf_counter() - t:.1f} s')
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


INTEROP_DATA = {'train': {**FLAGSHIP_DATA['train'], 'num_images': 64},
                'eval': {**FLAGSHIP_DATA['eval'], 'num_images': 32}}
HUB_MODEL = 'torchhub://pytorch/vision:mobilenet_v2'


def interop_experiment(model: Optional[dict] = None,
                       phases=('eval',)) -> Experiment:
    """The flagship on the card through ``Experiment``, synthetic data,
    ``fused_bn``, no augmentation, ``model`` merged into its model block."""
    return Experiment(FLAGSHIP, phases=phases, device='cuda', seed=SEED,
                      overrides={'dataset': INTEROP_DATA, 'augmentations': [],
                                 'train': {'fused_bn': True},
                                 **({'model': model} if model else {})})


def states_equal(got: dict, want: dict, label: str) -> int:
    """Fails unless every tensor of ``want`` but ``num_batches_tracked`` is
    in ``got`` bit-equal; returns how many were compared."""
    keys = [k for k in want if not k.endswith('num_batches_tracked')]
    differ = [k for k in keys if k not in got
              or not torch.equal(got[k].cpu(), want[k].cpu())]
    if differ:
        fail(f'{label}: {len(differ)} of {len(keys)} tensors differ, e.g. '
             f'{differ[:4]}')
    return len(keys)


def keras_h5_check(work: str, source_state: dict) -> Optional[dict]:
    """A keras ``.h5`` (whole-model layout) of seeded arrays shaped as the
    flagship's MobileNetV2, imported into an ``Experiment`` on the card
    through ``base.weight``: every mapped array lands, transposed to the
    port's layout.  None where ``h5py`` does not import."""
    try:
        import h5py
    except ImportError:
        return None
    from single_shot_detection_tpu_torch.utils import keras_import
    flagship_model = dict(load_config(FLAGSHIP).model)
    rng = np.random.RandomState(SEED + 22)
    path = os.path.join(work, 'mobilenet_v2.h5')
    want = {}
    with h5py.File(path, 'w') as f:
        root = f.create_group('model_weights')
        for layer, (our_path, kind) in keras_import.keras_mobilenet_v2_mapping().items():
            grp = root.create_group(layer).create_group(layer)
            target = '.'.join(('features', 'base') + our_path)
            shape = tuple(source_state[f'{target}.weight'].shape)
            if kind == keras_import.BN:
                for name, leaf in (('gamma:0', 'weight'), ('beta:0', 'bias'),
                                   ('moving_mean:0', 'running_mean'),
                                   ('moving_variance:0', 'running_var')):
                    arr = (rng.rand(*shape) + 0.5).astype(np.float32)
                    grp.create_dataset(name, data=arr)
                    want[f'{target}.{leaf}'] = torch.from_numpy(arr)
            else:  # keras [kh, kw, in, out]; depthwise [kh, kw, ch, 1]
                axes = (2, 3, 0, 1) if kind == keras_import.DEPTHWISE else (2, 3, 1, 0)
                arr = rng.randn(*[shape[a] for a in axes]).astype(np.float32)
                grp.create_dataset('depthwise_kernel:0' if kind == keras_import.DEPTHWISE
                                   else 'kernel:0', data=arr)
                back = (2, 3, 0, 1) if kind == keras_import.DEPTHWISE else (3, 2, 0, 1)
                want[f'{target}.weight'] = torch.from_numpy(
                    np.ascontiguousarray(arr.transpose(back)))
    # keras weights map by family name; the flagship's registry name is
    # ``torchvision_mobilenet_v2``, the same network as ``mobilenet_v2``
    exp = interop_experiment({'base': {**flagship_model['base'],
                                       'name': 'mobilenet_v2', 'weight': path}})
    n = states_equal(exp.model.state_dict(), want, 'keras .h5 import')
    del exp
    return {'h5py': h5py.__version__, 'tensors': n}


def run_interop(smi: str, jax_card_metrics: dict) -> dict:
    """Phase 22: the reference's checkpoint both ways, offline torch-hub
    and keras backbones and a bilinear neck, at full width on the card."""
    from single_shot_detection_tpu_torch.models import builder
    from single_shot_detection_tpu_torch.tools import export_torch_ckpt
    from single_shot_detection_tpu_torch.utils import torch_import
    flagship_model = dict(load_config(FLAGSHIP).model)
    out = {}
    work = tempfile.mkdtemp(prefix='chip_smoke_interop_')
    try:
        t = time.perf_counter()
        # (a) seeded weights -> the reference's checkpoint -> torch_weight
        source = interop_experiment()
        perturb_bn(source.model, torch.Generator().manual_seed(SEED + 1))
        path = os.path.join(work, 'reference.pt')
        torch_import.export_reference_checkpoint(
            path, source.model.state_dict(),
            **torch_import.mapping_args_from_config(flagship_model))
        imported = interop_experiment(
            {'detector': {**flagship_model['detector'], 'torch_weight': path}},
            phases=('train', 'eval'))
        n_tensors = states_equal(imported.model.state_dict(),
                                 source.model.state_dict(), 'torch_weight import')
        images = np.random.RandomState(SEED + 22).randint(
            0, 256, (32, 300, 300, 3), dtype=np.uint8)
        want = source.predictor().predict_batch(images)
        zero_launches()
        got = imported.predictor().predict_batch(images)
        torch.cuda.synchronize()
        serving = read_launches()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail('serving the imported weights differs from the source model: '
                 f'{int((got[0] != want[0]).sum())} detection values, '
                 f'{int((got[1] != want[1]).sum())} valid flags')
        if serving['nms_keep_batched'] < 1 or any(
                serving[fn.__name__] for fn in bn_kernel.KERNELS):
            fail(f'serving the imported weights launched {serving}')
        out['serving'] = {'tensors': n_tensors, 'launches': serving,
                          'valid': int(want[1].sum())}
        log(f'[22] {smi}: (a) {FLAGSHIP}\'s seeded weights written as the '
            f'reference\'s checkpoint and imported by torch_weight: '
            f'{n_tensors} tensors bit-equal; b32 predict_batch bit-equal to '
            f'the source model ({out["serving"]["valid"]} valid detections), '
            f'launches {json.dumps(serving)}')
        del source
        # (b) one fused_bn step from the imported weights
        n_bn = sum(isinstance(m, BatchNorm) for m in imported.model.modules())
        batch = train_batch(np.random.RandomState(SEED + 23))
        zero_launches()
        metrics = imported.trainer.train_step(*batch)
        torch.cuda.synchronize()
        step = read_launches()
        loss = metrics['loss'].item()
        if not math.isfinite(loss) or step['nms_keep_batched'] or any(
                step[fn.__name__] != n_bn for fn in bn_kernel.KERNELS):
            fail(f'the step from the imported weights: loss {loss}, launches '
                 f'{step}, expected {n_bn} of each BN kernel')
        out['train_step'] = {'loss': loss, 'launches': step, 'n_bn': n_bn}
        log(f'  (b) one b32 fused_bn step from them: loss {loss:.6f}, '
            f'launches {json.dumps(step)} ({n_bn} BNs)')
        del imported, metrics
        torch.cuda.empty_cache()
        # (c) the committed JAX run -> export_torch_ckpt -> torch_weight -> CLI
        exported = os.path.join(work, 'jax_run.pt')
        t_tool = time.perf_counter()
        export_torch_ckpt.main(['--config', f'{JAX_RUN}/config.py',
                                '--checkpoint', JAX_RUN, '--output', exported])
        tool_s = time.perf_counter() - t_tool
        config = Path(work) / 'jax_run_torch_weight.py'
        config.write_text((REPO / JAX_RUN / 'config.py').read_text()
                          + '\n# chip_smoke.py phase 22: the run as the '
                          'reference\'s checkpoint\n'
                          + f"model['detector']['torch_weight'] = {exported!r}\n")
        zero_launches()
        _, metrics = cli.main(['--config', str(config), '--phases', 'eval'])
        cli_launches = read_launches()
        if (metrics['loss'] != jax_card_metrics['loss']
                or metrics['mAP'] != jax_card_metrics['mAP']
                or cli_launches['nms_keep_batched'] < 1):
            fail(f'the exported JAX run evaluated through torch_weight: loss '
                 f'{metrics["loss"]!r} mAP {metrics["mAP"]!r}, launches '
                 f'{cli_launches}; phase 11 loss {jax_card_metrics["loss"]!r} '
                 f'mAP {jax_card_metrics["mAP"]!r}')
        out['jax_run'] = {'tool_s': tool_s, 'loss': metrics['loss'],
                          'mAP': metrics['mAP'], 'launches': cli_launches}
        log(f'  (c) {JAX_RUN} through tools/export_torch_ckpt.py ({tool_s:.2f} s) '
            f'and torch_weight, the CLI\'s eval: loss {metrics["loss"]!r} mAP '
            f'{metrics["mAP"]!r}, equal to phase 11\'s; launches '
            f'{json.dumps(cli_launches)}')
        # (d) a torchhub:// backbone from a temporary hub cache
        hub = Path(work) / 'hub'
        (hub / 'checkpoints').mkdir(parents=True)
        mapping = torch_import.mobilenet_v2_mapping()
        g = torch.Generator().manual_seed(SEED + 24)
        template = builder.from_config(load_config(FLAGSHIP), None,
                                       SEED).module.state_dict()
        written = torch_import.export_state_dict(
            {k: torch.rand(v.shape, generator=g) + 0.5 if v.is_floating_point()
             else v for k, v in template.items()},
            mapping, ('features', 'base'))
        torch.save(written, hub / 'checkpoints' / 'mobilenet_v2-seeded.pth')
        exp = interop_experiment({'base': {**flagship_model['base'],
                                           'name': HUB_MODEL,
                                           'hub_dir': str(hub)}})
        got = torch_import.export_state_dict(exp.model.state_dict(), mapping,
                                             ('features', 'base'))
        out['torchhub'] = {'tensors': states_equal(got, written,
                                                   'torchhub backbone')}
        log(f'  (d) {HUB_MODEL} from a temporary hub cache: '
            f'{out["torchhub"]["tensors"]} backbone tensors bit-equal to the '
            'file written')
        del exp
        # (e) RetinaNet-500 with bilinear necks, the card against the CPU
        cfg = load_config(RETINA)
        cfg.config.model['detector']['features']['interpolation_mode'] = 'bilinear'
        model = builder.from_config(cfg, None, SEED).module
        perturb_bn(model, torch.Generator().manual_seed(SEED + 25))
        model = model.cuda().eval()
        x = torch.randn(2, 3, 500, 500,
                        generator=torch.Generator().manual_seed(SEED + 26)).cuda()
        out['bilinear_retina'] = {
            'forward_vs_cpu': forward_vs_cpu(model, x, 'bilinear RetinaNet-500'),
            'mode': model.features.interpolation_mode}
        log(f'  (e) {RETINA} with interpolation_mode=bilinear, b2 eval '
            f'forward on the card against the CPU: heads and sources within '
            f'{out["bilinear_retina"]["forward_vs_cpu"]:.3g} of their largest '
            f'value (tol {ZOO_FORWARD_RTOL})')
        del model, x
        # (f) a keras .h5 backbone
        out['keras'] = keras_h5_check(work, template)
        log('  (f) ' + (f'keras .h5 (h5py {out["keras"]["h5py"]}): '
                        f'{out["keras"]["tensors"]} backbone tensors imported '
                        'bit-equal to the file\'s, in the port\'s layout'
                        if out['keras'] else
                        'keras .h5: h5py does not import on this machine, '
                        'not run'))
        out['seconds'] = time.perf_counter() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 23

DP_RANKS = 2
DP_BATCH = 16  # per rank; the one-process reference takes the global 32
DP_TIMED_STEPS = 5
DP_COLLECTIVE_TIMEOUT_S = 120
DP_WALL_S = 300
# Phase 23 (a): each parameter's update against the one-process step's, as
# a share of the step's largest update (the backward through 64 BNs
# amplifies the reduction order of the ranks' partial sums and cuDNN's own
# order; 2.3 % on the CPU, tests/test_torch_port_distributed.py), and the
# running statistics, direct reductions over the global batch
DP_UPDATE_TOL = 5e-2
DP_STATS_RTOL = 1e-3
DP_STATS_ATOL = 1e-4
DP_EXPERIMENT_STEPS = 2
DP_TOP_OPS = 6


def dp_trainer(device, rank: int, count: int, zero: bool = False) -> Trainer:
    """The flagship as shipped (its augmentation, SGD with momentum),
    seeded weights, rank ``rank`` of ``count``."""
    return Trainer.from_config(FLAGSHIP, device=device, seed=SEED, overrides={
        'train': {'zero_sharding': zero}}, process_count=count,
        process_index=rank)


def dp_batch():
    """Phase 23's global b32 batch."""
    return train_batch(np.random.RandomState(SEED + 23), b=DP_RANKS * DP_BATCH)


def cpu_state(model: torch.nn.Module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def optimizer_bytes(trainer: Trainer) -> int:
    return sum(t.numel() * t.element_size()
               for state in trainer.state.optimizer.state.values()
               for t in state.values() if isinstance(t, torch.Tensor))


def wall_ms(fn, iters: int) -> float:
    """Median wall ms of ``fn`` (synchronized) over ``iters`` calls after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dp_worker(rank: int, port: int, backend: str, out: str) -> int:
    """One rank of phase 23; writes its results to ``out/rank{rank}.pt``."""
    from single_shot_detection_tpu_torch import parallel
    device = parallel.initialize_distributed(
        f'127.0.0.1:{port}', DP_RANKS, rank,
        device=f'cuda:{rank % torch.cuda.device_count()}', backend=backend,
        timeout=DP_COLLECTIVE_TIMEOUT_S)
    try:
        for module in (nms_kernel, bn_kernel):
            module.build()  # the parent's builds, found by their hash
        images, boxes, mask = dp_batch()
        own = slice(rank * DP_BATCH, (rank + 1) * DP_BATCH)
        batch = (images[own], boxes[own], mask[own])
        result = {'device': str(device), 'backend': backend}

        # (a) and (d): the 2-rank step, then its times
        trainer = dp_trainer(device, rank, DP_RANKS)
        metrics = trainer.train_step(*batch, step=0)
        result['a'] = {'metrics': {k: v.item() for k, v in metrics.items()},
                       'state': cpu_state(trainer.model)}
        result['d'] = {'step_ms': wall_ms(lambda: trainer.train_step(*batch),
                                          DP_TIMED_STEPS),
                       'profile': dp_step_profile(trainer, batch)}
        # timing only: the same step with each rank's own BN statistics
        # (PyTorch's batch norm), the synchronised BN's cost end to end
        set_sync_bn(trainer.model, False)
        result['d']['own_bn_step_ms'] = wall_ms(
            lambda: trainer.train_step(*batch), DP_TIMED_STEPS)
        set_sync_bn(trainer.model, True)
        params = list(trainer.model.parameters())
        result['d']['all_reduce_ms'] = wall_ms(
            lambda: parallel.all_reduce_grads(params), DP_TIMED_STEPS)
        result['d']['grad_bytes'] = sum(p.numel() * 4 for p in params)
        del trainer
        result['d'].update(bn_forward_backward_ms(device))

        # (c): ZeRO-1 against the plain step, cuDNN deterministic
        torch.backends.cudnn.deterministic = True
        try:
            runs = {}
            for key, zero in (('plain', False), ('zero', True)):
                t = dp_trainer(device, rank, DP_RANKS, zero=zero)
                m = t.train_step(*batch, step=0)
                runs[key] = {'metrics': {k: v.item() for k, v in m.items()},
                             'state': cpu_state(t.model),
                             'optimizer_bytes': optimizer_bytes(t),
                             'sliced': (sum(a is not None for a in
                                            t.state.zero.axes.values())
                                        if t.state.zero else 0)}
                del t
        finally:
            torch.backends.cudnn.deterministic = False
        result['c'] = runs

        # (b): Experiment on the JPEG fixtures, NMS counted on this rank
        exp = Experiment(FLAGSHIP, phases=('train', 'eval'), device=device,
                         seed=SEED, process_count=DP_RANKS, process_index=rank,
                         overrides={'dataset': extras_dataset(), 'train': {
                             'epochs': 1, 'eval_every': 1,
                             'num_batches_per_epoch': DP_EXPERIMENT_STEPS}})
        nms_kernel.nms_keep_batched.launches = 0
        t0 = time.perf_counter()
        rows = exp.train()
        torch.cuda.synchronize()
        result['b'] = {'rows': rows, 's': time.perf_counter() - t0,
                       'nms_launches': nms_kernel.nms_keep_batched.launches,
                       'eval_batches': len(exp.loaders['eval']),
                       'train_batch': exp.loaders['train'].batch_size}
        torch.save(result, os.path.join(out, f'rank{rank}.pt'))
    finally:
        parallel.destroy()
    return 0


def dp_step_profile(trainer: Trainer, batch) -> dict:
    """One profiled train step (after a warm-up one): its host ms under
    the profiler, the device's busy ms outside NCCL's kernels and NCCL's
    kernels' ms (which include waiting for the other rank), their idle
    share, the host's operator calls and device launches, and the largest
    host operators by self time."""
    def step():
        trainer.train_step(*batch)
        torch.cuda.synchronize()

    prof = profile_window(step)
    events = averages(prof)
    wall_us = sum(e.cpu_time_total for e in events
                  if e.key.startswith('ProfilerStep'))
    nccl = [e for e in events if 'nccl' in e.key.lower()
            and e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)]
    nccl_us = sum(e.self_device_time_total for e in nccl)
    busy = busy_us(prof) - nccl_us
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
            and not e.key.startswith('ProfilerStep')]
    top = sorted(host, key=lambda e: -e.self_cpu_time_total)[:DP_TOP_OPS]
    return {'wall_ms': wall_us / 1e3, 'busy_ms': busy / 1e3,
            'nccl_ms': nccl_us / 1e3, 'nccl_launches': sum(e.count for e in nccl),
            'idle_share': 1.0 - busy / wall_us if wall_us else None,
            'aten_calls': sum(e.count for e in host if e.key.startswith('aten::')),
            'launches': busy_launches(prof),
            'top_host_ms': {e.key: [e.self_cpu_time_total / 1e3, e.count]
                            for e in top}}


def profile_line(p: dict) -> str:
    return (f'{p["wall_ms"]:.2f} ms on the host under the profiler, device '
            f'busy {p["busy_ms"]:.2f} ms outside NCCL (idle '
            f'{p["idle_share"]:.1%}), NCCL kernels {p["nccl_ms"]:.2f} ms in '
            f'{p["nccl_launches"]} launches; {p["aten_calls"]} aten calls, '
            f'{p["launches"]} device launches; largest host self times: '
            + ', '.join(f'{k} {ms:.2f} ms x{n}'
                        for k, (ms, n) in p['top_host_ms'].items()))


def bn_forward_backward_ms(device) -> dict:
    """A train-mode BN's forward and backward at the flagship's largest BN
    input of a b16 rank: the synchronised one (its two all-reduces
    included) against PyTorch's batch norm on this rank alone."""
    from single_shot_detection_tpu_torch.models.layers import SyncBatchNormFunction
    shape = (DP_BATCH, 96, 150, 150)
    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(shape, device=device, generator=g).requires_grad_()
    dz = torch.randn(shape, device=device, generator=g)
    w = torch.ones(shape[1], device=device, requires_grad=True)
    b = torch.zeros(shape[1], device=device, requires_grad=True)

    def synced():
        z, _, _ = SyncBatchNormFunction.apply(x, w, b, 1e-5)
        torch.autograd.backward(z, dz)

    def alone():
        z, _, _ = torch.native_batch_norm(x, w, b, None, None, True, 0.0, 1e-5)
        torch.autograd.backward(z, dz)

    return {'bn_shape': list(shape), 'sync_bn_ms': cuda_ms(synced, 10),
            'native_bn_ms': cuda_ms(alone, 10)}


def start_dp_ranks(work: str, backend: str):
    """Start phase 23's rank processes; returns them with their logs."""
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    for rank in range(DP_RANKS):
        logs.append(os.path.join(work, f'rank{rank}.log'))
        with open(logs[-1], 'w') as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / 'chip_smoke.py'), '--dp-worker',
                 str(rank), str(port), backend, work], stdout=log,
                stderr=subprocess.STDOUT, cwd=str(REPO)))
    return procs, logs


def wait_dp_ranks(procs, logs) -> None:
    """Wait for every rank under ``DP_WALL_S``; kill them all and fail on a
    rank's failure or on the limit, with its log."""
    deadline = time.monotonic() + DP_WALL_S
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            log(f'--- phase 23 rank {r} (exit {procs[r].returncode}):\n'
                + open(logs[r]).read()[-8000:])
        fail(f'phase 23: ranks {bad} failed or passed {DP_WALL_S} s')


def dp_compare(got: dict, want: dict, before: dict,
               label: str = 'phase 23 (a)') -> dict:
    """Phase 23 (a): the 2-rank step against the one-process one (and
    phase 24's steps, ``label`` naming them)."""
    loss_rel = abs(got['metrics']['loss'] - want['metrics']['loss']) / abs(
        want['metrics']['loss'])
    if not loss_rel <= 1e-4:
        fail(f'{label}: loss {got["metrics"]["loss"]} against '
             f'{want["metrics"]["loss"]} (rel {loss_rel:.3g} > 1e-4)')
    updates = {k: want['state'][k] - before[k] for k in want['state']
               if k.endswith(('weight', 'bias'))}
    largest = max(u.abs().max().item() for u in updates.values())
    update_err = max((got['state'][k] - before[k] - u).abs().max().item()
                     for k, u in updates.items())
    if not update_err <= DP_UPDATE_TOL * largest:
        fail(f'{label}: an update is {update_err:.3g} off the '
             f'one-process step\'s, over {DP_UPDATE_TOL} x {largest:.3g}')
    stats_err = 0.0
    for k in want['state']:
        if k.endswith(('running_mean', 'running_var')):
            g, w = got['state'][k], want['state'][k]
            excess = ((g - w).abs() - DP_STATS_ATOL - DP_STATS_RTOL * w.abs())
            if excess.max().item() > 0:
                fail(f'{label}: {k} off the one-process step\'s '
                     f'beyond rtol {DP_STATS_RTOL}, atol {DP_STATS_ATOL}')
            stats_err = max(stats_err, (g - w).abs().max().item())
    return {'loss_rel_err': loss_rel, 'largest_update': largest,
            'update_max_abs_err': update_err,
            'running_stats_max_abs_err': stats_err}


def run_multi_gpu(smi: str) -> dict:
    """Phase 23: the data-parallel path on two rank processes."""
    cards = torch.cuda.device_count()
    backend = 'nccl' if cards >= DP_RANKS else 'gloo'
    mode = (f'NCCL, ranks on cuda:0 and cuda:1' if backend == 'nccl' else
            'gloo, both ranks on cuda:0 (one card: NCCL refuses two ranks '
            'on one card)')
    log(f'[23] {smi}: 2 rank processes over {mode}; the flagship at 300 px, '
        f'seeded weights, b{DP_BATCH} a rank')
    work = tempfile.mkdtemp(prefix='chip_smoke_dp_')
    try:
        wait_dp_ranks(*start_dp_ranks(work, backend))
        ranks = [torch.load(os.path.join(work, f'rank{r}.pt'),
                            weights_only=False) for r in range(DP_RANKS)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # then, alone on the card: the one-process step on the global batch,
    # and the one-process step times at b16 and b32
    images, boxes, mask = dp_batch()
    single = dp_trainer('cuda', 0, 1)
    before = cpu_state(single.model)
    metrics = single.train_step(images, boxes, mask, step=0)
    want = {'metrics': {k: v.item() for k, v in metrics.items()},
            'state': cpu_state(single.model)}
    timing = {
        'one_b32_step_ms': wall_ms(
            lambda: single.train_step(images, boxes, mask), DP_TIMED_STEPS),
        'one_b16_step_ms': wall_ms(
            lambda: single.train_step(images[:DP_BATCH], boxes[:DP_BATCH],
                                      mask[:DP_BATCH]), DP_TIMED_STEPS),
        'one_b16_profile': dp_step_profile(
            single, (images[:DP_BATCH], boxes[:DP_BATCH], mask[:DP_BATCH]))}
    del single
    torch.cuda.empty_cache()

    # (a)
    for r in range(1, DP_RANKS):
        if ranks[r]['a']['metrics'] != ranks[0]['a']['metrics'] or any(
                not torch.equal(v, ranks[0]['a']['state'][k])
                for k, v in ranks[r]['a']['state'].items()):
            fail(f'phase 23 (a): rank {r}\'s state differs from rank 0\'s')
    step = dp_compare(ranks[0]['a'], want, before)
    log(f'  (a) 2 x b{DP_BATCH} step against 1 x b{DP_RANKS * DP_BATCH}: '
        f'loss {ranks[0]["a"]["metrics"]["loss"]:.6f} against '
        f'{want["metrics"]["loss"]:.6f} (rel {step["loss_rel_err"]:.3g}); '
        f'updates within {step["update_max_abs_err"]:.3g} of the largest '
        f'{step["largest_update"]:.3g}; running statistics within '
        f'{step["running_stats_max_abs_err"]:.3g}; the ranks bit-equal')
    # (b)
    rows = [r['b']['rows'][-1] for r in ranks]
    launches = [r['b']['nms_launches'] for r in ranks]
    if any(n <= 0 for n in launches):
        fail(f'phase 23 (b): NMS launches per rank {launches}')
    for key in ('train_loss', 'eval_loss', 'eval_mAP'):
        if any(row[key] != rows[0][key] for row in rows):
            fail(f'phase 23 (b): the ranks disagree on {key}: '
                 f'{[row[key] for row in rows]}')
        if not np.isfinite(rows[0][key]):
            fail(f'phase 23 (b): {key} {rows[0][key]}')
    if not 0.0 <= rows[0]['eval_mAP'] <= 1.0:
        fail(f'phase 23 (b): mAP {rows[0]["eval_mAP"]}')
    log(f'  (b) Experiment(process_count=2) on the JPEG fixtures: '
        f'{DP_EXPERIMENT_STEPS} steps of 2 x b{ranks[0]["b"]["train_batch"]} '
        f'and an evaluation ({ranks[0]["b"]["eval_batches"]} batch a rank) in '
        f'{max(r["b"]["s"] for r in ranks):.2f} s; NMS launches per rank '
        f'{launches}; both ranks: ' + json.dumps(rows[0]))
    # (c)
    zero_bytes = []
    for r, result in enumerate(ranks):
        plain, zero = result['c']['plain'], result['c']['zero']
        diff = max((zero['state'][k] - v).abs().max().item()
                   for k, v in plain['state'].items())
        if zero['metrics'] != plain['metrics'] or diff != 0.0:
            fail(f'phase 23 (c): rank {r}: the ZeRO-1 step is {diff:.3g} off '
                 'the plain one')
        zero_bytes.append(zero['optimizer_bytes'])
    plain_bytes = ranks[0]['c']['plain']['optimizer_bytes']
    log(f'  (c) ZeRO-1: the step bit-equal to the plain 2-rank step '
        f'(cuDNN deterministic); {ranks[0]["c"]["zero"]["sliced"]} leaves '
        f'sliced; optimizer bytes per rank {zero_bytes} against '
        f'{plain_bytes} plain')
    # (d)
    two = [r['d'] for r in ranks]
    step_ms = max(d['step_ms'] for d in two)
    reduce_ms = max(d['all_reduce_ms'] for d in two)
    timing.update({'two_rank_step_ms': step_ms, 'all_reduce_ms': reduce_ms,
                   'all_reduce_share': reduce_ms / step_ms,
                   'grad_bytes': two[0]['grad_bytes'], 'backend': backend})
    log(f'  (d) {smi}: step wall ms (median of {DP_TIMED_STEPS}): 2 ranks x '
        f'b{DP_BATCH} {step_ms:.2f} (slower rank), 1 process b32 '
        f'{timing["one_b32_step_ms"]:.2f}, b16 {timing["one_b16_step_ms"]:.2f}; '
        f'the gradient all-reduce ({timing["grad_bytes"]} bytes, {backend}) '
        f'{reduce_ms:.2f} ms = {timing["all_reduce_share"]:.1%} of the step; '
        f'one BN forward and backward at {two[0]["bn_shape"]}: synchronised '
        f'{max(d["sync_bn_ms"] for d in two):.3f} ms (its all-reduces in), '
        f'PyTorch\'s batch norm alone {max(d["native_bn_ms"] for d in two):.3f}')
    timing.update({key: max(d[key] for d in two)
                   for key in ('sync_bn_ms', 'native_bn_ms', 'own_bn_step_ms')})
    timing['two_rank_profiles'] = [d['profile'] for d in two]
    log(f'      the same 2-rank step with each rank\'s own BN statistics '
        f'(timing only): {timing["own_bn_step_ms"]:.2f} ms')
    for r, d in enumerate(two):
        log(f'      profiled 2-rank step, rank {r}: '
            + profile_line(d['profile']))
    log(f'      profiled 1-process b{DP_BATCH} step: '
        + profile_line(timing['one_b16_profile']))
    return {'mode': mode, 'a': step, 'b': {'rows': rows, 'nms_launches': launches},
            'c': {'optimizer_bytes_per_rank': zero_bytes,
                  'plain_optimizer_bytes': plain_bytes},
            'd': timing}


# --------------------------------------------------------------- phase 24

MA_BATCH = 32  # one model group's batch, the flagship's
MA_TIMED_STEPS = 3
MA_WALL_S = 420
MA_COLLECTIVE_TIMEOUT_S = 180
MA_EXPERIMENT_STEPS = 1
# the options of the 2-rank group, as train overrides
MA_OPTIONS = {
    'tensor': {'tensor_sharding': 2},
    'pipeline': {'pipeline_sharding': {'microbatches': 4, 'stages': 2},
                 'frozen_bn': True},
    'spatial': {'spatial_sharding': 2},
}
# M2Det-512 at full width, 4 stages in 4 ranks, b4 in 2 microbatches
MA_M2DET_RANKS = 4
MA_M2DET_BATCH = 4
MA_M2DET_TRAIN = {'pipeline_sharding': {'microbatches': 2, 'stages': 4},
                  'frozen_bn': True}
# Tolerances against the one-process runs on the card: the step's loss
# rel 1e-4, each update within DP_UPDATE_TOL of the largest and the BN
# statistics within DP_STATS_RTOL/ATOL (phase 23's: the backward through
# the BNs amplifies the reduction order, here of a channel's or a row
# block's partial sums and cuDNN's own); a pipelined forward within
# ZOO_FORWARD_RTOL of its largest output; an Experiment's one step: its
# train loss rel 1e-4 (the step's own), its evaluation's loss rel
# MA_EVAL_RTOL and mAP within MA_MAP_ATOL (the weights after a step whose
# updates sit up to ~1 % of the largest update apart; a 2-step epoch's
# mean train loss was 2.0e-3 apart under tensor sharding, rel, on the card)
MA_EVAL_RTOL = 1e-3
MA_MAP_ATOL = 1e-2


def ma_trainer(device, rank: int, count: int, train: dict,
               config: str = FLAGSHIP) -> Trainer:
    """``config`` as shipped with ``train`` overrides, seeded weights,
    rank ``rank`` of ``count``."""
    return Trainer.from_config(config, device=device, seed=SEED,
                               overrides={'train': train},
                               process_count=count, process_index=rank)


def ma_batch(b: int = MA_BATCH, size: int = 300):
    """Phase 24's batch: one model group's, every rank's."""
    return train_batch(np.random.RandomState(SEED + 24), b=b, size=size)


def whole_cpu_state(trainer: Trainer) -> dict:
    """The model's state on the CPU, tensor-sharded entries gathered."""
    from single_shot_detection_tpu_torch.parallel import tensor
    return {k: v.cpu().clone() for k, v in tensor.gather_leaves(
        trainer.model.state_dict(), trainer.state.tensor or {}).items()}


def reset_moved() -> None:
    from single_shot_detection_tpu_torch.parallel import pipeline, spatial, tensor
    for stats in (tensor.STATS, pipeline.STATS, spatial.STATS):
        for key in stats:
            stats[key] = 0


def read_moved() -> dict:
    from single_shot_detection_tpu_torch.parallel import pipeline, spatial, tensor
    return {'tensor': dict(tensor.STATS), 'pipeline': dict(pipeline.STATS),
            'spatial': dict(spatial.STATS)}


def ma_experiment(device, rank: int, count: int, train: dict) -> Experiment:
    return Experiment(FLAGSHIP, phases=('train', 'eval'), device=device,
                      seed=SEED, process_count=count, process_index=rank,
                      overrides={'dataset': extras_dataset(), 'train': {
                          'epochs': 1, 'eval_every': 1,
                          'num_batches_per_epoch': MA_EXPERIMENT_STEPS,
                          **train}})


def ma_run_experiment(exp: Experiment) -> dict:
    zero_launches()
    t0 = time.perf_counter()
    rows = exp.train()
    torch.cuda.synchronize()
    return {'rows': rows, 's': time.perf_counter() - t0,
            'launches': read_launches()}


def ma_worker(group: str, rank: int, count: int, port: int, backend: str,
              out: str) -> int:
    """One rank of phase 24's ``group`` (``'two'``: the three options on
    the flagship; ``'four'``: M2Det's 4 stages) or of phase 25
    (``'phases'``); writes its results to ``out/{group}{rank}.pt``."""
    from single_shot_detection_tpu_torch import parallel
    from single_shot_detection_tpu_torch.parallel import pipeline, spatial
    device = parallel.initialize_distributed(
        f'127.0.0.1:{port}', count, rank,
        device=f'cuda:{rank % torch.cuda.device_count()}', backend=backend,
        timeout=MA_COLLECTIVE_TIMEOUT_S)
    torch.backends.cudnn.deterministic = True
    try:
        for module in (nms_kernel, bn_kernel):
            module.build()  # the parent's builds, found by their hash
        result = {'device': str(device), 'backend': backend}
        if group == 'phases':
            for key in ('DISPLAY', 'WAYLAND_DISPLAY'):  # headless frames
                os.environ.pop(key, None)
            result.update(mp_worker(rank, count, device, out))
            torch.save(result, os.path.join(out, f'{group}{rank}.pt'))
            return 0
        if group == 'four':
            trainer = ma_trainer(device, rank, count, MA_M2DET_TRAIN, M2DET)
            x = torch.randn((MA_M2DET_BATCH, 3, 512, 512), generator=torch
                            .Generator().manual_seed(SEED)).to(device)
            trainer.model.eval()
            scores, locs, _ = pipeline.pipeline_apply(trainer.model, x, 2)
            result['forward'] = (scores.detach().cpu(), locs.detach().cpu())
            batch = ma_batch(MA_M2DET_BATCH, 512)
            reset_moved()
            metrics = trainer.train_step(*batch, step=0)
            result['moved'] = read_moved()
            result['step'] = {'metrics': {k: v.item() for k, v in
                                          metrics.items()},
                              'state': whole_cpu_state(trainer)}
            result['step_ms'] = wall_ms(lambda: trainer.train_step(*batch),
                                        MA_TIMED_STEPS)
            torch.save(result, os.path.join(out, f'{group}{rank}.pt'))
            return 0
        batch = ma_batch()
        for key, train in MA_OPTIONS.items():
            trainer = ma_trainer(device, rank, count, train)
            reset_moved()
            metrics = trainer.train_step(*batch, step=0)
            moved = read_moved()
            axes = trainer.state.tensor or {}
            state = whole_cpu_state(trainer)
            full = {k: v.shape for k, v in state.items()}
            result[key] = {
                'metrics': {k: v.item() for k, v in metrics.items()},
                'state': state, 'moved': moved,
                'param_bytes': sum(p.numel() * p.element_size()
                                   for p in trainer.model.parameters()),
                'sliced': sum(v.shape != full[k] for k, v in
                              trainer.model.state_dict().items()),
                'rule_sliced': sum(a is not None for a in axes.values()),
                'replicated': sorted(k for k in full if axes.get(k) is None),
                'step_ms': wall_ms(lambda: trainer.train_step(*batch),
                                   MA_TIMED_STEPS)}
            del trainer
            torch.cuda.empty_cache()
        for key, train in MA_OPTIONS.items():
            exp = ma_experiment(device, rank, count, train)
            result[f'experiment_{key}'] = ma_run_experiment(exp)
            del exp
        torch.save(result, os.path.join(out, f'{group}{rank}.pt'))
    finally:
        torch.backends.cudnn.deterministic = False
        parallel.destroy()
    return 0


def start_ma_ranks(work: str, group: str, count: int, backend: str):
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    for rank in range(count):
        logs.append(os.path.join(work, f'{group}{rank}.log'))
        with open(logs[-1], 'w') as log_file:
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / 'chip_smoke.py'), '--ma-worker',
                 group, str(rank), str(count), str(port), backend, work],
                stdout=log_file, stderr=subprocess.STDOUT, cwd=str(REPO)))
    return procs, logs


def wait_ma_ranks(procs, logs, phase: int = 24) -> None:
    """Wait for every rank under ``MA_WALL_S``; kill them all and fail on a
    rank's failure or on the limit, with its log."""
    deadline = time.monotonic() + MA_WALL_S
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            log(f'--- phase {phase} rank {r} (exit {procs[r].returncode}):\n'
                + open(logs[r]).read()[-8000:])
        fail(f'phase {phase}: ranks {bad} failed or passed {MA_WALL_S} s')


def ma_ranks(group: str, count: int, backend: str) -> list:
    work = tempfile.mkdtemp(prefix=f'chip_smoke_ma_{group}_')
    try:
        wait_ma_ranks(*start_ma_ranks(work, group, count, backend))
        return [torch.load(os.path.join(work, f'{group}{r}.pt'),
                           weights_only=False) for r in range(count)]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def ma_ranks_equal(ranks: list, key: Optional[str], label: str) -> None:
    get = (lambda r: r[key]) if key else (lambda r: r['step'])
    for r in range(1, len(ranks)):
        a, b = get(ranks[0]), get(ranks[r])
        if a['metrics'] != b['metrics'] or any(
                not torch.equal(v, a['state'][k]) for k, v in b['state'].items()):
            fail(f'phase 24 {label}: rank {r}\'s state differs from rank 0\'s')


def ma_one_process(train: dict, batch, config: str = FLAGSHIP) -> dict:
    """The one-process step on the same batch, and its wall ms."""
    trainer = ma_trainer('cuda', 0, 1, train, config)
    before = cpu_state(trainer.model)
    metrics = trainer.train_step(*batch, step=0)
    out = {'before': before,
           'want': {'metrics': {k: v.item() for k, v in metrics.items()},
                    'state': cpu_state(trainer.model)},
           'step_ms': wall_ms(lambda: trainer.train_step(*batch),
                              MA_TIMED_STEPS)}
    del trainer
    torch.cuda.empty_cache()
    return out


def ma_experiment_check(ranks: list, key: str, want: dict) -> dict:
    rows = [r[f'experiment_{key}']['rows'][-1] for r in ranks]
    launches = [r[f'experiment_{key}']['launches'] for r in ranks]
    nms = [n['nms_keep_batched'] for n in launches]
    if any(n <= 0 for n in nms):
        fail(f'phase 24 (d) {key}: NMS launches per rank {nms}')
    one = want['rows'][-1]
    log(f'  (d) {key}: ranks {json.dumps(rows)}; one process '
        f'{json.dumps(one)}')
    for k in ('train_loss', 'eval_loss', 'eval_mAP'):
        if any(row[k] != rows[0][k] for row in rows):
            fail(f'phase 24 (d) {key}: the ranks disagree on {k}: '
                 f'{[row[k] for row in rows]}')
        if not np.isfinite(rows[0][k]):
            fail(f'phase 24 (d) {key}: {k} {rows[0][k]}')
    for k, tol in (('train_loss', 1e-4), ('eval_loss', MA_EVAL_RTOL)):
        rel = abs(rows[0][k] - one[k]) / abs(one[k])
        if not rel <= tol:
            fail(f'phase 24 (d) {key}: {k} {rows[0][k]} against one '
                 f'process\'s {one[k]} (rel {rel:.3g} > {tol})')
    if not abs(rows[0]['eval_mAP'] - one['eval_mAP']) <= MA_MAP_ATOL:
        fail(f'phase 24 (d) {key}: mAP {rows[0]["eval_mAP"]} against '
             f'{one["eval_mAP"]}')
    return {'rows': rows[0], 'one_process': one, 'nms_launches': nms,
            'bn_launches': [{k: v for k, v in n.items()
                             if k != 'nms_keep_batched'} for n in launches],
            's': max(r[f'experiment_{key}']['s'] for r in ranks)}


def moved_bytes(key: str, moved: dict) -> dict:
    if key == 'tensor':
        return dict(moved['tensor'])
    if key == 'pipeline':
        return {'boundary_bytes': moved['pipeline']['sent_bytes'],
                'boundary_floats': moved['pipeline']['boundary_floats']}
    return {'halo_bytes': moved['spatial']['halo_bytes'],
            'halo_rows': moved['spatial']['rows_received'],
            'max_extra_rows': moved['spatial']['max_extra_rows'],
            'largest_whole_map': moved['spatial']['largest_whole']}


def run_model_axis(smi: str) -> dict:
    """Phase 24: tensor, pipeline and spatial sharding in rank processes."""
    cards = torch.cuda.device_count()
    backend = 'nccl' if cards >= MA_M2DET_RANKS else 'gloo'
    mode = (f'NCCL, a card a rank' if backend == 'nccl' else
            f'gloo, every rank on the one card ({cards} card(s); NCCL '
            'refuses two ranks on one card)')
    log(f'[24] {smi}: the model axis in rank processes over {mode}; the '
        f'flagship at 300 px, seeded weights, b{MA_BATCH} a model group')
    two = ma_ranks('two', 2, backend)
    four = ma_ranks('four', MA_M2DET_RANKS, backend)
    batch = ma_batch()
    plain = ma_one_process({}, batch)
    frozen = ma_one_process({'frozen_bn': True}, batch)
    reference = {'tensor': plain, 'spatial': plain, 'pipeline': frozen}
    out = {'mode': mode, 'backend': backend, 'options': {}}
    whole_bytes = sum(v.numel() * v.element_size()
                      for k, v in plain['before'].items()
                      if not k.endswith(('running_mean', 'running_var',
                                         'num_batches_tracked')))
    for key in MA_OPTIONS:
        ma_ranks_equal(two, key, f'({key})')
        ref = reference[key]
        step = dp_compare(two[0][key], ref['want'], ref['before'],
                          f'phase 24 ({key})')
        row = {**step, 'step_ms': max(r[key]['step_ms'] for r in two),
               'one_process_step_ms': ref['step_ms'],
               'param_bytes_per_rank': [r[key]['param_bytes'] for r in two],
               'one_process_param_bytes': whole_bytes,
               'moved_per_step': [moved_bytes(key, r[key]['moved'])
                                  for r in two]}
        if key == 'tensor':
            if two[0][key]['sliced'] != two[0][key]['rule_sliced']:
                fail(f'phase 24 (a): {two[0][key]["sliced"]} leaves sliced, '
                     f'JAX\'s rule gives {two[0][key]["rule_sliced"]}')
            row['sliced_leaves'] = two[0][key]['sliced']
            row['replicated_leaves'] = len(two[0][key]['replicated'])
        if key == 'spatial':
            for r in two:
                m = r[key]['moved']['spatial']
                if not (0 < m['max_extra_rows'] <= 2
                        and m['largest_whole'] <= 3):
                    fail(f'phase 24 (c): a window held {m["max_extra_rows"]} '
                         f'rows past its own, a map of '
                         f'{m["largest_whole"]} rows whole')
        out['options'][key] = row
        label = {'tensor': '(a)', 'pipeline': '(b)', 'spatial': '(c)'}[key]
        log(f'  {label} {key}: 2 ranks x b{MA_BATCH} against 1 process: loss '
            f'{two[0][key]["metrics"]["loss"]:.6f} against '
            f'{ref["want"]["metrics"]["loss"]:.6f} (rel '
            f'{step["loss_rel_err"]:.3g}); updates within '
            f'{step["update_max_abs_err"]:.3g} of the largest '
            f'{step["largest_update"]:.3g}; running statistics within '
            f'{step["running_stats_max_abs_err"]:.3g}; the ranks bit-equal; '
            f'parameter bytes a rank {row["param_bytes_per_rank"]} against '
            f'{whole_bytes}; moved a step (rank 0): '
            + json.dumps(row['moved_per_step'][0]))
    # (b) M2Det-512, 4 stages
    m2det_batch = ma_batch(MA_M2DET_BATCH, 512)
    single = ma_trainer('cuda', 0, 1, {'frozen_bn': True}, M2DET)
    x = torch.randn((MA_M2DET_BATCH, 3, 512, 512), generator=torch.Generator()
                    .manual_seed(SEED)).to('cuda')
    with torch.inference_mode():
        want_s, want_l = single.model.eval()(x)
    forward_err = 0.0
    for r in four:
        for got, want in zip(r['forward'], (want_s.cpu(), want_l.cpu())):
            rel = ((got - want).abs().max().item()
                   / max(want.abs().max().item(), 1e-30))
            if not rel <= ZOO_FORWARD_RTOL:
                fail(f'phase 24 (b): M2Det\'s pipelined forward on rank '
                     f'{four.index(r)} is {rel:.3g} of its largest output '
                     'off the one-process forward')
            forward_err = max(forward_err, rel)
    del single
    torch.cuda.empty_cache()
    m2det = ma_one_process({'frozen_bn': True}, m2det_batch, M2DET)
    ma_ranks_equal(four, None, '(b) M2Det')
    m2det_step = dp_compare(four[0]['step'], m2det['want'], m2det['before'],
                            'phase 24 (b) M2Det')
    out['m2det_4_stages'] = {
        **m2det_step, 'forward_max_rel_err': forward_err,
        'step_ms': max(r['step_ms'] for r in four),
        'one_process_step_ms': m2det['step_ms'],
        'moved_per_step': [moved_bytes('pipeline', r['moved']) for r in four]}
    log(f'  (b) M2Det-512, 4 stages in 4 ranks, b{MA_M2DET_BATCH} in 2 '
        f'microbatches: forward within {forward_err:.3g} of its largest '
        f'output; step loss rel {m2det_step["loss_rel_err"]:.3g}, updates '
        f'within {m2det_step["update_max_abs_err"]:.3g} of the largest '
        f'{m2det_step["largest_update"]:.3g}')
    # (d) Experiment with each option against one process
    ones = {}
    for label, train in (('plain', {}), ('frozen', {'frozen_bn': True})):
        exp = ma_experiment('cuda', 0, 1, train)
        ones[label] = ma_run_experiment(exp)
        del exp
        torch.cuda.empty_cache()
    out['experiments'] = {}
    for key in MA_OPTIONS:
        check = ma_experiment_check(
            two, key, ones['frozen' if key == 'pipeline' else 'plain'])
        out['experiments'][key] = check
        log(f'  (d) Experiment(process_count=2), {key}: '
            f'{MA_EXPERIMENT_STEPS} steps and an evaluation in '
            f'{check["s"]:.2f} s; NMS launches per rank '
            f'{check["nms_launches"]}; both ranks {json.dumps(check["rows"])}; '
            f'one process {json.dumps(check["one_process"])}')
    # (e) times
    for key, row in out['options'].items():
        log(f'  (e) {smi}: {key} step wall ms (median of {MA_TIMED_STEPS}, '
            f'slower rank) {row["step_ms"]:.2f} at 2 ranks against '
            f'{row["one_process_step_ms"]:.2f} in 1 process')
    m = out['m2det_4_stages']
    log(f'  (e) {smi}: M2Det-512 b{MA_M2DET_BATCH} 4-stage step '
        f'{m["step_ms"]:.2f} ms at 4 ranks against '
        f'{m["one_process_step_ms"]:.2f} in 1 process')
    return out


# --------------------------------------------------------------- phase 25

# Each option of phase 24 through the phases that serve one whole model:
# an Experiment of MA_EXPERIMENT_STEPS steps on the committed JPEG fixtures
# with train.pruner (MinL1Norm, 4 channels of the backbone and extras a
# prune) and int8 forced (the gate refuses MobileNet below b128), its
# export (standalone, int8, b32) and the test phase on MP_FRAMES frames
MP_PRUNER = {'criterion': {'name': 'MinL1Norm'}, 'num': 4,
             'include_paths': ['features', 'extra']}
MP_FRAMES = 3
# one process's train options beside each option's (pipeline: frozen BN)
MP_ONE_PROCESS = {'tensor': {}, 'spatial': {}, 'pipeline': {'frozen_bn': True}}


def mp_experiment(device, rank: int, count: int, train: dict,
                  **kwargs) -> Experiment:
    return Experiment(FLAGSHIP, phases=('train', 'eval'), device=device,
                      seed=SEED, int8=True, process_count=count,
                      process_index=rank, overrides={
                          'dataset': extras_dataset(), 'int8': {},
                          'train': {'epochs': 1, 'eval_every': 1,
                                    'num_batches_per_epoch':
                                        MA_EXPERIMENT_STEPS,
                                    'pruner': MP_PRUNER, **train}}, **kwargs)


def whole_mask(exp: Experiment) -> dict:
    """The pruning mask on the CPU, tensor-sharded entries gathered."""
    from single_shot_detection_tpu_torch.parallel import tensor
    return {k: v.cpu().clone() for k, v in tensor.gather_leaves(
        exp.trainer.state.mask, exp.trainer.state.tensor or {}).items()}


def mp_epoch(exp: Experiment) -> dict:
    """``exp``'s epoch (the prune at its start, its steps and the int8
    evaluation), the whole state and mask right after the prune, the
    state after the epoch, its counts and seconds."""
    pruned = {}
    prune = exp.pruner.prune

    def snapshot(state):
        prune(state)
        pruned.update(state=whole_cpu_state(exp.trainer),
                      mask=whole_mask(exp))
        return state
    exp.pruner.prune = snapshot
    out = ma_run_experiment(exp)
    out.update(pruned=pruned, after=whole_cpu_state(exp.trainer),
               dead={k: sorted(v) for k, v in exp.pruner.dead.items() if v},
               amax=exp._int8_amax)
    return out


def mp_export(exp: Experiment, path: str) -> Tuple[str, float]:
    from single_shot_detection_tpu_torch.export import export_model
    t = time.perf_counter()
    path = export_model(exp, path, with_postprocess=True, with_preprocess=True,
                        bake_variables=True, batch_size=MA_BATCH, int8=True)
    return path, time.perf_counter() - t


def mp_worker(rank: int, count: int, device, out: str) -> dict:
    """Phase 25 on one rank: each option's pruned int8 epoch, its export
    (process 0 writes) and the test phase (process 0 runs the frames
    after every rank has built the predictor)."""
    from single_shot_detection_tpu_torch.utils.video_viewer import VideoViewer
    result = {}
    for key, train in MA_OPTIONS.items():
        exp = mp_experiment(device, rank, count, train,
                            checkpoint_dir=os.path.join(out, f'ckpt_{key}'))
        row = mp_epoch(exp)
        row['path'], row['export_s'] = mp_export(
            exp, os.path.join(out, f'artifact_{key}_rank{rank}'))
        t = time.perf_counter()
        exp.predictor()  # every rank: the whole model and the calibration
        zero_launches()
        frames = 0
        if rank == 0:
            frames = VideoViewer(os.path.join(out, 'video'), exp, os.path.join(
                out, f'frames_{key}')).run()
        torch.cuda.synchronize()
        row.update(test_launches=read_launches(), frames=frames,
                   test_s=time.perf_counter() - t)
        result[key] = row
        del exp
        torch.cuda.empty_cache()
    return result


def mp_reference(key: str, dead: dict, directory: str):
    """One process from the sharded run's gathered checkpoint, with its
    dead set: the int8 artifact (the export phase's) and the amax."""
    exp = mp_experiment('cuda', 0, 1, MP_ONE_PROCESS[key],
                        resume_from=directory)
    exp.pruner.dead = {tuple(k): set(v) for k, v in dead.items()}
    exp.evaluate()  # the int8 calibration at the checkpoint's step
    path, _ = mp_export(exp, os.path.join(directory, 'one_process'))
    amax = exp._int8_amax
    del exp
    torch.cuda.empty_cache()
    return path, amax


def mp_check(key: str, ranks: list, one: dict, work: str) -> dict:
    """Phase 25's checks (a)-(d) of one option against one process."""
    from single_shot_detection_tpu_torch.export import load_exported
    got = [r[key] for r in ranks]
    label = f'phase 25 ({key})'
    # (a) the prune: every rank as one process, bit for bit
    for r, g in enumerate(got):
        if g['dead'] != one['dead']:
            fail(f'{label} (a): rank {r}\'s dead set {g["dead"]} against one '
                 f'process\'s {one["dead"]}')
        for part in ('state', 'mask'):
            a, b = g['pruned'][part], one['pruned'][part]
            if a.keys() != b.keys() or any(not torch.equal(v, b[k])
                                           for k, v in a.items()):
                fail(f'{label} (a): rank {r}\'s pruned {part} differs from '
                     'one process\'s')
        for name, m in g['pruned']['mask'].items():
            if g['after'][name][m.reshape(-1) == 0].any():
                fail(f'{label} (a): rank {r}: a dead entry of {name} moved')
        bn = {k: v for k, v in g['launches'].items() if k != 'nms_keep_batched'}
        if any(bn.values()) or any(g['test_launches'][k] for k in bn):
            fail(f'{label}: BN kernel launches {bn}')
    channels = sum(len(v) for v in one['dead'].values())
    # (b) the int8 evaluation
    rows = [g['rows'][-1] for g in got]
    want = one['rows'][-1]
    for k in ('eval_loss', 'eval_mAP', 'eval_int8'):
        if any(row[k] != rows[0][k] for row in rows):
            fail(f'{label} (b): the ranks disagree on {k}: '
                 f'{[row[k] for row in rows]}')
    if rows[0]['eval_int8'] != 1.0 or want['eval_int8'] != 1.0:
        fail(f'{label} (b): int8 {rows[0]["eval_int8"]}, one process '
             f'{want["eval_int8"]}')
    rel = abs(rows[0]['eval_loss'] - want['eval_loss']) / abs(want['eval_loss'])
    if not (rel <= MA_EVAL_RTOL and abs(rows[0]['eval_mAP'] - want['eval_mAP'])
            <= MA_MAP_ATOL):
        fail(f'{label} (b): loss {rows[0]["eval_loss"]} mAP '
             f'{rows[0]["eval_mAP"]} against one process\'s '
             f'{want["eval_loss"]} {want["eval_mAP"]}')
    nms = [g['launches']['nms_keep_batched'] for g in got]
    if nms != [one['launches']['nms_keep_batched']] * len(got) or not nms[0]:
        fail(f'{label} (b): NMS launches per rank {nms}, one process '
             f'{one["launches"]["nms_keep_batched"]}')
    # (c) process 0's artifact against one process's from the checkpoint
    if not os.path.exists(got[0]['path']) or any(
            os.path.exists(g['path']) for g in got[1:]):
        fail(f'{label} (c): the artifacts written: '
             f'{[os.path.exists(g["path"]) for g in got]}')
    t = time.perf_counter()
    ref_path, ref_amax = mp_reference(key, got[0]['dead'],
                                      os.path.join(work, f'ckpt_{key}'))
    ref_s = time.perf_counter() - t
    if ref_amax != got[0]['amax']:
        worst = max(abs(ref_amax[k] - v) / v for k, v in got[0]['amax'].items())
        fail(f'{label} (c): the int8 amax of one process from the checkpoint '
             f'differs, rel {worst:.3g}')
    x = torch.from_numpy(ma_batch()[0]).float().cuda()
    calls = [load_exported(p) for p in (got[0]['path'], ref_path)]
    outs = [c(x) for c in calls]
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        fail(f'{label} (c): process 0\'s artifact differs from one process\'s')
    per_call = artifact_launches(calls[0], x)['nms_keep_batched']
    if per_call != 1:
        fail(f'{label} (c): {per_call} NMS launches a call')
    # (d) the test phase
    tests = [g['test_launches']['nms_keep_batched'] for g in got]
    if tests != [MP_FRAMES] + [0] * (len(got) - 1) or got[0]['frames'] != MP_FRAMES:
        fail(f'{label} (d): NMS launches per rank {tests}, '
             f'{got[0]["frames"]} frames')
    return {'dead_channels': channels, 'rows': rows[0], 'one_process': want,
            'eval_nms_launches': nms, 'export_nms_launches_per_call': per_call,
            'test_nms_launches': tests,
            'detections': int(outs[0][1].sum()),
            # (e) seconds, the slower rank's
            'epoch_s': max(g['s'] for g in got), 'one_process_epoch_s': one['s'],
            'export_s': max(g['export_s'] for g in got),
            'test_s': max(g['test_s'] for g in got),
            'one_process_reference_s': ref_s}


def run_model_axis_phases(smi: str) -> dict:
    """Phase 25: the model axis's test and export phases, int8 evaluation
    and pruner, in rank processes, against one process."""
    cards = torch.cuda.device_count()
    backend = 'nccl' if cards >= 2 else 'gloo'
    mode = ('NCCL, a card a rank' if backend == 'nccl' else
            f'gloo, both ranks on the one card ({cards} card)')
    log(f'[25] {smi}: the model axis\'s test and export phases, int8 '
        f'evaluation and train.pruner in 2 rank processes over {mode}; the '
        f'flagship at 300 px, seeded weights, b{MA_BATCH} a model group, '
        'the committed JPEG fixtures')
    work = tempfile.mkdtemp(prefix='chip_smoke_mp_')
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        os.makedirs(os.path.join(work, 'video'))
        frames = sorted((JPEG_FIXTURES / 'VOC2007' / 'JPEGImages').glob(
            '*.jpg'))[:MP_FRAMES]
        if len(frames) != MP_FRAMES:
            fail(f'phase 25: {len(frames)} fixture frames')
        for f in frames:
            shutil.copy(f, os.path.join(work, 'video'))
        t = time.perf_counter()
        procs, logs = start_ma_ranks(work, 'phases', 2, backend)
        ones = {}
        for key in MA_OPTIONS:  # one process beside the ranks
            exp = mp_experiment('cuda', 0, 1, MP_ONE_PROCESS[key])
            ones[key] = mp_epoch(exp)
            del exp
            torch.cuda.empty_cache()
        wait_ma_ranks(procs, logs, 25)
        ranks = [torch.load(os.path.join(work, f'phases{r}.pt'),
                            weights_only=False) for r in range(2)]
        ranks_s = time.perf_counter() - t
        out = {'mode': mode, 'backend': backend, 'ranks_s': ranks_s,
               'options': {}}
        for key in MA_OPTIONS:
            check = mp_check(key, ranks, ones[key], work)
            out['options'][key] = check
            log(f'  {key}: (a) {check["dead_channels"]} channels pruned, '
                'every rank\'s dead set, pruned parameters and mask equal to '
                'one process\'s bit for bit; (b) int8 evaluation '
                + json.dumps(check['rows']) + ' against one process '
                + json.dumps(check['one_process'])
                + f'; NMS {check["eval_nms_launches"]} a rank; (c) process '
                f'0\'s b{MA_BATCH} int8 artifact equal to one process\'s from '
                f'the gathered checkpoint bit for bit, '
                f'{check["detections"]} detections, NMS '
                f'{check["export_nms_launches_per_call"]} a call; (d) '
                f'{MP_FRAMES} frames, NMS {check["test_nms_launches"]} by '
                f'rank; (e) {smi}: epoch {check["epoch_s"]:.2f} s (one '
                f'process {check["one_process_epoch_s"]:.2f}), export '
                f'{check["export_s"]:.2f} s, test {check["test_s"]:.2f} s, '
                'one process from the checkpoint '
                f'{check["one_process_reference_s"]:.2f} s')
        return out
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(work, ignore_errors=True)


# --------------------------------------------------------------- phase 26

# The accuracy protocol's own arm (``tools/parity_run.py``): the
# low-variance protocol staged by the port's tool (512 train and 64 eval
# synthetic JPEGs at 128 px, SSD-MobileNetV2-0.35 with 5 classes, SGD 2e-3
# at b8, MultiStepLR at epochs 40 and 52, hflip), seed 23 trained from
# scratch through ``cli.main`` with ``train.fused_bn``.  ``--parity-only``
# trains the protocol's 60 epochs and holds the held-out mAP to
# ``PARITY_MIN_MAP``; the whole script trains ``PARITY_SHORT_EPOCHS`` of
# them and holds the loss to falling.
PARITY_TRAIN_N, PARITY_EVAL_N = 512, 64
PARITY_EPOCHS = 60
PARITY_SHORT_EPOCHS = 4
PARITY_MILESTONES = '40,52'
PARITY_SEED = 23
# the JAX package's record of this protocol on a TPU (PARITY.md, true f32,
# seeds 23-27): 0.720-0.754, mean 0.736
PARITY_MIN_MAP = 0.65


def bn_input_shapes(model: torch.nn.Module, x: torch.Tensor) -> dict:
    """``{(B, C, H, W): count}`` of the inputs of ``model``'s BNs on ``x``
    (an eval-mode forward: the shapes of a train step's)."""
    shapes = collections.Counter()
    hooks = [m.register_forward_pre_hook(
        lambda _, args: shapes.update([tuple(args[0].shape)]))
        for m in model.modules() if isinstance(m, BatchNorm)]
    model.eval()
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return dict(shapes)


def run_parity(smi: str, epochs: int, seed: int = PARITY_SEED) -> dict:
    """Phase 26: ``epochs`` of the accuracy protocol's ``seed`` through
    the CLI with ``fused_bn``, every kernel counted; NMS exactly and K1-K4
    at ``BN_TOL`` against their plain versions on the run's own shapes."""
    from single_shot_detection_tpu_torch.tools import parity_run
    full = epochs == PARITY_EPOCHS
    log(f'[26] {smi}: the accuracy protocol (tools/parity_run.py) seed '
        f'{seed}, {PARITY_TRAIN_N} train and {PARITY_EVAL_N} eval '
        f'synthetic images at {parity_run.IMG} px, {epochs} of its '
        f'{PARITY_EPOCHS} epochs from scratch, fused_bn, through cli.main')
    work = tempfile.mkdtemp(prefix='chip_smoke_parity_')
    try:
        parity_run.TRAIN_N, parity_run.EVAL_N = PARITY_TRAIN_N, PARITY_EVAL_N
        t = time.perf_counter()
        csvs = parity_run.stage_dataset(work)
        config = parity_run.write_configs(work, csvs, epochs, seed,
                                          PARITY_MILESTONES)['ours']
        with open(config, 'a') as f:
            f.write("\ntrain['fused_bn'] = True\n")
        stage_s = time.perf_counter() - t
        save = os.path.join(work, 'ours_out')
        exp, rows, launches, seconds, epoch_s = run_cli(
            ['--config', config, '--save-dir', save])
        mAP = parity_run.last_eval_map(save)
        steps = len(exp.loaders['train'])
        eval_batches = len(exp.loaders['eval'])
        n_bn = sum(isinstance(m, BatchNorm) for m in exp.model.modules())
        want = {fn.__name__: n_bn * steps * epochs for fn in bn_kernel.KERNELS}
        want['nms_keep_batched'] = eval_batches  # one evaluation, at the end
        if launches != want:
            fail(f'phase 26: kernel launches {launches}, expected {want}')
        losses = [row['train_loss'] for row in rows]
        train_s = sum(epoch_s)
        log(f'  mAP {mAP:.4f} after {epochs} epochs of {steps} b'
            f'{exp.loaders["train"].batch_size} steps; staged in '
            f'{stage_s:.2f} s, the run {seconds / 60:.2f} min, '
            f'{steps * epochs / train_s:.2f} steps/s over the epochs; train '
            f'loss {losses[0]:.4f} -> {losses[-1]:.4f}; kernel launches '
            + json.dumps(launches))
        if len(rows) != epochs or not all(np.isfinite(losses)):
            fail(f'phase 26: epoch losses {losses}')
        if not 0.0 <= mAP <= 1.0:
            fail(f'phase 26: mAP {mAP} outside [0, 1]')

        # the kernels against their plain versions on this run's inputs
        boxes, scores = eval_nms_inputs(exp)
        thr = exp.postprocessor.overlap_threshold
        got = nms_kernel.nms_keep_batched(boxes, scores, thr)
        if not torch.equal(got, nms_ops.nms_keep_sorted(boxes, scores, thr)):
            fail('phase 26: NMS kernel != plain on the evaluation\'s inputs')
        batch = first_batch(exp.loaders['train'], torch.device('cuda'))
        x, _, _ = exp.eval_pipeline.apply([], *batch)
        shapes = bn_input_shapes(exp.model, x)
        if sum(shapes.values()) != n_bn:
            fail(f'phase 26: {sum(shapes.values())} BN inputs, {n_bn} BNs')
        bn_err_worst = check_bn_kernels(
            [BnCase(f'parity {list(shape)}', shape, torch.float32)
             for shape in shapes], quiet=True)
        log(f'  NMS exact on the evaluation\'s first batch '
            f'(N={scores.shape[0]}, K={scores.shape[1]}, {int(got.sum())} '
            'kept); K1-K4 within '
            f'BN_TOL on the {len(shapes)} distinct b{x.shape[0]} BN shapes of '
            f'{n_bn} BNs')
        if full and mAP < PARITY_MIN_MAP:
            fail(f'phase 26: held-out mAP {mAP:.4f} under {PARITY_MIN_MAP} '
                 f'after {epochs} epochs')
        if not full and not losses[-1] < losses[0]:
            fail(f'phase 26: the loss did not fall: {losses}')
        return {'seed': seed, 'epochs': epochs, 'mAP': mAP,
                'minutes': seconds / 60,
                'steps_per_s': steps * epochs / train_s, 'stage_s': stage_s,
                'epoch_s': epoch_s, 'train_losses': losses,
                'launches': launches, 'n_bn': n_bn,
                'bn_shapes': {str(list(k)): v for k, v in shapes.items()},
                'bn_max_abs_err': bn_err_worst,
                'nms_shape': list(scores.shape)}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------ tie rules

def check_tie_rules(device: torch.device) -> None:
    """Phase 3's last check: the port's gradients at a clamp's bound
    follow the JAX package's rule on the card (``torch.minimum`` and
    ``torch.maximum`` against a 0-dim CPU bound pass half the gradient,
    ``jnp.abs`` passes 1 at 0): ReLU6 half at 6 and none at 0, at f32 and
    bf16; a box of zero width half its height; the BCE on a logit of 0
    ``-t``.  Each gradient equals the CPU's bit for bit and the JAX
    package's value (``tests/test_torch_port_ties.py`` holds the CPU to
    JAX)."""
    from single_shot_detection_tpu_torch.models.layers import relu6
    from single_shot_detection_tpu_torch.ops import boxes as box_ops
    from single_shot_detection_tpu_torch.ops import losses

    def bce(v):
        target = torch.tensor([[1.0, 0.0, 1.0]], device=v.device)
        return losses.BCEWithLogitsLoss(reduction='none')(v, target)

    relu6_x = [-1.0, 0.0, 6.0, 7.0, 3.0]
    relu6_grad = [0.0, 0.0, 0.5, 0.0, 1.0]
    cases = {
        'relu6 f32': (relu6, relu6_x, torch.float32, relu6_grad),
        'relu6 bf16': (relu6, relu6_x, torch.bfloat16, relu6_grad),
        'area, zero width': (box_ops.area, [[1.0, 2.0, 1.0, 5.0]],
                             torch.float32, [[-1.5, 0.0, 1.5, 0.0]]),
        'BCE, logits 0': (bce, [[0.0, 0.0, 0.0]], torch.float32,
                          [[-1.0, 0.0, -1.0]]),
    }
    out = {}
    for name, (fn, x, dtype, want) in cases.items():
        grads = []
        for dev in (torch.device('cpu'), device):
            v = torch.tensor(x, dtype=dtype, device=dev).requires_grad_()
            fn(v).float().sum().backward()
            grads.append(v.grad.float().cpu())
        if not torch.equal(grads[0], grads[1]):
            fail(f'tie rule {name}: card {grads[1].tolist()} != CPU '
                 f'{grads[0].tolist()}')
        if not torch.equal(grads[1], torch.tensor(want)):
            fail(f'tie rule {name}: gradient {grads[1].tolist()}, JAX\'s '
                 f'{want}')
        out[name] = grads[1].tolist()
    log(f'  tie rules on the card as on the CPU and in JAX: {out}')


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument(
        '--parent-nms', metavar='NMS_CU',
        help='another version of kernels/nms.cu (e.g. from a git archive '
             'of an earlier commit) to build and time beside this one')
    parser.add_argument(
        '--parent-bn', metavar='BN_CU',
        help='another version of kernels/bn.cu with this C interface (e.g. '
             'from a git archive of an earlier commit) whose K2 and K4 are '
             'built and timed in turns beside this one in the profiled '
             'train steps and in phase 14')
    parser.add_argument(
        '--data-parallel-only', action='store_true',
        help='build the kernels and run phase 23 alone (two rank processes; '
             'NCCL with two cards or more), then print its results as JSON; '
             'the smoke test\'s last line is not printed')
    parser.add_argument('--dp-worker', nargs=4, help=argparse.SUPPRESS,
                        metavar=('RANK', 'PORT', 'BACKEND', 'OUT'))
    parser.add_argument(
        '--model-axis-only', action='store_true',
        help='build the kernels and run phase 24 alone (tensor, pipeline '
             'and spatial sharding in rank processes; NCCL with four cards '
             'or more), then print its results as JSON; the smoke test\'s '
             'last line is not printed')
    parser.add_argument(
        '--model-axis-phases-only', action='store_true',
        help='build the kernels and run phase 25 alone (the model axis\'s '
             'test and export phases, int8 evaluation and pruner in two rank '
             'processes; NCCL with two cards or more), then print its '
             'results as JSON; the smoke test\'s last line is not printed')
    parser.add_argument(
        '--parity-only', action='store_true',
        help='build the kernels and run phase 26 alone at the accuracy '
             'protocol\'s full 60 epochs (seed 23, the held-out mAP held to '
             'PARITY_MIN_MAP), then print its results as JSON; the smoke '
             'test\'s last line is not printed')
    parser.add_argument('--parity-seed', type=int, default=PARITY_SEED,
                        help='the seed --parity-only trains')
    parser.add_argument('--ma-worker', nargs=6, help=argparse.SUPPRESS,
                        metavar=('GROUP', 'RANK', 'COUNT', 'PORT', 'BACKEND',
                                 'OUT'))
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # 1. environment
    if not torch.cuda.is_available():
        print('FAIL: CUDA is not available', file=sys.stderr)
        return 1
    if args.dp_worker:  # a rank process of phase 23
        rank, port, backend, out = args.dp_worker
        return dp_worker(int(rank), int(port), backend, out)
    if args.ma_worker:  # a rank process of phase 24
        group, rank, count, port, backend, out = args.ma_worker
        return ma_worker(group, int(rank), int(count), int(port), backend, out)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    if args.model_axis_only or args.model_axis_phases_only:
        from single_shot_detection_tpu_torch.data import native
        t = time.perf_counter()
        for module in (nms_kernel, bn_kernel):
            module.build()
        native.get_library()
        log(f'[2] built the kernels and the JPEG decoder in '
            f'{time.perf_counter() - t:.2f} s')
        t = time.perf_counter()
        phase, run = ((24, run_model_axis) if args.model_axis_only
                      else (25, run_model_axis_phases))
        result = run(smi)
        log(f'phase {phase} in {time.perf_counter() - t:.2f} s')
        log(json.dumps(result, default=str))
        return 0
    if args.parity_only:
        from single_shot_detection_tpu_torch.data import native
        t = time.perf_counter()
        with ThreadPoolExecutor() as pool:
            for b in [pool.submit(m.build) for m in (nms_kernel, bn_kernel)]:
                b.result()
        native.get_library()
        log(f'[2] built the kernels and the JPEG decoder in '
            f'{time.perf_counter() - t:.2f} s')
        t = time.perf_counter()
        result = run_parity(smi, PARITY_EPOCHS, args.parity_seed)
        log(f'phase 26 in {time.perf_counter() - t:.2f} s')
        log(json.dumps(result, default=str))
        return 0
    if args.data_parallel_only:
        from single_shot_detection_tpu_torch.data import native
        t = time.perf_counter()
        for module in (nms_kernel, bn_kernel):
            module.build()
        native.get_library()  # the ranks load the one build
        log(f'[2] built the kernels and the JPEG decoder in '
            f'{time.perf_counter() - t:.2f} s')
        t = time.perf_counter()
        result = run_multi_gpu(smi)
        log(f'phase 23 in {time.perf_counter() - t:.2f} s')
        log(json.dumps(result, default=str))
        return 0
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
        parent_bn = (pool.submit(load_parent_bn, args.parent_bn)
                     if args.parent_bn else None)
        for b in builds:
            b.result()
        parent_nms = parent.result() if parent else None
        parent_bn = parent_bn.result() if parent_bn else None
    others = [a for a in (args.parent_nms, args.parent_bn) if a]
    log(f'[2] built the nms and bn kernels in {time.perf_counter() - t:.2f} s'
        + (f' (and {", ".join(others)})' if others else ''))

    # 3. kernels against their plain versions
    log('[3] kernels vs plain versions on the card')
    nms_check = check_nms_kernel(device)
    bn_check = check_bn_kernels()
    check_tie_rules(device)

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
    step_profile = profile_train_step(trainer, train_batches[0], n_bn, card,
                                      'flagship', parent_bn=parent_bn)
    library_step = library_bn_step_ms(step_profile.pop('bn_shapes'))
    log(f'[7] {smi}: train_step b32 with the BN kernels '
        f'{train_timing["train_step_b32_fused_bn_ms"]:.3f} ms = '
        f'{train_timing["train_step_b32_fused_bn_img_per_s"]:.1f} img/s; with '
        f'PyTorch BN {train_timing["train_step_b32_library_bn_ms"]:.3f} ms = '
        f'{train_timing["train_step_b32_library_bn_img_per_s"]:.1f} img/s')
    log_bn_kernels(bn_time, 'f32')
    log_bn_step(step_profile, library_step, n_bn)
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

    # 12. the model zoo: RetinaNet-ResNet50 and SSD300-VGG16
    t = time.perf_counter()
    log(f'[12] {smi}: the model zoo at b{ZOO_BATCH}, seeded random weights, '
        'fused_bn')
    zoo = run_zoo(card, smi, parent_bn)
    log(f'  phase 12 in {time.perf_counter() - t:.1f} s')

    # 13. the rest of the zoo: M2Det-512, SSD300-ShuffleNetV2, GroupNorm
    t = time.perf_counter()
    log(f'[13] {smi}: M2Det-512 at b8 and SSD300-ShuffleNetV2 at b32, '
        'seeded random weights, fused_bn; MobileNet v1 + the depthwise FPN '
        'with train.group_norm')
    zoo_rest = run_zoo_rest(card, smi, parent_bn)
    log(f'  phase 13 in {time.perf_counter() - t:.1f} s')

    # 14. the BN kernels shape by shape over the five steps
    t = time.perf_counter()
    log(f'[14] {smi}: K1 and K3 (f32), K2 and K4 (f32 and bf16) per launch '
        'at every BN shape of the five steps (warm: each window repeats its '
        'inputs)'
        + (f', K2 and K4 in turns against {args.parent_bn}' if parent_bn
           else ''))
    bn_shapes = time_bn_shapes(card, parent_bn)
    log(f'  phase 14 in {time.perf_counter() - t:.1f} s')

    # 15. bf16 and the precision options
    t = time.perf_counter()
    log(f'[15] {smi}: bf16 and TF32 against f32 on the flagship\'s serving '
        'and train step and RetinaNet\'s step, soft-NMS, the CLI with --bf16')
    precision = run_precision(card, smi, parent_bn)
    log(f'  phase 15 in {time.perf_counter() - t:.1f} s')

    # 16. int8 serving and QAT
    t = time.perf_counter()
    log(f'[16] {smi}: int8 serving (export/quantize.py) against f32 and '
        f'bf16 at {", ".join(p[0] for p in INT8_POINTS)}; QAT on the '
        'flagship; the JAX checkpoint at int8')
    int8 = run_int8(card, smi, card_metrics)
    log(f'  phase 16 in {time.perf_counter() - t:.1f} s')

    # 17. train.transfer_ahead
    t = time.perf_counter()
    transfer = run_transfer_ahead(smi)
    log(f'  phase 17 in {time.perf_counter() - t:.1f} s')

    # 18. export and the artifact's consumers
    t = time.perf_counter()
    export = run_export(smi)
    log(f'  phase 18 in {time.perf_counter() - t:.1f} s')

    # 19. structured channel pruning and the narrow model
    t = time.perf_counter()
    pruned = run_pruning(smi)
    log(f'  phase 19 in {time.perf_counter() - t:.1f} s')

    # 20. the rest of the train path: optimizers, EMA, mixup, accumulation,
    # clipping, lr_groups, frozen BN, fused steps, the other losses
    t = time.perf_counter()
    options = run_train_options(smi)
    log(f'  phase 20 in {time.perf_counter() - t:.1f} s')

    # 21. the data path and run extras: native decode, YUV420 staging, the
    # staging cache, the device cache, eval replay, async saves, tensorboard
    t = time.perf_counter()
    extras = run_data_extras(smi)
    log(f'  phase 21 in {time.perf_counter() - t:.1f} s')

    # 22. interop: the reference's checkpoint both ways, torch-hub and keras
    # backbones, bilinear necks
    t = time.perf_counter()
    interop = run_interop(smi, card_metrics)
    log(f'  phase 22 in {time.perf_counter() - t:.1f} s')

    # 23. data parallelism over two rank processes
    t = time.perf_counter()
    multi_gpu = run_multi_gpu(smi)
    log(f'  phase 23 in {time.perf_counter() - t:.1f} s')

    # 24. the model axis: tensor, pipeline and spatial sharding
    t = time.perf_counter()
    model_axis = run_model_axis(smi)
    log(f'  phase 24 in {time.perf_counter() - t:.1f} s')

    # 25. the model axis's test and export phases, int8 evaluation, pruner
    t = time.perf_counter()
    axis_phases = run_model_axis_phases(smi)
    log(f'  phase 25 in {time.perf_counter() - t:.1f} s')

    # 26. the accuracy protocol's own arm, cut to a few epochs
    t = time.perf_counter()
    parity = run_parity(smi, PARITY_SHORT_EPOCHS)
    log(f'  phase 26 in {time.perf_counter() - t:.1f} s')

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
                           **jax_check, 'launches': jax_launches},
        'zoo': {key: value for key, value in zoo.items() if key != 'nms'},
        'zoo_rest': {key: value for key, value in zoo_rest.items()
                     if key != 'nms'},
        'bn_shapes': bn_shapes,
        'precision': {
            'serving': {k: v for k, v in precision['serving'].items()
                        if k != 'nms'},
            'training': {k: v for k, v in precision['training'].items()
                         if k not in ('bn_step', 'per_launch')},
            'retina': precision['retina'], 'cli': precision['cli']},
        'int8': {key: ({k: v for k, v in value.items() if k != 'nms'}
                       if isinstance(value, dict) else value)
                 for key, value in int8.items()},
        'transfer_ahead': transfer, 'export': export,
        'pruning': {key: value for key, value in pruned.items()
                    if key != 'launches'},
        'train_options': {
            **{k: v for k, v in options.items() if k != 'combined'},
            'combined': {k: v for k, v in options['combined'].items()
                         if k != 'launches'}},
        'data_extras': extras, 'interop': interop,
        'multi_gpu': multi_gpu, 'model_axis': model_axis,
        'model_axis_phases': axis_phases, 'parity': parity}}))
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
                                 jax_launches['nms_keep_batched'],
                             **{f'{key}_{label}': zoo[key][path]['launches'][
                                 'nms_keep_batched'] for key in ZOO
                                 for path, label in ZOO_PATHS},
                             'retina_cli': zoo['retina']['cli']['launches'][
                                 'nms_keep_batched'],
                             **{f'{key}_{label}': zoo_rest[key][path][
                                 'launches']['nms_keep_batched']
                                 for key in ZOO_REST
                                 for path, label in ZOO_PATHS},
                             'm2det_cli': zoo_rest['m2det']['cli']['launches'][
                                 'nms_keep_batched'],
                             'mbv1_gn': zoo_rest['mbv1_gn']['launches'][
                                 'nms_keep_batched'],
                             'bf16_serving': precision['serving']['launches'][
                                 'nms_keep_batched'],
                             'bf16_train': precision['training']['launches'][
                                 'nms_keep_batched'],
                             'bf16_cli': precision['cli']['launches'][
                                 'nms_keep_batched'],
                             **{f'int8_{label}': int8[label]['launches'][
                                 'nms_keep_batched'] for label, *_ in INT8_POINTS},
                             'qat_train': int8['qat']['launches'][
                                 'nms_keep_batched'],
                             'qat_int8_serving': int8['qat'][
                                 'int8_eval_launches']['nms_keep_batched'],
                             'int8_cli_jax_checkpoint': int8['jax_checkpoint'][
                                 'launches']['nms_keep_batched'],
                             # one artifact call each (phase 18)
                             **{f'export_{label}': export[label][
                                 'launches_per_call']['nms_keep_batched']
                                for label, *_ in EXPORT_POINTS},
                             'export_cli_jax_checkpoint_eval': export[
                                 'cli_jax_checkpoint']['eval_launches'][
                                 'nms_keep_batched'],
                             'export_test_phase': export['test_phase'][
                                 'launches']['nms_keep_batched'],
                             # phase 19: the pruned run's evaluation, one
                             # call of its narrow artifact, the JAX
                             # checkpoint's masked and narrow evaluations
                             'pruning_experiment': pruned['launches'][
                                 'nms_keep_batched'],
                             'pruning_narrow_export': pruned['export'][
                                 'launches_per_call']['nms_keep_batched'],
                             'pruning_jax_checkpoint': pruned[
                                 'jax_checkpoint']['launches'][
                                 'nms_keep_batched'],
                             # phase 20: the evaluation on the EMA shadow
                             'train_options_experiment': options[
                                 'combined']['launches']['nms_keep_batched'],
                             # phase 21: three evaluations, two replayed
                             'data_extras_experiment': extras['experiment'][
                                 'launches']['nms_keep_batched'],
                             # phase 22: b32 serving of the imported
                             # weights, the exported JAX run's CLI eval
                             'interop_serving': interop['serving'][
                                 'launches']['nms_keep_batched'],
                             'interop_cli_jax_run': interop['jax_run'][
                                 'launches']['nms_keep_batched'],
                             # phase 23: each rank's evaluation
                             **{f'multi_gpu_rank{r}': n for r, n in enumerate(
                                 multi_gpu['b']['nms_launches'])},
                             # phase 24: each option's evaluation, per rank
                             **{f'model_axis_{key}_rank{r}': n
                                for key, check in model_axis[
                                    'experiments'].items()
                                for r, n in enumerate(check['nms_launches'])},
                             # phase 25: each option's int8 evaluation and
                             # test phase per rank, its artifact per call
                             **{f'model_axis_phases_{key}_{path}_rank{r}': n
                                for key, check in axis_phases[
                                    'options'].items()
                                for path in ('eval', 'test')
                                for r, n in enumerate(
                                    check[f'{path}_nms_launches'])},
                             **{f'model_axis_phases_{key}_export': check[
                                 'export_nms_launches_per_call']
                                for key, check in axis_phases[
                                    'options'].items()},
                             # phase 26: the protocol's one evaluation
                             'parity': parity['launches']['nms_keep_batched']},
        'max_abs_err': nms_check['max_abs_err'],
        **{key: nms_time['b32'][key] for key in (
            'shape', 'ms', 'call_ms', 'plain_ms', 'bound_ms', 'bound_by',
            'floor_ms', 'n_valid')},
        'library_ms': None,
        'by_input': {name: {key: value for key, value in row.items()
                            if key not in ('bytes', 'turns_ms')}
                     for name, row in {**nms_time, **trained,
                                       **zoo['nms'], **zoo_rest['nms'],
                                       **precision['serving']['nms'],
                                       **{k: v for label, *_ in INT8_POINTS
                                          for k, v in int8[label].get(
                                              'nms', {}).items()}}.items()},
    }]
    # each zoo path's train step, phases 12 and 13
    zoo_steps = {key: paths[key]['training'] for paths, keys in
                 ((zoo, ZOO), (zoo_rest, ZOO_REST)) for key in keys}
    bf16 = precision['training']
    slower = slower_than_library({
        'flagship': (step_profile, library_step),
        **{key: (t['bn_step'], t['library_step_ms'])
           for key, t in zoo_steps.items()},
        'flagship_bf16': (bf16['bn_step'], bf16['library_step_ms'])})
    log('each BN kernel against its own PyTorch call over the six profiled '
        'steps, steps where the kernel was slower: ' + json.dumps(slower))
    for name, (_, _, replaces) in BN_KERNELS.items():
        kernels.append({
            'name': name,
            'route': 'cuda',
            'source': 'single_shot_detection_tpu_torch/kernels/bn.cu',
            'replaces': replaces,
            'launches': cli_launches[name],
            'launches_by_path': {'train_step': bn_launches[name],
                                 'experiment': exp_launches[name],
                                 'cli': cli_launches[name],
                                 **{f'{key}_{label}': zoo[key][path]['launches'][
                                     name] for key in ZOO
                                     for path, label in ZOO_PATHS},
                                 'retina_cli': zoo['retina']['cli']['launches'][name],
                                 **{f'{key}_{label}': zoo_rest[key][path][
                                     'launches'][name] for key in ZOO_REST
                                     for path, label in ZOO_PATHS},
                                 'm2det_cli': zoo_rest['m2det']['cli'][
                                     'launches'][name],
                                 'mbv1_gn': zoo_rest['mbv1_gn']['launches'][name],
                                 'bf16_serving': precision['serving'][
                                     'launches'][name],
                                 'bf16_train': bf16['launches'][name],
                                 'bf16_cli': precision['cli']['launches'][name],
                                 **{f'int8_{label}': int8[label]['launches'][name]
                                    for label, *_ in INT8_POINTS},
                                 'qat_train': int8['qat']['launches'][name],
                                 'int8_cli_jax_checkpoint': int8[
                                     'jax_checkpoint']['launches'][name],
                                 **{f'export_{label}': export[label][
                                     'launches_per_call'][name]
                                    for label, *_ in EXPORT_POINTS},
                                 # phase 19's masked steps
                                 'pruning_experiment': pruned['launches'][
                                     name],
                                 # phase 20: every train option at once,
                                 # and frozen BN (none)
                                 'train_options_experiment': options[
                                     'combined']['launches'][name],
                                 'train_options_frozen_bn': options[
                                     'frozen_bn']['launches'][name],
                                 # phase 21: the fill epoch and two from
                                 # the device cache
                                 'data_extras_experiment': extras[
                                     'experiment']['launches'][name],
                                 # phase 22: one step from imported weights
                                 'interop_train_step': interop['train_step'][
                                     'launches'][name],
                                 # phase 24: each option's run, per rank
                                 # (fused_bn is off over several processes)
                                 **{f'model_axis_{key}_rank{r}': n[name]
                                    for key, check in model_axis[
                                        'experiments'].items()
                                    for r, n in enumerate(
                                        check['bn_launches'])},
                                 # phase 25: checked 0 on every rank
                                 **{f'model_axis_phases_{key}': 0
                                    for key in axis_phases['options']},
                                 # phase 26: the protocol's epochs
                                 'parity': parity['launches'][name]},
            'max_abs_err': max(bn_check[name], parity['bn_max_abs_err'][name],
                               *(t['bn_max_abs_err'][name]
                                 for t in zoo_steps.values())),
            'shape': list(BN_TIMED_SHAPE),
            **bn_time[name],
            **step_profile[name],
            **library_step_fields(name, library_step),
            'by_step': {key: {
                **t['bn_step'][name], 'launches': t['n_bn'],
                **library_step_fields(name, t['library_step_ms']),
                'max_abs_err': t['bn_max_abs_err'][name]}
                for key, t in zoo_steps.items()},
            'by_step_per_shape': {key: step[name] for key, step in
                                  bn_shapes['steps'].items()
                                  if name in step},
            # the flagship's bf16 train step (phase 15)
            'bf16': {**bf16['per_launch'][name], **bf16['bn_step'][name],
                     'launches': bf16['launches'][name],
                     **library_step_fields(name, bf16['library_step_ms']),
                     'max_abs_err': bf16['bn_max_abs_err'][name]},
            'slower_than_library_on': slower[name],
        })
    log(json.dumps({'kernels': kernels}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': card,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
