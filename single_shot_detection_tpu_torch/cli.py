"""Command line: ``python -m single_shot_detection_tpu_torch``.

Port of the JAX package's ``main.py``, flag for flag::

    python -m single_shot_detection_tpu_torch --config samples/synthetic_smoke.py \\
        --phases train eval [--save-dir DIR] [--checkpoint FILE_OR_DIR]
        [--new-checkpoint] [--load-weights] [--debug] [--cpu] [--profile DIR]
        [--bf16] [--int8] [--matmul-precision NAME] [--video PATH]
        [--coordinator-address HOST:PORT --num-processes N --process-id I]

``train`` runs the epochs (checkpoints, ``log.csv``, ``train.log`` and a
copy of the config go to a timestamped directory under ``--save-dir``, or
to the ``--checkpoint`` directory it resumes unless ``--new-checkpoint``);
``eval`` alone evaluates and writes nothing; ``test`` runs the detector on
each frame of ``--video`` (a video file or an image folder) and shows or,
headless, saves the frames with their boxes (``utils/video_viewer.py``);
``export`` writes a ``torch.export`` artifact as the config's ``export``
block says (``Experiment.export``, ``export/__init__.py``); ``embed``
opens an interactive shell with ``experiment`` and ``cfg``.
``--checkpoint`` also takes the JAX package's ``ckpt-N.msgpack`` files and
directories.  The run is on ``cuda``
and raises without a GPU unless ``--cpu`` is given.  ``--profile DIR``
writes a ``torch.profiler`` trace of the train phase into DIR.
``--bf16`` runs the activations in bfloat16 (parameters, BN statistics,
momentum and losses stay f32; checkpoints are f32) and
``--matmul-precision`` sets the precision of the convolutions and matmuls
(unset: ``highest``, TF32 off, for f32 runs; ``default``, TF32 on, for
bf16 runs; ``device.py``).  ``--int8`` evaluates with the dense convs in
int8, calibrated on eval batches or from a ``train.qat`` run's scales
(``export/quantize.py``), unless the JAX package's serving gate refuses the
config's backbone at its eval batch; with the ``export`` phase it exports
an int8 artifact.

``--tensorboard`` writes each epoch's ``train/{k}`` and ``eval/{k}``
scalars beside the checkpoints (``torch.utils.tensorboard``).

``--num-processes N`` with ``--coordinator-address HOST:PORT`` (process
0's) and ``--process-id I`` runs process ``I`` of a data-parallel run of
N processes, one card each (``cuda:{I % cards}``; gloo on the CPU with
``--cpu``), started once per process: ``config.batch_size`` is each
process's batch (``train/engine.py``).  Process 0 picks and creates the
run directory and hands its name to the others; only it writes the
checkpoints, ``log.csv``, ``train.log``, tensorboard scalars and an
export, and runs the ``test`` phase.

A config's ``train.tensor_sharding``, ``spatial_sharding`` or
``pipeline_sharding`` runs over the processes with no flag of its own
(``--num-processes W`` with the option's ``m``; ``trainer.py``), its
``ValueError``s raised before anything is written.  Its ``test`` and
``export`` phases serve the whole model (``Experiment.whole_model``):
every rank enters its gather and the int8 calibration, then process 0
runs the frames and writes the artifact.

Not ported, raising ``NotImplementedError`` before anything is written:
``--compilation-cache`` other than ``off`` (the port has no XLA cache; its
kernels are built once into ``kernels/build/``).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional, Sequence

def get_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog='python -m single_shot_detection_tpu_torch')
    parser.add_argument('--config', default='./config.py',
                        help='Path to a config file')
    parser.add_argument('--save-dir', type=str, default='./experiments',
                        help='Folder where checkpoints are saved')
    parser.add_argument('--checkpoint', type=str,
                        help='Checkpoint file/dir to restore from (.pt, or '
                             'the JAX package\'s .msgpack)')
    parser.add_argument('--debug', default=False, action='store_true',
                        help='Disable checkpoint/log writing, verbose logs')
    parser.add_argument('--new-checkpoint', default=False, action='store_true',
                        help='Save to a fresh directory even when resuming')
    parser.add_argument('--load-weights', default=False, action='store_true',
                        help='Restore weights only (fresh optimizer state)')
    parser.add_argument('--cpu', default=False, action='store_true',
                        help='Run on the CPU (default: the CUDA card)')
    parser.add_argument('--bf16', default=False, action='store_true',
                        help='bfloat16 activations (parameters, BN '
                             'statistics and losses stay f32)')
    parser.add_argument('--int8', default=False, action='store_true',
                        help='int8 evaluation and export: dense convs as '
                             's8 x s8 -> s32 products, calibrated on eval '
                             'batches')
    parser.add_argument('--matmul-precision', type=str, default=None,
                        choices=['default', 'high', 'highest',
                                 'bfloat16', 'tensorfloat32', 'float32'],
                        help='Matmul/conv precision. Unset: f32 runs use '
                             '"highest" (TF32 off), bf16 runs "default" '
                             '(TF32 on)')
    parser.add_argument('--phases', nargs='+', default=['train', 'eval'],
                        choices=['train', 'eval', 'test', 'export', 'embed'],
                        help='One or multiple runtime phases')
    parser.add_argument('--video', type=str,
                        help='Video file or image folder for the test phase')
    parser.add_argument('--tensorboard', default=False, action='store_true',
                        help='Log train/eval scalars to tensorboard '
                             '(into the checkpoint directory)')
    parser.add_argument('--profile', type=str, default=None, metavar='DIR',
                        help='Write a torch.profiler trace of the train '
                             'phase into DIR')
    parser.add_argument('--compilation-cache', type=str, default=None,
                        metavar='DIR|off',
                        help='The JAX package\'s XLA cache; the port has '
                             'none: only "off"')

    dist = parser.add_argument_group('distributed (one process a card)')
    dist.add_argument('--coordinator-address', type=str, default=None,
                      help='HOST:PORT of process 0')
    dist.add_argument('--num-processes', type=int, default=None)
    dist.add_argument('--process-id', type=int, default=None)
    return parser


def check_ported(args: argparse.Namespace) -> None:
    """Raise ``NotImplementedError`` for a flag the port does not run."""
    if args.compilation_cache not in (None, 'off'):
        raise NotImplementedError(
            '--compilation-cache: the port has no XLA compilation cache; its '
            'CUDA kernels are built once into '
            'single_shot_detection_tpu_torch/kernels/build/')


def _profiled(directory: str, device, run):
    """``run()`` under ``torch.profiler``, its trace written into
    ``directory`` (TensorBoard's PyTorch profiler plugin reads it)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(directory)):
        return run()


def main(argv: Optional[Sequence[str]] = None):
    """Run ``main.py``'s phases; returns ``(experiment, result)``, the
    result being the train phase's epoch rows, the eval phase's metrics
    when it runs alone, or None.  ``test`` and ``export`` run after them,
    in that order."""
    args = get_argparser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format='%(message)s', stream=sys.stdout, force=True)
    check_ported(args)

    from single_shot_detection_tpu_torch import parallel
    from single_shot_detection_tpu_torch.train import checkpoint as ckpt_utils
    from single_shot_detection_tpu_torch.train.engine import Experiment
    from single_shot_detection_tpu_torch.trainer import check_ported as check_train
    from single_shot_detection_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, phases=args.phases)
    processes = int(args.num_processes or 1)
    check_train(cfg, processes)  # before anything is written
    device = 'cpu' if args.cpu else 'cuda'
    joined = processes > 1
    if joined:
        device = parallel.initialize_distributed(
            args.coordinator_address, processes, args.process_id,
            device=device)
    handler = None
    try:
        index = parallel.process_index()
        train = 'train' in args.phases
        checkpoint_dir = None
        if index == 0:
            checkpoint_dir = ckpt_utils.prepare_checkpoint_dir(
                args.save_dir, args.checkpoint, args.config, args.debug,
                train, args.new_checkpoint)
        if joined:  # one run directory, process 0's
            checkpoint_dir = parallel.broadcast_object(checkpoint_dir)

        if not args.debug and train and index == 0:
            # the file logger next to the checkpoints
            handler = logging.FileHandler(os.path.join(checkpoint_dir,
                                                       'train.log'))
            handler.setFormatter(logging.Formatter('%(asctime)s %(message)s'))
            logging.getLogger().addHandler(handler)
        experiment = Experiment(cfg, phases=args.phases, device=device,
                                checkpoint_dir=checkpoint_dir,
                                resume_from=args.checkpoint,
                                load_weights=args.load_weights,
                                debug=args.debug, bf16=args.bf16,
                                int8=args.int8,
                                matmul_precision=args.matmul_precision,
                                tensorboard=args.tensorboard,
                                process_count=processes, process_index=index)
        if 'embed' in args.phases:
            import code
            code.interact(local={'experiment': experiment, 'cfg': cfg})
            return experiment, None
        result = None
        if train:
            if args.profile:
                result = _profiled(args.profile, experiment.device,
                                   experiment.train)
            else:
                result = experiment.train()
        elif 'eval' in args.phases:
            result = experiment.evaluate()
        experiment.trainer.gather_shadow()  # ZeRO-1 with EMA: every rank
        if 'test' in args.phases:
            # every rank: an int8 calibration takes the ranks' maximum, and
            # a model axis's whole model is gathered
            experiment.predictor()
            if index == 0:
                from single_shot_detection_tpu_torch.utils.video_viewer import VideoViewer
                VideoViewer(args.video, experiment).run()
        if 'export' in args.phases:  # every rank gathers, process 0 writes
            experiment.export(int8=args.int8)
        return experiment, result
    finally:
        if handler is not None:
            logging.getLogger().removeHandler(handler)
            handler.close()
        if joined:
            parallel.destroy()
