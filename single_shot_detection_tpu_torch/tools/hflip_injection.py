"""The accuracy protocol over several seeds, with the port's own
horizontal-flip draws and with the JAX package's injected in their place.

    python -m single_shot_detection_tpu_torch.tools.hflip_injection \\
        --draws tests/data/protocol_jax_hflips.npz --seeds 23-32 \\
        --train-n 512 --eval-n 64 --epochs 60 --milestones 40,52 \\
        --out results.json

A diagnostic of the one random stream the two packages do not share: the
data order is the same permutation in both (``data/loader.py``), the
flips are not (``trainer.py::step_generator`` against the JAX engine's
keys).  Arm ``own`` is ``parity_run --skip-reference`` as it stands, one
process a seed.  Arm ``jax`` trains the same staged data and config
through the port's CLI in one process a seed, with
``Trainer.step_draws`` returning the JAX engine's flips of that seed and
step from ``--draws`` (an ``.npz`` of ``np.packbits`` of ``[steps,
batch]`` booleans under ``flips_<seed>``, written on a machine with JAX by
``tests/_torch_protocol.py flips``): a flip's ``u`` is 0.25 and no flip's
0.75, so the stage's ``u < p`` at the protocol's ``p = 0.5`` decides as
the JAX draw did.  Nothing else of the port changes: no flag, no config
key.  All the runs start at once (each is host-bound on one core) and the
tool prints, and writes to ``--out``, each run's held-out mAP and each
arm's mean, median, standard deviation and count under 0.6.  A run's
staged images and checkpoints are deleted once its mAP is read.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from single_shot_detection_tpu_torch.tools import parity_run

MODULE = 'single_shot_detection_tpu_torch.tools.hflip_injection'
ARMS = ('own', 'jax')
LOW = 0.6   # the tail's threshold in the protocol's records


def seed_list(text: str) -> List[int]:
    """``'23-32'`` or ``'23,25'`` -> a list of seeds."""
    seeds = []
    for part in text.split(','):
        lo, _, hi = part.partition('-')
        seeds += list(range(int(lo), int(hi or lo) + 1))
    return seeds


def read_flips(path: str, seed: int) -> np.ndarray:
    """``[steps, batch]`` bool: the JAX engine's flips of ``seed``."""
    with np.load(path) as data:
        steps, batch = int(data['steps']), int(data['batch'])
        bits = np.unpackbits(data[f'flips_{seed}'])[:steps * batch]
    return bits.reshape(steps, batch).astype(bool)


def inject(flips: np.ndarray):
    """Make ``Trainer.step_draws`` return ``flips`` as the hflip stage's
    draws; returns a function that puts the original back."""
    from single_shot_detection_tpu_torch.trainer import Trainer
    original = Trainer.step_draws

    def step_draws(self, step: int, batch: int):
        draws, mixup = original(self, step, batch)
        (stage,) = [i for i, (kind, _) in enumerate(self.pipeline.stages)
                    if kind == 'hflip']
        if flips.shape[1] != batch * self.data_count or step >= len(flips):
            raise ValueError(f'no injected flips for step {step} at batch '
                             f'{batch * self.data_count}')
        u = torch.where(torch.from_numpy(flips[step]), 0.25, 0.75)
        draws[stage] = {'u': u[self.data_index * batch:
                               (self.data_index + 1) * batch]}
        return draws, mixup

    Trainer.step_draws = step_draws
    return lambda: setattr(Trainer, 'step_draws', original)


def run_injected(args) -> float:
    """Arm ``jax`` for ``args.seed`` in this process; returns the mAP."""
    from single_shot_detection_tpu_torch import cli
    parity_run.TRAIN_N, parity_run.EVAL_N = args.train_n, args.eval_n
    os.makedirs(args.workdir, exist_ok=True)
    csvs = parity_run.stage_dataset(args.workdir)
    config = parity_run.write_configs(args.workdir, csvs, args.epochs,
                                      args.seed, args.milestones)['ours']
    save = os.path.join(args.workdir, 'ours_out')
    restore = inject(read_flips(args.draws, args.seed))
    t0 = time.time()
    try:
        cli.main(['--config', config, '--save-dir', save]
                 + (['--cpu'] if args.cpu else []))
    finally:
        restore()
    mAP = parity_run.last_eval_map(save)
    parity_run.save_results(os.path.join(args.workdir, 'results.json'), {
        'ours_jax_hflips': {'mAP': mAP,
                            'minutes': round((time.time() - t0) / 60, 1)}})
    return mAP


def command(arm: str, seed: int, workdir: str, args) -> List[str]:
    common = ['--seed', str(seed), '--workdir', workdir,
              '--train-n', str(args.train_n), '--eval-n', str(args.eval_n),
              '--epochs', str(args.epochs), '--milestones', args.milestones]
    if arm == 'own':
        cmd = [sys.executable, '-m',
               'single_shot_detection_tpu_torch.tools.parity_run',
               '--skip-reference'] + common
        return cmd + (['--ours-cpu'] if args.cpu else [])
    cmd = [sys.executable, '-m', MODULE, '--one', '--draws',
           args.draws] + common
    return cmd + (['--cpu'] if args.cpu else [])


def summary(maps: Sequence[float]) -> dict:
    return {'n': len(maps), 'mean': statistics.fmean(maps),
            'median': statistics.median(maps),
            'sd': statistics.stdev(maps) if len(maps) > 1 else 0.0,
            f'under_{LOW}': sum(m < LOW for m in maps)}


def run_all(args) -> dict:
    """Every (arm, seed) in its own process, all at once."""
    if not args.cpu:  # build once, before the processes race for it
        from single_shot_detection_tpu_torch.data import native
        from single_shot_detection_tpu_torch.ops import nms_kernel
        nms_kernel.build()
        native.get_library()
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env['PYTHONPATH'] = parity_run.ROOT + os.pathsep + env.get('PYTHONPATH', '')
    runs = {}
    t0 = time.time()
    for arm in ARMS:
        for seed in args.seeds:
            work = os.path.join(args.workdir, f'{arm}_{seed}')
            os.makedirs(work, exist_ok=True)
            log = open(os.path.join(work, 'run.log'), 'w')
            runs[arm, seed] = (work, log, subprocess.Popen(
                command(arm, seed, work, args), env=env, cwd=parity_run.ROOT,
                stdout=log, stderr=subprocess.STDOUT))
    maps: Dict[str, Dict[int, Optional[float]]] = {a: {} for a in ARMS}
    for (arm, seed), (work, log, proc) in runs.items():
        code = proc.wait()
        log.close()
        results = parity_run.load_results(os.path.join(work, 'results.json'))
        entry = results.get('ours' if arm == 'own' else 'ours_jax_hflips')
        maps[arm][seed] = entry['mAP'] if code == 0 and entry else None
        print(f'{arm} seed {seed}: exit {code}, mAP {maps[arm][seed]}',
              flush=True)
        shutil.rmtree(os.path.join(work, 'data'), ignore_errors=True)
        for directory, _, files in os.walk(os.path.join(work, 'ours_out')):
            for name in files:
                if name.endswith('.pt'):
                    os.remove(os.path.join(directory, name))
    out = {'seeds': args.seeds, 'epochs': args.epochs,
           'minutes': round((time.time() - t0) / 60, 2),
           'maps': {a: {str(s): m for s, m in v.items()} for a, v in maps.items()},
           'summary': {a: summary([m for m in v.values() if m is not None])
                       for a, v in maps.items() if any(
                           m is not None for m in v.values())}}
    first5 = args.seeds[:5]
    for arm, v in maps.items():
        done = [v[s] for s in first5 if v.get(s) is not None]
        if len(done) == len(first5):
            out['summary'][arm][f'mean_{first5[0]}_{first5[-1]}'] = \
                statistics.fmean(done)
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog='python -m single_shot_detection_tpu_torch.tools.hflip_injection',
        description=__doc__.splitlines()[0])
    ap.add_argument('--draws', required=True,
                    help='.npz of the JAX engine\'s flips (flips_<seed>)')
    ap.add_argument('--seeds', default='23-32', type=seed_list)
    ap.add_argument('--seed', type=int, default=23, help='with --one')
    ap.add_argument('--train-n', type=int, default=512)
    ap.add_argument('--eval-n', type=int, default=64)
    ap.add_argument('--epochs', type=int, default=60)
    ap.add_argument('--milestones', default='40,52')
    ap.add_argument('--workdir', default=os.path.join(tempfile.gettempdir(),
                                                      'hflip_injection'))
    ap.add_argument('--out', help='write the summary JSON here too')
    ap.add_argument('--cpu', action='store_true')
    ap.add_argument('--one', action='store_true',
                    help='run arm jax for --seed in this process')
    args = ap.parse_args(argv)
    if args.one:
        return {'mAP': run_injected(args)}
    out = run_all(args)
    print(json.dumps(out, indent=2), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == '__main__':
    main()
