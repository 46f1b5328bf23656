"""Paired-seed QAT ablation on the low-variance parity protocol.

Measures what ``train.qat`` buys end-to-end, with everything else
identical (same staged 512-image synthetic dataset, same seeds as
PARITY.md's decisive comparison).  Per seed, two arms:

  * ``base``: plain training -> held-out float mAP from the run's own
    eval; then an int8 **PTQ** eval of the trained checkpoint
    (``--phases eval --int8`` — activation scales calibrated on eval
    batches);
  * ``qat``: ``train.qat: True`` training -> held-out **fake-quant**
    mAP (eval under QAT runs the quantized-noise forward); then an int8
    eval using the **learned** scales (``--int8`` reads them from the
    convs' ``act_amax`` buffers — no calibration pass).

Port of the JAX package's ``tools/qat_ablation.py``: the same arms, config
lines, ``results.json`` and table; ``run_int8_eval`` runs the port's CLI
with ``--checkpoint DIR --phases eval --int8`` and parses the ``mAP=`` of
its ``[eval]`` line (``train/engine.py``).  ``export/quantize.py``'s gate
refuses int8 for a MobileNet below batch 128 unless the config has
``int8 = {}`` or ``train.qat`` (as the JAX package's does), so at this
protocol's batch 8 the base arm's "PTQ" eval runs in float: its log says
``int8=0.0000`` beside the mAP, the QAT arm's ``int8=1.0000``.

Usage:
  python -m single_shot_detection_tpu_torch.tools.qat_ablation \
      [--workdir DIR] [--seeds 23 24 25] [--epochs 60] [--cpu]

Prints a markdown table + writes results.json under the workdir; docs
are updated by hand from it.
"""

import argparse
import json
import os
import re
import subprocess
import tempfile
import time

from single_shot_detection_tpu_torch.tools import parity_run


def run_int8_eval(workdir, cfg_path, cpu=False):
    """Eval the arm's trained checkpoint with --int8; returns mAP."""
    save = os.path.join(workdir, 'ours_out')
    exp_dir = os.path.join(save, sorted(os.listdir(save))[-1])
    log = os.path.join(workdir, 'int8_eval.log')
    cmd, env = parity_run.cli_command(
        '--config', cfg_path, '--save-dir', save,
        '--checkpoint', exp_dir, '--phases', 'eval', '--int8')
    if cpu:
        cmd.append('--cpu')
    with open(log, 'w') as lf:
        subprocess.run(cmd, env=env, cwd=parity_run.ROOT, stdout=lf,
                       stderr=subprocess.STDOUT, check=True)
    with open(log) as f:
        text = f.read()
    maps = re.findall(r'\bmAP=([0-9.]+)', text)
    if not maps:
        raise RuntimeError(f'no mAP line in {log}')
    return float(maps[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m single_shot_detection_tpu_torch.tools.qat_ablation',
        description=__doc__.splitlines()[0])
    ap.add_argument('--workdir', default=os.path.join(
        tempfile.gettempdir(), 'qat_ablation'))
    ap.add_argument('--seeds', type=int, nargs='+', default=[23, 24, 25])
    ap.add_argument('--epochs', type=int, default=60)
    ap.add_argument('--train-n', type=int, default=512)
    ap.add_argument('--eval-n', type=int, default=64)
    ap.add_argument('--milestones', default='40,52')
    ap.add_argument('--cpu', action='store_true')
    args = ap.parse_args(argv)

    parity_run.TRAIN_N, parity_run.EVAL_N = args.train_n, args.eval_n
    os.makedirs(args.workdir, exist_ok=True)
    csvs = parity_run.stage_dataset(args.workdir)

    state_path = os.path.join(args.workdir, 'results.json')
    results = parity_run.load_results(state_path)

    for seed in args.seeds:
        for arm in ('base', 'qat'):
            key = f'{arm}_{seed}'
            if 'int8_mAP' in results.get(key, {}):
                continue
            arm_dir = os.path.join(args.workdir, key)
            os.makedirs(arm_dir, exist_ok=True)
            cfg_path = os.path.join(arm_dir, 'config_ours.py')
            # Train unless this arm already has a trained result (a crash
            # during the cheap int8 eval must not discard the ~15-min
            # training run on resume — results.json is written after each
            # stage, not only at arm completion).
            if key not in results:
                cfgs = parity_run.write_configs(arm_dir, csvs, args.epochs,
                                                seed, args.milestones)
                cfg_path = cfgs['ours']
                if arm == 'qat':
                    with open(cfg_path, 'a') as f:
                        f.write("\ntrain['qat'] = True\n")
                print(f'== {key}: training...', flush=True)
                t0 = time.time()
                out = parity_run.run_ours(arm_dir, cfg_path, cpu=args.cpu)
                results[key] = {'mAP': out['mAP'],
                                'minutes': round((time.time() - t0) / 60.0,
                                                 1)}
                parity_run.save_results(state_path, results)
            print(f'== {key}: int8 eval...', flush=True)
            results[key]['int8_mAP'] = run_int8_eval(arm_dir, cfg_path,
                                                     cpu=args.cpu)
            parity_run.save_results(state_path, results)
            print(json.dumps({key: results[key]}), flush=True)

    rows, deltas = [], []
    for seed in args.seeds:
        b = results.get(f'base_{seed}')
        q = results.get(f'qat_{seed}')
        if not b or not q or 'int8_mAP' not in b or 'int8_mAP' not in q:
            continue
        deltas.append(q['int8_mAP'] - b['int8_mAP'])
        rows.append(f"| {seed} | {b['mAP']:.3f} | {b['int8_mAP']:.3f} "
                    f"| {q['mAP']:.3f} | {q['int8_mAP']:.3f} "
                    f"| {deltas[-1]:+.3f} |")
    print('\n| seed | float | int8 PTQ | QAT (fake-quant eval) '
          '| int8 from QAT | int8 delta |')
    print('|---|---|---|---|---|---|')
    print('\n'.join(rows))
    if deltas:
        import numpy as np
        print(f'| mean | | | | | {np.mean(deltas):+.3f} '
              f'(± {np.std(deltas):.3f}) |')


if __name__ == '__main__':
    main()
