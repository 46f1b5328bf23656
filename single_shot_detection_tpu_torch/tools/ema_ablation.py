"""Paired-seed EMA ablation on the low-variance parity protocol.

Measures what ``train.ema`` (EMA shadow weights read by eval/serving —
train/step.py, train/engine.py) buys in held-out mAP, with everything else
identical: same staged 512-image synthetic dataset, same config, same
seeds as PARITY.md's decisive comparison, each seed trained twice (EMA
off / EMA on).  Port of the JAX package's ``tools/ema_ablation.py``: the
same arms, config lines, ``results.json`` and table, each arm trained by
``parity_run.run_ours``.

Usage:
  python -m single_shot_detection_tpu_torch.tools.ema_ablation \
      [--workdir DIR] [--seeds 23 24 25 26 27] [--decay 0.999] \
      [--epochs 60] [--cpu]

Appends nothing anywhere automatically — prints a markdown table +
writes results.json under the workdir; docs are updated by hand from it.
"""

import argparse
import json
import os
import tempfile

from single_shot_detection_tpu_torch.tools import parity_run


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m single_shot_detection_tpu_torch.tools.ema_ablation',
        description=__doc__.splitlines()[0])
    ap.add_argument('--workdir', default=os.path.join(
        tempfile.gettempdir(), 'ema_ablation'))
    ap.add_argument('--seeds', type=int, nargs='+',
                    default=[23, 24, 25, 26, 27])
    ap.add_argument('--decay', type=float, default=0.999)
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
        for arm in ('base', 'ema'):
            key = f'{arm}_{seed}'
            if key in results:
                continue
            arm_dir = os.path.join(args.workdir, key)
            os.makedirs(arm_dir, exist_ok=True)
            cfgs = parity_run.write_configs(arm_dir, csvs, args.epochs,
                                            seed, args.milestones)
            cfg_path = cfgs['ours']
            if arm == 'ema':
                with open(cfg_path, 'a') as f:
                    f.write(f"\ntrain['ema'] = {{'decay': {args.decay}}}\n")
            print(f'== {key}: training...', flush=True)
            out = parity_run.run_ours(arm_dir, cfg_path, cpu=args.cpu)
            results[key] = {'mAP': out['mAP'],
                            'minutes': round(out['minutes'], 1)}
            parity_run.save_results(state_path, results)
            print(json.dumps({key: results[key]}), flush=True)

    rows, deltas = [], []
    for seed in args.seeds:
        b = results.get(f'base_{seed}', {}).get('mAP')
        e = results.get(f'ema_{seed}', {}).get('mAP')
        if b is None or e is None:
            continue
        deltas.append(e - b)
        rows.append(f'| {seed} | {b:.3f} | {e:.3f} | {e - b:+.3f} |')
    print('\n| seed | no EMA | EMA | delta |')
    print('|---|---|---|---|')
    print('\n'.join(rows))
    if deltas:
        import numpy as np
        print(f'| mean | | | {np.mean(deltas):+.3f} '
              f'(± {np.std(deltas):.3f}) |')


if __name__ == '__main__':
    main()
