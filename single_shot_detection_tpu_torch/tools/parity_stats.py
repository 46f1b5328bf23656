"""Aggregate accuracy-protocol runs into mean / sd / 95% CI.

    python -m single_shot_detection_tpu_torch.tools.parity_stats \
        /tmp/p23 /tmp/p24 ... [--extra REF:OURS ...] [--json]

Port of the JAX package's ``tools/parity_stats.py``, with its text and its
``--json`` output.  Collects ``results.json`` files of ``parity_run`` (one
workdir per seed; only those that hold both a ``reference`` and an
``ours`` entry) plus inline ``--extra REF:OURS`` rows, and prints
per-framework means with the normal-approximation 95% confidence
interval on the mean delta.  Per-seed pairing is meaningless where the
augmentation RNG streams differ (the port draws from torch generators,
the JAX package from JAX counters), so only the means compare.  The port
has no reference arm of its own: the ``--extra`` rows bring in recorded
figures, e.g. the JAX package's per-seed mAP as the "reference" column
and the port's as "ours".
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys


def collect(workdirs):
    rows = []
    for wd in workdirs:
        path = os.path.join(wd, 'results.json')
        if not os.path.exists(path):
            print(f'-- skipping {wd}: no results.json', file=sys.stderr)
            continue
        with open(path) as f:
            r = json.load(f)
        if 'reference' not in r or 'ours' not in r:
            print(f'-- skipping {wd}: incomplete run', file=sys.stderr)
            continue
        rows.append({
            'workdir': wd,
            'reference': float(r['reference']['mAP_by_our_metric']),
            'ours': float(r['ours']['mAP']),
        })
    return rows


def stats(values):
    n = len(values)
    mean = sum(values) / n
    var = sum((v - mean) ** 2 for v in values) / max(n - 1, 1)
    return mean, math.sqrt(var)


def summarize(rows):
    ref = [r['reference'] for r in rows]
    ours = [r['ours'] for r in rows]
    n = len(rows)
    ref_mean, ref_sd = stats(ref)
    ours_mean, ours_sd = stats(ours)
    delta = ours_mean - ref_mean
    # two-sample (Welch) standard error of the difference of means;
    # 1.96 = normal 95% (n >= 20 makes the t correction negligible)
    se = math.sqrt(ref_sd ** 2 / n + ours_sd ** 2 / n)
    return {
        'n': n,
        'reference_mean': round(ref_mean, 4),
        'reference_sd': round(ref_sd, 4),
        'ours_mean': round(ours_mean, 4),
        'ours_sd': round(ours_sd, 4),
        'delta_mean': round(delta, 4),
        'delta_ci95': round(1.96 * se, 4),
        'positive_deltas': sum(o > r for o, r in zip(ours, ref)),
        'negative_deltas': sum(o < r for o, r in zip(ours, ref)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m single_shot_detection_tpu_torch.tools.parity_stats',
        description=__doc__.splitlines()[0])
    ap.add_argument('workdirs', nargs='*', default=[])
    ap.add_argument('--extra', action='append', default=[],
                    metavar='REF:OURS',
                    help='inline row, e.g. 0.712:0.221 (merges recorded '
                         'tables, e.g. PARITY.md round-4 seeds, with '
                         'fresh workdirs)')
    ap.add_argument('--json', action='store_true')
    args = ap.parse_args(argv)
    rows = collect(args.workdirs)
    for spec in args.extra:
        ref, ours = spec.split(':')
        rows.append({'workdir': f'extra{len(rows)}',
                     'reference': float(ref), 'ours': float(ours)})
    if not rows:
        sys.exit('no complete runs found')
    s = summarize(rows)
    if args.json:
        print(json.dumps({'rows': rows, 'summary': s}, indent=2))
        return
    print(f'{"workdir":<12} {"reference":>10} {"ours":>10} {"delta":>8}')
    for r in rows:
        print(f'{os.path.basename(r["workdir"]):<12} '
              f'{r["reference"]:>10.3f} {r["ours"]:>10.3f} '
              f'{r["ours"] - r["reference"]:>+8.3f}')
    print(f'\nn={s["n"]}  reference {s["reference_mean"]} '
          f'(sd {s["reference_sd"]})  ours {s["ours_mean"]} '
          f'(sd {s["ours_sd"]})')
    print(f'mean delta {s["delta_mean"]:+.4f} ± {s["delta_ci95"]} '
          f'(95% CI); signs {s["positive_deltas"]}+ / '
          f'{s["negative_deltas"]}-')


if __name__ == '__main__':
    main()
