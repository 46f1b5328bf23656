"""The accuracy protocol's own arm: train the port from scratch on staged
synthetic data and read its held-out mAP.

    python -m single_shot_detection_tpu_torch.tools.parity_run --skip-reference \
        --train-n 512 --eval-n 64 --epochs 60 --milestones 40,52 --seed 23

Port of the JAX package's ``tools/parity_run.py``, with its flags, its
staged data and its configs.  ``stage_dataset`` exports the ``Synthetic``
dataset (``data/datasets.py``) as JPEGs and Csv files in both dialects
(``ours`` keeps the extension; the reference's appends ``.jpg`` itself
and wants numeric class and score columns), byte for byte what the JAX
tool writes; ``write_configs`` writes the same config text for each
model family and augmentation chain; ``run_ours`` trains
``python -m single_shot_detection_tpu_torch --config ... --save-dir ...``
(on the card unless ``--ours-cpu``) and reads the last ``eval_mAP`` of
the run's ``log.csv``.  ``results.json`` under the workdir keeps the JAX
tool's keys.

The reference arm (the JAX tool's ``run_reference``: the reference
implementation, ``georgymironov/single_shot_detection``, trained as-is on
the same files with its eval predictions scored by the repo's metric) is
not ported: it needs a checkout of the reference, which the JAX tool reads
from ``$SSD_REFERENCE_PATH``.  So ``--skip-reference`` is required, and a
run without it stops with that message.  A workdir whose ``results.json``
already holds the JAX tool's ``reference`` entry gets its ``delta_mAP``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

IMG = 128
TRAIN_N, EVAL_N = 96, 16
NUM_CLASSES = 5
BATCH = 8

REFERENCE_ARM_MISSING = (
    'the reference arm is not ported: it trains the reference '
    'implementation (georgymironov/single_shot_detection) from a checkout '
    "that the JAX package's tools/parity_run.py reads from "
    '$SSD_REFERENCE_PATH; pass --skip-reference to run this arm alone')

# per-family model/detection-math sections (--family), the JAX tool's text.
# 'ssd_mb2' mirrors the JAX package's learning-evidence config;
# 'retina_mb1' exercises a disjoint code-path set: FPN neck,
# SharedConvPredictor towers, retina anchor generator, SigmoidFocalLoss +
# naive sampler, SIGMOID score converter, config 'initializer' dicts.  Both
# templates are valid for the reference too (the config dict is the shared
# public API); backbones are the custom MobileNets because the reference's
# torchvision backbones need a download.
FAMILY_SECTIONS = {
    'ssd_mb2': """
model = {{
    'base': {{'name': 'mobilenet_v2_035'}},
    'detector': {{
        'num_classes': {num_classes},
        'use_depthwise': True,
        'features': {{'name': 'Features', 'out_layers': (13, 18)}},
        'extras': {{'layers': (('s', 128),)}},
    }},
    'anchor_generator': {{
        'type': 'ssd',
        'num_scales': 3,
        'min_scale': 0.15,
        'max_scale': 0.95,
        'aspect_ratios': [[1.0, 2.0]] * 3,
    }},
}}

sampler = {{
    'name': 'hard_negative_mining',
    'negative_per_positive_ratio': 3,
    'min_negative_per_image': 5,
}}

loss = {{
    'classification_loss': {{'name': 'CrossEntropyLoss'}},
    'localization_loss': {{'name': 'SmoothL1Loss'}},
    'classification_weight': 1.0,
    'localization_weight': 1.0,
}}

postprocess = {{
    'score_threshold': 0.1,
    'max_total': 50,
    'nms': {{'max_per_class': 20, 'overlap_threshold': 0.45}},
    'score_converter': 'SOFTMAX',
}}

target_assigner = {{'matched_threshold': 0.5, 'unmatched_threshold': 0.5}}
""",
    'm2det_mb2': """
model = {{
    'base': {{'name': 'mobilenet_v2_035'}},
    'detector': {{
        'num_classes': {num_classes},
        'features': {{'name': 'MultilevelFeaturePyramid',
                     'out_layers': (13, 18),
                     'num_scales': 3,
                     'num_tums': 2,
                     'base_reduced_channels': [64, 64],
                     'reduced_channels': 32,
                     'tum': {{'inner_channels': 64, 'out_channels': 32}}}},
    }},
    'anchor_generator': {{
        'type': 'ssd',
        'num_scales': 3,
        'min_scale': 0.15,
        'max_scale': 0.95,
        'aspect_ratios': [[1.0, 2.0]] * 3,
    }},
}}

sampler = {{
    'name': 'hard_negative_mining',
    'negative_per_positive_ratio': 3,
    'min_negative_per_image': 5,
}}

loss = {{
    'classification_loss': {{'name': 'CrossEntropyLoss'}},
    'localization_loss': {{'name': 'SmoothL1Loss'}},
    'classification_weight': 1.0,
    'localization_weight': 1.0,
}}

postprocess = {{
    'score_threshold': 0.1,
    'max_total': 50,
    'nms': {{'max_per_class': 20, 'overlap_threshold': 0.45}},
    'score_converter': 'SOFTMAX',
}}

target_assigner = {{'matched_threshold': 0.5, 'unmatched_threshold': 0.5}}
""",
    'retina_mb1': """
model = {{
    'base': {{'name': 'mobilenet_050'}},
    'detector': {{
        'num_classes': {num_classes},
        'use_depthwise': False,
        'features': {{'name': 'FeaturePyramid', 'out_layers': (5, 11, 13),
                     'pyramid_layers': 4, 'pyramid_channels': 64,
                     'initializer': {{'name': 'normal_',
                                     'args': {{'mean': 0, 'std': 0.03}}}}}},
        'predictor': {{'num_layers': 2, 'num_channels': 64, 'kernel_size': 3,
                      'activation': {{'name': 'ReLU',
                                     'args': {{'inplace': True}}}},
                      'initializer': {{'name': 'normal_',
                                      'args': {{'mean': 0, 'std': 0.01}}}}}},
        'heads': {{'initializer': {{'name': 'normal_',
                                  'args': {{'mean': 0, 'std': 0.01}}}},
                  'score_head_bias_init': -4.6}},
    }},
    'anchor_generator': {{
        'type': 'retina_net',
        'min_level': 3,
        'max_level': 6,
        'aspect_ratios': [1.0, 2.0, 0.5],
        'scale': 4.0,
        'scales_per_level': 2,
    }},
}}

sampler = {{
    'name': 'naive_sampler',
}}

loss = {{
    'classification_loss': {{'name': 'SigmoidFocalLoss', 'gamma': 2.0,
                            'alpha': 0.25}},
    'localization_loss': {{'name': 'SmoothL1Loss'}},
    'classification_weight': 1.0,
    'localization_weight': 1.0,
}}

postprocess = {{
    'score_threshold': 0.05,
    'max_total': 50,
    'nms': {{'max_per_class': 20, 'overlap_threshold': 0.5}},
    'score_converter': 'SIGMOID',
}}

target_assigner = {{'matched_threshold': 0.5, 'unmatched_threshold': 0.4}}
""",
}

# matched experiment hyperparameters.  Two augmentation chains:
#   hflip — the round-3 protocol (geometric flip only);
#   full  — the reference flagship chain MINUS RandomAdjustHueSaturation
#           (the only member that needs real OpenCV — HSV conversion;
#           brightness/contrast/expand/crop are pure numpy on the
#           reference side, bf/preprocessing/transforms.py:50-131 +
#           functional/img.py:55-113, so both frameworks run them).
AUG_CHAINS = {
    'hflip': """
augmentations = [
    {{'name': 'RandomHorizontalFlip'}},
]
""",
    'full': """
augmentations = [
    {{'name': 'ToFloat'}},
    {{'name': 'RandomAdjustBrightness', 'args': {{'max_brightness_delta': .15}}}},
    {{'name': 'RandomAdjustContrast', 'args': {{'contrast_delta_range': (.5, 1.5)}}}},
    {{'name': 'RandomExpand', 'args': {{'aspect_ratio_range': (0.5, 2.0), 'area_range': (1.0, 16.0)}}}},
    {{
        'name': 'OneOf',
        'args': {{
            'transforms': [
                {{'name': 'Identity'}},
                {{'name': 'RandomCrop', 'args': {{'min_iou': .0}}}},
                {{'name': 'RandomCrop', 'args': {{'min_iou': .1}}}},
                {{'name': 'RandomCrop', 'args': {{'min_iou': .3}}}},
                {{'name': 'RandomCrop', 'args': {{'min_iou': .5}}}},
                {{'name': 'RandomCrop', 'args': {{'min_iou': .7}}}},
                {{'name': 'RandomCrop', 'args': {{'min_iou': .9}}}},
            ]
        }}
    }},
    {{'name': 'RandomHorizontalFlip'}},
]
""",
}

COMMON_CFG = """
seed = {seed}
{family_sections}
box_coder = {{'xy_scale': 10.0, 'wh_scale': 5.0}}
{aug_chain}

preprocessing = [
    {{'name': 'ToFloatTensor', 'args': {{'normalize': True}}}},
    {{'name': 'Normalize',
     'args': {{'mean': [0.485, 0.456, 0.406], 'std': [0.229, 0.224, 0.225]}}}},
]

input_size = ({img}, {img})

dataset = {{
    'train': {{'name': 'Csv', 'path': r'{train_csv}'}},
    'eval': {{'name': 'Csv', 'path': r'{eval_csv}'}},
    'labels': {labels},
}}

batch_size = {batch}
shuffle = True
num_workers = 1

train = {{
    'accumulation_steps': 1,
    'epochs': {epochs},
    'eval_every': {eval_every},
    'max_gt': 8,
    'optimizer': {{'name': 'SGD', 'lr': {lr}, 'momentum': 0.9}},
    'scheduler': {{'name': 'MultiStepLR', 'milestones': [{milestones}],
                  'gamma': 0.1}},
}}
"""
# NB: the reference's CosineAnnealingWithWarmupLR cannot be built through its
# own config path (schedulers.py defines it via __new__ only, so
# train_builder.py:38's __init__.__code__ kwarg filter crashes) — MultiStepLR
# is the scheduler its shipped samples actually use (ssd_mb2_voc.py:119-123).

# The reference's model registry / anchor schema are intentionally
# config-compatible; the only difference between the two config files is
# the Csv name column (the reference appends '.jpg' itself, csv.py:41).


def stage_dataset(workdir):
    """Export the Synthetic dataset (data/datasets.py) as JPEGs + Csv in
    BOTH frameworks' csv dialects (ours keeps the extension; the reference
    appends '.jpg' itself and wants numeric class+score columns)."""
    from PIL import Image

    from single_shot_detection_tpu_torch.data.datasets import Synthetic

    img_dir = os.path.join(workdir, 'data')
    os.makedirs(img_dir, exist_ok=True)
    csvs = {}
    for split, num, seed in (('train', TRAIN_N, 1), ('eval', EVAL_N, 2)):
        ds = Synthetic(num_images=num, image_size=IMG,
                       num_classes=NUM_CLASSES, max_boxes=3, seed=seed)
        ours_rows, ref_rows = [], []
        for i, ann in enumerate(ds.annotations):
            name = f'{split}_{i:04d}'
            Image.fromarray(ann['image']).save(
                os.path.join(img_dir, name + '.jpg'), quality=95)
            for b in ann['boxes']:
                x0, y0, x1, y1, cls, score = b
                ours_rows.append(f'{name}.jpg,{x0:.0f},{y0:.0f},{x1:.0f},'
                                 f'{y1:.0f},{int(cls)}')
                ref_rows.append(f'{name},{x0:.0f},{y0:.0f},{x1:.0f},'
                                f'{y1:.0f},{int(cls)},1.0')
        for flavor, rows in (('ours', ours_rows), ('ref', ref_rows)):
            path = os.path.join(img_dir, f'{split}_{flavor}.csv')
            with open(path, 'w') as f:
                f.write('\n'.join(rows) + '\n')
            csvs[(split, flavor)] = path
    return csvs


def write_configs(workdir, csvs, epochs, seed=23, milestones='100,130',
                  family='ssd_mb2', lr=2e-3, aug='hflip'):
    labels = repr(['background'] + [f'class_{i}'
                                    for i in range(1, NUM_CLASSES)])
    # splice the family/augmentation text in FIRST (they use the same
    # {{...}} escaping), then format the whole config once
    template = (COMMON_CFG
                .replace('{family_sections}', FAMILY_SECTIONS[family])
                .replace('{aug_chain}', AUG_CHAINS[aug]))
    out = {}
    for flavor in ('ours', 'ref'):
        cfg = template.format(
            num_classes=NUM_CLASSES, img=IMG, batch=BATCH, epochs=epochs,
            eval_every=epochs, labels=labels, seed=seed,
            milestones=milestones, lr=lr,
            train_csv=csvs[('train', flavor)],
            eval_csv=csvs[('eval', flavor)])
        path = os.path.join(workdir, f'config_{flavor}.py')
        with open(path, 'w') as f:
            f.write(cfg)
        out[flavor] = path
    return out


def cli_command(*args: str):
    """``python -m single_shot_detection_tpu_torch`` with ``args``, and the
    environment that finds this checkout's package."""
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
    return [sys.executable, '-m', 'single_shot_detection_tpu_torch',
            *args], env


def last_eval_map(save: str) -> float:
    """The last ``eval_mAP`` in ``log.csv`` of the newest run under
    ``save`` (``train/engine.py`` writes one row per epoch)."""
    exp_dirs = sorted(os.listdir(save))
    csv_path = os.path.join(save, exp_dirs[-1], 'log.csv')
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    maps = [float(r['eval_mAP']) for r in rows if r.get('eval_mAP')]
    if not maps:
        raise RuntimeError(f'no eval_mAP in {csv_path}')
    return maps[-1]


def load_results(path: str) -> dict:
    """``results.json`` of a workdir, or ``{}`` before its first run."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def save_results(path: str, results: dict) -> None:
    with open(path, 'w') as f:
        json.dump(results, f, indent=2)


def run_ours(workdir, cfg_path, cpu=False, matmul_precision=None):
    save = os.path.join(workdir, 'ours_out')
    log = os.path.join(workdir, 'ours.log')
    cmd, env = cli_command('--config', cfg_path, '--save-dir', save)
    if cpu:
        cmd.append('--cpu')
    if matmul_precision:
        cmd += ['--matmul-precision', matmul_precision]
    t0 = time.time()
    with open(log, 'w') as lf:
        subprocess.run(cmd, env=env, cwd=ROOT, stdout=lf,
                       stderr=subprocess.STDOUT, check=True)
    return {'mAP': last_eval_map(save),
            'minutes': (time.time() - t0) / 60.0, 'log': log}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog='python -m single_shot_detection_tpu_torch.tools.parity_run',
        description=__doc__.splitlines()[0])
    ap.add_argument('--workdir',
                    default=os.path.join(tempfile.gettempdir(), 'parity_run'))
    ap.add_argument('--epochs', type=int, default=150)
    ap.add_argument('--seed', type=int, default=23)
    ap.add_argument('--train-n', type=int, default=96)
    ap.add_argument('--eval-n', type=int, default=16)
    ap.add_argument('--milestones', default='100,130')
    ap.add_argument('--family', default='ssd_mb2',
                    choices=sorted(FAMILY_SECTIONS),
                    help='model/detection-math family (retina_mb1 exercises '
                         'FPN + SharedConvPredictor + retina anchors + '
                         'focal loss cross-framework)')
    ap.add_argument('--lr', type=float, default=None,
                    help='SGD learning rate (default: 2e-3 ssd_mb2, '
                         '1e-3 retina_mb1)')
    ap.add_argument('--ours-cpu', action='store_true')
    ap.add_argument('--ours-matmul-precision', default=None,
                    choices=['default', 'high', 'highest',
                             'bfloat16', 'tensorfloat32', 'float32'],
                    help="override the port's matmul precision (an f32 run "
                         "defaults to 'highest': TF32 off)")
    ap.add_argument('--skip-reference', action='store_true',
                    help='required: the reference arm is not ported')
    ap.add_argument('--skip-ours', action='store_true')
    ap.add_argument('--aug', default='hflip', choices=sorted(AUG_CHAINS),
                    help="augmentation chain: 'hflip' (round-3 protocol) or "
                         "'full' (the reference flagship chain minus the "
                         "cv2-only HueSaturation: brightness, contrast, "
                         "expand, OneOf(crops), hflip)")
    args = ap.parse_args(argv)
    if not args.skip_reference:
        sys.exit(f'parity_run: {REFERENCE_ARM_MISSING}')

    global TRAIN_N, EVAL_N
    TRAIN_N, EVAL_N = args.train_n, args.eval_n

    os.makedirs(args.workdir, exist_ok=True)
    csvs = stage_dataset(args.workdir)
    lr = args.lr if args.lr is not None else \
        {'ssd_mb2': 2e-3, 'retina_mb1': 1e-3, 'm2det_mb2': 2e-3}[args.family]
    cfgs = write_configs(args.workdir, csvs, args.epochs, args.seed,
                         args.milestones, family=args.family, lr=lr,
                         aug=args.aug)
    print(f'staged dataset + configs under {args.workdir}', flush=True)

    state_path = os.path.join(args.workdir, 'results.json')
    results = load_results(state_path)

    if not args.skip_ours:
        print('training this framework...', flush=True)
        ours = run_ours(args.workdir, cfgs['ours'], cpu=args.ours_cpu,
                        matmul_precision=args.ours_matmul_precision)
        results['ours'] = {'mAP': ours['mAP'],
                           'minutes': round(ours['minutes'], 1)}
        save_results(state_path, results)
        print(json.dumps(results['ours']), flush=True)

    if 'reference' in results and 'ours' in results:
        delta = results['ours']['mAP'] - results['reference']['mAP_by_our_metric']
        results['delta_mAP'] = round(delta, 4)
        save_results(state_path, results)
        print(json.dumps(results, indent=2))


if __name__ == '__main__':
    main()
