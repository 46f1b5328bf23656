"""Fill the on-disk staging cache of a config's datasets ahead of training.

    python -m single_shot_detection_tpu_torch.tools.stage_dataset \\
        --config samples/ssd_mb2_voc.py --cache-dir /data/voc_staged

The staging cache (``data/cache.py``) keeps the loader's deterministic host
work per image (the JPEG decode, the staging resize and, at
``staging_colorspace='yuv420'``, the packing) so that training never
decodes after its first epoch.  It fills during the first epoch anyway;
this tool does it beforehand with the port's ``Loader``, one subdirectory
per phase, at the config's ``train.staging_size`` and
``train.staging_colorspace``.  Then train with ``train.staging_cache`` set
to the same directory.  The directory is the JAX package's format: either
package's loader reads what the other's wrote.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m single_shot_detection_tpu_torch.tools.stage_dataset')
    parser.add_argument('--config', required=True,
                        help='Config file whose datasets to stage')
    parser.add_argument('--cache-dir', required=True,
                        help='Cache directory (one subdirectory per phase)')
    parser.add_argument('--phases', nargs='+', default=['train', 'eval'],
                        choices=['train', 'eval'])
    parser.add_argument('--batch-size', type=int, default=64,
                        help='Decode batch size (throughput only)')
    parser.add_argument('--num-workers', type=int, default=4)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format='%(message)s')

    from single_shot_detection_tpu_torch.data.loader import Loader
    from single_shot_detection_tpu_torch.train.engine import create_datasets
    from single_shot_detection_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, phases=args.phases)
    datasets = create_datasets(dict(cfg.dataset), args.phases)
    if not datasets:
        logging.error('XX config has no datasets for the requested phases')
        return 1
    train_cfg = dict(cfg.train or {})
    staging = tuple(train_cfg.get('staging_size', cfg.input_size))
    colorspace = str(train_cfg.get('staging_colorspace', 'rgb'))
    for phase, dataset in datasets.items():
        loader = Loader(dataset, batch_size=args.batch_size,
                        staging_size=staging, num_workers=args.num_workers,
                        staging_colorspace=colorspace,
                        cache_dir=os.path.join(args.cache_dir, phase))
        if loader.cache.complete:
            logging.info(f'== {phase}: cache already complete '
                         f'({loader.cache.n} images)')
            continue
        start = time.perf_counter()
        n = 0
        for batch in loader:
            n += int((batch['ids'] >= 0).sum())
            print(f'\r== {phase}: {loader.cache.hit_count}/{loader.cache.n} '
                  'staged', end='', flush=True)
        loader.cache.flush()
        seconds = time.perf_counter() - start
        print()
        logging.info(f'== {phase}: {loader.cache.hit_count}/{loader.cache.n} '
                     f'images staged in {seconds:.1f}s '
                     f'({n / max(seconds, 1e-9):.0f} img/s)')
    return 0


if __name__ == '__main__':
    sys.exit(main())
