"""Export a checkpoint as the reference's torch checkpoint.

    python -m single_shot_detection_tpu_torch.tools.export_torch_ckpt \
        --config samples/ssd_mb2_voc.py --checkpoint RUN_DIR \
        --output ssd_mb2_voc.pt

Port of the JAX package's ``tools/export_torch_ckpt.py``, with its flags.
``--checkpoint`` is a ``ckpt-N.pt`` of the port, a ``ckpt-N.msgpack`` of
the JAX package or a run directory (its latest checkpoint,
``train/checkpoint.py::find_latest``).  The weights load into the
config's detector, built on the CPU (a config that does not match the
checkpoint fails there), and go out through
``utils/torch_import.py::export_reference_checkpoint``: a ``torch.save``
global_state ``{'model_dict', 'epoch', 'global_step'}`` that the reference
writes and loads, the step and the epoch from the checkpoint's
``.meta.json``.  The EMA shadow, where the run kept one, replaces the
parameters unless ``--no-ema`` is given.  No GPU is needed: it is a weight
conversion.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence

from single_shot_detection_tpu_torch.models import builder
from single_shot_detection_tpu_torch.train import checkpoint as ckpt
from single_shot_detection_tpu_torch.utils import torch_import
from single_shot_detection_tpu_torch.utils.config import load_config
from single_shot_detection_tpu_torch.utils.weights import reconcile_qat


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m single_shot_detection_tpu_torch.tools.export_torch_ckpt',
        description=__doc__.splitlines()[0])
    parser.add_argument('--config', required=True,
                        help='Config the checkpoint was trained with')
    parser.add_argument('--checkpoint', required=True,
                        help='ckpt-N.pt or ckpt-N.msgpack file, or a run '
                             'directory (its latest checkpoint is picked)')
    parser.add_argument('--output', required=True,
                        help='Output .pt path (reference ckpt-N.pt format)')
    parser.add_argument('--no-ema', action='store_true',
                        help='Export the live params even when the run '
                             'kept an EMA shadow')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format='%(message)s')

    cfg = load_config(args.config)
    model_cfg = dict(cfg.model)
    detector_cfg = dict(model_cfg.get('detector', {}))
    path = ckpt.find_latest(args.checkpoint)
    if path is None:
        sys.exit(f'no checkpoint found at {args.checkpoint}')
    saved = ckpt.read_weights(path)
    model = builder.build(
        base=model_cfg['base'],
        anchor_generator=model_cfg['anchor_generator'],
        input_size=tuple(cfg.input_size),
        **{k: v for k, v in detector_cfg.items()
           if k in builder.DETECTOR_KEYS}).module
    template = model.state_dict()
    model.load_state_dict(reconcile_qat(saved['model'], template), strict=True)
    state = model.state_dict()
    if saved['ema'] and not args.no_ema:
        print('>> exporting the EMA shadow weights (--no-ema for live)')
        params = dict(model.named_parameters())
        if saved['ema'].keys() != params.keys():
            sys.exit(f'{path}: the EMA shadow does not name the model\'s '
                     'parameters')
        state.update(saved['ema'])
    meta = saved['meta']
    torch_import.export_reference_checkpoint(
        args.output, state, epoch=int(meta.get('epoch', 0)),
        global_step=int(meta.get('global_step', 0)),
        **torch_import.mapping_args_from_config(model_cfg))
    print(f'>> wrote {args.output} (reference torch checkpoint, '
          f'step {meta.get("global_step", 0)})')
    return 0


if __name__ == '__main__':
    sys.exit(main())
