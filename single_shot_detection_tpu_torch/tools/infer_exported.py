"""Standalone inference on an exported ``.pt2`` artifact.

Port of the JAX package's ``tools/infer_exported.py``.  It consumes
``export = {'standalone': True}`` artifacts (``export/__init__.py``): the
program closes over the weights, the normalization and the NMS, so this
tool needs torch, numpy, PIL (for image files) and the port's NMS op
(``ops/nms_kernel.py``, imported by the loader): no config, no checkpoint,
no model code.  The artifact runs on the device it was exported on, under
the numeric flags recorded in it.

Usage:
    python -m single_shot_detection_tpu_torch.tools.infer_exported \\
        exported/model.pt2 img1.jpg ...
    python -m single_shot_detection_tpu_torch.tools.infer_exported \\
        exported/model.pt2 --synthetic

Input images are resized to the artifact's (H, W) and fed as raw 0-255 RGB
floats; the artifact normalizes them.  Output rows: x1 y1 x2 y2 class score
(in resized-image pixels, 1-based class ids), one block per image.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from single_shot_detection_tpu_torch.export import load_exported_with_spec


def load_artifact(path: str):
    """Returns ``(callable, (batch, height, width))`` from the artifact
    alone."""
    call, specs = load_exported_with_spec(path)
    if len(specs) != 1:
        raise SystemExit(
            f'{path} takes {len(specs)} inputs — not a standalone '
            "artifact (re-export with export = {'standalone': True} or "
            'bake_variables=True)')
    b, h, w, _ = specs[0].shape
    return call, (b, h, w)


def load_images(paths, size_hw, batch) -> np.ndarray:
    """Up to ``batch`` images, resized, in a zero-padded f32 ``[batch, h,
    w, 3]`` array."""
    from PIL import Image
    h, w = size_hw
    imgs = np.zeros((batch, h, w, 3), np.float32)
    for i, p in enumerate(paths[:batch]):
        with Image.open(p) as im:
            imgs[i] = np.asarray(
                im.convert('RGB').resize((w, h), Image.BILINEAR), np.float32)
    return imgs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('artifact', help='path to the exported .pt2 file')
    ap.add_argument('images', nargs='*', help='image files (resized to fit)')
    ap.add_argument('--synthetic', action='store_true',
                    help='run on random data (artifact smoke test)')
    ap.add_argument('--min-score', type=float, default=0.3)
    args = ap.parse_args(argv)

    call, (batch, h, w) = load_artifact(args.artifact)
    print(f'>> artifact expects [{batch}, {h}, {w}, 3] raw RGB', flush=True)

    if args.synthetic:
        chunks = [[f'synthetic[{i}]' for i in range(batch)]]
        synth = (np.random.RandomState(0).rand(batch, h, w, 3) * 255
                 ).astype(np.float32)
    elif args.images:
        # the batch is fixed in the artifact: ceil(N / batch) calls, the
        # padding slots zero-filled and their outputs never printed
        chunks = [args.images[i:i + batch]
                  for i in range(0, len(args.images), batch)]
        synth = None
    else:
        ap.error('give image files or --synthetic')

    total_ms = 0.0
    warm = False
    for names in chunks:
        imgs = synth if synth is not None else load_images(names, (h, w),
                                                           batch)
        if not warm:
            call(imgs)  # the first call loads and builds: not timed
            warm = True
        t0 = time.perf_counter()
        dets, valid = call(imgs)
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        total_ms += (time.perf_counter() - t0) * 1e3

        for i, name in enumerate(names):
            rows = dets[i][valid[i] & (dets[i][:, 5] >= args.min_score)]
            print(f'{name}: {len(rows)} detections')
            for x1, y1, x2, y2, cls, score in rows:
                print(f'  [{x1:8.2f} {y1:8.2f} {x2:8.2f} {y2:8.2f}] '
                      f'score={score:.3f} class={int(cls)}')
    n_calls = len(chunks)
    print(f'>> inference: {total_ms:.2f} ms for {n_calls} '
          f'call{"s" if n_calls != 1 else ""} of batch {batch}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
