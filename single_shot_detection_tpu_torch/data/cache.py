"""On-disk staging cache: decode once, read the staged records every later
epoch.

Port of the JAX package's ``data/cache.py``, with its file layout and its
fingerprint byte for byte, so a cache directory written by either package's
loader is read by the other's without a rebuild.  The loader's host work
per sample (decode, one staging resize, the optional YUV420 packing) is a
pure function of (dataset, staging size, colour space): all randomness
runs after staging, on the device.  So the staged records are kept in
memmaps:

* ``images.u8``: ``[N, record_bytes]`` uint8, the staged pixels;
* ``sizes.u32``: ``[N, 2]`` uint32, each image's original (w, h), from
  which the loader scales the ground truth;
* ``valid.u8``: ``[N]`` uint8, filled lazily as records are first staged;
* ``meta.json``: written last, so its presence certifies full-size data
  files.

A fingerprint of the dataset's length and identities, the staging
geometry, the colour space and the contract's version guards staleness:
a directory that does not match is discarded and rebuilt with a warning,
never served.  ``train.staging_cache: <dir>`` or ``Loader(cache_dir=)``
turns it on; ``tools/stage_dataset.py`` fills one ahead of training.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Optional, Tuple

import numpy as np

_META_NAME = 'meta.json'
_VERSION = 1
_FILES = ('images.u8', 'sizes.u32', 'valid.u8', _META_NAME)


def record_shape(staging_size: Tuple[int, int],
                 colorspace: str) -> Tuple[int, ...]:
    """Shape of one staged image record (a row of the loader's buffer)."""
    w, h = staging_size
    if colorspace == 'yuv420':
        return (w * h * 3 // 2,)
    return (h, w, 3)


def _fingerprint(dataset, staging_size, colorspace: str) -> str:
    """Identity of (dataset contents, staging contract): every image path
    in order for path-backed datasets; for inline ones (``Synthetic``) the
    first image's bytes and every box table's shape.  File times are not
    hashed, so a re-downloaded identical dataset hits."""
    h = hashlib.sha1()
    h.update(f'v{_VERSION}|{len(dataset)}|{tuple(staging_size)}|'
             f'{colorspace}'.encode())
    for ann in dataset.annotations:
        path = ann.get('image_path')
        if path is not None:
            h.update(path.encode())
        else:
            h.update(b'<inline>')
            h.update(str(np.shape(ann.get('boxes'))).encode())
    first = dataset.annotations[0] if len(dataset) else {}
    if 'image' in first:
        h.update(np.ascontiguousarray(first['image']).tobytes())
    return h.hexdigest()


class StagingCache:
    """Lazily filled memmap cache of one loader's staged images.

    ``get(i)`` gives ``(record, (w, h))`` or None; ``put(i, record, (w,
    h))`` stores a freshly staged sample.  One writer (the loader's
    producer thread); readers may be concurrent.
    """

    def __init__(self, directory: str, dataset,
                 staging_size: Tuple[int, int], colorspace: str = 'rgb'):
        self.directory = directory
        self.n = len(dataset)
        if self.n == 0:
            raise ValueError('refusing to cache an empty dataset')
        self.record_shape = record_shape(staging_size, colorspace)
        self._record_bytes = int(np.prod(self.record_shape))
        meta = {
            'version': _VERSION,
            'n': self.n,
            'staging_size': list(staging_size),
            'colorspace': colorspace,
            'record_bytes': self._record_bytes,
            'fingerprint': _fingerprint(dataset, staging_size, colorspace),
        }
        os.makedirs(directory, exist_ok=True)
        meta_path = os.path.join(directory, _META_NAME)
        fresh = True
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    existing = json.load(f)
            except (OSError, ValueError):
                existing = None
            if existing == meta:
                fresh = False
            else:
                logging.warning(
                    f'WW staging cache at {directory} does not match the '
                    'dataset/staging contract — discarding and rebuilding')
                for name in _FILES:
                    try:
                        os.remove(os.path.join(directory, name))
                    except OSError:
                        pass
        mode = 'w+' if fresh else 'r+'
        self.images = np.memmap(os.path.join(directory, 'images.u8'),
                                np.uint8, mode,
                                shape=(self.n, self._record_bytes))
        self.sizes = np.memmap(os.path.join(directory, 'sizes.u32'),
                               np.uint32, mode, shape=(self.n, 2))
        self.valid = np.memmap(os.path.join(directory, 'valid.u8'),
                               np.uint8, mode, shape=(self.n,))
        if fresh:
            self.valid[:] = 0
            self.flush()
            # meta last: its presence certifies the data files exist at
            # full size (a crash mid-creation leaves no meta -> rebuild)
            with open(meta_path, 'w') as f:
                json.dump(meta, f)

    def get(self, i: int) -> Optional[Tuple[np.ndarray, Tuple[int, int]]]:
        if not self.valid[i]:
            return None
        rec = self.images[i].reshape(self.record_shape)
        w, h = self.sizes[i]
        return rec, (int(w), int(h))

    def put(self, i: int, img: np.ndarray, size: Tuple[int, int]) -> None:
        self.images[i] = np.asarray(img, np.uint8).reshape(-1)
        self.sizes[i] = size
        self.valid[i] = 1

    @property
    def complete(self) -> bool:
        return bool(self.valid.all())

    @property
    def hit_count(self) -> int:
        return int(np.count_nonzero(self.valid))

    def flush(self) -> None:
        self.images.flush()
        self.sizes.flush()
        self.valid.flush()
