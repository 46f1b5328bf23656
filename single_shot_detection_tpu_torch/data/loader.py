"""Batch loader: host decode and staging -> padded fixed-shape numpy batches.

Port of the JAX package's ``data/loader.py``: decode on host threads, one
staging resize to ``staging_size``, and padded ``[B, max_gt, 7]`` ground
truth with a validity mask, in the same global order (a permutation seeded
by ``seed + epoch``), with the same ``drop_last``, the eval batch twice the
train batch, and ``ids = -1`` on the padding rows of a partial batch.
Everything else (augmentation, normalization) runs on the device
(``data/transforms.py``).

The staging resize is :func:`data.preprocess.stage_images`, cv2's
``INTER_LINEAR`` arithmetic bit for bit in int32 tensor ops, one call per
run of same-size images of a batch.  It runs on CPU tensors unless
``staging_device`` names a CUDA device: then each batch crosses to the card
at its source size, is staged there on a stream of its own, and comes back
as the same numpy batch (integer arithmetic, so equal on either device;
``chip_smoke.py`` phase 9 times the loader with either).

A batch whose every path is a ``.jpg``/``.jpeg`` is decoded and staged by
the C++ decoder instead (``data/native.py``, DCT-scaled as in JAX), exactly
where the JAX loader takes it, so JPEG batches equal the JAX package's; a
slot it failed to decode, a batch with another file type or inline images,
and every batch when the library is unavailable, take the path above.
``staging_colorspace='yuv420'`` stages packed planar YUV420 ``[B,
H*W*3/2]`` (1.5 bytes a pixel; even staging sizes only), which the
``Pipeline`` turns back into RGB on the device; ``cache_dir`` keeps the
staged records in an on-disk ``StagingCache`` (``data/cache.py``).

A run of several processes (``process_count``, ``process_index``) shards
the order as the JAX loader does, in place of torch's
``DistributedSampler``: the global order is wrap-padded to a multiple of
``process_count`` and process ``r`` takes ``order[r::process_count]``, so
every process emits the same number of batches.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from single_shot_detection_tpu_torch.data import native
from single_shot_detection_tpu_torch.data.cache import StagingCache, record_shape
from single_shot_detection_tpu_torch.data.preprocess import stage_images


class Loader:
    """Iterates padded numpy batches ``{'image', 'boxes', 'box_mask', 'ids'}``.

    ``image`` is staged uint8 ``[B, S, S, 3]`` (``[B, S*S*3/2]`` at
    ``staging_colorspace='yuv420'``); ``boxes`` ``[B, max_gt, 7]``
    in staged pixels (difficult column zero-filled when absent); ``ids`` the
    dataset index of each row, -1 on padding rows.
    """

    def __init__(self,
                 dataset,
                 batch_size: int,
                 staging_size: Tuple[int, int],
                 shuffle: bool = False,
                 drop_last: bool = False,
                 max_gt: int = 100,
                 seed: int = 23,
                 num_workers: int = 4,
                 prefetch: int = 2,
                 staging_colorspace: str = 'rgb',
                 cache_dir: Optional[str] = None,
                 staging_device: Optional[torch.device] = None,
                 process_count: int = 1,
                 process_index: int = 0):
        self.staging_device = torch.device(staging_device or 'cpu')
        self.process_count = int(process_count)
        self.process_index = int(process_index)
        self._stream = None  # the staging stream on a CUDA staging device
        self.dataset = dataset
        self.batch_size = batch_size
        self.staging_size = tuple(staging_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.max_gt = max_gt
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.epoch = 0
        if staging_colorspace not in ('rgb', 'yuv420'):
            raise ValueError(f'staging_colorspace {staging_colorspace!r}: '
                             "expected 'rgb' or 'yuv420'")
        if staging_colorspace == 'yuv420' and (
                self.staging_size[0] % 2 or self.staging_size[1] % 2):
            raise ValueError('yuv420 staging needs even staging dims, got '
                             f'{self.staging_size}')
        self.staging_colorspace = staging_colorspace
        self.cache = (StagingCache(cache_dir, dataset, self.staging_size,
                                   staging_colorspace) if cache_dir else None)

    def _global_order(self) -> np.ndarray:
        """The (seed + epoch)-deterministic permutation of the dataset,
        wrap-padded to a multiple of ``process_count`` (the device cache
        builds every rank's batches from it)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        pad = (-len(order)) % self.process_count
        if pad:
            order = np.concatenate([order, order[:pad]])
        return order

    def _indices(self) -> np.ndarray:
        """This process's rows of :meth:`_global_order`."""
        return self._global_order()[self.process_index::self.process_count]

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _native_fill(self, idxs, rows_out: np.ndarray) -> Optional[np.ndarray]:
        """Decode and stage ``idxs`` with the C++ decoder when every one is
        a JPEG file; their original sizes (0 for a failed slot), or None
        to take the Python path."""
        paths = []
        for i in idxs:
            path = self.dataset.annotations[int(i)].get('image_path', '')
            if not native.is_jpeg(path):
                return None
            paths.append(path)
        if self.staging_colorspace == 'yuv420':
            return native.decode_batch_into_yuv420(
                paths, rows_out, self.staging_size,
                num_threads=self.num_workers)
        return native.decode_batch_into(paths, rows_out,
                                        num_threads=self.num_workers)

    def _stage_python(self, idxs, rows_out: np.ndarray,
                      pool: ThreadPoolExecutor) -> np.ndarray:
        """Decode (PIL) and stage ``idxs`` into ``rows_out``, in the staging
        colour space; returns ``[k, 2]`` original (w, h) sizes."""
        images = list(pool.map(self.dataset.load_image, [int(i) for i in idxs]))
        sizes = np.array([(img.shape[1], img.shape[0]) for img in images],
                         np.int64).reshape(-1, 2)
        yuv = self.staging_colorspace == 'yuv420'
        rgb = (np.empty((len(images), *record_shape(self.staging_size, 'rgb')),
                        np.uint8) if yuv else rows_out)
        by_size: Dict[Tuple[int, int], List[int]] = {}
        for r, img in enumerate(images):
            by_size.setdefault(img.shape[:2], []).append(r)
        for rows in by_size.values():
            rgb[rows] = self._stage(np.stack([images[r] for r in rows]))
        if yuv:
            for r in range(len(images)):
                rows_out[r] = native.rgb_to_yuv420(rgb[r])
        native.count('python', len(images))
        return sizes

    def _decode_rows(self, idxs, rows_out: np.ndarray,
                     pool: ThreadPoolExecutor) -> np.ndarray:
        """Decode and stage ``idxs`` into ``rows_out`` (one staged record a
        row); returns ``[k, 2]`` original (w, h) sizes.  The C++ batch path
        when every source is a JPEG file, the Python path otherwise and for
        each slot the C++ decoder failed on."""
        sizes = self._native_fill(idxs, rows_out)
        if sizes is None:
            return self._stage_python(idxs, rows_out, pool)
        sizes = sizes.astype(np.int64)
        failed = [r for r in range(len(idxs)) if not sizes[r].all()]
        native.count('native', len(idxs) - len(failed))
        if failed:
            redo = np.empty((len(failed),) + rows_out.shape[1:], np.uint8)
            sizes[failed] = self._stage_python(np.asarray(idxs)[failed],
                                               redo, pool)
            rows_out[failed] = redo
        return sizes

    def _stage(self, images: np.ndarray) -> np.ndarray:
        batch = torch.from_numpy(images)
        if self.staging_device.type != 'cuda':
            return stage_images(batch, self.staging_size).numpy()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.staging_device)
        with torch.cuda.stream(self._stream):
            staged = stage_images(batch.to(self.staging_device), self.staging_size)
            return staged.cpu().numpy()

    def _make_batch(self, idxs: np.ndarray, pool: ThreadPoolExecutor) -> dict:
        s = self.staging_size
        n = len(idxs)
        images = np.zeros((self.batch_size,)
                          + record_shape(s, self.staging_colorspace), np.uint8)
        boxes = np.zeros((self.batch_size, self.max_gt, 7), np.float32)
        mask = np.zeros((self.batch_size, self.max_gt), bool)
        rows = images[:n]
        if self.cache is not None:
            sizes = np.zeros((n, 2), np.int64)
            miss = []
            for r, i in enumerate(idxs):
                rec = self.cache.get(int(i))
                if rec is None:
                    miss.append(r)
                else:
                    rows[r], sizes[r] = rec
            if miss:
                tmp = np.empty((len(miss),) + rows.shape[1:], np.uint8)
                miss_sizes = self._decode_rows(np.asarray(idxs)[miss], tmp, pool)
                for k, r in enumerate(miss):
                    rows[r] = tmp[k]
                    sizes[r] = miss_sizes[k]
                    self.cache.put(int(idxs[r]), tmp[k], tuple(miss_sizes[k]))
        else:
            sizes = self._decode_rows(idxs, rows, pool)

        for row, i in enumerate(idxs):
            w, h = int(sizes[row, 0]), int(sizes[row, 1])
            b = self.dataset.boxes(int(i))
            if len(b):
                b = b.copy()
                b[:, [0, 2]] = np.clip(b[:, [0, 2]] * (s[0] / w),
                                       0, s[0] - 1)
                b[:, [1, 3]] = np.clip(b[:, [1, 3]] * (s[1] / h),
                                       0, s[1] - 1)
            k = min(len(b), self.max_gt)
            if k:
                boxes[row, :k, :b.shape[1]] = b[:k]
                mask[row, :k] = True

        ids = np.full((self.batch_size,), -1, np.int64)
        ids[:n] = idxs
        return {'image': images, 'boxes': boxes, 'box_mask': mask, 'ids': ids}

    def __iter__(self) -> Iterator[dict]:
        indices = self._indices()
        self.epoch += 1
        n_batches = len(self)
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_batches)]

        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        stop = object()
        done = threading.Event()

        def put(item) -> bool:
            while not done.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # a decode or annotation error surfaces in the consumer instead
            # of silently truncating the epoch
            try:
                for idxs in batches:
                    if not put(self._make_batch(idxs, pool)):
                        return
                put(stop)
            except BaseException as exc:  # noqa: BLE001
                put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            done.set()
            thread.join()
            pool.shutdown(wait=True)


def create_loaders(datasets: dict, batch_size: int, staging_size,
                   shuffle: bool = False, num_workers: int = 4,
                   max_gt: int = 100, seed: int = 23,
                   staging_colorspace: str = 'rgb',
                   cache_dir: Optional[str] = None,
                   staging_device: Optional[torch.device] = None,
                   process_count: int = 1, process_index: int = 0) -> dict:
    """Per-phase loaders: the eval batch twice the train batch, ``drop_last``
    and shuffling for train only.  ``cache_dir`` turns on the on-disk
    staging cache, one subdirectory per phase.  ``process_count`` and
    ``process_index``: this process's shard (the module doc)."""
    return {phase: Loader(
        dataset,
        batch_size=batch_size * 2 if phase == 'eval' else batch_size,
        staging_size=staging_size,
        shuffle=shuffle and phase == 'train',
        drop_last=phase == 'train',
        max_gt=max_gt,
        seed=seed,
        num_workers=num_workers,
        staging_colorspace=staging_colorspace,
        cache_dir=os.path.join(cache_dir, phase) if cache_dir else None,
        staging_device=staging_device, process_count=process_count,
        process_index=process_index) for phase, dataset in datasets.items()}
