"""The staged train set kept on the device: epochs after the first never
touch the host loader.

Port of the JAX package's ``data/device_cache.py`` for one process.  Staged
pixels are a pure function of (dataset, staging size, colour space): all
augmentation runs on the device after staging (``data/transforms.py``).
So the whole staged train set can stay on the card: the first epoch
streams as usual while :meth:`DeviceDatasetCache.observe` copies each
batch's rows aside, :meth:`DeviceDatasetCache.finalize` stages the rows
that epoch never yielded (``drop_last``) and uploads everything, and every
later epoch gathers its batches on the device by index: no decode, no
host-to-device copy of pixels.

The batch stream is the streamed one bit for bit: the same ``(seed +
epoch)`` permutation (``Loader._indices``), the same ``drop_last``
truncation, the same chunks of ``fused_k`` with a shorter remainder run
singly, the same ``num_batches`` cap.

A run of several processes (the loader's ``process_count``) keeps the JAX
cache's row blocks: rank ``r`` holds only the dataset rows ``[r * m, (r + 1)
* m)``, ``m`` the wrap-padded size over the ranks, fills them from its own
loader shard and tops up the rest at ``finalize``.  A later epoch's batch
``b`` is every rank's streamed batch ``b`` (the ranks' shards of the same
permutation): each rank gathers the rows of its block that any rank needs,
zeros elsewhere, and one integer sum over the ranks (exact: one rank holds
each row) hands every rank its own rows, bit for bit the streamed ones.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from single_shot_detection_tpu_torch import parallel
from single_shot_detection_tpu_torch.data.cache import record_shape

KEYS = ('image', 'boxes', 'box_mask')
# the integer type a column of each dtype is summed over the ranks as
_SUM_DTYPES = {torch.float32: torch.int32, torch.bool: torch.uint8}
DEFAULT_MAX_BYTES = 4 << 30


def budget(cfg) -> int:
    """The device bytes a ``device_cache`` option allows: ``True`` or
    ``{'max_bytes': n}``, 4 GiB by default.  The train cache and the eval
    replay cache share it."""
    opts = dict(cfg) if isinstance(cfg, dict) else {}
    return int(opts.get('max_bytes', DEFAULT_MAX_BYTES))


class DeviceDatasetCache:
    """Staged train records, filled on the host, then resident on
    ``device``.

    * the fill epoch: :meth:`observe` each loader batch, then
      :meth:`finalize` with the loader;
    * later epochs: :meth:`epoch_batches` yields what the streamed epoch
      would, as device tensors.
    """

    def __init__(self, loader, device: torch.device, max_bytes: int):
        n = len(loader.dataset)
        count, index = loader.process_count, loader.process_index
        # this rank's row block (the whole set for one process)
        n_local = n if count == 1 else (n + (-n) % count) // count
        img_shape, nbytes = self._record_shapes(loader)
        # the footprint on the device and the budget, read by the eval
        # replay cache, which charges itself against the same budget
        self.total_bytes = n_local * nbytes
        self.max_bytes = max_bytes
        self.ok = self.total_bytes <= max_bytes
        if not self.ok:
            logging.warning(
                f'WW train.device_cache: staged dataset needs '
                f'{self.total_bytes / 2**30:.2f} GiB > budget '
                f'{max_bytes / 2**30:.2f} GiB '
                f"(raise train.device_cache['max_bytes'] to override) — "
                f'falling back to host streaming')
            return
        self.n = n
        self.n_local = n_local
        self.row_lo = index * n_local
        self.process_count, self.process_index = count, index
        self.target = torch.device(device)
        self.images = np.zeros((n_local,) + img_shape, np.uint8)
        self.boxes = np.zeros((n_local, loader.max_gt, 7), np.float32)
        self.mask = np.zeros((n_local, loader.max_gt), bool)
        self.seen = np.zeros((n_local,), bool)
        # block rows past the dataset's end (the wrap padding) hold nothing
        self.seen[max(0, n - self.row_lo):] = True
        self.topped_up = 0  # rows finalize staged itself
        self.device: Optional[dict] = None  # set by finalize()
        logging.info(f'II device cache: reserving '
                     f'{self.total_bytes / 2**30:.2f} GiB host staging for '
                     f'{n_local} records {img_shape}')

    @staticmethod
    def _record_shapes(loader) -> Tuple[tuple, int]:
        img_shape = record_shape(loader.staging_size, loader.staging_colorspace)
        nbytes = (int(np.prod(img_shape))           # uint8 pixels
                  + loader.max_gt * 7 * 4           # boxes f32
                  + loader.max_gt)                  # mask bool
        return img_shape, nbytes

    @property
    def ready(self) -> bool:
        return self.ok and self.device is not None

    def observe(self, batch: dict) -> None:
        """Keep a loader batch's rows during the fill epoch (keyed by the
        dataset index in ``ids``; padding rows carry -1)."""
        if not self.ok or self.device is not None:
            return
        ids = np.asarray(batch['ids'])
        # this rank's block only (padding rows carry -1)
        valid = (ids >= self.row_lo) & (ids < self.row_lo + self.n_local)
        idx = ids[valid] - self.row_lo
        self.images[idx] = np.asarray(batch['image'])[valid]
        self.boxes[idx] = np.asarray(batch['boxes'])[valid]
        self.mask[idx] = np.asarray(batch['box_mask'])[valid]
        self.seen[idx] = True

    def finalize(self, loader) -> None:
        """Stage the rows the fill epoch never yielded, then upload the
        whole staged set to the device and drop the host copies."""
        if not self.ok or self.device is not None:
            return
        missing = np.flatnonzero(~self.seen) + self.row_lo
        if len(missing):
            with ThreadPoolExecutor(max_workers=loader.num_workers) as pool:
                for start in range(0, len(missing), loader.batch_size):
                    idxs = missing[start:start + loader.batch_size]
                    self.observe(loader._make_batch(idxs, pool))
        self.topped_up = len(missing)
        assert bool(self.seen.all())
        host = {'image': self.images, 'boxes': self.boxes,
                'box_mask': self.mask}
        self.device = {k: torch.from_numpy(v).to(self.target)
                       for k, v in host.items()}
        self.images = self.boxes = self.mask = None
        logging.info(f'===> device cache ready: {self.n_local} of {self.n} '
                     f'records on {self.target} — later epochs run host-free')

    def _gather(self, idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The rows of dataset indices ``idx [ranks, B]`` (every rank's
        batch) that this rank feeds: its own ``[B]``."""
        if self.process_count == 1:
            return tuple(self.device[k].index_select(0, idx[0]) for k in KEYS)
        flat = idx.reshape(-1)
        mine = (flat >= self.row_lo) & (flat < self.row_lo + self.n_local)
        local = torch.where(mine, flat - self.row_lo, 0)
        b = idx.shape[1]
        own = slice(self.process_index * b, (self.process_index + 1) * b)
        out = []
        for k in KEYS:
            rows = self.device[k].index_select(0, local)
            keep = mine.view(-1, *([1] * (rows.dim() - 1)))
            rows = torch.where(keep, rows, torch.zeros((), dtype=rows.dtype,
                                                       device=rows.device))
            # summed as integers of the same width: exact, bit for bit
            bits = rows.view(_SUM_DTYPES.get(rows.dtype, rows.dtype))
            parallel.all_reduce_(bits)
            out.append(bits[own].view(rows.dtype))
        return tuple(out)

    def epoch_batches(self, loader, epoch: int, fused_k: int = 1,
                      num_batches: Optional[int] = None) -> Iterator[tuple]:
        """Yield ``('single', (image, boxes, box_mask))`` or ``('fused', [k
        such tuples])`` for one epoch, the streamed epoch's batches in its
        order and grouping, gathered on the device.  The epoch's indices
        cross to the device once, as one small copy."""
        loader.epoch = epoch  # _indices reads it, as the streamed path does
        count, b = self.process_count, loader.batch_size
        shards = np.stack([loader._global_order()[r::count]
                           for r in range(count)])  # [ranks, m]
        nb = shards.shape[1] // b
        if num_batches is not None:
            nb = min(nb, num_batches)
        # [nb, ranks, B]: batch i of every rank's streamed epoch
        order = torch.from_numpy(np.ascontiguousarray(
            shards[:, :nb * b].reshape(count, nb, b).transpose(1, 0, 2))
        ).to(self.target)
        pos = 0
        while pos < nb:
            if fused_k > 1 and pos + fused_k <= nb:
                yield 'fused', [self._gather(order[pos + i])
                                for i in range(fused_k)]
                pos += fused_k
            else:
                yield 'single', self._gather(order[pos])
                pos += 1


def make_device_cache(loader, cfg, device: torch.device
                      ) -> Optional[DeviceDatasetCache]:
    """``train.device_cache`` (see :func:`budget`); None when off or over
    budget."""
    if not cfg:
        return None
    cache = DeviceDatasetCache(loader, device, max_bytes=budget(cfg))
    return cache if cache.ok else None
