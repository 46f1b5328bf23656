"""``train.transfer_ahead`` (``train/engine.py::prefetch_to_device``, the
port of the JAX engine's ``_prefetch_shard``) on the CPU: the batch stream
and an epoch are bit-equal at depths 0 and 2, a loader error reaches the
consumer after the batches before it, and leaving early stops the thread
and the loader.  Every wait has a timeout.  The card's path (pinned
buffers, a side stream) runs in ``chip_smoke.py``'s ``transfer_ahead``
phase."""

import itertools
import threading

import numpy as np
import pytest
import torch

from single_shot_detection_tpu_torch.train.engine import (BATCH_KEYS,
                                                          Experiment,
                                                          prefetch_to_device)

SMOKE = 'samples/synthetic_smoke.py'
CPU = torch.device('cpu')
TIMEOUT_S = 30


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    processes, and torch's default of one thread per core makes them
    contend for the CPU, tens of times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def within_timeout(fn):
    """``fn()``'s result, run on a thread that must end within
    ``TIMEOUT_S``; its exception is raised here."""
    out = {}

    def run():
        try:
            out['value'] = fn()
        except BaseException as exc:  # handed to the test's thread
            out['error'] = exc

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(TIMEOUT_S)
    assert not thread.is_alive(), f'did not finish within {TIMEOUT_S} s'
    if 'error' in out:
        raise out['error']
    return out['value']


def fake_batches(n, fail_at=None, closed=None):
    """``n`` loader-shaped batches; ``fail_at`` raises there; ``closed``
    (a list) records that the generator was closed."""
    rng = np.random.RandomState(0)
    try:
        for i in itertools.count() if n is None else range(n):
            if i == fail_at:
                raise OSError(f'decode failed at batch {i}')
            yield {'image': rng.randint(0, 256, (2, 8, 8, 3), dtype=np.uint8),
                   'boxes': rng.rand(2, 4, 7).astype(np.float32),
                   'box_mask': rng.rand(2, 4) > 0.5, 'ids': np.arange(2) + 2 * i}
    finally:
        if closed is not None:
            closed.append(True)


def test_batch_stream_is_bit_equal_at_depths_0_and_2():
    exp = Experiment(SMOKE, device='cpu')
    assert exp.transfer_ahead == 2  # the JAX engine's default
    loader = exp.loaders['train']
    streams = {}
    for depth in (0, 2, 0, 2):
        loader.epoch = 0
        streams.setdefault(depth, []).append(within_timeout(lambda: [
            (batch['ids'], tensors) for batch, tensors in
            prefetch_to_device(loader, CPU, depth)]))
    first = streams[0][0]
    assert len(first) == len(loader) > 1
    for runs in streams.values():
        for run in runs:
            assert len(run) == len(first)
            for (ids, tensors), (want_ids, want) in zip(run, first):
                np.testing.assert_array_equal(ids, want_ids)
                for t, w, key in zip(tensors, want, BATCH_KEYS):
                    assert t.dtype == w.dtype and torch.equal(t, w), key


def test_epoch_is_bit_equal_at_depths_0_and_2():
    rows = {}
    for depth in (0, 2):
        exp = Experiment(SMOKE, phases=('train',), device='cpu',
                         overrides={'train': {'transfer_ahead': depth,
                                              'num_batches_per_epoch': 3}})
        assert exp.transfer_ahead == depth
        rows[depth] = within_timeout(lambda: exp.train_epoch(0))
        assert exp.trainer.state.step == 3
    assert rows[0] == rows[2]


@pytest.mark.parametrize('depth', [0, 1, 2])
def test_loader_error_reaches_the_consumer(depth):
    seen = []

    def consume():
        for batch, _ in prefetch_to_device(fake_batches(5, fail_at=3), CPU, depth):
            seen.append(int(batch['ids'][0]))

    with pytest.raises(OSError, match='decode failed at batch 3'):
        within_timeout(consume)
    assert seen == [0, 2, 4]  # the batches before the error, in order


@pytest.mark.parametrize('depth', [1, 2])
def test_leaving_early_stops_the_thread_and_the_loader(depth):
    closed = []
    before = {t.name for t in threading.enumerate()}

    def consume():
        stream = prefetch_to_device(fake_batches(None, closed=closed), CPU, depth)
        taken = [batch for batch, _ in itertools.islice(stream, 3)]
        stream.close()
        return taken

    assert len(within_timeout(consume)) == 3
    assert closed == [True]  # the endless loader was closed
    assert not [t for t in threading.enumerate()
                if t.name == 'transfer-ahead' and t.name not in before]


def test_copy_error_reaches_the_consumer():
    """A batch that cannot become a tensor fails in the copy thread and
    the error reaches the consumer."""
    def bad():
        yield {'image': np.zeros((2, 2), object), 'boxes': np.zeros(1),
               'box_mask': np.zeros(1, bool)}

    with pytest.raises(TypeError):
        within_timeout(lambda: list(prefetch_to_device(bad(), CPU, 2)))
