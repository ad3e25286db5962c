"""The port's segment micro-batcher (``volsync_tpu_torch/ops/batcher.py``)
against the JAX package's, on the CPU.

Concurrent submits through a pipelined ``SegmentMicroBatcher`` give each
caller its own lane, equal to the port's ``BatchedSegmentHasher`` on the
same segments and to the reference's batcher; ``stop()`` resolves every
future queued before it; ``submit`` after ``stop`` raises
``BatcherStopped``; the shared batcher is off on the CPU unless
``VOLSYNC_BATCH_SEGMENTS`` forces it, and a forced one coalesces
``DeviceChunkHasher`` segments into batched passes with the unbatched
chunk lists. Segments are made from a seed with numpy.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from volsync_tpu.ops.batcher import SegmentMicroBatcher as JBatcher
from volsync_tpu.ops.gearcdc import GearParams as JParams
from volsync_tpu_torch.engine.chunker import DeviceChunkHasher
from volsync_tpu_torch.ops import batcher
from volsync_tpu_torch.ops.gearcdc import GearParams
from volsync_tpu_torch.ops.segment import BatchedSegmentHasher

torch.set_num_threads(1)

P = dict(min_size=4096, avg_size=32768, max_size=65536, seed=0x5EED_CDC1,
         align=4096)
TP, JP = GearParams(**P), JParams(**P)


def _segments(seed: int = 3):
    """(bytes, valid_len, eof) lanes: full and short, eof and not, one
    below min_size, one empty, one repeating another's bytes."""
    rng = np.random.RandomState(seed)
    items = [(rng.bytes(n), n, eof) for n, eof in
             ((60_000, True), (50_001, False), (3 * 4096 + 17, True),
              (2000, True), (40_000, False))]
    items.append((b"", 0, True))
    items.append((items[0][0], len(items[0][0]), False))
    return items


def _through(mb, items):
    try:
        with ThreadPoolExecutor(len(items)) as ex:
            return list(ex.map(lambda it: mb.submit(*it), items))
    finally:
        mb.stop()


def test_lanes_equal_batched_hasher_and_the_reference():
    items = _segments()
    got = _through(batcher.SegmentMicroBatcher(
        TP, max_batch=4, window_ms=20.0, pipeline_depth=2, device="cpu"),
        items)
    direct = BatchedSegmentHasher(TP, device="cpu").hash_segments(items)
    ref = _through(JBatcher(JP, max_batch=4, window_ms=20.0,
                            pipeline_depth=2), items)
    assert got == direct == ref
    assert got[0][0] and got[0][1] == 60_000  # eof: the whole lane
    assert got[-1][0][0] == got[0][0][0]  # equal bytes, equal first id


def test_stop_drains_every_queued_future():
    """Futures queued before ``stop()`` are resolved with results, none
    left stranded, while the collector is still holding back the first
    batch for its window."""
    mb = batcher.SegmentMicroBatcher(TP, max_batch=2, window_ms=200.0,
                                     pipeline_depth=1, device="cpu")
    items = _segments()[:4]
    futs = [mb.submit_async(*it) for it in items]
    mb.stop()
    assert all(f.done() for f in futs)
    want = BatchedSegmentHasher(TP, device="cpu").hash_segments(items)
    assert [f.result(timeout=0) for f in futs] == want


def test_submit_after_stop_raises_batcher_stopped():
    mb = batcher.SegmentMicroBatcher(TP, device="cpu")
    mb.stop()
    with pytest.raises(batcher.BatcherStopped):
        mb.submit_async(b"x" * 8192, 8192, True)
    with pytest.raises(batcher.BatcherStopped):
        mb.submit(b"x" * 8192, 8192, True)


@pytest.mark.parametrize("forced,want", [(None, False), ("0", False),
                                         ("false", False), ("1", True)])
def test_shared_batcher_is_off_on_the_cpu_unless_forced(monkeypatch,
                                                        forced, want):
    if forced is None:
        monkeypatch.delenv("VOLSYNC_BATCH_SEGMENTS", raising=False)
    else:
        monkeypatch.setenv("VOLSYNC_BATCH_SEGMENTS", forced)
    monkeypatch.setattr(batcher, "_SHARED", {})
    cpu = torch.device("cpu")
    assert batcher._batching_enabled(cpu) is want
    assert batcher._batching_enabled(torch.device("cuda")) is \
        (forced is None or want)
    b = batcher.shared_batcher(TP, device="cpu")
    assert (b is not None) is want
    if b is not None:
        assert b.device == cpu
        assert batcher.shared_batcher(TP, device="cpu") is b  # one a key
        # unaligned params never batch
        assert batcher.shared_batcher(GearParams(align=64),
                                      device="cpu") is None
        b.stop()


def test_forced_shared_batcher_coalesces_hasher_segments(monkeypatch):
    """With ``VOLSYNC_BATCH_SEGMENTS=1`` concurrent ``DeviceChunkHasher``
    calls on the CPU go through the shared batcher (fewer batched
    passes than segments) and give the unbatched chunk lists; a hasher
    that clears ``use_shared_batcher`` keeps its own passes."""
    monkeypatch.setenv("VOLSYNC_BATCH_SEGMENTS", "1")
    monkeypatch.setenv("VOLSYNC_BATCH_WINDOW_MS", "200")
    monkeypatch.setattr(batcher, "_SHARED", {})
    items = [it for it in _segments(5) if it[1] > P["min_size"]]
    plain = DeviceChunkHasher(TP, device="cpu")
    plain.use_shared_batcher = False
    want = [plain.process(np.frombuffer(b, np.uint8), eof=e)
            for b, _, e in items]
    shared = batcher.shared_batcher(TP, device="cpu")
    lanes, lock = [], threading.Lock()
    inner = shared._hasher.hash_segments

    def spy(batch):
        with lock:
            lanes.append(len(batch))
        return inner(batch)

    shared._hasher.hash_segments = spy
    hasher = DeviceChunkHasher(TP, device="cpu")
    try:
        with ThreadPoolExecutor(len(items)) as ex:
            got = list(ex.map(lambda it: hasher.process(
                np.frombuffer(it[0], np.uint8), eof=it[2]), items))
    finally:
        shared.stop()
    assert got == want
    assert sum(lanes) == len(items) and len(lanes) < len(items)
