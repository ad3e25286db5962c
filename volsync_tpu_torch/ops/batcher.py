"""Cross-stream segment microbatching (shared by service + local engine).

Ports ``volsync_tpu/ops/batcher.py``. Concurrent producers (gRPC
ChunkHash handlers in ``service/server.py``, or TreeBackup's per-file
workers through ``DeviceChunkHasher``) submit segments that coalesce
into ONE batched device pass (``ops/segment.chunk_hash_segments`` via
``BatchedSegmentHasher``). A lone producer pays at most ``window_ms``;
a busy pipeline pays it never (the queue is already non-empty when the
worker looks).

The batcher runs on the device it is given (``device=``; None means
CUDA and raises where CUDA is absent). The process-wide
``shared_batcher`` is on by default where its device is CUDA and off on
the CPU, as the reference's is on for the TPU backend and off for the
CPU one; ``VOLSYNC_BATCH_SEGMENTS`` forces it either way.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

from volsync_tpu_torch import envflags, resolve_device
from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.obs import current_context, span, use_context
from volsync_tpu_torch.ops.gearcdc import GearParams


class BatcherStopped(RuntimeError):
    """submit() after stop(), or work stranded by shutdown. Typed so
    the service layer can map it to a clean UNAVAILABLE instead of
    pattern-matching a RuntimeError message."""


class SegmentMicroBatcher:
    """Queue + worker thread: the first item waits up to ``window_ms``
    for companions (bounded by ``max_batch``), the batch dispatches via
    BatchedSegmentHasher, and each caller's future resolves with its
    lane. ``stop()`` drains the queue: a future enqueued before stop
    is always resolved, never stranded."""

    def __init__(self, params: GearParams, *, max_batch: int = 16,
                 window_ms: float = 2.0, pipeline_depth: int = 2,
                 device=None):
        from volsync_tpu_torch.ops.segment import BatchedSegmentHasher

        self._hasher = BatchedSegmentHasher(params, device=device)
        self.device = self._hasher.device
        self._q: queue.Queue = queue.Queue()
        self._max_batch = max_batch
        self._window = window_ms / 1000.0
        # Up to ``pipeline_depth`` batches in flight: while one dispatch
        # waits for its result, the collector assembles and launches the
        # next. The semaphore bounds in-flight batches so producer
        # backpressure (blocking submit) still holds. Depth 1 restores
        # strict one-at-a-time dispatch.
        #
        # Dispatchers are hand-rolled DAEMON threads, not a
        # ThreadPoolExecutor: the executor's non-daemon workers register
        # an interpreter-exit join, so a shared_batcher (never stopped)
        # with a wedged dispatch would hang process exit.
        self._depth = max(1, pipeline_depth)
        self._inflight = threading.BoundedSemaphore(self._depth)
        self._dq: queue.Queue = queue.Queue()
        self._dispatchers = [
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name=f"segment-batch-{i}")
            for i in range(self._depth)]
        for t in self._dispatchers:
            t.start()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="segment-microbatcher")
        self._thread.start()

    def submit(self, data, length: int, eof: bool):
        """Blocking: returns (chunks, consumed) for this segment."""
        # The worker resolves every queued future (including at
        # shutdown); the timeout is a last-ditch liveness bound so a
        # producer thread can never hang the interpreter.
        return self.submit_async(data, length, eof).result(timeout=600)

    def submit_async(self, data, length: int, eof: bool) -> Future:
        """Non-blocking enqueue: the future resolves with
        (chunks, consumed) for this segment. The service scheduler
        feeds the batcher through this so its deficit-round-robin
        thread never blocks on a device pass."""
        if self._stop.is_set():
            raise BatcherStopped("microbatcher stopped")
        f: Future = Future()
        self._q.put((data, length, eof, current_context(), f))
        return f

    def _run(self):
        while True:
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            batch = [first]
            deadline = time.monotonic() + self._window
            while len(batch) < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            # Interruptible slot wait: if every dispatch slot stays
            # occupied for 30 s AFTER stop() fires, the pipeline is
            # wedged: fail the in-hand batch instead of blocking forever
            # with popped futures that stop()'s queue drain can no
            # longer reach.
            acquired = stop_deadline = None
            while True:
                if self._inflight.acquire(timeout=0.2):
                    acquired = True
                    break
                if not self._stop.is_set():
                    continue
                now = time.monotonic()
                if stop_deadline is None:
                    stop_deadline = now + 30.0
                elif now >= stop_deadline:
                    break
            if not acquired:
                exc = BatcherStopped("microbatcher stopped")
                for *_, f in batch:
                    if not f.done():
                        f.set_exception(exc)
                return
            self._dq.put(batch)

    def _dispatch_loop(self):
        while True:
            batch = self._dq.get()
            try:
                # One span per coalesced device pass, under the lanes'
                # trace when they all carry one (_pass_context).
                with use_context(_pass_context(batch)), \
                        span("ops.batch_dispatch", lanes=len(batch)):
                    results = self._hasher.hash_segments(
                        [(d, n, e) for d, n, e, *_ in batch])
                for (*_, f), r in zip(batch, results):
                    f.set_result(r)
            except Exception as exc:  # noqa: BLE001 — per-caller delivery
                for *_, f in batch:
                    if not f.done():
                        f.set_exception(exc)
            finally:
                self._inflight.release()

    def stop(self):
        """Stop accepting work, then let the collector DRAIN the queue:
        it exits only via the empty-queue check, so a future enqueued
        before stop() is always resolved, never stranded. In-flight
        dispatches run on daemon threads: wait (bounded) for them to
        resolve their futures."""
        self._stop.set()
        self._thread.join(timeout=30.0)
        # Drain the in-flight window by taking every slot (bounded wait).
        got = 0
        t_end = time.monotonic() + 30.0
        for _ in range(self._depth):
            if self._inflight.acquire(
                    timeout=max(0.0, t_end - time.monotonic())):
                got += 1
        for _ in range(got):
            self._inflight.release()
        # If the collector died abnormally, fail leftovers still queued.
        while True:
            try:
                *_, f = self._q.get_nowait()
            except queue.Empty:
                break
            if not f.done():
                f.set_exception(BatcherStopped("microbatcher stopped"))


def _pass_context(batch):
    """The trace a pass's span runs under: the lanes' own when every
    lane was submitted under one trace (one backup's hashing workers),
    so the flight recorder shows the pass inside that trace; else none.
    The reference keeps every pass context-free: a batch that mixes
    streams is attributed by the scheduler's svc.batch span around each
    future, which this keeps."""
    first = batch[0][3]
    if first is None or any(item[3] is None
                            or item[3].trace_id != first.trace_id
                            for item in batch):
        return None
    return first


_SHARED: dict = {}
_SHARED_LOCK = lockcheck.make_lock("batcher.shared")


def _batching_enabled(device) -> bool:
    """VOLSYNC_BATCH_SEGMENTS: "1" forces on, "0"/"false"/"no" forces
    off. Unset -> device-aware default: ON for CUDA, OFF for the CPU
    (the reference keys the same default on its TPU backend)."""
    forced = envflags.batch_segments_override()
    if forced is not None:
        return forced
    return device.type == "cuda"


def shared_batcher(params: GearParams, device=None):
    """Process-wide microbatcher per (chunker params, device), the
    local engine's batching path: TreeBackup workers hashing different
    files, and different CRs' movers in one operator process, coalesce
    through one instance. Returns None when batching is disabled (see
    _batching_enabled: the default follows the device) or the params
    aren't page-aligned. ``device`` None means CUDA and raises where
    CUDA is absent."""
    device = resolve_device(device)
    if not _batching_enabled(device):
        return None
    if params.align != 4096:
        return None
    with _SHARED_LOCK:
        b = _SHARED.get((params, device))
        if b is None:
            b = _SHARED[(params, device)] = SegmentMicroBatcher(
                params,
                max_batch=envflags.batch_max(),
                window_ms=envflags.batch_window_ms(),
                pipeline_depth=envflags.batch_pipeline_depth(),
                device=device)
        return b
