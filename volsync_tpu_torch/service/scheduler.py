"""Weighted deficit-round-robin segment scheduler for the service plane.

Ports ``volsync_tpu/service/scheduler.py`` whole.

Without it, concurrent ChunkHash streams race each other straight into
the SegmentMicroBatcher's FIFO: one greedy stream that always has a
segment ready monopolizes device batch slots and starves everyone else
of the coalescing win the batcher exists for. The scheduler puts a
fairness stage in front: segments queue PER TENANT, and a collector
thread runs classic deficit round robin (Shreedhar & Varghese) weighted
by the tenant's configured share — each round every backlogged tenant
earns ``quantum * weight`` bytes of credit and dispatches whole
segments while its deficit covers them. Cross-tenant segments still
land in the SAME microbatcher window, so fairness does not cost the
single-dispatch coalescing (amortized pipeline warmup) the batched
path measures.

Backpressure, not buffering: each tenant's queue is bounded
(TenantConfig.max_queued / VOLSYNC_SVC_TENANT_QUEUED). ``submit``
blocks on the tenant's credit semaphore when the queue is full, which
pauses the gRPC handler thread, which stops pulling the request
iterator, which lets gRPC flow control push back on the sender — a
slow device never turns into unbounded server memory. Dispatches into
the batcher are themselves windowed (``dispatch_window``) so the
scheduler cannot flood the batcher queue and recreate the FIFO it
replaced.

Deadline classes over WDRR: a segment may
carry a relative ``deadline`` (seconds of queue wait it can absorb).
Within a tenant the scheduler serves **earliest-deadline-first** —
deadline-free segments rank last, FIFO among themselves — and a
segment whose deadline has already passed when its dispatch turn comes
is shed with a typed :class:`DeadlineExceeded` BEFORE it costs a
batcher slot or device work: at overload, late work is dropped at the
cheapest point instead of wasting the device on answers nobody is
waiting for. Cross-tenant isolation stays WDRR's job — a saturated
background class cannot move another tenant's p99 because deficits,
not deadlines, divide the quantum. Class names map to relative
deadlines via :func:`parse_deadline_classes`
(``VOLSYNC_SVC_DEADLINES``, e.g. ``interactive=0.5,background=none``).

Observability: ``volsync_svc_queue_depth{tenant}`` tracks backlog,
``volsync_svc_sched_latency_seconds{tenant}`` the queue wait of the
most recently dispatched segment,
``volsync_svc_deadline_exceeded_total{tenant}`` counts deadline sheds
(each also records a ``deadline`` trigger), and
each dispatch runs under a ``svc.schedule`` span.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from concurrent.futures import Future

from volsync_tpu_torch import envflags
from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS
from volsync_tpu_torch.obs import (begin_span, record_trigger, span,
                                   use_context)
from volsync_tpu_torch.service.tenants import TenantRegistry


class SchedulerStopped(RuntimeError):
    """Work refused or stranded because the scheduler is shutting
    down; the server maps it to a clean UNAVAILABLE."""


class DeadlineExceeded(RuntimeError):
    """A segment's queue-wait deadline passed before dispatch; the
    scheduler shed it without spending a batcher slot or device work.
    The server maps it to gRPC DEADLINE_EXCEEDED."""

    def __init__(self, tenant: str, waited: float, deadline: float):
        super().__init__(
            f"segment for tenant {tenant!r} shed after {waited:.3f}s "
            f"queue wait (deadline {deadline:.3f}s)")
        self.tenant = tenant
        self.waited = waited
        self.deadline = deadline


#: Built-in deadline classes: relative seconds of queue wait a segment
#: of that class tolerates, None = no deadline (pure WDRR behaviour).
#: Override with VOLSYNC_SVC_DEADLINES.
DEFAULT_DEADLINE_CLASSES: dict = {
    "interactive": 0.5,
    "standard": 5.0,
    "background": None,
}


def parse_deadline_classes(spec: str) -> dict:
    """Parse ``name=seconds[,name=...]`` (``none``/``inf`` = no
    deadline) into a class map; empty spec returns the defaults."""
    if not spec.strip():
        return dict(DEFAULT_DEADLINE_CLASSES)
    classes: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, value = part.partition("=")
        name = name.strip()
        if not sep or not name:
            raise ValueError(f"bad deadline class {part!r} "
                             "(want name=seconds or name=none)")
        value = value.strip().lower()
        if value in ("none", "inf", ""):
            classes[name] = None
        else:
            seconds = float(value)
            if seconds <= 0:
                raise ValueError(
                    f"deadline for class {name!r} must be > 0, "
                    f"got {seconds}")
            classes[name] = seconds
    return classes


@dataclass
class _Item:
    data: bytes
    length: int
    eof: bool
    future: Future
    tenant: str
    enqueued_at: float
    cost: int  # bytes (>= 1 so empty eof flushes still cost a unit)
    #: absolute clock time after which dispatch is pointless
    #: (None = no deadline, ranks last within the tenant)
    deadline: Optional[float] = None
    #: the submitting stream's TraceContext, carried across the
    #: collector-thread seam so dispatch/batch spans attribute to it
    ctx: object = None
    #: open svc.queue_wait span handle, finished at dispatch
    qspan: object = None


@dataclass
class _TenantState:
    weight: int
    credits: threading.Semaphore
    q: deque = field(default_factory=deque)
    deficit: float = 0.0
    depth_gauge: object = None
    latency_gauge: object = None


class SegmentScheduler:
    """Fair, bounded feeder between stream handlers and one
    SegmentMicroBatcher.

    ``start=False`` leaves the collector thread unstarted so tests can
    drive :meth:`service_round` deterministically."""

    def __init__(self, batcher, registry: TenantRegistry, *,
                 quantum: Optional[int] = None,
                 tenant_queued: Optional[int] = None,
                 dispatch_window: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 start: bool = True):
        self._batcher = batcher
        self._registry = registry
        self._quantum = (envflags.svc_quantum() if quantum is None
                         else max(1, quantum))
        self._tenant_queued = (envflags.svc_tenant_queued()
                               if tenant_queued is None
                               else max(1, tenant_queued))
        if dispatch_window is None:
            dispatch_window = envflags.svc_dispatch_window()
        if dispatch_window <= 0:
            # derive from batcher geometry: enough outstanding segments
            # to fill every in-flight batch, plus one window forming
            depth = getattr(batcher, "_depth", 1)
            max_batch = getattr(batcher, "_max_batch", 16)
            dispatch_window = max_batch * (depth + 1)
        self._clock = clock
        self._lock = lockcheck.make_lock("service.scheduler")
        self._states: dict[str, _TenantState] = {}
        self._order: list[str] = []
        self._slots = threading.BoundedSemaphore(dispatch_window)
        self.dispatch_window = dispatch_window
        self._queued = 0
        self._dispatched = 0
        # cached per-tenant deadline-shed counter children
        self._deadline_c: dict = {}
        self._work = threading.Event()
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="svc-scheduler")
        if start:
            self._thread.start()

    # -- producer side -----------------------------------------------------

    def _state_for(self, tenant: str) -> _TenantState:
        # caller does NOT hold the lock
        with self._lock:
            st = self._states.get(tenant)
            if st is None:
                cfg = self._registry.config(tenant)
                bound = (cfg.max_queued if cfg.max_queued is not None
                         else self._tenant_queued)
                st = _TenantState(
                    weight=cfg.weight,
                    credits=threading.Semaphore(bound),
                    depth_gauge=GLOBAL_METRICS.svc_queue_depth.labels(
                        tenant=tenant),
                    latency_gauge=GLOBAL_METRICS.svc_sched_latency.labels(
                        tenant=tenant))
                self._states[tenant] = st
                self._order.append(tenant)
            return st

    def submit(self, tenant: str, data: bytes, length: int,
               eof: bool, ctx=None,
               deadline: Optional[float] = None) -> Future:
        """Enqueue one segment; the future resolves with the batcher's
        (chunks, consumed). Blocks — the credit-based pause — while the
        tenant's queue is at its bound. ``ctx`` is the submitting
        stream's TraceContext (or None): queue-wait and device-batch
        spans attribute to it even though they finish on the collector
        and batcher threads. ``deadline`` is RELATIVE seconds of queue
        wait this segment tolerates (None = unbounded): within the
        tenant it is served earliest-deadline-first, and if it is still
        queued when the deadline passes the future fails with
        :class:`DeadlineExceeded` instead of reaching the device."""
        st = self._state_for(tenant)
        while not st.credits.acquire(timeout=0.1):
            if self._stopped.is_set():
                raise SchedulerStopped("scheduler stopped")
        if self._stopped.is_set():
            st.credits.release()
            raise SchedulerStopped("scheduler stopped")
        now = self._clock()
        item = _Item(data=data, length=length, eof=eof, future=Future(),
                     tenant=tenant, enqueued_at=now,
                     cost=max(1, length), ctx=ctx,
                     deadline=None if deadline is None else now + deadline,
                     qspan=begin_span("svc.queue_wait", ctx=ctx))
        with self._lock:
            st.q.append(item)
            self._queued += 1
            depth = len(st.q)
        st.depth_gauge.set(depth)
        self._work.set()
        return item.future

    def queued_total(self) -> int:
        """Segments waiting for a dispatch slot (the admission
        controller's overload signal)."""
        with self._lock:
            return self._queued

    @property
    def dispatched_total(self) -> int:
        with self._lock:
            return self._dispatched

    # -- collector side ----------------------------------------------------

    @staticmethod
    def _edf_index(q: deque) -> int:
        """Index of the segment to serve next within one tenant:
        earliest absolute deadline first, deadline-free segments last,
        FIFO among equals (queue order IS arrival order)."""
        return min(range(len(q)),
                   key=lambda i: (q[i].deadline is None,
                                  q[i].deadline
                                  if q[i].deadline is not None else 0.0,
                                  i))

    def service_round(self) -> bool:
        """One deficit-round-robin pass over all backlogged tenants.
        Returns False when there was nothing to do."""
        with self._lock:
            actives = [n for n in self._order if self._states[n].q]
        if not actives:
            return False
        for name in actives:
            ready: list[_Item] = []
            with self._lock:
                st = self._states[name]
                if not st.q:
                    st.deficit = 0.0
                    continue
                st.deficit += float(self._quantum) * st.weight
                # EDF within the tenant: the most urgent segment is the
                # one the deficit must cover — if it does not fit yet we
                # wait (skipping to a cheaper, later segment would
                # starve exactly the work with the tightest deadline)
                while st.q:
                    idx = self._edf_index(st.q)
                    if st.q[idx].cost > st.deficit:
                        break
                    item = st.q[idx]
                    del st.q[idx]
                    st.deficit -= item.cost
                    self._queued -= 1
                    ready.append(item)
                if not st.q:
                    # standard DRR: an emptied queue forfeits leftover
                    # deficit (no banking credit while idle)
                    st.deficit = 0.0
                depth = len(st.q)
            st.depth_gauge.set(depth)
            for item in ready:
                st.credits.release()
                self._dispatch(st, item)
        return True

    def _deadline_counter(self, tenant: str):
        # cold path (deadline sheds only); the lock keeps the cache
        # honest even though today only the scheduler thread calls it
        with self._lock:
            c = self._deadline_c.get(tenant)
            if c is None:
                c = self._deadline_c[tenant] = \
                    GLOBAL_METRICS.svc_deadline_exceeded.labels(
                        tenant=tenant)
            return c

    def _dispatch(self, st: _TenantState, item: _Item) -> None:
        # deadline shed BEFORE the slot acquire: an expired segment must
        # not cost a batcher slot, a device batch, or the wait for
        # either — dropping late work here is the whole point of
        # deadline classes
        if item.deadline is not None:
            now = self._clock()
            if now > item.deadline:
                if item.qspan is not None:
                    item.qspan.finish("error")
                self._deadline_counter(item.tenant).inc()
                record_trigger("deadline", tenant=item.tenant,
                               waited=round(now - item.enqueued_at, 4))
                if not item.future.done():
                    item.future.set_exception(DeadlineExceeded(
                        item.tenant, now - item.enqueued_at,
                        item.deadline - item.enqueued_at))
                return
        # windowed handoff to the batcher: wait for a slot, interrupted
        # by stop (stranded items are failed, never lost)
        while not self._slots.acquire(timeout=0.1):
            if self._stopped.is_set():
                if item.qspan is not None:
                    item.qspan.finish("error")
                if not item.future.done():
                    item.future.set_exception(
                        SchedulerStopped("scheduler stopped"))
                return
        if item.qspan is not None:
            item.qspan.finish("ok")
        st.latency_gauge.set(self._clock() - item.enqueued_at)
        with self._lock:
            self._dispatched += 1
        bspan = begin_span("svc.batch", ctx=item.ctx)
        try:
            with use_context(item.ctx):
                with span("svc.schedule"):
                    inner = self._batcher.submit_async(
                        item.data, item.length, item.eof)
        except BaseException as exc:
            bspan.finish("error")
            self._slots.release()
            if not item.future.done():
                item.future.set_exception(exc)
            return

        def _chain(done: Future, out: Future = item.future) -> None:
            self._slots.release()
            exc = done.exception()
            bspan.finish("ok" if exc is None else "error")
            if out.done():
                return
            if exc is not None:
                out.set_exception(exc)
            else:
                out.set_result(done.result())

        inner.add_done_callback(_chain)

    def _run(self) -> None:
        while not self._stopped.is_set():
            if self.service_round():
                continue
            # empty: sleep until a submit signals work. Clear FIRST,
            # then re-check, so a submit racing the clear is never lost.
            self._work.clear()
            with self._lock:
                backlog = self._queued
            if backlog:
                continue
            self._work.wait(0.2)

    def stop(self) -> None:
        """Stop the collector and fail everything still queued with
        SchedulerStopped (handlers map it to UNAVAILABLE). Call AFTER
        the server's drain window — an orderly shutdown reaches here
        with empty queues."""
        self._stopped.set()
        self._work.set()
        if self._thread.is_alive():
            self._thread.join(timeout=30.0)
        stranded: list[_Item] = []
        with self._lock:
            for st in self._states.values():
                while st.q:
                    stranded.append(st.q.popleft())
                    self._queued -= 1
                st.deficit = 0.0
        for item in stranded:
            # unlocked read is safe here: the scheduler thread has
            # been joined above, teardown is single-threaded
            st = self._states[item.tenant]
            st.credits.release()
            st.depth_gauge.set(0)
            if item.qspan is not None:
                item.qspan.finish("error")
            if not item.future.done():
                item.future.set_exception(
                    SchedulerStopped("scheduler stopped"))
