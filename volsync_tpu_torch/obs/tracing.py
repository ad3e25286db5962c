"""Spans, trace context, the flight recorder and the device trace.

Ports ``volsync_tpu/obs/tracing.py``. Three layers, as in the
reference:

- **Spans**: named timers (``span("engine.read")``) recording durations
  into a process-wide registry (``span_totals()``, also split by
  outcome) AND the stage histogram
  ``volsync_stage_duration_seconds{stage,outcome}`` of the port's
  in-memory ``metrics.GLOBAL`` (the reference's family and buckets; the
  port does not depend on ``prometheus_client``). Spans are
  hierarchical when a :class:`TraceContext` is active: each span
  becomes the parent of spans opened inside it, and tenant-tagged
  contexts also feed ``volsync_svc_stage_seconds{tenant,stage}``.
  A span's attributes may be set while it is open (``h.set(...)``).
- **Flight recorder**: when the active context is sampled
  (``VOLSYNC_TRACE_SAMPLE``), finished spans land in a bounded
  in-process ring (``VOLSYNC_TRACE_RING``, default 131,072 events:
  six 50 s benchmark windows of 1 GiB restic syncs) exported as
  Chrome-trace-event JSON (Perfetto-loadable) via :func:`dump_trace`
  and ``volsync trace dump``. The ring holds compact tuples; the
  Chrome dicts are built only when it is read (:func:`trace_events`,
  :func:`chrome_trace`), and :func:`ring_stats` says how much of the
  past it still holds. The ring is sampled; the totals are not.
  :func:`record_trigger` marks shed / breaker-open / injected-fault /
  deadline (and the port's other operational) events in the ring and
  auto-dumps an annotated trace file when ``VOLSYNC_TRACE_DUMP`` is set
  (throttled per reason by ``VOLSYNC_TRACE_TRIGGER_INTERVAL_S``). The
  port also keeps the last 1,024 trigger events as plain records
  (:func:`triggers`), each with the trace id it fired under.
- **Device profiling**: ``device_trace()`` wraps a region with
  ``torch.profiler`` (where the reference takes a JAX profiler trace)
  when ``VOLSYNC_TRACE_DIR`` is set: where CUDA is available it records
  the card's activity (kernels, copies, memsets, from every thread),
  else the host's torch operators, and writes one Chrome trace under
  ``<VOLSYNC_TRACE_DIR>/<label>/``, also when the region raises.

One clock: the recorder's ``ts`` is microseconds since the Unix epoch
on CLOCK_REALTIME, the clock ``torch.profiler`` stamps host and device
events with, so a :func:`dump_trace` file and a profiler trace load
side by side in Perfetto on one timeline, and a span can be set beside
a device operation. Spans are timed with ``time.perf_counter()``
(CLOCK_MONOTONIC, which NTP does not step), and ``span_totals()`` and
the histograms keep those seconds. A ring tuple keeps the perf_counter
reading; while events are recorded the recorder pairs a perf_counter
reading with a realtime one at most once a second, and a read maps each
event's start and end by linear interpolation between the pairs around
it, as the profiler maps its own clock to realtime. The mapping only
rises, so events keep their order and nesting, and NTP's slewing of
realtime (up to 500 ppm) moves no event by more than the clocks drift
in a second.

Context propagation: the current :class:`TraceContext` lives in a
``contextvars.ContextVar``. It does NOT cross thread boundaries by
itself: every pipeline seam hands it over explicitly
(:func:`carry_context` for pool submissions and threads, :func:`use_context`
when a consumer thread processes an item that carried its producer's
context) and the gRPC client sends it to the server in
``x-volsync-trace`` metadata (:func:`format_trace_header` /
:func:`parse_trace_header`). A mover Job is one trace: the restic entry
runs each Job under a context whose ``stream_id`` is the Job's name,
and its file-hash pool, readahead thread, seal and upload pools and the
micro-batcher's passes carry it.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import dataclasses
import functools
import json
import logging
import os
import random
import socket
import threading
import time
from collections import defaultdict, deque
from typing import Optional

from volsync_tpu_torch import envflags
from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS

log = logging.getLogger(__name__)

_lock = lockcheck.make_lock("obs.spans")
_totals: dict = defaultdict(lambda: [0, 0.0])  # name -> [n, secs]
# (name, outcome) -> [n, secs]; outcome is "ok" or "error"
_outcomes: dict = defaultdict(lambda: [0, 0.0])

# Flight-recorder state. The ring holds one compact tuple an event,
# ``(ph, name, perf_counter seconds, tid, ctx, ...)``: a span
# ("X") adds its seconds, span id, outcome and attributes; a copy ("i")
# or trigger ("g") instant its args. ``_event`` builds the Chrome dict.
_PID = os.getpid()
_ring: deque = deque(maxlen=envflags.trace_ring_size())
_recorded = [0]  # events appended since the last reset_trace()
# (perf_counter s, realtime us) read together, at most once a second
# while the ring records: what a read maps perf_counter to realtime by
_PAIR_EVERY_S = 1.0
_pairs: deque = deque(maxlen=4096)
_thread_names: dict = {}
_trigger_last: dict = {}  # reason -> perf_counter of last dump
_dump_seq = [0]
_triggers: deque = deque(maxlen=1024)  # the port's plain trigger records


# -- trace context --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Identity of the request a span belongs to. ``span_id`` is the id
    of the *current* (innermost open) span: children record it as
    their parent."""

    trace_id: str
    span_id: str
    tenant: Optional[str] = None
    stream_id: Optional[str] = None
    sampled: bool = True

    def child(self, span_id: str) -> "TraceContext":
        return dataclasses.replace(self, span_id=span_id)

    def evolve(self, **changes) -> "TraceContext":
        return dataclasses.replace(self, **changes)


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "volsync_tpu_torch_trace_ctx", default=None)
_CURRENT = object()  # sentinel: "use whatever context is active"


def new_id() -> str:
    return os.urandom(8).hex()


def _sample_decision() -> bool:
    rate = envflags.trace_sample()
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return random.random() < rate


def current_context() -> Optional[TraceContext]:
    return _CTX.get()


def new_trace(tenant: Optional[str] = None,
              stream_id: Optional[str] = None,
              sampled: Optional[bool] = None) -> TraceContext:
    """Root context for a new request; the sampling decision is made
    once here and inherited by every span/child of the trace."""
    if sampled is None:
        sampled = _sample_decision()
    return TraceContext(trace_id=new_id(), span_id=new_id(), tenant=tenant,
                        stream_id=stream_id, sampled=sampled)


@contextlib.contextmanager
def trace_context(ctx: Optional[TraceContext] = None, *,
                  tenant: Optional[str] = None,
                  stream_id: Optional[str] = None,
                  sampled: Optional[bool] = None):
    """Activate ``ctx`` (or a fresh root trace) for the enclosed block."""
    if ctx is None:
        ctx = new_trace(tenant=tenant, stream_id=stream_id, sampled=sampled)
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def use_context(ctx: Optional[TraceContext]):
    """Like :func:`trace_context` but a no-op when ``ctx`` is None:
    the consumer-thread side of an explicit context handoff."""
    if ctx is None:
        yield None
        return
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def carry_context(fn, ctx: Optional[TraceContext] = None):
    """Wrap ``fn`` so it runs under the caller's current trace context
    (captured now) even when invoked later on a worker thread: the
    producer side of the thread-pool seam handoff. Returns ``fn``
    unchanged when there is nothing to carry."""
    captured = ctx if ctx is not None else _CTX.get()
    if captured is None:
        return fn

    @functools.wraps(fn)
    def _carried(*args, **kwargs):
        token = _CTX.set(captured)
        try:
            return fn(*args, **kwargs)
        finally:
            _CTX.reset(token)

    return _carried


# -- gRPC metadata wire format (x-volsync-trace) --------------------------

def format_trace_header(ctx: TraceContext) -> str:
    """``trace_id:span_id:stream_id:sampled``; the tenant is left out
    (the server trusts only its own token-derived tenant)."""
    return (f"{ctx.trace_id}:{ctx.span_id}:{ctx.stream_id or ''}:"
            f"{1 if ctx.sampled else 0}")


def parse_trace_header(value: Optional[str]) -> Optional[TraceContext]:
    """Inverse of :func:`format_trace_header`; None on anything
    malformed (an unparseable header degrades to a fresh root trace,
    never an error)."""
    if not value:
        return None
    parts = value.strip().split(":")
    if len(parts) != 4 or not parts[0] or not parts[1]:
        return None
    return TraceContext(trace_id=parts[0], span_id=parts[1], tenant=None,
                        stream_id=parts[2] or None, sampled=parts[3] != "0")


# -- spans ----------------------------------------------------------------

def _note_thread(tid: int) -> None:
    """Name ``tid`` for the trace's thread_name records (under _lock).
    Events carry the kernel's thread id, as the profiler's do: Python's
    ``get_ident`` is reused as soon as a thread exits."""
    if tid not in _thread_names:
        _thread_names[tid] = threading.current_thread().name


class _SpanHandle:
    """An open span. ``finish()`` is idempotent so error paths may
    finish eagerly and a ``finally`` can still call it."""

    __slots__ = ("name", "ctx", "span_id", "t0", "attrs", "_done")

    def __init__(self, name: str, ctx: Optional[TraceContext],
                 attrs: Optional[dict]):
        self.name = name
        self.ctx = ctx
        self.span_id = new_id() if ctx is not None else None
        self.attrs = attrs
        self._done = False
        self.t0 = time.perf_counter()

    def set(self, **attrs) -> None:
        """Add attributes known only once the span's work has run."""
        self.attrs = {**(self.attrs or {}), **attrs}

    def finish(self, outcome: str = "ok") -> None:
        if self._done:
            return
        self._done = True
        dt = time.perf_counter() - self.t0
        ctx = self.ctx
        with _lock:
            acc = _totals[self.name]
            acc[0] += 1
            acc[1] += dt
            oacc = _outcomes[(self.name, outcome)]
            oacc[0] += 1
            oacc[1] += dt
            if ctx is not None and ctx.sampled:
                tid = threading.get_native_id()
                _note_thread(tid)
                _ring.append(("X", self.name, self.t0, tid, ctx, dt,
                              self.span_id, outcome, self.attrs))
                _recorded[0] += 1
                _note_pair(self.t0 + dt)
        GLOBAL_METRICS.stage_duration.labels(
            stage=self.name, outcome=outcome).observe(dt)
        if ctx is not None and ctx.tenant:
            GLOBAL_METRICS.svc_stage_seconds.labels(
                tenant=ctx.tenant, stage=self.name).inc(dt)


def begin_span(name: str, ctx=_CURRENT, **attrs) -> _SpanHandle:
    """Open a span without a ``with`` block: for spans whose end lives
    on another thread (scheduler dispatch -> batcher done-callback) or
    inside a generator (gRPC stream handlers, where a contextvar set
    across ``yield`` would leak into the consuming thread). Pass
    ``ctx=None`` to force a context-free span, or a TraceContext to
    attribute the span to a request this thread is not running under."""
    if ctx is _CURRENT:
        ctx = _CTX.get()
    return _SpanHandle(name, ctx, attrs or None)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a named stage; feeds the span registry + the histogram,
    and (when a sampled TraceContext is active) the flight recorder,
    with spans opened inside nesting under this one."""
    h = begin_span(name, **attrs)
    token = None
    if h.ctx is not None and h.ctx.sampled:
        token = _CTX.set(h.ctx.child(h.span_id))
    try:
        yield h
    except BaseException:
        if token is not None:
            _CTX.reset(token)
            token = None
        h.finish("error")
        raise
    else:
        if token is not None:
            _CTX.reset(token)
        h.finish("ok")


def span_totals(by_outcome: bool = False) -> dict:
    """``{stage: (count, total seconds)}``. With ``by_outcome=True``:
    ``{(stage, outcome): (count, seconds)}`` so failing stages are
    distinguishable from succeeding ones."""
    with _lock:
        if by_outcome:
            return {k: (v[0], v[1]) for k, v in _outcomes.items()}
        return {k: (v[0], v[1]) for k, v in _totals.items()}


def reset_spans() -> None:
    """Zero the span registry AND the metric series it populated
    (volsync_stage_duration_seconds / volsync_svc_stage_seconds) so
    stage timings cannot bleed across tests/bench rounds."""
    with _lock:
        _totals.clear()
        _outcomes.clear()
    GLOBAL_METRICS.stage_duration.clear()
    GLOBAL_METRICS.svc_stage_seconds.clear()


# -- flight recorder ------------------------------------------------------

def trace_instant(name: str, **args) -> None:
    """Thread-scoped instant event (Chrome ``ph="i"``) into the flight
    recorder when a SAMPLED trace context is active; no-op otherwise.
    The event lands at the current timestamp on the calling thread, so
    in Perfetto it nests visually under whatever stage span is open:
    the copy ledger uses this to attribute sanctioned host copies to
    the pipeline stage that paid them."""
    ctx = _CTX.get()
    if ctx is None or not ctx.sampled:
        return
    t = time.perf_counter()
    tid = threading.get_native_id()
    with _lock:
        _note_thread(tid)
        _ring.append(("i", name, t, tid, ctx, args))
        _recorded[0] += 1
        _note_pair(t)


def _note_pair(t: float) -> None:
    """Pair the two clocks when the last pair is a second older than
    ``t``, a perf_counter reading (under _lock). Of a few tries, the
    realtime reading whose perf_counter bracket is tightest."""
    if _pairs and t - _pairs[-1][0] < _PAIR_EVERY_S:
        return
    best = None
    for _ in range(3):
        a = time.perf_counter()
        r = time.time_ns()
        b = time.perf_counter()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) / 2, r / 1e3)
    _pairs.append(best[1:])


def _snapshot() -> tuple:
    """(ring tuples, thread names, perf_counter -> realtime us) now."""
    with _lock:
        _note_pair(time.perf_counter())
        recs = list(_ring)
        threads = dict(_thread_names)
        pairs = list(_pairs)
    at = [p for p, _ in pairs]

    def realtime_us(t: float) -> float:
        i = bisect.bisect_right(at, t)
        if i in (0, len(pairs)):  # outside the pairs: the nearest's offset
            p, r = pairs[min(i, len(pairs) - 1)]
            return r + (t - p) * 1e6
        (p0, r0), (p1, r1) = pairs[i - 1], pairs[i]
        return r0 + (t - p0) * (r1 - r0) / (p1 - p0)

    return recs, threads, realtime_us


def _event(rec: tuple, realtime_us) -> dict:
    """One ring tuple as a Chrome trace event on realtime."""
    ph, name, t, tid, ctx = rec[:5]
    ev = {"name": name, "cat": "span", "ph": ph, "ts": realtime_us(t),
          "pid": _PID, "tid": tid}
    if ph == "X":
        dt, span_id, outcome, attrs = rec[5:]
        args = {"trace_id": ctx.trace_id, "span_id": span_id,
                "parent_span_id": ctx.span_id, "outcome": outcome}
        if ctx.tenant:
            args["tenant"] = ctx.tenant
        if ctx.stream_id:
            args["stream_id"] = ctx.stream_id
        if attrs:
            args.update(attrs)
        ev["dur"] = realtime_us(t + dt) - ev["ts"]
    elif ph == "i":
        ev.update(cat="copy", s="t")
        args = {**rec[5], "trace_id": ctx.trace_id,
                "parent_span_id": ctx.span_id}
    else:
        ev.update(cat="trigger", ph="i", s="g")
        args = dict(rec[5])
    ev["args"] = args
    return ev


def trace_events() -> list:
    """Snapshot of the ring buffer (Chrome trace events, oldest first)."""
    recs, _, realtime_us = _snapshot()
    return [_event(r, realtime_us) for r in recs]


def ring_stats() -> dict:
    """The ring's ``capacity``, the events it ``held``, the events
    ``recorded`` since the last :func:`reset_trace` (more than held once
    it wrapped), and ``oldest_ts``: the realtime microseconds of its
    oldest event (None when empty). A reader of a window finds every
    sampled event of it only where ``oldest_ts`` is before the window."""
    recs, _, realtime_us = _snapshot()
    with _lock:
        out = {"capacity": _ring.maxlen, "held": len(_ring),
               "recorded": _recorded[0]}
    out["oldest_ts"] = realtime_us(recs[0][2]) if recs else None
    return out


def chrome_trace(trigger: Optional[str] = None,
                 annotations: Optional[dict] = None) -> dict:
    """The ring buffer as a Chrome-trace-event JSON document (load in
    Perfetto / chrome://tracing). ``trigger`` stamps a top-level
    annotation describing why the dump was taken."""
    recs, threads, realtime_us = _snapshot()
    events = [_event(r, realtime_us) for r in recs]
    meta = [{"name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
             "args": {"name": tname}}
            for tid, tname in sorted(threads.items())]
    doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    if trigger is not None:
        # "reason" is the trigger's own key; annotations cannot shadow it
        doc["trigger"] = {**(annotations or {}), "reason": trigger}
    return doc


def dump_trace(path: Optional[str] = None, trigger: Optional[str] = None,
               annotations: Optional[dict] = None) -> Optional[str]:
    """Write the flight recorder to ``path`` (or an auto-numbered file
    under ``VOLSYNC_TRACE_DUMP``). Returns the path written, or None
    when no path was given and no dump dir is configured."""
    doc = chrome_trace(trigger=trigger, annotations=annotations)
    if path is None:
        dump_dir = envflags.trace_dump_dir()
        if not dump_dir:
            return None
        with _lock:
            _dump_seq[0] += 1
            seq = _dump_seq[0]
        path = os.path.join(dump_dir,
                            f"trace-{trigger or 'manual'}-{seq:04d}.json")
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    return path


def record_trigger(reason: str, /, **annotations) -> Optional[str]:
    """Mark an operational event (shed, breaker_open, fault, deadline,
    takeover, fenced publish, read-repair heal, verify failure, ...) as
    an instant event in the ring, and (when ``VOLSYNC_TRACE_DUMP`` is
    set) auto-dump an annotated trace file, throttled per reason by
    ``VOLSYNC_TRACE_TRIGGER_INTERVAL_S``. Returns the dump's path, or
    None. Never raises: callers sit on error paths (often holding their
    own locks) and must not gain new failure modes from
    observability."""
    now = time.perf_counter()
    ctx = _CTX.get()
    with _lock:
        tid = threading.get_native_id()
        _note_thread(tid)
        _ring.append(("g", "trigger." + reason, now, tid, None,
                      dict(annotations)))
        _recorded[0] += 1
        _note_pair(now)
        _triggers.append({
            "reason": reason, "time": time.time(),
            "thread": threading.current_thread().name,
            "trace_id": ctx.trace_id if ctx is not None else None,
            "args": dict(annotations)})
    if envflags.trace_dump_dir() is None:
        return None
    interval = envflags.trace_trigger_interval()
    with _lock:
        last = _trigger_last.get(reason)
        if last is not None and now - last < interval:
            return None
        _trigger_last[reason] = now
    try:
        return dump_trace(trigger=reason, annotations=dict(annotations))
    except OSError as exc:
        log.warning("flight-recorder dump for trigger %r failed: %s",
                    reason, exc)
        return None


def triggers() -> list:
    """The port's record of the last 1,024 trigger events, oldest
    first: ``{"reason", "time", "thread", "trace_id", "args"}``."""
    with _lock:
        return list(_triggers)


def reset_trace() -> None:
    """Clear the flight recorder (ring + thread map + trigger
    throttles); the ring is re-sized from VOLSYNC_TRACE_RING."""
    global _ring
    with _lock:
        _ring = deque(maxlen=envflags.trace_ring_size())
        _recorded[0] = 0
        _pairs.clear()
        _thread_names.clear()
        _trigger_last.clear()


# -- device profiling -----------------------------------------------------

@contextlib.contextmanager
def device_trace(label: str = "volsync"):
    """Profiler trace of the wrapped region when VOLSYNC_TRACE_DIR is
    set; no-op otherwise. ``torch.profiler`` where the reference takes
    a JAX profiler trace: where CUDA is available it records the card's
    activity (kernels, copies, memsets, from every thread), else the
    host's torch operators, and writes one Chrome trace
    (``chrome://tracing``, Perfetto) under
    ``<VOLSYNC_TRACE_DIR>/<label>/``, also when the region raises."""
    trace_dir = envflags.trace_dir()
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(trace_dir, label)
    os.makedirs(out, exist_ok=True)
    prof = profile(activities=[ProfilerActivity.CUDA
                               if torch.cuda.is_available()
                               else ProfilerActivity.CPU])
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            out, f"{socket.gethostname()}.{os.getpid()}."
                 f"{time.time_ns()}.pt.trace.json"))
