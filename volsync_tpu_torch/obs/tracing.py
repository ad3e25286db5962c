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
  contexts also feed ``volsync_svc_stage_seconds{tenant,stage}`` and
  ``stage_seconds_by_tenant()``.
- **Flight recorder**: when the active context is sampled
  (``VOLSYNC_TRACE_SAMPLE``), finished spans land in a bounded
  in-process ring (``VOLSYNC_TRACE_RING``, default 4096) exported as
  Chrome-trace-event JSON (Perfetto-loadable) via :func:`dump_trace`
  and ``volsync trace dump``. The ring is sampled; the totals are not.
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

Context propagation: the current :class:`TraceContext` lives in a
``contextvars.ContextVar``. It does NOT cross thread boundaries by
itself: every pipeline seam hands it over explicitly
(:func:`carry_context` for pool submissions, :func:`use_context` when a
consumer thread processes an item that carried its producer's context)
and the gRPC client sends it to the server in ``x-volsync-trace``
metadata (:func:`format_trace_header` / :func:`parse_trace_header`).
"""

from __future__ import annotations

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
_tenant_stage: dict = defaultdict(float)  # (tenant, stage) -> seconds

# Flight-recorder state. Events are stored ready-made in Chrome trace
# event format so export is a snapshot + json.dump. Timestamps are
# microseconds since this module's perf_counter epoch.
_EPOCH = time.perf_counter()
_PID = os.getpid()
_ring: deque = deque(maxlen=envflags.trace_ring_size())
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
    """Name ``tid`` for the trace's thread_name records (under _lock)."""
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
            if ctx is not None and ctx.tenant:
                _tenant_stage[(ctx.tenant, self.name)] += dt
            if ctx is not None and ctx.sampled:
                tid = threading.get_ident()
                _note_thread(tid)
                args = {"trace_id": ctx.trace_id, "span_id": self.span_id,
                        "parent_span_id": ctx.span_id, "outcome": outcome}
                if ctx.tenant:
                    args["tenant"] = ctx.tenant
                if ctx.stream_id:
                    args["stream_id"] = ctx.stream_id
                if self.attrs:
                    args.update(self.attrs)
                _ring.append({
                    "name": self.name, "cat": "span", "ph": "X",
                    "ts": (self.t0 - _EPOCH) * 1e6, "dur": dt * 1e6,
                    "pid": _PID, "tid": tid, "args": args})
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


def stage_seconds_by_tenant() -> dict:
    """``{(tenant, stage): seconds}`` for spans finished under a
    tenant-tagged context: the in-process mirror of
    ``volsync_svc_stage_seconds`` that benches read."""
    with _lock:
        return dict(_tenant_stage)


def reset_spans() -> None:
    """Zero the span registry AND the metric series it populated
    (volsync_stage_duration_seconds / volsync_svc_stage_seconds) so
    stage timings cannot bleed across tests/bench rounds."""
    with _lock:
        _totals.clear()
        _outcomes.clear()
        _tenant_stage.clear()
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
    tid = threading.get_ident()
    with _lock:
        _note_thread(tid)
        _ring.append({
            "name": name, "cat": "copy", "ph": "i", "s": "t",
            "ts": (time.perf_counter() - _EPOCH) * 1e6,
            "pid": _PID, "tid": tid,
            "args": {**args, "trace_id": ctx.trace_id,
                     "parent_span_id": ctx.span_id}})


def trace_events() -> list:
    """Snapshot of the ring buffer (Chrome trace events, oldest first)."""
    with _lock:
        return list(_ring)


def chrome_trace(trigger: Optional[str] = None,
                 annotations: Optional[dict] = None) -> dict:
    """The ring buffer as a Chrome-trace-event JSON document (load in
    Perfetto / chrome://tracing). ``trigger`` stamps a top-level
    annotation describing why the dump was taken."""
    with _lock:
        events = list(_ring)
        threads = dict(_thread_names)
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
        tid = threading.get_ident()
        _note_thread(tid)
        _ring.append({"name": "trigger." + reason, "cat": "trigger",
                      "ph": "i", "s": "g", "ts": (now - _EPOCH) * 1e6,
                      "pid": _PID, "tid": tid, "args": dict(annotations)})
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
