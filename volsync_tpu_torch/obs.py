"""Minimal observability for the port: spans, trace context, trigger
marks and a copy counter.

Ports the calls the port's modules make into ``volsync_tpu/obs``:
from ``obs/tracing.py`` ``span`` (with attributes), the handle form
``begin_span`` (a span whose end lives on another thread or inside a
generator), ``new_trace``, ``carry_context``, ``current_context``,
``use_context``, ``trace_context``, the ``x-volsync-trace`` wire form
(``format_trace_header`` / ``parse_trace_header``), ``reset_spans`` and
``record_trigger``; ``record_copy`` from ``obs/copyledger.py``; and
``device_trace`` (a ``torch.profiler`` trace where the reference takes
a JAX profiler one), so call sites read as in the reference. There is
no Prometheus export and no flight-recorder dump: a span sums host wall
time per name (``span_totals()``), and per (tenant,
stage) when its context names a tenant (``stage_seconds_by_tenant()``:
the service's ``svc.*`` spans carry their stream's trace, so they bill
to its tenant); ``record_trigger`` keeps the last events in a bounded
list (``triggers()``); ``record_copy`` sums bytes per site
(``copy_totals()``).

Context propagation is the reference's: the current ``TraceContext``
lives in a ``contextvars.ContextVar`` that does not cross threads by
itself. ``carry_context`` wraps a function submitted to a pool so it
runs under the submitter's context; ``use_context`` re-enters a
captured context on a consumer thread. A span opened under a sampled
context becomes the parent of the spans opened inside it. Every trace
is sampled unless its maker says otherwise (the port keeps no flight
recorder for a sampling rate to bound).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import os
import socket
import threading
import time
from collections import defaultdict, deque
from typing import Optional

from volsync_tpu_torch import envflags

_lock = threading.Lock()
_spans: dict = defaultdict(lambda: [0, 0.0])  # name -> [count, seconds]
_tenant_stage: dict = defaultdict(float)  # (tenant, stage) -> seconds
_copies: dict = defaultdict(int)  # site -> bytes
_triggers: deque = deque(maxlen=1024)


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Identity of the request a span belongs to; ``span_id`` is the id
    of the innermost open span."""

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


def new_id() -> str:
    return os.urandom(8).hex()


_CURRENT = object()  # sentinel: "use whatever context is active"


def current_context() -> Optional[TraceContext]:
    return _CTX.get()


def new_trace(tenant: Optional[str] = None,
              stream_id: Optional[str] = None,
              sampled: bool = True) -> TraceContext:
    """Root context for a new request; every span and child of the
    trace inherits ``sampled``."""
    return TraceContext(trace_id=new_id(), span_id=new_id(), tenant=tenant,
                        stream_id=stream_id, sampled=sampled)


@contextlib.contextmanager
def trace_context(ctx: Optional[TraceContext] = None, *,
                  tenant: Optional[str] = None,
                  stream_id: Optional[str] = None, sampled: bool = True):
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
    """Like ``trace_context`` but a no-op when ``ctx`` is None: the
    consumer-thread side of an explicit context handoff."""
    if ctx is None:
        yield None
        return
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def carry_context(fn, ctx: Optional[TraceContext] = None):
    """Wrap ``fn`` so it runs under the caller's current context
    (captured now) when a worker thread calls it later. Returns ``fn``
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

class _SpanHandle:
    """An open span. ``finish()`` is idempotent, so error paths may
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
        """Close the span; ``outcome`` ("ok" or "error") is the
        reference's label, which the port's totals do not split by."""
        if self._done:
            return
        self._done = True
        dt = time.perf_counter() - self.t0
        with _lock:
            entry = _spans[self.name]
            entry[0] += 1
            entry[1] += dt
            if self.ctx is not None and self.ctx.tenant:
                _tenant_stage[(self.ctx.tenant, self.name)] += dt


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
    """Time a named host stage (wall clock, summed per name and outcome
    and, under a tenant's context, per (tenant, name)); under a sampled
    context, spans opened inside nest under this one."""
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


def record_trigger(reason: str, /, **annotations) -> None:
    """Mark an operational event (takeover, fenced publish, deadline,
    read-repair heal, verify failure). Never raises."""
    ctx = _CTX.get()
    with _lock:
        _triggers.append({
            "reason": reason, "time": time.time(),
            "thread": threading.current_thread().name,
            "trace_id": ctx.trace_id if ctx is not None else None,
            "args": dict(annotations)})


def record_copy(site: str, nbytes: int) -> None:
    """Account ``nbytes`` host bytes copied at ``site``."""
    if nbytes <= 0:
        return
    with _lock:
        _copies[site] += nbytes


def span_totals() -> dict:
    """``{name: (count, total seconds)}``."""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _spans.items()}


def reset_spans() -> None:
    """Zero the span registry (totals and tenant stages), so stage
    timings cannot bleed across tests or bench rounds."""
    with _lock:
        _spans.clear()
        _tenant_stage.clear()


def stage_seconds_by_tenant() -> dict:
    """``{(tenant, stage): seconds}`` of spans finished under a context
    that names a tenant."""
    with _lock:
        return dict(_tenant_stage)


def triggers() -> list:
    """The recorded trigger events, oldest first."""
    with _lock:
        return list(_triggers)


def copy_totals() -> dict:
    """``{site: bytes}``."""
    with _lock:
        return dict(_copies)


@contextlib.contextmanager
def device_trace(label: str = "volsync"):
    """Profiler trace of the wrapped region when VOLSYNC_TRACE_DIR is
    set; no-op otherwise. Ports ``device_trace`` of
    ``volsync_tpu/obs/tracing.py`` on ``torch.profiler``: where CUDA is
    available it records the card's activity (kernels, copies, memsets,
    from every thread), else the host's torch operators, and writes one
    Chrome trace (``chrome://tracing``, Perfetto) under
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
