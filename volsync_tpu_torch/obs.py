"""Minimal observability for the port: stage timers, trace context,
trigger marks and a copy counter.

Ports the calls the port's modules make into ``volsync_tpu/obs``:
``span``, ``carry_context``, ``current_context``, ``use_context``,
``trace_context`` and ``record_trigger`` from ``obs/tracing.py``, and
``record_copy`` from ``obs/copyledger.py``, so call sites read as in the
reference. There is no Prometheus export and no trace dump: ``span``
sums host wall time per name (``span_totals()``), and per (tenant,
stage) when the active context names a tenant
(``stage_seconds_by_tenant()``); ``record_trigger`` keeps the last
events in a bounded list (``triggers()``); ``record_copy`` sums bytes
per site (``copy_totals()``).

Context propagation is the reference's: the current ``TraceContext``
lives in a ``contextvars.ContextVar`` that does not cross threads by
itself. ``carry_context`` wraps a function submitted to a pool so it
runs under the submitter's context; ``use_context`` re-enters a
captured context on a consumer thread. A span opened under a sampled
context becomes the parent of the spans opened inside it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import os
import threading
import time
from collections import defaultdict, deque
from typing import Optional

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


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "volsync_tpu_torch_trace_ctx", default=None)


def new_id() -> str:
    return os.urandom(8).hex()


def current_context() -> Optional[TraceContext]:
    return _CTX.get()


@contextlib.contextmanager
def trace_context(ctx: Optional[TraceContext] = None, *,
                  tenant: Optional[str] = None,
                  stream_id: Optional[str] = None, sampled: bool = True):
    """Activate ``ctx`` (or a fresh root trace) for the enclosed block."""
    if ctx is None:
        ctx = TraceContext(trace_id=new_id(), span_id=new_id(),
                           tenant=tenant, stream_id=stream_id,
                           sampled=sampled)
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


@contextlib.contextmanager
def span(name: str):
    """Time a named host stage (wall clock, summed per name and, under a
    tenant's context, per (tenant, name))."""
    ctx = _CTX.get()
    token = None
    if ctx is not None and ctx.sampled:
        token = _CTX.set(ctx.child(new_id()))
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if token is not None:
            _CTX.reset(token)
        with _lock:
            entry = _spans[name]
            entry[0] += 1
            entry[1] += dt
            if ctx is not None and ctx.tenant:
                _tenant_stage[(ctx.tenant, name)] += dt


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
