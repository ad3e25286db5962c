"""Admission control for the mover-jax service plane.

Ports ``volsync_tpu/service/admission.py`` whole.

"Reexamining Paradigms of End-to-End Data Movement" (PAPERS.md) argues
the end-to-end path — admission, scheduling, flow control — decides
delivered goodput, not the kernel alone. This module is the admission
half: every ChunkHash stream passes through :class:`AdmissionController`
BEFORE any bytes are read, and is either admitted (a
:class:`StreamTicket` the handler releases when the stream ends) or
shed right there with a reason and a retry-after hint. The server maps
a shed to ``RESOURCE_EXHAUSTED`` + ``x-volsync-retry-after-ms``
trailing metadata — overload is visible to the client in one RTT
instead of surfacing mid-stream as a timeout.

Shed reasons:

- ``breaker_open``    — the wired resilience circuit breaker
                        (resilience.py) is open: the backend is
                        known-sick, so new work is refused in <10 ms
                        with the remaining cooldown as the hint.
- ``global_streams``  — VOLSYNC_SVC_MAX_STREAMS concurrent streams.
- ``tenant_streams``  — the tenant's own stream cap.
- ``overload``        — the scheduler backlog is at
                        VOLSYNC_SVC_MAX_QUEUED segments.
- ``draining``        — stop() is in progress; the server maps this
                        one to UNAVAILABLE, not RESOURCE_EXHAUSTED.

Quota sheds carry a **decorrelated-jitter** retry-after hint (the
resilience.py backoff discipline applied to hints): each hint is drawn
from ``[base, prev*3]`` capped at 10x base, so N clients shed in the
same instant retry spread out instead of re-colliding as a thundering
herd — which matters once multiple fleet replicas share one backlog
signal. Breaker sheds keep the breaker's exact remaining cooldown.

Cross-replica admission (service/fleet.py): when a ``sibling_fn`` is
wired, every shed also carries the address of a sibling replica with
advertised headroom — the server stamps it into ``x-volsync-sibling``
trailing metadata so a shed client retries *there* instead of
re-offering the hot replica the same stream.

Admitted/shed counts are kept per tenant in the port's in-memory
``volsync_svc_admitted_total{tenant}`` /
``volsync_svc_shed_total{tenant,reason}``; active streams as a gauge.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional

from volsync_tpu_torch import envflags
from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS
from volsync_tpu_torch.obs import record_trigger, span
from volsync_tpu_torch.service.tenants import TenantRegistry


class AdmissionRejected(Exception):
    """A stream shed at admission. ``retry_after`` is the hint in
    seconds the server stamps into trailing metadata; ``sibling`` (when
    a fleet router is wired) is the ``host:port`` of a replica with
    advertised headroom the client should retry against."""

    def __init__(self, tenant: str, reason: str, retry_after: float,
                 sibling: Optional[str] = None):
        at = f"; sibling {sibling}" if sibling else ""
        super().__init__(
            f"stream for tenant {tenant!r} shed at admission "
            f"({reason}); retry after {retry_after:.3f}s{at}")
        self.tenant = tenant
        self.reason = reason
        self.retry_after = retry_after
        self.sibling = sibling


@dataclass
class StreamTicket:
    """One admitted stream; hand it back via release()."""

    tenant: str
    #: high-water mark of request bytes the handler buffered beyond the
    #: segment in flight — observability for the credit-based pause
    buffered_high_water: int = 0
    #: TraceContext of the stream span — the handler threads it through
    #: the scheduler so device-batch spans attribute to this stream
    trace: object = None
    #: relative queue-wait deadline (seconds) from the stream's
    #: deadline class; None = no deadline (pure WDRR)
    deadline: Optional[float] = None
    _released: bool = field(default=False, repr=False)


class AdmissionController:
    """Bounds in-flight streams and queued segments, globally and per
    tenant, and sheds immediately while the wired circuit breaker is
    open or the server is draining.

    ``queue_depth_fn`` reports the scheduler's total queued segments
    (None = no segment-backlog gate). ``breaker`` is a
    resilience.CircuitBreaker (or None). ``sibling_fn`` (fleet mode)
    returns the ``host:port`` of a sibling replica with headroom, or
    None — attached to every shed. ``clock`` and ``jitter_rng`` are
    injectable for tests (the rng drives the decorrelated retry-after
    jitter; a seeded ``random.Random`` makes hints reproducible)."""

    def __init__(self, registry: TenantRegistry, *,
                 max_streams: Optional[int] = None,
                 tenant_streams: Optional[int] = None,
                 max_queued: Optional[int] = None,
                 retry_after: Optional[float] = None,
                 breaker=None,
                 queue_depth_fn: Optional[Callable[[], int]] = None,
                 sibling_fn: Optional[Callable[[], Optional[str]]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 jitter_rng: Optional[random.Random] = None):
        self.registry = registry
        self.max_streams = (envflags.svc_max_streams()
                            if max_streams is None else max(1, max_streams))
        self.tenant_streams = (envflags.svc_tenant_streams()
                               if tenant_streams is None
                               else max(1, tenant_streams))
        self.max_queued = (envflags.svc_max_queued()
                           if max_queued is None else max(1, max_queued))
        self.retry_after = (envflags.svc_retry_after_ms() / 1000.0
                            if retry_after is None else retry_after)
        self.breaker = breaker
        self._queue_depth = queue_depth_fn
        self._sibling = sibling_fn
        self._clock = clock
        # decorrelated jitter over retry-after hints: state + rng live
        # under the same lock as the counters (one shed = one draw)
        self._rng = jitter_rng if jitter_rng is not None else random.Random()
        self._hint_prev = self.retry_after
        # own tiny lock: _shed runs both outside and INSIDE self._lock,
        # so the jitter state cannot share it
        self._hint_lock = lockcheck.make_lock("service.admission.hint")
        self._lock = lockcheck.make_lock("service.admission")
        self._counts: dict[str, int] = {}
        self._total = 0
        self._draining = False
        # set whenever no stream is in flight (stop() waits on it)
        self._idle = threading.Event()
        self._idle.set()
        # cached per-tenant metric children (one .labels() per tenant,
        # not per stream)
        self._admitted_c: dict = {}
        self._shed_c: dict = {}
        self._active_g: dict = {}

    # -- metrics plumbing --------------------------------------------------

    def _admitted(self, tenant: str):
        c = self._admitted_c.get(tenant)
        if c is None:
            c = self._admitted_c[tenant] = \
                GLOBAL_METRICS.svc_admitted.labels(tenant=tenant)
        return c

    def _shed_counter(self, tenant: str, reason: str):
        c = self._shed_c.get((tenant, reason))
        if c is None:
            c = self._shed_c[(tenant, reason)] = \
                GLOBAL_METRICS.svc_shed.labels(tenant=tenant, reason=reason)
        return c

    def _active(self, tenant: str):
        g = self._active_g.get(tenant)
        if g is None:
            g = self._active_g[tenant] = \
                GLOBAL_METRICS.svc_active_streams.labels(tenant=tenant)
        return g

    def _jittered_hint(self) -> float:
        """Decorrelated jitter (resilience.py's backoff discipline) over
        the base retry-after: each hint is uniform in [base, prev*3],
        capped at 10x base. Clients shed in the same instant draw
        different hints, so they do not return as a thundering herd."""
        base = self.retry_after
        with self._hint_lock:
            hint = min(base * 10.0,
                       self._rng.uniform(base, max(base, self._hint_prev * 3)))
            self._hint_prev = hint
        return hint

    def _shed(self, tenant: str, reason: str,
              retry_after: Optional[float] = None) -> AdmissionRejected:
        self._shed_counter(tenant, reason).inc()
        sibling = self._sibling() if self._sibling is not None else None
        # Flight-recorder annotation: what the service was doing right
        # before it started refusing work (auto-dumps when armed).
        record_trigger("shed", tenant=tenant, cause=reason,
                       sibling=sibling)
        return AdmissionRejected(
            tenant, reason,
            self._jittered_hint() if retry_after is None else retry_after,
            sibling=sibling)

    # -- the gate ----------------------------------------------------------

    def tenant_from(self, metadata: Mapping[str, object]) -> str:
        return self.registry.resolve(metadata)

    def admit_stream(self, tenant: str) -> StreamTicket:
        """Admit or raise AdmissionRejected. Constant-time-ish: one
        breaker peek, one queue-depth read, one dict update under the
        lock — the <10 ms shed path the acceptance test pins down."""
        with span("svc.admit"):
            cfg = self.registry.config(tenant)
            if self.breaker is not None:
                remaining = self.breaker.open_remaining()
                if remaining > 0:
                    raise self._shed(tenant, "breaker_open",
                                     retry_after=remaining)
            if self._queue_depth is not None:
                if self._queue_depth() >= self.max_queued:
                    raise self._shed(tenant, "overload")
            with self._lock:
                if self._draining:
                    raise self._shed(tenant, "draining")
                if self._total >= self.max_streams:
                    raise self._shed(tenant, "global_streams")
                tenant_cap = (cfg.max_streams if cfg.max_streams is not None
                              else self.tenant_streams)
                held = self._counts.get(tenant, 0)
                if held >= tenant_cap:
                    raise self._shed(tenant, "tenant_streams")
                self._counts[tenant] = held + 1
                self._total += 1
                self._idle.clear()
            self._admitted(tenant).inc()
            self._active(tenant).inc()
            return StreamTicket(tenant=tenant)

    def release(self, ticket: StreamTicket) -> None:
        with self._lock:
            if ticket._released:
                return
            ticket._released = True
            self._counts[ticket.tenant] = \
                max(0, self._counts.get(ticket.tenant, 0) - 1)
            self._total = max(0, self._total - 1)
            if self._total == 0:
                self._idle.set()
        self._active(ticket.tenant).dec()

    # -- drain (server stop ordering) --------------------------------------

    def begin_drain(self) -> None:
        """Stop admitting: every later admit_stream sheds with reason
        "draining" (mapped to UNAVAILABLE by the server)."""
        with self._lock:
            self._draining = True
            if self._total == 0:
                self._idle.set()

    def wait_idle(self, timeout: float) -> bool:
        """True once no stream is in flight (bounded wait)."""
        return self._idle.wait(timeout)

    def active_streams(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is None:
                return self._total
            return self._counts.get(tenant, 0)

    def headroom(self) -> int:
        """Streams this controller could still admit right now (0 while
        draining) — what a fleet replica advertises in its heartbeat
        stamp so the router can route new streams by capacity."""
        with self._lock:
            if self._draining:
                return 0
            return max(0, self.max_streams - self._total)
