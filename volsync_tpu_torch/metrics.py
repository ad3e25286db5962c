"""In-memory stand-in for the reference's Prometheus metrics.

Ports the part of ``volsync_tpu/metrics.py`` that the port's repository,
index, resilience, pack-cache, restore, scrub and repack modules, the
protocol planner, the service plane (admission, scheduler), the fleet,
the continuous GC and the session supervisor touch:
the families of ``GLOBAL`` with the reference's names and label sets,
each an in-memory counter or gauge with the
``labels(...).inc/dec/set/observe`` shape. The reference builds
them on ``prometheus_client``, which the port does not depend on;
nothing here is exported over HTTP. A family's ``values()`` reads its
series, keyed by label values.
"""

from __future__ import annotations

import threading


class _Child:
    """One labelled series: a float value behind a lock."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def observe(self, value: float) -> None:
        self.inc(value)


class _Family:
    """A metric family: ``labels(**kw)`` returns its child series; a
    family without labels is its own single series."""

    def __init__(self, name: str, labelnames: tuple = ()):
        self.name = name
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict = {}

    def labels(self, **kw) -> _Child:
        if set(kw) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(kw)} != "
                             f"{sorted(self.labelnames)}")
        key = tuple(str(kw[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child()
            return child

    def _only(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name} needs labels "
                             f"{list(self.labelnames)}")
        return self.labels()

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def observe(self, value: float) -> None:
        self._only().observe(value)

    def values(self) -> dict:
        with self._lock:
            return {k: c.value for k, c in self._children.items()}


#: attribute -> (reference metric name, label names)
_FAMILIES = {
    "pipeline_depth": ("volsync_pipeline_queue_depth", ("stage",)),
    "retry_attempts": ("volsync_retry_attempts_total", ("site", "outcome")),
    "breaker_state": ("volsync_breaker_state", ("backend",)),
    "breaker_transitions": ("volsync_breaker_transitions_total",
                            ("backend", "to")),
    "index_queries": ("volsync_index_queries_total", ("result",)),
    "index_prefilter": ("volsync_index_prefilter_total", ("outcome",)),
    "index_prefilter_saturation": ("volsync_index_prefilter_saturation",
                                   ()),
    "repo_lock_age": ("volsync_repo_lock_age_seconds", ()),
    "repo_writer_generation": ("volsync_repo_writer_generation", ()),
    "repo_pending_delete_packs": ("volsync_repo_pending_delete_packs", ()),
    "repo_takeovers_total": ("volsync_repo_takeovers_total", ()),
    "repo_fenced_publishes_total": ("volsync_repo_fenced_publishes_total",
                                    ()),
    "restore_cache_hits": ("volsync_restore_cache_hits_total", ()),
    "restore_cache_misses": ("volsync_restore_cache_misses_total", ()),
    "restore_cache_evictions": ("volsync_restore_cache_evictions_total", ()),
    "restore_bytes": ("volsync_restore_bytes_total", ()),
    "scrub_packs": ("volsync_scrub_packs_total", ("outcome",)),
    "scrub_bytes": ("volsync_scrub_bytes_total", ()),
    "repack_cycles": ("volsync_repack_cycles_total", ("outcome",)),
    "repack_packs": ("volsync_repack_packs_total", ()),
    "svc_protocol_selected": ("volsync_svc_protocol_selected_total",
                              ("protocol", "reason")),
    "svc_admitted": ("volsync_svc_admitted_total", ("tenant",)),
    "svc_shed": ("volsync_svc_shed_total", ("tenant", "reason")),
    "svc_active_streams": ("volsync_svc_active_streams", ("tenant",)),
    "svc_queue_depth": ("volsync_svc_queue_depth", ("tenant",)),
    "svc_sched_latency": ("volsync_svc_sched_latency_seconds", ("tenant",)),
    "svc_deadline_exceeded": ("volsync_svc_deadline_exceeded_total",
                              ("tenant",)),
    "fleet_replica_headroom": ("volsync_fleet_replica_headroom",
                               ("replica",)),
    "fleet_routed_total": ("volsync_fleet_routed_total", ("replica",)),
    "fleet_failovers_total": ("volsync_fleet_failovers_total", ()),
    "gc_cycles": ("volsync_gc_cycles_total", ("outcome",)),
    "session_state": ("volsync_session_state", ("backend",)),
    "session_transitions": ("volsync_session_transitions_total",
                            ("backend", "to")),
    "session_recycles": ("volsync_session_recycles_total",
                         ("backend", "cause")),
    "session_keepalives": ("volsync_session_keepalive_total",
                           ("backend", "outcome")),
    "session_fenced_writes": ("volsync_session_fenced_writes_total",
                              ("backend",)),
}


class Metrics:
    """The metric families the port's modules use (module docstring)."""

    def __init__(self):
        for attr, (name, labels) in _FAMILIES.items():
            setattr(self, attr, _Family(name, labels))


GLOBAL = Metrics()
