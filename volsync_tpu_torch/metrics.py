"""In-memory stand-in for the reference's Prometheus metrics.

Ports the part of ``volsync_tpu/metrics.py`` that the port's repository,
index, resilience, pack-cache, restore, scrub and repack modules, the
protocol planner, the service plane (admission, scheduler), the fleet,
the continuous GC, the session supervisor and the flight recorder
(``obs/``) touch:
the families of ``GLOBAL`` with the reference's names and label sets,
each an in-memory counter or gauge with the
``labels(...).inc/dec/set/observe`` shape, and the stage histogram
``volsync_stage_duration_seconds{stage,outcome}`` with the reference's
buckets. The reference builds them on ``prometheus_client``, which the
port does not depend on; nothing here is exported over HTTP. A
family's ``values()`` reads its series, keyed by label values;
``clear()`` drops them.
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
                child = self._children[key] = self._new_child()
            return child

    def _new_child(self):
        return _Child()

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

    def clear(self) -> None:
        """Drop every series (prometheus_client's ``clear()``)."""
        with self._lock:
            self._children.clear()


#: the stage histogram's upper bounds (``obs/tracing.py`` ``_BUCKETS``)
STAGE_BUCKETS = (0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1, 2, 5, 15,
                 60, float("inf"))


class _HistChild:
    """One labelled histogram series: observation count, sum and
    cumulative bucket counts (one per upper bound)."""

    __slots__ = ("_lock", "_bounds", "count", "sum", "buckets")

    def __init__(self, bounds: tuple):
        self._lock = threading.Lock()
        self._bounds = bounds
        self.count = 0
        self.sum = 0.0
        self.buckets = [0] * len(bounds)

    def observe(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += value
            for i, bound in enumerate(self._bounds):
                if value <= bound:
                    self.buckets[i] += 1

    @property
    def value(self) -> tuple:
        return (self.count, self.sum)


class _Histogram(_Family):
    """A histogram family; ``values()`` maps label values to (count,
    sum)."""

    def __init__(self, name: str, labelnames: tuple, buckets: tuple):
        super().__init__(name, labelnames)
        self.bounds = tuple(buckets)

    def _new_child(self) -> _HistChild:
        return _HistChild(self.bounds)


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
    "svc_stage_seconds": ("volsync_svc_stage_seconds", ("tenant", "stage")),
    "copy_bytes": ("volsync_copy_bytes_total", ("site",)),
}


class Metrics:
    """The metric families the port's modules use (module docstring)."""

    def __init__(self):
        for attr, (name, labels) in _FAMILIES.items():
            setattr(self, attr, _Family(name, labels))
        self.stage_duration = _Histogram(
            "volsync_stage_duration_seconds", ("stage", "outcome"),
            STAGE_BUCKETS)


GLOBAL = Metrics()
