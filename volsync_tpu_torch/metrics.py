"""Prometheus metrics without ``prometheus_client``.

Ports ``volsync_tpu/metrics.py`` whole: the families of ``Metrics`` with
the reference's names, help texts, types and label sets, each an
in-memory counter, gauge or histogram with the
``labels(...).inc/dec/set/observe`` shape; the reconcile families the
controllers drive through ``Metrics.for_object`` (``BoundMetrics``:
missed intervals, out of sync, sync durations, throughput); and the
stage histogram ``volsync_stage_duration_seconds{stage,outcome}`` with
the reference's buckets, which the reference registers on ``GLOBAL``
from ``obs/tracing.py``. ``Metrics.expose()`` writes the Prometheus text
exposition (format 0.0.4) by hand, and ``MetricsServer`` serves it on
``/metrics`` beside ``/healthz``, ``/readyz`` and ``/debug/trace``.
The reference builds its families on ``prometheus_client``, which the
port does not depend on; its exposition also carries the ``_created``
series that ``prometheus_client`` adds, which the port's does not. A
family's ``values()`` reads its series, keyed by label values;
``clear()`` drops them.
"""

from __future__ import annotations

import dataclasses
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
    family without labels is its own single series. ``kind`` and
    ``help_text`` are its exposition's ``# TYPE`` and ``# HELP``."""

    def __init__(self, name: str, labelnames: tuple = (),
                 kind: str = "gauge", help_text: str = ""):
        self.name = name
        self.labelnames = tuple(labelnames)
        self.kind, self.help = kind, help_text
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

    def __init__(self, name: str, labelnames: tuple, buckets: tuple,
                 help_text: str = ""):
        super().__init__(name, labelnames, "histogram", help_text)
        self.bounds = tuple(buckets)

    def _new_child(self) -> _HistChild:
        return _HistChild(self.bounds)


#: the reconcile histogram's upper bounds (the reference's ``_BUCKETS``)
_BUCKETS = (0.1, 0.5, 1, 5, 15, 30, 60, 120, 300, 600, 1800, 3600,
            float("inf"))

#: the reconcile families' labels (``LABELS`` of the reference)
LABELS = ("obj_name", "obj_namespace", "role", "method")

#: attribute -> (reference metric name, type, label names, help)
_FAMILIES = {
    "missed_intervals": (
        "volsync_missed_intervals_total", "counter", LABELS,
        "The number of times a synchronization failed to complete "
        "before the next scheduled start"),
    "out_of_sync": (
        "volsync_volume_out_of_sync", "gauge", LABELS,
        "Set to 1 if the volume is not properly synchronized"),
    "throughput": (
        "volsync_data_throughput_bytes_per_second", "gauge", LABELS,
        "Device data-plane throughput of the last completed transfer"),
    "pipeline_depth": (
        "volsync_pipeline_queue_depth", "gauge", ("stage",),
        "Current occupancy of each backup-pipeline stage queue"),
    "retry_attempts": (
        "volsync_retry_attempts_total", "counter", ("site", "outcome"),
        "Resilient-call attempts by site and outcome"),
    "breaker_state": (
        "volsync_breaker_state", "gauge", ("backend",),
        "Circuit-breaker state per backend (0=closed, 1=open, "
        "2=half-open)"),
    "breaker_transitions": (
        "volsync_breaker_transitions_total", "counter", ("backend", "to"),
        "Circuit-breaker state transitions per backend"),
    "index_queries": (
        "volsync_index_queries_total", "counter", ("result",),
        "Batched dedup-index keys queried, by result"),
    "index_prefilter": (
        "volsync_index_prefilter_total", "counter", ("outcome",),
        "Prefilter decisions for batched dedup-index queries"),
    "index_prefilter_saturation": (
        "volsync_index_prefilter_saturation", "gauge", (),
        "Max per-shard prefilter set-bit fraction (0..1)"),
    "svc_admitted": (
        "volsync_svc_admitted_total", "counter", ("tenant",),
        "ChunkHash streams admitted, by tenant"),
    "svc_shed": (
        "volsync_svc_shed_total", "counter", ("tenant", "reason"),
        "ChunkHash streams shed at admission, by tenant and reason"),
    "svc_active_streams": (
        "volsync_svc_active_streams", "gauge", ("tenant",),
        "Currently admitted ChunkHash streams, by tenant"),
    "svc_queue_depth": (
        "volsync_svc_queue_depth", "gauge", ("tenant",),
        "Segments queued in the service scheduler, by tenant"),
    "svc_sched_latency": (
        "volsync_svc_sched_latency_seconds", "gauge", ("tenant",),
        "Queue wait of the last segment the scheduler dispatched, "
        "by tenant"),
    "svc_deadline_exceeded": (
        "volsync_svc_deadline_exceeded_total", "counter", ("tenant",),
        "Segments shed because their queue-wait deadline passed "
        "before dispatch, by tenant"),
    "svc_stage_seconds": (
        "volsync_svc_stage_seconds", "counter", ("tenant", "stage"),
        "Seconds spent per stage by tenant-attributed spans"),
    "svc_protocol_selected": (
        "volsync_svc_protocol_selected_total", "counter",
        ("protocol", "reason"),
        "Sync-protocol planner decisions, by protocol and reason"),
    "plan_regret": (
        "volsync_plan_regret_ratio", "gauge", (),
        "Chosen-protocol cost over oracle cost for the last planner "
        "replay (1.0 = optimal)"),
    "repo_lock_age": (
        "volsync_repo_lock_age_seconds", "gauge", (),
        "Age of the most recent conflicting repository lock "
        "observed while acquiring"),
    "repo_writer_generation": (
        "volsync_repo_writer_generation", "gauge", (),
        "Current repository fencing generation of this writer"),
    "repo_pending_delete_packs": (
        "volsync_repo_pending_delete_packs", "gauge", (),
        "Packs marked pending-delete and awaiting their sweep "
        "grace deadline"),
    "repo_takeovers_total": (
        "volsync_repo_takeovers_total", "counter", (),
        "Stale repository locks atomically taken over (victim "
        "writer fenced, generation bumped)"),
    "repo_fenced_publishes_total": (
        "volsync_repo_fenced_publishes_total", "counter", (),
        "Index/snapshot publishes refused because this writer was "
        "fenced by a stale-lock takeover"),
    "session_state": (
        "volsync_session_state", "gauge", ("backend",),
        "Supervised session state per backend "
        "(0=acquiring, 1=healthy, 2=degraded, 3=recycling)"),
    "session_transitions": (
        "volsync_session_transitions_total", "counter", ("backend", "to"),
        "Supervised session state transitions per backend"),
    "session_recycles": (
        "volsync_session_recycles_total", "counter", ("backend", "cause"),
        "Forced session recycles per backend, by cause"),
    "session_keepalives": (
        "volsync_session_keepalive_total", "counter",
        ("backend", "outcome"),
        "Session keepalive beats per backend, by outcome"),
    "session_fenced_writes": (
        "volsync_session_fenced_writes_total", "counter", ("backend",),
        "Results refused because the producing session's fencing "
        "epoch was stale"),
    "fleet_replica_headroom": (
        "volsync_fleet_replica_headroom", "gauge", ("replica",),
        "Advertised admission headroom per replica, from its last "
        "heartbeat stamp"),
    "fleet_routed_total": (
        "volsync_fleet_routed_total", "counter", ("replica",),
        "Streams the fleet router sent to each replica"),
    "fleet_failovers_total": (
        "volsync_fleet_failovers_total", "counter", (),
        "Streams that completed on a sibling after a shed or a "
        "replica death"),
    "restore_cache_hits": (
        "volsync_restore_cache_hits_total", "counter", (),
        "Pack requests served from the restore PackCache (LRU hit "
        "or shared single-flight fetch)"),
    "restore_cache_misses": (
        "volsync_restore_cache_misses_total", "counter", (),
        "Pack requests that paid a store GET (single-flight fetch "
        "leaders)"),
    "restore_cache_evictions": (
        "volsync_restore_cache_evictions_total", "counter", (),
        "Pack bodies evicted from the restore PackCache LRU to "
        "stay under the byte budget"),
    "restore_bytes": (
        "volsync_restore_bytes_total", "counter", (),
        "Plaintext bytes written to restore destinations by the "
        "pipelined restore data plane"),
    "gc_cycles": (
        "volsync_gc_cycles_total", "counter", ("outcome",),
        "Continuous-GC prune cycles, by outcome"),
    "scrub_packs": (
        "volsync_scrub_packs_total", "counter", ("outcome",),
        "Packs examined by the integrity scrub, by outcome"),
    "scrub_bytes": (
        "volsync_scrub_bytes_total", "counter", (),
        "Pack bytes fetched and device-verified by the integrity "
        "scrub"),
    "repack_cycles": (
        "volsync_repack_cycles_total", "counter", ("outcome",),
        "Online-repack cycles, by outcome"),
    "repack_packs": (
        "volsync_repack_packs_total", "counter", (),
        "Packs rewritten into erasure-coded stripes by the online "
        "repacker"),
    "copy_bytes": (
        "volsync_copy_bytes_total", "counter", ("site",),
        "Host bytes copied at sanctioned data-plane copy sites"),
}


def _number(value: float) -> str:
    """A sample value or ``le`` bound as the Prometheus text format (and
    the reference's exposition) writes it: ``1.0``, ``+Inf``, ``NaN``."""
    value = float(value)
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    if value != value:
        return "NaN"
    return repr(value)


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _labels_text(pairs) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"'
                          for k, v in pairs) + "}"


class Metrics:
    """The reference's metric families (module docstring)."""

    def __init__(self):
        self._families = []
        for attr, (name, kind, labels, help_text) in _FAMILIES.items():
            fam = _Family(name, labels, kind, help_text)
            setattr(self, attr, fam)
            self._families.append(fam)
        self.sync_durations = _Histogram(
            "volsync_sync_duration_seconds", LABELS, _BUCKETS,
            "Duration of the synchronization interval in seconds")
        self.stage_duration = _Histogram(
            "volsync_stage_duration_seconds", ("stage", "outcome"),
            STAGE_BUCKETS, "Duration of instrumented data-plane stages")
        self._families += [self.sync_durations, self.stage_duration]

    def for_object(self, name: str, namespace: str, role: str,
                   method: str) -> "BoundMetrics":
        labels = dict(obj_name=name, obj_namespace=namespace, role=role,
                      method=method)
        return BoundMetrics(
            missed_intervals=self.missed_intervals.labels(**labels),
            out_of_sync=self.out_of_sync.labels(**labels),
            sync_durations=self.sync_durations.labels(**labels),
            throughput=self.throughput.labels(**labels),
        )

    def expose(self) -> bytes:
        """Text exposition (the reference serves this on :8080/metrics):
        ``# HELP`` and ``# TYPE`` a family, then its samples; a counter's
        sample ends in ``_total``; a histogram writes cumulative
        ``_bucket{le=...}`` lines up to ``+Inf``, then ``_sum`` and
        ``_count``; a family without labels shows 0 before its first
        use, as ``prometheus_client``'s does."""
        out = []
        for fam in self._families:
            base = fam.name
            if fam.kind == "counter" and base.endswith("_total"):
                base = base[:-len("_total")]
            help_text = fam.help.replace("\\", "\\\\").replace(
                "\n", "\\n")
            out.append(f"# HELP {fam.name} {help_text}")
            out.append(f"# TYPE {base} {fam.kind}")
            with fam._lock:
                children = sorted(fam._children.items())
            if not children and not fam.labelnames:
                children = [((), fam._new_child())]
            for key, child in children:
                pairs = list(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    with child._lock:
                        counts = list(child.buckets)
                        total, count = child.sum, child.count
                    for bound, n in zip(fam.bounds, counts):
                        le = pairs + [("le", _number(bound))]
                        out.append(f"{base}_bucket{_labels_text(le)} "
                                   f"{_number(n)}")
                    out.append(f"{base}_count{_labels_text(pairs)} "
                               f"{_number(count)}")
                    out.append(f"{base}_sum{_labels_text(pairs)} "
                               f"{_number(total)}")
                else:
                    sample = base + "_total" if fam.kind == "counter" \
                        else base
                    out.append(f"{sample}{_labels_text(pairs)} "
                               f"{_number(child.value)}")
        return ("\n".join(out) + "\n").encode("utf-8")


@dataclasses.dataclass
class BoundMetrics:
    """Per-CR labeled children (what the state machine drives)."""

    missed_intervals: object
    out_of_sync: object
    sync_durations: object
    throughput: object


class MetricsServer:
    """HTTP exposition + probes, the analogue of the reference manager's
    metrics listener on :8080 and healthz/readyz probes on :8081
    (controllers/metrics.go:82-85, main.go:140-153). One server carries
    all the endpoints — /metrics, /healthz, /readyz, plus /debug/trace
    serving the obs flight recorder as Chrome-trace JSON; ``port=0``
    binds an ephemeral port (tests)."""

    def __init__(self, metrics: "Metrics", host: str = "127.0.0.1",
                 port: int = 8080,
                 ready_check=None):
        import http.server

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path == "/metrics":
                    body = outer.metrics.expose()
                    ctype = "text/plain; version=0.0.4"
                    code = 200
                elif self.path == "/healthz":
                    body, ctype, code = b"ok", "text/plain", 200
                elif self.path == "/readyz":
                    ok = outer.ready_check is None or outer.ready_check()
                    body = b"ok" if ok else b"not ready"
                    ctype, code = "text/plain", (200 if ok else 503)
                elif self.path == "/debug/trace":
                    # Imported lazily: obs depends on this module, so a
                    # top-level import here would be a cycle.
                    import json

                    from volsync_tpu_torch import obs
                    body = json.dumps(obs.chrome_trace()).encode("utf-8")
                    ctype, code = "application/json", 200
                else:
                    body, ctype, code = b"not found", "text/plain", 404
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet
                pass

        self.metrics = metrics
        self.ready_check = ready_check
        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="metrics-server")

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


GLOBAL = Metrics()
