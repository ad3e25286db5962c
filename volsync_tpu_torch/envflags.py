"""Env-knob parsing for the port: copies of the knobs it reads.

Ports the part of ``volsync_tpu/envflags.py`` that the port's modules
use: the stream engine's (``pipeline_enabled``, ``readahead_segments``),
the repository's write pipeline, index, locking and retry knobs,
``open_store``'s wrapping of network stores
(``store_resilience_enabled``), the
backup and restore workers', the scrub's and the repacker's cadence,
the fault-injection store's seed and spec, the sync-protocol
planner's and the batched delta scan's, the flight recorder's
(``trace_*``), the native host library's (``no_native``, ``volio_so``,
``native_cache_dir``),
the segment micro-batcher's (``batch_*``), the
service plane's (``svc_*``), the fleet's and the continuous GC's
(``fleet_*``, ``gc_interval_seconds``), the lock detector's switch
(``lockcheck_enabled``), the session supervisor's
(``session_*``, cluster/sessions.py), plus the page-major digest-table gate of
``volsync_tpu/ops/segment.py`` (``pagemajor``). Names, defaults and
the falsy-token set are the reference's, so one environment configures
both packages alike. The reference's ``VOLSYNC_NO_PALLAS`` has no
counterpart: on a CUDA tensor the port always runs its kernels.
"""

from __future__ import annotations

import os
from typing import Optional

_FALSY = ("", "0", "false", "no", "off")


def env_bool(name: str, default: bool = False) -> bool:
    """True/False from the environment; unset -> ``default``."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in _FALSY


def env_int(name: str, default: int, minimum: int = 0) -> int:
    """Integer knob; unset/unparsable -> ``default``, floored at
    ``minimum``."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return max(minimum, int(raw.strip()))
    except ValueError:
        return default


def env_float(name: str, default: float, minimum: float = 0.0) -> float:
    """Float knob with the same degrade-to-default contract as
    env_int."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return max(minimum, float(raw.strip()))
    except ValueError:
        return default


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """Raw string knob; empty string counts as unset."""
    raw = os.environ.get(name)
    if not raw:
        return default
    return raw


def pipeline_enabled() -> bool:
    """Master switch for the pipelined data plane.
    ``VOLSYNC_TPU_PIPELINE=0`` falls back to the fully serial path."""
    return env_bool("VOLSYNC_TPU_PIPELINE", True)


def readahead_segments() -> int:
    """Segments prefetched ahead of the device stage by
    stream_chunk_batches' read-ahead thread; 0 disables the thread."""
    if not pipeline_enabled():
        return 0
    return env_int("VOLSYNC_TPU_READAHEAD", 2, minimum=0)


# -- cross-stream segment microbatching knobs (ops/batcher.py) -----------

def batch_segments_override() -> Optional[bool]:
    """VOLSYNC_BATCH_SEGMENTS tri-state: None when unset (callers fall
    back to the device-aware default), else the forced bool."""
    if os.environ.get("VOLSYNC_BATCH_SEGMENTS") is None:
        return None
    return env_bool("VOLSYNC_BATCH_SEGMENTS")


def batch_max() -> int:
    """Max segments coalesced into one batched device dispatch."""
    return env_int("VOLSYNC_BATCH_MAX", 16, minimum=1)


def batch_window_ms() -> float:
    """How long (ms) the first segment of a batch waits for
    companions."""
    return env_float("VOLSYNC_BATCH_WINDOW_MS", 2.0, minimum=0.0)


def batch_pipeline_depth() -> int:
    """Batched dispatches in flight per microbatcher (ops/batcher.py
    and the gRPC server's per-process batcher share this knob)."""
    return env_int("VOLSYNC_BATCH_PIPELINE", 2, minimum=1)


def pagemajor() -> bool:
    """Opt-in page-major digest-table layout of the fused path
    (``VOLSYNC_PAGEMAJOR``, ref ``segment._use_pagemajor``): word j of
    page p at p*8 + j instead of j*n_pages_pad + p. Read once per call
    by the functions of ``ops/segment.py`` that build a table."""
    return env_bool("VOLSYNC_PAGEMAJOR")


# -- repository write pipeline (repo/repository.py) ----------------------

def seal_workers() -> int:
    """Worker threads for async pack sealing (compression and the
    cipher are pure CPU)."""
    return env_int("VOLSYNC_TPU_SEAL_WORKERS", 2, minimum=1)


def seal_queue_limit() -> int:
    """Max blobs queued for sealing per repository before add_blob
    blocks."""
    return env_int("VOLSYNC_TPU_SEAL_QUEUE", 16, minimum=1)


def upload_window() -> int:
    """Max sealed packs in flight to the object store per repository."""
    return env_int("VOLSYNC_TPU_UPLOAD_WINDOW", 4, minimum=1)


def upload_retries() -> int:
    """Retries per failed pack upload before the error surfaces."""
    return env_int("VOLSYNC_TPU_UPLOAD_RETRIES", 2, minimum=0)


def pack_copies() -> int:
    """VOLSYNC_PACK_COPIES: 1 (default) or 2, which also writes each
    pack to ``mirror/<pack-id>`` (the restore read-repair source).
    Values above 2 clamp to 2."""
    return min(env_int("VOLSYNC_PACK_COPIES", 1, minimum=1), 2)


def ec_scheme() -> Optional[tuple]:
    """VOLSYNC_EC_SCHEME: ``k+m`` (e.g. ``4+2``) -> (k, m); None when
    unset, malformed or out of range. A set scheme seals every new pack
    as its k+m Reed-Solomon shards (repo/erasure.py)."""
    raw = env_str("VOLSYNC_EC_SCHEME")
    if raw is None:
        return None
    parts = raw.strip().split("+")
    if len(parts) != 2:
        return None
    try:
        k, m = int(parts[0]), int(parts[1])
    except ValueError:
        return None
    if not (2 <= k <= 16 and 1 <= m <= 8):
        return None
    return (k, m)


# -- blob index (repo/shardedindex.py) -----------------------------------

def index_shards() -> int:
    """Shard count of the repository blob index (rounded up to a power
    of two by the index)."""
    return env_int("VOLSYNC_INDEX_SHARDS", 16, minimum=1)


def index_prefilter() -> bool:
    """VOLSYNC_INDEX_PREFILTER=0 disables the blocked-bloom cold-miss
    prefilter in front of the index shards."""
    return env_bool("VOLSYNC_INDEX_PREFILTER", True)


# -- locking and retention (repo/repository.py) --------------------------

def lock_stale_seconds() -> float:
    """VOLSYNC_LOCK_STALE_S: age after which another holder's repository
    lock counts as a crashed process (default 30 minutes)."""
    return env_float("VOLSYNC_LOCK_STALE_S", 30.0 * 60.0, minimum=1.0)


def prune_grace_seconds() -> Optional[float]:
    """VOLSYNC_PRUNE_GRACE_S: grace of marked victim packs before the
    sweep; unset means the lock-staleness horizon, 0 the stop-the-world
    prune."""
    raw = env_str("VOLSYNC_PRUNE_GRACE_S")
    if raw is None:
        return None
    try:
        return max(0.0, float(raw.strip()))
    except ValueError:
        return None


# -- resilience layer (resilience.py) ------------------------------------

def retry_attempts() -> int:
    """Total tries per resilient call (1 = no retry)."""
    return env_int("VOLSYNC_RETRY_ATTEMPTS", 4, minimum=1)


def retry_base_delay() -> float:
    """Backoff floor in seconds (VOLSYNC_RETRY_BASE_MS, milliseconds)."""
    return env_float("VOLSYNC_RETRY_BASE_MS", 50.0, minimum=1.0) / 1000.0


def retry_max_delay() -> float:
    """Backoff cap in seconds (VOLSYNC_RETRY_MAX_MS, milliseconds)."""
    return env_float("VOLSYNC_RETRY_MAX_MS", 5000.0, minimum=1.0) / 1000.0


def retry_deadline() -> Optional[float]:
    """Overall per-operation deadline in seconds
    (VOLSYNC_RETRY_DEADLINE_S); unset/0 = no deadline."""
    v = env_float("VOLSYNC_RETRY_DEADLINE_S", 0.0, minimum=0.0)
    return v or None


def breaker_threshold() -> int:
    """Consecutive retryable failures before a backend's circuit
    breaker opens."""
    return env_int("VOLSYNC_BREAKER_THRESHOLD", 5, minimum=1)


def breaker_reset_seconds() -> float:
    """Cooldown before an open breaker admits the half-open probe."""
    return env_float("VOLSYNC_BREAKER_RESET_S", 30.0, minimum=0.1)


def store_resilience_enabled() -> bool:
    """VOLSYNC_STORE_RESILIENCE=0 opts open_store() out of wrapping
    network backends in the shared retry/breaker layer."""
    return env_bool("VOLSYNC_STORE_RESILIENCE", True)


def fault_seed() -> Optional[int]:
    """VOLSYNC_FAULT_SEED arms the deterministic fault-injection store
    wrapper (objstore/faultstore.py) for stores opened via open_store();
    None = disarmed. A seed that is not an integer raises: a typo must
    not disarm a chaos run silently."""
    raw = env_str("VOLSYNC_FAULT_SEED")
    if raw is None:
        return None
    try:
        return int(raw.strip())
    except ValueError:
        raise ValueError(
            f"VOLSYNC_FAULT_SEED={raw!r} is not an integer; fix or "
            "unset it") from None


def fault_spec() -> Optional[str]:
    """VOLSYNC_FAULT_SPEC: fault-schedule spec string (see
    objstore/faultstore.py parse_spec); None with a seed set means the
    default transient-heavy profile."""
    return env_str("VOLSYNC_FAULT_SPEC")


# -- backup and restore (engine/backup.py, engine/restore*.py) -----------

def backup_workers() -> int:
    """Concurrent per-file hashing workers for TreeBackup."""
    return env_int("VOLSYNC_BACKUP_WORKERS", 4, minimum=1)


# -- sync-protocol planner knobs (engine/protoplan.py, syncstats.py) ------

def sync_protocol() -> str:
    """VOLSYNC_SYNC_PROTO: per-call override of the adaptive protocol
    planner — ``auto`` (cost model decides), ``full`` (whole-file copy),
    ``delta`` (rsync-style signature exchange), ``cdc`` (content-defined
    chunking + dedup). Unknown values degrade to ``auto``."""
    raw = (env_str("VOLSYNC_SYNC_PROTO") or "auto").strip().lower()
    return raw if raw in ("auto", "full", "delta", "cdc") else "auto"


def plan_ewma_alpha() -> float:
    """VOLSYNC_PLAN_EWMA: smoothing factor of the SyncStatsBook's
    exponentially weighted moving averages. Clamped to (0, 1]: 1.0 =
    last sample only."""
    v = env_float("VOLSYNC_PLAN_EWMA", 0.3, minimum=0.0)
    return min(max(v, 0.01), 1.0)


def delta_batch_files() -> int:
    """VOLSYNC_DELTA_BATCH: how many files one batched delta scan
    (engine/deltasync.delta_scan_batch) takes; 1 = one file a call."""
    return env_int("VOLSYNC_DELTA_BATCH", 32, minimum=1)


def plan_full_blob_cap() -> int:
    """VOLSYNC_PLAN_FULL_CAP: largest file (bytes) the planner may store
    as one whole-file blob (``protocol="full"``, or ``"auto"``'s
    FULL_COPY); larger files always chunk."""
    return env_int("VOLSYNC_PLAN_FULL_CAP", 8 * 1024 * 1024, minimum=4096)


def restore_workers() -> int:
    """Concurrent per-file restore workers for TreeRestore."""
    return env_int("VOLSYNC_RESTORE_WORKERS", 4, minimum=1)


def restore_fetchers() -> int:
    """Threads of the restore pipeline's async pack-fetch pool."""
    return env_int("VOLSYNC_RESTORE_FETCHERS", 4, minimum=1)


def restore_fetch_window() -> int:
    """Max pack fetches submitted ahead of the verify/write stage."""
    return env_int("VOLSYNC_RESTORE_FETCH_WINDOW", 8, minimum=1)


def restore_cache_mb() -> int:
    """Byte budget (MiB) of the restore PackCache LRU."""
    return env_int("VOLSYNC_RESTORE_CACHE_MB", 256, minimum=1)


def restore_pipeline_enabled() -> bool:
    """``VOLSYNC_RESTORE_PIPELINE=0`` selects the serial per-blob
    restore (the byte-identity oracle) over the pipelined one."""
    return env_bool("VOLSYNC_RESTORE_PIPELINE", True)


def device_verify_enabled() -> bool:
    """VOLSYNC_DEVICE_VERIFY: check(read_data=True) re-hashes blobs in
    device batches (default on); 0 forces the host path."""
    return env_bool("VOLSYNC_DEVICE_VERIFY", True)


def scrub_read_repair_enabled() -> bool:
    """VOLSYNC_SCRUB_READ_REPAIR: a pipelined restore whose device
    verify catches a corrupt blob heals from the pack's mirror copy
    before raising (default on)."""
    return env_bool("VOLSYNC_SCRUB_READ_REPAIR", True)


# -- durability services (repo/scrub.py, repo/repack.py) -----------------

def scrub_interval_seconds() -> float:
    """VOLSYNC_SCRUB_INTERVAL_S: pause between continuous-scrub cycles
    (repo/scrub.py)."""
    return env_float("VOLSYNC_SCRUB_INTERVAL_S", 60.0, minimum=0.1)


def scrub_packs_per_cycle() -> int:
    """VOLSYNC_SCRUB_PACKS: packs verified per scrub cycle, walked
    round-robin; 0 (the default) scrubs the whole repository each
    cycle."""
    return env_int("VOLSYNC_SCRUB_PACKS", 0, minimum=0)


def repack_dead_ratio() -> float:
    """VOLSYNC_REPACK_DEAD_RATIO: fraction of a pack's entries that must
    be dead before RepackService rewrites its live blobs into a fresh
    erasure-coded stripe. Clamped to [0.05, 1.0]."""
    v = env_float("VOLSYNC_REPACK_DEAD_RATIO", 0.3, minimum=0.05)
    return min(v, 1.0)


def repack_interval_seconds() -> float:
    """VOLSYNC_REPACK_INTERVAL_S: pause between continuous-repack cycles
    (repo/repack.py)."""
    return env_float("VOLSYNC_REPACK_INTERVAL_S", 60.0, minimum=0.1)


def repack_packs_per_cycle() -> int:
    """VOLSYNC_REPACK_PACKS: packs rewritten per repack cycle; 0 (the
    default) repacks every eligible pack each cycle."""
    return env_int("VOLSYNC_REPACK_PACKS", 0, minimum=0)


# -- multi-tenant service plane (service/admission.py, scheduler.py) -----

def svc_max_streams() -> int:
    """Global cap on concurrently admitted ChunkHash streams; the
    stream that would exceed it is shed at admission with
    RESOURCE_EXHAUSTED (never wedged mid-stream)."""
    return env_int("VOLSYNC_SVC_MAX_STREAMS", 64, minimum=1)


def svc_tenant_streams() -> int:
    """Default per-tenant concurrent-stream cap (a TenantConfig
    max_streams overrides it per tenant)."""
    return env_int("VOLSYNC_SVC_TENANT_STREAMS", 16, minimum=1)


def svc_max_queued() -> int:
    """Global cap on segments queued in the service scheduler; new
    streams are shed at admission while the backlog is at the cap."""
    return env_int("VOLSYNC_SVC_MAX_QUEUED", 256, minimum=1)


def svc_tenant_queued() -> int:
    """Default per-tenant bound on scheduler-queued segments: the
    credit pool behind the per-stream backpressure pause (a
    TenantConfig max_queued overrides it per tenant)."""
    return env_int("VOLSYNC_SVC_TENANT_QUEUED", 32, minimum=1)


def svc_stream_credits() -> int:
    """Segments' worth of request bytes one stream may buffer in the
    server beyond the segment in flight before the handler stops
    reading (gRPC flow control then pauses the sender)."""
    return env_int("VOLSYNC_SVC_STREAM_CREDITS", 2, minimum=1)


def svc_retry_after_ms() -> float:
    """Base retry-after hint (milliseconds) stamped on quota sheds;
    breaker sheds carry the breaker's remaining cooldown instead."""
    return env_float("VOLSYNC_SVC_RETRY_AFTER_MS", 100.0, minimum=1.0)


def svc_quantum() -> int:
    """Deficit-round-robin quantum in bytes credited to each backlogged
    tenant per scheduler round (multiplied by the tenant weight)."""
    return env_int("VOLSYNC_SVC_QUANTUM", 256 * 1024, minimum=1)


def svc_dispatch_window() -> int:
    """Max scheduler-dispatched segments outstanding in the
    microbatcher at once; 0 derives it from the batcher geometry
    (max_batch * (pipeline_depth + 1))."""
    return env_int("VOLSYNC_SVC_DISPATCH_WINDOW", 0, minimum=0)


def svc_drain_seconds() -> float:
    """How long stop() waits for in-flight streams to finish before
    aborting the stragglers with UNAVAILABLE."""
    return env_float("VOLSYNC_SVC_DRAIN_S", 10.0, minimum=0.0)


def svc_tenants_spec() -> Optional[str]:
    """VOLSYNC_SVC_TENANTS: per-tenant quota/weight spec, e.g.
    ``gold:weight=4,streams=8,queued=64;bronze:weight=1`` (see
    service/tenants.py parse rules); None = all tenants on defaults."""
    return env_str("VOLSYNC_SVC_TENANTS")


def svc_breaker_backend() -> Optional[str]:
    """VOLSYNC_SVC_BREAKER_BACKEND: name of the resilience circuit
    breaker the admission controller watches: while that breaker is
    open, new streams shed at admission with the remaining cooldown as
    the retry-after hint. None = no breaker wired."""
    return env_str("VOLSYNC_SVC_BREAKER_BACKEND")


def svc_deadline_spec() -> Optional[str]:
    """VOLSYNC_SVC_DEADLINES: deadline-class map for the segment
    scheduler, e.g. ``interactive=0.5,standard=5,background=none`` (see
    scheduler.parse_deadline_classes); None = built-in defaults."""
    return env_str("VOLSYNC_SVC_DEADLINES")


# -- fleet replica plane (service/fleet.py, service/gc.py) ---------------

def fleet_beat_seconds() -> float:
    """VOLSYNC_FLEET_BEAT_S: interval between a replica's heartbeat
    stamps into the shared object store (``fleet/<replica-id>``). The
    stamp carries headroom + backlog, so the beat is also how fast the
    router's routing picture refreshes."""
    return env_float("VOLSYNC_FLEET_BEAT_S", 2.0, minimum=0.1)


def fleet_ttl_seconds() -> float:
    """VOLSYNC_FLEET_TTL_S: heartbeat-stamp TTL — a replica whose stamp
    is older than this is presumed dead: the router stops routing to it
    and ``repair`` may clear the stale stamp. Keep it a few beats wide
    so one slow put does not declare a live replica dead."""
    return env_float("VOLSYNC_FLEET_TTL_S", 10.0, minimum=0.5)


def gc_interval_seconds() -> float:
    """VOLSYNC_GC_INTERVAL_S: pause between continuous-GC prune cycles
    (service/gc.py). Each cycle is the two-phase mark-then-sweep prune;
    the interval bounds how much garbage accumulates between cycles."""
    return env_float("VOLSYNC_GC_INTERVAL_S", 60.0, minimum=0.1)


# -- debug/verification toggles (analysis/lockcheck.py) ------------------

def lockcheck_enabled() -> bool:
    """VOLSYNC_TPU_LOCKCHECK=1 swaps the locks built through
    ``analysis.lockcheck`` for instrumented wrappers that record the
    per-thread lock-acquisition graph, fail fast on lock-order cycles
    (potential deadlock), and back the assert_held guards on pipeline
    shared state. Debug/test only: never on by default (every acquire
    pays a bookkeeping step)."""
    return env_bool("VOLSYNC_TPU_LOCKCHECK")


# -- observability (obs/tracing.py) ----------------------------------------

def trace_dir() -> Optional[str]:
    """VOLSYNC_TRACE_DIR: where ``obs.device_trace`` writes its
    ``torch.profiler`` traces; None (the default) disables tracing."""
    return env_str("VOLSYNC_TRACE_DIR")


def trace_sample() -> float:
    """VOLSYNC_TRACE_SAMPLE: fraction of new root traces whose spans are
    recorded into the flight recorder (1.0 = every trace, 0 = flight
    recorder off; span totals + the stage histogram always record)."""
    return env_float("VOLSYNC_TRACE_SAMPLE", 1.0, minimum=0.0)


def trace_ring_size() -> int:
    """VOLSYNC_TRACE_RING: span events retained in the in-process
    flight-recorder ring buffer (oldest evicted first)."""
    return env_int("VOLSYNC_TRACE_RING", 4096, minimum=16)


def trace_dump_dir() -> Optional[str]:
    """VOLSYNC_TRACE_DUMP: directory where trigger events (shed,
    breaker-open, injected fault, deadline) auto-dump annotated
    Chrome-trace JSON files; None (the default) disables auto-dumps
    (the ring still records)."""
    return env_str("VOLSYNC_TRACE_DUMP")


def trace_trigger_interval() -> float:
    """VOLSYNC_TRACE_TRIGGER_INTERVAL_S: minimum seconds between
    auto-dumps for the SAME trigger reason, so a shed storm can't
    fill the dump dir."""
    return env_float("VOLSYNC_TRACE_TRIGGER_INTERVAL_S", 30.0, minimum=0.0)


# -- native host library (io/native.py) -------------------------------------

def no_native() -> bool:
    """VOLSYNC_NO_NATIVE=1 skips the native volio accelerator."""
    return env_bool("VOLSYNC_NO_NATIVE")


def volio_so() -> Optional[str]:
    """Path to a prebuilt libvolio.so (container images ship one)."""
    return env_str("VOLSYNC_VOLIO_SO")


def native_cache_dir() -> Optional[str]:
    """Build cache dir for the self-compiled native library."""
    return env_str("VOLSYNC_NATIVE_CACHE")


# -- supervised accelerator sessions (cluster/sessions.py) ----------------

def session_ttl_seconds() -> float:
    """VOLSYNC_SESSION_TTL_S: hard lease TTL — a session whose keepalive
    has not succeeded for this long is recycled no matter what (the
    8-hour wedge of rounds 4/5 becomes a bounded outage)."""
    return env_float("VOLSYNC_SESSION_TTL_S", 900.0, minimum=1.0)


def session_keepalive_seconds() -> float:
    """VOLSYNC_SESSION_KEEPALIVE_S: interval between keepalive beats."""
    return env_float("VOLSYNC_SESSION_KEEPALIVE_S", 30.0, minimum=0.1)


def session_keepalive_failures() -> int:
    """VOLSYNC_SESSION_KEEPALIVE_FAILS: consecutive keepalive failures
    before the supervisor force-recycles the session."""
    return env_int("VOLSYNC_SESSION_KEEPALIVE_FAILS", 3, minimum=1)


def session_probe_timeout() -> float:
    """VOLSYNC_SESSION_PROBE_TIMEOUT_S: verify-probe budget; a probe
    that exceeds it counts as a wedged backend and triggers a recycle."""
    return env_float("VOLSYNC_SESSION_PROBE_TIMEOUT_S", 300.0, minimum=1.0)


def session_job_deadline() -> float:
    """VOLSYNC_SESSION_JOB_DEADLINE_S: per-job hard deadline in the
    serialized bench queue — a job is killed at this wall-clock bound,
    never allowed to hold the single-tenant device open-endedly."""
    return env_float("VOLSYNC_SESSION_JOB_DEADLINE_S", 1800.0, minimum=1.0)


def session_id() -> Optional[str]:
    """VOLSYNC_SESSION_ID: stamped into a job's environment by the
    session queue so bench provenance can carry the supervised-session
    identity; None when the process runs outside a session."""
    return env_str("VOLSYNC_SESSION_ID")


def session_epoch() -> int:
    """VOLSYNC_SESSION_EPOCH: the fencing epoch stamped alongside
    VOLSYNC_SESSION_ID (0 when unset)."""
    return env_int("VOLSYNC_SESSION_EPOCH", 0)


def session_backend() -> Optional[str]:
    """VOLSYNC_SESSION_BACKEND: backend name stamped alongside
    VOLSYNC_SESSION_ID."""
    return env_str("VOLSYNC_SESSION_BACKEND")


def session_status_path() -> Optional[str]:
    """VOLSYNC_SESSION_STATUS: file where the supervisor mirrors its
    state for observers (``volsync session status``); None = no mirror."""
    return env_str("VOLSYNC_SESSION_STATUS")
