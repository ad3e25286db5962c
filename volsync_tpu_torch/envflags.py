"""Env-knob parsing for the port: copies of the knobs it reads.

Ports the part of ``volsync_tpu/envflags.py`` that the port's modules
use: the stream engine's (``pipeline_enabled``, ``readahead_segments``),
the repository's write pipeline, index, locking and retry knobs, the
backup and restore workers', the scrub's and the repacker's cadence,
the fault-injection store's seed and spec, the sync-protocol
planner's and the batched delta scan's, the device trace's directory
(``trace_dir``), plus the page-major digest-table gate of
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


# -- observability (obs.py) -------------------------------------------------

def trace_dir() -> Optional[str]:
    """VOLSYNC_TRACE_DIR: where ``obs.device_trace`` writes its
    ``torch.profiler`` traces; None (the default) disables tracing."""
    return env_str("VOLSYNC_TRACE_DIR")
