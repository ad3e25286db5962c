"""Content-addressed deduplicating repository (restic-equivalent semantics).

Ports ``volsync_tpu/repo/repository.py`` whole, in the same repository
format: a repository written by either package opens, lists, reads and
checks under the other (with the same cipher; see ``repo/crypto.py``).
Three things differ:

- **The device.** ``Repository.init``/``open`` (and the constructor)
  take ``device=``, resolved by ``volsync_tpu_torch.resolve_device``:
  CUDA by default, raising where CUDA is absent. ``check(read_data=True)``
  re-hashes blobs with the port's ``verify_blob_batch`` on that device,
  ``TreeBackup``/``TreeRestore`` default to it, and under
  ``VOLSYNC_EC_SCHEME`` the Reed-Solomon field math of sealing and
  reconstructing a pack (``repo/erasure.py``) runs there too.
- **Reading erasure-coded packs.** ``check(read_data=True)`` reads
  blobs in (pack, offset) order, and ``ec_reconstruct`` lets one
  thread decode a pack while the others that want it wait: the
  reference reads in index order and decodes in every thread that
  misses its four-body memo, so a repository of many shard-only packs
  decoded each pack about once a blob.
- **Spans.** ``check(read_data=True)`` also times its reads
  (``repo.read``) and its batches' verify (``repo.verify``).

Clean-room design with the same capability envelope as the engine the
reference wraps (SURVEY.md §2.2 #25: CDC chunking, per-blob SHA-256 ids,
AES encryption, pack/index/snapshot objects, retain policy + prune,
point-in-time restore selection): blobs keyed by the SHA-256 of their
plaintext, grouped into immutable pack objects; index objects map blob id
-> (pack, offset); snapshot manifests reference a tree blob. Formats are
msgpack/json + zstd, sealed by repo/crypto.py when a password is set.

Layout in the object store:
    config                      repo id, chunker params, KDF salt+verifier
    data/<p2>/<pack-id>         packs: sealed blob segments + sealed header
    index/<gen>-<writer>-<id>   sealed, compressed index delta (per writer;
                                bare index/<id> from older writers still loads)
    snapshots/<id>              sealed snapshot manifest
    locks/<id>                  live writer/pruner lock objects
    gen/<n>                     fencing generation stamps (max = current)
    takeover/<lock-id>          atomic claim to remove one stale lock
    fenced/<writer-id>          fence marker: that writer's publishes refuse
    pending-delete/<id>         two-phase prune manifests (marked packs)
    mirror/<pack-id>            second pack copy (VOLSYNC_PACK_COPIES=2):
                                the heal source for scrub + read-repair
    ec/<pack-id>/<idx>          Reed-Solomon shard (VOLSYNC_EC_SCHEME=k+m):
                                packs sealed while the scheme is armed
                                store ONLY their k+m shards — any k
                                reconstruct the body at (k+m)/k storage
                                (repo/erasure.py; mirrors stay 2.0x)
    quarantine/<pack-id>        scrub corruption manifest; removed after a
                                successful mirror heal + re-verify

Multi-writer protocol (docs/robustness.md): N concurrent backup writers
plus one prune-mode pruner share a repository; generation fencing
refuses a taken-over zombie's late publishes, and prune is mark-then-
sweep with a grace period no shorter than the lock-staleness horizon.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import logging
import threading
import time as time_mod
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone
from typing import Optional

from volsync_tpu_torch import envflags, resolve_device
from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS
from volsync_tpu_torch.objstore.store import NoSuchKey, ObjectStore
from volsync_tpu_torch.obs import (
    begin_span,
    carry_context,
    record_copy,
    record_trigger,
    span,
)
from volsync_tpu_torch.repo import blobid, crypto
from volsync_tpu_torch.repo.shardedindex import ShardedBlobIndex
from volsync_tpu_torch.repo.compress import Compressor, Decompressor
from volsync_tpu_torch.resilience import ResilientStore, RetryPolicy

BLOB_DATA = "data"
BLOB_TREE = "tree"


def pack_key(pack_id: str) -> str:
    """Primary store key of a sealed pack."""
    return f"data/{pack_id[:2]}/{pack_id}"


def mirror_key(pack_id: str) -> str:
    """Second-copy key (VOLSYNC_PACK_COPIES=2) — the heal source the
    scrub and restore read-repair fetch when the primary rots."""
    return f"mirror/{pack_id}"


def quarantine_key(pack_id: str) -> str:
    """Scrub corruption manifest for one pack (plaintext JSON; see
    repo/scrub.py). Present = that pack failed device verify and has
    not yet been healed + re-verified."""
    return f"quarantine/{pack_id}"


def ec_shard_key(pack_id: str, idx: int) -> str:
    """Store key of shard ``idx`` of a pack's k+m erasure-coded stripe
    (VOLSYNC_EC_SCHEME=k+m). Packs sealed while the scheme is armed
    write ONLY these shards — no primary, no mirror — so the estate
    carries (k+m)/k bytes per logical byte instead of 2x."""
    return f"ec/{pack_id}/{idx}"


def ec_pack_prefix(pack_id: str) -> str:
    """List prefix covering every shard of one pack's stripe."""
    return f"ec/{pack_id}/"


#: Key families whose publishes MUST be dominated by a _guard_publish
#: fence re-check on every path (docs/robustness.md, multi-writer
#: protocol): a taken-over zombie writer must not land an index delta,
#: snapshot manifest, or prune manifest after its generation is fenced.
#: The VL604 analyzer (analysis/faultflow.py) proves this statically.
FENCED_KEY_FAMILIES = ("index/", "snapshots/", "pending-delete/", "ec/")

#: Declared two-phase write orders, proved by the VL605 analyzer as
#: statement order in the named function: a crash between adjacent
#: steps must leave a recoverable store (the chaos matrix in
#: tests/test_chaos.py crashes at every boundary; this pins the order
#: itself). Step vocabulary: a bare name is a call to that function;
#: "delete-prefix:<p>" a store delete of that key family;
#: "delete-of:<var>" a store delete iterating that variable.
CRASH_ORDERINGS = {
    "repo.prune": ("_prune_locked", (
        "_flush_data",                # rescued blobs durable first
        "_write_pending_manifest",    # mark new victims (two-phase)
        "_write_consolidated_index",  # publish the post-prune index
        "delete-of:superseded",       # then retire superseded deltas
        "delete-prefix:data/",        # then sweep expired packs
        "delete-of:ec_keys",          # a swept pack's shards follow it
        "delete-of:sweep_keys",       # manifests retired last
    )),
}

_VERIFIER_PLAINTEXT = b"volsync-tpu repository key verifier v1"
_COMPRESS_MIN_GAIN = 0.9  # keep compressed form only if <= 90% of raw

#: Default chunker parameters for new repositories — the single source
#: of truth (Repository.init and the movers' align-override knob both
#: build from this; see init() for the align rationale).
DEFAULT_CHUNKER = {"min_size": 512 * 1024,
                   "avg_size": 1024 * 1024,
                   "max_size": 8 * 1024 * 1024,
                   "seed": 0x5EED_CDC1,
                   "align": 4096}


class RepoError(RuntimeError):
    pass


class RepoLockedError(RepoError):
    """Another process holds a conflicting repository lock."""


class UploadError(RepoError):
    """A pack upload failed after retries; the pack was NOT registered,
    so no index entry references it."""


class StaleWriterError(RepoError):
    """This writer was fenced by a peer's stale-lock takeover; its index
    and snapshot publishes are refused (the fence-first recycle order
    from cluster/sessions.py applied to repository writers)."""


class _IndexReloadRace(RuntimeError):
    """A load_index pass raced a concurrent consolidation (delta
    deleted mid-scan) or a torn delta PUT; the whole pass restarts
    (classified retryable by the reload policy)."""


# Shared worker pools for the pipelined write path — module-level
# singletons so a process that opens many Repository objects (tests,
# multi-CR movers) does not leak a thread pool per repo. Per-repo
# backpressure (seal queue limit, upload window) still bounds each
# repository's in-flight work; the pools just supply the threads.
log = logging.getLogger("volsync_tpu_torch.repo")

_pools_lock = lockcheck.make_lock("repo.pools")
_seal_pool: Optional[ThreadPoolExecutor] = None
_upload_pool: Optional[ThreadPoolExecutor] = None


def _get_seal_pool() -> ThreadPoolExecutor:
    global _seal_pool
    with _pools_lock:
        if _seal_pool is None:
            _seal_pool = ThreadPoolExecutor(
                max_workers=envflags.seal_workers(),
                thread_name_prefix="vtpk-seal")
        return _seal_pool


def _get_upload_pool() -> ThreadPoolExecutor:
    global _upload_pool
    with _pools_lock:
        if _upload_pool is None:
            _upload_pool = ThreadPoolExecutor(
                max_workers=max(4, envflags.upload_window()),
                thread_name_prefix="vtpk-upload")
        return _upload_pool


def _shutdown_pools() -> None:
    """Tear down the shared pools (atexit, and tests that count
    threads). Safe to call repeatedly; the next _get_* re-creates.
    shutdown(wait=False) only flags the workers, so holding the pools
    lock across it cannot block."""
    global _seal_pool, _upload_pool
    with _pools_lock:
        if _seal_pool is not None:
            _seal_pool.shutdown(wait=False, cancel_futures=True)
            _seal_pool = None
        if _upload_pool is not None:
            _upload_pool.shutdown(wait=False, cancel_futures=True)
            _upload_pool = None


atexit.register(_shutdown_pools)


@dataclass
class _OpenBlob:
    """A blob admitted to the open pack whose sealed form is still being
    produced by the seal pool."""
    meta: dict            # {"id", "type", "raw_length"}
    fut: Future           # resolves to the sealed segment bytes
    stats: Optional["BackupStats"]


@dataclass
class _InflightPack:
    """A closed pack whose upload is in flight. ``entries``/``segments``
    are retained until the reap so buffered reads and a mid-run
    load_index can still see its blobs (they stay pack="" in the index
    until the put completes). ``segments[i]`` is the sealed iovec for
    ``entries[i]`` — the pack body is their logical concatenation and
    is never materialized here (the zero-copy seal path)."""
    entries: list[dict]
    segments: list[list]
    fut: Future           # resolves to (pack_id, pack_bytes_len)


def _parse_time(value: str) -> datetime:
    t = datetime.fromisoformat(value)
    return t.replace(tzinfo=timezone.utc) if t.tzinfo is None else t


@dataclass
class IndexEntry:
    pack: str
    type: str
    offset: int
    length: int       # stored (sealed) length
    raw_length: int   # plaintext length


@dataclass
class BackupStats:
    files: int = 0
    bytes_scanned: int = 0
    blobs_new: int = 0
    bytes_new: int = 0       # plaintext bytes newly stored
    bytes_stored: int = 0    # stored (compressed+sealed) bytes
    blobs_dedup: int = 0
    bytes_dedup: int = 0

    def as_dict(self):
        return self.__dict__.copy()


class Repository:
    PACK_TARGET = 16 * 1024 * 1024
    #: Pending (not yet persisted) index entries buffered before an index
    #: delta is written mid-run. Bounds _pending_index RAM on huge
    #: backups: without it a 1 TiB first backup would hold ~1M entry
    #: dicts until the final flush().
    PENDING_INDEX_LIMIT = 32768

    def __init__(self, store: ObjectStore, box, config: dict, *,
                 device=None):
        self.store = store
        #: device of check(read_data=True) and, by default, of the
        #: backup hasher and the restore verify (module docstring)
        self.device = resolve_device(device)
        self.box = box
        self.config = config
        # Sharded compact flat-array index (repo/shardedindex.py over
        # repo/compactindex.py): ~10x less RAM than dict[str,
        # IndexEntry] at million-blob scale (~60 bytes/blob => a 1 TiB
        # repo indexes in ~60 MB), split into VOLSYNC_INDEX_SHARDS
        # lock-sharded partitions with a blocked-bloom cold-miss
        # prefilter. The index synchronizes internally, so batched
        # dedup queries (has_blobs) need no repo.state acquisition.
        self._index = ShardedBlobIndex()
        self._lock = lockcheck.make_rlock("repo.state")
        # Open-pack buffer: _cur_segments[i] is the sealed IOVEC (list
        # of bytes/memoryview parts from seal_parts) for
        # _cur_entries[i]; the pack body stays scattered until the
        # store consumes it (ObjectStore.put's PutBody contract).
        self._cur_segments: list[list] = []
        self._cur_entries: list[dict] = []
        self._cur_size = 0
        self._pending_index: dict[str, list[dict]] = {}
        self._pending_count = 0
        # Compression contexts are NOT thread-safe (one ZSTD_CCtx/DCtx
        # each) and run off-lock on the pipelined seal workers and the
        # concurrent restore/verify readers — both are thread-local.
        self._z_local = threading.local()
        # -- pipelined write path (VOLSYNC_TPU_PIPELINE, default on) --
        # Stage queues, all mutated only under self._lock by caller
        # threads; pool workers never touch repo state or self._lock
        # (prune calls flush() while holding it — a worker that locked
        # would deadlock the barrier).
        self.pipelined = envflags.pipeline_enabled()
        self._pl_open: list[_OpenBlob] = []       # seal stage queue
        self._pl_inflight: list[_InflightPack] = []  # upload stage queue
        self._pl_seal_limit = envflags.seal_queue_limit()
        self._pl_upload_slots = threading.BoundedSemaphore(
            envflags.upload_window())
        self._pl_retries = envflags.upload_retries()
        # VOLSYNC_TPU_UPLOAD_RETRIES keeps its historical meaning
        # (retries, not attempts); classification/backoff come from the
        # shared layer.
        self._upload_policy = RetryPolicy.from_env(
            "repo.pack_upload", max_attempts=self._pl_retries + 1,
            base_delay=0.05)
        # One retry layer per pack upload: a store opened via
        # open_store() already carries the shared retry/breaker layer
        # (ResilientStore), and stacking _upload_policy on top would
        # multiply attempt budgets (~16+ network tries with tiers of
        # compounded backoff — one bad pack could stall an upload slot
        # for minutes). The store's policy governs those uploads;
        # _upload_policy applies only to bare stores.
        self._store_retries = isinstance(store, ResilientStore)
        self._pl_error: Optional[Exception] = None
        self._g_seal = GLOBAL_METRICS.pipeline_depth.labels(stage="seal")
        self._g_upload = GLOBAL_METRICS.pipeline_depth.labels(stage="upload")
        # Staleness horizon read per instance (VOLSYNC_LOCK_STALE_S)
        # so an operator can shorten the wait on a known-dead holder
        # without editing code; the class attribute stays as the
        # documented default for direct patching in tests.
        self.LOCK_STALE_SECONDS = envflags.lock_stale_seconds()
        # -- multi-writer protocol state (docs/robustness.md) --
        # Every Repository instance is one "writer": a fresh random id
        # stamped into its lock objects and index-delta keys, plus the
        # fencing generation observed at open/takeover. A peer that
        # takes over this writer's stale lock marks fenced/<writer-id>
        # first; _guard_publish then refuses every later publish.
        import os

        self.writer_id = os.urandom(8).hex()
        self.generation = 0
        # Marker puts (gen/ stamps, takeover/ claims, fenced/ flags)
        # need their own retry budget: ResilientStore deliberately does
        # NOT retry put_if_absent (see _claim_marker for why it is safe
        # here), so without this a single transient transport fault
        # would kill open() or a takeover mid-protocol.
        self._marker_policy = RetryPolicy.from_env(
            "repo.fence_marker", max_attempts=6, base_delay=0.02,
            max_delay=0.25)
        #: packs parked in pending-delete/ manifests: dedup treats
        #: entries pointing at them as ABSENT, so new backups re-store
        #: those blobs instead of extending a marked pack's life.
        self._pending_packs: set[str] = set()
        #: index-delta keys this writer published (prune must know its
        #: own mid-run deltas to supersede them at consolidation)
        self._published_deltas: list[str] = []
        #: store keys of lock objects this instance currently holds
        self._held_locks: set[str] = set()
        #: VOLSYNC_PACK_COPIES — 2 mirrors every sealed pack to
        #: mirror/<pack-id> (the scrub/read-repair heal source); each
        #: copy rides the same resilient upload path as the primary.
        self.pack_copies = envflags.pack_copies()
        #: VOLSYNC_EC_SCHEME=k+m arms Reed-Solomon striping: sealed
        #: packs land as k+m shards under ec/<pack-id>/<idx> INSTEAD of
        #: primary+mirror — any m shard losses reconstruct at (k+m)/k
        #: storage (repo/erasure.py). None keeps the classic layout;
        #: pre-existing primary/mirror packs are read as before.
        self.ec_scheme = envflags.ec_scheme()
        # Tiny verified-reconstruct memo: one heal or restore burst
        # touches the same shard-only pack repeatedly (existence probe
        # plus every blob read); the memo bounds that to one k-shard
        # fetch + decode. Entries are content-addressed (pack id fixes
        # the bytes), so they can never go stale.
        self._ec_memo: dict[str, bytes] = {}
        self._ec_memo_lock = lockcheck.make_lock("repo.ec_memo")
        #: pack id -> lock of the one decode in flight (ec_reconstruct),
        #: every one named "repo.ec_flight" for the lock detector
        self._ec_flights: dict = {}

    # -- lifecycle ----------------------------------------------------------

    @classmethod
    def init(cls, store: ObjectStore, password: Optional[str] = None,
             chunker: Optional[dict] = None, *,
             device=None) -> "Repository":
        """Initialize a fresh repository. The config write is atomic
        create-if-absent, so two movers racing to initialize one shared
        repository can never clobber each other's config/salt (one wins,
        the loser gets RepoError and opens the winner's repo — a silent
        overwrite would make every earlier sealed object MAC-fail)."""
        device = resolve_device(device)  # before any store write
        if store.exists("config"):
            raise RepoError("repository already initialized")
        import os

        salt = os.urandom(16) if password else None
        box = crypto.make_box(password, salt or b"")
        config = {
            "version": 1,
            "id": hashlib.sha256(os.urandom(32)).hexdigest(),
            # align=4096: page-aligned cuts (ops/gearcdc.DEFAULT_PARAMS
            # rationale) — new repos chunk on the 4 KiB Merkle-leaf grid
            # so the fused single-dispatch engine (ops/segment.py)
            # hashes leaves as contiguous pages. Repos created without
            # the key keep align=1 (classic shift-invariant CDC), and
            # align=64 repos keep the split-phase engine, so historical
            # chunk boundaries and dedup remain valid either way.
            "chunker": chunker or dict(DEFAULT_CHUNKER),
            "salt": salt.hex() if salt else None,
            "verifier": box.seal(_VERIFIER_PLAINTEXT).hex() if password else None,
        }
        payload = json.dumps(config).encode()
        # put_if_absent is a hard ObjectStore requirement (no silent
        # non-atomic fallback: that would quietly reintroduce the
        # config-clobber race for a store that forgot to implement it).
        if not store.put_if_absent("config", payload):
            raise RepoError("repository already initialized")
        repo = cls(store, box, config, device=device)
        repo._bump_generation()
        return repo

    @classmethod
    def open(cls, store: ObjectStore,
             password: Optional[str] = None, *,
             device=None) -> "Repository":
        device = resolve_device(device)
        try:
            config = json.loads(store.get("config"))
        except NoSuchKey:
            raise RepoError("no repository at this location "
                            "(missing config)") from None
        if config.get("salt"):
            if not password:
                raise crypto.WrongPassword("repository is encrypted")
            box = crypto.make_box(password, bytes.fromhex(config["salt"]))
            try:
                if box.open(bytes.fromhex(config["verifier"])) != _VERIFIER_PLAINTEXT:
                    raise crypto.WrongPassword("bad password")
            except crypto.IntegrityError:
                raise crypto.WrongPassword("bad password") from None
        else:
            box = crypto.PlainBox()
        repo = cls(store, box, config, device=device)
        repo._bump_generation()  # every open mints a writer generation
        repo.load_index()
        return repo

    @property
    def chunker_params(self) -> dict:
        return dict(self.config["chunker"])

    # -- locking ------------------------------------------------------------
    #
    # restic-style lock objects in the store (locks/<id>). Modes:
    # "shared" (backup/restore writers), "prune" (two-phase prune and
    # repair — coexists with shared writers, conflicts with other
    # pruners), "exclusive" (forget, stop-the-world prune).
    # Create-then-check (restic's own protocol): write our lock object
    # first, then scan for conflicts; back out on conflict. Locks older
    # than LOCK_STALE_SECONDS are crashed holders: their removal is
    # arbitrated by an atomic put_if_absent takeover marker
    # (takeover/<lock-id>) so two observers can never both "win", and
    # the winner fences the victim writer (fenced/<writer-id>) and
    # bumps the generation BEFORE deleting the lock — a holder that was
    # merely slow, not dead, finds its later index/snapshot publishes
    # refused by _guard_publish instead of silently corrupting the
    # repo. Live holders refresh their lock's "time" every
    # LOCK_REFRESH_SECONDS (restic's ~5-minute refresh); "created" is
    # immutable and orders the lock against pending-delete manifests
    # for the sweep decision.

    LOCK_STALE_SECONDS = 30 * 60
    LOCK_REFRESH_SECONDS = 5 * 60

    #: lock mode -> the set of peer modes it cannot coexist with
    _LOCK_CONFLICTS = {
        "shared": frozenset({"exclusive"}),
        "prune": frozenset({"prune", "exclusive"}),
        "exclusive": frozenset({"shared", "prune", "exclusive"}),
    }

    #: Default contention wait for lock() callers that don't pass one
    #: (movers raise it so a shared/exclusive collision between two CRs
    #: waits out the other side instead of failing the whole sync).
    default_lock_wait: float = 0.0

    def _write_lock(self, mode) -> str:
        import os
        import socket

        if isinstance(mode, bool):  # historical exclusive-flag spelling
            mode = "exclusive" if mode else "shared"
        now = datetime.now(timezone.utc).isoformat()
        payload = json.dumps({
            "exclusive": mode == "exclusive",  # read by older peers
            "mode": mode,
            "writer": self.writer_id,
            "gen": self.generation,
            "hostname": socket.gethostname(),
            "pid": os.getpid(),
            "time": now,      # refreshed every LOCK_REFRESH_SECONDS
            "created": now,   # immutable: orders the lock vs manifests
        }).encode()
        lock_id = hashlib.sha256(payload + os.urandom(16)).hexdigest()
        self.store.put(f"locks/{lock_id}", payload)
        return f"locks/{lock_id}"

    @staticmethod
    def _lock_mode(info: dict) -> str:
        return info.get(
            "mode", "exclusive" if info.get("exclusive") else "shared")

    def _take_over_stale_lock(self, key: str, info: dict) -> bool:
        """Atomically claim removal of one stale lock. Returns True if
        WE won the takeover (victim fenced, lock removed, generation
        bumped); False if a peer holds the claim — the caller must then
        treat the lock as still conflicting and re-poll, never delete
        it itself (the double-takeover race this marker closes)."""
        lock_id = key.split("/", 1)[1]
        marker_key = f"takeover/{lock_id}"
        now = datetime.now(timezone.utc)
        marker = json.dumps({"writer": self.writer_id,
                             "time": now.isoformat()}).encode()
        if not self._claim_marker(marker_key, marker):
            # A peer claimed this takeover first — unless the "peer" is
            # our own ambiguous first attempt (a retried put_if_absent
            # observing the marker it landed): the claim names its
            # writer, so read it back before conceding. If a real peer
            # claimed and then crashed, its marker outlives the
            # horizon: expire the claim so the NEXT poll can retry —
            # but never proceed past the lock now.
            try:
                prior = json.loads(self.store.get(marker_key))
                age = (now - _parse_time(prior["time"])).total_seconds()
            except (NoSuchKey, ValueError, KeyError):
                return False  # marker vanished/torn: repoll decides
            if prior.get("writer") != self.writer_id:
                if age > self.LOCK_STALE_SECONDS:
                    self.store.delete(marker_key)
                return False
        # We hold the claim — but the lock list we acted on may be
        # stale: a peer can have completed this takeover (lock deleted,
        # marker cleaned) between our listing and our claim, making the
        # marker free to win again. Re-verify the lock still exists
        # before fencing; if it is gone the takeover already happened,
        # so back out without double-fencing or double-counting.
        if not self.store.exists(key):
            self.store.delete(marker_key)
            return False
        # Fence FIRST (cluster/sessions.py recycle order): by the time
        # the victim could observe its lock missing, its publishes are
        # already refused. Reclaiming one's OWN stale lock (a stalled
        # but living writer) must not self-fence — same process, no
        # split brain to guard against.
        victim = info.get("writer", "")
        if victim and victim != self.writer_id:
            self._claim_marker(
                f"fenced/{victim}",
                json.dumps({"by": self.writer_id, "lock": lock_id,
                            "time": now.isoformat()}).encode())
        self.store.delete(key)
        self.store.delete(marker_key)
        self._bump_generation()
        GLOBAL_METRICS.repo_takeovers_total.inc()
        record_trigger("repo_takeover", lock=lock_id,
                       victim_writer=victim,
                       new_generation=str(self.generation))
        return True

    def _conflicting_lock(self, own_key: str, mode: str) -> Optional[str]:
        now = datetime.now(timezone.utc)
        conflicts = self._LOCK_CONFLICTS[mode]
        for key in list(self.store.list("locks/")):
            if key == own_key:
                continue
            try:
                info = json.loads(self.store.get(key))
            except (NoSuchKey, ValueError):
                continue
            try:
                age = (now - _parse_time(info["time"])).total_seconds()
            except (KeyError, ValueError):
                age = self.LOCK_STALE_SECONDS + 1
            if age > self.LOCK_STALE_SECONDS:
                if self._take_over_stale_lock(key, info):
                    continue  # crashed holder removed (by us)
                # A peer owns the takeover and may still be mid-
                # removal: re-poll rather than race its delete.
                return key
            if self._lock_mode(info) in conflicts:
                # Make the wait observable: a waiter stalled behind a
                # dying holder shows as this gauge climbing toward
                # LOCK_STALE_SECONDS instead of a silent stall.
                GLOBAL_METRICS.repo_lock_age.set(max(age, 0.0))
                return key
        return None

    @contextmanager
    def lock(self, *, exclusive: bool = False,
             mode: Optional[str] = None,
             wait_seconds: Optional[float] = None):
        """Hold a repository lock for the duration of the with-block.

        ``mode`` is "shared", "prune", or "exclusive"; the boolean
        ``exclusive`` kwarg is the historical spelling of
        shared/exclusive. Shared holders coexist with each other and
        with one prune-mode holder; "exclusive" excludes everything.

        Raises RepoLockedError if a conflicting lock persists past
        ``wait_seconds`` (default: ``self.default_lock_wait``). The
        acquisition is the span ``repo.lock`` (contention waits
        included), the release ``repo.unlock``.
        """
        if mode is None:
            mode = "exclusive" if exclusive else "shared"
        if mode not in self._LOCK_CONFLICTS:
            raise ValueError(f"unknown lock mode {mode!r}")
        if wait_seconds is None:
            wait_seconds = self.default_lock_wait
        acquiring = begin_span("repo.lock")
        own: Optional[str] = self._write_lock(mode)
        stop = threading.Event()
        refresher = None
        try:
            deadline = time_mod.monotonic() + wait_seconds
            # Randomized contender backoff: two acquirers started in
            # lock-step (same cron tick on two hosts) must desynchronize
            # or they re-collide every round until both time out. The
            # shared decorrelated-jitter sequence keeps that property;
            # bounds match the old uniform draw over
            # [0.2, 1.0] * min(1.0, max(wait_seconds, 0.1)).
            cap = min(1.0, max(wait_seconds, 0.1))
            contend_delays = RetryPolicy.from_env(
                "repo.lock_contend", base_delay=0.2 * cap,
                max_delay=cap).backoffs()
            while True:
                conflict = self._conflicting_lock(own, mode)
                if conflict is None:
                    break
                # Back out before waiting (restic's protocol): keeping our
                # lock in the store while polling would make two
                # concurrent acquirers block each other forever.
                self.store.delete(own)
                own = None
                if time_mod.monotonic() >= deadline:
                    raise RepoLockedError(
                        f"repository is locked by {conflict} "
                        f"(wanted {mode})")
                time_mod.sleep(next(contend_delays))
                own = self._write_lock(mode)

            lock_key = own
            self._held_locks.add(lock_key)

            refresh_policy = RetryPolicy.from_env(
                "repo.lock_refresh", max_attempts=2, base_delay=0.05,
                max_delay=0.5, deadline=self.LOCK_REFRESH_SECONDS)

            def restamp():
                info = json.loads(self.store.get(lock_key))
                info["time"] = datetime.now(timezone.utc).isoformat()
                if stop.is_set():  # released while we were reading
                    return
                self.store.put(lock_key, json.dumps(info).encode())

            def refresh():
                while not stop.wait(self.LOCK_REFRESH_SECONDS):
                    try:
                        # Single retry budget: restamp's get/put already
                        # retry inside a ResilientStore; only a bare
                        # store needs the policy wrap (VL602).
                        if self._store_retries:
                            restamp()
                        else:
                            refresh_policy.call(restamp)
                    except Exception as ex:  # noqa: BLE001 — log, don't
                        # swallow silently; keep holding (the next beat
                        # re-stamps, staleness only bites after
                        # LOCK_STALE_SECONDS of consecutive failures)
                        log.debug("repo lock refresh failed (retrying "
                                  "next beat): %s", ex)
                # The refresher owns deletion: by the time we get here any
                # in-flight refresh put has completed, so the delete cannot
                # be resurrected behind our back (an orphaned fresh-looking
                # lock would block exclusive ops for LOCK_STALE_SECONDS).
                try:
                    self.store.delete(lock_key)
                except Exception as ex:  # noqa: BLE001 — lock goes
                    # stale in LOCK_STALE_SECONDS anyway; log so an
                    # operator can explain the stale-lock wait
                    log.warning("repo lock release failed (peers wait "
                                "out staleness): %s", ex)

            refresher = threading.Thread(target=refresh,
                                         name="repo-lock-refresh",
                                         daemon=True)
            refresher.start()
            acquiring.finish()
            yield
        finally:
            acquiring.finish("error")  # a no-op once acquired
            with span("repo.unlock"):
                stop.set()
                if own is not None:
                    self._held_locks.discard(own)
                if refresher is not None:
                    # The refresher deletes the lock when it exits; the
                    # join just bounds how long release waits for that.
                    refresher.join(timeout=10.0)
                elif own is not None:
                    try:
                        self.store.delete(own)
                    except NoSuchKey:
                        pass

    # -- writer generations / fencing ---------------------------------------

    def _claim_marker(self, key: str, payload: bytes) -> bool:
        """put_if_absent with retries. The blanket no-retry rule for
        put_if_absent (resilience.py _RETRIED_OPS) exists because a
        retry can observe its OWN ambiguous first attempt as "exists";
        for the protocol markers this helper writes that misread is
        safe: gen/ stamps just mint the next number, takeover/ claims
        carry the claimant's writer id and are re-read on a False (see
        _take_over_stale_lock), and a fenced/ flag is idempotent — any
        claimant writing it yields the same outcome."""
        return self._marker_policy.call(
            self.store.put_if_absent, key, payload)

    def _load_generation(self) -> int:
        gen = 0
        for key in self.store.list("gen/"):
            try:
                gen = max(gen, int(key.split("/", 1)[1]))
            except ValueError:
                continue  # foreign junk under gen/ never wedges open
        return gen

    def _bump_generation(self) -> int:
        """Mint a strictly newer generation stamp. The put_if_absent
        loop gives concurrent minters distinct numbers; stamps are tiny
        and repair() trims superseded ones."""
        n = self._load_generation()
        while True:
            n += 1
            if self._claim_marker(f"gen/{n:012d}", b"{}"):
                break
        self.generation = max(self.generation, n)
        GLOBAL_METRICS.repo_writer_generation.set(self.generation)
        return n

    def _guard_publish(self, what: str) -> None:
        """guard(gen): refuse a fenced writer's late publish. A peer
        that takes over this writer's stale lock marks
        fenced/<writer-id> BEFORE touching anything else (fence-first),
        so by the time the zombie reaches its next publish the marker
        is durable. Raises StaleWriterError; the refusal is counted and
        flight-recorded."""
        if not self.store.exists(f"fenced/{self.writer_id}"):
            return
        GLOBAL_METRICS.repo_fenced_publishes_total.inc()
        record_trigger("repo_fenced_publish", writer=self.writer_id,
                       generation=str(self.generation), what=what)
        raise StaleWriterError(
            f"writer {self.writer_id} (generation {self.generation}) "
            f"was fenced by a stale-lock takeover; {what} refused")

    # -- index --------------------------------------------------------------

    def load_index(self):
        """(Re)read index deltas from the store.

        Read-snapshot semantics: one pass over ``index/`` builds a
        FRESH index that is swapped in atomically under repo.state — a
        failed reload never leaves a half-loaded index behind (callers
        keep the previous snapshot). A delta deleted mid-scan (a
        concurrent prune consolidating) restarts the whole pass against
        the new delta set; a torn delta body (a concurrent writer's PUT
        still landing or retrying) is re-fetched once and the pass
        restarts if it stays undecodable — so a reload racing a
        concurrent writer sees either none of that writer's delta or
        all of it, never half. Entries for blobs this process has
        written but not yet persisted to an index object — the open
        pack's buffer, _pending_index, and the pipelined in-flight
        queues — are re-inserted after the swap: a mid-lifecycle reload
        (backup/restore re-reading after lock acquisition) must not
        wipe a concurrent local writer's in-flight state. Also
        refreshes the pending-delete pack set (the dedup exclusion) and
        the fencing generation.
        """
        with self._lock:  # lint: ignore[VL101] — reviewed: holding
            # repo.state across the index GETs is what makes the
            # swap + in-flight re-insert atomic w.r.t. a concurrent
            # local writer; pool workers never take this lock.
            reload_policy = RetryPolicy.from_env(
                "repo.index_reload", max_attempts=4, base_delay=0.02,
                max_delay=0.5, retryable=(_IndexReloadRace,),
                # Scoped policy: retries ONLY the list/get race above
                # (retryable= is checked first) — store weather is the
                # ResilientStore wrap's budget, not ours (VL602).
                classify_fn=lambda exc: False)
            fresh, pending = reload_policy.call(self._read_index_snapshot)
            self._index = fresh
            self._pending_packs = pending
            GLOBAL_METRICS.repo_pending_delete_packs.set(len(pending))
            self.generation = max(self.generation,
                                  self._load_generation())
            GLOBAL_METRICS.repo_writer_generation.set(self.generation)
            for pack_id, entries in self._pending_index.items():
                for e in entries:
                    self._index.insert(
                        e["id"], pack_id, e["type"], e["offset"],
                        e["length"], e["raw_length"], replace=False)
            for e in self._cur_entries:
                self._index.insert(
                    e["id"], "", e["type"], e["offset"], e["length"],
                    e["raw_length"], replace=False)
            # Pipelined in-flight state: blobs queued for sealing and
            # packs whose upload has not been reaped stay visible (and
            # dedup-able) as pack="" entries across a reload.
            for pk in self._pl_inflight:
                for e in pk.entries:
                    self._index.insert(
                        e["id"], "", e["type"], e["offset"], e["length"],
                        e["raw_length"], replace=False)
            for ob in self._pl_open:
                self._index.insert(
                    ob.meta["id"], "", ob.meta["type"], 0, 0,
                    ob.meta["raw_length"], replace=False)

    def _list_then_load(self) -> list[tuple[str, dict]]:
        """List the snapshots, THEN (re)load the index; returns the
        listing. A writer publishes its index delta before its snapshot,
        so an index loaded after the listing holds every listed
        snapshot's trees. The other order (the reference's) leaves a
        window: a backup that lands between the load and the listing is
        listed, but its tree is "not in index" for the walk."""
        with span("repo.list_then_load"):
            snaps = self.list_snapshots()
            self.load_index()
            return snaps

    def _decode_index_delta(self, raw: bytes) -> dict:
        return json.loads(self._zd.decompress(self.box.open(raw)))

    def _read_index_snapshot(self) -> tuple[ShardedBlobIndex, set]:
        """One full pass over ``index/`` + ``pending-delete/`` into a
        fresh index (load_index holds repo.state and swaps it in).
        Raises _IndexReloadRace when the pass must restart."""
        from volsync_tpu_torch.repo.compress import CompressError

        fresh = ShardedBlobIndex()
        # Pending set FIRST: a blob listed by several deltas (a crashed
        # pruner's old delta parks it in a marked pack, the consolidated
        # shard repoints it) must resolve to the non-pending home —
        # pending-pack entries never overwrite an existing entry below.
        pending: set[str] = set()
        for _key, man in self._load_pending_manifests():
            pending.update(man.get("packs", ()))
        # Streaming: one index delta decoded at a time; entries land
        # in the flat compact index, never in per-entry objects.
        for key in list(self.store.list("index/")):
            try:
                raw = self.store.get(key)
            except NoSuchKey:
                raise _IndexReloadRace(
                    f"index delta {key} consolidated mid-scan") from None
            try:
                payload = self._decode_index_delta(raw)
            except (ValueError, CompressError):
                # Torn body: the writer's PUT may still be retrying
                # (a torn write leaves a truncated object the retry
                # overwrites). One re-fetch, then restart the pass.
                try:
                    payload = self._decode_index_delta(
                        self.store.get(key))
                except NoSuchKey:
                    raise _IndexReloadRace(
                        f"index delta {key} consolidated mid-scan"
                    ) from None
                except (ValueError, CompressError) as ex:
                    raise _IndexReloadRace(
                        f"index delta {key} stayed undecodable: {ex}"
                    ) from ex
            for pack_id, entries in payload["packs"].items():
                replace = pack_id not in pending
                for e in entries:
                    fresh.insert(e["id"], pack_id, e["type"],
                                 e["offset"], e["length"],
                                 e["raw_length"], replace=replace)
        return fresh, pending

    def _load_pending_manifests(self) -> list[tuple[str, dict]]:
        """``[(key, manifest)]`` under ``pending-delete/``, skipping
        objects a crashed pruner left torn (a retried prune re-marks
        the same victims, so skipping loses nothing durable)."""
        out: list[tuple[str, dict]] = []
        for key in list(self.store.list("pending-delete/")):
            try:
                man = json.loads(self.store.get(key))
            except (NoSuchKey, ValueError):
                continue  # swept mid-scan, or torn by a crashed pruner
            out.append((key, man))
        return out

    def has_blob(self, blob_id: str) -> bool:
        with self._lock:
            return self._present_for_dedup(blob_id)

    def _present_for_dedup(self, blob_id: str) -> bool:
        """Present, and NOT parked in a pending-delete pack. New
        backups must re-store blobs whose only copy lives in a marked
        pack (repointing the entry at the new pack) instead of
        extending the marked pack's life past its sweep deadline."""
        if not self._pending_packs:
            return blob_id in self._index
        tup = self._index.lookup(blob_id)
        return tup is not None and tup[0] not in self._pending_packs

    def has_blobs(self, blob_ids) -> "np.ndarray":
        """Vectorized dedup membership for a whole chunk batch ->
        ``(N,)`` bool mask aligned with the input.

        Deliberately does NOT take repo.state: the sharded index
        synchronizes per shard, so concurrent backups query in
        parallel. A query racing load_index()/a writer may miss the
        newest entries — dedup is advisory, so the worst case is one
        duplicate blob stored, never a wrong restore. Entries pointing
        at pending-delete packs count as absent (_present_for_dedup)."""
        with span("repo.dedup_query"):
            blob_ids = list(blob_ids)
            mask = self._index.contains_many(blob_ids)
            pending = self._pending_packs
            if pending and mask.any():
                for i, tup in enumerate(self._index.lookup_many(blob_ids)):
                    if tup is not None and tup[0] in pending:
                        mask[i] = False
            return mask

    def blob_ids(self) -> set:
        with self._lock:
            return set(self._index)

    def _entry(self, blob_id: str) -> Optional[IndexEntry]:
        tup = self._index.lookup(blob_id)
        if tup is None:
            return None
        pack, btype, offset, length, raw_length = tup
        return IndexEntry(pack=pack, type=btype, offset=offset,
                          length=length, raw_length=raw_length)

    # -- write path ---------------------------------------------------------

    def _encode_blob(self, data) -> list:
        """Seal one blob into its sealed-segment IOVEC (list of
        bytes/memoryview parts whose concatenation is the sealed
        segment). ``data`` is any buffer — the chunker's pooled
        memoryviews flow through compress/seal_parts uncopied; on the
        PlainBox + incompressible path the caller's view itself becomes
        a part and rides down to the store PUT. Inside ``repo.seal``,
        ``repo.seal.compress`` (``raw`` bytes in, ``kept``: whether the
        compressed form is stored) and ``repo.seal.cipher`` split it."""
        with span("repo.seal"):
            with span("repo.seal.compress", raw=len(data)) as h:
                comp = self._zc.compress(data)
                kept = len(comp) <= len(data) * _COMPRESS_MIN_GAIN
                h.set(kept=kept)
            with span("repo.seal.cipher"):
                if kept:
                    return self.box.seal_parts((b"\x01", comp))
                return self.box.seal_parts((b"\x00", data))

    @staticmethod
    def _seg_len(seg: list) -> int:
        """Stored length of a sealed-segment iovec (no copying)."""
        return sum(len(p) for p in seg)

    @staticmethod
    def _seg_join(seg: list) -> bytes:
        """One contiguous buffer for a sealed-segment iovec — only the
        buffered-read path (reading a blob still in the write pipeline)
        needs this; pack upload and decode stream the parts."""
        if len(seg) == 1:
            return seg[0]
        out = b"".join(seg)
        record_copy("repo.buffered_read", len(out))
        return out

    @property
    def _zc(self):
        zc = getattr(self._z_local, "zc", None)
        if zc is None:
            zc = self._z_local.zc = Compressor(level=3)
        return zc

    @property
    def _zd(self):
        zd = getattr(self._z_local, "zd", None)
        if zd is None:
            zd = self._z_local.zd = Decompressor()
        return zd

    def _decode_blob(self, sealed: bytes) -> bytes:
        plain = self.box.open(sealed)
        if plain[:1] == b"\x01":
            return self._zd.decompress(plain[1:])
        return plain[1:]

    def add_blob(self, btype: str, blob_id: str, data: bytes,
                 stats: Optional[BackupStats] = None) -> bool:
        """Store a blob unless present. Returns True if newly stored.

        Pipelined mode (VOLSYNC_TPU_PIPELINE, default on) hands the
        zstd+AES sealing to a worker pool and returns once the blob is
        queued; pack close and upload happen as sealed segments drain.
        A prior upload failure surfaces here (before flush) as
        UploadError."""
        with self._lock:  # lint: ignore[VL101] — reviewed: the drain/
            # reap/flush paths under repo.state DO put to the store;
            # that is the serial fallback and the bounded-backpressure
            # design (docs/performance.md). Pool workers never take
            # this lock, so the puts cannot deadlock, only serialize.
            if self._present_for_dedup(blob_id):
                if stats:
                    stats.blobs_dedup += 1
                    stats.bytes_dedup += len(data)
                return False
            self._add_new_blob_locked(btype, blob_id, data, stats)
            return True

    def add_blobs(self, btype: str, blobs, stats:
                  Optional[BackupStats] = None) -> int:
        """Batched add_blob for a pre-hashed chunk batch (one chunker
        segment). ``blobs`` is a sequence of ``(blob_id, data)``;
        returns how many were newly stored.

        One repo.state acquisition and ONE vectorized dedup query cover
        the whole batch — the per-chunk lock/probe round-trip the
        scalar path pays N times. Store order, dedup decisions (ids
        repeated within the batch dedup against the first occurrence,
        exactly as serial per-chunk adds would), and pack boundaries
        are identical to looping add_blob."""
        blobs = list(blobs)
        if not blobs:
            return 0
        new = 0
        with self._lock:  # lint: ignore[VL101] — reviewed: same serial-
            # fallback/backpressure store puts as add_blob (above);
            # pool workers never take repo.state.
            with span("repo.dedup_query"):
                ids = [blob_id for blob_id, _ in blobs]
                present = self._index.contains_many(ids)
                if self._pending_packs and present.any():
                    for i, tup in enumerate(self._index.lookup_many(ids)):
                        if (tup is not None
                                and tup[0] in self._pending_packs):
                            present[i] = False
            seen: set = set()
            for (blob_id, data), have in zip(blobs, present):
                if have or blob_id in seen:
                    if stats:
                        stats.blobs_dedup += 1
                        stats.bytes_dedup += len(data)
                    continue
                seen.add(blob_id)
                self._add_new_blob_locked(btype, blob_id, data, stats)
                new += 1
        return new

    def _add_new_blob_locked(self, btype: str, blob_id: str, data: bytes,
                             stats: Optional[BackupStats]) -> None:
        """Store a blob already known to be absent; caller holds
        self._lock and has counted dedup."""
        lockcheck.assert_held(self._lock, "repo write path (add blob)")
        if self.pipelined:
            self._pl_raise()
            # carry_context: seal-stage spans keep the submitting
            # request's trace across the pool-thread seam
            fut = _get_seal_pool().submit(
                carry_context(self._encode_blob), data)
            self._pl_open.append(_OpenBlob(
                meta={"id": blob_id, "type": btype,
                      "raw_length": len(data)},
                fut=fut, stats=stats))
            self._g_seal.set(len(self._pl_open))
            # visible to dedup immediately; real offset/length land
            # when the sealed segment drains into the open pack
            self._index.insert(blob_id, "", btype, 0, 0, len(data))
            if stats:
                stats.blobs_new += 1
                stats.bytes_new += len(data)
            self._pl_drain(block=False)
            while len(self._pl_open) >= self._pl_seal_limit:
                # backpressure: bound raw+sealed bytes held by the
                # seal queue by blocking on the head future (workers
                # never need self._lock, so this cannot deadlock)
                self._pl_drain_one()
            self._pl_reap(block=False)
            return
        seg = self._encode_blob(data)
        stored = self._seg_len(seg)
        self._cur_entries.append({
            "id": blob_id, "type": btype, "offset": self._cur_size,
            "length": stored, "raw_length": len(data),
        })
        self._cur_segments.append(seg)
        self._cur_size += stored
        # visible to dedup immediately (pack id filled at flush)
        self._index.insert(blob_id, "", btype,
                           self._cur_entries[-1]["offset"], stored,
                           len(data))
        if stats:
            stats.blobs_new += 1
            stats.bytes_new += len(data)
            stats.bytes_stored += stored
        if self._cur_size >= self.PACK_TARGET:
            self._flush_pack()

    # -- pipelined write path ------------------------------------------------
    #
    # Four stages run concurrently with backpressure: read-ahead
    # (engine/chunker._ReadaheadReader), device chunk+hash (unchanged),
    # async sealing (seal pool), async upload (upload pool, bounded
    # in-flight window). All repository state is mutated only by caller
    # threads under self._lock; pool workers seal/hash/put and nothing
    # else, so flush()/prune() can hold the lock across the barrier.
    # Byte-identity with the serial path is structural: segments drain in
    # submit order, pack boundaries use the same cumulative-sealed-size
    # rule at the same positions, headers are the same JSON of the same
    # entry dicts, and packs register (and index deltas persist) in pack
    # creation order.

    def _pl_drain_one(self):
        """Resolve the head of the seal queue into the open pack; close
        the pack when the sealed size crosses PACK_TARGET."""
        lockcheck.assert_held(self._lock, "repo seal queue (_pl_open)")
        ob = self._pl_open.pop(0)
        if ob.fut.done():
            seg = ob.fut.result()
        else:
            with span("repo.seal_wait"):
                seg = ob.fut.result()
        stored = self._seg_len(seg)
        self._cur_entries.append({
            "id": ob.meta["id"], "type": ob.meta["type"],
            "offset": self._cur_size, "length": stored,
            "raw_length": ob.meta["raw_length"],
        })
        self._cur_segments.append(seg)
        self._cur_size += stored
        self._index.insert(ob.meta["id"], "", ob.meta["type"],
                           self._cur_entries[-1]["offset"], stored,
                           ob.meta["raw_length"])
        if ob.stats:
            ob.stats.bytes_stored += stored
        self._g_seal.set(len(self._pl_open))
        if self._cur_size >= self.PACK_TARGET:
            self._pl_close_pack()

    def _pl_drain(self, block: bool):
        while self._pl_open and (block or self._pl_open[0].fut.done()):
            self._pl_drain_one()

    def _pl_close_pack(self):
        """Hand the open pack to the upload stage. Blocks while the
        in-flight window (VOLSYNC_TPU_UPLOAD_WINDOW) is full — that
        bounds sealed pack bytes held in memory."""
        lockcheck.assert_held(self._lock, "open pack buffer (_cur_*)")
        if not self._cur_segments:
            return
        segments = self._cur_segments
        entries = self._cur_entries
        self._cur_segments, self._cur_entries, self._cur_size = [], [], 0
        self._pl_upload_slots.acquire()
        try:
            fut = _get_upload_pool().submit(
                carry_context(self._upload_pack), segments, entries)
        except BaseException:
            # on the success path _upload_pack's finally releases the
            # slot; if the submit itself fails, no worker ever runs,
            # so the slot must be released here or the window shrinks
            self._pl_upload_slots.release()
            raise
        self._pl_inflight.append(
            _InflightPack(entries=entries, segments=segments, fut=fut))
        self._g_upload.set(len(self._pl_inflight))
        self._pl_reap(block=False)

    def _upload_pack(self, segments: list[list],
                     entries: list[dict]) -> str:
        """Upload worker: seal the header, hash the pack, put with
        retry/backoff. Runs on the upload pool; touches no repository
        state and never takes self._lock.

        Vectored: the pack is the flattened iovec of every sealed
        segment's parts plus header/trailer — sha256 streams over the
        parts and the store PUT consumes them directly (PutBody), so no
        monolithic pack-body ``bytes`` is ever built on this path."""
        try:
            header = self.box.seal(
                self._zc.compress(json.dumps(entries).encode()))
            parts = [p for seg in segments for p in seg]
            parts.append(header)
            parts.append(len(header).to_bytes(4, "big") + b"VTPK")
            h = hashlib.sha256()
            for p in parts:
                h.update(p)
            pack_id = h.hexdigest()
            with span("repo.pack_upload"):
                if self.ec_scheme is not None:
                    self._put_ec_shards(pack_id, parts)
                else:
                    self._put_pack_blob(pack_key(pack_id), parts)
                    if self.pack_copies >= 2:
                        self._put_pack_blob(mirror_key(pack_id), parts)
            return pack_id
        finally:
            self._pl_upload_slots.release()

    def _put_pack_blob(self, key: str, blob) -> None:
        """One pack-copy PUT under exactly one retry layer: the store's
        own (ResilientStore) when it carries one, _upload_policy
        otherwise — the no-stacking rule from the constructor. The
        mirror copy rides the identical path as the primary."""
        if self._store_retries:
            self.store.put(key, blob)
        else:
            self._upload_policy.call(self.store.put, key, blob)

    # -- erasure-coded pack layout (VOLSYNC_EC_SCHEME) -----------------------

    def _put_ec_shards(self, pack_id: str, parts) -> None:
        """Seal one pack as its k+m Reed-Solomon shards
        (ec/<pack-id>/<idx>) INSTEAD of primary+mirror — the (k+m)/k
        storage layout. ec/ is a fenced key family: the fence is
        re-checked before any shard lands, so a taken-over zombie
        writer cannot publish a stripe. Each shard put carries exactly
        one retry layer (the constructor's no-stacking rule)."""
        from volsync_tpu_torch.repo import erasure

        k, m = self.ec_scheme
        shards = erasure.encode_pack_shards(parts, k, m,
                                             device=self.device)
        self._guard_publish("ec shard publish")
        if self._store_retries:
            for idx, shard in enumerate(shards):
                self.store.put(ec_shard_key(pack_id, idx), shard)
        else:
            for idx, shard in enumerate(shards):
                self._upload_policy.call(
                    self.store.put, ec_shard_key(pack_id, idx), shard)

    def ec_publish_shard(self, pack_id: str, idx: int,
                         shard: bytes) -> None:
        """Publish ONE shard of an existing stripe (the scrub's shard
        backfill and RepackService route their ec/ writes through here
        so every shard publish shares the same fence check)."""
        self._guard_publish("ec shard publish")
        self.store.put(ec_shard_key(pack_id, idx), shard)

    def ec_shard_blobs(self, pack_id: str) -> dict:
        """Every present shard blob of one pack, keyed by shard index.
        Unlistable indices and shards deleted mid-scan are skipped —
        reconstruct_verified cross-checks whatever survives."""
        blobs: dict[int, bytes] = {}
        for key in list(self.store.list(ec_pack_prefix(pack_id))):
            try:
                idx = int(key.rsplit("/", 1)[1])
            except ValueError:
                continue
            try:
                blobs[idx] = self.store.get(key)
            except NoSuchKey:
                continue
        return blobs

    def ec_reconstruct(self, pack_id: str) -> bytes:
        """Reconstruct AND prove one pack body from any k healthy
        shards (repo/erasure.reconstruct_verified re-derives the
        content-addressed pack id, routing around silently corrupt
        shards). Pure read — the heal arms own the one overwriting
        PUT. Raises NoSuchKey when no surviving k-subset proves out,
        so callers treat an unreconstructable pack exactly like a
        missing object (quarantine-first semantics)."""
        with self._ec_memo_lock:
            body = self._ec_memo.get(pack_id)
            if body is not None:
                return body
            flight = self._ec_flights.get(pack_id)
            if flight is None:
                flight = self._ec_flights[pack_id] = \
                    lockcheck.make_lock("repo.ec_flight")
        # The port's single flight: readers of one pack (check's pool,
        # the serial restore's workers) wait for one decode and take it
        # from the memo.
        with flight:  # lint: ignore[VL101] single flight: readers wait for the one decode by design
            with self._ec_memo_lock:
                body = self._ec_memo.get(pack_id)
            try:
                return body if body is not None else \
                    self._ec_reconstruct_once(pack_id)
            finally:
                with self._ec_memo_lock:
                    self._ec_flights.pop(pack_id, None)

    def _ec_reconstruct_once(self, pack_id: str) -> bytes:
        from volsync_tpu_torch.repo import erasure

        blobs = self.ec_shard_blobs(pack_id)
        body = (erasure.reconstruct_verified(blobs, pack_id,
                                             device=self.device)
                if blobs else None)
        if body is None:
            raise NoSuchKey(
                f"pack {pack_id}: fewer than k provable shards")
        record_trigger("ec_reconstruct", pack=pack_id,
                       shards=str(len(blobs)))
        with self._ec_memo_lock:
            self._ec_memo[pack_id] = body
            while len(self._ec_memo) > 4:
                self._ec_memo.pop(next(iter(self._ec_memo)))
        return body

    def _ec_present(self, pack_id: str) -> bool:
        """At least k healthy-LOOKING shards of this pack exist (header
        probe only — check(read_data=True) and the scrub prove the
        payloads). The existence answer check()/repair() use for packs
        that have no data/ primary."""
        from volsync_tpu_torch.repo import erasure

        keys = list(self.store.list(ec_pack_prefix(pack_id)))
        if not keys:
            return False
        for key in keys:
            try:
                hdr = self.store.get_range(key, 0, erasure.HEADER_LEN)
                k = erasure.parse_shard(hdr)[0]
            except (NoSuchKey, erasure.ECError):
                continue
            return len(keys) >= k
        return False

    def _pl_reap(self, block: bool):
        """Register completed uploads in FIFO (pack creation) order:
        bind index entries to the now-durable pack, buffer its index
        delta, persist deltas at the limit — the same delta grouping as
        the serial path. A failed upload records the error and registers
        NOTHING, so no persisted index object can reference its pack."""
        lockcheck.assert_held(self._lock,
                              "upload window (_pl_inflight) + index")
        while (self._pl_inflight
               and (block or self._pl_inflight[0].fut.done())):
            pk = self._pl_inflight.pop(0)
            try:
                pack_id = pk.fut.result()
            except Exception as ex:  # noqa: BLE001 — surfaced via _pl_raise
                if self._pl_error is None:
                    self._pl_error = ex
                continue
            for e in pk.entries:
                cur = self._index.lookup(e["id"])
                if (cur is None or cur[0] == ""
                        or cur[0] in self._pending_packs):
                    self._index.insert(e["id"], pack_id, e["type"],
                                       e["offset"], e["length"],
                                       e["raw_length"])
            self._pending_index[pack_id] = pk.entries
            self._pending_count += len(pk.entries)
            if self._pending_count >= self.PENDING_INDEX_LIMIT:
                self._persist_pending()
        self._g_upload.set(len(self._pl_inflight))

    def _pl_raise(self):
        if self._pl_error is not None:
            err, self._pl_error = self._pl_error, None
            raise UploadError(f"pack upload failed: {err}") from err

    def _find_buffered(self, blob_id: str) -> Optional[bytes]:
        """Sealed segment for a pack="" blob, wherever the pipeline
        holds it: the drained open pack, the seal queue (blocks on that
        blob's future), or an in-flight pack's body."""
        for e, seg in zip(self._cur_entries, self._cur_segments):
            if e["id"] == blob_id:
                return self._seg_join(seg)
        for ob in self._pl_open:
            if ob.meta["id"] == blob_id:
                return self._seg_join(ob.fut.result())
        for pk in self._pl_inflight:
            # entries[i] <-> segments[i] stay 1:1 aligned, so the blob's
            # sealed segment comes straight off the list — no slicing a
            # materialized pack body
            for e, seg in zip(pk.entries, pk.segments):
                if e["id"] == blob_id:
                    return self._seg_join(seg)
        return None

    def _flush_pack(self):
        if self.pipelined:
            # explicit pack boundary (prune's rewrite packs, tests):
            # everything queued behind the seal stage belongs to this
            # pack, so drain it into the open pack, then close async
            self._pl_drain(block=True)
            self._pl_close_pack()
            return
        if not self._cur_segments:
            return
        header = self.box.seal(
            self._zc.compress(json.dumps(self._cur_entries).encode())
        )
        parts = [p for seg in self._cur_segments for p in seg]
        parts.append(header)
        parts.append(len(header).to_bytes(4, "big") + b"VTPK")
        h = hashlib.sha256()
        for p in parts:
            h.update(p)
        pack_id = h.hexdigest()
        with span("repo.pack_upload"):
            if self.ec_scheme is not None:
                self._put_ec_shards(pack_id, parts)
            else:
                self.store.put(pack_key(pack_id), parts)
                if self.pack_copies >= 2:
                    self.store.put(mirror_key(pack_id), parts)
        for e in self._cur_entries:
            cur = self._index.lookup(e["id"])
            if (cur is None or cur[0] == ""
                    or cur[0] in self._pending_packs):
                # bind the buffered entry to its now-durable pack (or
                # re-add if a load_index dropped it — always safe; a
                # pending-delete pack's entry repoints here too)
                self._index.insert(e["id"], pack_id, e["type"], e["offset"],
                                   e["length"], e["raw_length"])
            # else: rebound to a store-sourced pack by load_index — its
            # offset/length belong to that pack; leave it pointing there
        self._pending_index[pack_id] = self._cur_entries
        self._pending_count += len(self._cur_entries)
        self._cur_segments, self._cur_entries, self._cur_size = [], [], 0
        if self._pending_count >= self.PENDING_INDEX_LIMIT:
            self._persist_pending()

    def _persist_pending(self):
        """Write buffered index entries as one index delta object under
        the per-writer key ``index/<gen>-<writer>-<hash>`` — writers
        never contend on a shared index object, and a pruner can tell
        its own mid-run deltas apart from concurrent writers' (which it
        must preserve). Fenced writers are refused (_guard_publish),
        including a fence that lands while the put is in flight — the
        zombie's delta is withdrawn before the error surfaces."""
        lockcheck.assert_held(self._lock,
                              "pending index buffer (_pending_index)")
        if not self._pending_index:
            return
        payload = self.box.seal(self._zc.compress(json.dumps(
            {"packs": self._pending_index}
        ).encode()))
        digest = hashlib.sha256(payload).hexdigest()
        key = (f"index/{self.generation:012d}-{self.writer_id}"
               f"-{digest[:32]}")
        self._guard_publish("index delta")
        self.store.put(key, payload)
        try:
            self._guard_publish("index delta")
        except StaleWriterError:
            self.store.delete(key)  # fenced mid-put: withdraw it
            raise
        self._published_deltas.append(key)
        self._pending_index = {}
        self._pending_count = 0

    def _flush_data(self):
        """Barrier: every buffered blob sealed, packed, and durably in
        the store (no index persist). Pipelined mode drains the seal
        queue, closes the tail pack, and joins every in-flight upload;
        the serial fallback flushes inline."""
        if not self.pipelined:
            self._flush_pack()
            return
        self._pl_drain(block=True)
        self._pl_close_pack()
        with span("repo.upload_wait"):
            self._pl_reap(block=True)
        self._pl_raise()

    def flush(self):
        """Flush all buffered data and persist an index delta.

        This is the durability barrier the snapshot write relies on: in
        pipelined mode it joins every in-flight upload BEFORE the index
        delta referencing those packs is written, and re-raises the
        first upload failure (whose pack was never registered)."""
        with self._lock:  # lint: ignore[VL101] — reviewed: flush IS
            # the durability barrier; the index-delta put must happen
            # under repo.state so no new blob lands between the join
            # and the delta write. Pool workers never take this lock.
            self._flush_data()
            with span("repo.index_write"):
                self._persist_pending()

    # -- read path ----------------------------------------------------------

    def read_blob(self, blob_id: str) -> bytes:
        with self._lock:
            entry = self._entry(blob_id)
            if entry is None:
                raise RepoError(f"blob {blob_id} not in index")
            if entry.pack == "":  # still buffered in the write pipeline
                seg = self._find_buffered(blob_id)
                if seg is None:
                    raise RepoError(f"blob {blob_id} buffered but missing")
                return self._decode_blob(seg)
        return self._read_packed(blob_id, entry)

    def read_blob_raw(self, blob_id: str) -> bytes:
        """read_blob WITHOUT the host re-hash. Callers MUST verify the
        returned plaintext themselves (device-batched via
        engine/chunker.verify_blob_batch) — this exists so bulk readers
        can move the per-byte hashing off the host."""
        with self._lock:
            entry = self._entry(blob_id)
            if entry is None:
                raise RepoError(f"blob {blob_id} not in index")
            if entry.pack == "":  # still buffered in the write pipeline
                seg = self._find_buffered(blob_id)
                if seg is None:
                    raise RepoError(f"blob {blob_id} buffered but missing")
                return self._decode_blob(seg)
        return self._read_packed(blob_id, entry, verify=False)

    def _read_packed(self, blob_id: str, entry: IndexEntry, *,
                     verify: bool = True) -> bytes:
        """Fetch + decode (+ host-verify) a flushed blob WITHOUT
        touching self._lock — safe for worker pools even while another
        thread holds the lock (prune's rewrite readers).
        ``verify=False`` skips the host re-hash for callers that verify
        in device batches (check's device path)."""
        try:
            sealed = self.store.get_range(
                f"data/{entry.pack[:2]}/{entry.pack}", entry.offset,
                entry.length)
        except NoSuchKey:
            # Shard-only pack (EC layout), or a vanished primary with
            # surviving shards: serve from the proven reconstruction.
            # Read-only — the scrub/restore heal arms own the PUT that
            # re-materializes a primary.
            body = self.ec_reconstruct(entry.pack)
            sealed = body[entry.offset:entry.offset + entry.length]
        data = self._decode_blob(sealed)
        if verify:
            got = blobid.blob_id(data)
            if got != blob_id:
                raise crypto.IntegrityError(
                    f"blob {blob_id}: content hash mismatch ({got})"
                )
        return data

    # -- snapshots ----------------------------------------------------------

    def save_snapshot(self, manifest: dict) -> str:
        with span("repo.save_snapshot"):
            manifest.setdefault("time",
                                datetime.now(timezone.utc).isoformat())
            payload = self.box.seal(json.dumps(manifest).encode())
            snap_id = hashlib.sha256(payload).hexdigest()
            self._guard_publish("snapshot publish")
            self.store.put(f"snapshots/{snap_id}", payload)
            try:
                self._guard_publish("snapshot publish")
            except StaleWriterError:
                self.store.delete(f"snapshots/{snap_id}")  # fenced mid-put
                raise
            return snap_id

    def list_snapshots(self) -> list[tuple[str, dict]]:
        out = []
        for key in self.store.list("snapshots/"):
            snap_id = key.split("/", 1)[1]
            manifest = json.loads(self.box.open(self.store.get(key)))
            out.append((snap_id, manifest))
        # Chronological, not lexicographic: manifests may carry non-UTC
        # offsets, where the ISO strings don't sort by instant.
        out.sort(key=lambda kv: _parse_time(kv[1]["time"]))
        return out

    def delete_snapshot(self, snap_id: str):
        self.store.delete(f"snapshots/{snap_id}")

    def select_snapshot(self, restore_as_of: Optional[datetime] = None,
                        previous: int = 0) -> Optional[tuple[str, dict]]:
        """Point-in-time selection (mover-restic/entry.sh:146-200
        semantics): newest snapshot with time <= restore_as_of, then step
        back ``previous`` more."""
        snaps = self.list_snapshots()
        if restore_as_of is not None:
            if restore_as_of.tzinfo is None:
                # Naive selector (e.g. RESTORE_AS_OF without an offset):
                # interpret as UTC rather than crash on aware-vs-naive.
                restore_as_of = restore_as_of.replace(tzinfo=timezone.utc)
            snaps = [s for s in snaps
                     if _parse_time(s[1]["time"]) <= restore_as_of]
        if not snaps:
            return None
        idx = len(snaps) - 1 - previous
        if idx < 0:
            return None
        return snaps[idx]

    # -- retention / GC -----------------------------------------------------

    def forget(self, *, last: Optional[int] = None,
               hourly: Optional[int] = None, daily: Optional[int] = None,
               weekly: Optional[int] = None, monthly: Optional[int] = None,
               yearly: Optional[int] = None,
               within: Optional[timedelta] = None) -> list[str]:
        """Apply a restic-style retain policy; returns deleted snapshot ids
        (restic ``forget`` — the FORGET_OPTIONS the reference builds in
        controllers/mover/restic/mover.go:440-471)."""
        with self.lock(exclusive=True):
            return self._forget_locked(
                last=last, hourly=hourly, daily=daily, weekly=weekly,
                monthly=monthly, yearly=yearly, within=within)

    def _forget_locked(self, *, last=None, hourly=None, daily=None,
                       weekly=None, monthly=None, yearly=None,
                       within=None) -> list[str]:
        snaps = self.list_snapshots()
        if not snaps:
            return []
        keep: set[str] = set()
        # _parse_time throughout: a repository mixing naive and tz-aware
        # snapshot times must not raise on aware-vs-naive comparison.
        newest_time = _parse_time(snaps[-1][1]["time"])
        if last:
            keep.update(sid for sid, _ in snaps[-last:])
        if within:
            keep.update(
                sid for sid, m in snaps
                if _parse_time(m["time"]) >= newest_time - within
            )
        buckets = (
            (hourly, "%Y-%m-%d-%H"), (daily, "%Y-%m-%d"),
            (weekly, "%G-%V"), (monthly, "%Y-%m"), (yearly, "%Y"),
        )
        for count, fmt in buckets:
            if not count:
                continue
            seen: dict[str, str] = {}
            for sid, m in snaps:  # ascending: later overwrites keep newest
                seen[_parse_time(m["time"]).strftime(fmt)] = sid
            for bucket_key in sorted(seen, reverse=True)[:count]:
                keep.add(seen[bucket_key])
        if not keep:  # a policy that keeps nothing keeps the newest
            keep.add(snaps[-1][0])
        doomed = [sid for sid, _ in snaps if sid not in keep]
        for sid in doomed:
            self.delete_snapshot(sid)
        return doomed

    def referenced_blobs(self) -> set:
        """Walk all snapshot trees; returns reachable blob ids (hex)."""
        import numpy as np

        keys = self._referenced_keys(self.list_snapshots())
        # u8-row extraction: S-dtype scalar conversion strips trailing
        # NUL bytes (~1/256 ids end in 0x00 and would truncate).
        rows = keys.view(np.uint8).reshape(-1, 32)
        return {rows[i].tobytes().hex() for i in range(rows.shape[0])}  # lint: ignore[VL106] 32 B ids

    def _referenced_keys(self, snaps):
        """Reachable blob ids as a SORTED (N,) ``S32`` numpy array of
        raw 32-byte ids — 32 bytes/blob instead of ~180 for a hex-string
        set, and O(log n) vectorized membership for prune.

        ``snaps`` is a listing taken before the index the walk reads
        through was loaded (``_list_then_load``)."""
        import numpy as np

        ids = bytearray()
        seen_trees: set[str] = set()
        stack = [m["tree"] for _, m in snaps]
        while stack:
            tree_id = stack.pop()
            if tree_id in seen_trees:
                continue
            seen_trees.add(tree_id)
            ids += bytes.fromhex(tree_id)
            tree = json.loads(self.read_blob(tree_id))
            for entry in tree["entries"]:
                if entry["type"] == "dir":
                    stack.append(entry["subtree"])
                elif entry["type"] == "file":
                    for b in entry["content"]:
                        ids += bytes.fromhex(b)
        if not ids:
            return np.empty((0,), dtype="S32")
        return np.unique(np.frombuffer(bytes(ids), dtype="S32"))  # lint: ignore[VL106] id table freeze

    def _resolve_grace(self, grace_seconds: Optional[float]) -> float:
        """Precedence: explicit argument, VOLSYNC_PRUNE_GRACE_S, then
        the lock-staleness horizon — the smallest deadline guaranteeing
        any writer still able to dedup against a victim pack either
        shows a live lock (blocking the sweep) or is stale enough that
        its takeover fenced it."""
        if grace_seconds is not None:
            return max(0.0, float(grace_seconds))
        env = envflags.prune_grace_seconds()
        if env is not None:
            return env
        return float(self.LOCK_STALE_SECONDS)

    def _live_foreign_locks(self) -> list[dict]:
        """Decoded payloads of every live lock held by OTHER Repository
        instances (stale, torn, and own locks skipped). Each payload
        carries ``_created``: the holder's immutable acquisition time,
        which the sweep gate compares against manifest mark times."""
        now = datetime.now(timezone.utc)
        locks: list[dict] = []
        for key in list(self.store.list("locks/")):
            if key in self._held_locks:
                continue
            try:
                info = json.loads(self.store.get(key))
            except (NoSuchKey, ValueError):
                continue  # released or torn mid-read: not a live holder
            try:
                age = (now - _parse_time(info["time"])).total_seconds()
            except (KeyError, ValueError):
                continue  # undecodable age: the stale-lock poll owns it
            if age > self.LOCK_STALE_SECONDS:
                continue
            try:
                info["_created"] = _parse_time(
                    info.get("created", info["time"]))
            except ValueError:
                info["_created"] = now  # conservative: blocks the sweep
            locks.append(info)
        return locks

    def _sweep_blocked(self, marked_at: datetime,
                       locks: list[dict]) -> bool:
        """A live foreign lock acquired before (or skew-close to) a
        manifest's mark time may belong to a writer that loaded its
        index BEFORE the marked packs were excluded from dedup — its
        in-flight backup may still reference them, so the sweep must
        wait. Writers that locked after the mark saw the manifest at
        load_index and never dedup into marked packs, which is what
        makes this gate sufficient. LOCK_REFRESH_SECONDS of slack
        absorbs clock skew between the pruner's mark stamp and the
        holders' acquisition stamps."""
        horizon = marked_at + timedelta(seconds=self.LOCK_REFRESH_SECONDS)
        return any(info["_created"] <= horizon for info in locks)

    def _write_pending_manifest(self, packs: set, grace: float) -> str:
        """Park victim packs under ``pending-delete/``. Plaintext JSON:
        repair tooling and foreign writers must read the manifest during
        load_index without first proving they hold the repo key for THIS
        object (the pack ids it names are already visible in ``data/``
        listings, so nothing secret leaks)."""
        now = datetime.now(timezone.utc)
        manifest = {
            "packs": sorted(packs),
            "marked_at": now.isoformat(),
            "deadline": (now + timedelta(seconds=grace)).isoformat(),
            "gen": self.generation,
            "writer": self.writer_id,
        }
        payload = json.dumps(manifest).encode()
        key = "pending-delete/" + hashlib.sha256(payload).hexdigest()[:32]
        self._guard_publish("pending-delete manifest")
        self.store.put(key, payload)
        return key

    def _write_consolidated_index(self) -> set[str]:
        """Write the whole in-memory index as bounded shard objects
        (~PENDING_INDEX_LIMIT entries each) under this writer's
        gen-writer key prefix; returns the new shard keys. No single
        index object — or its in-memory JSON — scales with the whole
        repository."""
        new_keys: set[str] = set()
        shard: dict[str, list[dict]] = {}
        count = 0

        def emit_shard():
            nonlocal shard, count
            if not shard:
                return
            payload = self.box.seal(self._zc.compress(
                json.dumps({"packs": shard}).encode()))
            digest = hashlib.sha256(payload).hexdigest()
            key = (f"index/{self.generation:012d}-{self.writer_id}"
                   f"-{digest[:32]}")
            self._guard_publish("consolidated index shard")
            self.store.put(key, payload)
            new_keys.add(key)
            shard = {}
            count = 0

        for blob_id, (pack, btype, offset, length, raw) in \
                self._index.items():
            shard.setdefault(pack, []).append({
                "id": blob_id, "type": btype, "offset": offset,
                "length": length, "raw_length": raw,
            })
            count += 1
            if count >= self.PENDING_INDEX_LIMIT:
                emit_shard()
        emit_shard()
        return new_keys

    def prune(self, *, grace_seconds: Optional[float] = None) -> dict:
        """Two-phase mark-then-sweep GC that runs CONCURRENTLY with
        backups (restic ``prune`` — cadence governed by the mover's
        prune_interval_days, SURVEY.md §2 #12).

        The mark phase runs under a ``prune``-mode lock that admits
        concurrent shared (backup/restore) holders: live blobs of
        partially-live packs are rewritten into fresh packs, the victim
        packs are parked in a ``pending-delete/`` manifest stamped with
        a grace deadline, and the consolidated index is republished.
        Victim packs stay in the store AND their dead entries stay in
        the index until the sweep — dedup treats them as absent (see
        ``_present_for_dedup``), but a writer that deduped against one
        BEFORE the mark still restores through it. The sweep (the head
        of every later prune) deletes only packs whose deadline expired
        AND that no live foreign lock acquired before the mark could
        still reference; reachable blobs still homed in a sweeping pack
        are rescued into fresh packs first.

        ``grace_seconds`` (or VOLSYNC_PRUNE_GRACE_S) overrides the
        grace; the default is the lock-staleness horizon. ``0`` selects
        the classic stop-the-world prune: an EXCLUSIVE lock, victims
        swept in the same call, no manifest.

        Crash-safety ordering — data is never deleted before its
        replacement is durable:
          1. rewrite live/rescued blobs into new packs and FLUSH them;
          2. write the pending-delete manifest for this round's victims;
          3. write the consolidated index shards;
          4. delete superseded index deltas;
          5. sweep expired packs, then their manifests.
        A crash between any two steps leaves a repository where every
        snapshot restores byte-identically and ``check(read_data=True)``
        passes, and a retried prune completes the interrupted phase
        (tests/test_crash_recovery.py proves each boundary).
        """
        grace = self._resolve_grace(grace_seconds)
        mode = "exclusive" if grace <= 0 else "prune"
        # reviewed: prune holds repo.state across rewrite/sweep store
        # I/O BY DESIGN — the crash-safety ordering above depends on no
        # concurrent LOCAL writer mutating the index between steps.
        # Remote writers are handled by the protocol itself: the
        # prune-mode store lock excludes other pruners, and the
        # manifest + grace + live-lock sweep gate protects concurrent
        # backups (grace 0 falls back to a genuinely exclusive lock).
        # lint: ignore[VL101]
        with self.lock(mode=mode), self._lock:
            return self._prune_locked(grace)

    def _prune_locked(self, grace: float) -> dict:
        import numpy as np

        lockcheck.assert_held(self._lock, "prune (repo.state)")
        self.flush()
        # Every index object listed NOW is superseded by the
        # consolidated shards written below; deltas concurrent writers
        # publish AFTER this listing are preserved. Own deltas
        # published mid-prune (the rewrite's add_blob calls can trip
        # _persist_pending) are tracked via _published_deltas. The
        # listing comes before the index load, so the shards hold every
        # listed delta's entries (listed after the load, a delta
        # published in between would be deleted unconsolidated: its
        # snapshot's tree "not in index" for good).
        baseline_deltas = set(self.store.list("index/"))
        snaps = self._list_then_load()
        own_mark = len(self._published_deltas)
        reach = self._referenced_keys(snaps)
        now = datetime.now(timezone.utc)
        locks = self._live_foreign_locks()
        # -- sweep triage: which prior manifests are collectable -------
        still_pending: set[str] = set()
        sweep_packs: set[str] = set()
        sweep_keys: list[str] = []
        for key, man in self._load_pending_manifests():
            packs = set(man.get("packs", ()))
            try:
                deadline = _parse_time(man["deadline"])
                marked_at = _parse_time(man["marked_at"])
            except (KeyError, ValueError):
                # Damaged manifest: with marked_at == now the gate
                # blocks on ANY live foreign lock — it sweeps only
                # when quiescent. Conservative but terminating.
                deadline = marked_at = now
            if grace > 0 and (now < deadline
                              or self._sweep_blocked(marked_at, locks)):
                still_pending |= packs
                continue
            sweep_keys.append(key)
            sweep_packs |= packs
        sweep_packs -= still_pending  # in ANY blocked manifest => stays
        # -- liveness: one vectorized membership pass ------------------
        # Membership via batched searchsorted over raw 32-byte keys,
        # per-pack totals via bincount — no per-blob Python probes, no
        # id materialization outside the dirty packs.
        keys, pack_codes, pack_names = self._index.snapshot_arrays()
        if reach.size and keys.size:
            pos = np.clip(np.searchsorted(reach, keys), 0,
                          reach.size - 1)
            live_mask = reach[pos] == keys
        else:
            live_mask = np.zeros((keys.size,), dtype=bool)
        totals = np.bincount(pack_codes, minlength=len(pack_names))
        lives = np.bincount(pack_codes[live_mask],
                            minlength=len(pack_names))
        # Ids decode to hex only inside per-pack work lists, through a
        # u8 row view: S-dtype scalar conversion strips trailing NUL
        # bytes, which would truncate ~1/256 blob ids.
        keys_u8 = keys.view(np.uint8).reshape(-1, 32)
        order = np.argsort(pack_codes, kind="stable")
        sorted_codes = pack_codes[order]
        code_of = {name: c for c, name in enumerate(pack_names)}

        def pack_rows(code):
            lo = np.searchsorted(sorted_codes, code, "left")
            hi = np.searchsorted(sorted_codes, code, "right")
            return order[lo:hi]

        pending_all = still_pending | sweep_packs
        dirty_codes = [c for c in np.nonzero(lives < totals)[0]
                       if pack_names[c]
                       and pack_names[c] not in pending_all]
        removed_blobs = 0
        rewritten = 0
        rescued = 0
        work: dict[str, list[str]] = {}
        doomed: dict[str, list[str]] = {}
        new_victims: set[str] = set()
        # Sweep-time rescue: a pack being swept THIS call may still
        # home reachable blobs (a crashed pruner never republished the
        # index, or a writer deduped against the pack before its mark).
        # Rewrite those into fresh packs before the pack goes away.
        for pack in sorted(sweep_packs):
            code = code_of.get(pack)
            if code is None:
                continue  # no index entries left for this pack
            rows = pack_rows(code)
            live_ids = [keys_u8[r].tobytes().hex() for r in rows  # lint: ignore[VL106] 32 B ids
                        if live_mask[r]]
            if live_ids:
                work[pack] = live_ids
                rescued += len(live_ids)
            doomed[pack] = [keys_u8[r].tobytes().hex() for r in rows  # lint: ignore[VL106] 32 B ids
                            if not live_mask[r]]
        # Partially-dead packs become this round's new victims: live
        # blobs rewritten now, dead ENTRIES retained until the sweep (a
        # concurrent writer that deduped against one needs the entry
        # and the pack alive until its own snapshot is republishable).
        for code in dirty_codes:
            name = pack_names[code]
            new_victims.add(name)
            rows = pack_rows(code)
            live_ids = [keys_u8[r].tobytes().hex() for r in rows  # lint: ignore[VL106] 32 B ids
                        if live_mask[r]]
            if live_ids:
                work[name] = live_ids
            rewritten += 1
        # Orphan packs (a crashed writer's un-indexed uploads): marked
        # pending-delete too — the grace window is what distinguishes
        # "crashed" from "a live writer whose delta is still in
        # flight"; a live writer's delta lands long before the grace
        # expires and the pack stops being an orphan.
        indexed = {p for p in pack_names if p}
        orphans: set[str] = set()
        for key in list(self.store.list("data/")):
            pid = key.rsplit("/", 1)[1]
            if (pid not in indexed and pid not in pending_all
                    and pid not in new_victims):
                orphans.add(pid)
        # Shard-only packs (EC layout) have no data/ listing; a stripe
        # a crashed writer never indexed is orphan debris exactly like
        # an un-indexed primary — same grace window, same sweep.
        for key in list(self.store.list("ec/")):
            pid = key.split("/", 2)[1]
            if (pid not in indexed and pid not in pending_all
                    and pid not in new_victims):
                orphans.add(pid)
        if orphans:
            record_trigger("repo_orphan", packs=sorted(orphans),
                           source="prune")
            new_victims |= orphans
        if grace <= 0:
            # Stop-the-world mode (exclusive lock, no concurrent
            # writers possible): no manifest, this round's victims are
            # swept in the same call.
            for pack in sorted(new_victims):
                code = code_of.get(pack)
                rows = pack_rows(code) if code is not None else []
                doomed[pack] = [keys_u8[r].tobytes().hex()  # lint: ignore[VL106] 32 B ids
                                for r in rows if not live_mask[r]]
            sweep_packs |= new_victims
            new_victims = set()
        # Step 1: rewrite live/rescued blobs. Reads go through the
        # lock-free reader CONCURRENTLY (store IO + decrypt overlap —
        # the same pool pattern as check(); read_blob itself would
        # deadlock on self._lock, which prune holds), then re-add under
        # the new pack generation. Peak buffering is one pack's live
        # payload.
        with ThreadPoolExecutor(8) as pool:
            for pack_id, live_ids in work.items():
                jobs = [(b, self._entry(b)) for b in live_ids]
                datas = list(pool.map(
                    lambda j: self._read_packed(j[0], j[1]), jobs))
                for (blob_id, entry), data in zip(jobs, datas):
                    self._index.remove(blob_id)
                    self.add_blob(entry.type, blob_id, data)
        self._flush_data()  # rewrites durable before anything deleted
        # Step 2: manifest for the new victims (deferred-sweep mode).
        if new_victims:
            self._write_pending_manifest(new_victims, grace)
        # Step 3: consolidated index — swept packs' dead entries drop,
        # new victims' dead entries stay (see above).
        for pack, dead_ids in doomed.items():
            for blob_id in dead_ids:
                self._index.remove(blob_id)
                removed_blobs += 1
        self._index.vacuum()
        # Resurrection guard: pack ids are content-addressed, so the
        # rewrite (ours now, or any writer's since the mark) can
        # regenerate a byte-identical pack under the SAME id as a sweep
        # candidate — e.g. re-rescuing the blobs a crashed pruner
        # already rewrote into a now-orphaned pack. A candidate the
        # post-rewrite index still references is a live pack again:
        # it must survive the sweep (its manifest may still be
        # deleted — the index now owns the reference).
        referenced_now = {p for p in self._index.live_packs() if p}
        sweep_packs -= referenced_now
        new_keys = self._write_consolidated_index()
        # Step 4: drop superseded deltas — everything visible at entry
        # plus own mid-prune deltas; deltas concurrent writers
        # published since the baseline listing are preserved. Deletes
        # are idempotent, so a crash-retry re-runs this safely.
        superseded = (baseline_deltas
                      | set(self._published_deltas[own_mark:])) - new_keys
        for key in superseded:
            self.store.delete(key)
        # Step 5: sweep expired packs — primary, mirror copy, erasure
        # shards, and any stale quarantine manifest ride one sweep
        # (deletes are idempotent, so a crash between them re-runs
        # safely) — then their pending-delete manifests.
        for pack in sorted(sweep_packs):
            self.store.delete(pack_key(pack))
            self.store.delete(mirror_key(pack))
            ec_keys = list(self.store.list(ec_pack_prefix(pack)))
            for skey in ec_keys:
                self.store.delete(skey)
            self.store.delete(quarantine_key(pack))
        for key in sweep_keys:
            self.store.delete(key)
        self._pending_index = {}
        self._pending_count = 0
        self._published_deltas = list(new_keys)
        self._pending_packs = still_pending | new_victims
        GLOBAL_METRICS.repo_pending_delete_packs.set(
            len(self._pending_packs))
        return {"packs_rewritten": rewritten,
                "blobs_removed": removed_blobs,
                "snapshots": len(self.list_snapshots()),
                "packs_pending": len(self._pending_packs),
                "packs_swept": len(sweep_packs),
                "blobs_rescued": rescued}

    # -- repair -------------------------------------------------------------

    def _walk_trees_tolerant(self, snaps) -> tuple[set[str], list[str]]:
        """Reachable blob ids (hex) via a tree walk that RECORDS broken
        trees instead of raising — repair must survive exactly the
        damage it exists to diagnose. Any broken tree makes the
        reachable set a lower bound, so callers withhold destructive
        resolution while the list is non-empty."""
        reach: set[str] = set()
        broken: list[str] = []
        stack = [m["tree"] for _, m in snaps]
        while stack:
            tree_id = stack.pop()
            if tree_id in reach:
                continue
            reach.add(tree_id)
            try:
                tree = json.loads(self.read_blob(tree_id))
            except Exception as ex:  # noqa: BLE001 — report, don't die:
                # the id lands in broken_trees, which blocks every
                # destructive resolution step downstream.
                broken.append(f"{tree_id}: {ex}")
                continue
            for entry in tree["entries"]:
                if entry["type"] == "dir":
                    stack.append(entry["subtree"])
                elif entry["type"] == "file":
                    reach.update(entry["content"])
        return reach, broken

    def repair(self, *, apply: bool = True,
               grace_seconds: Optional[float] = None) -> dict:
        """Detect and resolve the debris crashed writers and pruners
        leave behind: orphaned packs (uploaded, never indexed), expired
        pending-delete manifests, dangling index entries (their pack is
        missing from the store), stale takeover/fence markers, and
        superseded generation stamps.

        ``apply=False`` (``volsync repair --dry-run``) scans and
        reports without mutating. With ``apply=True``, dangling entries
        whose blobs are UNREACHABLE are dropped and the index
        consolidated; reachable ones are reported as
        ``unrecoverable_blobs`` and left in place — repair never
        deletes a referenced blob's last record. Stale markers and old
        generation stamps are removed, and (when the scan found no
        broken trees and no unrecoverable blobs) a full two-phase prune
        pass runs, which marks orphans and sweeps expired manifests.

        Runbook caveat (docs/robustness.md): deleting a stale
        ``fenced/<writer>`` marker re-admits that writer id — only run
        an applying repair when the fenced process is known dead.
        """
        grace = self._resolve_grace(grace_seconds)
        mode = "exclusive" if grace <= 0 else "prune"
        # reviewed: same rationale as prune — repair IS the maintenance
        # pass; it holds repo.state across scan/resolve store I/O so no
        # concurrent local writer mutates the index between steps, and
        # the store-level lock + two-phase protocol handle peers.
        # lint: ignore[VL101]
        with self.lock(mode=mode), self._lock:
            self.flush()
            # the deltas a consolidation below may delete: listed before
            # the index load (see _prune_locked)
            baseline = set(self.store.list("index/"))
            snaps = self._list_then_load()
            now = datetime.now(timezone.utc)
            with span("repo.repair.scan"):
                reach_hex, broken_trees = self._walk_trees_tolerant(snaps)
                store_packs = {key.rsplit("/", 1)[1]
                               for key in self.store.list("data/")}
                indexed = {p for p in self._index.live_packs() if p}
                # A pack with no data/ primary but a reconstructable
                # stripe is HOME, not dangling (the EC layout never
                # writes a primary); fewer than k surviving shards is
                # genuinely dangling and reported as such.
                dangling_packs = sorted(
                    p for p in indexed - store_packs
                    if not self._ec_present(p))
                orphan_packs = sorted(store_packs - indexed
                                      - self._pending_packs)
                manifests = self._load_pending_manifests()
                expired = []
                for key, man in manifests:
                    try:
                        deadline = _parse_time(man["deadline"])
                    except (KeyError, ValueError):
                        expired.append(key)
                        continue
                    if now >= deadline:
                        expired.append(key)
                # Mirror debris (VOLSYNC_PACK_COPIES=2): a mirror whose
                # primary is gone — a crash between the sweep's primary
                # and mirror deletes — is unreferenced by construction
                # (every reader resolves the primary key first) and safe
                # to drop. Missing mirrors are NOT re-created here; the
                # scrub heals those from the verified primary.
                stray_mirrors = sorted(
                    key for key in self.store.list("mirror/")
                    if key.rsplit("/", 1)[1] not in store_packs)
                stale_markers = []
                # fleet/ heartbeat stamps (service/fleet.py) join the
                # marker scan: a stamp a replica never retired outlives
                # its TTL by definition once it crosses the lock-stale
                # horizon, and torn stamps are debris like torn markers
                for prefix in ("takeover/", "fenced/", "fleet/"):
                    for key in list(self.store.list(prefix)):
                        try:
                            info = json.loads(self.store.get(key))
                            age = (now - _parse_time(info["time"])
                                   ).total_seconds()
                        except (NoSuchKey, KeyError, ValueError):
                            stale_markers.append(key)  # torn: debris
                            continue
                        if age > self.LOCK_STALE_SECONDS:
                            stale_markers.append(key)
                old_gens = sorted(self.store.list("gen/"))[:-1]
                dangling_set = set(dangling_packs)
                drop_ids: list[str] = []
                unrecoverable: list[str] = []
                for blob_id, (pack, *_rest) in self._index.items():
                    if pack and pack in dangling_set:
                        if blob_id in reach_hex:
                            unrecoverable.append(blob_id)
                        else:
                            drop_ids.append(blob_id)
                if orphan_packs:
                    record_trigger("repo_orphan", packs=orphan_packs,
                                   source="repair_scan")
            gc = None
            dropped = 0
            if apply:
                with span("repo.repair.resolve"):
                    # A broken tree makes reach_hex a LOWER bound:
                    # entries that look unreachable may hang off the
                    # unreadable tree, so the drop is withheld (they
                    # stay reported via dangling_entries_found).
                    if drop_ids and not broken_trees:
                        for blob_id in drop_ids:
                            self._index.remove(blob_id)
                        dropped = len(drop_ids)
                        self._index.vacuum()
                        new_keys = self._write_consolidated_index()
                        for key in baseline - new_keys:
                            self.store.delete(key)
                        self._pending_index = {}
                        self._pending_count = 0
                        self._published_deltas = list(new_keys)
                    for key in stale_markers:
                        self.store.delete(key)
                    for key in stray_mirrors:
                        self.store.delete(key)
                    for key in old_gens:
                        self.store.delete(key)
                    if not broken_trees and not unrecoverable:
                        gc = self._prune_locked(grace)
            return {
                "applied": bool(apply),
                "orphan_packs": orphan_packs,
                "dangling_packs": dangling_packs,
                "dangling_entries_dropped": dropped,
                "dangling_entries_found": len(drop_ids),
                "unrecoverable_blobs": sorted(unrecoverable),
                "broken_trees": broken_trees,
                "pending_manifests": len(manifests),
                "expired_manifests": len(expired),
                "stale_markers": sorted(stale_markers),
                "stray_mirrors": stray_mirrors,
                "gc": gc,
            }

    # -- verification -------------------------------------------------------

    _DEVICE_VERIFY_BATCH = 64 * 1024 * 1024

    def _verify_blobs_device(self, blob_ids: list, workers: int) -> list:
        """Re-hash blobs in device batches: a reader pool streams raw
        plaintext (store IO + decrypt + decompress overlap, NO host
        hashing), batches pack ~64 MiB of page-aligned spans, and one
        fused dispatch per batch re-derives every blob id
        (engine/chunker.hash_spans — the rclone checksum primitive).
        The port times the reads (``repo.read``, summed over the pool)
        and the batches' verify (``repo.verify``) as spans."""
        from volsync_tpu_torch.engine.chunker import verify_blob_batch

        problems: list[str] = []
        batch: list[tuple[str, bytes]] = []
        batch_bytes = 0

        def flush():
            nonlocal batch, batch_bytes
            with span("repo.verify"):
                bad = verify_blob_batch(batch, device=self.device)
            for bid in bad:
                problems.append(f"blob {bid}: content hash mismatch")
            batch, batch_bytes = [], 0

        def read_raw(bid: str):
            try:
                with self._lock:
                    entry = self._entry(bid)
                if entry is None:
                    raise RepoError("not in index")
                with span("repo.read"):
                    return bid, self._read_packed(bid, entry, verify=False)
            except Exception as ex:  # noqa: BLE001 — report, don't die
                return bid, ex

        with ThreadPoolExecutor(max(workers, 1)) as pool:
            for bid, data in pool.map(read_raw, blob_ids):
                if isinstance(data, Exception):
                    problems.append(f"blob {bid}: {data}")
                    continue
                batch.append((bid, data))
                batch_bytes += len(data)
                if batch_bytes >= self._DEVICE_VERIFY_BATCH:
                    flush()
        flush()
        return problems

    def check(self, read_data: bool = False, *,
              workers: int = 4,
              device_verify: Optional[bool] = None) -> list[str]:
        """Structural check (restic ``check``): every indexed blob's pack
        exists; every blob reachable from any snapshot (sub-trees and
        file content included) is present in the index; with read_data,
        every indexed blob decrypts and re-hashes to its id (``workers``
        blobs verified concurrently — store IO + decrypt overlap;
        read_blob and the zstd path are thread-safe).

        ``device_verify`` (default: env VOLSYNC_DEVICE_VERIFY, ON unless
        explicitly disabled) re-hashes the read blobs in ~64 MiB DEVICE
        batches instead of per-blob host SHA — decrypt/decompress stay
        on host, but the per-byte hashing rides the page-grid kernel
        (engine/chunker.hash_spans), so a full 1 TiB verify is bounded
        by store IO + decompress, not hashlib. Both paths flag the same
        blob set (the serial path is kept as the golden reference)."""
        problems = []
        with self._lock:
            entries = self._index.copy()  # three array copies, no objects
        to_read: list[str] = []
        packs_seen: dict[str, bool] = {}  # pack id -> exists (memoized)
        for blob_id, (pack, *_rest) in entries.items():
            if not pack:
                problems.append(f"blob {blob_id}: unflushed")
                continue
            ok = packs_seen.get(pack)
            if ok is None:
                # Primary object OR a reconstructable stripe counts as
                # present — EC-sealed packs have no data/ primary.
                ok = packs_seen[pack] = (
                    self.store.exists(f"data/{pack[:2]}/{pack}")
                    or self._ec_present(pack))
            if not ok:
                problems.append(f"blob {blob_id}: pack {pack} missing")
                continue
            if read_data:
                to_read.append((pack, _rest[1], blob_id))
        # the port reads in pack order: an erasure-coded pack is then
        # decoded once (ec_reconstruct's memo), not once a blob
        to_read = [blob_id for *_at, blob_id in sorted(to_read)]
        if device_verify is None:
            device_verify = envflags.device_verify_enabled()
        if to_read and device_verify:
            problems.extend(self._verify_blobs_device(to_read, workers))
        elif to_read:
            def verify(blob_id: str):
                try:
                    self.read_blob(blob_id)
                    return None
                except Exception as ex:  # noqa: BLE001 — report, don't die
                    return f"blob {blob_id}: {ex}"

            if workers > 1 and len(to_read) > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(workers) as pool:
                    problems.extend(p for p in pool.map(verify, to_read)
                                    if p)
            else:
                problems.extend(p for p in map(verify, to_read) if p)
        # Deep reachability: a snapshot is restorable only if its whole
        # tree closure resolves through the index.
        seen: set[str] = set()
        reloaded = False
        for snap_id, manifest in self.list_snapshots():
            stack = [manifest["tree"]]
            while stack:
                tree_id = stack.pop()
                if tree_id in seen:
                    continue
                seen.add(tree_id)
                if tree_id not in entries and not reloaded:
                    # check reads through the index as it was loaded
                    # before this listing: a snapshot published since is
                    # listed without its tree. Reload once; the reloaded
                    # index (after the listing) holds every listed tree.
                    reloaded = True
                    self.load_index()
                    with self._lock:
                        entries = self._index.copy()
                if tree_id not in entries:
                    problems.append(
                        f"snapshot {snap_id}: tree {tree_id} not in index")
                    continue
                try:
                    tree = json.loads(self.read_blob(tree_id))
                except Exception as ex:  # noqa: BLE001
                    problems.append(f"snapshot {snap_id}: tree {tree_id}: {ex}")
                    continue
                for entry in tree["entries"]:
                    if entry["type"] == "dir":
                        stack.append(entry["subtree"])
                    elif entry["type"] == "file":
                        for b in entry["content"]:
                            if b not in entries and b not in seen:
                                seen.add(b)
                                problems.append(
                                    f"snapshot {snap_id}: data blob {b} "
                                    "not in index")
        return problems
