"""Pipelined restore data plane: pack-aware fetch, device verify, write.

The serial restore (engine/restore.py) issues one
``repo.read_blob()`` store round trip per chunk — fine on a local
filesystem, ruinous against an object store with tens of milliseconds
per GET, and exactly the shape the write pipeline removed from the
*write* path. This module mirrors that work for reads, in four stages:

1. **Plan** (``restore.plan``): resolve every file's content list
   through the index, derive each blob's byte offset within its file
   (``raw_length`` is the plaintext length, known before any fetch),
   group needed blobs by the pack that holds them, and order pack
   fetches by first need — each pack is downloaded ONCE and all ranges
   within it coalesce into that one GET.
2. **Fetch** (``restore.fetch``): a bounded async pool
   (``VOLSYNC_RESTORE_FETCHERS`` threads, ``VOLSYNC_RESTORE_FETCH_WINDOW``
   packs submitted ahead) pulls whole packs through the shared
   ``PackCache`` (repo/packcache.py) — LRU with a byte budget,
   single-flight across concurrent restores.
3. **Verify** (``restore.verify``): chunk hashes re-derive DEVICE-SIDE
   in ~64 MiB batches (engine/chunker.verify_blob_batch — the same
   page-grid kernel repository check uses) while later fetches are
   still in flight. A batch's bytes reach disk only after the batch
   verifies. A mismatch first attempts READ-REPAIR
   (``VOLSYNC_SCRUB_READ_REPAIR``, default on): one fetch of the
   owning pack's mirror copy (``VOLSYNC_PACK_COPIES=2``), proven
   byte-perfect against the content-addressed pack id, heals the
   primary with one overwriting PUT (verify-then-replace — the
   repo/scrub.py protocol) and the corrupt blobs re-decode from the
   healthy body — so a restore storm survives bit-rot the scrubber
   has not reached yet. When no byte-perfect mirror exists the heal
   falls through to Reed-Solomon RECONSTRUCTION from any k healthy
   shards of the pack's ``ec/`` stripe (``repo.ec_reconstruct``,
   which proves the content-addressed pack id before returning).
   Only when neither arm yields a provable body does the mismatch
   raise, before any byte of that batch is written, and the failed
   restore leaves no partial file behind.
4. **Write** (``restore.write``): verified blobs are written at their
   planned offsets with the serial path's sparse semantics (aligned
   all-zero pages become holes; chunk boundaries are page-aligned, so
   the hole grid matches the serial writer's byte for byte).

The pipeline runs under the caller's shared-mode repository lock for
its WHOLE fetch window, so a concurrent two-phase pruner can mark packs
pending-delete mid-restore but never sweep them out from under the
fetch stage — pending-delete packs stay readable through their grace
period by design (docs/robustness.md, "Multi-writer protocol").

``RestoreGroup`` runs N snapshot restores in parallel sharing ONE
PackCache: a restore storm over the same snapshot fetches each pack
once for the whole group (the chaos drill asserts store GET counts).

Byte identity with the serial oracle is pinned by
tests/test_restorepipe.py; VOLSYNC_RESTORE_PIPELINE=0 selects the
serial path at runtime.

Ports ``volsync_tpu/engine/restorepipe.py``. The verify stage runs the
port's ``verify_blob_batch`` on the owning ``TreeRestore``'s device.
The Reed-Solomon arm of the heal reaches ``Repository.ec_reconstruct``,
which decodes a pack that has ``ec/`` shards from any k of its k + m
shards (``ops/rs.gf_matmul`` on the repository's device) and raises
NoSuchKey where no k of them prove out (a pack that has none), as there;
tests/test_torch_ec.py::test_ec_estate_is_stripes_only_and_survives_m_losses
restores an EC repository with m shards of every pack lost.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

from volsync_tpu_torch import envflags
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS
from volsync_tpu_torch.objstore.store import NoSuchKey
from volsync_tpu_torch.obs import (
    current_context,
    record_trigger,
    span,
    use_context,
)
from volsync_tpu_torch.repo import crypto
from volsync_tpu_torch.repo.packcache import PackCache
from volsync_tpu_torch.repo.repository import (
    RepoError,
    mirror_key,
    pack_key,
)

_M_RESTORE_BYTES = GLOBAL_METRICS.restore_bytes
# read-repair shares the scrub's heal accounting (the cached-child
# convention): a restore-side mirror heal is the same event as a
# scrub-side one, just detected earlier
_M_HEALED = GLOBAL_METRICS.scrub_packs.labels(outcome="healed")

#: sentinel pack key for blobs still buffered in an active write
#: pipeline (IndexEntry.pack == "") — read via the repository, no GET
_BUFFERED = ""


class _FilePlan:
    """One file's restore state: where it goes, how many blob writes
    remain, and the final length to truncate to (trailing holes)."""

    __slots__ = ("entry", "target", "total", "remaining", "claimed")

    def __init__(self, entry: dict, target: Path):
        self.entry = entry
        self.target = target
        self.total = 0
        self.remaining = 0
        self.claimed = False


def restore_files_pipelined(tr, jobs: list, stats: dict) -> None:
    """Restore every (entry, target) file job through the four-stage
    pipeline. ``tr`` is the owning TreeRestore (skip/clear/finalize
    semantics and the sparse toggle are ITS methods, so the two paths
    cannot drift); must run under the repo's shared store lock."""
    repo = tr.repo
    cache = tr.pack_cache
    if cache is None:
        cache = PackCache(repo.store, rescue=repo.ec_reconstruct)
    with span("restore.plan"):
        plans, placements, groups = _plan(tr, jobs, stats)
    if not plans:
        return
    try:
        _execute(tr, repo, cache, plans, placements, groups, stats)
    except BaseException:
        # zero partial files on a failed restore: complete files stay,
        # every claimed-but-incomplete target is removed
        for plan in plans:
            if plan.claimed and plan.remaining > 0:
                plan.target.unlink(missing_ok=True)
        raise


def _plan(tr, jobs: list, stats: dict):
    """Stage 1: skip-unchanged filtering, target claiming, offset
    derivation, and pack grouping (module docstring)."""
    repo = tr.repo
    plans: list[_FilePlan] = []
    # blob_id -> [(plan, offset_in_file)] across ALL files (dedup means
    # one fetched blob may land in many places)
    placements: dict[str, list] = {}
    # pack id (or _BUFFERED) -> [(blob_id, offset_in_pack, length)],
    # ordered by first need so early files' packs fetch first
    groups: "OrderedDict[str, list]" = OrderedDict()
    for entry, target in jobs:
        if tr._skip_unchanged(entry, target):
            stats["skipped"] += 1
            continue
        tr._clear_target(target)
        plan = _FilePlan(entry, target)
        # claim: create/truncate now, so a failure ANYWHERE later knows
        # exactly which targets to clean up
        with open(target, "wb"):
            pass
        plan.claimed = True
        offset = 0
        for blob_id in entry["content"]:
            ie = repo._entry(blob_id)
            if ie is None:
                raise RepoError(f"blob {blob_id} not in index")
            known = placements.get(blob_id)
            if known is None:
                placements[blob_id] = [(plan, offset)]
                grp = groups.get(ie.pack)
                if grp is None:
                    grp = groups[ie.pack] = []
                grp.append((blob_id, ie.offset, ie.length, ie.raw_length))
            else:
                known.append((plan, offset))
            offset += ie.raw_length
            plan.remaining += 1
        plan.total = offset
        plans.append(plan)
        if plan.remaining == 0:
            _finish_file(tr, plan, stats)
    return plans, placements, groups


def _mirror_heal(repo, cache: PackCache, pack_id: str) -> Optional[bytes]:
    """Read-repair heal: fetch the mirror copy, prove it byte-perfect
    (the pack id is the SHA-256 of the whole sealed blob) — falling
    through to Reed-Solomon reconstruction from the pack's ``ec/``
    stripe when no provable mirror exists — then heal the primary with
    one overwriting PUT (verify-then-replace, never delete-first) and
    evict the poisoned cache body so every later fetch sees healthy
    bytes. The mirror arm runs FIRST (one GET beats k shard GETs plus
    a decode) and costs exactly one mirror fetch. Returns the healthy
    body, or None when neither arm proves out (single-copy repository,
    swept mirror, fewer than k provable shards)."""
    body = None
    try:
        mirror = repo.store.get(mirror_key(pack_id))
        if hashlib.sha256(mirror).hexdigest() == pack_id:
            body = mirror
    except NoSuchKey:
        pass
    if body is None:
        try:
            body = repo.ec_reconstruct(pack_id)
        except NoSuchKey:
            return None
    with span("scrub.heal"):
        repo.store.put(pack_key(pack_id), body)
    cache.invalidate(pack_id)
    _M_HEALED.inc()
    record_trigger("scrub_corruption", pack=pack_id,
                   source="read_repair", healed=True)
    return body


def _execute(tr, repo, cache: PackCache, plans, placements,
             groups: "OrderedDict[str, list]", stats: dict) -> None:
    """Stages 2-4: bounded async pack fetch -> decode -> device-batched
    verify -> positional writes, consuming packs in plan order."""
    ctx = current_context()

    def fetch(pack_id: str) -> Optional[bytes]:
        # pool thread: re-enter the caller's trace so restore.fetch
        # spans attribute to the restore being served
        with use_context(ctx):
            if pack_id == _BUFFERED:
                return None
            return cache.get_pack(pack_id)

    window = envflags.restore_fetch_window()
    batch: list[tuple[str, bytes]] = []
    batch_bytes = 0
    # read-repair state: blob -> (pack, offset, length, raw_length)
    # provenance for everything in ``batch``, and a per-pack memo of
    # heal attempts (None = no healthy mirror) so a corrupt pack costs
    # exactly ONE mirror re-fetch however many blobs/batches it spans
    src: dict[str, tuple[str, int, int, int]] = {}
    healed: dict[str, Optional[bytes]] = {}
    repair_on = envflags.scrub_read_repair_enabled()

    def healthy_body(pack_id: str) -> Optional[bytes]:
        if not repair_on:
            return None
        if pack_id not in healed:
            healed[pack_id] = _mirror_heal(repo, cache, pack_id)
        return healed[pack_id]

    def decode_member(body, blob_id: str, p_off: int, p_len: int,
                      raw_len: int):
        # zero-copy slice: the sealed segment decodes straight off the
        # cached pack body; on the unencrypted+incompressible path
        # ``data`` stays a memoryview all the way to the positional
        # file write
        data = repo._decode_blob(memoryview(body)[p_off:p_off + p_len])
        if len(data) != raw_len:
            raise crypto.IntegrityError(
                f"restore: blob {blob_id} length "
                f"{len(data)} != indexed {raw_len}")
        return data

    def repair_batch(bad: list) -> None:
        """Re-decode the corrupt entries of ``batch`` in place from
        healed pack bodies and re-verify exactly those; raises
        IntegrityError when any blob stays bad (no healthy mirror)."""
        from volsync_tpu_torch.engine.chunker import verify_blob_batch

        bad_set = set(bad)
        repaired: list[tuple[str, bytes]] = []
        for i, (blob_id, _data) in enumerate(batch):
            if blob_id not in bad_set:
                continue
            prov = src.get(blob_id)
            body = healthy_body(prov[0]) if prov is not None else None
            if body is None:
                record_trigger("restore_verify_fail", blob=blob_id)
                raise crypto.IntegrityError(
                    f"restore: blob {blob_id} content hash mismatch")
            batch[i] = (blob_id, decode_member(body, blob_id, *prov[1:]))
            repaired.append(batch[i])
        with span("restore.verify"):
            still_bad = verify_blob_batch(repaired, device=tr.device)
        if still_bad:
            record_trigger("restore_verify_fail", blob=still_bad[0])
            raise crypto.IntegrityError(
                f"restore: blob {still_bad[0]} content hash mismatch")

    def flush_batch():
        nonlocal batch, batch_bytes
        if not batch:
            return
        from volsync_tpu_torch.engine.chunker import verify_blob_batch

        with span("restore.verify"):
            bad = verify_blob_batch(batch, device=tr.device)
        if bad:
            # device verify caught wrong bytes: heal from the mirror
            # before giving up (module docstring, stage 3)
            repair_batch(bad)
        with span("restore.write"):
            for blob_id, data in batch:
                for plan, offset in placements[blob_id]:
                    _write_at(tr, plan, offset, data)
                    plan.remaining -= 1
                    if plan.remaining == 0:
                        _finish_file(tr, plan, stats)
                _M_RESTORE_BYTES.inc(len(data)
                                     * len(placements[blob_id]))
        batch, batch_bytes = [], 0

    order = deque(groups.items())
    pending: "deque[tuple[str, list, object]]" = deque()
    with ThreadPoolExecutor(max_workers=envflags.restore_fetchers(),
                            thread_name_prefix="restore-fetch") as pool:
        try:
            while order or pending:
                while order and len(pending) < window:
                    pack_id, members = order.popleft()
                    pending.append(
                        (pack_id, members, pool.submit(fetch, pack_id)))
                pack_id, members, fut = pending.popleft()
                body = fut.result()
                for blob_id, p_off, p_len, raw_len in members:
                    if body is None:
                        # buffered in an active write pipeline of this
                        # process — no pack object to fetch yet
                        data = repo.read_blob_raw(blob_id)
                        if len(data) != raw_len:
                            raise crypto.IntegrityError(
                                f"restore: blob {blob_id} length "
                                f"{len(data)} != indexed {raw_len}")
                    else:
                        src[blob_id] = (pack_id, p_off, p_len, raw_len)
                        try:
                            data = decode_member(body, blob_id, p_off,
                                                 p_len, raw_len)
                        except Exception:  # noqa: BLE001 — an
                            # undecodable segment (torn seal, decompress
                            # error, wrong length) is the same silent-
                            # corruption class the verify stage catches;
                            # try the mirror before dying
                            mbody = healthy_body(pack_id)
                            if mbody is None:
                                raise
                            data = decode_member(mbody, blob_id, p_off,
                                                 p_len, raw_len)
                    batch.append((blob_id, data))
                    batch_bytes += len(data)
                    if batch_bytes >= tr._VERIFY_BATCH:
                        flush_batch()
            flush_batch()
        except BaseException:
            for _, _, fut in pending:
                fut.cancel()
            for _, _, fut in pending:
                try:
                    fut.exception()
                except BaseException:  # lint: ignore[VL003] — draining
                    # cancelled/failed stragglers so no fetch thread
                    # outlives the pipeline; the primary error below
                    # carries the failure
                    pass
            raise


def _write_at(tr, plan: _FilePlan, offset: int, data: bytes) -> None:
    """One positional blob write with the serial path's sparse
    semantics. Opens per write: restores span more files than fd
    limits, and a blob's writes are MiB-scale so the open is noise."""
    from volsync_tpu_torch.engine.restore import _write_sparse

    with open(plan.target, "r+b") as f:
        f.seek(offset)
        if tr.sparse:
            _write_sparse(f, data)
        else:
            f.write(data)


def _finish_file(tr, plan: _FilePlan, stats: dict) -> None:
    """All content written: materialize trailing holes and stamp
    metadata exactly as the serial writer does."""
    with open(plan.target, "r+b") as f:
        f.truncate(plan.total)
    tr._finalize_file(plan.entry, plan.target)
    stats["files"] += 1
    stats["bytes"] += plan.entry["size"]


class RestoreGroup:
    """Parallel multi-snapshot restore sharing one PackCache.

    Queue jobs with :meth:`add`, run them with :meth:`run`. Every job
    gets its own shared-mode repository lock and its own thread; all
    pack fetches for jobs over the same store funnel through one
    single-flight cache, so N restores of one snapshot cost each pack
    ONE store GET for the whole group. Pass each job its OWN
    Repository handle — handles are cheap, and per-job locks/indices
    must not interleave on one object."""

    def __init__(self, *, budget_bytes: Optional[int] = None):
        self._budget = budget_bytes
        # safe unlocked: run() pre-populates per-store caches before
        # any thread starts; job threads only read (Thread.start() is
        # the happens-before edge)
        self._caches: dict[int, PackCache] = {}  # lint: ignore[VL404]
        self._jobs: list[tuple] = []

    def cache_for(self, store, rescue=None) -> PackCache:
        """The group's shared cache for ``store`` (one per distinct
        store object). ``rescue`` (first caller wins) is the cache's
        missing-primary fallback — ec_reconstruct is content-addressed
        and store-scoped, so any job's repository handle over the same
        store derives identical bodies."""
        cache = self._caches.get(id(store))
        if cache is None:
            cache = PackCache(store, budget_bytes=self._budget,
                              rescue=rescue)
            self._caches[id(store)] = cache
        return cache

    def add(self, repo, dest, *, restore_as_of=None, previous: int = 0,
            delete_extra: bool = True) -> None:
        self._jobs.append((repo, dest, restore_as_of, previous,
                           delete_extra))

    def stats(self) -> list[dict]:
        return [c.stats() for c in self._caches.values()]

    def run(self) -> list[Optional[dict]]:
        """Run every queued job concurrently; returns per-job stats
        (None where no snapshot matched) in add() order. The first
        job failure re-raises after EVERY thread has joined — no
        orphaned fetch pool keeps reading behind the caller's back."""
        from volsync_tpu_torch.engine.restore import TreeRestore

        results: list = [None] * len(self._jobs)
        errors: list = [None] * len(self._jobs)
        # caches are created up front, single-threaded: cache_for is
        # not synchronized and must not race inside the job threads
        for repo, *_ in self._jobs:
            self.cache_for(repo.store, rescue=repo.ec_reconstruct)

        def one(i: int, repo, dest, as_of, previous, delete_extra):
            try:
                with repo.lock(exclusive=False):
                    # listing before the index load, as restore_snapshot
                    selected = repo.select_snapshot(
                        restore_as_of=as_of, previous=previous)
                    if selected is None:
                        return
                    repo.load_index()
                    snap_id, manifest = selected
                    tr = TreeRestore(repo, pipeline=True)
                    tr.pack_cache = self.cache_for(repo.store)
                    results[i] = tr._run_locked(
                        snap_id, manifest, dest,
                        delete_extra=delete_extra)
            except BaseException as e:  # noqa: BLE001 — collected and
                errors[i] = e           # re-raised by the coordinator

        threads: list[threading.Thread] = []
        for i, job in enumerate(self._jobs):
            t = threading.Thread(target=one, args=(i, *job),
                                 name=f"restore-group-{i}")
            threads.append(t)
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
        return results
