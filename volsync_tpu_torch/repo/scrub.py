"""Continuous integrity scrub: the silent-corruption defense service.

Ports ``volsync_tpu/repo/scrub.py`` whole. ``ScrubService`` takes
``device=`` (CUDA by default, raising where CUDA is absent) and opens
its repository there; ``verify_pack_blobs`` re-hashes on
``repo.device``, and the stripe arms decode and re-encode there. The
one-shot ``scrub`` CLI verb and its exit codes are
``volsync_tpu_torch/cli/scrub.py``.

Every fault the chaos harness injected before this layer was LOUD —
transient errors, throttles, crashes — but the failure mode that
actually destroys backup systems is the store silently returning wrong
bytes (bit-rot, a torn sector, a flipped bit on the wire). "Optimized
Disaster Recovery for Distributed Storage Systems" (PAPERS.md) puts
the DR cost at the pack/metadata layer: detect and heal there, never
re-transfer whole datasets. ``ScrubService`` is that detector/healer,
modeled on service/gc.py's ContinuousGC loop:

- **walk** — every cycle visits a bounded slice of indexed packs
  (``VOLSYNC_SCRUB_PACKS`` per cycle, round-robin cursor; 0 = all)
  under a SHARED-mode repository lock, so live backup writers and one
  pruner keep running while the scrub reads.
- **verify** — pack bodies are fetched through the restore data
  plane's ``PackCache`` (single-flight, byte-budget LRU) and every
  blob is decoded and re-hashed in batched on-device dispatches
  (engine/chunker.verify_blob_batch) under a ``scrub.verify`` span.
- **quarantine** — a mismatching pack gets a plaintext JSON manifest
  at ``quarantine/<pack-id>`` (pack id, bad blob ids, time, writer)
  plus a ``record_trigger("scrub_corruption")`` flight-recorder
  annotation BEFORE any heal is attempted, so a crash mid-heal leaves
  the evidence behind.
- **heal** — verify-then-replace, mirror arm first: the mirror body
  (``VOLSYNC_PACK_COPIES=2`` writes ``mirror/<pack-id>`` next to every
  primary) must re-derive the content-addressed pack id AND pass
  device verify before one overwriting PUT replaces the primary —
  never delete-first, so no reader ever sees a missing pack. With no
  healthy mirror the RECONSTRUCT arm (VOLSYNC_EC_SCHEME estates)
  decodes the body from any k healthy ``ec/<pack-id>/<idx>`` shards,
  re-derives the pack id, device-verifies, and lands the same single
  overwriting PUT. The poisoned ``PackCache`` entry is invalidated
  and the healed primary RE-verified through the same fetch path;
  only then is the quarantine manifest removed. A clean pack with a
  missing or rotten mirror is re-mirrored from the verified primary
  (which also backfills mirrors for repositories that enabled
  copies=2 late); a proven stripe with missing or rotten shards gets
  those shards re-published the same way (shard backfill).
- **escalate** — no healthy mirror AND no k provable shards means
  outcome ``unhealable``: the quarantine manifest stays,
  ``record_trigger("scrub_corruption")`` fires again with
  ``unhealable=True``, and ``volsync scrub`` exits 2 — the pack is
  never silently served.

Outcomes export as ``volsync_scrub_packs_total{outcome}`` +
``volsync_scrub_bytes_total``; engine/restorepipe.py's read-repair
shares the heal protocol (and the healed metric child) for corruption
a restore hits before the scrub reaches it.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
from datetime import datetime, timezone
from typing import Optional

from volsync_tpu_torch import envflags, resolve_device
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS
from volsync_tpu_torch.objstore.store import NoSuchKey
from volsync_tpu_torch.obs import record_trigger, span
from volsync_tpu_torch.repo import erasure
from volsync_tpu_torch.repo.packcache import PackCache
from volsync_tpu_torch.repo.repository import (
    RepoLockedError,
    Repository,
    StaleWriterError,
    mirror_key,
    pack_key,
    quarantine_key,
)

log = logging.getLogger("volsync_tpu_torch.repo.scrub")

#: Declared scrub write order (the reference's VL605 analyzer,
#: analysis/faultflow.py, proves it statically there): quarantine the evidence BEFORE attempting
#: the mirror heal, and drop the quarantine manifest only after the
#: heal — a crash at any boundary leaves either the manifest or a
#: healthy pack, never silent corruption.
CRASH_ORDERINGS = {
    "scrub.heal": ("_scrub_pack", (
        "_quarantine",                 # evidence first (crash-safe)
        "_heal",                       # verify-then-replace overwrite
        "delete-prefix:quarantine/",   # manifest retired last
    )),
}

# Module-cached label children (PR 6/8 convention: resolve once at
# import, not per pack).
_M_CLEAN = GLOBAL_METRICS.scrub_packs.labels(outcome="clean")
_M_HEALED = GLOBAL_METRICS.scrub_packs.labels(outcome="healed")
_M_QUARANTINED = GLOBAL_METRICS.scrub_packs.labels(outcome="quarantined")
_M_UNHEALABLE = GLOBAL_METRICS.scrub_packs.labels(outcome="unhealable")
_M_BYTES = GLOBAL_METRICS.scrub_bytes

#: device-verify batch target — same sizing as Repository's check()
_VERIFY_BATCH = 64 * 1024 * 1024


def verify_pack_blobs(repo, body: bytes,
                      entries: list[tuple[str, int, int]]) -> list[str]:
    """Blob ids in ``body`` that fail decode or device re-hash.

    ``entries`` is ``[(blob_id, offset, length)]`` from the index. A
    segment that will not even decode (torn seal, MAC failure,
    decompress error) is as corrupt as a wrong hash — both land in the
    returned list. Hashing rides the batched device path in ~64 MiB
    fused dispatches on ``repo.device``.
    """
    from volsync_tpu_torch.engine.chunker import verify_blob_batch

    bad: list[str] = []
    batch: list[tuple[str, bytes]] = []
    batch_bytes = 0

    def flush():
        nonlocal batch, batch_bytes
        if batch:
            with span("scrub.verify"):
                bad.extend(verify_blob_batch(batch, device=repo.device))
        batch, batch_bytes = [], 0

    for blob_id, offset, length in entries:
        seg = body[offset:offset + length]
        try:
            data = repo._decode_blob(seg)
        except Exception:  # noqa: BLE001 — undecodable IS the finding:
            # the segment joins the bad list instead of killing the scan
            bad.append(blob_id)
            continue
        batch.append((blob_id, data))
        batch_bytes += len(data)
        if batch_bytes >= _VERIFY_BATCH:
            flush()
    flush()
    return bad


class ScrubService:
    """Continuously verifies and heals packs against silent corruption
    (module docstring). ``run_once()`` is the deterministic-test entry
    point; ``start()``/``stop()`` wrap it in the background loop, the
    same service shape as ContinuousGC. The repository opens on
    ``device`` (CUDA by default)."""

    def __init__(self, store, *, password: Optional[str] = None,
                 device=None,
                 interval_seconds: Optional[float] = None,
                 packs_per_cycle: Optional[int] = None,
                 lock_wait: float = 0.0):
        self.device = resolve_device(device)
        self.store = store
        self.password = password
        self.interval = (envflags.scrub_interval_seconds()
                         if interval_seconds is None else interval_seconds)
        self.packs_per_cycle = (envflags.scrub_packs_per_cycle()
                                if packs_per_cycle is None
                                else packs_per_cycle)
        self.lock_wait = lock_wait
        self._repo = None
        self._cache: Optional[PackCache] = None
        self._cursor = 0
        self.cycles = 0
        self.packs_scrubbed = 0
        self.bytes_scrubbed = 0
        self.corruptions = 0
        self.healed = 0
        self.unhealable = 0
        # single-writer: only the cycle thread (or a test calling
        # run_once synchronously) mutates; readers join() via stop()
        self.outcomes: dict[str, int] = {}  # lint: ignore[VL404]
        self.last_report: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- plumbing ----------------------------------------------------------

    def _open(self):
        if self._repo is None:
            repo = Repository.open(self.store, self.password,
                                   device=self.device)
            repo.default_lock_wait = self.lock_wait
            self._repo = repo
            # the scrub's own cache: single-flight + LRU like a
            # restore's, but invalidated on heal so a poisoned body is
            # never re-served
            self._cache = PackCache(repo.store)
        return self._repo

    # -- one cycle ---------------------------------------------------------

    def run_once(self) -> str:
        """One scrub cycle; returns the outcome ("clean", "healed",
        "unhealable", "contended", "fenced", "error") and never raises
        — the loop's cadence must survive anything a cycle hits.
        "healed"/"unhealable" report the WORST per-pack result of the
        cycle (unhealable dominates)."""
        self.cycles += 1
        try:
            with span("scrub.cycle"):
                repo = self._open()
                outcome = self._scrub_cycle(repo)
        except RepoLockedError as exc:
            # an exclusive maintenance pass holds the lock: skip this
            # cycle, the packs keep until the next one
            log.info("scrub cycle skipped (contended): %s", exc)
            outcome = "contended"
        except StaleWriterError as exc:
            # fenced like any writer (stalled past the horizon): drop
            # the dead handle, reopen fresh next cycle
            log.warning("scrub writer fenced, reopening: %s", exc)
            self._repo = None
            self._cache = None
            outcome = "fenced"
        except Exception as exc:  # noqa: BLE001 — store weather mid-
            # cycle; the service must keep its cadence
            log.warning("scrub cycle failed: %s", exc)
            self._repo = None
            self._cache = None
            outcome = "error"
        self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
        return outcome

    def _scrub_cycle(self, repo) -> str:
        bytes_before = self.bytes_scrubbed
        with repo.lock(mode="shared"):
            repo.load_index()
            # pack -> [(blob_id, offset, length)] snapshot; the sharded
            # index snapshots per shard internally, no repo.state needed
            packs: dict[str, list[tuple[str, int, int]]] = {}
            pending = set(repo._pending_packs)
            for blob_id, (pack, _btype, off, length, _raw) \
                    in repo._index.items():
                if pack and pack not in pending:
                    packs.setdefault(pack, []).append((blob_id, off, length))
            order = sorted(packs)
            report = {"packs": 0, "clean": 0, "healed": 0,
                      "unhealable": 0, "bytes": 0}
            if order:
                budget = (len(order) if self.packs_per_cycle <= 0
                          else min(self.packs_per_cycle, len(order)))
                start = self._cursor % len(order)
                for i in range(budget):
                    pack_id = order[(start + i) % len(order)]
                    res = self._scrub_pack(repo, pack_id, packs[pack_id])
                    if res == "skipped":
                        continue
                    report["packs"] += 1
                    report[res] += 1
                self._cursor = (start + budget) % len(order)
        report["bytes"] = self.bytes_scrubbed - bytes_before
        self.last_report = report
        if report["unhealable"]:
            return "unhealable"
        if report["healed"]:
            return "healed"
        return "clean"

    def _scrub_pack(self, repo, pack_id: str,
                    entries: list[tuple[str, int, int]]) -> str:
        assert self._cache is not None
        try:
            body = self._cache.get_pack(pack_id)
        except NoSuchKey:
            # No primary object: an EC-sealed pack (shards only), or a
            # prune swept it between the index snapshot and the fetch.
            return self._scrub_stripe(repo, pack_id, entries)
        self.packs_scrubbed += 1
        self.bytes_scrubbed += len(body)
        _M_BYTES.inc(len(body))
        bad = verify_pack_blobs(repo, body, entries)
        if not bad:
            if repo.pack_copies >= 2 and self._remirror(repo, pack_id,
                                                        body):
                _M_HEALED.inc()
                self.healed += 1
                return "healed"
            _M_CLEAN.inc()
            return "clean"
        # corruption: quarantine FIRST (crash mid-heal keeps the
        # evidence), then attempt the mirror heal
        self.corruptions += 1
        self._quarantine(repo, pack_id, bad)
        with span("scrub.heal"):
            healed = self._heal(repo, pack_id, entries)
        if healed:
            repo.store.delete(quarantine_key(pack_id))
            _M_HEALED.inc()
            self.healed += 1
            return "healed"
        record_trigger("scrub_corruption", pack=pack_id, unhealable=True)
        _M_UNHEALABLE.inc()
        self.unhealable += 1
        return "unhealable"

    def _scrub_stripe(self, repo, pack_id: str,
                      entries: list[tuple[str, int, int]]) -> str:
        """Scrub a pack with NO primary object. No shards either means
        a prune swept it (skip). Otherwise reconstruct-AND-prove the
        body from any k shards, device-verify every blob, and backfill
        whatever shards rotted or vanished; fewer than k provable
        shards quarantines and escalates unhealable — the stripe is
        never silently served."""
        blobs = repo.ec_shard_blobs(pack_id)
        if not blobs:
            return "skipped"
        self.packs_scrubbed += 1
        body = erasure.reconstruct_verified(blobs, pack_id,
                                            device=repo.device)
        if body is None or verify_pack_blobs(repo, body, entries):
            self.corruptions += 1
            self._quarantine(repo, pack_id, [e[0] for e in entries])
            record_trigger("scrub_corruption", pack=pack_id,
                           unhealable=True)
            _M_UNHEALABLE.inc()
            self.unhealable += 1
            return "unhealable"
        self.bytes_scrubbed += len(body)
        _M_BYTES.inc(len(body))
        if self._ec_backfill(repo, pack_id, blobs, body):
            _M_HEALED.inc()
            self.healed += 1
            return "healed"
        _M_CLEAN.inc()
        return "clean"

    # -- quarantine + heal -------------------------------------------------

    def _quarantine(self, repo, pack_id: str, bad: list[str]) -> None:
        manifest = {
            "pack": pack_id,
            "blobs": sorted(bad),
            "writer": repo.writer_id,
            "time": datetime.now(timezone.utc).isoformat(),
        }
        repo.store.put(quarantine_key(pack_id),
                       json.dumps(manifest).encode())
        _M_QUARANTINED.inc()
        record_trigger("scrub_corruption", pack=pack_id,
                       blobs=len(bad))

    def _heal(self, repo, pack_id: str,
              entries: list[tuple[str, int, int]]) -> bool:
        """Verify-then-replace; True only after the healed primary
        RE-verifies through a fresh fetch. Mirror arm first (one GET —
        the PR 14 law), reconstruct arm otherwise: any k healthy
        shards decode a candidate body whose content-addressed pack id
        is re-derived before it may become the primary. Either way the
        replacement lands as ONE overwriting PUT, never delete-first."""
        assert self._cache is not None
        body = self._healthy_body(repo, pack_id, entries)
        if body is None:
            return False
        repo.store.put(pack_key(pack_id), body)  # overwrite, not
        #                                          delete-first
        self._cache.invalidate(pack_id)
        try:
            fresh = self._cache.get_pack(pack_id)
        except NoSuchKey:
            return False
        return not verify_pack_blobs(repo, fresh, entries)

    def _healthy_body(self, repo, pack_id: str,
                      entries: list[tuple[str, int, int]]):
        """A proven replacement body, or None: the mirror when it
        re-derives the pack id and device-verifies, else the verified
        reconstruction from any k healthy shards."""
        try:
            mirror_body = repo.store.get(mirror_key(pack_id))
        except NoSuchKey:
            mirror_body = None
        if mirror_body is not None:
            # the pack id is the SHA-256 of the whole sealed blob, so
            # one host hash proves the mirror byte-perfect (header
            # included)... and the device batch re-proves every blob
            # payload before the mirror may become the primary
            if (hashlib.sha256(mirror_body).hexdigest() == pack_id
                    and not verify_pack_blobs(repo, mirror_body,
                                              entries)):
                return mirror_body
        try:
            body = repo.ec_reconstruct(pack_id)
        except NoSuchKey:
            return None
        if verify_pack_blobs(repo, body, entries):
            return None
        return body

    def _remirror(self, repo, pack_id: str, body: bytes) -> bool:
        """Heal the OTHER direction: primary verified clean, so make
        sure a byte-perfect mirror exists (backfills repositories that
        enabled VOLSYNC_PACK_COPIES=2 after their first backups, and
        repairs a rotten mirror before it is ever needed). Returns True
        when a mirror was (re)written."""
        if hashlib.sha256(body).hexdigest() != pack_id:
            # cached body itself is suspect (header rot the blob batch
            # cannot see) — leave the mirror alone
            return False
        try:
            current = repo.store.get(mirror_key(pack_id))
            if hashlib.sha256(current).hexdigest() == pack_id:
                return False
        except NoSuchKey:
            pass
        with span("scrub.heal"):
            repo.store.put(mirror_key(pack_id), body)
        return True

    def _ec_backfill(self, repo, pack_id: str, blobs: dict,
                     body: bytes) -> bool:
        """Heal a proven stripe the other direction (the EC analogue of
        _remirror): re-encode the verified body and re-publish every
        shard that vanished or rotted. Write-new only — healthy shards
        are byte-identical to the re-encode and never rewritten.
        Returns True when any shard was (re)published."""
        scheme = erasure.stripe_scheme(blobs)
        if scheme is None:
            return False
        k, m = scheme
        want = erasure.encode_pack_shards([body], k, m, device=repo.device)
        wrote = False
        for idx, shard in enumerate(want):
            if blobs.get(idx) != shard:
                with span("scrub.heal"):
                    repo.ec_publish_shard(pack_id, idx, shard)
                wrote = True
        return wrote

    # -- service loop ------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.run_once()

    def start(self) -> "ScrubService":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repo-scrub")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
