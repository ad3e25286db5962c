"""Online repack: rewrite fragmented packs into erasure-coded stripes.

Ports ``volsync_tpu/repo/repack.py`` whole. ``RepackService`` takes
``device=`` (CUDA by default, raising where CUDA is absent) and opens
its repository there: the stripes are encoded, read back, decoded and
device-verified on it. The one-shot ``repack`` CLI verb is
``volsync_tpu_torch/cli/repack.py``.

Prune (repo/repository.py) keeps the repository CORRECT as snapshots
are forgotten, but its victims are chosen by liveness alone; a
long-lived estate accumulates packs that are mostly dead bytes yet
never quite dead enough, and — on repositories sealed before
``VOLSYNC_EC_SCHEME`` was armed — every one of those packs still
carries the 2x primary+mirror footprint. ``RepackService`` is the
always-on maintenance loop that amortizes that estate down to the
(k+m)/k <= 1.5x erasure-coded layout:

- **selection** — packs whose dead-entry ratio exceeds
  ``VOLSYNC_REPACK_DEAD_RATIO`` (entries no snapshot references /
  total entries, the same vectorized liveness math prune uses);
- **rewrite** — each victim's LIVE sealed segments are copied
  verbatim (no re-chunk, no re-seal: blob seals do not bind their
  pack offset) into a fresh pack body that is erasure-coded into k+m
  shards under ``ec/<new-pack-id>/<idx>``;
- **two-phase retire** — write-new-verify-then-retire-old, never
  delete-first. The stripe is READ BACK from the store and proved
  (reconstruct + content-addressed pack id + device-verified blobs)
  before the index re-homes a single entry; the old pack is then
  parked in a ``pending-delete/`` manifest (``source: "repack"``)
  with a grace deadline and swept only by a LATER cycle once the
  deadline passed, no pre-mark foreign lock survives, and every
  entry still homed in it is provably dead. The exact write order is
  declared in ``CRASH_ORDERINGS`` below (the reference's VL605
  analyzer proves it statically there); the chaos tests crash at every
  boundary.

A crash anywhere mid-cycle is recoverable by design: an orphaned
stripe (published, never indexed) is exactly the un-indexed-pack
debris prune's orphan scan already marks and sweeps; a retired pack
whose manifest survives is either re-swept here or rescued by prune's
own sweep triage (both read the same manifests).

The service shape is ContinuousGC's: ``run_once()`` is the
deterministic-test entry point returning an outcome string, the
background loop keeps cadence through contention, fencing, and store
weather. Cycles run under a ``prune``-mode store lock — concurrent
backup/restore traffic holds shared locks and proceeds; other
pruners/repackers are excluded.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
from datetime import datetime, timedelta, timezone
from typing import Optional

import numpy as np

from volsync_tpu_torch import envflags, resolve_device
from volsync_tpu_torch.analysis.lockcheck import make_lock
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS
from volsync_tpu_torch.objstore.store import NoSuchKey
from volsync_tpu_torch.obs import record_trigger, span
from volsync_tpu_torch.repo import erasure
from volsync_tpu_torch.repo.repository import (
    RepoError,
    RepoLockedError,
    Repository,
    StaleWriterError,
    _parse_time,
    ec_pack_prefix,
    mirror_key,
    pack_key,
    quarantine_key,
)
from volsync_tpu_torch.repo.scrub import verify_pack_blobs

log = logging.getLogger("volsync_tpu_torch.repo.repack")

#: Declared repack write order (the reference's VL605 analyzer,
#: analysis/faultflow.py, proves it statically there). A crash between any two steps leaves every
#: snapshot restorable: the stripe is durable and PROVEN before the
#: index references it, the index re-homes entries before the old pack
#: is even marked, and old objects are deleted only for packs retired
#: by an earlier, grace-expired cycle.
CRASH_ORDERINGS = {
    "repack.cycle": ("_repack_locked", (
        "_write_stripes",           # new stripe durable first
        "_verify_stripes",          # read back + prove before indexing
        "_publish_entries",         # re-home the index, then
        "_write_retire_manifest",   # park the old pack (two-phase)
        "delete-of:old_keys",       # sweep only prior expired retirees
    )),
}

_M_PACKS = GLOBAL_METRICS.repack_packs


class RepackService:
    """Drives one repack cycle every ``interval_seconds`` against
    ``store`` (this replica's own — possibly faulted — view of the
    shared backing store).

    ``scheme`` is the (k, m) stripe geometry for rewritten packs;
    default ``VOLSYNC_EC_SCHEME``, falling back to 4+2 — the repacker
    exists to carry the estate to the erasure-coded layout, so it
    stripes even when the seal path still mirrors. ``dead_ratio`` is
    the selection threshold (``VOLSYNC_REPACK_DEAD_RATIO``).
    ``grace_seconds`` follows prune's resolution rules and must stay
    > 0: repack is an ONLINE protocol, retire-then-sweep is what makes
    it safe under concurrent readers. ``run_once()`` is the
    deterministic-test entry point; ``start()``/``stop()`` wrap it in
    the background loop. The repository opens on ``device`` (CUDA by
    default)."""

    def __init__(self, store, *, password: Optional[str] = None,
                 device=None,
                 scheme: Optional[tuple] = None,
                 dead_ratio: Optional[float] = None,
                 interval_seconds: Optional[float] = None,
                 packs_per_cycle: Optional[int] = None,
                 grace_seconds: Optional[float] = None,
                 lock_wait: float = 0.0):
        if grace_seconds is not None and grace_seconds <= 0:
            raise ValueError(
                "repack requires grace_seconds > 0 (an immediate sweep "
                "would delete packs a concurrent restore still reads)")
        self.device = resolve_device(device)
        if scheme is None:
            scheme = envflags.ec_scheme() or (4, 2)
        erasure.validate_scheme(*scheme)
        self.store = store
        self.password = password
        self.scheme = scheme
        self.dead_ratio = (envflags.repack_dead_ratio()
                           if dead_ratio is None else float(dead_ratio))
        self.interval = (envflags.repack_interval_seconds()
                         if interval_seconds is None
                         else interval_seconds)
        self.per_cycle = (envflags.repack_packs_per_cycle()
                          if packs_per_cycle is None else packs_per_cycle)
        self.grace = grace_seconds
        self.lock_wait = lock_wait
        self._repo = None
        self.cycles = 0
        self._outcomes_lock = make_lock("repack.outcomes")
        self.outcomes: dict[str, int] = {}
        self.last_report: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _open(self):
        if self._repo is None:
            repo = Repository.open(self.store, self.password,
                                   device=self.device)
            repo.default_lock_wait = self.lock_wait
            self._repo = repo
        return self._repo

    # -- one cycle ----------------------------------------------------------

    def run_once(self) -> str:
        """One repack cycle; returns the outcome ("ok", "clean",
        "contended", "fenced", "error") and never raises — the loop's
        cadence must survive anything a cycle hits."""
        self.cycles += 1
        try:
            with span("repo.repack"):
                repo = self._open()
                # reviewed: like prune, repack holds repo.state across
                # rewrite/publish store I/O BY DESIGN — the declared
                # crash ordering depends on no concurrent LOCAL writer
                # mutating the index between steps; remote writers are
                # fenced by the prune-mode store lock + manifests.
                with repo.lock(mode="prune"), repo._lock:
                    self.last_report = self._repack_locked(repo)
            did = (self.last_report["packs_rewritten"]
                   + self.last_report["packs_retired"]
                   + self.last_report["packs_swept"])
            outcome = "ok" if did else "clean"
        except RepoLockedError as exc:
            log.info("repack cycle skipped (contended): %s", exc)
            outcome = "contended"
        except StaleWriterError as exc:
            log.warning("repack writer fenced, reopening: %s", exc)
            self._repo = None
            outcome = "fenced"
        except Exception as exc:  # noqa: BLE001 — store weather or a
            # torn read mid-cycle; the service must keep its cadence
            log.warning("repack cycle failed: %s", exc)
            # a failed cycle may have left the handle mid-state; a
            # fresh open next cycle is always safe (the protocol is
            # two-phase crash-safe, so a retried cycle converges)
            self._repo = None
            outcome = "error"
        with self._outcomes_lock:
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
        GLOBAL_METRICS.repack_cycles.labels(outcome=outcome).inc()
        return outcome

    def _repack_locked(self, repo) -> dict:
        """One locked cycle: sweep-triage prior retirees, select this
        round's victims by dead ratio, then the declared order —
        write stripes, verify, publish, retire, delete expired."""
        repo.flush()
        # the deltas a consolidation may delete, listed before the index
        # load (Repository._prune_locked says why)
        baseline_deltas = set(repo.store.list("index/"))
        snaps = repo._list_then_load()
        own_mark = len(repo._published_deltas)
        now = datetime.now(timezone.utc)
        locks = repo._live_foreign_locks()
        reach = repo._referenced_keys(snaps)
        keys, pack_codes, pack_names = repo._index.snapshot_arrays()
        if reach.size and keys.size:
            pos = np.clip(np.searchsorted(reach, keys), 0,
                          reach.size - 1)
            live_mask = reach[pos] == keys
        else:
            live_mask = np.zeros((keys.size,), dtype=bool)
        totals = np.bincount(pack_codes, minlength=len(pack_names))
        lives = np.bincount(pack_codes[live_mask],
                            minlength=len(pack_names))
        keys_u8 = keys.view(np.uint8).reshape(-1, 32)
        order = np.argsort(pack_codes, kind="stable")
        sorted_codes = pack_codes[order]
        code_of = {name: c for c, name in enumerate(pack_names)}

        def pack_rows(code):
            lo = np.searchsorted(sorted_codes, code, "left")
            hi = np.searchsorted(sorted_codes, code, "right")
            return order[lo:hi]

        # -- sweep triage: prior repack retirees whose grace expired --
        # Only manifests this service wrote are swept here (prune's own
        # sweep handles the rest — and handles OURS too, with its
        # rescue machinery, if this service never runs again); a pack
        # is sweepable only when every entry still homed in it is
        # provably dead — anything live is prune's rescue to make.
        sweep_packs: set[str] = set()
        sweep_keys: list[str] = []
        pending_all: set[str] = set()
        doomed: dict[str, list[str]] = {}
        for key, man in repo._load_pending_manifests():
            packs = set(man.get("packs", ()))
            pending_all |= packs
            if man.get("source") != "repack":
                continue
            try:
                deadline = _parse_time(man["deadline"])
                marked_at = _parse_time(man["marked_at"])
            except (KeyError, ValueError):
                deadline = marked_at = now  # damaged: quiescent-only
            if now < deadline or repo._sweep_blocked(marked_at, locks):
                continue
            sweep_keys.append(key)
            sweep_packs |= packs
        for pack in sorted(sweep_packs):
            code = code_of.get(pack)
            rows = pack_rows(code) if code is not None else []
            if any(live_mask[r] for r in rows):
                # a writer deduped into the retiree after its mark:
                # live again — prune's rescue owns it, not our delete
                sweep_packs.discard(pack)
                sweep_keys = [k for k in sweep_keys
                              if pack not in self._manifest_packs(repo, k)]
                continue
            doomed[pack] = [memoryview(keys_u8[r]).hex() for r in rows]

        # -- selection: dead ratio over the threshold -----------------
        candidates: list[tuple[float, str]] = []
        retire: set[str] = set()
        for code in np.nonzero(totals > 0)[0]:
            name = pack_names[code]
            if not name or name in pending_all:
                continue
            dead = float(totals[code] - lives[code]) / float(totals[code])
            if dead <= self.dead_ratio:
                continue
            if lives[code] == 0:
                # fully dead: nothing to restripe — straight to retire
                # (dead ENTRIES stay until the sweep, prune's rule: a
                # pre-mark writer may still dedup against them)
                retire.add(name)
            else:
                candidates.append((dead, name))
        candidates.sort(reverse=True)
        if self.per_cycle:
            candidates = candidates[:self.per_cycle]
        if not candidates and not retire and not sweep_packs:
            return {"packs_rewritten": 0, "packs_retired": 0,
                    "packs_swept": 0, "blobs_rehomed": 0,
                    "stripes_bytes": 0}

        # -- declared order: write -> verify -> publish -> retire -----
        staged: list[tuple[str, str, list]] = []
        stripe_bytes = 0
        for _ratio, pack_id in candidates:
            rows = sorted(
                ((memoryview(keys_u8[r]).hex(), r) for r
                 in pack_rows(code_of[pack_id]) if live_mask[r]),
                key=lambda item: repo._entry(item[0]).offset)
            made = self._write_stripes(repo, pack_id,
                                       [b for b, _ in rows])
            if made is None:
                continue  # unreadable source or no-op rewrite: skip
            new_id, entries, nbytes = made
            self._verify_stripes(repo, new_id, entries)
            staged.append((pack_id, new_id, entries))
            retire.add(pack_id)
            stripe_bytes += nbytes
            _M_PACKS.inc()
        sweep_packs = self._publish_entries(repo, staged, sweep_packs,
                                            doomed, baseline_deltas,
                                            own_mark)
        if retire:
            self._write_retire_manifest(repo, retire)
        old_keys: list[str] = []
        for pack in sorted(sweep_packs):
            old_keys.append(pack_key(pack))
            old_keys.append(mirror_key(pack))
            old_keys.extend(repo.store.list(ec_pack_prefix(pack)))
            old_keys.append(quarantine_key(pack))
        old_keys.extend(sweep_keys)
        for okey in old_keys:
            repo.store.delete(okey)
        if staged or sweep_packs:
            record_trigger("repack_cycle",
                           rewritten=[p for p, _n, _e in staged],
                           swept=sorted(sweep_packs))
        return {"packs_rewritten": len(staged),
                "packs_retired": len(retire),
                "packs_swept": len(sweep_packs),
                "blobs_rehomed": sum(len(e) for _p, _n, e in staged),
                "stripes_bytes": stripe_bytes}

    @staticmethod
    def _manifest_packs(repo, key: str) -> set:
        try:
            return set(json.loads(repo.store.get(key)).get("packs", ()))
        except (NoSuchKey, ValueError):
            return set()

    # -- protocol steps (CRASH_ORDERINGS order) -----------------------------

    def _pack_body(self, repo, pack_id: str) -> Optional[bytes]:
        """The proven source body: primary, mirror, or reconstructed
        stripe — whichever first re-derives the content-addressed pack
        id. None means the source is unreadable/corrupt: repack SKIPS
        it (the scrub owns quarantine and heal, not the repacker)."""
        for key in (pack_key(pack_id), mirror_key(pack_id)):
            try:
                body = repo.store.get(key)
            except NoSuchKey:
                continue
            if hashlib.sha256(body).hexdigest() == pack_id:
                return body
        try:
            return repo.ec_reconstruct(pack_id)
        except NoSuchKey:
            return None

    def _write_stripes(self, repo, pack_id: str,
                       live_ids: list) -> Optional[tuple]:
        """Build the replacement pack from the victim's live sealed
        segments (copied verbatim — seals do not bind pack offsets)
        and publish it as a k+m stripe. Returns (new_pack_id, entries,
        stored_bytes), or None when the source is unreadable or the
        rewrite would be a byte-identical no-op."""
        body = self._pack_body(repo, pack_id)
        if body is None:
            record_trigger("repack_skip", pack=pack_id,
                           reason="unreadable")
            return None
        view = memoryview(body)
        segments: list = []  # memoryview slices: zero-copy carry-over
        entries: list[dict] = []
        off = 0
        for blob_id in live_ids:
            e = repo._entry(blob_id)
            segments.append(view[e.offset:e.offset + e.length])
            entries.append({"id": blob_id, "type": e.type,
                            "offset": off, "length": e.length,
                            "raw_length": e.raw_length})
            off += e.length
        header = repo.box.seal(
            repo._zc.compress(json.dumps(entries).encode()))
        parts = segments + [header,
                            len(header).to_bytes(4, "big") + b"VTPK"]
        h = hashlib.sha256()
        for p in parts:
            h.update(p)
        new_id = h.hexdigest()
        if new_id == pack_id:
            # content-addressed no-op (nothing was dead after all):
            # staging it would retire the very object just written
            return None
        k, m = self.scheme
        with span("repack.stripe"):
            shards = erasure.encode_pack_shards(parts, k, m,
                                                device=repo.device)
            for idx, shard in enumerate(shards):
                repo.ec_publish_shard(new_id, idx, shard)
        return new_id, entries, sum(len(s) for s in shards)

    def _verify_stripes(self, repo, new_id: str,
                        entries: list) -> None:
        """Read the stripe BACK from the store and prove it end to
        end — reconstruct, re-derive the pack id, device-verify every
        blob — before a single index entry may reference it."""
        blobs = repo.ec_shard_blobs(new_id)
        body = erasure.reconstruct_verified(blobs, new_id,
                                            device=repo.device)
        if body is None:
            raise RepoError(
                f"repack: stripe {new_id} failed readback proof")
        bad = verify_pack_blobs(
            repo, body,
            [(e["id"], e["offset"], e["length"]) for e in entries])
        if bad:
            raise RepoError(
                f"repack: stripe {new_id} blob {bad[0]} failed "
                "device verify on readback")

    def _publish_entries(self, repo, staged: list, sweep_packs: set,
                         doomed: dict, baseline_deltas: set,
                         own_mark: int) -> set:
        """Re-home every staged blob to its new stripe, drop the dead
        entries of this cycle's sweepable retirees, and republish the
        consolidated index (prune's steps 3-4). Returns the final
        sweep set — a retiree the post-publish index still references
        (content-addressed resurrection) must survive."""
        for _old, new_id, entries in staged:
            for e in entries:
                repo._index.remove(e["id"])
                repo._index.insert(e["id"], new_id, e["type"],
                                   e["offset"], e["length"],
                                   e["raw_length"])
        for pack in sorted(sweep_packs):
            for blob_id in doomed.get(pack, ()):
                repo._index.remove(blob_id)
        repo._index.vacuum()
        referenced_now = {p for p in repo._index.live_packs() if p}
        sweep_packs = sweep_packs - referenced_now
        if not staged and not doomed:
            return sweep_packs  # index unchanged: keep the deltas
        new_keys = repo._write_consolidated_index()
        superseded = (baseline_deltas
                      | set(repo._published_deltas[own_mark:])) - new_keys
        for key in superseded:
            repo.store.delete(key)
        repo._pending_index = {}
        repo._pending_count = 0
        repo._published_deltas = list(new_keys)
        return sweep_packs

    def _write_retire_manifest(self, repo, packs: set) -> str:
        """Park this cycle's victims under ``pending-delete/`` with a
        grace deadline — the same manifest shape prune writes (its
        sweep triage honors ours, ours only touches its own), tagged
        ``source: "repack"``. Plaintext for the same reason prune's
        is: foreign writers read it during load_index."""
        grace = repo._resolve_grace(self.grace)
        now = datetime.now(timezone.utc)
        manifest = {
            "packs": sorted(packs),
            "marked_at": now.isoformat(),
            "deadline": (now + timedelta(seconds=grace)).isoformat(),
            "gen": repo.generation,
            "writer": repo.writer_id,
            "source": "repack",
        }
        payload = json.dumps(manifest).encode()
        key = "pending-delete/" + hashlib.sha256(payload).hexdigest()[:32]
        repo._guard_publish("repack retire manifest")
        repo.store.put(key, payload)
        return key

    # -- service loop -------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.run_once()

    def start(self) -> "RepackService":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repo-repack")
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
