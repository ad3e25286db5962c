"""Checksum-based bucket sync engine (the `rclone sync --checksum` core).

Ports ``volsync_tpu/movers/rclone/sync.py`` whole, on the port's
``hash_spans`` / ``hash_file_streaming`` (engine/chunker.py), its stores
and its metadata helpers. The bucket it writes is byte-for-byte the
reference's: the same object keys, index shards and manifest. Two
additions: ``hash_files``, ``sync_up`` and ``sync_down`` take
``device=`` (None: CUDA, raising where it is absent; the reference
hashes on JAX's default device), and the host stages are timed as
``obs.span``s (``rclone.scan``, ``rclone.hash``, ``rclone.put`` /
``rclone.get`` a file, ``rclone.index.write`` / ``rclone.index.read``,
``rclone.meta``).

What the reference's data plane does with a wrapped rclone binary
(mover-rclone/active.sh:19-31: checksum compare, both directions,
--transfers 10 concurrent streams, POSIX-metadata round-trip via a
getfacl dump file, delete-extraneous mirror semantics), rebuilt around
the TPU hash pipeline:

  - every file's checksum is a Merkle blob id (repo/blobid.py) computed
    on device, with many files packed per upload batch
    (engine/chunker.py hash_spans) — the per-byte work that rclone does
    on CPU cores is the batched-lane SHA-256 kernel here;
  - bucket layout is content-addressed: ``<prefix>/objects/<digest>``
    holds file bytes, ``<prefix>/index.json`` maps relpath -> metadata
    (type, size, mode, mtime_ns, digest / symlink target). The index is
    the facl-dump analogue: modes and mtimes round-trip through it;
  - transfers fan out over a thread pool (the --transfers 10 analogue;
    object-store puts/gets are IO-bound);
  - mirror semantics: objects no longer referenced by the new index are
    deleted (source direction), local files not in the index are deleted
    (destination direction); empty directories are preserved
    (--create-empty-src-dirs).
"""

from __future__ import annotations

import json
import logging
import os
import stat as stat_mod
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from volsync_tpu_torch import resolve_device
from volsync_tpu_torch.engine.backup import _read_xattrs
from volsync_tpu_torch.engine.chunker import hash_file_streaming, hash_spans
from volsync_tpu_torch.engine.restore import _apply_owner, _apply_xattrs
from volsync_tpu_torch.objstore.store import (
    NoSuchKey,
    ObjectStore,
    get_file,
    put_file,
)
from volsync_tpu_torch.obs import span
from volsync_tpu_torch.resilience import RetryPolicy

log = logging.getLogger("volsync_tpu_torch.movers.rclone")

INDEX_KEY = "index.json"  # legacy v1 single-object index (read-only)
INDEX_MANIFEST = "index/manifest.json"
INDEX_SHARDS = "index/shards"
OBJECTS = "objects"
DEFAULT_TRANSFERS = 10  # mover-rclone/active.sh:19
_BATCH_BYTES = 64 * 1024 * 1024
#: Files above this hash via the segmented streaming path instead of
#: being packed whole into a batch buffer (bounded host+device memory).
_STREAM_THRESHOLD = 256 * 1024 * 1024


class SyncError(RuntimeError):
    pass


class BucketLockedError(SyncError):
    """Another writer holds the bucket prefix's mirror lease."""


def _key(prefix: str, *parts: str) -> str:
    prefix = prefix.strip("/")
    return "/".join((prefix, *parts)) if prefix else "/".join(parts)


LOCKS = "locks"
LOCK_STALE_SECONDS = 10 * 60
LOCK_REFRESH_SECONDS = LOCK_STALE_SECONDS / 3


class _MirrorLease:
    """Writer lease over one bucket prefix.

    Two sources mirroring into one prefix would otherwise sweep each
    other's objects (each's index only references its own files). The
    protocol is the repository layer's restic-style one (see
    repo/repository.py), which needs NO compare-and-swap from the store:
    write your OWN uniquely-named lock object under ``<prefix>/locks/``,
    then scan; any other fresh lock means back off (remove your own,
    raise BucketLockedError — the Job's backoff machinery retries).
    Crashed holders go stale after LOCK_STALE_SECONDS and are swept by
    the next contender; LIVE holders re-stamp their lock every
    LOCK_REFRESH_SECONDS from a heartbeat thread, so a long mirror is
    never mistaken for a crash. Two simultaneous contenders can both
    back off (safe, retried) — never both proceed.
    """

    def __init__(self, store: ObjectStore, prefix: str):
        self.store = store
        self.prefix = prefix
        self.holder = f"{os.getpid()}-{os.urandom(4).hex()}"
        self.key = _key(prefix, LOCKS, f"{self.holder}.json")
        self._stop = None

    def _stamp(self):
        import time

        self.store.put(self.key, json.dumps(
            {"holder": self.holder, "time": time.time()}).encode())

    def _others_fresh(self) -> list:
        import time

        fresh = []
        for key in list(self.store.list(_key(self.prefix, LOCKS))):
            if key == self.key:
                continue
            try:
                held = json.loads(self.store.get(key))
            except (NoSuchKey, ValueError):
                continue
            if time.time() - held.get("time", 0) > LOCK_STALE_SECONDS:
                self.store.delete(key)  # crashed holder: sweep
            else:
                fresh.append(held.get("holder"))
        return fresh

    def __enter__(self):
        import threading

        self._stamp()
        others = self._others_fresh()
        if others:
            self.store.delete(self.key)  # back off: only our own lock
            raise BucketLockedError(
                f"{self.prefix}: mirror held by {others}")
        stop = threading.Event()
        self._stop = stop
        restamp_policy = RetryPolicy.from_env(
            "rclone.lease_restamp", max_attempts=2, base_delay=0.05,
            max_delay=0.5, deadline=LOCK_REFRESH_SECONDS)

        def heartbeat():
            while not stop.wait(LOCK_REFRESH_SECONDS):
                try:
                    restamp_policy.call(self._stamp)
                except Exception as ex:  # noqa: BLE001 — log, don't
                    # swallow silently; keep mirroring (staleness only
                    # bites after LOCK_STALE_SECONDS of failed beats)
                    log.debug("mirror lease re-stamp failed "
                              "(retrying next beat): %s", ex)
        threading.Thread(target=heartbeat, daemon=True,
                         name="mirror-lease").start()
        return self

    def __exit__(self, *exc):
        if self._stop is not None:
            self._stop.set()
        self.store.delete(self.key)  # only ever our own lock object


def _safe_rel(rel: str) -> bool:
    """Remote index relpaths are untrusted input: reject anything that
    could escape the volume root (absolute paths, '..', empty segments) —
    a corrupted or hostile index must not be able to write, chmod, or
    symlink outside the mount."""
    if not rel or rel.startswith("/"):
        return False
    return not any(p in ("", ".", "..") for p in rel.split("/"))


def _validated_entries(entries: dict) -> dict:
    bad = [r for r in entries if not _safe_rel(r)]
    if bad:
        raise SyncError(f"index contains unsafe paths: {bad[:3]}")
    return entries


def _owner_xattrs(st, p) -> dict:
    """uid/gid + xattrs for the metadata index — the reference rclone
    mover's `getfacl -R` dump analogue (active.sh:24), which records
    owner and ACLs; ACLs travel inside system.posix_acl_* xattrs.
    ``xattrs`` is ALWAYS present (possibly {}) in this index format:
    removing the last xattr at the source must strip it at the
    destination too (pre-format indexes are recognized by the absent
    uid key and left alone)."""
    return {"uid": st.st_uid, "gid": st.st_gid,
            "xattrs": _read_xattrs(p)}


def scan_tree(root: Path, *, collect_meta: bool = True) -> dict[str, dict]:
    """Walk a volume -> {relpath: entry} with file metadata (no digests
    yet). Sockets/devices are skipped, as the reference movers do.
    ``collect_meta=False`` skips the owner/xattr syscalls — for scans
    used only for membership/type/size (sync_down's local inventory)."""
    meta = _owner_xattrs if collect_meta else (lambda st, p: {})
    entries: dict[str, dict] = {}
    root = Path(root)
    # --one-file-system (active.sh:19). stat(), not lstat(): a
    # symlinked volume root must anchor at the walked filesystem or the
    # whole inventory reads as foreign (and a later mirror pass would
    # delete real data from the empty index).
    root_dev = root.stat().st_dev
    for dirpath, dirnames, filenames in os.walk(root):
        d = Path(dirpath)
        rel_dir = d.relative_to(root).as_posix()
        if rel_dir != ".":
            st = d.lstat()
            if st.st_dev != root_dev:
                # mount point: record as an empty dir, don't descend
                dirnames.clear()
                filenames = []
            entries[rel_dir] = {"type": "dir", "mode": st.st_mode & 0o7777,
                                "mtime_ns": st.st_mtime_ns,
                                **meta(st, d)}
        for name in filenames:
            p = d / name
            st = p.lstat()
            if st.st_dev != root_dev:
                continue  # foreign device (bind-mounted file)
            rel = p.relative_to(root).as_posix()
            if stat_mod.S_ISLNK(st.st_mode):
                entries[rel] = {"type": "symlink",
                                "target": os.readlink(p), **meta(st, p)}
            elif stat_mod.S_ISREG(st.st_mode):
                entries[rel] = {"type": "file", "size": st.st_size,
                                "mode": st.st_mode & 0o7777,
                                "mtime_ns": st.st_mtime_ns,
                                **meta(st, p)}
        # symlinked dirs: record as symlink, don't descend
        for name in list(dirnames):
            p = d / name
            if p.is_symlink():
                dirnames.remove(name)
                entries[p.relative_to(root).as_posix()] = {
                    "type": "symlink", "target": os.readlink(p),
                    **meta(p.lstat(), p)}
    return entries


def hash_files(root: Path, rels: list[str], device=None) -> dict[str, str]:
    """Device digests for the given files. Small files pack into ~64 MiB
    host buffers (one upload + one batched SHA-256 call per buffer —
    engine/chunker.py hash_spans); large files hash segment-by-segment
    with bounded memory (hash_file_streaming). Both run on ``device``
    (None: CUDA)."""
    device = resolve_device(device)
    out: dict[str, str] = {}
    batch: list[tuple[str, bytes]] = []
    batch_bytes = 0

    def flush():
        nonlocal batch, batch_bytes
        if not batch:
            return
        # Files pack at 4 KiB-aligned offsets (<=4095B zero fill each),
        # which puts every Merkle leaf on the buffer's page grid — the
        # hash_spans fused fast path (ops/segment.span_roots_device):
        # one dispatch + one [N, 8] fetch, no per-leaf gathers.
        pieces: list[bytes] = []
        spans = []
        off = 0
        for _, data in batch:
            spans.append((off, len(data)))
            pieces.append(data)
            pad = -len(data) % 4096
            if pad:
                pieces.append(bytes(pad))
            off += len(data) + pad
        buf = b"".join(pieces)
        for (rel, _), digest in zip(batch, hash_spans(buf, spans,
                                                      device=device)):
            out[rel] = digest
        batch, batch_bytes = [], 0

    for rel in rels:
        p = root / rel
        if p.stat().st_size > _STREAM_THRESHOLD:
            out[rel] = hash_file_streaming(p, device=device)
            continue
        data = p.read_bytes()
        batch.append((rel, data))
        batch_bytes += len(data)
        if batch_bytes >= _BATCH_BYTES:
            flush()
    flush()
    return out


def _shard_of(rel: str) -> str:
    """Index shard for a relpath: all entries of one DIRECTORY share a
    shard (a changed file dirties exactly its directory's shard), hashed
    into at most 256 buckets so huge flat trees still bound shard count."""
    import hashlib

    d = rel.rsplit("/", 1)[0] if "/" in rel else ""
    return hashlib.sha256(d.encode()).hexdigest()[:2]


def write_index(store: ObjectStore, prefix: str,
                entries: dict[str, dict]) -> dict:
    """Persist the index as per-directory shards + a small manifest.

    BASELINE configs[3] (100 GiB, many small files) is metadata-heavy:
    a monolithic index.json re-uploads every entry on every sync. Here
    a sync touches O(changed directories) index bytes: each shard's
    object name embeds its content hash, so unchanged shards are simply
    re-referenced by the new manifest and never re-serialized past the
    grouping pass. Returns {"shards": total, "written": uploaded}.
    """
    import hashlib

    groups: dict[str, dict[str, dict]] = {}
    for rel, e in entries.items():
        groups.setdefault(_shard_of(rel), {})[rel] = e
    try:
        old_shards = json.loads(
            store.get(_key(prefix, INDEX_MANIFEST))).get("shards", {})
    except (NoSuchKey, ValueError):
        old_shards = {}
    shards: dict[str, str] = {}
    written = 0
    for sk in sorted(groups):
        payload = json.dumps({"entries": groups[sk]},
                             sort_keys=True).encode()
        name = f"{sk}-{hashlib.sha256(payload).hexdigest()[:16]}.json"
        shards[sk] = name
        if old_shards.get(sk) != name:
            store.put(_key(prefix, INDEX_SHARDS, name), payload)
            written += 1
    # Superseded shards are GC'd ONE GENERATION LATE: a reader holding
    # the previous manifest must still find every shard it references
    # (sync_down takes no lease — the v1 single-object index gave
    # readers that atomicity for free). The manifest records the
    # previous generation's retired names; THIS sync deletes only the
    # generation before that.
    retiring = sorted(set(old_shards.values()) - set(shards.values()))
    store.put(_key(prefix, INDEX_MANIFEST), json.dumps(
        {"version": 2, "shards": shards, "retiring": retiring},
        sort_keys=True).encode())
    keep = set(shards.values()) | set(retiring)
    for key in list(store.list(_key(prefix, INDEX_SHARDS))):
        if key.rsplit("/", 1)[-1] not in keep:
            store.delete(key)
    try:
        store.delete(_key(prefix, INDEX_KEY))
    except NoSuchKey:
        pass
    return {"shards": len(shards), "written": written}


def read_index(store: ObjectStore, prefix: str) -> dict[str, dict]:
    """Merge the sharded index (v2); fall back to the legacy single
    index.json written by older syncs.

    Readers take no lease, so a sync may supersede the manifest while
    this runs. The one-generation-late GC keeps the just-read
    manifest's shards alive through one concurrent sync; if a reader
    slept through TWO syncs it restarts from the fresh manifest once
    before declaring corruption.
    """
    for attempt in (0, 1):
        try:
            manifest = json.loads(store.get(_key(prefix, INDEX_MANIFEST)))
        except NoSuchKey:
            manifest = None
        if manifest is None:
            break
        entries: dict[str, dict] = {}
        try:
            for name in manifest.get("shards", {}).values():
                payload = json.loads(
                    store.get(_key(prefix, INDEX_SHARDS, name)))
                entries.update(payload.get("entries", {}))
            return entries
        except NoSuchKey as e:
            if attempt:
                # Fresh manifest and still missing a referenced shard —
                # real corruption (or a writer violating the mirror
                # lease), not a reason to serve a partial tree.
                raise SyncError(
                    f"index shard missing from bucket: {e}") from None
            continue  # superseded mid-read: retry from the new manifest
    try:
        payload = json.loads(store.get(_key(prefix, INDEX_KEY)))
    except NoSuchKey:
        return {}
    return payload.get("entries", {})


def sync_up(root: Path, store: ObjectStore, prefix: str, *,
            transfers: int = DEFAULT_TRANSFERS, device=None) -> dict:
    """Volume -> bucket mirror (DIRECTION=source, active.sh:23-27).

    Checksum compare: a file uploads only if its digest object is absent;
    unreferenced objects are deleted afterwards (mirror semantics).
    Digests are computed on ``device`` (None: CUDA, raising without it,
    before the volume is read).
    """
    device = resolve_device(device)
    root = Path(root)
    with span("rclone.scan"):
        entries = scan_tree(root)
    files = [r for r, e in entries.items() if e["type"] == "file"]
    with span("rclone.hash"):
        digests = hash_files(root, files, device)
    for rel in files:
        entries[rel]["digest"] = digests[rel]

    with _MirrorLease(store, prefix):
        return _mirror_up(root, store, prefix, entries, files, digests,
                          transfers)


def _mirror_up(root, store, prefix, entries, files, digests,
               transfers) -> dict:
    wanted = set(digests.values())
    have = {k.rsplit("/", 1)[-1] for k in store.list(_key(prefix, OBJECTS))}
    to_upload = wanted - have
    uploaded = 0
    with ThreadPoolExecutor(max_workers=transfers) as pool:
        futs = []
        seen: set[str] = set()
        for rel in files:
            d = digests[rel]
            if d in to_upload and d not in seen:
                seen.add(d)
                futs.append(pool.submit(
                    _put, store, _key(prefix, OBJECTS, d), root / rel))
        for f in futs:
            f.result()
        uploaded = len(futs)

    with span("rclone.index.write"):
        idx_stats = write_index(store, prefix, entries)

    # mirror: drop objects the new index no longer references
    deleted = 0
    for key in list(store.list(_key(prefix, OBJECTS))):
        if key.rsplit("/", 1)[-1] not in wanted:
            store.delete(key)
            deleted += 1
    return {"files": len(files), "uploaded": uploaded,
            "deduped": len(files) - uploaded, "deleted_objects": deleted,
            "index_shards": idx_stats["shards"],
            "index_shards_written": idx_stats["written"],
            "bytes": sum(e["size"] for e in entries.values()
                         if e["type"] == "file")}


def _put(store, key: str, src) -> None:
    with span("rclone.put"):
        put_file(store, key, src)


def sync_down(store: ObjectStore, prefix: str, root: Path, *,
              transfers: int = DEFAULT_TRANSFERS, device=None) -> dict:
    """Bucket -> volume mirror (DIRECTION=destination, active.sh:28-33).

    Local files whose digest already matches are untouched (checksum
    compare); metadata (mode, mtime) is re-applied from the index either
    way — the setfacl --restore analogue. Extraneous local paths are
    deleted. Local digests are computed on ``device`` (None: CUDA,
    raising without it, before the volume is touched).
    """
    device = resolve_device(device)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    with span("rclone.index.read"):
        got = read_index(store, prefix)
    if not got and not store.exists(_key(prefix, INDEX_MANIFEST)) \
            and not store.exists(_key(prefix, INDEX_KEY)):
        raise SyncError(
            f"no index at {prefix!r}: nothing has been synced here")
    entries = _validated_entries(got)

    with span("rclone.scan"):
        local = scan_tree(root, collect_meta=False)
    local_files = [r for r, e in local.items() if e["type"] == "file"
                   and r in entries and entries[r]["type"] == "file"
                   and entries[r]["size"] == e["size"]]
    with span("rclone.hash"):
        local_digests = hash_files(root, local_files, device)

    # delete extraneous paths first (files, then emptied dirs bottom-up)
    deleted = 0
    for rel in sorted(local, key=len, reverse=True):
        if rel not in entries:
            p = root / rel
            if p.is_symlink() or p.is_file():
                p.unlink()
            elif p.is_dir():
                import shutil

                shutil.rmtree(p, ignore_errors=True)
            deleted += 1

    # directories (create-empty-src-dirs), shallow-first
    for rel in sorted((r for r, e in entries.items() if e["type"] == "dir"),
                      key=len):
        p = root / rel
        if p.is_symlink() or (p.exists() and not p.is_dir()):
            p.unlink()
        p.mkdir(parents=True, exist_ok=True)

    skipped = 0

    def materialize(rel: str, entry: dict):
        p = root / rel
        if p.is_symlink() or p.is_file():
            # unlink, not rmtree: rmtree silently refuses symlinks, and a
            # surviving symlink would make the write follow it (possibly
            # out of the volume) instead of replacing it
            p.unlink()
        elif p.is_dir():
            import shutil

            shutil.rmtree(p, ignore_errors=True)
        p.parent.mkdir(parents=True, exist_ok=True)
        try:
            with span("rclone.get"):
                n = get_file(store, _key(prefix, OBJECTS, entry["digest"]),
                             p)
        except NoSuchKey:
            # e.g. a concurrent source-direction mirror swept an object
            # the index we read still references — retryable sync failure,
            # not a crash
            raise SyncError(f"{rel}: object {entry['digest']} missing "
                            "from bucket") from None
        if n != entry["size"]:
            raise SyncError(f"{rel}: object size mismatch")

    with ThreadPoolExecutor(max_workers=transfers) as pool:
        futs = []
        for rel, entry in entries.items():
            if entry["type"] != "file":
                continue
            if local_digests.get(rel) == entry["digest"]:
                skipped += 1
                continue
            futs.append(pool.submit(materialize, rel, entry))
        for f in futs:
            f.result()
        fetched = len(futs)

    with span("rclone.meta"):
        _apply_meta(root, entries)
    return {"files": sum(1 for e in entries.values() if e["type"] == "file"),
            "fetched": fetched, "skipped": skipped, "deleted_local": deleted,
            "bytes": sum(e.get("size", 0) for e in entries.values()
                         if e["type"] == "file")}


def _apply_meta(root: Path, entries: dict) -> None:
    """Symlinks, then file and directory metadata from the index."""
    for rel, entry in entries.items():
        p = root / rel
        if entry["type"] == "symlink":
            if p.is_symlink() or p.exists():
                if p.is_dir() and not p.is_symlink():
                    import shutil

                    shutil.rmtree(p, ignore_errors=True)
                else:
                    p.unlink()
            p.parent.mkdir(parents=True, exist_ok=True)
            os.symlink(entry["target"], p)
            _apply_xattrs(p, entry)
            _apply_owner(p, entry)
        elif entry["type"] == "file":
            # xattrs before chmod (read-only modes block setxattr),
            # chown before chmod (chown clears suid) — the engine
            # restore's ordering; the index carries the facl-dump
            # analogue (owner + ACL xattrs)
            _apply_xattrs(p, entry)
            _apply_owner(p, entry)
            os.chmod(p, entry["mode"])
            os.utime(p, ns=(entry["mtime_ns"], entry["mtime_ns"]))
    # dir metadata last (child writes bump parent mtimes), deepest first
    for rel in sorted((r for r, e in entries.items() if e["type"] == "dir"),
                      key=len, reverse=True):
        entry = entries[rel]
        _apply_xattrs(root / rel, entry)
        _apply_owner(root / rel, entry)
        os.chmod(root / rel, entry["mode"])
        os.utime(root / rel, ns=(entry["mtime_ns"], entry["mtime_ns"]))
