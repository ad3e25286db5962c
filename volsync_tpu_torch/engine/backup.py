"""Tree backup into a dedup repository (the `restic backup` equivalent).

What `/entry.sh backup` achieves in the reference (mover-restic/
entry.sh:58-72) — walk the volume, chunk file contents, dedup blobs by
content hash, store packs/index, record a snapshot — with the chunk+hash
inner loop on the TPU (engine/chunker.py) instead of inside a wrapped
binary. Unchanged-file detection against the parent snapshot (size +
mtime_ns, restic's heuristic) skips re-reading stable data.

Ports ``volsync_tpu/engine/backup.py``. ``TreeBackup`` takes ``device=``
(default: its repository's device) and by default hashes with the
port's ``DeviceChunkHasher`` there; snapshots are bit-identical to the
reference's for the same tree and chunker parameters, under each of
the protocols ``"cdc"``, ``"full"`` and ``"auto"`` (the cost-model
planner of ``engine/protoplan.py``, reached through
``movers/common.plan_protocol`` as in the reference).
"""

from __future__ import annotations

import json
import os
import stat as stat_mod
from pathlib import Path
from typing import Optional

from volsync_tpu_torch import envflags, resolve_device
from volsync_tpu_torch.engine.chunker import (
    DeviceChunkHasher,
    params_from_config,
    stream_chunk_batches,
)
from volsync_tpu_torch.repo import blobid
from volsync_tpu_torch.repo.repository import (
    BLOB_DATA,
    BLOB_TREE,
    BackupStats,
    Repository,
)


def _tree_id(tree_json: bytes) -> str:
    return blobid.blob_id(tree_json)


def _read_xattrs(path) -> dict:
    """Extended attributes (incl. POSIX ACLs, which live in
    system.posix_acl_*) as {name: base64}; the reference's rsync -A /
    rclone getfacl round-trip analogue. Filesystems without xattr
    support contribute nothing."""
    import base64

    try:
        names = os.listxattr(path, follow_symlinks=False)
    except OSError:
        return {}
    out = {}
    for n in sorted(names):
        try:
            out[n] = base64.b64encode(
                os.getxattr(path, n, follow_symlinks=False)).decode()
        except OSError:
            continue
    return out


def _load_parent_files(repo: Repository, parent_tree: str,
                       prefix: str = "") -> dict:
    """Flatten the parent snapshot's tree into {relpath: file entry}.

    Iterative (explicit stack): directory depth is bounded by memory,
    not the interpreter's recursion limit — a legal-but-deep volume
    (the reference's engines stream arbitrary depth) must not crash
    the walk."""
    out = {}
    stack = [(parent_tree, prefix)]
    while stack:
        tree_id, pfx = stack.pop()
        tree = json.loads(repo.read_blob(tree_id))
        for entry in tree["entries"]:
            path = f"{pfx}{entry['name']}"
            if entry["type"] == "file":
                # Hardlink-secondary entries carry no content of their
                # own; offering them for unchanged-file dedup would
                # match a now-unlinked file (nlink 2->1 leaves mtime
                # untouched) and resolve it to empty content.
                if "hardlink_to" not in entry:
                    out[path] = entry
            elif entry["type"] == "dir":
                stack.append((entry["subtree"], path + "/"))
    return out


class TreeBackup:
    def __init__(self, repo: Repository, *, skip_if_empty: bool = True,
                 hasher=None, workers: Optional[int] = None,
                 protocol: str = "cdc", device=None):
        """``hasher`` swaps the chunk+hash engine: single-chip
        DeviceChunkHasher (default) or the mesh-sharded
        parallel.sharded_chunker.MeshChunkHasher — both produce
        bit-identical chunks/ids, so snapshots are interchangeable.

        ``protocol`` selects how file CONTENT is stored: ``"cdc"``
        (default, the restic-equivalent content-defined chunking),
        ``"full"`` (whole-file blobs — no sub-file dedup, but no chunk
        scan either; files above envflags.plan_full_blob_cap() still
        chunk, the planner's ``size_cap`` rule), or ``"auto"`` (the
        cost-model planner prices full vs cdc per file against the
        "restic" SyncStatsBook — engine/protoplan.py). All three
        produce valid interchangeable snapshots; they differ only in
        blob granularity, i.e. dedup ratio vs scan cost.

        ``workers`` hashes that many FILES concurrently (default 4, env
        VOLSYNC_BACKUP_WORKERS). Files are independent streams, so their
        per-segment result round-trips overlap while the device
        serializes their kernels — the same concurrency the reference
        gets from parallel mover pods (MaxConcurrentReconciles), here
        inside one backup. Snapshot bits are identical for any worker
        count: tree assembly is deterministic and the repository dedups
        concurrent identical blobs under its lock.

        ``device`` is where the default hasher runs (default: the
        repository's device; CUDA unless the repository was opened
        elsewhere).
        """
        if protocol not in ("cdc", "full", "auto"):
            raise ValueError(f"unknown backup protocol {protocol!r}")
        self.repo = repo
        self.device = resolve_device(
            repo.device if device is None else device)
        want = params_from_config(repo.chunker_params)
        self.hasher = hasher or DeviceChunkHasher(want, device=self.device)
        self.params = self.hasher.params
        # An injected hasher chunking under different parameters would
        # still produce a valid-looking snapshot — but one that shares no
        # boundaries with prior ones, silently killing dedup. Refuse.
        if self.params != want:
            raise ValueError(
                f"hasher params {self.params} != repository chunker "
                f"params {want}")
        self.skip_if_empty = skip_if_empty
        if workers is None:
            workers = envflags.backup_workers()
        # A hasher that doesn't declare thread-safety (the mesh-sharded
        # engine: collective enqueue order must match across devices)
        # forces serial file hashing regardless of the knob.
        if not getattr(self.hasher, "thread_safe", False):
            workers = 1
        self.workers = max(1, workers)
        self.protocol = protocol

    def run(self, root, *, hostname: str = "volsync",
            tags: Optional[list] = None,
            parent: Optional[str] = None) -> tuple[Optional[str], BackupStats]:
        """Backup ``root`` -> (snapshot id, stats). Returns (None, stats)
        for an empty volume when skip_if_empty (the reference's
        "directory is empty, skipping backup" — entry.sh:44-50).

        Holds a shared repository lock so a concurrent prune (exclusive)
        can never sweep this backup's freshly written packs.
        """
        with self.repo.lock(exclusive=False):
            # Re-read the index now that the lock is held: entries loaded
            # before it could reference packs a prune swept in between,
            # and dedup'ing against those would produce a snapshot whose
            # blobs no longer exist (restic reloads after locking too).
            # The snapshots are listed before the load, so the index
            # holds the parent's tree.
            snaps = self.repo._list_then_load()
            return self._run_locked(root, hostname=hostname, tags=tags,
                                    parent=parent, snaps=snaps)

    def _run_locked(self, root, *, hostname, tags, parent, snaps):
        root = Path(root)
        stats = BackupStats()
        if parent is None and snaps:
            parent = snaps[-1][0]
        parent_files = {}
        parent_manifest = None
        if parent:
            parent_manifest = dict(snaps).get(parent)
            if parent_manifest:
                parent_files = _load_parent_files(
                    self.repo, parent_manifest["tree"])
        if self.skip_if_empty and not any(root.iterdir()):
            return None, stats
        # Single-threaded walk (stats + unchanged-file dedup decisions),
        # concurrent per-file hashing, deterministic tree assembly.
        jobs: list[tuple[Path, str, object]] = []
        inode_first: dict = {}  # (st_dev, st_ino) -> rel of first sight
        skeleton = self._walk_dir(root, "", parent_files, stats, jobs,
                                  inode_first)
        contents: dict = {}
        if jobs:
            if self.workers > 1 and len(jobs) > 1:
                from concurrent.futures import ThreadPoolExecutor

                from volsync_tpu_torch.obs import carry_context

                # carry_context: worker-thread spans (repo store spans)
                # keep the caller's tenant/trace context instead of
                # starting orphaned.
                with ThreadPoolExecutor(
                        self.workers,
                        thread_name_prefix="backup-hash") as pool:
                    for rel, resolved in pool.map(
                            carry_context(
                                lambda j: self._hash_file(*j, stats)),
                            jobs):
                        contents[rel] = resolved
            else:
                for j in jobs:
                    rel, resolved = self._hash_file(*j, stats)
                    contents[rel] = resolved
        tree_id = self._assemble_tree(skeleton, contents, stats)
        manifest = {
            "hostname": hostname,
            "paths": [str(root)],
            "tags": tags or [],
            "tree": tree_id,
            "parent": parent,
            "stats": stats.as_dict(),
        }
        # Durability order matters (restic's invariant): packs and index
        # deltas must hit the store BEFORE the snapshot that references
        # them becomes visible, or a crash in between leaves a snapshot
        # pointing at unwritten blobs that poisons every later backup.
        self.repo.flush()
        snap_id = self.repo.save_snapshot(manifest)
        return snap_id, stats

    # -- internals ----------------------------------------------------------

    def _walk_dir(self, dirpath: Path, rel: str, parent_files: dict,
                  stats: BackupStats, jobs: list,
                  inode_first: dict) -> dict:
        """Single-threaded walk -> a skeleton tree. File entries that
        need hashing carry content=None and append a job; unchanged
        files resolve to the parent's content list immediately. All
        stats counted here (except per-blob counts, which the
        repository updates under its own lock) so worker threads never
        touch the shared counters.

        Iterative (one child-iterator frame per open directory):
        pushing a frame and resuming the parent's iterator afterwards
        reproduces the recursion's exact in-order DFS — inode_first's
        "first sighting" stays deterministic — while directory depth
        is bounded by memory, not the interpreter recursion limit
        (the reference's engines stream arbitrary depth)."""
        root_skel = {"entries": []}

        def children(d: Path):
            return iter(sorted(d.iterdir(), key=lambda p: p.name))

        stack = [(children(dirpath), rel, root_skel["entries"])]
        while stack:
            it, cur_rel, entries = stack[-1]
            descended = False
            for child in it:
                st = child.lstat()
                meta = {"name": child.name, "mode": st.st_mode & 0o7777,
                        "mtime_ns": st.st_mtime_ns}
                xs = _read_xattrs(child)
                if xs:
                    # only-when-present: tree ids of xattr-less trees
                    # stay identical to pre-xattr snapshots (parent
                    # dedup keeps working across the format addition)
                    meta["xattrs"] = xs
                # owner/group (rsync -o -g, part of the reference's -a;
                # mover-rsync/source.sh:54). Recorded unconditionally:
                # root:root must be restorable too (ownership drift on
                # a root-owned file has to converge back), and restore
                # treats an ABSENT key — a pre-format snapshot — as
                # "unknown, leave the destination's owner alone".
                meta["uid"] = st.st_uid
                meta["gid"] = st.st_gid
                if stat_mod.S_ISLNK(st.st_mode):
                    entries.append({**meta, "type": "symlink",
                                    "target": os.readlink(child)})
                elif stat_mod.S_ISDIR(st.st_mode):
                    sub = {"entries": []}
                    entries.append({**meta, "type": "dir",
                                    "skeleton": sub})
                    stack.append((children(child),
                                  f"{cur_rel}{child.name}/",
                                  sub["entries"]))
                    descended = True
                    break
                elif stat_mod.S_ISREG(st.st_mode):
                    self._walk_file(child, f"{cur_rel}{child.name}",
                                    st, meta, entries, parent_files,
                                    stats, jobs, inode_first)
                elif stat_mod.S_ISFIFO(st.st_mode) or stat_mod.S_ISSOCK(
                        st.st_mode) or stat_mod.S_ISBLK(st.st_mode) \
                        or stat_mod.S_ISCHR(st.st_mode):
                    # specials (rsync -D, part of the reference's -a):
                    # FIFOs and sockets recreate from the mode; device
                    # nodes also carry st_rdev. Restore degrades
                    # gracefully without CAP_MKNOD (devices need it;
                    # FIFOs/sockets don't).
                    special = {**meta, "type": "special",
                               "fmt": stat_mod.S_IFMT(st.st_mode)}
                    if stat_mod.S_ISBLK(st.st_mode) or stat_mod.S_ISCHR(
                            st.st_mode):
                        special["rdev"] = st.st_rdev
                    entries.append(special)
            if not descended:
                stack.pop()
        return root_skel

    def _walk_file(self, child: Path, frel: str, st, meta: dict,
                   entries: list, parent_files: dict, stats: BackupStats,
                   jobs: list, inode_first: dict) -> None:
        """Regular-file walk step (shared by every _walk_dir frame)."""
        stats.files += 1
        # Hardlink preservation (reference: rsync -H in
        # mover-rsync/source.sh:54): later sightings of a
        # multiply-linked inode record a link to the FIRST sighting's
        # path (deterministic — the walk is sorted and
        # single-threaded) instead of re-hashing content.
        if st.st_nlink > 1:
            ino = (st.st_dev, st.st_ino)
            first = inode_first.get(ino)
            if first is not None:
                entries.append({**meta, "type": "file",
                                "size": st.st_size,
                                "hardlink_to": first,
                                "content": [], "rel": frel})
                return
            inode_first[ino] = frel
        stats.bytes_scanned += st.st_size
        prev = parent_files.get(frel)
        # One vectorized dedup query covers the whole previous content
        # list (vs a lock/probe round-trip per blob) — unchanged-file
        # checks on a warm repo are the dominant query source.
        if (prev is not None and prev["size"] == st.st_size
                and prev["mtime_ns"] == st.st_mtime_ns
                and (not prev["content"]
                     or bool(self.repo.has_blobs(prev["content"]).all()))):
            stats.blobs_dedup += len(prev["content"])
            stats.bytes_dedup += st.st_size
            content = list(prev["content"])
        elif st.st_size == 0:
            content = []
        else:
            content = None  # resolved by _hash_file
            jobs.append((child, frel, st))
        entries.append({**meta, "type": "file", "size": st.st_size,
                        "content": content, "rel": frel})

    def _assemble_tree(self, skeleton: dict, contents: dict,
                       stats: BackupStats) -> str:
        """Deterministic bottom-up tree-blob construction from the walk
        skeleton + hashed file contents (independent of hashing order,
        so snapshots are bit-identical for any worker count). Iterative
        post-order — children's tree blobs are written before the
        parent serializes references to them, at any depth."""
        done: dict = {}  # id(skeleton node) -> tree id
        stack = [(skeleton, False)]
        while stack:
            node, ready = stack.pop()
            if not ready:
                stack.append((node, True))
                for e in node["entries"]:
                    if e.get("skeleton") is not None:
                        stack.append((e["skeleton"], False))
                continue
            entries = []
            for e in node["entries"]:
                if e.get("skeleton") is not None:
                    sub = done.pop(id(e["skeleton"]))
                    e = {k: v for k, v in e.items() if k != "skeleton"}
                    e["subtree"] = sub
                elif e.get("type") == "file":
                    e = dict(e)
                    rel = e.pop("rel")
                    if e["content"] is None:
                        content, size, mtime_ns = contents[rel]
                        # Metadata observed AT read time, not walk
                        # time: a file rewritten between the walk's
                        # lstat and the worker's read must not pair new
                        # content with stale size/mtime (restore's
                        # unchanged-skip heuristic keys on them).
                        e["content"] = content
                        e["size"] = size
                        e["mtime_ns"] = mtime_ns
                entries.append(e)
            tree_json = json.dumps({"entries": entries},
                                   sort_keys=True).encode()
            tid = _tree_id(tree_json)
            self.repo.add_blob(BLOB_TREE, tid, tree_json, stats)
            done[id(node)] = tid
        return done[id(skeleton)]

    def _hash_file(self, path: Path, rel: str, st,
                   stats: BackupStats) -> tuple[str, tuple]:
        """Worker body: chunk+hash one file, store its blobs. Returns
        (rel, (content, size, mtime_ns)) where size is the byte count
        actually hashed and mtime_ns a post-read lstat — the entry must
        describe the content that was stored, not the walk-time stat.
        Per-blob stats are updated by the repository under its lock;
        everything else was counted in the walk."""
        if st.st_size <= self.params.min_size or self._wants_full(st.st_size):
            data = path.read_bytes()
            digest = blobid.blob_id(data)
            self.repo.add_blob(BLOB_DATA, digest, data, stats)
            content = [digest]
            hashed = len(data)
        else:
            # Large files stream through the native readahead reader
            # when available (native/volio.cpp): disk IO for segment N+1
            # overlaps the device hashing of segment N (open() fallback).
            content = []
            hashed = 0
            reader_cm = self._open_stream(path)
            with reader_cm as reader:
                for batch in stream_chunk_batches(reader.read, self.params,
                                                  hasher=self.hasher):
                    # one batched dedup query + one lock acquisition
                    # per device segment, not per chunk
                    self.repo.add_blobs(
                        BLOB_DATA,
                        [(digest, chunk) for chunk, digest in batch],
                        stats)
                    for chunk, digest in batch:
                        content.append(digest)
                        hashed += len(chunk)
        try:
            mtime_ns = path.lstat().st_mtime_ns
        except OSError:  # deleted mid-backup: keep the walk-time stamp
            mtime_ns = st.st_mtime_ns
        return rel, (content, hashed, mtime_ns)

    def _wants_full(self, size: int) -> bool:
        """Whole-file blob storage for this file? Pinned ``"full"`` says
        yes up to the blob cap; ``"auto"`` asks the planner (which
        applies the same cap as its ``size_cap`` rule); ``"cdc"`` never.
        """
        if self.protocol == "cdc":
            return False
        cap = envflags.plan_full_blob_cap()
        if self.protocol == "auto":
            from volsync_tpu_torch.movers import common

            proto = common.plan_protocol(
                "restic", size, candidates=("full", "cdc"),
                full_cap=cap).protocol
        else:
            proto = self.protocol
        return proto == "full" and size <= cap

    @staticmethod
    def _open_stream(path: Path):
        from volsync_tpu_torch.engine.chunker import _open_readahead

        return _open_readahead(path, 32 * 1024 * 1024)
