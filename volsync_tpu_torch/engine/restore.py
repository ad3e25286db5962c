"""Snapshot restore (the `restic restore` equivalent).

What `/entry.sh restore` does in the reference (mover-restic/
entry.sh:203-229): select a snapshot by RESTORE_AS_OF / SELECT_PREVIOUS
(here: Repository.select_snapshot), then materialize its tree into the
target volume. Restores are idempotent: existing files matching the
snapshot entry's size+mtime_ns are skipped (mode still re-applied), and
extra files in the target can optionally be deleted (--delete semantics).

Ports ``volsync_tpu/engine/restore.py``. ``TreeRestore`` and
``restore_snapshot`` take ``device=`` (default: the repository's
device): the pipelined restore, and the serial one under
``VOLSYNC_DEVICE_VERIFY``, re-hash blobs there with the port's
``verify_blob_batch`` before any byte is written.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import numpy as np

from volsync_tpu_torch import envflags, resolve_device
from volsync_tpu_torch.repo.repository import Repository


class TreeRestore:
    def __init__(self, repo: Repository, *, workers: Optional[int] = None,
                 pipeline: Optional[bool] = None, device=None):
        """``workers`` restores that many files concurrently (default 4,
        env VOLSYNC_RESTORE_WORKERS): blob reads (store IO + decrypt)
        overlap file writes across independent files. Directory
        modes/mtimes are applied in a bottom-up pass AFTER every file
        write, so concurrent writes can't bump an already-stamped parent
        mtime.

        ``pipeline`` selects the pack-aware restore data plane
        (engine/restorepipe.py): fetches are planned per PACK, pulled
        through a shared single-flight PackCache by a bounded async
        pool, device-verified in ~64 MiB batches, and written at
        planned offsets. Default from VOLSYNC_RESTORE_PIPELINE (on);
        ``pipeline=False`` is the serial per-blob oracle the golden
        suite compares against.

        ``device`` is where blobs are re-hashed before they are written
        (default: the repository's device)."""
        self.repo = repo
        self.device = resolve_device(
            repo.device if device is None else device)
        if workers is None:
            workers = envflags.restore_workers()
        self.workers = max(1, workers)
        if pipeline is None:
            pipeline = envflags.restore_pipeline_enabled()
        self.pipelined = pipeline
        # a RestoreGroup injects its shared cache here; None means the
        # pipelined path builds a private one per run
        self.pack_cache = None
        # Device-batched blob verification (same knob as repository
        # check): per-byte re-hashing rides the page-grid kernel in
        # ~64 MiB batches, host keeps only decrypt/decompress. Batches
        # verify BEFORE their bytes are written, so corruption is
        # caught exactly as early as the host path would.
        from volsync_tpu_torch.envflags import env_bool

        self.device_verify = env_bool("VOLSYNC_DEVICE_VERIFY")
        # Sparse materialization (the rsync -S analogue,
        # mover-rsync/source.sh:54): aligned all-zero pages become
        # holes. Content-identical; VOLSYNC_SPARSE=0 restores dense
        # writes.
        self.sparse = env_bool("VOLSYNC_SPARSE", default=True)

    def run(self, snap_id: str, manifest: dict, dest,
            *, delete_extra: bool = True) -> dict:
        # Shared lock: a concurrent exclusive prune must not repack and
        # delete the packs this restore is mid-way through reading.
        # restore_snapshot() already holds the lock and calls _run_locked
        # directly (selection and walk under ONE lock, not two).
        with self.repo.lock(exclusive=False):
            return self._run_locked(snap_id, manifest, dest,
                                    delete_extra=delete_extra)

    def _run_locked(self, snap_id: str, manifest: dict, dest,
                    *, delete_extra: bool = True) -> dict:
        dest = Path(dest)
        dest.mkdir(parents=True, exist_ok=True)
        stats = {"files": 0, "bytes": 0, "skipped": 0, "deleted": 0}
        jobs: list[tuple[dict, Path]] = []
        dirs: list[tuple[Path, dict]] = []
        links: list[tuple[dict, Path]] = []
        self._walk_tree(manifest["tree"], dest, stats, jobs, dirs, links,
                        delete_extra=delete_extra)
        if jobs:
            self._restore_files(jobs, stats)
        # Hardlinks AFTER the file pool: the link's source path is only
        # guaranteed to exist (with final content) once every file job
        # has run. Metadata is shared with the source inode, already
        # applied there.
        for entry, target in links:
            source = dest / entry["hardlink_to"]
            if target.exists() and not target.is_symlink() \
                    and os.path.samestat(target.lstat(), source.lstat()):
                stats["skipped"] += 1
                continue
            if target.is_symlink() or target.exists():
                _rmtree(target)
            os.link(source, target)
            stats["files"] += 1
        # Directory metadata last, children-first: any earlier write
        # inside a directory would overwrite its restored mtime.
        for path, entry in reversed(dirs):
            _apply_xattrs(path, entry)  # before chmod: a read-only
            _apply_owner(path, entry)   # mode would block setxattr;
            os.chmod(path, entry["mode"])  # chown clears suid -> last
            os.utime(path, ns=(entry["mtime_ns"], entry["mtime_ns"]))
        return stats

    def _walk_tree(self, tree_id: str, dirpath: Path, stats: dict,
                   jobs: list, dirs: list, links: list, *,
                   delete_extra: bool):
        """Iterative DFS (explicit stack): depth bounded by memory,
        not the interpreter recursion limit. The one ordering invariant
        — ``dirs`` holds a parent BEFORE every descendant, so the
        caller's reversed() metadata pass runs children-first — holds
        because a directory is appended when first visited and its
        subtree is pushed afterwards."""
        stack = [(tree_id, dirpath)]
        while stack:
            cur_id, cur_dir = stack.pop()
            tree = json.loads(self.repo.read_blob(cur_id))
            wanted = {e["name"] for e in tree["entries"]}
            if delete_extra:
                for child in cur_dir.iterdir():
                    if child.name not in wanted:
                        _rmtree(child)
                        stats["deleted"] += 1
            subdirs = []
            for entry in tree["entries"]:
                target = cur_dir / entry["name"]
                if entry["type"] == "dir":
                    if target.is_symlink() or (target.exists()
                                               and not target.is_dir()):
                        target.unlink()
                    target.mkdir(exist_ok=True)
                    dirs.append((target, entry))
                    subdirs.append((entry["subtree"], target))
                elif entry["type"] == "symlink":
                    if target.is_symlink() or target.exists():
                        _rmtree(target)
                    os.symlink(entry["target"], target)
                    _apply_owner(target, entry)
                    _apply_xattrs(target, entry)
                    os.utime(target,
                             ns=(entry["mtime_ns"], entry["mtime_ns"]),
                             follow_symlinks=False)
                elif entry["type"] == "special":
                    self._restore_special(entry, target, stats)
                elif entry["type"] == "file":
                    if entry.get("hardlink_to"):
                        links.append((entry, target))
                    else:
                        jobs.append((entry, target))
            # reversed: the LIFO pop then visits subtrees in entry
            # order, matching the recursive walk
            stack.extend(reversed(subdirs))

    def _restore_special(self, entry: dict, target: Path, stats: dict):
        """FIFOs/sockets/device nodes (rsync -D analogue). Device nodes
        need CAP_MKNOD — without it the node is skipped, the rest of
        the restore proceeds (the reference's mover logs and continues
        the same way)."""
        import stat as stat_mod

        fmt = entry["fmt"]
        mode = entry["mode"]
        if target.is_symlink() or target.exists():
            st = target.lstat()
            if (stat_mod.S_IFMT(st.st_mode) == fmt
                    and st.st_rdev == entry.get("rdev", 0)):
                _apply_xattrs(target, entry)
                _apply_owner(target, entry)
                os.chmod(target, mode)
                os.utime(target,
                         ns=(entry["mtime_ns"], entry["mtime_ns"]))
                stats["skipped"] += 1
                return
            _rmtree(target)
        if stat_mod.S_ISFIFO(fmt):
            os.mkfifo(target, mode)
        else:
            try:
                os.mknod(target, fmt | mode, entry.get("rdev", 0))
            except PermissionError:
                # device/socket nodes need CAP_MKNOD; degrade like the
                # reference mover outside privileged pods. Real IO
                # errors (EROFS/ENOSPC) still raise.
                stats["skipped"] += 1
                return
        _apply_owner(target, entry)
        _apply_xattrs(target, entry)
        os.chmod(target, mode)
        os.utime(target, ns=(entry["mtime_ns"], entry["mtime_ns"]))
        stats["files"] += 1

    def _restore_files(self, jobs: list, stats: dict) -> None:
        """Restore every (entry, target) file job. Pipelined mode
        (VOLSYNC_RESTORE_PIPELINE, default on) plans pack-granular
        fetches and device-verifies in batches
        (engine/restorepipe.py); the serial fallback reads blob by
        blob under the per-file worker pool — the golden oracle."""
        if self.pipelined:
            from volsync_tpu_torch.engine.restorepipe import (
                restore_files_pipelined,
            )

            restore_files_pipelined(self, jobs, stats)
            return
        if self.workers > 1 and len(jobs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(self.workers) as pool:
                results = list(pool.map(
                    lambda j: self._restore_file(*j), jobs))
        else:
            results = [self._restore_file(*j) for j in jobs]
        for key, nbytes in results:
            stats[key] += 1
            stats["bytes"] += nbytes

    def _skip_unchanged(self, entry: dict, target: Path) -> bool:
        """The unchanged-file heuristic (size+mtime_ns, same keys
        backup trusts). Skipped files still get owner/mode/xattrs
        re-applied: those drift without touching mtime (they update
        only ctime) — xattrs first (a read-only final mode would block
        setxattr for unprivileged restores), chown before chmod (chown
        clears setuid bits)."""
        if (target.is_file() and not target.is_symlink()
                and target.stat().st_size == entry["size"]
                and target.stat().st_mtime_ns == entry["mtime_ns"]):
            _apply_xattrs(target, entry)
            _apply_owner(target, entry)
            os.chmod(target, entry["mode"])
            return True
        return False

    def _clear_target(self, target: Path) -> None:
        """Make ``target`` writable as a fresh regular file."""
        if target.is_symlink() or target.is_dir():
            _rmtree(target)
        elif target.exists():
            st = target.lstat()
            import stat as stat_mod

            if not stat_mod.S_ISREG(st.st_mode):
                # A special occupies the path: opening it "wb" would
                # block on a reader-less FIFO or write INTO a device
                # node — remove it first.
                target.unlink()
            elif st.st_nlink > 1:
                # Break a pre-existing hardlink before writing: an
                # in-place open("wb") would write through the SHARED
                # inode and corrupt the other linked path (and race
                # against its own restore job under the worker pool).
                target.unlink()

    def _finalize_file(self, entry: dict, target: Path) -> None:
        """Post-content metadata stamp, shared by both restore paths:
        xattrs before chmod (read-only modes), chown before chmod
        (chown clears suid), mtime last."""
        _apply_xattrs(target, entry)
        _apply_owner(target, entry)
        os.chmod(target, entry["mode"])
        os.utime(target, ns=(entry["mtime_ns"], entry["mtime_ns"]))

    def _restore_file(self, entry: dict, target: Path) -> tuple[str, int]:
        if self._skip_unchanged(entry, target):
            return "skipped", 0
        self._clear_target(target)
        write = _write_sparse if self.sparse else (
            lambda f_, d: f_.write(d))
        with open(target, "wb") as f:
            if self.device_verify:
                self._write_device_verified(f, entry["content"], write)
            else:
                for blob_id in entry["content"]:
                    write(f, self.repo.read_blob(blob_id))
            if self.sparse:
                # materialize a trailing hole (seek alone doesn't extend)
                f.truncate(f.tell())
        self._finalize_file(entry, target)
        return "files", entry["size"]

    _VERIFY_BATCH = 64 * 1024 * 1024

    def _write_device_verified(self, f, content: list, write):
        """Raw blob reads in ~64 MiB groups, ONE device dispatch
        re-derives the group's blob ids, bytes hit the file only after
        their group verifies (engine/chunker.verify_blob_batch);
        ``write(f, data)`` is the caller's (possibly sparse) writer. The
        port times the verify and the writes as the pipelined path's
        ``restore.verify`` and ``restore.write`` spans."""
        from volsync_tpu_torch.engine.chunker import verify_blob_batch
        from volsync_tpu_torch.obs import span
        from volsync_tpu_torch.repo import crypto

        group: list[tuple[str, bytes]] = []
        gbytes = 0

        def flush():
            nonlocal group, gbytes
            with span("restore.verify"):
                bad = verify_blob_batch(group, device=self.device)
            if bad:
                raise crypto.IntegrityError(
                    f"restore: blob {bad[0]} content hash mismatch")
            with span("restore.write"):
                for _, data in group:
                    write(f, data)
            group, gbytes = [], 0

        for blob_id in content:
            data = self.repo.read_blob_raw(blob_id)
            group.append((blob_id, data))
            gbytes += len(data)
            if gbytes >= self._VERIFY_BATCH:
                flush()
        flush()


def _apply_owner(path, entry: dict) -> None:
    """uid/gid (rsync -o -g analogue). Backup records them on EVERY
    entry (root:root drift must converge too); an ABSENT key means a
    pre-format snapshot — unknown owner, leave the destination alone.
    Unprivileged restores degrade silently — chown needs CAP_CHOWN —
    matching the reference mover's behavior outside privileged pods."""
    if "uid" not in entry:
        return
    try:
        os.chown(path, entry["uid"], entry["gid"], follow_symlinks=False)
    except OSError:
        pass


def _apply_xattrs(path, entry: dict) -> None:
    """Restore recorded extended attributes (rsync -A analogue);
    follow_symlinks=False throughout. Namespaces the filesystem rejects
    (e.g. user.* on symlinks) are skipped — fidelity degrades to what
    the destination supports, as the reference movers' setfacl
    --restore does.

    Drifted extras are removed ONLY when the entry actually recorded
    xattrs: backup encodes the key only-when-present, so an absent key
    is indistinguishable from a pre-xattr-format snapshot — stripping
    on absence would destroy every destination xattr when restoring an
    older snapshot."""
    import base64

    if "xattrs" not in entry:
        return
    want = entry["xattrs"]
    try:
        have = os.listxattr(path, follow_symlinks=False)
    except OSError:
        return
    for n in have:
        if n not in want:
            try:
                os.removexattr(path, n, follow_symlinks=False)
            except OSError:
                pass
    for n, v in want.items():
        try:
            os.setxattr(path, n, base64.b64decode(v),
                        follow_symlinks=False)
        except OSError:
            pass


_ZERO_PAGE = bytes(4096)


def _write_sparse(f, data) -> None:
    """rsync -S analogue: aligned runs of all-zero 4 KiB pages become
    seeks (holes) instead of writes — content identical, allocation
    not. Accepts any buffer (the zero-copy restore pipeline hands
    pack-slice memoryviews straight through); the zero-run scan is
    numpy so no ``bytes`` materialization happens here.

    Hole semantics are pinned to the historical writer: data with no
    4096-zero-byte RUN anywhere writes densely in one call; wholly-zero
    data seeks its full length (including a partial tail); otherwise
    page-ALIGNED all-zero pages seek and everything else (partial tail
    included, even when zero) writes."""
    view = memoryview(data).cast("B")
    n = len(view)
    if n == 0:
        f.write(view)
        return
    arr = np.frombuffer(view, np.uint8)
    nz = np.flatnonzero(arr)
    if nz.size == 0:
        if n < 4096:  # no zero page exists -> the dense short-circuit
            f.write(view)
        else:
            f.seek(n, os.SEEK_CUR)
        return
    gaps = np.diff(nz) - 1
    longest = max(int(nz[0]), int(n - 1 - nz[-1]),
                  int(gaps.max()) if gaps.size else 0)
    if longest < 4096:
        f.write(view)
        return
    full = n // 4096
    zero_pages = np.logical_not(
        arr[:full * 4096].reshape(full, 4096).any(axis=1))
    bounds = np.flatnonzero(np.diff(zero_pages)) + 1
    starts = np.concatenate(([0], bounds))
    ends = np.concatenate((bounds, [full]))
    for s, e in zip(starts, ends):
        if zero_pages[s]:
            f.seek((e - s) * 4096, os.SEEK_CUR)
        else:
            f.write(view[s * 4096:e * 4096])
    if full * 4096 < n:
        f.write(view[full * 4096:])


def _rmtree(path: Path):
    """Depth-safe recursive delete. Explicit stack rather than
    shutil.rmtree: the walkers' any-depth guarantee must hold for
    delete_extra too, on every supported interpreter (shutil.rmtree
    recurses per directory level before CPython 3.12)."""
    if path.is_dir() and not path.is_symlink():
        stack = [(path, False)]
        while stack:
            d, emptied = stack.pop()
            if emptied:
                try:
                    d.rmdir()
                except OSError:
                    pass
                continue
            stack.append((d, True))
            try:
                entries = list(os.scandir(d))
            except OSError:
                continue
            for e in entries:
                try:
                    if e.is_dir(follow_symlinks=False):
                        stack.append((Path(e.path), False))
                    else:
                        os.unlink(e.path)
                except OSError:
                    pass  # best-effort, like rmtree(ignore_errors=True)
    else:
        # symlinks, regular files, AND specials (FIFO/socket/device —
        # is_file() is False for those; rmtree would leave them behind)
        path.unlink(missing_ok=True)


def restore_snapshot(repo: Repository, dest, *,
                     restore_as_of=None, previous: int = 0,
                     delete_extra: bool = True,
                     device=None) -> Optional[dict]:
    """Select + restore in one call; returns stats or None if no snapshot
    matches the selectors.

    Selection happens under the same shared lock as the tree walk (shared
    locks nest), and the index is re-read once locked — otherwise a prune
    between select and walk could delete the chosen snapshot's packs and
    the restore would die mid-way with delete_extra damage already done.
    ``device`` is the verify device (default: the repository's).
    """
    tr = TreeRestore(repo, device=device)
    with repo.lock(exclusive=False):
        # select (a listing) before the index load: the index then holds
        # the selected snapshot's tree (a writer publishes its index
        # delta before its snapshot)
        selected = repo.select_snapshot(restore_as_of=restore_as_of,
                                        previous=previous)
        if selected is None:
            return None
        repo.load_index()
        snap_id, manifest = selected
        return tr._run_locked(snap_id, manifest, dest,
                              delete_extra=delete_extra)
