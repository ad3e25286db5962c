"""Traffic kind ``restic_sync``: ReplicationSource syncs of one PVC through
the port's restic mover entry, back to back, to the loopback S3 remote.

Each sync is one Job: ``restic_entrypoint`` in a ``JobContext`` with the
deployment's environment (``DIRECTION=backup``, the repository password,
``RESTIC_REPOSITORY=s3:http://127.0.0.1:<port>/<bucket>`` and its keys),
and each is a first backup of the volume into a fresh bucket. Set-up
backs up the mix's small warm volume once, so that the window compiles
nothing. The window starts syncs until ``--seconds`` have passed; the
last one runs to its end.

After the window the reference judges a sample of the syncs, drawn from
the seed with the last one always in it: each file's content list in the
snapshot's tree against plain FastCDC cuts and Merkle ids of the volume's
bytes, every referenced blob in the index exactly once, and every blob's
stored bytes read back equal to their source span.
"""

from __future__ import annotations

import os
import stat
import threading
import time
from pathlib import Path

import numpy as np

from portbench import gen
from portbench.reference import cdc, merkle
from portbench.reference.restic_repo import FormatError, RepoReader
from portbench.remote import Remote

GIB = 1 << 30


class Load:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cell.config
        self.mix = ctx.cell.traffic
        self.chunker = cdc.Chunker.from_config(self.cfg["chunker"])
        self.syncs: list[dict] = []
        self.remote = None
        self.window_s = None

    # -- set-up ---------------------------------------------------------

    def _job(self, bucket: str, tree: Path):
        from volsync_tpu_torch.cluster.runner import JobContext

        env = {**self.cfg["job_env"], **self.remote.env(bucket)}
        return JobContext(name=f"volsync-src-{bucket}", namespace="portbench",
                          env=env, mounts={"data": tree}, secrets={},
                          stop_event=threading.Event(),
                          device=self.ctx.device)

    def _sync(self, bucket: str, tree: Path) -> dict:
        from volsync_tpu_torch.movers.restic.entry import restic_entrypoint

        before = self.remote.usage(bucket)["bytes"]
        job = self._job(bucket, tree)
        t0 = time.perf_counter()
        rc = restic_entrypoint(job)
        wall = time.perf_counter() - t0
        return {"bucket": bucket, "rc": rc, "wall": wall,
                "added": self.remote.usage(bucket)["bytes"] - before}

    def setup(self) -> None:
        self.remote = Remote()
        self.tree = self.ctx.workdir / "pvc"
        made = gen.make_volume(self.tree, self.cfg["volume"], self.ctx.seed,
                               self.ctx.gen_device)
        self.pvc_bytes, self.files = made["bytes"], made["files"]
        # a hard link's bytes are its target's
        self.alias = {f["path"]: f["to"] for f in self.cfg["volume"]["files"]
                      if f["kind"] == "hardlink"}
        warm = self.ctx.workdir / "warm"
        gen.make_volume(warm, self.mix["warm_volume"], self.ctx.seed + 1,
                        self.ctx.gen_device)
        r = self._sync("warm", warm)
        if r["rc"]:
            raise RuntimeError(f"set-up sync failed: rc {r['rc']}")
        self.remote.drop("warm")

    # -- the window -----------------------------------------------------

    def window(self, seconds: float, mark) -> None:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with mark("sync"):
                self.syncs.append(self._sync(f"initial-{len(self.syncs)}",
                                             self.tree))
        self.window_s = time.perf_counter() - t0
        self.ctx.log("sync walls (s): " + " ".join(
            f"{r['wall']:.3f}" for r in self.syncs))

    def collect(self) -> None:
        """Every sync of the window has returned."""

    def counts(self) -> tuple[int, int]:
        return len(self.syncs), sum(1 for r in self.syncs if r["rc"])

    def end_to_end(self) -> dict:
        walls = sum(r["wall"] for r in self.syncs)
        n = len(self.syncs)
        return {"sync_gib_s": n * self.pvc_bytes / GIB / walls,
                "sync_bytes_ratio": sum(r["added"] for r in self.syncs)
                / (n * self.pvc_bytes)}

    # -- after the window -------------------------------------------------

    def release(self) -> None:
        """Each sync's repository is dropped when its Job returns."""

    def _state(self) -> dict:
        """{path: bytes} of the volume's regular files, read once."""
        return {p: np.fromfile(self.tree / p, np.uint8)
                for p in sorted(self.files)}

    def _expected(self, data: np.ndarray) -> tuple[list, list]:
        """(cuts, ids) the format asks for of one regular file."""
        n = len(data)
        if n == 0:
            return [], []
        if n <= self.chunker.min_size:
            return [(0, n)], [merkle.blob_id(data)]
        cuts = cdc.cuts(data, self.chunker, self._table)
        return cuts, [merkle.blob_id(data[o: o + m]) for o, m in cuts]

    def _tree_shape(self) -> dict:
        """{path: (type, mode, hardlink first sighting or None)} in the
        backup's walk order (sorted names, depth first)."""
        out, first = {}, {}

        def walk(d: Path, rel: str):
            for child in sorted(d.iterdir(), key=lambda p: p.name):
                st = child.lstat()
                path = rel + child.name
                mode = st.st_mode & 0o7777
                if stat.S_ISDIR(st.st_mode):
                    out[path] = ("dir", mode, None)
                    walk(child, path + "/")
                elif st.st_nlink > 1 and (st.st_dev, st.st_ino) in first:
                    out[path] = ("file", mode, first[(st.st_dev, st.st_ino)])
                else:
                    if st.st_nlink > 1:
                        first[(st.st_dev, st.st_ino)] = path
                    out[path] = ("file", mode, None)

        walk(self.tree, "")
        return out

    def layer_inputs(self) -> dict:
        """What the per-layer readers need: PVC GiB synced in the window
        and the lengths of the chunks its syncs hashed on the device (the
        files above the chunker's minimum; the host hashes smaller ones)."""
        self._table = self.chunker.gear_table()
        state = self._state()
        per_sync = [m for p in sorted(state)
                    if self.files[p] > self.chunker.min_size
                    for _, m in cdc.cuts(state[p], self.chunker, self._table)]
        return {"pvc_gib": len(self.syncs) * self.pvc_bytes / GIB,
                "chunk_lengths": per_sync * len(self.syncs),
                "added_bytes": sum(r["added"] for r in self.syncs),
                "new_data_bytes": self._new_data_bytes()}

    def _new_data_bytes(self) -> int:
        """Bytes of the data blobs that the window's syncs added to their
        repositories, from the index objects they wrote."""
        password = self.cfg["job_env"]["RESTIC_PASSWORD"]
        total = 0
        for bucket in sorted({r["bucket"] for r in self.syncs}):
            repo = RepoReader(self.remote, bucket, password)
            total += sum(row[4] for rows in repo.deltas.values()
                         for row in rows if row[1] == "data")
        return total

    def check(self) -> list[tuple[str, float, float]]:
        self._table = self.chunker.gear_table()
        rng = np.random.default_rng([self.ctx.seed & (2 ** 64 - 1), 9])
        n = len(self.syncs)
        picks = {n - 1}
        others = list(range(n - 1))
        k = min(len(others), self.mix["check_syncs"] - 1)
        picks.update(int(i) for i in rng.choice(others, size=k, replace=False))
        shape = self._tree_shape()
        wrong_files = wrong_blobs = not_once = 0
        state = self._state()
        memo: dict = {}
        password = self.cfg["job_env"]["RESTIC_PASSWORD"]
        for i in sorted(picks):
            r = self.syncs[i]
            try:
                repo = RepoReader(self.remote, r["bucket"], password)
                got = repo.tree_files(repo.snapshots()[-1]["tree"])
            except (FormatError, KeyError, IndexError, ValueError) as ex:
                self.ctx.log(f"sync {i}: snapshot unreadable: {ex!r}")
                wrong_files += len(shape)
                continue
            if set(got) != set(shape):
                self.ctx.log(f"sync {i}: paths differ: "
                             f"{sorted(set(got) ^ set(shape))[:5]}")
                wrong_files += len(set(got) ^ set(shape))
            for path, (kind, mode, link) in shape.items():
                e = got.get(path)
                if e is None:
                    continue
                ok = e.get("type") == kind and e.get("mode") == mode
                if kind == "file" and ok:
                    data = state[self.alias.get(link or path, link or path)]
                    if link:
                        ok = e.get("hardlink_to") == link \
                            and e.get("size") == len(data)
                    else:
                        if path not in memo:
                            memo[path] = self._expected(data)
                        cuts, ids = memo[path]
                        ok = e.get("size") == len(data) \
                            and e.get("content") == ids
                        for (o, m), bid in zip(cuts, ids):
                            homes = repo.index.get(bid, [])
                            if len(homes) != 1:
                                not_once += 1
                            try:
                                stored = repo.blob(bid)
                            except FormatError as ex:
                                self.ctx.log(f"sync {i}: {ex}")
                                stored = None
                            if stored != data[o: o + m].tobytes():
                                wrong_blobs += 1
                if not ok:
                    wrong_files += 1
                    if wrong_files <= 5:
                        self.ctx.log(f"sync {i}: {path} differs: {e}")
        self.checked = sorted(picks)
        return [("files_differ", wrong_files, 0),
                ("blobs_not_stored_once", not_once, 0),
                ("stored_bytes_differ", wrong_blobs, 0)]

    def close(self) -> None:
        if self.remote is not None:
            self.remote.close()
        for root in (self.ctx.workdir / "pvc", self.ctx.workdir / "warm"):
            if root.exists():
                _rmtree(root)


def _rmtree(root: Path) -> None:
    for dirpath, dirnames, filenames in os.walk(root, topdown=False):
        for f in filenames:
            os.unlink(os.path.join(dirpath, f))
        for d in dirnames:
            os.rmdir(os.path.join(dirpath, d))
    os.rmdir(root)
