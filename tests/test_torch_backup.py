"""The port's TreeBackup and TreeRestore against the JAX package's, on
the CPU.

One small tree (a file with an odd tail, its hard link, a sparse file
with a hole, an empty file, a file below min_size, nested directories)
is backed up by each package at align 4096, 64 and 1: the same root
tree id, the same data and tree blob sets, index entries with equal
(id, type, length, raw length), and a second backup that adds nothing.
Each package restores the other's snapshot byte-identical (bytes,
modes, mtimes, hard links, holes); the port's serial and pipelined
restores write the same tree; a corrupt pack is rejected before any
write; four backup workers give the one-worker snapshot; ``protocol=
"full"`` and ``"auto"`` match the reference.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from volsync_tpu.engine.backup import TreeBackup as JBackup
from volsync_tpu.engine.restore import restore_snapshot as j_restore
from volsync_tpu.objstore.store import MemObjectStore as JMem
from volsync_tpu.repo.repository import Repository as JRepo
from volsync_tpu_torch.engine.backup import TreeBackup
from volsync_tpu_torch.engine.restore import TreeRestore, restore_snapshot
from volsync_tpu_torch.objstore.store import MemObjectStore
from volsync_tpu_torch.repo import crypto
from volsync_tpu_torch.repo.repository import Repository

torch.set_num_threads(1)

ALIGNS = [4096, 64, 1]


def _chunker(align: int) -> dict:
    return {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
            "seed": 0x5EED_CDC1, "align": align}


def make_tree(root: Path, seed: int = 3) -> Path:
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True)
    (root / "tail.bin").write_bytes(rng.bytes(3 * 32768 + 12_345))
    (root / "empty").write_bytes(b"")
    with open(root / "sparse.bin", "wb") as f:
        f.write(rng.bytes(5_000))
        f.seek(145_000)
        f.write(rng.bytes(3_000))
    (root / "sub" / "deeper").mkdir(parents=True)
    os.link(root / "tail.bin", root / "sub" / "hard.bin")
    (root / "sub" / "small.txt").write_bytes(b"hello backup\n" * 40)
    (root / "sub" / "deeper" / "mid.bin").write_bytes(rng.bytes(40_000))
    os.chmod(root / "sub" / "small.txt", 0o640)
    os.utime(root / "sub" / "deeper", ns=(10**18, 10**18))
    return root


def assert_restored(src: Path, dst: Path, *, blocks: bool = False) -> None:
    """Layout, bytes, modes, mtimes and hard-link grouping equal;
    ``blocks`` also requires equal allocation (both trees restored)."""
    rels = sorted(p.relative_to(src) for p in src.rglob("*"))
    assert rels == sorted(p.relative_to(dst) for p in dst.rglob("*"))
    groups_a, groups_b = {}, {}
    for rel in rels:
        sa, sb = (src / rel).lstat(), (dst / rel).lstat()
        assert (sa.st_mode, sa.st_mtime_ns) == \
            (sb.st_mode, sb.st_mtime_ns), rel
        if (src / rel).is_file():
            assert (src / rel).read_bytes() == (dst / rel).read_bytes(), rel
            if blocks:
                assert sa.st_blocks == sb.st_blocks, rel
            groups_a.setdefault(sa.st_ino, set()).add(str(rel))
            groups_b.setdefault(sb.st_ino, set()).add(str(rel))
    assert sorted(map(sorted, groups_a.values())) == \
        sorted(map(sorted, groups_b.values()))


def _index(repo) -> set:
    return {(b, repo._entry(b).type, repo._entry(b).length,
             repo._entry(b).raw_length) for b in repo.blob_ids()}


@pytest.fixture(scope="module", params=ALIGNS,
                ids=[f"align{a}" for a in ALIGNS])
def backed_up(request, tmp_path_factory):
    """The tree, backed up once by each package at one align."""
    base = tmp_path_factory.mktemp(f"align{request.param}")
    src = make_tree(base / "src")
    jstore, tstore = JMem(), MemObjectStore()
    jrepo = JRepo.init(jstore, chunker=_chunker(request.param))
    trepo = Repository.init(tstore, chunker=_chunker(request.param),
                            device="cpu")
    jsnap, _ = JBackup(jrepo, workers=1).run(src)
    tsnap, tstats = TreeBackup(trepo, workers=1).run(src)
    return {"base": base, "src": src, "jstore": jstore, "tstore": tstore,
            "jrepo": jrepo, "trepo": trepo, "jsnap": jsnap, "tsnap": tsnap,
            "tstats": tstats}


def _tree(repo, snap):
    return dict(repo.list_snapshots())[snap]["tree"]


def test_backup_matches_reference(backed_up):
    j, t = backed_up["jrepo"], backed_up["trepo"]
    assert _tree(t, backed_up["tsnap"]) == _tree(j, backed_up["jsnap"])
    assert t.blob_ids() == j.blob_ids()
    assert _index(t) == _index(j)
    kinds = {t._entry(b).type for b in t.blob_ids()}
    assert kinds == {"data", "tree"}
    st = backed_up["tstats"]
    assert st.files == 6 and st.blobs_new > 4
    # a second backup of the unchanged tree stores nothing new
    again, st2 = TreeBackup(t, workers=1).run(backed_up["src"])
    assert _tree(t, again) == _tree(t, backed_up["tsnap"])
    assert st2.blobs_new == 0 and st2.bytes_dedup > 0


def test_each_package_restores_the_others_snapshot(backed_up):
    base, src = backed_up["base"], backed_up["src"]
    port_of_ref = base / "port-of-ref"
    ref_of_port = base / "ref-of-port"
    restore_snapshot(Repository.open(_as_port(backed_up["jstore"]),
                                     device="cpu"), port_of_ref)
    j_restore(JRepo.open(_as_ref(backed_up["tstore"])), ref_of_port)
    assert_restored(src, port_of_ref)
    assert_restored(src, ref_of_port)
    assert_restored(port_of_ref, ref_of_port, blocks=True)
    # the hole stays a hole
    assert (port_of_ref / "sparse.bin").stat().st_blocks * 512 < 145_000


def _as_port(jstore) -> MemObjectStore:
    store = MemObjectStore()
    for k in jstore.list():
        store.put(k, jstore.get(k))
    return store


def _as_ref(tstore) -> JMem:
    store = JMem()
    for k in tstore.list():
        store.put(k, tstore.get(k))
    return store


def test_serial_restore_equals_pipelined(tmp_path):
    src = make_tree(tmp_path / "src", seed=4)
    store = MemObjectStore()
    repo = Repository.init(store, "pw", chunker=_chunker(4096), device="cpu")
    repo.PACK_TARGET = 64 * 1024  # several packs
    snap, _ = TreeBackup(repo, workers=1).run(src)
    results = {}
    for name, pipeline in (("serial", False), ("pipe", True)):
        r = Repository.open(store, "pw", device="cpu")
        manifest = dict(r.list_snapshots())[snap]
        results[name] = TreeRestore(r, pipeline=pipeline).run(
            snap, manifest, tmp_path / name)
    assert results["serial"] == results["pipe"]
    assert_restored(tmp_path / "serial", tmp_path / "pipe", blocks=True)
    assert_restored(src, tmp_path / "pipe")


def _corrupt_first_blob(store, repo) -> str:
    _, manifest = repo.list_snapshots()[0]
    tree = json.loads(repo.read_blob(manifest["tree"]))
    entry = next(e for e in tree["entries"] if e["name"] == "only.bin")
    blob0 = entry["content"][0]
    ie = repo._entry(blob0)
    key = f"data/{ie.pack[:2]}/{ie.pack}"
    body = bytearray(store.get(key))
    body[ie.offset + 5] ^= 0xFF  # one byte inside the blob's segment
    store.put(key, bytes(body))
    return blob0


@pytest.mark.parametrize("password", [None, "pw"], ids=["plain", "sealed"])
def test_corrupt_pack_rejected_before_any_write(tmp_path, password):
    """Unsealed, the device verify catches the flipped byte; sealed, the
    MAC does. Either way nothing reaches the destination."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "only.bin").write_bytes(np.random.RandomState(9).bytes(90_000))
    store = MemObjectStore()
    repo = Repository.init(store, password, chunker=_chunker(4096),
                           device="cpu")
    TreeBackup(repo, workers=1).run(src)
    bad = _corrupt_first_blob(store, repo)
    dst = tmp_path / "dst"
    with pytest.raises(crypto.IntegrityError) as err:
        restore_snapshot(Repository.open(store, password, device="cpu"), dst)
    if password is None:
        assert bad in str(err.value)  # the verify names the blob
    assert list(dst.rglob("*")) == []
    with pytest.raises(crypto.IntegrityError):
        TreeRestore(Repository.open(store, password, device="cpu"),
                    pipeline=False).run(
            *repo.list_snapshots()[0], tmp_path / "serial")


def test_four_workers_give_the_one_worker_snapshot(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    rng = np.random.RandomState(6)
    # two chunked files and two below min_size (the CPU twins slow down
    # several-fold under concurrent threads, so two at once at most)
    for k, n in enumerate((20_000, 3_000, 27_777, 4_000)):
        (src / ("sub" if k % 2 else "") / f"f{k}.bin").write_bytes(
            rng.bytes(n))
    got = []
    for workers in (1, 4):
        repo = Repository.init(MemObjectStore(), chunker=_chunker(4096),
                               device="cpu")
        backup = TreeBackup(repo, workers=workers)
        assert backup.workers == workers
        snap, _ = backup.run(src)
        got.append((_tree(repo, snap), _index(repo)))
    assert got[0] == got[1]


@pytest.mark.parametrize("protocol", ["full", "auto"])
def test_full_and_auto_protocols_match_reference(tmp_path, monkeypatch,
                                                 protocol):
    """``"auto"`` starts both packages' planners cold: books reset, and
    the dedup-query counters their books diff at 0 for the test."""
    from volsync_tpu.engine import syncstats as jstats
    from volsync_tpu.metrics import GLOBAL as JMETRICS
    from volsync_tpu_torch.engine import syncstats
    from volsync_tpu_torch.metrics import GLOBAL as METRICS

    monkeypatch.delenv("VOLSYNC_SYNC_PROTO", raising=False)
    for r in ("hit", "miss"):
        monkeypatch.setattr(METRICS.index_queries.labels(result=r), "value",
                            0.0)
        monkeypatch.setattr(JMETRICS.index_queries.labels(result=r)._value,
                            "_value", 0.0)
    syncstats.reset_books()
    jstats.reset_books()
    src = make_tree(tmp_path / "src", seed=5)
    jrepo = JRepo.init(JMem(), chunker=_chunker(4096))
    trepo = Repository.init(MemObjectStore(), chunker=_chunker(4096),
                            device="cpu")
    jsnap, _ = JBackup(jrepo, workers=1, protocol=protocol).run(src)
    tsnap, _ = TreeBackup(trepo, workers=1, protocol=protocol).run(src)
    syncstats.reset_books()
    jstats.reset_books()
    assert _tree(trepo, tsnap) == _tree(jrepo, jsnap)
    assert _index(trepo) == _index(jrepo)
    with pytest.raises(ValueError, match="unknown backup protocol"):
        TreeBackup(trepo, protocol="rsync")


def test_backup_and_restore_default_to_the_repository_device():
    repo = Repository.init(MemObjectStore(), chunker=_chunker(4096),
                           device="cpu")
    backup = TreeBackup(repo)
    assert backup.device.type == "cpu"
    assert backup.hasher.device.type == "cpu"
    assert backup.hasher.params.align == 4096
    assert TreeRestore(repo).device.type == "cpu"


def test_launch_counts_add_up_across_threads(monkeypatch):
    """Backup and restore workers launch from several threads at once;
    no launch is lost from the counts that chip_smoke asserts (more
    threads than cores, a short switch interval)."""
    import sys
    import threading
    import types

    from volsync_tpu_torch.ops import _build

    k = _build.Kernel("stress_probe", "none.cu", "none", [])
    try:
        k._fn = lambda *args: 0  # a launcher that always succeeds
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda index: types.SimpleNamespace(
                                cuda_stream=0))
        dev = torch.device("cuda", 0)
        threads = [threading.Thread(
            target=lambda: [k.launch(dev) for _ in range(2000)])
            for _ in range(4 * (os.cpu_count() or 4))]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert k.launches == 2000 * len(threads)
        assert _build.launch_counts()["stress_probe"] == k.launches
    finally:
        _build.KERNELS.remove(k)

