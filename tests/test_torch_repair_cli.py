"""The port's ``repair`` verb against the JAX package's, on the CPU.

Each case makes one store state, copies it, and runs the reference's
``volsync_tpu.cli.main.run`` on one copy and the port's
``volsync_tpu_torch.cli.main(..., device="cpu")`` on the other: the exit
codes (0 clean or resolved, 1 damage repair refuses to touch, 2 could
not run), the reports (``--json`` and text) and what the verb leaves in
the store must be the same. The states are
tests/test_multiwriter.py's repair cases: an orphan pack, a stale
fenced marker and superseded generation stamps (``--dry-run`` leaves
them, an applying repair resolves them), an expired pending-delete
manifest, a dangling index entry no snapshot references, a referenced
pack gone (exit 1), a store that is not there and a wrong password
(exit 2). The tree is made from a seed with numpy (three 60 KB files,
64 KiB packs, one backup worker).
"""

import json
import os
import shutil
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from volsync_tpu.cli.main import run as j_run
from volsync_tpu_torch import cli
from volsync_tpu_torch.engine.backup import TreeBackup
from volsync_tpu_torch.engine.restore import restore_snapshot
from volsync_tpu_torch.objstore.store import FsObjectStore
from volsync_tpu_torch.repo import blobid
from volsync_tpu_torch.repo.repository import Repository

torch.set_num_threads(1)

DEV = "cpu"
CHUNKER = {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
           "seed": 7, "align": 4096}
ORPHAN = "ab" + "5e" * 31


def _src_tree(root, *, seed=11, files=3, size=60_000):
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True)
    for i in range(files):
        (root / f"f{i}.bin").write_bytes(rng.bytes(size + 7 * i))
    return root


@pytest.fixture(scope="module")
def base_store(tmp_path_factory):
    """A port-written repository holding one snapshot of the tree."""
    base = tmp_path_factory.mktemp("repair")
    root = base / "store"
    fs = FsObjectStore(str(root))
    Repository.init(fs, chunker=CHUNKER, device=DEV)
    repo = Repository.open(fs, device=DEV)
    repo.PACK_TARGET = 64 * 1024
    src = _src_tree(base / "src")
    snap, _ = TreeBackup(repo, workers=1).run(src)
    assert snap
    return root, src


def _debris(fs):
    """An orphan pack, a stale fenced marker and three superseded
    generation stamps (test_multiwriter's ``_damaged_repo``)."""
    fs.put(f"data/{ORPHAN[:2]}/{ORPHAN}", bytes(range(256)) * 2)
    old = (datetime.now(timezone.utc) - timedelta(seconds=7200)).isoformat()
    fs.put("fenced/deadwriter",
           json.dumps({"by": "x", "lock": "y", "time": old}).encode())
    for _ in range(3):
        Repository.open(fs, device=DEV)


def _both(tmp_path, root, argv_tail, *, state=None):
    """Copy the store at ``root`` twice and run ``argv_tail`` (the verb
    and its options; the store path goes second) through the
    reference's CLI on one copy and the port's on the other ->
    {"ref"|"port": (rc, output lines, store)}."""
    out = {}
    for who in ("ref", "port"):
        dst = tmp_path / f"{who}-store"
        if root is not None:
            shutil.copytree(root, dst)
            if state is not None:
                state(FsObjectStore(str(dst)))
        argv = [argv_tail[0], str(dst), *argv_tail[1:]]
        lines: list = []
        if who == "ref":
            rc = j_run(argv, {}, out=lines.append)
        else:
            rc = cli.main(argv, out=lines.append, device=DEV)
        out[who] = (rc, lines, FsObjectStore(str(dst)))
    return out


def _report(lines) -> dict:
    return json.loads("\n".join(lines))


def _keys(store) -> set:
    """Store keys except the ones every open mints (gen stamps, locks),
    with the writer id taken out of index object names
    (``index/<gen>-<writer>-<digest>``)."""
    out = set()
    for k in store.list(""):
        if k.startswith(("gen/", "locks/")):
            continue
        if k.startswith("index/"):
            gen, _writer, digest = k[len("index/"):].split("-")
            k = f"index/{gen}-{digest}"
        out.add(k)
    return out


def test_dry_run_json_reports_and_leaves_the_store(tmp_path, base_store):
    root, _ = base_store
    res = _both(tmp_path, root, ["repair", "--dry-run", "--json"],
                state=_debris)
    (rc_r, lines_r, fs_r), (rc_p, lines_p, fs_p) = res["ref"], res["port"]
    assert rc_r == rc_p == 0
    rep_r, rep_p = _report(lines_r), _report(lines_p)
    assert rep_p == rep_r
    assert rep_p["applied"] is False and rep_p["gc"] is None
    assert rep_p["orphan_packs"] == [ORPHAN]
    assert "fenced/deadwriter" in rep_p["stale_markers"]
    assert _keys(fs_p) == _keys(fs_r)
    assert fs_p.exists(f"data/{ORPHAN[:2]}/{ORPHAN}")
    assert fs_p.exists("fenced/deadwriter")


def test_repair_resolves_debris(tmp_path, base_store):
    root, src = base_store
    res = _both(tmp_path, root, ["repair", "--grace-seconds", "0"],
                state=_debris)
    (rc_r, lines_r, fs_r), (rc_p, lines_p, fs_p) = res["ref"], res["port"]
    assert rc_r == rc_p == 0
    assert lines_p == lines_r
    assert lines_p[0] == "repair resolved:"
    assert any("gc: swept" in ln for ln in lines_p)
    for fs in (fs_r, fs_p):
        assert not fs.exists(f"data/{ORPHAN[:2]}/{ORPHAN}")
        assert not fs.exists("fenced/deadwriter")
        assert len(list(fs.list("gen/"))) == 1
    assert _keys(fs_p) == _keys(fs_r)
    fresh = Repository.open(fs_p, device=DEV)
    assert fresh.check(read_data=True) == []
    restore_snapshot(fresh, tmp_path / "dst")
    for f in sorted(p.name for p in src.iterdir()):
        assert (tmp_path / "dst" / f).read_bytes() == (src / f).read_bytes()


def _expired_manifest(fs):
    """Forget the snapshot and prune with a grace that is already over:
    every pack is parked in a pending-delete manifest past its
    deadline."""
    repo = Repository.open(fs, device=DEV)
    for sid, _ in repo.list_snapshots():
        repo.delete_snapshot(sid)
    assert repo.prune(grace_seconds=1e-6)["packs_pending"] > 0


def test_expired_manifest_is_swept(tmp_path, base_store):
    root, _ = base_store
    res = _both(tmp_path, root, ["repair", "--json"],
                state=_expired_manifest)
    (rc_r, lines_r, fs_r), (rc_p, lines_p, fs_p) = res["ref"], res["port"]
    assert rc_r == rc_p == 0
    rep_r, rep_p = _report(lines_r), _report(lines_p)
    assert rep_p == rep_r
    assert rep_p["expired_manifests"] == rep_p["pending_manifests"] == 1
    assert rep_p["gc"]["packs_swept"] > 0
    for fs in (fs_r, fs_p):
        assert list(fs.list("pending-delete/")) == []
        assert list(fs.list("data/")) == []
    assert _keys(fs_p) == _keys(fs_r)


def _dangling_entry(fs):
    """An index entry whose pack is gone and whose blob no snapshot
    references."""
    repo = Repository.open(fs, device=DEV)
    data = np.random.RandomState(3).bytes(20_000)
    bid = blobid.blob_id(data)
    repo.add_blob("data", bid, data)
    repo.flush()
    pack = repo._index.lookup(bid)[0]
    fs.delete(f"data/{pack[:2]}/{pack}")


def test_unreachable_dangling_entry_is_dropped(tmp_path, base_store):
    root, _ = base_store
    res = _both(tmp_path, root, ["repair", "--json", "--grace-seconds",
                                 "0"], state=_dangling_entry)
    (rc_r, lines_r, fs_r), (rc_p, lines_p, fs_p) = res["ref"], res["port"]
    assert rc_r == rc_p == 0
    rep_r, rep_p = _report(lines_r), _report(lines_p)
    assert rep_p == rep_r
    assert len(rep_p["dangling_packs"]) == 1
    assert rep_p["dangling_entries_dropped"] >= 1
    assert rep_p["unrecoverable_blobs"] == []
    assert Repository.open(fs_p, device=DEV).check(read_data=True) == []


def _referenced_pack_gone(fs):
    repo = Repository.open(fs, device=DEV)
    pack = sorted(p for p in repo._index.live_packs() if p)[0]
    fs.delete(f"data/{pack[:2]}/{pack}")


def test_reachable_loss_exits_1_and_refuses_gc(tmp_path, base_store):
    root, _ = base_store
    res = _both(tmp_path, root, ["repair"], state=_referenced_pack_gone)
    (rc_r, lines_r, fs_r), (rc_p, lines_p, fs_p) = res["ref"], res["port"]
    assert rc_r == rc_p == 1
    assert lines_p == lines_r
    assert any(ln.startswith("  UNRECOVERABLE blob: ") for ln in lines_p)
    assert not any("gc: swept" in ln for ln in lines_p)
    assert _keys(fs_p) == _keys(fs_r)


@pytest.mark.parametrize("case", ["missing-store", "wrong-password"])
def test_operational_errors_exit_2(tmp_path, case):
    if case == "missing-store":
        res = _both(tmp_path, None, ["repair"])
        for who in ("ref", "port"):
            # an empty directory is no repository
            shutil.rmtree(tmp_path / f"{who}-store", ignore_errors=True)
    else:
        # an encrypted repository opened with the wrong password
        root = tmp_path / "sealed"
        Repository.init(FsObjectStore(str(root)), password="right",
                        chunker=CHUNKER, device=DEV)
        res = _both(tmp_path, root, ["repair", "--password", "not-it"])
    assert res["ref"][0] == res["port"][0] == 2
    assert res["port"][1][0].startswith("error:")
    assert res["ref"][1][0].startswith("error:")


def test_repair_raises_without_cuda_before_the_store(monkeypatch,
                                                     tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = tmp_path / "none"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["repair", str(store)])
    assert not store.exists()
    assert not os.path.exists(store)
