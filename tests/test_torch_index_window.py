"""The index/snapshot window, reproduced without threads or timing.

A writer publishes its index delta before its snapshot. A reader that
loads the index and only then lists the snapshots can list a snapshot
that landed in between and find its tree "not in index". Each case
patches ``Repository.list_snapshots`` so that its first call publishes
a second writer's complete backup (packs, index delta, snapshot) and
then returns the listing, which is exactly that interleaving.

The reference (``volsync_tpu``) loads first and lists second in the
backup, prune, restore, check and repair paths: it raises, or reports
the new snapshot broken (pinned here as the known difference). The
port lists first (``Repository._list_then_load``; ``check`` reloads
once on a tree miss) and passes; after its prune the new snapshot
restores byte-identical, so the prune swept none of its blobs.

"prune-delta" publishes just after the pruner's index load instead. A
pruner that lists the index deltas it supersedes after that load
deletes the new delta without consolidating its entries, and the new
snapshot's tree is then "not in index" for good; the port lists the
deltas before its load (prune, repair, the repacker), so the delta is
kept and the snapshot restores and checks clean.
"""

import numpy as np
import pytest
import torch

from volsync_tpu.engine.backup import TreeBackup as JBackup
from volsync_tpu.engine.restore import restore_snapshot as j_restore
from volsync_tpu.objstore.store import MemObjectStore as JMem
from volsync_tpu.repo.repository import RepoError as JRepoError
from volsync_tpu.repo.repository import Repository as JRepo
from volsync_tpu_torch.engine.backup import TreeBackup
from volsync_tpu_torch.engine.restore import restore_snapshot
from volsync_tpu_torch.objstore.store import MemObjectStore
from volsync_tpu_torch.repo.repository import Repository

torch.set_num_threads(1)

CHUNKER = {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
           "seed": 0x5EED_CDC1, "align": 4096}


class _Ref:
    """The reference package behind one interface."""

    Repo = JRepo

    @staticmethod
    def init():
        return JRepo.init(JMem(), chunker=CHUNKER)

    @staticmethod
    def open(store):
        return JRepo.open(store)

    @staticmethod
    def backup(repo, src):
        return JBackup(repo, workers=1).run(src)[0]

    @staticmethod
    def restore(repo, dst):
        return j_restore(repo, dst)


class _Port:
    Repo = Repository

    @staticmethod
    def init():
        return Repository.init(MemObjectStore(), chunker=CHUNKER,
                               device="cpu")

    @staticmethod
    def open(store):
        return Repository.open(store, device="cpu")

    @staticmethod
    def backup(repo, src):
        return TreeBackup(repo, workers=1).run(src)[0]

    @staticmethod
    def restore(repo, dst):
        return restore_snapshot(repo, dst)


def _trees(base, seed=11):
    """tree1, and tree2 = tree1 plus one file (so its root tree is new
    while its data dedups into tree1's packs). Files stay below
    min_size: one blob each, cheap on the CPU."""
    rng = np.random.RandomState(seed)
    t1, t2 = base / "t1", base / "t2"
    for t in (t1, t2):
        (t / "d").mkdir(parents=True)
    for name, n in (("a.bin", 3000), ("d/b.bin", 2500)):
        data = rng.bytes(n)
        (t1 / name).write_bytes(data)
        (t2 / name).write_bytes(data)
    (t2 / "c.bin").write_bytes(rng.bytes(1234))
    return t1, t2


def _publish_once(monkeypatch, pkg, store, src, box,
                  method="list_snapshots"):
    """Patch ``pkg.Repo.<method>``: its first call runs a second
    writer's whole backup of ``src`` (its own Repository on ``store``)
    just before (``list_snapshots``) or just after (``load_index``) the
    method's own work. ``box["snap"]`` gets that snapshot's id."""
    orig = getattr(pkg.Repo, method)

    def publish():
        box["snap"] = None  # the writer's own calls are unpatched
        box["snap"] = pkg.backup(pkg.open(store), src)

    def patched(self):
        if method == "list_snapshots" and "snap" not in box:
            publish()
        out = orig(self)
        if method == "load_index" and "snap" not in box:
            publish()
        return out

    monkeypatch.setattr(pkg.Repo, method, patched)


def _same_tree(a, b):
    rels = sorted(p.relative_to(a) for p in a.rglob("*"))
    assert rels == sorted(p.relative_to(b) for p in b.rglob("*"))
    for rel in rels:
        if (a / rel).is_file():
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


CASES = ["backup", "prune", "prune-delta", "restore", "check", "repair"]


def _run_case(case, pkg, repo, t1, t2, tmp_path, monkeypatch, box):
    """Drive one reader through the window; returns the reader's
    result (what differs between the packages is whether it raises)."""
    if case == "backup":
        _publish_once(monkeypatch, pkg, repo.store, t2, box)
        return pkg.backup(repo, t1)
    if case.startswith("prune"):
        # snapshot A is forgotten: only the second writer's snapshot
        # keeps tree1's data packs live. "prune-delta": the writer
        # publishes just after the pruner's index load, so its delta is
        # not in the loaded index (a pruner that lists the deltas to
        # supersede after its load deletes it unconsolidated)
        for sid, _ in repo.list_snapshots():
            repo.delete_snapshot(sid)
        _publish_once(monkeypatch, pkg, repo.store, t2, box,
                      "load_index" if case == "prune-delta"
                      else "list_snapshots")
        return repo.prune(grace_seconds=1e-6)
    if case == "restore":
        _publish_once(monkeypatch, pkg, repo.store, t2, box)
        return pkg.restore(repo, tmp_path / "restored")
    if case == "check":
        _publish_once(monkeypatch, pkg, repo.store, t2, box)
        return repo.check(read_data=True)
    assert case == "repair"
    _publish_once(monkeypatch, pkg, repo.store, t2, box)
    return repo.repair(apply=False)


@pytest.mark.parametrize("case", CASES)
def test_reference_reads_a_snapshot_not_in_its_index(case, tmp_path,
                                                     monkeypatch):
    """The known difference: the reference loads, then lists."""
    t1, t2 = _trees(tmp_path)
    repo = _Ref.init()
    _Ref.backup(repo, t1)
    box: dict = {}
    if case in ("check", "repair"):
        out = _run_case(case, _Ref, repo, t1, t2, tmp_path, monkeypatch,
                        box)
        problems = out if case == "check" else out["broken_trees"]
        assert any("not in index" in p for p in problems), out
    else:
        with pytest.raises(JRepoError, match="not in index"):
            _run_case(case, _Ref, repo, t1, t2, tmp_path, monkeypatch,
                      box)
    assert box["snap"]  # the second writer's backup did land


@pytest.mark.parametrize("case", CASES)
def test_port_lists_before_it_loads(case, tmp_path, monkeypatch):
    t1, t2 = _trees(tmp_path)
    repo = _Port.init()
    _Port.backup(repo, t1)
    box: dict = {}
    out = _run_case(case, _Port, repo, t1, t2, tmp_path, monkeypatch, box)
    monkeypatch.undo()
    assert box["snap"]
    if case == "backup":
        manifest = dict(repo.list_snapshots())[out]
        assert manifest["parent"] == box["snap"]
    elif case.startswith("prune"):
        # a second prune sweeps whatever the first parked; the second
        # writer's snapshot must still restore byte-identical
        repo.prune(grace_seconds=1e-6)
        assert [s for s, _ in repo.list_snapshots()] == [box["snap"]]
        restore_snapshot(_Port.open(repo.store), tmp_path / "after")
        _same_tree(t2, tmp_path / "after")
    elif case == "restore":
        _same_tree(t2, tmp_path / "restored")
    elif case == "check":
        assert out == []
    else:
        assert out["broken_trees"] == [] and out["unrecoverable_blobs"] \
            == []
    assert _Port.open(repo.store).check(read_data=True) == []
