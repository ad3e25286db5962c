"""The port's lock-order/race detector (``volsync_tpu_torch/analysis/
lockcheck.py``) holds the cases of ``tests/test_lockcheck.py``: off it
hands out plain locks; armed, a seeded AB/BA cycle and a three-lock
cycle are caught on any interleaving, self-deadlock and unguarded
mutation raise, and the port's pipelined repository runs clean. Then
concurrent erasure-coded reads of one pack, armed, decode it once
through the named single-flight lock with no violation, and the
flight lock sits before ``repo.ec_memo`` in the observed order."""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.engine.backup import TreeBackup
from volsync_tpu_torch.objstore.store import MemObjectStore
from volsync_tpu_torch.repo import blobid
from volsync_tpu_torch.repo.repository import Repository

torch.set_num_threads(1)


@pytest.fixture
def checked(monkeypatch):
    monkeypatch.setenv("VOLSYNC_TPU_LOCKCHECK", "1")
    lockcheck.reset()
    yield
    lockcheck.reset()


def test_disabled_returns_plain_locks(monkeypatch):
    monkeypatch.delenv("VOLSYNC_TPU_LOCKCHECK", raising=False)
    lock = lockcheck.make_lock("plain")
    assert type(lock) is type(threading.Lock())
    rlock = lockcheck.make_rlock("plain.r")
    assert type(rlock) is type(threading.RLock())
    # assert_held is a no-op on plain locks: call sites stay branchless
    lockcheck.assert_held(lock, "anything")


def test_ab_ba_cycle_detected(checked):
    """T1 takes A then B; T2 takes B then A. The second order is
    flagged the moment it is observed: neither thread has to block."""
    a = lockcheck.make_lock("fixture.A")
    b = lockcheck.make_lock("fixture.B")
    with a:
        with b:
            pass
    caught = []

    def ba():
        try:
            with b:
                with a:
                    pass
        except lockcheck.LockOrderError as e:
            caught.append(e)

    t = threading.Thread(target=ba, name="ba")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert len(caught) == 1
    assert "cycle" in str(caught[0])
    assert len(lockcheck.violations()) == 1
    # the offending acquire did NOT leave the lock held
    assert not a.locked()


def test_three_lock_cycle_detected(checked):
    """Transitive cycles too: A->B, B->C, then C->A closes the loop."""
    a, b, c = (lockcheck.make_lock(f"fixture3.{n}") for n in "ABC")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with pytest.raises(lockcheck.LockOrderError):
        with c:
            with a:
                pass


def test_consistent_order_is_clean(checked):
    a = lockcheck.make_lock("ok.A")
    b = lockcheck.make_lock("ok.B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert lockcheck.violations() == []
    assert lockcheck.order_graph() == {"ok.A": {"ok.B"}}
    assert lockcheck.graph() == {("ok.A", "ok.B")}


def test_self_deadlock_on_nonreentrant_lock(checked):
    lock = lockcheck.make_lock("self.A")
    with lock:
        with pytest.raises(lockcheck.LockOrderError):
            lock.acquire()
    # non-blocking re-acquire is a legitimate probe, not a deadlock
    with lock:
        assert lock.acquire(blocking=False) is False


def test_rlock_reentry_allowed(checked):
    rlock = lockcheck.make_rlock("re.A")
    with rlock:
        with rlock:
            lockcheck.assert_held(rlock, "nested state")
    with pytest.raises(lockcheck.LockGuardError):
        lockcheck.assert_held(rlock, "released state")


def test_assert_held_catches_wrong_thread(checked):
    lock = lockcheck.make_lock("guard.A")
    errs = []

    def intruder():
        try:
            lockcheck.assert_held(lock, "shared queue")
        except lockcheck.LockGuardError as e:
            errs.append(e)

    with lock:
        t = threading.Thread(target=intruder)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert len(errs) == 1
    assert "shared queue" in str(errs[0])
    assert any("shared queue" in v for v in lockcheck.violations())


def test_pipelined_backup_runs_instrumented(checked):
    """The port's pipelined repository with instrumented locks: every
    stage's lock discipline holds, and the write path still produces a
    readable repository."""
    rng = np.random.RandomState(7)
    repo = Repository.init(MemObjectStore(), device="cpu")
    repo.PACK_TARGET = 16 * 1024
    assert repo.pipelined
    assert isinstance(repo._lock, lockcheck._InstrumentedLock)
    blobs = [(d, blobid.blob_id(d))
             for d in (rng.bytes(3000) for _ in range(40))]
    for data, bid in blobs:
        repo.add_blob("data", bid, data)
    repo.flush()
    for data, bid in blobs:
        assert repo.read_blob(bid) == data
    assert lockcheck.violations() == []
    assert repo._lock.locked() is False
    # the instrumented run observed lock activity under the state lock
    assert any(a == "repo.state" for a, _ in lockcheck.graph())


def test_concurrent_ec_reads_of_one_pack_armed(checked, tmp_path,
                                               monkeypatch):
    """Eight threads read every blob of an erasure-coded repository
    whose packs each lost two of six shards: each pack is decoded once
    (the single-flight lock, built through the detector as
    "repo.ec_flight"), every read returns its bytes, and the detector
    records no violation. The observed order puts the flight lock
    before "repo.ec_memo", never after it."""
    rng = np.random.RandomState(11)
    src = tmp_path / "src"
    src.mkdir()
    for i in range(2):
        (src / f"f{i}.bin").write_bytes(rng.bytes(90_000 + 17 * i))
    store = MemObjectStore()
    repo = Repository.init(store, chunker={
        "min_size": 4096, "avg_size": 32768, "max_size": 65536,
        "seed": 7, "align": 4096}, device="cpu")
    repo.PACK_TARGET = 64 * 1024
    repo.ec_scheme = (4, 2)
    TreeBackup(repo, workers=1).run(src)
    packs: dict = {}
    for key in store.list("ec/"):
        packs.setdefault(key.split("/")[1], []).append(key)
    assert packs and all(len(ks) == 6 for ks in packs.values())
    for keys in packs.values():
        for k in sorted(keys)[:2]:
            store.delete(k)

    decoded = []
    once = Repository._ec_reconstruct_once

    def counted(self, pack_id):
        decoded.append(pack_id)
        return once(self, pack_id)

    monkeypatch.setattr(Repository, "_ec_reconstruct_once", counted)
    lockcheck.reset()
    reader = Repository.open(store, device="cpu")
    ids = sorted(bid for bid, entry in reader._index.items()
                 if entry[1] == "data")
    assert len(ids) > 2
    barrier = threading.Barrier(8)

    def read_all(k):
        barrier.wait(timeout=10)
        return [blobid.blob_id(reader.read_blob(b)) == b
                for b in ids[k % len(ids):] + ids[:k % len(ids)]]

    with ThreadPoolExecutor(8) as pool:
        results = list(pool.map(read_all, range(8)))
    assert all(all(r) for r in results)
    assert sorted(decoded) == sorted(set(decoded))  # one decode a pack
    assert set(decoded) <= set(packs)
    assert lockcheck.violations() == []
    graph = lockcheck.graph()
    assert ("repo.ec_flight", "repo.ec_memo") in graph
    assert ("repo.ec_memo", "repo.ec_flight") not in graph
