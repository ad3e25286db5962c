"""The port's durability path against the JAX package's, on the CPU:
the pack shard codec (``repo/erasure.py``), the fault-injection store
(``objstore/faultstore.py``), the repository's erasure-coded layout,
the integrity scrub (``repo/scrub.py``) and the online repack
(``repo/repack.py``).

Shard blobs are byte-identical to the reference's for the same parts;
``reconstruct_verified`` routes around a corrupt shard and gives None
below k, as there; both fault stores make the same decisions over one
seeded sequence of 200 operations; an erasure-coded repository written
by either package opens, checks and restores byte-identical under the
other; the scrub heals a rotted shard and a rotted primary, and
quarantines a pack below k; a repack cut at each boundary of its
declared write order leaves a repository that checks clean, and a
retried cycle converges. Trees are small (64 KiB packs, one worker) and
every schedule is deterministic. Inputs are made from a seed with
numpy.
"""

import hashlib
import json
import time
from itertools import combinations

import numpy as np
import pytest
import torch

from volsync_tpu.engine.backup import TreeBackup as JBackup
from volsync_tpu.engine.restore import restore_snapshot as j_restore
from volsync_tpu.objstore import faultstore as jfault
from volsync_tpu.objstore.store import MemObjectStore as JMem
from volsync_tpu.repo import erasure as jerasure
from volsync_tpu.repo.repository import Repository as JRepo
from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.engine.backup import TreeBackup
from volsync_tpu_torch.engine.restore import restore_snapshot
from volsync_tpu_torch.objstore import faultstore as tfault
from volsync_tpu_torch.objstore.store import MemObjectStore, NoSuchKey
from volsync_tpu_torch.ops import rs
from volsync_tpu_torch.repo import erasure
from volsync_tpu_torch.repo.repack import RepackService
from volsync_tpu_torch.repo.repository import Repository
from volsync_tpu_torch.repo.scrub import ScrubService

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _lockcheck_armed_module():
    """The lock-order/race detector is armed for the whole module, so
    every Repository and store built here (module fixtures included)
    gets instrumented locks (the env flag is read when a lock is
    built)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOLSYNC_TPU_LOCKCHECK", "1")
        yield


@pytest.fixture(autouse=True)
def _lockcheck_armed():
    """Each test starts with an empty order graph and fails on any
    lock-order cycle or unguarded pipeline-state mutation the detector
    recorded, even one a worker thread swallowed."""
    lockcheck.reset()
    yield
    assert lockcheck.violations() == []

CHUNKER = {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
           "seed": 7, "align": 4096}
PACK_TARGET = 64 * 1024
SCHEMES = [(2, 1), (4, 2), (6, 3)]


# -- helpers ------------------------------------------------------------------

def _src_tree(root, *, seed=5, files=1):
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True)
    for i in range(files):
        (root / f"f{i}.bin").write_bytes(rng.bytes(110_000 + 13 * i))
    (root / "sub").mkdir()
    (root / "sub" / "nested.bin").write_bytes(rng.bytes(40_000))
    return root


def _assert_identical(src, dst):
    rels = sorted(p.relative_to(src) for p in src.rglob("*"))
    assert rels == sorted(p.relative_to(dst) for p in dst.rglob("*"))
    for rel in rels:
        if (src / rel).is_file():
            assert (dst / rel).read_bytes() == (src / rel).read_bytes(), rel


def _port_backup(store, src, *, ec=None, copies=1, init=True):
    repo = (Repository.init(store, chunker=CHUNKER, device="cpu") if init
            else Repository.open(store, device="cpu"))
    repo.PACK_TARGET = PACK_TARGET
    repo.ec_scheme = ec
    repo.pack_copies = copies
    snap, _ = TreeBackup(repo, workers=1).run(src)
    return snap


def _copy(store: MemObjectStore) -> MemObjectStore:
    out = MemObjectStore()
    out._objs = dict(store._objs)
    return out


def _shards_of(store):
    """pack id -> sorted shard keys under ec/."""
    packs: dict = {}
    for key in store.list("ec/"):
        packs.setdefault(key.split("/")[1], []).append(key)
    return {p: sorted(ks) for p, ks in packs.items()}


def _open(store):
    return Repository.open(store, device="cpu")


@pytest.fixture(scope="module")
def ec_estate(tmp_path_factory):
    """(store, src): the port's 4+2 erasure-coded backup of a small tree
    (several packs); tests work on a copy of the store."""
    src = _src_tree(tmp_path_factory.mktemp("ec") / "src")
    store = MemObjectStore()
    _port_backup(store, src, ec=(4, 2))
    return store, src


@pytest.fixture(scope="module")
def fragmented_estate(tmp_path_factory):
    """(store, src): a primary+mirror estate with dead weight — two
    snapshots, one file rewritten between them, the first forgotten."""
    src = _src_tree(tmp_path_factory.mktemp("frag") / "src")
    store = MemObjectStore()
    _port_backup(store, src, copies=2)
    (src / "f0.bin").write_bytes(np.random.RandomState(99).bytes(110_000))
    _port_backup(store, src, copies=2, init=False)
    _open(store).forget(last=1)
    return store, src


# -- shard codec ----------------------------------------------------------------

@pytest.mark.parametrize("k,m", SCHEMES)
def test_shard_blobs_equal_the_reference(k, m):
    rng = np.random.RandomState(k * 10 + m)
    for n in (0, 1, 3, 5, 4095, 4096, 70_001):
        body = rng.bytes(n)
        parts = [body[: n // 3], memoryview(body)[n // 3: n // 2],
                 bytearray(body[n // 2:])]
        got = erasure.encode_pack_shards(parts, k, m, device="cpu")
        assert got == jerasure.encode_pack_shards(parts, k, m), n
        pack_id = hashlib.sha256(body).hexdigest()
        have = dict(enumerate(got))
        for idx in range(m):
            del have[idx * 2 % (k + m)]  # m losses, data and parity
        assert erasure.reconstruct_verified(have, pack_id,
                                            device="cpu") == body
        assert erasure.stripe_scheme(have) == (k, m)


def test_reconstruct_verified_routes_around_a_corrupt_shard():
    rng = np.random.RandomState(3)
    body = rng.bytes(20_000)
    pack_id = hashlib.sha256(body).hexdigest()
    shards = dict(enumerate(erasure.encode_pack_shards([body], 4, 2,
                                                       device="cpu")))
    bad = bytearray(shards[1])
    bad[erasure.HEADER_LEN + 7] ^= 0x40
    shards[1] = bytes(bad)
    before = rs.CALLS.n
    assert erasure.reconstruct_verified(shards, pack_id,
                                        device="cpu") == body
    # combinations(have, k) order, as in the reference: the first subset
    # without the bad shard 1 is (0,2,3,4), the seventh tried
    attempts = rs.CALLS.n - before
    subsets = list(combinations(range(6), 4))
    assert attempts == next(i for i, s in enumerate(subsets)
                            if 1 not in s) + 1
    assert jerasure.reconstruct_verified(shards, pack_id) == body
    shards[2] = shards[2][:-5]           # truncated payload
    shards[4] = b"JUNK" + shards[4][4:]  # wrong magic
    assert erasure.reconstruct_verified(shards, pack_id,
                                        device="cpu") is None
    assert jerasure.reconstruct_verified(shards, pack_id) is None
    below = {i: shards[i] for i in (0, 3, 5)}
    assert erasure.reconstruct_verified(below, pack_id,
                                        device="cpu") is None
    with pytest.raises(erasure.ECError, match="need 4 healthy"):
        erasure.reconstruct_pack(below, device="cpu")
    assert erasure.reconstruct_verified({}, pack_id, device="cpu") is None


def test_header_parse_and_scheme_limits():
    blob = erasure.shard_header(4, 2, 5, 12345) + b"x" * 3087
    assert blob[:16] == jerasure.shard_header(4, 2, 5, 12345)
    k, m, idx, n, payload = erasure.parse_shard(blob)
    assert (k, m, idx, n, len(payload)) == (4, 2, 5, 12345, 3087)
    for bad in (b"VSEC", b"XXXX" + blob[4:],
                blob[:4] + b"\x02" + blob[5:],
                erasure.shard_header(4, 2, 0, 1)[:7] + b"\x06" + blob[8:]):
        with pytest.raises(erasure.ECError):
            erasure.parse_shard(bad)
        with pytest.raises(jerasure.ECError):
            jerasure.parse_shard(bad)
    for k, m in ((1, 1), (17, 2), (4, 0), (4, 9)):
        with pytest.raises(erasure.ECError):
            erasure.validate_scheme(k, m)
    assert erasure.storage_overhead(4, 2) == 1.5


# -- fault schedule ------------------------------------------------------------

def _fault_specs(mod):
    S = mod.FaultSpec
    return [S(kind="transient", p=0.08, op="put|get"),
            S(kind="transient", p=0.1, op="delete", landed=True),
            S(kind="throttle", p=0.05),
            S(kind="latency", p=0.1, latency=0.001),
            S(kind="partial_put", p=0.08, op="put"),
            S(kind="truncated_read", p=0.1, op="get_range"),
            S(kind="hang", p=0.02, latency=0.5),
            S(kind="bitflip", p=0.4, nbytes=3),
            S(kind="vanish", at=5, op="get", key_prefix="ec/"),
            S(kind="vanish", at=3, op="put", key_prefix="data/"),
            S(kind="partition", at=150, latency=0.02),
            S(kind="crash", at=60, op="put|delete|put_if_absent")]


def _drive(mod, mem, ops):
    """Run ``ops`` through a FaultStore of ``mod`` over ``mem``;
    -> (outcome per op, injected, sleeps, final store contents)."""
    now = [0.0]
    sleeps = []
    fs = mod.FaultStore(mem, mod.FaultSchedule(seed=4242,
                                               specs=_fault_specs(mod)),
                        sleep_fn=sleeps.append, clock=lambda: now[0])
    out = []
    for op, key, arg in ops:
        now[0] += 0.001
        try:
            if op == "put":
                res = fs.put(key, [arg[:7], memoryview(arg)[7:]])
            elif op == "put_if_absent":
                res = fs.put_if_absent(key, arg)
            elif op == "get_range":
                res = fs.get_range(key, 3, 50)
            elif op == "list":
                res = sorted(fs.list(key))
            else:
                res = getattr(fs, op)(key)
            out.append(("ok", res))
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            out.append((type(e).__name__, None))
    return out, fs.injected, sleeps, dict(sorted(mem._objs.items()))


def test_fault_store_decides_as_the_reference():
    rng = np.random.default_rng(8)
    keys = ([f"data/{i:02x}/p{i}" for i in range(6)]
            + [f"ec/pk/{i}" for i in range(4)] + ["locks/l0", "index/x"])
    names = ["put", "put", "get", "get", "get_range", "exists", "delete",
             "size", "list", "put_if_absent"]
    ops = []
    for _ in range(200):
        op = names[int(rng.integers(len(names)))]
        key = keys[int(rng.integers(len(keys)))]
        if op == "list":
            key = key.split("/")[0] + "/"
        ops.append((op, key, rng.bytes(int(rng.integers(1, 300)))))
    got = _drive(tfault, MemObjectStore(), ops)
    want = _drive(jfault, JMem(), ops)
    assert got == want
    kinds = {kind for _, _, _, kind in got[1]}
    assert {"transient", "bitflip", "vanish", "partition", "crash",
            "partial_put", "latency"} <= kinds
    assert sum(1 for o, _ in got[0] if o == "InjectedCrash") > 0


def test_fault_spec_strings_parse_as_in_the_reference():
    text = ("transient:p=0.05,op=put;latency:p=0.1,ms=2;"
            "crash:at=40,op=put|delete,prefix=data/,landed=1;"
            "bitflip:p=0.2,nbytes=4")
    assert [vars(s) for s in tfault.parse_spec(text)] == \
        [vars(s) for s in jfault.parse_spec(text)]
    assert [vars(s) for s in tfault.default_specs()] == \
        [vars(s) for s in jfault.default_specs()]
    for bad in ("melt:p=1", "transient:q=1"):
        with pytest.raises(ValueError):
            tfault.parse_spec(bad)
    inner = MemObjectStore()
    assert tfault.maybe_wrap(inner) is inner
    wrapped = tfault.maybe_wrap(inner, seed=3, spec="latency:p=1,ms=0")
    assert wrapped.inner is inner and wrapped.schedule.seed == 3


# -- the erasure-coded repository ---------------------------------------------

def test_ec_estate_is_stripes_only_and_survives_m_losses(ec_estate,
                                                         tmp_path,
                                                         monkeypatch):
    store, src = ec_estate
    mem = _copy(store)
    assert list(mem.list("data/")) == [] and list(mem.list("mirror/")) == []
    shards = _shards_of(mem)
    assert len(shards) >= 3 and all(len(ks) == 6 for ks in shards.values())
    repo = _open(mem)
    logical = sum(len(repo.ec_reconstruct(p)) for p in shards)
    stored = sum(mem.size(k) for k in mem.list("ec/"))
    assert stored <= 1.52 * logical, (stored, logical)
    rng = np.random.default_rng(1)
    for keys in shards.values():
        for i in rng.choice(6, size=2, replace=False):
            mem.delete(keys[i])
    decoded = []
    once = Repository._ec_reconstruct_once

    def counted(self, pack_id):
        decoded.append(pack_id)
        return once(self, pack_id)

    monkeypatch.setattr(Repository, "_ec_reconstruct_once", counted)
    assert _open(mem).check(read_data=True, workers=4) == []
    assert sorted(decoded) == sorted(shards)  # each pack decoded once
    decoded.clear()
    restore_snapshot(_open(mem), tmp_path / "dst")
    _assert_identical(src, tmp_path / "dst")
    assert sorted(decoded) == sorted(shards)
    svc = ScrubService(mem, device="cpu")
    assert svc.run_once() == "healed"  # the lost shards backfilled
    assert svc.last_report["healed"] == len(shards)
    assert all(len(ks) == 6 for ks in _shards_of(mem).values())


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_ec_repository_crosses_packages(tmp_path, monkeypatch, writer):
    """An EC repository written by either package opens, checks and
    restores byte-identical under the other (same cipher: both here
    run the one the host has)."""
    monkeypatch.setenv("VOLSYNC_EC_SCHEME", "4+2")
    src = _src_tree(tmp_path / "src")
    mem = MemObjectStore()
    if writer == "port":
        _port_backup(mem, src, ec=(4, 2))
        jmem = JMem()
        jmem._objs = dict(mem._objs)
        assert JRepo.open(jmem).check(read_data=True) == []
        j_restore(JRepo.open(jmem), tmp_path / "dst")
    else:
        jmem = JMem()
        repo = JRepo.init(jmem, chunker=CHUNKER)
        repo.PACK_TARGET = PACK_TARGET
        JBackup(repo, workers=1).run(src)
        mem._objs = dict(jmem._objs)
        assert _open(mem).check(read_data=True) == []
        restore_snapshot(_open(mem), tmp_path / "dst")
    assert list(mem.list("data/")) == [] and _shards_of(mem)
    _assert_identical(src, tmp_path / "dst")


# -- scrub -----------------------------------------------------------------------

def _scrub_first_pack(mem) -> ScrubService:
    """A scrub whose cycle visits one pack: the first in pack-id order
    (the walk's start)."""
    return ScrubService(mem, device="cpu", packs_per_cycle=1)


def test_scrub_heals_a_rotted_shard(ec_estate):
    store, _ = ec_estate
    mem = _copy(store)
    pack, keys = sorted(_shards_of(mem).items())[0]
    good = mem.get(keys[1])
    bad = bytearray(good)
    bad[erasure.HEADER_LEN + 100] ^= 0x01
    mem.put(keys[1], bytes(bad))
    svc = _scrub_first_pack(mem)
    assert svc.run_once() == "healed"
    assert svc.last_report["healed"] == 1 and svc.corruptions == 0
    assert mem.get(keys[1]) == good
    assert _scrub_first_pack(mem).run_once() == "clean"
    assert list(mem.list("quarantine/")) == []


def test_scrub_heals_a_rotted_primary_from_its_mirror(fragmented_estate):
    store, _ = fragmented_estate
    mem = _copy(store)
    repo = _open(mem)
    with repo.lock(exclusive=False):
        repo.load_index()
        segs: dict = {}
        for _b, (pack, _t, off, length, _r) in repo._index.items():
            if pack:
                segs.setdefault(pack, []).append((off, length))
    pack = sorted(segs)[0]
    off, length = sorted(segs[pack])[0]
    key = f"data/{pack[:2]}/{pack}"
    healthy = mem.get(key)
    body = bytearray(healthy)
    body[off + min(5, length - 1)] ^= 0xFF
    mem.put(key, bytes(body))
    svc = _scrub_first_pack(mem)
    assert svc.run_once() == "healed"
    assert svc.corruptions == 1 and svc.healed == 1
    assert mem.get(key) == healthy
    assert list(mem.list("quarantine/")) == []
    assert _scrub_first_pack(mem).run_once() == "clean"


def test_scrub_quarantines_a_pack_below_k(ec_estate, tmp_path):
    store, src = ec_estate
    mem = _copy(store)
    pack, keys = sorted(_shards_of(mem).items())[0]
    for key in keys[:3]:
        mem.delete(key)
    svc = ScrubService(mem, device="cpu")
    assert svc.run_once() == "unhealable"
    assert json.loads(mem.get(f"quarantine/{pack}"))["pack"] == pack
    assert svc.run_once() == "unhealable"
    with pytest.raises(NoSuchKey):
        _open(mem).ec_reconstruct(pack)
    dst = tmp_path / "dst"
    with pytest.raises(NoSuchKey, match="fewer than k"):
        restore_snapshot(_open(mem), dst)
    by_rel = {p.relative_to(src): p for p in src.rglob("*") if p.is_file()}
    written = [p for p in dst.rglob("*") if p.is_file()]
    for p in written:  # no partial file behind the failed restore
        assert p.read_bytes() == by_rel[p.relative_to(dst)].read_bytes()
    assert len(written) < len(by_rel)


# -- repack ----------------------------------------------------------------------

def _converge(svc, store, tries=12):
    for _ in range(tries):
        if svc.run_once() == "clean" and \
                list(store.list("pending-delete/")) == []:
            return
        time.sleep(0.25)
    pytest.fail(f"repack never converged: {svc.outcomes}")


@pytest.mark.parametrize("step", ["_write_stripes", "_verify_stripes",
                                  "_publish_entries",
                                  "_write_retire_manifest"])
def test_repack_cut_at_each_boundary_checks_clean(fragmented_estate,
                                                  monkeypatch, step):
    """A cycle killed at the entry of each declared step leaves the old
    packs in place and the repository check-clean (every blob re-hashed:
    the host path, which flags the same blobs as the device batches);
    the retried cycle converges."""
    store, _ = fragmented_estate
    mem = _copy(store)
    data_before = sorted(mem.list("data/"))

    def crash(self, *a, **kw):
        raise RuntimeError(f"injected crash at {step}")

    svc = RepackService(mem, device="cpu", dead_ratio=0.05,
                        grace_seconds=0.3)
    monkeypatch.setattr(RepackService, step, crash)
    assert svc.run_once() == "error"
    assert sorted(mem.list("data/")) == data_before
    assert _open(mem).check(read_data=True, device_verify=False) == []
    monkeypatch.undo()
    _converge(RepackService(mem, device="cpu", dead_ratio=0.05,
                            grace_seconds=0.3), mem)
    assert _shards_of(mem)
    assert _open(mem).check(read_data=True, device_verify=False) == []


def test_repack_carries_the_estate_to_stripes(fragmented_estate, tmp_path):
    store, src = fragmented_estate
    mem = _copy(store)
    svc = RepackService(mem, device="cpu", scheme=(4, 2), dead_ratio=0.05,
                        grace_seconds=0.3)
    assert svc.run_once() == "ok"
    assert svc.last_report["packs_rewritten"] >= 1
    assert list(mem.list("pending-delete/"))  # parked, not deleted
    _converge(svc, mem)
    shards = _shards_of(mem)
    repo = _open(mem)
    logical = sum(len(repo.ec_reconstruct(p)) for p in shards)
    stored = sum(mem.size(k) for ks in shards.values() for k in ks)
    assert stored <= 1.52 * logical, (stored, logical)
    assert _open(mem).check(read_data=True) == []
    restore_snapshot(_open(mem), tmp_path / "dst")
    _assert_identical(src, tmp_path / "dst")
    with pytest.raises(ValueError, match="grace_seconds > 0"):
        RepackService(mem, device="cpu", grace_seconds=0)
