"""The port's repository layer against the JAX package's, on the CPU.

Cipher and compression cross-decode both ways with the same keys; the
compact and sharded indexes answer the same lookups; a repository
written by either package opens, lists, loads its index, reads every
blob equal and passes ``check(read_data=True)`` under the other (the
port's on ``device="cpu"``). A restore group fetches each pack once, and
a corrupt primary heals from its mirror copy. Under ``VOLSYNC_EC_SCHEME``
a flush writes only ``ec/`` shards and a shard-only pack reconstructs;
``VOLSYNC_FAULT_SEED`` wraps the local stores in the fault store (the
network stores: ``tests/test_torch_objstore.py``). The stand-ins (trace context, metrics, lock
factory) behave as the reference's.
"""

import hashlib
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from volsync_tpu import obs as jobs
from volsync_tpu import resilience as jres
from volsync_tpu.objstore import store as jstore
from volsync_tpu.repo import compactindex as jci
from volsync_tpu.repo import compress as jcomp
from volsync_tpu.repo import crypto as jcrypto
from volsync_tpu.repo import repository as jrepo
from volsync_tpu.repo import shardedindex as jsi
from volsync_tpu_torch import obs as tobs
from volsync_tpu_torch import resilience as tres
from volsync_tpu_torch.analysis import lockcheck as tlock
from volsync_tpu_torch.engine.backup import TreeBackup
from volsync_tpu_torch.engine.restore import restore_snapshot
from volsync_tpu_torch.metrics import GLOBAL as TMETRICS
from volsync_tpu_torch.objstore import faultstore as tfault
from volsync_tpu_torch.objstore import store as tstore
from volsync_tpu_torch.repo import blobid
from volsync_tpu_torch.repo import compactindex as tci
from volsync_tpu_torch.repo import compress as tcomp
from volsync_tpu_torch.repo import crypto as tcrypto
from volsync_tpu_torch.repo import erasure as terasure
from volsync_tpu_torch.repo import repository as trepo
from volsync_tpu_torch.repo import shardedindex as tsi

torch.set_num_threads(1)

CHUNKER = {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
           "seed": 7, "align": 4096}


# -- cipher and compression ---------------------------------------------------

@pytest.fixture(params=["aes", "shake"])
def cipher(request, monkeypatch):
    """Both packages on one cipher: the AES build, or the stdlib SHAKE
    keystream that runs where the ``cryptography`` wheel is absent."""
    if request.param == "shake":
        monkeypatch.setattr(jcrypto, "Cipher", None)
        monkeypatch.setattr(tcrypto, "Cipher", None)
    elif not tcrypto.HAVE_AES:
        pytest.skip("the cryptography wheel is not installed")
    return request.param


def test_secretbox_seals_open_across_packages(rng, cipher):
    enc, mac = rng.bytes(32), rng.bytes(32)
    tbox, jbox = tcrypto.SecretBox(enc, mac), jcrypto.SecretBox(enc, mac)
    for n in (0, 1, 4095, 70_001):
        msg = rng.bytes(n)
        assert jbox.open(tbox.seal(msg)) == msg
        assert tbox.open(jbox.seal(msg)) == msg
        parts = [msg[: n // 3], memoryview(msg)[n // 3:]]
        assert jbox.open(b"".join(tbox.seal_parts(parts))) == msg
        assert tbox.open(b"".join(jbox.seal_parts(parts))) == msg
    sealed = bytearray(tbox.seal(b"payload"))
    sealed[20] ^= 1
    with pytest.raises(jcrypto.IntegrityError):
        jbox.open(bytes(sealed))
    with pytest.raises(tcrypto.IntegrityError):
        tbox.open(bytes(sealed))


def test_derived_keys_equal():
    salt = bytes(range(16))
    t = tcrypto.derive_keys("pw", salt, n=2**10)
    j = jcrypto.derive_keys("pw", salt, n=2**10)
    assert (t.enc_key, t.mac_key) == (j.enc_key, j.mac_key)
    assert tcrypto.HAVE_AES == jcrypto.HAVE_AES


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_compress_cross_decodes(rng, monkeypatch, codec):
    if codec == "zlib":
        monkeypatch.setattr(tcomp, "_zstd", None)
        monkeypatch.setattr(jcomp, "_zstd", None)
    elif not tcomp.HAVE_ZSTD:
        pytest.skip("the zstandard wheel is not installed")
    data = rng.bytes(3000) + bytes(50_000) + b"abc" * 9000
    t_out = tcomp.Compressor().compress(data)
    j_out = jcomp.Compressor().compress(data)
    assert t_out == j_out
    assert jcomp.Decompressor().decompress(t_out) == data
    assert tcomp.Decompressor().decompress(j_out) == data
    assert tcomp.Decompressor().decompress(t_out, max_output_size=len(data)) \
        == data


def test_zstd_frame_without_the_wheel_raises(monkeypatch):
    if not jcomp.HAVE_ZSTD:
        pytest.skip("the zstandard wheel is not installed")
    frame = jcomp.Compressor().compress(b"x" * 1000)
    monkeypatch.setattr(tcomp, "_zstd", None)
    with pytest.raises(tcomp.CompressError, match="zstandard"):
        tcomp.Decompressor().decompress(frame)


# -- index --------------------------------------------------------------------

def _entries(rng, n: int):
    ids = [rng.bytes(32).hex() for _ in range(n)]
    packs = [rng.bytes(32).hex() for _ in range(7)] + [""]
    return [(bid, packs[i % len(packs)], "data" if i % 5 else "tree",
             int(rng.randint(0, 1 << 40)), int(rng.randint(1, 1 << 24)),
             int(rng.randint(0, 1 << 24))) for i, bid in enumerate(ids)]


@pytest.mark.parametrize("kind", ["compact", "sharded"])
def test_indexes_answer_the_same_lookups(rng, kind):
    entries = _entries(rng, 3000)
    absent = [rng.bytes(32).hex() for _ in range(500)]
    if kind == "compact":
        t, j = tci.CompactIndex(capacity=64), jci.CompactIndex(capacity=64)
    else:
        t = tsi.ShardedBlobIndex(shards=8, capacity=64)
        j = jsi.ShardedBlobIndex(shards=8, capacity=64)
    for e in entries:
        assert t.insert(*e) == j.insert(*e)
    for e in entries[::3]:  # replace=False keeps the first entry
        e2 = (e[0], "f" * 64) + e[2:]
        assert t.insert(*e2, replace=False) == j.insert(*e2, replace=False)
    for bid, *_ in entries[::11]:
        assert t.remove(bid) == j.remove(bid)
    queries = [e[0] for e in entries] + absent
    assert np.array_equal(t.contains_many(queries), j.contains_many(queries))
    assert t.lookup_many(queries) == j.lookup_many(queries)
    assert [t.lookup(q) for q in queries[:300]] == \
        [j.lookup(q) for q in queries[:300]]
    assert sorted(t.items()) == sorted(j.items())
    assert t.live_packs() == j.live_packs()
    t.vacuum()
    j.vacuum()
    tk, tc, tn = t.snapshot_arrays()
    jk, jc, jn = j.snapshot_arrays()
    assert np.array_equal(tk, jk) and np.array_equal(tc, jc) and tn == jn


def test_bloom_prefilters_agree(rng):
    ids = [rng.bytes(32).hex() for _ in range(2000)]
    rows = tci.as_key_rows(ids)
    assert np.array_equal(rows, jci.as_key_rows(ids))
    t, j = tsi.BloomPrefilter(1024), jsi.BloomPrefilter(1024)
    t.add_rows(rows[:1000])
    j.add_rows(rows[:1000])
    assert np.array_equal(t.maybe_contains_rows(rows),
                          j.maybe_contains_rows(rows))
    assert t.maybe_contains_rows(rows[:1000]).all()
    assert t.saturation() == j.saturation()


# -- repository interop -------------------------------------------------------

def _blobs(rng):
    sizes = [0, 1, 4095, 4096, 4097, 30_000, 65_536, 100_003]
    datas = [rng.bytes(n) for n in sizes] + [bytes(50_000), b"ab" * 20_000]
    return [(blobid.blob_id(d), d) for d in datas]


def _write(pkg, store, password, rng):
    """Fill a repository through ``pkg``'s own write path: several packs
    (a small pack target), a tree blob and a snapshot naming it."""
    repo_mod = trepo if pkg == "port" else jrepo
    kw = {"device": "cpu"} if pkg == "port" else {}
    repo = repo_mod.Repository.init(store, password, chunker=CHUNKER, **kw)
    repo.PACK_TARGET = 64 * 1024
    blobs = _blobs(rng)
    for bid, data in blobs:
        repo.add_blob(repo_mod.BLOB_DATA, bid, data)
    tree = (b'{"entries": [{"content": [' + b", ".join(
        f'"{bid}"'.encode() for bid, _ in blobs) + b'], "name": "f", '
        b'"type": "file"}]}')
    tid = blobid.blob_id(tree)
    repo.add_blob(repo_mod.BLOB_TREE, tid, tree)
    repo.flush()
    snap = repo.save_snapshot({"tree": tid, "paths": ["/v"], "tags": []})
    return blobs, tid, snap


@pytest.mark.parametrize("password", [None, "pw"], ids=["plain", "sealed"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_repository_opens_under_the_other_package(rng, writer, password):
    store = jstore.MemObjectStore()
    blobs, tid, snap = _write(writer, store, password, rng)
    if writer == "reference":
        repo = trepo.Repository.open(store, password, device="cpu")
        other = jrepo.Repository.open(store, password)
    else:
        repo = jrepo.Repository.open(store, password)
        other = trepo.Repository.open(store, password, device="cpu")
    assert [s for s, _ in repo.list_snapshots()] == [snap]
    assert repo.list_snapshots()[0][1]["tree"] == tid
    assert repo.blob_ids() == {b for b, _ in blobs} | {tid}
    assert len({repo._entry(b).pack for b, _ in blobs}) > 2  # several packs
    for bid, data in blobs:
        assert repo.read_blob(bid) == data
        assert repo.read_blob_raw(bid) == data
        e, o = repo._entry(bid), other._entry(bid)
        assert (e.type, e.raw_length, e.pack, e.offset, e.length) == \
            (o.type, o.raw_length, o.pack, o.offset, o.length)
    assert repo.check(read_data=True) == []
    assert repo.check(read_data=True, device_verify=False) == []


def test_check_flags_the_same_corrupt_blob_in_both_packages(rng):
    store = jstore.MemObjectStore()
    blobs, _, _ = _write("port", store, None, rng)
    bid, _ = blobs[6]  # 65,536 random bytes: stored raw, not compressed
    repo = trepo.Repository.open(store, device="cpu")
    e = repo._entry(bid)
    key = trepo.pack_key(e.pack)
    body = bytearray(store.get(key))
    body[e.offset + 1000] ^= 0x10
    store.put(key, bytes(body))
    want = [f"blob {bid}: content hash mismatch"]
    assert repo.check(read_data=True) == want
    assert jrepo.Repository.open(store).check(read_data=True) == want
    with pytest.raises(tcrypto.IntegrityError):
        repo.read_blob(bid)


@pytest.mark.parametrize("pruner", ["reference", "port"])
def test_forget_prune_repair_interoperate(rng, pruner):
    """Two snapshots written by the port; one package forgets the older
    and prunes (stop-the-world, grace 0); both packages then read the
    kept snapshot's blobs, find the dropped ones gone, and check clean;
    a dry-run repair finds no debris."""
    store = jstore.MemObjectStore()
    old_blobs, _, old_snap = _write("port", store, "pw", rng)
    repo = trepo.Repository.open(store, "pw", device="cpu")
    repo.PACK_TARGET = 64 * 1024
    new = [(blobid.blob_id(d), d) for d in (rng.bytes(20_000),
                                           rng.bytes(70_000))]
    for bid, data in new:
        repo.add_blob(trepo.BLOB_DATA, bid, data)
    tree = (b'{"entries": [{"content": [' + b", ".join(
        f'"{bid}"'.encode() for bid, _ in new + old_blobs[:2]) +
        b'], "name": "g", "type": "file"}]}')
    tid = blobid.blob_id(tree)
    repo.add_blob(trepo.BLOB_TREE, tid, tree)
    repo.flush()
    new_snap = repo.save_snapshot({"tree": tid, "paths": ["/v"],
                                   "tags": []})
    mod = trepo if pruner == "port" else jrepo
    kw = {"device": "cpu"} if pruner == "port" else {}
    p = mod.Repository.open(store, "pw", **kw)
    assert p.forget(last=1) == [old_snap]
    stats = p.prune(grace_seconds=0)
    assert stats["blobs_removed"] == len(old_blobs) - 2 + 1
    kept = {b for b, _ in new + old_blobs[:2]} | {tid}
    for reader in (trepo.Repository.open(store, "pw", device="cpu"),
                   jrepo.Repository.open(store, "pw")):
        assert [s for s, _ in reader.list_snapshots()] == [new_snap]
        assert reader.blob_ids() == kept
        for bid, data in new + old_blobs[:2]:
            assert reader.read_blob(bid) == data
        assert reader.check(read_data=True) == []
    report = trepo.Repository.open(store, "pw", device="cpu").repair(
        apply=False)
    assert report["orphan_packs"] == [] and report["dangling_packs"] == []
    assert report["broken_trees"] == []


# -- pack cache and read-repair ------------------------------------------------

def _assert_same_files(src, dst):
    rels = sorted(p.relative_to(src) for p in src.rglob("*"))
    assert rels == sorted(p.relative_to(dst) for p in dst.rglob("*"))
    for rel in rels:
        assert (src / rel).lstat().st_mode == (dst / rel).lstat().st_mode
        if (src / rel).is_file():
            assert (src / rel).read_bytes() == (dst / rel).read_bytes()


def _small_repo(tmp_path, monkeypatch, copies: int):
    """One chunked file and two small ones, backed up unsealed into
    several packs with ``copies`` pack copies."""
    monkeypatch.setenv("VOLSYNC_PACK_COPIES", str(copies))
    rng = np.random.RandomState(12)
    src = tmp_path / "src"
    (src / "d").mkdir(parents=True)
    (src / "a.bin").write_bytes(rng.bytes(90_000))
    (src / "b.txt").write_bytes(b"b" * 3000)
    (src / "d" / "c.bin").write_bytes(rng.bytes(2000))
    store = tstore.MemObjectStore()
    repo = trepo.Repository.init(store, chunker=CHUNKER, device="cpu")
    repo.PACK_TARGET = 32 * 1024
    TreeBackup(repo, workers=1).run(src)
    return src, store


class _PackFetchCounter:
    """Pass-through store that counts whole-object ``data/`` GETs."""

    def __init__(self, inner):
        self.inner = inner
        self.pack_fetches = 0
        self._lock = threading.Lock()

    def get(self, key):
        if key.startswith("data/"):
            with self._lock:
                self.pack_fetches += 1
        return self.inner.get(key)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_restore_group_fetches_each_pack_once(tmp_path, monkeypatch):
    from volsync_tpu_torch.engine.restorepipe import RestoreGroup

    src, store = _small_repo(tmp_path, monkeypatch, 1)
    npacks = len(list(store.list("data/")))
    assert npacks > 1
    counted = _PackFetchCounter(store)
    group = RestoreGroup()
    dests = [tmp_path / f"dst{i}" for i in range(2)]
    for d in dests:
        group.add(trepo.Repository.open(counted, device="cpu"), d)
    assert all(r["files"] == 3 for r in group.run())
    for d in dests:
        _assert_same_files(src, d)
    assert group.stats()[0]["misses"] == npacks
    assert counted.pack_fetches == npacks


def test_read_repair_heals_a_corrupt_primary_from_its_mirror(
        tmp_path, monkeypatch):
    """A flipped byte the device verify catches: with a mirror copy the
    restore heals the primary and completes byte-identical; without
    one it raises before any write."""
    src, store = _small_repo(tmp_path, monkeypatch, 2)
    repo = trepo.Repository.open(store, device="cpu")
    _, manifest = repo.list_snapshots()[0]
    tree = json.loads(repo.read_blob(manifest["tree"]))
    blob = next(e for e in tree["entries"]
                if e["name"] == "a.bin")["content"][0]
    ie = repo._entry(blob)
    key = f"data/{ie.pack[:2]}/{ie.pack}"
    healthy = store.get(key)
    body = bytearray(healthy)
    body[ie.offset + 50] ^= 0x01
    store.put(key, bytes(body))
    restore_snapshot(trepo.Repository.open(store, device="cpu"), tmp_path / "ok")
    _assert_same_files(src, tmp_path / "ok")
    assert store.get(key) == healthy  # the primary was healed
    store.put(key, bytes(body))
    store.delete(f"mirror/{ie.pack}")
    with pytest.raises(tcrypto.IntegrityError, match="content hash"):
        restore_snapshot(trepo.Repository.open(store, device="cpu"),
                         tmp_path / "bad")
    assert not (tmp_path / "bad" / "a.bin").exists()


# -- erasure-coded layout, fault store and refusals ---------------------------

@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_ec_flush_writes_only_shards(rng, monkeypatch, pipeline):
    """Under VOLSYNC_EC_SCHEME a flush seals each pack as its k+m shards
    and nothing else, pipelined and serial, and the blob reads back."""
    monkeypatch.setenv("VOLSYNC_EC_SCHEME", "4+2")
    monkeypatch.setenv("VOLSYNC_TPU_PIPELINE", pipeline)
    repo = trepo.Repository.init(tstore.MemObjectStore(), device="cpu")
    assert repo.ec_scheme == (4, 2)
    data = rng.bytes(5000)
    bid = blobid.blob_id(data)
    repo.add_blob(trepo.BLOB_DATA, bid, data)
    repo.flush()
    keys = list(repo.store.list())
    assert not any(k.startswith(("data/", "mirror/")) for k in keys)
    shards = sorted(k for k in keys if k.startswith("ec/"))
    pack = repo._entry(bid).pack
    assert shards == [trepo.ec_shard_key(pack, i) for i in range(6)]
    assert trepo.Repository.open(repo.store, device="cpu").read_blob(bid) \
        == data


def test_shard_only_pack_reconstructs_and_missing_pack_is_no_such_key(rng):
    repo = trepo.Repository.init(tstore.MemObjectStore(), device="cpu")
    with pytest.raises(tstore.NoSuchKey):
        repo.ec_reconstruct("ab" * 32)
    assert repo._ec_present("ab" * 32) is False
    body = rng.bytes(9000)
    pack = hashlib.sha256(body).hexdigest()
    shards = terasure.encode_pack_shards([body], 4, 2, device="cpu")
    for idx in (0, 2, 3, 5):  # any k of the six
        repo.ec_publish_shard(pack, idx, shards[idx])
    assert repo._ec_present(pack) is True
    assert sorted(repo.ec_shard_blobs(pack)) == [0, 2, 3, 5]
    assert repo.ec_reconstruct(pack) == body
    repo.store.delete(trepo.ec_shard_key(pack, 0))
    assert repo._ec_present(pack) is False
    assert repo.ec_reconstruct(pack) == body  # the memo holds it
    assert trepo.Repository.open(repo.store, device="cpu")._ec_present(
        pack) is False
    with pytest.raises(tstore.NoSuchKey, match="fewer than k"):
        trepo.Repository.open(repo.store, device="cpu").ec_reconstruct(pack)


def test_fault_seed_wraps_local_stores(monkeypatch, tmp_path):
    monkeypatch.setenv("VOLSYNC_FAULT_SEED", "7")
    monkeypatch.setenv("VOLSYNC_FAULT_SPEC", "latency:p=1,ms=0")
    for url, inner in (("mem:", tstore.MemObjectStore),
                       (f"file://{tmp_path}", tstore.FsObjectStore),
                       (str(tmp_path), tstore.FsObjectStore)):
        store = tstore.open_store(url)
        assert isinstance(store, tfault.FaultStore)
        assert store.schedule.seed == 7
        assert [s.kind for s in store.schedule.specs] == ["latency"]
        assert isinstance(tstore.unwrap(store), inner)
        assert tstore.unwrap(tres.ResilientStore(store)) is store.inner
    monkeypatch.delenv("VOLSYNC_FAULT_SPEC")
    assert tstore.open_store("mem:").schedule.specs == \
        tfault.default_specs()
    monkeypatch.setenv("VOLSYNC_FAULT_SEED", "seven")
    with pytest.raises(ValueError, match="not an integer"):
        tstore.open_store("mem:")


def test_local_stores_open(tmp_path):
    assert isinstance(tstore.open_store("mem:"), tstore.MemObjectStore)
    fs = tstore.open_store(f"file://{tmp_path / 'a'}")
    assert isinstance(fs, tstore.FsObjectStore) and fs.root == tmp_path / "a"
    fs.put("data/ab/x", [b"he", memoryview(b"llo")])
    assert tstore.open_store(str(tmp_path / "a")).get("data/ab/x") == b"hello"
    assert tstore.unwrap(tres.ResilientStore(fs)) is fs


# -- stand-ins ----------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_trace_context_crosses_threads_only_when_carried(pkg):
    obs = tobs if pkg == "port" else jobs
    seen = {}

    def probe(tag):
        with obs.span(f"seam.{pkg}.{tag}"):
            seen[tag] = obs.current_context()

    with obs.trace_context(tenant=f"t-{pkg}") as ctx:
        with ThreadPoolExecutor(1) as pool:
            pool.submit(probe, "bare").result()
            pool.submit(obs.carry_context(probe), "carried").result()
        t = threading.Thread(target=lambda: probe("thread"))
        t.start()
        t.join()
        captured = obs.current_context()
    with obs.use_context(captured):
        probe("used")
    with obs.use_context(None):
        probe("none")
    assert seen["bare"] is None and seen["thread"] is None
    assert seen["none"] is None
    for tag in ("carried", "used"):
        assert seen[tag].trace_id == ctx.trace_id
        assert seen[tag].tenant == f"t-{pkg}"
        assert seen[tag].span_id != ctx.span_id  # the span is the parent
    by_tenant = (TMETRICS.svc_stage_seconds.values() if pkg == "port"
                 else obs.stage_seconds_by_tenant())
    assert (f"t-{pkg}", f"seam.{pkg}.carried") in by_tenant
    assert (f"t-{pkg}", f"seam.{pkg}.bare") not in by_tenant
    assert obs.carry_context(probe) is probe  # nothing to carry


def test_record_trigger_and_metrics_stand_ins():
    with tobs.trace_context() as ctx:
        tobs.record_trigger("seam_test", pack="p1")
    last = tobs.triggers()[-1]
    assert last["reason"] == "seam_test" and last["args"] == {"pack": "p1"}
    assert last["trace_id"] == ctx.trace_id
    fam = TMETRICS.retry_attempts
    before = fam.labels(site="seam", outcome="ok").value
    tres.RetryPolicy(site="seam").call(lambda: 1)
    assert fam.labels(site="seam", outcome="ok").value == before + 1
    with pytest.raises(ValueError):
        fam.labels(site="seam")
    TMETRICS.repo_lock_age.set(3.5)
    assert TMETRICS.repo_lock_age.values() == {(): 3.5}
    assert TMETRICS.repo_lock_age.name == "volsync_repo_lock_age_seconds"
    lock = tlock.make_lock("x")
    rlock = tlock.make_rlock("y")
    with lock, rlock, rlock:
        tlock.assert_held(lock, "anything")


def test_retry_classification_matches_reference():
    class Status(Exception):
        def __init__(self, status):
            self.status = status

    cases = [ConnectionError(), TimeoutError(), KeyError("k"),
             ValueError(), FileNotFoundError(), OSError(), Status(503),
             Status(404)]
    assert [tres.classify(e) for e in cases] == \
        [jres.classify(e) for e in cases]
    assert tres.classify(tres.ThrottleError()) is True
    assert jres.classify(jres.ThrottleError()) is True
    assert tres.classify(tstore.NoSuchKey("k")) is False
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("reset")
        return "ok"

    policy = tres.RetryPolicy(site="seam.flaky", max_attempts=4,
                              base_delay=0.001, max_delay=0.002)
    assert policy.call(flaky) == "ok" and policy.last_attempts == 3


# -- env knobs ----------------------------------------------------------------

KNOBS = {  # function -> (variable, a set value)
    "pipeline_enabled": ("VOLSYNC_TPU_PIPELINE", "0"),
    "readahead_segments": ("VOLSYNC_TPU_READAHEAD", "5"),
    "seal_workers": ("VOLSYNC_TPU_SEAL_WORKERS", "3"),
    "seal_queue_limit": ("VOLSYNC_TPU_SEAL_QUEUE", "7"),
    "upload_window": ("VOLSYNC_TPU_UPLOAD_WINDOW", "9"),
    "upload_retries": ("VOLSYNC_TPU_UPLOAD_RETRIES", "0"),
    "pack_copies": ("VOLSYNC_PACK_COPIES", "5"),
    "ec_scheme": ("VOLSYNC_EC_SCHEME", "4+2"),
    "index_shards": ("VOLSYNC_INDEX_SHARDS", "5"),
    "index_prefilter": ("VOLSYNC_INDEX_PREFILTER", "off"),
    "lock_stale_seconds": ("VOLSYNC_LOCK_STALE_S", "12.5"),
    "prune_grace_seconds": ("VOLSYNC_PRUNE_GRACE_S", "0"),
    "retry_attempts": ("VOLSYNC_RETRY_ATTEMPTS", "2"),
    "retry_base_delay": ("VOLSYNC_RETRY_BASE_MS", "7"),
    "retry_max_delay": ("VOLSYNC_RETRY_MAX_MS", "70"),
    "retry_deadline": ("VOLSYNC_RETRY_DEADLINE_S", "3"),
    "breaker_threshold": ("VOLSYNC_BREAKER_THRESHOLD", "2"),
    "breaker_reset_seconds": ("VOLSYNC_BREAKER_RESET_S", "4"),
    "fault_seed": ("VOLSYNC_FAULT_SEED", "7"),
    "fault_spec": ("VOLSYNC_FAULT_SPEC", "transient:p=0.5"),
    "scrub_interval_seconds": ("VOLSYNC_SCRUB_INTERVAL_S", "2.5"),
    "scrub_packs_per_cycle": ("VOLSYNC_SCRUB_PACKS", "3"),
    "repack_dead_ratio": ("VOLSYNC_REPACK_DEAD_RATIO", "0.5"),
    "repack_interval_seconds": ("VOLSYNC_REPACK_INTERVAL_S", "7"),
    "repack_packs_per_cycle": ("VOLSYNC_REPACK_PACKS", "2"),
    "backup_workers": ("VOLSYNC_BACKUP_WORKERS", "6"),
    "plan_full_blob_cap": ("VOLSYNC_PLAN_FULL_CAP", "100"),
    "restore_workers": ("VOLSYNC_RESTORE_WORKERS", "2"),
    "restore_fetchers": ("VOLSYNC_RESTORE_FETCHERS", "3"),
    "restore_fetch_window": ("VOLSYNC_RESTORE_FETCH_WINDOW", "2"),
    "restore_cache_mb": ("VOLSYNC_RESTORE_CACHE_MB", "64"),
    "restore_pipeline_enabled": ("VOLSYNC_RESTORE_PIPELINE", "false"),
    "device_verify_enabled": ("VOLSYNC_DEVICE_VERIFY", "0"),
    "scrub_read_repair_enabled": ("VOLSYNC_SCRUB_READ_REPAIR", "0"),
}


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_env_knobs_read_as_in_the_reference(monkeypatch, name):
    """Same variable, default and parse: one environment configures both
    packages alike."""
    from volsync_tpu import envflags as jenv
    from volsync_tpu_torch import envflags as tenv

    var, value = KNOBS[name]
    monkeypatch.delenv(var, raising=False)
    default = getattr(tenv, name)()
    assert default == getattr(jenv, name)()
    monkeypatch.setenv(var, value)
    assert getattr(tenv, name)() == getattr(jenv, name)() != default
