"""The port's rclone mover against the JAX package's, on the CPU.

The same seeded tree goes through both packages' ``sync_up`` into two
in-memory buckets, which must hold the same keys with identical bytes
(objects, index shards, manifest; no lock left), also when a file takes
the streamed branch. Each package's ``sync_down`` restores the other's
bucket, and after an edit both packages' second syncs report equal
stats. The data-plane cases of ``tests/test_e2e_rclone.py`` that need no
operator (hostile index paths, the mirror lease, the sharded index, the
legacy v1 index, a missing shard, owners and xattrs, the mirror round
trip with deletes, a destination synced in place) run in both packages,
and ``rclone_entrypoint`` runs through an ``rclone.conf`` naming each
package's fake S3. The port runs with ``device="cpu"`` and one transfer
thread where it hashes (its CPU twins slow under threads).
"""

import json
import os
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from volsync_tpu.cluster.runner import JobContext as JJobContext
from volsync_tpu.engine import chunker as jchunker
from volsync_tpu.movers.rclone import entry as jentry
from volsync_tpu.movers.rclone import sync as jsync
from volsync_tpu.objstore import fakes3 as jfakes3
from volsync_tpu.objstore import store as jstore
from volsync_tpu_torch import resilience as tres
from volsync_tpu_torch.cluster.runner import JobContext
from volsync_tpu_torch.engine import chunker as tchunker
from volsync_tpu_torch.movers import rclone as trclone
from volsync_tpu_torch.movers.rclone import entry as tentry
from volsync_tpu_torch.movers.rclone import sync as tsync
from volsync_tpu_torch.objstore import fakes3 as tfakes3
from volsync_tpu_torch.objstore import store as tstore

torch.set_num_threads(1)

PKGS = {
    "port": SimpleNamespace(sync=tsync, entry=tentry, store=tstore,
                            fakes3=tfakes3, chunker=tchunker, kw={
                                "device": "cpu", "transfers": 1}),
    "ref": SimpleNamespace(sync=jsync, entry=jentry, store=jstore,
                           fakes3=jfakes3, chunker=jchunker,
                           kw={"transfers": 1}),
}


@pytest.fixture(autouse=True)
def _fresh_port_breakers():
    yield
    tres.reset_breakers()


def _up(pkg, root, store, prefix="p"):
    m = PKGS[pkg]
    return m.sync.sync_up(root, store, prefix, **m.kw)


def _down(pkg, store, root, prefix="p"):
    m = PKGS[pkg]
    return m.sync.sync_down(store, prefix, root, **m.kw)


def _make_tree(root: Path, seed: int) -> None:
    """A small seeded tree: files in nested directories, a byte copy,
    empty files, a mid file, symlinks (one to a directory), an empty
    directory, modes, a fixed directory mtime and an xattr."""
    rng = np.random.default_rng(seed)
    for i in range(12):
        p = root / f"d{i % 3}" / ("deep" if i % 4 == 0 else "") / f"f{i}.bin"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(rng.bytes(int(rng.integers(1, 9000))))
        if i % 5 == 0:
            os.chmod(p, 0o600)
    (root / "d1" / "copy.bin").write_bytes((root / "d0" / "deep" / "f0.bin")
                                           .read_bytes())
    (root / "e1").write_bytes(b"")
    (root / "d2" / "e2").write_bytes(b"")
    (root / "mid.bin").write_bytes(rng.bytes(70_000))
    os.symlink("d0/f3.bin", root / "link")
    os.symlink("d1", root / "dlink")
    (root / "emptydir").mkdir()
    os.setxattr(root / "d1" / "f1.bin", "user.tag", b"v1")
    os.utime(root / "d2", ns=(1_600_000_000 * 10**9,) * 2)


def _state(root: Path) -> dict:
    """rel -> kind, mode, mtime (not for symlinks), bytes or target,
    xattrs: what a mirror must carry."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            p = Path(dirpath) / name
            st = p.lstat()
            rel = p.relative_to(root).as_posix()
            xattrs = sorted((n, os.getxattr(p, n, follow_symlinks=False))
                            for n in os.listxattr(p, follow_symlinks=False))
            if p.is_symlink():
                out[rel] = ("link", os.readlink(p), xattrs)
            elif p.is_dir():
                out[rel] = ("dir", st.st_mode & 0o7777, st.st_mtime_ns,
                            xattrs)
            else:
                out[rel] = ("file", st.st_mode & 0o7777, st.st_mtime_ns,
                            p.read_bytes(), xattrs)
    return out


def _objects(store) -> dict:
    return {k: store.get(k) for k in store.list()}


def _buckets(tmp_path, seed=5):
    src = tmp_path / "src"
    _make_tree(src, seed)
    buckets = {"port": tstore.MemObjectStore(), "ref": jstore.MemObjectStore()}
    stats = {pkg: _up(pkg, src, buckets[pkg]) for pkg in PKGS}
    return src, buckets, stats


# -- bucket for bucket ---------------------------------------------------------

@pytest.mark.parametrize("streamed", [False, True],
                         ids=["batched", "streamed"])
def test_buckets_equal_byte_for_byte(tmp_path, monkeypatch, streamed):
    """Both packages' ``sync_up`` of one tree give buckets with the same
    keys and identical bytes: objects, index shards and manifest, no
    lock left. ``streamed``: files over 64 KiB take
    ``hash_file_streaming`` in both packages."""
    if streamed:
        for m in PKGS.values():
            monkeypatch.setattr(m.sync, "_STREAM_THRESHOLD", 64 * 1024)
    calls = {pkg: [] for pkg in PKGS}
    for pkg, m in PKGS.items():
        orig = m.sync.hash_file_streaming
        monkeypatch.setattr(m.sync, "hash_file_streaming",
                            lambda *a, _o=orig, _c=calls[pkg], **k:
                            _c.append(a[0]) or _o(*a, **k))
    src, buckets, stats = _buckets(tmp_path)
    assert stats["port"] == stats["ref"]
    assert stats["port"]["uploaded"] == stats["port"]["files"] - 2
    got = {pkg: _objects(b) for pkg, b in buckets.items()}
    assert got["port"] == got["ref"]
    assert not any("/locks/" in k for k in got["port"])
    assert {k.split("/")[1] for k in got["port"]} == {"objects", "index"}
    want = [src / "mid.bin"] if streamed else []
    assert calls["port"] == calls["ref"] == want


@pytest.mark.parametrize("reader", ["port", "ref"])
def test_sync_down_restores_the_other_packages_bucket(tmp_path, reader):
    """Each package's ``sync_down`` rebuilds the tree from the bucket
    the other package wrote: bytes, modes, mtimes, symlink targets,
    empty directories and xattrs."""
    src, buckets, _ = _buckets(tmp_path)
    writer = "ref" if reader == "port" else "port"
    stats = _down(reader, buckets[writer], tmp_path / "dst")
    assert _state(tmp_path / "dst") == _state(src)
    assert stats["fetched"] == stats["files"] and stats["skipped"] == 0


def test_second_sync_stats_equal(tmp_path):
    """After an edit (a rewrite at the same size, a delete, an add, an
    append, a chmod) both packages' second ``sync_up`` and ``sync_down``
    report equal stats, the buckets stay equal and both destinations
    equal the edited tree."""
    src, buckets, _ = _buckets(tmp_path)
    dsts = {pkg: tmp_path / f"dst-{pkg}" for pkg in PKGS}
    for pkg in PKGS:
        _down(pkg, buckets[pkg], dsts[pkg])
    rng = np.random.default_rng(9)
    f = src / "d0" / "f3.bin"
    f.write_bytes(rng.bytes(f.stat().st_size))
    (src / "d2" / "f2.bin").unlink()
    (src / "new").mkdir()
    (src / "new" / "n.bin").write_bytes(rng.bytes(3000))
    with open(src / "mid.bin", "ab") as fh:
        fh.write(rng.bytes(4097))
    os.chmod(src / "d1" / "f1.bin", 0o640)
    up = {pkg: _up(pkg, src, buckets[pkg]) for pkg in PKGS}
    assert up["port"] == up["ref"]
    assert (up["port"]["uploaded"], up["port"]["deleted_objects"]) == (3, 3)
    assert _objects(buckets["port"]) == _objects(buckets["ref"])
    down = {pkg: _down(pkg, buckets[pkg], dsts[pkg]) for pkg in PKGS}
    assert down["port"] == down["ref"]
    assert (down["port"]["fetched"], down["port"]["deleted_local"]) == (3, 1)
    assert _state(dsts["port"]) == _state(dsts["ref"]) == _state(src)


def test_hash_files_digests_equal(tmp_path, monkeypatch):
    """``hash_files`` gives the reference's digests, through small
    batches (several flushes) and the streamed branch."""
    src = tmp_path / "src"
    _make_tree(src, 11)
    rels = sorted(r for r, v in _state(src).items() if v[0] == "file")
    for m in PKGS.values():
        monkeypatch.setattr(m.sync, "_BATCH_BYTES", 20_000)
        monkeypatch.setattr(m.sync, "_STREAM_THRESHOLD", 50_000)
    assert tsync.hash_files(src, rels, device="cpu") == \
        jsync.hash_files(src, rels)


# -- data-plane cases of tests/test_e2e_rclone.py ------------------------------

@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_hostile_index_paths_rejected(pkg, tmp_path):
    """A crafted index must not write outside the volume root."""
    m = PKGS[pkg]
    store = m.store.FsObjectStore(tmp_path / "bucket")
    store.put("p/index.json", json.dumps({"version": 1, "entries": {
        "../escape.txt": {"type": "file", "size": 1, "mode": 0o644,
                          "mtime_ns": 0, "digest": "d" * 64},
    }}).encode())
    with pytest.raises(m.sync.SyncError, match="unsafe"):
        _down(pkg, store, tmp_path / "dst")
    assert not (tmp_path / "escape.txt").exists()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_mirror_lease_blocks_concurrent_writers(pkg, tmp_path, rng):
    """A second writer is refused while the lease is held; a crashed
    holder's stale lease is swept; every lock object is released."""
    m = PKGS[pkg]
    store = m.store.MemObjectStore()
    root = tmp_path / "v"
    root.mkdir()
    (root / "f").write_bytes(rng.bytes(10_000))
    with m.sync._MirrorLease(store, "pfx"):
        with pytest.raises(m.sync.BucketLockedError):
            _up(pkg, root, store, "pfx")
    assert _up(pkg, root, store, "pfx")["files"] == 1
    store.put(m.sync._key("pfx", m.sync.LOCKS, "dead.json"), json.dumps(
        {"holder": "dead", "time": time.time() - 3600}).encode())
    assert _up(pkg, root, store, "pfx")["files"] == 1
    assert list(store.list(m.sync._key("pfx", m.sync.LOCKS))) == []


def test_mirror_lease_is_shared_across_packages(tmp_path, rng):
    """Both packages' leases are the same objects: a port writer backs
    off from a reference lease and the other way round."""
    root = tmp_path / "v"
    root.mkdir()
    (root / "f").write_bytes(rng.bytes(100))
    for holder, writer in (("ref", "port"), ("port", "ref")):
        store = PKGS[writer].store.MemObjectStore()
        with PKGS[holder].sync._MirrorLease(store, "pfx"):
            with pytest.raises(PKGS[writer].sync.BucketLockedError):
                _up(writer, root, store, "pfx")


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_sharded_index_incremental_writes(pkg, tmp_path, rng):
    """A second sync that touches one file rewrites only its directory's
    shard; an unchanged sync rewrites none; the merged index restores
    the tree."""
    m = PKGS[pkg]
    store = m.store.MemObjectStore()
    root = tmp_path / "vol"
    for d in range(8):
        for f in range(4):
            p = root / f"dir{d}" / f"f{f}.bin"
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(rng.bytes(2000))
    s1 = _up(pkg, root, store)
    assert s1["files"] == 32
    assert s1["index_shards_written"] == s1["index_shards"] >= 8
    (root / "dir3" / "f0.bin").write_bytes(rng.bytes(2500))
    s2 = _up(pkg, root, store)
    assert s2["index_shards_written"] == 1 and s2["uploaded"] == 1
    assert _up(pkg, root, store)["index_shards_written"] == 0
    stats = _down(pkg, store, tmp_path / "dst")
    assert stats["files"] == 32
    for d in range(8):
        for f in range(4):
            rel = f"dir{d}/f{f}.bin"
            assert (tmp_path / "dst" / rel).read_bytes() == \
                (root / rel).read_bytes()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_sharded_index_reads_legacy_v1(pkg, tmp_path, rng):
    """A v1 single-object index syncs down; the next sync_up migrates it
    to shards and removes index.json."""
    m = PKGS[pkg]
    store = m.store.MemObjectStore()
    root = tmp_path / "vol"
    root.mkdir()
    payload = rng.bytes(5000)
    (root / "a.bin").write_bytes(payload)
    kw = {"device": "cpu"} if pkg == "port" else {}
    digest = m.chunker.hash_file_streaming(root / "a.bin", **kw)
    store.put("p/objects/" + digest, payload)
    st = (root / "a.bin").lstat()
    store.put("p/index.json", json.dumps({"version": 1, "entries": {
        "a.bin": {"type": "file", "size": 5000, "mode": 0o644,
                  "mtime_ns": st.st_mtime_ns, "digest": digest}}}).encode())
    _down(pkg, store, tmp_path / "dst")
    assert (tmp_path / "dst" / "a.bin").read_bytes() == payload
    _up(pkg, root, store)
    assert not store.exists("p/index.json")
    assert store.exists("p/index/manifest.json")
    _down(pkg, store, tmp_path / "dst2")
    assert (tmp_path / "dst2" / "a.bin").read_bytes() == payload


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_sharded_index_missing_shard_is_error(pkg):
    m = PKGS[pkg]
    store = m.store.MemObjectStore()
    store.put("p/index/manifest.json", json.dumps(
        {"version": 2, "shards": {"ab": "ab-deadbeef.json"}}).encode())
    with pytest.raises(m.sync.SyncError, match="shard"):
        m.sync.read_index(store, "p")


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_mirror_carries_owner_and_xattrs(pkg, tmp_path, rng):
    """Owner and ACL-carrier xattrs round-trip through the bucket (the
    reference's getfacl-dump analogue)."""
    src, dst = tmp_path / "srcvol", tmp_path / "dstvol"
    src.mkdir()
    dst.mkdir()
    f = src / "f.bin"
    f.write_bytes(rng.bytes(40_000))
    os.setxattr(f, "user.acltag", b"rwx")
    if os.geteuid() == 0:
        os.chown(f, 4321, 8765)
    (src / "sub").mkdir()
    os.setxattr(src / "sub", "user.dirtag", b"d")
    store = PKGS[pkg].store.MemObjectStore()
    _up(pkg, src, store, "pfx")
    _down(pkg, store, dst, "pfx")
    assert os.getxattr(dst / "f.bin", "user.acltag") == b"rwx"
    assert os.getxattr(dst / "sub", "user.dirtag") == b"d"
    if os.geteuid() == 0:
        st = (dst / "f.bin").stat()
        assert (st.st_uid, st.st_gid) == (4321, 8765)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_mirror_roundtrip_and_delete_extraneous(pkg, tmp_path, rng):
    """The mirror round trip: identical files share one object, symlinks
    and empty directories and modes survive, and a second iteration
    follows a delete and a change."""
    m = PKGS[pkg]
    files = {"a.txt": b"alpha" * 2000, "sub/deep/b.bin": rng.bytes(25_000),
             "dup1.bin": b"same-bytes" * 1000,
             "dup2.bin": b"same-bytes" * 1000}
    src = tmp_path / "src"
    for rel, content in files.items():
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_bytes(content)
    (src / "emptydir").mkdir()
    os.symlink("a.txt", src / "link.txt")
    os.chmod(src / "a.txt", 0o640)
    store = m.store.FsObjectStore(tmp_path / "bucket")
    _up(pkg, src, store, "pvc1")
    _down(pkg, store, tmp_path / "dst", "pvc1")
    assert _state(tmp_path / "dst") == _state(src)
    assert len(list((tmp_path / "bucket" / "pvc1" / "objects").iterdir())) \
        == 3
    (src / "dup2.bin").unlink()
    (src / "a.txt").write_bytes(b"changed")
    _up(pkg, src, store, "pvc1")
    stats = _down(pkg, store, tmp_path / "dst", "pvc1")
    assert not (tmp_path / "dst" / "dup2.bin").exists()
    assert (tmp_path / "dst" / "a.txt").read_bytes() == b"changed"
    assert stats["deleted_local"] == 1 and stats["fetched"] == 1


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_destination_synced_in_place(pkg, tmp_path, rng):
    """Into a populated volume: extraneous data is removed, a matching
    file is skipped (checksum compare)."""
    m = PKGS[pkg]
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    dst.mkdir()
    keep = rng.bytes(10_000)
    (src / "keep.bin").write_bytes(keep)
    (src / "new.txt").write_bytes(b"hello")
    store = m.store.MemObjectStore()
    _up(pkg, src, store)
    (dst / "keep.bin").write_bytes(keep)
    (dst / "stale.txt").write_bytes(b"old")
    stats = _down(pkg, store, dst)
    assert (stats["skipped"], stats["fetched"], stats["deleted_local"]) == \
        (1, 1, 1)
    assert (dst / "new.txt").read_bytes() == b"hello"
    assert not (dst / "stale.txt").exists()


# -- the entry point -----------------------------------------------------------

def _ctx(pkg, env, data, conf):
    secrets = {} if conf is None else {
        "rclone-secret": {"rclone.conf": conf.encode()}}
    if pkg == "ref":
        return JJobContext(name="rclone", namespace="default", env=env,
                           mounts={"data": data}, secrets=secrets,
                           stop_event=threading.Event())
    return JobContext(name="rclone", namespace="default", env=env,
                      mounts={"data": data}, secrets=secrets,
                      stop_event=threading.Event(), device="cpu")


def _conf(srv) -> str:
    return (f"[bucket]\nurl = s3:{srv.endpoint}/bucket\n"
            f"access_key_id = {srv.access_key}\n"
            f"secret_access_key = {srv.secret_key}\n"
            f"endpoint = {srv.endpoint}\n")


@pytest.mark.parametrize("fake", ["port", "ref"])
def test_entry_through_each_fake_s3(fake, tmp_path, monkeypatch):
    """``rclone_entrypoint`` with an ``rclone.conf`` naming a fake S3:
    both packages return 0 in both directions with equal stats, and the
    two prefixes hold the same objects."""
    src = tmp_path / "src"
    _make_tree(src, 3)
    stats = {}
    for pkg, m in PKGS.items():
        for name in ("sync_up", "sync_down"):
            orig = getattr(m.entry, name)
            monkeypatch.setattr(
                m.entry, name,
                lambda *a, _o=orig, _k=(pkg, name), **kw:
                stats.setdefault(_k, _o(*a, **kw)))
    with PKGS[fake].fakes3.FakeS3Server() as srv:
        for pkg, m in PKGS.items():
            env = {"RCLONE_DEST_PATH": f"pvc-{pkg}",
                   "RCLONE_CONFIG_SECTION": "bucket", "TRANSFERS": "1"}
            up = _ctx(pkg, {**env, "DIRECTION": "source"}, src, _conf(srv))
            assert m.entry.rclone_entrypoint(up) == 0
            down = _ctx(pkg, {**env, "DIRECTION": "destination"},
                        tmp_path / f"dst-{pkg}", _conf(srv))
            assert m.entry.rclone_entrypoint(down) == 0
            assert _state(tmp_path / f"dst-{pkg}") == _state(src)
        objs = {pkg: {k.split("/", 1)[1]: v
                      for (_, k), v in srv._objects.items()
                      if k.startswith(f"pvc-{pkg}/")} for pkg in PKGS}
    assert objs["port"] == objs["ref"] and objs["port"]
    for name in ("sync_up", "sync_down"):
        assert stats[("port", name)] == stats[("ref", name)]


@pytest.mark.parametrize("case", ["no-conf", "no-section", "no-url",
                                  "bad-direction", "missing-env",
                                  "bad-url"])
@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_entry_config_errors_return_1(pkg, case, tmp_path):
    """A missing config secret, section or ``url``, an unknown
    DIRECTION, a missing required variable and a URL that cannot open
    each return 1, writing nothing."""
    data = tmp_path / "data"
    data.mkdir()
    env = {"RCLONE_DEST_PATH": "p", "DIRECTION": "source",
           "RCLONE_CONFIG_SECTION": "bucket"}
    conf = f"[bucket]\nurl = file://{tmp_path / 'bucket'}\n"
    if case == "no-conf":
        conf = None
    elif case == "no-section":
        env["RCLONE_CONFIG_SECTION"] = "nope"
    elif case == "no-url":
        conf = "[bucket]\ntype = s3\n"
    elif case == "bad-direction":
        env["DIRECTION"] = "sideways"
    elif case == "missing-env":
        del env["RCLONE_DEST_PATH"]
    else:
        conf = "[bucket]\nurl = s3://bucket/p\n"  # no AWS_S3_ENDPOINT
    assert PKGS[pkg].entry.rclone_entrypoint(
        _ctx(pkg, env, data, conf)) == 1
    assert not (tmp_path / "bucket").exists() or case == "bad-direction"


def test_package_exports():
    assert trclone.rclone_entrypoint is tentry.rclone_entrypoint
    assert (trclone.sync_up, trclone.sync_down, trclone.hash_files) == (
        tsync.sync_up, tsync.sync_down, tsync.hash_files)
    for name in ("INDEX_KEY", "INDEX_MANIFEST", "INDEX_SHARDS", "OBJECTS",
                 "LOCKS", "DEFAULT_TRANSFERS", "_BATCH_BYTES",
                 "_STREAM_THRESHOLD", "LOCK_STALE_SECONDS"):
        assert getattr(tsync, name) == getattr(jsync, name)
    for rel in ("a", "a/b", "x/y/z.bin"):
        assert tsync._shard_of(rel) == jsync._shard_of(rel)
