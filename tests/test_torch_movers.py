"""The port's mover entry points against the JAX package's, on the CPU.

The rsync mover's push scenarios of ``tests/test_delta_batch.py`` and
``tests/test_e2e_rsync.py`` run through both packages' ``_push_tree`` /
``_dest_verbs`` on the same seeded trees (the port on ``device="cpu"``,
its kernels' plain twins) and must leave byte-identical trees with the
same modes, mtimes, symlinks, hard links and holes; where the protocol
is pinned to delta the push stats must be equal too. Over loopback TCP
the port's source pushes into the reference's destination and the
reverse; the port's ``sig``/``sigs`` replies and sealed frames are the
reference's. The port's channel refuses malformed frames and foreign
versions, its standalone listener runs as its own process, and its
device keys are the reference's. The restic entry point gives the
reference's exit codes, snapshots and root trees, and repositories
restore across packages.

The planner's books are process-wide and learn from wall-clock link
samples, so every test starts both packages' books cold.
"""

import hashlib
import json
import os
import socket
import stat
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from volsync_tpu import resilience as jres
from volsync_tpu.cluster.runner import JobContext as JJobContext
from volsync_tpu.engine import syncstats as jstats
from volsync_tpu.metrics import GLOBAL as JMETRICS
from volsync_tpu.movers import base as jbase
from volsync_tpu.movers import devicetransport as jdt
from volsync_tpu.movers.restic import entry as jrestic
from volsync_tpu.movers.rsync import channel as jchannel
from volsync_tpu.movers.rsync import entry as jentry
from volsync_tpu.objstore.store import open_store as jopen_store
from volsync_tpu.repo.repository import Repository as JRepo
from volsync_tpu_torch import obs, resilience
from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.cluster.runner import JobContext
from volsync_tpu_torch.engine import syncstats
from volsync_tpu_torch.metrics import GLOBAL as METRICS
from volsync_tpu_torch.movers import base
from volsync_tpu_torch.movers import devicetransport as dt
from volsync_tpu_torch.movers.restic import entry as restic
from volsync_tpu_torch.movers.rsync import channel, entry
from volsync_tpu_torch.objstore.store import open_store
from volsync_tpu_torch.repo.repository import Repository

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKGS = ("ref", "port")


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


@pytest.fixture(autouse=True)
def _cold():
    """Both packages' planner books and link totals reset, and their
    dedup-query counters at 0 for the test (restored after)."""
    port = [METRICS.index_queries.labels(result=r) for r in ("hit", "miss")]
    ref = [JMETRICS.index_queries.labels(result=r) for r in ("hit", "miss")]
    saved = ([c.value for c in port], [c._value.get() for c in ref])
    for c in port:
        c.value = 0.0
    for c in ref:
        c._value.set(0.0)

    def reset():
        for mod in (syncstats, jstats):
            mod.reset_books()
        resilience.reset_link_totals()
        jres.reset_link_totals()

    reset()
    yield
    reset()
    for c, v in zip(port, saved[0]):
        c.value = v
    for c, v in zip(ref, saved[1]):
        c._value.set(v)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


#: The simulated link of ``_LinkClock``: latency a frame, bytes a second.
LINK_RTT_S = 1e-3
LINK_BPS = 50e6


class _LinkClock:
    """The ``time`` module of an entry module, with ``perf_counter`` on a
    virtual clock that only ``_Chan`` advances: each frame by
    ``LINK_RTT_S`` plus its literal bytes over ``LINK_BPS``. The
    planner's link samples, and so its choices, are then the same in
    every run and in both packages, whatever the machine's load."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


class _Chan:
    """Loopback channel: dispatch directly into the dest verb table (on
    ``clock``'s simulated link, where given)."""

    def __init__(self, verbs, clock=None):
        self.verbs = verbs
        self.reply = None
        self.clock = clock

    def send(self, msg):
        self.reply = self.verbs[msg["verb"]](msg)
        if self.clock is not None:
            lit = sum(len(op[1]) for op in msg.get("ops", ())
                      if op[0] == "data")
            self.clock.now += LINK_RTT_S + lit / LINK_BPS

    def recv(self):
        return self.reply


def _verbs(pkg: str, root: Path):
    if pkg == "ref":
        return jentry._dest_verbs(root)
    return entry._dest_verbs(root, device="cpu")


def _push(pkg: str, verbs, root: Path, clock=None) -> dict:
    if pkg == "ref":
        return jentry._push_tree(_Chan(verbs, clock), root)
    return entry._push_tree(_Chan(verbs, clock), root, device="cpu")


def _book(pkg: str):
    return (jstats if pkg == "ref" else syncstats).book_for("rsync")


def _tree_bytes(root: Path) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            p = Path(dirpath, name)
            out[str(p.relative_to(root))] = p.read_bytes()
    return out


def _tree_state(root: Path, with_root: bool = True) -> dict:
    """Every path under ``root`` (and the root itself, as ".", unless
    ``with_root`` is false: a restore leaves the root's own metadata
    alone): its type,
    permission bits, mtime, size, content digest, symlink target,
    xattrs, hard-link group (the lexicographically first name of its
    inode) and whether it is sparse (allocates under half its size)."""
    out = {}
    first_name: dict = {}
    paths = [root] * with_root + sorted(root.rglob("*"))
    for p in paths:
        rel = "." if p == root else str(p.relative_to(root))
        st = p.lstat()
        fmt = stat.S_IFMT(st.st_mode)
        entry_ = {"fmt": fmt, "mode": st.st_mode & 0o7777,
                  "mtime_ns": st.st_mtime_ns}
        if stat.S_ISREG(fmt):
            entry_["size"] = st.st_size
            entry_["sha256"] = hashlib.sha256(p.read_bytes()).hexdigest()
            entry_["sparse"] = st.st_blocks * 512 < st.st_size // 2
            entry_["link"] = first_name.setdefault(
                (st.st_dev, st.st_ino), rel)
        if stat.S_ISLNK(fmt):
            entry_["target"] = os.readlink(p)
        if not stat.S_ISLNK(fmt):
            entry_["xattrs"] = {n: os.getxattr(p, n)
                                for n in sorted(os.listxattr(p))}
        out[rel] = entry_
    return out


# ---------------------------------------------------------------------------
# The reference's push scenarios, in both packages
# ---------------------------------------------------------------------------


def _bidirectional(pkg: str, base_dir: Path, seed: int, clock) -> tuple:
    """tests/test_delta_batch.py::test_bidirectional_sync_converges_with_delta
    with its assertions, in ``pkg``, on ``clock``'s link; -> (stats of
    the three pushes, the trees' bytes)."""
    rng = np.random.default_rng(seed)
    a = base_dir / pkg / "a"
    b = base_dir / pkg / "b"
    a.mkdir(parents=True)
    b.mkdir()
    payload = rng.bytes(4 << 20)
    (a / "data.bin").write_bytes(payload)
    (a / "logs").mkdir()
    (a / "logs" / "app.log").write_bytes(rng.bytes(1 << 20))
    all_stats = []

    stats = _push(pkg, _verbs(pkg, b), a, clock)
    assert _tree_bytes(b) == _tree_bytes(a)
    assert stats["literal_bytes"] == stats["bytes"]
    all_stats.append(stats)

    edited = bytearray(payload)
    edited[1000:1050] = rng.bytes(50)
    (a / "data.bin").write_bytes(bytes(edited))
    with open(b / "logs" / "app.log", "ab") as f:
        f.write(rng.bytes(8_000))

    stats = _push(pkg, _verbs(pkg, b), a, clock)
    assert _tree_bytes(b) == _tree_bytes(a)
    assert stats["copied_bytes"] > 0, "delta never engaged A->B"
    assert stats["literal_bytes"] < len(payload) // 4
    all_stats.append(stats)

    with open(b / "logs" / "app.log", "ab") as f:
        f.write(rng.bytes(8_000))
    stats = _push(pkg, _verbs(pkg, a), b, clock)
    assert _tree_bytes(a) == _tree_bytes(b)
    assert stats["copied_bytes"] > 0, "delta never engaged B->A"
    assert stats["literal_bytes"] < stats["bytes"]
    all_stats.append(stats)

    assert _book(pkg).snapshot().delta_samples > 0
    return all_stats, _tree_bytes(a)


@pytest.mark.parametrize("proto", ["auto", "delta"])
def test_bidirectional_sync_converges_with_delta(tmp_path, monkeypatch,
                                                 proto):
    """Both packages converge the two trees in both directions, and their
    literal and copied bytes are equal push for push: pinned to delta,
    and under ``auto``, where the planner learns from link samples, on
    a simulated link (``_LinkClock``) so that both packages see the same
    samples whatever the machine's load."""
    if proto == "delta":
        monkeypatch.setenv("VOLSYNC_SYNC_PROTO", "delta")
    clock = _LinkClock()
    monkeypatch.setattr(entry, "time", clock)
    monkeypatch.setattr(jentry, "time", clock)
    ref_stats, ref_tree = _bidirectional("ref", tmp_path, 7, clock)
    port_stats, port_tree = _bidirectional("port", tmp_path, 7, clock)
    assert port_tree == ref_tree
    assert port_stats == ref_stats


def test_push_batch_respects_env_batch_size(tmp_path, monkeypatch):
    """tests/test_delta_batch.py::test_push_batch_respects_env_batch_size
    in both packages: VOLSYNC_DELTA_BATCH=1 sends a sig a file, 32 one
    sigs round trip for the batch; the destinations end equal."""
    seen_by = {}
    for pkg in PKGS:
        rng = np.random.default_rng(11)
        src = tmp_path / pkg / "src"
        dst = tmp_path / pkg / "dst"
        src.mkdir(parents=True)
        dst.mkdir()
        for i in range(5):
            (src / f"f{i}.bin").write_bytes(rng.bytes(20_000))
        seen = {"sig": 0, "sigs": 0}
        verbs = _verbs(pkg, dst)
        real_sig, real_sigs = verbs["sig"], verbs["sigs"]

        def count(name, real):
            def handler(m):
                seen[name] += 1
                return real(m)
            return handler

        verbs["sig"] = count("sig", real_sig)
        verbs["sigs"] = count("sigs", real_sigs)
        monkeypatch.setenv("VOLSYNC_DELTA_BATCH", "1")
        _push(pkg, verbs, src)
        assert seen == {"sig": 5, "sigs": 0}
        assert _tree_bytes(dst) == _tree_bytes(src)
        for i in range(5):
            with open(src / f"f{i}.bin", "ab") as f:
                f.write(b"delta")
        monkeypatch.setenv("VOLSYNC_DELTA_BATCH", "32")
        seen.update(sig=0, sigs=0)
        _push(pkg, verbs, src)
        assert seen["sig"] == 0
        assert seen["sigs"] == 1
        assert _tree_bytes(dst) == _tree_bytes(src)
        seen_by[pkg] = dict(seen)
        monkeypatch.delenv("VOLSYNC_DELTA_BATCH")
    assert seen_by["port"] == seen_by["ref"]
    assert _tree_bytes(tmp_path / "port" / "dst") == \
        _tree_bytes(tmp_path / "ref" / "dst")


def _fidelity_tree(src: Path, rng) -> int:
    """tests/test_e2e_rsync.py's fidelity tree: a hard link, a FIFO, a
    socket, an xattr, owner, a sparse file, a symlink and a dated
    directory. -> the directory's mtime."""
    src.mkdir(parents=True)
    payload = rng.bytes(80_000)
    (src / "a.bin").write_bytes(payload)
    os.link(src / "a.bin", src / "b.bin")
    os.mkfifo(src / "pipe", 0o640)
    s = socket.socket(socket.AF_UNIX)
    s.bind(str(src / "sock"))
    s.close()
    os.setxattr(src / "a.bin", "user.tag", b"v1")
    os.symlink("a.bin", src / "link")
    sub = src / "sub"
    sub.mkdir()
    with open(sub / "sparse.img", "wb") as f:
        f.write(b"x" * 4096)
        f.seek(8 << 20, os.SEEK_CUR)
        f.write(b"y" * 4096)
    if os.geteuid() == 0:
        os.chown(src / "a.bin", 1234, 5678)
    dir_mtime = 1_600_000_000_000_000_000
    os.utime(sub, ns=(dir_mtime, dir_mtime))
    return dir_mtime


def test_rsync_plane_fidelity_hardlinks_specials_sparse(tmp_path):
    """tests/test_e2e_rsync.py::test_rsync_plane_fidelity_hardlinks_specials_sparse
    with its assertions in both packages, from one source tree: the two
    destinations' states (types, modes, mtimes, xattrs, hard links,
    holes, symlinks) are equal, and equal to the source's."""
    src = tmp_path / "src"
    dir_mtime = _fidelity_tree(src, np.random.default_rng(3))
    payload = (src / "a.bin").read_bytes()
    states = {}
    for pkg in PKGS:
        dst = tmp_path / pkg
        dst.mkdir()
        _push(pkg, _verbs(pkg, dst), src)
        assert (dst / "a.bin").read_bytes() == payload
        assert (dst / "a.bin").stat().st_ino == (dst / "b.bin").stat().st_ino
        assert stat.S_ISFIFO((dst / "pipe").lstat().st_mode)
        assert (dst / "pipe").lstat().st_mode & 0o7777 == 0o640
        assert stat.S_ISSOCK((dst / "sock").lstat().st_mode)
        assert os.getxattr(dst / "a.bin", "user.tag") == b"v1"
        if os.geteuid() == 0:
            st = (dst / "a.bin").stat()
            assert (st.st_uid, st.st_gid) == (1234, 5678)
        out = dst / "sub" / "sparse.img"
        assert out.stat().st_size == 8192 + (8 << 20)
        assert out.stat().st_blocks * 512 < out.stat().st_size // 2
        assert (dst / "sub").stat().st_mtime_ns == dir_mtime
        states[pkg] = _tree_state(dst)
    assert states["port"] == states["ref"]
    assert states["port"] == _tree_state(src)


def test_wire_compression_z(tmp_path):
    """tests/test_e2e_rsync.py::test_wire_compression_z on the port's
    Framed: a compressible frame shrinks under the compressed flag and
    round-trips; an incompressible one stays raw."""
    rng = np.random.default_rng(5)
    a, b = socket.socketpair()
    box = channel.box_from_key(b"k" * 32)
    fa = channel.Framed(a, box)
    fb = channel.Framed(b, box)
    fa.send({"verb": "apply", "ops": [["data", b"A" * 1_000_000]]})
    (n,) = struct.unpack(">I", fb._read_exact(4))
    assert n < 100_000, n
    plain = box.open(fb._read_exact(n))
    assert plain[:1] == channel._FLAG_ZSTD
    rnd = {"verb": "apply", "ops": [["data", rng.bytes(30_000)]]}
    fa.send(rnd)
    (n,) = struct.unpack(">I", fb._read_exact(4))
    plain = box.open(fb._read_exact(n))
    assert plain[:1] == channel._FLAG_RAW
    fa.send(rnd)
    assert fb.recv()["ops"][0][1] == rnd["ops"][0][1]
    a.close()
    b.close()


def test_one_file_system_x(tmp_path):
    """tests/test_e2e_rsync.py::test_one_file_system_x in both packages:
    a mount point replicates as an empty dir and its contents never
    cross (a real tmpfs mount where CAP_SYS_ADMIN allows)."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "normal.txt").write_bytes(b"stay")
    mnt = src / "mnt"
    mnt.mkdir()
    r = subprocess.run(["mount", "-t", "tmpfs", "tmpfs", str(mnt)],
                       capture_output=True)
    if r.returncode != 0:
        pytest.skip("cannot mount tmpfs (no CAP_SYS_ADMIN)")
    try:
        (mnt / "foreign.txt").write_bytes(b"cross me not")
        trees = {}
        for pkg in PKGS:
            dst = tmp_path / pkg
            dst.mkdir()
            _push(pkg, _verbs(pkg, dst), src)
            assert (dst / "normal.txt").read_bytes() == b"stay"
            assert (dst / "mnt").is_dir()
            assert not (dst / "mnt" / "foreign.txt").exists()
            trees[pkg] = sorted(str(p.relative_to(dst))
                                for p in dst.rglob("*"))
        assert trees["port"] == trees["ref"] == ["mnt", "normal.txt"]
    finally:
        subprocess.run(["umount", str(mnt)], capture_output=True)


# ---------------------------------------------------------------------------
# The wire: the port and the reference talk to each other
# ---------------------------------------------------------------------------


def _ctx(cls, env: dict, root: Path, keys: dict, **kw):
    return cls(name="rsync-src", namespace="default", env=env,
               mounts={"data": root}, secrets={"keys": keys},
               stop_event=threading.Event(), **kw)


def _listen(serve, *args, **kw) -> tuple:
    """Start ``serve(*args, on_port=..., **kw)`` in a thread; -> (thread,
    result dict holding "rc" when it returns, the bound port)."""
    got = {}
    ready = threading.Event()

    def on_port(port):
        got["port"] = port
        ready.set()

    def run():
        got["rc"] = serve(*args, on_port=on_port, **kw)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert ready.wait(30)
    return t, got


def _seed_tree(root: Path, rng, edits: bool = False,
               link: bool = False) -> None:
    root.mkdir(parents=True, exist_ok=True)
    (root / "sub").mkdir(exist_ok=True)
    files = {"a.bin": rng.bytes(120_000), "sub/b.txt": b"beta" * 999,
             "c.bin": rng.bytes(300_000), "empty": b""}
    for rel, data in files.items():
        if edits and rel == "c.bin":
            data = data[:1000] + b"edit" + data[1004:]
        (root / rel).write_bytes(data)
    if link and not (root / "ln").is_symlink():
        os.symlink("a.bin", root / "ln")


@pytest.mark.parametrize("source,dest", [("port", "ref"), ("ref", "port")])
def test_wire_interop_over_loopback(tmp_path, source, dest):
    """The ``source`` package's ``rsync_source_entrypoint`` pushes into
    the ``dest`` package's ``serve_destination`` over loopback TCP with
    device keys: both end with rc 0, twice (a push against a basis,
    then a delta push after edits), and the destination equals the
    source. (The trees hold no symlink: the reference's destination
    cannot sync one twice, see ``test_resync_keeps_a_symlinks_target``.)"""
    src = tmp_path / "src"
    dst = tmp_path / "dst"
    dst.mkdir()
    _seed_tree(dst, np.random.default_rng(21))  # a basis to delta against
    src_priv, dst_priv = dt.generate_device_key(), dt.generate_device_key()
    keys = {"source": src_priv,
            "destination-id": dt.device_id_from_private(dst_priv).encode()}
    for edits in (False, True):
        _seed_tree(src, np.random.default_rng(21), edits=edits)
        if dest == "ref":
            t, got = _listen(jentry.serve_destination, dst, dst_priv,
                             jdt.device_id_from_private(src_priv))
        else:
            t, got = _listen(entry.serve_destination, dst, dst_priv,
                             dt.device_id_from_private(src_priv),
                             device="cpu")
        env = {"ADDRESS": "127.0.0.1", "PORT": str(got["port"]),
               "FAST_RETRY": "1"}
        if source == "port":
            rc = entry.rsync_source_entrypoint(
                _ctx(JobContext, env, src, keys, device="cpu"))
        else:
            rc = jentry.rsync_source_entrypoint(
                _ctx(JJobContext, env, src, keys))
        t.join(30)
        assert rc == 0 and got["rc"] == 0
        assert _tree_state(dst) == _tree_state(src)


def test_resync_keeps_a_symlinks_target(tmp_path):
    """A second sync of a tree with a symlink replaces the link, not its
    target: the port's destination ends equal to the source. (The
    reference's ``_safe_join`` follows the existing link, so its second
    sync turns ``a.bin`` into a link to itself: ROADMAP queue 3.)"""
    src = tmp_path / "src"
    dst = tmp_path / "dst"
    dst.mkdir()
    for edits in (False, True):
        _seed_tree(src, np.random.default_rng(22), edits=edits, link=True)
        _push("port", _verbs("port", dst), src)
        assert _tree_state(dst) == _tree_state(src)
    assert (dst / "ln").is_symlink() and not (dst / "a.bin").is_symlink()
    with pytest.raises(channel.ChannelError, match="escapes"):
        entry._safe_join(dst, "../x")
    with pytest.raises(channel.ChannelError, match="escapes"):
        entry._safe_join(dst, "sub/../..")
    assert entry._safe_join(dst, "sub/..") == dst.resolve()


def test_verbs_do_not_act_through_a_symlink_out_of_root(tmp_path):
    """A destination symlink to a directory or file outside root: no verb
    reaches the outside. ``dirmeta`` leaves the link alone, ``link``
    refuses a ``to`` that is a symlink, ``special`` replaces the link,
    and the outside directory's mode and mtime and its file's link
    count stay as they were."""
    outside = tmp_path / "outside"
    outside.mkdir()
    (outside / "f").write_bytes(b"secret")
    os.chmod(outside, 0o700)
    os.utime(outside, ns=(10**18, 10**18))
    before = outside.lstat()
    dst = tmp_path / "dst"
    dst.mkdir()
    os.symlink(outside, dst / "x")
    os.symlink(outside / "f", dst / "fl")
    verbs = entry._dest_verbs(dst, device="cpu")
    assert verbs["dirmeta"]({"dirs": [
        {"path": "x", "mode": 0o777, "mtime_ns": 0}]}) == {"verb": "ok"}
    with pytest.raises(channel.ChannelError, match="not a regular file"):
        verbs["link"]({"path": "h", "to": "fl"})
    assert not (dst / "h").exists()
    with pytest.raises(channel.ChannelError, match="escapes"):
        verbs["dirmeta"]({"dirs": [{"path": "x/f", "mode": 0o777}]})
    verbs["special"]({"path": "x", "fmt": stat.S_IFIFO, "mode": 0o600})
    assert stat.S_ISFIFO((dst / "x").lstat().st_mode)
    after = outside.lstat()
    assert (after.st_mode, after.st_mtime_ns) == (before.st_mode,
                                                   before.st_mtime_ns)
    assert (outside / "f").lstat().st_nlink == 1
    assert (outside / "f").read_bytes() == b"secret"
    # a replication root reached through a symlink keeps its own meta
    os.symlink(dst, tmp_path / "root-link")
    entry._dest_verbs(tmp_path / "root-link", device="cpu")["dirmeta"](
        {"dirs": [{"path": "", "mode": 0o750, "mtime_ns": 10**18}]})
    assert (dst.lstat().st_mode & 0o7777, dst.lstat().st_mtime_ns) == (
        0o750, 10**18)


def test_sig_replies_equal_the_reference(tmp_path):
    """The port's ``sig`` and ``sigs`` replies equal the reference's field
    for field, for files with no full block, several blocks, a tail,
    none at all, and a missing path."""
    rng = np.random.default_rng(8)
    root = tmp_path / "d"
    root.mkdir()
    sizes = {"zero": 0, "short": 100, "one": 4096, "tail": 20_000,
             "big": 70_001}
    for name, n in sizes.items():
        (root / name).write_bytes(rng.bytes(n))
    files = [{"path": n, "block_len": 4096} for n in sizes]
    files += [{"path": "big", "block_len": 8192}, {"path": "missing"}]
    msg = {"verb": "sigs", "files": files}
    ref, port = jentry._dest_verbs(root), entry._dest_verbs(root,
                                                              device="cpu")
    assert port["sigs"](msg) == ref["sigs"](msg)
    for f in files:
        one = {"verb": "sig", **f}
        assert port["sig"](one) == ref["sig"](one)


def test_port_frames_open_on_the_reference(tmp_path):
    """Frames the port seals open on the reference's Framed and the
    reverse: small raw, large compressible and large incompressible
    bodies, under the same channel key."""
    rng = np.random.default_rng(9)
    key = rng.bytes(32)
    objs = [{"verb": "hello", "nonce": rng.bytes(16)},
            {"verb": "apply", "ops": [["data", b"Z" * 200_000]],
             "mode": 0o644},
            {"verb": "apply", "ops": [["copy", 3, 2],
                                      ["data", rng.bytes(50_000)]]}]
    for send_mod, recv_mod in ((channel, jchannel), (jchannel, channel)):
        a, b = socket.socketpair()
        fa = send_mod.Framed(a, send_mod.box_from_key(key))
        fb = recv_mod.Framed(b, recv_mod.box_from_key(key))
        for obj in objs:
            t = threading.Thread(target=fa.send, args=(obj,))
            t.start()
            assert fb.recv() == obj
            t.join(10)
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# The channel's own checks, in the port
# ---------------------------------------------------------------------------


def test_channel_rejects_malformed_frames():
    """tests/test_network_plane.py::test_channel_rejects_malformed_frames
    on the port's channel: a wrong flag, a corrupt compressed body, an
    empty plaintext, a flipped seal and an oversized length all surface
    as ChannelError."""
    rng = np.random.default_rng(4)
    box = channel.box_from_key(b"q" * 32)
    cases = [
        (box.seal(b"\x07" + b"junk"), "unknown frame flag"),
        (box.seal(channel._FLAG_ZSTD + rng.bytes(64)), "bad compressed"),
        (box.seal(b""), "empty frame"),
        (box.seal(b"\x00" + b"hi")[:-1] + b"\x00", "authentication"),
        (box.seal(b"\x00" + b"\xc1"), "malformed frame body"),
    ]
    for payload, match in cases:
        a, b = socket.socketpair()
        a.sendall(struct.pack(">I", len(payload)) + payload)
        with pytest.raises(channel.ChannelError, match=match):
            channel.Framed(b, box).recv()
        a.close()
        b.close()
    a, b = socket.socketpair()
    a.sendall(struct.pack(">I", channel._MAX_FRAME + 1))
    with pytest.raises(channel.ChannelError, match="frame too large"):
        channel.Framed(b, box).recv()
    a.close()
    b.close()


def _read_exact(s, n):
    buf = b""
    while len(buf) < n:
        piece = s.recv(n - len(buf))
        if not piece:
            break
        buf += piece
    return buf


def test_channel_version_negotiation():
    """tests/test_network_plane.py::test_channel_version_negotiation on
    the port: same-version peers handshake (a port client with a
    reference server too); an old-version client is refused after the
    cleartext preamble; a future-version server draws an explicit
    version-mismatch error."""
    key = b"v" * 32
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    rcs = {}

    def serve(mod, name):
        conn, _ = srv.accept()
        rcs[name] = mod.serve_session(conn, key, {})

    for mod in (channel, jchannel):
        t = threading.Thread(target=serve, args=(mod, mod.__name__))
        t.start()
        ch = channel.client_connect("127.0.0.1", port, key)
        ch.send({"verb": "shutdown", "rc": 0})
        assert ch.recv() == {"verb": "ok"}
        t.join(10)
        assert rcs[mod.__name__] == 0

    t = threading.Thread(target=serve, args=(channel, "old"))
    t.start()
    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    sock.settimeout(10)
    sock.sendall(b"VSCH" + struct.pack(">I", channel.CHANNEL_VERSION - 1))
    peer = _read_exact(sock, 8)
    assert peer[:4] == b"VSCH"
    assert struct.unpack(">I", peer[4:])[0] == channel.CHANNEL_VERSION
    assert sock.recv(1) == b""
    sock.close()
    t.join(10)
    assert rcs["old"] is None

    def serve_future():
        conn, _ = srv.accept()
        conn.sendall(b"VSCH" + struct.pack(">I",
                                           channel.CHANNEL_VERSION + 1))
        conn.recv(8)
        conn.close()

    t = threading.Thread(target=serve_future)
    t.start()
    with pytest.raises(channel.ChannelError, match="version mismatch"):
        channel.client_connect("127.0.0.1", port, key)
    t.join(10)
    srv.close()


def test_rsync_across_two_processes(tmp_path):
    """tests/test_network_plane.py::test_rsync_across_two_processes on the
    port: its standalone listener (``--device cpu``) in a second OS
    process; a wrong device is refused at the handshake; the source
    half of the key split pushes a tree and the listener exits with the
    transferred rc."""
    rng = np.random.default_rng(6)
    src_priv = dt.generate_device_key()
    dst_priv = dt.generate_device_key()
    dest_root = tmp_path / "dest"
    dest_root.mkdir()
    key_file = tmp_path / "dst.key"
    key_file.write_bytes(dst_priv)
    proc = subprocess.Popen(
        [sys.executable, "-m", "volsync_tpu_torch.movers.rsync.standalone",
         "--root", str(dest_root), "--key-file", str(key_file),
         "--source-id", dt.device_id_from_private(src_priv),
         "--bind", "127.0.0.1", "--port", "0", "--device", "cpu"],
        stdout=subprocess.PIPE, text=True, cwd=str(ROOT),
        env={"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "PYTHONPATH": str(ROOT), "HOME": str(tmp_path),
             "OMP_NUM_THREADS": "1"})
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("PORT "), line
        port = int(line.split()[1])
        src_root = tmp_path / "src"
        (src_root / "sub").mkdir(parents=True)
        files = {"a.bin": rng.bytes(120_000), "sub/b.txt": b"beta" * 999}
        for rel, content in files.items():
            (src_root / rel).write_bytes(content)
        with pytest.raises(channel.ChannelError):
            dt.connect_device("127.0.0.1", port, dt.generate_device_key(),
                              dt.device_id_from_private(dst_priv),
                              timeout=3.0)
        ch = dt.connect_device("127.0.0.1", port, src_priv,
                               dt.device_id_from_private(dst_priv))
        stats = entry._push_tree(ch, src_root, device="cpu")
        ch.send({"verb": "shutdown", "rc": 0})
        ch.recv()
        ch.close()
        assert stats["files"] == 2
        assert proc.wait(timeout=30) == 0
        for rel, content in files.items():
            assert (dest_root / rel).read_bytes() == content
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()


# ---------------------------------------------------------------------------
# Device keys
# ---------------------------------------------------------------------------


def test_device_ids_equal_the_reference():
    rng = np.random.default_rng(2)
    for _ in range(3):
        priv = rng.bytes(64)
        assert dt.public_key(priv) == jdt.public_key(priv)
        assert dt.device_id_from_private(priv) == \
            jdt.device_id_from_private(priv)
    assert (dt.DH_P, dt.DH_G) == (jdt.DH_P, jdt.DH_G)


@pytest.mark.parametrize("server", ["port", "ref"])
def test_wrong_device_id_refused_at_handshake(server):
    """A dialer pinning the wrong ID refuses the peer (ChannelError); a
    listener refuses a dialer whose ID it does not know (None, and the
    dialer sees the hang-up). The right pair handshakes across
    packages."""
    mod = dt if server == "port" else jdt
    a_priv, b_priv = dt.generate_device_key(), dt.generate_device_key()
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    results = []

    def accept(known):
        conn, _ = srv.accept()
        results.append(mod.accept_device(conn, b_priv, known, timeout=5))

    cases = [  # (ids the listener knows, id the dialer pins, ok)
        ({dt.device_id_from_private(a_priv)}, "00" * 32, False),
        ({"11" * 32}, dt.device_id_from_private(b_priv), False),
        ({dt.device_id_from_private(a_priv)},
         dt.device_id_from_private(b_priv), True),
    ]
    for known, pinned, ok in cases:
        t = threading.Thread(target=accept, args=(known,))
        t.start()
        if ok:
            ch = dt.connect_device("127.0.0.1", port, a_priv, pinned)
            ch.send({"verb": "x"})
            ch.close()
        else:
            with pytest.raises(channel.ChannelError):
                dt.connect_device("127.0.0.1", port, a_priv, pinned,
                                  timeout=5)
        t.join(10)
    assert results[0] is None and results[1] is None
    chan, peer = results[2]
    assert peer == dt.device_id_from_private(a_priv)
    assert chan.recv() == {"verb": "x"}
    chan.close()
    srv.close()


# ---------------------------------------------------------------------------
# The restic mover's entry point
# ---------------------------------------------------------------------------


def _restic_tree(root: Path, rng) -> None:
    (root / "sub").mkdir(parents=True)
    (root / "big.bin").write_bytes(rng.bytes(700_000))
    (root / "sub" / "small.txt").write_bytes(b"small\n" * 300)
    (root / "sub" / "empty").write_bytes(b"")
    os.symlink("sub/small.txt", root / "ln")
    os.utime(root / "sub", ns=(1_600_000_000_000_000_000,) * 2)


def _restic(pkg: str, env: dict, data: Path) -> int:
    if pkg == "ref":
        return jrestic.restic_entrypoint(JJobContext(
            name="restic", namespace="default", env=env,
            mounts={"data": data}, secrets={},
            stop_event=threading.Event()))
    return restic.restic_entrypoint(JobContext(
        name="restic", namespace="default", env=env, mounts={"data": data},
        secrets={}, stop_event=threading.Event(), device="cpu"))


def _open(pkg: str, url: str, password):
    if pkg == "ref":
        return JRepo.open(jopen_store(url), password=password)
    return Repository.open(open_store(url), password=password, device="cpu")


@pytest.fixture
def one_worker(monkeypatch):
    monkeypatch.setenv("VOLSYNC_BACKUP_WORKERS", "1")
    monkeypatch.setenv("VOLSYNC_RESTORE_WORKERS", "1")


def test_restic_entry_backup_forget_prune_restore(tmp_path, one_worker):
    """The same env and tree through both packages' entry: a backup,
    edits, a second backup with FORGET_LAST=1 and PRUNE=1, and a restore
    into an empty directory give the same rcs, one snapshot left, the
    same root tree, and restored bytes equal to the source. Then each
    package's repository restores through the other package's entry."""
    src = tmp_path / "src"
    rng = np.random.default_rng(31)
    _restic_tree(src, rng)
    out = {}
    for pkg in PKGS:
        url = f"file://{tmp_path / ('repo-' + pkg)}"
        env = {"RESTIC_REPOSITORY": url, "RESTIC_PASSWORD": "pw",
               "HOSTNAME": "h"}
        out[pkg] = {"url": url, "rcs": [_restic(pkg, env, src)]}
    with open(src / "big.bin", "r+b") as f:
        f.seek(5000)
        f.write(rng.bytes(4096))
    (src / "sub" / "new.txt").write_bytes(b"new\n" * 100)
    state = _tree_state(src, with_root=False)
    for pkg in PKGS:
        env = {"RESTIC_REPOSITORY": out[pkg]["url"], "RESTIC_PASSWORD": "pw",
               "HOSTNAME": "h", "FORGET_LAST": "1", "PRUNE": "1"}
        out[pkg]["rcs"].append(_restic(pkg, env, src))
        snaps = _open(pkg, out[pkg]["url"], "pw").list_snapshots()
        out[pkg]["snaps"] = len(snaps)
        out[pkg]["tree"] = snaps[-1][1]["tree"]
        dst = tmp_path / ("restored-" + pkg)
        dst.mkdir()
        env = {"RESTIC_REPOSITORY": out[pkg]["url"], "RESTIC_PASSWORD": "pw",
               "DIRECTION": "restore"}
        out[pkg]["rcs"].append(_restic(pkg, env, dst))
        assert _tree_state(dst, with_root=False) == state
    for pkg in PKGS:
        out[pkg].pop("url")
    assert out["port"] == out["ref"]
    assert out["port"]["rcs"] == [0, 0, 0]
    assert out["port"]["snaps"] == 1
    for reader, writer in (("ref", "port"), ("port", "ref")):
        dst = tmp_path / f"cross-{writer}-{reader}"
        dst.mkdir()
        env = {"RESTIC_REPOSITORY": f"file://{tmp_path / ('repo-' + writer)}",
               "RESTIC_PASSWORD": "pw", "DIRECTION": "restore"}
        assert _restic(reader, env, dst) == 0
        assert _tree_state(dst, with_root=False) == state


def test_restic_entry_exit_codes(tmp_path, one_worker):
    """rc 2 without RESTIC_REPOSITORY and for an unknown DIRECTION, rc 3
    for a RESTORE_AS_OF before the first snapshot, rc 4 while another
    holder keeps the repository locked; rc 0 for an empty source, which
    writes no repository. Both packages alike."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "f.txt").write_bytes(b"x" * 5000)
    empty = tmp_path / "empty"
    empty.mkdir()
    rcs = {}
    for pkg in PKGS:
        url = f"file://{tmp_path / ('repo-' + pkg)}"
        env = {"RESTIC_REPOSITORY": url}
        got = [_restic(pkg, {}, src),
               _restic(pkg, {**env, "DIRECTION": "sideways"}, src),
               _restic(pkg, env, empty)]
        assert not (tmp_path / ("repo-" + pkg)).exists()
        got.append(_restic(pkg, env, src))
        dst = tmp_path / ("dst-" + pkg)
        dst.mkdir()
        got.append(_restic(pkg, {**env, "DIRECTION": "restore",
                                 "RESTORE_AS_OF": "2001-01-01T00:00:00"},
                           dst))
        holder = _open(pkg, url, None)
        with holder.lock(exclusive=True):
            got.append(_restic(pkg, {**env, "LOCK_WAIT_SECONDS": "0"}, src))
            got.append(_restic(pkg, {**env, "DIRECTION": "restore",
                                     "LOCK_WAIT_SECONDS": "0"}, dst))
        rcs[pkg] = got
    assert rcs["ref"] == [2, 2, 0, 0, 3, 4, 4]
    assert rcs["port"] == rcs["ref"]


def test_restic_entry_chunker_align_knob(tmp_path, one_worker):
    """VOLSYNC_CHUNKER_ALIGN=64 at creation gives the reference's chunker
    config and root tree; the stored config wins on reopen without the
    knob; an unknown align raises ValueError in both packages."""
    src = tmp_path / "src"
    _restic_tree(src, np.random.default_rng(41))
    trees = {}
    for pkg in PKGS:
        url = f"file://{tmp_path / ('r1-' + pkg)}"
        env = {"RESTIC_REPOSITORY": url, "VOLSYNC_CHUNKER_ALIGN": "64"}
        assert _restic(pkg, env, src) == 0
        repo = _open(pkg, url, None)
        assert repo.chunker_params["align"] == 64
        trees[pkg] = repo.list_snapshots()[-1][1]["tree"]
        mod = jrestic if pkg == "ref" else restic
        kw = {} if pkg == "ref" else {"device": "cpu"}
        assert mod._open_or_init({"RESTIC_REPOSITORY": url},
                                 **kw).chunker_params["align"] == 64
        with pytest.raises(ValueError, match="CHUNKER_ALIGN"):
            mod._open_or_init({"RESTIC_REPOSITORY": f"file://{tmp_path}/r2",
                               "VOLSYNC_CHUNKER_ALIGN": "512"}, **kw)
    assert trees["port"] == trees["ref"]


def test_restic_entry_parses_env_like_the_reference():
    for value in ("3h30m", "2d", "1h", "90", "1.5h"):
        assert restic._parse_within(value) == jrestic._parse_within(value)
    for bad in ("3x", "h"):
        with pytest.raises(ValueError):
            restic._parse_within(bad)
    env = {"FORGET_LAST": "2", "FORGET_DAILY": "7", "FORGET_WITHIN": "1d"}
    assert restic._forget_kwargs(env) == jrestic._forget_kwargs(env)
    assert restic.RC_LOCKED == jrestic.RC_LOCKED == 4
    for v in ("AUTO", " delta ", "bogus", None, "cdc"):
        assert base.normalize_protocol(v, default="cdc") == \
            jbase.normalize_protocol(v, default="cdc")


def test_restic_entry_mesh_engine_tree_id(tmp_path, one_worker):
    """VOLSYNC_ENGINE=mesh through the port's entry on device="cpu" (a
    one-shard mesh) backs up with ``MeshChunkHasher`` and leaves the
    root tree of the port's default engine and of the reference's."""
    src = tmp_path / "src"
    _restic_tree(src, np.random.default_rng(43))
    trees = {}
    for name, pkg, extra in (("mesh", "port", {"VOLSYNC_ENGINE": "mesh"}),
                             ("port", "port", {}), ("ref", "ref", {})):
        url = f"file://{tmp_path / ('repo-' + name)}"
        env = {"RESTIC_REPOSITORY": url, "RESTIC_PASSWORD": "pw", **extra}
        assert _restic(pkg, env, src) == 0
        trees[name] = _open(pkg, url, "pw").list_snapshots()[-1][1]["tree"]
    assert trees["mesh"] == trees["port"] == trees["ref"]
    assert not hasattr(restic, "UnportedEngineError")


def test_restic_entry_mesh_hasher_reused(tmp_path, one_worker,
                                         monkeypatch):
    """Two entry runs with VOLSYNC_ENGINE=mesh use one memoized
    MeshChunkHasher (one per chunker params and device), over a
    one-shard CPU mesh, and the second run dedups against the first."""
    from volsync_tpu_torch.parallel.sharded_chunker import MeshChunkHasher

    monkeypatch.setattr(restic, "_MESH_HASHERS", {})
    made = []
    real = restic._select_hasher

    def spy(env, repo, device=None):
        made.append(real(env, repo, device))
        return made[-1]

    monkeypatch.setattr(restic, "_select_hasher", spy)
    src = tmp_path / "src"
    _restic_tree(src, np.random.default_rng(44))
    url = f"file://{tmp_path / 'repo'}"
    env = {"RESTIC_REPOSITORY": url, "RESTIC_PASSWORD": "pw",
           "VOLSYNC_ENGINE": "mesh"}
    assert _restic("port", env, src) == 0
    assert _restic("port", env, src) == 0
    assert len(made) == 2 and made[0] is made[1]
    assert isinstance(made[0], MeshChunkHasher)
    assert [str(d) for d in made[0].mesh.local_devices] == ["cpu"]
    assert list(restic._MESH_HASHERS.values()) == [made[0]]
    snaps = _open("port", url, "pw").list_snapshots()
    assert len(snaps) == 2 and snaps[0][1]["tree"] == snaps[1][1]["tree"]


# ---------------------------------------------------------------------------
# device_trace
# ---------------------------------------------------------------------------


def test_device_trace_is_a_noop_without_trace_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("VOLSYNC_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with obs.device_trace("restic-backup"):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_device_trace_writes_a_trace(tmp_path, monkeypatch):
    """With VOLSYNC_TRACE_DIR set it writes one Chrome trace under
    <dir>/<label>, on the CPU of the host's torch operators, also when
    the region raises."""
    monkeypatch.setenv("VOLSYNC_TRACE_DIR", str(tmp_path))
    with obs.device_trace("restic-backup"):
        torch.ones(64).cumsum(0)
    files = list((tmp_path / "restic-backup").iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    with pytest.raises(KeyError):
        with obs.device_trace("failed"):
            raise KeyError("x")
    assert len(list((tmp_path / "failed").iterdir())) == 1


def test_restic_backup_runs_under_device_trace(tmp_path, monkeypatch,
                                               one_worker):
    """The entry's backup writes its trace under <dir>/restic-backup."""
    monkeypatch.setenv("VOLSYNC_TRACE_DIR", str(tmp_path / "traces"))
    src = tmp_path / "src"
    src.mkdir()
    (src / "f.txt").write_bytes(b"y" * 3000)
    env = {"RESTIC_REPOSITORY": f"file://{tmp_path / 'r'}"}
    assert _restic("port", env, src) == 0
    assert len(list((tmp_path / "traces" / "restic-backup").iterdir())) == 1


# ---------------------------------------------------------------------------
# The framework copies
# ---------------------------------------------------------------------------


def test_base_and_job_context_match_the_reference():
    assert base.SYNC_PROTOCOLS == jbase.SYNC_PROTOCOLS
    for name in jbase.__all__:
        assert hasattr(base, name), name
    assert base.Result.in_progress() == base.Result(
        completed=False, retry_after=jbase.Result.in_progress().retry_after)
    cat = base.Catalog()
    cat.register("b", object())
    cat.register("a", object())
    assert cat.names() == ["a", "b"]
    ref_fields = [f.name for f in JJobContext.__dataclass_fields__.values()]
    port_fields = [f.name for f in JobContext.__dataclass_fields__.values()]
    assert port_fields == ref_fields + ["device"]
    ctx = JobContext(name="n", namespace="ns", env={}, mounts={},
                     secrets={}, stop_event=threading.Event())
    assert ctx.device is None and ctx.kind == "Job"
    ctx.report_transfer(10, 1.0)  # no cluster: a no-op

    class _Obj:
        class status:
            transfer_bytes = transfer_seconds = None

    class _Cluster:
        def __init__(self):
            self.obj, self.updated = _Obj(), []

        def try_get(self, kind, ns, name):
            return self.obj if (kind, ns, name) == ("Job", "ns", "n") \
                else None

        def update_status(self, obj):
            self.updated.append(obj)

    ctx.cluster = _Cluster()
    ctx.report_transfer(123, 0.5)
    assert ctx.cluster.updated == [ctx.cluster.obj]
    assert (_Obj.status.transfer_bytes, _Obj.status.transfer_seconds) == \
        (123, 0.5)


def test_publish_port_on_the_service():
    """``_publish_port`` sets the bound port and address on the mover
    Service through the duck-typed cluster, as the reference does."""

    class _Svc:
        class spec:
            type = "LoadBalancer"

        class status:
            bound_port = None
            load_balancer_ip = cluster_ip = None

    class _Cluster:
        def __init__(self):
            self.updated = []

        def try_get(self, kind, ns, name):
            return _Svc if (kind, name) == ("Service", "svc") else None

        def update_status(self, obj):
            self.updated.append(obj)

    cluster = _Cluster()
    ctx = JobContext(name="d", namespace="ns", env={"SERVICE": "svc"},
                     mounts={}, secrets={}, stop_event=threading.Event(),
                     cluster=cluster)
    entry._publish_port(ctx, 4242)
    assert cluster.updated == [_Svc]
    assert (_Svc.status.bound_port, _Svc.status.cluster_ip,
            _Svc.status.load_balancer_ip) == (4242, "127.0.0.1", "127.0.0.1")
    entry._publish_port(JobContext(name="d", namespace="ns", env={},
                                   mounts={}, secrets={},
                                   stop_event=threading.Event()), 1)


def test_destination_entrypoint_serves_until_shutdown(tmp_path):
    """``rsync_destination_entrypoint`` reads its keys from the Secret
    mount, serves the port's source, and returns the rc the source
    sends; a stop event without a transfer returns 1."""
    src = tmp_path / "src"
    _seed_tree(src, np.random.default_rng(51), link=True)
    dst = tmp_path / "dst"
    dst.mkdir()
    src_priv, dst_priv = dt.generate_device_key(), dt.generate_device_key()
    published = {}

    class _Svc:
        class spec:
            type = "ClusterIP"

        class status:
            bound_port = None
            cluster_ip = None

    class _Cluster:
        def try_get(self, kind, ns, name):
            return _Svc if kind == "Service" else None

        def update_status(self, obj):
            published["port"] = obj.status.bound_port

    dctx = JobContext(
        name="d", namespace="ns", env={"SERVICE": "svc"},
        mounts={"data": dst},
        secrets={"keys": {"destination": dst_priv, "source-id":
                          dt.device_id_from_private(src_priv).encode()}},
        stop_event=threading.Event(), cluster=_Cluster(), device="cpu")
    got = {}
    t = threading.Thread(target=lambda: got.setdefault(
        "rc", entry.rsync_destination_entrypoint(dctx)), daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while "port" not in published and time.monotonic() < deadline:
        time.sleep(0.01)
    env = {"ADDRESS": "127.0.0.1", "PORT": str(published["port"]),
           "FAST_RETRY": "1"}
    keys = {"source": src_priv,
            "destination-id": dt.device_id_from_private(dst_priv).encode()}
    assert entry.rsync_source_entrypoint(
        _ctx(JobContext, env, src, keys, device="cpu")) == 0
    t.join(30)
    assert got["rc"] == 0
    assert _tree_state(dst) == _tree_state(src)
    stop = threading.Event()
    stop.set()
    assert entry.serve_destination(dst, dst_priv, "00" * 32, stop_event=stop,
                                   device="cpu") == 1


def test_source_gives_up_after_retries(tmp_path):
    """No listener: the source retries MAX_RETRIES times and returns 1;
    a set stop event returns 1 at once."""
    src = tmp_path / "src"
    src.mkdir()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens there now
    keys = {"source": dt.generate_device_key(), "destination-id": b"00"}
    env = {"ADDRESS": "127.0.0.1", "PORT": str(port), "FAST_RETRY": "1"}
    ctx = _ctx(JobContext, env, src, keys, device="cpu")
    t0 = time.monotonic()
    assert entry.rsync_source_entrypoint(ctx) == 1
    assert time.monotonic() - t0 < 30
    ctx.stop_event.set()
    assert entry.rsync_source_entrypoint(ctx) == 1


def test_protocol_names_and_catalog_match_the_reference():
    for name in ("PROTO_AUTO", "PROTO_FULL", "PROTO_DELTA", "PROTO_CDC",
                 "EV_TRANSFER_COMPLETED", "SERVICE_ADDRESS_TIMEOUT"):
        assert getattr(base, name) == getattr(jbase, name)
    with pytest.raises(base.NoMoverFound):
        _catalog_of(None).source_mover(None, _Obj("src"))
    with pytest.raises(base.MultipleMoversFound, match="m1"):
        _catalog_of(_Mover("m1"), _Mover("m2")).source_mover(
            None, _Obj("src"))
    only = _Mover("m3")
    assert _catalog_of(only).destination_mover(None, _Obj("dst")) is only


class _Mover:
    def __init__(self, name):
        self.name = name


class _Obj:
    kind = "ReplicationSource"

    def __init__(self, name):
        self.metadata = type("M", (), {"key": f"ns/{name}"})()


def _catalog_of(*movers):
    cat = base.Catalog()
    for i, m in enumerate(movers):
        class _B:
            def __init__(self, m):
                self.m = m

            def from_source(self, cluster, obj, metrics):
                return self.m

            from_destination = from_source

        cat.register(f"m{i}", _B(m))
    return cat
