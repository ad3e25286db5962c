"""The port's syncthing mover (``movers/syncthing/``) on the CPU, against
the JAX package's.

The daemon cases of tests/test_e2e_syncthing.py that need no operator
run on the port through ``syncthing_entrypoint`` and a ``JobContext``
with ``device="cpu"``: a three-daemon mesh converges writes, nested
directories and deletions, a path that turns from a directory into a
file converges, an introducer teaches its spokes about each other, a
device the daemon does not know is refused at the handshake, the
control-API client reads and publishes the config, an unchanged rescan
hashes nothing, and the idle backoff grows to its ceiling and snaps
back. Across the packages a reference daemon and a port daemon sync one
folder both ways with equal index entries, and every digest is
hashlib's blob id. Daemons listen on 127.0.0.1; a duck-typed cluster
records the ports they publish. Contents are made from a seed with
numpy.
"""

import os
import shutil
import threading
import time
import types

import numpy as np
import pytest
import torch

from volsync_tpu.cluster.runner import JobContext as JJobContext
from volsync_tpu.movers.syncthing import entry as j_entry
from volsync_tpu_torch.cluster.runner import JobContext
from volsync_tpu_torch.movers.rsync.channel import ChannelError
from volsync_tpu_torch.movers.syncthing import entry, transport
from volsync_tpu_torch.movers.syncthing.apiclient import (
    SyncthingConnection,
    try_fetch,
)
from volsync_tpu_torch.repo.blobid import blob_id

torch.set_num_threads(1)

DEV = "cpu"
TIMEOUT = 90.0


class _Cluster:
    """The two calls the daemon makes of its cluster: ``try_get`` a
    Service by name and ``update_status`` it with the bound port."""

    def __init__(self):
        self._lock = threading.Lock()
        self.services: dict = {}

    def try_get(self, kind, namespace, name):
        with self._lock:
            return self.services.setdefault(name, types.SimpleNamespace(
                status=types.SimpleNamespace(bound_port=None,
                                             cluster_ip=None)))

    def update_status(self, obj):
        pass

    def port(self, name, timeout=30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            port = self.try_get("Service", "t", name).status.bound_port
            if port:
                return port
            time.sleep(0.02)
        raise AssertionError(f"service {name} never bound")


class _Daemon:
    """One daemon thread through an entry point (the port's by default,
    ``ref=True`` for the reference's) on its own data and config
    directories."""

    def __init__(self, base, name, cluster, *, ref=False, key=None):
        self.name = name
        self.data = base / name / "data"
        self.config = base / name / "config"
        self.data.mkdir(parents=True, exist_ok=True)
        self.config.mkdir(parents=True, exist_ok=True)
        self.key = key or transport.generate_device_key()
        self.apikey = os.urandom(32)
        self.id = transport.device_id_from_private(self.key)
        self.cluster = cluster
        self.ref = ref
        self.rc = None
        kw = dict(name=name, namespace="t",
                  env={"SERVICE_API": f"{name}-api",
                       "SERVICE_DATA": f"{name}-data",
                       "VOLSYNC_ST_MAX_INTERVAL": "1.0"},
                  mounts={"data": self.data, "config": self.config},
                  secrets={"secret": {"apikey": self.apikey,
                                      "cert": self.key}},
                  stop_event=threading.Event(), cluster=cluster)
        self.ctx = JJobContext(**kw) if ref else JobContext(**kw, device=DEV)
        run = j_entry.syncthing_entrypoint if ref \
            else entry.syncthing_entrypoint
        self.thread = threading.Thread(target=self._run, args=(run,),
                                       daemon=True, name=f"st-{name}")

    def _run(self, run):
        self.rc = run(self.ctx)

    def start(self):
        self.thread.start()
        self.api_port = self.cluster.port(f"{self.name}-api")
        self.data_port = self.cluster.port(f"{self.name}-data")
        return self

    @property
    def address(self):
        return f"tcp://127.0.0.1:{self.data_port}"

    def api(self):
        return SyncthingConnection("127.0.0.1", self.api_port, self.apikey)

    def peer(self, other, introducer=False):
        return {"id": other.id, "address": other.address,
                "introducer": introducer}

    def stop(self):
        self.ctx.stop_event.set()
        self.thread.join(timeout=10.0)
        assert not self.thread.is_alive() and self.rc == 0


@pytest.fixture
def daemons(tmp_path):
    made = []
    cluster = _Cluster()

    def spawn(name, **kw):
        d = _Daemon(tmp_path, name, cluster, **kw).start()
        made.append(d)
        return d

    yield spawn
    for d in made:
        d.ctx.stop_event.set()
    for d in made:
        d.thread.join(timeout=10.0)


class _Moving(Exception):
    """A path vanished or changed between a tree walk and its read: the
    tree is still moving, so the snapshot is not settled."""


def wait(pred, timeout=TIMEOUT):
    """Poll ``pred`` until it holds; a snapshot of a tree that moved
    under it (``_Moving``) counts as not settled and is polled again."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if pred():
                return
        except _Moving:
            pass
        time.sleep(0.05)
    raise AssertionError("timed out")


def _mesh(daemons, names=("alpha", "beta", "gamma")):
    ds = [daemons(n) for n in names]
    for d in ds:
        d.api().publish_config({"devices": [d.peer(o) for o in ds
                                            if o is not d]})
    return ds


def _has(d, rel, data):
    p = d.data / rel
    return p.is_file() and p.read_bytes() == data


def _tree(root) -> dict:
    """rel -> (kind, bytes or link target, mode, mtime_ns). Raises
    ``_Moving`` when a walked path vanishes or changes kind before it is
    read (a daemon renamed or deleted it): no entry is skipped, so a
    partial tree is never compared."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            p = os.path.join(dirpath, name)
            rel = os.path.relpath(p, root)
            try:
                st = os.lstat(p)
                if os.path.islink(p):
                    out[rel] = ("link", os.readlink(p))
                elif os.path.isdir(p):
                    out[rel] = ("dir", st.st_mode & 0o7777)
                else:
                    with open(p, "rb") as f:
                        out[rel] = ("file", f.read(), st.st_mode & 0o7777,
                                    st.st_mtime_ns)
            except (FileNotFoundError, NotADirectoryError,
                    IsADirectoryError) as e:
                raise _Moving(p) from e
    return out


def test_tree_snapshot_of_a_moving_tree_is_polled_again(tmp_path,
                                                        monkeypatch):
    """A path that vanishes between the walk and its ``lstat`` makes the
    snapshot unsettled: ``wait`` polls again instead of failing or
    comparing a partial tree."""
    for side in ("a", "b"):
        (tmp_path / side / "d").mkdir(parents=True)
        (tmp_path / side / "d" / "f.bin").write_bytes(b"z" * 100)
        os.utime(tmp_path / side / "d" / "f.bin", ns=(10**18, 10**18))
    real = os.lstat
    calls = {"n": 0, "raised": 0}

    def flaky(p, *a, **k):
        calls["n"] += 1
        if calls["raised"] == 0 and str(p).endswith("f.bin"):
            calls["raised"] += 1
            raise FileNotFoundError(p)
        return real(p, *a, **k)

    monkeypatch.setattr(os, "lstat", flaky)
    wait(lambda: _tree(tmp_path / "a") == _tree(tmp_path / "b"),
         timeout=5.0)
    assert calls["raised"] == 1 and calls["n"] > 2
    calls["raised"] = 0
    with pytest.raises(_Moving):
        _tree(tmp_path / "a")


def test_mesh_sync_and_connections(daemons):
    alpha, beta, gamma = _mesh(daemons)

    (alpha.data / "hello.txt").write_bytes(b"from-alpha")
    for other in (beta, gamma):
        wait(lambda o=other: _has(o, "hello.txt", b"from-alpha"))

    sub = beta.data / "nested"
    sub.mkdir()
    blob = np.random.RandomState(4).bytes(50_000)
    (sub / "b.bin").write_bytes(blob)
    for other in (alpha, gamma):
        wait(lambda o=other: _has(o, "nested/b.bin", blob))

    (gamma.data / "hello.txt").unlink()
    for other in (alpha, beta):
        wait(lambda o=other: not (o.data / "hello.txt").exists())

    def connected():
        state = alpha.api().fetch()
        return state.my_id == alpha.id and len(state.connections) == 2 \
            and all(c["connected"] for c in state.connections.values())
    wait(connected)
    wait(lambda: _tree(alpha.data) == _tree(beta.data) == _tree(gamma.data))
    idx = entry.FolderIndex(gamma.config / "index.json", gamma.id, DEV)
    ent = idx.entries["nested/b.bin"]
    assert ent["digest"] == blob_id(blob) and ent["modified_by"] == beta.id
    assert idx.entries["hello.txt"]["deleted"] is True


def test_type_change_converges(daemons):
    """A path that changes TYPE (dir -> file) converges: the apply
    clears the conflicting old object instead of wedging the round."""
    alpha, beta, gamma = _mesh(daemons)
    d = alpha.data / "thing"
    d.mkdir()
    (d / "inner.txt").write_bytes(b"inner")
    wait(lambda: (beta.data / "thing" / "inner.txt").is_file())
    shutil.rmtree(d)
    d.write_bytes(b"now a file")
    for other in (beta, gamma):
        wait(lambda o=other: _has(o, "thing", b"now a file"))


def test_introducer_propagates_devices(daemons):
    """Star topology: alpha and gamma know ONLY beta (their introducer);
    beta knows both. Introduction teaches alpha and gamma about each
    other (stamped introduced_by) and data converges across the mesh."""
    alpha, beta, gamma = (daemons(n) for n in ("alpha", "beta", "gamma"))
    beta.api().publish_config({"devices": [beta.peer(alpha),
                                           beta.peer(gamma)]})
    for spoke in (alpha, gamma):
        spoke.api().publish_config({"devices": [
            spoke.peer(beta, introducer=True)]})

    def introduced(spoke, other):
        return any(d["id"] == other.id and d.get("introduced_by") == beta.id
                   for d in spoke.api().fetch().config["devices"])

    wait(lambda: introduced(alpha, gamma))
    wait(lambda: introduced(gamma, alpha))
    (alpha.data / "via-hub.txt").write_bytes(b"hello")
    for other in (beta, gamma):
        wait(lambda o=other: _has(o, "via-hub.txt", b"hello"))


def test_unknown_device_is_refused(daemons):
    """A device NOT in the daemon's config cannot complete the
    handshake (the pinned-ID trust model)."""
    alpha = daemons("alpha")
    stranger = transport.generate_device_key()
    with pytest.raises(ChannelError):
        transport.connect_device("127.0.0.1", alpha.data_port, stranger,
                                 alpha.id, timeout=2.0)


def test_api_client_roundtrip(daemons):
    alpha = daemons("alpha")
    conn = alpha.api()
    assert conn.fetch().my_id == alpha.id
    conn.publish_config({"devices": [
        {"id": "f" * 64, "address": "tcp://127.0.0.1:1",
         "introducer": False}]})
    assert conn.fetch().config["devices"][0]["id"] == "f" * 64
    assert try_fetch("127.0.0.1", alpha.api_port, b"x" * 32) is None


def test_unchanged_rescan_is_stat_only(tmp_path, monkeypatch):
    """An unchanged folder's rescan costs stats, never re-hashing."""
    root = tmp_path / "data"
    (root / "d").mkdir(parents=True)
    (root / "d" / "f.bin").write_bytes(b"x" * 50_000)
    idx = entry.FolderIndex(tmp_path / "index.json", "dev1", DEV)

    calls = []
    real = entry._hash_file

    def spy(path, device):
        calls.append((path, device))
        return real(path, device)

    monkeypatch.setattr(entry, "_hash_file", spy)
    assert idx.scan(root) is True
    assert len(calls) == 1 and calls[0][1].type == "cpu"
    for _ in range(3):
        assert idx.scan(root) is False  # stat-gated: no hashing at all
    assert len(calls) == 1
    (root / "d" / "f.bin").write_bytes(b"y" * 50_001)
    assert idx.scan(root) is True
    assert len(calls) == 2
    assert idx.entries["d/f.bin"]["digest"] == blob_id(b"y" * 50_001)


def test_idle_backoff_interval_schedule():
    base, ceil = 0.2, 30.0
    iv = base
    seen = []
    for _ in range(40):
        iv = entry._next_interval(iv, base, ceil, active=False)
        seen.append(iv)
    assert seen[0] == pytest.approx(base * entry._BACKOFF)
    assert seen[-1] == ceil  # converges to the ceiling, never past it
    assert all(b >= a for a, b in zip(seen, seen[1:]))
    assert entry._next_interval(seen[-1], base, ceil, active=True) == base
    assert [j_entry._next_interval(base * 2, base, ceil, a)
            for a in (False, True)] \
        == [entry._next_interval(base * 2, base, ceil, a)
            for a in (False, True)]


def test_entrypoint_preflight_needs_service_names(tmp_path):
    ctx = JobContext(name="x", namespace="t", env={},
                     mounts={"data": tmp_path, "config": tmp_path},
                     secrets={}, stop_event=threading.Event(), device=DEV)
    assert entry.syncthing_entrypoint(ctx) == 2


def test_reference_and_port_daemons_converge_both_ways(daemons):
    """One reference daemon and one port daemon on one folder: files
    written on either side arrive on the other, and both indexes end
    with the same entries, every digest hashlib's blob id."""
    ref = daemons("ref", ref=True)
    port = daemons("port")
    ref.api().publish_config({"devices": [ref.peer(port)]})
    port.api().publish_config({"devices": [port.peer(ref)]})
    rng = np.random.RandomState(9)
    made = {"from-ref.bin": rng.bytes(70_000), "empty": b"",
            "d/small.txt": b"x" * 17}
    (ref.data / "d").mkdir()
    for rel, data in made.items():
        (ref.data / rel).write_bytes(data)
    os.symlink("d/small.txt", ref.data / "link")
    back = {"from-port.bin": rng.bytes(45_000), "d/more.bin": b"y" * 4096}
    wait(lambda: _tree(port.data) == _tree(ref.data))
    for rel, data in back.items():
        (port.data / rel).write_bytes(data)
    (port.data / "from-ref.bin").unlink()
    wait(lambda: _tree(port.data) == _tree(ref.data)
         and not (ref.data / "from-ref.bin").exists())

    def entries(d):
        idx = entry.FolderIndex(d.config / "index.json", d.id, DEV)
        return idx.entries
    wait(lambda: entries(ref) == entries(port))
    ents = entries(port)
    assert ents["from-ref.bin"]["deleted"] is True
    assert ents["from-port.bin"]["modified_by"] == port.id
    assert ents["d/small.txt"]["modified_by"] == ref.id
    for rel, data in {**made, **back}.items():
        if rel != "from-ref.bin":
            assert ents[rel]["digest"] == (blob_id(data) if data else "")


def test_package_exports_the_daemon_and_no_builder():
    """The port's package carries the daemon, its entry point and the
    control-API client, and, since the operator was ported, the
    reference's builder, its mover and ``register`` as well (the name
    is from before the operator)."""
    import volsync_tpu.movers.syncthing as jpkg
    import volsync_tpu_torch.movers.syncthing as pkg

    assert set(pkg.__all__) == {"FolderIndex", "SyncthingConnection",
                                "SyncthingDaemon", "SyncthingState",
                                "syncthing_entrypoint", "try_fetch",
                                "Builder", "SyncthingMover", "register"}
    assert set(jpkg.__all__) <= set(pkg.__all__)
    assert all(hasattr(pkg, n) for n in pkg.__all__)
