"""The port stands alone: no file of volsync_tpu_torch/ or chip_smoke.py
imports JAX or the JAX package (AST scan and a fresh-interpreter
``sys.modules`` diff, also around ``python -m volsync_tpu_torch.cli
scrub``), and with no CUDA and no ``device`` argument the entry points
(the durability path's, the delta engine's, the movers', the fleet's,
the GC's and the maintenance verbs' among them) raise instead of moving
to the CPU, before they touch a store or bind a port."""

import ast
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

import volsync_tpu_torch
from volsync_tpu_torch.cluster.runner import JobContext
from volsync_tpu_torch.engine import chunker as tch
from volsync_tpu_torch.engine import deltasync
from volsync_tpu_torch.engine.backup import TreeBackup
from volsync_tpu_torch.engine.restore import TreeRestore, restore_snapshot
from volsync_tpu_torch.movers.rclone import entry as rclone_entry
from volsync_tpu_torch.movers.rclone import sync as rclone_sync
from volsync_tpu_torch.movers.restic import entry as restic_entry
from volsync_tpu_torch.movers.rsync import entry as rsync_entry
from volsync_tpu_torch.objstore.store import MemObjectStore
from volsync_tpu_torch.ops import batcher, gearcdc, md5, rs, segment, sha256
from volsync_tpu_torch.repo import erasure
from volsync_tpu_torch.repo.repack import RepackService
from volsync_tpu_torch.repo.repository import Repository
from volsync_tpu_torch.repo.scrub import ScrubService
from volsync_tpu_torch.service import MoverJaxServer

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "volsync_tpu_torch"
FORBIDDEN = ("jax", "volsync_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_file_imports_jax_or_the_reference():
    found = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", "") == "__import__"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [node.args[0].value]
            else:
                continue
            found += [(path.name, n) for n in names if _forbidden(n)]
    assert found == []
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {"volsync_tpu_torch/ops/rs.py", "volsync_tpu_torch/repo/erasure.py",
            "volsync_tpu_torch/repo/scrub.py", "volsync_tpu_torch/repo/repack.py",
            "volsync_tpu_torch/objstore/faultstore.py",
            "volsync_tpu_torch/ops/rolling.py", "volsync_tpu_torch/ops/md5.py",
            "volsync_tpu_torch/ops/delta.py",
            "volsync_tpu_torch/engine/deltasync.py",
            "volsync_tpu_torch/engine/syncstats.py",
            "volsync_tpu_torch/engine/protoplan.py",
            "volsync_tpu_torch/movers/common.py",
            "volsync_tpu_torch/movers/base.py",
            "volsync_tpu_torch/cluster/runner.py",
            "volsync_tpu_torch/movers/devicetransport.py",
            "volsync_tpu_torch/movers/rsync/channel.py",
            "volsync_tpu_torch/movers/rsync/entry.py",
            "volsync_tpu_torch/movers/rsync/standalone.py",
            "volsync_tpu_torch/movers/restic/entry.py",
            "volsync_tpu_torch/movers/rclone/__init__.py",
            "volsync_tpu_torch/movers/rclone/sync.py",
            "volsync_tpu_torch/movers/rclone/entry.py",
            "volsync_tpu_torch/objstore/s3.py",
            "volsync_tpu_torch/objstore/fakes3.py",
            "volsync_tpu_torch/objstore/azure.py",
            "volsync_tpu_torch/objstore/fakeazure.py",
            "volsync_tpu_torch/objstore/swift.py",
            "volsync_tpu_torch/objstore/fakeswift.py",
            "volsync_tpu_torch/obs/__init__.py",
            "volsync_tpu_torch/obs/tracing.py",
            "volsync_tpu_torch/obs/copyledger.py",
            "volsync_tpu_torch/obs/cli.py",
            "volsync_tpu_torch/io/__init__.py",
            "volsync_tpu_torch/io/native.py",
            "volsync_tpu_torch/cli/repair.py",
            "volsync_tpu_torch/analysis/lockcheck.py",
            "volsync_tpu_torch/ops/batcher.py",
            "volsync_tpu_torch/service/__init__.py",
            "volsync_tpu_torch/service/tenants.py",
            "volsync_tpu_torch/service/admission.py",
            "volsync_tpu_torch/service/scheduler.py",
            "volsync_tpu_torch/service/moverjax_pb2.py",
            "volsync_tpu_torch/service/server.py",
            "volsync_tpu_torch/service/client.py",
            "volsync_tpu_torch/tools/service_bench.py",
            "volsync_tpu_torch/service/gc.py",
            "volsync_tpu_torch/service/fleet.py",
            "volsync_tpu_torch/cli/__init__.py",
            "volsync_tpu_torch/cli/__main__.py",
            "volsync_tpu_torch/cli/scrub.py",
            "volsync_tpu_torch/cli/repack.py",
            "volsync_tpu_torch/movers/syncthing/__init__.py",
            "volsync_tpu_torch/movers/syncthing/transport.py",
            "volsync_tpu_torch/movers/syncthing/apiclient.py",
            "volsync_tpu_torch/movers/syncthing/entry.py",
            "volsync_tpu_torch/parallel/__init__.py",
            "volsync_tpu_torch/parallel/mesh.py",
            "volsync_tpu_torch/parallel/multihost.py",
            "volsync_tpu_torch/parallel/engine.py",
            "volsync_tpu_torch/parallel/sharded_chunker.py",
            "volsync_tpu_torch/cluster/sessions.py",
            "volsync_tpu_torch/cluster/sessioncli.py"} <= names
    assert len(_port_files()) >= 95


def test_importing_the_port_loads_no_jax_module():
    """Diff sys.modules around importing every port module in a fresh
    interpreter (the interpreter's startup may already hold jax, so the
    check is on what the import adds)."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py") if p.name != "__main__.py")
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=300,
                         check=True)
    added = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"volsync_tpu_torch.ops.segment",
            "volsync_tpu_torch.movers.rclone.sync",
            "volsync_tpu_torch.objstore.s3",
            "volsync_tpu_torch.objstore.fakeswift",
            "volsync_tpu_torch.ops.batcher",
            "volsync_tpu_torch.service.server",
            "volsync_tpu_torch.tools.service_bench",
            "volsync_tpu_torch.service.gc",
            "volsync_tpu_torch.service.fleet",
            "volsync_tpu_torch.cli.scrub",
            "volsync_tpu_torch.cli.repack",
            "volsync_tpu_torch.cli.repair",
            "volsync_tpu_torch.obs.tracing",
            "volsync_tpu_torch.obs.copyledger",
            "volsync_tpu_torch.obs.cli",
            "volsync_tpu_torch.io.native",
            "volsync_tpu_torch.movers.syncthing.entry",
            "volsync_tpu_torch.movers.syncthing.apiclient",
            "volsync_tpu_torch.parallel.sharded_chunker",
            "volsync_tpu_torch.parallel.multihost",
            "volsync_tpu_torch.cluster.sessions",
            "volsync_tpu_torch.cluster.sessioncli"} <= set(added)
    assert [m for m in added if _forbidden(m)] == []


def test_cli_scrub_in_a_subprocess_loads_no_jax(tmp_path):
    """``python -m volsync_tpu_torch.cli scrub STORE`` in a fresh
    interpreter: the verb's imports add no JAX module and nothing of the
    JAX package, and with no CUDA it raises before opening the store."""
    store = tmp_path / "store"
    code = (
        "import json, runpy, sys\n"
        "before = set(sys.modules)\n"
        f"sys.argv = ['volsync', 'scrub', {str(store)!r}]\n"
        "try:\n"
        "    runpy.run_module('volsync_tpu_torch.cli', run_name='__main__',\n"
        "                     alter_sys=True)\n"
        "except RuntimeError as e:\n"
        "    err = str(e)\n"
        "print(json.dumps([err, sorted(set(sys.modules) - before)]))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300,
                         check=True)
    err, added = json.loads(out.stdout.strip().splitlines()[-1])
    assert "CUDA is not available" in err
    assert {"volsync_tpu_torch.cli", "volsync_tpu_torch.cli.scrub",
            "volsync_tpu_torch.repo.scrub"} <= set(added)
    assert [m for m in added if _forbidden(m)] == []
    assert not store.exists()


@pytest.mark.parametrize("verb", ["repair", "trace"])
def test_cli_repair_and_trace_in_a_subprocess_load_no_jax(tmp_path, verb):
    """``python -m volsync_tpu_torch.cli repair STORE`` and ``... trace
    summary`` in a fresh interpreter with no CUDA: no JAX module and
    nothing of the JAX package is imported; repair raises before it
    opens the store, and trace (which takes no device) runs."""
    store = tmp_path / "store"
    argv = (["volsync", "repair", str(store), "--dry-run"] if verb == "repair"
            else ["volsync", "trace", "summary"])
    code = (
        "import json, runpy, sys\n"
        "before = set(sys.modules)\n"
        f"sys.argv = {argv!r}\n"
        "err = None\n"
        "try:\n"
        "    runpy.run_module('volsync_tpu_torch.cli', run_name='__main__',\n"
        "                     alter_sys=True)\n"
        "except RuntimeError as e:\n"
        "    err = str(e)\n"
        "except SystemExit as e:\n"
        "    err = f'exit {e.code}'\n"
        "print(json.dumps([err, sorted(set(sys.modules) - before)]))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300,
                         check=True)
    err, added = json.loads(out.stdout.strip().splitlines()[-1])
    if verb == "repair":
        assert "CUDA is not available" in err
        assert "volsync_tpu_torch.cli.repair" in added
    else:
        assert err == "exit 0"
        assert "no spans recorded" in out.stdout
        assert "volsync_tpu_torch.obs.cli" in added
    assert [m for m in added if _forbidden(m)] == []
    assert not store.exists()


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = gearcdc.GearParams(min_size=4096, avg_size=32768, max_size=65536,
                           align=4096)
    f = tmp_path / "f"
    f.write_bytes(b"x" * 10)
    calls = [
        lambda: volsync_tpu_torch.resolve_device(),
        lambda: volsync_tpu_torch.resolve_device("cuda"),
        lambda: tch.DeviceChunkHasher(p),
        lambda: tch.stream_chunk_batches(lambda n: b"", p),
        lambda: tch.stream_chunks(lambda n: b"", p),
        lambda: tch.hash_spans(b"x" * 10, [(0, 10)]),
        lambda: tch.verify_blob_batch([("00", b"y")]),
        lambda: tch.hash_file_streaming(f),
        lambda: sha256.sha256_many([b"x"]),
        lambda: segment.BatchedSegmentHasher(p),
        lambda: gearcdc.chunk_buffer(b"x" * 10, p),
        lambda: tch.DeviceChunkHasher(gearcdc.GearParams(align=64)),
        lambda: tch.DeviceChunkHasher(gearcdc.GearParams(align=1)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert volsync_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    assert tch.DeviceChunkHasher(p, device="cpu").device.type == "cpu"


def test_product_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Repository.init/open, TreeBackup, TreeRestore and restore_snapshot
    run on CUDA unless told otherwise: with no CUDA they raise, and
    init writes nothing first. A backup or restore without ``device=``
    takes its repository's device, so one opened on CUDA raises here
    too rather than moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = MemObjectStore()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Repository.init(store)
    assert list(store.list()) == []
    repo = Repository.init(store, device="cpu")
    calls = [
        lambda: Repository.open(store),
        lambda: Repository(store, repo.box, repo.config),
        lambda: TreeBackup(repo, device="cuda"),
        lambda: TreeRestore(repo, device="cuda"),
        lambda: restore_snapshot(repo, tmp_path / "d", device="cuda"),
    ]
    repo_on_cuda = Repository.open(store, device="cpu")
    repo_on_cuda.device = torch.device("cuda")  # as if opened on a card
    calls += [lambda: TreeBackup(repo_on_cuda),
              lambda: TreeRestore(repo_on_cuda),
              lambda: restore_snapshot(repo_on_cuda, tmp_path / "d")]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not (tmp_path / "d").exists()
    assert Repository.open(store, device="cpu").device.type == "cpu"
    assert TreeBackup(repo).device.type == "cpu"


class _CudaGrid:
    """Stands for a uint8 page grid on a card, which cannot be made
    where CUDA is absent."""

    device = torch.device("cuda")
    dtype = torch.uint8
    shape = (4, 1, 4096)

    def dim(self):
        return 3


def test_durability_entry_points_raise_without_cuda(monkeypatch):
    """The scrub, the repacker, the shard codec and the GF(2^8) product
    run on CUDA unless told otherwise: with no CUDA they raise, and a
    scrub or repack given ``device="cpu"`` opens its repository there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = MemObjectStore()
    Repository.init(store, device="cpu")
    calls = [
        lambda: ScrubService(store),
        lambda: RepackService(store),
        lambda: ScrubService(store, device="cuda"),
        lambda: rs.gf_matmul(rs.rs_generator_matrix(4, 2), _CudaGrid()),
        lambda: rs.rs_encode_device(_CudaGrid(), 2),
        lambda: rs.rs_reconstruct_device({0: b"a", 1: b"b"}, 2, 1, 1),
        lambda: erasure.encode_pack_shards([b"body"], 4, 2),
        lambda: erasure.reconstruct_pack({}),
        lambda: erasure.reconstruct_verified({}, "00" * 32),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    scrub = ScrubService(store, device="cpu")
    assert scrub.run_once() == "clean"
    assert scrub._repo.device.type == "cpu"
    repack = RepackService(store, device="cpu")
    assert repack.run_once() == "clean"
    assert repack._repo.device.type == "cpu"


class _CudaTensor:
    """Stands for a tensor on a card, which cannot be made where CUDA is
    absent."""

    device = torch.device("cuda")

    def __init__(self, dtype, shape):
        self.dtype, self.shape = dtype, shape

    def dim(self):
        return len(self.shape)


def test_delta_entry_points_raise_without_cuda(monkeypatch):
    """The delta engine's entry points and MD5 run on CUDA unless told
    otherwise: with no CUDA they raise, and an MD5 call on a CUDA tensor
    raises rather than running the CPU twin."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = b"x" * 10_000
    sig = deltasync.build_file_signature(data, 4096, device="cpu")

    def twin(*a, **kw):  # pragma: no cover - failure path
        raise AssertionError("the CPU twin ran for a CUDA tensor")

    monkeypatch.setattr(md5, "_md5_lanes_plain", twin)
    monkeypatch.setattr(md5, "_md5_windows_plain", twin)
    monkeypatch.setattr(md5, "_md5_contiguous_plain", twin)
    calls = [
        lambda: deltasync.build_file_signature(data),
        lambda: deltasync.build_file_signature(data, device="cuda"),
        lambda: deltasync.compute_delta(data, sig),
        lambda: deltasync.delta_scan_batch([(data, sig)]),
        lambda: md5.md5_many([b"x"]),
        lambda: md5.md5_blocks(_CudaTensor(torch.int32, (2, 1, 16)),
                               _CudaTensor(torch.int32, (2,))),
        lambda: md5.md5_fixed_blocks_device(
            _CudaTensor(torch.uint8, (4096,)),
            _CudaTensor(torch.int64, (3,)), block_len=64),
        lambda: md5.md5_contiguous_blocks_device(
            _CudaTensor(torch.uint8, (4096,)), block_len=1024),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_mover_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The movers' entry points (rsync, restic, rclone and its bucket
    sync) run on CUDA unless given a device: with no CUDA, a
    ``JobContext`` with no ``device`` and no ``device=`` they raise
    before they bind, connect, send, open a remote or write anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "src"
    src.mkdir()
    (src / "f").write_bytes(b"x" * 10)
    sent = []

    class _Chan:
        def send(self, msg):  # pragma: no cover - failure path
            sent.append(msg)

        def recv(self):  # pragma: no cover - failure path
            return {"verb": "ok"}

    listener = socket.create_server(("127.0.0.1", 0))
    port = listener.getsockname()[1]
    bound = []

    def ctx(env, secrets):
        return JobContext(name="j", namespace="ns", env=env,
                          mounts={"data": src}, secrets=secrets,
                          stop_event=threading.Event())

    keys = {"source": b"k" * 64, "destination-id": b"00",
            "destination": b"k" * 64, "source-id": b"00"}
    repo = tmp_path / "repo"
    conf = {"rclone-secret": {"rclone.conf": (
        f"[b]\nurl = file://{tmp_path / 'bucket'}\n").encode()}}
    bucket = MemObjectStore()
    dst = tmp_path / "dst"
    calls = [
        lambda: rsync_entry.serve_destination(
            src, b"k" * 64, "00", on_port=bound.append),
        lambda: rsync_entry._dest_verbs(src),
        lambda: rsync_entry._push_tree(_Chan(), src),
        lambda: rsync_entry.rsync_source_entrypoint(ctx(
            {"ADDRESS": "127.0.0.1", "PORT": str(port)}, {"keys": keys})),
        lambda: rsync_entry.rsync_destination_entrypoint(ctx(
            {}, {"keys": keys})),
        lambda: restic_entry.restic_entrypoint(ctx(
            {"RESTIC_REPOSITORY": str(repo)}, {})),
        lambda: restic_entry.restic_entrypoint(ctx(
            {"RESTIC_REPOSITORY": str(repo), "DIRECTION": "restore"}, {})),
        lambda: rclone_entry.rclone_entrypoint(ctx(
            {"RCLONE_DEST_PATH": "p", "DIRECTION": "source",
             "RCLONE_CONFIG_SECTION": "b"}, conf)),
        lambda: rclone_entry.rclone_entrypoint(ctx(
            {"RCLONE_DEST_PATH": "p", "DIRECTION": "destination",
             "RCLONE_CONFIG_SECTION": "b"}, conf)),
        lambda: rclone_sync.sync_up(src, bucket, "p"),
        lambda: rclone_sync.sync_down(bucket, "p", dst),
        lambda: rclone_sync.hash_files(src, ["f"]),
    ]
    listener.settimeout(0.2)
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
        with pytest.raises(socket.timeout):
            listener.accept()  # the source never dialled
    listener.close()
    assert sent == [] and bound == [] and not repo.exists()
    assert [p.name for p in src.iterdir()] == ["f"]
    assert list(bucket.list()) == [] and not dst.exists()
    assert not (tmp_path / "bucket").exists()


def test_service_entry_points_raise_without_cuda(monkeypatch):
    """The mover-jax server, the segment micro-batcher and a forced
    shared batcher run on CUDA unless given a device: with no CUDA they
    raise before a port is bound or a thread started; unforced, the
    shared batcher is off for the CPU, and a CPU server reports its
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(batcher, "_SHARED", {})
    p = gearcdc.GearParams(min_size=4096, avg_size=32768, max_size=65536,
                           align=4096)
    threads = threading.active_count()
    monkeypatch.setenv("VOLSYNC_BATCH_SEGMENTS", "1")
    calls = [
        lambda: MoverJaxServer(),
        lambda: MoverJaxServer(params=p, device="cuda"),
        lambda: MoverJaxServer(params=p, batch_window_ms=0.0),
        lambda: batcher.SegmentMicroBatcher(p),
        lambda: batcher.SegmentMicroBatcher(p, device="cuda"),
        lambda: batcher.shared_batcher(p),
        lambda: batcher.shared_batcher(p, device="cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert threading.active_count() == threads and batcher._SHARED == {}
    monkeypatch.delenv("VOLSYNC_BATCH_SEGMENTS")
    assert batcher.shared_batcher(p, device="cpu") is None
    srv = MoverJaxServer(params=p, device="cpu")
    assert srv.device.type == "cpu" and srv._hasher.device.type == "cpu"
    assert srv._batcher.device.type == "cpu"
    srv.stop(grace=0.1, drain=0.1)


class _SpyStore(MemObjectStore):
    """A store that records every call made of it."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __getattribute__(self, name):
        attr = super().__getattribute__(name)
        if name in ("get", "put", "list", "exists", "delete", "get_range",
                    "size"):
            super().__getattribute__("calls").append(name)
        return attr


def test_fleet_gc_cli_and_syncthing_raise_without_cuda(monkeypatch,
                                                       tmp_path):
    """The continuous GC, a fleet replica and a replica group, the
    ``scrub`` and ``repack`` verbs and the syncthing daemon run on CUDA
    unless given a device: with no CUDA they raise before they touch a
    store, bind a port or publish one, and start no thread."""
    from volsync_tpu_torch import cli
    from volsync_tpu_torch.movers.syncthing import entry as st_entry
    from volsync_tpu_torch.service.fleet import Replica, ReplicaGroup
    from volsync_tpu_torch.service.gc import ContinuousGC

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = _SpyStore()
    published = []

    class _Cluster:
        def try_get(self, kind, namespace, name):  # pragma: no cover
            published.append(name)

        def update_status(self, obj):  # pragma: no cover
            published.append(obj)

    data, config = tmp_path / "data", tmp_path / "config"
    ctx = JobContext(name="st", namespace="ns",
                     env={"SERVICE_API": "api", "SERVICE_DATA": "data"},
                     mounts={"data": data, "config": config},
                     secrets={"secret": {"apikey": b"k" * 32,
                                         "cert": b"\x01" * 32}},
                     stop_event=threading.Event(), cluster=_Cluster())
    repo_dir = tmp_path / "repo"
    threads = threading.active_count()
    calls = [
        lambda: ContinuousGC(store),
        lambda: ContinuousGC(store, device="cuda", grace_seconds=1.0),
        lambda: Replica("r00", store),
        lambda: Replica("r00", store, device="cuda"),
        lambda: ReplicaGroup([store, store]),
        lambda: cli.main(["scrub", str(repo_dir)], out=lambda s: None),
        lambda: cli.main(["repack", str(repo_dir), "--json"],
                         out=lambda s: None),
        lambda: cli.main(["scrub", str(repo_dir)], out=lambda s: None,
                         device="cuda"),
        lambda: cli.main(["repair", str(repo_dir)], out=lambda s: None),
        lambda: cli.main(["repair", str(repo_dir), "--dry-run", "--json"],
                         out=lambda s: None, device="cuda"),
        lambda: st_entry.syncthing_entrypoint(ctx),
        lambda: st_entry.SyncthingDaemon(ctx),
        lambda: st_entry.FolderIndex(config / "index.json", "dev"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert store.calls == [] and published == []
    assert threading.active_count() == threads
    assert not repo_dir.exists() and not data.exists() \
        and not config.exists()
    assert ContinuousGC(store, device="cpu").device.type == "cpu"


def test_mesh_and_session_entry_points_raise_without_cuda(monkeypatch,
                                                          tmp_path):
    """The meshes, the mesh hasher, the sharded steps and the join run on
    CUDA unless given devices: with no CUDA they raise before they bind
    a port or touch a store; the restic entry's VOLSYNC_ENGINE=mesh
    raises before its repository is written; the default session
    backend's probe child fails naming CUDA."""
    from volsync_tpu_torch.cluster.sessions import TorchSessionBackend
    from volsync_tpu_torch.parallel import engine as pengine
    from volsync_tpu_torch.parallel import mesh as pmesh
    from volsync_tpu_torch.parallel import multihost, sharded_chunker
    from volsync_tpu_torch.resilience import TransientError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    p = gearcdc.GearParams(min_size=4096, avg_size=32768, max_size=65536,
                           align=4096)
    src = tmp_path / "src"
    src.mkdir()
    (src / "f").write_bytes(b"x" * 10)
    repo = tmp_path / "repo"
    calls = [
        lambda: pmesh.make_mesh(),
        lambda: sharded_chunker.make_stream_mesh(),
        lambda: sharded_chunker.MeshChunkHasher(p),
        lambda: pengine.chunk_hash_block(b"x" * 4096, block_len=64),
        lambda: multihost.init_distributed(),
        lambda: multihost.init_distributed(require=True),
        lambda: multihost.init_distributed("127.0.0.1:1", 2, 0),
        lambda: restic_entry.restic_entrypoint(JobContext(
            name="j", namespace="ns", env={"RESTIC_REPOSITORY": str(repo),
                                           "VOLSYNC_ENGINE": "mesh"},
            mounts={"data": src}, secrets={},
            stop_event=threading.Event())),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert multihost.process_group() is None and not repo.exists()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(TransientError, match="CUDA is not available"):
        TorchSessionBackend(probe_timeout=120.0).acquire()


OPERATOR_MODULES = [
    "volsync_tpu_torch/version.py", "volsync_tpu_torch/metrics.py",
    "volsync_tpu_torch/operator.py", "volsync_tpu_torch/api/__init__.py",
    "volsync_tpu_torch/api/common.py", "volsync_tpu_torch/api/types.py",
    "volsync_tpu_torch/api/serde.py", "volsync_tpu_torch/cluster/__init__.py",
    "volsync_tpu_torch/cluster/objects.py",
    "volsync_tpu_torch/cluster/cluster.py",
    "volsync_tpu_torch/cluster/storage.py",
    "volsync_tpu_torch/cluster/runner.py",
    "volsync_tpu_torch/controller/__init__.py",
    "volsync_tpu_torch/controller/cron.py",
    "volsync_tpu_torch/controller/statemachine.py",
    "volsync_tpu_torch/controller/utils.py",
    "volsync_tpu_torch/controller/volumehandler.py",
    "volsync_tpu_torch/controller/reconcilers.py",
    "volsync_tpu_torch/controller/manager.py",
    "volsync_tpu_torch/movers/common.py",
    "volsync_tpu_torch/movers/restic/builder.py",
    "volsync_tpu_torch/movers/rsync/builder.py",
    "volsync_tpu_torch/movers/rclone/builder.py",
    "volsync_tpu_torch/movers/syncthing/builder.py"]


@pytest.mark.parametrize("rel", OPERATOR_MODULES)
def test_operator_modules_import_no_jax_and_name_their_reference(rel):
    """Each module of the operator imports no JAX and nothing of the JAX
    package, and its docstring names the reference file it ports."""
    path = ROOT / rel
    tree = ast.parse(path.read_text(), str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and _forbidden(
                node.module or ""):
            found.append(node.module)
    assert found == []
    ref = rel.replace("volsync_tpu_torch/", "volsync_tpu/")
    assert (ROOT / ref).is_file()
    assert f"``{ref}``" in " ".join(ast.get_docstring(tree).split())


def _port_is_free(port: int) -> bool:
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def test_operator_raises_without_cuda_before_port_or_lock(monkeypatch,
                                                          tmp_path):
    """``JobRunner``, ``OperatorRuntime`` and ``operator.main`` run on
    CUDA unless asked for the CPU: with no CUDA they raise before a Job
    is taken, a port bound, storage made or the storage lock taken; with
    ``device="cpu"`` (or ``VOLSYNC_DEVICE=cpu``) they boot on the CPU."""
    from volsync_tpu_torch import operator
    from volsync_tpu_torch.cluster.cluster import Cluster
    from volsync_tpu_torch.cluster.runner import JobRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("VOLSYNC_DEVICE", raising=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    storage = tmp_path / "storage"
    cfg = {"storage_path": str(storage), "metrics_port": port}
    argv = ["--storage-path", str(storage), "--metrics-port", str(port)]
    for call in (lambda: JobRunner(Cluster()),
                 lambda: JobRunner(Cluster(), device="cuda"),
                 lambda: operator.OperatorRuntime(cfg),
                 lambda: operator.OperatorRuntime({**cfg,
                                                   "device": "cuda"}),
                 lambda: operator.main(argv)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
        assert _port_is_free(port) and not storage.exists()
    assert JobRunner(Cluster(), device="cpu").device == torch.device("cpu")
    monkeypatch.setenv("VOLSYNC_DEVICE", "cpu")
    rt = operator.OperatorRuntime(operator.resolve_config(
        operator.build_parser().parse_args(argv))).start()
    try:
        assert rt.runner.device == torch.device("cpu")
        assert (storage / ".volsync-manager.lock").exists()
        assert not _port_is_free(port)
    finally:
        rt.stop()


def test_operator_in_a_subprocess_loads_no_jax(tmp_path):
    """The operator in a fresh interpreter: booted on the CPU and stopped,
    and without CUDA or a device (it raises), its imports add no JAX
    module and nothing of the JAX package."""
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "from volsync_tpu_torch import operator\n"
        "err = None\n"
        "try:\n"
        "    operator.main(['--metrics-port', '0'])\n"
        "except RuntimeError as e:\n"
        "    err = str(e)\n"
        "rt = operator.OperatorRuntime(operator.resolve_config(\n"
        "    operator.build_parser().parse_args(\n"
        "        ['--device', 'cpu', '--metrics-port', '-1',\n"
        f"         '--storage-path', {str(tmp_path / 's')!r}]))).start()\n"
        "rt.stop()\n"
        "print(json.dumps([err, sorted(set(sys.modules) - before)]))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("VOLSYNC_DEVICE", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300,
                         check=True)
    err, added = json.loads(out.stdout.strip().splitlines()[-1])
    assert "CUDA is not available" in err
    assert {"volsync_tpu_torch.operator", "volsync_tpu_torch.controller",
            "volsync_tpu_torch.movers.restic.builder",
            "volsync_tpu_torch.movers.syncthing.builder",
            "volsync_tpu_torch.api.serde"} <= set(added)
    assert [m for m in added if _forbidden(m)] == []


VERB_AND_LINT_MODULES = [
    f"volsync_tpu_torch/cli/{m}.py"
    for m in ("main", "migration", "relationship", "replication")] + [
    f"volsync_tpu_torch/analysis/{m}.py"
    for m in ("engine", "cache", "sarif", "rules", "callgraph", "dataflow",
              "iprules", "lockflow", "guards", "faultflow", "bufflow",
              "cli", "__main__", "absdomain", "shapes")]


@pytest.mark.parametrize("rel", VERB_AND_LINT_MODULES)
def test_verb_and_lint_modules_import_no_jax_and_name_their_reference(rel):
    """Each module of the cluster verbs and of the lint imports no JAX
    and nothing of the JAX package and names the reference file it
    ports; the lint keeps its own copy of ``absdomain`` (the reference's
    imports no JAX either)."""
    path = ROOT / rel
    tree = ast.parse(path.read_text(), str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if _forbidden(node.module or ""):
                found.append(node.module)
    assert found == []
    ref = rel.replace("volsync_tpu_torch/", "volsync_tpu/")
    assert (ROOT / ref).is_file()
    assert f"``{ref}``" in " ".join(ast.get_docstring(tree).split())


def test_cli_main_raises_without_cuda_before_storage(monkeypatch, tmp_path):
    """``cli.main`` with no ``device`` boots its demo runtime on CUDA:
    without CUDA a cluster verb raises before storage is made, a port
    bound or a relationship file written, while ``lint`` and ``trace``
    dispatch without touching a device."""
    from volsync_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("VOLSYNC_DEVICE", raising=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    storage, cfg = tmp_path / "storage", tmp_path / "cfg"
    monkeypatch.setenv("VOLSYNC_STORAGE_PATH", str(storage))
    monkeypatch.setenv("VOLSYNC_METRICS_PORT", str(port))
    for argv in (["--config-dir", str(cfg), "replication", "create", "x"],
                 ["--config-dir", str(cfg), "migration", "rsync", "x",
                  str(tmp_path)]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv, out=lambda s: None)
        assert _port_is_free(port)
        assert not storage.exists() and not cfg.exists()
    touched = []
    monkeypatch.setattr(torch, "device",
                        lambda *a, **k: touched.append(a))
    mod = tmp_path / "m.py"
    mod.write_text("X = 1\n")
    lines: list = []
    assert cli.main(["lint", str(mod), "--no-baseline"],
                    out=lines.append) == 0
    assert cli.main(["trace", "summary"], out=lines.append) == 0
    assert touched == []


def test_cli_lint_in_a_subprocess_loads_no_jax(tmp_path):
    """``python -m volsync_tpu_torch.cli lint`` and ``python -m
    volsync_tpu_torch.analysis`` in a fresh interpreter lint a file and
    import no JAX module and nothing of the JAX package."""
    mod = tmp_path / "m.py"
    mod.write_text("X = 1\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    for argv in (["volsync_tpu_torch.cli", "lint", str(mod), "--no-baseline"],
                 ["volsync_tpu_torch.analysis", str(mod), "--no-baseline"]):
        code = ("import json, runpy, sys\n"
                f"sys.argv = {argv!r}\n"
                "rc = None\n"
                "try:\n"
                f"    runpy.run_module({argv[0]!r}, run_name='__main__')\n"
                "except SystemExit as e:\n"
                "    rc = e.code\n"
                "print(json.dumps([rc, sorted(sys.modules)]))\n")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, env=env,
                             cwd=str(tmp_path), timeout=300, check=True)
        rc, mods = json.loads(out.stdout.strip().splitlines()[-1])
        assert rc == 0
        assert [m for m in mods if _forbidden(m)] == []
        assert "volsync_tpu_torch.analysis.engine" in mods
