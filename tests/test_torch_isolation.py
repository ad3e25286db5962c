"""The port stands alone: no file of volsync_tpu_torch/ or chip_smoke.py
imports JAX or the JAX package (AST scan and a fresh-interpreter
``sys.modules`` diff), and with no CUDA and no ``device`` argument the
entry points (the durability path's, the delta engine's and the
movers' among them) raise instead of moving to the CPU."""

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
from volsync_tpu_torch.movers.restic import entry as restic_entry
from volsync_tpu_torch.movers.rsync import entry as rsync_entry
from volsync_tpu_torch.objstore.store import MemObjectStore
from volsync_tpu_torch.ops import gearcdc, md5, rs, segment, sha256
from volsync_tpu_torch.repo import erasure
from volsync_tpu_torch.repo.repack import RepackService
from volsync_tpu_torch.repo.repository import Repository
from volsync_tpu_torch.repo.scrub import ScrubService

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
            "volsync_tpu_torch/obs.py"} <= names
    assert len(_port_files()) >= 53


def test_importing_the_port_loads_no_jax_module():
    """Diff sys.modules around importing every port module in a fresh
    interpreter (the interpreter's startup may already hold jax, so the
    check is on what the import adds)."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))
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
    assert "volsync_tpu_torch.ops.segment" in added
    assert [m for m in added if _forbidden(m)] == []


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
    """The movers' entry points run on CUDA unless given a device: with
    no CUDA, a ``JobContext`` with no ``device`` and no ``device=`` they
    raise before they bind, connect, send or write anything."""
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
