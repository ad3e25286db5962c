"""The port's multi-process meshes (volsync_tpu_torch/parallel/multihost.py).

The single-process contract of tests/test_cluster.py's multihost cases
(idempotent, a soft failure does not latch, ``require=True`` fails
hard, a re-init with other arguments raises), the torchrun environment
triplet, and TWO processes joined over gloo with 2 CPU shards each: the
sharded step on a 4-shard seq ring that spans both, and ``TreeBackup``
plus the leaf and byte paths of ``MeshChunkHasher`` through a mesh
spanning both. Every cross-process result must equal the in-process
4-shard one. The worker is this file run as a script (``__main__``).
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from volsync_tpu_torch.ops.gearcdc import GearParams
from volsync_tpu_torch.parallel import multihost
from volsync_tpu_torch.parallel.engine import make_chunk_hash_step
from volsync_tpu_torch.parallel.mesh import make_mesh
from volsync_tpu_torch.parallel.sharded_chunker import (
    MeshChunkHasher,
    make_stream_mesh,
)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TRIPLET = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
STEP = dict(block_len=256, bloom_log2=12,
            params=GearParams(min_size=32, avg_size=32, max_size=64,
                              align=1))
FUSED = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                   align=4096)
LEAF = GearParams(min_size=4096, avg_size=16384, max_size=65536)
BYTE = GearParams(min_size=4096, avg_size=16384, max_size=65536, align=1)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def no_group(monkeypatch):
    for k in TRIPLET:
        monkeypatch.delenv(k, raising=False)
    multihost.shutdown_distributed()
    yield
    multihost.shutdown_distributed()


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


# -- the work both sides run --------------------------------------------------

def step_result() -> dict:
    host = np.random.RandomState(5).randint(0, 256, size=(2, 4 * 4 * 256),
                                            dtype=np.uint8)
    host[1, 1000:1100] = 0  # a seam of the 4-shard ring inside a run
    mesh = make_mesh([CPU] * 4, (1, 4))
    out = make_chunk_hash_step(mesh, **STEP)(host)
    return {"digests": _digest(out["digests"]),
            "cand_mask": _digest(out["cand_mask"]),
            "bloom": _digest(out["bloom"]), "stats": out["stats"]}


def make_tree(root: Path) -> None:
    rng = np.random.RandomState(9)
    (root / "d").mkdir(parents=True)
    (root / "big.bin").write_bytes(rng.bytes(300_000))
    (root / "d" / "small.txt").write_bytes(b"volsync" * 100)


def product_result(src: Path) -> dict:
    from volsync_tpu_torch.engine.backup import TreeBackup
    from volsync_tpu_torch.objstore.store import MemObjectStore
    from volsync_tpu_torch.repo.repository import Repository

    mesh = make_stream_mesh([CPU] * 4)
    chunker = {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
               "seed": FUSED.seed, "align": 4096}
    repo = Repository.init(MemObjectStore(), "pw", chunker=chunker,
                           device="cpu")
    snap, _ = TreeBackup(repo, hasher=MeshChunkHasher(FUSED, mesh=mesh)).run(
        src)
    buf = np.random.RandomState(3).randint(0, 256, size=(200_000,),
                                           dtype=np.uint8)
    return {"tree": dict(repo.list_snapshots())[snap]["tree"],
            "leaf": MeshChunkHasher(LEAF, mesh=mesh).process(buf),
            "byte": MeshChunkHasher(BYTE, mesh=mesh).process(buf)}


# -- single process -----------------------------------------------------------

def test_init_single_process_no_configuration(no_group):
    """No configuration: a warning and the one-process summary, every
    time (the soft path does not latch)."""
    info = multihost.init_distributed(device="cpu")
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 1, "global_devices": 1}
    assert multihost.init_distributed(device="cpu") == info
    assert getattr(multihost.init_distributed, "_done_args", None) is None
    assert multihost.process_group() is None


def test_require_fails_hard_and_soft_does_not_latch(no_group):
    with pytest.raises(RuntimeError, match="explicitly requested"):
        multihost.init_distributed(require=True, device="cpu")
    info = multihost.init_distributed(device="cpu")
    assert info["process_count"] == 1
    assert getattr(multihost.init_distributed, "_done_args", None) is None
    with pytest.raises(RuntimeError, match="explicitly requested"):
        multihost.init_distributed(require=True, device="cpu")
    with pytest.raises(RuntimeError, match="incomplete"):
        multihost.init_distributed("127.0.0.1:1", device="cpu")


def test_reinit_with_other_arguments_raises(no_group):
    """An explicit one-process gloo group: idempotent with the same
    arguments, RuntimeError with others; a mesh made under it carries
    the group and its collectives go through gloo."""
    addr = f"127.0.0.1:{_free_port()}"
    info = multihost.init_distributed(addr, 1, 0, device="cpu")
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 1, "global_devices": 1}
    assert multihost.init_distributed(addr, 1, 0, device="cpu") == info
    with pytest.raises(RuntimeError, match="already ran"):
        multihost.init_distributed(addr, 2, 0, device="cpu")
    with pytest.raises(RuntimeError, match="already ran"):
        multihost.init_distributed(device="cpu")
    mesh = make_stream_mesh([CPU] * 2)
    assert mesh.group is not None and mesh.local == (0, 1)
    from volsync_tpu_torch.parallel import mesh as pmesh

    xs = [torch.tensor([1, 5]), torch.tensor([3, 2])]
    assert pmesh.all_gather(mesh, xs).tolist() == [[1, 5], [3, 2]]
    assert pmesh.psum(mesh, xs).tolist() == [4, 7]
    assert pmesh.pmax(mesh, xs).tolist() == [3, 5]
    assert [t.tolist() for t in pmesh.ppermute(mesh, xs, 1)] == \
        [[3, 2], [1, 5]]


def test_torchrun_environment_triplet(no_group, monkeypatch):
    """MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK configure the join
    (the reference reads JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/
    JAX_PROCESS_ID)."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    info = multihost.init_distributed(device="cpu")
    assert info["process_count"] == 1
    assert multihost.process_group() is not None
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.init_distributed(device="cpu") == info  # latched


def test_without_cuda_raises_before_joining(no_group, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"require": True}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            multihost.init_distributed(**kw)


# -- two processes over gloo --------------------------------------------------

def _run_pair(mode: str, *extra) -> list:
    """This file as a worker in both slots of a 2-process gloo group ->
    each worker's JSON result."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    env["CUDA_VISIBLE_DEVICES"] = ""
    for k in TRIPLET:
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, f"127.0.0.1:{port}", str(rank),
         *extra], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=str(ROOT)) for rank in range(2)]
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, stderr[-2000:]
            out.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def test_two_process_sharded_step():
    results = _run_pair("step")
    want = step_result()  # the same 4-shard ring in one process
    for r in results:
        assert r["result"] == json.loads(json.dumps(want))
        assert r["info"] == {"process_index": r["info"]["process_index"],
                             "process_count": 2, "local_devices": 1,
                             "global_devices": 2}
        assert r["local"] == [2 * r["info"]["process_index"],
                              2 * r["info"]["process_index"] + 1]
    assert want["stats"]["total_candidates"] > 0


def test_two_process_treebackup_and_paths(tmp_path):
    src = tmp_path / "src"
    make_tree(src)
    results = _run_pair("product", str(src))
    want = json.loads(json.dumps(product_result(src)))
    for r in results:
        assert r["result"] == want


def _worker(argv: list) -> int:
    mode, addr, rank = argv[0], argv[1], int(argv[2])
    info = multihost.init_distributed(addr, 2, rank, device="cpu")
    if mode == "step":
        result = step_result()
        local = list(make_mesh([CPU] * 4, (1, 4)).local)
    else:
        result = product_result(Path(argv[3]))
        local = list(make_stream_mesh([CPU] * 4).local)
    print(json.dumps({"info": info, "local": local, "result": result}),
          flush=True)
    multihost.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
