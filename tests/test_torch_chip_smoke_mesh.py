"""chip_smoke.py's mesh and session phases rehearsed on the CPU at a tiny
size: the mesh phase's three cells (fused, align 64, align 1) through a
2-shard CPU mesh and the default one-shard mesh against the
single-device engine, the sharded step against its host oracles, the
fixed-block entry, ``init_distributed``, the mesh TreeBackup and the
restic entry with ``VOLSYNC_ENGINE=mesh``, and the session phase with
its probes on the CPU (the launch counts are checked on the card
only)."""

import numpy as np
import pytest
import torch

import chip_smoke
from volsync_tpu_torch.ops.gearcdc import GearParams

torch.set_num_threads(1)

FUSED = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                   align=4096)
P64 = GearParams(min_size=4096, avg_size=32768, max_size=65536, align=64)
P1 = GearParams(min_size=4096, avg_size=32768, max_size=65536, align=1)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "BLOCK", 128 * 1024)
    monkeypatch.setattr(chip_smoke, "MESH_SHARDS", 2)
    monkeypatch.setattr(chip_smoke, "MESH_STEP", (4, 8 * 1024))
    monkeypatch.setattr(chip_smoke, "MESH_BLOCK", 1024)
    monkeypatch.setattr(chip_smoke, "FIXED_SHAPE", (8, 1024))
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda torch, fn, reps, graph=True: 0.0)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)


def test_stream_head_keeps_only_its_blocks(on_cpu):
    stream = chip_smoke.SeededStream(torch, 2, 6 * 128 * 1024 + 12345)
    head = chip_smoke.stream_head(stream, 2 * 128 * 1024 + 5)
    assert head.total == 2 * 128 * 1024 + 5 and len(head.plan) == 3
    assert sum(u is not None for u in head.unique) <= 3
    assert bytes(head.view(0, head.total)) == bytes(stream.view(0,
                                                                head.total))
    assert chip_smoke.stream_head(stream, stream.total) is stream


def test_mesh_phase_on_cpu(on_cpu):
    stats = chip_smoke.new_stats()
    cells = []
    for label, params in (("fused", FUSED), ("align=64", P64),
                          ("align=1", P1)):
        stream = chip_smoke.SeededStream(torch, 3, 3 * 128 * 1024 + 12345)
        run = chip_smoke.drive(torch, stream, params, {}, label)
        cells.append(chip_smoke.mesh_cell(label, params, stream,
                                          2 * 128 * 1024 + 777, run))
    out = chip_smoke.mesh_phase(torch, cells, stats, 5, "cpu")
    for label in ("fused", "align=64", "align=1"):
        assert out[label]["mesh"]["passes"] >= 1
    assert out["fused"]["default"]["passes"] >= 1
    assert out["fused"]["mesh"]["tails"] <= out["fused"]["mesh"]["passes"]
    assert out["step"]["stats"]["total_bytes"] == 4 * 8 * 1024
    assert out["multihost"]["process_count"] == 1
    st = stats["sha256_slices_fixed"]
    assert st["err"] == 0 and st["plain_ms"] and st["bound"][0] > 0


def test_mesh_tree_check_on_cpu(on_cpu, tmp_path, monkeypatch):
    from volsync_tpu_torch.engine.backup import TreeBackup
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.repo.repository import Repository

    monkeypatch.setenv("VOLSYNC_BACKUP_WORKERS", "1")
    src = tmp_path / "src"
    (src / "d").mkdir(parents=True)
    (src / "big.bin").write_bytes(np.random.default_rng(4).bytes(700_000))
    (src / "d" / "small").write_bytes(b"x" * 1000)
    repo = Repository.init(FsObjectStore(tmp_path / "single"),
                           chip_smoke.EC_PASSWORD, device="cpu")
    snap, _ = TreeBackup(repo).run(src, hostname="chip-smoke")
    tree = dict(repo.list_snapshots())[snap]["tree"]
    out = chip_smoke.mesh_tree_check(torch, tmp_path, src, tree, "cpu")
    assert out["secs"] > 0
    assert not (tmp_path / "mesh-repo").exists()


def test_session_phase_on_cpu(on_cpu, tmp_path):
    out = chip_smoke.session_phase(torch, tmp_path, 7, "cpu",
                                   nbytes=200_000)
    assert out["device"].startswith("probe: WEDGED")  # CUDA's, absent here
    assert out["probe_s"] > 0 and out["job_s"] > 0
