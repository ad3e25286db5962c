"""The product paths through the port's mesh hasher: ``stream_chunks``
(segments carrying their tails into the next pass) and ``TreeBackup``
(the tree id commits to every chunk id) over 8 CPU shards in one
process, against the single-device engine.
"""

import numpy as np
import torch

from volsync_tpu_torch.engine.chunker import stream_chunks
from volsync_tpu_torch.ops.gearcdc import GearParams
from volsync_tpu_torch.parallel.sharded_chunker import (
    MeshChunkHasher,
    make_stream_mesh,
)

FUSED = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                   align=4096)
CPU = torch.device("cpu")


def _mesh(params=FUSED, n=8):
    return MeshChunkHasher(params, mesh=make_stream_mesh([CPU] * n))


def test_stream_chunks_through_mesh(rng):
    """The streaming path TreeBackup takes, over the mesh, with segments
    small enough to carry tails between passes."""
    data = rng.bytes(600_000 + 999)

    def reader():
        view = memoryview(data)
        pos = [0]

        def read(n):
            chunk = view[pos[0]: pos[0] + n]
            pos[0] += len(chunk)
            return bytes(chunk)
        return read

    mesh_out = list(stream_chunks(reader(), FUSED, segment_size=384 * 1024,
                                  hasher=_mesh()))
    single = list(stream_chunks(reader(), FUSED, segment_size=384 * 1024,
                                device="cpu"))
    assert [(len(c), d) for c, d in mesh_out] == \
        [(len(c), d) for c, d in single]
    assert b"".join(bytes(c) for c, _ in mesh_out) == data


def test_tree_backup_snapshots_bit_identical(tmp_path, rng):
    """TreeBackup through the mesh: the tree id equals the single-device
    one (it commits to every chunk id), and the repository restores."""
    from volsync_tpu_torch.engine.backup import TreeBackup
    from volsync_tpu_torch.engine.restore import restore_snapshot
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.repo.repository import Repository

    src = tmp_path / "src"
    (src / "d").mkdir(parents=True)
    (src / "big.bin").write_bytes(rng.bytes(600_000))
    (src / "d" / "small.txt").write_bytes(b"volsync" * 100)
    chunker = {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
               "seed": FUSED.seed, "align": 4096}

    def backup(name, hasher):
        repo = Repository.init(FsObjectStore(str(tmp_path / name)), "pw",
                               chunker=chunker, device="cpu")
        snap, _ = TreeBackup(repo, hasher=hasher, workers=1).run(src)
        return repo, dict(repo.list_snapshots())[snap]["tree"]

    _, single = backup("single", None)
    hasher = _mesh()
    repo, meshed = backup("mesh", hasher)
    assert meshed == single
    assert TreeBackup(repo, hasher=hasher).workers == 1  # not thread-safe
    dest = tmp_path / "restored"
    restore_snapshot(repo, dest, device="cpu")
    assert (dest / "big.bin").read_bytes() == (src / "big.bin").read_bytes()
