"""The port's MeshChunkHasher on its fused path (align 4096).

8 CPU shards in one process (4 where a case repeats passes). The fused
pass keeps each shard's K1 table page-major, so the shards' tables
stacked in order are the global table the walk's chunks and
``merkle_roots`` read; the one partial tail leaf is spliced by its
owner shard. The fused pass is held directly against
the reference's ``MeshChunkHasher`` on its 8 virtual CPU devices, the
other cases against the single-device engines of both packages.
``stream_chunks`` and ``TreeBackup`` through a mesh are
tests/test_torch_mesh_backup.py.
"""

import numpy as np
import pytest
import torch

from volsync_tpu.engine.chunker import DeviceChunkHasher as RefHasher
from volsync_tpu.ops.gearcdc import GearParams as RefGearParams
from volsync_tpu.parallel.sharded_chunker import MeshChunkHasher as RefMesh
from volsync_tpu_torch.engine.chunker import DeviceChunkHasher
from volsync_tpu_torch.ops.gearcdc import GearParams
from volsync_tpu_torch.parallel.sharded_chunker import (
    MeshChunkHasher,
    make_stream_mesh,
)
from volsync_tpu_torch.repo import blobid

FUSED = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                   align=4096)
REF_FUSED = RefGearParams(min_size=4096, avg_size=32768, max_size=65536,
                          align=4096)
CPU = torch.device("cpu")


def _mesh(params=FUSED, n=8):
    return MeshChunkHasher(params, mesh=make_stream_mesh([CPU] * n))


@pytest.fixture(scope="module")
def fused_case():
    buf = np.random.RandomState(77).randint(0, 256, size=(700_000 + 777,),
                                            dtype=np.uint8)
    return buf, _mesh().process(buf)


def test_fused_identical_to_reference_mesh(fused_case):
    buf, sharded = fused_case
    assert sharded == RefMesh(REF_FUSED).process(buf)
    assert sharded == DeviceChunkHasher(FUSED, device="cpu").process(buf)
    pos = 0
    for start, length, hexd in sharded:
        assert start == pos
        assert hexd == blobid.blob_id(buf[start:start + length].tobytes())
        pos += length
    assert pos == buf.shape[0] and pos % 4096  # the tail leaf is partial


def test_fused_without_eof(rng):
    buf = rng.randint(0, 256, size=(500_000,), dtype=np.uint8)
    sharded = _mesh().process(buf, eof=False)
    assert sharded == DeviceChunkHasher(FUSED, device="cpu").process(
        buf, eof=False)
    assert sharded == RefHasher(REF_FUSED).process(buf, eof=False)
    end = sum(n for _, n, _ in sharded)
    assert 0 < end < buf.shape[0] and end % 4096 == 0


def test_fused_zero_entropy_max_cuts():
    buf = np.zeros((500_000,), np.uint8)
    sharded = _mesh().process(buf)
    assert sharded == DeviceChunkHasher(FUSED, device="cpu").process(buf)
    assert all(n <= FUSED.max_size for _, n, _ in sharded)
    # constant data -> every full chunk identical -> total dedup
    assert len({d for _, _, d in sharded[:-1]}) == 1


def test_fused_capacity_retry(fused_case, monkeypatch):
    """chunk_cap starts far too small for the chunks this data makes;
    the in-band counts drive the doubling retry to the same result."""
    buf, normal = fused_case
    passes = []
    mesh = _mesh(n=4)
    real = mesh._fused_pass

    def counted(*a):
        passes.append(a[-1])  # chunk_cap of the pass
        return real(*a)

    mesh._fused_pass = counted
    monkeypatch.setattr(
        "volsync_tpu_torch.parallel.sharded_chunker.segment_caps",
        lambda padded, params: (1024, 16))
    assert len(normal) > 16
    assert mesh.process(buf) == normal
    assert passes[0] == 16 and len(passes) >= 2
