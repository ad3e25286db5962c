"""The port's MeshChunkHasher on its leaf (align 64) and byte (align 1)
paths, 8 CPU shards in one process, against the reference's.

Buffers are sized so that every shard seam is crossed (8 shards of 64
or 128 KiB): the gear halo of the byte path and the 4,095-byte right
halo of the leaf stage are where a sharded engine would break. Each
path is held directly against the reference's ``MeshChunkHasher`` on
its 8 virtual CPU devices, and the other cases against the port's and
the reference's single-device engines. The fused path (align 4096) is
tests/test_torch_sharded_fused.py; ``stream_chunks`` and ``TreeBackup``
through the mesh are tests/test_torch_mesh_backup.py.
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

SIZES = dict(min_size=4096, avg_size=16384, max_size=65536)
LEAF = GearParams(**SIZES)  # align 64: the leaf path
BYTE = GearParams(**SIZES, align=1)  # the byte path
CPU = torch.device("cpu")


def _mesh(params):
    return MeshChunkHasher(params, mesh=make_stream_mesh([CPU] * 8))


def _ref(params):
    return RefGearParams(**{k: getattr(params, k) for k in
                            ("min_size", "avg_size", "max_size", "seed",
                             "norm_level", "align")})


def _tiles(chunks, n):
    pos = 0
    for start, length, _ in chunks:
        assert start == pos
        pos += length
    assert pos == n


@pytest.fixture(scope="module")
def leaf_case():
    buf = np.random.RandomState(1234).randint(0, 256, size=(700_000,),
                                              dtype=np.uint8)
    return buf, _mesh(LEAF).process(buf)


def test_leaf_path_identical_to_reference_mesh(leaf_case):
    buf, sharded = leaf_case
    assert sharded == RefMesh(_ref(LEAF)).process(buf)
    assert sharded == DeviceChunkHasher(LEAF, device="cpu").process(buf)
    _tiles(sharded, buf.shape[0])


def test_digests_match_hashlib(leaf_case):
    buf, sharded = leaf_case
    assert len(sharded) > 8
    for start, length, hexd in sharded:
        assert blobid.blob_id(buf[start:start + length].tobytes()) == hexd


def test_identical_without_eof(rng):
    buf = rng.randint(0, 256, size=(512 * 1024 + 5,), dtype=np.uint8)
    sharded = _mesh(LEAF).process(buf, eof=False)
    assert sharded == DeviceChunkHasher(LEAF, device="cpu").process(
        buf, eof=False)
    assert sharded == RefHasher(_ref(LEAF)).process(buf, eof=False)
    assert 0 < sum(n for _, n, _ in sharded) < buf.shape[0]


def test_pathological_zeros_cut_at_max():
    """All zeros has no candidates anywhere: every cut is a forced
    max_size cut, on every shard and across every seam."""
    buf = np.zeros((512 * 1024 + 3,), dtype=np.uint8)
    sharded = _mesh(LEAF).process(buf)
    assert sharded == DeviceChunkHasher(LEAF, device="cpu").process(buf)
    assert {length for _, length, _ in sharded[:-1]} == {LEAF.max_size}


def test_small_and_empty_buffers():
    mesh = _mesh(LEAF)
    assert mesh.process(np.zeros((0,), np.uint8)) == []
    tiny = np.arange(100, dtype=np.uint8)
    assert mesh.process(tiny) == [(0, 100, blobid.blob_id(tiny.tobytes()))]
    assert mesh.process(tiny, eof=False) == []
    assert mesh.process(tiny.tobytes()) == mesh.process(tiny)
    assert MeshChunkHasher.thread_safe is False


def test_byte_path_identical_to_reference_mesh(rng):
    """align 1: per-byte candidates with the 31-byte left halo; a run of
    equal bytes straddles a seam."""
    buf = rng.randint(0, 256, size=(480_000,), dtype=np.uint8)
    buf[65_536 - 100:65_536 + 100] = 7
    sharded = _mesh(BYTE).process(buf)
    assert sharded == RefMesh(_ref(BYTE)).process(buf)
    assert sharded == DeviceChunkHasher(BYTE, device="cpu").process(buf)
    _tiles(sharded, buf.shape[0])


def test_byte_path_without_eof(rng):
    buf = rng.randint(0, 256, size=(400_000,), dtype=np.uint8)
    sharded = _mesh(BYTE).process(buf, eof=False)
    assert sharded == DeviceChunkHasher(BYTE, device="cpu").process(
        buf, eof=False)
    assert sharded == RefHasher(_ref(BYTE)).process(buf, eof=False)


def test_byte_path_candidate_retry(rng):
    """A dense mask overflows the first candidate capacity (1/64 of a
    shard's bytes): the worst shard's count sizes the lists, and the
    result equals the single-device engine's."""
    dense = GearParams(min_size=64, avg_size=64, max_size=256, align=1)
    buf = rng.randint(0, 256, size=(300_000,), dtype=np.uint8)
    sharded = _mesh(dense).process(buf)
    assert sharded == DeviceChunkHasher(dense, device="cpu").process(buf)
