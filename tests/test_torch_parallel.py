"""The port's mesh, collectives and sharded step
(volsync_tpu_torch/parallel/) against the reference's on the 8 virtual
CPU devices tests/conftest.py sets up.

The port's meshes here are 8 CPU shards in one process (a mesh's
devices may repeat); the collectives run as copies between them. Every
output is compared bit for bit with the reference's on the same seeded
input, and the digests also with hashlib.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsync_tpu.ops.gearcdc import GearParams as RefGearParams
from volsync_tpu.parallel import chunk_hash_block as ref_chunk_hash_block
from volsync_tpu.parallel import make_chunk_hash_step as ref_step
from volsync_tpu.parallel import make_mesh as ref_make_mesh
from volsync_tpu.parallel import sha256_fixed_blocks as ref_fixed
from volsync_tpu.parallel import stream_sharding as ref_sharding
from volsync_tpu.parallel.mesh import _factor_2d as ref_factor
from volsync_tpu_torch.ops.gearcdc import DEFAULT_PARAMS, GearParams
from volsync_tpu_torch.parallel import (
    SEQ_AXIS,
    WAVE_AXIS,
    chunk_hash_block,
    make_chunk_hash_step,
    make_mesh,
    replicated,
    sha256_fixed_blocks,
    stream_sharding,
)
from volsync_tpu_torch.parallel import mesh as pmesh
from volsync_tpu_torch.parallel.engine import _gear_lastaxis
from volsync_tpu_torch.parallel.sharded_chunker import make_stream_mesh

CPU = torch.device("cpu")
BLOCK = 256  # small blocks keep the CPU twins fast


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def meshes():
    return make_mesh([CPU] * 8), ref_make_mesh(jax.devices())


def test_factor_2d_matches_reference():
    for n in range(1, 33):
        assert pmesh._factor_2d(n) == ref_factor(n)


@pytest.mark.parametrize("n,shape", [(1, None), (2, None), (4, None),
                                     (8, None), (8, (4, 2)), (8, (1, 8))])
def test_make_mesh_shapes_match_reference(n, shape):
    got = make_mesh([CPU] * n, shape)
    want = ref_make_mesh(jax.devices()[:n], shape)
    assert got.devices.shape == want.devices.shape
    assert got.axis_names == tuple(want.axis_names) == (WAVE_AXIS, SEQ_AXIS)
    assert got.devices.size == n and got.local == tuple(range(n))
    assert got.group is None and got.device == CPU


def test_make_mesh_errors(monkeypatch):
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh([CPU] * 8, (3, 3))
    with pytest.raises(ValueError, match="mesh shape"):
        ref_make_mesh(jax.devices(), (3, 3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (make_mesh, make_stream_mesh):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("shift", [1, -1])
def test_ppermute_ring_both_ways(shift):
    """1-D ring and the seq rings of a (2, 4) mesh: shard k receives the
    tensor of the shard ``shift`` steps behind it on its own ring."""
    ring = make_stream_mesh([CPU] * 4)
    xs = [torch.full((3,), k, dtype=torch.int64) for k in range(4)]
    got = [int(t[0]) for t in pmesh.ppermute(ring, xs, shift)]
    assert got == [(k - shift) % 4 for k in range(4)]
    grid = make_mesh([CPU] * 8)  # (2, 4)
    xs = [torch.tensor([k]) for k in range(8)]
    got = [int(t[0]) for t in pmesh.ppermute(grid, xs, shift, SEQ_AXIS)]
    assert got == [4 * (k // 4) + (k % 4 - shift) % 4 for k in range(8)]
    got = [int(t[0]) for t in pmesh.ppermute(grid, xs, shift, WAVE_AXIS)]
    assert got == [(k + 4) % 8 for k in range(8)]


def test_all_gather_psum_pmax():
    mesh = make_mesh([CPU] * 8)
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.integers(-50, 50, (2, 3))) for _ in range(8)]
    want = np.stack([x.numpy() for x in xs])
    assert np.array_equal(pmesh.all_gather(mesh, xs).numpy(), want)
    assert np.array_equal(pmesh.psum(mesh, xs).numpy(), want.sum(0))
    assert np.array_equal(pmesh.pmax(mesh, xs).numpy(), want.max(0))
    flags = [x > 0 for x in xs]
    assert np.array_equal(pmesh.all_gather(mesh, flags).numpy(), want > 0)


def test_stream_sharding_and_replicated(rng):
    mesh = make_mesh([CPU] * 8)
    host = rng.randint(0, 256, size=(4, 64), dtype=np.uint8)
    shards = stream_sharding(mesh, host)
    assert len(shards) == 8 and all(s.shape == (2, 16) for s in shards)
    assert np.array_equal(shards[5].numpy(), host[2:4, 16:32])
    assert replicated(mesh, np.arange(3)).device == CPU
    with pytest.raises(ValueError, match="does not split"):
        stream_sharding(mesh, host[:3])


@pytest.mark.parametrize("L", [64, 128, 4096])
@pytest.mark.parametrize("B", [1, 7])
def test_sha256_fixed_blocks_matches_reference(B, L):
    rng = np.random.default_rng(B * 10_000 + L)
    blocks = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
    got = _u32(sha256_fixed_blocks(torch.from_numpy(blocks)))
    want = np.asarray(ref_fixed(jnp.asarray(blocks)))
    assert np.array_equal(got, want)
    for i in range(B):
        assert got[i].astype(">u4").tobytes() == \
            hashlib.sha256(blocks[i].tobytes()).digest()
    with pytest.raises(ValueError, match="64-byte"):
        sha256_fixed_blocks(torch.zeros((1, 100), dtype=torch.uint8))


def test_sharded_step_matches_reference(meshes, rng):
    """The (2, 4) mesh over 8 CPU shards against the reference's step on
    its 8 devices: digests, candidate mask (halo seams included), bloom
    and every stat equal; digests equal hashlib."""
    mesh, rmesh = meshes
    wave, seq = mesh.devices.shape
    W, L = 2 * wave, seq * 4 * BLOCK
    host = rng.randint(0, 256, size=(W, L), dtype=np.uint8)
    # duplicate blocks exercise the dedup sketch; a candidate-dense run
    # of zeros crosses a seq seam
    host[0, :BLOCK] = host[1, BLOCK:2 * BLOCK] = host[0, 4 * BLOCK:5 * BLOCK]
    host[2, 4 * BLOCK - 40:4 * BLOCK + 40] = 0
    # a 7-bit dense mask: ~1 candidate in 128 bytes, so seams matter
    sizes = dict(min_size=32, avg_size=32, max_size=64, align=1)
    kw = dict(block_len=BLOCK, bloom_log2=12)
    out = make_chunk_hash_step(mesh, params=GearParams(**sizes), **kw)(host)
    ref = ref_step(rmesh, params=RefGearParams(**sizes), **kw)(
        jax.device_put(host, ref_sharding(rmesh)))

    digests = _u32(out["digests"])
    assert np.array_equal(digests, np.asarray(ref["digests"]))
    for w in range(W):
        for b in range(L // BLOCK):
            assert digests[w, b].astype(">u4").tobytes() == hashlib.sha256(
                host[w, b * BLOCK:(b + 1) * BLOCK].tobytes()).digest()
    assert np.array_equal(out["cand_mask"].numpy(),
                          np.asarray(ref["cand_mask"]))
    assert np.array_equal(out["bloom"].numpy(),
                          np.asarray(ref["bloom"]).astype(np.int32))
    stats = out["stats"]
    assert stats == {k: int(v) for k, v in ref["stats"].items()}
    assert stats["total_candidates"] == int(out["cand_mask"].sum()) > 0
    assert stats["duplicate_block_estimate"] >= 2

    # the same step from pre-sharded tensors
    again = make_chunk_hash_step(mesh, params=GearParams(**sizes), **kw)(
        stream_sharding(mesh, host))
    assert torch.equal(again["digests"], out["digests"])
    assert again["stats"] == stats


def test_chunk_hash_block_matches_reference(rng):
    L = 8 * BLOCK + 100
    data = rng.randint(0, 256, size=(L,), dtype=np.uint8)
    params = GearParams(min_size=4096, avg_size=16384, max_size=65536)
    ref_params = RefGearParams(min_size=4096, avg_size=16384,
                               max_size=65536)
    for p, rp in ((DEFAULT_PARAMS, RefGearParams(align=4096)),
                  (params, ref_params)):
        dig, count = chunk_hash_block(data, block_len=BLOCK, params=p,
                                      device="cpu")
        rdig, rcount = ref_chunk_hash_block(data, block_len=BLOCK,
                                            params=rp)
        assert np.array_equal(_u32(dig), np.asarray(rdig))
        assert int(count) == int(rcount)
    h = _gear_lastaxis(torch.from_numpy(data), DEFAULT_PARAMS.seed)
    assert int(count) == int(((h & params.dense_mask_s) == 0).sum())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chunk_hash_block(data.tobytes(), block_len=BLOCK)
