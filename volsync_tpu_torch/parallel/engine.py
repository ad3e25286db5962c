"""The sharded chunk+hash step over a ``(wave, seq)`` mesh.

Ports ``volsync_tpu/parallel/engine.py``. One step takes a ``[W, L]``
batch of byte streams (W independent streams of L bytes) laid out over
the mesh and returns:

- the gear-hash CDC candidate mask of every byte position (the strict
  per-position mask),
- the SHA-256 digest of every fixed ``block_len`` block,
- a bloom sketch of the digests summed over the whole mesh (``psum``),
  and candidate, byte and block counts.

A gear hash at position i depends on the 31 bytes before it, so each
seq shard receives its left neighbour's 31-byte tail (``ppermute``
one step right); shard 0 of the ring starts the true stream, so its
halo's TABLE VALUES are zeroed (zeroing the halo bytes would still add
``_mix_u32(seed)`` per position). The program runs as explicit phases:
per shard, then the collectives, then the totals on ``mesh.device``.

``sha256_fixed_blocks`` is one ``sha256_slices`` launch on CUDA
(``ops/sha256.sha256_chunks_device`` over the blocks as slices), its
twin ``_sha256_chunks_plain`` on the CPU; the gear hash, the mask and
the bloom are torch ops. Hash words are int64 values in ``[0, 2**32)``
masked with ``_M``: torch on the CPU has no uint32 ``+``, ``<<`` or
``>>``. Digests are int32 tensors holding the u32 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from volsync_tpu_torch import resolve_device
from volsync_tpu_torch.ops.gearcdc import (
    DEFAULT_PARAMS,
    GearParams,
    _mix_u32,
    gear_doubling,
)
from volsync_tpu_torch.ops.sha256 import sha256_chunks_device
from volsync_tpu_torch.parallel.mesh import (
    SEQ_AXIS,
    Mesh,
    all_gather,
    ppermute,
    psum,
    stream_sharding,
)

_HALO = 31  # gear window is 32 bytes -> 31 bytes of left context
_M = 0xFFFFFFFF


def _gear_table_values(data: torch.Tensor, seed: int) -> torch.Tensor:
    """Per-byte gear table values of ``data`` (uint8) -> int64 u32."""
    return _mix_u32((data.to(torch.int64) + (seed & _M)) & _M)


def _gear_lastaxis(data: torch.Tensor, seed: int) -> torch.Tensor:
    """Gear hash over the last axis ([..., L] uint8 -> [..., L] int64
    holding u32 values), the doubling form of ``ops/gearcdc.py``."""
    return gear_doubling(_gear_table_values(data, seed))


def sha256_fixed_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """SHA-256 of equal-length messages: [B, L] uint8, L % 64 == 0 ->
    [B, 8] int32 digests. CUDA: one ``sha256_slices`` launch, block i
    the slice (i*L, L) of the flat buffer, ``max_len`` L (64 KiB blocks
    run 1,025 message blocks a lane); CPU: its twin."""
    B, L = blocks.shape
    if L % 64:
        raise ValueError("fixed-block path requires 64-byte-aligned blocks")
    flat = blocks.reshape(B * L)
    if flat.device.type == "cuda" and flat.data_ptr() % 16:
        flat = flat.clone()
    starts = torch.arange(B, dtype=torch.int64, device=flat.device) * L
    lengths = torch.full((B,), L, dtype=torch.int64, device=flat.device)
    return sha256_chunks_device(flat, starts, lengths, max_len=L)


def _local_step(mesh: Mesh, shards: list, *, block_len: int, seed: int,
                mask_s: int, bloom_size: int):
    """Per shard: halo exchange, candidate mask, block digests and the
    shard's bloom; then the mesh-wide sums."""
    halos = ppermute(mesh, [d[:, -_HALO:].contiguous() for d in shards], 1,
                     SEQ_AXIS)
    digests, cands, blooms, counts = [], [], [], []
    for k, data, halo in zip(mesh.local, shards, halos):
        ext = torch.cat([halo, data], dim=1)  # [Wl, HALO + Sl]
        g = _gear_table_values(ext, seed)
        if mesh.axis_index(k, SEQ_AXIS) == 0:
            g[:, :_HALO] = 0  # the true stream start: h starts from 0
        h = gear_doubling(g)[:, _HALO:]
        cand = (h & mask_s) == 0
        Wl, Sl = data.shape
        nb = Sl // block_len
        dig = sha256_fixed_blocks(  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
            data.reshape(Wl * nb, block_len)).reshape(Wl, nb, 8)
        slot = (dig[..., 0].to(torch.int64) & (bloom_size - 1)).reshape(-1)  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
        bloom = torch.zeros((bloom_size,), dtype=torch.int32,  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
                            device=data.device)
        bloom[slot] = 1  # scatter-max of 1
        digests.append(dig)
        cands.append(cand)
        blooms.append(bloom)
        counts.append(cand.sum())
    bloom = psum(mesh, blooms)
    total_cand = psum(mesh, counts)
    return digests, cands, bloom, total_cand


def _assemble(mesh: Mesh, parts: list) -> torch.Tensor:
    """Shards [Wl, Sl, ...] of a (wave, seq) layout -> the global [W,
    L, ...] tensor on ``mesh.device``."""
    wave, seq = mesh.devices.shape
    g = all_gather(mesh, parts)  # [S, Wl, Sl, ...]
    Wl, Sl = g.shape[1], g.shape[2]
    rest = tuple(g.shape[3:])
    g = g.reshape(wave, seq, Wl, Sl, *rest).transpose(1, 2)
    return g.reshape(wave * Wl, seq * Sl, *rest)


def make_chunk_hash_step(mesh: Mesh, *, block_len: int = 64 * 1024,
                         params: GearParams = DEFAULT_PARAMS,
                         bloom_log2: int = 20):
    """The sharded step for ``mesh``: ``step(data)`` where data is a [W,
    L] uint8 host array (W divisible by the wave axis, L by seq axis x
    block_len) or this process's shards of it (``stream_sharding``).
    Returns, on ``mesh.device`` (every process gets the global
    tensors):

    - ``digests``   [W, L // block_len, 8] int32 — per-block SHA-256;
    - ``cand_mask`` [W, L] bool — strict per-position CDC candidates;
    - ``bloom``     [2^bloom_log2] int32 — digest-occupancy counts
      summed over the mesh (membership = > 0);
    - ``stats``: total_bytes, total_candidates, distinct_block_estimate,
      duplicate_block_estimate (byte and block totals are host ints: a
      device u32 would wrap at 4 GiB)."""
    if mesh.devices.ndim != 2:
        raise ValueError("the step runs on a (wave, seq) mesh")
    kw = dict(block_len=block_len, seed=params.seed,
              mask_s=params.dense_mask_s, bloom_size=1 << bloom_log2)
    wave, seq = mesh.devices.shape

    def step(data):
        if isinstance(data, np.ndarray):
            W, L = data.shape
            shards = stream_sharding(mesh, data)
        else:
            shards = list(data)
            Wl, Sl = shards[0].shape
            W, L = Wl * wave, Sl * seq
        if L % (seq * block_len):
            raise ValueError(f"L={L} is not a multiple of seq x block_len")
        digests, cands, bloom, total_cand = _local_step(mesh, shards, **kw)
        distinct = int((bloom > 0).sum())
        total_blocks = W * (L // block_len)
        return {
            "digests": _assemble(mesh, digests),
            "cand_mask": _assemble(mesh, cands),
            "bloom": bloom,
            "stats": {
                "total_bytes": W * L,
                "total_candidates": int(total_cand),
                "distinct_block_estimate": distinct,
                "duplicate_block_estimate": total_blocks - distinct,
            },
        }

    return step


def chunk_hash_block(data, *, block_len: int = 64 * 1024,
                     params: GearParams = DEFAULT_PARAMS, device=None):
    """The single-device step on one flat buffer: [L] uint8 (tensor,
    array or bytes) -> (block digests [L // block_len, 8] int32, CDC
    candidate count as a 0-d tensor). A tensor runs where it lies;
    other input goes to ``device`` (default CUDA)."""
    if not isinstance(data, torch.Tensor):
        if isinstance(data, (bytes, bytearray, memoryview)):
            data = np.frombuffer(data, dtype=np.uint8)
        data = torch.from_numpy(np.array(data, dtype=np.uint8)).to(
            resolve_device(device))
    h = _gear_lastaxis(data, params.seed)
    count = ((h & params.dense_mask_s) == 0).sum()
    nb = data.shape[0] // block_len
    digests = sha256_fixed_blocks(
        data[: nb * block_len].reshape(nb, block_len))
    return digests, count
