"""Mesh-sharded CDC chunk+hash: the multi-device product path.

Ports ``volsync_tpu/parallel/sharded_chunker.py``. ``MeshChunkHasher``
is a drop-in for ``engine.chunker.DeviceChunkHasher`` (the same
``process(buffer, eof)`` protocol), so ``stream_chunks`` and
``TreeBackup`` run sharded over a 1-D ``seq`` ring of devices with no
other change, and give the single-device engine's chunks and blob ids
bit for bit. A buffer is laid out ``[S, Ls]``: shard i holds bytes
``[i*Ls, (i+1)*Ls)`` as its own allocation on its device.

Three paths, picked by ``align`` as the single-device engine picks:

- **fused** (align 4096; ref ``_build_fused_fn``). Per shard: one K1
  ``sha256_pages`` over its row, stored PAGE-MAJOR, and its aligned
  candidates compacted at a per-shard cap. Shard s holds global pages
  ``s*npp ... s*npp+npp-1``, so the shards' page-major tables stacked
  in order ARE the global page-major table (word j of global page p at
  ``p*8 + j``): no third layout and no index remap. The candidate lists
  are all-gathered and sorted (sentinel ``2**31-2``), the counts
  ``psum``'d and the worst shard's ``pmax``'d; one ``fastcdc_walk`` runs
  on the global lists (``n_rows = S*R``). The one partial tail leaf is
  hashed by its owner shard, one ``sha256_slices`` span launch on its
  own row that writes the digest into its own table before the gather;
  then one ``merkle_roots(pagemajor=True, n_pages_pad=S*npp)`` on the
  gathered table and one fetch of the packed result, decoded with the
  capacity retry. The replicated stage runs once a process, on
  ``mesh.device``; every process computes the same packed result.
  (The reference forces word-major here because its per-shard Pallas
  table is lane-padded; the port pads no lane tile and ignores
  ``VOLSYNC_PAGEMAJOR`` on this path.)
- **leaf** (align > 1, not 4096): aligned candidates need no halo (a
  gear window ends inside one align row, which never crosses a seam).
- **byte** (align 1): per-byte candidates with the 31-byte left halo
  (``ppermute``; shard 0's halo table values zeroed).

The leaf and byte paths concatenate the per-shard lists in shard order
(with the capacity retry), walk on the host (``select_boundaries``),
and hash every 4 KiB leaf on the shard its start falls in: one
``sha256_slices`` launch a shard over its row plus a 4,095-byte right
halo (``ppermute`` leftward). Blob ids assemble on the host
(``repo/blobid.root_from_leaves``).
"""

from __future__ import annotations

import numpy as np
import torch

from volsync_tpu_torch.engine.chunker import _pow2ceil, _to_device
from volsync_tpu_torch.ops.gearcdc import (
    GearParams,
    gear_at_aligned,
    gear_doubling,
    nonzero_fixed,
    select_boundaries,
)
from volsync_tpu_torch.ops.segment import (
    _SENTINEL,
    LEAF_SIZE,
    _root_blocks_bound,
    _root_digests_loop,
    _select_boundaries_device,
    decode_with_overflow_check,
    segment_caps,
    tail_leaves_into,
)
from volsync_tpu_torch.ops.sha256 import (
    _M,
    _i32,
    sha256_chunks_device,
    sha256_pages,
)
from volsync_tpu_torch.parallel.engine import _HALO, _gear_table_values
from volsync_tpu_torch.parallel.mesh import (
    SEQ_AXIS,
    Mesh,
    all_gather,
    build_mesh,
    pmax,
    ppermute,
    psum,
)
from volsync_tpu_torch.repo import blobid

_LEAF = LEAF_SIZE


def make_stream_mesh(devices=None) -> Mesh:
    """All devices as one ``seq`` ring: a single stream's bytes shard
    across every device (default: every CUDA device of every process;
    raises without CUDA). Devices may repeat."""
    if devices is not None:
        devices = list(devices)
        return build_mesh(devices, (len(devices),), (SEQ_AXIS,))
    from volsync_tpu_torch.parallel import multihost

    n = len(multihost.local_devices()) * multihost.process_count()
    return build_mesh(None, (n,), (SEQ_AXIS,))


class MeshChunkHasher:
    """chunk+hash a byte buffer sharded over a 1-D device mesh."""

    #: NOT safe for concurrent process() calls: across processes the
    #: collectives of two calls would interleave differently on each
    #: rank. TreeBackup hashes one file at a time with this hasher.
    thread_safe = False

    def __init__(self, params: GearParams, mesh: Mesh = None):
        self.params = params
        self.mesh = mesh if mesh is not None else make_stream_mesh()
        if self.mesh.devices.ndim != 1:
            raise ValueError("MeshChunkHasher shards over a 1-D seq mesh")
        self.n_shards = self.mesh.size

    # -- public protocol (mirrors DeviceChunkHasher.process) ----------------

    def process(self, buffer, *, eof: bool = True
                ) -> list[tuple[int, int, str]]:
        if isinstance(buffer, (bytes, bytearray, memoryview)):
            buffer = np.frombuffer(buffer, dtype=np.uint8)
        length = int(buffer.shape[0])
        if length == 0:
            return []
        p = self.params
        if length <= p.min_size:
            if not eof:
                return []
            return [(0, length, blobid.blob_id(buffer.tobytes()))]
        rows, shard_len = self._upload(buffer, length)
        if p.align == _LEAF:
            return self._process_fused(rows, shard_len, length, eof)
        if p.align > 1:
            idx_s, idx_l = self._candidates_aligned(rows, shard_len, length)
        else:
            idx_s, idx_l = self._candidates(rows, shard_len, length)
        chunks = select_boundaries(idx_s, idx_l, length, p, eof=eof)
        if not chunks:
            return []
        hexes = self._span_roots(rows, shard_len, chunks)
        return [(int(s), int(l), h) for (s, l), h in zip(chunks, hexes)]

    # -- upload -------------------------------------------------------------

    def _upload(self, buffer: np.ndarray, length: int):
        """Pad to S * a pow2-bucketed shard length; this process's
        shards as tensors on their devices, each its own allocation (so
        every row starts on a 16-byte boundary). A short shard is zeroed
        on its device and its bytes copied in: no padded host copy."""
        S = self.n_shards
        shard_len = _pow2ceil((length + S - 1) // S, max(_LEAF, 64 * 1024))
        rows = []
        for k, dev in zip(self.mesh.local, self.mesh.local_devices):
            piece = np.ascontiguousarray(
                buffer[k * shard_len: min((k + 1) * shard_len, length)])
            if piece.shape[0] == shard_len:
                rows.append(_to_device(piece, dev))  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
                continue
            row = torch.zeros((shard_len,), dtype=torch.uint8, device=dev)  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
            if piece.shape[0]:
                if not piece.flags.writeable:
                    piece = piece.copy()
                row[: piece.shape[0]].copy_(torch.from_numpy(piece))  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
            rows.append(row)
        return rows, shard_len

    # -- fused page-aligned path --------------------------------------------

    def _process_fused(self, rows: list, shard_len: int, length: int,
                       eof: bool) -> list[tuple[int, int, str]]:
        padded = self.n_shards * shard_len
        cand_cap, chunk_cap = segment_caps(padded, self.params)
        # cand_cap is per shard here (compaction is local; the header's
        # candidate slot carries the WORST shard's true count).
        cand_cap = max(1024, cand_cap // self.n_shards)
        while True:
            packed = self._fused_pass(rows, shard_len, length, eof,
                                      cand_cap, chunk_cap)
            chunks, consumed, grown = decode_with_overflow_check(
                packed, length, cand_cap, chunk_cap)
            if grown is None:
                assert not eof or consumed == length
                return chunks
            cand_cap, chunk_cap = grown

    def _fused_pass(self, rows: list, shard_len: int, length: int,
                    eof: bool, cand_cap: int, chunk_cap: int) -> np.ndarray:
        """One fused pass -> the packed [4 + chunk_cap*10] result (u32
        words), fetched once."""
        p = self.params
        mesh = self.mesh
        S = self.n_shards
        align = p.align
        npp = shard_len // _LEAF
        R = shard_len // align
        tables, lpos, spos, nls = [], [], [], []
        for k, row in zip(mesh.local, rows):
            tables.append(sha256_pages(row, npp, pagemajor=True))  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
            pos, is_s, is_l = self._aligned_masks(k, row, shard_len, length)  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
            ridx = nonzero_fixed(is_l, cand_cap, R)  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
            safe = ridx.clamp(max=R - 1)  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
            hit = ridx < R
            lp = torch.where(hit, pos[safe], _SENTINEL)
            lpos.append(lp)
            spos.append(torch.where(hit & is_s[safe], lp, _SENTINEL))
            nls.append(torch.stack([is_l.sum(), is_s.sum()]))
        dev = mesh.device
        pos_l = all_gather(mesh, lpos).reshape(1, -1).sort(dim=1).values
        pos_s = all_gather(mesh, spos).reshape(1, -1).sort(dim=1).values
        nl, ns = psum(mesh, nls).clamp(max=S * cand_cap).reshape(2, 1)
        worst = pmax(mesh, nls)[0]
        starts, lens, count, consumed = _select_boundaries_device(
            pos_s, ns, pos_l, nl,
            torch.tensor([length], dtype=torch.int64, device=dev),
            torch.tensor([eof], dtype=torch.bool, device=dev),
            min_size=p.min_size, avg_size=p.avg_size, max_size=p.max_size,
            chunk_cap=chunk_cap, align=align, n_rows=S * R)
        starts, lens, count = starts[0], lens[0], count[0]

        # The ONE possibly-partial tail leaf, hashed by its owner shard
        # into its own table (one small fetch names the owner).
        last = (count.to(torch.int64) - 1).clamp(min=0)
        end = int(torch.where(count > 0, starts[last].to(torch.int64)
                              + lens[last], 0))
        if end % _LEAF:
            page = (end - 1) // _LEAF
            owner = page // npp
            if owner in mesh.local:
                i = mesh.local.index(owner)
                at = rows[i].device
                tables[i] = tail_leaves_into(
                    tables[i], npp, rows[i],
                    torch.tensor([(page % npp) * _LEAF], dtype=torch.int64,
                                 device=at),
                    torch.tensor([end - page * _LEAF], dtype=torch.int64,
                                 device=at),
                    pagemajor=True)
        flat = all_gather(mesh, tables).reshape(-1)  # global page-major

        live = torch.arange(chunk_cap, dtype=torch.int64,
                            device=dev) < count
        lens64 = lens.to(torch.int64)
        nleaves = torch.where(live, (lens64 + (_LEAF - 1)) // _LEAF, 0)
        roots = _root_digests_loop(
            flat, S * npp, starts.to(torch.int64) // _LEAF, nleaves, lens64,
            live, nb_max=_root_blocks_bound(p.max_size), pagemajor=True)
        header = torch.stack([count.to(torch.int64),
                              consumed[0].to(torch.int64), worst,
                              nleaves.sum()])
        packed = torch.cat([_i32(header & _M), starts, lens,
                            roots.reshape(-1)])
        return packed.cpu().numpy().view(np.uint32)

    # -- candidates ---------------------------------------------------------

    def _aligned_masks(self, k: int, row: torch.Tensor, shard_len: int,
                       length: int):
        """Shard k's aligned cut positions ``r*align + align-1`` (global)
        and their strict and lax candidate masks below ``length``. No
        halo: the gear window of an eligible position lies inside one
        align row, which never crosses a seam (shard_len % align == 0)."""
        p = self.params
        h = gear_at_aligned(row, p.seed, p.align)  # [R]
        pos = (k * shard_len + torch.arange(h.shape[0], dtype=torch.int64,
                                            device=row.device) * p.align
               + (p.align - 1))
        ok = pos < length
        return pos, ((h & p.mask_s) == 0) & ok, ((h & p.mask_l) == 0) & ok

    def _gather_host(self, parts: list) -> np.ndarray:
        return all_gather(self.mesh, parts).cpu().numpy()

    def _candidates(self, rows: list, shard_len: int, length: int):
        """Per-byte candidates with the 31-byte left halo -> (strict,
        lax) global positions, sorted."""
        p = self.params
        mesh = self.mesh
        halos = ppermute(mesh, [r[-_HALO:].contiguous() for r in rows], 1)
        masks = []
        for k, row, halo in zip(mesh.local, rows, halos):
            g = _gear_table_values(torch.cat([halo, row]), p.seed)
            if k == 0:
                g[:_HALO] = 0  # the true stream start: h starts from 0
            h = gear_doubling(g)[_HALO:]
            pos = k * shard_len + torch.arange(  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
                shard_len, dtype=torch.int64, device=row.device)
            ok = pos < length
            masks.append((((h & p.mask_s) == 0) & ok,
                          ((h & p.mask_l) == 0) & ok))
        # The lists' capacity: 1/64 of a shard's bytes (any mask down to
        # 2^-6 density, DeviceChunkHasher's bound), doubled past the
        # worst shard's count on dense data.
        cnt = self._gather_host([torch.stack([s.sum(), l.sum()])
                                 for s, l in masks])  # [S, 2]
        cap = _pow2ceil(int(cnt.max()), _pow2ceil(shard_len // 64, 1024))
        idx = self._gather_host([
            torch.stack([nonzero_fixed(s, cap, shard_len),  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
                         nonzero_fixed(l, cap, shard_len)])  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
            for s, l in masks])  # [S, 2, cap]
        # Shards are contiguous byte ranges in order: concatenation sorts.
        out = [np.concatenate([idx[i, j, : cnt[i, j]] + i * shard_len
                               for i in range(self.n_shards)])
               for j in (0, 1)]
        return out[0], out[1]

    def _candidates_aligned(self, rows: list, shard_len: int, length: int):
        """Aligned candidates (``_aligned_masks``) -> (strict, lax) global
        positions, sorted."""
        align = self.params.align
        R = shard_len // align
        flags = [self._aligned_masks(k, row, shard_len, length)[1:]  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
                 for k, row in zip(self.mesh.local, rows)]
        cnt = self._gather_host([l.sum() for _, l in flags])  # [S]
        cap = _pow2ceil(int(cnt.max()), 1024)  # the lists' capacity
        parts = []
        for is_s, is_l in flags:
            ridx = nonzero_fixed(is_l, cap, R)  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
            strict = (ridx < R) & is_s[ridx.clamp(max=R - 1)]  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
            parts.append(torch.stack([ridx, strict.to(torch.int64)]))  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
        got = self._gather_host(parts)  # [S, 2, cap]
        out_s, out_l = [], []
        for i in range(self.n_shards):
            n = int(cnt[i])
            pos = i * shard_len + got[i, 0, :n] * align + (align - 1)
            out_l.append(pos)
            out_s.append(pos[got[i, 1, :n].astype(bool)])
        return np.concatenate(out_s), np.concatenate(out_l)

    # -- Merkle leaf digests (leaf and byte paths) --------------------------

    def _span_roots(self, rows: list, shard_len: int,
                    chunks: list[tuple[int, int]]) -> list[str]:
        """Blob ids of ``chunks``: every 4 KiB leaf hashed on the shard
        its start falls in (one ``sha256_slices`` launch a shard over its
        row and a 4,095-byte right halo), the roots on the host."""
        S = self.n_shards
        if shard_len < _LEAF:
            raise ValueError("shards must cover at least one leaf")
        per_shard: list[list[tuple[int, int]]] = [[] for _ in range(S)]
        placement: list[tuple[int, int]] = []  # leaf -> (shard, slot)
        spans: list[tuple[int, int]] = []      # chunk -> (first leaf, n)
        for start, clen in chunks:
            first = len(placement)
            n = blobid.leaf_count(clen)
            for k in range(n):
                off = start + k * _LEAF
                llen = min(_LEAF, start + clen - off)
                shard = off // shard_len
                placement.append((shard, len(per_shard[shard])))
                per_shard[shard].append((off - shard * shard_len, llen))
            spans.append((first, n))
        cap = _pow2ceil(max((len(v) for v in per_shard), default=1),
                        max(shard_len // _LEAF // 8, 128))
        # Right halo: my leaves may run up to LEAF-1 bytes past my slice
        # (the last shard's wrap-around halo is never read: the stream
        # ends inside it).
        halos = ppermute(self.mesh, [r[: _LEAF - 1].contiguous()
                                     for r in rows], -1)
        digests = []
        for k, row, halo in zip(self.mesh.local, rows, halos):
            starts = np.zeros((cap,), np.int64)
            lengths = np.zeros((cap,), np.int64)
            for slot, (off, llen) in enumerate(per_shard[k]):
                starts[slot] = off
                lengths[slot] = llen
            at = row.device
            digests.append(sha256_chunks_device(  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
                torch.cat([row, halo]), torch.from_numpy(starts).to(at),  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
                torch.from_numpy(lengths).to(at), max_len=_LEAF))  # lint: ignore[VL502] per-shard phase: one dispatch a local mesh shard, the port's form of shard_map's per-device body
        flat = self._gather_host(digests).view(np.uint32).astype(
            ">u4").tobytes()  # [S, cap, 8] big-endian

        def leaf_bytes(shard: int, slot: int) -> bytes:
            base = (shard * cap + slot) * 32
            return flat[base: base + 32]

        return [blobid.root_from_leaves(
            clen, [leaf_bytes(*placement[first + k]) for k in range(n)])
            for (first, n), (_, clen) in zip(spans, chunks)]
