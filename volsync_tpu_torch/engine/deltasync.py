"""rsync-style delta synchronization engine on the card.

Ports ``volsync_tpu/engine/deltasync.py``: the algorithm of the
reference's ``rsync -aAhHSxz --delete`` hot loop (mover-rsync/source.sh:54)
on the port's device primitives (ops/rolling.py, ops/delta.py,
ops/md5.py):

  destination:  per-block signature = (weak32, MD5) per block_len block
  source:       rolling weak checksum at EVERY offset in one parallel
                pass -> membership vs the signature's sorted weak set ->
                batched MD5 verification of candidate windows -> greedy
                left-to-right op selection on host (sparse matches only)
  ops stream:   COPY(block_index, n_blocks) | DATA(bytes), applied on the
                destination against its current file

Block size follows rsync's heuristic (~sqrt(file size), bounded), and
batched rows are bucket-padded (engine/chunker._buffer_bucket), so the
op streams, signatures and wire forms are the reference's bit for bit.
``build_file_signature``, ``compute_delta`` and ``delta_scan_batch`` take
``device=`` (CUDA by default, raising where it is absent); the reference
runs on JAX's default device.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from volsync_tpu_torch import resolve_device
from volsync_tpu_torch.engine.chunker import _buffer_bucket, _to_device
from volsync_tpu_torch.ops.delta import (
    build_signature,
    match_offsets,
    match_offsets_batch,
    verify_candidates,
    verify_candidates_batch,
)
from volsync_tpu_torch.ops.md5 import state_bytes
from volsync_tpu_torch.ops.rolling import weak_checksum_host

MIN_BLOCK = 4096
MAX_BLOCK = 128 * 1024

#: Wire cost of one signature block: weak32 + 16-byte MD5 (to_wire).
SIG_BYTES_PER_BLOCK = 4 + 16
#: Wire cost of a signature's fixed fields (size + block_len ints).
SIG_HEADER_BYTES = 16


def pick_block_len(size: int) -> int:
    """rsync-style block size: ~sqrt(size), pow2-bounded [4 KiB, 128 KiB]."""
    if size <= 0:
        return MIN_BLOCK
    target = int(size ** 0.5)
    b = MIN_BLOCK
    while b < target and b < MAX_BLOCK:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class SigGeometry:
    """The block geometry the engine would pick for a file of ``size``
    bytes, plus the exact signature wire cost that geometry implies:
    the pricing seam of the protocol planner (engine/protoplan.py)."""

    block_len: int
    n_blocks: int      # includes the short tail block, matching to_wire
    sig_bytes: int


def signature_geometry(size: int,
                       block_len: Optional[int] = None) -> SigGeometry:
    """Geometry + signature wire size for a ``size``-byte destination
    file (``block_len`` overrides the heuristic, as build_file_signature
    allows)."""
    block_len = block_len or pick_block_len(size)
    n_blocks = 0 if size <= 0 else -(-size // block_len)
    return SigGeometry(block_len=block_len, n_blocks=n_blocks,
                       sig_bytes=SIG_HEADER_BYTES
                       + n_blocks * SIG_BYTES_PER_BLOCK)


@dataclasses.dataclass
class FileSignature:
    size: int
    block_len: int
    weak: np.ndarray          # [nb] uint32 (includes short tail block)
    strong: list[bytes]       # [nb] 16-byte MD5 digests

    def to_wire(self) -> dict:
        return {"size": self.size, "block_len": self.block_len,
                "weak": self.weak.tobytes(),
                "strong": b"".join(self.strong)}

    @classmethod
    def from_wire(cls, d: dict) -> "FileSignature":
        weak = np.frombuffer(d["weak"], dtype=np.uint32).copy()
        strong = [d["strong"][i : i + 16]
                  for i in range(0, len(d["strong"]), 16)]
        return cls(size=d["size"], block_len=d["block_len"], weak=weak,
                   strong=strong)


def build_file_signature(data: bytes, block_len: Optional[int] = None, *,
                         device=None) -> FileSignature:
    """Destination side: checksum every block (on ``device`` for the
    full blocks, on the host for the short tail)."""
    dev = resolve_device(device)
    block_len = block_len or pick_block_len(len(data))
    if len(data) == 0:
        return FileSignature(0, block_len, np.zeros((0,), np.uint32), [])
    n_full = len(data) // block_len
    if n_full == 0:
        weak = np.array([weak_checksum_host(data)], dtype=np.uint32)
        return FileSignature(len(data), block_len, weak,
                             [hashlib.md5(data).digest()])
    buf = _to_device(np.frombuffer(data, np.uint8), dev)
    weak_dev, strong_dev = build_signature(buf, block_len=block_len)
    weak = weak_dev.cpu().numpy().astype(np.uint32)  # tail at true length
    strong = state_bytes(strong_dev)
    tail = data[n_full * block_len :]
    if tail:
        strong.append(hashlib.md5(tail).digest())
    else:
        weak = weak[:n_full]
    return FileSignature(len(data), block_len, weak, strong)


# Delta ops: ("copy", first_block, n_blocks) | ("data", bytes)
Op = tuple


def compute_delta(src: bytes, sig: FileSignature, *,
                  device=None) -> list[Op]:
    """Source side: the delta scan. Returns ops that rebuild ``src`` from
    the destination's blocks + literal data."""
    dev = resolve_device(device)
    L = len(src)
    if L == 0:
        return []
    block_len = sig.block_len
    n_full_dst = sig.size // block_len
    # Only full blocks take part in the rolling scan; the destination
    # tail block (if any) can only match at the very end of src.
    full_weak = sig.weak[:n_full_dst]
    if len(full_weak) == 0 or L < block_len:
        return _with_tail_match(src, sig, [("data", src)])

    arr = np.frombuffer(src, np.uint8)
    buf = _to_device(arr, dev)
    sorted_weak = torch.from_numpy(
        np.sort(full_weak, kind="stable").astype(np.int64)).to(dev)
    cap = max(1024, _pow2ceil(L // block_len * 4))
    while True:
        cand_dev, count = match_offsets(buf, sorted_weak, window=block_len,
                                        max_candidates=cap)
        n = int(count)
        if n <= cap:
            cand = cand_dev[:n].cpu().numpy()
            break
        cap = _pow2ceil(n)
    if len(cand) == 0:
        return _with_tail_match(src, sig, [("data", src)])

    strongs = verify_candidates(buf, cand, block_len=block_len)
    return _select_ops(src, arr, sig, full_weak, cand, state_bytes(strongs))


def _select_ops(src: bytes, arr: np.ndarray, sig: FileSignature,
                full_weak: np.ndarray, cand, strong_bytes: list) -> list[Op]:
    """Host-side tail of the delta scan, shared verbatim by the serial
    and batched paths: map verified candidates to destination blocks,
    then greedy left-to-right op selection over the sparse matches."""
    L = len(src)
    block_len = sig.block_len
    # weak -> destination block ids (handle duplicate weak values)
    by_weak: dict[int, list[int]] = {}
    for orig_idx in range(len(full_weak)):
        by_weak.setdefault(int(full_weak[orig_idx]), []).append(orig_idx)
    # offset -> destination block index for verified matches
    verified: dict[int, int] = {}
    weak_at = _weak_at_offsets(arr, cand, block_len)
    for i, off in enumerate(cand):
        w = weak_at[i]
        if w not in by_weak:
            continue
        for dst_block in by_weak[w]:
            if sig.strong[dst_block] == strong_bytes[i]:
                verified[int(off)] = dst_block
                break

    # Greedy left-to-right selection over sparse verified offsets.
    ops: list[Op] = []
    lit_start = 0
    pos = 0
    offsets = sorted(verified)
    oi = 0
    while pos + block_len <= L:
        while oi < len(offsets) and offsets[oi] < pos:
            oi += 1
        if oi < len(offsets) and offsets[oi] == pos:
            if lit_start < pos:
                ops.append(("data", src[lit_start:pos]))
            blk = verified[pos]
            if ops and ops[-1][0] == "copy" and (
                    ops[-1][1] + ops[-1][2] == blk):
                ops[-1] = ("copy", ops[-1][1], ops[-1][2] + 1)
            else:
                ops.append(("copy", blk, 1))
            pos += block_len
            lit_start = pos
        else:
            # No verified match at pos: jump to the next verified offset
            # (the unmatched region is already covered by lit_start).
            if oi < len(offsets) and offsets[oi] > pos:
                pos = offsets[oi]
            else:
                break
    if lit_start < L:
        ops.append(("data", src[lit_start:]))
    return _with_tail_match(src, sig, ops)


def _with_tail_match(src: bytes, sig: FileSignature,
                     ops: list[Op]) -> list[Op]:
    """If src's final bytes equal the destination's short tail block,
    replace the trailing literal with a copy of the tail block."""
    n_full = sig.size // sig.block_len
    tail_len = sig.size - n_full * sig.block_len
    if tail_len == 0 or n_full >= len(sig.strong):
        return ops
    if not ops or ops[-1][0] != "data" or len(ops[-1][1]) < tail_len:
        return ops
    lit = ops[-1][1]
    if hashlib.md5(lit[-tail_len:]).digest() == sig.strong[n_full]:
        remainder = lit[:-tail_len]
        ops = ops[:-1]
        if remainder:
            ops.append(("data", remainder))
        ops.append(("copy", n_full, 1))
    return ops


def delta_scan_batch(items, *, device=None) -> list[list[Op]]:
    """Multi-file delta scan: the device stages of ``compute_delta``
    (rolling weak scan -> signature membership -> batched MD5 verify)
    run once per GROUP of files instead of once per file.

    ``items`` is a sequence of ``(src_bytes, FileSignature)`` pairs;
    returns one op stream per item, identical to ``compute_delta`` on
    each: the host-side greedy selection is the shared ``_select_ops``,
    and padding rows to a common bucketed length only adds scan offsets
    that the per-row valid-length mask discards.

    Files are grouped by block length and each group is padded to a
    bucket-rounded row length (engine/chunker._buffer_bucket). Empty
    files, sub-block files and signatures with no full block never reach
    the device, as in the serial engine."""
    dev = resolve_device(device)
    results: list = [None] * len(items)
    groups: dict[int, list[int]] = {}
    for i, (src, sig) in enumerate(items):
        if len(src) == 0:
            results[i] = []
            continue
        n_full_dst = sig.size // sig.block_len
        if n_full_dst == 0 or len(src) < sig.block_len:
            results[i] = _with_tail_match(src, sig, [("data", src)])
            continue
        groups.setdefault(sig.block_len, []).append(i)

    for block_len, idxs in groups.items():
        arrs = [np.frombuffer(items[i][0], np.uint8) for i in idxs]
        lens = [len(a) for a in arrs]
        L = _buffer_bucket(max(lens))
        n = len(idxs)
        data = np.zeros((n, L), np.uint8)
        for r, a in enumerate(arrs):
            data[r, : len(a)] = a
        full_weaks = [items[i][1].weak[: items[i][1].size // block_len]
                      for i in idxs]
        nb = np.array([len(w) for w in full_weaks], np.int64)
        nb_cap = _pow2ceil(int(nb.max()))
        sorted_weak = np.full((n, nb_cap), 0xFFFFFFFF, np.int64)
        for r, w in enumerate(full_weaks):
            sorted_weak[r, : len(w)] = np.sort(w, kind="stable")
        nscan = np.array([ln - block_len + 1 for ln in lens], np.int64)
        width = L - block_len + 1
        # One upload and one match ladder per block-length group.
        buf = _to_device(data, dev)
        sw_dev = torch.from_numpy(sorted_weak).to(dev)
        nb_dev = torch.from_numpy(nb).to(dev)
        ns_dev = torch.from_numpy(nscan).to(dev)
        cap = max(1024, _pow2ceil(sum(ln // block_len for ln in lens) * 4))
        while True:
            cand_dev, count = match_offsets_batch(
                buf, sw_dev, nb_dev, ns_dev, window=block_len,
                max_candidates=cap)
            total = int(count)
            if total <= cap:
                flat = cand_dev[:total].cpu().numpy()
                break
            cap = _pow2ceil(total)
        rows = flat // width
        offs = flat % width
        strong_all = state_bytes(verify_candidates_batch(
            buf, rows, offs, block_len=block_len))
        for r, i in enumerate(idxs):
            picks = np.nonzero(rows == r)[0]
            src, sig = items[i]
            if len(picks) == 0:
                results[i] = _with_tail_match(src, sig, [("data", src)])
                continue
            results[i] = _select_ops(
                src, arrs[r], sig, full_weaks[r], offs[picks],
                [strong_all[k] for k in picks])
    return results


def apply_delta(ops: list[Op], dest: bytes, block_len: int) -> bytes:
    """Destination side: rebuild the file from its own blocks + literals."""
    out = bytearray()
    for op in ops:
        if op[0] == "data":
            out += op[1]
        else:
            _, first, count = op
            start = first * block_len
            out += dest[start : start + count * block_len]
    return bytes(out)


def delta_stats(ops: list[Op], block_len: int) -> dict:
    copied = sum(op[2] * block_len for op in ops if op[0] == "copy")
    literal = sum(len(op[1]) for op in ops if op[0] == "data")
    return {"copied_bytes": copied, "literal_bytes": literal}


def _pow2ceil(n: int) -> int:
    v = 1
    while v < n:
        v *= 2
    return v


def _weak_at_offsets(arr: np.ndarray, offsets, block_len: int) -> np.ndarray:
    """Weak checksums at given offsets via numpy prefix sums (vectorized;
    the same arithmetic as ops/rolling.py, in uint32 wraparound)."""
    if len(offsets) == 0:
        return np.zeros((0,), np.uint32)
    x = arr.astype(np.uint32)
    j = np.arange(len(arr), dtype=np.uint32)
    with np.errstate(over="ignore"):
        S = np.concatenate([[0], np.cumsum(x, dtype=np.uint32)])
        T = np.concatenate([[0], np.cumsum(j * x, dtype=np.uint32)])
        off = np.asarray(offsets, dtype=np.int64)
        dS = S[off + block_len] - S[off]
        dT = T[off + block_len] - T[off]
        a = dS & np.uint32(0xFFFF)
        b = ((off.astype(np.uint32) + np.uint32(block_len)) * dS - dT) & np.uint32(0xFFFF)
    return (a | (b << np.uint32(16))).astype(np.uint32)
