"""Pack-level Reed-Solomon shard codec (storage-agnostic half).

Ports ``volsync_tpu/repo/erasure.py`` whole, shard format included: a
shard blob written by either package parses and decodes under the
other. ``encode_pack_shards``, ``reconstruct_pack`` and
``reconstruct_verified`` take ``device=`` (CUDA by default, raising
where CUDA is absent): the field math runs there through
``ops/rs.gf_matmul``, the pack id is checked on the host with
``hashlib``. The port times the encode (``ec.encode``) and the
verified reconstruction (``ec.reconstruct``) as spans.

A sealed pack body (the exact bytes whose SHA-256 is the pack id) is
split into k equal data shards plus m Cauchy parity shards via
ops/rs.py; each shard blob is a 16-byte self-describing header followed
by the shard payload, so reconstruction needs no side metadata beyond
the shard keys themselves (arxiv 2602.22237's lightweight-metadata DR
posture — recovery is never index-bound):

    b"VSEC" | version u8 | k u8 | m u8 | idx u8 | body_len u64be

Repository owns the key layout (``ec/<pack-id>/<shard-idx>``, see
``repository.ec_shard_key``) and all store I/O; this module is the pure
codec used by the seal path, the scrub/restore reconstruct heal arms,
and RepackService. ``reconstruct_verified`` re-derives the
content-addressed pack id and, when the cheapest k-subset decodes to a
mismatch (a silently corrupt shard), searches other k-subsets until one
proves out — a wrong shard can therefore never be silently served.
"""

from __future__ import annotations

import hashlib
import struct
from itertools import combinations
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from volsync_tpu_torch import resolve_device
from volsync_tpu_torch.obs import record_copy, span
from volsync_tpu_torch.ops import rs

EC_PREFIX = "ec/"
_MAGIC = b"VSEC"
_VERSION = 1
HEADER_LEN = 16
# Cap the k-subset search when corrupt shards poison the cheap decode:
# C(k+m, k) for the supported schemes is small (6+2 -> 28), but a cap
# keeps a pathological scheme from turning heal into a combinatorial
# stall.
_MAX_DECODE_ATTEMPTS = 128
# Schemes are deliberately narrow: k+m shards per pack, all fetched on
# reconstruct, so wide schemes would turn one heal into dozens of GETs.
_MAX_K = 16
_MAX_M = 8


class ECError(ValueError):
    """Shard set is malformed, inconsistent, or insufficient."""


def validate_scheme(k: int, m: int) -> None:
    if not (1 <= m <= _MAX_M and 2 <= k <= _MAX_K):
        raise ECError(f"unsupported EC scheme {k}+{m}")


def shard_count(k: int, m: int) -> int:
    return k + m


def storage_overhead(k: int, m: int) -> float:
    """Stored bytes per logical byte for a k+m stripe (mirrors are 2.0)."""
    return (k + m) / k


def shard_header(k: int, m: int, idx: int, body_len: int) -> bytes:
    validate_scheme(k, m)
    return _MAGIC + struct.pack(">BBBBQ", _VERSION, k, m, idx, body_len)


def parse_shard(blob) -> Tuple[int, int, int, int, memoryview]:
    """-> (k, m, idx, body_len, payload). Raises ECError on a blob that
    is not a VSEC shard (truncation, wrong magic, bad scheme)."""
    view = memoryview(blob)
    if len(view) < HEADER_LEN or view[:4] != _MAGIC:
        raise ECError("not a VSEC shard")
    version, k, m, idx = view[4], view[5], view[6], view[7]
    if version != _VERSION:
        raise ECError(f"unknown VSEC version {version}")
    validate_scheme(k, m)
    if idx >= k + m:
        raise ECError(f"shard index {idx} out of range for {k}+{m}")
    body_len = int.from_bytes(view[8:16], "big")
    return k, m, idx, body_len, view[HEADER_LEN:]


def shard_len_for(body_len: int, k: int) -> int:
    return max((body_len + k - 1) // k, 1)


def _pack_grid(parts: Sequence, k: int) -> Tuple[np.ndarray, int, int]:
    """Flatten an iovec part list into the [k, shard_len] data grid.
    One buffer-sized copy is inherent here — parity math needs the body
    as contiguous field lanes (the seal path otherwise stays vectored;
    this is the EC analogue of the device hash's packing copy)."""
    body_len = sum(len(p) for p in parts)
    slen = shard_len_for(body_len, k)
    buf = np.zeros(k * slen, dtype=np.uint8)
    record_copy("ec.encode", body_len)
    off = 0
    for p in parts:
        n = len(p)
        buf[off:off + n] = np.frombuffer(p, dtype=np.uint8)
        off += n
    return buf.reshape(k, slen), body_len, slen


def encode_pack_shards(parts: Sequence, k: int, m: int, *,
                       device=None) -> List[bytes]:
    """Sealed pack body (iovec parts) -> k+m shard blobs with headers.
    Shard idx 0..k-1 are the systematic body slices; k..k+m-1 parity,
    computed on ``device``."""
    dev = resolve_device(device)
    validate_scheme(k, m)
    with span("ec.encode"):
        grid, body_len, slen = _pack_grid(parts, k)
        pages, _ = rs.rs_pack_host(list(grid))
        parity = rs.rs_encode_device(
            torch.from_numpy(pages).to(dev), m).cpu().numpy()
        parity = parity.reshape(m, -1)[:, :slen]
        shards: List[bytes] = []
        for idx in range(k):
            record_copy("ec.encode", int(slen))
            shards.append(shard_header(k, m, idx, body_len)
                          + grid[idx].tobytes())
        for i in range(m):
            record_copy("ec.encode", int(slen))
            shards.append(shard_header(k, m, k + i, body_len)
                          + parity[i].tobytes())
    return shards


def _parse_set(blobs: Dict[int, bytes]) -> Tuple[int, int, int,
                                                 Dict[int, memoryview]]:
    """Parse + cross-check a shard set; drops blobs whose header
    disagrees with the majority scheme or whose payload is truncated."""
    parsed: Dict[int, memoryview] = {}
    schemes: Dict[Tuple[int, int, int], int] = {}
    fields: Dict[int, Tuple[int, int, int]] = {}
    for idx, blob in blobs.items():
        try:
            k, m, hidx, body_len, payload = parse_shard(blob)
        except ECError:
            continue
        if hidx != idx:
            continue
        schemes[(k, m, body_len)] = schemes.get((k, m, body_len), 0) + 1
        fields[idx] = (k, m, body_len)
        parsed[idx] = payload
    if not schemes:
        raise ECError("no parseable shards")
    (k, m, body_len), _ = max(schemes.items(), key=lambda kv: kv[1])
    slen = shard_len_for(body_len, k)
    healthy = {idx: pv for idx, pv in parsed.items()
               if fields[idx] == (k, m, body_len) and len(pv) == slen}
    return k, m, body_len, healthy


def stripe_scheme(blobs: Dict[int, bytes]) -> Optional[Tuple[int, int]]:
    """(k, m) of a shard set by majority header vote; None when no
    shard parses (callers then treat the stripe as absent)."""
    try:
        k, m, _body_len, _healthy = _parse_set(blobs)
    except ECError:
        return None
    return k, m


def reconstruct_pack(blobs: Dict[int, bytes],
                     use: Optional[Iterable[int]] = None, *,
                     device=None) -> bytes:
    """Decode the pack body from shard blobs (any k healthy ones).
    ``use`` restricts decoding to a specific k-subset of shard indices
    (the verified-search driver below). Raises ECError when fewer than
    k consistent shards survive."""
    dev = resolve_device(device)
    k, m, body_len, healthy = _parse_set(blobs)
    if use is not None:
        healthy = {i: healthy[i] for i in use if i in healthy}
    if len(healthy) < k:
        raise ECError(f"need {k} healthy shards, have {len(healthy)}")
    data = rs.rs_reconstruct_device(
        healthy, k, m, shard_len_for(body_len, k), device=dev)
    record_copy("ec.decode", body_len)
    return b"".join(data)[:body_len]


def reconstruct_verified(blobs: Dict[int, bytes], pack_id: str, *,
                         device=None) -> Optional[bytes]:
    """Reconstruct AND prove: re-derive the content-addressed pack id
    over each candidate decode and return the body only when it
    matches. Tries the cheapest subset first (survived data shards pass
    through identity rows), then other k-subsets in case a silently
    corrupt shard poisoned the decode. Returns None if no subset of the
    surviving shards proves out — the caller quarantines."""
    dev = resolve_device(device)
    with span("ec.reconstruct"):
        return _reconstruct_verified(blobs, pack_id, dev)


def _reconstruct_verified(blobs: Dict[int, bytes], pack_id: str,
                          dev) -> Optional[bytes]:
    try:
        k, _m, _body_len, healthy = _parse_set(blobs)
    except ECError:
        return None
    have = sorted(healthy)
    if len(have) < k:
        return None
    attempts = 0
    for use in combinations(have, k):
        if attempts >= _MAX_DECODE_ATTEMPTS:
            break
        attempts += 1
        try:
            body = reconstruct_pack(blobs, use=use, device=dev)
        except ECError:
            continue
        if hashlib.sha256(body).hexdigest() == pack_id:
            return body
    return None
