"""Fused segment pipeline on the card: chunk + hash + Merkle roots.

Ports ``volsync_tpu/ops/segment.py``. One call per segment runs every
stage on the device and returns ONE small packed result, fetched once:

1. aligned gear candidates and their compaction (torch; cumsum ranks
   and a scatter, so no host sync);
2. the FastCDC walk: the ``fastcdc_walk`` kernel (``csrc/fastcdc.cu``),
   one warp a lane deciding each chunk from the candidate lists;
3. SHA-256 of every 4 KiB page: K1 ``sha256_pages``
   (``csrc/sha256.cu``) over the raw segment bytes;
4. the one partial tail leaf of each lane: ``tail_leaves_into``, one
   ``sha256_slices`` launch (``csrc/sha256.cu``) that reads the chunk
   table, hashes the leaf from the segment bytes and writes its digest
   into the page-digest table;
5. the Merkle roots: the ``merkle_roots`` kernel (``csrc/merkle.cu``),
   one warp per chunk, builds the "VMRK1" || le64(len) || leaf digests
   message blocks from the page-digest table itself and chains them.

K3 ``transpose_u32`` (``csrc/transpose.cu``, the counterpart of the
reference's ``_pallas_transpose``) is no longer on this path; it stays
for the rsync MD5 path that reuses it.

With ``GearParams.align == 4096`` every interior cut lands on the page
grid, so every full leaf of every chunk IS a page of the segment and
only the final chunk's last leaf can be partial.

The packed result is ``[4 + chunk_cap*10]`` 32-bit words (int32
tensors carrying u32 bit patterns): header (count, consumed, true lax
candidate count, leaf count), starts[chunk_cap], lens[chunk_cap],
roots[chunk_cap*8]; bit-identical to the reference's. The host retries
with doubled capacities iff real data overflowed them.

The page-digest table is word-major (word j of page p at j*npp + p) by
default; under ``VOLSYNC_PAGEMAJOR=1`` K1 stores it page-major (p*8 +
j) itself, the work of the reference's ``_pallas_pagemajor``
(segment.py:267-292). The K4 ``pagemajor_u32`` kernel
(``csrc/transpose.cu``) that relaid K1's word-major output stays, tested
and timed, off every path. ``chunk_hash_segments``, ``page_digests``
and ``span_roots_device`` read the gate once per call and pass it down,
and ``_word_index_fn`` is the one index formula every producer, tail
override, root gather and host decode uses (``sha256_slices`` and
``merkle_roots`` carry its two forms in CUDA). The packed results do not
depend on the layout.

Every kernel wrapper here and in ``ops/sha256.py`` runs the kernel on a
CUDA tensor and its plain PyTorch twin on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from volsync_tpu_torch import envflags, resolve_device
from volsync_tpu_torch.obs import record_copy, span
from volsync_tpu_torch.ops._build import Kernel, check_cuda
from volsync_tpu_torch.ops.gearcdc import (
    GearParams,
    gear_at_aligned,
    nonzero_fixed,
)
from volsync_tpu_torch.ops.gearcdc import _pow2ceil_int as _pow2ceil
from volsync_tpu_torch.ops.sha256 import (
    _M,
    SHA256_TAIL_CHUNKS,
    SHA256_TAIL_SPANS,
    _i32,
    _sha256_chunks_plain,
    _sha256_lanes_plain,
    _u32,
    sha256_pages,
    slice_blocks,
)

LEAF_SIZE = 4096  # == repo.blobid.LEAF_SIZE

#: Largest flat [S*P] byte view one batched dispatch may address. Torch
#: indexes in int64, but the reference gathers with int32 indices and
#: splits bigger batches; the port keeps the split so that batch
#: compositions (and so results) match.
_MAX_FLAT_BYTES = (1 << 31) - 1
_DOMAIN_WORD0 = int.from_bytes(b"VMRK", "big")  # "VMRK1" header, word 0
_DOMAIN_BYTE4 = b"VMRK1"[4]
_SENTINEL = 2**31 - 2  # compacted-candidate padding, > any position

TRANSPOSE_U32 = Kernel("transpose_u32", "transpose.cu", "vt_transpose_u32",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int])
PAGEMAJOR_U32 = Kernel("pagemajor_u32", "transpose.cu", "vt_pagemajor_u32",
                       [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])
FASTCDC_WALK = Kernel("fastcdc_walk", "fastcdc.cu", "vt_fastcdc_walk",
                      [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                      + [ctypes.c_longlong] * 3)
MERKLE_ROOTS = Kernel("merkle_roots", "merkle.cu", "vt_merkle_roots",
                      [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
                      + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3)


def segment_caps(padded_len: int, params: GearParams) -> tuple[int, int]:
    """(cand_cap, chunk_cap) for a padded segment length (the
    reference's sizing: ~8-16x candidate headroom, chunk_cap covers the
    min_size packing bound plus the eof tail)."""
    chunk_cap = _pow2ceil(padded_len // params.min_size + 2, 16)
    cand_cap = max(4096, _pow2ceil(4 * padded_len // params.avg_size, 4096))
    return cand_cap, chunk_cap


def _compact_candidates(mask: torch.Tensor, cand_cap: int,
                        align: int) -> torch.Tensor:
    """[S, R] bool candidate mask -> [S, cand_cap] int64 sorted aligned
    cut positions, padded with ``_SENTINEL`` (the reference's
    nonzero(size=cand_cap) protocol)."""
    R = mask.shape[1]
    ridx = nonzero_fixed(mask, cand_cap, R)
    return torch.where(ridx < R, ridx * align + (align - 1), _SENTINEL)


def _word_index_fn(n_pages_pad: int, pagemajor: bool):
    """THE home of the digest-table index formula (word-major: word j of
    page p at j*n_pages_pad + p; page-major: at p*8 + j); producers, the
    tail override, the root gather and the host decode all route
    through it."""
    if pagemajor:
        return lambda j, p: p * 8 + j
    return lambda j, p: j * n_pages_pad + p


def _apply_tail_overrides(flat: torch.Tensor, n_pages_pad: int,
                          tail_pages: torch.Tensor, tail_digs: torch.Tensor,
                          has_tail: torch.Tensor,
                          pagemajor: bool) -> torch.Tensor:
    """Overwrite the page-digest table with per-lane partial tail-leaf
    digests. tail_pages/has_tail: [N]; tail_digs: [N, 8] int32. Lanes
    with has_tail False write one slot past the table, which is
    dropped."""
    wi = _word_index_fn(n_pages_pad, pagemajor)
    j8 = torch.arange(8, dtype=torch.int64, device=flat.device)[None, :]
    idx = torch.where(has_tail[:, None], wi(j8, tail_pages[:, None]),
                      8 * n_pages_pad)
    ext = torch.cat([flat, flat.new_zeros(1)])
    ext.scatter_(0, idx.reshape(-1), tail_digs.reshape(-1))
    return ext[:-1]


def _tail_lanes(starts: torch.Tensor, lens: torch.Tensor, count, *,
                lane_pages: int, L: int):
    """Each lane's partial tail leaf, as the reference derives it ->
    (slice starts, lengths (0 without a tail), pages, has_tail), [B]
    int64. With ``count`` ([S] chunk counts; starts/lens the [S, cap]
    chunk tables of ``chunk_hash_segments``): the last chunk's end, on
    lane s's pages ``s * lane_pages ...``. Without: page-aligned spans
    (starts/lens [N]; lens <= 0 marks a padding lane)."""
    dev = starts.device
    if count is not None:
        starts64, lens64 = starts.to(torch.int64), lens.to(torch.int64)
        count64 = count.to(torch.int64)
        last = (count64 - 1).clamp(min=0)[:, None]
        end = torch.where(count64 > 0, (starts64.gather(1, last)
                                        + lens64.gather(1, last))[:, 0], 0)
        has_tail = (count64 > 0) & (end % LEAF_SIZE != 0)
        base = torch.arange(starts.shape[0], dtype=torch.int64,
                            device=dev) * lane_pages
    else:
        lens64 = lens.to(torch.int64)
        lens_c = lens64.clamp(min=0)
        end = starts.to(torch.int64) + lens_c
        has_tail = (lens64 > 0) & (lens_c % LEAF_SIZE != 0)
        base = 0
    local = (end - 1).clamp(min=0) // LEAF_SIZE
    page = base + local
    tail_len = end - local * LEAF_SIZE
    return ((page * LEAF_SIZE).clamp(0, L - 1),
            torch.where(has_tail, tail_len, 0), page, has_tail)


def _tail_leaves_plain(flat: torch.Tensor, n_pages_pad: int,
                       data: torch.Tensor, starts: torch.Tensor,
                       lens: torch.Tensor, count=None, *, lane_pages: int = 0,
                       pagemajor: bool) -> torch.Tensor:
    """Twin of ``sha256_slices``' table forms: ``_tail_lanes``, the
    slices through ``_sha256_chunks_plain``, then
    ``_apply_tail_overrides`` -> a new table."""
    ts, tl, page, has_tail = _tail_lanes(starts, lens, count,
                                         lane_pages=lane_pages,
                                         L=data.shape[0])
    dig = _sha256_chunks_plain(data, ts, tl, max_len=LEAF_SIZE)
    return _apply_tail_overrides(flat, n_pages_pad, page, dig, has_tail,
                                 pagemajor)


def tail_leaves_into(flat: torch.Tensor, n_pages_pad: int,
                     data: torch.Tensor, starts: torch.Tensor,
                     lens: torch.Tensor, count=None, *, lane_pages: int = 0,
                     pagemajor: bool) -> torch.Tensor:
    """Replace each lane's partial tail-leaf page in the page-digest
    table ``flat`` ([8 * n_pages_pad] int32, ``_word_index_fn`` layout)
    with the digest of the leaf's bytes in ``data`` ([L] uint8) -> the
    table. Lanes as ``_tail_lanes`` takes them: the fused segment's
    chunk tables (int32 [S, cap] starts and lens, [S] count, and
    ``lane_pages`` pages a lane) or page-aligned spans (int64 [N] starts
    and lens). CUDA: one ``sha256_slices`` launch (its chunk-table or
    span entry point) that derives each lane's tail, hashes it from the
    raw bytes and writes its 8 words into ``flat`` in place (no gather,
    padding or scatter ops); ``data`` must start on a 16-byte boundary.
    CPU: its twin ``_tail_leaves_plain``, which returns a new table."""
    if flat.device.type == "cpu":
        return _tail_leaves_plain(flat, n_pages_pad, data, starts, lens,
                                  count, lane_pages=lane_pages,
                                  pagemajor=pagemajor)
    name = "sha256_slices"
    check_cuda(name, flat, torch.int32, 1)
    check_cuda(name, data, torch.uint8, 1)
    if count is None:
        check_cuda(name, starts, torch.int64, 1)
        check_cuda(name, lens, torch.int64, 1)
        ok = lens.shape == starts.shape
    else:
        check_cuda(name, starts, torch.int32, 2)
        check_cuda(name, lens, torch.int32, 2)
        check_cuda(name, count, torch.int32, 1)
        ok = lens.shape == starts.shape and count.shape[0] == starts.shape[0]
    L = data.shape[0]
    if not ok or flat.shape[0] != 8 * n_pages_pad or L == 0 \
            or data.data_ptr() % 16:
        raise ValueError("sha256_slices: need an [8 * npp] table, a "
                         "16-byte aligned non-empty buffer and lane "
                         "tensors of one shape")
    table = (flat.data_ptr(), n_pages_pad, int(pagemajor), starts.shape[0],
             slice_blocks(LEAF_SIZE))
    if count is None:
        SHA256_TAIL_SPANS.launch(flat.device, data.data_ptr(), L,
                                 starts.data_ptr(), lens.data_ptr(), *table)
    else:
        SHA256_TAIL_CHUNKS.launch(flat.device, data.data_ptr(), L,
                                  starts.data_ptr(), lens.data_ptr(),
                                  count.data_ptr(), starts.shape[-1],
                                  lane_pages, *table)
    return flat


# ---------------------------------------------------------------------------
# FastCDC walk: the fastcdc_walk kernel, successor tables in its twin
# ---------------------------------------------------------------------------

def _fastcdc_walk_plain(cut_tab, emit_tab, valid_len, *, chunk_cap: int,
                        shift: int):
    """The walk over successor tables (``_walk_tables``) as a host loop
    over each lane: (starts [S, chunk_cap], lens [S, chunk_cap], count
    [S], consumed [S]), int32."""
    S, n_rows = cut_tab.shape
    dev = cut_tab.device
    starts = torch.zeros((S, chunk_cap), dtype=torch.int32, device=dev)
    lens = torch.zeros((S, chunk_cap), dtype=torch.int32, device=dev)
    count = torch.zeros((S,), dtype=torch.int32, device=dev)
    consumed = torch.zeros((S,), dtype=torch.int32, device=dev)
    cuts, emits, L = cut_tab.tolist(), emit_tab.tolist(), valid_len.tolist()
    for s in range(S):
        pos = cnt = 0
        st, ln = [], []
        while pos < L[s] and cnt < chunk_cap:
            r = min(pos >> shift, n_rows - 1)
            if not emits[s][r]:
                break
            cut = cuts[s][r]
            st.append(pos)
            ln.append(cut - pos + 1)
            cnt += 1
            pos = cut + 1
        starts[s, :cnt] = torch.tensor(st, dtype=torch.int32)
        lens[s, :cnt] = torch.tensor(ln, dtype=torch.int32)
        count[s] = cnt
        consumed[s] = pos
    return starts, lens, count, consumed


def _walk_tables(pos_s, ns, pos_l, nl, valid_len, eof, *, min_size: int,
                 avg_size: int, max_size: int, align: int, n_rows: int):
    """(cut_tab, emit_tab) [S, n_rows] int32: the FastCDC decision for a
    chunk starting at every row, from two batched searchsorted calls
    (side="left", as the reference's ``cut_emit``)."""
    S = pos_s.shape[0]
    dev = pos_s.device
    pos = torch.arange(n_rows, dtype=torch.int64, device=dev)[None, :] \
        * align
    L = valid_len[:, None]
    lo = (pos + (min_size - 1)).expand(S, n_rows).contiguous()
    mid = pos + (avg_size - 1)
    hi = pos + (max_size - 1)
    cap_s, cap_l = pos_s.shape[1], pos_l.shape[1]
    i = torch.searchsorted(pos_s, lo, side="left")
    cs = pos_s.gather(1, i.clamp(0, cap_s - 1))
    lim_s = torch.minimum(torch.minimum(mid - 1, L - 1), hi)
    found_s = (i < ns[:, None]) & (cs <= lim_s)
    j = torch.searchsorted(pos_l, torch.maximum(lo, mid).contiguous(),
                           side="left")
    cl = pos_l.gather(1, j.clamp(0, cap_l - 1))
    found_l = (j < nl[:, None]) & (cl <= torch.minimum(hi, L - 1))
    hi_ok = hi <= L - 1
    cut = torch.where(found_s, cs,
                      torch.where(found_l, cl, torch.where(hi_ok, hi, L - 1)))
    emit = found_s | found_l | hi_ok | eof[:, None]
    return cut.to(torch.int32), emit.to(torch.int32)


def _fastcdc_walk_twin(pos_s, ns, pos_l, nl, valid_len, eof, *,
                       min_size: int, avg_size: int, max_size: int,
                       chunk_cap: int, align: int):
    """Twin of the ``fastcdc_walk`` kernel (same arguments and results):
    the successor tables over the rows that the lanes' lengths cover
    (``_walk_tables``), then the table walk (``_fastcdc_walk_plain``)."""
    n_rows = max(1, -(-int(valid_len.max()) // align)) if len(valid_len) \
        else 1
    cut_tab, emit_tab = _walk_tables(
        pos_s, ns, pos_l, nl, valid_len, eof, min_size=min_size,
        avg_size=avg_size, max_size=max_size, align=align, n_rows=n_rows)
    return _fastcdc_walk_plain(cut_tab, emit_tab, valid_len.to(torch.int32),
                               chunk_cap=chunk_cap,
                               shift=int(align).bit_length() - 1)


def fastcdc_walk(pos_s: torch.Tensor, ns: torch.Tensor, pos_l: torch.Tensor,
                 nl: torch.Tensor, valid_len: torch.Tensor, eof: torch.Tensor,
                 *, min_size: int, avg_size: int, max_size: int,
                 chunk_cap: int, align: int):
    """The FastCDC walk of S segment lanes over their candidate lists.

    pos_s/pos_l: [S, cap] int64 sorted candidate cut positions, padded
    with ``_SENTINEL``; ns/nl: [S] int64 counts (at most cap);
    valid_len: [S] int64; eof: [S] bool. Every candidate is align - 1
    modulo ``align`` (a power of two dividing the three sizes). Returns
    (starts [S, chunk_cap], lens [S, chunk_cap], count [S], consumed
    [S]), int32, zero past count. CUDA: the ``fastcdc_walk`` kernel, one
    warp a lane deciding each chunk from the lists (it needs no
    ``align``); CPU: its twin ``_fastcdc_walk_twin``."""
    if pos_s.device.type == "cpu":
        return _fastcdc_walk_twin(pos_s, ns, pos_l, nl, valid_len, eof,
                                  min_size=min_size, avg_size=avg_size,
                                  max_size=max_size, chunk_cap=chunk_cap,
                                  align=align)
    for x, dtype, ndim in ((pos_s, torch.int64, 2), (pos_l, torch.int64, 2),
                           (ns, torch.int64, 1), (nl, torch.int64, 1),
                           (valid_len, torch.int64, 1), (eof, torch.bool, 1)):
        check_cuda("fastcdc_walk", x, dtype, ndim)
    S = pos_s.shape[0]
    if any(x.shape[0] != S for x in (pos_l, ns, nl, valid_len, eof)):
        raise ValueError("fastcdc_walk: the lanes' tensors disagree on S")
    dev = pos_s.device
    n = S * chunk_cap
    # One allocation for the four outputs (the kernel writes every word).
    starts, lens, count, consumed = torch.empty(
        (2 * n + 2 * S,), dtype=torch.int32, device=dev).split(
            [n, n, S, S])
    starts, lens = starts.view(S, chunk_cap), lens.view(S, chunk_cap)
    FASTCDC_WALK.launch(dev, pos_s.data_ptr(), ns.data_ptr(),
                        pos_l.data_ptr(), nl.data_ptr(), valid_len.data_ptr(),
                        eof.data_ptr(), starts.data_ptr(), lens.data_ptr(),
                        count.data_ptr(), consumed.data_ptr(), S,
                        pos_s.shape[1], pos_l.shape[1], chunk_cap, min_size,
                        avg_size, max_size)
    return starts, lens, count, consumed


def _select_boundaries_device(pos_s, ns, pos_l, nl, valid_len, eof, *,
                              min_size: int, avg_size: int, max_size: int,
                              chunk_cap: int, align: int, n_rows: int):
    """FastCDC walk == gearcdc.select_boundaries for S lanes, with the
    reference's arguments. pos_s/pos_l: [S, cap] sorted sentinel-padded
    candidate positions; ns/nl/valid_len: [S] int64; eof: [S] bool;
    ``n_rows`` the buffer's rows, which the reference's table form
    needs and the walk does not. Returns (starts, lens, count, consumed)
    as ``fastcdc_walk``."""
    if not (align & (align - 1) == 0 and min_size % align == 0
            and avg_size % align == 0 and max_size % align == 0):
        raise ValueError("the table walk needs page-multiple sizes")
    return fastcdc_walk(pos_s, ns, pos_l, nl, valid_len, eof,
                        min_size=min_size, avg_size=avg_size,
                        max_size=max_size, chunk_cap=chunk_cap, align=align)


# ---------------------------------------------------------------------------
# Page-digest stage: K1 page hashing of the raw bytes, either layout
# ---------------------------------------------------------------------------

def _transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """Twin of K3."""
    return x.t().contiguous()


def transpose_u32(x: torch.Tensor) -> torch.Tensor:
    """[R, C] 32-bit words -> [C, R]. CUDA: the K3 kernel; CPU: its
    twin."""
    if x.device.type == "cpu":
        return _transpose_plain(x)
    check_cuda("transpose_u32", x, torch.int32, 2)
    R, C = x.shape
    out = torch.empty((C, R), dtype=torch.int32, device=x.device)
    TRANSPOSE_U32.launch(x.device, x.data_ptr(), out.data_ptr(), R, C)
    return out


def _pagemajor_plain(x: torch.Tensor) -> torch.Tensor:
    """Twin of K4 (K1's page-major store computes the same relayout)."""
    return x.t().contiguous().view(-1)


def pagemajor_u32(x: torch.Tensor) -> torch.Tensor:
    """Word-major digest table [8, npp] -> page-major [npp * 8] (word j
    of page p at p*8 + j). CUDA: the K4 kernel; CPU: its twin. No path
    launches it: K1 stores page-major itself."""
    if x.device.type == "cpu":
        return _pagemajor_plain(x)
    check_cuda("pagemajor_u32", x, torch.int32, 2)
    if x.shape[0] != 8:
        raise ValueError("pagemajor_u32: expected an [8, npp] table")
    npp = x.shape[1]
    out = torch.empty((npp * 8,), dtype=torch.int32, device=x.device)
    PAGEMAJOR_U32.launch(x.device, x.data_ptr(), out.data_ptr(), npp)
    return out


def _page_digests_flat(data: torch.Tensor, n_pages_pad: int,
                       pagemajor: bool = False) -> torch.Tensor:
    """SHA-256 of every 4 KiB page of ``data`` ([P] uint8, P % 4096 ==
    0) -> [8 * n_pages_pad] int32, word-major (word j of page p at
    j * n_pages_pad + p), or page-major (p*8 + j) when ``pagemajor``:
    one K1 launch either way, which reads the raw bytes (no staged copy
    of the segment) and stores the layout asked for. Pad pages hash
    zeros and are never read."""
    return sha256_pages(data, n_pages_pad, pagemajor=pagemajor)


# ---------------------------------------------------------------------------
# Root stage: the merkle_roots kernel over the page-digest table
# ---------------------------------------------------------------------------

def _root_blocks_bound(max_len: int) -> int:
    """Message blocks of the longest possible root message for blobs of
    at most ``max_len`` bytes (1,025 at the 8 MiB default max_size)."""
    leaves = max((max_len + LEAF_SIZE - 1) // LEAF_SIZE, 1)
    return (32 * leaves + 13 + 9 + 63) // 64


def _root_digests_plain(flat: torch.Tensor, n_pages_pad: int,
                        page0: torch.Tensor, nleaves: torch.Tensor,
                        lens: torch.Tensor, live: torch.Tensor, *,
                        nb_max: int, pagemajor: bool) -> torch.Tensor:
    """Twin of ``merkle_roots``: the message blocks assembled with torch
    gathers up to the static bound ``nb_max``, then
    ``_sha256_lanes_plain`` (no kernel, on any device)."""
    return _sha256_lanes_plain(*_root_message_blocks(
        flat, n_pages_pad, page0, nleaves, lens, live, nb_max=nb_max,
        pagemajor=pagemajor))


def _root_message_blocks(flat: torch.Tensor, n_pages_pad: int,
                         page0: torch.Tensor, nleaves: torch.Tensor,
                         lens: torch.Tensor, live: torch.Tensor, *,
                         nb_max: int, pagemajor: bool):
    """The root messages as ``sha256_blocks`` takes them: ([C, nb_max,
    16] int32 blocks, [C] int32 block counts).

    The digest stream of lane c is D(t) = flat[word_index(t%8, page0[c]
    + t//8)]. The 13-byte header shifts it to byte offset 13, so message
    word q >= 4 is (D(q-4) << 24) | (D(q-3) >> 8) (for q < 4 the formula
    reads masked zeros); words 0..2 are header constants, and the FIPS
    terminator and bit length overlay computed word indices. As in the
    reference, dead lanes hash the empty leaf list and every lane is
    left at H0 when no lane is live."""
    C = page0.shape[0]
    dev = flat.device
    nl8 = 8 * nleaves
    nb = (32 * nleaves + 13 + 9 + 63) // 64
    nblocks = nb * live.any()  # the reference loop runs to max live nb
    qterm = 3 + nl8  # word holding the 0x80 terminator (byte 1)
    qlen = nb * 16 - 1  # word holding the bit length
    bitlen = ((13 + 32 * nleaves) * 8) & _M
    w1 = ((_DOMAIN_BYTE4 << 24) | ((lens & 0xFF) << 16)
          | (((lens >> 8) & 0xFF) << 8) | ((lens >> 16) & 0xFF))
    w2 = ((lens >> 24) & 0xFF) << 24

    wi = _word_index_fn(n_pages_pad, pagemajor)
    t = torch.arange(-4, 16 * nb_max - 3, dtype=torch.int64,
                     device=dev)[None, :]  # D index of word q=t+4
    tc = t.clamp(0, n_pages_pad * 8 - 1)
    idx = wi(tc % 8, page0[:, None] + tc // 8).clamp(0, flat.shape[0] - 1)
    d = torch.where((t >= 0) & (t < nl8[:, None]), _u32(flat)[idx], 0)
    blk = ((d[:, :-1] << 24) & _M) | (d[:, 1:] >> 8)  # [C, 16*nb_max]
    q = torch.arange(16 * nb_max, dtype=torch.int64, device=dev)[None, :]
    blk = torch.where(q == 0, _DOMAIN_WORD0, blk)
    blk = torch.where(q == 1, w1[:, None], blk)
    blk = torch.where(q == 2, w2[:, None], blk)
    blk = torch.where(q == qterm[:, None], blk | 0x00800000, blk)
    blk = torch.where(q == qlen[:, None], bitlen[:, None], blk)
    return _i32(blk).view(C, nb_max, 16), nblocks.to(torch.int32)


def _root_digests_loop(flat: torch.Tensor, n_pages_pad: int,
                       page0: torch.Tensor, nleaves: torch.Tensor,
                       lens: torch.Tensor, live: torch.Tensor, *,
                       nb_max: int, pagemajor: bool) -> torch.Tensor:
    """Blob ids (repo/blobid.py) from a page-digest table (word-major,
    or page-major when ``pagemajor``) -> [C, 8] int32.
    page0/nleaves/lens: [C] int64 chunk table, live: [C] bool; ``nb_max``
    a static bound on any lane's block count. Every lane's pages lie in
    the table. CUDA: one ``merkle_roots`` launch, which reads the table
    directly (csrc/merkle.cu); CPU: its twin ``_root_digests_plain``."""
    if flat.device.type == "cpu":
        return _root_digests_plain(flat, n_pages_pad, page0, nleaves, lens,
                                   live, nb_max=nb_max, pagemajor=pagemajor)
    check_cuda("merkle_roots", flat, torch.int32, 1)
    for x in (page0, nleaves, lens):
        check_cuda("merkle_roots", x, torch.int64, 1)
    check_cuda("merkle_roots", live, torch.bool, 1)
    C = page0.shape[0]
    if not (nleaves.shape[0] == lens.shape[0] == live.shape[0] == C) \
            or flat.shape[0] != 8 * n_pages_pad or flat.data_ptr() % 16:
        raise ValueError("merkle_roots: need a 16-byte aligned [8 * npp] "
                         "table and [C] chunk-table tensors")
    out = torch.empty((C, 8), dtype=torch.int32, device=flat.device)
    MERKLE_ROOTS.launch(flat.device, flat.data_ptr(), flat.shape[0],
                        n_pages_pad, page0.data_ptr(), nleaves.data_ptr(),
                        lens.data_ptr(), live.data_ptr(), out.data_ptr(), C,
                        nb_max, int(pagemajor))
    return out


# ---------------------------------------------------------------------------
# The segment programs
# ---------------------------------------------------------------------------

def chunk_hash_segments(data: torch.Tensor, valid_len, eof, *,
                        min_size: int, avg_size: int, max_size: int,
                        seed: int, mask_s: int, mask_l: int, align: int,
                        cand_cap: int, chunk_cap: int) -> torch.Tensor:
    """MANY independent segments in one pass (ports
    ``_chunk_hash_segments_impl`` / ``chunk_hash_segments``).

    data: [S, P] uint8 (zero-padded rows, P % 4096 == 0); valid_len: [S]
    ints; eof: [S] bools; padding lanes use valid_len == 0. Returns
    [S, 4 + chunk_cap*10] int32 packed rows, each decodable with
    ``decode_segment``. Page hashing runs as one K1 batch over all S*P/4096
    pages and the roots as one S*chunk_cap-lane ``merkle_roots``
    launch. ``VOLSYNC_PAGEMAJOR`` is read once here and picks the digest
    table's layout for every stage of the call."""
    if align != LEAF_SIZE:
        raise ValueError("the fused path requires page-aligned cuts")
    pagemajor = envflags.pagemajor()
    S, P = data.shape
    if S * P > _MAX_FLAT_BYTES:
        raise ValueError(f"batched dispatch of {S}x{P} bytes exceeds the "
                         f"2 GiB batch bound; split the batch")
    dev = data.device
    R = P // align
    F = P // LEAF_SIZE
    npp = S * F
    valid_len = torch.as_tensor(valid_len, dtype=torch.int64, device=dev)
    eof = torch.as_tensor(eof, dtype=torch.bool, device=dev)
    flat = data.reshape(S * P)
    i64 = dict(dtype=torch.int64, device=dev)

    # gear is page-local, so the flat evaluation equals the per-segment one
    h = gear_at_aligned(flat, seed, align).view(S, R)
    pos_all = torch.arange(R, **i64) * align + (align - 1)
    ok = pos_all[None, :] < valid_len[:, None]
    is_s = ((h & mask_s) == 0) & ok
    is_l = ((h & mask_l) == 0) & ok
    pos_s = _compact_candidates(is_s, cand_cap, align)
    pos_l = _compact_candidates(is_l, cand_cap, align)
    ns = is_s.sum(dim=1)
    nl = is_l.sum(dim=1)

    starts, lens, count, consumed = _select_boundaries_device(
        pos_s, ns.clamp(max=cand_cap), pos_l, nl.clamp(max=cand_cap),
        valid_len, eof, min_size=min_size, avg_size=avg_size,
        max_size=max_size, chunk_cap=chunk_cap, align=align, n_rows=R)

    digests = _page_digests_flat(flat, npp, pagemajor)
    # The ONE possibly-partial leaf per lane, the final chunk's tail,
    # replaces its page's digest.
    digests = tail_leaves_into(digests, npp, flat, starts, lens, count,
                               lane_pages=F, pagemajor=pagemajor)

    starts64, lens64 = starts.to(torch.int64), lens.to(torch.int64)
    count64 = count.to(torch.int64)
    live = torch.arange(chunk_cap, **i64)[None, :] < count64[:, None]
    nleaves = torch.where(live, (lens64 + (LEAF_SIZE - 1)) // LEAF_SIZE,
                          0)
    page0 = starts64 // LEAF_SIZE + (torch.arange(S, **i64) * F)[:, None]
    roots = _root_digests_loop(
        digests, npp, page0.reshape(-1), nleaves.reshape(-1),
        lens64.reshape(-1), live.reshape(-1),
        nb_max=_root_blocks_bound(max_size), pagemajor=pagemajor)

    header = torch.stack([count64, consumed.to(torch.int64), nl,
                          nleaves.sum(dim=1)], dim=1)
    return torch.cat([_i32(header & _M), starts, lens,
                      roots.view(S, chunk_cap * 8)], dim=1)


def chunk_hash_segment(data: torch.Tensor, valid_len: int, *, min_size: int,
                       avg_size: int, max_size: int, seed: int, mask_s: int,
                       mask_l: int, align: int, eof: bool, cand_cap: int,
                       chunk_cap: int) -> torch.Tensor:
    """The whole segment on the device, one small result.

    data: [P] uint8, P % 4096 == 0 (zero-padded; candidates at or beyond
    ``valid_len`` are masked). Returns [4 + chunk_cap*10] int32, decoded
    by ``decode_segment``. Equal to ``chunk_hash_segments`` with one
    lane, exactly as the reference's single and batched programs agree.
    """
    return chunk_hash_segments(
        data[None, :], [valid_len], [eof], min_size=min_size,
        avg_size=avg_size, max_size=max_size, seed=seed, mask_s=mask_s,
        mask_l=mask_l, align=align, cand_cap=cand_cap,
        chunk_cap=chunk_cap)[0]


def page_digests(dev: torch.Tensor) -> np.ndarray:
    """SHA-256 of every full 4 KiB page of a resident buffer -> [P/4096,
    8] uint32 ndarray (one pass, one fetch of 32 bytes per page). The
    layout gate is read once, so the table and its decode agree."""
    F = dev.shape[0] // LEAF_SIZE
    pm = envflags.pagemajor()
    flat = _page_digests_flat(dev, F, pm).cpu().numpy().view(np.uint32)  # lint: ignore[VL501] bounded batched digest staging
    j, p = np.meshgrid(np.arange(8), np.arange(F), indexing="xy")
    return flat[_word_index_fn(F, pm)(j, p)]  # [F, 8]


def span_roots_device(data: torch.Tensor, starts: torch.Tensor,
                      lens: torch.Tensor, *,
                      max_len: int | None = None) -> torch.Tensor:
    """Blob ids for page-aligned spans of a resident buffer -> [N, 8]
    int32 (garbage on padding lanes, lens < 0).

    data: [P] uint8, P % 4096 == 0; every start % 4096 == 0 and the
    spans page-DISJOINT (the tail override mutates the shared page-digest
    table; engine/chunker._spans_page_disjoint is the gate). ``max_len``
    bounds the span lengths (the root message bound); when omitted it is
    read from ``lens`` (one host sync)."""
    pagemajor = envflags.pagemajor()
    dev = data.device
    P = data.shape[0]
    npp = P // LEAF_SIZE
    starts = starts.to(device=dev, dtype=torch.int64)
    lens = lens.to(device=dev, dtype=torch.int64)
    live = lens > 0
    lens_c = lens.clamp(min=0)
    if max_len is None:
        max_len = int(lens_c.max()) if lens_c.numel() else 0  # lint: ignore[VL501] one host sync for the root bound when the caller passes no max_len (the docstring's contract)

    flat = _page_digests_flat(data, npp, pagemajor)
    flat = tail_leaves_into(flat, npp, data, starts, lens,
                            pagemajor=pagemajor)
    nleaves = torch.where(
        live, ((lens_c + LEAF_SIZE - 1) // LEAF_SIZE).clamp(min=1), 0)
    return _root_digests_loop(flat, npp, starts // LEAF_SIZE, nleaves,
                              lens_c, live,
                              nb_max=_root_blocks_bound(max_len),
                              pagemajor=pagemajor)


def decode_segment(packed, chunk_cap: int
                   ) -> tuple[list[tuple[int, int, str]], int, int, int]:
    """packed 32-bit words (tensor or ndarray) -> ([(start, len,
    root-hex)], consumed, true_candidates, total_leaves)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.ascontiguousarray(packed)
    if packed.dtype == np.int32:
        packed = packed.view(np.uint32)
    count = int(packed[0])
    consumed = int(packed[1])
    n_cand = int(packed[2])
    n_leaves = int(packed[3])
    starts = packed[4: 4 + chunk_cap].astype(np.int64)
    lens = packed[4 + chunk_cap: 4 + 2 * chunk_cap].astype(np.int64)
    roots = packed[4 + 2 * chunk_cap:].reshape(chunk_cap, 8).astype(">u4")
    out = [(int(starts[c]), int(lens[c]), roots[c].tobytes().hex())  # lint: ignore[VL106] 32 B digests
           for c in range(count)]
    return out, consumed, n_cand, n_leaves


def decode_with_overflow_check(packed, length: int, cand_cap: int,
                               chunk_cap: int):
    """Decode one packed result and apply the capacity-retry protocol:
    (chunks, consumed, grown) with ``grown`` None when the result is
    trustworthy, else the (cand_cap, chunk_cap) to re-dispatch with."""
    chunks, consumed, n_cand, _ = decode_segment(packed, chunk_cap)
    grown_cand, grown_chunk = cand_cap, chunk_cap
    retry = False
    if n_cand > cand_cap:
        grown_cand = _pow2ceil(n_cand, cand_cap * 2)
        retry = True
    if len(chunks) >= chunk_cap and consumed < length:
        grown_chunk = chunk_cap * 2
        retry = True
    return chunks, consumed, (grown_cand, grown_chunk) if retry else None


class FusedSegmentHasher:
    """Host side of ``chunk_hash_segment``: capacity bucketing and
    the overflow retry. Stateless apart from the params; safe to share
    across threads."""

    def __init__(self, params: GearParams):
        if params.align != LEAF_SIZE:
            raise ValueError("the fused path requires the page-aligned cut "
                             "format (align=4096)")
        self.params = params

    def dispatch(self, dev: torch.Tensor, length: int, *, eof: bool,
                 cand_cap: int | None = None, chunk_cap: int | None = None):
        """Launch the segment's device work; returns the in-flight
        (packed tensor, (cand_cap, chunk_cap))."""
        p = self.params
        cc, kc = segment_caps(int(dev.shape[0]), p)
        cand_cap = cand_cap or cc
        chunk_cap = chunk_cap or kc
        return chunk_hash_segment(
            dev, length, min_size=p.min_size, avg_size=p.avg_size,
            max_size=p.max_size, seed=p.seed, mask_s=p.mask_s,
            mask_l=p.mask_l, align=p.align, eof=eof, cand_cap=cand_cap,
            chunk_cap=chunk_cap), \
            (cand_cap, chunk_cap)

    def finish(self, dev: torch.Tensor, length: int, inflight, *, eof: bool):
        """Fetch + decode; re-dispatch with doubled capacities iff the
        true counts overflowed the tables (adversarial data)."""
        handle, (cand_cap, chunk_cap) = inflight
        while True:
            chunks, consumed, grown = decode_with_overflow_check(
                handle.cpu(), length, cand_cap, chunk_cap)
            if grown is None:
                return chunks, consumed
            handle, (cand_cap, chunk_cap) = self.dispatch(
                dev, length, eof=eof, cand_cap=grown[0], chunk_cap=grown[1])


class BatchedSegmentHasher:
    """Host side of ``chunk_hash_segments``: many independent
    streams' segments in one pass and one fetch.

    ``hash_segments(items)`` takes ``[(bytes-like, valid_len, eof)]``,
    groups lanes by buffer bucket, and returns ``[(chunks, consumed)]``
    per lane. Lanes whose true counts overflow the capacities retry
    alone through the single-segment path."""

    def __init__(self, params: GearParams, device=None):
        if params.align != LEAF_SIZE:
            raise ValueError("the batched path requires the page-aligned "
                             "cut format (align=4096)")
        self.params = params
        self.device = resolve_device(device)
        self._single = FusedSegmentHasher(params)

    def hash_segments(self, items) -> list:
        from volsync_tpu_torch.engine.chunker import _buffer_bucket

        if not items:
            return []
        groups: dict[int, list[int]] = {}
        for i, (buf, _, _) in enumerate(items):
            groups.setdefault(_buffer_bucket(max(len(buf), 1)),
                              []).append(i)
        out: list = [None] * len(items)
        for P, idxs in groups.items():
            for i, res in zip(idxs,
                              self._hash_bucket(P,
                                                [items[i] for i in idxs])):
                out[i] = res
        return out

    def _hash_bucket(self, P: int, items) -> list:
        """One pass for same-bucket lanes (lane count padded to a pow2;
        padding lanes carry valid_len == 0). Batches whose padded shape
        would cross ``_MAX_FLAT_BYTES`` split."""
        max_lanes = max(1, _MAX_FLAT_BYTES // P)
        if _pow2ceil(len(items), 1) > max_lanes:
            half = max(1, len(items) // 2)
            return (self._hash_bucket(P, items[:half])
                    + self._hash_bucket(P, items[half:]))

        p = self.params
        cand_cap, chunk_cap = segment_caps(P, p)
        S = _pow2ceil(len(items), 1)
        with span("ops.batch_stage"):
            rows = np.zeros((S, P), dtype=np.uint8)
            lens = np.zeros((S,), dtype=np.int64)
            eofs = np.zeros((S,), dtype=bool)
            staged = 0
            for i, (buf, n, eof) in enumerate(items):
                arr = np.frombuffer(buf, dtype=np.uint8, count=len(buf))
                rows[i, : arr.shape[0]] = arr
                staged += arr.shape[0]
                lens[i] = n
                eofs[i] = eof
            record_copy("device.stage", staged)
        # the lane table rides with the rows: no upload hides in the pass
        with span("device.h2d"):
            dev_rows = torch.from_numpy(rows).to(self.device)
            dev_lens = torch.from_numpy(lens).to(self.device)
            dev_eofs = torch.from_numpy(eofs).to(self.device)
        packed = chunk_hash_segments(
            dev_rows, dev_lens, dev_eofs, min_size=p.min_size,
            avg_size=p.avg_size, max_size=p.max_size, seed=p.seed,
            mask_s=p.mask_s, mask_l=p.mask_l, align=p.align,
            cand_cap=cand_cap, chunk_cap=chunk_cap).cpu().numpy()
        out = []
        for i in range(len(items)):
            chunks, consumed, grown = decode_with_overflow_check(
                packed[i], int(lens[i]), cand_cap, chunk_cap)
            if grown is not None:
                # adversarial lane: retry alone with doubled capacities
                dev = dev_rows[i]
                inflight = self._single.dispatch(
                    dev, int(lens[i]), eof=bool(eofs[i]),
                    cand_cap=grown[0], chunk_cap=grown[1])
                chunks, consumed = self._single.finish(
                    dev, int(lens[i]), inflight, eof=bool(eofs[i]))
            out.append((chunks, consumed))
        return out
