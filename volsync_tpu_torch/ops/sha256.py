"""Batched SHA-256 on the card: message lanes, 4 KiB pages, 4 KiB
leaves at 64-byte-aligned offsets and slices at any byte offset.

Ports ``volsync_tpu/ops/sha256.py``. Four kernels written for Hopper
(``csrc/sha256.cu``) carry the device work:

- ``sha256_blocks`` launches ``sha256_lanes`` (replaces the XLA scan
  ``sha256_blocks``, sha256.py:144-169): lane b runs ``nblocks[b]``
  compressions over pre-padded big-endian blocks (``sha256_many``; no
  engine launches it);
- ``sha256_pages`` launches K1 (replaces the Pallas
  ``_sha256_leaf_kernel``, sha256.py:367-395): SHA-256 of every page of
  a buffer, read as raw bytes through a shared-memory ``cp.async``
  ring, word-major output, or page-major (``pagemajor=True``, the work
  of K4 folded into K1's store). Its ``threads`` argument is the launch
  configuration that ``chip_smoke.py`` sweeps in place of the lane-tile
  sweep of ``scripts/tune_sha.py`` (K5);
- ``sha256_rows`` launches K2 (replaces ``_sha256_rows_pallas``,
  sha256.py:398-422): SHA-256 of full leaves read from the raw segment
  bytes at ``64*rows0[b]`` through K1's ``cp.async`` ring;
  ``sha256_leaves_device`` (ref :260-286) pairs it with
  ``sha256_chunks_device`` for the short tail leaves, the split-phase
  engine's one leaf dispatch;
- ``sha256_chunks_device`` launches ``sha256_slices`` (replaces the
  gather, padding and scan of ref :438-492): slices at any byte offset
  hashed from the raw bytes, the FIPS padding built in the kernel.
  ``ops/segment.py tail_leaves_into`` launches its table-writing form.

On a CPU tensor each runs its plain PyTorch twin (``_sha256_lanes_plain``,
``_sha256_pages_plain``, ``_sha256_rows`` over ``pack_words``,
``_sha256_chunks_plain``); on a CUDA tensor the kernel, always.

Word convention: 32-bit message and digest words travel as int32
tensors holding the u32 bit pattern (``_i32``/``_u32`` convert). The
plain twins compute in int64 holding values in ``[0, 2**32)`` and mask
with ``_M`` (torch on the CPU has no uint32 ``+``/``<<``/``>>``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from volsync_tpu_torch import resolve_device
from volsync_tpu_torch.ops._build import Kernel, check_cuda

_M = 0xFFFFFFFF

# First 32 bits of the fractional parts of the cube roots of the first 64
# primes (FIPS 180-4 section 4.2.2); csrc/sha256.cuh holds the same table.
_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
        0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
        0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
        0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
        0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
        0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
        0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
        0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
        0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
        0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
        0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

# Initial hash state (square roots of the first 8 primes).
_H0 = np.array(
    [
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    ],
    dtype=np.uint32,
)

_K_INT = [int(k) for k in _K]

SHA256_PAGES = Kernel("sha256_pages", "sha256.cu", "vt_sha256_pages",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int])
SHA256_LANES = Kernel("sha256_lanes", "sha256.cu", "vt_sha256_lanes",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int])
SHA256_ROWS = Kernel("sha256_rows", "sha256.cu", "vt_sha256_rows",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int])
# sha256_slices' three entry points, one per kind of lanes; their launches
# count under the one kernel name.
SHA256_SLICES = Kernel("sha256_slices", "sha256.cu", "vt_sha256_slices",
                       [ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)
SHA256_TAIL_CHUNKS = Kernel("sha256_slices", "sha256.cu",
                            "vt_sha256_tail_chunks",
                            [ctypes.c_void_p, ctypes.c_longlong]
                            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                            + [ctypes.c_void_p] + [ctypes.c_int] * 4)
SHA256_TAIL_SPANS = Kernel("sha256_slices", "sha256.cu",
                           "vt_sha256_tail_spans",
                           [ctypes.c_void_p, ctypes.c_longlong]
                           + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4)

#: K1's threads per block as the library launches it.
PAGES_THREADS = 64
#: K2's threads per block (its ring is K1's; 64 x 80 bytes a stage).
ROWS_THREADS = 64
#: sha256_slices' threads per block (fixed in csrc/sha256.cu).
SLICES_THREADS = 64
#: sha256_lanes' threads per block (fixed in csrc/sha256.cu).
LANES_THREADS = 32


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return x.to(torch.int64) & _M


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bit pattern."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def _big_sigma(x: torch.Tensor, r1: int, r2: int, r3: int) -> torch.Tensor:
    """rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3) on int64 u32 values: x
    is doubled into 64 bits once, so each rotation is one shift."""
    xx = x | (x << 32)
    return ((xx >> r1) ^ (xx >> r2) ^ (xx >> r3)) & _M


def _small_sigma(x: torch.Tensor, r1: int, r2: int, s: int) -> torch.Tensor:
    """rotr(x, r1) ^ rotr(x, r2) ^ (x >> s) on int64 u32 values."""
    xx = x | (x << 32)
    return ((xx >> r1) ^ (xx >> r2) ^ (x >> s)) & _M


def _compress(state: list, w: list) -> list:
    """Plain SHA-256 compression over a batch: ``state`` 8 and ``w`` 16
    int64 tensors of one shape, u32 values. Returns the new state."""
    w = list(w)
    for t in range(16, 64):
        s0 = _small_sigma(w[t - 15], 7, 18, 3)
        s1 = _small_sigma(w[t - 2], 17, 19, 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        t1 = h + _big_sigma(e, 6, 11, 25) + (g ^ (e & (f ^ g))) \
            + (w[t] + _K_INT[t])
        t2 = _big_sigma(a, 2, 13, 22) + ((a & (b | c)) | (b & c))
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M, c, b, a, \
            (t1 + t2) & _M
    return [(x + y) & _M for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _h0_state(shape, device) -> list:
    return [torch.full(shape, int(v), dtype=torch.int64, device=device)
            for v in _H0]


def _sha256_lanes_plain(blocks: torch.Tensor,
                        nblocks: torch.Tensor) -> torch.Tensor:
    """Twin of the ``sha256_lanes`` kernel: [B, N, 16] int32 blocks,
    [B] block counts -> [B, 8] int32 digests."""
    B, N, _ = blocks.shape
    state = _h0_state((B,), blocks.device)
    nb = nblocks.to(torch.int64)
    steps = min(N, int(nb.max())) if B else 0
    for n in range(steps):
        w = _u32(blocks[:, n, :])
        new = _compress(state, [w[:, j] for j in range(16)])
        act = n < nb
        state = [torch.where(act, x, y) for x, y in zip(new, state)]
    return _i32(torch.stack(state, dim=1))


def sha256_blocks(blocks: torch.Tensor, nblocks: torch.Tensor
                  ) -> torch.Tensor:
    """Hash a batch of pre-padded messages.

    blocks:  [B, N, 16] int32 big-endian message words (FIPS-padded);
    nblocks: [B] int32, valid 64-byte blocks per message (<= N).
    returns: [B, 8] int32 digests (u32 bit patterns).
    CUDA: the ``sha256_lanes`` kernel; CPU: its plain twin."""
    if blocks.device.type == "cpu":
        return _sha256_lanes_plain(blocks, nblocks)
    check_cuda("sha256_lanes", blocks, torch.int32, 3)
    check_cuda("sha256_lanes", nblocks, torch.int32, 1)
    B, N, W = blocks.shape
    if W != 16 or nblocks.shape[0] != B or blocks.data_ptr() % 16:
        raise ValueError("sha256_lanes: need 16-byte aligned [B, N, 16] "
                         "blocks and [B] nblocks")
    out = torch.empty((B, 8), dtype=torch.int32, device=blocks.device)
    SHA256_LANES.launch(blocks.device, blocks.data_ptr(), nblocks.data_ptr(),
                        out.data_ptr(), B, N)
    return out


def _sha256_pages_plain(data: torch.Tensor, npp: int,
                        pagemajor: bool = False) -> torch.Tensor:
    """Twin of K1: [P] uint8 (P % 4096 == 0) -> [8 * npp] int32
    digests of its pages, zero pages past P / 4096; word-major, or
    page-major (the word-major table transposed) when ``pagemajor``."""
    F = data.shape[0] // 4096
    x = torch.zeros((npp, 1024), dtype=torch.int64, device=data.device)
    x[:F] = _u32(pack_words_rows(data.view(F, 4096)))  # big-endian words
    x = x.t().contiguous()  # [1024, npp]: word w of every page
    state = _h0_state((npp,), data.device)
    for t in range(64):
        state = _compress(state, [x[16 * t + j] for j in range(16)])
    zero = torch.zeros((npp,), dtype=torch.int64, device=data.device)
    pad = [zero + 0x80000000] + [zero] * 14 + [zero + 4096 * 8]
    state = _compress(state, pad)
    table = _i32(torch.stack(state, dim=0))  # [8, npp]
    if pagemajor:
        table = table.t().contiguous()
    return table.reshape(-1)


def sha256_pages(data: torch.Tensor, npp: int, *,
                 threads: int = PAGES_THREADS,
                 pagemajor: bool = False) -> torch.Tensor:
    """SHA-256 of every 4 KiB page of a resident buffer.

    data: [P] uint8, P % 4096 == 0 (16-byte aligned on the card);
    ``npp`` >= P / 4096 pages are hashed, those past the buffer as zero
    pages. Returns [8 * npp] int32 digests, word j of page p at
    ``j*npp + p`` (the TPU kernel's word-major layout), or at ``p*8 + j``
    when ``pagemajor``. ``threads`` per block (a multiple of 32, at most
    256) is K1's launch configuration; it does not change the result.
    CUDA: K1, which reads the raw bytes and stores either layout itself;
    CPU: its plain twin."""
    P = data.shape[0]
    if data.dim() != 1 or P % 4096 or npp < P // 4096:
        raise ValueError(f"sha256_pages: need [P] bytes with P % 4096 == 0 "
                         f"and npp >= P/4096, got {tuple(data.shape)}, "
                         f"npp {npp}")
    if data.device.type == "cpu":
        return _sha256_pages_plain(data, npp, pagemajor)
    check_cuda("sha256_pages", data, torch.uint8, 1)
    if data.data_ptr() % 16:
        raise ValueError("sha256_pages: the buffer must be 16-byte aligned")
    if threads % 32 or not 32 <= threads <= 256:
        raise ValueError(f"sha256_pages: threads {threads} is not a "
                         f"multiple of 32 in [32, 256]")
    out = torch.empty((8 * npp,), dtype=torch.int32, device=data.device)
    SHA256_PAGES.launch(data.device, data.data_ptr(), out.data_ptr(),
                        P // 4096, npp, threads, int(pagemajor))
    return out


def sha256_pack_host(chunks: list, pad_batch_to: int | None = None,
                     pad_blocks_to: int | None = None):
    """Pad a list of messages into [B, N, 16] uint32 blocks + [B]
    nblocks (numpy; extra lanes carry nblocks=0)."""
    B = len(chunks)
    nb = np.array([(len(c) + 9 + 63) // 64 for c in chunks], dtype=np.int32)
    N = int(nb.max()) if B else 1
    if pad_blocks_to is not None:
        N = max(N, 1)
        target = 1
        while target < N:
            target *= 2
        N = max(target, pad_blocks_to) if N > pad_blocks_to else pad_blocks_to
    Bp = B
    if pad_batch_to is not None:
        Bp = ((B + pad_batch_to - 1) // pad_batch_to) * pad_batch_to
        Bp = max(Bp, pad_batch_to)
    buf = np.zeros((Bp, N * 64), dtype=np.uint8)
    for i, c in enumerate(chunks):
        L = len(c)
        buf[i, :L] = np.frombuffer(c, dtype=np.uint8)
        buf[i, L] = 0x80
        buf[i, nb[i] * 64 - 8: nb[i] * 64] = np.frombuffer(
            (L * 8).to_bytes(8, "big"), dtype=np.uint8)
    words = buf.reshape(Bp, N, 16, 4).astype(np.uint32)
    blocks = ((words[..., 0] << 24) | (words[..., 1] << 16)
              | (words[..., 2] << 8) | words[..., 3])
    nblocks = np.zeros((Bp,), dtype=np.int32)
    nblocks[:B] = nb
    return blocks, nblocks


def digest_bytes(digests) -> list[bytes]:
    """[B, 8] u32 words (numpy, or an int32 tensor) -> 32-byte
    big-endian digests."""
    if isinstance(digests, torch.Tensor):
        digests = digests.cpu().numpy().view(np.uint32)
    d = np.asarray(digests).astype(">u4")
    return [d[i].tobytes() for i in range(d.shape[0])]


def sha256_many(chunks: list, device=None) -> list[bytes]:
    """Hash a list of byte strings on ``device`` -> 32-byte digests."""
    dev = resolve_device(device)
    if not chunks:
        return []
    blocks, nblocks = sha256_pack_host(chunks, pad_batch_to=8,
                                       pad_blocks_to=1)
    out = sha256_blocks(torch.from_numpy(blocks.view(np.int32)).to(dev),
                        torch.from_numpy(nblocks).to(dev))
    return digest_bytes(out)[: len(chunks)]


def pack_words_rows(r: torch.Tensor, *,
                    little_endian: bool = False) -> torch.Tensor:
    """[B, 4*W] uint8 rows -> [B, W] int32 words, big-endian for
    SHA-256, little-endian for MD5. The words are a byte-order view of
    the rows (both the host and the card are little-endian), one copy
    for the big-endian byte swap."""
    B, n = r.shape
    quads = r.reshape(B, n // 4, 4)
    if not little_endian:
        quads = quads.flip(2)
    return quads.contiguous().view(torch.int32).reshape(B, n // 4)


def pack_words(data: torch.Tensor) -> torch.Tensor:
    """[L] uint8 (L % 64 == 0) -> [L/64, 16] int32 big-endian message
    blocks of the whole buffer."""
    return pack_words_rows(data.reshape(data.shape[0] // 64, 64))


def _sha256_rows(wb: torch.Tensor, rows0: torch.Tensor,
                 leaf_len: int) -> torch.Tensor:
    """Plain SHA-256 of full, 64-byte-row-aligned slices of a packed
    buffer: wb [NB, 16] int32 = pack_words(buffer); rows0 [B] first block
    row of each ``leaf_len``-byte slice -> [B, 8] int32 digests (the
    fixed-length FIPS pad is one constant extra block)."""
    B = rows0.shape[0]
    rows0 = rows0.to(torch.int64)
    state = _h0_state((B,), wb.device)
    for t in range(leaf_len // 64):
        w = _u32(wb[rows0 + t])
        state = _compress(state, [w[:, j] for j in range(16)])
    zero = torch.zeros((B,), dtype=torch.int64, device=wb.device)
    bits = leaf_len * 8
    pad = [zero + 0x80000000] + [zero] * 13 + [zero + (bits >> 32),
                                               zero + (bits & _M)]
    return _i32(torch.stack(_compress(state, pad), dim=1))


def sha256_rows(data: torch.Tensor, rows0: torch.Tensor, *,
                leaf_len: int = 4096) -> torch.Tensor:
    """SHA-256 of full ``leaf_len``-byte leaves of a resident buffer:
    data [L] uint8 (L % 64 == 0); rows0 [B] int32, leaf b starts at byte
    ``64 * rows0[b]`` and lies inside ``data`` -> [B, 8] int32 digests.
    CUDA: the K2 kernel, ``ROWS_THREADS`` lanes a block, which reads
    the raw bytes itself (no packed copy of the buffer); CPU: its twin
    ``_sha256_rows(pack_words(data), rows0, leaf_len)``."""
    if leaf_len % 64 or leaf_len <= 0:
        raise ValueError("sha256_rows: leaf_len must be a positive "
                         "multiple of 64")
    if data.device.type == "cpu":
        return _sha256_rows(pack_words(data), rows0, leaf_len)
    check_cuda("sha256_rows", data, torch.uint8, 1)
    check_cuda("sha256_rows", rows0, torch.int32, 1)
    L = data.shape[0]
    if L % 64 or L < leaf_len or data.data_ptr() % 16:
        raise ValueError("sha256_rows: need a 16-byte aligned buffer of "
                         "whole 64-byte rows holding at least one leaf")
    B = rows0.shape[0]
    out = torch.empty((B, 8), dtype=torch.int32, device=data.device)
    SHA256_ROWS.launch(data.device, data.data_ptr(), rows0.data_ptr(),
                       out.data_ptr(), B, L // 64, leaf_len // 64,
                       ROWS_THREADS)
    return out


def sha256_leaves_device(data: torch.Tensor, rows0: torch.Tensor,
                         tail_starts: torch.Tensor,
                         tail_lengths: torch.Tensor, *,
                         leaf_len: int = 4096) -> torch.Tensor:
    """One dispatch for a segment's Merkle leaves (aligned cuts): full
    leaves at 64-byte rows ``rows0`` [F] through ``sha256_rows``, short
    tail leaves (< leaf_len) at ``tail_starts``/``tail_lengths`` [T]
    through ``sha256_chunks_device`` -> [F + T, 8] int32 (full digests,
    then tail digests), fetched by the host in one copy."""
    full = sha256_rows(data, rows0, leaf_len=leaf_len)
    tail = sha256_chunks_device(data, tail_starts, tail_lengths,
                                max_len=leaf_len)
    return torch.cat([full, tail], dim=0)


def _chunk_lane_blocks(data: torch.Tensor, starts: torch.Tensor,
                       lengths: torch.Tensor, max_len: int):
    """The reference's padded messages of slices of ``data``: ([B, N,
    16] int32 big-endian blocks, [B] int32 block counts), built with a
    byte gather (indices clamped into the buffer) and index masks."""
    if max_len >= (1 << 28):
        raise ValueError("bit length is packed in 32-bit lanes")
    dev = data.device
    B = starts.shape[0]
    L = data.shape[0]
    padded = ((max_len + 9) + 63) // 64 * 64
    N = padded // 64
    starts = starts.to(torch.int64)
    lengths = lengths.to(torch.int64)
    j = torch.arange(padded, dtype=torch.int64, device=dev)[None, :]
    idx = (starts[:, None] + j).clamp(0, L - 1)
    raw = data[idx].to(torch.int64)  # [B, padded] byte gather
    lens = lengths[:, None]
    msg = torch.where(j < lens, raw, torch.where(j == lens, 0x80, 0))
    nb = (lengths + 9 + 63) // 64
    k = j - (nb[:, None] * 64 - 8)  # 0..7 inside the length field
    bitlen = (lengths * 8)[:, None]
    # bitlen < 2**31: only bytes 4..7 of the 8-byte field are nonzero.
    len_byte = (bitlen >> ((7 - k.clamp(4, 7)) * 8)) & 0xFF
    msg = torch.where((k >= 4) & (k < 8), len_byte, msg)
    q = msg.view(B, N, 16, 4)
    words = (q[..., 0] << 24) | (q[..., 1] << 16) | (q[..., 2] << 8) \
        | q[..., 3]
    return _i32(words).contiguous(), nb.to(torch.int32).contiguous()


def _sha256_chunks_plain(data: torch.Tensor, starts: torch.Tensor,
                         lengths: torch.Tensor, *,
                         max_len: int) -> torch.Tensor:
    """Twin of ``sha256_slices``: the padded messages of
    ``_chunk_lane_blocks`` through ``_sha256_lanes_plain``."""
    return _sha256_lanes_plain(*_chunk_lane_blocks(data, starts, lengths,
                                                   max_len))


def slice_blocks(max_len: int) -> int:
    """Message blocks of the longest slice of at most ``max_len`` bytes
    (65 at 4096)."""
    return (max_len + 9 + 63) // 64


def sha256_chunks_device(data: torch.Tensor, starts: torch.Tensor,
                         lengths: torch.Tensor, *,
                         max_len: int) -> torch.Tensor:
    """Hash variable-length chunks of a device-resident byte buffer.

    data: [L] uint8; starts/lengths: [B] chunk offsets and lengths
    (<= max_len < 2**28) -> [B, 8] int32 digests, bit-exact vs hashlib,
    with no host sync. As in the reference, each byte index is clamped
    into [0, L - 1] (a slice running past the buffer repeats its last
    byte) and a lane runs at most ``slice_blocks(max_len)`` blocks.
    CUDA: one ``sha256_slices`` launch, which reads the raw bytes with
    16-byte copies and builds the FIPS padding in registers (int32
    starts and lengths, as the reference casts them); the buffer must
    start on a 16-byte boundary (a whole allocation does; a view at an
    offset raises ValueError). CPU: its twin ``_sha256_chunks_plain``,
    which takes any buffer."""
    if max_len >= (1 << 28):
        raise ValueError("bit length is packed in 32-bit lanes")
    if data.device.type == "cpu":
        return _sha256_chunks_plain(data, starts, lengths, max_len=max_len)
    check_cuda("sha256_slices", data, torch.uint8, 1)
    starts = starts.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    check_cuda("sha256_slices", starts, torch.int32, 1)
    check_cuda("sha256_slices", lengths, torch.int32, 1)
    B = starts.shape[0]
    L = data.shape[0]
    if lengths.shape[0] != B or L == 0 or data.data_ptr() % 16:
        raise ValueError("sha256_slices: need a 16-byte aligned, non-empty "
                         "buffer and [B] starts and lengths")
    out = torch.empty((B, 8), dtype=torch.int32, device=data.device)
    SHA256_SLICES.launch(data.device, data.data_ptr(), L, starts.data_ptr(),
                         lengths.data_ptr(), out.data_ptr(), B,
                         slice_blocks(max_len))
    return out
