"""Batched MD5 on the card: the rsync delta engine's strong checksum.

Ports ``volsync_tpu/ops/md5.py``. The reference's rsync mover verifies
weak-checksum matches with MD5 (rsync pairs a rolling weak checksum
with an MD5 strong one); the delta engine (``engine/deltasync.py``)
batches it over signature blocks and candidate windows. One kernel
written for Hopper, ``md5_slices`` (``csrc/md5.cu``), carries the
device work in two forms:

- windows: ``md5_fixed_blocks_device`` (replaces the reference's
  clamped byte gather, padding and ``md5_blocks`` scan, md5.py:168-200)
  and ``md5_contiguous_blocks_device`` (replaces its word pack, K3
  transpose and scan, md5.py:203-264): windows of one length at int64
  byte starts, read in place, the padding built in registers. The
  contiguous form keeps the reference's ``block_len % 1024 == 0``
  precondition and launches the windows form at ``i * block_len``;
  K3 ``transpose_u32`` is not on this path (the kernel reads windows
  in place; ``csrc/md5.cu`` says why);
- lanes: ``md5_blocks`` (replaces the reference's ``md5_blocks`` scan,
  md5.py:113-135) over pre-padded [B, N, 16] little-endian words and a
  block count a lane (``md5_many``).

On a CPU tensor each runs its plain PyTorch twin (``_md5_lanes_plain``
over the reference's padded blocks; ``_md5_contiguous_plain``); on a
CUDA tensor the kernel, always. States travel as [B, 4] int32 tensors
holding the u32 bit patterns; a digest is their little-endian bytes.
The twins compute in int64 holding values in [0, 2**32) and mask with
``_M`` (torch on the CPU has no uint32 ``+``/``<<``/``>>``).

Known difference: starts are int64 here. The reference casts window
starts to int32, so its batched delta scan wraps once a batch passes
2 GiB; below that both agree.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from volsync_tpu_torch import resolve_device
from volsync_tpu_torch.ops._build import Kernel, check_cuda

# T[i] = floor(2^32 * |sin(i+1)|) (RFC 1321 §3.4). Computed in double
# precision, which reproduces the canonical table; golden tests vs hashlib
# enforce bit-exactness. csrc/md5.cu holds the same table.
_T = np.array(
    [int(math.floor(abs(math.sin(i + 1)) * 2**32)) & 0xFFFFFFFF for i in range(64)],
    dtype=np.uint32,
)

_S = np.array(
    [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4 + [6, 10, 15, 21] * 4,
    dtype=np.int32,
)

# Message word index per operation.
_G = np.array(
    [i for i in range(16)]
    + [(5 * i + 1) % 16 for i in range(16)]
    + [(3 * i + 5) % 16 for i in range(16)]
    + [(7 * i) % 16 for i in range(16)],
    dtype=np.int32,
)

_A0 = np.array([0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476], dtype=np.uint32)

_M = 0xFFFFFFFF

# md5_slices' two entry points (csrc/md5.cu); their launches count under
# the one kernel name.
MD5_WINDOWS = Kernel("md5_slices", "md5.cu", "vt_md5_windows",
                     [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int])
MD5_LANES = Kernel("md5_slices", "md5.cu", "vt_md5_lanes",
                   [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)

#: md5_slices' threads per block (fixed in csrc/md5.cu).
MD5_THREADS = 64


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bit pattern."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def _compress(state: list, m: list) -> list:
    """Plain MD5 compression over a batch: ``state`` 4 and ``m`` 16
    int64 tensors of one shape, u32 values. Returns the new state."""
    a, b, c, d = state
    for i in range(64):
        if i < 16:
            f = d ^ (b & (c ^ d))
        elif i < 32:
            f = c ^ (d & (b ^ c))
        elif i < 48:
            f = b ^ c ^ d
        else:
            f = c ^ (b | (d ^ _M))
        tmp = (a + f + (int(_T[i]) + m[int(_G[i])])) & _M
        s = int(_S[i])
        rot = ((tmp << s) | (tmp >> (32 - s))) & _M
        a, d, c, b = d, c, b, (b + rot) & _M
    return [(x + y) & _M for x, y in zip(state, (a, b, c, d))]


def _a0_state(shape, device) -> list:
    return [torch.full(shape, int(v), dtype=torch.int64, device=device)
            for v in _A0]


def _md5_lanes_plain(blocks: torch.Tensor,
                     nblocks: torch.Tensor) -> torch.Tensor:
    """Twin of ``md5_slices``' lanes form: [B, N, 16] int32 blocks, [B]
    block counts -> [B, 4] int32 states."""
    B, N, _ = blocks.shape
    state = _a0_state((B,), blocks.device)
    nb = nblocks.to(torch.int64)
    steps = min(N, int(nb.max())) if B else 0
    for n in range(steps):
        w = blocks[:, n, :].to(torch.int64) & _M
        new = _compress(state, [w[:, j] for j in range(16)])
        act = n < nb
        state = [torch.where(act, x, y) for x, y in zip(new, state)]
    return _i32(torch.stack(state, dim=1)) if B else torch.zeros(
        (0, 4), dtype=torch.int32, device=blocks.device)


def md5_blocks(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """blocks: [B, N, 16] int32 little-endian words (padded); nblocks:
    [B] int32, valid blocks a lane (clamped into [0, N]).

    Returns [B, 4] int32 state words (u32 bit patterns; their
    little-endian serialization is the standard digest).
    CUDA: ``md5_slices``' lanes form; CPU: its twin."""
    if blocks.dim() != 3 or blocks.shape[2] != 16 \
            or nblocks.shape != (blocks.shape[0],):
        raise ValueError(f"md5_blocks: need [B, N, 16] blocks and [B] "
                         f"nblocks, got {tuple(blocks.shape)} and "
                         f"{tuple(nblocks.shape)}")
    if blocks.device.type == "cpu":
        return _md5_lanes_plain(blocks, nblocks)
    resolve_device(blocks.device)  # raises where CUDA is absent
    check_cuda("md5_slices", blocks, torch.int32, 3)
    check_cuda("md5_slices", nblocks, torch.int32, 1)
    if blocks.data_ptr() % 16:
        raise ValueError("md5_slices: the blocks must be 16-byte aligned")
    B, N, _ = blocks.shape
    out = torch.empty((B, 4), dtype=torch.int32, device=blocks.device)
    MD5_LANES.launch(blocks.device, blocks.data_ptr(), nblocks.data_ptr(),
                     out.data_ptr(), B, N)
    return out


def md5_pack_host(chunks: list[bytes]):
    """Pad messages into [B, N, 16] uint32 little-endian blocks + nblocks."""
    B = len(chunks)
    nb = np.array([(len(c) + 9 + 63) // 64 for c in chunks], dtype=np.int32)
    N = int(nb.max()) if B else 1
    buf = np.zeros((B, N * 64), dtype=np.uint8)
    for i, c in enumerate(chunks):
        L = len(c)
        buf[i, :L] = np.frombuffer(c, dtype=np.uint8)
        buf[i, L] = 0x80
        buf[i, nb[i] * 64 - 8 : nb[i] * 64] = np.frombuffer(
            np.array([L * 8], dtype="<u8").tobytes(), dtype=np.uint8
        )
    words = buf.reshape(B, N, 16, 4).astype(np.uint32)
    blocks = (
        words[..., 0] | (words[..., 1] << 8)
        | (words[..., 2] << 16) | (words[..., 3] << 24)
    )
    return blocks, nb


def state_bytes(states) -> list[bytes]:
    """[B, 4] states (an int32 tensor, or uint32 numpy) -> 16-byte
    digests: the words' little-endian bytes (the bit pattern, not a
    value conversion)."""
    if isinstance(states, torch.Tensor):
        states = states.cpu().numpy().view(np.uint32)
    le = np.asarray(states).astype("<u4")
    return [le[i].tobytes() for i in range(le.shape[0])]


def md5_many(chunks: list[bytes], *, device=None) -> list[bytes]:
    """Hash byte strings on ``device`` -> standard 16-byte MD5 digests."""
    dev = resolve_device(device)
    if not chunks:
        return []
    blocks, nblocks = md5_pack_host(chunks)
    out = md5_blocks(torch.from_numpy(blocks.view(np.int32)).to(dev),
                     torch.from_numpy(nblocks).to(dev))
    return state_bytes(out)


def _window_blocks(data: torch.Tensor, starts: torch.Tensor,
                  block_len: int):
    """The reference's padded messages of ``block_len``-byte windows of
    ``data`` at ``starts``: ([B, N, 16] int32 little-endian blocks, [B]
    int32 block counts), from a byte gather with every index clamped
    into [0, L - 1] and index masks for the padding."""
    dev = data.device
    B = starts.shape[0]
    L = data.shape[0]
    padded = (block_len + 9 + 63) // 64 * 64
    N = padded // 64
    j = torch.arange(padded, dtype=torch.int64, device=dev)
    idx = (starts.to(torch.int64)[:, None] + j[None, :]).clamp_(0, L - 1)
    msg = data[idx].to(torch.int64)  # [B, padded] byte gather
    msg[:, block_len:] = 0
    msg[:, block_len] = 0x80
    bits = block_len * 8
    for k in range(8):  # little-endian 64-bit bit length, last 8 bytes
        msg[:, padded - 8 + k] = (bits >> (8 * k)) & 0xFF
    q = msg.view(B, N, 16, 4)
    words = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)
    nb = torch.full((B,), N, dtype=torch.int32, device=dev)
    return _i32(words).contiguous(), nb


def _md5_windows_plain(data: torch.Tensor, starts: torch.Tensor, *,
                       block_len: int) -> torch.Tensor:
    """Twin of ``md5_slices``' windows form: the padded messages of
    ``_window_blocks`` through ``_md5_lanes_plain``."""
    return _md5_lanes_plain(*_window_blocks(data, starts, block_len))


def _check_windows(data: torch.Tensor, starts: torch.Tensor,
                   block_len: int):
    """On CUDA: ``data`` and int64 ``starts`` as the windows form takes
    them; raises on what it does not take, and where CUDA is absent."""
    resolve_device(data.device)
    check_cuda("md5_slices", data, torch.uint8, 1)
    starts = starts.to(torch.int64).contiguous()
    check_cuda("md5_slices", starts, torch.int64, 1)
    if data.shape[0] == 0 or data.data_ptr() % 16 or block_len < 0:
        raise ValueError("md5_slices: need a 16-byte aligned, non-empty "
                         "buffer and a block_len >= 0")
    return starts


def md5_fixed_blocks_device(data: torch.Tensor, starts: torch.Tensor,
                            *, block_len: int) -> torch.Tensor:
    """MD5 of fixed-length windows of a resident buffer (the delta
    scan's strong check).

    data: [L] uint8 (L > 0); starts: [B] window starts (any integer
    type; int64 on the card); every window has length ``block_len``
    and, as in the reference, each byte index is clamped into
    [0, L - 1]. Returns [B, 4] int32 states. CUDA: one ``md5_slices``
    launch (the buffer must start on a 16-byte boundary: a whole
    allocation does; a view at an offset raises ValueError); CPU: its
    twin."""
    if data.device.type == "cpu":
        return _md5_windows_plain(data, starts, block_len=block_len)
    starts = _check_windows(data, starts, block_len)
    B = starts.shape[0]
    out = torch.empty((B, 4), dtype=torch.int32, device=data.device)
    MD5_WINDOWS.launch(data.device, data.data_ptr(), data.shape[0],
                       starts.data_ptr(), block_len, out.data_ptr(), B)
    return out


def _md5_contiguous_plain(data: torch.Tensor, *,
                          block_len: int) -> torch.Tensor:
    """Twin of ``md5_contiguous_blocks_device``: the buffer's
    little-endian words as a [B, block_len / 4] table (a byte-order
    view: the host is little-endian), one compression step a 64-byte
    block across all B blocks, then the constant FIPS pad block of a
    ``block_len``-byte message."""
    B = data.shape[0] // block_len
    w = data[: B * block_len].reshape(B, block_len // 4, 4).contiguous() \
        .view(torch.int32).reshape(B, block_len // 4).to(torch.int64) & _M
    state = _a0_state((B,), data.device)
    for t in range(block_len // 64):
        state = _compress(state, [w[:, 16 * t + j] for j in range(16)])
    zero = torch.zeros((B,), dtype=torch.int64, device=data.device)
    bits = block_len * 8
    pad = [zero + 0x80] + [zero] * 13 + [zero + (bits & _M),
                                        zero + (bits >> 32)]
    return _i32(torch.stack(_compress(state, pad), dim=1))


def md5_contiguous_blocks_device(data: torch.Tensor, *,
                                 block_len: int) -> torch.Tensor:
    """MD5 of every contiguous ``block_len`` window of ``data`` ([L]
    uint8, L % block_len == 0) -> [L / block_len, 4] int32 states: the
    delta signature's bulk path. ``block_len`` must be a multiple of
    1024, as in the reference (``pick_block_len`` gives powers of two
    >= 4 KiB); ``build_signature`` takes ``md5_fixed_blocks_device`` for
    other lengths. CUDA: one ``md5_slices`` launch, windows at ``i *
    block_len``; CPU: ``_md5_contiguous_plain``."""
    assert block_len % 1024 == 0, "the contiguous form takes 1 KiB multiples"
    if data.device.type == "cpu":
        return _md5_contiguous_plain(data, block_len=block_len)
    B = data.shape[0] // block_len
    starts = torch.arange(B, dtype=torch.int64,
                          device=resolve_device(data.device)) * block_len
    return md5_fixed_blocks_device(data, starts, block_len=block_len)
