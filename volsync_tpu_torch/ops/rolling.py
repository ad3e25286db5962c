"""rsync-style rolling weak checksums from prefix sums, as torch ops.

Ports ``volsync_tpu/ops/rolling.py``. The rsync binary slides an
Adler-32-style weak checksum over every byte offset of the source file;
both of its components are window sums, so they are differences of
prefix sums. Checksum of window x[k .. k+W-1] (rsync weak32):

    a(k) = sum x_j                  (mod 2^16)
    b(k) = sum (k + W - j) x_j      (mod 2^16)
    s(k) = a(k) | b(k) << 16

With S = exclusive-cumsum(x) and T = exclusive-cumsum(j * x_j):

    a(k) = S[k+W] - S[k]
    b(k) = (k + W) * (S[k+W] - S[k]) - (T[k+W] - T[k])

The reference sums in uint32 wraparound. Torch on the CPU has no uint32
``+`` or ``cumsum``, so the port sums in int64: each product ``j * x_j``
is reduced mod 2^32 before its cumsum, which keeps T below 2^63 for rows
up to 2 GiB (an unreduced T overflows past ~2.7e8 bytes), and only the
residues mod 2^16 are used. Checksums come back as int64 values in
[0, 2^32), so they compare and sort as the reference's uint32 do. Every
function runs on its input's device; these are plain torch ops on the
card too (no hand-written kernel: ``chip_smoke.py`` times them).
"""

from __future__ import annotations

import torch

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF


def prefix_sums(x: torch.Tensor) -> tuple:
    """Exclusive prefix sums along the last dim of ``x`` ([..., L]
    uint8): (S, T), each [..., L+1] int64, T over ``j * x_j mod 2^32``
    (j the position in the row)."""
    L = x.shape[-1]
    v = x.to(torch.int64)
    S = torch.zeros((*x.shape[:-1], L + 1), dtype=torch.int64,
                    device=x.device)
    torch.cumsum(v, dim=-1, out=S[..., 1:])
    v.mul_(torch.arange(L, dtype=torch.int64, device=x.device))
    v.bitwise_and_(_M32)
    T = torch.zeros_like(S)
    torch.cumsum(v, dim=-1, out=T[..., 1:])
    return S, T


def weak_from_sums(dS: torch.Tensor, dT: torch.Tensor,
                   ends: torch.Tensor) -> torch.Tensor:
    """The weak checksum of windows whose byte and position-weighted
    sums are ``dS``/``dT`` and which end (exclusive) at ``ends`` ->
    int64 in [0, 2^32)."""
    b = (ends * dS - dT).bitwise_and_(_M16)
    return dS.bitwise_and(_M16).bitwise_or_(b.bitwise_left_shift_(16))


def rolling_weak_checksums(data: torch.Tensor, *, window: int
                           ) -> torch.Tensor:
    """Weak checksum at every offset: [L] uint8 -> [max(L - window + 1,
    0)] int64. Buffers shorter than the window have no full window and
    return empty (short tails are checksummed at their true length by
    ``block_weak_checksums`` / ``weak_checksum_host``)."""
    L = data.shape[0]
    if L < window:
        return torch.zeros((0,), dtype=torch.int64, device=data.device)
    S, T = prefix_sums(data)
    width = L - window + 1
    dS = S[window:] - S[:width]
    del S
    dT = T[window:] - T[:width]
    del T
    ends = torch.arange(window, L + 1, dtype=torch.int64, device=data.device)
    return weak_from_sums(dS, dT, ends)


def block_weak_checksums(data: torch.Tensor, *, block_len: int
                         ) -> torch.Tensor:
    """Weak checksum of each non-overlapping block ([L] uint8 -> [nb]
    int64). The final partial block (if any) is checksummed at its true
    (shorter) length, as the delta engine's signature wants it."""
    L = data.shape[0]
    nb = (L + block_len - 1) // block_len
    S, T = prefix_sums(data)
    starts = torch.arange(nb, dtype=torch.int64,
                          device=data.device) * block_len
    ends = (starts + block_len).clamp_(max=L)
    return weak_from_sums(S[ends] - S[starts], T[ends] - T[starts], ends)


def weak_checksum_host(block: bytes) -> int:
    """Reference scalar implementation (for tests and tiny control paths)."""
    a = 0
    b = 0
    n = len(block)
    for i, byte in enumerate(block):
        a = (a + byte) & 0xFFFF
        b = (b + (n - i) * byte) & 0xFFFF
    return a | (b << 16)
