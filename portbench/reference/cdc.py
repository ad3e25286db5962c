"""Plain content-defined chunking: the FastCDC cuts the repository format
asks for, in NumPy, written from the format and not from the program.

The format (restic's chunker sizes on the repository's 4 KiB grid):

- the gear table is ``mix32((b + seed) mod 2**32)`` for b in 0..255, with
  the Murmur3 32-bit finalizer as ``mix32``;
- the gear hash at position i is ``sum_{k<32} G[x[i-k]] << k (mod 2**32)``;
  only positions ``r*align + align-1`` may end a chunk;
- a position is a strict candidate when its hash has no bit set under the
  top ``bits - log2(align) + norm`` bits, a lax one under the top
  ``bits - log2(align) - norm`` bits (``bits = log2(avg)``);
- the walk from ``pos`` takes the first strict candidate in
  ``[pos+min-1, pos+avg-2]``, else the first lax one in
  ``[pos+avg-1, pos+max-1]``, else cuts at ``pos+max-1`` (or the end).
"""

from __future__ import annotations

import dataclasses

import numpy as np

M32 = 0xFFFFFFFF
WINDOW = 32


@dataclasses.dataclass(frozen=True)
class Chunker:
    min_size: int
    avg_size: int
    max_size: int
    seed: int
    align: int
    norm_level: int = 2

    @classmethod
    def from_config(cls, cfg: dict) -> "Chunker":
        return cls(min_size=int(cfg["min_size"]), avg_size=int(cfg["avg_size"]),
                   max_size=int(cfg["max_size"]), seed=int(cfg["seed"]),
                   align=int(cfg["align"]),
                   norm_level=int(cfg.get("norm_level", 2)))

    def _top_mask(self, bits: int) -> int:
        bits = max(1, min(bits, 31))
        return (((1 << bits) - 1) << (32 - bits)) & M32

    @property
    def eff_bits(self) -> int:
        return (self.avg_size.bit_length() - 1) - (self.align.bit_length() - 1)

    @property
    def mask_strict(self) -> int:
        return self._top_mask(self.eff_bits + self.norm_level)

    @property
    def mask_lax(self) -> int:
        return self._top_mask(self.eff_bits - self.norm_level)

    def gear_table(self) -> np.ndarray:
        x = (np.arange(256, dtype=np.uint64) + np.uint64(self.seed & M32)) \
            & np.uint64(M32)
        for shift, mul in ((16, 0x7FEB352D), (15, 0x846CA68B)):
            x = ((x ^ (x >> np.uint64(shift))) * np.uint64(mul)) & np.uint64(M32)
        return x ^ (x >> np.uint64(16))


def candidates(data: np.ndarray, ch: Chunker, table: np.ndarray,
               rows_per_block: int = 1 << 16) -> tuple[np.ndarray, np.ndarray]:
    """(strict, lax) end positions of ``data`` (uint8), in order."""
    a = ch.align
    if a < WINDOW:
        raise ValueError("the plain chunker covers align >= 32 only")
    n = len(data) // a
    shifts = np.arange(WINDOW - 1, -1, -1, dtype=np.uint64)
    strict, lax = [], []
    for r0 in range(0, n, rows_per_block):
        r1 = min(n, r0 + rows_per_block)
        win = data[r0 * a: r1 * a].reshape(r1 - r0, a)[:, a - WINDOW:]
        h = ((table[win] << shifts) & np.uint64(M32)).sum(axis=1) & np.uint64(M32)
        pos = np.arange(r0, r1, dtype=np.int64) * a + (a - 1)
        strict.append(pos[(h & np.uint64(ch.mask_strict)) == 0])
        lax.append(pos[(h & np.uint64(ch.mask_lax)) == 0])
    empty = np.zeros(0, np.int64)
    return (np.concatenate(strict) if strict else empty,
            np.concatenate(lax) if lax else empty)


def cuts(data, ch: Chunker, table: np.ndarray | None = None
         ) -> list[tuple[int, int]]:
    """[(start, length)] covering ``data``, the last chunk ending at EOF."""
    data = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data
    length = len(data)
    if length == 0:
        return []
    if table is None:
        table = ch.gear_table()
    strict, lax = candidates(data, ch, table)
    out, pos = [], 0
    while pos < length:
        lo = pos + ch.min_size - 1
        mid = pos + ch.avg_size - 1
        hi = pos + ch.max_size - 1
        cut = None
        i = np.searchsorted(strict, lo)
        if i < len(strict) and strict[i] <= min(mid - 1, length - 1, hi):
            cut = int(strict[i])
        if cut is None:
            j = np.searchsorted(lax, max(lo, mid))
            if j < len(lax) and lax[j] <= min(hi, length - 1):
                cut = int(lax[j])
        if cut is None:
            cut = hi if hi <= length - 1 else length - 1
        out.append((pos, cut - pos + 1))
        pos = cut + 1
    return out
