"""Content-defined chunking parameters, the aligned gear hash, and the
host FastCDC walk.

Ports ``volsync_tpu/ops/gearcdc.py`` for the page-aligned fused path:

- ``GearParams`` / ``DEFAULT_PARAMS``: the port's own frozen dataclass
  with the reference's fields, masks and gear table (the two packages
  chunk identically under equal parameters; see
  ``engine/chunker.params_from_reference``);
- ``_mix_u32``, ``_make_gear_table`` and ``gear_at_aligned`` in torch;
- ``select_boundaries`` (the reference's ``_select_boundaries_py``
  walk) and ``host_candidates`` in numpy: the host oracle the device
  path is held against.

32-bit arithmetic: torch on the CPU has no uint32 ``+``, ``<<`` or
``>>``, so hash words are carried as int64 values in ``[0, 2**32)`` and
masked with ``_M`` where a result could leave that range. Products are
split so that no int64 multiply overflows.

The gear hash at position i is ``sum_{k<32} G[b_{i-k}] << k (mod
2**32)``: a pure function of the trailing 32 bytes. With ``align >=
32`` the window ending at ``r*align + align-1`` lies inside row r, so
the aligned evaluation is a reshape plus a weighted row sum.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

_WINDOW = 32  # bytes of context in a 32-bit gear hash
_M = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), without an
    int64 overflow: the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M


def _mix_u32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3-style finalizer (the gear table as a function), on int64
    tensors holding u32 values."""
    x = _mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul_u32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _make_gear_table(seed: int) -> np.ndarray:
    b = torch.arange(256, dtype=torch.int64)
    return _mix_u32((b + (seed & _M)) & _M).numpy().astype(np.uint32)


def _pow2ceil_int(n: int, lo: int) -> int:
    """Pow2 bucketing for retry capacities."""
    v = lo
    while v < n:
        v *= 2
    return v


def _top_mask(bits: int) -> int:
    """Mask selecting the top ``bits`` bits of a uint32."""
    bits = max(1, min(bits, 31))
    return (((1 << bits) - 1) << (32 - bits)) & _M


@dataclasses.dataclass(frozen=True)
class GearParams:
    """CDC parameters (fields, defaults and derived masks as in the
    reference ``GearParams``). ``align`` constrains cut positions to
    ``r*align + align-1``; the port's fused path needs align == 4096."""

    min_size: int = 512 * 1024
    avg_size: int = 1024 * 1024
    max_size: int = 8 * 1024 * 1024
    seed: int = 0x5EED_CDC1
    norm_level: int = 2  # FastCDC normalization: mask_s=bits+n, mask_l=bits-n
    align: int = 64

    def __post_init__(self):
        if not self.min_size >= _WINDOW:
            raise ValueError("min_size must cover the gear window")
        if not self.min_size <= self.avg_size <= self.max_size:
            raise ValueError("need min_size <= avg_size <= max_size")
        if self.avg_size & (self.avg_size - 1):
            raise ValueError("avg_size must be 2^k")
        if self.align < 1 or self.align & (self.align - 1):
            raise ValueError("align must be a power of two")
        if self.align > 1:
            if self.align < _WINDOW:
                raise ValueError("align must be >= the gear window")
            if self.min_size % self.align or self.max_size % self.align:
                raise ValueError("min_size and max_size must be multiples "
                                 "of align")
            if self.eff_bits - self.norm_level < 1:
                raise ValueError("avg_size too small for this "
                                 "align/norm combination")

    @property
    def bits(self) -> int:
        return int(self.avg_size).bit_length() - 1

    @property
    def eff_bits(self) -> int:
        """Mask bits after discounting the 1/align eligible positions."""
        return self.bits - (int(self.align).bit_length() - 1)

    @property
    def mask_s(self) -> int:
        """Strict mask for aligned evaluation."""
        return _top_mask(self.eff_bits + self.norm_level)

    @property
    def mask_l(self) -> int:
        return _top_mask(self.eff_bits - self.norm_level)

    @property
    def dense_mask_s(self) -> int:
        """Strict mask for per-position evaluation (no align discount)."""
        return _top_mask(self.bits + self.norm_level)

    @property
    def dense_mask_l(self) -> int:
        return _top_mask(self.bits - self.norm_level)

    @functools.cached_property
    def table(self) -> np.ndarray:
        return _make_gear_table(self.seed)


#: Repo-format default: page-aligned cuts (align == the 4 KiB Merkle
#: leaf), min 512 KiB / avg 1 MiB / max 8 MiB.
DEFAULT_PARAMS = GearParams(align=4096)


def gear_at_aligned(data: torch.Tensor, seed: int,
                    align: int) -> torch.Tensor:
    """Gear hash at positions ``r*align + align-1`` of ``data`` ([L]
    uint8, L % align == 0) -> [L/align] int64 holding u32 values."""
    L = data.shape[0]
    rows = data.view(L // align, align)[:, align - _WINDOW:]
    g = _mix_u32((rows.to(torch.int64) + (seed & _M)) & _M)
    shifts = torch.arange(_WINDOW - 1, -1, -1, dtype=torch.int64,
                          device=data.device)  # 31..0
    return ((g << shifts) & _M).sum(dim=1) & _M


def host_candidates(data: np.ndarray, params: GearParams, length: int,
                    base: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """numpy oracle for the aligned candidates of a host buffer: the
    (strict, lax) cut positions ``r*align + align-1`` below ``length``,
    offset by ``base``. Uses the 256-entry gear table, not the device
    formula, so it checks the device path independently."""
    a = params.align
    n = len(data) // a
    win = np.asarray(data[: n * a]).reshape(n, a)[:, a - _WINDOW:]
    g = params.table[win].astype(np.uint64)
    shifts = np.arange(_WINDOW - 1, -1, -1, dtype=np.uint64)
    h = ((g << shifts) & np.uint64(_M)).sum(axis=1) & np.uint64(_M)
    pos = np.arange(n, dtype=np.int64) * a + (a - 1)
    ok = pos < length
    is_s = ok & ((h & np.uint64(params.mask_s)) == 0)
    is_l = ok & ((h & np.uint64(params.mask_l)) == 0)
    return pos[is_s] + base, pos[is_l] + base


def select_boundaries(idx_s: np.ndarray, idx_l: np.ndarray, length: int,
                      params: GearParams, *, eof: bool = True,
                      base: int = 0) -> list[tuple[int, int]]:
    """FastCDC walk over sorted candidate cut positions ->
    [(start, length)] (the reference's ``_select_boundaries_py``).

    ``idx_*`` are positions relative to this buffer (cut after position
    i => the chunk ends at i+1); ``base`` is added to emitted starts.
    With ``eof`` False the unterminated tail is withheld."""
    chunks: list[tuple[int, int]] = []
    pos = 0
    while pos < length:
        lo = pos + params.min_size - 1  # earliest cut (chunk len >= min)
        mid = pos + params.avg_size - 1
        hi = pos + params.max_size - 1  # latest cut (chunk len <= max)
        cut = None
        i = np.searchsorted(idx_s, lo, side="left")
        if i < len(idx_s) and idx_s[i] <= min(mid - 1, length - 1, hi):
            cut = int(idx_s[i])
        if cut is None:
            j = np.searchsorted(idx_l, max(lo, mid), side="left")
            if j < len(idx_l) and idx_l[j] <= min(hi, length - 1):
                cut = int(idx_l[j])
        if cut is None:
            if hi <= length - 1:
                cut = hi
            elif eof:
                cut = length - 1  # final short chunk
            else:
                break  # tail continues into the next segment
        chunks.append((base + pos, cut - pos + 1))
        pos = cut + 1
    return chunks
