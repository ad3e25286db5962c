"""Content-defined chunking parameters, the gear hash, candidate
compaction and the host FastCDC walk.

Ports ``volsync_tpu/ops/gearcdc.py``:

- ``GearParams`` / ``DEFAULT_PARAMS``: the port's own frozen dataclass
  with the reference's fields, masks and gear table (the two packages
  chunk identically under equal parameters; see
  ``engine/chunker.params_from_reference``);
- ``_mix_u32``, ``_make_gear_table``, ``gear_at_aligned`` and
  ``gear_hash_positions`` (ref :169-199) in torch;
- ``cdc_candidates_aligned[_packed]`` (ref :202-243, the split-phase
  engine's candidates) and ``cdc_candidates`` (ref :246-273, the legacy
  align=1 engine's), compacted without a host sync by ``nonzero_fixed``;
  ``fetch_candidates`` runs either with the capacity retry and one
  fetch, and ``chunk_buffer`` (ref :338-385) chunks a buffer with it;
- ``select_boundaries`` (the reference's ``_select_boundaries_py``
  walk; the reference tries its native walk first, and its golden tests
  pin the two equal) and ``host_candidates`` in numpy: the host oracle
  the device path is held against.

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

from volsync_tpu_torch import resolve_device

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
    ``r*align + align-1``: 4096 runs the fused engine, 64 <= align <
    4096 the split-phase one, 1 the legacy per-byte one."""

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


def gear_hash_positions(data: torch.Tensor, seed: int) -> torch.Tensor:
    """Gear hash at every byte position of ``data`` ([L] uint8 -> [L]
    int64 holding u32 values), by shift-doubling: after the passes m =
    1, 2, 4, 8, 16 position i sums ``G[b_{i-k}] << k`` over k < 32.
    Positions < 31 hash a shorter prefix window (the recurrence starts
    from 0, as in the reference); no cut reads them since min_size >=
    32."""
    L = data.shape[0]
    h = _mix_u32((data.to(torch.int64) + (seed & _M)) & _M)
    for m in (1, 2, 4, 8, 16):
        shifted = torch.cat([h.new_zeros(min(m, L)), h[: max(L - m, 0)]])
        h = (h + (shifted << m)) & _M
    return h


def nonzero_fixed(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)`` along the last
    dim, without a host sync: [..., R] bool -> [..., size] int64 indices
    in order, padded with ``fill``. Ranks come from a cumsum and each
    index scatters into its rank; ranks >= size and non-members land in
    one extra slot that is dropped."""
    R = mask.shape[-1]
    rank = torch.cumsum(mask, dim=-1) - 1
    slot = torch.where(mask & (rank < size), rank, size)
    idx = torch.arange(R, dtype=torch.int64, device=mask.device)
    out = torch.full((*mask.shape[:-1], size + 1), fill, dtype=torch.int64,
                     device=mask.device)
    out.scatter_(-1, slot, idx.expand_as(slot))
    return out[..., :size]


def cdc_candidates_aligned(data: torch.Tensor, *, seed: int, mask_s: int,
                           mask_l: int, align: int, max_candidates: int,
                           valid_len=None):
    """Aligned cut candidates of ``data`` ([L] uint8, L % align == 0)
    -> (positions [cap] int32, strict flags [cap] bool, true lax count
    as a 0-d int64 tensor). The strict mask's zero bits contain the lax
    mask's, so only lax candidates are compacted, each with its strict
    flag. Fill slots hold ``R*align + align-1`` (R = L/align) with flag
    False, as the reference's ``nonzero(..., fill_value=R)``; the count
    may exceed ``max_candidates`` (the caller retries). Positions at or
    past ``valid_len`` are masked."""
    h = gear_at_aligned(data, seed, align)
    R = h.shape[0]
    is_s = (h & mask_s) == 0
    is_l = (h & mask_l) == 0
    if valid_len is not None:
        pos_ok = (torch.arange(R, dtype=torch.int64, device=data.device)
                  * align + (align - 1)) < valid_len
        is_s = is_s & pos_ok
        is_l = is_l & pos_ok
    ridx = nonzero_fixed(is_l, max_candidates, R)
    flags = (ridx < R) & is_s[ridx.clamp(max=R - 1)]
    pos = (ridx * align + (align - 1)).to(torch.int32)
    return pos, flags, is_l.sum()


def cdc_candidates_aligned_packed(data: torch.Tensor, *, seed: int,
                                  mask_s: int, mask_l: int, align: int,
                                  max_candidates: int, valid_len=None
                                  ) -> torch.Tensor:
    """``cdc_candidates_aligned`` packed into one [2*cap + 1] int32
    tensor (positions, strict flags, count): one fetch per segment,
    bit-identical to the reference's packed array."""
    pos, flags, count = cdc_candidates_aligned(
        data, seed=seed, mask_s=mask_s, mask_l=mask_l, align=align,
        max_candidates=max_candidates, valid_len=valid_len)
    return torch.cat([pos, flags.to(torch.int32),
                      count.reshape(1).to(torch.int32)])


def cdc_candidates(data: torch.Tensor, *, seed: int, mask_s: int,
                   mask_l: int, max_candidates: int, valid_len=None):
    """Per-byte cut candidates of ``data`` ([L] uint8) -> (idx_s [cap],
    count_s, idx_l [cap], count_l): the first ``max_candidates``
    positions whose gear hash clears the strict / lax mask, padded with
    L, and the true counts as 0-d int64 tensors (no host sync).
    Positions at or past ``valid_len`` are masked, so zero padding
    neither adds candidates nor inflates the counts."""
    h = gear_hash_positions(data, seed)
    is_s = (h & mask_s) == 0
    is_l = (h & mask_l) == 0
    L = data.shape[0]
    if valid_len is not None:
        pos_ok = torch.arange(L, dtype=torch.int64,
                              device=data.device) < valid_len
        is_s = is_s & pos_ok
        is_l = is_l & pos_ok
    return (nonzero_fixed(is_s, max_candidates, L), is_s.sum(),
            nonzero_fixed(is_l, max_candidates, L), is_l.sum())


def fetch_candidates(dev: torch.Tensor, params: GearParams,
                     length: int) -> tuple[np.ndarray, np.ndarray]:
    """(strict, lax) sorted cut positions below ``length`` of a resident
    buffer, as host arrays (ref ``DeviceChunkHasher._candidates``).
    align > 1: ``cdc_candidates_aligned_packed`` from 4096 slots, one
    fetch per try. align == 1: ``cdc_candidates`` from L/64 slots, which
    covers any mask down to 2^-6 density; one fetch of the counts, one
    of the candidates. Denser (adversarial) data retries with a doubled
    capacity, so the result never depends on the capacity."""
    p = params
    if p.align > 1:
        cap = 4096
        while True:
            packed = cdc_candidates_aligned_packed(
                dev, seed=p.seed, mask_s=p.mask_s, mask_l=p.mask_l,
                align=p.align, max_candidates=cap,
                valid_len=length).cpu().numpy()
            c = int(packed[-1])
            if c <= cap:
                break
            cap = _pow2ceil_int(c, cap * 2)
        pos = packed[:c].astype(np.int64)
        return pos[packed[cap: cap + c].astype(bool)], pos
    cap = max(1, int(dev.shape[0]) // 64)
    while True:
        idx_s, count_s, idx_l, count_l = cdc_candidates(
            dev, seed=p.seed, mask_s=p.mask_s, mask_l=p.mask_l,
            max_candidates=cap, valid_len=length)
        cs, cl = torch.stack([count_s, count_l]).tolist()
        if cs <= cap and cl <= cap:
            break
        cap = _pow2ceil_int(max(cs, cl), cap * 2)
    both = torch.cat([idx_s[:cs], idx_l[:cl]]).cpu().numpy()
    return both[:cs], both[cs:]


def chunk_buffer(data, params: GearParams = DEFAULT_PARAMS, *,
                 eof: bool = True, device=None) -> list[tuple[int, int]]:
    """Chunk a byte buffer (bytes-like, uint8 ndarray or tensor) on
    ``device`` -> [(start, length)] covering it (the last chunk may be
    shorter than min_size iff ``eof``). Aligned params pad the buffer
    to a multiple of ``align`` first; candidates are masked at the true
    length."""
    dev = resolve_device(device)
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(data, dtype=np.uint8)
    length = int(data.shape[0])
    if length == 0:
        return []
    if length <= params.min_size:
        return [(0, length)] if eof else []
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.array(data, dtype=np.uint8))
    buf = data.to(device=dev, dtype=torch.uint8)
    pad = -length % params.align
    if pad:
        buf = torch.cat([buf, buf.new_zeros(pad)])
    idx_s, idx_l = fetch_candidates(buf, params, length)
    return select_boundaries(idx_s, idx_l, length, params, eof=eof)


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
