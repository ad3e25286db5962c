"""Batched GF(2^8) Reed-Solomon erasure coding as PyTorch ops.

Ports ``volsync_tpu/ops/rs.py``. A sealed pack body is split into k
equal data shards and extended with m parity shards so that ANY k of
the k+m shards reconstruct the body: m arbitrary losses survive at
(k+m)/k storage, against the 2x of full-pack mirrors.

- Field: GF(2^8) mod the primitive polynomial 0x11D, generator 2.
  Multiplication is ``exp[log[a] + log[b]]`` with a doubled exp table
  so the index sum (at most 508) never needs a mod 255; zeros are
  masked (``log[0]`` is 0 in the table, so an unmasked gather would
  multiply a zero byte by 1).
- Generator matrix: systematic ``[I_k ; C]`` with the m x k Cauchy
  matrix ``C[i][j] = 1/(x_i ^ y_j)``, ``x_i = k + i``, ``y_j = j``:
  every k x k submatrix is invertible, so any k surviving rows decode.
- The tables, matrices, host packing and the NumPy oracles
  (``rs_encode_np``, ``rs_reconstruct_np``) are the reference's, byte
  for byte.
- ``gf_matmul`` replaces the reference's per-matrix ``jax.jit`` cache
  (``_gf_matmul_fn``): plain torch ops on the grid's device, one log
  gather per input shard and one exp gather per nonzero coefficient,
  masked where the data byte is 0 and XORed into the row's accumulator.
  A zero coefficient adds no term, as the reference drops it at trace
  time. The same ops on a CPU tensor are its CPU twin. It is bound by
  the bytes it moves; ``CALLS`` counts its calls (under a lock: the
  upload pool and the restore's fetchers call it from several threads).
- Decoding inverts the k x k surviving submatrix on the host
  (Gauss-Jordan, at most 16 x 16) and applies the same ``gf_matmul``
  with the inverse rows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from volsync_tpu_torch import resolve_device
from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.obs import record_copy

_GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1, primitive over GF(2)
_PAGE = 4096      # page-grid minor dim (matches the pack seal alignment)
_MAX_SHARDS = 256  # field size bounds k + m

# exp/log tables for generator 2. The exp table is doubled (510 live
# entries) so exp[log[a] + log[b]] never needs an explicit mod 255.
_GF_EXP = np.zeros(512, dtype=np.uint8)
_GF_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _GF_EXP[_i] = _x
    _GF_LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _GF_POLY
_GF_EXP[255:510] = _GF_EXP[:255]
del _x, _i


class CallCount:
    """Calls of ``gf_matmul`` (any device), counted under a lock."""

    def __init__(self):
        self._lock = lockcheck.make_lock("ops.rs_calls")
        self.n = 0

    def add(self) -> None:
        with self._lock:
            self.n += 1


CALLS = CallCount()


def gf_mul_np(a, b) -> np.ndarray:
    """Elementwise GF(2^8) multiply (NumPy oracle path)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    prod = _GF_EXP[_GF_LOG[a] + _GF_LOG[b]]
    return np.where((a == 0) | (b == 0), 0, prod).astype(np.uint8)


def gf_inv_np(a: int) -> int:
    """GF(2^8) multiplicative inverse of a nonzero scalar."""
    if a == 0:
        raise ZeroDivisionError("gf_inv_np(0)")
    return int(_GF_EXP[255 - _GF_LOG[a]])


def rs_generator_matrix(k: int, m: int) -> np.ndarray:
    """[m, k] uint8 Cauchy parity rows (x_i = k+i, y_j = j)."""
    if k < 1 or m < 1 or k + m > _MAX_SHARDS:
        raise ValueError(f"invalid RS scheme {k}+{m}")
    rows = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            rows[i, j] = gf_inv_np((k + i) ^ j)
    return rows


def rs_full_matrix(k: int, m: int) -> np.ndarray:
    """[k+m, k] systematic matrix: identity data rows over Cauchy parity."""
    return np.concatenate(
        [np.eye(k, dtype=np.uint8), rs_generator_matrix(k, m)], axis=0)


def gf_mat_inv_np(a: np.ndarray) -> np.ndarray:
    """Invert a [k, k] GF(2^8) matrix by Gauss-Jordan (host side; k is
    tiny). Raises ValueError if singular — cannot happen for submatrices
    of the Cauchy construction, but decode guards anyway."""
    k = a.shape[0]
    aug = np.concatenate(
        [a.astype(np.uint8), np.eye(k, dtype=np.uint8)], axis=1)
    for col in range(k):
        piv = col
        while piv < k and aug[piv, col] == 0:
            piv += 1
        if piv == k:
            raise ValueError("singular GF(2^8) matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = gf_mul_np(gf_inv_np(int(aug[col, col])), aug[col])
        for row in range(k):
            if row != col and aug[row, col]:
                aug[row] ^= gf_mul_np(int(aug[row, col]), aug[col])
    return aug[:, k:].copy()


# -- NumPy golden oracle -----------------------------------------------------


def rs_encode_np(data: np.ndarray, m: int) -> np.ndarray:
    """[k, L] uint8 data shards -> [m, L] parity shards (pure NumPy)."""
    k = data.shape[0]
    gm = rs_generator_matrix(k, m)
    out = np.zeros((m, data.shape[1]), dtype=np.uint8)
    for i in range(m):
        acc = np.zeros(data.shape[1], dtype=np.uint8)
        for j in range(k):
            acc ^= gf_mul_np(gm[i, j], data[j])
        out[i] = acc
    return out


def rs_decode_plan(k: int, m: int, have: list[int]) -> tuple[list[int],
                                                             np.ndarray]:
    """Pick k surviving shard indices and build the [k, k] inverse that
    maps their rows back to the data shards. ``have`` is the sorted set
    of healthy shard indices (0..k-1 data, k..k+m-1 parity); data shards
    are preferred so a fully-systematic survival decodes by identity."""
    if len(have) < k:
        raise ValueError(f"need {k} shards, have {len(have)}")
    use = sorted(have)[:k]
    sub = rs_full_matrix(k, m)[use]
    return use, gf_mat_inv_np(sub)


def rs_reconstruct_np(shards: dict[int, np.ndarray], k: int,
                      m: int) -> np.ndarray:
    """Recover the [k, L] data shards from any k healthy shards
    (pure-NumPy oracle; ``shards`` maps shard index -> [L] uint8)."""
    use, inv = rs_decode_plan(k, m, sorted(shards))
    L = shards[use[0]].shape[0]
    out = np.zeros((k, L), dtype=np.uint8)
    for j in range(k):
        acc = np.zeros(L, dtype=np.uint8)
        for i in range(k):
            acc ^= gf_mul_np(inv[j, i], shards[use[i]])
        out[j] = acc
    return out


# -- device ops --------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _tables(device: torch.device) -> tuple:
    """(exp uint8, log int32) tables on ``device`` (one pair a device)."""
    return (torch.from_numpy(_GF_EXP).to(device),
            torch.from_numpy(_GF_LOG).to(device))


def gf_matmul(rows: np.ndarray, grid: torch.Tensor) -> torch.Tensor:
    """Apply a host [r, k] GF(2^8) matrix to a [k, P, _PAGE] uint8 page
    grid -> [r, P, _PAGE] uint8, on the grid's device."""
    dev = resolve_device(grid.device)
    rows = np.asarray(rows, dtype=np.uint8)
    r, k = rows.shape
    if (grid.dtype != torch.uint8 or grid.dim() != 3
            or grid.shape[0] != k or grid.shape[2] != _PAGE):
        raise ValueError(f"gf_matmul: expected a [{k}, P, {_PAGE}] uint8 "
                         f"grid, got {tuple(grid.shape)} {grid.dtype}")
    CALLS.add()
    exp_t, log_t = _tables(dev)
    logc = _GF_LOG[rows]  # [r, k] coefficient logs, host ints
    flat = grid.reshape(k, -1)
    out = torch.zeros((r, flat.shape[1]), dtype=torch.uint8, device=dev)
    for j in range(k):
        col = rows[:, j]
        if not col.any():
            continue
        dlog = torch.index_select(log_t, 0, flat[j].to(torch.int32))
        zero = flat[j] == 0
        for i in range(r):
            if col[i] == 0:
                continue  # a zero coefficient adds no term
            term = torch.index_select(exp_t, 0, dlog + int(logc[i, j]))
            out[i] ^= term.masked_fill_(zero, 0)
    return out.reshape(r, *grid.shape[1:])


def rs_pack_host(shards: list, *, pad_pages_to: int | None = None):
    """Pack k equal-length shard buffers into the [k, P, _PAGE] page
    grid. Zero-pads the tail page (linear-code safe) and optionally
    rounds P up to a multiple of ``pad_pages_to``."""
    k = len(shards)
    if k == 0:
        raise ValueError("rs_pack_host: no shards")
    L = len(shards[0])
    pages = max((L + _PAGE - 1) // _PAGE, 1)
    if pad_pages_to is not None:
        pages = ((pages + pad_pages_to - 1) // pad_pages_to) * pad_pages_to
    buf = np.zeros((k, pages * _PAGE), dtype=np.uint8)
    for i, s in enumerate(shards):
        if len(s) != L:
            raise ValueError("rs_pack_host: unequal shard lengths")
        buf[i, :L] = np.frombuffer(s, dtype=np.uint8)
    return buf.reshape(k, pages, _PAGE), L


def rs_encode_device(data_grid: torch.Tensor, m: int) -> torch.Tensor:
    """[k, P, _PAGE] data page grid -> [m, P, _PAGE] parity page grid,
    on the grid's device."""
    k = int(data_grid.shape[0])
    return gf_matmul(rs_generator_matrix(k, m), data_grid)


def rs_reconstruct_device(shards: dict, k: int, m: int, shard_len: int,
                          *, device=None) -> list[bytes]:
    """Recover all k data shards from any k healthy shards on ``device``
    (CUDA by default). ``shards`` maps shard index -> buffer; returns
    the k data shards as ``shard_len``-byte strings."""
    dev = resolve_device(device)
    use, inv = rs_decode_plan(k, m, sorted(shards))
    grid, L = rs_pack_host([shards[i] for i in use])
    if L != shard_len:
        raise ValueError("rs_reconstruct_device: shard length mismatch")
    out = gf_matmul(inv, torch.from_numpy(grid).to(dev)).cpu().numpy()
    flat = out.reshape(k, -1)[:, :shard_len]
    record_copy("ec.decode", k * shard_len)
    return [flat[i].tobytes() for i in range(k)]
