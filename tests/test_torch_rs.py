"""The port's GF(2^8) Reed-Solomon core (``volsync_tpu_torch/ops/rs.py``)
against the JAX package's (``volsync_tpu/ops/rs.py``), on the CPU.

The tables and generator matrices are the reference's; ``gf_matmul``
(the CPU twin of the device op) equals the reference's
``gf_matmul_device`` and the NumPy oracle at schemes 2+1, 4+2, 6+3 and
16+8, on random and zero-heavy grids, with coefficient matrices that
hold zeros; ``rs_reconstruct_device`` equals ``rs_reconstruct_np`` for
every 2-loss pattern of 4+2. Tolerance: exact (bytes of a finite
field). Inputs are made from a seed with numpy.
"""

from itertools import combinations

import numpy as np
import pytest
import torch

from volsync_tpu.ops import rs as jrs
from volsync_tpu_torch.ops import rs

torch.set_num_threads(1)

SCHEMES = [(2, 1), (4, 2), (6, 3), (16, 8)]
PAGES = 2


def _grid(seed: int, k: int, kind: str) -> np.ndarray:
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 256, size=(k, PAGES, rs._PAGE), dtype=np.uint8)
    if kind == "zero-heavy":
        grid[rng.random(grid.shape) < 0.9] = 0
        grid[0] = 0  # one all-zero input shard
    return grid


def test_tables_equal_the_reference():
    assert rs._GF_EXP.dtype == jrs._GF_EXP.dtype
    assert rs._GF_LOG.dtype == jrs._GF_LOG.dtype
    np.testing.assert_array_equal(rs._GF_EXP, jrs._GF_EXP)
    np.testing.assert_array_equal(rs._GF_LOG, jrs._GF_LOG)
    assert rs._GF_LOG[0] == 0  # why gf_matmul masks zero bytes
    a = np.arange(256, dtype=np.uint8)
    for b in (0, 1, 2, 0x8E, 255):
        np.testing.assert_array_equal(rs.gf_mul_np(a, b),
                                      jrs.gf_mul_np(a, b))
    assert [rs.gf_inv_np(x) for x in range(1, 256)] == \
        [jrs.gf_inv_np(x) for x in range(1, 256)]


@pytest.mark.parametrize("k,m", SCHEMES)
def test_matrices_equal_the_reference(k, m):
    np.testing.assert_array_equal(rs.rs_generator_matrix(k, m),
                                  jrs.rs_generator_matrix(k, m))
    full = rs.rs_full_matrix(k, m)
    np.testing.assert_array_equal(full, jrs.rs_full_matrix(k, m))
    use = list(range(m, m + k))  # the last k rows: parity-heavy
    np.testing.assert_array_equal(rs.gf_mat_inv_np(full[use]),
                                  jrs.gf_mat_inv_np(full[use]))
    assert rs.rs_decode_plan(k, m, use)[0] == jrs.rs_decode_plan(k, m,
                                                                 use)[0]


@pytest.mark.parametrize("kind", ["random", "zero-heavy"])
@pytest.mark.parametrize("k,m", SCHEMES)
def test_encode_equals_reference_and_oracle(k, m, kind):
    grid = _grid(k * 100 + m, k, kind)
    got = rs.rs_encode_device(torch.from_numpy(grid), m)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (m, PAGES,
                                                             rs._PAGE)
    got = got.numpy()
    want = rs.rs_encode_np(grid.reshape(k, -1), m).reshape(got.shape)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jrs.rs_encode_device(grid, m)))


@pytest.mark.parametrize("kind", ["random", "zero-heavy"])
@pytest.mark.parametrize("k,m", SCHEMES)
def test_gf_matmul_with_zero_coefficients(k, m, kind):
    """A coefficient matrix with zeros (whole zero rows and columns
    among them): a zero coefficient adds nothing, as the reference drops
    its term."""
    rng = np.random.default_rng(k * 7 + m)
    rows = rng.integers(0, 256, size=(m + 1, k), dtype=np.uint8)
    rows[rng.random(rows.shape) < 0.4] = 0
    rows[0] = 0
    rows[:, -1] = 0
    rows[1, 0] = 1
    grid = _grid(k + m, k, kind)
    got = rs.gf_matmul(rows, torch.from_numpy(grid)).numpy()
    flat = grid.reshape(k, -1)
    want = np.zeros((m + 1, flat.shape[1]), dtype=np.uint8)
    for i in range(m + 1):
        for j in range(k):
            want[i] ^= rs.gf_mul_np(rows[i, j], flat[j])
    np.testing.assert_array_equal(got.reshape(m + 1, -1), want)
    np.testing.assert_array_equal(
        got, np.asarray(jrs.gf_matmul_device(rows, grid)))
    assert not got[0].any()


LOSSES_4_2 = list(combinations(range(6), 2))


@pytest.mark.parametrize("lost", LOSSES_4_2,
                         ids=[f"lost{a}{b}" for a, b in LOSSES_4_2])
def test_reconstruct_every_two_loss_pattern(lost):
    k, m, L = 4, 2, 3 * rs._PAGE + 77
    rng = np.random.default_rng(sum(lost))
    data = rng.integers(0, 256, size=(k, L), dtype=np.uint8)
    stripe = np.concatenate([data, rs.rs_encode_np(data, m)])
    have = {i: stripe[i] for i in range(k + m) if i not in lost}
    got = rs.rs_reconstruct_device({i: s.tobytes() for i, s in have.items()},
                                   k, m, L, device="cpu")
    np.testing.assert_array_equal(rs.rs_reconstruct_np(have, k, m), data)
    assert got == [row.tobytes() for row in data]
    assert got == jrs.rs_reconstruct_device(
        {i: s.tobytes() for i, s in have.items()}, k, m, L)


def test_pack_host_and_errors():
    shards = [b"a" * 5000, b"b" * 5000]
    grid, L = rs.rs_pack_host(shards, pad_pages_to=4)
    jgrid, jL = jrs.rs_pack_host(shards, pad_pages_to=4)
    assert L == jL == 5000
    np.testing.assert_array_equal(grid, jgrid)
    with pytest.raises(ValueError, match="unequal"):
        rs.rs_pack_host([b"a", b"bb"])
    with pytest.raises(ValueError, match="no shards"):
        rs.rs_pack_host([])
    with pytest.raises(ValueError, match="invalid RS scheme"):
        rs.rs_generator_matrix(200, 100)
    with pytest.raises(ValueError, match="uint8 grid"):
        rs.gf_matmul(np.ones((1, 2), np.uint8),
                     torch.zeros((3, 1, rs._PAGE), dtype=torch.uint8))
    with pytest.raises(ValueError, match="shard length mismatch"):
        rs.rs_reconstruct_device({0: b"x" * 10, 1: b"y" * 10}, 2, 1, 11,
                                 device="cpu")


def test_calls_are_counted_across_threads():
    from concurrent.futures import ThreadPoolExecutor

    grid = torch.from_numpy(_grid(3, 4, "random"))
    before = rs.CALLS.n
    with ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(lambda _: rs.rs_encode_device(grid, 2),
                             range(8)))
    assert rs.CALLS.n - before == 8
    assert all(torch.equal(o, outs[0]) for o in outs)
