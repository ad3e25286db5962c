"""The port's chunking parameters and gear hash
(volsync_tpu_torch/ops/gearcdc.py) against the JAX package, on the
CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsync_tpu.engine.chunker import params_from_config as jparams_cfg
from volsync_tpu.ops import gearcdc as jg
from volsync_tpu_torch.engine.chunker import (
    params_from_config,
    params_from_reference,
)
from volsync_tpu_torch.ops import gearcdc as tg

# Parallel test workers share the cores: keep the CPU twins single-threaded.
torch.set_num_threads(1)

PARAM_SETS = [
    dict(),
    dict(align=4096),
    dict(min_size=4096, avg_size=32768, max_size=65536, align=4096),
    dict(min_size=256, avg_size=1024, max_size=4096, seed=7),
]


@pytest.mark.parametrize("kw", PARAM_SETS)
def test_params_masks_and_table_match_reference(kw):
    j = jg.GearParams(**kw)
    t = tg.GearParams(**kw)
    for attr in ("bits", "eff_bits", "mask_s", "mask_l", "dense_mask_s",
                 "dense_mask_l"):
        assert getattr(t, attr) == getattr(j, attr), attr
    np.testing.assert_array_equal(t.table, j.table)
    assert t.table.dtype == np.uint32


def test_default_params_match_reference():
    assert dataclasses.asdict(tg.DEFAULT_PARAMS) == \
        dataclasses.asdict(jg.DEFAULT_PARAMS)


@pytest.mark.parametrize("kw", PARAM_SETS)
def test_params_from_reference_round_trip(kw):
    j = jg.GearParams(**kw)
    t = params_from_reference(dataclasses.asdict(j))
    assert isinstance(t, tg.GearParams)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t == tg.GearParams(**kw)
    with pytest.raises(ValueError):
        params_from_reference({**dataclasses.asdict(j), "extra": 1})


def test_params_from_config_matches_reference():
    for cfg in ({"min_size": 4096, "avg_size": 32768, "max_size": 65536,
                 "seed": 3, "align": 4096},
                {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
                 "seed": 3}):
        assert dataclasses.asdict(params_from_config(cfg)) == \
            dataclasses.asdict(jparams_cfg(cfg))


def test_invalid_params_raise():
    with pytest.raises(ValueError):
        tg.GearParams(avg_size=3 * 1024 * 1024)
    with pytest.raises(ValueError):
        tg.GearParams(min_size=4096 + 64, avg_size=32768, max_size=65536,
                      align=4096)


def test_mix_u32_matches_reference(rng):
    x = rng.randint(0, 2**32, size=(1000,), dtype=np.uint64).astype(
        np.uint32)
    ref = np.asarray(jg._mix_u32(jnp.asarray(x)))
    got = tg._mix_u32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), ref)
    assert got.max() < 2**32 and got.min() >= 0


@pytest.mark.parametrize("align", [64, 4096])
def test_gear_at_aligned_matches_reference(rng, align):
    data = rng.randint(0, 256, size=(64 * 1024,), dtype=np.uint8)
    seed = 0x5EEDCDC1
    ref = np.asarray(jg.gear_at_aligned(jnp.asarray(data), seed, align))
    got = tg.gear_at_aligned(torch.from_numpy(data), seed, align).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), ref)


def test_host_candidates_match_reference(rng):
    p = jg.GearParams(min_size=4096, avg_size=32768, max_size=65536,
                      align=4096)
    tp = params_from_reference(dataclasses.asdict(p))
    data = rng.randint(0, 256, size=(2 << 20,), dtype=np.uint8)
    length = len(data) - 5000
    pos, flags, count = jg.cdc_candidates_aligned(
        jnp.asarray(data), seed=p.seed, mask_s=p.mask_s, mask_l=p.mask_l,
        align=p.align, max_candidates=4096, valid_len=length)
    c = int(count)
    pos = np.asarray(pos)[:c]
    flags = np.asarray(flags)[:c]
    idx_s, idx_l = tg.host_candidates(data, tp, length)
    np.testing.assert_array_equal(idx_l, pos)
    np.testing.assert_array_equal(idx_s, pos[flags])
    assert len(idx_l) > len(idx_s) > 0
    s2, l2 = tg.host_candidates(data, tp, length, base=1 << 30)
    np.testing.assert_array_equal(l2, idx_l + (1 << 30))


def test_select_boundaries_matches_reference(rng):
    p = jg.GearParams(min_size=4096, avg_size=32768, max_size=65536,
                      align=4096)
    tp = params_from_reference(dataclasses.asdict(p))
    for trial in range(30):
        n_rows = int(rng.randint(1, 80))
        rows_l = np.nonzero(rng.rand(n_rows) < rng.choice([0.0, 0.1, 0.5]))[0]
        rows_s = rows_l[rng.rand(rows_l.shape[0]) < 0.4]
        idx_l = rows_l * 4096 + 4095
        idx_s = rows_s * 4096 + 4095
        L = int(rng.randint(1, n_rows * 4096 + 1))
        eof = bool(trial % 2)
        base = int(rng.randint(0, 1 << 20))
        assert tg.select_boundaries(idx_s, idx_l, L, tp, eof=eof,
                                    base=base) == \
            jg._select_boundaries_py(idx_s, idx_l, L, p, eof=eof, base=base)


# The split-phase params at test scale, and the reference's own.
P64 = jg.GearParams(min_size=4096, avg_size=32768, max_size=65536, align=64)
P64_REF = jg.GearParams(min_size=256, avg_size=1024, max_size=4096)
P1 = jg.GearParams(min_size=256, avg_size=1024, max_size=4096, align=1)


def _kw(p, **extra):
    return dict(seed=p.seed, mask_s=p.mask_s, mask_l=p.mask_l, **extra)


@pytest.mark.parametrize("p,cap,valid_len", [
    (P64, 4096, None), (P64, 4096, 700_001), (P64_REF, 64, 1 << 20),
    (P64_REF, 4096, 123_457)],
    ids=["roomy", "valid_len", "count-over-cap", "ref-params"])
def test_cdc_candidates_aligned_packed_matches_reference(rng, p, cap,
                                                         valid_len):
    """The packed [2*cap + 1] array is bit-identical: fill slots hold
    R*align + align-1 with flag 0, and the count is the true lax count
    even when it exceeds cap."""
    data = rng.randint(0, 256, size=(1 << 20,), dtype=np.uint8)
    ref = np.asarray(jg.cdc_candidates_aligned_packed(
        jnp.asarray(data), **_kw(p, align=p.align, max_candidates=cap,
                                 valid_len=valid_len)))
    got = tg.cdc_candidates_aligned_packed(
        torch.from_numpy(data), **_kw(p, align=p.align, max_candidates=cap,
                                      valid_len=valid_len))
    assert got.dtype == torch.int32 and got.shape == (2 * cap + 1,)
    np.testing.assert_array_equal(got.numpy(), ref)
    if cap == 64:
        assert ref[-1] > cap
    else:
        assert (ref[:cap] == (1 << 20) + 63).any()  # fill slots


@pytest.mark.parametrize("n", [16, 33, 40_000])
def test_gear_hash_positions_matches_reference(rng, n):
    data = rng.randint(0, 256, size=(n,), dtype=np.uint8)
    ref = np.asarray(jg.gear_hash_positions(jnp.asarray(data), 0x5EEDCDC1))
    got = tg.gear_hash_positions(torch.from_numpy(data), 0x5EEDCDC1)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)


def test_gear_hash_positions_short_buffers(rng):
    """Below 16 bytes (where the reference's padding cannot broadcast)
    position i is sum_{k<=i} G[b_{i-k}] << k mod 2**32."""
    table = tg._make_gear_table(7).astype(np.uint64)
    for n in (1, 5, 15):
        data = rng.randint(0, 256, size=(n,), dtype=np.uint8)
        want = [sum(int(table[data[i - k]]) << k for k in range(i + 1))
                & 0xFFFFFFFF for i in range(n)]
        assert tg.gear_hash_positions(torch.from_numpy(data),
                                      7).tolist() == want


@pytest.mark.parametrize("cap,valid_len", [(512, None), (8, 30_000)],
                         ids=["roomy", "truncated"])
def test_cdc_candidates_matches_reference(rng, cap, valid_len):
    data = rng.randint(0, 256, size=(40_000,), dtype=np.uint8)
    ref = jg.cdc_candidates(jnp.asarray(data), **_kw(
        P1, max_candidates=cap, valid_len=valid_len))
    got = tg.cdc_candidates(torch.from_numpy(data), **_kw(
        P1, max_candidates=cap, valid_len=valid_len))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if cap == 8:
        assert int(ref[3]) > cap


def test_nonzero_fixed_batched_rows(rng):
    mask = rng.rand(3, 50) < 0.3
    got = tg.nonzero_fixed(torch.from_numpy(mask), 8, 50).numpy()
    for row, m in zip(got, mask):
        idx = np.nonzero(m)[0][:8]
        np.testing.assert_array_equal(row[: len(idx)], idx)
        assert (row[len(idx):] == 50).all()


@pytest.mark.parametrize("p,eof", [(P64, True), (P64_REF, False),
                                   (P1, True), (P1, False),
                                   (jg.GearParams(min_size=4096,
                                                  avg_size=32768,
                                                  max_size=65536,
                                                  align=4096), True)],
                         ids=["align64", "align64-ref-tail", "align1",
                              "align1-tail", "align4096"])
def test_chunk_buffer_matches_reference(rng, p, eof):
    data = rng.bytes(200_003)
    want = jg.chunk_buffer(data, p, eof=eof)
    assert tg.chunk_buffer(data, params_from_reference(
        dataclasses.asdict(p)), eof=eof, device="cpu") == want
    assert tg.chunk_buffer(torch.from_numpy(np.frombuffer(
        data, np.uint8).copy()), params_from_reference(
        dataclasses.asdict(p)), eof=eof, device="cpu") == want
    assert tg.chunk_buffer(b"", p, device="cpu") == []


def test_fetch_candidates_retries_past_the_first_capacity(rng):
    """Dense candidates (the reference's split-phase params give ~1 lax
    candidate per 4 aligned rows) overflow the first 4096 slots; the
    retry returns exactly the numpy oracle's positions."""
    tp = params_from_reference(dataclasses.asdict(P64_REF))
    data = rng.randint(0, 256, size=(2 << 20,), dtype=np.uint8)
    length = len(data) - 1000
    idx_s, idx_l = tg.fetch_candidates(torch.from_numpy(data), tp, length)
    want_s, want_l = tg.host_candidates(data, tp, length)
    assert len(idx_l) > 4096
    np.testing.assert_array_equal(idx_l, want_l)
    np.testing.assert_array_equal(idx_s, want_s)
