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
