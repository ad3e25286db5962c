"""The port's fused segment pipeline (volsync_tpu_torch/ops/segment.py)
against the JAX package's ops/segment.py, on the CPU: packed results
element for element on random, redundant and zero-entropy data,
non-eof tails, forced small capacities (the overflow retry), batched
lanes and page-aligned spans, and under VOLSYNC_PAGEMAJOR=1 (the K4
page-major digest table); the FastCDC walk's twin against both forms of
the reference's walk."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsync_tpu.ops import segment as jseg
from volsync_tpu.ops.gearcdc import GearParams
from volsync_tpu.repo import blobid
from volsync_tpu_torch.engine.chunker import params_from_reference
from volsync_tpu_torch.ops import segment as tseg
from volsync_tpu_torch.ops import sha256 as tsha
from volsync_tpu_torch.ops.gearcdc import select_boundaries

# Parallel test workers share the cores: keep the CPU twins single-threaded.
torch.set_num_threads(1)

# The page-aligned fused format at test scale (tests/test_fused_segment.py).
PARAMS = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                    align=4096)
TPARAMS = params_from_reference(dataclasses.asdict(PARAMS))
P = 512 * 1024  # the bucket of a 400,000-byte segment


def _kw(eof, cand_cap, chunk_cap):
    p = PARAMS
    return dict(min_size=p.min_size, avg_size=p.avg_size,
                max_size=p.max_size, seed=p.seed, mask_s=p.mask_s,
                mask_l=p.mask_l, align=p.align, eof=eof, cand_cap=cand_cap,
                chunk_cap=chunk_cap)


def _both(data: np.ndarray, n: int, eof: bool, caps=None):
    cc, kc = caps or jseg.segment_caps(data.shape[0], PARAMS)
    ref = np.asarray(jseg.chunk_hash_segment(jnp.asarray(data), n,
                                             **_kw(eof, cc, kc)))
    got = tseg.chunk_hash_segment(torch.from_numpy(data), n,
                                  **_kw(eof, cc, kc))
    return ref, got.numpy().view(np.uint32), kc


def _padded(payload: bytes, size: int = P) -> np.ndarray:
    out = np.zeros((size,), np.uint8)
    out[: len(payload)] = np.frombuffer(payload, np.uint8)
    return out


def _redundant(rng) -> bytes:
    block = rng.bytes(131072)
    return block * 3 + rng.bytes(400_000 - 3 * 131072)


@pytest.mark.parametrize("kind", ["random", "redundant", "zero"])
def test_chunk_hash_segment_matches_reference(rng, kind):
    payload = {"random": lambda: rng.bytes(400_000),
               "redundant": lambda: _redundant(rng),
               "zero": lambda: bytes(400_000)}[kind]()
    data = _padded(payload)
    ref, got, kc = _both(data, len(payload), True)
    np.testing.assert_array_equal(got, ref)
    chunks, consumed, _, _ = tseg.decode_segment(got, kc)
    assert consumed == len(payload)
    assert [d for _, _, d in chunks] == [
        blobid.blob_id(payload[s:s + n]) for s, n, _ in chunks]
    assert all(n <= PARAMS.max_size for _, n, _ in chunks)
    if kind == "redundant":
        ids = [d for _, _, d in chunks]
        assert len(set(ids)) < len(ids)


def test_chunk_hash_segment_non_eof_tail(rng):
    payload = rng.bytes(300_000)
    ref, got, kc = _both(_padded(payload), len(payload), False)
    np.testing.assert_array_equal(got, ref)
    chunks, consumed, _, _ = tseg.decode_segment(got, kc)
    assert 0 < consumed < len(payload) and consumed % 4096 == 0


def test_chunk_hash_segment_forced_small_caps_and_retry(rng):
    """Truncated tables (chunk_cap 16 < the true count) pack the same
    words as the reference, and the host retry converges to the
    reference's chunk list."""
    data = np.frombuffer(rng.bytes(P), np.uint8).copy()
    ref, got, _ = _both(data, P, True, caps=(4096, 16))
    np.testing.assert_array_equal(got, ref)
    assert got[0] == 16 and got[1] < P  # truncated walk

    jf = jseg.FusedSegmentHasher(PARAMS)
    jdev = jnp.asarray(data)
    want = jf.finish(jdev, P, jf.dispatch(jdev, P, eof=True, cand_cap=4096,
                                          chunk_cap=16), eof=True)
    tf = tseg.FusedSegmentHasher(TPARAMS)
    tdev = torch.from_numpy(data)
    have = tf.finish(tdev, P, tf.dispatch(tdev, P, eof=True, cand_cap=4096,
                                          chunk_cap=16), eof=True)
    assert have == want and have[1] == P


def test_chunk_hash_segments_batched_matches_reference(rng):
    """Mixed lanes (full, eof tail, empty padding lane, zero data) in
    one batched pass == the JAX batched program, row for row; and each
    row == the single-segment program."""
    Pb = 128 * 1024
    rows = np.zeros((4, Pb), np.uint8)
    rows[0] = np.frombuffer(rng.bytes(Pb), np.uint8)
    rows[1, :90_000] = np.frombuffer(rng.bytes(90_000), np.uint8)
    valid = [Pb, 90_000, 0, 100_000]
    eof = [False, True, False, True]
    cc, kc = jseg.segment_caps(Pb, PARAMS)
    kw = _kw(True, cc, kc)
    del kw["eof"]
    ref = np.asarray(jseg.chunk_hash_segments(
        jnp.asarray(rows), jnp.asarray(valid, jnp.int32),
        jnp.asarray(eof), **kw))
    got = tseg.chunk_hash_segments(torch.from_numpy(rows), valid, eof,
                                   **kw).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, ref)
    single = tseg.chunk_hash_segment(torch.from_numpy(rows[1]), valid[1],
                                     **_kw(True, cc, kc))
    np.testing.assert_array_equal(single.numpy().view(np.uint32), got[1])


def test_batched_hasher_split_matches_reference(rng, monkeypatch):
    """A batch over the (shrunk) flat-bytes bound splits into the same
    sub-batches in both packages and gives the same chunks."""
    monkeypatch.setattr(jseg, "_MAX_FLAT_BYTES", 2 * 64 * 1024)
    monkeypatch.setattr(tseg, "_MAX_FLAT_BYTES", 2 * 64 * 1024)
    items = [(rng.bytes(n), n, True) for n in (40_000, 60_000, 20_000)]
    want = jseg.BatchedSegmentHasher(PARAMS).hash_segments(items)
    have = tseg.BatchedSegmentHasher(TPARAMS, device="cpu").hash_segments(
        items)
    assert have == want
    for (buf, _, _), (chunks, consumed) in zip(items, have):
        assert consumed == len(buf)
        assert [d for _, _, d in chunks] == [
            blobid.blob_id(buf[s:s + n]) for s, n, _ in chunks]


def test_span_roots_device_matches_reference(rng):
    sizes = [1, 4095, 4096, 4097, 12288, 50_000]
    starts, off = [], 0
    for n in sizes:
        starts.append(off)
        off += n + (-n % 4096)
    data = np.frombuffer(rng.bytes(128 * 1024), np.uint8).copy()
    st = np.array(starts + [0, 0], np.int32)
    ln = np.array(sizes + [-1, -1], np.int32)  # two padding lanes
    ref = np.asarray(jseg.span_roots_device(jnp.asarray(data),
                                            jnp.asarray(st), jnp.asarray(ln)))
    got = tseg.span_roots_device(torch.from_numpy(data),
                                 torch.from_numpy(st), torch.from_numpy(ln))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    for i, (s, n) in enumerate(zip(starts, sizes)):
        assert got.numpy().view(np.uint32)[i].astype(">u4").tobytes().hex() \
            == blobid.blob_id(data[s:s + n].tobytes())


def test_compact_candidates_matches_reference(rng):
    mask = rng.rand(3, 300) < 0.2
    ref = np.stack([np.asarray(jseg._compact_candidates(
        jnp.asarray(m), 64, 300, 4096)) for m in mask])
    got = tseg._compact_candidates(torch.from_numpy(mask), 64, 4096)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got.numpy()[:, -1] == 2**31 - 2).any()


def test_walk_tables_and_twin_match_scalar_reference(rng):
    """The successor-table walk (tables + fastcdc_walk's twin) on random
    candidate sets == the host walk, truncated at chunk_cap, with
    consumed == the end of the last emitted chunk."""
    p = TPARAMS
    cap, sent = 128, 2**31 - 2
    for trial in range(24):
        n_rows = int(rng.randint(1, 64))
        rows_l = np.nonzero(rng.rand(n_rows)
                            < rng.choice([0.0, 0.05, 0.3, 0.8]))[0]
        rows_s = rows_l[rng.rand(rows_l.shape[0]) < 0.4]
        L = [n_rows * 4096, int(rng.randint(1, n_rows * 4096 + 1)),
             max(1, n_rows * 4096 - int(rng.randint(0, 4096)))][trial % 3]
        idx_l = (rows_l * 4096 + 4095)
        idx_s = (rows_s * 4096 + 4095)
        idx_l, idx_s = idx_l[idx_l < L], idx_s[idx_s < L]
        eof = bool(rng.randint(0, 2))
        chunk_cap = int(rng.choice([2, 4, 256]))

        def padded(a):
            out = np.full((1, cap), sent, np.int64)
            out[0, : a.shape[0]] = a
            return torch.from_numpy(out)

        starts, lens, count, consumed = tseg._select_boundaries_device(
            padded(idx_s), torch.tensor([len(idx_s)]), padded(idx_l),
            torch.tensor([len(idx_l)]), torch.tensor([L]),
            torch.tensor([eof]), min_size=p.min_size, avg_size=p.avg_size,
            max_size=p.max_size, chunk_cap=chunk_cap, align=4096,
            n_rows=n_rows)
        c = int(count[0])
        got = [(int(starts[0, i]), int(lens[0, i])) for i in range(c)]
        ref = select_boundaries(idx_s, idx_l, L, p, eof=eof)
        assert got == ref[:chunk_cap], (trial, L, eof, chunk_cap)
        assert int(consumed[0]) == (got[-1][0] + got[-1][1] if got else 0)


#: The reference walk jitted once per (chunk_cap, form); eof stays a
#: traced per-lane scalar, as on the reference's batched path.
_JWALK = jax.jit(jseg._select_boundaries_device, static_argnames=(
    "min_size", "avg_size", "max_size", "chunk_cap", "align", "n_rows"))


def _walk_lanes(rng, trial: int, cap: int, n_rows: int):
    """One [3, cap] candidate batch on the 4096-byte grid, numpy: a lane
    with an unaligned length and 0, few or many candidates; a padding
    lane (valid_len 0); a dense lane whose true counts overflow cap
    (ns == nl == cap, no sentinel). eof alternates on lanes 0 and 2."""
    pos_s = np.full((3, cap), 2**31 - 2, np.int64)
    pos_l = pos_s.copy()
    ns, nl = np.zeros(3, np.int64), np.zeros(3, np.int64)
    L = np.array([n_rows * 4096 - int(rng.randint(1, 4096)), 0,
                  n_rows * 4096], np.int64)
    for k, density in enumerate([[0.0, 0.05, 0.3][trial % 3], 0.3, 1.0]):
        rows_l = np.nonzero(rng.rand(n_rows) < density)[0]
        rows_s = rows_l[rng.rand(rows_l.shape[0]) < (0.4 if k < 2 else 0.8)]
        for rows, pos, n in ((rows_s, pos_s, ns), (rows_l, pos_l, nl)):
            c = rows * 4096 + 4095
            c = c[c < L[k]]
            n[k] = min(c.shape[0], cap)
            pos[k, :n[k]] = c[:n[k]]
    eof = np.array([trial % 2 == 0, True, trial % 2 == 1])
    return pos_s, ns, pos_l, nl, L, eof


@pytest.mark.parametrize("chunk_cap", [2, 4, 256])
def test_fastcdc_walk_twin_matches_reference_both_forms(rng, chunk_cap):
    """fastcdc_walk's twin (successor tables + the table walk) on seeded
    [3, cap] lanes == the JAX walk lane by lane, in its generic
    per-iteration form (align=0, n_rows=0) and its table form: starts
    and lens (zero past count), count and consumed."""
    p = TPARAMS
    cap, n_rows = 16, 40
    sizes = dict(min_size=p.min_size, avg_size=p.avg_size,
                 max_size=p.max_size)
    for trial in range(4):
        lanes = _walk_lanes(rng, trial, cap, n_rows)
        pos_s, ns, pos_l, nl, L, eof = lanes
        assert ns[2] == nl[2] == cap
        got = tseg.fastcdc_walk(*(torch.from_numpy(x) for x in lanes),
                                chunk_cap=chunk_cap, align=4096, **sizes)
        got = [x.numpy() for x in got]
        assert got[2][1] == got[3][1] == 0  # the padding lane
        for k in range(3):
            for align, rows in ((0, 0), (4096, n_rows)):
                want = _JWALK(
                    jnp.asarray(pos_s[k], jnp.int32), jnp.int32(ns[k]),
                    jnp.asarray(pos_l[k], jnp.int32), jnp.int32(nl[k]),
                    jnp.int32(L[k]), chunk_cap=chunk_cap,
                    eof=jnp.bool_(eof[k]), align=align, n_rows=rows,
                    **sizes)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(
                        g[k], np.asarray(w), err_msg=f"{trial} {k} {align}")


def test_page_digests_and_decode(rng):
    data = np.frombuffer(rng.bytes(3 * 4096), np.uint8).copy()
    ref = jseg.page_digests(jnp.asarray(data))
    np.testing.assert_array_equal(tseg.page_digests(torch.from_numpy(data)),
                                  ref)
    cc, kc = tseg.segment_caps(65536, TPARAMS)
    assert (cc, kc) == jseg.segment_caps(65536, PARAMS)
    packed = np.zeros((4 + kc * 10,), np.uint32)
    packed[0], packed[1], packed[4 + kc] = 1, 123, 123
    chunks, consumed, _, _ = tseg.decode_segment(packed, kc)
    assert chunks[0][:2] == (0, 123) and consumed == 123
    assert tseg.decode_segment(torch.from_numpy(packed.view(np.int32)),
                               kc)[0] == chunks


def test_pagemajor_twin_and_word_index(rng):
    """K4's twin moves word j of page p from j*npp + p to p*8 + j, the
    two index functions of ``_word_index_fn``."""
    npp = 5
    x = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, size=(8, npp),
                                     dtype=np.int64).astype(np.int32))
    pm = tseg.pagemajor_u32(x)
    flat = x.reshape(-1)
    for j in range(8):
        for p in range(npp):
            assert pm[tseg._word_index_fn(npp, True)(j, p)] == \
                flat[tseg._word_index_fn(npp, False)(j, p)]
    np.testing.assert_array_equal(pm.numpy(), x.numpy().T.reshape(-1))


def _under_pagemajor(monkeypatch, run):
    """run() with VOLSYNC_PAGEMAJOR unset, then set. The reference reads
    the gate at trace time, so the JAX caches are cleared around the
    page-major run; the word-major run may reuse earlier traces."""
    import jax

    monkeypatch.delenv("VOLSYNC_PAGEMAJOR", raising=False)
    word = run()
    jax.clear_caches()
    monkeypatch.setenv("VOLSYNC_PAGEMAJOR", "1")
    try:
        page = run()
    finally:
        monkeypatch.delenv("VOLSYNC_PAGEMAJOR", raising=False)
        jax.clear_caches()
    return word, page


def test_chunk_hash_segment_pagemajor_matches_reference(rng, monkeypatch):
    payload = _redundant(rng)  # the shape the tests above compile
    data = _padded(payload)
    (ref_w, got_w, _), (ref_p, got_p, _) = _under_pagemajor(
        monkeypatch, lambda: _both(data, len(payload), True))
    np.testing.assert_array_equal(got_p, ref_p)
    np.testing.assert_array_equal(got_p, got_w)
    np.testing.assert_array_equal(ref_p, ref_w)


def test_page_digests_pagemajor_matches_reference(rng, monkeypatch):
    data = np.frombuffer(rng.bytes(5 * 4096), np.uint8).copy()
    word, page = _under_pagemajor(monkeypatch, lambda: (
        jseg.page_digests(jnp.asarray(data)),
        tseg.page_digests(torch.from_numpy(data))))
    for ref, got in (word, page):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(page[1], word[1])


def test_span_roots_device_pagemajor_matches_reference(rng, monkeypatch):
    sizes = [1, 4096, 9000]
    starts = [0, 4096, 8192]
    data = np.frombuffer(rng.bytes(64 * 1024), np.uint8).copy()
    st = np.array(starts + [0], np.int32)
    ln = np.array(sizes + [-1], np.int32)

    def run():
        ref = np.asarray(jseg.span_roots_device(
            jnp.asarray(data), jnp.asarray(st), jnp.asarray(ln)))
        got = tseg.span_roots_device(torch.from_numpy(data),
                                     torch.from_numpy(st),
                                     torch.from_numpy(ln))
        return ref, got.numpy().view(np.uint32)

    (ref_w, got_w), (ref_p, got_p) = _under_pagemajor(monkeypatch, run)
    np.testing.assert_array_equal(got_p, ref_p)
    np.testing.assert_array_equal(got_p[:3], got_w[:3])


def _root_case(rng, npp, lanes, live):
    """A seeded digest table of ``npp`` pages and a chunk table of
    (page0, nleaves, len) lanes, as numpy."""
    flat = rng.randint(0, 2**32, size=(8 * npp,), dtype=np.int64).astype(
        np.uint32)
    page0, nleaves, lens = (np.array(c, np.int64) for c in zip(*lanes))
    return flat, page0, nleaves, lens, np.array(live, bool)


def _roots_both(flat, npp, page0, nleaves, lens, live, pagemajor,
                nb_max=None, ref_live=None):
    """(reference, twin) digests of one chunk table. ``nb_max`` bounds
    the twin's blocks (default: the longest length's bound); the
    reference reads ``ref_live`` where given (its loop runs to the
    longest LIVE lane, which is how it bounds a lane)."""
    ref = np.asarray(jseg._root_digests_loop(
        jnp.asarray(flat), npp, jnp.asarray(page0, jnp.int32),
        jnp.asarray(nleaves, jnp.int32), jnp.asarray(lens, jnp.int32),
        jnp.asarray(live if ref_live is None else ref_live),
        word_index=jseg._word_index_fn(npp, pagemajor)))
    got = tseg._root_digests_plain(
        torch.from_numpy(flat.view(np.int32)), npp, torch.from_numpy(page0),
        torch.from_numpy(nleaves), torch.from_numpy(lens),
        torch.from_numpy(live),
        nb_max=nb_max or tseg._root_blocks_bound(int(lens.max())),
        pagemajor=pagemajor)
    return ref, got.numpy().view(np.uint32)


def _short_lanes(rng, n, npp, leaves=(1, 2, 3)):
    """``n`` seeded (page0, nleaves, len) lanes of a few leaves each."""
    out = []
    for _ in range(n):
        nl = int(rng.choice(leaves))
        out.append((int(rng.randint(0, npp - nl)), nl,
                    nl * 4096 - int(rng.randint(0, 4096))))
    return out


def _root_table(rng, kind):
    """(npp, lanes, live, nb_max, ref_live) of one root case; the
    kernel (csrc/merkle.cu) runs a lane of more than a quarter of the
    longest lane's blocks as one warp's chain, a shorter one (every
    lane of no leaves) one a thread, 32 to a warp, so the cases put
    both side by side."""
    if kind in ("mixed", "none"):
        lanes = [(3, 1, 100), (5, 2, 4097), (0, 0, 0),
                 (9, 7, 7 * 4096 - 5), (2, 0, 77)]
        live = [kind == "mixed" and n > 0 for _, n, _ in lanes]
        return 20, lanes, live, None, None
    if kind == "widths":
        # 0, 1, 2 leaves (1, 1, 2 blocks) beside 66 (34 blocks: a chain
        # that crosses its 32-block tile), then 36 more short lanes
        # (two groups of one-a-thread lanes)
        lanes = [(3, 0, 55), (5, 1, 100), (7, 2, 4097 + 3000),
                 (10, 66, 66 * 4096 - 11)] + _short_lanes(rng, 36, 80)
        return 80, lanes, [n > 0 for _, n, _ in lanes], None, None
    if kind == "clamp":
        # nb_max 12 cuts the 66-leaf lane (34 blocks) to 12: the
        # reference's loop stops there when its longest live lane has
        # 12 blocks (22 leaves; its steps of 4 blocks end there too), so
        # the cut lane is dead in its table
        lanes = [(0, 66, 66 * 4096), (70, 22, 22 * 4096 - 9), (1, 0, 3)]
        return 96, lanes, [True, True, False], 12, [False, True, False]
    if kind == "gaps":
        # a live mask that is not a prefix (the span form's empty and
        # padding lanes): dead lanes of no leaves between live ones
        lanes = []
        for i, (p0, nl, ln) in enumerate(_short_lanes(rng, 40, 90,
                                                       (1, 2, 5, 9, 33))):
            lanes.append((p0, nl, ln) if i % 3 else (0, 0, 0))
        return 90, lanes, [n > 0 for _, n, _ in lanes], None, None
    raise ValueError(kind)


@pytest.mark.parametrize("kind,pagemajor", [
    pytest.param("mixed", False, id="mixed-wm"),
    pytest.param("mixed", True, id="mixed-pm"),
    pytest.param("none", False, id="none-wm"),
    pytest.param("none", True, id="none-pm"),
    pytest.param("widths", False, id="widths-wm"),
    pytest.param("widths", True, id="widths-pm"),
    pytest.param("clamp", False, id="clamp-wm"),
    pytest.param("gaps", True, id="gaps-pm"),
])
def test_root_digests_plain_matches_reference(rng, kind, pagemajor):
    """merkle_roots' twin == the JAX root loop on a seeded table: lanes
    of 1, 2 and 7 leaves with lengths off the page grid, dead lanes
    (nleaves 0, any length), and a chunk table with no live lane (every
    lane stays at H0); then lanes of 0, 1, 2 and 66 leaves side by side
    with 36 more short ones, nb_max cutting a live lane, and a live mask
    that is not a prefix."""
    npp, lanes, live, nb_max, ref_live = _root_table(rng, kind)
    case = _root_case(rng, npp, lanes, live)
    ref, got = _roots_both(case[0], npp, *case[1:], pagemajor,
                           nb_max=nb_max, ref_live=ref_live)
    np.testing.assert_array_equal(got, ref)
    if kind == "none":
        np.testing.assert_array_equal(got, np.broadcast_to(tsha._H0,
                                                           got.shape))


def test_root_digests_plain_long_chain_matches_reference(rng):
    """A 2,048-leaf chunk (an 8 MiB blob: a 1,025-block root message)
    beside a dead lane, word-major, == the JAX root loop."""
    npp = 2056
    lanes = [(5, 2048, 8 << 20), (0, 0, 0)]
    case = _root_case(rng, npp, lanes, [True, False])
    ref, got = _roots_both(case[0], npp, *case[1:], False)
    np.testing.assert_array_equal(got, ref)
    assert tseg._root_blocks_bound(8 << 20) == 1025


def _ref_tail_table(flat, npp, data, ts, tl, page, has, pagemajor):
    """The reference's tail override: its sha256_chunks_device on the
    tail slices, then its _apply_tail_overrides, numpy in and out."""
    import volsync_tpu.ops.sha256 as jsha

    dig = jsha.sha256_chunks_device(jnp.asarray(data), jnp.asarray(ts),
                                    jnp.asarray(tl), max_len=4096)
    return np.asarray(jseg._apply_tail_overrides(
        jnp.asarray(flat), npp, jnp.asarray(page), dig, jnp.asarray(has),
        pagemajor=pagemajor))


@pytest.mark.parametrize("pagemajor", [False, True], ids=["wm", "pm"])
def test_tail_leaves_twin_chunk_tables_match_reference(rng, pagemajor):
    """The fused tail's twin (``tail_leaves_into`` on the CPU) on three
    lanes' chunk tables (a partial tail, no chunk, a tail on the page
    grid) == the reference's sha256_chunks_device + _apply_tail_overrides
    with the tails derived as its chunk_hash_segments derives them."""
    S, F, cap = 3, 4, 6
    data = rng.randint(0, 256, size=(S * F * 4096,), dtype=np.uint8)
    flat = rng.randint(0, 2**32, size=(8 * S * F,), dtype=np.int64).astype(
        np.uint32)
    starts = np.zeros((S, cap), np.int32)
    lens = np.zeros((S, cap), np.int32)
    starts[0, :2], lens[0, :2] = [0, 4096], [4096, 6000]
    starts[2, :2], lens[2, :2] = [0, 4096], [4096, 8192]
    count = np.array([2, 0, 2], np.int32)
    got = tseg.tail_leaves_into(
        torch.from_numpy(flat.view(np.int32)), S * F, torch.from_numpy(data),
        torch.from_numpy(starts), torch.from_numpy(lens),
        torch.from_numpy(count), lane_pages=F, pagemajor=pagemajor)
    last = np.maximum(count - 1, 0)
    end = np.where(count > 0, starts[np.arange(S), last]
                   + lens[np.arange(S), last], 0)
    has = (count > 0) & (end % 4096 != 0)
    local = np.maximum(end - 1, 0) // 4096
    page = (np.arange(S) * F + local).astype(np.int32)
    tl = np.where(has, end - local * 4096, 0).astype(np.int32)
    ts = np.clip(page * 4096, 0, data.shape[0] - 1).astype(np.int32)
    ref = _ref_tail_table(flat, S * F, data, ts, tl, page, has, pagemajor)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    assert (ref != flat).sum() == 8  # one lane has a partial tail


@pytest.mark.parametrize("pagemajor", [False, True], ids=["wm", "pm"])
def test_tail_leaves_twin_spans_match_reference(rng, pagemajor):
    """The span tails' twin on page-aligned spans (tails of 1 to 4,095
    bytes, a whole-page span, a padding lane) == the reference's
    override as its span_roots_device derives it."""
    P = 16 * 4096
    data = rng.randint(0, 256, size=(P,), dtype=np.uint8)
    flat = rng.randint(0, 2**32, size=(8 * 16,), dtype=np.int64).astype(
        np.uint32)
    starts = np.array([0, 8192, 20480, 0, 45056], np.int64)
    lens = np.array([1, 4096, 9000, -1, 4095], np.int64)
    got = tseg.tail_leaves_into(
        torch.from_numpy(flat.view(np.int32)), 16, torch.from_numpy(data),
        torch.from_numpy(starts), torch.from_numpy(lens),
        pagemajor=pagemajor)
    lens_c = np.maximum(lens, 0)
    end = starts + lens_c
    has = (lens > 0) & (lens_c % 4096 != 0)
    page = (np.maximum(end - 1, 0) // 4096).astype(np.int32)
    tl = np.where(has, end - page * 4096, 0).astype(np.int32)
    ts = np.clip(page * 4096, 0, P - 1).astype(np.int32)
    ref = _ref_tail_table(flat, 16, data, ts, tl, page, has, pagemajor)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    assert (ref != flat).sum() == 24


def test_page_digests_flat_pagemajor_matches_reference(rng):
    """One K1 pass with the page-major store (its CPU twin) == the
    reference's page-major table, K1 then its _pallas_pagemajor (CPU
    path), word for word."""
    F = 6
    data = rng.randint(0, 256, size=(F * 4096,), dtype=np.uint8)
    ref = np.asarray(jseg._page_digests_flat(jnp.asarray(data), F,
                                             pagemajor=True))
    got = tseg._page_digests_flat(torch.from_numpy(data), F, True)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
