"""The port's CUDA kernels against their plain PyTorch twins on a card,
and the engines (fused, split-phase, legacy, page-major) on the card
against the CPU.

Needs an NVIDIA card with nvcc (the kernels build from
volsync_tpu_torch/csrc at first use); skipped elsewhere. Imports no JAX,
so it runs where JAX is absent: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (``tests/conftest.py`` imports JAX).
"""

import numpy as np
import pytest
import torch

from volsync_tpu_torch.ops import segment as seg
from volsync_tpu_torch.ops import sha256 as sha
from volsync_tpu_torch.ops.gearcdc import GearParams

pytestmark = pytest.mark.cuda

PARAMS = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                    align=4096)


@pytest.fixture
def rng():
    return np.random.RandomState(1234)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _rand_i32(rng, shape, device):
    return torch.from_numpy(
        rng.randint(-2**31, 2**31 - 1, size=shape).astype(np.int32)).to(device)


@pytest.mark.parametrize("shape", [(8192, 1024), (1000, 77), (1, 33)])
def test_transpose_kernel_equals_twin(cuda, rng, shape):
    x = _rand_i32(rng, shape, cuda)
    assert torch.equal(seg.transpose_u32(x), seg._transpose_plain(x))


def _pages(rng, F, device):
    return torch.from_numpy(np.frombuffer(rng.bytes(F * 4096), np.uint8)
                            .copy()).to(device)


def test_sha256_pages_kernel_equals_twin(cuda, rng):
    data = _pages(rng, 100, cuda)
    assert torch.equal(sha.sha256_pages(data, 128),
                       sha._sha256_pages_plain(data, 128))


def test_sha256_lanes_kernel_equals_twin(cuda, rng):
    blocks = _rand_i32(rng, (40, 9, 16), cuda)
    nblocks = torch.from_numpy(rng.randint(-1, 11, size=(40,)).astype(
        np.int32)).to(cuda)
    assert torch.equal(sha.sha256_blocks(blocks, nblocks),
                       sha._sha256_lanes_plain(blocks, nblocks))


def test_segment_on_card_equals_cpu(cuda, rng):
    """The whole fused segment (every kernel, with the card's page
    padding) packs the same words as the CPU twins."""
    data = np.zeros((512 * 1024,), np.uint8)
    data[:400_000] = np.frombuffer(rng.bytes(400_000), np.uint8)
    cc, kc = seg.segment_caps(data.shape[0], PARAMS)
    p = PARAMS
    kw = dict(min_size=p.min_size, avg_size=p.avg_size,
              max_size=p.max_size, seed=p.seed, mask_s=p.mask_s,
              mask_l=p.mask_l, align=p.align, eof=True, cand_cap=cc,
              chunk_cap=kc)
    host = torch.from_numpy(data)
    want = seg.chunk_hash_segment(host, 400_000, **kw)
    got = seg.chunk_hash_segment(host.to(cuda), 400_000, **kw)
    assert torch.equal(got.cpu(), want)


def test_batched_segments_on_card_equal_cpu(cuda, rng):
    """The batched pass (several lanes, one K1 batch, one root launch)
    packs the same rows on the card as on the CPU."""
    P = 128 * 1024
    rows = np.zeros((4, P), np.uint8)
    rows[0] = np.frombuffer(rng.bytes(P), np.uint8)
    rows[1, :90_000] = np.frombuffer(rng.bytes(90_000), np.uint8)
    valid, eof = [P, 90_000, 0, 100_000], [False, True, False, True]
    cc, kc = seg.segment_caps(P, PARAMS)
    p = PARAMS
    kw = dict(min_size=p.min_size, avg_size=p.avg_size,
              max_size=p.max_size, seed=p.seed, mask_s=p.mask_s,
              mask_l=p.mask_l, align=p.align, cand_cap=cc, chunk_cap=kc)
    host = torch.from_numpy(rows)
    want = seg.chunk_hash_segments(host, valid, eof, **kw)
    got = seg.chunk_hash_segments(host.to(cuda), valid, eof, **kw)
    assert torch.equal(got.cpu(), want)


def test_hash_file_streaming_on_card(cuda, rng, tmp_path):
    from volsync_tpu_torch.engine import hash_file_streaming
    from volsync_tpu_torch.repo import blobid

    for n in (5, 4096, 300_000 + 17):
        f = tmp_path / f"f{n}"
        data = rng.bytes(n)
        f.write_bytes(data)
        assert hash_file_streaming(f, segment_size=128 * 1024) == \
            blobid.blob_id(data)


@pytest.mark.parametrize("leaf_len", [64, 4096, 8192])
def test_sha256_rows_kernel_equals_twin_and_hashlib(cuda, rng, leaf_len):
    """K2 at one, 64 and 128 blocks a leaf: 301 lanes (not a multiple of
    the 64-lane block) at rows off the page grid, the last leaf that
    fits and the row before it, equal to the twin and hashlib."""
    import hashlib

    data = np.frombuffer(rng.bytes(256 * 1024), np.uint8).copy()
    n_rows = data.shape[0] // 64
    last = n_rows - leaf_len // 64
    rows0 = np.concatenate([[0, last, last - 1, 5, 5],
                            rng.randint(0, last + 1, size=296)]
                           ).astype(np.int32)
    d, r = torch.from_numpy(data).to(cuda), torch.from_numpy(rows0).to(cuda)
    got = sha.sha256_rows(d, r, leaf_len=leaf_len)
    assert torch.equal(got, sha._sha256_rows(sha.pack_words(d), r, leaf_len))
    dig = got.cpu().numpy().view(np.uint32).astype(">u4")
    for b, row in enumerate(rows0):
        assert dig[b].tobytes() == hashlib.sha256(
            data[64 * row: 64 * row + leaf_len]).digest()


def test_sha256_rows_raises_on_what_the_kernel_does_not_take(cuda):
    d = torch.zeros(64 * 1024 + 16, dtype=torch.uint8, device=cuda)
    rows = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        sha.sha256_rows(d[1:65 * 1024 - 1023], rows)  # not 16-byte aligned
    with pytest.raises(ValueError):
        sha.sha256_rows(d[:64 * 1024], rows.to(torch.int64))
    with pytest.raises(ValueError):
        sha.sha256_rows(d[:2048], rows)  # shorter than a leaf


@pytest.mark.parametrize("npp", [64, 77, 12288])
def test_pagemajor_kernel_equals_twin(cuda, rng, npp):
    x = _rand_i32(rng, (8, npp), cuda)
    assert torch.equal(seg.pagemajor_u32(x), seg._pagemajor_plain(x))


@pytest.mark.parametrize("threads", [32, 64, 128, 256])
def test_sha256_pages_launch_sizes_equal_twin(cuda, rng, threads):
    """K1 at every sweep size (its largest block, 256 threads), npp past
    the buffer on a ragged grid: the twin's digests, hashlib's per page,
    a zero page's past the buffer."""
    import hashlib

    F, npp = 200, 333
    data = _pages(rng, F, cuda)
    got = sha.sha256_pages(data, npp, threads=threads)
    assert torch.equal(got, sha._sha256_pages_plain(data, npp))
    host = data.cpu().numpy()
    tab = got.cpu().numpy().view(np.uint32).reshape(8, npp)
    for p in range(npp):
        want = host[p * 4096:(p + 1) * 4096] if p < F else bytes(4096)
        assert tab[:, p].astype(">u4").tobytes() == \
            hashlib.sha256(want).digest()
    for bad in (48, 288, 1024):
        with pytest.raises(ValueError):
            sha.sha256_pages(data, npp, threads=bad)
    with pytest.raises(ValueError):
        sha.sha256_pages(data[:4000], 1)  # not whole pages
    with pytest.raises(ValueError):
        sha.sha256_pages(torch.zeros(8192 + 4, dtype=torch.uint8,
                                     device=cuda)[4:], 2)  # misaligned


@pytest.mark.parametrize("pagemajor", [False, True], ids=["wm", "pm"])
def test_merkle_roots_zero_segment_equals_twin(cuda, pagemajor,
                                               monkeypatch):
    """merkle_roots on a zero-entropy segment of four 8 MiB chunks
    (1,025-block root messages, 124 dead lanes) == its twin on the card,
    and the fused segment's ids == blob_id of 8 MiB of zeros."""
    from volsync_tpu_torch.ops.gearcdc import DEFAULT_PARAMS
    from volsync_tpu_torch.repo import blobid

    P = 32 << 20
    data = torch.zeros(P, dtype=torch.uint8, device=cuda)
    npp = P // 4096
    flat = seg._page_digests_flat(data, npp, pagemajor)
    C = 128
    i64 = dict(dtype=torch.int64, device=cuda)
    live = torch.arange(C, device=cuda) < 4
    page0 = torch.where(live, torch.arange(C, **i64) * 2048, 0)
    nleaves = torch.where(live, 2048, 0).to(torch.int64)
    lens = torch.where(live, 8 << 20, 0).to(torch.int64)
    args = (flat, npp, page0, nleaves, lens, live)
    kw = dict(nb_max=seg._root_blocks_bound(8 << 20), pagemajor=pagemajor)
    launched = seg.MERKLE_ROOTS.launches
    got = seg._root_digests_loop(*args, **kw)
    assert seg.MERKLE_ROOTS.launches == launched + 1
    assert torch.equal(got, seg._root_digests_plain(*args, **kw))

    if pagemajor:
        monkeypatch.setenv("VOLSYNC_PAGEMAJOR", "1")
    p = DEFAULT_PARAMS
    cc, kc = seg.segment_caps(P, p)
    packed = seg.chunk_hash_segment(
        data, P, min_size=p.min_size, avg_size=p.avg_size,
        max_size=p.max_size, seed=p.seed, mask_s=p.mask_s, mask_l=p.mask_l,
        align=p.align, eof=True, cand_cap=cc, chunk_cap=kc)
    chunks, consumed, _, _ = seg.decode_segment(packed, kc)
    assert consumed == P and len(chunks) == 4
    assert {h for _, _, h in chunks} == {blobid.blob_id(bytes(8 << 20))}


@pytest.mark.parametrize("align", [64, 1])
def test_split_and_legacy_engines_on_card_equal_cpu(cuda, rng, align):
    """The align=64 engine (K2 + tail lanes) and the align=1 engine (a
    lane per leaf) give the CPU's chunks and ids, eof and not."""
    from volsync_tpu_torch.engine import DeviceChunkHasher

    p = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                   align=align)
    buf = rng.bytes(300_000) + bytes(70_000) + rng.bytes(33_333)
    for eof in (True, False):
        want = DeviceChunkHasher(p, device="cpu").process(buf, eof=eof)
        got = DeviceChunkHasher(p, device=cuda).process(buf, eof=eof)
        assert got == want and want


def test_pagemajor_segment_on_card_equals_word_major(cuda, rng,
                                                     monkeypatch):
    data = np.zeros((512 * 1024,), np.uint8)
    data[:400_000] = np.frombuffer(rng.bytes(400_000), np.uint8)
    cc, kc = seg.segment_caps(data.shape[0], PARAMS)
    p = PARAMS
    kw = dict(min_size=p.min_size, avg_size=p.avg_size,
              max_size=p.max_size, seed=p.seed, mask_s=p.mask_s,
              mask_l=p.mask_l, align=p.align, eof=True, cand_cap=cc,
              chunk_cap=kc)
    dev = torch.from_numpy(data).to(cuda)
    monkeypatch.delenv("VOLSYNC_PAGEMAJOR", raising=False)
    word = seg.chunk_hash_segment(dev, 400_000, **kw)
    pages = seg.page_digests(dev)
    monkeypatch.setenv("VOLSYNC_PAGEMAJOR", "1")
    launched = seg.PAGEMAJOR_U32.launches, sha.SHA256_PAGES.launches
    assert torch.equal(seg.chunk_hash_segment(dev, 400_000, **kw), word)
    np.testing.assert_array_equal(seg.page_digests(dev), pages)
    # K1 stores page-major itself: two K1 launches and no K4.
    assert (seg.PAGEMAJOR_U32.launches, sha.SHA256_PAGES.launches) == (
        launched[0], launched[1] + 2)


def _walk_inputs(rng, S, n_rows, cap, density):
    """Candidate lists of S lanes on the 4096-byte grid, numpy: lax rows
    at ``density``, strict rows a 40% subset, each list sorted, cut at
    cap and padded with the sentinel; lane 0 spans every row, the others
    end anywhere in the last row; eof on even lanes."""
    pos_s = np.full((S, cap), 2**31 - 2, np.int64)
    pos_l = pos_s.copy()
    ns, nl = np.zeros(S, np.int64), np.zeros(S, np.int64)
    L = n_rows * 4096 - rng.randint(0, 4096, size=S).astype(np.int64)
    L[0] = n_rows * 4096
    for k in range(S):
        rows_l = np.nonzero(rng.rand(n_rows) < density)[0]
        rows_s = rows_l[rng.rand(rows_l.shape[0]) < 0.4]
        for rows, pos, n in ((rows_s, pos_s, ns), (rows_l, pos_l, nl)):
            c = rows * 4096 + 4095
            c = c[c < L[k]]
            n[k] = min(c.shape[0], cap)
            pos[k, :n[k]] = c[:n[k]]
    return pos_s, ns, pos_l, nl, L, np.arange(S) % 2 == 0


@pytest.mark.parametrize("S,density", [(1, 0.02), (5, 0.02), (1, 0.0),
                                       (5, 1.0)],
                         ids=["random1", "random5", "zero", "dense"])
def test_fastcdc_walk_kernel_equals_twin(cuda, rng, S, density):
    """The walk kernel on 48 MiB lanes (12,288 rows, 4,096-entry lists)
    at the default sizes == its twin on the CPU, at the segment's
    chunk_cap and at 4 (truncated walks, zero-filled tails): random
    lanes, an all-zero segment (no candidates: max-size cuts) and a
    dense one whose lists overflow (ns == cap). One launch a call."""
    from volsync_tpu_torch.ops.gearcdc import DEFAULT_PARAMS as p

    n_rows, cap = 12288, 4096
    host = [torch.from_numpy(x) for x in _walk_inputs(rng, S, n_rows, cap,
                                                      density)]
    dev = [x.to(cuda) for x in host]
    for chunk_cap in (seg.segment_caps(n_rows * 4096, p)[1], 4):
        kw = dict(min_size=p.min_size, avg_size=p.avg_size,
                  max_size=p.max_size, chunk_cap=chunk_cap, align=p.align)
        launched = seg.FASTCDC_WALK.launches
        got = seg.fastcdc_walk(*dev, **kw)
        assert seg.FASTCDC_WALK.launches == launched + 1
        want = seg.fastcdc_walk(*host, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        assert int(want[2][0]) > 0


def test_fastcdc_walk_raises_on_what_the_kernel_does_not_take(cuda):
    def z(*shape, dtype=torch.int64, device=cuda):
        return torch.zeros(shape, dtype=dtype, device=device)

    good = [z(2, 64), z(2), z(2, 64), z(2), z(2), z(2, dtype=torch.bool)]
    kw = dict(min_size=4096, avg_size=32768, max_size=65536, chunk_cap=8,
              align=4096)
    assert int(seg.fastcdc_walk(*good, **kw)[2].sum()) == 0
    for i, bad in ((0, z(2, 64, dtype=torch.int32)), (0, z(128)),
                   (1, z(3)), (2, z(3, 64)), (4, z(2, dtype=torch.int32)),
                   (5, z(2)), (3, z(2, device="cpu")),
                   (2, z(2, 128)[:, ::2])):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            seg.fastcdc_walk(*args, **kw)


def test_walk_stage_on_card_is_one_kernel_launch(cuda, rng, monkeypatch):
    """On CUDA ``_select_boundaries_device`` launches one fastcdc_walk and
    builds no successor tables (no searchsorted)."""
    def table_path(*args, **kwargs):
        raise AssertionError("the table path ran on CUDA")

    dev = [torch.from_numpy(x).to(cuda)
           for x in _walk_inputs(rng, 3, 64, 64, 0.3)]
    monkeypatch.setattr(torch, "searchsorted", table_path)
    monkeypatch.setattr(seg, "_walk_tables", table_path)
    launched = seg.FASTCDC_WALK.launches
    count = seg._select_boundaries_device(
        *dev, min_size=PARAMS.min_size, avg_size=PARAMS.avg_size,
        max_size=PARAMS.max_size, chunk_cap=16, align=4096, n_rows=64)[2]
    assert seg.FASTCDC_WALK.launches == launched + 1
    assert int(count.min()) > 0


EDGE_LENGTHS = [0, 1, 55, 56, 63, 64, 119, 120, 4095, 4096]


def _slice_case(rng, L):
    """Slices at offsets 0..15 of every edge length, one ending on the
    buffer's last byte, one running past it, one wholly past it and one
    longer than max_len (starts, lengths: int32 numpy)."""
    starts = [off * 2049 for off in range(16) for _ in EDGE_LENGTHS]
    lengths = EDGE_LENGTHS * 16
    starts += [L - 100, L - 10, L + 5, 7]
    lengths += [100, 4096, 50, 4150]
    return np.array(starts, np.int32), np.array(lengths, np.int32)


def test_sha256_slices_kernel_equals_twin_and_hashlib(cuda, rng):
    """sha256_chunks_device on the card (one sha256_slices launch) ==
    its twin at offsets 0..15 and the padding edge lengths, at the
    buffer's end and past it, for int32 and int64 lanes; == hashlib on
    every slice inside the buffer."""
    import hashlib

    host = np.frombuffer(rng.bytes(40_000), np.uint8).copy()
    L = host.shape[0]
    starts, lengths = _slice_case(rng, L)
    data = torch.from_numpy(host).to(cuda)
    s = torch.from_numpy(starts).to(cuda)
    n = torch.from_numpy(lengths).to(cuda)
    launched = sha.SHA256_SLICES.launches
    got = sha.sha256_chunks_device(data, s, n, max_len=4096)
    assert sha.SHA256_SLICES.launches == launched + 1
    want = sha._sha256_chunks_plain(data, s, n, max_len=4096)
    assert torch.equal(got, want)
    assert torch.equal(sha.sha256_chunks_device(
        data, s.to(torch.int64), n.to(torch.int64), max_len=4096), got)
    dig = got.cpu().numpy().view(np.uint32).astype(">u4")
    for i, (a, k) in enumerate(zip(starts, lengths)):
        if a + k <= L and k <= 4096:
            assert dig[i].tobytes() == hashlib.sha256(host[a:a + k]).digest()


def test_sha256_slices_every_end_in_a_block(cuda, rng):
    """Every message length of 1 to 130 bytes at every offset 0..15: the
    message ends at each byte of its last block, which the kernel builds
    from the ring's words with masks; == hashlib and the twin."""
    import hashlib

    host = np.frombuffer(rng.bytes(16 * 4096), np.uint8).copy()
    starts = np.array([off * 4096 + off for off in range(16)
                       for _ in range(1, 131)], np.int32)
    lengths = np.array(list(range(1, 131)) * 16, np.int32)
    data = torch.from_numpy(host).to(cuda)
    s = torch.from_numpy(starts).to(cuda)
    n = torch.from_numpy(lengths).to(cuda)
    got = sha.sha256_chunks_device(data, s, n, max_len=4096)
    assert torch.equal(got, sha._sha256_chunks_plain(data, s, n,
                                                     max_len=4096))
    dig = got.cpu().numpy().view(np.uint32).astype(">u4")
    for i, (a, k) in enumerate(zip(starts, lengths)):
        assert dig[i].tobytes() == hashlib.sha256(host[a:a + k]).digest()


def test_sha256_slices_at_the_legacy_shape(cuda, rng):
    """16,384 lanes as the legacy engine sends a 32 MiB segment: 8,225
    leaves of its chunks at any offset, the rest empty padding lanes,
    == the twin and hashlib."""
    import hashlib

    host = np.frombuffer(rng.bytes(32 << 20), np.uint8).copy()
    starts = np.zeros(16384, np.int32)
    lengths = np.zeros(16384, np.int32)
    k, pos = 0, 0
    while k < 8225:
        n = int(rng.randint(1, 12 * 4096))  # a chunk, cut into leaves
        for off in range(0, n, 4096):
            if k == 8225 or pos + off >= host.shape[0]:
                break
            starts[k] = pos + off
            lengths[k] = min(4096, n - off, host.shape[0] - pos - off)
            k += 1
        pos += n
    data = torch.from_numpy(host).to(cuda)
    s = torch.from_numpy(starts).to(cuda)
    n = torch.from_numpy(lengths).to(cuda)
    got = sha.sha256_chunks_device(data, s, n, max_len=4096)
    assert torch.equal(got, sha._sha256_chunks_plain(data, s, n,
                                                     max_len=4096))
    dig = got.cpu().numpy().view(np.uint32).astype(">u4")
    for i in range(0, 16384, 7):
        a, m = starts[i], lengths[i]
        assert dig[i].tobytes() == hashlib.sha256(host[a:a + m]).digest()


def test_sha256_slices_raises_on_what_the_kernel_does_not_take(cuda):
    d = torch.zeros(8192 + 16, dtype=torch.uint8, device=cuda)
    s = torch.zeros(4, dtype=torch.int32, device=cuda)
    for data, starts, lengths in ((d[1:4097], s, s),  # not 16-byte aligned
                                  (d[:0], s, s),  # empty buffer
                                  (d, s, s[:3]),  # lanes disagree
                                  (d, s.view(2, 2), s.view(2, 2)),
                                  (d, s.cpu(), s),
                                  (d.to(torch.int32), s, s)):
        with pytest.raises(ValueError):
            sha.sha256_chunks_device(data, starts, lengths, max_len=4096)
    with pytest.raises(ValueError):
        sha.sha256_chunks_device(d, s, s, max_len=1 << 28)


def _tail_case(rng, form):
    """A seeded table and lanes of one table form: the fused chunk
    tables (3 lanes of 8 pages: a partial tail, no chunk, a tail on the
    page grid) or spans (a padding lane and tails of 1 to 4095 bytes)."""
    S, F, cap = 3, 8, 8
    data = np.frombuffer(rng.bytes(S * F * 4096), np.uint8).copy()
    table = rng.randint(-2**31, 2**31 - 1, size=(8 * S * F,)).astype(
        np.int32)
    if form == "chunks":
        starts = np.zeros((S, cap), np.int32)
        lens = np.zeros((S, cap), np.int32)
        starts[0, :3], lens[0, :3] = [0, 4096, 12288], [4096, 8192, 7000]
        starts[2, :2], lens[2, :2] = [0, 8192], [8192, 4096]
        lanes = (starts, lens, np.array([3, 0, 2], np.int32))
        kw = dict(lane_pages=F)
    else:
        lanes = (np.array([0, 8192, 20480, 0, 45056, 69632], np.int64),
                 np.array([1, 4096, 9000, -1, 4095, 20000], np.int64))
        kw = {}
    return data, table, lanes, kw


@pytest.mark.parametrize("form", ["chunks", "spans"])
@pytest.mark.parametrize("pagemajor", [False, True], ids=["wm", "pm"])
def test_tail_leaves_into_equals_twin(cuda, rng, form, pagemajor):
    """sha256_slices' table forms write each lane's tail digest into the
    table exactly where the twin's _apply_tail_overrides puts it, and
    nothing else; one launch a call."""
    data, table, lanes, kw = _tail_case(rng, form)
    npp = table.shape[0] // 8
    d = torch.from_numpy(data).to(cuda)
    t = torch.from_numpy(table).to(cuda)
    ln = [torch.from_numpy(x).to(cuda) for x in lanes]
    want = seg._tail_leaves_plain(t, npp, d, *ln, pagemajor=pagemajor, **kw)
    entry = sha.SHA256_TAIL_CHUNKS if form == "chunks" \
        else sha.SHA256_TAIL_SPANS
    launched = entry.launches
    got = seg.tail_leaves_into(t.clone(), npp, d, *ln, pagemajor=pagemajor,
                               **kw)
    assert entry.launches == launched + 1
    assert torch.equal(got, want)
    assert int((want != t).sum()) > 0


@pytest.mark.parametrize("threads", [32, 64, 128, 256])
def test_sha256_pages_pagemajor_equals_twin(cuda, rng, threads):
    """K1's page-major store == its twin (the word-major table
    transposed) on a ragged grid, with zero pages past the buffer."""
    F, npp = 200, 333
    data = _pages(rng, F, cuda)
    got = sha.sha256_pages(data, npp, threads=threads, pagemajor=True)
    assert torch.equal(got, sha._sha256_pages_plain(data, npp, True))
    assert torch.equal(got, seg._pagemajor_plain(
        sha.sha256_pages(data, npp, threads=threads).view(8, npp)))


@pytest.mark.parametrize("align,pagemajor,want", [
    (4096, False, {"sha256_pages": 1, "fastcdc_walk": 1,
                   "sha256_slices": 1, "merkle_roots": 1}),
    (4096, True, {"sha256_pages": 1, "fastcdc_walk": 1,
                  "sha256_slices": 1, "merkle_roots": 1}),
    (64, False, {"sha256_rows": 1, "sha256_slices": 1}),
    (1, False, {"sha256_slices": 1})], ids=["fused", "pagemajor", "align64",
                                            "align1"])
def test_launches_of_one_device_pass(cuda, rng, monkeypatch, align,
                                     pagemajor, want):
    """One device pass of each engine launches exactly these kernels
    once and no other (no sha256_lanes, transpose_u32 or
    pagemajor_u32)."""
    from volsync_tpu_torch.engine import DeviceChunkHasher
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts

    if pagemajor:
        monkeypatch.setenv("VOLSYNC_PAGEMAJOR", "1")
    else:
        monkeypatch.delenv("VOLSYNC_PAGEMAJOR", raising=False)
    p = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                   align=align)
    buf = rng.bytes(300_000) + bytes(70_000) + rng.bytes(33_333)
    hasher = DeviceChunkHasher(p, device=cuda)
    hasher.process(buf)  # builds and loads every library it launches
    for k in KERNELS:
        k.launches = 0
    chunks = hasher.process(buf)
    torch.cuda.synchronize()
    assert {k: n for k, n in launch_counts().items() if n} == want
    assert chunks == DeviceChunkHasher(p, device="cpu").process(buf)
