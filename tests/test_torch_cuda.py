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


def test_service_streams_on_card_equal_cpu(cuda, rng):
    """Eight concurrent ChunkHash streams through the port's server on
    the card (scheduler + micro-batcher) give the CPU port's chunk
    lists; Info reports cuda and HashSpans equals the CPU's."""
    from concurrent.futures import ThreadPoolExecutor

    from volsync_tpu_torch.engine.chunker import DeviceChunkHasher, hash_spans
    from volsync_tpu_torch.service import MoverJaxClient, MoverJaxServer

    payloads = [rng.bytes(300_000 + 4099 * i) for i in range(8)]
    lanes = []
    with MoverJaxServer(params=PARAMS, segment_size=128 * 1024,
                        batch_window_ms=25.0, max_workers=12) as srv:
        inner = srv._batcher._hasher.hash_segments

        def spy(items):
            lanes.append(len(items))
            return inner(items)

        srv._batcher._hasher.hash_segments = spy

        def run(data):
            with MoverJaxClient("127.0.0.1", srv.port, srv.token) as c:
                return c.chunk_bytes(data)

        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(run, payloads))
        with MoverJaxClient("127.0.0.1", srv.port, srv.token) as c:
            assert c.info().backend == "cuda"
            spans = [(0, 5000), (8192, 70_000), (100_000, 0)]
            assert c.hash_spans(payloads[0], spans) == hash_spans(
                payloads[0], spans, device="cpu")
    cpu = DeviceChunkHasher(PARAMS, device="cpu")
    for data, chunks in zip(payloads, got):
        assert chunks == cpu.process(np.frombuffer(data, np.uint8))
    assert sum(lanes) > len(lanes)  # coalesced


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


def _small_tree(root, rng):
    """A file with an odd tail, its hard link, a sparse file with a hole,
    an empty file, a file below min_size, nested directories."""
    import os

    root.mkdir()
    (root / "tail.bin").write_bytes(rng.bytes(5 * 32768 + 12_345))
    (root / "empty").write_bytes(b"")
    with open(root / "sparse.bin", "wb") as f:
        f.write(rng.bytes(5_000))
        f.seek(145_000)
        f.write(rng.bytes(3_000))
    (root / "sub" / "deeper").mkdir(parents=True)
    os.link(root / "tail.bin", root / "sub" / "hard.bin")
    (root / "sub" / "small.txt").write_bytes(b"hello card\n" * 40)
    for k in range(3):
        (root / "sub" / "deeper" / f"mid{k}.bin").write_bytes(
            rng.bytes(40_000 + 9_999 * k))
    return root


def _chunker(align):
    return {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
            "seed": 0x5EED_CDC1, "align": align}


@pytest.mark.parametrize("align", [4096, 64, 1])
def test_stream_and_tree_backup_on_card_equal_cpu(cuda, rng, tmp_path,
                                                  align):
    """The seams on the card: ``stream_chunk_batches`` gives the CPU's
    batches, and ``TreeBackup`` with four workers on the card gives the
    snapshot of one worker on the CPU (the CPU side is what the JAX
    package is held against in tests/test_torch_seams.py)."""
    from volsync_tpu_torch.engine import stream_chunk_batches
    from volsync_tpu_torch.engine.backup import TreeBackup
    from volsync_tpu_torch.objstore.store import MemObjectStore
    from volsync_tpu_torch.repo.repository import Repository

    p = GearParams(**{k: v for k, v in _chunker(align).items()})
    data = rng.bytes(200_000) + bytes(70_000) + rng.bytes(33_333)

    def batches(device):
        pos = [0]

        def read(n):
            piece = data[pos[0]: pos[0] + min(n, 61_441)]
            pos[0] += len(piece)
            return piece
        return [[(bytes(c), d) for c, d in b] for b in stream_chunk_batches(
            read, p, segment_size=128 * 1024, device=device)]

    assert batches(cuda) == batches("cpu")
    src = _small_tree(tmp_path / "src", rng)
    got = []
    for device, workers in ((cuda, 4), ("cpu", 1)):
        repo = Repository.init(MemObjectStore(), chunker=_chunker(align),
                               device=device)
        snap, _ = TreeBackup(repo, workers=workers).run(src)
        got.append((dict(repo.list_snapshots())[snap]["tree"],
                    repo.blob_ids()))
    assert got[0] == got[1]


def test_backup_check_restore_round_trip_on_card(cuda, rng, tmp_path):
    """Backup, ``check(read_data=True)``, pipelined and serial restore on
    the card, with the verify kernels launched; a flipped byte in an
    unencrypted pack is caught by the device verify before any write."""
    import json
    import os

    from volsync_tpu_torch.engine.backup import TreeBackup
    from volsync_tpu_torch.engine.restore import TreeRestore, \
        restore_snapshot
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts
    from volsync_tpu_torch.repo import crypto
    from volsync_tpu_torch.repo.repository import Repository

    src = _small_tree(tmp_path / "src", rng)
    store = FsObjectStore(tmp_path / "repo")
    repo = Repository.init(store, chunker=_chunker(4096), device=cuda)
    snap, stats = TreeBackup(repo).run(src)
    assert stats.files == 8
    for k in KERNELS:
        k.launches = 0
    assert Repository.open(store, device=cuda).check(read_data=True) == []
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["sha256_pages"] >= 1 and counts["merkle_roots"] >= 1
    assert counts["fastcdc_walk"] == 0
    restore_snapshot(Repository.open(store, device=cuda), tmp_path / "p")
    os.environ["VOLSYNC_DEVICE_VERIFY"] = "1"
    try:
        r = Repository.open(store, device=cuda)
        TreeRestore(r, pipeline=False).run(
            snap, dict(r.list_snapshots())[snap], tmp_path / "s")
    finally:
        del os.environ["VOLSYNC_DEVICE_VERIFY"]
    for dst in (tmp_path / "p", tmp_path / "s"):
        for f in src.rglob("*"):
            g = dst / f.relative_to(src)
            assert f.lstat().st_mode == g.lstat().st_mode
            assert f.lstat().st_mtime_ns == g.lstat().st_mtime_ns
            if f.is_file():
                assert f.read_bytes() == g.read_bytes()
        assert os.path.samefile(dst / "tail.bin", dst / "sub" / "hard.bin")
    # the files by their first blob; flip a byte of one stored raw (no
    # password, incompressible), which only the device verify can catch
    firsts, stack = {}, [(dict(repo.list_snapshots())[snap]["tree"], "")]
    while stack:
        tid, prefix = stack.pop()
        for e in json.loads(repo.read_blob(tid))["entries"]:
            if e["type"] == "dir":
                stack.append((e["subtree"], f"{prefix}{e['name']}/"))
            elif e["type"] == "file" and e["content"]:
                firsts[e["content"][0]] = prefix + e["name"]
    bid, rel = next((b, r) for b, r in sorted(firsts.items())
                    if repo._entry(b).length == repo._entry(b).raw_length + 1)
    ie = repo._entry(bid)
    pack = tmp_path / "repo" / f"data/{ie.pack[:2]}/{ie.pack}"
    body = bytearray(pack.read_bytes())
    body[ie.offset + 100] ^= 1
    pack.write_bytes(bytes(body))
    with pytest.raises(crypto.IntegrityError, match="content hash"):
        restore_snapshot(Repository.open(store, device=cuda),
                         tmp_path / "bad")
    assert not (tmp_path / "bad" / rel).exists()


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (6, 3), (16, 8)])
def test_gf_matmul_on_card_equals_cpu(cuda, k, m):
    """The Reed-Solomon product on the card equals its CPU twin and the
    NumPy oracle, with zero bytes and zero coefficients."""
    from volsync_tpu_torch.ops import rs

    gen = np.random.default_rng(k * 100 + m)
    grid = gen.integers(0, 256, size=(k, 3, 4096), dtype=np.uint8)
    grid[gen.random(grid.shape) < 0.5] = 0
    rows = gen.integers(0, 256, size=(m + 1, k), dtype=np.uint8)
    rows[0, :] = 0
    rows[1, 0] = 0
    got = rs.gf_matmul(rows, torch.from_numpy(grid).to(cuda))
    assert got.device.type == "cuda"
    want = rs.gf_matmul(rows, torch.from_numpy(grid))
    assert torch.equal(got.cpu(), want)
    parity = rs.rs_encode_device(torch.from_numpy(grid).to(cuda), m)
    assert np.array_equal(parity.cpu().numpy().reshape(m, -1),
                          rs.rs_encode_np(grid.reshape(k, -1), m))


def test_ec_round_trip_on_card(cuda, rng, tmp_path, monkeypatch):
    """An erasure-coded backup on the card: 2 of 6 shards of every pack
    lost, then a clean check, a byte-identical restore, a scrub that
    backfills the shards and a repack that converges."""
    import time

    from volsync_tpu_torch.engine.backup import TreeBackup
    from volsync_tpu_torch.engine.restore import restore_snapshot
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.repo.repack import RepackService
    from volsync_tpu_torch.repo.repository import Repository
    from volsync_tpu_torch.repo.scrub import ScrubService

    monkeypatch.setenv("VOLSYNC_EC_SCHEME", "4+2")
    src = _small_tree(tmp_path / "src", rng)
    store = FsObjectStore(tmp_path / "repo")
    repo = Repository.init(store, chunker=_chunker(4096), device=cuda)
    repo.PACK_TARGET = 64 * 1024
    TreeBackup(repo).run(src)
    stripes: dict = {}
    for key in store.list("ec/"):
        stripes.setdefault(key.split("/")[1], []).append(key)
    assert len(stripes) >= 2 and not list(store.list("data/"))
    for keys in stripes.values():
        for key in sorted(keys)[:2]:
            store.delete(key)
    assert Repository.open(store, device=cuda).check(read_data=True) == []
    restore_snapshot(Repository.open(store, device=cuda), tmp_path / "p")
    for f in src.rglob("*"):
        if f.is_file():
            assert f.read_bytes() == (tmp_path / "p" /
                                      f.relative_to(src)).read_bytes()
    scrub = ScrubService(store, device=cuda)
    assert scrub.run_once() == "healed"
    assert ScrubService(store, device=cuda).run_once() == "clean"
    (src / "tail.bin").write_bytes(rng.bytes(50_000))
    again = Repository.open(store, device=cuda)
    again.PACK_TARGET = 64 * 1024
    TreeBackup(again).run(src)
    Repository.open(store, device=cuda).forget(last=1)
    repack = RepackService(store, device=cuda, dead_ratio=0.05,
                           grace_seconds=0.3)
    for _ in range(10):
        if repack.run_once() == "clean" and \
                not list(store.list("pending-delete/")):
            break
        time.sleep(0.3)
    assert repack.outcomes.get("ok", 0) >= 1
    assert Repository.open(store, device=cuda).check(read_data=True) == []


# -- md5_slices and the delta engine ------------------------------------------

MD5_EDGE_LENGTHS = [0, 1, 55, 56, 63, 64, 119, 120, 1000, 4096]


def test_md5_windows_equal_twin_and_hashlib(cuda, rng):
    """md5_fixed_blocks_device on the card (one md5_slices launch) ==
    its twin at starts of every residue mod 16 for each edge length, with
    windows ending on the buffer's last byte, running past it and
    starting before it (clamped, as in the reference); == hashlib on
    every window inside the buffer."""
    import hashlib

    from volsync_tpu_torch.ops import md5

    host = np.frombuffer(rng.bytes(40_000), np.uint8).copy()
    L = host.shape[0]
    data = torch.from_numpy(host).to(cuda)
    for n in MD5_EDGE_LENGTHS:
        starts = np.array([off * 2048 + off for off in range(16)]
                          + [L - n, L - n + 5, L + 3, -7], np.int64)
        s = torch.from_numpy(starts).to(cuda)
        launched = md5.MD5_WINDOWS.launches
        got = md5.md5_fixed_blocks_device(data, s, block_len=n)
        assert md5.MD5_WINDOWS.launches == launched + 1
        want = md5._md5_windows_plain(data, s, block_len=n)
        assert torch.equal(got, want), n
        dig = md5.state_bytes(got)
        for i, a in enumerate(starts):
            if 0 <= a and a + n <= L:
                assert dig[i] == hashlib.md5(host[a:a + n]).digest()


def test_md5_contiguous_and_lanes_equal_twin_and_hashlib(cuda, rng):
    import hashlib

    from volsync_tpu_torch.ops import md5

    host = np.frombuffer(rng.bytes(40 * 4096), np.uint8).copy()
    data = torch.from_numpy(host).to(cuda)
    for bl in (1024, 4096, 32768):
        got = md5.md5_contiguous_blocks_device(data, block_len=bl)
        assert torch.equal(got, md5._md5_contiguous_plain(data.cpu(),
                                                          block_len=bl)
                           .to(cuda))
        assert md5.state_bytes(got) == [
            hashlib.md5(host[i * bl:(i + 1) * bl]).digest()
            for i in range(host.shape[0] // bl)]
    chunks = [rng.bytes(int(k)) for k in rng.randint(0, 201, size=300)]
    blocks, nb = md5.md5_pack_host(chunks)
    nb[:3] = [-1, 0, blocks.shape[1] + 2]
    b = torch.from_numpy(blocks.view(np.int32)).to(cuda)
    n = torch.from_numpy(nb).to(cuda)
    assert torch.equal(md5.md5_blocks(b, n), md5._md5_lanes_plain(b, n))
    assert md5.md5_many(chunks) == [hashlib.md5(c).digest() for c in chunks]


def test_md5_raises_on_what_the_kernel_does_not_take(cuda):
    from volsync_tpu_torch.ops import md5

    d = torch.zeros(8192 + 16, dtype=torch.uint8, device=cuda)
    s = torch.zeros(4, dtype=torch.int64, device=cuda)
    for data, starts in ((d[1:4097], s),  # not 16-byte aligned
                         (d[:0], s),  # empty buffer
                         (d[::2], s),  # not contiguous
                         (d, s.cpu()),
                         (d, s.view(2, 2)),
                         (d.to(torch.int32), s)):
        with pytest.raises(ValueError):
            md5.md5_fixed_blocks_device(data, starts, block_len=64)
    blocks = torch.zeros((4, 2, 16), dtype=torch.int32, device=cuda)
    nb = torch.zeros(4, dtype=torch.int32, device=cuda)
    for b, n in ((blocks.transpose(0, 1), nb[:2]), (blocks, nb.cpu()),
                 (blocks.to(torch.int64), nb)):
        with pytest.raises(ValueError):
            md5.md5_blocks(b, n)


def _md5_windows_case(cuda, host, starts, n):
    """md5_fixed_blocks_device on the card (one launch) == its twin on
    the same tensors, and == hashlib on every window inside the buffer."""
    import hashlib

    from volsync_tpu_torch.ops import md5

    L = host.shape[0]
    data = torch.from_numpy(host).to(cuda)
    s = torch.from_numpy(np.asarray(starts, np.int64)).to(cuda)
    launched = md5.MD5_WINDOWS.launches
    got = md5.md5_fixed_blocks_device(data, s, block_len=n)
    assert md5.MD5_WINDOWS.launches == launched + 1
    assert torch.equal(got, md5._md5_windows_plain(data, s, block_len=n))
    dig = md5.state_bytes(got)
    for i, a in enumerate(starts):
        if 0 <= a and a + n <= L:
            assert dig[i] == hashlib.md5(host[a:a + n]).digest(), (i, a)


@pytest.mark.parametrize("n", [1000, 4096])
def test_md5_edge_lanes_across_warps_and_ctas(cuda, rng, n):
    """Windows at the buffer's edges (past its end, its last window, a
    few bytes before byte 0, wholly below 0 and wholly past L) placed at
    lanes 0, 31, 32, 63, 64 and B - 1 of one launch of B = 200 lanes (not
    a multiple of a block's 64): each lane's words are its own, so an
    edge lane changes no other lane's digest."""
    host = np.frombuffer(rng.bytes(40_000), np.uint8).copy()
    L = host.shape[0]
    B = 200
    starts = list(rng.randint(0, L - n, size=B) | 1)
    edges = [L - n + 5, L - n, -7, -n - 50, L + 1000, L - 3]
    for lane, a in zip([0, 31, 32, 63, 64, B - 1], edges):
        starts[lane] = a
    _md5_windows_case(cuda, host, [int(a) for a in starts], n)


@pytest.mark.parametrize("n", MD5_EDGE_LENGTHS)
def test_md5_padding_lengths_at_every_start_residue(cuda, rng, n):
    """Each padding-boundary length at every start residue mod 16: inside
    the buffer, ending on its last byte, running past it, starting
    before byte 0, and wholly below 0 (start <= -len) or past L."""
    host = np.frombuffer(rng.bytes(9_000), np.uint8).copy()
    L = host.shape[0]
    starts = []
    for r in range(16):
        starts += [100 + 16 * r + r, L - n - r, L - n + r + 1, -r - 1,
                   -n - r, -n - 200 - r, L + r, L + 5000 + r]
    _md5_windows_case(cuda, host, starts, n)


def test_md5_windows_past_4_gib(cuda, rng):
    """One buffer of 4 GiB + 1 MiB: windows whose starts lie past 2**32
    (and one across it, one ending on the last byte, one past the end)
    equal hashlib. The port's starts and offsets are int64: a 32-bit
    offset anywhere would read the wrong bytes here."""
    import hashlib

    from volsync_tpu_torch.ops import md5

    L = (4 << 30) + (1 << 20)
    data = torch.zeros(L, dtype=torch.uint8, device=cuda)
    tail = np.frombuffer(rng.bytes(2 << 20), np.uint8).copy()
    lo = L - tail.shape[0]  # the last 2 MiB: random, across 2**32
    data[lo:] = torch.from_numpy(tail).to(cuda)
    n = 4096
    starts = ([(1 << 32) + 12345 + 4097 * k for k in range(60)]
              + [(1 << 32) - 100, L - n, lo, (1 << 32) + 1])
    s = torch.tensor(starts, dtype=torch.int64, device=cuda)
    dig = md5.state_bytes(md5.md5_fixed_blocks_device(data, s, block_len=n))
    for i, a in enumerate(starts):
        assert dig[i] == hashlib.md5(tail[a - lo:a - lo + n]).digest(), a
    past = md5.md5_fixed_blocks_device(
        data, torch.tensor([L - 100], dtype=torch.int64, device=cuda),
        block_len=n)
    want = tail[-100:].tobytes() + bytes([tail[-1]]) * (n - 100)
    assert md5.state_bytes(past) == [hashlib.md5(want).digest()]


def test_md5_lanes_mixed_block_counts_in_one_warp(cuda, rng):
    """The lanes form with block counts of 0 to 17 mixed inside every
    warp (and counts below 0 and past N clamped) == twin and hashlib."""
    import hashlib

    from volsync_tpu_torch.ops import md5

    lengths = [int(k) for k in rng.choice(
        [0, 1, 55, 56, 63, 64, 119, 120, 500, 1000], size=150)]
    chunks = [rng.bytes(k) for k in lengths]
    blocks, nb = md5.md5_pack_host(chunks)
    b = torch.from_numpy(blocks.view(np.int32)).to(cuda)
    n = torch.from_numpy(nb).to(cuda)
    got = md5.md5_blocks(b, n)
    assert torch.equal(got, md5._md5_lanes_plain(b, n))
    assert md5.state_bytes(got) == [hashlib.md5(c).digest() for c in chunks]
    nb2 = nb.copy()
    nb2[[0, 33, 70]] = [-3, 0, blocks.shape[1] + 5]
    n2 = torch.from_numpy(nb2).to(cuda)
    assert torch.equal(md5.md5_blocks(b, n2), md5._md5_lanes_plain(b, n2))


def test_delta_scan_on_card_equals_cpu(cuda, rng):
    """A small delta batch (an unchanged file, an insertion, an edit, an
    unrelated file, a short tail) on the card: the signatures' wire
    forms and the batched and serial ops equal the CPU twins', and the
    ops rebuild every source."""
    from volsync_tpu_torch.engine import deltasync as ds

    base = rng.bytes(300_000)
    pairs = [(base, base), (base, base[:1000] + b"+" + base[1000:]),
             (base, base[:5000] + rng.bytes(4096) + base[9096:]),
             (base, rng.bytes(300_000)), (base[:9000], base[:9000] + b"x")]
    items = {}
    for dev in ("cuda", "cpu"):
        items[dev] = [(new, ds.build_file_signature(
            old, ds.pick_block_len(max(len(old), len(new))), device=dev))
            for old, new in pairs]
    for (_, a), (_, b) in zip(items["cuda"], items["cpu"]):
        assert a.to_wire() == b.to_wire()
    ops = ds.delta_scan_batch(items["cuda"], device="cuda")
    assert ops == ds.delta_scan_batch(items["cpu"], device="cpu")
    for (old, new), (src, sig), o in zip(pairs, items["cuda"], ops):
        assert o == ds.compute_delta(src, sig, device="cuda")
        assert ds.apply_delta(o, old, sig.block_len) == new


def _mover_trees(rng, root):
    """A destination basis and a source with edits: a 600 KB file with
    an insertion, one rewritten block, one unchanged, a new file."""
    old = {"a.bin": rng.bytes(600_000), "sub/b.bin": rng.bytes(300_000),
           "c.bin": rng.bytes(200_000)}
    new = dict(old)
    new["a.bin"] = old["a.bin"][:1000] + b"+" + old["a.bin"][1000:]
    new["sub/b.bin"] = (old["sub/b.bin"][:8192] + rng.bytes(4096)
                        + old["sub/b.bin"][12288:])
    new["new.bin"] = rng.bytes(50_000)
    for side, files in (("dst", old), ("src", new)):
        for rel, data in files.items():
            p = root / side / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(data)


def test_rsync_push_on_card_equals_cpu(cuda, rng, tmp_path, monkeypatch):
    """The rsync mover's push (source and destination verbs) on the card
    leaves the destination equal to the source, with the same stats as
    the same push on the CPU port, through one md5_slices launch at
    least."""
    from volsync_tpu_torch.engine import syncstats
    from volsync_tpu_torch.movers.rsync import entry
    from volsync_tpu_torch.ops._build import launch_counts

    class _Chan:
        def __init__(self, verbs):
            self.verbs = verbs

        def send(self, msg):
            self.reply = self.verbs[msg["verb"]](msg)

        def recv(self):
            return self.reply

    monkeypatch.setenv("VOLSYNC_SYNC_PROTO", "delta")
    stats = {}
    for dev in ("cuda", "cpu"):
        _mover_trees(np.random.RandomState(5), tmp_path / dev)
        syncstats.reset_books()
        before = launch_counts()["md5_slices"]
        stats[dev] = entry._push_tree(
            _Chan(entry._dest_verbs(tmp_path / dev / "dst", device=dev)),
            tmp_path / dev / "src", device=dev)
        if dev == "cuda":
            assert launch_counts()["md5_slices"] > before
        for p in (tmp_path / dev / "src").rglob("*"):
            if p.is_file():
                rel = p.relative_to(tmp_path / dev / "src")
                assert (tmp_path / dev / "dst" / rel).read_bytes() == \
                    p.read_bytes()
    assert stats["cuda"] == stats["cpu"]
    assert 0 < stats["cuda"]["literal_bytes"] < stats["cuda"]["bytes"]


def test_restic_entry_on_card(cuda, rng, tmp_path, monkeypatch):
    """The restic mover's entry point with no device (CUDA): a backup, a
    second backup with FORGET_LAST=1 and PRUNE=1, and a restore that
    equals the source; the trace lands under VOLSYNC_TRACE_DIR."""
    import threading

    from volsync_tpu_torch.cluster.runner import JobContext
    from volsync_tpu_torch.movers.restic import entry

    monkeypatch.setenv("VOLSYNC_TRACE_DIR", str(tmp_path / "traces"))
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "big.bin").write_bytes(rng.bytes(3 << 20))
    (src / "sub" / "small.txt").write_bytes(b"s" * 5000)

    def run(env, data):
        return entry.restic_entrypoint(JobContext(
            name="r", namespace="ns", env={
                "RESTIC_REPOSITORY": f"file://{tmp_path / 'repo'}",
                "RESTIC_PASSWORD": "pw", **env},
            mounts={"data": data}, secrets={},
            stop_event=threading.Event()))

    assert run({}, src) == 0
    (src / "sub" / "small.txt").write_bytes(b"t" * 6000)
    assert run({"FORGET_LAST": "1", "PRUNE": "1"}, src) == 0
    dst = tmp_path / "dst"
    dst.mkdir()
    assert run({"DIRECTION": "restore"}, dst) == 0
    for p in src.rglob("*"):
        if p.is_file():
            assert (dst / p.relative_to(src)).read_bytes() == p.read_bytes()
    assert len(list((tmp_path / "traces" / "restic-backup").iterdir())) == 2
