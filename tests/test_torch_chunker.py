"""The port's streaming engine (volsync_tpu_torch/engine/chunker.py)
against the JAX package's engine/chunker.py, on the CPU: the same chunk
bytes, ids and batch split from ``stream_chunk_batches`` for the fused
(align 4096), split-phase (align 64) and legacy (align 1) engines, and
blob ids from ``verify_blob_batch``, ``hash_spans`` (aligned and not),
``device_span_roots`` and ``hash_file_streaming`` that equal the host
reference."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsync_tpu.engine import chunker as jch
from volsync_tpu.ops.gearcdc import GearParams
from volsync_tpu.repo import blobid
from volsync_tpu_torch.engine import chunker as tch
from volsync_tpu_torch.obs import copy_totals, span_totals

# Parallel test workers share the cores: keep the CPU twins single-threaded.
torch.set_num_threads(1)

PARAMS = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                    align=4096)
TPARAMS = tch.params_from_reference(dataclasses.asdict(PARAMS))


def _reader(data: bytes, step: int = 73_210):
    pos = [0]

    def read(n):
        n = min(n, step)  # ragged reads
        piece = data[pos[0]: pos[0] + n]
        pos[0] += len(piece)
        return piece
    return read


def test_stream_chunk_batches_matches_reference(rng):
    # page-aligned repeats dedup (cuts are content-defined modulo 4 KiB)
    block = rng.bytes(200 * 4096)
    data = rng.bytes(75 * 4096) + block + rng.bytes(30 * 4096) + block \
        + rng.bytes(12_345)
    want = [[(bytes(c), d) for c, d in batch]
            for batch in jch.stream_chunk_batches(
                _reader(data), PARAMS, segment_size=256 * 1024)]
    have = [[(bytes(c), d) for c, d in batch]
            for batch in tch.stream_chunk_batches(
                _reader(data), TPARAMS, segment_size=256 * 1024,
                device="cpu")]
    assert [len(b) for b in have] == [len(b) for b in want]
    assert have == want
    flat = [c for batch in have for c in batch]
    assert b"".join(c for c, _ in flat) == data
    assert all(d == blobid.blob_id(c) for c, d in flat)
    ids = [d for _, d in flat]
    assert len(set(ids)) < len(ids)  # the repeated block dedups
    count, secs = span_totals()["engine.fused_dispatch"]
    assert count >= len(have) and secs > 0


def test_stream_chunks_readinto_source_is_flattened_batches(rng):
    import io

    data = rng.bytes(150_000)
    got = [(bytes(c), d) for c, d in tch.stream_chunks(
        io.BytesIO(data).read, TPARAMS, segment_size=64 * 1024,
        readahead=0, device="cpu")]
    assert b"".join(c for c, _ in got) == data
    assert all(d == blobid.blob_id(c) for c, d in got)


def test_small_and_empty_buffers():
    h = tch.DeviceChunkHasher(TPARAMS, device="cpu")
    assert h.process(b"") == []
    tiny = b"x" * 100  # <= min_size: host fast path
    [(s, l, d)] = h.process(tiny)
    assert (s, l) == (0, 100) and d == blobid.blob_id(tiny)
    assert h.process(tiny, eof=False) == []


#: The split-phase engine at test scale (chunks span many 64-byte-aligned
#: full leaves) and the reference's own split-phase params.
PARAMS_64 = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                       align=64)
PARAMS64_REF = GearParams(min_size=256, avg_size=1024, max_size=4096)
PARAMS_1 = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                      align=1)


def _port(p):
    return tch.params_from_reference(dataclasses.asdict(p))


@pytest.mark.parametrize("params,eof", [
    (PARAMS_64, True), (PARAMS_64, False), (PARAMS64_REF, True),
    (PARAMS_1, True), (PARAMS_1, False)],
    ids=["align64-eof", "align64-tail", "align64-ref", "align1-eof",
         "align1-tail"])
def test_split_phase_and_legacy_process_match_reference(rng, params, eof):
    """align 64 and 1 run: DeviceChunkHasher.process equals the JAX
    engine's chunks and ids (and blob_id) on random data with a zero
    run."""
    buf = rng.bytes(150_000) + bytes(70_000) + rng.bytes(33_333)
    want = jch.DeviceChunkHasher(params).process(buf, eof=eof)
    have = tch.DeviceChunkHasher(_port(params), device="cpu").process(
        buf, eof=eof)
    assert have == want and len(have) > 2
    assert all(d == blobid.blob_id(buf[s:s + n]) for s, n, d in have)
    assert tch.DeviceChunkHasher(_port(params), device="cpu").fused is None


def test_split_phase_end_leaves_digests_in_flight(rng):
    """On the split-phase path the chunk list is known at dispatch, so
    ``.end`` does not fetch; ``finish()`` does."""
    buf = np.frombuffer(rng.bytes(200_000), np.uint8)
    seg = tch.DeviceChunkHasher(_port(PARAMS_64), device="cpu").begin(
        buf, eof=False)
    end = seg.end
    assert seg._done is None and seg._inflight is not None
    assert 0 < end == sum(n for _, n in seg.chunks) < len(buf)
    done = seg.finish()
    assert [(s, n) for s, n, _ in done] == seg.chunks
    assert seg.end == end


@pytest.mark.parametrize("params", [PARAMS_64, PARAMS_1],
                         ids=["align64", "align1"])
def test_stream_chunk_batches_split_and_legacy_match_reference(rng, params):
    """Segment carry across several segments, a zero run and the eof
    tail: the same batches, chunk bytes and ids as the reference."""
    data = rng.bytes(90_000) + bytes(100_000) + rng.bytes(60_123)
    want = [[(bytes(c), d) for c, d in batch]
            for batch in jch.stream_chunk_batches(
                _reader(data), params, segment_size=96 * 1024)]
    have = [[(bytes(c), d) for c, d in batch]
            for batch in tch.stream_chunk_batches(
                _reader(data), _port(params), segment_size=96 * 1024,
                device="cpu")]
    assert have == want and len(have) >= 2
    assert b"".join(c for batch in have for c, _ in batch) == data


def test_device_span_roots_matches_reference(rng):
    data = np.frombuffer(rng.bytes(64 * 1024), np.uint8).copy()
    chunks = [(0, 4096), (64, 9000), (12_800, 1), (20_032, 20_000),
              (7, 5000), (40_001, 0)]
    want = jch.device_span_roots(jnp.asarray(data), chunks)
    have = tch.device_span_roots(torch.from_numpy(data), chunks)
    assert have == want
    assert have == [blobid.blob_id(data[s:s + n].tobytes())
                    for s, n in chunks]


def test_verify_blob_batch_flags_corruption(rng):
    blobs = [rng.bytes(n) for n in (0, 5000, 4096, 12_345)]
    pairs = [(blobid.blob_id(b), b) for b in blobs]
    staged = copy_totals().get("verify.stage", 0)
    assert tch.verify_blob_batch(pairs, device="cpu") == []
    # the one sanctioned staging copy of the payload is accounted
    assert copy_totals()["verify.stage"] - staged == sum(map(len, blobs))
    assert tch.verify_blob_batch([], device="cpu") == []
    bad = bytearray(blobs[3])
    bad[7000] ^= 1
    pairs[3] = (pairs[3][0], bytes(bad))
    assert tch.verify_blob_batch(pairs, device="cpu") == [pairs[3][0]]


def test_hash_spans_page_aligned(rng):
    """Aligned spans, including empty, exact-page and sub-page tails,
    match blob_id and the reference's hash_spans."""
    sizes = [0, 1, 4095, 4096, 4097, 12288, 50_000]
    pieces, spans, off = [], [], 0
    for n in sizes:
        spans.append((off, n))
        pieces.append(rng.bytes(n) + bytes(-n % 4096))
        off += n + (-n % 4096)
    buf = b"".join(pieces)
    got = tch.hash_spans(buf, spans, device="cpu")
    assert got == [blobid.blob_id(buf[s:s + n]) for s, n in spans]
    assert got == jch.hash_spans(buf, spans)
    # unaligned or page-sharing spans take the per-leaf gather path
    shared = [(0, 10), (10, 100), (5, 0), (4097, 8000)]
    got = tch.hash_spans(buf, shared, device="cpu")
    assert got == jch.hash_spans(buf, shared)
    assert got == [blobid.blob_id(buf[s:s + n]) for s, n in shared]


def test_hash_file_streaming_equals_blob_id(tmp_path, rng):
    for n in (0, 5, 4096, 200_000):
        p = tmp_path / f"f{n}"
        data = rng.bytes(n)
        p.write_bytes(data)
        assert tch.hash_file_streaming(p, segment_size=128 * 1024,
                                       device="cpu") == blobid.blob_id(data)


def test_buffer_bucket_and_page_disjoint_match_reference():
    for n in (1, 65536, 65537, 8 << 20, (8 << 20) + 1, 40 << 20):
        assert tch._buffer_bucket(n) == jch._buffer_bucket(n)
    for spans in ([(0, 100), (4096, 1)], [(0, 4097), (4096, 1)],
                  [(1, 10)], [(0, 0), (0, 100)]):
        assert tch._spans_page_disjoint(spans) == \
            jch._spans_page_disjoint(spans)
