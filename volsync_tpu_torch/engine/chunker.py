"""Streaming CDC chunk+hash pipeline: the mover's device hot path.

Ports ``volsync_tpu/engine/chunker.py``: a segment of the input stream
is uploaded to the card once and chunked and hashed there; only chunk
tables and digests come back. ``stream_chunk_batches`` carries the
unterminated tail of each segment into the next, so chunk boundaries
equal one-shot chunking of the whole stream. ``DeviceChunkHasher`` runs
one of three engines, picked by the repository's ``align``:

- align == 4096 (the repo default): the fused pass of
  ``ops/segment.py``, one small fetch per segment (ref :185-194);
- 64 <= align < 4096, split phase (ref :195-208): aligned candidates on
  the card, the host FastCDC walk, then one leaf dispatch
  (``sha256_leaves_device``: K2 ``sha256_rows`` for full leaves,
  ``sha256_slices`` for the short tails) left in flight while the stream
  moves on; ``_leaf_plan``, ``_dispatch_leaves``, ``_assemble_roots``
  and ``PendingSegment.split_phase`` port ref :287-419;
- align == 1, legacy (ref :209-213): per-byte gear candidates, the host
  walk, and every leaf a lane of ``sha256_chunks_device``, one
  ``sha256_slices`` launch (``device_span_roots``, ref :422-454), the
  route unaligned
  ``hash_spans`` also takes (ref :527).

On the fused path ``begin`` hands the segment to the process-wide
segment micro-batcher (``ops/batcher.shared_batcher``, ref :164-175)
when batching is on: by default where the hasher's device is CUDA, and
as ``VOLSYNC_BATCH_SEGMENTS`` forces it. Concurrent workers' segments
then coalesce into one batched pass; owners that batch for themselves
(``MoverJaxServer``) clear ``use_shared_batcher``.

Files are read through the native readahead reader
(``_open_readahead``, ``io/native.py``) when its library is available.
``process_device`` runs the device pipeline on a segment already on the
card, and the class attributes ``leaf_device_fn`` / ``cand_device_fn``
replace the split-phase path's two fused launches (ref :215-262): the
benchmark hooks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from volsync_tpu_torch import envflags, resolve_device
from volsync_tpu_torch.engine import bufpool
from volsync_tpu_torch.obs import carry_context, record_copy, span
from volsync_tpu_torch.ops.gearcdc import (
    GearParams,
    fetch_candidates,
    select_boundaries,
)
from volsync_tpu_torch.ops.segment import (
    LEAF_SIZE,
    FusedSegmentHasher,
    page_digests,
    span_roots_device,
)
from volsync_tpu_torch.ops.sha256 import (
    sha256_chunks_device,
    sha256_leaves_device,
)
from volsync_tpu_torch.repo import blobid

log = logging.getLogger(__name__)


def params_from_config(cfg: dict) -> GearParams:
    """GearParams from a repository's persisted chunker config. Repos
    written before the aligned-cut format carry no "align" key and keep
    align=1 (the legacy engine) forever, so their chunk boundaries and
    dedup stay valid; align 64 runs the split-phase engine and 4096 the
    fused one."""
    return GearParams(min_size=cfg["min_size"], avg_size=cfg["avg_size"],
                      max_size=cfg["max_size"], seed=cfg["seed"],
                      align=cfg.get("align", 1))


def params_from_reference(d: dict) -> GearParams:
    """The port's GearParams from ``dataclasses.asdict`` of the
    reference's: both packages then chunk under identical parameters."""
    names = {f.name for f in dataclasses.fields(GearParams)}
    if set(d) != names:
        raise ValueError(f"GearParams fields differ: {sorted(set(d) ^ names)}")
    return GearParams(**d)


def _pow2ceil(n: int, lo: int = 1) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def _buffer_bucket(length: int) -> int:
    """Pad target for input buffers: pow2 up to 8 MiB, then multiples of
    8 MiB (the reference's bounded set of shapes; the packed results
    depend on the padded length through the capacities)."""
    if length <= 8 * 1024 * 1024:
        return _pow2ceil(length, 64 * 1024)
    m = 8 * 1024 * 1024
    return (length + m - 1) // m * m


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host uint8 array -> a device tensor that owns its memory (the
    pooled host buffer is recycled once the segment finishes)."""
    if not arr.flags.writeable:
        arr = arr.copy()
    with span("device.h2d"):
        return torch.from_numpy(arr).to(device=device, copy=True)


class DeviceChunkHasher:
    """chunk+hash a byte buffer with one host->device upload.

    With align == 4096 the whole segment runs as one fused pass
    (ops/segment.py) with one small result fetch: candidates, the
    FastCDC walk, leaf hashing and Merkle-root assembly stay on the
    card, and only the chunk table and 32-byte roots come back. Other
    aligns fetch the candidates, walk on the host, and hash leaves on
    the card (split phase for align >= 64, legacy below; see the module
    docstring)."""

    #: Safe to drive from concurrent threads (ref chunker.py:96-98): no
    #: per-call mutable state, launches go to the calling thread's
    #: current stream, the kernel libraries load under one lock and the
    #: launch counts add under another. ``TreeBackup`` hashes that many
    #: files at once only when this is set.
    thread_safe = True

    #: Owners that manage their own batching (MoverJaxServer) set this
    #: False so the process-wide shared batcher cannot override their
    #: explicit per-request configuration (ref chunker.py:100-101).
    use_shared_batcher = True

    #: ``begin()`` takes ``valid_len`` (ref chunker.py:103-107): a
    #: stream hands it a view already padded to the device bucket with
    #: a zeroed pad lane, so no ``np.pad`` copy happens per segment.
    accepts_prepadded = True

    def __init__(self, params: GearParams, device=None):
        self.params = params
        self.device = resolve_device(device)
        self.fused = (FusedSegmentHasher(params)
                      if params.align == LEAF_SIZE else None)

    def process(self, buffer, *, eof: bool = True
                ) -> list[tuple[int, int, str]]:
        """-> [(start, length, blob-id-hex)] covering ``buffer`` (the
        tail is withheld when not ``eof``)."""
        return self.begin(buffer, eof=eof).finish()

    def begin(self, buffer, *, eof: bool = True,
              valid_len: Optional[int] = None) -> "PendingSegment":
        """Upload + launch the segment's device work, leaving it IN
        FLIGHT. On the fused path the chunk table is part of the one
        in-flight result, so ``.end`` fetches it; on the split-phase
        path the walk runs here and only the leaf digests stay in
        flight until ``finish()``. Callers that hold a bucket-padded
        view pass it plus ``valid_len``.

        When the shared batcher is on (``ops/batcher.shared_batcher``:
        by default on CUDA) the fused path submits the segment to it
        and blocks for its lane of a batched pass instead."""
        if isinstance(buffer, (bytes, bytearray, memoryview)):
            buffer = np.frombuffer(buffer, dtype=np.uint8)
        have = int(buffer.shape[0])
        length = have if valid_len is None else int(valid_len)
        if length == 0:
            return PendingSegment([])
        p = self.params
        if length <= p.min_size:
            if not eof:
                return PendingSegment([])
            return PendingSegment(
                [(0, length, blobid.blob_id(buffer[:length]))])
        if self.use_shared_batcher and self.fused is not None:
            from volsync_tpu_torch.ops.batcher import shared_batcher

            batcher = shared_batcher(p, device=self.device)
            if batcher is not None:
                # consumed == the last chunk's end, which is what
                # PendingSegment.end derives from the chunk list. The
                # buffer passes through uncopied (submit blocks, so it
                # stays alive).
                chunks, _consumed = batcher.submit(buffer, length, eof)
                return PendingSegment(chunks)
        padded = _buffer_bucket(length)
        if have < padded:
            record_copy("device.pad", length)
            buffer = np.pad(buffer, (0, padded - have))
        elif have > padded:
            buffer = buffer[:padded]
        return self.begin_device(_to_device(buffer, self.device), length,
                                 eof=eof)

    def begin_device(self, dev: torch.Tensor, length: int, *,
                     eof: bool = True) -> "PendingSegment":
        p = self.params
        if self.fused is not None:
            with span("engine.fused_dispatch"):
                inflight = self.fused.dispatch(dev, length, eof=eof)
            return PendingSegment.fused_segment(self.fused, dev, length,
                                                inflight, eof)
        with span("engine.candidates"):
            idx_s, idx_l = fetch_candidates(dev, p, length,
                                            cand_fn=self.cand_device_fn)
        with span("engine.boundary_walk"):
            chunks = select_boundaries(idx_s, idx_l, length, p, eof=eof)
        if not chunks:
            return PendingSegment([])
        if p.align >= 64:
            with span("engine.leaf_dispatch"):
                plan = _leaf_plan(chunks)
                inflight = _dispatch_leaves(dev, *plan[:3],
                                            leaf_fn=self.leaf_device_fn)
            return PendingSegment.split_phase(chunks, plan, inflight)
        with span("engine.leaf_roots"):
            hexes = device_span_roots(dev, chunks)
        return PendingSegment([(s, l, h)
                               for (s, l), h in zip(chunks, hexes)])

    def process_device(self, dev: torch.Tensor, length: int, *,
                       eof: bool = True) -> list[tuple[int, int, str]]:
        """The device pipeline on an already-resident bucket-padded
        buffer — what ``process`` runs after its upload, and what a
        benchmark measures: the segment's launches plus their result
        fetch (ref :215-221)."""
        return self.begin_device(dev, length, eof=eof).finish()

    #: Override points for the split-phase path's two fused launches
    #: (benchmarks compose a content salt into the same programs; None =
    #: the library's ``sha256_leaves_device`` / the aligned
    #: ``cdc_candidates_aligned_packed``). ``leaf_device_fn(dev, rows,
    #: tail_starts, tail_lengths, leaf_len=...)`` and
    #: ``cand_device_fn(dev, cap)`` take the library calls' arguments.
    leaf_device_fn = None
    cand_device_fn = None


def device_leaf_digests(dev: torch.Tensor, leaf_starts: list[int],
                        leaf_lengths: list[int]) -> list[bytes]:
    """SHA-256 digests of arbitrary <= 4 KiB slices of a resident
    buffer, every slice one ``sha256_chunks_device`` lane (lanes padded
    to a pow2 >= 128 with empty slices; on the card one
    ``sha256_slices`` launch); one fetch of 32 bytes per lane."""
    lanes = _pow2ceil(len(leaf_starts), 128)
    starts = np.zeros((lanes,), np.int32)
    lengths = np.zeros((lanes,), np.int32)
    starts[: len(leaf_starts)] = leaf_starts
    lengths[: len(leaf_lengths)] = leaf_lengths
    digests = sha256_chunks_device(
        dev, torch.from_numpy(starts).to(dev.device),
        torch.from_numpy(lengths).to(dev.device), max_len=LEAF_SIZE)
    flat = digests.cpu().numpy().view(np.uint32).astype(">u4").tobytes()  # lint: ignore[VL106,VL501] 32 B/leaf digest wire form, metadata not payload; one batched 32 B/lane digest download — this helper's contract
    return [flat[32 * k: 32 * (k + 1)] for k in range(len(leaf_starts))]


def _leaf_plan(chunks: list[tuple[int, int]]):
    """Host-side leaf assignment for a chunk list with 64-byte-aligned
    cuts: which leaves are full (K2, by 64-byte row) and which are short
    tails (``sha256_chunks_device``), plus the bookkeeping that
    reassembles each chunk's leaf sequence -> (full_rows, short_starts,
    short_lengths, slot, spans)."""
    full_rows: list[int] = []
    short_starts: list[int] = []
    short_lengths: list[int] = []
    slot: list[tuple[bool, int]] = []  # leaf -> (is_full, index)
    spans: list[tuple[int, int]] = []  # chunk -> (first leaf, count)
    for start, length in chunks:
        first = len(slot)
        n = blobid.leaf_count(length)
        for k in range(n):
            s = start + k * LEAF_SIZE
            l = min(LEAF_SIZE, length - k * LEAF_SIZE)
            if l == LEAF_SIZE:
                if s % 64:
                    raise ValueError("the split-phase path needs 64-byte "
                                     "aligned leaf starts")
                slot.append((True, len(full_rows)))
                full_rows.append(s // 64)
            else:
                slot.append((False, len(short_starts)))
                short_starts.append(s)
                short_lengths.append(l)
        spans.append((first, n))
    return full_rows, short_starts, short_lengths, slot, spans


def _dispatch_leaves(dev: torch.Tensor, full_rows, short_starts,
                     short_lengths, leaf_fn=None):
    """Launch the segment's one leaf dispatch (``leaf_fn``, default
    ``sha256_leaves_device``) -> (the in-flight [F + T, 8] digests, F).
    Full-leaf lanes pad to a pow2 >= 128 with row 0, tail lanes to a
    pow2 >= 8 with empty slices."""
    lanes_f = _pow2ceil(len(full_rows), 128)
    lanes_t = _pow2ceil(max(len(short_starts), 1), 8)
    rows = np.zeros((lanes_f,), np.int32)
    rows[: len(full_rows)] = full_rows
    ts = np.zeros((lanes_t,), np.int32)
    tl = np.zeros((lanes_t,), np.int32)
    ts[: len(short_starts)] = short_starts
    tl[: len(short_lengths)] = short_lengths
    on_dev = [torch.from_numpy(a).to(dev.device) for a in (rows, ts, tl)]  # lint: ignore[VL502] a fixed three-array unroll (full rows, tail starts, tail lengths) for the segment's one leaf dispatch
    return (leaf_fn or sha256_leaves_device)(
        dev, *on_dev, leaf_len=LEAF_SIZE), lanes_f


def _assemble_roots(chunks, plan, digests: np.ndarray,
                    lanes_f: int) -> list[str]:
    """Blob ids from the fetched [F + T, 8] leaf digests and the plan."""
    _, _, _, slot, spans = plan
    flat = digests.view(np.uint32).astype(">u4").tobytes()  # lint: ignore[VL106] 32 B/leaf digest wire form, metadata not payload

    def leaf(is_full: bool, i: int) -> bytes:
        base = (i if is_full else lanes_f + i) * 32
        return flat[base: base + 32]

    return [blobid.root_from_leaves(
        length, [leaf(*slot[first + k]) for k in range(n)])
        for (first, n), (_, length) in zip(spans, chunks)]


def device_span_roots(dev: torch.Tensor,
                      chunks: list[tuple[int, int]]) -> list[str]:
    """Blob ids for (start, length) slices of a resident buffer at any
    offsets: every 4 KiB leaf of every slice is one
    ``sha256_chunks_device`` lane, and the roots combine on the host.
    (The reference's ``aligned=True`` form, which no caller uses, is the
    split-phase leaf dispatch that ``begin_device`` runs directly.)"""
    leaf_starts: list[int] = []
    leaf_lengths: list[int] = []
    spans: list[tuple[int, int]] = []  # (first leaf, count) per slice
    for start, length in chunks:
        first = len(leaf_starts)
        n = blobid.leaf_count(length)
        for k in range(n):
            leaf_starts.append(start + k * LEAF_SIZE)
            leaf_lengths.append(min(LEAF_SIZE, length - k * LEAF_SIZE))
        spans.append((first, n))
    leaves = device_leaf_digests(dev, leaf_starts, leaf_lengths)
    return [blobid.root_from_leaves(length, leaves[first: first + n])
            for (first, n), (_, length) in zip(spans, chunks)]


class PendingSegment:
    """A segment whose device work may still be in flight: ``.end`` =
    bytes consumed, ``finish()`` -> [(start, length, blob-id-hex)].

    Split-phase and legacy segments know their chunk list at once, so
    ``.chunks``/``.end`` leave the leaf digests in flight; the fused
    path learns it from its one fetch, so there they force
    ``finish()``."""

    def __init__(self, done):
        self._done = done
        self._chunks = [(s, l) for s, l, _ in done]
        self._fused = None
        self._inflight = None

    @classmethod
    def fused_segment(cls, fsh, dev, length, inflight, eof):
        seg = cls([])
        seg._done = seg._chunks = None
        seg._fused = (fsh, dev, length, inflight, eof)
        return seg

    @classmethod
    def split_phase(cls, chunks, plan, inflight):
        """``inflight`` = (device digests, lanes_f) of ``_dispatch_leaves``."""
        seg = cls([])
        seg._done = None
        seg._chunks = list(chunks)
        seg._inflight = (plan, inflight)
        return seg

    @property
    def chunks(self) -> list[tuple[int, int]]:
        if self._chunks is None:
            self.finish()
        return self._chunks

    @property
    def end(self) -> int:
        """One past the last covered byte (0 if nothing was emitted)."""
        if not self.chunks:
            return 0
        s, l = self.chunks[-1]
        return s + l

    def finish(self) -> list[tuple[int, int, str]]:
        if self._done is not None:
            return self._done
        if self._fused is not None:
            fsh, dev, length, inflight, eof = self._fused
            with span("engine.fused_fetch"):
                chunks, _ = fsh.finish(dev, length, inflight, eof=eof)
            self._fused = None
            self._chunks = [(s, l) for s, l, _ in chunks]
        else:
            plan, (digests, lanes_f) = self._inflight
            with span("engine.leaf_fetch_assemble"):
                hexes = _assemble_roots(self._chunks, plan,
                                        digests.cpu().numpy(), lanes_f)
            self._inflight = None
            chunks = [(s, l, h) for (s, l), h in zip(self._chunks, hexes)]
        self._done = chunks
        return chunks


def _spans_page_disjoint(spans: list[tuple[int, int]]) -> bool:
    """True iff every span starts on the 4 KiB page grid and no two
    spans touch the same page — the precondition of the shared
    page-digest table in ops/segment.span_roots_device. Zero-length
    spans touch no pages (they are hashed host-side)."""
    last_page = -1
    for s, l in sorted(spans):
        if s % LEAF_SIZE != 0:
            return False
        if l <= 0:
            continue
        if s // LEAF_SIZE <= last_page:
            return False
        last_page = (s + l - 1) // LEAF_SIZE
    return True


def _upload_padded(buffer, device: torch.device) -> torch.Tensor:
    """Host bytes/array -> device tensor padded to a bucketed length."""
    if isinstance(buffer, (bytes, bytearray, memoryview)):
        buffer = np.frombuffer(buffer, dtype=np.uint8)
    length = int(buffer.shape[0])
    padded = _buffer_bucket(max(length, 1))
    if padded != length:
        record_copy("device.pad", length)
        buffer = np.pad(buffer, (0, padded - length))
    return _to_device(buffer, device)


def hash_spans(buffer, spans: list[tuple[int, int]],
               device=None) -> list[str]:
    """Device-batched blob ids for (start, length) spans of one buffer.

    Page-aligned, page-disjoint spans take ``span_roots_device``: one
    pass and one [N, 8] fetch. Other spans fall back to the per-leaf
    gather batch of ``device_span_roots`` (ref chunker.py:527)."""
    dev = resolve_device(device)
    if not spans:
        return []
    if not _spans_page_disjoint(spans):
        return device_span_roots(_upload_padded(buffer, dev), spans)
    n_cap = _pow2ceil(len(spans), 128)
    starts = np.zeros((n_cap,), np.int64)
    lengths = np.full((n_cap,), -1, np.int64)  # padding lanes
    starts[: len(spans)] = [s for s, _ in spans]
    lengths[: len(spans)] = [l for _, l in spans]
    # Zero-length spans own no page (their device tail override would hit
    # whatever span owns it); their id is a constant.
    empty = lengths[: len(spans)] == 0
    lengths[: len(spans)][empty] = -1
    roots = span_roots_device(
        _upload_padded(buffer, dev), torch.from_numpy(starts),
        torch.from_numpy(lengths), max_len=int(max(lengths.max(), 0)))
    roots = roots.cpu().numpy().view(np.uint32).astype(">u4")  # lint: ignore[VL501] one batched 32 B/span root download — metadata, not payload
    empty_id = blobid.blob_id(b"")
    return [empty_id if empty[i] else roots[i].tobytes().hex()  # lint: ignore[VL106] 32 B span-root ids, metadata not payload
            for i in range(len(spans))]


def _open_readahead(path, segment_size: int):
    """Open ``path`` through the native double-buffered readahead
    (``io/native.py``, ``native/volio.cpp``) when available: disk IO for
    segment N+1 overlaps the device hashing of segment N. Else plain
    ``open()``, as the reference (ref :530-543)."""
    try:
        from volsync_tpu_torch.io import ReadaheadReader, available

        if available():
            return ReadaheadReader(path, segment_size)
    except Exception as ex:  # noqa: BLE001 - native is optional
        log.debug("native readahead unavailable for %s, using plain "
                  "open(): %s", path, ex)
    return open(path, "rb")


def verify_blob_batch(pairs: list, device=None) -> list:
    """Device-batch blob-id verification: ``pairs`` is
    [(expected-id-hex, plaintext bytes)]; returns the ids whose content
    re-derives to something else. Blobs pack page-aligned into one
    staging buffer, so one ``hash_spans`` pass checks them all."""
    dev = resolve_device(device)
    if not pairs:
        return []
    spans = []
    off = payload = 0
    for _, data in pairs:
        spans.append((off, len(data)))
        payload += len(data)
        off += len(data) + (-len(data) % LEAF_SIZE)
    staging = np.zeros((_buffer_bucket(max(off, 1)),), np.uint8)
    for (start, _), (_, data) in zip(spans, pairs):
        n = len(data)
        if n:
            staging[start: start + n] = np.frombuffer(data, np.uint8, count=n)
    record_copy("verify.stage", payload)
    got = hash_spans(staging, spans, device=dev)
    return [bid for (bid, _), d in zip(pairs, got) if d != bid]


def hash_file_streaming(path, *, segment_size: int = 32 * 1024 * 1024,
                        device=None) -> str:
    """Blob id of an arbitrarily large file with bounded memory: page
    digests are computed on the card one segment at a time and the root
    combines host-side; the file's final partial leaf is hashed on the
    host from bytes already in hand."""
    dev = resolve_device(device)
    if segment_size % LEAF_SIZE:
        raise ValueError("segment_size must be a multiple of 4 KiB")
    leaves: list[bytes] = []
    total = 0
    buf = bufpool.GLOBAL.acquire(segment_size)
    try:
        view = memoryview(buf)
        arr = np.frombuffer(buf, np.uint8)
        with _open_readahead(path, segment_size) as f:
            while True:
                n = 0
                while n < segment_size:
                    got = f.readinto(view[n:segment_size]) or 0
                    if got == 0:
                        break
                    n += got
                if n == 0:
                    break
                total += n
                full = n // LEAF_SIZE
                if full:
                    dig = page_digests(_upload_padded(
                        arr[: full * LEAF_SIZE], dev))[:full].astype(">u4")
                    leaves.extend(dig[k].tobytes() for k in range(full))  # lint: ignore[VL106] 32 B leaf digest rows, metadata not payload
                if n % LEAF_SIZE:
                    leaves.append(hashlib.sha256(
                        view[full * LEAF_SIZE: n]).digest())
                if n < segment_size:
                    break  # EOF landed mid-segment
    finally:
        view.release()
        del arr
        bufpool.GLOBAL.release(buf)
    if total == 0:
        return blobid.blob_id(b"")
    return blobid.root_from_leaves(total, leaves)


def _resolve_reader(reader):
    """(read_fn, readinto_fn) for a stream source: when ``reader`` is a
    bound ``read`` of an object that also has ``readinto``, segment
    fills go straight into the pooled buffer."""
    readinto = getattr(reader, "readinto", None)
    if readinto is None:
        readinto = getattr(getattr(reader, "__self__", None),
                           "readinto", None)
    read = getattr(reader, "read", None) or reader
    return read, readinto


class _SegmentFill:
    """Fills pooled segment buffers for stream_chunk_batches.

    ``[0, head)`` is reserved for the previous segment's carried tail
    (head == max_size bounds it); new bytes fill ``[head, head +
    target)`` with target == segment_size + max_size. ``readinto()``
    sources fill in place; ``read()`` sources pay one
    ``chunker.ingest`` copy. The bucket slack past the window lets the
    consumer hand the device a pre-padded view."""

    def __init__(self, reader: Callable[[int], bytes], piece_size: int,
                 max_size: int):
        self._read, self._readinto = _resolve_reader(reader)
        self._piece = piece_size
        self.head = max_size
        self.target = piece_size + max_size
        self.capacity = max_size + _buffer_bucket(self.target + max_size)
        self._eof = False
        self._carry: Optional[memoryview] = None  # over-returned piece

    def next_segment(self) -> tuple[bytearray, int, bool]:
        """-> (pooled buffer, fill end, eof). Data lives in
        ``[head, fill)``; at most one more segment follows eof=True."""
        buf = bufpool.GLOBAL.acquire(self.capacity)
        try:
            view = memoryview(buf)
            fill = self.head
            limit = self.head + self.target
            while not self._eof and fill < limit:
                if self._carry is not None:
                    take = min(len(self._carry), limit - fill)
                    view[fill: fill + take] = self._carry[:take]
                    record_copy("chunker.ingest", take)
                    self._carry = (self._carry[take:]
                                   if take < len(self._carry) else None)
                    fill += take
                    continue
                want = min(self._piece, limit - fill)
                with span("engine.read"):
                    if self._readinto is not None:
                        got = self._readinto(view[fill: fill + want])
                        got = 0 if got is None else int(got)
                        if got == 0:
                            self._eof = True
                        fill += got
                    else:
                        piece = self._read(want)
                        if not piece:
                            self._eof = True
                        else:
                            p = memoryview(piece)
                            take = min(len(p), limit - fill)
                            view[fill: fill + take] = p[:take]
                            record_copy("chunker.ingest", take)
                            if take < len(p):  # reader over-returned
                                self._carry = p[take:]
                            fill += take
        except BaseException:
            # ownership transfers to the caller only on success
            view.release()
            bufpool.GLOBAL.release(buf)
            raise
        view.release()
        return buf, fill, self._eof


class _SegmentReadahead:
    """A producer thread runs _SegmentFill ahead of the consumer so the
    next segment's host read overlaps the current segment's device
    work. Fill exceptions propagate to the consumer; ``close()`` stops
    the thread and returns unconsumed buffers to the pool."""

    def __init__(self, fill: _SegmentFill, depth: int):
        self.head = fill.head
        self._fill = fill
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        # carry_context: the reads' engine.read spans join the trace of
        # the stream they fill
        self._thread = threading.Thread(
            target=carry_context(self._produce), daemon=True,
            name="vtpt-readahead")
        self._thread.start()

    def _produce(self):
        try:
            while not self._stop.is_set():
                item = self._fill.next_segment()
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue  # poll stop: a closed consumer must
                        # not leave this thread blocked forever
                if item[2]:
                    return
        except Exception as ex:  # noqa: BLE001 — re-raised by consumer
            while not self._stop.is_set():
                try:
                    self._q.put(ex, timeout=0.1)
                    return
                except queue.Full:
                    continue

    def next_segment(self) -> tuple[bytearray, int, bool]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if not isinstance(item, Exception):
                bufpool.GLOBAL.release(item[0])


def stream_chunk_batches(reader: Callable[[int], bytes],
                         params: GearParams,
                         segment_size: int = 32 * 1024 * 1024,
                         hasher: Optional[DeviceChunkHasher] = None,
                         readahead: Optional[int] = None,
                         device=None,
                         ) -> Iterator[list[tuple[memoryview, str]]]:
    """Chunk an arbitrary-length stream -> per-segment batches of
    (chunk payload, blob-id hex).

    Each yielded list is one device segment's cut list; flattening the
    batches gives ``stream_chunks``. Payloads are zero-copy
    ``memoryview`` slices of pooled segment buffers, filled with
    ``readinto()`` when the reader supports it; the only per-segment
    host copy is the sub-max_size tail carried between segments.
    ``reader(n)`` returns up to n bytes, b"" at EOF.

    Each segment is one device pass; the buffer advances once its chunk
    list is known (the fused pass's one fetch; on the split-phase path
    the host walk, with the segment's leaf digests still in flight
    until the batch is yielded). ``readahead`` (default: env
    VOLSYNC_TPU_READAHEAD, 0 under VOLSYNC_TPU_PIPELINE=0) runs the fill
    that many buffers ahead on a producer thread. The hasher (default
    ``DeviceChunkHasher(params, device)``) is made before the first
    ``next()``, so a missing device raises at the call. A hasher that
    does not take pre-padded views (``parallel.sharded_chunker.
    MeshChunkHasher``) runs each segment through ``process``."""
    hasher = hasher or DeviceChunkHasher(params, device=device)
    if readahead is None:
        readahead = envflags.readahead_segments()
    return _stream(reader, params, segment_size, hasher, readahead)


def _stream(reader, params: GearParams, segment_size: int, hasher,
            readahead: int):
    src = _SegmentFill(reader, segment_size, params.max_size)
    ra: Optional[_SegmentReadahead] = None
    if readahead > 0:
        ra = src = _SegmentReadahead(src, readahead)
    head = src.head
    prepadded = getattr(hasher, "accepts_prepadded", False)

    def _dispatch(buf, start, fill, eof):
        length = fill - start
        with span("engine.device"):
            if length == 0:
                return PendingSegment([])
            arr = np.frombuffer(buf, np.uint8)
            if not prepadded:
                # Engines without split-phase support (the mesh hasher)
                # still work, just without the overlap (ref :872-877).
                return PendingSegment(
                    hasher.process(arr[start:fill], eof=eof))
            # Hand the device a view already padded to its bucket: zero
            # the pad lane in place (a memset over buffer slack).
            plen = _buffer_bucket(length)
            arr[fill: start + plen] = 0
            return hasher.begin(arr[start: start + plen], eof=eof,
                                valid_len=length)

    def _finish(prev):
        buf, start, token = prev
        with span("engine.device"):
            cuts = list(token.finish())
        if cuts:
            base = memoryview(buf).toreadonly()
            return [(base[start + s: start + s + length], digest)
                    for s, length, digest in cuts]
        return None

    try:
        tail: Optional[memoryview] = None  # lives in prev's buffer
        prev = None  # (buf, start, token)
        while True:
            buf, fill, eof = src.next_segment()
            t = len(tail) if tail is not None else 0
            start = head - t
            if t:
                # The one inter-segment copy: the unterminated tail
                # (< max_size) moves into the next buffer's reserve.
                memoryview(buf)[start:head] = tail
                record_copy("chunker.tail_carry", t)
            tail = None
            token = _dispatch(buf, start, fill, eof)
            consumed = token.end
            tail = memoryview(buf)[start + consumed: fill]
            if len(tail) == 0:
                tail = None
            if prev is not None:
                batch = _finish(prev)
                if batch:
                    yield batch
                bufpool.GLOBAL.release(prev[0])
            prev = (buf, start, token)
            if eof:
                batch = _finish(prev)
                if batch:
                    yield batch
                bufpool.GLOBAL.release(buf)
                return
            # A non-eof pass over more than max_size bytes always emits
            # at least one chunk (max_size forces a cut).
            if consumed <= 0:
                raise AssertionError("chunker made no progress")
    finally:
        if ra is not None:
            ra.close()


def stream_chunks(reader: Callable[[int], bytes], params: GearParams,
                  segment_size: int = 32 * 1024 * 1024,
                  hasher: Optional[DeviceChunkHasher] = None,
                  readahead: Optional[int] = None, device=None,
                  ) -> Iterator[tuple[memoryview, str]]:
    """Flattened ``stream_chunk_batches``: one (chunk bytes, blob-id
    hex) tuple per chunk."""
    batches = stream_chunk_batches(reader, params, segment_size=segment_size,
                                   hasher=hasher, readahead=readahead,
                                   device=device)
    return (item for batch in batches for item in batch)
