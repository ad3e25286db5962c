"""mover-jax gRPC server: the card's chunk/hash engine as a network service.

Ports ``volsync_tpu/service/server.py``. Remote movers call a gRPC
service whose hot loops run on the card (engine/chunker.py,
ops/batcher.py). The server runs on ``device=`` (None means CUDA and
raises where CUDA is absent); ``Info`` reports that device's type
(``"cuda"``, or ``"cpu"`` when asked for), where the reference reports
JAX's default backend. The wire (``moverjax_pb2``, the metadata keys,
the carry-the-tail protocol) is the reference's byte for byte. Service
surface:

- ``ChunkHash``  — bidirectional stream: volume bytes in segments ->
  finalized (offset, length, blob id) chunks, streaming-CDC semantics
  bit-identical to local chunking (the carry-the-tail protocol of
  stream_chunks).
- ``HashSpans``  — batched span digests (the rclone checksum primitive).
- ``Info``       — engine/device/chunker-envelope discovery.

Security keeps the reference's envelope (mutually-known secret +
restricted verb surface — rsync_common.go's keyed channel): every call
must carry a bearer token in ``x-volsync-token`` metadata — the shared
service token, or the calling tenant's own token when its TenantConfig
pins one (service/tenants.py). Comparison is constant-time
(hmac.compare_digest); anything else is UNAUTHENTICATED. The method
table is closed — gRPC generic handlers register exactly these three
methods.

Multi-tenant service plane (service/admission.py, scheduler.py,
tenants.py): every ChunkHash stream is admission-controlled before any
byte is read — global and per-tenant stream caps, a scheduler-backlog
gate, and an immediate shed while the wired resilience circuit breaker
is open — and admitted streams' segments flow through a weighted
deficit-round-robin scheduler into the shared SegmentMicroBatcher, so
one greedy stream cannot starve other tenants of device batch slots
while cross-tenant segments still coalesce into single dispatches.
Sheds surface as ``RESOURCE_EXHAUSTED`` with an
``x-volsync-retry-after-ms`` trailing-metadata hint (``UNAVAILABLE``
while draining). Within a stream, a credit-based pause bounds how many
request bytes the server buffers beyond the segment in flight — a slow
device pushes back through gRPC flow control instead of growing server
memory.

Service stubs are hand-wired over protoc-generated messages
(grpc_tools is not vendored; grpc's generic-handler API needs only the
message classes).
"""

from __future__ import annotations

import hmac
import logging
import os
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import grpc
import numpy as np

from volsync_tpu_torch import envflags, resolve_device
from volsync_tpu_torch.obs import (begin_span, new_trace, parse_trace_header,
                                   record_copy, use_context)
from volsync_tpu_torch.ops.batcher import BatcherStopped, SegmentMicroBatcher
from volsync_tpu_torch.service import moverjax_pb2 as pb
from volsync_tpu_torch.service.admission import (
    AdmissionController,
    AdmissionRejected,
)
from volsync_tpu_torch.service.scheduler import (
    DeadlineExceeded,
    SchedulerStopped,
    SegmentScheduler,
    parse_deadline_classes,
)
from volsync_tpu_torch.service.tenants import TenantRegistry

log = logging.getLogger("volsync_tpu_torch.moverjax")

SERVICE_NAME = "moverjax.MoverJax"
TOKEN_METADATA_KEY = "x-volsync-token"
#: trailing-metadata key carrying the shed retry-after hint (ms)
RETRY_AFTER_METADATA_KEY = "x-volsync-retry-after-ms"
#: trailing-metadata key carrying a sibling replica's host:port on a
#: shed, when a fleet router is wired (cross-replica admission: retry
#: THERE, not here)
SIBLING_METADATA_KEY = "x-volsync-sibling"
#: request-metadata key carrying the client's trace context
#: (obs.format_trace_header) so client + server spans join one trace
TRACE_METADATA_KEY = "x-volsync-trace"
#: request-metadata key naming the stream's deadline class
#: (scheduler.parse_deadline_classes); unknown/absent = no deadline
DEADLINE_CLASS_METADATA_KEY = "x-volsync-deadline-class"

#: Stream segmentation mirrors engine/chunker.stream_chunks: a segment is
#: processed once at least this much beyond max_size is buffered.
DEFAULT_SEGMENT_SIZE = 32 * 1024 * 1024


def _timed_ingest(request_iterator, ctx):
    """Yield request frames, timing each blocking pull as a
    ``svc.ingest`` span: that wait is paced by the CLIENT (its
    chunking, transport, OS scheduling) yet elapses inside the
    enclosing ``svc.stream`` span, so without it the per-tenant stage
    breakdown has a hole exactly as wide as the client is slow. No
    span is left open across the ``yield`` — abandoning the stream
    mid-iteration leaks nothing."""
    it = iter(request_iterator)
    while True:
        h = begin_span("svc.ingest", ctx=ctx)
        try:
            seg = next(it)
        except StopIteration:
            h.finish("ok")
            return
        except BaseException:
            h.finish("error")
            raise
        h.finish("ok")
        yield seg


class _TokenInterceptor(grpc.ServerInterceptor):
    """Constant-time bearer-token check, tenant-scoped: a tenant with
    its own token must present it; everyone else presents the service
    token. The deny handler matches the method's cardinality (a
    stream-stream call refused with a unary handler draws an opaque
    internal error instead of UNAUTHENTICATED)."""

    def __init__(self, token: str, registry: TenantRegistry):
        self._token = token.encode()
        self._registry = registry
        self._deny_unary = grpc.unary_unary_rpc_method_handler(
            self._refuse_unary)
        self._deny_stream = grpc.stream_stream_rpc_method_handler(
            self._refuse_stream)

    def _refuse_unary(self, request, context):
        context.abort(grpc.StatusCode.UNAUTHENTICATED, "bad service token")

    def _refuse_stream(self, request_iterator, context):
        context.abort(grpc.StatusCode.UNAUTHENTICATED, "bad service token")
        yield  # pragma: no cover — abort raises; this makes a generator

    def intercept_service(self, continuation, handler_call_details):
        meta = dict(handler_call_details.invocation_metadata)
        tenant = self._registry.resolve(meta)
        scoped = self._registry.token_for(tenant)
        expected = scoped.encode() if scoped is not None else self._token
        supplied = str(meta.get(TOKEN_METADATA_KEY, "")).encode()
        if not hmac.compare_digest(supplied, expected):
            method = handler_call_details.method or ""
            if method.rsplit("/", 1)[-1] == "ChunkHash":
                return self._deny_stream
            return self._deny_unary
        return continuation(handler_call_details)


class MoverJaxServer:
    """One engine, many remote movers. ``token`` is the shared service
    secret (generated if not supplied — read it back via ``.token``).
    ``device`` is where every segment and span is hashed (None: CUDA,
    raising where it is absent).

    ``batch_window_ms > 0`` (default) coalesces concurrent streams'
    segments into single device dispatches via SegmentMicroBatcher;
    0 keeps the per-request dispatch path.

    ``tenants``/``max_streams``/``tenant_streams``/``max_queued``
    configure the admission controller (defaults from VOLSYNC_SVC_*).
    ``breaker`` wires load-shedding to a resilience circuit breaker —
    pass a CircuitBreaker, a backend name (resolved via breaker_for),
    or leave None to follow VOLSYNC_SVC_BREAKER_BACKEND.

    Fleet mode (service/fleet.py): ``sibling_fn`` returns a sibling
    replica's ``host:port`` with headroom (or None) — stamped into
    ``x-volsync-sibling`` trailing metadata on every shed so clients
    fail over instead of hammering this replica. ``deadline_classes``
    maps ``x-volsync-deadline-class`` request-metadata names to
    relative queue-wait deadlines (None entry = no deadline); defaults
    follow VOLSYNC_SVC_DEADLINES."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 token: Optional[str] = None, params=None,
                 segment_size: int = DEFAULT_SEGMENT_SIZE,
                 max_workers: int = 8, batch_window_ms: float = 2.0,
                 pipeline_depth: Optional[int] = None,
                 tenants: Optional[TenantRegistry] = None,
                 admission: Optional[AdmissionController] = None,
                 breaker=None,
                 max_streams: Optional[int] = None,
                 tenant_streams: Optional[int] = None,
                 max_queued: Optional[int] = None,
                 stream_credits: Optional[int] = None,
                 scheduler_quantum: Optional[int] = None,
                 sibling_fn=None,
                 deadline_classes: Optional[dict] = None,
                 device=None):
        from volsync_tpu_torch.engine.chunker import DeviceChunkHasher
        from volsync_tpu_torch.ops.gearcdc import DEFAULT_PARAMS

        self.device = resolve_device(device)
        self.params = params or DEFAULT_PARAMS
        self.segment_size = segment_size
        self.token = token or os.urandom(32).hex()
        self._hasher = DeviceChunkHasher(self.params, device=self.device)
        # The server manages its own batching: the process-wide shared
        # batcher must not override an explicit batch_window_ms=0
        # per-request configuration.
        self._hasher.use_shared_batcher = False
        self._batcher = None
        if batch_window_ms > 0 and self.params.align == 4096:
            if pipeline_depth is None:
                pipeline_depth = envflags.batch_pipeline_depth()
            self._batcher = SegmentMicroBatcher(
                self.params, window_ms=batch_window_ms,
                max_batch=max_workers, pipeline_depth=pipeline_depth,
                device=self.device)

        self.tenants = tenants if tenants is not None \
            else TenantRegistry.from_env()
        # The WDRR scheduler rides the batcher; the per-request dispatch
        # path (batch_window_ms=0 or unaligned params) keeps its direct
        # per-handler dispatch and is still admission-gated.
        self._scheduler = None
        if self._batcher is not None:
            self._scheduler = SegmentScheduler(
                self._batcher, self.tenants, quantum=scheduler_quantum)
        if isinstance(breaker, str):
            from volsync_tpu_torch.resilience import breaker_for

            breaker = breaker_for(breaker)
        elif breaker is None:
            backend = envflags.svc_breaker_backend()
            if backend:
                from volsync_tpu_torch.resilience import breaker_for

                breaker = breaker_for(backend)
        self._admission = admission if admission is not None else \
            AdmissionController(
                self.tenants, max_streams=max_streams,
                tenant_streams=tenant_streams, max_queued=max_queued,
                breaker=breaker,
                queue_depth_fn=(self._scheduler.queued_total
                                if self._scheduler is not None else None),
                sibling_fn=sibling_fn)
        self._stream_credits = (envflags.svc_stream_credits()
                                if stream_credits is None
                                else max(1, stream_credits))
        if deadline_classes is None:
            deadline_classes = parse_deadline_classes(
                envflags.svc_deadline_spec() or "")
        self.deadline_classes = deadline_classes

        serialize = lambda m: m.SerializeToString()  # noqa: E731
        handlers = {
            "ChunkHash": grpc.stream_stream_rpc_method_handler(
                self._chunk_hash, pb.DataSegment.FromString, serialize),
            "HashSpans": grpc.unary_unary_rpc_method_handler(
                self._hash_spans, pb.HashSpansRequest.FromString, serialize),
            "Info": grpc.unary_unary_rpc_method_handler(
                self._info, pb.InfoRequest.FromString, serialize),
        }
        self._server = grpc.server(
            ThreadPoolExecutor(max_workers=max_workers),
            interceptors=[_TokenInterceptor(self.token, self.tenants)],
        )
        self._server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),
        ))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self.host = host

    @property
    def admission(self) -> AdmissionController:
        return self._admission

    @property
    def scheduler(self) -> Optional[SegmentScheduler]:
        return self._scheduler

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MoverJaxServer":
        self._server.start()
        log.info("mover-jax serving on %s:%d", self.host, self.port)
        return self

    def stop(self, grace: float = 2.0, drain: Optional[float] = None):
        """Drain-then-stop, deterministically ordered:

        1. close admission — new streams shed with UNAVAILABLE;
        2. wait up to ``drain`` (VOLSYNC_SVC_DRAIN_S) for in-flight
           streams to finish on their own;
        3. stop the scheduler — stragglers' pending segments fail with
           SchedulerStopped, which their handlers surface as a clean
           UNAVAILABLE (never a half-written final batch);
        4. stop the gRPC server (bounded ``grace``), then the batcher.
        """
        if drain is None:
            drain = envflags.svc_drain_seconds()
        self._admission.begin_drain()
        drained = self._admission.wait_idle(drain)
        if not drained:
            log.warning("mover-jax stop: %d stream(s) still in flight "
                        "after %.1fs drain; aborting them",
                        self._admission.active_streams(), drain)
        if self._scheduler is not None:
            self._scheduler.stop()
        self._server.stop(grace).wait()
        if self._batcher is not None:
            self._batcher.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- methods -------------------------------------------------------------

    def _chunk_hash(self, request_iterator, context):
        """Admission-gated streaming CDC: tenant resolution + admission
        BEFORE the first byte is read, then the carry-the-tail protocol
        of engine/chunker.stream_chunks — a remote stream chunks
        bit-identically to a local scan of the same bytes.

        Tracing: the client's ``x-volsync-trace`` header (or a fresh
        root when absent/malformed) becomes this stream's TraceContext;
        the whole handler is one ``svc.stream`` span, admission and the
        scheduler/device spans nest under it, and the ticket carries
        the context across the scheduler thread seam. Spans are
        recorded via an explicit handle, not a contextvar held across
        ``yield`` — a generator's context leaks into whichever thread
        consumes it."""
        meta = dict(context.invocation_metadata())
        tenant = self._admission.tenant_from(meta)
        tctx = parse_trace_header(meta.get(TRACE_METADATA_KEY))
        if tctx is not None:
            # the tenant claim is resolved server-side (token-scoped);
            # never trust one riding the trace header
            tctx = tctx.evolve(tenant=tenant)
        else:
            tctx = new_trace(tenant=tenant)
        handle = begin_span("svc.stream", ctx=tctx)
        stream_ctx = tctx.child(handle.span_id)
        try:
            with use_context(stream_ctx):
                ticket = self._admission.admit_stream(tenant)
        except AdmissionRejected as rej:
            handle.finish("error")
            trailing = [(RETRY_AFTER_METADATA_KEY,
                         str(max(1, int(rej.retry_after * 1000))))]
            if rej.sibling:
                trailing.append((SIBLING_METADATA_KEY, rej.sibling))
            context.set_trailing_metadata(tuple(trailing))
            code = (grpc.StatusCode.UNAVAILABLE if rej.reason == "draining"
                    else grpc.StatusCode.RESOURCE_EXHAUSTED)
            context.abort(code, str(rej))
            return  # pragma: no cover — abort raises
        ticket.trace = stream_ctx
        # deadline class rides request metadata; an unknown class name
        # degrades to no deadline (never rejects the stream)
        cls = meta.get(DEADLINE_CLASS_METADATA_KEY)
        if cls is not None:
            ticket.deadline = self.deadline_classes.get(str(cls))
        try:
            # Client-paced waits (pulling request frames, the consumer
            # draining a yielded batch) happen INSIDE the svc.stream
            # span but outside every server component span; timing
            # them as svc.ingest/svc.emit makes the per-tenant stage
            # breakdown account for the stream span even when the
            # client thread is starved for CPU.
            inner = self._serve_stream(
                _timed_ingest(request_iterator, stream_ctx), ticket)
            for batch in inner:
                emit = begin_span("svc.emit", ctx=stream_ctx)
                try:
                    yield batch
                except BaseException:
                    emit.finish("error")
                    raise
                emit.finish("ok")
        except DeadlineExceeded as exc:
            handle.finish("error")
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(exc))
        except (SchedulerStopped, BatcherStopped):
            handle.finish("error")
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          "server shutting down")
        except BaseException:
            handle.finish("error")
            raise
        else:
            handle.finish("ok")
        finally:
            self._admission.release(ticket)

    def _submit_segment(self, ticket, data: bytes, eof: bool) -> Future:
        """One segment into the scheduler (fair, windowed) or the
        direct dispatch path; the future resolves with
        (chunks, consumed_hint)."""
        if self._scheduler is not None:
            return self._scheduler.submit(ticket.tenant, data,
                                          len(data), eof,
                                          ctx=ticket.trace,
                                          deadline=ticket.deadline)
        f: Future = Future()
        handle = begin_span("svc.batch", ctx=ticket.trace)
        try:
            if self._batcher is not None:
                f.set_result(self._batcher.submit(data, len(data), eof))
            else:
                with use_context(ticket.trace):
                    out = self._hasher.process(
                        np.frombuffer(data, np.uint8), eof=eof)
                f.set_result((out, 0))
            handle.finish("ok")
        except BaseException as exc:
            handle.finish("error")
            f.set_exception(exc)
        return f

    def _serve_stream(self, request_iterator, ticket):
        """The streaming loop, with a credit-based pause: while one
        segment is in flight on the device, the handler keeps reading
        request bytes only up to ``stream_credits`` further segments'
        worth — past that it blocks on the in-flight result, gRPC flow
        control pauses the sender, and server-side buffering stays
        bounded no matter how slow the device or how greedy the
        client."""
        # gRPC frames buffered UNJOINED: each pb frame is immutable
        # bytes, so the rolling buffer is a deque of them plus a
        # consumed-prefix offset into the head frame. The old bytearray
        # paid two full copies per segment (append into the rolling
        # buffer, then a bytes() snapshot at flush); this pays at most
        # one — the assemble join — and zero for single-frame segments.
        pieces: deque = deque()
        head = 0          # consumed prefix of pieces[0]
        plen = 0          # logical bytes buffered
        base = 0
        p = self.params
        cut = self.segment_size + p.max_size
        credit_bytes = self._stream_credits * cut
        inflight: Optional[tuple[Future, bool]] = None

        def assemble():
            # one snapshot of the WHOLE buffer: frames are immutable,
            # so views/joins over them are stable while the device
            # works and later appends don't disturb the consumed prefix
            if not pieces:
                return b""
            if len(pieces) == 1:
                if head == 0:
                    return pieces[0]  # zero-copy pass-through
                return memoryview(pieces[0])[head:]
            out = b"".join([memoryview(pieces[0])[head:],
                            *list(pieces)[1:]])
            record_copy("svc.frame", len(out))
            return out

        def collect(handle) -> pb.ChunkBatch:
            nonlocal base, head, plen
            fut, eof = handle
            out, _ = fut.result(timeout=600)
            batch = pb.ChunkBatch(final=eof)
            consumed = 0
            for start, length, digest in out:
                batch.chunks.append(pb.Chunk(
                    offset=base + start, length=length, digest=digest))
                consumed = start + length
            base += consumed
            # drop the consumed prefix frame by frame; only the head
            # frame's offset moves — no bytes shift
            plen -= consumed
            drop = consumed
            while drop:
                avail = len(pieces[0]) - head
                if avail <= drop:
                    pieces.popleft()
                    head = 0
                    drop -= avail
                else:
                    head += drop
                    drop = 0
            return batch

        def flush(eof: bool) -> tuple[Future, bool]:
            return (self._submit_segment(ticket, assemble(), eof), eof)

        for seg in request_iterator:
            if seg.data:
                pieces.append(seg.data)
                plen += len(seg.data)
            if inflight is not None and inflight[0].done():
                yield collect(inflight)
                inflight = None
            if inflight is None and plen >= cut:
                inflight = flush(False)
            while inflight is not None and plen >= credit_bytes:
                # credits exhausted: stop reading, wait out the device
                yield collect(inflight)
                inflight = None
                if plen >= cut:
                    inflight = flush(False)
            if inflight is not None:
                ticket.buffered_high_water = max(
                    ticket.buffered_high_water, plen)
            if seg.eof:
                if inflight is not None:
                    yield collect(inflight)
                    inflight = None
                yield collect(flush(True))
                return
        # Stream ended without an eof marker: finalize what we have
        # (client disconnect mid-stream just drops the call).
        if inflight is not None:
            yield collect(inflight)
            inflight = None
        yield collect(flush(True))

    def _hash_spans(self, request: pb.HashSpansRequest, context):
        from volsync_tpu_torch.engine.chunker import hash_spans

        spans = [(s.offset, s.length) for s in request.spans]
        for off, length in spans:
            if off + length > len(request.data):
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              "span out of range")
        return pb.HashSpansResponse(
            digests=hash_spans(request.data, spans, device=self.device))

    def _info(self, request: pb.InfoRequest, context):
        return pb.InfoResponse(
            backend=self.device.type,
            min_size=self.params.min_size, avg_size=self.params.avg_size,
            max_size=self.params.max_size, align=self.params.align)
