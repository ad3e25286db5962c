"""mover-jax typed client.

Ports ``volsync_tpu/service/client.py`` whole: it speaks the
reference's wire, so it works against either package's server.

What a remote mover links against instead of a local engine: stream a
volume (any ``reader(n)``) to the service and iterate finalized chunks;
batch-hash spans; discover the serving backend. Every call carries the
service token (server aborts UNAUTHENTICATED otherwise) and, when
given, an ``x-volsync-tenant`` claim so the service plane's admission
controller and fair scheduler know whose quota the work bills to.

When the server sheds a stream at admission (RESOURCE_EXHAUSTED with
an ``x-volsync-retry-after-ms`` trailing-metadata hint), the raw
grpc.RpcError is translated into :class:`ShedError` — a typed
resilience.ThrottleError subclass carrying ``retry_after`` seconds —
so callers (and RetryPolicy's classifier) see a throttle, not an
opaque RPC failure.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import grpc

from volsync_tpu_torch.obs import (begin_span, format_trace_header, new_id,
                                   new_trace, record_copy)
from volsync_tpu_torch.resilience import RetryPolicy, ThrottleError
from volsync_tpu_torch.service import moverjax_pb2 as pb
from volsync_tpu_torch.service.server import (
    DEADLINE_CLASS_METADATA_KEY,
    RETRY_AFTER_METADATA_KEY,
    SERVICE_NAME,
    SIBLING_METADATA_KEY,
    TOKEN_METADATA_KEY,
    TRACE_METADATA_KEY,
)
from volsync_tpu_torch.service.tenants import TENANT_METADATA_KEY

_SEND_CHUNK = 4 * 1024 * 1024


class ShedError(ThrottleError):
    """The service shed this call at admission. ``retry_after`` is the
    server's hint in seconds (falls back to 0.1 when the trailing
    metadata is missing); ``sibling`` is the ``host:port`` of a fleet
    sibling with headroom (None outside fleet mode) — retry THERE.
    Subclasses ThrottleError so resilience.classify treats a shed as
    retryable backpressure."""

    def __init__(self, message: str, retry_after: float = 0.1,
                 sibling: Optional[str] = None):
        super().__init__(message)
        self.retry_after = retry_after
        self.sibling = sibling


def shed_from_rpc(err: grpc.RpcError) -> Optional[ShedError]:
    """RESOURCE_EXHAUSTED RpcError -> ShedError (else None), reading
    the retry-after hint and sibling address from trailing metadata.
    Exposed for tests and for callers driving the raw stubs."""
    code = getattr(err, "code", None)
    if not callable(code) or code() != grpc.StatusCode.RESOURCE_EXHAUSTED:
        return None
    retry_after = 0.1
    sibling = None
    trailing = getattr(err, "trailing_metadata", None)
    pairs = trailing() if callable(trailing) else None
    for key, value in pairs or ():
        if key == RETRY_AFTER_METADATA_KEY:
            try:
                retry_after = max(0.001, float(value) / 1000.0)
            except ValueError:
                pass  # unparsable hint: keep the default
        elif key == SIBLING_METADATA_KEY:
            sibling = str(value) or None
    details = getattr(err, "details", None)
    message = details() if callable(details) else str(err)
    return ShedError(message or "shed at admission", retry_after,
                     sibling=sibling)


class MoverJaxClient:
    """``deadline_class`` (fleet deadline scheduling) names the
    scheduler class this client's segments bill to — rides
    ``x-volsync-deadline-class`` request metadata; None = no class
    (pure WDRR)."""

    def __init__(self, address: str, port: int, token: str,
                 timeout: float = 60.0, tenant: Optional[str] = None,
                 deadline_class: Optional[str] = None):
        self._channel = grpc.insecure_channel(f"{address}:{port}")
        meta = [(TOKEN_METADATA_KEY, token)]
        if tenant:
            meta.append((TENANT_METADATA_KEY, tenant))
        if deadline_class:
            meta.append((DEADLINE_CLASS_METADATA_KEY, deadline_class))
        self._meta = tuple(meta)
        self.tenant = tenant
        self.deadline_class = deadline_class
        self._timeout = timeout
        # Unary calls retry under the shared policy (grpc.RpcError's
        # .code() is classified: UNAVAILABLE-family retries,
        # UNAUTHENTICATED/INVALID_ARGUMENT... is fatal). chunk_stream
        # does NOT retry — a partially consumed reader() stream cannot
        # be replayed; its caller owns re-driving the whole transfer.
        self._policy = RetryPolicy.from_env("service.client",
                                            call_timeout=timeout)
        ser = lambda m: m.SerializeToString()  # noqa: E731
        self._chunk_hash = self._channel.stream_stream(
            f"/{SERVICE_NAME}/ChunkHash",
            request_serializer=ser,
            response_deserializer=pb.ChunkBatch.FromString)
        self._hash_spans = self._channel.unary_unary(
            f"/{SERVICE_NAME}/HashSpans",
            request_serializer=ser,
            response_deserializer=pb.HashSpansResponse.FromString)
        self._info = self._channel.unary_unary(
            f"/{SERVICE_NAME}/Info",
            request_serializer=ser,
            response_deserializer=pb.InfoResponse.FromString)

    def close(self):
        self._channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- calls ---------------------------------------------------------------

    def chunk_stream(self, reader: Callable[[int], bytes],
                     ) -> Iterator[tuple[int, int, str]]:
        """Stream ``reader`` to the service -> (offset, length, digest)
        per finalized chunk, in order, covering the whole stream.

        Each call is the root of a fresh trace (tenant + generated
        stream id) whose context rides ``x-volsync-trace`` metadata, so
        the server's svc.* spans join this client span in one
        flight-recorder trace. The span is handle-based, not a
        contextvar held across ``yield`` — a generator's context would
        leak into the consuming thread between iterations."""
        tctx = new_trace(tenant=self.tenant, stream_id=new_id())
        handle = begin_span("client.chunk_stream", ctx=tctx)
        meta = self._meta + ((TRACE_METADATA_KEY,
                              format_trace_header(tctx.child(handle.span_id))),)

        def segments():
            while True:
                piece = reader(_SEND_CHUNK)
                if not piece:
                    yield pb.DataSegment(data=b"", eof=True)
                    return
                if not isinstance(piece, bytes):
                    # protobuf bytes fields reject memoryview — the
                    # wire frame is the one sanctioned materialization
                    # on this path
                    piece = bytes(piece)
                    record_copy("svc.frame", len(piece))
                yield pb.DataSegment(data=piece)

        call = self._chunk_hash(segments(), metadata=meta,
                                timeout=self._timeout)
        ok = False
        try:
            for batch in call:
                for c in batch.chunks:
                    yield int(c.offset), int(c.length), c.digest
            ok = True
        except grpc.RpcError as err:
            shed = shed_from_rpc(err)
            if shed is not None:
                raise shed from err
            raise
        finally:
            handle.finish("ok" if ok else "error")

    def chunk_bytes(self, data) -> list[tuple[int, int, str]]:
        """Chunk one in-memory buffer (bytes/bytearray/memoryview).
        The reader serves zero-copy memoryview slices; the only copy
        left on this path is the wire frame (see chunk_stream)."""
        view = memoryview(data).toreadonly()
        pos = [0]

        def read(n: int):
            piece = view[pos[0]: pos[0] + n]
            pos[0] += len(piece)
            return piece

        return list(self.chunk_stream(read))

    def _unary(self, stub, request):
        """Policy-wrapped unary call; sheds surface as ShedError (a
        ThrottleError, so the policy retries them like any throttle,
        and an exhausted deadline still carries the typed error)."""

        def invoke():
            try:
                return stub(request, metadata=self._meta,
                            timeout=self._timeout)
            except grpc.RpcError as err:
                shed = shed_from_rpc(err)
                if shed is not None:
                    raise shed from err
                raise

        return self._policy.call(invoke)

    def hash_spans(self, data: bytes,
                   spans: list[tuple[int, int]]) -> list[str]:
        req = pb.HashSpansRequest(data=data)
        for off, length in spans:
            req.spans.append(pb.Span(offset=off, length=length))
        return list(self._unary(self._hash_spans, req).digests)

    def info(self) -> pb.InfoResponse:
        return self._unary(self._info, pb.InfoRequest())


def open_client(address: str, port: int, token: str,
                tenant: Optional[str] = None,
                deadline_class: Optional[str] = None) -> MoverJaxClient:
    return MoverJaxClient(address, port, token, tenant=tenant,
                          deadline_class=deadline_class)
