"""The port's mover-jax service (``volsync_tpu_torch/service/``) against
the JAX package's, on the CPU (``device="cpu"``).

The wire is shared: the same salted payloads give identical (offset,
length, id) lists through either package's server with either
package's client, ``HashSpans`` is equal, and both equal a local scan.
Then the cases of ``tests/test_service_plane.py`` (tenancy, admission,
the WDRR scheduler, auth, the typed shed, drain-then-stop, the
closed-loop acceptance through ``tools/service_bench``), the deadline
classes of ``tests/test_fleet.py`` with an unknown class name degrading
to no deadline, the service cases of ``tests/test_network_plane.py``
and the three of ``tests/test_service_chaos.py``, on the port. Sizes
follow ``tests/test_network_plane.py`` (64-256 KiB segments, payloads
of at most ~1 MiB), with one torch thread: the SHA twins cost ~10-20
ms a compression step here. Latency bounds the CPU cannot keep live in
``chip_smoke.py``'s service phase.
"""

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import grpc
import numpy as np
import pytest
import torch

import volsync_tpu.service as jsvc
from volsync_tpu.ops.gearcdc import GearParams as JParams
from volsync_tpu_torch.engine.chunker import DeviceChunkHasher
from volsync_tpu_torch.metrics import GLOBAL as METRICS
from volsync_tpu_torch.objstore.faultstore import (
    FaultSchedule,
    FaultSpec,
    FaultStore,
)
from volsync_tpu_torch.objstore.store import FsObjectStore
from volsync_tpu_torch.ops.gearcdc import GearParams
from volsync_tpu_torch.repo import blobid
from volsync_tpu_torch.resilience import (
    CircuitBreaker,
    ResilientStore,
    RetryPolicy,
    ThrottleError,
    TransientError,
    classify,
)
from volsync_tpu_torch.service import (
    MoverJaxClient,
    MoverJaxServer,
    ShedError,
    TenantConfig,
    TenantRegistry,
)
from volsync_tpu_torch.service.admission import (
    AdmissionController,
    AdmissionRejected,
)
from volsync_tpu_torch.service.client import shed_from_rpc
from volsync_tpu_torch.service.scheduler import (
    DEFAULT_DEADLINE_CLASSES,
    DeadlineExceeded,
    SchedulerStopped,
    SegmentScheduler,
    parse_deadline_classes,
)
from volsync_tpu_torch.service.server import RETRY_AFTER_METADATA_KEY
from volsync_tpu_torch.service.tenants import sanitize_tenant
from volsync_tpu_torch.tools.service_bench import run_closed_loop

torch.set_num_threads(1)

P4K = dict(min_size=4096, avg_size=32768, max_size=65536, align=4096)
#: tests/test_network_plane.py's params: align 64, the per-request path
P64 = dict(min_size=4096, avg_size=16384, max_size=65536)
SEG = 128 * 1024


def _local(params: dict, data: bytes) -> list:
    return DeviceChunkHasher(GearParams(**params), device="cpu").process(
        np.frombuffer(data, np.uint8), eof=True)


def _reader(buf: bytes, piece: int = 65536):
    pos = [0]

    def read(n):
        chunk = buf[pos[0]: pos[0] + min(n, piece)]
        pos[0] += len(chunk)
        return chunk

    return read


def _wait_admitted(srv, timeout=5.0):
    deadline = time.monotonic() + timeout
    while srv.admission.active_streams() == 0:
        assert time.monotonic() < deadline
        time.sleep(0.01)


# -- the shared wire: both servers, both clients ------------------------------

@pytest.fixture(scope="module", params=["P4K", "P64"])
def servers(request):
    """(params, {"port": server, "ref": server}) at one chunker: P4K
    runs both servers' scheduler + micro-batcher, P64 their per-request
    path."""
    params = {"P4K": P4K, "P64": P64}[request.param]
    port = MoverJaxServer(params=GearParams(**params), segment_size=SEG,
                          batch_window_ms=10.0, device="cpu").start()
    ref = jsvc.MoverJaxServer(params=JParams(**params), segment_size=SEG,
                              batch_window_ms=10.0).start()
    yield params, {"port": port, "ref": ref}
    port.stop(grace=0.5, drain=1.0)
    ref.stop(grace=0.5, drain=1.0)


CLIENTS = {"port": MoverJaxClient, "ref": jsvc.MoverJaxClient}


def test_streams_equal_across_packages(servers):
    """One salted payload through every (client, server) pairing: the
    (offset, length, id) lists are identical and equal a local scan;
    the chunks tile the payload and the first id is hashlib's."""
    params, srvs = servers
    base = np.random.RandomState(7).randint(0, 256, 200_001, np.uint8)
    data = (base ^ np.uint8(3)).tobytes()
    got = {}
    for sname, srv in srvs.items():
        for cname, client in CLIENTS.items():
            with client("127.0.0.1", srv.port, srv.token) as c:
                got[(cname, sname)] = c.chunk_bytes(data)
    want = _local(params, data)
    assert all(v == want for v in got.values()), sorted(got)
    assert b"".join(data[o: o + n] for o, n, _ in want) == data
    o, n, d = want[0]
    assert d == blobid.blob_id(data[o: o + n])


def test_hash_spans_and_info_across_packages(servers):
    params, srvs = servers
    rng = np.random.RandomState(5)
    blobs = [b"", b"x", rng.bytes(5000), rng.bytes(70_000)]
    buf = b"".join(blobs)
    spans, off = [], 0
    for b in blobs:
        spans.append((off, len(b)))
        off += len(b)
    want = [blobid.blob_id(b) for b in blobs]
    for sname, srv in srvs.items():
        for cname, client in CLIENTS.items():
            with client("127.0.0.1", srv.port, srv.token) as c:
                assert c.hash_spans(buf, spans) == want, (cname, sname)
                info = c.info()
            assert info.backend == "cpu"
            assert (info.min_size, info.avg_size, info.max_size) == (
                params["min_size"], params["avg_size"], params["max_size"])
            assert info.align == params.get("align", 64)


def test_streaming_segmentation_is_invisible(servers):
    """Feeding the stream in awkward piece sizes changes no boundary
    (the carry-the-tail protocol)."""
    params, srvs = servers
    data = np.random.RandomState(9).bytes(200_001)
    srv = srvs["port"]
    with MoverJaxClient("127.0.0.1", srv.port, srv.token) as c:
        dribbled = list(c.chunk_stream(_reader(data, 37_777)))
    assert dribbled == _local(params, data)


@pytest.mark.parametrize("call", ["info", "chunk_stream"])
def test_bad_token_unauthenticated(servers, call):
    """A bad token draws UNAUTHENTICATED on the unary and on the
    streaming method (the deny handler matches the cardinality)."""
    _, srvs = servers
    srv = srvs["port"]
    with MoverJaxClient("127.0.0.1", srv.port, "wrong") as c:
        with pytest.raises(grpc.RpcError) as ei:
            if call == "info":
                c.info()
            else:
                c.chunk_bytes(b"z" * 8192)
    assert ei.value.code() == grpc.StatusCode.UNAUTHENTICATED


# -- the service's spans --------------------------------------------------------

def test_trace_header_and_tenant_attribution():
    """The ``x-volsync-trace`` header is the reference's string both ways;
    a handle span finished on another thread bills its trace's tenant;
    ``reset_spans`` zeroes the registry."""
    from volsync_tpu import obs as jobs
    from volsync_tpu_torch import obs

    ctx = obs.new_trace(tenant="gold", stream_id="s1")
    header = obs.format_trace_header(ctx)
    jctx = jobs.parse_trace_header(header)
    assert jobs.format_trace_header(jctx) == header
    back = obs.parse_trace_header(header)
    assert back == ctx.evolve(tenant=None)
    assert obs.parse_trace_header("a:b:c") is None
    assert obs.parse_trace_header("") is None
    obs.reset_spans()
    h = obs.begin_span("svc.batch", ctx=ctx)
    th = threading.Thread(target=h.finish, args=("error",))
    th.start()
    th.join(timeout=5)
    h.finish()  # idempotent
    with obs.trace_context(ctx), obs.span("svc.emit", lanes=2):
        pass
    with obs.span("ops.batch_dispatch", lanes=3):  # context-free
        pass
    assert {k: n for k, (n, _) in obs.span_totals().items()} == {
        "svc.batch": 1, "svc.emit": 1, "ops.batch_dispatch": 1}
    by_tenant = METRICS.svc_stage_seconds.values
    assert set(by_tenant()) == {("gold", "svc.batch"), ("gold", "svc.emit")}
    obs.reset_spans()
    assert obs.span_totals() == {} and by_tenant() == {}


# -- tenancy model -----------------------------------------------------------

def test_tenant_spec_round_trip():
    reg = TenantRegistry.from_spec(
        "gold:weight=4,streams=8,queued=64,token=tk;bronze:weight=1;;")
    assert reg.names() == ["bronze", "gold"]
    gold = reg.config("gold")
    assert (gold.weight, gold.max_streams, gold.max_queued, gold.token) \
        == (4, 8, 64, "tk")
    assert reg.config("nobody") == TenantConfig(name="nobody")
    assert reg.token_for("bronze") is None


def test_tenant_spec_rejects_typos_and_bad_weight():
    with pytest.raises(ValueError, match="unknown tenant spec field"):
        TenantRegistry.from_spec("gold:wieght=4")
    with pytest.raises(ValueError, match="weight"):
        TenantConfig(name="x", weight=0)


def test_sanitize_tenant_bounds_label_values():
    assert sanitize_tenant("") == "default"
    assert sanitize_tenant("Team.a_1-x") == "Team.a_1-x"
    assert sanitize_tenant("a\nb{evil}" + "c" * 200) == "abevil" + "c" * 58
    assert sanitize_tenant("\x00\x01") == "default"


# -- admission controller ----------------------------------------------------

def _controller(**kw):
    kw.setdefault("max_streams", 3)
    kw.setdefault("tenant_streams", 2)
    kw.setdefault("max_queued", 10)
    kw.setdefault("retry_after", 0.05)
    return AdmissionController(TenantRegistry(), **kw)


def test_admission_caps_global_and_per_tenant():
    ctrl = _controller()
    t1 = ctrl.admit_stream("a")
    ctrl.admit_stream("a")
    with pytest.raises(AdmissionRejected) as ei:
        ctrl.admit_stream("a")  # tenant cap (2)
    assert ei.value.reason == "tenant_streams"
    assert 0.05 <= ei.value.retry_after <= 0.5  # decorrelated jitter
    ctrl.admit_stream("b")
    with pytest.raises(AdmissionRejected) as ei:
        ctrl.admit_stream("b")  # global cap (3)
    assert ei.value.reason == "global_streams"
    ctrl.release(t1)
    ctrl.release(t1)  # idempotent: double release frees one slot only
    assert ctrl.active_streams() == 2
    ctrl.admit_stream("b")


def test_admission_tenant_override_beats_default():
    reg = TenantRegistry([TenantConfig(name="vip", max_streams=5)])
    ctrl = AdmissionController(reg, max_streams=10, tenant_streams=1,
                               max_queued=10)
    for _ in range(5):
        ctrl.admit_stream("vip")
    with pytest.raises(AdmissionRejected):
        ctrl.admit_stream("vip")


def test_admission_sheds_on_scheduler_backlog():
    depth = [0]
    ctrl = _controller(queue_depth_fn=lambda: depth[0])
    ctrl.admit_stream("a")
    depth[0] = 10
    with pytest.raises(AdmissionRejected) as ei:
        ctrl.admit_stream("a")
    assert ei.value.reason == "overload"


def test_admission_sheds_while_breaker_open_with_cooldown_hint():
    t = [100.0]
    brk = CircuitBreaker("svc-test", threshold=1, reset_seconds=30.0,
                         clock=lambda: t[0])
    brk.record_failure(TransientError("boom"))
    ctrl = _controller(breaker=brk, clock=lambda: t[0])
    t[0] += 10.0
    with pytest.raises(AdmissionRejected) as ei:
        ctrl.admit_stream("a")
    assert ei.value.reason == "breaker_open"
    assert ei.value.retry_after == pytest.approx(20.0)
    t[0] += 25.0  # past reset: the probe is due, admission reopens
    ctrl.release(ctrl.admit_stream("a"))


def test_admission_drain_then_idle():
    ctrl = _controller()
    ticket = ctrl.admit_stream("a")
    ctrl.begin_drain()
    with pytest.raises(AdmissionRejected) as ei:
        ctrl.admit_stream("b")
    assert ei.value.reason == "draining"
    assert not ctrl.wait_idle(0.05)
    ctrl.release(ticket)
    assert ctrl.wait_idle(1.0)


def test_admission_drain_release_race_never_loses_wakeup():
    """``begin_drain`` racing the ``release`` of the last ticket always
    wakes ``wait_idle``: both set the idle event under the lock."""
    for i in range(200):
        ctrl = _controller()
        ticket = ctrl.admit_stream("a")
        start = threading.Barrier(3)
        woke = []

        def drainer():
            start.wait(timeout=5)
            ctrl.begin_drain()

        def releaser():
            start.wait(timeout=5)
            ctrl.release(ticket)

        def waiter():
            start.wait(timeout=5)
            woke.append(ctrl.wait_idle(5.0))

        threads = [threading.Thread(target=f)
                   for f in (drainer, releaser, waiter)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=10)
        assert not any(th.is_alive() for th in threads)
        assert woke == [True], f"lost wakeup on iteration {i}"
        assert ctrl.active_streams() == 0


# -- scheduler (driven via service_round) -------------------------------------

class _FakeBatcher:
    """Records submission order; resolves futures on demand."""

    _depth = 1
    _max_batch = 16

    def __init__(self):
        self.calls = []

    def submit_async(self, data, length, eof):
        f = Future()
        self.calls.append((data, length, eof, f))
        return f


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _drain_rounds(sched, limit=50):
    for _ in range(limit):
        if not sched.service_round():
            return


def test_wdrr_shares_follow_weights():
    """Equal backlogs, weights 3:1: about 3 gold segments dispatch per
    bronze one, FIFO within a tenant."""
    reg = TenantRegistry([TenantConfig(name="gold", weight=3),
                          TenantConfig(name="bronze", weight=1)])
    fb = _FakeBatcher()
    sched = SegmentScheduler(fb, reg, quantum=100, tenant_queued=64,
                             dispatch_window=1000, start=False)
    for i in range(12):
        sched.submit("gold", b"g%d" % i, 100, False)
        sched.submit("bronze", b"b%d" % i, 100, False)
    _drain_rounds(sched)
    order = [d[:1] for d, _, _, _ in fb.calls]
    assert len(fb.calls) == 24
    head = order[:16]
    assert head.count(b"g") == 12 and head.count(b"b") == 4
    golds = [d for d, _, _, _ in fb.calls if d.startswith(b"g")]
    assert golds == sorted(golds, key=lambda s: int(s[1:]))
    sched.stop()


def test_wdrr_large_segment_waits_for_deficit():
    fb = _FakeBatcher()
    sched = SegmentScheduler(fb, TenantRegistry(), quantum=100,
                             tenant_queued=8, dispatch_window=100,
                             start=False)
    sched.submit("t", b"big", 250, False)
    assert sched.service_round() and not fb.calls   # deficit 100
    assert sched.service_round() and not fb.calls   # deficit 200
    assert sched.service_round() and len(fb.calls) == 1  # 300 covers it
    assert not sched.service_round()
    sched.stop()


def test_scheduler_credit_pause_blocks_submit():
    """A tenant at its queue bound blocks in submit() until the
    scheduler drains a slot: the pause that stops a handler from
    pulling more request bytes."""
    fb = _FakeBatcher()
    sched = SegmentScheduler(fb, TenantRegistry(), quantum=10**6,
                             tenant_queued=2, dispatch_window=100,
                             start=False)
    sched.submit("t", b"1", 10, False)
    sched.submit("t", b"2", 10, False)
    entered = threading.Event()
    unblocked = threading.Event()

    def third():
        entered.set()
        sched.submit("t", b"3", 10, False)
        unblocked.set()

    th = threading.Thread(target=third, name="svc-test-blocked-submit")
    th.start()
    assert entered.wait(2.0)
    assert not unblocked.wait(0.3), "submit should block at the bound"
    _drain_rounds(sched)
    assert unblocked.wait(2.0), "drain must unblock the producer"
    th.join(timeout=5.0)
    assert not th.is_alive()
    _drain_rounds(sched)
    assert len(fb.calls) == 3
    sched.stop()


def test_scheduler_stop_fails_stranded_work():
    fb = _FakeBatcher()
    sched = SegmentScheduler(fb, TenantRegistry(), quantum=100,
                             tenant_queued=8, dispatch_window=100,
                             start=False)
    f = sched.submit("t", b"x", 10, False)
    sched.stop()
    with pytest.raises(SchedulerStopped):
        f.result(timeout=1.0)
    with pytest.raises(SchedulerStopped):
        sched.submit("t", b"y", 10, False)


def test_scheduler_chains_batcher_results():
    fb = _FakeBatcher()
    sched = SegmentScheduler(fb, TenantRegistry(), quantum=100,
                             tenant_queued=8, dispatch_window=100,
                             start=False)
    f = sched.submit("t", b"x", 10, True)
    _drain_rounds(sched)
    fb.calls[0][3].set_result(([(0, 10, "d")], 10))
    assert f.result(timeout=1.0) == ([(0, 10, "d")], 10)
    assert sched.dispatched_total == 1
    sched.stop()


# -- deadline classes ----------------------------------------------------------

def test_parse_deadline_classes():
    assert parse_deadline_classes("") == DEFAULT_DEADLINE_CLASSES
    got = parse_deadline_classes("fast=0.25, slow=none ,bulk=inf")
    assert got == {"fast": 0.25, "slow": None, "bulk": None}
    with pytest.raises(ValueError, match="bad deadline class"):
        parse_deadline_classes("fast")
    with pytest.raises(ValueError, match="must be > 0"):
        parse_deadline_classes("fast=-1")


def test_edf_within_tenant_then_expired_sheds_before_batcher():
    """Within a tenant the most urgent segment dispatches first and
    deadline-free ones keep FIFO order, last; a segment whose deadline
    passed while queued fails with DeadlineExceeded and never reaches
    the batcher."""
    fb = _FakeBatcher()
    clock = _Clock()
    sched = SegmentScheduler(fb, TenantRegistry(), quantum=1000,
                             tenant_queued=64, dispatch_window=1000,
                             clock=clock, start=False)
    sched.submit("t", b"free1", 10, False)
    sched.submit("t", b"lax", 10, False, deadline=9.0)
    sched.submit("t", b"urgent", 10, False, deadline=2.0)
    sched.submit("t", b"free2", 10, False)
    _drain_rounds(sched)
    assert [d for d, _, _, _ in fb.calls] \
        == [b"urgent", b"lax", b"free1", b"free2"]
    fb.calls.clear()
    counter = METRICS.svc_deadline_exceeded.labels(tenant="t")
    before = counter.value
    doomed = sched.submit("t", b"late", 10, False, deadline=0.5)
    ok = sched.submit("t", b"fine", 10, False)
    clock.now = 1.0
    _drain_rounds(sched)
    with pytest.raises(DeadlineExceeded) as ei:
        doomed.result(timeout=1)
    assert ei.value.tenant == "t"
    assert [d for d, _, _, _ in fb.calls] == [b"fine"]
    assert counter.value == before + 1
    fb.calls[0][3].set_result(([], 10))
    assert ok.result(timeout=1) == ([], 10)
    sched.stop()


@pytest.mark.parametrize("cls,want", [("interactive", 0.5),
                                      ("no-such-class", None)])
def test_deadline_class_metadata_reaches_the_ticket(cls, want):
    """The client's deadline class rides request metadata to the
    stream's ticket; an unknown class name degrades to no deadline and
    the stream completes."""
    seen = []
    with MoverJaxServer(params=GearParams(**P4K), segment_size=SEG,
                        device="cpu") as srv:
        submit = srv._submit_segment

        def spy(ticket, data, eof):
            seen.append(ticket.deadline)
            return submit(ticket, data, eof)

        srv._submit_segment = spy
        with MoverJaxClient("127.0.0.1", srv.port, srv.token,
                            deadline_class=cls) as c:
            data = np.random.RandomState(4).bytes(20_000)
            assert c.chunk_bytes(data) == _local(P4K, data)
    assert seen and set(seen) == {want}


# -- auth, the typed shed --------------------------------------------------------

def test_tenant_scoped_token():
    """A tenant with its own token must present it, on the unary and
    the streaming method; other tenants use the service token."""
    reg = TenantRegistry([TenantConfig(name="sec", token="tenant-secret")])
    with MoverJaxServer(params=GearParams(**P4K), segment_size=SEG,
                        token="service-secret", tenants=reg,
                        device="cpu") as srv:
        with MoverJaxClient("127.0.0.1", srv.port, "tenant-secret",
                            tenant="sec") as c:
            assert c.info().align == 4096
        with MoverJaxClient("127.0.0.1", srv.port, "service-secret",
                            tenant="sec") as c:
            with pytest.raises(grpc.RpcError) as ei:
                c.info()
        assert ei.value.code() == grpc.StatusCode.UNAUTHENTICATED
        with MoverJaxClient("127.0.0.1", srv.port, "service-secret",
                            tenant="sec") as c:
            with pytest.raises(grpc.RpcError) as ei:
                c.chunk_bytes(b"z" * 8192)
        assert ei.value.code() == grpc.StatusCode.UNAUTHENTICATED
        with MoverJaxClient("127.0.0.1", srv.port, "service-secret",
                            tenant="other") as c:
            assert c.info().align == 4096


class _FakeRpcError(grpc.RpcError):
    def __init__(self, code, trailing=(), details_text="shed"):
        self._code = code
        self._trailing = trailing
        self._details = details_text

    def code(self):
        return self._code

    def trailing_metadata(self):
        return self._trailing

    def details(self):
        return self._details


def test_shed_from_rpc_classification():
    err = _FakeRpcError(grpc.StatusCode.RESOURCE_EXHAUSTED,
                        ((RETRY_AFTER_METADATA_KEY, "250"),))
    shed = shed_from_rpc(err)
    assert isinstance(shed, ShedError)
    assert isinstance(shed, ThrottleError)
    assert classify(shed)
    assert shed.retry_after == pytest.approx(0.25)
    assert shed_from_rpc(_FakeRpcError(
        grpc.StatusCode.RESOURCE_EXHAUSTED)).retry_after == \
        pytest.approx(0.1)
    assert shed_from_rpc(_FakeRpcError(
        grpc.StatusCode.RESOURCE_EXHAUSTED,
        ((RETRY_AFTER_METADATA_KEY, "bogus"),))).retry_after == \
        pytest.approx(0.1)
    assert shed_from_rpc(
        _FakeRpcError(grpc.StatusCode.UNAVAILABLE)) is None


@pytest.mark.parametrize("client", ["port", "ref"])
def test_client_surfaces_shed_as_typed_error(client):
    """Server at max_streams=1, one stream parked in flight: the second
    stream draws the client package's ShedError with the server's
    retry-after hint."""
    shed_type = {"port": ShedError, "ref": jsvc.ShedError}[client]
    with MoverJaxServer(params=GearParams(**P4K), segment_size=SEG,
                        max_streams=1, batch_window_ms=0.0,
                        device="cpu") as srv:
        hold = threading.Event()
        started = threading.Event()

        def parked():
            def reader(n):
                if not started.is_set():
                    started.set()
                    return b"p" * 8192
                hold.wait(10.0)
                return b""

            with MoverJaxClient("127.0.0.1", srv.port, srv.token) as c:
                return list(c.chunk_stream(reader))

        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(parked)
            assert started.wait(5.0)
            _wait_admitted(srv)
            with CLIENTS[client]("127.0.0.1", srv.port, srv.token) as c:
                with pytest.raises(shed_type) as ei:
                    c.chunk_bytes(b"q" * 8192)
            assert ei.value.retry_after > 0
            hold.set()
            assert fut.result(timeout=10.0)


# -- concurrency: coalescing, drain, stop ------------------------------------------

def test_concurrent_tenant_streams_coalesce_bit_identically():
    """Six tenant-tagged streams through admission + WDRR + the
    micro-batcher: at least one multi-lane batched pass, and every
    stream chunks exactly like a local scan."""
    reg = TenantRegistry([TenantConfig(name="gold", weight=4),
                          TenantConfig(name="bronze", weight=1)])
    rng = np.random.RandomState(1234)
    payloads = [rng.bytes(100_000 + 17 * i) for i in range(6)]
    lanes = []
    with MoverJaxServer(params=GearParams(**P4K), segment_size=SEG,
                        batch_window_ms=100.0, tenants=reg,
                        device="cpu") as srv:
        assert srv.scheduler is not None
        real = srv._batcher._hasher.hash_segments

        def spy(items):
            lanes.append(len(items))
            return real(items)

        srv._batcher._hasher.hash_segments = spy

        def run(i):
            tenant = "gold" if i % 2 == 0 else "bronze"
            with MoverJaxClient("127.0.0.1", srv.port, srv.token,
                                tenant=tenant) as c:
                return c.chunk_bytes(payloads[i])

        with ThreadPoolExecutor(6) as pool:
            results = list(pool.map(run, range(6)))
        assert srv.admission.active_streams() == 0
    for data, got in zip(payloads, results):
        assert got == _local(P4K, data)
    assert any(n > 1 for n in lanes), lanes


def test_stop_drains_inflight_stream_to_completion():
    """stop() mid-stream: the in-flight stream completes with correct
    chunks, while a stream arriving after the drain began is shed."""
    data = np.random.RandomState(2).bytes(300_000)
    srv = MoverJaxServer(params=GearParams(**P4K), segment_size=SEG,
                         batch_window_ms=2.0, device="cpu").start()
    reading = threading.Event()
    result: dict = {}

    def read_slowly():
        pos = [0]

        def read(n):
            reading.set()
            time.sleep(0.05)  # stretch the stream across stop()
            piece = data[pos[0]: pos[0] + min(n, 65536)]
            pos[0] += len(piece)
            return piece

        return read

    def run_stream():
        with MoverJaxClient("127.0.0.1", srv.port, srv.token) as c:
            result["chunks"] = list(c.chunk_stream(read_slowly()))

    th = threading.Thread(target=run_stream, name="svc-test-drain-stream")
    th.start()
    assert reading.wait(5.0)
    _wait_admitted(srv)
    stopper = threading.Thread(target=lambda: srv.stop(drain=15.0),
                               name="svc-test-stopper")
    stopper.start()
    deadline = time.monotonic() + 5.0
    while True:
        try:
            srv.admission.admit_stream("late")
        except AdmissionRejected as rej:
            assert rej.reason == "draining"
            break
        assert time.monotonic() < deadline, "admission still open"
        time.sleep(0.01)
    th.join(timeout=60.0)
    stopper.join(timeout=60.0)
    assert not th.is_alive() and not stopper.is_alive()
    assert result["chunks"] == _local(P4K, data)


def test_stop_aborts_stuck_stream_cleanly():
    """A stream that never finishes cannot wedge stop(): past the drain
    window it ends with a clean terminal status."""
    srv = MoverJaxServer(params=GearParams(**P4K), segment_size=SEG,
                         device="cpu").start()
    hold = threading.Event()
    started = threading.Event()
    outcome: dict = {}

    def stuck():
        def read(n):
            if not started.is_set():
                started.set()
                return b"s" * 8192
            hold.wait(20.0)
            return b""

        try:
            with MoverJaxClient("127.0.0.1", srv.port, srv.token) as c:
                outcome["chunks"] = list(c.chunk_stream(read))
        except grpc.RpcError as e:
            outcome["code"] = e.code()

    th = threading.Thread(target=stuck, name="svc-test-stuck-stream")
    th.start()
    assert started.wait(5.0)
    _wait_admitted(srv)
    t0 = time.monotonic()
    srv.stop(grace=0.5, drain=0.3)
    assert time.monotonic() - t0 < 15.0, "stop() must be bounded"
    hold.set()
    th.join(timeout=10.0)
    assert not th.is_alive()
    assert outcome.get("code") in (grpc.StatusCode.UNAVAILABLE,
                                   grpc.StatusCode.CANCELLED), outcome


# -- the closed-loop acceptance (tools/service_bench) -------------------------------

def _bench_tenants():
    return [{"name": "gold", "weight": 4, "clients": 3},
            {"name": "bronze", "weight": 1, "clients": 3}]


def test_acceptance_coalescing_and_overload():
    """(a) cross-tenant coalescing survives scheduling; (b) under 2x
    overload the excess is shed at admission (zero mid-stream aborts)
    and every request completes."""
    res = run_closed_loop(
        tenants=_bench_tenants(), requests_per_client=1,
        mib_per_request=0.125, segment_kib=128, window_ms=100.0,
        params=GearParams(**P4K), warm=False, device="cpu",
        keep_chunks=True)
    assert res["mid_stream_aborts"] == []
    assert res["requests_total"] == 6
    assert res["coalesced"], (res["device_dispatches"],
                              res["segments_dispatched"])
    assert res["device_dispatches"] < res["segments_dispatched"]
    assert res["admitted_by_tenant"] == {"gold": 3.0, "bronze": 3.0}
    for name in ("gold", "bronze"):
        t = res["tenants"][name]
        assert t["requests"] == 3
        assert t["stages_s"]["svc.batch"] > 0  # spans bill to the tenant
    from volsync_tpu_torch.tools.service_bench import salted
    for i, lists in res["streams"].items():
        assert lists == [_local(P4K, salted(res["base"], i + 1).tobytes())]

    res = run_closed_loop(
        tenants=_bench_tenants(), requests_per_client=1,
        mib_per_request=1 / 16, segment_kib=64, window_ms=50.0,
        max_streams=3, params=GearParams(**P4K), warm=False, device="cpu")
    assert res["mid_stream_aborts"] == [], res["mid_stream_aborts"]
    assert res["shed_total"] > 0, "2x overload must shed at admission"
    assert res["requests_total"] == 6  # every request retries to done
    assert sum(res["shed_by_tenant"].values()) == res["shed_total"]


def test_acceptance_breaker_sheds_at_admission():
    """A forced-open breaker sheds at admission: the in-process decision
    is far under 10 ms, the RPC shed carries the cooldown hint."""
    res = run_closed_loop(tenants=_bench_tenants(), force_breaker=True,
                          mib_per_request=0.125, device="cpu")
    brk = res["breaker"]
    assert brk["direct_shed_p99_ms"] < 10.0, brk
    assert brk["rpc_shed_ms"] < 1_000.0, brk
    assert brk["retry_after_s"] > 0


# -- chaos: the service beside a faulted store ------------------------------------

def _chaos_stack(root, seed, specs, *, breaker=None, attempts=10):
    fs = FsObjectStore(str(root))
    faults = FaultStore(fs, FaultSchedule(seed=seed, specs=list(specs)))
    policy = RetryPolicy(site="svc-chaos", max_attempts=attempts,
                         base_delay=0.001, max_delay=0.01,
                         sleep_fn=lambda s: None)
    if breaker is None:
        breaker = CircuitBreaker("svc-chaos", threshold=10**9,
                                 reset_seconds=0.01)
    return fs, ResilientStore(faults, policy=policy, breaker=breaker)


def test_concurrent_streams_byte_correct_over_faulted_store(tmp_path):
    """Four tenant streams chunk through the scheduled service while
    their blobs land through a transient-faulted resilient store: every
    stream's chunks match a local scan and every blob reads back from
    the unfaulted layer."""
    fs, top = _chaos_stack(tmp_path / "store", seed=11, specs=[
        FaultSpec(kind="transient", p=0.2),
        FaultSpec(kind="latency", p=0.1, latency=0.002),
    ])
    reg = TenantRegistry([TenantConfig(name="gold", weight=3),
                          TenantConfig(name="bronze", weight=1)])
    rng = np.random.RandomState(8)
    payloads = [rng.bytes(120_000 + 31 * i) for i in range(4)]
    with MoverJaxServer(params=GearParams(**P4K), segment_size=SEG,
                        batch_window_ms=5.0, tenants=reg,
                        device="cpu") as srv:
        def mover(i):
            data = payloads[i]
            with MoverJaxClient("127.0.0.1", srv.port, srv.token,
                                tenant="gold" if i % 2 == 0
                                else "bronze") as c:
                chunks = c.chunk_bytes(data)
            for off, length, digest in chunks:
                top.put(f"chunks/{digest}", data[off:off + length])
            return chunks

        with ThreadPoolExecutor(4) as pool:
            results = list(pool.map(mover, range(4)))
    for data, chunks in zip(payloads, results):
        assert chunks == _local(P4K, data)
        for off, length, digest in chunks:
            assert fs.get(f"chunks/{digest}") == data[off:off + length]


def test_store_breaker_open_sheds_streams_at_admission(tmp_path):
    """The store's breaker, opened by a hammered store, sheds every new
    stream at admission before any chunk batch, with its cooldown as
    the hint; the decision itself takes under 10 ms."""
    breaker = CircuitBreaker("svc-chaos-sick", threshold=2,
                             reset_seconds=60.0)
    _, top = _chaos_stack(
        tmp_path / "store", seed=3,
        specs=[FaultSpec(kind="transient", p=1.0, op="put")],
        breaker=breaker, attempts=2)
    with pytest.raises(TransientError):
        top.put("chunks/doomed", b"x")
    assert breaker.open_remaining() > 0
    with MoverJaxServer(params=GearParams(**P4K), segment_size=SEG,
                        breaker=breaker, device="cpu") as srv:
        batches = [0]

        def reader(n):
            return b"z" * 8192 if batches[0] == 0 else b""

        with MoverJaxClient("127.0.0.1", srv.port, srv.token) as c:
            with pytest.raises(ShedError) as ei:
                for _ in c.chunk_stream(reader):
                    batches[0] += 1
        assert batches[0] == 0, "shed must precede any batch"
        assert 0 < ei.value.retry_after <= 60.0
        t0 = time.perf_counter()
        with pytest.raises(AdmissionRejected) as rej:
            srv.admission.admit_stream("anyone")
        assert rej.value.reason == "breaker_open"
        assert time.perf_counter() - t0 < 0.010


def test_overload_sheds_never_abort_admitted_work():
    """Six clients against two stream slots: some are shed (typed, no
    batch seen), and every admitted stream completes byte-correct. (A
    50 ms window lets the two admitted streams share a pass: the CPU
    twins slow down several-fold when threads run them at once.)"""
    rng = np.random.RandomState(6)
    payloads = [rng.bytes(60_000 + 13 * i) for i in range(6)]
    sheds, lock = [], threading.Lock()
    with MoverJaxServer(params=GearParams(**P4K), segment_size=SEG,
                        batch_window_ms=50.0, max_streams=2,
                        max_workers=10, device="cpu") as srv:
        def run(i):
            while True:
                got = []
                try:
                    with MoverJaxClient("127.0.0.1", srv.port,
                                        srv.token) as c:
                        for tup in c.chunk_stream(_reader(payloads[i])):
                            got.append(tup)
                    return got
                except ShedError as e:
                    assert got == [], "shed must precede any batch"
                    with lock:
                        sheds.append(e.retry_after)
                    time.sleep(min(e.retry_after, 0.05))

        with ThreadPoolExecutor(6) as pool:
            results = list(pool.map(run, range(6)))
    for data, chunks in zip(payloads, results):
        assert chunks == _local(P4K, data)
    assert sheds and all(r > 0 for r in sheds)
