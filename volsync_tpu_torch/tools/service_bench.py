"""mover-jax closed-loop multi-tenant service benchmark on the port.

Ports ``run_closed_loop`` and the breaker shed phase of
``scripts/service_bench.py``. N closed-loop clients across tenants each
drive sequential ChunkHash streams against the port's
``MoverJaxServer`` (admission + weighted-DRR scheduling + the segment
micro-batcher, or the per-request path with ``window_ms=0``), and the
report is per tenant (p50/p99 request latency, goodput, admitted and
shed counts, seconds by ``svc.*`` stage) plus plane-wide evidence that
cross-tenant coalescing survived scheduling (device dispatches fewer
than segments) and that overload was absorbed at admission (zero
mid-stream aborts). There is no fleet mode and no dispatch-fault
injection.

Every client streams its own salted copy of one seeded base payload
(``base ^ salt``, salt ``i + 1`` timed and ``128 + i`` warm), generated
piece by piece as the client sends it, so host memory holds the base
and the pieces in flight, not every client's payload. Salting keeps the
streams distinct.

    python -m volsync_tpu_torch.tools.service_bench \\
        [--tenants gold:4:2;bronze:1:2] [--requests 3] [--mib 16]
        [--segment-kib 32768] [--window-ms 2] [--device cuda]

prints one JSON line (``--device cpu`` runs the plain twins).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import threading
import time

import numpy as np

#: Bytes a client read hands to one DataSegment: gRPC's default 4 MiB
#: receive cap leaves no room for a 4 MiB payload plus its framing.
PIECE = 1024 * 1024


def salted(base: np.ndarray, salt: int) -> np.ndarray:
    """A client's whole payload: the base XOR its salt byte."""
    return base ^ np.uint8(salt)


def _salted_reader(base: np.ndarray, salt: int, piece: int = PIECE):
    """``reader(n)`` over ``salted(base, salt)``, made piece by piece."""
    pos = [0]

    def read(nbytes: int) -> bytes:
        start = pos[0]
        end = min(start + min(nbytes, piece), base.shape[0])
        pos[0] = end
        return (base[start:end] ^ np.uint8(salt)).tobytes()

    return read


def _percentile(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q)) \
        if xs else 0.0


def parse_tenants(spec: str) -> list[dict]:
    """``name:weight:clients;...`` -> [{name, weight, clients}, ...]."""
    out = []
    for entry in filter(None, (e.strip() for e in spec.split(";"))):
        parts = entry.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"tenant spec entry {entry!r} is not name:weight:clients")
        out.append({"name": parts[0], "weight": int(parts[1]),
                    "clients": int(parts[2])})
    if not out:
        raise ValueError("empty tenant spec")
    return out


class _TenantTally:
    """Per-tenant closed-loop accounting, shared by that tenant's
    client threads."""

    def __init__(self):
        self.lock = threading.Lock()
        self.latencies: list[float] = []
        self.shed_latencies: list[float] = []
        self.bytes = 0
        self.requests = 0
        self.sheds = 0
        self.mid_stream_aborts: list[str] = []


def _spy_dispatches(srv, dispatch_log: list):
    """Record the lanes of every device pass the server makes: the
    batcher's batched passes, or (per-request path) each segment the
    handler hashes alone. Returns a function that removes the spy."""
    lock = threading.Lock()
    if srv._batcher is not None:
        owner, name, lanes = srv._batcher._hasher, "hash_segments", len
    else:
        owner, name, lanes = srv._hasher, "begin_device", \
            lambda *a, **k: 1
    inner = getattr(owner, name)

    def spy(*args, **kwargs):
        with lock:
            dispatch_log.append(lanes(*args, **kwargs))
        return inner(*args, **kwargs)

    setattr(owner, name, spy)
    return lambda: setattr(owner, name, inner)


def _run_clients(make_client, tenants: list[dict], base: np.ndarray,
                 salt_for, requests_per_client: int, tallies: dict,
                 streams: dict | None = None) -> float:
    """Closed loop: every client drives ``requests_per_client``
    sequential streams, sleeping out the server's retry-after hint on a
    shed. ``streams`` (when given) receives each client's chunk lists.
    Returns the wall time of the whole phase."""
    from volsync_tpu_torch.service import ShedError

    def loop(tenant: str, gidx: int):
        tally: _TenantTally = tallies[tenant]
        salt = salt_for(gidx)
        with make_client(tenant) as c:
            done = 0
            while done < requests_per_client:
                t0 = time.perf_counter()
                got = []
                try:
                    for tup in c.chunk_stream(_salted_reader(base, salt)):
                        got.append(tup)
                except ShedError as e:
                    dt = time.perf_counter() - t0
                    with tally.lock:
                        tally.sheds += 1
                        tally.shed_latencies.append(dt)
                    # Closed-loop shed handling is the thing measured:
                    # honour the server's hint directly (capped so a
                    # long breaker cooldown cannot stall the bench).
                    time.sleep(min(e.retry_after, 0.2))  # lint: ignore[VL105] the closed loop honours the server's shed hint: that wait is what is measured
                    continue
                except Exception as e:  # noqa: BLE001 — tallied, asserted on
                    with tally.lock:
                        tally.mid_stream_aborts.append(
                            f"{tenant}[{gidx}] after {len(got)} chunks: "
                            f"{e!r}")
                    done += 1
                    continue
                dt = time.perf_counter() - t0
                with tally.lock:
                    tally.latencies.append(dt)
                    tally.bytes += base.shape[0]
                    tally.requests += 1
                    if streams is not None:
                        streams.setdefault(gidx, []).append(got)
                done += 1

    threads = []
    gidx = 0
    for t in tenants:
        for _ in range(t["clients"]):
            threads.append(threading.Thread(
                target=loop, args=(t["name"], gidx), daemon=True,
                name=f"svcbench-{t['name']}-{gidx}"))
            gidx += 1
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return time.perf_counter() - t0


def run_closed_loop(*, tenants: list[dict], requests_per_client: int = 3,
                    mib_per_request: float = 16, segment_kib: int = 4096,
                    window_ms: float = 2.0, max_streams: int = 0,
                    tenant_streams: int = 0, max_queued: int = 0,
                    stream_credits: int = 0, force_breaker: bool = False,
                    params=None, warm: bool = True,
                    client_timeout: float = 60.0, device=None,
                    seed: int = 7, keep_chunks: bool = False,
                    around_timed=contextlib.nullcontext) -> dict:
    """The importable benchmark core (the tests and ``chip_smoke.py``
    drive it). ``tenants`` is [{name, weight, clients[, streams]}, ...];
    0 for any cap means "use the VOLSYNC_SVC_* default". ``device`` is
    the server's (None: CUDA). ``keep_chunks`` adds ``streams``: each
    client's chunk lists of the timed phase, by client index, and
    ``base``, the unsalted payload. ``around_timed()`` is a context
    manager entered around the timed phase only (a device trace)."""
    from volsync_tpu_torch.metrics import GLOBAL
    from volsync_tpu_torch.obs import reset_spans, span_totals
    from volsync_tpu_torch.ops.gearcdc import GearParams
    from volsync_tpu_torch.repo import blobid
    from volsync_tpu_torch.resilience import CircuitBreaker, TransientError
    from volsync_tpu_torch.service import (MoverJaxClient, MoverJaxServer,
                                           TenantConfig, TenantRegistry)

    if params is None:
        params = GearParams(min_size=64 * 1024, avg_size=1024 * 1024,
                            max_size=4 * 1024 * 1024, align=4096)
    registry = TenantRegistry(
        TenantConfig(name=t["name"], weight=t["weight"],
                     max_streams=t.get("streams"))
        for t in tenants)
    total_clients = sum(t["clients"] for t in tenants)
    if total_clients >= 127:
        raise ValueError("salt space: at most 126 clients")

    breaker = None
    if force_breaker:
        breaker = CircuitBreaker("svcbench", threshold=1,
                                 reset_seconds=60.0)
        breaker.record_failure(TransientError("svcbench: forced open"))

    n = int(mib_per_request * 1024 * 1024)
    base = np.random.RandomState(seed).randint(0, 256, size=(n,),
                                               dtype=np.uint8)
    dispatch_log: list[int] = []
    srv = MoverJaxServer(
        params=params, segment_size=segment_kib * 1024,
        batch_window_ms=window_ms,
        # enough executor workers that concurrency is bounded by
        # ADMISSION, not by gRPC's thread pool queueing ahead of it
        max_workers=total_clients + 4,
        tenants=registry, breaker=breaker,
        max_streams=max_streams or None,
        tenant_streams=tenant_streams or None,
        max_queued=max_queued or None,
        stream_credits=stream_credits or None, device=device)
    unspy = _spy_dispatches(srv, dispatch_log)

    def make_client(tenant: str) -> MoverJaxClient:
        return MoverJaxClient("127.0.0.1", srv.port, srv.token,
                              tenant=tenant, timeout=client_timeout)

    result: dict = {
        "metric": "service_closed_loop",
        "unit": "GiB/s",
        "device": srv.device.type,
        "tenants": {},
        "mib_per_request": mib_per_request,
        "segment_kib": segment_kib,
        "window_ms": window_ms,
        "requests_per_client": requests_per_client,
        "clients": total_clients,
        "max_streams": max_streams or None,
    }
    try:
        with srv:
            if force_breaker:
                result.update(_breaker_shed_phase(srv, make_client))
                result["value"] = 0.0
            else:
                # Golden: one stream checked against hashlib before
                # timing (warm salt, never the timed data).
                with make_client(tenants[0]["name"]) as cl:
                    g = list(cl.chunk_stream(_salted_reader(base, 128)))
                s0, l0, d0 = g[0]
                if d0 != blobid.blob_id(salted(base, 128)[s0:s0 + l0]):
                    raise AssertionError("service golden check failed")
                tallies = {t["name"]: _TenantTally() for t in tenants}
                if warm:
                    _run_clients(make_client, tenants, base,
                                 lambda i: 128 + i, 1, tallies)
                    aborts = [a for tl in tallies.values()
                              for a in tl.mid_stream_aborts]
                    if aborts:
                        raise AssertionError(f"warm round aborts: {aborts}")
                    tallies = {t["name"]: _TenantTally()
                               for t in tenants}
                # Stage attribution describes the TIMED phase only.
                reset_spans()
                dispatch_log.clear()
                before = _admission_counts()
                streams: dict | None = {} if keep_chunks else None
                with around_timed():
                    wall = _run_clients(make_client, tenants, base,
                                        lambda i: i + 1,
                                        requests_per_client, tallies,
                                        streams)
                result.update(_report_load_phase(
                    tenants, tallies, wall, dispatch_log,
                    GLOBAL.svc_stage_seconds.values()))
                after = _admission_counts()
                result["admitted_by_tenant"], result["shed_by_tenant"] = (
                    {t: v - b.get(t, 0.0) for t, v in a.items()
                     if v != b.get(t, 0.0)}
                    for a, b in zip(after, before))
                if keep_chunks:
                    result["streams"] = streams
                    result["base"] = base
    finally:
        unspy()
    result["spans"] = {name: {"count": c, "seconds": round(s, 6)}
                       for name, (c, s) in sorted(span_totals().items())}
    return result


def _admission_counts() -> tuple:
    """(admitted, shed) stream counts by tenant so far in this process,
    from the admission metrics (shed summed over reasons)."""
    from volsync_tpu_torch.metrics import GLOBAL

    admitted = {t: v for (t,), v in GLOBAL.svc_admitted.values().items()}
    shed: dict = collections.defaultdict(float)
    for (t, _reason), v in GLOBAL.svc_shed.values().items():
        shed[t] += v
    return admitted, dict(shed)


def _breaker_shed_phase(srv, make_client) -> dict:
    """With the breaker forced open, time the admission shed path
    directly (the in-process bound the <10 ms criterion pins) and once
    through a real client (the RPC-visible bound, network stack
    included)."""
    from volsync_tpu_torch.service import ShedError
    from volsync_tpu_torch.service.admission import AdmissionRejected

    direct: list[float] = []
    for _ in range(200):
        t0 = time.perf_counter()
        try:
            srv.admission.admit_stream("svcbench-probe")
        except AdmissionRejected as rej:
            if rej.reason != "breaker_open":
                raise AssertionError(f"shed for {rej.reason}") from rej
        else:
            raise AssertionError("breaker open but stream admitted")
        direct.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    try:
        with make_client("svcbench-probe") as c:
            list(c.chunk_stream(lambda n: b""))
    except ShedError as e:
        rpc_dt, retry_after = time.perf_counter() - t0, e.retry_after
    else:
        raise AssertionError("breaker open but RPC stream admitted")
    return {
        "breaker": {
            "direct_shed_p99_ms": round(_percentile(direct, 99) * 1e3, 4),
            "direct_shed_max_ms": round(max(direct) * 1e3, 4),
            "rpc_shed_ms": round(rpc_dt * 1e3, 3),
            "retry_after_s": round(retry_after, 3),
        },
    }


# The components of one stream: admission gate, client-paced frame
# pulls, DRR queue wait, device batch, client-paced batch drains
# (svc.schedule and svc.stream enclose or overlap these, so they are
# reported in stages_s but kept out of the coverage sum).
_COMPONENT_STAGES = ("svc.admit", "svc.ingest", "svc.queue_wait",
                     "svc.batch", "svc.emit")


def _report_load_phase(tenants: list[dict], tallies: dict, wall: float,
                       dispatch_log: list, tenant_stages: dict) -> dict:
    per_tenant: dict = {}
    total_bytes = 0
    admitted = sheds = 0
    aborts: list[str] = []
    for t in tenants:
        tl: _TenantTally = tallies[t["name"]]
        total_bytes += tl.bytes
        admitted += tl.requests
        sheds += tl.sheds
        aborts.extend(tl.mid_stream_aborts)
        stages = {stage: round(secs, 4)
                  for (tn, stage), secs in sorted(tenant_stages.items())
                  if tn == t["name"]}
        comp = sum(stages.get(s, 0.0) for s in _COMPONENT_STAGES)
        per_tenant[t["name"]] = {
            "weight": t["weight"],
            "clients": t["clients"],
            "requests": tl.requests,
            "shed": tl.sheds,
            "p50_ms": round(_percentile(tl.latencies, 50) * 1e3, 2),
            "p99_ms": round(_percentile(tl.latencies, 99) * 1e3, 2),
            "goodput_gibs": round(tl.bytes / wall / (1 << 30), 4)
            if wall > 0 else 0.0,
            "stages_s": stages,
            # component seconds over the enclosing server-span seconds
            "stage_coverage": round(comp / stages["svc.stream"], 3)
            if stages.get("svc.stream", 0.0) > 0 else 0.0,
        }
    segments = sum(dispatch_log)
    return {
        "value": round(total_bytes / wall / (1 << 30), 4)
        if wall > 0 else 0.0,
        "wall_s": round(wall, 3),
        "bytes": total_bytes,
        "tenants": per_tenant,
        "requests_total": admitted,
        "shed_total": sheds,
        "mid_stream_aborts": aborts,
        "device_dispatches": len(dispatch_log),
        "segments_dispatched": segments,
        "max_batch_lanes": max(dispatch_log) if dispatch_log else 0,
        "lanes_histogram": dict(sorted(
            collections.Counter(dispatch_log).items())),
        # the coalescing signal: scheduling preserved cross-tenant
        # batching (fewer dispatches than segments)
        "coalesced": bool(dispatch_log) and len(dispatch_log) < segments,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenants", default="gold:4:2;bronze:1:2")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--mib", type=float, default=16)
    ap.add_argument("--segment-kib", type=int, default=32 * 1024)
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--max-streams", type=int, default=0)
    ap.add_argument("--force-breaker", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    from volsync_tpu_torch.ops.gearcdc import DEFAULT_PARAMS

    res = run_closed_loop(
        tenants=parse_tenants(args.tenants),
        requests_per_client=args.requests, mib_per_request=args.mib,
        segment_kib=args.segment_kib, window_ms=args.window_ms,
        max_streams=args.max_streams, force_breaker=args.force_breaker,
        params=DEFAULT_PARAMS, device=args.device)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
