"""The port's flight recorder (``volsync_tpu_torch/obs``) against the JAX
package's ``volsync_tpu/obs``, on the CPU.

The cases of tests/test_tracing.py on the port: span outcomes and the
registry/histogram reset, TraceContext nesting and ring tags, explicit
thread-seam handoff, the ``x-volsync-trace`` wire format (both
packages parse each other's headers), sampling (the ring is sampled,
the totals are not), the shed / breaker-open / injected-fault /
deadline trigger dumps and their throttling, the ``trace`` CLI and
``chrome_trace``'s shape. The same span sequence run through both
packages gives dumps of one event shape (keys, ``ph``, names, args).
The reference's wall-clock overhead gate is left out (a timing bound is
unsteady on a shared CPU); a disabled ring is asserted to record
nothing instead. The port's own additions are held too: the plain
``triggers()`` records, ``copy_totals()``, and the micro-batcher's pass
recorded under its lanes' one trace.
"""

import glob
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from volsync_tpu import obs as jobs
from volsync_tpu_torch import cli
from volsync_tpu_torch import obs
from volsync_tpu_torch.metrics import GLOBAL as M
from volsync_tpu_torch.obs import (
    begin_span,
    carry_context,
    chrome_trace,
    dump_trace,
    format_trace_header,
    new_trace,
    parse_trace_header,
    record_trigger,
    reset_spans,
    reset_trace,
    span,
    span_totals,
    trace_context,
    trace_events,
    use_context,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_obs():
    for pkg in (obs, jobs):
        pkg.reset_spans()
        pkg.reset_trace()
    yield
    for pkg in (obs, jobs):
        pkg.reset_spans()
        pkg.reset_trace()


def _hist_count(stage, outcome):
    """Observations of the stage histogram's series, None when absent
    (after a clear())."""
    got = M.stage_duration.values().get((stage, outcome))
    return None if got is None else got[0]


# -- outcome dimension and reset ------------------------------------------

def test_span_outcome_dimension():
    with span("repo.seal"):
        pass
    with pytest.raises(ValueError):
        with span("repo.seal"):
            raise ValueError("boom")
    assert span_totals()["repo.seal"][0] == 2
    by = span_totals(by_outcome=True)
    assert by[("repo.seal", "ok")][0] == 1
    assert by[("repo.seal", "error")][0] == 1
    assert _hist_count("repo.seal", "ok") == 1
    assert _hist_count("repo.seal", "error") == 1
    assert M.stage_duration.name == "volsync_stage_duration_seconds"
    assert M.stage_duration.labelnames == ("stage", "outcome")
    assert M.stage_duration.bounds[-1] == float("inf")
    child = M.stage_duration.labels(stage="repo.seal", outcome="ok")
    assert child.buckets[-1] == child.count == 1


def test_stage_histogram_buckets_match_the_reference():
    from volsync_tpu.obs import tracing as jtracing

    assert M.stage_duration.bounds == jtracing._BUCKETS


def test_reset_spans_clears_histogram_and_tenant_counter():
    with trace_context(tenant="gold"):
        with span("engine.read"):
            pass
    assert _hist_count("engine.read", "ok") == 1
    assert M.svc_stage_seconds.values()[("gold", "engine.read")] > 0

    reset_spans()

    assert span_totals() == {}
    assert M.svc_stage_seconds.values() == {}
    assert _hist_count("engine.read", "ok") is None
    assert ("gold", "engine.read") not in M.svc_stage_seconds.values()


# -- context: nesting, handoff, wire format -------------------------------

def test_span_nesting_and_ring_tags():
    with trace_context(tenant="t1", stream_id="s1") as root:
        with span("svc.stream"):
            with span("svc.batch", lanes=3):
                pass
    spans = {e["name"]: e for e in trace_events() if e["ph"] == "X"}
    outer, inner = spans["svc.stream"], spans["svc.batch"]
    assert inner["args"]["parent_span_id"] == outer["args"]["span_id"]
    assert outer["args"]["parent_span_id"] == root.span_id
    for e in (outer, inner):
        assert e["args"]["trace_id"] == root.trace_id
        assert e["args"]["tenant"] == "t1"
        assert e["args"]["stream_id"] == "s1"
    assert inner["args"]["lanes"] == 3
    assert inner["dur"] <= outer["dur"]


def test_carry_context_across_pool_seam():
    def work():
        with span("repo.seal"):
            pass

    assert carry_context(work) is work  # nothing to carry

    with trace_context(tenant="t2"):
        with span("svc.stream"):
            with ThreadPoolExecutor(1) as pool:
                pool.submit(carry_context(work)).result()
    spans = {e["name"]: e for e in trace_events() if e["ph"] == "X"}
    assert spans["repo.seal"]["args"]["parent_span_id"] == \
        spans["svc.stream"]["args"]["span_id"]
    assert spans["repo.seal"]["args"]["tenant"] == "t2"
    assert spans["repo.seal"]["tid"] != spans["svc.stream"]["tid"]
    names = {e["tid"]: e["args"]["name"] for e in chrome_trace()[
        "traceEvents"] if e["ph"] == "M"}
    assert set(names) == {spans["repo.seal"]["tid"],
                          spans["svc.stream"]["tid"]}


def test_use_context_and_detached_spans():
    ctx = new_trace(tenant="t3", sampled=True)
    with use_context(None):  # explicit no-op side of the handoff
        assert begin_span("svc.queue_wait", ctx=None).ctx is None
    h = begin_span("svc.queue_wait", ctx=ctx)
    h.finish("error")
    h.finish("ok")  # idempotent: the first outcome stands
    by = span_totals(by_outcome=True)
    assert by[("svc.queue_wait", "error")][0] == 1
    assert ("svc.queue_wait", "ok") not in by
    (ev,) = [e for e in trace_events() if e["ph"] == "X"]
    assert ev["args"]["outcome"] == "error"
    assert ev["args"]["parent_span_id"] == ctx.span_id


@pytest.mark.parametrize("maker,parser", [
    (obs, obs), (obs, jobs), (jobs, obs)], ids=["port", "port-to-ref",
                                                 "ref-to-port"])
def test_trace_header_roundtrip(maker, parser):
    ctx = maker.new_trace(tenant="gold", stream_id="abc123", sampled=True)
    parsed = parser.parse_trace_header(maker.format_trace_header(ctx))
    assert parsed.trace_id == ctx.trace_id
    assert parsed.span_id == ctx.span_id
    assert parsed.stream_id == "abc123"
    assert parsed.sampled is True
    assert parsed.tenant is None  # never trusted from the wire
    unsampled = parser.parse_trace_header(
        maker.format_trace_header(ctx.evolve(sampled=False)))
    assert unsampled.sampled is False
    for bad in (None, "", "garbage", "a:b:c", ":x:y:1"):
        assert parser.parse_trace_header(bad) is None


def test_sampling_disables_ring_but_not_totals(monkeypatch):
    monkeypatch.setenv("VOLSYNC_TRACE_SAMPLE", "0")
    with trace_context(tenant="t4") as ctx:
        assert ctx.sampled is False
        with span("engine.read"):
            pass
    assert trace_events() == []
    assert span_totals()["engine.read"][0] == 1
    assert M.svc_stage_seconds.values()[("t4", "engine.read")] > 0


def test_disabled_ring_records_nothing(monkeypatch):
    """What the reference's overhead gate ends on, without its timing:
    with sampling off, spans, copies and context-free spans leave the
    ring empty."""
    monkeypatch.setenv("VOLSYNC_TRACE_SAMPLE", "0")
    for _ in range(100):
        with span("engine.device"):
            pass
    with trace_context():
        with span("engine.device"):
            obs.record_copy("device.pad", 10)
    assert trace_events() == []
    assert span_totals()["engine.device"][0] == 101


def test_ring_size_from_env_and_wrap(monkeypatch):
    monkeypatch.setenv("VOLSYNC_TRACE_RING", "16")
    reset_trace()
    with trace_context():
        for _ in range(20):
            with span("engine.read"):
                pass
    assert len(trace_events()) == 16  # oldest evicted first
    assert span_totals()["engine.read"][0] == 20


# -- flight recorder: trigger auto-dumps ----------------------------------

def _trigger_files(dump_dir, reason):
    return sorted(glob.glob(os.path.join(dump_dir,
                                         f"trace-{reason}-*.json")))


def _arm_dumps(monkeypatch, tmp_path):
    monkeypatch.setenv("VOLSYNC_TRACE_DUMP", str(tmp_path))
    monkeypatch.setenv("VOLSYNC_TRACE_TRIGGER_INTERVAL_S", "0")


def test_shed_trigger_dumps_annotated_trace(monkeypatch, tmp_path):
    _arm_dumps(monkeypatch, tmp_path)
    from volsync_tpu_torch.service import TenantConfig, TenantRegistry
    from volsync_tpu_torch.service.admission import (
        AdmissionController, AdmissionRejected)

    adm = AdmissionController(
        TenantRegistry([TenantConfig(name="gold", weight=1)]),
        max_streams=1)
    ticket = adm.admit_stream("gold")
    with pytest.raises(AdmissionRejected):
        adm.admit_stream("gold")
    adm.release(ticket)

    (path,) = _trigger_files(tmp_path, "shed")
    doc = json.loads(Path(path).read_text())
    assert doc["trigger"]["reason"] == "shed"
    assert doc["trigger"]["tenant"] == "gold"
    assert doc["trigger"]["cause"] == "global_streams"
    assert any(e["name"] == "trigger.shed" for e in doc["traceEvents"])


def test_breaker_open_trigger_dumps(monkeypatch, tmp_path):
    _arm_dumps(monkeypatch, tmp_path)
    from volsync_tpu_torch.resilience import CircuitBreaker, TransientError

    breaker = CircuitBreaker("dumptest", threshold=1, reset_seconds=60.0)
    breaker.record_failure(TransientError("forced"))
    assert breaker.open_remaining() > 0

    (path,) = _trigger_files(tmp_path, "breaker_open")
    doc = json.loads(Path(path).read_text())
    assert doc["trigger"] == {"reason": "breaker_open",
                              "backend": "dumptest"}


def test_injected_fault_trigger_dumps(monkeypatch, tmp_path):
    _arm_dumps(monkeypatch, tmp_path)
    from volsync_tpu_torch.objstore.faultstore import maybe_wrap
    from volsync_tpu_torch.objstore.store import MemObjectStore

    store = maybe_wrap(MemObjectStore(), seed=3, spec="latency:p=1,ms=1")
    store.put("k", b"x")

    files = _trigger_files(tmp_path, "fault")
    assert files, "injected fault produced no flight-recorder dump"
    doc = json.loads(Path(files[0]).read_text())
    assert doc["trigger"]["reason"] == "fault"
    assert doc["trigger"]["op"] == "put"
    assert doc["trigger"]["kinds"] == ["latency"]


def test_deadline_trigger_dumps(monkeypatch, tmp_path):
    _arm_dumps(monkeypatch, tmp_path)
    from volsync_tpu_torch.resilience import (
        DeadlineExceeded, RetryPolicy, TransientError)

    policy = RetryPolicy(site="tracetest.deadline", max_attempts=10,
                         base_delay=0.05, max_delay=0.05, deadline=0.01)

    def always_fails():
        raise TransientError("nope")

    with pytest.raises(DeadlineExceeded):
        policy.call(always_fails)

    (path,) = _trigger_files(tmp_path, "deadline")
    doc = json.loads(Path(path).read_text())
    assert doc["trigger"]["reason"] == "deadline"
    assert doc["trigger"]["site"] == "tracetest.deadline"
    assert doc["trigger"]["attempt"] >= 1


def test_trigger_throttling(monkeypatch, tmp_path):
    monkeypatch.setenv("VOLSYNC_TRACE_DUMP", str(tmp_path))
    monkeypatch.setenv("VOLSYNC_TRACE_TRIGGER_INTERVAL_S", "3600")
    assert record_trigger("shed", tenant="a") is not None
    assert record_trigger("shed", tenant="b") is None  # throttled
    assert len(_trigger_files(tmp_path, "shed")) == 1
    # but both instants are in the ring, and in the port's records
    marks = [e for e in trace_events() if e["name"] == "trigger.shed"]
    assert len(marks) == 2
    assert [t["args"]["tenant"] for t in obs.triggers()[-2:]] == ["a", "b"]


def test_trigger_without_dump_dir_writes_nothing(monkeypatch, tmp_path):
    monkeypatch.delenv("VOLSYNC_TRACE_DUMP", raising=False)
    monkeypatch.chdir(tmp_path)
    assert record_trigger("fault", op="get") is None
    assert list(tmp_path.iterdir()) == []
    assert trace_events()[-1]["name"] == "trigger.fault"


# -- CLI + export ---------------------------------------------------------

def test_trace_cli_dump_and_summary(tmp_path):
    with trace_context(tenant="cli"):
        with span("engine.read"):
            pass
    out_file = tmp_path / "dump.json"
    lines: list = []
    assert cli.main(["trace", "dump", "--out", str(out_file)],
                    out=lines.append) == 0
    doc = json.loads(out_file.read_text())
    assert any(e.get("name") == "engine.read" for e in doc["traceEvents"])
    assert str(out_file) in lines[0]

    lines.clear()
    assert cli.main(["trace", "summary"], out=lines.append) == 0
    assert any("engine.read" in ln and "ok" in ln for ln in lines)

    lines.clear()
    assert cli.main(["trace", "dump"], out=lines.append) == 0
    assert json.loads("\n".join(lines))["traceEvents"]


def test_trace_summary_matches_the_reference_cli():
    """The same spans through both packages: ``trace summary`` prints
    the same table rows (the seconds column aside)."""
    from volsync_tpu.cli.main import run as j_run

    for pkg in (obs, jobs):
        with pkg.span("repo.seal"):
            pass
        with pytest.raises(KeyError):
            with pkg.span("repo.seal"):
                raise KeyError("x")
    rows = {}
    for who in ("ref", "port"):
        lines: list = []
        if who == "ref":
            assert j_run(["trace", "summary"], {}, out=lines.append) == 0
        else:
            assert cli.main(["trace", "summary"], out=lines.append) == 0
        rows[who] = [ln.rsplit(None, 1)[0] for ln in lines]
    assert rows["port"] == rows["ref"]
    assert len(rows["port"]) == 3  # header, error, ok


def test_empty_summary():
    lines: list = []
    assert cli.main(["trace", "summary"], out=lines.append) == 0
    assert lines == ["no spans recorded"]


def test_chrome_trace_shape_and_dump_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("VOLSYNC_TRACE_DUMP", raising=False)
    with trace_context(tenant="shape"):
        with span("engine.read"):
            pass
    doc = chrome_trace(trigger="manual", annotations={"who": "test"})
    assert doc["displayTimeUnit"] == "ms"
    assert doc["trigger"] == {"reason": "manual", "who": "test"}
    assert any(e["ph"] == "M" and e["name"] == "thread_name"
               for e in doc["traceEvents"])
    path = dump_trace(path=str(tmp_path / "t.json"))
    assert json.loads(Path(path).read_text())["traceEvents"]
    assert dump_trace() is None  # no path, no dump dir


def _sequence(pkg):
    """One span sequence: nested spans with attributes, an error span,
    a copy instant and a trigger, under one tenant's trace."""
    with pkg.trace_context(tenant="gold", stream_id="s-1"):
        with pkg.span("svc.stream"):
            with pkg.span("svc.batch", lanes=4):
                pkg.record_copy("device.pad", 4096)
            with pytest.raises(ValueError):
                with pkg.span("repo.seal"):
                    raise ValueError("boom")
        pkg.record_trigger("shed", tenant="gold", cause="global_streams")
    return pkg.chrome_trace(trigger="manual", annotations={"who": "t"})


_IDS = ("trace_id", "span_id", "parent_span_id")


def _shape(doc):
    """The dump with what differs run to run taken out: times, pids and
    tids, and the random ids (kept as which-event-parents-which)."""
    events = doc["traceEvents"]
    span_ids = {e["args"]["span_id"]: i for i, e in enumerate(events)
                if e["ph"] == "X"}
    out = []
    for e in events:
        if e["ph"] == "M":
            out.append((e["name"], e["ph"], sorted(e)))
            continue
        args = {k: v for k, v in e["args"].items() if k not in _IDS}
        parent = span_ids.get(e["args"].get("parent_span_id"))
        out.append((e["name"], e["ph"], e.get("cat"), e.get("s"),
                    sorted(e), sorted(e["args"]), args, parent))
    return out, doc["displayTimeUnit"], doc["trigger"]


def test_dump_has_the_references_event_shape():
    assert _shape(_sequence(obs)) == _shape(_sequence(jobs))
    evs = [e for e in _sequence(obs)["traceEvents"] if e["ph"] != "M"]
    assert [e["name"] for e in evs if e["ph"] == "X"] == [
        "svc.batch", "repo.seal", "svc.stream"] * 2


def test_copy_ledger_and_legacy_names():
    obs.reset_copies()
    with trace_context():
        with span("engine.read"):
            obs.record_copy("device.pad", 100)
    obs.record_copy("device.pad", 28)
    obs.record_copy("device.pad", 0)  # nothing copied, nothing counted
    assert obs.copies_by_site() == {"device.pad": 128}
    assert obs.copy_totals() == obs.copies_by_site()
    assert obs.total_copied() == 128
    assert M.copy_bytes.values()[("device.pad",)] >= 128
    (inst,) = [e for e in trace_events() if e["ph"] == "i"]
    assert inst["name"] == "copy" and inst["args"]["nbytes"] == 100
    (sp,) = [e for e in trace_events() if e["ph"] == "X"]
    assert inst["args"]["parent_span_id"] == sp["args"]["span_id"]
    assert "device.pad" in obs.SANCTIONED_SITES
    assert obs.SANCTIONED_SITES == jobs.SANCTIONED_SITES


def test_batched_pass_records_under_its_lanes_trace():
    """The port's micro-batcher dispatches a pass whose lanes all carry
    one trace under that trace (the reference keeps every pass
    context-free); a pass with a context-free lane stays context-free."""
    from volsync_tpu_torch.ops.batcher import SegmentMicroBatcher
    from volsync_tpu_torch.ops.gearcdc import GearParams

    params = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                        align=4096)
    data = np.frombuffer(np.random.RandomState(5).bytes(65536), np.uint8)
    b = SegmentMicroBatcher(params, window_ms=1.0, device="cpu")
    try:
        with trace_context() as root:
            with span("engine.segment"):
                b.submit(data, len(data), True)
        b.submit(data, len(data), True)  # no context
    finally:
        b.stop()
    passes = [e for e in trace_events()
              if e["name"] == "ops.batch_dispatch"]
    (traced,) = passes
    seg = next(e for e in trace_events() if e["name"] == "engine.segment")
    assert traced["args"]["trace_id"] == root.trace_id
    assert traced["args"]["parent_span_id"] == seg["args"]["span_id"]
    assert traced["tid"] != seg["tid"]
    assert span_totals()["ops.batch_dispatch"][0] == 2


# -- one clock, a ring that holds a window, the restic Job's trace ---------

def test_span_lands_on_the_profilers_clock():
    """A span around a ``torch.profiler.record_function`` region starts
    and ends within 1 ms of it: the ring's ``ts`` is realtime, the
    profiler's clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace_context():
            with span("test.clock"), record_function("test.region"):
                torch.ones(64).sum()
                time.sleep(0.005)
    (region,) = [(e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "test.region"]
    (ev,) = [e for e in trace_events() if e["name"] == "test.clock"]
    start_ns, end_ns = ev["ts"] * 1e3, (ev["ts"] + ev["dur"]) * 1e3
    assert abs(start_ns - region[0]) < 1e6
    assert abs(end_ns - region[1]) < 1e6
    assert abs(ev["ts"] / 1e6 - time.time()) < 60


def test_ring_follows_a_drifting_realtime_clock(monkeypatch):
    """Realtime running 0.5% fast against perf_counter (ten times what NTP
    may slew): each span still lands where realtime read inside it, and
    nested spans stay nested, as the recorder pairs the clocks while it
    records and interpolates between the pairs."""
    from volsync_tpu_torch.obs import tracing

    base = time.time_ns() - int(time.perf_counter() * 1e9)

    def drifting_ns():
        return base + int(time.perf_counter() * 1.005e9)

    monkeypatch.setattr(tracing, "_PAIR_EVERY_S", 0.01)
    monkeypatch.setattr(tracing.time, "time_ns", drifting_ns)
    seen = {}
    with trace_context():
        with span("test.outer"):
            for i in range(20):
                with span("test.inner", i=i):
                    time.sleep(0.01)
                    seen[i] = drifting_ns() / 1e3
    events = trace_events()
    (outer,) = [e for e in events if e["name"] == "test.outer"]
    inner = [e for e in events if e["name"] == "test.inner"]
    for e in inner:
        assert e["ts"] - 20 <= seen[e["args"]["i"]] <= e["ts"] + e["dur"] + 20
        assert outer["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    assert [e["ts"] for e in inner] == sorted(e["ts"] for e in inner)


def test_ring_keeps_n_events_in_order_and_reports_its_oldest(monkeypatch):
    monkeypatch.setenv("VOLSYNC_TRACE_RING", "32")
    reset_trace()
    assert obs.ring_stats() == {"capacity": 32, "held": 0, "recorded": 0,
                                "oldest_ts": None}
    with trace_context():
        for i in range(50):
            with span("engine.read", i=i):
                pass
    events = trace_events()
    assert [e["args"]["i"] for e in events] == list(range(18, 50))
    assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)
    stats = obs.ring_stats()
    assert (stats["capacity"], stats["held"], stats["recorded"]) == \
        (32, 32, 50)
    assert stats["oldest_ts"] == pytest.approx(events[0]["ts"], abs=100)
    assert obs.ring_stats()["oldest_ts"] < events[1]["ts"]


def test_seal_keeps_compression_only_where_it_pays():
    """``repo.seal.compress`` says whether the compressed form is kept:
    not for a random blob, yes for a text blob; ``repo.seal.cipher``
    follows it inside ``repo.seal``."""
    from volsync_tpu_torch.objstore.store import MemObjectStore
    from volsync_tpu_torch.repo.repository import Repository

    repo = Repository.init(MemObjectStore(), password="pw", device="cpu")
    rand = np.random.default_rng(3).bytes(1 << 16)
    text = b"".join(b"row %06d of the log\n" % i for i in range(3000))
    with trace_context():
        repo._encode_blob(rand)
        repo._encode_blob(text)
    comp = [e for e in trace_events() if e["name"] == "repo.seal.compress"]
    assert [(e["args"]["raw"], e["args"]["kept"]) for e in comp] == [
        (len(rand), False), (len(text), True)]
    seals = [e for e in trace_events() if e["name"] == "repo.seal"]
    ciphers = [e for e in trace_events() if e["name"] == "repo.seal.cipher"]
    for c, s in zip(comp + ciphers, seals + seals):
        assert c["args"]["parent_span_id"] == s["args"]["span_id"]
    assert span_totals()["repo.seal.cipher"][0] == 2


#: the spans a restic backup Job records inside the port, besides the
#: existing engine.*, repo.seal, repo.pack_upload and ops.batch_dispatch
JOB_SPANS = ("mover.restic.open", "repo.kdf", "repo.lock",
             "repo.list_then_load", "repo.seal.compress", "repo.seal.cipher",
             "repo.seal_wait", "repo.index_write", "repo.save_snapshot",
             "repo.unlock", "ops.batch_stage", "device.h2d", "engine.read")


def test_restic_backup_job_is_one_trace_on_every_thread(monkeypatch,
                                                        tmp_path):
    """A tiny backup through ``restic_entrypoint`` on the CPU (the
    shared micro-batcher forced on, every seal slowed so that the flush
    waits for one): every new span is in ``span_totals()`` and in the
    ring, all under one trace whose ``stream_id`` is the Job's name,
    from the entry, readahead, batcher and seal threads at least."""
    import threading

    from volsync_tpu_torch.cluster.runner import JobContext
    from volsync_tpu_torch.movers.restic.entry import restic_entrypoint
    from volsync_tpu_torch.repo import crypto

    monkeypatch.setenv("VOLSYNC_BATCH_SEGMENTS", "1")
    seal_parts = crypto.SecretBox.seal_parts

    def slow_seal(self, parts):
        time.sleep(0.05)
        return seal_parts(self, parts)

    monkeypatch.setattr(crypto.SecretBox, "seal_parts", slow_seal)
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    rng = np.random.default_rng(7)
    (src / "big.bin").write_bytes(rng.bytes(700_000))
    (src / "sub" / "log.txt").write_bytes(b"a line of text\n" * 5000)
    env = {"RESTIC_REPOSITORY": f"file://{tmp_path / 'repo'}",
           "RESTIC_PASSWORD": "pw", "HOSTNAME": "h"}
    assert restic_entrypoint(JobContext(
        name="src-job", namespace="ns", env=env, mounts={"data": src},
        secrets={}, stop_event=threading.Event(), device="cpu")) == 0
    totals = span_totals()
    spans = [e for e in trace_events() if e["ph"] == "X"]
    assert not [n for n in JOB_SPANS if n not in totals]
    assert not [n for n in JOB_SPANS if n not in {e["name"] for e in spans}]
    assert len({e["args"]["trace_id"] for e in spans}) == 1
    assert {e["args"]["stream_id"] for e in spans} == {"src-job"}
    names = {e["tid"]: e["args"]["name"]
             for e in chrome_trace()["traceEvents"] if e["ph"] == "M"}
    threads = {names[e["tid"]] for e in spans}
    assert len(threads) >= 3
    assert any(t.startswith("vtpk-seal") for t in threads)
    assert any(t.startswith("segment-batch") for t in threads)
    assert "vtpt-readahead" in threads
