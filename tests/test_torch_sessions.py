"""The port's supervised device sessions
(volsync_tpu_torch/cluster/sessions.py and sessioncli.py): every case of
tests/test_sessions.py on the port's classes, plus the torch backend's
subprocess probe on the CPU (ok, CUDA missing, timeout) and the CLI
verbs through the port's dispatcher.

The FakeSessionBackend replays seeded fault schedules against a
deterministic clock, so the wedge -> recycle -> measure story is
asserted transition by transition and reproduced from the same seed.
"""

from __future__ import annotations

import threading

import pytest

from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.cluster import sessions
from volsync_tpu_torch.cluster.sessions import (
    ACQUIRING,
    DEGRADED,
    HEALTHY,
    BenchQueue,
    FakeClock,
    FakeSessionBackend,
    FencedError,
    JobDeadlineExceeded,
    Lease,
    SessionBusy,
    SessionSupervisor,
    TorchSessionBackend,
    kill_marked_children,
)
from volsync_tpu_torch.objstore.faultstore import (
    FaultSchedule,
    FaultSpec,
    FaultStore,
    InjectedHang,
)
from volsync_tpu_torch.objstore.store import MemObjectStore
from volsync_tpu_torch.resilience import TransientError, classify


@pytest.fixture(autouse=True)
def _lockcheck_armed(monkeypatch):
    """Arm the lock-order detector for every supervisor test: the
    supervisor + queue + fake backend locks are all lockcheck-named,
    so any ordering violation fails the test at teardown."""
    monkeypatch.setenv("VOLSYNC_TPU_LOCKCHECK", "1")
    lockcheck.reset()
    yield
    assert lockcheck.violations() == []


def _stack(specs, *, seed=7, ttl=900.0, keepalive=30.0,
           probe_timeout=300.0, fails=2, job_deadline=120.0):
    clock = FakeClock()
    backend = FakeSessionBackend(FaultSchedule(seed=seed, specs=specs),
                                 clock=clock)
    sup = SessionSupervisor(backend, ttl=ttl, keepalive_interval=keepalive,
                            probe_timeout=probe_timeout,
                            max_keepalive_failures=fails,
                            clock=clock, sleep_fn=clock.sleep,
                            status_path="")
    queue = BenchQueue(sup, job_deadline=job_deadline, clock=clock)
    return clock, backend, sup, queue


# -- lease -------------------------------------------------------------------

def test_lease_beat_extends_ttl_and_silence_expires_it():
    clock = FakeClock()
    backend = FakeSessionBackend(clock=clock)
    lease = Lease(backend, ttl=100.0, clock=clock, sleep_fn=clock.sleep)
    lease.acquire()
    assert not lease.expired()
    clock.sleep(60)
    lease.beat()  # extends to now+100
    clock.sleep(90)
    assert not lease.expired()
    assert lease.remaining() == pytest.approx(10.0)
    clock.sleep(10)  # no beat: hard TTL
    assert lease.expired()
    assert lease.remaining() == 0.0


def test_lease_release_frees_device_for_next_acquire():
    backend = FakeSessionBackend()
    lease = Lease(backend, ttl=100.0, clock=backend.clock,
                  sleep_fn=backend.clock.sleep)
    lease.acquire()
    with pytest.raises(SessionBusy):
        backend.acquire()  # single-tenant: slot is held
    lease.release()
    assert backend.acquire().startswith("fake-")


# -- supervisor state machine ------------------------------------------------

def test_keepalive_drop_degrades_then_recovers():
    clock, backend, sup, _ = _stack(
        [FaultSpec(kind="transient", at=2, op="keepalive")])
    sup.ensure()
    sup.tick()                      # beat 1 ok
    assert sup.state == HEALTHY
    sup.tick()                      # beat 2 dropped
    assert sup.state == DEGRADED
    assert sup.keepalive_failures == 1
    sup.tick()                      # beat 3 ok again
    assert sup.state == HEALTHY
    assert sup.keepalive_failures == 0


def test_consecutive_keepalive_failures_force_recycle():
    clock, backend, sup, _ = _stack(
        [FaultSpec(kind="transient", p=1.0, op="keepalive")], fails=3)
    sup.ensure()
    first_epoch = sup.epoch
    sup.tick(); sup.tick()
    assert sup.state == DEGRADED
    sup.tick()                      # third consecutive failure
    assert sup.state == ACQUIRING   # recycled, awaiting reacquire
    assert sup.epoch == first_epoch + 1  # fenced
    causes = [c for (_, _, c) in sup.transitions]
    assert "keepalive_failures" in causes
    assert backend.force_releases == 1


def test_ttl_expiry_forces_recycle():
    clock, backend, sup, _ = _stack([], ttl=100.0)
    sup.ensure()
    clock.sleep(101)                # no beats landed in time
    sup.tick()
    assert [c for (_, _, c) in sup.transitions].count("ttl_expired") == 1
    assert sup.state == ACQUIRING


def test_recycle_is_single_flight():
    _, _, sup, _ = _stack([])
    sup.ensure()
    seen = []
    orig_release = sup.lease.release

    def release_and_reenter(**kw):
        # re-entering recycle mid-recycle must be refused, not recurse
        seen.append(sup.recycle("reentrant"))
        orig_release(**kw)

    sup.lease.release = release_and_reenter
    assert sup.recycle("probe_timeout") is True
    assert seen == [False]


def test_paused_supervisor_skips_beats():
    clock, backend, sup, _ = _stack([], ttl=100.0)
    sup.ensure()
    sup.pause_keepalive()
    clock.sleep(150)
    sup.tick()                      # TTL is past, but beats are paused
    assert sup.state == HEALTHY    # untouched: a job owns the device
    sup.resume_keepalive()
    sup.tick()
    assert sup.state == ACQUIRING   # now the TTL verdict lands


# -- fencing -----------------------------------------------------------------

def test_guard_refuses_stale_epoch_and_counts_it():
    from volsync_tpu_torch.metrics import GLOBAL as M

    _, backend, sup, _ = _stack([])
    sup.ensure()
    epoch = sup.epoch
    sup.guard(epoch)                # current epoch passes
    before = M.session_fenced_writes.labels(backend="fake").value
    sup.recycle("test")
    with pytest.raises(FencedError):
        sup.guard(epoch)
    after = M.session_fenced_writes.labels(backend="fake").value
    assert after == before + 1


def test_zombie_write_never_lands():
    """The acceptance fencing story end-to-end: a zombie session's
    result, produced under the pre-recycle epoch, is refused at
    publish; only the fresh session's write lands."""
    _, backend, sup, _ = _stack([])
    sup.ensure()
    zombie_epoch = sup.epoch
    zombie_payload = "stale-measurement"
    sup.recycle("keepalive_failures")   # zombie fenced out
    sup.ensure()
    # fresh session publishes fine
    sup.guard(sup.epoch)
    backend.write(sup.epoch, "fresh-measurement")
    # zombie's late publish is refused BEFORE the write
    with pytest.raises(FencedError):
        sup.guard(zombie_epoch)
        backend.write(zombie_epoch, zombie_payload)
    assert [p for (_, p) in backend.writes] == ["fresh-measurement"]


# -- serialized verify-then-measure queue ------------------------------------

def test_queue_stamps_session_provenance():
    _, _, sup, queue = _stack([])
    res = queue.run(lambda: 42, label="probe-me")
    assert res["result"] == 42
    s = res["session"]
    assert s["backend"] == "fake"
    assert s["session_id"].startswith("fake-")
    assert s["epoch"] >= 1
    assert queue.completed[0]["label"] == "probe-me"


def test_queue_never_runs_two_jobs_concurrently():
    _, backend, sup, queue = _stack([])
    barrier = threading.Barrier(2, timeout=10)
    results = []

    def submit():
        barrier.wait()
        results.append(queue.run(lambda: threading.get_ident()))

    threads = [threading.Thread(target=submit,
                                name=f"session-test-submit-{i}")
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(results) == 2
    assert backend.max_concurrent_jobs == 1


def test_probe_hang_recycles_and_queue_retries():
    """The verify probe hangs past its budget (faultstore ``hang``
    kind): admission recycles the wedged session and the job completes
    on a fresh one — within the hard TTL."""
    clock, backend, sup, queue = _stack(
        [FaultSpec(kind="hang", at=1, op="probe", latency=400.0)],
        probe_timeout=300.0)
    t0 = clock()
    res = queue.run(lambda: "measured")
    assert res["result"] == "measured"
    assert clock() - t0 <= sup.lease.ttl
    causes = [c for (_, _, c) in sup.transitions]
    assert "probe_timeout" in causes
    assert res["session"]["session_id"] == "fake-2"


def test_job_overrunning_deadline_is_refused_and_recycled():
    clock, backend, sup, queue = _stack([], job_deadline=100.0)

    def slow_job():
        clock.sleep(150)            # deterministic overrun
        return "too-late"

    with pytest.raises(JobDeadlineExceeded):
        queue.run(slow_job)
    assert "job_deadline" in [c for (_, _, c) in sup.transitions]
    assert queue.completed == []    # nothing published


def test_crash_mid_job_recycles_before_next_job():
    clock, backend, sup, queue = _stack(
        [FaultSpec(kind="crash", at=1, op="job")])
    with pytest.raises(RuntimeError, match="injected crash"):
        queue.run(lambda: "doomed")
    assert "job_failed" in [c for (_, _, c) in sup.transitions]
    res = queue.run(lambda: "after-crash")   # fresh session, clean run
    assert res["result"] == "after-crash"


def test_zombie_held_device_is_freed_at_admission():
    """Acquire hits SessionBusy while a zombie holds the slot; the
    queue's admission recycle force-releases it and the job runs."""
    _, backend, sup, queue = _stack([])
    sup.ensure()
    backend.zombies.add(backend.device_holder)  # wedge: polite release
    sup.lease.release()                         # ...is ignored
    sup.state = ACQUIRING                       # lease given up
    res = queue.run(lambda: "freed")
    assert res["result"] == "freed"
    assert backend.force_releases >= 1


# -- the acceptance chaos scenario -------------------------------------------

_ACCEPTANCE_SPECS = [
    FaultSpec(kind="hang", at=2, op="probe", latency=400.0),
    FaultSpec(kind="transient", at=2, op="keepalive"),
    FaultSpec(kind="zombie", at=4, op="keepalive"),
]


def _acceptance_run(seed):
    clock, backend, sup, queue = _stack(list(_ACCEPTANCE_SPECS),
                                        seed=seed)
    done = [queue.run(lambda: "m1", label="first")]
    for _ in range(3):              # keepalive drop -> degraded -> back
        sup.tick()
        clock.sleep(30)
    t0 = clock()
    done.append(queue.run(lambda: "m2", label="second"))  # probe hang
    assert clock() - t0 <= sup.lease.ttl
    zombie_epoch = done[-1]["session"]["epoch"]
    for _ in range(4):              # zombie -> degraded -> recycle
        sup.tick()
        clock.sleep(30)
    done.append(queue.run(lambda: "m3", label="third"))
    with pytest.raises(FencedError):
        sup.guard(zombie_epoch)
    return sup, backend, done


def test_acceptance_chaos_schedule():
    """ONE seeded schedule wedges the probe, drops a keepalive, and
    zombifies a session: every recycle lands within the hard TTL, the
    queue never admits two jobs, the zombie's post-fence write is
    refused, and each completed measurement carries its session
    identity."""
    sup, backend, done = _acceptance_run(7)
    causes = [c for (_, _, c) in sup.transitions]
    assert "probe_timeout" in causes
    assert "keepalive_failures" in causes
    assert backend.max_concurrent_jobs == 1
    epochs = [d["session"]["epoch"] for d in done]
    assert epochs == sorted(set(epochs))    # strictly advancing
    sids = [d["session"]["session_id"] for d in done]
    assert len(set(sids)) == 3              # three distinct sessions


def test_acceptance_trace_is_reproducible():
    """Same seed -> byte-identical transition trace (timestamps, states
    and causes); a different seed still satisfies the invariants but
    the trace is its own."""
    sup_a, _, _ = _acceptance_run(7)
    sup_b, _, _ = _acceptance_run(7)
    assert sup_a.transitions == sup_b.transitions
    assert len(sup_a.transitions) >= 8


def test_acceptance_recycles_recorded_in_flight_recorder():
    from volsync_tpu_torch import obs

    seen = len(obs.triggers())
    _acceptance_run(7)
    recycles = [e for e in obs.triggers()[seen:]
                if e["reason"] == "session_recycle"]
    assert len(recycles) >= 2
    assert {e["args"]["cause"] for e in recycles} >= {
        "probe_timeout", "keepalive_failures"}


# -- keepalive thread lifecycle ----------------------------------------------

def test_keepalive_thread_ticks_and_stops():
    backend = FakeSessionBackend()
    sup = SessionSupervisor(backend, ttl=900.0, keepalive_interval=0.01,
                            probe_timeout=300.0, status_path="")
    beats = threading.Event()
    orig = sup.tick

    def counting_tick():
        orig()
        beats.set()

    sup.tick = counting_tick
    with sup:
        sup.ensure()
        assert beats.wait(timeout=10)
    assert sup._thread is None      # stop() joined and cleared it


# -- status mirror + kill sweep ----------------------------------------------

def test_status_mirror_written_on_transitions(tmp_path):
    path = tmp_path / "status.json"
    backend = FakeSessionBackend()
    sup = SessionSupervisor(backend, ttl=900.0,
                            clock=backend.clock,
                            sleep_fn=backend.clock.sleep,
                            status_path=str(path))
    sup.ensure()
    import json

    mirrored = json.loads(path.read_text())
    assert mirrored["state"] == HEALTHY
    assert mirrored["backend"] == "fake"
    assert mirrored["session_id"] == sup.session_id
    assert mirrored["epoch"] == sup.epoch


def test_kill_marked_children_ignores_unmatched_marker():
    # the targeted kill itself (marker hit, bystander spared) is
    # test_kill_marked_children_spares_unmarked below; here: a sentinel
    # marker that matches nothing must be a harmless no-op
    assert kill_marked_children("VOLSYNC_NO_SUCH_SENTINEL=1",
                                log_fn=lambda _m: None) == 0


# -- faultstore hang kind (satellite) ----------------------------------------

def test_faultstore_hang_blocks_then_raises_retryable():
    """The ``hang`` kind consumes the caller's patience on the injected
    sleep before surfacing as a retryable drop — the ingredient the
    supervisor probe-timeout tests are built from."""
    slept = []
    fs = FaultStore(
        MemObjectStore(),
        FaultSchedule(seed=3, specs=[
            FaultSpec(kind="hang", at=1, op="get", key_prefix="data/",
                      latency=120.0)]),
        sleep_fn=slept.append)
    fs.put("data/a", b"payload")
    with pytest.raises(InjectedHang):
        fs.get("data/a")
    assert slept == [120.0]
    assert classify(InjectedHang("x")) is True   # retryable
    assert fs.get("data/a") == b"payload"        # once only (at=1)


def test_faultstore_hang_default_duration():
    slept = []
    fs = FaultStore(
        MemObjectStore(),
        FaultSchedule(seed=3, specs=[
            FaultSpec(kind="hang", at=1, op="put")]),
        sleep_fn=slept.append)
    with pytest.raises(InjectedHang):
        fs.put("k", b"v")
    assert slept == [60.0]          # _HANG_DEFAULT_S
    assert fs.exists("k") is False  # the op never landed


# -- CLI verbs ---------------------------------------------------------------

def _cli(argv):
    from volsync_tpu_torch.cluster.sessioncli import main

    lines = []
    rc = main(argv, out=lines.append)
    return rc, "\n".join(str(ln) for ln in lines)


def test_cli_run_fake_backend_stamps_session(tmp_path):
    import json
    import sys

    status = tmp_path / "status.json"
    rc, out = _cli(["run", "--backend", "fake", "--deadline", "60",
                    "--status-file", str(status), "--label", "smoke",
                    "--", sys.executable, "-c", "print('hi')"])
    assert rc == 0
    assert "hi" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["session"]["backend"] == "fake"
    assert summary["session"]["epoch"] >= 1
    assert json.loads(status.read_text())["backend"] == "fake"


def test_cli_run_requires_command():
    rc, out = _cli(["run", "--backend", "fake"])
    assert rc == 2
    assert "no command" in out


def test_cli_run_fake_spec_drives_chaos(tmp_path):
    import sys

    rc, out = _cli(["run", "--backend", "fake", "--deadline", "60",
                    "--status-file", str(tmp_path / "s.json"),
                    "--fake-spec", "hang:op=probe,at=1,ms=500",
                    "--", sys.executable, "-c", "print('ok')"])
    # the probe hang is on the FAKE clock (instant in wall time): the
    # supervisor classifies it as probe_failed, recycles, retries, and
    # the job still lands
    assert rc == 0
    assert "ok" in out


def test_cli_status_missing_file(tmp_path):
    rc, out = _cli(["status", "--file", str(tmp_path / "nope.json")])
    assert rc == 1
    assert "no session status" in out


def test_cli_status_reads_mirror(tmp_path):
    import json

    path = tmp_path / "status.json"
    path.write_text(json.dumps({"state": "healthy", "epoch": 3}) + "\n")
    rc, out = _cli(["status", "--file", str(path)])
    assert rc == 0
    assert '"healthy"' in out


def test_cli_recycle_reports_kill_count():
    rc, out = _cli(["recycle", "--marker", "VOLSYNC_NO_SUCH_SENTINEL=1"])
    assert rc == 0
    assert "killed 0" in out


def test_cli_dispatches_from_main_entry():
    from volsync_tpu_torch.cli import main

    lines = []
    rc = main(["session", "recycle", "--marker",
               "VOLSYNC_NO_SUCH_SENTINEL=1"], out=lines.append)
    assert rc == 0
    assert any("killed 0" in str(ln) for ln in lines)


# -- the torch backend (subprocess probes) -----------------------------------

def test_torch_backend_probes_the_cpu():
    """The probe child runs sha256_many of the port on the CPU against
    hashlib and names the device; a session acquired on it reports
    the backend's name."""
    backend = TorchSessionBackend(device="cpu", probe_timeout=120.0)
    assert backend.name == "torch"
    assert backend.probe("s", timeout=120.0) == "cpu cpu"
    sid = backend.acquire()
    assert sid.startswith("torch-")
    sup = SessionSupervisor(backend, ttl=900.0, probe_timeout=120.0,
                            status_path="")
    assert sup.verify() == "cpu cpu"
    assert sup.provenance()["backend"] == "torch"


def test_torch_backend_default_needs_cuda(monkeypatch):
    """device=None probes CUDA: here, with no card, the child fails and
    the probe raises TransientError naming CUDA."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    backend = TorchSessionBackend(probe_timeout=120.0)
    with pytest.raises(TransientError, match="CUDA"):
        backend.probe("s")
    with pytest.raises(TransientError, match="CUDA"):
        backend.acquire()


def test_torch_backend_probe_timeout_fails(monkeypatch):
    """A probe child that outlives its timeout is killed and the probe
    fails retryably; the supervisor then recycles."""
    monkeypatch.setattr(sessions, "_TORCH_PROBE_SRC",
                        "import time\ntime.sleep(60)\n")
    backend = TorchSessionBackend(device="cpu", probe_timeout=1.0)
    with pytest.raises(TransientError, match="exceeded"):
        backend.probe("s", timeout=1.0)
    assert classify(TransientError("x")) is True


def test_kill_marked_children_spares_unmarked():
    """force_release kills the child carrying the marker and leaves an
    unmarked one alive; this process never carries it."""
    import os
    import subprocess
    import sys
    import uuid

    marker = f"VOLSYNC_BENCH_INNER=test-{uuid.uuid4().hex}"
    key, _, value = marker.partition("=")
    assert os.environ.get(key) != value
    sleeper = [sys.executable, "-c", "import time; time.sleep(60)"]
    marked = subprocess.Popen(sleeper, env=dict(os.environ, **{key: value}))
    plain = subprocess.Popen(sleeper, env=dict(os.environ))
    try:
        import time

        for _ in range(50):  # the child's environ is readable once exec'd
            try:
                with open(f"/proc/{marked.pid}/environ", "rb") as f:
                    if marker.encode() in f.read().split(b"\0"):
                        break
            except OSError:
                pass
            time.sleep(0.1)
        backend = TorchSessionBackend(device="cpu", marker=marker)
        assert backend.force_release() == 1
        assert marked.wait(timeout=10) != 0
        assert plain.poll() is None
    finally:
        for p in (marked, plain):
            p.kill()
            p.wait()


def test_cli_status_probe_through_the_dispatcher(tmp_path):
    """``volsync session status --probe`` through the port's CLI: live on
    the CPU (rc 0), and 75 where the probe cannot run."""
    from volsync_tpu_torch.cli import main
    from volsync_tpu_torch.cluster.sessioncli import EXIT_UNHEALTHY

    lines = []
    rc = main(["session", "status", "--file", str(tmp_path / "none.json"),
               "--probe", "--probe-timeout", "120"], out=lines.append,
              device="cpu")
    assert rc == 0
    assert "probe: live (cpu cpu)" in lines
    lines.clear()
    rc = main(["session", "status", "--file", str(tmp_path / "none.json"),
               "--probe", "--probe-timeout", "120"], out=lines.append,
              device="cuda:99")
    assert rc == EXIT_UNHEALTHY == 75
    assert any("WEDGED" in ln for ln in lines)


def test_cli_run_torch_backend_on_the_cpu(tmp_path):
    """``session run --backend torch`` probes, runs the command with the
    session stamped into its environment and mirrors the status."""
    import json
    import sys

    from volsync_tpu_torch.cli import main

    lines = []
    status = tmp_path / "status.json"
    code = ("import os; print(os.environ['VOLSYNC_SESSION_BACKEND'], "
            "os.environ['VOLSYNC_SESSION_EPOCH'])")
    rc = main(["session", "run", "--backend", "torch", "--deadline", "120",
               "--probe-timeout", "120", "--status-file", str(status),
               "--", sys.executable, "-c", code], out=lines.append,
              device="cpu")
    assert rc == 0
    assert "torch 1" in lines
    summary = json.loads(lines[-1])
    assert summary["session"]["backend"] == "torch"
    assert json.loads(status.read_text())["backend"] == "torch"
