"""The port's fleet replica plane (``service/fleet.py``) and continuous
GC (``service/gc.py``) against the JAX package's, on the CPU.

The fleet and GC cases of tests/test_fleet.py run on the port: stamps
and their TTL arithmetic, heartbeats that beat, retire, die unretired
and survive store weather, headroom routing and cache-only sibling
hints, admission headroom, the GC's four outcomes and its background
loop, and repair's reaping of crashed replicas' stamps. Across the two
packages a stamp written by either parses in the other byte for byte,
a reference ``FleetRouter`` routes to port replicas' stamps, and a
repository the port's fleet wrote checks clean and restores
byte-identical under the reference. The replica failure drill of
tests/test_fleet_chaos.py runs on the port under its seven seeded
schedules with the same contract. Everything runs with
``device="cpu"``; trees are the reference tests' own (90-150 KB files,
64 KiB packs, one backup worker), made from a seed with numpy.
"""

import json
import shutil
import threading
import time
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from volsync_tpu.engine.restore import restore_snapshot as j_restore
from volsync_tpu.objstore.store import FsObjectStore as JFs
from volsync_tpu.repo.repository import Repository as JRepo
from volsync_tpu.service import fleet as jfleet
from volsync_tpu_torch.engine.backup import TreeBackup
from volsync_tpu_torch.engine.restore import restore_snapshot
from volsync_tpu_torch.metrics import GLOBAL as METRICS
from volsync_tpu_torch.objstore.faultstore import (
    FaultSchedule,
    FaultSpec,
    FaultStore,
)
from volsync_tpu_torch.objstore.store import FsObjectStore, MemObjectStore
from volsync_tpu_torch.repo.repository import Repository, StaleWriterError
from volsync_tpu_torch.resilience import (
    CircuitBreaker,
    ResilientStore,
    RetryPolicy,
    reset_breakers,
)
from volsync_tpu_torch.service.admission import AdmissionController
from volsync_tpu_torch.service.fleet import (
    FLEET_PREFIX,
    FleetRouter,
    ReplicaGroup,
    ReplicaHeartbeat,
    ReplicaStamp,
)
from volsync_tpu_torch.service.gc import ContinuousGC
from volsync_tpu_torch.service.tenants import TenantRegistry

torch.set_num_threads(1)

DEV = "cpu"
CHUNKER = {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
           "seed": 7, "align": 4096}


@pytest.fixture(autouse=True)
def _fresh_port_breakers():
    yield
    reset_breakers()


def _value(family) -> float:
    """The single series of an unlabelled in-memory counter."""
    return family.values().get((), 0.0)


def _stamp(rid="r00", address="h:1", headroom=4, backlog=0,
           age_seconds=0.0, cls=ReplicaStamp, **kw):
    when = (datetime.now(timezone.utc)
            - timedelta(seconds=age_seconds)).isoformat()
    return cls(replica_id=rid, address=address, headroom=headroom,
               backlog=backlog, writer_id=kw.get("writer_id", "w"),
               generation=kw.get("generation", 1), seq=kw.get("seq", 1),
               time=when)


# -- replica stamps ----------------------------------------------------------

def test_stamp_round_trip_and_torn_payloads():
    stamp = _stamp(headroom=7, backlog=3)
    assert ReplicaStamp.from_json(stamp.to_json()) == stamp
    for torn in (b"", b"{", b"[]", b'{"replica_id": "x"}'):
        with pytest.raises(ValueError):
            ReplicaStamp.from_json(torn)


def test_stamp_ttl_expiry():
    assert not _stamp(age_seconds=1.0).expired(10.0)
    assert _stamp(age_seconds=11.0).expired(10.0)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stamps_byte_identical_across_packages(writer):
    """The same fields give the same bytes in both packages, and a stamp
    either writes parses in the other into the same fields."""
    fields = dict(replica_id="r03", address="10.0.0.7:50051", headroom=5,
                  backlog=11, writer_id="ab" * 8, generation=9, seq=42,
                  time=datetime(2026, 1, 2, 3, 4, 5, 678901,
                                tzinfo=timezone.utc).isoformat())
    port, ref = ReplicaStamp(**fields), jfleet.ReplicaStamp(**fields)
    assert port.to_json() == ref.to_json()
    payload = (port if writer == "port" else ref).to_json()
    for cls in (ReplicaStamp, jfleet.ReplicaStamp):
        back = cls.from_json(payload)
        assert vars(back) == fields and back.to_json() == payload
    assert port.age() == pytest.approx(ref.age(), abs=1.0)


# -- heartbeat ---------------------------------------------------------------

def test_heartbeat_beats_and_retires():
    mem = MemObjectStore()
    hb = ReplicaHeartbeat(mem, "r07", "h:9", headroom_fn=lambda: 5,
                          backlog_fn=lambda: 2, beat_seconds=999)
    s1 = hb.beat()
    s2 = hb.beat()
    assert (s1.seq, s2.seq) == (1, 2)  # beat extends, seq orders
    stored = ReplicaStamp.from_json(mem.get(f"{FLEET_PREFIX}r07"))
    assert (stored.address, stored.headroom, stored.backlog) == ("h:9", 5, 2)
    hb.stop(retire=True)
    assert not mem.exists(f"{FLEET_PREFIX}r07")


def test_heartbeat_kill_path_leaves_stamp_to_expire():
    mem = MemObjectStore()
    hb = ReplicaHeartbeat(mem, "r07", "h:9", headroom_fn=lambda: 5,
                          beat_seconds=999)
    hb.beat()
    hb.stop(retire=False)  # died like a killed pod
    assert mem.exists(f"{FLEET_PREFIX}r07")  # stamp ages toward TTL


def test_heartbeat_survives_store_failure():
    class _DeadStore(MemObjectStore):
        def put(self, key, data):
            raise OSError("store down")

    hb = ReplicaHeartbeat(_DeadStore(), "r07", "h:9",
                          headroom_fn=lambda: 5, beat_seconds=999)
    with pytest.raises(OSError):
        hb.beat()  # explicit beat surfaces the error...
    hb.start()  # ...the background path swallows and counts it
    hb.stop(retire=False)
    assert hb.missed >= 1


# -- router ------------------------------------------------------------------

def test_router_routes_by_headroom_then_backlog():
    mem = MemObjectStore()
    for rid, headroom, backlog in (("r00", 2, 9), ("r01", 6, 5),
                                   ("r02", 6, 1), ("r03", 0, 0)):
        st = _stamp(rid=rid, address=f"h:{rid}", headroom=headroom,
                    backlog=backlog)
        mem.put(f"{FLEET_PREFIX}{rid}", st.to_json())
    router = FleetRouter(mem, ttl_seconds=30.0)
    before = METRICS.fleet_routed_total.values().get(("r02",), 0.0)
    assert router.pick().replica_id == "r02"  # most headroom, least backlog
    assert METRICS.fleet_routed_total.values()[("r02",)] == before + 1
    assert METRICS.fleet_replica_headroom.values()[("r01",)] == 6
    assert router.pick(exclude=("r02",)).replica_id == "r01"
    # headroom 0 is never picked even when everyone else is excluded
    assert router.pick(exclude=("r00", "r01", "r02")) is None


def test_router_skips_expired_and_torn_stamps():
    mem = MemObjectStore()
    mem.put(f"{FLEET_PREFIX}dead",
            _stamp(rid="dead", age_seconds=60.0).to_json())
    mem.put(f"{FLEET_PREFIX}torn", b"{not json")
    mem.put(f"{FLEET_PREFIX}live", _stamp(rid="live").to_json())
    router = FleetRouter(mem, ttl_seconds=10.0)
    assert [s.replica_id for s in router.refresh()] == ["live"]
    assert router.pick().replica_id == "live"


def test_router_sibling_hint_is_cache_only_and_excludes_self():
    mem = MemObjectStore()
    mem.put(f"{FLEET_PREFIX}r00", _stamp(rid="r00", address="a:0",
                                         headroom=9).to_json())
    mem.put(f"{FLEET_PREFIX}r01", _stamp(rid="r01", address="a:1",
                                         headroom=3).to_json())
    router = FleetRouter(mem, ttl_seconds=30.0)
    assert router.sibling_hint("r00") is None  # cold cache: no I/O
    router.refresh()
    assert router.sibling_hint("r00") == "a:1"  # self excluded
    assert router.sibling_hint("r99") == "a:0"  # best overall

    class _Tripwire(MemObjectStore):
        def list(self, prefix=""):
            raise AssertionError("sibling_hint must not touch the store")

        def get(self, key):
            raise AssertionError("sibling_hint must not touch the store")

    router.store = _Tripwire()
    assert router.sibling_hint("r00") == "a:1"  # still served from cache


def test_reference_router_routes_to_port_replicas(tmp_path):
    """Port replicas' heartbeats in a shared directory: the reference's
    router reads them, ranks them as the port's does, and hints the
    same sibling."""
    root = tmp_path / "store"
    fs = FsObjectStore(str(root))
    Repository.init(fs, device=DEV)
    group = ReplicaGroup([FsObjectStore(str(root)) for _ in range(3)],
                         router_store=fs, ttl_seconds=30.0,
                         beat_seconds=999.0, batch_window_ms=0,
                         max_streams=4, device=DEV)
    with group:
        busy = group.replica("r01").server.admission
        tickets = [busy.admit_stream("t") for _ in range(3)]
        group.beat_all()
        ref = jfleet.FleetRouter(JFs(str(root)), ttl_seconds=30.0)
        port = FleetRouter(FsObjectStore(str(root)), ttl_seconds=30.0)
        got = {s.replica_id: (s.headroom, s.address, s.writer_id,
                              s.generation) for s in ref.refresh()}
        want = {r.replica_id: (r.server.admission.headroom(), r.address,
                               r.repo.writer_id, r.repo.generation)
                for r in group.replicas}
        assert got == want and got["r01"][0] == 1
        port.refresh()
        for exclude in ((), ("r00",), ("r00", "r02")):
            assert ref.pick(exclude=exclude).replica_id \
                == port.pick(exclude=exclude).replica_id
        assert ref.sibling_hint("r00") == port.sibling_hint("r00") \
            == group.replica("r02").address
        for t in tickets:
            busy.release(t)


# -- admission headroom -------------------------------------------------------

def test_headroom_tracks_admits_and_drain():
    ctrl = AdmissionController(TenantRegistry(), max_streams=3,
                               tenant_streams=2, max_queued=10,
                               retry_after=0.1)
    assert ctrl.headroom() == 3
    t = ctrl.admit_stream("a")
    assert ctrl.headroom() == 2
    ctrl.release(t)
    assert ctrl.headroom() == 3
    ctrl.begin_drain()
    assert ctrl.headroom() == 0  # draining replicas advertise nothing


# -- continuous GC service ----------------------------------------------------

def _garbage_repo(tmp_path):
    """A repo with a deleted snapshot's worth of garbage to collect."""
    fs = FsObjectStore(str(tmp_path / "store"))
    Repository.init(fs, chunker=CHUNKER, device=DEV)
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.RandomState(3)
    for i in range(3):
        (src / f"f{i}.bin").write_bytes(rng.bytes(120_000 + i))
    repo = Repository.open(fs, device=DEV)
    repo.PACK_TARGET = 64 * 1024
    doomed, _ = TreeBackup(repo, workers=1).run(src)
    (src / "f0.bin").write_bytes(rng.bytes(120_000))
    kept, _ = TreeBackup(repo, workers=1).run(src)
    repo.delete_snapshot(doomed)
    return fs, kept


def test_gc_cycle_outcomes(tmp_path):
    fs, _kept = _garbage_repo(tmp_path)
    before = METRICS.gc_cycles.values()
    gc = ContinuousGC(fs, interval_seconds=999, grace_seconds=0.01,
                      device=DEV)
    assert gc.run_once() == "ok"
    assert gc.last_report is not None
    assert gc._open().device.type == "cpu"

    # contended: a peer holds a conflicting prune-mode lock
    peer = Repository.open(fs, device=DEV)
    with peer.lock(mode="prune"):
        assert gc.run_once() == "contended"
    assert gc.run_once() == "ok"  # lock released: next cycle proceeds

    # fenced: a takeover marked this GC writer dead mid-flight — the
    # cycle reports it and the NEXT cycle reopens a fresh generation
    victim = gc._open()
    old_writer = victim.writer_id
    fs.put(f"fenced/{old_writer}", json.dumps(
        {"writer": "peer", "time":
         datetime.now(timezone.utc).isoformat()}).encode())
    assert gc.run_once() == "fenced"
    assert gc.run_once() == "ok"
    assert gc._open().writer_id != old_writer  # reopened, new identity

    # error: store weather mid-cycle drops the handle; the next reopens
    gc._repo.store = None
    assert gc.run_once() == "error" and gc._repo is None
    assert gc.run_once() == "ok"
    assert gc.outcomes == {"ok": 4, "contended": 1, "fenced": 1,
                           "error": 1}
    after = METRICS.gc_cycles.values()
    assert {k[0]: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)} == gc.outcomes
    assert Repository.open(fs, device=DEV).check(read_data=True) == []


def test_gc_rejects_stop_the_world_grace():
    with pytest.raises(ValueError, match="grace_seconds > 0"):
        ContinuousGC(MemObjectStore(), grace_seconds=0, device=DEV)


def test_gc_background_loop_runs_and_stops(tmp_path):
    fs, _kept = _garbage_repo(tmp_path)
    gc = ContinuousGC(fs, interval_seconds=0.01, grace_seconds=0.01,
                      device=DEV)
    done = threading.Event()
    orig = gc.run_once

    def counting():
        out = orig()
        if gc.cycles >= 2:
            done.set()
        return out

    gc.run_once = counting
    with gc:
        assert done.wait(10.0), "GC loop never completed two cycles"
    assert gc.cycles >= 2 and gc._thread is None


def test_repair_clears_stale_fleet_stamps(tmp_path, monkeypatch):
    monkeypatch.setenv("VOLSYNC_LOCK_STALE_S", "5")
    fs, _kept = _garbage_repo(tmp_path)
    fs.put(f"{FLEET_PREFIX}dead",
           _stamp(rid="dead", age_seconds=60.0).to_json())
    fs.put(f"{FLEET_PREFIX}torn", b"{not json")
    fs.put(f"{FLEET_PREFIX}live", _stamp(rid="live").to_json())
    report = Repository.open(fs, device=DEV).repair(grace_seconds=0.01)
    assert f"{FLEET_PREFIX}dead" in report["stale_markers"]
    assert f"{FLEET_PREFIX}torn" in report["stale_markers"]
    assert not fs.exists(f"{FLEET_PREFIX}dead")
    assert not fs.exists(f"{FLEET_PREFIX}torn")
    assert fs.exists(f"{FLEET_PREFIX}live")  # live replicas untouched


# -- the replica failure drill -------------------------------------------------

N_REPLICAS = 3
N_JOBS = 5


def _chaos_stack(root, seed, specs):
    """open_store()'s layering with the drill's retry policy: attempts
    high enough that p^attempts is negligible, no wall-clock backoff, a
    breaker that never trips."""
    fs = FsObjectStore(str(root))
    faults = FaultStore(fs, FaultSchedule(seed=seed, specs=list(specs)))
    policy = RetryPolicy(site="chaos", max_attempts=10, base_delay=0.001,
                         max_delay=0.01, sleep_fn=lambda s: None)
    top = ResilientStore(faults, policy=policy,
                         breaker=CircuitBreaker("chaos", threshold=10**9,
                                                reset_seconds=0.01))
    return fs, faults, top


def _age_locks(fs, *, seconds: float) -> int:
    """Backdate every lock's refresh stamp — the fingerprint of holders
    that died a while ago."""
    stamped = 0
    when = (datetime.now(timezone.utc)
            - timedelta(seconds=seconds)).isoformat()
    for key in list(fs.list("locks/")):
        info = json.loads(fs.get(key))
        info["time"] = when
        fs.put(key, json.dumps(info).encode())
        stamped += 1
    return stamped


def _job_tree(tmp_path, j):
    rng = np.random.RandomState(60 + j)
    src = tmp_path / f"job{j}"
    src.mkdir()
    for i in range(2):
        (src / f"f{i}.bin").write_bytes(rng.bytes(90_000 + 13 * i + 7 * j))
    return src


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A repository holding one kept snapshot plus a deleted one's
    unique chunks, so the continuous GC has victims to mark WHILE the
    fleet serves jobs; each schedule works on a copy of it."""
    base = tmp_path_factory.mktemp("seeded")
    fs = FsObjectStore(str(base / "store"))
    Repository.init(fs, chunker=CHUNKER, device=DEV)
    pre, kept = _seed_garbage(fs, base)
    return base / "store", pre, kept


def _seed_garbage(fs, tmp_path):
    pre = tmp_path / "pre"
    pre.mkdir()
    rng = np.random.RandomState(77)
    for i in range(4):
        (pre / f"g{i}.bin").write_bytes(rng.bytes(150_000 + 11 * i))
    repo = Repository.open(fs, device=DEV)
    repo.PACK_TARGET = 64 * 1024
    doomed, _ = TreeBackup(repo, workers=1).run(pre)
    for i in range(2):
        (pre / f"g{i}.bin").write_bytes(rng.bytes(150_000 + 11 * i))
    kept, _ = TreeBackup(repo, workers=1).run(pre)
    repo.delete_snapshot(doomed)
    return pre, kept


#: The seven seeded schedules of tests/test_fleet_chaos.py, built with the
#: port's FaultSpec (weather on every replica, one replica's extras, the
#: GC's own faults, and the fleet-level kill of r00).
FLEET_SCHEDULES = [
    ("fleet-transient", 2101, dict(
        replica_specs=[FaultSpec(kind="transient", p=0.15),
                       FaultSpec(kind="transient", at=3)])),
    ("fleet-throttle-latency", 2202, dict(
        replica_specs=[FaultSpec(kind="throttle", p=0.10),
                       FaultSpec(kind="latency", p=0.20, latency=0.001),
                       FaultSpec(kind="throttle", at=4)])),
    ("fleet-partition", 2303, dict(
        extra={0: [FaultSpec(kind="partition", at=3, op="put",
                             latency=0.3)]})),
    ("fleet-kill-mid-stream", 2404, dict(
        kill=True,
        extra={0: [FaultSpec(kind="crash", at=2, op="put",
                             key_prefix="data/")]})),
    ("fleet-gc-weather", 2505, dict(
        replica_specs=[FaultSpec(kind="transient", p=0.10),
                       FaultSpec(kind="transient", at=3)],
        gc_specs=[FaultSpec(kind="transient", p=0.20)])),
    ("fleet-gc-crash", 2606, dict(
        gc_specs=[FaultSpec(kind="crash", at=1, op="put",
                            key_prefix="pending-delete/")])),
    ("fleet-mixed", 2707, dict(
        replica_specs=[FaultSpec(kind="transient", p=0.10),
                       FaultSpec(kind="throttle", p=0.05),
                       FaultSpec(kind="latency", p=0.10, latency=0.001),
                       FaultSpec(kind="truncated_read", p=0.10,
                                 op="get_range"),
                       FaultSpec(kind="transient", at=3)],
        gc_specs=[FaultSpec(kind="transient", p=0.10)])),
]


@pytest.mark.parametrize("name,seed,cfg", FLEET_SCHEDULES,
                         ids=[s[0] for s in FLEET_SCHEDULES])
def test_chaos_fleet(tmp_path, monkeypatch, seeded, name, seed, cfg):
    """3 fenced port replicas on one repository plus a continuous GC,
    under one seeded schedule: every job completes on some replica, a
    killed replica's lock is taken over and its writer fenced, the GC
    keeps its cadence and never sweeps a live pack, and the repository
    checks clean and restores byte-identical through the unfaulted
    store, under the port and under the reference."""
    monkeypatch.setenv("VOLSYNC_LOCK_STALE_S", "5")
    # The reference's drill holds each lock for well under its 5 s
    # horizon; the CPU twins take longer a job, so live holders here
    # re-stamp their locks every second (the refresh well inside the
    # horizon, as the 5- and 30-minute defaults are).
    monkeypatch.setattr(Repository, "LOCK_REFRESH_SECONDS", 1.0)
    replica_specs = cfg.get("replica_specs", [])
    gc_specs = cfg.get("gc_specs", [])
    extra = cfg.get("extra", {})
    kill = cfg.get("kill", False)

    template, pre, kept = seeded
    root = tmp_path / "store"
    shutil.copytree(template, root)
    fs = FsObjectStore(str(root))
    trees = [_job_tree(tmp_path, j) for j in range(N_JOBS)]

    stacks = [_chaos_stack(root, seed + t,
                           list(replica_specs) + list(extra.get(t, [])))
              for t in range(N_REPLICAS)]
    _g_fs, g_faults, g_top = _chaos_stack(root, seed + 99, gc_specs)

    if kill:
        # a stalled r00 process from "before the kill": holds a shared
        # lock over the UNFAULTED store so its late publish can be
        # observed after the fleet fences it
        zombie = Repository.open(fs, device=DEV)
        zombie._write_lock("shared")
        zombie_writer = zombie.writer_id
        fenced_before = _value(METRICS.repo_fenced_publishes_total)
    failovers_before = _value(METRICS.fleet_failovers_total)

    group = ReplicaGroup([st[2] for st in stacks], router_store=fs,
                         ttl_seconds=30.0, beat_seconds=999.0,
                         batch_window_ms=0, max_streams=4, device=DEV)
    for r in group.replicas:
        r.repo.PACK_TARGET = 64 * 1024
        r.repo.default_lock_wait = 10.0
        assert r.repo.device.type == r.server.device.type == "cpu"
    # The reference's drill cycles every 0.05 s; here every 0.5 s, since
    # each cycle's store walk holds the interpreter while the jobs,
    # many times longer on the CPU twins, wait for it.
    gc = ContinuousGC(g_top, interval_seconds=0.5, grace_seconds=0.2,
                      lock_wait=2.0, device=DEV)

    snaps: list = []
    killed_mid_run = False
    with group, gc:
        for j, tree in enumerate(trees):
            group.beat_all()
            snap, rid = group.submit_backup(tree, hostname=f"job{j}")
            snaps.append(snap)
            assert snap and rid in {r.replica_id for r in group.replicas}
            if kill and not killed_mid_run and stacks[0][1].crashed:
                group.kill("r00")
                killed_mid_run = True
        group.beat_all()
        deadline = time.monotonic() + 10.0
        while gc.cycles < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert len(snaps) == N_JOBS

    # -- the schedule actually exercised something ------------------------
    if replica_specs:
        assert all(st[1].injected for st in stacks), \
            "a replica schedule never fired — drill tested nothing"
    for t in extra:
        assert stacks[t][1].injected, \
            f"replica {t}'s extra schedule never fired"
    assert gc.cycles >= 2
    if any(s.kind == "crash" for s in gc_specs):
        assert g_faults.crashed
        assert gc.outcomes.get("error", 0) >= 1
    if "partition" in {s.kind for s in extra.get(0, [])} or kill:
        assert _value(METRICS.fleet_failovers_total) > failovers_before

    # -- kill drill: takeover + fencing + late publish refused ------------
    if kill:
        assert killed_mid_run, "the kill schedule never killed r00"
        assert group.replica("r00")._killed
        assert fs.exists("fleet/r00")  # never retired: it lingers, aging
        # its lock (and the zombie's) linger until someone takes them
        # over: here, or already the GC's own cycles, since a drill on
        # the CPU twins runs past the 5 s horizon
        assert _age_locks(fs, seconds=60) >= 1 \
            or fs.exists(f"fenced/{zombie_writer}")
        retry = Repository.open(fs, device=DEV)
        retry.default_lock_wait = 10.0
        retry.prune(grace_seconds=0.2)
        assert fs.exists(f"fenced/{zombie_writer}"), \
            "takeover never fenced the dead replica's writer"
        with pytest.raises(StaleWriterError):
            TreeBackup(zombie, workers=1).run(trees[0],
                                              hostname="zombie-late")
        assert _value(METRICS.repo_fenced_publishes_total) > fenced_before

    # -- end state through the UNFAULTED store ----------------------------
    time.sleep(0.3)  # grace expiry for anything the GC marked late
    _age_locks(fs, seconds=60)
    final = Repository.open(fs, device=DEV)
    final.default_lock_wait = 10.0
    final.prune(grace_seconds=0.2)
    time.sleep(0.3)
    final.prune(grace_seconds=0.2)
    assert list(fs.list("pending-delete/")) == [], \
        "continuous GC left pending-delete debris"

    check = Repository.open(fs, device=DEV)
    assert check.check(read_data=True) == []
    ids = [s[0] for s in check.list_snapshots()]
    assert set(snaps) <= set(ids), "an admitted job's snapshot vanished"
    for j, snap in enumerate(snaps):
        dst = tmp_path / f"dst{j}"
        prev = len(ids) - 1 - ids.index(snap)
        restore_snapshot(Repository.open(fs, device=DEV), dst, previous=prev)
        for f in sorted(p.name for p in trees[j].iterdir()):
            assert (dst / f).read_bytes() == (trees[j] / f).read_bytes(), f
    dstk = tmp_path / "dstk"
    prev = len(ids) - 1 - ids.index(kept)
    restore_snapshot(Repository.open(fs, device=DEV), dstk, previous=prev)
    for f in sorted(p.name for p in pre.iterdir()):
        assert (dstk / f).read_bytes() == (pre / f).read_bytes(), f
    with check._lock:
        packs = [p for p in check._index.live_packs() if p]
    for p in packs:
        assert fs.exists(f"data/{p[:2]}/{p}"), \
            f"index references missing pack {p} — a live pack was swept"

    # -- the reference reads what the port's fleet wrote ------------------
    jrepo = JRepo.open(JFs(str(root)))
    assert jrepo.check(read_data=True) == []
    assert [s[0] for s in jrepo.list_snapshots()] == ids
    j = N_JOBS - 1
    jdst = tmp_path / "jdst"
    j_restore(JRepo.open(JFs(str(root))), jdst,
              previous=len(ids) - 1 - ids.index(snaps[j]))
    for f in sorted(p.name for p in trees[j].iterdir()):
        assert (jdst / f).read_bytes() == (trees[j] / f).read_bytes(), f
