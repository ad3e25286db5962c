"""The port's control plane against the reference's
(``volsync_tpu_torch/controller/``, ``cluster/`` and the movers'
builders against ``volsync_tpu/``).

- The cases of ``tests/test_statemachine.py`` drive one fake machine
  class through both packages' state machines on one fake clock: every
  pass's requeue, the machine's timestamps, conditions and metric hooks
  are equal.
- The cron parsers give equal next-fire times, and refuse the same
  specs.
- Each mover's builder, source and destination (syncthing has no
  destination), reconciles once in each package's ``Cluster`` with no
  runner (envtest style): the Jobs, Deployments, Services, Volumes,
  VolumeSnapshots, ServiceAccounts, Roles, RoleBindings, the Secrets' key
  sets and the events compare equal once uids, resource versions,
  timestamps and generated keys are normalised."""

from __future__ import annotations

import dataclasses
from datetime import datetime, timedelta, timezone
from pathlib import Path

import pytest

from volsync_tpu import api as japi
from volsync_tpu.cluster.cluster import Cluster as JCluster
from volsync_tpu.cluster import objects as jobjects
from volsync_tpu.cluster.storage import StorageProvider as JStorage
from volsync_tpu.controller import cron as jcron
from volsync_tpu.controller import reconcilers as jrec
from volsync_tpu.controller import statemachine as jsm
from volsync_tpu.metrics import Metrics as JMetrics
from volsync_tpu.movers import base as jbase
from volsync_tpu_torch import api as tapi
from volsync_tpu_torch.cluster import objects as tobjects
from volsync_tpu_torch.cluster.cluster import Cluster as TCluster
from volsync_tpu_torch.cluster.storage import StorageProvider as TStorage
from volsync_tpu_torch.controller import cron as tcron
from volsync_tpu_torch.controller import reconcilers as trec
from volsync_tpu_torch.controller import statemachine as tsm
from volsync_tpu_torch.metrics import Metrics as TMetrics
from volsync_tpu_torch.movers import base as tbase

NOW = datetime(2026, 7, 29, 12, 0, 30, tzinfo=timezone.utc)


class FakeMachine:
    """``tests/test_statemachine.py``'s fake machine, over either
    package's ``Result``."""

    def __init__(self, result_cls, schedule=None, manual=None):
        self.schedule = schedule
        self.manual = manual
        self._last_manual = None
        self._lsst = None
        self._lst = None
        self._dur = None
        self._nst = None
        self.sync_result = result_cls.complete()
        self.cleanup_result = result_cls.complete()
        self.sync_calls = 0
        self.cleanup_calls = 0
        self.conditions = {}
        self.oos = None
        self.missed = 0
        self.durations = []

    def cronspec(self):
        return self.schedule

    def creation_time(self):
        return None

    def manual_tag(self):
        return self.manual

    def last_manual_sync(self):
        return self._last_manual

    def set_last_manual_sync(self, tag):
        self._last_manual = tag

    def last_sync_start_time(self):
        return self._lsst

    def set_last_sync_start_time(self, t):
        self._lsst = t

    def last_sync_time(self):
        return self._lst

    def set_last_sync_time(self, t):
        self._lst = t

    def last_sync_duration(self):
        return self._dur

    def set_last_sync_duration(self, d):
        self._dur = d

    def next_sync_time(self):
        return self._nst

    def set_next_sync_time(self, t):
        self._nst = t

    def set_condition(self, ctype, status, reason, message):
        self.conditions[ctype] = (status, reason)

    def synchronize(self):
        self.sync_calls += 1
        return self.sync_result

    def cleanup(self):
        self.cleanup_calls += 1
        return self.cleanup_result

    def set_out_of_sync(self, oos):
        self.oos = oos

    def increment_missed_intervals(self):
        self.missed += 1

    def observe_sync_duration(self, seconds):
        self.durations.append(seconds)

    def state(self) -> dict:
        return {k: v for k, v in vars(self).items()
                if k not in ("sync_result", "cleanup_result")
                and not callable(v)}


class Driver:
    """Runs one package's state machine over a ``FakeMachine`` and
    records, after each pass, its result and the machine's state."""

    def __init__(self, sm, result_cls, **kw):
        self.sm, self.result_cls = sm, result_cls
        self.m = FakeMachine(result_cls, **kw)
        self.record = []

    def run(self, now):
        try:
            r = self.sm.run(self.m, now)
            out = ("ok", r.requeue_after)
        except RuntimeError as e:
            out = ("raised", str(e))
        self.record.append((out, self.sm.current_state(self.m),
                            self.m.state()))
        return out

    def result(self, kind, *args):
        return getattr(self.result_cls, kind)(*args)


def _no_trigger(d):
    d.run(NOW)
    d.run(NOW)


def _in_progress(d):
    d.m.sync_result = d.result("in_progress")
    d.run(NOW)
    d.m.sync_result = d.result("complete")
    d.run(NOW + timedelta(seconds=90))


def _schedule(d):
    d.m.schedule = "*/5 * * * *"
    d.run(NOW)
    d.run(d.m._nst)
    d.run(d.m._nst)


def _manual(d):
    d.m.manual = "v1"
    d.run(NOW)
    d.run(NOW)
    d.m.manual = "v2"
    d.run(NOW)
    d.run(NOW)


def _missed_deadline(d):
    d.m.schedule = "*/5 * * * *"
    d.m.sync_result = d.result("in_progress")
    d.run(NOW)
    d.run(d.m._nst)
    late = datetime(2026, 7, 29, 12, 10, 0, tzinfo=timezone.utc)
    d.run(late)
    d.m.sync_result = d.result("complete")
    d.run(late + timedelta(seconds=10))


def _manual_and_schedule(d):
    d.m.schedule, d.m.manual = "0 0 1 1 *", "v1"
    d.run(NOW)


def _outage(d):
    d.m.schedule = "0 * * * *"
    d.run(NOW)
    d.run(datetime(2026, 7, 29, 15, 20, 0, tzinfo=timezone.utc))


def _cleanup_in_progress(d):
    d.m.cleanup_result = d.result("in_progress")
    d.run(NOW)
    d.run(NOW + timedelta(seconds=1))


def _sync_error(d):
    def boom():
        raise RuntimeError("mover exploded")

    d.m.synchronize = boom
    d.run(NOW)


def _retry(d):
    d.m.sync_result = d.result("retry", timedelta(seconds=7))
    d.run(NOW)
    d.run(NOW + timedelta(seconds=7))


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _no_trigger, _in_progress, _schedule, _manual, _missed_deadline,
    _manual_and_schedule, _outage, _cleanup_in_progress, _sync_error,
    _retry)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_state_machine_cases_equal_across_packages(name):
    ref = Driver(jsm, jbase.Result)
    port = Driver(tsm, tbase.Result)
    SCENARIOS[name](ref)
    SCENARIOS[name](port)
    assert port.record == ref.record
    assert len(ref.record) >= 1


def test_state_machine_constants_equal():
    for n in ("INITIAL", "SYNCHRONIZING", "CLEANING_UP", "COND_SYNCHRONIZING",
              "REASON_SYNC_IN_PROGRESS", "REASON_WAITING_FOR_SCHEDULE",
              "REASON_WAITING_FOR_MANUAL", "REASON_CLEANING_UP",
              "REASON_ERROR"):
        assert getattr(tsm, n) == getattr(jsm, n)


CRON_SPECS = ["0 3 * * *", "1,31 */2 * * *", "@daily", "@hourly",
              "@weekly", "@monthly", "@yearly", "0 0 * jan mon",
              "0 0 15 * fri", "0 0 * * 5-7", "0 0 * * 0-7",
              "0 0 29 2 *", "*/7 9-17 * * 1-5", "30 4 1,15 * *",
              "15 */3 * feb-apr sun"]


@pytest.mark.parametrize("spec", CRON_SPECS)
def test_cron_next_fire_times_equal(spec):
    js, ts = jcron.parse(spec), tcron.parse(spec)
    assert dataclasses.astuple(ts) == dataclasses.astuple(js)
    for start in (datetime(2026, 1, 1, 0, 0), datetime(2026, 7, 29, 3, 0),
                  datetime(2027, 2, 28, 23, 59)):
        jt = tt = start
        for _ in range(12):
            jt, tt = js.next(jt), ts.next(tt)
            assert tt == jt


@pytest.mark.parametrize("spec", ["* * * *", "61 * * * *", "* 25 * * *",
                                  "a * * * *", "*/0 * * * *"])
def test_cron_refuses_the_same_specs(spec):
    with pytest.raises(jcron.CronError):
        jcron.parse(spec)
    with pytest.raises(tcron.CronError):
        tcron.parse(spec)


# -- envtest: one reconcile of each mover in each package's Cluster ---------

PKGS = {
    "reference": dict(api=japi, objects=jobjects, Cluster=JCluster,
                      Storage=JStorage, rec=jrec, Metrics=JMetrics,
                      base=jbase, movers="volsync_tpu.movers"),
    "port": dict(api=tapi, objects=tobjects, Cluster=TCluster,
                 Storage=TStorage, rec=trec, Metrics=TMetrics,
                 base=tbase, movers="volsync_tpu_torch.movers"),
}
KINDS = ("Job", "Deployment", "Service", "Volume", "VolumeSnapshot",
         "ServiceAccount", "Role", "RoleBinding", "Secret")
DROP = {"uid", "resourceVersion", "creationTimestamp", "lastTransitionTime",
        "startTime", "completionTime", "creationTime", "lastSyncStartTime",
        "lastSyncTime", "nextSyncTime", "lastPruned"}


def _world(pkg, root: Path):
    import importlib

    p = PKGS[pkg]
    cluster = p["Cluster"](storage=p["Storage"](root))
    catalog = p["base"].Catalog()
    for name in ("rsync", "rclone", "restic", "syncthing"):
        importlib.import_module(f"{p['movers']}.{name}").register(
            catalog, _NullCatalog())
    metrics = p["Metrics"]()
    return p, cluster, {
        "ReplicationSource": p["rec"].ReplicationSourceReconciler(
            cluster, catalog, metrics),
        "ReplicationDestination": p["rec"].ReplicationDestinationReconciler(
            cluster, catalog, metrics)}


class _NullCatalog:
    """A runner catalog that takes the entry points and keeps nothing:
    no runner runs in these cases."""

    def register(self, name, fn=None):
        return fn


def _setup(p, cluster, mover: str, role: str):
    """The volume, secrets and CR of one case; returns the CR's (kind,
    name)."""
    api, objects = p["api"], p["objects"]
    meta = api.ObjectMeta
    vol = cluster.create(objects.Volume(
        metadata=meta(name="data", namespace="default"),
        spec=objects.VolumeSpec(capacity=1 << 30)))
    Path(vol.status.path, "f.bin").write_bytes(b"x" * 1000)
    cluster.create(objects.Secret(
        metadata=meta(name="repo", namespace="default"),
        data={"RESTIC_REPOSITORY": b"file:///repo", "RESTIC_PASSWORD": b"pw"}))
    cluster.create(objects.Secret(
        metadata=meta(name="rclone-conf", namespace="default"),
        data={"rclone.conf": b"[bucket]\ntype = local\n"}))
    trigger = api.ReplicationTrigger(manual="go")
    if role == "destination":
        spec = {
            "rsync": lambda: api.ReplicationDestinationRsyncSpec(
                copy_method=api.CopyMethod.SNAPSHOT),
            "rclone": lambda: api.ReplicationDestinationRcloneSpec(
                rclone_config_section="bucket", rclone_dest_path="b/p",
                rclone_config="rclone-conf",
                copy_method=api.CopyMethod.SNAPSHOT, capacity=1 << 30),
            "restic": lambda: api.ReplicationDestinationResticSpec(
                repository="repo", copy_method=api.CopyMethod.SNAPSHOT,
                capacity=1 << 30, previous=1),
        }[mover]()
        cluster.create(api.ReplicationDestination(
            metadata=meta(name="cr", namespace="default"),
            spec=api.ReplicationDestinationSpec(trigger=trigger,
                                                **{mover: spec})))
        return "ReplicationDestination"
    if mover == "rsync":
        # the source's keys come from a destination's reconcile
        cluster.create(api.ReplicationDestination(
            metadata=meta(name="dst", namespace="default"),
            spec=api.ReplicationDestinationSpec(
                trigger=trigger, rsync=api.ReplicationDestinationRsyncSpec(
                    copy_method=api.CopyMethod.SNAPSHOT))))
    spec = {
        "rsync": lambda: api.ReplicationSourceRsyncSpec(
            address="127.0.0.1", port=2222,
            ssh_keys="volsync-src-keys-dst",
            copy_method=api.CopyMethod.CLONE),
        "rclone": lambda: api.ReplicationSourceRcloneSpec(
            rclone_config_section="bucket", rclone_dest_path="b/p",
            rclone_config="rclone-conf",
            copy_method=api.CopyMethod.SNAPSHOT),
        "restic": lambda: api.ReplicationSourceResticSpec(
            repository="repo", copy_method=api.CopyMethod.CLONE,
            retain=api.ResticRetainPolicy(last=3, daily=2)),
        "syncthing": lambda: api.ReplicationSourceSyncthingSpec(
            peers=[api.SyncthingPeer(address="tcp://127.0.0.1:1",
                                     id="PEER")]),
    }[mover]()
    cluster.create(api.ReplicationSource(
        metadata=meta(name="cr", namespace="default"),
        spec=api.ReplicationSourceSpec(
            source_pvc="data", trigger=None if mover == "syncthing"
            else trigger, **{mover: spec})))
    return "ReplicationSource"


def _normalised(p, cluster, root: Path) -> dict:
    """Every object of ``KINDS``, and the events, as dicts with uids
    named by their object, resource versions and timestamps dropped,
    paths relative to the storage root, and secrets' values left out
    (generated keys)."""
    to_dict = p["api"].to_dict
    uids = {}
    objs = []
    for kind in KINDS + ("ReplicationSource", "ReplicationDestination"):
        for o in cluster.list(kind):
            uids[o.metadata.uid] = f"{kind}/{o.metadata.name}"
            objs.append(o)

    def norm(x):
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items() if k not in DROP}
        if isinstance(x, list):
            return [norm(v) for v in x]
        if isinstance(x, str):
            if x in uids:
                return uids[x]
            return x.replace(str(root), "<root>")
        return x

    out = {}
    for o in objs:
        d = to_dict(o)
        if o.kind == "Secret":
            d["data"] = sorted(o.data)
        if o.kind == "ReplicationDestination" and d.get("status", {}).get(
                "rsync", {}).get("address"):
            d["status"]["rsync"]["address"] = "<address>"
        out[f"{o.kind}/{o.metadata.name}"] = norm(d)
    out["events"] = sorted(
        (e.involved_kind, e.involved_name, e.type, e.reason, e.action)
        for e in cluster.list("Event"))
    return out


CASES = [("rsync", "source"), ("rsync", "destination"),
         ("rclone", "source"), ("rclone", "destination"),
         ("restic", "source"), ("restic", "destination"),
         ("syncthing", "source")]


@pytest.mark.parametrize("mover,role", CASES,
                         ids=[f"{m}-{r}" for m, r in CASES])
def test_one_reconcile_creates_equal_objects(tmp_path, mover, role):
    got = {}
    for pkg in PKGS:
        root = tmp_path / pkg
        p, cluster, recs = _world(pkg, root)
        kind = _setup(p, cluster, mover, role)
        if mover == "rsync" and role == "source":
            recs["ReplicationDestination"].reconcile("default", "dst",
                                                     now=NOW)
        result = recs[kind].reconcile("default", "cr", now=NOW)
        cr = cluster.get(kind, "default", "cr")
        got[pkg] = (result.requeue_after, _normalised(p, cluster, root),
                    [dataclasses.astuple(c)[:4] for c in
                     cr.status.conditions])
    assert got["port"] == got["reference"]
    objs = got["port"][1]
    made = {k.split("/")[0] for k in objs if "/" in k}
    # each case made its mover's payload and identity
    assert made & {"Job", "Deployment"}
    if mover != "syncthing":
        assert f"Job/volsync-{'src' if role == 'source' else 'dst'}-cr" in \
            objs or any(k.startswith("Job/volsync-rclone") for k in objs)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_syncthing_has_no_destination_and_a_spec_without_mover_parks(
        tmp_path, pkg):
    p, cluster, recs = _world(pkg, tmp_path)
    api = p["api"]
    cluster.create(api.ReplicationDestination(
        metadata=api.ObjectMeta(name="none", namespace="default"),
        spec=api.ReplicationDestinationSpec(
            trigger=api.ReplicationTrigger(manual="go"))))
    r = recs["ReplicationDestination"].reconcile("default", "none", now=NOW)
    assert r.requeue_after is None
    cr = cluster.get("ReplicationDestination", "default", "none")
    (cond,) = cr.status.conditions
    assert (cond.type, cond.status.value, cond.reason) == (
        "Synchronizing", "False", "Error")
