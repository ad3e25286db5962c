"""The port's CR types against the reference's (``volsync_tpu_torch/api/``
and ``cluster/objects.py`` against ``volsync_tpu/api/`` and
``cluster/objects.py``).

The cases of ``tests/test_api.py`` run on both packages, and every CR,
status and cluster object kind, filled from a seed in every field, goes
reference ``to_dict`` -> port ``from_dict`` -> port ``to_dict`` and back:
the dicts are equal both ways, so a CR or status written by either
package loads in the other (the state carried across)."""

from __future__ import annotations

import dataclasses
import enum
import random
import typing
from datetime import datetime, timedelta, timezone

import pytest

import volsync_tpu.api as japi
import volsync_tpu.api.common as jcommon
import volsync_tpu.api.types as jtypes
import volsync_tpu.cluster.objects as jobjects
import volsync_tpu_torch.api as tapi
import volsync_tpu_torch.api.common as tcommon
import volsync_tpu_torch.api.types as ttypes
import volsync_tpu_torch.cluster.objects as tobjects

PACKAGES = {"reference": (japi, jcommon), "port": (tapi, tcommon)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def make_source(api):
    return api.ReplicationSource(
        metadata=api.ObjectMeta(name="db-backup", namespace="prod"),
        spec=api.ReplicationSourceSpec(
            source_pvc="db-data",
            trigger=api.ReplicationTrigger(schedule="0 * * * *"),
            restic=api.ReplicationSourceResticSpec(
                copy_method=api.CopyMethod.SNAPSHOT,
                repository="restic-secret",
                prune_interval_days=7,
                retain=api.ResticRetainPolicy(daily=7, weekly=4, last=3),
            ),
        ),
    )


def test_source_roundtrip(pkg):
    api, _ = pkg
    d = api.to_dict(make_source(api))
    assert d["spec"]["sourcePvc"] == "db-data"
    assert d["spec"]["trigger"]["schedule"] == "0 * * * *"
    assert d["spec"]["restic"]["retain"]["daily"] == 7
    assert "rsync" not in d["spec"]
    back = api.from_dict(api.ReplicationSource, d)
    assert back.spec.restic.retain.weekly == 4
    assert back.spec.restic.copy_method is api.CopyMethod.SNAPSHOT
    assert back.metadata.key == ("prod", "db-backup")


def test_destination_roundtrip_times(pkg):
    api, _ = pkg
    rd = api.ReplicationDestination(
        metadata=api.ObjectMeta(name="dst"),
        spec=api.ReplicationDestinationSpec(
            restic=api.ReplicationDestinationResticSpec(
                repository="restic-secret",
                restore_as_of=datetime(2026, 7, 1, 12, 0,
                                       tzinfo=timezone.utc),
                previous=1,
            )
        ),
    )
    st = rd.ensure_status()
    st.last_sync_time = datetime(2026, 7, 2, tzinfo=timezone.utc)
    st.last_sync_duration = timedelta(seconds=42.5)
    back = api.from_dict(api.ReplicationDestination, api.to_dict(rd))
    assert back.spec.restic.restore_as_of.year == 2026
    assert back.status.last_sync_duration == timedelta(seconds=42.5)


def test_unknown_keys_ignored(pkg):
    api, _ = pkg
    d = api.to_dict(make_source(api))
    d["spec"]["futureField"] = {"x": 1}
    back = api.from_dict(api.ReplicationSource, d)
    assert back.spec.source_pvc == "db-data"


def test_condition_upsert_transition_time(pkg):
    api, common = pkg
    conds = []
    common.set_condition(conds, api.Condition(
        api.CONDITION_SYNCHRONIZING, api.ConditionStatus.TRUE,
        "SyncInProgress"))
    t0 = conds[0].last_transition_time
    assert t0 is not None
    common.set_condition(conds, api.Condition(
        api.CONDITION_SYNCHRONIZING, api.ConditionStatus.TRUE,
        "SyncInProgress", "m"))
    assert conds[0].last_transition_time == t0
    assert conds[0].message == "m"
    common.set_condition(conds, api.Condition(
        api.CONDITION_SYNCHRONIZING, api.ConditionStatus.FALSE,
        "CleaningUp"))
    assert conds[0].last_transition_time >= t0
    assert len(conds) == 1
    assert common.find_condition(
        conds, api.CONDITION_SYNCHRONIZING).reason == "CleaningUp"


def test_typed_list_fields_roundtrip(pkg):
    api, common = pkg
    rs = make_source(api)
    rs.spec.restic = None
    rs.spec.syncthing = api.ReplicationSourceSyncthingSpec(
        peers=[api.SyncthingPeer(address="tcp://a:22000", id="DEV1")])
    st = rs.ensure_status()
    common.set_condition(st.conditions, api.Condition(
        api.CONDITION_SYNCHRONIZING, api.ConditionStatus.TRUE,
        "SyncInProgress"))
    back = api.from_dict(api.ReplicationSource, api.to_dict(rs))
    assert isinstance(back.spec.syncthing.peers[0], api.SyncthingPeer)
    assert back.spec.syncthing.peers[0].id == "DEV1"
    assert isinstance(back.status.conditions[0], api.Condition)
    assert back.status.conditions[0].status is api.ConditionStatus.TRUE


def test_enum_yaml_safe(pkg):
    yaml = pytest.importorskip("yaml")
    api, _ = pkg
    y = yaml.safe_dump(api.to_dict(make_source(api)))
    assert "Snapshot" in y


# -- every kind, filled from a seed, across the packages --------------------

def _fill(cls, rng: random.Random, depth: int = 0):
    """An instance of the dataclass ``cls`` with every field set: strings,
    numbers, times (whole microseconds, UTC), enums, typed lists of
    dataclasses, plain dicts and lists of strings."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        kwargs[f.name] = _value(hints[f.name], f.name, rng, depth)
    return cls(**kwargs)


def _value(tp, name: str, rng: random.Random, depth: int):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        (tp,) = [a for a in typing.get_args(tp) if a is not type(None)]
        origin = typing.get_origin(tp)
    if origin in (list, typing.List):
        (elem,) = typing.get_args(tp)
        return [_value(elem, name, rng, depth + 1)
                for _ in range(rng.randint(1, 3))]
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return rng.choice(list(tp))
    if tp is str:
        return f"{name}-{rng.randrange(1 << 30):x}"
    if tp is bool:
        return rng.random() < 0.5
    if tp is int:
        return rng.randrange(1 << 40)
    if tp is float:
        return rng.randrange(1 << 20) / 64
    if tp is datetime:
        return datetime(2026, 1, 1, tzinfo=timezone.utc) + timedelta(
            microseconds=rng.randrange(1 << 45))
    if tp is timedelta:
        return timedelta(seconds=rng.randrange(1 << 20) / 64)
    if tp is dict:
        return {f"k{i}": f"v{rng.randrange(1000)}" for i in range(2)}
    if tp is list:
        return [f"item-{rng.randrange(1000)}" for _ in range(2)]
    if dataclasses.is_dataclass(tp):
        return _fill(tp, rng, depth + 1)
    raise TypeError(f"no filler for {tp!r}")


CR_KINDS = [
    "ReplicationSource", "ReplicationSourceStatus",
    "ReplicationSourceRsyncStatus", "ReplicationSourceResticStatus",
    "ReplicationSourceSyncthingStatus", "ReplicationDestination",
    "ReplicationDestinationStatus", "ReplicationDestinationRsyncStatus",
    "ReplicationSourceSpec", "ReplicationDestinationSpec",
]
OBJECT_KINDS = ["Volume", "VolumeSnapshot", "Job", "Service", "Secret",
                "ServiceAccount", "Role", "RoleBinding", "Deployment",
                "Event"]
KINDS = ([(jtypes, ttypes, k) for k in CR_KINDS]
         + [(jobjects, tobjects, k) for k in OBJECT_KINDS])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("jmod,tmod,kind", KINDS,
                         ids=[k for _, _, k in KINDS])
def test_every_kind_crosses_the_packages_both_ways(jmod, tmod, kind, seed):
    rng = random.Random(f"{kind}-{seed}")
    ref = _fill(getattr(jmod, kind), rng)
    d = japi.to_dict(ref)
    port = tapi.from_dict(getattr(tmod, kind), d)
    assert type(port).__module__.startswith("volsync_tpu_torch.")
    assert tapi.to_dict(port) == d
    rng = random.Random(f"{kind}-{seed}")
    port = _fill(getattr(tmod, kind), rng)
    d = tapi.to_dict(port)
    assert d == japi.to_dict(ref)  # the same seed fills the same values
    back = japi.from_dict(getattr(jmod, kind), d)
    assert japi.to_dict(back) == d
    # status and spec survive a second crossing unchanged
    assert japi.to_dict(japi.from_dict(
        getattr(jmod, kind), tapi.to_dict(tapi.from_dict(
            getattr(tmod, kind), d)))) == d


def test_the_packages_define_the_same_kinds_and_fields():
    for jmod, tmod in ((jtypes, ttypes), (jcommon, tcommon),
                       (jobjects, tobjects)):
        jnames = {n for n, v in vars(jmod).items()
                  if dataclasses.is_dataclass(v) and v.__module__ ==
                  jmod.__name__}
        tnames = {n for n, v in vars(tmod).items()
                  if dataclasses.is_dataclass(v) and v.__module__ ==
                  tmod.__name__}
        assert jnames == tnames
        for n in jnames:
            jf = [(f.name, str(f.type)) for f in
                  dataclasses.fields(getattr(jmod, n))]
            tf = [(f.name, str(f.type)) for f in
                  dataclasses.fields(getattr(tmod, n))]
            assert jf == tf, n
    assert sorted(japi.__all__) == sorted(tapi.__all__)
