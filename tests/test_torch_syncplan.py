"""The port's sync-protocol planner against the JAX package's, on the CPU.

The reference's decision table, hostile inputs, decide() modifiers,
stats-book EWMA cases and live feeds (``tests/test_syncplan.py``) run
through both packages' ``engine/protoplan.py`` / ``engine/syncstats.py``
and must give the same ``PlanDecision``s and snapshots; and
``TreeBackup(protocol="auto")`` from cold books gives the reference's
root tree, blob set and index entries at align 4096. Both packages'
books and link totals are process-wide, and the dedup feed reads
process-wide counters that earlier tests on the same worker advance, so
every test starts both from cold.
"""

import dataclasses
import math

import pytest
import torch

from volsync_tpu import resilience as jres
from volsync_tpu.engine import protoplan as jplan
from volsync_tpu.engine import syncstats as jstats
from volsync_tpu.engine.backup import TreeBackup as JBackup
from volsync_tpu.metrics import GLOBAL as JMETRICS
from volsync_tpu.objstore.store import MemObjectStore as JMem
from volsync_tpu.repo.repository import Repository as JRepo
from volsync_tpu_torch import envflags, resilience
from volsync_tpu_torch.engine import protoplan, syncstats
from volsync_tpu_torch.engine.backup import TreeBackup
from volsync_tpu_torch.metrics import GLOBAL as METRICS
from volsync_tpu_torch.movers import common
from volsync_tpu_torch.objstore.store import MemObjectStore
from volsync_tpu_torch.repo.repository import Repository

torch.set_num_threads(1)


def _index_children():
    return ([METRICS.index_queries.labels(result=r) for r in ("hit", "miss")],
            [JMETRICS.index_queries.labels(result=r)
             for r in ("hit", "miss")])


@pytest.fixture(autouse=True)
def _cold():
    """Both packages' books and link totals reset, and their dedup-query
    counters at 0 for the test (restored after)."""
    port, ref = _index_children()
    saved = ([c.value for c in port], [c._value.get() for c in ref])
    for c in port:
        c.value = 0.0
    for c in ref:
        c._value.set(0.0)
    for mod in (syncstats, jstats):
        mod.reset_books()
    resilience.reset_link_totals()
    jres.reset_link_totals()
    yield
    for mod in (syncstats, jstats):
        mod.reset_books()
    resilience.reset_link_totals()
    jres.reset_link_totals()
    for c, v in zip(port, saved[0]):
        c.value = v
    for c, v in zip(ref, saved[1]):
        c._value.set(v)


def _stats(pkg, change=1.0, dedup=0.0, bw=100e6, lat=1e-3,
           delta_n=1, dedup_n=1, link_n=1):
    return pkg.SyncStats(
        change_rate=change, dedup_hit_ratio=dedup, bandwidth_bps=bw,
        latency_s=lat, delta_samples=delta_n, dedup_samples=dedup_n,
        link_samples=link_n)


def _plain(d) -> tuple:
    """A PlanDecision as plain values (the packages' classes differ)."""
    return (d.protocol, d.reason,
            {p: dataclasses.astuple(s) for p, s in d.scores.items()},
            [dataclasses.astuple(s) for s in d.losing()])


def _both(kw: dict, **decide_kw) -> tuple:
    """decide() of both packages on the same stats; asserts they agree."""
    got = protoplan.decide(stats=_stats(syncstats, **kw), **decide_kw)
    want = jplan.decide(stats=_stats(jstats, **kw), **decide_kw)
    assert _plain(got) == _plain(want)
    return got


DECISION_TABLE = [
    (dict(size=1 << 20), dict(delta_n=0, dedup_n=0, link_n=0),
     protoplan.FULL_COPY),
    (dict(size=64 << 20), dict(change=0.9, dedup=0.95), protoplan.CDC_DEDUP),
    (dict(size=64 << 20), dict(change=0.01, dedup=0.0), protoplan.DELTA),
    (dict(size=8 << 20), dict(change=1.0, dedup=0.0), protoplan.FULL_COPY),
    (dict(size=512), dict(change=0.01, dedup=0.9, bw=1e6, lat=0.5),
     protoplan.FULL_COPY),
]


@pytest.mark.parametrize("size,stats,want", DECISION_TABLE)
def test_decision_table_equals_reference(size, stats, want):
    d = _both(stats, **size)
    assert (d.protocol, d.reason) == (want, protoplan.REASON_COST)
    assert set(d.scores) == set(protoplan.PROTOCOLS)


@pytest.mark.parametrize("bw", [0.0, -1.0, float("nan"), float("inf")])
def test_hostile_bandwidth_equals_reference(bw):
    d = _both(dict(bw=bw), size=1 << 20)
    assert all(math.isfinite(s.cost_s) for s in d.scores.values())


@pytest.mark.parametrize("size,stats", [
    (1 << 20, dict(change=float("nan"), dedup=float("nan"))),
    (0, {}), (-5, {}),
    (1 << 20, dict(lat=float("nan"))), (1 << 20, dict(lat=-1.0)),
])
def test_hostile_rates_and_sizes_equal_reference(size, stats):
    d = _both(stats, size=size)
    assert all(math.isfinite(s.cost_s) for s in d.scores.values())


@pytest.mark.parametrize("stats,kw", [
    (dict(delta_n=0, dedup_n=0, link_n=0), dict(allow_probe=True)),
    (dict(change=1.0, dedup=0.0, delta_n=3, dedup_n=0),
     dict(allow_probe=True)),
    ({}, dict(allow_probe=True)),
    (dict(change=0.01), dict(basis_exists=False, size=64 << 20)),
    (dict(delta_n=0, dedup_n=0), dict(full_cap=8 << 20, size=64 << 20)),
    (dict(delta_n=0, dedup_n=0), dict(full_cap=8 << 20)),
    ({}, dict(candidates=("full", "cdc"), block_len=1024)),
    ({}, dict(candidates=("warp",))),
])
def test_decide_modifiers_equal_reference(stats, kw):
    kw.setdefault("size", 1 << 20)
    _both(stats, **kw)


@pytest.mark.parametrize("proto", ["cdc", "delta", "warp"])
def test_override_equals_reference(monkeypatch, proto):
    monkeypatch.setenv("VOLSYNC_SYNC_PROTO", proto)
    d = _both(dict(delta_n=0, dedup_n=0), size=1 << 20)
    _both(dict(delta_n=0, dedup_n=0), size=1 << 20,
          candidates=("full", "cdc"))
    assert d.reason == (protoplan.REASON_COST if proto == "warp"
                        else protoplan.REASON_OVERRIDE)


def test_decide_bumps_selected_metric():
    child = METRICS.svc_protocol_selected.labels(protocol="full",
                                                 reason="cost")
    before = child.value
    protoplan.decide(1 << 20, _stats(syncstats, delta_n=0, dedup_n=0))
    assert child.value == before + 1
    assert METRICS.svc_protocol_selected.name == \
        "volsync_svc_protocol_selected_total"


def _books(alpha=None):
    return (syncstats.SyncStatsBook(alpha=alpha),
            jstats.SyncStatsBook(alpha=alpha))


def _same_snapshot(port, ref):
    assert dataclasses.astuple(port.snapshot()) == \
        dataclasses.astuple(ref.snapshot())


def test_ewma_decay_and_cold_snapshots_equal_reference():
    books = _books()
    _same_snapshot(*books)
    books = _books(alpha=0.5)
    for b in books:
        b.observe_delta(100, 1000)
        b.observe_delta(300, 1000)
        b.observe_dedup(9, 10)
        b.observe_link(10 << 20, 0.1)
        b.observe_rtt(0.02)
    _same_snapshot(*books)
    assert books[0].snapshot().change_rate == pytest.approx(0.2)
    for factor in (0.5, float("nan"), -1.0, 2.0):
        for b in books:
            b.decay(factor)
        _same_snapshot(*books)


@pytest.mark.parametrize("lit,total", [
    (float("nan"), 100), (10, float("nan")), (10, 0), (10, -1),
    (-5, 100), (10, float("inf")), (1 << 20, 0.0),
])
def test_hostile_observations_equal_reference(lit, total):
    books = _books()
    for b in books:
        b.observe_delta(lit, total)
        b.observe_dedup(lit, total)
        b.observe_link(lit, total)
        b.observe_rtt(total)
    _same_snapshot(*books)
    assert books[0].snapshot().delta_samples == 0


def test_env_knobs_equal_reference(monkeypatch):
    from volsync_tpu import envflags as jenv

    cases = [("VOLSYNC_PLAN_EWMA", v) for v in ("2.5", "junk", "0", "0.5")]
    cases += [("VOLSYNC_DELTA_BATCH", v) for v in ("0", "7", "x")]
    cases += [("VOLSYNC_SYNC_PROTO", v) for v in (" Delta ", "warp", "")]
    for name, value in cases:
        monkeypatch.setenv(name, value)
        for fn in ("plan_ewma_alpha", "delta_batch_files", "sync_protocol"):
            assert getattr(envflags, fn)() == getattr(jenv, fn)(), (name,
                                                                    value)
    monkeypatch.delenv("VOLSYNC_DELTA_BATCH")
    assert envflags.delta_batch_files() == 32


def test_book_registry_is_per_consumer():
    a = syncstats.book_for("rsync")
    assert syncstats.book_for("rsync") is a
    assert syncstats.book_for("restic") is not a
    a.observe_delta(1, 100)
    assert syncstats.book_for("restic").snapshot().delta_samples == 0
    syncstats.reset_books()
    assert syncstats.book_for("rsync") is not a


class _MemStore:
    def __init__(self):
        self.d = {}

    def put(self, key, data):
        self.d[key] = data

    def get(self, key):
        return self.d[key]


def test_resilient_store_feeds_the_book():
    store = resilience.ResilientStore(
        _MemStore(), policy=resilience.RetryPolicy(max_attempts=1))
    store.put("big", b"x" * (1 << 20))
    store.get("big")
    store.put("small", b"tiny")
    t = resilience.link_totals()
    assert (t["large_ops"], t["large_bytes"], t["small_ops"]) == (
        2, 2 << 20, 1)
    b = syncstats.SyncStatsBook()
    b.pull_link_timings()
    n = b.snapshot().link_samples
    assert n >= 1 and b.snapshot().bandwidth_bps > 0
    b.pull_link_timings()  # nothing new: nothing observed twice
    assert b.snapshot().link_samples == n


def test_pull_index_metrics_equals_reference():
    books = _books(alpha=1.0)
    books[0].pull_index_metrics(METRICS)
    books[1].pull_index_metrics(JMETRICS)
    for metrics in (METRICS, JMETRICS):
        metrics.index_queries.labels(result="hit").inc(30)
        metrics.index_queries.labels(result="miss").inc(10)
    books[0].pull_index_metrics()
    books[1].pull_index_metrics()
    _same_snapshot(*books)
    assert books[0].snapshot().dedup_hit_ratio == pytest.approx(0.75)
    books[0].pull_index_metrics()
    books[1].pull_index_metrics()
    _same_snapshot(*books)
    assert books[0].snapshot().dedup_samples == 1


def test_plan_protocol_probes_then_settles_as_the_reference():
    from volsync_tpu.movers import common as jcommon

    kw = dict(candidates=("full", "delta"))
    first = common.plan_protocol("rsync", 1 << 20, **kw)
    assert _plain(first) == _plain(jcommon.plan_protocol("rsync", 1 << 20,
                                                         **kw))
    assert (first.protocol, first.reason) == ("delta",
                                              protoplan.REASON_PROBE)
    for book in (syncstats.book_for("rsync"), jstats.book_for("rsync")):
        for _ in range(3):
            book.observe_delta(99, 100)
        book.observe_link(100 << 20, 1.0)
    then = common.plan_protocol("rsync", 1 << 20, **kw)
    assert _plain(then) == _plain(jcommon.plan_protocol("rsync", 1 << 20,
                                                        **kw))
    assert (then.protocol, then.reason) == ("full", protoplan.REASON_COST)


# -- TreeBackup(protocol="auto") ---------------------------------------------


def _chunker() -> dict:
    return {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
            "seed": 0x5EED_CDC1, "align": 4096}


def _tree(root, rng):
    """Files above min_size the planner prices one by one: the first
    probes CDC, the later ones are priced on the dedup it then saw."""
    root.mkdir()
    base = rng.bytes(150_000)
    (root / "a.bin").write_bytes(base)
    (root / "b.bin").write_bytes(base[:90_000] + rng.bytes(70_000))
    (root / "c.bin").write_bytes(rng.bytes(40_000))
    (root / "d").mkdir()
    (root / "d" / "e.bin").write_bytes(base)
    (root / "d" / "small").write_bytes(b"tiny")
    return root


def _index(repo) -> set:
    return {(b, repo._entry(b).type, repo._entry(b).length,
             repo._entry(b).raw_length) for b in repo.blob_ids()}


def _root(repo, snap):
    return dict(repo.list_snapshots())[snap]["tree"]


def test_auto_protocol_backup_equals_reference(tmp_path, rng, monkeypatch):
    monkeypatch.delenv("VOLSYNC_SYNC_PROTO", raising=False)
    src = _tree(tmp_path / "src", rng)
    decisions = {"port": [], "ref": []}

    def spy(into, fn):
        def wrapped(*a, **kw):
            d = fn(*a, **kw)
            into.append((d.protocol, d.reason))
            return d
        return wrapped

    from volsync_tpu.movers import common as jcommon

    monkeypatch.setattr(common, "plan_protocol",
                        spy(decisions["port"], common.plan_protocol))
    monkeypatch.setattr(jcommon, "plan_protocol",
                        spy(decisions["ref"], jcommon.plan_protocol))
    jrepo = JRepo.init(JMem(), chunker=_chunker())
    trepo = Repository.init(MemObjectStore(), chunker=_chunker(),
                            device="cpu")
    jsnap, _ = JBackup(jrepo, workers=1, protocol="auto").run(src)
    tsnap, _ = TreeBackup(trepo, workers=1, protocol="auto").run(src)
    assert decisions["port"] == decisions["ref"]
    assert {p for p, _ in decisions["port"]} == {"cdc", "full"}
    assert decisions["port"][0] == ("cdc", protoplan.REASON_PROBE)
    assert _root(trepo, tsnap) == _root(jrepo, jsnap)
    assert trepo.blob_ids() == jrepo.blob_ids()
    assert _index(trepo) == _index(jrepo)
