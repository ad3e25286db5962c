"""The readers of the program's spans and flight recorder, on synthetic
runs: fake device operations, host marks and ring events (the program's
``obs`` replaced by a stand-in that holds them)."""

import types

import pytest

from portbench import ring, run, spec
from portbench.devtrace import DeviceTrace

CARD = {"sms": 132, "max_sm_hz": 1.98e9}
MS = 10 ** 6  # ns
T0 = 1_800_000_000 * 10 ** 9  # the window's start, ns since the epoch

SPAN_READERS = [
    ("seal_compress_s_per_gib.sync", ["repo.seal.compress"]),
    ("seal_cipher_s_per_gib.sync", ["repo.seal.cipher"]),
    ("seal_wait_s_per_gib.sync", ["repo.seal_wait"]),
    ("entry_fixed_s_per_gib.sync",
     ["mover.restic.open", "repo.lock", "repo.list_then_load",
      "repo.index_write", "repo.save_snapshot", "repo.unlock"]),
    ("stage_s_per_gib.sync", ["ops.batch_stage"]),
    ("h2d_s_per_gib.sync", ["device.h2d"]),
]
RING_READERS = ["compress_discarded_s_per_gib.sync",
                "idle_in_seal_wait_pct.sync", "idle_in_read_pct.sync"]


def _metric(name):
    return spec.load_module("metrics", name).read


def _run(spans=None, inputs=None, ops=(), host=(), card=CARD):
    tr = DeviceTrace(on=False)
    tr.ops = list(ops)
    tr.host = list(host)
    return run.Run(spans=spans or {}, inputs=inputs or {"pvc_gib": 2.0},
                   trace=tr, card=card)


def _span(name, a_ms, b_ms, **attrs):
    """A ring span from ``a_ms`` to ``b_ms`` after the window's start,
    in the program's units (realtime microseconds)."""
    return {"name": name, "ph": "X", "ts": (T0 + a_ms * MS) / 1e3,
            "dur": (b_ms - a_ms) * 1e3, "args": attrs}


@pytest.fixture
def fake_obs(monkeypatch):
    """The program's ``obs`` as the readers see it: ``events`` is the
    ring, its oldest event the first one (or ``oldest``, ms)."""
    import volsync_tpu_torch

    state = types.SimpleNamespace(events=[], oldest=None)

    def ring_stats():
        ts = ([e["ts"] for e in state.events] if state.oldest is None
              else [(T0 + state.oldest * MS) / 1e3])
        return {"capacity": 1 << 17, "held": len(state.events),
                "recorded": len(state.events),
                "oldest_ts": min(ts) if ts else None}

    fake = types.SimpleNamespace(ring_stats=ring_stats,
                                 trace_events=lambda: list(state.events))
    monkeypatch.setattr(volsync_tpu_torch, "obs", fake, raising=False)
    return state


def _marks(*pairs_ms):
    return [("portbench.sync", T0 + a * MS, T0 + b * MS) for a, b in pairs_ms]


@pytest.mark.parametrize("name,spans", SPAN_READERS,
                         ids=[n for n, _ in SPAN_READERS])
def test_span_reader_value_absent_and_off_card(name, spans):
    read = _metric(name)
    got = read(_run(spans={**{s: 1.5 for s in spans}, "other": 9.0,
                           "repo.kdf": 4.0, "repo.seal": 8.0}))
    assert got == pytest.approx(1.5 * len(spans) / 2.0)
    assert read(_run(spans={"other": 9.0})) is None  # the parent's program
    assert read(_run(spans={s: 1.5 for s in spans}, card={})) is None


def test_compress_discarded_sums_the_unkept_in_the_window(fake_obs):
    fake_obs.events = [
        _span("repo.seal.compress", -50, -10, kept=False),  # before
        _span("repo.seal.compress", -5, 5, kept=False),     # half in
        _span("repo.seal.compress", 10, 30, kept=False),
        _span("repo.seal.compress", 40, 100, kept=True),
        _span("repo.seal.cipher", 30, 40),
        _span("repo.seal.compress", 990, 1010, kept=False),  # half out
    ]
    r = _run(host=_marks((0, 500), (600, 1000)))
    got = _metric("compress_discarded_s_per_gib.sync")(r)
    # realtime microseconds as floats hold ~0.25 us at this epoch
    assert got == pytest.approx((5 + 20 + 10) / 1e3 / 2.0, rel=1e-5)


def test_idle_shares_in_seal_wait_and_read(fake_obs):
    # device busy 0-100 and 400-500 ms of a 0-1000 ms window: 800 ms idle
    ops = [("Memcpy HtoD (Pageable -> Device)", T0, T0 + 100 * MS),
           ("void merkle_roots_kernel", T0 + 400 * MS, T0 + 500 * MS)]
    fake_obs.events = [
        _span("engine.read", -20, 10),
        _span("repo.seal_wait", 50, 250),     # 150 idle
        _span("repo.seal_wait", 200, 300),    # overlaps: +50 idle
        _span("repo.seal_wait", 450, 700),    # 200 idle
        _span("engine.read", 600, 900),       # 300 idle
        _span("engine.read", 1100, 1200),     # after the window
    ]
    r = _run(ops=ops, host=_marks((0, 400), (450, 1000)))
    assert _metric("idle_in_seal_wait_pct.sync")(r) == \
        pytest.approx(100 * 400 / 800)
    assert _metric("idle_in_read_pct.sync")(r) == \
        pytest.approx(100 * 300 / 800)


@pytest.mark.parametrize("name", RING_READERS)
def test_ring_reader_none_when_the_ring_starts_inside_the_window(
        fake_obs, name):
    ops = [("k", T0 + 100 * MS, T0 + 200 * MS)]
    fake_obs.events = [_span("engine.read", -100, -90),
                       _span("repo.seal_wait", 10, 30),
                       _span("engine.read", 40, 60),
                       _span("repo.seal.compress", 50, 70, kept=False)]
    r = _run(ops=ops, host=_marks((0, 1000)))
    assert _metric(name)(r) is not None
    fake_obs.oldest = 5  # the ring dropped the window's first 5 ms
    assert _metric(name)(r) is None
    fake_obs.oldest = None
    fake_obs.events = []
    assert _metric(name)(r) is None


@pytest.mark.parametrize("name", RING_READERS)
def test_ring_reader_none_off_the_card(fake_obs, name):
    fake_obs.events = [_span("repo.seal_wait", 10, 30),
                       _span("engine.read", 40, 60),
                       _span("repo.seal.compress", 50, 70, kept=False)]
    ops = [("k", T0 + 100 * MS, T0 + 200 * MS)]
    assert _metric(name)(_run(ops=ops, host=_marks((0, 1000)),
                              card={})) is None
    assert _metric(name)(_run(ops=ops)) is None  # no marks: untraced


@pytest.mark.parametrize("name", RING_READERS)
def test_ring_reader_none_on_a_program_without_the_clock(monkeypatch,
                                                          name):
    """The parent's program has no ``ring_stats``: its ring is on
    another clock, and the reader says nothing rather than raise."""
    import volsync_tpu_torch

    monkeypatch.setattr(volsync_tpu_torch, "obs", types.SimpleNamespace(
        trace_events=lambda: [_span("repo.seal_wait", 10, 30)]),
        raising=False)
    r = _run(ops=[("k", T0, T0 + MS)], host=_marks((0, 1000)))
    assert _metric(name)(r) is None


def test_union_and_overlap():
    assert ring.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert ring.overlap([(0, 3), (5, 8)], [(2, 6), (7, 9)]) == 3
