"""One traced benchmark run of a cell, with the program's flight recorder
set beside the device timeline (run on a machine with the CUDA card):

    python3 scripts/trace_window.py --workload restic-initial-1g \
        --seed 7000000001 --seconds 50 --out chiprun_out/trace_window.json

Runs ``portbench.run.run_cell`` with ``--trace 1`` in this process, then
reads the program's ring (``volsync_tpu_torch.obs``) over the window
(first to last ``portbench.sync`` mark) and writes, beside the run's
result line:

- ``idle_by_span``: the window's device-idle seconds split by the
  innermost program span open at each instant on any thread (the
  latest-opened span still open), plus ``no span``; with the idle
  seconds ``device_idle_pct`` counts (its window less the busy union);
- ``ring``: events the ring recorded in the window and in each sync,
  and its ``ring_stats()``;
- ``h2d``: how many ``Memcpy HtoD`` device operations lie within a
  ``device.h2d`` span (1 ms either side), and the ones that do not, with
  the host's torch calls open when they started.
"""

from __future__ import annotations

import argparse
import heapq
import json
import sys
from collections import Counter, defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import ring, run, spec  # noqa: E402
from portbench.devtrace import busy_union, idle_gaps  # noqa: E402

MS = 10 ** 6


def idle_by_span(gaps, spans) -> dict:
    """Seconds of ``gaps`` under each label: the name of the latest-opened
    span still open, or ``no span``. ``gaps``: sorted disjoint (start,
    end); ``spans``: [(start, end, name)]."""
    bounds = sorted({t for a, b, _ in spans for t in (a, b)}
                    | {t for g in gaps for t in g})
    starts = sorted(spans)
    out: dict = defaultdict(float)
    heap: list = []  # (-start, end, name): the latest-opened on top
    k = gi = 0
    for t0, t1 in zip(bounds, bounds[1:]):
        while gi < len(gaps) and gaps[gi][1] <= t0:
            gi += 1
        if gi == len(gaps):
            break
        while k < len(starts) and starts[k][0] <= t0:
            a, b, name = starts[k]
            heapq.heappush(heap, (-a, b, name))
            k += 1
        if not (gaps[gi][0] <= t0 and t1 <= gaps[gi][1]):
            continue
        while heap and heap[0][1] <= t0:
            heapq.heappop(heap)
        out[heap[0][2] if heap else "no span"] += (t1 - t0) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _nearest(spans, a, b) -> list:
    """ms from the copy ``(a, b)`` to the span whose start is nearest
    its start: [span start - a, b - span end]."""
    if not spans:
        return []
    s, t = min(spans, key=lambda st: abs(st[0] - a))
    return [(s - a) / MS, (b - t) / MS]


def _launches(prof, win, h2d) -> dict:
    """Each ``Memcpy HtoD`` beside the ``cudaMemcpyAsync`` call that
    launched it (the profiler's correlation id), in 5 s bins of the
    window: the copy's start less its call's start (ms: the profiler's
    device clock against its host clock), and the shares of calls and of
    copies inside a ``device.h2d`` span (1 ms either side)."""
    calls, copies = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.name() == "cudaMemcpyAsync":
            calls[e.correlation_id()] = (e.start_ns(), e.end_ns())
        elif "HtoD" in e.name():
            copies.append((e.correlation_id(), e.start_ns(), e.end_ns()))

    def within(a, b):
        return any(s - MS <= a and b <= t + MS for s, t in h2d)

    bins: dict = defaultdict(list)
    for cid, a, b in copies:
        call = calls.get(cid)
        if call is None:
            continue
        bins[int((a - win[0]) / 5e9) * 5].append(
            ((a - call[0]) / MS, within(*call), within(a, b)))
    return {"copies": len(copies), "matched": sum(map(len, bins.values())),
            "by_5s": {k: {"n": len(v),
                          "lag_ms_min": min(x[0] for x in v),
                          "lag_ms_max": max(x[0] for x in v),
                          "call_in_span": sum(x[1] for x in v) / len(v),
                          "copy_in_span": sum(x[2] for x in v) / len(v)}
                      for k, v in sorted(bins.items())}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    seen = []

    class _Run(run.Run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self)

    import torch.profiler

    profs = []

    class _Profile(torch.profiler.profile):
        def __enter__(self):
            profs.append(self)
            return super().__enter__()

    import threading
    import time

    clocks, done = [], threading.Event()

    def sample():  # realtime against the raw monotonic clock
        while not done.wait(0.5):
            clocks.append((time.time_ns(), time.clock_gettime_ns(
                time.CLOCK_MONOTONIC_RAW)))

    sampler = threading.Thread(target=sample, daemon=True,
                               name="clock-sampler")
    sampler.start()
    run.Run = _Run
    torch.profiler.profile = _Profile
    result = run.run_cell(spec.load_cell(args.workload), args.seed,
                          args.seconds, True)
    (r,) = seen
    from volsync_tpu_torch import obs
    from volsync_tpu_torch.obs import tracing

    win = ring.window(r)
    events = obs.trace_events()
    stats = obs.ring_stats()
    out = {"result": result, "ring_stats": stats}
    if win is None:
        out["error"] = "no window"
    else:
        def inside(e):
            return win[0] <= e["ts"] * 1e3 <= win[1]

        marks = [(a, b) for n, a, b in r.trace.host if n == ring.MARK]
        out["ring"] = {
            "window_events": sum(1 for e in events if inside(e)),
            "per_sync": [sum(1 for e in events
                             if a <= e["ts"] * 1e3 <= b) for a, b in marks],
            "window_names": Counter(e["name"] for e in events
                                    if inside(e)).most_common(),
            "covers_window": (stats["oldest_ts"] is not None
                              and stats["oldest_ts"] * 1e3 <= win[0])}
        spans = [(max(e["ts"] * 1e3, win[0]),
                  min((e["ts"] + e["dur"]) * 1e3, win[1]), e["name"])
                 for e in events if e["ph"] == "X"
                 and (e["ts"] + e["dur"]) * 1e3 > win[0]
                 and e["ts"] * 1e3 < win[1]]
        gaps = idle_gaps([(a, b) for _, a, b in r.trace.ops], *win)
        table = idle_by_span(gaps, spans)
        busy = r.trace.busy_s
        out["idle_by_span"] = {
            "seconds": table, "sum_s": sum(table.values()),
            "marks_window_s": (win[1] - win[0]) / 1e9,
            "device_idle_pct_idle_s": r.trace.window_s - busy,
            "device_idle_pct_window_s": r.trace.window_s,
            "busy_s": busy,
            "busy_in_marks_s": busy_union(
                (max(a, win[0]), min(b, win[1])) for _, a, b in r.trace.ops
                if b > win[0] and a < win[1]) / 1e9}
        h2d = sorted((e["ts"] * 1e3, (e["ts"] + e["dur"]) * 1e3)
                     for e in events
                     if e["ph"] == "X" and e["name"] == "device.h2d")
        copies = [(n, a, b) for n, a, b in r.trace.ops if "HtoD" in n]
        misses = [(n, a, b) for n, a, b in copies
                  if not any(s - MS <= a and b <= t + MS for s, t in h2d)]
        out["h2d"] = {"copies": len(copies),
                      "within": len(copies) - len(misses),
                      "share": (1 - len(misses) / len(copies))
                      if copies else None,
                      "h2d_spans": len(h2d),
                      "misses": [[n, (a - win[0]) / 1e9, (b - a) / 1e9,
                                  _nearest(h2d, a, b)]
                                 for n, a, b in misses[:40]]}
        out["launches"] = _launches(profs[-1], win, h2d)
    done.set()
    sampler.join(timeout=5.0)
    if win is not None and clocks:
        real0, raw0 = clocks[0]
        out["realtime_less_raw_ms"] = {
            int((r - win[0]) / 5e9) * 5: ((r - real0) - (w - raw0)) / MS
            for r, w in clocks if win[0] <= r <= win[1]}
    pairs = list(tracing._pairs)
    if len(pairs) > 1:
        (p0, r0), (p1, r1) = pairs[0], pairs[-1]
        out["clock_drift_ppm"] = ((r1 - r0) / ((p1 - p0) * 1e6) - 1) * 1e6
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    brief = {k: v for k, v in out.items() if k != "result"}
    if "ring" in brief:
        brief["ring"] = {k: v for k, v in brief["ring"].items()
                         if k != "window_names"}
    if "h2d" in brief:
        brief["h2d"] = {k: v for k, v in brief["h2d"].items()
                        if k != "misses"} | {"misses": out["h2d"]["misses"][:5]}
    print(json.dumps(result["metrics"]))
    print(json.dumps(brief, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
