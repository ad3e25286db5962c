"""What the new per-layer readers share: the program's span seconds per
PVC GiB, and its flight recorder set beside the traced window's device
timeline.

The window runs from the start of the first ``portbench.sync`` mark to
the end of the last one in ``run.trace.host``: ``torch.profiler``'s
clock, nanoseconds since the Unix epoch. The program's flight recorder
(``volsync_tpu_torch.obs``) stamps its events in microseconds on that
clock where it has ``ring_stats``; a program without it records on
another clock, and every reader here then returns None, as it does off
the card and where the ring's oldest event is later than the window's
start (the ring no longer holds all of the window). The program is
loaded when a reader runs, never when this module is imported.
"""

from __future__ import annotations

from portbench.devtrace import idle_gaps

MARK = "portbench.sync"


def on_card(run) -> bool:
    return bool(run.card)


def span_s_per_gib(run, names) -> float | None:
    """Host seconds of the spans ``names`` (exact names, summed over
    threads) per GiB of PVC synced in the window; None off the card or
    where none of them ran."""
    gib = run.inputs.get("pvc_gib")
    seconds = sum(run.spans.get(n, 0.0) for n in names)
    if not on_card(run) or not gib or not seconds:
        return None
    return seconds / gib


def window(run) -> tuple[int, int] | None:
    marks = [(a, b) for name, a, b in run.trace.host if name == MARK]
    if not on_card(run) or not marks:
        return None
    return min(a for a, _ in marks), max(b for _, b in marks)


def ring_spans(run, name: str) -> list | None:
    """``[(start_ns, end_ns, args)]`` of the ring's ``name`` spans, cut
    to the window (spans outside it left out); None where the ring
    cannot say (see the module's note)."""
    win = window(run)
    if win is None:
        return None
    from volsync_tpu_torch import obs

    stats = getattr(obs, "ring_stats", None)
    if stats is None:
        return None
    oldest = stats()["oldest_ts"]
    if oldest is None or oldest * 1e3 > win[0]:
        return None
    out = []
    for e in obs.trace_events():
        if e["ph"] != "X" or e["name"] != name:
            continue
        a = e["ts"] * 1e3
        b = a + e["dur"] * 1e3
        if b > win[0] and a < win[1]:
            out.append((max(a, win[0]), min(b, win[1]), e["args"]))
    return out


def union(intervals) -> list[tuple]:
    """Sorted disjoint ``(start, end)`` covering ``intervals``."""
    out: list[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def overlap(xs, ys) -> float:
    """Length common to two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_in(run, name: str) -> float | None:
    """Share (%) of the window's device-idle time (no kernel, copy or
    memset running) that lies in the union of open ``name`` spans, on
    any thread."""
    spans = ring_spans(run, name)
    if spans is None or not run.trace.ops:
        return None
    gaps = idle_gaps([(a, b) for _, a, b in run.trace.ops], *window(run))
    idle = sum(b - a for a, b in gaps)
    if not idle:
        return None
    return 100.0 * overlap(gaps, union((a, b) for a, b, _ in spans)) / idle
