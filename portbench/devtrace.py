"""The traced run's device timeline, from ``torch.profiler``.

``DeviceTrace`` profiles the window (device activity, and the host's
torch calls so that an idle gap can be named by what the host launched
next) and reduces it to plain numbers: every device operation as
``(name, start_ns, end_ns)``, the seconds in which any of them ran (the
union of their intervals), the top operations by summed time, and the
longest idle gaps. Off the card it records nothing, and every reader
that needs it returns nothing.
"""

from __future__ import annotations

import bisect
import contextlib
import time


def busy_union(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def idle_gaps(intervals, start, stop) -> list[tuple]:
    """``(gap start, gap end)`` of ``[start, stop]`` covered by no interval."""
    gaps, cur = [], start
    for a, b in sorted(intervals):
        if a > cur:
            gaps.append((cur, min(a, stop)))
        cur = max(cur, b)
        if cur >= stop:
            break
    if cur < stop:
        gaps.append((cur, stop))
    return [(a, b) for a, b in gaps if b > a]


class DeviceTrace:
    def __init__(self, on: bool):
        self.on = on
        self.ops: list[tuple[str, int, int]] = []
        self.host: list[tuple[str, int, int]] = []
        self.window_s = None

    @contextlib.contextmanager
    def record(self):
        if not self.on:
            t0 = time.perf_counter()
            yield self
            self.window_s = time.perf_counter() - t0
            return
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield self
            self.window_s = time.perf_counter() - t0
        for e in prof.profiler.kineto_results.events():
            row = (e.name(), e.start_ns(), e.end_ns())
            (self.host if e.device_type() == DeviceType.CPU
             else self.ops).append(row)
        self.ops.sort(key=lambda r: r[1])
        self.host.sort(key=lambda r: r[1])

    @property
    def busy_s(self) -> float | None:
        if not self.ops:
            return None
        return busy_union((a, b) for _, a, b in self.ops) / 1e9

    def kernel_seconds(self, patterns) -> float | None:
        """Summed device seconds of the operations whose names hold one of
        ``patterns``; None when none ran."""
        hits = [b - a for name, a, b in self.ops
                if any(p in name for p in patterns)]
        return sum(hits) / 1e9 if hits else None

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, int] = {}
        for name, a, b in self.ops:
            key = name if len(name) <= 80 else name[:77] + "..."
            by[key] = by.get(key, 0) + (b - a)
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> list[list]:
        """The longest idle gaps of the device between its first and last
        operation, each named by the host call that ended it: the last
        ``cuda*`` runtime call to start before the gap closed."""
        if not self.ops:
            return []
        start = self.ops[0][1]
        stop = max(b for _, _, b in self.ops)
        gaps = idle_gaps([(a, b) for _, a, b in self.ops], start, stop)
        gaps.sort(key=lambda g: g[0] - g[1])
        launches = [(a, name) for name, a, _ in self.host
                    if name.startswith("cuda")]
        starts = [a for a, _ in launches]
        op_starts = [a for _, a, _ in self.ops]
        out = []
        for a, b in gaps[:n]:
            i = bisect.bisect_right(starts, b) - 1
            host = launches[i][1] if i >= 0 else "no host call"
            j = bisect.bisect_left(op_starts, b)
            nxt = self.ops[j][0] if j < len(self.ops) else "end"
            out.append([f"{host} -> {nxt[:60]}", (b - a) / 1e9])
        return out
