"""Live statistics feeding the sync-protocol planner (engine/protoplan.py).

Ports ``volsync_tpu/engine/syncstats.py``. The dedup feed reads the
port's in-memory metrics (``metrics.GLOBAL``: a series' ``.value``,
where the reference reads prometheus_client's ``_value.get()``), the
link feed the port's ``resilience.link_totals()``.

The planner's cost model is only as honest as its inputs, and all three
of them drift at run time:

- **change rate** — what fraction of a file's bytes the delta engine
  actually shipped as literals last time (engine/deltasync.delta_stats);
- **dedup hit ratio** — how often the CDC path's batched index queries
  hit (``volsync_index_queries_total{result}``, repo/shardedindex.py);
- **link bandwidth / latency** — wall time of successful byte-moving
  ``ResilientStore`` attempts (resilience.link_totals()).

``SyncStatsBook`` folds each signal into an exponentially weighted
moving average so one anomalous sync can't whipsaw protocol choice,
with every update guarded against hostile inputs (NaN, zero totals,
zero-duration timings) — a poisoned sample is dropped, never divided
by. Books are per-consumer (``book_for("rsync")``): the rsync mover's
observed churn must not contaminate the restic mover's dedup pricing.

Cold books are deliberately pessimistic: no delta history reads as
change rate 1.0 (every byte would ship as literal) and no dedup history
as hit ratio 0.0, which prices both fancy protocols above FULL_COPY
until a probe run seeds real observations (protoplan's ``probe``
reason).
"""

from __future__ import annotations

import dataclasses
import math

from volsync_tpu_torch import envflags, resilience
from volsync_tpu_torch.analysis import lockcheck

#: Cold-book priors: pessimistic on purpose (see module docstring).
COLD_CHANGE_RATE = 1.0
COLD_DEDUP_RATIO = 0.0
#: Cold link assumptions: a mid-range 100 MiB/s pipe with a 1 ms round
#: trip — only used to break ties before any transfer has been timed.
COLD_BANDWIDTH = 100.0 * (1 << 20)
COLD_LATENCY_S = 1e-3


def _finite_fraction(num: float, den: float):
    """num/den clamped to [0, 1], or None when the inputs can't yield a
    meaningful fraction (zero/negative/NaN/inf denominators included)."""
    if not (math.isfinite(num) and math.isfinite(den)) or den <= 0 or num < 0:
        return None
    return min(num / den, 1.0)


def _finite_rate(amount: float, seconds: float):
    """amount/seconds, or None when undefined — the divide-by-zero guard
    for bandwidth math (a zero-duration timing is clock granularity, not
    an infinitely fast link)."""
    if not (math.isfinite(amount) and math.isfinite(seconds)):
        return None
    if amount <= 0 or seconds <= 0:
        return None
    return amount / seconds


@dataclasses.dataclass(frozen=True)
class SyncStats:
    """Immutable snapshot the planner prices against."""

    change_rate: float        # fraction of bytes expected literal (0..1)
    dedup_hit_ratio: float    # fraction of chunks expected deduped (0..1)
    bandwidth_bps: float      # sustained link bytes/second
    latency_s: float          # per-round-trip link latency, seconds
    delta_samples: int        # how many delta runs informed change_rate
    dedup_samples: int        # how many dedup batches informed hit ratio
    link_samples: int         # how many timed transfers informed the link


class SyncStatsBook:
    """EWMA ledger of sync observations; thread-safe, one per consumer."""

    def __init__(self, *, alpha: float = None):
        self._alpha = alpha if alpha is not None else envflags.plan_ewma_alpha()
        self._lock = lockcheck.make_lock("engine.syncstats")
        self._change_rate = None
        self._dedup_ratio = None
        self._bandwidth = None
        self._latency = None
        self._delta_samples = 0
        self._dedup_samples = 0
        self._link_samples = 0
        # cursors for the cumulative external feeds (diffed per pull)
        self._link_cursor: dict = {}
        self._index_cursor = (0.0, 0.0)

    def _ewma(self, cur, x: float) -> float:
        return x if cur is None else self._alpha * x + (1 - self._alpha) * cur

    # -- observations -------------------------------------------------------

    def observe_delta(self, literal_bytes: float, total_bytes: float) -> None:
        """One completed delta run: ``literal_bytes`` shipped out of
        ``total_bytes`` of source. Unusable inputs are dropped."""
        ratio = _finite_fraction(literal_bytes, total_bytes)
        if ratio is None:
            return
        with self._lock:
            self._change_rate = self._ewma(self._change_rate, ratio)
            self._delta_samples += 1

    def observe_dedup(self, hits: float, total: float) -> None:
        """One batch of dedup-index queries: ``hits`` of ``total`` keys
        already present in the repository."""
        ratio = _finite_fraction(hits, total)
        if ratio is None:
            return
        with self._lock:
            self._dedup_ratio = self._ewma(self._dedup_ratio, ratio)
            self._dedup_samples += 1

    def observe_link(self, nbytes: float, seconds: float) -> None:
        """One timed bulk transfer -> bandwidth sample. Zero-duration or
        non-finite timings never reach the division."""
        rate = _finite_rate(nbytes, seconds)
        if rate is None:
            return
        with self._lock:
            self._bandwidth = self._ewma(self._bandwidth, rate)
            self._link_samples += 1

    def observe_rtt(self, seconds: float) -> None:
        """One timed small round trip -> latency sample."""
        if not math.isfinite(seconds) or seconds <= 0:
            return
        with self._lock:
            self._latency = self._ewma(self._latency, seconds)
            self._link_samples += 1

    # -- external feeds -----------------------------------------------------

    def pull_link_timings(self) -> None:
        """Fold new ResilientStore timings (resilience.link_totals())
        into the link EWMAs. Totals are cumulative, so each book diffs
        against its own cursor — pulling twice observes nothing twice."""
        now = resilience.link_totals()
        with self._lock:
            prev = self._link_cursor
            self._link_cursor = now
        d_bytes = now["large_bytes"] - prev.get("large_bytes", 0)
        d_secs = now["large_seconds"] - prev.get("large_seconds", 0.0)
        self.observe_link(d_bytes, d_secs)
        d_ops = now["small_ops"] - prev.get("small_ops", 0)
        d_small = now["small_seconds"] - prev.get("small_seconds", 0.0)
        if d_ops > 0:
            self.observe_rtt(d_small / d_ops)

    def pull_index_metrics(self, metrics=None) -> None:
        """Fold the global dedup-query counters
        (``volsync_index_queries_total{result}``) into the dedup EWMA,
        diffing against this book's cursor."""
        if metrics is None:
            from volsync_tpu_torch.metrics import GLOBAL as metrics
        hit = metrics.index_queries.labels(result="hit").value
        miss = metrics.index_queries.labels(result="miss").value
        with self._lock:
            prev_hit, prev_miss = self._index_cursor
            self._index_cursor = (hit, miss)
        self.observe_dedup(hit - prev_hit, (hit - prev_hit) + (miss - prev_miss))

    # -- readout ------------------------------------------------------------

    def decay(self, factor: float = 0.5) -> None:
        """Age the book toward its cold priors: each average moves
        ``factor`` of the way back and the sample counts shrink, so a
        long-idle book re-probes instead of trusting stale confidence."""
        if not math.isfinite(factor):
            return
        factor = min(max(factor, 0.0), 1.0)
        with self._lock:
            if self._change_rate is not None:
                self._change_rate += factor * (COLD_CHANGE_RATE
                                               - self._change_rate)
            if self._dedup_ratio is not None:
                self._dedup_ratio += factor * (COLD_DEDUP_RATIO
                                               - self._dedup_ratio)
            self._delta_samples = int(self._delta_samples * (1 - factor))
            self._dedup_samples = int(self._dedup_samples * (1 - factor))

    def snapshot(self) -> SyncStats:
        with self._lock:
            return SyncStats(
                change_rate=(COLD_CHANGE_RATE if self._change_rate is None
                             else self._change_rate),
                dedup_hit_ratio=(COLD_DEDUP_RATIO if self._dedup_ratio is None
                                 else self._dedup_ratio),
                bandwidth_bps=(COLD_BANDWIDTH if self._bandwidth is None
                               else self._bandwidth),
                latency_s=(COLD_LATENCY_S if self._latency is None
                           else self._latency),
                delta_samples=self._delta_samples,
                dedup_samples=self._dedup_samples,
                link_samples=self._link_samples,
            )


# -- per-consumer registry ---------------------------------------------------

_books_lock = lockcheck.make_lock("engine.syncstats.books")
_books: dict = {}


def book_for(name: str) -> SyncStatsBook:
    """Process-wide book per consumer name ("rsync", "restic", ...)."""
    with _books_lock:
        book = _books.get(name)
        if book is None:
            book = _books[name] = SyncStatsBook()
        return book


def reset_books() -> None:
    """Drop all shared books (tests)."""
    with _books_lock:
        _books.clear()
