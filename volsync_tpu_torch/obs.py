"""Minimal observability for the port: a stage timer and a copy counter.

Ports the two calls the stream engine makes into ``volsync_tpu/obs``
(``span`` from ``obs/tracing.py``, ``record_copy`` from
``obs/copyledger.py``) so call sites read as in the reference. There is
no flight recorder and no Prometheus export: ``span`` sums host wall
time per name and ``record_copy`` sums bytes per site, both readable
with ``span_totals()`` / ``copy_totals()``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

_lock = threading.Lock()
_spans: dict = defaultdict(lambda: [0, 0.0])  # name -> [count, seconds]
_copies: dict = defaultdict(int)  # site -> bytes


@contextlib.contextmanager
def span(name: str):
    """Time a named host stage (wall clock, summed per name)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            entry = _spans[name]
            entry[0] += 1
            entry[1] += dt


def record_copy(site: str, nbytes: int) -> None:
    """Account ``nbytes`` host bytes copied at ``site``."""
    if nbytes <= 0:
        return
    with _lock:
        _copies[site] += nbytes


def span_totals() -> dict:
    """``{name: (count, total seconds)}``."""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _spans.items()}


def copy_totals() -> dict:
    """``{site: bytes}``."""
    with _lock:
        return dict(_copies)
