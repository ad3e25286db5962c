"""Continuous GC: a long-running pruner replica for the fleet.

Ports ``volsync_tpu/service/gc.py`` whole, with one addition:
``ContinuousGC`` takes ``device=`` (CUDA by default, raising where CUDA
is absent, before any store is touched) and opens its repository
there.

"Optimized Disaster Recovery for Distributed Storage Systems"
(PAPERS.md) motivates always-on cluster GC: at fleet scale there is no
quiet window to park a stop-the-world prune in, so garbage collection
must be a SERVICE — a dedicated replica driving the two-phase
mark-then-sweep protocol (repo/repository.py prune) in a loop,
concurrently with live backup traffic from the other fenced writers.

Every cycle is one ordinary two-phase prune: mark victims under a
prune-mode lock that coexists with the writers' shared locks, park
them in a pending-delete manifest with a grace deadline, and sweep
only what expired AND no live foreign lock could still reference.
The service adds the fleet-grade loop around it:

- **contention is normal**: another pruner (or an exclusive
  maintenance pass) holding the lock is outcome ``contended`` — the
  cycle is skipped, not failed, and the next interval retries.
- **fencing is survivable**: this GC writer can lose a stale-lock
  takeover like any other writer (e.g. it stalled past the horizon
  mid-cycle). A ``StaleWriterError`` is outcome ``fenced``: the dead
  repository handle is dropped and the next cycle REOPENS — minting a
  fresh writer generation — instead of wedging the service on a
  permanently fenced handle.
- **weather is survivable**: any other error is outcome ``error``;
  the loop logs, counts, and keeps its cadence.

Cycle outcomes count in the port's in-memory
``volsync_gc_cycles_total{outcome}``; the fleet drill
(tests/test_torch_fleet.py) runs this service against live fenced
writers under seeded fault schedules and asserts no dangling index
entries and no live pack swept.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from volsync_tpu_torch import envflags, resolve_device
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS
from volsync_tpu_torch.obs import span

log = logging.getLogger("volsync_tpu_torch.fleet.gc")


class ContinuousGC:
    """Drives ``repo.prune`` every ``interval_seconds`` against
    ``store`` (this GC replica's own — possibly faulted — view of the
    shared backing store), with the repository opened on ``device``
    (None: CUDA).

    ``grace_seconds`` follows prune's resolution rules (None = the
    lock-staleness horizon; must stay > 0 — a continuous pruner taking
    exclusive stop-the-world locks would defeat its purpose, so 0 is
    rejected). ``run_once()`` is the deterministic-test entry point;
    ``start()``/``stop()`` wrap it in the background loop."""

    def __init__(self, store, *, password: Optional[str] = None,
                 interval_seconds: Optional[float] = None,
                 grace_seconds: Optional[float] = None,
                 lock_wait: float = 0.0, device=None):
        if grace_seconds is not None and grace_seconds <= 0:
            raise ValueError(
                "continuous GC requires grace_seconds > 0 (grace 0 is "
                "the stop-the-world prune; run that by hand)")
        self.device = resolve_device(device)
        self.store = store
        self.password = password
        self.interval = (envflags.gc_interval_seconds()
                         if interval_seconds is None else interval_seconds)
        self.grace = grace_seconds
        self.lock_wait = lock_wait
        self._repo = None
        self.cycles = 0
        # single-writer: only the cycle thread (or a test calling
        # run_once synchronously) mutates; readers join() via stop()
        self.outcomes: dict[str, int] = {}  # lint: ignore[VL404] single writer: the cycle thread; readers join() via stop()
        self.last_report: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _open(self):
        from volsync_tpu_torch.repo.repository import Repository

        if self._repo is None:
            repo = Repository.open(self.store, self.password,
                                   device=self.device)
            repo.default_lock_wait = self.lock_wait
            self._repo = repo
        return self._repo

    def run_once(self) -> str:
        """One GC cycle; returns the outcome ("ok", "contended",
        "fenced", "error") and never raises — the loop's cadence must
        survive anything a cycle hits."""
        from volsync_tpu_torch.repo.repository import (
            RepoLockedError,
            StaleWriterError,
        )

        self.cycles += 1
        try:
            with span("fleet.gc"):
                repo = self._open()
                self.last_report = repo.prune(grace_seconds=self.grace)
            outcome = "ok"
        except RepoLockedError as exc:
            # a peer pruner / maintenance pass holds the lock: skip
            # this cycle, the garbage keeps until the next one
            log.info("gc cycle skipped (contended): %s", exc)
            outcome = "contended"
        except StaleWriterError as exc:
            # we were fenced (stalled past the horizon, lost a
            # takeover): this handle is dead forever — reopen fresh
            # next cycle under a new writer generation
            log.warning("gc writer fenced, reopening: %s", exc)
            self._repo = None
            outcome = "fenced"
        except Exception as exc:  # noqa: BLE001 — store weather or a
            # torn read mid-cycle; the service must keep its cadence
            log.warning("gc cycle failed: %s", exc)
            # a failed cycle may have left the handle mid-state; a
            # fresh open next cycle is always safe (prune is two-phase
            # crash-safe, so a retried cycle completes the protocol)
            self._repo = None
            outcome = "error"
        self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
        GLOBAL_METRICS.gc_cycles.labels(outcome=outcome).inc()
        return outcome

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.run_once()

    def start(self) -> "ContinuousGC":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-gc")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
