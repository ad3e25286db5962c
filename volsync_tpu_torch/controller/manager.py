"""Controller manager: the controller-runtime analogue.

Runs both reconcilers over the in-process cluster (main.go:140-183 builds
the same wiring around controller-runtime). Work distribution follows the
reference's model: every CR reconciles independently (the reference allows
100 concurrent reconciles — replicationsource_controller.go:145); here a
small thread pool drains a due-queue that wakes on every cluster mutation
(the watch analogue) and on requeue_after deadlines.

Ports ``volsync_tpu/controller/manager.py`` whole.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from datetime import datetime, timezone
from typing import Optional

from volsync_tpu_torch.cluster.cluster import Cluster
from volsync_tpu_torch.controller.reconcilers import (
    ReplicationDestinationReconciler,
    ReplicationSourceReconciler,
)
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS

log = logging.getLogger("volsync_tpu_torch.manager")


class Manager:
    def __init__(self, cluster: Cluster, catalog=None, metrics=None,
                 workers: int = 4):
        from volsync_tpu_torch.movers.base import CATALOG

        catalog = catalog or CATALOG
        metrics = metrics or GLOBAL_METRICS
        self.cluster = cluster
        self.reconcilers = {
            "ReplicationSource": ReplicationSourceReconciler(
                cluster, catalog, metrics),
            "ReplicationDestination": ReplicationDestinationReconciler(
                cluster, catalog, metrics),
        }
        self.workers = workers
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._lock = threading.Lock()
        self._due: list[tuple[float, tuple]] = []  # heap of (when, key)
        self._seen_gen: dict[tuple, int] = {}
        self._inflight: set[tuple] = set()
        self._cond = threading.Condition(self._lock)

    # lifecycle -------------------------------------------------------------

    def start(self) -> "Manager":
        self._threads = [
            threading.Thread(target=self._watch_loop, daemon=True,
                             name="mgr-watch")
        ] + [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"mgr-worker-{i}")
            for i in range(self.workers)
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self):
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # watch: enqueue CRs whose spec generation moved ------------------------

    def _watch_loop(self):
        last_gen = -1
        while not self._stop.is_set():
            self.cluster.wait_for(lambda: self._stop.is_set()
                                  or self.cluster.generation != last_gen,
                                  timeout=0.5)
            if self._stop.is_set():
                return
            last_gen = self.cluster.generation
            now = time.monotonic()
            with self._cond:
                live: set[tuple] = set()
                for kind in self.reconcilers:
                    for cr in self.cluster.list(kind):
                        key = (kind,) + cr.metadata.key
                        live.add(key)
                        # Track the CR's spec *generation*, not its
                        # resourceVersion: reconciles bump rv via status
                        # writes (which must not re-trigger, or the loop
                        # runs hot), and recording a post-reconcile rv
                        # would race a concurrent user update and swallow
                        # it. Generation only moves on spec writes.
                        gen = cr.metadata.generation
                        if self._seen_gen.get(key) != gen:
                            self._seen_gen[key] = gen
                            heapq.heappush(self._due, (now, key))
                # Forget deleted CRs so a same-name recreation (which
                # restarts at generation 1) is seen as new, not stale.
                for key in list(self._seen_gen):
                    if key not in live:
                        del self._seen_gen[key]
                self._cond.notify_all()

    def enqueue(self, kind: str, namespace: str, name: str, delay: float = 0.0):
        with self._cond:
            heapq.heappush(self._due, (time.monotonic() + delay,
                                       (kind, namespace, name)))
            self._cond.notify_all()

    # workers ---------------------------------------------------------------

    def _worker_loop(self):
        while not self._stop.is_set():
            item = self._pop_due()
            if item is None:
                continue
            kind, namespace, name = item
            key = (kind, namespace, name)
            try:
                result = self.reconcilers[kind].reconcile(namespace, name)
                if result.requeue_after is not None and (
                        self.cluster.try_get(kind, namespace, name) is not None):
                    self.enqueue(kind, namespace, name,
                                 result.requeue_after.total_seconds())
            except Exception:
                log.exception("reconcile %s/%s/%s failed; backing off",
                              kind, namespace, name)
                if self.cluster.try_get(kind, namespace, name) is not None:
                    self.enqueue(kind, namespace, name, 1.0)
            finally:
                with self._cond:
                    self._inflight.discard(key)
                    self._cond.notify_all()

    def _pop_due(self) -> Optional[tuple]:
        with self._cond:
            while not self._stop.is_set():
                now = time.monotonic()
                while self._due and self._due[0][1] in self._inflight:
                    # A reconcile for this CR is running; retry shortly.
                    when, key = heapq.heappop(self._due)
                    heapq.heappush(self._due, (max(when, now) + 0.05, key))
                    break
                if self._due and self._due[0][0] <= now:
                    _, key = heapq.heappop(self._due)
                    if key in self._inflight:
                        heapq.heappush(self._due, (now + 0.05, key))
                        continue
                    if self.cluster.try_get(*key) is None:
                        self._seen_gen.pop(key, None)
                        continue
                    self._inflight.add(key)
                    return key
                wait = 0.25
                if self._due:
                    wait = min(wait, max(self._due[0][0] - now, 0.01))
                self._cond.wait(wait)
            return None

    # convenience -----------------------------------------------------------

    def reconcile_until(self, predicate, timeout: float = 30.0,
                        poll: float = 0.02) -> bool:
        """Test/CLI helper: wait until ``predicate()`` holds."""
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            if predicate():
                return True
            time.sleep(poll)
        return predicate()
