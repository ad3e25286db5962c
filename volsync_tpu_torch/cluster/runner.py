"""Job/Deployment runner: the kubelet analogue.

Resolves ``spec.entrypoint`` from a registered catalog (the
container-image analogue: the reference wires mover images via
``--<mover>-container-image`` flags — SURVEY.md §5 config) and executes
payloads in worker threads. Jobs retry up to ``backoff_limit`` (the
reference's Jobs use backoffLimit 2 or 8 — rsync/mover.go:363,
restic/mover.go:286); Deployments run until stopped.

Tests that want envtest semantics simply don't start a runner and flip
``job.status.succeeded`` themselves (SURVEY.md §4 tier 2).

Ports ``volsync_tpu/cluster/runner.py`` whole: ``JobContext``,
``EntrypointCatalog``, ``CATALOG`` and ``JobRunner``. The port's
context carries one more field than the reference's: ``device``, the
device the entry point's engines run on. ``None`` means CUDA through
``resolve_device``, which raises where CUDA is absent; it never falls
back to the CPU. ``JobRunner(device=...)`` resolves its device once, at
construction, so a runner without a card raises before it takes a Job
(an entry point raising in every Job would only be retried up to
``backoff_limit``), and it hands the resolved device to every Job and
Deployment it starts. The reference's entry points run on JAX's default
device instead.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import traceback
from datetime import datetime, timezone
from pathlib import Path
from typing import Callable, Optional

from volsync_tpu_torch.cluster.objects import HOSTNAME_LABEL

log = logging.getLogger("volsync_tpu_torch.runner")


@dataclasses.dataclass
class JobContext:
    """What a data-plane entrypoint sees: its config and its mounts.

    ``cluster`` is provided for substrate interactions that a pod would do
    through its environment (e.g. a daemon publishing its bound port on its
    Service); data-plane logic must otherwise stick to env/mounts/secrets —
    that discipline preserves the reference's process boundary. Here it
    is duck-typed: anything with ``Cluster``'s ``try_get`` and
    ``update_status``.
    """

    name: str
    namespace: str
    env: dict
    mounts: dict            # mount name -> Path
    secrets: dict           # mount name -> {key: bytes}
    stop_event: threading.Event
    cluster: object = None
    attempt: int = 0
    kind: str = "Job"       # Job | Deployment — which object hosts us
    device: object = None   # None: CUDA (raises without it)

    def report_transfer(self, nbytes: int, seconds: float):
        """Data-plane self-report (the termination-message analogue): the
        entrypoint records how many bytes its transfer moved and how long
        the data path took; the control plane reads this off the completed
        Job and drives the throughput gauge + TransferCompleted event."""
        if self.cluster is None:
            return
        obj = self.cluster.try_get(self.kind, self.namespace, self.name)
        if obj is None:
            return
        obj.status.transfer_bytes = int(nbytes)
        obj.status.transfer_seconds = float(seconds)
        self.cluster.update_status(obj)


class EntrypointCatalog:
    """Global registry of data-plane entrypoints, name -> callable(ctx)->int."""

    def __init__(self):
        # entrypoints register at import/setup time, before any
        # JobRunner worker thread starts; threads only read
        self._entries: dict[str, Callable] = {}  # lint: ignore[VL404]

    def register(self, name: str, fn: Optional[Callable] = None):
        if fn is None:
            def deco(f):
                self._entries[name] = f
                return f
            return deco
        self._entries[name] = fn
        return fn

    def get(self, name: str) -> Callable:
        if name not in self._entries:
            raise KeyError(f"no entrypoint registered for {name!r}")
        return self._entries[name]

    def __contains__(self, name):
        return name in self._entries


CATALOG = EntrypointCatalog()


class JobRunner:
    """Watches the cluster and executes runnable Jobs and Deployments."""

    def __init__(self, cluster, catalog: EntrypointCatalog = CATALOG,
                 max_workers: int = 8, node_name: str = "node-0",
                 node_labels: Optional[dict] = None, device=None):
        from volsync_tpu_torch import resolve_device

        # Resolved once, here: without a card the runner raises before it
        # takes a Job, instead of each Job failing into its retries.
        self.device = resolve_device(device)
        self.cluster = cluster
        self.catalog = catalog
        self.max_workers = max_workers
        # The runner is the kubelet analogue: one runner = one node. A
        # payload with a node_selector only runs on a runner whose labels
        # satisfy it (the affinity pinning of utils/affinity.go:35-83 —
        # two runners with different hostnames model a two-node cluster).
        self.node_name = node_name
        self.node_labels = dict(node_labels or {})
        self.node_labels.setdefault(HOSTNAME_LABEL, node_name)
        self._stop = threading.Event()
        self._running: dict[tuple, threading.Thread] = {}
        self._daemon_stops: dict[tuple, threading.Event] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # Lifecycle -------------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="job-runner")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        with self._lock:
            for ev in self._daemon_stops.values():
                ev.set()
            threads = list(self._running.values())
        for t in threads:
            t.join(timeout=10)
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # Main loop -------------------------------------------------------------

    def _loop(self):
        while not self._stop.is_set():
            try:
                self._schedule_once()
            except Exception:
                log.exception("runner scheduling error")
            self.cluster.wait_for(lambda: self._stop.is_set(), timeout=0.2)

    def _schedule_once(self):
        with self._lock:
            for job in self.cluster.list("Job"):
                if len(self._running) >= self.max_workers:
                    return
                key = ("Job",) + job.metadata.key
                if key in self._running:
                    continue
                if self._job_runnable(job):
                    t = threading.Thread(
                        target=self._run_job, args=(job,), daemon=True,
                        name=f"job-{job.metadata.name}",
                    )
                    self._running[key] = t
                    t.start()
            for dep in self.cluster.list("Deployment"):
                if len(self._running) >= self.max_workers:
                    return
                key = ("Deployment",) + dep.metadata.key
                alive = key in self._running and self._running[key].is_alive()
                if alive and not self._selector_matches(dep.spec):
                    # Selector moved away from this node mid-flight: stop
                    # our instance so the right node can take over (the
                    # selector only *gates* starts; stop/pause handling
                    # below must still run for daemons we already host).
                    self._daemon_stops[key].set()
                elif (dep.spec.replicas >= 1 and not alive
                        and self._selector_matches(dep.spec)
                        and not (dep.status.ready_replicas > 0
                                 and dep.status.node not in (None, self.node_name))):
                    stop = threading.Event()
                    self._daemon_stops[key] = stop
                    t = threading.Thread(
                        target=self._run_deployment, args=(dep, stop),
                        daemon=True, name=f"dep-{dep.metadata.name}",
                    )
                    self._running[key] = t
                    t.start()
                elif dep.spec.replicas == 0 and key in self._daemon_stops:
                    self._daemon_stops[key].set()
            # Reap daemons whose object is gone
            for key, stop in list(self._daemon_stops.items()):
                kind, ns, name = key
                if self.cluster.try_get(kind, ns, name) is None:
                    stop.set()

    def _selector_matches(self, spec) -> bool:
        sel = getattr(spec, "node_selector", None) or {}
        return all(self.node_labels.get(k) == v for k, v in sel.items())

    def _job_runnable(self, job) -> bool:
        s = job.status
        if job.spec.parallelism == 0:   # paused (rsync/mover.go:366-370)
            return False
        if s.succeeded > 0 or s.active > 0:
            return False
        if s.failed > job.spec.backoff_limit:
            return False
        if job.spec.entrypoint not in self.catalog:
            return False
        if not self._selector_matches(job.spec):
            return False
        return self._mounts_ready(job.spec, job.metadata.namespace)

    def _mounts_ready(self, spec, namespace: str) -> bool:
        for volname in spec.volumes.values():
            vol = self.cluster.try_get("Volume", namespace, volname)
            if vol is None or vol.status.phase != "Bound":
                return False
        for secname in spec.secrets.values():
            if self.cluster.try_get("Secret", namespace, secname) is None:
                return False
        return True

    def _resolve(self, meta, spec):
        mounts = {}
        for mount, volname in spec.volumes.items():
            vol = self.cluster.get("Volume", meta.namespace, volname)
            mounts[mount] = Path(vol.status.path)
        secrets = {}
        for mount, secname in spec.secrets.items():
            sec = self.cluster.get("Secret", meta.namespace, secname)
            secrets[mount] = dict(sec.data)
        return mounts, secrets

    # Execution -------------------------------------------------------------

    def _run_job(self, job):
        key = ("Job",) + job.metadata.key
        try:
            if not self._mounts_ready(job.spec, job.metadata.namespace):
                return
            # Atomic claim (CAS on resourceVersion): with several runners
            # (nodes) watching one cluster, exactly one may flip the Job
            # active — a lost race means another node took it.
            job = self.cluster.try_get("Job", *job.metadata.key)
            if job is None or job.status.active > 0 or job.status.succeeded > 0:
                return
            claim_version = job.metadata.resource_version
            mounts, secrets = self._resolve(job.metadata, job.spec)
            job.status.active = 1
            job.status.node = self.node_name
            job.status.start_time = job.status.start_time or datetime.now(
                timezone.utc
            )
            from volsync_tpu_torch.cluster.cluster import Conflict

            try:
                self.cluster.update_status(job, expect_version=claim_version)
            except Conflict:
                return  # another runner claimed it first
            ctx = JobContext(
                name=job.metadata.name, namespace=job.metadata.namespace,
                env=dict(job.spec.env), mounts=mounts, secrets=secrets,
                stop_event=self._stop, cluster=self.cluster,
                attempt=job.status.failed, device=self.device,
            )
            fn = self.catalog.get(job.spec.entrypoint)
            try:
                rc = fn(ctx)
                rc = 0 if rc is None else int(rc)
            except Exception as e:  # noqa: BLE001 — mover failure, not ours
                log.warning("job %s attempt %d failed: %s",
                            job.metadata.name, ctx.attempt, e,
                            exc_info=True)
                job.status.message = "".join(
                    traceback.format_exception_only(type(e), e)
                ).strip()
                rc = 1
            fresh = self.cluster.try_get("Job", *job.metadata.key)
            if fresh is None or fresh.metadata.uid != job.metadata.uid:
                return  # deleted/recreated while we ran
            fresh.status.active = 0
            fresh.status.exit_code = rc
            fresh.status.message = job.status.message
            if rc == 0:
                fresh.status.succeeded = 1
                fresh.status.completion_time = datetime.now(timezone.utc)
            else:
                fresh.status.failed += 1
            self.cluster.update_status(fresh)
        finally:
            with self._lock:
                self._running.pop(key, None)

    def _run_deployment(self, dep, stop):
        key = ("Deployment",) + dep.metadata.key
        claimed = False
        try:
            while not (stop.is_set() or self._stop.is_set()):
                if self._mounts_ready(dep.spec, dep.metadata.namespace):
                    break
                self.cluster.wait_for(lambda: stop.is_set(), timeout=0.2)
            if stop.is_set() or self._stop.is_set():
                return
            # Atomic claim, as for Jobs: replicas=1 means ONE live daemon
            # across all runners.
            dep = self.cluster.try_get("Deployment", *dep.metadata.key)
            if dep is None or (dep.status.ready_replicas > 0
                               and dep.status.node != self.node_name):
                return
            claim_version = dep.metadata.resource_version
            mounts, secrets = self._resolve(dep.metadata, dep.spec)
            dep.status.ready_replicas = 1
            dep.status.node = self.node_name
            from volsync_tpu_torch.cluster.cluster import Conflict

            try:
                self.cluster.update_status(dep, expect_version=claim_version)
            except Conflict:
                return
            claimed = True
            ctx = JobContext(
                name=dep.metadata.name, namespace=dep.metadata.namespace,
                env=dict(dep.spec.env), mounts=mounts, secrets=secrets,
                stop_event=stop, cluster=self.cluster, kind="Deployment",
                device=self.device,
            )
            fn = self.catalog.get(dep.spec.entrypoint)
            try:
                fn(ctx)
            except Exception as e:  # noqa: BLE001
                log.warning("deployment %s crashed: %s", dep.metadata.name, e)
                fresh = self.cluster.try_get("Deployment", *dep.metadata.key)
                if fresh is not None:
                    fresh.status.message = str(e)
                    self.cluster.update_status(fresh)
        finally:
            fresh = self.cluster.try_get("Deployment", *dep.metadata.key)
            if (claimed and fresh is not None
                    and fresh.metadata.uid == dep.metadata.uid):
                fresh.status.ready_replicas = 0
                fresh.status.node = None
                self.cluster.update_status(fresh)
            with self._lock:
                self._running.pop(key, None)
                self._daemon_stops.pop(key, None)
