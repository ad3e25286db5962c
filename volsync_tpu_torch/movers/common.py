"""Shared mover plumbing: job lifecycle, naming, poll-to-result.

Captures the Job-handling behavior every reference mover repeats:
create-or-adopt the mover Job, treat paused as parallelism 0
(rsync/mover.go:366-370), poll until succeeded, and on exhausted backoff
delete + recreate fresh (rsync/mover.go:436-443).

Ports ``volsync_tpu/movers/common.py`` whole: the protocol planner's
front door (``plan_protocol``) and the operator's Job plumbing
(``mover_name``, ``publish_transfer``, ``reconcile_job``, ``job_result``,
``ensure_cache_volume``).
"""

from __future__ import annotations

from typing import Optional

from volsync_tpu_torch.api.common import ObjectMeta
from volsync_tpu_torch.cluster.objects import Job, JobSpec
from volsync_tpu_torch.controller import utils
from volsync_tpu_torch.movers import base
from volsync_tpu_torch.movers.base import Result

#: Annotation stamped on a completed Job once its transfer report has been
#: turned into metrics + event, so re-reconciles don't double-count.
TRANSFER_RECORDED_ANNOTATION = "volsync.backube/transfer-recorded"


def plan_protocol(mover: str, size: int, *, basis_exists: bool = True,
                  candidates=None, full_cap=None, block_len=None):
    """One-stop planner call for a mover data plane: refresh the mover's
    ``SyncStatsBook`` from its live feeds (ResilientStore link timings,
    dedup-index counters), then price and decide for one ``size``-byte
    file. Movers always allow probe runs — they are the parties that CAN
    run the fancier protocol, so they must be the ones seeding an empty
    book (protoplan's cold-start contract).

    Returns the full ``protoplan.PlanDecision`` (``.protocol`` is the
    verdict; losing scores stay attached for the caller's telemetry).
    """
    from volsync_tpu_torch.engine import protoplan, syncstats

    book = syncstats.book_for(mover)
    book.pull_link_timings()
    book.pull_index_metrics()
    kwargs = {"basis_exists": basis_exists, "allow_probe": True,
              "full_cap": full_cap, "block_len": block_len}
    if candidates is not None:
        kwargs["candidates"] = candidates
    return protoplan.decide(size, book.snapshot(), **kwargs)


def mover_name(prefix: str, owner) -> str:
    return f"volsync-{prefix}-{owner.metadata.name}"


def publish_transfer(cluster, owner, job, metrics=None):
    """On Job completion: fold the data plane's transfer self-report
    (JobStatus.transfer_*) into the throughput gauge and emit the
    completion event, exactly once per Job incarnation."""
    if job.metadata.annotations.get(TRANSFER_RECORDED_ANNOTATION):
        return
    nbytes, secs = job.status.transfer_bytes, job.status.transfer_seconds
    if nbytes is not None and secs:
        rate = nbytes / secs
        if metrics is not None:
            metrics.throughput.set(rate)
        cluster.record_event(
            owner, "Normal", base.EV_TRANSFER_COMPLETED,
            f"transfer completed: {nbytes} bytes in {secs:.3f}s "
            f"({rate / (1 << 20):.1f} MiB/s)")
    else:
        cluster.record_event(owner, "Normal", base.EV_TRANSFER_COMPLETED,
                             "transfer completed")
    job.metadata.annotations[TRANSFER_RECORDED_ANNOTATION] = "1"
    cluster.update(job)


def reconcile_job(cluster, owner, name: str, *, entrypoint: str, env: dict,
                  volumes: dict, secrets: Optional[dict] = None,
                  backoff_limit: int = 2, paused: bool = False,
                  service_account: Optional[str] = None,
                  node_selector: Optional[dict] = None,
                  metrics=None) -> Optional[Job]:
    """Ensure the mover Job exists with the desired payload; return it
    once it has succeeded, None while still in progress.

    Failure handling matches the reference: when failures exceed the
    backoff limit the Job is deleted and recreated from scratch so the
    next reconcile retries cleanly (utils/reconcile.go + mover.go:436-443).
    """
    existing = cluster.try_get("Job", owner.metadata.namespace, name)
    if existing is not None and existing.status.failed > backoff_limit:
        cluster.record_event(owner, "Warning", "TransferFailed",
                             f"job {name} exceeded backoff limit; recreating",
                             "Recreating")
        cluster.delete("Job", owner.metadata.namespace, name)
        existing = None
    if existing is not None:
        if existing.status.succeeded > 0:
            publish_transfer(cluster, owner, existing, metrics)
        # The Job template is treated as immutable once created (k8s Job
        # semantics): only pause/unpause is applied. In particular the env
        # that RAN is preserved, so callers reading job.spec.env after
        # completion see the payload the entrypoint actually executed
        # with, not this pass's recomputed desire. Each sync iteration
        # gets a fresh Job (cleanup collects the old one), picking up the
        # new desired spec then.
        want_par = 0 if paused else 1
        dirty = False
        if existing.spec.parallelism != want_par:
            existing.spec.parallelism = want_par
            dirty = True
        # Affinity is re-resolved every reconcile (the reference computes
        # it fresh each ensureJob — utils/affinity.go:35): as long as the
        # Job hasn't started, a late-arriving app workload can still pin
        # it to the right node.
        want_sel = dict(node_selector or {})
        if (existing.status.active == 0 and existing.status.succeeded == 0
                and want_sel and existing.spec.node_selector != want_sel):
            existing.spec.node_selector = want_sel
            dirty = True
        if dirty:
            existing = cluster.update(existing)
        return existing if existing.status.succeeded > 0 else None
    job = Job(
        metadata=ObjectMeta(name=name, namespace=owner.metadata.namespace),
        spec=JobSpec(
            entrypoint=entrypoint, env=dict(env), volumes=dict(volumes),
            secrets=dict(secrets or {}), backoff_limit=backoff_limit,
            parallelism=0 if paused else 1,
            node_selector=dict(node_selector or {}),
            service_account=service_account,
        ),
    )
    utils.set_owned_by(job, owner, cluster)
    utils.mark_for_cleanup(job, owner)
    job = cluster.create(job)
    if not paused:  # a paused Job (parallelism 0) hasn't started anything
        cluster.record_event(owner, "Normal", base.EV_TRANSFER_STARTED,
                             f"mover job {name} created", base.ACT_CREATING)
    return job if job.status.succeeded > 0 else None


def job_result(job: Optional[Job]) -> Result:
    """Map ensure_job output to a state-machine Result."""
    if job is None:
        return Result.in_progress()
    return Result.complete()


def ensure_cache_volume(cluster, owner, spec, name: str):
    """Dedicated mover cache volume with the reference's fallback chain
    (cache_* fields, else the data volume options — restic/mover.go:
    154-193). Not marked for cleanup: it persists across iterations and
    is collected with the CR via ownership."""
    from volsync_tpu_torch.cluster.objects import Volume, VolumeSpec

    default_capacity = 1 * 1024 * 1024 * 1024  # 1Gi
    vol = Volume(
        metadata=ObjectMeta(name=name, namespace=owner.metadata.namespace),
        spec=VolumeSpec(
            capacity=getattr(spec, "cache_capacity", None) or default_capacity,
            access_modes=(list(getattr(spec, "cache_access_modes", []))
                          or list(getattr(spec, "access_modes", []))),
            storage_class_name=(getattr(spec, "cache_storage_class_name", None)
                                or getattr(spec, "storage_class_name", None)),
        ),
    )
    utils.set_owned_by(vol, owner, cluster)
    vol = cluster.apply(vol)
    return vol if vol.status.phase == "Bound" else None
