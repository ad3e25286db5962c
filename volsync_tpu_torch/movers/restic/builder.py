"""restic mover: control-plane builder + movers.

Mirrors controllers/mover/restic/{builder,mover}.go: builder selects on
``spec.restic``; the source mover assembles PiT data volume, cache
volume, service account, validated repository secret, and the backup
Job (with prune cadence + retain policy); the destination mover restores
into the destination volume and publishes the PiT image.

Ports ``volsync_tpu/movers/restic/builder.py`` whole.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime, timedelta, timezone
from typing import Optional

from volsync_tpu_torch.api.common import ObjectMeta
from volsync_tpu_torch.api.types import ReplicationSourceResticStatus
from volsync_tpu_torch.cluster.objects import Volume, VolumeSpec
from volsync_tpu_torch.controller import utils
from volsync_tpu_torch.controller.volumehandler import VolumeHandler
from volsync_tpu_torch.movers import base
from volsync_tpu_torch.movers.base import Result
from volsync_tpu_torch.movers.common import (
    ensure_cache_volume,
    mover_name,
    reconcile_job,
)

MOVER_NAME = "restic"
REPO_SECRET_FIELDS = ("RESTIC_REPOSITORY", "RESTIC_PASSWORD")
DEFAULT_PRUNE_INTERVAL_DAYS = 7
DEFAULT_CACHE_CAPACITY = 1 * 1024 * 1024 * 1024  # 1Gi (restic/mover.go:154)


def _retain_env(retain) -> dict:
    """Retain policy -> engine env (generateForgetOptions,
    restic/mover.go:440-471)."""
    if retain is None:
        return {}
    env = {}
    for attr, key in (("last", "FORGET_LAST"), ("hourly", "FORGET_HOURLY"),
                      ("daily", "FORGET_DAILY"), ("weekly", "FORGET_WEEKLY"),
                      ("monthly", "FORGET_MONTHLY"),
                      ("yearly", "FORGET_YEARLY")):
        v = getattr(retain, attr)
        if v is not None:
            env[key] = str(v)
    if retain.within is not None:
        env["FORGET_WITHIN"] = str(retain.within)
    return env


@dataclasses.dataclass
class ResticSourceMover:
    cluster: object
    owner: object
    spec: object  # ReplicationSourceResticSpec
    paused: bool = False
    metrics: object = None  # BoundMetrics, attached by the reconciler

    name = MOVER_NAME

    def synchronize(self) -> Result:
        ns = self.owner.metadata.namespace
        vh = VolumeHandler.from_volume_options(self.cluster, self.owner,
                                               self.spec)
        data_vol = vh.ensure_pvc_from_src(
            self.owner.spec.source_pvc, mover_name("src", self.owner))
        if data_vol is None:
            return Result.in_progress()
        cache = self._ensure_cache()
        if cache is None:
            return Result.in_progress()
        sa = utils.ensure_service_account(
            self.cluster, self.owner, mover_name("src", self.owner))
        secret = utils.get_and_validate_secret(
            self.cluster, ns, self.spec.repository, REPO_SECRET_FIELDS)
        env = utils.env_from_secret(secret, secret.data.keys())
        env["DIRECTION"] = "backup"
        env.update(_retain_env(self.spec.retain))
        if self._should_prune():
            env["PRUNE"] = "1"
        job = reconcile_job(
            self.cluster, self.owner, mover_name("src", self.owner),
            entrypoint="restic", env=env,
            volumes={"data": data_vol.metadata.name,
                     "cache": cache.metadata.name},
            backoff_limit=8,  # restic/mover.go:286
            paused=self.paused, service_account=sa.metadata.name,
            metrics=self.metrics,
            node_selector=utils.affinity_from_volume(
                self.cluster, ns, data_vol.metadata.name),
        )
        if job is None:
            return Result.in_progress()
        if job.spec.env.get("PRUNE") == "1":
            st = self.owner.ensure_status()
            if st.restic is None:
                st.restic = ReplicationSourceResticStatus()
            st.restic.last_pruned = datetime.now(timezone.utc)
        return Result.complete()

    def cleanup(self) -> Result:
        # Cache volume is intentionally NOT marked for cleanup: it
        # persists across iterations (restic/mover.go keeps the cache PVC;
        # CR deletion collects it via ownership).
        utils.cleanup_objects(self.cluster, self.owner,
                              kinds=("Job", "VolumeSnapshot", "Volume"))
        return Result.complete()

    # -- helpers -------------------------------------------------------------

    def _ensure_cache(self) -> Optional[Volume]:
        return ensure_cache_volume(self.cluster, self.owner, self.spec,
                                   mover_name("cache", self.owner))

    def _should_prune(self) -> bool:
        """Prune cadence vs status.restic.last_pruned; the first prune
        anchors to the CR's creation so it fires one interval in
        (shouldPrune, restic/mover.go:427-438 — anchoring to creation
        avoids the never-prunes cycle of waiting for a stamp that only a
        prune can write)."""
        days = self.spec.prune_interval_days or DEFAULT_PRUNE_INTERVAL_DAYS
        st = self.owner.status
        last = (st.restic.last_pruned if (st and st.restic) else None) \
            or self.owner.metadata.creation_timestamp
        if last is None:
            return False
        return datetime.now(timezone.utc) - last >= timedelta(days=days)


@dataclasses.dataclass
class ResticDestinationMover:
    cluster: object
    owner: object
    spec: object  # ReplicationDestinationResticSpec
    paused: bool = False
    metrics: object = None

    name = MOVER_NAME

    def synchronize(self) -> Result:
        ns = self.owner.metadata.namespace
        vh = VolumeHandler.from_volume_options(self.cluster, self.owner,
                                               self.spec)
        dest_name = (self.spec.destination_pvc
                     or mover_name("dst", self.owner))
        if self.spec.destination_pvc:
            dest = self.cluster.try_get("Volume", ns, dest_name)
            if dest is None or dest.status.phase != "Bound":
                return Result.in_progress()
        else:
            dest = vh.ensure_new_volume(dest_name)
            if dest is None:
                return Result.in_progress()
        cache = self._ensure_cache()
        if cache is None:
            return Result.in_progress()
        sa = utils.ensure_service_account(
            self.cluster, self.owner, mover_name("dst", self.owner))
        secret = utils.get_and_validate_secret(
            self.cluster, ns, self.spec.repository, REPO_SECRET_FIELDS)
        env = utils.env_from_secret(secret, secret.data.keys())
        env["DIRECTION"] = "restore"
        if self.spec.previous is not None:
            env["SELECT_PREVIOUS"] = str(self.spec.previous)
        if self.spec.restore_as_of is not None:
            env["RESTORE_AS_OF"] = self.spec.restore_as_of.isoformat()
        job = reconcile_job(
            self.cluster, self.owner, mover_name("dst", self.owner),
            entrypoint="restic", env=env,
            volumes={"data": dest.metadata.name,
                     "cache": cache.metadata.name},
            backoff_limit=8, paused=self.paused,
            service_account=sa.metadata.name, metrics=self.metrics,
            node_selector=utils.affinity_from_volume(
                self.cluster, ns, dest.metadata.name),
        )
        if job is None:
            return Result.in_progress()
        image = vh.ensure_image(dest.metadata.name)
        if image is None:
            return Result.in_progress()
        return Result.complete_with_image(image)

    def cleanup(self) -> Result:
        # Superseded latestImage snapshots are label-selected; the current
        # image has no cleanup label and survives.
        utils.cleanup_objects(self.cluster, self.owner,
                              kinds=("Job", "VolumeSnapshot", "Volume"))
        return Result.complete()

    def _ensure_cache(self) -> Optional[Volume]:
        return ensure_cache_volume(self.cluster, self.owner, self.spec,
                                   mover_name("dst-cache", self.owner))


class Builder:
    """Catalog plugin (restic/builder.go:51-130)."""

    def version_info(self) -> str:
        return "restic mover (CUDA engine, clean-room repo format v1)"

    def from_source(self, cluster, source, metrics=None):
        if source.spec.restic is None:
            return None
        return ResticSourceMover(cluster, source, source.spec.restic,
                                 paused=source.spec.paused)

    def from_destination(self, cluster, destination, metrics=None):
        if destination.spec.restic is None:
            return None
        return ResticDestinationMover(cluster, destination,
                                      destination.spec.restic,
                                      paused=destination.spec.paused)


def register(catalog=None, runner_catalog=None):
    """Wire the mover into the catalogs (registerMovers, main.go:67-81)."""
    from volsync_tpu_torch.cluster.runner import CATALOG as RUNNER_CATALOG
    from volsync_tpu_torch.movers.base import CATALOG as MOVER_CATALOG
    from volsync_tpu_torch.movers.restic.entry import restic_entrypoint

    (catalog or MOVER_CATALOG).register(MOVER_NAME, Builder())
    (runner_catalog or RUNNER_CATALOG).register("restic", restic_entrypoint)
