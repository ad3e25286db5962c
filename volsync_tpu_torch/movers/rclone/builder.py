"""rclone mover: control-plane builder + movers.

Mirrors controllers/mover/rclone/{builder,mover}.go: the builder selects
on ``spec.rclone``; both movers validate the three spec fields and the
config Secret (must carry ``rclone.conf`` — validateRcloneConfig,
mover.go:166-195), allocate the data volume (PiT copy on the source,
provided-or-new on the destination), and run the mover Job with the
reference's env contract (mover.go:236-242). The destination publishes
the PiT image on completion, exactly like restic's.

Ports ``volsync_tpu/movers/rclone/builder.py`` whole.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from volsync_tpu_torch.controller import utils
from volsync_tpu_torch.controller.volumehandler import VolumeHandler
from volsync_tpu_torch.movers.base import Result
from volsync_tpu_torch.movers.common import mover_name, reconcile_job

MOVER_NAME = "rclone"
SECRET_MOUNT = "rclone-secret"
CONFIG_FIELDS = ("rclone.conf",)


def _validate_spec(spec) -> Optional[str]:
    """All three fields are mandatory (validateSpec, mover.go:150-164)."""
    if not spec.rclone_config_section:
        return "rcloneConfigSection is required"
    if not spec.rclone_dest_path:
        return "rcloneDestPath is required"
    if not spec.rclone_config:
        return "rcloneConfig is required"
    return None


def _mover_env(spec) -> dict:
    return {
        "RCLONE_CONFIG": f"/{SECRET_MOUNT}/rclone.conf",
        "RCLONE_DEST_PATH": spec.rclone_dest_path,
        "MOUNT_PATH": "/data",
        "RCLONE_CONFIG_SECTION": spec.rclone_config_section,
    }


@dataclasses.dataclass
class RcloneSourceMover:
    cluster: object
    owner: object
    spec: object  # ReplicationSourceRcloneSpec
    paused: bool = False
    metrics: object = None

    name = MOVER_NAME

    def synchronize(self) -> Result:
        ns = self.owner.metadata.namespace
        problem = _validate_spec(self.spec)
        if problem:
            self.cluster.record_event(self.owner, "Warning", "TransferFailed",
                                      problem, "Synchronizing")
            return Result.in_progress()
        secret = utils.get_and_validate_secret(
            self.cluster, ns, self.spec.rclone_config, CONFIG_FIELDS)
        vh = VolumeHandler.from_volume_options(self.cluster, self.owner,
                                               self.spec)
        data_vol = vh.ensure_pvc_from_src(
            self.owner.spec.source_pvc, mover_name("src", self.owner))
        if data_vol is None:
            return Result.in_progress()
        sa = utils.ensure_service_account(
            self.cluster, self.owner, mover_name("src", self.owner))
        env = _mover_env(self.spec)
        env["DIRECTION"] = "source"
        job = reconcile_job(
            self.cluster, self.owner,
            mover_name("rclone-src", self.owner),
            entrypoint="rclone", env=env,
            volumes={"data": data_vol.metadata.name},
            secrets={SECRET_MOUNT: secret.metadata.name},
            backoff_limit=2,  # rclone/mover.go:225
            paused=self.paused, service_account=sa.metadata.name,
            metrics=self.metrics,
            node_selector=utils.affinity_from_volume(
                self.cluster, ns, data_vol.metadata.name),
        )
        if job is None:
            return Result.in_progress()
        return Result.complete()

    def cleanup(self) -> Result:
        utils.cleanup_objects(self.cluster, self.owner,
                              kinds=("Job", "VolumeSnapshot", "Volume"))
        return Result.complete()


@dataclasses.dataclass
class RcloneDestinationMover:
    cluster: object
    owner: object
    spec: object  # ReplicationDestinationRcloneSpec
    paused: bool = False
    metrics: object = None

    name = MOVER_NAME

    def synchronize(self) -> Result:
        ns = self.owner.metadata.namespace
        problem = _validate_spec(self.spec)
        if problem:
            self.cluster.record_event(self.owner, "Warning", "TransferFailed",
                                      problem, "Synchronizing")
            return Result.in_progress()
        secret = utils.get_and_validate_secret(
            self.cluster, ns, self.spec.rclone_config, CONFIG_FIELDS)
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
        sa = utils.ensure_service_account(
            self.cluster, self.owner, mover_name("dst", self.owner))
        env = _mover_env(self.spec)
        env["DIRECTION"] = "destination"
        job = reconcile_job(
            self.cluster, self.owner,
            mover_name("rclone-dst", self.owner),
            entrypoint="rclone", env=env,
            volumes={"data": dest.metadata.name},
            secrets={SECRET_MOUNT: secret.metadata.name},
            backoff_limit=2, paused=self.paused,
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
        utils.cleanup_objects(self.cluster, self.owner,
                              kinds=("Job", "VolumeSnapshot", "Volume"))
        return Result.complete()


class Builder:
    """Catalog plugin (rclone/builder.go:49-121)."""

    def version_info(self) -> str:
        return "rclone mover (CUDA checksum sync, content-addressed bucket)"

    def from_source(self, cluster, source, metrics=None):
        if source.spec.rclone is None:
            return None
        return RcloneSourceMover(cluster, source, source.spec.rclone,
                                 paused=source.spec.paused)

    def from_destination(self, cluster, destination, metrics=None):
        if destination.spec.rclone is None:
            return None
        return RcloneDestinationMover(cluster, destination,
                                      destination.spec.rclone,
                                      paused=destination.spec.paused)


def register(catalog=None, runner_catalog=None):
    """Wire the mover into the catalogs (registerMovers, main.go:67-81)."""
    from volsync_tpu_torch.cluster.runner import CATALOG as RUNNER_CATALOG
    from volsync_tpu_torch.movers.base import CATALOG as MOVER_CATALOG
    from volsync_tpu_torch.movers.rclone.entry import rclone_entrypoint

    (catalog or MOVER_CATALOG).register(MOVER_NAME, Builder())
    (runner_catalog or RUNNER_CATALOG).register("rclone", rclone_entrypoint)
