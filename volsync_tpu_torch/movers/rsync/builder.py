"""rsync mover: control-plane builder + movers.

Mirrors controllers/mover/rsync/{builder,mover,rsync_common}.go: the
destination assembles the data volume, generated connection-key Secret,
addressed Service, and listener Job, publishing address/port/keys in
status (mover.go:158-205); the source assembles the PiT copy, references
the shared key Secret, and runs the push Job against spec.address. Keys
are generated once and reused (rsync_common.go:104-219's secret scheme,
collapsed to one shared-key Secret for the channel in
movers/rsync/channel.py).

Ports ``volsync_tpu/movers/rsync/builder.py`` whole, over the
port's ``movers/devicetransport.py``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from volsync_tpu_torch.api.common import ObjectMeta
from volsync_tpu_torch.api.types import (
    ReplicationDestinationRsyncStatus,
    ReplicationSourceRsyncStatus,
)
from volsync_tpu_torch.cluster.objects import (Secret, Service, ServicePort,
                                              ServiceSpec)
from volsync_tpu_torch.controller import utils
from volsync_tpu_torch.controller.volumehandler import VolumeHandler
from volsync_tpu_torch.movers.base import Result
from volsync_tpu_torch.movers.common import mover_name, reconcile_job

MOVER_NAME = "rsync"
#: Source-facing secret fields: the SOURCE's private device key + the
#: destination's pinned device ID. The destination's private key never
#: leaves its own secret — the reference's 3-secret asymmetry
#: (rsync_common.go:104-128: main/src/dst split so neither side holds
#: the other's private key).
SRC_KEY_FIELDS = ("source", "destination-id")
DST_KEY_FIELDS = ("destination", "source-id")


@dataclasses.dataclass
class RsyncDestinationMover:
    cluster: object
    owner: object
    spec: object  # ReplicationDestinationRsyncSpec
    paused: bool = False
    metrics: object = None

    name = MOVER_NAME

    def synchronize(self) -> Result:
        ns = self.owner.metadata.namespace
        st = self.owner.ensure_status()
        if st.rsync is None:
            st.rsync = ReplicationDestinationRsyncStatus()
        vh = VolumeHandler.from_volume_options(self.cluster, self.owner,
                                               self.spec)
        dest_name = self.spec.destination_pvc or mover_name("dst", self.owner)
        if self.spec.destination_pvc:
            dest = self.cluster.try_get("Volume", ns, dest_name)
            if dest is None or dest.status.phase != "Bound":
                return Result.in_progress()
        else:
            dest = vh.ensure_new_volume(dest_name)
            if dest is None:
                return Result.in_progress()
        dst_secret, src_secret = self._ensure_keys()
        # Publish the SOURCE-facing half (the reference publishes the
        # source secret's name in .status.rsync.sshKeys the same way).
        st.rsync.ssh_keys = src_secret.metadata.name
        svc = self._ensure_service()
        job = reconcile_job(
            self.cluster, self.owner, mover_name("dst", self.owner),
            entrypoint="rsync-destination",
            env={"SERVICE": svc.metadata.name},
            volumes={"data": dest.metadata.name},
            secrets={"keys": dst_secret.metadata.name},
            backoff_limit=2, paused=self.paused, metrics=self.metrics,
            node_selector=utils.affinity_from_volume(
                self.cluster, ns, dest.metadata.name),
        )
        # Publish the address once the listener has bound its port
        # (ensureServiceAndPublishAddress blocks on this —
        # rsync/mover.go:129-175).
        svc = self.cluster.get("Service", ns, svc.metadata.name)
        address = utils.get_service_address(svc)
        if address and svc.status.bound_port:
            if st.rsync.address is None:
                # First assignment (utils.go:86-100 + mover.go:158-175's
                # address wait resolving): announce it.
                self.cluster.record_event(
                    self.owner, "Normal", "ServiceAddressAssigned",
                    f"listener reachable at {address}:"
                    f"{svc.status.bound_port}")
            st.rsync.address = address
            st.rsync.port = svc.status.bound_port
        else:
            self.cluster.record_event(
                self.owner, "Normal", "NoServiceAddressAssigned",
                "waiting for the listener to publish its port", "Waiting")
        if job is None:
            return Result.in_progress()
        image = vh.ensure_image(dest.metadata.name)
        if image is None:
            return Result.in_progress()
        return Result.complete_with_image(image)

    def cleanup(self) -> Result:
        # Keys/Service persist across iterations (the reference reuses the
        # SSH secrets and Service); Jobs and temp volumes are collected.
        # VolumeSnapshot is included so superseded latestImage snapshots
        # (stamped by mark_old_snapshot_for_cleanup) are collected; the
        # current image carries no cleanup label and survives.
        utils.cleanup_objects(self.cluster, self.owner,
                              kinds=("Job", "VolumeSnapshot", "Volume"))
        return Result.complete()

    def _ensure_keys(self) -> tuple[Secret, Secret]:
        """Generate the asymmetric key split (rsync_common.go:104-219's
        ssh-keygen + 3-secret scheme, with DH device keys): a MAIN secret
        holding both private keys (kept, like the reference's main
        secret), a DESTINATION secret (dest private + source's pinned
        device ID) mounted by the listener Job, and a SOURCE secret
        (source private + destination's pinned ID) whose name is
        published in status for the operator/CLI to copy to the source
        cluster. Returns (dst_secret, src_secret)."""
        from volsync_tpu_torch.movers import devicetransport as dt

        ns = self.owner.metadata.namespace
        main_name = self.spec.ssh_keys or mover_name("dst-main", self.owner)
        if self.spec.ssh_keys:
            # User-supplied main secret: validate its shape up front so a
            # wrong secret is a clean config error, not a KeyError.
            utils.get_and_validate_secret(self.cluster, ns, main_name,
                                          ("source", "destination"))
        main = self.cluster.try_get("Secret", ns, main_name)
        if main is None:
            src_priv = dt.generate_device_key()
            dst_priv = dt.generate_device_key()
            main = Secret(
                metadata=ObjectMeta(name=main_name, namespace=ns),
                data={"source": src_priv, "destination": dst_priv},
            )
            utils.set_owned_by(main, self.owner, self.cluster)
            main = self.cluster.create(main)
        src_priv = main.data["source"]
        dst_priv = main.data["destination"]
        src_id = dt.device_id_from_private(src_priv).encode()
        dst_id = dt.device_id_from_private(dst_priv).encode()

        dst_secret = Secret(
            metadata=ObjectMeta(name=mover_name("dst-keys", self.owner),
                                namespace=ns),
            data={"destination": dst_priv, "source-id": src_id},
        )
        utils.set_owned_by(dst_secret, self.owner, self.cluster)
        dst_secret = self.cluster.apply(dst_secret)

        src_secret = Secret(
            metadata=ObjectMeta(name=mover_name("src-keys", self.owner),
                                namespace=ns),
            data={"source": src_priv, "destination-id": dst_id},
        )
        utils.set_owned_by(src_secret, self.owner, self.cluster)
        src_secret = self.cluster.apply(src_secret)
        return dst_secret, src_secret

    def _ensure_service(self) -> Service:
        name = mover_name("dst", self.owner)
        svc = Service(
            metadata=ObjectMeta(name=name,
                                namespace=self.owner.metadata.namespace),
            spec=ServiceSpec(
                type=self.spec.service_type or "ClusterIP",
                ports=[ServicePort(port=22)],  # the reference's SSH port
            ),
        )
        utils.set_owned_by(svc, self.owner, self.cluster)
        return self.cluster.apply(svc)


@dataclasses.dataclass
class RsyncSourceMover:
    cluster: object
    owner: object
    spec: object  # ReplicationSourceRsyncSpec
    paused: bool = False
    metrics: object = None

    name = MOVER_NAME

    def synchronize(self) -> Result:
        ns = self.owner.metadata.namespace
        st = self.owner.ensure_status()
        if st.rsync is None:
            st.rsync = ReplicationSourceRsyncStatus()
        if not self.spec.address or not self.spec.port:
            raise ValueError(
                "spec.rsync.address and port are required on the source "
                "(copy them from the destination's status.rsync)")
        if not self.spec.ssh_keys:
            raise ValueError(
                "spec.rsync.ssh_keys is required on the source "
                "(the destination's key secret)")
        utils.get_and_validate_secret(self.cluster, ns, self.spec.ssh_keys,
                                      SRC_KEY_FIELDS)
        st.rsync.ssh_keys = self.spec.ssh_keys
        vh = VolumeHandler.from_volume_options(self.cluster, self.owner,
                                               self.spec)
        data_vol = vh.ensure_pvc_from_src(
            self.owner.spec.source_pvc, mover_name("src", self.owner))
        if data_vol is None:
            return Result.in_progress()
        sa = utils.ensure_service_account(
            self.cluster, self.owner, mover_name("src", self.owner))
        job = reconcile_job(
            self.cluster, self.owner, mover_name("src", self.owner),
            entrypoint="rsync-source",
            env={"ADDRESS": self.spec.address, "PORT": str(self.spec.port),
                 "FAST_RETRY": "1"},
            volumes={"data": data_vol.metadata.name},
            secrets={"keys": self.spec.ssh_keys},
            backoff_limit=2, paused=self.paused,
            service_account=sa.metadata.name, metrics=self.metrics,
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


class Builder:
    def version_info(self) -> str:
        return "rsync mover (CUDA delta engine over authenticated channel)"

    def from_source(self, cluster, source, metrics=None):
        if source.spec.rsync is None:
            return None
        return RsyncSourceMover(cluster, source, source.spec.rsync,
                                paused=source.spec.paused)

    def from_destination(self, cluster, destination, metrics=None):
        if destination.spec.rsync is None:
            return None
        return RsyncDestinationMover(cluster, destination,
                                     destination.spec.rsync,
                                     paused=destination.spec.paused)


def register(catalog=None, runner_catalog=None):
    from volsync_tpu_torch.cluster.runner import CATALOG as RUNNER_CATALOG
    from volsync_tpu_torch.movers.base import CATALOG as MOVER_CATALOG
    from volsync_tpu_torch.movers.rsync.entry import (
        rsync_destination_entrypoint,
        rsync_source_entrypoint,
    )

    (catalog or MOVER_CATALOG).register(MOVER_NAME, Builder())
    rc = runner_catalog or RUNNER_CATALOG
    rc.register("rsync-destination", rsync_destination_entrypoint)
    rc.register("rsync-source", rsync_source_entrypoint)
