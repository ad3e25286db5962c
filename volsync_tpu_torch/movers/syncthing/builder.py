"""syncthing mover: control plane.

Mirrors controllers/mover/syncthing/{mover,builder}.go: an always-on
Deployment (not a Job) serving live N-way sync, plus a config volume, a
generated API-key/device-cert Secret (ensureSecretAPIKey mover.go:312-369
+ tlsutils.go:123-166 — the cert here is the DH device key of
transport.py), API + data Services (mover.go:525-601), and — the part
that makes this mover unique — a control-plane conversation with the
LIVE daemon every reconcile: fetch config/status/connections, reconcile
the device list against spec.syncthing.peers, publish the updated
config, and record ID/address/connected-peers in CR status
(interactWithSyncthing mover.go:205-236, ensureIsConfigured :673-720,
getConnectedPeers :740-782). Cleanup is a no-op (:617-623) — the daemon
lives for as long as the CR does.

Ports ``volsync_tpu/movers/syncthing/builder.py`` whole, over
the port's ``transport.py`` and ``apiclient.py``.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Optional

from volsync_tpu_torch.api.common import ObjectMeta, SyncthingPeerStatus
from volsync_tpu_torch.api.types import ReplicationSourceSyncthingStatus
from volsync_tpu_torch.cluster.objects import (
    Deployment,
    DeploymentSpec,
    Secret,
    Service,
    ServicePort,
    ServiceSpec,
    Volume,
    VolumeSpec,
)
from volsync_tpu_torch.controller import utils
from volsync_tpu_torch.movers import base
from volsync_tpu_torch.movers.base import Result
from volsync_tpu_torch.movers.common import mover_name
from volsync_tpu_torch.movers.syncthing import transport
from volsync_tpu_torch.movers.syncthing.apiclient import (
    SyncthingConnection,
    try_fetch,
)

MOVER_NAME = "syncthing"
DEFAULT_CONFIG_CAPACITY = 1 * 1024 * 1024 * 1024  # 1Gi config volume
#: The reference re-polls the live daemon every 20s (mover.go:146-156);
#: the in-process substrate converges much faster, so the poll is a
#: builder knob with the reference's default.
DEFAULT_POLL_SECONDS = 20.0

SECRET_FIELDS = ("apikey", "username", "password", "cert", "device-id")


@dataclasses.dataclass
class SyncthingMover:
    cluster: object
    owner: object
    spec: object  # ReplicationSourceSyncthingSpec
    paused: bool = False
    poll_seconds: float = DEFAULT_POLL_SECONDS
    metrics: object = None

    name = MOVER_NAME

    # -- reconcile ----------------------------------------------------------

    def synchronize(self) -> Result:
        st = self.owner.ensure_status()
        if st.syncthing is None:
            st.syncthing = ReplicationSourceSyncthingStatus()
        data_vol = self._ensure_data_volume()
        if data_vol is None:
            return Result.in_progress()
        config_vol = self._ensure_config_volume()
        if config_vol is None:
            return Result.in_progress()
        secret = self._ensure_secret()
        api_svc = self._ensure_service("api", port=8384)
        data_svc = self._ensure_service(
            "data", port=22000, service_type=self.spec.service_type)
        self._ensure_deployment(data_vol, config_vol, secret, api_svc,
                                data_svc)

        # Talk to the LIVE daemon (interactWithSyncthing mover.go:205-236).
        api_addr, api_port = self._service_endpoint(api_svc)
        if api_addr is None:
            return Result.retry(timedelta(seconds=min(self.poll_seconds, 1)))
        state = try_fetch(api_addr, api_port, secret.data["apikey"])
        if state is None:
            return Result.retry(timedelta(seconds=min(self.poll_seconds, 1)))

        self._ensure_is_configured(state, secret, api_addr, api_port)
        self._update_status(state, data_svc, secret)
        # Always-on mover: never "completed" — re-poll on a cadence.
        return Result.retry(timedelta(seconds=self.poll_seconds))

    def cleanup(self) -> Result:
        """No-op (mover.go:617-623): the daemon and its resources live
        for the CR's lifetime; CR deletion collects them via ownership."""
        return Result.complete()

    # -- resources (ensureNecessaryResources :162-200) -----------------------

    def _ensure_data_volume(self) -> Optional[Volume]:
        # The live-sync folder IS the application volume: syncthing mounts
        # the source PVC directly, no PiT copy (the reference's dataPVC).
        vol = self.cluster.try_get("Volume", self.owner.metadata.namespace,
                                   self.owner.spec.source_pvc)
        if vol is None or vol.status.phase != "Bound":
            return None
        return vol

    def _ensure_config_volume(self) -> Optional[Volume]:
        vol = Volume(
            metadata=ObjectMeta(name=mover_name("st-config", self.owner),
                                namespace=self.owner.metadata.namespace),
            spec=VolumeSpec(
                capacity=self.spec.config_capacity or DEFAULT_CONFIG_CAPACITY,
                access_modes=list(self.spec.config_access_modes),
                storage_class_name=self.spec.config_storage_class_name,
            ),
        )
        utils.set_owned_by(vol, self.owner, self.cluster)
        vol = self.cluster.apply(vol)
        return vol if vol.status.phase == "Bound" else None

    def _ensure_secret(self) -> Secret:
        """Generated API key + credentials + device cert
        (ensureSecretAPIKey mover.go:312-369; the cert is the transport's
        DH device key, its hash the device ID — tlsutils.go:123-166)."""
        name = mover_name("st", self.owner)
        existing = self.cluster.try_get(
            "Secret", self.owner.metadata.namespace, name)
        if existing is not None:
            utils.get_and_validate_secret(
                self.cluster, self.owner.metadata.namespace, name,
                SECRET_FIELDS)
            return existing
        private = transport.generate_device_key()
        secret = Secret(
            metadata=ObjectMeta(name=name,
                                namespace=self.owner.metadata.namespace),
            data={
                "apikey": os.urandom(32),
                "username": b"syncthing",
                "password": os.urandom(16).hex().encode(),
                "cert": private,
                "device-id": transport.device_id_from_private(
                    private).encode(),
            },
        )
        utils.set_owned_by(secret, self.owner, self.cluster)
        return self.cluster.create(secret)

    def _ensure_service(self, which: str, *, port: int,
                        service_type: Optional[str] = None) -> Service:
        svc = Service(
            metadata=ObjectMeta(
                name=mover_name(f"st-{which}", self.owner),
                namespace=self.owner.metadata.namespace),
            spec=ServiceSpec(type=service_type or "ClusterIP",
                             ports=[ServicePort(port=port)]),
        )
        utils.set_owned_by(svc, self.owner, self.cluster)
        return self.cluster.apply(svc)

    def _ensure_deployment(self, data_vol, config_vol, secret, api_svc,
                           data_svc) -> Deployment:
        dep = Deployment(
            metadata=ObjectMeta(name=mover_name("st", self.owner),
                                namespace=self.owner.metadata.namespace),
            spec=DeploymentSpec(
                entrypoint="syncthing",
                env={"SERVICE_API": api_svc.metadata.name,
                     "SERVICE_DATA": data_svc.metadata.name},
                volumes={"data": data_vol.metadata.name,
                         "config": config_vol.metadata.name},
                secrets={"secret": secret.metadata.name},
                replicas=0 if self.paused else 1,
                node_selector=utils.affinity_from_volume(
                    self.cluster, self.owner.metadata.namespace,
                    data_vol.metadata.name),
            ),
        )
        utils.set_owned_by(dep, self.owner, self.cluster)
        existing = self.cluster.try_get("Deployment", *dep.metadata.key)
        if existing is None:
            self.cluster.record_event(
                self.owner, "Normal", base.EV_TRANSFER_STARTED,
                "syncthing daemon deployment created", base.ACT_CREATING)
        return self.cluster.apply(dep)

    # -- live-daemon interaction --------------------------------------------

    def _service_endpoint(self, svc) -> tuple[Optional[str], Optional[int]]:
        fresh = self.cluster.get("Service", *svc.metadata.key)
        address = utils.get_service_address(fresh)
        return (address, fresh.status.bound_port) \
            if address and fresh.status.bound_port else (None, None)

    def _desired_devices(self, state) -> list:
        """spec.peers plus live devices an introducer brought in
        (updateSyncthingDevices syncthing.go:32-119 retains introduced
        nodes as long as their introducer is still configured — wiping
        them every poll would defeat the introducer feature)."""
        my_id = state.my_id
        desired = {p.id: {"id": p.id, "address": p.address,
                          "introducer": p.introducer}
                   for p in self.spec.peers if p.id != my_id}
        introducers = {p.id for p in self.spec.peers if p.introducer}
        for dev in state.config.get("devices", []):
            did = dev.get("id")
            if (did and did not in desired
                    and dev.get("introduced_by") in introducers):
                desired[did] = dev
        return sorted(desired.values(), key=lambda d: d["id"])

    def _ensure_is_configured(self, state, secret, api_addr, api_port):
        """Diff the live device list against the desired set and publish
        when they differ (ensureIsConfigured :673-720)."""
        desired = self._desired_devices(state)
        current = sorted(state.config.get("devices", []),
                         key=lambda d: d.get("id", ""))
        if current != desired:
            SyncthingConnection(
                api_addr, api_port, secret.data["apikey"],
            ).publish_config({"devices": desired})

    def _update_status(self, state, data_svc, secret):
        """ID + data address + per-peer connectivity
        (ensureStatusIsUpdated :723-737, getConnectedPeers :740-782)."""
        st = self.owner.status.syncthing
        st.id = state.my_id
        addr, port = self._service_endpoint(data_svc)
        st.address = f"tcp://{addr}:{port}" if addr else None
        # Status covers the LIVE device list (spec peers + introduced),
        # with introduced_by carried through (getConnectedPeers :740-782).
        st.peers = [
            SyncthingPeerStatus(
                address=state.connections.get(d["id"], {}).get(
                    "address", d.get("address", "")),
                id=d["id"],
                connected=state.connections.get(d["id"], {}).get(
                    "connected", False),
                introduced_by=d.get("introduced_by"),
            )
            for d in self._desired_devices(state)
        ]


class Builder:
    """Catalog plugin (syncthing/builder.go). Source-only, like the
    reference (syncthing has no ReplicationDestination section)."""

    def __init__(self, poll_seconds: float = DEFAULT_POLL_SECONDS):
        self.poll_seconds = poll_seconds

    def version_info(self) -> str:
        return "syncthing mover (CUDA block hashing, device-ID mesh)"

    def from_source(self, cluster, source, metrics=None):
        if source.spec.syncthing is None:
            return None
        return SyncthingMover(cluster, source, source.spec.syncthing,
                              paused=source.spec.paused,
                              poll_seconds=self.poll_seconds)

    def from_destination(self, cluster, destination, metrics=None):
        return None


def register(catalog=None, runner_catalog=None,
             poll_seconds: float = DEFAULT_POLL_SECONDS):
    from volsync_tpu_torch.cluster.runner import CATALOG as RUNNER_CATALOG
    from volsync_tpu_torch.movers.base import CATALOG as MOVER_CATALOG
    from volsync_tpu_torch.movers.syncthing.entry import syncthing_entrypoint

    (catalog or MOVER_CATALOG).register(
        MOVER_NAME, Builder(poll_seconds=poll_seconds))
    (runner_catalog or RUNNER_CATALOG).register("syncthing",
                                                syncthing_entrypoint)
