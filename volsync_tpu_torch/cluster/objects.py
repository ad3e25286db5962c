"""Resource kinds the movers build.

These mirror the Kubernetes objects the reference's movers create
(Jobs/Deployments/Services/Secrets/PVCs/VolumeSnapshots — SURVEY.md §2
#10-13), re-expressed as plain dataclasses over the in-process cluster.

Ports ``volsync_tpu/cluster/objects.py`` whole.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from typing import Optional

from volsync_tpu_torch.api.common import ObjectMeta

#: Node-identity label used by the scheduler (runner node_labels) and the
#: affinity producer (controller/utils.affinity_from_volume) — one wire
#: constant so the selector and the labels can never drift apart.
HOSTNAME_LABEL = "kubernetes.io/hostname"


@dataclasses.dataclass
class VolumeSpec:
    """PVC analogue: a named, provisioned data volume."""

    capacity: Optional[int] = None              # bytes
    access_modes: list = dataclasses.field(default_factory=list)
    storage_class_name: Optional[str] = None
    # PiT provenance, like PVC dataSource: {"kind": "Volume"|"VolumeSnapshot",
    # "name": ...}
    data_source: Optional[dict] = None


@dataclasses.dataclass
class VolumeStatus:
    phase: str = "Pending"      # Pending | Bound
    capacity: Optional[int] = None
    path: Optional[str] = None  # filesystem root of the provisioned volume


@dataclasses.dataclass
class Volume:
    metadata: ObjectMeta
    spec: VolumeSpec = dataclasses.field(default_factory=VolumeSpec)
    status: VolumeStatus = dataclasses.field(default_factory=VolumeStatus)
    kind: str = "Volume"


@dataclasses.dataclass
class VolumeSnapshotSpec:
    source_volume: Optional[str] = None
    volume_snapshot_class_name: Optional[str] = None


@dataclasses.dataclass
class VolumeSnapshotStatus:
    bound_content: Optional[str] = None   # snapshot content path once taken
    ready_to_use: bool = False
    restore_size: Optional[int] = None
    creation_time: Optional[datetime] = None


@dataclasses.dataclass
class VolumeSnapshot:
    metadata: ObjectMeta
    spec: VolumeSnapshotSpec = dataclasses.field(default_factory=VolumeSnapshotSpec)
    status: VolumeSnapshotStatus = dataclasses.field(
        default_factory=VolumeSnapshotStatus
    )
    kind: str = "VolumeSnapshot"


@dataclasses.dataclass
class JobSpec:
    """The mover payload. ``entrypoint`` names a registered data-plane
    entrypoint (the container-image analogue: the reference's Jobs run
    /entry.sh, /source.sh, ... — SURVEY.md §2.2); ``env`` is its config,
    ``volumes`` maps mount names to Volume object names."""

    entrypoint: str = ""
    env: dict = dataclasses.field(default_factory=dict)
    volumes: dict = dataclasses.field(default_factory=dict)
    secrets: dict = dataclasses.field(default_factory=dict)  # mount: secret name
    backoff_limit: int = 2
    parallelism: int = 1            # 0 = paused (rsync/mover.go:366-370)
    node_selector: dict = dataclasses.field(default_factory=dict)
    service_account: Optional[str] = None


@dataclasses.dataclass
class JobStatus:
    active: int = 0
    succeeded: int = 0
    failed: int = 0
    exit_code: Optional[int] = None
    message: Optional[str] = None
    start_time: Optional[datetime] = None
    completion_time: Optional[datetime] = None
    node: Optional[str] = None  # where the payload ran (pod.spec.nodeName)
    # Data-plane self-report (the pod termination-message analogue): how
    # many bytes the transfer moved and how long the data path took. The
    # control plane turns this into the throughput gauge
    # (volsync_data_throughput_bytes_per_second).
    transfer_bytes: Optional[int] = None
    transfer_seconds: Optional[float] = None


@dataclasses.dataclass
class Job:
    metadata: ObjectMeta
    spec: JobSpec = dataclasses.field(default_factory=JobSpec)
    status: JobStatus = dataclasses.field(default_factory=JobStatus)
    kind: str = "Job"


@dataclasses.dataclass
class ServicePort:
    port: int
    target_port: Optional[int] = None
    protocol: str = "TCP"


@dataclasses.dataclass
class ServiceSpec:
    type: str = "ClusterIP"  # ClusterIP | LoadBalancer
    ports: list = dataclasses.field(default_factory=list)
    selector: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ServiceStatus:
    cluster_ip: Optional[str] = None
    load_balancer_hostname: Optional[str] = None
    load_balancer_ip: Optional[str] = None
    bound_port: Optional[int] = None  # actual listening port of the backend


@dataclasses.dataclass
class Service:
    metadata: ObjectMeta
    spec: ServiceSpec = dataclasses.field(default_factory=ServiceSpec)
    status: ServiceStatus = dataclasses.field(default_factory=ServiceStatus)
    kind: str = "Service"


@dataclasses.dataclass
class Secret:
    metadata: ObjectMeta
    data: dict = dataclasses.field(default_factory=dict)  # str -> bytes
    kind: str = "Secret"


@dataclasses.dataclass
class ServiceAccount:
    metadata: ObjectMeta
    kind: str = "ServiceAccount"


@dataclasses.dataclass
class PolicyRule:
    """One RBAC rule (rbacv1.PolicyRule shape, trimmed to what the
    per-CR mover identity needs — utils/sahandler.go:47-55)."""

    api_groups: list = dataclasses.field(default_factory=list)
    resources: list = dataclasses.field(default_factory=list)
    resource_names: list = dataclasses.field(default_factory=list)
    verbs: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Role:
    metadata: ObjectMeta
    rules: list = dataclasses.field(default_factory=list)  # [PolicyRule]
    kind: str = "Role"


@dataclasses.dataclass
class RoleBinding:
    metadata: ObjectMeta
    role_name: str = ""
    subjects: list = dataclasses.field(default_factory=list)  # [(kind, name)]
    kind: str = "RoleBinding"


@dataclasses.dataclass
class DeploymentSpec:
    """Always-on mover (the live-sync daemon runs as a Deployment, not a
    Job — syncthing/mover.go:389-522)."""

    entrypoint: str = ""
    env: dict = dataclasses.field(default_factory=dict)
    volumes: dict = dataclasses.field(default_factory=dict)
    secrets: dict = dataclasses.field(default_factory=dict)
    replicas: int = 1
    node_selector: dict = dataclasses.field(default_factory=dict)
    service_account: Optional[str] = None


@dataclasses.dataclass
class DeploymentStatus:
    ready_replicas: int = 0
    message: Optional[str] = None
    node: Optional[str] = None
    transfer_bytes: Optional[int] = None
    transfer_seconds: Optional[float] = None


@dataclasses.dataclass
class Deployment:
    metadata: ObjectMeta
    spec: DeploymentSpec = dataclasses.field(default_factory=DeploymentSpec)
    status: DeploymentStatus = dataclasses.field(default_factory=DeploymentStatus)
    kind: str = "Deployment"


@dataclasses.dataclass
class Event:
    """Recorded against an involved object (mover/events.go vocabulary)."""

    metadata: ObjectMeta
    involved_kind: str = ""
    involved_name: str = ""
    type: str = "Normal"   # Normal | Warning
    reason: str = ""
    action: str = ""
    message: str = ""
    kind: str = "Event"


KINDS = {
    "Volume": Volume,
    "VolumeSnapshot": VolumeSnapshot,
    "Job": Job,
    "Service": Service,
    "Secret": Secret,
    "ServiceAccount": ServiceAccount,
    "Role": Role,
    "RoleBinding": RoleBinding,
    "Deployment": Deployment,
    "Event": Event,
}
