"""ReplicationSource / ReplicationDestination spec & status types.

Re-expression of the reference CRD surface:
``api/v1alpha1/replicationsource_types.go`` (trigger :45-60, rsync :95-119,
rclone :122-130, restic + retain :133-174, syncthing :184-199, spec
:201-228, status :256-290) and ``replicationdestination_types.go`` (volume
options incl. destinationPVC :62-86, restore selectors :194-200,
latestImage :222-225). Every user-facing knob of the reference is present;
the engines behind them are the PyTorch/CUDA data plane.

Ports ``volsync_tpu/api/types.py`` whole: a CR or status
written by either package's ``to_dict`` loads in the other's ``from_dict``.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime, timedelta
from typing import List, Optional

from volsync_tpu_torch.api.common import (
    Condition,
    CopyMethod,
    ObjectMeta,
    SyncthingPeer,
    SyncthingPeerStatus,
)


@dataclasses.dataclass
class TypedLocalObjectReference:
    """Reference to a typed object in the same namespace (latestImage)."""

    kind: str
    name: str
    api_group: Optional[str] = None


@dataclasses.dataclass
class ReplicationTrigger:
    """When to sync (replicationsource_types.go:45-60).

    Exactly one of ``schedule`` (cron expression) or ``manual`` (an opaque
    tag; sync runs once per new tag value and acks via
    ``status.last_manual_sync``) — or neither, which means continuous
    re-sync.
    """

    schedule: Optional[str] = None
    manual: Optional[str] = None


@dataclasses.dataclass
class ReplicationSourceVolumeOptions:
    """How the PiT copy of the source volume is made (types.go:62-93)."""

    copy_method: CopyMethod = CopyMethod.SNAPSHOT
    capacity: Optional[int] = None          # bytes
    storage_class_name: Optional[str] = None
    access_modes: List[str] = dataclasses.field(default_factory=list)
    volume_snapshot_class_name: Optional[str] = None


@dataclasses.dataclass
class ReplicationDestinationVolumeOptions:
    """Destination volume options incl. a preprovisioned destination
    volume (replicationdestination_types.go:62-86)."""

    copy_method: CopyMethod = CopyMethod.SNAPSHOT
    capacity: Optional[int] = None
    storage_class_name: Optional[str] = None
    access_modes: List[str] = dataclasses.field(default_factory=list)
    volume_snapshot_class_name: Optional[str] = None
    destination_pvc: Optional[str] = None


# ---------------------------------------------------------------------------
# Per-mover spec sections (source side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReplicationSourceRsyncSpec(ReplicationSourceVolumeOptions):
    """Delta-sync mover (replicationsource_types.go:95-119): push the
    volume to a remote destination over an authenticated channel."""

    ssh_keys: Optional[str] = None       # Secret with keypair (auto-gen if None)
    service_type: Optional[str] = None   # ClusterIP | LoadBalancer
    address: Optional[str] = None        # destination address to push to
    port: Optional[int] = None
    path: Optional[str] = None
    ssh_user: Optional[str] = None


@dataclasses.dataclass
class ReplicationSourceRcloneSpec(ReplicationSourceVolumeOptions):
    """Bucket-sync mover (replicationsource_types.go:122-130)."""

    rclone_config_section: Optional[str] = None
    rclone_dest_path: Optional[str] = None
    rclone_config: Optional[str] = None  # Secret name holding the config


@dataclasses.dataclass
class ResticRetainPolicy:
    """Snapshot retention (replicationsource_types.go:133-152)."""

    hourly: Optional[int] = None
    daily: Optional[int] = None
    weekly: Optional[int] = None
    monthly: Optional[int] = None
    yearly: Optional[int] = None
    within: Optional[str] = None  # duration string like "3h30m"
    last: Optional[int] = None


@dataclasses.dataclass
class ReplicationSourceResticSpec(ReplicationSourceVolumeOptions):
    """Deduplicating backup mover (replicationsource_types.go:154-174)."""

    prune_interval_days: Optional[int] = None    # default 7 (mover-level)
    repository: Optional[str] = None             # Secret with repo URL+password
    retain: Optional[ResticRetainPolicy] = None
    cache_capacity: Optional[int] = None         # bytes; default 1 GiB
    cache_storage_class_name: Optional[str] = None
    cache_access_modes: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ReplicationSourceSyncthingSpec(ReplicationSourceVolumeOptions):
    """Live P2P sync mover (replicationsource_types.go:184-199)."""

    peers: List[SyncthingPeer] = dataclasses.field(default_factory=list)
    service_type: Optional[str] = None
    config_capacity: Optional[int] = None
    config_storage_class_name: Optional[str] = None
    config_access_modes: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ReplicationSourceExternalSpec:
    """Hand off to an out-of-tree mover (replicationsource_types.go:176-182)."""

    provisioner: str = ""
    parameters: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ReplicationSourceSpec:
    """replicationsource_types.go:201-228. Exactly one mover section may be
    set; ``source_pvc`` names the volume to replicate."""

    source_pvc: Optional[str] = None
    trigger: Optional[ReplicationTrigger] = None
    rsync: Optional[ReplicationSourceRsyncSpec] = None
    rclone: Optional[ReplicationSourceRcloneSpec] = None
    restic: Optional[ReplicationSourceResticSpec] = None
    syncthing: Optional[ReplicationSourceSyncthingSpec] = None
    external: Optional[ReplicationSourceExternalSpec] = None
    paused: bool = False


# ---------------------------------------------------------------------------
# Status types (source side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReplicationSourceRsyncStatus:
    """Published connection info (replicationsource_types.go:231-243)."""

    address: Optional[str] = None
    ssh_keys: Optional[str] = None
    port: Optional[int] = None


@dataclasses.dataclass
class ReplicationSourceResticStatus:
    last_pruned: Optional[datetime] = None


@dataclasses.dataclass
class ReplicationSourceSyncthingStatus:
    id: Optional[str] = None
    address: Optional[str] = None
    peers: List[SyncthingPeerStatus] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ReplicationSourceStatus:
    """replicationsource_types.go:256-290."""

    last_sync_time: Optional[datetime] = None
    last_sync_start_time: Optional[datetime] = None
    last_sync_duration: Optional[timedelta] = None
    next_sync_time: Optional[datetime] = None
    last_manual_sync: Optional[str] = None
    conditions: List[Condition] = dataclasses.field(default_factory=list)
    rsync: Optional[ReplicationSourceRsyncStatus] = None
    restic: Optional[ReplicationSourceResticStatus] = None
    syncthing: Optional[ReplicationSourceSyncthingStatus] = None
    external: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ReplicationSource:
    metadata: ObjectMeta
    spec: ReplicationSourceSpec = dataclasses.field(
        default_factory=ReplicationSourceSpec
    )
    status: Optional[ReplicationSourceStatus] = None
    kind: str = "ReplicationSource"

    def ensure_status(self) -> ReplicationSourceStatus:
        if self.status is None:
            self.status = ReplicationSourceStatus()
        return self.status


# ---------------------------------------------------------------------------
# Destination side
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReplicationDestinationRsyncSpec(ReplicationDestinationVolumeOptions):
    """replicationdestination_types.go:88-117: receive a delta-synced
    volume; exposes a listening service whose address lands in status."""

    ssh_keys: Optional[str] = None
    service_type: Optional[str] = None
    address: Optional[str] = None
    port: Optional[int] = None
    path: Optional[str] = None
    ssh_user: Optional[str] = None


@dataclasses.dataclass
class ReplicationDestinationRcloneSpec(ReplicationDestinationVolumeOptions):
    rclone_config_section: Optional[str] = None
    rclone_dest_path: Optional[str] = None
    rclone_config: Optional[str] = None


@dataclasses.dataclass
class ReplicationDestinationResticSpec(ReplicationDestinationVolumeOptions):
    """Restore from a dedup repository; ``previous`` / ``restore_as_of``
    select the snapshot (replicationdestination_types.go:194-200)."""

    repository: Optional[str] = None
    cache_capacity: Optional[int] = None
    cache_storage_class_name: Optional[str] = None
    cache_access_modes: List[str] = dataclasses.field(default_factory=list)
    previous: Optional[int] = None
    restore_as_of: Optional[datetime] = None


@dataclasses.dataclass
class ReplicationDestinationExternalSpec:
    provisioner: str = ""
    parameters: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ReplicationDestinationSpec:
    trigger: Optional[ReplicationTrigger] = None
    rsync: Optional[ReplicationDestinationRsyncSpec] = None
    rclone: Optional[ReplicationDestinationRcloneSpec] = None
    restic: Optional[ReplicationDestinationResticSpec] = None
    external: Optional[ReplicationDestinationExternalSpec] = None
    paused: bool = False


@dataclasses.dataclass
class ReplicationDestinationRsyncStatus:
    address: Optional[str] = None
    ssh_keys: Optional[str] = None
    port: Optional[int] = None


@dataclasses.dataclass
class ReplicationDestinationStatus:
    """replicationdestination_types.go:202-240; ``latest_image`` points at
    the most recent PiT replica (volume or snapshot)."""

    last_sync_time: Optional[datetime] = None
    last_sync_start_time: Optional[datetime] = None
    last_sync_duration: Optional[timedelta] = None
    next_sync_time: Optional[datetime] = None
    last_manual_sync: Optional[str] = None
    latest_image: Optional[TypedLocalObjectReference] = None
    conditions: List[Condition] = dataclasses.field(default_factory=list)
    rsync: Optional[ReplicationDestinationRsyncStatus] = None
    external: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ReplicationDestination:
    metadata: ObjectMeta
    spec: ReplicationDestinationSpec = dataclasses.field(
        default_factory=ReplicationDestinationSpec
    )
    status: Optional[ReplicationDestinationStatus] = None
    kind: str = "ReplicationDestination"

    def ensure_status(self) -> ReplicationDestinationStatus:
        if self.status is None:
            self.status = ReplicationDestinationStatus()
        return self.status
