"""Public API types: the declarative replication spec/status surface.

Re-design of the reference's CRD layer (``api/v1alpha1/`` —
SURVEY.md §2 #2-3). The object model keeps the reference's shape —
``ReplicationSource`` / ``ReplicationDestination`` with trigger, per-mover
spec sections, copyMethod volume options, and status with conditions — so a
VolSync user finds every knob they expect, while the data plane behind the
specs is the PyTorch/CUDA engine.

Ports ``volsync_tpu/api/__init__.py`` whole.
"""

from volsync_tpu_torch.api.common import (
    CopyMethod,
    Condition,
    ConditionStatus,
    CONDITION_SYNCHRONIZING,
    SYNCHRONIZING_REASON_SYNC,
    SYNCHRONIZING_REASON_SCHED,
    SYNCHRONIZING_REASON_MANUAL,
    SYNCHRONIZING_REASON_CLEANUP,
    SYNCHRONIZING_REASON_ERROR,
    SyncthingPeer,
    SyncthingPeerStatus,
    ObjectMeta,
)
from volsync_tpu_torch.api.types import (
    ReplicationTrigger,
    ReplicationSourceVolumeOptions,
    ReplicationDestinationVolumeOptions,
    ReplicationSourceRsyncSpec,
    ReplicationSourceRcloneSpec,
    ResticRetainPolicy,
    ReplicationSourceResticSpec,
    ReplicationSourceSyncthingSpec,
    ReplicationSourceExternalSpec,
    ReplicationSourceSpec,
    ReplicationSourceRsyncStatus,
    ReplicationSourceResticStatus,
    ReplicationSourceSyncthingStatus,
    ReplicationSourceStatus,
    ReplicationSource,
    ReplicationDestinationRsyncSpec,
    ReplicationDestinationRcloneSpec,
    ReplicationDestinationResticSpec,
    ReplicationDestinationExternalSpec,
    ReplicationDestinationSpec,
    ReplicationDestinationRsyncStatus,
    ReplicationDestinationStatus,
    ReplicationDestination,
    TypedLocalObjectReference,
)
from volsync_tpu_torch.api.serde import to_dict, from_dict

__all__ = [
    "CopyMethod",
    "Condition",
    "ConditionStatus",
    "CONDITION_SYNCHRONIZING",
    "SYNCHRONIZING_REASON_SYNC",
    "SYNCHRONIZING_REASON_SCHED",
    "SYNCHRONIZING_REASON_MANUAL",
    "SYNCHRONIZING_REASON_CLEANUP",
    "SYNCHRONIZING_REASON_ERROR",
    "SyncthingPeer",
    "SyncthingPeerStatus",
    "ObjectMeta",
    "ReplicationTrigger",
    "ReplicationSourceVolumeOptions",
    "ReplicationDestinationVolumeOptions",
    "ReplicationSourceRsyncSpec",
    "ReplicationSourceRcloneSpec",
    "ResticRetainPolicy",
    "ReplicationSourceResticSpec",
    "ReplicationSourceSyncthingSpec",
    "ReplicationSourceExternalSpec",
    "ReplicationSourceSpec",
    "ReplicationSourceRsyncStatus",
    "ReplicationSourceResticStatus",
    "ReplicationSourceSyncthingStatus",
    "ReplicationSourceStatus",
    "ReplicationSource",
    "ReplicationDestinationRsyncSpec",
    "ReplicationDestinationRcloneSpec",
    "ReplicationDestinationResticSpec",
    "ReplicationDestinationExternalSpec",
    "ReplicationDestinationSpec",
    "ReplicationDestinationRsyncStatus",
    "ReplicationDestinationStatus",
    "ReplicationDestination",
    "TypedLocalObjectReference",
    "to_dict",
    "from_dict",
]
