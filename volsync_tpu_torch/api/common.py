"""Shared API types: copy methods, conditions, peers, object metadata.

Mirrors the reference's ``api/v1alpha1/common_types.go`` (CopyMethodType
enum :38-51, Synchronizing condition + reasons :53-60, SyncthingPeer
:64-90) and the slice of ``metav1.ObjectMeta`` the framework uses.

Ports ``volsync_tpu/api/common.py`` whole.
"""

from __future__ import annotations

import dataclasses
import enum
import uuid as uuid_mod
from datetime import datetime, timezone
from typing import List, Optional


class CopyMethod(str, enum.Enum):
    """How point-in-time images are produced (common_types.go:38-51)."""

    DIRECT = "Direct"      # use the volume directly (no PiT guarantee)
    NONE = "None"          # deprecated alias of Direct in the reference
    CLONE = "Clone"        # storage-level clone of the volume
    SNAPSHOT = "Snapshot"  # snapshot, then a volume from the snapshot


# The single condition both CR kinds maintain (common_types.go:53-60).
CONDITION_SYNCHRONIZING = "Synchronizing"
SYNCHRONIZING_REASON_SYNC = "SyncInProgress"
SYNCHRONIZING_REASON_SCHED = "WaitingForSchedule"
SYNCHRONIZING_REASON_MANUAL = "WaitingForManual"
SYNCHRONIZING_REASON_CLEANUP = "CleaningUp"
SYNCHRONIZING_REASON_ERROR = "Error"


class ConditionStatus(str, enum.Enum):
    TRUE = "True"
    FALSE = "False"
    UNKNOWN = "Unknown"


@dataclasses.dataclass
class Condition:
    """k8s-style status condition (apimachinery metav1.Condition shape)."""

    type: str
    status: ConditionStatus
    reason: str
    message: str = ""
    last_transition_time: Optional[datetime] = None


def set_condition(conditions: list, cond: Condition) -> list:
    """Upsert by type; bump lastTransitionTime only when status flips."""
    now = datetime.now(timezone.utc)
    for i, existing in enumerate(conditions):
        if existing.type == cond.type:
            if existing.status != cond.status or cond.last_transition_time:
                cond.last_transition_time = cond.last_transition_time or now
            else:
                cond.last_transition_time = existing.last_transition_time or now
            conditions[i] = cond
            return conditions
    cond.last_transition_time = cond.last_transition_time or now
    conditions.append(cond)
    return conditions


def find_condition(conditions: list, ctype: str) -> Optional[Condition]:
    for c in conditions:
        if c.type == ctype:
            return c
    return None


@dataclasses.dataclass
class SyncthingPeer:
    """A peer device in the live-sync mesh (common_types.go:64-75)."""

    address: str          # e.g. "tcp://host:22000"
    id: str               # device ID (derived from the peer's TLS cert)
    introducer: bool = False


@dataclasses.dataclass
class SyncthingPeerStatus:
    """Connected-peer observation (common_types.go:77-90)."""

    address: str
    id: str
    connected: bool
    device_name: Optional[str] = None
    introduced_by: Optional[str] = None


@dataclasses.dataclass
class ObjectMeta:
    """The subset of object metadata the framework relies on."""

    name: str
    namespace: str = "default"
    uid: str = dataclasses.field(default_factory=lambda: str(uuid_mod.uuid4()))
    labels: dict = dataclasses.field(default_factory=dict)
    annotations: dict = dataclasses.field(default_factory=dict)
    creation_timestamp: Optional[datetime] = None
    deletion_timestamp: Optional[datetime] = None
    owner_references: List["OwnerReference"] = dataclasses.field(
        default_factory=list
    )
    resource_version: int = 0
    generation: int = 0

    @property
    def key(self) -> tuple:
        return (self.namespace, self.name)


@dataclasses.dataclass
class OwnerReference:
    kind: str
    name: str
    uid: str
    controller: bool = False
