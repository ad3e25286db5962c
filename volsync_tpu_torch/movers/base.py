"""Mover plugin framework: interface, result, builder catalog, events.

Ports ``volsync_tpu/movers/base.py`` whole (it has no dependencies).
Mirrors controllers/mover/{mover,builder,events}.go: a ``Mover`` exposes
idempotent Synchronize/Cleanup; a ``Builder`` constructs one from a CR if
its spec section is present; the global catalog rejects specs selecting
zero or multiple movers (builder.go:87-105).
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta
from typing import Optional, Protocol


@dataclasses.dataclass
class Result:
    """Mover progress report (mover/mover.go:44-102)."""

    completed: bool = False
    image: Optional[object] = None
    retry_after: Optional[timedelta] = None

    @staticmethod
    def in_progress() -> "Result":
        # The reference polls incomplete movers at 1 minute
        # (mover/mover.go:75-82); an in-process cluster can afford a much
        # tighter poll.
        return Result(completed=False, retry_after=timedelta(seconds=1))

    @staticmethod
    def retry(after: timedelta) -> "Result":
        return Result(completed=False, retry_after=after)

    @staticmethod
    def complete() -> "Result":
        return Result(completed=True)

    @staticmethod
    def complete_with_image(image) -> "Result":
        return Result(completed=True, image=image)

__all__ = [
    "Mover", "Builder", "Catalog", "CATALOG", "Result",
    "NoMoverFound", "MultipleMoversFound",
    "PROTO_AUTO", "PROTO_FULL", "PROTO_DELTA", "PROTO_CDC",
    "SYNC_PROTOCOLS", "normalize_protocol",
    "EV_TRANSFER_STARTED", "EV_TRANSFER_FAILED", "EV_TRANSFER_COMPLETED",
    "EV_PVC_CREATED",
    "EV_PVC_NOT_BOUND", "EV_SNAP_CREATED", "EV_SNAP_NOT_BOUND",
    "EV_SVC_ADDRESS_ASSIGNED", "EV_SVC_NO_ADDRESS",
    "ACT_CREATING", "ACT_WAITING",
    "SNAP_BIND_TIMEOUT", "VOLUME_BIND_TIMEOUT", "SERVICE_ADDRESS_TIMEOUT",
]


# Sync-protocol selection vocabulary shared by every mover. "auto"
# delegates the per-file choice to the cost-model planner
# (engine/protoplan.py); the rest pin it. Matches the protocol names in
# protoplan.PROTOCOLS plus the planner-delegating sentinel.
PROTO_AUTO = "auto"
PROTO_FULL = "full"
PROTO_DELTA = "delta"
PROTO_CDC = "cdc"
SYNC_PROTOCOLS = (PROTO_AUTO, PROTO_FULL, PROTO_DELTA, PROTO_CDC)


def normalize_protocol(value, default: str = PROTO_AUTO) -> str:
    """Validate a mover's requested sync protocol; unknown or empty
    degrades to ``default`` (the same degrade-don't-raise contract as
    envflags.sync_protocol())."""
    if isinstance(value, str) and value.strip().lower() in SYNC_PROTOCOLS:
        return value.strip().lower()
    return default


class Mover(Protocol):
    """controllers/mover/mover.go:29-41 — both methods are idempotent and
    callable any number of times on the way to completion."""

    @property
    def name(self) -> str: ...
    def synchronize(self) -> Result: ...
    def cleanup(self) -> Result: ...


class Builder(Protocol):
    """controllers/mover/builder.go:47-65."""

    def version_info(self) -> str: ...
    def from_source(self, cluster, source, metrics=None) -> Optional[Mover]: ...
    def from_destination(self, cluster, destination,
                         metrics=None) -> Optional[Mover]: ...


class NoMoverFound(ValueError):
    pass


class MultipleMoversFound(ValueError):
    pass


class Catalog:
    """Global mover registry (builder.go:37-43)."""

    def __init__(self):
        self._builders: dict[str, Builder] = {}

    def register(self, name: str, builder: Builder):
        self._builders[name] = builder
        return builder

    def names(self) -> list[str]:
        return sorted(self._builders)

    def version_infos(self) -> list[str]:
        return [self._builders[n].version_info() for n in self.names()]

    def _get_one(self, cluster, obj, metrics, attr: str) -> Mover:
        found = []
        for name in self.names():
            mover = getattr(self._builders[name], attr)(cluster, obj, metrics)
            if mover is not None:
                found.append(mover)
        if not found:
            raise NoMoverFound(
                f"{obj.kind} {obj.metadata.key}: no mover section in spec"
            )
        if len(found) > 1:
            raise MultipleMoversFound(
                f"{obj.kind} {obj.metadata.key}: multiple mover sections: "
                f"{[m.name for m in found]}"
            )
        return found[0]

    def source_mover(self, cluster, source, metrics=None) -> Mover:
        return self._get_one(cluster, source, metrics, "from_source")

    def destination_mover(self, cluster, destination, metrics=None) -> Mover:
        return self._get_one(cluster, destination, metrics, "from_destination")


CATALOG = Catalog()


# Event vocabulary (controllers/mover/events.go:25-57)
EV_TRANSFER_STARTED = "TransferStarted"
EV_TRANSFER_FAILED = "TransferFailed"
# TPU addition: the reference never observes a transfer's data rate; the
# device pipeline reports one, so completion gets its own event carrying it.
EV_TRANSFER_COMPLETED = "TransferCompleted"
EV_PVC_CREATED = "PersistentVolumeClaimCreated"
EV_PVC_NOT_BOUND = "PersistentVolumeClaimNotBound"
EV_SNAP_CREATED = "VolumeSnapshotCreated"
EV_SNAP_NOT_BOUND = "VolumeSnapshotNotBound"
EV_SVC_ADDRESS_ASSIGNED = "ServiceAddressAssigned"
EV_SVC_NO_ADDRESS = "NoServiceAddressAssigned"
ACT_CREATING = "Creating"
ACT_WAITING = "Waiting"

# Bind timeouts (events.go:50-57), scaled to the in-process substrate where
# provisioning is synchronous; kept as knobs for real-storage backends.
SNAP_BIND_TIMEOUT = 30.0
VOLUME_BIND_TIMEOUT = 120.0
SERVICE_ADDRESS_TIMEOUT = 15.0
