"""VolumeHandler: the point-in-time copy engine.

Mirrors controllers/volumehandler/: ``ensure_pvc_from_src`` dispatches on
CopyMethod (Direct/None -> the source volume itself, Clone -> a volume
with dataSource Volume, Snapshot -> VolumeSnapshot then a volume restored
from it — volumehandler.go:64-82); ``ensure_image`` publishes the
destination's replicated PiT image (volume ref or snapshot ref with the
snapshot name tracked via annotation — :88-126,219-291); capacity falls
back vh.capacity -> snapshot restoreSize -> source status -> source spec
(:474-492). Constructed with functional options like new.go:31-132.

Ports ``volsync_tpu/controller/volumehandler.py`` whole.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from volsync_tpu_torch.api.common import CopyMethod, ObjectMeta
from volsync_tpu_torch.api.types import TypedLocalObjectReference
from volsync_tpu_torch.cluster.cluster import Cluster
from volsync_tpu_torch.cluster.objects import (Volume, VolumeSnapshot,
                                              VolumeSnapshotSpec, VolumeSpec)
from volsync_tpu_torch.controller import utils
from volsync_tpu_torch.movers import base as mover_base


@dataclasses.dataclass
class VolumeHandler:
    cluster: Cluster
    owner: object
    copy_method: CopyMethod = CopyMethod.SNAPSHOT
    capacity: Optional[int] = None
    storage_class_name: Optional[str] = None
    access_modes: List[str] = dataclasses.field(default_factory=list)
    volume_snapshot_class_name: Optional[str] = None

    @classmethod
    def from_volume_options(cls, cluster, owner, opts) -> "VolumeHandler":
        return cls(
            cluster=cluster, owner=owner, copy_method=opts.copy_method,
            capacity=opts.capacity,
            storage_class_name=opts.storage_class_name,
            access_modes=list(opts.access_modes),
            volume_snapshot_class_name=opts.volume_snapshot_class_name,
        )

    # -- source side (volumehandler.go:64-82) -------------------------------

    def ensure_pvc_from_src(self, src_name: str, name: str,
                            is_temporary: bool = True) -> Optional[Volume]:
        """PiT copy of ``src_name`` for the mover to read. Returns None
        while the copy is still materializing (controller re-polls)."""
        src = self.cluster.try_get("Volume", self.owner.metadata.namespace,
                                   src_name)
        if src is None or src.status.phase != "Bound":
            return None
        if self.copy_method in (CopyMethod.DIRECT, CopyMethod.NONE):
            return src
        if self.copy_method == CopyMethod.CLONE:
            return self._ensure_clone(src, name, is_temporary)
        if self.copy_method == CopyMethod.SNAPSHOT:
            snap = self._ensure_snapshot(src, f"{name}-snap", is_temporary)
            if snap is None or not snap.status.ready_to_use:
                return None
            return self._ensure_volume_from_snapshot(src, snap, name,
                                                     is_temporary)
        raise ValueError(f"unsupported copyMethod {self.copy_method}")

    # -- destination side (volumehandler.go:88-126) -------------------------

    def ensure_image(self, vol_name: str) -> Optional[TypedLocalObjectReference]:
        """Publish the PiT image of the destination volume as the
        latestImage reference. Snapshot copyMethod produces a fresh
        VolumeSnapshot per sync (named by generation so successive syncs
        produce distinct images); Direct/None points at the volume."""
        if self.copy_method in (CopyMethod.DIRECT, CopyMethod.NONE):
            return TypedLocalObjectReference(kind="Volume", name=vol_name)
        if self.copy_method != CopyMethod.SNAPSHOT:
            raise ValueError(
                f"unsupported destination copyMethod {self.copy_method}"
            )
        vol = self.cluster.try_get("Volume", self.owner.metadata.namespace,
                                   vol_name)
        if vol is None or vol.status.phase != "Bound":
            return None
        # Track the in-flight snapshot name on the owner via annotation
        # (volumehandler.go:44,219-291) so retries reuse it.
        ann = self.owner.metadata.annotations
        snap_name = ann.get(utils.SNAPNAME_ANNOTATION)
        if not snap_name:
            snap_name = f"{self.owner.metadata.name}-{vol.metadata.resource_version:08d}"
            ann[utils.SNAPNAME_ANNOTATION] = snap_name
        snap = self._ensure_snapshot_of(vol, snap_name, is_temporary=False)
        if not snap.status.ready_to_use:
            self.cluster.record_event(
                self.owner, "Warning", mover_base.EV_SNAP_NOT_BOUND,
                f"waiting for snapshot {snap_name}", mover_base.ACT_WAITING,
            )
            return None
        del ann[utils.SNAPNAME_ANNOTATION]
        return TypedLocalObjectReference(kind="VolumeSnapshot", name=snap_name)

    # -- shared (volumehandler.go:144-208) ----------------------------------

    def ensure_new_volume(self, name: str,
                          is_temporary: bool = False) -> Optional[Volume]:
        vol = Volume(
            metadata=ObjectMeta(name=name,
                                namespace=self.owner.metadata.namespace),
            spec=VolumeSpec(
                capacity=self.capacity,
                access_modes=list(self.access_modes),
                storage_class_name=self.storage_class_name,
            ),
        )
        self._claim(vol, is_temporary)
        vol = self._apply_with_event(vol, mover_base.EV_PVC_CREATED)
        if vol.status.phase != "Bound":
            self.cluster.record_event(
                self.owner, "Warning", mover_base.EV_PVC_NOT_BOUND,
                f"waiting for volume {name} to bind", mover_base.ACT_WAITING,
            )
            return None
        return vol

    # -- internals ----------------------------------------------------------

    def _claim(self, obj, is_temporary: bool):
        utils.set_owned_by(obj, self.owner, self.cluster)
        if is_temporary:
            utils.mark_for_cleanup(obj, self.owner)

    def _apply_with_event(self, obj, created_reason: str):
        """apply() + emit the created event only on first creation
        (the reference's recorder fires from ensure* creation sites —
        volumehandler.go:192-205, mover/events.go:25-57)."""
        existed = self.cluster.try_get(
            obj.kind, obj.metadata.namespace, obj.metadata.name) is not None
        out = self.cluster.apply(obj)
        if not existed:
            self.cluster.record_event(
                self.owner, "Normal", created_reason,
                f"{obj.kind.lower()} {obj.metadata.name} created",
                mover_base.ACT_CREATING)
        return out

    def _capacity_for(self, src: Volume,
                      snap: Optional[VolumeSnapshot] = None) -> Optional[int]:
        """volumehandler.go:474-492 fallback chain."""
        if self.capacity is not None:
            return self.capacity
        if snap is not None and snap.status.restore_size:
            return snap.status.restore_size
        return src.status.capacity or src.spec.capacity

    def _ensure_clone(self, src: Volume, name: str,
                      is_temporary: bool) -> Optional[Volume]:
        vol = Volume(
            metadata=ObjectMeta(name=name,
                                namespace=self.owner.metadata.namespace),
            spec=VolumeSpec(
                capacity=self._capacity_for(src),
                access_modes=list(self.access_modes) or list(src.spec.access_modes),
                storage_class_name=self.storage_class_name
                or src.spec.storage_class_name,
                data_source={"kind": "Volume", "name": src.metadata.name},
            ),
        )
        self._claim(vol, is_temporary)
        vol = self._apply_with_event(vol, mover_base.EV_PVC_CREATED)
        return vol if vol.status.phase == "Bound" else None

    def _ensure_snapshot(self, src: Volume, name: str,
                         is_temporary: bool) -> Optional[VolumeSnapshot]:
        return self._ensure_snapshot_of(src, name, is_temporary)

    def _ensure_snapshot_of(self, vol: Volume, name: str,
                            is_temporary: bool) -> VolumeSnapshot:
        snap = VolumeSnapshot(
            metadata=ObjectMeta(name=name,
                                namespace=self.owner.metadata.namespace),
            spec=VolumeSnapshotSpec(
                source_volume=vol.metadata.name,
                volume_snapshot_class_name=self.volume_snapshot_class_name,
            ),
        )
        self._claim(snap, is_temporary)
        return self._apply_with_event(snap, mover_base.EV_SNAP_CREATED)

    def _ensure_volume_from_snapshot(self, src: Volume, snap: VolumeSnapshot,
                                     name: str,
                                     is_temporary: bool) -> Optional[Volume]:
        vol = Volume(
            metadata=ObjectMeta(name=name,
                                namespace=self.owner.metadata.namespace),
            spec=VolumeSpec(
                capacity=self._capacity_for(src, snap),
                access_modes=list(self.access_modes) or list(src.spec.access_modes),
                storage_class_name=self.storage_class_name
                or src.spec.storage_class_name,
                data_source={"kind": "VolumeSnapshot",
                             "name": snap.metadata.name},
            ),
        )
        self._claim(vol, is_temporary)
        vol = self._apply_with_event(vol, mover_base.EV_PVC_CREATED)
        return vol if vol.status.phase == "Bound" else None
