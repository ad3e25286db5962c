"""Directory-backed storage provider: the CSI-driver analogue.

Volumes are directories under a root; snapshots are hardlink trees (O(n)
in file count, O(1) in bytes — a real PiT image as long as writers replace
rather than mutate in place, which all movers in this framework do);
clones are hardlink trees too. Capacity accounting is advisory.

Reference behavior being mirrored: dynamic provisioning binds PVCs;
VolumeSnapshot gets ``boundVolumeSnapshotContentName`` + ``readyToUse``
and a ``restoreSize`` (volumehandler.go:474-492 uses restoreSize in the
capacity fallback chain); volumes created *from* a snapshot or another
volume (dataSource) materialize the PiT image.

Ports ``volsync_tpu/cluster/storage.py`` whole.
"""

from __future__ import annotations

import os
import shutil
from datetime import datetime, timezone
from pathlib import Path


def _hardlink_tree(src: Path, dst: Path):
    """Copy a tree with hardlinks (fall back to copy across devices)."""

    def link(s, d):
        try:
            os.link(s, d)
        except OSError:
            shutil.copy2(s, d)

    if src.exists():
        shutil.copytree(src, dst, copy_function=link, symlinks=True,
                        dirs_exist_ok=True)
    else:
        dst.mkdir(parents=True, exist_ok=True)


def _tree_size(root: Path) -> int:
    total = 0
    for dirpath, _, files in os.walk(root):
        for f in files:
            try:
                total += os.lstat(os.path.join(dirpath, f)).st_size
            except OSError:
                pass
    return total


class StorageProvider:
    def __init__(self, root):
        self.root = Path(root)
        (self.root / "volumes").mkdir(parents=True, exist_ok=True)
        (self.root / "snapshots").mkdir(parents=True, exist_ok=True)

    def volume_path(self, obj) -> Path:
        return self.root / "volumes" / obj.metadata.namespace / obj.metadata.name

    def snapshot_path(self, obj) -> Path:
        return self.root / "snapshots" / obj.metadata.namespace / obj.metadata.name

    # Cluster hooks ---------------------------------------------------------

    def on_change(self, cluster, obj):
        """Provision/snapshot the changed object, then chase dependents to
        a fixpoint: a snapshot becoming ready binds volumes restored from
        it; a volume binding enables snapshots of it and clones from it.
        (The CSI analogue of late binding — the reference's volumehandler
        waits on exactly these transitions, volumehandler.go:474-492.)"""
        if obj.kind not in ("Volume", "VolumeSnapshot"):
            return
        ns = obj.metadata.namespace
        progress = True
        while progress:
            progress = False
            for snap in cluster.list("VolumeSnapshot", ns):
                if not snap.status.ready_to_use:
                    self._take_snapshot(cluster, snap)
                    progress = progress or snap.status.ready_to_use
            for vol in cluster.list("Volume", ns):
                if vol.status.phase != "Bound":
                    self._provision_volume(cluster, vol)
                    progress = progress or vol.status.phase == "Bound"

    def on_delete(self, cluster, obj):
        if obj.kind == "Volume":
            shutil.rmtree(self.volume_path(obj), ignore_errors=True)
        elif obj.kind == "VolumeSnapshot":
            shutil.rmtree(self.snapshot_path(obj), ignore_errors=True)

    # Implementation --------------------------------------------------------

    def _provision_volume(self, cluster, vol):
        path = self.volume_path(vol)
        path.mkdir(parents=True, exist_ok=True)
        src = vol.spec.data_source
        if src:
            if src.get("kind") == "VolumeSnapshot":
                snap = cluster.get("VolumeSnapshot", vol.metadata.namespace,
                                   src["name"])
                if not snap.status.ready_to_use:
                    return  # stays Pending; binds when snapshot is ready
                _hardlink_tree(Path(snap.status.bound_content), path)
            elif src.get("kind") == "Volume":
                origin = cluster.get("Volume", vol.metadata.namespace, src["name"])
                if origin.status.phase != "Bound":
                    return
                _hardlink_tree(Path(origin.status.path), path)
        vol.status.phase = "Bound"
        vol.status.path = str(path)
        vol.status.capacity = vol.spec.capacity or _tree_size(path)

    def _take_snapshot(self, cluster, snap):
        vol = cluster.try_get("Volume", snap.metadata.namespace,
                              snap.spec.source_volume)
        if vol is None or vol.status.phase != "Bound":
            return  # not ready; controller retries
        content = self.snapshot_path(snap)
        _hardlink_tree(Path(vol.status.path), content)
        snap.status.bound_content = str(content)
        snap.status.ready_to_use = True
        snap.status.restore_size = _tree_size(content)
        snap.status.creation_time = datetime.now(timezone.utc)
