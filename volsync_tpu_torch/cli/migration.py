"""``volsync migration`` — push a local directory into a cluster volume.

Mirrors kubectl-volsync's migration command set (cmd/migration*.go):
``create`` stands up an rsync ReplicationDestination (optionally
provisioning the destination volume), ``rsync`` runs a LOCAL push from
the operator's workstation directory against the in-cluster destination
using the keys pulled from the destination's Secret
(migration_rsync.go:81-149 runs a local rsync subprocess the same way —
here the push is the framework's own delta client), ``delete`` tears it
all down by relationship label.

Ports ``volsync_tpu/cli/migration.py``. ``rsync`` pushes from the
calling process through the port's ``movers/devicetransport`` and
``movers/rsync/entry._push_tree``, on ``device`` (CUDA unless the
caller asks for another; it raises without CUDA before it connects).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from volsync_tpu_torch.api.common import CopyMethod, ObjectMeta
from volsync_tpu_torch.api.types import (
    ReplicationDestination,
    ReplicationDestinationRsyncSpec,
    ReplicationDestinationSpec,
)
from volsync_tpu_torch.cli.relationship import (
    TYPE_MIGRATION,
    ContextCLI,
    Relationship,
    RelationshipError,
)


class MigrationCLI(ContextCLI):

    def create(self, name: str, *, cluster: str, namespace: str,
               pvc_name: str, capacity: Optional[int] = None,
               access_modes: Optional[list] = None,
               timeout: float = 60.0) -> dict:
        """RD with Direct copy into the (possibly new) destination volume
        — a migration wants the bytes in the PVC itself, not a snapshot
        chain (migration_create.go).

        The relationship file persists only after the cluster side is
        ready: a failed create leaves nothing on disk, so it can simply
        be re-run (cluster objects are cleaned up on failure)."""
        rel = Relationship(self.config_dir, name, TYPE_MIGRATION)
        if rel.path.exists():
            raise RelationshipError(f"relationship {name!r} already exists")
        cl = self._cluster(cluster)
        rd = ReplicationDestination(
            metadata=ObjectMeta(name=f"volsync-mig-{name}",
                                namespace=namespace, labels=rel.label()),
            spec=ReplicationDestinationSpec(
                trigger=None,
                rsync=ReplicationDestinationRsyncSpec(
                    copy_method=CopyMethod.DIRECT,
                    destination_pvc=pvc_name if capacity is None else None,
                    capacity=capacity,
                    access_modes=list(access_modes or []),
                ),
            ),
        )
        if capacity is not None:
            # Provision a fresh destination volume of the requested size.
            from volsync_tpu_torch.cluster.objects import Volume, VolumeSpec

            vol = Volume(metadata=ObjectMeta(name=pvc_name,
                                             namespace=namespace,
                                             labels=rel.label()),
                         spec=VolumeSpec(capacity=capacity,
                                         access_modes=list(access_modes
                                                           or [])))
            cl.apply(vol)
            rd.spec.rsync.destination_pvc = pvc_name
        cl.apply(rd)
        ok = cl.wait_for(
            lambda: self._rd_ready(cl, namespace, f"volsync-mig-{name}"),
            timeout=timeout, poll=0.1)
        if not ok:
            # Roll back the labeled objects so a retry starts clean.
            for kind in ("ReplicationDestination", "Volume"):
                for obj in cl.list(kind, namespace, labels=rel.label()):
                    cl.delete(kind, namespace, obj.metadata.name)
            raise RelationshipError(
                "migration destination did not publish address/keys")
        fresh = cl.get("ReplicationDestination", namespace,
                       f"volsync-mig-{name}")
        rel.data["destination"] = {
            "cluster": cluster, "namespace": namespace,
            "name": f"volsync-mig-{name}", "pvc_name": pvc_name,
            "address": fresh.status.rsync.address,
            "port": fresh.status.rsync.port,
            "keys_secret": fresh.status.rsync.ssh_keys,
        }
        rel.save()
        self.out(f"migration destination ready at "
                 f"{fresh.status.rsync.address}:{fresh.status.rsync.port}")
        return rel.data["destination"]

    def rsync(self, name: str, source_dir) -> dict:
        """LOCAL push: pull the connection key from the destination's
        Secret and delta-push ``source_dir`` from THIS process — the
        workstation-side transfer of migration_rsync.go:81-117."""
        from volsync_tpu_torch import resolve_device
        from volsync_tpu_torch.movers import devicetransport as dt
        from volsync_tpu_torch.movers.rsync.entry import _push_tree

        dev = resolve_device(self.device)
        rel = Relationship.load(self.config_dir, name, TYPE_MIGRATION)
        dest = rel.data.get("destination")
        if not dest:
            raise RelationshipError("run migration create first")
        cl = self._cluster(dest["cluster"])
        secret = cl.get("Secret", dest["namespace"], dest["keys_secret"])
        ch = dt.connect_device(dest["address"], dest["port"],
                               secret.data["source"],
                               secret.data["destination-id"].decode())
        try:
            stats = _push_tree(ch, Path(source_dir), device=dev)
            ch.send({"verb": "shutdown", "rc": 0})
            ch.recv()
        finally:
            ch.close()
        self.out(f"migration push complete: {stats}")
        return stats

    def delete(self, name: str) -> None:
        rel = Relationship.load(self.config_dir, name, TYPE_MIGRATION)
        dest = rel.data.get("destination")
        if dest:
            cl = self._cluster(dest["cluster"])
            for kind in ("ReplicationDestination", "Secret"):
                for obj in cl.list(kind, dest["namespace"],
                                   labels=rel.label()):
                    cl.delete(kind, dest["namespace"], obj.metadata.name)
        rel.delete_file()
        self.out(f"migration relationship {name} deleted")
