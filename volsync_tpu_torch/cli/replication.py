"""``volsync replication`` — drive an rsync replication pair by CLI.

Mirrors kubectl-volsync's replication command set (cmd/replication*.go;
verbs create/delete/schedule/set-source/set-destination/sync): the CLI
owns a relationship file, creates the ReplicationDestination first (its
status publishes address/port and the generated key Secret), copies the
key Secret into the source cluster (the reference CLI moves Secrets
between kubeconfig contexts the same way), creates the
ReplicationSource pointing at the destination, and drives manual syncs
through the trigger handshake.

Ports ``volsync_tpu/cli/replication.py`` over the port's ``api`` and
``cluster.objects``; the syncs run as the port operator's rsync Jobs,
on the device its runner was given.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Optional

from volsync_tpu_torch.api.common import CopyMethod, ObjectMeta
from volsync_tpu_torch.api.types import (
    ReplicationDestination,
    ReplicationDestinationRsyncSpec,
    ReplicationDestinationSpec,
    ReplicationSource,
    ReplicationSourceRsyncSpec,
    ReplicationSourceSpec,
    ReplicationTrigger,
)
from volsync_tpu_torch.cli.relationship import (
    TYPE_REPLICATION,
    ContextCLI,
    Relationship,
    RelationshipError,
)
from volsync_tpu_torch.cluster.objects import Secret


class ReplicationCLI(ContextCLI):
    """The verb implementations, parameterized over named cluster
    contexts (the kubeconfig-context analogue: tests register two
    in-process Clusters as 'source'/'destination')."""

    # -- verbs ---------------------------------------------------------------

    def create(self, name: str) -> Relationship:
        rel = Relationship.create(self.config_dir, name, TYPE_REPLICATION)
        self.out(f"created replication relationship {name} (id {rel.id})")
        return rel

    def set_destination(self, name: str, *, cluster: str, namespace: str,
                        dest_name: str,
                        copy_method: CopyMethod = CopyMethod.SNAPSHOT,
                        service_type: Optional[str] = None,
                        capacity: Optional[int] = None,
                        access_modes: Optional[list] = None,
                        timeout: float = 60.0) -> dict:
        """Create the RD and wait for its published address/port/keys
        (replication_setdest; the reference blocks on status.rsync too)."""
        rel = Relationship.load(self.config_dir, name, TYPE_REPLICATION)
        cl = self._cluster(cluster)
        rd = ReplicationDestination(
            metadata=ObjectMeta(name=dest_name, namespace=namespace,
                                labels=rel.label()),
            spec=ReplicationDestinationSpec(
                trigger=None,
                rsync=ReplicationDestinationRsyncSpec(
                    copy_method=copy_method, service_type=service_type,
                    capacity=capacity,
                    access_modes=list(access_modes or []),
                ),
            ),
        )
        cl.apply(rd)
        ok = cl.wait_for(lambda: self._rd_ready(cl, namespace, dest_name),
                         timeout=timeout, poll=0.1)
        if not ok:
            raise RelationshipError(
                "destination did not publish address/keys in time")
        fresh = cl.get("ReplicationDestination", namespace, dest_name)
        rel.data["destination"] = {
            "cluster": cluster, "namespace": namespace, "name": dest_name,
            "address": fresh.status.rsync.address,
            "port": fresh.status.rsync.port,
            "keys_secret": fresh.status.rsync.ssh_keys,
        }
        rel.save()
        self.out(f"destination ready at "
                 f"{fresh.status.rsync.address}:{fresh.status.rsync.port}")
        return rel.data["destination"]

    def set_source(self, name: str, *, cluster: str, namespace: str,
                   pvc_name: str,
                   copy_method: CopyMethod = CopyMethod.SNAPSHOT) -> None:
        """Create the RS against the stored destination, copying the key
        Secret across clusters first (the reference CLI propagates the
        SSH Secret between contexts — migration_rsync.go:131-149 pulls it
        the same way)."""
        rel = Relationship.load(self.config_dir, name, TYPE_REPLICATION)
        dest = rel.data.get("destination")
        if not dest:
            raise RelationshipError(
                "run set-destination before set-source (the source needs "
                "the destination's address and keys)")
        dst_cl = self._cluster(dest["cluster"])
        src_cl = self._cluster(cluster)
        key_secret = dst_cl.get("Secret", dest["namespace"],
                                dest["keys_secret"])
        copied_name = f"volsync-{name}-keys"
        copy = Secret(metadata=ObjectMeta(name=copied_name,
                                          namespace=namespace,
                                          labels=rel.label()),
                      data=dict(key_secret.data))
        src_cl.apply(copy)
        rs = ReplicationSource(
            metadata=ObjectMeta(name=f"volsync-{name}", namespace=namespace,
                                labels=rel.label()),
            spec=ReplicationSourceSpec(
                source_pvc=pvc_name,
                trigger=None,
                rsync=ReplicationSourceRsyncSpec(
                    copy_method=copy_method,
                    address=dest["address"], port=dest["port"],
                    ssh_keys=copied_name,
                ),
            ),
        )
        src_cl.apply(rs)
        rel.data["source"] = {"cluster": cluster, "namespace": namespace,
                              "name": f"volsync-{name}",
                              "pvc_name": pvc_name}
        rel.save()
        self.out(f"source {namespace}/{pvc_name} wired to "
                 f"{dest['address']}:{dest['port']}")

    def schedule(self, name: str, cronspec: str) -> None:
        """Set a cron trigger on the source (replication_schedule.go)."""
        rel = Relationship.load(self.config_dir, name, TYPE_REPLICATION)
        src = rel.data.get("source")
        if not src:
            raise RelationshipError("no source configured")
        cl = self._cluster(src["cluster"])
        rs = cl.get("ReplicationSource", src["namespace"], src["name"])
        rs.spec.trigger = ReplicationTrigger(schedule=cronspec)
        cl.update(rs)
        rel.data["schedule"] = cronspec
        rel.save()
        self.out(f"replication scheduled: {cronspec}")

    def sync(self, name: str, *, timeout: float = 120.0) -> None:
        """One manual sync via the trigger handshake
        (replication_sync.go: set trigger.manual, wait for
        status.lastManualSync to match)."""
        rel = Relationship.load(self.config_dir, name, TYPE_REPLICATION)
        src = rel.data.get("source")
        if not src:
            raise RelationshipError("no source configured")
        cl = self._cluster(src["cluster"])
        rs = cl.get("ReplicationSource", src["namespace"], src["name"])
        tag = datetime.now(timezone.utc).strftime("%Y%m%d%H%M%S.%f")
        rs.spec.trigger = ReplicationTrigger(manual=tag)
        cl.update(rs)
        ok = cl.wait_for(
            lambda: (
                (cr := cl.try_get("ReplicationSource", src["namespace"],
                                  src["name"])) is not None
                and cr.status is not None
                and cr.status.last_manual_sync == tag),
            timeout=timeout, poll=0.1)
        if not ok:
            raise RelationshipError("manual sync did not complete in time")
        self.out("sync complete")

    def delete(self, name: str) -> None:
        """Delete every object labeled with the relationship id in both
        clusters, then the relationship file (replication_delete.go)."""
        rel = Relationship.load(self.config_dir, name, TYPE_REPLICATION)
        for half in ("source", "destination"):
            info = rel.data.get(half)
            if not info:
                continue
            cl = self._cluster(info["cluster"])
            for kind in ("ReplicationSource", "ReplicationDestination",
                         "Secret"):
                for obj in cl.list(kind, info["namespace"],
                                   labels=rel.label()):
                    cl.delete(kind, info["namespace"], obj.metadata.name)
        rel.delete_file()
        self.out(f"replication relationship {name} deleted")
