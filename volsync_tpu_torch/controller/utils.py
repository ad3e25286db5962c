"""Shared controller utilities.

Mirrors controllers/utils/: ownership labels (labels.go), label-based GC
with the do-not-delete escape hatch (cleanup.go), per-CR service accounts
(sahandler.go), secret validation + short-circuit reconcile chains
(utils.go, reconcile.go).

Ports ``volsync_tpu/controller/utils.py`` whole.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from volsync_tpu_torch.api.common import ObjectMeta
from volsync_tpu_torch.cluster.cluster import Cluster
from volsync_tpu_torch.cluster.objects import (
    HOSTNAME_LABEL,
    PolicyRule,
    Role,
    RoleBinding,
    ServiceAccount,
)

# labels.go:20-107
CREATED_BY_LABEL = "app.kubernetes.io/created-by"
CREATED_BY_VALUE = "volsync-tpu"
CLEANUP_LABEL = "volsync.backube/cleanup"
DO_NOT_DELETE_LABEL = "volsync.backube/do-not-delete"
SNAPNAME_ANNOTATION = "volsync.backube/snapname"

# Kinds swept by cleanup, in dependency order (cleanup.go:48-76).
CLEANUP_KINDS = ("Job", "Deployment", "Service", "VolumeSnapshot", "Volume",
                 "Secret", "RoleBinding", "Role", "ServiceAccount")

#: The privilege the per-CR Role grants "use" of — the analogue of the
#: reference's OpenShift SCC named by --scc-name (sahandler.go:32-36,
#: default "volsync-mover"): here it names the runner policy that allows a
#: payload to execute on the shared substrate.
DEFAULT_RUNNER_POLICY = "volsync-mover"


def owned_by_labels(owner) -> dict:
    return {CREATED_BY_LABEL: CREATED_BY_VALUE,
            "volsync.backube/owner-uid": owner.metadata.uid}


def set_owned_by(obj, owner, cluster: Optional[Cluster] = None):
    obj.metadata.labels.update(owned_by_labels(owner))
    if cluster is not None:
        cluster.set_owner(obj, owner)
    return obj


def mark_for_cleanup(obj, owner):
    """cleanup.go:34-37: stamp the cleanup label with the owner's uid."""
    obj.metadata.labels[CLEANUP_LABEL] = owner.metadata.uid
    return obj


def mark_old_snapshot_for_cleanup(cluster: Cluster, owner,
                                  current_name: Optional[str]):
    """cleanup.go:220-269: when a new latestImage snapshot appears, stamp
    the previous one so the next cleanup pass collects it."""
    for snap in cluster.list("VolumeSnapshot", owner.metadata.namespace,
                             labels=owned_by_labels(owner)):
        if current_name is not None and snap.metadata.name == current_name:
            continue
        mark_for_cleanup(snap, owner)
        cluster.update(snap)


def relinquish(cluster: Cluster, obj):
    """Strip VolSync ownership instead of deleting (cleanup.go:95-117):
    user-protected snapshots survive, unowned."""
    obj.metadata.labels = {
        k: v for k, v in obj.metadata.labels.items()
        if k not in (CLEANUP_LABEL, CREATED_BY_LABEL,
                     "volsync.backube/owner-uid")
    }
    obj.metadata.owner_references = []
    cluster.update(obj)


def relinquish_do_not_delete_snapshots(cluster: Cluster, owner):
    """replicationdestination_controller.go:101 — run every reconcile."""
    for snap in cluster.list("VolumeSnapshot", owner.metadata.namespace):
        if (DO_NOT_DELETE_LABEL in snap.metadata.labels
                and cluster.is_owned_by(snap, owner)):
            relinquish(cluster, snap)


def cleanup_objects(cluster: Cluster, owner,
                    kinds: Iterable[str] = CLEANUP_KINDS) -> int:
    """cleanup.go:48-76: DeleteAllOf per kind selected by the cleanup
    label; do-not-delete snapshots are relinquished, not deleted."""
    ns = owner.metadata.namespace
    sel = {CLEANUP_LABEL: owner.metadata.uid}
    n = 0
    for kind in kinds:
        if kind == "VolumeSnapshot":
            for snap in cluster.list(kind, ns, labels=sel):
                if DO_NOT_DELETE_LABEL in snap.metadata.labels:
                    relinquish(cluster, snap)
                else:
                    cluster.delete(kind, ns, snap.metadata.name)
                    n += 1
        else:
            n += cluster.delete_all_of(kind, ns, sel)
    return n


def ensure_service_account(cluster: Cluster, owner, name: str,
                           runner_policy: Optional[str] = None,
                           ) -> ServiceAccount:
    """Per-CR mover identity: ServiceAccount + Role granting ``use`` of
    the runner policy + RoleBinding tying them together — the full
    sahandler.go:38-153 triple (SA, Role with use-SCC rule :47-55,
    RoleBinding :56-62), with the SCC name replaced by the runner-policy
    name. The default resolves at CALL time, preferring the cluster
    handle's ``runner_policy`` (set from the operator's --scc-name flag,
    per cluster so co-resident operator runtimes don't clobber each
    other) over the module default."""
    if runner_policy is None:
        runner_policy = getattr(cluster, "runner_policy", None) \
            or DEFAULT_RUNNER_POLICY
    ns = owner.metadata.namespace
    sa = ServiceAccount(metadata=ObjectMeta(name=name, namespace=ns))
    set_owned_by(sa, owner, cluster)
    mark_for_cleanup(sa, owner)
    sa = cluster.apply(sa)

    role = Role(
        metadata=ObjectMeta(name=name, namespace=ns),
        rules=[PolicyRule(api_groups=["policy.volsync.backube"],
                          resources=["runnerpolicies"],
                          resource_names=[runner_policy],
                          verbs=["use"])],
    )
    set_owned_by(role, owner, cluster)
    mark_for_cleanup(role, owner)
    cluster.apply(role)

    binding = RoleBinding(
        metadata=ObjectMeta(name=name, namespace=ns),
        role_name=name,
        subjects=[("ServiceAccount", name)],
    )
    set_owned_by(binding, owner, cluster)
    mark_for_cleanup(binding, owner)
    cluster.apply(binding)
    return sa


def affinity_from_volume(cluster: Cluster, namespace: str,
                         volume_name: str) -> dict:
    """Node pinning for movers that mount a live, single-attach volume
    (utils/affinity.go:35-83 + docs/design/rwo-affinity.rst): if the
    volume is RWO/RWOP and a running non-VolSync workload already mounts
    it, the mover must land on that workload's node or its mount would
    fail. Returns a node_selector ({} = unconstrained).

    With Clone/Snapshot copy methods the mover mounts a fresh PiT copy
    that nothing else uses, so no workload is found and no pinning
    happens — Direct is the case this exists for, exactly like the
    reference.
    """
    vol = cluster.try_get("Volume", namespace, volume_name)
    if vol is None:
        return {}
    modes = set(vol.spec.access_modes or [])
    if modes and not (modes & {"ReadWriteOnce", "ReadWriteOncePod"}):
        return {}  # shared-attach volumes need no pinning
    for kind, running in (("Job", lambda s: s.active > 0),
                          ("Deployment", lambda s: s.ready_replicas > 0)):
        for obj in cluster.list(kind, namespace):
            if obj.metadata.labels.get(CREATED_BY_LABEL) == CREATED_BY_VALUE:
                continue  # ignore our own movers (podsUsingPVC :86-104)
            if volume_name not in obj.spec.volumes.values():
                continue
            if running(obj.status) and obj.status.node:
                return {HOSTNAME_LABEL: obj.status.node}
    return {}


def get_and_validate_secret(cluster: Cluster, namespace: str, name: str,
                            fields: Iterable[str]):
    """utils.go:36-60."""
    secret = cluster.try_get("Secret", namespace, name)
    if secret is None:
        raise ValueError(f"secret {namespace}/{name} not found")
    missing = [f for f in fields if f not in secret.data]
    if missing:
        raise ValueError(
            f"secret {namespace}/{name} missing fields: {missing}"
        )
    return secret


def env_from_secret(secret, keys: Iterable[str],
                    optional: bool = False) -> dict:
    """utils.go:62-75: 1-for-1 secret-key -> env mapping."""
    out = {}
    for k in keys:
        if k in secret.data:
            v = secret.data[k]
            out[k] = v.decode() if isinstance(v, bytes) else str(v)
        elif not optional:
            raise KeyError(f"secret {secret.metadata.key} missing {k}")
    return out


def get_service_address(service) -> Optional[str]:
    """utils.go:86-100: LB hostname > LB IP > cluster IP."""
    s = service.status
    return s.load_balancer_hostname or s.load_balancer_ip or s.cluster_ip


def reconcile_batch(*steps: Callable[[], bool]) -> bool:
    """reconcile.go:38-45: run steps in order, stop at the first that
    reports not-done; True iff all completed."""
    for step in steps:
        if not step():
            return False
    return True
