"""In-process API server: typed CRUD + labels + owner refs + watch.

Plays the role controller-runtime's client + envtest kube-apiserver play in
the reference (SURVEY.md §4 tier 2): controllers and movers do all their
work through this store. With a ``StorageProvider`` attached it also acts
as the dynamic provisioner/CSI driver (volumes bind and snapshots become
ready on create); without one, objects stay Pending and tests drive status
by hand exactly like the reference's envtest suites flip
``job.Status.Succeeded``.

Ports ``volsync_tpu/cluster/cluster.py`` whole.
"""

from __future__ import annotations

import copy
import threading
from datetime import datetime, timezone
from typing import Callable, Iterable, Optional

from volsync_tpu_torch.api.common import ObjectMeta, OwnerReference
from volsync_tpu_torch.cluster.objects import Event, Job


class NotFound(KeyError):
    pass


class Conflict(RuntimeError):
    """Resource-version conflict or immutable-field violation."""


class Cluster:
    def __init__(self, storage=None):
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._stores: dict[str, dict[tuple, object]] = {}
        self._rv = 0
        self.storage = storage
        # Immutable Job spec fields: changing them requires delete+recreate,
        # mirroring k8s Job template immutability
        # (utils/reconcile.go:51-68 handles this in the reference).
        self._immutable = {"Job": ("entrypoint", "volumes", "secrets")}

    # -- core CRUD ---------------------------------------------------------

    def _store(self, kind: str) -> dict:
        return self._stores.setdefault(kind, {})

    def _bump(self):
        self._rv += 1
        self._cond.notify_all()
        return self._rv

    @property
    def generation(self) -> int:
        return self._rv

    def _after_write(self, obj):
        """Run storage hooks outside the lock (tree copies can be large —
        holding the global lock for them would stall all CRUD), then wake
        watchers of any status the hook changed."""
        if self.storage is not None:
            self.storage.on_change(self, obj)
            with self._lock:
                self._bump()

    def create(self, obj):
        with self._lock:
            store = self._store(obj.kind)
            key = obj.metadata.key
            if key in store:
                raise Conflict(f"{obj.kind} {key} already exists")
            obj.metadata.resource_version = self._bump()
            obj.metadata.generation = 1
            obj.metadata.creation_timestamp = datetime.now(timezone.utc)
            store[key] = obj
        self._after_write(obj)
        return obj

    def get(self, kind: str, namespace: str, name: str):
        with self._lock:
            try:
                return self._store(kind)[(namespace, name)]
            except KeyError:
                raise NotFound(f"{kind} {namespace}/{name}") from None

    def try_get(self, kind: str, namespace: str, name: str):
        try:
            return self.get(kind, namespace, name)
        except NotFound:
            return None

    def update(self, obj, *, expect_version: Optional[int] = None):
        with self._lock:
            store = self._store(obj.kind)
            key = obj.metadata.key
            if key not in store:
                raise NotFound(f"{obj.kind} {key}")
            current = store[key]
            if expect_version is not None and (
                current.metadata.resource_version != expect_version
            ):
                raise Conflict(f"{obj.kind} {key}: stale resourceVersion")
            for field in self._immutable.get(obj.kind, ()):
                if getattr(current.spec, field) != getattr(obj.spec, field):
                    raise Conflict(
                        f"{obj.kind} {key}: field spec.{field} is immutable"
                    )
            obj.metadata.resource_version = self._bump()
            # Spec writes advance the generation; status-subresource writes
            # (update_status) do not — watchers that only care about spec
            # changes key off generation, like metadata.generation in k8s.
            obj.metadata.generation = current.metadata.generation + 1
            store[key] = obj
        self._after_write(obj)
        return obj

    def delete(self, kind: str, namespace: str, name: str, *,
               expect_version: Optional[int] = None) -> bool:
        with self._lock:
            store = self._store(kind)
            obj = store.get((namespace, name))
            if obj is None:
                return False
            if expect_version is not None and (
                obj.metadata.resource_version != expect_version
            ):
                raise Conflict(f"{kind} {namespace}/{name}: stale delete precondition")
            del store[(namespace, name)]
            self._bump()
        if self.storage is not None:
            self.storage.on_delete(self, obj)
        return True

    def list(self, kind: str, namespace: Optional[str] = None,
             labels: Optional[dict] = None) -> list:
        with self._lock:
            out = []
            for (ns, _), obj in self._store(kind).items():
                if namespace is not None and ns != namespace:
                    continue
                if labels and not _match_labels(obj.metadata.labels, labels):
                    continue
                out.append(obj)
            return out

    def delete_all_of(self, kind: str, namespace: str, labels: dict,
                      keep: Optional[Callable[[object], bool]] = None) -> int:
        """DeleteAllOf with a label selector (utils/cleanup.go:48-76)."""
        with self._lock:
            doomed = [
                o for o in self.list(kind, namespace, labels)
                if keep is None or not keep(o)
            ]
            for o in doomed:
                self.delete(kind, namespace, o.metadata.name)
            return len(doomed)

    # -- helpers -----------------------------------------------------------

    def apply(self, obj, mutate: Optional[Callable[[object], None]] = None):
        """CreateOrUpdate: fetch-or-create by key, apply ``mutate``, write
        back. On an immutable-field conflict, delete + recreate — the
        reference's CreateOrUpdateDeleteOnImmutableErr
        (utils/reconcile.go:51-68)."""
        with self._lock:
            existing = self.try_get(obj.kind, *obj.metadata.key)
            if existing is None:
                if mutate:
                    mutate(obj)
                return self.create(obj)
            # Carry identity forward; apply desired state onto existing.
            obj.metadata.uid = existing.metadata.uid
            obj.metadata.creation_timestamp = existing.metadata.creation_timestamp
            obj.metadata.resource_version = existing.metadata.resource_version
            merged_labels = dict(existing.metadata.labels)
            merged_labels.update(obj.metadata.labels)
            obj.metadata.labels = merged_labels
            if hasattr(existing, "status"):
                obj.status = existing.status
            if not obj.metadata.owner_references:
                obj.metadata.owner_references = existing.metadata.owner_references
            if mutate:
                mutate(obj)
            try:
                return self.update(obj)
            except Conflict:
                import uuid

                self.delete(obj.kind, *obj.metadata.key)
                obj.metadata.uid = str(uuid.uuid4())  # fresh identity
                obj.metadata.resource_version = 0
                return self.create(obj)

    def update_status(self, obj, *, expect_version: Optional[int] = None):
        """Status-subresource style write: merge only status.
        ``expect_version`` makes it a CAS — runners use this to atomically
        claim a Job/Deployment so two nodes never double-start one."""
        with self._lock:
            current = self.get(obj.kind, *obj.metadata.key)
            if expect_version is not None and (
                current.metadata.resource_version != expect_version
            ):
                raise Conflict(
                    f"{obj.kind} {obj.metadata.key}: stale status write")
            current.status = obj.status
            current.metadata.resource_version = self._bump()
        self._after_write(current)
        return current

    def set_owner(self, obj, owner, *, controller: bool = True):
        ref = OwnerReference(
            kind=owner.kind, name=owner.metadata.name, uid=owner.metadata.uid,
            controller=controller,
        )
        refs = [r for r in obj.metadata.owner_references if r.uid != ref.uid]
        refs.append(ref)
        obj.metadata.owner_references = refs
        return obj

    def is_owned_by(self, obj, owner) -> bool:
        return any(r.uid == owner.metadata.uid for r in obj.metadata.owner_references)

    def snapshot_objects(self) -> dict:
        """Deep copy of everything (debug/inspection)."""
        with self._lock:
            return {k: copy.deepcopy(v) for k, v in self._stores.items()}

    # -- events ------------------------------------------------------------

    def record_event(self, involved, etype: str, reason: str, message: str,
                     action: str = ""):
        with self._lock:
            n = len(self._store("Event")) + 1
            ev = Event(
                metadata=ObjectMeta(
                    name=f"{involved.metadata.name}.{n:07d}",
                    namespace=involved.metadata.namespace,
                ),
                involved_kind=involved.kind,
                involved_name=involved.metadata.name,
                type=etype,
                reason=reason,
                action=action,
                message=message,
            )
            self._store("Event")[ev.metadata.key] = ev
            self._bump()
            return ev

    def events_for(self, involved) -> list:
        return [
            e for e in self.list("Event", involved.metadata.namespace)
            if e.involved_name == involved.metadata.name
            and e.involved_kind == involved.kind
        ]

    # -- watch -------------------------------------------------------------

    def wait_for(self, predicate: Callable[[], bool], timeout: float = 10.0,
                 poll: float = 0.0) -> bool:
        """Block until ``predicate()`` holds or timeout. Wakes on every
        store mutation (and optionally on a poll interval for conditions
        driven by outside-the-store progress)."""
        deadline = threading.TIMEOUT_MAX if timeout is None else timeout
        import time

        end = time.monotonic() + deadline
        with self._cond:
            while True:
                if predicate():
                    return True
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, poll) if poll else remaining)


def _match_labels(have: dict, want: dict) -> bool:
    return all(have.get(k) == v for k, v in want.items())
