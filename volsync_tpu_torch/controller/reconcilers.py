"""ReplicationSource / ReplicationDestination reconcilers.

Mirrors controllers/replicationsource_controller.go and
replicationdestination_controller.go: fetch the CR, select exactly one
mover from the catalog, adapt the CR's status fields onto the
``ReplicationMachine`` interface, run the state machine, write status
back. The destination reconciler additionally relinquishes user-protected
snapshots every pass (:101) and swaps ``status.latest_image``, marking the
superseded snapshot for cleanup (:263-278).

Ports ``volsync_tpu/controller/reconcilers.py`` whole.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import Optional

from volsync_tpu_torch.api.common import (
    Condition,
    ConditionStatus,
    set_condition as upsert_condition,
)
from volsync_tpu_torch.cluster.cluster import Cluster
from volsync_tpu_torch.controller import statemachine, utils
from volsync_tpu_torch.controller.statemachine import ReconcileResult, Result
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS, Metrics
from volsync_tpu_torch.movers.base import (CATALOG, Catalog,
                                           MultipleMoversFound, NoMoverFound)


class _MachineBase:
    """Shared ReplicationMachine plumbing over a CR + mover + metrics."""

    role = ""

    def __init__(self, cr, mover, bound_metrics):
        self.cr = cr
        self.status = cr.ensure_status()
        self.mover = mover
        self.metrics = bound_metrics

    # trigger --------------------------------------------------------------
    def _trigger(self):
        return self.cr.spec.trigger

    def cronspec(self) -> Optional[str]:
        t = self._trigger()
        return t.schedule if t else None

    def creation_time(self):
        return self.cr.metadata.creation_timestamp

    def manual_tag(self) -> Optional[str]:
        t = self._trigger()
        return t.manual if t else None

    # status fields --------------------------------------------------------
    def last_manual_sync(self):
        return self.status.last_manual_sync

    def set_last_manual_sync(self, tag):
        self.status.last_manual_sync = tag

    def last_sync_start_time(self):
        return self.status.last_sync_start_time

    def set_last_sync_start_time(self, t):
        self.status.last_sync_start_time = t

    def last_sync_time(self):
        return self.status.last_sync_time

    def set_last_sync_time(self, t):
        self.status.last_sync_time = t

    def last_sync_duration(self):
        return self.status.last_sync_duration

    def set_last_sync_duration(self, d):
        self.status.last_sync_duration = d

    def next_sync_time(self):
        return self.status.next_sync_time

    def set_next_sync_time(self, t):
        self.status.next_sync_time = t

    def set_condition(self, ctype, status, reason, message):
        upsert_condition(
            self.status.conditions,
            Condition(
                type=ctype,
                status=ConditionStatus.TRUE if status else ConditionStatus.FALSE,
                reason=reason, message=message,
            ),
        )

    # metrics --------------------------------------------------------------
    def set_out_of_sync(self, oos: bool):
        self.metrics.out_of_sync.set(1 if oos else 0)

    def increment_missed_intervals(self):
        self.metrics.missed_intervals.inc()

    def observe_sync_duration(self, seconds: float):
        self.metrics.sync_durations.observe(seconds)

    # mover ----------------------------------------------------------------
    def synchronize(self) -> Result:
        return self.mover.synchronize()

    def cleanup(self) -> Result:
        return self.mover.cleanup()


class RSMachine(_MachineBase):
    role = "source"


class RDMachine(_MachineBase):
    """rdMachine.Synchronize swaps latestImage and GCs the previous
    snapshot (replicationdestination_controller.go:263-278)."""

    role = "destination"

    def __init__(self, cr, mover, bound_metrics, cluster: Cluster):
        super().__init__(cr, mover, bound_metrics)
        self.cluster = cluster

    def synchronize(self) -> Result:
        result = self.mover.synchronize()
        if result.completed and result.image is not None:
            self.status.latest_image = result.image
            current = (result.image.name
                       if result.image.kind == "VolumeSnapshot" else None)
            utils.mark_old_snapshot_for_cleanup(self.cluster, self.cr, current)
        return result


class _ReconcilerBase:
    kind = ""

    def __init__(self, cluster: Cluster, catalog: Catalog = CATALOG,
                 metrics: Metrics = GLOBAL_METRICS):
        self.cluster = cluster
        self.catalog = catalog
        self.metrics = metrics

    def _build_machine(self, cr):
        raise NotImplementedError

    def reconcile(self, namespace: str, name: str,
                  now: Optional[datetime] = None) -> ReconcileResult:
        cr = self.cluster.try_get(self.kind, namespace, name)
        if cr is None:
            return ReconcileResult()  # deleted; GC is ownership-driven
        try:
            machine = self._build_machine(cr)
        except NoMoverFound as e:
            # spec.external means an out-of-tree provisioner owns the data
            # motion: no internal mover is an expected, healthy state and
            # VolSync must leave the CR alone entirely
            # (replicationsource_controller.go:103-106).
            if getattr(cr.spec, "external", None) is not None:
                return ReconcileResult()
            return self._park_with_error(cr, e)
        except MultipleMoversFound as e:
            return self._park_with_error(cr, e)
        if getattr(cr.spec, "external", None) is not None:
            # Both an internal mover section and spec.external is a config
            # conflict (replicationsource_controller.go:107-117).
            return self._park_with_error(cr, ValueError(
                "spec defines both an internal mover and spec.external"))
        try:
            result = statemachine.run(machine, now)
        finally:
            self.cluster.update_status(cr)
        return result

    def _park_with_error(self, cr, e) -> ReconcileResult:
        """Permanent spec problem (zero or 2+ mover sections, internal +
        external conflict): surface it on the CR and park — retrying
        cannot fix a config error (the reference rejects these the same
        way, replicationsource_controller.go:104-119)."""
        cr.ensure_status()
        upsert_condition(
            cr.status.conditions,
            Condition(type=statemachine.COND_SYNCHRONIZING,
                      status=ConditionStatus.FALSE,
                      reason=statemachine.REASON_ERROR,
                      message=str(e)),
        )
        self.cluster.update_status(cr)
        return ReconcileResult()

    def _bound_metrics(self, cr, mover):
        return self.metrics.for_object(
            cr.metadata.name, cr.metadata.namespace, self._role(),
            mover.name,
        )

    def _role(self):
        raise NotImplementedError


class ReplicationSourceReconciler(_ReconcilerBase):
    kind = "ReplicationSource"

    def _role(self):
        return "source"

    def _build_machine(self, cr):
        mover = self.catalog.source_mover(self.cluster, cr)
        bm = self._bound_metrics(cr, mover)
        mover.metrics = bm  # movers feed the throughput gauge on completion
        return RSMachine(cr, mover, bm)


class ReplicationDestinationReconciler(_ReconcilerBase):
    kind = "ReplicationDestination"

    def _role(self):
        return "destination"

    def _build_machine(self, cr):
        utils.relinquish_do_not_delete_snapshots(self.cluster, cr)
        mover = self.catalog.destination_mover(self.cluster, cr)
        bm = self._bound_metrics(cr, mover)
        mover.metrics = bm
        return RDMachine(cr, mover, bm, self.cluster)
