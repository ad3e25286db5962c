"""Control plane: cron triggers, sync state machine, reconcilers, manager.

The port keeps the reference's control-plane *shape* — declarative
specs, a timestamp-derived 3-state machine, a pluggable mover catalog,
label-based GC — as host-side Python (SURVEY.md §7 stance: the operator
logic has no performance needs; the data plane is where the card matters).

Ports ``volsync_tpu/controller/__init__.py``.
"""

from volsync_tpu_torch.controller import cron, statemachine, utils
from volsync_tpu_torch.controller.manager import Manager
from volsync_tpu_torch.controller.reconcilers import (
    ReplicationDestinationReconciler,
    ReplicationSourceReconciler,
)
from volsync_tpu_torch.controller.statemachine import ReconcileResult, Result
from volsync_tpu_torch.controller.volumehandler import VolumeHandler

__all__ = [
    "cron",
    "statemachine",
    "utils",
    "Manager",
    "ReplicationSourceReconciler",
    "ReplicationDestinationReconciler",
    "ReconcileResult",
    "Result",
    "VolumeHandler",
]
