"""The 3-state synchronization state machine.

Faithful re-expression of controllers/statemachine/machine.go: state is
derived **purely from status timestamps** (machine.go:160-172) so any
crash/restart resumes mid-iteration exactly:

    last_sync_start_time set            -> SYNCHRONIZING
    both start & last_sync_time unset   -> INITIAL
    otherwise                           -> CLEANING_UP   (doubles as idle)

Triggers (machine.go:40-46, 83-92): ``schedule`` (cron), ``manual`` (sync
once per new tag, acked into status.last_manual_sync), or none (continuous
re-sync). Deadline misses — a sync still running when the *following* cron
tick passes — feed the missed-interval counter and the out-of-sync gauge
(machine.go:259-278, Run :50-62).

The ``ReplicationMachine`` interface (interface.go:31-57) abstracts the
status fields of both CR kinds so one machine serves source & destination.

Ports ``volsync_tpu/controller/statemachine.py`` whole.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime, timedelta, timezone
from typing import Optional, Protocol

from volsync_tpu_torch.controller import cron
from volsync_tpu_torch.movers.base import Result

# States (machine.go:33-37)
INITIAL = "Initial"
SYNCHRONIZING = "Synchronizing"
CLEANING_UP = "CleaningUp"

# Trigger types (machine.go:40-46)
SCHEDULE_TRIGGER = "schedule"
MANUAL_TRIGGER = "manual"
NO_TRIGGER = "none"

# Synchronizing condition vocabulary (conditions.go:28-76)
COND_SYNCHRONIZING = "Synchronizing"
REASON_SYNC_IN_PROGRESS = "SyncInProgress"
REASON_WAITING_FOR_SCHEDULE = "WaitingForSchedule"
REASON_WAITING_FOR_MANUAL = "WaitingForManual"
REASON_CLEANING_UP = "CleaningUp"
REASON_ERROR = "Error"


@dataclasses.dataclass
class ReconcileResult:
    """What the caller should do next."""

    requeue_after: Optional[timedelta] = None


class ReplicationMachine(Protocol):
    """Status-field abstraction over both CR kinds (interface.go:31-57)."""

    def cronspec(self) -> Optional[str]: ...
    def creation_time(self) -> Optional[datetime]: ...
    def manual_tag(self) -> Optional[str]: ...
    def last_manual_sync(self) -> Optional[str]: ...
    def set_last_manual_sync(self, tag: Optional[str]) -> None: ...
    def last_sync_start_time(self) -> Optional[datetime]: ...
    def set_last_sync_start_time(self, t: Optional[datetime]) -> None: ...
    def last_sync_time(self) -> Optional[datetime]: ...
    def set_last_sync_time(self, t: Optional[datetime]) -> None: ...
    def last_sync_duration(self) -> Optional[timedelta]: ...
    def set_last_sync_duration(self, d: Optional[timedelta]) -> None: ...
    def next_sync_time(self) -> Optional[datetime]: ...
    def set_next_sync_time(self, t: Optional[datetime]) -> None: ...
    def set_condition(self, ctype: str, status: bool, reason: str,
                      message: str) -> None: ...
    def synchronize(self) -> Result: ...
    def cleanup(self) -> Result: ...
    # Metrics hooks (driven here so both reconcilers share them —
    # controllers/metrics.go wiring)
    def set_out_of_sync(self, oos: bool) -> None: ...
    def increment_missed_intervals(self) -> None: ...
    def observe_sync_duration(self, seconds: float) -> None: ...


def trigger_type(m: ReplicationMachine) -> str:
    # Manual wins over schedule when both are set (machine.go getTrigger
    # checks the manual tag first): a user-supplied tag must fire now, not
    # at the next cron slot.
    if m.manual_tag():
        return MANUAL_TRIGGER
    if m.cronspec():
        return SCHEDULE_TRIGGER
    return NO_TRIGGER


def current_state(m: ReplicationMachine) -> str:
    """machine.go:160-172 — the restart-safe timestamp trick."""
    if m.last_sync_start_time():
        return SYNCHRONIZING
    if not m.last_sync_time():
        return INITIAL
    return CLEANING_UP


def _next_sync_from(m: ReplicationMachine, after: datetime) -> Optional[datetime]:
    spec = m.cronspec()
    if not spec:
        return None
    return cron.parse(spec).next(after)


def past_schedule_deadline(m: ReplicationMachine, now: datetime) -> bool:
    """machine.go:259-264: the deadline for a scheduled sync is the *next*
    cron tick after its nominal start; running past it = a missed interval."""
    spec = m.cronspec()
    nst = m.next_sync_time()
    if not spec or nst is None:
        return False
    deadline = cron.parse(spec).next(nst)
    return now >= deadline


def should_sync(m: ReplicationMachine, now: datetime) -> bool:
    """machine.go:223-240."""
    t = trigger_type(m)
    if t == MANUAL_TRIGGER:
        return m.manual_tag() != m.last_manual_sync()
    if t == SCHEDULE_TRIGGER:
        nst = m.next_sync_time()
        return nst is not None and now >= nst
    return True  # no trigger: continuous re-sync loop


def run(m: ReplicationMachine, now: Optional[datetime] = None) -> ReconcileResult:
    """One reconcile pass (machine.go:49-81)."""
    if now is None:
        now = datetime.now(timezone.utc)

    # The nominal slot is recomputed every pass from a stable anchor
    # (last sync completion, else CR creation), so schedule edits take
    # effect immediately — a stale far-future slot is never trusted, and
    # an overdue slot stays in the past and fires at once. This mirrors
    # the reference recomputing nextSyncTime from lastSyncTime each
    # reconcile (machine.go:280-297) rather than persisting a guess.
    if trigger_type(m) == SCHEDULE_TRIGGER:
        anchor = m.last_sync_time() or m.creation_time()
        if anchor is not None:
            m.set_next_sync_time(cron.parse(m.cronspec()).next(anchor))
        elif m.next_sync_time() is None:
            # No stable anchor (no sync yet, no creation stamp): seed once
            # from now; re-deriving from a moving 'now' could slide the
            # slot forever past each fire time.
            m.set_next_sync_time(_next_sync_from(m, now))

    # Deadline-miss accounting (Run :50-62): while a scheduled sync is
    # overdue, only the (idempotent) out-of-sync gauge is raised here —
    # next_sync_time must NOT move, so the overdue slot still fires
    # immediately via should_sync. The miss *counter* is incremented once
    # per sync iteration, at completion (_transition_to_cleaning_up).
    if (trigger_type(m) == SCHEDULE_TRIGGER
            and past_schedule_deadline(m, now)):
        m.set_out_of_sync(True)

    state = current_state(m)
    if state == INITIAL:
        return _do_initial(m, now)
    if state == SYNCHRONIZING:
        return _do_synchronizing(m, now)
    return _do_cleanup(m, now)


def _transition_to_synchronizing(m: ReplicationMachine, now: datetime):
    """machine.go:175-181."""
    m.set_last_sync_start_time(now)
    m.set_condition(COND_SYNCHRONIZING, True, REASON_SYNC_IN_PROGRESS,
                    "Synchronization in-progress")


def _waiting(m: ReplicationMachine, now: datetime) -> ReconcileResult:
    """Idle until the trigger fires again."""
    t = trigger_type(m)
    if t == SCHEDULE_TRIGGER:
        nst = m.next_sync_time()
        m.set_condition(COND_SYNCHRONIZING, False,
                        REASON_WAITING_FOR_SCHEDULE,
                        f"Waiting until next scheduled synchronization {nst}")
        delay = max((nst - now).total_seconds(), 0.0) if nst else 60.0
        return ReconcileResult(requeue_after=timedelta(seconds=delay))
    if t == MANUAL_TRIGGER:
        m.set_condition(COND_SYNCHRONIZING, False, REASON_WAITING_FOR_MANUAL,
                        "Waiting for a new manual trigger tag")
        return ReconcileResult()
    return ReconcileResult(requeue_after=timedelta(seconds=0))


def _do_initial(m: ReplicationMachine, now: datetime) -> ReconcileResult:
    if should_sync(m, now):
        _transition_to_synchronizing(m, now)
        return _do_synchronizing(m, now)
    return _waiting(m, now)


def _do_synchronizing(m: ReplicationMachine, now: datetime) -> ReconcileResult:
    if m.last_sync_start_time() is None:
        _transition_to_synchronizing(m, now)
    try:
        result = m.synchronize()
    except Exception as e:
        m.set_condition(COND_SYNCHRONIZING, False, REASON_ERROR, str(e))
        raise
    if not result.completed:
        m.set_condition(COND_SYNCHRONIZING, True, REASON_SYNC_IN_PROGRESS,
                        "Synchronization in-progress")
        return ReconcileResult(requeue_after=result.retry_after
                               or timedelta(seconds=1))
    return _transition_to_cleaning_up(m, now)


def _transition_to_cleaning_up(m: ReplicationMachine,
                               now: datetime) -> ReconcileResult:
    """machine.go:183-220: stamp completion, feed metrics, ack the manual
    tag, schedule the next slot, clear the start timestamp."""
    start = m.last_sync_start_time()
    m.set_last_sync_time(now)
    if start is not None:
        duration = now - start
        m.set_last_sync_duration(duration)
        m.observe_sync_duration(duration.total_seconds())
    if trigger_type(m) == MANUAL_TRIGGER:
        m.set_last_manual_sync(m.manual_tag())
    if trigger_type(m) == SCHEDULE_TRIGGER:
        # One missed-interval count per iteration that finished after its
        # deadline (the slot after its nominal start).
        if past_schedule_deadline(m, now):
            m.increment_missed_intervals()
        m.set_next_sync_time(_next_sync_from(m, now))
    m.set_out_of_sync(False)
    m.set_last_sync_start_time(None)
    m.set_condition(COND_SYNCHRONIZING, False, REASON_CLEANING_UP,
                    "Cleaning up")
    return _do_cleanup(m, now)


def _do_cleanup(m: ReplicationMachine, now: datetime) -> ReconcileResult:
    try:
        result = m.cleanup()
    except Exception as e:
        m.set_condition(COND_SYNCHRONIZING, False, REASON_ERROR, str(e))
        raise
    if not result.completed:
        return ReconcileResult(requeue_after=result.retry_after
                               or timedelta(seconds=1))
    if should_sync(m, now):
        _transition_to_synchronizing(m, now)
        return ReconcileResult(requeue_after=timedelta(seconds=0))
    return _waiting(m, now)
