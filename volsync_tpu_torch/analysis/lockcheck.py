"""Runtime lock-order / race detector of the port.

Ports ``volsync_tpu/analysis/lockcheck.py`` whole (standard library
only). With ``VOLSYNC_TPU_LOCKCHECK=1`` (``envflags.lockcheck_enabled``),
the modules that build their locks through :func:`make_lock` /
:func:`make_rlock` get instrumented wrappers that:

* keep a per-thread stack of held locks;
* record a directed edge ``A -> B`` (keyed by lock *name*, i.e. lock
  class, not instance) whenever B is acquired while A is held;
* raise :class:`LockOrderError` the moment a new edge closes a cycle
  in that graph: the AB/BA pattern that deadlocks only under the
  right interleaving is caught on ANY interleaving;
* raise on a blocking re-acquire of a non-reentrant lock the current
  thread already holds (certain self-deadlock);
* back :func:`assert_held`, the guard the repository's pipeline stages
  place in front of shared-state mutation.

Without the flag, ``make_lock``/``make_rlock`` return plain
``threading.Lock``/``RLock`` objects and :func:`assert_held` is a
no-op.

Every violation is both raised in the offending thread and appended to
a module-level list (:func:`violations`): pipeline workers swallow
exceptions into their error slots by design, so a test fixture checks
the list at teardown rather than trusting propagation.
"""

from __future__ import annotations

import threading
from typing import Optional

from volsync_tpu_torch import envflags


class LockOrderError(RuntimeError):
    """A lock acquisition would close a cycle in the lock-order graph
    (potential deadlock), or re-acquire a held non-reentrant lock
    (certain deadlock)."""


class LockGuardError(RuntimeError):
    """Shared state guarded by a lock was touched by a thread not
    holding it."""


# Graph + violation log, shared across all instrumented locks.
_state = threading.Lock()
_edges: dict[str, set[str]] = {}
_edge_sites: dict[tuple[str, str], str] = {}
_violations: list[str] = []

_tls = threading.local()


def enabled() -> bool:
    return envflags.lockcheck_enabled()


def _held_stack() -> list:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _record_violation(msg: str) -> None:
    with _state:
        _violations.append(msg)


def _reaches(src: str, dst: str) -> Optional[list[str]]:
    """Path src -> ... -> dst in the edge graph (caller holds _state);
    None if unreachable."""
    seen = {src}
    stack = [(src, [src])]
    while stack:
        node, path = stack.pop()
        for nxt in _edges.get(node, ()):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


class _InstrumentedLock:
    """Lock/RLock drop-in recording acquisition order. ``name`` is the
    lock's CLASS (every Repository's state lock shares one name): the
    order invariant is between classes of lock, and an edge between two
    same-named instances is itself a hazard (two repos locked in
    opposite orders by two threads is a real ABBA)."""

    def __init__(self, name: str, *, reentrant: bool):
        self._name = name
        self._reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._owner: Optional[int] = None
        self._count = 0

    # -- bookkeeping ----------------------------------------------------

    def _check_order(self) -> None:
        """Pre-acquire: raise if taking this lock would deadlock or
        close an order cycle. Runs BEFORE the blocking acquire so the
        detector reports instead of hanging."""
        me = threading.get_ident()
        held = _held_stack()
        if self._owner == me:
            if self._reentrant:
                return  # re-entry: no new ordering information
            msg = (f"lockcheck: thread {threading.current_thread().name} "
                   f"re-acquiring non-reentrant lock '{self._name}' it "
                   f"already holds (self-deadlock)")
            _record_violation(msg)
            raise LockOrderError(msg)
        with _state:
            for holder in held:
                a, b = holder._name, self._name
                if holder is self or (a, b) in _edge_sites:
                    continue
                cycle = _reaches(b, a)
                if cycle is not None:
                    where = " ; ".join(
                        f"{x}->{y} first seen {_edge_sites[(x, y)]}"
                        for x, y in zip(cycle, cycle[1:]))
                    msg = (f"lockcheck: lock-order cycle: acquiring "
                           f"'{b}' while holding '{a}' in thread "
                           f"{threading.current_thread().name}, but "
                           f"{where}")
                    _violations.append(msg)
                    raise LockOrderError(msg)

    def _record_acquired(self) -> None:
        """Post-acquire: insert held->self edges, atomically re-checking
        acyclicity per insertion (closes the window between the
        pre-acquire check and this record — the graph is acyclic as an
        invariant, so a raise here is never stale). Raises with the
        inner lock still held; acquire() releases it."""
        me = threading.get_ident()
        held = _held_stack()
        with _state:
            for holder in held:
                if holder is self:
                    continue
                a, b = holder._name, self._name
                if (a, b) in _edge_sites:
                    continue
                cycle = _reaches(b, a)
                if cycle is not None:
                    where = " ; ".join(
                        f"{x}->{y} first seen {_edge_sites[(x, y)]}"
                        for x, y in zip(cycle, cycle[1:]))
                    msg = (f"lockcheck: lock-order cycle: acquiring "
                           f"'{b}' while holding '{a}' in thread "
                           f"{threading.current_thread().name}, but "
                           f"{where}")
                    _violations.append(msg)
                    raise LockOrderError(msg)
                _edges.setdefault(a, set()).add(b)
                _edge_sites[(a, b)] = (
                    f"thread {threading.current_thread().name}")
        if self._owner == me:
            self._count += 1
            return
        self._owner = me
        self._count = 1
        held.append(self)

    def _record_released(self) -> None:
        self._count -= 1
        if self._count <= 0:
            self._owner = None
            self._count = 0
            held = _held_stack()
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    break

    # -- Lock API -------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            self._check_order()
        got = self._inner.acquire(blocking, timeout)
        if got:
            try:
                self._record_acquired()
            except LockOrderError:
                self._inner.release()
                raise
        return got

    def release(self) -> None:
        if self._owner == threading.get_ident():
            self._record_released()
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        if self._reentrant:
            return self._count > 0
        return self._inner.locked()

    # -- guard hook -----------------------------------------------------

    def _lc_assert_held(self, what: str) -> None:
        if self._owner != threading.get_ident():
            msg = (f"lockcheck: {what} mutated by thread "
                   f"{threading.current_thread().name} without holding "
                   f"'{self._name}'")
            _record_violation(msg)
            raise LockGuardError(msg)

    def __repr__(self):
        state = f"held by {self._owner}" if self._count else "unlocked"
        return f"<InstrumentedLock {self._name!r} {state}>"


def make_lock(name: str):
    """A ``threading.Lock`` — instrumented when VOLSYNC_TPU_LOCKCHECK=1
    (read at construction: locks built before the flag flips stay
    plain, which is why the lockcheck suites set the flag before
    constructing their repositories/stores)."""
    if enabled():
        return _InstrumentedLock(name, reentrant=False)
    return threading.Lock()


def make_rlock(name: str):
    """``threading.RLock`` variant of :func:`make_lock`."""
    if enabled():
        return _InstrumentedLock(name, reentrant=True)
    return threading.RLock()


def assert_held(lock, what: str) -> None:
    """Guard for lock-protected shared state: raises LockGuardError if
    the calling thread does not hold ``lock``. No-op on plain
    (uninstrumented) locks, so call sites don't need their own
    enabled() branches."""
    hook = getattr(lock, "_lc_assert_held", None)
    if hook is not None:
        hook(what)


# -- test / inspection hooks ------------------------------------------------

def reset() -> None:
    """Clear the order graph and violation log (test isolation)."""
    with _state:
        _edges.clear()
        _edge_sites.clear()
        _violations.clear()


def violations() -> list[str]:
    """Violations recorded so far (raises may have been swallowed by
    worker threads — this list never is)."""
    with _state:
        return list(_violations)


def order_graph() -> dict[str, set[str]]:
    """Copy of the observed lock-order edges (name -> successors)."""
    with _state:
        return {k: set(v) for k, v in _edges.items()}


def graph() -> set:
    """The runtime-observed acquisition edges as a flat ``(held,
    acquired)`` name-pair set — the shape the static cross-check
    compares against)."""
    with _state:
        return {(a, b) for a, succs in _edges.items() for b in succs}
