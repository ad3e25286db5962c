"""Lock factory of the port: the reference's with its detector off.

Ports ``volsync_tpu/analysis/lockcheck.py`` as it behaves when
``VOLSYNC_TPU_LOCKCHECK`` is unset (its ``make_lock`` / ``make_rlock`` /
``assert_held``): ``make_lock`` returns a ``threading.Lock``,
``make_rlock`` a ``threading.RLock``, and ``assert_held`` checks
nothing. The lock-order and race detector is not ported; call sites
keep the reference's lock names so it can be dropped in later.
"""

from __future__ import annotations

import threading


def make_lock(name: str):
    """A plain ``threading.Lock`` (``name`` is the detector's label)."""
    return threading.Lock()


def make_rlock(name: str):
    """A plain ``threading.RLock`` (``name`` is the detector's label)."""
    return threading.RLock()


def assert_held(lock, what: str) -> None:
    """No-op: plain locks carry no owner to check."""
