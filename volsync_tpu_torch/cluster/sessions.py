"""Supervised device sessions: leases, keepalive TTLs, auto-recycle, and
a serialized verify-then-measure bench queue.

Ports ``volsync_tpu/cluster/sessions.py`` whole on the port's
``envflags``, ``lockcheck``, metrics, ``FaultSchedule``, ``obs`` and
``resilience``:

- ``Lease``: a hard-TTL hold on the backend's single-tenant device
  slot, acquired through ``RetryPolicy`` behind the backend's circuit
  breaker; every keepalive beat extends it to ``now + ttl``.
- ``SessionSupervisor``: ACQUIRING -> HEALTHY -> DEGRADED -> RECYCLING.
  Keepalive failures degrade; the failure threshold, a probe timeout or
  TTL expiry force a single-flight recycle (``force_release`` and a
  fresh acquire under a new fencing epoch), each marked by
  ``record_trigger``. ``guard(epoch)`` refuses a result produced under
  a fenced-out epoch.
- ``BenchQueue``: jobs strictly one at a time behind a verify probe,
  killed at a per-job hard deadline, each result stamped with the
  session's provenance (backend, session id, epoch).
- ``FakeSessionBackend``: seeded fault schedules (probe hang, keepalive
  drop, zombie holding the device, crash mid-job) on a deterministic
  clock, so the whole supervisor is tested with no card.

``TorchSessionBackend`` takes the place of the reference's
``JaxSessionBackend``: it probes the device in a SUBPROCESS with a hard
timeout (never a fork of a process that may hold a CUDA context), and
the child runs one kernel of the port (``sha256_many`` against
``hashlib``) and synchronises. ``force_release`` kills stale marked
measurement children (``kill_marked_children``). The
``session run/status/recycle`` verbs are ``cluster/sessioncli.py``.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from pathlib import Path

from volsync_tpu_torch import envflags
from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS
from volsync_tpu_torch.objstore.faultstore import FaultSchedule
from volsync_tpu_torch.obs import record_trigger, span
from volsync_tpu_torch.resilience import (
    RetryPolicy,
    TransientError,
    breaker_for,
)

log = logging.getLogger("volsync_tpu_torch.sessions")

# -- states ------------------------------------------------------------------

ACQUIRING = "acquiring"
HEALTHY = "healthy"
DEGRADED = "degraded"
RECYCLING = "recycling"

_STATE_CODE = {ACQUIRING: 0, HEALTHY: 1, DEGRADED: 2, RECYCLING: 3}


# -- errors ------------------------------------------------------------------

class SessionError(RuntimeError):
    """Supervised-session failure (fatal to the caller's attempt; the
    supervisor has already scheduled whatever recovery applies)."""


class SessionBusy(TransientError):
    """The backend's single-tenant device slot is held by another
    session (typically a zombie awaiting force_release) — retryable
    once the holder is recycled."""


class FencedError(SessionError):
    """The producing session's fencing epoch is stale: it was recycled
    while the work ran, so its result is refused. NOT retryable — the
    zombie must die, not retry."""


class JobDeadlineExceeded(SessionError):
    """A queued job hit its per-job hard deadline and was killed."""


# -- deterministic clock (tests, chaos schedules) ----------------------------

class FakeClock:
    """Deterministic clock: calling it reads the time, ``sleep``
    advances it. Injected as ``clock``/``sleep_fn`` so supervisor tests
    drive TTL and probe-timeout arithmetic without wall-clock waits."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.now += max(0.0, float(seconds))


# -- lease -------------------------------------------------------------------

class Lease:
    """Hard-TTL hold on a backend's single-tenant device slot.

    ``acquire`` runs under the shared retry policy with the per-backend
    circuit breaker (a dead backend fails fast instead of being
    hammered); each successful ``beat`` extends the expiry to
    ``now + ttl``. Expiry is judged by the injected ``clock`` so the
    deterministic chaos tests need no wall time.
    """

    def __init__(self, backend, *, ttl: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 policy: Optional[RetryPolicy] = None):
        self.backend = backend
        self.ttl = envflags.session_ttl_seconds() if ttl is None else ttl
        self._clock = clock
        self._lock = lockcheck.make_lock(f"session.lease.{backend.name}")
        self._policy = policy if policy is not None else RetryPolicy.from_env(
            f"session.{backend.name}", sleep_fn=sleep_fn,
            breaker=breaker_for(f"session.{backend.name}"))
        self.session_id: Optional[str] = None
        self._expires = 0.0

    def acquire(self) -> str:
        sid = self._policy.call(self.backend.acquire)
        with self._lock:
            self.session_id = sid
            self._expires = self._clock() + self.ttl
        return sid

    def beat(self) -> None:
        """One keepalive beat — no internal retry (the supervisor
        counts consecutive failures; retrying here would hide them)."""
        with self._lock:
            sid = self.session_id
        if sid is None:
            raise SessionError("no session to keep alive")
        self.backend.keepalive(sid)
        with self._lock:
            self._expires = self._clock() + self.ttl

    def expired(self) -> bool:
        with self._lock:
            return self.session_id is None or self._clock() >= self._expires

    def remaining(self) -> float:
        with self._lock:
            if self.session_id is None:
                return 0.0
            return max(0.0, self._expires - self._clock())

    def release(self, *, force: bool = False) -> None:
        with self._lock:
            sid, self.session_id = self.session_id, None
            self._expires = 0.0
        if force:
            self.backend.force_release()
        elif sid is not None:
            try:
                self.backend.release(sid)
            except Exception as exc:  # noqa: BLE001 — best-effort; the
                # TTL reaps whatever a failed release leaves behind
                log.warning("session release failed (TTL reaps it): %s",
                            exc)


# -- supervisor --------------------------------------------------------------

class SessionSupervisor:
    """ACQUIRING -> HEALTHY -> DEGRADED -> RECYCLING over one backend.

    All state mutates under one re-entrant lock; ``tick()`` is one
    supervision beat (the keepalive thread calls it on an interval;
    deterministic tests call it directly). ``transitions`` records the
    full ``(clock, state, cause)`` trace — the chaos tests assert the
    same seed reproduces the same trace byte-for-byte.

    Fencing: ``epoch`` bumps on every recycle AND every fresh acquire,
    so a token captured by a job admitted under epoch N goes stale the
    instant the session is fenced out — ``guard(N)`` then refuses the
    job's result (the zombie's late write never lands).
    """

    def __init__(self, backend, *, ttl: Optional[float] = None,
                 keepalive_interval: Optional[float] = None,
                 probe_timeout: Optional[float] = None,
                 max_keepalive_failures: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 status_path: Optional[str] = None):
        self.backend = backend
        self.lease = Lease(backend, ttl=ttl, clock=clock,
                           sleep_fn=sleep_fn)
        self.keepalive_interval = (envflags.session_keepalive_seconds()
                                   if keepalive_interval is None
                                   else keepalive_interval)
        self.probe_timeout = (envflags.session_probe_timeout()
                              if probe_timeout is None else probe_timeout)
        self.max_keepalive_failures = (
            envflags.session_keepalive_failures()
            if max_keepalive_failures is None else max_keepalive_failures)
        self._clock = clock
        self._lock = lockcheck.make_rlock(
            f"session.supervisor.{backend.name}")
        self.state = ACQUIRING
        self.epoch = 0
        self.session_id: Optional[str] = None
        self.transitions: list[tuple[float, str, str]] = []
        self.keepalive_failures = 0
        self._recycling = False
        self._paused = 0
        self._status_path = (status_path if status_path is not None
                             else envflags.session_status_path())
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._gauge = GLOBAL_METRICS.session_state.labels(
            backend=backend.name)
        self._gauge.set(_STATE_CODE[self.state])

    # -- state bookkeeping --------------------------------------------------

    def _transition(self, to: str, cause: str) -> None:
        lockcheck.assert_held(self._lock, "session state transition")
        if to == self.state:
            return
        self.state = to
        self.transitions.append((round(self._clock(), 3), to, cause))
        self._gauge.set(_STATE_CODE[to])
        GLOBAL_METRICS.session_transitions.labels(
            backend=self.backend.name, to=to).inc()
        log.info("session %s -> %s (%s)", self.backend.name, to, cause)
        self._write_status()

    def _write_status(self) -> None:
        if not self._status_path:
            return
        try:
            payload = json.dumps(dict(self.provenance(),
                                      wall_time=time.time()))
            tmp = f"{self._status_path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(payload + "\n")
            os.replace(tmp, self._status_path)
        except OSError as exc:
            log.warning("session status mirror failed: %s", exc)

    def provenance(self) -> dict:
        """The identity block the bench queue stamps into every result
        (and into job environments as VOLSYNC_SESSION_*)."""
        with self._lock:
            return {"backend": self.backend.name,
                    "session_id": self.session_id,
                    "epoch": self.epoch,
                    "state": self.state}

    def job_env(self) -> dict:
        """VOLSYNC_SESSION_* variables for a queued job's environment —
        a measurement child reads them back as its provenance."""
        with self._lock:
            return {"VOLSYNC_SESSION_ID": self.session_id or "",
                    "VOLSYNC_SESSION_EPOCH": str(self.epoch),
                    "VOLSYNC_SESSION_BACKEND": self.backend.name}

    # -- lifecycle ----------------------------------------------------------

    def ensure(self) -> str:
        """Return a healthy session id, acquiring one if needed."""
        with self._lock:
            if self.state == HEALTHY and not self.lease.expired():
                return self.session_id  # type: ignore[return-value]
            self._transition(ACQUIRING, "ensure")
            with span("session.acquire"):
                sid = self.lease.acquire()
            self.session_id = sid
            self.epoch += 1
            self.keepalive_failures = 0
            self._transition(HEALTHY, "acquired")
            return sid

    def pause_keepalive(self) -> None:
        """Suspend supervision beats while a queued job holds the
        single-tenant device — a keepalive probe would contend with the
        measurement for the device. The lease is re-beaten at job end."""
        with self._lock:
            self._paused += 1

    def resume_keepalive(self) -> None:
        with self._lock:
            self._paused = max(0, self._paused - 1)

    def tick(self) -> None:
        """One supervision beat: TTL check + keepalive. Failures
        degrade; the consecutive-failure threshold or an expired lease
        force a recycle."""
        with self._lock:
            if self._paused or self.state in (ACQUIRING, RECYCLING):
                return
            if self.lease.expired():
                self.recycle("ttl_expired")
                return
            try:
                with span("session.keepalive"):
                    self.lease.beat()
            except Exception as exc:  # noqa: BLE001 — every failure
                # class counts toward the threshold; classification
                # nuance belongs to acquire's RetryPolicy, not the beat
                GLOBAL_METRICS.session_keepalives.labels(
                    backend=self.backend.name, outcome="failed").inc()
                self.keepalive_failures += 1
                log.warning("session keepalive failed (%d/%d): %s",
                            self.keepalive_failures,
                            self.max_keepalive_failures, exc)
                if self.keepalive_failures >= self.max_keepalive_failures:
                    self.recycle("keepalive_failures")
                elif self.state == HEALTHY:
                    self._transition(DEGRADED, "keepalive_failed")
                return
            GLOBAL_METRICS.session_keepalives.labels(
                backend=self.backend.name, outcome="ok").inc()
            self.keepalive_failures = 0
            if self.state == DEGRADED:
                self._transition(HEALTHY, "keepalive_recovered")

    def verify(self) -> str:
        """The verify probe in front of every queued job. A probe that
        fails — or blocks past ``probe_timeout`` (the faultstore
        ``hang`` kind in chaos schedules) — forces a recycle and raises
        SessionError; the queue retries admission against the fresh
        session."""
        sid = self.ensure()
        t0 = self._clock()
        try:
            with span("session.probe"):
                info = self.backend.probe(sid, timeout=self.probe_timeout)
        except Exception as exc:  # noqa: BLE001 — any probe failure
            # means the session cannot be trusted with the device
            elapsed = self._clock() - t0
            cause = ("probe_timeout" if elapsed >= self.probe_timeout
                     else "probe_failed")
            self.recycle(cause)
            raise SessionError(
                f"verify probe {cause} after {elapsed:.1f}s: {exc}"
            ) from exc
        elapsed = self._clock() - t0
        if elapsed >= self.probe_timeout:
            self.recycle("probe_timeout")
            raise SessionError(
                f"verify probe blocked {elapsed:.1f}s "
                f"(budget {self.probe_timeout:.1f}s)")
        return info

    def recycle(self, cause: str) -> bool:
        """Single-flight forced recycle: fence the epoch, dump the
        flight recorder, force-release the device, land in ACQUIRING.
        Returns False when another flight is already recycling."""
        with self._lock:
            if self._recycling:
                return False
            self._recycling = True
            try:
                old = self.session_id
                self._transition(RECYCLING, cause)
                # Fence FIRST: from this instant, results produced under
                # the old epoch are refused even while force_release is
                # still in flight.
                self.epoch += 1
                GLOBAL_METRICS.session_recycles.labels(
                    backend=self.backend.name, cause=cause).inc()
                record_trigger("session_recycle",
                               backend=self.backend.name, cause=cause,
                               epoch=self.epoch, session=old or "")
                with span("session.recycle"):
                    self.lease.release(force=True)
                self.session_id = None
                self.keepalive_failures = 0
                self._transition(ACQUIRING, "recycled")
            finally:
                self._recycling = False
        return True

    def guard(self, epoch: int) -> None:
        """Refuse work stamped with a stale fencing epoch — the zombie
        session's late write."""
        with self._lock:
            if epoch != self.epoch or self.state != HEALTHY:
                GLOBAL_METRICS.session_fenced_writes.labels(
                    backend=self.backend.name).inc()
                record_trigger("session_fenced_write",
                               backend=self.backend.name,
                               stale_epoch=epoch, epoch=self.epoch)
                raise FencedError(
                    f"fencing epoch {epoch} is stale "
                    f"(current {self.epoch}, state {self.state}); "
                    f"result refused")

    def wait_healthy(self, *, timeout: float,
                     sleep_fn: Callable[[float], None] = time.sleep) -> str:
        """Block (with jittered backoff) until a healthy session exists
        or ``timeout`` expires — the watch entry point."""
        policy = RetryPolicy.from_env(
            "session.wait_healthy", max_attempts=10_000,
            deadline=timeout, sleep_fn=sleep_fn)
        return policy.call(self.verify)

    # -- keepalive thread ---------------------------------------------------

    def start(self) -> "SessionSupervisor":
        """Run ``tick()`` every ``keepalive_interval`` seconds on a
        named thread until ``stop()``."""
        if self._thread is not None:
            return self

        def beat_loop():
            while not self._stop.wait(self.keepalive_interval):
                try:
                    self.tick()
                except Exception as exc:  # noqa: BLE001 — the beat
                    # must survive anything; recycle paths report their
                    # own failures
                    log.warning("session tick failed: %s", exc)

        self._thread = threading.Thread(target=beat_loop,
                                        name="session-keepalive")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self._write_status()

    def __enter__(self) -> "SessionSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- serialized verify-then-measure queue ------------------------------------

class BenchQueue:
    """Bench jobs, strictly one-at-a-time behind a verify probe.

    The queue lock serializes admission AND execution — two jobs can
    never hold the single-tenant device concurrently, whatever threads
    submit them. Each job is killed at a hard deadline (the 8-hour
    wedge becomes a bounded, recycled failure), and its
    result is ``guard``-checked against the fencing epoch captured at
    admission: a job that rode across a recycle is refused.
    """

    #: verify attempts per admission — each failure already recycled
    #: the session, so the retry runs against a fresh one
    ADMIT_ATTEMPTS = 3

    def __init__(self, supervisor: SessionSupervisor, *,
                 job_deadline: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.supervisor = supervisor
        self.job_deadline = (envflags.session_job_deadline()
                             if job_deadline is None else job_deadline)
        self._clock = clock
        self._lock = lockcheck.make_lock(
            f"session.queue.{supervisor.backend.name}")
        self.completed: list[dict] = []

    def _admit(self) -> dict:
        last: Optional[Exception] = None
        for _ in range(self.ADMIT_ATTEMPTS):
            try:
                with span("session.verify"):
                    self.supervisor.verify()
                return self.supervisor.provenance()
            except SessionError as exc:
                last = exc  # verify already recycled; retry fresh
            except Exception as exc:  # noqa: BLE001 — acquire itself
                # failed (e.g. SessionBusy: a zombie holds the device);
                # force_release via recycle, then retry admission
                last = exc
                self.supervisor.recycle("acquire_failed")
        raise SessionError(
            f"verify failed {self.ADMIT_ATTEMPTS}x — backend stays "
            f"unhealthy: {last}")

    def _notify(self, method: str, sid: Optional[str]) -> None:
        hook = getattr(self.supervisor.backend, method, None)
        if hook is not None:
            hook(sid)

    def run(self, fn: Callable[[], object], *, label: str = "job",
            deadline: Optional[float] = None) -> dict:
        """Run ``fn`` as the next serialized job. Returns
        ``{"label", "result", "session"}``; raises JobDeadlineExceeded
        (after recycling) when the job outruns its deadline, and
        FencedError when the session was recycled out from under it."""
        deadline = self.job_deadline if deadline is None else deadline
        with self._lock:
            prov = self._admit()
            epoch = prov["epoch"]
            sid = prov["session_id"]
            from concurrent.futures import ThreadPoolExecutor
            from concurrent.futures import TimeoutError as FutTimeout

            t0 = self._clock()
            self.supervisor.pause_keepalive()
            pool = ThreadPoolExecutor(
                1, thread_name_prefix=f"session-job-{label}")
            try:
                self._notify("job_started", sid)
                with span("session.job"):
                    fut = pool.submit(fn)
                    try:
                        result = fut.result(timeout=deadline)
                    except (FutTimeout, TimeoutError):
                        self.supervisor.recycle("job_deadline")
                        raise JobDeadlineExceeded(
                            f"job {label!r} exceeded {deadline:.0f}s — "
                            f"killed and session recycled") from None
            except JobDeadlineExceeded:
                raise
            except FencedError:
                raise
            except Exception:
                # the job died inside the session: device state is
                # unknown, so the slot is recycled before the next job
                self.supervisor.recycle("job_failed")
                raise
            finally:
                self._notify("job_finished", sid)
                self.supervisor.resume_keepalive()
                # never join a possibly-wedged worker
                pool.shutdown(wait=False, cancel_futures=True)
            elapsed = self._clock() - t0
            if elapsed >= deadline:
                # deterministic-clock path: the job "ran long" even if
                # the wall-clock future returned promptly
                self.supervisor.recycle("job_deadline")
                raise JobDeadlineExceeded(
                    f"job {label!r} took {elapsed:.1f}s "
                    f"(deadline {deadline:.0f}s); result refused")
            self.supervisor.guard(epoch)
            out = {"label": label, "result": result, "session": prov}
            self.completed.append({"label": label, "epoch": epoch,
                                   "session_id": sid})
            return out

    def run_command(self, cmd: list[str], *, label: str = "job",
                    deadline: Optional[float] = None,
                    env_extra: Optional[dict] = None) -> dict:
        """Run a subprocess as the next serialized job, its environment
        stamped with VOLSYNC_SESSION_* so any bench JSON it emits
        carries session provenance. The subprocess is KILLED at the
        deadline — the only hang-proof boundary is a killable process."""
        deadline = self.job_deadline if deadline is None else deadline

        def job():
            env = dict(os.environ, **self.supervisor.job_env(),
                       **(env_extra or {}))
            try:
                r = subprocess.run(cmd, env=env, capture_output=True,
                                   text=True, timeout=deadline)
            except subprocess.TimeoutExpired as exc:
                out = exc.stdout or ""
                if isinstance(out, bytes):
                    out = out.decode(errors="replace")
                return {"rc": 124, "stdout": out, "stderr": "TIMEOUT"}
            return {"rc": r.returncode, "stdout": r.stdout,
                    "stderr": r.stderr}

        # generous outer margin: the subprocess timeout is the real
        # enforcement; the future timeout only guards a wedged spawn
        res = self.run(job, label=label, deadline=deadline + 60)
        if res["result"]["rc"] == 124:
            self.supervisor.recycle("job_deadline")
            raise JobDeadlineExceeded(
                f"command {label!r} exceeded {deadline:.0f}s — killed "
                f"and session recycled")
        return res


# -- fake backend (deterministic chaos) --------------------------------------

class FakeSessionBackend:
    """Deterministic seeded session backend, faultstore-style.

    Faults come from a ``FaultSchedule`` whose specs target session ops
    (``op=`` one of acquire/keepalive/probe/job) with these kinds:

    - ``transient`` — the op fails retryable (keepalive DROP when
      targeted at ``keepalive``);
    - ``hang``      — the op blocks ``ms=`` (default ``hang_s``) on the
      injected clock, then fails — the probe-timeout trigger;
    - ``zombie``    — the session stops answering keepalives but HOLDS
      the device: acquire raises SessionBusy until ``force_release``;
    - ``crash``     — the op (or the job started under it) dies
      non-retryably.

    Decisions reuse ``FaultSchedule.roll`` — a pure hash of
    (seed, spec, op, key, occurrence) — so the same seed over the same
    op sequence reproduces the same faults and therefore the same
    supervisor transition trace. Everything is logged in ``ops`` for
    replay assertions; ``max_concurrent_jobs`` pins the queue's
    one-at-a-time guarantee.
    """

    name = "fake"

    def __init__(self, schedule: Optional[FaultSchedule] = None, *,
                 seed: int = 0, clock: Optional[FakeClock] = None,
                 hang_s: float = 60.0):
        self.schedule = (schedule if schedule is not None
                         else FaultSchedule(seed=seed, specs=[]))
        self.clock = clock if clock is not None else FakeClock()
        self._sleep = self.clock.sleep
        self.hang_s = hang_s
        self._lock = lockcheck.make_lock("session.fake")
        self._spec_hits = [0] * len(self.schedule.specs)
        self._occurrence: dict[tuple[str, str], int] = {}
        self._count = 0
        self.device_holder: Optional[str] = None
        self.zombies: set[str] = set()
        self.ops: list[tuple[str, str, tuple]] = []
        self.writes: list[tuple[int, object]] = []
        self.active_jobs = 0
        self.max_concurrent_jobs = 0
        self.force_releases = 0

    def _decide(self, op: str, key: str) -> list:
        with self._lock:
            n = self._occurrence.get((op, key), 0) + 1
            self._occurrence[(op, key)] = n
            fired = []
            for i, spec in enumerate(self.schedule.specs):
                if not spec.matches(op, key):
                    continue
                self._spec_hits[i] += 1
                hit = (self._spec_hits[i] == spec.at
                       if spec.at is not None
                       else self.schedule.roll(i, op, key, n) < spec.p)
                if hit:
                    fired.append(spec)
            self.ops.append((op, key, tuple(s.kind for s in fired)))
        return fired

    def _apply(self, op: str, fired: list) -> None:
        for spec in fired:
            if spec.kind == "hang":
                self._sleep(spec.latency if spec.latency > 0
                            else self.hang_s)
                raise TransientError(f"injected hang at {op}")
            if spec.kind == "crash":
                raise RuntimeError(f"injected crash at {op}")
            if spec.kind == "transient":
                raise TransientError(f"injected drop at {op}")

    # -- session backend protocol -------------------------------------------

    def acquire(self) -> str:
        fired = self._decide("acquire", "")
        if self.device_holder is not None:
            raise SessionBusy(
                f"device held by {self.device_holder!r} "
                f"(zombie awaiting force_release)")
        self._apply("acquire", fired)
        with self._lock:
            self._count += 1
            sid = f"fake-{self._count}"
            self.device_holder = sid
        return sid

    def keepalive(self, session_id: str) -> None:
        fired = self._decide("keepalive", session_id)
        for spec in fired:
            if spec.kind == "zombie":
                with self._lock:
                    self.zombies.add(session_id)
                raise TransientError("session went zombie "
                                     "(holds the device)")
        if session_id in self.zombies:
            raise TransientError("zombie session ignores keepalive")
        self._apply("keepalive", fired)

    def probe(self, session_id: str, *, timeout: float = 0.0) -> str:
        fired = self._decide("probe", session_id)
        if session_id in self.zombies:
            self._sleep(max(timeout, self.hang_s))
            raise TransientError("zombie session: probe wedged")
        self._apply("probe", fired)
        if self.device_holder != session_id:
            raise SessionError(f"probe of released session "
                               f"{session_id!r}")
        return "fake-ok"

    def release(self, session_id: str) -> None:
        self._decide("release", session_id)
        with self._lock:
            if (self.device_holder == session_id
                    and session_id not in self.zombies):
                self.device_holder = None
        # a zombie ignores polite release — only force_release frees it

    def force_release(self) -> int:
        with self._lock:
            freed = int(self.device_holder is not None)
            self.device_holder = None
            self.force_releases += 1
            self.ops.append(("force_release", "", ()))
        return freed

    # -- queue hooks ---------------------------------------------------------

    def job_started(self, session_id: Optional[str]) -> None:
        with self._lock:
            self.active_jobs += 1
            self.max_concurrent_jobs = max(self.max_concurrent_jobs,
                                           self.active_jobs)
        fired = self._decide("job", session_id or "")
        self._apply("job", fired)

    def job_finished(self, session_id: Optional[str]) -> None:
        with self._lock:
            self.active_jobs -= 1

    def write(self, epoch: int, payload: object) -> None:
        """A landed result write (tests call this only after a
        successful ``supervisor.guard`` — the fence test asserts the
        zombie's write never reaches here)."""
        with self._lock:
            self.writes.append((epoch, payload))


# -- real backend ------------------------------------------------------------

#: The probe child: one kernel of the port on the device, held against
#: hashlib, then a synchronise. argv[1] is the device.
_TORCH_PROBE_SRC = """
import hashlib, sys
import torch
from volsync_tpu_torch import resolve_device
from volsync_tpu_torch.ops.sha256 import sha256_many
dev = resolve_device(None if sys.argv[1] == "default" else sys.argv[1])
msgs = [b"", b"abc", bytes(range(256)) * 3]
if sha256_many(msgs, device=dev) != [hashlib.sha256(m).digest() for m in msgs]:
    raise SystemExit("probe: sha256_many disagrees with hashlib")
name = "cpu"
if dev.type == "cuda":
    torch.cuda.synchronize(dev)
    name = torch.cuda.get_device_name(dev)
print("probe-ok", dev.type, name)
"""

#: environment marker carried ONLY by this harness's measurement
#: children — the targeted-kill filter (see kill_marked_children)
BENCH_CHILD_MARKER = "VOLSYNC_BENCH_INNER=1"

#: The checkout root, put on the probe child's ``PYTHONPATH``.
_ROOT = str(Path(__file__).resolve().parents[2])


def kill_marked_children(marker: str = BENCH_CHILD_MARKER, *,
                         log_fn: Callable[[str], None] = log.info) -> int:
    """SIGKILL processes leaked by PRIOR measurement runs. Targeted: only
    processes whose environment carries ``marker`` (set exclusively by
    the measurement harness's children) and that are not this process or
    its parent. ``marker`` is parameterized so tests can sweep a
    sentinel value without ever matching a real run."""
    import glob

    killed = 0
    own = {os.getpid(), os.getppid()}
    want = marker.encode()
    for path in glob.glob("/proc/[0-9]*/environ"):
        try:
            pid = int(path.split("/")[2])
        except ValueError:
            continue
        if pid in own:
            continue
        try:
            with open(path, "rb") as f:
                env_blob = f.read()
        except OSError:
            continue
        if want in env_blob.split(b"\0"):
            try:
                os.kill(pid, signal.SIGKILL)
                killed += 1
                log_fn(f"sessions: killed stale measurement pid {pid}")
            except OSError:
                pass
    return killed


class TorchSessionBackend:
    """A device of this host, probed in SUBPROCESSES with hard timeouts
    (a wedged device call hangs where in-process deadlines cannot
    interrupt it). ``device`` None probes CUDA, and the probe fails
    with ``TransientError`` where there is none; ``"cpu"`` probes the
    kernels' plain versions. ``force_release`` sweeps stale marked
    measurement children."""

    def __init__(self, name: str = "torch", device=None, *,
                 probe_timeout: Optional[float] = None,
                 keepalive_timeout: float = 120.0,
                 marker: str = BENCH_CHILD_MARKER):
        self.name = name
        self.device = None if device is None else str(device)
        self.probe_timeout = (envflags.session_probe_timeout()
                              if probe_timeout is None else probe_timeout)
        self.keepalive_timeout = keepalive_timeout
        self.marker = marker
        self._count = 0

    def _probe_subprocess(self, timeout: float) -> str:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        try:
            r = subprocess.run(
                [sys.executable, "-c", _TORCH_PROBE_SRC,
                 self.device or "default"],
                timeout=max(timeout, 1.0), capture_output=True, text=True,
                env=env)
        except subprocess.TimeoutExpired:
            raise TransientError(
                f"device probe exceeded {timeout:.0f}s (device "
                f"wedged)") from None
        for line in r.stdout.splitlines():
            if r.returncode == 0 and line.startswith("probe-ok "):
                return line[len("probe-ok "):].strip()
        raise TransientError(
            f"device probe rc={r.returncode}: "
            f"{(r.stderr or '').strip()[-300:]}")

    def acquire(self) -> str:
        self._probe_subprocess(self.probe_timeout)
        self._count += 1
        return f"{self.name}-{os.getpid()}-{self._count}"

    def keepalive(self, session_id: str) -> None:
        self._probe_subprocess(self.keepalive_timeout)

    def probe(self, session_id: str, *, timeout: float = 0.0) -> str:
        """-> ``"<device type> <device name>"`` from the child."""
        return self._probe_subprocess(timeout or self.probe_timeout)

    def release(self, session_id: str) -> None:
        pass  # sessions are subprocess-scoped; nothing to hand back

    def force_release(self) -> int:
        return kill_marked_children(self.marker)
