"""Unified resilience layer: retry policy, circuit breakers, resilient
object-store wrapper.

Ports ``volsync_tpu/resilience.py`` whole (retry policy, circuit
breakers, ``ResilientStore``), on the port's envflags, metrics and
obs stand-ins.

"Reexamining Paradigms of End-to-End Data Movement" (PAPERS.md) argues
that transfer stacks need failure semantics designed as a LAYER, not
re-invented per call site. Before this module the reproduction had a
scatter of ad-hoc loops (a one-shot reconnect in ``objstore/s3.py``, a
hand-rolled exponential sleep in the pack-upload worker, bespoke
backoff in the lock refresh and the mirror-lease re-stamp). They all
route through here now, and lint rule VL105 (analysis/rules.py) keeps
it that way: a ``time.sleep`` inside an except handler or retry loop
anywhere else in the tree is a finding.

Three pieces:

- **Error classification** — ``classify(exc)`` maps an exception to
  retryable/fatal. Transient transport failures (ConnectionError,
  http.client exceptions, timeouts, gRPC UNAVAILABLE-class codes) and
  HTTP statuses 408/429/5xx are retryable; everything else — including
  NoSuchKey, auth failures and 4xx — is fatal. Backends can also raise
  ``TransientError``/``ThrottleError`` to opt a failure in explicitly.
- **RetryPolicy** — attempts bound, exponential backoff with
  DECORRELATED jitter (AWS architecture-blog variant: each sleep is
  drawn from ``[base, prev*3]`` capped — contenders desynchronize
  instead of re-colliding in lock-step), an overall deadline, and a
  per-call timeout hint threaded to callables that accept one. Every
  attempt increments ``volsync_retry_attempts_total{site,outcome}``
  and backoff waits are visible as ``resilience.backoff`` spans.
- **CircuitBreaker** — classic closed -> open -> half-open per backend,
  envflags-tunable (VOLSYNC_BREAKER_THRESHOLD / _RESET_S). While open,
  calls fail fast with ``CircuitOpen`` (retryable by classification:
  the caller's policy waits out the cooldown instead of hammering a
  dead endpoint). State is exported as
  ``volsync_breaker_state{backend}`` and transitions as a counter.

``ResilientStore`` composes both over any ObjectStore — the layer the
chaos soak (tests/test_chaos.py) drives against seeded fault schedules
(objstore/faultstore.py).
"""

from __future__ import annotations

import http.client
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

from volsync_tpu_torch import envflags
from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS
from volsync_tpu_torch.obs import record_trigger, span

log = logging.getLogger("volsync_tpu_torch.resilience")

#: HTTP statuses worth retrying: request-timeout, throttle, and the
#: transient 5xx family. 501/505 are permanent and excluded on purpose.
RETRYABLE_HTTP = frozenset({408, 429, 500, 502, 503, 504})

#: gRPC status-code NAMES worth retrying (names, not the enum, so this
#: module never imports grpc). UNAUTHENTICATED/NOT_FOUND etc. are fatal.
RETRYABLE_GRPC = frozenset({"UNAVAILABLE", "DEADLINE_EXCEEDED",
                            "RESOURCE_EXHAUSTED", "ABORTED"})


class TransientError(RuntimeError):
    """Base for failures a backend knows to be retryable (fault
    injection raises these too)."""


class ThrottleError(TransientError):
    """Server-side throttle (429/503 Slow Down analogue)."""


class CircuitOpen(TransientError):
    """The backend's breaker is open; fail fast instead of calling."""

    def __init__(self, backend: str, remaining: float):
        super().__init__(
            f"circuit breaker for {backend!r} is open "
            f"({remaining:.1f}s until half-open probe)")
        self.backend = backend
        self.remaining = remaining


class DeadlineExceeded(RuntimeError):
    """The policy's overall deadline expired; carries the last error."""

    def __init__(self, site: str, elapsed: float, last: Exception):
        super().__init__(
            f"{site}: deadline exceeded after {elapsed:.1f}s: {last}")
        self.last = last


def classify(exc: BaseException) -> bool:
    """True when ``exc`` is worth retrying.

    Duck-typed on purpose: backend error classes (S3Error, SwiftError,
    AzureError) carry ``.status``; grpc.RpcError carries ``.code()``.
    Classifying by shape keeps this module free of backend imports (the
    backends import *us*).
    """
    if isinstance(exc, TransientError):
        return True
    # NoSuchKey is a KeyError; any lookup miss is a fact, not a fault.
    if isinstance(exc, (KeyError, ValueError, TypeError)):
        return False
    status = getattr(exc, "status", None)
    if isinstance(status, int):
        return status in RETRYABLE_HTTP
    code = getattr(exc, "code", None)
    if callable(code):
        try:
            name = getattr(code(), "name", None)
        except Exception:  # noqa: BLE001 — a broken .code() is unclassifiable
            name = None
        if isinstance(name, str):
            return name in RETRYABLE_GRPC
    if isinstance(exc, (http.client.HTTPException, ConnectionError,
                        TimeoutError, InterruptedError)):
        return True
    # Remaining OSErrors: transport-level (reset sockets, EPIPE under a
    # NAT timeout...). FileNotFoundError/PermissionError etc. are
    # subclasses handled above only if they match; treat explicit
    # filesystem misses as fatal, the rest of OSError as transient.
    if isinstance(exc, (FileNotFoundError, PermissionError, IsADirectoryError,
                        NotADirectoryError)):
        return False
    return isinstance(exc, OSError)


def decorrelated_jitter(prev: float, base: float, cap: float,
                        rng: Optional[random.Random] = None) -> float:
    """Next backoff sleep (AWS decorrelated-jitter):
    ``min(cap, uniform(base, prev * 3))``. Two contenders started in
    lock-step (same cron tick on two hosts) desynchronize instead of
    re-colliding every round — the randomized-contender semantics the
    repository lock always had, now shared."""
    r = rng if rng is not None else random
    return min(cap, r.uniform(base, max(base, prev * 3)))


@dataclass(frozen=True)
class Attempt:
    """One attempt handed out by RetryPolicy.attempts()."""

    number: int        # 1-based
    elapsed: float     # seconds since the first attempt started
    timeout: Optional[float]  # per-call timeout hint (policy.call_timeout)


@dataclass
class RetryPolicy:
    """Classified retry with decorrelated-jitter backoff and deadlines.

    ``site`` labels metrics/log lines. ``max_attempts`` counts total
    tries (1 = no retry). ``deadline`` bounds the WHOLE operation: no
    new attempt starts once it has passed (a transfer stack that
    retries past its sync interval just converts one failure into two).
    ``call_timeout`` is a hint threaded to each attempt for callables
    that take a ``timeout=`` kwarg. ``retryable``/``fatal`` extend the
    default classifier; ``classify_fn`` replaces it. ``sleep_fn``/
    ``rng`` are injection points so tests and the deterministic fault
    harness can run without wall-clock sleeps.
    """

    site: str = "default"
    max_attempts: int = 4
    base_delay: float = 0.05
    max_delay: float = 5.0
    deadline: Optional[float] = None       # overall seconds budget
    call_timeout: Optional[float] = None   # per-attempt hint
    retryable: tuple = ()
    fatal: tuple = ()
    classify_fn: Optional[Callable[[BaseException], bool]] = None
    sleep_fn: Callable[[float], None] = time.sleep
    rng: Optional[random.Random] = None
    breaker: Optional["CircuitBreaker"] = None
    #: attempts observed by the last call() — tests/metrics introspection
    last_attempts: int = field(default=0, compare=False)

    @classmethod
    def from_env(cls, site: str, **overrides) -> "RetryPolicy":
        """Policy with the envflags-tunable defaults
        (VOLSYNC_RETRY_ATTEMPTS / _BASE_MS / _MAX_MS / _DEADLINE_S)."""
        base = dict(
            max_attempts=envflags.retry_attempts(),
            base_delay=envflags.retry_base_delay(),
            max_delay=envflags.retry_max_delay(),
            deadline=envflags.retry_deadline(),
        )
        base.update(overrides)
        return cls(site=site, **base)

    def is_retryable(self, exc: BaseException) -> bool:
        if self.fatal and isinstance(exc, self.fatal):
            return False
        if self.retryable and isinstance(exc, self.retryable):
            return True
        return (self.classify_fn or classify)(exc)

    def backoffs(self) -> Iterator[float]:
        """The (unbounded) jittered backoff sequence — callers that own
        their loop (lock contention) draw from this instead of
        re-deriving jitter math."""
        prev = self.base_delay
        while True:
            prev = decorrelated_jitter(prev, self.base_delay,
                                       self.max_delay, self.rng)
            yield prev

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` under the policy.

        Retries only classified-retryable failures, sleeps the jittered
        backoff between attempts (as a ``resilience.backoff`` span),
        never starts an attempt past the deadline, and consults/feeds
        the breaker when one is attached. The breaker being open counts
        as a (retryable) failed attempt — the backoff waits out part of
        the cooldown.
        """
        t0 = time.monotonic()
        delays = self.backoffs()
        last: Optional[BaseException] = None
        for attempt in range(1, max(1, self.max_attempts) + 1):
            self.last_attempts = attempt
            try:
                if self.breaker is not None:
                    self.breaker.before_call()
                result = fn(*args, **kwargs)
            except BaseException as exc:
                if (self.breaker is not None
                        and not isinstance(exc, CircuitOpen)):
                    self.breaker.record_failure(exc)
                retryable = self.is_retryable(exc)
                exhausted = (retryable
                             and attempt >= max(1, self.max_attempts))
                _retry_counter(self.site,
                               "exhausted" if exhausted
                               else "retried" if retryable
                               else "fatal").inc()
                if not retryable or exhausted:
                    raise
                last = exc
                delay = next(delays)
                elapsed = time.monotonic() - t0
                if (self.deadline is not None
                        and elapsed + delay > self.deadline):
                    record_trigger("deadline", site=self.site,
                                   attempt=attempt, elapsed_s=round(elapsed, 4))
                    raise DeadlineExceeded(self.site, elapsed, exc) from exc
                log.debug("%s: attempt %d/%d failed (%s); backing off "
                          "%.3fs", self.site, attempt, self.max_attempts,
                          exc, delay)
                with span("resilience.backoff"):
                    self.sleep_fn(delay)
                continue
            if self.breaker is not None:
                self.breaker.record_success()
            _retry_counter(self.site, "ok").inc()
            return result
        raise AssertionError(f"unreachable: {last}")  # pragma: no cover


def _retry_counter(site: str, outcome: str):
    return GLOBAL_METRICS.retry_attempts.labels(site=site, outcome=outcome)


# -- circuit breaker --------------------------------------------------------

_STATE_CODE = {"closed": 0, "open": 1, "half-open": 2}


class CircuitBreaker:
    """closed -> open -> half-open per backend.

    ``threshold`` consecutive retryable failures open the circuit;
    while open, ``before_call`` raises CircuitOpen without touching the
    backend. After ``reset_seconds`` ONE probe call is let through
    (half-open): success closes the circuit, failure re-opens it for
    another cooldown. Fatal (non-retryable) errors never count toward
    the trip threshold — a NoSuchKey storm is the caller's bug, not an
    outage — but a fatal probe failure still releases the probe slot
    and restarts the cooldown (it proved nothing about health, and
    keeping the slot would wedge the breaker half-open forever).
    """

    def __init__(self, backend: str, *, threshold: Optional[int] = None,
                 reset_seconds: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.backend = backend
        self.threshold = (envflags.breaker_threshold() if threshold is None
                          else max(1, threshold))
        self.reset_seconds = (envflags.breaker_reset_seconds()
                              if reset_seconds is None else reset_seconds)
        self._clock = clock
        self._lock = lockcheck.make_lock(f"resilience.breaker.{backend}")
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._gauge = GLOBAL_METRICS.breaker_state.labels(backend=backend)
        self._gauge.set(0)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def open_remaining(self) -> float:
        """Seconds left in the open-state cooldown; 0.0 when the
        breaker is closed, half-open, or already due for its probe.
        Load-shedding callers (service/admission.py) use this as the
        retry-after hint — shedding at admission instead of discovering
        the open breaker mid-stream as a timeout."""
        with self._lock:
            if self._state != "open":
                return 0.0
            return max(0.0,
                       self._opened_at + self.reset_seconds - self._clock())

    def _transition(self, state: str):
        # caller holds self._lock
        if state == self._state:
            return
        self._state = state
        self._gauge.set(_STATE_CODE[state])
        GLOBAL_METRICS.breaker_transitions.labels(
            backend=self.backend, to=state).inc()
        if state == "open":
            # flight-recorder annotation; obs takes only its own lock,
            # never this breaker's, so nesting under self._lock is safe
            record_trigger("breaker_open", backend=self.backend)
        log.info("breaker %s -> %s", self.backend, state)

    def before_call(self):
        """Gate one call. Raises CircuitOpen while cooling down; in
        half-open, admits exactly one probe and shunts the rest."""
        with self._lock:
            if self._state == "closed":
                return
            remaining = self._opened_at + self.reset_seconds - self._clock()
            if self._state == "open":
                if remaining > 0:
                    raise CircuitOpen(self.backend, remaining)
                self._transition("half-open")
            if self._probing:  # half-open, probe slot taken
                raise CircuitOpen(self.backend, max(remaining, 0.0))
            self._probing = True

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._probing = False
            self._transition("closed")

    def record_failure(self, exc: BaseException):
        retryable = classify(exc)
        with self._lock:
            # The probe slot must be released on ANY failure, fatal or
            # not — a probe that dies on NoSuchKey would otherwise wedge
            # the breaker half-open with the slot taken forever, failing
            # every future call with CircuitOpen.
            self._probing = False
            if self._state == "half-open":
                self._opened_at = self._clock()
                self._transition("open")
                return
            if not retryable:
                return  # fatal errors say nothing about backend health
            self._failures += 1
            if self._failures >= self.threshold:
                self._opened_at = self._clock()
                self._transition("open")


_breakers: dict[str, CircuitBreaker] = {}
_breakers_lock = lockcheck.make_lock("resilience.breakers")


def breaker_for(backend: str) -> CircuitBreaker:
    """Process-wide breaker per backend name (all S3 stores pointed at
    one endpoint share its health signal)."""
    with _breakers_lock:
        br = _breakers.get(backend)
        if br is None:
            br = _breakers[backend] = CircuitBreaker(backend)
        return br


def reset_breakers():
    """Drop all shared breakers (tests)."""
    with _breakers_lock:
        _breakers.clear()


# -- measured link statistics ----------------------------------------------

#: Payload size below which a store op is treated as a latency probe
#: rather than a bandwidth sample: tiny transfers are dominated by the
#: per-request round trip, so their wall time estimates link latency,
#: while large transfers estimate sustained bytes/second.
_LINK_SMALL_BYTES = 16 * 1024

_link_lock = lockcheck.make_lock("resilience.link")
_link_totals = {"small_ops": 0, "small_seconds": 0.0,
                "large_ops": 0, "large_bytes": 0, "large_seconds": 0.0}


def _observe_link(nbytes: int, seconds: float) -> None:
    """Fold one successful store attempt into the cumulative link
    totals (only arithmetic under the lock)."""
    with _link_lock:
        if nbytes < _LINK_SMALL_BYTES:
            _link_totals["small_ops"] += 1
            _link_totals["small_seconds"] += seconds
        else:
            _link_totals["large_ops"] += 1
            _link_totals["large_bytes"] += nbytes
            _link_totals["large_seconds"] += seconds


def link_totals() -> dict:
    """Cumulative timings of successful byte-moving ResilientStore
    attempts. The protocol planner's SyncStatsBook
    (engine/syncstats.py) diffs successive snapshots into EWMA
    bandwidth/latency estimates; returning cumulative totals keeps any
    number of independent books consistent."""
    with _link_lock:
        return dict(_link_totals)


def reset_link_totals() -> None:
    """Zero the cumulative link totals (tests)."""
    with _link_lock:
        for k in _link_totals:
            _link_totals[k] = type(_link_totals[k])()


def _payload_bytes(op: str, args: tuple, kwargs: dict, result) -> int:
    if op == "put":
        data = args[1] if len(args) > 1 else kwargs.get("data", b"")
        if isinstance(data, (list, tuple)):  # iovec PutBody
            return sum(len(p) for p in data)
        return len(data)
    return len(result) if isinstance(result, (bytes, bytearray)) else 0


# -- resilient object-store wrapper ----------------------------------------

#: Store methods wrapped with retry (all idempotent: puts are
#: whole-object and content-addressed or last-writer-wins, gets/lists
#: are reads). put_if_absent is NOT here: re-sending it after an
#: ambiguous failure can observe its own first attempt (see
#: objstore/s3.py put_if_absent docstring) — one attempt, caller
#: interprets False as "exists".
_RETRIED_OPS = ("put", "get", "get_range", "exists", "delete", "size",
                "put_file", "get_file")

#: Ops that are single-attempt BY DESIGN: retrying them needs an
#: argued-safe policy at the call site, never the blanket wrap.
#: ``put_if_absent`` is the fence/marker primitive — a blind replay
#: after an ambiguous failure could observe its own first attempt and
#: misreport "lost"; Repository._claim_marker documents the safe retry.
#: The VL601 analyzer (analysis/faultflow.py) exempts these sites the
#: way VL505 sanctions copy sites.
SINGLE_ATTEMPT_OPS = frozenset({"put_if_absent"})


class ResilientStore:
    """Any ObjectStore, wrapped in the shared retry policy + breaker.

    ``list`` is special: the iterator is materialized per attempt so a
    mid-pagination failure retries the WHOLE listing instead of
    resuming a broken continuation token.
    """

    def __init__(self, inner, *, policy: Optional[RetryPolicy] = None,
                 backend: str = "store",
                 breaker: Optional[CircuitBreaker] = None):
        self.inner = inner
        if policy is None:
            policy = RetryPolicy.from_env(f"objstore.{backend}")
        if policy.breaker is None:
            policy.breaker = (breaker if breaker is not None
                              else breaker_for(backend))
        self.policy = policy

    def __getattr__(self, name):  # passthrough for extras (stats, etc.)
        return getattr(self.inner, name)

    def put_if_absent(self, key: str, data: bytes) -> bool:
        return self.inner.put_if_absent(key, data)

    def list(self, prefix: str = ""):
        return iter(self.policy.call(
            lambda: list(self.inner.list(prefix))))


#: Byte-moving ops whose successful attempts feed the measured link
#: totals above. put_file/get_file are excluded: sizing them would cost
#: an extra stat per call on a path that already reports transfer totals
#: through the pipeline's own accounting.
_TIMED_OPS = ("put", "get", "get_range")


def _make_op(op: str):
    if op in _TIMED_OPS:
        def method(self, *args, **kwargs):
            inner = getattr(self.inner, op)

            def timed(*a, **kw):
                t0 = time.perf_counter()
                out = inner(*a, **kw)
                _observe_link(_payload_bytes(op, a, kw, out),
                              time.perf_counter() - t0)
                return out

            return self.policy.call(timed, *args, **kwargs)
    else:
        def method(self, *args, **kwargs):
            return self.policy.call(getattr(self.inner, op), *args, **kwargs)

    method.__name__ = op
    return method


for _op in _RETRIED_OPS:
    setattr(ResilientStore, _op, _make_op(_op))
del _op
