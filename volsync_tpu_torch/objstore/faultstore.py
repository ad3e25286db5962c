"""Deterministic, seeded fault-injection ObjectStore wrapper.

Ports ``volsync_tpu/objstore/faultstore.py`` whole. The schedule is the
reference's: for the same seed, spec and sequence of operations both
packages inject the same faults, so the chaos tests of either hold the
other's stores to one weather.

"Optimized Disaster Recovery for Distributed Storage Systems"
(PAPERS.md) motivates verifying metadata/index consistency *under*
failure, not only on the happy path. ``FaultStore`` wraps any
ObjectStore and injects faults according to a seeded ``FaultSchedule``:

- ``transient``   — a retryable error (connection-reset analogue); for
                    writes, ``landed=1`` means the bytes reached the
                    store BEFORE the error (the S3 PUT-committed /
                    connection-died ambiguity).
- ``throttle``    — a retryable 429/Slow-Down analogue.
- ``latency``     — a latency spike (``ms=`` per hit).
- ``partial_put`` — a TORN write: the store receives a truncated
                    object, then the error raises. Retry must
                    OVERWRITE, not skip-if-exists.
- ``truncated_read`` — the connection drops mid-body (http.client
                    raises IncompleteRead in real life); retryable.
- ``crash``       — process death at operation N: a NON-retryable
                    error, and the store goes dead (every later call
                    fails too — in-flight worker threads cannot
                    quietly finish work the "dead" process started).
- ``hang``        — the call blocks (``ms=`` per hit, default 60 s)
                    past any caller-side deadline and THEN fails
                    retryable — a stuck TCP connection that a NAT
                    eventually reaps. The way to exercise
                    ``DeadlineExceeded`` paths in chaos schedules.
- ``partition``   — the store becomes unreachable for a DURATION
                    (``ms=`` per hit, default 5 s) and then heals:
                    every op inside the window fails retryable without
                    reaching the store. Distinct from ``crash``'s
                    sticky death — a replica that loses the network
                    while its siblings keep writing comes back; the
                    fleet drill's mid-outage failover rides this.
                    While partitioned, other specs' counters do not
                    advance (those ops never arrived at the store).
- ``vanish``      — a landed object LATER disappears: the triggering
                    op completes normally, then every subsequent
                    ``get``/``get_range``/``size`` of that key raises
                    ``NoSuchKey``, ``exists`` says False, and listings
                    omit it — the lost-shard / lost-replica fault
                    class (an object a bucket audit can no longer
                    find). Distinct from ``crash``'s sticky death
                    (only the KEY dies, the store lives) and from
                    ``delete`` (no client ever asked). A later PUT of
                    the key resurrects it — which is exactly what the
                    erasure-coding heal arms must be able to do.
- ``bitflip``     — SILENT corruption: a ``get``/``get_range`` payload
                    comes back with ``nbytes=`` byte positions XORed
                    (default 1) and NO exception raised — the bit-rot /
                    wrong-bytes fault class every loud kind above
                    misses. Corrupted positions and masks are a pure
                    hash of ``(seed, key, nth-occurrence)`` so the same
                    seed rots the same bytes on every run. Only read
                    ops match (the spec's ``at=N`` counter counts reads
                    only); the stored object itself is untouched.

Determinism: probability rolls are a pure hash of
``(seed, spec, op, key, nth-occurrence-of(op,key))`` — independent of
thread interleaving, so the same seed over the same multiset of
operations injects the same faults even under the concurrent upload
pool. ``at=N`` (fire at the Nth matching op) counts arrivals under a
lock and is deterministic for serial op sequences — what the
crash-at-op-N recovery scenarios use. Every injection is recorded in
``FaultStore.injected`` for replay assertions.

Arming: construct directly (tests), or set ``VOLSYNC_FAULT_SEED`` (+
optional ``VOLSYNC_FAULT_SPEC``) and open stores through
``open_store()`` / ``maybe_wrap()`` — the CLI and bench.py
(``--faults SEED``) ride that path in the reference.

Spec strings (``parse_spec``): semicolon-separated entries
``kind:key=value,...`` e.g. ::

    transient:p=0.05,op=put;latency:p=0.1,ms=2;crash:at=40,op=put,prefix=data/

``op`` accepts a pipe-separated list (``op=put|delete``) so one
crash-at-op-N counter can span every write boundary of a multi-op
protocol, e.g. the two-phase prune's mark/sweep steps.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

from volsync_tpu_torch import envflags
from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.objstore.store import NoSuchKey, body_len, body_parts
from volsync_tpu_torch.obs import record_trigger
from volsync_tpu_torch.resilience import ThrottleError, TransientError


class FaultInjected(TransientError):
    """A scheduled transient fault (retryable by classification)."""


class InjectedThrottle(ThrottleError):
    """A scheduled throttle response (retryable)."""


class InjectedCrash(RuntimeError):
    """Scheduled process death — NOT retryable (plain RuntimeError, so
    resilience.classify says fatal) and sticky: the store is dead."""


class InjectedHang(TransientError):
    """A scheduled hang: the call consumed the caller's patience before
    failing (retryable — but a deadline-aware policy has usually
    already expired by the time this surfaces)."""


class InjectedPartition(TransientError):
    """The store is inside a scheduled partition window: unreachable
    now, healed once the window elapses (retryable — a policy that
    keeps trying past the window succeeds)."""


class _Vanished(Exception):
    """Internal signal: the key is in the vanished set — surfaced to
    callers as NoSuchKey (or False from exists), never raised out."""


#: default blocked time for a ``hang`` spec that carries no ``ms=``
_HANG_DEFAULT_S = 60.0
#: default outage length for a ``partition`` spec that carries no ``ms=``
_PARTITION_DEFAULT_S = 5.0

_KINDS = ("transient", "throttle", "latency", "partial_put",
          "truncated_read", "crash", "hang", "partition", "bitflip",
          "vanish")
#: ops that mutate the store — the ones ``landed`` applies to
_WRITE_OPS = ("put", "put_if_absent", "delete")
#: ops returning a payload — the only ones ``bitflip`` can corrupt
_PAYLOAD_OPS = ("get", "get_range")
#: ops a vanished key answers "no such object" to (writes resurrect)
_VANISH_OPS = ("get", "get_range", "size", "exists")


@dataclass(frozen=True)
class FaultSpec:
    """One line of a fault schedule."""

    kind: str                  # one of _KINDS
    p: float = 0.0             # probability per matching op
    at: Optional[int] = None   # fire at the Nth matching op (1-based)
    op: str = "*"              # op filter: "*", one name, or "a|b|c"
    key_prefix: str = ""       # key startswith filter
    landed: bool = False       # write ops: inner op completes first
    latency: float = 0.0       # seconds, for kind="latency"
    nbytes: int = 1            # byte positions flipped, for kind="bitflip"

    def matches(self, op: str, key: str) -> bool:
        # ``op`` accepts a pipe-separated list ("put|delete") so one
        # crash counter can span every write stage of a multi-op
        # protocol (the two-phase prune's chaos schedules need
        # crash-at-op-N across its put AND delete boundaries).
        if self.kind == "bitflip" and op not in _PAYLOAD_OPS:
            # silent corruption only exists on payload-returning ops;
            # keeping non-reads out of ``matches`` keeps the spec's
            # at=N counter a pure read counter
            return False
        if self.op != "*" and op not in self.op.split("|"):
            return False
        return key.startswith(self.key_prefix)


def parse_spec(text: str) -> list[FaultSpec]:
    """Parse the VOLSYNC_FAULT_SPEC string format (module docstring)."""
    specs: list[FaultSpec] = []
    for entry in text.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        kind, _, rest = entry.partition(":")
        kind = kind.strip()
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(known: {', '.join(_KINDS)})")
        kwargs: dict = {}
        for pair in filter(None, (p.strip() for p in rest.split(","))):
            k, _, v = pair.partition("=")
            k = k.strip()
            v = v.strip()
            if k == "p":
                kwargs["p"] = float(v)
            elif k == "at":
                kwargs["at"] = int(v)
            elif k == "op":
                kwargs["op"] = v
            elif k == "prefix":
                kwargs["key_prefix"] = v
            elif k == "landed":
                kwargs["landed"] = v not in ("", "0", "false", "no")
            elif k == "ms":
                kwargs["latency"] = float(v) / 1000.0
            elif k == "nbytes":
                kwargs["nbytes"] = int(v)
            else:
                raise ValueError(f"unknown fault spec field {k!r}")
        specs.append(FaultSpec(kind=kind, **kwargs))
    return specs


def default_specs() -> list[FaultSpec]:
    """The transient-heavy profile a bare VOLSYNC_FAULT_SEED arms."""
    return [
        FaultSpec(kind="transient", p=0.05),
        FaultSpec(kind="latency", p=0.05, latency=0.002),
    ]


@dataclass
class FaultSchedule:
    """Seeded decision function over (op, key) arrivals."""

    seed: int
    specs: list = field(default_factory=default_specs)

    def roll(self, spec_idx: int, op: str, key: str, n: int) -> float:
        """Uniform [0,1) as a pure function of identity — thread-
        interleaving-independent determinism."""
        h = hashlib.blake2b(
            f"{self.seed}:{spec_idx}:{op}:{key}:{n}".encode(),
            digest_size=8).digest()
        return int.from_bytes(h, "big") / float(1 << 64)


class FaultStore:
    """ObjectStore wrapper applying a FaultSchedule (module docstring).

    With an all-zero schedule the wrapper is TRANSPARENT — the
    cross-backend contract test runs every backend through it to pin
    that down.
    """

    def __init__(self, inner, schedule: Optional[FaultSchedule] = None,
                 *, seed: int = 0,
                 sleep_fn=time.sleep,
                 clock=time.monotonic):
        self.inner = inner
        self.schedule = (schedule if schedule is not None
                         else FaultSchedule(seed=seed))
        self.injected: list[tuple[int, str, str, str]] = []
        self.crashed = False
        self._sleep = sleep_fn
        # partition windows are judged by this clock (injectable so
        # tests heal a partition without wall-clock waits)
        self._clock = clock
        self._partition_until = 0.0
        self._lock = lockcheck.make_lock("objstore.faults")
        # keys currently "lost" by a vanish fault (sticky until a
        # write of that key lands again)
        self._vanished: set[str] = set()
        self._op_count = 0
        # per-spec matching-op counters (for at=N) and per-(op,key)
        # occurrence counters (for the pure-hash rolls)
        self._spec_hits = [0] * len(self.schedule.specs)
        self._occurrence: dict[tuple[str, str], int] = {}

    # -- decision core ----------------------------------------------------

    def _decide(self, op: str, key: str) -> tuple[list[FaultSpec], int, int]:
        """All specs firing on this arrival (with the arrival's op index
        and per-(op,key) occurrence number), recorded — except
        ``bitflip``, which is recorded by ``_apply`` only when a
        corrupted payload actually reached the caller (a louder spec on
        the same arrival masks it). Raises InjectedCrash immediately
        when the store is already dead."""
        with self._lock:
            if self.crashed:
                raise InjectedCrash(
                    f"store is dead (earlier injected crash); {op} "
                    f"{key!r} refused")
            if self._clock() < self._partition_until:
                # inside an open partition window: the op never reaches
                # the store, and no spec counter advances for it
                raise InjectedPartition(
                    f"store partitioned; {op} {key!r} unreachable for "
                    f"{self._partition_until - self._clock():.3f}s more")
            if key in self._vanished and op in _VANISH_OPS:
                # the object is "lost": reads answer absence without
                # advancing any spec counter (they never reached a
                # real object) — writes fall through and resurrect
                raise _Vanished(key)
            self._op_count += 1
            opix = self._op_count
            n = self._occurrence.get((op, key), 0) + 1
            self._occurrence[(op, key)] = n
            fired: list[FaultSpec] = []
            for i, spec in enumerate(self.schedule.specs):
                if not spec.matches(op, key):
                    continue
                self._spec_hits[i] += 1
                hit = (self._spec_hits[i] == spec.at if spec.at is not None
                       else self.schedule.roll(i, op, key, n) < spec.p)
                if hit:
                    fired.append(spec)
                    if spec.kind not in ("bitflip", "vanish"):
                        # bitflip/vanish record in _apply, only once
                        # the op actually succeeded (a louder spec on
                        # the same arrival masks them)
                        self.injected.append((opix, op, key, spec.kind))
            if any(s.kind == "crash" for s in fired):
                self.crashed = True
        return fired, opix, n

    def _corrupt(self, data: bytes, key: str, n: int,
                 nbytes: int) -> bytes:
        """Deterministically XOR ``nbytes`` byte positions of ``data``.
        Positions and masks are a pure hash of (seed, key, nth) — the
        same seed rots the same bytes on every run — and every mask has
        its low bit set so a flipped byte always differs."""
        if not data:
            return data
        out = bytearray(data)
        for i in range(max(1, nbytes)):
            h = hashlib.blake2b(
                f"{self.schedule.seed}:bitflip:{key}:{n}:{i}".encode(),  # lint: ignore[VL402] schedule is set once in __init__ and never reassigned
                digest_size=8).digest()
            pos = int.from_bytes(h[:6], "big") % len(out)
            out[pos] ^= h[6] | 0x01
        return bytes(out)

    def _apply(self, op: str, key: str, execute, *,
               torn_execute=None):
        """Run one op under the schedule. ``execute()`` performs the
        real operation; ``torn_execute()`` (writes only) performs the
        truncated form for partial_put."""
        try:
            fired, opix, n = self._decide(op, key)
        except _Vanished:
            record_trigger("fault", op=op, key=key, kinds=["vanish"])
            if op == "exists":
                return False
            raise NoSuchKey(f"{key} (vanished by fault injection)")
        if fired:
            # flight-recorder annotation, outside self._lock (_decide
            # released it) so the dump can never nest under it
            record_trigger("fault", op=op, key=key,
                           kinds=[s.kind for s in fired])
        for spec in fired:
            if spec.kind == "latency" and spec.latency > 0:
                self._sleep(spec.latency)
        crash = next((s for s in fired if s.kind == "crash"), None)
        part = next((s for s in fired if s.kind == "partition"), None)
        err = next((s for s in fired
                    if s.kind in ("transient", "throttle", "partial_put",
                                  "truncated_read", "hang")), None)
        if part is not None:
            duration = (part.latency if part.latency > 0
                        else _PARTITION_DEFAULT_S)
            with self._lock:
                self._partition_until = max(self._partition_until,
                                            self._clock() + duration)
            raise InjectedPartition(
                f"injected partition at {op} {key!r} "
                f"(unreachable {duration:.3f}s)")
        if crash is not None:
            if crash.landed and op in _WRITE_OPS:
                execute()
            raise InjectedCrash(f"injected crash at {op} {key!r}")
        if err is None:
            result = execute()
            if op in _WRITE_OPS:
                with self._lock:
                    # a landed write replaces (or truly removes) the
                    # object: the key stops being "lost"
                    self._vanished.discard(key)
            if any(s.kind == "vanish" for s in fired):
                with self._lock:
                    self._vanished.add(key)
                self.injected.append((opix, op, key, "vanish"))
            flips = [s for s in fired if s.kind == "bitflip"]
            if flips:
                # silent wrong-bytes: the op SUCCEEDS and the caller
                # receives a corrupted payload — one corruption per
                # arrival (widest nbytes wins when several specs fire),
                # recorded only now that it actually reached a caller
                result = self._corrupt(result, key, n,
                                       max(s.nbytes for s in flips))
                self.injected.append((opix, op, key, "bitflip"))
            return result
        if err.kind == "hang":
            # Block past the caller's deadline, then surface as a drop
            # (the op never reached the store — nothing lands).
            self._sleep(err.latency if err.latency > 0
                        else _HANG_DEFAULT_S)
            raise InjectedHang(f"injected hang at {op} {key!r}")
        if err.kind == "partial_put" and torn_execute is not None:
            torn_execute()
            raise FaultInjected(f"injected torn write at {op} {key!r}")
        if err.kind == "throttle":
            raise InjectedThrottle(f"injected throttle at {op} {key!r}")
        if err.kind == "truncated_read":
            raise FaultInjected(f"injected truncated read at {op} {key!r}")
        # transient
        if err.landed and op in _WRITE_OPS:
            execute()
        raise FaultInjected(f"injected transient error at {op} {key!r}")

    # -- ObjectStore protocol ---------------------------------------------

    def put(self, key: str, data) -> None:
        # PutBody-aware: iovec part lists pass through untouched (the
        # zero-copy seal path); the torn form truncates at the logical
        # half-length without materializing one blob.
        half = max(0, body_len(data) // 2)

        def torn():
            out: list = []
            left = half
            for p in body_parts(data):
                if left <= 0:
                    break
                if len(p) <= left:
                    out.append(p)
                    left -= len(p)
                else:
                    out.append(memoryview(p)[:left])
                    left = 0
            self.inner.put(key, out)

        self._apply("put", key, lambda: self.inner.put(key, data),
                    torn_execute=torn)

    def put_if_absent(self, key: str, data) -> bool:
        return self._apply("put_if_absent", key,
                           lambda: self.inner.put_if_absent(key, data))

    def get(self, key: str) -> bytes:
        return self._apply("get", key, lambda: self.inner.get(key))

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        return self._apply("get_range", key,
                           lambda: self.inner.get_range(key, offset,
                                                        length))

    def exists(self, key: str) -> bool:
        return self._apply("exists", key, lambda: self.inner.exists(key))

    def delete(self, key: str) -> None:
        self._apply("delete", key, lambda: self.inner.delete(key))

    def size(self, key: str) -> int:
        return self._apply("size", key, lambda: self.inner.size(key))

    def list(self, prefix: str = "") -> Iterator[str]:
        # materialized so the fault decision covers the whole listing,
        # not just the first page pull; vanished keys are omitted (a
        # lost object stops appearing in bucket listings too)
        keys = self._apply("list", prefix,
                           lambda: list(self.inner.list(prefix)))
        with self._lock:
            gone = set(self._vanished)
        return iter([k for k in keys if k not in gone])

    # file transfer rides the byte path so the schedule applies to it
    # (bounded memory is irrelevant at chaos-test scale)
    def put_file(self, key: str, src) -> None:
        from pathlib import Path

        self.put(key, Path(src).read_bytes())

    def get_file(self, key: str, dst) -> int:
        import os
        from pathlib import Path

        data = self.get(key)
        dst = Path(dst)
        tmp = dst.parent / f".volsync.tmp.{os.getpid()}.{dst.name}"
        tmp.write_bytes(data)
        tmp.replace(dst)
        return len(data)


def maybe_wrap(store, *, seed: Optional[int] = None,
               spec: Optional[str] = None):
    """Wrap ``store`` in a FaultStore when armed (explicitly or via
    VOLSYNC_FAULT_SEED / VOLSYNC_FAULT_SPEC); otherwise return it
    unchanged. The arming path the tests and open_store share."""
    if seed is None:
        seed = envflags.fault_seed()
    if seed is None:
        return store
    if spec is None:
        spec = envflags.fault_spec()
    specs = parse_spec(spec) if spec else default_specs()
    return FaultStore(store, FaultSchedule(seed=seed, specs=specs))
