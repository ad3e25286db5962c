"""Fleet replica plane: N fenced mover replicas on one repository.

Ports ``volsync_tpu/service/fleet.py`` whole. ``Replica`` and
``ReplicaGroup`` take ``device=`` (CUDA by default, raising where CUDA
is absent before a store is opened or a port bound) and pass it to both
the replica's ``Repository.open`` and its ``MoverJaxServer``. The
``fleet/`` keys and the stamp JSON are the reference's, so either
package's router reads the other's stamps.

Many ``mover-jax`` server replicas run as independent fenced writers
(repo/repository.py generations) into ONE shared repository, behind a
front door that spreads load by advertised capacity. This module is
that composition:

- :class:`ReplicaStamp` / :class:`ReplicaHeartbeat` — each replica
  publishes a small heartbeat record at ``fleet/<replica-id>`` in the
  shared object store (a lease/TTL idiom, with the store as the
  bulletin board): address, admission headroom, scheduler backlog,
  writer id + generation, beat seq, wall-clock stamp. A stamp older
  than VOLSYNC_FLEET_TTL_S is a presumed-dead replica; ``repair``
  clears stamps past the lock-stale horizon like any other
  crashed-writer marker.
- :class:`FleetRouter` — reads the stamps and routes new streams to
  the live replica with the most headroom (ties: least backlog, then
  replica id — deterministic). It also answers the admission
  controller's ``sibling_fn`` from a CACHED snapshot only (no store
  I/O on the shed path, which runs under the admission lock), so a
  hot replica's shed carries ``x-volsync-sibling`` pointing at a
  sibling that advertised headroom — cross-replica admission.
- :class:`Replica` — one fleet member: a MoverJaxServer (service
  plane: admission, WDRR + deadline scheduling, credit backpressure)
  plus its OWN fenced Repository writer over its OWN store stack
  (distinct writer ids — real multi-writer fencing, and a per-replica
  fault-injection point for the drills), plus the heartbeat.
  ``kill()`` is the drill primitive: the process "dies" — no drain,
  no stamp retirement, locks left to go stale — exactly what a killed
  pod leaves behind.
- :class:`ReplicaGroup` — the N-replica runtime: builds/starts the
  fleet, owns the router, and drives backup jobs with failover —
  a job shed by a hot replica follows the sibling hint, a job whose
  replica died mid-stream is re-driven on a sibling (streams never
  resume mid-way: chunk streams are re-driven whole), and
  ``volsync_fleet_failovers_total`` counts each hop.

The replica failure drill (tests/test_torch_fleet.py) kills replicas
mid-stream under seeded fault schedules and asserts the contract end
to end: failover completes every admitted job, the dead writer's stale
lock is taken over and fenced, its late publishes raise
StaleWriterError, and ``check(read_data=True)`` + restores stay
byte-identical.
"""

from __future__ import annotations

import json
import logging
import threading
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Callable, Iterable, Optional

from volsync_tpu_torch import envflags, resolve_device
from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS
from volsync_tpu_torch.obs import record_trigger, span
from volsync_tpu_torch.objstore.store import NoSuchKey
from volsync_tpu_torch.service.admission import AdmissionRejected

log = logging.getLogger("volsync_tpu_torch.fleet")

#: where replica heartbeat stamps live in the shared object store
FLEET_PREFIX = "fleet/"


def _utcnow() -> datetime:
    return datetime.now(timezone.utc)


def _parse_time(value: str) -> datetime:
    dt = datetime.fromisoformat(value)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt


@dataclass
class ReplicaStamp:
    """One replica's heartbeat record, as published at
    ``fleet/<replica_id>``. ``time`` is a wall-clock ISO-8601 UTC
    stamp (the same convention as lock objects, so repair's staleness
    arithmetic and the test backdating helpers apply unchanged)."""

    replica_id: str
    address: str
    headroom: int
    backlog: int
    writer_id: str
    generation: int
    seq: int
    time: str

    def to_json(self) -> bytes:
        return json.dumps({
            "replica_id": self.replica_id,
            "address": self.address,
            "headroom": self.headroom,
            "backlog": self.backlog,
            "writer_id": self.writer_id,
            "generation": self.generation,
            "seq": self.seq,
            "time": self.time,
        }).encode()

    @classmethod
    def from_json(cls, payload: bytes) -> "ReplicaStamp":
        """Raises ValueError on a torn/malformed stamp (readers treat
        it as absent; repair treats it as debris)."""
        try:
            raw = json.loads(payload)
            return cls(replica_id=str(raw["replica_id"]),
                       address=str(raw["address"]),
                       headroom=int(raw["headroom"]),
                       backlog=int(raw["backlog"]),
                       writer_id=str(raw.get("writer_id", "")),
                       generation=int(raw.get("generation", 0)),
                       seq=int(raw.get("seq", 0)),
                       time=str(raw["time"]))
        except (KeyError, TypeError, ValueError) as exc:
            raise ValueError(f"torn replica stamp: {exc}") from exc

    def age(self, now: Optional[datetime] = None) -> float:
        return ((now or _utcnow()) - _parse_time(self.time)).total_seconds()

    def expired(self, ttl: float, now: Optional[datetime] = None) -> bool:
        return self.age(now) > ttl


class ReplicaHeartbeat:
    """Publishes one replica's stamp every ``beat_seconds``.

    The beat is best-effort by design: a failed put (store weather, a
    partition) is logged and counted, never fatal — the replica keeps
    serving, and the stamp simply ages toward the TTL until a beat
    lands again. ``stop(retire=True)`` deletes the stamp (clean
    shutdown); a killed replica never retires, so its stamp expires —
    which is exactly the liveness signal the router needs."""

    def __init__(self, store, replica_id: str, address: str, *,
                 headroom_fn: Callable[[], int],
                 backlog_fn: Optional[Callable[[], int]] = None,
                 writer_fn: Optional[Callable[[], str]] = None,
                 generation_fn: Optional[Callable[[], int]] = None,
                 beat_seconds: Optional[float] = None):
        self.store = store
        self.replica_id = replica_id
        self.address = address
        self._headroom = headroom_fn
        self._backlog = backlog_fn
        self._writer = writer_fn
        self._generation = generation_fn
        self.beat_seconds = (envflags.fleet_beat_seconds()
                             if beat_seconds is None else beat_seconds)
        self._lock = lockcheck.make_lock(f"fleet.beat.{replica_id}")
        self._seq = 0
        self.missed = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def key(self) -> str:
        return f"{FLEET_PREFIX}{self.replica_id}"

    def beat(self) -> ReplicaStamp:
        """Compose and publish one stamp (raises on store failure; the
        background loop is the layer that swallows and counts)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        stamp = ReplicaStamp(
            replica_id=self.replica_id,
            address=self.address,
            headroom=max(0, int(self._headroom())),
            backlog=(max(0, int(self._backlog()))
                     if self._backlog is not None else 0),
            writer_id=self._writer() if self._writer is not None else "",
            generation=(int(self._generation())
                        if self._generation is not None else 0),
            seq=seq,
            time=_utcnow().isoformat())
        self.store.put(self.key, stamp.to_json())
        return stamp

    def _run(self) -> None:
        while not self._stop.wait(self.beat_seconds):
            try:
                self.beat()
            except Exception as exc:  # noqa: BLE001 — the beat must
                # survive store weather; the stamp just ages meanwhile
                self.missed += 1
                log.warning("fleet heartbeat %s failed: %s",
                            self.replica_id, exc)

    def start(self) -> "ReplicaHeartbeat":
        try:
            self.beat()  # first stamp lands before start() returns
        except Exception as exc:  # noqa: BLE001 — same contract as _run
            self.missed += 1
            log.warning("fleet heartbeat %s failed: %s",
                        self.replica_id, exc)
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"fleet-beat-{self.replica_id}")
        self._thread.start()
        return self

    def stop(self, *, retire: bool = True) -> None:
        """``retire=False`` is the kill path: the thread dies but the
        stamp stays, aging toward the TTL like a crashed pod's."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if retire:
            try:
                self.store.delete(self.key)
            except Exception as exc:  # noqa: BLE001 — best-effort;
                # repair reaps what a failed retire leaves behind
                log.warning("fleet stamp retire %s failed: %s",
                            self.replica_id, exc)


class FleetRouter:
    """Routes by advertised headroom over the ``fleet/`` stamps.

    ``refresh()`` does the store I/O and caches the result;
    ``pick()`` refreshes then chooses; ``sibling_hint()`` serves the
    CACHE only — it is called from the admission shed path (under the
    admission lock), where store I/O is forbidden (VL101) and latency
    is the <10 ms shed budget. The cache refreshes on every pick and
    on every heartbeat beat via :meth:`note_stamp`, so hints track the
    fleet at heartbeat granularity."""

    def __init__(self, store, *, ttl_seconds: Optional[float] = None):
        self.store = store
        self.ttl = (envflags.fleet_ttl_seconds()
                    if ttl_seconds is None else ttl_seconds)
        self._lock = lockcheck.make_lock("fleet.router")
        self._cache: dict[str, ReplicaStamp] = {}
        self._routed_c: dict = {}
        self._headroom_g: dict = {}

    # -- cache maintenance ---------------------------------------------------

    def refresh(self) -> list[ReplicaStamp]:
        """Re-read every stamp from the store; torn stamps are skipped,
        expired stamps drop out of the cache (dead replicas)."""
        fresh: dict[str, ReplicaStamp] = {}
        for key in list(self.store.list(FLEET_PREFIX)):
            try:
                stamp = ReplicaStamp.from_json(self.store.get(key))
            except (NoSuchKey, ValueError):
                continue  # retired mid-scan / torn: not routable
            if not stamp.expired(self.ttl):
                fresh[stamp.replica_id] = stamp
        with self._lock:
            self._cache = fresh
            stamps = list(fresh.values())
        for stamp in stamps:
            self._headroom_gauge(stamp.replica_id).set(stamp.headroom)
        return stamps

    def note_stamp(self, stamp: ReplicaStamp) -> None:
        """Fold one freshly published stamp into the cache (replicas
        feed their own beats in so sibling hints stay warm without the
        router polling)."""
        with self._lock:
            self._cache[stamp.replica_id] = stamp
        self._headroom_gauge(stamp.replica_id).set(stamp.headroom)

    def forget(self, replica_id: str) -> None:
        with self._lock:
            self._cache.pop(replica_id, None)

    def live(self) -> list[ReplicaStamp]:
        """Unexpired stamps from the cache (no I/O)."""
        now = _utcnow()
        with self._lock:
            stamps = list(self._cache.values())
        return [s for s in stamps if not s.expired(self.ttl, now)]

    # -- routing -------------------------------------------------------------

    @staticmethod
    def _rank(stamp: ReplicaStamp) -> tuple:
        # most headroom first; ties broken by least backlog, then
        # replica id so two routers with the same picture agree
        return (-stamp.headroom, stamp.backlog, stamp.replica_id)

    def pick(self, exclude: Iterable[str] = ()) -> Optional[ReplicaStamp]:
        """Route one new stream: refresh, then the best live replica
        not in ``exclude`` (None when the whole fleet is dead/full)."""
        with span("fleet.route"):
            self.refresh()
            skip = set(exclude)
            live = [s for s in self.live()
                    if s.replica_id not in skip and s.headroom > 0]
            if not live:
                return None
            best = min(live, key=self._rank)
            self._routed_counter(best.replica_id).inc()
            return best

    def sibling_hint(self, self_id: str) -> Optional[str]:
        """Cache-only (shed path, runs under the admission lock): the
        address of the best live sibling with headroom, or None."""
        candidates = [s for s in self.live()
                      if s.replica_id != self_id and s.headroom > 0]
        if not candidates:
            return None
        return min(candidates, key=self._rank).address

    # -- metrics plumbing ----------------------------------------------------

    def _routed_counter(self, replica: str):
        c = self._routed_c.get(replica)
        if c is None:
            c = self._routed_c[replica] = \
                GLOBAL_METRICS.fleet_routed_total.labels(replica=replica)
        return c

    def _headroom_gauge(self, replica: str):
        g = self._headroom_g.get(replica)
        if g is None:
            g = self._headroom_g[replica] = \
                GLOBAL_METRICS.fleet_replica_headroom.labels(replica=replica)
        return g


class Replica:
    """One fleet member: gRPC server + fenced repository writer +
    heartbeat, all over this replica's OWN ``store`` (its private view
    of the shared backing store — the per-replica fault-injection
    point). ``stamp_store`` (default: ``store``) is where heartbeat
    stamps publish; the chaos drills pass the replica's faulted stack
    for both so a partitioned replica's beats fail like its data.

    ``server_kwargs`` pass through to MoverJaxServer (token, tenants,
    admission caps, deadline_classes, ...). ``device`` (None: CUDA) is
    where both the repository writer and the server hash."""

    def __init__(self, replica_id: str, store, *,
                 router: Optional[FleetRouter] = None,
                 stamp_store=None,
                 password: Optional[str] = None,
                 beat_seconds: Optional[float] = None,
                 device=None,
                 **server_kwargs):
        from volsync_tpu_torch.repo.repository import Repository
        from volsync_tpu_torch.service.server import MoverJaxServer

        self.device = resolve_device(device)
        self.replica_id = replica_id
        self.store = store
        self.router = router
        self.repo = Repository.open(store, password, device=self.device)
        if router is not None:
            server_kwargs.setdefault(
                "sibling_fn", lambda: router.sibling_hint(replica_id))
        self.server = MoverJaxServer(device=self.device, **server_kwargs)
        self.heartbeat = ReplicaHeartbeat(
            stamp_store if stamp_store is not None else store,
            replica_id, self.address,
            headroom_fn=self.server.admission.headroom,
            backlog_fn=(self.server.scheduler.queued_total
                        if self.server.scheduler is not None else None),
            writer_fn=lambda: self.repo.writer_id,
            generation_fn=lambda: self.repo.generation,
            beat_seconds=beat_seconds)
        self._killed = False

    @property
    def address(self) -> str:
        return f"{self.server.host}:{self.server.port}"

    @property
    def token(self) -> str:
        return self.server.token

    def start(self) -> "Replica":
        self.server.start()
        self.heartbeat.start()
        if self.router is not None:
            try:
                self.router.note_stamp(self.heartbeat.beat())
            except Exception as exc:  # noqa: BLE001 — cache warm-up
                # only; the background beat keeps trying
                log.warning("fleet start beat %s failed: %s",
                            self.replica_id, exc)
        return self

    def beat(self) -> None:
        """One explicit heartbeat (deterministic tests drive this
        instead of waiting out beat_seconds)."""
        stamp = self.heartbeat.beat()
        if self.router is not None:
            self.router.note_stamp(stamp)

    def backup(self, tree, *, tenant: str = "fleet",
               hostname: Optional[str] = None) -> str:
        """One admission-ticketed backup job through this replica's
        fenced writer: the stream is admitted (or shed with a sibling
        hint) by the same controller that gates the gRPC plane, then
        TreeBackup runs against the shared repository under this
        replica's writer generation. Returns the snapshot id."""
        from volsync_tpu_torch.engine.backup import TreeBackup

        if self._killed:
            raise RuntimeError(f"replica {self.replica_id} is dead")
        ticket = self.server.admission.admit_stream(tenant)
        try:
            with span("fleet.backup"):
                snap, _stats = TreeBackup(self.repo, workers=1).run(
                    tree, hostname=hostname or self.replica_id)
            return snap
        finally:
            self.server.admission.release(ticket)

    def stop(self) -> None:
        """Clean shutdown: retire the stamp, drain the server."""
        if self._killed:
            return
        self.heartbeat.stop(retire=True)
        if self.router is not None:
            self.router.forget(self.replica_id)
        self.server.stop()

    def kill(self) -> None:
        """Drill primitive — die like a killed pod: no drain, no stamp
        retirement, repository locks left to go stale. The stamp ages
        past the TTL (router stops routing here), the stale lock is
        taken over and this writer fenced by whoever needs it, and any
        late publish from this replica raises StaleWriterError."""
        self._killed = True
        self.heartbeat.stop(retire=False)
        record_trigger("replica_kill", replica=self.replica_id)
        # hard gRPC stop: in-flight calls abort, nothing drains
        self.server._server.stop(0)


class ReplicaGroup:
    """The N-replica runtime the drills and the bench drive.

    ``stores`` is one store per replica (each replica's own — possibly
    faulted — view of the shared backing store); ``router_store`` is
    the view the front door reads stamps through (default: the first
    replica's). Jobs submitted via :meth:`submit_backup` are routed by
    headroom and failed over across sheds and replica deaths until one
    replica completes them (bounded by ``max_hops``). Every replica
    runs on ``device`` (None: CUDA)."""

    def __init__(self, stores: list, *, router_store=None,
                 password: Optional[str] = None,
                 ttl_seconds: Optional[float] = None,
                 beat_seconds: Optional[float] = None,
                 device=None,
                 **server_kwargs):
        if not stores:
            raise ValueError("a fleet needs at least one replica store")
        device = resolve_device(device)
        self.router = FleetRouter(
            router_store if router_store is not None else stores[0],
            ttl_seconds=ttl_seconds)
        self.replicas = [
            Replica(f"r{i:02d}", store, router=self.router,
                    password=password, beat_seconds=beat_seconds,
                    device=device, **server_kwargs)
            for i, store in enumerate(stores)]
        self._by_id = {r.replica_id: r for r in self.replicas}
        self._by_address = {r.address: r for r in self.replicas}

    def start(self) -> "ReplicaGroup":
        for r in self.replicas:
            r.start()
        return self

    def stop(self) -> None:
        for r in self.replicas:
            r.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def beat_all(self) -> None:
        """One synchronous heartbeat round (deterministic tests). Keeps
        the background beat's contract: one replica's store weather
        fails ITS beat (counted, stamp ages), never the fleet round."""
        for r in self.replicas:
            if r._killed:
                continue
            try:
                r.beat()
            except Exception as exc:  # noqa: BLE001 — best-effort beat
                r.heartbeat.missed += 1
                log.warning("fleet beat %s failed: %s", r.replica_id, exc)

    def kill(self, replica_id: str) -> Replica:
        r = self._by_id[replica_id]
        r.kill()
        return r

    def replica(self, replica_id: str) -> Replica:
        return self._by_id[replica_id]

    def submit_backup(self, tree, *, tenant: str = "fleet",
                      hostname: Optional[str] = None,
                      max_hops: Optional[int] = None) -> tuple[str, str]:
        """Route one backup job and fail it over until it completes:
        returns (snapshot_id, replica_id). A shed follows the shed's
        sibling hint when it names a live replica (cross-replica
        admission); a death mid-job re-routes through the router with
        the dead replica excluded. Raises the last error once
        ``max_hops`` replicas (default: fleet size * 2) have failed."""
        hops = (len(self.replicas) * 2 if max_hops is None
                else max(1, max_hops))
        exclude: set[str] = set()
        target: Optional[Replica] = None
        last_error: Optional[BaseException] = None
        for attempt in range(hops):
            if target is None:
                stamp = self.router.pick(exclude=exclude)
                if stamp is None:
                    # nobody advertises headroom: widen to any replica
                    # we have not tried yet (stamps may just be stale)
                    candidates = [r for r in self.replicas
                                  if r.replica_id not in exclude
                                  and not r._killed]
                    if not candidates:
                        break
                    target = candidates[0]
                else:
                    target = self._by_id.get(stamp.replica_id)
                    if target is None:
                        exclude.add(stamp.replica_id)
                        continue
            if attempt > 0:
                GLOBAL_METRICS.fleet_failovers_total.inc()
            try:
                snap = target.backup(tree, tenant=tenant,
                                     hostname=hostname)
                return snap, target.replica_id
            except AdmissionRejected as rej:
                last_error = rej
                exclude.add(target.replica_id)
                # cross-replica admission: the shed names where to go
                sibling = (self._by_address.get(rej.sibling)
                           if rej.sibling else None)
                if sibling is not None and not sibling._killed \
                        and sibling.replica_id not in exclude:
                    target = sibling
                else:
                    target = None
            except Exception as exc:  # noqa: BLE001 — replica death is
                # exactly what failover exists for; the last error
                # surfaces if every hop fails
                last_error = exc
                exclude.add(target.replica_id)
                target = None
        if last_error is not None:
            raise last_error
        raise RuntimeError("no live replica accepted the job")
