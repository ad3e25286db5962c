"""Content-addressed pack cache: the shared read-side tier in front of
the object store.

Ports ``volsync_tpu/repo/packcache.py`` unchanged, on the port's
store, index prefilter, lock factory and metrics stand-in.

The restore data plane (engine/restorepipe.py) fetches whole packs —
one GET per pack instead of one ranged GET per blob — and every fetch
funnels through this cache:

- **LRU with a byte budget** (``VOLSYNC_RESTORE_CACHE_MB``): pack
  bodies are immutable (content-addressed), so eviction is purely a
  memory decision — a re-fetch can never observe different bytes.
- **Single-flight**: N concurrent restores of the same snapshot ask
  for the same packs; the first asker becomes the fetch leader, the
  rest wait on its flight and share the body. The store sees each pack
  once — the restore-storm drill asserts this via GET counts.
- **Bloom prefilter** (repo/shardedindex.BloomPrefilter, the index's
  machinery): a lock-free "definitely not cached" pre-check keyed on
  the pack id. Cold restores are nearly all misses; the filter lets
  them skip the LRU probe-and-touch under the cache lock and go
  straight to flight registration. False positives just pay the probe.

The cache sits ON the ObjectStore interface (it is handed the
repository's already-ResilientStore-wrapped store), so retries,
breakers, and fault injection all happen underneath it — a fetch
leader's exhausted retry propagates to every waiter of that flight.

Observability: ``volsync_restore_cache_{hits,misses,evictions}_total``
count decisions (a follower that shares a leader's in-flight fetch
counts as a hit — the store round trip was saved), and every leader
fetch runs under a ``restore.fetch`` span feeding the flight recorder.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

from volsync_tpu_torch import envflags
from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS
from volsync_tpu_torch.objstore.store import NoSuchKey
from volsync_tpu_torch.obs import span
from volsync_tpu_torch.repo.compactindex import as_key_rows
from volsync_tpu_torch.repo.shardedindex import BloomPrefilter

# Module-cached metric children (no labels here, but the shared idiom
# stays: resolve once at import, not per call).
_M_HITS = GLOBAL_METRICS.restore_cache_hits
_M_MISSES = GLOBAL_METRICS.restore_cache_misses
_M_EVICTIONS = GLOBAL_METRICS.restore_cache_evictions

#: prefilter sizing — packs fetched over a cache lifetime; a restore
#: storm over a big repository stays far under this, and saturation is
#: exported in stats() for the operator who outgrows it
_PREFILTER_CAPACITY = 8192


class _Flight:
    """One in-flight pack fetch: the leader fills body/error and sets
    done; followers wait outside the cache lock."""

    __slots__ = ("done", "body", "error")

    def __init__(self):
        self.done = threading.Event()
        self.body: Optional[bytes] = None
        self.error: Optional[BaseException] = None


class PackCache:
    """Byte-budget LRU over immutable pack bodies with single-flight
    fetches (module docstring). Thread-safe; one instance may serve
    many concurrent restores (RestoreGroup does exactly that)."""

    def __init__(self, store, *, budget_bytes: Optional[int] = None,
                 rescue=None):
        self.store = store
        if budget_bytes is None:
            budget_bytes = envflags.restore_cache_mb() << 20
        self.budget_bytes = budget_bytes
        # pack_id -> bytes fallback when the primary object is absent
        # (erasure-coded estates have NO data/ primary: the repository's
        # ec_reconstruct decodes any k healthy shards and proves the
        # content-addressed pack id before the body is served). Pure
        # read — materializing a primary is the heal arms' job, not the
        # cache's.
        self.rescue = rescue
        self._lru: "OrderedDict[str, bytes]" = OrderedDict()
        self._bytes = 0
        self._inflight: dict[str, _Flight] = {}
        self._lock = lockcheck.make_lock("repo.packcache")
        self._filter = BloomPrefilter(_PREFILTER_CAPACITY)
        # local counters mirror the process-global metrics so one
        # bench/test can read ITS cache's numbers in isolation
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_fetched = 0

    # -- membership --------------------------------------------------------

    def _maybe_cached(self, pack_id: str) -> bool:
        """Lock-free prefilter read: False => definitely not in the
        LRU (never inserted since construction); True => probe it.
        Concurrent inserts can only turn bits on, so a racy read can
        produce a false negative ONLY for a pack whose insert is still
        mid-flight — and that pack's flight is found under the lock."""
        # deliberate benign race (see docstring): bits are monotonic,
        # a stale read only costs a lock-path probe
        return bool(self._filter.maybe_contains_rows(  # lint: ignore[VL402]
            as_key_rows([pack_id]))[0])

    # -- fetch -------------------------------------------------------------

    def get_pack(self, pack_id: str) -> bytes:
        """Whole pack body, from cache or a (single-flight) store GET."""
        probe = self._maybe_cached(pack_id)
        with self._lock:
            if probe:
                body = self._lru.get(pack_id)
                if body is not None:
                    self._lru.move_to_end(pack_id)
                    self.hits += 1
                    _M_HITS.inc()
                    return body
            flight = self._inflight.get(pack_id)
            leader = flight is None
            if leader:
                flight = self._inflight[pack_id] = _Flight()
        if not leader:
            flight.done.wait()
            if flight.error is not None:
                raise flight.error
            with self._lock:
                self.hits += 1  # shared a leader's round trip
            _M_HITS.inc()
            return flight.body
        try:
            with span("restore.fetch"):
                try:
                    body = self.store.get(f"data/{pack_id[:2]}/{pack_id}")
                except NoSuchKey:
                    if self.rescue is None:
                        raise
                    body = self.rescue(pack_id)
        except BaseException as e:  # noqa: BLE001 — every waiter of
            # this flight must see the leader's failure, whatever it is
            flight.error = e
            with self._lock:
                self._inflight.pop(pack_id, None)
            flight.done.set()
            raise
        flight.body = body
        with self._lock:
            self.misses += 1
            self.bytes_fetched += len(body)
            if len(body) <= self.budget_bytes:
                self._lru[pack_id] = body
                self._bytes += len(body)
                self._filter.add_one(as_key_rows([pack_id])[0])
                while self._bytes > self.budget_bytes:
                    _, evicted = self._lru.popitem(last=False)
                    self._bytes -= len(evicted)
                    self.evictions += 1
                    _M_EVICTIONS.inc()
            self._inflight.pop(pack_id, None)
        _M_MISSES.inc()
        flight.done.set()
        return body

    def invalidate(self, pack_id: str) -> bool:
        """Drop one cached body — the ONLY mutation of an entry.

        Pack bodies are immutable in the store, but the cache can have
        memorized a payload that arrived CORRUPTED (bit-rot, a wire
        flip): after a heal rewrites the primary, the healer must evict
        the poisoned body so the next get_pack re-fetches healthy
        bytes. The Bloom prefilter's bit stays set (bits only turn on);
        the re-fetch just pays one LRU probe. Returns True if a body
        was dropped. An in-flight fetch is untouched — its waiters get
        whatever the store returned, and THEIR verify decides."""
        with self._lock:
            body = self._lru.pop(pack_id, None)
            if body is None:
                return False
            self._bytes -= len(body)
            return True

    def get_ranges(self, pack_id: str,
                   spans: list[tuple[int, int]]) -> list[memoryview]:
        """Coalesced ranged read: ONE pack fetch serves every
        ``(offset, length)`` span — the planner's per-pack blob list
        rides this instead of per-blob ``get_range`` round trips.

        Returns zero-copy read-only memoryview slices of the cached
        body (safe: pack bodies are immutable ``bytes``; a view pins
        the body alive past eviction, which only delays the free)."""
        body = memoryview(self.get_pack(pack_id)).toreadonly()
        return [body[off:off + length] for off, length in spans]

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "bytes_fetched": self.bytes_fetched,
                "bytes_cached": self._bytes,
                "packs_cached": len(self._lru),
                "budget_bytes": self.budget_bytes,
                "prefilter_saturation": round(self._filter.saturation(), 4),
            }
