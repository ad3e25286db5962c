"""Sharded blob index: per-shard locks + a blocked-bloom cold-miss
prefilter in front of the flat CompactIndex.

Ports ``volsync_tpu/repo/shardedindex.py`` unchanged (host numpy), on
the port's envflags, lock factory and metrics stand-in.

At million-to-billion-chunk scale the dedup *index* — not the hash —
becomes the bottleneck (PAPERS.md, arxiv 2602.22237): the write pipeline
batches chunking and hashing on device, but every chunk's dedup
decision still funneled through one repository-wide mutex into a
per-key Python probe loop. This module removes both serializers:

* **Sharding.** Blob ids are uniform SHA-256, so splitting on the top
  ``log2(S)`` key bits is free and perfectly balanced. Each shard is a
  private ``CompactIndex`` behind its own lockcheck-registered lock
  (``repo.index.shard{i}``), so concurrent backups and the pipeline's
  stages contend on ~1/S of the keyspace. The slot hash uses the *low*
  bits of the same key word, so shard routing and in-shard placement
  stay independent. Whole-index operations (items/vacuum/copy/
  snapshot) visit shards one at a time in ascending order and never
  nest shard locks, keeping the lock-order graph trivially acyclic.

* **Batching.** ``contains_many``/``lookup_many`` take a whole key
  batch (hex list or ``(N, 32)`` array — see
  ``compactindex.as_key_rows``), partition it by shard, and resolve
  each partition with CompactIndex's vectorized numpy probe — a
  handful of gather/compare passes instead of N Python loops.

* **Prefilter.** A per-shard blocked-bloom filter answers "definitely
  absent" for the first-backup workload where nearly every query is a
  miss, skipping the probe entirely. It lives under the shard's lock
  (a shared filter would need atomic ``|=`` across threads — a lost
  update there would be a *false negative*, which a bloom filter must
  never produce). Removes don't clear bits (stale "maybe" is just an
  extra probe); vacuum and auto-grow rebuild from live keys.

Lock order: ``repo.state`` -> ``repo.index.shard{i}``. The index never
calls back into the repository or the object store, so no blocking
work ever runs under a shard lock.
"""

from __future__ import annotations

import itertools
from typing import Iterator, Optional

import numpy as np

from volsync_tpu_torch import envflags
from volsync_tpu_torch.analysis import lockcheck
from volsync_tpu_torch.metrics import GLOBAL as GLOBAL_METRICS
from volsync_tpu_torch.repo.compactindex import CompactIndex, as_key_rows

# Metric children resolved once: .labels() costs a dict lookup under a
# lock per call — real money on the per-batch query path.
_M_HIT = GLOBAL_METRICS.index_queries.labels(result="hit")
_M_MISS = GLOBAL_METRICS.index_queries.labels(result="miss")
_M_SKIP = GLOBAL_METRICS.index_prefilter.labels(outcome="skip")
_M_PASS = GLOBAL_METRICS.index_prefilter.labels(outcome="pass")
_M_FP = GLOBAL_METRICS.index_prefilter.labels(outcome="false_positive")


# Batches at or below this many keys per shard take the scalar-probe
# path: the vectorized probe's fixed numpy setup (~30us per touched
# shard) only amortizes once partitions grow past a few dozen keys
# (measured crossover ~32-48 keys/shard on CPU; see bench.py index).
_SMALL_BATCH_PER_SHARD = 32


def _pow2ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class BloomPrefilter:
    """Blocked-bloom filter over ``(N, 4)`` uint64 key rows.

    One cache line of state per key lookup: key word 1 (low bits) picks
    a 64-bit block, ``K`` 6-bit fields of key word 2 pick bits within
    it. Words 1/2 are independent of word 0 (shard routing + slot
    hash), so filter placement never correlates with table collisions.
    Sized at ~16 bits/key => ~25% fill at capacity => ~0.4% false
    positives with K=4. Add-only; the owner rebuilds (``capacity`` is
    the advisory trigger) after removes accumulate or live count
    outgrows it.
    """

    K = 4
    BITS_PER_KEY = 16

    __slots__ = ("_blocks", "_bmask", "capacity")

    def __init__(self, capacity: int = 4096):
        nblocks = _pow2ceil(max(64, capacity * self.BITS_PER_KEY // 64))
        self._blocks = np.zeros((nblocks,), dtype=np.uint64)
        self._bmask = np.uint64(nblocks - 1)
        self.capacity = nblocks * 64 // self.BITS_PER_KEY

    @classmethod
    def _masks(cls, w2: np.ndarray) -> np.ndarray:
        m = np.zeros(w2.shape, dtype=np.uint64)
        one = np.uint64(1)
        six3f = np.uint64(63)
        for i in range(cls.K):
            m |= one << ((w2 >> np.uint64(6 * i)) & six3f)
        return m

    def add_rows(self, k4: np.ndarray):
        if not k4.shape[0]:
            return
        b = (k4[:, 1] & self._bmask).astype(np.int64)
        # |= via ufunc.at: plain fancy-assign would lose all but one
        # update when a batch maps two keys to the same block
        np.bitwise_or.at(self._blocks, b, self._masks(k4[:, 2]))

    def add_one(self, k4) -> None:
        """Scalar add in plain-int arithmetic: the per-insert hot path
        (every new blob) — numpy scalar ops here would cost more than
        the table probe the filter fronts."""
        b = int(k4[1]) & int(self._bmask)
        w2 = int(k4[2])
        m = 0
        for i in range(self.K):
            m |= 1 << ((w2 >> (6 * i)) & 63)
        self._blocks[b] |= np.uint64(m)

    def maybe_contains_rows(self, k4: np.ndarray) -> np.ndarray:
        """False => definitely absent; True => probe the shard."""
        b = (k4[:, 1] & self._bmask).astype(np.int64)
        m = self._masks(k4[:, 2])
        return (self._blocks[b] & m) == m

    def saturation(self) -> float:
        """Set-bit fraction (0..1); ~0.25 at design capacity."""
        return float(np.unpackbits(self._blocks.view(np.uint8)).mean())


class ShardedBlobIndex:
    """Drop-in for the repository's ``CompactIndex`` slot, plus the
    batched (``contains_many``/``lookup_many``) and concurrent-writer
    APIs. Unlike ``CompactIndex`` it IS thread-safe: every shard access
    happens under that shard's lock, so callers (``Repository.
    has_blobs``, concurrent ``TreeBackup`` workers) need no outer
    mutex for index reads. Entry values keep CompactIndex's tuple
    contract ``(pack, type, offset, length, raw_length)``.
    """

    def __init__(self, shards: Optional[int] = None,
                 capacity: int = 1024,
                 prefilter: Optional[bool] = None):
        nshards = _pow2ceil(shards if shards is not None
                            else envflags.index_shards())
        self._nshards = nshards
        self._shard_bits = nshards.bit_length() - 1
        self._shards = [CompactIndex(capacity=max(16, capacity // nshards))
                        for _ in range(nshards)]
        self._locks = [lockcheck.make_lock(f"repo.index.shard{i}")
                       for i in range(nshards)]
        self._prefilter_on = (envflags.index_prefilter()
                              if prefilter is None else prefilter)
        self._filters: list[Optional[BloomPrefilter]] = [
            BloomPrefilter() if self._prefilter_on else None
            for _ in range(nshards)]

    # -- shard routing ------------------------------------------------------

    def _shard_of(self, k4) -> int:
        if self._shard_bits == 0:
            return 0
        return int(k4[0]) >> (64 - self._shard_bits)

    def _shard_ids(self, k4: np.ndarray) -> np.ndarray:
        if self._shard_bits == 0:
            return np.zeros((k4.shape[0],), dtype=np.int64)
        return (k4[:, 0] >> np.uint64(64 - self._shard_bits)).astype(
            np.int64)

    # -- prefilter maintenance (caller holds the shard lock) ----------------

    def _rebuild_filter(self, s: int):
        if not self._prefilter_on:
            return
        rows = self._shards[s].live_key_rows()
        f = BloomPrefilter(capacity=max(4096, rows.shape[0] * 2))
        f.add_rows(rows)
        self._filters[s] = f
        self._update_saturation()

    def _update_saturation(self):
        sats = [f.saturation() for f in self._filters if f is not None]
        if sats:
            GLOBAL_METRICS.index_prefilter_saturation.set(max(sats))

    def prefilter_saturation(self) -> float:
        """Worst per-shard filter fill fraction (0.0 when disabled)."""
        sats = [f.saturation() for f in self._filters if f is not None]
        return max(sats) if sats else 0.0

    # -- scalar mapping API (CompactIndex-compatible) -----------------------

    def __len__(self) -> int:
        return sum(len(sh) for sh in self._shards)

    def __contains__(self, hex_id: str) -> bool:
        k4 = CompactIndex._key4(hex_id)
        s = self._shard_of(k4)
        with self._locks[s]:
            return self._shards[s]._probe(k4)[1] >= 0

    def lookup(self, hex_id: str):
        k4 = CompactIndex._key4(hex_id)
        s = self._shard_of(k4)
        sh = self._shards[s]
        with self._locks[s]:
            j = sh._probe(k4)[1]
            return sh._decode_row(j) if j >= 0 else None

    def insert(self, hex_id: str, pack: str, btype: str, offset: int,
               length: int, raw_length: int, *, replace: bool = True) -> bool:
        k4 = CompactIndex._key4(hex_id)
        s = self._shard_of(k4)
        with self._locks[s]:
            changed = self._shards[s].insert(
                hex_id, pack, btype, offset, length, raw_length,
                replace=replace, _k4=k4)
            f = self._filters[s]
            if changed and f is not None:
                f.add_one(k4)
                if len(self._shards[s]) > f.capacity:
                    self._rebuild_filter(s)
            return changed

    def remove(self, hex_id: str) -> bool:
        k4 = CompactIndex._key4(hex_id)
        s = self._shard_of(k4)
        with self._locks[s]:
            # the filter keeps the key's bits (stale "maybe" costs one
            # probe, clearing could break other keys); vacuum rebuilds
            return self._shards[s].remove(hex_id)

    def clear(self):
        for s in range(self._nshards):
            with self._locks[s]:
                self._shards[s].clear()
                if self._prefilter_on:
                    self._filters[s] = BloomPrefilter()

    def items(self) -> Iterator[tuple[str, tuple]]:
        """Live entries across shards. Each shard's snapshot is taken
        under its lock at call time (CompactIndex.items snapshots
        eagerly), so mutation while iterating is safe here too."""
        parts = []
        for s in range(self._nshards):
            with self._locks[s]:
                parts.append(self._shards[s].items())
        return itertools.chain.from_iterable(parts)

    def keys(self) -> Iterator[str]:
        parts = []
        for s in range(self._nshards):
            with self._locks[s]:
                parts.append(self._shards[s].keys())
        return itertools.chain.from_iterable(parts)

    __iter__ = keys

    def copy(self) -> "ShardedBlobIndex":
        """Consistent-per-shard snapshot copy (shards are copied one at
        a time, so cross-shard consistency needs an outer barrier —
        the repository holds repo.state across check()/prune())."""
        new = ShardedBlobIndex.__new__(ShardedBlobIndex)
        new._nshards = self._nshards
        new._shard_bits = self._shard_bits
        new._prefilter_on = self._prefilter_on
        new._locks = [lockcheck.make_lock(f"repo.index.shard{i}")
                      for i in range(self._nshards)]
        new._shards = []
        new._filters = []
        for s in range(self._nshards):
            with self._locks[s]:
                new._shards.append(self._shards[s].copy())
                new._filters.append(None)
        if new._prefilter_on:
            for s in range(new._nshards):
                new._filters[s] = BloomPrefilter()
                rows = new._shards[s].live_key_rows()
                new._filters[s].add_rows(rows)
        return new

    def vacuum(self):
        for s in range(self._nshards):
            with self._locks[s]:
                self._shards[s].vacuum()
                self._rebuild_filter(s)

    def snapshot_arrays(self) -> tuple[np.ndarray, np.ndarray, list]:
        """Concatenated per-shard snapshots with pack codes remapped
        into one merged pack_names list — same contract as
        CompactIndex.snapshot_arrays (prune's liveness math)."""
        all_keys: list[np.ndarray] = []
        all_codes: list[np.ndarray] = []
        names: list[str] = []
        name_idx: dict[str, int] = {}
        for s in range(self._nshards):
            with self._locks[s]:
                keys, codes, pack_names = self._shards[s].snapshot_arrays()
            remap = np.zeros((len(pack_names) or 1,), dtype=np.uint32)
            for i, p in enumerate(pack_names):
                gi = name_idx.get(p)
                if gi is None:
                    gi = name_idx[p] = len(names)
                    names.append(p)
                remap[i] = gi
            all_keys.append(keys)
            all_codes.append(remap[codes] if codes.shape[0] else codes)
        if not all_keys:
            return np.zeros((0,), dtype="S32"), np.zeros(
                (0,), dtype=np.uint32), names
        return (np.concatenate(all_keys), np.concatenate(all_codes),
                names)

    def live_packs(self) -> set[str]:
        out: set[str] = set()
        for s in range(self._nshards):
            with self._locks[s]:
                out |= self._shards[s].live_packs()
        return out

    def nbytes(self) -> int:
        total = sum(sh.nbytes() for sh in self._shards)
        total += sum(int(f._blocks.nbytes) for f in self._filters
                     if f is not None)
        return total

    # -- batched API --------------------------------------------------------

    def _probe_small(self, k4: np.ndarray, mask: np.ndarray,
                     entries: Optional[list]):
        """Small-batch body of ``_probe_batch``: scalar probes grouped
        so each touched shard's lock is taken once. Below a few dozen
        keys per shard the vectorized probe loses to its own fixed numpy
        costs (array setup per shard partition), so tiny batches —
        e.g. one chunk batch of a small file — take this path. Skips
        the prefilter (a scalar probe costs about as much as the bloom
        check it would save); prefilter metrics only move on the
        vectorized path."""
        rows = k4.tolist()
        by_shard: dict[int, list[int]] = {}
        for i, s in enumerate(self._shard_ids(k4).tolist()):
            by_shard.setdefault(s, []).append(i)
        for s in sorted(by_shard):
            sh = self._shards[s]
            with self._locks[s]:
                for i in by_shard[s]:
                    _, j = sh._probe(rows[i])
                    if j >= 0:
                        mask[i] = True
                        if entries is not None:
                            entries[i] = sh._decode_row(j)
        nhit = int(mask.sum())
        if nhit:
            _M_HIT.inc(nhit)
        if mask.shape[0] - nhit:
            _M_MISS.inc(mask.shape[0] - nhit)
        return mask, entries

    def _probe_batch(self, k4: np.ndarray, decode: bool):
        """Shared body of contains_many/lookup_many: partition the batch
        by shard, prefilter each partition, vector-probe the survivors
        under the shard lock. Returns (bool mask, entries-or-None) plus
        metric bookkeeping."""
        n = int(k4.shape[0])
        mask = np.zeros((n,), dtype=bool)
        entries: Optional[list] = [None] * n if decode else None
        if n == 0:
            return mask, entries
        if n <= _SMALL_BATCH_PER_SHARD * self._nshards:
            return self._probe_small(k4, mask, entries)
        # one argsort partitions the batch by shard (vs a full
        # boolean-scan pass per shard, which dominates small batches)
        sid = self._shard_ids(k4)
        order = np.argsort(sid, kind="stable")
        bounds = np.searchsorted(sid[order],
                                 np.arange(self._nshards + 1))
        skips = passes = false_pos = 0
        for s in range(self._nshards):
            a, b = int(bounds[s]), int(bounds[s + 1])
            if a == b:
                continue
            sel = order[a:b]
            rows = k4[sel]
            sh = self._shards[s]
            with self._locks[s]:
                f = self._filters[s]
                maybe = (f.maybe_contains_rows(rows) if f is not None
                         else np.ones((sel.shape[0],), dtype=bool))
                hit_rows = np.full((sel.shape[0],), -1, dtype=np.int64)
                if maybe.any():
                    hit_rows[maybe] = sh.probe_rows(rows[maybe])
                hits = hit_rows >= 0
                if entries is not None and hits.any():
                    decoded = sh.decode_rows(hit_rows[hits])
                    for i, gi in enumerate(sel[hits].tolist()):
                        entries[gi] = decoded[i]
            mask[sel] = hits
            if f is not None:
                nskip = int((~maybe).sum())
                skips += nskip
                passes += int(hits.sum())
                false_pos += sel.shape[0] - nskip - int(hits.sum())
        nhit = int(mask.sum())
        if nhit:
            _M_HIT.inc(nhit)
        if n - nhit:
            _M_MISS.inc(n - nhit)
        if skips:
            _M_SKIP.inc(skips)
        if passes:
            _M_PASS.inc(passes)
        if false_pos:
            _M_FP.inc(false_pos)
        return mask, entries

    def contains_many(self, keys) -> np.ndarray:
        """Batched membership: blob-id batch -> ``(N,)`` bool mask. One
        vectorized probe per touched shard; definite misses never reach
        the probe when the prefilter is on."""
        return self._probe_batch(as_key_rows(keys), decode=False)[0]

    def lookup_many(self, keys) -> list:
        """Batched ``lookup``: -> entry tuples (None where absent),
        aligned with the input order."""
        return self._probe_batch(as_key_rows(keys), decode=True)[1]
