"""Reusable page-granular byte buffers for the zero-copy data plane.

A copy of ``volsync_tpu/engine/bufpool.py``; its lock is built through
``analysis.lockcheck`` as the reference's is. The chunker fills pooled
``bytearray`` segments with ``readinto()`` and hands consumers
memoryview slices of them.

Release is safe by construction: a ``bytearray`` with exported views
refuses to resize, so ``release()`` probes with a 1-byte append/undo. A
buffer whose views are still held is PARKED instead of recycled and
re-probed on later acquires, so a pooled buffer is never handed out
while any view of it is alive.
"""

from __future__ import annotations

from collections import defaultdict

from volsync_tpu_torch.analysis import lockcheck

_PAGE = 4096

#: Free-list byte budget: beyond it released buffers go back to the
#: allocator instead of being retained.
_MAX_FREE_BYTES = 256 * 1024 * 1024
#: Parked buffers kept for re-probing; older ones are left to GC.
_MAX_PARKED = 16


class BufferPool:
    """Size-bucketed free list of reusable ``bytearray`` buffers."""

    def __init__(self, max_free_bytes: int = _MAX_FREE_BYTES,
                 max_parked: int = _MAX_PARKED):
        self._lock = lockcheck.make_lock("engine.bufpool")
        self._free: defaultdict = defaultdict(list)  # size -> [bytearray]
        self._free_bytes = 0
        self._max_free_bytes = max_free_bytes
        self._parked: list = []
        self._max_parked = max_parked

    @staticmethod
    def _reusable(buf: bytearray) -> bool:
        """True iff no memoryview of ``buf`` is still exported."""
        try:
            buf.append(0)
        except BufferError:
            return False
        del buf[-1:]
        return True

    def acquire(self, size: int) -> bytearray:
        """A buffer of ``size`` bytes rounded up to the page grid,
        recycled when one is free. Contents are UNDEFINED."""
        size = (size + _PAGE - 1) // _PAGE * _PAGE
        with self._lock:
            if self._parked:
                still = []
                for buf in self._parked:
                    if self._reusable(buf):
                        self._stash(buf)
                    else:
                        still.append(buf)
                self._parked = still
            bucket = self._free.get(size)
            if bucket:
                self._free_bytes -= size
                return bucket.pop()
        return bytearray(size)

    def release(self, buf: bytearray) -> None:
        """Return ``buf`` to the pool (parked while views are alive)."""
        with self._lock:
            if not self._reusable(buf):
                self._parked.append(buf)
                if len(self._parked) > self._max_parked:
                    self._parked.pop(0)
                return
            self._stash(buf)

    def _stash(self, buf: bytearray) -> None:
        if self._free_bytes + len(buf) > self._max_free_bytes:
            return
        self._free[len(buf)].append(buf)
        self._free_bytes += len(buf)


#: Process-wide pool shared by every stream worker.
GLOBAL = BufferPool()
