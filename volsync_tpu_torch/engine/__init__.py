"""Engine of the port (ports ``volsync_tpu/engine/``): the streaming
chunk+hash pipeline (the fused, split-phase and legacy engines), tree
backup (``backup.py``), snapshot restore (``restore.py`` and the
pack-aware pipeline of ``restorepipe.py``), the rsync delta engine
(``deltasync.py``) and the sync-protocol planner (``protoplan.py`` over
``syncstats.py``)."""

from volsync_tpu_torch.engine.chunker import (
    DeviceChunkHasher,
    PendingSegment,
    device_span_roots,
    hash_file_streaming,
    hash_spans,
    params_from_config,
    params_from_reference,
    stream_chunk_batches,
    stream_chunks,
    verify_blob_batch,
)
from volsync_tpu_torch.engine.protoplan import PlanDecision, decide
from volsync_tpu_torch.engine.syncstats import SyncStatsBook, book_for

__all__ = [
    "DeviceChunkHasher",
    "PendingSegment",
    "PlanDecision",
    "SyncStatsBook",
    "book_for",
    "decide",
    "device_span_roots",
    "hash_file_streaming",
    "hash_spans",
    "params_from_config",
    "params_from_reference",
    "stream_chunk_batches",
    "stream_chunks",
    "verify_blob_batch",
]
