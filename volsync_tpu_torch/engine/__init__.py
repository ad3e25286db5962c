"""Engine of the port (ports ``volsync_tpu/engine/``): the streaming
chunk+hash pipeline (the fused, split-phase and legacy engines), tree
backup (``backup.py``) and snapshot restore (``restore.py`` and the
pack-aware pipeline of ``restorepipe.py``)."""

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

__all__ = [
    "DeviceChunkHasher",
    "PendingSegment",
    "device_span_roots",
    "hash_file_streaming",
    "hash_spans",
    "params_from_config",
    "params_from_reference",
    "stream_chunk_batches",
    "stream_chunks",
    "verify_blob_batch",
]
