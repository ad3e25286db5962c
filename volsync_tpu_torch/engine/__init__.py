"""Device data-plane engine of the port (ports ``volsync_tpu/engine/``).

This package carries the streaming chunk+hash pipeline only (the fused,
split-phase and legacy engines); backup and restore are later slices
(ROADMAP.md).
"""

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
