"""Mesh-parallel data plane of the port: (wave, seq) sharding of the
chunk+hash engine (ports ``volsync_tpu/parallel/``).

Concurrent streams batch over the ``wave`` axis, one stream's bytes
shard over the ``seq`` axis with a ring halo exchange, and dedup state
is summed with mesh-wide collectives. A mesh lives in one process (its
devices may repeat) or spans processes joined by ``init_distributed``
(``torch.distributed``: NCCL on CUDA, gloo on the CPU).
"""

from volsync_tpu_torch.parallel.mesh import (
    SEQ_AXIS,
    WAVE_AXIS,
    Mesh,
    make_mesh,
    replicated,
    stream_sharding,
)
from volsync_tpu_torch.parallel.engine import (
    chunk_hash_block,
    make_chunk_hash_step,
    sha256_fixed_blocks,
)

__all__ = [
    "SEQ_AXIS",
    "WAVE_AXIS",
    "Mesh",
    "make_mesh",
    "replicated",
    "stream_sharding",
    "chunk_hash_block",
    "make_chunk_hash_step",
    "sha256_fixed_blocks",
]
