"""Device kernels of the port (ports ``volsync_tpu/ops/``): SHA-256
(``sha256``), content-defined chunking (``gearcdc``), the fused
chunk+hash segment pipeline (``segment``), Reed-Solomon (``rs``) and the
rsync delta scan (``rolling``, ``md5``, ``delta``). CUDA sources live in
``../csrc`` and are built by ``_build`` at first use."""

from volsync_tpu_torch.ops.delta import build_signature, match_offsets
from volsync_tpu_torch.ops.md5 import md5_blocks, md5_many
from volsync_tpu_torch.ops.rolling import (
    block_weak_checksums,
    rolling_weak_checksums,
)

__all__ = [
    "md5_blocks",
    "md5_many",
    "block_weak_checksums",
    "rolling_weak_checksums",
    "build_signature",
    "match_offsets",
]
