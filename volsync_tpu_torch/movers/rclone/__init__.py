"""rclone-equivalent mover: checksum-based bucket mirroring (ports
``volsync_tpu/movers/rclone/``' data plane: entry.py + sync.py, the
mover-rclone/active.sh analogue).

Only the entry point and the sync functions are exported: the
reference's builder belongs to the operator, which the port does not
have.
"""

from volsync_tpu_torch.movers.rclone.entry import rclone_entrypoint
from volsync_tpu_torch.movers.rclone.sync import (
    SyncError,
    hash_files,
    sync_down,
    sync_up,
)

__all__ = ["SyncError", "hash_files", "rclone_entrypoint", "sync_down",
           "sync_up"]
