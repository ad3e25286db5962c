"""rclone-equivalent mover: checksum-based bucket mirroring (ports
``volsync_tpu/movers/rclone/``).

Control plane: builder.py (controllers/mover/rclone/).
Data plane: entry.py + sync.py (mover-rclone/active.sh).
"""

from volsync_tpu_torch.movers.rclone.builder import (
    Builder,
    RcloneDestinationMover,
    RcloneSourceMover,
    register,
)
from volsync_tpu_torch.movers.rclone.entry import rclone_entrypoint
from volsync_tpu_torch.movers.rclone.sync import (
    SyncError,
    hash_files,
    sync_down,
    sync_up,
)

__all__ = ["Builder", "RcloneDestinationMover", "RcloneSourceMover",
           "SyncError", "hash_files", "rclone_entrypoint", "register",
           "sync_down", "sync_up"]
