"""restic-equivalent mover: deduplicating backup/restore to object storage
(ports ``volsync_tpu/movers/restic/``' data plane).

The data plane is the port's engine (engine/backup.py,
engine/restore.py). Only the entry point is exported: the reference's
builder belongs to the operator, which the port does not have.
"""

from volsync_tpu_torch.movers.restic.entry import restic_entrypoint

__all__ = ["restic_entrypoint"]
