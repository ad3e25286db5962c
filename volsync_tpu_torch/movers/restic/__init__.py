"""restic-equivalent mover: deduplicating backup/restore to object storage
(ports ``volsync_tpu/movers/restic/``).

Control plane mirrors controllers/mover/restic/ (cache volume, repository
secret validation, backup/prune on the source, restore with
restoreAsOf/previous on the destination); the data plane is the port's
engine (engine/backup.py, engine/restore.py) instead of a wrapped binary.
"""

from volsync_tpu_torch.movers.restic.builder import Builder, register
from volsync_tpu_torch.movers.restic.entry import restic_entrypoint

__all__ = ["Builder", "register", "restic_entrypoint"]
