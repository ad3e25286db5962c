"""syncthing mover: always-on N-way live sync (ports
``volsync_tpu/movers/syncthing/``' data plane: entry.py, apiclient.py,
transport.py).

The always-on daemon block-hashes its folder on the card and exchanges
files with authenticated peer devices. Only the entry point, the
daemon and the control-API client are exported: the reference's
builder belongs to the operator, which the port does not have.
"""

from volsync_tpu_torch.movers.syncthing.apiclient import (
    SyncthingConnection,
    SyncthingState,
    try_fetch,
)
from volsync_tpu_torch.movers.syncthing.entry import (
    FolderIndex,
    SyncthingDaemon,
    syncthing_entrypoint,
)

__all__ = ["FolderIndex", "SyncthingConnection", "SyncthingDaemon",
           "SyncthingState", "syncthing_entrypoint", "try_fetch"]
