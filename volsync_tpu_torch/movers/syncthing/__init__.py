"""syncthing mover: always-on N-way live sync (ports
``volsync_tpu/movers/syncthing/``; SURVEY.md §2 #13/#14/#28).

The one mover category where the control plane talks to a LIVE service:
an always-on daemon Deployment block-hashing its folder on the card and
exchanging files with authenticated peer devices, reconciled against
spec.peers every poll (controllers/mover/syncthing/ +
mover-syncthing/entry.sh).
"""

from volsync_tpu_torch.movers.syncthing.apiclient import (
    SyncthingConnection,
    SyncthingState,
    try_fetch,
)
from volsync_tpu_torch.movers.syncthing.builder import (
    Builder,
    SyncthingMover,
    register,
)
from volsync_tpu_torch.movers.syncthing.entry import (
    FolderIndex,
    SyncthingDaemon,
    syncthing_entrypoint,
)

__all__ = ["Builder", "FolderIndex", "SyncthingConnection",
           "SyncthingDaemon", "SyncthingMover", "SyncthingState",
           "register", "syncthing_entrypoint", "try_fetch"]
