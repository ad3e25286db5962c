"""rsync-equivalent mover: authenticated push delta-sync to a listening
destination (ports ``volsync_tpu/movers/rsync/``' data plane).

The destination exposes an addressed listener; the source pushes a
whole-tree delta over the mutually-authenticated channel with bounded
retries, then tells the listener to shut down with the transfer's exit
code. The delta scan runs on the card (engine/deltasync.py). Only the
entry points are exported: the reference's builder belongs to the
operator, which the port does not have.
"""

from volsync_tpu_torch.movers.rsync.entry import (
    rsync_destination_entrypoint,
    rsync_source_entrypoint,
    serve_destination,
)

__all__ = ["rsync_destination_entrypoint", "rsync_source_entrypoint",
           "serve_destination"]
