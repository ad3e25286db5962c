"""rsync-equivalent mover: authenticated push delta-sync to a listening
destination (ports ``volsync_tpu/movers/rsync/``).

Mirrors controllers/mover/rsync/ (SURVEY.md §2 #10, #23-24): the
destination exposes an addressed listener whose connection keys live in a
generated Secret and whose address/keys are published in status; the
source pushes a whole-tree delta over the mutually-authenticated channel
with bounded retries, then tells the listener to shut down with the
transfer's exit code. The delta scan runs on the card
(engine/deltasync.py) instead of inside the rsync binary.
"""

from volsync_tpu_torch.movers.rsync.builder import Builder, register
from volsync_tpu_torch.movers.rsync.entry import (
    rsync_destination_entrypoint,
    rsync_source_entrypoint,
    serve_destination,
)

__all__ = ["Builder", "register", "rsync_destination_entrypoint",
           "rsync_source_entrypoint", "serve_destination"]
