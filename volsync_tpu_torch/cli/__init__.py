"""The port's ``volsync`` CLI (kubectl-volsync analogue; ports
``volsync_tpu/cli/``).

Replication and migration verb trees over persisted relationship files
(parse with ``cli.main.build_parser``, dispatch with ``cli.main.run``
over named cluster contexts), and the verbs that run before any runtime
boots: ``lint`` (``analysis/``), ``trace`` (``obs/cli.py``), ``session``
(``cluster/sessioncli.py``), ``repair``, ``scrub`` and ``repack``.

    python -m volsync_tpu_torch.cli replication|migration ...
    python -m volsync_tpu_torch.cli lint [PATHS] [--no-baseline] ...
    python -m volsync_tpu_torch.cli scrub STORE [--password P] [--json]
    python -m volsync_tpu_torch.cli repack STORE [--scheme k+m] [--json]
    python -m volsync_tpu_torch.cli repair STORE [--dry-run] [--json]
    python -m volsync_tpu_torch.cli trace dump [--out FILE] | summary
    python -m volsync_tpu_torch.cli session run|status|recycle ...

The cluster verbs boot the port's operator runtime, and scrub, repack,
repair and a migration push run, on CUDA (``main(..., device=)`` picks
another device for tests) and raise where CUDA is absent, before
storage is made or a store opened; a session probe fails there (exit
75). ``lint`` and ``trace`` touch no device.
"""

from volsync_tpu_torch.cli.main import VERBS, build_parser, main, run
from volsync_tpu_torch.cli.relationship import Relationship, RelationshipError

__all__ = ["VERBS", "build_parser", "main", "run", "Relationship",
           "RelationshipError"]
