"""The port's ``volsync`` CLI: the maintenance and session verbs.

Ports the part of ``volsync_tpu/cli/`` that needs no operator: the
``scrub`` and ``repack`` verbs (cli/scrub.py, cli/repack.py) and the
``session`` verbs (``cluster/sessioncli.py``), dispatched as
``volsync_tpu/cli/main.py`` dispatches them, before anything of a
cluster is imported. The replication, migration, lint, trace and repair
verbs belong to the operator and its tools, which the port does not
have.

    python -m volsync_tpu_torch.cli scrub STORE [--password P] [--json]
    python -m volsync_tpu_torch.cli repack STORE [--scheme k+m] [--json]
    python -m volsync_tpu_torch.cli session run|status|recycle ...

They run on CUDA (``main(..., device=)`` picks another device for
tests): scrub and repack raise where CUDA is absent, before the store
is opened; a session probe fails there (exit 75).
"""

from __future__ import annotations

import sys

VERBS = ("scrub", "repack", "session")


def main(argv=None, out=print, device=None) -> int:
    """Dispatch ``argv`` (default: the command line) to its verb's
    ``main``; 2 with a usage line for anything else."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "scrub":
        from volsync_tpu_torch.cli.scrub import main as scrub_main

        return scrub_main(argv[1:], out=out, device=device)
    if argv and argv[0] == "repack":
        from volsync_tpu_torch.cli.repack import main as repack_main

        return repack_main(argv[1:], out=out, device=device)
    if argv and argv[0] == "session":
        from volsync_tpu_torch.cluster.sessioncli import main as session_main

        return session_main(argv[1:], out=out, device=device)
    out(f"usage: volsync {{{','.join(VERBS)}}} ... "
        f"(got {argv[:1] or 'no verb'})")
    return 2


__all__ = ["VERBS", "main"]
