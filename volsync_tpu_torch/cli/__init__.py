"""The port's ``volsync`` CLI: the maintenance, trace and session verbs.

Ports the verbs that ``volsync_tpu/cli/main.py`` dispatches before the
operator boots, so they can run against a store whose operator stack is
exactly what crashed: ``scrub``, ``repack`` and ``repair``
(cli/scrub.py, cli/repack.py, cli/repair.py), ``trace``
(``obs/cli.py``) and ``session`` (``cluster/sessioncli.py``). The
replication, migration and relationship verbs (the cluster verbs over
the port's operator, ``volsync_tpu_torch/operator.py``) and ``lint``
(the reference's analysis tools) are not ported yet (ROADMAP.md).

    python -m volsync_tpu_torch.cli scrub STORE [--password P] [--json]
    python -m volsync_tpu_torch.cli repack STORE [--scheme k+m] [--json]
    python -m volsync_tpu_torch.cli repair STORE [--dry-run] [--json]
    python -m volsync_tpu_torch.cli trace dump [--out FILE] | summary
    python -m volsync_tpu_torch.cli session run|status|recycle ...

scrub, repack and repair run on CUDA (``main(..., device=)`` picks
another device for tests) and raise where CUDA is absent, before the
store is opened; a session probe fails there (exit 75). ``trace``
touches no device: it reads the calling process's flight recorder.
"""

from __future__ import annotations

import sys

VERBS = ("scrub", "repack", "repair", "trace", "session")


def main(argv=None, out=print, device=None) -> int:
    """Dispatch ``argv`` (default: the command line) to its verb's
    ``main``; 2 with a usage line for anything else."""
    argv = list(sys.argv[1:] if argv is None else argv)
    verb = argv[0] if argv else None
    if verb == "scrub":
        from volsync_tpu_torch.cli.scrub import main as scrub_main

        return scrub_main(argv[1:], out=out, device=device)
    if verb == "repack":
        from volsync_tpu_torch.cli.repack import main as repack_main

        return repack_main(argv[1:], out=out, device=device)
    if verb == "repair":
        from volsync_tpu_torch.cli.repair import main as repair_main

        return repair_main(argv[1:], out=out, device=device)
    if verb == "trace":
        from volsync_tpu_torch.obs.cli import main as trace_main

        return trace_main(argv[1:], out=out)
    if verb == "session":
        from volsync_tpu_torch.cluster.sessioncli import main as session_main

        return session_main(argv[1:], out=out, device=device)
    out(f"usage: volsync {{{','.join(VERBS)}}} ... "
        f"(got {argv[:1] or 'no verb'})")
    return 2


__all__ = ["VERBS", "main"]
