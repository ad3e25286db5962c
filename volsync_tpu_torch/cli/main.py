"""The port's ``volsync`` CLI frontend (the kubectl-volsync plugin
analogue).

Ports ``volsync_tpu/cli/main.py``. The command tree is the reference's
(cmd/root.go:44-60):

    volsync replication create|delete|schedule|set-source|set-destination|sync
    volsync migration   create|delete|rsync
    volsync lint|trace|session|repair|scrub|repack ...

Parsing is argparse (cobra analogue); the cluster verbs dispatch to
ReplicationCLI / MigrationCLI over named cluster contexts. ``lint``,
``trace``, ``session``, ``repair``, ``scrub`` and ``repack`` dispatch
before any runtime boots, so they run against a store whose operator
stack is exactly what crashed. ``python -m volsync_tpu_torch.cli``
(``volsync-torch``) runs the cluster verbs in demo mode with one
in-process cluster context ("default") booted from the port's operator
runtime on ``device`` (CUDA unless another is asked for; it raises
without CUDA before it makes storage); tests and ``chip_smoke.py``
embed ``run()`` with real contexts.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from volsync_tpu_torch.api.common import CopyMethod
from volsync_tpu_torch.cli.migration import MigrationCLI
from volsync_tpu_torch.cli.relationship import RelationshipError
from volsync_tpu_torch.cli.replication import ReplicationCLI

DEFAULT_CONFIG_DIR = Path.home() / ".volsync"

#: Verbs that never need the runtime: dispatched before it boots.
PRE_BOOT = ("lint", "trace", "session", "repair", "scrub", "repack")
VERBS = ("replication", "migration") + PRE_BOOT


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="volsync",
        description="Drive VolSync-TPU replication/migration relationships",
    )
    parser.add_argument("--config-dir", default=str(DEFAULT_CONFIG_DIR),
                        help="directory holding relationship files")
    sub = parser.add_subparsers(dest="group", required=True)

    rep = sub.add_parser("replication",
                         help="asynchronous volume replication")
    repsub = rep.add_subparsers(dest="verb", required=True)

    r_create = repsub.add_parser("create")
    r_create.add_argument("name")

    r_setdst = repsub.add_parser("set-destination")
    r_setdst.add_argument("name")
    r_setdst.add_argument("--cluster", default="default")
    r_setdst.add_argument("--namespace", default="default")
    r_setdst.add_argument("--dest-name", required=True)
    r_setdst.add_argument("--copy-method", default="Snapshot",
                          choices=[m.value for m in CopyMethod])
    r_setdst.add_argument("--service-type", default=None)
    r_setdst.add_argument("--capacity", type=int, default=None)
    r_setdst.add_argument("--access-modes", nargs="*", default=None)

    r_setsrc = repsub.add_parser("set-source")
    r_setsrc.add_argument("name")
    r_setsrc.add_argument("--cluster", default="default")
    r_setsrc.add_argument("--namespace", default="default")
    r_setsrc.add_argument("--pvcname", required=True)
    r_setsrc.add_argument("--copy-method", default="Snapshot",
                          choices=[m.value for m in CopyMethod])

    r_sched = repsub.add_parser("schedule")
    r_sched.add_argument("name")
    r_sched.add_argument("cronspec")

    r_sync = repsub.add_parser("sync")
    r_sync.add_argument("name")
    r_sync.add_argument("--timeout", type=float, default=120.0)

    r_del = repsub.add_parser("delete")
    r_del.add_argument("name")

    mig = sub.add_parser("migration", help="one-way data migration")
    migsub = mig.add_subparsers(dest="verb", required=True)

    m_create = migsub.add_parser("create")
    m_create.add_argument("name")
    m_create.add_argument("--cluster", default="default")
    m_create.add_argument("--namespace", default="default")
    m_create.add_argument("--pvcname", required=True)
    m_create.add_argument("--capacity", type=int, default=None)
    m_create.add_argument("--access-modes", nargs="*", default=None)

    m_rsync = migsub.add_parser("rsync")
    m_rsync.add_argument("name")
    m_rsync.add_argument("source_dir")

    m_del = migsub.add_parser("delete")
    m_del.add_argument("name")

    # Registered for --help discoverability only; run() hands these
    # verbs (with all their options) straight to their own modules,
    # which own the real argument parsing.
    sub.add_parser(
        "lint", add_help=False,
        help="repo-invariant static analysis "
             "(python -m volsync_tpu_torch.analysis)")
    sub.add_parser(
        "trace", add_help=False,
        help="span flight recorder: dump Chrome-trace JSON / summary "
             "(volsync_tpu_torch.obs)")
    sub.add_parser(
        "session", add_help=False,
        help="supervised accelerator sessions: serialized bench jobs, "
             "status, forced recycle (volsync_tpu_torch.cluster.sessioncli)")
    sub.add_parser(
        "repair", add_help=False,
        help="repository recovery: orphaned packs, expired "
             "pending-deletes, dangling index entries "
             "(volsync_tpu_torch.cli.repair)")
    sub.add_parser(
        "scrub", add_help=False,
        help="integrity scrub: on-device pack verify, quarantine + "
             "mirror heal of silent corruption (volsync_tpu_torch.cli.scrub)")
    sub.add_parser(
        "repack", add_help=False,
        help="online repack: rewrite mostly-dead packs into "
             "erasure-coded stripes, two-phase retire "
             "(volsync_tpu_torch.cli.repack)")

    return parser


def _pre_boot(verb: str, argv: list, out, device) -> int:
    """Dispatch one of ``PRE_BOOT`` to its module's ``main``."""
    if verb == "lint":
        from volsync_tpu_torch.analysis.cli import main as lint_main

        return lint_main(argv, out=out)
    if verb == "trace":
        from volsync_tpu_torch.obs.cli import main as trace_main

        return trace_main(argv, out=out)
    if verb == "session":
        from volsync_tpu_torch.cluster.sessioncli import main as session_main

        return session_main(argv, out=out, device=device)
    if verb == "repair":
        from volsync_tpu_torch.cli.repair import main as repair_main

        return repair_main(argv, out=out, device=device)
    if verb == "scrub":
        from volsync_tpu_torch.cli.scrub import main as scrub_main

        return scrub_main(argv, out=out, device=device)
    from volsync_tpu_torch.cli.repack import main as repack_main

    return repack_main(argv, out=out, device=device)


def run(argv, contexts: dict, out=print, device=None) -> int:
    """Parse + dispatch. ``contexts`` maps context names to Cluster
    handles (the kubeconfig analogue); ``device`` is where the
    maintenance verbs and a migration push run (CUDA by default)."""
    argv = list(argv)
    if argv and argv[0] in PRE_BOOT:
        return _pre_boot(argv[0], argv[1:], out, device)
    args = build_parser().parse_args(argv)
    config_dir = Path(args.config_dir)
    try:
        if args.group == "replication":
            cli = ReplicationCLI(contexts, config_dir, out=out,
                                 device=device)
            if args.verb == "create":
                cli.create(args.name)
            elif args.verb == "set-destination":
                cli.set_destination(
                    args.name, cluster=args.cluster,
                    namespace=args.namespace, dest_name=args.dest_name,
                    copy_method=CopyMethod(args.copy_method),
                    service_type=args.service_type, capacity=args.capacity,
                    access_modes=args.access_modes)
            elif args.verb == "set-source":
                cli.set_source(args.name, cluster=args.cluster,
                               namespace=args.namespace,
                               pvc_name=args.pvcname,
                               copy_method=CopyMethod(args.copy_method))
            elif args.verb == "schedule":
                cli.schedule(args.name, args.cronspec)
            elif args.verb == "sync":
                cli.sync(args.name, timeout=args.timeout)
            elif args.verb == "delete":
                cli.delete(args.name)
        else:
            cli = MigrationCLI(contexts, config_dir, out=out, device=device)
            if args.verb == "create":
                cli.create(args.name, cluster=args.cluster,
                           namespace=args.namespace, pvc_name=args.pvcname,
                           capacity=args.capacity,
                           access_modes=args.access_modes)
            elif args.verb == "rsync":
                cli.rsync(args.name, args.source_dir)
            elif args.verb == "delete":
                cli.delete(args.name)
        return 0
    except RelationshipError as e:
        out(f"error: {e}")
        return 1


def main(argv=None, out=print, device=None) -> int:
    """Entry point (``volsync-torch``). The pre-boot verbs dispatch
    straight away; the rest is parsed first (a parse error, an unknown
    verb included, exits 2 with a usage line and no runtime booted) and
    then runs in demo mode against one in-process operator runtime on
    ``device`` as the 'default' context (its flags from the
    ``VOLSYNC_*`` environment, as ``volsync-manager-torch`` reads
    them)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in PRE_BOOT:
        return run(argv, {}, out=out, device=device)
    try:
        build_parser().parse_args(argv)
    except SystemExit as e:
        if e.code:
            out(f"usage: volsync {{{','.join(VERBS)}}} ... "
                f"(got {argv[:1] or 'no verb'})")
        return int(e.code or 0)
    from volsync_tpu_torch.operator import OperatorRuntime, resolve_config

    cfg = resolve_config()
    if device is not None:
        cfg["device"] = device
    with OperatorRuntime(cfg) as rt:
        return run(argv, {"default": rt.cluster}, out=out, device=device)


if __name__ == "__main__":
    raise SystemExit(main())
