"""``repair``: repository recovery verb.

Ports ``volsync_tpu/cli/repair.py`` whole, with one addition: ``main``
takes ``device=`` (CUDA by default; without CUDA it raises before the
store is opened) and opens the repository there. The command line, the
exit codes and the report are the reference's: ``python -m
volsync_tpu_torch.cli repair STORE ...``.

Detects and (unless ``--dry-run``) resolves the debris crashed writers
and pruners leave behind: orphaned packs, expired pending-delete
manifests, dangling index entries, stale takeover/fence markers. Thin
argparse front over ``Repository.repair`` (repo/repository.py), which
owns the actual protocol.

Exit codes: 0 clean (or everything resolvable was resolved), 1 when the
scan found damage repair refuses to touch (broken trees, reachable
blobs whose pack is gone), 2 on operational errors (bad store URL,
wrong password, lock contention).
"""

from __future__ import annotations

import argparse
import json

from volsync_tpu_torch import resolve_device
from volsync_tpu_torch.objstore.store import open_store
from volsync_tpu_torch.repo import crypto
from volsync_tpu_torch.repo.repository import RepoError, Repository


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="volsync repair",
        description="detect and resolve crashed-writer/pruner debris "
                    "in a repository",
    )
    parser.add_argument("store", help="repository store URL "
                                      "(e.g. file:///backups/repo)")
    parser.add_argument("--password", default=None,
                        help="repository password (encrypted repos)")
    parser.add_argument("--dry-run", action="store_true",
                        help="scan and report only; mutate nothing")
    parser.add_argument("--grace-seconds", type=float, default=None,
                        help="pending-delete grace for the GC pass "
                             "(default: the lock-staleness horizon; "
                             "0 = stop-the-world sweep)")
    parser.add_argument("--json", action="store_true",
                        help="emit the full report as JSON")
    return parser


def main(argv, out=print, device=None) -> int:
    args = build_parser().parse_args(list(argv))
    device = resolve_device(device)
    try:
        store = open_store(args.store)
        repo = Repository.open(store, password=args.password,
                               device=device)
        report = repo.repair(apply=not args.dry_run,
                             grace_seconds=args.grace_seconds)
    except (RepoError, crypto.WrongPassword, OSError, ValueError) as ex:
        out(f"error: {ex}")
        return 2
    if args.json:
        out(json.dumps(report, indent=2, sort_keys=True))
    else:
        verb = "resolved" if report["applied"] else "found (dry-run)"
        out(f"repair {verb}:")
        out(f"  orphan packs:            {len(report['orphan_packs'])}")
        out(f"  dangling packs:          {len(report['dangling_packs'])}")
        out(f"  dangling entries:        "
            f"{report['dangling_entries_found']}"
            f" ({report['dangling_entries_dropped']} dropped)")
        out(f"  pending manifests:       {report['pending_manifests']}"
            f" ({report['expired_manifests']} expired)")
        out(f"  stale markers:           {len(report['stale_markers'])}")
        if report["gc"]:
            gc = report["gc"]
            out(f"  gc: swept {gc['packs_swept']} packs, "
                f"{gc['packs_pending']} pending, "
                f"rescued {gc['blobs_rescued']} blobs")
        for blob_id in report["unrecoverable_blobs"]:
            out(f"  UNRECOVERABLE blob: {blob_id}")
        for item in report["broken_trees"]:
            out(f"  BROKEN tree: {item}")
    if report["unrecoverable_blobs"] or report["broken_trees"]:
        return 1
    return 0
