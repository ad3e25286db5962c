"""``repack`` — one-shot online repack verb.

Ports ``volsync_tpu/cli/repack.py`` whole, with one addition:
``main`` takes ``device=`` (CUDA by default; without CUDA it raises
before the store is opened) and runs the RepackService there. The
command line, the exit codes and the ``--json`` report are the
reference's: ``python -m volsync_tpu_torch.cli repack STORE ...``.

Runs one full RepackService pass (repo/repack.py): picks packs whose
dead-entry ratio exceeds the threshold, rewrites their live blobs into
fresh erasure-coded stripes (``ec/<pack-id>/<shard-idx>``), re-homes
the index, and parks the old packs behind a two-phase pending-delete
manifest (write-new-verify-then-retire-old, never delete-first).  The
continuous form is the service loop (``RepackService.start()``); this
verb is the operator's on-demand / cron entry point.
docs/robustness.md ("Erasure coding & online repack") carries the
runbook.

Exit codes: 0 the cycle ran (including a no-op "clean" cycle with
nothing above the dead-ratio threshold), 2 the repack could not run at
all (bad store URL, wrong password, lock contention, mid-cycle error).
"""

from __future__ import annotations

import argparse
import json

from volsync_tpu_torch import resolve_device
from volsync_tpu_torch.objstore.store import open_store
from volsync_tpu_torch.repo import crypto
from volsync_tpu_torch.repo.repository import RepoError
from volsync_tpu_torch.repo.repack import RepackService


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="volsync repack",
        description="rewrite mostly-dead packs into erasure-coded "
                    "stripes and retire the originals two-phase",
    )
    parser.add_argument("store", help="repository store URL "
                                      "(e.g. file:///backups/repo)")
    parser.add_argument("--password", default=None,
                        help="repository password (encrypted repos)")
    parser.add_argument("--scheme", default=None,
                        help="erasure scheme k+m (default: "
                             "VOLSYNC_EC_SCHEME or 4+2)")
    parser.add_argument("--dead-ratio", type=float, default=None,
                        help="rewrite packs whose dead-entry ratio "
                             "exceeds this (default: "
                             "VOLSYNC_REPACK_DEAD_RATIO or 0.3)")
    parser.add_argument("--grace", type=float, default=None,
                        help="seconds retired packs stay restorable "
                             "before the sweep (default: repo grace)")
    parser.add_argument("--lock-wait", type=float, default=0.0,
                        help="seconds to wait for a conflicting "
                             "exclusive lock before giving up")
    parser.add_argument("--json", action="store_true",
                        help="emit the full report as JSON")
    return parser


def _parse_scheme(text):
    if text is None:
        return None
    k_s, _, m_s = text.partition("+")
    try:
        return int(k_s), int(m_s)
    except ValueError:
        raise ValueError(f"bad --scheme {text!r}: expected k+m")


def main(argv, out=print, device=None) -> int:
    args = build_parser().parse_args(list(argv))
    device = resolve_device(device)
    try:
        store = open_store(args.store)
        scheme = _parse_scheme(args.scheme)
    except (OSError, ValueError) as ex:
        out(f"error: {ex}")
        return 2
    # one full pass regardless of the fleet's per-cycle budget knob
    try:
        svc = RepackService(store, password=args.password,
                            scheme=scheme, dead_ratio=args.dead_ratio,
                            packs_per_cycle=0,
                            grace_seconds=args.grace,
                            lock_wait=args.lock_wait,
                            device=device)
    except ValueError as ex:
        out(f"error: {ex}")
        return 2
    outcome = svc.run_once()
    if outcome in ("contended", "fenced", "error"):
        # run_once never raises; re-run the open + lock so the
        # operator sees the underlying error instead of a bare outcome
        try:
            from volsync_tpu_torch.repo.repository import Repository

            repo = Repository.open(store, password=args.password,
                                   device=device)
            repo.default_lock_wait = args.lock_wait
            with repo.lock(mode="prune"):
                pass
        except (RepoError, crypto.WrongPassword, OSError,
                ValueError) as ex:
            out(f"error: {ex}")
            return 2
        out(f"error: repack cycle ended {outcome}")
        return 2
    report = dict(svc.last_report or {})
    report["outcome"] = outcome
    if args.json:
        out(json.dumps(report, indent=2, sort_keys=True))
    else:
        out(f"repack {outcome}:")
        out(f"  packs rewritten:  {report.get('packs_rewritten', 0)}")
        out(f"  packs retired:    {report.get('packs_retired', 0)}")
        out(f"  packs swept:      {report.get('packs_swept', 0)}")
        out(f"  blobs re-homed:   {report.get('blobs_rehomed', 0)}")
        out(f"  stripe bytes:     {report.get('stripes_bytes', 0)}")
    return 0
