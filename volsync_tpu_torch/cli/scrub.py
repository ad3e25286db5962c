"""``scrub`` — one-shot integrity scrub verb.

Ports ``volsync_tpu/cli/scrub.py`` whole, with one addition:
``main`` takes ``device=`` (CUDA by default; without CUDA it raises
before the store is opened) and runs the ScrubService there. The
command line, the exit codes and the ``--json`` report are the
reference's: ``python -m volsync_tpu_torch.cli scrub STORE ...``.

Runs one full ScrubService pass (repo/scrub.py) over every indexed
pack: batched on-device verify, quarantine manifests for mismatches,
atomic verify-then-replace heals from the mirror copy
(``VOLSYNC_PACK_COPIES=2``). The continuous form is the service loop
(``ScrubService.start()``); this verb is the operator's on-demand /
cron entry point. docs/robustness.md ("Silent corruption & scrub")
carries the runbook.

Exit codes: 0 every pack verified clean, 1 corruption was found and
every corrupt pack was healed from its mirror (quarantine is empty
again), 2 unhealable corruption remains quarantined — or the scrub
could not run at all (bad store URL, wrong password, lock contention).
"""

from __future__ import annotations

import argparse
import json

from volsync_tpu_torch import resolve_device
from volsync_tpu_torch.objstore.store import open_store
from volsync_tpu_torch.repo import crypto
from volsync_tpu_torch.repo.repository import RepoError
from volsync_tpu_torch.repo.scrub import ScrubService


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="volsync scrub",
        description="verify every pack on-device and heal silent "
                    "corruption from the mirror copies",
    )
    parser.add_argument("store", help="repository store URL "
                                      "(e.g. file:///backups/repo)")
    parser.add_argument("--password", default=None,
                        help="repository password (encrypted repos)")
    parser.add_argument("--lock-wait", type=float, default=0.0,
                        help="seconds to wait for a conflicting "
                             "exclusive lock before giving up")
    parser.add_argument("--json", action="store_true",
                        help="emit the full report as JSON")
    return parser


def main(argv, out=print, device=None) -> int:
    args = build_parser().parse_args(list(argv))
    device = resolve_device(device)
    try:
        store = open_store(args.store)
    except (OSError, ValueError) as ex:
        out(f"error: {ex}")
        return 2
    # one full pass regardless of the fleet's per-cycle budget knob
    svc = ScrubService(store, password=args.password,
                       packs_per_cycle=0, lock_wait=args.lock_wait,
                       device=device)
    outcome = svc.run_once()
    if outcome in ("contended", "fenced", "error"):
        # run_once never raises; re-run the open + shared lock so the
        # operator sees the underlying error instead of a bare outcome
        try:
            from volsync_tpu_torch.repo.repository import Repository

            repo = Repository.open(store, password=args.password,
                                   device=device)
            repo.default_lock_wait = args.lock_wait
            with repo.lock(mode="shared"):
                pass
        except (RepoError, crypto.WrongPassword, OSError,
                ValueError) as ex:
            out(f"error: {ex}")
            return 2
        out(f"error: scrub cycle ended {outcome}")
        return 2
    report = dict(svc.last_report or {})
    report["outcome"] = outcome
    if args.json:
        out(json.dumps(report, indent=2, sort_keys=True))
    else:
        out(f"scrub {outcome}:")
        out(f"  packs verified:   {report.get('packs', 0)}")
        out(f"  clean:            {report.get('clean', 0)}")
        out(f"  healed:           {report.get('healed', 0)}")
        out(f"  unhealable:       {report.get('unhealable', 0)}")
        out(f"  bytes verified:   {report.get('bytes', 0)}")
    if outcome == "unhealable":
        return 2
    if outcome == "healed":
        return 1
    return 0
