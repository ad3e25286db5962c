"""``volsync session``: supervised device session verbs.

Ports ``volsync_tpu/cluster/sessioncli.py`` on the port's
``cluster/sessions.py``:

- ``volsync session run [opts] -- CMD...``: run CMD as the next
  serialized verify-then-measure job: probe first, kill at the hard
  deadline, recycle on a wedge, stamp VOLSYNC_SESSION_* into CMD's
  environment. Exit code is CMD's, or 75 (EX_TEMPFAIL) when the backend
  never verifies healthy or the job is fenced or killed.
- ``volsync session status [--probe]``: show the last supervisor status
  mirror (VOLSYNC_SESSION_STATUS); ``--probe`` also runs one live
  subprocess probe (exit 75 when it fails).
- ``volsync session recycle``: SIGKILL stale marked measurement
  children now, exit 0.

``--backend`` is ``torch|fake`` where the reference's is ``jax|fake``:
``torch`` is ``TorchSessionBackend`` on CUDA (``main(..., device=)``
picks another device for tests). Dispatched as ``session`` by
``volsync_tpu_torch.cli.main``, before anything of a device is touched.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from volsync_tpu_torch import envflags
from volsync_tpu_torch.cluster import sessions
from volsync_tpu_torch.objstore.faultstore import FaultSchedule, parse_spec

DEFAULT_STATUS = "/tmp/volsync_session_status.json"

#: EX_TEMPFAIL — the backend is unhealthy / the result was refused;
#: retry after recovery
EXIT_UNHEALTHY = 75


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="volsync session",
        description="Supervised device sessions: serialized "
                    "verify-then-measure jobs, status, forced recycle.")
    sub = p.add_subparsers(dest="verb", required=True)

    run = sub.add_parser(
        "run", help="run CMD as the next serialized bench job")
    run.add_argument("--backend", choices=("torch", "fake"),
                     default="torch",
                     help="session backend (fake = deterministic "
                          "seeded chaos, no device)")
    run.add_argument("--label", default="job",
                     help="job label for spans and logs")
    run.add_argument("--deadline", type=float, default=None,
                     help="per-job hard deadline in seconds "
                          "(default VOLSYNC_SESSION_JOB_DEADLINE_S)")
    run.add_argument("--ttl", type=float, default=None,
                     help="lease TTL seconds "
                          "(default VOLSYNC_SESSION_TTL_S)")
    run.add_argument("--probe-timeout", type=float, default=None,
                     help="verify-probe budget in seconds "
                          "(default VOLSYNC_SESSION_PROBE_TIMEOUT_S)")
    run.add_argument("--status-file", default=None,
                     help="mirror supervisor state to this JSON file "
                          "(default VOLSYNC_SESSION_STATUS)")
    run.add_argument("--fake-seed", type=int, default=0,
                     help="fault-schedule seed for --backend fake")
    run.add_argument("--fake-spec", action="append", default=[],
                     metavar="SPEC",
                     help="faultstore spec for --backend fake, e.g. "
                          "'hang:op=probe,at=2,ms=400000' or "
                          "'zombie:op=keepalive,at=4' (repeatable)")
    run.add_argument("cmd", nargs=argparse.REMAINDER,
                     help="command to run (prefix with --)")

    st = sub.add_parser("status",
                        help="show last supervisor status mirror")
    st.add_argument("--file", default=None,
                    help=f"status mirror path (default "
                         f"VOLSYNC_SESSION_STATUS or {DEFAULT_STATUS})")
    st.add_argument("--probe", action="store_true",
                    help="also run one live backend probe")
    st.add_argument("--probe-timeout", type=float, default=None)

    rec = sub.add_parser("recycle",
                         help="force-release: kill stale marked "
                              "measurement children now")
    rec.add_argument("--marker", default=sessions.BENCH_CHILD_MARKER,
                     help="environment marker identifying stale "
                          "measurement children")
    return p


def _parse_session_specs(texts: list) -> list:
    """faultstore ``parse_spec`` plus the session-only ``zombie`` kind
    (not in the store registry: a store op can't hold a device)."""
    import dataclasses

    out = []
    for text in texts:
        for entry in filter(None, (e.strip() for e in text.split(";"))):
            kind, _, rest = entry.partition(":")
            if kind.strip() == "zombie":
                out.extend(dataclasses.replace(s, kind="zombie")
                           for s in parse_spec(f"transient:{rest}"))
            else:
                out.extend(parse_spec(entry))
    return out


def _make_backend(args, device=None) -> object:
    if args.backend == "fake":
        return sessions.FakeSessionBackend(
            FaultSchedule(seed=args.fake_seed,
                          specs=_parse_session_specs(args.fake_spec)))
    return sessions.TorchSessionBackend(device=device,
                                        probe_timeout=args.probe_timeout)


def _status_path(explicit: Optional[str]) -> str:
    return (explicit or envflags.session_status_path()
            or DEFAULT_STATUS)


def _run(args, out, device=None) -> int:
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        out("session run: no command given (append -- CMD...)")
        return 2
    backend = _make_backend(args, device)
    sup = sessions.SessionSupervisor(
        backend, ttl=args.ttl, probe_timeout=args.probe_timeout,
        status_path=_status_path(args.status_file))
    queue = sessions.BenchQueue(sup, job_deadline=args.deadline)
    with sup:  # keepalive thread runs between (not during) jobs
        try:
            res = queue.run_command(cmd, label=args.label)
        except sessions.SessionError as exc:
            out(f"session run: {exc}")
            return EXIT_UNHEALTHY
    inner = res["result"]
    if inner["stdout"]:
        out(inner["stdout"].rstrip("\n"))
    if inner["stderr"]:
        print(inner["stderr"].rstrip("\n"), file=sys.stderr)
    out(json.dumps({"session": res["session"],
                    "label": res["label"], "rc": inner["rc"]}))
    return inner["rc"]


def _status(args, out, device=None) -> int:
    path = _status_path(args.file)
    try:
        with open(path, encoding="utf-8") as f:
            out(json.dumps(json.loads(f.read()), indent=2,
                           sort_keys=True))
    except (OSError, ValueError):
        out(f"no session status at {path}")
        if not args.probe:
            return 1
    if args.probe:
        backend = sessions.TorchSessionBackend(
            device=device, probe_timeout=args.probe_timeout)
        try:
            platform = backend.probe("status-probe",
                                     timeout=args.probe_timeout or 0.0)
        except Exception as exc:  # noqa: BLE001 — any probe failure
            # means "wedged" to the operator reading this
            out(f"probe: WEDGED ({exc})")
            return EXIT_UNHEALTHY
        out(f"probe: live ({platform})")
    return 0


def _recycle(args, out) -> int:
    killed = sessions.kill_marked_children(args.marker, log_fn=out)
    out(f"recycle: killed {killed} stale measurement "
        f"child{'' if killed == 1 else 'ren'} "
        f"(marker {args.marker!r}, pid {os.getpid()} spared)")
    return 0


def main(argv=None, out=print, device=None) -> int:
    """``device`` is the torch backend's (None: CUDA)."""
    args = build_parser().parse_args(argv)
    if args.verb == "run":
        return _run(args, out, device)
    if args.verb == "status":
        return _status(args, out, device)
    return _recycle(args, out)


if __name__ == "__main__":
    raise SystemExit(main())
