"""``volsync trace``: flight-recorder access for the port's CLI.

Ports ``volsync_tpu/obs/cli.py``. Verbs:

- ``volsync trace dump [--out FILE]``: export the in-process flight
  recorder as Chrome-trace-event JSON (load the file in Perfetto /
  chrome://tracing). Without ``--out`` the JSON prints to stdout.
- ``volsync trace summary``: the span registry as a table, split by
  outcome, so a session can see where time went without leaving the
  terminal.

The verb touches no device and dispatches before anything else is
imported: reading the recorder must work in a half-broken process
(that is when you want the flight recorder). The recorder is
process-local: ``dump`` exports the calling process's own spans, so
it is useful in process (``volsync_tpu_torch.cli.main(["trace", ...])``
after the work) or from a fresh process only for its own spans.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="volsync trace",
        description="Inspect/export the in-process span flight recorder")
    sub = parser.add_subparsers(dest="verb", required=True)
    dump = sub.add_parser("dump", help="export Chrome-trace-event JSON")
    dump.add_argument("--out", default=None,
                      help="file to write (default: print to stdout)")
    sub.add_parser("summary", help="span totals by stage and outcome")
    return parser


def main(argv, out=print) -> int:
    from volsync_tpu_torch.obs import chrome_trace, dump_trace, span_totals

    args = build_parser().parse_args(list(argv))
    if args.verb == "dump":
        if args.out:
            path = dump_trace(path=args.out)
            out(f"trace written to {path}")
        else:
            out(json.dumps(chrome_trace(), indent=2))
        return 0
    totals = span_totals(by_outcome=True)
    if not totals:
        out("no spans recorded")
        return 0
    out(f"{'stage':<32} {'outcome':<8} {'count':>8} {'seconds':>12}")
    for (stage, outcome), (count, secs) in sorted(totals.items()):
        out(f"{stage:<32} {outcome:<8} {count:>8} {secs:>12.4f}")
    return 0
