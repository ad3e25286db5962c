"""Standalone rsync destination listener: the cross-host data plane.

Ports ``volsync_tpu/movers/rsync/standalone.py`` whole, plus a
``--device`` option (default ``cuda``: the signatures run on the card,
and the listener raises where CUDA is absent; ``cpu`` runs the kernels'
plain PyTorch versions, for tests).

Runs the same listener the in-cluster Job runs, as its own OS process
bound to a real interface — what a destination host outside the
in-process substrate deploys (the reference's destination container runs
sshd the same way). Keys come from files (the destination half of the
asymmetric split: its own private device key + the source's pinned
device ID); the bound port prints on stdout for the orchestrator.

    python -m volsync_tpu_torch.movers.rsync.standalone \\
        --root /data --key-file dst.key --source-id <hex> \\
        --bind 0.0.0.0 --port 0 [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from volsync_tpu_torch.movers.rsync.entry import serve_destination


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rsync-destination")
    parser.add_argument("--root", required=True,
                        help="directory to receive into")
    parser.add_argument("--key-file", required=True,
                        help="file holding this destination's private "
                             "device key")
    parser.add_argument("--source-id", required=True,
                        help="pinned device ID of the allowed source")
    parser.add_argument("--bind", default="0.0.0.0",
                        help="listen address (default all interfaces)")
    parser.add_argument("--port", type=int, default=0,
                        help="listen port (0 = ephemeral, printed)")
    parser.add_argument("--device", default="cuda",
                        help="device of the signatures (default cuda; "
                             "cpu runs the kernels' plain versions)")
    args = parser.parse_args(argv)

    def announce(port: int):
        print(f"PORT {port}", flush=True)

    return serve_destination(
        Path(args.root), Path(args.key_file).read_bytes(), args.source_id,
        bind=args.bind, preferred_port=args.port, on_port=announce,
        device=args.device)


if __name__ == "__main__":
    sys.exit(main())
