#!/usr/bin/env python3
"""Time ``sha256_chunks_device`` at the shapes of its callers.

    python3 volsync_tpu_torch/tools/time_leaf_calls.py [--seed N] [--reps R]

``ops.sha256.sha256_chunks_device`` hashes slices of at most 4 KiB of a
resident buffer: the fused and span paths' tail leaves, the split-phase
engine's short tail leaves and every leaf of the legacy engine. The
script builds one seeded 48 MiB buffer on the card and four sets of
lanes:

- ``fused_tail``: one lane, a 4,095-byte tail leaf (65 blocks), the
  longest a fused segment's lane can have;
- ``split``: 64 lanes of 64 to 4,032 bytes (whole 64-byte rows, as the
  split-phase engine cuts) at 64-byte-aligned starts, its short tail
  leaves;
- ``spans``: 256 lanes of 1 to 4,095 bytes at page starts, the tail
  leaves of 256 spans (``verify_blob_batch`` checks 256 chunks at a
  time in ``chip_smoke.py``), where most lanes end inside a block;
- ``legacy``: 16,384 lanes, the 4 KiB leaves of chunks of 512 KiB to
  2 MiB laid one after another from byte 777 within the first 40 MiB
  (each chunk's last leaf partial), then empty padding lanes, as the
  legacy engine sends one 40 MiB read.

Each call's digests must equal hashlib's. A call is timed eagerly, as
its caller makes it (CUDA events around ``--reps`` calls, the least
mean of 3 trials), so the time holds every launch and the gaps between
them, and as the replay of a CUDA graph of ``--reps`` calls (the
device's time alone). The script imports ``volsync_tpu_torch`` from ``sys.path``:
``PYTHONPATH=<another checkout>`` times that checkout's function on the
same inputs, so two checkouts run in one job compare on one card. It
prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import numpy as np

LEAF = 4096
BUFFER = 48 << 20  # a segment's device buffer
READ = 40 << 20  # the bytes of one pass


def lanes(rng: np.random.RandomState, L: int) -> dict:
    """{shape: (starts, lengths)} int32 arrays of the callers' lanes."""
    tail_start = (L // LEAF - 3) * LEAF
    split_len = rng.randint(1, LEAF // 64, size=64) * 64
    split_start = rng.randint(0, (L - LEAF) // 64, size=64) * 64
    span_len = rng.randint(1, LEAF, size=256)
    span_start = rng.randint(0, L // LEAF, size=256) * LEAF
    starts, lengths, pos = [], [], 777
    while len(starts) < 16384:
        n = int(rng.randint(512 << 10, 2 << 20))
        if pos + n > min(L, READ):
            break
        for off in range(0, n, LEAF):
            starts.append(pos + off)
            lengths.append(min(LEAF, n - off))
        pos += n
    pad = 16384 - len(starts)
    return {
        "fused_tail": (np.array([tail_start], np.int32),
                       np.array([LEAF - 1], np.int32)),
        "split": (split_start.astype(np.int32), split_len.astype(np.int32)),
        "spans": (span_start.astype(np.int32), span_len.astype(np.int32)),
        "legacy": (np.array(starts[:16384] + [0] * pad, np.int32),
                   np.array(lengths[:16384] + [0] * pad, np.int32)),
    }


def check(host: np.ndarray, starts, lengths, digests: np.ndarray) -> None:
    """Raise unless every lane's digest equals hashlib's."""
    dig = digests.view(np.uint32).astype(">u4")
    for b, (s, n) in enumerate(zip(starts.tolist(), lengths.tolist())):
        if dig[b].tobytes() != hashlib.sha256(host[s:s + n]).digest():
            raise AssertionError(f"lane {b} ({s}, {n}) differs from hashlib")


def call_ms(torch, fn, reps: int, graph: bool) -> float:
    """Least mean ms of ``fn()`` over ``reps`` calls, of 3 trials: eager,
    or replayed from one CUDA graph of ``reps`` calls (``graph``)."""
    fn()
    torch.cuda.synchronize()
    run, n = fn, reps
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        run, n = g.replay, 1
    best = float("inf")
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            run()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / reps)
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_leaf_calls: CUDA is not available", file=sys.stderr)
        return 2
    import volsync_tpu_torch
    from volsync_tpu_torch.ops.sha256 import sha256_chunks_device

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=False).stdout.strip()
    print(card, flush=True)
    rng = np.random.RandomState(args.seed)
    host = rng.randint(0, 256, size=(BUFFER,)).astype(np.uint8)
    data = torch.from_numpy(host).to("cuda")
    res = {}
    for name, (starts, lengths) in lanes(rng, BUFFER).items():
        s = torch.from_numpy(starts).to("cuda")
        n = torch.from_numpy(lengths).to("cuda")

        def call():
            return sha256_chunks_device(data, s, n, max_len=LEAF)

        check(host, starts, lengths, call().cpu().numpy())
        res[name] = {"lanes": int(starts.shape[0]),
                     "leaves": int((lengths > 0).sum()),
                     "eager_ms": call_ms(torch, call, args.reps, False),
                     "graph_ms": call_ms(torch, call, args.reps, True)}
    print(json.dumps({"card": card, "package": volsync_tpu_torch.__file__,
                      "shapes": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
