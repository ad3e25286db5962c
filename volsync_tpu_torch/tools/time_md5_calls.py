#!/usr/bin/env python3
"""Time ``md5_slices`` at the shapes of its callers, and split one lane's
block loop into its parts.

    PYTHONPATH=. python3 volsync_tpu_torch/tools/time_md5_calls.py \\
        [--seed N] [--reps R]

The delta engine launches ``md5_slices`` (``csrc/md5.cu``) through
``ops.md5``: once a signature with a full block
(``md5_contiguous_blocks_device``) and once a scan group with
candidates (``md5_fixed_blocks_device``). The script builds seeded
buffers on the card and times four shapes:

- ``signature``: 16,384 contiguous 32 KiB windows of a 512 MiB buffer
  (``pick_block_len``'s block for a 512 MiB file), 513 blocks a lane;
- ``verify``: 8,192 4 KiB windows at odd starts of a 32 MiB buffer,
  one past its end, one its last window and one at a negative start
  (every byte index clamped into the buffer, as in the reference);
- ``sig_1mib``: a 1 MiB file's signature, 256 contiguous 4 KiB windows,
  the delta cell's most frequent launch;
- ``one_window``: one 32 KiB window, one thread's chain.

Each call's digests must equal hashlib's on sampled windows inside the
buffer. A call is timed eagerly (CUDA events around ``--reps`` calls,
the least mean of 3 trials) and as the replay of a CUDA graph of
``--reps`` calls (the device's time alone).

Where the package's ``csrc/md5.cu`` exports ``vt_md5_windows_split``,
the script also launches that instrumented instance of the kernel at
each shape and reports, for one lane, the SM cycles (clock64) its block
loop spent in each part, summed over its blocks: the copies' wait (and
any barrier), block classification and word assembly (the edge
blocks' words also apart), the 64 rounds, the copy issue, and the
loop's whole span; ``block_split`` below reads them.

The script imports ``volsync_tpu_torch`` from ``sys.path``:
``PYTHONPATH=<another checkout>`` times that checkout's kernel on the
same inputs, so two checkouts run in one job compare on one card. It
prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys

import numpy as np

SIG_WINDOWS, SIG_LEN = 16384, 32 << 10
VERIFY_WINDOWS, VERIFY_LEN, VERIFY_BUFFER = 8192, 4096, 32 << 20
SMALL_WINDOWS, SMALL_LEN = 256, 4096

#: The parts of vt_md5_windows_split's output, in its order (csrc/md5.cu
#: Md5Split).
SPLIT_PARTS = ("wait", "words", "edge", "rounds", "issue", "loop", "blocks")


def split_summary(raw) -> dict:
    """Per-block SM cycles of one lane's split from the kernel's raw
    sums (``SPLIT_PARTS`` order): each part over the blocks the lane
    compressed, and ``other``, the loop's span less the four timed
    parts (``edge`` is inside ``words``)."""
    cyc = dict(zip(SPLIT_PARTS, (int(v) for v in raw)))
    n = max(cyc["blocks"], 1)
    timed = cyc["wait"] + cyc["words"] + cyc["rounds"] + cyc["issue"]
    per = {k: cyc[k] / n for k in ("wait", "words", "edge", "rounds",
                                   "issue", "loop")}
    per["other"] = (cyc["loop"] - timed) / n
    return {"blocks": cyc["blocks"], "cycles": cyc, "per_block": per}


def block_split(torch, data, starts, block_len: int,
                lane: int) -> dict | None:
    """``split_summary`` of lane ``lane``'s block loop in one launch of the
    windows form's instrumented instance (``vt_md5_windows_split``), the
    run of 3 with the shortest loop; None where the package's md5.cu has
    no such entry point. Never a product path."""
    from volsync_tpu_torch.ops import _build

    lib = _build.load("md5.cu")
    if not hasattr(lib, "vt_md5_windows_split"):
        return None
    fn = lib.vt_md5_windows_split
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B = starts.shape[0]
    out = torch.empty((B, 4), dtype=torch.int32, device=data.device)
    split = torch.zeros((len(SPLIT_PARTS),), dtype=torch.int64,
                        device=data.device)
    best = None
    for _ in range(3):
        rc = fn(data.data_ptr(), data.shape[0], starts.data_ptr(), block_len,
                out.data_ptr(), B, split.data_ptr(), lane,
                data.device.index or 0,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"vt_md5_windows_split failed ({rc})")
        s = split_summary(split.tolist())
        if best is None or s["cycles"]["loop"] < best["cycles"]["loop"]:
            best = s
    best["lane"] = lane
    return best


def shapes(torch, rng: np.random.RandomState, gen) -> dict:
    """{name: (buffer on the card, int64 starts on the card, window
    length, host copy or None, split lanes)} of the four shapes."""
    sig = torch.randint(0, 256, (SIG_WINDOWS * SIG_LEN,), dtype=torch.uint8,
                        device="cuda", generator=gen)
    host = rng.randint(0, 256, size=(VERIFY_BUFFER,)).astype(np.uint8)
    L = host.shape[0]
    vstarts = rng.randint(0, L - VERIFY_LEN, size=VERIFY_WINDOWS) | 1
    vstarts[:3] = [L - 100, L - VERIFY_LEN, -5]
    small = torch.randint(0, 256, (SMALL_WINDOWS * SMALL_LEN,),
                          dtype=torch.uint8, device="cuda", generator=gen)

    def grid(n, bl):
        return torch.arange(n, dtype=torch.int64, device="cuda") * bl

    return {
        "signature": (sig, grid(SIG_WINDOWS, SIG_LEN), SIG_LEN, None,
                      [SIG_WINDOWS // 2]),
        "verify": (torch.from_numpy(host).to("cuda"),
                   torch.from_numpy(vstarts.astype(np.int64)).to("cuda"),
                   VERIFY_LEN, host, [VERIFY_WINDOWS // 2, 0, 2]),
        "sig_1mib": (small, grid(SMALL_WINDOWS, SMALL_LEN), SMALL_LEN, None,
                     [SMALL_WINDOWS // 2]),
        "one_window": (sig[:SIG_LEN], grid(1, SIG_LEN), SIG_LEN, None, [0]),
    }


def check(data, starts, bl: int, host, digests: list, picks) -> None:
    """Raise unless the picked windows inside the buffer equal hashlib."""
    st = starts.cpu().numpy()
    L = data.shape[0]
    for k in picks:
        a = int(st[k])
        if a < 0 or a + bl > L:
            continue
        win = host[a:a + bl] if host is not None else \
            data[a:a + bl].cpu().numpy()
        if digests[k] != hashlib.md5(win.tobytes()).digest():
            raise AssertionError(f"window {k} (start {a}) differs from "
                                 f"hashlib")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_md5_calls: CUDA is not available", file=sys.stderr)
        return 2
    import volsync_tpu_torch
    from volsync_tpu_torch.ops import md5
    from volsync_tpu_torch.tools.time_leaf_calls import call_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=False).stdout.strip()
    print(card, flush=True)
    rng = np.random.RandomState(args.seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    res = {}
    for name, (data, starts, bl, host, lanes) in shapes(torch, rng,
                                                         gen).items():
        if name == "verify":
            def call(data=data, starts=starts, bl=bl):
                return md5.md5_fixed_blocks_device(data, starts, block_len=bl)
        else:
            def call(data=data, bl=bl):
                return md5.md5_contiguous_blocks_device(data, block_len=bl)

        B = starts.shape[0]
        picks = sorted({k for k in (0, 1, 2, B - 1) if k < B}
                       | set(range(3, B, max(1, B // 61))))
        check(data, starts, bl, host, md5.state_bytes(call()), picks)
        res[name] = {"lanes": B, "blocks": B * ((bl + 72) // 64),
                     "eager_ms": call_ms(torch, call, args.reps, False),
                     "graph_ms": call_ms(torch, call, args.reps, True),
                     "split": [block_split(torch, data, starts, bl, lane)
                               for lane in lanes]}
    print(json.dumps({"card": card, "package": volsync_tpu_torch.__file__,
                      "shapes": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
