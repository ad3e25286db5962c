#!/usr/bin/env python3
"""Time ``merkle_roots`` at the shapes of its callers, and split each
warp of one launch into its parts.

    PYTHONPATH=. python3 volsync_tpu_torch/tools/time_root_calls.py \\
        [--seed N] [--reps R]

``ops.segment._root_digests_loop`` launches ``merkle_roots``
(``csrc/merkle.cu``) once a pass: the fused and batched passes
(``chunk_hash_segments``), the span form (``span_roots_device``: check,
restore, scrub, rclone) and the mesh's stacked page-major table
(``parallel/sharded_chunker.py``). The script builds seeded inputs on
the card and records the launch's arguments where a caller makes it:

- ``fused``: one 48 MiB segment through ``chunk_hash_segment`` (non-eof,
  128 lanes), as ``chip_smoke.py``'s kernels phase;
- ``batched8``, ``batched16``: ``chunk_hash_segments`` over 8 and 16
  lanes of 32 MiB (eof, each 12,345 bytes short), the service's pass
  (1,024 and 2,048 lane slots);
- ``lanes32``: 32 such lanes (4,096 slots), more live lanes than the
  card has SM sub-partitions;
- ``verify``: ``span_roots_device`` over ~64 MiB of page-aligned spans
  with the fused segment's chunk lengths and one empty span among them
  (a live mask that is not a prefix), padded to a multiple of 128
  lanes, as ``engine.chunker.hash_spans`` calls it;
- ``mesh``: a page-major table of 4 shards of 32 MiB and a chunk list
  over all of them, as the mesh's stacked tables;
- ``zero``: a zero-entropy 32 MiB segment: four 8 MiB chunks (1,025
  blocks each) beside 124 dead lanes;
- ``dead``: 2,048 lanes, none live (every lane stays at H0).

Each call's digests must equal hashlib's on sampled lanes (``VMRK1`` ||
le64(len) || the lane's page digests, from the table on the host). A
call is timed eagerly (CUDA events around ``--reps`` calls, the least
mean of 3 trials) and as the replay of a CUDA graph of ``--reps`` calls
(the device's time alone). Each shape's bound is the larger of the
longest lane's issue floor (64 rounds a block of 10 logic and shift
instructions, each a warp's 2 cycles of its sub-partition's integer ALU
pipe) and its dependency chain (3 dependent integer instructions a
round, each at the latency that ``csrc/probe.cu``'s MD5 chain measures
for one of its 4), at 1.98 GHz.

Where the package's ``csrc/merkle.cu`` exports ``vt_merkle_roots_split``,
the script also launches that instrumented instance at each shape and
summarises its per-warp records (``split_summary``): where each warp ran
(SM and sub-partition), its lanes and blocks, and the SM cycles of its
phases.

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

LEAF = 4096
SEGMENT = 48 << 20  # the fused path's padded segment
LANE = 32 << 20  # a batched pass's lane
SPAN_BYTES = 64 << 20  # the span form's buffer
ZERO_LEAVES = 2048  # leaves of a zero-entropy chunk (8 MiB: 1,025 blocks)
SHORT = 12345  # a service source's shortfall
SHAPES = ("fused", "batched8", "batched16", "lanes32", "verify", "mesh",
          "zero", "dead")
CLOCK_HZ = 1.98e9  # the H100 SXM's highest SM clock
#: The least issue of one SHA-256 round on one sub-partition: 10 logic
#: and shift instructions (Sigma0, Sigma1: 3 SHF + 1 LOP3 each; Ch, Maj:
#: 1 LOP3 each), 2 cycles each on the 16-lane integer ALU pipe.
ROUND_ISSUE_CYCLES = 10 * 2
#: Dependent integer instructions a round: e -> funnel shift -> LOP3
#: (Sigma1) -> add (the adds of the other terms made earlier).
ROUND_CHAIN_OPS = 3
H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F,
      0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

#: The fields of one warp's record in vt_merkle_roots_split's output, in
#: its order (csrc/merkle.cu MerkleSplit).
SPLIT_FIELDS = ("sm", "sub", "t0", "t1", "cycles", "long", "long_blocks",
                "short", "short_blocks", "prologue", "build", "wait",
                "rounds", "short_cycles", "lane", "lane_blocks", "pass1")


def lane_blocks(nleaves: np.ndarray, live: np.ndarray,
                nb_max: int) -> np.ndarray:
    """Blocks each lane runs, as the kernel and the reference count
    them (every lane none when no lane is live)."""
    nb = (32 * np.maximum(nleaves, 0) + 13 + 9 + 63) // 64
    return np.minimum(nb, nb_max) * bool(live.any())


def bounds(longest: int, op_cycles: float) -> dict:
    """The bound of a launch whose longest lane runs ``longest`` blocks:
    the larger of its issue floor and its dependency chain (ms)."""
    issue = longest * 64 * ROUND_ISSUE_CYCLES / CLOCK_HZ * 1e3
    chain = longest * 64 * ROUND_CHAIN_OPS * op_cycles / CLOCK_HZ * 1e3
    return {"issue_ms": issue, "chain_ms": chain,
            "bound_ms": max(issue, chain),
            "bound_kind": "issue" if issue >= chain else "chain"}


def split_summary(rec: np.ndarray) -> dict:
    """What one launch's per-warp records (``SPLIT_FIELDS`` columns) show:
    the kernel's span (the first warp's start to the last warp's end),
    the warps and sub-partitions that ran lanes, the heaviest
    sub-partition's load (blocks of warp chains, and of one-a-thread
    groups), the warp of the longest lane (its blocks, its cycles a
    round in the rounds, a block in builds and waits, its prologue, and
    the other warps with chains of more than one block that ran on its
    sub-partition while it ran), the warps that ran only lanes of one
    block, and the one-a-thread groups (their warps, lanes and SM cycles
    a block of their longest lanes)."""
    r = {k: rec[:, i] for i, k in enumerate(SPLIT_FIELDS)}
    ran = (r["long"] + r["short"]) > 0
    span_ns = int(r["t1"][ran].max() - r["t0"][ran].min()) if ran.any() \
        else 0
    load: dict = {}
    for i in np.flatnonzero(ran):
        key = (int(r["sm"][i]), int(r["sub"][i]))
        lb, sb = load.get(key, (0, 0))
        load[key] = (lb + int(r["long_blocks"][i]),
                     sb + int(r["short_blocks"][i]))
    grouped = ran & (r["short"] > 0)
    out = {"span_us": span_ns / 1e3, "warps": int(ran.sum()),
           "sub_partitions": len(load),
           "heaviest_sub_partition": None, "longest": None,
           "one_block_warps": int((ran & (r["long_blocks"] <= 1)
                                   & (r["short"] == 0)).sum()),
           "groups": {"warps": int(grouped.sum()),
                      "lanes": int(r["short"].sum()),
                      "cycles_per_block": (
                          int(r["short_cycles"].sum())
                          / max(int(r["short_blocks"].sum()), 1))}}
    if not load:
        return out
    key, (lb, sb) = max(load.items(), key=lambda kv: (kv[1][0], kv[1][1]))
    out["heaviest_sub_partition"] = {"sm": key[0], "sub": key[1],
                                     "chain_blocks": lb, "group_blocks": sb}
    chains = ran & (r["long_blocks"] > 0)
    if chains.any():
        w = int(np.flatnonzero(chains)[np.argmax(r["lane_blocks"][chains])])
        nb = max(int(r["long_blocks"][w]), 1)
        same = ((r["sm"] == r["sm"][w]) & (r["sub"] == r["sub"][w])
                & (r["long_blocks"] > 1) & (r["t0"] < r["t1"][w])
                & (r["t1"] > r["t0"][w]))
        same[w] = False
        out["longest"] = {
            "lane": int(r["lane"][w]), "blocks": int(r["lane_blocks"][w]),
            "warp_blocks": int(r["long_blocks"][w]),
            "warp_lanes": int(r["long"][w]),
            "us": (int(r["t1"][w]) - int(r["t0"][w])) / 1e3,
            "cycles": int(r["cycles"][w]),
            "round_cycles": int(r["rounds"][w]) / (64 * nb),
            "build_per_block": int(r["build"][w]) / nb,
            "wait_per_block": int(r["wait"][w]) / nb,
            "prologue": int(r["prologue"][w]),
            "pass1": int(r["pass1"][w]),
            "sharing_chains": int(same.sum()),
            "sharing_blocks": int(r["long_blocks"][same].sum())}
    return out


def launch_split(torch, seg, args, kw) -> dict | None:
    """``split_summary`` of one launch of the instrumented instance
    (``vt_merkle_roots_split``), the run of 3 with the shortest span;
    None where the package's merkle.cu has no such entry point. Raises
    unless its digests equal the product kernel's. Never a product
    path."""
    from volsync_tpu_torch.ops import _build

    lib = _build.load("merkle.cu")
    if not hasattr(lib, "vt_merkle_roots_split"):
        return None
    fn = lib.vt_merkle_roots_split
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.vt_merkle_roots_split_warps.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.vt_merkle_roots_split_warps.restype = ctypes.c_int
    flat, npp, page0, nleaves, lens, live = args
    C = page0.shape[0]
    dev = flat.device.index or 0
    warps = lib.vt_merkle_roots_split_warps(C, dev)
    out = torch.empty((C, 8), dtype=torch.int32, device=flat.device)
    rec = torch.zeros((warps, len(SPLIT_FIELDS)), dtype=torch.int64,
                      device=flat.device)
    want = seg._root_digests_loop(*args, **kw)
    best = None
    for _ in range(3):
        rec.zero_()
        rc = fn(flat.data_ptr(), flat.shape[0], npp, page0.data_ptr(),
                nleaves.data_ptr(), lens.data_ptr(), live.data_ptr(),
                out.data_ptr(), C, kw["nb_max"], int(kw["pagemajor"]),
                rec.data_ptr(), dev, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"vt_merkle_roots_split failed ({rc})")
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError("the split instance's digests differ")
        s = split_summary(rec.cpu().numpy())
        if best is None or s["span_us"] < best["span_us"]:
            best = s
    return best


def capture_root_call(seg, run) -> tuple:
    """(args, kwargs) of the one ``_root_digests_loop`` call ``run()``
    makes."""
    calls = []
    orig = seg._root_digests_loop

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    seg._root_digests_loop = rec
    try:
        run()
    finally:
        seg._root_digests_loop = orig
    if len(calls) != 1:
        raise AssertionError(f"expected one root launch, got {len(calls)}")
    return calls[0]


def _pass_kw(seg, P: int) -> dict:
    """A pass's keyword arguments at DEFAULT_PARAMS for P-byte lanes."""
    from volsync_tpu_torch.ops.gearcdc import DEFAULT_PARAMS as p

    cc, kc = seg.segment_caps(P, p)
    return dict(min_size=p.min_size, avg_size=p.avg_size,
                max_size=p.max_size, seed=p.seed, mask_s=p.mask_s,
                mask_l=p.mask_l, align=p.align, cand_cap=cc, chunk_cap=kc)


def chunk_lengths(args) -> list:
    """The live lanes' chunk lengths of a captured root launch."""
    _, _, _, _, lens, live = args
    return [int(v) for v in lens[live].cpu().tolist()]


def span_args(torch, seg, gen, sizes: list, dev: str) -> tuple:
    """``span_roots_device``'s root launch over ~64 MiB of page-aligned
    spans of ``sizes`` (cycled), one of them empty, in a buffer of
    seeded bytes, as ``hash_spans`` lays them out."""
    total, spans, k = SPAN_BYTES, [], 0
    pos = 0
    while True:
        n = sizes[k % len(sizes)]
        if pos + n > total:
            break
        spans.append((pos, n))
        pos += -(-n // LEAF) * LEAF
        k += 1
    spans.insert(len(spans) // 2, (pos, 0))
    n_cap = -(-len(spans) // 128) * 128
    starts = np.zeros((n_cap,), np.int64)
    lens = np.full((n_cap,), -1, np.int64)
    starts[:len(spans)] = [s for s, _ in spans]
    lens[:len(spans)] = [max(n, 0) or -1 for _, n in spans]
    buf = torch.randint(0, 256, (-(-pos // LEAF) * LEAF + LEAF,),
                        dtype=torch.uint8, device=dev, generator=gen)
    st, ln = (torch.from_numpy(a).to(dev) for a in (starts, lens))  # lint: ignore[VL502] the span shape's two index arrays, uploaded once (set-up)
    return capture_root_call(seg, lambda: seg.span_roots_device(
        buf, st, ln, max_len=int(lens.max())))


def shapes(torch, seg, gen, names: tuple, dev: str = "cuda") -> dict:
    """{name: (args, kwargs)} of ``_root_digests_loop`` at each shape
    (on ``dev``: the card, or the CPU for a rehearsal at small sizes)."""
    out = {}
    i64 = dict(dtype=torch.int64, device=dev)

    def rand_bytes(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    data = rand_bytes(SEGMENT)
    kw = _pass_kw(seg, SEGMENT)
    valid = SEGMENT - 5 * LEAF - 777
    out["fused"] = capture_root_call(seg, lambda: seg.chunk_hash_segment(
        data, valid, eof=False, **kw))
    sizes = chunk_lengths(out["fused"][0]) or [1 << 20]
    del data
    for name, S in (("batched8", 8), ("batched16", 16), ("lanes32", 32)):
        if name not in names:
            continue
        rows = rand_bytes(S, LANE)  # lint: ignore[VL502] one batch per lane count under test (set-up, untimed)
        n = LANE - SHORT
        rows[:, n:] = 0
        out[name] = capture_root_call(seg, lambda: seg.chunk_hash_segments(
            rows, [n] * S, [True] * S, **_pass_kw(seg, LANE)))
        del rows
        torch.cuda.empty_cache()
    if "verify" in names:
        out["verify"] = span_args(torch, seg, gen, sizes, dev)
    if "mesh" in names:
        W, npp = 4, LANE // LEAF
        flat = torch.randint(-2**31, 2**31 - 1, (W * npp * 8,),
                             dtype=torch.int32, device=dev, generator=gen)
        kc = _pass_kw(seg, W * LANE)["chunk_cap"]
        starts, lens, pos, k = [], [], 0, 0
        while pos < W * LANE - SHORT and len(starts) < kc:
            n = min(sizes[k % len(sizes)], W * LANE - SHORT - pos)
            starts.append(pos)
            lens.append(n)
            pos += n
            k += 1
        count = len(starts)
        st = torch.zeros((kc,), **i64)
        ln = torch.zeros((kc,), **i64)
        st[:count] = torch.tensor(starts, **i64)
        ln[:count] = torch.tensor(lens, **i64)
        live = torch.arange(kc, **i64) < count
        nl = torch.where(live, (ln + LEAF - 1) // LEAF, 0)
        out["mesh"] = ((flat, W * npp, st // LEAF, nl, ln, live),
                       dict(nb_max=seg._root_blocks_bound(8 << 20),
                            pagemajor=True))
    if "zero" in names:
        npp, n = 4 * ZERO_LEAVES, ZERO_LEAVES * LEAF
        zero = np.frombuffer(hashlib.sha256(bytes(LEAF)).digest(), ">u4")
        flat = torch.from_numpy(np.repeat(zero.astype(np.uint32), npp)
                                .view(np.int32)).to(dev)  # word-major
        C = 128
        live = torch.arange(C, device=dev) < 4
        page0 = torch.where(live, torch.arange(C, **i64) * ZERO_LEAVES, 0)
        nl = torch.where(live, ZERO_LEAVES, 0).to(torch.int64)
        ln = torch.where(live, n, 0).to(torch.int64)
        out["zero"] = ((flat, npp, page0, nl, ln, live),
                       dict(nb_max=seg._root_blocks_bound(n),
                            pagemajor=False))
    if "dead" in names:
        C, npp = 2048, 1024
        flat = torch.zeros((8 * npp,), dtype=torch.int32, device=dev)
        z = torch.zeros((C,), **i64)
        out["dead"] = ((flat, npp, z, z, z,
                        torch.zeros((C,), dtype=torch.bool, device=dev)),
                       dict(nb_max=seg._root_blocks_bound(8 << 20),
                            pagemajor=False))
    return {k: out[k] for k in names if k in out}


def check(args, kw, got, picks) -> None:
    """Raise unless the picked lanes equal hashlib's digest of their
    root message (H0 everywhere when no lane is live)."""
    flat, npp, page0, nleaves, lens, live = args
    tab = flat.cpu().numpy().view(np.uint32)
    p0, nl, ln = (t.cpu().numpy() for t in (page0, nleaves, lens))
    lv = live.cpu().numpy()
    g = got.cpu().numpy().view(np.uint32)
    blocks = lane_blocks(nl, lv, kw["nb_max"])
    for c in picks:
        if not lv.any():
            want = np.array(H0, np.uint32)
        else:
            n = max(int(nl[c]), 0)
            if (32 * n + 13 + 9 + 63) // 64 > blocks[c]:
                continue  # cut by nb_max: not a whole message
            pages = int(p0[c]) + np.arange(n)
            j = np.arange(8)
            idx = (pages[:, None] * 8 + j if kw["pagemajor"]
                   else j * npp + pages[:, None])
            body = tab[idx].astype(">u4").tobytes()
            msg = (b"VMRK1" + (int(ln[c]) & 0xFFFFFFFF).to_bytes(8, "little")
                   + body)
            want = np.frombuffer(hashlib.sha256(msg).digest(), ">u4")
        if not np.array_equal(g[c], want.astype(np.uint32)):
            raise AssertionError(f"lane {c} differs from hashlib")


def op_cycles(torch) -> float:
    """One dependent integer instruction's latency (SM cycles): the MD5
    chain probe's round (``csrc/probe.cu``, 4 dependent instructions)
    over 4, the least of 3."""
    from volsync_tpu_torch.ops import _build

    fn = _build.load("probe.cu").vt_probe_md5_chain
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    words = torch.arange(16, dtype=torch.int32, device="cuda")
    out = torch.zeros((3,), dtype=torch.int64, device="cuda")
    blocks, best = 4096, float("inf")
    for _ in range(3):
        rc = fn(words.data_ptr(), blocks, out.data_ptr(),
                torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"probe_md5_chain failed ({rc})")
        best = min(best, int(out.tolist()[0]) / (blocks * 64))
    return best / 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_root_calls: CUDA is not available", file=sys.stderr)
        return 2
    import volsync_tpu_torch
    from volsync_tpu_torch.ops import _build
    from volsync_tpu_torch.ops import segment as seg
    from volsync_tpu_torch.tools.time_leaf_calls import call_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=False).stdout.strip()
    print(card, flush=True)
    _build.build_all()
    lat = op_cycles(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    res = {}
    for name, (a, kw) in shapes(torch, seg, gen, SHAPES).items():
        def call(a=a, kw=kw):
            return seg._root_digests_loop(*a, **kw)  # lint: ignore[VL502] the timed call of one root shape

        got = call()
        C = a[2].shape[0]
        picks = sorted({0, 1, 2, C - 1} | set(range(3, C, max(1, C // 61)))
                       | set(np.flatnonzero(a[5].cpu().numpy())[:8]))
        check(a, kw, got, [c for c in picks if c < C])
        blocks = lane_blocks(a[3].cpu().numpy(), a[5].cpu().numpy(),
                             kw["nb_max"])
        live = a[5].cpu().numpy()
        res[name] = {
            "lanes": C, "live": int(live.sum()),
            "blocks": int(blocks.sum()), "longest": int(blocks.max()),
            "pagemajor": bool(kw["pagemajor"]),
            **bounds(int(blocks.max()), lat),
            "graph_ms": call_ms(torch, call, args.reps, True),
            "eager_ms": call_ms(torch, call, args.reps, False),
            "split": launch_split(torch, seg, a, kw)}
        print(f"{name}: {json.dumps(res[name])}", flush=True)
    print(json.dumps({"card": card, "package": volsync_tpu_torch.__file__,
                      "op_cycles": lat, "shapes": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
