#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (volsync_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--stream-gib G] [--align64-gib G]
                          [--align1-mib M] [--pagemajor-gib G]

Run from the repository root on a machine with a CUDA card and nvcc. It
imports nothing of JAX or of the JAX package, and every phase raises on
a mismatch:

1. build: compiles every CUDA source of the port (one nvcc per source,
   started together) and prints nvcc's register report, the
   instructions of one message block of K1 (both instances), K2,
   sha256_slices (its three forms' loops), merkle_roots and sha256_lanes as
   compiled (``cuobjdump -sass``), the card's name and power limit, and
   the torch and CUDA versions;
2. kernels: runs one real 48 MiB segment through ``chunk_hash_segment``
   while recording each kernel wrapper's inputs, then holds every
   kernel of that pass (K1 sha256_pages, fastcdc_walk, the tail form of
   sha256_slices, merkle_roots) against its plain PyTorch twin on those
   inputs with ``torch.equal`` (K1 also against hashlib per page) and
   times kernel and twin; logs merkle_roots' chain bound (its longest
   lane in blocks x the least time of a block, from the compiled
   block's instruction issue) and the walk's (its longest lane's chunks
   x one dependent load, measured by a pointer chase,
   ``csrc/probe.cu``), and times ``merkle_roots`` on one 1,025-block
   lane alone and the tail form on a 4,095-byte tail (65 blocks). K3
   transpose_u32, off the fused path, is held and timed on [12,288,
   1,024] (the segment's page-word table) and a ragged shape, beside
   the one PyTorch call computing the same function. Then K5: K1 at
   32/64/128/256 threads per block on that segment's bytes, each equal
   to hashlib per page and timed; page-major K1: the same segment under
   ``VOLSYNC_PAGEMAJOR=1`` launches no ``pagemajor_u32``, its K1 launch
   equals its twin and hashlib, timed in turns with the word-major
   instance, and its packed result equals the word-major one; K4 timed
   alone on the word-major table; K2: a stream segment (48 MiB buffer,
   non-eof) through ``DeviceChunkHasher(align=64).begin``, which
   launches exactly one ``sha256_rows`` and one ``sha256_slices``, each
   equal to its twin, K2 also to hashlib per leaf, logged with its
   per-warp floor; sha256_slices at the legacy shape: a 32 MiB segment
   through ``DeviceChunkHasher(align=1).begin`` (one launch of 16,384
   lanes), equal to its twin and hashlib per lane, timed (also at the
   split-phase tails' shape) and bounded from the function's work (the
   whole card's ALU rate, and the per-warp floor of its longest lane);
   ``sha256_lanes``, which no path launches, held and timed on the
   padded messages the reference builds for the same lanes;
3. stream: sets every launch count to 0, streams a seeded ``--stream-gib``
   GiB + 12,345-byte volume (half of its 64 MiB blocks repeat earlier
   ones; one block is all zero) through ``stream_chunk_batches`` with
   ``DeviceChunkHasher(DEFAULT_PARAMS)`` in 32 MiB segments, reads the
   counts, and holds the cut list and every blob id against a host
   oracle (numpy gear candidates, the host FastCDC walk, hashlib blob
   ids); prints GiB/s and the dedup ratio. A second pass with each
   stage's functions bracketed by CUDA events gives per-stage device
   time, and a third plain pass the GiB/s spread; both must give the
   first pass's chunks;
4. verify: ``verify_blob_batch`` over 256 produced chunks returns [] and,
   with one byte flipped, exactly that chunk's id; its span-tail
   ``sha256_slices`` call equals its twin;
5. the other engines, each over its own seeded volume of the same
   pattern with the counts set to 0 before and read after, held against
   its own host oracle and against the launches it must make per device
   pass: the split-phase engine (``GearParams(align=64)``,
   ``--align64-gib``; exactly one ``sha256_rows`` and one
   ``sha256_slices`` per pass; then ``verify_blob_batch``), the legacy
   engine (``GearParams(align=1)``, ``--align1-mib``; a numpy
   per-position gear oracle; one ``sha256_slices`` per pass) and the
   fused engine under ``VOLSYNC_PAGEMAJOR=1`` (``--pagemajor-gib``; the
   fused launches, no ``pagemajor_u32``; chunks and ids equal to
   word-major passes over the same bytes, the layouts alternating
   pm/wm/wm/pm). Each stream also prints its host seconds by
   ``obs.span``.

The line before the last is the kernels JSON (launches on the stream
phase that runs each kernel, max difference from the twin, times and
bounds); the last line is ``{"ok": true, "device": {...}}``. Exits
nonzero, with no result, when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

GIB = 1 << 30
BLOCK = 64 << 20  # unit of the stream's redundancy pattern
SEGMENT_P = 48 << 20  # padded device buffer of a full 32 MiB segment

# Published H100 SXM peaks (700 W): 3.35 TB/s of HBM; 67 TFLOP/s fp32
# outside the tensor cores = 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
# Integer logic and shifts (LOP3, SHF) issue only on the integer ALU
# pipe, 16 lanes in each of an SM's 4 sub-partitions:
# 132 x 64 x 1.98e9 = 16.7e12 instructions/s.
INT32_ALU_OPS_PER_S = 132 * 64 * 1.98e9
# Least integer work of one SHA-256 compression in sm_90's instructions:
# a rotation is one funnel shift (SHF), any logic function of three
# words one LOP3, a sum of three words one IADD3. A round has Sigma0 and
# Sigma1 (3 SHF + 1 LOP3 each), Ch and Maj (1 LOP3 each): 10 logic and
# shift ops, plus 4 IADD3 (T1 = h+S1+ch+K+W, e = d+T1, a = T1+S0+maj).
# A schedule step has sigma0 and sigma1 (3 SHF + 1 LOP3 each): 8, plus 2
# IADD3. 8 adds fold the state. So a block (64 rounds, 48 steps) is
# 1,024 logic and shift ops and 360 adds. The adds can issue as IMAD on
# the FMA pipe beside the ALU pipe, and 1,024 + 600 two-input IMADs over
# the SM's 128-lane issue rate is less than 1,024 over the ALU pipe's 64
# lanes, so the ALU ops bound the time. K1's pad block is a constant
# message: its schedule and K+W sums fold away, leaving the rounds' 640.
# main() prints the compiled K1 block's instruction classes beside this.
SHA_BLOCK_ALU_OPS = 64 * 10 + 48 * 8
SHA_PAD_BLOCK_ALU_OPS = 64 * 10
#: merkle_roots' chain runs the rounds alone (its schedules are built a
#: tile at a time, one block a thread), so this is its per-block work.
SHA_ROUNDS_ALU_OPS = 64 * 10

REPLACES = {
    "transpose_u32": "volsync_tpu/ops/segment.py:248",
    "sha256_pages": "volsync_tpu/ops/sha256.py:367",
    "sha256_pages_pagemajor": "volsync_tpu/ops/segment.py:282",
    "sha256_lanes": "volsync_tpu/ops/sha256.py:144",
    "sha256_slices": "volsync_tpu/ops/sha256.py:438",
    "sha256_slices_tail": "volsync_tpu/ops/segment.py:126",
    "fastcdc_walk": "volsync_tpu/ops/segment.py:205",
    "sha256_rows": "volsync_tpu/ops/sha256.py:411",
    "pagemajor_u32": "volsync_tpu/ops/segment.py:282",
    "sha256_pages_sweep": "scripts/tune_sha.py:72",
    "merkle_roots": "volsync_tpu/ops/segment.py:367",
}
SOURCES = {
    "transpose_u32": "volsync_tpu_torch/csrc/transpose.cu",
    "sha256_pages": "volsync_tpu_torch/csrc/sha256.cu",
    "sha256_pages_pagemajor": "volsync_tpu_torch/csrc/sha256.cu",
    "sha256_lanes": "volsync_tpu_torch/csrc/sha256.cu",
    "sha256_slices": "volsync_tpu_torch/csrc/sha256.cu",
    "sha256_slices_tail": "volsync_tpu_torch/csrc/sha256.cu",
    "fastcdc_walk": "volsync_tpu_torch/csrc/fastcdc.cu",
    "sha256_rows": "volsync_tpu_torch/csrc/sha256.cu",
    "pagemajor_u32": "volsync_tpu_torch/csrc/transpose.cu",
    "sha256_pages_sweep": "volsync_tpu_torch/csrc/sha256.cu",
    "merkle_roots": "volsync_tpu_torch/csrc/merkle.cu",
}
#: K1 block sizes of the K5 sweep (the library launches 64).
SWEEP_THREADS = (32, 64, 128, 256)
#: Kernel launches per device pass of each engine's stream.
FUSED_PER_PASS = {"sha256_pages": 1, "fastcdc_walk": 1, "sha256_slices": 1,
                  "merkle_roots": 1}
SPLIT_PER_PASS = {"sha256_rows": 1, "sha256_slices": 1}
LEGACY_PER_PASS = {"sha256_slices": 1}
#: K1 stores the page-major table itself: no pagemajor_u32 launch.
PAGEMAJOR_PER_PASS = dict(FUSED_PER_PASS)


#: Device of every phase; the card unless a rehearsal sets "cpu".
DEVICE = "cuda"


def sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


class _HostEvent:
    """perf_counter stand-in for a CUDA event (CPU rehearsals)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def new_event(torch):
    if DEVICE == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostEvent()


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class StageTimer:
    """``timer(name)`` brackets a device stage with CUDA events on the
    current stream; ``totals_ms()`` sums each stage's elapsed times."""

    def __init__(self, torch):
        self._torch = torch
        self._events = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        a, b = new_event(self._torch), new_event(self._torch)
        a.record()
        yield
        b.record()
        self._events[name].append((a, b))

    def count(self, name: str) -> int:
        return len(self._events[name])

    def totals_ms(self) -> dict:
        sync(self._torch)
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self._events.items()}


def time_ms(torch, fn, reps: int, *, graph: bool = True) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after a warm-up,
    from CUDA events. On the card with ``graph`` the runs are captured
    into one CUDA graph and replayed between the events, so the time is
    the device's alone; without it (``graph=False``) the events also
    hold any gaps in which the card waits for Python to launch."""
    fn()
    sync(torch)
    a, b = new_event(torch), new_event(torch)
    if graph and DEVICE == "cuda":
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        sync(torch)
        a.record()
        g.replay()
        b.record()
    else:
        a.record()
        for _ in range(reps):
            fn()
        b.record()
    sync(torch)
    return a.elapsed_time(b) / reps


class SeededStream:
    """A ``readinto`` source of ``total`` bytes made from ``seed``: 64 MiB
    blocks, each odd block a repeat of a random earlier fresh block, the
    block at ``zero_block`` all zero. Fresh blocks are drawn on the card
    and held in host memory; nothing touches the disk."""

    def __init__(self, torch, seed: int, total: int):
        self.total = total
        nblocks = (total + BLOCK - 1) // BLOCK
        self.zero_block = (nblocks // 2) & ~1
        rng = np.random.default_rng(seed)
        self.plan, fresh = [], 0
        for b in range(nblocks):
            if b == self.zero_block:
                self.plan.append(-1)
            elif b % 2 == 1 and fresh:
                self.plan.append(int(rng.integers(fresh)))
            else:
                self.plan.append(fresh)
                fresh += 1
        gen = torch.Generator(device=DEVICE)
        self.unique = []
        for k in range(fresh):
            gen.manual_seed(seed * 1_000_003 + k)
            self.unique.append(torch.randint(
                0, 256, (BLOCK,), dtype=torch.uint8, device=DEVICE,
                generator=gen).cpu().numpy())
        self.zero = np.zeros((BLOCK,), np.uint8)
        self.pos = 0

    def block(self, b: int) -> np.ndarray:
        k = self.plan[b]
        return self.zero if k < 0 else self.unique[k]

    def view(self, off: int, n: int):
        """Bytes [off, off+n) of the stream (a view within one block)."""
        b, o = divmod(off, BLOCK)
        if o + n <= BLOCK:
            return memoryview(self.block(b))[o: o + n]
        return bytes(self.view(off, BLOCK - o)) + bytes(
            self.view(off + BLOCK - o, n - (BLOCK - o)))

    def readinto(self, mv) -> int:
        n = min(len(mv), self.total - self.pos, BLOCK - self.pos % BLOCK)
        if n <= 0:
            return 0
        np.frombuffer(mv, np.uint8, count=n)[:] = np.asarray(
            self.view(self.pos, n))
        self.pos += n
        return n

    def read(self, n: int) -> bytes:
        n = min(n, self.total - self.pos, BLOCK - self.pos % BLOCK)
        out = bytes(self.view(self.pos, n)) if n > 0 else b""
        self.pos += len(out)
        return out


@contextlib.contextmanager
def patched(module, wrappers: dict):
    """Within the block, ``module.<name>`` is ``wrappers[name](original)``;
    the originals come back on exit."""
    saved = {n: getattr(module, n) for n in wrappers}
    try:
        for n, make in wrappers.items():
            setattr(module, n, make(saved[n]))
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


#: The kernel wrappers ``capture_calls`` records, attribute -> kernel
#: entry, in ops/segment.py, ops/sha256.py and engine/chunker.py (which
#: calls ``sha256_chunks_device`` by its own name).
#: "sha256_slices_tail" is the table-writing form of sha256_slices.
SEG_WRAPPERS = {"transpose_u32": "transpose_u32",
                "sha256_pages": "sha256_pages",
                "fastcdc_walk": "fastcdc_walk",
                "pagemajor_u32": "pagemajor_u32",
                "tail_leaves_into": "sha256_slices_tail",
                "_root_digests_loop": "merkle_roots"}
SHA_WRAPPERS = {"sha256_blocks": "sha256_lanes", "sha256_rows": "sha256_rows",
                "sha256_chunks_device": "sha256_slices"}
CHUNKER_WRAPPERS = {"sha256_chunks_device": "sha256_slices"}


def capture_calls(seg, sha, run) -> list:
    """Run ``run()`` with every kernel wrapper of the segment pipeline
    recording (clones of) its inputs; returns [(kernel, args, kwargs)]."""
    import torch

    from volsync_tpu_torch.engine import chunker

    calls = []

    def recorder(kernel):
        def make(fn):
            def wrapper(*args, **kwargs):
                calls.append((kernel,
                              [a.clone() if isinstance(a, torch.Tensor)
                               else a for a in args], dict(kwargs)))
                return fn(*args, **kwargs)
            return wrapper
        return make

    with patched(seg, {a: recorder(k) for a, k in SEG_WRAPPERS.items()}), \
            patched(sha, {a: recorder(k) for a, k in SHA_WRAPPERS.items()}), \
            patched(chunker, {a: recorder(k)
                              for a, k in CHUNKER_WRAPPERS.items()}):
        run()
    return calls


@contextlib.contextmanager
def pagemajor_env(on: bool = True):
    """Within the block, ``VOLSYNC_PAGEMAJOR`` is set (or unset)."""
    saved = os.environ.get("VOLSYNC_PAGEMAJOR")
    if on:
        os.environ["VOLSYNC_PAGEMAJOR"] = "1"
    else:
        os.environ.pop("VOLSYNC_PAGEMAJOR", None)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("VOLSYNC_PAGEMAJOR", None)
        else:
            os.environ["VOLSYNC_PAGEMAJOR"] = saved


#: Device stages of ``chunk_hash_segments``, each the segment-module
#: functions it is timed over; "walk.kernel", "pages.K1", "roots.tail"
#: and "roots.merkle" are the kernels inside "walk", "pages" and "roots".
STAGES = {
    "gear": ("gear_at_aligned", "_compact_candidates"),
    "walk": ("_select_boundaries_device",),
    "walk.kernel": ("fastcdc_walk",),
    "pages": ("_page_digests_flat",),
    "pages.K1": ("sha256_pages",),
    "roots": ("tail_leaves_into", "_root_digests_loop"),
    "roots.tail": ("tail_leaves_into",),
    "roots.merkle": ("_root_digests_loop",),
}


def stage_probes(seg, timer: "StageTimer"):
    """Context in which every function of ``STAGES`` runs inside
    ``timer(stage)`` for each stage that lists it."""
    stages = defaultdict(list)
    for stage, fns in STAGES.items():
        for fn in fns:
            stages[fn].append(stage)

    def probe(names):
        def make(fn):
            def wrapper(*args, **kwargs):
                with contextlib.ExitStack() as stack:
                    for name in names:
                        stack.enter_context(timer(name))
                    return fn(*args, **kwargs)
            return wrapper
        return make

    return patched(seg, {fn: probe(names) for fn, names in stages.items()})


def sass_block_counts(sass: str, kernel: str, loads: int,
                      load_op: str = "LDGSTS") -> dict | None:
    """Instructions of one message block of ``kernel`` in ``cuobjdump
    -sass`` text, by class: the body of the kernel's block loop (the
    shortest backward branch whose span holds at least ``loads``
    ``load_op`` instructions) divided by the blocks it covers
    (``loads`` each). None when no such loop is found."""
    fn = re.search(rf"Function : \S*{kernel}\S*\n(.*?)(?=Function : |\Z)",
                   sass, re.S)
    if fn is None:
        return None
    ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?\w+\s+)?([A-Z][A-Z0-9_.]*)"
        r"\s*([^;]*);", fn.group(1))]
    loops = []
    for addr, op, rest in ins:
        tgt = re.match(r"0x([0-9a-f]+)", rest.strip())
        if op.startswith("BRA") and tgt and int(tgt.group(1), 16) < addr:
            lo = int(tgt.group(1), 16)
            body = [o for a, o, _ in ins if lo <= a <= addr]
            n_ld = sum(o.split(".")[0] == load_op for o in body)
            if n_ld >= loads:
                loops.append((len(body), n_ld, body))
    if not loops:
        return None
    _, n_ld, body = min(loops, key=lambda x: x[0])
    classes = {"LOP3/SHF": ("LOP3", "LOP", "SHF", "PRMT"),
               "IADD3": ("IADD3", "IADD"), "IMAD": ("IMAD",),
               load_op: (load_op,)}
    out = dict.fromkeys([*classes, "other"], 0)
    for op in body:
        base = op.split(".")[0]
        out[next((k for k, v in classes.items() if base in v), "other")] += 1
    nblk = n_ld // loads
    return {k: v / nblk for k, v in out.items()}


def sass_blocks() -> dict:
    """``sass_block_counts`` of K1's two instances (word-major and
    page-major) and K2 (4 16-byte cp.async a block: a thread copies 64
    bytes of its block's messages per message block), of
    ``sha256_slices``' three forms (5 a block: 80-byte windows), of merkle_roots' chain (64 shared K+W reads a
    block) and of ``sha256_lanes`` (4 16-byte loads a block) in the built
    libraries; empty when the toolkit has no cuobjdump."""
    from volsync_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}

    def dump(src):
        return subprocess.run([str(tool), "-sass",
                               str(_build.library_path(src))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout

    sha = dump("sha256.cu")
    return {"K1": sass_block_counts(sha, "sha256_pages_kernelILb0E", 4),
            "K1 page-major": sass_block_counts(sha,
                                               "sha256_pages_kernelILb1E", 4),
            "K2": sass_block_counts(sha, "sha256_rows_kernel", 4),
            **{name: sass_block_counts(sha, f"sha256_slices_kernelI{lanes}",
                                       5)
               for name, lanes in (("sha256_slices", "10SliceLanes"),
                                   ("sha256_slices_tail", "10ChunkTails"),
                                   ("sha256_slices_spans", "9SpanTails"))},
            "merkle_roots": sass_block_counts(dump("merkle.cu"),
                                              "merkle_roots_kernel", 64,
                                              "LDS"),
            "sha256_lanes": sass_block_counts(sha, "sha256_lanes_kernel", 4,
                                              "LDG")}


def as_list(x):
    return list(x) if isinstance(x, tuple) else [x]


def max_abs_err(torch, got, want) -> int:
    err = 0
    for g, w in zip(as_list(got), as_list(want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        d = ((g.to(torch.int64) & 0xFFFFFFFF)
             - (w.to(torch.int64) & 0xFFFFFFFF)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def kernel_fns(seg, sha) -> tuple:
    """(wrapper, plain twin) dicts by kernel name; taken outside any
    ``capture_calls`` block, so the wrappers are the library's own."""
    kernel = {"transpose_u32": seg.transpose_u32,
              "sha256_pages": sha.sha256_pages,
              "fastcdc_walk": seg.fastcdc_walk,
              "sha256_lanes": sha.sha256_blocks,
              "sha256_slices": sha.sha256_chunks_device,
              "sha256_slices_tail": seg.tail_leaves_into,
              "sha256_rows": sha.sha256_rows,
              "pagemajor_u32": seg.pagemajor_u32,
              "merkle_roots": seg._root_digests_loop}
    plain = {"transpose_u32": seg._transpose_plain,
             "sha256_pages": sha._sha256_pages_plain,
             "fastcdc_walk": seg._fastcdc_walk_twin,
             "sha256_lanes": sha._sha256_lanes_plain,
             "sha256_slices": sha._sha256_chunks_plain,
             "sha256_slices_tail": seg._tail_leaves_plain,
             "sha256_rows": lambda data, rows0, leaf_len=4096:
                 sha._sha256_rows(sha.pack_words(data), rows0, leaf_len),
             "pagemajor_u32": seg._pagemajor_plain,
             "merkle_roots": seg._root_digests_plain}
    return kernel, plain


def against_twin(torch, fns, name, args, kwargs) -> tuple:
    """Kernel ``name`` and its twin on the same inputs; raises unless
    they are equal -> (kernel output, twin output, max abs err, twin
    seconds). The kernel gets clones of the tensors (the table form
    writes into its table)."""
    kernel, plain = fns
    out_k = kernel[name](*[a.clone() if hasattr(a, "clone") else a
                           for a in args], **kwargs)
    sync(torch)
    t0 = time.perf_counter()
    out_p = plain[name](*args, **kwargs)
    sync(torch)
    plain_s = time.perf_counter() - t0
    err = max_abs_err(torch, out_k, out_p)
    if not all(torch.equal(a, b) for a, b in zip(as_list(out_k),
                                                  as_list(out_p))):
        shapes = [tuple(a.shape) for a in args if hasattr(a, "shape")]
        raise AssertionError(f"{name} differs from its plain twin (max abs "
                             f"err {err}) at {shapes}")
    return out_k, out_p, err, plain_s


def expect_calls(label: str, calls, want: list) -> None:
    got = sorted(n for n, _, _ in calls)
    if got != sorted(want):
        raise AssertionError(f"{label} launched {got}, expected "
                             f"{sorted(want)}")


def sha_bound(data_blocks: int, pad_blocks: int, nbytes: int) -> tuple:
    """(bound ms, what bounds it) of SHA-256 over ``data_blocks``
    message blocks and ``pad_blocks`` constant pad blocks that move
    ``nbytes``."""
    t_ops = (data_blocks * SHA_BLOCK_ALU_OPS
             + pad_blocks * SHA_PAD_BLOCK_ALU_OPS) / INT32_ALU_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


FUSED_CALLS = ["sha256_pages", "fastcdc_walk", "sha256_slices_tail",
               "merkle_roots"]

# One SM sub-partition (scheduler) issues one instruction a cycle, and a
# warp's ALU instruction over 2 cycles (16 lanes), so a warp alone on its
# scheduler runs at most 16 ALU lanes a cycle. The H100 SXM's highest SM
# clock (nvidia-smi clocks.max.sm: 1,980 MHz).
CLOCK_HZ = 1.98e9


def chain_block_floor_ms(counts: dict | None) -> float | None:
    """Least time of one message block of a serial SHA chain, from its
    compiled instructions (``sass_block_counts``): the block's warp is
    alone on its scheduler, so it takes at least max(2 x its ALU-pipe
    instructions (LOP3/SHF/PRMT, IADD3), all its instructions) cycles.
    None without the counts."""
    if not counts:
        return None
    alu = counts["LOP3/SHF"] + counts["IADD3"]
    return max(2 * alu, sum(counts.values())) / CLOCK_HZ * 1e3


def page_table(host: np.ndarray, npp: int) -> np.ndarray:
    """hashlib's SHA-256 of every page of ``host`` and of zero pages up
    to ``npp``, as the word-major [8, npp] u32 table K1 writes."""
    F = host.shape[0] // 4096
    raw = b"".join(hashlib.sha256(host[p * 4096:(p + 1) * 4096]).digest()
                   for p in range(F))
    raw += hashlib.sha256(bytes(4096)).digest() * (npp - F)
    return np.frombuffer(raw, ">u4").reshape(npp, 8).T.astype(np.uint32)


#: ALU work of one thread's 4 KiB message: 64 data blocks and a pad block.
LEAF_ALU_OPS = 64 * SHA_BLOCK_ALU_OPS + SHA_PAD_BLOCK_ALU_OPS


def warp_floor_ms(lanes: int, threads: int,
                  lane_ops: int = LEAF_ALU_OPS) -> float:
    """Per-warp floor of a SHA kernel that gives each thread one message
    (``threads`` a block), from the function's work: the blocks spread
    over the 132 SMs, an SM's warps over its 4 schedulers, and each
    scheduler's warps issue their longest lane's ALU work (``lane_ops``;
    K1 and K2: a 4 KiB message, 65 x 1,024 + 640) at 16 lanes a cycle,
    one after another. With one lane it is that lane's serial chain."""
    blocks_per_sm = -(-(-(-lanes // threads)) // 132)
    per_sched = -(-blocks_per_sm * (threads // 32) // 4)
    return per_sched * lane_ops * 2 / CLOCK_HZ * 1e3


#: Entries of the probe's two chases: 256 KiB of cycle in L2 (its loads
#: skip L1) and 16 KiB in shared memory.
PROBE_L2_ENTRIES = 1 << 16
PROBE_SHARED_ENTRIES = 4096
PROBE_STEPS = 1 << 16


def probe_latency_ns(torch, seed: int = 0) -> dict:
    """One dependent load's latency from L2 and from shared memory: a
    one-thread pointer chase over a random cycle (``csrc/probe.cu``, no
    port of a TPU kernel), timed inside the kernel by %globaltimer (ns,
    at the clocks the card ran) and clock64 (SM cycles); the least of 3
    chases each -> {"l2_ns", "l2_cycles", "shared_ns",
    "shared_cycles"}."""
    import ctypes

    from volsync_tpu_torch.ops import _build

    fn = _build.load("probe.cu").vt_probe_chase
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(seed)
    res = {}
    for name, n, shared in (("l2", PROBE_L2_ENTRIES, 0),
                            ("shared", PROBE_SHARED_ENTRIES, 1)):
        order = rng.permutation(n)
        nxt = np.empty((n,), np.int32)
        nxt[order] = np.roll(order, -1)  # one cycle through all n
        dev_next = torch.from_numpy(nxt).to(DEVICE)
        out = torch.zeros((3,), dtype=torch.int64, device=DEVICE)
        runs = []
        for _ in range(3):
            rc = fn(dev_next.data_ptr(), n, PROBE_STEPS, shared,
                    out.data_ptr(), torch.cuda.current_device(),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"probe_chase launch failed ({rc})")
            runs.append(out.tolist()[:2])
        cycles, ns = min(runs, key=lambda r: r[1])
        res[f"{name}_ns"] = ns / PROBE_STEPS
        res[f"{name}_cycles"] = cycles / PROBE_STEPS
    return res


def walk_bound(torch, args, out, lat_ns: dict) -> dict:
    """Bound of one ``fastcdc_walk`` launch, the larger of its bytes and
    its chain. Bytes: each lane's candidates up to its last cut read
    once, the lanes' counts, lengths and eof flags, and the outputs
    written, over HBM's rate. Chain: the first windows' dependent L2
    load, then one dependent step a chunk of the longest lane, each at
    least a shared-memory load's latency (the decision's ballot and
    shuffle on the previous cut)."""
    pos_s, _, pos_l, _, _, _ = args
    starts, _, count, consumed = out
    last = consumed.to(torch.int64)[:, None] - 1
    n_read = int((pos_s <= last).sum()) + int((pos_l <= last).sum())
    S, chunk_cap = starts.shape
    nbytes = n_read * 8 + S * (3 * 8 + 1) + S * chunk_cap * 8 + S * 8
    longest = int(count.max()) if S else 0
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chain_ms = (lat_ns["l2_ns"] + longest * lat_ns["shared_ns"]) * 1e-6
    return {"bytes_ms": bytes_ms, "chain_ms": chain_ms,
            "bound_ms": max(bytes_ms, chain_ms),
            "bound_by": "bytes" if bytes_ms >= chain_ms else "operations",
            "longest": longest, "candidates": n_read}


def root_lane_blocks(torch, nleaves, live, nb_max: int):
    """Blocks each lane of a root launch runs ([C] int64), as the kernel
    and the reference count them."""
    nb = (32 * nleaves + 13 + 9 + 63) // 64
    return nb.clamp(max=nb_max) * live.any()


def new_stats() -> defaultdict:
    """Per-kernel measurements of the kernels phase, by kernel name."""
    return defaultdict(lambda: {"err": 0, "ms": [], "eager_ms": [],
                                "plain_ms": [], "bound": [], "bound_by": "",
                                "lib": []})


def kernel_phase(torch, stream, p, seg_bytes: int, p64, p1,
                 lat_ns: dict) -> dict:
    from volsync_tpu_torch.ops import segment as seg
    from volsync_tpu_torch.ops import sha256 as sha

    host = np.concatenate([stream.block(0), stream.block(1)])[:seg_bytes]
    valid = seg_bytes - 5 * 4096 - 777  # a full segment, non-eof
    data = torch.from_numpy(host).to(DEVICE)
    cc, kc = seg.segment_caps(seg_bytes, p)
    kw = dict(min_size=p.min_size, avg_size=p.avg_size,
              max_size=p.max_size, seed=p.seed, mask_s=p.mask_s,
              mask_l=p.mask_l, align=p.align, eof=False, cand_cap=cc,
              chunk_cap=kc)
    packed = []
    with pagemajor_env(False):
        calls = capture_calls(seg, sha, lambda: packed.append(
            seg.chunk_hash_segment(data, valid, **kw)))
    sync(torch)
    expect_calls("fused segment", calls, FUSED_CALLS)

    fns = kernel_fns(seg, sha)
    F = seg_bytes // 4096
    # K3 left the fused path: it is held on the segment's page-word table
    # shape, which it transposed there, and on a ragged shape.
    extra = [("transpose_u32", [torch.randint(
        -2**31, 2**31 - 1, (F, 1024), dtype=torch.int32,
        device=DEVICE)], {}),
        ("transpose_u32", [torch.randint(
            -2**31, 2**31 - 1, (1000, 77), dtype=torch.int32,
            device=DEVICE)], {})]
    stats = new_stats()
    k1 = None
    for name, args, kwargs in calls + extra:
        out_k, out_p, err, plain_s = against_twin(torch, fns, name, args,
                                                  kwargs)
        st = stats[name]
        st["err"] = max(st["err"], err)
        if name == "transpose_u32" and args[0].shape[1] != 1024:
            log(f"K3 transpose_u32 {tuple(args[0].shape)}: equals twin")
            continue
        if name == "sha256_pages":
            npp = args[1]
            want = page_table(host, npp)
            if not np.array_equal(
                    out_k.cpu().numpy().view(np.uint32).reshape(8, npp),
                    want):
                raise AssertionError("K1 differs from hashlib")
            k1 = (args[0], npp, want)
            log(f"K1 sha256_pages: {F} pages (of {npp}) equal hashlib and "
                f"the twin")
        reps = {"merkle_roots": 10}.get(name, 20)
        st["ms"].append(time_ms(
            torch, lambda: fns[0][name](*args, **kwargs), reps))
        st["eager_ms"].append(time_ms(
            torch, lambda: fns[0][name](*args, **kwargs), reps, graph=False))
        st["plain_ms"].append(plain_s * 1e3)
        if name == "transpose_u32":
            x = args[0]
            nbytes = 2 * x.numel() * 4
            st["bound"].append(nbytes / HBM_BYTES_PER_S * 1e3)
            st["bound_by"] = "bytes"
            st["lib"].append(time_ms(torch, lambda: x.t().contiguous(), 20))
        elif name == "sha256_pages":
            bound, st["bound_by"] = sha_bound(64 * npp, npp,
                                              F * 4096 + npp * 32)
            st["bound"].append(bound)
            log(f"K1: per-warp floor "
                f"{warp_floor_ms(npp, sha.PAGES_THREADS):.4f} ms")
        elif name == "merkle_roots":
            root_checks(torch, seg, st, args, kwargs)
        elif name == "sha256_slices_tail":
            tail_checks(torch, stats, args, kwargs)
        else:  # fastcdc_walk: a serial chain of decisions
            b = walk_bound(torch, args, out_k, lat_ns)
            st["bound"].append(b["bound_ms"])
            st["bound_by"] = b["bound_by"]
            st["bound_kind"] = "chain" if b["chain_ms"] > b["bytes_ms"] \
                else "work"
            st["longest"] = b["longest"]
            log(f"fastcdc_walk: {out_k[2].shape[0]} lanes, longest lane "
                f"{b['longest']} chunks; bytes bound {b['bytes_ms']:.6f} "
                f"ms ({b['candidates']} candidates up to the last cuts, "
                f"the outputs), chain bound {b['chain_ms']:.6f} ms (one "
                f"dependent L2 load + {b['longest']} x one dependent "
                f"shared-memory load)")
        log(f"{name}: equals twin; kernel {st['ms'][-1]:.4f} ms/launch "
            f"(eager {st['eager_ms'][-1]:.4f}), twin {plain_s*1e3:.1f} ms")

    sweep_k1(torch, stats, *k1)
    pagemajor_check(torch, fns, stats, data, valid, kw, packed[0], k1)
    split_segment_check(torch, fns, stats, host, p64)
    legacy_segment_check(torch, fns, stats, host, p1)
    return stats


def root_checks(torch, seg, st, args, kwargs) -> None:
    """Bound and longest lane of the segment's root launch, and
    ``merkle_roots`` on one 1,025-block lane alone (its measured time a
    block, beside the chain floor ``main`` takes from the SASS)."""
    flat, npp, page0, nleaves, lens, live = args
    lanes = root_lane_blocks(torch, nleaves, live, kwargs["nb_max"])
    total, st["longest"] = int(lanes.sum()), int(lanes.max())
    C = page0.shape[0]
    nbytes = int(nleaves.sum()) * 32 + C * (3 * 8 + 1) + C * 32
    bound, st["bound_by"] = sha_bound(total, 0, nbytes)
    st["bound"].append(bound)

    one = [flat, npp] + [torch.tensor([v], dtype=torch.int64, device=DEVICE)
                         for v in (0, 2048, 8 << 20)] + [
        torch.tensor([True], device=DEVICE)]
    one_ms = time_ms(torch, lambda: seg._root_digests_loop(*one, **kwargs),
                     10)
    st["one_lane_block_ms"] = one_ms / 1025
    log(f"merkle_roots: {C} lanes, {int(live.sum())} live, {total} blocks, "
        f"longest lane {st['longest']} blocks; one 1,025-block lane "
        f"{one_ms:.4f} ms = {st['one_lane_block_ms'] * 1e3:.4f} us a block")


def slice_work(torch, lengths, n_max: int) -> dict:
    """Work of sha256_slices lanes of these lengths: message blocks
    (each holding message bytes), padding-only blocks, message bytes,
    the longest lane's blocks (the FIPS count, at most ``n_max``) and
    the most ALU work of one lane (1,024 a message block, 640 a
    padding-only block, as ``sha_bound`` counts them)."""
    n = lengths.to(torch.int64)
    nb = ((n + 72) // 64).clamp(0, n_max)
    data = torch.minimum((n.clamp(min=0) + 63) // 64, nb)
    ops = data * SHA_BLOCK_ALU_OPS + (nb - data) * SHA_PAD_BLOCK_ALU_OPS
    return {"data_blocks": int(data.sum()), "pad_blocks": int((nb - data)
                                                              .sum()),
            "bytes": int(n.clamp(min=0).sum()),
            "longest": int(nb.max()) if n.numel() else 0,
            "lane_ops": int(ops.max()) if n.numel() else 0}


def lanes_bound(lanes: int, threads: int, lane_ops: int, work: tuple) -> dict:
    """Bound of a launch that gives each thread one SHA message, from the
    function's work alone: the larger of ``work`` (``sha_bound``: the
    whole card's ALU rate or HBM) and the per-warp floor of its longest
    lane (``warp_floor_ms`` with that lane's ``lane_ops``; for one lane,
    its blocks one after another)."""
    ops_ms, by = work
    floor = warp_floor_ms(lanes, threads, lane_ops)
    if ops_ms >= floor:
        return {"bound_ms": ops_ms, "bound_by": by, "bound_kind": "work",
                "floor_ms": floor}
    return {"bound_ms": floor, "bound_by": "operations",
            "bound_kind": "per-warp floor", "floor_ms": floor}


def set_bound(st, b: dict) -> None:
    st["bound"].append(b["bound_ms"])
    st["bound_by"], st["bound_kind"] = b["bound_by"], b["bound_kind"]


def tail_bound(torch, args, kwargs) -> dict:
    """Work and bound of one launch of the chunk-table tail form."""
    from volsync_tpu_torch.ops import segment as seg
    from volsync_tpu_torch.ops import sha256 as sha

    flat, npp, data, starts, lens, count = args
    S = count.shape[0]
    _, tl, _, has = seg._tail_lanes(starts, lens, count,
                                    lane_pages=kwargs["lane_pages"],
                                    L=data.shape[0])
    w = slice_work(torch, tl[has], sha.slice_blocks(seg.LEAF_SIZE))
    nbytes = w["bytes"] + S * 12 + int(has.sum()) * 32
    return {**w, "lanes": S, "max_tail": int(tl.max()),
            **lanes_bound(S, sha.SLICES_THREADS, w["lane_ops"], sha_bound(
                w["data_blocks"], w["pad_blocks"], nbytes))}


def tail_checks(torch, stats, args, kwargs) -> None:
    """The fused segment's tail launch (the table form's entry, timed by
    ``kernel_phase``; a non-eof segment's lane may end on the page grid
    and have no tail) with its bound, and the longest tail a pass can
    have: its last chunk cut one byte short of its page (4,095 bytes,
    65 blocks), held against the twin and timed."""
    from volsync_tpu_torch.ops import segment as seg
    from volsync_tpu_torch.ops import sha256 as sha

    st = stats["sha256_slices_tail"]
    b = tail_bound(torch, args, kwargs)
    set_bound(st, b)
    st["longest"] = b["longest"]
    flat, npp, data, starts, lens, count = args
    longer = lens.clone()
    last = (count.to(torch.int64) - 1).clamp(min=0)
    longer[torch.arange(count.shape[0], device=lens.device), last] -= 1
    args2 = [flat.clone(), npp, data, starts, longer, count]
    against_twin(torch, kernel_fns(seg, sha), "sha256_slices_tail", args2,
                 kwargs)
    b2 = tail_bound(torch, args2, kwargs)
    ms = time_ms(torch, lambda: seg.tail_leaves_into(*args2, **kwargs), 20)
    eager = time_ms(torch, lambda: seg.tail_leaves_into(*args2, **kwargs),
                    20, graph=False)
    st["shapes"] = {
        label: {"lanes": x["lanes"], "blocks": x["data_blocks"]
                + x["pad_blocks"], "ms": t, "eager_ms": e,
                "bound_ms": x["bound_ms"], "bound_kind": x["bound_kind"]}
        for label, x, t, e in (
            ("fused_tail", b, st["ms"][-1], st["eager_ms"][-1]),
            (f"tail_{b2['max_tail']}", b2, ms, eager))}
    for label, x in st["shapes"].items():
        log(f"sha256_slices {label}: {x['lanes']} lane(s), {x['blocks']} "
            f"blocks; kernel {x['ms']:.4f} ms (eager {x['eager_ms']:.4f}), "
            f"bound {x['bound_ms']:.4f} ms ({x['bound_kind']})")


def slices_shape(torch, stats, label: str, args, kwargs, plain_s: float,
                 main: bool) -> None:
    """sha256_slices at one engine's shape: kernel time, its work and
    bound; the legacy shape (``main``) is its entry, and there
    ``sha256_lanes`` is held and timed on the same lanes' padded
    blocks."""
    from volsync_tpu_torch.ops import sha256 as sha

    data, starts, lengths = args
    max_len = kwargs["max_len"]
    st = stats["sha256_slices"]

    def run():
        return sha.sha256_chunks_device(data, starts, lengths,
                                        max_len=max_len)

    ms = time_ms(torch, run, 20)
    eager = time_ms(torch, run, 20, graph=False)
    B = starts.shape[0]
    w = slice_work(torch, lengths, sha.slice_blocks(max_len))
    b = lanes_bound(B, sha.SLICES_THREADS, w["lane_ops"], sha_bound(
        w["data_blocks"], w["pad_blocks"], w["bytes"] + B * 40))
    st.setdefault("shapes", {})[label] = {
        "lanes": B, "blocks": w["data_blocks"] + w["pad_blocks"], "ms": ms,
        "eager_ms": eager, "bound_ms": b["bound_ms"],
        "bound_kind": b["bound_kind"]}
    if main:
        st["ms"].append(ms)
        st["eager_ms"].append(eager)
        st["plain_ms"].append(plain_s * 1e3)
        set_bound(st, b)
        st["longest"] = w["longest"]
        lanes_entry(torch, stats,
                    *sha._chunk_lane_blocks(data, starts, lengths, max_len))
    log(f"sha256_slices ({label}): {B} lanes, {w['data_blocks']} message "
        f"+ {w['pad_blocks']} padding blocks, longest {w['longest']}; "
        f"kernel {ms:.4f} ms (eager {eager:.4f}), bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_kind']}; per-warp floor "
        f"{b['floor_ms']:.4f} ms)")


def lanes_entry(torch, stats, blocks, nb) -> None:
    """``sha256_lanes`` (on no path since sha256_slices) on the padded
    blocks that the reference builds for the legacy shape's lanes: equal
    to its twin, timed, bounded like ``sha256_slices``."""
    from volsync_tpu_torch.ops import sha256 as sha

    fns = ({"sha256_lanes": sha.sha256_blocks},
           {"sha256_lanes": sha._sha256_lanes_plain})
    _, _, err, plain_s = against_twin(torch, fns, "sha256_lanes",
                                      [blocks, nb], {})
    st = stats["sha256_lanes"]
    st["err"] = max(st["err"], err)
    st["ms"].append(time_ms(torch, lambda: sha.sha256_blocks(blocks, nb), 20))
    st["eager_ms"].append(time_ms(torch, lambda: sha.sha256_blocks(
        blocks, nb), 20, graph=False))
    st["plain_ms"].append(plain_s * 1e3)
    nbc = nb.clamp(min=0, max=blocks.shape[1])
    n, st["longest"] = int(nbc.sum()), int(nbc.max())
    B = blocks.shape[0]
    b = lanes_bound(B, sha.LANES_THREADS, st["longest"] * SHA_BLOCK_ALU_OPS,
                    sha_bound(n, 0, n * 64 + B * 36))
    set_bound(st, b)
    log(f"sha256_lanes ({B} lanes, {n} blocks, the legacy shape's padded "
        f"messages): equals twin; {st['ms'][-1]:.4f} ms (eager "
        f"{st['eager_ms'][-1]:.4f}), bound {b['bound_ms']:.4f} ms "
        f"({b['bound_kind']})")


def sweep_k1(torch, stats, data, npp, want) -> None:
    """K5: K1 at each of ``SWEEP_THREADS`` threads per block on the
    segment's bytes, each equal to hashlib on every page, timed."""
    from volsync_tpu_torch.ops import sha256 as sha

    times = {}
    for t in SWEEP_THREADS:
        def run(t=t):
            return sha.sha256_pages(data, npp, threads=t)
        got = run().cpu().numpy().view(np.uint32).reshape(8, npp)
        if not np.array_equal(got, want):
            raise AssertionError(f"K1 at {t} threads differs from hashlib")
        times[t] = time_ms(torch, run, 20)
    k1 = stats["sha256_pages"]
    stats["sha256_pages_sweep"].update(
        ms=[min(times.values())], eager_ms=list(k1["eager_ms"]),
        plain_ms=list(k1["plain_ms"]),
        bound=list(k1["bound"]), bound_by=k1["bound_by"],
        threads_ms={str(t): v for t, v in times.items()})
    log(f"K5 sweep of K1 ({npp} pages), ms per launch by threads per "
        f"block: {json.dumps({t: round(v, 4) for t, v in times.items()})}"
        f", per-warp floors: " + json.dumps(
            {t: round(warp_floor_ms(npp, t), 4) for t in SWEEP_THREADS})
        + "; every launch equals hashlib on every page")


def pagemajor_check(torch, fns, stats, data, valid, kw, packed_wm,
                    k1) -> None:
    """The fused segment under ``VOLSYNC_PAGEMAJOR=1`` makes the fused
    launches and no ``pagemajor_u32`` (K1 stores page-major itself) and
    packs the same words as the word-major pass. Its K1 launch equals its
    twin and hashlib's table transposed, timed beside the word-major
    instance in turns (wm, pm, wm, pm). K4, off every path, equals its
    twin on the word-major table and is timed on it."""
    from volsync_tpu_torch.ops import segment as seg
    from volsync_tpu_torch.ops import sha256 as sha

    packed = []
    with pagemajor_env():
        calls = capture_calls(seg, sha, lambda: packed.append(
            seg.chunk_hash_segment(data, valid, **kw)))
    sync(torch)
    expect_calls("page-major segment", calls, FUSED_CALLS)
    if not torch.equal(packed[0], packed_wm):
        raise AssertionError("the page-major packed result differs from "
                             "the word-major one")
    name, args, kwargs = next(c for c in calls if c[0] == "sha256_pages")
    if kwargs != {"pagemajor": True}:
        raise AssertionError(f"the page-major K1 call took {kwargs}")
    out_k, _, err, plain_s = against_twin(torch, fns, name, args, kwargs)
    pages, npp, want = k1
    if not np.array_equal(out_k.cpu().numpy().view(np.uint32),
                          want.T.reshape(-1)):
        raise AssertionError("page-major K1 differs from hashlib")
    st = stats["sha256_pages_pagemajor"]
    st["err"] = max(st["err"], err)
    turns = {False: [], True: []}
    for pm in (False, True, False, True):
        turns[pm].append(time_ms(torch, lambda: sha.sha256_pages(
            pages, npp, pagemajor=pm), 20))
    st["ms"].append(float(np.mean(turns[True])))
    st["eager_ms"].append(time_ms(torch, lambda: sha.sha256_pages(
        pages, npp, pagemajor=True), 20, graph=False))
    st["plain_ms"].append(plain_s * 1e3)
    st["bound"] = list(stats["sha256_pages"]["bound"])
    st["bound_by"] = stats["sha256_pages"]["bound_by"]
    log(f"K1 page-major ({npp} pages): equals twin and hashlib, packed "
        f"result equals word-major; ms in turns wm/pm/wm/pm "
        f"{turns[False][0]:.4f}/{turns[True][0]:.4f}/{turns[False][1]:.4f}/"
        f"{turns[True][1]:.4f}")

    x = sha.sha256_pages(pages, npp).view(8, npp)
    name = "pagemajor_u32"
    _, _, err, plain_s = against_twin(torch, fns, name, [x], {})
    st = stats[name]
    st["err"] = max(st["err"], err)
    st["ms"].append(time_ms(torch, lambda: fns[0][name](x), 50))
    st["eager_ms"].append(time_ms(torch, lambda: fns[0][name](x), 50,
                                  graph=False))
    st["plain_ms"].append(plain_s * 1e3)
    st["bound"].append(x.shape[1] * 64 / HBM_BYTES_PER_S * 1e3)
    st["bound_by"] = "bytes"
    st["lib"].append(time_ms(torch, lambda: x.t().contiguous(), 50))
    log(f"K4 pagemajor_u32 ({x.shape[1]} pages, timed alone): equals twin; "
        f"kernel {st['ms'][-1]:.4f} ms (eager {st['eager_ms'][-1]:.4f}), "
        f"x.t().contiguous() {st['lib'][-1]:.4f} ms")


def split_segment_check(torch, fns, stats, host, p64) -> None:
    """K2: a stream segment (40 MiB read plus a carried tail, a 48 MiB
    buffer, non-eof) through the split-phase engine launches exactly one
    ``sha256_rows`` and one ``sha256_slices``; both equal their twins,
    every K2 lane equals hashlib, every id equals ``blob_id``; the tail
    lanes' sha256_slices is timed at this shape (``slices_shape``)."""
    from volsync_tpu_torch.engine import DeviceChunkHasher
    from volsync_tpu_torch.engine.chunker import _leaf_plan
    from volsync_tpu_torch.ops import segment as seg
    from volsync_tpu_torch.ops import sha256 as sha
    from volsync_tpu_torch.repo import blobid

    valid = host.shape[0] - host.shape[0] // 16 - 777  # 45 MiB at 48
    hasher = DeviceChunkHasher(p64, device=DEVICE)
    pending = []
    calls = capture_calls(seg, sha, lambda: pending.append(
        hasher.begin(host, eof=False, valid_len=valid)))
    sync(torch)
    expect_calls("split-phase segment", calls,
                 ["sha256_rows", "sha256_slices"])
    chunks = pending[0].finish()
    for s, n, bid in chunks:
        if bid != blobid.blob_id(host[s: s + n]):
            raise AssertionError(f"split-phase id of ({s}, {n}) differs "
                                 f"from blob_id")
    n_full = len(_leaf_plan(pending[0].chunks)[0])
    for name, args, kwargs in calls:
        out_k, _, err, plain_s = against_twin(torch, fns, name, args,
                                              kwargs)
        if name == "sha256_slices":
            stats[name]["err"] = max(stats[name]["err"], err)
            slices_shape(torch, stats, "split", args, kwargs,
                         plain_s, main=False)
            continue
        dig = out_k.cpu().numpy().view(np.uint32).astype(">u4")
        for b, r in enumerate(args[1].cpu().tolist()):
            if dig[b].tobytes() != hashlib.sha256(
                    host[64 * r: 64 * r + 4096]).digest():
                raise AssertionError(f"K2 lane {b} (row {r}) != hashlib")
        st = stats[name]
        st["err"] = max(st["err"], err)
        st["ms"].append(time_ms(
            torch, lambda: fns[0][name](*args, **kwargs), 20))
        st["eager_ms"].append(time_ms(
            torch, lambda: fns[0][name](*args, **kwargs), 20, graph=False))
        st["plain_ms"].append(plain_s * 1e3)
        bound, st["bound_by"] = sha_bound(64 * n_full, n_full,
                                          n_full * (4096 + 32 + 4))
        st["bound"].append(bound)
        lanes = args[1].shape[0]
        log(f"K2 sha256_rows: {lanes} lanes ({n_full} full leaves of "
            f"{len(chunks)} chunks) equal the twin and hashlib; kernel "
            f"{st['ms'][-1]:.4f} ms, twin {plain_s*1e3:.1f} ms; bound "
            f"{bound:.4f} ms ({st['bound_by']}), per-warp floor "
            f"{warp_floor_ms(lanes, sha.ROWS_THREADS):.4f} ms "
            f"({sha.ROWS_THREADS} threads a block)")


def legacy_segment_check(torch, fns, stats, host, p1) -> None:
    """sha256_slices at the legacy shape: a stream segment (40 MiB read,
    non-eof) through ``DeviceChunkHasher(align=1).begin`` launches
    exactly one ``sha256_slices``, a lane per 4 KiB leaf at any offset,
    padded to a power of two; it equals its twin and hashlib on every
    lane, every id equals ``blob_id``; timed with its bound
    (``slices_shape``), which is the kernel's entry."""
    from volsync_tpu_torch.engine import DeviceChunkHasher
    from volsync_tpu_torch.ops import segment as seg
    from volsync_tpu_torch.ops import sha256 as sha
    from volsync_tpu_torch.repo import blobid

    valid = min(40 << 20, host.shape[0]) - 777  # one pass of the stream
    hasher = DeviceChunkHasher(p1, device=DEVICE)
    pending = []
    calls = capture_calls(seg, sha, lambda: pending.append(
        hasher.begin(host, eof=False, valid_len=valid)))
    sync(torch)
    expect_calls("legacy segment", calls, ["sha256_slices"])
    chunks = pending[0].finish()
    for s, n, bid in chunks:
        if bid != blobid.blob_id(host[s: s + n]):
            raise AssertionError(f"legacy id of ({s}, {n}) differs from "
                                 f"blob_id")
    name, args, kwargs = calls[0]
    out_k, _, err, plain_s = against_twin(torch, fns, name, args, kwargs)
    stats[name]["err"] = max(stats[name]["err"], err)
    dig = out_k.cpu().numpy().view(np.uint32).astype(">u4")
    starts, lengths = (a.cpu().tolist() for a in args[1:])
    for b, (s, n) in enumerate(zip(starts, lengths)):
        if dig[b].tobytes() != hashlib.sha256(host[s: s + n]).digest():
            raise AssertionError(f"sha256_slices lane {b} ({s}, {n}) != "
                                 f"hashlib")
    log(f"sha256_slices (legacy): {len(starts)} lanes, "
        f"{sum(n > 0 for n in lengths)} leaves of {len(chunks)} chunks, "
        f"equal the twin and hashlib; twin {plain_s * 1e3:.1f} ms")
    slices_shape(torch, stats, "legacy", args, kwargs, plain_s,
                 main=True)


def stream_once(torch, stream, params, hasher) -> tuple:
    """One pass of ``stream_chunk_batches`` over the whole stream:
    ([(offset, length, blob id)], the first 256 (id, memoryview) pairs,
    seconds to the last chunk with the card synchronised)."""
    from volsync_tpu_torch.engine import stream_chunk_batches

    stream.pos = 0
    results, views = [], []
    off = 0
    sync(torch)
    t0 = time.perf_counter()
    for batch in stream_chunk_batches(stream.read, params, hasher=hasher):
        for mv, bid in batch:
            results.append((off, len(mv), bid))
            if len(views) < 256:
                views.append((bid, mv))
            off += len(mv)
    sync(torch)
    return results, views, time.perf_counter() - t0


def count_passes(hasher) -> list:
    """Wrap ``hasher.begin_device``; ``n[0]`` counts its device passes."""
    n = [0]
    inner = hasher.begin_device

    def counted(*args, **kwargs):
        n[0] += 1
        return inner(*args, **kwargs)

    hasher.begin_device = counted
    return n


def drive(torch, stream, params, per_pass: dict, label: str) -> dict:
    """One pass of ``stream_chunk_batches`` through a fresh hasher with
    every launch count set to 0 just before and read just after. On the
    card every kernel must have launched ``per_pass[name]`` times per
    device pass (0 when absent)."""
    from volsync_tpu_torch.engine import DeviceChunkHasher
    from volsync_tpu_torch.obs import span_totals
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts

    hasher = DeviceChunkHasher(params, device=DEVICE)
    passes = count_passes(hasher)
    before = span_totals()
    for k in KERNELS:
        k.launches = 0
    results, views, secs = stream_once(torch, stream, params, hasher)
    launches = launch_counts()
    spans = {k: round(s - before.get(k, (0, 0.0))[1], 4)
             for k, (n, s) in span_totals().items()
             if n != before.get(k, (0, 0.0))[0]}
    off = sum(n for _, n, _ in results)
    if off != stream.total:
        raise AssertionError(f"{label} covered {off} of {stream.total} "
                             f"bytes")
    want = {k: per_pass.get(k, 0) * passes[0] for k in launches}
    if DEVICE == "cuda" and launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want} over {passes[0]} device passes")
    gibs = stream.total / GIB / secs
    per_pass = {k: v / max(passes[0], 1) for k, v in launches.items() if v}
    log(f"{label}: {stream.total} bytes, {len(results)} chunks in "
        f"{secs:.3f} s = {gibs:.4f} GiB/s over {passes[0]} device passes; "
        f"launches {json.dumps(launches)}, per pass {json.dumps(per_pass)}")
    log(f"{label}: host seconds by span (summed; engine.read runs on the "
        f"readahead thread): {json.dumps(spans)}")
    return {"results": results, "views": views, "gibs": gibs,
            "launches": launches, "passes": passes[0], "spans": spans}


def dense_candidates(x: np.ndarray, params, skip: int) -> tuple:
    """numpy per-position gear oracle: (strict, lax) positions of ``x``
    at or past ``skip`` (the halo before it only feeds the windows),
    relative to ``skip``. The shift-doubling runs on uint32 words, which
    wrap mod 2**32 as the hash does; it uses the gear table, not the
    device's arithmetic form."""
    h = params.table[x]
    for m in (1, 2, 4, 8, 16):
        h[m:] += h[:-m] << np.uint32(m)
    h = h[skip:]
    pos = np.arange(h.shape[0], dtype=np.int64)
    return (pos[(h & np.uint32(params.mask_s)) == 0],
            pos[(h & np.uint32(params.mask_l)) == 0])


def oracle_cuts(stream, params) -> list:
    """The stream's cut list from host candidates (``host_candidates``
    for aligned params, cached by block content; ``dense_candidates``
    with a 31-byte halo at align 1) and the host FastCDC walk."""
    from volsync_tpu_torch.ops.gearcdc import host_candidates, select_boundaries

    cs, cl, cache = [], [], {}
    halo = np.zeros((0,), np.uint8)
    for b in range(len(stream.plan)):
        base = b * BLOCK
        blk = stream.block(b)[: stream.total - base]
        if params.align == 1:
            s, l = dense_candidates(np.concatenate([halo, blk]), params,
                                    len(halo))
            halo = blk[-31:]
        else:
            key = stream.plan[b] if len(blk) == BLOCK else None
            if key is None or key not in cache:
                cache[key] = host_candidates(blk, params, len(blk))
            s, l = cache[key]
        cs.append(s + base)
        cl.append(l + base)
    return select_boundaries(np.concatenate(cs), np.concatenate(cl),
                             stream.total, params, eof=True)


def check_oracle(label: str, results, stream, params) -> float:
    """Every cut and blob id of ``results`` equals the host oracle's;
    returns the dedup ratio (unique-id bytes / total)."""
    from volsync_tpu_torch.repo import blobid

    t1 = time.perf_counter()
    cuts = oracle_cuts(stream, params)
    if [(o, n) for o, n, _ in results] != cuts:
        bad = next((i for i, (a, b) in enumerate(zip(results, cuts))
                    if a[:2] != b), min(len(results), len(cuts)))
        raise AssertionError(f"{label}: cut list differs from the host "
                             f"oracle at chunk {bad} ({len(results)} vs "
                             f"{len(cuts)} chunks)")
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        ids = list(ex.map(lambda c: blobid.blob_id(stream.view(*c)), cuts,
                          chunksize=16))
    for (o, n, bid), want in zip(results, ids):
        if bid != want:
            raise AssertionError(f"{label}: blob id of chunk ({o}, {n}) "
                                 f"differs from hashlib")
    uniq = {bid: n for _, n, bid in results}
    ratio = sum(uniq.values()) / stream.total
    log(f"{label} oracle: {len(cuts)} cuts and every blob id equal "
        f"({time.perf_counter() - t1:.1f} s); dedup ratio (unique-id "
        f"bytes / total) {ratio:.4f}")
    return ratio


def stream_phase(torch, stream, params) -> dict:
    from volsync_tpu_torch.engine import DeviceChunkHasher
    from volsync_tpu_torch.ops import segment as seg

    res = drive(torch, stream, params, FUSED_PER_PASS, "stream")
    results = res["results"]

    # Per-stage device time, from a pass of its own: the probes' events
    # stay out of the GiB/s above, and this pass's GiB/s shows their cost.
    hasher = DeviceChunkHasher(params, device=DEVICE)
    timer = StageTimer(torch)
    longest = []  # each root launch's longest lane, read after the pass

    def root_lanes(fn):
        def wrapper(flat, npp, page0, nleaves, lens, live, **kw):
            longest.append(root_lane_blocks(torch, nleaves, live,
                                            kw["nb_max"]).max())
            return fn(flat, npp, page0, nleaves, lens, live, **kw)
        return wrapper

    with stage_probes(seg, timer), \
            patched(seg, {"_root_digests_loop": root_lanes}):
        staged, _, staged_secs = stream_once(torch, stream, params, hasher)
    stages = timer.totals_ms()
    longest = [int(x) for x in longest]
    segments = timer.count("walk")  # device passes, retries included
    again, _, again_secs = stream_once(torch, stream, params, hasher)
    if staged != results or again != results:
        raise AssertionError("a repeated stream pass gave other chunks")
    log(f"stream with stage probes: {staged_secs:.3f} s = "
        f"{stream.total / GIB / staged_secs:.4f} GiB/s; plain again: "
        f"{again_secs:.3f} s = {stream.total / GIB / again_secs:.4f} GiB/s")
    log(f"stream device ms by stage over {segments} device passes (CUDA "
        f"events, summed): "
        + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    log("stream device ms by stage a pass: " + json.dumps(
        {k: round(v / max(segments, 1), 4) for k, v in stages.items()}))
    log(f"root launches' longest lane in blocks over {len(longest)} "
        f"launches: min {min(longest, default=0)}, median "
        f"{int(np.median(longest)) if longest else 0}, max "
        f"{max(longest, default=0)}, sum {sum(longest)}")
    check_oracle("stream", results, stream, params)
    return {"launches": res["launches"], "segments": segments,
            "views": res["views"], "gibs": res["gibs"], "stages": stages,
            "longest": longest}


def split_stream_phase(torch, stream, params) -> dict:
    """The split-phase engine (align 64) over its own volume: one
    ``sha256_rows`` and one ``sha256_lanes`` per device pass, every cut
    and id equal to the oracle, then ``verify_blob_batch``."""
    res = drive(torch, stream, params, SPLIT_PER_PASS, "align=64 stream")
    check_oracle("align=64 stream", res["results"], stream, params)
    verify_phase(res.pop("views"))
    return res


def legacy_stream_phase(torch, stream, params) -> dict:
    """The legacy engine (align 1): one ``sha256_lanes`` per device
    pass, held against the per-position gear oracle."""
    res = drive(torch, stream, params, LEGACY_PER_PASS, "align=1 stream")
    check_oracle("align=1 stream", res["results"], stream, params)
    return res


def pagemajor_stream_phase(torch, stream, params) -> dict:
    """The fused engine under ``VOLSYNC_PAGEMAJOR=1`` (one
    ``pagemajor_u32`` per pass) gives the chunks and ids of a word-major
    pass over the same bytes, and those equal the oracle. The passes
    alternate page-major, word-major, word-major, page-major, so the two
    layouts' GiB/s compare within one call."""
    runs = []
    for on in (True, False, False, True):
        with pagemajor_env(on):
            runs.append(drive(
                torch, stream, params,
                PAGEMAJOR_PER_PASS if on else FUSED_PER_PASS,
                "page-major stream" if on
                else "word-major stream (same bytes)"))
    if any(r["results"] != runs[0]["results"] for r in runs):
        raise AssertionError("page-major and word-major passes differ")
    check_oracle("page-major stream", runs[0]["results"], stream, params)
    log("page-major / word-major GiB/s in turn: " + ", ".join(
        f"{r['gibs']:.4f}" for r in runs))
    return runs[0]


def verify_phase(views) -> None:
    """``verify_blob_batch`` on the stream's first chunks: all pass and
    one flipped byte is caught. The span form of sha256_slices that its
    ``hash_spans`` pass launches is held against its twin on the
    recorded inputs."""
    import torch

    from volsync_tpu_torch.engine import verify_blob_batch
    from volsync_tpu_torch.ops import segment as seg
    from volsync_tpu_torch.ops import sha256 as sha

    pairs = [(bid, bytes(mv)) for bid, mv in views]
    out = []
    calls = capture_calls(seg, sha, lambda: out.append(
        verify_blob_batch(pairs, device=DEVICE)))
    # The span form: lanes without a chunk count (5 positional arguments).
    spans = [c for c in calls
             if c[0] == "sha256_slices_tail" and len(c[1]) == 5]
    if not spans:
        raise AssertionError("verify_blob_batch made no span-tail call")
    for name, args, kwargs in spans:
        against_twin(torch, kernel_fns(seg, sha), name, args, kwargs)
    bad = out[0]
    if bad != []:
        raise AssertionError(f"verify_blob_batch flagged {len(bad)} good "
                             f"chunks")
    k = len(pairs) // 2
    flipped = bytearray(pairs[k][1])
    flipped[len(flipped) // 3] ^= 0x40
    pairs[k] = (pairs[k][0], bytes(flipped))
    bad = verify_blob_batch(pairs, device=DEVICE)
    if bad != [pairs[k][0]]:
        raise AssertionError(f"verify_blob_batch returned {bad}, expected "
                             f"the flipped chunk's id")
    log(f"verify: {len(pairs)} chunks pass; one flipped byte is caught; "
        f"the span tails' sha256_slices call ({spans[0][1][3].shape[0]} "
        f"spans) equals its twin")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream-gib", type=float, default=10.0)
    # The other engines' volumes are cut from 10 GiB to keep their host
    # oracles (numpy candidates at 64 or 1 byte granularity) within the
    # time limit.
    ap.add_argument("--align64-gib", type=float, default=2.0)
    ap.add_argument("--align1-mib", type=float, default=256.0)
    ap.add_argument("--pagemajor-gib", type=float, default=1.0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from volsync_tpu_torch.ops import _build
    from volsync_tpu_torch.ops.gearcdc import DEFAULT_PARAMS, GearParams

    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build: {len(reports)} CUDA sources compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, rep in reports.items():
        for line in rep.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"  {src}: {line.strip()}")
    sass = sass_blocks()
    floors = {"merkle_roots": chain_block_floor_ms(sass.get("merkle_roots"))}
    for name, counts in sass.items():
        floor = floors.get(name)
        log(f"{name} one message block as compiled (cuobjdump -sass, "
            f"instructions by class): "
            + (json.dumps(counts) if counts else "not available")
            + f"; least work {SHA_BLOCK_ALU_OPS} LOP3/SHF and 360 adds, "
              f"{SHA_ROUNDS_ALU_OPS} LOP3/SHF in the rounds alone"
            + (f"; chain floor {floor * 1e3:.4f} us a block" if floor
               else ""))
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    lat = probe_latency_ns(torch, args.seed)
    log(f"probe (csrc/probe.cu, one-thread pointer chase): one dependent "
        f"L2 load {lat['l2_ns']:.1f} ns ({lat['l2_cycles']:.1f} SM "
        f"cycles), one dependent shared-memory load "
        f"{lat['shared_ns']:.1f} ns ({lat['shared_cycles']:.1f} cycles) "
        f"({card})")

    def volume(size: int, what: str):
        t1 = time.perf_counter()
        s = SeededStream(torch, args.seed, size + 12345)
        log(f"data ({what}): {len(s.unique)} fresh 64 MiB blocks of "
            f"{len(s.plan)} made in {time.perf_counter() - t1:.1f} s "
            f"(zero block {s.zero_block})")
        return s

    # The align=64 deployment: DEFAULT_CHUNKER's sizes with align 64.
    params64 = GearParams(align=64)
    params1 = GearParams(align=1)
    stream = volume(int(args.stream_gib * GIB), "fused stream")
    stats = kernel_phase(torch, stream, DEFAULT_PARAMS, SEGMENT_P, params64,
                         params1, lat)
    for name, floor in floors.items():
        st = stats[name]
        bound = (f"{st['longest'] * floor:.4f} ms" if floor
                 else "not available")
        log(f"{name} chain bound (longest lane {st['longest']} blocks x the "
            f"chain floor): {bound}, measured {np.mean(st['ms']):.4f} ms "
            f"({card})")
    res = stream_phase(torch, stream, DEFAULT_PARAMS)
    verify_phase(res.pop("views"))
    per_seg = {k: v / res["segments"] for k, v in res["launches"].items()}
    log(f"launches per segment pass: {json.dumps(per_seg)} ({card})")
    log(f"stream roots {res['stages'].get('roots', 0):.3f} ms, roots.tail "
        f"{res['stages'].get('roots.tail', 0):.3f} ms over {res['segments']} "
        f"passes ({card})")
    if floors["merkle_roots"]:
        log(f"stream roots.merkle {res['stages'].get('roots.merkle', 0):.3f} "
            f"ms over {res['segments']} passes against a summed chain bound "
            f"of {sum(res['longest']) * floors['merkle_roots']:.3f} ms "
            f"({card})")
    del stream

    split = split_stream_phase(
        torch, volume(int(args.align64_gib * GIB), "align=64"), params64)
    legacy = legacy_stream_phase(
        torch, volume(int(args.align1_mib * (1 << 20)), "align=1"), params1)
    pm = pagemajor_stream_phase(
        torch, volume(int(args.pagemajor_gib * GIB), "page-major"),
        DEFAULT_PARAMS)
    log(f"GiB/s by engine: fused {res['gibs']:.4f}, align=64 "
        f"{split['gibs']:.4f}, align=1 {legacy['gibs']:.4f}, page-major "
        f"{pm['gibs']:.4f} ({card})")

    # Launches: from the stream phase of the path that runs each kernel.
    launches = {**res["launches"],
                "sha256_rows": split["launches"]["sha256_rows"],
                "pagemajor_u32": pm["launches"]["pagemajor_u32"],
                "sha256_pages_sweep": res["launches"]["sha256_pages"],
                "sha256_pages_pagemajor": pm["launches"]["sha256_pages"],
                "sha256_slices": legacy["launches"]["sha256_slices"],
                "sha256_slices_tail": res["launches"]["sha256_slices"]}
    kernels = []
    for name in ("transpose_u32", "sha256_pages", "sha256_pages_pagemajor",
                 "sha256_lanes", "sha256_slices", "sha256_slices_tail",
                 "fastcdc_walk", "sha256_rows", "pagemajor_u32",
                 "sha256_pages_sweep", "merkle_roots"):
        st = stats[name]
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": st["err"],
            "ms": float(np.mean(st["ms"])),
            "eager_ms": float(np.mean(st["eager_ms"])),
            "plain_ms": float(np.mean(st["plain_ms"])),
            "bound_ms": float(np.mean(st["bound"])),
            "bound_by": st["bound_by"],
            "library_ms": float(np.mean(st["lib"])) if st["lib"] else None,
        }
        for extra in ("bound_kind", "threads_ms", "shapes"):
            if extra in st:
                entry[extra] = st[extra]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
