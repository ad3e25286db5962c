#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (volsync_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--stream-gib G] [--align64-gib G]
                          [--align1-mib M] [--pagemajor-gib G]
                          [--backup-gib G] [--backup64-mib M]
                          [--ec-gib G] [--delta-gib G] [--restic-mib M]

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
   padded messages the reference builds for the same lanes; then
   ``md5_slices`` (``csrc/md5.cu``) in both forms against its twin and
   hashlib, timed and bounded (the compiled block's ALU instructions
   over the card's ALU rate, and the longest lane's per-warp floor):
   the windows form at the signature's shape (16,384 contiguous 32 KiB
   blocks) and at a verify shape (8,192 4 KiB windows at odd offsets,
   one running past the buffer's end, one before its start), the lanes
   form on 16,384 messages of 0..200 bytes, each bounded also by the
   chain of its longest lane (64 dependent rounds a block at one
   round's latency, measured by a one-thread MD5 chain in
   ``csrc/probe.cu``), one launch on a single 32 KiB window timed
   beside that chain, and a 1 MiB file's signature (256 4 KiB windows);
   the compiled round's dependency chain (``cuobjdump -sass``) and a
   clock64 split of one lane's block loop at the signature, one-window
   and verify shapes (``tools/time_md5_calls.block_split``: an
   instrumented instance of the kernel, off the launch counts);
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
   ``obs.span``;
6. backup: the restic mover's product path. A seeded tree of about
   ``--backup-gib`` GiB on local disk (in the process's temporary
   directory where its filesystem keeps holes and has room, else under
   ``build/``; removed after) from the stream's block pattern: a file of half the volume, one
   ending in a 12,345-byte odd tail and its hard link, a sparse file
   with a 32 MiB hole, an empty file and 300 files below min_size.
   ``TreeBackup`` into an encrypted ``FsObjectStore`` repository at the
   repository default chunker (align 4096), a second backup (nothing
   new, the same root tree), ``check(read_data=True)``, a pipelined
   ``restore_snapshot`` and a serial ``TreeRestore`` with device verify
   (each byte-identical: SHA-256, mode and mtime of every path, hard
   links, the hole), and one flipped byte in a pack (IntegrityError
   before the affected file is written); then the same for an
   unencrypted align-64 repository over ``--backup64-mib`` MiB (K2 in
   the product path; the device verify, not the MAC, catches its
   flipped byte). Every run sets the launch counts to 0 before and
   reads them after: the fused or split-phase kernels once a backup
   pass, none on the second backup, and K1, ``sha256_slices`` and
   ``merkle_roots`` once a verify pass. Logs backup and restore GiB/s,
   each run's host seconds by span and the seconds the card was busy
   (a ``torch.profiler`` trace of its kernels, copies and memsets).
   Every restore must leave the hole unwritten (its writes into
   ``sparse.bin`` are recorded); where the filesystem keeps holes, the
   restored file must keep it as one too, and the log says whether it
   did;
7. durability: ``gf_matmul`` (the Reed-Solomon field product, plain
   torch ops) at a 16 MiB pack's shape, held exactly against the NumPy
   oracle and timed (CUDA-graph replay and eager) beside its CPU twin
   and its bytes bound; then ``durability_phase`` over a seeded tree of
   ``--ec-gib`` GiB in an encrypted repository under
   ``VOLSYNC_EC_SCHEME=4+2``: shards only at no more than 1.52x the
   pack bytes; 2 of 6 shards of every pack lost, ``check(read_data=
   True)`` clean and pipelined and serial restores byte-identical, each
   pack decoded once by check and the pipelined restore (one of tree
   blobs at most twice); a whole scrub backfills the lost shards; a
   flipped shard byte heals, then a whole scrub is clean; a second backup with a quarter of the bytes new,
   ``forget`` and ``RepackService`` until it converges, a clean check
   and a byte-identical restore of the kept snapshot; 3 of 6 shards of
   one pack lost: the scrub quarantines it as unhealable and a restore
   raises before writing the files that need it. Each run counts the
   launches (the fused kernels once a backup pass, the verify kernels
   once a verify batch), ``gf_matmul``'s calls and the packs decoded,
   and traces the card;
8. delta: the rsync mover's data plane (BASELINE.json configs[0], a
   1 GiB PVC replicated by rsync; ``--delta-gib``). Seeded destination
   and source trees on disk: a file of half the volume with 16 scattered
   1 KiB overwrites, a 37-byte insertion a third of the way in and a
   12,345-byte append; 64 files of 4 MiB and 240 of 1 MiB, in turns
   unchanged, with a byte inserted, with a 4 KiB block rewritten and
   unrelated; 300 files below one block; an emptied file and one with
   no basis. With the launch counts set to 0 and the card traced: the
   files read in walk order, the destination's signatures on the card
   (block length ``pick_block_len(max(src, dst))``),
   ``delta_scan_batch`` over 32 files a call (``VOLSYNC_DELTA_BATCH``),
   ``apply_delta`` each file. Then every weak sum against rsync's
   formula and every strong sum against hashlib, every rebuilt file
   against its source, the batched ops against ``compute_delta`` on the
   card and, for 8 of the 1 MiB files, against the port on the CPU,
   the literal bytes of each kind of edit, and exactly one
   ``md5_slices`` launch a signature with a full block and one a scan
   group with candidates, nothing else. Logs signature, scan and apply
   GiB/s, the literal share, the stage times, the peak device memory,
   the card's busy share, and the rolling + membership torch ops timed
   again at the largest group's shape and a 4 KiB group's beside their
   bytes bound;
9. mover: the rsync mover's entry points over the delta phase's trees
   (BASELINE.json configs[0], before they are removed): with the launch
   counts set to 0 and the card traced, ``serve_destination`` on the
   destination tree in a thread on 127.0.0.1 and
   ``rsync_source_entrypoint`` with a ``JobContext`` (ADDRESS, PORT,
   FAST_RETRY) push one sync iteration over the sealed,
   device-authenticated channel, first with the planner pinned to delta
   (into hard links of the destination's files), then as a Job runs it,
   the planner choosing; each with a cold planner book, both rc 0, the
   destination equal to
   the source (bytes, paths, modes, mtimes), each delta-planned file's
   literal bytes within its edit's bounds (whole files all literal),
   and exactly one ``md5_slices`` launch for each delta-planned file
   with a full block at the destination and one a scan group with
   candidates. Logs the push wall and GiB/s, the sealed frames' bytes
   by direction, the literal share, the planner's full/delta split and
   the round-trip and bulk samples its book took, the card's busy share and the host seconds in the frames' zlib (or zstd)
   and seal. Then a device the listener does not know and a wrong
   pinned ID are refused at the handshake, and a cold push of 64 MiB
   into an empty directory ships all literal with no kernel launched;
10. restic entry: ``restic_entrypoint`` over a seeded ``--restic-mib``
   MiB tree in an encrypted ``FsObjectStore`` repository with
   ``VOLSYNC_TRACE_DIR`` set: a backup, edits, a second backup with
   FORGET_LAST=1 and PRUNE=1, a restore into an empty directory; rc 0
   each, exact launches each run (the fused kernels a backup pass, the
   verify kernels a verify pass), one snapshot left, the restore
   byte-identical with the hole unwritten, one trace a backup and one
   of the restore (``obs.device_trace``), whose device events, where
   the profiler kept them, give each run's busy share.

The line before the last is the kernels JSON (launches on the stream
phase that runs each kernel, ``md5_slices``' on the delta phase, max
difference from the twin, times and bounds; ``product_launches``: each
kernel's launches in the backup, durability, delta, mover and restic
entry phases' runs, on the entries named as the kernel is: a form's
entry has none, since its launches count under its kernel's name);
the last line is ``{"ok": true, "device":
{...}}``. Exits nonzero, with no result, when CUDA is unavailable or
any phase fails.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
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
    "md5_slices": "volsync_tpu/ops/md5.py:168",
    "md5_slices_lanes": "volsync_tpu/ops/md5.py:113",
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
    "md5_slices": "volsync_tpu_torch/csrc/md5.cu",
    "md5_slices_lanes": "volsync_tpu_torch/csrc/md5.cu",
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
def env_set(name: str, value):
    """Within the block, ``name`` is ``value`` in the environment (unset
    for None); the previous state comes back on exit."""
    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def pagemajor_env(on: bool = True):
    """Within the block, ``VOLSYNC_PAGEMAJOR`` is set (or unset)."""
    return env_set("VOLSYNC_PAGEMAJOR", "1" if on else None)


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


def sass_loop(sass: str, kernel: str, loads: int,
              load_op: str = "LDGSTS", min_len: int = 0) -> tuple | None:
    """(instructions, ``load_op`` count) of ``kernel``'s block loop in
    ``cuobjdump -sass`` text: the shortest backward branch whose span
    holds at least ``loads`` ``load_op`` instructions (and ``min_len``
    instructions: a kernel whose copy prologue is a loop of its own),
    each instruction (address, opcode, operands). None when no such
    loop is found."""
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
            body = [(a, o, r) for a, o, r in ins if lo <= a <= addr]
            n_ld = sum(o.split(".")[0] == load_op for _, o, _ in body)
            if n_ld >= loads and len(body) >= min_len:
                loops.append((len(body), n_ld, body))
    if not loops:
        return None
    _, n_ld, body = min(loops, key=lambda x: x[0])
    return body, n_ld


def sass_block_counts(sass: str, kernel: str, loads: int,
                      load_op: str = "LDGSTS",
                      min_len: int = 0) -> dict | None:
    """Instructions of one message block of ``kernel`` in ``cuobjdump
    -sass`` text, by class: the body of the kernel's block loop
    (``sass_loop``) divided by the blocks it covers (``loads`` each).
    None when no such loop is found."""
    loop = sass_loop(sass, kernel, loads, load_op, min_len)
    if loop is None:
        return None
    body, n_ld = [o for _, o, _ in loop[0]], loop[1]
    classes = {"LOP3/SHF": ("LOP3", "LOP", "SHF", "PRMT"),
               "IADD3": ("IADD3", "IADD"), "IMAD": ("IMAD",),
               load_op: (load_op,)}
    out = dict.fromkeys([*classes, "other"], 0)
    for op in body:
        base = op.split(".")[0]
        out[next((k for k, v in classes.items() if base in v), "other")] += 1
    nblk = n_ld // loads
    return {k: v / nblk for k, v in out.items()}


def _regs(text: str) -> list:
    """Registers named in SASS operand text (RZ, the zero register,
    left out): general ``R<n>``, uniform ``UR<n>`` and predicates."""
    return re.findall(r"\b(U?R\d+|U?P\d+)\b", text)


def straight_runs(body: list) -> list:
    """The branch-free runs of a loop body (``sass_loop``'s (address,
    opcode, operands) list), each a list of (opcode, operands): a run
    ends after a branch, exit or call and begins at a branch target."""
    targets = {int(m.group(1), 16) for _, op, rest in body
               if op.startswith("BRA")
               for m in [re.match(r"0x([0-9a-f]+)", rest.strip())] if m}
    runs, cur = [], []
    for addr, op, rest in body:
        if addr in targets and cur:
            runs.append(cur)
            cur = []
        cur.append((op, rest))
        if op.split(".")[0] in ("BRA", "EXIT", "RET", "CALL", "BRX", "JMP"):
            runs.append(cur)
            cur = []
    if cur:
        runs.append(cur)
    return runs


def sass_chain(body: list, rounds: int) -> dict:
    """The longest chain of dependent instructions through a straight run
    of SASS (a ``straight_runs`` list of (opcode, operands), in program
    order): an instruction depends on the last earlier instruction of
    the run that wrote a register it reads; the first operand is the
    one written where it is a register. -> {"length": instructions on
    the chain, "per_round": length / ``rounds``, "ops": opcode counts
    on it}: for a run of ``rounds`` dependent hash rounds, the
    instructions from one round's result to the next."""
    writer: dict = {}  # register -> index of its last writer
    depth, prev = [], []
    for i, (op, rest) in enumerate(body):
        ops = [o.strip() for o in rest.split(",")] if rest.strip() else []
        dest = ops[0] if ops and re.fullmatch(r"U?[RP]\d+(\.\w+)*",
                                              ops[0]) else None
        srcs = _regs(",".join(ops[1:] if dest else ops))
        best, arg = 0, -1
        for r in srcs:
            j = writer.get(r)
            if j is not None and depth[j] > best:
                best, arg = depth[j], j
        depth.append(best + 1)
        prev.append(arg)
        if dest:
            writer[dest.split(".")[0]] = i
    if not depth:
        return {"length": 0, "per_round": 0.0, "ops": {}}
    i = max(range(len(depth)), key=depth.__getitem__)
    ops: dict = {}
    while i >= 0:
        base = body[i][0].split(".")[0]
        ops[base] = ops.get(base, 0) + 1
        i = prev[i]
    length = max(depth)
    return {"length": length, "per_round": length / rounds, "ops": ops}


#: md5_slices' product instances in the SASS (the split's instance,
#: ``Lb1E``, is not on a product path) and the 16-byte cp.async of one
#: pass of each one's block loop: a window's four pieces, its fifth and
#: the five of the edge blocks' bounded copy; a padded lane's four. The
#: block loop holds the 64 rounds (256 instructions at least); the copy
#: prologue's loop is shorter.
MD5_SASS = (("md5_slices", "md5_slices_kernelI7WindowsLb0E", 10),
            ("md5_slices_lanes", "md5_slices_kernelI11PaddedLanesLb0E", 4))
MD5_LOOP_MIN = 256


def md5_sass_chain() -> dict:
    """``sass_chain`` of the rounds of each md5_slices product instance's
    block loop (the loop's straight run with the longest chain: no branch
    splits the 64 dependent rounds of a block), from the built library;
    empty when the toolkit has no cuobjdump."""
    from volsync_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    text = subprocess.run([str(tool), "-sass",
                           str(_build.library_path("md5.cu"))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    out = {}
    for name, kernel, loads in MD5_SASS:
        loop = sass_loop(text, kernel, loads, min_len=MD5_LOOP_MIN)
        if loop is not None:
            rounds = 64 * (loop[1] // loads)
            out[name] = max((sass_chain(run, rounds)
                             for run in straight_runs(loop[0])),
                            key=lambda c: c["length"])
    return out


def sass_blocks() -> dict:
    """``sass_block_counts`` of K1's two instances (word-major and
    page-major) and K2 (4 16-byte cp.async a block: a thread copies 64
    bytes of its block's messages per message block), of
    ``sha256_slices``' three forms (5 a block: 80-byte windows), of merkle_roots' chain (64 shared K+W reads a
    block), of ``sha256_lanes`` (4 16-byte loads a block) and of
    ``md5_slices``' two forms (5 a block, as ``sha256_slices``) in the
    built libraries; empty when the toolkit has no cuobjdump."""
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
                                              "LDG"),
            **{name: sass_block_counts(dump("md5.cu"), kernel, loads,
                                       min_len=MD5_LOOP_MIN)
               for name, kernel, loads in MD5_SASS}}


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


#: Blocks of the MD5 chain probe: 64 x 4,096 dependent rounds.
PROBE_MD5_BLOCKS = 4096


def md5_round_cycles(torch, seed: int = 0) -> dict:
    """One MD5 round's dependent latency: one thread compresses
    ``PROBE_MD5_BLOCKS`` blocks in a row on its own state
    (``csrc/probe.cu`` probe_md5_chain, no port of a TPU kernel), timed
    in the kernel by clock64 (SM cycles) and %globaltimer (ns); the
    least of 3 -> {"cycles", "ns"} a round."""
    import ctypes

    from volsync_tpu_torch.ops import _build

    fn = _build.load("probe.cu").vt_probe_md5_chain
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    words = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2**31, 16, dtype=np.int32)).to(DEVICE)
    out = torch.zeros((3,), dtype=torch.int64, device=DEVICE)
    runs = []
    for _ in range(3):
        rc = fn(words.data_ptr(), PROBE_MD5_BLOCKS, out.data_ptr(),
                torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"probe_md5_chain launch failed ({rc})")
        runs.append(out.tolist()[:2])
    cycles, ns = min(runs, key=lambda r: r[0])
    rounds = PROBE_MD5_BLOCKS * 64
    return {"cycles": cycles / rounds, "ns": ns / rounds}


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


class PassCounter:
    """Counts calls of a wrapped function from any thread (``n``)."""

    def __init__(self):
        self.n = 0
        self._lock = threading.Lock()

    def wrap(self, fn):
        def counted(*args, **kwargs):
            with self._lock:
                self.n += 1
            return fn(*args, **kwargs)
        return counted


def count_passes(hasher) -> PassCounter:
    """Wrap ``hasher.begin_device``; the counter's ``n`` is its device
    passes."""
    passes = PassCounter()
    hasher.begin_device = passes.wrap(hasher.begin_device)
    return passes


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
    want = {k: per_pass.get(k, 0) * passes.n for k in launches}
    if DEVICE == "cuda" and launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want} over {passes.n} device passes")
    gibs = stream.total / GIB / secs
    per_pass = {k: v / max(passes.n, 1) for k, v in launches.items() if v}
    log(f"{label}: {stream.total} bytes, {len(results)} chunks in "
        f"{secs:.3f} s = {gibs:.4f} GiB/s over {passes.n} device passes; "
        f"launches {json.dumps(launches)}, per pass {json.dumps(per_pass)}")
    log(f"{label}: host seconds by span (summed; engine.read runs on the "
        f"readahead thread): {json.dumps(spans)}")
    return {"results": results, "views": views, "gibs": gibs,
            "launches": launches, "passes": passes.n, "spans": spans}


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


#: Kernel launches per ``hash_spans`` pass of ``verify_blob_batch`` (the
#: repository check and both restores): K1, the span form of
#: sha256_slices, merkle_roots.
VERIFY_PER_PASS = {"sha256_pages": 1, "sha256_slices": 1, "merkle_roots": 1}
#: Files below min_size in the backup tree, and its odd tail.
SMALL_FILES = 300
ODD_TAIL = 12345
# The restore writes zero pages aligned to each blob's start as holes:
# at align 64 the blobs at the hole's two ends may leave a page of it
# written on each side.
HOLE_SLACK = 4 * 4096


def write_stream(path: Path, stream, n: int) -> None:
    """Write the stream's next ``n`` bytes to ``path``."""
    buf = bytearray(8 << 20)
    view = memoryview(buf)
    with open(path, "wb") as f:
        while n > 0:
            got = stream.readinto(view[: min(len(buf), n)])
            if got == 0:
                raise AssertionError(f"stream ended {n} bytes early")
            f.write(view[:got])
            n -= got


def make_backup_tree(torch, root: Path, total: int, seed: int,
                     min_size: int, hole: int) -> dict:
    """A seeded volume of about ``total`` bytes on local disk, made from
    ``SeededStream``'s block pattern (half of its blocks repeat earlier
    ones, one is all zero): ``big.bin`` (at least half the volume),
    ``odd.bin`` (the rest, ending in a 12,345-byte odd tail), a hard link
    to it two directories down, ``sparse.bin`` (data, a ``hole``-byte
    hole, data), an empty file and 300 files below ``min_size`` in 16
    directories. -> {"bytes": bytes of its distinct regular files (the
    hole counted, the link not), "hole": hole, "hole_at": its offset}."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    small_max = min(min_size, 64 << 10)
    sizes = rng.integers(1, small_max, size=SMALL_FILES)
    sparse_data = max(8192, min(2 << 20, total // 16) // 8192 * 8192)
    big = total // 2 + 4096
    odd = max(total - big - sparse_data - int(sizes.sum()), 0)
    odd = odd // (1 << 20) * (1 << 20) + ODD_TAIL
    stream = SeededStream(torch, seed, big + odd)
    write_stream(root / "big.bin", stream, big)
    write_stream(root / "odd.bin", stream, odd)
    with open(root / "sparse.bin", "wb") as f:
        f.write(rng.bytes(sparse_data // 2))
        f.seek(sparse_data // 2 + hole)
        f.write(rng.bytes(sparse_data // 2))
    (root / "empty").write_bytes(b"")
    (root / "nested" / "deeper").mkdir(parents=True)
    os.link(root / "odd.bin", root / "nested" / "deeper" / "link.bin")
    for i, n in enumerate(sizes):
        d = root / "small" / f"{i % 16:02d}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"f{i:04d}.bin").write_bytes(rng.bytes(int(n)))
        if i % 7 == 0:
            os.chmod(d / f"f{i:04d}.bin", 0o600)
    os.chmod(root / "odd.bin", 0o640)
    os.utime(root / "nested", ns=(1_600_000_000 * 10**9,) * 2)
    return {"bytes": big + odd + sparse_data + hole + int(sizes.sum()),
            "hole": hole, "hole_at": sparse_data // 2}


def hole_bytes(fd: int, size: int) -> int:
    """Bytes of an open file's holes, as ``SEEK_HOLE``/``SEEK_DATA`` see
    them (0 where the filesystem reports none)."""
    total = off = 0
    while off < size:
        start = os.lseek(fd, off, os.SEEK_HOLE)
        if start >= size:
            break
        try:
            off = os.lseek(fd, start, os.SEEK_DATA)
        except OSError:  # ENXIO: a hole to the end
            off = size
        total += off - start
    return total


def keeps_holes(d: Path) -> bool:
    """Whether ``d``'s filesystem keeps a 1 MiB gap written past as a
    hole (``SEEK_HOLE`` finds it)."""
    fd, name = tempfile.mkstemp(prefix="hole_probe.", dir=d)
    try:
        os.write(fd, b"\1" * 4096)
        os.lseek(fd, 1 << 20, os.SEEK_CUR)
        os.write(fd, b"\1" * 4096)
        os.fsync(fd)
        return hole_bytes(fd, os.fstat(fd).st_size) > 0
    finally:
        os.close(fd)
        os.unlink(name)


def backup_base(build: Path, need: int) -> Path:
    """The directory the backup phase works in: the first of this
    process's temporary directory and the checkout's ``build/`` that has
    ``need`` bytes free and keeps holes, else ``build/``."""
    for d in (Path(tempfile.gettempdir()), build):
        if shutil.disk_usage(d).free >= need and keeps_holes(d):
            return d
    return build


def tree_state(root: Path) -> dict:
    """rel -> (kind, mode, mtime_ns, size, sha256 hex, inode, blocks,
    hole bytes)."""
    out = {}
    for p in sorted(root.rglob("*")):
        st = p.lstat()
        digest = None
        holes = 0
        if p.is_file():
            h = hashlib.sha256()
            with open(p, "rb") as f:
                while piece := f.read(8 << 20):
                    h.update(piece)
                holes = hole_bytes(f.fileno(), st.st_size)
            digest = h.hexdigest()
        out[str(p.relative_to(root))] = (
            "file" if p.is_file() else "dir", st.st_mode, st.st_mtime_ns,
            st.st_size if p.is_file() else 0, digest, st.st_ino,
            st.st_blocks, holes)
    return out


def check_restored(label: str, src: dict, dst_root: Path, hole: int,
                   only_complete: bool = False) -> None:
    """``dst_root`` holds ``src``'s tree byte-identical: the same paths,
    and for each its kind, mode, mtime, size and SHA-256, the same
    hard-link groups, and, where the source's ``sparse.bin`` keeps its
    ``hole``, a restored ``sparse.bin`` whose holes are as large within
    ``HOLE_SLACK``. With ``only_complete`` (a failed restore)
    ``dst_root`` may hold fewer files, each complete."""
    dst = tree_state(dst_root)
    if only_complete:
        src = {k: v for k, v in src.items() if k in dst}
    if set(dst) != set(src):
        missing = sorted(set(src) ^ set(dst))[:5]
        raise AssertionError(f"{label}: paths differ, e.g. {missing}")
    for rel, a in src.items():
        b = dst[rel]
        if a[:5] != b[:5] and not (only_complete and a[0] == "dir"):
            raise AssertionError(f"{label}: {rel} differs: {a[:5]} "
                                 f"restored as {b[:5]}")

    def groups(state):
        by_ino = defaultdict(set)
        for rel, v in state.items():
            if v[0] == "file":
                by_ino[v[5]].add(rel)
        return sorted(sorted(g) for g in by_ino.values())

    if groups(src) != groups(dst):
        raise AssertionError(f"{label}: hard-link groups differ")
    if "sparse.bin" in dst and src["sparse.bin"][7] >= hole and \
            dst["sparse.bin"][7] < src["sparse.bin"][7] - HOLE_SLACK:
        raise AssertionError(
            f"{label}: sparse.bin restored with {dst['sparse.bin'][7]} "
            f"bytes of holes, the source has {src['sparse.bin'][7]} (its "
            f"{hole}-byte hole filled)")


def busy_union(spans) -> float:
    """Length of the union of the (start, end) intervals ``spans``."""
    spans = sorted(spans)
    busy, end = 0, spans[0][0] if spans else 0
    for a, b in spans:
        busy += max(b, end) - max(a, end)
        end = max(end, b)
    return busy


@contextlib.contextmanager
def device_trace(torch, on: bool = True):
    """Trace the card while the body runs (``torch.profiler``, CUDA
    activity only). Fills the yielded dict with ``busy_s``, the seconds
    in which a kernel, copy or memset ran on the card (the union of
    their intervals, any stream), ``events``, their count, and
    ``by_kind``, their summed seconds by kernels, Memcpy and Memset; all
    None off the card, without ``on`` (a body that traces itself: two
    profilers cannot nest), or when the trace holds no device event."""
    out = {"busy_s": None, "events": None, "by_kind": None}
    if DEVICE != "cuda" or not on:
        yield out
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield out
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() != DeviceType.CPU]
    if not events:
        return
    busy = busy_union((e.start_ns(), e.end_ns()) for e in events)
    kinds = defaultdict(int)
    for e in events:
        kinds[e.name().split()[0] if e.name().startswith(("Memcpy", "Memset"))
              else "kernels"] += e.duration_ns()
    out.update(busy_s=busy / 1e9, events=len(events),
               by_kind={k: round(v / 1e9, 4) for k, v in kinds.items()})


def chrome_trace_busy(path: Path) -> dict:
    """``device_trace``'s numbers from a Chrome trace that
    ``torch.profiler`` wrote (``obs.device_trace``): the kernels, copies
    and memsets on the card (categories kernel, gpu_memcpy, gpu_memset;
    microseconds). ``busy_s`` None when it holds no device event."""
    names = {"kernel": "kernels", "gpu_memcpy": "Memcpy",
             "gpu_memset": "Memset"}
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") in names and "dur" in e]
    if not events:
        return {"busy_s": None, "events": 0, "by_kind": None}
    kinds = defaultdict(float)
    for e in events:
        kinds[names[e["cat"]]] += e["dur"] / 1e6
    return {"busy_s": busy_union((e["ts"], e["ts"] + e["dur"])
                                 for e in events) / 1e6,
            "events": len(events),
            "by_kind": {k: round(v, 4) for k, v in kinds.items()}}


class WriteRecorder:
    """A file object that appends the byte range of each write to
    ``ranges``."""

    def __init__(self, f, ranges: list):
        self.f, self.ranges = f, ranges

    def write(self, data) -> int:
        start = self.f.tell()
        n = self.f.write(data)
        self.ranges.append((start, start + n))
        return n

    def __getattr__(self, name):
        return getattr(self.f, name)


@contextlib.contextmanager
def sparse_writes():
    """Within the block, the restores' writer records the byte ranges it
    writes into any ``sparse.bin``; yields the list of them."""
    from volsync_tpu_torch.engine import restore

    ranges = []

    def make(fn):
        def wrapper(f, data):
            if Path(f.name).name == "sparse.bin":
                f = WriteRecorder(f, ranges)
            return fn(f, data)
        return wrapper

    with patched(restore, {"_write_sparse": make}):
        yield ranges


def check_hole_unwritten(label: str, written: list, made: dict) -> None:
    """The restore wrote ``sparse.bin``'s data and left its hole
    unwritten (within ``HOLE_SLACK``), whatever the filesystem then
    allocates."""
    a = made["hole_at"]
    b = a + made["hole"]
    inside = sum(max(0, min(e, b) - max(s, a)) for s, e in written)
    if not written or inside > HOLE_SLACK:
        raise AssertionError(f"{label}: {sum(e - s for s, e in written)} "
                             f"bytes written to sparse.bin, {inside} of "
                             f"them inside its {made['hole']}-byte hole")


def product_run(torch, label: str, run, per_pass: dict,
                passes: PassCounter, min_passes: int = 1, *,
                verify_per_pass: dict | None = None,
                trace: bool = True) -> dict:
    """``run()`` with every launch count set to 0 just before and read
    just after, and ``hash_spans`` (the verify pass) counted. On the card
    every kernel must have launched ``per_pass[name]`` times per counted
    pass (0 when absent), plus ``verify_per_pass[name]`` times a verify
    pass where given, and a ``per_pass`` with kernels needs at least
    ``min_passes`` passes. ``trace`` False: the run traces the card
    itself (``obs.device_trace``), so this one does not."""
    from volsync_tpu_torch.engine import chunker
    from volsync_tpu_torch.obs import span_totals
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts

    verify = PassCounter()
    before = span_totals()
    for k in KERNELS:
        k.launches = 0
    with device_trace(torch, trace) as traced:
        sync(torch)
        t0 = time.perf_counter()
        with patched(chunker, {"hash_spans": verify.wrap}):
            out = run()
        sync(torch)
        secs = time.perf_counter() - t0
    launches = launch_counts()
    n = passes.n if passes is not None else verify.n
    want = {k: per_pass.get(k, 0) * n
            + (verify_per_pass or {}).get(k, 0) * verify.n
            for k in launches}
    if DEVICE == "cuda" and (launches != want
                             or (per_pass and n < min_passes)):
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want} over {n} passes")
    spans = {k: round(s - before.get(k, (0, 0.0))[1], 4)
             for k, (c, s) in span_totals().items()
             if c != before.get(k, (0, 0.0))[0]}
    busy = traced["busy_s"]
    log(f"{label}: {secs:.3f} s, {n} device passes"
        + (f" and {verify.n} verify passes" if verify_per_pass else "")
        + f", launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}; card busy "
        + (f"{busy:.4f} s ({100 * busy / secs:.2f}% of the wall; "
           f"{traced['events']} device events traced, seconds by kind "
           f"{json.dumps(traced['by_kind'])})" if busy is not None
           else "not measured" + ("" if trace else " here (traced by the "
                                  "run itself)"))
        + f"; host seconds by span (summed over threads): "
          f"{json.dumps(spans)}")
    return {"out": out, "secs": secs, "launches": launches, "passes": n,
            "verify_passes": verify.n, "spans": spans, "busy_s": busy}


def repo_round_trip(torch, label: str, base: Path, total: int, seed: int,
                    chunker: dict, password, hole: int, card: str,
                    holes: bool) -> dict:
    """Back up a seeded tree into a new ``FsObjectStore`` repository on the
    card, back it up again (nothing new, the same root tree), check it
    with ``read_data=True``, restore it pipelined and serially (both
    byte-identical to the source; ``holes``: ``base`` keeps holes, so
    the source's must be there), then flip one byte in the pack of
    ``big.bin``'s first blob and restore again: IntegrityError, with
    ``big.bin`` not written and every file that was written complete."""
    from volsync_tpu_torch.engine.backup import TreeBackup
    from volsync_tpu_torch.engine.restore import TreeRestore, \
        restore_snapshot
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.repo import crypto
    from volsync_tpu_torch.repo.repository import Repository

    src = base / f"{label}-src"
    t0 = time.perf_counter()
    made = make_backup_tree(torch, src, total, seed, chunker["min_size"],
                            hole)
    state = tree_state(src)
    sparse = state["sparse.bin"]
    res = {"hole_kept": sparse[7] >= hole}
    log(f"{label}: tree of {made['bytes']} bytes in {len(state)} entries "
        f"in {base} made in {time.perf_counter() - t0:.1f} s; sparse.bin "
        f"has {sparse[7]} bytes of holes of {sparse[3]} (a {hole}-byte "
        "hole; restores must leave it unwritten"
        + (" and keep it a hole)" if res["hole_kept"] else
           "; this filesystem allocates holes, so their allocation is not "
           "checked)"))
    if holes and not res["hole_kept"]:
        raise AssertionError(f"{label}: {base} keeps holes, but sparse.bin "
                             f"has {sparse[7]} bytes of them")
    store = FsObjectStore(base / f"{label}-repo")
    repo = Repository.init(store, password, chunker=chunker, device=DEVICE)
    per_pass = FUSED_PER_PASS if chunker["align"] == 4096 else SPLIT_PER_PASS

    def backup_run():
        backup = TreeBackup(repo)
        return backup, count_passes(backup.hasher)

    backup, passes = backup_run()
    r = product_run(torch, f"{label} backup ({backup.workers} workers)",
                    lambda: backup.run(src), per_pass, passes)
    snap, stats = r["out"]
    res["backup"] = r
    res["backup_gibs"] = stats.bytes_scanned / GIB / r["secs"]
    log(f"{label} backup: {stats.bytes_scanned} bytes scanned at "
        f"{res['backup_gibs']:.4f} GiB/s, {stats.blobs_new} new blobs "
        f"({stats.bytes_new} bytes, {stats.bytes_stored} stored), "
        f"{stats.blobs_dedup} deduplicated ({card})")
    if stats.bytes_scanned != made["bytes"]:
        raise AssertionError(f"{label}: scanned {stats.bytes_scanned} of "
                             f"{made['bytes']} bytes")
    tree_id = dict(repo.list_snapshots())[snap]["tree"]
    data_ids = {b for b in repo.blob_ids() if repo._entry(b).type == "data"}

    again, passes = backup_run()
    r = product_run(torch, f"{label} second backup", lambda: again.run(src),
                    {}, passes)
    snap2, stats2 = r["out"]
    data_ids2 = {b for b in repo.blob_ids() if repo._entry(b).type == "data"}
    if (stats2.blobs_new, data_ids2) != (0, data_ids) or \
            dict(repo.list_snapshots())[snap2]["tree"] != tree_id:
        raise AssertionError(f"{label}: the second backup stored "
                             f"{stats2.blobs_new} blobs or changed the tree")

    reader = Repository.open(store, password, device=DEVICE)
    r = product_run(torch, f"{label} check(read_data=True)",
                    lambda: reader.check(read_data=True), VERIFY_PER_PASS,
                    None)
    if r["out"] != []:
        raise AssertionError(f"{label}: check found {r['out'][:3]}")
    res["check"] = r

    dst = base / f"{label}-pipelined"
    with sparse_writes() as written:
        r = product_run(torch, f"{label} pipelined restore",
                        lambda: restore_snapshot(
                            Repository.open(store, password, device=DEVICE),
                            dst), VERIFY_PER_PASS, None)
    check_restored(f"{label} pipelined restore", state, dst, hole)
    check_hole_unwritten(f"{label} pipelined restore", written, made)
    res["restore"] = r
    res["restore_gibs"] = made["bytes"] / GIB / r["secs"]
    shutil.rmtree(dst)

    dst = base / f"{label}-serial"
    serial_repo = Repository.open(store, password, device=DEVICE)
    manifest = dict(serial_repo.list_snapshots())[snap]
    with env_set("VOLSYNC_DEVICE_VERIFY", "1"), sparse_writes() as written:
        r = product_run(torch, f"{label} serial restore (device verify)",
                        lambda: TreeRestore(serial_repo, pipeline=False).run(
                            snap, manifest, dst), VERIFY_PER_PASS, None)
    check_restored(f"{label} serial restore", state, dst, hole)
    check_hole_unwritten(f"{label} serial restore", written, made)
    res["serial"] = r
    res["serial_gibs"] = made["bytes"] / GIB / r["secs"]
    shutil.rmtree(dst)
    log(f"{label}: restore {res['restore_gibs']:.4f} GiB/s pipelined, "
        f"{res['serial_gibs']:.4f} GiB/s serial, both byte-identical "
        f"({card})")

    bad_repo = Repository.open(store, password, device=DEVICE)
    tree = json.loads(bad_repo.read_blob(tree_id))
    # big.bin's first blob stored uncompressed (a flag byte and the
    # cipher's overhead around the plaintext): without a password its
    # flipped byte reaches the device verify, not the decompressor
    ie = next(e for e in map(bad_repo._entry, next(
        e for e in tree["entries"] if e["name"] == "big.bin")["content"])
        if e.length == e.raw_length + 1 + bad_repo.box.overhead)
    pack = store.root / f"data/{ie.pack[:2]}/{ie.pack}"
    with open(pack, "r+b") as f:
        f.seek(ie.offset + ie.length // 2)
        byte = f.read(1)
        f.seek(ie.offset + ie.length // 2)
        f.write(bytes([byte[0] ^ 0x20]))
    dst = base / f"{label}-corrupt"
    try:
        restore_snapshot(bad_repo, dst)
    except crypto.IntegrityError as e:
        caught = str(e)
    else:
        raise AssertionError(f"{label}: the corrupt pack restored")
    if (dst / "big.bin").exists():
        raise AssertionError(f"{label}: big.bin was written from a "
                             f"corrupt pack")
    check_restored(f"{label} failed restore", state, dst, hole,
                   only_complete=True)
    shutil.rmtree(dst, ignore_errors=True)
    log(f"{label}: one flipped byte in pack {ie.pack[:12]} raised "
        f"IntegrityError ({caught[:60]}) before big.bin was written")
    return res


def backup_phase(torch, base: Path, backup_bytes: int, backup64_bytes: int,
                 seed: int, card: str, chunker: dict | None = None,
                 hole: int = 32 << 20) -> dict:
    """The restic mover's product path on the port: ``repo_round_trip`` of
    an encrypted repository at the repository default chunker (align
    4096: the fused engine) over ``backup_bytes``, and of an unencrypted
    align-64 repository (the split-phase engine with K2; its corrupt
    pack is caught by the device verify, not the cipher's MAC) over
    ``backup64_bytes``. -> launches by kernel of each run."""
    from volsync_tpu_torch.repo import compress, crypto
    from volsync_tpu_torch.repo.repository import DEFAULT_CHUNKER

    cipher = "AES-256-CTR" if crypto.HAVE_AES else "the SHAKE-256 keystream"
    log(f"backup phase: cipher {cipher}, compression "
        f"{'zstd' if compress.HAVE_ZSTD else 'zlib'} (what this host has "
        f"installed)")
    chunker = dict(chunker or DEFAULT_CHUNKER)
    holes = keeps_holes(base)
    fused = repo_round_trip(torch, "backup", base, backup_bytes, seed,
                            chunker, "smoke-password", hole, card, holes)
    split = repo_round_trip(torch, "backup64", base, backup64_bytes,
                            seed + 1, {**chunker, "align": 64}, None,
                            hole, card, holes)
    return {"fused": fused, "split": split}


#: The durability phase's Reed-Solomon scheme (VOLSYNC_EC_SCHEME) and
#: the storage bound its stored shard bytes are held to.
EC_SCHEME = (4, 2)
EC_STORED_MAX = 1.52
#: Repack's retire grace in the smoke: long enough to keep the two
#: phases of a retire apart, short enough to converge in seconds.
REPACK_GRACE_S = 1.0
EC_PASSWORD = "smoke-password"


class _DecodeLog(PassCounter):
    """A ``PassCounter`` that also keeps the argument it was called
    with: the pack ids ``Repository._ec_reconstruct_once`` decoded."""

    def __init__(self):
        super().__init__()
        self.packs = []

    def wrap(self, fn):
        def counted(repo, pack_id):
            with self._lock:
                self.n += 1
                self.packs.append(pack_id)
            return fn(repo, pack_id)
        return counted


def ec_run(torch, label: str, run, per_pass: dict,
           passes: PassCounter | None, min_passes: int = 1) -> dict:
    """``product_run`` that also counts ``gf_matmul``'s calls (set to 0
    just before, read just after) and the packs decoded."""
    from volsync_tpu_torch.ops import rs
    from volsync_tpu_torch.repo.repository import Repository

    decodes = _DecodeLog()
    rs.CALLS.n = 0
    with patched(Repository, {"_ec_reconstruct_once": decodes.wrap}):
        r = product_run(torch, label, run, per_pass, passes, min_passes)
    r["gf_calls"] = rs.CALLS.n
    r["decoded"] = decodes.packs
    log(f"{label}: gf_matmul called {r['gf_calls']} times, "
        f"{len(decodes.packs)} pack decodes "
        f"({len(set(decodes.packs))} packs)")
    return r


def ec_stripes(store) -> dict:
    """pack id -> its shard keys; raises unless every pack is exactly
    ``ec/<pack>/0 .. k+m-1``."""
    k, m = EC_SCHEME
    out = defaultdict(list)
    for key in store.list("ec/"):
        out[key.split("/")[1]].append(key)
    for pack, keys in out.items():
        if sorted(keys) != sorted(f"ec/{pack}/{i}" for i in range(k + m)):
            raise AssertionError(f"pack {pack} has shards {sorted(keys)}")
    return {p: sorted(ks, key=lambda s: int(s.rsplit("/", 1)[1]))
            for p, ks in out.items()}


def files_needing(repo, tree_id: str, pack: str, prefix: str = "") -> list:
    """Paths of the snapshot tree ``tree_id`` with a blob in ``pack``."""
    out = []
    for e in json.loads(repo.read_blob(tree_id))["entries"]:
        rel = prefix + e["name"]
        if e.get("type") == "dir":
            out += files_needing(repo, e["subtree"], pack, rel + "/")
        elif any(repo._entry(b).pack == pack for b in e.get("content") or []):
            out.append(rel)
    return out


def gf_matmul_entry(torch, seed: int, card: str, pages: int = 1024) -> dict:
    """``gf_matmul`` at the pack shape: a 16 MiB pack at 4+2 is a
    [4, 1024, 4096] grid to [2, 1024, 4096] of parity. Held against
    ``rs_encode_np`` (exact), timed by CUDA-graph replay and eagerly,
    beside its CPU twin (the same ops on the host) and its bound: the
    bytes it must move, (k + r) x P x 4096, over HBM's rate."""
    from volsync_tpu_torch.ops import rs

    k, m = EC_SCHEME
    host = np.random.default_rng(seed).integers(
        0, 256, size=(k, pages, 4096), dtype=np.uint8)
    rows = rs.rs_generator_matrix(k, m)
    grid = torch.from_numpy(host).to(DEVICE)
    got = rs.gf_matmul(rows, grid)
    sync(torch)
    want = torch.from_numpy(rs.rs_encode_np(host.reshape(k, -1), m)
                            .reshape(m, pages, 4096))
    err = max_abs_err(torch, got.cpu(), want)
    ms = time_ms(torch, lambda: rs.gf_matmul(rows, grid), 20)
    eager_ms = time_ms(torch, lambda: rs.gf_matmul(rows, grid), 20,
                       graph=False)
    cpu_grid = torch.from_numpy(host)
    t0 = time.perf_counter()
    for _ in range(3):
        rs.gf_matmul(rows, cpu_grid)
    plain_ms = (time.perf_counter() - t0) / 3 * 1e3
    bound_ms = (k + m) * pages * 4096 / HBM_BYTES_PER_S * 1e3
    entry = {"name": "gf_matmul", "route": "torch ops",
             "source": "volsync_tpu_torch/ops/rs.py",
             "replaces": "volsync_tpu/ops/rs.py:169",
             "shape": [k, pages, 4096], "rows": m, "max_abs_err": err,
             "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
    log(f"gf_matmul at [{k}, {pages}, 4096] -> [{m}, {pages}, 4096]: "
        f"{ms:.4f} ms by CUDA-graph replay, {eager_ms:.4f} ms eager, CPU "
        f"twin {plain_ms:.1f} ms, bytes bound {bound_ms:.4f} ms "
        f"({ms / bound_ms:.1f}x it), max abs err {err} against "
        f"rs_encode_np ({card})")
    if err:
        raise AssertionError(f"gf_matmul differs from rs_encode_np by {err}")
    return entry


def durability_phase(torch, base: Path, total: int, seed: int, card: str,
                     chunker: dict | None = None,
                     hole: int = 32 << 20) -> dict:
    """The erasure-coded repository end to end on the card, under
    ``VOLSYNC_EC_SCHEME=4+2``: back up a seeded tree of ``total`` bytes
    (shards only, stored bytes within 1.52x); lose 2 of 6 shards of every
    pack (a seeded choice) and check with ``read_data=True``, restore
    pipelined and serially (byte-identical, each pack decoded once by
    check and by the pipelined restore, a pack of tree blobs at most
    twice: the snapshot walk and the plan read trees apart); a whole
    scrub backfills the lost shards; a flipped byte in one shard heals
    by backfill, then a whole scrub is clean; a second backup with a quarter of the bytes
    changed, ``forget`` of the first snapshot and ``RepackService``
    until it converges, then a clean check and a byte-identical restore
    of the kept snapshot; last, 3 shards of one pack lost: the scrub
    quarantines it as unhealable and a restore raises before writing
    the files that need it. -> each run's result by name."""
    from volsync_tpu_torch.engine.backup import TreeBackup
    from volsync_tpu_torch.engine.restore import TreeRestore, \
        restore_snapshot
    from volsync_tpu_torch.objstore.store import FsObjectStore, NoSuchKey
    from volsync_tpu_torch.repo import erasure
    from volsync_tpu_torch.repo.repack import RepackService
    from volsync_tpu_torch.repo.repository import DEFAULT_CHUNKER, Repository
    from volsync_tpu_torch.repo.scrub import ScrubService

    k, m = EC_SCHEME
    chunker = dict(chunker or DEFAULT_CHUNKER)
    src = base / "ec-src"
    made = make_backup_tree(torch, src, total, seed, chunker["min_size"],
                            hole)
    state = tree_state(src)
    store = FsObjectStore(base / "ec-repo")

    def opened():
        return Repository.open(store, EC_PASSWORD, device=DEVICE)

    def scrub(label, **kw):
        svc = ScrubService(store, password=EC_PASSWORD, device=DEVICE, **kw)
        r = ec_run(torch, label, svc.run_once, VERIFY_PER_PASS, None)
        r["gibs"] = svc.bytes_scrubbed / GIB / r["secs"]
        r["report"] = svc.last_report
        proven = r["report"]["clean"] + r["report"]["healed"]
        if DEVICE == "cuda" and r["passes"] != proven:
            raise AssertionError(f"{label}: {r['passes']} verify batches "
                                 f"for {proven} packs proven")
        log(f"{label}: {r['out']}, {svc.last_report}, "
            f"{r['gibs']:.4f} GiB/s scrubbed ({card})")
        return r

    res = {}
    with env_set("VOLSYNC_EC_SCHEME", f"{k}+{m}"):
        repo = Repository.init(store, EC_PASSWORD, chunker=chunker,
                               device=DEVICE)
        backup = TreeBackup(repo)
        r = ec_run(torch, f"ec backup ({backup.workers} workers)",
                   lambda: backup.run(src), FUSED_PER_PASS,
                   count_passes(backup.hasher))
        snap, stats = r["out"]
        r["gibs"] = stats.bytes_scanned / GIB / r["secs"]
        res["backup"] = r
        if stats.bytes_scanned != made["bytes"]:
            raise AssertionError(f"ec: scanned {stats.bytes_scanned} of "
                                 f"{made['bytes']} bytes")
        others = [key for key in store.list("")
                  if key.startswith(("data/", "mirror/"))]
        if others:
            raise AssertionError(f"ec: the backup wrote {others[:3]}")
        stripes = ec_stripes(store)
        logical = sum(erasure.parse_shard(store.get_range(
            keys[0], 0, erasure.HEADER_LEN))[3] for keys in stripes.values())
        stored = sum(store.size(key) for keys in stripes.values()
                     for key in keys)
        res["overhead"] = stored / logical
        log(f"ec backup: {stats.bytes_scanned} bytes at {r['gibs']:.4f} "
            f"GiB/s into {len(stripes)} packs of {k}+{m} shards, "
            f"{stored} bytes stored for {logical} bytes of packs "
            f"({res['overhead']:.4f}x) ({card})")
        if res["overhead"] > EC_STORED_MAX:
            raise AssertionError(f"ec: stored {res['overhead']:.4f}x")
        if r["gf_calls"] != len(stripes):
            raise AssertionError(f"ec: {r['gf_calls']} gf_matmul calls for "
                                 f"{len(stripes)} packs")

        rng = np.random.default_rng(seed)
        for pack in sorted(stripes):
            for i in rng.choice(k + m, size=m, replace=False):
                store.delete(stripes[pack][i])

        # packs that hold tree blobs: check's walk of the snapshots and a
        # restore's plan read them apart from the blob pass, which may
        # decode them again once the memo moved on
        meta = opened()
        tree_packs = {meta._entry(b).pack for b in meta.blob_ids()
                      if meta._entry(b).type == "tree"}

        def decoded_once(label, r, again=frozenset()):
            """Every pack decoded once, those in ``again`` at most
            twice."""
            seen = defaultdict(int)
            for p in r["decoded"]:
                seen[p] += 1
            if set(seen) != set(stripes) or any(
                    n > (2 if p in again else 1) for p, n in seen.items()):
                raise AssertionError(
                    f"{label}: decoded {len(r['decoded'])} times "
                    f"({len(seen)} packs) for {len(stripes)} packs")

        r = ec_run(torch, "ec check(read_data=True), 2 of 6 shards lost",
                   lambda: opened().check(read_data=True), VERIFY_PER_PASS,
                   None)
        if r["out"] != []:
            raise AssertionError(f"ec check found {r['out'][:3]}")
        decoded_once("ec check", r, tree_packs)
        res["check"] = r

        dst = base / "ec-pipelined"
        with sparse_writes() as written:
            r = ec_run(torch, "ec pipelined restore, 2 of 6 shards lost",
                       lambda: restore_snapshot(opened(), dst),
                       VERIFY_PER_PASS, None)
        check_restored("ec pipelined restore", state, dst, hole)
        check_hole_unwritten("ec pipelined restore", written, made)
        decoded_once("ec pipelined restore", r, tree_packs)
        r["gibs"] = made["bytes"] / GIB / r["secs"]
        res["restore"] = r
        shutil.rmtree(dst)

        dst = base / "ec-serial"
        serial_repo = opened()
        manifest = dict(serial_repo.list_snapshots())[snap]
        with env_set("VOLSYNC_DEVICE_VERIFY", "1"), \
                sparse_writes() as written:
            r = ec_run(torch, "ec serial restore (device verify)",
                       lambda: TreeRestore(serial_repo, pipeline=False).run(
                           snap, manifest, dst), VERIFY_PER_PASS, None)
        check_restored("ec serial restore", state, dst, hole)
        check_hole_unwritten("ec serial restore", written, made)
        if set(r["decoded"]) != set(stripes):
            raise AssertionError("ec serial restore: packs decoded "
                                 f"{len(set(r['decoded']))} of "
                                 f"{len(stripes)}")
        r["gibs"] = made["bytes"] / GIB / r["secs"]
        res["serial"] = r
        shutil.rmtree(dst)
        log(f"ec restores: pipelined {res['restore']['gibs']:.4f} GiB/s, "
            f"serial {r['gibs']:.4f} GiB/s, both byte-identical with 2 of "
            f"6 shards of every pack lost ({card})")

        r = scrub("ec scrub (whole, backfills the lost shards)")
        if r["out"] != "healed" or r["report"]["healed"] != len(stripes):
            raise AssertionError(f"ec scrub: {r['out']} {r['report']}")
        ec_stripes(store)  # every pack whole again
        res["scrub"] = r

        victim = sorted(stripes)[0]
        shard = store.root / stripes[victim][1]
        good = shard.read_bytes()
        with open(shard, "r+b") as f:
            f.seek(erasure.HEADER_LEN + len(good) // 3)
            byte = f.read(1)
            f.seek(erasure.HEADER_LEN + len(good) // 3)
            f.write(bytes([byte[0] ^ 0x10]))
        r = scrub("ec scrub (one pack, a flipped byte in shard 1)",
                  packs_per_cycle=1)
        if r["out"] != "healed" or shard.read_bytes() != good:
            raise AssertionError(f"ec scrub did not heal shard 1 of "
                                 f"{victim}: {r['out']}")
        r = scrub("ec scrub (whole, after the heal)")
        if r["out"] != "clean":
            raise AssertionError(f"ec scrub after the heal: {r['out']}")
        res["scrub_clean"] = r

        # a quarter of the volume new: the head of big.bin rewritten
        quarter = made["bytes"] // 4 // 4096 * 4096
        new = np.random.default_rng(seed + 1)
        with open(src / "big.bin", "r+b") as f:
            for off in range(0, quarter, 8 << 20):
                f.write(new.bytes(min(8 << 20, quarter - off)))
        state2 = tree_state(src)
        again = TreeBackup(opened())
        r = ec_run(torch, "ec second backup (a quarter of the bytes new)",
                   lambda: again.run(src), FUSED_PER_PASS,
                   count_passes(again.hasher))
        snap2 = r["out"][0]
        res["backup2"] = r
        forgotten = opened().forget(last=1)
        if forgotten != [snap]:
            raise AssertionError(f"ec forget removed {forgotten}")

        repacker = RepackService(store, password=EC_PASSWORD, device=DEVICE,
                                 scheme=EC_SCHEME, dead_ratio=0.05,
                                 grace_seconds=REPACK_GRACE_S)
        cycles = []
        for _ in range(8):
            # one verify batch a stripe written; a sweep or a clean
            # cycle writes none
            r = ec_run(torch, f"ec repack cycle {len(cycles) + 1}",
                       repacker.run_once, VERIFY_PER_PASS, None,
                       min_passes=0)
            r["report"] = dict(repacker.last_report or {})
            if DEVICE == "cuda" and r["passes"] != r["report"].get(
                    "packs_rewritten", 0):
                raise AssertionError(f"ec repack: {r['passes']} verify "
                                     f"batches for {r['report']}")
            cycles.append(r)
            log(f"ec repack cycle {len(cycles)}: {r['out']}, "
                f"{r['report']}")
            if r["out"] == "error":
                raise AssertionError("ec repack cycle failed")
            if r["out"] == "clean" and not list(
                    store.list("pending-delete/")):
                break
            time.sleep(REPACK_GRACE_S)
        else:
            raise AssertionError(f"ec repack never converged: "
                                 f"{repacker.outcomes}")
        secs = sum(c["secs"] for c in cycles)
        rewritten = sum(c["report"].get("stripes_bytes", 0) for c in cycles)
        res["repack"] = {"cycles": cycles, "secs": secs,
                         "gibs": rewritten / GIB / secs,
                         "outcomes": dict(repacker.outcomes)}
        log(f"ec repack: converged in {len(cycles)} cycles, {secs:.3f} s "
            f"of cycles (grace sleeps excluded), {rewritten} bytes of "
            f"stripes written, {res['repack']['gibs']:.4f} GiB/s "
            f"({card})")
        r = ec_run(torch, "ec check(read_data=True) after the repack",
                   lambda: opened().check(read_data=True), VERIFY_PER_PASS,
                   None)
        if r["out"] != []:
            raise AssertionError(f"ec check after repack: {r['out'][:3]}")
        res["check2"] = r
        stripes = ec_stripes(store)
        dst = base / "ec-kept"
        r = ec_run(torch, "ec restore of the kept snapshot",
                   lambda: restore_snapshot(opened(), dst), VERIFY_PER_PASS,
                   None)
        check_restored("ec restore after repack", state2, dst, hole)
        shutil.rmtree(dst)
        res["restore2"] = r

        reader = opened()
        tree_id = dict(reader.list_snapshots())[snap2]["tree"]
        at = next(i for i, p in enumerate(sorted(stripes))
                  if i and files_needing(reader, tree_id, p))
        lost = sorted(stripes)[at]
        need = files_needing(reader, tree_id, lost)
        for key in stripes[lost][:m + 1]:
            store.delete(key)
        r = scrub("ec scrub (3 of 6 shards of one pack lost)",
                  packs_per_cycle=at + 1)
        if r["out"] != "unhealable" or not store.exists(
                f"quarantine/{lost}"):
            raise AssertionError(f"ec scrub below k: {r['out']}")
        dst = base / "ec-lost"
        try:
            restore_snapshot(opened(), dst)
        except NoSuchKey as e:
            caught = str(e)
        else:
            raise AssertionError("ec: a pack below k restored")
        written = [rel for rel in need if (dst / rel).exists()]
        if written:
            raise AssertionError(f"ec: {written[:3]} written without "
                                 f"pack {lost}")
        check_restored("ec failed restore", state2, dst, hole,
                       only_complete=True)
        shutil.rmtree(dst, ignore_errors=True)
        log(f"ec: pack {lost[:12]} below k quarantined as unhealable; the "
            f"restore raised ({caught[:60]}) before writing {len(need)} "
            f"file(s) that need it")
    return res


# -- MD5 (md5_slices) in the kernels phase ----------------------------------

#: ALU instructions of one MD5 compression as the source writes it, the
#: fallback where no cuobjdump gives the compiled block's count: a round
#: is one LOP3 (every round function is a logic function of three
#: words), one SHF (the rotation) and three adds; 4 adds fold the state.
#: The compiler folds some adds and rotations into IMAD and LEA, so the
#: compiled block has fewer (chip_smoke logs both).
MD5_BLOCK_ALU_OPS = 64 * 5 + 4
#: The signature's shape (a 512 MiB file at pick_block_len's 32 KiB) and
#: the 4 KiB groups' verify shape (a few thousand candidate windows).
MD5_SIG_WINDOWS, MD5_SIG_LEN = 16384, 32 << 10
MD5_VERIFY_WINDOWS, MD5_VERIFY_LEN = 8192, 4096
#: A 1 MiB file's signature (pick_block_len: 4 KiB blocks).
MD5_SMALL_WINDOWS, MD5_SMALL_LEN = 256, 4096


def md5_block_ops(sass: dict) -> tuple:
    """(ALU instructions of one compressed block, their source): the
    LOP3/SHF/PRMT and IADD3 of the lanes form's compiled block (its loop
    holds one compression and the ring's copies), else the source's
    count ``MD5_BLOCK_ALU_OPS``."""
    counts = sass.get("md5_slices_lanes")
    if counts:
        return counts["LOP3/SHF"] + counts["IADD3"], "cuobjdump"
    return MD5_BLOCK_ALU_OPS, "as written"


def md5_bound(lanes: int, blocks: int, longest: int, nbytes: int,
              block_ops: float, round_cycles: float | None = None) -> dict:
    """Bound of one md5_slices launch from its work: the largest of the
    blocks' ALU instructions over the card's ALU rate (or its bytes over
    HBM's), the per-warp floor of its longest lane, and, given
    ``round_cycles`` (one round's dependent latency, ``md5_round_cycles``),
    the chain of its longest lane: 64 dependent rounds a block, one
    after another, at the card's clock (``chain_ms``; None without
    ``round_cycles``)."""
    from volsync_tpu_torch.ops import md5

    t_ops = blocks * block_ops / INT32_ALU_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    work = (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")
    b = lanes_bound(lanes, md5.MD5_THREADS, int(longest * block_ops), work)
    b["chain_ms"] = None
    if round_cycles:
        b["chain_ms"] = longest * 64 * round_cycles / CLOCK_HZ * 1e3
        if b["chain_ms"] > b["bound_ms"]:
            b.update(bound_ms=b["chain_ms"], bound_by="operations",
                     bound_kind="chain")
    return b


def md5_entry(torch, stats, name: str, label: str, run, plain, check,
              b: dict, main: bool) -> None:
    """One md5_slices shape: the kernel equal to its twin on the same
    inputs (and ``check`` against hashlib), timed by graph replay and
    eagerly beside the twin and the bound ``b``."""
    out_k = run()
    sync(torch)
    t0 = time.perf_counter()
    out_p = plain()
    sync(torch)
    plain_s = time.perf_counter() - t0
    err = max_abs_err(torch, out_k, out_p)
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"{name} ({label}) differs from its twin "
                             f"(max abs err {err})")
    check(out_k)
    st = stats[name]
    st["err"] = max(st["err"], err)
    ms = time_ms(torch, run, 20)
    eager = time_ms(torch, run, 20, graph=False)
    st.setdefault("shapes", {})[label] = {
        "lanes": b["lanes"], "blocks": b["blocks"], "ms": ms,
        "eager_ms": eager, "plain_ms": plain_s * 1e3,
        "bound_ms": b["bound_ms"], "bound_kind": b["bound_kind"],
        "chain_ms": b["chain_ms"]}
    if main:
        st["ms"].append(ms)
        st["eager_ms"].append(eager)
        st["plain_ms"].append(plain_s * 1e3)
        set_bound(st, b)
        st["longest"] = b["longest"]
    log(f"{name} ({label}): {b['lanes']} lanes, {b['blocks']} blocks, "
        f"longest {b['longest']}; equals twin (max abs err {err}) and "
        f"hashlib; kernel {ms:.4f} ms (eager {eager:.4f}), twin "
        f"{plain_s * 1e3:.1f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_kind']}; per-warp floor {b['floor_ms']:.4f} ms, "
        f"chain " + (f"{b['chain_ms']:.4f} ms)" if b["chain_ms"]
                     else "not measured)"))


def md5_split_line(label: str, sp: dict, round_cycles: float | None) -> str:
    """One log line of a lane's clock64 split (``time_md5_calls.
    split_summary``): SM cycles a block in each part, beside the chain
    of 64 dependent rounds at ``round_cycles`` (the probe's)."""
    per = sp["per_block"]
    chain = (f"{64 * round_cycles:.1f}" if round_cycles
             else "not measured")
    return (f"md5_slices split ({label}, lane {sp['lane']}, "
            f"{sp['blocks']} blocks; clock64 SM cycles a block): wait "
            f"{per['wait']:.1f}, words {per['words']:.1f} (edge path "
            f"{per['edge']:.1f}), rounds {per['rounds']:.1f}, issue "
            f"{per['issue']:.1f}, other {per['other']:.1f}; loop "
            f"{per['loop']:.1f} against a chain of {chain}")


def md5_split_entry(torch, stats, label: str, data, starts, bl: int,
                    lane: int, round_cycles: float | None) -> None:
    """Log and keep lane ``lane``'s clock64 split at one shape
    (``time_md5_calls.block_split``: the instrumented instance, not a
    product launch, so no launch count moves)."""
    from volsync_tpu_torch.tools.time_md5_calls import block_split

    sp = block_split(torch, data, starts, bl, lane)
    if sp is None:
        raise AssertionError("md5.cu has no vt_md5_windows_split")
    stats["md5_slices"].setdefault("split", {})[label] = sp
    log(md5_split_line(label, sp, round_cycles))


def md5_kernel_entries(torch, stats, seed: int, sass: dict,
                       round_cycles: float | None = None) -> None:
    """md5_slices in both forms against its twin (max abs err 0) and
    hashlib, timed and bounded (with ``round_cycles``, also by the chain
    of the longest lane): the windows form at the signature's shape
    (contiguous 32 KiB blocks of 512 MiB), at a 1 MiB file's signature
    (256 4 KiB blocks) and at a verify shape (4 KiB windows at odd
    offsets, one running past the buffer's end, one at a negative
    start), and the lanes form on ``md5_pack_host`` of mixed lengths
    0..200 bytes. The chain bound's cross-check: one launch of a single
    32 KiB window (one thread's chain), timed. The compiled round's
    chain and each shape's clock64 split are logged beside them."""
    from volsync_tpu_torch.ops import md5

    ops, src = md5_block_ops(sass)
    log(f"md5_slices: {ops:.1f} ALU instructions a block ({src}; "
        f"{MD5_BLOCK_ALU_OPS} as the source writes it)")
    for name, ch in md5_sass_chain().items():
        stats[name]["round_chain"] = ch
        log(f"{name} compiled round chain (cuobjdump -sass, the longest "
            f"register dependency through the block loop's rounds): "
            f"{ch['length']} instructions, {ch['per_round']:.2f} a round; "
            f"on it {json.dumps(ch['ops'])}")
    rng = np.random.default_rng(seed + 9)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 9)
    n, bl = MD5_SIG_WINDOWS, MD5_SIG_LEN
    data = torch.randint(0, 256, (n * bl,), dtype=torch.uint8,
                         device=DEVICE, generator=gen)
    picks = rng.choice(n, 16, replace=False)
    host = {int(i): data[i * bl:(i + 1) * bl].cpu().numpy() for i in picks}

    def sig_check(out):
        dig = md5.state_bytes(out)
        for i, blk in host.items():
            if dig[i] != hashlib.md5(blk).digest():
                raise AssertionError(f"md5_slices block {i} != hashlib")

    nb = (bl + 72) // 64
    md5_entry(torch, stats, "md5_slices", "signature",
              lambda: md5.md5_contiguous_blocks_device(data, block_len=bl),
              lambda: md5._md5_contiguous_plain(data, block_len=bl),
              sig_check, {**md5_bound(n, n * nb, nb, n * (bl + 16), ops,
                                      round_cycles),
                          "lanes": n, "blocks": n * nb, "longest": nb},
              main=True)
    grid = torch.arange(n, dtype=torch.int64, device=DEVICE) * bl
    md5_split_entry(torch, stats, "signature", data, grid, bl,
                    n // 2, round_cycles)
    one = data[:bl]
    if md5.state_bytes(md5.md5_contiguous_blocks_device(one, block_len=bl)) \
            != [hashlib.md5(one.cpu().numpy().tobytes()).digest()]:
        raise AssertionError("md5_slices on one window != hashlib")
    one_ms = time_ms(torch, lambda: md5.md5_contiguous_blocks_device(
        one, block_len=bl), 20)
    chain = md5_bound(1, nb, nb, bl + 16, ops, round_cycles)["chain_ms"]
    stats["md5_slices"]["one_window_ms"] = one_ms
    log(f"md5_slices on one {bl}-byte window ({nb} blocks, one thread's "
        f"chain): {one_ms:.4f} ms by graph replay; chain bound "
        + (f"{chain:.4f} ms" if chain else "not measured"))
    md5_split_entry(torch, stats, "one window", one, grid[:1], bl, 0,
                    round_cycles)
    del data, one, grid
    # A 1 MiB file's signature: 256 contiguous 4 KiB windows, the delta
    # cell's most frequent launch.
    n, bl = MD5_SMALL_WINDOWS, MD5_SMALL_LEN
    small = torch.randint(0, 256, (n * bl,), dtype=torch.uint8,
                          device=DEVICE, generator=gen)
    shost = small.cpu().numpy()

    def small_check(out):
        if md5.state_bytes(out) != [hashlib.md5(shost[i * bl:(i + 1) * bl])
                                    .digest() for i in range(n)]:
            raise AssertionError("md5_slices 1 MiB signature != hashlib")

    nb = (bl + 72) // 64
    md5_entry(torch, stats, "md5_slices", "1 MiB signature",
              lambda: md5.md5_contiguous_blocks_device(small, block_len=bl),
              lambda: md5._md5_contiguous_plain(small, block_len=bl),
              small_check, {**md5_bound(n, n * nb, nb, n * (bl + 16), ops,
                                        round_cycles),
                            "lanes": n, "blocks": n * nb, "longest": nb},
              main=False)
    del small
    n, bl = MD5_VERIFY_WINDOWS, MD5_VERIFY_LEN
    hbuf = rng.integers(0, 256, 32 << 20, dtype=np.uint8)
    L = hbuf.shape[0]
    starts = rng.integers(0, L - bl, n) | 1
    starts[:3] = [L - 100, L - bl, -5]  # past the end, the last, clamped
    vdata = torch.from_numpy(hbuf).to(DEVICE)
    vst = torch.from_numpy(starts.astype(np.int64)).to(DEVICE)

    def verify_check(out):
        dig = md5.state_bytes(out)
        for k in range(1, n, 97):
            a = int(starts[k])
            if dig[k] != hashlib.md5(hbuf[a:a + bl]).digest():
                raise AssertionError(f"md5_slices window {k} != hashlib")

    nb = (bl + 72) // 64
    md5_entry(torch, stats, "md5_slices", "verify",
              lambda: md5.md5_fixed_blocks_device(vdata, vst, block_len=bl),
              lambda: md5._md5_windows_plain(vdata, vst, block_len=bl),
              verify_check, {**md5_bound(n, n * nb, nb, n * (bl + 24), ops,
                                         round_cycles),
                             "lanes": n, "blocks": n * nb, "longest": nb},
              main=False)
    for lane, label in ((n // 2, "verify"), (0, "verify, past the end"),
                        (2, "verify, before the start")):
        md5_split_entry(torch, stats, label, vdata, vst, bl, lane,
                        round_cycles)
    chunks = [rng.bytes(int(k)) for k in rng.integers(0, 201, 16384)]
    blocks, nbl = md5.md5_pack_host(chunks)
    b = torch.from_numpy(blocks.view(np.int32)).to(DEVICE)
    nbt = torch.from_numpy(nbl).to(DEVICE)
    want = [hashlib.md5(c).digest() for c in chunks]

    def lanes_check(out):
        if md5.state_bytes(out) != want or md5.md5_many(chunks,
                                                        device=DEVICE) != want:
            raise AssertionError("md5_slices lanes differ from hashlib")

    total, longest = int(nbl.sum()), int(nbl.max())
    md5_entry(torch, stats, "md5_slices_lanes", "mixed 0-200 B",
              lambda: md5.md5_blocks(b, nbt),
              lambda: md5._md5_lanes_plain(b, nbt), lanes_check,
              {**md5_bound(len(chunks), total, longest,
                           blocks.nbytes + len(chunks) * 20, ops,
                           round_cycles),
               "lanes": len(chunks), "blocks": total, "longest": longest},
              main=True)


# -- delta: the rsync delta engine over a seeded 1 GiB volume ----------------

#: The delta phase's layout at ``--delta-gib`` 1 (BASELINE.json configs[0],
#: a 1 GiB PVC replicated by rsync): one file of half the volume
#: (pick_block_len: 32 KiB blocks), 64 files of 4 MiB and 240 of 1 MiB
#: (4 KiB blocks), 300 files below one block, an empty file and a file
#: with no basis. ``delta_layout`` scales the file counts and the big
#: file with the volume.
DELTA_LAYOUT = {"big": 512 << 20, "n_mid": 64, "mid": 4 << 20,
                "n_small": 240, "small": 1 << 20, "n_tiny": 300}
DELTA_BIG_OVERWRITES = 16
DELTA_INSERT = 37
DELTA_APPEND = 12345
#: Files held against the port on the CPU (its twins).
DELTA_CPU_FILES = 8


def delta_layout(gib: float) -> dict:
    return {**DELTA_LAYOUT, "big": int(DELTA_LAYOUT["big"] * gib) // 4096
            * 4096, "n_mid": max(4, round(DELTA_LAYOUT["n_mid"] * gib)),
            "n_small": max(4, round(DELTA_LAYOUT["n_small"] * gib))}


def make_delta_trees(root: Path, layout: dict, seed: int) -> dict:
    """A destination tree ``root/dst`` and a source tree ``root/src`` from
    ``seed``: the big file with 16 scattered 1 KiB overwrites, a 37-byte
    insertion a third of the way in and a 12,345-byte append; the 4 MiB
    and 1 MiB files in turns unchanged, with one byte inserted in the
    middle, with one 4 KiB block rewritten, unrelated; the files below a
    block unchanged (the host's short circuit: a copy of the tail block);
    an emptied file; a file with no basis. -> {rel:
    (kind, edit bytes, src bytes, dst bytes or None)}."""
    rng = np.random.default_rng(seed)
    files = {}
    big = rng.bytes(layout["big"])
    src = bytearray(big)
    at = np.sort(rng.choice(len(big) // 4096 - 2, DELTA_BIG_OVERWRITES,
                            replace=False)) * 4096 + 1000
    for a in at:
        src[a:a + 1024] = rng.bytes(1024)
    third = len(big) // 3
    src[third:third] = rng.bytes(DELTA_INSERT)
    src += rng.bytes(DELTA_APPEND)
    files["big.bin"] = ("big", DELTA_BIG_OVERWRITES * 1024 + DELTA_INSERT
                        + DELTA_APPEND, bytes(src), big)
    kinds = ("unchanged", "insert", "rewrite", "unrelated")
    for d, count, size in (("mid", layout["n_mid"], layout["mid"]),
                           ("small", layout["n_small"], layout["small"])):
        for i in range(count):
            old = rng.bytes(size)
            kind = kinds[i % 4]
            if kind == "unchanged":
                new, edit = old, 0
            elif kind == "insert":
                new, edit = old[:size // 2] + rng.bytes(1) + old[size // 2:], 1
            elif kind == "rewrite":
                b = size // 4096 // 2 * 4096
                new, edit = old[:b] + rng.bytes(4096) + old[b + 4096:], 4096
            else:
                new, edit = rng.bytes(size), size
            files[f"{d}/{d}{i:03d}.bin"] = (kind, edit, new, old)
    for i in range(layout["n_tiny"]):
        old = rng.bytes(int(rng.integers(1, 4096)))
        files[f"tiny/t{i:03d}.bin"] = ("tiny", 0, old, old)
    files["empty.bin"] = ("empty", 0, b"", rng.bytes(10_000))
    files["new.bin"] = ("no_basis", 100_000, rng.bytes(100_000), None)
    for rel, (_, _, new, old) in files.items():
        for side, data in (("src", new), ("dst", old)):
            if data is not None:
                p = root / side / rel
                p.parent.mkdir(parents=True, exist_ok=True)
                p.write_bytes(data)
    return files


def host_signature_check(sig, dst: bytes) -> None:
    """Every weak sum of ``sig`` equals rsync's formula on the host
    (numpy, uint32 wraparound: only the residues mod 2^16 are kept) and
    every strong sum hashlib's MD5 of its block."""
    from volsync_tpu_torch.ops.rolling import weak_checksum_host

    bl, n_full = sig.block_len, len(dst) // sig.block_len
    x = np.frombuffer(dst, np.uint8)[: n_full * bl].reshape(n_full, bl) \
        .astype(np.uint32)
    with np.errstate(over="ignore"):
        a = x.sum(axis=1, dtype=np.uint32) & 0xFFFF
        b = (x * np.arange(bl, 0, -1, dtype=np.uint32)).sum(
            axis=1, dtype=np.uint32) & 0xFFFF
    weak = list(a | (b << 16))
    strong = [hashlib.md5(dst[i * bl:(i + 1) * bl]).digest()
              for i in range(n_full)]
    if len(dst) % bl:
        weak.append(weak_checksum_host(dst[n_full * bl:]))
        strong.append(hashlib.md5(dst[n_full * bl:]).digest())
    if [int(w) for w in sig.weak] != [int(w) for w in weak] \
            or sig.strong != strong or sig.size != len(dst):
        raise AssertionError(f"signature of a {len(dst)}-byte file differs "
                             f"from the host formulas")


@contextlib.contextmanager
def stage_timers(torch, module, names: dict, totals: dict):
    """Within the block, each ``module.<fn>`` in ``names`` adds its wall
    seconds (synchronised before and after) to ``totals[names[fn]]``."""
    def timer(stage):
        def make(fn):
            def wrapper(*args, **kwargs):
                sync(torch)
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                sync(torch)
                totals[stage] += time.perf_counter() - t0
                return out
            return wrapper
        return make

    with patched(module, {fn: timer(st) for fn, st in names.items()}):
        yield


def rolling_entry(torch, ds, args, kw) -> dict:
    """One ``match_offsets_batch`` call (rolling weak sums, per-row
    membership and compaction: torch ops, no kernel of the port) timed
    again on its inputs from the delta run, eagerly (its temporaries at
    the largest group take tens of GB, too many to capture a graph of
    several runs), beside its bytes bound: the [n, L] rows and the
    sorted weak sets read once, the candidates written once."""
    data, sorted_weak = args[0], args[1]
    ms = time_ms(torch, lambda: ds.match_offsets_batch(*args, **kw), 3,
                 graph=False)
    nbytes = (data.numel() + sorted_weak.numel() * 8 + data.shape[0] * 16
              + kw["max_candidates"] * 8)
    out = {"rows": data.shape[0], "row_bytes": data.shape[1],
           "window": kw["window"], "eager_ms": ms,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    log(f"rolling + membership ({out['rows']} x {out['row_bytes']} bytes, "
        f"window {out['window']}): {ms:.4f} ms eager, bytes bound "
        f"{out['bound_ms']:.4f} ms")
    return out


def literal_within(kind: str, edit: int, n_src: int, lit: int, ops,
                   block_len: int) -> bool:
    """Whether a file of ``make_delta_trees``' ``kind`` (``edit`` bytes
    edited) shipped the literal bytes its edit allows: none unchanged,
    all of an unrelated file or one with no basis, a copy of the tail
    block below a block, nothing for the emptied file, else at least
    the edit and at most two blocks more an edit."""
    n_edits = DELTA_BIG_OVERWRITES + 2 if kind == "big" else 1
    return {"unchanged": lit == 0, "unrelated": lit == n_src,
            "tiny": ops == [("copy", 0, 1)], "no_basis": lit == n_src,
            "empty": lit == 0 and ops == []}.get(
        kind, edit <= lit <= edit + 2 * block_len * n_edits)


def rows_of(verifies: list):
    """A ``patched`` wrapper of ``verify_candidates_batch`` that appends
    each call's candidate count to ``verifies`` (a scan group with
    candidates launches one ``md5_slices``)."""
    def make(fn):
        def wrapper(data, rows, offs, *, block_len):
            verifies.append(len(rows))
            return fn(data, rows, offs, block_len=block_len)
        return wrapper
    return make


#: deltasync's functions bracketed by the delta phase's stage timers.
DELTA_STAGES = {"_to_device": "upload", "build_signature": "signature",
                "match_offsets_batch": "rolling + membership",
                "verify_candidates_batch": "md5 verify",
                "_select_ops": "select"}


def delta_phase(torch, base: Path, layout: dict, seed: int,
                card: str) -> dict:
    """The rsync mover's data plane on the port, minus the channel (ref
    movers/rsync/entry.py:442-500): for each file of the seeded trees in
    walk order, block_len = pick_block_len(max(src, dst)); the
    destination's signatures on the card; ``delta_scan_batch``
    over ``envflags.delta_batch_files()`` files a call; ``apply_delta``
    each file. The launch counts are set to 0 just before and read just
    after; then the checks (module docstring)."""
    from volsync_tpu_torch import envflags
    from volsync_tpu_torch.engine import deltasync as ds
    from volsync_tpu_torch.ops import md5
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts

    t0 = time.perf_counter()
    made = make_delta_trees(base, layout, seed)
    rels = sorted(made)
    log(f"delta: {len(rels)} files, "
        f"{sum(len(m[2]) for m in made.values())} source and "
        f"{sum(len(m[3]) for m in made.values() if m[3] is not None)} "
        f"destination bytes written in {time.perf_counter() - t0:.1f} s")
    per_call = envflags.delta_batch_files()
    totals = defaultdict(float)
    scans = PassCounter()
    verifies = []

    matches = {}  # the largest scan call's inputs, and a 4 KiB group's

    def keep_match(fn):
        def wrapper(*args, **kw):
            big = matches.get("largest")
            if big is None or args[0].numel() > big[0][0].numel():
                matches["largest"] = (args, kw)
            if kw["window"] == 4096:
                matches.setdefault("4 KiB group", (args, kw))
            return fn(*args, **kw)
        return wrapper

    for k in KERNELS:
        k.launches = 0
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    srcs, dsts, sigs, ops, rebuilt = {}, {}, {}, {}, {}
    with device_trace(torch) as trace, \
            stage_timers(torch, ds, DELTA_STAGES, totals), \
            patched(ds, {"delta_scan_batch": scans.wrap,
                         "verify_candidates_batch": rows_of(verifies),
                         "match_offsets_batch": keep_match}):
        sync(torch)
        t1 = time.perf_counter()
        for rel in rels:
            srcs[rel] = (base / "src" / rel).read_bytes()
            d = base / "dst" / rel
            dsts[rel] = d.read_bytes() if d.exists() else None
        t_read = time.perf_counter() - t1
        t2 = time.perf_counter()
        for rel in rels:
            if dsts[rel] is not None:
                bl = ds.pick_block_len(max(len(srcs[rel]), len(dsts[rel])))
                sigs[rel] = ds.build_file_signature(dsts[rel], bl,
                                                    device=DEVICE)
        sync(torch)
        t_sig = time.perf_counter() - t2
        t3 = time.perf_counter()
        based = [rel for rel in rels if rel in sigs]
        for i in range(0, len(based), per_call):
            part = based[i:i + per_call]
            for rel, o in zip(part, ds.delta_scan_batch(
                    [(srcs[r], sigs[r]) for r in part], device=DEVICE)):
                ops[rel] = o
        t_scan = time.perf_counter() - t3
        t4 = time.perf_counter()
        for rel in rels:
            if rel not in ops:  # no basis: the whole file as literals
                ops[rel] = [("data", srcs[rel])] if srcs[rel] else []
            bl = sigs[rel].block_len if rel in sigs else ds.pick_block_len(
                len(srcs[rel]))
            rebuilt[rel] = ds.apply_delta(ops[rel], dsts[rel] or b"", bl)
        t_apply = time.perf_counter() - t4
        sync(torch)
        secs = time.perf_counter() - t1
    launches = launch_counts()
    lanes_launches = md5.MD5_LANES.launches
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None

    # Launches: one md5_slices a signature with a full block, one a scan
    # group with candidates; nothing else.
    full = sum(len(dsts[r]) // sigs[r].block_len > 0 for r in sigs)
    groups = sum(1 for n in verifies if n)
    want = {k: 0 for k in launches}
    want["md5_slices"] = full + groups
    if DEVICE == "cuda" and (launches != want or lanes_launches):
        raise AssertionError(f"delta: launches {launches} (lanes form "
                             f"{lanes_launches}), expected {want}")
    t5 = time.perf_counter()
    for rel in rels:
        if rebuilt[rel] != srcs[rel]:
            raise AssertionError(f"delta: {rel} rebuilt differs from its "
                                 f"source")
        if rel in sigs:
            host_signature_check(sigs[rel], dsts[rel])
            if ds.compute_delta(srcs[rel], sigs[rel], device=DEVICE) \
                    != ops[rel]:
                raise AssertionError(f"delta: {rel}: batched ops differ "
                                     f"from compute_delta's")
    lit = {rel: ds.delta_stats(ops[rel], sigs[rel].block_len if rel in sigs
                               else 4096)["literal_bytes"] for rel in rels}
    for rel in rels:
        kind, edit, src, _ = made[rel]
        bl = sigs[rel].block_len if rel in sigs else 0
        if not literal_within(kind, edit, len(src), lit[rel], ops[rel], bl):
            raise AssertionError(f"delta: {rel} ({kind}, {edit} edited "
                                 f"bytes, block {bl}) shipped {lit[rel]} "
                                 f"literal bytes")
    cpu = [r for r in rels if made[r][0] != "tiny" and r.startswith(
        "small/")][:DELTA_CPU_FILES]
    cpu_items = [(srcs[r], ds.build_file_signature(
        dsts[r], sigs[r].block_len, device="cpu")) for r in cpu]
    for r, (_, s) in zip(cpu, cpu_items):
        if s.to_wire() != sigs[r].to_wire():
            raise AssertionError(f"delta: {r}: signature differs on the CPU")
    if ds.delta_scan_batch(cpu_items, device="cpu") != [ops[r] for r in cpu]:
        raise AssertionError("delta: ops differ from the port's on the CPU")
    t_check = time.perf_counter() - t5
    rolling = {label: rolling_entry(torch, ds, args, kw)
               for label, (args, kw) in matches.items()}
    matches.clear()

    src_bytes = sum(len(s) for s in srcs.values())
    dst_bytes = sum(len(d) for d in dsts.values() if d is not None)
    busy = trace["busy_s"]
    res = {"files": len(rels), "src_bytes": src_bytes,
           "dst_bytes": dst_bytes, "secs": secs, "read_s": t_read,
           "signature_s": t_sig, "scan_s": t_scan, "apply_s": t_apply,
           "check_s": t_check, "scan_calls": scans.n,
           "groups": groups, "signatures": full,
           "sig_gibs": dst_bytes / t_sig / GIB,
           "scan_gibs": src_bytes / t_scan / GIB,
           "apply_gibs": src_bytes / t_apply / GIB,
           "literal_share": sum(lit.values()) / src_bytes,
           "stages_s": {k: round(v, 4) for k, v in totals.items()},
           "peak_bytes": peak, "busy_s": busy, "launches": launches,
           "rolling": rolling, "made": made}
    log(f"delta: {len(rels)} files, {src_bytes} source bytes in "
        f"{secs:.3f} s: reads {t_read:.3f} s, signatures {t_sig:.3f} s "
        f"({res['sig_gibs']:.4f} GiB/s of {dst_bytes} destination bytes), "
        f"delta scan {t_scan:.3f} s ({res['scan_gibs']:.4f} GiB/s, "
        f"{scans.n} calls of {per_call} files, {groups} groups with "
        f"candidates), apply {t_apply:.3f} s ({res['apply_gibs']:.4f} "
        f"GiB/s); literal share {res['literal_share']:.6f}; stages "
        f"(synchronised wall seconds) {json.dumps(res['stages_s'])}; "
        f"peak device memory "
        + (f"{peak} bytes" if peak is not None else "not measured")
        + "; card busy "
        + (f"{busy:.4f} s ({100 * busy / secs:.2f}% of the wall; "
           f"{trace['events']} device events, seconds by kind "
           f"{json.dumps(trace['by_kind'])})" if busy is not None
           else "not measured")
        + f"; launches {json.dumps({k: v for k, v in launches.items() if v})}"
          f" = {full} signatures + {groups} scan groups; checks "
          f"{t_check:.1f} s ({card})")
    return res


# -- mover: the rsync mover's entry points over the delta phase's trees -----

#: Thread that runs the mover phase's destination listener.
DEST_THREAD = "rsync-destination"
#: Bytes of the cold push's subset of the source tree.
COLD_BYTES = 64 << 20


@contextlib.contextmanager
def wire_meter():
    """Within the block, the sealed channel's frames (each sealed
    payload and its 4-byte length, by the thread that sent it: the
    listener's ``DEST_THREAD`` or the source) and the host seconds spent
    in the frames' compress, decompress, seal and open, summed over both
    sides. Yields {"frames", "bytes", "seconds"}."""
    from volsync_tpu_torch.repo.compress import Compressor, Decompressor
    from volsync_tpu_torch.repo.crypto import SecretBox

    out = {"frames": defaultdict(int), "bytes": defaultdict(int),
           "seconds": defaultdict(float)}
    lock = threading.Lock()

    def timed(name: str):
        def make(fn):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                res = fn(*args, **kwargs)
                dt = time.perf_counter() - t0
                with lock:
                    out["seconds"][name] += dt
                    if name == "seal":
                        side = ("destination" if threading.current_thread()
                                .name == DEST_THREAD else "source")
                        out["frames"][side] += 1
                        out["bytes"][side] += len(res) + 4
                return res
            return wrapper
        return make

    with patched(SecretBox, {"seal": timed("seal"), "open": timed("open")}), \
            patched(Compressor, {"compress": timed("compress")}), \
            patched(Decompressor, {"decompress": timed("decompress")}):
        yield out


def mover_push(torch, label: str, src: Path, dst: Path, keys: dict,
               refused: bool = False) -> dict:
    """One sync iteration through the rsync mover's entry points:
    ``serve_destination`` on ``dst`` (127.0.0.1, in the thread
    ``DEST_THREAD``) and ``rsync_source_entrypoint`` on ``src`` with a
    ``JobContext`` (ADDRESS, PORT from ``on_port``, FAST_RETRY). With
    ``refused``, first two handshakes the listener must refuse: a device
    it does not know, and the source pinning a wrong destination ID.
    The launch counts are set to 0 just before the push and read just
    after; the push is traced (``device_trace``) and metered
    (``wire_meter``), and records the planner's decisions (file, size,
    block length, protocol, reason) and, at the destination, each
    applied file's literal bytes and, where it has no literal, its ops,
    and the samples the planner's book took (``observe_rtt`` seconds,
    ``observe_link`` bytes and seconds) with the book's latency,
    bandwidth and change rate at each decision. The book starts cold, as
    in a new mover Job. Both sides must end with rc 0."""
    from volsync_tpu_torch.cluster.runner import JobContext
    from volsync_tpu_torch.engine import deltasync as ds
    from volsync_tpu_torch.engine import syncstats
    from volsync_tpu_torch.movers import common
    from volsync_tpu_torch.movers import devicetransport as dt
    from volsync_tpu_torch.movers.rsync import channel, entry
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts

    bound, got = threading.Event(), {}

    def on_port(port):
        got["port"] = port
        bound.set()

    def serve():
        got["rc"] = entry.serve_destination(
            dst, keys["dst"], dt.device_id_from_private(keys["src"]),
            bind="127.0.0.1", on_port=on_port, device=DEVICE)

    rels, decisions, applied, verifies = [], [], {}, []
    samples, priced = {"rtt": [], "link": []}, []

    def record_jobs(fn):
        def wrapper(ch, jobs, stats, device):
            rels.extend(rel for _, rel, _ in jobs)
            return fn(ch, jobs, stats, device)
        return wrapper

    def record_plan(fn):
        def wrapper(mover, size, **kw):
            d = fn(mover, size, **kw)
            decisions.append((size, kw["block_len"], d.protocol, d.reason))
            b = syncstats.book_for(mover).snapshot()
            priced.append((d.protocol, b.latency_s, b.bandwidth_bps,
                           b.change_rate))
            return d
        return wrapper

    def record_sample(kind):
        def make(fn):
            def wrapper(book, *args):
                if all(a > 0 for a in args):  # what the book keeps
                    samples[kind].append(args)
                return fn(book, *args)
            return wrapper
        return make

    def record_applies(fn):
        def wrapper(root, *, device=None):
            verbs = fn(root, device=device)
            apply = verbs["apply"]

            def recorded(msg):
                lit = sum(len(op[1]) for op in msg["ops"] if op[0] == "data")
                applied[msg["path"]] = (lit, None if lit else [
                    tuple(op) for op in msg["ops"]], msg["block_len"])
                return apply(msg)
            verbs["apply"] = recorded
            return verbs
        return wrapper

    with patched(entry, {"_dest_verbs": record_applies,
                         "_push_files_batch": record_jobs}), \
            patched(common, {"plan_protocol": record_plan}), \
            patched(syncstats.SyncStatsBook, {
                "observe_rtt": record_sample("rtt"),
                "observe_link": record_sample("link")}), \
            patched(ds, {"verify_candidates_batch": rows_of(verifies)}):
        syncstats.reset_books()
        t = threading.Thread(target=serve, name=DEST_THREAD, daemon=True)
        t.start()
        if not bound.wait(60):
            raise AssertionError(f"{label}: the listener never bound")
        dst_id = dt.device_id_from_private(keys["dst"])
        if refused:
            for priv, pinned, why in (
                    (keys["stranger"], dst_id, "an unknown device"),
                    (keys["src"], "00" * 32, "a wrong pinned ID")):
                try:
                    dt.connect_device("127.0.0.1", got["port"], priv,
                                      pinned, timeout=10.0)
                except channel.ChannelError as e:
                    log(f"{label}: the handshake of {why} was refused "
                        f"({e})")
                else:
                    raise AssertionError(f"{label}: the handshake of {why} "
                                         f"was accepted")
        ctx = JobContext(
            name="rsync-src", namespace="chip-smoke",
            env={"ADDRESS": "127.0.0.1", "PORT": str(got["port"]),
                 "FAST_RETRY": "1"},
            mounts={"data": src},
            secrets={"keys": {"source": keys["src"],
                              "destination-id": dst_id.encode()}},
            stop_event=threading.Event(), device=DEVICE)
        for k in KERNELS:
            k.launches = 0
        with device_trace(torch) as traced, wire_meter() as wire:
            sync(torch)
            t0 = time.perf_counter()
            rc = entry.rsync_source_entrypoint(ctx)
            t.join(600)
            sync(torch)
            secs = time.perf_counter() - t0
        launches = launch_counts()
    if rc != 0 or got.get("rc") != 0:
        raise AssertionError(f"{label}: source rc {rc}, destination rc "
                             f"{got.get('rc')}")
    if len(rels) != len(decisions):
        raise AssertionError(f"{label}: {len(decisions)} planner decisions "
                             f"for {len(rels)} files")
    return {"secs": secs, "launches": launches, "busy_s": traced["busy_s"],
            "trace": traced, "wire": wire, "applied": applied,
            "plans": dict(zip(rels, decisions)), "samples": samples,
            "priced": priced, "groups": sum(1 for n in verifies if n)}


def check_synced(label: str, src: Path, dst: Path, want: dict) -> None:
    """``dst`` holds exactly ``want``'s files ({rel: bytes}) and the same
    directories as ``src``, each path with ``src``'s mode and mtime, the
    root's too."""
    paths = {str(p.relative_to(dst)) for p in dst.rglob("*")}
    files = {p for p in paths if (dst / p).is_file()}
    if files != set(want) or paths != {str(p.relative_to(src))
                                       for p in src.rglob("*")}:
        raise AssertionError(f"{label}: paths differ, e.g. "
                             f"{sorted(files ^ set(want))[:5]}")
    for rel, data in want.items():
        if (dst / rel).read_bytes() != data:
            raise AssertionError(f"{label}: {rel} differs from its source")
    for rel in sorted(paths) + ["."]:
        a, b = (src / rel).lstat(), (dst / rel).lstat()
        if (a.st_mode, a.st_mtime_ns) != (b.st_mode, b.st_mtime_ns):
            raise AssertionError(f"{label}: {rel} has mode/mtime "
                                 f"{(b.st_mode, b.st_mtime_ns)}, its source "
                                 f"{(a.st_mode, a.st_mtime_ns)}")


def book_summary(r: dict) -> dict:
    """The planner book's samples in a push (``mover_push``): round trips
    (count, median, 90th percentile and largest, ms), bulk transfers
    (count and median MB/s), and the book's latency (ms), bandwidth
    (MB/s) and change rate at the decisions that chose each protocol
    (median)."""
    rtt = np.array([a[0] for a in r["samples"]["rtt"]]) * 1e3
    link = np.array([n / t for n, t in r["samples"]["link"]]) / 1e6
    out = {"rtt_n": len(rtt), "link_n": len(link)}
    if len(rtt):
        out.update(rtt_ms_median=float(np.median(rtt)),
                   rtt_ms_p90=float(np.percentile(rtt, 90)),
                   rtt_ms_max=float(rtt.max()))
    if len(link):
        out["link_mbs_median"] = float(np.median(link))
    for proto in sorted({p[0] for p in r["priced"]}):
        at = np.array([p[1:] for p in r["priced"] if p[0] == proto])
        out[f"{proto}_at_latency_ms"] = float(np.median(at[:, 0]) * 1e3)
        out[f"{proto}_at_bandwidth_mbs"] = float(np.median(at[:, 1]) / 1e6)
        out[f"{proto}_at_change_rate"] = float(np.median(at[:, 2]))
    return out


def check_push(label: str, r: dict, made: dict, card: str) -> dict:
    """A push over ``made``'s trees (``mover_push``) held to its plan:
    every file that the planner sent by delta within its edit's literal
    bounds and every one it sent whole all literal, and ``md5_slices``
    launched exactly once for each delta-planned file with a full block
    at the destination plus once a scan group with candidates, no other
    kernel. Logs the push wall and GiB/s, the bytes on the wire and the
    literal share, the planner's split and the book's samples, the
    card's busy share and the host seconds in the frames' zlib and
    seal."""
    src_bytes = sum(len(m[2]) for m in made.values())
    sig_files, bad = 0, []
    split = defaultdict(lambda: [0, 0])
    reasons = defaultdict(int)
    for rel, (size, bl, proto, reason) in r["plans"].items():
        kind, edit, src, dst = made[rel]
        split[proto][0] += 1
        split[proto][1] += size
        reasons[f"{proto}/{reason}"] += 1
        lit, ops, sent_bl = r["applied"][rel]
        if proto == "delta" and dst is not None:
            sig_files += len(dst) // bl > 0
            ok = literal_within(kind, edit, len(src), lit, ops, sent_bl)
        else:
            ok = lit == len(src)
        if not ok:
            bad.append((rel, kind, proto, lit))
    if bad:
        raise AssertionError(f"{label}: literal bytes out of bounds: "
                             f"{bad[:5]}")
    want_launches = {k: 0 for k in r["launches"]}
    want_launches["md5_slices"] = sig_files + r["groups"]
    if DEVICE == "cuda" and r["launches"] != want_launches:
        raise AssertionError(f"{label}: launches {r['launches']}, expected "
                             f"{want_launches} ({sig_files} signatures + "
                             f"{r['groups']} scan groups)")
    lit = sum(a[0] for a in r["applied"].values())
    wire, busy = r["wire"], r["busy_s"]
    on_wire = sum(wire["bytes"].values())
    codec = {k: round(v, 4) for k, v in wire["seconds"].items()}
    res = {"files": len(made), "src_bytes": src_bytes, "secs": r["secs"],
           "gibs": src_bytes / GIB / r["secs"], "literal_bytes": lit,
           "literal_share": lit / src_bytes, "wire_bytes": dict(wire["bytes"]),
           "frames": dict(wire["frames"]), "codec_s": codec,
           "split": {k: tuple(v) for k, v in split.items()},
           "reasons": dict(reasons), "book": book_summary(r), "busy_s": busy,
           "launches": r["launches"], "signatures": sig_files,
           "groups": r["groups"]}
    log(f"{label}: {len(made)} files, {src_bytes} source bytes pushed in "
        f"{r['secs']:.3f} s ({res['gibs']:.4f} GiB/s) through "
        f"rsync_source_entrypoint -> serve_destination; {on_wire} bytes on "
        f"the wire ({json.dumps(res['wire_bytes'])} in "
        f"{json.dumps(res['frames'])} sealed frames), literal "
        f"{lit} bytes (share {res['literal_share']:.6f}); planner "
        f"(files, bytes) {json.dumps(res['split'])}, reasons "
        f"{json.dumps(res['reasons'])}; the book's samples "
        f"{json.dumps(res['book'])}; host seconds in the frames "
        f"{json.dumps(codec)} ({100 * sum(codec.values()) / r['secs']:.2f}%"
        f" of the wall, both sides); card busy "
        + (f"{busy:.4f} s ({100 * busy / r['secs']:.2f}% of the wall; "
           f"seconds by kind {json.dumps(r['trace']['by_kind'])})"
           if busy is not None else "not measured")
        + f"; launches {json.dumps({k: v for k, v in r['launches'].items() if v})}"
          f" = {sig_files} signatures + {r['groups']} scan groups ({card})")
    return res


def mover_phase(torch, base: Path, made: dict, seed: int, card: str) -> dict:
    """The rsync mover's entry points on the port over the delta phase's
    seeded trees (BASELINE.json configs[0]; ``base/src`` pushed into
    ``base/dst``, written once, by ``make_delta_trees``). First a push
    with the planner pinned to delta (``VOLSYNC_SYNC_PROTO=delta``) into
    ``base/dst-delta``, hard links of ``base/dst``'s files (the
    destination replaces a file with more than one name, so ``base/dst``
    keeps its bytes), removed after; then one sync iteration as a Job
    runs it, the planner choosing, into ``base/dst``. Each is held by
    ``check_synced`` (bytes, paths, modes, mtimes) and ``check_push``
    (literal bounds and exact ``md5_slices`` launches from its own
    plan). Then two refused handshakes and a cold push of a
    ``COLD_BYTES`` subset (hard links of the 4 MiB files) into an empty
    directory: all literal, no kernel launched."""
    from volsync_tpu_torch.repo import compress, crypto

    rng = np.random.default_rng(seed)
    keys = {"src": rng.bytes(64), "dst": rng.bytes(64),
            "stranger": rng.bytes(64)}
    want = {rel: m[2] for rel, m in made.items()}
    log(f"mover: frames {'zstd' if compress.HAVE_ZSTD else 'zlib'} and "
        f"{'AES-256-CTR' if crypto.HAVE_AES else 'SHAKE-256'} + "
        f"HMAC-SHA256 (what this host has installed)")
    pinned = base / "dst-delta"
    for p in sorted((base / "dst").rglob("*")):
        q = pinned / p.relative_to(base / "dst")
        q.parent.mkdir(parents=True, exist_ok=True)
        if p.is_file():
            os.link(p, q)
    with env_set("VOLSYNC_SYNC_PROTO", "delta"):
        rd = mover_push(torch, "mover (delta pinned)", base / "src", pinned,
                        keys)
    check_synced("mover (delta pinned)", base / "src", pinned, want)
    shutil.rmtree(pinned)
    if {p[2] for p in rd["plans"].values()} != {"delta"}:
        raise AssertionError("mover (delta pinned): the planner chose "
                             "another protocol")
    delta = check_push("mover (delta pinned)", rd, made, card)
    r = mover_push(torch, "mover", base / "src", base / "dst", keys)
    check_synced("mover", base / "src", base / "dst", want)
    res = check_push("mover", r, made, card)
    res["delta_pinned"] = delta

    cold_src, cold_dst = base / "cold-src", base / "cold-dst"
    subset, total = {}, 0
    for rel in sorted(made):
        n = len(made[rel][2])
        if rel.startswith("mid/") and total + n <= COLD_BYTES:
            (cold_src / rel).parent.mkdir(parents=True, exist_ok=True)
            os.link(base / "src" / rel, cold_src / rel)
            subset[rel] = made[rel][2]
            total += n
    cold_dst.mkdir()
    c = mover_push(torch, "mover cold push", cold_src, cold_dst, keys,
                   refused=True)
    check_synced("mover cold push", cold_src, cold_dst, subset)
    c_lit = sum(a[0] for a in c["applied"].values())
    if c_lit != total or (DEVICE == "cuda" and any(c["launches"].values())):
        raise AssertionError(f"mover cold push: {c_lit} literal bytes of "
                             f"{total}, launches {c['launches']}")
    c_codec = {k: round(v, 4) for k, v in c["wire"]["seconds"].items()}
    res["cold"] = {"files": len(subset), "bytes": total, "secs": c["secs"],
                   "gibs": total / GIB / c["secs"],
                   "wire_bytes": dict(c["wire"]["bytes"]),
                   "codec_s": c_codec, "launches": c["launches"]}
    log(f"mover cold push: {len(subset)} files, {total} bytes into an "
        f"empty directory in {c['secs']:.3f} s "
        f"({res['cold']['gibs']:.4f} GiB/s), all literal, "
        f"{sum(c['wire']['bytes'].values())} bytes on the wire, host "
        f"seconds in the frames {json.dumps(c_codec)}, no kernel launched "
        f"({card})")
    return res


# -- restic entry: the restic mover's entry point on a seeded tree ----------

#: The restic entry phase's hole (its sparse file's gap).
RESTIC_HOLE = 4 << 20


def restic_entry_phase(torch, base: Path, total: int, seed: int,
                       card: str) -> dict:
    """The restic mover's entry point on the port (ref
    movers/restic/entry.py) over a seeded tree of about ``total`` bytes
    (``make_backup_tree``) in an encrypted ``FsObjectStore`` repository,
    with ``VOLSYNC_TRACE_DIR`` set: ``restic_entrypoint`` backs up, the
    tree is edited (``total`` / 256 bytes overwritten in ``big.bin``, a
    small file grown, one deleted, a new file of ``total`` / 64 bytes),
    backs up again with FORGET_LAST=1 and
    PRUNE=1, and restores into an empty directory. Each run has the
    launch counts set to 0 before and read after (the fused kernels once
    a backup pass, the verify kernels once a verify pass), rc 0; one
    snapshot is left; the restore equals the edited tree (``check_
    restored``) and leaves the hole unwritten; each backup wrote its
    trace, and the restore is traced by the same ``obs.device_trace``
    (``restic-restore``): the card's busy seconds are read from these
    three files, where they hold device events."""
    from volsync_tpu_torch import obs
    from volsync_tpu_torch.cluster.runner import JobContext
    from volsync_tpu_torch.engine import chunker
    from volsync_tpu_torch.movers.restic import entry
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.repo.repository import DEFAULT_CHUNKER, Repository

    rng = np.random.default_rng(seed)
    src = base / "restic-src"
    t0 = time.perf_counter()
    made = make_backup_tree(torch, src, total, seed,
                            DEFAULT_CHUNKER["min_size"], RESTIC_HOLE)
    log(f"restic entry: tree of {made['bytes']} bytes made in "
        f"{time.perf_counter() - t0:.1f} s")
    traces = base / "restic-traces" / "restic-backup"
    env = {"RESTIC_REPOSITORY": f"file://{base / 'restic-repo'}",
           "RESTIC_PASSWORD": EC_PASSWORD, "HOSTNAME": "chip-smoke"}

    def run_entry(label, extra, data, backup: bool):
        """A backup (hasher passes counted; it traces the card itself,
        ``restic-backup``) or a restore (verify passes; traced here by
        ``obs.device_trace("restic-restore")``) through the entry."""
        passes = PassCounter()
        ctx = JobContext(name="restic", namespace="chip-smoke",
                         env={**env, **extra}, mounts={"data": data},
                         secrets={}, stop_event=threading.Event(),
                         device=DEVICE)

        def run():
            with patched(chunker.DeviceChunkHasher,
                         {"begin_device": passes.wrap}), \
                    (contextlib.nullcontext() if backup
                     else obs.device_trace("restic-restore")):
                return entry.restic_entrypoint(ctx)

        if backup:
            r = product_run(torch, label, run, FUSED_PER_PASS, passes,
                            verify_per_pass=VERIFY_PER_PASS, trace=False)
        else:
            r = product_run(torch, label, run, VERIFY_PER_PASS, None,
                            trace=False)
        if r["out"] != 0:
            raise AssertionError(f"{label}: rc {r['out']}")
        return r

    res = {}
    with env_set("VOLSYNC_TRACE_DIR", str(traces.parent)):
        res["backup"] = run_entry("restic entry backup", {}, src, True)
        res["backup"]["bytes"] = made["bytes"]
        with open(src / "big.bin", "r+b") as f:
            f.seek(os.path.getsize(src / "big.bin") // 3)
            f.write(rng.bytes(total // 256))
        smalls = sorted((src / "small").rglob("*.bin"))
        with open(smalls[0], "ab") as f:
            f.write(rng.bytes(5000))
        smalls[1].unlink()
        (src / "new.bin").write_bytes(rng.bytes(total // 64))
        state = tree_state(src)
        res["backup2"] = run_entry(
            "restic entry backup (FORGET_LAST=1, PRUNE=1)",
            {"FORGET_LAST": "1", "PRUNE": "1"}, src, True)
        # distinct regular files (a hard link once), as made["bytes"]
        res["backup2"]["bytes"] = sum({v[5]: v[3] for v in state.values()
                                       if v[0] == "file"}.values())
        snaps = Repository.open(FsObjectStore(base / "restic-repo"),
                                EC_PASSWORD, device=DEVICE).list_snapshots()
        if len(snaps) != 1:
            raise AssertionError(f"restic entry: {len(snaps)} snapshots "
                                 f"left")
        dst = base / "restic-dst"
        dst.mkdir()
        with sparse_writes() as written:
            res["restore"] = run_entry("restic entry restore",
                                       {"DIRECTION": "restore"}, dst, False)
    files = [sorted(d.glob("*.pt.trace.json")) if d.is_dir() else []
             for d in (traces, traces.parent / "restic-restore")]
    if [len(f) for f in files] != [2, 1]:
        raise AssertionError(f"restic entry: trace files {files}, expected "
                             f"one a backup and one of the restore")
    files = files[0] + files[1]
    # A trace may hold no device event: late in a long process the
    # profiler drops or misplaces the card's events (PERF.md, section 7),
    # so the busy share is then not measured; the exact launches above
    # still show that each run went through the kernels.
    for run, path in zip(("backup", "backup2", "restore"), files):
        traced = chrome_trace_busy(path)
        res[run].update(busy_s=traced["busy_s"], trace=traced,
                        trace_file=path.name)
    check_restored("restic entry restore", state, dst, RESTIC_HOLE)
    check_hole_unwritten("restic entry restore", written, made)
    res["restore"]["bytes"] = res["backup2"]["bytes"]
    for run in ("backup", "backup2", "restore"):
        r = res[run]
        r["gibs"] = r["bytes"] / GIB / r["secs"]
    log(f"restic entry: backup {res['backup']['gibs']:.4f} GiB/s, second "
        f"backup with forget and prune {res['backup2']['gibs']:.4f} GiB/s, "
        f"restore {res['restore']['gibs']:.4f} GiB/s; card busy "
        + ", ".join(f"{run} " + (f"{100 * res[run]['busy_s'] / res[run]['secs']:.2f}%"
                                 if res[run]["busy_s"] is not None
                                 else "not measured")
                    for run in ("backup", "backup2", "restore"))
        + f"; 1 snapshot left, restore byte-identical, traces "
          f"{[p.name for p in files]} ({card})")
    return res


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
    # The backup phase's volumes: the mover's 10 GiB PVC (BASELINE.json
    # configs[1]); the align-64 tree is cut, since it differs from it
    # only by the engine.
    ap.add_argument("--backup-gib", type=float, default=10.0)
    ap.add_argument("--backup64-mib", type=float, default=256.0)
    # The erasure-coded round trip's volume: cut from the 10 GiB PVC to
    # keep the whole script inside its time limit (PERF.md, section 4).
    ap.add_argument("--ec-gib", type=float, default=2.0)
    # The delta phase's volume: BASELINE.json configs[0], a 1 GiB PVC
    # replicated by rsync, not cut. The mover phase syncs the same trees.
    ap.add_argument("--delta-gib", type=float, default=1.0)
    # The restic entry phase's tree: cut from the 10 GiB PVC, which the
    # backup phase already runs through the same engine.
    ap.add_argument("--restic-mib", type=float, default=256.0)
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
        least = (f"{MD5_BLOCK_ALU_OPS} as the source writes it (128 "
                 f"LOP3/SHF and 196 adds)" if name.startswith("md5") else
                 f"least work {SHA_BLOCK_ALU_OPS} LOP3/SHF and 360 adds, "
                 f"{SHA_ROUNDS_ALU_OPS} LOP3/SHF in the rounds alone")
        log(f"{name} one message block as compiled (cuobjdump -sass, "
            f"instructions by class): "
            + (json.dumps(counts) if counts else "not available")
            + f"; {least}"
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
    md5_lat = md5_round_cycles(torch, args.seed)
    log(f"probe (csrc/probe.cu, one-thread MD5 chain of "
        f"{PROBE_MD5_BLOCKS} blocks): one dependent round "
        f"{md5_lat['cycles']:.2f} SM cycles ({md5_lat['ns']:.3f} ns) "
        f"({card})")
    md5_kernel_entries(torch, stats, args.seed, sass, md5_lat["cycles"])
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

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    backup_bytes = int(args.backup_gib * GIB)
    backup64_bytes = int(args.backup64_mib * (1 << 20))
    # each tree, its repository and one restore at a time
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_backup.", dir=backup_base(
        build, 3 * (backup_bytes + backup64_bytes))))
    t1 = time.perf_counter()
    try:
        product = backup_phase(torch, base, backup_bytes, backup64_bytes,
                               args.seed, card)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    fused = product["fused"]
    busy = fused["backup"]["busy_s"]
    log(f"backup phase: {time.perf_counter() - t1:.1f} s in all; backup "
        f"{fused['backup_gibs']:.4f} GiB/s (card busy "
        + (f"{100 * busy / fused['backup']['secs']:.2f}%" if busy is not None
           else "not measured")
        + f"), pipelined restore {fused['restore_gibs']:.4f} GiB/s, "
        f"serial restore {fused['serial_gibs']:.4f} GiB/s "
        f"(encrypted, align 4096); align 64: backup "
        f"{product['split']['backup_gibs']:.4f}, restore "
        f"{product['split']['restore_gibs']:.4f} GiB/s; every restore left "
        f"the hole unwritten, and its allocation was "
        + ("checked" if fused["hole_kept"] and product["split"]["hole_kept"]
           else "NOT checked (no filesystem here keeps holes)")
        + f" ({card})")
    runs = {f"{engine}.{run}": product[engine][run]["launches"]
            for engine in ("fused", "split")
            for run in ("backup", "check", "restore", "serial")}

    gf = gf_matmul_entry(torch, args.seed, card)
    ec_bytes = int(args.ec_gib * GIB)
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_ec.", dir=backup_base(
        build, 4 * ec_bytes)))
    t1 = time.perf_counter()
    try:
        ec = durability_phase(torch, base, ec_bytes, args.seed + 2, card)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    busy = {k: ec[k]["busy_s"] / ec[k]["secs"]
            for k in ("backup", "check", "restore", "scrub")
            if ec[k]["busy_s"] is not None}
    gf["calls"] = {k: ec[k]["gf_calls"] for k in
                   ("backup", "check", "restore", "serial", "scrub",
                    "backup2")}
    gf["calls"]["repack"] = sum(c["gf_calls"] for c in
                                ec["repack"]["cycles"])
    log(f"durability phase: {time.perf_counter() - t1:.1f} s in all; ec "
        f"backup {ec['backup']['gibs']:.4f} GiB/s at "
        f"{ec['overhead']:.4f}x stored, pipelined restore "
        f"{ec['restore']['gibs']:.4f}, serial restore "
        f"{ec['serial']['gibs']:.4f}, whole scrub "
        f"{ec['scrub']['gibs']:.4f}, repack {ec['repack']['gibs']:.4f} "
        f"GiB/s; card busy share "
        f"{json.dumps({k: round(v, 4) for k, v in busy.items()})}; "
        f"gf_matmul {json.dumps(gf)} ({card})")
    for run in ("backup", "check", "restore", "serial", "scrub",
                "scrub_clean", "backup2", "check2", "restore2"):
        runs[f"ec.{run}"] = ec[run]["launches"]
    for i, c in enumerate(ec["repack"]["cycles"]):
        runs[f"ec.repack{i + 1}"] = c["launches"]

    base = Path(tempfile.mkdtemp(prefix="chip_smoke_delta.", dir=backup_base(
        build, int(3.3 * args.delta_gib * GIB))))
    try:
        delta = delta_phase(torch, base, delta_layout(args.delta_gib),
                            args.seed + 3, card)
        t1 = time.perf_counter()
        mover = mover_phase(torch, base, delta.pop("made"), args.seed + 4,
                            card)
        log(f"mover phase: {time.perf_counter() - t1:.1f} s in all ({card})")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    restic_bytes = int(args.restic_mib * (1 << 20))
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_restic.", dir=backup_base(
        build, 4 * restic_bytes)))
    t1 = time.perf_counter()
    try:
        restic = restic_entry_phase(torch, base, restic_bytes, args.seed + 5,
                                    card)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"restic entry phase: {time.perf_counter() - t1:.1f} s in all "
        f"({card})")

    # Launches: from the stream phase of the path that runs each kernel.
    launches = {**res["launches"],
                "sha256_rows": split["launches"]["sha256_rows"],
                "pagemajor_u32": pm["launches"]["pagemajor_u32"],
                "sha256_pages_sweep": res["launches"]["sha256_pages"],
                "sha256_pages_pagemajor": pm["launches"]["sha256_pages"],
                "sha256_slices": legacy["launches"]["sha256_slices"],
                "sha256_slices_tail": res["launches"]["sha256_slices"],
                "md5_slices": delta["launches"]["md5_slices"],
                "md5_slices_lanes": 0}
    runs["delta"] = delta["launches"]
    runs["mover.delta"] = mover["delta_pinned"]["launches"]
    runs["mover"] = mover["launches"]
    runs["mover.cold"] = mover["cold"]["launches"]
    for run in ("backup", "backup2", "restore"):
        runs[f"restic.{run}"] = restic[run]["launches"]
    kernels = []
    for name in ("transpose_u32", "sha256_pages", "sha256_pages_pagemajor",
                 "sha256_lanes", "sha256_slices", "sha256_slices_tail",
                 "fastcdc_walk", "sha256_rows", "pagemajor_u32",
                 "sha256_pages_sweep", "merkle_roots", "md5_slices",
                 "md5_slices_lanes"):
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
        for extra in ("bound_kind", "threads_ms", "shapes", "one_window_ms",
                      "split", "round_chain"):
            if extra in st:
                entry[extra] = st[extra]
        if name in runs["fused.backup"]:
            entry["product_launches"] = {r: c[name] for r, c in runs.items()}
        kernels.append(entry)
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s from the build on")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
