#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (volsync_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--stream-gib G] [--align64-gib G]
                          [--align1-mib M] [--pagemajor-gib G]
                          [--backup-gib G] [--backup64-mib M]
                          [--ec-gib G] [--delta-gib G] [--restic-mib M]
                          [--rclone-files N] [--service-tenants SPEC]
                          [--service-mib M] [--turns-gib G]
                          [--fleet-mib M] [--syncthing-mib M]
                          [--mesh-gib G] [--operator-crs N]
                          [--operator-mib M] [--operator-rounds R]
                          [--trace-out FILE]

Run from the repository root on a machine with a CUDA card and nvcc. It
imports nothing of JAX or of the JAX package, and every phase raises on
a mismatch:

1. build: compiles every CUDA source of the port (one nvcc per source,
   started together) and prints nvcc's register report, the
   instructions of one message block of K1 (both instances), K2,
   sha256_slices (its three forms' loops), merkle_roots and sha256_lanes as
   compiled (``cuobjdump -sass``), the card's name and power limit, and
   the torch and CUDA versions; builds the native host library
   (``io/native.py``: ``native/volio.cpp`` with g++, its build time
   logged) and fails where it is not available, so no run measures
   the Python routes by accident;
2. kernels: runs one real 48 MiB segment through ``chunk_hash_segment``
   while recording each kernel wrapper's inputs, then holds every
   kernel of that pass (K1 sha256_pages, fastcdc_walk, the tail form of
   sha256_slices, merkle_roots) against its plain PyTorch twin on those
   inputs with ``torch.equal`` (K1 also against hashlib per page) and
   times kernel and twin; logs merkle_roots' chain bound (its longest
   lane in blocks x the least time of a block, from the compiled
   block's instruction issue), its issue and dependency bounds and the
   heaviest SM sub-partition's load from its instrumented instance
   (``tools/time_root_calls.py``), and the walk's (its longest lane's
   chunks x one dependent load, measured by a pointer chase,
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
   instrumented instance of the kernel, off the launch counts); then
   ``merkle_roots`` at its other callers' shapes (the span form, 32
   lanes of 32 MiB: more live lanes than the card has sub-partitions,
   the mesh's page-major table, no live lane, and nb_max below a lane's
   blocks), each against its twin, timed, bounded and split;
3. stream: sets every launch count to 0, streams a seeded ``--stream-gib``
   GiB + 12,345-byte volume (half of its 64 MiB blocks repeat earlier
   ones; one block is all zero) through ``stream_chunk_batches`` with
   ``DeviceChunkHasher(DEFAULT_PARAMS)`` in 32 MiB segments, reads the
   counts, and holds the cut list and every blob id against a host
   oracle (numpy gear candidates, the host FastCDC walk, hashlib blob
   ids); prints GiB/s and the dedup ratio. A second pass with each
   stage's functions bracketed by CUDA events gives per-stage device
   time, and a third plain pass the GiB/s spread; both must give the
   first pass's chunks. Then the stream's first ``--turns-gib`` GiB +
   12,345 B alone through the engine's own pipeline and through the
   default hasher (on CUDA the shared micro-batcher, one lane a pass),
   in turns off, on, off, on, each turn giving the whole stream's chunks
   that end inside it and the one it cuts short;
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
   ``obs.span``. The align-64 and align-1 streams walk their segments
   in C (the native library); each runs again through the Python walk
   and the C walk in turns (Python, C, Python), every turn with the
   first pass's cuts and ids, the walk's host seconds logged by route;
6. service: the mover-jax gRPC service (BASELINE.json configs[4], 100
   concurrent sources; ``tools/service_bench.run_closed_loop``): the
   port's ``MoverJaxServer`` on 127.0.0.1 (``DEFAULT_PARAMS``, 32 MiB
   segments, pipeline depth 2, admission at its defaults, gRPC workers
   = clients + 4) answers ``--service-tenants`` closed-loop ChunkHash
   sources (``gold:4:25;silver:2:25;bronze:1:50``) of ``--service-mib``
   MiB each (16) less 12,345 bytes (so every eof segment ends mid-page),
   salted from one seeded base and made piece by piece as they are sent; shed sources honour the retry-after hint. A warm
   round and the timed round with a 2 ms batch window, then the same
   load per request (window 0), each with the launch counts set to 0
   just before and read just after, the fused passes counted and the
   card traced: the fused kernels once a pass, no mid-stream abort,
   fewer batched passes than segments. Every stream equals the
   unbatched ``DeviceChunkHasher`` on the card over its bytes (stream 0
   also hashlib's ids), the per-request lists the batched ones; ``Info``
   reports the device; HashSpans over a 64 MiB buffer equals
   ``hash_spans``; a forced-open breaker sheds at admission in under
   10 ms; 8 streams of 80 MiB less 12,345 bytes under
   ``VOLSYNC_TPU_LOCKCHECK=1``, each crossing the 40 MiB segment cut,
   equal the unbatched hasher and record no violation. Logs GiB/s, p50/p99, admitted and shed counts by
   tenant, lanes a pass, spans, the card's busy share, peak device
   memory and peak host RSS. Then the fused kernels at the batched
   pass's shape (the pass shape that hashed the most of the timed
   round's segments, and 8 lanes of it), on the service's own lanes
   (each a whole source, eof, with a tail leaf): each held against its
   twin (max abs err 0), timed and bounded;
7. backup: the restic mover's product path. A seeded tree of about
   ``--backup-gib`` GiB on local disk (in the process's temporary
   directory where its filesystem keeps holes and has room, else under
   ``build/``; removed after) from the stream's block pattern: a file of half the volume, one
   ending in a 12,345-byte odd tail and its hard link, a sparse file
   with a 32 MiB hole, an empty file and 300 files below min_size.
   First the native reader: the first GiB of its big file through
   ``ReadaheadReader`` and ``open()`` in turns, equal SHA-256, both
   rates. ``TreeBackup`` (its files opened through the native reader,
   counted) into an encrypted ``FsObjectStore`` repository at the
   repository default chunker (align 4096), a second backup (nothing
   new, the same root tree), ``check(read_data=True)``, a pipelined
   ``restore_snapshot`` and a serial ``TreeRestore`` with device verify
   (each byte-identical: SHA-256, mode and mtime of every path, hard
   links, the hole), and one flipped byte in a pack (IntegrityError
   before the affected file is written, with ``VOLSYNC_TRACE_DUMP``
   set); then the same for an
   unencrypted align-64 repository over ``--backup64-mib`` MiB (K2 in
   the product path; the device verify, not the MAC, catches its
   flipped byte, and the flight recorder's ``restore_verify_fail`` dump
   lands). Every run sets the launch counts to 0 before and
   reads them after: the fused or split-phase kernels once a backup
   pass, none on the second backup, and K1, ``sha256_slices`` and
   ``merkle_roots`` once a verify pass. Logs backup and restore GiB/s,
   each run's host seconds by span and the seconds the card was busy
   (a ``torch.profiler`` trace of its kernels, copies and memsets).
   On the card the fused engine's segments go through the shared
   micro-batcher (its default there): a run counts its batched passes
   and the segments they hashed, the fused kernels once a pass and
   passes no more than segments. Every restore must leave the hole
   unwritten (its writes into
   ``sparse.bin`` are recorded); where the filesystem keeps holes, the
   restored file must keep it as one too, and the log says whether it
   did;
8. durability: ``gf_matmul`` (the Reed-Solomon field product, plain
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
9. delta: the rsync mover's data plane (BASELINE.json configs[0], a
   1 GiB PVC replicated by rsync; ``--delta-gib``, 0.5: the counts
   below halve). Seeded destination
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
10. mover: the rsync mover's entry points over the delta phase's trees
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
11. restic entry: ``restic_entrypoint`` over a seeded ``--restic-mib``
   MiB tree in an encrypted ``FsObjectStore`` repository with
   ``VOLSYNC_TRACE_DIR`` set: a backup, edits, a second backup with
   FORGET_LAST=1 and PRUNE=1, a restore into an empty directory; rc 0
   each, exact launches each run (the fused kernels a backup pass, the
   verify kernels a verify pass), one snapshot left, the restore
   byte-identical with the hole unwritten, the backup again into fresh
   repositories in turns with ``VOLSYNC_BATCH_SEGMENTS=0`` twice and
   batched once (the same segments and root tree each), one trace a
   backup and one
   of the restore (``obs.device_trace``), whose device events, where
   the profiler kept them, give each run's busy share. The first backup
   runs under one root trace of the flight recorder
   (``VOLSYNC_TRACE_RING`` large enough for all of its spans):
   ``volsync trace dump --out`` through the port's CLI in process
   (``--trace-out`` keeps the file), loaded back, its spans of one
   trace, nested, on more than one thread, with ``engine.*``,
   ``repo.seal`` and ``ops.batch_dispatch`` among them; each thread's
   busy seconds over the backup's wall, and ``trace summary``;
12. rclone: ``rclone_entrypoint`` (BASELINE.json configs[2], many small
   files) through an S3 remote, the port's ``FakeS3Server`` on
   127.0.0.1 named by an ``rclone.conf`` section, TRANSFERS 10, over a
   seeded tree of ``--rclone-files`` small files (log-uniform 1 B to
   128 KiB, one in 20 a copy of another) in 128 directories, 64 empty
   files, 16 symlinks (two to directories), 4 empty directories, 32
   files of 4-16 MiB and one of 256 MiB + 12,345 B (streamed): up into
   the cold bucket, down into an empty directory, edits (1% of the
   small files rewritten, 1% deleted, 1% added in a new directory, two
   mid files appended, 1% chmodded), up again, down again. Each run
   traced, its rc 0, its stats equal to those predicted from the trees,
   its ``hash_spans`` flushes and streamed files and, on the card, its
   launches exact (K1, ``sha256_slices`` and ``merkle_roots`` once a
   flush, K1 once a streamed segment with a full page); every index
   digest equal to hashlib's blob id, the bucket's objects exactly the
   index's digests, no lock left, and the destination equal to the
   source after each down (bytes, modes, mtimes, symlink targets, empty
   directories, owners and xattrs where the filesystem keeps them).
   Logs each run's wall, GiB/s, files/s, busy share, host spans and the
   fake server's requests by verb;
13. fleet: BASELINE.json configs[4] (many ReplicationSources served by
   one fleet) in the shape of the fleet drill: 12 seeded jobs of
   ``--fleet-mib`` MiB less 12,345 B (the backup cell's layout without
   its hole, half of each shared across jobs) submitted from 6 threads
   to a ``ReplicaGroup`` of 3 replicas (each its own fenced writer over
   its own ``FaultStore`` stack on one encrypted ``FsObjectStore``
   repository at ``DEFAULT_CHUNKER``; servers at their defaults but 2
   streams a replica, so that sheds happen; a shed job waits out the
   hint) beside a ``ContinuousGC`` (0.5 s, grace 2 s) over a deleted
   snapshot's garbage. r00's store crashes on its second data put and
   r00 is killed. Then: every job completed, failovers counted; the
   stale locks taken over, a zombie writer fenced and its late backup
   refused; no pending-delete left and every live pack present; the
   distinct data bytes equal the trees' oracle; ``check(read_data=
   True)`` clean; one restore a replica that completed a job, the
   failed-over one's among them, byte-identical; the ``repair`` verb
   in process, ``--dry-run --json`` (exit 0, the dead stamp found and
   left) and then applying (exit 0, the stamp cleared, the GC pass run).
   No job attempt and no GC cycle reads a tree "not in index", and no
   GC cycle ends "error" (the outcomes are logged by kind). The round runs batched (the CUDA default) and with
   ``VOLSYNC_BATCH_SEGMENTS=0`` (the jobs, their failovers and the
   oracle only), each into a fresh repository, launches exact a pass;
   then ``python -m volsync_tpu_torch.cli scrub`` in a
   subprocess exits 0, ``repack`` exits 0 and, after a pack body rots,
   ``scrub`` exits 2 with one unhealable pack. Logs each round's wall,
   GiB/s, passes against segments, busy share, spans and GC outcomes;
14. syncthing: three daemons through ``syncthing_entrypoint`` on
   127.0.0.1 (A knows B and C; B and C know A as their introducer) over
   a seeded folder on A (``--syncthing-mib``: small files log-uniform 1
   B to 128 KiB, files of 4-16 MiB, one of 48 MiB + 12,345 B that
   streams, a symlink, an empty file, an empty directory). A's folder
   converges to B and C, an unknown device is refused, idle rescans
   hash and launch nothing, B's edits (rewrites, deletes, adds, a file
   turned into a directory) converge back, and after a restart a file
   written on A and on C goes to the larger (version, device id). After
   each run the folders are equal (bytes, modes, mtimes) and every
   digest is hashlib's blob id; launches exact from the files hashed
   (one ``hash_spans`` pass a file up to 32 MiB, K1 once a streamed
   segment with a full page). Logs the time to convergence, files and
   bytes hashed and pulled, the busy share and the host seconds;
15. mesh (``parallel/``; runs after phase 5, on its volumes): the fused
   stream's first ``--mesh-gib`` GiB + 12,345 B, the align-64 volume's
   first 256 MiB and the align-1 volume's first 32 MiB, each through the
   single-device engine and through ``MeshChunkHasher`` on a 4-shard
   mesh of the one card (the fused prefix also on the default mesh,
   every CUDA device: one shard) in 32 MiB segments, the counts set to
   0 before each: chunks and ids equal to the stream phase's, launches
   exact a pass (fused: ``sha256_pages`` once a shard, one
   ``fastcdc_walk``, one ``merkle_roots``, one tail ``sha256_slices`` a
   pass with a partial tail leaf; leaf and byte paths one
   ``sha256_slices`` a shard), GiB/s beside the single device's. Then
   ``make_chunk_hash_step`` on a (2, 2) mesh of the card over a seeded
   [4, 16 MiB] (one ``sha256_slices`` a shard): every 64 KiB block's
   digest equal to hashlib, the candidate mask to a numpy gear oracle,
   each row to ``chunk_hash_block`` on the card, the bloom and stats to
   the host's; ``sha256_fixed_blocks`` at [1024, 64 KiB] against its
   twin and hashlib, timed (graph replay and eager) and bounded by its
   per-warp floor; ``init_distributed()`` with nothing configured gives
   one process, and ``require=True`` raises. In phase 11, after the
   first backup, ``TreeBackup`` of the restic tree through a 4-shard
   mesh (launches exact) and the restic entry with
   ``VOLSYNC_ENGINE=mesh`` give its root tree;
16. operator: ``volsync-manager``'s stack, ``OperatorRuntime`` on the
   card (every mover registered, 16 runner and 8 manager workers as
   ``bench_scale.py``'s fleet scenario, the listener on an ephemeral
   port, its storage root under ``build/``, where a second runtime on
   the same root is refused by the storage lock). BASELINE.json
   configs[4]: ``--operator-crs`` restic ReplicationSources, each on its
   own volume of one seeded ``--operator-mib`` MiB file and its own
   repository, ``--operator-rounds`` manual rounds with a quarter of
   every file rewritten between them; every CR acks every round,
   launches exact (the fused kernels once a device pass), the card
   traced. Then a restic ReplicationDestination restores four of them
   (byte-identical, one file's blob ids equal to the host oracle's, the
   verify kernels once a verify pass); an rsync destination and source
   over a 16 MiB tree, synced twice (equal each time, ``md5_slices``
   launched by the second); two restic sources sharing one bucket of
   the port's fake S3 (two snapshots, a clean check, throughput gauges
   above 0) and an rclone source and destination over 16 MiB of small
   files through it (equal); a syncthing pair over an 8 MiB folder
   (converged). No Job attempt may fail (each failure is logged with
   the runner's traceback). Last, over HTTP: /healthz and /readyz 200,
   /debug/trace JSON, and /metrics with every fleet CR at 0 missed
   intervals, in sync, one sync duration a round and a throughput
   above 0. Logs each round's wall, MiB/s, the p50 and p99 of the CRs'
   ``last_sync_duration``, passes, launches and busy share;
17. session (last): ``TorchSessionBackend`` probes the card in a
   subprocess (seconds and the device it names); a ``SessionSupervisor``
   and ``BenchQueue`` run a child that hashes a seeded 64 MiB buffer
   with ``hash_spans`` on the card (blob id equal to hashlib's, its
   environment carrying ``VOLSYNC_SESSION_ID``, ``_EPOCH`` and
   ``_BACKEND=torch``); a job past a 2 s deadline is refused;
   ``force_release`` kills a marked sleeping child and spares an
   unmarked one; ``python -m volsync_tpu_torch.cli session status
   --probe`` exits 0. This process never carries the marker.

The line before the last is the kernels JSON (launches on the stream
phase that runs each kernel, ``md5_slices``' on the delta phase, the
``*_batched`` entries' on the service phase's timed batched round,
``sha256_slices_fixed``'s on the mesh phase's step, max
difference from the twin, times and bounds; ``product_launches``: each
kernel's launches in the backup, durability, delta, mover, restic
entry, rclone, service, fleet, syncthing, mesh and operator phases'
runs, on
the entries named as the
kernel is: a form's entry has none, since its launches count under its
kernel's name);
the last line is ``{"ok": true, "device":
{...}}``. Exits nonzero, with no result, when CUDA is unavailable or
any phase fails.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import hashlib
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
from collections import Counter, defaultdict
from datetime import datetime, timedelta, timezone
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
    "sha256_pages_batched": "volsync_tpu/ops/sha256.py:367",
    "fastcdc_walk_batched": "volsync_tpu/ops/segment.py:205",
    "sha256_slices_tail_batched": "volsync_tpu/ops/segment.py:126",
    "merkle_roots_batched": "volsync_tpu/ops/segment.py:367",
    "sha256_slices_fixed": "volsync_tpu/parallel/engine.py:76",
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
    "sha256_pages_batched": "volsync_tpu_torch/csrc/sha256.cu",
    "fastcdc_walk_batched": "volsync_tpu_torch/csrc/fastcdc.cu",
    "sha256_slices_tail_batched": "volsync_tpu_torch/csrc/sha256.cu",
    "merkle_roots_batched": "volsync_tpu_torch/csrc/merkle.cu",
    "sha256_slices_fixed": "volsync_tpu_torch/csrc/sha256.cu",
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
                                              "merkle_roots_kernelILb0ELb0E",
                                              16, "LDS"),
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
                 lat_ns: dict, op_cycles: float) -> dict:
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
            root_checks(torch, seg, st, args, kwargs, op_cycles)
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


def root_report(torch, label: str, args, kwargs,
                op_cycles: float | None) -> dict:
    """A root launch's lanes, its bounds (``tools/time_root_calls.
    bounds``: the longest lane's issue floor and, given one dependent
    instruction's cycles, its dependency chain) and the split of one
    launch of its instrumented instance (the heaviest sub-partition's
    load, the longest lane's cycles a round); logged."""
    from volsync_tpu_torch.ops import segment as seg
    from volsync_tpu_torch.tools import time_root_calls as trc

    _, _, page0, nleaves, _, live = args
    blocks = trc.lane_blocks(nleaves.cpu().numpy(), live.cpu().numpy(),
                             kwargs["nb_max"])
    rep = {"lanes": int(page0.shape[0]), "live": int(live.sum()),
           "blocks": int(blocks.sum()), "longest": int(blocks.max()),
           **trc.bounds(int(blocks.max()), op_cycles or 0.0)}
    if op_cycles is None:
        rep["chain_ms"] = None
    if DEVICE == "cuda":
        sp = trc.launch_split(torch, seg, args, kwargs)
        if sp is not None:
            rep["heaviest_sub_partition"] = sp["heaviest_sub_partition"]
            rep["longest_warp"] = sp["longest"]
    heavy = rep.get("heaviest_sub_partition")
    longest = rep.get("longest_warp") or {}
    log(f"merkle_roots {label}: {rep['lanes']} lanes, {rep['live']} live, "
        f"longest {rep['longest']} blocks; chain bound "
        + (f"{rep['chain_ms']:.4f} ms" if op_cycles else "not measured")
        + f", issue bound {rep['issue_ms']:.4f} ms; "
        + (f"heaviest sub-partition {heavy['chain_blocks']} chain blocks + "
           f"{heavy['group_blocks']} in one-a-thread groups; longest lane "
           f"{longest.get('round_cycles', 0):.2f} cycles a round"
           if heavy else "no split"))
    return rep


def root_checks(torch, seg, st, args, kwargs, op_cycles: float) -> None:
    """Bound and longest lane of the segment's root launch, its report
    (``root_report``), and ``merkle_roots`` on one 1,025-block lane
    alone (its measured time a block, beside the chain floor ``main``
    takes from the SASS)."""
    flat, npp, page0, nleaves, lens, live = args
    lanes = root_lane_blocks(torch, nleaves, live, kwargs["nb_max"])
    total, st["longest"] = int(lanes.sum()), int(lanes.max())
    C = page0.shape[0]
    nbytes = int(nleaves.sum()) * 32 + C * (3 * 8 + 1) + C * 32
    bound, st["bound_by"] = sha_bound(total, 0, nbytes)
    st["bound"].append(bound)
    st["split"] = {"fused": root_report(torch, "fused segment", args, kwargs,
                                        op_cycles)}

    one = [flat, npp] + [torch.tensor([v], dtype=torch.int64, device=DEVICE)
                         for v in (0, 2048, 8 << 20)] + [
        torch.tensor([True], device=DEVICE)]
    one_ms = time_ms(torch, lambda: seg._root_digests_loop(*one, **kwargs),
                     10)
    st["one_lane_block_ms"] = one_ms / 1025
    log(f"merkle_roots: {C} lanes, {int(live.sum())} live, {total} blocks, "
        f"longest lane {st['longest']} blocks; one 1,025-block lane "
        f"{one_ms:.4f} ms = {st['one_lane_block_ms'] * 1e3:.4f} us a block")


#: merkle_roots' callers' shapes beyond the fused and service entries
#: (``tools/time_root_calls.py``): batched passes of 8 and 16 lanes of 32
#: MiB, 32 such lanes (more live lanes than the card has sub-partitions),
#: the span form, the mesh's page-major table, a zero-entropy segment, no
#: live lane.
ROOT_SHAPES = ("batched8", "batched16", "lanes32", "verify", "mesh", "zero",
               "dead")
#: Held against hashlib rather than the twin: four 1,025-block lanes are
#: 1,025 twin steps (~35 s on the card); ``tests/test_torch_cuda.py``
#: holds that segment against its twin.
ROOT_HASHLIB = ("zero",)
#: The cut that holds nb_max below a lane's block count: the span form's
#: lanes at this many blocks.
ROOT_CLAMP = 40


def root_union(torch, shapes: dict) -> tuple:
    """One twin call over several shapes' lanes: their tables stacked
    page-major (the digests a lane reads do not depend on the layout)
    -> (args, kwargs, {name: (first lane, lanes)}). Each shape must have
    a live lane and no lane past its own nb_max, so that each lane's
    digest is its shape's."""
    flats, page0s, rest, rows, off, lane0 = [], [], [], {}, 0, 0
    for name, ((flat, npp, page0, nleaves, lens, live), kw) in shapes.items():
        pm = flat if kw["pagemajor"] else flat.view(8, npp).t().reshape(-1)
        flats.append(pm)
        page0s.append(page0 + off)
        rest.append((nleaves, lens, live))
        rows[name] = (lane0, page0.shape[0])
        off += npp
        lane0 += page0.shape[0]
    args = (torch.cat(flats), off, torch.cat(page0s),
            *(torch.cat(x) for x in zip(*rest)))
    kw = dict(nb_max=max(kw["nb_max"] for _, kw in shapes.values()),
              pagemajor=True)
    return args, kw, rows


def root_shape_entries(torch, stats, seed: int, op_cycles: float) -> None:
    """``merkle_roots`` at ``ROOT_SHAPES`` (built on the card by
    ``tools/time_root_calls.shapes``) and with nb_max at ``ROOT_CLAMP``
    on the span form's lanes: each launch held against its twin (the
    shapes with a live lane in one twin call over their lanes,
    ``root_union``; ``ROOT_HASHLIB``'s against hashlib), timed (graph
    replay and eager) and reported (``root_report``) into the kernel's
    ``shapes``."""
    from volsync_tpu_torch.ops import segment as seg
    from volsync_tpu_torch.tools import time_root_calls as trc

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    shapes = trc.shapes(torch, seg, gen, ROOT_SHAPES, DEVICE)
    verify_args, verify_kw = shapes["verify"]
    shapes["clamp"] = (verify_args, dict(verify_kw, nb_max=ROOT_CLAMP))
    st = stats["merkle_roots"]
    got = {name: seg._root_digests_loop(*a, **kw)
           for name, (a, kw) in shapes.items()}
    sync(torch)
    t0 = time.perf_counter()
    union = {k: shapes[k] for k in ROOT_SHAPES
             if k not in ROOT_HASHLIB and bool(shapes[k][0][5].any())}
    args, kw, rows = root_union(torch, union)
    want = seg._root_digests_plain(*args, **kw)
    want = {k: want[a:a + n] for k, (a, n) in rows.items()}
    for k in set(shapes) - set(union) - set(ROOT_HASHLIB):
        want[k] = seg._root_digests_plain(*shapes[k][0], **shapes[k][1])
    for k in ROOT_HASHLIB:  # every lane against hashlib
        a, kw = shapes[k]
        trc.check(a, kw, got[k], range(a[2].shape[0]))
        want[k] = got[k]
    sync(torch)
    plain_s = time.perf_counter() - t0
    for name, (a, kw) in shapes.items():
        err = max_abs_err(torch, got[name], want[name])
        if not torch.equal(got[name], want[name]):
            raise AssertionError(f"merkle_roots at {name} differs from its "
                                 f"twin (max abs err {err})")
        st["err"] = max(st["err"], err)
        rep = root_report(torch, name, a, kw, op_cycles)
        rep.update(pagemajor=bool(kw["pagemajor"]), nb_max=kw["nb_max"],
                   max_abs_err=err, ms=None, eager_ms=None)
        if DEVICE == "cuda":  # a CPU rehearsal times no device
            rep["ms"], rep["eager_ms"] = (
                time_ms(torch, lambda: seg._root_digests_loop(*a, **kw), 5,
                        graph=graph) for graph in (True, False))
        st.setdefault("shapes", {})[name] = rep
        ms = ("not measured" if rep["ms"] is None else
              f"{rep['ms']:.4f} ms (eager {rep['eager_ms']:.4f})")
        log(f"merkle_roots {name}: equals "
            + ("hashlib" if name in ROOT_HASHLIB else "twin")
            + f" (max abs err {err}); kernel {ms}, bound "
            f"{rep['bound_ms']:.4f} ms ({rep['bound_kind']})")
    log(f"merkle_roots twins of the other shapes: {plain_s:.1f} s")


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
            "lanes_with_tail": int(has.sum()),
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


def spans_since(before: dict) -> dict:
    """Host seconds of each ``obs.span`` entered since ``span_totals()``
    read ``before`` (summed over threads)."""
    from volsync_tpu_torch.obs import span_totals

    return {k: round(s - before.get(k, (0, 0.0))[1], 4)
            for k, (n, s) in span_totals().items()
            if n != before.get(k, (0, 0.0))[0]}


def count_passes(hasher) -> PassCounter:
    """Wrap ``hasher.begin_device``; the counter's ``n`` is its device
    passes."""
    passes = PassCounter()
    hasher.begin_device = passes.wrap(hasher.begin_device)
    return passes


class SegmentPasses(PassCounter):
    """Device passes of the fused engine, batched or not: calls of
    ``segment.chunk_hash_segments`` (``n``; the unbatched path makes one
    a segment, the shared micro-batcher, on by default on CUDA, one a
    batched pass of several, and each launches the fused kernels once)
    and the segments they hashed (``lanes``: their lanes holding bytes,
    as deterministic as the segmentation). ``counting()`` counts within
    a block; ``product_run`` enters it."""

    def __init__(self):
        super().__init__()
        self.lanes = 0
        self.shapes: Counter = Counter()  # (S, P) of each pass

    @contextlib.contextmanager
    def counting(self):
        from volsync_tpu_torch.ops import segment as seg

        def make(fn):
            def counted(data, valid_len, eof, **kw):
                live = sum(1 for v in valid_len if int(v) > 0)
                with self._lock:
                    self.n += 1
                    self.lanes += live
                    self.shapes[tuple(data.shape)] += 1
                return fn(data, valid_len, eof, **kw)
            return counted

        with patched(seg, {"chunk_hash_segments": make}):
            yield self


def fused_passes(hasher) -> PassCounter:
    """The pass counter of a backup's hasher: ``SegmentPasses`` on the
    fused engine (whose segments may go through the shared batcher),
    else its ``begin_device`` calls."""
    return SegmentPasses() if hasher.fused is not None \
        else count_passes(hasher)


def engine_hasher(params):
    """A ``DeviceChunkHasher`` with the shared micro-batcher off: the
    stream cells time the engine's own pipeline (a segment in flight
    while the next is read); the batcher, on by default on CUDA, is
    timed in the backup and service phases."""
    from volsync_tpu_torch.engine import DeviceChunkHasher

    hasher = DeviceChunkHasher(params, device=DEVICE)
    hasher.use_shared_batcher = False
    return hasher


def drive(torch, stream, params, per_pass: dict, label: str) -> dict:
    """One pass of ``stream_chunk_batches`` through a fresh hasher with
    every launch count set to 0 just before and read just after. On the
    card every kernel must have launched ``per_pass[name]`` times per
    device pass (0 when absent)."""
    from volsync_tpu_torch.obs import span_totals
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts

    hasher = engine_hasher(params)
    passes = count_passes(hasher)
    before = span_totals()
    for k in KERNELS:
        k.launches = 0
    results, views, secs = stream_once(torch, stream, params, hasher)
    launches = launch_counts()
    spans = spans_since(before)
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
    # the Python walk: the engines' host walk is the native C one
    from volsync_tpu_torch.ops.gearcdc import (_select_boundaries_py,
                                               host_candidates)

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
    return _select_boundaries_py(np.concatenate(cs), np.concatenate(cl),
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
    # One thread: hashlib hands the interpreter lock around on every 4 KiB
    # leaf, and eight threads contending for it hashed the 10 GiB stream's
    # ids in 60.6 s against one thread's 12.1 s (PERF.md, section 4).
    ids = [blobid.blob_id(stream.view(*c)) for c in cuts]
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
    from volsync_tpu_torch.ops import segment as seg

    res = drive(torch, stream, params, FUSED_PER_PASS, "stream")
    results = res["results"]

    # Per-stage device time, from a pass of its own: the probes' events
    # stay out of the GiB/s above, and this pass's GiB/s shows their cost.
    hasher = engine_hasher(params)
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
            "longest": longest, "results": results}


def batcher_turns(torch, stream, params, want: list) -> dict:
    """One stream of the fused cell through ``engine_hasher`` (the
    engine's own pipeline: a segment in flight while the next is read)
    and through the default ``DeviceChunkHasher`` (on CUDA each segment
    a lane of the shared micro-batcher, here alone: one lane a pass,
    after the batch window), in turns: off, on, off, on. Every turn must
    give ``want``'s chunks and, on the card, launch each fused kernel
    once a device pass. Returns each kind's seconds, GiB/s and passes
    in turn order, and whether the default hasher batched."""
    from volsync_tpu_torch.engine import DeviceChunkHasher
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts
    from volsync_tpu_torch.ops.batcher import shared_batcher

    hashers = {"off": engine_hasher(params),
               "on": DeviceChunkHasher(params, device=DEVICE)}
    batching = hashers["on"].use_shared_batcher and \
        shared_batcher(params, device=DEVICE) is not None
    if DEVICE == "cuda" and not batching:
        raise AssertionError("the default hasher does not batch on the card")
    out: dict = {"off": [], "on": [], "batching": batching}
    for turn, kind in enumerate(("off", "on", "off", "on"), 1):
        passes = SegmentPasses()
        for k in KERNELS:
            k.launches = 0
        with passes.counting():
            results, _, secs = stream_once(torch, stream, params,
                                           hashers[kind])
        launches = launch_counts()
        if results != want:
            raise AssertionError(f"stream, batcher {kind}: other chunks")
        expect = {k: FUSED_PER_PASS.get(k, 0) * passes.n for k in launches}
        if DEVICE == "cuda" and launches != expect:
            raise AssertionError(f"stream, batcher {kind}: launches "
                                 f"{launches}, expected {expect}")
        gibs = stream.total / GIB / secs
        out[kind].append({"secs": secs, "gibs": gibs, "passes": passes.n,
                          "segments": passes.lanes})
        log(f"stream, shared batcher {kind} (turn {turn} of 4): "
            f"{secs:.3f} s = {gibs:.4f} GiB/s, {passes.n} device "
            f"passes of {passes.lanes} segments")
    return out


def stream_prefix(stream, total: int):
    """The first ``total`` bytes of ``stream`` as a stream of their own
    (the same blocks, no copy); ``stream`` itself when it is no longer."""
    if total >= stream.total:
        return stream
    prefix = copy.copy(stream)
    prefix.total, prefix.pos = total, 0
    return prefix


def prefix_chunks(results: list, prefix) -> list:
    """The chunks of ``prefix`` from those of the whole stream: a cut
    depends only on the bytes since the chunk's start, so every chunk
    that ends inside the prefix is kept, and the one it cuts short ends
    at the prefix's end (its id from hashlib)."""
    from volsync_tpu_torch.repo import blobid

    n = prefix.total
    out = [c for c in results if c[0] + c[1] <= n]
    end = out[-1][0] + out[-1][1] if out else 0
    if end < n:
        out.append((end, n - end, blobid.blob_id(prefix.view(end, n - end))))
    return out


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


def walk_turns(torch, stream, params, per_pass: dict, label: str,
               first: dict, card: str) -> dict:
    """The host FastCDC walk's two routes over one engine's stream, in
    turns after ``first`` (that stream's pass on the default route, the
    native C walk, held against the oracle): the Python walk
    (``_select_boundaries_py``), the C walk, the Python walk. Every turn
    must give ``first``'s cuts and ids; each C turn must walk every
    segment in C (``select_boundaries_native`` counted, none falling
    back). -> the walk's host seconds (``engine.boundary_walk`` spans)
    a turn by route."""
    from volsync_tpu_torch.engine import chunker
    from volsync_tpu_torch.io import native
    from volsync_tpu_torch.ops.gearcdc import _select_boundaries_py

    walks = {"c": [first["spans"].get("engine.boundary_walk", 0.0)],
             "py": []}
    for route in ("py", "c", "py"):
        calls = []

        def counted(fn):
            def walk(*args, **kwargs):
                out = fn(*args, **kwargs)
                calls.append(out is not None)
                return out
            return walk

        route_patch = (patched(chunker, {"select_boundaries": lambda fn:
                                         _select_boundaries_py})
                       if route == "py" else
                       patched(native, {"select_boundaries_native": counted}))
        with route_patch:
            r = drive(torch, stream, params, per_pass,
                      f"{label}, {'Python' if route == 'py' else 'C'} walk")
        if r["results"] != first["results"]:
            raise AssertionError(f"{label}: the {route} walk gave other "
                                 f"chunks")
        if route == "c" and (len(calls) != r["passes"] or not all(calls)):
            raise AssertionError(f"{label}: {len(calls)} C walks for "
                                 f"{r['passes']} passes, {calls.count(False)}"
                                 f" fell back")
        walks[route].append(r["spans"].get("engine.boundary_walk", 0.0))
    log(f"{label}: the C walk and the Python walk in turns (C, Python, C, "
        f"Python) give equal cuts and ids; the walk's host seconds a pass "
        f"of the stream: C {walks['c']}, Python {walks['py']} ({card})")
    return walks


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
    counting = getattr(passes, "counting", contextlib.nullcontext)
    for k in KERNELS:
        k.launches = 0
    with device_trace(torch, trace) as traced:
        sync(torch)
        t0 = time.perf_counter()
        with patched(chunker, {"hash_spans": verify.wrap}), counting():
            out = run()
        sync(torch)
        secs = time.perf_counter() - t0
    launches = launch_counts()
    n = passes.n if passes is not None else verify.n
    lanes = getattr(passes, "lanes", n)
    want = {k: per_pass.get(k, 0) * n
            + (verify_per_pass or {}).get(k, 0) * verify.n
            for k in launches}
    if DEVICE == "cuda" and (launches != want or lanes < n
                             or (per_pass and lanes < min_passes)):
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want} over {n} passes of {lanes} "
                             f"segments")
    spans = spans_since(before)
    busy = traced["busy_s"]
    log(f"{label}: {secs:.3f} s, {n} device passes"
        + (f" of {lanes} segments" if hasattr(passes, "lanes") else "")
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
            "lanes": lanes, "verify_passes": verify.n, "spans": spans,
            "busy_s": busy}


#: The native readahead reader's check reads this much of the backup
#: tree's big.bin through each route.
READER_BYTES = 1 << 30


def reader_check(path: Path, nbytes: int, card: str) -> dict:
    """The first ``nbytes`` of ``path`` through the native readahead
    reader (``io/native.ReadaheadReader``, 32 MiB segments, as
    ``TreeBackup`` opens files) and through ``open()``, in turns
    (native, open, native, open), each ``readinto`` a pooled 32 MiB
    buffer and hashed: equal SHA-256 every turn. -> GiB/s by route
    (reads and hashing, right after the file was written: a warm read
    where the filesystem caches it)."""
    from volsync_tpu_torch.engine import bufpool
    from volsync_tpu_torch.io import ReadaheadReader

    seg = 32 << 20
    rates = {"native": [], "open": []}
    digests = set()
    buf = bufpool.GLOBAL.acquire(seg)
    view = memoryview(buf)
    try:
        for route in ("native", "open", "native", "open"):
            h = hashlib.sha256()
            left = nbytes
            t0 = time.perf_counter()
            with (ReadaheadReader(path, seg) if route == "native"
                  else open(path, "rb")) as f:
                while left > 0:
                    got = f.readinto(view[: min(seg, left)]) or 0
                    if got == 0:
                        break
                    h.update(view[:got])
                    left -= got
            secs = time.perf_counter() - t0
            if left:
                raise AssertionError(f"reader check: {path.name} ended "
                                     f"{left} bytes early ({route})")
            digests.add(h.hexdigest())
            rates[route].append(nbytes / GIB / secs)
    finally:
        view.release()
        bufpool.GLOBAL.release(buf)
    if len(digests) != 1:
        raise AssertionError(f"reader check: the routes read other bytes "
                             f"({sorted(digests)})")
    log(f"native reader: the first {nbytes} bytes of {path.name} through "
        f"ReadaheadReader and open() in turns, equal SHA-256 "
        f"{next(iter(digests))[:16]}...; GiB/s (read and hashed, right "
        f"after the file was written) native {[round(x, 4) for x in rates['native']]}, "
        f"open() {[round(x, 4) for x in rates['open']]} ({card})")
    return rates


@contextlib.contextmanager
def reader_types():
    """Within the block, the type of every file object
    ``engine/chunker._open_readahead`` returns (``TreeBackup`` opens its
    files through it) is counted; yields the Counter."""
    from volsync_tpu_torch.engine import chunker

    seen: Counter = Counter()

    def spy(fn):
        def opened(path, segment_size):
            f = fn(path, segment_size)
            seen[type(f).__name__] += 1
            return f
        return opened

    with patched(chunker, {"_open_readahead": spy}):
        yield seen


def repo_round_trip(torch, label: str, base: Path, total: int, seed: int,
                    chunker: dict, password, hole: int, card: str,
                    holes: bool, reader_bytes: int = 0) -> dict:
    """Back up a seeded tree into a new ``FsObjectStore`` repository on the
    card, back it up again (nothing new, the same root tree), check it
    with ``read_data=True``, restore it pipelined and serially (both
    byte-identical to the source; ``holes``: ``base`` keeps holes, so
    the source's must be there), then flip one byte in the pack of
    ``big.bin``'s first blob and restore again with ``VOLSYNC_TRACE_DUMP``
    set: IntegrityError, with ``big.bin`` not written and every file
    that was written complete; without a password (the device verify
    catches the byte) the flight recorder's ``restore_verify_fail`` dump
    lands. The first backup must open its files through the native
    readahead reader where the card runs; ``reader_bytes``: first the
    ``reader_check`` of that much of ``big.bin``."""
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
    if reader_bytes:
        res["reader"] = reader_check(
            src / "big.bin", min(reader_bytes,
                                 (src / "big.bin").stat().st_size), card)
    store = FsObjectStore(base / f"{label}-repo")
    repo = Repository.init(store, password, chunker=chunker, device=DEVICE)
    per_pass = FUSED_PER_PASS if chunker["align"] == 4096 else SPLIT_PER_PASS

    def backup_run():
        backup = TreeBackup(repo)
        return backup, fused_passes(backup.hasher)

    backup, passes = backup_run()
    with reader_types() as opened:
        r = product_run(torch, f"{label} backup ({backup.workers} workers)",
                        lambda: backup.run(src), per_pass, passes)
    res["readers"] = dict(opened)
    log(f"{label} backup: files opened through {json.dumps(res['readers'])}")
    if DEVICE == "cuda" and set(opened) != {"ReadaheadReader"}:
        raise AssertionError(f"{label}: the backup opened its files "
                             f"through {dict(opened)}")
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
    big = next(e for e in tree["entries"]
               if e["name"] == "big.bin")["content"]
    ie = next(e for e in map(bad_repo._entry, big)
              if e.length == e.raw_length + 1 + bad_repo.box.overhead)
    pack = store.root / f"data/{ie.pack[:2]}/{ie.pack}"
    with open(pack, "r+b") as f:
        f.seek(ie.offset + ie.length // 2)
        byte = f.read(1)
        f.seek(ie.offset + ie.length // 2)
        f.write(bytes([byte[0] ^ 0x20]))
    dst = base / f"{label}-corrupt"
    dumps = base / f"{label}-trace-dumps"
    try:
        with env_set("VOLSYNC_TRACE_DUMP", str(dumps)), \
                env_set("VOLSYNC_TRACE_TRIGGER_INTERVAL_S", "0"):
            restore_snapshot(bad_repo, dst)
    except crypto.IntegrityError as e:
        caught = str(e)
    else:
        raise AssertionError(f"{label}: the corrupt pack restored")
    landed = sorted(p.name for p in dumps.glob("trace-*.json"))
    fails = sorted(dumps.glob("trace-restore_verify_fail-*.json"))
    if password is None:
        if not fails:
            raise AssertionError(f"{label}: no restore_verify_fail dump "
                                 f"landed (dumps {landed})")
        doc = json.loads(fails[0].read_text())
        if doc["trigger"].get("reason") != "restore_verify_fail" or \
                doc["trigger"].get("blob") not in big:
            raise AssertionError(f"{label}: the dump's trigger is "
                                 f"{doc['trigger']}")
    res["trace_dumps"] = landed
    log(f"{label}: flight-recorder dumps of the corrupt restore "
        f"(VOLSYNC_TRACE_DUMP): {landed}")
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
                            chunker, "smoke-password", hole, card, holes,
                            reader_bytes=READER_BYTES)
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
                   fused_passes(backup.hasher))
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
                   fused_passes(again.hasher))
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


#: The flight recorder's ring while the restic entry's first backup is
#: traced: room for every span it records (the log says whether it held
#: them all).
TRACE_RING = 1 << 20


@contextlib.contextmanager
def flight_recorder():
    """Within the block: ``VOLSYNC_TRACE_RING`` is ``TRACE_RING``, the
    flight recorder starts empty, and one sampled root trace is active
    (the trace context the block's spans nest under); yields its
    context. The ring goes back to its default size after."""
    from volsync_tpu_torch import obs

    with env_set("VOLSYNC_TRACE_RING", str(TRACE_RING)), \
            env_set("VOLSYNC_TRACE_SAMPLE", None):
        obs.reset_trace()
        with obs.trace_context(sampled=True) as root:
            yield root
    obs.reset_trace()


def _union_s(intervals: list) -> float:
    """Seconds covered by a list of (start, end) microsecond pairs."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


def flight_report(root, path: Path, wall: float, batching: bool,
                  hashed: bool, card: str) -> dict:
    """``volsync trace dump --out path`` through the port's CLI in this
    process after a run traced under ``root`` (``flight_recorder``), the
    dump loaded back and checked: the ring did not wrap; every span
    carries ``root``'s trace id and names as its parent ``root`` or a
    span of the dump (a span's parent on its own thread encloses it);
    ``repo.seal`` spans and (``hashed``: the run made device passes)
    ``engine.*`` spans and (and ``batching``: the shared micro-batcher
    ran them) ``ops.batch_dispatch`` spans are there, on more than one
    thread. Logs each thread's busy seconds
    (the union of its spans; of its ``repo.seal`` and ``engine.*``
    spans) against the run's ``wall``, then ``trace summary``."""
    from volsync_tpu_torch import cli, envflags, obs

    lines: list = []
    if cli.main(["trace", "dump", "--out", str(path)],
                out=lines.append) != 0:
        raise AssertionError(f"trace dump: {lines}")
    ring = envflags.trace_ring_size()
    held = len(obs.trace_events())
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    threads = {e["tid"]: e["args"]["name"] for e in events
               if e["ph"] == "M"}
    spans = [e for e in events if e["ph"] == "X"]
    if held >= ring:
        raise AssertionError(f"trace: the ring of {ring} wrapped")
    if {e["args"]["trace_id"] for e in spans} != {root.trace_id}:
        raise AssertionError("trace: spans of another trace in the dump")
    by_id = {e["args"]["span_id"]: e for e in spans}
    for e in spans:
        parent = e["args"]["parent_span_id"]
        if parent != root.span_id and parent not in by_id:
            raise AssertionError(f"trace: {e['name']}'s parent {parent} is "
                                 f"in no span of the dump")
        up = by_id.get(parent)
        if up is not None and up["tid"] == e["tid"] and not (
                up["ts"] - 1 <= e["ts"]
                and e["ts"] + e["dur"] <= up["ts"] + up["dur"] + 1):
            raise AssertionError(f"trace: {e['name']} runs outside its "
                                 f"parent {up['name']} on one thread")
    names = Counter(e["name"] for e in spans)
    need = ["repo.seal"] + (["ops.batch_dispatch"]
                            if hashed and batching else [])
    missing = [n for n in need if n not in names]
    if hashed and not any(n.startswith("engine.") for n in names):
        missing.append("engine.*")
    if missing:
        raise AssertionError(f"trace: no {missing} span in {dict(names)}")
    tids = {e["tid"] for e in spans}
    if len(tids) < 2:
        raise AssertionError("trace: every span on one thread")
    busy = {}
    for tid in sorted(tids, key=lambda t: threads.get(t, "")):
        mine = [e for e in spans if e["tid"] == tid]

        def cover(pick):
            return _union_s([(e["ts"], e["ts"] + e["dur"]) for e in mine
                             if pick(e["name"])])

        busy[f"{threads.get(tid, tid)}"] = {
            "spans": len(mine), "busy_s": round(cover(lambda n: True), 4),
            "seal_s": round(cover(lambda n: n == "repo.seal"), 4),
            "engine_s": round(cover(lambda n: n.startswith("engine.")), 4)}
    log(f"trace dump of the restic entry's first backup: "
        f"{path.stat().st_size} bytes, {len(spans)} spans ({held} events, "
        f"ring of {ring} not wrapped) on {len(tids)} threads, names "
        f"{json.dumps(dict(sorted(names.items())))}")
    log(f"trace: each thread's busy seconds over the backup's {wall:.3f} s "
        f"wall (the union of its spans; of repo.seal; of engine.*): "
        + json.dumps(busy) + f" ({card})")
    lines.clear()
    cli.main(["trace", "summary"], out=lines.append)
    for line in lines:
        log(f"trace summary | {line}")
    return {"spans": len(spans), "events": held, "threads": busy,
            "names": dict(names)}


def batching_turns(run_entry, base: Path, src: Path, made: dict,
                   first: dict) -> list:
    """The restic entry's backup of ``src`` into fresh repositories in
    turns after ``first`` (the shared micro-batcher on, the CUDA
    default): ``VOLSYNC_BATCH_SEGMENTS=0``, again, then batched, each
    untraced and its repository removed after. Every turn hashes the
    segments ``first`` did (an unbatched turn one pass a segment) and
    leaves the same root tree."""
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.repo.repository import Repository

    def tree_of(repo_dir):
        repo = Repository.open(FsObjectStore(repo_dir), EC_PASSWORD,
                               device=DEVICE)
        (snap, meta), = repo.list_snapshots()
        return meta["tree"]

    want_tree = tree_of(base / "restic-repo")
    turns = []
    with env_set("VOLSYNC_TRACE_DIR", None):
        for i, batched in enumerate((False, False, True)):
            repo_dir = base / f"restic-turn{i}"
            how = "batched" if batched else "VOLSYNC_BATCH_SEGMENTS=0"
            with env_set("VOLSYNC_BATCH_SEGMENTS", None if batched
                         else "0"):
                r = run_entry(f"restic entry backup, turn {i + 1} ({how})",
                              {"RESTIC_REPOSITORY": f"file://{repo_dir}"},
                              src, True)
            tree = tree_of(repo_dir)
            shutil.rmtree(repo_dir, ignore_errors=True)
            if DEVICE == "cuda" and (
                    r["lanes"] != first["lanes"]
                    or (not batched and r["passes"] != r["lanes"])):
                raise AssertionError(
                    f"turn {i + 1}: {r['passes']} passes of {r['lanes']} "
                    f"segments, the first backup {first['lanes']}")
            if tree != want_tree:
                raise AssertionError(f"turn {i + 1}: root tree {tree}, "
                                     f"expected {want_tree}")
            turns.append({"batched": batched, "secs": r["secs"],
                          "passes": r["passes"], "lanes": r["lanes"],
                          "gibs": made["bytes"] / GIB / r["secs"]})
    log("restic entry backup in turns (batched first, then "
        + ", ".join(("batched" if t["batched"] else "unbatched")
                    for t in turns)
        + f"): {first['secs']:.3f} s in {first['passes']} passes of "
        f"{first['lanes']} segments, then "
        + ", ".join(f"{t['secs']:.3f} s in {t['passes']} passes"
                    for t in turns)
        + f" ({made['bytes']} bytes)")
    return turns


def restic_entry_phase(torch, base: Path, total: int, seed: int,
                       card: str, mesh_check=None,
                       trace_out: Path | None = None) -> dict:
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
    three files, where they hold device events. The first backup runs
    under one root trace of the flight recorder (``flight_recorder``),
    and ``trace dump`` writes its spans to ``trace_out`` (default: under
    ``base``), checked by ``flight_report``. ``mesh_check(base, src,
    tree)``, where given, runs after the first backup with its root
    tree."""
    from volsync_tpu_torch import obs
    from volsync_tpu_torch.cluster.runner import JobContext
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
        passes = SegmentPasses()
        ctx = JobContext(name="restic", namespace="chip-smoke",
                         env={**env, **extra}, mounts={"data": data},
                         secrets={}, stop_event=threading.Event(),
                         device=DEVICE)

        def run():
            with (contextlib.nullcontext() if backup
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

    from volsync_tpu_torch.ops.batcher import _batching_enabled

    res = {}
    with env_set("VOLSYNC_TRACE_DIR", str(traces.parent)):
        with flight_recorder() as root:
            res["backup"] = run_entry("restic entry backup", {}, src, True)
            res["flight"] = flight_report(
                root, trace_out or base / "restic-flight.json",
                res["backup"]["secs"],
                _batching_enabled(torch.device(DEVICE)),
                res["backup"]["passes"] > 0, card)
        res["backup"]["bytes"] = made["bytes"]
        res["turns"] = batching_turns(run_entry, base, src, made,
                                      res["backup"])
        if mesh_check is not None:
            (_, meta), = Repository.open(
                FsObjectStore(base / "restic-repo"), EC_PASSWORD,
                device=DEVICE).list_snapshots()
            res["mesh"] = mesh_check(base, src, meta["tree"])
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


# -- rclone: the rclone mover's entry point through an S3 remote ------------

#: The rclone phase's tree: BASELINE.json configs[2]'s many small files,
#: cut in depth (``--rclone-files`` of them). Sizes are log-uniform from 1
#: byte to ``small_max``; every 20th small file copies an earlier one.
RCLONE_LAYOUT = {"dirs": 128, "small_max": 128 << 10, "dup_every": 20,
                 "empty": 64, "links": 16, "dir_links": 2, "empty_dirs": 4,
                 "n_mid": 32, "mid_min": 4 << 20, "mid_max": 16 << 20,
                 "big": (256 << 20) + ODD_TAIL}
RCLONE_TRANSFERS = 10
#: ``hash_file_streaming``'s segment, as ``sync.hash_files`` calls it.
RCLONE_SEGMENT = 32 << 20
RCLONE_APPEND = 4097
RCLONE_PREFIX = "pvc"
#: Launches of one ``hash_spans`` flush of page-aligned spans.
RCLONE_PER_FLUSH = VERIFY_PER_PASS


def rclone_layout(files: int) -> dict:
    return {**RCLONE_LAYOUT, "files": files}


def make_rclone_tree(root: Path, layout: dict, seed: int) -> dict:
    """The seeded many-small-files tree: ``files`` small files in ``dirs``
    directories (every ``dup_every``-th a byte copy of an earlier one,
    every 7th mode 0600), ``empty`` empty files, ``links`` symlinks
    (``dir_links`` of them to directories), ``empty_dirs`` empty
    directories, ``n_mid`` files of ``mid_min``..``mid_max`` bytes (mode
    0640) and ``big.bin`` of ``big`` bytes. A ``user.`` xattr goes on
    eight small files and one directory where the filesystem keeps it.
    -> {"small": [rel], "mid": [rel], "xattrs": bool}."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    dirs = [f"d{i:03d}" for i in range(layout["dirs"])]
    for d in dirs:
        (root / d).mkdir()
    sizes = np.exp(rng.uniform(0, np.log(layout["small_max"] + 1),
                               layout["files"])).astype(np.int64)
    sizes = np.clip(sizes, 1, layout["small_max"])
    small, originals = [], []
    for i, n in enumerate(sizes):
        rel = f"{dirs[i % len(dirs)]}/f{i:05d}.bin"
        if originals and i % layout["dup_every"] == layout["dup_every"] - 1:
            data = (root / originals[rng.integers(len(originals))]).read_bytes()
        else:
            data = rng.bytes(int(n))
            originals.append(rel)
        (root / rel).write_bytes(data)
        if i % 7 == 0:
            os.chmod(root / rel, 0o600)
        small.append(rel)
    for i in range(layout["empty"]):
        (root / dirs[i % len(dirs)] / f"e{i:03d}").write_bytes(b"")
    mid = []
    for i in range(layout["n_mid"]):
        rel = f"{dirs[(4 * i + 1) % len(dirs)]}/m{i:03d}.bin"
        n = int(rng.integers(layout["mid_min"], layout["mid_max"] + 1))
        (root / rel).write_bytes(rng.bytes(n))
        os.chmod(root / rel, 0o640)
        mid.append(rel)
    with open(root / "big.bin", "wb") as f:
        left = layout["big"]
        while left:
            piece = min(left, 16 << 20)
            f.write(rng.bytes(piece))
            left -= piece
    for k in range(layout["links"]):
        if k < layout["dir_links"]:
            os.symlink(dirs[k], root / f"dlink{k}")
        else:
            d = dirs[k % len(dirs)]
            target = next(r for r in small if r.startswith(d + "/"))
            os.symlink(target.split("/", 1)[1], root / d / f"l{k:02d}")
    for k in range(layout["empty_dirs"]):
        (root / f"empty{k}").mkdir()
    try:
        for rel in small[:8] + [dirs[0]]:
            os.setxattr(root / rel, "user.rclone", rel.encode())
        xattrs = True
    except OSError:
        xattrs = False
    return {"small": small, "mid": mid, "xattrs": xattrs}


def edit_rclone_tree(root: Path, made: dict, seed: int) -> dict:
    """The second sync's edits: 1% of the small files rewritten in place
    at their size, 1% deleted, 1% added in a new directory, 4,097 bytes
    appended to two of the mid files and 1% chmodded. -> the rels of
    each kind."""
    rng = np.random.default_rng(seed)
    small = made["small"]
    k = max(len(small) // 100, 1)
    pick = [small[i] for i in rng.permutation(len(small))[: 3 * k]]
    edits = {"rewritten": pick[:k], "deleted": pick[k: 2 * k],
             "chmodded": pick[2 * k:], "appended": made["mid"][:2],
             "added": [f"new/n{i:04d}.bin" for i in range(k)]}
    for rel in edits["rewritten"]:
        n = (root / rel).stat().st_size
        with open(root / rel, "r+b") as f:
            f.write(rng.bytes(n))
    for rel in edits["deleted"]:
        (root / rel).unlink()
    for rel in edits["chmodded"]:
        mode = (root / rel).stat().st_mode & 0o7777
        os.chmod(root / rel, 0o640 if mode != 0o640 else 0o600)
    for rel in edits["appended"]:
        with open(root / rel, "ab") as f:
            f.write(rng.bytes(RCLONE_APPEND))
    (root / "new").mkdir()
    for rel in edits["added"]:
        (root / rel).write_bytes(rng.bytes(int(rng.integers(1, 64 << 10))))
    return edits


def _xattrs(p: Path) -> tuple:
    """(name, value) of each extended attribute ``p`` itself holds."""
    try:
        names = os.listxattr(p, follow_symlinks=False)
    except OSError:
        return ()
    out = []
    for n in sorted(names):
        try:
            out.append((n, os.getxattr(p, n, follow_symlinks=False)))
        except OSError:
            continue
    return tuple(out)


def rclone_state(root: Path) -> dict:
    """rel -> what the rclone index keeps of each path below ``root``
    (directories and symlinked directories not descended into as
    ``scan_tree``, the root itself left out): a directory's mode, mtime,
    owner and xattrs; a file's mode, mtime, size, SHA-256, owner and
    xattrs; a symlink's target, owner and xattrs."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        d = Path(dirpath)
        for name in dirnames + filenames:
            p = d / name
            st = p.lstat()
            rel = p.relative_to(root).as_posix()
            meta = (st.st_uid, st.st_gid, _xattrs(p))
            if os.path.islink(p):
                out[rel] = ("symlink", os.readlink(p)) + meta
            elif p.is_dir():
                out[rel] = ("dir", st.st_mode & 0o7777, st.st_mtime_ns) + meta
            else:
                with open(p, "rb") as f:
                    digest = hashlib.file_digest(f, "sha256").hexdigest()
                out[rel] = ("file", st.st_mode & 0o7777, st.st_mtime_ns,
                            st.st_size, digest) + meta
    return out


def rclone_shard_of(rel: str) -> str:
    """The index shard of a path: the first two hex digits of the SHA-256
    of its directory (the bucket's index format)."""
    d = rel.rsplit("/", 1)[0] if "/" in rel else ""
    return hashlib.sha256(d.encode()).hexdigest()[:2]


def rclone_walk_files(root: Path) -> list:
    """[(rel, size)] of the regular files below ``root`` in ``os.walk``
    order: the order ``sync.scan_tree`` lists and ``hash_files`` reads
    them."""
    out = []
    for dirpath, _, filenames in os.walk(root):
        for name in filenames:
            p = Path(dirpath) / name
            st = p.lstat()
            if not os.path.islink(p) and p.is_file():
                out.append((p.relative_to(root).as_posix(), st.st_size))
    return out


def rclone_hashing(sizes: list, batch: int, stream: int) -> dict:
    """What ``sync.hash_files`` launches for files of ``sizes`` in read
    order: a file over ``stream`` bytes hashes alone through
    ``hash_file_streaming`` (one K1 a ``RCLONE_SEGMENT`` segment that
    holds a full page); the others pack into a batch, flushed (one
    ``hash_spans``) once it holds ``batch`` bytes and at the end.
    -> {"flushes", "streamed", "launches": {kernel: n}}."""
    flushes = n_batch = batch_bytes = 0
    streamed = []
    for n in sizes:
        if n > stream:
            streamed.append(n)
            continue
        n_batch += 1
        batch_bytes += n
        if batch_bytes >= batch:
            flushes += 1
            n_batch = batch_bytes = 0
    flushes += n_batch > 0
    pages = sum(n // RCLONE_SEGMENT + (n % RCLONE_SEGMENT >= 4096)
                for n in streamed)
    launches = {k: v * flushes for k, v in RCLONE_PER_FLUSH.items()}
    launches["sha256_pages"] += pages
    return {"flushes": flushes, "streamed": len(streamed),
            "launches": launches}


def _shards(state: dict) -> dict:
    groups = defaultdict(dict)
    for rel, v in state.items():
        groups[rclone_shard_of(rel)][rel] = v
    return groups


def predict_up(old: dict | None, new: dict) -> dict:
    """``sync_up``'s stats from the tree's states before (None: a cold
    bucket) and now: uploads are the new distinct contents, deleted
    objects the old ones no longer held, and an index shard is written
    where any of its paths changed."""
    files = [v for v in new.values() if v[0] == "file"]
    have = {v[4] for v in (old or {}).values() if v[0] == "file"}
    want = {v[4] for v in files}
    shards = _shards(new)
    old_shards = _shards(old or {})
    return {"files": len(files), "uploaded": len(want - have),
            "deduped": len(files) - len(want - have),
            "deleted_objects": len(have - want),
            "index_shards": len(shards),
            "index_shards_written": sum(
                old_shards.get(k) != g for k, g in shards.items()),
            "bytes": sum(v[3] for v in files)}


def predict_down(local: dict | None, state: dict) -> dict:
    """``sync_down``'s stats into a tree in ``local`` (None: empty) from
    a bucket of ``state``: a file of equal size and content is skipped,
    every other file fetched, and each local path the bucket lacks is
    deleted."""
    local = local or {}
    files = {r: v for r, v in state.items() if v[0] == "file"}
    skipped = sum(1 for r, v in files.items()
                  if local.get(r, ())[:1] == ("file",)
                  and local[r][3:5] == v[3:5])
    return {"files": len(files), "fetched": len(files) - skipped,
            "skipped": skipped,
            "deleted_local": sum(1 for r in local if r not in state),
            "bytes": sum(v[3] for v in files.values())}


def rclone_hashed(root: Path, entries: dict | None, batch: int,
                  stream: int) -> dict:
    """``rclone_hashing`` of the files a sync reads from ``root``: all
    of them (``entries`` None, a sync up), or those a sync down rechecks
    (a file of the bucket's ``entries`` state at the same size)."""
    walk = rclone_walk_files(root)
    if entries is not None:
        walk = [(r, n) for r, n in walk
                if entries.get(r, ())[:1] == ("file",)
                and entries[r][3] == n]
    return rclone_hashing([n for _, n in walk], batch, stream)


@contextlib.contextmanager
def verb_counts(server):
    """Within the block, the fake server counts its requests by verb
    (a GET of a bucket with no key is a LIST); yields the counts."""
    counts = defaultdict(int)
    lock = threading.Lock()
    handler = server._httpd.RequestHandlerClass

    def make(verb):
        def wrap(fn):
            def counted(self):
                name = verb
                if verb == "GET" and "/" not in self.path.lstrip("/").split(
                        "?", 1)[0]:
                    name = "LIST"
                with lock:
                    counts[name] += 1
                return fn(self)
            return counted
        return wrap

    with patched(handler, {f"do_{v}": make(v)
                           for v in ("PUT", "GET", "HEAD", "DELETE")}):
        yield counts


def check_rclone_index(label: str, store, root: Path, state: dict) -> None:
    """The bucket holds exactly ``state``: every file's index digest is
    the host blob id (hashlib) of its bytes, the objects are exactly the
    digests the index references, and no lock object is left."""
    from volsync_tpu_torch.movers.rclone import sync
    from volsync_tpu_torch.repo.blobid import blob_id

    index = sync.read_index(store, RCLONE_PREFIX)
    if set(index) != set(state):
        diff = sorted(set(index) ^ set(state))[:5]
        raise AssertionError(f"{label}: index paths differ, e.g. {diff}")
    bad = [r for r, e in index.items() if e["type"] == "file"
           and e["digest"] != blob_id((root / r).read_bytes())]
    objects = {k.rsplit("/", 1)[-1]
               for k in store.list(f"{RCLONE_PREFIX}/{sync.OBJECTS}/")}
    digests = {e["digest"] for e in index.values() if e["type"] == "file"}
    locks = list(store.list(f"{RCLONE_PREFIX}/{sync.LOCKS}/"))
    if bad or objects != digests or locks:
        raise AssertionError(f"{label}: digests differing from hashlib "
                             f"{bad[:3]}, {len(objects ^ digests)} objects "
                             f"unlike the index, locks left {locks}")


def rclone_run(torch, label: str, server, run, want_stats: dict,
               hashing: dict, card: str) -> dict:
    """``run()`` (one ``rclone_entrypoint`` call, returning its rc and
    stats) with every launch count set to 0 just before and read just
    after, the card traced, the fake server's requests counted by verb
    and ``sync``'s ``hash_spans`` and ``hash_file_streaming`` calls
    counted. The rc must be 0, the stats ``want_stats``, the flushes and
    streamed files ``hashing``'s and, on the card, the launches
    ``hashing["launches"]`` exactly."""
    from volsync_tpu_torch.movers.rclone import sync as rclone_sync
    from volsync_tpu_torch.obs import span_totals
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts

    flushes, streamed = PassCounter(), PassCounter()
    before = span_totals()
    for k in KERNELS:
        k.launches = 0
    with verb_counts(server) as verbs, device_trace(torch) as traced, \
            patched(rclone_sync, {"hash_spans": flushes.wrap,
                                  "hash_file_streaming": streamed.wrap}):
        sync(torch)
        t0 = time.perf_counter()
        rc, stats = run()
        sync(torch)
        secs = time.perf_counter() - t0
    launches = launch_counts()
    want = {k: hashing["launches"].get(k, 0) for k in launches}
    if rc != 0 or stats != want_stats:
        raise AssertionError(f"{label}: rc {rc}, stats {stats}, expected "
                             f"{want_stats}")
    if (flushes.n, streamed.n) != (hashing["flushes"], hashing["streamed"]) \
            or (DEVICE == "cuda" and launches != want):
        raise AssertionError(
            f"{label}: {flushes.n} flushes and {streamed.n} streamed files, "
            f"launches {launches}; expected {hashing['flushes']}, "
            f"{hashing['streamed']} and {want}")
    spans = spans_since(before)
    busy = traced["busy_s"]
    res = {"secs": secs, "stats": stats, "launches": launches,
           "flushes": flushes.n, "streamed": streamed.n, "spans": spans,
           "verbs": dict(verbs), "busy_s": busy,
           "gibs": stats["bytes"] / GIB / secs,
           "files_per_s": stats["files"] / secs}
    log(f"{label}: {secs:.3f} s, {res['gibs']:.4f} GiB/s, "
        f"{res['files_per_s']:.1f} files/s; stats {json.dumps(stats)}; "
        f"{flushes.n} hash_spans flushes, {streamed.n} streamed files, "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}; "
        f"card busy "
        + (f"{busy:.4f} s ({100 * busy / secs:.2f}% of the wall; "
           f"{traced['events']} device events, seconds by kind "
           f"{json.dumps(traced['by_kind'])})" if busy is not None
           else "not measured")
        + f"; requests by verb {json.dumps(res['verbs'])}; host seconds by "
          f"span (summed over threads): {json.dumps(spans)} ({card})")
    return res


def rclone_phase(torch, base: Path, layout: dict, seed: int,
                 card: str) -> dict:
    """The rclone mover's entry point on the port (ref
    movers/rclone/entry.py) through an S3 remote: the port's
    ``FakeS3Server`` on 127.0.0.1, named by an ``rclone.conf`` section
    (``url = s3:http://127.0.0.1:<port>/bucket`` with the access key,
    secret and endpoint), ``TRANSFERS`` 10, ``ResilientStore`` on. Over
    the seeded tree of ``make_rclone_tree``: ``up`` into the cold bucket,
    ``down`` into an empty directory, the edits of ``edit_rclone_tree``,
    ``up2`` and ``down2`` into the tree ``down`` made. Each run
    (``rclone_run``) is held to its rc, to its stats as ``predict_up`` /
    ``predict_down`` give them, to its flushes and launches as
    ``rclone_hashed`` gives them; after each up every index digest is
    the host blob id of the file (``check_rclone_index``), after each
    down the destination equals the source (``rclone_state``)."""
    from volsync_tpu_torch.cluster.runner import JobContext
    from volsync_tpu_torch.movers.rclone import entry, sync
    from volsync_tpu_torch.objstore.fakes3 import FakeS3Server
    from volsync_tpu_torch.objstore.s3 import S3ObjectStore

    src, dst = base / "rclone-src", base / "rclone-dst"
    t0 = time.perf_counter()
    made = make_rclone_tree(src, layout, seed)
    state = rclone_state(src)
    total = sum(v[3] for v in state.values() if v[0] == "file")
    log(f"rclone: tree of {sum(v[0] == 'file' for v in state.values())} "
        f"files, {total} bytes, {len(state)} paths made in "
        f"{time.perf_counter() - t0:.1f} s; xattrs "
        + ("kept by this filesystem, compared" if made["xattrs"]
           else "not kept by this filesystem, not compared"))
    batch, stream = sync._BATCH_BYTES, sync._STREAM_THRESHOLD
    res = {"bytes": total}
    with FakeS3Server() as server:
        conf = (f"[bucket]\nurl = s3:{server.endpoint}/bucket\n"
                f"access_key_id = {server.access_key}\n"
                f"secret_access_key = {server.secret_key}\n"
                f"endpoint = {server.endpoint}\n")
        bucket = S3ObjectStore(server.endpoint, "bucket",
                               access_key=server.access_key,
                               secret_key=server.secret_key)
        captured = {}

        def capture(fn):
            def wrapper(*args, **kwargs):
                captured["stats"] = fn(*args, **kwargs)
                return captured["stats"]
            return wrapper

        def go(direction, data):
            ctx = JobContext(
                name="rclone", namespace="chip-smoke",
                env={"RCLONE_DEST_PATH": RCLONE_PREFIX, "DIRECTION": direction,
                     "RCLONE_CONFIG_SECTION": "bucket",
                     "TRANSFERS": str(RCLONE_TRANSFERS)},
                mounts={"data": data},
                secrets={"rclone-secret": {"rclone.conf": conf.encode()}},
                stop_event=threading.Event(), device=DEVICE)
            captured.clear()
            with patched(entry, {"sync_up": capture, "sync_down": capture}):
                rc = entry.rclone_entrypoint(ctx)
            return rc, captured.get("stats")

        res["up"] = rclone_run(
            torch, "rclone up", server, lambda: go("source", src),
            predict_up(None, state), rclone_hashed(src, None, batch, stream),
            card)
        check_rclone_index("rclone up", bucket, src, state)
        dst.mkdir()
        res["down"] = rclone_run(
            torch, "rclone down", server, lambda: go("destination", dst),
            predict_down(None, state),
            rclone_hashed(dst, state, batch, stream), card)
        if rclone_state(dst) != state:
            raise AssertionError("rclone down: the destination differs from "
                                 "the source")
        edits = edit_rclone_tree(src, made, seed + 1)
        state2 = rclone_state(src)
        res["up2"] = rclone_run(
            torch, "rclone up2", server, lambda: go("source", src),
            predict_up(state, state2),
            rclone_hashed(src, None, batch, stream), card)
        check_rclone_index("rclone up2", bucket, src, state2)
        local = rclone_state(dst)
        res["down2"] = rclone_run(
            torch, "rclone down2", server, lambda: go("destination", dst),
            predict_down(local, state2),
            rclone_hashed(dst, state2, batch, stream), card)
        if rclone_state(dst) != state2:
            raise AssertionError("rclone down2: the destination differs from "
                                 "the edited source")
        res["objects"] = len(list(bucket.list(f"{RCLONE_PREFIX}/objects/")))
    res["edits"] = {k: len(v) for k, v in edits.items()}
    log(f"rclone: trees equal after down and down2 (bytes, modes, mtimes, "
        f"symlink targets, empty directories, owners"
        + (", xattrs" if made["xattrs"] else "") + "); every index digest "
        f"equal to hashlib's blob id; edits {json.dumps(res['edits'])}; "
        f"{res['objects']} objects left in the bucket ({card})")
    return res


# -- service: the mover-jax gRPC service, 100 concurrent sources ------------

#: BASELINE.json configs[4]'s 100 concurrent sources, in three tenants
#: (name:weight:clients).
SERVICE_TENANTS = "gold:4:25;silver:2:25;bronze:1:50"
#: The server's default segment (ref ``server.py:91``), in KiB.
SERVICE_SEGMENT_KIB = 32 * 1024
#: Each source ends this many bytes short of its whole MiB, so that its
#: last (eof) segment ends mid-page and every lane of that segment's pass
#: hashes a partial tail leaf, as a volume's stream does.
SERVICE_SHORT = 12345
#: The armed round: 8 streams of 80 MiB (less ``SERVICE_SHORT``) under
#: VOLSYNC_TPU_LOCKCHECK=1. Each crosses the server's 40 MiB segment cut
#: (32 MiB + max_size) twice, so the carry-the-tail join, the stream
#: credits and non-eof batched lanes run on the card.
SERVICE_LOCKCHECK_TENANTS = "gold:4:4;bronze:1:4"
SERVICE_LOCKCHECK_MIB = 80
#: gRPC's default 4 MiB receive cap (neither package's server raises it)
#: bounds one request, so HashSpans over the 64 MiB buffer goes as
#: requests of four 512 KiB spans.
SPANS_LEN = 512 << 10
SPANS_PER_REQUEST = 4


class RssPeak:
    """Samples this process's resident set (``VmRSS``) every 50 ms while
    the block runs; ``start`` is the first sample and ``peak`` the
    largest, in bytes."""

    def __init__(self):
        self.start = self.peak = 0
        self._stop = threading.Event()

    @staticmethod
    def now() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _run(self):
        while not self._stop.wait(0.05):
            self.peak = max(self.peak, self.now())

    def __enter__(self):
        self.start = self.peak = self.now()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rss-peak")
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, self.now())


def source_bytes(mib: float) -> int:
    """A service source's bytes: ``mib`` MiB less ``SERVICE_SHORT``."""
    return int(mib * (1 << 20)) - SERVICE_SHORT


def source_mib(mib: float) -> float:
    """``source_bytes`` as ``run_closed_loop``'s MiB (a dyadic float, so
    its bytes come back exact)."""
    return source_bytes(mib) / (1 << 20)


def service_round(torch, label: str, tenants: list, mib: float,
                  window_ms: float, seed: int, *, warm: bool) -> dict:
    """One closed-loop round of ``tools/service_bench.run_closed_loop``
    through the port's ``MoverJaxServer`` on the card (one request a
    client of ``mib`` MiB less ``SERVICE_SHORT`` bytes, ``DEFAULT_PARAMS``,
    the server's 32 MiB segment, a ``window_ms`` batch window; 0 is the
    per-request path). Every launch
    count is set to 0 just before the timed phase and read just after,
    with the card traced and the fused passes counted; every kernel of
    the fused path must have launched once a pass, no stream may abort,
    every client must finish, and a batched round must make fewer passes
    than segments."""
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts
    from volsync_tpu_torch.ops.gearcdc import DEFAULT_PARAMS
    from volsync_tpu_torch.tools import service_bench as sb

    passes = SegmentPasses()
    got: dict = {}

    @contextlib.contextmanager
    def around_timed():
        for k in KERNELS:
            k.launches = 0
        with device_trace(torch) as traced:
            with passes.counting():
                yield
            sync(torch)
        got["launches"] = launch_counts()
        got["traced"] = traced

    res = sb.run_closed_loop(
        tenants=tenants, requests_per_client=1,
        mib_per_request=source_mib(mib), segment_kib=SERVICE_SEGMENT_KIB,
        window_ms=window_ms, params=DEFAULT_PARAMS,
        warm=warm, device=DEVICE, seed=seed, keep_chunks=True,
        client_timeout=600.0, around_timed=around_timed)
    clients = sum(t["clients"] for t in tenants)
    launches = got["launches"]
    want = {k: FUSED_PER_PASS.get(k, 0) * passes.n for k in launches}
    if res["mid_stream_aborts"] or res["requests_total"] != clients:
        raise AssertionError(f"{label}: {res['requests_total']} of "
                             f"{clients} streams, aborts "
                             f"{res['mid_stream_aborts'][:3]}")
    if DEVICE == "cuda" and launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want} over {passes.n} passes")
    if window_ms > 0 and not (passes.n < passes.lanes
                              and res["coalesced"]):
        raise AssertionError(f"{label}: {passes.n} passes for "
                             f"{passes.lanes} segments: nothing coalesced")
    busy = got["traced"]["busy_s"]
    res.update(launches=launches, passes=passes.n, lanes=passes.lanes,
               busy_s=busy, pass_shapes=passes.shapes)
    log(f"{label}: {clients} sources x {source_bytes(mib)} B in "
        f"{res['wall_s']} s = "
        f"{res['value']} GiB/s; {passes.n} device passes of "
        f"{passes.lanes} segments (segments a dispatch: "
        f"{json.dumps(res['lanes_histogram'])}; passes by [lanes, bytes "
        f"a lane]: {json.dumps(sorted(passes.shapes.items()))}); launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}; card "
        "busy "
        + (f"{busy:.4f} s ({100 * busy / res['wall_s']:.2f}% of the wall;"
           f" seconds by kind {json.dumps(got['traced']['by_kind'])})"
           if busy is not None else "not measured"))
    for name, t in res["tenants"].items():
        log(f"{label} tenant {name} (weight {t['weight']}, {t['clients']} "
            f"clients): p50 {t['p50_ms']} ms, p99 {t['p99_ms']} ms, "
            f"{t['goodput_gibs']} GiB/s; admitted "
            f"{res['admitted_by_tenant'].get(name, 0):.0f}, shed "
            f"{res['shed_by_tenant'].get(name, 0):.0f}; server seconds by "
            f"stage {json.dumps(t['stages_s'])}")
    log(f"{label}: host seconds by span (summed over threads): "
        + json.dumps({k: v["seconds"] for k, v in res["spans"].items()}))
    return res


def service_phase(torch, seed: int, tenants_spec: str, mib: float,
                  card: str) -> dict:
    """BASELINE.json configs[4] on one card: the port's mover-jax server
    (``DEFAULT_PARAMS``, 32 MiB segments, pipeline depth 2, admission at
    its defaults) answering ``tenants_spec``'s closed-loop ChunkHash
    sources, ``mib`` MiB each, salted from one seeded base. A warm round
    and the timed round with a 2 ms batch window, then the same load
    per request (window 0); every stream of the batched round equal to
    the unbatched ``DeviceChunkHasher`` on the card over its bytes, one
    stream's ids equal to hashlib's, the per-request round's lists equal
    to the batched round's; ``Info`` reports the device and HashSpans
    over a 64 MiB buffer equals ``hash_spans``; the shed latency with a
    forced-open breaker (under 10 ms in process); then 8 streams of 80
    MiB under ``VOLSYNC_TPU_LOCKCHECK=1`` with no violation, each cut
    into two or more segments and equal to the unbatched hasher. Each
    source ends ``SERVICE_SHORT`` bytes short of its MiB. Logs GiB/s,
    p50/p99, admitted and shed counts by tenant, lanes a pass, spans,
    the card's busy share, peak device memory and peak host RSS."""
    from volsync_tpu_torch.analysis import lockcheck
    from volsync_tpu_torch.engine.chunker import hash_spans
    from volsync_tpu_torch.ops.gearcdc import DEFAULT_PARAMS
    from volsync_tpu_torch.repo import blobid
    from volsync_tpu_torch.service import MoverJaxClient, MoverJaxServer
    from volsync_tpu_torch.tools import service_bench as sb

    tenants = sb.parse_tenants(tenants_spec)
    t0 = time.perf_counter()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss:
        batched = service_round(torch, "service, 2 ms window", tenants, mib,
                                2.0, seed, warm=True)
        per_request = service_round(torch, "service, per request "
                                    "(window 0)", tenants, mib, 0.0, seed,
                                    warm=False)
    peak_dev = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    base = batched.pop("base")
    streams = batched.pop("streams")
    t1 = time.perf_counter()
    ref = engine_hasher(DEFAULT_PARAMS)
    for i, lists in sorted(streams.items()):
        data = sb.salted(base, i + 1)
        want = ref.process(data)
        if any(chunks != want for chunks in lists) or \
                per_request["streams"][i] != lists:
            raise AssertionError(f"service stream {i} differs from the "
                                 f"unbatched hasher on the card")
        if i == 0:
            for o, n, d in want:
                if d != blobid.blob_id(data[o:o + n]):
                    raise AssertionError(f"service stream 0: chunk at {o} "
                                         f"differs from hashlib")
            if sum(n for _, n, _ in want) != data.shape[0]:
                raise AssertionError("service stream 0 left bytes out")
    log(f"service: all {len(streams)} streams equal the unbatched hasher "
        f"on the card (stream 0 also hashlib's ids, "
        f"{len(streams[0][0])} chunks), the per-request round's lists "
        f"equal the batched round's; checked in "
        f"{time.perf_counter() - t1:.1f} s")

    data = sb.salted(base, 1).tobytes()
    spans = [(o, min(SPANS_LEN, len(data) - o))
             for o in range(0, len(data), SPANS_LEN)]
    with MoverJaxServer(params=DEFAULT_PARAMS, device=DEVICE) as srv:
        with MoverJaxClient("127.0.0.1", srv.port, srv.token) as c:
            info = c.info()
            if info.backend != torch.device(DEVICE).type:
                raise AssertionError(f"Info reports {info.backend}")
            remote = []
            for k in range(0, len(spans), SPANS_PER_REQUEST):
                part = spans[k:k + SPANS_PER_REQUEST]
                lo, hi = part[0][0], part[-1][0] + part[-1][1]
                remote += c.hash_spans(data[lo:hi],
                                       [(o - lo, n) for o, n in part])
    if remote != hash_spans(data, spans, device=DEVICE):
        raise AssertionError("HashSpans differs from hash_spans")
    log(f"service: Info reports {info.backend}; HashSpans over "
        f"{len(data)} bytes ({len(spans)} spans, "
        f"{SPANS_PER_REQUEST} a request) equals hash_spans")

    brk = sb.run_closed_loop(tenants=tenants[:1], force_breaker=True,
                             mib_per_request=1, params=DEFAULT_PARAMS,
                             device=DEVICE)["breaker"]
    if brk["direct_shed_p99_ms"] >= 10.0:
        raise AssertionError(f"breaker shed p99 {brk}")
    log(f"service: forced-open breaker sheds at admission in "
        f"{brk['direct_shed_p99_ms']} ms p99 in process (max "
        f"{brk['direct_shed_max_ms']}), {brk['rpc_shed_ms']} ms through "
        f"a client, retry after {brk['retry_after_s']} s")

    armed_passes = SegmentPasses()
    with env_set("VOLSYNC_TPU_LOCKCHECK", "1"):
        lockcheck.reset()
        armed = sb.run_closed_loop(
            tenants=sb.parse_tenants(SERVICE_LOCKCHECK_TENANTS),
            requests_per_client=1,
            mib_per_request=source_mib(SERVICE_LOCKCHECK_MIB),
            segment_kib=SERVICE_SEGMENT_KIB, window_ms=2.0,
            params=DEFAULT_PARAMS,
            warm=False, device=DEVICE, seed=seed + 1, client_timeout=600.0,
            keep_chunks=True, around_timed=armed_passes.counting)
        bad = lockcheck.violations()
        graph = sorted(lockcheck.graph())
    n_armed = armed["clients"]
    if bad or armed["mid_stream_aborts"] or armed["requests_total"] != \
            n_armed:
        raise AssertionError(f"armed service round: violations {bad}, "
                             f"aborts {armed['mid_stream_aborts']}")
    if armed_passes.lanes < 2 * n_armed:
        raise AssertionError(f"armed service round: {armed_passes.lanes} "
                             f"segments for {n_armed} streams; a stream "
                             f"must cross the segment cut")
    for i, lists in sorted(armed["streams"].items()):
        if any(chunks != ref.process(sb.salted(armed["base"], i + 1))
               for chunks in lists):
            raise AssertionError(f"armed service stream {i} differs from "
                                 f"the unbatched hasher on the card")
    log(f"service under VOLSYNC_TPU_LOCKCHECK=1: {n_armed} streams x "
        f"{source_bytes(SERVICE_LOCKCHECK_MIB)} B in "
        f"{armed_passes.lanes} segments ({armed_passes.n} device passes), "
        f"every stream equal to the unbatched hasher, no violation; "
        f"observed lock order {graph}")
    log(f"service phase: {time.perf_counter() - t0:.1f} s in all; batched "
        f"{batched['value']} GiB/s against per request "
        f"{per_request['value']} GiB/s; peak device memory {peak_dev} B, "
        f"host RSS {rss.start} B at the start of the rounds, peak "
        f"{rss.peak} B ({card})")
    return {"batched": batched, "per_request": per_request, "base": base,
            "breaker": brk, "peak_device": peak_dev, "peak_rss": rss.peak,
            "armed": {"streams": n_armed, "segments": armed_passes.lanes,
                      "passes": armed_passes.n}}


#: The fused kernels' entries at the service's batched shape.
BATCHED = {"sha256_pages": "sha256_pages_batched",
           "fastcdc_walk": "fastcdc_walk_batched",
           "sha256_slices_tail": "sha256_slices_tail_batched",
           "merkle_roots": "merkle_roots_batched"}
def batched_kernel_entries(torch, stats, base: np.ndarray, shapes: list,
                           lat: dict, merkle_floor,
                           op_cycles: float | None = None) -> None:
    """The fused kernels at the batched pass's shapes, on the lanes the
    service dispatches: each (S, P) of ``shapes`` is S lanes of P bytes,
    lane i source i's whole salted payload (``base`` XOR i + 1, one eof
    segment ending mid-page, zero-padded to P; a source longer than
    ``P - SERVICE_SHORT`` gives that many of its first bytes), through
    ``chunk_hash_segments`` with every kernel's inputs recorded, each
    held against its twin on those inputs, timed (graph replay and
    eager) and bounded as the kernels phase bounds it. Every lane must
    carry a partial tail leaf, so the tail form hashes S real tails. The
    first shape fills the entry, every shape its ``shapes``."""
    from volsync_tpu_torch.ops import segment as seg
    from volsync_tpu_torch.ops import sha256 as sha
    from volsync_tpu_torch.ops.gearcdc import DEFAULT_PARAMS as p
    from volsync_tpu_torch.tools.service_bench import salted

    fns = kernel_fns(seg, sha)
    for k, (S, P) in enumerate(shapes):
        cc, kc = seg.segment_caps(P, p)
        kw = dict(min_size=p.min_size, avg_size=p.avg_size,
                  max_size=p.max_size, seed=p.seed, mask_s=p.mask_s,
                  mask_l=p.mask_l, align=p.align, cand_cap=cc,
                  chunk_cap=kc)
        n = min(base.shape[0], P - SERVICE_SHORT)
        rows = torch.zeros((S, P), dtype=torch.uint8, device=DEVICE)
        for i in range(S):
            rows[i, :n] = torch.from_numpy(salted(base[:n], i + 1)).to(
                DEVICE)
        with pagemajor_env(False):
            calls = capture_calls(seg, sha, lambda: seg.chunk_hash_segments(
                rows, [n] * S, [True] * S, **kw))
        sync(torch)
        expect_calls(f"batched pass of {S} lanes", calls, FUSED_CALLS)
        del rows
        for name, args, kwargs in calls:
            out_k, _, err, plain_s = against_twin(torch, fns, name, args,
                                                  kwargs)
            st = stats[BATCHED[name]]
            st["err"] = max(st["err"], err)
            reps = 5 if DEVICE == "cuda" else 1
            ms = time_ms(torch, lambda: fns[0][name](*args, **kwargs), reps)
            eager = time_ms(torch, lambda: fns[0][name](*args, **kwargs),
                            reps, graph=False)
            if name == "sha256_pages":
                npp = args[1]
                b = dict(zip(("bound_ms", "bound_by"), sha_bound(
                    64 * npp, npp, S * P + npp * 32)))
            elif name == "fastcdc_walk":
                b = walk_bound(torch, args, out_k, lat)
            elif name == "sha256_slices_tail":
                b = tail_bound(torch, args, kwargs)
                tails = b["lanes_with_tail"]
                if tails != S:
                    raise AssertionError(f"batched tail: {tails} of {S} "
                                         f"lanes carry a tail")
            else:
                flat, npp, page0, nleaves, lens, live = args
                blocks = root_lane_blocks(torch, nleaves, live,
                                          kwargs["nb_max"])
                C = page0.shape[0]
                nbytes = (int(nleaves.sum()) * 32 + C * (3 * 8 + 1)
                          + C * 32)
                b = dict(zip(("bound_ms", "bound_by"), sha_bound(
                    int(blocks.sum()), 0, nbytes)))
                if merkle_floor:
                    b["chain_ms"] = int(blocks.max()) * merkle_floor
                st.setdefault("split", {})[f"{S}x{P}"] = root_report(
                    torch, f"batched {S} lanes", args, kwargs, op_cycles)
            shape = {"lanes": S, "valid_len": n, "ms": ms,
                     "eager_ms": eager,
                     "plain_ms": plain_s * 1e3, "bound_ms": b["bound_ms"],
                     "bound_by": b["bound_by"]}
            if "chain_ms" in b:
                shape["chain_ms"] = b["chain_ms"]
            if k == 0:
                st["ms"].append(ms)
                st["eager_ms"].append(eager)
                st["plain_ms"].append(plain_s * 1e3)
                st["bound"].append(b["bound_ms"])
                st["bound_by"] = b["bound_by"]
            st.setdefault("shapes", {})[f"{S}x{P}"] = shape
            log(f"{BATCHED[name]} at {S} lanes of {P} bytes ({n} valid, "
                f"eof): equals twin "
                f"(max abs err {err}); kernel {ms:.4f} ms (eager "
                f"{eager:.4f}), twin {plain_s * 1e3:.1f} ms, bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']})"
                + (f", chain bound {b['chain_ms']:.4f} ms"
                   if "chain_ms" in b else ""))
        del calls
        if DEVICE == "cuda":
            torch.cuda.empty_cache()


# -- fleet: fenced replicas behind the router, with the continuous GC -------

#: The fleet drill's shape (tests/test_fleet_chaos.py): three replicas,
#: each its own fenced writer over its own store stack on one repository,
#: the server at its defaults but two streams a replica, so that sheds
#: happen, and a continuous GC beside them.
FLEET_REPLICAS = 3
FLEET_MAX_STREAMS = 2
FLEET_JOBS = 12
FLEET_THREADS = 6
FLEET_GC_INTERVAL = 0.5
FLEET_GC_GRACE = 2.0
FLEET_PASSWORD = "smoke-password"
#: r00's store crashes on its second data put (the drill's
#: fleet-kill-mid-stream schedule), and then r00 is killed.
FLEET_CRASH_AT = 2
#: The seeded garbage: a deleted snapshot's files, four of 1 MiB.
FLEET_PRE = (4, 1 << 20)
#: A job's tree is ``--fleet-mib`` MiB less this.
FLEET_SHORT = 12345
#: The nominal job (128 MiB less FLEET_SHORT), which holds the backup
#: cell's 300 small files; a smaller job holds them in proportion.
FLEET_NOMINAL = (128 << 20) - FLEET_SHORT


def make_fleet_tree(root: Path, total: int, seed: int, shared: bytes,
                    min_size: int) -> dict:
    """One fleet job's tree of ``total`` bytes in the backup cell's
    layout without its hole: ``big.bin`` holds ``shared`` (the same bytes
    in every job, half the volume), ``odd.bin`` the rest of the volume
    (this job's own; an odd length), a hard link to it two directories
    down, an empty file and files below ``min_size`` in 16 directories
    (``SMALL_FILES`` in a ``FLEET_NOMINAL`` job, in proportion in a
    smaller one, at least one). Every byte outside ``big.bin`` is drawn
    from ``seed``, so a blob is shared across jobs only where a whole
    file is.
    -> {"bytes": total, "files": {sha256 hex: size} of its distinct
    non-empty contents}."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    n_small = max(1, round(SMALL_FILES * total / FLEET_NOMINAL))
    sizes = rng.integers(1, min(min_size, 64 << 10), size=n_small)
    files = {hashlib.sha256(shared).hexdigest(): len(shared)}
    (root / "big.bin").write_bytes(shared)
    odd = total - len(shared) - int(sizes.sum())
    h = hashlib.sha256()
    with open(root / "odd.bin", "wb") as f:
        left = odd
        while left:
            piece = rng.bytes(min(left, 16 << 20))
            h.update(piece)
            f.write(piece)
            left -= len(piece)
    files[h.hexdigest()] = odd
    (root / "empty").write_bytes(b"")
    (root / "nested" / "deeper").mkdir(parents=True)
    os.link(root / "odd.bin", root / "nested" / "deeper" / "link.bin")
    for i, n in enumerate(sizes):
        d = root / "small" / f"{i % 16:02d}"
        d.mkdir(parents=True, exist_ok=True)
        data = rng.bytes(int(n))
        (d / f"f{i:04d}.bin").write_bytes(data)
        files[hashlib.sha256(data).hexdigest()] = int(n)
        if i % 7 == 0:
            os.chmod(d / f"f{i:04d}.bin", 0o600)
    os.chmod(root / "odd.bin", 0o640)
    os.utime(root / "nested", ns=(1_600_000_000 * 10**9,) * 2)
    return {"bytes": total, "files": files}


def fleet_garbage(store, root: Path, seed: int) -> tuple:
    """Back up a seeded tree, rewrite half of it, back it up again and
    delete the first snapshot: the continuous GC's garbage. -> (the data
    blob ids now in the index, the kept snapshot, the tree)."""
    from volsync_tpu_torch.engine.backup import TreeBackup
    from volsync_tpu_torch.repo.repository import Repository

    rng = np.random.default_rng([seed, 1])
    root.mkdir(parents=True)
    n, size = FLEET_PRE
    for i in range(n):
        (root / f"g{i}.bin").write_bytes(rng.bytes(size + 11 * i))
    repo = Repository.open(store, FLEET_PASSWORD, device=DEVICE)
    doomed, _ = TreeBackup(repo).run(root)
    for i in range(n // 2):
        (root / f"g{i}.bin").write_bytes(rng.bytes(size + 11 * i))
    kept, _ = TreeBackup(repo).run(root)
    repo.delete_snapshot(doomed)
    ids = {b for b in repo.blob_ids() if repo._entry(b).type == "data"}
    return ids, kept


def age_locks(store, seconds: float) -> int:
    """Backdate every lock's refresh stamp by ``seconds``: the
    fingerprint of holders that died that long ago."""
    when = (datetime.now(timezone.utc)
            - timedelta(seconds=seconds)).isoformat()
    keys = list(store.list("locks/"))
    for key in keys:
        info = json.loads(store.get(key))
        info["time"] = when
        store.put(key, json.dumps(info).encode())
    return len(keys)


def fleet_stack(root: Path, seed: int, specs: list):
    """A replica's own view of the shared repository: ``open_store``'s
    layering (``ResilientStore`` over ``FaultStore`` over the directory)
    with the drill's retry policy (no wall-clock backoff, a breaker that
    never trips). -> (its FaultStore, its top)."""
    from volsync_tpu_torch.objstore.faultstore import (FaultSchedule,
                                                       FaultStore)
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.resilience import (CircuitBreaker,
                                              ResilientStore, RetryPolicy)

    faults = FaultStore(FsObjectStore(root),
                        FaultSchedule(seed=seed, specs=specs))
    policy = RetryPolicy(site="fleet", max_attempts=10, base_delay=0.001,
                         max_delay=0.01, sleep_fn=lambda s: None)
    return faults, ResilientStore(
        faults, policy=policy,
        breaker=CircuitBreaker("fleet", threshold=10**9, reset_seconds=0.01))


def fleet_round(torch, label: str, base: Path, trees: list, made: list,
                seed: int, card: str, full: bool = True) -> dict:
    """One round of the fleet drill into a fresh encrypted repository at
    ``DEFAULT_CHUNKER`` seeded with a deleted snapshot's garbage: a
    ``ReplicaGroup`` of three replicas (``FLEET_MAX_STREAMS`` a replica,
    r00's store crashing on its second data put) and a ``ContinuousGC``
    (``FLEET_GC_INTERVAL``, ``FLEET_GC_GRACE``) run the ``trees`` as
    jobs submitted from ``FLEET_THREADS`` threads, each retried after a
    shed's hint; the attempt that meets r00's crash kills r00. A zombie
    writer holds a shared lock from before the round. Then: every job
    completed, failovers counted, r00's stamp left, every live pack
    present, the distinct data bytes equal to the oracle's; and with
    ``full``, the dead writers fenced and the garbage swept (``fence``),
    ``check(read_data=True)`` clean, one restore a replica that
    completed a job, the failed-over job's among them, byte-identical,
    and ``repair`` clearing r00's stamp. Launches exact: the fused
    kernels once a device pass of the jobs, the verify kernels once a
    verify pass of the check and restores."""
    from volsync_tpu_torch.engine.restore import restore_snapshot
    from volsync_tpu_torch.metrics import GLOBAL as METRICS
    from volsync_tpu_torch.objstore.faultstore import FaultSpec
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.repo.repository import (DEFAULT_CHUNKER,
                                                   Repository)
    from volsync_tpu_torch.service import fleet
    from volsync_tpu_torch.service.admission import AdmissionRejected
    from volsync_tpu_torch.service.gc import ContinuousGC

    root = base / f"{label}-repo"
    fs = FsObjectStore(root)
    Repository.init(fs, FLEET_PASSWORD, chunker=DEFAULT_CHUNKER,
                    device=DEVICE)
    pre_ids, kept = fleet_garbage(fs, base / f"{label}-pre", seed)
    crash = FaultSpec(kind="crash", at=FLEET_CRASH_AT, op="put",
                      key_prefix="data/")
    stacks = [fleet_stack(root, seed + r, [crash] if r == 0 else [])
              for r in range(FLEET_REPLICAS)]
    zombie = Repository.open(fs, FLEET_PASSWORD, device=DEVICE)
    zombie._write_lock("shared")
    failovers = METRICS.fleet_failovers_total.values().get((), 0.0)
    sheds_before = sum(METRICS.svc_shed.values().values())
    group = fleet.ReplicaGroup(
        [top for _, top in stacks], router_store=fs, password=FLEET_PASSWORD,
        ttl_seconds=30.0, beat_seconds=0.25, max_streams=FLEET_MAX_STREAMS,
        device=DEVICE)
    gc = ContinuousGC(FsObjectStore(root), password=FLEET_PASSWORD,
                      interval_seconds=FLEET_GC_INTERVAL,
                      grace_seconds=FLEET_GC_GRACE, lock_wait=2.0,
                      device=DEVICE)
    lock = threading.Lock()
    attempts = defaultdict(list)  # job -> [(replica, outcome)]
    errors = []  # every failed attempt's message
    killed = []
    waits = []

    def record(fn):
        def backup(self, tree, *, tenant="fleet", hostname=None):
            try:
                snap = fn(self, tree, tenant=tenant, hostname=hostname)
            except BaseException as ex:
                with lock:
                    attempts[hostname].append((self.replica_id,
                                               type(ex).__name__))
                    errors.append(f"{type(ex).__name__}: {ex}")
                    if stacks[0][0].crashed and not killed:
                        group.kill("r00")  # the pod goes away
                        killed.append(hostname)
                raise
            with lock:
                attempts[hostname].append((self.replica_id, "ok"))
            return snap
        return backup

    def job(j):
        deadline = time.monotonic() + 600
        while True:
            try:
                out = group.submit_backup(trees[j], hostname=f"job{j:02d}")
                break
            except AdmissionRejected as rej:
                # every replica shed it: honour the hint, as a client does
                if time.monotonic() > deadline:
                    raise
                with lock:
                    waits.append(rej.retry_after)
                time.sleep(rej.retry_after)
        return out

    def run():
        with group, gc, concurrent.futures.ThreadPoolExecutor(
                FLEET_THREADS) as ex:
            out = list(ex.map(job, range(len(trees))))
            while gc.cycles < 2:
                time.sleep(0.05)
        return out

    logical = sum(m["bytes"] for m in made)
    gc_log = GcErrors()
    with patched(fleet.Replica, {"backup": record}), gc_log:
        r = product_run(torch, f"{label}: {len(trees)} jobs on "
                        f"{FLEET_REPLICAS} replicas", run, FUSED_PER_PASS,
                        SegmentPasses())
    for rep in group.replicas:  # the killed replica's service threads
        if rep.server.scheduler is not None:
            rep.server.scheduler.stop()
        if rep.server._batcher is not None:
            rep.server._batcher.stop()
    jobs_end = time.perf_counter()
    done = r["out"]
    res = {"jobs": r, "secs": r["secs"], "gibs": logical / GIB / r["secs"],
           "passes": r["passes"], "segments": r["lanes"],
           "busy_s": r["busy_s"], "gc": dict(gc.outcomes),
           "gc_cycles": gc.cycles,
           "failovers": METRICS.fleet_failovers_total.values().get((), 0.0)
           - failovers,
           "sheds": sum(METRICS.svc_shed.values().values()) - sheds_before,
           "shed_waits": len(waits),
           "by_replica": dict(Counter(rid for _, rid in done))}
    hopped = sorted(h for h, a in attempts.items() if len(a) > 1)
    if not killed or not stacks[0][0].crashed or res["failovers"] < 1 \
            or not hopped:
        raise AssertionError(f"{label}: r00's store crashed "
                             f"{stacks[0][0].crashed}, killed {killed}, "
                             f"{res['failovers']} failovers")
    # the index/snapshot window (ROADMAP queue 3, closed): no job attempt
    # and no GC cycle may read a snapshot's tree "not in index", and no
    # GC cycle may fail; one must run
    stale = [e for e in errors + gc_log.messages if "not in index" in e]
    if stale or gc.outcomes.get("error") or not gc.outcomes.get("ok"):
        raise AssertionError(f"{label}: GC outcomes {gc.outcomes} (failed "
                             f"cycles: {gc_log.messages[:3]}); attempts "
                             f"that read a tree not in the index: "
                             f"{stale[:3]}")
    log(f"{label}: {len(done)} jobs, {logical} bytes in {r['secs']:.3f} s "
        f"= {res['gibs']:.4f} GiB/s; {r['passes']} device passes of "
        f"{r['lanes']} segments; completed by replica "
        f"{json.dumps(res['by_replica'])}; {res['failovers']:.0f} "
        f"failovers ({len(hopped)} jobs moved, r00 killed in "
        f"{killed[0]}), {res['sheds']:.0f} sheds, {len(waits)} waits on a "
        f"shed's hint; GC {gc.cycles} cycles, outcomes by kind "
        f"{json.dumps(gc.outcomes)}, none 'not in index'; failed job "
        f"attempts by error {json.dumps(Counter(e.split(':')[0] for e in errors))} "
        f"({card})")

    # -- the dead writer: stamp left, locks taken over, zombie fenced ---
    steps, t_post = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        steps[name] = round(now - t_post[0], 3)
        t_post[0] = now

    if not fs.exists("fleet/r00"):
        raise AssertionError(f"{label}: the killed replica's stamp is gone")
    horizon = Repository.LOCK_STALE_SECONDS + 60
    if full:
        fence(fs, zombie, base / f"{label}-late", horizon, jobs_end)
        lap("takeover, zombie, sweep")
    final = Repository.open(fs, FLEET_PASSWORD, device=DEVICE)
    with final._lock:
        packs = [p for p in final._index.live_packs() if p]
    gone = [p for p in packs if not fs.exists(f"data/{p[:2]}/{p}")]
    if gone:
        raise AssertionError(f"{label}: the index names swept packs {gone}")
    job_ids = {b for b in final.blob_ids()
               if final._entry(b).type == "data"} - pre_ids
    stored = sum(final._entry(b).raw_length for b in job_ids)
    distinct = {}
    for m in made:
        distinct.update(m["files"])
    if stored != sum(distinct.values()):
        raise AssertionError(f"{label}: {stored} distinct data bytes, the "
                             f"oracle has {sum(distinct.values())}")
    res["dedup"] = stored / logical
    lap("dedup")
    log(f"{label}: all {len(packs)} live packs present; dedup ratio "
        f"(distinct data bytes / logical) {res['dedup']:.6f}, equal to the "
        f"oracle's")
    res["root"] = root
    if not full:
        log(f"{label}: seconds after the jobs {json.dumps(steps)}")
        return res
    r = product_run(torch, f"{label} check(read_data=True)",
                    lambda: final.check(read_data=True), VERIFY_PER_PASS,
                    None)
    if r["out"] != []:
        raise AssertionError(f"{label}: check found {r['out'][:3]}")
    res["check"] = r
    lap("check")
    ids = [s for s, _ in final.list_snapshots()]
    pick = {}
    for h in hopped[:1] + sorted(attempts):
        rid = next(rid for rid, how in attempts[h] if how == "ok")
        if rid not in pick.values() and h not in pick:
            pick[h] = rid
    res["restores"] = []
    for h, rid in pick.items():
        j = int(h[3:])
        dst = base / f"{label}-restore-{h}"
        r = product_run(torch, f"{label} restore of {h} (made on {rid})",
                        lambda: restore_snapshot(
                            Repository.open(fs, FLEET_PASSWORD,
                                            device=DEVICE), dst,
                            previous=len(ids) - 1 - ids.index(done[j][0])),
                        VERIFY_PER_PASS, None)
        check_restored(f"{label} restore of {h}", tree_state(trees[j]), dst, 0)
        shutil.rmtree(dst)
        res["restores"].append(r)
    lap("restores")
    if kept not in ids:
        raise AssertionError(f"{label}: the kept snapshot is gone")
    stamp = json.loads(fs.get("fleet/r00"))
    stamp["time"] = (datetime.now(timezone.utc)
                     - timedelta(seconds=horizon)).isoformat()
    fs.put("fleet/r00", json.dumps(stamp).encode())
    # the repair verb, as an operator runs it after the crash
    dry = fleet_verb(torch, root, ["repair", "--dry-run"])
    if dry["rc"] != 0 or dry["report"]["applied"] or \
            "fleet/r00" not in dry["report"]["stale_markers"] or \
            not fs.exists("fleet/r00"):
        raise AssertionError(f"{label}: repair --dry-run gave {dry}")
    rep = fleet_verb(torch, root, ["repair", "--grace-seconds", "0.5"])
    report = rep["report"]
    if rep["rc"] != 0 or not report["applied"] or \
            "fleet/r00" not in report["stale_markers"] or \
            fs.exists("fleet/r00") or report["broken_trees"] or \
            report["unrecoverable_blobs"] or report["gc"] is None:
        raise AssertionError(f"{label}: repair gave {rep}, r00's stamp "
                             f"{'left' if fs.exists('fleet/r00') else 'gone'}")
    res["repair"] = {"dry_run": dry, "apply": rep}
    lap("repair")
    tried = attempts[hopped[0]]
    log(f"{label}: check clean, {len(pick)} restores byte-identical "
        f"({json.dumps(pick)}; {hopped[0]} failed over in {len(tried)} "
        f"attempts: {tried[:2]}...{tried[-1:]}); the repair verb "
        f"(in process): --dry-run exit {dry['rc']} found "
        f"{len(dry['report']['stale_markers'])} stale markers, then exit "
        f"{rep['rc']} cleared r00's stamp (gc swept "
        f"{report['gc']['packs_swept']} packs); seconds after the jobs "
        f"{json.dumps(steps)} ({card})")
    return res


class GcErrors(logging.Handler):
    """Within a ``with`` block, the messages of the continuous GC's
    failed cycles (its "gc cycle failed" warnings)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: list = []
        self._log = logging.getLogger("volsync_tpu_torch.fleet.gc")

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self._log.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._log.removeHandler(self)


def fence(fs, zombie, late: Path, horizon: float, jobs_end: float) -> None:
    """The dead writers after a fleet round: age every lock past
    ``horizon`` (the crashed replica's and the zombie's), a prune takes
    them over and fences the zombie, whose late backup of ``late`` is
    refused (its lock left behind, aged too); then a mark-and-sweep pair,
    once the GC's last manifests have expired (``FLEET_GC_GRACE`` after
    ``jobs_end``) and the pair's own (0.5 s), leaves no pending-delete
    manifest."""
    from volsync_tpu_torch.engine.backup import TreeBackup
    from volsync_tpu_torch.repo.repository import (Repository,
                                                   StaleWriterError)

    aged = age_locks(fs, horizon)
    retry = Repository.open(fs, FLEET_PASSWORD, device=DEVICE)
    retry.default_lock_wait = 10.0
    retry.prune(grace_seconds=0.5)
    if not fs.exists(f"fenced/{zombie.writer_id}"):
        raise AssertionError("fleet: the zombie writer was not fenced")
    late.mkdir()
    (late / "late.bin").write_bytes(b"late" * 1024)
    try:
        TreeBackup(zombie, workers=1).run(late, hostname="zombie-late")
    except StaleWriterError:
        pass
    else:
        raise AssertionError("fleet: the zombie's late publish landed")
    aged += age_locks(fs, horizon)
    time.sleep(max(0.0, FLEET_GC_GRACE + 0.1 - (time.perf_counter()
                                                - jobs_end)))
    retry.prune(grace_seconds=0.5)
    time.sleep(0.6)
    retry.prune(grace_seconds=0.5)
    left = list(fs.list("pending-delete/"))
    if left:
        raise AssertionError(
            "fleet: pending-delete manifests left: "
            + json.dumps([json.loads(fs.get(k)) for k in left])[:2000]
            + "; locks " + json.dumps([json.loads(fs.get(k)) for k
                                       in fs.list("locks/")])[:2000])
    log(f"fleet: {aged} stale locks taken over, the zombie fenced and its "
        f"late backup refused (StaleWriterError); no pending-delete left")


def fleet_cli(root: Path, argv: list) -> tuple:
    """``python -m volsync_tpu_torch.cli`` in a subprocess from the
    checkout on ``root``'s repository: (exit code, --json report or
    None, seconds)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parent)]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "volsync_tpu_torch.cli", argv[0], str(root),
         "--password", FLEET_PASSWORD, "--json", *argv[1:]],
        capture_output=True, text=True, env=env, timeout=300,
        cwd=str(Path(__file__).resolve().parent))
    secs = time.perf_counter() - t0
    try:
        report = json.loads(out.stdout)
    except ValueError:
        report = None
    if report is None:
        log(f"cli {argv[0]}: rc {out.returncode}, no report; stderr "
            f"{out.stderr[-2000:]}")
    return out.returncode, report, secs


def fleet_phase(torch, base: Path, total: int, seed: int, card: str) -> dict:
    """The fleet (BASELINE.json configs[4]: many ReplicationSources served
    by one fleet): ``FLEET_JOBS`` seeded trees of ``total`` bytes (half
    shared across jobs), ``fleet_round`` batched (the shared
    micro-batcher, the CUDA default; with the dead writers fenced, the
    check, restores and repair) and unbatched
    (``VOLSYNC_BATCH_SEGMENTS=0``; the jobs and the dedup oracle) into
    fresh repositories; then on the batched round's repository the
    maintenance verbs: ``scrub`` in a subprocess exits 0, ``repack``
    exits 0, and after one pack body is rotted ``scrub`` exits 2 with
    one unhealable pack (those two through the same ``main`` in process,
    launches counted)."""
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.repo.repository import (DEFAULT_CHUNKER,
                                                   Repository)

    t0 = time.perf_counter()
    shared = np.random.default_rng([seed, 2]).bytes(total // 2)
    trees, made = [], []
    for j in range(FLEET_JOBS):
        trees.append(base / f"job{j:02d}")
        made.append(make_fleet_tree(trees[-1], total, seed + 1 + j, shared,
                                    DEFAULT_CHUNKER["min_size"]))
    logical = sum(m["bytes"] for m in made)
    log(f"fleet: {FLEET_JOBS} trees of {total} bytes ({logical} in all, "
        f"{total // 2} of each shared) made in "
        f"{time.perf_counter() - t0:.1f} s")
    res = {"batched": fleet_round(torch, "fleet batched", base, trees, made,
                                  seed, card)}
    with env_set("VOLSYNC_BATCH_SEGMENTS", "0"):
        res["unbatched"] = fleet_round(torch, "fleet unbatched", base, trees,
                                       made, seed, card, full=False)
    shutil.rmtree(res["unbatched"].pop("root"))
    root = res["batched"].pop("root")
    for k in ("batched", "unbatched"):
        r = res[k]
        if r["passes"] > r["segments"] or (k == "unbatched" and DEVICE ==
                                           "cuda" and r["passes"] !=
                                           r["segments"]):
            raise AssertionError(f"fleet {k}: {r['passes']} passes of "
                                 f"{r['segments']} segments")
    rc, report, secs = fleet_cli(root, ["scrub"])
    if rc != 0 or report is None:
        raise AssertionError(f"fleet: scrub exited {rc}, report {report}")
    cli = {"scrub": {"rc": rc, "report": report, "secs": secs}}
    cli["repack"] = fleet_verb(torch, root, ["repack"])
    if cli["repack"]["rc"] != 0:
        raise AssertionError(f"fleet: repack exited {cli['repack']}")
    fs = FsObjectStore(root)
    repo = Repository.open(fs, FLEET_PASSWORD, device=DEVICE)
    with repo._lock:
        segs = sorted((p, off) for _, (p, _t, off, _n, _r)
                      in repo._index.items() if p and
                      fs.exists(f"data/{p[:2]}/{p}"))
    pack, off = segs[0]
    key = f"data/{pack[:2]}/{pack}"
    body = bytearray(fs.get(key))
    body[off + 5] ^= 0xFF
    fs.put(key, bytes(body))
    cli["scrub_rotted"] = fleet_verb(torch, root, ["scrub"])
    if cli["scrub_rotted"]["rc"] != 2 or cli["scrub_rotted"]["report"].get(
            "unhealable") != 1 or not fs.exists(f"quarantine/{pack}"):
        raise AssertionError(f"fleet: the rotted pack's scrub gave "
                             f"{cli['scrub_rotted']}")
    shutil.rmtree(root)
    log("fleet maintenance verbs (the first scrub as python -m "
        "volsync_tpu_torch.cli in a subprocess, the others through the "
        "same main in process): " + json.dumps(
            {k: {"rc": v["rc"], "s": round(v["secs"], 3),
                 "report": v["report"]} for k, v in cli.items()})
        + f" ({card})")
    res["cli"] = cli
    return res


def fleet_verb(torch, root: Path, argv: list) -> dict:
    """A maintenance verb through ``volsync_tpu_torch.cli.main`` in this
    process on ``root``'s repository, as a ``product_run`` (the verify
    kernels once a verify pass). -> {"rc", "report", "secs", "launches"}."""
    from volsync_tpu_torch import cli

    lines: list = []
    r = product_run(torch, f"fleet {argv[0]} (in process)",
                    lambda: cli.main([argv[0], str(root), "--password",
                                      FLEET_PASSWORD, "--json", *argv[1:]],
                                     out=lines.append, device=DEVICE),
                    {}, None, verify_per_pass=VERIFY_PER_PASS)
    return {"rc": r["out"], "report": json.loads("\n".join(lines)),
            "secs": r["secs"], "launches": r["launches"]}


# -- syncthing: three always-on daemons converge one folder -----------------

#: The folder on A at ``--syncthing-mib`` 256 (counts scale with it):
#: small files log-uniform from 1 B to 128 KiB in 32 directories, files
#: of 4-16 MiB, and one above the 32 MiB streaming cut; plus a symlink, an
#: empty file and an empty directory.
ST_LAYOUT = {"small": 1024, "small_max": 128 << 10, "dirs": 32, "n_mid": 8,
             "mid_min": 4 << 20, "mid_max": 16 << 20,
             "big": (48 << 20) + ODD_TAIL}
#: The daemons' idle backoff ceiling (VOLSYNC_ST_MAX_INTERVAL) here.
ST_MAX_INTERVAL = "0.5"
ST_TIMEOUT = 300.0


def st_layout(mib: float) -> dict:
    scale = mib / 256
    return {**ST_LAYOUT, "small": max(1, round(ST_LAYOUT["small"] * scale)),
            "n_mid": max(1, round(ST_LAYOUT["n_mid"] * scale))}


def make_st_folder(root: Path, layout: dict, seed: int) -> dict:
    """The seeded folder of ``layout`` -> {"small": [rel], "mid": [rel]}."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    dirs = [f"d{i:02d}" for i in range(layout["dirs"])]
    for d in dirs:
        (root / d).mkdir()
    sizes = np.clip(np.exp(rng.uniform(0, np.log(layout["small_max"] + 1),
                                       layout["small"])).astype(np.int64),
                    1, layout["small_max"])
    small = []
    for i, n in enumerate(sizes):
        rel = f"{dirs[i % len(dirs)]}/f{i:04d}.bin"
        (root / rel).write_bytes(rng.bytes(int(n)))
        if i % 7 == 0:
            os.chmod(root / rel, 0o600)
        small.append(rel)
    mid = []
    for i in range(layout["n_mid"]):
        rel = f"m{i:02d}.bin"
        n = int(rng.integers(layout["mid_min"], layout["mid_max"] + 1))
        (root / rel).write_bytes(rng.bytes(n))
        mid.append(rel)
    with open(root / "big.bin", "wb") as f:
        left = layout["big"]
        while left:
            piece = rng.bytes(min(left, 16 << 20))
            f.write(piece)
            left -= len(piece)
    (root / "empty").write_bytes(b"")
    (root / "empty-dir").mkdir()
    os.symlink(small[0], root / "link")
    return {"small": small, "mid": mid}


def st_state(root: Path) -> dict:
    """rel -> (kind, mode, size, sha256, mtime_ns) of files, (kind,
    mode) of directories, (kind, target) of symlinks."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            p = Path(dirpath) / name
            st = p.lstat()
            rel = p.relative_to(root).as_posix()
            if p.is_symlink():
                out[rel] = ("link", os.readlink(p))
            elif p.is_dir():
                out[rel] = ("dir", st.st_mode & 0o7777)
            else:
                h = hashlib.sha256()
                with open(p, "rb") as f:
                    while piece := f.read(8 << 20):
                        h.update(piece)
                out[rel] = ("file", st.st_mode & 0o7777, st.st_size,
                            h.hexdigest(), st.st_mtime_ns)
    return out


class StCluster:
    """The two calls a daemon makes of its cluster (``JobContext.cluster``
    is duck-typed): ``try_get`` a Service, ``update_status`` it with the
    port the daemon bound."""

    def __init__(self):
        self._lock = threading.Lock()
        self.services: dict = {}

    def try_get(self, kind, namespace, name):
        with self._lock:
            return self.services.setdefault(name, types.SimpleNamespace(
                status=types.SimpleNamespace(bound_port=None,
                                             cluster_ip=None)))

    def update_status(self, obj):
        pass

    def port(self, name: str) -> int:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            port = self.try_get("Service", "", name).status.bound_port
            if port:
                return port
            time.sleep(0.02)
        raise AssertionError(f"syncthing: {name} never bound a port")


class StDaemon:
    """One daemon: ``syncthing_entrypoint`` in a thread with a
    ``JobContext`` (device None: CUDA) over its data and config
    directories, its device key and API key kept across restarts."""

    def __init__(self, base: Path, name: str, seed: int):
        from volsync_tpu_torch.movers.syncthing import transport

        rng = np.random.default_rng(seed)
        self.name, self.base = name, base
        self.data = base / name / "data"
        self.config = base / name / "config"
        self.config.mkdir(parents=True)
        self.key = transport.generate_device_key()
        self.apikey = rng.bytes(32)
        self.id = transport.device_id_from_private(self.key)

    def start(self, cluster: StCluster) -> "StDaemon":
        from volsync_tpu_torch.cluster.runner import JobContext
        from volsync_tpu_torch.movers.syncthing import entry

        self.data.mkdir(parents=True, exist_ok=True)
        for svc in ("api", "data"):  # a restart binds new ports
            cluster.try_get("Service", "", f"{self.name}-{svc}") \
                .status.bound_port = None
        self.ctx = JobContext(
            name=self.name, namespace="chip-smoke",
            env={"SERVICE_API": f"{self.name}-api",
                 "SERVICE_DATA": f"{self.name}-data",
                 "VOLSYNC_ST_MAX_INTERVAL": ST_MAX_INTERVAL},
            mounts={"data": self.data, "config": self.config},
            secrets={"secret": {"apikey": self.apikey, "cert": self.key}},
            stop_event=threading.Event(), cluster=cluster, kind="Deployment",
            device=None if DEVICE == "cuda" else DEVICE)
        self.rc = None

        def run():
            self.rc = entry.syncthing_entrypoint(self.ctx)

        self.thread = threading.Thread(target=run, name=f"st-{self.name}",
                                       daemon=True)
        self.thread.start()
        self.api_port = cluster.port(f"{self.name}-api")
        self.data_port = cluster.port(f"{self.name}-data")
        return self

    def peer(self, other: "StDaemon", introducer: bool = False) -> dict:
        return {"id": other.id,
                "address": f"tcp://127.0.0.1:{other.data_port}",
                "introducer": introducer}

    def publish(self, devices: list) -> None:
        from volsync_tpu_torch.movers.syncthing.apiclient import (
            SyncthingConnection)

        SyncthingConnection("127.0.0.1", self.api_port,
                            self.apikey).publish_config({"devices": devices})

    def fetch(self):
        from volsync_tpu_torch.movers.syncthing.apiclient import (
            SyncthingConnection)

        return SyncthingConnection("127.0.0.1", self.api_port,
                                   self.apikey).fetch()

    def index(self) -> dict:
        """The folder index the daemon last saved (its config volume)."""
        try:
            return json.loads((self.config / "index.json").read_text())
        except (OSError, ValueError):
            return {"entries": {}, "max_version": 0}

    def stop(self) -> None:
        self.ctx.stop_event.set()
        self.thread.join(timeout=30)
        if self.thread.is_alive() or self.rc != 0:
            raise AssertionError(f"syncthing {self.name}: rc {self.rc}")


def st_hashing(sizes: list, stream_above: int) -> dict:
    """What ``_hash_file`` launches for files of ``sizes``: an empty file
    nothing, one of at most ``stream_above`` bytes one ``hash_spans``
    pass (K1, span-form ``sha256_slices``, ``merkle_roots``), a larger
    one K1 once a streamed 32 MiB segment that holds a full page."""
    spans = sum(1 for n in sizes if 0 < n <= stream_above)
    big = [n for n in sizes if n > stream_above]
    launches = {k: v * spans for k, v in VERIFY_PER_PASS.items()}
    launches["sha256_pages"] += sum(
        n // RCLONE_SEGMENT + (n % RCLONE_SEGMENT >= 4096) for n in big)
    return {"spans": spans, "streamed": len(big), "launches": launches}


def st_run(torch, label: str, daemons: list, act, card: str) -> dict:
    """``act()`` (starting, configuring or editing the daemons), then wait
    until every daemon's saved index equals the others' and the first's
    has moved from where it was before ``act()``, with every
    launch count set to 0 just before, the card traced, every
    ``_hash_file`` call's size and every pulled byte recorded. The
    ``hash_spans`` and ``hash_file_streaming`` calls must be those the
    recorded sizes give, and on the card the launches exactly
    ``st_hashing``'s."""
    from volsync_tpu_torch.engine import chunker
    from volsync_tpu_torch.movers.syncthing import entry
    from volsync_tpu_torch.obs import span_totals
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts

    sizes, pulled = [], []
    host = {"hash": 0.0, "pull": 0.0}
    lock = threading.Lock()
    spans, streamed = PassCounter(), PassCounter()

    def hashed(fn):
        def wrapper(path, device):
            n = path.stat().st_size
            t1 = time.perf_counter()
            out = fn(path, device)
            with lock:
                sizes.append(n)
                host["hash"] += time.perf_counter() - t1
            return out
        return wrapper

    def fetched(fn):
        def wrapper(self, ch, rel):
            t1 = time.perf_counter()
            tmp = fn(self, ch, rel)
            with lock:
                host["pull"] += time.perf_counter() - t1
                if tmp is not None:
                    pulled.append(tmp.stat().st_size)
            return tmp
        return wrapper

    start = daemons[0].index()["entries"]
    before = span_totals()
    for k in KERNELS:
        k.launches = 0
    with patched(entry, {"_hash_file": hashed}), \
            patched(entry.SyncthingDaemon, {"_fetch_to_temp": fetched}), \
            patched(chunker, {"hash_spans": spans.wrap,
                              "hash_file_streaming": streamed.wrap}), \
            device_trace(torch) as traced:
        sync(torch)
        t0 = time.perf_counter()
        act()
        deadline = time.monotonic() + ST_TIMEOUT
        while True:
            indexes = [d.index()["entries"] for d in daemons]
            if indexes[0] and indexes[0] != start and \
                    all(i == indexes[0] for i in indexes[1:]):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"{label}: no convergence in "
                                     f"{ST_TIMEOUT} s")
            time.sleep(0.05)
        sync(torch)
        secs = time.perf_counter() - t0
    launches = launch_counts()
    want = st_hashing(sizes, entry._STREAM_ABOVE)
    if (spans.n, streamed.n) != (want["spans"], want["streamed"]) or (
            DEVICE == "cuda" and launches != {k: want["launches"].get(k, 0)
                                              for k in launches}):
        raise AssertionError(f"{label}: {spans.n} hash_spans and "
                             f"{streamed.n} streamed hashes, launches "
                             f"{launches}; expected {want}")
    busy = traced["busy_s"]
    res = {"secs": secs, "hashed": len(sizes), "hashed_bytes": sum(sizes),
           "pulled": len(pulled), "pulled_bytes": sum(pulled),
           "launches": launches, "busy_s": busy,
           "host": {k: round(v, 4) for k, v in host.items()},
           "spans": spans_since(before), "index": indexes[0]}
    log(f"{label}: converged in {secs:.3f} s; {len(sizes)} files hashed "
        f"({sum(sizes)} bytes; {spans.n} hash_spans, {streamed.n} "
        f"streamed), {len(pulled)} files pulled ({sum(pulled)} bytes), "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}; "
        f"card busy "
        + (f"{busy:.4f} s ({100 * busy / secs:.2f}% of the wall; seconds "
           f"by kind {json.dumps(traced['by_kind'])})" if busy is not None
           else "not measured")
        + f"; host seconds in _hash_file and in pulls (summed over the "
          f"daemons' threads) {json.dumps(res['host'])}, by span "
          f"{json.dumps(res['spans'])} ({card})")
    return res


def st_check(label: str, daemons: list, index: dict) -> dict:
    """Every folder equals the first (bytes, modes, mtimes, symlink
    targets, empty directories) and every live file's index digest is
    hashlib's blob id of its bytes ("" for an empty file)."""
    from volsync_tpu_torch.repo.blobid import blob_id

    states = [st_state(d.data) for d in daemons]
    for d, s in zip(daemons[1:], states[1:]):
        if s != states[0]:
            diff = sorted(set(s.items()) ^ set(states[0].items()))[:3]
            raise AssertionError(f"{label}: {d.name}'s folder differs, "
                                 f"e.g. {diff}")
    root = daemons[0].data
    bad = [rel for rel, e in index.items()
           if e.get("type") == "file" and not e.get("deleted")
           and e["digest"] != ((lambda b: blob_id(b) if b else "")(
               (root / rel).read_bytes()))]
    live = {rel for rel, e in index.items() if not e.get("deleted")}
    if bad or live != set(states[0]):
        raise AssertionError(f"{label}: digests unlike hashlib {bad[:3]}, "
                             f"index paths {len(live)} against "
                             f"{len(states[0])} in the folder")
    return states[0]


def st_edit(root: Path, made: dict, seed: int) -> dict:
    """B's edits: 2% of the small files rewritten at new sizes, 2%
    deleted, one in 64 added in a new directory, one mid file turned into
    a directory holding a file. -> the rels of each kind."""
    rng = np.random.default_rng(seed)
    small = made["small"]
    k = max(1, len(small) // 50)
    picks = rng.permutation(len(small))
    rewrite = [small[i] for i in picks[:k]]
    delete = [small[i] for i in picks[k: 2 * k]]
    for rel in rewrite:
        (root / rel).write_bytes(rng.bytes(int(rng.integers(1, 64 << 10))))
    for rel in delete:
        (root / rel).unlink()
    (root / "added").mkdir()
    added = []
    for i in range(max(1, len(small) // 64)):
        rel = f"added/a{i:02d}.bin"
        (root / rel).write_bytes(rng.bytes(int(rng.integers(1, 128 << 10))))
        added.append(rel)
    turned = made["mid"][0]
    (root / turned).unlink()
    (root / turned).mkdir()
    (root / turned / "inside.bin").write_bytes(rng.bytes(4097))
    return {"rewrite": rewrite, "delete": delete, "added": added,
            "turned": [turned]}


def syncthing_phase(torch, base: Path, layout: dict, seed: int,
                    card: str) -> dict:
    """The syncthing mover's daemon on the port (ref
    movers/syncthing/entry.py): three daemons A, B and C through
    ``syncthing_entrypoint`` on 127.0.0.1, A knowing B and C, B and C
    knowing only A as their introducer. A's seeded folder converges to B
    and C (``st_run``: launches exact from the files hashed); a device
    none of them knows is refused at A's handshake; an unchanged rescan
    hashes nothing and launches nothing; B's edits (``st_edit``: rewrites,
    deletes, adds, a file turned into a directory) converge back to A
    and C; then, with the daemons stopped, one file is written on A and
    on C, the daemons restart, and last-writer-wins settles it by
    (version, device id) on all three. After each run every folder is
    equal and every digest hashlib's blob id (``st_check``)."""
    from volsync_tpu_torch.movers.rsync.channel import ChannelError
    from volsync_tpu_torch.movers.syncthing import entry, transport
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts

    a, b, c = (StDaemon(base, n, seed + i) for i, n in enumerate("ABC"))
    t0 = time.perf_counter()
    made = make_st_folder(a.data, layout, seed)
    total = sum(v[2] for v in st_state(a.data).values() if v[0] == "file")
    log(f"syncthing: folder of {len(made['small']) + len(made['mid']) + 2} "
        f"files, {total} bytes made on A in "
        f"{time.perf_counter() - t0:.1f} s")
    cluster = StCluster()
    daemons = [a, b, c]
    res = {"bytes": total}

    def wire():
        a.publish([a.peer(b), a.peer(c)])
        b.publish([b.peer(a, introducer=True)])
        c.publish([c.peer(a, introducer=True)])

    def start_all():
        for d in daemons:
            d.start(cluster)
        wire()

    res["initial"] = st_run(torch, "syncthing initial (A to B and C)",
                            daemons, start_all, card)
    st_check("syncthing initial", daemons, res["initial"]["index"])
    introduced = {d.name: sorted(p.get("introduced_by", "")[:8]
                                 for p in d.fetch().config["devices"])
                  for d in (b, c)}
    stranger = transport.generate_device_key()
    try:
        transport.connect_device("127.0.0.1", a.data_port, stranger, a.id,
                                 timeout=5.0)
    except ChannelError:
        pass
    else:
        raise AssertionError("syncthing: A accepted a device it does not "
                             "know")
    hashed = PassCounter()
    for k in KERNELS:
        k.launches = 0
    with patched(entry, {"_hash_file": hashed.wrap}):
        time.sleep(3 * float(ST_MAX_INTERVAL) + 1)
    if hashed.n or any(launch_counts().values()):
        raise AssertionError(f"syncthing: an unchanged folder re-hashed "
                             f"{hashed.n} files, launches {launch_counts()}")
    log(f"syncthing: introducer: B's and C's peers introduced by "
        f"{json.dumps(introduced)}; an unknown device refused at A's "
        f"handshake; idle rescans over {3 * float(ST_MAX_INTERVAL) + 1} s "
        f"hashed nothing and launched nothing")

    edits = {}
    res["edits"] = st_run(torch, "syncthing edits (B to A and C)", daemons,
                          lambda: edits.update(st_edit(b.data, made,
                                                       seed + 7)), card)
    st_check("syncthing edits", [b, a, c], res["edits"]["index"])

    for d in daemons:
        d.stop()
    rel = made["small"][1]
    stamps = {}
    for d, fill in ((a, b"A"), (c, b"C")):
        (d.data / rel).write_bytes(fill * 1000)
        stamps[d.name] = (d.index()["max_version"] + 1, d.id)
    winner = max(stamps, key=stamps.get)
    res["conflict"] = st_run(torch, "syncthing conflict (A and C restart)",
                             daemons, start_all, card)
    state = st_check("syncthing conflict", daemons,
                     res["conflict"]["index"])
    got = (a.data / rel).read_bytes()
    ent = res["conflict"]["index"][rel]
    if got != winner.encode() * 1000 or \
            (ent["version"], ent["modified_by"]) != stamps[winner]:
        raise AssertionError(f"syncthing conflict: {rel} holds {got[:4]!r} "
                             f"by {ent['modified_by'][:8]}, expected "
                             f"{winner}'s")
    for d in daemons:
        d.stop()
    res["edits_made"] = {k: len(v) for k, v in edits.items()}
    log(f"syncthing: all three folders equal ({len(state)} paths: bytes, "
        f"modes, mtimes, symlink, empty directory) after each run; edits "
        f"{json.dumps(res['edits_made'])}; the same-time write on A and C "
        f"went to {winner} by (version, device id) {json.dumps(stamps)} "
        f"({card})")
    for r in ("initial", "edits", "conflict"):
        res[r].pop("index")
    return res


# -- multi-device: the sharded engine on a mesh of one card ------------------

#: Shards of the mesh phase's meshes, all on the one card: every
#: per-shard kernel, seam, gather and global table runs for real.
MESH_SHARDS = 4
#: The leaf and byte paths' prefixes of the align=64 and align=1 volumes.
MESH_ALIGN64 = 256 << 20
MESH_ALIGN1 = 32 << 20
#: The sharded step's [W, L] on a (2, 2) mesh, its block length, and the
#: fixed-block shape sha256_fixed_blocks is timed at.
MESH_STEP = (4, 16 << 20)
MESH_BLOCK = 64 << 10
FIXED_SHAPE = (1024, 64 << 10)
#: The shape sha256_fixed_blocks is held against its twin at.
FIXED_TWIN_SHAPE = (1024, 4 << 10)


def stream_head(stream, total: int):
    """``stream_prefix`` that keeps only the fresh blocks the prefix
    uses, so the whole volume's host memory can go."""
    head = stream_prefix(stream, total)
    if head is stream:
        return stream
    nb = -(-total // BLOCK)
    used = {k for k in stream.plan[:nb] if k >= 0}
    head.plan = stream.plan[:nb]
    head.unique = [u if i in used else None
                   for i, u in enumerate(stream.unique)]
    return head


def mesh_cell(label: str, params, stream, total: int, run: dict) -> tuple:
    """A mesh phase cell: (label, params, the stream's first ``total``
    bytes, their chunks from the stream phase ``run``)."""
    head = stream_head(stream, total)
    return label, params, head, prefix_chunks(run["results"], head)


def mesh_hasher(params, shards: int):
    """A ``MeshChunkHasher`` over ``shards`` shards of the phase's device,
    or (0) over the default mesh: every CUDA device of the process (one
    CPU shard in a rehearsal)."""
    from volsync_tpu_torch.parallel.sharded_chunker import (
        MeshChunkHasher,
        make_stream_mesh,
    )

    if shards:
        return MeshChunkHasher(params, mesh=make_stream_mesh(
            [DEVICE] * shards))
    if DEVICE == "cuda":
        return MeshChunkHasher(params)
    return MeshChunkHasher(params, mesh=make_stream_mesh([DEVICE]))


@contextlib.contextmanager
def mesh_counting(hasher):
    """Counts the mesh hasher's device passes (fused passes, or leaf
    stages on the other paths), the fused passes' tail launches and the
    verify passes (``hash_spans``) within the block; yields
    ``want(launches)`` -> the launch counts those passes must make."""
    from volsync_tpu_torch.engine import chunker
    from volsync_tpu_torch.parallel import sharded_chunker as sc

    fused = hasher.params.align == 4096
    passes, tails, verify = PassCounter(), PassCounter(), PassCounter()
    S = hasher.n_shards

    def want(launches: dict) -> dict:
        per = ({"sha256_pages": S * passes.n, "fastcdc_walk": passes.n,
                "sha256_slices": tails.n, "merkle_roots": passes.n}
               if fused else {"sha256_slices": S * passes.n})
        return {k: per.get(k, 0) + VERIFY_PER_PASS.get(k, 0) * verify.n
                for k in launches}

    want.passes, want.tails, want.verify = passes, tails, verify
    with patched(hasher, {"_fused_pass" if fused else "_span_roots":
                          passes.wrap}), \
            patched(sc, {"tail_leaves_into": tails.wrap}), \
            patched(chunker, {"hash_spans": verify.wrap}):
        yield want


def mesh_stream(torch, label: str, stream, params, want: list,
                hasher) -> dict:
    """One pass of ``stream_chunk_batches`` through a mesh hasher with
    every launch count set to 0 just before and read just after: the
    chunks must be ``want`` (the single-device engine's), and on the
    card each kernel must launch exactly as the passes need (fused: K1
    once a shard, one walk, one ``merkle_roots``, one ``sha256_slices``
    a pass with a partial tail leaf and never more than one; the other
    paths: one ``sha256_slices`` a shard a pass)."""
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts

    for k in KERNELS:
        k.launches = 0
    with mesh_counting(hasher) as expect:
        results, _, secs = stream_once(torch, stream, params, hasher)
    launches = launch_counts()
    if results != want:
        bad = next((i for i, (a, b) in enumerate(zip(results, want))
                    if a != b), min(len(results), len(want)))
        raise AssertionError(f"{label}: chunks differ from the single-device "
                             f"engine's at chunk {bad} ({len(results)} vs "
                             f"{len(want)})")
    passes, tails = expect.passes.n, expect.tails.n
    if DEVICE == "cuda" and (launches != expect(launches) or tails > passes
                             or not passes):
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expect(launches)} over {passes} passes with "
                             f"{tails} tails")
    gibs = stream.total / GIB / secs
    log(f"{label}: {stream.total} bytes, {len(results)} chunks equal to the "
        f"single-device engine's in {secs:.3f} s = {gibs:.4f} GiB/s over "
        f"{passes} passes ({tails} with a tail leaf); launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}, per pass "
        + json.dumps({k: v / max(passes, 1) for k, v in launches.items()
                      if v}))
    return {"gibs": gibs, "secs": secs, "passes": passes, "tails": tails,
            "launches": launches}


def host_dense_mask(x: np.ndarray, params) -> np.ndarray:
    """numpy strict per-position candidate mask of one stream (the gear
    table, shift-doubling on uint32 words), as the step computes it."""
    h = params.table[x]
    for m in (1, 2, 4, 8, 16):
        h[m:] += h[:-m] << np.uint32(m)
    return (h & np.uint32(params.dense_mask_s)) == 0


def fixed_blocks_entry(torch, stats, seed: int) -> None:
    """``sha256_fixed_blocks`` (one ``sha256_slices`` launch) at [B, L]
    (``FIXED_SHAPE``): every one of its B digests equal to hashlib, an
    independent exact oracle, on seeded blocks; timed by graph replay and
    eagerly, bounded by its work and its per-warp floor (each lane one
    L-byte message). Its twin steps through the message blocks of all
    lanes one at a time, which at 1,025 blocks a lane costs tens of
    seconds on the card, so the kernel is held against its twin at
    ``FIXED_TWIN_SHAPE`` (as many lanes, 65 blocks a lane), where
    ``plain_ms`` is timed."""
    from volsync_tpu_torch.ops import sha256 as sha
    from volsync_tpu_torch.parallel.engine import sha256_fixed_blocks

    B, L = shape = FIXED_SHAPE
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    blocks = torch.randint(0, 256, (B, L), dtype=torch.uint8, device=DEVICE,
                           generator=gen)
    got = sha256_fixed_blocks(blocks)
    host = blocks.cpu().numpy()
    dig = got.cpu().numpy().view(np.uint32).astype(">u4")
    for i in range(B):
        if dig[i].tobytes() != hashlib.sha256(host[i].tobytes()).digest():
            raise AssertionError(f"sha256_fixed_blocks at {shape}: block {i} "
                                 f"differs from hashlib")
    small = blocks[:FIXED_TWIN_SHAPE[0], :FIXED_TWIN_SHAPE[1]].contiguous()
    tb, tl = small.shape
    got_small = sha256_fixed_blocks(small)
    starts = torch.arange(tb, dtype=torch.int64, device=DEVICE) * tl
    lengths = torch.full((tb,), tl, dtype=torch.int64, device=DEVICE)
    sync(torch)
    t0 = time.perf_counter()
    want = sha._sha256_chunks_plain(small.reshape(-1), starts, lengths,
                                    max_len=tl)
    sync(torch)
    plain_s = time.perf_counter() - t0
    st = stats["sha256_slices_fixed"]
    st["err"] = max(st["err"], max_abs_err(torch, got_small, want))
    if not torch.equal(got_small, want):
        raise AssertionError(f"sha256_fixed_blocks at [{tb}, {tl}] differs "
                             f"from its twin")
    st["plain_shape"] = f"{tb}x{tl}"
    starts = torch.arange(B, dtype=torch.int64, device=DEVICE) * L
    lengths = torch.full((B,), L, dtype=torch.int64, device=DEVICE)

    def run():
        return sha256_fixed_blocks(blocks)

    ms = time_ms(torch, run, 5)
    eager = time_ms(torch, run, 5, graph=False)
    w = slice_work(torch, lengths, sha.slice_blocks(L))
    b = lanes_bound(B, sha.SLICES_THREADS, w["lane_ops"], sha_bound(
        w["data_blocks"], w["pad_blocks"], w["bytes"] + B * 40))
    st["ms"].append(ms)
    st["eager_ms"].append(eager)
    st["plain_ms"].append(plain_s * 1e3)
    set_bound(st, b)
    st["shapes"] = {f"{B}x{L}": {"lanes": B, "blocks": w["data_blocks"]
                                 + w["pad_blocks"], "floor_ms":
                                 b["floor_ms"]}}
    log(f"sha256_slices (sha256_fixed_blocks, [{B}, {L}]): {B} lanes of "
        f"{w['longest']} blocks, every digest equal to hashlib; kernel "
        f"{ms:.4f} ms (eager {eager:.4f}); equal to its twin at [{tb}, "
        f"{tl}], twin {plain_s * 1e3:.1f} ms there; bound "
        f"{b['bound_ms']:.4f} ms "
        f"({b['bound_kind']}; per-warp floor {b['floor_ms']:.4f} ms, work "
        f"{sha_bound(w['data_blocks'], w['pad_blocks'], w['bytes'])[0]:.4f}"
        f" ms)")


def mesh_step_check(torch, stats, seed: int, card: str) -> dict:
    """``make_chunk_hash_step`` on a (2, 2) mesh of the phase's device
    over a seeded ``MESH_STEP`` [W, L] of ``MESH_BLOCK``-byte blocks
    (duplicate blocks in it): one ``sha256_slices``
    a shard and nothing else; every block digest equal to hashlib, the
    candidate mask to a numpy gear oracle and, row by row, digests and
    candidate count to ``chunk_hash_block`` on the device; the bloom and
    the stats to a host computation. Then ``fixed_blocks_entry``."""
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts
    from volsync_tpu_torch.ops.gearcdc import DEFAULT_PARAMS as p
    from volsync_tpu_torch.parallel import (
        chunk_hash_block,
        make_chunk_hash_step,
        make_mesh,
    )

    W, L = MESH_STEP
    block = MESH_BLOCK
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    host = torch.randint(0, 256, (W, L), dtype=torch.uint8, device=DEVICE,
                         generator=gen).cpu().numpy()
    host[1, :block] = host[0, :block]
    host[3, 5 * block:6 * block] = host[0, :block]
    mesh = make_mesh([DEVICE] * 4)
    step = make_chunk_hash_step(mesh, block_len=block, params=p)
    for k in KERNELS:
        k.launches = 0
    sync(torch)
    t0 = time.perf_counter()
    out = step(host)
    sync(torch)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    expect = {k: (mesh.size if k == "sha256_slices" else 0)
              for k in launches}
    if DEVICE == "cuda" and launches != expect:
        raise AssertionError(f"step: launches {launches}, expected {expect}")
    nb = L // block
    digests = out["digests"].cpu().numpy().view(np.uint32)
    mask = out["cand_mask"].cpu().numpy()
    if digests.shape != (W, nb, 8) or mask.shape != (W, L):
        raise AssertionError(f"step: shapes {digests.shape} {mask.shape}")
    raw = np.frombuffer(b"".join(
        hashlib.sha256(host[w, b * block:(b + 1) * block]).digest()
        for w in range(W) for b in range(nb)), ">u4").reshape(W, nb, 8)
    if not np.array_equal(digests, raw):
        raise AssertionError("step: a block digest differs from hashlib")
    want_mask = np.stack([host_dense_mask(host[w], p) for w in range(W)])
    if not np.array_equal(mask, want_mask):
        raise AssertionError("step: the candidate mask differs from the "
                             "numpy gear oracle")
    for w in range(W):
        dig, count = chunk_hash_block(torch.from_numpy(host[w]).to(DEVICE),
                                      block_len=block, params=p)
        if not np.array_equal(dig.cpu().numpy().view(np.uint32),
                              digests[w]) or int(count) != int(mask[w].sum()):
            raise AssertionError(f"step: row {w} differs from "
                                 f"chunk_hash_block on the device")
    wave, seq = mesh.devices.shape
    bloom = np.zeros((1 << 20,), np.int64)
    for s in range(mesh.size):
        wi, si = divmod(s, seq)
        rows = slice(wi * W // wave, (wi + 1) * W // wave)
        cols = slice(si * nb // seq, (si + 1) * nb // seq)
        bloom[np.unique(raw[rows, cols, 0].astype(np.int64)
                        & ((1 << 20) - 1))] += 1
    distinct = int((bloom > 0).sum())
    want_stats = {"total_bytes": W * L,
                  "total_candidates": int(want_mask.sum()),
                  "distinct_block_estimate": distinct,
                  "duplicate_block_estimate": W * nb - distinct}
    if not np.array_equal(out["bloom"].cpu().numpy(), bloom) \
            or out["stats"] != want_stats:
        raise AssertionError(f"step: bloom or stats {out['stats']} differ "
                             f"from the host's {want_stats}")
    log(f"step (make_chunk_hash_step, (2, 2) mesh of {DEVICE}, [{W}, {L}], "
        f"{block}-byte blocks): {secs:.3f} s = {W * L / GIB / secs:.4f} "
        f"GiB/s, launches {json.dumps({k: v for k, v in launches.items() if v})}; "
        f"{W * nb} digests equal hashlib, mask equal the oracle, stats "
        f"{json.dumps(out['stats'])} ({card})")
    fixed_blocks_entry(torch, stats, seed + 1)
    return {"secs": secs, "launches": launches, "stats": out["stats"]}


def multihost_check() -> dict:
    """``init_distributed`` with nothing configured: the one-process
    summary, and ``require=True`` refuses."""
    from volsync_tpu_torch.parallel import multihost

    dev = None if DEVICE == "cuda" else DEVICE
    info = multihost.init_distributed(device=dev)
    want = {"process_index": 0, "process_count": 1, "local_devices": 1,
            "global_devices": 1}
    if info != want:
        raise AssertionError(f"init_distributed() -> {info}, expected "
                             f"{want}")
    try:
        multihost.init_distributed(require=True, device=dev)
    except RuntimeError as e:
        if "explicitly requested" not in str(e):
            raise
    else:
        raise AssertionError("init_distributed(require=True) did not raise")
    log(f"multihost: init_distributed() -> {json.dumps(info)}; "
        f"require=True refused")
    return info


def mesh_phase(torch, cells: list, stats, seed: int, card: str) -> dict:
    """The sharded engine over the stream phases' volumes. ``cells``:
    (label, params, head stream, its single-device chunks). Each head
    goes through the single-device engine (timed beside the mesh), a
    ``MESH_SHARDS``-shard mesh of the phase's device and, on the fused
    path, the default mesh; chunks and ids must equal the single-device
    engine's. Then the sharded step and ``init_distributed``."""
    out: dict = {}
    for label, params, head, want in cells:
        per = {4096: FUSED_PER_PASS, 64: SPLIT_PER_PASS}.get(
            params.align, LEGACY_PER_PASS)
        single = drive(torch, head, params, per, f"mesh {label}, single "
                       f"device")
        if single["results"] != want:
            raise AssertionError(f"mesh {label}: the single-device engine "
                                 f"gave other chunks over the prefix")
        rec = {"single": single["gibs"], "mesh": mesh_stream(
            torch, f"mesh {label}, {MESH_SHARDS} shards of {DEVICE}", head,
            params, want, mesh_hasher(params, MESH_SHARDS))}
        if params.align == 4096:
            rec["default"] = mesh_stream(
                torch, f"mesh {label}, the default mesh", head, params,
                want, mesh_hasher(params, 0))
        log(f"mesh {label} GiB/s over {head.total} bytes: single device "
            f"{rec['single']:.4f}, {MESH_SHARDS} shards "
            f"{rec['mesh']['gibs']:.4f}"
            + (f", default mesh {rec['default']['gibs']:.4f}"
               if "default" in rec else "") + f" ({card})")
        out[label] = rec
    out["step"] = mesh_step_check(torch, stats, seed, card)
    out["multihost"] = multihost_check()
    return out


def mesh_tree_check(torch, base: Path, src: Path, want_tree: str,
                    card: str) -> dict:
    """``TreeBackup`` of ``src`` through a ``MESH_SHARDS``-shard mesh
    hasher into a fresh encrypted repository, and the restic entry's
    backup with ``VOLSYNC_ENGINE=mesh`` (the default mesh): both give
    ``want_tree``, the single-device backup's root tree; the TreeBackup's
    launches are exact (the mesh passes' and the verify passes')."""
    from volsync_tpu_torch.cluster.runner import JobContext
    from volsync_tpu_torch.engine.backup import TreeBackup
    from volsync_tpu_torch.movers.restic import entry
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts
    from volsync_tpu_torch.ops.gearcdc import DEFAULT_PARAMS
    from volsync_tpu_torch.parallel.sharded_chunker import MeshChunkHasher
    from volsync_tpu_torch.repo.repository import Repository

    def tree_of(path: Path) -> str:
        repo = Repository.open(FsObjectStore(path), EC_PASSWORD,
                               device=DEVICE)
        (_, meta), = repo.list_snapshots()
        return meta["tree"]

    hasher = mesh_hasher(DEFAULT_PARAMS, MESH_SHARDS)
    repo = Repository.init(FsObjectStore(base / "mesh-repo"), EC_PASSWORD,
                           device=DEVICE)
    for k in KERNELS:
        k.launches = 0
    sync(torch)
    t0 = time.perf_counter()
    with mesh_counting(hasher) as expect:
        TreeBackup(repo, hasher=hasher).run(src, hostname="chip-smoke")
    sync(torch)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    if DEVICE == "cuda" and launches != expect(launches):
        raise AssertionError(f"mesh TreeBackup: launches {launches}, "
                             f"expected {expect(launches)}")
    tree = tree_of(base / "mesh-repo")
    ctx = JobContext(name="restic", namespace="chip-smoke", env={
        "RESTIC_REPOSITORY": f"file://{base / 'mesh-entry'}",
        "RESTIC_PASSWORD": EC_PASSWORD, "HOSTNAME": "chip-smoke",
        "VOLSYNC_ENGINE": "mesh"}, mounts={"data": src}, secrets={},
        stop_event=threading.Event(), device=DEVICE)
    t1 = time.perf_counter()
    with env_set("VOLSYNC_TRACE_DIR", None):
        rc = entry.restic_entrypoint(ctx)
    entry_secs = time.perf_counter() - t1
    hashers = [h for h in entry._MESH_HASHERS.values()
               if isinstance(h, MeshChunkHasher)]
    entry_tree = tree_of(base / "mesh-entry")
    if rc != 0 or tree != want_tree or entry_tree != want_tree \
            or not hashers:
        raise AssertionError(f"mesh backups: rc {rc}, trees {tree} and "
                             f"{entry_tree}, expected {want_tree}")
    for d in ("mesh-repo", "mesh-entry"):
        shutil.rmtree(base / d, ignore_errors=True)
    log(f"mesh TreeBackup ({MESH_SHARDS} shards of {DEVICE}): {secs:.3f} s, "
        f"{expect.passes.n} mesh passes and {expect.verify.n} verify "
        f"passes, launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}; restic "
        f"entry with VOLSYNC_ENGINE=mesh ({hashers[0].n_shards} shard(s)) "
        f"{entry_secs:.3f} s; both give the single-device root tree "
        f"({card})")
    return {"secs": secs, "launches": launches, "entry_secs": entry_secs}


# -- operator: volsync-manager's stack, CRs reconciled into Jobs on the card --

#: The operator phase's stack: one manager with 8 reconcile workers and one
#: runner with 16 (``bench_scale.py`` ``scenario_fleet``, the reference's
#: scale proof of BASELINE.json configs[4]), every mover registered.
OPERATOR_RUNNER_WORKERS = 16
OPERATOR_MANAGER_WORKERS = 8
OPERATOR_MOVERS = "rsync,rclone,restic,syncthing"
OPERATOR_NS = "default"
OPERATOR_PASSWORD = "smoke-password"
#: Fleet CRs whose latest snapshot a restic ReplicationDestination restores.
OPERATOR_RESTORES = 4
#: The rsync pair's tree, the rclone pair's small files and the syncthing
#: pair's folder.
OPERATOR_RSYNC_BYTES = 16 << 20
OPERATOR_RCLONE_BYTES = 16 << 20
OPERATOR_SYNCTHING_BYTES = 8 << 20
#: How long a round or a pair may take, and ``Cluster.wait_for``'s poll
#: (the reference's 0.05-0.25 s).
OPERATOR_TIMEOUT = 600.0
OPERATOR_POLL = 0.25


class _Records(logging.Handler):
    """A logging handler that keeps each record's text, traceback
    included."""

    def __init__(self, out: list):
        super().__init__(logging.WARNING)
        self.out = out

    def emit(self, record):
        self.out.append(logging.Formatter(
            "%(name)s %(levelname)s %(message)s").format(record))


class JobFailures:
    """Within the block, every failed Job attempt and crashed Deployment
    of ``cluster`` is kept: each status write of a Job with ``failed``
    above 0, or of a Deployment with a message, and what the runner logs
    (the traceback of the attempt). The runner retries a failed attempt
    up to the Job's backoff limit, which would hide a kernel that failed
    to build or launch; ``check(label)`` raises with them instead."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.failed, self.logged = [], []
        self._handler = _Records(self.logged)

    def __enter__(self):
        write, failed = self.cluster.update_status, self.failed

        def watched(obj, **kw):
            if (obj.kind == "Job" and obj.status.failed > 0) or (
                    obj.kind == "Deployment" and obj.status.message):
                failed.append(f"{obj.kind} {obj.metadata.name} "
                              f"failed={getattr(obj.status, 'failed', '-')}"
                              f": {obj.status.message}")
            return write(obj, **kw)

        self.cluster.update_status = watched
        logging.getLogger("volsync_tpu_torch.runner").addHandler(
            self._handler)
        return self

    def __exit__(self, *exc):
        del self.cluster.update_status
        logging.getLogger("volsync_tpu_torch.runner").removeHandler(
            self._handler)

    def check(self, label: str) -> None:
        if self.failed or self.logged:
            raise AssertionError(
                f"{label}: failed Job attempts {self.failed}; the runner "
                "logged:\n" + "\n".join(self.logged))


def launches_of(torch, label: str, run, need: tuple, card: str) -> dict:
    """``run()`` with every launch count set to 0 just before and read
    just after, the card traced; on the card each kernel of ``need``
    must have launched. -> {"out", "secs", "launches", "busy_s"}."""
    from volsync_tpu_torch.ops._build import KERNELS, launch_counts

    for k in KERNELS:
        k.launches = 0
    with device_trace(torch) as traced:
        sync(torch)
        t0 = time.perf_counter()
        out = run()
        sync(torch)
        secs = time.perf_counter() - t0
    launches = launch_counts()
    if DEVICE == "cuda" and any(launches.get(k, 0) == 0 for k in need):
        raise AssertionError(f"{label}: launches {launches}, none of "
                             f"{[k for k in need if not launches.get(k)]}")
    busy = traced["busy_s"]
    log(f"{label}: {secs:.3f} s, launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}; card busy "
        + (f"{100 * busy / secs:.2f}%" if busy is not None
           else "not measured") + f" ({card})")
    return {"out": out, "secs": secs, "launches": launches, "busy_s": busy}


def operator_runtime(base: Path, runner_workers: int = OPERATOR_RUNNER_WORKERS,
                     manager_workers: int = OPERATOR_MANAGER_WORKERS,
                     movers: str = OPERATOR_MOVERS):
    """``OperatorRuntime`` as ``volsync-manager`` boots it, on the phase's
    device, its storage under ``base``, the listener on an ephemeral
    port."""
    from volsync_tpu_torch.operator import OperatorRuntime

    return OperatorRuntime({
        "storage_path": str(base / "storage"), "metrics_addr": "127.0.0.1",
        "metrics_port": -1, "runner_workers": runner_workers,
        "manager_workers": manager_workers, "movers": movers,
        "device": DEVICE})


def landed(cluster, kind: str, name: str, tag: str) -> bool:
    cr = cluster.try_get(kind, OPERATOR_NS, name)
    return bool(cr and cr.status and cr.status.last_manual_sync == tag)


def wait_landed(cluster, label: str, crs: list, tag: str) -> None:
    """Every (kind, name) of ``crs`` acks the manual ``tag``, or raise
    with those that did not."""
    if cluster.wait_for(lambda: all(landed(cluster, k, n, tag)
                                    for k, n in crs),
                        timeout=OPERATOR_TIMEOUT, poll=OPERATOR_POLL):
        return
    missing = [n for k, n in crs if not landed(cluster, k, n, tag)]
    raise AssertionError(f"{label}: {len(missing)} of {len(crs)} CRs missed "
                         f"{tag!r}: {missing[:8]}")


def retrigger(cluster, crs: list, tag: str) -> None:
    from volsync_tpu_torch.api import ReplicationTrigger

    for kind, name in crs:
        cr = cluster.get(kind, OPERATOR_NS, name)
        cr.spec.trigger = ReplicationTrigger(manual=tag)
        cluster.update(cr)


def replace_bytes(path: Path, data: bytes) -> None:
    """Write ``data`` as ``path`` through a new inode: a volume's
    point-in-time images are hard links of its files."""
    tmp = path.with_name(path.name + ".new")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def image_root(cluster, kind: str, name: str) -> Path:
    """The directory of a destination CR's latest image."""
    cr = cluster.get(kind, OPERATOR_NS, name)
    img = cr.status.latest_image
    if img is None or img.kind != "VolumeSnapshot":
        raise AssertionError(f"{name}: latest image {img}")
    snap = cluster.get("VolumeSnapshot", OPERATOR_NS, img.name)
    return Path(snap.status.bound_content)


def operator_layout(nbytes: int, big: int,
                    small_max: int = 128 << 10) -> dict:
    """``make_st_folder``'s layout for a tree of about ``nbytes``: ``big``
    bytes in ``big.bin``, the rest in small files (log-uniform 1 B to
    ``small_max``, their count from the mean size), no mid files."""
    mean = small_max / np.log(small_max + 1)
    return {"small": max(1, round((nbytes - big) / mean)),
            "small_max": small_max, "dirs": 8, "n_mid": 0, "mid_min": 0,
            "mid_max": 0, "big": big}


def volume(cluster, name: str):
    from volsync_tpu_torch.api import ObjectMeta
    from volsync_tpu_torch.cluster.objects import Volume, VolumeSpec

    vol = cluster.create(Volume(
        metadata=ObjectMeta(name=name, namespace=OPERATOR_NS),
        spec=VolumeSpec(capacity=1 << 30)))
    return Path(vol.status.path)


def secret(cluster, name: str, data: dict) -> None:
    from volsync_tpu_torch.api import ObjectMeta
    from volsync_tpu_torch.cluster.objects import Secret

    cluster.create(Secret(metadata=ObjectMeta(name=name,
                                              namespace=OPERATOR_NS),
                          data={k: v.encode() if isinstance(v, str) else v
                                for k, v in data.items()}))


def restic_source(cluster, name: str, pvc: str, repo_secret: str,
                  tag: str) -> None:
    from volsync_tpu_torch.api import (CopyMethod, ObjectMeta,
                                       ReplicationSource,
                                       ReplicationSourceResticSpec,
                                       ReplicationSourceSpec,
                                       ReplicationTrigger)

    cluster.create(ReplicationSource(
        metadata=ObjectMeta(name=name, namespace=OPERATOR_NS),
        spec=ReplicationSourceSpec(
            source_pvc=pvc, trigger=ReplicationTrigger(manual=tag),
            restic=ReplicationSourceResticSpec(
                repository=repo_secret, copy_method=CopyMethod.CLONE))))


def operator_fleet(torch, rt, base: Path, crs: int, nbytes: int,
                   rounds: int, seed: int, card: str) -> dict:
    """BASELINE.json configs[4] as ``bench_scale.py`` ``scenario_fleet``
    runs it: ``crs`` restic ReplicationSources (CopyMethod Clone), each
    on its own volume holding one seeded file of ``nbytes`` and its own
    encrypted repository, synced ``rounds`` manual rounds with the first
    quarter of every file rewritten between rounds. Each round has the
    launch counts set to 0 before and read after, exact (the fused
    kernels once a device pass, the verify kernels once a verify pass)
    and the card traced; every CR must ack the round's tag. Logs each
    round's wall, aggregate MiB/s, the p50 and p99 of the CRs'
    ``last_sync_duration``, passes and launches, and the busy share."""
    cluster = rt.cluster
    rng = np.random.default_rng(seed)
    names = [f"cr{i:03d}" for i in range(crs)]
    t0 = time.perf_counter()
    for name in names:
        (volume(cluster, f"{name}-d") / "data.bin").write_bytes(
            rng.bytes(nbytes))
        secret(cluster, f"{name}-s", {
            "RESTIC_REPOSITORY": str(base / f"repo-{name}"),
            "RESTIC_PASSWORD": OPERATOR_PASSWORD})
    log(f"operator fleet: {crs} volumes of {nbytes} bytes and their "
        f"repository secrets made in {time.perf_counter() - t0:.1f} s")
    keys = [("ReplicationSource", n) for n in names]
    out = {"names": names, "rounds": []}
    for rnd in range(rounds):
        tag = f"round-{rnd}"
        if rnd:
            for name in names:
                p = Path(cluster.get("Volume", OPERATOR_NS,
                                     f"{name}-d").status.path, "data.bin")
                buf = bytearray(p.read_bytes())
                buf[: nbytes // 4] = rng.bytes(nbytes // 4)
                replace_bytes(p, bytes(buf))

        def run(rnd=rnd, tag=tag):
            if rnd == 0:
                for name in names:
                    restic_source(cluster, name, f"{name}-d", f"{name}-s",
                                  tag)
            else:
                retrigger(cluster, keys, tag)
            wait_landed(cluster, f"operator round {rnd + 1}", keys, tag)

        label = (f"operator round {rnd + 1}: {crs} restic "
                 f"ReplicationSources of {nbytes} bytes")
        r = product_run(torch, label, run, FUSED_PER_PASS, SegmentPasses(),
                        verify_per_pass=VERIFY_PER_PASS)
        durs = np.array([cluster.get("ReplicationSource", OPERATOR_NS, n)
                         .status.last_sync_duration.total_seconds()
                         for n in names])
        r.update(mibs=crs * nbytes / (1 << 20) / r["secs"],
                 p50_s=float(np.percentile(durs, 50)),
                 p99_s=float(np.percentile(durs, 99)))
        log(f"{label}: wall {r['secs']:.3f} s, {r['mibs']:.2f} MiB/s in all; "
            f"last_sync_duration p50 {r['p50_s']:.3f} s, p99 "
            f"{r['p99_s']:.3f} s ({card})")
        out["rounds"].append(r)
    return out


def file_oracle_ids(data: bytes, params) -> list:
    """The blob ids of ``data`` as one file: host candidates, the host
    FastCDC walk and hashlib."""
    from volsync_tpu_torch.ops.gearcdc import (_select_boundaries_py,
                                               host_candidates)
    from volsync_tpu_torch.repo import blobid

    x = np.frombuffer(data, np.uint8)
    s, lax = host_candidates(x, params, len(x))
    return [blobid.blob_id(data[o:o + n]) for o, n in
            _select_boundaries_py(s, lax, len(x), params, eof=True)]


def operator_restores(torch, rt, base: Path, names: list, card: str) -> dict:
    """A restic ReplicationDestination (CopyMethod Snapshot, a fresh
    volume) for each fleet CR of ``names``, restoring its latest snapshot:
    the launch counts exact (the verify kernels once a verify pass), each
    image byte-identical to its source volume, and the first CR's file's
    blob ids in its repository equal to the host oracle's."""
    from volsync_tpu_torch.api import (CopyMethod, ObjectMeta,
                                       ReplicationDestination,
                                       ReplicationDestinationResticSpec,
                                       ReplicationDestinationSpec,
                                       ReplicationTrigger)
    from volsync_tpu_torch.engine import params_from_config
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.repo.repository import Repository

    cluster = rt.cluster
    keys = [("ReplicationDestination", f"{n}-r") for n in names]

    def run():
        for name in names:
            cluster.create(ReplicationDestination(
                metadata=ObjectMeta(name=f"{name}-r", namespace=OPERATOR_NS),
                spec=ReplicationDestinationSpec(
                    trigger=ReplicationTrigger(manual="restore"),
                    restic=ReplicationDestinationResticSpec(
                        repository=f"{name}-s", capacity=1 << 30,
                        copy_method=CopyMethod.SNAPSHOT))))
        wait_landed(cluster, "operator restores", keys, "restore")

    r = product_run(torch, f"operator restores: {len(names)} restic "
                    f"ReplicationDestinations", run, VERIFY_PER_PASS, None)
    for name in names:
        src = Path(cluster.get("Volume", OPERATOR_NS, f"{name}-d")
                   .status.path)
        got = st_state(image_root(cluster, "ReplicationDestination",
                                       f"{name}-r"))
        if got != st_state(src):
            raise AssertionError(f"operator restore of {name}: the image "
                                 f"differs from its source volume")
    repo = Repository.open(FsObjectStore(base / f"repo-{names[0]}"),
                           OPERATOR_PASSWORD, device=DEVICE)
    snaps = repo.list_snapshots()
    _, meta = max(snaps, key=lambda s: s[1]["time"])
    tree = json.loads(repo.read_blob(meta["tree"]))
    (entry,) = [e for e in tree["entries"] if e["name"] == "data.bin"]
    data = Path(cluster.get("Volume", OPERATOR_NS, f"{names[0]}-d")
                .status.path, "data.bin").read_bytes()
    want = file_oracle_ids(data, params_from_config(repo.chunker_params))
    if entry["content"] != want:
        raise AssertionError(f"operator: {names[0]}'s blob ids differ from "
                             f"the host oracle's")
    log(f"operator restores: {len(names)} images byte-identical; "
        f"{names[0]}'s {len(want)} blob ids over {len(snaps)} snapshots "
        f"equal the host oracle's ({card})")
    return r


def operator_rsync(torch, rt, nbytes: int, seed: int, card: str) -> dict:
    """An rsync ReplicationDestination (CopyMethod Snapshot) and a
    ReplicationSource (CopyMethod Clone) given the address, port and key
    secret the destination publishes, over a seeded tree of ``nbytes``
    (half in ``big.bin``): a first sync into the empty volume, then edits
    (``big.bin`` overwritten in two places, a small file grown, one added)
    and a second sync over the basis; after each the destination's image
    equals the source, and the second launches ``md5_slices``."""
    from volsync_tpu_torch.api import (CopyMethod, ObjectMeta,
                                       ReplicationDestination,
                                       ReplicationDestinationRsyncSpec,
                                       ReplicationDestinationSpec,
                                       ReplicationSource,
                                       ReplicationSourceRsyncSpec,
                                       ReplicationSourceSpec,
                                       ReplicationTrigger)

    cluster = rt.cluster
    rng = np.random.default_rng(seed)
    src = volume(cluster, "rsync-data")
    made = make_st_folder(src / "tree", operator_layout(nbytes, nbytes // 2),
                          seed)
    keys = [("ReplicationDestination", "rsync-dst"),
            ("ReplicationSource", "rsync-src")]
    res = {}

    def first():
        cluster.create(ReplicationDestination(
            metadata=ObjectMeta(name="rsync-dst", namespace=OPERATOR_NS),
            spec=ReplicationDestinationSpec(
                trigger=ReplicationTrigger(manual="first"),
                rsync=ReplicationDestinationRsyncSpec(
                    copy_method=CopyMethod.SNAPSHOT, capacity=1 << 30))))

        def published():
            cr = cluster.try_get("ReplicationDestination", OPERATOR_NS,
                                 "rsync-dst")
            st = cr.status.rsync if cr and cr.status else None
            return bool(st and st.address and st.port)

        if not cluster.wait_for(published, timeout=OPERATOR_TIMEOUT,
                                poll=OPERATOR_POLL):
            raise AssertionError("operator rsync: the destination never "
                                 "published its address")
        st = cluster.get("ReplicationDestination", OPERATOR_NS,
                         "rsync-dst").status.rsync
        cluster.create(ReplicationSource(
            metadata=ObjectMeta(name="rsync-src", namespace=OPERATOR_NS),
            spec=ReplicationSourceSpec(
                source_pvc="rsync-data",
                trigger=ReplicationTrigger(manual="first"),
                rsync=ReplicationSourceRsyncSpec(
                    address=st.address, port=st.port, ssh_keys=st.ssh_keys,
                    copy_method=CopyMethod.CLONE))))
        wait_landed(cluster, "operator rsync first", keys, "first")

    def second():
        retrigger(cluster, keys, "second")
        wait_landed(cluster, "operator rsync second", keys, "second")

    for label, run, need in (("first", first, ()),
                             ("second", second, ("md5_slices",))):
        if label == "second":
            big = bytearray((src / "tree" / "big.bin").read_bytes())
            for at in (len(big) // 5, 3 * len(big) // 4):
                big[at:at + 4096] = rng.bytes(4096)
            replace_bytes(src / "tree" / "big.bin", bytes(big))
            small = src / "tree" / made["small"][1]
            replace_bytes(small, small.read_bytes() + rng.bytes(5000))
            (src / "tree" / "d03" / "added.bin").write_bytes(
                rng.bytes(70_000))
        res[label] = launches_of(
            torch, f"operator rsync {label} sync ({nbytes} bytes)", run,
            need, card)
        got = st_state(image_root(cluster, "ReplicationDestination",
                                       "rsync-dst"))
        if got != st_state(src):
            raise AssertionError(f"operator rsync {label}: the destination "
                                 f"differs from the source")
    return res


def operator_s3(torch, rt, base: Path, nbytes: int, rclone_bytes: int,
                seed: int, card: str) -> dict:
    """Through one bucket of the port's ``FakeS3Server`` on 127.0.0.1:
    two restic ReplicationSources sharing one repository (both land, the
    repository holds two snapshots and checks clean, each CR's
    throughput gauge is above 0), then an rclone ReplicationSource and
    ReplicationDestination (a fresh volume) over ``rclone_bytes`` of small
    files: the image equals the source."""
    from volsync_tpu_torch.api import (CopyMethod, ObjectMeta,
                                       ReplicationDestination,
                                       ReplicationDestinationRcloneSpec,
                                       ReplicationDestinationSpec,
                                       ReplicationSource,
                                       ReplicationSourceRcloneSpec,
                                       ReplicationSourceSpec,
                                       ReplicationTrigger)
    from volsync_tpu_torch.objstore.fakes3 import FakeS3Server
    from volsync_tpu_torch.objstore.s3 import S3ObjectStore
    from volsync_tpu_torch.repo.repository import Repository

    cluster = rt.cluster
    rng = np.random.default_rng(seed)
    res = {}
    with FakeS3Server() as s3:
        secret(cluster, "s3-repo", {
            "RESTIC_REPOSITORY": f"s3:{s3.endpoint}/bucket/shared",
            "RESTIC_PASSWORD": OPERATOR_PASSWORD,
            "AWS_ACCESS_KEY_ID": s3.access_key,
            "AWS_SECRET_ACCESS_KEY": s3.secret_key,
            "LOCK_WAIT_SECONDS": "60"})
        keys = [("ReplicationSource", f"s3-cr{i}") for i in range(2)]
        for i in range(2):
            (volume(cluster, f"s3-v{i}") / "data.bin").write_bytes(
                rng.bytes(nbytes))

        def restic():
            for i in range(2):
                restic_source(cluster, f"s3-cr{i}", f"s3-v{i}", "s3-repo",
                              "go")
            wait_landed(cluster, "operator s3 restic", keys, "go")

        res["restic"] = launches_of(
            torch, "operator s3: two restic ReplicationSources into one "
            "bucket", restic, ("sha256_pages", "fastcdc_walk",
                               "sha256_slices", "merkle_roots"), card)
        repo = Repository.open(S3ObjectStore(
            s3.endpoint, "bucket", "shared", access_key=s3.access_key,
            secret_key=s3.secret_key), OPERATOR_PASSWORD, device=DEVICE)
        if len(repo.list_snapshots()) != 2 or repo.check() != []:
            raise AssertionError("operator s3: the shared repository does "
                                 "not hold two clean snapshots")
        gauge = rt.metrics.throughput.values()
        rates = [gauge.get((f"s3-cr{i}", OPERATOR_NS, "source", "restic"),
                           0.0) for i in range(2)]
        if min(rates) <= 0:
            raise AssertionError(f"operator s3: throughput gauges {rates}")

        src = volume(cluster, "rclone-data")
        make_st_folder(src / "tree", operator_layout(
            rclone_bytes, 0, small_max=512 << 10), seed + 1)
        secret(cluster, "rclone-conf", {"rclone.conf": (
            f"[bucket]\nurl = s3:{s3.endpoint}/bucket\n"
            f"access_key_id = {s3.access_key}\n"
            f"secret_access_key = {s3.secret_key}\n"
            f"endpoint = {s3.endpoint}\n")})
        conf = dict(rclone_config_section="bucket",
                    rclone_dest_path="rclone-pvc",
                    rclone_config="rclone-conf")

        def up():
            cluster.create(ReplicationSource(
                metadata=ObjectMeta(name="rclone-up", namespace=OPERATOR_NS),
                spec=ReplicationSourceSpec(
                    source_pvc="rclone-data",
                    trigger=ReplicationTrigger(manual="up"),
                    rclone=ReplicationSourceRcloneSpec(
                        copy_method=CopyMethod.CLONE, **conf))))
            wait_landed(cluster, "operator rclone up",
                        [("ReplicationSource", "rclone-up")], "up")

        def down():
            cluster.create(ReplicationDestination(
                metadata=ObjectMeta(name="rclone-down",
                                    namespace=OPERATOR_NS),
                spec=ReplicationDestinationSpec(
                    trigger=ReplicationTrigger(manual="down"),
                    rclone=ReplicationDestinationRcloneSpec(
                        copy_method=CopyMethod.SNAPSHOT, capacity=1 << 30,
                        **conf))))
            wait_landed(cluster, "operator rclone down",
                        [("ReplicationDestination", "rclone-down")], "down")

        res["rclone_up"] = launches_of(
            torch, f"operator rclone up ({rclone_bytes} bytes of small "
            "files)", up, ("sha256_pages",), card)
        res["rclone_down"] = launches_of(torch, "operator rclone down",
                                         down, (), card)
        if st_state(image_root(cluster, "ReplicationDestination",
                                    "rclone-down")) != st_state(src):
            raise AssertionError("operator rclone: the destination differs "
                                 "from the source")
    log(f"operator s3: two CRs landed in one bucket, 2 snapshots, check "
        f"clean, throughput gauges {[round(r) for r in rates]} B/s; rclone "
        f"image equal to its source ({card})")
    return res


def settled_state(root: Path) -> dict | None:
    """``st_state`` of a daemon's folder without its in-flight pull files;
    None while a file vanishes under the walk."""
    from volsync_tpu_torch.movers.syncthing.entry import _TMP_PREFIX

    try:
        return {k: v for k, v in st_state(root).items()
                if not Path(k).name.startswith(_TMP_PREFIX)}
    except FileNotFoundError:
        return None


def operator_syncthing(torch, rt, nbytes: int, seed: int, card: str) -> dict:
    """Two syncthing ReplicationSources (always-on daemons as
    Deployments) over a seeded folder of ``nbytes`` on A and an empty one
    on B: once each publishes its identity, each is given the other as a
    peer, and B's folder must converge to A's."""
    from volsync_tpu_torch.api import (ObjectMeta, ReplicationSource,
                                       ReplicationSourceSpec,
                                       ReplicationSourceSyncthingSpec,
                                       SyncthingPeer)

    cluster = rt.cluster
    roots = {}
    for name in ("st-a", "st-b"):
        roots[name] = volume(cluster, f"{name}-data")
    make_st_folder(roots["st-a"] / "tree",
                   operator_layout(nbytes, nbytes // 2), seed)

    def identity(name):
        cr = cluster.try_get("ReplicationSource", OPERATOR_NS, name)
        st = cr.status.syncthing if cr and cr.status else None
        return st if st and st.id and st.address else None

    def run():
        for name in roots:
            cluster.create(ReplicationSource(
                metadata=ObjectMeta(name=name, namespace=OPERATOR_NS),
                spec=ReplicationSourceSpec(
                    source_pvc=f"{name}-data",
                    syncthing=ReplicationSourceSyncthingSpec())))
        if not cluster.wait_for(lambda: all(identity(n) for n in roots),
                                timeout=OPERATOR_TIMEOUT,
                                poll=OPERATOR_POLL):
            raise AssertionError("operator syncthing: no identity published")
        ids = {n: identity(n) for n in roots}
        for name, other in (("st-a", "st-b"), ("st-b", "st-a")):
            cr = cluster.get("ReplicationSource", OPERATOR_NS, name)
            cr.spec.syncthing.peers = [SyncthingPeer(
                address=ids[other].address, id=ids[other].id)]
            cluster.update(cr)
        want = settled_state(roots["st-a"])
        deadline = time.monotonic() + ST_TIMEOUT
        while settled_state(roots["st-b"]) != want:
            if time.monotonic() > deadline:
                raise AssertionError("operator syncthing: B never "
                                     "converged to A")
            time.sleep(OPERATOR_POLL)

    with env_set("VOLSYNC_ST_MAX_INTERVAL", ST_MAX_INTERVAL):
        return launches_of(torch, f"operator syncthing pair ({nbytes} "
                           "bytes) converged", run, ("sha256_pages",), card)


def parse_exposition(text: str) -> list:
    """The samples of a Prometheus text exposition: [(name, labels,
    value)]."""
    out = []
    label = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
    unescape = {"\\\\": "\\", '\\"': '"', "\\n": "\n"}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, value = line.rsplit(" ", 1)
        name, _, rest = head.partition("{")
        labels = {k: re.sub(r"\\[\\\"n]", lambda m: unescape[m.group(0)], v)
                  for k, v in label.findall(rest)}
        out.append((name, labels, float(value)))
    return out


def operator_listener(rt, names: list, rounds: int, card: str) -> dict:
    """The metrics and probes listener over HTTP: /healthz and /readyz
    answer 200, /debug/trace parses as JSON, and /metrics shows every
    fleet CR with 0 missed intervals, out of sync 0, ``rounds`` sync
    durations and a throughput above 0."""
    import urllib.request

    url = f"http://127.0.0.1:{rt.metrics_server.port}"

    def get(path):
        with urllib.request.urlopen(url + path, timeout=30) as r:
            return r.status, r.read()

    for path in ("/healthz", "/readyz"):
        code, _ = get(path)
        if code != 200:
            raise AssertionError(f"operator listener: {path} {code}")
    _, body = get("/debug/trace")
    trace = json.loads(body)
    _, body = get("/metrics")
    samples = parse_exposition(body.decode())
    by = defaultdict(dict)
    for name, labels, value in samples:
        if labels.get("role") == "source" and labels.get("method") == \
                "restic" and "le" not in labels:
            by[labels["obj_name"]][name] = value
    want = {"volsync_missed_intervals_total": 0.0,
            "volsync_volume_out_of_sync": 0.0,
            "volsync_sync_duration_seconds_count": float(rounds)}
    bad = [n for n in names
           if any(by[n].get(k) != v for k, v in want.items())
           or not by[n].get("volsync_data_throughput_bytes_per_second", 0) > 0]
    if bad:
        raise AssertionError(f"operator listener: /metrics of {bad[:4]}: "
                             f"{[by[n] for n in bad[:4]]}")
    log(f"operator listener: /healthz, /readyz 200; /debug/trace "
        f"{len(trace.get('traceEvents', []))} events; /metrics "
        f"{len(samples)} samples, every one of {len(names)} fleet CRs at 0 "
        f"missed intervals, in sync, {rounds} sync durations, throughput "
        f"above 0 ({card})")
    return {"samples": len(samples)}


def operator_phase(torch, base: Path, crs: int, nbytes: int, rounds: int,
                   seed: int, card: str) -> dict:
    """``volsync-manager``'s stack (``OperatorRuntime``) on the card, its
    storage root under ``base``: a second runtime on the same root is
    refused by the storage lock; then the fleet rounds, the restores,
    the rsync pair, the S3 bucket with two restic CRs and the rclone
    pair, the syncthing pair, and the listener, with no Job attempt
    failed anywhere (``JobFailures``)."""
    from volsync_tpu_torch.operator import OperatorRuntime

    t0 = time.perf_counter()
    rt = operator_runtime(base).start()
    log(f"operator: OperatorRuntime up in {time.perf_counter() - t0:.2f} s "
        f"(movers {', '.join(rt.catalog.names())}; runner "
        f"{rt.runner.max_workers} workers on {rt.runner.device}, manager "
        f"{rt.manager.workers}; storage {rt.cluster.storage.root})")
    res = {}
    try:
        second = OperatorRuntime({"storage_path": str(base / "storage"),
                                  "metrics_port": 0, "device": DEVICE})
        try:
            second.start()
        except SystemExit as e:
            if "already managed" not in str(e):
                raise
            log(f"operator: a second manager on {base / 'storage'} is "
                f"refused by the storage lock (flock)")
        else:
            second.stop()
            raise AssertionError("operator: a second manager took the "
                                 "storage root")
        with JobFailures(rt.cluster) as failures:
            fleet = operator_fleet(torch, rt, base, crs, nbytes, rounds,
                                   seed, card)
            res["rounds"] = fleet["rounds"]
            res["restore"] = operator_restores(
                torch, rt, base, fleet["names"][:OPERATOR_RESTORES], card)
            res["rsync"] = operator_rsync(torch, rt, OPERATOR_RSYNC_BYTES,
                                          seed + 1, card)
            res["s3"] = operator_s3(torch, rt, base, nbytes,
                                    OPERATOR_RCLONE_BYTES, seed + 2, card)
            res["syncthing"] = operator_syncthing(
                torch, rt, OPERATOR_SYNCTHING_BYTES, seed + 3, card)
            res["listener"] = operator_listener(rt, fleet["names"], rounds,
                                                card)
        failures.check("operator")
    finally:
        rt.stop()
    return res


# -- supervised device sessions ------------------------------------------------

#: The session phase's hashing child: a seeded buffer's blob id by
#: ``hash_spans`` on the device, and the session variables it was given.
SESSION_CHILD = """
import json, os, sys
import numpy as np
from volsync_tpu_torch.engine.chunker import hash_spans
n, seed, dev = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
buf = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)
print(json.dumps({"id": hash_spans(buf, [(0, n)], device=dev)[0],
                  "env": {k: os.environ.get(k) for k in (
                      "VOLSYNC_SESSION_ID", "VOLSYNC_SESSION_EPOCH",
                      "VOLSYNC_SESSION_BACKEND")}}))
"""


def session_phase(torch, base: Path, seed: int, card: str,
                  nbytes: int = 64 << 20) -> dict:
    """``TorchSessionBackend`` on the phase's device, under a
    ``SessionSupervisor`` and ``BenchQueue``: the acquire probe (its
    seconds); ``python -m volsync_tpu_torch.cli session status --probe``
    in a subprocess beside the rest (0 on the card; the device its probe
    names); one queued child that hashes a seeded buffer with the port
    (its blob id equal to hashlib's, its environment carrying the
    session); a job past a 2 s deadline refused; ``force_release``
    killing a marked sleeping child and sparing an unmarked one. This
    process never carries the marker."""
    from volsync_tpu_torch.cluster import sessions
    from volsync_tpu_torch.repo import blobid

    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    key, _, value = sessions.BENCH_CHILD_MARKER.partition("=")
    if os.environ.get(key) == value:
        raise AssertionError("chip_smoke carries the measurement marker")
    dev = None if DEVICE == "cuda" else DEVICE
    status = base / "session-status.json"
    sup = sessions.SessionSupervisor(
        sessions.TorchSessionBackend(device=dev, probe_timeout=300.0),
        probe_timeout=300.0, status_path=str(status))
    queue = sessions.BenchQueue(sup, job_deadline=300.0)
    t0 = time.perf_counter()
    sid = sup.ensure()  # the acquire probe
    probe_s = time.perf_counter() - t0
    cli = subprocess.Popen(
        [sys.executable, "-m", "volsync_tpu_torch.cli", "session", "status",
         "--probe", "--probe-timeout", "300"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(env, VOLSYNC_SESSION_STATUS=str(status)))
    marker = f"{key}=chip-smoke-{os.getpid()}"
    sleeper = [sys.executable, "-c", "import time; time.sleep(300)"]
    marked = subprocess.Popen(sleeper, env=dict(env, **{key: marker.split(
        "=", 1)[1]}))
    plain = subprocess.Popen(sleeper, env=env)
    try:
        t0 = time.perf_counter()
        res = queue.run_command(
            [sys.executable, "-c", SESSION_CHILD, str(nbytes), str(seed),
             DEVICE], label="hash",
            env_extra={"PYTHONPATH": env["PYTHONPATH"]})
        job_s = time.perf_counter() - t0
        inner = res["result"]
        if inner["rc"] != 0:
            raise AssertionError(f"session job rc {inner['rc']}: "
                                 f"{inner['stderr'][-800:]}")
        got = json.loads(inner["stdout"].strip().splitlines()[-1])
        buf = np.random.default_rng(seed).integers(0, 256, nbytes,
                                                   dtype=np.uint8)
        want_env = {"VOLSYNC_SESSION_ID": res["session"]["session_id"],
                    "VOLSYNC_SESSION_EPOCH": str(res["session"]["epoch"]),
                    "VOLSYNC_SESSION_BACKEND": "torch"}
        if got["id"] != blobid.blob_id(buf) or got["env"] != want_env \
                or res["session"]["session_id"] != sid:
            raise AssertionError(f"session job: {got} under "
                                 f"{res['session']}, expected id "
                                 f"{blobid.blob_id(buf)} and env {want_env}")
        try:
            queue.run_command([sys.executable, "-c",
                               "import time; time.sleep(30)"],
                              label="overrun", deadline=2.0)
        except sessions.JobDeadlineExceeded:
            pass
        else:
            raise AssertionError("a job past its 2 s deadline was not "
                                 "refused")
        killed = sessions.TorchSessionBackend(
            device=dev, marker=marker).force_release()
        if killed != 1 or marked.wait(timeout=30) == 0 \
                or plain.poll() is not None:
            raise AssertionError(f"force_release killed {killed}; marked "
                                 f"rc {marked.poll()}, unmarked rc "
                                 f"{plain.poll()}")
        out, err = cli.communicate(timeout=600)
    finally:
        for p in (marked, plain, cli):
            if p.poll() is None:
                p.kill()
            p.wait()
    live = [ln for ln in out.splitlines() if ln.startswith("probe: ")]
    if cli.returncode != (0 if DEVICE == "cuda" else 75) or not live:
        raise AssertionError(f"session status --probe rc {cli.returncode}: "
                             f"{out[-400:]} {err[-400:]}")
    log(f"session: acquire probe {probe_s:.2f} s; 'session status --probe' "
        f"rc {cli.returncode}: {live[0]}; a hash job of {nbytes} bytes "
        f"through the queue {job_s:.2f} s (its verify probe included), its "
        f"blob id equal to hashlib's under session {sid} epoch "
        f"{res['session']['epoch']}; a 2 s overrun refused; force_release "
        f"killed the marked child and spared the other ({card})")
    return {"probe_s": probe_s, "device": live[0], "job_s": job_s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream-gib", type=float, default=10.0)
    # The other engines' volumes are cut from 10 GiB to keep their host
    # oracles (numpy candidates at 64 or 1 byte granularity) within the
    # time limit; align 64 from 2 to 1 GiB and page-major from 1 to 0.5
    # once the mesh and session phases came (PERF.md, section 4).
    ap.add_argument("--align64-gib", type=float, default=1.0)
    ap.add_argument("--align1-mib", type=float, default=256.0)
    ap.add_argument("--pagemajor-gib", type=float, default=0.5)
    # The backup phase's volumes: the mover's 10 GiB PVC (BASELINE.json
    # configs[1]); the align-64 tree is cut, since it differs from it
    # only by the engine.
    ap.add_argument("--backup-gib", type=float, default=10.0)
    ap.add_argument("--backup64-mib", type=float, default=256.0)
    # The erasure-coded round trip's volume: cut from the 10 GiB PVC, and
    # from 2 to 0.5 GiB once the service phase came, to keep the whole
    # script inside its time limit on a slower host (PERF.md, section 4).
    ap.add_argument("--ec-gib", type=float, default=0.5)
    # The delta phase's volume: BASELINE.json configs[0], a 1 GiB PVC
    # replicated by rsync, cut to 0.5 GiB once the script passed 1,150 s
    # on a slow host (PERF.md, section 4). The mover phase syncs the same
    # trees.
    ap.add_argument("--delta-gib", type=float, default=0.5)
    # The restic entry phase's tree: cut from the 10 GiB PVC, which the
    # backup phase already runs through the same engine.
    ap.add_argument("--restic-mib", type=float, default=256.0)
    # The rclone phase's small files: BASELINE.json configs[2] (many small
    # files) cut in depth, from 100 GiB to ~0.6 GiB with the mid files and
    # the streamed file, from 8,192 to 4,096 files once the service
    # phase came, and to 2,048 with the delta cut (PERF.md, section 4).
    ap.add_argument("--rclone-files", type=int, default=2048)
    # The service phase: BASELINE.json configs[4], 100 concurrent sources,
    # cut in depth to 32 MiB less SERVICE_SHORT a source, one segment
    # each, then to 16 MiB with the delta cut (PERF.md, section 4).
    ap.add_argument("--service-tenants", default=SERVICE_TENANTS)
    ap.add_argument("--service-mib", type=float, default=16.0)
    # The lone-stream batcher turns: the first GiB of the fused stream,
    # cut from the whole 10 GiB once the fleet and syncthing phases came
    # (PERF.md, section 4).
    ap.add_argument("--turns-gib", type=float, default=1.0)
    # The fleet phase: BASELINE.json configs[4], many ReplicationSources
    # served by one fleet; 12 jobs of this many MiB less FLEET_SHORT, cut
    # from 128 to keep the script inside its limit (PERF.md, section 4).
    ap.add_argument("--fleet-mib", type=float, default=16.0)
    # The syncthing phase's folder on A (its small and mid files' counts
    # scale with it), cut from 256 for the same reason.
    ap.add_argument("--syncthing-mib", type=float, default=32.0)
    # The mesh phase's fused prefix: the fused stream's first half GiB
    # + 12,345 B through a 4-shard mesh of the card, cut from 1 GiB with
    # the two above (the align-64 and align-1 prefixes are MESH_ALIGN64
    # and MESH_ALIGN1).
    ap.add_argument("--mesh-gib", type=float, default=0.5)
    # The operator phase: BASELINE.json configs[4], 100 concurrent
    # ReplicationSource CRs, at bench_scale.py's fleet scenario (100 CRs
    # of 4 MiB) through volsync-manager's stack; its rounds cut from the
    # scenario's 2 to 1 once the script passed 850 s (PERF.md, section 4).
    ap.add_argument("--operator-crs", type=int, default=100)
    ap.add_argument("--operator-mib", type=float, default=4.0)
    ap.add_argument("--operator-rounds", type=int, default=1)
    # Where the flight recorder's dump of the restic entry's first
    # backup is kept (a Chrome trace for Perfetto); default: removed
    # with the phase's directory.
    ap.add_argument("--trace-out", type=Path, default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from volsync_tpu_torch.ops import _build
    from volsync_tpu_torch.ops.gearcdc import DEFAULT_PARAMS, GearParams

    from volsync_tpu_torch.io import native

    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build: {len(reports)} CUDA sources compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    # the native host library: the file reader and the host walk of the
    # align-64 and align-1 engines; the script measures no Python route
    # by accident
    if not native.available():
        raise AssertionError("the native host library (volsync_tpu_torch/"
                             "io/native.py) is not available")
    build_s = native.LOAD_INFO["build_s"]
    log(f"build: native volio (volsync_tpu_torch/native/volio.cpp, g++ "
        f"{' '.join(native.GXX_FLAGS)}) "
        + (f"compiled in {build_s:.2f} s" if build_s is not None
           else "already built")
        + f", loaded from {native.LOAD_INFO['path']}")
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
    md5_lat = md5_round_cycles(torch, args.seed)
    log(f"probe (csrc/probe.cu, one-thread MD5 chain of "
        f"{PROBE_MD5_BLOCKS} blocks): one dependent round "
        f"{md5_lat['cycles']:.2f} SM cycles ({md5_lat['ns']:.3f} ns) "
        f"({card})")
    # one dependent integer instruction: the MD5 round's 4, over 4
    op_cycles = md5_lat["cycles"] / 4
    stats = kernel_phase(torch, stream, DEFAULT_PARAMS, SEGMENT_P, params64,
                         params1, lat, op_cycles)
    md5_kernel_entries(torch, stats, args.seed, sass, md5_lat["cycles"])
    t1 = time.perf_counter()
    root_shape_entries(torch, stats, args.seed, op_cycles)
    log(f"merkle_roots at its callers' other shapes: "
        f"{time.perf_counter() - t1:.1f} s ({card})")
    for name, floor in floors.items():
        st = stats[name]
        bound = (f"{st['longest'] * floor:.4f} ms" if floor
                 else "not available")
        log(f"{name} chain bound (longest lane {st['longest']} blocks x the "
            f"chain floor): {bound}, measured {np.mean(st['ms']):.4f} ms "
            f"({card})")
    res = stream_phase(torch, stream, DEFAULT_PARAMS)
    verify_phase(res.pop("views"))
    turns_stream = stream_prefix(stream, int(args.turns_gib * GIB) + ODD_TAIL)
    mesh_cells = [mesh_cell("fused", DEFAULT_PARAMS, stream,
                            int(args.mesh_gib * GIB) + ODD_TAIL, res)]
    turns = batcher_turns(torch, turns_stream, DEFAULT_PARAMS,
                          prefix_chunks(res.pop("results"), turns_stream))
    log(f"stream GiB/s, a lone stream of {turns_stream.total} bytes with the "
        "shared batcher off / on in turns: " + " / ".join(
            ", ".join(f"{t['gibs']:.4f}" for t in turns[k])
            for k in ("off", "on")) + f" ({card})")
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

    vol = volume(int(args.align64_gib * GIB), "align=64")
    split = split_stream_phase(torch, vol, params64)
    walk_turns(torch, vol, params64, SPLIT_PER_PASS, "align=64 stream",
               split, card)
    mesh_cells.append(mesh_cell("align=64", params64, vol, MESH_ALIGN64,
                                split))
    vol = volume(int(args.align1_mib * (1 << 20)), "align=1")
    legacy = legacy_stream_phase(torch, vol, params1)
    walk_turns(torch, vol, params1, LEGACY_PER_PASS, "align=1 stream",
               legacy, card)
    mesh_cells.append(mesh_cell("align=1", params1, vol, MESH_ALIGN1, legacy))
    del vol
    pm = pagemajor_stream_phase(
        torch, volume(int(args.pagemajor_gib * GIB), "page-major"),
        DEFAULT_PARAMS)
    log(f"GiB/s by engine: fused {res['gibs']:.4f}, align=64 "
        f"{split['gibs']:.4f}, align=1 {legacy['gibs']:.4f}, page-major "
        f"{pm['gibs']:.4f} ({card})")
    t1 = time.perf_counter()
    mesh = mesh_phase(torch, mesh_cells, stats, args.seed + 10, card)
    del mesh_cells
    log(f"mesh phase: {time.perf_counter() - t1:.1f} s in all ({card})")

    t1 = time.perf_counter()
    svc = service_phase(torch, args.seed + 7, args.service_tenants,
                        args.service_mib, card)
    # the pass shape that hashed the most of the timed round's segments
    shapes = svc["batched"]["pass_shapes"]
    most = max(shapes, key=lambda sp: (sp[0] * shapes[sp], sp))
    batched_kernel_entries(torch, stats, svc.pop("base"),
                           [most] + ([(8, most[1])] if most[0] != 8 else []),
                           lat, floors["merkle_roots"], op_cycles)
    log(f"service phase with the batched-shape kernels: "
        f"{time.perf_counter() - t1:.1f} s ({card})")

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
        build, 5 * restic_bytes)))
    t1 = time.perf_counter()
    try:
        restic = restic_entry_phase(
            torch, base, restic_bytes, args.seed + 5, card,
            mesh_check=lambda b, src, tree: mesh_tree_check(
                torch, b, src, tree, card), trace_out=args.trace_out)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"restic entry phase: {time.perf_counter() - t1:.1f} s in all "
        f"({card})")
    layout = rclone_layout(args.rclone_files)
    need = (layout["big"] + layout["n_mid"] * layout["mid_max"]
            + args.rclone_files * layout["small_max"] // 8)
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_rclone.", dir=backup_base(
        build, 3 * need)))
    t1 = time.perf_counter()
    try:
        rclone = rclone_phase(torch, base, layout, args.seed + 6, card)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"rclone phase: {time.perf_counter() - t1:.1f} s in all ({card})")
    fleet_bytes = int(args.fleet_mib * (1 << 20)) - FLEET_SHORT
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet.", dir=backup_base(
        build, 3 * FLEET_JOBS * fleet_bytes)))
    t1 = time.perf_counter()
    try:
        fleet = fleet_phase(torch, base, fleet_bytes, args.seed + 8, card)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"fleet phase: {time.perf_counter() - t1:.1f} s in all; batched / "
        "unbatched: " + "; ".join(
            f"{k} {fleet[k]['secs']:.3f} s, {fleet[k]['gibs']:.4f} GiB/s, "
            f"{fleet[k]['passes']} passes of {fleet[k]['segments']} "
            f"segments, card busy "
            + (f"{100 * fleet[k]['busy_s'] / fleet[k]['secs']:.2f}%"
               if fleet[k]["busy_s"] is not None else "not measured")
            for k in ("batched", "unbatched")) + f" ({card})")
    layout = st_layout(args.syncthing_mib)
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_syncthing.",
                                 dir=backup_base(build, 4 * (256 << 20))))
    t1 = time.perf_counter()
    try:
        st = syncthing_phase(torch, base, layout, args.seed + 9, card)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"syncthing phase: {time.perf_counter() - t1:.1f} s in all; "
        f"convergence initial {st['initial']['secs']:.3f} s, edits "
        f"{st['edits']['secs']:.3f} s, conflict {st['conflict']['secs']:.3f} "
        f"s ({card})")
    # the operator's storage root (its volumes, images and repositories)
    # under build/, where its storage lock is taken
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_operator.", dir=build))
    t1 = time.perf_counter()
    try:
        op = operator_phase(torch, base, args.operator_crs,
                            int(args.operator_mib * (1 << 20)),
                            args.operator_rounds, args.seed + 12, card)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"operator phase: {time.perf_counter() - t1:.1f} s in all; "
        + "; ".join(
            f"round {i + 1} of {args.operator_crs} CRs {r['secs']:.3f} s, "
            f"{r['mibs']:.2f} MiB/s, last_sync_duration p50 "
            f"{r['p50_s']:.3f} s p99 {r['p99_s']:.3f} s, {r['passes']} "
            f"passes of {r['lanes']} segments, card busy "
            + (f"{100 * r['busy_s'] / r['secs']:.2f}%"
               if r["busy_s"] is not None else "not measured")
            for i, r in enumerate(op["rounds"])) + f" ({card})")
    base = Path(tempfile.mkdtemp(prefix="chip_smoke_session.", dir=build))
    t1 = time.perf_counter()
    try:
        session_phase(torch, base, args.seed + 11, card)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"session phase: {time.perf_counter() - t1:.1f} s in all ({card})")

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
    launches.update({b: svc["batched"]["launches"][k]
                     for k, b in BATCHED.items()
                     if k in svc["batched"]["launches"]})
    launches["sha256_slices_tail_batched"] = \
        svc["batched"]["launches"]["sha256_slices"]
    launches["sha256_slices_fixed"] = \
        mesh["step"]["launches"]["sha256_slices"]
    runs["delta"] = delta["launches"]
    runs["mover.delta"] = mover["delta_pinned"]["launches"]
    runs["mover"] = mover["launches"]
    runs["mover.cold"] = mover["cold"]["launches"]
    for run in ("backup", "backup2", "restore"):
        runs[f"restic.{run}"] = restic[run]["launches"]
    runs["service"] = svc["batched"]["launches"]
    runs["service.per_request"] = svc["per_request"]["launches"]
    for run in ("up", "down", "up2", "down2"):
        runs[f"rclone.{run}"] = rclone[run]["launches"]
    for k in ("batched", "unbatched"):
        runs[f"fleet.{k}"] = fleet[k]["jobs"]["launches"]
    runs["fleet.check"] = fleet["batched"]["check"]["launches"]
    for i, r in enumerate(fleet["batched"]["restores"]):
        runs[f"fleet.restore{i + 1}"] = r["launches"]
    for verb in ("repack", "scrub_rotted"):
        runs[f"fleet.{verb}"] = fleet["cli"][verb]["launches"]
    for run in ("initial", "edits", "conflict"):
        runs[f"syncthing.{run}"] = st[run]["launches"]
    for label in ("fused", "align=64", "align=1"):
        runs[f"mesh.{label}"] = mesh[label]["mesh"]["launches"]
    runs["mesh.fused.default"] = mesh["fused"]["default"]["launches"]
    runs["mesh.step"] = mesh["step"]["launches"]
    runs["mesh.treebackup"] = restic["mesh"]["launches"]
    for i, r in enumerate(op["rounds"]):
        runs[f"operator.round{i + 1}"] = r["launches"]
    runs["operator.restore"] = op["restore"]["launches"]
    for k in ("first", "second"):
        runs[f"operator.rsync.{k}"] = op["rsync"][k]["launches"]
    for k in ("restic", "rclone_up", "rclone_down"):
        runs[f"operator.s3.{k}"] = op["s3"][k]["launches"]
    runs["operator.syncthing"] = op["syncthing"]["launches"]
    kernels = []
    for name in ("transpose_u32", "sha256_pages", "sha256_pages_pagemajor",
                 "sha256_lanes", "sha256_slices", "sha256_slices_tail",
                 "fastcdc_walk", "sha256_rows", "pagemajor_u32",
                 "sha256_pages_sweep", "merkle_roots", "md5_slices",
                 "md5_slices_lanes", *BATCHED.values(),
                 "sha256_slices_fixed"):
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
                      "split", "round_chain", "plain_shape"):
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
