"""restic mover data-plane entrypoint (the /entry.sh analogue).

Ports ``volsync_tpu/movers/restic/entry.py`` whole, on the port's
repository, ``TreeBackup`` and ``restore_snapshot``. The engines run on
``ctx.device`` (CUDA when None, raising without it); the reference runs
on JAX's default device. ``VOLSYNC_ENGINE=mesh`` shards the scan with
``parallel.sharded_chunker.MeshChunkHasher`` over ``make_stream_mesh``
of ``ctx.device``: every CUDA device of the process by default, one
shard for an explicit device (``"cpu"`` in the tests).

Dispatches on DIRECTION the way mover-restic/entry.sh dispatches on its
argv verb: ``backup`` ensures the repository exists (probe, then init on
"no repository" — entry.sh:42-57), skips empty volumes, backs up with
the card's engine, applies FORGET_* retention, and optionally prunes;
``restore`` selects a snapshot via RESTORE_AS_OF / SELECT_PREVIOUS and
materializes it. Config arrives exclusively via env + mounts, preserving
the reference's process boundary.

Each Job is one trace (``obs``): it runs under the active trace context
or, without one, a fresh root, with ``stream_id`` the Job's name and
sampled by ``VOLSYNC_TRACE_SAMPLE``, so that every thread of its sync
records into the flight recorder under one trace id. The repository's
open (scrypt inside, ``repo.kdf``) is the span ``mover.restic.open``.
"""

from __future__ import annotations

import logging
import time
from datetime import datetime, timedelta

from volsync_tpu_torch import resolve_device
from volsync_tpu_torch.engine.backup import TreeBackup
from volsync_tpu_torch.engine.restore import restore_snapshot
from volsync_tpu_torch.movers.base import normalize_protocol
from volsync_tpu_torch.objstore.store import open_store
from volsync_tpu_torch.obs import (
    current_context,
    device_trace,
    new_trace,
    span,
    trace_context,
)
from volsync_tpu_torch.repo.repository import (
    DEFAULT_CHUNKER,
    RepoError,
    RepoLockedError,
    Repository,
)

log = logging.getLogger("volsync_tpu_torch.mover.restic")


def _parse_within(value: str) -> timedelta:
    """Duration strings like '3h30m', '2d', '1h' (restic --keep-within)."""
    units = {"d": 86400, "h": 3600, "m": 60, "s": 1}
    total = 0.0
    num = ""
    for ch in value:
        if ch.isdigit() or ch == ".":
            num += ch
        elif ch in units and num:
            total += float(num) * units[ch]
            num = ""
        else:
            raise ValueError(f"bad duration {value!r}")
    if num:  # bare number = seconds
        total += float(num)
    return timedelta(seconds=total)


def _open_or_init(env: dict, device=None) -> Repository:
    with span("mover.restic.open"):
        # env carries the full Secret passthrough (AWS_* credentials
        # included), exactly like the reference's mover pod
        # (restic/mover.go:317-364).
        store = open_store(env["RESTIC_REPOSITORY"], env=env)
        password = env.get("RESTIC_PASSWORD") or None
        # Per-repo chunker-alignment knob (VOLSYNC_CHUNKER_ALIGN, set at
        # CREATION only — existing repos keep their stored config
        # forever). The default align=4096 runs the fused single-dispatch
        # engine but makes cuts content-defined only modulo the 4 KiB
        # phase: inserting a non-page-multiple length desynchronizes the
        # rest of the file from the parent's chunks. Insert-heavy
        # workloads can pick align=1 (fully shift-invariant, classic
        # engine) or 64 (split-phase). See docs/usage.md "Chunker
        # alignment".
        chunker = None
        if env.get("VOLSYNC_CHUNKER_ALIGN"):
            align = int(env["VOLSYNC_CHUNKER_ALIGN"])
            if align not in (1, 64, 4096):
                raise ValueError(
                    f"VOLSYNC_CHUNKER_ALIGN={align}: must be 1 (shift-"
                    "invariant), 64 (split-phase), or 4096 (fused page "
                    "grid)")
            chunker = {**DEFAULT_CHUNKER, "align": align}
        try:
            repo = Repository.open(store, password=password, device=device)
        except RepoError:
            log.info("repository not initialized; creating "
                     "(entry.sh:52-57)")
            try:
                repo = Repository.init(store, password=password,
                                       chunker=chunker, device=device)
            except RepoError:
                # Lost the init race to a concurrent mover sharing this
                # repository: open the winner's (init is atomic, so the
                # config is whole).
                repo = Repository.open(store, password=password,
                                       device=device)
        # Wait out a concurrent holder instead of failing the sync on
        # first contention (shared repositories across CRs are
        # supported).
        repo.default_lock_wait = float(env.get("LOCK_WAIT_SECONDS", "120"))
        return repo


def _forget_kwargs(env: dict) -> dict:
    kw = {}
    for key, name in (("FORGET_LAST", "last"), ("FORGET_HOURLY", "hourly"),
                      ("FORGET_DAILY", "daily"), ("FORGET_WEEKLY", "weekly"),
                      ("FORGET_MONTHLY", "monthly"),
                      ("FORGET_YEARLY", "yearly")):
        if env.get(key):
            kw[name] = int(env[key])
    if env.get("FORGET_WITHIN"):
        kw["within"] = _parse_within(env["FORGET_WITHIN"])
    return kw


#: Mover exit code for "repository locked by another holder" — nonzero so
#: the Job backoff machinery retries the sync (movers/common.py), distinct
#: from the config errors (2) and no-matching-snapshot (3).
RC_LOCKED = 4


#: Mesh hashers memoized per (chunker params, device): a hasher keeps no
#: compiled state in the port, but reusing it keeps one mesh per job
#: stream, as the reference's ``_MESH_HASHERS`` does.
_MESH_HASHERS: dict = {}


def _select_hasher(env: dict, repo: Repository, device=None):
    """VOLSYNC_ENGINE=mesh shards the scan over the device mesh
    (parallel/sharded_chunker.py); the default (None) is the
    single-card engine. Both give bit-identical snapshots, so the
    switch is a throughput and topology choice."""
    if env.get("VOLSYNC_ENGINE", "").lower() != "mesh":
        return None
    from volsync_tpu_torch.engine.chunker import params_from_config
    from volsync_tpu_torch.parallel.sharded_chunker import (
        MeshChunkHasher,
        make_stream_mesh,
    )

    params = params_from_config(repo.chunker_params)
    dev = resolve_device(device)
    key = (params, str(dev))
    hasher = _MESH_HASHERS.get(key)
    if hasher is None:
        every_card = dev.type == "cuda" and dev.index is None
        mesh = make_stream_mesh(None if every_card else [dev])
        hasher = _MESH_HASHERS[key] = MeshChunkHasher(params, mesh=mesh)
    return hasher


def restic_entrypoint(ctx) -> int:
    resolve_device(ctx.device)  # raises where CUDA is asked for and absent
    env = ctx.env
    direction = env.get("DIRECTION", "backup")
    for required in ("RESTIC_REPOSITORY",):
        if required not in env:
            log.error("missing env %s (entry.sh:232-240)", required)
            return 2
    parent = current_context()
    job = (parent.evolve(stream_id=ctx.name) if parent is not None
           else new_trace(stream_id=ctx.name))
    try:
        with trace_context(job):
            return _dispatch(ctx, env, direction)
    except RepoLockedError as ex:
        # Two CRs sharing one repository collide (shared backup vs
        # exclusive forget/prune): fail this attempt cleanly and let the
        # Job retry, don't crash the mover.
        log.warning("repository locked, retrying later: %s", ex)
        return RC_LOCKED


def _dispatch(ctx, env: dict, direction: str) -> int:
    data = ctx.mounts["data"]

    if direction == "backup":
        if not any(data.iterdir()):
            log.info("source is empty, skipping backup (entry.sh:44-50)")
            return 0
        repo = _open_or_init(env, ctx.device)
        hasher = _select_hasher(env, repo, ctx.device)
        t0 = time.perf_counter()
        # SYNC_PROTOCOL=auto delegates per-file full-vs-cdc storage to
        # the cost-model planner (engine/protoplan.py); default stays
        # the reference-equivalent CDC chunking. "delta" makes no sense
        # against a dedup repository and degrades to the default.
        proto = normalize_protocol(env.get("SYNC_PROTOCOL"), default="cdc")
        if proto == "delta":
            proto = "cdc"
        with device_trace("restic-backup"), span("mover.restic.backup"):
            snap_id, stats = TreeBackup(
                repo, hasher=hasher,
                protocol=proto).run(
                data, hostname=env.get("HOSTNAME", "volsync"))
        log.info("backup snapshot=%s stats=%s", snap_id, stats.as_dict())
        ctx.report_transfer(stats.bytes_scanned, time.perf_counter() - t0)
        # Maintenance after a durable snapshot must not fail the sync: a
        # lock collision here defers forget/prune to the next iteration
        # instead of discarding the successful backup (a retry would
        # duplicate the snapshot).
        try:
            kw = _forget_kwargs(env)
            if kw:
                removed = repo.forget(**kw)
                log.info("forget removed %d snapshots", len(removed))
            if env.get("PRUNE") == "1":
                report = repo.prune()
                log.info("prune: %s", report)
        except RepoLockedError as ex:
            log.warning("maintenance deferred (repository locked): %s", ex)
        return 0

    if direction == "prune":
        repo = _open_or_init(env, ctx.device)
        log.info("prune: %s", repo.prune())
        return 0

    if direction == "restore":
        repo = Repository.open(open_store(env["RESTIC_REPOSITORY"], env=env),
                               password=env.get("RESTIC_PASSWORD") or None,
                               device=ctx.device)
        repo.default_lock_wait = float(env.get("LOCK_WAIT_SECONDS", "120"))
        as_of = (datetime.fromisoformat(env["RESTORE_AS_OF"])
                 if env.get("RESTORE_AS_OF") else None)
        previous = int(env.get("SELECT_PREVIOUS", "0"))
        t0 = time.perf_counter()
        out = restore_snapshot(repo, data, restore_as_of=as_of,
                               previous=previous)
        if out is None:
            log.error("no snapshot matches the restore selectors")
            return 3
        log.info("restore: %s", out)
        ctx.report_transfer(out.get("bytes", 0), time.perf_counter() - t0)
        return 0

    log.error("unknown DIRECTION %r", direction)
    return 2
