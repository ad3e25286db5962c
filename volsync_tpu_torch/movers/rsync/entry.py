"""rsync mover data-plane entrypoints (source.sh / destination.sh
analogues).

Destination: bind a listener, publish the bound port on the mover
Service, then serve authenticated sessions restricted to the sync verb
table until the source's ``shutdown <rc>`` arrives — the process exits
with that rc, exactly like the forced-command sshd wrapper
(mover-rsync/destination.sh:19-27, destination-command.sh:4-17).

Source: connect with bounded exponential-backoff retries
(mover-rsync/source.sh:43-62), push a whole-tree delta (the delta scan
on the card, engine/deltasync.py), then send shutdown with the transfer
rc.

Ports ``volsync_tpu/movers/rsync/entry.py`` whole. The engines' device
comes from ``ctx.device`` (CUDA when None, raising without it), or from
the ``device=`` keyword of ``serve_destination``, ``_dest_verbs`` and
``_push_tree``, and every ``deltasync`` call runs there; the reference
runs on JAX's default device.
"""

from __future__ import annotations

import logging
import os
import socket
import stat as stat_mod
import time
from pathlib import Path

from volsync_tpu_torch import envflags, resolve_device
from volsync_tpu_torch.engine import deltasync
from volsync_tpu_torch.engine.backup import _read_xattrs
from volsync_tpu_torch.engine.restore import (_apply_owner, _apply_xattrs,
                                              _write_sparse)
from volsync_tpu_torch.engine.syncstats import book_for
from volsync_tpu_torch.movers import common
from volsync_tpu_torch.movers import devicetransport as dt
from volsync_tpu_torch.movers.rsync import channel
from volsync_tpu_torch.resilience import RetryPolicy

log = logging.getLogger("volsync_tpu_torch.mover.rsync")

MAX_RETRIES = 5  # source.sh:43 (5 attempts, doubling backoff)


# ---------------------------------------------------------------------------
# Destination
# ---------------------------------------------------------------------------


def _apply_meta(path, msg: dict, *, utime: bool = True):
    """xattrs -> chown -> chmod -> utime (the engine's restore order:
    xattrs before a possibly-read-only mode; chown clears suid so
    chmod follows it). Absent keys are skipped — same degrade-to-
    what-the-wire-carries contract as engine/restore."""
    _apply_xattrs(path, msg)
    _apply_owner(path, msg)
    if "mode" in msg:
        os.chmod(path, msg["mode"])
    if utime and "mtime_ns" in msg:
        os.utime(path, ns=(msg["mtime_ns"], msg["mtime_ns"]))


def _dest_verbs(root: Path, *, device=None):
    dev = resolve_device(device)

    def sig(msg):
        path = _safe_join(root, msg["path"])
        if not path.is_file() or path.is_symlink():
            return {"verb": "sig", "exists": False}
        data = path.read_bytes()
        s = deltasync.build_file_signature(
            data, msg.get("block_len") or None, device=dev)
        return {"verb": "sig", "exists": True, **s.to_wire()}

    def apply(msg):
        path = _safe_join(root, msg["path"])
        old = b""
        if path.is_file() and not path.is_symlink():
            old = path.read_bytes()
        ops = [tuple(op) if op[0] == "copy" else ("data", op[1])
               for op in msg["ops"]]
        new = deltasync.apply_delta(ops, old, msg["block_len"])
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.is_dir() or path.is_symlink():
            _rm(path)
        elif path.exists() and (
                not stat_mod.S_ISREG(path.lstat().st_mode)
                or path.lstat().st_nlink > 1):
            # a special (writing "into" a FIFO/device is a hang / data
            # loss) or a hardlinked inode (in-place write would corrupt
            # the other name) occupies the path — replace, don't reuse
            path.unlink()
        with open(path, "wb") as f:
            _write_sparse(f, new)  # rsync -S semantics
            f.truncate(len(new))
        _apply_meta(path, msg)
        return {"verb": "ok", "size": len(new)}

    def mkdir(msg):
        path = _safe_join(root, msg["path"])
        if path.is_symlink() or (path.exists() and not path.is_dir()):
            _rm(path)
        path.mkdir(parents=True, exist_ok=True)
        os.chmod(path, msg["mode"])  # full meta arrives via dirmeta
        return {"verb": "ok"}

    def symlink(msg):
        path = _safe_join(root, msg["path"])
        if path.is_symlink() or path.exists():
            _rm(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        os.symlink(msg["target"], path)
        _apply_xattrs(path, msg)
        _apply_owner(path, msg)
        if "mtime_ns" in msg:
            os.utime(path, ns=(msg["mtime_ns"], msg["mtime_ns"]),
                     follow_symlinks=False)
        return {"verb": "ok"}

    def link(msg):
        """Hardlink (rsync -H): target becomes another name of the
        already-transferred first-sighting path."""
        path = _safe_join(root, msg["path"])
        source = _safe_join(root, msg["to"])
        if not stat_mod.S_ISREG(source.lstat().st_mode):
            # the source names only regular files here; os.link would
            # follow a symlink at ``to`` to whatever it points at
            raise channel.ChannelError(
                f"link source is not a regular file: {msg['to']!r}")
        if path.exists() and not path.is_symlink() \
                and os.path.samestat(path.lstat(), source.lstat()):
            return {"verb": "ok"}
        if path.is_symlink() or path.exists():
            _rm(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        os.link(source, path)
        return {"verb": "ok"}

    def special(msg):
        """FIFO/socket/device nodes (rsync -D)."""
        path = _safe_join(root, msg["path"])
        fmt = msg["fmt"]
        if path.is_symlink() or path.exists():
            st = path.lstat()
            if (stat_mod.S_IFMT(st.st_mode) == fmt
                    and st.st_rdev == msg.get("rdev", 0)):
                _apply_meta(path, msg)
                return {"verb": "ok"}
            _rm(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        if stat_mod.S_ISFIFO(fmt):
            os.mkfifo(path, msg["mode"])
        else:
            try:
                os.mknod(path, fmt | msg["mode"], msg.get("rdev", 0))
            except PermissionError:
                return {"verb": "ok", "skipped": True}  # no CAP_MKNOD
        _apply_meta(path, msg)
        return {"verb": "ok"}

    def dirmeta(msg):
        """Directory metadata, bottom-up AFTER all children are written
        (a child write would bump the parent's restored mtime)."""
        for d in msg["dirs"]:
            path = (_safe_join(root, d["path"]) if d["path"]
                    else root.resolve())
            # chmod and utime follow a symlink: leave one alone
            if path.is_dir() and not path.is_symlink():
                _apply_meta(path, d)
        return {"verb": "ok"}

    def prune(msg):
        """--delete semantics: remove everything not in the keep set."""
        keep = set(msg["paths"])
        removed = 0
        for dirpath, dirs, files in os.walk(root, topdown=False):
            for name in files + dirs:
                p = Path(dirpath, name)
                rel = str(p.relative_to(root))
                if rel not in keep:
                    _rm(p)
                    removed += 1
        return {"verb": "ok", "removed": removed}

    def sigs(msg):
        """Batched ``sig``: one round trip for a whole file batch — the
        round-trip half of the planner's DELTA wire cost (protoplan's
        rt=2 is per BATCH now, which is what makes delta worth pricing
        on high-latency links)."""
        return {"verb": "sigs", "sigs": [sig(item) for item in msg["files"]]}

    return {"sig": sig, "sigs": sigs, "apply": apply, "mkdir": mkdir,
            "symlink": symlink, "link": link, "special": special,
            "dirmeta": dirmeta, "prune": prune}


def serve_destination(root: Path, dst_private: bytes, source_id: str,
                      *, bind: str = "127.0.0.1", preferred_port: int = 0,
                      stop_event=None, on_port=None, device=None) -> int:
    """The listener proper: accept device-authenticated sessions from the
    pinned source device and serve the sync verb table until the source's
    ``shutdown <rc>`` arrives; that rc becomes the exit code, exactly like
    the forced-command sshd wrapper (destination.sh:19-27).

    ``bind`` un-loopbacks the listener for cross-host deployment
    (BIND_ADDRESS env in the mover contract; the standalone listener
    binds 0.0.0.0). ``device`` runs the signatures (CUDA when None,
    raising without it, before the listener binds)."""
    verbs = _dest_verbs(Path(root), device=device)
    try:
        server = socket.create_server((bind, preferred_port))
    except OSError:
        server = socket.create_server((bind, 0))
    port = server.getsockname()[1]
    if on_port is not None:
        on_port(port)
    log.info("rsync destination listening on %s:%d", bind, port)
    server.settimeout(0.5)
    try:
        while stop_event is None or not stop_event.is_set():
            try:
                conn, _ = server.accept()
            except socket.timeout:
                continue
            out = dt.accept_device(conn, dst_private, {source_id})
            if out is None:
                continue  # unknown/failed device: refused at handshake
            ch, _peer = out
            rc = channel.serve_channel(ch, verbs)
            if rc is not None:  # source sent shutdown <rc>
                return rc
        return 1  # stopped without a completed transfer
    finally:
        server.close()


def rsync_destination_entrypoint(ctx) -> int:
    root = ctx.mounts["data"]
    keys = ctx.secrets["keys"]
    # Reuse the previously-published port so the address the source was
    # configured with stays valid across sync iterations (the reference's
    # Service port is stable for the same reason); fall back to an
    # ephemeral port only on first start or if the old port is taken.
    preferred = 0
    svc_name = ctx.env.get("SERVICE")
    if svc_name and ctx.cluster is not None:
        svc = ctx.cluster.try_get("Service", ctx.namespace, svc_name)
        if svc is not None and svc.status.bound_port:
            preferred = svc.status.bound_port
    return serve_destination(
        Path(root), keys["destination"], keys["source-id"].decode(),
        bind=ctx.env.get("BIND_ADDRESS", "127.0.0.1"),
        preferred_port=preferred, stop_event=ctx.stop_event,
        on_port=lambda port: _publish_port(ctx, port), device=ctx.device)


def _publish_port(ctx, port: int):
    """Publish the bound port on the mover Service (the pod's analogue of
    a named containerPort feeding Service endpoints). ``ctx.cluster`` is
    duck-typed: the reference cluster's ``try_get`` and
    ``update_status``."""
    svc_name = ctx.env.get("SERVICE")
    if not svc_name or ctx.cluster is None:
        return
    svc = ctx.cluster.try_get("Service", ctx.namespace, svc_name)
    if svc is not None:
        svc.status.bound_port = port
        if svc.spec.type == "LoadBalancer":
            svc.status.load_balancer_ip = "127.0.0.1"
        svc.status.cluster_ip = "127.0.0.1"
        ctx.cluster.update_status(svc)


# ---------------------------------------------------------------------------
# Source
# ---------------------------------------------------------------------------


class _PushCancelled(Exception):
    """stop_event fired between attempts — classified fatal, so the
    retry policy aborts instead of backing off."""


def rsync_source_entrypoint(ctx) -> int:
    dev = resolve_device(ctx.device)  # raises before any connection
    root = Path(ctx.mounts["data"])
    keys = ctx.secrets["keys"]
    src_private = keys["source"]
    dest_id = keys["destination-id"].decode()
    address = ctx.env["ADDRESS"]
    port = int(ctx.env["PORT"])

    # source.sh:43-62 semantics via the shared layer: MAX_RETRIES
    # attempts, 2s-based growing backoff; FAST_RETRY (tests) caps every
    # sleep at 1s exactly as the old inline min(delay, 1.0) did.
    policy = RetryPolicy.from_env(
        "rsync.push", max_attempts=MAX_RETRIES, base_delay=2.0,
        max_delay=(1.0 if ctx.env.get("FAST_RETRY") else 60.0),
        retryable=(OSError, channel.ChannelError))

    def push_once() -> int:
        if ctx.stop_event.is_set():
            raise _PushCancelled()
        # Mutual device auth: we pin the destination's ID, it pins
        # ours — neither side ever held the other's private key.
        ch = dt.connect_device(address, port, src_private, dest_id)
        try:
            t0 = time.perf_counter()
            stats = _push_tree(ch, root, device=dev)
            ch.send({"verb": "shutdown", "rc": 0})
            ch.recv()
            log.info("rsync push complete: %s", stats)
            ctx.report_transfer(stats.get("bytes", 0),
                                time.perf_counter() - t0)
            return 0
        finally:
            ch.close()

    try:
        return policy.call(push_once)
    except _PushCancelled:
        return 1
    except (OSError, channel.ChannelError) as e:
        log.error("rsync push failed after %d attempts: %s", MAX_RETRIES, e)
        return 1


def _meta_of(st, p=None) -> dict:
    """Wire metadata for one node: mode/mtime always, uid/gid always
    (root:root must converge at the destination too), xattrs
    only-when-present — mirrors engine/backup's tree-entry contract."""
    out = {"mode": st.st_mode & 0o7777, "mtime_ns": st.st_mtime_ns,
           "uid": st.st_uid, "gid": st.st_gid}
    if p is not None:
        xs = _read_xattrs(p)
        if xs:
            out["xattrs"] = xs
    return out


def _push_tree(ch, root: Path, *, device=None) -> dict:
    dev = resolve_device(device)
    stats = {"files": 0, "literal_bytes": 0, "copied_bytes": 0, "bytes": 0}
    keep: list[str] = []
    dirmeta: list[dict] = []
    inode_first: dict = {}  # (dev, ino) -> rel (rsync -H)
    # Regular files accumulate into planner-driven batches (one sig
    # round trip + one device dispatch ladder per batch); VOLSYNC_DELTA_BATCH=1
    # keeps the legacy serial per-file path.
    batch_n = envflags.delta_batch_files()
    pending: list[tuple] = []

    def flush():
        if pending:
            _push_files_batch(ch, pending, stats, dev)
            pending.clear()
    # rsync -x: one file system. stat(), not lstat(): a SYMLINKED
    # replication root (mount indirection) must anchor the device id at
    # the walk's actual filesystem, or every entry looks foreign and
    # prune would wipe the destination.
    root_dev = root.stat().st_dev
    for dirpath, dirs, files in os.walk(root):
        dirs.sort()
        for name in sorted(files) + dirs:
            p = Path(dirpath, name)
            rel = str(p.relative_to(root))
            st = p.lstat()
            if st.st_dev != root_dev:
                # -x semantics: a mount point appears as an EMPTY dir
                # (created below if a dir), its contents never cross
                if stat_mod.S_ISDIR(st.st_mode):
                    dirs.remove(name)  # don't descend
                else:
                    continue  # foreign non-dir: skip entirely
            keep.append(rel)
            if stat_mod.S_ISLNK(st.st_mode):
                ch.send({"verb": "symlink", "path": rel,
                         "target": os.readlink(p), **_meta_of(st, p)})
                ch.recv()
            elif stat_mod.S_ISDIR(st.st_mode):
                ch.send({"verb": "mkdir", "path": rel,
                         "mode": st.st_mode & 0o7777})
                ch.recv()
                dirmeta.append({"path": rel, **_meta_of(st, p)})
            elif stat_mod.S_ISREG(st.st_mode):
                if st.st_nlink > 1:
                    ino = (st.st_dev, st.st_ino)
                    first = inode_first.get(ino)
                    if first is not None:
                        # the link target must already exist at the
                        # destination — drain any batch holding it
                        flush()
                        ch.send({"verb": "link", "path": rel,
                                 "to": first})
                        ch.recv()
                        stats["files"] += 1
                        continue
                    inode_first[ino] = rel
                if batch_n <= 1:
                    _push_file(ch, p, rel, st, stats, dev)
                else:
                    pending.append((p, rel, st))
                    if len(pending) >= batch_n:
                        flush()
            elif stat_mod.S_ISFIFO(st.st_mode) or stat_mod.S_ISSOCK(
                    st.st_mode) or stat_mod.S_ISBLK(st.st_mode) \
                    or stat_mod.S_ISCHR(st.st_mode):
                msg = {"verb": "special", "path": rel,
                       "fmt": stat_mod.S_IFMT(st.st_mode),
                       **_meta_of(st, p)}
                if stat_mod.S_ISBLK(st.st_mode) or stat_mod.S_ISCHR(
                        st.st_mode):
                    msg["rdev"] = st.st_rdev
                ch.send(msg)
                ch.recv()
    flush()
    ch.send({"verb": "prune", "paths": keep})
    ch.recv()
    # Directory metadata last, children-first (deepest paths first),
    # with the replication ROOT itself last of all (path "" — rsync -a
    # with a trailing slash replicates the root dir's meta too):
    # every write above would have bumped the parent's mtime.
    dirmeta.sort(key=lambda d: d["path"].count(os.sep), reverse=True)
    dirmeta.append({"path": "", **_meta_of(root.lstat(), root)})
    ch.send({"verb": "dirmeta", "dirs": dirmeta})
    ch.recv()
    return stats


def _push_file(ch, path: Path, rel: str, st, stats: dict, device):
    data = path.read_bytes()
    block_len = deltasync.pick_block_len(max(len(data), st.st_size))
    ch.send({"verb": "sig", "path": rel, "block_len": block_len})
    reply = ch.recv()
    if reply.get("exists"):
        sig = deltasync.FileSignature.from_wire(reply)
        ops = deltasync.compute_delta(data, sig, device=device)
        block_len = sig.block_len
    else:
        ops = [("data", data)] if data else []
    wire_ops = [list(op) for op in ops]
    ch.send({"verb": "apply", "path": rel, "ops": wire_ops,
             "block_len": block_len, **_meta_of(st, path)})
    out = ch.recv()
    if out.get("verb") != "ok":
        raise channel.ChannelError(f"apply failed for {rel}: {out}")
    d = deltasync.delta_stats(ops, block_len)
    stats["files"] += 1
    stats["bytes"] += len(data)
    stats["literal_bytes"] += d["literal_bytes"]
    stats["copied_bytes"] += d["copied_bytes"]


def _push_files_batch(ch, jobs: list, stats: dict, device):
    """Planner-driven batch push: price FULL vs DELTA per file
    (movers.common.plan_protocol -> engine/protoplan), fetch signatures
    for all delta-planned files in ONE ``sigs`` round trip, run the
    delta scan for the whole batch through ONE device dispatch ladder
    (deltasync.delta_scan_batch), then apply per file. Every completed
    delta and timed round trip feeds the rsync ``SyncStatsBook``, so the
    planner's next batch prices against what this one actually cost."""
    book = book_for("rsync")
    datas = [p.read_bytes() for p, _rel, _st in jobs]
    plans = []
    for (p, rel, st), data in zip(jobs, datas):
        block_len = deltasync.pick_block_len(max(len(data), st.st_size))
        decision = common.plan_protocol(
            "rsync", len(data), candidates=("full", "delta"),
            block_len=block_len)
        plans.append((decision.protocol, block_len))
    want = [i for i, (proto, _bl) in enumerate(plans) if proto == "delta"]
    sig_by_idx: dict = {}
    if want:
        # NOT timed as a latency sample: the reply embeds the
        # destination's signature computation (and, first time, its
        # kernels' build), which would poison the rtt EWMA by orders of
        # magnitude. Small apply acks below are the latency proxy.
        ch.send({"verb": "sigs", "files": [
            {"path": jobs[i][1], "block_len": plans[i][1]} for i in want]})
        reply = ch.recv()
        for i, r in zip(want, reply["sigs"]):
            if r.get("exists"):
                sig_by_idx[i] = deltasync.FileSignature.from_wire(r)
    scanned = [i for i in want if i in sig_by_idx]
    batch_ops = deltasync.delta_scan_batch(
        [(datas[i], sig_by_idx[i]) for i in scanned],
        device=device) if scanned else []
    ops_by_idx = dict(zip(scanned, batch_ops))
    for idx, ((p, rel, st), data) in enumerate(zip(jobs, datas)):
        _proto, block_len = plans[idx]
        if idx in ops_by_idx:
            ops = ops_by_idx[idx]
            block_len = sig_by_idx[idx].block_len
        else:
            # planner said FULL, or the destination has no basis: the
            # whole file ships as one literal op (still delta framing)
            ops = [("data", data)] if data else []
        wire_ops = [list(op) for op in ops]
        t0 = time.perf_counter()
        ch.send({"verb": "apply", "path": rel, "ops": wire_ops,
                 "block_len": block_len, **_meta_of(st, p)})
        out = ch.recv()
        elapsed = time.perf_counter() - t0
        if out.get("verb") != "ok":
            raise channel.ChannelError(f"apply failed for {rel}: {out}")
        d = deltasync.delta_stats(ops, block_len)
        if idx in ops_by_idx:
            book.observe_delta(d["literal_bytes"], len(data))
        # same small/large split as resilience.link_totals(): bulk
        # applies sample bandwidth, near-empty ones sample latency
        if d["literal_bytes"] >= 16 * 1024:
            book.observe_link(d["literal_bytes"], elapsed)
        else:
            book.observe_rtt(elapsed)
        stats["files"] += 1
        stats["bytes"] += len(data)
        stats["literal_bytes"] += d["literal_bytes"]
        stats["copied_bytes"] += d["copied_bytes"]


# ---------------------------------------------------------------------------


def _safe_join(root: Path, rel: str) -> Path:
    """``root / rel`` with its directories resolved and refused if it
    escapes ``root``. The last component is not followed: a symlink the
    destination already holds at ``rel`` is the path itself, which the
    verbs replace, not its target. (The reference resolves it too, so a
    second sync of a tree with a symlink replaces the link's target
    with a link to itself: ROADMAP queue 3.) So no verb may act
    through such a link: ``apply``, ``mkdir``, ``symlink``, ``link``
    and ``special`` replace it, ``link`` refuses a ``to`` that is not a
    regular file, and ``dirmeta`` skips it."""
    joined = root / rel
    if joined.name in ("", ".", ".."):
        p = joined.resolve()
    else:
        p = joined.parent.resolve() / joined.name
    base = root.resolve()
    if not str(p).startswith(str(base) + os.sep) and p != base:
        raise channel.ChannelError(f"path escapes root: {rel!r}")
    return p


def _rm(path: Path):
    import shutil

    if path.is_dir() and not path.is_symlink():
        shutil.rmtree(path, ignore_errors=True)
    else:
        # symlinks, regular files, AND specials (FIFO/socket/device:
        # is_file() is False for those — the same fix as
        # engine/restore._rmtree; a no-op here would make the
        # replacement verbs raise FileExistsError and prune leave
        # stale specials behind while still counting them removed)
        path.unlink(missing_ok=True)
