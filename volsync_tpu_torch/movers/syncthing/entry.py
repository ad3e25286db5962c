"""syncthing mover data plane: the always-on live-sync daemon.

Ports ``volsync_tpu/movers/syncthing/entry.py`` whole, on the port's
device transport, sealed channel and hashers. Every file digest is
computed on ``ctx.device`` (None: CUDA; without CUDA
``syncthing_entrypoint`` raises before it binds a port): ``hash_spans``
for a file of at most 32 MiB, ``hash_file_streaming`` above. The index
entries, the wire verbs and the digests are the reference's, so a port
daemon and a reference daemon sync one folder with each other.

The /entry.sh analogue (mover-syncthing/entry.sh:65-138 seeds config and
execs the vendored syncthing binary). Here the daemon itself is part of
the framework: it block-hashes its folder on the card (engine/chunker
hash_spans), serves a control API for the operator (the :8384 REST
analogue, authenticated by the generated API key), exchanges file
indexes with configured peer devices over the mutually-authenticated
device transport (the :22000 BEP analogue), and converges the folder via
version-vectors with last-writer-wins conflict resolution.

Persistence: the device's file index (with version counters and deletion
tombstones) lives in the config volume, exactly what the reference's
config PVC holds for syncthing's database.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
import stat as stat_mod
import threading
import time
from pathlib import Path
from typing import Optional

from volsync_tpu_torch import resolve_device
from volsync_tpu_torch.movers.rsync.channel import ChannelError, serve_session
from volsync_tpu_torch.movers.syncthing import transport

log = logging.getLogger("volsync_tpu_torch.mover.syncthing")

#: Base cadences (seconds). Env-overridable for real deployments
#: (VOLSYNC_ST_SCAN_INTERVAL / VOLSYNC_ST_SYNC_INTERVAL /
#: VOLSYNC_ST_MAX_INTERVAL); the in-process defaults favor test
#: latency. Idle periods BACK OFF geometrically to the max interval —
#: an unchanged folder costs one stat-only walk per (growing) interval,
#: never a re-read or re-hash (the scan's size+mtime gate), so a
#: quiescent volume converges to ~zero IO the way the vendored
#: syncthing's fs-watcher + long rescan does
#: (mover-syncthing/entry.sh's daemon defaults to 3600s rescans).
_SCAN_INTERVAL = 0.2      # local rescan cadence
_SYNC_INTERVAL = 0.3      # peer reconnect/pull cadence
_MAX_INTERVAL = 30.0      # idle-backoff ceiling for both loops
_BACKOFF = 1.6            # growth per idle iteration
_PULL_CHUNK = 4 * 1024 * 1024
#: In-flight pull temp files live in the data folder (same filesystem, so
#: the final rename is atomic) under this prefix, which the scanner and
#: the pull verb both exclude — a crash mid-pull must never replicate a
#: partial file.
_TMP_PREFIX = ".volsync-st-"


def _next_interval(cur: float, base: float, max_iv: float,
                   active: bool) -> float:
    """Idle-backoff step: activity snaps to base, idleness grows
    geometrically toward the ceiling."""
    return base if active else min(cur * _BACKOFF, max_iv)


#: Files above this many bytes hash through ``hash_file_streaming``.
_STREAM_ABOVE = 32 * 1024 * 1024


def _hash_file(path: Path, device) -> str:
    """Device-batched digest of one file on ``device`` (the per-block
    SHA-256 the vendored syncthing does on CPU — here engine/chunker's
    device path); "" for an empty file."""
    from volsync_tpu_torch.engine.chunker import (
        hash_file_streaming,
        hash_spans,
    )

    size = path.stat().st_size
    if size > _STREAM_ABOVE:
        return hash_file_streaming(path, device=device)
    data = path.read_bytes()
    return hash_spans(data, [(0, len(data))], device=device)[0] \
        if data else ""


class FolderIndex:
    """Versioned folder state: {rel: entry} with monotonic version
    counters and deletion tombstones, persisted in the config volume.
    ``device`` is this daemon's device id (``modified_by``);
    ``hash_device`` the torch device its files hash on (None: CUDA)."""

    def __init__(self, store_path: Path, device: str, hash_device=None):
        self.path = store_path
        self.device = device
        self.hash_device = resolve_device(hash_device)
        self.lock = threading.RLock()
        self.entries: dict = {}
        self.max_version = 0
        if store_path.is_file():
            payload = json.loads(store_path.read_text())
            self.entries = payload.get("entries", {})
            self.max_version = payload.get("max_version", 0)

    def save(self):
        with self.lock:
            tmp = self.path.with_suffix(".tmp")
            tmp.write_text(json.dumps(
                {"entries": self.entries, "max_version": self.max_version}))
            tmp.replace(self.path)

    def bump(self) -> int:
        self.max_version += 1
        return self.max_version

    def observe(self, remote_version: int):
        """Lamport merge: local counters always move past anything seen."""
        self.max_version = max(self.max_version, remote_version)

    def scan(self, root: Path) -> bool:
        """Rescan the folder; returns True if anything changed.

        Hashing runs OUTSIDE the lock (a multi-GB new file must not
        stall the device-protocol index handler); the lock is retaken to
        commit, re-stat-ing each hashed file so a write that raced the
        hash is simply picked up by the next scan instead of being
        recorded with a stale digest.
        """
        changed = False
        to_hash: list[tuple[str, Path, object]] = []
        with self.lock:
            seen = set()
            for dirpath, dirnames, filenames in os.walk(root):
                d = Path(dirpath)
                for name in filenames + list(dirnames):
                    if name.startswith(_TMP_PREFIX):
                        continue  # crash-leftover pull temp: never index
                    p = d / name
                    rel = p.relative_to(root).as_posix()
                    st = p.lstat()
                    seen.add(rel)
                    cur = self.entries.get(rel)
                    if stat_mod.S_ISDIR(st.st_mode):
                        ent = {"type": "dir", "mode": st.st_mode & 0o7777}
                    elif stat_mod.S_ISLNK(st.st_mode):
                        ent = {"type": "symlink", "target": os.readlink(p)}
                    elif stat_mod.S_ISREG(st.st_mode):
                        if (cur and cur.get("type") == "file"
                                and not cur.get("deleted")
                                and cur["size"] == st.st_size
                                and cur["mtime_ns"] == st.st_mtime_ns):
                            continue  # unchanged: keep version + digest
                        to_hash.append((rel, p, st))
                        continue
                    else:
                        continue
                    if (cur is None or cur.get("deleted")
                            or {k: cur.get(k) for k in ent} != ent):
                        self.entries[rel] = {
                            **ent, "version": self.bump(),
                            "modified_by": self.device, "deleted": False}
                        changed = True
            for rel, ent in list(self.entries.items()):
                if rel not in seen and not ent.get("deleted"):
                    self.entries[rel] = {
                        "type": ent["type"], "deleted": True,
                        "version": self.bump(), "modified_by": self.device}
                    changed = True

        digests: dict[str, str] = {}
        for rel, p, _ in to_hash:          # slow part, unlocked
            try:
                digests[rel] = _hash_file(p, self.hash_device)
            except OSError:
                pass  # vanished/changing mid-hash: next scan retries

        with self.lock:
            for rel, p, st in to_hash:
                if rel not in digests:
                    continue
                try:
                    now = p.lstat()
                except OSError:
                    continue
                if (now.st_size != st.st_size
                        or now.st_mtime_ns != st.st_mtime_ns
                        or not stat_mod.S_ISREG(now.st_mode)):
                    continue  # raced a writer; next scan re-hashes
                self.entries[rel] = {
                    "type": "file", "size": st.st_size,
                    "mtime_ns": st.st_mtime_ns,
                    "mode": st.st_mode & 0o7777, "digest": digests[rel],
                    "version": self.bump(),
                    "modified_by": self.device, "deleted": False}
                changed = True
            if changed:
                self.save()
        return changed

    def snapshot(self) -> dict:
        with self.lock:
            return {rel: dict(e) for rel, e in self.entries.items()}


class SyncthingDaemon:
    """One folder's daemon, configured by a ``JobContext``: its data and
    config mounts, its API key and device key, and ``ctx.device``."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.hash_device = resolve_device(ctx.device)
        self.data = Path(ctx.mounts["data"])
        self.config_dir = Path(ctx.mounts["config"])
        sec = ctx.secrets["secret"]
        self.apikey = sec["apikey"]
        self.private = sec["cert"]
        self.my_id = transport.device_id_from_private(self.private)
        self.index = FolderIndex(self.config_dir / "index.json", self.my_id,
                                 self.hash_device)
        cfg_path = self.config_dir / "config.json"
        self.config = (json.loads(cfg_path.read_text())
                       if cfg_path.is_file() else {"devices": []})
        self.cfg_path = cfg_path
        self.cfg_lock = threading.RLock()
        self.connected: dict[str, float] = {}  # device id -> last-seen ts
        self.started = time.time()

    # -- config ------------------------------------------------------------

    def put_config(self, config: dict):
        with self.cfg_lock:
            self.config = {"devices": list(config.get("devices", []))}
            tmp = self.cfg_path.with_suffix(".tmp")
            tmp.write_text(json.dumps(self.config))
            tmp.replace(self.cfg_path)

    def peer_devices(self) -> list:
        with self.cfg_lock:
            return [d for d in self.config.get("devices", [])
                    if d.get("id") != self.my_id]

    def known_ids(self):
        return {d["id"] for d in self.peer_devices()}

    # -- control API (the :8384 REST analogue) ------------------------------

    def _control_verbs(self):
        def get_config(msg):
            with self.cfg_lock:
                return {"verb": "ok", "config": self.config}

        def put_config(msg):
            self.put_config(msg.get("config") or {})
            return {"verb": "ok"}

        def get_status(msg):
            return {"verb": "ok", "myID": self.my_id,
                    "uptime": time.time() - self.started}

        def get_connections(msg):
            now = time.time()
            return {"verb": "ok", "connections": {
                d["id"]: {"connected":
                          now - self.connected.get(d["id"], 0) < 5.0,
                          "address": d.get("address", "")}
                for d in self.peer_devices()}}

        return {"get_config": get_config, "put_config": put_config,
                "get_status": get_status,
                "get_connections": get_connections}

    # -- device protocol (the :22000 BEP analogue) ---------------------------

    def _device_verbs(self, peer_id: str):
        def index(msg):
            # Receiving a peer's index piggybacks on their pull loop;
            # we just return ours (both sides pull what they need).
            return {"verb": "ok", "index": self.index.snapshot()}

        def devices(msg):
            # Introduction: a peer that trusts us as an introducer asks
            # for the devices WE know (syncthing's introducer concept —
            # common_types.go:64-75 carries the flag).
            return {"verb": "ok", "devices": [
                {"id": d["id"], "address": d.get("address", "")}
                for d in self.peer_devices()]}

        def pull(msg):
            rel = msg.get("rel", "")
            off = int(msg.get("offset", 0))
            p = (self.data / rel).resolve()
            if not p.is_relative_to(self.data.resolve()):
                raise ChannelError("path escape")
            if p.name.startswith(_TMP_PREFIX):
                return {"verb": "gone"}
            try:
                with open(p, "rb") as f:
                    f.seek(off)
                    piece = f.read(_PULL_CHUNK)
            except OSError:
                return {"verb": "gone"}
            return {"verb": "ok", "data": piece,
                    "eof": len(piece) < _PULL_CHUNK}

        return {"index": index, "pull": pull, "devices": devices}

    # -- sync loop ----------------------------------------------------------

    def _fetch_to_temp(self, ch, rel: str) -> Optional[Path]:
        """Stream a remote file into an excluded temp in the data folder
        (same filesystem -> the later rename is atomic). Runs OUTSIDE the
        index lock: a transfer can take a while and must not block the
        scanner or the index handler serving other peers."""
        tmp = self.data / f"{_TMP_PREFIX}{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "wb") as f:
            off = 0
            while True:
                ch.send({"verb": "pull", "rel": rel, "offset": off})
                reply = ch.recv()
                if reply.get("verb") != "ok":
                    tmp.unlink(missing_ok=True)
                    return None
                piece = reply.get("data", b"")
                f.write(piece)
                off += len(piece)
                if reply.get("eof"):
                    return tmp

    @staticmethod
    def _clear_conflict(target: Path, want: str):
        """A path that changed TYPE (dir->file, file->dir, anything<->
        symlink) must have the old object removed first, or the apply
        raises and wedges the whole peer round. Symlinks are always
        re-created fresh (os.symlink cannot overwrite)."""
        import shutil

        if target.is_symlink():
            if want != "file":  # rename-over replaces a symlink entry fine
                target.unlink()
        elif target.is_dir():
            if want != "dir":
                shutil.rmtree(target, ignore_errors=True)
        elif target.exists():
            if want in ("dir", "symlink"):
                target.unlink()

    def _newer_than_local(self, rel: str, rent: dict) -> bool:
        local = self.index.entries.get(rel)
        self.index.observe(rent["version"])
        if local is None:
            return True
        return (local["version"], local["modified_by"]) < (
            rent["version"], rent["modified_by"])

    def _apply_remote(self, ch, remote_index: dict) -> int:
        """Adopt every remote entry that is strictly newer (version, then
        device-id tiebreak — last-writer-wins). File contents transfer
        outside the index lock; the lock is retaken only for the final
        rename+record (re-checking the version, in case a concurrent
        local write won meanwhile)."""
        applied = 0
        for rel, rent in sorted(remote_index.items()):
            with self.index.lock:
                if not self._newer_than_local(rel, rent):
                    continue
            target = self.data / rel
            if rent.get("deleted"):
                with self.index.lock:
                    if not self._newer_than_local(rel, rent):
                        continue
                    self._clear_conflict(target, "absent")
                    if target.is_dir() and not target.is_symlink():
                        import shutil

                        shutil.rmtree(target, ignore_errors=True)
                    else:
                        target.unlink(missing_ok=True)
                    self.index.entries[rel] = dict(rent)
                    applied += 1
                continue
            if rent["type"] == "file":
                tmp = self._fetch_to_temp(ch, rel)   # slow part, unlocked
                if tmp is None:
                    continue
                # Verify content against the advertised digest BEFORE
                # installing: a pull that raced a live writer on the
                # remote (torn read) must be discarded, not recorded
                # under the remote's metadata — a same-size in-place
                # rewrite would otherwise never be rescanned.
                if rent.get("digest") and \
                        _hash_file(tmp, self.hash_device) != rent["digest"]:
                    tmp.unlink(missing_ok=True)
                    continue  # remote is mid-write; next round re-pulls
                with self.index.lock:
                    if not self._newer_than_local(rel, rent):
                        tmp.unlink(missing_ok=True)
                        continue
                    target.parent.mkdir(parents=True, exist_ok=True)
                    self._clear_conflict(target, "file")
                    tmp.replace(target)
                    os.chmod(target, rent.get("mode", 0o644))
                    os.utime(target,
                             ns=(rent["mtime_ns"], rent["mtime_ns"]))
                    self.index.entries[rel] = dict(rent)
                    applied += 1
                continue
            with self.index.lock:
                if not self._newer_than_local(rel, rent):
                    continue
                if rent["type"] == "dir":
                    self._clear_conflict(target, "dir")
                    target.mkdir(parents=True, exist_ok=True)
                    os.chmod(target, rent.get("mode", 0o755))
                elif rent["type"] == "symlink":
                    self._clear_conflict(target, "symlink")
                    target.parent.mkdir(parents=True, exist_ok=True)
                    os.symlink(rent["target"], target)
                self.index.entries[rel] = dict(rent)
                applied += 1
        if applied:
            with self.index.lock:
                self.index.save()
        return applied

    def _sync_with(self, dev: dict) -> int:
        """One pull pass against a peer; returns the number of entries
        applied (the idle-backoff activity signal)."""
        addr = dev.get("address", "")
        if not isinstance(addr, str) or not addr.startswith("tcp://"):
            return 0  # malformed/foreign address: skip, never crash
        host, _, port = addr[len("tcp://"):].rpartition(":")
        try:
            ch = transport.connect_device(host, int(port), self.private,
                                          dev["id"], timeout=5.0)
        except (OSError, ChannelError, ValueError):
            self.connected.pop(dev["id"], None)
            return 0
        applied = 0
        try:
            ch.send({"verb": "index"})
            reply = ch.recv()
            self.connected[dev["id"]] = time.time()
            applied = self._apply_remote(ch, reply.get("index", {}))
            if dev.get("introducer"):
                ch.send({"verb": "devices"})
                self._adopt_introduced(dev["id"],
                                       ch.recv().get("devices", []))
            ch.send({"verb": "shutdown", "rc": 0})
            ch.recv()
        except (OSError, ChannelError):
            pass
        finally:
            ch.close()
        return applied

    def _adopt_introduced(self, introducer_id: str, devices: list):
        """Reconcile devices learned from an introducer into the live
        config (syncthing's introducer semantics): unknown IDs become
        peers stamped introduced_by; addresses of devices WE got from
        this introducer refresh when the introducer re-advertises them
        (daemons bind ephemeral ports — stale addresses strand peers);
        and devices this introducer no longer advertises are REVOKED
        (real syncthing drops them the same way)."""
        advertised = {
            d["id"]: d.get("address", "")
            for d in devices
            if isinstance(d.get("id"), str)
            and isinstance(d.get("address", ""), str)
            and d["id"] != self.my_id
        }
        with self.cfg_lock:
            out = []
            changed = False
            present = set()
            for dev in self.config.get("devices", []):
                did = dev.get("id")
                present.add(did)
                if dev.get("introduced_by") == introducer_id:
                    if did not in advertised:
                        changed = True  # revoked by the introducer
                        continue
                    if dev.get("address") != advertised[did]:
                        dev = {**dev, "address": advertised[did]}
                        changed = True  # ephemeral port moved
                out.append(dev)
            for did, address in advertised.items():
                if did not in present:
                    out.append({"id": did, "address": address,
                                "introducer": False,
                                "introduced_by": introducer_id})
                    changed = True
            if changed:
                self.put_config({"devices": out})
                log.info("introducer %s reconciled: %d device(s) known",
                         introducer_id[:12], len(out))

    # -- servers ------------------------------------------------------------

    def _serve(self, server: socket.socket, handler):
        server.settimeout(0.2)
        while not self.ctx.stop_event.is_set():
            try:
                conn, _ = server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=handler, args=(conn,),
                             name="st-conn", daemon=True).start()
        server.close()

    def _handle_control(self, conn):
        serve_session(conn, self.apikey, self._control_verbs())

    def _handle_device(self, conn):
        out = transport.accept_device(conn, self.private, self.known_ids())
        if out is None:
            return
        ch, peer_id = out
        self.connected[peer_id] = time.time()
        verbs = self._device_verbs(peer_id)
        try:
            while True:
                msg = ch.recv()
                if peer_id not in self.known_ids():
                    # Removed from the live config mid-session: revoke
                    # immediately, not just at the next handshake.
                    return
                verb = msg.get("verb")
                if verb == "shutdown":
                    ch.send({"verb": "ok"})
                    return
                handler = verbs.get(verb)
                if handler is None:
                    return
                ch.send(handler(msg))
        except (ChannelError, OSError):
            pass
        finally:
            ch.close()

    def _publish_port(self, env_key: str, port: int):
        svc_name = self.ctx.env.get(env_key)
        if not svc_name or self.ctx.cluster is None:
            return
        svc = self.ctx.cluster.try_get("Service", self.ctx.namespace,
                                       svc_name)
        if svc is not None:
            svc.status.bound_port = port
            svc.status.cluster_ip = "127.0.0.1"
            self.ctx.cluster.update_status(svc)

    def run(self) -> int:
        api_srv = socket.create_server(("127.0.0.1", 0))
        data_srv = socket.create_server(("127.0.0.1", 0))
        self._publish_port("SERVICE_API", api_srv.getsockname()[1])
        self._publish_port("SERVICE_DATA", data_srv.getsockname()[1])
        log.info("syncthing daemon %s api=%d data=%d", self.my_id[:12],
                 api_srv.getsockname()[1], data_srv.getsockname()[1])
        threading.Thread(target=self._serve,
                         args=(api_srv, self._handle_control),
                         daemon=True, name="st-api").start()
        threading.Thread(target=self._serve,
                         args=(data_srv, self._handle_device),
                         daemon=True, name="st-data").start()
        def knob(name: str, default: float) -> float:
            raw = self.ctx.env.get(name, os.environ.get(name))
            try:
                return float(raw) if raw is not None else default
            except ValueError:
                log.warning("bad %s=%r, using %s", name, raw, default)
                return default

        scan_base = knob("VOLSYNC_ST_SCAN_INTERVAL", _SCAN_INTERVAL)
        sync_base = knob("VOLSYNC_ST_SYNC_INTERVAL", _SYNC_INTERVAL)
        max_iv = knob("VOLSYNC_ST_MAX_INTERVAL",
                      max(_MAX_INTERVAL, scan_base, sync_base))
        scan_iv, sync_iv = scan_base, sync_base
        last_scan = 0.0
        last_sync = 0.0
        peers_sig: tuple = ()
        while not self.ctx.stop_event.is_set():
            now = time.monotonic()
            if now - last_scan >= scan_iv:
                changed = False
                try:
                    changed = self.index.scan(self.data)
                except OSError as e:
                    log.warning("scan failed: %s", e)
                # Idle backoff: an unchanged folder pays progressively
                # rarer stat-walks; any change snaps back to base.
                scan_iv = _next_interval(scan_iv, scan_base, max_iv, changed)
                last_scan = now
            if now - last_sync >= sync_iv:
                peers = self.peer_devices()
                sig = tuple(sorted(
                    (d.get("id", ""), d.get("address", "")) for d in peers))
                applied = sum(self._sync_with(dev) for dev in peers)
                active = bool(applied) or sig != peers_sig
                if active:
                    # Remote activity (or a peer-set edit through the
                    # control API) resets BOTH loops: fresh pulls mean
                    # local files changed too.
                    scan_iv = scan_base
                    peers_sig = sig
                sync_iv = _next_interval(sync_iv, sync_base, max_iv, active)
                last_sync = now
            self.ctx.stop_event.wait(0.05)
        return 0


def syncthing_entrypoint(ctx) -> int:
    resolve_device(ctx.device)  # raises where CUDA is asked for and absent
    for required in ("SERVICE_API", "SERVICE_DATA"):
        if required not in ctx.env:
            log.error("missing env %s (entry.sh preflight analogue)",
                      required)
            return 2
    return SyncthingDaemon(ctx).run()
