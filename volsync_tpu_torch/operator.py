"""Deployable operator process: the main.go analogue.

Boots the whole stack — in-process cluster + storage provider, the
node-scoped JobRunner (kubelet analogue), the controller Manager with
every registered mover, and the metrics/probes HTTP listener — from a
flag/env configuration layer that mirrors the reference's
pflag+viper setup (main.go:105-183: every flag is env-overridable with
a VOLSYNC_ prefix, like viper's AutomaticEnv).

Run it:
    python -m volsync_tpu_torch.operator --storage-path /var/lib/volsync \
        --metrics-port 8080
(``volsync-manager-torch``), or embed ``OperatorRuntime`` (the tests and
``chip_smoke.py`` do).

Ports ``volsync_tpu/operator.py`` whole, with one flag more: ``device``
(``--device``, ``VOLSYNC_DEVICE``), the device the movers' Jobs run on,
handed to ``JobRunner``. Its default is CUDA, the counterpart of JAX's
default device in the reference; without CUDA a runtime (and so
``main``) raises before it binds its port or takes its storage lock,
unless ``device="cpu"`` is asked for. ``distributed`` joins the port's
``torch.distributed`` group (``parallel/multihost.init_distributed``).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading
from typing import Optional

log = logging.getLogger("volsync_tpu_torch.operator")

#: Flag registry: (name, env var, default, type, help). A CLI flag wins
#: over its env var, which wins over the default (viper precedence).
FLAGS = [
    ("storage-path", "VOLSYNC_STORAGE_PATH", None, str,
     "directory backing provisioned volumes (default: a temp dir)"),
    ("metrics-addr", "VOLSYNC_METRICS_ADDR", "127.0.0.1", str,
     "metrics/probes listen address (main.go metrics :8080)"),
    ("metrics-port", "VOLSYNC_METRICS_PORT", 8080, int,
     "metrics/probes listen port (0 = disabled, -1 = ephemeral)"),
    ("node-name", "VOLSYNC_NODE_NAME", "node-0", str,
     "this runner's node identity (affinity scheduling)"),
    ("runner-workers", "VOLSYNC_RUNNER_WORKERS", 8, int,
     "max concurrent mover payloads on this node"),
    ("manager-workers", "VOLSYNC_MANAGER_WORKERS", 4, int,
     "concurrent reconciles (the reference allows 100; sized for one host)"),
    ("movers", "VOLSYNC_MOVERS", "rsync,rclone,restic,syncthing", str,
     "comma-separated movers to register (registerMovers main.go:67-81)"),
    ("scc-name", "VOLSYNC_SCC_NAME", "volsync-mover", str,
     "runner-policy name granted to per-CR identities (sahandler.go:32-36)"),
    ("distributed", "VOLSYNC_DISTRIBUTED", 0, int,
     "join torch.distributed for a multi-process mesh "
     "(parallel/multihost.py; MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK); "
     "0 = single-process"),
    ("device", "VOLSYNC_DEVICE", "cuda", str,
     "device the movers' Jobs run on (cuda raises where CUDA is absent; "
     "cpu runs the kernels' plain PyTorch versions)"),
]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="volsync-manager",
        description="volsync operator on PyTorch/CUDA: manager + runner + "
                    "metrics",
    )
    for name, env, default, typ, help_text in FLAGS:
        parser.add_argument(
            f"--{name}", type=typ,
            default=None,  # so env fallback below can see "unset"
            help=f"{help_text} [env {env}, default {default!r}]")
    return parser


def resolve_config(args: Optional[argparse.Namespace] = None) -> dict:
    """Flag > env > default, like pflag+viper (main.go:105-128)."""
    out = {}
    for name, env, default, typ, _ in FLAGS:
        attr = name.replace("-", "_")
        val = getattr(args, attr, None) if args is not None else None
        if val is None:
            raw = os.environ.get(env)
            val = typ(raw) if raw is not None else default
        out[attr] = val
    return out


class OperatorRuntime:
    """The running stack; context-manager lifecycle."""

    def __init__(self, config: Optional[dict] = None):
        import tempfile
        from pathlib import Path

        from volsync_tpu_torch import resolve_device
        from volsync_tpu_torch.cluster.cluster import Cluster
        from volsync_tpu_torch.cluster.runner import (EntrypointCatalog,
                                                      JobRunner)
        from volsync_tpu_torch.cluster.storage import StorageProvider
        from volsync_tpu_torch.controller import utils
        from volsync_tpu_torch.controller.manager import Manager
        from volsync_tpu_torch.metrics import Metrics, MetricsServer
        from volsync_tpu_torch.movers.base import Catalog

        cfg = dict(config or resolve_config())
        # First: without the card the runtime raises here, before it
        # makes storage, binds a port or takes the storage lock.
        device = resolve_device(cfg.get("device", "cuda"))
        self._owns_storage = not cfg.get("storage_path")
        storage_path = cfg.get("storage_path") or tempfile.mkdtemp(
            prefix="volsync-operator-")

        self.config = cfg
        self.cluster = Cluster(storage=StorageProvider(Path(storage_path)))
        # Per-CLUSTER setting (ensure_service_account reads it off the
        # cluster handle): a process-global would let co-resident
        # runtimes clobber each other's policy.
        self.cluster.runner_policy = cfg.get("scc_name",
                                             utils.DEFAULT_RUNNER_POLICY)
        self.catalog = Catalog()
        self.runner_catalog = EntrypointCatalog()
        self.metrics = Metrics()
        self._register_movers(cfg.get("movers",
                                      "rsync,rclone,restic,syncthing"))
        self.runner = JobRunner(
            self.cluster, self.runner_catalog,
            max_workers=int(cfg.get("runner_workers", 8)),
            node_name=cfg.get("node_name", "node-0"), device=device)
        self.manager = Manager(self.cluster, catalog=self.catalog,
                               metrics=self.metrics,
                               workers=int(cfg.get("manager_workers", 4)))
        self.metrics_server = None
        port = int(cfg.get("metrics_port", 8080) or 0)
        if port:
            self.metrics_server = MetricsServer(
                self.metrics, host=cfg.get("metrics_addr", "127.0.0.1"),
                port=max(port, 0),  # -1 -> 0 = ephemeral
                ready_check=self._ready)

    def _register_movers(self, movers: str):
        import importlib

        for name in [m.strip() for m in movers.split(",") if m.strip()]:
            mod = importlib.import_module(
                f"volsync_tpu_torch.movers.{name}")
            mod.register(self.catalog, self.runner_catalog)
            log.info("registered mover %s", name)

    def _ready(self) -> bool:
        return bool(self.manager._threads)  # manager started

    # lifecycle -------------------------------------------------------------

    def _acquire_storage_lock(self):
        """Single-writer guard over the storage root (the reference's
        one-manager invariant that main.go:140-153 gets from leader
        election and the Deployment's Recreate strategy): an exclusive
        flock on <storage>/.volsync-manager.lock. A second manager on
        the same root exits with a clear error instead of corrupting
        volumes/status behind the first one's back. Ephemeral demo-mode
        storage (fresh tempdir) needs no guard."""
        if self._owns_storage:
            return
        import fcntl
        import json as json_mod
        import socket
        from pathlib import Path

        path = Path(self.cluster.storage.root) / ".volsync-manager.lock"
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            try:
                holder = os.read(fd, 4096).decode(errors="replace")
            except OSError:
                holder = "?"
            os.close(fd)
            raise SystemExit(
                f"storage path {self.cluster.storage.root} is already "
                f"managed by another volsync-manager ({holder.strip()}); "
                "exactly one manager may own a storage root — stop the "
                "other instance or point VOLSYNC_STORAGE_PATH elsewhere")
        os.ftruncate(fd, 0)
        os.write(fd, json_mod.dumps({
            "pid": os.getpid(), "host": socket.gethostname()}).encode())
        self._storage_lock_fd = fd

    def start(self) -> "OperatorRuntime":
        self._acquire_storage_lock()
        self.runner.start()
        self.manager.start()
        if self.metrics_server is not None:
            self.metrics_server.start()
            log.info("metrics/probes on :%d", self.metrics_server.port)
        return self

    def stop(self):
        if self.metrics_server is not None:
            self.metrics_server.stop()
        self.manager.stop()
        self.runner.stop()
        fd = getattr(self, "_storage_lock_fd", None)
        if fd is not None:
            os.close(fd)  # releases the flock
            self._storage_lock_fd = None
        if self._owns_storage:
            # Ephemeral demo-mode storage: don't leak volume bytes in /tmp.
            import shutil

            shutil.rmtree(self.cluster.storage.root, ignore_errors=True)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    cfg = resolve_config(args)
    if cfg["distributed"]:
        from volsync_tpu_torch.parallel.multihost import init_distributed

        info = init_distributed(require=True, device=cfg["device"])
        log.info("torch.distributed: process %d/%d, %d local / %d global "
                 "devices", info["process_index"], info["process_count"],
                 info["local_devices"], info["global_devices"])
    rt = OperatorRuntime(cfg).start()
    movers = ", ".join(rt.catalog.names())
    log.info("volsync operator up: movers=[%s] node=%s device=%s "
             "storage=%s", movers, cfg["node_name"], rt.runner.device,
             rt.cluster.storage.root)
    stop = threading.Event()

    def _sig(*_):
        stop.set()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    try:
        stop.wait()
    finally:
        rt.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
