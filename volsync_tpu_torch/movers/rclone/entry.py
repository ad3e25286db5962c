"""rclone mover data-plane entrypoint (the /active.sh analogue).

Ports ``volsync_tpu/movers/rclone/entry.py`` whole, on the port's
``sync_up`` / ``sync_down`` and ``open_store``. The digests are computed
on ``ctx.device`` (CUDA when None, raising without it before the remote
is opened); the reference runs on JAX's default device.

Dispatches on DIRECTION exactly as mover-rclone/active.sh:22-37 does:
``source`` mirrors the data volume into the configured bucket,
``destination`` mirrors the bucket into the data volume. Configuration
arrives via env (RCLONE_DEST_PATH, DIRECTION, RCLONE_CONFIG_SECTION —
controllers/mover/rclone/mover.go:236-242) plus the mounted config
secret, whose ``rclone.conf`` is an INI of named remotes:

    [bucket]
    url = file:///mnt/bucket        # any objstore.open_store URL

The section named by RCLONE_CONFIG_SECTION selects the remote;
RCLONE_DEST_PATH is the key prefix within it.
"""

from __future__ import annotations

import configparser
import logging
import time

from volsync_tpu_torch import resolve_device
from volsync_tpu_torch.movers.rclone.sync import SyncError, sync_down, sync_up
from volsync_tpu_torch.objstore.store import open_store

log = logging.getLogger("volsync_tpu_torch.mover.rclone")

SECRET_MOUNT = "rclone-secret"
CONFIG_KEY = "rclone.conf"


def _open_remote(ctx, env: dict):
    section = env["RCLONE_CONFIG_SECTION"]
    conf_bytes = ctx.secrets.get(SECRET_MOUNT, {}).get(CONFIG_KEY)
    if conf_bytes is None:
        log.error("config secret has no %s", CONFIG_KEY)
        return None, None
    cp = configparser.ConfigParser()
    cp.read_string(conf_bytes.decode())
    if section not in cp:
        log.error("rclone.conf has no section [%s]", section)
        return None, None
    url = cp[section].get("url")
    if not url:
        log.error("section [%s] has no url", section)
        return None, None
    # rclone.conf remote options -> the AWS env contract open_store
    # expects (rclone's s3 remotes carry the same fields by these names),
    # overlaid on the mover env so credentials can come from either the
    # conf section or the Secret->env passthrough.
    store_env = dict(env)
    for opt, var in (("access_key_id", "AWS_ACCESS_KEY_ID"),
                     ("secret_access_key", "AWS_SECRET_ACCESS_KEY"),
                     ("endpoint", "AWS_S3_ENDPOINT"),
                     ("region", "AWS_DEFAULT_REGION")):
        if cp[section].get(opt):
            store_env[var] = cp[section][opt]
    try:
        return open_store(url, env=store_env), env["RCLONE_DEST_PATH"]
    except ValueError as ex:
        # Misconfigured URL/credentials is a config error like the rest of
        # this function's cases: log and fail the attempt, don't traceback.
        log.error("cannot open remote [%s] %s: %s", section, url, ex)
        return None, None


def rclone_entrypoint(ctx) -> int:
    resolve_device(ctx.device)  # raises where CUDA is asked for and absent
    env = ctx.env
    for required in ("RCLONE_DEST_PATH", "DIRECTION",
                     "RCLONE_CONFIG_SECTION"):
        if not env.get(required):
            log.error("%s must be defined (active.sh:16-17)", required)
            return 1
    store, prefix = _open_remote(ctx, env)
    if store is None:
        return 1
    data = ctx.mounts["data"]
    transfers = int(env.get("TRANSFERS", "10"))
    direction = env["DIRECTION"]
    t0 = time.perf_counter()
    try:
        if direction == "source":
            stats = sync_up(data, store, prefix, transfers=transfers,
                            device=ctx.device)
        elif direction == "destination":
            stats = sync_down(store, prefix, data, transfers=transfers,
                              device=ctx.device)
        else:
            log.error("unknown value for DIRECTION: %s", direction)
            return 1
    except SyncError as ex:
        log.error("sync failed: %s", ex)
        return 1
    dt = time.perf_counter() - t0
    log.info("rclone completed in %.1fs %s", dt, stats)
    ctx.report_transfer(stats.get("bytes", 0), dt)
    return 0
