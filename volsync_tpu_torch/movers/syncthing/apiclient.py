"""Typed client for the live daemon's control API.

Ports ``volsync_tpu/movers/syncthing/apiclient.py`` whole, over the
port's sealed channel (``movers/rsync/channel.client_connect``), which
speaks the reference's wire: either package's client talks to either
package's daemon.

Mirrors controllers/mover/syncthing/api/connection.go:29-73: a minimal
typed connection exposing exactly the three read endpoints
(/rest/config, /rest/system/status, /rest/system/connections) plus
config publication, authenticated with the generated API key. The
transport is the framework's sealed channel instead of HTTPS, but the
interface shape — ``Fetch()`` populating config/status/connections and
``PublishConfig()`` — is the same, so the mover's reconcile logic reads
like the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from volsync_tpu_torch.movers.rsync.channel import ChannelError, client_connect


@dataclasses.dataclass
class SyncthingState:
    """What one Fetch() observes (api/types.go:80-86 analogue)."""

    config: dict
    my_id: str
    connections: dict  # device id -> {"connected": bool, "address": str}


class SyncthingConnection:
    """One control-API session target (api/connection.go:29-33)."""

    def __init__(self, address: str, port: int, apikey: bytes,
                 timeout: float = 5.0):
        self.address = address
        self.port = port
        self.apikey = apikey
        self.timeout = timeout

    def _session(self):
        return client_connect(self.address, self.port, self.apikey,
                              timeout=self.timeout)

    @staticmethod
    def _call(ch, verb: str, **payload) -> dict:
        ch.send({"verb": verb, **payload})
        reply = ch.recv()
        if reply.get("verb") != "ok":
            raise ChannelError(f"{verb} failed: {reply}")
        return reply

    @staticmethod
    def _end(ch):
        ch.send({"verb": "shutdown", "rc": 0})
        ch.recv()

    def fetch(self) -> SyncthingState:
        """GET config + system status + connections in ONE session
        (connection.go:37-61 issues three requests per Fetch; the sealed
        channel serves them all without re-handshaking)."""
        ch = self._session()
        try:
            config = self._call(ch, "get_config")["config"]
            status = self._call(ch, "get_status")
            conns = self._call(ch, "get_connections")["connections"]
            self._end(ch)
        finally:
            ch.close()
        return SyncthingState(config=config, my_id=status["myID"],
                              connections=conns)

    def publish_config(self, config: dict) -> None:
        """PUT /rest/config (connection.go:65-73)."""
        ch = self._session()
        try:
            self._call(ch, "put_config", config=config)
            self._end(ch)
        finally:
            ch.close()


def try_fetch(address: str, port: int,
              apikey: bytes) -> Optional[SyncthingState]:
    """Fetch, or None while the daemon is still coming up (the reference
    re-polls on connection errors — mover.go:205-236)."""
    try:
        return SyncthingConnection(address, port, apikey).fetch()
    except (OSError, ChannelError):
        return None
