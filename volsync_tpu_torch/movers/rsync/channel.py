"""Mutually-authenticated framed channel (the SSH-tunnel analogue).

Ports ``volsync_tpu/movers/rsync/channel.py`` whole, on the port's
``repo/crypto.SecretBox`` and ``repo/compress``. The wire is the
reference's byte for byte, so a port peer and a reference peer talk to
each other. Where the ``zstandard`` wheel is absent the ``Compressor``
writes zlib and the ``Decompressor`` reads either codec; the flag byte
``_FLAG_ZSTD`` means "compressed" whichever codec wrote the body.

The reference secures its data channel with SSH: generated keypairs in
Secrets, mutual pubkey auth, and a forced command restricting the remote
to exactly two verbs (mover-rsync/destination-command.sh:23-33). This
channel keeps that security envelope with the primitives at hand: a
32-byte pre-shared key from the generated Secret, per-frame
AES-256-CTR + HMAC-SHA256 sealing (repo/crypto.py), a key-possession
handshake both ways, and a server loop that dispatches only a fixed verb
table — anything else closes the connection.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import os
import socket
import struct
from typing import Callable, Optional

import msgpack

from volsync_tpu_torch.repo.compress import (CompressError, Compressor,
                                              Decompressor)
from volsync_tpu_torch.repo.crypto import IntegrityError, SecretBox

_MAX_FRAME = 256 * 1024 * 1024

#: Wire-format generation of the sealed framing. v2 added the
#: raw/zstd flag byte inside the seal; the version is exchanged in a
#: fixed-format CLEARTEXT preamble (below) so a mixed-version
#: source/destination pair (rolling operator upgrade) fails with an
#: explicit version-mismatch error instead of an opaque
#: msgpack/unknown-flag failure mid-sync — the preamble layout is
#: frozen, so the check works across any framing change from v2
#: onward (peers older than the preamble itself are diagnosed as
#: "pre-v2 peer"). Bump on any framing change. The preamble carries no
#: secrets; tampering with it can only refuse a connection (DoS-
#: equivalent to dropping packets), never weaken the sealed channel.
CHANNEL_VERSION = 2
_PREAMBLE_MAGIC = b"VSCH"
_PREAMBLE_LEN = 8  # magic + >I version — FROZEN for all versions


def _preamble() -> bytes:
    return _PREAMBLE_MAGIC + struct.pack(">I", CHANNEL_VERSION)


def _exchange_preamble(ch: "Framed") -> int:
    """Both sides write the 8-byte cleartext preamble immediately on
    connect (no deadlock) and read the peer's; returns the peer's
    version. The layout is frozen, so this works across any framing
    change from v2 onward; a peer that predates the preamble entirely
    (or a non-volsync client) draws an explicit ChannelError — the
    best possible diagnosis, since such a peer speaks no preamble we
    could negotiate with."""
    ch.sock.sendall(_preamble())
    try:
        peer = ch._read_exact(_PREAMBLE_LEN)
    except ChannelError:
        # A pre-preamble peer misparses our magic as a frame header
        # (~1.4 GB length), errors out and hangs up without writing —
        # diagnose that instead of reporting the bare EOF.
        raise ChannelError(
            "peer hung up during the version preamble exchange "
            "(pre-v2 peer, or not a volsync channel)") from None
    if peer[:4] != _PREAMBLE_MAGIC:
        raise ChannelError(
            "peer sent no version preamble (pre-v2 peer or not a "
            "volsync channel)")
    (peer_v,) = struct.unpack(">I", peer[4:])
    return peer_v


class ChannelError(RuntimeError):
    pass


def box_from_key(key: bytes) -> SecretBox:
    """Derive directional-agnostic enc/mac keys from the shared secret."""
    enc = hmac_mod.new(key, b"volsync-channel-enc", hashlib.sha256).digest()
    mac = hmac_mod.new(key, b"volsync-channel-mac", hashlib.sha256).digest()
    return SecretBox(enc, mac)


#: Frames above this compress before sealing (rsync -z analogue;
#: mover-rsync/source.sh:54). Small control frames skip the overhead.
_COMPRESS_MIN = 1024
_FLAG_RAW = b"\x00"
_FLAG_ZSTD = b"\x01"


class Framed:
    """Sealed, length-prefixed msgpack frames over a socket.

    Plaintext layout (inside the seal): 1 flag byte (0 raw / 1 zstd)
    then the msgpack body — compress-then-encrypt, the rsync -z
    analogue. Compression is applied only when it actually shrinks the
    body (already-compressed file data falls back to raw)."""

    def __init__(self, sock: socket.socket, box: SecretBox):
        self.sock = sock
        self.box = box
        self._c = Compressor(level=3)
        self._d = Decompressor()

    def send(self, obj) -> None:
        body = msgpack.packb(obj, use_bin_type=True)
        plain = _FLAG_RAW + body
        if len(body) >= _COMPRESS_MIN:
            z = self._c.compress(body)
            if len(z) < len(body):
                plain = _FLAG_ZSTD + z
        payload = self.box.seal(plain)
        self.sock.sendall(struct.pack(">I", len(payload)) + payload)

    def recv(self):
        header = self._read_exact(4)
        (n,) = struct.unpack(">I", header)
        if n > _MAX_FRAME:
            raise ChannelError(f"frame too large: {n}")
        try:
            plain = self.box.open(self._read_exact(n))
        except IntegrityError as e:
            raise ChannelError(f"authentication failure: {e}") from None
        if not plain:
            raise ChannelError("empty frame")
        flag, body = plain[:1], plain[1:]
        if flag == _FLAG_ZSTD:
            try:
                # bound decompressed size: a corrupt or oversized frame
                # must not OOM us (the peer is inside the auth envelope)
                body = self._d.decompress(body,
                                          max_output_size=_MAX_FRAME)
            except CompressError as e:
                raise ChannelError(f"bad compressed frame: {e}") from None
        elif flag != _FLAG_RAW:
            raise ChannelError(
                f"unknown frame flag: {flag!r} (peer running an "
                f"incompatible channel version? local v{CHANNEL_VERSION})")
        try:
            return msgpack.unpackb(body, raw=False)
        except Exception as e:  # msgpack's error zoo is not one type
            raise ChannelError(
                f"malformed frame body (peer running an incompatible "
                f"channel version? local v{CHANNEL_VERSION}): {e}"
            ) from None

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            piece = self.sock.recv(n - len(buf))
            if not piece:
                raise ChannelError("peer closed connection")
            buf += piece
        return buf

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def client_connect(address: str, port: int, key: bytes,
                   timeout: float = 10.0) -> Framed:
    sock = socket.create_connection((address, port), timeout=timeout)
    sock.settimeout(timeout)
    ch = Framed(sock, box_from_key(key))
    # Cleartext version preamble BEFORE any sealed frame, so mismatched
    # peers never have to parse each other's version-dependent framing.
    try:
        peer_v = _exchange_preamble(ch)
        if peer_v != CHANNEL_VERSION:
            raise ChannelError(
                f"channel version mismatch: local v{CHANNEL_VERSION}, "
                f"peer v{peer_v}")
    except ChannelError:
        ch.close()
        raise
    except OSError as e:
        # socket.timeout / ECONNRESET from a half-open or hung peer:
        # close the fd and surface the ChannelError callers expect.
        ch.close()
        raise ChannelError(f"preamble exchange failed: {e}") from None
    nonce = os.urandom(16)
    ch.send({"verb": "hello", "nonce": nonce})
    reply = ch.recv()  # decrypting proves the server holds the key
    if reply.get("verb") != "hello-ack" or reply.get("nonce") != nonce:
        ch.close()
        raise ChannelError("handshake failed")
    return ch


def serve_channel(ch: Framed,
                  verbs: dict[str, Callable[[dict], dict]]) -> Optional[int]:
    """Serve verbs over an ALREADY-authenticated channel (PSK hello or
    the device-transport DH handshake). Returns the rc passed to the
    ``shutdown`` verb, or None if the peer just disconnected. Unknown
    verbs terminate the session (forced-command discipline)."""
    try:
        while True:
            try:
                msg = ch.recv()
            except (ChannelError, OSError):
                # Includes socket.timeout: a stalled peer drops ITS
                # session; the listener's accept loop must survive.
                return None
            verb = msg.get("verb")
            if verb == "shutdown":
                ch.send({"verb": "ok"})
                return int(msg.get("rc", 0))
            handler = verbs.get(verb)
            if handler is None:
                return None  # not in the allowed verb table: hang up
            ch.send(handler(msg))
    finally:
        ch.close()


def serve_session(conn: socket.socket, key: bytes,
                  verbs: dict[str, Callable[[dict], dict]],
                  timeout: float = 30.0) -> Optional[int]:
    """Serve one PSK-authenticated session. ``verbs`` maps verb name ->
    handler(msg)->reply; MAC failures terminate immediately."""
    conn.settimeout(timeout)
    ch = Framed(conn, box_from_key(key))
    try:
        # Cleartext preamble exchange (see _exchange_preamble): version
        # mismatch hangs up here, before either side parses the
        # other's sealed framing. OSError covers a peer that RSTs
        # mid-handshake (port scanner, crashed mover) — the listener's
        # handler thread must survive it.
        if _exchange_preamble(ch) != CHANNEL_VERSION:
            ch.close()
            return None
        hello = ch.recv()  # MAC-validated: proves the client holds the key
        if hello.get("verb") != "hello":
            ch.close()
            return None
        ch.send({"verb": "hello-ack", "nonce": hello.get("nonce")})
    except (ChannelError, OSError):
        ch.close()
        return None
    return serve_channel(ch, verbs)
