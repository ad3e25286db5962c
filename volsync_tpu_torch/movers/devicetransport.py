"""Device identity + mutually-authenticated P2P transport.

The reference's syncthing daemon authenticates peers with per-device TLS
certificates: a device's ID is derived from its certificate hash, and a
connection is accepted only if the remote's certificate hashes to a
device ID present in the local config
(mover-syncthing/Dockerfile:9-21 vendored syncthing; peers configured by
ID — api/v1alpha1/common_types.go:64-75). This module reproduces that
trust model with stdlib primitives:

- a device's "certificate" is a finite-field Diffie-Hellman keypair
  (RFC 3526 2048-bit MODP group; pure ``pow`` arithmetic);
- ``device_id = sha256(public key)`` — exactly syncthing's cert-hash
  derivation shape;
- connections start with a cleartext pubkey+nonce exchange, each side
  checks the peer's pubkey hashes to a *pinned, expected* device ID
  (IDs come from the CR's peer list, like syncthing's config), and the
  DH shared secret keys the sealed channel (movers/rsync/channel.py) for
  everything after the handshake. An active MITM cannot substitute keys
  without breaking the pinned-ID check.

Ports ``volsync_tpu/movers/devicetransport.py`` whole: the same group,
device IDs, handshake frames and session key, so a port peer and a
reference peer authenticate each other.
"""

from __future__ import annotations

import hashlib
import os
import socket
import struct
from typing import Optional

import msgpack

from volsync_tpu_torch.movers.rsync.channel import (CHANNEL_VERSION,
                                                    ChannelError, Framed,
                                                    box_from_key)

# RFC 3526 group 14 (2048-bit MODP): a public, fixed DH group.
DH_P = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)
DH_G = 2
_KEY_BYTES = 256  # 2048-bit group element


def generate_device_key() -> bytes:
    """Private device key (the TLS-cert analogue) — random exponent."""
    return os.urandom(64)


def public_key(private: bytes) -> bytes:
    x = int.from_bytes(private, "big")
    return pow(DH_G, x, DH_P).to_bytes(_KEY_BYTES, "big")


def device_id(public: bytes) -> str:
    """Syncthing derives device IDs from the cert hash; same shape here."""
    return hashlib.sha256(public).hexdigest()


def device_id_from_private(private: bytes) -> str:
    return device_id(public_key(private))


class PlainFramed:
    """Length-prefixed cleartext msgpack frames — ONLY for the pubkey
    handshake; everything after rides the sealed channel."""

    _MAX = 1 << 20

    def __init__(self, sock: socket.socket):
        self.sock = sock

    def send(self, obj) -> None:
        payload = msgpack.packb(obj, use_bin_type=True)
        self.sock.sendall(struct.pack(">I", len(payload)) + payload)

    def recv(self):
        header = self._read_exact(4)
        (n,) = struct.unpack(">I", header)
        if n > self._MAX:
            raise ChannelError(f"handshake frame too large: {n}")
        return msgpack.unpackb(self._read_exact(n), raw=False)

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            piece = self.sock.recv(n - len(buf))
            if not piece:
                raise ChannelError("peer closed during handshake")
            buf += piece
        return buf


def _session_key(shared: int, nonce_a: bytes, nonce_b: bytes) -> bytes:
    return hashlib.sha256(
        shared.to_bytes(_KEY_BYTES, "big") + min(nonce_a, nonce_b)
        + max(nonce_a, nonce_b)
    ).digest()


def connect_device(address: str, port: int, private: bytes,
                   expect_id: str, timeout: float = 10.0) -> Framed:
    """Dial a peer and mutually authenticate. The caller pins the peer's
    device ID (from the CR's peer list); the peer learns and checks OUR
    ID against its own config on its side."""
    sock = socket.create_connection((address, port), timeout=timeout)
    sock.settimeout(timeout)
    plain = PlainFramed(sock)
    my_pub = public_key(private)
    nonce = os.urandom(16)
    plain.send({"pub": my_pub, "nonce": nonce, "v": CHANNEL_VERSION})
    hello = plain.recv()
    if hello.get("v") != CHANNEL_VERSION:
        # Version rides the CLEARTEXT hello so a mixed-version pair
        # fails here with an explicit error, before either side tries
        # to parse the other's sealed framing.
        sock.close()
        raise ChannelError(
            f"device channel version mismatch: local v{CHANNEL_VERSION}, "
            f"peer v{hello.get('v')}")
    peer_pub, peer_nonce = hello.get("pub"), hello.get("nonce")
    if not isinstance(peer_pub, bytes) or not isinstance(peer_nonce, bytes):
        sock.close()
        raise ChannelError("malformed device hello")
    if device_id(peer_pub) != expect_id:
        sock.close()
        raise ChannelError("peer device ID mismatch (pinned-ID check)")
    shared = pow(int.from_bytes(peer_pub, "big"),
                 int.from_bytes(private, "big"), DH_P)
    ch = Framed(sock, box_from_key(_session_key(shared, nonce, peer_nonce)))
    # Sealed confirm: proves both sides derived the same key (i.e. the
    # cleartext pubkeys weren't tampered with).
    ch.send({"verb": "confirm", "nonce": nonce})
    reply = ch.recv()
    if reply.get("verb") != "confirm-ack" or reply.get("nonce") != nonce:
        ch.close()
        raise ChannelError("session confirm failed")
    return ch


def accept_device(conn: socket.socket, private: bytes,
                  known_ids, timeout: float = 30.0
                  ) -> Optional[tuple[Framed, str]]:
    """Server side of the device handshake. ``known_ids`` is the set of
    configured peer device IDs — anyone else is refused (the config-pinned
    trust model). Returns (sealed channel, peer device id) or None."""
    conn.settimeout(timeout)
    plain = PlainFramed(conn)
    try:
        hello = plain.recv()
        peer_pub, peer_nonce = hello.get("pub"), hello.get("nonce")
        if not isinstance(peer_pub, bytes) or not isinstance(peer_nonce, bytes):
            return None
        peer_id = device_id(peer_pub)
        if peer_id not in set(known_ids):
            # Unknown device: hang up immediately (syncthing refuses
            # certs not in its config the same way).
            conn.close()
            return None
        if hello.get("v") != CHANNEL_VERSION:
            # Reply with OUR hello (it carries our version) before
            # hanging up, so the dialer's version check reports the
            # explicit mismatch instead of "peer closed".
            try:
                plain.send({"pub": public_key(private),
                            "nonce": os.urandom(16),
                            "v": CHANNEL_VERSION})
            except OSError:
                pass
            conn.close()
            return None
        my_nonce = os.urandom(16)
        plain.send({"pub": public_key(private), "nonce": my_nonce,
                    "v": CHANNEL_VERSION})
        shared = pow(int.from_bytes(peer_pub, "big"),
                     int.from_bytes(private, "big"), DH_P)
        ch = Framed(conn,
                    box_from_key(_session_key(shared, peer_nonce, my_nonce)))
        confirm = ch.recv()
        if confirm.get("verb") != "confirm":
            ch.close()
            return None
        ch.send({"verb": "confirm-ack", "nonce": confirm.get("nonce")})
        return ch, peer_id
    except (ChannelError, OSError):
        try:
            conn.close()
        except OSError:
            pass
        return None
