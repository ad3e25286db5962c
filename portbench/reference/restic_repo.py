"""A plain reader of the repository format, for judging what a sync
stored. Written from the format:

- ``config`` (JSON): ``chunker``, ``salt`` (hex) and ``verifier`` (hex,
  the sealed text ``b"volsync-tpu repository key verifier v1"``);
- keys: ``scrypt(password, salt, n=2**15, r=8, p=1)`` -> 64 bytes, the
  first 32 the cipher key, the last 32 the MAC key;
- a sealed object is ``nonce(16) || ciphertext || HMAC-SHA256(mac key,
  nonce || ciphertext)``; the cipher is AES-256-CTR where the
  ``cryptography`` wheel is installed, else XOR with SHAKE-256(key ||
  nonce);
- a blob in a pack at (offset, length) is one sealed object whose
  plaintext is a flag byte, 1 for compressed (zlib, or zstd where its
  magic leads), 0 for raw, and the payload;
- ``index/*``: sealed, compressed JSON ``{"packs": {pack: [{id, type,
  offset, length, raw_length}]}}``; packs live at ``data/<pack[:2]>/<pack>``;
- ``snapshots/*``: sealed JSON with ``tree`` and ``time``; a tree blob is
  JSON ``{"entries": [...]}``.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import zlib

VERIFIER = b"volsync-tpu repository key verifier v1"
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


class FormatError(ValueError):
    pass


def _shake_xor(key: bytes, nonce: bytes, data: bytes) -> bytes:
    if not data:
        return b""
    ks = hashlib.shake_256(key + nonce).digest(len(data))
    return (int.from_bytes(data, "little")
            ^ int.from_bytes(ks, "little")).to_bytes(len(data), "little")


def _aes_ctr(key: bytes, nonce: bytes, data: bytes) -> bytes:
    from cryptography.hazmat.primitives.ciphers import (Cipher, algorithms,
                                                        modes)

    dec = Cipher(algorithms.AES(key), modes.CTR(nonce)).decryptor()
    return dec.update(data) + dec.finalize()


class Keys:
    def __init__(self, password: str, salt: bytes, verifier: bytes):
        km = hashlib.scrypt(password.encode(), salt=salt, n=2 ** 15, r=8,
                            p=1, maxmem=256 * 1024 * 1024, dklen=64)
        self.enc, self.mac = km[:32], km[32:]
        self.cipher = None
        for cipher in (_aes_ctr, _shake_xor):
            try:
                if self._open_with(cipher, verifier) == VERIFIER:
                    self.cipher = cipher
                    break
            except ImportError:
                continue
        if self.cipher is None:
            raise FormatError("the password does not open the verifier")

    def _open_with(self, cipher, sealed: bytes) -> bytes:
        if len(sealed) < 48:
            raise FormatError("sealed object too short")
        nonce, ct, mac = sealed[:16], sealed[16:-32], sealed[-32:]
        want = hmac.new(self.mac, nonce + ct, hashlib.sha256).digest()
        if not hmac.compare_digest(want, mac):
            raise FormatError("MAC mismatch")
        return cipher(self.enc, nonce, ct)

    def open(self, sealed: bytes) -> bytes:
        return self._open_with(self.cipher, sealed)


def decompress(data: bytes) -> bytes:
    if data[:4] == ZSTD_MAGIC:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(data)
    return zlib.decompress(data)


class RepoReader:
    """Reads one bucket of a ``Remote`` (get/list) as a repository."""

    def __init__(self, remote, bucket: str, password: str):
        self.remote, self.bucket = remote, bucket
        self.config = json.loads(remote.get(bucket, "config"))
        if not self.config.get("salt") or not self.config.get("verifier"):
            raise FormatError("repository is not encrypted")
        self.keys = Keys(password, bytes.fromhex(self.config["salt"]),
                         bytes.fromhex(self.config["verifier"]))
        self.index: dict[str, list[tuple]] = {}
        #: index object key -> the (pack, type, offset, length, raw_length)
        #: entries it added
        self.deltas: dict[str, list[tuple]] = {}
        for key in remote.list(bucket, "index/"):
            payload = json.loads(decompress(self.keys.open(
                remote.get(bucket, key))))
            rows = self.deltas.setdefault(key, [])
            for pack, entries in payload["packs"].items():
                for e in entries:
                    row = (pack, e["type"], e["offset"], e["length"],
                           e["raw_length"])
                    rows.append(row)
                    self.index.setdefault(e["id"], []).append(row)

    def snapshots(self) -> list[dict]:
        """Every snapshot manifest, oldest first."""
        out = []
        for key in self.remote.list(self.bucket, "snapshots/"):
            out.append(json.loads(self.keys.open(self.remote.get(self.bucket,
                                                                 key))))
        out.sort(key=lambda m: m["time"])
        return out

    def blob(self, blob_id: str) -> bytes:
        homes = self.index.get(blob_id)
        if not homes:
            raise FormatError(f"blob {blob_id} is not in the index")
        pack, _, offset, length, raw_length = homes[0]
        plain = self.keys.open(self.remote.get(
            self.bucket, f"data/{pack[:2]}/{pack}", offset, length))
        if plain[:1] == b"\x01":
            data = decompress(plain[1:])
        elif plain[:1] == b"\x00":
            data = plain[1:]
        else:
            raise FormatError(f"blob {blob_id}: unknown flag byte")
        if len(data) != raw_length:
            raise FormatError(f"blob {blob_id}: {len(data)} bytes, the index "
                              f"says {raw_length}")
        return data

    def tree_files(self, tree_id: str) -> dict[str, dict]:
        """{relative path: entry} of a snapshot's tree, directories too."""
        out, stack = {}, [(tree_id, "")]
        while stack:
            tid, prefix = stack.pop()
            for e in json.loads(self.blob(tid))["entries"]:
                path = prefix + e["name"]
                out[path] = e
                if e.get("type") == "dir":
                    stack.append((e["subtree"], path + "/"))
        return out
