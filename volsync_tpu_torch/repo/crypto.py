"""Repository encryption: AES-256-CTR + HMAC-SHA256, scrypt KDF.

Ports ``volsync_tpu/repo/crypto.py`` unchanged: both packages seal and
open each other's objects with the same keys. Where the
``cryptography`` wheel is not installed the cipher is the SHAKE-256 keystream below, which is not wire-compatible
with AES-CTR: a repository sealed there opens only where the cipher
matches (``HAVE_AES`` says which one this process uses).

The reference's restic engine encrypts every blob/pack/index with
AES-256-CTR and authenticates with Poly1305-AES (SURVEY.md §2.2 #25).
This clean-room equivalent keeps the same *security envelope* —
per-object random nonce, encrypt-then-MAC, password-derived master key —
using the primitives available in this image's ``cryptography`` wheel
(HMAC-SHA256 instead of Poly1305; scrypt for key derivation, as restic).
When that wheel is absent the cipher falls back to a SHAKE-256
keystream (see ``_xor_stream``); the MAC and KDF are stdlib either way.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import os
from typing import Optional

from volsync_tpu_torch.obs import span

try:
    from cryptography.hazmat.primitives.ciphers import (Cipher, algorithms,
                                                        modes)
except ImportError:  # optional binary wheel
    Cipher = None

HAVE_AES = Cipher is not None

_NONCE = 16  # AES block / CTR nonce size
_MAC = 32    # HMAC-SHA256


def _xor_stream(key: bytes, nonce: bytes, data: bytes) -> bytes:
    """Stdlib stream cipher for builds without the ``cryptography`` wheel.

    XOR against a SHAKE-256(key ‖ nonce) keystream — same envelope
    (random nonce, encrypt-then-MAC) but NOT wire-compatible with the
    AES-CTR build: an object sealed by one cipher opens to garbage on
    the other, which the downstream decompression/JSON layer rejects.
    The MAC (shared scheme) still authenticates either way.
    """
    if not data:
        return b""
    ks = hashlib.shake_256(key + nonce).digest(len(data))
    n = len(data)
    return (int.from_bytes(data, "little")
            ^ int.from_bytes(ks, "little")).to_bytes(n, "little")


class IntegrityError(ValueError):
    pass


class WrongPassword(ValueError):
    pass


class SecretBox:
    """seal/open with key separation: one AES key, one MAC key."""

    def __init__(self, enc_key: bytes, mac_key: bytes):
        assert len(enc_key) == 32 and len(mac_key) == 32
        self.enc_key = enc_key
        self.mac_key = mac_key

    def seal(self, plaintext: bytes) -> bytes:
        nonce = os.urandom(_NONCE)
        if Cipher is not None:
            enc = Cipher(algorithms.AES(self.enc_key),
                         modes.CTR(nonce)).encryptor()
            ct = enc.update(plaintext) + enc.finalize()
        else:
            ct = _xor_stream(self.enc_key, nonce, plaintext)
        mac = hmac_mod.new(self.mac_key, nonce + ct, hashlib.sha256).digest()
        return nonce + ct + mac

    def seal_parts(self, parts) -> list:
        """``seal`` over the logical concatenation of ``parts`` (bytes
        or memoryviews) WITHOUT joining them first: CTR and the MAC both
        stream, so the zero-copy seal path feeds the payload views
        straight through. Returns the sealed object as an iovec whose
        join is byte-identical to ``seal(b"".join(parts))``."""
        nonce = os.urandom(_NONCE)
        if Cipher is not None:
            enc = Cipher(algorithms.AES(self.enc_key),
                         modes.CTR(nonce)).encryptor()
            cts = [enc.update(p) for p in parts]
            cts.append(enc.finalize())
        else:
            # The SHAKE keystream XOR needs one contiguous integer —
            # stdlib-only builds pay the join the AES path avoids.
            cts = [_xor_stream(self.enc_key, nonce, b"".join(parts))]  # lint: ignore[VL106] stdlib-only fallback
        h = hmac_mod.new(self.mac_key, nonce, hashlib.sha256)
        out = [nonce]
        for ct in cts:
            if ct:
                h.update(ct)
                out.append(ct)
        out.append(h.digest())
        return out

    def open(self, sealed) -> bytes:
        """Accepts any buffer (bytes or a pack-slice memoryview) — the
        MAC and cipher both stream over views without a joining copy."""
        if len(sealed) < _NONCE + _MAC:
            raise IntegrityError("sealed object too short")
        nonce, ct, mac = (sealed[:_NONCE], sealed[_NONCE:-_MAC],
                          sealed[-_MAC:])
        h = hmac_mod.new(self.mac_key, nonce, hashlib.sha256)
        h.update(ct)
        if not hmac_mod.compare_digest(mac, h.digest()):
            raise IntegrityError("MAC mismatch (corrupt or tampered object)")
        if Cipher is not None:
            dec = Cipher(algorithms.AES(self.enc_key),
                         modes.CTR(nonce)).decryptor()
            return dec.update(ct) + dec.finalize()
        return _xor_stream(self.enc_key, nonce, ct)

    @property
    def overhead(self) -> int:
        return _NONCE + _MAC


class PlainBox:
    """No-op box for unencrypted repositories."""

    def seal(self, plaintext: bytes) -> bytes:
        return plaintext

    def seal_parts(self, parts) -> list:
        """Pass-through iovec: the payload views flow to the store
        uncopied (the zero-copy seal path for unencrypted repos)."""
        return list(parts)

    def open(self, sealed):
        return sealed

    overhead = 0


def derive_keys(password: str, salt: bytes, *, n: int = 2**15, r: int = 8,
                p: int = 1) -> SecretBox:
    """scrypt(password) -> 64 bytes -> (enc_key, mac_key)."""
    with span("repo.kdf"):
        km = hashlib.scrypt(password.encode(), salt=salt, n=n, r=r, p=p,
                            maxmem=256 * 1024 * 1024, dklen=64)
    return SecretBox(km[:32], km[32:])


def make_box(password: Optional[str], salt: bytes):
    return derive_keys(password, salt) if password else PlainBox()
