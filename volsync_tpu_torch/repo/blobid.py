"""Blob content addressing: Merkle-style SHA-256 over 4 KiB leaves.

A copy of ``volsync_tpu/repo/blobid.py`` (the repository format both
packages read and write):

    id(blob) = SHA-256("VMRK1" || le64(len) || leaf_0 || ... || leaf_k)
    leaf_i   = SHA-256(blob[4096*i : 4096*(i+1)])

The device paths (ops/segment.py) compute the same ids; these host
functions are the reference they are tested against.
"""

from __future__ import annotations

import hashlib

LEAF_SIZE = 4096
_DOMAIN = b"VMRK1"


def blob_id(data: bytes) -> str:
    """Host reference implementation (small blobs, verification)."""
    root = hashlib.sha256()
    root.update(_DOMAIN)
    root.update(len(data).to_bytes(8, "little"))
    for off in range(0, max(len(data), 1), LEAF_SIZE):
        root.update(hashlib.sha256(data[off: off + LEAF_SIZE]).digest())
    return root.hexdigest()


def root_from_leaves(length: int, leaf_digests: list[bytes]) -> str:
    """Combine leaf digests into the blob id."""
    root = hashlib.sha256()
    root.update(_DOMAIN)
    root.update(length.to_bytes(8, "little"))
    for d in leaf_digests:
        root.update(d)
    return root.hexdigest()


def leaf_count(length: int) -> int:
    return max((length + LEAF_SIZE - 1) // LEAF_SIZE, 1)
