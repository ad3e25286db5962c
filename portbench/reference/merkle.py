"""Plain blob ids of the repository format, with hashlib:

    id(blob) = SHA-256("VMRK1" || le64(len) || leaf_0 || ... || leaf_k)
    leaf_i   = SHA-256(blob[4096*i : 4096*(i+1)])

(an empty blob has one leaf, the digest of no bytes).
"""

from __future__ import annotations

import hashlib

LEAF = 4096
DOMAIN = b"VMRK1"


def blob_id(data) -> str:
    view = memoryview(data).cast("B")
    root = hashlib.sha256(DOMAIN + len(view).to_bytes(8, "little"))
    for off in range(0, max(len(view), 1), LEAF):
        root.update(hashlib.sha256(view[off: off + LEAF]).digest())
    return root.hexdigest()


def leaves(length: int) -> int:
    return max((length + LEAF - 1) // LEAF, 1)
