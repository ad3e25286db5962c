"""The SHA-256 kernel family: which device kernels do its work, and the
work that the algorithm needs for the chunks they hash.

Work is counted from the chunk lengths, by the repository's blob-id
format (``reference/merkle.py``), whatever kernel does it:

- a full 4 KiB leaf is 64 message blocks and one padding block;
- a tail leaf of t bytes (0 < t < 4096, or the empty blob's one leaf) is
  ``ceil((t + 9) / 64)`` blocks;
- the root of a chunk with L leaves hashes 5 + 8 + 32 L bytes:
  ``ceil((13 + 32 L + 9) / 64)`` blocks.

Operations per block, from FIPS 180-4 section 6.2.2, counted as the
instructions the INT32 pipe has to issue when three-input logic (LOP3)
and funnel shifts (rotations) are available:

- message schedule, t = 16..63 (48 steps): sigma0 and sigma1 are three
  shifts or rotations and one three-way XOR each: 8 a step, 384;
- 64 rounds: Sigma1 and Sigma0 are three rotations and one three-way
  XOR each (8), Ch and Maj one LOP3 each (2): 10 a round, 640;
- the additions (3 a schedule step, 7 a round, 8 at the end) are left
  out: the H100 can issue them on its FMA pipe (IMAD), beside the INT32
  pipe, so they set no floor.

That is 1,024 a block with a data-dependent schedule. The padding block
of a full 4 KiB leaf is the same for every leaf, so its schedule is a
constant: 640. The count is a floor, so a share of it cannot pass 100%.

Bytes: every chunk byte read once, one 32-byte id written per chunk.
"""

from __future__ import annotations

#: substrings of the device kernels' names that belong to this family
KERNELS = ("sha256_pages", "sha256_rows", "sha256_slices", "sha256_lanes",
           "merkle_roots")

LEAF = 4096
OPS_BLOCK = 8 * 48 + 10 * 64          # 1,024
OPS_CONST_SCHEDULE_BLOCK = 10 * 64    # 640
DIGEST = 32


def _blocks(nbytes: int) -> int:
    return (nbytes + 9 + 63) // 64


def chunk_work(length: int) -> tuple[int, int]:
    """(operations, bytes) that one chunk of ``length`` bytes needs."""
    full, tail = divmod(length, LEAF)
    ops = full * (64 * OPS_BLOCK + OPS_CONST_SCHEDULE_BLOCK)
    if tail or length == 0:
        ops += _blocks(tail) * OPS_BLOCK
    nleaves = full + (1 if tail or length == 0 else 0)
    ops += _blocks(5 + 8 + 32 * nleaves) * OPS_BLOCK
    return ops, length + DIGEST


def work(lengths) -> tuple[int, int]:
    ops = nbytes = 0
    for n in lengths:
        o, b = chunk_work(int(n))
        ops += o
        nbytes += b
    return ops, nbytes
