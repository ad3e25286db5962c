"""Device primitives of the rsync-style delta scan, as torch ops around
the ``md5_slices`` kernel.

Ports ``volsync_tpu/ops/delta.py``. The destination sends per-block
(weak, strong) checksums; the source computes the weak checksum at every
offset (``ops/rolling.py``, prefix sums), tests each against the sorted
signature with a binary search (``torch.searchsorted``, one sorted row a
file in the batch form), compacts the hits into a fixed-size candidate
array (``ops/gearcdc.nonzero_fixed``, the reference's
``jnp.nonzero(size=, fill_value=)``), and verifies the candidates' MD5
in one batched launch (``ops/md5.md5_fixed_blocks_device``). The greedy
op selection over the sparse verified matches runs on the host in
``engine/deltasync.py``.

Weak checksums are int64 values in [0, 2**32), so the batch form's
0xFFFFFFFF padding sorts after every real checksum, as it does among the
reference's uint32. Candidates are int64 (offsets, and flat indices into
[n, L - window + 1] in the batch form), where the reference's are int32
and wrap once a batch passes 2 GiB; below that both agree.
"""

from __future__ import annotations

import numpy as np
import torch

from volsync_tpu_torch.ops.gearcdc import nonzero_fixed
from volsync_tpu_torch.ops.md5 import (
    md5_contiguous_blocks_device,
    md5_fixed_blocks_device,
)
from volsync_tpu_torch.ops.rolling import (
    block_weak_checksums,
    prefix_sums,
    rolling_weak_checksums,
    weak_from_sums,
)


def build_signature(data: torch.Tensor, *, block_len: int):
    """Destination side: per-block (weak [nb] int64, strong [n_full, 4]
    int32 MD5 states) of ``data`` ([L] uint8).

    The weak checksums include the short tail block at its true length;
    its strong checksum is computed on the host by the engine. Block
    lengths that are a multiple of 1024 (every ``pick_block_len`` size)
    take the contiguous form, others the windowed one, as in the
    reference."""
    weak = block_weak_checksums(data, block_len=block_len)
    n_full = data.shape[0] // block_len
    if block_len % 1024 == 0:
        strong = md5_contiguous_blocks_device(data[: n_full * block_len],
                                              block_len=block_len)
    else:
        starts = torch.arange(n_full, dtype=torch.int64,
                              device=data.device) * block_len
        strong = md5_fixed_blocks_device(data, starts, block_len=block_len)
    return weak, strong


def match_offsets(data: torch.Tensor, sorted_weak: torch.Tensor, *,
                  window: int, max_candidates: int):
    """Source side: offsets whose rolling weak checksum hits the
    signature.

    data:        [L] uint8 source buffer.
    sorted_weak: [nb] int64, destination block weak checksums, sorted.
    Returns (cand [max_candidates] int64 ascending with L as fill,
    true_count as a 0-d int64 tensor); the host re-runs with a larger
    bound on truncation. No host sync."""
    L = data.shape[0]
    if sorted_weak.shape[0] == 0 or L < window:
        return (torch.full((max_candidates,), L, dtype=torch.int64,
                           device=data.device),
                torch.zeros((), dtype=torch.int64, device=data.device))
    weak = rolling_weak_checksums(data, window=window)
    pos = torch.searchsorted(sorted_weak, weak, out_int32=True)
    pos = pos.clamp_(max=sorted_weak.shape[0] - 1).to(torch.int64)
    hit = sorted_weak[pos] == weak
    del pos, weak
    return nonzero_fixed(hit, max_candidates, L), hit.sum()


def _states_host(states: torch.Tensor) -> np.ndarray:
    """[k, 4] int32 states -> the host's [k, 4] uint32 (bit pattern)."""
    return states.cpu().numpy().view(np.uint32)


def verify_candidates(data: torch.Tensor, cand: np.ndarray, *,
                      block_len: int) -> np.ndarray:
    """Batch MD5 over candidate windows -> [n, 4] uint32 states (host
    array)."""
    if len(cand) == 0:
        return np.zeros((0, 4), dtype=np.uint32)
    starts = torch.from_numpy(np.asarray(cand, dtype=np.int64)).to(
        data.device)
    return _states_host(md5_fixed_blocks_device(data, starts,
                                                block_len=block_len))


def match_offsets_batch(data: torch.Tensor, sorted_weak: torch.Tensor,
                        nb: torch.Tensor, nscan: torch.Tensor, *,
                        window: int, max_candidates: int):
    """Multi-file ``match_offsets``: one rolling scan + membership pass
    over a whole padded file batch (engine/deltasync.delta_scan_batch).

    data:        [n, L] uint8, one zero-padded file a row.
    sorted_weak: [n, nb_cap] int64 per-row sorted signature weak sets,
                 0xFFFFFFFF-padded past each row's true count.
    nb:          [n] true signature lengths (masks the padding: a real
                 weak equal to the sentinel still matches inside its
                 row's first ``nb`` entries, exactly like the serial
                 clip-then-compare).
    nscan:       [n] valid scan offsets a row (len - window + 1);
                 offsets whose window would read padding are masked out,
                 which makes each row's candidates the serial scan's.

    Returns (cand [max_candidates] int64 ascending row-major flat indices
    into [n, L-window+1] with n*(L-window+1) as fill, true_count as a
    0-d int64 tensor); the host re-runs with a doubled bound on
    truncation, the serial path's ladder."""
    n, L = data.shape
    width = L - window + 1
    dev = data.device
    S, T = prefix_sums(data)
    dS = S[:, window:] - S[:, :width]
    del S
    dT = T[:, window:] - T[:, :width]
    del T
    ends = torch.arange(window, L + 1, dtype=torch.int64, device=dev)
    weak = weak_from_sums(dS, dT, ends[None, :])  # [n, width]
    del dS, dT
    pos = torch.searchsorted(sorted_weak, weak, out_int32=True)
    clipped = pos.clamp(max=sorted_weak.shape[1] - 1).to(torch.int64)
    hit = torch.gather(sorted_weak, 1, clipped) == weak
    del clipped, weak
    hit &= pos < nb.to(dev)[:, None]
    del pos
    hit &= torch.arange(width, device=dev)[None, :] < nscan.to(dev)[:, None]
    flat = hit.reshape(-1)
    return nonzero_fixed(flat, max_candidates, n * width), flat.sum()


def verify_candidates_batch(data: torch.Tensor, rows: np.ndarray,
                            offs: np.ndarray, *,
                            block_len: int) -> np.ndarray:
    """Batch MD5 over candidate windows across a padded [n, L] file
    batch -> [k, 4] uint32 states (host array). One launch for the whole
    batch: rows flatten to offsets into the [n*L] buffer (int64), and a
    candidate window never crosses a row boundary (offs <= row_len -
    block_len)."""
    if len(rows) == 0:
        return np.zeros((0, 4), dtype=np.uint32)
    L = data.shape[1]
    starts = (np.asarray(rows, dtype=np.int64) * L
              + np.asarray(offs, dtype=np.int64))
    return _states_host(md5_fixed_blocks_device(
        data.reshape(-1), torch.from_numpy(starts).to(data.device),
        block_len=block_len))
