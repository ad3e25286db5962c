"""The port's rsync delta engine against the JAX package's, on the CPU.

MD5 (``ops/md5.py``: the RFC 1321 vectors, random batches against
hashlib, and states equal to the reference's in the lanes, windowed and
contiguous forms, clamped windows included), the rolling weak checksums
(``ops/rolling.py``, at the window's edge lengths), the delta primitives
(``ops/delta.py``: signatures, candidate arrays and counts, truncated
first ladder steps included) and the engine (``engine/deltasync.py``:
signature wire forms, serial and batched op streams on the reference's
ten-pair corpus and mixed block lengths, ``apply_delta``). Inputs come
from numpy seeds and go through both packages; every comparison is
exact (hash states and op streams have no tolerance).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsync_tpu.engine import deltasync as jd
from volsync_tpu.ops import delta as jdelta
from volsync_tpu.ops import md5 as jmd5
from volsync_tpu.ops import rolling as jroll
from volsync_tpu_torch.engine import deltasync as td
from volsync_tpu_torch.ops import delta as tdelta
from volsync_tpu_torch.ops import md5 as tmd5
from volsync_tpu_torch.ops import rolling as troll

torch.set_num_threads(1)

CPU = "cpu"


def _t(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def _u32(states: torch.Tensor) -> np.ndarray:
    return states.numpy().view(np.uint32)


def _bytes(rng, n: int) -> np.ndarray:
    return np.frombuffer(rng.bytes(n), np.uint8).copy()


# -- MD5 ---------------------------------------------------------------------

RFC1321 = [
    (b"", "d41d8cd98f00b204e9800998ecf8427e"),
    (b"a", "0cc175b9c0f1b6a831c399e269772661"),
    (b"abc", "900150983cd24fb0d6963f7d28e17f72"),
    (b"message digest", "f96b697d7cb7938d525a2f31aaf161d0"),
    (b"abcdefghijklmnopqrstuvwxyz", "c3fcd3d76192e4007dfb496cca67e13b"),
    (b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789",
     "d174ab98d277d9f5a5611c2c9f419d9f"),
    (b"1234567890" * 8, "57edf4a22be3c955ac49da2e2107b67a"),
]


def test_md5_many_rfc1321_vectors():
    got = tmd5.md5_many([m for m, _ in RFC1321], device=CPU)
    assert [g.hex() for g in got] == [h for _, h in RFC1321]
    assert tmd5.md5_many([], device=CPU) == []


def test_md5_many_random_batch_equals_hashlib(rng):
    lengths = list(range(0, 130)) + [200, 511, 512, 1000, 4096]
    chunks = [rng.bytes(n) for n in lengths]
    assert tmd5.md5_many(chunks, device=CPU) == [
        hashlib.md5(c).digest() for c in chunks]


def test_md5_pack_and_blocks_equal_reference(rng):
    chunks = [rng.bytes(n) for n in (0, 55, 56, 64, 119, 120, 300)]
    blocks, nb = tmd5.md5_pack_host(chunks)
    jblocks, jnb = jmd5.md5_pack_host(chunks)
    assert np.array_equal(blocks, jblocks) and np.array_equal(nb, jnb)
    # block counts below 0, at 0 and past N clamp as the reference's scan
    nb = nb.copy()
    nb[:3] = [-1, 0, blocks.shape[1] + 3]
    got = tmd5.md5_blocks(_t(blocks.view(np.int32)), _t(nb))
    want = jmd5.md5_blocks(jnp.asarray(blocks), jnp.asarray(nb))
    assert np.array_equal(_u32(got), np.asarray(want))


def _md5_starts(kind: str, n: int) -> np.ndarray:
    """Window starts into a 6,000-byte buffer: ``inside`` (windows at
    every residue mod 16, one running past the end, whose last byte
    repeats, and one with a negative start, where byte 0 repeats),
    ``below`` (wholly below byte 0: start + n <= 0) and ``past`` (wholly
    past the end); within int32, as the reference casts starts."""
    if kind == "inside":
        return np.array([0, 1, 15, 17, 333, 4999, 5999, 5500, -3]
                        + [100 + 17 * r for r in range(16)], np.int64)
    if kind == "below":
        return np.array([-n - r for r in range(16)]
                        + [-n - 64, -n - 1000, -2 * n - 100, -10**6],
                        np.int64)
    return np.array([6000 + r for r in range(16)]
                    + [6064, 7000, 6000 + 2 * n, 10**6], np.int64)


MD5_BLOCK_LENS = [1024, 1000, 120, 119, 64, 63, 56, 55, 7, 0]


@pytest.mark.parametrize("block_len,kind", [
    pytest.param(n, kind, id=str(n) if kind == "inside" else f"{n}-{kind}")
    for kind in ("inside", "below", "past") for n in MD5_BLOCK_LENS])
def test_md5_fixed_blocks_equal_reference(rng, block_len, kind):
    data = _bytes(rng, 6000)
    starts = _md5_starts(kind, block_len)
    got = tmd5.md5_fixed_blocks_device(_t(data), _t(starts),
                                       block_len=block_len)
    want = jmd5.md5_fixed_blocks_device(
        jnp.asarray(data), jnp.asarray(starts.astype(np.int32)),
        block_len=block_len)
    assert np.array_equal(_u32(got), np.asarray(want))
    digests = tmd5.state_bytes(got)
    for k, s in enumerate(starts):
        if 0 <= s <= 6000 - block_len:
            assert digests[k] == hashlib.md5(
                data[s:s + block_len].tobytes()).digest()


@pytest.mark.parametrize("block_len", [1024, 4096])
def test_md5_contiguous_blocks_equal_reference(rng, block_len):
    data = _bytes(rng, 5 * block_len)
    got = tmd5.md5_contiguous_blocks_device(_t(data), block_len=block_len)
    want = jmd5.md5_contiguous_blocks_device(jnp.asarray(data),
                                             block_len=block_len)
    assert np.array_equal(_u32(got), np.asarray(want))
    assert tmd5.state_bytes(got) == [
        hashlib.md5(data[i * block_len:(i + 1) * block_len].tobytes())
        .digest() for i in range(5)]
    with pytest.raises(AssertionError):
        tmd5.md5_contiguous_blocks_device(_t(data), block_len=1000)


# -- rolling weak checksums --------------------------------------------------

W = 100


@pytest.mark.parametrize("L", [0, 1, W - 1, W, W + 1, 3 * W + 17, 4096])
def test_rolling_weak_checksums_equal_reference(rng, L):
    data = _bytes(rng, L)
    got = troll.rolling_weak_checksums(_t(data), window=W)
    assert got.dtype == torch.int64
    want = np.asarray(jroll.rolling_weak_checksums(jnp.asarray(data),
                                                   window=W))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    blocks = troll.block_weak_checksums(_t(data), block_len=W)
    want = np.asarray(jroll.block_weak_checksums(jnp.asarray(data),
                                                 block_len=W))
    assert np.array_equal(blocks.numpy(), want.astype(np.int64))
    assert [int(v) for v in blocks] == [
        jroll.weak_checksum_host(data[i:i + W].tobytes())
        for i in range(0, L, W)]


def test_rolling_weak_checksums_of_high_bytes_equal_host():
    """All-0xFF rows: the largest sums the position-weighted prefix can
    take at this length."""
    data = np.full((5000,), 0xFF, np.uint8)
    got = troll.rolling_weak_checksums(_t(data), window=999)
    assert int(got[0]) == int(got[-1]) == troll.weak_checksum_host(
        bytes(data[:999])) == jroll.weak_checksum_host(bytes(data[:999]))


# -- delta primitives --------------------------------------------------------


@pytest.mark.parametrize("block_len", [1024, 1000])
def test_build_signature_equals_reference(rng, block_len):
    data = _bytes(rng, 7 * block_len + 333)
    weak, strong = tdelta.build_signature(_t(data), block_len=block_len)
    jweak, jstrong = jdelta.build_signature(jnp.asarray(data),
                                            block_len=block_len)
    assert np.array_equal(weak.numpy(), np.asarray(jweak).astype(np.int64))
    assert np.array_equal(_u32(strong), np.asarray(jstrong))


def _src_and_sig(rng, block_len=512, n_blocks=12):
    dst = _bytes(rng, block_len * n_blocks)
    src = np.concatenate([dst[:2000], _bytes(rng, 37), dst[2000:],
                          dst[:block_len]])
    weak = np.asarray(jroll.block_weak_checksums(jnp.asarray(dst),
                                                 block_len=block_len))
    return src, np.sort(weak)


@pytest.mark.parametrize("cap", [1024, 4])
def test_match_offsets_equal_reference(rng, cap):
    """Candidate arrays and true counts, including a truncated first
    ladder step (cap 4 < the count)."""
    src, sw = _src_and_sig(rng)
    cand, count = tdelta.match_offsets(_t(src), _t(sw.astype(np.int64)),
                                       window=512, max_candidates=cap)
    jcand, jcount = jdelta.match_offsets(jnp.asarray(src), jnp.asarray(sw),
                                         window=512, max_candidates=cap)
    assert int(count) == int(jcount) > 4
    assert np.array_equal(cand.numpy(), np.asarray(jcand).astype(np.int64))
    states = tdelta.verify_candidates(_t(src), cand.numpy()[:min(cap, 13)],
                                      block_len=512)
    want = jdelta.verify_candidates(jnp.asarray(src),
                                    np.asarray(jcand)[:min(cap, 13)],
                                    block_len=512)
    assert np.array_equal(states, want)


@pytest.mark.parametrize("cap", [1024, 8])
def test_match_offsets_batch_equals_reference(rng, cap):
    """The batch form over three padded rows with the 0xFFFFFFFF sentinel
    past each row's true count, a short row and a truncated step."""
    rows, sigs = [], []
    for n_blocks in (12, 5, 9):
        src, sw = _src_and_sig(rng, n_blocks=n_blocks)
        rows.append(src)
        sigs.append(sw)
    L = 8192
    data = np.zeros((3, L), np.uint8)
    for r, s in enumerate(rows):
        data[r, :len(s)] = s
    nb = np.array([len(s) for s in sigs], np.int32)
    sorted_weak = np.full((3, 16), 0xFFFFFFFF, np.uint32)
    for r, s in enumerate(sigs):
        sorted_weak[r, :len(s)] = s
    nscan = np.array([len(s) - 512 + 1 for s in rows], np.int32)
    cand, count = tdelta.match_offsets_batch(
        _t(data), _t(sorted_weak.astype(np.int64)), _t(nb), _t(nscan),
        window=512, max_candidates=cap)
    jcand, jcount = jdelta.match_offsets_batch(
        jnp.asarray(data), jnp.asarray(sorted_weak), jnp.asarray(nb),
        jnp.asarray(nscan), window=512, max_candidates=cap)
    assert int(count) == int(jcount) > 8
    assert np.array_equal(cand.numpy(), np.asarray(jcand).astype(np.int64))
    flat = cand.numpy()[:min(cap, int(count))]
    width = L - 512 + 1
    got = tdelta.verify_candidates_batch(_t(data), flat // width,
                                         flat % width, block_len=512)
    want = jdelta.verify_candidates_batch(jnp.asarray(data), flat // width,
                                          flat % width, block_len=512)
    assert np.array_equal(got, want)


# -- the engine --------------------------------------------------------------


def _corpus(rng):
    """tests/test_delta_batch.py's ten (old, new) pairs."""
    base = rng.bytes(200_000)
    shifted = base[:50_000] + b"INSERT" + base[50_000:]
    edited = bytearray(base)
    edited[10_000:10_100] = rng.bytes(100)
    edited[150_000:150_001] = b""
    taily = rng.bytes(4096 * 3 + 789)
    return [
        (base, base),
        (base, shifted),
        (base, bytes(edited)),
        (taily, taily[:4096 * 2] + rng.bytes(4096 + 789)),
        (b"", rng.bytes(10_000)),
        (rng.bytes(10_000), b""),
        (rng.bytes(512), rng.bytes(300)),
        (rng.bytes(300), rng.bytes(512)),
        (rng.bytes(64_000), rng.bytes(64_000)),
        (base, base[100_000:] + base[:100_000]),
    ]


def _items(pairs, block_lens=None):
    """(new, signature of old) pairs for both packages."""
    titems, jitems = [], []
    for k, (old, new) in enumerate(pairs):
        bl = (block_lens[k] if block_lens
              else td.pick_block_len(max(len(old), len(new))))
        titems.append((new, td.build_file_signature(old, bl, device=CPU)))
        jitems.append((new, jd.build_file_signature(old, bl)))
    return titems, jitems


def test_signatures_and_op_streams_equal_reference(rng):
    pairs = _corpus(rng)
    titems, jitems = _items(pairs)
    for (_, ts), (_, js) in zip(titems, jitems):
        assert ts.to_wire() == js.to_wire()
        back = td.FileSignature.from_wire(ts.to_wire())
        assert back.to_wire() == ts.to_wire()
    batch = td.delta_scan_batch(titems, device=CPU)
    assert batch == jd.delta_scan_batch(jitems)
    for (old, new), (src, sig), (jsrc, jsig), ops in zip(pairs, titems,
                                                         jitems, batch):
        serial = td.compute_delta(src, sig, device=CPU)
        assert serial == ops == jd.compute_delta(jsrc, jsig)
        assert td.apply_delta(ops, old, sig.block_len) == new
    # the identical pair ships no literal byte, the rotation some
    assert td.delta_stats(batch[0], 4096)["literal_bytes"] == 0
    assert all(op[0] == "copy" for op in batch[0])


def test_mixed_block_lengths_equal_reference(rng):
    """Caller-chosen block lengths give several device groups in one
    batch; 1000 takes build_signature's windowed form."""
    pairs = []
    for i in range(6):
        old = rng.bytes(40_000 + i * 1000)
        new = bytearray(old)
        new[5_000:5_050] = rng.bytes(50)
        pairs.append((old, bytes(new)))
    titems, jitems = _items(pairs, [1024, 4096, 1000, 8192, 4096, 1024])
    batch = td.delta_scan_batch(titems, device=CPU)
    assert batch == jd.delta_scan_batch(jitems)
    for (old, new), (src, sig), ops in zip(pairs, titems, batch):
        assert ops == td.compute_delta(src, sig, device=CPU)
        assert td.apply_delta(ops, old, sig.block_len) == new


def test_batch_uses_fewer_dispatches_than_files(rng, monkeypatch):
    """One match ladder and one verify launch a block-length group, not
    one a file; and the serial kernels are not used by the batch."""
    calls = {"match": 0, "verify": 0}
    real_match = td.match_offsets_batch
    real_verify = td.verify_candidates_batch

    def spy_match(*a, **kw):
        calls["match"] += 1
        return real_match(*a, **kw)

    def spy_verify(*a, **kw):
        calls["verify"] += 1
        return real_verify(*a, **kw)

    def boom(*a, **kw):  # pragma: no cover - failure path
        raise AssertionError("serial kernel used by the batch path")

    monkeypatch.setattr(td, "match_offsets_batch", spy_match)
    monkeypatch.setattr(td, "verify_candidates_batch", spy_verify)
    monkeypatch.setattr(td, "match_offsets", boom)
    base = rng.bytes(60_000)
    pairs = []
    for i in range(8):
        mutated = bytearray(base)
        mutated[i * 1000:i * 1000 + 50] = rng.bytes(50)
        pairs.append((base, bytes(mutated)))
    titems, _ = _items(pairs)
    batch = td.delta_scan_batch(titems, device=CPU)
    assert calls == {"match": 1, "verify": 1}
    monkeypatch.setattr(td, "match_offsets", tdelta.match_offsets)
    for (old, new), (src, sig), ops in zip(pairs, titems, batch):
        assert ops == td.compute_delta(src, sig, device=CPU)
        assert td.apply_delta(ops, old, sig.block_len) == new


def test_geometry_and_block_lengths_equal_reference():
    for size in (0, 1, 4095, 4096, 1 << 20, (1 << 29) + 12_345, 1 << 40):
        assert td.pick_block_len(size) == jd.pick_block_len(size)
        assert (td.signature_geometry(size) ==
                td.SigGeometry(**vars(jd.signature_geometry(size))))
    assert td.signature_geometry(8192, 1024).n_blocks == 8
