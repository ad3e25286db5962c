"""The port's SHA-256 (volsync_tpu_torch/ops/sha256.py and the page
stage of ops/segment.py) against hashlib and the JAX package, on the
CPU: the kernels' plain twins must be bit-exact with the reference."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volsync_tpu.ops import segment as jseg
from volsync_tpu.ops import sha256 as jsha
from volsync_tpu_torch.ops import segment as tseg
from volsync_tpu_torch.ops import sha256 as tsha

# Parallel test workers share the cores: keep the CPU twins single-threaded.
torch.set_num_threads(1)

LENGTHS = [0, 55, 56, 63, 64, 4096]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_sha256_many_matches_hashlib_and_reference(rng):
    msgs = [rng.bytes(n) for n in LENGTHS] + [rng.bytes(int(rng.randint(
        1, 3000)))]
    got = tsha.sha256_many(msgs, device="cpu")
    assert got == [hashlib.sha256(m).digest() for m in msgs]
    blocks, nblocks = tsha.sha256_pack_host(msgs, pad_batch_to=8,
                                            pad_blocks_to=1)
    jblocks, jnblocks = jsha.sha256_pack_host(msgs, pad_batch_to=8,
                                              pad_blocks_to=1)
    np.testing.assert_array_equal(blocks, jblocks)
    np.testing.assert_array_equal(nblocks, jnblocks)
    ref = np.asarray(jsha.sha256_blocks(jnp.asarray(jblocks),
                                        jnp.asarray(jnblocks)))
    port = tsha.sha256_blocks(torch.from_numpy(blocks.view(np.int32)),
                              torch.from_numpy(nblocks))
    np.testing.assert_array_equal(_u32(port), ref)


def test_sha256_many_empty_list():
    assert tsha.sha256_many([], device="cpu") == []


@pytest.mark.parametrize("little_endian", [False, True])
def test_pack_words_rows_matches_reference(rng, little_endian):
    rows = rng.randint(0, 256, size=(3, 64), dtype=np.uint8)
    ref = np.asarray(jsha.pack_words_rows(jnp.asarray(rows),
                                          little_endian=little_endian))
    got = tsha.pack_words_rows(torch.from_numpy(rows),
                               little_endian=little_endian)
    np.testing.assert_array_equal(_u32(got), ref)


def test_page_digests_match_reference(rng):
    """K1's twin behind K3's twin (the CPU page stage) == the JAX
    _page_digests_flat, word-major; and == hashlib per page."""
    F = 12
    data = rng.randint(0, 256, size=(F * 4096,), dtype=np.uint8)
    ref = np.asarray(jseg._page_digests_flat(jnp.asarray(data), F,
                                             pagemajor=False))
    got = _u32(tseg._page_digests_flat(torch.from_numpy(data), F))
    np.testing.assert_array_equal(got, ref)
    for p in range(F):
        assert got.reshape(8, F)[:, p].astype(">u4").tobytes() == \
            hashlib.sha256(data[p * 4096:(p + 1) * 4096]).digest()


def test_page_digests_pad_pages_hash_zeros(rng):
    """With n_pages_pad > F (the CUDA padding) real pages keep their
    digests and pad pages hash zero pages."""
    data = rng.randint(0, 256, size=(3 * 4096,), dtype=np.uint8)
    got = _u32(tseg._page_digests_flat(torch.from_numpy(data), 5))
    tab = got.reshape(8, 5)
    assert tab[:, 1].astype(">u4").tobytes() == \
        hashlib.sha256(data[4096:8192]).digest()
    assert tab[:, 4].astype(">u4").tobytes() == \
        hashlib.sha256(bytes(4096)).digest()


def test_sha256_rows_matches_reference(rng):
    data = rng.randint(0, 256, size=(6 * 4096,), dtype=np.uint8)
    rows0 = np.array([0, 64, 3 * 64 + 7], np.int32)
    ref = np.asarray(jsha._sha256_rows(jsha.pack_words(jnp.asarray(data)),
                                       jnp.asarray(rows0), 4096))
    got = tsha._sha256_rows(tsha.pack_words(torch.from_numpy(data)),
                            torch.from_numpy(rows0), 4096)
    np.testing.assert_array_equal(_u32(got), ref)


def test_sha256_chunks_device_matches_reference(rng):
    """Device-built FIPS padding (the tail-leaf path) at the padding
    edge lengths, bit-exact vs the JAX function and hashlib."""
    data = rng.randint(0, 256, size=(20_000,), dtype=np.uint8)
    starts = np.array([0, 100, 4096, 7, 12_000, 19_990, 5], np.int32)
    lengths = np.array([0, 55, 56, 63, 64, 10, 4096], np.int32)
    ref = np.asarray(jsha.sha256_chunks_device(
        jnp.asarray(data), jnp.asarray(starts), jnp.asarray(lengths),
        max_len=4096))
    got = tsha.sha256_chunks_device(
        torch.from_numpy(data), torch.from_numpy(starts),
        torch.from_numpy(lengths), max_len=4096)
    np.testing.assert_array_equal(_u32(got), ref)
    for i, (s, n) in enumerate(zip(starts, lengths)):
        assert _u32(got)[i].astype(">u4").tobytes() == \
            hashlib.sha256(data[s:s + n]).digest()


def test_sha256_lanes_twin_respects_nblocks(rng):
    """Lanes stop at their own block count; nblocks 0 leaves H0."""
    blocks = rng.randint(-2**31, 2**31 - 1, size=(3, 4, 16)).astype(np.int32)
    nblocks = np.array([0, 1, 4], np.int32)
    ref = np.asarray(jsha.sha256_blocks(jnp.asarray(blocks.view(np.uint32)),
                                        jnp.asarray(nblocks)))
    got = tsha.sha256_blocks(torch.from_numpy(blocks),
                             torch.from_numpy(nblocks))
    np.testing.assert_array_equal(_u32(got), ref)
    np.testing.assert_array_equal(_u32(got)[0], tsha._H0)


def test_word_conversions_round_trip():
    vals = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                        dtype=torch.int64)
    assert torch.equal(tsha._u32(tsha._i32(vals)), vals)


def test_sha256_leaves_device_matches_reference(rng):
    """[F + T, 8] leaf digests: full leaves at 64-byte rows (K2's twin)
    then short tails (the gather path), padding lanes included."""
    data = rng.randint(0, 256, size=(48 * 1024,), dtype=np.uint8)
    rows0 = np.array([0, 1, 64, 500, 0, 0, 0, 0], np.int32)  # 4 padding
    ts = np.array([100, 40_000, 0, 0], np.int32)
    tl = np.array([4095, 1, 0, 0], np.int32)
    ref = np.asarray(jsha.sha256_leaves_device(
        jnp.asarray(data), jnp.asarray(rows0), jnp.asarray(ts),
        jnp.asarray(tl)))
    got = tsha.sha256_leaves_device(
        torch.from_numpy(data), torch.from_numpy(rows0),
        torch.from_numpy(ts), torch.from_numpy(tl))
    np.testing.assert_array_equal(_u32(got), ref)
    for i, r in enumerate(rows0):
        assert _u32(got)[i].astype(">u4").tobytes() == \
            hashlib.sha256(data[64 * r: 64 * r + 4096]).digest()
    assert _u32(got)[8].astype(">u4").tobytes() == \
        hashlib.sha256(data[100:4195]).digest()


def test_sha256_rows_is_its_twin_on_the_cpu(rng):
    """K2's wrapper on a CPU tensor is ``_sha256_rows`` over
    ``pack_words``, for any whole-block leaf length; other lengths and
    K1's launch size are refused or ignored as on the card."""
    data = torch.from_numpy(rng.randint(0, 256, size=(8192,),
                                        dtype=np.uint8))
    rows0 = torch.tensor([0, 3, 60], dtype=torch.int32)
    for leaf_len in (64, 4096):
        assert torch.equal(
            tsha.sha256_rows(data, rows0, leaf_len=leaf_len),
            tsha._sha256_rows(tsha.pack_words(data), rows0, leaf_len))
    with pytest.raises(ValueError):
        tsha.sha256_rows(data, rows0, leaf_len=100)
    assert torch.equal(tsha.sha256_pages(data, 3, threads=256),
                       tsha._sha256_pages_plain(data, 3))
    with pytest.raises(ValueError):
        tsha.sha256_pages(data, 1)  # fewer pages than the buffer holds
    with pytest.raises(ValueError):
        tsha.sha256_pages(data[:4000], 1)  # not whole pages


@pytest.mark.parametrize("F,npp", [(3, 3), (2, 7)])
def test_sha256_pages_twin_matches_reference_on_raw_bytes(rng, F, npp):
    """K1's twin reads raw bytes: its first F pages == the JAX
    _page_digests_flat (CPU path) word for word, and pad pages hash a
    zero page (the reference's CPU path hashes them as the last real
    page, which no reader sees)."""
    data = rng.randint(0, 256, size=(F * 4096,), dtype=np.uint8)
    ref = np.asarray(jseg._page_digests_flat(jnp.asarray(data), npp,
                                             pagemajor=False))
    got = _u32(tsha.sha256_pages(torch.from_numpy(data), npp))
    np.testing.assert_array_equal(got.reshape(8, npp)[:, :F],
                                  ref.reshape(8, npp)[:, :F])
    zero = hashlib.sha256(bytes(4096)).digest()
    for p in range(F, npp):
        assert got.reshape(8, npp)[:, p].astype(">u4").tobytes() == zero


SLICE_LENGTHS = [0, 1, 55, 56, 63, 64, 119, 120, 4095, 4096]


@pytest.mark.parametrize("length", SLICE_LENGTHS)
def test_sha256_chunks_plain_matches_reference(rng, length):
    """sha256_slices' twin == the JAX sha256_chunks_device at start
    offsets 0..15 (mod 16) for one padding edge length, beside a slice
    ending on the buffer's last byte and one running past it (the
    reference repeats the last byte); == hashlib inside the buffer."""
    L = 9000
    data = rng.randint(0, 256, size=(L,), dtype=np.uint8)
    starts = np.array([off * 33 for off in range(16)] + [L - 100, L - 7],
                      np.int32)
    lengths = np.array([length] * 16 + [100, 4096], np.int32)
    ref = np.asarray(jsha.sha256_chunks_device(
        jnp.asarray(data), jnp.asarray(starts), jnp.asarray(lengths),
        max_len=4096))
    got = _u32(tsha._sha256_chunks_plain(
        torch.from_numpy(data), torch.from_numpy(starts),
        torch.from_numpy(lengths), max_len=4096))
    np.testing.assert_array_equal(got, ref)
    for i in range(17):
        s, n = starts[i], lengths[i]
        assert got[i].astype(">u4").tobytes() == \
            hashlib.sha256(data[s:s + n]).digest()
    assert torch.equal(
        tsha.sha256_chunks_device(torch.from_numpy(data),
                                  torch.from_numpy(starts),
                                  torch.from_numpy(lengths), max_len=4096),
        torch.from_numpy(got.view(np.int32)))


def test_sha256_pages_pagemajor_twin_is_the_transposed_table(rng):
    """K1's page-major form on the CPU is its word-major table
    transposed (word j of page p at p*8 + j), zero pages included."""
    data = torch.from_numpy(rng.randint(0, 256, size=(3 * 4096,),
                                        dtype=np.uint8))
    word = tsha.sha256_pages(data, 5)
    page = tsha.sha256_pages(data, 5, pagemajor=True)
    assert torch.equal(page, word.view(8, 5).t().reshape(-1))
    assert torch.equal(page, tsha._sha256_pages_plain(data, 5, True))
