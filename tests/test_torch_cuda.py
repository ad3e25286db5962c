"""The port's CUDA kernels against their plain PyTorch twins on a card.

Needs an NVIDIA card with nvcc (the kernels build from
volsync_tpu_torch/csrc at first use); skipped elsewhere. Imports no JAX,
so it runs where JAX is absent: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (``tests/conftest.py`` imports JAX).
"""

import numpy as np
import pytest
import torch

from volsync_tpu_torch.ops import segment as seg
from volsync_tpu_torch.ops import sha256 as sha
from volsync_tpu_torch.ops.gearcdc import GearParams

pytestmark = pytest.mark.cuda

PARAMS = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                    align=4096)


@pytest.fixture
def rng():
    return np.random.RandomState(1234)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _rand_i32(rng, shape, device):
    return torch.from_numpy(
        rng.randint(-2**31, 2**31 - 1, size=shape).astype(np.int32)).to(device)


@pytest.mark.parametrize("shape", [(8192, 1024), (1000, 77), (1, 33)])
def test_transpose_kernel_equals_twin(cuda, rng, shape):
    x = _rand_i32(rng, shape, cuda)
    assert torch.equal(seg.transpose_u32(x), seg._transpose_plain(x))


def test_sha256_pages_kernel_equals_twin(cuda, rng):
    xt = _rand_i32(rng, (1024, 128), cuda)
    assert torch.equal(sha.sha256_pages(xt), sha._sha256_pages_plain(xt))


def test_sha256_lanes_kernel_equals_twin(cuda, rng):
    blocks = _rand_i32(rng, (40, 9, 16), cuda)
    nblocks = torch.from_numpy(rng.randint(-1, 11, size=(40,)).astype(
        np.int32)).to(cuda)
    assert torch.equal(sha.sha256_blocks(blocks, nblocks),
                       sha._sha256_lanes_plain(blocks, nblocks))


def test_segment_on_card_equals_cpu(cuda, rng):
    """The whole fused segment (every kernel, with the card's page
    padding) packs the same words as the CPU twins."""
    data = np.zeros((512 * 1024,), np.uint8)
    data[:400_000] = np.frombuffer(rng.bytes(400_000), np.uint8)
    cc, kc = seg.segment_caps(data.shape[0], PARAMS)
    p = PARAMS
    kw = dict(min_size=p.min_size, avg_size=p.avg_size,
              max_size=p.max_size, seed=p.seed, mask_s=p.mask_s,
              mask_l=p.mask_l, align=p.align, eof=True, cand_cap=cc,
              chunk_cap=kc)
    host = torch.from_numpy(data)
    want = seg.chunk_hash_segment(host, 400_000, **kw)
    got = seg.chunk_hash_segment(host.to(cuda), 400_000, **kw)
    assert torch.equal(got.cpu(), want)


def test_batched_segments_on_card_equal_cpu(cuda, rng):
    """The batched pass (several lanes, one K1 batch, one root launch)
    packs the same rows on the card as on the CPU."""
    P = 128 * 1024
    rows = np.zeros((4, P), np.uint8)
    rows[0] = np.frombuffer(rng.bytes(P), np.uint8)
    rows[1, :90_000] = np.frombuffer(rng.bytes(90_000), np.uint8)
    valid, eof = [P, 90_000, 0, 100_000], [False, True, False, True]
    cc, kc = seg.segment_caps(P, PARAMS)
    p = PARAMS
    kw = dict(min_size=p.min_size, avg_size=p.avg_size,
              max_size=p.max_size, seed=p.seed, mask_s=p.mask_s,
              mask_l=p.mask_l, align=p.align, cand_cap=cc, chunk_cap=kc)
    host = torch.from_numpy(rows)
    want = seg.chunk_hash_segments(host, valid, eof, **kw)
    got = seg.chunk_hash_segments(host.to(cuda), valid, eof, **kw)
    assert torch.equal(got.cpu(), want)


def test_hash_file_streaming_on_card(cuda, rng, tmp_path):
    from volsync_tpu_torch.engine import hash_file_streaming
    from volsync_tpu_torch.repo import blobid

    for n in (5, 4096, 300_000 + 17):
        f = tmp_path / f"f{n}"
        data = rng.bytes(n)
        f.write_bytes(data)
        assert hash_file_streaming(f, segment_size=128 * 1024) == \
            blobid.blob_id(data)
