"""The port's measurement scripts on the CPU: ``time_leaf_calls`` builds
the lanes of ``sha256_chunks_device``'s callers and checks digests
against hashlib (its timing needs the card)."""

import numpy as np
import pytest
import torch

from volsync_tpu_torch.ops import sha256 as sha
from volsync_tpu_torch.tools import time_leaf_calls as tlc


def test_leaf_call_lanes_have_the_callers_shapes():
    shapes = tlc.lanes(np.random.RandomState(0), tlc.BUFFER)
    assert {k: v[0].shape[0] for k, v in shapes.items()} == {
        "fused_tail": 1, "split": 64, "spans": 256, "legacy": 16384}
    for starts, lengths in shapes.values():
        assert starts.dtype == lengths.dtype == np.int32
        assert (lengths <= tlc.LEAF).all() and (lengths >= 0).all()
        assert (starts + lengths <= tlc.BUFFER).all()
    assert shapes["fused_tail"][1][0] == 4095
    assert (shapes["split"][0] % 64 == 0).all()
    assert (shapes["split"][1] % 64 == 0).all() and (shapes["split"][1] > 0).all()
    assert (shapes["spans"][0] % tlc.LEAF == 0).all()
    assert (shapes["spans"][1] > 0).all() and (shapes["spans"][1] % 64).any()
    starts, lengths = shapes["legacy"]
    live = lengths > 0
    assert 9000 < live.sum() < 16384 and not live[live.sum():].any()
    assert (starts[live] + lengths[live]).max() <= tlc.READ
    # each chunk's leaves follow one another; most are whole
    assert (lengths[live] == tlc.LEAF).mean() > 0.95


@pytest.mark.parametrize("shape", ["fused_tail", "split", "spans"])
def test_leaf_call_check_holds_digests_to_hashlib(shape):
    rng = np.random.RandomState(1)
    L = 1 << 20  # all but the legacy lanes fit any buffer
    host = np.frombuffer(rng.bytes(L), np.uint8).copy()
    starts, lengths = tlc.lanes(rng, L)[shape]
    got = sha.sha256_chunks_device(
        torch.from_numpy(host), torch.from_numpy(starts),
        torch.from_numpy(lengths), max_len=tlc.LEAF).numpy()
    tlc.check(host, starts, lengths, got)
    got[0, 0] ^= 1
    with pytest.raises(AssertionError):
        tlc.check(host, starts, lengths, got)


def test_leaf_call_script_needs_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["time_leaf_calls.py"])
    assert tlc.main() == 2
    assert capsys.readouterr().out == ""
