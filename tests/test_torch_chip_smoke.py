"""chip_smoke.py rehearsed on the CPU: its seeded stream, host oracles
(aligned and per-position), verify check, the split-phase, legacy and
page-major stream phases and kernel-input capture run at a tiny size
with the kernels' plain twins, and the script itself refuses to report
without CUDA or without the package beside it."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from volsync_tpu_torch.ops import segment as seg
from volsync_tpu_torch.ops import sha256 as sha
from volsync_tpu_torch.ops.gearcdc import GearParams

# Parallel test workers share the cores: keep the CPU twins single-threaded.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PARAMS = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                    align=4096)


def test_seeded_stream_layout(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "BLOCK", 64 * 1024)
    s = chip_smoke.SeededStream(torch, 3, 6 * 64 * 1024 + 12345)
    assert s.plan[s.zero_block] == -1
    # every odd block repeats an earlier block; even ones are fresh
    assert all(s.plan[b] in s.plan[:b] for b in range(1, 7, 2))
    assert len(s.unique) == len({k for k in s.plan if k >= 0})
    pieces = []
    while piece := s.read(100_000):  # short reads stop at block edges
        pieces.append(piece)
    data = b"".join(pieces)
    assert len(data) == s.total and max(map(len, pieces)) <= 64 * 1024
    assert bytes(s.view(64 * 1024 - 5, 10)) == data[64 * 1024 - 5:
                                                     64 * 1024 + 5]


def test_stream_and_verify_phases_on_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "BLOCK", 256 * 1024)
    stream = chip_smoke.SeededStream(torch, 0, 3 * 256 * 1024 + 12345)
    res = chip_smoke.stream_phase(torch, stream, PARAMS)
    assert res["segments"] == 1 and res["gibs"] > 0
    assert set(res["stages"]) == set(chip_smoke.STAGES)
    chip_smoke.verify_phase(res.pop("views"))


def _wrappers() -> dict:
    """The objects behind every attribute ``capture_calls`` patches."""
    from volsync_tpu_torch.engine import chunker

    return {**{("seg", a): getattr(seg, a) for a in chip_smoke.SEG_WRAPPERS},
            **{("sha", a): getattr(sha, a) for a in chip_smoke.SHA_WRAPPERS},
            **{("chunker", a): getattr(chunker, a)
               for a in chip_smoke.CHUNKER_WRAPPERS}}


def _assert_restored(before: dict) -> None:
    after = _wrappers()
    assert after.keys() == before.keys()
    assert all(after[k] is before[k] for k in before), [
        k for k in before if after[k] is not before[k]]


def test_capture_calls_records_every_kernel_wrapper(rng):
    data = torch.from_numpy(rng.randint(0, 256, size=(64 * 1024,)).astype(
        "uint8"))
    cc, kc = seg.segment_caps(64 * 1024, PARAMS)
    p = PARAMS
    before = _wrappers()
    calls = chip_smoke.capture_calls(seg, sha, lambda: seg.chunk_hash_segment(
        data, 60_000, min_size=p.min_size, avg_size=p.avg_size,
        max_size=p.max_size, seed=p.seed, mask_s=p.mask_s, mask_l=p.mask_l,
        align=p.align, eof=True, cand_cap=cc, chunk_cap=kc))
    assert sorted(n for n, _, _ in calls) == sorted(chip_smoke.FUSED_CALLS)
    assert sorted(chip_smoke.FUSED_CALLS) == sorted(
        ["sha256_pages", "fastcdc_walk", "sha256_slices_tail",
         "merkle_roots"])
    assert sorted({**chip_smoke.SEG_WRAPPERS,
                   **chip_smoke.SHA_WRAPPERS}.values()) == sorted(
        chip_smoke.kernel_fns(seg, sha)[0])  # every kernel is recorded
    _assert_restored(before)

    def fails():
        assert seg.sha256_pages is not before[("seg", "sha256_pages")]
        raise RuntimeError("run failed")

    with pytest.raises(RuntimeError):
        chip_smoke.capture_calls(seg, sha, fails)
    _assert_restored(before)


def test_stage_probes_restore_the_segment_module():
    before = {fn: getattr(seg, fn) for fns in chip_smoke.STAGES.values()
              for fn in fns}
    timer = chip_smoke.StageTimer(torch)
    with chip_smoke.stage_probes(seg, timer):
        assert seg.sha256_pages is not before["sha256_pages"]
    assert before == {fn: getattr(seg, fn) for fn in before}


def test_sass_block_counts_reads_the_block_loop():
    ins = ["        /*0000*/                   S2R R0, SR_TID.X ;"]
    addr = 0x10
    loop = addr
    body = (["LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64]"] * 8
            + ["SHF.R.W.U32.HI R5, R4, 0x7, R4"] * 6
            + ["LOP3.LUT R6, R5, R7, R8, 0x96, !PT"] * 4
            + ["IADD3 R9, R6, R9, c[0x3][0x10]"] * 2
            + ["IMAD.MOV.U32 R1, RZ, RZ, R2", "ISETP.NE.AND P0, PT, R3, RZ, PT"])
    for text in body:
        ins.append(f"        /*{addr:04x}*/                   {text} ;")
        addr += 0x10
    ins.append(f"        /*{addr:04x}*/              @P0 BRA 0x{loop:x} ;")
    ins.append(f"        /*{addr + 0x10:04x}*/                   EXIT ;")
    sass = ("\t\tFunction : _Z19sha256_pages_kernelPKhPjii\n"
            + "\n".join(ins) + "\n\t\tFunction : _Z5otherv\n")
    got = chip_smoke.sass_block_counts(sass, "sha256_pages_kernel", 4)
    # two blocks in the loop body (4 cp.async each): every count halves
    assert got == {"LOP3/SHF": 5.0, "IADD3": 1.0, "IMAD": 0.5,
                   "LDGSTS": 4.0, "other": 1.0}
    assert chip_smoke.sass_block_counts(sass, "missing_kernel", 4) is None
    # an LDG-counted loop finds no block loop here
    assert chip_smoke.sass_block_counts(sass, "sha256_pages_kernel", 4,
                                        "LDG") is None


def test_chain_block_floor_is_the_compiled_block_issue():
    """A lone warp issues an ALU-pipe instruction every second cycle and
    any instruction every cycle: the larger of the two counts."""
    mr = {"LOP3/SHF": 640.0, "IADD3": 129.0, "IMAD": 134.0, "LDS": 64.0,
          "other": 4.0}
    ms = chip_smoke.chain_block_floor_ms(mr)
    assert ms == pytest.approx(2 * 769 / chip_smoke.CLOCK_HZ * 1e3)
    assert 0.7e-3 < ms < 0.8e-3  # about 0.78 us at 1.98 GHz
    fma_heavy = {"LOP3/SHF": 10.0, "IADD3": 0.0, "IMAD": 100.0, "LDG": 4.0,
                 "other": 0.0}
    assert chip_smoke.chain_block_floor_ms(fma_heavy) == pytest.approx(
        114 / chip_smoke.CLOCK_HZ * 1e3)
    assert chip_smoke.chain_block_floor_ms(None) is None


def test_script_fails_without_cuda_or_package(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for cwd, script in ((tmp_path, lone), (ROOT, ROOT / "chip_smoke.py")):
        out = subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                             capture_output=True, text=True, timeout=300,
                             env={"PATH": "/usr/bin:/bin",
                                  "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


PARAMS_64 = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                       align=64)
PARAMS_1 = GearParams(min_size=4096, avg_size=32768, max_size=65536,
                      align=1)


def _tiny_stream(monkeypatch, blocks: int):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "BLOCK", 128 * 1024)
    return chip_smoke.SeededStream(torch, 1, blocks * 128 * 1024 + 12345)


def test_split_stream_phase_on_cpu(monkeypatch):
    res = chip_smoke.split_stream_phase(torch, _tiny_stream(monkeypatch, 3),
                                        PARAMS_64)
    assert res["passes"] == 1 and len(res["results"]) > 5


@pytest.mark.parametrize("phase,params", [
    ("legacy_stream_phase", PARAMS_1),
    ("pagemajor_stream_phase", PARAMS)], ids=["align1", "pagemajor"])
def test_legacy_and_pagemajor_stream_phases_on_cpu(monkeypatch, phase,
                                                   params):
    res = getattr(chip_smoke, phase)(torch, _tiny_stream(monkeypatch, 2),
                                     params)
    assert res["passes"] == 1 and res["gibs"] > 0


def test_dense_oracle_equals_the_port_gear_hash(rng):
    """The numpy per-position oracle (with a halo) flags the positions
    where the port's gear_hash_positions clears the masks."""
    from volsync_tpu_torch.ops.gearcdc import gear_hash_positions

    p = GearParams(min_size=256, avg_size=1024, max_size=4096, align=1)
    x = rng.randint(0, 256, size=(20_000,)).astype(np.uint8)
    h = gear_hash_positions(torch.from_numpy(x), p.seed).numpy()[31:]
    s, l = chip_smoke.dense_candidates(x, p, 31)
    np.testing.assert_array_equal(s, np.nonzero((h & p.mask_s) == 0)[0])
    np.testing.assert_array_equal(l, np.nonzero((h & p.mask_l) == 0)[0])
    assert len(l) > len(s) > 0


def test_capture_calls_records_the_split_phase_leaf_dispatch(rng,
                                                             monkeypatch):
    from volsync_tpu_torch.engine import DeviceChunkHasher

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    host = rng.randint(0, 256, size=(128 * 1024,)).astype(np.uint8)
    hasher = DeviceChunkHasher(PARAMS_64, device="cpu")
    before = _wrappers()
    calls = chip_smoke.capture_calls(seg, sha, lambda: hasher.begin(
        host, eof=False, valid_len=120_000))
    chip_smoke.expect_calls("split", calls, ["sha256_rows", "sha256_slices"])
    with pytest.raises(AssertionError):
        chip_smoke.expect_calls("split", calls, ["sha256_rows"])
    _assert_restored(before)


def test_pagemajor_env_restores_the_variable(monkeypatch):
    import os

    monkeypatch.setenv("VOLSYNC_PAGEMAJOR", "0")
    with chip_smoke.pagemajor_env():
        assert os.environ["VOLSYNC_PAGEMAJOR"] == "1"
    with chip_smoke.pagemajor_env(False):
        assert "VOLSYNC_PAGEMAJOR" not in os.environ
    assert os.environ["VOLSYNC_PAGEMAJOR"] == "0"


def test_warp_floor_of_k1_and_k2():
    """12,288 pages or 16,384 leaves at 64 threads a block: no scheduler
    holds two warps, so the floor is one warp's 65 blocks of ALU
    instructions at 16 lanes a cycle; 48 blocks of 256 threads put two
    warps on a scheduler."""
    one = (64 * 1024 + 640) * 2 / chip_smoke.CLOCK_HZ * 1e3
    assert chip_smoke.warp_floor_ms(12288, 64) == pytest.approx(one)
    assert chip_smoke.warp_floor_ms(16384, 64) == pytest.approx(one)
    assert 0.0667 < one < 0.0669
    assert chip_smoke.warp_floor_ms(12288, 256) == pytest.approx(2 * one)


def test_walk_bound_on_a_captured_walk(rng):
    """The walk's bound from the fused segment's own fastcdc_walk inputs:
    the candidates up to each lane's last cut, the longest lane's
    chunks, and the larger of bytes and chain."""
    data = torch.from_numpy(rng.randint(0, 256, size=(256 * 1024,)).astype(
        "uint8"))
    cc, kc = seg.segment_caps(256 * 1024, PARAMS)
    p = PARAMS
    calls = chip_smoke.capture_calls(seg, sha, lambda: seg.chunk_hash_segment(
        data, 250_000, min_size=p.min_size, avg_size=p.avg_size,
        max_size=p.max_size, seed=p.seed, mask_s=p.mask_s, mask_l=p.mask_l,
        align=p.align, eof=True, cand_cap=cc, chunk_cap=kc))
    _, args, kwargs = next(c for c in calls if c[0] == "fastcdc_walk")
    assert sorted(kwargs) == ["align", "avg_size", "chunk_cap", "max_size",
                              "min_size"]
    out = seg.fastcdc_walk(*args, **kwargs)
    lat = {"l2_ns": 300.0, "shared_ns": 30.0}
    b = chip_smoke.walk_bound(torch, args, out, lat)
    pos_s, ns, pos_l, nl, valid_len, eof = args
    assert int(out[3][0]) == 250_000 and b["longest"] == int(out[2][0]) > 3
    n = int((pos_s[0, :ns[0]] < 250_000).sum()
            + (pos_l[0, :nl[0]] < 250_000).sum())
    assert b["candidates"] == n > 0
    assert b["bytes_ms"] == pytest.approx(
        (n * 8 + 25 + kc * 8 + 8) / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert b["chain_ms"] == pytest.approx((300 + 30 * b["longest"]) * 1e-6)
    assert (b["bound_ms"], b["bound_by"]) == (b["chain_ms"], "operations")
    lat = {"l2_ns": 0.0, "shared_ns": 0.0}
    assert chip_smoke.walk_bound(torch, args, out, lat)["bound_by"] == "bytes"


def test_split_segment_check_on_cpu(monkeypatch):
    """K2's check rehearsed at a tiny size with the twins (kernel timing
    stubbed out): one sha256_rows and one sha256_slices, each equal to
    its twin, every K2 lane equal to hashlib, every id to blob_id; the
    tail lanes' shape recorded with its bound."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda torch, fn, reps, graph=True: 0.0)
    host = np.random.RandomState(7).randint(0, 256, size=(160 * 1024,)
                                            ).astype(np.uint8)
    stats = chip_smoke.new_stats()
    chip_smoke.split_segment_check(torch, chip_smoke.kernel_fns(seg, sha),
                                   stats, host, PARAMS_64)
    st = stats["sha256_rows"]
    assert st["err"] == 0 and st["bound_by"] == "operations"
    assert len(st["bound"]) == 1 and st["bound"][0] > 0
    split = stats["sha256_slices"]["shapes"]["split"]
    assert split["lanes"] >= 8 and split["blocks"] > 0
    assert stats["sha256_slices"]["ms"] == []  # the legacy shape's entry
    assert split["bound_ms"] > 0 and split["bound_kind"] in (
        "work", "per-warp floor")
    assert stats["sha256_lanes"]["ms"] == []  # timed at the legacy shape


def _no_timing(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda torch, fn, reps, graph=True: 0.0)


def test_legacy_segment_check_on_cpu(monkeypatch):
    """sha256_slices at the legacy shape rehearsed at a tiny size: one
    launch a segment, equal to its twin and hashlib on every lane,
    whose work and bound make the kernel's entry; sha256_lanes held
    against its twin on the same lanes' padded messages."""
    _no_timing(monkeypatch)
    host = np.random.RandomState(8).randint(0, 256, size=(96 * 1024,)
                                            ).astype(np.uint8)
    stats = chip_smoke.new_stats()
    p1 = GearParams(min_size=4096, avg_size=16384, max_size=32768, align=1)
    chip_smoke.legacy_segment_check(torch, chip_smoke.kernel_fns(seg, sha),
                                    stats, host, p1)
    st = stats["sha256_slices"]
    assert st["err"] == 0 and len(st["bound"]) == 1
    legacy = st["shapes"]["legacy"]
    assert legacy["lanes"] == 128 and legacy["blocks"] > 128
    # 128 lanes are 2 blocks: one warp a scheduler, so the longest
    # lane's floor (a 4 KiB leaf) is K1's per-warp floor.
    assert st["bound"][0] == pytest.approx(
        chip_smoke.warp_floor_ms(16384, 64))
    assert (st["bound_by"], st["bound_kind"]) == ("operations",
                                                  "per-warp floor")
    lanes = stats["sha256_lanes"]
    assert lanes["err"] == 0 and len(lanes["ms"]) == len(lanes["bound"]) == 1
    assert lanes["longest"] == 65


def test_slice_work_counts_blocks():
    w = chip_smoke.slice_work(torch, torch.tensor([0, 4096, 4000, 55, 56,
                                                   5000]), 65)
    # 0: a padding block; 4096: 64 + 1; 4000: 63; 55: 1; 56: 1 + 1;
    # 5000 (past max_len): 65 blocks of message
    assert (w["data_blocks"], w["pad_blocks"]) == (64 + 63 + 1 + 1 + 65,
                                                   1 + 1 + 1)
    assert w["bytes"] == 4096 + 4000 + 55 + 56 + 5000
    assert w["longest"] == 65
    assert w["lane_ops"] == 65 * 1024  # the lane past max_len


@pytest.mark.parametrize("lanes,lane_ops,kind", [
    (16384, 64 * 1024 + 640, "per-warp floor"),  # the legacy shape
    (1, 64 * 1024 + 640, "per-warp floor"),  # one 4,095-byte tail
    (1, 0, "work")])  # a lane with no tail
def test_lanes_bound_takes_the_function_work(lanes, lane_ops, kind):
    """A launch's bound is the larger of the whole card's work and the
    longest lane's per-warp floor, both from the function's ALU work (not
    from a kernel's compiled loop): 0.0668 ms for a 4 KiB leaf."""
    work = chip_smoke.sha_bound(100, 1, 10_000)
    b = chip_smoke.lanes_bound(lanes, 64, lane_ops, work)
    assert b["bound_kind"] == kind
    floor = lane_ops * 2 / chip_smoke.CLOCK_HZ * 1e3
    assert b["floor_ms"] == pytest.approx(floor)
    assert b["bound_ms"] == pytest.approx(max(floor, work[0]))
    if lane_ops:
        assert 0.0667 < b["bound_ms"] < 0.0669


def test_tail_and_pagemajor_checks_on_cpu(monkeypatch, rng):
    """The fused tail's check (its work and bound, and a 4,095-byte tail
    equal to the twin with its own bound) and the page-major check (no
    pagemajor_u32 on the path, K1's
    page-major table equal to hashlib's transposed, K4 on the word-major
    table) rehearsed on a small segment with the twins."""
    _no_timing(monkeypatch)
    P = 64 * 1024
    host = rng.randint(0, 256, size=(P,)).astype(np.uint8)
    data = torch.from_numpy(host)
    cc, kc = seg.segment_caps(P, PARAMS)
    p = PARAMS
    kw = dict(min_size=p.min_size, avg_size=p.avg_size, max_size=p.max_size,
              seed=p.seed, mask_s=p.mask_s, mask_l=p.mask_l, align=p.align,
              eof=True, cand_cap=cc, chunk_cap=kc)
    valid = P - 5 * 4096 - 777
    packed = []
    calls = chip_smoke.capture_calls(seg, sha, lambda: packed.append(
        seg.chunk_hash_segment(data, valid, **kw)))
    fns = chip_smoke.kernel_fns(seg, sha)
    stats = chip_smoke.new_stats()
    name, args, kwargs = next(c for c in calls
                              if c[0] == "sha256_slices_tail")
    out_k, _, err, _ = chip_smoke.against_twin(torch, fns, name, args, kwargs)
    stats[name]["ms"].append(0.0)
    stats[name]["eager_ms"].append(0.0)
    chip_smoke.tail_checks(torch, stats, args, kwargs)
    st = stats[name]
    assert err == 0 and 0 < st["longest"] <= 65
    assert st["shapes"]["fused_tail"]["lanes"] == 1
    assert len(st["shapes"]) == 2  # and the tail one byte longer or shorter
    assert len(st["bound"]) == 1 and st["bound_kind"] == "per-warp floor"
    assert st["bound"][0] == pytest.approx(
        st["shapes"]["fused_tail"]["bound_ms"])

    npp = P // 4096
    stats["sha256_pages"]["bound"].append(1.0)
    k1 = (data, npp, chip_smoke.page_table(host, npp))
    chip_smoke.pagemajor_check(torch, fns, stats, data, valid, kw,
                               packed[0], k1)
    assert stats["sha256_pages_pagemajor"]["err"] == 0
    assert stats["pagemajor_u32"]["bound_by"] == "bytes"
