"""chip_smoke.py rehearsed on the CPU: its seeded stream, host oracles
(aligned and per-position), verify check, the split-phase, legacy and
page-major stream phases and kernel-input capture run at a tiny size
with the kernels' plain twins, and the script itself refuses to report
without CUDA or without the package beside it."""

import json
import os
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


def test_batcher_turns_on_cpu(monkeypatch):
    """A lone stream through the engine's own pipeline and through the
    shared batcher (forced on, as CUDA has it by default), in turns:
    the same chunks every turn, one device pass a segment either way."""
    from volsync_tpu_torch.ops import batcher

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "BLOCK", 256 * 1024)
    monkeypatch.setenv("VOLSYNC_BATCH_SEGMENTS", "1")
    monkeypatch.setattr(batcher, "_SHARED", {})
    stream = chip_smoke.SeededStream(torch, 0, 3 * 256 * 1024 + 12345)
    want, _, _ = chip_smoke.stream_once(torch, stream, PARAMS,
                                        chip_smoke.engine_hasher(PARAMS))
    try:
        turns = chip_smoke.batcher_turns(torch, stream, PARAMS, want)
    finally:
        for b in batcher._SHARED.values():
            b.stop()
    assert turns["batching"] and len(batcher._SHARED) == 1
    assert [len(turns[k]) for k in ("off", "on")] == [2, 2]
    assert all(t["passes"] == t["segments"] == 1 and t["gibs"] > 0
               for k in ("off", "on") for t in turns[k])


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


@pytest.mark.parametrize("phase,params,per_pass", [
    ("split_stream_phase", PARAMS_64, chip_smoke.SPLIT_PER_PASS),
    ("legacy_stream_phase", PARAMS_1, chip_smoke.LEGACY_PER_PASS)],
    ids=["align64", "align1"])
def test_walk_turns_on_cpu(monkeypatch, phase, params, per_pass):
    """The native C walk and the Python walk in turns over a stream:
    equal chunks every turn, every C turn's segments walked in C."""
    stream = _tiny_stream(monkeypatch, 2)
    first = getattr(chip_smoke, phase)(torch, stream, params)
    walks = chip_smoke.walk_turns(torch, stream, params, per_pass, "tiny",
                                  first, "cpu")
    assert len(walks["c"]) == len(walks["py"]) == 2
    assert all(w > 0 for w in walks["c"] + walks["py"])


def test_walk_turns_catch_a_walk_that_differs(monkeypatch):
    from volsync_tpu_torch.ops import gearcdc

    stream = _tiny_stream(monkeypatch, 2)
    first = chip_smoke.split_stream_phase(torch, stream, PARAMS_64)
    real = gearcdc._select_boundaries_py

    def off_by_one(idx_s, idx_l, length, params, **kw):
        out = real(idx_s, idx_l, length, params, **kw)
        if len(out) >= 2:  # the first cut one row (64 bytes) early
            (s0, n0), (s1, n1) = out[:2]
            out[:2] = [(s0, n0 - 64), (s1 - 64, n1 + 64)]
        return out

    monkeypatch.setattr(gearcdc, "_select_boundaries_py", off_by_one)
    with pytest.raises(AssertionError, match="the py walk gave other"):
        chip_smoke.walk_turns(torch, stream, PARAMS_64,
                              chip_smoke.SPLIT_PER_PASS, "tiny", first, "cpu")


def test_reader_check_on_cpu(tmp_path):
    p = tmp_path / "big.bin"
    p.write_bytes(np.random.RandomState(3).bytes((3 << 20) + 12345))
    rates = chip_smoke.reader_check(p, (2 << 20) + 7, "cpu")
    assert len(rates["native"]) == len(rates["open"]) == 2
    with pytest.raises(AssertionError, match="ended"):
        chip_smoke.reader_check(p, 4 << 20, "cpu")


def test_flight_report_of_a_batched_backup_on_cpu(monkeypatch, tmp_path):
    """The flight recorder around a TreeBackup whose segments go through
    the shared micro-batcher (forced on here): the dump holds engine.*,
    repo.seal and ops.batch_dispatch spans of one trace on several
    threads, nested, and the report reads each thread's busy seconds."""
    import time

    from volsync_tpu_torch.engine.backup import TreeBackup
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.repo.repository import Repository

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setenv("VOLSYNC_BATCH_SEGMENTS", "1")
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.RandomState(9)
    (src / "a.bin").write_bytes(rng.bytes(150_000))
    (src / "small.bin").write_bytes(rng.bytes(1000))
    repo = Repository.init(FsObjectStore(tmp_path / "repo"),
                           chunker=SMALL_CHUNKER, device="cpu")
    with chip_smoke.flight_recorder() as root:
        t0 = time.perf_counter()
        TreeBackup(repo, workers=1).run(src)
        rep = chip_smoke.flight_report(root, tmp_path / "flight.json",
                                       time.perf_counter() - t0, True, True,
                                       "cpu")
    assert {"ops.batch_dispatch", "repo.seal"} <= set(rep["names"])
    assert any(n.startswith("engine.") for n in rep["names"])
    assert len(rep["threads"]) >= 2
    assert sum(t["seal_s"] for t in rep["threads"].values()) > 0
    doc = json.loads((tmp_path / "flight.json").read_text())
    assert doc["displayTimeUnit"] == "ms"
    from volsync_tpu_torch import envflags
    assert envflags.trace_ring_size() == 4096  # the knob is back


def test_flight_report_refuses_a_wrapped_ring(monkeypatch, tmp_path):
    from volsync_tpu_torch import obs

    monkeypatch.setattr(chip_smoke, "TRACE_RING", 16)
    with chip_smoke.flight_recorder() as root:
        for _ in range(20):
            with obs.span("repo.seal"):
                pass
        with pytest.raises(AssertionError, match="wrapped"):
            chip_smoke.flight_report(root, tmp_path / "f.json", 1.0, False,
                                     False, "cpu")


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


def test_backup_tree_builder_layout(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "BLOCK", 64 * 1024)
    made = chip_smoke.make_backup_tree(torch, tmp_path / "t", 1 << 20, 2,
                                       min_size=4096, hole=256 * 1024)
    state = chip_smoke.tree_state(tmp_path / "t")
    files = {k: v for k, v in state.items() if v[0] == "file"}
    assert len(files) == chip_smoke.SMALL_FILES + 5
    assert sum(v[3] for k, v in files.items() if k != "nested/deeper/link.bin") \
        == made["bytes"]
    assert files["big.bin"][3] >= made["bytes"] // 2 - 300 * 4096
    assert files["odd.bin"][3] % (1 << 20) == chip_smoke.ODD_TAIL
    assert files["odd.bin"][5] == files["nested/deeper/link.bin"][5]
    assert files["empty"][3] == 0
    assert files["sparse.bin"][6] * 512 < files["sparse.bin"][3] - 128 * 1024
    assert all(v[3] < 4096 for k, v in files.items() if k.startswith("small"))
    chip_smoke.check_restored("self", state, tmp_path / "t", made["hole"])
    (tmp_path / "t" / "small" / "00" / "f0000.bin").write_bytes(b"x")
    with pytest.raises(AssertionError, match="differs"):
        chip_smoke.check_restored("edited", state, tmp_path / "t",
                                  made["hole"])


def test_check_restored_refuses_a_filled_hole(monkeypatch, tmp_path):
    """Where the filesystem keeps holes, a restore that writes the same
    bytes densely fails the hole check; the base chooser takes such a
    directory; and writes into the hole fail on any filesystem."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "BLOCK", 64 * 1024)
    assert chip_smoke.keeps_holes(tmp_path)
    assert chip_smoke.backup_base(tmp_path, 1 << 20) in (
        tmp_path, Path(chip_smoke.tempfile.gettempdir()))
    made = chip_smoke.make_backup_tree(torch, tmp_path / "t", 1 << 20, 2,
                                       min_size=4096, hole=256 * 1024)
    state = chip_smoke.tree_state(tmp_path / "t")
    assert state["sparse.bin"][7] >= made["hole"]
    sparse = tmp_path / "t" / "sparse.bin"
    st = sparse.stat()
    sparse.write_bytes(sparse.read_bytes())
    os.utime(sparse, ns=(st.st_atime_ns, st.st_mtime_ns))
    with pytest.raises(AssertionError, match="hole filled"):
        chip_smoke.check_restored("dense", state, tmp_path / "t",
                                  made["hole"])
    # the writes a restore makes are held to the hole on any filesystem
    a, n = made["hole_at"], made["hole"]
    data = [(0, a), (a + n, a + n + 4096)]
    chip_smoke.check_hole_unwritten("sparse", data, made)
    for written in ([], data + [(a + 4096, a + 4096 + 5 * 4096)]):
        with pytest.raises(AssertionError, match="inside its"):
            chip_smoke.check_hole_unwritten("dense", written, made)


def test_backup_phase_on_cpu(monkeypatch, tmp_path):
    """The whole backup phase at a tiny size: backup, second backup,
    check, pipelined and serial restore, the corrupt pack, for the
    encrypted fused repository and the unencrypted align-64 one."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "BLOCK", 64 * 1024)
    monkeypatch.setattr(chip_smoke, "SMALL_FILES", 3)
    # one thread: the CPU twins slow down several-fold under concurrent
    # threads (the card runs the default four workers)
    monkeypatch.setenv("VOLSYNC_BACKUP_WORKERS", "1")
    monkeypatch.setenv("VOLSYNC_RESTORE_WORKERS", "1")
    chunker = {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
               "seed": 0x5EED_CDC1, "align": 4096}
    res = chip_smoke.backup_phase(torch, tmp_path, 300_000, 200_000, 5,
                                  "cpu", chunker=chunker, hole=128 * 1024)
    # the fused tree's big.bin read through both routes; every backup
    # file opened through the native reader; the device verify's
    # restore_verify_fail dump landed for the unencrypted repository
    assert len(res["fused"]["reader"]["native"]) == 2
    assert not any(n.startswith("trace-restore_verify_fail")
                   for n in res["fused"]["trace_dumps"])
    assert any(n.startswith("trace-restore_verify_fail")
               for n in res["split"]["trace_dumps"])
    for engine in ("fused", "split"):
        r = res[engine]
        assert set(r["readers"]) == {"ReadaheadReader"}
        assert r["backup"]["passes"] >= 3
        assert r["check"]["passes"] >= 1 and r["restore"]["passes"] >= 1
        assert r["backup_gibs"] > 0 and r["restore_gibs"] > 0
        assert r["hole_kept"]
        assert "repo.seal" in r["backup"]["spans"]
        assert {"repo.read", "repo.verify"} <= set(r["check"]["spans"])
        for run in ("restore", "serial"):
            assert {"restore.verify", "restore.write"} <= \
                set(r[run]["spans"])


def test_durability_phase_on_cpu(monkeypatch, tmp_path):
    """The durability phase at a tiny size (64 KiB packs, one worker):
    the erasure-coded backup, check and restores through lost shards,
    the scrubs, the repack and the unhealable pack; and gf_matmul's
    entry at a two-page grid."""
    from volsync_tpu_torch.repo.repository import Repository

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "BLOCK", 64 * 1024)
    monkeypatch.setattr(chip_smoke, "SMALL_FILES", 3)
    monkeypatch.setattr(chip_smoke, "REPACK_GRACE_S", 0.2)
    monkeypatch.setattr(Repository, "PACK_TARGET", 64 * 1024)
    monkeypatch.setenv("VOLSYNC_BACKUP_WORKERS", "1")
    monkeypatch.setenv("VOLSYNC_RESTORE_WORKERS", "1")
    chunker = {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
               "seed": 0x5EED_CDC1, "align": 4096}
    res = chip_smoke.durability_phase(torch, tmp_path, 300_000, 5, "cpu",
                                      chunker=chunker, hole=128 * 1024)
    packs = res["scrub"]["report"]["packs"]
    assert packs >= 2 and res["scrub"]["report"]["healed"] == packs
    assert res["overhead"] <= chip_smoke.EC_STORED_MAX
    assert res["backup"]["gf_calls"] == packs  # one encode a pack
    assert res["check"]["gf_calls"] == len(res["check"]["decoded"]) == packs
    assert res["scrub"]["passes"] == packs  # one verify batch a pack
    assert res["backup2"]["passes"] >= 1
    assert res["repack"]["outcomes"]["ok"] >= 1
    assert "ec.encode" in res["backup"]["spans"]
    assert {"ec.reconstruct", "scrub.verify"} <= set(res["scrub"]["spans"])
    assert sum(c["report"]["packs_rewritten"]
               for c in res["repack"]["cycles"]) >= 1
    entry = chip_smoke.gf_matmul_entry(torch, 0, "cpu", pages=2)
    assert entry["max_abs_err"] == 0 and entry["bound_by"] == "bytes"
    assert entry["bound_ms"] == pytest.approx(6 * 2 * 4096 / 3.35e12 * 1e3)


SMALL_DELTA = {"big": 256 * 1024, "n_mid": 4, "mid": 64 * 1024,
               "n_small": 8, "small": 32 * 1024, "n_tiny": 5}


def test_delta_phase_on_cpu(monkeypatch, tmp_path):
    """The delta phase at a few hundred KiB with the twins: every check
    passes (signatures against the host formulas, rebuilt files, batch
    against serial and against the CPU port, the literal bounds of each
    edit), with one scan call per 32 files and the stages timed."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "DELTA_CPU_FILES", 2)
    res = chip_smoke.delta_phase(torch, tmp_path, SMALL_DELTA, 5, "cpu")
    assert res["files"] == 1 + 4 + 8 + 5 + 2
    assert res["scan_calls"] == 1 and res["groups"] >= 1
    assert res["signatures"] == 1 + 4 + 8 + 1  # and the emptied file's
    assert set(res["stages_s"]) == set(chip_smoke.DELTA_STAGES.values())
    assert 0 < res["literal_share"] < 1
    assert res["peak_bytes"] is None and res["busy_s"] is None


def test_delta_trees_layout(tmp_path):
    made = chip_smoke.make_delta_trees(tmp_path, SMALL_DELTA, 1)
    kinds = [m[0] for m in made.values()]
    assert kinds.count("big") == 1 and kinds.count("tiny") == 5
    assert {k: kinds.count(k) for k in ("unchanged", "insert", "rewrite",
                                        "unrelated")} == dict.fromkeys(
        ("unchanged", "insert", "rewrite", "unrelated"), 3)
    kind, edit, src, dst = made["big.bin"]
    assert len(src) == len(dst) + chip_smoke.DELTA_INSERT + \
        chip_smoke.DELTA_APPEND
    assert not (tmp_path / "dst" / "new.bin").exists()
    assert (tmp_path / "src" / "empty.bin").read_bytes() == b""
    assert chip_smoke.delta_layout(1.0) == chip_smoke.DELTA_LAYOUT
    assert chip_smoke.delta_layout(0.25)["n_small"] == 60


def test_md5_bound_takes_the_larger_of_work_and_floor():
    # the signature's shape: a scheduler holds one warp, so the longest
    # lane's 513 blocks floor it above the card's whole ALU rate
    b = chip_smoke.md5_bound(16384, 16384 * 513, 513, 16384 * 32784,
                             chip_smoke.MD5_BLOCK_ALU_OPS)
    assert b["bound_kind"] == "per-warp floor"
    assert b["bound_ms"] == pytest.approx(
        513 * chip_smoke.MD5_BLOCK_ALU_OPS * 2 / chip_smoke.CLOCK_HZ * 1e3)
    assert chip_smoke.md5_block_ops({}) == (chip_smoke.MD5_BLOCK_ALU_OPS,
                                            "as written")


def test_md5_bound_takes_the_chain_when_it_is_longest():
    """Given one round's latency in cycles, the bound is the longest
    lane's 64 dependent rounds a block at the card's clock where that
    exceeds the work and the per-warp floor; without it, no chain."""
    b = chip_smoke.md5_bound(16384, 16384 * 513, 513, 16384 * 32784,
                             chip_smoke.MD5_BLOCK_ALU_OPS, 16.0)
    chain = 513 * 64 * 16.0 / chip_smoke.CLOCK_HZ * 1e3
    assert b["chain_ms"] == pytest.approx(chain)
    assert (b["bound_ms"], b["bound_by"], b["bound_kind"]) == (
        pytest.approx(chain), "operations", "chain")
    small = chip_smoke.md5_bound(16384, 16384 * 513, 513, 16384 * 32784,
                                 chip_smoke.MD5_BLOCK_ALU_OPS, 1.0)
    assert small["bound_kind"] == "per-warp floor"
    assert small["chain_ms"] == pytest.approx(chain / 16)
    assert chip_smoke.md5_bound(1, 1, 1, 64, 100.0)["chain_ms"] is None


def test_md5_bound_of_a_1_mib_signature():
    """The 1 MiB signature's launch (256 lanes of 65 blocks): 4 blocks of
    64 threads, one warp a scheduler, so the bound is the longest lane's
    chain, 65 x 64 rounds, where the probe's round latency is given."""
    n, nb = chip_smoke.MD5_SMALL_WINDOWS, (chip_smoke.MD5_SMALL_LEN + 72) // 64
    assert (n, nb) == (256, 65)
    b = chip_smoke.md5_bound(n, n * nb, nb, n * (4096 + 16),
                             chip_smoke.MD5_BLOCK_ALU_OPS, 18.52)
    chain = 65 * 64 * 18.52 / chip_smoke.CLOCK_HZ * 1e3
    assert b["chain_ms"] == pytest.approx(chain)
    assert (b["bound_ms"], b["bound_kind"]) == (pytest.approx(chain),
                                                "chain")
    assert b["floor_ms"] == pytest.approx(
        65 * chip_smoke.MD5_BLOCK_ALU_OPS * 2 / chip_smoke.CLOCK_HZ * 1e3)


def test_md5_split_summary_per_block_cycles():
    """The split's raw sums (wait, words, edge, rounds, issue, loop,
    blocks) become cycles a block; ``other`` is the loop less the four
    timed parts (the edge path is inside words)."""
    from volsync_tpu_torch.tools.time_md5_calls import split_summary

    sp = split_summary([650, 1300, 260, 75400, 195, 78000, 65])
    assert sp["blocks"] == 65
    assert sp["per_block"] == pytest.approx({
        "wait": 10.0, "words": 20.0, "edge": 4.0, "rounds": 1160.0,
        "issue": 3.0, "loop": 1200.0, "other": 7.0})
    assert sp["cycles"]["loop"] == 78000
    # a lane that compressed nothing divides by one, not zero
    assert split_summary([0] * 7)["per_block"]["loop"] == 0.0
    line = chip_smoke.md5_split_line("verify", {**sp, "lane": 3}, 18.5)
    assert "lane 3, 65 blocks" in line and "rounds 1160.0" in line
    assert "chain of 1184.0" in line
    assert "chain of not measured" in chip_smoke.md5_split_line(
        "verify", {**sp, "lane": 3}, None)


def test_sass_chain_follows_register_dependencies():
    """The longest chain of dependent instructions through one pass of a
    loop body: two rounds of LOP3 -> IADD3 -> SHF -> IADD3 on b give 8
    (4 a round); independent instructions and stores add nothing."""
    rnd = [("LOP3.LUT", "R6, R5, R7, R8, 0x96, !PT"),
           ("IADD3", "R6, R6, R2, RZ"),
           ("SHF.L.W.U32.HI", "R6, R6, 0x7, R6"),
           ("IADD3", "R5, R5, R6, RZ")]
    body = ([("LDS", "R8, [R3+0x10]")] + rnd
            + [("IMAD.MOV.U32", "R9, RZ, RZ, R4"), ("STS", "[R3], R9")]
            + rnd + [("BRA", "0x10")])
    ch = chip_smoke.sass_chain(body, 2)
    assert ch["length"] == 9  # the LDS feeds the first round's LOP3
    assert ch["per_round"] == 4.5
    assert ch["ops"] == {"LDS": 1, "LOP3": 2, "IADD3": 4, "SHF": 2}
    assert chip_smoke.sass_chain([], 64)["length"] == 0


def test_straight_runs_split_a_loop_at_its_branches():
    """A loop body with an edge branch before its rounds: the run after
    the branch target holds the rounds and the longest chain."""
    body = [(0x10, "ISETP.GE.AND", "P0, PT, R2, R3, PT"),
            (0x20, "BRA", "0x50"),  # past the edge words
            (0x30, "LOP3.LUT", "R9, R9, R10, RZ, 0xc0, !PT"),
            (0x40, "IADD3", "R9, R9, 0x80, RZ"),
            (0x50, "LDS", "R8, [R3+0x10]"),
            (0x60, "LOP3.LUT", "R6, R5, R7, R8, 0x96, !PT"),
            (0x70, "IADD3", "R5, R5, R6, RZ"),
            (0x80, "BRA", "0x10")]
    runs = chip_smoke.straight_runs(body)
    assert [[op for op, _ in r] for r in runs] == [
        ["ISETP.GE.AND", "BRA"], ["LOP3.LUT", "IADD3"],
        ["LDS", "LOP3.LUT", "IADD3", "BRA"]]
    assert [chip_smoke.sass_chain(r, 1)["length"] for r in runs] == [1, 2, 3]


def test_chrome_trace_busy_reads_device_events(tmp_path):
    """The busy seconds of a written trace: the union of its kernels',
    copies' and memsets' intervals (microseconds), host events ignored;
    None when it holds no device event."""
    trace = {"traceEvents": [
        {"cat": "kernel", "ts": 0, "dur": 10},
        {"cat": "gpu_memcpy", "ts": 5, "dur": 10},
        {"cat": "gpu_memset", "ts": 100, "dur": 1},
        {"cat": "cpu_op", "ts": 0, "dur": 1000}]}
    p = tmp_path / "t.json"
    p.write_text(json.dumps(trace))
    got = chip_smoke.chrome_trace_busy(p)
    assert got["busy_s"] == pytest.approx(16e-6) and got["events"] == 3
    assert got["by_kind"] == {"kernels": 0.0, "Memcpy": 0.0, "Memset": 0.0}
    p.write_text(json.dumps({"traceEvents": trace["traceEvents"][3:]}))
    assert chip_smoke.chrome_trace_busy(p)["busy_s"] is None


def test_mover_phase_on_cpu(monkeypatch, tmp_path):
    """The mover phase at a few hundred KiB with the twins: the push
    through the entry points leaves the destination equal to the source,
    every file within its literal bound, the refused handshakes and the
    cold push; the wire and the planner are metered."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "COLD_BYTES", 4 * 64 * 1024)
    made = chip_smoke.make_delta_trees(tmp_path, SMALL_DELTA, 5)
    res = chip_smoke.mover_phase(torch, tmp_path, made, 7, "cpu")
    assert res["files"] == len(made) == 20
    assert res["src_bytes"] == sum(len(m[2]) for m in made.values())
    assert 0 < res["literal_share"] < 1
    assert res["signatures"] >= 1 and res["groups"] >= 1
    assert sum(n for n, _ in res["split"].values()) == 20
    assert res["wire_bytes"]["source"] > res["literal_bytes"]
    assert {"seal", "open"} <= set(res["codec_s"])
    # mid000..mid002 (the insert file one byte longer) fit, mid003 not
    assert res["cold"]["files"] == 3
    assert res["cold"]["bytes"] == 3 * 65536 + 1
    assert res["busy_s"] is None
    pinned = res["delta_pinned"]
    assert set(pinned["split"]) == {"delta"}
    assert pinned["signatures"] >= res["signatures"]
    for push in (res, pinned):  # one book sample an apply
        assert push["book"]["rtt_n"] + push["book"]["link_n"] == 20
    assert not (tmp_path / "dst-delta").exists()


def test_restic_entry_phase_on_cpu(monkeypatch, tmp_path):
    """The restic entry phase at a few hundred KiB: backup, edits, a
    second backup with forget and prune, and a byte-identical restore
    through ``restic_entrypoint``, one snapshot left, one trace a
    backup."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "BLOCK", 64 * 1024)
    monkeypatch.setattr(chip_smoke, "SMALL_FILES", 3)
    monkeypatch.setattr(chip_smoke, "RESTIC_HOLE", 128 * 1024)
    monkeypatch.setenv("VOLSYNC_BACKUP_WORKERS", "1")
    monkeypatch.setenv("VOLSYNC_RESTORE_WORKERS", "1")
    res = chip_smoke.restic_entry_phase(torch, tmp_path, 300_000, 5, "cpu")
    # the flight recorder's dump of the first backup (below min_size
    # here: seal spans only, on the seal and upload threads)
    assert res["flight"]["names"]["repo.seal"] >= 1
    assert len(res["flight"]["threads"]) >= 2
    assert (tmp_path / "restic-flight.json").is_file()
    for run in ("backup", "backup2", "restore"):
        assert res[run]["gibs"] > 0 and res[run]["busy_s"] is None
    assert res["restore"]["passes"] >= 1
    assert res["backup"]["trace_file"] != res["backup2"]["trace_file"]
    assert "restore.write" in res["restore"]["spans"]
    assert len(list((tmp_path / "restic-traces" / "restic-backup")
                    .iterdir())) == 2
    assert len(list((tmp_path / "restic-traces" / "restic-restore")
                    .iterdir())) == 1


# -- the rclone phase ------------------------------------------------------------

SMALL_RCLONE = {**chip_smoke.RCLONE_LAYOUT, "files": 60, "dirs": 4,
                "small_max": 8192, "empty": 3, "links": 4, "dir_links": 2,
                "empty_dirs": 2, "n_mid": 2, "mid_min": 40_000,
                "mid_max": 90_000, "big": 300_000 + 12345}


def test_rclone_tree_maker_layout(tmp_path):
    """The seeded tree: its counts of each kind, sizes, byte copies,
    symlinks (two to directories) and empty directories, made the same
    from the same seed."""
    made = chip_smoke.make_rclone_tree(tmp_path / "a", SMALL_RCLONE, 4)
    state = chip_smoke.rclone_state(tmp_path / "a")
    kinds = [v[0] for v in state.values()]
    files = {r: v for r, v in state.items() if v[0] == "file"}
    assert len(files) == 60 + 3 + 2 + 1 and kinds.count("symlink") == 4
    assert kinds.count("dir") == 4 + 2
    assert {r for r, v in state.items() if v[0] == "symlink"
            and (tmp_path / "a" / r).is_dir()} == {"dlink0", "dlink1"}
    small = [files[r] for r in made["small"]]
    assert all(1 <= v[3] <= 8192 for v in small)
    assert len(small) - len({v[4] for v in small}) == 60 // 20
    assert sum(v[3] == 0 for v in files.values()) == 3
    assert all(40_000 <= files[r][3] <= 90_000 for r in made["mid"])
    assert files["big.bin"][3] == 300_000 + 12345
    assert [list((tmp_path / "a" / f"empty{k}").iterdir())
            for k in (0, 1)] == [[], []]
    chip_smoke.make_rclone_tree(tmp_path / "b", SMALL_RCLONE, 4)
    strip = {r: v[:2] + v[3:5] if v[0] == "file" else v[:2]
             for r, v in state.items()}
    assert strip == {r: v[:2] + v[3:5] if v[0] == "file" else v[:2]
                     for r, v in chip_smoke.rclone_state(
                         tmp_path / "b").items()}


@pytest.mark.parametrize("sizes,want", [
    ([(256 << 20) + 12345], (0, 1, 9)),
    ([32 << 20], (0, 1, 1)),
    ([(32 << 20) + 4095], (0, 1, 1)),
    ([(32 << 20) + 4096], (0, 1, 2)),
    ([100, 0, 4095, 16 << 20], (1, 0, 0)),
    ([12 << 20] * 5 + [4 << 20, 1], (2, 0, 0)),
    ([], (0, 0, 0)),
])
def test_rclone_hashing_counts_streamed_segments(sizes, want):
    """K1 launches a streamed file (over 16 MiB here): one a 32 MiB
    segment that holds a full page (a 256 MiB + 12,345 B file: eight
    and its last 12,345 bytes); a batch flushes once it holds 64 MiB and
    at the end."""
    got = chip_smoke.rclone_hashing(sizes, 64 << 20, 16 << 20)
    flushes, streamed, pages = want
    assert (got["flushes"], got["streamed"]) == (flushes, streamed)
    assert got["launches"] == {"sha256_pages": flushes + pages,
                               "sha256_slices": flushes,
                               "merkle_roots": flushes}


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_rclone_flush_predictor_follows_hash_files(pkg, tmp_path,
                                                   monkeypatch):
    """The predicted flushes and streamed files are those of each
    package's ``hash_files`` batching rule (its ``hash_spans`` and
    ``hash_file_streaming`` stubbed and counted), in walk order, with the
    batch and stream limits cut to the small tree."""
    if pkg == "ref":
        from volsync_tpu.movers.rclone import sync
    else:
        from volsync_tpu_torch.movers.rclone import sync
    root = tmp_path / "t"
    chip_smoke.make_rclone_tree(root, SMALL_RCLONE, 8)
    monkeypatch.setattr(sync, "_BATCH_BYTES", 20_000)
    monkeypatch.setattr(sync, "_STREAM_THRESHOLD", 200_000)
    flushes, streamed = [], []
    monkeypatch.setattr(sync, "hash_spans", lambda buf, spans, **kw: (
        flushes.append(len(spans)) or ["0" * 64] * len(spans)))
    monkeypatch.setattr(sync, "hash_file_streaming", lambda p, **kw: (
        streamed.append(p) or "0" * 64))
    rels = [r for r, _ in chip_smoke.rclone_walk_files(root)]
    sync.hash_files(root, rels, **({"device": "cpu"} if pkg == "port"
                                   else {}))
    got = chip_smoke.rclone_hashed(root, None, 20_000, 200_000)
    assert (got["flushes"], got["streamed"]) == (len(flushes), len(streamed))
    assert len(flushes) > 3 and streamed == [root / "big.bin"]
    assert [r for r, _ in chip_smoke.rclone_walk_files(root)] == [
        r for r, e in sync.scan_tree(root).items() if e["type"] == "file"]
    assert (chip_smoke.RCLONE_PER_FLUSH, sync.DEFAULT_TRANSFERS) == (
        chip_smoke.VERIFY_PER_PASS, chip_smoke.RCLONE_TRANSFERS)


def test_rclone_segment_is_hash_file_streamings():
    import inspect

    from volsync_tpu_torch.engine import chunker
    from volsync_tpu_torch.movers.rclone import sync

    seg = inspect.signature(chunker.hash_file_streaming).parameters[
        "segment_size"].default
    assert seg == chip_smoke.RCLONE_SEGMENT
    assert (sync._BATCH_BYTES, sync._STREAM_THRESHOLD) == (64 << 20,
                                                           256 << 20)


def test_rclone_stats_predictors():
    """The stats predicted from two tree states: distinct contents
    upload once, objects no longer held are deleted, an index shard is
    written where any of its paths changed, and a sync down skips the
    files of equal size and content and deletes what the bucket
    lacks."""
    meta = (0, 0, ())
    old = {"a": ("dir", 0o755, 1) + meta,
           "a/x": ("file", 0o644, 1, 3, "h1") + meta,
           "a/y": ("file", 0o644, 1, 3, "h1") + meta,
           "b": ("dir", 0o755, 1) + meta,
           "b/z": ("file", 0o644, 1, 5, "h2") + meta,
           "l": ("symlink", "a/x") + meta}
    up = chip_smoke.predict_up(None, old)
    shards = {chip_smoke.rclone_shard_of(r) for r in old}
    assert up == {"files": 3, "uploaded": 2, "deduped": 1,
                  "deleted_objects": 0, "index_shards": len(shards),
                  "index_shards_written": len(shards), "bytes": 11}
    new = dict(old)
    new["b/z"] = ("file", 0o600, 1, 5, "h2") + meta  # chmod only
    del new["a/y"]
    new["a/x"] = ("file", 0o644, 2, 3, "h3") + meta  # rewritten
    up2 = chip_smoke.predict_up(old, new)
    changed = {chip_smoke.rclone_shard_of(r) for r in ("b/z", "a/x")}
    assert up2 == {"files": 2, "uploaded": 1, "deduped": 1,
                   "deleted_objects": 1, "index_shards": len(shards),
                   "index_shards_written": len(changed), "bytes": 8}
    assert chip_smoke.predict_down(None, new) == {
        "files": 2, "fetched": 2, "skipped": 0, "deleted_local": 0,
        "bytes": 8}
    assert chip_smoke.predict_down(old, new) == {
        "files": 2, "fetched": 1, "skipped": 1, "deleted_local": 1,
        "bytes": 8}
    from volsync_tpu.movers.rclone.sync import _shard_of

    assert all(chip_smoke.rclone_shard_of(r) == _shard_of(r)
               for r in ("a", "a/x", "x/y/z", ""))


def test_rclone_phase_on_cpu(monkeypatch, tmp_path):
    """The rclone phase on a small tree with the twins: up, down, the
    edits, up2 and down2 through ``rclone_entrypoint`` and the port's
    fake S3, each held to its predicted stats and flushes, the index to
    hashlib's blob ids and the destinations to the source."""
    from volsync_tpu_torch.movers.rclone import sync

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(sync, "_BATCH_BYTES", 150_000)
    monkeypatch.setattr(sync, "_STREAM_THRESHOLD", 256 * 1024)
    res = chip_smoke.rclone_phase(torch, tmp_path, SMALL_RCLONE, 3, "cpu")
    assert res["up"]["stats"]["uploaded"] == res["up"]["stats"]["files"] - 5
    assert res["up"]["flushes"] > 1 and res["up"]["streamed"] == 1
    assert (res["down"]["flushes"], res["down"]["streamed"]) == (0, 0)
    assert res["down2"]["streamed"] == 1
    assert res["down2"]["stats"]["deleted_local"] == res["edits"]["deleted"]
    assert "rclone.meta" in res["down2"]["spans"]
    assert res["up"]["verbs"]["PUT"] >= res["up"]["stats"]["uploaded"]
    for run in ("up", "down", "up2", "down2"):
        assert res[run]["busy_s"] is None and res[run]["gibs"] > 0


# -- the service phase -----------------------------------------------------------

def test_service_phase_on_cpu(monkeypatch):
    """The service phase at four sources of 64 KiB less
    ``SERVICE_SHORT`` in two tenants (the test chunker, 16 KiB server
    segments, one segment a source): both rounds, every stream against
    the unbatched hasher, Info, HashSpans in pieces, the breaker shed
    and the armed round, whose streams cross the segment cut; then the
    batched-shape kernel entries at 2 lanes, each equal to its twin and
    each lane carrying a tail."""
    from volsync_tpu_torch.ops import gearcdc

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(gearcdc, "DEFAULT_PARAMS", PARAMS)
    # a 16 KiB segment cuts at 80 KiB (with max_size): one segment a
    # source, two an armed stream
    monkeypatch.setattr(chip_smoke, "SERVICE_SEGMENT_KIB", 16)
    monkeypatch.setattr(chip_smoke, "SERVICE_LOCKCHECK_TENANTS",
                        "gold:4:2;bronze:1:2")
    monkeypatch.setattr(chip_smoke, "SERVICE_LOCKCHECK_MIB", 1 / 8)
    monkeypatch.setattr(chip_smoke, "SPANS_LEN", 16 * 1024)
    # the card's 2 ms window is too short for the CPU's thread starts to
    # coalesce reliably (the round refuses a batched round that did not)
    real = chip_smoke.service_round
    monkeypatch.setattr(
        chip_smoke, "service_round",
        lambda torch, label, tenants, mib, window_ms, seed, **kw: real(
            torch, label, tenants, mib, window_ms and 200.0, seed, **kw))
    res = chip_smoke.service_phase(torch, 3, "gold:4:2;bronze:1:2",
                                   1 / 16, "cpu")
    batched, per_request = res["batched"], res["per_request"]
    assert batched["requests_total"] == per_request["requests_total"] == 4
    assert batched["passes"] < batched["lanes"] == 4
    assert per_request["passes"] == per_request["lanes"] == 4
    assert set(batched["admitted_by_tenant"]) == {"gold", "bronze"}
    assert res["breaker"]["direct_shed_p99_ms"] < 10
    assert res["armed"]["streams"] == 4
    assert res["armed"]["segments"] >= 2 * res["armed"]["streams"]
    stats = chip_smoke.new_stats()
    shapes = batched["pass_shapes"]
    S, P = max(shapes, key=lambda sp: (sp[0] * shapes[sp], sp))
    assert P == 64 * 1024
    chip_smoke.batched_kernel_entries(
        torch, stats, res["base"], [(2, P)],
        {"l2_ns": 500.0, "shared_ns": 30.0}, None)
    for name in chip_smoke.BATCHED.values():
        st = stats[name]
        assert st["err"] == 0 and st["bound"][0] > 0 and st["bound_by"]
        assert set(st["shapes"]) == {f"2x{P}"}


# -- the lone-stream turns' prefix, the fleet and syncthing phases ----------------

@pytest.mark.parametrize("blocks,cut", [(3, 256 * 1024 + 12345),
                                        (3, 100_000), (2, 0)])
def test_stream_prefix_chunks_equal_a_pass_over_the_prefix(monkeypatch,
                                                           blocks, cut):
    """``--turns-gib``'s stream is the first bytes of the fused stream:
    the chunks ``prefix_chunks`` derives from the whole stream's equal a
    pass over the prefix alone (0: the prefix is the whole stream)."""
    stream = _tiny_stream(monkeypatch, blocks)
    hasher = chip_smoke.engine_hasher(PARAMS)
    whole, _, _ = chip_smoke.stream_once(torch, stream, PARAMS, hasher)
    prefix = chip_smoke.stream_prefix(stream, cut or stream.total + 1)
    got, _, _ = chip_smoke.stream_once(torch, prefix, PARAMS, hasher)
    assert got == chip_smoke.prefix_chunks(whole, prefix)
    assert (prefix is stream) == (cut == 0)
    assert sum(n for _, n, _ in got) == prefix.total


SMALL_CHUNKER = {"min_size": 4096, "avg_size": 32768, "max_size": 65536,
                 "seed": 7, "align": 4096}


def test_fleet_tree_maker_and_oracle(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "SMALL_FILES", 5)
    shared = np.random.default_rng(1).bytes(50_000)
    made = [chip_smoke.make_fleet_tree(tmp_path / f"j{j}", 120_000 - 12345,
                                       2 + j, shared, 4096)
            for j in range(2)]
    for j, m in enumerate(made):
        root = tmp_path / f"j{j}"
        files = [p for p in root.rglob("*") if p.is_file()]
        inodes = {p.stat().st_ino: p.stat().st_size for p in files}
        assert sum(inodes.values()) == m["bytes"] == 120_000 - 12345
        assert (root / "big.bin").read_bytes() == shared
        assert (root / "nested" / "deeper" / "link.bin").stat().st_ino \
            == (root / "odd.bin").stat().st_ino
        assert sum(m["files"].values()) == m["bytes"]
    # the shared half counts once across the jobs
    both = {**made[0]["files"], **made[1]["files"]}
    assert sum(both.values()) == 2 * made[0]["bytes"] - len(shared)


def test_fleet_phase_on_cpu(monkeypatch, tmp_path):
    """The fleet phase with the twins at three jobs of ~100 KB on one
    thread (the test chunker): both rounds (r00's store crashing on its
    second data put, r00 killed, the job failed over; the GC's cycles;
    the stale locks taken over, the zombie fenced and refused; the
    dedup oracle; check, one restore a replica, repair of r00's stamp),
    then the maintenance verbs (the subprocess's scrub here in process
    on the CPU): scrub 0, repack 0, and scrub 2 with one unhealable pack
    once a pack rots."""
    from volsync_tpu_torch import cli
    from volsync_tpu_torch.repo import repository

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(repository, "DEFAULT_CHUNKER", SMALL_CHUNKER)
    monkeypatch.setattr(chip_smoke, "SMALL_FILES", 4)
    monkeypatch.setattr(chip_smoke, "FLEET_JOBS", 3)
    monkeypatch.setattr(chip_smoke, "FLEET_THREADS", 1)
    monkeypatch.setattr(chip_smoke, "FLEET_PRE", (2, 60_000))
    calls = []

    def in_process(root, argv):
        lines = []
        rc = cli.main([argv[0], str(root), "--password",
                       chip_smoke.FLEET_PASSWORD, "--json", *argv[1:]],
                      out=lines.append, device="cpu")
        calls.append((argv[0], rc))
        return rc, json.loads("\n".join(lines)), 0.0

    monkeypatch.setattr(chip_smoke, "fleet_cli", in_process)
    res = chip_smoke.fleet_phase(torch, tmp_path, 100_000 - 12345, 5, "cpu")
    for k in ("batched", "unbatched"):
        r = res[k]
        assert r["failovers"] >= 1 and r["gc"].get("ok", 0) >= 1
        assert r["passes"] == r["segments"] > 0 and r["busy_s"] is None
        assert 0.5 < r["dedup"] < 0.7
        assert sum(r["by_replica"].values()) == 3
    # check, restores and repair run in the batched round
    assert len(res["batched"]["restores"]) >= 2
    assert res["batched"]["check"]["out"] == []
    assert "restores" not in res["unbatched"]
    assert calls == [("scrub", 0)]  # the subprocess's stand-in
    repair = res["batched"]["repair"]  # the repair verb after the crash
    assert repair["dry_run"]["rc"] == repair["apply"]["rc"] == 0
    assert repair["dry_run"]["report"]["applied"] is False
    assert "fleet/r00" in repair["apply"]["report"]["stale_markers"]
    assert "error" not in res["batched"]["gc"]
    assert res["cli"]["repack"]["rc"] == 0
    assert res["cli"]["scrub_rotted"]["rc"] == 2
    assert res["cli"]["scrub_rotted"]["report"]["unhealable"] == 1


def test_syncthing_phase_on_cpu(monkeypatch, tmp_path):
    """The syncthing phase with the twins on a folder of two small
    files, a mid file and one above a 64 KiB streaming cut: A to B and
    C, the unknown device, the idle rescans, B's edits back to A and C,
    and the conflict settled by (version, device id) after a restart,
    each run's hashing counted against the files hashed."""
    from volsync_tpu_torch.movers.syncthing import entry

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(entry, "_STREAM_ABOVE", 64 * 1024)
    layout = {**chip_smoke.ST_LAYOUT, "small": 2, "small_max": 16 << 10,
              "dirs": 2, "n_mid": 1, "mid_min": 20 << 10,
              "mid_max": 40 << 10, "big": 70_000 + 12345}
    res = chip_smoke.syncthing_phase(torch, tmp_path, layout, 5, "cpu")
    init = res["initial"]
    # A hashes its five files; B and C pull all five and verify the four
    # with bytes (an empty file's digest is "")
    assert init["hashed"] == 5 + 2 * 4 and init["pulled"] == 2 * 5
    assert init["busy_s"] is None and init["host"]["hash"] > 0
    assert res["edits_made"] == {"rewrite": 1, "delete": 1, "added": 1,
                                 "turned": 1}
    assert res["conflict"]["pulled"] >= 2  # B may take both versions


def test_root_shape_entries_on_cpu(monkeypatch):
    """merkle_roots' other callers' shapes (batched passes, more live
    lanes than sub-partitions, the span form, the mesh's page-major
    table, a zero-entropy segment, no live lane, nb_max below a lane's
    blocks) at a tiny size: each held against its twin (those with a
    live lane through one twin call over their stacked page-major
    tables) or hashlib, each reported with its bounds."""
    from volsync_tpu_torch.tools import time_root_calls as trc

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(trc, "SEGMENT", 2 << 20)
    monkeypatch.setattr(trc, "LANE", 128 * 1024)
    monkeypatch.setattr(trc, "SPAN_BYTES", 2 << 20)
    monkeypatch.setattr(trc, "ZERO_LEAVES", 40)
    # the span and mesh lanes' lengths: short, so the twins stay quick
    monkeypatch.setattr(trc, "chunk_lengths", lambda args: [70_000, 150_000])
    stats = chip_smoke.new_stats()
    chip_smoke.root_shape_entries(torch, stats, 3, 4.6)
    shapes = stats["merkle_roots"]["shapes"]
    assert set(shapes) == {*chip_smoke.ROOT_SHAPES, "clamp"}
    assert stats["merkle_roots"]["err"] == 0
    assert shapes["dead"]["live"] == 0 and shapes["dead"]["longest"] == 0
    assert shapes["mesh"]["pagemajor"] and not shapes["verify"]["pagemajor"]
    assert shapes["clamp"]["nb_max"] == chip_smoke.ROOT_CLAMP
    for name in ("batched8", "batched16", "lanes32", "verify", "mesh",
                 "zero", "clamp"):
        r = shapes[name]
        assert r["live"] > 0 and r["bound_ms"] == max(r["issue_ms"],
                                                      r["chain_ms"])


def test_root_union_keeps_each_shapes_digests():
    """One twin call over two shapes' lanes, a word-major and a
    page-major table stacked page-major, gives each shape's own
    digests."""
    rng = np.random.RandomState(7)

    def shape(npp, pagemajor, lanes):
        flat = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, size=8 * npp)
                                .astype(np.int32))
        p0, nl, ln = (torch.tensor(c, dtype=torch.int64)
                      for c in zip(*lanes))
        return ((flat, npp, p0, nl, ln, nl > 0),
                dict(nb_max=seg._root_blocks_bound(int(ln.max())),
                     pagemajor=pagemajor))

    shapes = {"wm": shape(12, False, [(0, 3, 12000), (4, 0, 0),
                                      (5, 7, 27000)]),
              "pm": shape(9, True, [(1, 8, 32768), (0, 1, 5)])}
    args, kw, rows = chip_smoke.root_union(torch, shapes)
    both = seg._root_digests_plain(*args, **kw)
    for name, (a, k) in shapes.items():
        first, n = rows[name]
        assert torch.equal(both[first:first + n],
                           seg._root_digests_plain(*a, **k))
