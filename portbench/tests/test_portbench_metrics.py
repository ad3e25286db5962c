"""Each metric's arithmetic on fixed inputs."""

import pytest

from portbench import run, spec
from portbench.devtrace import DeviceTrace, busy_union, idle_gaps
from portbench.loads import restic_sync
from portbench.kernels import sha256


def _run(spans=None, inputs=None, ops=None, window_s=None, card=None):
    tr = DeviceTrace(on=False)
    tr.ops = ops or []
    tr.window_s = window_s
    return run.Run(spans=spans or {}, inputs=inputs or {}, trace=tr,
                   card=card or {})


def _metric(name):
    return spec.load_module("metrics", name).read


def test_sync_rates_are_over_all_syncs_and_their_walls():
    d = restic_sync.Load.__new__(restic_sync.Load)
    d.pvc_bytes = 1 << 30
    d.syncs = [{"wall": 1.0, "added": 1 << 20, "rc": 0},
               {"wall": 3.0, "added": 3 << 20, "rc": 0}]
    e2e = d.end_to_end()
    assert e2e["sync_gib_s"] == pytest.approx(2 / 4.0)
    assert e2e["sync_bytes_ratio"] == pytest.approx(4 / 2048)


@pytest.mark.parametrize("length,blocks", [
    (4096, 65 + 1),            # one full leaf; its root 13 + 32 + 9 bytes
    (4097, 65 + 1 + 2),        # a one-byte tail leaf; a root of 2 leaves
    (4096 + 55, 65 + 1 + 2),   # 55 + 9 fit one block
    (4096 + 56, 65 + 2 + 2),   # 56 + 9 do not
    (0, 1 + 1),                # the empty blob: one empty leaf, its root
    (1 << 20, 256 * 65 + 129),  # 256 leaves: 13 + 8192 + 9 bytes -> 129
])
def test_sha_blocks_for_known_lengths(length, blocks):
    full = length // 4096
    ops, nbytes = sha256.chunk_work(length)
    pad_saving = full * (sha256.OPS_BLOCK - sha256.OPS_CONST_SCHEDULE_BLOCK)
    assert ops == blocks * sha256.OPS_BLOCK - pad_saving
    assert nbytes == length + 32
    assert sha256.OPS_BLOCK == 1024


def test_idle_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert busy_union(iv) == 25
    assert idle_gaps(iv, 0, 40) == [(15, 20), (30, 40)]
    read = _metric("device_idle_pct.sync")
    ops = [("k", a * 10 ** 8, b * 10 ** 8) for a, b in iv]
    assert read(_run(ops=ops, window_s=10.0)) == pytest.approx(75.0)
    assert read(_run(window_s=10.0)) is None


def test_roofline_is_the_floor_over_family_time():
    lengths = [1 << 20] * 4
    ops, nbytes = sha256.work(lengths)
    card = {"sms": 132, "max_sm_hz": 1.98e9}
    floor = max(ops / (132 * 64 * 1.98e9), nbytes / 3.35e12)
    kernel_ns = 2 * floor * 1e9
    trace_ops = [("void sha256_pages_kernel<false>(...)", 0,
                  int(kernel_ns / 2)),
                 ("void merkle_roots_kernel<false, false>(...)", 0,
                  int(kernel_ns / 2)),
                 ("Memcpy HtoD (Pageable -> Device)", 0, 10 ** 9)]
    got = _metric("sha256_roofline.sync")(
        _run(inputs={"chunk_lengths": lengths}, ops=trace_ops, card=card))
    assert got == pytest.approx(50.0, rel=1e-3)
    assert _metric("sha256_roofline.sync")(
        _run(inputs={"chunk_lengths": lengths}, card=card)) is None


@pytest.mark.parametrize("name,span,key", [
    ("engine_s_per_gib.sync", "engine.device", "pvc_gib"),
    ("seal_s_per_gib.sync", "repo.seal", "pvc_gib"),
    ("upload_s_per_gib.sync", "repo.pack_upload", "pvc_gib"),
])
def test_span_readers(name, span, key):
    read = _metric(name)
    assert read(_run(spans={span: 3.0, "other": 9.0},
                     inputs={key: 2.0})) == pytest.approx(1.5)
    assert read(_run(spans={"other": 9.0}, inputs={key: 2.0})) is None


def test_engine_reader_sums_every_engine_span():
    read = _metric("engine_s_per_gib.sync")
    spans = {"engine.read": 1.0, "engine.fused_dispatch": 2.0, "repo.seal": 5}
    assert read(_run(spans=spans, inputs={"pvc_gib": 1.5})) == \
        pytest.approx(2.0)


def test_stored_per_new_byte():
    read = _metric("stored_per_new_byte.sync")
    assert read(_run(inputs={"added_bytes": 3, "new_data_bytes": 4})) == \
        pytest.approx(0.75)
    assert read(_run(inputs={"added_bytes": 3, "new_data_bytes": 0})) is None


def test_a_reader_serves_every_suffix_of_its_name(tmp_path):
    """``x.sync`` and ``x.service`` both find ``x.py``; ``x.sync.py``,
    where it exists, wins for ``x.sync``."""
    assert spec.load_module("metrics", "device_idle_pct.sync") is \
        spec.load_module("metrics", "device_idle_pct.service")
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "x.py").write_text("WHICH = 'x'\n")
    (tmp_path / "metrics" / "x.sync.py").write_text("WHICH = 'x.sync'\n")
    assert spec.load_module("metrics", "x.sync", root=tmp_path).WHICH == \
        "x.sync"
    assert spec.load_module("metrics", "x.service", root=tmp_path).WHICH == \
        "x"
    with pytest.raises(KeyError):
        spec.load_module("metrics", "y.sync", root=tmp_path)


def test_forbidden_modules_compare_top_level_names_whole():
    mods = ["volsync_tpu_torch", "volsync_tpu_torch.ops", "jaxtyping",
            "volsync_tpu.ops", "jax", "flax.linen", "numpy"]
    assert run.forbidden_modules(mods) == ["flax.linen", "jax",
                                           "volsync_tpu.ops"]

