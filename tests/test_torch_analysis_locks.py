"""The port's VL4xx static concurrency analyzer
(``volsync_tpu_torch/analysis/lockflow.py``, ``guards.py``) holds the
cases of ``tests/test_analysis_locks.py``: seeded fixtures per rule next
to clean twins, each family's findings on the fixture package equal to
the reference analyzer's, finding spans, SARIF regions, rule selection,
suppressions, the cached "locks" fact kind, the graph export — and the
bridge law on the port: every acquisition edge the runtime detector
observes in the port's repository is covered by the static VL401 graph
of ``volsync_tpu_torch``. Then the lint's VL005 repair: the kernels'
build and launch-count locks and ``gf_matmul``'s call counter are built
through lockcheck, so an armed run instruments them."""

import functools
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import volsync_tpu_torch
from volsync_tpu.analysis import run_project as j_run_project
from volsync_tpu_torch.analysis import lockcheck, run_project
from volsync_tpu_torch.analysis.cli import main as lint_main
from volsync_tpu_torch.analysis.lockflow import (
    dump_for_paths,
    edge_covered,
    name_matches,
)

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "analysis_fixtures"
MINIPROJ = FIXTURES / "miniproj"
LOCKS = MINIPROJ / "locks"
PKG = Path(volsync_tpu_torch.__file__).resolve().parent


def _mark_line(path: Path, marker: str) -> int:
    for i, line in enumerate(path.read_text().splitlines(), 1):
        if f"MARK: {marker}" in line:
            return i
    raise AssertionError(f"marker {marker!r} not in {path}")


@functools.lru_cache(maxsize=None)
def _runs():
    port, ref = run_project([str(MINIPROJ)]), j_run_project([str(MINIPROJ)])
    assert port.errors == [] and ref.errors == []
    return port, ref


def _rows(findings):
    """Comparable rows; the port words one VL602 aside on the bug class
    without the reference's history, so asides on it are left out."""
    return sorted((f.path, f.line, f.code,
                   re.sub(r" \(the [^)]*bug class\)", "", f.message),
                   f.severity, f.col, f.end_line, f.end_col)
                  for f in findings)


def _findings(code: str, relname: str):
    """The port's ``code`` findings in ``relname``, which must equal the
    reference analyzer's on the same fixture."""
    port, ref = _runs()
    got = [f for f in port.findings
           if f.code == code and f.path.endswith(relname)]
    want = [f for f in ref.findings
            if f.code == code and f.path.endswith(relname)]
    assert _rows(got) == _rows(want)
    return got


# -- VL401: lock-order cycles ---------------------------------------------------

def test_vl401_same_module_cycle():
    found = _findings("VL401", "locks/order.py")
    assert len(found) == 1
    f = found[0]
    assert f.line == _mark_line(LOCKS / "order.py", "ab-edge")
    assert f.severity == "error"
    assert "'fix.order.a' -> 'fix.order.b' -> 'fix.order.a'" in f.message
    assert "`ab()`" in f.message and "`ba()`" in f.message
    assert "fix.order.c" not in f.message


def test_vl401_two_hop_interprocedural_cycle():
    found = _findings("VL401", "locks/order_a.py")
    assert len(found) == 1
    f = found[0]
    assert f.line == _mark_line(LOCKS / "order_a.py", "hop-out")
    msg = f.message
    assert ("via `hold_first_call_out()` -> `step_out()` -> "
            "`grab_second()`") in msg
    assert ("via `hold_second_call_back()` -> `relay()` -> "
            "`grab_first()`") in msg
    back_line = _mark_line(LOCKS / "order_b.py", "hop-back")
    assert f"locks/order_b.py:{back_line}" in msg


# -- VL402: guarded-field inference ---------------------------------------------

def test_vl402_majority_guard_flags_unguarded_thread_path():
    by_line = {f.line: f for f in _findings("VL402", "locks/fields.py")}
    peek = by_line[_mark_line(LOCKS / "fields.py", "unguarded-read")]
    assert peek.severity == "error"
    assert "guarded by 'fix.fields.tally' on 3/5 accesses" in peek.message
    assert "Thread target" in peek.message


def test_vl402_lock_resolved_through_inheritance():
    by_line = {f.line: f for f in _findings("VL402", "locks/fields.py")}
    glance = by_line[_mark_line(LOCKS / "fields.py", "inherited-unguarded")]
    assert "of Meter" in glance.message
    assert "'fix.fields.tally'" in glance.message


def test_vl402_suppression_and_clean_twin():
    found = _findings("VL402", "locks/fields.py")
    src = (LOCKS / "fields.py").read_text().splitlines()
    audit_line = next(i for i, s in enumerate(src, 1)
                      if "ignore[VL402]" in s)
    assert audit_line not in {f.line for f in found}
    assert all("CleanTally" not in f.message for f in found)
    assert len(found) == 2


# -- VL403: check-then-act -------------------------------------------------------

def test_vl403_stale_snapshot_dependent_write():
    found = _findings("VL403", "locks/toctou.py")
    assert len(found) == 1
    f = found[0]
    assert f.line == _mark_line(LOCKS / "toctou.py", "stale-write")
    snap = _mark_line(LOCKS / "toctou.py", "stale-snapshot")
    assert f"snapshot into 'cur' under 'fix.toctou.budget' at line " \
           f"{snap}" in f.message
    assert f.severity == "error"


# -- VL404: unsynchronized publication -------------------------------------------

def test_vl404_thread_seam_publication():
    found = _findings("VL404", "locks/publish.py")
    assert len(found) == 1
    f = found[0]
    assert f.line == _mark_line(LOCKS / "publish.py", "unsynced-dict")
    assert f.severity == "warning"
    assert "'notes' of Board" in f.message
    assert "Board.post()" in f.message and "Board.read()" in f.message


# -- finding mechanics -------------------------------------------------------------

def test_vl4_findings_carry_source_spans():
    for f in (_findings("VL402", "locks/fields.py")
              + _findings("VL404", "locks/publish.py")):
        assert f.col > 0
        assert f.end_line >= f.line
        assert f.end_col > 0


def test_cli_select_vl4_only():
    lines: list = []
    rc = lint_main(["--no-baseline", "--select", "VL4", str(MINIPROJ)],
                   out=lines.append)
    assert rc == 1
    finding_lines = [s for s in lines if " VL" in s]
    assert finding_lines
    assert all(" VL4" in s for s in finding_lines)


def test_sarif_has_vl4_catalogue_and_regions(tmp_path):
    out = tmp_path / "locks.sarif"
    rc = lint_main(["--no-baseline", "--select", "VL4", "--format",
                    "sarif", "--out", str(out), str(MINIPROJ)],
                   out=lambda *_: None)
    assert rc == 1
    run = json.loads(out.read_text())["runs"][0]
    rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert rule_ids == {"VL401", "VL402", "VL403", "VL404"}
    regions = [r["locations"][0]["physicalLocation"]["region"]
               for r in run["results"]]
    assert regions
    assert all(reg["startLine"] >= 1 and "startColumn" in reg
               and reg["endLine"] >= reg["startLine"]
               for reg in regions)


def test_lock_facts_cached_and_invalidated(tmp_path):
    proj = tmp_path / "miniproj"
    shutil.copytree(MINIPROJ, proj)
    cache = tmp_path / ".lint-cache"

    def vl4(res):
        return sorted((f.path, f.line, f.code, f.message)
                      for f in res.findings if f.code.startswith("VL4"))

    cold = run_project([str(tmp_path)], cache_path=cache)
    assert cold.errors == []
    assert vl4(cold)
    raw = json.loads(cache.read_text())
    assert any(row.get("locks") for row in raw["files"].values())

    warm = run_project([str(tmp_path)], cache_path=cache)
    assert warm.analyzed == []
    assert vl4(warm) == vl4(cold)

    order = proj / "locks" / "order.py"
    src = order.read_text()
    start = src.index("def ca_ok():")
    end = src.index("def ca_again_ok():")
    order.write_text(src[:start] + "def ca_ok():\n    with _A:\n"
                     "        with _C:\n            pass\n\n\n" + src[end:])
    edited = run_project([str(tmp_path)], cache_path=cache)
    assert order.as_posix() in edited.analyzed
    new = [f for f in edited.findings
           if f.code == "VL401" and "fix.order.c" in f.message]
    assert len(new) == 1
    assert "'fix.order.a'" in new[0].message


def test_dump_lock_graph_cli(tmp_path):
    out = tmp_path / "graph.json"
    lines: list = []
    rc = lint_main(["--no-baseline", "--select", "VL4",
                    "--dump-lock-graph", str(out), str(MINIPROJ)],
                   out=lines.append)
    assert rc == 1
    doc = json.loads(out.read_text())
    assert set(doc) == {"nodes", "edges"}
    assert "fix.hop.first" in doc["nodes"]
    edges = {(e["from"], e["to"]): e for e in doc["edges"]}
    hop = edges[("fix.hop.first", "fix.hop.second")]
    assert "step_out()" in hop["via"]
    assert hop["site"].endswith(
        f"locks/order_a.py:{_mark_line(LOCKS / 'order_a.py', 'hop-out')}")
    assert any(str(out) in s for s in lines)


def test_static_graph_covers_striping_law():
    """The port's static graph proves the repo.state ->
    repo.index.shard* law without running anything."""
    doc = dump_for_paths([str(PKG)])
    assert "repo.state" in doc["nodes"]
    assert "repo.index.shard*" in doc["nodes"]
    assert any(e["from"] == "repo.state" and e["to"] == "repo.index.shard*"
               for e in doc["edges"])


def test_name_matches_wildcards():
    assert name_matches("repo.index.shard*", "repo.index.shard7")
    assert name_matches("repo.state", "repo.state")
    assert not name_matches("repo.index.shard*", "repo.pools")
    assert not name_matches("repo.state", "repo.staten")


@pytest.fixture
def checked(monkeypatch):
    monkeypatch.setenv("VOLSYNC_TPU_LOCKCHECK", "1")
    lockcheck.reset()
    yield
    lockcheck.reset()


def test_runtime_edges_subset_of_static(checked):
    """Run the port's repository under the runtime detector, then check
    every acquisition edge it observed is covered by an edge the static
    analyzer proved over ``volsync_tpu_torch``."""
    from volsync_tpu_torch.objstore.store import MemObjectStore
    from volsync_tpu_torch.repo import blobid
    from volsync_tpu_torch.repo.repository import Repository

    rng = np.random.RandomState(11)
    repo = Repository.init(MemObjectStore(), device="cpu")
    repo.PACK_TARGET = 16 * 1024
    for data in (rng.bytes(3000) for _ in range(24)):
        repo.add_blob("data", blobid.blob_id(data), data)
    repo.flush()
    repo.load_index()
    assert lockcheck.violations() == []

    observed = lockcheck.graph()
    assert observed, "instrumented run recorded no acquisition edges"
    static = {(e["from"], e["to"])
              for e in dump_for_paths([str(PKG)])["edges"]}
    uncovered = [rt for rt in sorted(observed)
                 if not edge_covered(static, rt)]
    assert uncovered == [], (
        f"runtime acquisition edges with no static cover: {uncovered}")


def test_ops_locks_route_through_lockcheck(checked):
    """The VL005 repair: ``gf_matmul``'s call counter takes its lock from
    lockcheck (an armed run instruments it), and so do the kernels'
    build and launch-count locks (checked on a second, private copy of
    ``ops/_build.py``, so the registry of the loaded one is untouched)."""
    import importlib.util

    from volsync_tpu_torch.ops import rs

    counter = rs.CallCount()
    assert type(counter._lock) is lockcheck._InstrumentedLock
    counter.add()
    assert counter.n == 1
    spec = importlib.util.spec_from_file_location(
        "_build_copy", PKG / "ops" / "_build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    assert type(build._lock) is lockcheck._InstrumentedLock
    assert type(build._count_lock) is lockcheck._InstrumentedLock
