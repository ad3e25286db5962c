"""The port's VL5xx buffer-provenance analyzer, host half
(``volsync_tpu_torch/analysis/bufflow.py``), holds the VL503, VL505 and
VL106-bridge cases of ``tests/test_analysis_buf.py``: pooled copies with
two-hop interprocedural hop chains next to a ledgered twin, ledger <->
sanction drift, the per-file VL106 bridge, each rule's findings on the
fixture package equal to the reference analyzer's, finding spans, SARIF
regions, rule selection, the cached "buf" fact kind and the provenance
export — and the bridge law on the port: every copy site the armed
runtime ledger records during a pipelined backup and restore by the port
(on the CPU) is one the static analyzer proved sanctioned over
``volsync_tpu_torch``."""

import functools
import json
import re
import shutil
from pathlib import Path

import numpy as np
import torch

import volsync_tpu_torch
from volsync_tpu.analysis import run_project as j_run_project
from volsync_tpu.analysis.bufflow import sanctioned_lines as j_sanctioned_lines
from volsync_tpu_torch.analysis import run_project
from volsync_tpu_torch.analysis.bufflow import (
    sanction_sites_for_paths,
    sanctioned_lines,
)
from volsync_tpu_torch.analysis.cli import main as lint_main

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "analysis_fixtures"
MINIPROJ = FIXTURES / "miniproj"
BUF = MINIPROJ / "buf"
LEDGER = MINIPROJ / "obs" / "copyledger.py"
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


# -- VL503: unledgered pooled copies -----------------------------------------

def test_vl503_direct_copy_vs_ledgered():
    found = _findings("VL503", "buf/pool.py")
    pool = BUF / "pool.py"
    assert len(found) == 1
    f = found[0]
    assert f.line == _mark_line(pool, "copy-bytes")
    assert "pooled-provenance" in f.message
    assert "acquire()" in f.message
    # the same copy one MARK down is record_copy-adjacent: silent
    assert f.line != _mark_line(pool, "copy-ledgered")


def test_vl503_two_hop_interprocedural_chain():
    """The pooled buffer is acquired in pool.ship, memoryview'd, passed
    through relay() into finish(), and materialized there — the finding
    lands at the .tobytes() and its hop chain names every hop."""
    found = _findings("VL503", "buf/helpers.py")
    helpers, pool = BUF / "helpers.py", BUF / "pool.py"
    assert len(found) == 1
    f = found[0]
    assert f.line == _mark_line(helpers, "twohop-mat")
    assert "mview-provenance" in f.message
    msg = f.message
    assert f"pool.py:{_mark_line(pool, 'twohop-acquire')}" in msg
    assert f"passed to relay() at" in msg
    assert f"pool.py:{_mark_line(pool, 'twohop-entry')}" in msg
    assert f"passed to finish() at" in msg
    assert f"helpers.py:{_mark_line(helpers, 'twohop-relay')}" in msg
    assert ".tobytes()" in msg


# -- VL505: ledger <-> sanction drift ----------------------------------------

def test_vl505_rogue_nonliteral_and_dead_site():
    rogue = _findings("VL505", "buf/ledger_use.py")
    use = BUF / "ledger_use.py"
    by_line = {f.line: f for f in rogue}
    assert set(by_line) == {_mark_line(use, "rogue-site"),
                            _mark_line(use, "nonliteral-site")}
    assert "'fix.rogue' is not in" in by_line[
        _mark_line(use, "rogue-site")].message
    assert "not a string literal" in by_line[
        _mark_line(use, "nonliteral-site")].message
    dead = _findings("VL505", "obs/copyledger.py")
    assert len(dead) == 1
    assert dead[0].line == _mark_line(LEDGER, "unused-site")
    assert "'fix.unused' has no record_copy call site" in dead[0].message


def test_vl106_bridge_sanctioned_lines():
    """The per-file VL106 bridge: lines whose statements sit next to a
    sanctioned record_copy are semantically ledgered."""
    import ast
    tree = ast.parse((BUF / "pool.py").read_text())
    lines = sanctioned_lines(tree, frozenset({"fix.ingest"}))
    assert lines == j_sanctioned_lines(tree, frozenset({"fix.ingest"}))
    assert _mark_line(BUF / "pool.py", "copy-ledgered") in lines
    assert _mark_line(BUF / "pool.py", "copy-bytes") not in lines


# -- finding mechanics -------------------------------------------------------

def test_vl5_findings_carry_source_spans():
    for f in (_findings("VL503", "buf/pool.py")
              + _findings("VL503", "buf/helpers.py")
              + _findings("VL505", "buf/ledger_use.py")):
        assert f.col > 0
        assert f.end_line >= f.line
        assert f.end_col > 0


def test_cli_select_vl5_only():
    lines: list = []
    rc = lint_main(["--no-baseline", "--select", "VL5", str(MINIPROJ)],
                   out=lines.append)
    assert rc == 1
    finding_lines = [s for s in lines if " VL" in s]
    assert finding_lines
    assert all(" VL5" in s for s in finding_lines)


def test_sarif_has_vl5_catalogue_and_regions(tmp_path):
    out = tmp_path / "buf.sarif"
    rc = lint_main(["--no-baseline", "--select", "VL5", "--format",
                    "sarif", "--out", str(out), str(MINIPROJ)],
                   out=lambda *_: None)
    assert rc == 1
    doc = json.loads(out.read_text())
    run = doc["runs"][0]
    rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert rule_ids == {"VL501", "VL502", "VL503", "VL504", "VL505"}
    regions = [r["locations"][0]["physicalLocation"]["region"]
               for r in run["results"]]
    assert regions
    assert all(reg["startLine"] >= 1 and "startColumn" in reg
               and reg["endLine"] >= reg["startLine"]
               for reg in regions)


# -- cached buffer facts -----------------------------------------------------

def test_buf_facts_cached_and_invalidated(tmp_path):
    """Warm cache re-analyzes ZERO files and replays VL5 findings
    verbatim; editing the summary-feeding helper kills the two-hop
    finding (helper + its importer re-derived), and reverting the edit
    re-surfaces it at the same line."""
    proj = tmp_path / "miniproj"
    shutil.copytree(MINIPROJ, proj)
    cache = tmp_path / ".lint-cache"

    def vl5(res):
        return sorted((f.path, f.line, f.code, f.message)
                      for f in res.findings if f.code.startswith("VL5"))

    cold = run_project([str(tmp_path)], cache_path=cache)
    assert cold.errors == []
    cold_vl5 = vl5(cold)
    assert cold_vl5

    # the cache rows carry the new "buf" fact kind
    raw = json.loads(cache.read_text())
    assert any(row.get("buf") for row in raw["files"].values())

    warm = run_project([str(tmp_path)], cache_path=cache)
    assert warm.analyzed == []
    assert vl5(warm) == cold_vl5

    helpers = proj / "buf" / "helpers.py"
    original = helpers.read_text()
    helpers.write_text(original.replace(
        "return finish(chunk)  # MARK: twohop-relay",
        "return len(chunk)  # MARK: twohop-relay"))
    edited = run_project([str(tmp_path)], cache_path=cache)
    assert helpers.as_posix() in edited.analyzed
    assert not any(f.path == helpers.as_posix() and f.code == "VL503"
                   for f in edited.findings)

    helpers.write_text(original)
    restored = run_project([str(tmp_path)], cache_path=cache)
    assert helpers.as_posix() in restored.analyzed
    assert vl5(restored) == cold_vl5


# -- provenance export -------------------------------------------------------

def test_dump_provenance_cli(tmp_path):
    out = tmp_path / "prov.json"
    lines: list = []
    rc = lint_main(["--no-baseline", "--select", "VL5",
                    "--dump-provenance", str(out), str(MINIPROJ)],
                   out=lines.append)
    assert rc == 1  # the fixtures ARE findings; the dump still lands
    doc = json.loads(out.read_text())
    assert set(doc) == {"sanctioned_sites", "nodes", "edges"}
    pool = BUF / "pool.py"
    assert any(s.endswith(f"buf/pool.py:{_mark_line(pool, 'copy-ledgered') + 1}")
               for s in doc["sanctioned_sites"]["fix.ingest"])
    nodes = {n["fn"]: n for n in doc["nodes"]}
    assert nodes["miniproj.buf.pool.window"]["returns"] == "mview"
    assert nodes["miniproj.buf.pool.ledgered"]["sanctions"] == ["fix.ingest"]
    finish = [e for e in doc["edges"]
              if e["to"] == "miniproj.buf.helpers.finish"]
    assert len(finish) == 1
    assert finish[0]["prov"] == "mview"
    assert any("passed to finish()" in hop for hop in finish[0]["via"])
    assert any(str(out) in s for s in lines)


def test_static_sanction_sites_cover_whole_ledger():
    """The ledger's acceptance fact, statically: every site in the
    package's SANCTIONED_SITES has a proven record_copy call site and
    no record_copy calls a site outside the frozenset (VL505 keeps
    this equality; the bridge test below checks the runtime half)."""
    from volsync_tpu_torch.obs.copyledger import SANCTIONED_SITES
    static = sanction_sites_for_paths([str(PKG)])
    assert set(static) == set(SANCTIONED_SITES)
    assert all(static[site] for site in static)


# -- runtime ⊆ static --------------------------------------------------------

def test_runtime_copies_subset_of_static(tmp_path):
    """The bridge between the ledgers: run the port's pipelined backup and
    restore with the copy ledger armed, then check every site the
    runtime RECORDED is one the static analyzer PROVED sanctioned. A
    runtime site with no static cover means record_copy grew a call
    path the analyzer lost — this test is the canary."""
    from volsync_tpu_torch.engine.backup import TreeBackup
    from volsync_tpu_torch.engine.restore import restore_snapshot
    from volsync_tpu_torch.obs import copyledger
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.repo.repository import Repository

    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.RandomState(7)
    for i in range(4):
        (src / f"f{i}.bin").write_bytes(rng.bytes(200_000 + i * 33_000))

    copyledger.reset_copies()
    fs = FsObjectStore(str(tmp_path / "store"))
    repo = Repository.init(fs, device="cpu", chunker={
        "min_size": 32 * 1024, "avg_size": 64 * 1024,
        "max_size": 128 * 1024, "seed": 7})
    repo.pipelined = True
    TreeBackup(repo, workers=2, device="cpu").run(src)
    dst = tmp_path / "dst"
    restore_snapshot(Repository.open(fs, device="cpu"), dst, device="cpu")
    for i in range(4):
        assert (dst / f"f{i}.bin").read_bytes() == \
            (src / f"f{i}.bin").read_bytes()

    observed = set(copyledger.copies_by_site())
    assert observed, "armed pipelined run recorded no copy sites"
    static = set(sanction_sites_for_paths([str(PKG)]))
    assert observed <= static, (
        f"runtime copy sites with no static sanction cover: "
        f"{sorted(observed - static)}")
    assert observed <= set(copyledger.SANCTIONED_SITES)
