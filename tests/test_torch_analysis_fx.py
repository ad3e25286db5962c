"""The port's VL6xx fault-path analyzer
(``volsync_tpu_torch/analysis/faultflow.py``) holds the cases of
``tests/test_analysis_fx.py``: seeded fixtures per rule next to clean
twins, each rule's findings on the fixture package equal to the
reference analyzer's, finding spans, SARIF regions and severity tiers,
rule selection, suppressions, the cached "fx" fact kind, the
effect-graph export — and the bridge law on the port: every (op, key)
edge a seeded ``FaultStore`` chaos schedule observes during a backup and
restore by the port (on the CPU) is one the static analyzer inferred
over ``volsync_tpu_torch``, and every injected exception type is one the
port's ``classify()`` decides."""

import functools
import json
import re
import shutil
from pathlib import Path

import numpy as np
import torch

import volsync_tpu_torch
from volsync_tpu.analysis import run_project as j_run_project
from volsync_tpu_torch.analysis import run_project
from volsync_tpu_torch.analysis.cli import main as lint_main
from volsync_tpu_torch.analysis.faultflow import (
    static_fault_edges_for_paths,
)

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "analysis_fixtures"
MINIPROJ = FIXTURES / "miniproj"
FX = MINIPROJ / "fx" / "repo"
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


# -- VL601: unprotected network effect ---------------------------------------

def test_vl601_direct_and_hop_chain():
    """A bare ``store.put`` at a call-graph root fires in place; the
    helper-buried effect fires too, its hop chain naming the uncovered
    caller — while the policy-wrapped twin stays silent."""
    found = _findings("VL601", "fx/repo/uploader.py")
    up = FX / "uploader.py"
    by_line = {f.line: f for f in found}
    assert set(by_line) == {_mark_line(up, "vl601-direct"),
                            _mark_line(up, "vl601-hop-effect")}
    direct = by_line[_mark_line(up, "vl601-direct")]
    assert "no retry layer" in direct.message
    assert "SINGLE_ATTEMPT_OPS" in direct.message
    assert direct.severity == "error"
    hop = by_line[_mark_line(up, "vl601-hop-effect")]
    assert "called from mirror_head()" in hop.message
    assert f"uploader.py:{_mark_line(up, 'vl601-hop-call')}" in hop.message


def test_vl601_same_line_suppression():
    """The reviewed ``# lint: ignore[VL601]`` single-shot put reports
    nothing."""
    up = FX / "uploader.py"
    sup_line = next(i for i, s in enumerate(up.read_text().splitlines(), 1)
                    if "lint: ignore[VL601]" in s)
    assert all(f.line != sup_line
               for f in _findings("VL601", "fx/repo/uploader.py"))


# -- VL602: retry stacking ---------------------------------------------------

def test_vl602_two_hop_stacked_chain():
    """A full RetryPolicy over ``_mid`` fires because two hops down,
    ``_fetch``'s boundary-store get already carries its one layer —
    the finding lands at the policy call and the hop chain names the
    intermediate call."""
    found = _findings("VL602", "fx/repo/pusher.py")
    pu = FX / "pusher.py"
    by_line = {f.line: f for f in found}
    assert _mark_line(pu, "vl602-two-hop") in by_line
    f = by_line[_mark_line(pu, "vl602-two-hop")]
    assert "retry stacking" in f.message
    assert "get()" in f.message
    assert "ResilientStore boundary" in f.message
    assert "_fetch() called at" in f.message
    assert f.severity == "error"


def test_vl602_local_double_layer():
    pu = FX / "pusher.py"
    by_line = {f.line: f for f in _findings("VL602", "fx/repo/pusher.py")}
    f = by_line[_mark_line(pu, "vl602-local")]
    assert "two retry layers on one call path" in f.message


def test_vl602_flag_branch_twin_is_clean():
    """The proven-wrap flag branch keeps one layer per arm: the
    bare-arm ``policy.call(restamp)`` is NOT stacking (the branch
    proves the store has no wrap there)."""
    pu = FX / "pusher.py"
    found = _findings("VL602", "fx/repo/pusher.py")
    assert {f.line for f in found} == {_mark_line(pu, "vl602-two-hop"),
                                       _mark_line(pu, "vl602-local")}
    assert _mark_line(pu, "vl602-clean-arm") not in {f.line for f in found}


# -- VL603: exception-taxonomy drift -----------------------------------------

def test_vl603_generic_vs_typed_raise():
    found = _findings("VL603", "fx/repo/errors.py")
    err = FX / "errors.py"
    assert {f.line for f in found} == {_mark_line(err, "vl603-generic")}
    f = found[0]
    assert "raise RuntimeError" in f.message
    assert "classify()" in f.message
    assert f.severity == "warning"


def test_vl603_unknown_and_dead_classify_branches(tmp_path):
    """A classify() referencing a type nothing defines, and a branch
    fully shadowed by an earlier isinstance, both fire against the
    classifier's own decision table."""
    proj = tmp_path / "fx2"
    proj.mkdir()
    (proj / "__init__.py").write_text('"""tmp fixture."""\n')
    (proj / "resilience.py").write_text(
        '"""tmp classify drift fixture."""\n'
        "_RETRIED_OPS = (\"get\",)\n\n\n"
        "class FixError(ValueError):\n"
        "    pass\n\n\n"
        "def classify(exc):\n"
        "    if isinstance(exc, ValueError):\n"
        "        return False\n"
        "    if isinstance(exc, FixError):  # dead: ValueError decided\n"
        "        return False\n"
        "    if isinstance(exc, GhostError):  # undefined anywhere\n"
        "        return True\n"
        "    return isinstance(exc, OSError)\n")
    res = run_project([str(tmp_path)])
    assert res.errors == []
    ref = j_run_project([str(tmp_path)])
    assert _rows(f for f in res.findings if f.code == "VL603") == \
        _rows(f for f in ref.findings if f.code == "VL603")
    msgs = [f.message for f in res.findings if f.code == "VL603"]
    assert any("unknown exception type GhostError" in m for m in msgs)
    assert any("branch is dead: FixError already decided" in m
               for m in msgs)


# -- VL604: fence before publish ---------------------------------------------

def test_vl604_direct_and_helper_publish():
    """An ``index/`` put with no ``_guard_publish`` dominator fires;
    the key-taking helper fires once, blaming the unguarded caller in
    its hop chain — the guarded twin paths stay silent."""
    found = _findings("VL604", "fx/repo/publish.py")
    pub = FX / "publish.py"
    by_line = {f.line: f for f in found}
    assert set(by_line) == {_mark_line(pub, "vl604-direct"),
                            _mark_line(pub, "vl604-helper-effect")}
    direct = by_line[_mark_line(pub, "vl604-direct")]
    assert "unfenced 'index/'-family publish" in direct.message
    assert "_guard_publish" in direct.message
    assert direct.severity == "error"
    helper = by_line[_mark_line(pub, "vl604-helper-effect")]
    assert "'snap/'" in helper.message
    assert "called from emit_unguarded()" in helper.message
    assert f"publish.py:{_mark_line(pub, 'vl604-helper-call')}" \
        in helper.message


# -- VL605: crash ordering ---------------------------------------------------

def test_vl605_order_violation_and_clean_twin():
    """``sweep_bad`` scrubs the tombstone before marking — the finding
    lands at the too-early step and recites the declared order; the
    in-order ``sweep_ok`` twin (law 'fx.sweep') reports nothing."""
    found = _findings("VL605", "fx/repo/twophase.py")
    tp = FX / "twophase.py"
    assert {f.line for f in found} == {_mark_line(tp, "vl605-early-scrub")}
    f = found[0]
    assert "'fx.sweep-bad'" in f.message
    assert "must not run before" in f.message
    assert "_mark < delete-prefix:tomb/ < delete-of:victims" in f.message
    assert f.severity == "error"
    assert not any("'fx.sweep'" in g.message for g in found)


# -- finding mechanics -------------------------------------------------------

def test_vl6_findings_carry_source_spans():
    for f in (_findings("VL601", "fx/repo/uploader.py")
              + _findings("VL602", "fx/repo/pusher.py")
              + _findings("VL604", "fx/repo/publish.py")
              + _findings("VL605", "fx/repo/twophase.py")):
        assert f.col > 0
        assert f.end_line >= f.line
        assert f.end_col > 0


def test_cli_select_vl6_only():
    lines: list = []
    rc = lint_main(["--no-baseline", "--select", "VL6", str(MINIPROJ)],
                   out=lines.append)
    assert rc == 1
    finding_lines = [s for s in lines if " VL" in s]
    assert finding_lines
    assert all(" VL6" in s for s in finding_lines)


def test_sarif_has_vl6_catalogue_regions_and_tiers(tmp_path):
    out = tmp_path / "fx.sarif"
    rc = lint_main(["--no-baseline", "--select", "VL6", "--format",
                    "sarif", "--out", str(out), str(MINIPROJ)],
                   out=lambda *_: None)
    assert rc == 1
    doc = json.loads(out.read_text())
    run = doc["runs"][0]
    rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert {"VL601", "VL602", "VL603", "VL604", "VL605"} <= rule_ids
    levels = {}
    for res in run["results"]:
        levels.setdefault(res["ruleId"], set()).add(res["level"])
        reg = res["locations"][0]["physicalLocation"]["region"]
        assert reg["startLine"] >= 1 and "startColumn" in reg
        assert reg["endLine"] >= reg["startLine"]
    assert levels["VL603"] == {"warning"}
    for code in ("VL601", "VL602", "VL604", "VL605"):
        assert levels[code] == {"error"}


def test_cli_stats_reports_families(tmp_path, capsys):
    lines: list = []
    rc = lint_main(["--no-baseline", "--stats", str(MINIPROJ)],
                   out=lines.append)
    assert rc == 1  # the fixtures ARE findings
    stats = json.loads("\n".join(lines))
    assert stats["findings"]["VL6xx"] == 8
    assert stats["suppressions"]["VL6xx"] >= 1  # the reviewed put
    assert stats["total_findings"] >= stats["findings"]["VL6xx"]


# -- cached fault facts ------------------------------------------------------

def test_fx_facts_cached_and_invalidated(tmp_path):
    """Warm cache re-analyzes ZERO files and replays VL6 findings
    verbatim; editing the chain's middle hop kills the two-hop
    stacking finding, and reverting the edit re-surfaces it."""
    proj = tmp_path / "miniproj"
    shutil.copytree(MINIPROJ, proj)
    cache = tmp_path / ".lint-cache"

    def vl6(res):
        return sorted((f.path, f.line, f.code, f.message)
                      for f in res.findings if f.code.startswith("VL6"))

    cold = run_project([str(tmp_path)], cache_path=cache)
    assert cold.errors == []
    cold_vl6 = vl6(cold)
    assert cold_vl6

    # the cache rows carry the new "fx" fact kind
    raw = json.loads(cache.read_text())
    assert any(row.get("fx") for row in raw["files"].values())

    warm = run_project([str(tmp_path)], cache_path=cache)
    assert warm.analyzed == []
    assert vl6(warm) == cold_vl6

    pusher = proj / "fx" / "repo" / "pusher.py"
    original = pusher.read_text()
    pusher.write_text(original.replace(
        "return self._fetch(key)",
        "return None  # chain severed"))
    edited = run_project([str(tmp_path)], cache_path=cache)
    assert pusher.as_posix() in edited.analyzed
    two_hop = _mark_line(pusher, "vl602-two-hop")
    assert not any(f.path == pusher.as_posix() and f.code == "VL602"
                   and f.line == two_hop for f in edited.findings)

    pusher.write_text(original)
    restored = run_project([str(tmp_path)], cache_path=cache)
    assert pusher.as_posix() in restored.analyzed
    assert vl6(restored) == cold_vl6


# -- effect-graph export -----------------------------------------------------

def test_dump_effects_cli(tmp_path):
    out = tmp_path / "effects.json"
    lines: list = []
    rc = lint_main(["--no-baseline", "--select", "VL6",
                    "--dump-effects", str(out), str(MINIPROJ)],
                   out=lines.append)
    assert rc == 1  # the fixtures ARE findings; the dump still lands
    doc = json.loads(out.read_text())
    assert set(doc) == {"laws", "nodes", "edges"}
    assert doc["laws"]["retried_ops"] == ["delete", "get"]
    assert doc["laws"]["single_attempt_ops"] == ["put_if_absent"]
    assert doc["laws"]["fenced_families"] == ["index/", "snap/"]
    assert doc["laws"]["orderings"]["fx.sweep"]["fn"] == "sweep_ok"
    assert any(b["types"] == ["TransientError"] and b["verdict"] is True
               for b in doc["laws"]["classify"])
    nodes = {n["fn"]: n for n in doc["nodes"]}
    fetch = nodes["miniproj.fx.repo.pusher.Pusher._fetch"]
    assert [e["op"] for e in fetch["effects"]] == ["get"]
    assert fetch["effects"][0]["kind"] == "boundary"
    assert len(fetch["effects"][0]["layers"]) == 1
    policy_edges = [e for e in doc["edges"] if e["kind"] == "policy"]
    assert any(e["from"].endswith("Pusher.sync")
               and e["to"].endswith("Pusher._mid") for e in policy_edges)
    assert any(str(out) in s for s in lines)


def test_static_fault_edges_cover_package():
    """The static half of the bridge over the real package: the index
    publish edge exists, and classify's verdict sets name the taxonomy
    roots."""
    static = static_fault_edges_for_paths([str(PKG)])
    assert ("put", "index/") in {tuple(e) for e in static["edges"]}
    assert "TransientError" in static["retryable_types"]
    assert "OSError" in static["retryable_types"]
    assert "ValueError" in static["fatal_types"]


# -- runtime ⊆ static --------------------------------------------------------

def test_runtime_faults_subset_of_static(tmp_path):
    """The fault-path bridge: run the port's backup+restore under a seeded
    chaos schedule, then check (a) every (op, key) the FaultStore
    observed lies on a statically inferred effect edge, and (b) every
    injected exception type is one classify() decides. An observed op
    with no static edge means the effect walk lost a store call path —
    this test is the canary."""
    from volsync_tpu_torch.engine.backup import TreeBackup
    from volsync_tpu_torch.engine.restore import restore_snapshot
    from volsync_tpu_torch.objstore.faultstore import (
        FaultSchedule,
        FaultSpec,
        FaultStore,
    )
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.repo.repository import Repository
    from volsync_tpu_torch.resilience import (
        CircuitBreaker,
        ResilientStore,
        RetryPolicy,
        classify,
    )

    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.RandomState(11)
    for i in range(3):
        (src / f"f{i}.bin").write_bytes(rng.bytes(150_000 + 17_000 * i))

    fs = FsObjectStore(str(tmp_path / "store"))
    faults = FaultStore(fs, FaultSchedule(seed=23, specs=[
        FaultSpec(kind="transient", p=0.08),
        FaultSpec(kind="throttle", p=0.04, op="put"),
    ]))
    policy = RetryPolicy(site="fxbridge", max_attempts=10,
                         base_delay=0.001, max_delay=0.01,
                         sleep_fn=lambda s: None)
    top = ResilientStore(faults, policy=policy,
                         breaker=CircuitBreaker("fxbridge",
                                                threshold=10**9,
                                                reset_seconds=0.01))
    repo = Repository.init(top, device="cpu", chunker={
        "min_size": 16 * 1024, "avg_size": 32 * 1024,
        "max_size": 64 * 1024, "seed": 11})
    TreeBackup(repo, workers=2, device="cpu").run(src)
    dst = tmp_path / "dst"
    restore_snapshot(Repository.open(top, device="cpu"), dst, device="cpu")
    for i in range(3):
        assert (dst / f"f{i}.bin").read_bytes() == \
            (src / f"f{i}.bin").read_bytes()

    assert faults.injected, "seeded schedule injected nothing"
    static = static_fault_edges_for_paths([str(PKG)])
    edges = [tuple(e) for e in static["edges"]]
    for _opix, op, key, _kind in faults.injected:
        assert any(o == op and (p == "" or key.startswith(p))
                   for o, p in edges), (
            f"runtime fault edge ({op}, {key!r}) has no static cover")

    decided = set(static["retryable_types"]) | set(static["fatal_types"])
    kind_exc = {"transient": "FaultInjected", "throttle": "InjectedThrottle"}
    from volsync_tpu_torch.objstore import faultstore as fmod
    for kind in {k for _, _, _, k in faults.injected}:
        exc_cls = getattr(fmod, kind_exc[kind])
        mro = {c.__name__ for c in exc_cls.__mro__}
        assert mro & decided, f"classify() cannot decide {exc_cls}"
        assert classify(exc_cls("probe")) is True  # both kinds retryable
