"""The port's lint (``volsync_tpu_torch/analysis/``) against the
reference's (``volsync_tpu/analysis/``), on the CPU.

The cases of ``tests/test_analysis.py`` for the rule families that read
the same source in both packages: every seeded snippet (per-file
VL001-VL003, VL005, VL105, VL106, VL301 and interprocedural
VL101-VL103) goes through both linters,
which must report the same findings (path, line, code, message with the
package name mapped, severity and span), and through the port alone
against the reference test's expected codes and lines. The committed
mini-package in ``analysis_fixtures/`` goes through both, one
parametrised case per ported code. Then the engine's mechanics on the
port (incremental cache, rule-set signature, SARIF, baseline add and
expire, exit codes, the ``volsync lint`` verb), and the tier-1 gate: the
port's linter, every family, over ``volsync_tpu_torch/`` and
``chip_smoke.py`` with no baseline reports nothing; its rule catalogue
is the reference's; and with the VL501/VL502 pragmas stripped it finds
the counterparts of the reference's pragma'd sites. The families that
model the array library (``ARRAY_FAMILIES``) recognise torch in the
port and jnp/lax in the reference, so they are held against the
reference on translated inputs in ``test_torch_analysis_shapes.py`` and
``test_torch_analysis_device.py``.
"""

import json
import re
import shutil
from pathlib import Path

import pytest

import volsync_tpu_torch
from volsync_tpu.analysis import run_lint as j_run_lint
from volsync_tpu.analysis import run_project as j_run_project
from volsync_tpu_torch.analysis import (
    apply_baseline,
    load_baseline,
    run_lint,
    run_project,
    write_baseline,
)
from volsync_tpu_torch.analysis.cli import _all_rules
from volsync_tpu_torch.analysis.cli import main as lint_main
from volsync_tpu_torch.cli.main import run as cli_run

FIXTURES = Path(__file__).resolve().parent / "analysis_fixtures"
MINIPROJ = FIXTURES / "miniproj"
PKG = Path(volsync_tpu_torch.__file__).resolve().parent
#: the families that model the array library: torch's idiom in the port,
#: jnp/lax/jax.jit in the reference, so no shared input exercises both
ARRAY_FAMILIES = {"VL004", "VL104", "VL201", "VL202", "VL203", "VL204",
                  "VL205", "VL501", "VL502", "VL504"}
PORTED = sorted({r.code for rules in _all_rules() for r in rules}
                - ARRAY_FAMILIES)


def _rows(findings, mapped: bool = False):
    """Comparable rows; the reference's rows keep only the codes the port
    carries and name the port's package in their messages."""
    out = []
    for f in findings:
        if mapped and f.code not in PORTED:
            continue
        msg = f.message.replace("volsync_tpu/", "volsync_tpu_torch/") \
            if mapped else f.message
        # the port words one VL602 aside on the bug class without the
        # reference's history
        msg = re.sub(r" \(the [^)]*bug class\)", "", msg)
        out.append((f.path, f.line, f.code, msg, f.severity, f.col,
                    f.end_line, f.end_col))
    return sorted(out)


def _lint_file(tmp_path, source, name="mod.py", subdir=None):
    """Lint one file with both packages; they must agree. -> the port's
    findings."""
    d = tmp_path if subdir is None else tmp_path / subdir
    d.mkdir(parents=True, exist_ok=True)
    f = d / name
    f.write_text(source)
    findings, errors = run_lint([str(f)])
    j_findings, j_errors = j_run_lint([str(f)])
    assert errors == [] and j_errors == []
    assert _rows(findings) == _rows(j_findings, mapped=True)
    return findings


def _codes(findings):
    return sorted(f.code for f in findings)


# -- rule fixtures: (source, file name, subdir, codes, lines or None) --------

VL001 = (
    "import os\n"
    "import os as _os\n"
    "from os import environ, getenv as ge\n"
    "a = os.environ.get('VOLSYNC_FOO')\n"
    "b = _os.environ['VOLSYNC_BAR']\n"
    "c = environ.get('VOLSYNC_BAZ')\n"
    "d = ge('VOLSYNC_QUX')\n"
    "e = 'VOLSYNC_IN' in os.environ\n"
    "ok1 = os.environ.get('HOME')\n"
    "ok2 = os.environ.get(a)\n"
    "os.environ['VOLSYNC_SET'] = '1'\n")

VL003 = (
    "try:\n    x = 1\nexcept Exception:\n    pass\n"
    "try:\n    x = 2\nexcept:\n    pass\n"
    "for i in range(3):\n"
    "    try:\n        x = 3\n    except BaseException:\n"
    "        continue\n"
    "try:\n    x = 4\nexcept ValueError:\n    pass\n"
    "try:\n    x = 5\nexcept Exception as e:\n    print(e)\n"
    "try:\n    x = 6\nexcept Exception:\n    raise\n")

VL003_SUPPRESSED = (
    "try:\n    x = 1\n"
    "except Exception:  # lint: ignore[VL003] — reason here\n"
    "    pass\n"
    "try:\n    x = 2\n"
    "except Exception:  # lint: ignore\n"
    "    pass\n"
    "try:\n    x = 3\n"
    "except Exception:  # lint: ignore[VL001]\n"
    "    pass\n")

VL005 = ("import threading\n"
         "from threading import Lock\n"
         "a = threading.Lock()\n"
         "b = threading.RLock()\n"
         "c = Lock()\n"
         "e = threading.Event()\n")

VL105 = (
    "import time\n"
    "import time as t\n"
    "from time import sleep as zzz\n"
    "def handler():\n"
    "    try:\n"
    "        x = 1\n"
    "    except OSError:\n"
    "        time.sleep(1)\n"
    "def retry_loop():\n"
    "    for i in range(3):\n"
    "        try:\n"
    "            x = 1\n"
    "        except OSError:\n"
    "            pass\n"
    "        t.sleep(0.1)\n"
    "def while_retry():\n"
    "    while True:\n"
    "        try:\n"
    "            break\n"
    "        except OSError:\n"
    "            pass\n"
    "        zzz(0.1)\n"
    "def pacing():\n"
    "    for i in range(3):\n"
    "        time.sleep(0.1)\n"
    "def nested_reset():\n"
    "    try:\n"
    "        x = 1\n"
    "    except OSError:\n"
    "        def cb():\n"
    "            time.sleep(1)\n"
    "        cb()\n")

VL105_SUPPRESSED = ("import time\n"
                    "while True:\n"
                    "    try:\n"
                    "        break\n"
                    "    except OSError:\n"
                    "        pass\n"
                    "    time.sleep(1)  # lint: ignore[VL105] — paced poll\n")

VL106 = (
    "def seal(view, parts, n):\n"
    "    a = view.tobytes()\n"
    "    b = bytes(view)\n"
    "    c = b''.join(parts)\n"
    "    ok1 = bytes(16)\n"
    "    ok2 = bytes()\n"
    "    ok3 = ','.join(str(p) for p in parts)\n"
    "    ok4 = n.to_bytes(8, 'big')\n"
    "    return a, b, c, ok1, ok2, ok3, ok4\n")

VL301 = (
    "from volsync_tpu_torch.obs import begin_span, span\n"
    "from volsync_tpu_torch import obs\n"
    "stage = 'read'\n"
    "with span(f'engine.{stage}'):\n"
    "    pass\n"
    "with span('engine.' + stage):\n"
    "    pass\n"
    "with span(stage):\n"
    "    pass\n"
    "with span('Bad.Name'):\n"
    "    pass\n"
    "with obs.span('flat'):\n"
    "    pass\n"
    "h = begin_span(name=stage)\n")

VL301_CLEAN = (
    "import re\n"
    "from volsync_tpu_torch.obs import begin_span, span\n"
    "from volsync_tpu_torch import obs\n"
    "with span('engine.read'):\n"
    "    pass\n"
    "with obs.span('svc.queue_wait', lanes=4):\n"
    "    pass\n"
    "h = begin_span('repo.pack_upload', ctx=None)\n"
    "h.finish('ok')\n"
    "m = re.match('(a)', 'a')\n"
    "s = m.span(1)\n")

VL301_DYNAMIC = ("def span(name, **attrs):\n"
                 "    return name\n"
                 "x = 'dyn'\n"
                 "span(x)\n")

VL101 = (
    "import time\n"
    "def make_lock(name):\n"
    "    return name\n"
    "_L = make_lock('t.lock')\n"
    "def hot():\n"
    "    with _L:\n"
    "        time.sleep(1)\n"
    "def reviewed():\n"
    "    # lint: ignore[VL101] -- held for atomicity only\n"
    "    with _L:\n"
    "        time.sleep(1)\n"
    "def bare():\n"
    "    _L.acquire()\n"
    "    try:\n"
    "        time.sleep(1)\n"
    "    finally:\n"
    "        _L.release()\n"
    "def after_release():\n"
    "    _L.acquire()\n"
    "    try:\n"
    "        pass\n"
    "    finally:\n"
    "        _L.release()\n"
    "    time.sleep(1)\n")

VL102 = (
    "import threading\n"
    "from concurrent.futures import ThreadPoolExecutor\n"
    "def unnamed_daemon():\n"
    "    threading.Thread(target=print, daemon=True).start()\n"
    "def named_joined():\n"
    "    t = threading.Thread(target=print, name='w')\n"
    "    t.start()\n"
    "    t.join()\n"
    "def named_leaked():\n"
    "    t = threading.Thread(target=print, name='w2')\n"
    "    t.start()\n"
    "def pool_leaked():\n"
    "    ex = ThreadPoolExecutor(max_workers=2)\n"
    "    return ex.submit(print)\n"
    "def pool_with():\n"
    "    with ThreadPoolExecutor(max_workers=2) as ex:\n"
    "        ex.submit(print)\n"
    "def pool_transferred(server):\n"
    "    return server(ThreadPoolExecutor(max_workers=2))\n")

VL103 = (
    "def leak(lock):\n"
    "    lock.acquire()\n"
    "    do()\n"
    "    lock.release()\n"
    "def ok_finally(lock):\n"
    "    lock.acquire()\n"
    "    try:\n"
    "        do()\n"
    "    finally:\n"
    "        lock.release()\n"
    "def ok_reraise(slots):\n"
    "    slots.acquire()\n"
    "    try:\n"
    "        do()\n"
    "    except Exception:\n"
    "        slots.release()\n"
    "        raise\n"
    "def leak_open(p):\n"
    "    f = open(p)\n"
    "    return f.read()\n"
    "def ok_open(p):\n"
    "    f = open(p)\n"
    "    try:\n"
    "        return f.read()\n"
    "    finally:\n"
    "        f.close()\n"
    "def ok_with(p):\n"
    "    with open(p) as f:\n"
    "        return f.read()\n")

CASES = {
    "vl001-env-read": (VL001, "mod.py", None, ["VL001"] * 5,
                       {4, 5, 6, 7, 8}),
    "vl001-envflags-exempt": ("import os\nx = os.environ.get('VOLSYNC_FOO')\n",
                              "envflags.py", None, [], None),
    "vl002-gated": ("import zstandard\n"
                    "from cryptography.hazmat.primitives import hashes\n"
                    "import json\n", "mod.py", None, ["VL002"] * 2, None),
    "vl002-compress-shim": ("import zstandard\n", "compress.py", "repo", [],
                            None),
    "vl002-crypto-shim": ("import cryptography\n", "crypto.py", "repo", [],
                          None),
    "vl003-silent": (VL003, "mod.py", None, ["VL003"] * 3, None),
    "vl003-suppression": (VL003_SUPPRESSED, "mod.py", None, ["VL003"], {11}),
    "vl005-data-plane": (VL005, "mod.py", "repo", ["VL005"] * 3, None),
    "vl005-ops": (VL005, "mod.py", "ops", ["VL005"] * 3, None),
    "vl005-control-plane": (VL005, "mod.py", "cluster", [], None),
    "vl105-adhoc-retry": (VL105, "mod.py", None, ["VL105"] * 3,
                          {8, 15, 22}),
    "vl105-resilience-exempt": (VL105, "resilience.py", None, [], None),
    "vl105-suppression": (VL105_SUPPRESSED, "mod.py", None, [], None),
    "vl106-repo": (VL106, "mod.py", "repo", ["VL106"] * 3, {2, 3, 4}),
    "vl106-engine": (VL106, "mod.py", "engine", ["VL106"] * 3, {2, 3, 4}),
    "vl106-service": (VL106, "mod.py", "service", [], None),
    "vl106-cluster": (VL106, "mod.py", "cluster", [], None),
    "vl106-suppression": ("def download(digests):\n"
                          "    return digests.tobytes()  "
                          "# lint: ignore[VL106] 32 B digests\n",
                          "mod.py", "ops", [], None),
    "vl301-dynamic-names": (VL301, "mod.py", None, ["VL301"] * 6,
                            {4, 6, 8, 10, 12, 14}),
    "vl301-clean-twin": (VL301_CLEAN, "mod.py", None, [], None),
    "vl301-tracing-exempt": (VL301_DYNAMIC, "tracing.py", "obs", [], None),
    "vl301-dynamic-elsewhere": (VL301_DYNAMIC, "mod.py", None, ["VL301"],
                                None),
    "vl101-regions": (VL101, "mod.py", "engine", ["VL101"] * 2, {7, 15}),
    "vl102-thread-lifecycle": (VL102, "mod.py", None, ["VL102"] * 3,
                               {4, 10, 13}),
    "vl103-leak": (VL103, "mod.py", "repo", ["VL103"] * 2, {2, 19}),
    "vl103-control-plane": (VL103, "mod.py", "cluster", [], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_fixture_on_both_linters(tmp_path, case):
    src, name, subdir, codes, lines = CASES[case]
    findings = _lint_file(tmp_path, src, name=name, subdir=subdir)
    assert _codes(findings) == codes
    if lines is not None:
        assert {f.line for f in findings} == lines


def test_vl102_messages(tmp_path):
    msgs = " / ".join(f.message for f in _lint_file(tmp_path, VL102))
    assert "without name=" in msgs
    assert "no reachable .join()" in msgs
    assert "no reachable .shutdown()" in msgs


def test_vl001_message_names_the_ports_envflags(tmp_path):
    (f,) = _lint_file(tmp_path, "import os\nx = os.getenv('VOLSYNC_A')\n")
    assert "volsync_tpu_torch/envflags.py" in f.message


def test_scope_keys_on_the_ports_root(tmp_path):
    """Scope-limited rules read the directories after the last
    ``volsync_tpu_torch`` component: a checkout under a directory named
    ``repo`` does not put a top-level module in the data plane."""
    d = tmp_path / "repo" / "volsync_tpu_torch"
    d.mkdir(parents=True)
    f = d / "top.py"
    f.write_text(VL005)
    findings, errors = run_lint([str(f)])
    assert errors == [] and findings == []
    (d / "ops").mkdir()
    (d / "ops" / "k.py").write_text(VL005)
    findings, _ = run_lint([str(d / "ops" / "k.py")])
    assert _codes(findings) == ["VL005"] * 3


def test_syntax_error_is_reported(tmp_path):
    f = tmp_path / "bad.py"
    f.write_text("def broken(:\n")
    findings, errors = run_lint([str(f)])
    assert findings == []
    assert len(errors) == 1 and "bad.py" in errors[0]


# -- the fixture package on both linters --------------------------------------

@pytest.fixture(scope="module")
def miniproj_runs():
    port = run_project([str(MINIPROJ)])
    ref = j_run_project([str(MINIPROJ)])
    assert port.errors == [] and ref.errors == []
    return port, ref


@pytest.mark.parametrize("code", PORTED)
def test_fixture_package_findings_equal_the_reference(miniproj_runs, code):
    port, ref = miniproj_runs
    assert _rows([f for f in port.findings if f.code == code]) == \
        _rows([f for f in ref.findings if f.code == code], mapped=True)


def test_fixture_package_codes(miniproj_runs):
    """Every ported family fires on its seeded fixture, and nothing the
    port does not carry."""
    port, _ = miniproj_runs
    assert {f.code for f in port.findings} == {
        "VL101", "VL401", "VL402", "VL403", "VL404", "VL503", "VL505",
        "VL601", "VL602", "VL603", "VL604", "VL605"}


def _mark_line(path: Path, marker: str) -> int:
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        if f"MARK: {marker}" in line:
            return i
    raise AssertionError(f"marker {marker!r} not in {path}")


def test_vl101_interprocedural_fixture_package(miniproj_runs):
    """From-import-as aliasing, self-method dispatch, base-class lock
    lookup, and a blocking call two call-hops below a ``with lock:``
    region reported with its hop chain."""
    port, _ = miniproj_runs
    store = MINIPROJ / "repo" / "store.py"
    vl101 = [f for f in port.findings if f.code == "VL101"]
    assert all(f.path.endswith("repo/store.py") for f in vl101)
    by_line = {f.line: f for f in vl101}
    assert set(by_line) == {_mark_line(store, "direct-sleep"),
                            _mark_line(store, "two-hop"),
                            _mark_line(store, "self-method")}
    direct = by_line[_mark_line(store, "direct-sleep")]
    assert "time.sleep()" in direct.message
    assert "lock 'miniproj.repo.module'" in direct.message
    two_hop = by_line[_mark_line(store, "two-hop")]
    assert "via drain() -> _slow()" in two_hop.message
    assert "lock 'miniproj.repo.store'" in two_hop.message
    assert two_hop.severity == "error"
    self_m = by_line[_mark_line(store, "self-method")]
    assert "via _write() -> drain() -> _slow()" in self_m.message


# -- incremental cache --------------------------------------------------------

def test_cache_warm_run_and_transitive_invalidation(tmp_path):
    a, b, c = (tmp_path / n for n in ("a.py", "b.py", "c.py"))
    c.write_text("import os\n"
                 "import time\n"
                 "V = os.environ.get('VOLSYNC_CACHED')\n"
                 "def slow():\n"
                 "    time.sleep(1)\n")
    b.write_text("import c\n"
                 "def mid():\n"
                 "    c.slow()\n")
    a.write_text("import b\n"
                 "def top():\n"
                 "    b.mid()\n")
    cache = tmp_path / ".lint-cache"

    cold = run_project([str(tmp_path)], cache_path=cache)
    assert cold.errors == []
    assert sorted(cold.analyzed) == sorted(
        p.as_posix() for p in (a, b, c))
    assert [f.code for f in cold.findings] == ["VL001"]

    warm = run_project([str(tmp_path)], cache_path=cache)
    assert warm.analyzed == []
    assert warm.total == 3
    assert [(f.path, f.line, f.code, f.message, f.severity)
            for f in warm.findings] == [
        (f.path, f.line, f.code, f.message, f.severity)
        for f in cold.findings]

    c.write_text(c.read_text().replace("time.sleep(1)", "time.sleep(2)"))
    edited = run_project([str(tmp_path)], cache_path=cache)
    assert sorted(edited.analyzed) == sorted(
        p.as_posix() for p in (a, b, c))

    d = tmp_path / "d.py"
    d.write_text("X = 1\n")
    extended = run_project([str(tmp_path)], cache_path=cache)
    assert extended.analyzed == [d.as_posix()]
    assert [f.code for f in extended.findings] == ["VL001"]


def test_cache_rejected_on_rule_set_change(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("X = 1\n")
    cache = tmp_path / ".lint-cache"
    run_project([str(tmp_path)], cache_path=cache)

    class FakeRule:
        code = "VL999"
        name = "fake"
        description = "fake"

        def check(self, ctx):
            return iter(())

    from volsync_tpu_torch.analysis.rules import default_rules
    res = run_project([str(tmp_path)], rules=default_rules() + [FakeRule()],
                      cache_path=cache)
    assert res.analyzed == [mod.as_posix()]


def test_cli_cache_stat_line(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("X = 1\n")
    cache = tmp_path / ".lint-cache"
    lines = []
    assert lint_main([str(mod), "--no-baseline", "--cache", str(cache)],
                     out=lines.append) == 0
    lines.clear()
    assert lint_main([str(mod), "--no-baseline", "--cache", str(cache)],
                     out=lines.append) == 0
    assert any(ln.startswith("cache: analyzed 0 of 1") for ln in lines)


# -- SARIF ----------------------------------------------------------------------

def test_sarif_output_shape(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("import os\nx = os.environ.get('VOLSYNC_X')\n")
    out_file = tmp_path / "lint.sarif"
    lines = []
    rc = lint_main([str(mod), "--no-baseline", "--format", "sarif",
                    "--out", str(out_file)], out=lines.append)
    assert rc == 1
    doc = json.loads(out_file.read_text())
    assert doc["version"] == "2.1.0"
    assert "sarif-schema-2.1.0.json" in doc["$schema"]
    run = doc["runs"][0]
    driver = run["tool"]["driver"]
    assert driver["name"] == "volsync-lint"
    rule_ids = [r["id"] for r in driver["rules"]]
    assert rule_ids == [r.code for rules in _all_rules() for r in rules]
    for r in driver["rules"]:
        assert r["defaultConfiguration"]["level"] in (
            "error", "warning", "note")
    assert run["invocations"][0]["executionSuccessful"] is True
    (res,) = run["results"]
    assert res["ruleId"] == "VL001"
    assert res["level"] == "warning"
    loc = res["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].endswith("m.py")
    assert loc["region"]["startLine"] == 2
    assert rule_ids[res["ruleIndex"]] == "VL001"


def test_sarif_parse_error_notification(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    lines = []
    assert lint_main([str(bad), "--no-baseline", "--format", "sarif"],
                     out=lines.append) == 1
    doc = json.loads("\n".join(lines))
    inv = doc["runs"][0]["invocations"][0]
    assert inv["executionSuccessful"] is False
    notes = inv["toolExecutionNotifications"]
    assert len(notes) == 1 and "bad.py" in notes[0]["message"]["text"]


# -- baseline add / expire ----------------------------------------------------

def test_baseline_roundtrip_and_expiry(tmp_path):
    mod = tmp_path / "legacy.py"
    mod.write_text("import os\n"
                   "a = os.environ.get('VOLSYNC_OLD')\n"
                   "b = os.environ.get('VOLSYNC_OLDER')\n")
    baseline_path = tmp_path / "baseline.json"

    findings, _ = run_lint([str(mod)])
    assert len(findings) == 2
    write_baseline(findings, baseline_path)
    new, suppressed, stale = apply_baseline(findings,
                                            load_baseline(baseline_path))
    assert new == [] and suppressed == 2 and stale == []

    mod.write_text(mod.read_text()
                   + "c = os.environ.get('VOLSYNC_NEW')\n")
    findings2, _ = run_lint([str(mod)])
    new, suppressed, stale = apply_baseline(findings2,
                                            load_baseline(baseline_path))
    assert len(new) == 1 and "VOLSYNC_NEW" in new[0].message
    assert suppressed == 2

    mod.write_text("import os\n"
                   "a = os.environ.get('VOLSYNC_OLD')\n")
    findings3, _ = run_lint([str(mod)])
    new, suppressed, stale = apply_baseline(findings3,
                                            load_baseline(baseline_path))
    assert new == [] and suppressed == 1
    assert len(stale) == 1 and "VOLSYNC_OLDER" in stale[0]


def test_baseline_missing_file_is_empty(tmp_path):
    assert load_baseline(tmp_path / "nope.json") == {}


def test_cli_exit_codes_and_write_baseline(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("import os\nx = os.environ.get('VOLSYNC_X')\n")
    baseline = tmp_path / "b.json"
    lines = []
    assert lint_main([str(mod), "--baseline", str(baseline)],
                     out=lines.append) == 1
    assert any("VL001" in ln for ln in lines)
    assert lint_main([str(mod), "--baseline", str(baseline),
                      "--write-baseline"], out=lines.append) == 0
    assert baseline.exists()
    assert lint_main([str(mod), "--baseline", str(baseline)],
                     out=lines.append) == 0
    assert lint_main([str(mod), "--baseline", str(baseline),
                      "--no-baseline"], out=lines.append) == 1
    with pytest.raises(SystemExit) as e:
        lint_main(["--format", "yaml"], out=lines.append)
    assert e.value.code == 2


def test_volsync_cli_lint_verb(tmp_path):
    """The port's ``volsync lint`` dispatches to its analyzer without
    any cluster context."""
    mod = tmp_path / "m.py"
    mod.write_text("try:\n    pass\nexcept Exception:\n    pass\n")
    lines = []
    assert cli_run(["lint", str(mod), "--no-baseline"], {},
                   out=lines.append) == 1
    assert any("VL003" in ln for ln in lines)


# -- the tier-1 gate ------------------------------------------------------------

def _port_paths(root: Path = PKG.parent) -> list:
    paths = [str(root / "volsync_tpu_torch")]
    smoke = root / "chip_smoke.py"
    if smoke.exists():  # absent when only the package is installed
        paths.append(str(smoke))
    return paths


def test_port_is_lint_clean():
    """The port's linter, every rule family, over ``volsync_tpu_torch/``
    and ``chip_smoke.py`` with no baseline: no finding and no file error.
    Every pragma there carries its reason on its line."""
    codes = {r.code for rules in _all_rules() for r in rules}
    assert ARRAY_FAMILIES <= codes
    findings, errors = run_lint(_port_paths())
    assert errors == []
    assert findings == [], "\n" + "\n".join(f.render() for f in findings)


def test_list_rules_equal_the_reference():
    """``--list-rules`` names the same codes in both packages."""
    from volsync_tpu.analysis.cli import main as j_lint_main

    def codes(main):
        lines = []
        assert main(["--list-rules"], out=lines.append) == 0
        return sorted(ln.split()[0] for ln in lines if ln.startswith("VL"))

    port = codes(lint_main)
    assert port == codes(j_lint_main)
    assert ARRAY_FAMILIES <= set(port)


_PRAGMA = re.compile(r"#\s*lint:\s*ignore\[([A-Z0-9, ]+)\]")

#: the port's counterparts of the reference's 13 VL501/VL502 pragma'd
#: sites, as (file, text of the line, code). The reference's others have
#: no counterpart where the port's analysis sees a device value:
#: ops/delta.py:87 and :156, ops/md5.py:162 and ops/sha256.py:223 fetch
#: inside a helper that takes the tensor as a parameter
#: (``_states_host``, ``state_bytes``, ``digest_bytes``), and
#: ops/segment.py:895 re-dispatches a view of the batch's device rows
#: through an attribute call the call graph does not resolve.
COUNTERPARTS = [
    ("engine/chunker.py", "flat = digests.cpu().numpy()", "VL501"),
    ("engine/chunker.py", "roots = roots.cpu().numpy()", "VL501"),
    ("ops/segment.py", "flat = _page_digests_flat(dev, F, pm).cpu()",
     "VL501"),
    ("engine/deltasync.py", "buf = _to_device(data, dev)", "VL502"),
    ("engine/deltasync.py", "sw_dev = torch.from_numpy(sorted_weak)",
     "VL502"),
    ("engine/deltasync.py", "nb_dev = torch.from_numpy(nb)", "VL502"),
    ("engine/deltasync.py", "ns_dev = torch.from_numpy(nscan)", "VL502"),
    ("engine/deltasync.py", "cand_dev, count = match_offsets_batch(",
     "VL502"),
]


def test_stripped_pragmas_find_the_reference_sites(tmp_path):
    """A copy of the port with every VL501/VL502 pragma stripped: the
    device half reports exactly the stripped lines (each pragma is
    needed), among them the counterparts of the reference's pragma'd
    sites."""
    root = tmp_path / "port"
    shutil.copytree(PKG, root / "volsync_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    smoke = PKG.parent / "chip_smoke.py"
    if smoke.exists():
        shutil.copy(smoke, root / "chip_smoke.py")
    stripped = set()
    for f in [*root.rglob("*.py")]:
        lines = f.read_text().splitlines(keepends=True)
        for i, line in enumerate(lines):
            m = _PRAGMA.search(line)
            if not m:
                continue
            codes = [c.strip() for c in m.group(1).split(",")]
            keep = [c for c in codes if c not in ("VL501", "VL502")]
            if keep == codes:
                continue
            for c in set(codes) - set(keep):
                stripped.add((f.relative_to(root).as_posix(), i + 1, c))
            lines[i] = line[:m.start()] + (
                f"# lint: ignore[{','.join(keep)}]" if keep
                else "# lint: stripped") + line[m.end():]
        f.write_text("".join(lines))
    findings, errors = run_lint(_port_paths(root))
    assert errors == []
    got = {(Path(f.path).relative_to(root).as_posix(), f.line, f.code)
           for f in findings}
    assert got == stripped
    for rel, text, code in COUNTERPARTS:
        path = root / "volsync_tpu_torch" / rel
        line = next(i for i, ln in enumerate(
            path.read_text().splitlines(), 1) if text in ln)
        assert (f"volsync_tpu_torch/{rel}", line, code) in got, (rel, text)
