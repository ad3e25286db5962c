"""The port's shape/dtype interpreter (``volsync_tpu_torch/analysis/
shapes.py`` over ``absdomain.py``) against the reference's, on the CPU.

The reference's fixture package may not change, so each case writes a
torch translation of ``analysis_fixtures/miniproj/kernels/{kern,
helpers}.py`` and ``parallel/mesh.py`` into ``tmp_path`` with the same
``MARK:`` lines: the reference's linter on the original and the port's
on the translation report the same codes, marked lines, severities,
spans and hop chains, and messages equal once ``NAMES`` maps the
library's constructs (and the one lattice difference: torch refuses
uint32 + int32 where JAX widens it to int64). Then torch's lattice held
against the live torch (``promote`` over every pair of dtypes it names,
Python scalars and zero-dim tensors included, and the uint32 ops the CPU
refuses), the dims and broadcasting against the reference's and
``torch.broadcast_shapes``, the interpreter's torch idiom case by case,
the cache's shape summaries, ``--select``/``--ignore`` and SARIF
regions as ``tests/test_analysis_shapes.py`` checks them.
"""

import itertools
import json
import re
from pathlib import Path

import pytest
import torch

from volsync_tpu.analysis import absdomain as JD
from volsync_tpu.analysis import run_project as j_run_project
from volsync_tpu_torch.analysis import absdomain as D
from volsync_tpu_torch.analysis import run_lint, run_project
from volsync_tpu_torch.analysis.cli import filter_rules
from volsync_tpu_torch.analysis.cli import main as lint_main
from volsync_tpu_torch.analysis.shapes import default_shape_rules

FIXTURES = Path(__file__).resolve().parent / "analysis_fixtures"
MINIPROJ = FIXTURES / "miniproj"

KERN = '''\
"""Seeded VL201-VL205 true positives (torch), each next to a clean twin
the rules must stay silent on. Parsed only, never imported."""
import torch
from torch import vmap
from torch._higher_order_ops import scan


from miniproj.kernels.helpers import mix, mix_ok
from miniproj.parallel.mesh import SEQ_AXIS


def vl201_bad():
    a = torch.zeros((4, 8), dtype=torch.uint32)
    b = torch.ones((4, 7), dtype=torch.uint32)
    return a + b  # MARK: vl201-bad


def vl201_ok():
    a = torch.zeros((4, 8), dtype=torch.uint32)
    b = torch.ones((4, 8), dtype=torch.uint32)
    return a + b


def vl202_bad():
    h = torch.zeros((128,), dtype=torch.uint32)
    step = torch.arange(128, dtype=torch.int32)
    return mix(h, step)  # MARK: vl202-bad


def vl202_ok():
    h = torch.zeros((128,), dtype=torch.uint32)
    step = torch.arange(128, dtype=torch.int32)
    return mix_ok(h, step)


def vl203_bad():
    def body(c, x):
        return c + 0.5, x.clone()

    init = torch.zeros((8,), dtype=torch.int32)
    xs = torch.zeros((16, 8), dtype=torch.int32)
    return scan(body, init, xs)  # MARK: vl203-bad


def vl203_ok():
    def body(c, x):
        return c + 1, x.clone()

    init = torch.zeros((8,), dtype=torch.int32)
    xs = torch.zeros((16, 8), dtype=torch.int32)
    return scan(body, init, xs)


def _pair(a, b):
    return a + b


def vl204_bad(x, y):
    return vmap(_pair, in_dims=(0, 0, 0))(x, y)  # MARK: vl204-bad


def vl204_ok(x, y):
    return vmap(_pair, in_dims=(0, 0))(x, y)


def vl205_bad(mesh, k):
    return mesh.axis_index(k, "sq")  # MARK: vl205-bad


def vl205_ok(mesh, k):
    return mesh.axis_index(k, SEQ_AXIS)
'''

HELPERS = '''\
"""Hash-state helpers for the VL202 interprocedural fixture: ``mix``
adds a strong int32 step to uint32 hash state (a promotion torch
refuses); ``mix_ok`` casts explicitly. Parsed only, never
imported."""
import torch


def mix(h, step):
    return h * 33 + step  # MARK: vl202-sink


def mix_ok(h, step):
    return h * 33 + step.to(torch.uint32)
'''

MESH = '''\
"""Declared mesh axes the VL205 rule checks against: the port's mesh
API in miniature. Parsed only, never imported."""
import torch

WAVE_AXIS = "wave"
SEQ_AXIS = "seq"


class Mesh:
    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    def axis_index(self, k, axis):
        return k % len(self.devices[self.axis_names.index(axis)])


def build_mesh(devices, shape, axis_names):
    return Mesh(devices, axis_names)


def make_mesh(devices):
    return build_mesh(devices, (1, len(devices)), (WAVE_AXIS, SEQ_AXIS))
'''

#: the reference's names of the library's constructs -> the port's (and
#: the lattice's one difference)
NAMES = [
    ("lax.scan(body, init, xs)", "scan(body, init, xs)"),
    ("jax.vmap", "vmap"),
    ("lax.scan", "scan"),
    ("in_axes", "in_dims"),
    ("lax.psum", "axis_index"),
    ("uint32 -> int64", "uint32 -> unsupported"),
    (".astype", ".to"),
]


def _map(text: str) -> str:
    for a, b in NAMES:
        text = text.replace(a, b)
    return text


def write_miniproj(root: Path, files: dict) -> Path:
    """A ``miniproj`` package under ``root`` holding ``files`` (relpath
    -> source), with every package's ``__init__.py``."""
    pkg = root / "miniproj"
    for rel, src in files.items():
        f = pkg / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(src)
    for d in [pkg, *[p for p in pkg.rglob("*") if p.is_dir()]]:
        (d / "__init__.py").touch()
    return pkg


def _span(f) -> str:
    lines = Path(f.path).read_text().splitlines()
    if f.end_line == f.line:
        return lines[f.line - 1][f.col - 1:f.end_col - 1]
    return "\n".join([lines[f.line - 1][f.col - 1:]]
                     + lines[f.line:f.end_line - 1]
                     + [lines[f.end_line - 1][:f.end_col - 1]])


def rows(findings, mapped: bool) -> list:
    """(path under the package, line, code, severity, span, message),
    the package's location dropped from paths and messages."""
    out = []
    for f in findings:
        rel = f.path.split("miniproj/", 1)[1]
        msg = re.sub(r"[^\s\[]*miniproj/", "miniproj/", f.message)
        span = _span(f)
        if mapped:
            msg, span = _map(msg), _map(span)
        out.append((rel, f.line, f.code, f.severity, span, msg))
    return sorted(out)


def _mark_line(path: Path, marker: str) -> int:
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        if f"MARK: {marker}" in line:
            return i
    raise AssertionError(f"marker {marker!r} not in {path}")


@pytest.fixture(scope="module")
def vl2_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("port")
    pkg = write_miniproj(root, {"kernels/kern.py": KERN,
                                "kernels/helpers.py": HELPERS,
                                "parallel/mesh.py": MESH})
    port = run_project([str(pkg)])
    ref = j_run_project([str(MINIPROJ)])
    assert port.errors == [] and ref.errors == []
    vl2 = [f for f in port.findings if f.code.startswith("VL2")]
    jvl2 = [f for f in ref.findings if f.code.startswith("VL2")]
    return pkg, vl2, jvl2


# -- the translated fixture on both linters -----------------------------------

@pytest.mark.parametrize("code", ["VL201", "VL202", "VL203", "VL204",
                                  "VL205"])
def test_fixture_findings_equal_the_reference(vl2_runs, code):
    pkg, port, ref = vl2_runs
    got = rows([f for f in port if f.code == code], mapped=False)
    want = rows([f for f in ref if f.code == code], mapped=True)
    assert len(got) == 1
    assert got == want


def test_marked_lines_and_clean_twins(vl2_runs):
    pkg, port, _ = vl2_runs
    kern = pkg / "kernels" / "kern.py"
    assert {f.line for f in port} == {
        _mark_line(kern, f"vl20{i}-bad") for i in range(1, 6)}
    assert all(f.path.endswith("kernels/kern.py") for f in port)


def test_vl202_hop_chain_names_the_sink(vl2_runs):
    pkg, port, _ = vl2_runs
    (f,) = [f for f in port if f.code == "VL202"]
    helpers = pkg / "kernels" / "helpers.py"
    assert "uint32 -> unsupported" in f.message
    assert "via mix()" in f.message
    assert f"helpers.py:{_mark_line(helpers, 'vl202-sink')}" in f.message
    assert f.severity == "warning"


def test_fixture_package_of_the_reference_is_silent_on_the_port():
    """The port's shape rules recognise torch, not jnp/lax: the
    reference's own fixture package gives them nothing."""
    res = run_project([str(MINIPROJ)])
    assert [f for f in res.findings if f.code.startswith("VL2")] == []


# -- absdomain: torch's lattice against the live torch -------------------------

def _live(fn):
    try:
        return str(fn()).replace("torch.", "")
    except RuntimeError:
        return D.UNSUPPORTED


TIERS = {"dim": (2,), "zero": ()}
SCALARS = {"bool": True, "int": 3, "float": 1.5, "complex": 1j}


@pytest.mark.parametrize("a", D.DTYPES)
def test_promote_types_matches_torch(a):
    for b in D.DTYPES:
        want = _live(lambda: torch.promote_types(getattr(torch, a),
                                                 getattr(torch, b)))
        assert D.promote_types(a, b) == want, (a, b)


@pytest.mark.parametrize("a", D.DTYPES)
def test_promote_matches_result_type(a):
    """Every pair of tensors (dimensioned or zero-dim) and every tensor
    against every kind of Python scalar, both operand orders."""
    for b in D.DTYPES:
        for (ta, sa), (tb, sb) in itertools.product(TIERS.items(),
                                                    repeat=2):
            want = _live(lambda: torch.result_type(
                torch.zeros(sa, dtype=getattr(torch, a)),
                torch.zeros(sb, dtype=getattr(torch, b))))
            got, weak = D.promote(a, False, b, False, ta == "zero",
                                  tb == "zero")
            assert (got, weak) == (want, False), (a, ta, b, tb)
    for ta, sa in TIERS.items():
        for kind, value in SCALARS.items():
            want = _live(lambda: torch.result_type(
                torch.zeros(sa, dtype=getattr(torch, a)), value))
            s = D.SCALAR_DTYPE[kind]
            assert D.promote(a, False, s, True, ta == "zero")[0] == want
            assert D.promote(s, True, a, False, False,
                             ta == "zero")[0] == want


def test_promote_unknown_rank_decides_only_where_tiers_agree():
    # uint32 against int64 of unknown rank: a dimensioned int64 raises, a
    # zero-dim one adapts -> Unknown, never a guess
    assert D.promote("uint32", False, "int64", False, False, None) == (
        None, False)
    # int32 against float64 of unknown rank: float64 either way
    assert D.promote("int32", False, "float64", False, False, None) == (
        "float64", False)
    assert D.promote(None, False, "uint32", False) == (None, False)


def test_uint32_cpu_refusals_match_torch():
    a = torch.tensor([5, 7, 9], dtype=torch.uint32)
    b = torch.tensor([1, 2, 3], dtype=torch.uint32)
    calls = D.uint32_op_calls(torch, a, b)
    assert D.UINT32_CPU_REFUSED <= set(calls)
    for name, call in calls.items():
        try:
            call()
            refused = False
        except NotImplementedError:
            refused = True
        assert refused == (name in D.UINT32_CPU_REFUSED), name


def test_canon_dtype_names_torchs_dtypes():
    for name in D.DTYPES:
        assert str(getattr(torch, name)) == f"torch.{name}"
    for alias in ("half", "float", "double", "short", "int", "long",
                  "chalf", "cfloat", "cdouble"):
        want = str(getattr(torch, alias)).replace("torch.", "")
        assert D.canon_dtype(alias) == want


# -- dims and broadcasting -----------------------------------------------------

SHAPES = [(), (1,), (3,), (4, 1), (4, 7), (4, 8), (1, 8), (2, 4, 8),
          (5, 1, 1), (0,), (0, 8)]


@pytest.mark.parametrize("a,b", list(itertools.product(SHAPES, repeat=2)))
def test_broadcast_matches_reference_and_torch(a, b):
    got = D.broadcast_shapes(a, b)
    assert got == JD.broadcast_shapes(a, b)
    shape, conflict = got
    try:
        want = tuple(torch.broadcast_shapes(a, b))
    except RuntimeError:
        want = None
    if want is None:
        assert conflict is not None
    else:
        assert conflict is None and shape == want


def test_symbolic_dims_equal_the_reference():
    n = D.sym("n")
    cases = [(D.broadcast_shapes, ((n, 8), (3, 8))),
             (D.broadcast_shapes, (None, (4,))),
             (D.dim_binop, ("add", n, 1)), (D.dim_binop, ("add", 2, 3)),
             (D.dim_binop, ("add", n, 0)), (D.dim_binop, ("floordiv", n,
                                                          None)),
             (D.dim_binop, ("mul", 1, n)), (D.dim_binop, ("mod", 7, 0)),
             (D.numel, ((2, 3, 4),)), (D.numel, ((2, n),)),
             (D.shape_str, ((4, n, None),)), (D.join_shape, ((4, 8),
                                                             (4, 7)))]
    for fn, args in cases:
        assert fn(*args) == getattr(JD, fn.__name__)(*args), (fn, args)
    assert D.dim_binop("add", n, 1) == D.dim_binop("add", n, 1)


# -- the interpreter on torch's idiom ------------------------------------------

HEAD = "import torch\nfrom torch._higher_order_ops import while_loop\n"

#: (source body, subdir, expected codes) — each file imports torch
IDIOM = {
    "varargs-factory": ("def f():\n"
                        "    a = torch.zeros(4, 8)\n"
                        "    b = torch.ones(4, 7)\n"
                        "    return a + b\n", None, ["VL201"]),
    "matmul": ("def f():\n"
               "    a = torch.ones((4, 8))\n"
               "    b = torch.ones((7, 2))\n"
               "    return a @ b\n", None, ["VL201"]),
    "matmul-ok": ("def f():\n"
                  "    a = torch.ones((4, 8))\n"
                  "    return torch.matmul(a, torch.ones((8, 2)))\n",
                  None, []),
    "view-minus-one": ("def f():\n"
                       "    a = torch.zeros((4, 8))\n"
                       "    return a.view(-1, 3)\n", None, ["VL201"]),
    "reshape-ok": ("def f():\n"
                   "    a = torch.zeros((4, 8))\n"
                   "    return a.reshape(-1, 16) + torch.zeros((2, 16))\n",
                   None, []),
    "cat-dim": ("def f():\n"
                "    a = torch.zeros((4, 8))\n"
                "    b = torch.zeros((3, 7))\n"
                "    return torch.cat([a, b], dim=0)\n", None, ["VL201"]),
    "stack": ("def f():\n"
              "    return torch.stack([torch.zeros(3), torch.zeros(4)])\n",
              None, ["VL201"]),
    "reduce-keepdim": ("def f():\n"
                       "    a = torch.zeros((4, 8))\n"
                       "    s = a.sum(dim=1, keepdim=True)\n"
                       "    return s + torch.zeros((4, 3))\n", None, []),
    "reduce-dim": ("def f():\n"
                   "    a = torch.zeros((4, 8))\n"
                   "    return a.sum(dim=0) + torch.zeros((4,))\n", None,
                   ["VL201"]),
    "weak-int-stays-uint32": ("def f():\n"
                              "    h = torch.zeros(8, dtype=torch.uint32)\n"
                              "    return h * 33 + 1\n", "ops", []),
    "uint32-plus-int64": ("def f():\n"
                          "    h = torch.zeros(8, dtype=torch.uint32)\n"
                          "    s = torch.ones(8, dtype=torch.int64)\n"
                          "    return h + s\n", "ops", ["VL202"]),
    "uint32-plus-float": ("def f():\n"
                          "    h = torch.zeros(8, dtype=torch.uint32)\n"
                          "    return h * 0.5\n", "ops", ["VL202"]),
    "uint32-zero-dim-adapts": (
        "def f():\n"
        "    h = torch.zeros(8, dtype=torch.uint32)\n"
        "    return h + torch.tensor(3, dtype=torch.int64)\n", "ops", []),
    "explicit-to": ("def f():\n"
                    "    h = torch.zeros(8, dtype=torch.uint32)\n"
                    "    s = torch.ones(8, dtype=torch.int64)\n"
                    "    return h.to(torch.int64) + s\n", "ops", []),
    "explicit-long": ("def f():\n"
                      "    h = torch.zeros(8, dtype=torch.uint32)\n"
                      "    s = torch.ones(8, dtype=torch.int64)\n"
                      "    return h.long() + s\n", "ops", []),
    "promotion-outside-ops": ("def f():\n"
                              "    h = torch.zeros(8, dtype=torch.uint32)\n"
                              "    return h + torch.ones(8)\n", "cluster",
                              []),
    "while-loop-drift": ("def body(i, x):\n"
                         "    return i + 1, x * 2.5\n"
                         "def f():\n"
                         "    x = torch.ones(3, dtype=torch.int32)\n"
                         "    return while_loop(lambda i, x: i < 3, body,\n"
                         "                      (torch.tensor(0), x))\n",
                         None, ["VL203"]),
    "while-loop-ok": ("def body(i, x):\n"
                      "    return i + 1, x * 2\n"
                      "def f():\n"
                      "    x = torch.ones(3, dtype=torch.int32)\n"
                      "    return while_loop(lambda i, x: i < 3, body,\n"
                      "                      (torch.tensor(0), x))\n",
                      None, []),
    "cond-branches": ("def t(x):\n"
                      "    return x + torch.zeros(5)\n"
                      "def e(x):\n"
                      "    return x\n"
                      "def f():\n"
                      "    x = torch.ones(4)\n"
                      "    return torch.cond(x.sum() > 0, t, e, (x,))\n",
                      None, ["VL201"]),
    "vmap-rank": ("def g(a):\n"
                  "    return a\n"
                  "def f():\n"
                  "    x = torch.ones(4)\n"
                  "    return torch.func.vmap(g, in_dims=(1,))(x)\n",
                  None, ["VL204"]),
    "device-mesh": ("def f():\n"
                    "    from torch.distributed.device_mesh import "
                    "init_device_mesh\n"
                    "    m = init_device_mesh('cuda', (2,), "
                    "mesh_dim_names=('sq',))\n"
                    "    m['wave']\n"
                    "    return m['rows']\n", None, ["VL205", "VL205"]),
}


@pytest.mark.parametrize("case", sorted(IDIOM))
def test_torch_idiom(tmp_path, case):
    body, subdir, codes = IDIOM[case]
    files = {"parallel/mesh.py": MESH,
             f"{subdir or 'pkg'}/mod.py": HEAD + body}
    pkg = write_miniproj(tmp_path, files)
    res = run_project([str(pkg)])
    assert res.errors == []
    got = sorted(f.code for f in res.findings
                 if f.code.startswith("VL2") and f.path.endswith("mod.py"))
    assert got == sorted(codes), [f.render() for f in res.findings]


def test_mesh_api_of_the_port_is_clean_and_checked(tmp_path):
    """``build_mesh``/``Mesh`` axis names and the ``axis`` arguments of
    the mesh module's functions, in a module that imports the mesh."""
    body = ("from miniproj.parallel.mesh import Mesh, build_mesh, SEQ_AXIS\n"
            "def ok(d, mesh, k):\n"
            "    build_mesh(d, (2,), (SEQ_AXIS,))\n"
            "    return mesh.axis_index(k, 'wave')\n"
            "def bad(d, mesh, k):\n"
            "    Mesh(d, ('wave', 'rows'))\n"
            "    return mesh.axis_index(k, axis='lanes')\n")
    pkg = write_miniproj(tmp_path, {"parallel/mesh.py": MESH,
                                    "pkg/use.py": body})
    res = run_project([str(pkg)])
    msgs = sorted(f.message.split(";")[0] for f in res.findings
                  if f.code == "VL205")
    assert msgs == ["unknown mesh axis 'lanes' in axis_index",
                    "unknown mesh axis 'rows' in Mesh axis_names"]


def test_inline_suppression(tmp_path):
    mod = tmp_path / "k.py"
    mod.write_text(
        "import torch\n"
        "def f():\n"
        "    a = torch.zeros((4, 8), dtype=torch.uint32)\n"
        "    b = torch.ones((4, 7), dtype=torch.uint32)\n"
        "    return a + b  # lint: ignore[VL201] — exercised in a test\n")
    res = run_project([str(mod)])
    assert [f for f in res.findings if f.code == "VL201"] == []


# -- spans, SARIF, --select / --ignore, --list-rules --------------------------

def test_vl201_finding_carries_span(vl2_runs):
    pkg, port, _ = vl2_runs
    (f,) = [f for f in port if f.code == "VL201"]
    src_line = (pkg / "kernels" / "kern.py").read_text().splitlines()[
        f.line - 1]
    assert f.col == src_line.index("a + b") + 1
    assert f.end_line == f.line
    assert src_line[f.col - 1:f.end_col - 1] == "a + b"


def test_sarif_end_regions(tmp_path):
    mod = tmp_path / "k.py"
    mod.write_text(
        "import torch\n"
        "def f():\n"
        "    a = torch.zeros((4, 8), dtype=torch.uint32)\n"
        "    b = torch.ones((4, 7), dtype=torch.uint32)\n"
        "    return a + b\n")
    out_file = tmp_path / "lint.sarif"
    rc = lint_main([str(mod), "--no-baseline", "--format", "sarif",
                    "--out", str(out_file)], out=lambda *_: None)
    assert rc == 1
    doc = json.loads(out_file.read_text())
    (res,) = [r for r in doc["runs"][0]["results"]
              if r["ruleId"] == "VL201"]
    region = res["locations"][0]["physicalLocation"]["region"]
    assert region["startLine"] == 5 and region["endLine"] == 5
    src = mod.read_text().splitlines()[4]
    assert src[region["startColumn"] - 1:region["endColumn"] - 1] \
        == "a + b"
    rule_ids = [r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]]
    for code in ("VL201", "VL202", "VL203", "VL204", "VL205"):
        assert code in rule_ids


def test_filter_rules_by_prefix():
    rules = default_shape_rules()
    assert [r.code for r in filter_rules(rules, ["VL20"], None)] == [
        "VL201", "VL202", "VL203", "VL204", "VL205"]
    assert [r.code for r in filter_rules(rules, None, ["VL202"])] == [
        "VL201", "VL203", "VL204", "VL205"]
    assert filter_rules(rules, ["VL9"], None) == []


def test_cli_select_and_ignore(vl2_runs, tmp_path):
    pkg, _, _ = vl2_runs
    out_file = tmp_path / "report.json"
    rc = lint_main([str(pkg), "--no-baseline", "--select", "VL2",
                    "--format", "json", "--out", str(out_file)],
                   out=lambda *_: None)
    assert rc == 1
    codes = {f["code"]
             for f in json.loads(out_file.read_text())["findings"]}
    assert codes == {"VL201", "VL202", "VL203", "VL204", "VL205"}
    rc = lint_main([str(pkg), "--no-baseline", "--ignore", "VL2",
                    "--format", "json", "--out", str(out_file)],
                   out=lambda *_: None)
    assert rc == 0
    assert json.loads(out_file.read_text())["findings"] == []


def test_cli_list_rules_includes_vl2xx():
    lines = []
    assert lint_main(["--list-rules"], out=lines.append) == 0
    text = "\n".join(lines)
    for code in ("VL201", "VL202", "VL203", "VL204", "VL205"):
        assert code in text


# -- shape summaries in the incremental cache ---------------------------------

def test_shape_summary_cache_invalidation(tmp_path):
    helpers = tmp_path / "helpers.py"
    kern = tmp_path / "kern.py"
    other = tmp_path / "other.py"
    helpers.write_text(
        "import torch\n"
        "def table():\n"
        "    return torch.zeros((4, 8), dtype=torch.uint32)\n")
    kern.write_text(
        "import torch\n"
        "import helpers\n"
        "def use():\n"
        "    return helpers.table() * 3\n")
    other.write_text(
        "import torch\n"
        "def solo():\n"
        "    return torch.ones((2,), dtype=torch.int32)\n")
    cache = tmp_path / ".lint-cache"

    cold = run_project([str(tmp_path)], cache_path=cache)
    assert cold.errors == []
    assert len(cold.analyzed) == 3
    payload = json.loads(cache.read_text())
    entries = payload["files"] if "files" in payload else payload
    entry = next(v for k, v in entries.items() if k.endswith("helpers.py"))
    assert entry["shapes"]["helpers.table"] == "uint32(4, 8)"

    warm = run_project([str(tmp_path)], cache_path=cache)
    assert warm.analyzed == []

    # editing the summary source re-analyzes the helper AND its
    # reverse dependency, but NOT the unrelated module
    helpers.write_text(helpers.read_text().replace("(4, 8)", "(8, 8)"))
    edited = run_project([str(tmp_path)], cache_path=cache)
    assert sorted(Path(p).name for p in edited.analyzed) == [
        "helpers.py", "kern.py"]
    payload = json.loads(cache.read_text())
    entries = payload["files"] if "files" in payload else payload
    entry = next(v for k, v in entries.items() if k.endswith("helpers.py"))
    assert entry["shapes"]["helpers.table"] == "uint32(8, 8)"


def test_port_summaries_render_torch_shapes(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text(
        "import torch\n"
        "def a():\n"
        "    return torch.arange(10)\n"
        "def b():\n"
        "    return torch.zeros(4, 8).sum(dim=1)\n"
        "def c():\n"
        "    return torch.full((3,), 7)\n"
        "def d():\n"
        "    x = torch.zeros((2, 3), dtype=torch.int32)\n"
        "    return x.sum()\n")
    cache = tmp_path / ".lint-cache"
    assert run_lint([str(mod)])[1] == []
    run_project([str(tmp_path)], cache_path=cache)
    payload = json.loads(cache.read_text())
    entries = payload["files"] if "files" in payload else payload
    (entry,) = entries.values()
    assert entry["shapes"] == {"m.a": "int64(10,)", "m.b": "float32(4,)",
                               "m.c": "int64(3,)", "m.d": "int64()"}
