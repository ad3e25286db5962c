"""The port's device-facing lint families against the reference's, and
the chunker's bench hooks, on the CPU.

VL004 (``rules.TracerSafetyRule``), VL104 (``iprules.TracerTaintRule``)
and bufflow's device half (VL501, VL502, VL504) recognise torch in the
port and jnp/lax/jax.jit in the reference, and the fixture package may
not change: each case writes a torch translation of the reference's
input into ``tmp_path`` — the VL004 snippet of ``tests/test_analysis.py``,
``miniproj/ops/{kern,helpers}.py`` and ``miniproj/buf/{loop,donate,
engine/hot}.py``, line for line, with the same ``MARK:`` lines — and the
reference's linter on the original and the port's on the translation
must report the same codes, lines, severities, spans and hop chains,
their messages equal once ``NAMES`` maps the library's constructs. The
one difference by design: torch donates no buffer, so VL504 finds the
reference's two reads after donation and nothing in the port. Then the
port's own notions case by case (what a compiled function and its
traced parameters are; when a value is on the card), and
``DeviceChunkHasher.process_device`` with its two hooks against
``process`` and against the reference's ``process_device``.
"""

import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from volsync_tpu.analysis import run_lint as j_run_lint
from volsync_tpu.analysis import run_project as j_run_project
from volsync_tpu_torch.analysis import run_lint, run_project

FIXTURES = Path(__file__).resolve().parent / "analysis_fixtures"
MINIPROJ = FIXTURES / "miniproj"

#: the reference's names of the library's constructs -> the port's
NAMES = [
    ("jit'd", "compiled"),
    ("lax.cond/lax.select", "torch.where/torch.cond"),
    ("device array from jnp.", "device tensor from torch."),
    ("jnp.asarray(c)", 'c.to("cuda")'),
    ("jnp.square(c)", "torch.square(c)"),
]

#: fixture relpath -> (old, new) replacements, each on one line, that
#: translate the reference's file to torch line for line
TRANSLATE = {
    "ops/kern.py": [
        ("import jax\n", "import torch\n"),
        ('@functools.partial(jax.jit, static_argnames=("n",))',
         "@functools.partial(torch.compile, dynamic=False)"),
        ("def kernel(x, n):", "def kernel(x, n: int):"),
    ],
    "ops/helpers.py": [],
    "buf/engine/hot.py": [
        ("import jax.numpy as jnp\nimport numpy as np\n",
         "import numpy as np\nimport torch\n"),
        ("jnp.square(dev)", "torch.square(dev.cuda())"),
        ("jnp.sum(dev)", "torch.sum(dev.cuda())"),
        ("rows = jnp.reshape(dev, (-1, 32))\n    return",
         "rows = torch.reshape(dev.cuda(), (-1, 32))\n    return"),
        ("rows = jnp.reshape(dev, (-1, 32))\n    out",
         "rows = torch.reshape(dev.cuda(), (-1, 32))\n    out"),
        ("jnp.cumsum(dev)", "torch.cumsum(dev.cuda(), 0)"),
    ],
    "buf/loop.py": [
        ("import jax\nimport jax.numpy as jnp\n",
         "import torch\nfrom torch._higher_order_ops import scan\n"),
        ("out.append(jnp.asarray(c))", 'out.append(c.to("cuda"))'),
        ("[jnp.square(c) for c in chunks]",
         "[torch.square(c) for c in chunks.cuda()]"),
        ("return jnp.asarray(chunks)",
         'return torch.as_tensor(chunks, device="cuda")'),
        ("x + jnp.roll(x, m)", "x + torch.roll(x.cuda(), m)"),
        ("carry + jnp.add(x, off)", "carry + torch.add(x.cuda(), off)"),
        ("jax.lax.scan(step, jnp.uint8(0), xs)",
         "scan(step, torch.zeros((), dtype=torch.uint8), xs)"),
    ],
    "buf/donate.py": [
        ("import jax\nimport jax.numpy as jnp\n", "import torch\n\n"),
        ("twin = jax.jit(_impl)", "twin = torch.compile(_impl)"),
        ("functools.partial(jax.jit, donate_argnums=(0,))(_impl)",
         "functools.partial(torch.compile, dynamic=False)(_impl)"),
        ("dev = jnp.asarray(rows)\n    out = twin_donated(dev)",
         'dev = torch.as_tensor(rows, device="cuda")\n'
         "    out = twin_donated(dev)"),
        ("dev = jnp.asarray(rows)\n    out = helper_hash",
         'dev = torch.as_tensor(rows, device="cuda")\n'
         "    out = helper_hash"),
        ("dev = jnp.asarray(rows)\n    out = twin(dev)",
         'dev = torch.as_tensor(rows, device="cuda")\n'
         "    out = twin(dev)"),
        ("twin_donated(jnp.asarray(rows))",
         'twin_donated(torch.as_tensor(rows, device="cuda"))'),
        ("dev = jnp.asarray(rows)\n    out = twin_donated(dev)\n"
         "    dev = jnp.asarray(out)",
         'dev = torch.as_tensor(rows, device="cuda")\n'
         "    out = twin_donated(dev)\n"
         '    dev = torch.as_tensor(out, device="cuda")'),
    ],
}


def translate(rel: str) -> str:
    src = (MINIPROJ / rel).read_text()
    for old, new in TRANSLATE[rel]:
        assert old in src, (rel, old)
        assert old.count("\n") == new.count("\n")
        src = src.replace(old, new, 1)
    assert not re.search(r"\bjnp\.|\bjax\.", src.split('"""', 2)[-1]), rel
    return src


def write_port(root: Path, rels) -> Path:
    """Translations of ``rels`` under ``root/miniproj`` (the ledger
    module copied as it is), every package with an ``__init__.py``."""
    pkg = root / "miniproj"
    for rel in rels:
        f = pkg / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(translate(rel))
    ledger = pkg / "obs" / "copyledger.py"
    ledger.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(MINIPROJ / "obs" / "copyledger.py", ledger)
    for d in [pkg, *[p for p in pkg.rglob("*") if p.is_dir()]]:
        (d / "__init__.py").touch()
    return pkg


def _map(text: str) -> str:
    for a, b in NAMES:
        text = text.replace(a, b)
    return text


def _span(f) -> str:
    if not f.col:
        return ""
    lines = Path(f.path).read_text().splitlines()
    if f.end_line == f.line:
        return lines[f.line - 1][f.col - 1:f.end_col - 1]
    return lines[f.line - 1][f.col - 1:]


def rows(findings, mapped: bool) -> list:
    """(path under the package, line, code, severity, span, message),
    the package's location dropped from paths and messages."""
    out = []
    for f in findings:
        rel = f.path.split("miniproj/", 1)[1]
        msg = re.sub(r"[^\s\[(]*miniproj/", "miniproj/", f.message)
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
def runs(tmp_path_factory):
    pkg = write_port(tmp_path_factory.mktemp("port"), TRANSLATE)
    port = run_project([str(pkg)])
    ref = j_run_project([str(MINIPROJ)])
    assert port.errors == [] and ref.errors == []
    return pkg, port.findings, ref.findings


# -- the translated fixtures on both linters ---------------------------------

@pytest.mark.parametrize("code,rel", [
    ("VL104", "ops/kern.py"), ("VL501", "buf/engine/hot.py"),
    ("VL502", "buf/loop.py"), ("VL004", "ops/kern.py")])
def test_fixture_findings_equal_the_reference(runs, code, rel):
    pkg, port, ref = runs
    got = rows([f for f in port if f.code == code], mapped=False)
    want = rows([f for f in ref if f.code == code
                 and f.path.endswith(rel)], mapped=True)
    assert got == want
    if code != "VL004":  # VL104 covers the fixture's jit'd kernel
        assert got, code


def test_translated_files_report_nothing_else(runs):
    """Every finding the port makes on the translations is one the
    reference makes on the originals (VL505 aside: the copied ledger's
    sites have no record_copy in this slice of the package)."""
    pkg, port, ref = runs
    codes = {f.code for f in port} - {"VL505"}
    assert codes == {"VL104", "VL501", "VL502"}


def test_marked_lines(runs):
    pkg, port, _ = runs
    by = {(f.path.split("miniproj/", 1)[1], f.line) for f in port
          if f.code != "VL505"}
    kern, hot, loop = (pkg / r for r in ("ops/kern.py",
                                         "buf/engine/hot.py",
                                         "buf/loop.py"))
    assert by == {
        ("ops/kern.py", _mark_line(kern, m))
        for m in ("taint-via-route", "derived-branch", "taint-direct")} | {
        ("buf/engine/hot.py", _mark_line(hot, m))
        for m in ("sync-float", "sync-item", "sync-asarray")} | {
        ("buf/loop.py", _mark_line(loop, m))
        for m in ("loop-dispatch", "comp-dispatch")}


def test_vl104_hop_chain(runs):
    pkg, port, _ = runs
    kern = pkg / "ops" / "kern.py"
    (via,) = [f for f in port if f.code == "VL104"
              and f.line == _mark_line(kern, "taint-via-route")]
    assert "via route() -> decide()" in via.message
    assert "inside compiled kernel()" in via.message


def test_vl504_is_silent_where_the_reference_finds_donation(runs):
    """The documented difference: the reference reports its fixture's
    two reads after donation; torch has no donation, so the port's
    VL504 reports nothing on the translation (and nothing anywhere)."""
    pkg, port, ref = runs
    don = MINIPROJ / "buf" / "donate.py"
    assert {f.line for f in ref if f.code == "VL504"} == {
        _mark_line(don, "donate-read"), _mark_line(don, "helper-donate-read")}
    assert [f for f in port if f.code == "VL504"] == []
    assert [f for f in port if f.path.endswith("donate.py")] == []


VL004_REF = (
    "import functools\n"
    "import jax\n"
    "@functools.partial(jax.jit, static_argnames=('n',))\n"
    "def f(x, n):\n"
    "    if x > 0:\n"
    "        return float(x)\n"
    "    if n > 2:\n"
    "        return x.item()\n"
    "    if x.shape[0] == 1:\n"
    "        return x\n"
    "    if x is None:\n"
    "        return x\n"
    "    return x\n"
    "def host(x):\n"
    "    return float(x)\n"
)
VL004_PORT = (VL004_REF
              .replace("import jax\n", "import torch\n")
              .replace("@functools.partial(jax.jit, static_argnames=('n',))",
                       "@functools.partial(torch.compile, dynamic=False)")
              .replace("def f(x, n):", "def f(x, n: int):"))


@pytest.mark.parametrize("subdir,lines", [("ops", {5, 6, 8}),
                                          ("host", set())])
def test_vl004_snippet_equals_the_reference(tmp_path, subdir, lines):
    got, want = [], []
    for src, lint, out in ((VL004_PORT, run_lint, got),
                           (VL004_REF, j_run_lint, want)):
        d = tmp_path / ("port" if lint is run_lint else "ref") / subdir
        d.mkdir(parents=True)
        (d / "mod.py").write_text(src)
        findings, errors = lint([str(d / "mod.py")])
        assert errors == []
        out += [(f.line, f.code, _span(f), f.severity,
                 f.message if lint is run_lint else _map(f.message))
                for f in findings]
    assert sorted(got) == sorted(want)
    assert {line for line, *_ in got} == lines
    assert all(code == "VL004" for _, code, *_ in got)


# -- the port's notions, case by case -------------------------------------------

#: VL004: (source, expected lines) in an ops/ file
TRACED = {
    "compile-binding": ("import torch\n"
                        "def k(x):\n"
                        "    return x.item()\n"
                        "kc = torch.compile(k)\n", {3}),
    "jit-script": ("import torch\n"
                   "@torch.jit.script\n"
                   "def k(x):\n"
                   "    return float(x)\n", {4}),
    "compile-called": ("import torch\n"
                       "@torch.compile(fullgraph=True)\n"
                       "def k(x):\n"
                       "    return x.tolist()\n", {4}),
    "graphed": ("import torch\n"
                "def k(x):\n"
                "    if x.sum() > 0:\n"
                "        return x\n"
                "    return -x\n"
                "g = torch.cuda.make_graphed_callables(k, (torch.ones(2),))\n",
                {3}),
    "cond-bodies": ("import torch\n"
                    "def t(x):\n"
                    "    return x.item()\n"
                    "def e(x):\n"
                    "    return x\n"
                    "def f(p, x):\n"
                    "    return torch.cond(p, t, e, (x,))\n", {3}),
    "while-loop-body": ("from torch._higher_order_ops import while_loop\n"
                        "def c(i, x):\n"
                        "    return i < 3\n"
                        "def b(i, x):\n"
                        "    while x > 0:\n"
                        "        x = x - 1\n"
                        "    return i + 1, x\n"
                        "def f(x):\n"
                        "    return while_loop(c, b, (x, x))\n", {5}),
    "statics-exempt": ("import torch\n"
                       "@torch.compile\n"
                       "def k(x, n: int, flag=True, tag: str = 'a'):\n"
                       "    if n > 2 and flag and tag:\n"
                       "        return int(n)\n"
                       "    if x.device.type == 'cuda' or x.ndim == 1:\n"
                       "        return x\n"
                       "    return x\n", set()),
    "not-compiled": ("import torch\n"
                     "def k(x):\n"
                     "    if x > 0:\n"
                     "        return x.item()\n"
                     "    return float(x)\n", set()),
    "jax-jit-is-not-torch": ("import jax\n"
                             "@jax.jit\n"
                             "def k(x):\n"
                             "    return x.item()\n", set()),
}


@pytest.mark.parametrize("case", sorted(TRACED))
def test_vl004_traced_notion(tmp_path, case):
    src, lines = TRACED[case]
    d = tmp_path / "ops"
    d.mkdir()
    (d / "mod.py").write_text(src)
    findings, errors = run_lint([str(d / "mod.py")])
    assert errors == []
    assert {f.line for f in findings if f.code == "VL004"} == lines


KERNEL_MOD = (
    "import torch\n"
    "from miniproj.ops._build import Kernel\n"
    "K = Kernel('k', 'k.cu', 'vt_k', [])\n"
    "def wrap(x):\n"
    "    out = torch.empty_like(x)\n"
    "    K.launch(x.device, x.data_ptr(), out.data_ptr())\n"
    "    return out\n"
)

#: (engine/ source, expected [(line, code)]) — ``wrap`` is a kernel
#: wrapper of ``ops/k.py`` (KERNEL_MOD)
DEVICE = {
    "wrapper-result": ("from miniproj.ops.k import wrap\n"
                       "def f(x):\n"
                       "    return int(wrap(x).sum())\n", [(3, "VL501")]),
    "sinks": ("import torch\n"
              "def f(n, dev):\n"
              "    a = torch.zeros(n, device=dev)\n"
              "    b = a.tolist()\n"
              "    c = a.cpu()\n"
              "    d = c.numpy()\n"
              "    return a.item(), bool(a.any())\n",
              [(4, "VL501"), (5, "VL501"), (7, "VL501"), (7, "VL501")]),
    "cpu-is-host": ("import torch\n"
                    "def f(n, x):\n"
                    "    a = torch.zeros(n, device='cpu')\n"
                    "    b = x.to('cpu')\n"
                    "    c = x.to(torch.int64)\n"
                    "    d = torch.from_numpy(x)\n"
                    "    return a.item(), b.item(), c.item(), d.tolist()\n",
                    []),
    "unknown-device": ("def f(x):\n"
                       "    return x.item(), float(x.sum())\n", []),
    "loop-upload": ("import torch\n"
                    "def f(arrs, dev):\n"
                    "    out = []\n"
                    "    for a in arrs:\n"
                    "        out.append(torch.from_numpy(a).to(dev))\n"
                    "    return out\n", [(5, "VL502")]),
    "loop-wrapper": ("from miniproj.ops.k import wrap\n"
                     "def f(rows):\n"
                     "    return [wrap(r) for r in rows]\n",
                     [(3, "VL502")]),
    "loop-on-host": ("import torch\n"
                     "def f(arrs):\n"
                     "    return [torch.from_numpy(a).sum() for a in arrs]\n",
                     []),
    "loop-compiled": ("import torch\n"
                      "@torch.compile\n"
                      "def f(xs):\n"
                      "    acc = xs[0]\n"
                      "    for x in xs:\n"
                      "        acc = acc + x.cuda()\n"
                      "    return acc\n", []),
    "staging-site": ("import numpy as np\n"
                     "from miniproj.obs.copyledger import record_copy\n"
                     "def f(x):\n"
                     "    rows = x.cuda()\n"
                     "    out = np.asarray(rows)\n"
                     "    record_copy('fix.stage', out.nbytes)\n"
                     "    return out\n", []),
}


@pytest.mark.parametrize("case", sorted(DEVICE))
def test_device_provenance(tmp_path, case):
    src, want = DEVICE[case]
    pkg = tmp_path / "miniproj"
    for d in (pkg, pkg / "ops", pkg / "engine", pkg / "obs"):
        d.mkdir(parents=True, exist_ok=True)
        (d / "__init__.py").touch()
    (pkg / "ops" / "k.py").write_text(KERNEL_MOD)
    (pkg / "ops" / "_build.py").write_text("class Kernel:\n    pass\n")
    shutil.copy(MINIPROJ / "obs" / "copyledger.py",
                pkg / "obs" / "copyledger.py")
    (pkg / "engine" / "mod.py").write_text(src)
    res = run_project([str(pkg)])
    assert res.errors == []
    got = sorted((f.line, f.code) for f in res.findings
                 if f.path.endswith("engine/mod.py")
                 and f.code in ("VL501", "VL502"))
    assert got == sorted(want), [f.render() for f in res.findings]
    if case == "wrapper-result":
        (f,) = [f for f in res.findings if f.code == "VL501"]
        assert "kernel wrapper wrap()" in f.message


# -- DeviceChunkHasher.process_device and the bench hooks ---------------------

@pytest.mark.parametrize("align", [64, 4096])
def test_process_device_and_hooks(align):
    import jax.numpy as jnp

    from volsync_tpu.engine import chunker as jc
    from volsync_tpu.ops.gearcdc import GearParams as JGearParams
    from volsync_tpu_torch.engine import chunker as tc
    from volsync_tpu_torch.ops import gearcdc as tg
    from volsync_tpu_torch.ops import sha256 as tsha

    rng = np.random.RandomState(20 + align)
    data = rng.randint(0, 256, 300_000).astype(np.uint8)
    kw = dict(min_size=8192, avg_size=32768, max_size=131072, seed=7,
              align=align)
    p = tg.GearParams(**kw)
    padded = np.zeros(tc._buffer_bucket(len(data)), np.uint8)
    padded[:len(data)] = data

    h = tc.DeviceChunkHasher(p, device="cpu")
    want = h.process(data)
    got = h.process_device(torch.from_numpy(padded), len(data))
    assert got == want and len(want) > 2
    ref = jc.DeviceChunkHasher(JGearParams(**kw)).process_device(
        jnp.asarray(padded), len(data))
    assert got == [tuple(c) for c in ref]

    calls = {"leaf": 0, "cand": 0}

    def leaf(*a, **k):
        calls["leaf"] += 1
        return tsha.sha256_leaves_device(*a, **k)

    def cand(dev, cap):
        calls["cand"] += 1
        return tg.cdc_candidates_aligned_packed(
            dev, seed=p.seed, mask_s=p.mask_s, mask_l=p.mask_l,
            align=p.align, max_candidates=cap, valid_len=len(data))

    spied = tc.DeviceChunkHasher(p, device="cpu")
    spied.leaf_device_fn = leaf
    spied.cand_device_fn = cand
    assert spied.process_device(torch.from_numpy(padded),
                                len(data)) == want
    # the hooks replace the split-phase path's launches; the fused pass
    # (align 4096) runs its own, as in the reference
    n = 1 if align < 4096 else 0
    assert calls == {"leaf": n, "cand": n}
    assert tc.DeviceChunkHasher.leaf_device_fn is None
    assert tc.DeviceChunkHasher.cand_device_fn is None
