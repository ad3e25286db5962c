"""Buffer-provenance and device-boundary dataflow analysis (VL5xx).

Ports ``volsync_tpu/analysis/bufflow.py``. The zero-copy data plane
moves payload bytes as pooled buffers (engine/bufpool.py) and
memoryviews; the copy ledger (obs/copyledger.py) accounts for the
sanctioned host copies that remain.  VL106 guards that contract
syntactically; this module proves it semantically: an abstract
provenance lattice per value —

* ``pooled``  — a buffer from a BufferPool ``acquire()``;
* ``mview``   — a memoryview/slice over a pooled buffer;
* ``device``  — a tensor on the card.  A tensor's device is a run-time
  value and the port's twins run the same ops on CPU tensors, so a
  value is ``device`` only where the code says so: ``.cuda()``;
  ``.to(x)`` or a factory's ``device=x`` where ``x`` is not literally
  ``"cpu"`` (and ``.to``'s argument is not a dtype); the result of one
  of the port's kernel wrappers (a function that launches a
  ``Kernel`` of ops/_build.py); a ``torch.*`` op or a Tensor method
  applied to a device operand;
* ``host``    — materialized host bytes (``np.asarray`` fetch,
  ``.cpu()``, ``.numpy()``, ``bytes``, ``.tobytes``);
* ``unknown`` — everything else (never produces a finding);

propagated through per-function summaries (returns / param
materializations) over the callgraph, each fact carrying a hop chain
back to its origin.  Five rules ride the model:

* **VL501** implicit device→host sync in a hot scope (``float``/
  ``int``/``bool``/``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/
  ``np.asarray`` on a device value in engine/, ops/ or repo/).  A
  function that ledgers a sanctioned copy (``record_copy(site, n)``
  with ``site`` in ``SANCTIONED_SITES``) is an explicit staging site
  and is exempt — that is where the batched fetch is *supposed* to
  happen.
* **VL502** device dispatch inside a per-item Python loop: a ``torch``
  op, Tensor method or kernel wrapper yielding a device value whose
  operand derives from the loop variable — the anti-pattern the
  batched kernels exist to kill.  Loops in a compiled function or in a
  body handed to ``torch.cond``/``while_loop``/``scan`` (VL004's
  notion) run at trace time and are exempt.
* **VL503** semantic copy: a materialization (``bytes(x)``,
  ``x.tobytes()``, ``b"".join``) whose operand has pooled/mview
  provenance — locally or via a parameter — is a finding unless the
  statement (or an adjacent sibling within ``_SANCTION_SPAN`` lines)
  ledgers it with a sanctioned ``record_copy`` site.
* **VL504** use-after-donate: registered with the reference's code,
  name and description, and silent: torch has no buffer donation and
  the port donates nothing (``UseAfterDonateRule``).
* **VL505** ledger⊆sanction drift: every ``record_copy`` call site
  must name a literal site in ``SANCTIONED_SITES``, and every
  sanctioned site must have at least one call site.

``SANCTIONED_SITES`` is resolved from the AST of ``obs/copyledger.py``
in the linted tree (never hardcoded), falling back to the installed
module's file when the tree under analysis does not include one; VL505
stays silent without a ledger module in the index.  Per-function facts
are cached as the ``"buf"`` fact kind so warm ``--cache`` runs skip
this pass entirely, and ``volsync lint --dump-provenance`` exports the
node/hop-edge JSON for offline diffing.
"""

from __future__ import annotations

import ast
import weakref
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Optional

from volsync_tpu_torch.analysis.absdomain import canon_dtype
from volsync_tpu_torch.analysis.callgraph import (
    FunctionInfo,
    ModuleInfo,
    ProjectIndex,
    attr_chain,
)
from volsync_tpu_torch.analysis.engine import Finding, finding_at
from volsync_tpu_torch.analysis.iprules import _ScopeMaps, _walk_skip_defs
from volsync_tpu_torch.analysis.rules import TracerSafetyRule, _const_str

# -- provenance lattice ------------------------------------------------------

POOLED = "pooled"
MVIEW = "mview"
DEVICE = "device"
HOST = "host"
UNKNOWN = "unknown"

#: join order: a pooled verdict must survive merging with anything
#: weaker, and any concrete tag beats the symbolic param:<i> tags.
_RANK = {POOLED: 5, MVIEW: 4, DEVICE: 3, HOST: 2, UNKNOWN: 0}


@dataclass(frozen=True)
class Prov:
    """One abstract value: lattice tag + hop chain back to the origin
    (human-readable strings, origin first).  Symbolic tags
    ``param:<i>`` / ``paramview:<i>`` stand for "the i-th parameter of
    the function under analysis" until call-site provenance arrives."""

    tag: str
    chain: tuple = ()


UNK = Prov(UNKNOWN)


def _rank(p: Prov) -> int:
    return _RANK.get(p.tag, 1)  # symbolic tags rank above UNKNOWN


def join(a: Prov, b: Prov) -> Prov:
    return a if _rank(a) >= _rank(b) else b


def _param_of(p: Prov) -> Optional[tuple]:
    """(index, is_view) for a symbolic parameter tag, else None."""
    if p.tag.startswith("param:"):
        return int(p.tag.split(":")[1]), False
    if p.tag.startswith("paramview:"):
        return int(p.tag.split(":")[1]), True
    return None


def _hops(chain) -> str:
    return " -> ".join(chain)


# -- sanctioned-site resolution ---------------------------------------------

#: a materialization counts as ledgered when the record_copy sits on
#: the same statement or an adjacent sibling within this many lines
_SANCTION_SPAN = 3

_LEDGER_SUFFIX = "obs/copyledger.py"


def _literal_sites(value: ast.AST) -> dict[str, ast.AST]:
    """{site: element node} from a frozenset({...})/set/list/tuple of
    string constants (the SANCTIONED_SITES shape)."""
    if isinstance(value, ast.Call) and value.args:
        value = value.args[0]
    out: dict[str, ast.AST] = {}
    if isinstance(value, (ast.Set, ast.List, ast.Tuple)):
        for e in value.elts:
            s = _const_str(e)
            if s is not None:
                out[s] = e
    return out


def _sites_from_tree(tree: ast.AST) -> Optional[dict[str, ast.AST]]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "SANCTIONED_SITES":
                    return _literal_sites(node.value)
    return None


def ledger_module(index: ProjectIndex) -> Optional[ModuleInfo]:
    for rp in sorted(index.by_relpath):
        if rp == _LEDGER_SUFFIX or rp.endswith("/" + _LEDGER_SUFFIX):
            return index.by_relpath[rp]
    return None


_installed_cache: dict[str, frozenset] = {}


def installed_sanctioned_sites() -> frozenset:
    """SANCTIONED_SITES parsed from the installed copyledger file — the
    fallback used when the linted tree has no obs/copyledger.py (and by
    the per-file VL106 rule, which has no project index)."""
    path = Path(__file__).resolve().parent.parent / "obs" / "copyledger.py"
    key = str(path)
    if key not in _installed_cache:
        try:
            sites = _sites_from_tree(ast.parse(path.read_text(
                encoding="utf-8")))
        except (OSError, SyntaxError, ValueError):
            sites = None
        _installed_cache[key] = frozenset(sites or ())
    return _installed_cache[key]


def _is_record_copy(call: ast.Call) -> bool:
    chain = attr_chain(call.func)
    return bool(chain) and chain[-1] == "record_copy"


def _record_site(call: ast.Call) -> Optional[str]:
    """Literal site name of a record_copy call, else None."""
    arg = call.args[0] if call.args else next(
        (kw.value for kw in call.keywords if kw.arg == "site"), None)
    return _const_str(arg) if arg is not None else None


def statement_sanctioned(stmt: ast.stmt, block: Optional[list],
                         sites: frozenset) -> Optional[str]:
    """Site name when ``stmt`` is ledgered: itself or an adjacent
    sibling statement within ``_SANCTION_SPAN`` lines carries a
    ``record_copy`` with a literal sanctioned site.  Shared by VL503
    and the per-file VL106 rule, so their verdicts can never drift."""
    candidates = [stmt]
    if block is not None and stmt in block:
        i = block.index(stmt)
        for sib in block[max(0, i - 1): i + 2]:
            if sib is not stmt and abs(
                    sib.lineno - stmt.lineno) <= _SANCTION_SPAN:
                candidates.append(sib)
    for cand in candidates:
        for node in ast.walk(cand):
            if isinstance(node, ast.Call) and _is_record_copy(node):
                site = _record_site(node)
                if site is not None and site in sites:
                    return site
    return None


_COMPOUND_STMTS = (ast.If, ast.While, ast.For, ast.AsyncFor, ast.With,
                   ast.AsyncWith, ast.Try, ast.FunctionDef,
                   ast.AsyncFunctionDef, ast.ClassDef)


def _child_blocks(stmt: ast.stmt) -> Iterator[list]:
    for name in ("body", "orelse", "finalbody"):
        blk = getattr(stmt, name, None)
        if blk:
            yield blk
    for h in getattr(stmt, "handlers", ()):
        yield h.body


def sanctioned_lines(tree: ast.Module,
                     sites: Optional[frozenset] = None) -> set:
    """1-based line numbers covered by statements whose copies are
    ledgered (``statement_sanctioned``).  The per-file bridge VL106
    consults: a syntactic copy on one of these lines is semantically
    sanctioned, so the blanket same-line suppressions that merely
    restated a ``record_copy`` can go away."""
    if sites is None:
        sites = installed_sanctioned_sites()
    out: set = set()
    if not sites:
        return out

    def visit_block(stmts: list) -> None:
        for s in stmts:
            if not isinstance(s, _COMPOUND_STMTS) and \
                    statement_sanctioned(s, stmts, sites) is not None:
                end = getattr(s, "end_lineno", None) or s.lineno
                out.update(range(s.lineno, end + 1))
            for blk in _child_blocks(s):
                visit_block(blk)

    visit_block(tree.body)
    return out


# -- device / pool / host-fetch classification -----------------------------

def _expand_chain(chain: list, mod: ModuleInfo) -> str:
    """Dotted name with the leading alias expanded: with ``import
    numpy as np``, ["np", "asarray"] -> "numpy.asarray"."""
    head = mod.aliases.get(chain[0], chain[0])
    return ".".join([head] + chain[1:])


def _is_pool_acquire(call: ast.Call) -> bool:
    """``bufpool.GLOBAL.acquire(n)`` / ``<pool>.acquire(n)`` where the
    receiver chain names the pool module or its GLOBAL singleton."""
    chain = attr_chain(call.func)
    return (bool(chain) and chain[-1] == "acquire"
            and any(c in ("bufpool", "GLOBAL") for c in chain[:-1]))


def _is_host_fetch(call: ast.Call, mod: ModuleInfo) -> bool:
    """np.asarray/np.array — device→host when the operand is device."""
    chain = attr_chain(call.func)
    if not chain:
        return False
    return _expand_chain(chain, mod) in ("numpy.asarray", "numpy.array")


#: ``torch.*`` callables that are not ops on tensors (device handles,
#: host constructors, dtype queries) and namespaces of runtime services
_NON_OPS = frozenset({
    "torch.device", "torch.from_numpy", "torch.frombuffer", "torch.Size",
    "torch.is_tensor", "torch.get_default_dtype", "torch.set_num_threads",
    "torch.get_num_threads", "torch.manual_seed", "torch.promote_types",
    "torch.result_type", "torch.no_grad", "torch.inference_mode",
    "torch.iinfo", "torch.finfo", "torch.Generator", "torch.compile",
})
_NON_OP_PREFIXES = ("torch.cuda.", "torch.distributed.", "torch.utils.",
                    "torch.backends.", "torch.profiler.", "torch.jit.",
                    "torch.autograd.", "torch.library.", "torch.testing.",
                    "torch.multiprocessing.")

#: Tensor methods whose result is on the host (the VL501 sinks among
#: them) or is no tensor at all
_HOST_METHODS = ("cpu", "numpy", "tolist", "item", "tobytes",
                 "data_ptr", "dim", "size", "numel", "element_size",
                 "is_contiguous", "stride", "storage_offset")


def _is_cpu_literal(expr: ast.AST, mod: ModuleInfo) -> bool:
    """``"cpu"`` or ``torch.device("cpu"[, ...])``."""
    if isinstance(expr, ast.Constant):
        return expr.value == "cpu"
    if isinstance(expr, ast.Call) and expr.args:
        chain = attr_chain(expr.func)
        if chain and _expand_chain(chain, mod) == "torch.device":
            return _is_cpu_literal(expr.args[0], mod)
    return False


def _is_dtype_expr(expr: ast.AST, mod: ModuleInfo) -> bool:
    """``torch.int64``-style dtype constants and ``x.dtype`` reads."""
    chain = attr_chain(expr)
    if not chain:
        return False
    if chain[-1] == "dtype" and len(chain) > 1:
        return True
    root, _, leaf = _expand_chain(chain, mod).rpartition(".")
    return root == "torch" and canon_dtype(leaf) is not None


def _device_move(call: ast.Call, mod: ModuleInfo) -> Optional[str]:
    """Label when ``call`` puts a tensor on the card by the code's own
    word: ``.cuda()``, ``.to(x)`` / ``.to(device=x)`` or a ``torch.*``
    factory's ``device=x`` with ``x`` not literally ``"cpu"`` (and
    ``.to``'s positional argument not a dtype)."""
    f = call.func
    dev_kw = next((kw.value for kw in call.keywords if kw.arg == "device"),
                  None)
    if isinstance(f, ast.Attribute) and f.attr == "cuda":
        return ".cuda()"
    if isinstance(f, ast.Attribute) and f.attr == "to":
        target = dev_kw if dev_kw is not None else (
            call.args[0] if call.args else None)
        if target is None or _is_cpu_literal(target, mod) \
                or _is_dtype_expr(target, mod):
            return None
        return ".to()"
    if dev_kw is not None and not _is_cpu_literal(dev_kw, mod) \
            and _is_torch_op(call, mod) is not None:
        return f"{'.'.join(attr_chain(f))}(device=)"
    return None


def _is_torch_op(call: ast.Call, mod: ModuleInfo) -> Optional[str]:
    """The dotted name of a ``torch.*`` op call, else None."""
    chain = attr_chain(call.func)
    if not chain:
        return None
    dotted = _expand_chain(chain, mod)
    if not dotted.startswith("torch.") or dotted in _NON_OPS \
            or dotted.startswith(_NON_OP_PREFIXES):
        return None
    return ".".join(chain)


def _kernel_objects(index: ProjectIndex) -> set:
    """Dotted names of module-level ``Kernel(...)`` bindings: the
    launchers of ops/_build.py."""
    out: set = set()
    for mod in index.modules.values():
        for node in mod.ctx.tree.body:
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            chain = attr_chain(node.value.func)
            if chain and _expand_chain(chain, mod).endswith(
                    "_build.Kernel"):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.add(f"{mod.name}.{t.id}")
    return out


def _launches(fi: FunctionInfo, mod: ModuleInfo,
              kernels: set) -> Optional[str]:
    """The kernel a function launches directly (``K.launch(...)`` on a
    ``Kernel`` binding), making it one of the port's kernel wrappers."""
    for node in _walk_skip_defs(fi.node):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "launch"):
            continue
        chain = attr_chain(node.func.value)
        if not chain:
            continue
        dotted = _expand_chain(chain, mod)
        if dotted in kernels or f"{mod.name}.{dotted}" in kernels:
            return chain[-1]
    return None


def _const_iterable(it: ast.AST) -> bool:
    """True for an iterable that is a literal constant sequence —
    ``(1, 2, 4, 8, 16)`` or ``range(16)`` — i.e. a bounded structural
    unroll (the log-depth doubling kernels), not a per-data-item loop."""
    if isinstance(it, (ast.Tuple, ast.List)):
        return bool(it.elts) and all(
            isinstance(e, ast.Constant) for e in it.elts)
    if (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
            and it.func.id == "range" and it.args):
        return all(isinstance(a, ast.Constant) for a in it.args)
    return False


_SYNC_BUILTINS = {"float", "int", "bool"}

#: VL501's Tensor-method sinks: each leaves the card
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")

#: VL501 hot scopes — the zero-copy data plane proper
_HOT_PARTS = ("engine", "ops", "repo")


_MAT_KINDS = {"bytes": "bytes(...)", "tobytes": ".tobytes()",
              "join": 'b"".join'}


def _materialization(call: ast.Call) -> Optional[tuple]:
    """(kind label, operand expr) for bytes(x) / x.tobytes() /
    b"".join(parts) — the same shapes VL106 matches."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "tobytes":
        return _MAT_KINDS["tobytes"], f.value
    if (isinstance(f, ast.Name) and f.id == "bytes" and len(call.args) == 1
            and not call.keywords
            and not isinstance(call.args[0], ast.Constant)):
        return _MAT_KINDS["bytes"], call.args[0]
    if (isinstance(f, ast.Attribute) and f.attr == "join"
            and isinstance(f.value, ast.Constant)
            and isinstance(f.value.value, bytes) and call.args):
        return _MAT_KINDS["join"], call.args[0]
    return None


# -- per-function facts ------------------------------------------------------

@dataclass
class FnSummary:
    """What a caller needs to know about a function."""

    returns: Prov = UNK
    ret_param: Optional[int] = None  # returns param i (or a view of it)
    ret_view: bool = False
    sanctions: list = field(default_factory=list)  # [(site, lineno)]


@dataclass
class _Pending:
    """A fact about a symbolic parameter, resolved after the param-
    provenance fixpoint: a materialization of param ``idx`` (VL503) at
    ``node`` in function ``qual``."""

    qual: str
    idx: int
    node: ast.AST
    relpath: str
    desc: str  # local hop text, e.g. "bytes(...) at a/b.py:12"


class BufModel:
    """Whole-program buffer-provenance facts for one ProjectIndex."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self.maps: dict[str, _ScopeMaps] = {}
        self.sites: dict[str, ast.AST] = {}  # sanctioned site -> elt node
        self.ledger: Optional[ModuleInfo] = None
        self.site_set: frozenset = frozenset()
        # kernel wrappers: qualname -> the Kernel binding it launches
        self.wrappers: dict[str, str] = {}
        # ids of the FunctionDefs torch runs under capture/compilation
        self.traced: set = set()
        self.record_sites: dict[str, list] = {}  # site -> [(relpath, line)]
        self.nonliteral: list = []  # (relpath, Call) record_copy sites
        self.summaries: dict[str, FnSummary] = {}
        self._in_progress: set = set()
        self.findings: list[Finding] = []
        self._pending: list[_Pending] = []
        # (callee qual, param idx) -> list of contributions:
        #   ("const", Prov) | ("param", caller qual, caller idx, hop)
        self._flows: dict[tuple, list] = {}
        self.param_prov: dict[tuple, Prov] = {}
        self._build()

    # -- construction -------------------------------------------------------

    def _build(self) -> None:
        self.ledger = ledger_module(self.index)
        if self.ledger is not None:
            self.sites = _sites_from_tree(self.ledger.ctx.tree) or {}
            self.site_set = frozenset(self.sites)
        else:
            self.site_set = installed_sanctioned_sites()
        kernels = _kernel_objects(self.index)
        for rp in sorted(self.index.by_relpath):
            mod = self.index.by_relpath[rp]
            self.maps[rp] = _ScopeMaps(mod)
            self.traced.update(TracerSafetyRule.traced_functions(
                mod.ctx.tree))
        for qual in sorted(self.index.functions):
            fi = self.index.functions[qual]
            kernel = _launches(fi, self.index.modules[fi.module], kernels)
            if kernel is not None:
                self.wrappers[qual] = kernel
        for rp in sorted(self.index.by_relpath):
            self._collect_records(self.index.by_relpath[rp])
        for qual in sorted(self.index.functions):
            self.summary_of(qual)
        # module-level code (scripts, benches) runs at import time and
        # dispatches too — analyze each module body as a param-less
        # pseudo-function so VL501/VL502/VL503 cover script paths
        for rp in sorted(self.index.by_relpath):
            mod = self.index.by_relpath[rp]
            shim = FunctionInfo(
                qualname=mod.name, module=mod.name, relpath=rp,
                node=mod.ctx.tree, cls=None, parent=None, params=[],
                kwonly=[])
            self._analyze_fn(mod.name, shim)
        self._solve_params()
        self._emit_pending()
        self._check_ledger_drift()

    def _collect_records(self, mod: ModuleInfo) -> None:
        for node in ast.walk(mod.ctx.tree):
            if isinstance(node, ast.Call) and _is_record_copy(node):
                site = _record_site(node)
                if site is None:
                    self.nonliteral.append((mod.relpath, node))
                else:
                    self.record_sites.setdefault(site, []).append(
                        (mod.relpath, node.lineno))

    # -- function analysis --------------------------------------------------

    def summary_of(self, qual: str) -> FnSummary:
        got = self.summaries.get(qual)
        if got is not None:
            return got
        if qual in self._in_progress:  # recursion: weakest assumption
            return FnSummary()
        fi = self.index.functions.get(qual)
        if fi is None:
            return FnSummary()
        self._in_progress.add(qual)
        try:
            summary = self._analyze_fn(qual, fi)
        finally:
            self._in_progress.discard(qual)
        if qual in self.wrappers:  # launches a kernel: a card tensor
            summary.returns = Prov(
                DEVICE, (f"device tensor from kernel wrapper "
                         f"{fi.node.name}() ({fi.relpath}:"
                         f"{fi.node.lineno})",))
            summary.ret_param = None
        self.summaries[qual] = summary
        return summary

    def _analyze_fn(self, qual: str, fi: FunctionInfo) -> FnSummary:
        mod = self.index.modules[fi.module]
        maps = self.maps[fi.relpath]
        summary = FnSummary()
        env: dict[str, Prov] = {
            p: Prov(f"param:{i}") for i, p in enumerate(fi.params)}
        hot = any(p in mod.ctx.scope_dirs() for p in _HOT_PARTS)
        # one function-level pre-scan: a sanctioned record_copy
        # ANYWHERE in the body marks the whole function as an explicit
        # staging site (the VL501 exemption), order-independent
        for node in _walk_skip_defs(fi.node):
            if isinstance(node, ast.Call) and _is_record_copy(node):
                site = _record_site(node)
                if site is not None and site in self.site_set:
                    summary.sanctions.append((site, node.lineno))
        fn_sanctioned = bool(summary.sanctions)

        def site_of(node: ast.AST) -> str:
            return f"{fi.relpath}:{node.lineno}"

        def eval_expr(expr: ast.AST) -> Prov:
            if isinstance(expr, ast.Name):
                return env.get(expr.id, UNK)
            if isinstance(expr, ast.Call):
                return eval_call(expr)
            if isinstance(expr, ast.Subscript):
                base = eval_expr(expr.value)
                if base.tag in (POOLED, MVIEW):
                    return Prov(MVIEW, base.chain + (
                        f"sliced at {site_of(expr)}",))
                pv = _param_of(base)
                if pv is not None:
                    return Prov(f"paramview:{pv[0]}", base.chain)
                return base
            if isinstance(expr, ast.Attribute):
                base = eval_expr(expr.value)
                return base if base.tag == DEVICE else UNK
            if isinstance(expr, ast.IfExp):
                return join(eval_expr(expr.body), eval_expr(expr.orelse))
            if isinstance(expr, ast.BinOp):
                lt, rt = eval_expr(expr.left), eval_expr(expr.right)
                if DEVICE in (lt.tag, rt.tag):
                    return lt if lt.tag == DEVICE else rt
                return UNK
            if isinstance(expr, (ast.List, ast.Tuple)):
                # a sequence of card tensors (torch.cat's operand)
                for e in expr.elts:
                    prov = eval_expr(e)
                    if prov.tag == DEVICE:
                        return prov
                return UNK
            if isinstance(expr, (ast.Starred, ast.Await)):
                return eval_expr(expr.value)
            return UNK

        def eval_call(call: ast.Call) -> Prov:
            if _is_pool_acquire(call):
                return Prov(POOLED, (
                    f"pooled buffer from acquire() at {site_of(call)}",))
            chain = attr_chain(call.func)
            if chain and chain[-1] == "memoryview" and call.args:
                inner = eval_expr(call.args[0])
                if inner.tag in (POOLED, MVIEW):
                    return Prov(MVIEW, inner.chain + (
                        f"memoryview at {site_of(call)}",))
                pv = _param_of(inner)
                if pv is not None:
                    return Prov(f"paramview:{pv[0]}", inner.chain)
                return UNK
            if _is_host_fetch(call, mod):
                return Prov(HOST, (f"np.asarray at {site_of(call)}",))
            mat = _materialization(call)
            if mat is not None:
                return Prov(HOST, (f"{mat[0]} at {site_of(call)}",))
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr in _HOST_METHODS:
                return Prov(HOST, (f".{f.attr}() at {site_of(call)}",)) \
                    if f.attr in ("cpu", "numpy") else UNK
            move = _device_move(call, mod)
            if move is not None:
                return Prov(DEVICE, (
                    f"device tensor from {move} at {site_of(call)}",))
            site = self.index.site_by_node.get(id(call))
            if site is not None and site.callee is not None:
                return self._call_result(call, site.callee, eval_expr,
                                         site_of(call))
            op = _is_torch_op(call, mod)
            if op is not None:
                operands = list(call.args) + [kw.value
                                              for kw in call.keywords]
                if any(eval_expr(a).tag == DEVICE for a in operands):
                    return Prov(DEVICE, (
                        f"device tensor from {op} at {site_of(call)}",))
                return UNK
            if isinstance(f, ast.Attribute):
                base = eval_expr(f.value)
                if base.tag == DEVICE:
                    return base  # device method chain (.view, .reshape)
            return UNK

        def scan_stmt(stmt: ast.stmt) -> None:
            """Findings + summary facts for every call the statement
            owns directly (compound bodies and nested defs excluded —
            the block walk / their own analyses cover those)."""
            for root in _scan_roots(stmt):
                nodes = [root, *_walk_skip_defs(root)]
                scan_stmt_nodes(stmt, nodes)

        def scan_stmt_nodes(stmt, nodes) -> None:
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                if _is_record_copy(node):
                    continue
                self._scan_materialization(node, stmt, maps, fi, qual,
                                           eval_expr)
                if hot and not fn_sanctioned:
                    self._scan_sync(node, mod, fi, eval_expr)
                self._record_flows(node, qual, eval_expr)

        def walk_block(stmts: list) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                scan_stmt(stmt)
                if isinstance(stmt, ast.Assign):
                    prov = eval_expr(stmt.value)
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            env[t.id] = prov
                elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                    if stmt.value is not None and isinstance(
                            stmt.target, ast.Name):
                        env[stmt.target.id] = eval_expr(stmt.value)
                elif isinstance(stmt, ast.Return) and stmt.value is not None:
                    self._fold_return(summary, eval_expr(stmt.value))
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    for item in stmt.items:
                        if isinstance(item.optional_vars, ast.Name):
                            env[item.optional_vars.id] = eval_expr(
                                item.context_expr)
                    walk_block(stmt.body)
                elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                    if eval_expr(stmt.iter).tag == DEVICE:
                        for name in _target_names(stmt.target):
                            env[name] = Prov(DEVICE, (
                                f"row of a device tensor at "
                                f"{site_of(stmt)}",))
                    walk_block(stmt.body)
                    walk_block(stmt.orelse)
                elif isinstance(stmt, (ast.If, ast.While)):
                    walk_block(stmt.body)
                    walk_block(stmt.orelse)
                elif isinstance(stmt, ast.Try):
                    walk_block(stmt.body)
                    for h in stmt.handlers:
                        walk_block(h.body)
                    walk_block(stmt.orelse)
                    walk_block(stmt.finalbody)

        walk_block(fi.node.body)
        self._check_loop_dispatch(fi, mod, eval_expr, env)
        return summary

    # -- statement scanners -------------------------------------------------

    def _scan_materialization(self, call, stmt, maps, fi, qual,
                              eval_expr) -> None:
        mat = _materialization(call)
        if mat is None:
            return
        kind, operand = mat
        prov = eval_expr(operand)
        pv = _param_of(prov)
        if prov.tag not in (POOLED, MVIEW) and pv is None:
            return
        block = maps.block_of(stmt) if stmt is not None else None
        if statement_sanctioned(stmt, block, self.site_set) is not None:
            return  # ledgered copy — the sanctioned kind
        desc = f"{kind} at {fi.relpath}:{call.lineno}"
        if pv is not None:
            self._pending.append(_Pending(qual, pv[0], call, fi.relpath,
                                          desc))
            return
        self.findings.append(finding_at(
            fi.relpath, call, "VL503",
            f"{kind} materializes a {prov.tag}-provenance buffer with "
            f"no sanctioned record_copy on the statement "
            f"[{_hops(prov.chain + (desc,))}] — ledger it "
            f"(record_copy(site, n), site in SANCTIONED_SITES) or keep "
            f"the view", severity="error"))

    def _scan_sync(self, call, mod, fi, eval_expr) -> None:
        f = call.func
        operand = None
        what = None
        if (isinstance(f, ast.Name) and f.id in _SYNC_BUILTINS
                and len(call.args) == 1):
            operand, what = call.args[0], f"{f.id}()"
        elif isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
            operand, what = f.value, f".{f.attr}()"
        elif _is_host_fetch(call, mod) and call.args:
            operand, what = call.args[0], "np.asarray()"
        if operand is None:
            return
        prov = eval_expr(operand)
        if prov.tag != DEVICE:
            return
        self.findings.append(finding_at(
            fi.relpath, call, "VL501",
            f"{what} on a device-provenance value forces an implicit "
            f"device->host sync in a hot scope "
            f"[{_hops(prov.chain)}] — batch the fetch at an explicit "
            f"staging site (a function that ledgers a sanctioned "
            f"record_copy) or keep the value on device",
            severity="error"))

    def _record_flows(self, call, caller_qual, eval_expr) -> None:
        """Positional-arg provenance flowing into callee params — the
        edges the param-provenance fixpoint solves over."""
        site = self.index.site_by_node.get(id(call))
        if site is None or site.callee is None:
            return
        cfi = self.index.functions.get(site.callee)
        if cfi is None:
            return
        offset = 1 if (cfi.cls and cfi.params
                       and cfi.params[0] in ("self", "cls")
                       and isinstance(call.func, ast.Attribute)) else 0
        hop = (f"passed to {cfi.node.name}() at "
               f"{site.relpath}:{call.lineno}")
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            pidx = i + offset
            if pidx >= len(cfi.params):
                break
            prov = eval_expr(arg)
            slot = self._flows.setdefault((site.callee, pidx), [])
            pv = _param_of(prov)
            if pv is not None:
                slot.append(("param", caller_qual, pv[0], hop))
            elif prov.tag in (POOLED, MVIEW, DEVICE):
                slot.append(("const", Prov(prov.tag, prov.chain + (hop,))))

    # -- per-function post passes -------------------------------------------

    def _trace_context(self, fi) -> bool:
        """Is ``fi``'s body executed at trace time (so Python loops
        unroll into one compiled program, not per-item dispatches)?
        True for compiled functions and for bodies handed to
        ``torch.cond``/``while_loop``/``scan`` (VL004's notion),
        walking up through lexically enclosing functions."""
        seen = set()
        cur = fi
        while cur is not None and cur.qualname not in seen:
            seen.add(cur.qualname)
            if id(cur.node) in self.traced:
                return True
            cur = self.index.functions.get(cur.parent) \
                if cur.parent is not None else None
        return False

    def _check_loop_dispatch(self, fi, mod, eval_expr, env) -> None:
        if self._trace_context(fi):
            return
        for loop in _walk_skip_defs(fi.node):
            if isinstance(loop, (ast.For, ast.AsyncFor)):
                if _const_iterable(loop.iter):
                    continue  # structural unroll over a literal
                tainted = _target_names(loop.target)
                iters = [(loop.target, loop.iter)]
                body: list = loop.body
            elif isinstance(loop, (ast.ListComp, ast.SetComp,
                                   ast.GeneratorExp, ast.DictComp)):
                tainted = set()
                iters = []
                for gen in loop.generators:
                    if not _const_iterable(gen.iter):
                        tainted |= _target_names(gen.target)
                        iters.append((gen.target, gen.iter))
                body = []
            else:
                continue
            if not tainted:
                continue
            exprs: list = []
            for stmt in body:
                for node in [stmt, *_walk_skip_defs(stmt)]:
                    if isinstance(node, ast.Assign) and (
                            _names_in(node.value) & tainted):
                        for t in node.targets:
                            tainted |= _target_names(t)
                    if isinstance(node, ast.Call):
                        exprs.append(node)
            if not body:  # comprehension: scan its element/conditions
                exprs = [n for n in ast.walk(loop)
                         if isinstance(n, ast.Call)]
            # a loop over a card tensor hands out card rows
            saved = {}
            for target, it in iters:
                if eval_expr(it).tag == DEVICE:
                    for name in _target_names(target):
                        saved.setdefault(name, env.get(name))
                        env[name] = Prov(DEVICE, (
                            f"row of a device tensor at "
                            f"{fi.relpath}:{it.lineno}",))
            try:
                for call in exprs:
                    if eval_expr(call).tag != DEVICE:
                        continue  # no dispatch on the card
                    args_names: set = set()
                    operands = list(call.args) + [kw.value
                                                  for kw in call.keywords]
                    if isinstance(call.func, ast.Attribute):
                        operands.append(call.func.value)
                    for a in operands:
                        args_names |= _names_in(a)
                    if args_names & tainted:
                        self.findings.append(finding_at(
                            fi.relpath, call, "VL502",
                            f"device dispatch inside a per-item Python "
                            f"loop (operand derives from loop variable "
                            f"{sorted(args_names & tainted)}) — batch the "
                            f"items into one padded dispatch "
                            f"(ops/segment.py batched kernels) or hoist "
                            f"it out of the loop", severity="error"))
            finally:
                for name, prev in saved.items():
                    if prev is None:
                        env.pop(name, None)
                    else:
                        env[name] = prev

    # -- interprocedural solving --------------------------------------------

    def _fold_return(self, summary: FnSummary, prov: Prov) -> None:
        pv = _param_of(prov)
        if pv is not None:
            summary.ret_param, summary.ret_view = pv[0], pv[1]
            return
        summary.returns = join(summary.returns, prov)

    def _call_result(self, call, callee, eval_expr, site_desc) -> Prov:
        s = self.summary_of(callee)
        if s.ret_param is not None:
            cfi = self.index.functions.get(callee)
            offset = 1 if (cfi and cfi.cls and cfi.params
                           and cfi.params[0] in ("self", "cls")
                           and isinstance(call.func, ast.Attribute)) else 0
            i = s.ret_param - offset
            if 0 <= i < len(call.args):
                arg = eval_expr(call.args[i])
                if s.ret_view and arg.tag in (POOLED, MVIEW):
                    return Prov(MVIEW, arg.chain + (
                        f"viewed by callee at {site_desc}",))
                pv = _param_of(arg)
                if s.ret_view and pv is not None:
                    return Prov(f"paramview:{pv[0]}", arg.chain)
                return arg
        if s.returns.tag != UNKNOWN:
            return Prov(s.returns.tag, s.returns.chain)
        return UNK

    def _solve_params(self) -> None:
        """Monotone fixpoint over the arg→param flow edges: concrete
        provenance seeds, symbolic edges forward it caller→callee."""
        changed = True
        while changed:
            changed = False
            for key in sorted(self._flows):
                cur = self.param_prov.get(key, UNK)
                best = cur
                for contrib in self._flows[key]:
                    if contrib[0] == "const":
                        best = join(best, contrib[1])
                    else:
                        _, src_qual, src_idx, hop = contrib
                        src = self.param_prov.get((src_qual, src_idx), UNK)
                        if src.tag in (POOLED, MVIEW, DEVICE):
                            best = join(best, Prov(
                                src.tag, src.chain + (hop,)))
                if best.tag != cur.tag:
                    self.param_prov[key] = best
                    changed = True

    def _emit_pending(self) -> None:
        for p in self._pending:
            prov = self.param_prov.get((p.qual, p.idx), UNK)
            if prov.tag not in (POOLED, MVIEW):
                continue
            self.findings.append(finding_at(
                p.relpath, p.node, "VL503",
                f"materialization of a {prov.tag}-provenance parameter "
                f"with no sanctioned record_copy on the statement "
                f"[{_hops(prov.chain + (p.desc,))}] — ledger it "
                f"(record_copy(site, n), site in SANCTIONED_SITES) or "
                f"keep the view", severity="error"))

    def _check_ledger_drift(self) -> None:
        if self.ledger is None:
            return  # no copyledger in the linted tree — VL505 is moot
        for relpath, node in sorted(self.nonliteral,
                                    key=lambda t: (t[0], t[1].lineno)):
            self.findings.append(finding_at(
                relpath, node, "VL505",
                "record_copy site is not a string literal — sites are "
                "Prometheus label values and must be auditable "
                "statically; pass a literal dotted lowercase name",
                severity="error"))
        for site in sorted(self.record_sites):
            if site in self.site_set:
                continue
            first = self._first_record_node(site)
            if first is not None:
                self.findings.append(finding_at(
                    first[0], first[1], "VL505",
                    f"record_copy site '{site}' is not in "
                    f"obs.SANCTIONED_SITES — adding a copy site is a "
                    f"reviewed change: add it to the frozenset with a "
                    f"reason", severity="error"))
        for site in sorted(self.site_set):
            if site not in self.record_sites:
                elt = self.sites.get(site)
                if elt is None:
                    continue
                self.findings.append(finding_at(
                    self.ledger.relpath, elt, "VL505",
                    f"sanctioned site '{site}' has no record_copy call "
                    f"site — the ledger entry is dead; remove it or "
                    f"restore the call", severity="error"))

    def _first_record_node(self, site: str) -> Optional[tuple]:
        for rp in sorted(self.index.by_relpath):
            mod = self.index.by_relpath[rp]
            for node in ast.walk(mod.ctx.tree):
                if (isinstance(node, ast.Call) and _is_record_copy(node)
                        and _record_site(node) == site):
                    return rp, node
        return None


def _target_names(t: ast.AST) -> set:
    out: set = set()
    for n in ast.walk(t):
        if isinstance(n, ast.Name):
            out.add(n.id)
    return out


def _names_in(expr: ast.AST) -> set:
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}


def _scan_roots(stmt: ast.stmt) -> list:
    """The expression parts a statement owns directly.  Compound
    statements own only their headers (test / iter / context
    managers) — their bodies are separate statements the block walk
    visits on its own, so scanning the whole compound node would
    double-report every call inside it."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in stmt.items]
    if isinstance(stmt, ast.Try):
        return []
    return [stmt]


_MODELS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def model_for(index: ProjectIndex) -> BufModel:
    model = _MODELS.get(index)
    if model is None:
        model = BufModel(index)
        _MODELS[index] = model
    return model


# -- rules -------------------------------------------------------------------


class _BufRule:
    def check_project(self, index: ProjectIndex) -> Iterator[Finding]:
        for f in model_for(index).findings:
            if f.code == self.code:
                yield f


class HostSyncRule(_BufRule):
    code = "VL501"
    name = "implicit-host-sync"
    severity = "error"
    description = ("float()/int()/bool()/.item()/.tolist()/.cpu()/"
                   ".numpy()/np.asarray() on a device-provenance value in "
                   "engine/, ops/ or repo/ outside an explicit (ledgered) "
                   "staging site")


class LoopDispatchRule(_BufRule):
    code = "VL502"
    name = "per-item-device-dispatch"
    severity = "error"
    description = ("torch op/kernel-wrapper call on the card inside a "
                   "per-item Python loop with an operand derived from "
                   "the loop variable — batch it")


class SemanticCopyRule(_BufRule):
    code = "VL503"
    name = "unledgered-pooled-copy"
    severity = "error"
    description = ("bytes()/.tobytes()/b\"\".join over a pooled-buffer "
                   "or memoryview-of-pooled value (tracked "
                   "interprocedurally) without a sanctioned "
                   "record_copy on the statement")


class UseAfterDonateRule(_BufRule):
    """VL504, kept for the reference's rule catalogue and silent: torch
    has no buffer donation (no ``donate_argnums``; an op writes into a
    tensor only through an explicit ``out=`` or in-place method, which
    the caller names), and the port donates nothing, so no value can be
    read after its buffer was handed away."""

    code = "VL504"
    name = "use-after-donate"
    severity = "error"
    description = ("value passed to a donated-argument jit twin "
                   "(directly, via a helper, or via a conditional twin "
                   "binding) and read again — XLA may have reused the "
                   "buffer")

    def check_project(self, index: ProjectIndex) -> Iterator[Finding]:
        return iter(())


class LedgerDriftRule(_BufRule):
    code = "VL505"
    name = "ledger-sanction-drift"
    severity = "error"
    description = ("record_copy site missing from SANCTIONED_SITES, "
                   "non-literal site name, or a sanctioned site with "
                   "no remaining call site")


def default_buf_rules() -> list:
    return [HostSyncRule(), LoopDispatchRule(), SemanticCopyRule(),
            UseAfterDonateRule(), LedgerDriftRule()]


# -- cache fact kind ---------------------------------------------------------


def summaries_for(index: ProjectIndex) -> dict[str, dict]:
    """Per-file buffer-provenance facts — the cached "buf" fact kind.
    A file's summary changes iff its provenance-relevant surface
    (returns, sanction sites, ledger records) changes, so
    the cache layer can replay clean files verbatim."""
    model = model_for(index)
    out: dict[str, dict] = {}

    def slot(relpath: str) -> dict:
        return out.setdefault(relpath, {"prov": {}, "sanctions": [],
                                        "records": []})

    for qual in sorted(model.summaries):
        fi = index.functions.get(qual)
        if fi is None:
            continue
        s = model.summaries[qual]
        entry = slot(fi.relpath)
        ret = (f"param:{s.ret_param}{'(view)' if s.ret_view else ''}"
               if s.ret_param is not None else s.returns.tag)
        if ret != UNKNOWN or s.sanctions:
            entry["prov"][qual] = ret
        for site, lineno in sorted(s.sanctions):
            entry["sanctions"].append([site, lineno])
    for site in sorted(model.record_sites):
        for relpath, lineno in model.record_sites[site]:
            slot(relpath)["records"].append([site, lineno])
    return out


# -- provenance export & bridge helpers --------------------------------------


def sanction_sites(index: ProjectIndex) -> dict[str, list]:
    """{site: [(relpath, lineno), ...]} of statically discovered,
    SANCTIONED record_copy call sites — the static half of the
    runtime⊆static ledger bridge."""
    model = model_for(index)
    return {site: list(model.record_sites[site])
            for site in sorted(model.record_sites)
            if site in model.site_set}


def provenance_json(index: ProjectIndex) -> dict:
    """Per-site provenance facts as plain JSON for offline diffing —
    nodes are functions with non-trivial provenance surface, edges are
    the arg→param hops the fixpoint solved over."""
    model = model_for(index)
    nodes = []
    for qual in sorted(model.summaries):
        s = model.summaries[qual]
        fi = index.functions.get(qual)
        ret = (f"param:{s.ret_param}{'(view)' if s.ret_view else ''}"
               if s.ret_param is not None else s.returns.tag)
        if ret == UNKNOWN and not s.sanctions:
            continue
        nodes.append({
            "fn": qual, "file": fi.relpath if fi else "?",
            "returns": ret,
            "sanctions": sorted({site for site, _ in s.sanctions})})
    edges = []
    for (callee, idx) in sorted(model._flows):
        prov = model.param_prov.get((callee, idx), UNK)
        if prov.tag == UNKNOWN:
            continue
        edges.append({"to": callee, "param": idx, "prov": prov.tag,
                      "via": list(prov.chain)})
    return {
        "sanctioned_sites": {
            site: [f"{rp}:{ln}" for rp, ln in entries]
            for site, entries in sanction_sites(index).items()},
        "nodes": nodes,
        "edges": edges,
    }


def _index_for_paths(paths) -> ProjectIndex:
    from volsync_tpu_torch.analysis.callgraph import build_index
    from volsync_tpu_torch.analysis.engine import (
        FileContext,
        iter_py_files,
        relativize,
    )

    contexts = []
    for path in iter_py_files(paths):
        relpath = relativize(path)
        try:
            source = path.read_bytes().decode("utf-8")
            tree = ast.parse(source, filename=str(path))
        except (OSError, SyntaxError, ValueError):
            continue  # the lint run proper reports parse errors
        contexts.append(FileContext(path, relpath, source, tree))
    return build_index(contexts)


def dump_for_paths(paths) -> dict:
    """Build the provenance export for a path set from scratch — the
    ``volsync lint --dump-provenance`` entry point."""
    return provenance_json(_index_for_paths(paths))


def sanction_sites_for_paths(paths) -> dict[str, list]:
    """The static sanction-site map for a path set — what the tier-1
    runtime⊆static bridge test checks ``copies_by_site()`` against."""
    return sanction_sites(_index_for_paths(paths))
