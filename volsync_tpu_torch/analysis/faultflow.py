"""Fault-path analyzer: prove the retry, fencing and crash-ordering
laws statically (VL601-VL605).

Ports ``volsync_tpu/analysis/faultflow.py``, pointed at the PyTorch port.

The durability story (docs/robustness.md) rests on protocol laws that
were, until now, pinned only by runtime chaos soaks:

* **single retry budget** — every network store op runs under exactly
  one retry layer (``ResilientStore`` wrap *or* a ``RetryPolicy``),
  never zero and never two (an ``_upload_policy`` over a
  ``ResilientStore`` is the bug class);
* **typed weather** — data-plane raise sites throw types
  ``resilience.classify()`` can decide, and the classify table itself
  has no unknown types or dead branches;
* **fence before publish** — every store mutation of a fenced key
  family (``repository.FENCED_KEY_FAMILIES``) is dominated by a
  ``_guard_publish`` re-check on every path;
* **crash ordering** — the two-phase prune and scrub sequences write
  in their declared order (``CRASH_ORDERINGS`` next to the protocol
  code), so a crash at any boundary is recoverable (PRs 10/14).

This module infers, per function, an *effect summary*: the store ops
it performs (receiver kind: proven ``ResilientStore``, boundary
``ObjectStore`` the way VL401 types ``store: ObjectStore``, or proven
bare), the retry-policy context each effect runs under, and the typed
exceptions it raises.  Summaries flow interprocedurally over the
project call graph (``callgraph``) to a fixpoint with full hop chains
like the VL5xx provenance printer, then five rules check the laws:

* **VL601 unprotected-network-effect** — a store op reachable from a
  data-plane root with *no* retry layer on some call path.  Backend
  transports never fire (``objstore/`` and ``resilience.py`` are out
  of effect scope — they *are* the retry layer), and
  single-attempt-by-design ops (``resilience.SINGLE_ATTEMPT_OPS``,
  e.g. ``put_if_absent`` whose retry-safety is argued at the policy
  site) are sanctioned the same way VL505 sanctions copy sites.
* **VL602 retry-stacking** — two retry layers proved on one call
  chain: a wrapped receiver under a ``RetryPolicy``, or a policy
  wrapping a chain whose store op is already covered.  Policies
  constructed with ``classify_fn=`` are *scoped* (they replace the
  weather classifier, retrying only their own protocol signal) and
  are neither a store-weather layer nor a stacking hazard.  Branches
  on a ``isinstance(store, ResilientStore)`` flag field re-type the
  receiver per arm, so the ``_put_pack_blob`` one-layer-per-arm
  pattern verifies clean.
* **VL603 exception-taxonomy-drift** — generic ``raise RuntimeError``
  kin in the data plane; classify branches naming unknown types; dead
  classify branches shadowed by an earlier ``isinstance``.  The table
  is resolved from the linted tree's own ``resilience.py`` AST
  (VL505-style, installed-file fallback).
* **VL604 unfenced-publish** — a ``put``/``put_if_absent`` into a
  fenced key family not dominated by ``_guard_publish`` on every
  path.  Dominance is a sibling-statement approximation (guards
  inside a preceding ``with`` count; guards inside a preceding
  ``if``/``try`` do not), widened interprocedurally: a helper's
  unfenced publish is fine when every call site is itself dominated.
* **VL605 crash-ordering** — each law declared in a
  ``CRASH_ORDERINGS`` mapping names a function and an ordered step
  tuple (call names, ``delete-prefix:<p>``, ``delete-of:<var>``);
  first occurrences must appear, in order, in that function's body.

Heuristic surface (documented, audited): store receivers are
recognized by field/param typing and the ``*store`` naming
convention; ops submitted as bare callables to executors are
invisible (their worker functions are analyzed as roots instead);
lambdas are skipped.

Like ``lockflow``/``bufflow`` this runs as project rules so it rides
``--select``/``--ignore``, the SARIF export, and the incremental
cache (fact kind ``"fx"``).  ``volsync lint --dump-effects FILE``
exports the effect graph; ``static_fault_edges_for_paths`` is the
static half of the runtime⊆static fault bridge
(tests/test_analysis_fx.py).
"""

from __future__ import annotations

import ast
import weakref
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Optional

from volsync_tpu_torch.analysis.callgraph import (
    FunctionInfo,
    ModuleInfo,
    ProjectIndex,
    attr_chain,
)
from volsync_tpu_torch.analysis.engine import Finding, finding_at
from volsync_tpu_torch.analysis.iprules import _walk_skip_defs

# -- vocabulary --------------------------------------------------------------

#: ObjectStore protocol surface (repo/store.py) — attribute calls with
#: these names on a store-typed receiver are network effects.
STORE_METHODS = frozenset({
    "put", "put_if_absent", "get", "get_range", "put_file", "get_file",
    "list", "delete", "exists", "size",
})

#: Ops that mutate the store — the only ones VL604 fences.  Deletes are
#: deliberately NOT publishes: the protocol's deletes are idempotent
#: cleanup steps whose ordering VL605 proves instead.
MUTATING_OPS = frozenset({"put", "put_if_absent"})

#: Where effects are collected (data plane).  ``objstore/`` backends and
#: ``resilience.py`` are the retry layer itself — their internal ops are
#: transport, never findings.
_EFFECT_SCOPES = ("repo", "engine")

#: Where VL603 polices raise sites.
_RAISE_SCOPES = ("repo", "engine", "objstore")

_GENERIC_RAISES = frozenset({"Exception", "BaseException", "RuntimeError"})

_HOP_CAP = 15          # interprocedural BFS depth bound
_COV_CHAIN_CAP = 8     # covered-effect hop chains kept this long
_COV_SET_CAP = 64      # covered effects remembered per function
_PREFIX_SET_CAP = 8    # concrete prefixes solved per parameter

#: Minimal builtin exception hierarchy for the VL603 shadow check.
_BUILTIN_BASES: dict[str, list[str]] = {
    "BaseException": [],
    "Exception": ["BaseException"],
    "ArithmeticError": ["Exception"],
    "ZeroDivisionError": ["ArithmeticError"],
    "OverflowError": ["ArithmeticError"],
    "OSError": ["Exception"],
    "IOError": ["OSError"],
    "FileNotFoundError": ["OSError"],
    "FileExistsError": ["OSError"],
    "PermissionError": ["OSError"],
    "IsADirectoryError": ["OSError"],
    "NotADirectoryError": ["OSError"],
    "ConnectionError": ["OSError"],
    "ConnectionResetError": ["ConnectionError"],
    "ConnectionAbortedError": ["ConnectionError"],
    "ConnectionRefusedError": ["ConnectionError"],
    "BrokenPipeError": ["ConnectionError"],
    "TimeoutError": ["OSError"],
    "InterruptedError": ["OSError"],
    "LookupError": ["Exception"],
    "KeyError": ["LookupError"],
    "IndexError": ["LookupError"],
    "ValueError": ["Exception"],
    "UnicodeError": ["ValueError"],
    "TypeError": ["Exception"],
    "RuntimeError": ["Exception"],
    "RecursionError": ["RuntimeError"],
    "NotImplementedError": ["RuntimeError"],
    "AttributeError": ["Exception"],
    "StopIteration": ["Exception"],
    "MemoryError": ["Exception"],
}


def _in_effect_scope(mod: ModuleInfo) -> bool:
    dirs = mod.ctx.scope_dirs()
    return any(p in dirs for p in _EFFECT_SCOPES)


def _in_raise_scope(mod: ModuleInfo) -> bool:
    dirs = mod.ctx.scope_dirs()
    return any(p in dirs for p in _RAISE_SCOPES)


# -- law resolution (VL505-style: linted tree first, installed fallback) -----


def _module_with_suffix(index: ProjectIndex,
                        suffix: str) -> Optional[ModuleInfo]:
    for mod in index.modules.values():
        rp = mod.relpath
        if rp == suffix or rp.endswith("/" + suffix):
            return mod
    return None


def _assign_value(tree: ast.AST, name: str) -> Optional[ast.AST]:
    """Module-level ``name = <expr>`` (or annotated) value, if any."""
    for stmt in getattr(tree, "body", []):
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    return stmt.value
        elif isinstance(stmt, ast.AnnAssign):
            if (isinstance(stmt.target, ast.Name)
                    and stmt.target.id == name and stmt.value is not None):
                return stmt.value
    return None


def _literal_strs(node: Optional[ast.AST]) -> Optional[list[str]]:
    """Strings out of a literal tuple/list/set, unwrapping a
    ``frozenset({...})`` call the way the VL505 resolver does."""
    if node is None:
        return None
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("frozenset", "set", "tuple") and node.args):
        node = node.args[0]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out.append(elt.value)
            else:
                return None
        return out
    return None


_INSTALLED_TREES: dict[str, Optional[ast.AST]] = {}


def _installed_tree(relname: str) -> Optional[ast.AST]:
    """Parse a file of the *installed* package (fallback when the
    linted tree doesn't carry it, e.g. fixture miniprojects that only
    declare their own subset of the law constants)."""
    if relname not in _INSTALLED_TREES:
        path = Path(__file__).resolve().parent.parent / relname
        try:
            _INSTALLED_TREES[relname] = ast.parse(
                path.read_bytes().decode("utf-8"))
        except (OSError, SyntaxError, ValueError):
            _INSTALLED_TREES[relname] = None
    return _INSTALLED_TREES[relname]


def _isinstance_types(test: ast.AST,
                      subject: Optional[str] = None) -> Optional[list[str]]:
    """Type names out of ``isinstance(exc, T)`` / ``isinstance(exc,
    (T1, T2))``; dotted refs stay dotted.  With ``subject`` set, only
    probes of that exact name count — classify's ``isinstance(status,
    int)`` shape probes are structural, not taxonomy branches."""
    if not (isinstance(test, ast.Call) and isinstance(test.func, ast.Name)
            and test.func.id == "isinstance" and len(test.args) == 2):
        return None
    if subject is not None and not (
            isinstance(test.args[0], ast.Name)
            and test.args[0].id == subject):
        return None
    spec = test.args[1]
    elts = spec.elts if isinstance(spec, ast.Tuple) else [spec]
    names = []
    for elt in elts:
        chain = attr_chain(elt)
        if not chain:
            return None
        names.append(".".join(chain))
    return names


def _branch_verdict(body: list) -> Optional[bool]:
    for stmt in body:
        if (isinstance(stmt, ast.Return)
                and isinstance(stmt.value, ast.Constant)
                and isinstance(stmt.value.value, bool)):
            return stmt.value.value
        break
    return None


def _classify_branches(fn_node: ast.AST) -> list[tuple]:
    """The classify decision table, in source order:
    ``("types", [names], lineno, verdict)`` for isinstance branches
    (incl. a final ``return isinstance(...)``), ``("structural", [],
    lineno, None)`` for attribute probes the shadow check skips."""
    branches: list[tuple] = []
    args = getattr(fn_node, "args", None)
    subject = args.args[0].arg if args is not None and args.args else None
    for stmt in getattr(fn_node, "body", []):
        if isinstance(stmt, ast.If):
            names = _isinstance_types(stmt.test, subject)
            if names is not None:
                branches.append(
                    ("types", names, stmt.lineno, _branch_verdict(stmt.body)))
            else:
                branches.append(("structural", [], stmt.lineno, None))
        elif isinstance(stmt, ast.Return) and stmt.value is not None:
            names = _isinstance_types(stmt.value, subject)
            if names is not None:
                branches.append(("types", names, stmt.lineno, True))
    return branches


@dataclass
class FaultLaws:
    """The protocol laws, resolved from the linted tree's own source."""
    retried_ops: frozenset
    single_attempt_ops: frozenset
    classify_branches: list          # see _classify_branches
    classify_relpath: Optional[str]  # where classify() was found
    classify_aliases: frozenset      # names importable in that module
    fenced_families: tuple           # ("index/", ...)
    #: law -> (fnname, steps, module_name, relpath, decl_node)
    orderings: dict


def resolve_laws(index: ProjectIndex) -> FaultLaws:
    res = _module_with_suffix(index, "resilience.py")
    res_tree = res.ctx.tree if res is not None else None
    if res_tree is None or _assign_value(res_tree, "_RETRIED_OPS") is None:
        res_tree = _installed_tree("resilience.py")

    retried = _literal_strs(
        _assign_value(res_tree, "_RETRIED_OPS")) if res_tree else None
    single = _literal_strs(
        _assign_value(res_tree, "SINGLE_ATTEMPT_OPS")) if res_tree else None
    # Hand-written ResilientStore methods that route through
    # ``policy.call`` (``list`` materializes per attempt) are wrap-
    # covered too, even though the generated-op table doesn't name them.
    if res_tree is not None and retried is not None:
        for stmt in res_tree.body:
            if not (isinstance(stmt, ast.ClassDef)
                    and stmt.name.endswith("ResilientStore")):
                continue
            for meth in stmt.body:
                if not isinstance(meth, ast.FunctionDef):
                    continue
                for node in ast.walk(meth):
                    if isinstance(node, ast.Call):
                        chain = attr_chain(node.func)
                        if chain and chain[-1] == "call" and \
                                "policy" in chain[:-1]:
                            retried.append(meth.name)
                            break

    branches: list[tuple] = []
    classify_rp = None
    aliases: frozenset = frozenset()
    if res_tree is not None:
        for stmt in res_tree.body:
            if isinstance(stmt, ast.FunctionDef) and stmt.name == "classify":
                branches = _classify_branches(stmt)
                break
    if res is not None and res.ctx.tree is res_tree:
        classify_rp = res.relpath
        aliases = frozenset(res.aliases)

    fenced: tuple = ()
    orderings: dict = {}
    sources = list(index.modules.values())
    for mod in sources:
        val = _assign_value(mod.ctx.tree, "FENCED_KEY_FAMILIES")
        fams = _literal_strs(val)
        if fams:
            fenced = tuple(fams)
        oval = _assign_value(mod.ctx.tree, "CRASH_ORDERINGS")
        if isinstance(oval, ast.Dict):
            for k, v in zip(oval.keys, oval.values):
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)):
                    continue
                if not (isinstance(v, ast.Tuple) and len(v.elts) == 2):
                    continue
                fn_c, steps_c = v.elts
                steps = _literal_strs(steps_c)
                if (isinstance(fn_c, ast.Constant)
                        and isinstance(fn_c.value, str) and steps):
                    orderings[k.value] = (
                        fn_c.value, tuple(steps), mod.name, mod.relpath, v)
    if not fenced:
        inst = _installed_tree("repo/repository.py")
        fams = _literal_strs(
            _assign_value(inst, "FENCED_KEY_FAMILIES")) if inst else None
        if fams:
            fenced = tuple(fams)

    return FaultLaws(
        retried_ops=frozenset(retried or ()),
        single_attempt_ops=frozenset(single or ()),
        classify_branches=branches,
        classify_relpath=classify_rp,
        classify_aliases=aliases,
        fenced_families=fenced,
        orderings=orderings,
    )


# -- block / statement helpers -----------------------------------------------


def _scan_roots(stmt: ast.stmt) -> list:
    """The expression parts a statement owns directly (compound bodies
    are separate statements the block walk visits itself)."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in stmt.items]
    if isinstance(stmt, ast.Try):
        return []
    return [stmt]


def _child_blocks(stmt: ast.stmt) -> list:
    blocks = []
    for name in ("body", "orelse", "finalbody"):
        block = getattr(stmt, name, None)
        if isinstance(block, list) and block and isinstance(
                block[0], ast.stmt):
            blocks.append(block)
    for handler in getattr(stmt, "handlers", []) or []:
        blocks.append(handler.body)
    return blocks


def _calls_in(expr: ast.AST) -> list:
    out = [n for n in _walk_skip_defs(expr) if isinstance(n, ast.Call)]
    if isinstance(expr, ast.Call):
        out.append(expr)
    return out


def _names_in(expr: ast.AST) -> set:
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}


# -- per-function environments -----------------------------------------------


@dataclass
class _Env:
    """Flow-insensitive local bindings a function's effect walk needs;
    ``parent`` chains nested defs to their enclosing scope (closure
    reads — how ``lock()``'s nested ``refresh`` sees the policy bound
    in ``lock()``'s body)."""
    stores: dict = field(default_factory=dict)    # name -> kind
    flags: set = field(default_factory=set)       # proven-wrap booleans
    policies: dict = field(default_factory=dict)  # name -> "full"|"scoped"
    prefixes: dict = field(default_factory=dict)  # name -> key literal head
    parent: Optional["_Env"] = None

    def store_kind(self, name: str) -> Optional[str]:
        env: Optional[_Env] = self
        while env is not None:
            if name in env.stores:
                return env.stores[name]
            env = env.parent
        return None

    def is_flag(self, name: str) -> bool:
        env: Optional[_Env] = self
        while env is not None:
            if name in env.flags:
                return True
            env = env.parent
        return False

    def policy_kind(self, name: str) -> Optional[str]:
        env: Optional[_Env] = self
        while env is not None:
            if name in env.policies:
                return env.policies[name]
            env = env.parent
        return None

    def prefix_of(self, name: str) -> Optional[str]:
        env: Optional[_Env] = self
        while env is not None:
            if name in env.prefixes:
                return env.prefixes[name]
            env = env.parent
        return None


def _ann_name(node: Optional[ast.AST]) -> Optional[str]:
    if node is None:
        return None
    chain = attr_chain(node)
    return chain[-1] if chain else None


def _storeish_ann(ann: Optional[str]) -> bool:
    return ann is not None and (ann == "ObjectStore" or ann.endswith("Store"))


def _policy_ctor_kind(value: ast.AST) -> Optional[str]:
    """``RetryPolicy(...)`` / ``RetryPolicy.from_env(...)`` ->
    "scoped" when built with ``classify_fn=`` (replaces the weather
    classifier: retries only its own protocol signal), else "full"."""
    if not isinstance(value, ast.Call):
        return None
    chain = attr_chain(value.func)
    if not chain:
        return None
    is_policy = (chain[-1] == "RetryPolicy"
                 or (len(chain) >= 2 and chain[-1] == "from_env"
                     and chain[-2] == "RetryPolicy"))
    if not is_policy:
        return None
    for kw in value.keywords:
        if kw.arg == "classify_fn":
            return "scoped"
    return "full"


def _store_value_kind(value: ast.AST, params: dict) -> Optional[str]:
    """Kind of a value assigned into a store slot: a ``ResilientStore``
    ctor is proven resilient; a store-typed/-named param or an
    ``open_store(...)`` result is a boundary ObjectStore."""
    if isinstance(value, ast.Call):
        chain = attr_chain(value.func)
        if chain:
            if chain[-1].endswith("ResilientStore"):
                return "resilient"
            if chain[-1] == "open_store":
                return "boundary"
    if isinstance(value, ast.Name):
        if value.id in params:
            if _storeish_ann(params[value.id]) or \
                    value.id.lower().endswith("store"):
                return "boundary"
        elif value.id.lower().endswith("store"):
            return "boundary"
    return None


def _is_wrap_flag(value: ast.AST) -> bool:
    """``isinstance(x, ResilientStore)`` — the proven-wrap boolean the
    branch refinement keys on (repository's ``_store_retries``)."""
    if not (isinstance(value, ast.Call) and isinstance(value.func, ast.Name)
            and value.func.id == "isinstance" and len(value.args) == 2):
        return False
    chain = attr_chain(value.args[1])
    return bool(chain) and chain[-1].endswith("ResilientStore")


def _literal_head(value: ast.AST) -> Optional[str]:
    """Leading string literal of a key expression: a constant, an
    f-string's literal head, or the left side of ``"lit" + x``."""
    if isinstance(value, ast.Constant) and isinstance(value.value, str):
        return value.value
    if isinstance(value, ast.JoinedStr) and value.values:
        head = value.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            return head.value
    if isinstance(value, ast.BinOp) and isinstance(value.op, ast.Add):
        return _literal_head(value.left)
    return None


# -- effect records ----------------------------------------------------------


@dataclass
class Effect:
    """One store-op call site with its proven retry context."""
    op: str
    recv: str
    node: ast.AST
    relpath: str
    fn: str                       # qualname of the enclosing function
    kind: str                     # "bare" | "boundary" | "resilient"
    layers: tuple = ()            # descriptions of counted retry layers
    scoped: tuple = ()            # scoped policies seen (not layers)
    prefix: Optional[str] = None  # concrete key-literal head
    pidx: Optional[int] = None    # param index the key derives from
    sanctioned: bool = False

    @property
    def line(self) -> int:
        return getattr(self.node, "lineno", 0)


@dataclass
class FxSummary:
    qual: str
    relpath: str
    effects: list = field(default_factory=list)
    raises: list = field(default_factory=list)   # (type name, node)

    @property
    def exposed(self) -> list:
        return [e for e in self.effects
                if not e.layers and not e.sanctioned]

    @property
    def covered_once(self) -> list:
        return [e for e in self.effects if len(e.layers) == 1]


@dataclass(frozen=True)
class _Edge:
    caller: str
    relpath: str
    line: int
    kind: str                 # "call" | "policy" | "policy-scoped"
    ctx: Optional[str]        # branch-refined receiver ctx at the site
    node_id: int


# -- the model ---------------------------------------------------------------


class FxModel:
    """Effect-and-exception inference over one ProjectIndex, shared by
    the five VL6xx rules (``model_for`` memoizes per index)."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self.laws = resolve_laws(index)
        self.summaries: dict[str, FxSummary] = {}
        self.findings: list[Finding] = []
        self._fis: dict[str, FunctionInfo] = {}
        self._mods: dict[str, ModuleInfo] = {}   # qual -> module
        self._envs: dict[str, _Env] = {}
        self._edge_ctx: dict[int, Optional[str]] = {}
        self._site_nodes: dict[int, tuple] = {}  # id -> (fi, node)
        # (caller, callee, relpath, line, policy_kind, ctx, node)
        self.policy_edges: list[tuple] = []
        # (callee_qual, pidx) -> list of (prefix|("param", caller, i), hop)
        self._flows: dict[tuple, list] = {}
        self.param_prefixes: dict[tuple, set] = {}
        self._class_stores: dict[str, dict] = {}
        self._class_flags: dict[str, set] = {}
        self._class_policies: dict[str, dict] = {}
        self._emitted: set = set()
        self._build()

    # -- construction --------------------------------------------------------

    def _build(self) -> None:
        self._scan_classes()
        for mod in self.index.modules.values():
            if not (_in_effect_scope(mod) or _in_raise_scope(mod)):
                continue
            for qual in sorted(set(mod.functions.values())):
                fi = self.index.functions.get(qual)
                if fi is not None:
                    self._analyze_function(fi, mod)
            for ci in mod.classes.values():
                for fi in ci.methods.values():
                    self._analyze_function(fi, mod)
            self._analyze_module_body(mod)
        # nested defs aren't in ModuleInfo.functions — sweep the full
        # function table for anything in scope the loops above missed.
        for qual, fi in self.index.functions.items():
            mod = self.index.modules.get(fi.module)
            if mod is not None and (_in_effect_scope(mod)
                                    or _in_raise_scope(mod)):
                self._analyze_function(fi, mod)
        self._solve_param_prefixes()
        self._incoming = self._build_incoming()
        self._check_unprotected()     # VL601
        self._check_stacking()        # VL602
        self._check_taxonomy()        # VL603
        self._check_fencing()         # VL604
        self._check_orderings()       # VL605

    def _scan_classes(self) -> None:
        for mod in self.index.modules.values():
            for ci in mod.classes.values():
                stores: dict = {}
                flags: set = set()
                policies: dict = {}
                init = ci.methods.get("__init__")
                params: dict = {}
                if init is not None:
                    args = init.node.args
                    for a in [*args.posonlyargs, *args.args,
                              *args.kwonlyargs]:
                        params[a.arg] = _ann_name(a.annotation)
                    for node in _walk_skip_defs(init.node):
                        if not isinstance(node, ast.Assign):
                            continue
                        for tgt in node.targets:
                            chain = attr_chain(tgt)
                            if not (chain and len(chain) == 2
                                    and chain[0] == "self"):
                                continue
                            attr = chain[1]
                            kind = _store_value_kind(node.value, params)
                            if kind is None and \
                                    attr.lower().endswith("store"):
                                kind = "boundary"
                            if kind is not None:
                                stores[attr] = kind
                            if _is_wrap_flag(node.value):
                                flags.add(attr)
                            pk = _policy_ctor_kind(node.value)
                            if pk is not None:
                                policies[attr] = pk
                if stores:
                    self._class_stores[ci.qualname] = stores
                if flags:
                    self._class_flags[ci.qualname] = flags
                if policies:
                    self._class_policies[ci.qualname] = policies

    def _class_lookup(self, table: dict, clsqual: Optional[str],
                      attr: str):
        seen: set = set()
        while clsqual is not None and clsqual not in seen:
            seen.add(clsqual)
            entry = table.get(clsqual)
            if entry is not None and attr in entry:
                return entry[attr] if isinstance(entry, dict) else True
            ci = self.index.classes.get(clsqual)
            clsqual = ci.bases[0] if ci is not None and ci.bases else None
        return None

    def field_store_kind(self, clsqual, attr) -> Optional[str]:
        kind = self._class_lookup(self._class_stores, clsqual, attr)
        if kind is None and attr.lower().endswith("store"):
            return "boundary"
        return kind

    def field_is_flag(self, clsqual, attr) -> bool:
        seen: set = set()
        while clsqual is not None and clsqual not in seen:
            seen.add(clsqual)
            if attr in self._class_flags.get(clsqual, ()):
                return True
            ci = self.index.classes.get(clsqual)
            clsqual = ci.bases[0] if ci is not None and ci.bases else None
        return False

    def field_policy_kind(self, clsqual, attr) -> Optional[str]:
        return self._class_lookup(self._class_policies, clsqual, attr)

    # -- environments --------------------------------------------------------

    def _env_for(self, fi: FunctionInfo) -> _Env:
        env = self._envs.get(fi.qualname)
        if env is not None:
            return env
        parent_env = None
        if fi.parent is not None:
            parent_fi = self.index.functions.get(fi.parent)
            if parent_fi is not None:
                parent_env = self._env_for(parent_fi)
        env = _Env(parent=parent_env)
        self._envs[fi.qualname] = env   # before the walk: cycle guard
        node = fi.node
        args = getattr(node, "args", None)
        if args is not None:
            for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
                ann = _ann_name(a.annotation)
                if _storeish_ann(ann) or a.arg.lower().endswith("store"):
                    if a.arg not in ("self", "cls"):
                        env.stores[a.arg] = "boundary"
        for sub in _walk_skip_defs(node):
            if not isinstance(sub, ast.Assign):
                continue
            for tgt in sub.targets:
                if not isinstance(tgt, ast.Name):
                    continue
                name = tgt.id
                kind = _store_value_kind(sub.value, {})
                if kind is not None:
                    env.stores.setdefault(name, kind)
                if _is_wrap_flag(sub.value):
                    env.flags.add(name)
                pk = _policy_ctor_kind(sub.value)
                if pk is not None:
                    env.policies[name] = pk
                head = _literal_head(sub.value)
                if head is not None:
                    env.prefixes.setdefault(name, head)
        return env

    def _module_env(self, mod: ModuleInfo) -> _Env:
        key = "<module>:" + mod.name
        env = self._envs.get(key)
        if env is None:
            env = _Env()
            for stmt in mod.ctx.tree.body:
                if isinstance(stmt, ast.Assign):
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            head = _literal_head(stmt.value)
                            if head is not None:
                                env.prefixes.setdefault(tgt.id, head)
            self._envs[key] = env
        return env

    # -- receiver / policy / flag resolution ---------------------------------

    def _recv_kind(self, chain: list, fi: Optional[FunctionInfo],
                   env: _Env) -> Optional[str]:
        if len(chain) == 1:
            name = chain[0]
            if name in ("self", "cls"):
                return None
            kind = env.store_kind(name)
            if kind is not None:
                return kind
            return "boundary" if name.lower().endswith("store") else None
        if len(chain) == 2 and chain[0] in ("self", "cls"):
            cls = fi.cls if fi is not None else None
            return self.field_store_kind(cls, chain[1])
        last = chain[-1]
        return "boundary" if last.lower().endswith("store") else None

    def _policy_kind(self, chain: list, fi: Optional[FunctionInfo],
                     env: _Env) -> Optional[str]:
        if len(chain) == 1:
            return env.policy_kind(chain[0])
        if len(chain) == 2 and chain[0] in ("self", "cls"):
            cls = fi.cls if fi is not None else None
            return self.field_policy_kind(cls, chain[1])
        return None

    def _flag_value(self, test: ast.AST, fi: Optional[FunctionInfo],
                    env: _Env) -> Optional[bool]:
        """True/False when ``test`` is (the negation of) a proven-wrap
        flag: the truthy arm runs with a ResilientStore receiver."""
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            inner = self._flag_value(test.operand, fi, env)
            return None if inner is None else not inner
        chain = attr_chain(test)
        if not chain:
            return None
        if len(chain) == 1 and env.is_flag(chain[0]):
            return True
        if len(chain) == 2 and chain[0] in ("self", "cls"):
            cls = fi.cls if fi is not None else None
            if self.field_is_flag(cls, chain[1]):
                return True
        return None

    # -- key prefixes --------------------------------------------------------

    def _key_prefix(self, expr: ast.AST, fi: Optional[FunctionInfo],
                    env: _Env, depth: int = 0) -> Optional[str]:
        """Concrete leading literal of a key expression, seeing through
        local literal assigns and single-return key-helper functions
        (``pack_key(p)`` -> ``"data/"``)."""
        head = _literal_head(expr)
        if head is not None:
            return head
        if depth > 3:
            return None
        if isinstance(expr, ast.Name):
            return env.prefix_of(expr.id)
        if isinstance(expr, ast.Call):
            site = self.index.site_by_node.get(id(expr))
            callee = site.callee if site is not None else None
            helper = self.index.functions.get(callee) if callee else None
            if helper is not None:
                body = [s for s in helper.node.body
                        if not (isinstance(s, ast.Expr) and isinstance(
                            s.value, ast.Constant))]
                if len(body) == 1 and isinstance(body[0], ast.Return) \
                        and body[0].value is not None:
                    return self._key_prefix(
                        body[0].value, helper, _Env(), depth + 1)
        return None

    def _param_index(self, expr: ast.AST,
                     fi: Optional[FunctionInfo]) -> Optional[int]:
        if fi is None or not isinstance(expr, ast.Name):
            return None
        try:
            return fi.params.index(expr.id)
        except ValueError:
            return None

    # -- the walk ------------------------------------------------------------

    def _analyze_module_body(self, mod: ModuleInfo) -> None:
        qual = mod.name
        if qual in self.summaries:
            return
        summary = FxSummary(qual=qual, relpath=mod.relpath)
        self.summaries[qual] = summary
        self._mods[qual] = mod
        self._walk_block(
            mod.ctx.tree.body, None, None, self._module_env(mod), mod,
            summary)

    def _analyze_function(self, fi: FunctionInfo, mod: ModuleInfo) -> None:
        if fi.qualname in self.summaries:
            return
        summary = FxSummary(qual=fi.qualname, relpath=fi.relpath)
        self.summaries[fi.qualname] = summary
        self._fis[fi.qualname] = fi
        self._mods[fi.qualname] = mod
        env = self._env_for(fi)
        self._walk_block(fi.node.body, None, fi, env, mod, summary)

    def _walk_block(self, block: list, ctx: Optional[str],
                    fi: Optional[FunctionInfo], env: _Env,
                    mod: ModuleInfo, summary: FxSummary) -> None:
        for stmt in block:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.Raise) and stmt.exc is not None:
                exc = stmt.exc
                target = exc.func if isinstance(exc, ast.Call) else exc
                chain = attr_chain(target)
                if chain:
                    summary.raises.append((chain[-1], stmt))
            for root in _scan_roots(stmt):
                self._scan_expr(root, ctx, fi, env, mod, summary)
            if isinstance(stmt, ast.If):
                val = self._flag_value(stmt.test, fi, env)
                if val is not None:
                    on, off = ("resilient", "bare") if val else \
                        ("bare", "resilient")
                    self._walk_block(stmt.body, on, fi, env, mod, summary)
                    self._walk_block(stmt.orelse, off, fi, env, mod,
                                     summary)
                    continue
            for sub in _child_blocks(stmt):
                self._walk_block(sub, ctx, fi, env, mod, summary)

    def _scan_expr(self, root: ast.AST, ctx: Optional[str],
                   fi: Optional[FunctionInfo], env: _Env,
                   mod: ModuleInfo, summary: FxSummary) -> None:
        handled: set = set()
        for call in _calls_in(root):
            if id(call) in handled:
                continue
            chain = attr_chain(call.func)
            site = self.index.site_by_node.get(id(call))
            if site is not None:
                self._edge_ctx[id(call)] = ctx
                if fi is not None:
                    self._site_nodes[id(call)] = (fi, call)
                self._record_flows(call, site, fi, env)
            if not chain:
                continue
            # policy.call(...) — either a wrapped store op or a policy
            # edge over a project function.
            if chain[-1] == "call" and len(chain) >= 2:
                pk = self._policy_kind(chain[:-1], fi, env)
                if pk is not None and call.args:
                    self._handle_policy_call(
                        call, chain[:-1], pk, ctx, fi, env, mod, summary,
                        handled)
                    continue
            if chain[-1] in STORE_METHODS and len(chain) >= 2 and \
                    _in_effect_scope(mod):
                self._record_effect(call, chain, (), (), ctx, fi, env,
                                    mod, summary)

    def _handle_policy_call(self, call: ast.Call, pchain: list, pk: str,
                            ctx, fi, env, mod, summary,
                            handled: set) -> None:
        pol_desc = "%s RetryPolicy %s" % (
            "scoped" if pk == "scoped" else "full", ".".join(pchain))
        target = call.args[0]
        tchain = attr_chain(target)
        if tchain and tchain[-1] in STORE_METHODS and len(tchain) >= 2:
            # policy.call(store.op, ...) — the op itself, under pk.
            if _in_effect_scope(mod):
                layers = (pol_desc,) if pk == "full" else ()
                scoped = (pol_desc,) if pk == "scoped" else ()
                self._record_effect(call, tchain, layers, scoped, ctx,
                                    fi, env, mod, summary,
                                    key_arg_offset=1)
            return
        callee = self._resolve_fn_ref(target, fi, mod)
        if callee is not None and fi is not None:
            self.policy_edges.append(
                (summary.qual, callee, summary.relpath,
                 getattr(call, "lineno", 0), pk, ctx, call))

    def _resolve_fn_ref(self, target: ast.AST, fi: Optional[FunctionInfo],
                        mod: ModuleInfo) -> Optional[str]:
        chain = attr_chain(target)
        if not chain:
            return None
        if len(chain) == 1:
            name = chain[0]
            enc = fi
            while enc is not None:   # nested defs of the enclosing chain
                if name in enc.nested:
                    return enc.nested[name]
                enc = self.index.functions.get(enc.parent) \
                    if enc.parent else None
            return mod.functions.get(name)
        if len(chain) == 2 and chain[0] in ("self", "cls") and \
                fi is not None and fi.cls is not None:
            ci = self.index.classes.get(fi.cls)
            if ci is not None:
                return self.index._method_on_class(ci, chain[1])
        return None

    def _record_effect(self, call: ast.Call, chain: list, layers: tuple,
                       scoped: tuple, ctx, fi, env, mod, summary,
                       key_arg_offset: int = 0) -> None:
        op = chain[-1]
        recv_chain = chain[:-1]
        kind = self._recv_kind(recv_chain, fi, env)
        if kind is None:
            return
        if kind == "boundary" and ctx is not None:
            kind = ctx
        if kind == "resilient" and op in self.laws.retried_ops:
            layers = layers + ("ResilientStore (proven wrap)",)
        elif kind == "boundary" and op in self.laws.retried_ops:
            layers = layers + (
                "ResilientStore boundary (open_store contract)",)
        key_expr = call.args[key_arg_offset] if \
            len(call.args) > key_arg_offset else None
        prefix = pidx = None
        if key_expr is not None:
            prefix = self._key_prefix(key_expr, fi, env)
            if prefix is None:
                pidx = self._param_index(key_expr, fi)
        effect = Effect(
            op=op, recv=".".join(recv_chain), node=call,
            relpath=summary.relpath, fn=summary.qual, kind=kind,
            layers=layers, scoped=scoped, prefix=prefix, pidx=pidx,
            sanctioned=op in self.laws.single_attempt_ops)
        summary.effects.append(effect)
        if len(effect.layers) >= 2:
            self._emit(finding_at(
                effect.relpath, call, "VL602",
                "two retry layers on one call path: %s and %s — retry "
                "budgets multiply (the _upload_policy-over-ResilientStore "
                "bug class); "
                "keep exactly one layer per path"
                % (effect.layers[0], effect.layers[1]),
                severity="error"))

    def _record_flows(self, call: ast.Call, site, fi: Optional[FunctionInfo],
                      env: _Env) -> None:
        """Concrete key prefixes (and caller-param hand-offs) flowing
        into callee positional params — solved to a fixpoint so a
        helper's ``self.store.put(key, ...)`` learns its key family."""
        callee = self.index.functions.get(site.callee or "")
        if callee is None:
            return
        offset = 1 if callee.params and callee.params[0] in (
            "self", "cls") else 0
        hop = "%s:%d" % (site.relpath, site.lineno)
        for i, arg in enumerate(call.args):
            pidx = i + offset
            if pidx >= len(callee.params):
                break
            prefix = self._key_prefix(arg, fi, env)
            if prefix is not None:
                self._flows.setdefault((callee.qualname, pidx), []).append(
                    (("const", prefix), hop))
                continue
            cidx = self._param_index(arg, fi)
            if cidx is not None and fi is not None:
                self._flows.setdefault((callee.qualname, pidx), []).append(
                    (("param", fi.qualname, cidx), hop))

    def _solve_param_prefixes(self) -> None:
        solved: dict[tuple, set] = {}
        changed = True
        rounds = 0
        while changed and rounds < 20:
            changed = False
            rounds += 1
            for key, flows in self._flows.items():
                cur = solved.setdefault(key, set())
                if len(cur) >= _PREFIX_SET_CAP:
                    continue
                for src, hop in flows:
                    if src[0] == "const":
                        entry = (src[1], hop)
                        if entry not in cur:
                            cur.add(entry)
                            changed = True
                    else:
                        for p, chain_hop in solved.get(
                                (src[1], src[2]), set()):
                            entry = (p, "%s <- %s" % (hop, chain_hop))
                            if len(cur) < _PREFIX_SET_CAP and \
                                    entry not in cur:
                                cur.add(entry)
                                changed = True
        self.param_prefixes = solved

    # -- interprocedural plumbing --------------------------------------------

    def _build_incoming(self) -> dict[str, list]:
        incoming: dict[str, list] = {}
        for caller, sites in self.index.calls.items():
            if caller not in self.summaries:
                continue
            for site in sites:
                callee = site.callee
                if callee is None or callee not in self.summaries:
                    continue
                incoming.setdefault(callee, []).append(_Edge(
                    caller=caller, relpath=site.relpath, line=site.lineno,
                    kind="call", ctx=self._edge_ctx.get(id(site.node)),
                    node_id=id(site.node)))
        for caller, callee, relpath, line, pk, ctx, node in \
                self.policy_edges:
            if callee in self.summaries:
                incoming.setdefault(callee, []).append(_Edge(
                    caller=caller, relpath=relpath, line=line,
                    kind="policy" if pk == "full" else "policy-scoped",
                    ctx=ctx, node_id=id(node)))
        for edges in incoming.values():
            edges.sort(key=lambda e: (e.relpath, e.line, e.caller))
        return incoming

    def _root_chain(self, start: str, edge_covered) -> Optional[list]:
        """BFS from ``start`` toward callers; the first *root* (no
        incoming edges) reached without crossing a covering edge is
        the uncovered path — its hop chain, caller-first last.  None
        when every path to a root is covered."""
        from collections import deque
        queue = deque([(start, [])])
        visited = {start}
        while queue:
            qual, chain = queue.popleft()
            if len(chain) >= _HOP_CAP:
                continue
            edges = self._incoming.get(qual, [])
            if not edges:
                return chain
            for e in edges:
                if edge_covered(e) or e.caller in visited:
                    continue
                visited.add(e.caller)
                queue.append((e.caller, chain + [e]))
        return None

    @staticmethod
    def _hop_text(chain: list) -> str:
        parts = []
        for e in chain:
            caller = e.caller.rsplit(".", 1)[-1]
            note = " via scoped policy (no weather retry)" \
                if e.kind == "policy-scoped" else ""
            parts.append(" <- called from %s() at %s:%d%s"
                         % (caller, e.relpath, e.line, note))
        return "".join(parts)

    def _emit(self, finding: Finding) -> None:
        key = (finding.path, finding.line, finding.code, finding.message)
        if key not in self._emitted:
            self._emitted.add(key)
            self.findings.append(finding)

    # -- VL601: unprotected network effect -----------------------------------

    def _check_unprotected(self) -> None:
        def covered(e: _Edge) -> bool:
            return e.kind == "policy"

        for qual in sorted(self.summaries):
            summary = self.summaries[qual]
            mod = self._mods.get(qual)
            if mod is None or not _in_effect_scope(mod):
                continue
            for effect in summary.exposed:
                chain = self._root_chain(qual, covered)
                if chain is None:
                    continue
                fn = qual.rsplit(".", 1)[-1]
                self._emit(finding_at(
                    effect.relpath, effect.node, "VL601",
                    "store op %s.%s() can run with no retry layer: "
                    "effect in %s()%s reaches a call-graph root "
                    "uncovered — wrap the path in ResilientStore or a "
                    "RetryPolicy, or sanction the op in "
                    "resilience.SINGLE_ATTEMPT_OPS"
                    % (effect.recv, effect.op, fn, self._hop_text(chain)),
                    severity="error"))

    # -- VL602: retry stacking (policy over an already-covered chain) --------

    def _check_stacking(self) -> None:
        cov: dict[str, dict] = {}
        for qual, summary in self.summaries.items():
            entries = {}
            for effect in summary.covered_once:
                entries[(effect.relpath, effect.line)] = (effect, ())
            if entries:
                cov[qual] = entries
        changed = True
        rounds = 0
        while changed and rounds < 30:
            changed = False
            rounds += 1
            for callee, entries in list(cov.items()):
                for e in self._incoming.get(callee, []):
                    if e.kind != "call":
                        continue
                    target = cov.setdefault(e.caller, {})
                    if len(target) >= _COV_SET_CAP:
                        continue
                    hop = "%s() called at %s:%d" % (
                        callee.rsplit(".", 1)[-1], e.relpath, e.line)
                    for key, (effect, chain) in entries.items():
                        if key in target or len(chain) >= _COV_CHAIN_CAP:
                            continue
                        target[key] = (effect, chain + (hop,))
                        changed = True
        for caller, callee, relpath, line, pk, ctx, node in \
                self.policy_edges:
            if pk != "full":
                continue
            for key, (effect, chain) in cov.get(callee, {}).items():
                if ctx == "bare" and effect.kind == "boundary" and \
                        effect.layers and "boundary" in effect.layers[0]:
                    continue  # branch-proven bare on this arm
                hops = "".join(" <- %s" % h for h in chain)
                self._emit(finding_at(
                    relpath, node, "VL602",
                    "retry stacking: this RetryPolicy wraps a call "
                    "chain whose store op %s() at %s:%d already runs "
                    "under %s%s — retry budgets multiply; keep exactly "
                    "one layer per path"
                    % (effect.op, effect.relpath, effect.line,
                       effect.layers[0], hops),
                    severity="error"))

    # -- VL603: exception-taxonomy drift -------------------------------------

    def _type_known(self, name: str) -> bool:
        if "." in name:
            # dotted external ref (http.client.HTTPException): known
            # when its root module/alias is importable in classify's
            # module
            return name.split(".", 1)[0] in self.laws.classify_aliases
        if name in _BUILTIN_BASES or name in self.laws.classify_aliases:
            return True
        return any(q.rsplit(".", 1)[-1] == name for q in self.index.classes)

    def _bases_of(self, name: str) -> list:
        name = name.rsplit(".", 1)[-1]
        bases = list(_BUILTIN_BASES.get(name, ()))
        for qual, ci in self.index.classes.items():
            if qual.rsplit(".", 1)[-1] == name:
                bases.extend(b.rsplit(".", 1)[-1] for b in ci.bases)
                # ClassInfo.bases resolves project classes only —
                # builtin bases (FixError(ValueError)) live in the AST
                for b in getattr(ci.node, "bases", []):
                    chain = attr_chain(b)
                    if chain:
                        bases.append(chain[-1])
        return bases

    def _is_subtype(self, name: str, of: str, _seen=None) -> bool:
        name, of = name.rsplit(".", 1)[-1], of.rsplit(".", 1)[-1]
        if name == of:
            return True
        if _seen is None:
            _seen = set()
        if name in _seen:
            return False
        _seen.add(name)
        return any(self._is_subtype(b, of, _seen)
                   for b in self._bases_of(name))

    def _check_taxonomy(self) -> None:
        for qual in sorted(self.summaries):
            mod = self._mods.get(qual)
            if mod is None or not _in_raise_scope(mod):
                continue
            for name, node in self.summaries[qual].raises:
                if name in _GENERIC_RAISES:
                    self._emit(finding_at(
                        self.summaries[qual].relpath, node, "VL603",
                        "raise %s in the data plane: resilience."
                        "classify() cannot type it — raise a typed "
                        "taxonomy error (TransientError kin for "
                        "weather, a ValueError/OSError subtype for "
                        "fatal) so the retry verdict stays decidable"
                        % name, severity="warning"))
        rp = self.laws.classify_relpath
        if rp is None:
            return
        prev: list = []   # (names, lineno) of earlier types branches
        for tag, names, lineno, _verdict in self.laws.classify_branches:
            if tag != "types":
                continue
            anchor = ast.Constant(value=0)
            anchor.lineno, anchor.col_offset = lineno, 0
            anchor.end_lineno, anchor.end_col_offset = lineno, 1
            for name in names:
                if not self._type_known(name):
                    self._emit(finding_at(
                        rp, anchor, "VL603",
                        "classify() branch references unknown "
                        "exception type %s — taxonomy drift between "
                        "the classifier and the error types" % name,
                        severity="warning"))
            shadowed_by = None
            for pnames, plineno in prev:
                if all(any(self._is_subtype(n, p) for p in pnames)
                       for n in names):
                    shadowed_by = plineno
                    break
            if shadowed_by is not None:
                self._emit(finding_at(
                    rp, anchor, "VL603",
                    "classify() branch is dead: %s already decided by "
                    "the isinstance branch at line %d"
                    % (", ".join(names), shadowed_by),
                    severity="warning"))
            prev.append((names, lineno))

    # -- VL604: fence before publish -----------------------------------------

    def _stmt_path(self, body: list, target: ast.AST) -> Optional[list]:
        tid = id(target)
        for idx, stmt in enumerate(body):
            if stmt is target or any(id(n) == tid for n in ast.walk(stmt)):
                path = [(body, idx)]
                for sub in _child_blocks(stmt):
                    rest = self._stmt_path(sub, target)
                    if rest is not None:
                        return path + rest
                return path
        return None

    @staticmethod
    def _uncond_guard(stmt: ast.stmt) -> bool:
        """Does ``stmt`` unconditionally call _guard_publish?  Simple
        statements and ``with`` bodies count; conditional compounds
        don't."""
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return any(FxModel._uncond_guard(s) for s in stmt.body)
        if isinstance(stmt, (ast.If, ast.For, ast.AsyncFor, ast.While,
                             ast.Try, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef)):
            return False
        for call in _calls_in(stmt):
            chain = attr_chain(call.func)
            if chain and chain[-1] == "_guard_publish":
                return True
        return False

    def _guard_dominates(self, owner_body: list, node: ast.AST) -> bool:
        path = self._stmt_path(owner_body, node)
        if path is None:
            return False
        for block, idx in path:
            if any(self._uncond_guard(prior) for prior in block[:idx]):
                return True
        return False

    def _site_guarded(self, node_id: int) -> bool:
        entry = self._site_nodes.get(node_id)
        if entry is None:
            return False
        fi, node = entry
        return self._guard_dominates(fi.node.body, node)

    def _effect_families(self, effect: Effect) -> list:
        fams = self.laws.fenced_families
        if not fams:
            return []
        out = []
        if effect.prefix is not None:
            out = [f for f in fams if effect.prefix.startswith(f)]
        elif effect.pidx is not None:
            solved = self.param_prefixes.get(
                (effect.fn, effect.pidx), set())
            out = sorted({f for p, _hop in solved for f in fams
                          if p.startswith(f)})
        return out

    def _check_fencing(self) -> None:
        def covered(e: _Edge) -> bool:
            return self._site_guarded(e.node_id)

        for qual in sorted(self.summaries):
            summary = self.summaries[qual]
            mod = self._mods.get(qual)
            if mod is None or not _in_effect_scope(mod):
                continue
            fi = self._fis.get(qual)
            owner_body = fi.node.body if fi is not None else \
                mod.ctx.tree.body
            for effect in summary.effects:
                if effect.op not in MUTATING_OPS:
                    continue
                fams = self._effect_families(effect)
                if not fams:
                    continue
                if self._guard_dominates(owner_body, effect.node):
                    continue
                chain = self._root_chain(qual, covered)
                if chain is None:
                    continue
                self._emit(finding_at(
                    effect.relpath, effect.node, "VL604",
                    "unfenced %r-family publish: %s.%s() in %s()%s is "
                    "not dominated by _guard_publish on every path — "
                    "a fenced-out writer could publish stale state "
                    "(docs/robustness.md, multi-writer protocol)"
                    % (fams[0], effect.recv, effect.op,
                       qual.rsplit(".", 1)[-1], self._hop_text(chain)),
                    severity="error"))

    # -- VL605: crash ordering -----------------------------------------------

    def _ordering_calls(self, fi: FunctionInfo, env: _Env) -> list:
        """(call, chain, derived-names) in source order, with one level
        of enclosing-``for`` target->iter name transfer so
        ``for k in superseded: store.delete(k)`` derives from
        ``superseded``."""
        out = []

        def walk(block, for_stack):
            for stmt in block:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.ClassDef)):
                    continue
                for root in _scan_roots(stmt):
                    for call in _calls_in(root):
                        chain = attr_chain(call.func)
                        if chain:
                            out.append((call, chain, list(for_stack)))
                sub_stack = for_stack
                if isinstance(stmt, (ast.For, ast.AsyncFor)):
                    sub_stack = for_stack + [
                        (_names_in(stmt.target), _names_in(stmt.iter))]
                for sub in _child_blocks(stmt):
                    walk(sub, sub_stack)

        walk(fi.node.body, [])
        out.sort(key=lambda item: (
            getattr(item[0], "lineno", 0),
            getattr(item[0], "col_offset", 0)))
        return out

    def _match_step(self, step: str, call: ast.Call, chain: list,
                    for_stack: list, fi: FunctionInfo,
                    env: _Env) -> bool:
        if step.startswith("delete-prefix:"):
            if chain[-1] != "delete" or not call.args:
                return False
            prefix = self._key_prefix(call.args[0], fi, env)
            want = step.split(":", 1)[1]
            return prefix is not None and prefix.startswith(want)
        if step.startswith("delete-of:"):
            if chain[-1] != "delete" or not call.args:
                return False
            names = _names_in(call.args[0])
            for targets, iters in for_stack:
                if targets & names:
                    names = names | iters
            return step.split(":", 1)[1] in names
        return chain[-1] == step

    def _check_orderings(self) -> None:
        for law in sorted(self.laws.orderings):
            fnname, steps, mod_name, decl_rp, decl_node = \
                self.laws.orderings[law]
            target = None
            for qual, fi in sorted(self.index.functions.items()):
                if fi.module == mod_name and \
                        qual.rsplit(".", 1)[-1] == fnname:
                    target = fi
                    break
            if target is None:
                self._emit(finding_at(
                    decl_rp, decl_node, "VL605",
                    "crash-ordering law %r: declared function %r not "
                    "found in %s" % (law, fnname, mod_name),
                    severity="error"))
                continue
            env = self._env_for(target)
            calls = self._ordering_calls(target, env)
            first: dict[str, tuple] = {}
            for step in steps:
                for call, chain, for_stack in calls:
                    if self._match_step(step, call, chain, for_stack,
                                        target, env):
                        first[step] = (getattr(call, "lineno", 0), call)
                        break
            missing = [s for s in steps if s not in first]
            if missing:
                self._emit(finding_at(
                    target.relpath, target.node, "VL605",
                    "crash-ordering law %r: declared step %r never "
                    "occurs in %s() — declared order: %s"
                    % (law, missing[0], fnname, " < ".join(steps)),
                    severity="error"))
                continue
            for a, b in zip(steps, steps[1:]):
                if first[a][0] > first[b][0]:
                    self._emit(finding_at(
                        target.relpath, first[b][1], "VL605",
                        "crash-ordering law %r: step %r (line %d) must "
                        "not run before %r (line %d) — declared order: "
                        "%s (a crash between them is unrecoverable)"
                        % (law, b, first[b][0], a, first[a][0],
                           " < ".join(steps)),
                        severity="error"))
                    break


_MODELS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def model_for(index: ProjectIndex) -> FxModel:
    model = _MODELS.get(index)
    if model is None:
        model = FxModel(index)
        _MODELS[index] = model
    return model


# -- rules -------------------------------------------------------------------


class _FxRule:
    def check_project(self, index: ProjectIndex) -> Iterator[Finding]:
        for f in model_for(index).findings:
            if f.code == self.code:
                yield f


class UnprotectedEffectRule(_FxRule):
    code = "VL601"
    name = "unprotected-network-effect"
    severity = "error"
    description = ("store op reachable from a data-plane root with no "
                   "retry layer (ResilientStore wrap or RetryPolicy) on "
                   "some call path; single-attempt ops sanctioned via "
                   "resilience.SINGLE_ATTEMPT_OPS")


class RetryStackingRule(_FxRule):
    code = "VL602"
    name = "retry-stacking"
    severity = "error"
    description = ("two retry layers proved on one call chain — a "
                   "policy over a ResilientStore-covered op (the "
                   "_upload_policy bug class); budgets multiply")


class TaxonomyDriftRule(_FxRule):
    code = "VL603"
    name = "exception-taxonomy-drift"
    severity = "warning"
    description = ("generic raise in the data plane that classify() "
                   "cannot type, a classify branch naming an unknown "
                   "exception type, or a dead classify branch shadowed "
                   "by an earlier isinstance")


class UnfencedPublishRule(_FxRule):
    code = "VL604"
    name = "unfenced-publish"
    severity = "error"
    description = ("put into a fenced key family "
                   "(repository.FENCED_KEY_FAMILIES) not dominated by "
                   "_guard_publish on every path, interprocedural")


class CrashOrderingRule(_FxRule):
    code = "VL605"
    name = "crash-ordering-violation"
    severity = "error"
    description = ("a declared two-phase sequence (CRASH_ORDERINGS next "
                   "to the protocol code) with a missing step or a step "
                   "out of declared order")


def default_fx_rules() -> list:
    return [UnprotectedEffectRule(), RetryStackingRule(),
            TaxonomyDriftRule(), UnfencedPublishRule(),
            CrashOrderingRule()]


# -- cache fact kind ---------------------------------------------------------


def summaries_for(index: ProjectIndex) -> dict[str, dict]:
    """Per-file fault-path facts — the cached "fx" fact kind.  A file's
    summary changes iff its effect surface (store ops, their retry
    layers, raise types) changes, so the cache layer can replay clean
    files verbatim."""
    model = model_for(index)
    out: dict[str, dict] = {}
    for qual in sorted(model.summaries):
        s = model.summaries[qual]
        if not s.effects and not s.raises:
            continue
        entry = out.setdefault(s.relpath, {"effects": {}, "raises": {}})
        if s.effects:
            entry["effects"][qual] = [
                [e.op, e.recv, e.line, e.kind, len(e.layers)]
                for e in s.effects]
        if s.raises:
            entry["raises"][qual] = sorted(
                {name for name, _node in s.raises})
    return out


# -- effect-graph export & bridge helpers ------------------------------------


def effects_json(index: ProjectIndex) -> dict:
    """The inferred effect graph as plain JSON for offline diffing —
    the ``volsync lint --dump-effects`` payload."""
    model = model_for(index)
    laws = model.laws
    nodes = []
    for qual in sorted(model.summaries):
        s = model.summaries[qual]
        if not s.effects and not s.raises:
            continue
        nodes.append({
            "fn": qual, "file": s.relpath,
            "effects": [{
                "op": e.op, "recv": e.recv, "line": e.line,
                "kind": e.kind, "layers": list(e.layers),
                "scoped": list(e.scoped), "prefix": e.prefix,
                "sanctioned": e.sanctioned,
            } for e in s.effects],
            "raises": sorted({name for name, _ in s.raises}),
        })
    edges = []
    for callee, incoming in sorted(model._incoming.items()):
        for e in incoming:
            edges.append({"from": e.caller, "to": callee,
                          "at": "%s:%d" % (e.relpath, e.line),
                          "kind": e.kind})
    return {
        "laws": {
            "retried_ops": sorted(laws.retried_ops),
            "single_attempt_ops": sorted(laws.single_attempt_ops),
            "fenced_families": list(laws.fenced_families),
            "orderings": {
                law: {"fn": fn, "steps": list(steps), "module": mod_name}
                for law, (fn, steps, mod_name, _rp, _node)
                in sorted(laws.orderings.items())},
            "classify": [
                {"types": names, "line": lineno, "verdict": verdict}
                for tag, names, lineno, verdict in laws.classify_branches
                if tag == "types"],
        },
        "nodes": nodes,
        "edges": edges,
    }


def static_fault_edges(index: ProjectIndex) -> dict:
    """The static half of the runtime⊆static fault bridge: every
    (op, key-prefix) effect edge the model inferred, plus the exception
    roots classify() decides retryable/fatal.  The chaos-schedule test
    asserts every FaultStore-observed (site, exception-type) edge is
    covered here."""
    model = model_for(index)
    edges: set = set()
    for s in model.summaries.values():
        for e in s.effects:
            if e.prefix is not None:
                edges.add((e.op, e.prefix))
            elif e.pidx is not None:
                solved = model.param_prefixes.get((e.fn, e.pidx), set())
                if solved:
                    for p, _hop in solved:
                        edges.add((e.op, p))
                else:
                    edges.add((e.op, ""))
            else:
                edges.add((e.op, ""))
    retryable, fatal = [], []
    for tag, names, _lineno, verdict in model.laws.classify_branches:
        if tag != "types":
            continue
        (retryable if verdict else fatal).extend(
            n.rsplit(".", 1)[-1] for n in names)
    return {
        "edges": sorted(edges),
        "retryable_types": sorted(set(retryable)),
        "fatal_types": sorted(set(fatal)),
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
    """Build the effect-graph export for a path set from scratch — the
    ``volsync lint --dump-effects`` entry point."""
    return effects_json(_index_for_paths(paths))


def static_fault_edges_for_paths(paths) -> dict:
    """The static fault-edge set for a path set — what the tier-1
    runtime⊆static chaos bridge checks FaultStore observations
    against."""
    return static_fault_edges(_index_for_paths(paths))
