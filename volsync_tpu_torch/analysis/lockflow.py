"""Static lock-order analysis (VL401) over lockcheck-named locks.

Ports ``volsync_tpu/analysis/lockflow.py``, pointed at the PyTorch port.

The runtime detector (``analysis/lockcheck.py``) records the
acquisition orders that tests actually *execute*; this module proves
the orders that the code can *reach*.  It extracts per-function
lock-acquisition summaries with the same region machinery as VL101
(``with``-regions plus bare ``acquire()``…``release()`` tail spans),
propagates held-lock sets interprocedurally through the call graph,
and builds the global acquisition-order graph: an edge ``a -> b``
means some code path acquires ``b`` while holding ``a``.  Any cycle in
that graph is a potential deadlock no test has to interleave for.

Naming follows lockcheck: locks are identified by their construction
NAME (a lock class, not an instance).  Striped locks built from
f-strings — ``make_lock(f"repo.index.shard{i}")`` — canonicalise to
their literal prefix plus ``*`` (``repo.index.shard*``), so the static
graph speaks in wildcards that runtime-observed names match by prefix
(see :func:`name_matches`); that is what makes the runtime-edge ⊆
static-graph cross-check in tests/test_analysis_locks.py well-typed.
Unnamed locks stay distinct per construction site rather than unifying
into one bogus graph node.

The per-index model (regions, held sets, acquisition edges) is also
the substrate for the guarded-field rules in ``analysis/guards.py``,
and per-function summaries are cached as the "locks" fact kind so warm
``--cache`` runs skip this pass entirely.
"""

from __future__ import annotations

import ast
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator, Optional

from volsync_tpu_torch.analysis.callgraph import (
    ModuleInfo,
    ProjectIndex,
    attr_chain,
)
from volsync_tpu_torch.analysis.engine import Finding, finding_at
from volsync_tpu_torch.analysis.iprules import (
    _LOCK_CTORS,
    _ScopeMaps,
    _walk_skip_defs,
)
from volsync_tpu_torch.analysis.rules import _const_str


def lock_ctor_name(call: ast.Call, relpath: str) -> Optional[str]:
    """Lock NAME for a make_lock/make_rlock call: the literal string,
    an f-string's literal prefix + ``*`` (one wildcard lock class per
    construction site), or a site-unique placeholder when unnamed."""
    chain = attr_chain(call.func)
    if not chain or chain[-1] not in _LOCK_CTORS:
        return None
    if call.args:
        arg = call.args[0]
        lit = _const_str(arg)
        if lit is not None:
            return lit
        if isinstance(arg, ast.JoinedStr):
            prefix = ""
            for part in arg.values:
                if (isinstance(part, ast.Constant)
                        and isinstance(part.value, str)):
                    prefix += part.value
                else:
                    break
            return prefix + "*"
    return f"<unnamed:{relpath}:{call.lineno}>"


def _ctor_name_in(value: ast.AST, relpath: str) -> Optional[str]:
    """Lock name for an assignment RHS: a direct ctor call, or a lock
    stripe — a list/comprehension of ctor calls (all one name class)."""
    if isinstance(value, ast.Call):
        return lock_ctor_name(value, relpath)
    if isinstance(value, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
        return _ctor_name_in(value.elt, relpath)
    if isinstance(value, (ast.List, ast.Tuple)) and value.elts:
        names = {_ctor_name_in(e, relpath) for e in value.elts}
        names.discard(None)
        if len(names) == 1:
            return names.pop()
    return None


#: Raw stdlib lock constructors. Code outside the lockcheck-
#: instrumented data plane guards state with plain threading locks;
#: the analyzer must see those as locks too, or every correctly
#: guarded access behind one reads as unguarded (false VL402/VL404).
_RAW_LOCK_CTORS = {"Lock", "RLock", "Condition"}

#: Sentinel returned while the binding target (which names the lock)
#: isn't known yet.
_RAW = "<raw>"


def _raw_ctor_name(value: ast.AST, cls_qual: Optional[str],
                   module_locks: dict, class_locks: dict) -> Optional[str]:
    """``threading.Lock()``/``RLock()``/``Condition()`` as a lock
    binding. These have no lockcheck name, so the binding gets a
    synthetic static-only ``raw:<owner>.<attr>`` name (never observed
    at runtime, so the runtime-⊆-static check is unaffected).
    ``Condition(existing_lock)`` ALIASES the wrapped lock's name:
    ``with self._cond:`` acquires the same underlying lock."""
    if not isinstance(value, ast.Call):
        return None
    chain = attr_chain(value.func)
    if not chain or chain[-1] not in _RAW_LOCK_CTORS:
        return None
    if len(chain) >= 2 and chain[-2] != "threading":
        return None
    if chain[-1] == "Condition" and value.args:
        arg = value.args[0]
        if (isinstance(arg, ast.Attribute)
                and isinstance(arg.value, ast.Name)
                and arg.value.id == "self" and cls_qual):
            wrapped = class_locks.get(cls_qual, {}).get(arg.attr)
            if wrapped is not None:
                return wrapped
        elif isinstance(arg, ast.Name):
            wrapped = module_locks.get(arg.id)
            if wrapped is not None:
                return wrapped
    return _RAW


def lock_bindings(
        mod: ModuleInfo) -> tuple[dict[str, str], dict[str, dict[str, str]]]:
    """(module_locks {var: name}, class_locks {class_qual: {attr:
    name}}) — like iprules._lock_bindings but wildcard-aware for
    f-string names and striped-lock lists."""
    module_locks: dict[str, str] = {}
    class_locks: dict[str, dict[str, str]] = {}

    def walk(body: list, cls_qual: Optional[str]) -> None:
        for node in body:
            if isinstance(node, ast.ClassDef):
                walk(node.body, f"{_qual_prefix(node)}")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk(node.body, cls_qual)
            else:
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Assign):
                        continue
                    name = _ctor_name_in(sub.value, mod.relpath)
                    if name is None:
                        name = _raw_ctor_name(sub.value, cls_qual,
                                              module_locks, class_locks)
                    if name is None:
                        continue
                    for t in sub.targets:
                        if isinstance(t, ast.Name):
                            module_locks[t.id] = (
                                f"raw:{mod.name}.{t.id}"
                                if name is _RAW else name)
                        elif (isinstance(t, ast.Attribute)
                              and isinstance(t.value, ast.Name)
                              and t.value.id == "self" and cls_qual):
                            class_locks.setdefault(
                                cls_qual, {})[t.attr] = (
                                f"raw:{cls_qual}.{t.attr}"
                                if name is _RAW else name)
                walk([s for s in ast.iter_child_nodes(node)
                      if isinstance(s, ast.stmt)], cls_qual)

    prefixes: dict[int, str] = {}

    def _qual_prefix(node: ast.ClassDef) -> str:
        return prefixes[id(node)]

    # precompute class qualnames the same way _ScopeMaps does, so the
    # keys line up with ProjectIndex.classes
    def name_walk(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            nprefix = prefix
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nprefix = f"{prefix}.{child.name}"
            elif isinstance(child, ast.ClassDef):
                nprefix = f"{prefix}.{child.name}"
                prefixes[id(child)] = nprefix
            name_walk(child, nprefix)

    name_walk(mod.ctx.tree, mod.name)
    walk(mod.ctx.tree.body, None)
    return module_locks, class_locks


@dataclass
class Region:
    """One lock-held span: a ``with``-region or a bare acquire tail."""
    lock: str
    relpath: str
    func: str  # qualname of enclosing function, or module name
    cls: Optional[str]  # lexical class qualname, if inside a method
    header: ast.AST  # the With / acquire-Expr statement
    body: list = field(default_factory=list)


@dataclass
class LockEdge:
    """``src`` held while ``dst`` is acquired, first derivation wins.

    ``chain`` is the call path as function qualnames: the holder
    function first, then each hop down to the function that directly
    acquires ``dst``.  ``node``/``relpath``/``lineno`` locate the
    statement *inside the src region* that starts the path (the nested
    acquisition itself, or the call that reaches one)."""
    src: str
    dst: str
    relpath: str
    lineno: int
    node: ast.AST
    chain: tuple


class LockModel:
    """Whole-program lock facts for one ProjectIndex."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self.maps: dict[str, _ScopeMaps] = {}
        self.module_locks: dict[str, dict[str, str]] = {}  # relpath -> bind
        self.class_locks: dict[str, dict[str, str]] = {}  # class_qual -> bind
        self.regions: list[Region] = []
        # id(With|Expr stmt) -> ordered locks it acquires (With items)
        self._acq_stmts: dict[int, list[str]] = {}
        # func qual -> {lock: (relpath, lineno)} direct acquisitions
        self.direct: dict[str, dict[str, tuple]] = {}
        # func qual -> {lock: (chain, relpath, lineno)} transitive
        self.may: dict[str, dict[str, tuple]] = {}
        self.edges: dict[tuple, LockEdge] = {}
        # (class qualname, field) -> possible class qualnames: inferred
        # from ``self.f = ClassName(...)`` sites, so calls through
        # typed fields (``self._index.insert()``) resolve even though
        # the callgraph proper has no receiver types
        self.field_types: dict[tuple, set] = {}
        self._widened: dict[str, set] = {}
        # attr-typed call resolution: id(Call) -> callee qualnames,
        # plus the flat caller->callees edges for reachability closures
        self._attr_callees: dict[int, set] = {}
        self.extra_calls: dict[str, set] = {}
        self._extra_callers: dict[str, set] = {}
        self._fnqual: dict[int, str] = {
            id(fi.node): qual for qual, fi in index.functions.items()}
        self._build()

    # -- construction -------------------------------------------------------

    def _build(self) -> None:
        for relpath in sorted(self.index.by_relpath):
            mod = self.index.by_relpath[relpath]
            mlocks, clocks = lock_bindings(mod)
            self.module_locks[relpath] = mlocks
            self.class_locks.update(clocks)
        self._collect_field_types()
        self._resolve_attr_calls()
        for relpath in sorted(self.index.by_relpath):
            self._collect_regions(self.index.by_relpath[relpath])
        self._close_may()
        self._collect_edges()

    def _collect_field_types(self) -> None:
        for cq in sorted(self.index.classes):
            ci = self.index.classes[cq]
            mod = self.index.modules.get(ci.module)
            if mod is None:
                continue
            for fi in ci.methods.values():
                params = self._param_types(fi, mod)
                for sub in ast.walk(fi.node):
                    if not isinstance(sub, ast.Assign):
                        continue
                    classes: set = set()
                    if isinstance(sub.value, ast.Call):
                        target_cls = self._class_of_ctor(sub.value, mod)
                        if target_cls is not None:
                            classes.add(target_cls)
                    elif (isinstance(sub.value, ast.Name)
                          and sub.value.id in params):
                        classes |= params[sub.value.id]
                    if not classes:
                        continue
                    for t in sub.targets:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            self.field_types.setdefault(
                                (cq, t.attr), set()).update(classes)

    def _param_types(self, fi, mod) -> dict[str, set]:
        """{param name: widened class quals} from parameter
        annotations that resolve to project classes — so a field
        assigned FROM a parameter (``self.store = store`` with
        ``store: ObjectStore``) gets a type instead of a blind spot.
        The widening makes this a may-analysis: any implementation
        could arrive at runtime, so all of them are candidates."""
        out: dict[str, set] = {}
        a = fi.node.args
        for arg in (a.posonlyargs + a.args + a.kwonlyargs):
            if arg.annotation is None:
                continue
            cls = self._annotation_class(arg.annotation, mod)
            if cls is not None:
                out[arg.arg] = self._widen_type(cls)
        return out

    def _annotation_class(self, expr: ast.AST, mod) -> Optional[str]:
        if isinstance(expr, ast.Subscript):
            chain = attr_chain(expr.value)
            if chain and chain[-1] == "Optional":
                return self._annotation_class(expr.slice, mod)
            return None
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            try:
                parsed = ast.parse(expr.value, mode="eval").body
            except SyntaxError:
                return None
            return self._annotation_class(parsed, mod)
        chain = attr_chain(expr)
        return self._resolve_class_chain(chain, mod) if chain else None

    def _widen_type(self, cls_qual: str) -> set:
        """A declared type widened to its possible concrete classes.
        A ``Protocol`` widens structurally — every class defining ALL
        of the protocol's declared (public) methods implements it; a
        nominal class widens to itself plus its subclasses."""
        cached = self._widened.get(cls_qual)
        if cached is not None:
            return cached
        ci = self.index.classes.get(cls_qual)
        out = {cls_qual}
        if ci is not None:
            if any((attr_chain(b) or ["?"])[-1] == "Protocol"
                   for b in ci.base_exprs):
                wanted = {m for m in ci.methods if not m.startswith("_")}
                if wanted:
                    for dq in sorted(self.index.classes):
                        di = self.index.classes[dq]
                        if dq != cls_qual and wanted <= set(di.methods):
                            out.add(dq)
            else:
                for dq in sorted(self.index.classes):
                    if cls_qual in self._ancestors(dq):
                        out.add(dq)
        self._widened[cls_qual] = out
        return out

    def _ancestors(self, cls_qual: str) -> set:
        seen: set = set()
        queue = deque([cls_qual])
        while queue:
            q = queue.popleft()
            if q is None or q in seen:
                continue
            seen.add(q)
            ci = self.index.classes.get(q)
            if ci:
                queue.extend(ci.bases)
        seen.discard(cls_qual)
        return seen

    def _class_of_ctor(self, call: ast.Call, mod) -> Optional[str]:
        chain = attr_chain(call.func)
        return self._resolve_class_chain(chain, mod) if chain else None

    def _resolve_class_chain(self, chain: list, mod) -> Optional[str]:
        if len(chain) == 1 and chain[0] in mod.classes:
            return mod.classes[chain[0]].qualname
        dotted = None
        if chain[0] in mod.aliases:
            dotted = ".".join([mod.aliases[chain[0]]] + chain[1:])
        elif len(chain) > 1:
            dotted = ".".join(chain)
        if dotted is None:
            return None
        resolved = self.index.resolve_dotted(dotted)
        if resolved is None:
            return None
        if resolved in self.index.classes:
            return resolved
        if resolved.endswith(".__init__"):
            cq = resolved[:-len(".__init__")]
            if cq in self.index.classes:
                return cq
        return None

    def _field_classes(self, cls_qual: Optional[str], attr: str) -> set:
        """Field types for ``self.<attr>``, walking the base chain."""
        seen: set = set()
        out: set = set()
        queue = deque([cls_qual] if cls_qual else [])
        while queue:
            q = queue.popleft()
            if q is None or q in seen:
                continue
            seen.add(q)
            out |= self.field_types.get((q, attr), set())
            ci = self.index.classes.get(q)
            if ci:
                queue.extend(ci.bases)
        return out

    def _resolve_attr_calls(self) -> None:
        """Second-chance resolution for ``self.<field>.<method>()``
        calls the callgraph left unresolved."""
        for qual in sorted(self.index.functions):
            fi = self.index.functions[qual]
            for node in _walk_skip_defs(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                site = self.index.site_by_node.get(id(node))
                if site is not None and site.callee is not None:
                    continue
                chain = attr_chain(node.func)
                if (not chain or len(chain) != 3
                        or chain[0] != "self" or fi.cls is None):
                    continue
                targets: set = set()
                for tcq in sorted(self._field_classes(fi.cls, chain[1])):
                    ci = self.index.classes.get(tcq)
                    m = (self.index._method_on_class(ci, chain[2])
                         if ci else None)
                    if m:
                        targets.add(m)
                if not targets:
                    continue
                self._attr_callees[id(node)] = targets
                self.extra_calls.setdefault(qual, set()).update(targets)
                for t in targets:
                    self._extra_callers.setdefault(t, set()).add(qual)

    def resolve_self_lock(self, cls_qual: Optional[str],
                          attr: str) -> Optional[str]:
        """``self.<attr>`` -> lock name, walking ALL base classes
        breadth-first (inherited locks guard subclass code too)."""
        seen: set[str] = set()
        queue = deque([cls_qual] if cls_qual else [])
        while queue:
            q = queue.popleft()
            if q is None or q in seen:
                continue
            seen.add(q)
            name = self.class_locks.get(q, {}).get(attr)
            if name:
                return name
            ci = self.index.classes.get(q)
            if ci:
                queue.extend(ci.bases)
        return None

    def _context_lock(self, expr: ast.AST, relpath: str,
                      cls_qual: Optional[str]) -> Optional[str]:
        if isinstance(expr, ast.Subscript):  # striped: self._locks[s]
            expr = expr.value
        if isinstance(expr, ast.Name):
            return self.module_locks[relpath].get(expr.id)
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"):
            return self.resolve_self_lock(cls_qual, expr.attr)
        return None

    def _func_of(self, maps: _ScopeMaps, node: ast.AST,
                 mod: ModuleInfo) -> str:
        fn = maps.encl_fn.get(id(node))
        while fn is not None and id(fn) not in self._fnqual:
            fn = maps.encl_fn.get(id(fn))
        return self._fnqual[id(fn)] if fn is not None else mod.name

    def _collect_regions(self, mod: ModuleInfo) -> None:
        maps = _ScopeMaps(mod)
        self.maps[mod.relpath] = maps
        for node in ast.walk(mod.ctx.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                cq = maps.encl_cls.get(id(node))
                locks = [lk for item in node.items
                         if (lk := self._context_lock(
                             item.context_expr, mod.relpath, cq))]
                if not locks:
                    continue
                self._acq_stmts[id(node)] = locks
                func = self._func_of(maps, node, mod)
                for lk in locks:
                    self.regions.append(Region(
                        lk, mod.relpath, func, cq, node, node.body))
                    self.direct.setdefault(func, {}).setdefault(
                        lk, (mod.relpath, node.lineno))
                # ``with a, b:`` acquires in item order: a -> b
                for held, nxt in zip(locks, locks[1:]):
                    self._add_edge(held, nxt, mod.relpath, node.lineno,
                                   node, (func,))
            elif isinstance(node, ast.Expr):
                self._collect_bare_region(node, mod, maps)

    def _collect_bare_region(self, node: ast.Expr, mod: ModuleInfo,
                             maps: _ScopeMaps) -> None:
        call = node.value
        if not (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr == "acquire"):
            return
        base = attr_chain(call.func.value)
        if base is None:
            return
        cq = maps.encl_cls.get(id(node))
        lock = None
        if len(base) == 1:
            lock = self.module_locks[mod.relpath].get(base[0])
        elif base[0] == "self" and len(base) == 2:
            lock = self.resolve_self_lock(cq, base[1])
        if not lock:
            return
        block = maps.block_of(node)
        if block is None:
            return
        tail: list = []
        for stmt in block[block.index(node) + 1:]:
            tail.append(stmt)
            if any(isinstance(s, ast.Call)
                   and isinstance(s.func, ast.Attribute)
                   and s.func.attr == "release"
                   and attr_chain(s.func.value) == base
                   for s in ast.walk(stmt)):
                break
        func = self._func_of(maps, node, mod)
        self._acq_stmts[id(node)] = [lock]
        self.regions.append(Region(lock, mod.relpath, func, cq, node, tail))
        self.direct.setdefault(func, {}).setdefault(
            lock, (mod.relpath, node.lineno))

    def _close_may(self) -> None:
        """Transitive may-acquire: if f calls g and g may acquire L,
        then f may acquire L.  First (shortest-first, deterministic)
        derivation wins, so chains stay minimal and stable."""
        for qual in sorted(self.direct):
            for lk in sorted(self.direct[qual]):
                relpath, lineno = self.direct[qual][lk]
                self.may.setdefault(qual, {})[lk] = ((qual,), relpath, lineno)
        work = deque(sorted(self.may))
        while work:
            callee = work.popleft()
            facts = self.may.get(callee, {})
            for caller in self._callers_of(callee):
                cur = self.may.setdefault(caller, {})
                changed = False
                for lk in sorted(facts):
                    if lk in cur:
                        continue
                    chain, relpath, lineno = facts[lk]
                    cur[lk] = ((caller,) + chain, relpath, lineno)
                    changed = True
                if changed:
                    work.append(caller)

    def _callers_of(self, callee: str) -> Iterator[str]:
        for site in self.index.callers.get(callee, ()):  # type: ignore
            yield site.caller
        yield from sorted(self._extra_callers.get(callee, ()))

    def _add_edge(self, src: str, dst: str, relpath: str, lineno: int,
                  node: ast.AST, chain: tuple) -> None:
        self.edges.setdefault(
            (src, dst), LockEdge(src, dst, relpath, lineno, node, chain))

    def _collect_edges(self) -> None:
        for region in self.regions:
            for stmt in region.body:
                for node in self._iter_live(stmt):
                    locks = self._acq_stmts.get(id(node))
                    if locks is not None:
                        for lk in locks:
                            self._add_edge(region.lock, lk, region.relpath,
                                           node.lineno, node, (region.func,))
                        continue
                    if not isinstance(node, ast.Call):
                        continue
                    site = self.index.site_by_node.get(id(node))
                    callees = set(self._attr_callees.get(id(node), ()))
                    if site is not None and site.callee is not None:
                        callees.add(site.callee)
                    for callee in sorted(callees):
                        for lk in sorted(self.may.get(callee, ())):
                            chain, _, _ = self.may[callee][lk]
                            self._add_edge(region.lock, lk, region.relpath,
                                           node.lineno, node,
                                           (region.func,) + chain)

    @staticmethod
    def _iter_live(stmt: ast.AST) -> Iterator[ast.AST]:
        """The statement and everything under it that runs while the
        region is held — nested def/lambda bodies execute later, on
        their own call sites, so they are skipped."""
        yield stmt
        yield from _walk_skip_defs(stmt)

    # -- held-lock query (used by guards.py) --------------------------------

    def held_map(self, relpath: str) -> dict[int, frozenset]:
        """id(node) -> set of lock names held at that node, for every
        node inside some region body of this module."""
        held: dict[int, set] = {}
        for region in self.regions:
            if region.relpath != relpath:
                continue
            for stmt in region.body:
                for node in self._iter_live(stmt):
                    held.setdefault(id(node), set()).add(region.lock)
        return {k: frozenset(v) for k, v in held.items()}


_MODELS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def model_for(index: ProjectIndex) -> LockModel:
    model = _MODELS.get(index)
    if model is None:
        model = LockModel(index)
        _MODELS[index] = model
    return model


# -- rendering ---------------------------------------------------------------


def fn_label(index: ProjectIndex, qual: str) -> str:
    """Human hop label: ``Repository.flush()`` / ``helper()`` /
    ``module:pkg.mod`` for module-level code."""
    fi = index.functions.get(qual)
    if fi is None:
        return f"module:{qual}"
    name = fi.node.name
    if fi.cls:
        return f"{fi.cls.rsplit('.', 1)[-1]}.{name}()"
    return f"{name}()"


def _hop_text(index: ProjectIndex, edge: LockEdge) -> str:
    return " -> ".join(f"`{fn_label(index, q)}`" for q in edge.chain)


# -- VL401 rule --------------------------------------------------------------


class LockOrderRule:
    """VL401 — cycle in the static lock-acquisition-order graph."""

    code = "VL401"
    name = "lock-order-cycle"
    severity = "error"
    description = ("two lock classes are acquired in both orders on "
                   "some pair of static paths — a potential deadlock "
                   "no test has to interleave for")

    def check_project(self, index: ProjectIndex) -> Iterator[Finding]:
        model = model_for(index)
        adj: dict[str, list] = {}
        for a, b in model.edges:
            if a != b:
                adj.setdefault(a, []).append(b)
        for a in adj:
            adj[a].sort()
        reported: set[frozenset] = set()
        for a, b in sorted(model.edges):
            if a == b:
                continue  # same-name nesting: hazardous only across
                # instances; kept in the graph, judged by the runtime
                # detector which can tell instances apart
            path = self._bfs_path(adj, b, a)
            if path is None:
                continue
            nodes = frozenset(path)
            if nodes in reported:
                continue
            reported.add(nodes)
            cycle = [a] + path  # a -> b -> ... -> a
            hops = []
            for s, d in zip(cycle, cycle[1:]):
                e = model.edges[(s, d)]
                hops.append(f"'{s}'->'{d}' via {_hop_text(index, e)} "
                            f"({e.relpath}:{e.lineno})")
            head = model.edges[(a, b)]
            yield finding_at(
                head.relpath, head.node, self.code,
                f"lock-order cycle {' -> '.join(repr(n) for n in cycle)}: "
                + "; ".join(hops)
                + " — pick one global acquisition order",
                severity=self.severity)

    @staticmethod
    def _bfs_path(adj: dict, start: str, goal: str) -> Optional[list]:
        """Shortest path start..goal over ``adj`` (inclusive), or
        None.  Deterministic: neighbours are pre-sorted."""
        if start == goal:
            return [start]
        prev: dict[str, str] = {}
        queue = deque([start])
        seen = {start}
        while queue:
            cur = queue.popleft()
            for nxt in adj.get(cur, ()):  # sorted
                if nxt in seen:
                    continue
                seen.add(nxt)
                prev[nxt] = cur
                if nxt == goal:
                    out = [goal]
                    while out[-1] != start:
                        out.append(prev[out[-1]])
                    return out[::-1]
                queue.append(nxt)
        return None


# -- cache fact kind ---------------------------------------------------------


def summaries_for(index: ProjectIndex) -> dict[str, dict]:
    """Per-file lock facts — the cached "locks" fact kind.  A file's
    summary changes iff its acquisition sites or the edges rooted in
    it change, so the cache layer can replay clean files verbatim."""
    model = model_for(index)
    out: dict[str, dict] = {}

    def slot(relpath: str) -> dict:
        return out.setdefault(relpath, {"acquires": {}, "edges": []})

    for qual in sorted(model.direct):
        fi = index.functions.get(qual)
        mod = index.modules.get(qual) if fi is None else None
        relpath = fi.relpath if fi else (mod.relpath if mod else None)
        if relpath is None:
            continue
        slot(relpath)["acquires"][qual] = sorted(
            [lk, lineno] for lk, (_, lineno) in model.direct[qual].items())
    for (a, b) in sorted(model.edges):
        e = model.edges[(a, b)]
        slot(e.relpath)["edges"].append([a, b, e.lineno, list(e.chain)])
    return out


# -- graph export ------------------------------------------------------------


def graph_json(index: ProjectIndex) -> dict:
    """The static acquisition graph as plain JSON for the debug
    toolbox: nodes are lock names, edges carry hop chains."""
    model = model_for(index)
    nodes = sorted({n for e in model.edges for n in e})
    edges = [{"from": a, "to": b,
              "site": f"{e.relpath}:{e.lineno}",
              "via": [fn_label(index, q) for q in e.chain]}
             for (a, b), e in sorted(model.edges.items())]
    return {"nodes": nodes, "edges": edges}


def dump_for_paths(paths) -> dict:
    """Build the acquisition graph for a path set from scratch —
    the ``volsync lint --dump-lock-graph`` entry point."""
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
    return graph_json(build_index(contexts))


def static_edges(index: ProjectIndex) -> set:
    """The raw ``(src, dst)`` edge name set (wildcards included)."""
    return set(model_for(index).edges)


def name_matches(static_name: str, runtime_name: str) -> bool:
    """Does a static lock name (possibly a ``prefix*`` wildcard from
    an f-string construction site) cover a runtime-observed name?"""
    if static_name.endswith("*"):
        return runtime_name.startswith(static_name[:-1])
    return static_name == runtime_name


def edge_covered(edges: set, runtime_edge: tuple) -> bool:
    """Is a runtime-observed ``(src, dst)`` acquisition edge covered
    by some static edge, matching wildcard names by prefix?"""
    ra, rb = runtime_edge
    return any(name_matches(a, ra) and name_matches(b, rb)
               for a, b in edges)
