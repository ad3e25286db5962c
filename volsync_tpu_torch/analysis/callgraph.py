"""Project-wide module/symbol resolver and call-graph builder.

Ports ``volsync_tpu/analysis/callgraph.py``, pointed at the PyTorch port.

This is the substrate the interprocedural rules (analysis/iprules.py)
and the lock, buffer and fault-path models stand on: it turns a set of parsed files (engine.FileContext) into a
``ProjectIndex`` — modules with their import-alias tables, every
function/method/nested-def with a stable qualname, class method tables
with (single-level) base resolution, and one ``CallSite`` per call
expression with the best-effort resolved callee qualname.

Resolution is deliberately conservative: a call we cannot attribute to
a project symbol resolves to ``None`` and simply contributes no edge.
The rules are written so that an unresolved edge can only cause a
false NEGATIVE, never a false positive — the same bargain the per-file
rules make.

What resolves:

* bare names: nested defs of the enclosing function chain, then
  module-level functions/classes, then imported symbols
  (``from x import y as z`` included, relative imports included);
* ``self.m()`` / ``cls.m()``: methods on the enclosing class, then on
  resolvable base classes (transitively, cycle-guarded);
* attribute chains through module aliases: ``import a.b as c; c.f()``
  and ``c.Klass.method`` / ``c.Klass()`` (constructor -> ``__init__``);
* local variables shadowing any of the above resolve to ``None``.

Callbacks passed as arguments (``pool.submit(fn, ...)``) are
intentionally NOT call edges: the callee runs on another thread, so
e.g. lock-region reachability must not follow it.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional

from volsync_tpu_torch.analysis.engine import FileContext


def module_name_for(path: Path) -> str:
    """Dotted module name, derived by walking up while the parent
    directory is a package (has ``__init__.py``). Works for installed
    trees and for tmp-dir test fixtures alike."""
    path = Path(path)
    parts = [] if path.stem == "__init__" else [path.stem]
    d = path.parent
    while (d / "__init__.py").exists():
        parts.insert(0, d.name)
        parent = d.parent
        if parent == d:
            break
        d = parent
    return ".".join(parts) or path.stem


@dataclass
class FunctionInfo:
    qualname: str
    module: str
    relpath: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    cls: Optional[str]  # enclosing ClassInfo qualname (lexical)
    parent: Optional[str]  # enclosing function qualname (nested defs)
    params: list[str]  # positional (posonly + args), in order
    kwonly: list[str]
    nested: dict[str, str] = field(default_factory=dict)  # name -> qualname


@dataclass
class ClassInfo:
    qualname: str
    module: str
    node: ast.ClassDef
    methods: dict[str, FunctionInfo] = field(default_factory=dict)
    base_exprs: list[ast.expr] = field(default_factory=list)
    bases: list[str] = field(default_factory=list)  # resolved qualnames


@dataclass
class CallSite:
    caller: str  # qualname of the enclosing function (or module)
    relpath: str
    lineno: int
    node: ast.Call
    callee: Optional[str]  # resolved qualname, or None


class ModuleInfo:
    def __init__(self, name: str, ctx: FileContext):
        self.name = name
        self.ctx = ctx
        self.relpath = ctx.relpath
        # local alias -> dotted target ("os", "a.b.c", "a.b.c.symbol")
        self.aliases: dict[str, str] = {}
        self.functions: dict[str, str] = {}  # top-level name -> qualname
        self.classes: dict[str, ClassInfo] = {}

    def package(self) -> str:
        if self.ctx.path.name == "__init__.py":
            return self.name
        return self.name.rsplit(".", 1)[0] if "." in self.name else ""


def attr_chain(node: ast.AST) -> Optional[list[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None for anything non-trivial."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _collect_imports(mod: ModuleInfo) -> None:
    """Record every import in the file (function-local ones too — the
    codebase imports lazily) into one module-wide alias table."""
    pkg = mod.package()
    for node in ast.walk(mod.ctx.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    mod.aliases[alias.asname] = alias.name
                else:
                    root = alias.name.split(".")[0]
                    mod.aliases.setdefault(root, root)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base_parts = pkg.split(".") if pkg else []
                if node.level - 1:
                    base_parts = base_parts[:-(node.level - 1)]
                base = ".".join(base_parts)
            else:
                base = ""
            if node.module:
                base = f"{base}.{node.module}" if base else node.module
            for alias in node.names:
                if alias.name == "*":
                    continue
                target = f"{base}.{alias.name}" if base else alias.name
                mod.aliases[alias.asname or alias.name] = target


class ProjectIndex:
    def __init__(self) -> None:
        self.modules: dict[str, ModuleInfo] = {}
        self.by_relpath: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        self.calls: dict[str, list[CallSite]] = {}  # caller -> sites
        self.callers: dict[str, list[CallSite]] = {}  # callee -> sites
        self.site_by_node: dict[int, CallSite] = {}  # id(Call) -> site

    # -- construction -------------------------------------------------------

    def _collect_defs(self, mod: ModuleInfo) -> None:
        def visit(body: list[ast.stmt], cls: Optional[ClassInfo],
                  fn: Optional[FunctionInfo], prefix: str) -> None:
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}.{node.name}"
                    a = node.args
                    fi = FunctionInfo(
                        qualname=qual, module=mod.name, relpath=mod.relpath,
                        node=node,
                        cls=cls.qualname if cls else None,
                        parent=fn.qualname if fn else None,
                        params=[p.arg for p in a.posonlyargs + a.args],
                        kwonly=[p.arg for p in a.kwonlyargs])
                    self.functions[qual] = fi
                    if fn is not None:
                        fn.nested[node.name] = qual
                    elif cls is not None:
                        cls.methods[node.name] = fi
                    else:
                        mod.functions[node.name] = qual
                    # keep ``cls`` visible inside nested defs: closures
                    # over ``self`` are everywhere in the data plane
                    visit(node.body, cls, fi, qual)
                elif isinstance(node, ast.ClassDef):
                    qual = f"{prefix}.{node.name}"
                    ci = ClassInfo(qualname=qual, module=mod.name, node=node,
                                   base_exprs=list(node.bases))
                    self.classes[qual] = ci
                    if cls is None and fn is None:
                        mod.classes[node.name] = ci
                    visit(node.body, ci, None, qual)
                else:
                    # conditional defs (if TYPE_CHECKING / try-import)
                    for attr in ("body", "orelse", "finalbody"):
                        sub = getattr(node, attr, None)
                        if isinstance(sub, list):
                            visit(sub, cls, fn, prefix)
                    for handler in getattr(node, "handlers", []) or []:
                        visit(handler.body, cls, fn, prefix)

        visit(mod.ctx.tree.body, None, None, mod.name)

    def _link_bases(self) -> None:
        for mod in self.modules.values():
            for ci in mod.classes.values():
                for b in ci.base_exprs:
                    chain = attr_chain(b)
                    if not chain:
                        continue
                    target = self._resolve_class_ref(mod, chain)
                    if target:
                        ci.bases.append(target)

    def _resolve_class_ref(self, mod: ModuleInfo,
                           chain: list[str]) -> Optional[str]:
        head = chain[0]
        if len(chain) == 1:
            if head in mod.classes:
                return mod.classes[head].qualname
            if head in mod.aliases:
                q = self.resolve_dotted(mod.aliases[head])
                if q in self.classes:
                    return q
            return None
        if head in mod.aliases:
            dotted = ".".join([mod.aliases[head]] + chain[1:])
            q = self.resolve_dotted(dotted)
            if q in self.classes:
                return q
        return None

    # -- symbol resolution --------------------------------------------------

    def resolve_dotted(self, dotted: str,
                       _seen: Optional[set] = None) -> Optional[str]:
        """Map a fully-dotted reference onto a known function/class
        qualname (longest module prefix wins). Classes resolve to their
        ``__init__`` when one is reachable, else the class qualname."""
        if _seen is None:
            _seen = set()
        if dotted in _seen:
            return None
        _seen.add(dotted)
        parts = dotted.split(".")
        for i in range(len(parts), 0, -1):
            modname = ".".join(parts[:i])
            m = self.modules.get(modname)
            if m is None:
                continue
            rest = parts[i:]
            if not rest:
                return None  # bare module reference, not callable
            if len(rest) == 1:
                name = rest[0]
                if name in m.functions:
                    return m.functions[name]
                if name in m.classes:
                    return self._class_target(m.classes[name])
                if name in m.aliases:  # re-export chain
                    return self.resolve_dotted(m.aliases[name], _seen)
                return None
            if len(rest) == 2 and rest[0] in m.classes:
                return self._method_on_class(m.classes[rest[0]], rest[1])
            return None
        return None

    def _class_target(self, ci: ClassInfo) -> str:
        init = self._method_on_class(ci, "__init__")
        return init if init else ci.qualname

    def _method_on_class(self, ci: ClassInfo, name: str,
                         _seen: Optional[set] = None) -> Optional[str]:
        if _seen is None:
            _seen = set()
        if ci.qualname in _seen:
            return None
        _seen.add(ci.qualname)
        if name in ci.methods:
            return ci.methods[name].qualname
        for base in ci.bases:
            bc = self.classes.get(base)
            if bc is not None:
                found = self._method_on_class(bc, name, _seen)
                if found:
                    return found
        return None

    def _resolve_call(self, call: ast.Call, mod: ModuleInfo,
                      cls: Optional[ClassInfo],
                      fn_chain: list[FunctionInfo],
                      local_names: set[str]) -> Optional[str]:
        chain = attr_chain(call.func)
        if chain is None:
            return None
        head = chain[0]
        if len(chain) == 1:
            for enc in reversed(fn_chain):
                if head in enc.nested:
                    return enc.nested[head]
            if head in local_names:
                return None  # shadowed by a local binding
            if head in mod.functions:
                return mod.functions[head]
            if head in mod.classes:
                return self._class_target(mod.classes[head])
            if head in mod.aliases:
                return self.resolve_dotted(mod.aliases[head])
            return None
        if head in ("self", "cls") and cls is not None:
            if len(chain) == 2:
                return self._method_on_class(cls, chain[1])
            return None
        if head in local_names:
            return None
        if head in mod.aliases:
            return self.resolve_dotted(
                ".".join([mod.aliases[head]] + chain[1:]))
        return None

    # -- call-site collection -----------------------------------------------

    @staticmethod
    def _local_bindings(fn_node: ast.AST) -> set[str]:
        """Names bound inside the function (params, assignments, loop
        and with targets) — these shadow module scope for resolution."""
        names: set[str] = set()
        a = fn_node.args
        for p in (a.posonlyargs + a.args + a.kwonlyargs):
            names.add(p.arg)
        if a.vararg:
            names.add(a.vararg.arg)
        if a.kwarg:
            names.add(a.kwarg.arg)

        def targets(t: ast.AST) -> None:
            if isinstance(t, ast.Name):
                names.add(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    targets(e)
            elif isinstance(t, ast.Starred):
                targets(t.value)

        for node in ast.walk(fn_node):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    targets(t)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets(node.target)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                targets(node.target)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if item.optional_vars is not None:
                        targets(item.optional_vars)
            elif isinstance(node, ast.ExceptHandler) and node.name:
                names.add(node.name)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                for gen in node.generators:
                    targets(gen.target)
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Global):
                # ``global X`` assignments bind module scope, not local
                for gname in node.names:
                    names.discard(gname)
        return names

    def _record(self, call: ast.Call, caller: str, mod: ModuleInfo,
                cls: Optional[ClassInfo], fn_chain: list[FunctionInfo],
                local_names: set[str]) -> None:
        callee = self._resolve_call(call, mod, cls, fn_chain, local_names)
        site = CallSite(caller=caller, relpath=mod.relpath,
                        lineno=call.lineno, node=call, callee=callee)
        self.calls.setdefault(caller, []).append(site)
        self.site_by_node[id(call)] = site
        if callee is not None:
            self.callers.setdefault(callee, []).append(site)

    def _collect_calls(self, mod: ModuleInfo) -> None:
        def visit(node: ast.AST, caller: str, prefix: str,
                  cls: Optional[ClassInfo], fn_chain: list[FunctionInfo],
                  local_names: set[str]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{node.name}"
                fi = self.functions.get(qual)
                # decorators/defaults evaluate in the ENCLOSING scope
                for dec in node.decorator_list:
                    visit(dec, caller, prefix, cls, fn_chain, local_names)
                for dflt in (node.args.defaults + node.args.kw_defaults):
                    if dflt is not None:
                        visit(dflt, caller, prefix, cls, fn_chain,
                              local_names)
                if fi is None:
                    return
                locs = self._local_bindings(node)
                for child in node.body:
                    visit(child, qual, qual, cls, fn_chain + [fi], locs)
                return
            if isinstance(node, ast.ClassDef):
                qual = f"{prefix}.{node.name}"
                ci = self.classes.get(qual)
                # class-body statements execute at import time: keep the
                # enclosing caller for them, but resolve self.* against
                # the class for the methods inside
                for child in node.body:
                    visit(child, caller, qual, ci, [], set())
                return
            if isinstance(node, ast.Call):
                self._record(node, caller, mod, cls, fn_chain, local_names)
            for child in ast.iter_child_nodes(node):
                visit(child, caller, prefix, cls, fn_chain, local_names)

        for stmt in mod.ctx.tree.body:
            visit(stmt, mod.name, mod.name, None, [], set())

    # -- cache support ------------------------------------------------------

    def file_deps(self) -> dict[str, set[str]]:
        """relpath -> set of project-internal relpaths it imports
        (direct edges; the cache takes the transitive reverse closure).
        """
        deps: dict[str, set[str]] = {}
        for mod in self.modules.values():
            out: set[str] = set()
            for dotted in mod.aliases.values():
                parts = dotted.split(".")
                for i in range(len(parts), 0, -1):
                    target = self.modules.get(".".join(parts[:i]))
                    if target is not None:
                        if target.relpath != mod.relpath:
                            out.add(target.relpath)
                        break
            deps[mod.relpath] = out
        return deps


def build_index(contexts: Iterable[FileContext]) -> ProjectIndex:
    idx = ProjectIndex()
    for ctx in contexts:
        mod = ModuleInfo(module_name_for(ctx.path), ctx)
        idx.modules[mod.name] = mod
        idx.by_relpath[ctx.relpath] = mod
    for mod in idx.modules.values():
        _collect_imports(mod)
        idx._collect_defs(mod)
    idx._link_bases()
    for mod in idx.modules.values():
        idx._collect_calls(mod)
    return idx
