"""Interprocedural lint rules over the project call graph.

Ports ``volsync_tpu/analysis/iprules.py``, pointed at the PyTorch port.

These rules see what the per-file rules (analysis/rules.py) structurally
cannot: a blocking call two call-hops below a ``with lock:`` region, a
thread started in ``start()`` and joined (or not) in ``stop()``, tracer
taint flowing through a helper into a Python branch. Each consumes the
``ProjectIndex`` from analysis/callgraph.py and the fixpoints from
analysis/dataflow.py.

VL101  blocking-call-under-lock: any path from a lockcheck-built lock
       region in repo/engine/objstore to store I/O, socket/HTTP, or
       time.sleep. Messages carry the lockcheck lock NAME so a static
       finding correlates with a runtime LockOrderError on the same
       name. Suppressible on the sink line or on the region's ``with``
       header (one reviewed justification covers the region).
VL102  thread/future lifecycle: threads started without a name,
       non-daemon threads with no reachable join, executors with no
       reachable shutdown (with-statement and ownership-transfer-by-
       argument are fine).
VL103  exception-path resource leak: .acquire()/open() outside a with
       or try-finally in the data-plane modules.
VL104  interprocedural tracer-taint: a traced value inside a compiled
       ops/ kernel passed to a helper whose parameter reaches a
       concretizing sink (Python branch, int()/float()/bool()),
       or a Python branch on a tainted local derived from traced args.
       VL004 remains the per-function fallback for unresolved calls;
       both share its notion of a compiled function and of its traced
       parameters (``rules.TracerSafetyRule``).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from volsync_tpu_torch.analysis.callgraph import (
    ModuleInfo,
    ProjectIndex,
    attr_chain,
)
from volsync_tpu_torch.analysis.dataflow import (
    ParamSink,
    map_call_args,
    param_sink_fixpoint,
    reverse_reach,
)
from volsync_tpu_torch.analysis.engine import Finding
from volsync_tpu_torch.analysis.rules import TracerSafetyRule, _const_str

_LOCK_CTORS = {"make_lock", "make_rlock"}


def _in_scope(mod: ModuleInfo, parts: tuple[str, ...]) -> bool:
    return any(p in mod.ctx.scope_dirs() for p in parts)


def _dotted_for(mod: ModuleInfo, chain: list[str]) -> Optional[str]:
    """Expand the leading alias of an attribute chain, e.g. with
    ``import time as t``, ["t", "sleep"] -> "time.sleep"."""
    if chain and chain[0] in mod.aliases:
        return ".".join([mod.aliases[chain[0]]] + chain[1:])
    return None


class _ScopeMaps:
    """Parent / enclosing-function / enclosing-class maps for one
    module — shared plumbing for VL101/VL102/VL103."""

    def __init__(self, mod: ModuleInfo):
        self.parent: dict[int, ast.AST] = {}
        self.encl_fn: dict[int, Optional[ast.AST]] = {}
        self.encl_cls: dict[int, Optional[str]] = {}

        def walk(node: ast.AST, fn: Optional[ast.AST],
                 cq: Optional[str], prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                self.parent[id(child)] = node
                self.encl_fn[id(child)] = fn
                self.encl_cls[id(child)] = cq
                nfn, ncq, nprefix = fn, cq, prefix
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    nfn = child
                    nprefix = f"{prefix}.{child.name}"
                elif isinstance(child, ast.ClassDef):
                    ncq = f"{prefix}.{child.name}"
                    nprefix = ncq
                walk(child, nfn, ncq, nprefix)

        walk(mod.ctx.tree, None, None, mod.name)

    def stmt_of(self, node: ast.AST) -> Optional[ast.stmt]:
        while node is not None and not isinstance(node, ast.stmt):
            node = self.parent.get(id(node))
        return node

    def block_of(self, stmt: ast.stmt) -> Optional[list[ast.stmt]]:
        p = self.parent.get(id(stmt))
        if p is None:
            return None
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(p, attr, None)
            if isinstance(sub, list) and stmt in sub:
                return sub
        return None

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parent.get(id(node))
        while cur is not None:
            yield cur
            cur = self.parent.get(id(cur))


def _walk_skip_defs(root: ast.AST) -> Iterator[ast.AST]:
    """Walk ``root``'s body without descending into nested def/class/
    lambda bodies (they execute later, on their own call sites)."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _lock_bindings(
        mod: ModuleInfo) -> tuple[dict[str, str], dict[str, dict[str, str]]]:
    """(module_locks {var: lockname}, class_locks {class_qual: {attr:
    lockname}}) for locks built via lockcheck.make_lock/make_rlock."""
    module_locks: dict[str, str] = {}
    class_locks: dict[str, dict[str, str]] = {}

    def lock_name(call: ast.Call) -> Optional[str]:
        chain = attr_chain(call.func)
        if not chain or chain[-1] not in _LOCK_CTORS:
            return None
        name = _const_str(call.args[0]) if call.args else None
        return name or "<unnamed>"

    def walk(body: list[ast.stmt], cls_qual: Optional[str],
             prefix: str) -> None:
        for node in body:
            if isinstance(node, ast.ClassDef):
                walk(node.body, f"{prefix}.{node.name}",
                     f"{prefix}.{node.name}")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk(node.body, cls_qual, f"{prefix}.{node.name}")
            else:
                for sub in ast.walk(node):
                    if not (isinstance(sub, ast.Assign)
                            and isinstance(sub.value, ast.Call)):
                        continue
                    name = lock_name(sub.value)
                    if name is None:
                        continue
                    for t in sub.targets:
                        if isinstance(t, ast.Name):
                            module_locks[t.id] = name
                        elif (isinstance(t, ast.Attribute)
                              and isinstance(t.value, ast.Name)
                              and t.value.id == "self" and cls_qual):
                            class_locks.setdefault(
                                cls_qual, {})[t.attr] = name
                walk([s for s in ast.iter_child_nodes(node)
                      if isinstance(s, ast.stmt)], cls_qual, prefix)

    walk(mod.ctx.tree.body, None, mod.name)
    return module_locks, class_locks


class LockRegionRule:
    """VL101 — no blocking I/O while holding a lockcheck-built lock."""

    code = "VL101"
    name = "blocking-call-under-lock"
    severity = "error"
    description = ("store I/O, socket/HTTP, or time.sleep reachable "
                   "(directly or through calls) inside a lock region in "
                   "repo/engine/objstore")

    SCOPE_PARTS = ("repo", "engine", "objstore")
    STORE_METHODS = {"put", "put_if_absent", "get", "get_range",
                     "put_file", "get_file", "list", "delete", "exists",
                     "size"}
    NET_ATTRS = {"urlopen", "getresponse", "create_connection", "request",
                 "connect", "sendall", "recv", "accept"}

    # -- direct sink classification ----------------------------------------

    def _direct_sink(self, call: ast.Call,
                     mod: ModuleInfo) -> Optional[str]:
        chain = attr_chain(call.func)
        if not chain:
            return None
        if _dotted_for(mod, chain) == "time.sleep":
            return "time.sleep()"
        attr = chain[-1]
        if len(chain) >= 2:
            recv = chain[-2]
            if attr in self.STORE_METHODS and recv.lower().endswith("store"):
                return f"{recv}.{attr}() object-store I/O"
            if attr in self.NET_ATTRS:
                return f".{attr}() network I/O"
        elif chain[0] == "urlopen":
            return "urlopen() network I/O"
        return None

    def _blocking_seeds(self, index: ProjectIndex) -> dict[str, str]:
        seeds: dict[str, str] = {}
        for qual in sorted(index.functions):
            fi = index.functions[qual]
            mod = index.modules.get(fi.module)
            if mod is None:
                continue
            for node in _walk_skip_defs(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                desc = self._direct_sink(node, mod)
                if desc is not None:
                    seeds[qual] = f"{desc} at {fi.relpath}:{node.lineno}"
                    break
        return seeds

    # -- region discovery ---------------------------------------------------

    def _region_lock_name(self, expr: ast.AST, mod: ModuleInfo,
                          cls_qual: Optional[str], index: ProjectIndex,
                          module_locks: dict[str, str],
                          class_locks: dict[str, dict[str, str]],
                          ) -> Optional[str]:
        if isinstance(expr, ast.Name):
            return module_locks.get(expr.id)
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and cls_qual):
            seen: set[str] = set()
            q: Optional[str] = cls_qual
            while q and q not in seen:
                seen.add(q)
                name = class_locks.get(q, {}).get(expr.attr)
                if name:
                    return name
                ci = index.classes.get(q)
                q = ci.bases[0] if ci and ci.bases else None
        return None

    def check_project(self, index: ProjectIndex) -> Iterator[Finding]:
        bindings = {relpath: _lock_bindings(mod)
                    for relpath, mod in index.by_relpath.items()}
        seeds = self._blocking_seeds(index)
        reach = reverse_reach(index, seeds)
        for relpath in sorted(index.by_relpath):
            mod = index.by_relpath[relpath]
            if not _in_scope(mod, self.SCOPE_PARTS):
                continue
            yield from self._check_module(index, mod, bindings[relpath],
                                          reach)

    def _check_module(self, index: ProjectIndex, mod: ModuleInfo,
                      bindings, reach) -> Iterator[Finding]:
        module_locks, class_locks = bindings
        maps = _ScopeMaps(mod)

        regions: list[tuple[int, str, list[ast.stmt]]] = []
        for node in ast.walk(mod.ctx.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                cq = maps.encl_cls.get(id(node))
                for item in node.items:
                    lock = self._region_lock_name(
                        item.context_expr, mod, cq, index, module_locks,
                        class_locks)
                    if lock:
                        regions.append((node.lineno, lock, node.body))
            elif isinstance(node, ast.Expr):
                # bare ``X.acquire()`` statement: region runs to the
                # matching ``X.release()`` in the same block
                call = node.value
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and call.func.attr == "acquire"):
                    continue
                base = attr_chain(call.func.value)
                if base is None:
                    continue
                lock = None
                if len(base) == 1:
                    lock = module_locks.get(base[0])
                elif base[0] == "self" and len(base) == 2:
                    cq = maps.encl_cls.get(id(node))
                    if cq:
                        lock = class_locks.get(cq, {}).get(base[1])
                if not lock:
                    continue
                block = maps.block_of(node)
                if block is None:
                    continue
                tail: list[ast.stmt] = []
                for stmt in block[block.index(node) + 1:]:
                    # the statement CONTAINING the release (usually a
                    # try/finally) still runs under the lock up to that
                    # point — it belongs to the region
                    tail.append(stmt)
                    if any(isinstance(s, ast.Call)
                           and isinstance(s.func, ast.Attribute)
                           and s.func.attr == "release"
                           and attr_chain(s.func.value) == base
                           for s in ast.walk(stmt)):
                        break
                regions.append((node.lineno, lock, tail))

        for header_line, lock, body in regions:
            if _suppressed_on(mod, header_line, self.code):
                continue
            seen: set[tuple] = set()
            for stmt in body:
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    desc = self._direct_sink(node, mod)
                    if desc is not None:
                        key = (node.lineno, "direct", desc)
                        if key in seen:
                            continue
                        seen.add(key)
                        yield Finding(
                            mod.relpath, node.lineno, self.code,
                            f"{desc} while holding lock '{lock}' "
                            f"(region at line {header_line}) — move the "
                            f"blocking call out of the lock scope",
                            severity=self.severity)
                        continue
                    site = index.site_by_node.get(id(node))
                    if site is None or site.callee is None:
                        continue
                    r = reach.get(site.callee)
                    if r is None:
                        continue
                    key = (node.lineno, "chain", site.callee)
                    if key in seen:
                        continue
                    seen.add(key)
                    hops = " -> ".join(
                        q.rsplit(".", 1)[-1] + "()" for q in r.path)
                    yield Finding(
                        mod.relpath, node.lineno, self.code,
                        f"call reaches blocking {r.desc} while holding "
                        f"lock '{lock}' (region at line {header_line}; "
                        f"via {hops})",
                        severity=self.severity)


def _suppressed_on(mod: ModuleInfo, lineno: int, code: str) -> bool:
    """Region suppression: on the ``with``-header line itself, or on a
    comment-only line directly above it (lock headers are often too
    crowded for an inline comment)."""
    from volsync_tpu_torch.analysis.engine import _SUPPRESS_RE

    candidates = [mod.ctx.line_text(lineno)]
    above = mod.ctx.line_text(lineno - 1).strip()
    if above.startswith("#"):
        candidates.append(above)
    for text in candidates:
        m = _SUPPRESS_RE.search(text)
        if m:
            codes = m.group(1)
            if codes is None or code in {c.strip()
                                         for c in codes.split(",")}:
                return True
    return False


class ThreadLifecycleRule:
    """VL102 — threads are named, non-daemon threads are joined,
    executors are shut down (or ownership is clearly transferred)."""

    code = "VL102"
    name = "thread-lifecycle"
    severity = "warning"
    description = ("Thread() without name=, non-daemon thread without a "
                   "reachable join, executor without a reachable "
                   "shutdown")

    _EXECUTORS = ("concurrent.futures.ThreadPoolExecutor",
                  "concurrent.futures.ProcessPoolExecutor",
                  "concurrent.futures.thread.ThreadPoolExecutor",
                  "concurrent.futures.process.ProcessPoolExecutor")

    def check_project(self, index: ProjectIndex) -> Iterator[Finding]:
        for relpath in sorted(index.by_relpath):
            mod = index.by_relpath[relpath]
            yield from self._check_module(index, mod)

    @staticmethod
    def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
        for kw in call.keywords:
            if kw.arg == name:
                return kw.value
        return None

    def _binding_of(self, call: ast.Call, maps: _ScopeMaps):
        """('local'|'attr'|'none', name) — where the object lands."""
        p = maps.parent.get(id(call))
        if isinstance(p, ast.Assign) and len(p.targets) == 1:
            t = p.targets[0]
            if isinstance(t, ast.Name):
                return "local", t.id
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                return "attr", t.attr
        return "none", ""

    @staticmethod
    def _search_scope(kind: str, name: str, call: ast.Call,
                      maps: _ScopeMaps, mod: ModuleInfo,
                      index: ProjectIndex) -> Optional[ast.AST]:
        """The AST region in which a join/shutdown on the binding would
        count as reachable: the enclosing function for locals (module
        when declared global), the class body for self attributes, the
        whole module otherwise."""
        if kind == "local":
            fn = maps.encl_fn.get(id(call))
            if fn is None:
                return mod.ctx.tree
            for node in ast.walk(fn):
                if isinstance(node, ast.Global) and name in node.names:
                    return mod.ctx.tree
            return fn
        if kind == "attr":
            cq = maps.encl_cls.get(id(call))
            ci = index.classes.get(cq) if cq else None
            return ci.node if ci else mod.ctx.tree
        return None

    @staticmethod
    def _calls_method(scope: ast.AST, kind: str, name: str,
                      method: str) -> bool:
        for node in ast.walk(scope):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == method):
                continue
            v = node.func.value
            if kind == "local" and isinstance(v, ast.Name) and v.id == name:
                return True
            if (kind == "attr" and isinstance(v, ast.Attribute)
                    and v.attr == name and isinstance(v.value, ast.Name)
                    and v.value.id == "self"):
                return True
        return False

    @staticmethod
    def _used_in_with(scope: ast.AST, kind: str, name: str) -> bool:
        for node in ast.walk(scope):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                e = item.context_expr
                if (kind == "local" and isinstance(e, ast.Name)
                        and e.id == name):
                    return True
                if (kind == "attr" and isinstance(e, ast.Attribute)
                        and e.attr == name):
                    return True
        return False

    def _check_module(self, index: ProjectIndex,
                      mod: ModuleInfo) -> Iterator[Finding]:
        maps = _ScopeMaps(mod)
        for node in ast.walk(mod.ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if not chain:
                continue
            dotted = _dotted_for(mod, chain) or ""
            if dotted == "threading.Thread":
                yield from self._check_thread(node, mod, maps, index)
            elif dotted in self._EXECUTORS:
                yield from self._check_executor(node, mod, maps, index)

    def _check_thread(self, call: ast.Call, mod: ModuleInfo,
                      maps: _ScopeMaps,
                      index: ProjectIndex) -> Iterator[Finding]:
        if self._kw(call, "name") is None:
            yield Finding(
                mod.relpath, call.lineno, self.code,
                "Thread() without name= — anonymous threads make "
                "stack dumps and the lock-order detector unreadable",
                severity=self.severity)
        daemon = self._kw(call, "daemon")
        if (isinstance(daemon, ast.Constant) and daemon.value is True):
            return  # daemon threads may outlive scope by design
        kind, name = self._binding_of(call, maps)
        scope = self._search_scope(kind, name, call, maps, mod, index)
        if scope is not None and self._calls_method(scope, kind, name,
                                                    "join"):
            return
        yield Finding(
            mod.relpath, call.lineno, self.code,
            "non-daemon thread with no reachable .join() — leaks at "
            "shutdown; join it, make it a daemon, or suppress with a "
            "reason", severity=self.severity)

    def _check_executor(self, call: ast.Call, mod: ModuleInfo,
                        maps: _ScopeMaps,
                        index: ProjectIndex) -> Iterator[Finding]:
        p = maps.parent.get(id(call))
        if isinstance(p, ast.withitem):
            return  # with ThreadPoolExecutor(...) as pool
        if isinstance(p, ast.Call) and call in p.args:
            return  # ownership transferred (e.g. grpc.server(pool))
        kind, name = self._binding_of(call, maps)
        scope = self._search_scope(kind, name, call, maps, mod, index)
        if scope is not None:
            if self._calls_method(scope, kind, name, "shutdown"):
                return
            if self._used_in_with(scope, kind, name):
                return
        yield Finding(
            mod.relpath, call.lineno, self.code,
            "executor with no reachable .shutdown() — worker threads "
            "leak; use a with-statement or shut it down explicitly",
            severity=self.severity)


class ResourceLeakRule:
    """VL103 — acquire/open outside with/try-finally leaks the resource
    on any exception raised before the release/close."""

    code = "VL103"
    name = "exception-path-leak"
    severity = "warning"
    description = (".acquire() or open() outside a with-statement or "
                   "try-finally in the data-plane modules")

    SCOPE_PARTS = ("repo", "objstore", "engine", "obs", "io", "ops")

    def check_project(self, index: ProjectIndex) -> Iterator[Finding]:
        for relpath in sorted(index.by_relpath):
            mod = index.by_relpath[relpath]
            if not _in_scope(mod, self.SCOPE_PARTS):
                continue
            yield from self._check_module(mod)

    @staticmethod
    def _releases(node: ast.AST, base: list[str], method: str) -> bool:
        for sub in ast.walk(node):
            if (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == method
                    and attr_chain(sub.func.value) == base):
                return True
        return False

    def _protected(self, stmt: ast.stmt, maps: _ScopeMaps,
                   base: list[str], method: str) -> bool:
        """True when a release/close for ``base`` is structurally tied
        to the acquire: in the finally (or a re-raising except) of an
        ancestor try, or of the try that immediately follows."""
        def try_covers(t: ast.Try) -> bool:
            if any(self._releases(s, base, method) for s in t.finalbody):
                return True
            for h in t.handlers:
                body = ast.Module(body=h.body, type_ignores=[])
                if (any(self._releases(s, base, method) for s in h.body)
                        and any(isinstance(x, ast.Raise)
                                for x in ast.walk(body))):
                    return True
            return False

        for anc in maps.ancestors(stmt):
            if isinstance(anc, ast.Try) and try_covers(anc):
                return True
        block = maps.block_of(stmt)
        if block is not None:
            i = block.index(stmt)
            if i + 1 < len(block) and isinstance(block[i + 1], ast.Try):
                if try_covers(block[i + 1]):
                    return True
        return False

    def _check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        maps = _ScopeMaps(mod)
        for node in ast.walk(mod.ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            p = maps.parent.get(id(node))
            # .acquire() as a bare statement or assigned result
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "acquire"
                    and isinstance(p, (ast.Expr, ast.Assign))):
                base = attr_chain(node.func.value)
                stmt = maps.stmt_of(node)
                if base is None or stmt is None:
                    continue
                if not self._protected(stmt, maps, base, "release"):
                    yield Finding(
                        mod.relpath, node.lineno, self.code,
                        f"{'.'.join(base)}.acquire() outside "
                        f"with/try-finally — an exception before the "
                        f"release leaks the lock/slot",
                        severity=self.severity)
            # open() assigned to a name
            elif (isinstance(node.func, ast.Name)
                  and node.func.id == "open"
                  and isinstance(p, ast.Assign) and len(p.targets) == 1
                  and isinstance(p.targets[0], ast.Name)):
                base = [p.targets[0].id]
                stmt = maps.stmt_of(node)
                if stmt is None:
                    continue
                if not self._protected(stmt, maps, base, "close"):
                    yield Finding(
                        mod.relpath, node.lineno, self.code,
                        f"open() bound to {base[0]!r} outside "
                        f"with/try-finally — the handle leaks on an "
                        f"exception path",
                        severity=self.severity)


class TracerTaintRule:
    """VL104 — tracer taint followed through resolved helper calls."""

    code = "VL104"
    name = "interprocedural-tracer-taint"
    severity = "error"
    description = ("traced value from a compiled ops/ kernel flows "
                   "through "
                   "helper calls into Python control flow or an "
                   "int()/float()/bool() sink")

    SCOPE_PARTS = ("ops",)

    # -- taint-use policy ---------------------------------------------------

    @classmethod
    def _uses(cls, node: ast.AST, names: set) -> set:
        """Which of ``names`` are used as VALUES in ``node``. Exempt:
        .shape/.dtype/.ndim/.device metadata, ``is (not) None`` checks,
        and len() (static on tensors — it is shape[0])."""
        if (isinstance(node, ast.Attribute)
                and node.attr in ("shape", "dtype", "ndim", "device")):
            return set()
        if (isinstance(node, ast.Compare)
                and all(isinstance(op, (ast.Is, ast.IsNot))
                        for op in node.ops)):
            return set()
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "len"):
            return set()
        if isinstance(node, ast.Name):
            return {node.id} & names
        out: set = set()
        for child in ast.iter_child_nodes(node):
            out |= cls._uses(child, names)
        return out

    # -- per-function direct sinks -----------------------------------------

    def _direct_param_sinks(self, fi) -> dict[str, ParamSink]:
        params = {p for p in fi.params + fi.kwonly
                  if p not in ("self", "cls")}
        if not params:
            return {}
        out: dict[str, ParamSink] = {}

        def add(names: set, desc: str, lineno: int) -> None:
            for pname in sorted(names):
                out.setdefault(pname, ParamSink(
                    desc, fi.relpath, lineno, (fi.qualname,)))

        for node in _walk_skip_defs(fi.node):
            if isinstance(node, (ast.If, ast.While)):
                add(self._uses(node.test, params),
                    f"branches on it ({fi.relpath}:{node.lineno})",
                    node.lineno)
            elif isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Name)
                        and f.id in ("float", "int", "bool")
                        and len(node.args) == 1):
                    add(self._uses(node.args[0], params),
                        f"concretizes it with {f.id}() "
                        f"({fi.relpath}:{node.lineno})", node.lineno)
                elif (isinstance(f, ast.Attribute)
                      and f.attr in ("item", "tolist")):
                    add(self._uses(f.value, params),
                        f"host-transfers it with .{f.attr}() "
                        f"({fi.relpath}:{node.lineno})", node.lineno)
        return out

    # -- driver -------------------------------------------------------------

    def check_project(self, index: ProjectIndex) -> Iterator[Finding]:
        traced_by_mod: dict[str, dict[int, set]] = {}
        jit_statics: dict[str, Optional[set]] = {}
        for qual, fi in index.functions.items():
            mod = index.modules.get(fi.module)
            if mod is None or not isinstance(fi.node, ast.FunctionDef):
                jit_statics[qual] = None
                continue
            if mod.name not in traced_by_mod:
                traced_by_mod[mod.name] = \
                    TracerSafetyRule.traced_functions(mod.ctx.tree)
            jit_statics[qual] = traced_by_mod[mod.name].get(id(fi.node))

        direct: dict[str, dict[str, ParamSink]] = {}
        for qual in sorted(index.functions):
            if jit_statics.get(qual) is not None:
                continue  # compiled bodies are VL004's jurisdiction
            d = self._direct_param_sinks(index.functions[qual])
            if d:
                direct[qual] = d

        sinks = param_sink_fixpoint(
            index, direct, self._uses,
            skip=lambda q: jit_statics.get(q) is not None)

        for qual in sorted(index.functions):
            statics = jit_statics.get(qual)
            if statics is None:
                continue
            fi = index.functions[qual]
            mod = index.modules.get(fi.module)
            if mod is None or not _in_scope(mod, self.SCOPE_PARTS):
                continue
            yield from self._check_jit_fn(index, mod, fi, statics, sinks,
                                          jit_statics)

    def _check_jit_fn(self, index: ProjectIndex, mod: ModuleInfo, fi,
                      statics: set, sinks, jit_statics
                      ) -> Iterator[Finding]:
        traced = {p for p in fi.params + fi.kwonly
                  if p not in statics and p not in ("self", "cls")}
        if not traced:
            return

        # forward pass: locals derived from traced values are tainted
        tainted = set(traced)

        def scan_stmts(body: list[ast.stmt]) -> None:
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                if isinstance(stmt, ast.Assign):
                    if self._uses(stmt.value, tainted):
                        for t in stmt.targets:
                            if isinstance(t, ast.Name):
                                tainted.add(t.id)
                            elif isinstance(t, ast.Tuple):
                                tainted.update(
                                    e.id for e in t.elts
                                    if isinstance(e, ast.Name))
                elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                    if (stmt.value is not None
                            and self._uses(stmt.value, tainted)
                            and isinstance(stmt.target, ast.Name)):
                        tainted.add(stmt.target.id)
                for attr in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, attr, None)
                    if isinstance(sub, list):
                        scan_stmts(sub)
                for handler in getattr(stmt, "handlers", []) or []:
                    scan_stmts(handler.body)

        scan_stmts(fi.node.body)
        derived = tainted - traced

        # (a) tainted arguments into helpers whose params reach a sink
        reported: set[tuple] = set()
        for site in index.calls.get(fi.qualname, ()):
            if site.callee is None:
                continue  # unresolved: VL004's in-function fallback
            if jit_statics.get(site.callee) is not None:
                continue
            callee_sinks = sinks.get(site.callee)
            if not callee_sinks:
                continue
            for pname, arg in map_call_args(site, index):
                ps = callee_sinks.get(pname)
                if ps is None or not self._uses(arg, tainted):
                    continue
                key = (site.lineno, site.callee)
                if key in reported:
                    continue
                reported.add(key)
                short = site.callee.rsplit(".", 1)[-1]
                via = ""
                if len(ps.chain) > 1:
                    via = (" via " + " -> ".join(
                        q.rsplit(".", 1)[-1] + "()" for q in ps.chain))
                yield Finding(
                    mod.relpath, site.lineno, self.code,
                    f"traced value passed to {short}(... {pname}=) "
                    f"inside compiled {fi.node.name}() — it {ps.desc}"
                    f"{via}; hoist the host logic out of the kernel or "
                    f"mark the argument static",
                    severity=self.severity)
                break

        # (b) Python control flow / concretization on DERIVED taint
        # (direct traced-param uses are VL004's findings — no dupes)
        if not derived:
            return
        for node in _walk_skip_defs(fi.node):
            if isinstance(node, (ast.If, ast.While)):
                used = self._uses(node.test, derived)
                if used and not self._uses(node.test, traced):
                    yield Finding(
                        mod.relpath, node.lineno, self.code,
                        f"Python branch on tracer-derived value(s) "
                        f"{sorted(used)} inside compiled {fi.node.name}() "
                        f"— use torch.where/torch.cond",
                        severity=self.severity)
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Name)
                  and node.func.id in ("float", "int", "bool")
                  and len(node.args) == 1):
                used = self._uses(node.args[0], derived)
                if used and not self._uses(node.args[0], traced):
                    yield Finding(
                        mod.relpath, node.lineno, self.code,
                        f"{node.func.id}() on tracer-derived value(s) "
                        f"{sorted(used)} inside compiled {fi.node.name}() "
                        f"— forces a host sync or fails at trace time",
                        severity=self.severity)


def default_project_rules() -> list:
    from volsync_tpu_torch.analysis.guards import (
        CheckThenActRule,
        GuardedFieldRule,
        UnsyncPublicationRule,
    )
    from volsync_tpu_torch.analysis.bufflow import default_buf_rules
    from volsync_tpu_torch.analysis.faultflow import default_fx_rules
    from volsync_tpu_torch.analysis.lockflow import LockOrderRule

    return [LockRegionRule(), ThreadLifecycleRule(), ResourceLeakRule(),
            TracerTaintRule(), LockOrderRule(), GuardedFieldRule(),
            CheckThenActRule(), UnsyncPublicationRule(),
            *default_buf_rules(), *default_fx_rules()]
