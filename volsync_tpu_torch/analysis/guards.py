"""Guarded-field race inference (VL402/VL403/VL404).

Ports ``volsync_tpu/analysis/guards.py``, pointed at the PyTorch port.

RacerD-style ownership analysis over the lock model built by
``analysis/lockflow.py``:

* **VL402 guarded-field-race** — for each ``self._field`` of a class
  that creates lockcheck locks, infer the owning lock from the
  majority of guarded accesses (guarded on ≥ 2 accesses and on more
  than half of them), then flag accesses that skip the guard while
  being reachable from a thread entry point (``threading.Thread``
  targets, ``executor.submit`` callables, gRPC ``*Servicer`` methods).
  ``__init__`` is exempt: the object is not published yet.  A
  ``lockcheck.assert_held(self._lock, ...)`` statement in a function
  body counts as holding that lock from that line on — the checked
  way to write a caller-holds-the-lock helper (runtime-enforced under
  VOLSYNC_TPU_LOCKCHECK, statically trusted here, unlike a comment).

* **VL403 check-then-act** — a field read under a lock into a local,
  the lock released, and a *dependent* write (the stale local feeds
  the written value or a branch guarding it) re-acquiring the same
  lock later in the same function: the classic lost-update / TOCTOU
  window.

* **VL404 unsynchronized-publication** — a mutable container
  (dict/list/set/deque) attribute of a class whose methods run on a
  started thread or pool, accessed with no lock held *anywhere*: the
  field crosses the thread seam with no common guard at all.  (When a
  majority guard exists this is VL402's territory instead.)

All three share one pass per ProjectIndex (memoized weakly, like
shapes.py), and the per-class field/guard statistics are exported as
part of the cached "locks" fact kind.
"""

from __future__ import annotations

import ast
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Iterator, Optional

from volsync_tpu_torch.analysis.callgraph import (
    ProjectIndex,
    attr_chain,
)
from volsync_tpu_torch.analysis.engine import Finding, finding_at
from volsync_tpu_torch.analysis.iprules import _LOCK_CTORS, _dotted_for
from volsync_tpu_torch.analysis.lockflow import fn_label, model_for

# containers whose in-place mutation is NOT atomic across threads
_MUTABLE_CTORS = {"dict", "list", "set", "deque", "defaultdict",
                  "OrderedDict", "Counter"}
# internally-synchronized primitives: fields holding these are not
# shared *data*, they ARE the synchronization
_SYNC_CTORS = {"Event", "Condition", "Semaphore", "BoundedSemaphore",
               "Barrier", "Thread", "Timer", "Queue", "SimpleQueue",
               "LifoQueue", "PriorityQueue"} | _LOCK_CTORS
_MUTATOR_METHODS = {"append", "appendleft", "extend", "extendleft",
                    "insert", "pop", "popleft", "popitem", "remove",
                    "discard", "clear", "update", "setdefault", "add",
                    "sort", "reverse", "rotate"}


# -- thread entry points -----------------------------------------------------


def thread_roots(index: ProjectIndex) -> dict[str, str]:
    """{function qualname: reason} for code that runs off the creating
    thread: Thread targets, executor-submitted callables, and gRPC
    servicer methods."""
    roots: dict[str, str] = {}

    def add(qual: Optional[str], reason: str) -> None:
        if qual is not None:
            roots.setdefault(qual, reason)

    for caller in sorted(index.calls):
        for site in index.calls[caller]:
            call = site.node
            chain = attr_chain(call.func)
            if not chain:
                continue
            where = f"{site.relpath}:{site.lineno}"
            if chain[-1] == "Thread":
                target = next((kw.value for kw in call.keywords
                               if kw.arg == "target"), None)
                if target is not None:
                    q = _resolve_ref(index, target, site)
                    add(q, f"Thread target at {where}")
            elif chain[-1] == "submit" and call.args:
                q = _resolve_ref(index, call.args[0], site)
                add(q, f"executor submit at {where}")
    for cq in sorted(index.classes):
        ci = index.classes[cq]
        if any(_base_name(b).endswith("Servicer") for b in ci.base_exprs):
            for fi in ci.methods.values():
                add(fi.qualname, f"gRPC handler on {cq}")
    return roots


def _base_name(expr: ast.expr) -> str:
    chain = attr_chain(expr)
    return chain[-1] if chain else ""


def _resolve_ref(index: ProjectIndex, expr: ast.expr, site) -> Optional[str]:
    """Resolve a callable *reference* (not a call): ``self._run``, a
    local function name, or a dotted module path."""
    chain = attr_chain(expr)
    if not chain:
        return None
    mod = index.by_relpath.get(site.relpath)
    caller_fi = index.functions.get(site.caller)
    if chain[0] in ("self", "cls") and len(chain) == 2:
        cq = caller_fi.cls if caller_fi else None
        ci = index.classes.get(cq) if cq else None
        return index._method_on_class(ci, chain[1]) if ci else None
    if len(chain) == 1:
        if caller_fi and chain[0] in caller_fi.nested:
            return caller_fi.nested[chain[0]]
        return mod.functions.get(chain[0]) if mod else None
    if mod is None:
        return None
    dotted = _dotted_for(mod, chain) or ".".join(chain)
    return index.resolve_dotted(dotted)


def thread_reachable(index: ProjectIndex) -> dict[str, str]:
    """Forward call-graph closure from the thread roots (including
    calls through typed fields the lock model resolved):
    {qualname: reason it runs on a foreign thread}."""
    extra = model_for(index).extra_calls
    reach = dict(thread_roots(index))
    work = deque(sorted(reach))
    while work:
        qual = work.popleft()
        callees = {site.callee for site in index.calls.get(qual, ())}
        callees |= extra.get(qual, set())
        for callee in sorted(c for c in callees if c is not None):
            if callee not in reach:
                reach[callee] = reach[qual]
                work.append(callee)
    return reach


# -- field access collection -------------------------------------------------


@dataclass
class Access:
    cls: str  # lexical class qualname
    field: str
    method: str  # method qualname ("" when unresolved)
    relpath: str
    node: ast.Attribute
    kind: str  # "read" | "write"
    held: frozenset  # lock names held at the access


class _Analysis:
    """One shared pass: accesses, inference, findings for 402/403/404."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self.model = model_for(index)
        self.reach = thread_reachable(index)
        self.findings: list[tuple[str, Finding]] = []
        self._held: dict[str, dict[int, frozenset]] = {}
        # cls -> field -> [Access]; __init__ accesses excluded
        self.acc: dict[str, dict[str, list[Access]]] = {}
        # cls -> field -> (__init__ Assign node, container kind)
        self.containers: dict[str, dict[str, tuple]] = {}
        self._collect()
        self._infer_vl402_vl404()
        self._check_vl403()

    # -- plumbing -----------------------------------------------------------

    def held_at(self, relpath: str, node: ast.AST) -> frozenset:
        if relpath not in self._held:
            self._held[relpath] = self.model.held_map(relpath)
        return self._held[relpath].get(id(node), frozenset())

    def _family(self, cq: str) -> list[str]:
        """cq plus all (resolved) ancestors, breadth-first."""
        out, queue = [], deque([cq])
        seen: set[str] = set()
        while queue:
            q = queue.popleft()
            if q in seen:
                continue
            seen.add(q)
            out.append(q)
            ci = self.index.classes.get(q)
            if ci:
                queue.extend(ci.bases)
        return out

    def _is_method_name(self, cq: str, attr: str) -> bool:
        ci = self.index.classes.get(cq)
        return bool(ci and self.index._method_on_class(ci, attr))

    def _sync_fields(self, cq: str) -> set:
        """Fields of ``cq``'s family holding locks or synchronized
        primitives — excluded from data-race inference."""
        out: set = set()
        for q in self._family(cq):
            out |= set(self.model.class_locks.get(q, ()))
            init = self.index.classes.get(q, None)
            init_fi = init.methods.get("__init__") if init else None
            if init_fi is None:
                continue
            for sub in ast.walk(init_fi.node):
                if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    continue
                value = sub.value
                if not isinstance(value, ast.Call):
                    continue
                chain = attr_chain(value.func)
                if not chain or chain[-1] not in _SYNC_CTORS:
                    continue
                targets = (sub.targets if isinstance(sub, ast.Assign)
                           else [sub.target])
                for t in targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        out.add(t.attr)
        return out

    # -- collection ---------------------------------------------------------

    def _collect(self) -> None:
        for cq in sorted(self.index.classes):
            ci = self.index.classes[cq]
            if not any(self.model.class_locks.get(q) or
                       self.containers.get(q)
                       for q in self._family(cq)) \
                    and not self._class_has_locks_or_threads(ci):
                continue
            sync = self._sync_fields(cq)
            self._collect_containers(cq, ci)
            for mname in sorted(ci.methods):
                fi = ci.methods[mname]
                if mname in ("__init__", "__new__", "__post_init__"):
                    continue
                maps = self.model.maps.get(fi.relpath)
                if maps is None:
                    continue
                asserted = self._asserted_locks(cq, fi)
                for node in ast.walk(fi.node):
                    if not (isinstance(node, ast.Attribute)
                            and isinstance(node.value, ast.Name)
                            and node.value.id == "self"):
                        continue
                    attr = node.attr
                    if attr in sync or self._is_method_name(cq, attr):
                        continue
                    kind = self._access_kind(node, maps)
                    if kind is None:
                        continue
                    held = self.held_at(fi.relpath, node)
                    if asserted:
                        held = held | frozenset(
                            name for name, line in asserted
                            if node.lineno >= line)
                    self.acc.setdefault(cq, {}).setdefault(attr, []).append(
                        Access(cq, attr, fi.qualname, fi.relpath, node,
                               kind, held))

    def _asserted_locks(self, cq: str, fi) -> list[tuple[str, int]]:
        """``lockcheck.assert_held(self.<lockattr>, ...)`` statements
        directly in the function body: each makes its lock count as
        held from that line to the end of the function — the checked
        precondition idiom for caller-holds-the-lock helpers."""
        out: list[tuple[str, int]] = []
        for stmt in fi.node.body:
            if not (isinstance(stmt, ast.Expr)
                    and isinstance(stmt.value, ast.Call)):
                continue
            call = stmt.value
            chain = attr_chain(call.func)
            if not chain or chain[-1] != "assert_held" or not call.args:
                continue
            arg = call.args[0]
            if (isinstance(arg, ast.Attribute)
                    and isinstance(arg.value, ast.Name)
                    and arg.value.id == "self"):
                name = self.model.resolve_self_lock(cq, arg.attr)
                if name is not None:
                    out.append((name, stmt.lineno))
        return out

    def _class_has_locks_or_threads(self, ci) -> bool:
        """Classes with no lock anywhere in the family still matter to
        VL404 when they put work on a thread (gc/scrub services)."""
        return any(fi.qualname in self.reach for fi in ci.methods.values())

    def _collect_containers(self, cq: str, ci) -> None:
        init_fi = ci.methods.get("__init__")
        if init_fi is None:
            return
        for sub in ast.walk(init_fi.node):
            if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                continue
            kind = self._container_kind(sub.value)
            if kind is None:
                continue
            targets = (sub.targets if isinstance(sub, ast.Assign)
                       else [sub.target])
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    self.containers.setdefault(cq, {})[t.attr] = (sub, kind)

    @staticmethod
    def _container_kind(value: Optional[ast.AST]) -> Optional[str]:
        if isinstance(value, ast.Dict):
            return "dict"
        if isinstance(value, (ast.List, ast.ListComp)):
            return "list"
        if isinstance(value, (ast.Set, ast.SetComp)):
            return "set"
        if isinstance(value, ast.Call):
            chain = attr_chain(value.func)
            if chain and chain[-1] in _MUTABLE_CTORS:
                return chain[-1]
        return None

    def _access_kind(self, node: ast.Attribute, maps) -> Optional[str]:
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            return "write"
        parent = maps.parent.get(id(node))
        # self.f[k] = v / del self.f[k] — container mutation
        if (isinstance(parent, ast.Subscript) and parent.value is node
                and isinstance(parent.ctx, (ast.Store, ast.Del))):
            return "write"
        # self.f.append(x) etc — container mutation through a method
        if (isinstance(parent, ast.Attribute) and parent.value is node
                and parent.attr in _MUTATOR_METHODS):
            gp = maps.parent.get(id(parent))
            if isinstance(gp, ast.Call) and gp.func is parent:
                return "write"
        return "read"

    # -- VL402 + VL404 ------------------------------------------------------

    def _family_accesses(self, cq: str, field: str) -> list:
        out: list = []
        for q in self._family(cq):
            out.extend(self.acc.get(q, {}).get(field, ()))
        return out

    def _majority_lock(self, accesses: list) -> Optional[tuple]:
        """(lock, guarded, total) when one lock guards ≥ 2 accesses
        and more than half of them — the inferred owner."""
        counts: dict[str, int] = {}
        for a in accesses:
            for lk in a.held:
                counts[lk] = counts.get(lk, 0) + 1
        if not counts:
            return None
        lock = max(sorted(counts), key=lambda k: counts[k])
        guarded, total = counts[lock], len(accesses)
        if guarded >= 2 and guarded * 2 > total:
            return lock, guarded, total
        return None

    def _infer_vl402_vl404(self) -> None:
        for cq in sorted(self.acc):
            for field in sorted(self.acc[cq]):
                fam = self._family_accesses(cq, field)
                owner = self._majority_lock(fam)
                if owner is not None:
                    self._flag_vl402(cq, field, fam, owner)
        for cq in sorted(self.containers):
            for field in sorted(self.containers[cq]):
                self._flag_vl404(cq, field)

    def _flag_vl402(self, cq: str, field: str, fam: list,
                    owner: tuple) -> None:
        lock, guarded, total = owner
        cls_label = cq.rsplit(".", 1)[-1]
        for a in self.acc[cq].get(field, ()):  # own accesses only —
            # ancestor accesses get flagged under their own class
            if lock in a.held:
                continue
            reason = self.reach.get(a.method)
            if reason is None:
                continue
            self.findings.append(("VL402", finding_at(
                a.relpath, a.node, "VL402",
                f"field '{field}' of {cls_label} is guarded by "
                f"'{lock}' on {guarded}/{total} accesses but {a.kind} "
                f"here without it, on a path threads run "
                f"({reason}) — hold '{lock}' or document why this "
                f"access is safe", severity="error")))

    def _flag_vl404(self, cq: str, field: str) -> None:
        fam = self._family_accesses(cq, field)
        if len(fam) < 2 or any(a.held for a in fam):
            return  # guarded somewhere: VL402's territory
        threaded = [a for a in fam if a.method in self.reach]
        if not threaded:
            return
        node, kind = self.containers[cq][field]
        reason = self.reach[threaded[0].method]
        cls_label = cq.rsplit(".", 1)[-1]
        self.findings.append(("VL404", finding_at(
            self._relpath_of_class(cq), node, "VL404",
            f"mutable {kind} '{field}' of {cls_label} crosses a "
            f"thread seam ({reason}) with no lock on any of its "
            f"{len(fam)} accesses — all of "
            f"{sorted({fn_label(self.index, a.method) for a in fam})} "
            f"touch it unsynchronized; guard it with one lock",
            severity="warning")))

    def _relpath_of_class(self, cq: str) -> str:
        ci = self.index.classes.get(cq)
        mod = self.index.modules.get(ci.module) if ci else None
        return mod.relpath if mod else ""

    # -- VL403 --------------------------------------------------------------

    def _check_vl403(self) -> None:
        by_fn: dict[str, list] = {}
        for region in self.model.regions:
            by_fn.setdefault(region.func, []).append(region)
        for func in sorted(by_fn):
            regions = sorted(by_fn[func],
                             key=lambda r: r.header.lineno)
            if len(regions) < 2:
                continue
            live = [set(map(id, self._live_nodes(r))) for r in regions]
            for i, ri in enumerate(regions):
                taint = self._tainted_locals(ri)
                if not taint:
                    continue
                for j in range(i + 1, len(regions)):
                    rj = regions[j]
                    if rj.lock != ri.lock or id(rj.header) in live[i]:
                        continue  # different lock, or never released
                    self._flag_vl403(ri, rj, taint)

    def _live_nodes(self, region) -> Iterator[ast.AST]:
        for stmt in region.body:
            yield from self.model._iter_live(stmt)

    def _tainted_locals(self, region) -> dict[str, tuple]:
        """{local name: (field, read Attribute node)} for locals that
        snapshot a self-field inside the region."""
        taint: dict[str, tuple] = {}
        for node in self._live_nodes(region):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            for sub in ast.walk(node.value):
                if (isinstance(sub, ast.Attribute)
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id == "self"
                        and isinstance(sub.ctx, ast.Load)):
                    taint[node.targets[0].id] = (sub.attr, sub)
                    break
        return taint

    def _flag_vl403(self, ri, rj, taint: dict) -> None:
        maps = self.model.maps.get(rj.relpath)
        for node in self._live_nodes(rj):
            target = None
            if isinstance(node, ast.Assign):
                target = node.targets[0] if len(node.targets) == 1 else None
            elif isinstance(node, ast.AugAssign):
                target = node.target
            if not (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"):
                continue
            field = target.attr
            stale = [(name, n) for name, (f, n) in taint.items()
                     if f == field]
            if not stale:
                continue
            names = {name for name, _ in stale}
            if not (self._uses(node.value, names)
                    or self._branch_uses(node, maps, names)):
                continue
            name = sorted(names)[0]
            self.findings.append(("VL403", finding_at(
                rj.relpath, node, "VL403",
                f"check-then-act on field '{field}': snapshot into "
                f"'{name}' under '{ri.lock}' at line "
                f"{taint[name][1].lineno}, lock released, and this "
                f"dependent write re-acquires '{rj.lock}' — another "
                f"thread can update '{field}' in the window; widen "
                f"the critical section or re-validate under the lock",
                severity="error")))
            return  # one finding per region pair keeps the noise down

    @staticmethod
    def _uses(expr: Optional[ast.AST], names: set) -> bool:
        if expr is None:
            return False
        return any(isinstance(n, ast.Name) and n.id in names
                   and isinstance(n.ctx, ast.Load)
                   for n in ast.walk(expr))

    def _branch_uses(self, node: ast.AST, maps, names: set) -> bool:
        """Is the write guarded by an if/while whose test reads the
        stale snapshot? (the 'act' of check-then-act)"""
        if maps is None:
            return False
        for anc in maps.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
            if isinstance(anc, (ast.If, ast.While)) \
                    and self._uses(anc.test, names):
                return True
        return False


_ANALYSES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _analysis_for(index: ProjectIndex) -> _Analysis:
    a = _ANALYSES.get(index)
    if a is None:
        a = _Analysis(index)
        _ANALYSES[index] = a
    return a


def field_summaries(index: ProjectIndex) -> dict[str, dict]:
    """Per-file guarded-field statistics for the cached "locks" fact
    kind: {relpath: {"Class.field": {"guarded": {lock: n},
    "total": n}}}."""
    a = _analysis_for(index)
    out: dict[str, dict] = {}
    for cq in sorted(a.acc):
        for field in sorted(a.acc[cq]):
            accesses = a.acc[cq][field]
            counts: dict[str, int] = {}
            for acc in accesses:
                for lk in sorted(acc.held):
                    counts[lk] = counts.get(lk, 0) + 1
            key = f"{cq.rsplit('.', 1)[-1]}.{field}"
            relpath = accesses[0].relpath
            out.setdefault(relpath, {})[key] = {
                "guarded": dict(sorted(counts.items())),
                "total": len(accesses)}
    return out


class _GuardRule:
    severity = "error"

    def check_project(self, index: ProjectIndex) -> Iterator[Finding]:
        for code, finding in _analysis_for(index).findings:
            if code == self.code:
                yield finding


class GuardedFieldRule(_GuardRule):
    """VL402 — majority-guarded field accessed without its lock."""

    code = "VL402"
    name = "guarded-field-race"
    description = ("a field guarded by one lock on most accesses is "
                   "read/written without it on a thread-reachable path")


class CheckThenActRule(_GuardRule):
    """VL403 — lock released between a snapshot and a dependent write."""

    code = "VL403"
    name = "check-then-act"
    description = ("guarded read, lock released, dependent write "
                   "re-acquires the lock: lost-update / TOCTOU window")


class UnsyncPublicationRule(_GuardRule):
    """VL404 — mutable container crosses the thread seam unguarded."""

    code = "VL404"
    name = "unsynchronized-publication"
    severity = "warning"
    description = ("a dict/list/set/deque attribute is handed to a "
                   "started thread or pool with no common guard")
