"""Lint rules enforcing volsync-tpu's stated-but-unenforced invariants,
pointed at the port (ports ``volsync_tpu/analysis/rules.py``).

Each rule is a class with ``code``/``name``/``description`` and a
``check(ctx) -> Iterator[Finding]``. Codes are stable (they appear in
baselines and suppression comments):

VL001  VOLSYNC_* env reads outside envflags.py
VL002  gated third-party imports (zstandard, cryptography) outside shim
VL003  broad except that swallows silently (no log / re-raise)
VL004  tracer-unsafe host ops inside compiled functions (ops/ kernels)
VL005  direct threading.Lock/RLock in data-plane modules (bypasses
       lockcheck instrumentation)
VL105  ad-hoc retry: time.sleep inside an except handler or a retry
       loop (a for/while containing a try) outside resilience.py —
       route through resilience.RetryPolicy
VL106  hot-path byte copies: ``.tobytes()``, ``bytes(<buffer>)``, or a
       ``b"".join(...)`` in the zero-copy data plane (engine/, ops/,
       repo/) — the paths whose copies the ledger
       (obs/copyledger.py) accounts; sanctioned sites carry a
       reasoned ``# lint: ignore[VL106]`` next to their record_copy
VL301  span/trace names must be literal, dotted, lowercase strings at
       the call site (no f-strings/concatenation/variables) — span
       names become Prometheus label values, so dynamic names are
       unbounded metric cardinality
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from volsync_tpu_torch.analysis.engine import FileContext, Finding, finding_at

_BROAD_EXC = {"Exception", "BaseException"}


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class EnvFlagRule:
    """All VOLSYNC_* environment reads go through envflags.py — one
    falsy-token set, one catalogue of operator knobs."""

    code = "VL001"
    name = "env-flag-centralized"
    description = ("os.environ/os.getenv read of a VOLSYNC_* key outside "
                   "envflags.py")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if ctx.in_module("envflags.py"):
            return
        os_names: set[str] = set()
        environ_names: set[str] = set()
        getenv_names: set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "os":
                        os_names.add(alias.asname or "os")
            elif isinstance(node, ast.ImportFrom) and node.module == "os":
                for alias in node.names:
                    if alias.name == "environ":
                        environ_names.add(alias.asname or "environ")
                    elif alias.name == "getenv":
                        getenv_names.add(alias.asname or "getenv")

        def is_environ(node: ast.AST) -> bool:
            if isinstance(node, ast.Attribute) and node.attr == "environ":
                return (isinstance(node.value, ast.Name)
                        and node.value.id in os_names)
            return isinstance(node, ast.Name) and node.id in environ_names

        def volsync_key(node: ast.AST) -> Optional[str]:
            s = _const_str(node)
            if s is not None and s.startswith("VOLSYNC"):
                return s
            return None

        for node in ast.walk(ctx.tree):
            key = None
            if isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute)
                        and f.attr in ("get", "pop", "setdefault")
                        and is_environ(f.value) and node.args):
                    key = volsync_key(node.args[0])
                elif ((isinstance(f, ast.Attribute) and f.attr == "getenv"
                       and isinstance(f.value, ast.Name)
                       and f.value.id in os_names)
                      or (isinstance(f, ast.Name)
                          and f.id in getenv_names)) and node.args:
                    key = volsync_key(node.args[0])
            elif isinstance(node, ast.Subscript):
                if (isinstance(node.ctx, ast.Load)
                        and is_environ(node.value)):
                    key = volsync_key(node.slice)
            elif isinstance(node, ast.Compare):
                if (len(node.ops) == 1
                        and isinstance(node.ops[0], (ast.In, ast.NotIn))
                        and is_environ(node.comparators[0])):
                    key = volsync_key(node.left)
            if key is not None:
                yield finding_at(
                    ctx.relpath, node, self.code,
                    f"read of {key!r} outside envflags.py — add/use an "
                    f"accessor in volsync_tpu_torch/envflags.py")


class ImportGateRule:
    """Optional heavy deps import only behind their shims, so every
    other module stays importable when the dep is absent."""

    code = "VL002"
    name = "gated-imports"
    description = ("zstandard/cryptography imported outside "
                   "repo/compress.py / repo/crypto.py")

    GATES = {
        "zstandard": "repo/compress.py",
        "cryptography": "repo/crypto.py",
    }

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            roots: list[str] = []
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level == 0:  # relative imports can't be the dep
                    roots = [node.module.split(".")[0]]
            for root in roots:
                shim = self.GATES.get(root)
                if shim is None or ctx.in_module(shim):
                    continue
                yield finding_at(
                    ctx.relpath, node, self.code,
                    f"import of {root!r} outside {shim} — route through "
                    f"the shim so its absence degrades instead of "
                    f"breaking imports")


class SilentExceptRule:
    """A broad except whose body does nothing hides real failures —
    the invariant-drift class both sync-correctness papers blame."""

    code = "VL003"
    name = "silent-broad-except"
    description = ("except Exception/BaseException/bare whose body only "
                   "passes — no log, no re-raise")

    @staticmethod
    def _is_broad(type_node: Optional[ast.AST]) -> bool:
        if type_node is None:
            return True  # bare except
        if isinstance(type_node, ast.Name):
            return type_node.id in _BROAD_EXC
        if isinstance(type_node, ast.Attribute):
            return type_node.attr in _BROAD_EXC
        if isinstance(type_node, ast.Tuple):
            return any(SilentExceptRule._is_broad(e)
                       for e in type_node.elts)
        return False

    @staticmethod
    def _is_silent(body: list[ast.stmt]) -> bool:
        for stmt in body:
            if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
                continue
            if (isinstance(stmt, ast.Expr)
                    and isinstance(stmt.value, ast.Constant)):
                continue  # docstring / ellipsis
            return False
        return True

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if self._is_broad(node.type) and self._is_silent(node.body):
                yield finding_at(
                    ctx.relpath, node, self.code,
                    "broad except swallows the exception silently — "
                    "re-raise, narrow the type, or log it "
                    "(`# lint: ignore[VL003]` with a reason if "
                    "intentional)")


#: callables whose function arguments torch runs under capture or
#: compilation: dotted name -> positions of those arguments
_TRACING_CALLS = {
    "torch.compile": (0,),
    "torch.jit.script": (0,),
    "torch.cuda.make_graphed_callables": (0,),
    "torch.cond": (1, 2),
    "torch._higher_order_ops.cond": (1, 2),
    "torch._higher_order_ops.while_loop": (0, 1),
    "torch._higher_order_ops.scan": (0,),
}

#: decorators that compile the function they wrap
_COMPILE_DECORATORS = ("torch.compile", "torch.jit.script")

#: a parameter annotated with one of these is a Python value torch.compile
#: specializes on (guards), not a traced tensor
_STATIC_ANNOTATIONS = ("int", "float", "bool", "str", "bytes")


def module_aliases(tree: ast.Module) -> dict[str, str]:
    """Local name -> dotted target for every import in ``tree`` (function
    bodies included), as ``import torch._higher_order_ops as h`` or
    ``from torch import cond`` bind them."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    out.setdefault(head, head)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def dotted_name(node: ast.AST, aliases: dict[str, str]) -> Optional[str]:
    """``node`` as a dotted name with its head alias expanded, or None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


class TracerSafetyRule:
    """Host-side ops on traced values inside a compiled function either
    fail under capture or silently bake a traced value into the
    compiled graph — both are kernel bugs. Heuristic, scoped to ops/.

    A function is *traced* (compiled) when torch runs its body under
    capture or compilation: it is decorated with ``torch.compile`` or
    ``torch.jit.script`` (called or not, or through
    ``functools.partial``), or its name is passed as the function
    argument of ``torch.compile(fn)``, ``torch.jit.script(fn)``,
    ``torch.cuda.make_graphed_callables(fn, ...)``, or as a body of
    ``torch.cond`` / ``torch._higher_order_ops.while_loop`` / ``scan``
    in the same file. Under CUDA graph capture ``.item()``,
    ``.tolist()`` and ``float()`` on a tensor raise, and a Python branch
    on a tensor's value is frozen at capture: the two failure modes of
    a JAX tracer.

    Which parameters are traced: every parameter but ``self``/``cls``
    and the *static* ones, which torch.compile specializes on instead of
    tracing: a parameter annotated ``int``, ``float``, ``bool``, ``str``
    or ``bytes``, or one whose default is a constant other than None.
    Two uses stay exempt even on a traced tensor: ``.shape`` /
    ``.dtype`` / ``.ndim`` / ``.device`` metadata, and ``is (not) None``
    checks."""

    code = "VL004"
    name = "jit-tracer-safety"
    description = ("float()/int()/bool()/.item()/.tolist() or Python "
                   "branching on a traced arg inside a compiled function")

    SCOPE_PARTS = ("ops",)

    @staticmethod
    def _is_compile_expr(node: ast.AST, aliases: dict[str, str]) -> bool:
        return dotted_name(node, aliases) in _COMPILE_DECORATORS

    @classmethod
    def _decorated(cls, fn, aliases: dict[str, str]) -> bool:
        for dec in fn.decorator_list:
            if cls._is_compile_expr(dec, aliases):
                return True
            if not isinstance(dec, ast.Call):
                continue
            if cls._is_compile_expr(dec.func, aliases):
                return True  # @torch.compile(mode=...)
            f = dec.func
            is_partial = ((isinstance(f, ast.Name) and f.id == "partial")
                          or (isinstance(f, ast.Attribute)
                              and f.attr == "partial"))
            if is_partial and dec.args \
                    and cls._is_compile_expr(dec.args[0], aliases):
                return True
        return False

    @staticmethod
    def _static_params(fn) -> set[str]:
        a = fn.args
        out: set[str] = set()
        positional = a.posonlyargs + a.args
        defaults = [None] * (len(positional) - len(a.defaults)) \
            + list(a.defaults)
        pairs = list(zip(positional, defaults)) \
            + list(zip(a.kwonlyargs, a.kw_defaults))
        for arg, default in pairs:
            ann = arg.annotation
            if isinstance(ann, ast.Name) and ann.id in _STATIC_ANNOTATIONS:
                out.add(arg.arg)
            elif (isinstance(default, ast.Constant)
                  and default.value is not None):
                out.add(arg.arg)
        return out

    @classmethod
    def traced_functions(cls, tree: ast.Module) -> dict[int, set[str]]:
        """id(FunctionDef) -> its static parameter names, for every
        traced function in ``tree`` (the class docstring's notion)."""
        aliases = module_aliases(tree)
        handed: set[str] = set()
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            where = _TRACING_CALLS.get(dotted_name(node.func, aliases) or "")
            if where is None:
                continue
            for i in where:
                arg = node.args[i] if i < len(node.args) else None
                for e in (arg.elts if isinstance(arg, (ast.Tuple, ast.List))
                          else [arg]):
                    if isinstance(e, ast.Name):
                        handed.add(e.id)
        out: dict[int, set[str]] = {}
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name in handed or cls._decorated(fn, aliases):
                out[id(fn)] = cls._static_params(fn) | {"self", "cls"}
        return out

    @classmethod
    def _traced_uses(cls, node: ast.AST, traced: set[str]) -> set[str]:
        """Traced params used as VALUES in ``node``. Two uses are
        static even on a traced tensor and excluded: ``.shape/.dtype/
        .ndim/.device`` metadata access, and ``is (not) None`` identity
        checks (the optional-tensor-arg idiom)."""
        if (isinstance(node, ast.Attribute)
                and node.attr in ("shape", "dtype", "ndim", "device")):
            return set()
        if (isinstance(node, ast.Compare)
                and all(isinstance(op, (ast.Is, ast.IsNot))
                        for op in node.ops)):
            return set()
        if isinstance(node, ast.Name):
            return {node.id} & traced
        out: set[str] = set()
        for child in ast.iter_child_nodes(node):
            out |= cls._traced_uses(child, traced)
        return out

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        parts = ctx.scope_dirs()
        if not any(p in parts for p in self.SCOPE_PARTS):
            return
        traced_fns = self.traced_functions(ctx.tree)
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            statics = traced_fns.get(id(fn))
            if statics is None:
                continue
            a = fn.args
            params = {p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)}
            traced = params - statics
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    f = node.func
                    if (isinstance(f, ast.Name)
                            and f.id in ("float", "int", "bool")
                            and len(node.args) == 1
                            and not isinstance(node.args[0], ast.Constant)
                            and self._traced_uses(node.args[0], traced)):
                        yield finding_at(
                            ctx.relpath, node, self.code,
                            f"{f.id}() on a traced value inside compiled "
                            f"{fn.name}() — forces a host sync or fails "
                            f"at trace time")
                    elif (isinstance(f, ast.Attribute)
                          and f.attr in ("item", "tolist")):
                        yield finding_at(
                            ctx.relpath, node, self.code,
                            f".{f.attr}() inside compiled {fn.name}() — "
                            f"host transfer of a traced value")
                elif isinstance(node, (ast.If, ast.While)):
                    hot = self._traced_uses(node.test, traced)
                    if hot:
                        yield finding_at(
                            ctx.relpath, node, self.code,
                            f"Python branch on traced arg(s) "
                            f"{sorted(hot)} inside compiled {fn.name}() — "
                            f"use torch.where/torch.cond")


class DirectLockRule:
    """Data-plane modules construct locks via analysis.lockcheck so
    VOLSYNC_TPU_LOCKCHECK can instrument them; a direct
    threading.Lock() there is invisible to the detector."""

    code = "VL005"
    name = "lockcheck-routed-locks"
    description = ("direct threading.Lock/RLock construction in a "
                   "data-plane module (repo/objstore/ops/engine/obs/io)")

    SCOPE_PARTS = ("repo", "objstore", "ops", "engine", "obs", "io")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        parts = ctx.scope_dirs()
        if not any(p in parts for p in self.SCOPE_PARTS):
            return
        lock_names: set[str] = set()
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.ImportFrom)
                    and node.module == "threading"):
                lock_names.update(
                    a.asname or a.name for a in node.names
                    if a.name in ("Lock", "RLock"))
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            hit = None
            if (isinstance(f, ast.Attribute) and f.attr in ("Lock", "RLock")
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "threading"):
                hit = f.attr
            elif isinstance(f, ast.Name) and f.id in lock_names:
                hit = f.id
            if hit:
                yield finding_at(
                    ctx.relpath, node, self.code,
                    f"threading.{hit}() constructed directly — use "
                    f"analysis.lockcheck.make_{hit.lower()}(name) so "
                    f"VOLSYNC_TPU_LOCKCHECK can instrument it")


class AdHocRetryRule:
    """Every retry loop routes through resilience.RetryPolicy — one
    audited story for classification, backoff jitter, deadlines, and
    breaker/metrics integration. A ``time.sleep`` in an except handler
    or in a loop that wraps a try is the signature of a hand-rolled
    retry."""

    code = "VL105"
    name = "adhoc-retry"
    description = ("time.sleep inside an except handler or a retry loop "
                   "(for/while containing a try) outside resilience.py")

    @staticmethod
    def _sleep_names(tree: ast.Module) -> tuple[set[str], set[str]]:
        """(module aliases of ``time``, local names bound to
        ``time.sleep``) — alias-aware, same pattern as VL001."""
        time_aliases: set[str] = set()
        sleep_names: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        time_aliases.add(a.asname or "time")
            elif (isinstance(node, ast.ImportFrom)
                  and node.module == "time" and node.level == 0):
                for a in node.names:
                    if a.name == "sleep":
                        sleep_names.add(a.asname or "sleep")
        return time_aliases, sleep_names

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if ctx.in_module("resilience.py"):
            return
        time_aliases, sleep_names = self._sleep_names(ctx.tree)
        if not time_aliases and not sleep_names:
            return

        def is_sleep(call: ast.Call) -> bool:
            f = call.func
            if (isinstance(f, ast.Attribute) and f.attr == "sleep"
                    and isinstance(f.value, ast.Name)
                    and f.value.id in time_aliases):
                return True
            return isinstance(f, ast.Name) and f.id in sleep_names

        findings: list[Finding] = []

        def visit(node: ast.AST, in_except: bool, in_retry_loop: bool):
            for child in ast.iter_child_nodes(node):
                ie, irl = in_except, in_retry_loop
                if isinstance(child, ast.ExceptHandler):
                    ie = True
                elif isinstance(child, (ast.For, ast.While)):
                    if any(isinstance(n, ast.Try)
                           for n in ast.walk(child)):
                        irl = True
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef,
                                        ast.Lambda)):
                    # a nested function is a fresh context: its sleeps
                    # are judged by ITS loops/handlers, not the
                    # enclosing ones
                    ie = irl = False
                if (isinstance(child, ast.Call) and (ie or irl)
                        and is_sleep(child)):
                    where = ("an except handler" if ie
                             else "a retry loop")
                    findings.append(finding_at(
                        ctx.relpath, child, self.code,
                        f"time.sleep in {where} — hand-rolled retry; "
                        f"route through resilience.RetryPolicy "
                        f"(policy.call or policy.backoffs())"))
                visit(child, ie, irl)

        visit(ctx.tree, False, False)
        yield from findings


class HotPathCopyRule:
    """The zero-copy data plane (docs/performance.md) moves payload
    bytes as pooled buffers and memoryviews; every host copy that
    remains is sanctioned, ledgered via ``obs.record_copy``, and
    suppressed here with a reason. A NEW ``.tobytes()`` /
    ``bytes(buffer)`` / ``b"".join`` on these modules is the
    regression class the zero-copy work removed — flag it so the copy
    either goes away or joins the ledger explicitly."""

    code = "VL106"
    name = "hot-path-copy"
    description = (".tobytes()/bytes(<buffer>)/b\"\".join copy in a "
                   "zero-copy data-plane module (engine/, ops/, repo/)")

    SCOPE_PARTS = ("engine", "ops", "repo")

    @staticmethod
    def _is_bytes_literal(node: ast.AST) -> bool:
        return (isinstance(node, ast.Constant)
                and isinstance(node.value, bytes))

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        parts = ctx.scope_dirs()
        if not any(p in parts for p in self.SCOPE_PARTS):
            return
        # consult the VL503 sanction verdict: a copy whose statement
        # (or adjacent sibling) ledgers a sanctioned record_copy is the
        # accounted-for kind — no blanket suppression needed
        from volsync_tpu_torch.analysis.bufflow import sanctioned_lines

        ledgered = sanctioned_lines(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if node.lineno in ledgered:
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "tobytes":
                yield finding_at(
                    ctx.relpath, node, self.code,
                    ".tobytes() materializes a copy on the zero-copy "
                    "data plane — pass the buffer itself (hashing, "
                    "numpy, and the store all take memoryviews), or "
                    "sanction it: record_copy(site, n) + a reasoned "
                    "`# lint: ignore[VL106]`")
            elif (isinstance(f, ast.Name) and f.id == "bytes"
                  and len(node.args) == 1 and not node.keywords
                  and not isinstance(node.args[0], ast.Constant)):
                # bytes(<expr>) copies any buffer; bytes(1024) and
                # bytes literals are allocations, not copies, and
                # constant args are skipped above
                yield finding_at(
                    ctx.relpath, node, self.code,
                    "bytes(...) over a buffer copies it — keep the "
                    "memoryview/bytearray, or sanction the copy: "
                    "record_copy(site, n) + a reasoned "
                    "`# lint: ignore[VL106]`")
            elif (isinstance(f, ast.Attribute) and f.attr == "join"
                  and self._is_bytes_literal(f.value)):
                yield finding_at(
                    ctx.relpath, node, self.code,
                    "bytes join materializes one contiguous copy — "
                    "hand the parts list down (iovec PutBody, "
                    "seal_parts, writelines), or sanction the copy: "
                    "record_copy(site, n) + a reasoned "
                    "`# lint: ignore[VL106]`")


class SpanNameLiteralRule:
    """Span names feed Prometheus labels
    (``volsync_stage_duration_seconds{stage}``,
    ``volsync_svc_stage_seconds{stage}``) and the VL-clean flight
    recorder: a dynamic name (f-string, concatenation, variable) at a
    ``span()``/``begin_span()`` call site is unbounded label
    cardinality. Names must be literal ``component.stage`` strings —
    lowercase, dotted, ``[a-z0-9_]`` segments."""

    code = "VL301"
    name = "span-name-literal"
    description = ("span()/begin_span() call whose name is not a literal "
                   "dotted lowercase string")

    TARGETS = ("span", "begin_span")
    _NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")
    #: receiver names for attribute-style calls (obs.span(...),
    #: tracing.begin_span(...)); a bare ``m.span(1)`` (re.Match.span)
    #: is NOT matched because ``m`` is not a tracing receiver
    RECEIVERS = ("obs", "tracing")

    def _is_target(self, func: ast.AST) -> bool:
        if isinstance(func, ast.Name):
            return func.id in self.TARGETS
        if isinstance(func, ast.Attribute) and func.attr in self.TARGETS:
            return (isinstance(func.value, ast.Name)
                    and func.value.id in self.RECEIVERS)
        return False

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        # the tracing module itself defines span()/begin_span() and
        # forwards caller-supplied names internally
        if ctx.in_module("obs/tracing.py"):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if not self._is_target(node.func):
                continue
            name_arg = node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "name"),
                None)
            if name_arg is None:
                continue  # not the tracing API's shape
            literal = _const_str(name_arg)
            if literal is None:
                yield finding_at(
                    ctx.relpath, node, self.code,
                    "span name is not a string literal — dynamic names "
                    "(f-strings/concatenation/variables) are unbounded "
                    "Prometheus label cardinality; use a literal "
                    "component.stage name and carry variability in "
                    "span attributes")
            elif not self._NAME_RE.match(literal):
                yield finding_at(
                    ctx.relpath, node, self.code,
                    f"span name {literal!r} is not dotted-lowercase "
                    f"(expected e.g. 'engine.read': [a-z0-9_] segments "
                    f"joined by '.')")


def default_rules() -> list:
    return [EnvFlagRule(), ImportGateRule(), SilentExceptRule(),
            TracerSafetyRule(), DirectLockRule(), AdHocRetryRule(),
            HotPathCopyRule(), SpanNameLiteralRule()]
