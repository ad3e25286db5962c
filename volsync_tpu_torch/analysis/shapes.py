"""Static shape/dtype abstract interpreter + the VL2xx rule family.

Ports ``volsync_tpu/analysis/shapes.py`` to torch's idiom. An abstract
interpreter over the project call graph (analysis/callgraph.py) that
pushes the (shape, dtype, Python-scalar) lattice from
analysis/absdomain.py through ``torch.*`` calls and Tensor methods:
literal shapes from ``zeros``/``ones``/``empty``/``full``/``arange``
(a size tuple or varargs, ``dtype=``), broadcasting, reductions with
``dim=``/``keepdim=``, ``reshape``/``view`` (with ``-1``),
``cat``/``stack`` with ``dim=``, ``@``/``matmul`` arity rules, and
interprocedural function summaries (a callee is re-interpreted under
its caller's abstract arguments, memoized per argument signature,
cycle-guarded — the same fixpoint discipline as the VL10x dataflow
rules). A module is interpreted when it imports torch; NumPy values
stay Unknown (their lattice is NumPy's, not torch's).

Rules:

* **VL201** (error) shape-incompatible elementwise / matmul / reshape /
  cat operands — reported only when every involved dim is concrete;
* **VL202** (warning) implicit dtype promotion that moves an unsigned
  operand off its dtype (``uint32 -> int64/float32/...``), or a
  promotion torch refuses (``unsupported``: uint16/32/64 against any
  other non-floating dtype), in ``ops/`` / ``kernels/`` hash arithmetic,
  unless an explicit ``.to(...)`` / ``.type(...)`` / cast method /
  ``dtype=`` appears on either operand;
* **VL203** (error) ``torch._higher_order_ops.while_loop`` / ``scan``
  carry whose inferred shape/dtype differs from its init (torch refuses
  such a carry when it traces the body);
* **VL204** (error) ``torch.vmap`` / ``torch.func.vmap``
  ``in_dims``/``out_dims`` arity vs the callee signature, and
  mapped-dim validity against known arg ranks;
* **VL205** (error) axis names given to the port's mesh API
  (``build_mesh``/``Mesh`` axis names, the ``axis`` parameters of the
  mesh module's functions) or to a ``torch.distributed`` DeviceMesh
  (``mesh_dim_names``, ``mesh["..."]``) checked against the axes
  declared in ``parallel/mesh.py``.

Everything is conservative: Unknown or merely-symbolic values can
suppress a finding but never create one, so an unresolved helper or
an exotic construct costs recall, not precision. Findings discovered
while interpreting a callee under a caller's arguments are reported
at the caller's call site with a hop chain (``... via mix()``) and
the sink location in the message, deduplicated on the sink so a
helper shared by many kernels is reported once.
"""

from __future__ import annotations

import ast
import weakref
from dataclasses import dataclass
from typing import Optional

from volsync_tpu_torch.analysis import absdomain as D
from volsync_tpu_torch.analysis.absdomain import AbsArray, UNKNOWN_ARRAY
from volsync_tpu_torch.analysis.callgraph import ProjectIndex, attr_chain
from volsync_tpu_torch.analysis.engine import Finding, finding_at

_SEVERITY = {"VL201": "error", "VL202": "warning", "VL203": "error",
             "VL204": "error", "VL205": "error"}

_MAX_DEPTH = 8  # interprocedural interpretation depth
_MAX_CALLS = 20000  # per-project budget; past it calls go Unknown
_MAX_LITERAL_ITER = 128  # comprehension/range unrolling cap


# -- abstract value classes -------------------------------------------------

class _UnknownType:
    __slots__ = ()

    def __repr__(self) -> str:
        return "Unknown"


Unknown = _UnknownType()


@dataclass(frozen=True)
class PyInt:
    """Python int with an abstract value usable as a dim."""

    dim: object = None  # int | structural tuple | None


@dataclass(frozen=True)
class PyFloat:
    value: object = None


@dataclass(frozen=True)
class PyBool:
    value: object = None


@dataclass(frozen=True)
class PyStr:
    value: object = None


@dataclass(frozen=True)
class PyNoneV:
    pass


@dataclass(frozen=True)
class PyTuple:
    elts: tuple


@dataclass(frozen=True)
class PyDtype:
    name: str


@dataclass(frozen=True)
class PyModule:
    """Dotted reference not (yet) resolved to a value: an external
    module/function (``torch.nn``, ``torch.compile``) or a project
    module used as a namespace."""

    dotted: str


@dataclass(frozen=True)
class PyBuiltin:
    name: str


class PyFunc:
    """Reference to a project function, optionally with the defining
    frame's environment captured (nested defs / closures)."""

    __slots__ = ("qual", "closure")

    def __init__(self, qual: str, closure: Optional[dict] = None):
        self.qual = qual
        self.closure = closure


class PyLambda:
    __slots__ = ("node", "closure", "mod")

    def __init__(self, node: ast.Lambda, closure: dict, mod):
        self.node = node
        self.closure = closure
        self.mod = mod


class PyPartial:
    __slots__ = ("fn", "args", "kwargs")

    def __init__(self, fn, args, kwargs):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs


class PyVmapped:
    __slots__ = ("fn", "in_axes", "out_axes", "node")

    def __init__(self, fn, in_axes, out_axes, node):
        self.fn = fn
        self.in_axes = in_axes  # int | None | tuple | Unknown
        self.out_axes = out_axes
        self.node = node


@dataclass
class Rec:
    """A finding raised inside a nested (callee) frame, propagated up
    to the top-level caller for emission with a hop chain."""

    code: str
    message: str
    sink_rel: str
    sink_line: int
    chain: tuple = ()  # callee qualnames, outermost hop first


def _short(qual: str) -> str:
    return qual.rsplit(".", 1)[-1]


def _chain_str(chain) -> str:
    return " -> ".join(f"{_short(q)}()" for q in chain)


# -- value helpers ----------------------------------------------------------

def to_array(v) -> AbsArray:
    """A Python scalar takes its torch wrapped-number dtype (int ->
    int64, float -> the default float32, bool -> bool), marked weak."""
    if isinstance(v, AbsArray):
        return v
    if isinstance(v, PyInt):
        return AbsArray((), D.SCALAR_DTYPE["int"], weak=True)
    if isinstance(v, PyBool):
        return AbsArray((), D.SCALAR_DTYPE["bool"], weak=True)
    if isinstance(v, PyFloat):
        return AbsArray((), D.SCALAR_DTYPE["float"], weak=True)
    if isinstance(v, PyTuple):
        return _literal_array(v, None)
    return UNKNOWN_ARRAY


def _literal_array(v: PyTuple, dtype: Optional[str]) -> AbsArray:
    """Shape/dtype of a tensor built from a (nested) Python list
    (``torch.tensor``: ints -> int64, floats -> float32)."""
    n = len(v.elts)
    inner_shapes = []
    kinds = set()
    for e in v.elts:
        if isinstance(e, PyTuple):
            a = _literal_array(e, None)
            inner_shapes.append(a.shape)
            kinds.add(a.dtype)
        elif isinstance(e, AbsArray):
            inner_shapes.append(e.shape)
            kinds.add(e.dtype)
        elif isinstance(e, PyInt):
            inner_shapes.append(())
            kinds.add("int64")
        elif isinstance(e, PyFloat):
            inner_shapes.append(())
            kinds.add("float32")
        elif isinstance(e, PyBool):
            inner_shapes.append(())
            kinds.add("bool")
        else:
            return AbsArray((n,) if n else (0,), dtype)
    first = inner_shapes[0] if inner_shapes else ()
    if any(s != first for s in inner_shapes) or first is None:
        return AbsArray((n,), dtype)
    dt = dtype if dtype else (kinds.pop() if len(kinds) == 1 else None)
    return AbsArray((n,) + first, dt)


def dim_of(v):
    if isinstance(v, PyInt):
        return v.dim
    if isinstance(v, AbsArray) and v.shape == () and v.dtype and \
            D.kind(v.dtype) in (D.KIND_UINT, D.KIND_INT):
        return None  # a traced scalar: valid as a (symbolic) dim
    return None


def shape_from(v) -> Optional[tuple]:
    if isinstance(v, PyTuple):
        return tuple(dim_of(e) for e in v.elts)
    if isinstance(v, PyInt):
        return (v.dim,)
    return None


def size_args(args) -> Optional[tuple]:
    """A torch size given as one tuple/list or as varargs ints
    (``zeros((4, 8))``, ``zeros(4, 8)``, ``x.view(-1, 32)``)."""
    if len(args) == 1 and isinstance(args[0], (PyTuple, PyInt)):
        return shape_from(args[0])
    if args and all(isinstance(a, PyInt) for a in args):
        return tuple(a.dim for a in args)
    return None


def dtype_from(v) -> Optional[str]:
    if isinstance(v, PyDtype):
        return v.name
    if isinstance(v, PyBuiltin):
        # dtype=bool / dtype=int / dtype=float with the Python builtin
        return {"bool": "bool", "int": "int64",
                "float": "float64"}.get(v.name)
    return None


def join_value(a, b):
    if a is b:
        return a
    if isinstance(a, AbsArray) and isinstance(b, AbsArray):
        return D.join_array(a, b)
    if isinstance(a, PyInt) and isinstance(b, PyInt):
        return PyInt(D.join_dim(a.dim, b.dim))
    if isinstance(a, PyTuple) and isinstance(b, PyTuple) \
            and len(a.elts) == len(b.elts):
        return PyTuple(tuple(join_value(x, y)
                             for x, y in zip(a.elts, b.elts)))
    if isinstance(a, PyNoneV) and isinstance(b, PyNoneV):
        return a
    if isinstance(a, PyStr) and isinstance(b, PyStr):
        return a if a.value == b.value else PyStr(None)
    if isinstance(a, PyFunc) and isinstance(b, PyFunc) \
            and a.qual == b.qual:
        return a
    if a == b:
        return a
    return Unknown


def _vkey(v, depth=0):
    """Canonical memo key for an abstract value."""
    if depth > 4:
        return "?"
    if isinstance(v, AbsArray):
        return ("A", v.shape, v.dtype, v.weak)
    if isinstance(v, PyInt):
        return ("I", v.dim)
    if isinstance(v, PyTuple):
        return ("T", tuple(_vkey(e, depth + 1) for e in v.elts))
    if isinstance(v, PyFunc):
        return ("F", v.qual, id(v.closure) if v.closure else 0)
    if isinstance(v, (PyStr, PyFloat, PyBool)):
        return ("C", type(v).__name__, getattr(v, "value", None))
    if isinstance(v, PyDtype):
        return ("D", v.name)
    if isinstance(v, PyNoneV):
        return "N"
    return "?"


#: Tensor methods that cast to a fixed dtype (``x.long()``)
_CAST_METHODS = {
    "bool": "bool", "byte": "uint8", "char": "int8", "short": "int16",
    "int": "int32", "long": "int64", "half": "float16",
    "bfloat16": "bfloat16", "float": "float32", "double": "float64",
    "cfloat": "complex64", "cdouble": "complex128",
}


def _explicit_cast(node) -> bool:
    """Syntactic escape hatch for VL202: the operand expression is an
    explicit cast (``x.to(...)``, ``x.type(...)``, ``x.long()``, or any
    call carrying ``dtype=``)."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute) and (
            f.attr in ("to", "type") or f.attr in _CAST_METHODS):
        return True
    return any(kw.arg == "dtype" for kw in node.keywords)


_BIN_OPS = {
    ast.Add: "add", ast.Sub: "sub", ast.Mult: "mul",
    ast.FloorDiv: "floordiv", ast.Mod: "mod", ast.Pow: "pow",
    ast.Div: "div", ast.BitAnd: "and", ast.BitOr: "or",
    ast.BitXor: "xor", ast.LShift: "shl", ast.RShift: "shr",
    ast.MatMult: "matmul",
}

_DIM_FOLDABLE = {"add", "sub", "mul", "floordiv", "mod"}


#: torch functions / Tensor methods that are binary elementwise ops
_FUNC_OPS = {
    "add": "add", "sub": "sub", "subtract": "sub", "mul": "mul",
    "multiply": "mul", "div": "div", "divide": "div",
    "true_divide": "div", "floor_divide": "floordiv",
    "remainder": "mod", "fmod": "mod", "bitwise_and": "and",
    "bitwise_or": "or", "bitwise_xor": "xor",
    "bitwise_left_shift": "shl", "bitwise_right_shift": "shr",
    "maximum": "and", "minimum": "and", "eq": "cmp", "ne": "cmp",
    "lt": "cmp", "le": "cmp", "gt": "cmp", "ge": "cmp",
}

#: calls that compile or capture a function and hand it back (the
#: keyword naming the function)
_COMPILERS = {"torch.compile": "model", "torch.jit.script": "obj",
              "torch.cuda.make_graphed_callables": "callables"}


def _zero_dim(a: AbsArray) -> Optional[bool]:
    """Whether a tensor operand is zero-dim (torch's middle promotion
    tier); None when its rank is unknown."""
    return None if a.shape is None else a.shape == ()


def _int_accum(dtype: Optional[str]) -> Optional[str]:
    """torch's sum/prod/cumsum dtype: bool and every integer dtype
    accumulate in int64."""
    if dtype is not None and D.kind(dtype) in (D.KIND_BOOL, D.KIND_UINT,
                                               D.KIND_INT):
        return "int64"
    return dtype


def _drop_dim(v, dim):
    """One slice of ``v`` along ``dim`` (a scan's per-step element)."""
    if isinstance(v, AbsArray):
        if v.shape is not None and D.is_conc(dim) \
                and -len(v.shape) <= dim < len(v.shape):
            dims = list(v.shape)
            dims.pop(dim)
            return AbsArray(tuple(dims), v.dtype, v.weak)
        return AbsArray(None, v.dtype, v.weak)
    return Unknown


# -- the interpreter --------------------------------------------------------

class Interp:
    """One abstract interpretation of a ProjectIndex.

    Module bodies are interpreted first (building per-module constant
    environments: ``_H0``/``_K`` tables, masks, axis-name strings),
    then every function standalone with Unknown parameters. Calls to
    resolved project functions recurse with the caller's abstract
    arguments — memoized per ``(qualname, arg-signature)``, bounded by
    depth and a global call budget, cycle-guarded by an in-progress
    stack.
    """

    def __init__(self, index: ProjectIndex):
        self.index = index
        self.found: list[Finding] = []
        self.summaries: dict[str, dict[str, str]] = {}
        self._seen: set = set()  # (sink_rel, sink_line, code) dedup
        self._menvs: dict[str, dict] = {}
        self._menv_wip: dict[str, dict] = {}
        self._memo: dict = {}
        self._in_progress: set[str] = set()
        self._calls = 0
        self._sym_counter = 0
        self._crashes = 0

    # -- entry points -------------------------------------------------------

    def run(self) -> None:
        mods = sorted(
            (m for m in self.index.modules.values() if self._relevant(m)),
            key=lambda m: m.relpath)
        for m in mods:
            self.module_env(m.name)
        funcs = sorted(
            (fi for fi in self.index.functions.values()
             if self._relevant_rel(fi.relpath)),
            key=lambda fi: (fi.relpath, fi.node.lineno))
        for fi in funcs:
            try:
                self.run_function(fi)
            except Exception:
                # an interpreter bug must degrade to missing findings,
                # never crash the lint run or fabricate results
                self._crashes += 1
        self.found.extend(check_mesh_axes(self.index))
        self.found.sort(key=lambda f: (f.path, f.line, f.code))

    def _relevant(self, mod) -> bool:
        return any(t == "torch" or t.startswith("torch.")
                   for t in mod.aliases.values())

    def _relevant_rel(self, relpath: str) -> bool:
        mod = self.index.by_relpath.get(relpath)
        return mod is not None and self._relevant(mod)

    def module_env(self, name: str) -> dict:
        if name in self._menvs:
            return self._menvs[name]
        if name in self._menv_wip:
            return self._menv_wip[name]  # import cycle: partial env
        mod = self.index.modules.get(name)
        if mod is None or not self._relevant(mod):
            self._menvs[name] = {}
            return self._menvs[name]
        env: dict = {}
        self._menv_wip[name] = env
        frame = Frame(self, mod, env, depth=0)
        try:
            frame.exec_block(mod.ctx.tree.body)
        except Exception:
            self._crashes += 1
        del self._menv_wip[name]
        self._menvs[name] = env
        return env

    def run_function(self, fi) -> None:
        mod = self.index.by_relpath.get(fi.relpath)
        if mod is None:
            return
        env = {p: Unknown for p in fi.params + fi.kwonly}
        a = fi.node.args
        if a.vararg:
            env[a.vararg.arg] = Unknown
        if a.kwarg:
            env[a.kwarg.arg] = Unknown
        frame = Frame(self, mod, env, depth=0, fn=fi)
        frame.exec_block(fi.node.body)
        ret = frame.returns[0] if len(frame.returns) == 1 else (
            _join_all(frame.returns) if frame.returns else PyNoneV())
        self.summaries.setdefault(fi.relpath, {})[fi.qualname] = \
            _render(ret)

    # -- emission -----------------------------------------------------------

    def emit(self, relpath: str, node, code: str, message: str,
             dedup_key=None) -> None:
        key = dedup_key or (relpath, getattr(node, "lineno", 0), code)
        if key in self._seen:
            return
        self._seen.add(key)
        self.found.append(finding_at(relpath, node, code, message,
                                     severity=_SEVERITY[code]))

    def fresh_sym(self):
        self._sym_counter += 1
        return D.sym(self._sym_counter)

    # -- interprocedural calls ----------------------------------------------

    def call_value(self, caller_frame, fv, args, kwargs, node):
        """Invoke an abstract callable; returns (ret, records) where
        records carry findings raised inside the callee with their
        hop chain already prepended."""
        self._calls += 1
        if self._calls > _MAX_CALLS or caller_frame.depth >= _MAX_DEPTH:
            return Unknown, ()
        if isinstance(fv, PyPartial):
            return self.call_value(
                caller_frame, fv.fn, list(fv.args) + list(args),
                {**fv.kwargs, **(kwargs or {})}, node)
        if isinstance(fv, PyLambda):
            return self._call_lambda(caller_frame, fv, args, node)
        if isinstance(fv, PyFunc):
            return self._call_func(caller_frame, fv, args, kwargs, node)
        return Unknown, ()

    def _call_lambda(self, caller_frame, lam: PyLambda, args, node):
        params = [p.arg for p in (lam.node.args.posonlyargs
                                  + lam.node.args.args)]
        env = {p: (args[i] if i < len(args) else Unknown)
               for i, p in enumerate(params)}
        frame = Frame(self, lam.mod, env, depth=caller_frame.depth + 1,
                      closure=lam.closure)
        ret = frame.eval(lam.node.body)
        recs = tuple(Rec(r.code, r.message, r.sink_rel, r.sink_line,
                         ("<lambda>",) + r.chain) for r in frame.records)
        return ret, recs

    def _call_func(self, caller_frame, fv: PyFunc, args, kwargs, node):
        fi = self.index.functions.get(fv.qual)
        if fi is None or fv.qual in self._in_progress:
            return Unknown, ()
        key = None
        if fv.closure is None:
            key = (fv.qual, tuple(_vkey(a) for a in args),
                   tuple(sorted((k, _vkey(v))
                                for k, v in (kwargs or {}).items())))
            if key in self._memo:
                return self._memo[key]
        params = list(fi.params)
        if fi.cls is not None and params and params[0] in ("self", "cls"):
            params = params[1:]
        env = {p: Unknown for p in params + fi.kwonly}
        for i, p in enumerate(params):
            if i < len(args):
                env[p] = args[i]
        for k, v in (kwargs or {}).items():
            if k in env:
                env[k] = v
        a = fi.node.args
        if a.vararg:
            env[a.vararg.arg] = Unknown
        if a.kwarg:
            env[a.kwarg.arg] = Unknown
        mod = self.index.by_relpath.get(fi.relpath)
        if mod is None:
            return Unknown, ()
        self._in_progress.add(fv.qual)
        try:
            frame = Frame(self, mod, env, depth=caller_frame.depth + 1,
                          fn=fi, closure=fv.closure)
            frame.exec_block(fi.node.body)
        finally:
            self._in_progress.discard(fv.qual)
        ret = _join_all(frame.returns) if frame.returns else PyNoneV()
        recs = tuple(Rec(r.code, r.message, r.sink_rel, r.sink_line,
                         (fv.qual,) + r.chain) for r in frame.records)
        if key is not None:
            self._memo[key] = (ret, recs)
        return ret, recs


def _join_all(values):
    if not values:
        return Unknown
    out = values[0]
    for v in values[1:]:
        out = join_value(out, v)
    return out


def _render(v) -> str:
    if isinstance(v, AbsArray):
        return f"{v.dtype or '?'}{D.shape_str(v.shape)}"
    if isinstance(v, PyTuple):
        return "(" + ", ".join(_render(e) for e in v.elts) + ")"
    if isinstance(v, PyInt):
        return f"int[{v.dim}]" if D.is_conc(v.dim) else "int"
    if isinstance(v, PyNoneV):
        return "None"
    return "?"


class Frame:
    """One function (or module body) being interpreted."""

    def __init__(self, interp: Interp, mod, env: dict, depth: int,
                 fn=None, closure: Optional[dict] = None):
        self.interp = interp
        self.mod = mod
        self.env = env
        self.depth = depth
        self.fn = fn
        self.closure = closure
        self.returns: list = []
        self.records: list[Rec] = []

    # -- finding plumbing ---------------------------------------------------

    def report(self, code: str, node, message: str) -> None:
        if self.depth == 0:
            self.interp.emit(self.mod.relpath, node, code, message)
        else:
            self.records.append(Rec(code, message, self.mod.relpath,
                                    getattr(node, "lineno", 0)))

    def invoke(self, fv, args, kwargs, node):
        ret, recs = self.interp.call_value(self, fv, args, kwargs, node)
        for r in recs:
            if self.depth == 0:
                msg = (f"{r.message} [{r.sink_rel}:{r.sink_line}]"
                       f" via {_chain_str(r.chain)}")
                self.interp.emit(self.mod.relpath, node, r.code, msg,
                                 dedup_key=(r.sink_rel, r.sink_line,
                                            r.code))
            else:
                self.records.append(r)
        return ret

    def in_hash_scope(self) -> bool:
        parts = self.mod.ctx.scope_dirs()
        return "ops" in parts or "kernels" in parts

    # -- statements ---------------------------------------------------------

    def exec_block(self, stmts) -> bool:
        """Interpret a statement list; True when control definitely
        left the block (return/raise/break)."""
        for stmt in stmts:
            if self.exec_stmt(stmt):
                return True
        return False

    def exec_stmt(self, stmt) -> bool:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            self._exec_assign(stmt)
        elif isinstance(stmt, ast.Expr):
            self._eval_effect(stmt.value)
        elif isinstance(stmt, ast.Return):
            self.returns.append(self.eval(stmt.value)
                                if stmt.value is not None else PyNoneV())
            return True
        elif isinstance(stmt, (ast.Raise,)):
            if stmt.exc is not None:
                self.eval(stmt.exc)
            return True
        elif isinstance(stmt, (ast.Break, ast.Continue)):
            return True
        elif isinstance(stmt, ast.If):
            self.eval(stmt.test)
            pre = dict(self.env)
            t_done = self.exec_block(stmt.body)
            post_t = self.env
            self.env = pre if not stmt.orelse else dict(pre)
            f_done = self.exec_block(stmt.orelse) if stmt.orelse else False
            post_f = self.env
            if t_done and not f_done:
                self.env = post_f
            elif f_done and not t_done:
                self.env = post_t
            else:
                self.env = _join_env(post_t, post_f)
            return t_done and f_done
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            it = self.eval(stmt.iter)
            pre = dict(self.env)
            self._bind_target(stmt.target, _loop_elt(it))
            self.exec_block(stmt.body)
            self.exec_block(stmt.orelse)
            self.env = _join_env(pre, self.env)
        elif isinstance(stmt, ast.While):
            self.eval(stmt.test)
            pre = dict(self.env)
            self.exec_block(stmt.body)
            self.exec_block(stmt.orelse)
            self.env = _join_env(pre, self.env)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self._bind_target(item.optional_vars, Unknown)
            return self.exec_block(stmt.body)
        elif isinstance(stmt, ast.Try):
            pre = dict(self.env)
            self.exec_block(stmt.body)
            merged = self.env
            for handler in stmt.handlers:
                self.env = dict(pre)
                if handler.name:
                    self.env[handler.name] = Unknown
                self.exec_block(handler.body)
                merged = _join_env(merged, self.env)
            self.env = merged
            self.exec_block(stmt.orelse)
            self.exec_block(stmt.finalbody)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = self._nested_qual(stmt.name)
            if qual is not None:
                # late-binding closure: the env dict itself, so the
                # callee sees names bound after the def (like Python)
                self.env[stmt.name] = PyFunc(qual, closure=self.env)
            else:
                self.env[stmt.name] = Unknown
        elif isinstance(stmt, ast.ClassDef):
            self.env[stmt.name] = Unknown
        elif isinstance(stmt, ast.Assert):
            self.eval(stmt.test)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    self.env.pop(t.id, None)
        # Import/ImportFrom: the module-wide alias table (callgraph)
        # already covers these, including function-local imports.
        return False

    def _nested_qual(self, name: str) -> Optional[str]:
        if self.fn is not None and name in self.fn.nested:
            return self.fn.nested[name]
        if self.fn is None:  # module body
            return self.mod.functions.get(name)
        return None

    def _exec_assign(self, stmt) -> None:
        if isinstance(stmt, ast.AugAssign):
            val = self._arith(_BIN_OPS.get(type(stmt.op)),
                              self.eval(stmt.target), self.eval(stmt.value),
                              stmt, stmt.target, stmt.value)
            self._bind_target(stmt.target, val)
            return
        value_node = stmt.value
        if value_node is None:  # bare annotation
            return
        val = self.eval(value_node)
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        for t in targets:
            self._bind_target(t, val)

    def _bind_target(self, target, val) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = val
        elif isinstance(target, (ast.Tuple, ast.List)):
            elts = target.elts
            if isinstance(val, PyTuple) and len(val.elts) == len(elts) \
                    and not any(isinstance(e, ast.Starred) for e in elts):
                for t, v in zip(elts, val.elts):
                    self._bind_target(t, v)
            elif isinstance(val, AbsArray) and val.shape is not None \
                    and len(val.shape) >= 1 \
                    and not any(isinstance(e, ast.Starred) for e in elts):
                # unpacking an array's leading axis: B, N = x.shape is
                # handled via PyTuple; `a, b = arr` peels axis 0
                sub = AbsArray(val.shape[1:], val.dtype, val.weak)
                for t in elts:
                    self._bind_target(t, sub)
            else:
                for t in elts:
                    inner = t.value if isinstance(t, ast.Starred) else t
                    self._bind_target(inner, Unknown)
        # Subscript/Attribute writes keep the binding's abstract value

    def _eval_effect(self, node) -> None:
        """Expression statement: evaluate for findings; additionally
        kill list variables mutated in place (``w.append(x)``) so a
        stale literal length can't fabricate a shape downstream."""
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            f = node.func
            if f.attr in ("append", "extend", "insert", "pop", "remove",
                          "clear") and isinstance(f.value, ast.Name):
                for a in node.args:
                    self.eval(a)
                if isinstance(self.env.get(f.value.id), PyTuple):
                    self.env[f.value.id] = Unknown
                return
        self.eval(node)

    # -- expressions --------------------------------------------------------

    def eval(self, node):
        try:
            return self._eval(node)
        except RecursionError:
            raise
        except Exception:
            self.interp._crashes += 1
            return Unknown

    def _eval(self, node):
        if isinstance(node, ast.Constant):
            v = node.value
            if isinstance(v, bool):
                return PyBool(v)
            if isinstance(v, int):
                return PyInt(v)
            if isinstance(v, float):
                return PyFloat(v)
            if isinstance(v, str):
                return PyStr(v)
            if v is None:
                return PyNoneV()
            return Unknown
        if isinstance(node, ast.Name):
            return self.lookup(node.id)
        if isinstance(node, ast.Attribute):
            return self._eval_attr(node)
        if isinstance(node, ast.Subscript):
            return self._eval_subscript(node)
        if isinstance(node, ast.Call):
            return self._eval_call(node)
        if isinstance(node, ast.BinOp):
            return self._arith(_BIN_OPS.get(type(node.op)),
                               self.eval(node.left), self.eval(node.right),
                               node, node.left, node.right)
        if isinstance(node, ast.UnaryOp):
            v = self.eval(node.operand)
            if isinstance(node.op, ast.Not):
                return PyBool(None)
            if isinstance(node.op, ast.USub) and isinstance(v, PyInt):
                return PyInt(D.dim_binop("sub", 0, v.dim))
            if isinstance(v, AbsArray):
                return v
            return Unknown
        if isinstance(node, ast.Compare):
            left = self.eval(node.left)
            out = Unknown
            prev, prev_node = left, node.left
            for op, comp in zip(node.ops, node.comparators):
                cur = self.eval(comp)
                if isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)):
                    out = PyBool(None)
                else:
                    out = self._arith("cmp", prev, cur, node, prev_node,
                                      comp)
                prev, prev_node = cur, comp
            return out
        if isinstance(node, ast.BoolOp):
            vals = [self.eval(v) for v in node.values]
            return _join_all(vals)
        if isinstance(node, ast.IfExp):
            self.eval(node.test)
            return join_value(self.eval(node.body), self.eval(node.orelse))
        if isinstance(node, (ast.Tuple, ast.List)):
            if any(isinstance(e, ast.Starred) for e in node.elts):
                for e in node.elts:
                    self.eval(e.value if isinstance(e, ast.Starred) else e)
                return Unknown
            return PyTuple(tuple(self.eval(e) for e in node.elts))
        if isinstance(node, ast.Lambda):
            return PyLambda(node, self.env, self.mod)
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            return self._eval_comp(node)
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    self.eval(v.value)
            return PyStr(None)
        if isinstance(node, ast.Slice):
            return Unknown  # handled structurally at Subscript
        if isinstance(node, ast.Starred):
            self.eval(node.value)
            return Unknown
        if isinstance(node, (ast.Dict, ast.DictComp, ast.Set,
                             ast.Await, ast.Yield, ast.YieldFrom,
                             ast.NamedExpr)):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self.eval(child)
            if isinstance(node, ast.NamedExpr) and \
                    isinstance(node.target, ast.Name):
                v = self.eval(node.value)
                self.env[node.target.id] = v
                return v
            return Unknown
        return Unknown

    def _eval_comp(self, node):
        gens = node.generators
        if len(gens) != 1 or gens[0].ifs or gens[0].is_async:
            self.eval(gens[0].iter)
            return Unknown
        it = self.eval(gens[0].iter)
        target = gens[0].target
        if not isinstance(it, PyTuple) or not isinstance(target, ast.Name) \
                or len(it.elts) > _MAX_LITERAL_ITER:
            # one symbolic pass so findings inside the element expr
            # still surface
            is_name = isinstance(target, ast.Name)
            saved = self.env.get(target.id, None) if is_name else None
            self._bind_target(target, _loop_elt(it))
            self.eval(node.elt)
            if is_name:
                if saved is None:
                    self.env.pop(target.id, None)
                else:
                    self.env[target.id] = saved
            return Unknown
        out = []
        saved = self.env.get(target.id, None)
        for e in it.elts:
            self.env[target.id] = e
            out.append(self.eval(node.elt))
        if saved is None:
            self.env.pop(target.id, None)
        else:
            self.env[target.id] = saved
        return PyTuple(tuple(out))

    # -- names --------------------------------------------------------------

    def lookup(self, name: str):
        if name in self.env:
            return self.env[name]
        if self.closure is not None and name in self.closure:
            return self.closure[name]
        menv = self.interp.module_env(self.mod.name) \
            if self.fn is not None else self.env
        if name in menv:
            return menv[name]
        if name in self.mod.functions:
            return PyFunc(self.mod.functions[name])
        if name in self.mod.classes:
            return Unknown
        if name in self.mod.aliases:
            return self.resolve_dotted_value(self.mod.aliases[name])
        if name in _BUILTINS:
            return PyBuiltin(name)
        return Unknown

    def resolve_dotted_value(self, dotted: str):
        idx = self.interp.index
        q = idx.resolve_dotted(dotted)
        if q in idx.functions:
            return PyFunc(q)
        parts = dotted.split(".")
        for i in range(len(parts), 0, -1):
            m = idx.modules.get(".".join(parts[:i]))
            if m is None:
                continue
            rest = parts[i:]
            if not rest:
                return PyModule(dotted)
            if len(rest) == 1:
                menv = self.interp.module_env(m.name)
                if rest[0] in menv:
                    return menv[rest[0]]
                if rest[0] in m.functions:
                    return PyFunc(m.functions[rest[0]])
            return Unknown
        root = dotted.rsplit(".", 1)[0] if "." in dotted else ""
        leaf = dotted.rsplit(".", 1)[-1]
        if root == "torch" and D.canon_dtype(leaf):
            return PyDtype(D.canon_dtype(leaf))
        return PyModule(dotted)

    # -- attributes ---------------------------------------------------------

    def _eval_attr(self, node: ast.Attribute):
        base = self.eval(node.value)
        attr = node.attr
        if isinstance(base, PyModule):
            return self.resolve_dotted_value(base.dotted + "." + attr)
        if isinstance(base, AbsArray):
            if attr == "shape":
                if base.shape is None:
                    return Unknown
                return PyTuple(tuple(PyInt(d) for d in base.shape))
            if attr == "dtype":
                return PyDtype(base.dtype) if base.dtype else Unknown
            if attr == "ndim":
                return PyInt(base.rank())
            if attr == "T":
                if base.shape is None:
                    return base
                return AbsArray(tuple(reversed(base.shape)), base.dtype,
                                base.weak)
            if attr == "mT":
                if base.shape is None or len(base.shape) < 2:
                    return AbsArray(None, base.dtype, base.weak)
                return AbsArray(base.shape[:-2] + (base.shape[-1],
                                                   base.shape[-2]),
                                base.dtype, base.weak)
            if attr in ("real", "imag", "data"):
                return base
            return Unknown
        return Unknown

    # -- subscripts ---------------------------------------------------------

    def _eval_subscript(self, node: ast.Subscript):
        base = self.eval(node.value)
        idx_node = node.slice
        if isinstance(base, PyTuple):
            if isinstance(idx_node, ast.Slice):
                lo = self._dim_or_none(idx_node.lower, 0)
                hi = self._dim_or_none(idx_node.upper, len(base.elts))
                step = self._dim_or_none(idx_node.step, 1)
                if all(D.is_conc(x) for x in (lo, hi, step)) and step:
                    return PyTuple(tuple(base.elts[lo:hi:step]))
                return Unknown
            iv = self.eval(idx_node)
            d = dim_of(iv)
            if D.is_conc(d) and -len(base.elts) <= d < len(base.elts):
                return base.elts[d]
            return Unknown
        if isinstance(base, AbsArray):
            return self._index_array(base, idx_node)
        if isinstance(idx_node, ast.Slice):
            for part in (idx_node.lower, idx_node.upper, idx_node.step):
                if part is not None:
                    self.eval(part)
        else:
            self.eval(idx_node)
        return Unknown

    def _dim_or_none(self, expr, default):
        if expr is None:
            return default
        return dim_of(self.eval(expr))

    def _slice_len(self, dim, lower, upper, step):
        lo = self._dim_or_none(lower, 0)
        hi = self._dim_or_none(upper, dim)
        st = self._dim_or_none(step, 1)
        if D.is_conc(dim) and D.is_conc(lo) and D.is_conc(hi) \
                and D.is_conc(st) and st != 0:
            return len(range(*slice(
                lo if lower is not None else None,
                hi if upper is not None else None,
                st).indices(dim)))
        if st == 1:
            if (lower is None or lo == 0) and upper is not None:
                # x[:k] -> min(k, dim); only safely k when k <= dim is
                # not provable, so keep a structural token
                return ("min", hi, dim) if hi != dim else dim
            if upper is None and lower is not None:
                return D.dim_binop("sub", dim, lo)
            if lower is None and upper is None:
                return dim
        return None

    def _index_array(self, base: AbsArray, idx_node):
        items = list(idx_node.elts) if isinstance(idx_node, ast.Tuple) \
            else [idx_node]
        if base.shape is None:
            for it in items:
                if not isinstance(it, ast.Slice):
                    self.eval(it)
            return AbsArray(None, base.dtype, base.weak)
        dims = list(base.shape)
        out: list = []
        # how many real axes the non-ellipsis items consume
        consumed = sum(
            1 for it in items
            if not (isinstance(it, ast.Constant)
                    and (it.value is None or it.value is Ellipsis)))
        axis = 0
        for it in items:
            if isinstance(it, ast.Constant) and it.value is None:
                out.append(1)
                continue
            if isinstance(it, ast.Constant) and it.value is Ellipsis:
                take = len(dims) - consumed
                for _ in range(max(0, take)):
                    if axis < len(dims):
                        out.append(dims[axis])
                        axis += 1
                continue
            if axis >= len(dims):
                return AbsArray(None, base.dtype, base.weak)
            if isinstance(it, ast.Slice):
                out.append(self._slice_len(dims[axis], it.lower, it.upper,
                                           it.step))
                axis += 1
                continue
            iv = self.eval(it)
            if isinstance(iv, AbsArray) and iv.shape != ():
                if iv.dtype == "bool":
                    # boolean mask: flattens the masked axes
                    return AbsArray(None, base.dtype, base.weak)
                if iv.shape is None:
                    return AbsArray(None, base.dtype, base.weak)
                # integer gather on this axis
                out.extend(iv.shape)
                axis += 1
                continue
            d = dim_of(iv)
            if d is None and not isinstance(iv, (PyInt, AbsArray)):
                return AbsArray(None, base.dtype, base.weak)
            axis += 1  # integer index: axis dropped
        out.extend(dims[axis:])
        return AbsArray(tuple(out), base.dtype, base.weak)

    # -- arithmetic: the VL201/VL202 core -----------------------------------

    def _arith(self, op, lv, rv, node, lnode, rnode, opdesc=None):
        if op is None:
            return Unknown
        if op == "matmul":
            return self._dot(lv, rv, node, "matmul")
        if isinstance(lv, PyInt) and isinstance(rv, PyInt):
            if op in _DIM_FOLDABLE:
                return PyInt(D.dim_binop(op, lv.dim, rv.dim))
            if op == "cmp":
                return PyBool(None)
            if op == "div":
                return PyFloat(None)
            return PyInt(None)
        if isinstance(lv, (PyStr, PyTuple)) or isinstance(rv, (PyStr,
                                                               PyTuple)):
            # str/list concat & repeat stay at the Python level
            if op == "add" and isinstance(lv, PyTuple) \
                    and isinstance(rv, PyTuple):
                return PyTuple(lv.elts + rv.elts)
            if op == "mul":
                seq = lv if isinstance(lv, PyTuple) else (
                    rv if isinstance(rv, PyTuple) else None)
                n = dim_of(rv if seq is lv else lv)
                if seq is not None and D.is_conc(n) \
                        and 0 <= n * len(seq.elts) <= _MAX_LITERAL_ITER:
                    return PyTuple(seq.elts * n)
            if op == "cmp":
                return PyBool(None)
            return Unknown
        if lv is Unknown and rv is Unknown:
            return Unknown
        la, ra = to_array(lv), to_array(rv)
        shape, conflict = D.broadcast_shapes(la.shape, ra.shape)
        if conflict is not None:
            da, db, ax = conflict
            self.report(
                "VL201", node,
                f"shape mismatch: {opdesc or 'elementwise'} operands "
                f"{D.shape_str(la.shape)} vs {D.shape_str(ra.shape)} "
                f"conflict on dim {da} vs {db} (axis -{ax + 1}); "
                f"these can never broadcast")
        if op == "cmp":
            return AbsArray(shape, "bool" if (la.dtype and ra.dtype)
                            else None)
        dtype, weak = D.promote(la.dtype, la.weak, ra.dtype, ra.weak,
                                _zero_dim(la), _zero_dim(ra))
        if op == "div" and dtype not in (None, D.UNSUPPORTED) \
                and D.kind(dtype) < D.KIND_FLOAT:
            dtype, weak = "float32", False
        if dtype is not None and self.in_hash_scope():
            for arr, n_own, n_other in ((la, lnode, rnode),
                                        (ra, rnode, lnode)):
                if D.is_uint(arr.dtype) and not arr.weak \
                        and dtype != arr.dtype:
                    if _explicit_cast(lnode) or _explicit_cast(rnode):
                        break
                    self.report(
                        "VL202", node,
                        f"implicit dtype promotion {arr.dtype} -> "
                        f"{dtype} in hash arithmetic; unsigned "
                        f"wraparound semantics are lost — pin dtype= "
                        f"or add an explicit .to")
                    break
        if dtype == D.UNSUPPORTED:
            return AbsArray(shape, None)  # torch raises on this op
        return AbsArray(shape, dtype, weak)

    def _dot(self, lv, rv, node, opdesc):
        la, ra = to_array(lv), to_array(rv)
        dtype, weak = D.promote(la.dtype, la.weak, ra.dtype, ra.weak)
        if la.shape is None or ra.shape is None \
                or len(la.shape) == 0 or len(ra.shape) == 0:
            return AbsArray(None, dtype, weak)
        contract_l = la.shape[-1]
        contract_r = ra.shape[-2] if len(ra.shape) >= 2 else ra.shape[0]
        if D.is_conc(contract_l) and D.is_conc(contract_r) \
                and contract_l != contract_r:
            self.report(
                "VL201", node,
                f"shape mismatch: {opdesc} contracting dims "
                f"{contract_l} vs {contract_r} "
                f"({D.shape_str(la.shape)} @ {D.shape_str(ra.shape)})")
        if len(la.shape) == 1 and len(ra.shape) == 1:
            return AbsArray((), dtype, weak)
        if len(ra.shape) == 1:
            return AbsArray(la.shape[:-1], dtype, weak)
        if len(la.shape) == 1:
            return AbsArray(ra.shape[:-2] + ra.shape[-1:], dtype, weak)
        return AbsArray(la.shape[:-1] + ra.shape[-1:], dtype, weak)

    # -- calls --------------------------------------------------------------

    def _eval_call(self, node: ast.Call):
        has_star = any(isinstance(a, ast.Starred) for a in node.args)
        args = []
        arg_nodes = []
        for a in node.args:
            if isinstance(a, ast.Starred):
                self.eval(a.value)
            else:
                args.append(self.eval(a))
                arg_nodes.append(a)
        kwargs = {}
        for kw in node.keywords:
            v = self.eval(kw.value)
            if kw.arg is not None:
                kwargs[kw.arg] = v
        if has_star:
            args, arg_nodes = [], []  # positions unreliable: all-Unknown

        f = node.func
        if isinstance(f, ast.Attribute):
            base = self.eval(f.value)
            if isinstance(base, AbsArray):
                return self._array_method(base, f.attr, args, kwargs,
                                          node, arg_nodes)
            if isinstance(base, PyTuple):
                return Unknown  # list/tuple methods
            if isinstance(base, PyDtype):
                return Unknown
            if isinstance(base, PyModule):
                fv = self.resolve_dotted_value(base.dotted + "." + f.attr)
            else:
                return Unknown
        else:
            fv = self.eval(f)

        return self._dispatch(fv, args, kwargs, node, arg_nodes)

    def _dispatch(self, fv, args, kwargs, node, arg_nodes):
        if isinstance(fv, PyFunc) or isinstance(fv, PyLambda):
            return self.invoke(fv, args, kwargs, node)
        if isinstance(fv, PyPartial):
            return self.invoke(fv, args, kwargs, node)
        if isinstance(fv, PyVmapped):
            return self._call_vmapped(fv, args, kwargs, node)
        if isinstance(fv, PyBuiltin):
            return self._builtin(fv.name, args, kwargs, node)
        if isinstance(fv, PyModule):
            return self._api_call(fv.dotted, args, kwargs, node, arg_nodes)
        return Unknown

    # -- Tensor methods -----------------------------------------------------

    def _cast_target(self, arr: AbsArray, args, kwargs) -> Optional[str]:
        """The dtype ``x.to(...)`` / ``x.type(...)`` lands on: a dtype
        argument, another tensor's dtype, else (a device move) its own."""
        for v in list(args) + [kwargs.get("dtype", Unknown)]:
            dt = dtype_from(v)
            if dt is not None:
                return dt
            if isinstance(v, AbsArray):
                return v.dtype
        if any(isinstance(v, (PyStr, PyModule)) for v in args) \
                or "device" in kwargs or not (args or kwargs):
            return arr.dtype  # a device move keeps the dtype
        return None

    def _array_method(self, arr: AbsArray, name: str, args, kwargs,
                      node, arg_nodes):
        if name in ("to", "type"):
            if name == "type" and not args and "dtype" not in kwargs:
                return PyStr(None)  # x.type() is the type's name
            return AbsArray(arr.shape, self._cast_target(arr, args, kwargs),
                            weak=False)
        if name in _CAST_METHODS:
            return AbsArray(arr.shape, _CAST_METHODS[name], weak=False)
        if name in ("reshape", "view"):
            if len(args) == 1 and isinstance(args[0], PyDtype):
                return AbsArray(None, args[0].name)  # a reinterpreting view
            new = size_args(args)
            if new is None and "shape" in kwargs:
                new = shape_from(kwargs["shape"])
            return self._reshape(arr, new, node)
        if name in ("sum", "prod", "mean", "max", "min", "amax", "amin",
                    "all", "any", "argmax", "argmin", "std", "var"):
            return self._reduce(arr, name, args, kwargs)
        if name == "cumsum":
            dt = dtype_from(kwargs.get("dtype", Unknown)) \
                or _int_accum(arr.dtype)
            return AbsArray(arr.shape, dt, arr.weak)
        if name in ("flatten", "ravel"):
            if name == "flatten" and (args or kwargs):
                return AbsArray(None, arr.dtype, arr.weak)
            return AbsArray((D.numel(arr.shape),), arr.dtype, arr.weak)
        if name in ("t", "transpose", "permute"):
            return self._permute(arr, name, args)
        if name == "squeeze":
            if arr.shape is not None and not args and "dim" not in kwargs:
                return AbsArray(tuple(d for d in arr.shape if d != 1),
                                arr.dtype, arr.weak)
            return AbsArray(None, arr.dtype, arr.weak)
        if name == "unsqueeze":
            d = dim_of(self._arg_or_kw(args, kwargs, 0, "dim"))
            if arr.shape is not None and D.is_conc(d) \
                    and -len(arr.shape) - 1 <= d <= len(arr.shape):
                dims = list(arr.shape)
                dims.insert(d if d >= 0 else len(dims) + 1 + d, 1)
                return AbsArray(tuple(dims), arr.dtype, arr.weak)
            return AbsArray(None, arr.dtype, arr.weak)
        if name == "size":
            if not args and "dim" not in kwargs:
                if arr.shape is None:
                    return Unknown
                return PyTuple(tuple(PyInt(d) for d in arr.shape))
            d = dim_of(self._arg_or_kw(args, kwargs, 0, "dim"))
            if arr.shape is not None and D.is_conc(d) \
                    and -len(arr.shape) <= d < len(arr.shape):
                return PyInt(arr.shape[d])
            return PyInt(None)
        if name == "numel":
            return PyInt(D.numel(arr.shape))
        if name == "dim":
            return PyInt(arr.rank())
        if name in ("add", "sub", "mul", "bitwise_and", "bitwise_or",
                    "bitwise_xor", "bitwise_left_shift",
                    "bitwise_right_shift", "remainder", "fmod", "maximum",
                    "minimum", "div", "eq", "ne", "lt", "le", "gt", "ge"):
            if not args:
                return Unknown
            return self._arith(_FUNC_OPS[name], arr, args[0], node,
                               node.func.value, arg_nodes[0]
                               if arg_nodes else None, opdesc=name)
        if name == "matmul":
            return self._dot(arr, args[0], node, name) if args else Unknown
        if name in ("clone", "contiguous", "detach", "cuda", "cpu",
                    "clamp", "clamp_", "abs", "neg", "round", "conj",
                    "pin_memory", "requires_grad_", "share_memory_"):
            return arr
        if name in ("new_zeros", "new_ones", "new_empty", "new_full"):
            dt = dtype_from(kwargs.get("dtype", Unknown)) or arr.dtype
            return AbsArray(size_args(args[:1]), dt)
        return Unknown

    def _permute(self, arr: AbsArray, name: str, args):
        if arr.shape is None:
            return AbsArray(None, arr.dtype, arr.weak)
        dims = list(arr.shape)
        if name == "t":
            return AbsArray(tuple(reversed(dims)) if len(dims) <= 2
                            else None, arr.dtype, arr.weak)
        if name == "transpose":
            a, b = (dim_of(x) for x in (args + [Unknown, Unknown])[:2])
            n = len(dims)
            if D.is_conc(a) and D.is_conc(b) and -n <= a < n \
                    and -n <= b < n:
                dims[a], dims[b] = dims[b], dims[a]
                return AbsArray(tuple(dims), arr.dtype, arr.weak)
            return AbsArray(None, arr.dtype, arr.weak)
        perm = size_args(args)
        if perm is not None and all(D.is_conc(p) for p in perm) \
                and sorted(p % len(dims) for p in perm) \
                == list(range(len(dims))) and len(perm) == len(dims):
            return AbsArray(tuple(dims[p] for p in perm), arr.dtype,
                            arr.weak)
        return AbsArray(None, arr.dtype, arr.weak)

    def _reshape(self, arr: AbsArray, new: Optional[tuple], node):
        if new is None:
            return AbsArray(None, arr.dtype, arr.weak)
        old_n = D.numel(arr.shape)
        minus_one = sum(1 for d in new if d == -1)
        rest = [d for d in new if d != -1]
        rest_n = 1
        for d in rest:
            if not D.is_conc(d):
                rest_n = None
                break
            rest_n *= d
        if old_n is not None and rest_n is not None:
            if minus_one == 0 and old_n != rest_n:
                self.report(
                    "VL201", node,
                    f"shape mismatch: reshape of {old_n} element(s) "
                    f"{D.shape_str(arr.shape)} to {D.shape_str(new)} "
                    f"({rest_n} element(s))")
            elif minus_one == 1 and (rest_n == 0 or old_n % rest_n):
                self.report(
                    "VL201", node,
                    f"shape mismatch: reshape of {old_n} element(s) "
                    f"{D.shape_str(arr.shape)} to {D.shape_str(new)}; "
                    f"-1 cannot divide evenly")
        out = []
        for d in new:
            if d == -1:
                out.append(old_n // rest_n
                           if (old_n is not None and rest_n) else None)
            else:
                out.append(d)
        return AbsArray(tuple(out), arr.dtype, arr.weak)

    def _reduce(self, arr: AbsArray, name: str, args, kwargs):
        axis_v = kwargs.get("dim", args[0] if args else None)
        keep = isinstance(kwargs.get("keepdim"), PyBool) \
            and kwargs["keepdim"].value is True
        dt = dtype_from(kwargs.get("dtype", Unknown))
        if dt is None:
            if name in ("argmax", "argmin"):
                dt = "int64"
            elif name in ("all", "any"):
                dt = "uint8" if arr.dtype == "uint8" else (
                    "bool" if arr.dtype is not None else None)
            elif name in ("sum", "prod"):
                dt = _int_accum(arr.dtype)
            else:
                dt = arr.dtype
        if arr.shape is None:
            out = AbsArray(None, dt)
        elif axis_v is None or isinstance(axis_v, PyNoneV):
            out = AbsArray(tuple(1 for _ in arr.shape) if keep else (), dt)
        else:
            axes = []
            if isinstance(axis_v, PyTuple):
                for e in axis_v.elts:
                    d = dim_of(e)
                    if not D.is_conc(d):
                        axes = None
                        break
                    axes.append(d)
            else:
                d = dim_of(axis_v)
                axes = [d] if D.is_conc(d) else None
            if axes is None:
                out = AbsArray(None, dt)
            else:
                rank = len(arr.shape)
                norm = {a % rank for a in axes if -rank <= a < rank}
                out = AbsArray(tuple(1 if i in norm else d
                                     for i, d in enumerate(arr.shape)
                                     if keep or i not in norm), dt)
        if name in ("max", "min") and axis_v is not None \
                and not isinstance(axis_v, (PyNoneV, AbsArray)):
            # x.max(dim) -> (values, indices)
            return PyTuple((out, AbsArray(out.shape, "int64")))
        return out

    # -- builtins -----------------------------------------------------------

    def _builtin(self, name: str, args, kwargs, node):
        a0 = args[0] if args else Unknown
        if name == "len":
            if isinstance(a0, PyTuple):
                return PyInt(len(a0.elts))
            if isinstance(a0, AbsArray) and a0.shape is not None \
                    and len(a0.shape) >= 1:
                return PyInt(a0.shape[0])
            return PyInt(None)
        if name == "range":
            dims = [dim_of(a) for a in args]
            if all(D.is_conc(d) for d in dims) and 1 <= len(dims) <= 3:
                r = range(*dims)
                if 0 <= len(r) <= _MAX_LITERAL_ITER:
                    return PyTuple(tuple(PyInt(i) for i in r))
            return Unknown
        if name == "int":
            d = dim_of(a0)
            return PyInt(d)
        if name == "float":
            return PyFloat(None)
        if name == "bool":
            return PyBool(None)
        if name in ("tuple", "list"):
            return a0 if isinstance(a0, PyTuple) else Unknown
        if name in ("min", "max"):
            if len(args) >= 2 and all(isinstance(a, PyInt) for a in args):
                dims = [a.dim for a in args]
                if all(D.is_conc(d) for d in dims):
                    return PyInt(min(dims) if name == "min" else max(dims))
                return PyInt(None)
            return Unknown
        if name == "abs":
            return a0 if isinstance(a0, (PyInt, AbsArray)) else Unknown
        if name == "isinstance":
            return PyBool(None)
        if name == "str":
            return PyStr(None)
        return Unknown

    # -- external API dispatch ----------------------------------------------

    def _api_call(self, dotted: str, args, kwargs, node, arg_nodes):
        root, _, fname = dotted.rpartition(".")
        if dotted in _COMPILERS:
            fn = self._arg_or_kw(args, kwargs, 0, _COMPILERS[dotted])
            return fn if isinstance(fn, (PyFunc, PyLambda, PyPartial,
                                         PyVmapped)) else Unknown
        if dotted in ("torch.vmap", "torch.func.vmap"):
            return self._make_vmapped(args, kwargs, node)
        if dotted in ("torch.cond", "torch._higher_order_ops.cond"):
            return self._cond(args, kwargs, node)
        if dotted == "torch._higher_order_ops.while_loop":
            return self._while_loop(args, kwargs, node)
        if dotted == "torch._higher_order_ops.scan":
            return self._scan(args, kwargs, node)
        if root == "torch":
            return self._torch_call(fname, args, kwargs, node, arg_nodes)
        if dotted == "functools.partial":
            if args and isinstance(args[0], (PyFunc, PyLambda, PyModule,
                                             PyPartial)):
                return PyPartial(args[0], tuple(args[1:]), dict(kwargs))
            return Unknown
        return Unknown

    def _arg_or_kw(self, args, kwargs, i, name, default=Unknown):
        if i < len(args):
            return args[i]
        return kwargs.get(name, default)

    def _torch_call(self, fname, args, kwargs, node, arg_nodes):
        if fname in ("zeros", "ones", "empty", "rand", "randn"):
            shape = size_args(args) if args else shape_from(
                kwargs.get("size", Unknown))
            dt = dtype_from(kwargs.get("dtype", Unknown)) or "float32"
            return AbsArray(shape, dt)
        if fname == "full":
            shape = shape_from(self._arg_or_kw(args, kwargs, 0, "size"))
            fill = to_array(self._arg_or_kw(args, kwargs, 1, "fill_value"))
            dt = dtype_from(kwargs.get("dtype", Unknown)) or fill.dtype
            return AbsArray(shape, dt)
        if fname in ("zeros_like", "ones_like", "full_like", "empty_like",
                     "rand_like", "randn_like"):
            a = to_array(args[0]) if args else UNKNOWN_ARRAY
            dt = dtype_from(kwargs.get("dtype", Unknown)) or a.dtype
            return AbsArray(a.shape, dt)
        if fname == "arange":
            return self._arange(args, kwargs)
        if fname in ("tensor", "as_tensor", "asarray"):
            v = args[0] if args else kwargs.get("data", Unknown)
            dt = dtype_from(kwargs.get("dtype", Unknown))
            if isinstance(v, PyTuple):
                return _literal_array(v, dt)
            if isinstance(v, (PyInt, PyFloat, PyBool)):
                a = to_array(v)
                return AbsArray((), dt or a.dtype)
            if isinstance(v, AbsArray):
                return AbsArray(v.shape, dt or v.dtype)
            return AbsArray(None, dt)
        if fname in ("cumsum", "cumprod"):
            a = to_array(args[0]) if args else UNKNOWN_ARRAY
            dt = dtype_from(kwargs.get("dtype", Unknown)) \
                or _int_accum(a.dtype)
            return AbsArray(a.shape, dt)
        if fname in ("cat", "concat", "concatenate"):
            return self._concatenate(args, kwargs, node)
        if fname == "stack":
            return self._stack(args, kwargs, node)
        if fname == "reshape":
            a = to_array(args[0]) if args else UNKNOWN_ARRAY
            spec = self._arg_or_kw(args, kwargs, 1, "shape")
            return self._reshape(a, shape_from(spec), node)
        if fname == "broadcast_to":
            a = to_array(args[0]) if args else UNKNOWN_ARRAY
            shape = shape_from(self._arg_or_kw(args, kwargs, 1, "size"))
            if shape is not None and a.shape is not None:
                _, conflict = D.broadcast_shapes(a.shape, shape)
                if conflict is not None:
                    da, db, _ax = conflict
                    self.report(
                        "VL201", node,
                        f"shape mismatch: broadcast_to "
                        f"{D.shape_str(a.shape)} -> {D.shape_str(shape)} "
                        f"conflicts on dim {da} vs {db}")
            return AbsArray(shape, a.dtype, a.weak)
        if fname == "where":
            if len(args) < 3:
                return Unknown
            # x/y promote like an elementwise op; the condition only
            # broadcasts (it never participates in dtype promotion)
            out = self._arith("add", args[1], args[2], node,
                              arg_nodes[1], arg_nodes[2], opdesc="where")
            cond = to_array(args[0])
            oa = to_array(out)
            shape, conflict = D.broadcast_shapes(cond.shape, oa.shape)
            if conflict is not None:
                da, db, ax = conflict
                self.report(
                    "VL201", node,
                    f"shape mismatch: where condition "
                    f"{D.shape_str(cond.shape)} vs operands "
                    f"{D.shape_str(oa.shape)} conflict on dim {da} vs "
                    f"{db} (axis -{ax + 1}); these can never broadcast")
            if isinstance(out, AbsArray):
                return AbsArray(shape, out.dtype, out.weak)
            return out
        if fname in _FUNC_OPS:
            if len(args) < 2:
                return Unknown
            return self._arith(_FUNC_OPS[fname], args[0], args[1], node,
                               arg_nodes[0], arg_nodes[1], opdesc=fname)
        if fname in ("matmul", "mm", "bmm", "dot"):
            if len(args) < 2:
                return Unknown
            return self._dot(args[0], args[1], node, fname)
        if fname in ("sum", "prod", "mean", "max", "min", "amax", "amin",
                     "all", "any", "argmax", "argmin"):
            a = to_array(args[0]) if args else UNKNOWN_ARRAY
            return self._reduce(a, fname, args[1:], kwargs)
        if fname in ("clamp", "abs", "neg", "clone", "flip", "roll"):
            return to_array(args[0]) if args else Unknown
        if fname == "nonzero":
            a = to_array(args[0]) if args else UNKNOWN_ARRAY
            rank = a.rank()
            return AbsArray((None, rank), "int64")
        if fname == "searchsorted":
            v = to_array(args[1]) if len(args) > 1 else UNKNOWN_ARRAY
            return AbsArray(v.shape, "int64")
        if fname == "sort":
            a = to_array(args[0]) if args else UNKNOWN_ARRAY
            return PyTuple((a, AbsArray(a.shape, "int64")))
        if fname == "argsort":
            a = to_array(args[0]) if args else UNKNOWN_ARRAY
            return AbsArray(a.shape, "int64")
        if fname == "gather":
            a = to_array(args[0]) if args else UNKNOWN_ARRAY
            idx = to_array(self._arg_or_kw(args, kwargs, 2, "index"))
            return AbsArray(idx.shape, a.dtype)
        if fname in ("transpose", "permute", "t"):
            a = to_array(args[0]) if args else UNKNOWN_ARRAY
            return self._permute(a, fname, list(args[1:]))
        if fname in ("flatten", "ravel"):
            a = to_array(args[0]) if args else UNKNOWN_ARRAY
            if len(args) > 1 or kwargs:
                return AbsArray(None, a.dtype, a.weak)
            return AbsArray((D.numel(a.shape),), a.dtype, a.weak)
        if fname == "squeeze":
            a = to_array(args[0]) if args else UNKNOWN_ARRAY
            return self._array_method(a, "squeeze", list(args[1:]), kwargs,
                                      node, arg_nodes[1:])
        if fname == "unsqueeze":
            a = to_array(args[0]) if args else UNKNOWN_ARRAY
            return self._array_method(a, "unsqueeze", list(args[1:]),
                                      kwargs, node, arg_nodes[1:])
        return Unknown

    def _arange(self, args, kwargs):
        dims = [dim_of(a) for a in args[:3]]
        dt = dtype_from(kwargs.get("dtype", Unknown))
        if dt is None:
            dt = "float32" if any(isinstance(a, PyFloat)
                                  for a in args[:3]) else "int64"
        if len(dims) == 1:
            return AbsArray((dims[0],), dt)
        if len(dims) >= 2:
            start, stop = dims[0], dims[1]
            step = dims[2] if len(dims) > 2 else 1
            if all(D.is_conc(x) for x in (start, stop, step)) and step:
                return AbsArray((len(range(start, stop, step)),), dt)
            if step == 1:
                return AbsArray((D.dim_binop("sub", stop, start),), dt)
            return AbsArray((None,), dt)
        return AbsArray((None,), dt)

    def _concatenate(self, args, kwargs, node):
        seq = args[0] if args else kwargs.get("tensors", Unknown)
        axis = dim_of(self._arg_or_kw(args, kwargs, 1, "dim", PyInt(0)))
        if not isinstance(seq, PyTuple):
            return Unknown
        arrs = [to_array(e) for e in seq.elts]
        dts = {a.dtype for a in arrs if a.dtype is not None}
        dt = dts.pop() if len(dts) == 1 else None
        shapes = [a.shape for a in arrs]
        if any(s is None for s in shapes) or not shapes \
                or not D.is_conc(axis):
            return AbsArray(None, dt)
        rank = len(shapes[0])
        if any(len(s) != rank for s in shapes) \
                or not (-rank <= axis < rank):
            return AbsArray(None, dt)
        ax = axis % rank
        for i in range(rank):
            if i == ax:
                continue
            dims = [s[i] for s in shapes]
            conc = [d for d in dims if D.is_conc(d)]
            if len(set(conc)) > 1:
                self.report(
                    "VL201", node,
                    f"shape mismatch: cat along dim {ax} "
                    f"requires equal non-axis dims, got "
                    f"{' vs '.join(D.shape_str(s) for s in shapes)}")
                return AbsArray(None, dt)
        total = 0
        for s in shapes:
            total = D.dim_binop("add", total, s[ax])
        out = list(shapes[0])
        out[ax] = total
        return AbsArray(tuple(out), dt)

    def _stack(self, args, kwargs, node):
        seq = args[0] if args else kwargs.get("tensors", Unknown)
        axis = dim_of(self._arg_or_kw(args, kwargs, 1, "dim", PyInt(0)))
        if not isinstance(seq, PyTuple):
            return Unknown
        arrs = [to_array(e) for e in seq.elts]
        dts = {a.dtype for a in arrs if a.dtype is not None}
        dt = dts.pop() if len(dts) == 1 else None
        shapes = [a.shape for a in arrs]
        if any(s is None for s in shapes) or not shapes:
            return AbsArray(None, dt)
        first = shapes[0]
        for s in shapes[1:]:
            if len(s) != len(first):
                return AbsArray(None, dt)
            for da, db in zip(first, s):
                if D.is_conc(da) and D.is_conc(db) and da != db:
                    self.report(
                        "VL201", node,
                        f"shape mismatch: stack requires equal shapes, "
                        f"got {D.shape_str(first)} vs {D.shape_str(s)}")
                    return AbsArray(None, dt)
        if not D.is_conc(axis) or not (-len(first) - 1 <= axis
                                       <= len(first)):
            return AbsArray(None, dt)
        out = list(first)
        out.insert(axis if axis >= 0 else len(first) + 1 + axis,
                   len(arrs))
        return AbsArray(tuple(out), dt)

    # -- control flow: cond / while_loop / scan ------------------------------

    def _compare_carry(self, init, out, node, where):
        """VL203 core: the carry out of a loop body must structurally
        match its init — tuple arity, dtype, rank, and concrete dims.
        Unknown on either side keeps quiet."""
        if isinstance(init, PyTuple) and isinstance(out, PyTuple):
            if len(init.elts) != len(out.elts):
                self.report(
                    "VL203", node,
                    f"{where} carry arity changed: init has "
                    f"{len(init.elts)} element(s), body returns "
                    f"{len(out.elts)}")
                return
            for i, (a, b) in enumerate(zip(init.elts, out.elts)):
                self._compare_carry(a, b, node,
                                    f"{where} carry[{i}]")
            return
        if isinstance(init, PyTuple) or isinstance(out, PyTuple):
            return  # mixed tuple/array: structure not tracked — silent
        ia, oa = to_array(init), to_array(out)
        if ia is UNKNOWN_ARRAY and init is Unknown:
            return
        if oa is UNKNOWN_ARRAY and out is Unknown:
            return
        if ia.dtype is not None and oa.dtype is not None \
                and ia.dtype != oa.dtype and not (ia.weak or oa.weak):
            self.report(
                "VL203", node,
                f"{where} dtype drifts from init {ia.dtype} to "
                f"{oa.dtype}; every step retraces (or the carry NaNs) — "
                f"cast the body result back to the init dtype")
            return
        if ia.shape is not None and oa.shape is not None:
            if len(ia.shape) != len(oa.shape):
                self.report(
                    "VL203", node,
                    f"{where} rank drifts from init "
                    f"{D.shape_str(ia.shape)} to {D.shape_str(oa.shape)}")
                return
            for da, db in zip(ia.shape, oa.shape):
                if D.is_conc(da) and D.is_conc(db) and da != db:
                    self.report(
                        "VL203", node,
                        f"{where} shape drifts from init "
                        f"{D.shape_str(ia.shape)} to "
                        f"{D.shape_str(oa.shape)}")
                    return

    def _scan(self, args, kwargs, node):
        """``scan(combine_fn, init, xs, dim=0)``: ``combine_fn(carry,
        x) -> (carry, y)`` with ``x`` a slice of ``xs`` along ``dim``."""
        f = self._arg_or_kw(args, kwargs, 0, "combine_fn")
        init = self._arg_or_kw(args, kwargs, 1, "init")
        xs = self._arg_or_kw(args, kwargs, 2, "xs")
        dim = dim_of(kwargs.get("dim", PyInt(0)))
        elt = Unknown
        if isinstance(xs, PyTuple):
            elt = PyTuple(tuple(_drop_dim(e, dim) for e in xs.elts))
        elif isinstance(xs, AbsArray):
            elt = _drop_dim(xs, dim)
        ret = self._call_loop_body(f, [init, elt], node)
        carry_out = Unknown
        if isinstance(ret, PyTuple) and len(ret.elts) == 2:
            carry_out = ret.elts[0]
        elif ret is not Unknown and not isinstance(ret, PyTuple):
            carry_out = ret  # malformed body; compare what we have
        self._compare_carry(init, carry_out, node, "scan")
        return PyTuple((join_value(init, carry_out), Unknown))

    def _while_loop(self, args, kwargs, node):
        """``while_loop(cond_fn, body_fn, carried_inputs)``: the body
        takes the carried tuple unpacked and returns the next one."""
        f = self._arg_or_kw(args, kwargs, 1, "body_fn")
        init = self._arg_or_kw(args, kwargs, 2, "carried_inputs")
        if not isinstance(init, PyTuple):
            return Unknown
        ret = self._call_loop_body(f, list(init.elts), node)
        self._compare_carry(init, ret, node, "while_loop")
        return join_value(init, ret)

    def _call_loop_body(self, f, args, node):
        if isinstance(f, (PyFunc, PyLambda, PyPartial)):
            return self.invoke(f, args, {}, node)
        return Unknown

    def _cond(self, args, kwargs, node):
        """``torch.cond(pred, true_fn, false_fn, operands)``."""
        t_fn = self._arg_or_kw(args, kwargs, 1, "true_fn")
        f_fn = self._arg_or_kw(args, kwargs, 2, "false_fn")
        ops = self._arg_or_kw(args, kwargs, 3, "operands", PyTuple(()))
        if not isinstance(ops, PyTuple):
            return Unknown
        operands = list(ops.elts)
        t = self.invoke(t_fn, operands, {}, node) \
            if isinstance(t_fn, (PyFunc, PyLambda, PyPartial)) else Unknown
        fv = self.invoke(f_fn, operands, {}, node) \
            if isinstance(f_fn, (PyFunc, PyLambda, PyPartial)) else Unknown
        return join_value(t, fv)

    # -- vmap ---------------------------------------------------------------

    def _make_vmapped(self, args, kwargs, node):
        fn = self._arg_or_kw(args, kwargs, 0, "func")
        if not isinstance(fn, (PyFunc, PyLambda, PyPartial)):
            return Unknown
        in_axes = self._arg_or_kw(args, kwargs, 1, "in_dims", PyInt(0))
        out_axes = self._arg_or_kw(args, kwargs, 2, "out_dims", PyInt(0))
        vm = PyVmapped(fn, in_axes, out_axes, node)
        self._check_vmap_arity(vm, node)
        return vm

    def _vmap_target_params(self, fn):
        """(min_args, max_args, fi) for a vmapped callee, or None when
        the signature isn't statically known (lambdas count, *args
        doesn't)."""
        offset = 0
        while isinstance(fn, PyPartial):
            offset += len(fn.args)
            fn = fn.fn
        if isinstance(fn, PyLambda):
            a = fn.node.args
            if a.vararg is not None:
                return None
            total = len(a.args)
            lo = total - len(a.defaults)
            return (max(0, lo - offset), max(0, total - offset), None)
        if isinstance(fn, PyFunc):
            fi = self.interp.index.functions.get(fn.qual)
            if fi is None:
                return None
            a = fi.node.args
            if a.vararg is not None:
                return None
            params = list(fi.params)
            if params and fi.cls is not None and params[0] in ("self",
                                                               "cls"):
                params = params[1:]
            total = len(params)
            lo = total - len(a.defaults)
            return (max(0, lo - offset), max(0, total - offset), fi)
        return None

    def _check_vmap_arity(self, vm, node):
        sig = self._vmap_target_params(vm.fn)
        if sig is None:
            return
        lo, hi, _fi = sig
        ax = vm.in_axes
        if isinstance(ax, PyTuple):
            n = len(ax.elts)
            if n < lo or n > hi:
                want = str(lo) if lo == hi else f"{lo}..{hi}"
                self.report(
                    "VL204", node,
                    f"vmap in_dims has {n} entr"
                    f"{'y' if n == 1 else 'ies'} but the mapped "
                    f"function takes {want} argument"
                    f"{'' if hi == 1 else 's'}")

    def _call_vmapped(self, vm, args, kwargs, node):
        sig = self._vmap_target_params(vm.fn)
        axes = None
        if isinstance(vm.in_axes, PyTuple):
            axes = [dim_of(e) if not isinstance(e, PyNoneV) else "none"
                    for e in vm.in_axes.elts]
        elif isinstance(vm.in_axes, PyInt):
            axes = [vm.in_axes.dim] * len(args)
        elif isinstance(vm.in_axes, PyNoneV):
            axes = ["none"] * len(args)
        if axes is not None and len(axes) < len(args):
            axes = axes + [None] * (len(args) - len(axes))
        inner_args = []
        mapped_dim = None
        for i, v in enumerate(args):
            ax = axes[i] if axes is not None else None
            if ax == "none" or ax is None and axes is None:
                inner_args.append(v)
                continue
            a = to_array(v)
            if ax is None or not D.is_conc(ax):
                inner_args.append(AbsArray(None, a.dtype, a.weak)
                                  if a is not UNKNOWN_ARRAY or
                                  isinstance(v, AbsArray) else Unknown)
                continue
            if isinstance(v, AbsArray) and v.shape is not None:
                rank = len(v.shape)
                if not (-rank <= ax < rank):
                    self.report(
                        "VL204", node,
                        f"vmap maps axis {ax} of argument {i} but the "
                        f"operand has shape {D.shape_str(v.shape)} "
                        f"(rank {rank})")
                    inner_args.append(UNKNOWN_ARRAY)
                    continue
                dims = list(v.shape)
                d = dims.pop(ax % rank)
                if mapped_dim is None:
                    mapped_dim = d
                elif D.is_conc(mapped_dim) and D.is_conc(d) \
                        and mapped_dim != d:
                    self.report(
                        "VL204", node,
                        f"vmap mapped axes disagree: argument {i} maps "
                        f"a dim of {d} but an earlier argument maps "
                        f"{mapped_dim}")
                    mapped_dim = None
                inner_args.append(AbsArray(tuple(dims), v.dtype, v.weak))
            else:
                inner_args.append(UNKNOWN_ARRAY if isinstance(v, AbsArray)
                                  else Unknown)
        ret = self.invoke(vm.fn, inner_args, dict(kwargs), node)
        out_axes = vm.out_axes
        if isinstance(out_axes, PyTuple) and isinstance(ret, PyTuple) \
                and len(out_axes.elts) != len(ret.elts):
            self.report(
                "VL204", node,
                f"vmap out_dims has {len(out_axes.elts)} entries but "
                f"the mapped function returns {len(ret.elts)} value(s)")
        def lift(v, ax):
            if isinstance(ax, PyNoneV):
                return v
            a = to_array(v)
            axd = dim_of(ax)
            if isinstance(v, AbsArray) and v.shape is not None \
                    and D.is_conc(axd) \
                    and 0 <= axd <= len(v.shape):
                dims = list(v.shape)
                dims.insert(axd, mapped_dim)
                return AbsArray(tuple(dims), v.dtype, v.weak)
            return AbsArray(None, a.dtype, a.weak) \
                if isinstance(v, AbsArray) else Unknown
        if isinstance(ret, PyTuple):
            if isinstance(out_axes, PyTuple) \
                    and len(out_axes.elts) == len(ret.elts):
                return PyTuple(tuple(lift(v, a) for v, a
                                     in zip(ret.elts, out_axes.elts)))
            return PyTuple(tuple(lift(v, out_axes) for v in ret.elts))
        return lift(ret, out_axes)


# -- iteration / env joins --------------------------------------------------

def _loop_elt(v):
    """Per-iteration element of an abstract iterable."""
    if isinstance(v, PyTuple):
        out = None
        for e in v.elts:
            out = e if out is None else join_value(out, e)
        return Unknown if out is None else out
    if isinstance(v, AbsArray):
        if v.shape is not None and len(v.shape) >= 1:
            return AbsArray(v.shape[1:], v.dtype, v.weak)
        return AbsArray(None, v.dtype, v.weak)
    return Unknown


def _join_env(a: dict, b: dict) -> dict:
    """Join two environments: a name bound in both joins pointwise; a
    name bound on only one path keeps that binding (reading it on the
    other path would have raised, which concrete execution surfaces)."""
    out = dict(a)
    for k, vb in b.items():
        if k in a:
            out[k] = join_value(a[k], vb)
        else:
            out[k] = vb
    return out


_BUILTINS = frozenset({
    "len", "range", "int", "float", "bool", "tuple", "list", "min",
    "max", "abs", "isinstance", "str", "sum", "enumerate", "zip",
    "sorted", "reversed", "any", "all", "repr", "divmod", "print",
})


# -- VL205: mesh axis names -------------------------------------------------

#: where a torch.distributed DeviceMesh takes its dimension names
_DEVICE_MESH_CALLS = ("torch.distributed.device_mesh.init_device_mesh",
                      "torch.distributed.device_mesh.DeviceMesh",
                      "torch.distributed.init_device_mesh",
                      "torch.distributed.DeviceMesh")

#: parameter names of the mesh module's functions that take axis names
_AXIS_PARAMS = ("axis", "axis_name", "axis_names", "mesh_dim_names")


def _is_mesh_module(relpath: str) -> bool:
    return relpath.replace("\\", "/").endswith("parallel/mesh.py")


def _expand(node, aliases) -> Optional[str]:
    chain = attr_chain(node)
    if not chain:
        return None
    return ".".join([aliases.get(chain[0], chain[0])] + chain[1:])


class _ModNames:
    """Per-module name facts for the VL205 pass: which local names are
    bound to a DeviceMesh, and an unambiguous local-name ->
    string-constant map."""

    def __init__(self, mod):
        self.mod = mod
        self.device_meshes: set = set()  # local names bound to one
        self.consts: dict = {}       # local name -> str (unambiguous)
        ambiguous: set = set()
        for node in ast.walk(mod.ctx.tree):
            if isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tgt = node.targets[0].id
                if isinstance(node.value, ast.Constant) \
                        and isinstance(node.value.value, str):
                    if tgt in self.consts and self.consts[tgt] \
                            != node.value.value:
                        ambiguous.add(tgt)
                    else:
                        self.consts[tgt] = node.value.value
                elif isinstance(node.value, ast.Call) and _expand(
                        node.value.func, mod.aliases) in _DEVICE_MESH_CALLS:
                    self.device_meshes.add(tgt)
        for tgt in ambiguous:
            self.consts.pop(tgt, None)

    def imports_mesh(self, index) -> bool:
        """Whether this module names anything of a ``parallel/mesh.py``
        module (the mesh API's callers)."""
        for target in self.mod.aliases.values():
            parts = target.split(".")
            for cut in range(len(parts), 0, -1):
                m = index.modules.get(".".join(parts[:cut]))
                if m is not None:
                    if _is_mesh_module(m.relpath):
                        return True
                    break
        return False


def _mesh_api(index: ProjectIndex) -> dict:
    """name -> (position, keyword) of the axis argument for every function
    and method of a ``parallel/mesh.py`` module with a parameter named
    like an axis (``axis``, ``axis_names``, ...); positions skip
    ``self``, and a class's ``__init__`` registers under the class
    name (``Mesh(devices, axis_names)``)."""
    api: dict = {}
    for fi in index.functions.values():
        if not _is_mesh_module(fi.relpath):
            continue
        params = list(fi.params)
        if fi.cls is not None and params and params[0] in ("self", "cls"):
            params = params[1:]
        name = fi.node.name
        if name == "__init__" and fi.cls is not None:
            name = fi.cls.rsplit(".", 1)[-1]
        spec = next(((i, p) for i, p in enumerate(params)
                     if p in _AXIS_PARAMS), None) or next(
            ((None, p) for p in fi.kwonly if p in _AXIS_PARAMS), None)
        if spec is not None:
            api[name] = spec
    return api


def _collect_declared_axes(index: ProjectIndex, names_of) -> set:
    """Axis names declared in ``parallel/mesh.py`` modules: module-level
    ``*_AXIS = "..."`` constants plus the axis names given to the mesh
    constructors (``Mesh``/``build_mesh``, a DeviceMesh) there."""
    axes: set = set()
    found_mesh_module = False
    api = _mesh_api(index)
    for mod in index.modules.values():
        if not _is_mesh_module(mod.relpath):
            continue
        found_mesh_module = True
        mn = names_of(mod)
        for stmt in mod.ctx.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id.endswith("_AXIS") \
                    and isinstance(stmt.value, ast.Constant) \
                    and isinstance(stmt.value.value, str):
                axes.add(stmt.value.value)
        for node in ast.walk(mod.ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            declares, exprs = _axis_args(node, mn, api)
            for expr in exprs if declares else ():
                for ax, _ in _axis_operands(expr, mn, index, names_of):
                    if ax is not None:
                        axes.add(ax)
    return axes if found_mesh_module else None


def _resolve_axis_str(node, mn, index, names_of):
    """Resolve an axis-name expression to a string, or None."""
    if isinstance(node, ast.Constant):
        return node.value if isinstance(node.value, str) else None
    if isinstance(node, ast.Name):
        target = mn.mod.aliases.get(node.id)
        if target is not None:
            return _dotted_const(target, index, names_of)
        return mn.consts.get(node.id)
    if isinstance(node, ast.Attribute):
        chain = attr_chain(node)
        if chain and chain[0] in mn.mod.aliases:
            dotted = ".".join([mn.mod.aliases[chain[0]]] + chain[1:])
            return _dotted_const(dotted, index, names_of)
    return None


def _dotted_const(dotted: str, index, names_of):
    """``pkg.mod.NAME`` -> the string NAME is bound to in pkg.mod."""
    parts = dotted.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        mod = index.modules.get(".".join(parts[:cut]))
        if mod is not None:
            rest = parts[cut:]
            if len(rest) == 1:
                return names_of(mod).consts.get(rest[0])
            return None
    return None


def _axis_operands(node, mn, index, names_of):
    """Flatten an axis argument (string / name / tuple of those) to a
    list of (resolved_or_None, expr_node)."""
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            out.extend(_axis_operands(e, mn, index, names_of))
        return out
    if isinstance(node, ast.Constant) and node.value is None:
        return []
    return [(_resolve_axis_str(node, mn, index, names_of), node)]


def _call_name(call) -> Optional[str]:
    fn = call.func
    return fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else None)


def _axis_args(call, mn, api) -> tuple:
    """(declares, exprs): the axis-name argument expressions of ``call``
    — a DeviceMesh's ``mesh_dim_names``, or the axis argument of a
    mesh-module function — and whether the call declares names (a mesh
    built over them) rather than uses them."""
    if _expand(call.func, mn.mod.aliases) in _DEVICE_MESH_CALLS:
        return True, [kw.value for kw in call.keywords
                      if kw.arg == "mesh_dim_names"]
    spec = api.get(_call_name(call))
    if spec is None:
        return False, []
    pos, kwname = spec
    out = [call.args[pos]] if pos is not None and len(call.args) > pos \
        else []
    out += [kw.value for kw in call.keywords if kw.arg == kwname]
    return kwname in ("axis_names", "mesh_dim_names"), out


def check_mesh_axes(index: ProjectIndex):
    """VL205 — every axis name given to the mesh API (``Mesh`` /
    ``build_mesh`` axis names outside the mesh module, the ``axis``
    arguments of the mesh module's functions and methods, in modules
    that import the mesh module) or to a torch.distributed DeviceMesh
    (``mesh_dim_names``, ``mesh["..."]``) must be an axis declared in
    ``parallel/mesh.py``. Silent when the project has no mesh module
    or a name doesn't resolve to a string."""
    cache: dict = {}

    def names_of(mod):
        got = cache.get(mod.name)
        if got is None:
            got = _ModNames(mod)
            cache[mod.name] = got
        return got

    declared = _collect_declared_axes(index, names_of)
    findings: list = []
    if not declared:
        return findings
    api = _mesh_api(index)

    def flag(mod, expr, ax, what):
        findings.append(finding_at(
            mod.relpath, expr, "VL205",
            f"unknown mesh axis '{ax}' in {what}; declared axes are "
            f"{sorted(declared)} (parallel/mesh.py)",
            severity=_SEVERITY["VL205"]))

    for mod in index.modules.values():
        mn = names_of(mod)
        in_mesh_mod = _is_mesh_module(mod.relpath)
        uses_api = in_mesh_mod or mn.imports_mesh(index)
        for node in ast.walk(mod.ctx.tree):
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in mn.device_meshes:
                for ax, expr in _axis_operands(node.slice, mn, index,
                                               names_of):
                    if ax is not None and ax not in declared:
                        flag(mod, expr, ax, "DeviceMesh[...]")
                continue
            if not isinstance(node, ast.Call):
                continue
            nm = _call_name(node)
            device_mesh = _expand(node.func, mod.aliases) \
                in _DEVICE_MESH_CALLS
            if not device_mesh and (nm not in api or not uses_api):
                continue
            declares, exprs = _axis_args(node, mn, api)
            if declares and in_mesh_mod:
                continue  # where the names are declared
            what = "DeviceMesh mesh_dim_names" if device_mesh else (
                f"{nm} axis_names" if declares else nm)
            for e in exprs:
                for ax, expr in _axis_operands(e, mn, index, names_of):
                    if ax is not None and ax not in declared:
                        flag(mod, expr, ax, what)
    return findings


# -- rule classes -----------------------------------------------------------

_SHAPE_RESULTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _interp_for(index: ProjectIndex) -> "Interp":
    """Run the abstract interpreter once per ProjectIndex; the five
    VL2xx rules (and the cache's summary snapshot) share the result."""
    got = _SHAPE_RESULTS.get(index)
    if got is None:
        got = Interp(index)
        got.run()
        _SHAPE_RESULTS[index] = got
    return got


def _analysis_for(index: ProjectIndex) -> list:
    return _interp_for(index).found


def summaries_for(index: ProjectIndex) -> dict:
    """{relpath: {qualname: rendered return summary}} — what the
    incremental cache stores per file."""
    return _interp_for(index).summaries


class _ShapeRule:
    def check_project(self, index: ProjectIndex):
        for f in _analysis_for(index):
            if f.code == self.code:
                yield f


class ShapeMismatchRule(_ShapeRule):
    """VL201 — statically incompatible operand shapes."""

    code = "VL201"
    name = "shape-mismatch"
    severity = "error"
    description = ("elementwise/matmul/reshape/cat operands with "
                   "statically incompatible shapes (concrete dims that "
                   "can never broadcast or contract)")


class DtypePromotionRule(_ShapeRule):
    """VL202 — implicit unsigned promotion in hash arithmetic."""

    code = "VL202"
    name = "implicit-dtype-promotion"
    severity = "warning"
    description = ("implicit dtype promotion crossing a width or "
                   "signedness boundary (or one torch refuses) on uint "
                   "hash state in ops/ kernels without an explicit "
                   ".to/dtype=")


class CarryDriftRule(_ShapeRule):
    """VL203 — while_loop/scan carry drifts from its init."""

    code = "VL203"
    name = "carry-drift"
    severity = "error"
    description = ("while_loop/scan body returns a carry "
                   "whose shape or dtype differs from the init (retrace "
                   "storm / NaN trap)")


class VmapAxesRule(_ShapeRule):
    """VL204 — vmap in_dims/out_dims inconsistent with the callee."""

    code = "VL204"
    name = "vmap-axes"
    severity = "error"
    description = ("vmap in_dims/out_dims arity disagrees with the "
                   "mapped function's signature, or a mapped axis is "
                   "out of range / inconsistent across operands")


class MeshAxisRule(_ShapeRule):
    """VL205 — undeclared mesh axis name."""

    code = "VL205"
    name = "mesh-axis"
    severity = "error"
    description = ("mesh API / DeviceMesh axis name not declared in "
                   "parallel/mesh.py")


def default_shape_rules() -> list:
    return [ShapeMismatchRule(), DtypePromotionRule(), CarryDriftRule(),
            VmapAxesRule(), MeshAxisRule()]
