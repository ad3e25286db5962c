"""Abstract domain for the shape/dtype interpreter (analysis/shapes.py).

Ports ``volsync_tpu/analysis/absdomain.py``. Dims, ``broadcast_shapes``,
the ``join_*`` helpers and ``AbsArray`` are the reference's; the dtype
half follows torch's promotion lattice instead of JAX's.

The lattice is deliberately three-valued everywhere: a property is
either *known* (a concrete Python value), *symbolic* (a structural
token derived from an unknown quantity, so two occurrences of the same
expression compare equal), or *Unknown* (``None`` — no information).
Every rule built on top of this domain only fires on the *known*
tier: an Unknown or merely-symbolic disagreement can suppress a
finding but can never create one — the same false-negatives-only
bargain the per-file rules and the call-graph resolver make.

Dims
----
A dimension is ``int`` (concrete), a structural tuple like
``("add", ("sym", 3), 1)`` (symbolic — interned by construction so
``n + 1`` from two sites compares equal), or ``None`` (unknown).

Dtypes
------
Dtypes are canonical strings (``"uint32"``, ``"float32"``, ``"bool"``)
plus a *weak* flag for a Python scalar operand. ``promote`` is
``torch.result_type``'s rule: operands fall in three tiers (dimensioned
tensors, zero-dim tensors, Python scalars); each tier folds with
``torch.promote_types`` and a lower tier changes the result only when
its category (bool < integer < floating < complex) is higher — so
``uint32_tensor + 1`` stays ``uint32`` and ``int32_tensor + 0.5`` is
the default float, ``float32``. Where ``torch.promote_types`` raises —
uint16, uint32 or uint64 against any other dtype but a floating one —
the result is ``UNSUPPORTED``: the op raises at run time.

``UINT32_CPU_REFUSED`` lists the ops torch 2.13 refuses on uint32
tensors on the CPU (``NotImplementedError``); ``uint32_op_calls`` builds
each probed op on two tensors, so the tests hold the table against the
live torch on the CPU and ``chip_smoke.py`` logs it on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

# -- dimensions -------------------------------------------------------------

# Dim = int | structural tuple | None (unknown)


def is_conc(d) -> bool:
    """Concrete dimension (a real int; bool is a Python int subtype
    and must not slip through)."""
    return isinstance(d, int) and not isinstance(d, bool)


def sym(token) -> tuple:
    """Opaque symbolic dim from a hashable token (the interpreter
    uses per-run counters / qualnames, so runs stay deterministic)."""
    return ("sym", token)


def dim_binop(op: str, a, b):
    """Structural arithmetic on dims. Concrete operands fold; anything
    touching Unknown stays Unknown; otherwise the expression tree is
    the value, so equal expressions compare equal."""
    if a is None or b is None:
        return None
    if is_conc(a) and is_conc(b):
        try:
            if op == "add":
                return a + b
            if op == "sub":
                return a - b
            if op == "mul":
                return a * b
            if op == "floordiv":
                return a // b
            if op == "mod":
                return a % b
        except (ZeroDivisionError, OverflowError):
            return None
        return None
    # tiny normalizations keep common slice arithmetic comparable
    if op == "add" and b == 0:
        return a
    if op in ("add", "mul") and a == 0 and op == "add":
        return b
    if op == "sub" and b == 0:
        return a
    if op == "mul" and (a == 1 or b == 1):
        return b if a == 1 else a
    return (op, a, b)


def join_dim(a, b):
    return a if a == b else None


# -- dtypes -----------------------------------------------------------------

#: torch's dtype names (``torch.<name>``) and their aliases, canonical
_CANON = {
    "bool": "bool",
    "uint8": "uint8", "uint16": "uint16",
    "uint32": "uint32", "uint64": "uint64",
    "int8": "int8", "int16": "int16",
    "int32": "int32", "int64": "int64",
    "float16": "float16", "bfloat16": "bfloat16",
    "float32": "float32", "float64": "float64",
    "complex32": "complex32", "complex64": "complex64",
    "complex128": "complex128",
    "half": "float16", "float": "float32", "double": "float64",
    "short": "int16", "int": "int32", "long": "int64",
    "chalf": "complex32", "cfloat": "complex64", "cdouble": "complex128",
}

#: every canonical dtype the lattice names
DTYPES = ("bool", "uint8", "uint16", "uint32", "uint64", "int8", "int16",
          "int32", "int64", "float16", "bfloat16", "float32", "float64",
          "complex32", "complex64", "complex128")

#: the result of a promotion torch refuses (it raises at run time)
UNSUPPORTED = "unsupported"

KIND_BOOL, KIND_UINT, KIND_INT, KIND_FLOAT, KIND_COMPLEX = range(5)

#: torch's "barebones" unsigned dtypes: promotable only to themselves
#: and to a floating dtype
_BAREBONES = ("uint16", "uint32", "uint64")

#: a Python scalar's dtype in torch's wrapped-number tier (a float takes
#: the default dtype, a complex the default complex)
SCALAR_DTYPE = {"bool": "bool", "int": "int64", "float": "float32",
                "complex": "complex64"}


def canon_dtype(name: str) -> Optional[str]:
    """Canonical dtype string or None for anything exotic (quantized
    and float8 dtypes stay Unknown on purpose)."""
    return _CANON.get(name)


def kind(dtype: str) -> int:
    if dtype == "bool":
        return KIND_BOOL
    if dtype.startswith("uint"):
        return KIND_UINT
    if dtype.startswith("int"):
        return KIND_INT
    if dtype.startswith("float") or dtype == "bfloat16":
        return KIND_FLOAT
    return KIND_COMPLEX


def width(dtype: str) -> int:
    digits = "".join(c for c in dtype if c.isdigit())
    return int(digits) if digits else 8  # bool


def is_uint(dtype: Optional[str]) -> bool:
    return bool(dtype) and dtype.startswith("uint")


def _is_float(dtype: str) -> bool:
    return kind(dtype) == KIND_FLOAT


def _is_complex(dtype: str) -> bool:
    return kind(dtype) == KIND_COMPLEX


def _to_complex(dtype: str) -> str:
    return {"float16": "complex32", "bfloat16": "complex64",
            "float32": "complex64", "float64": "complex128"}[dtype]


def promote_types(a: str, b: str) -> str:
    """``torch.promote_types`` on canonical names; ``UNSUPPORTED`` where
    torch raises."""
    if a == b:
        return a
    if a in _BAREBONES or b in _BAREBONES:
        if _is_float(a):
            return a
        if _is_float(b):
            return b
        return UNSUPPORTED
    ka, kb = kind(a), kind(b)
    if ka == KIND_BOOL:
        return b
    if kb == KIND_BOOL:
        return a
    if KIND_COMPLEX in (ka, kb):
        # the complex type wide enough for both parts
        part = {"complex32": 16, "complex64": 32, "complex128": 64}
        wa = part[a] if ka == KIND_COMPLEX else (
            32 if a == "bfloat16" else width(a) if ka == KIND_FLOAT else 0)
        wb = part[b] if kb == KIND_COMPLEX else (
            32 if b == "bfloat16" else width(b) if kb == KIND_FLOAT else 0)
        w = max(wa, wb)
        if w <= 16:
            return "complex32"
        return "complex64" if w <= 32 else "complex128"
    if ka == KIND_FLOAT and kb == KIND_FLOAT:
        if width(a) == width(b):  # float16 vs bfloat16
            return "float32"
        return a if width(a) > width(b) else b
    if ka == KIND_FLOAT:
        return a
    if kb == KIND_FLOAT:
        return b
    if ka == kb:
        return a if width(a) >= width(b) else b
    # uint8 against a signed integer: the signed side when wider, else
    # the next wider signed integer
    ud, sd = (a, b) if ka == KIND_UINT else (b, a)
    if width(sd) > width(ud):
        return sd
    return f"int{width(ud) * 2}"


def _fold(acc: Optional[str], d: str) -> Optional[str]:
    if acc is None:
        return d
    if UNSUPPORTED in (acc, d):
        return UNSUPPORTED
    return promote_types(acc, d)


def _combine(higher: Optional[str], lower: Optional[str]) -> Optional[str]:
    """c10's ``combine_categories``: the higher tier's dtype unless the
    lower tier's category is higher."""
    if UNSUPPORTED in (higher, lower):
        return UNSUPPORTED
    if higher is not None and _is_complex(higher):
        return higher
    if lower is not None and _is_complex(lower):
        if higher is not None and _is_float(higher):
            return _to_complex(higher)
        return lower
    if higher is not None and _is_float(higher):
        return higher
    if higher == "bool" or (lower is not None and _is_float(lower)):
        return _fold(higher, lower) if lower is not None else higher
    if higher is not None:
        return higher
    return lower


def result_type(operands) -> Optional[str]:
    """``torch.result_type`` over ``[(dtype, tier)]`` with tier one of
    ``"dim"`` (a dimensioned tensor), ``"zero"`` (a zero-dim tensor) or
    ``"scalar"`` (a Python scalar, its dtype from ``SCALAR_DTYPE``)."""
    acc = {"dim": None, "zero": None, "scalar": None}
    for d, tier in operands:
        acc[tier] = _fold(acc[tier], d)
    return _combine(acc["dim"], _combine(acc["zero"], acc["scalar"]))


def promote(d1: Optional[str], w1: bool,
            d2: Optional[str], w2: bool,
            z1: Optional[bool] = False,
            z2: Optional[bool] = False) -> Tuple[Optional[str], bool]:
    """torch's binary result type. ``w`` marks a Python scalar, ``z`` a
    zero-dim tensor (None: rank unknown, which must not decide the
    result). Unknown in -> Unknown out."""
    if d1 is None or d2 is None:
        return None, False
    if w1 and w2:
        return (d1 if kind(d1) >= kind(d2) else d2), True

    def tiers(w, z):
        if w:
            return ("scalar",)
        if z is None:
            return ("dim", "zero")
        return ("zero",) if z else ("dim",)

    outs = {result_type([(d1, t1), (d2, t2)])
            for t1 in tiers(w1, z1) for t2 in tiers(w2, z2)}
    if len(outs) != 1:
        return None, False
    return outs.pop(), False


def join_dtype(d1: Optional[str], w1: bool,
               d2: Optional[str], w2: bool) -> Tuple[Optional[str], bool]:
    if d1 == d2:
        return d1, w1 and w2
    return None, False


# -- uint32 on the CPU ------------------------------------------------------

#: ops torch 2.13 refuses on uint32 tensors on the CPU (probed:
#: NotImplementedError "... not implemented for 'UInt32'")
UINT32_CPU_REFUSED = frozenset({
    "add", "sub", "floordiv", "mod", "pow", "shl", "shr", "lt", "le",
    "gt", "ge", "neg", "invert", "abs", "max", "min", "argmax",
    "maximum", "minimum", "clamp", "gather", "bincount", "arange",
    "flip", "nonzero", "isin", "searchsorted",
})


def uint32_op_calls(torch, a, b) -> dict[str, Callable[[], object]]:
    """name -> a call of that op on the uint32 tensors ``a`` and ``b``
    (equal shapes, 1-D): every name of ``UINT32_CPU_REFUSED`` and the
    ops the CPU runs, so a probe can tell which raise. ``torch`` is the
    caller's module, so this file imports nothing heavy."""
    idx = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    mask = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    return {
        "add": lambda: a + b, "sub": lambda: a - b, "mul": lambda: a * b,
        "div": lambda: a / b, "floordiv": lambda: a // b,
        "mod": lambda: a % b, "pow": lambda: a ** b,
        "and": lambda: a & b, "or": lambda: a | b, "xor": lambda: a ^ b,
        "shl": lambda: a << b, "shr": lambda: a >> b,
        "lt": lambda: a < b, "le": lambda: a <= b, "gt": lambda: a > b,
        "ge": lambda: a >= b, "eq": lambda: a == b, "ne": lambda: a != b,
        "neg": lambda: -a, "invert": lambda: ~a, "abs": lambda: a.abs(),
        "sum": lambda: a.sum(), "prod": lambda: a.prod(),
        "cumsum": lambda: a.cumsum(0), "max": lambda: a.max(),
        "min": lambda: a.min(), "argmax": lambda: a.argmax(),
        "maximum": lambda: torch.maximum(a, b),
        "minimum": lambda: torch.minimum(a, b),
        "clamp": lambda: a.clamp(0, 6),
        "gather": lambda: a.gather(0, idx),
        "bincount": lambda: a.bincount(),
        "arange": lambda: torch.arange(3, dtype=a.dtype, device=a.device),
        "flip": lambda: a.flip(0), "nonzero": lambda: a.nonzero(),
        "isin": lambda: torch.isin(a, b),
        "searchsorted": lambda: torch.searchsorted(b, a),
        "sort": lambda: a.sort(), "where": lambda: torch.where(mask, a, b),
        "cat": lambda: torch.cat([a, b]), "index": lambda: a[idx],
        "roll": lambda: a.roll(1), "to_int64": lambda: a.to(torch.int64),
        "view_int32": lambda: a.view(torch.int32),
    }


# -- abstract arrays --------------------------------------------------------

@dataclass(frozen=True)
class AbsArray:
    """An array (or scalar: ``shape == ()``) in the abstract domain.

    ``shape`` is a tuple of dims or ``None`` for unknown rank;
    ``dtype`` a canonical string or ``None``; ``weak`` marks a Python
    scalar operand (torch's wrapped-number tier).
    """

    shape: Optional[tuple]
    dtype: Optional[str]
    weak: bool = False

    def rank(self) -> Optional[int]:
        return None if self.shape is None else len(self.shape)


UNKNOWN_ARRAY = AbsArray(None, None)


def shape_str(shape: Optional[tuple]) -> str:
    if shape is None:
        return "(?)"

    def one(d):
        if is_conc(d):
            return str(d)
        return "?" if d is None else "s"

    return "(" + ", ".join(one(d) for d in shape) + ("," if len(shape) == 1
                                                     else "") + ")"


def broadcast_shapes(a: Optional[tuple],
                     b: Optional[tuple]) -> Tuple[Optional[tuple],
                                                  Optional[tuple]]:
    """NumPy broadcasting, three-valued.

    Returns ``(result_shape, conflict)`` where ``conflict`` is
    ``(dim_a, dim_b, axis_from_right)`` only when two CONCRETE dims
    disagree and neither is 1 — the only case a rule may report.
    Symbolic or unknown dims broadcast silently to Unknown.
    """
    if a is None or b is None:
        return None, None
    out = []
    conflict = None
    for i in range(1, max(len(a), len(b)) + 1):
        da = a[-i] if i <= len(a) else 1
        db = b[-i] if i <= len(b) else 1
        if da == db:
            out.append(da)
        elif da == 1:
            out.append(db)
        elif db == 1:
            out.append(da)
        elif is_conc(da) and is_conc(db):
            conflict = (da, db, i - 1)
            out.append(None)
        else:
            out.append(None)  # symbolic vs anything: silent
    return tuple(reversed(out)), conflict


def numel(shape: Optional[tuple]):
    if shape is None:
        return None
    n = 1
    for d in shape:
        if not is_conc(d):
            return None
        n *= d
    return n


def join_shape(a: Optional[tuple], b: Optional[tuple]) -> Optional[tuple]:
    if a is None or b is None or len(a) != len(b):
        return None
    return tuple(join_dim(x, y) for x, y in zip(a, b))


def join_array(a: AbsArray, b: AbsArray) -> AbsArray:
    d, w = join_dtype(a.dtype, a.weak, b.dtype, b.weak)
    return AbsArray(join_shape(a.shape, b.shape), d, w)
