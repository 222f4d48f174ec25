"""Column expression trees — the Macro-Pass analogue of HiFrames.

In the paper, ``df[:x] < 1.0`` is desugared at macro time into element-wise
array operations on the underlying column arrays (``_df_x .< 1.0``).  Here the
same desugaring builds a small expression tree that the executor evaluates
with torch ops, one rank's shard at a time.

Result dtypes follow the JAX reference package's promotion with 64-bit types
off (``infer_dtype``), not numpy's or torch's, so schemas, packed words and
byte censuses agree between the two packages.  ``UDF`` nodes carry the API
layer's device helpers (dictionary recoding, null fills); a public ``udf``
and external arrays are not part of this package yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .dtypes import canonical_dtype

# ---------------------------------------------------------------------------
# Expression nodes
# ---------------------------------------------------------------------------


class Expr:
    """Base class for column expressions.  Immutable, hash-consable."""

    children: tuple["Expr", ...] = ()

    # -- operator overloading (the "syntactic sugar" layer) -----------------
    def _bin(self, other: Any, op: str) -> "BinOp":
        return BinOp(op, self, as_expr(other))

    def _rbin(self, other: Any, op: str) -> "BinOp":
        return BinOp(op, as_expr(other), self)

    def __add__(self, o):  return self._bin(o, "add")
    def __radd__(self, o): return self._rbin(o, "add")
    def __sub__(self, o):  return self._bin(o, "sub")
    def __rsub__(self, o): return self._rbin(o, "sub")
    def __mul__(self, o):  return self._bin(o, "mul")
    def __rmul__(self, o): return self._rbin(o, "mul")
    def __truediv__(self, o):  return self._bin(o, "div")
    def __rtruediv__(self, o): return self._rbin(o, "div")
    def __mod__(self, o):  return self._bin(o, "mod")
    def __rmod__(self, o): return self._rbin(o, "mod")
    def __lt__(self, o):   return self._bin(o, "lt")
    def __le__(self, o):   return self._bin(o, "le")
    def __gt__(self, o):   return self._bin(o, "gt")
    def __ge__(self, o):   return self._bin(o, "ge")
    def __eq__(self, o):   return self._bin(o, "eq")          # noqa: E721
    def __ne__(self, o):   return self._bin(o, "ne")
    def __and__(self, o):  return self._bin(o, "and")
    def __rand__(self, o): return self._rbin(o, "and")
    def __or__(self, o):   return self._bin(o, "or")
    def __ror__(self, o):  return self._rbin(o, "or")
    def __invert__(self):  return UnOp("not", self)
    def __neg__(self):     return UnOp("neg", self)
    def __abs__(self):     return UnOp("abs", self)

    def isin(self, values) -> "IsIn":
        """Membership test (pandas ``Series.isin``).  String values against a
        category column lower to code-space comparison at plan-build time."""
        return IsIn(self, tuple(values))

    def isna(self) -> "UnOp":
        """True where the value is null (NaN for floats, null code for
        category columns — resolved against the schema at plan-build time)."""
        return UnOp("isna", self)

    def notna(self) -> "UnOp":
        return UnOp("not", self.isna())

    def astype(self, dtype) -> "Cast":
        """Element-wise cast to a numpy dtype."""
        return Cast(self, dtype)

    def __hash__(self):
        return hash(self.key())

    def key(self) -> tuple:
        """Structural key for hash-consing / CSE."""
        raise NotImplementedError

    def equals(self, other: "Expr") -> bool:
        return isinstance(other, Expr) and self.key() == other.key()

    def columns(self) -> set[tuple[int, str]]:
        """All (table_id, column) references in this expression."""
        out: set[tuple[int, str]] = set()
        stack = [self]
        while stack:
            e = stack.pop()
            if isinstance(e, ColRef):
                out.add((e.table_id, e.name))
            stack.extend(e.children)
        return out

    def map_refs(self, fn: Callable[["ColRef"], "Expr"]) -> "Expr":
        """Rebuild the tree with every ColRef replaced via ``fn``."""
        if isinstance(self, ColRef):
            return fn(self)
        if not self.children:
            return self
        new = tuple(c.map_refs(fn) for c in self.children)
        return self.with_children(new)

    def with_children(self, children: tuple["Expr", ...]) -> "Expr":
        raise NotImplementedError


class ColRef(Expr):
    """Reference to a column of a logical plan node (by node id)."""

    def __init__(self, table_id: int, name: str):
        self.table_id = table_id
        self.name = name

    def key(self):
        return ("col", self.table_id, self.name)

    def __repr__(self):
        return f"col({self.table_id}.{self.name})"


class Const(Expr):
    def __init__(self, value: Any):
        self.value = value

    def key(self):
        v = self.value
        if isinstance(v, (np.ndarray, torch.Tensor)):
            v = ("arr", id(v))
        # the type too: False == 0 == np.int32(0) hash alike, and a shared
        # evaluation cache must not hand one's tensor out for another's
        return ("const", type(self.value), v)

    def __repr__(self):
        return f"const({self.value})"


class BinOp(Expr):
    def __init__(self, op: str, a: Expr, b: Expr):
        self.op = op
        self.children = (a, b)

    def key(self):
        return ("bin", self.op, self.children[0].key(), self.children[1].key())

    def with_children(self, children):
        return BinOp(self.op, *children)

    def __repr__(self):
        return f"({self.children[0]} {self.op} {self.children[1]})"


class UnOp(Expr):
    def __init__(self, op: str, a: Expr):
        self.op = op
        self.children = (a,)

    def key(self):
        return ("un", self.op, self.children[0].key())

    def with_children(self, children):
        return UnOp(self.op, *children)

    def __repr__(self):
        return f"{self.op}({self.children[0]})"


class IsIn(Expr):
    """Membership of a column expression in a small literal value set.

    Evaluates as an OR-chain of equality comparisons (the set is a plan
    constant).  String value sets against category columns are rewritten to
    int32 code sets by the API layer before lowering.
    """

    def __init__(self, a: Expr, values: tuple):
        self.children = (a,)
        self.values = tuple(values)

    def key(self):
        return ("isin", self.children[0].key(), self.values)

    def with_children(self, children):
        return IsIn(children[0], self.values)

    def __repr__(self):
        return f"isin({self.children[0]}, {list(self.values)})"


class Cast(Expr):
    """Element-wise dtype cast (``Expr.astype`` / ``DataFrame.astype``)."""

    def __init__(self, a: Expr, dtype):
        self.children = (a,)
        self.to = np.dtype(dtype)

    def key(self):
        return ("cast", self.children[0].key(), self.to.str)

    def with_children(self, children):
        return Cast(children[0], self.to)

    def __repr__(self):
        return f"cast[{self.to.name}]({self.children[0]})"


class UDF(Expr):
    """Element-wise function of one or more column expressions: ``fn``
    takes the children's tensors and returns a tensor of their rows."""

    def __init__(self, fn: Callable, *args: Expr, name: str | None = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "udf")
        self.children = tuple(as_expr(a) for a in args)

    def key(self):
        return ("udf", id(self.fn)) + tuple(c.key() for c in self.children)

    def with_children(self, children):
        return UDF(self.fn, *children, name=self.name)

    def __repr__(self):
        return f"udf:{self.name}({', '.join(map(repr, self.children))})"


def as_expr(x: Any) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, (torch.Tensor, np.ndarray)) and getattr(x, "ndim", 0) > 0:
        raise TypeError("arrays inside expressions are not supported by "
                        "this package yet; add the array as a column")
    return Const(x)


# ---------------------------------------------------------------------------
# Aggregation specs (used by aggregate())
# ---------------------------------------------------------------------------

AGG_FNS = ("sum", "mean", "count", "min", "max", "prod", "any", "all",
           "var", "std", "first", "nunique")


@dataclasses.dataclass(frozen=True)
class AggExpr:
    """A reduction ``fn`` over an element-wise expression, e.g. sum(:x < 1.0).

    ``skipna`` follows pandas: nulls (NaN / null dictionary codes) are
    excluded from the reduction by default; ``skipna=False`` lets them
    poison the group result.  ``count`` over an expression counts non-null
    values (pandas ``count``); ``count`` with ``expr=None`` counts rows
    (pandas ``size``) and ignores ``skipna``.
    """

    fn: str
    expr: Expr = None  # None for count()
    skipna: bool = True

    def __post_init__(self):
        if self.fn not in AGG_FNS:
            raise ValueError(
                f"unknown aggregation fn {self.fn!r}; valid: {AGG_FNS}")


def sum_(e, skipna=True):    return AggExpr("sum", as_expr(e), skipna)
def mean(e, skipna=True):    return AggExpr("mean", as_expr(e), skipna)
def min_(e, skipna=True):    return AggExpr("min", as_expr(e), skipna)
def max_(e, skipna=True):    return AggExpr("max", as_expr(e), skipna)
def prod(e, skipna=True):    return AggExpr("prod", as_expr(e), skipna)
def any_(e, skipna=True):    return AggExpr("any", as_expr(e), skipna)
def all_(e, skipna=True):    return AggExpr("all", as_expr(e), skipna)
def var(e, skipna=True):     return AggExpr("var", as_expr(e), skipna)
def std(e, skipna=True):     return AggExpr("std", as_expr(e), skipna)
def first(e, skipna=True):   return AggExpr("first", as_expr(e), skipna)
def nunique(e, skipna=True): return AggExpr("nunique", as_expr(e), skipna)


def count(e=None):
    return AggExpr("count", as_expr(e) if e is not None else None)


# ---------------------------------------------------------------------------
# Evaluation (eager, per rank)
# ---------------------------------------------------------------------------

_BIN_IMPL = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.true_divide,
    "mod": torch.remainder,          # floor-mod, like jnp.mod
    "lt": torch.lt,
    "le": torch.le,
    "gt": torch.gt,
    "ge": torch.ge,
    "eq": torch.eq,
    "ne": torch.ne,
    "and": torch.logical_and,
    "or": torch.logical_or,
}

_UN_IMPL = {
    "not": torch.logical_not,
    "neg": torch.neg,
    "abs": torch.abs,
    "log": torch.log,
    "exp": torch.exp,
    "sqrt": torch.sqrt,
    "isnan": torch.isnan,
    "floor": torch.floor,
    "ceil": torch.ceil,
}

_ARITH = frozenset({"add", "sub", "mul", "mod"})


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a (canonicalized) numpy dtype."""
    return torch.from_numpy(np.zeros(0, canonical_dtype(dtype))).dtype


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def _scalar(v):
    """A Const value as a Python scalar: torch treats those as weakly typed,
    as JAX does, so an int32 column compared with ``1`` stays int32."""
    return v.item() if isinstance(v, np.generic) else v


def _operand(e: Expr, env, cache):
    if isinstance(e, Const) and not isinstance(e.value, (np.ndarray,
                                                         torch.Tensor)):
        return _scalar(e.value)
    return evaluate(e, env, cache)


def evaluate(e: Expr, env: dict[str, torch.Tensor],
             cache: dict | None = None) -> torch.Tensor:
    """Evaluate an expression against one shard's column tensors.

    ``env`` maps column names to tensors.  ``cache`` memoizes identical
    subtrees (hash-consed common-subexpression elimination).  A bare
    constant evaluates to a 0-d tensor of its :func:`infer_dtype` type;
    constants under an operator stay Python scalars.
    """
    if cache is None:
        cache = {}
    k = e.key()
    if k in cache:
        return cache[k]
    if isinstance(e, ColRef):
        out = env[e.name]
    elif isinstance(e, Const):
        dev = next(iter(env.values())).device if env else None
        out = torch.tensor(_scalar(e.value), device=dev,
                           dtype=torch_dtype(infer_dtype(e, {})))
    elif isinstance(e, BinOp):
        a = _operand(e.children[0], env, cache)
        b = _operand(e.children[1], env, cache)
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            a = evaluate(e.children[0], env, cache)
        if e.op in _ARITH:
            # JAX: bool op weak int -> int32 (torch would give int64)
            a, b = (_bool_to_i32(x, y) for x, y in ((a, b), (b, a)))
        elif e.op in ("and", "or"):
            dev = (a if isinstance(a, torch.Tensor) else b).device
            a, b = (torch.as_tensor(x, device=dev) for x in (a, b))
        out = _BIN_IMPL[e.op](a, b)
    elif isinstance(e, UnOp):
        a = evaluate(e.children[0], env, cache)
        if e.op == "isna":
            # floats are null iff NaN; non-float columns hold no nulls
            # (category isna is rewritten to a code test before lowering).
            out = torch.isnan(a) if a.is_floating_point() \
                else torch.zeros(a.shape, dtype=torch.bool, device=a.device)
        else:
            if e.op in _FLOAT_UN and not a.is_floating_point():
                a = a.to(torch.float32)
            elif e.op == "neg" and a.dtype == torch.bool:
                a = a.to(torch.int32)
            out = _UN_IMPL[e.op](a)
    elif isinstance(e, IsIn):
        a = evaluate(e.children[0], env, cache)
        out = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
        for v in e.values:
            out = out | (a == _scalar(v))
    elif isinstance(e, Cast):
        out = evaluate(e.children[0], env, cache).to(torch_dtype(e.to))
    elif isinstance(e, UDF):
        out = e.fn(*(evaluate(c, env, cache) for c in e.children))
    else:
        raise TypeError(f"unknown expr {e!r}")
    cache[k] = out
    return out


def _bool_to_i32(x, other):
    if isinstance(x, torch.Tensor) and x.dtype == torch.bool and \
            isinstance(other, int) and not isinstance(other, bool):
        return x.to(torch.int32)
    return x


def fn_expr(fn: Callable, *args) -> UDF:
    """Lift an element-wise tensor function into an expression."""
    return UDF(fn, *args)


def log(e):   return UnOp("log", as_expr(e))
def exp(e):   return UnOp("exp", as_expr(e))
def sqrt(e):  return UnOp("sqrt", as_expr(e))
def isnan(e): return UnOp("isnan", as_expr(e))


# ---------------------------------------------------------------------------
# Static result-dtype / nullability inference (schema propagation)
# ---------------------------------------------------------------------------

_BOOL_BIN = frozenset({"lt", "le", "gt", "ge", "eq", "ne", "and", "or"})
_BOOL_UN = frozenset({"not", "isnan", "isna"})
_FLOAT_UN = frozenset({"log", "exp", "sqrt", "floor", "ceil"})


def _float_ty() -> np.dtype:
    # the reference's canonical float (JAX with x64 off)
    return np.dtype(np.float32)


# JAX's type-promotion lattice (jax._src.dtypes), real types only: each
# type's immediate successors; "f*" is the weakly-typed float.
_LATTICE = {
    "b1": ("u1", "i1"), "u1": ("u2", "i2"), "u2": ("u4", "i4"), "u4": ("u8", "i8"),
    "u8": ("f*",), "i1": ("i2",), "i2": ("i4",), "i4": ("i8",), "i8": ("f*",),
    "f*": ("f2",), "f2": ("f4",), "f4": ("f8",), "f8": (),
}


def _upper(t: str) -> set[str]:
    out, stack = set(), [t]
    while stack:
        x = stack.pop()
        if x not in out:
            out.add(x)
            stack.extend(_LATTICE[x])
    return out


def _lattice_name(dt: np.dtype) -> str:
    return "b1" if dt == np.bool_ else f"{dt.kind}{dt.itemsize}"


def promote_types(a, b) -> np.dtype:
    """``jnp.promote_types`` with x64 off, over bool/int/uint/float dtypes:
    the least upper bound in JAX's promotion lattice, narrowed to 32 bits
    (numpy's table differs: there int32 with float32 gives float64)."""
    a, b = np.dtype(a), np.dtype(b)
    common = _upper(_lattice_name(a)) & _upper(_lattice_name(b))
    lub = next(t for t in common if common <= _upper(t))
    if lub == "f*":
        return _float_ty()
    return canonical_dtype(np.bool_ if lub == "b1" else lub)


def _const_dtype(v) -> np.dtype:
    """``jnp.result_type`` of a constant with x64 off: Python ints are
    int32, Python floats float32, 64-bit numpy values narrow to 32 bits."""
    if isinstance(v, (bool, np.bool_)):
        return np.dtype(np.bool_)
    if isinstance(v, int):
        return np.dtype(np.int32)
    if isinstance(v, float):
        return np.dtype(np.float32)
    return canonical_dtype(np.asarray(v).dtype)


def infer_dtype(e: Expr, schema: dict[str, Any]) -> np.dtype:
    """Physical result dtype of ``e`` over columns typed by ``schema``.

    Mirrors the reference's jnp promotion with x64 off, so ``explain()`` and
    the capacity/byte censuses agree with the reference package.
    """
    if isinstance(e, ColRef):
        dt = schema.get(e.name)
        return np.dtype(dt) if dt is not None else np.dtype(np.float32)
    if isinstance(e, Const):
        return _const_dtype(e.value)
    if isinstance(e, IsIn):
        return np.dtype(bool)
    if isinstance(e, Cast):
        return e.to
    if isinstance(e, BinOp):
        if e.op in _BOOL_BIN:
            return np.dtype(bool)
        a = infer_dtype(e.children[0], schema)
        b = infer_dtype(e.children[1], schema)
        t = promote_types(a, b)
        if e.op == "div" and not np.issubdtype(t, np.floating):
            t = promote_types(t, _float_ty())
        return t
    if isinstance(e, UnOp):
        if e.op in _BOOL_UN:
            return np.dtype(bool)
        t = infer_dtype(e.children[0], schema)
        if e.op in _FLOAT_UN and not np.issubdtype(t, np.floating):
            return promote_types(t, _float_ty())
        if e.op == "neg" and t == np.dtype(bool):
            return np.dtype(np.int32)
        return t
    if isinstance(e, UDF):
        # call fn on 4-row CPU tensors of the children's dtypes; anything
        # that fails there types as float32, as the reference's trace does
        try:
            args = [torch.zeros(4, dtype=torch_dtype(infer_dtype(c, schema)))
                    for c in e.children]
            return numpy_dtype(e.fn(*args).dtype)
        except Exception:
            return np.dtype(np.float32)
    return np.dtype(np.float32)


def expr_nullable(e: Expr, schema: dict[str, Any]) -> bool:
    """Whether ``e`` can produce nulls (NaN / null codes) over ``schema``.

    Comparisons and membership tests are never null (NaN compares False —
    pandas semantics); arithmetic propagates nullability; non-nullable
    sources stay non-nullable, so null-free pipelines pay zero masking cost.
    """
    from .dtypes import is_nullable
    if isinstance(e, ColRef):
        return is_nullable(schema.get(e.name))
    if isinstance(e, (Const, IsIn)):
        return False
    if isinstance(e, BinOp):
        if e.op in _BOOL_BIN:
            return False
        return any(expr_nullable(c, schema) for c in e.children)
    if isinstance(e, UnOp):
        if e.op in _BOOL_UN:
            return False
        return expr_nullable(e.children[0], schema)
    if isinstance(e, (Cast, UDF)):
        return any(expr_nullable(c, schema) for c in e.children)
    return False


def nulltag_for(e: Expr | None, schema: dict[str, Any]) -> str | None:
    """The in-band null encoding of an expression's values over ``schema``:
    ``"code"`` (dictionary code -1) for nullable category columns, ``"nan"``
    for nullable floating results, None for everything null-free — the tag
    the segment/partial kernels use to DERIVE validity masks, decided at
    lowering time so null-free pipelines take the exact pre-null code paths.
    """
    from .dtypes import is_category
    if e is None or not expr_nullable(e, schema):
        return None
    if isinstance(e, ColRef) and is_category(schema.get(e.name)):
        return "code"
    dt = np.dtype(infer_dtype(e, schema))
    return "nan" if np.issubdtype(dt, np.floating) else None
