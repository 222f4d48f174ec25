"""Logical dtypes: dictionary-encoded categories + validity/null model.

Schemas stay ``dict[str, dtype-like]``: plain columns carry a raw
``np.dtype``; category and nullable columns carry a :class:`DType` wrapper
that resolves to its physical dtype under ``np.dtype(...)`` — so packing,
byte censuses, sentinels and capacity planning never see the difference.
Encoding happens host-side at ingest (``hf.table`` / ``hf.from_pandas``);
on device a string column is int32 codes, one packed-exchange word, which is
why string-key plans are byte-identical to int-key ones (docs/dtypes.md).
"""
from __future__ import annotations

from typing import Any

import numpy as np

# ---------------------------------------------------------------------------
# logical dtypes (docs/dtypes.md)
# ---------------------------------------------------------------------------

#: dictionary code reserved for null — matches pandas.Categorical.codes.
NULL_CODE = -1

#: physical storage of dictionary codes; one packed-exchange word, same as an
#: int key, which is what makes string-key plans byte-identical to int-key.
CODE_DTYPE = np.dtype(np.int32)


class DType:
    """Logical column dtype: a physical ``np.dtype`` plus optional dictionary
    (categorical) and nullability metadata.

    Every physical layer keeps seeing a plain numpy dtype: ``np.dtype(DType)``
    resolves to ``physical`` (numpy reads the ``.dtype`` attribute), so
    packing, byte censuses, sentinels and capacity planning need no changes.
    A non-category ``DType`` compares equal to its physical dtype, so
    nullability never breaks a plain ``schema[c] == np.float32`` check;
    category dtypes only compare equal to category dtypes with the same
    dictionary.
    """

    __slots__ = ("physical", "categories", "nullable")

    def __init__(self, physical, categories: tuple | None = None,
                 nullable: bool = False):
        self.physical = np.dtype(physical)
        self.categories = tuple(categories) if categories is not None else None
        self.nullable = bool(nullable)
        if self.categories is not None and self.physical != CODE_DTYPE:
            raise ValueError("category columns are int32-coded")

    @property
    def dtype(self) -> np.dtype:        # np.dtype(DType) -> physical
        return self.physical

    @property
    def itemsize(self) -> int:
        return self.physical.itemsize

    @property
    def is_category(self) -> bool:
        return self.categories is not None

    def __eq__(self, other):
        if isinstance(other, DType):
            return (self.physical == other.physical
                    and self.categories == other.categories)
        if self.categories is not None:
            return False
        try:
            return self.physical == np.dtype(other)
        except TypeError:
            return NotImplemented

    def __hash__(self):
        return hash((self.physical, self.categories))

    def __repr__(self):
        if self.categories is not None:
            base = "category[str]"
            return base + ("?" if self.nullable else "")
        return self.physical.name + ("?" if self.nullable else "")


def physical_dtype(dt) -> np.dtype:
    """The on-device dtype of a logical-or-physical schema entry."""
    return np.dtype(dt)


def is_category(dt) -> bool:
    return isinstance(dt, DType) and dt.is_category


def is_nullable(dt) -> bool:
    return isinstance(dt, DType) and dt.nullable


def categories_of(dt) -> tuple:
    if not is_category(dt):
        raise TypeError(f"not a category dtype: {dt!r}")
    return dt.categories


def as_nullable(dt) -> Any:
    """The nullable variant of a schema entry (idempotent)."""
    if isinstance(dt, DType):
        if dt.nullable:
            return dt
        return DType(dt.physical, dt.categories, nullable=True)
    return DType(np.dtype(dt), nullable=True)


# -- dictionary encoding (host side, at ingest) ------------------------------


def _null_positions(values: np.ndarray) -> np.ndarray:
    """Boolean mask of None / NaN holes in a host object/str array."""
    out = np.zeros(len(values), dtype=bool)
    for i, v in enumerate(values):
        if v is None:
            out[i] = True
        elif isinstance(v, float) and np.isnan(v):
            out[i] = True
        elif type(v).__name__ == "NAType":    # pandas.NA, sans pandas import
            out[i] = True
    return out


def dict_encode(values: np.ndarray,
                categories: tuple | None = None
                ) -> tuple[np.ndarray, tuple, bool]:
    """Encode a host string array into (int32 codes, sorted dictionary,
    has_null).  ``None``/``NaN`` holes get ``NULL_CODE``.

    The dictionary is the *sorted* unique value set, so code order is
    lexicographic order — sorts and range comparisons on codes match sorts on
    the strings themselves.  Pass ``categories`` to encode against a fixed
    dictionary (values outside it raise).
    """
    values = np.asarray(values, dtype=object)
    nulls = _null_positions(values)
    strs = values[~nulls]
    for v in strs:
        if not isinstance(v, str):
            raise TypeError(
                f"dict_encode: non-string value {v!r}; mixed-type object "
                "columns are not supported")
    if categories is None:
        cats = tuple(sorted(set(strs.tolist())))
    else:
        cats = tuple(categories)
        extra = set(strs.tolist()) - set(cats)
        if extra:
            raise ValueError(f"values outside the dictionary: {sorted(extra)!r}")
    lut = {v: i for i, v in enumerate(cats)}
    codes = np.full(len(values), NULL_CODE, dtype=CODE_DTYPE)
    if len(strs):
        codes[~nulls] = np.fromiter((lut[v] for v in strs), dtype=CODE_DTYPE,
                                    count=len(strs))
    return codes, cats, bool(nulls.any())


def dict_decode(codes: np.ndarray, categories: tuple) -> np.ndarray:
    """Codes -> host object array of strings (``None`` for null codes)."""
    codes = np.asarray(codes)
    out = np.empty(len(codes), dtype=object)
    cats = np.asarray(categories, dtype=object) if categories else \
        np.empty(0, dtype=object)
    valid = codes >= 0
    if codes.size:
        out[valid] = cats[codes[valid]] if len(cats) else None
        out[~valid] = None
    return out


def union_categories(a: tuple, b: tuple) -> tuple:
    """Merged (sorted) dictionary for joining/concatenating two category
    columns encoded against different dictionaries."""
    return tuple(sorted(set(a) | set(b)))


def recode_map(old: tuple, new: tuple) -> np.ndarray:
    """Host int32 lookup table: ``new_code = map[old_code]`` (null stays
    null by convention — callers gate on ``code >= 0``)."""
    if not set(old) <= set(new):
        raise ValueError("recode target dictionary must be a superset")
    lut = {v: i for i, v in enumerate(new)}
    return np.asarray([lut[v] for v in old], dtype=CODE_DTYPE) if old else \
        np.zeros(1, dtype=CODE_DTYPE)


# -- ingest coercion ---------------------------------------------------------

_REJECT_KINDS = {
    "M": "datetime64 (convert to int64 epoch or string first)",
    "m": "timedelta64 (convert to a numeric duration first)",
    "c": "complex (split into real/imag float columns)",
    "V": "structured/void (pass each field as its own column)",
}


def coerce_column(name: str, values) -> tuple[np.ndarray, Any]:
    """Ingest-time coercion: host values -> (physical array, schema dtype).

    * str / object-of-str arrays (``None``/``NaN`` holes allowed) are
      dictionary-encoded to int32 codes with a ``category[str]`` dtype;
    * float arrays with NaN holes keep NaN in-band and get a nullable dtype;
    * object arrays of numbers with ``None`` holes become nullable float32
      (pandas promotes holed ints to float the same way);
    * plain numeric/bool arrays pass through unchanged;
    * datetime/complex/structured inputs raise an actionable TypeError
      instead of being silently cast.
    """
    arr = values if isinstance(values, np.ndarray) else np.asarray(values)
    kind = arr.dtype.kind
    if kind in _REJECT_KINDS:
        raise TypeError(
            f"column {name!r}: unsupported dtype {arr.dtype} — "
            f"{_REJECT_KINDS[kind]}")
    if kind in ("U", "S"):
        codes, cats, _ = dict_encode(arr.astype(object))
        return codes, DType(CODE_DTYPE, cats)
    if kind == "O":
        nulls = _null_positions(arr)
        rest = arr[~nulls]
        if all(isinstance(v, str) for v in rest):
            codes, cats, has_null = dict_encode(arr)
            return codes, DType(CODE_DTYPE, cats, nullable=has_null)
        if all(isinstance(v, (int, float, np.integer, np.floating))
               and not isinstance(v, bool) for v in rest):
            out = np.full(len(arr), np.nan, dtype=np.float32)
            out[~nulls] = rest.astype(np.float32)
            if not nulls.any() and all(
                    isinstance(v, (int, np.integer)) for v in rest):
                return rest.astype(np.int32), np.dtype(np.int32)
            return out, DType(np.float32, nullable=True)
        bad = {type(v).__name__ for v in rest
               if not isinstance(v, (str, int, float, np.integer, np.floating))}
        raise TypeError(
            f"column {name!r}: object column mixes strings and numbers or "
            f"holds unsupported values ({sorted(bad) or 'mixed str/number'}) "
            "— pass homogeneous strings or numbers")
    arr = canonical(arr)
    if kind == "f" and arr.size and bool(np.isnan(arr).any()):
        return arr, DType(arr.dtype, nullable=True)
    return arr, np.dtype(arr.dtype)


#: 64-bit host dtypes and the 32-bit types they narrow to at ingest — the
#: reference's arrays do the same on entry (JAX with x64 off), so hashes,
#: packed words and schemas agree between the two packages.
_NARROW = {np.dtype(np.int64): np.dtype(np.int32),
           np.dtype(np.uint64): np.dtype(np.uint32),
           np.dtype(np.float64): np.dtype(np.float32)}


def canonical_dtype(dtype) -> np.dtype:
    """The 32-bit dtype a 64-bit one narrows to (others unchanged)."""
    dt = np.dtype(dtype)
    return _NARROW.get(dt, dt)


def canonical(arr: np.ndarray) -> np.ndarray:
    """Narrow a host array's 64-bit dtype to its 32-bit counterpart."""
    dt = canonical_dtype(arr.dtype)
    return arr if dt == arr.dtype else arr.astype(dt)
