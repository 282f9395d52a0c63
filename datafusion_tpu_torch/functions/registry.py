"""Scalar function catalog: return-type inference + vectorized dispatch.

Port of ``datafusion_tpu/functions/registry.py`` (reference: the
BuiltinScalarFunction enum + dispatch, datafusion/src/physical_plan/
functions.rs:103-229, covering math, string, unicode, regex, datetime,
crypto and misc functions).

Math functions are torch operations on the column's device, with the
reference's semantics kept as they are: ``log`` is ``log10`` and
``round`` rounds half to even.  String functions run host-side once per
*distinct* dictionary value and ship back as a code lookup table, applied
with one device gather; functions of several column arguments run once
per distinct combination of values (found by a unique on the device).  Datetime functions are integer
calendar arithmetic (functions/datetime_fns.py).  ``array`` builds a
fixed-size list column, which is ported in slice 5.
"""

from __future__ import annotations

import hashlib
import re as _re
from typing import Callable

import numpy as np
import torch

from ..columnar.column import Column as CVec
from ..columnar.dictionary import StringDict
from ..columnar.table import host_numpy, refuse_in_whole_query
from ..errors import PlanError
from ..exprs.physical import derived, device_table, fn_key, padded, to_device
from ..ops import kernels as K
from ..types.dtypes import (
    BOOL,
    DATE32,
    FLOAT64,
    INT32,
    INT64,
    STRING,
    TIMESTAMP_US,
    DataType,
    NULLTYPE,
)

_MATH_UNARY = {
    "sqrt": torch.sqrt,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "exp": torch.exp,
    "ln": torch.log,
    "log": torch.log10,
    "log10": torch.log10,
    "log2": torch.log2,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "round": torch.round,
    "trunc": torch.trunc,
    "abs": torch.abs,
    "signum": torch.sign,
}

_STRING_TO_STRING = {
    "upper": lambda s: s.upper(),
    "lower": lambda s: s.lower(),
    "trim": lambda s: s.strip(),
    "btrim": lambda s: s.strip(),
    "ltrim": lambda s: s.lstrip(),
    "rtrim": lambda s: s.rstrip(),
    "reverse": lambda s: s[::-1],
    "initcap": lambda s: _re.sub(r"\w+", lambda m: m.group(0).capitalize(), s),
    "md5": lambda s: hashlib.md5(s.encode()).hexdigest(),
    "sha224": lambda s: hashlib.sha224(s.encode()).hexdigest(),
    "sha256": lambda s: hashlib.sha256(s.encode()).hexdigest(),
    "sha384": lambda s: hashlib.sha384(s.encode()).hexdigest(),
    "sha512": lambda s: hashlib.sha512(s.encode()).hexdigest(),
}

_STRING_TO_INT = {
    "character_length": len,
    "char_length": len,
    "length": len,
    "bit_length": lambda s: len(s.encode()) * 8,
    "octet_length": lambda s: len(s.encode()),
    "ascii": lambda s: ord(s[0]) if s else 0,
}

_SCALAR_NAMES = (
    set(_MATH_UNARY)
    | set(_STRING_TO_STRING)
    | set(_STRING_TO_INT)
    | {
        "power",
        "pow",
        "atan2",
        "concat",
        "concat_ws",
        "substr",
        "substring",
        "left",
        "right",
        "lpad",
        "rpad",
        "repeat",
        "replace",
        "split_part",
        "starts_with",
        "strpos",
        "translate",
        "regexp_match",
        "regexp_replace",
        "to_hex",
        "chr",
        "array",
        "nullif",
        "coalesce",
        "to_timestamp",
        "to_timestamp_millis",
        "to_timestamp_micros",
        "to_timestamp_seconds",
        "date_part",
        "datepart",
        "extract",
        "date_trunc",
        "now",
        "date_add",
        "date_sub",
        "date_bin",
        "convert_tz",
        "random",
        "isnull",
    }
)


def is_scalar_function(name: str) -> bool:
    return name.lower() in _SCALAR_NAMES


def _array_elem_type(arg_types: list[DataType]) -> DataType:
    """Common element type for array(...): all-string stays string, numerics
    promote pairwise (functions.rs:368 FixedSizeList return-type rule)."""
    if not arg_types:
        raise PlanError("array() requires at least one argument")
    if all(t.is_string for t in arg_types):
        return STRING
    from ..types.dtypes import numeric_common_type

    elem = arg_types[0]
    for t in arg_types[1:]:
        if t == elem:
            continue
        nt = numeric_common_type(elem, t)
        if nt is None:
            raise PlanError(f"array(): incompatible element types {elem} / {t}")
        elem = nt
    return elem


def scalar_return_type(name: str, arg_types: list[DataType]) -> DataType:
    n = name.lower()
    if n in _MATH_UNARY:
        if n in ("abs", "signum", "floor", "ceil", "round", "trunc") and arg_types and (
            arg_types[0].is_integer or arg_types[0].is_decimal
        ):
            return arg_types[0]
        return FLOAT64
    if n in ("power", "pow", "atan2", "random"):
        return FLOAT64
    if n in _STRING_TO_STRING or n in (
        "concat",
        "concat_ws",
        "substr",
        "substring",
        "left",
        "right",
        "lpad",
        "rpad",
        "repeat",
        "replace",
        "split_part",
        "translate",
        "regexp_replace",
        "to_hex",
        "chr",
    ):
        return STRING
    if n in _STRING_TO_INT:
        return INT32
    if n in ("starts_with",):
        return BOOL
    if n in ("strpos",):
        return INT32
    if n in ("regexp_match",):
        return STRING
    if n == "array":
        return DataType(
            "fixed_size_list",
            elem=_array_elem_type(arg_types),
            list_size=len(arg_types),
        )
    if n in ("nullif", "coalesce"):
        for t in arg_types:
            if t != NULLTYPE:
                return t
        return NULLTYPE
    if n in (
        "to_timestamp",
        "to_timestamp_millis",
        "to_timestamp_micros",
        "to_timestamp_seconds",
        "now",
        "date_bin",
        "convert_tz",
    ):
        return TIMESTAMP_US
    if n in ("date_part", "datepart", "extract"):
        return INT32
    if n in ("date_trunc",):
        return arg_types[1] if len(arg_types) > 1 else TIMESTAMP_US
    if n in ("date_add", "date_sub"):
        return arg_types[0] if arg_types else DATE32
    if n in ("isnull",):
        return BOOL
    raise PlanError(f"unknown scalar function '{name}'")


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _gather_lut(lut: np.ndarray, codes: torch.Tensor, memoized: bool = False) -> torch.Tensor:
    """lut[codes] on the codes' device (codes clamped into the table).  A
    ``memoized`` table (from ``derived``) is copied to the device once."""
    idx = torch.clamp(codes, 0, len(lut) - 1).to(torch.int64)
    table = device_table(lut, codes.device) if memoized else to_device(lut, codes.device)
    return table[idx]


def _string_map(col: CVec, fn, out_dtype: DataType) -> CVec:
    """Apply str->str or str->scalar per distinct value, gather on device."""
    d = col.dictionary
    assert d is not None
    key = (str(out_dtype),) + fn_key(fn)
    if out_dtype.is_string:
        nd, remap = derived(d, key, lambda: _map_values(d, fn))
        return CVec(STRING, _gather_lut(remap, col.data, memoized=True), col.valid, nd)
    lut = derived(d, key, lambda: np.array(
        [fn(s) for s in d.values] if len(d) else [0],
        dtype=out_dtype.storage_np_dtype(),
    ))
    return CVec(out_dtype, _gather_lut(lut, col.data, memoized=True), col.valid)


def _map_values(d: StringDict, fn):
    nd, remap = d.map_values(fn)
    return nd, padded(remap)


def _as_host_scalar(col: CVec, fname: str = "", arg: str = "argument"):
    """Host value of a CONSTANT (literal) column.

    Non-constant columns RAISE: silently reading row 0 would apply one
    row's value to every row (column-valued arguments route through
    _combo_map instead)."""
    lit = getattr(col, "literal", None)
    if lit is None:
        raise PlanError(
            f"{fname or 'scalar function'}: the {arg} must be a constant "
            "(literal) — column-valued arguments are not supported here"
        )
    if lit.value is not None and col.dtype.is_string:
        return str(lit.value)
    return lit.value


def _is_literal(col: CVec) -> bool:
    return getattr(col, "literal", None) is not None


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64)


def dispatch_scalar(
    name: str, args: list[CVec], out_dtype: DataType, capacity: int, device=None
) -> CVec:
    """Evaluate scalar function ``name`` over argument columns of
    ``capacity`` rows; ``device`` places the result of a function without
    arguments (``random()``, ``now()``)."""
    n = name.lower()

    # ---- math ----------------------------------------------------------------
    if n in _MATH_UNARY:
        c = args[0]
        if c.dtype.is_decimal:
            from ..exprs.physical import descale

            if n == "abs":
                return CVec(c.dtype, torch.abs(c.data), c.valid)
            if n in ("floor", "ceil", "round", "trunc"):
                scale = 10**c.dtype.scale
                v = _MATH_UNARY[n](descale(_f64(c.data), c.dtype.scale)) * scale
                return CVec(c.dtype, v.to(torch.int64), c.valid)
            data = descale(_f64(c.data), c.dtype.scale)
        else:
            data = c.data
        if out_dtype.is_integer:
            out = _MATH_UNARY[n](data).to(_storage(out_dtype))
            return CVec(out_dtype, out, c.valid)
        return CVec(FLOAT64, _MATH_UNARY[n](_f64(data)), c.valid)
    if n in ("power", "pow"):
        a, b = args
        return CVec(FLOAT64, torch.pow(_f64(a.data), _f64(b.data)), a.valid & b.valid)
    if n == "atan2":
        a, b = args
        return CVec(FLOAT64, torch.atan2(_f64(a.data), _f64(b.data)), a.valid & b.valid)
    if n == "random":
        # drawn on the host per call (non-deterministic like the reference),
        # so a plan that calls it is never replayed as one whole-query run
        refuse_in_whole_query("draws random() on the host")
        out = torch.from_numpy(np.random.rand(capacity)).to(device)
        return CVec(FLOAT64, out, torch.ones(capacity, dtype=torch.bool, device=device))
    if n == "array":
        raise NotImplementedError("fixed-size list columns (array) are ported in slice 5")

    # ---- generic -----------------------------------------------------------
    if n == "nullif":
        a, b = args
        if a.dtype.is_string and b.dtype.is_string:
            from ..exprs.physical import harmonize_strings

            a2, b2 = harmonize_strings(a, b)
            eq = (a2.data == b2.data) & a2.valid & b2.valid
            return CVec(a.dtype, a2.data, a2.valid & ~eq, a2.dictionary)
        eq = (a.data == b.data) & a.valid & b.valid
        return CVec(a.dtype, a.data, a.valid & ~eq, a.dictionary)
    if n == "coalesce":
        from ..exprs.physical import cast_column, harmonize_strings

        out = cast_column(args[0], out_dtype)
        for nxt in args[1:]:
            nxt = cast_column(nxt, out_dtype)
            if out_dtype.is_string:
                out, nxt = harmonize_strings(out, nxt)
            data = K.where_bits(out.valid, out.data, nxt.data)
            out = CVec(out_dtype, data, out.valid | nxt.valid, out.dictionary)
        return out
    if n == "isnull":
        return CVec(BOOL, ~args[0].valid, torch.ones_like(args[0].valid))

    # ---- datetime -------------------------------------------------------------
    from . import datetime_fns as DT

    if n in ("date_part", "datepart", "extract"):
        part = _as_host_scalar(args[0])
        c = args[1]
        if c.dtype == DATE32:
            out = DT.extract_field(str(part), c.data)
        else:
            days, us = DT.timestamp_to_days_us(c.data)
            out = DT.extract_field(str(part), days, us)
        if out.is_floating_point():  # epoch: saturate to int32, as XLA converts
            out = torch.clamp(out, -(2**31), 2**31 - 1)
        return CVec(INT32, out.to(torch.int32), c.valid)
    if n == "date_trunc":
        gran = _as_host_scalar(args[0])
        c = args[1]
        if c.dtype == DATE32:
            return CVec(DATE32, DT.date_trunc_days(str(gran), c.data), c.valid)
        return CVec(TIMESTAMP_US, DT.date_trunc_us(str(gran), c.data), c.valid)
    if n in ("to_timestamp", "to_timestamp_micros", "to_timestamp_seconds", "to_timestamp_millis"):
        from ..exprs.physical import cast_column

        c = args[0]
        per = {"to_timestamp_seconds": 1_000_000, "to_timestamp_millis": 1000}.get(n)
        if per is not None and c.dtype.is_integer:
            return CVec(TIMESTAMP_US, c.data.to(torch.int64) * per, c.valid)
        return cast_column(c, TIMESTAMP_US)
    if n == "convert_tz":
        # fork cube_ext semantics (datetime_expressions.rs:51-113):
        # shift '+HH:MM' applied as (hour*60 + signum(hour)*minute) minutes
        c, sh = args[0], args[1]

        def _shift_us(s: str) -> int:
            hm = str(s).split(":")
            if len(hm) != 2:
                raise PlanError(f"Can't parse timezone shift '{s}'")
            try:
                h, m = int(hm[0]), int(hm[1])
            except ValueError:
                raise PlanError(f"Can't parse timezone shift '{s}'")
            sig = 1 if h > 0 else (-1 if h < 0 else 0)
            return (h * 60 + sig * m) * 60 * 1_000_000

        if _is_literal(sh):
            off = _shift_us(_as_host_scalar(sh, n, "shift"))
            return CVec(TIMESTAMP_US, c.data + off, c.valid & sh.valid)
        lut = _string_map(sh, _shift_us, INT64)
        return CVec(TIMESTAMP_US, c.data + lut.data, c.valid & sh.valid)
    if n == "now":
        import time

        now_us = int(time.time() * 1e6)
        return CVec(
            TIMESTAMP_US,
            torch.full((capacity,), now_us, dtype=torch.int64, device=device),
            torch.ones(capacity, dtype=torch.bool, device=device),
        )

    # ---- string: single-column str->str / str->int via dictionary LUT ------
    if n in _STRING_TO_STRING:
        return _string_map(args[0], _STRING_TO_STRING[n], STRING)
    if n in _STRING_TO_INT:
        return _string_map(args[0], _STRING_TO_INT[n], INT32)

    # string fns whose extra args are COLUMNS: distinct-combo evaluation
    # (the reference evaluates these vectorized per row,
    # string_expressions.rs; here fn runs once per distinct combination)
    if n in _ROW_FNS and len(args) > 1 and not all(_is_literal(a) for a in args[1:]):
        return _combo_map(args, _ROW_FNS[n], out_dtype)

    # string fns with scalar (literal) extra args -> still per-distinct-value
    if n in ("substr", "substring"):
        start = int(_as_host_scalar(args[1]))
        length = int(_as_host_scalar(args[2])) if len(args) > 2 else None
        return _string_map(args[0], lambda s: _sql_substr(s, start, length), STRING)
    if n in ("left", "right", "repeat"):
        k = int(_as_host_scalar(args[1]))
        return _string_map(args[0], lambda s: _ROW_FNS[n](s, k), STRING)
    if n in ("lpad", "rpad"):
        k = int(_as_host_scalar(args[1]))
        fill = str(_as_host_scalar(args[2])) if len(args) > 2 else " "
        return _string_map(args[0], lambda s: _ROW_FNS[n](s, k, fill), STRING)
    if n in ("replace", "translate"):
        frm = str(_as_host_scalar(args[1]))
        to = str(_as_host_scalar(args[2]))
        return _string_map(args[0], lambda s: _ROW_FNS[n](s, frm, to), STRING)
    if n == "split_part":
        delim = str(_as_host_scalar(args[1]))
        idx = int(_as_host_scalar(args[2]))
        return _string_map(args[0], lambda s: _sql_split_part(s, delim, idx), STRING)
    if n == "starts_with":
        prefix = str(_as_host_scalar(args[1]))
        d = args[0].dictionary
        assert d is not None
        lut = derived(d, ("starts_with", prefix),
                      lambda: padded(d.predicate_lut(lambda s: s.startswith(prefix))))
        return CVec(BOOL, _gather_lut(lut, args[0].data, memoized=True), args[0].valid)
    if n == "strpos":
        sub = str(_as_host_scalar(args[1]))
        return _string_map(args[0], lambda s: s.find(sub) + 1, INT32)
    if n == "regexp_replace":
        pat = str(_as_host_scalar(args[1]))
        rep = str(_as_host_scalar(args[2]))
        rx = _re.compile(pat)
        count = 1
        if len(args) > 3 and "g" in str(_as_host_scalar(args[3])):
            count = 0
        return _string_map(args[0], lambda s: rx.sub(rep, s, count=count), STRING)
    if n == "regexp_match":
        pat = str(_as_host_scalar(args[1]))
        return _string_map(args[0], lambda s: _sql_regexp_match(s, pat), STRING)
    if n == "to_hex":
        return _int_map_by_unique(args[0], lambda v: format(int(v), "x"))
    if n == "chr":
        return _int_map_by_unique(args[0], lambda v: chr(int(v)))
    if n in ("concat", "concat_ws"):
        return _concat_columns(n, args)

    raise PlanError(f"scalar function '{name}' not implemented")


def _storage(dt: DataType) -> torch.dtype:
    from ..device import torch_dtype

    return torch_dtype(dt.storage_np_dtype())


def _distinct(data: torch.Tensor):
    """(the distinct values of a column buffer as a host array, never
    empty; each row's index into them on the device): the unique runs on
    the device and only the distinct values cross to the host."""
    uniq, inv = K.unique_bits(data)
    host = host_numpy(uniq)
    if len(host) == 0:
        host, inv = np.zeros(1, host.dtype), torch.zeros_like(data, dtype=torch.int64)
    return host, inv


def _int_map_by_unique(col: CVec, fn) -> CVec:
    """int column -> string column, computing fn once per DISTINCT value."""
    uniq, inv = _distinct(col.data)
    d, ucodes = StringDict.from_strings([fn(v) for v in uniq])
    return CVec(STRING, _gather_lut(ucodes, inv), col.valid, d)


def _format_values(uniq: np.ndarray, dt: DataType) -> list:
    """Distinct values of a non-string column as concat prints them."""
    if dt.is_decimal:
        return [f"{v / 10**dt.scale:.{dt.scale}f}" for v in uniq]
    if dt == DATE32:
        return [str(np.datetime64(int(v), "D")) for v in uniq]
    if dt == TIMESTAMP_US:
        return [str(np.datetime64(int(v), "us")) for v in uniq]
    if dt.is_bool:
        return [("true" if v else "false") for v in uniq]
    return [str(v) for v in uniq]


def _typed_values(uniq: np.ndarray, dt: DataType) -> list:
    """Distinct values of a non-string column as Python values."""
    if dt.is_decimal:
        return [v / 10**dt.scale for v in uniq.tolist()]
    if dt.is_float:
        return [float(v) for v in uniq]
    if dt.is_bool:
        return [bool(v) for v in uniq]
    return [int(v) for v in uniq]


def _col_codes(col: CVec, values_of):
    """(each row's code on the device, -1 where null; the host value behind
    each code).  String columns pass their dictionary codes through; other
    columns reduce to their distinct values, which ``values_of`` turns into
    host values."""
    if col.dtype.is_string:
        vals = list(col.dictionary.values) if col.dictionary and len(col.dictionary) else [""]
        codes = torch.clamp(col.data.to(torch.int64), 0, len(vals) - 1)
    else:
        uniq, codes = _distinct(col.data)
        vals = values_of(uniq, col.dtype)
    return torch.where(col.valid, codes, -1), vals


def _distinct_combos(cols: list[CVec], values_of):
    """(the distinct rows of the columns' codes as a host [k, ncols] array,
    -1 for a null; the host values behind each column's codes; each row's
    index into the combinations on the device)."""
    codes, values_l = zip(*(_col_codes(c, values_of) for c in cols))
    combos, inv = torch.unique(torch.stack(codes, dim=1), dim=0, return_inverse=True)
    return host_numpy(combos), values_l, inv


def _combo_map(cols: list[CVec], fn, out_dtype: DataType) -> CVec:
    """Vectorized multi-column scalar function: fn runs once per distinct
    combination of argument values, and the results go back to the rows by
    one device gather.  Null in any argument nulls the row (standard SQL
    scalar-function semantics)."""
    combos, values_l, inv = _distinct_combos(cols, _typed_values)
    valid = cols[0].valid
    for c in cols[1:]:
        valid = valid & c.valid
    results = [
        fn(*[values_l[j][int(cd)] for j, cd in enumerate(row)]) if (row >= 0).all() else None
        for row in combos
    ]
    if out_dtype.is_string:
        d, ucodes = StringDict.from_strings(["" if r is None else r for r in results])
        return CVec(STRING, _gather_lut(ucodes, inv), valid, d)
    lut = np.array([0 if r is None else r for r in results], dtype=out_dtype.storage_np_dtype())
    return CVec(out_dtype, _gather_lut(lut, inv), valid)


def _sql_substr(s, start, length=None):
    lo = max(int(start) - 1, 0)
    if length is None:
        return s[lo:]
    if length < 0:
        raise PlanError("substr: negative substring length not allowed")
    # negative start consumes length before the string begins (postgres)
    end = int(start) - 1 + int(length)
    return s[lo:max(end, lo)]


def _sql_lpad(s, k, fill=" "):
    k = int(k)
    if len(s) >= k:
        return s[:k]
    return (fill * k)[: k - len(s)] + s if fill else s


def _sql_rpad(s, k, fill=" "):
    k = int(k)
    if len(s) >= k:
        return s[:k]
    return s + (fill * k)[: k - len(s)] if fill else s


def _sql_split_part(s, delim, idx):
    parts = s.split(delim)
    return parts[int(idx) - 1] if 1 <= int(idx) <= len(parts) else ""


def _sql_translate(s, frm, to):
    tbl = str.maketrans(frm[: len(to)], to[: len(frm)], frm[len(to):])
    return s.translate(tbl)


def _sql_regexp_replace(s, pat, rep, flags=""):
    count = 0 if "g" in flags else 1
    return _re.compile(pat).sub(rep, s, count=count)


def _sql_regexp_match(s, pat):
    m = _re.compile(pat).search(s)
    return m.group(0) if m else ""


# row-semantics table for column-argument dispatch (_combo_map); the
# literal-argument paths of dispatch_scalar stay per-distinct-dictionary-value
_ROW_FNS: dict[str, Callable] = {
    "substr": _sql_substr,
    "substring": _sql_substr,
    "left": lambda s, k: s[: int(k)] if k >= 0 else s[: len(s) + int(k)],
    "right": lambda s, k: s[-int(k):] if k > 0 else (s[-int(k) - len(s):] if k < 0 else ""),
    "repeat": lambda s, k: s * int(k),
    "lpad": _sql_lpad,
    "rpad": _sql_rpad,
    "replace": lambda s, frm, to: s.replace(frm, to),
    "translate": _sql_translate,
    "split_part": _sql_split_part,
    "starts_with": lambda s, p: s.startswith(p),
    "strpos": lambda s, sub: s.find(sub) + 1,
    "regexp_replace": _sql_regexp_replace,
    "regexp_match": _sql_regexp_match,
}


def _concat_columns(n: str, args: list[CVec]) -> CVec:
    """concat / concat_ws via distinct-combo pairing: rows reduce to code
    tuples, a device unique finds the distinct combinations, and strings
    materialize once per combination.

    Null semantics mirror the reference (string_expressions.rs concat):
    null arguments contribute nothing and the result is never null."""
    sep = ""
    cols = args
    if n == "concat_ws":
        sep = _as_host_scalar(args[0], "concat_ws", "separator")
        cols = args[1:]
        if sep is None:
            like = (cols[0] if cols else args[0]).data
            return CVec(
                STRING,
                torch.zeros_like(like, dtype=torch.int32),
                torch.zeros_like(like, dtype=torch.bool),
                StringDict.empty(),
            )
        sep = str(sep)
    combos, values_l, inv = _distinct_combos(cols, _format_values)
    strs = []
    for row in combos:
        parts = [values_l[j][int(c)] for j, c in enumerate(row) if c >= 0]
        strs.append("".join(parts) if n == "concat" else sep.join(parts))
    d, ucodes = StringDict.from_strings(strs)
    like = cols[0].data
    return CVec(STRING, _gather_lut(ucodes, inv), torch.ones_like(like, dtype=torch.bool), d)
