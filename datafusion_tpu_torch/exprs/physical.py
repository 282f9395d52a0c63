"""Physical expressions: vectorized, null-propagating evaluation over device
columns.

Port of ``datafusion_tpu/exprs/physical.py`` to eager torch: each node
evaluates as whole-column tensor ops on the table's device (reference
equivalents in datafusion/src/physical_plan/expressions/: Column, Literal,
BinaryExpr, CaseExpr, CastExpr/TryCastExpr, InListExpr,
IsNull/IsNotNull/Not/Negative, LIKE).  User-defined scalar functions
(``PhysScalarUDF``) are ported in slice 5.

String semantics ride on sorted dictionaries (columnar/dictionary.py):
- col <op> col -> harmonize dictionaries (host merge), then an integer
  compare of remapped codes;
- LIKE / string functions -> a per-distinct-value host computation shipped
  as a code-indexed lookup table, applied with one device gather;
- a cast to a string formats each distinct value on the host (the unique
  and the gather stay on the device).

Null semantics follow SQL three-valued logic (Kleene AND/OR).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..columnar.column import Column as CVec
from ..columnar.dictionary import StringDict
from ..columnar.table import BUILD, Table, host_numpy, refuse_in_whole_query
from ..device import torch_dtype
from ..errors import ExecutionError, PlanError
from ..ops import kernels as K
from ..types import ScalarValue
from ..types.dtypes import (
    DECIMAL_MAX_PRECISION,
    BOOL,
    DATE32,
    FLOAT64,
    INT64,
    INTERVAL_DT,
    INTERVAL_YM,
    NULLTYPE,
    STRING,
    TIMESTAMP_US,
    DataType,
    decimal,
    numeric_common_type,
)

# ---------------------------------------------------------------------------
# base
# ---------------------------------------------------------------------------


def _tdt(dtype: DataType) -> torch.dtype:
    return torch_dtype(dtype.storage_np_dtype())


def descale(x: torch.Tensor, scale: int) -> torch.Tensor:
    """float64 x / 10**scale as the reference's compiled programs compute
    it: XLA rewrites a division by a constant into a multiplication by its
    float64 reciprocal, and the port does the same so both engines give
    the same bits."""
    return x * (1.0 / 10**scale) if scale else x


class PhysicalExpr:
    """Evaluate against a Table -> Column of the same capacity."""

    dtype: DataType

    def evaluate(self, table: Table) -> CVec:
        raise NotImplementedError

    def children(self) -> list["PhysicalExpr"]:
        return []

    def needs_host(self) -> bool:
        """True when evaluation must read column DATA on the host: such
        expressions cannot join a fused stage."""
        return any(c.needs_host() for c in self.children())


def _const_column(
    capacity: int, sv: ScalarValue, device, dictionary: StringDict | None = None
) -> CVec:
    dt = sv.dtype
    if sv.is_null:
        return CVec(
            dt,
            torch.zeros(capacity, dtype=_tdt(dt), device=device),
            torch.zeros(capacity, dtype=torch.bool, device=device),
            dictionary,
            literal=sv,
        )
    if dt.is_string:
        d = dictionary
        if d is None or d.code_of(sv.value) is None:
            d = _literal_dict(sv.value)
            code = 0
        else:
            code = d.code_of(sv.value)
        return CVec(
            dt,
            torch.full((capacity,), code, dtype=torch.int32, device=device),
            torch.ones(capacity, dtype=torch.bool, device=device),
            d,
            literal=sv,
        )
    return CVec(
        dt,
        torch.full((capacity,), sv.value, dtype=_tdt(dt), device=device),
        torch.ones(capacity, dtype=torch.bool, device=device),
        literal=sv,
    )


# one dictionary per string literal: a literal keeps one identity from run
# to run, so the merges and tables derived from it are memo hits
_LITERAL_DICTS: dict = {}


def _literal_dict(value: str) -> StringDict:
    d = _LITERAL_DICTS.get(value)
    if d is None:
        if len(_LITERAL_DICTS) > 4096:
            _LITERAL_DICTS.clear()
        d = _LITERAL_DICTS[value] = StringDict(np.array([value], dtype=object))
    return d


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------


@dataclass
class PhysCol(PhysicalExpr):
    name: str
    index: int
    dtype: DataType

    def evaluate(self, table: Table) -> CVec:
        return table.columns[self.index]

    def __repr__(self):
        return f"{self.name}@{self.index}"


@dataclass
class PhysLit(PhysicalExpr):
    value: ScalarValue

    @property
    def dtype(self) -> DataType:
        return self.value.dtype

    def evaluate(self, table: Table) -> CVec:
        return _const_column(table.capacity, self.value, table.device)

    def __repr__(self):
        return repr(self.value)


# ---------------------------------------------------------------------------
# helpers: casting / harmonization
# ---------------------------------------------------------------------------


def cast_column(col: CVec, to: DataType, capacity: int | None = None, safe: bool = False) -> CVec:
    """Cast a column to another type (CastExpr equivalent, cast.rs)."""
    frm = col.dtype
    if frm == to:
        return col
    data, valid = col.data, col.valid
    if frm == NULLTYPE:
        return CVec(
            to,
            torch.zeros(data.shape[0], dtype=_tdt(to), device=data.device),
            torch.zeros(data.shape[0], dtype=torch.bool, device=data.device),
            StringDict.empty() if to.is_string else None,
        )

    # ---- from string: decode via dictionary (host, per distinct value) ----
    if frm.is_string:
        d = col.dictionary
        assert d is not None
        if to.is_string:
            return col
        return _cast_from_string(col, d, to, safe)

    if to.is_string:
        return _cast_to_string(col)

    # ---- numeric/temporal device casts -------------------------------------
    if frm.is_decimal and to.is_decimal:
        ds = to.scale - frm.scale
        if ds >= 0:
            new = data * (10**ds)
        else:
            new = _div_round_half_away(data, 10 ** (-ds))
        return CVec(to, new.to(_tdt(to)), valid)
    if frm.is_decimal:
        f = descale(data.to(torch.float64), frm.scale)
        if to.is_float:
            return CVec(to, f.to(_tdt(to)), valid)
        if to.is_integer:
            return CVec(to, torch.trunc(f).to(_tdt(to)), valid)
        if to.is_bool:
            return CVec(to, data != 0, valid)
    if to.is_decimal:
        if frm.is_integer or frm.is_bool:
            return CVec(to, data.to(torch.int64) * (10**to.scale), valid)
        if frm.is_float:
            scaled = torch.round(data.to(torch.float64) * (10**to.scale))
            return CVec(to, scaled.to(torch.int64), valid)
    if frm == DATE32 and to == TIMESTAMP_US:
        us = data.to(torch.int64) * 86_400_000_000
        return CVec(to, us, valid)
    if frm == TIMESTAMP_US and to == DATE32:
        days = torch.div(data, 86_400_000_000, rounding_mode="floor")
        return CVec(to, days.to(torch.int32), valid)
    # plain numeric/bool cast
    return CVec(to, data.to(_tdt(to)), valid)


def _cast_from_string(col: CVec, d: StringDict, to: DataType, safe: bool) -> CVec:
    lut, ok = derived(d, ("cast", str(to), safe), lambda: _cast_tables(d, to, safe))
    dev = col.data.device
    codes = torch.clamp(col.data, 0, len(lut) - 1).to(torch.int64)
    new_data = device_table(lut, dev)[codes]
    new_valid = col.valid & device_table(ok, dev)[codes]
    return CVec(to, new_data, new_valid)


def _cast_tables(d: StringDict, to: DataType, safe: bool):
    """(value, parsed) per dictionary code of a cast from strings."""

    def parse(s: str):
        try:
            if to.is_integer:
                return int(s)
            if to.is_float:
                return float(s)
            if to.is_decimal:
                return int(round(float(s) * 10 ** to.scale))
            if to == DATE32:
                return (np.datetime64(s, "D") - np.datetime64(0, "D")).astype(int)
            if to == TIMESTAMP_US:
                return (np.datetime64(s, "us") - np.datetime64(0, "us")).astype(int)
            if to.is_bool:
                return s.lower() in ("t", "true", "1", "yes")
        except (ValueError, TypeError):
            return None
        return None

    lut_vals = [parse(s) for s in d.values]
    ok = np.array([v is not None for v in lut_vals], dtype=bool)
    if not safe and not ok.all() and len(ok):
        bad = [s for s, o in zip(d.values, ok) if not o]
        raise ExecutionError(f"cannot cast {bad[:3]} to {to!r}")
    lut = np.array(
        [v if v is not None else 0 for v in lut_vals],
        dtype=to.storage_np_dtype(),
    )
    if len(lut) == 0:
        lut = np.zeros(1, dtype=to.storage_np_dtype())
        ok = np.zeros(1, dtype=bool)
    return lut, ok


def _cast_to_string(col: CVec) -> CVec:
    """Format each distinct value that a valid row holds on the host, as
    the reference formats each row: the unique and the gather of the codes
    run on the device, and only the distinct values cross to the host."""
    frm = col.dtype
    uniq, inv = K.unique_bits(col.data)  # bits: -0.0 and 0.0 format apart
    held = torch.zeros(uniq.shape[0], dtype=torch.int8, device=uniq.device)
    held = held.scatter_reduce_(0, inv, col.valid.to(torch.int8), "amax")
    used = host_numpy(held).astype(bool)
    vals = host_numpy(uniq)[used]
    if frm.is_decimal:
        strs = [f"{v / 10**frm.scale:.{frm.scale}f}" for v in vals]
    elif frm == DATE32:
        strs = [str(np.datetime64(int(v), "D")) for v in vals]
    else:
        strs = [str(v) for v in vals]
    d, ucodes = StringDict.from_strings(strs)
    lut = np.zeros(len(used), dtype=np.int32)
    lut[used] = ucodes
    return CVec(STRING, to_device(lut, col.data.device)[inv], col.valid, d)


def _div_round_half_away(x: torch.Tensor, d: int) -> torch.Tensor:
    """Integer division with round-half-away-from-zero (SQL decimal style)."""
    sign = torch.where(x < 0, -1, 1).to(x.dtype)
    return sign * torch.div(torch.abs(x) + d // 2, d, rounding_mode="floor")


def to_device(values: np.ndarray, device) -> torch.Tensor:
    """A fresh copy of a host array on ``device``.  To the card it goes
    from pinned memory without waiting, so it is not a sync (the
    whole-query check runs with torch's synchronization check on)."""
    t = torch.from_numpy(np.ascontiguousarray(values))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# host tables copied to a device, one copy per (table, device).  Each table
# comes from a memo (``derived``, ``StringDict.merge``) and keeps one
# identity, so a warm run copies nothing: a whole-query run, which a CUDA
# graph captures, must not copy from the host, and reads these copies in
# place (a capture keeps every copy alive: ``device_tables``)
_ON_DEVICE: dict = {}


def device_table(values: np.ndarray, device) -> torch.Tensor:
    """``values``, a memoized host array, on ``device``.  The entry holds
    the array, so its id cannot be reused while the entry lives."""
    key = (id(values), str(device))
    hit = _ON_DEVICE.get(key)
    if hit is None or hit[0] is not values:
        if BUILD.strict:
            refuse_in_whole_query("copies a host table to the device")
        if len(_ON_DEVICE) > 4096:
            _ON_DEVICE.clear()
        hit = _ON_DEVICE[key] = (values, to_device(values, device))
    return hit[1]


def device_tables() -> list:
    """Every device table held now: those a capture reads are among them,
    since a capture copies none (``BUILD.strict``)."""
    return [t for _, t in _ON_DEVICE.values()]


# what a host function gives over a dictionary's values (a LIKE's LUT, a
# string function's new dictionary and remap), per dictionary and function:
# dictionaries are immutable, so each is computed once, and a derived
# dictionary keeps one identity from run to run, which the fused tails'
# per-input dictionary caches (``CompiledStage._out_dicts``) key on
_DERIVED: dict = {}


def derived(d: StringDict, key: tuple, build):
    """``build()``, memoized on (dictionary, ``key``); ``key`` names the
    function and its literal arguments."""
    k = (d._id,) + key
    hit = _DERIVED.get(k)
    if hit is None:
        if len(_DERIVED) > 4096:
            _DERIVED.clear()
        hit = _DERIVED[k] = build()
    return hit


def fn_key(fn) -> tuple:
    """A host function's memo key: its code and the literal arguments it
    closed over (a builtin is its own key)."""
    if not hasattr(fn, "__code__"):
        return (fn,)
    return (fn.__code__, tuple(c.cell_contents for c in fn.__closure__ or ()))


def harmonize_strings(a: CVec, b: CVec) -> tuple[CVec, CVec]:
    """Remap two string columns onto one merged sorted dictionary."""
    assert a.dictionary is not None and b.dictionary is not None
    if a.dictionary is b.dictionary:
        return a, b
    merged, ra, rb = StringDict.merge(a.dictionary, b.dictionary)
    dev = a.data.device
    ja = device_table(ra, dev) if len(ra) else torch.zeros(1, dtype=torch.int32, device=dev)
    jb = device_table(rb, dev) if len(rb) else torch.zeros(1, dtype=torch.int32, device=dev)
    ia = torch.clamp(a.data, 0, max(len(ra) - 1, 0)).to(torch.int64)
    ib = torch.clamp(b.data, 0, max(len(rb) - 1, 0)).to(torch.int64)
    return CVec(a.dtype, ja[ia], a.valid, merged), CVec(b.dtype, jb[ib], b.valid, merged)


# ---------------------------------------------------------------------------
# binary
# ---------------------------------------------------------------------------


@dataclass
class PhysBinary(PhysicalExpr):
    left: PhysicalExpr
    op: str
    right: PhysicalExpr
    dtype: DataType

    def children(self):
        return [self.left, self.right]

    def evaluate(self, table: Table) -> CVec:
        l = self.left.evaluate(table)
        r = self.right.evaluate(table)
        op = self.op

        if op in ("and", "or"):
            return _kleene(l, r, op)

        # an untyped NULL operand makes the whole result NULL
        if l.dtype == NULLTYPE or r.dtype == NULLTYPE:
            cap = l.data.shape[0]
            return CVec(
                self.dtype,
                torch.zeros(cap, dtype=_tdt(self.dtype), device=l.data.device),
                torch.zeros(cap, dtype=torch.bool, device=l.data.device),
            )

        # string comparisons via dictionary codes
        if l.dtype.is_string and r.dtype.is_string:
            if op in ("like", "not like"):
                return _like(l, r, negated=(op == "not like"))
            l, r = harmonize_strings(l, r)
            return _compare(l.data, r.data, l.valid & r.valid, op)

        if op in ("like", "not like"):
            raise PlanError("LIKE requires string operands")

        # implicit string -> temporal/numeric coercion (type_coercion.rs)
        if l.dtype.is_string and (r.dtype.is_temporal or r.dtype.is_numeric):
            l = cast_column(l, r.dtype)
        elif r.dtype.is_string and (l.dtype.is_temporal or l.dtype.is_numeric):
            r = cast_column(r, l.dtype)
        if (
            l.dtype.is_temporal
            and r.dtype.is_temporal
            and l.dtype != r.dtype
            and op in ("=", "!=", "<", "<=", ">", ">=")
        ):
            if l.dtype == DATE32:
                l = cast_column(l, r.dtype)
            elif r.dtype == DATE32:
                r = cast_column(r, l.dtype)

        # temporal arithmetic
        t = _temporal_arith(l, r, op)
        if t is not None:
            return t

        # numeric coercion
        common = numeric_common_type(l.dtype, r.dtype)
        if common is None and l.dtype == r.dtype:
            common = l.dtype
        if common is None:
            raise PlanError(f"cannot apply {op} to {l.dtype!r}, {r.dtype!r}")

        if op in ("=", "!=", "<", "<=", ">", ">="):
            # decimal vs float LITERAL: compare on the scaled-int axis with
            # an exact host-computed threshold
            out = _decimal_float_literal_compare(l, r, op)
            if out is not None:
                return out
            lc = cast_column(l, common)
            rc = cast_column(r, common)
            return _compare(lc.data, rc.data, lc.valid & rc.valid, op)

        # arithmetic
        valid = l.valid & r.valid
        if common.is_decimal and op in ("+", "-", "*", "/", "%"):
            return _decimal_arith(l, r, op, valid)
        lc = cast_column(l, common)
        rc = cast_column(r, common)
        a, b = _unsigned_operands(lc.data, rc.data)
        if op == "+":
            out = a + b
        elif op == "-":
            out = a - b
        elif op == "*":
            out = a * b
        elif op == "/":
            if common.is_integer:
                out = _trunc_div(a, b)
                valid = valid & (b != 0)
            else:
                out = a / b
        elif op == "%":
            if common.is_float:
                safe_b = torch.where(b == 0, torch.ones_like(b), b)
                out = torch.where(b == 0, torch.full_like(a, math.nan), torch.fmod(a, safe_b))
            else:
                safe_b = torch.where(b == 0, torch.ones_like(b), b)
                out = a - safe_b * _trunc_div(a, b)
                valid = valid & (b != 0)
        else:
            raise PlanError(f"unknown operator {op}")
        return CVec(self.dtype, out.to(_tdt(self.dtype)), valid)

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


def _trunc_div(a, b):
    """Integer division truncating toward zero (SQL semantics); b==0 slots
    produce garbage that callers mask via validity."""
    sb = torch.where(b == 0, torch.ones_like(b), b)
    return torch.div(a, sb, rounding_mode="trunc").to(a.dtype)


def _unsigned_operands(a, b):
    """Operands torch can compute with (it has no CUDA arithmetic for
    uint16/32/64): uint16 and uint32 widen to int64, exactly; uint64 takes
    its signed view, whose + - * wrap to the same bits (its / and % then
    read values from 2^63 up as negative: a port fault)."""
    if a.dtype in (torch.uint16, torch.uint32):
        return a.to(torch.int64), b.to(torch.int64)
    return K.signed_view(a), K.signed_view(b)


def _unsigned_order(x):
    """A signed tensor in x's unsigned order (uint64: the top bit flipped)."""
    if x.dtype == torch.uint64:
        return torch.bitwise_xor(x.view(torch.int64), -(2**63))
    return x.to(torch.int64)


def _compare(a, b, valid, op) -> CVec:
    if a.dtype in (torch.uint16, torch.uint32, torch.uint64):
        a, b = _unsigned_order(a), _unsigned_order(b)
    if op == "=":
        out = a == b
    elif op == "!=":
        out = a != b
    elif op == "<":
        out = a < b
    elif op == "<=":
        out = a <= b
    elif op == ">":
        out = a > b
    else:
        out = a >= b
    return CVec(BOOL, out, valid)


def _kleene(l: CVec, r: CVec, op: str) -> CVec:
    """SQL three-valued AND/OR (arrow's and_kleene/or_kleene)."""
    a = l.data.to(torch.bool)
    b = r.data.to(torch.bool)
    av, bv = l.valid, r.valid
    if op == "and":
        out = a & b
        valid = (av & bv) | (av & ~a) | (bv & ~b)
    else:
        out = a | b
        valid = (av & bv) | (av & a) | (bv & b)
    return CVec(BOOL, out, valid)


def _temporal_arith(l: CVec, r: CVec, op: str) -> Optional[CVec]:
    lt, rt = l.dtype, r.dtype
    valid = l.valid & r.valid
    # date/timestamp +- interval
    for a, b, flip in ((l, r, False), (r, l, True)):
        if a.dtype in (DATE32, TIMESTAMP_US) and b.dtype in (INTERVAL_YM, INTERVAL_DT):
            if flip and op == "-":
                return None  # interval - date is invalid
            sign = 1 if op == "+" else -1
            if b.dtype == INTERVAL_DT:
                ms = b.data.to(torch.int64) * sign
                if a.dtype == DATE32:
                    days = torch.div(ms, 86_400_000, rounding_mode="floor")
                    return CVec(DATE32, (a.data + days).to(torch.int32), valid)
                return CVec(TIMESTAMP_US, a.data + ms * 1000, valid)
            # interval months: calendar-aware add
            from ..functions.datetime_fns import add_months_days

            months = b.data.to(torch.int32) * sign
            if a.dtype == DATE32:
                return CVec(DATE32, add_months_days(a.data, months), valid)
            days = torch.div(a.data, 86_400_000_000, rounding_mode="floor").to(torch.int32)
            rem = a.data - days.to(torch.int64) * 86_400_000_000
            nd = add_months_days(days, months)
            return CVec(TIMESTAMP_US, nd.to(torch.int64) * 86_400_000_000 + rem, valid)
    if lt == DATE32 and rt == DATE32 and op == "-":
        return CVec(INT64, l.data.to(torch.int64) - r.data.to(torch.int64), valid)
    if lt == TIMESTAMP_US and rt == TIMESTAMP_US and op == "-":
        ms = torch.div(l.data - r.data, 1000, rounding_mode="floor")
        return CVec(INTERVAL_DT, ms, valid)
    if lt in (INTERVAL_YM, INTERVAL_DT) and rt == lt and op in ("+", "-"):
        out = l.data + r.data if op == "+" else l.data - r.data
        return CVec(lt, out, valid)
    return None


_FLIP_OP = {"=": "=", "!=": "!=", "<": ">", "<=": ">=", ">": "<", ">=": "<="}


_DEC_CMP_BOUND = 10**18  # |int64 decimal storage| bound for threshold search


def _dec_ge_threshold(x: float, s: int) -> int:
    """min integer d with double(d/s) >= x (python's d/s IS the correctly
    rounded IEEE double, monotone non-decreasing in d)."""
    lo, hi = -_DEC_CMP_BOUND, _DEC_CMP_BOUND
    while lo < hi:
        mid = (lo + hi) // 2
        if mid / s >= x:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _dec_le_threshold(x: float, s: int) -> int:
    """max integer d with double(d/s) <= x."""
    lo, hi = -_DEC_CMP_BOUND, _DEC_CMP_BOUND
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if mid / s <= x:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _decimal_float_literal_compare(l: CVec, r: CVec, op: str) -> CVec | None:
    """decimal column OP float literal with EXACT float-comparison
    semantics: the result equals comparing double(d / 10^scale) against the
    f64 literal for every row, evaluated as an integer threshold compare on
    the scaled storage.  Thresholds come from a host-side binary search using
    python's correctly-rounded int/int -> double division.  Returns None
    when the pattern does not apply."""
    if l.dtype.is_decimal and r.dtype.is_float and getattr(r, "literal", None) is not None:
        dec, lit = l, r.literal.value
    elif r.dtype.is_decimal and l.dtype.is_float and getattr(l, "literal", None) is not None:
        dec, lit = r, l.literal.value
        op = _FLIP_OP[op]
    else:
        return None
    if lit is None:
        z = torch.zeros_like(dec.valid)
        return CVec(BOOL, z, z)
    x = float(lit)
    valid = dec.valid & (l.valid & r.valid)
    d = dec.data.to(torch.int64)
    if math.isnan(x):
        out = torch.full_like(valid, op == "!=")
        return CVec(BOOL, out, valid)
    s = 10 ** dec.dtype.scale
    if op in ("=", "!="):
        ge, le = _dec_ge_threshold(x, s), _dec_le_threshold(x, s)
        eq = (d >= ge) & (d <= le) if ge <= le else torch.zeros_like(valid)
        return CVec(BOOL, eq if op == "=" else ~eq, valid)
    if op == ">=":
        return CVec(BOOL, d >= _dec_ge_threshold(x, s), valid)
    if op == ">":
        return CVec(BOOL, d > _dec_le_threshold(x, s), valid)
    if op == "<=":
        return CVec(BOOL, d <= _dec_le_threshold(x, s), valid)
    if op == "<":
        return CVec(BOOL, d < _dec_ge_threshold(x, s), valid)
    return None


def _decimal_arith(l: CVec, r: CVec, op: str, valid) -> CVec:
    """Exact decimal arithmetic on scaled ints (wrapping int64, like the
    reference)."""
    ls = l.dtype.scale if l.dtype.is_decimal else 0
    rs = r.dtype.scale if r.dtype.is_decimal else 0
    if not l.dtype.is_decimal:
        l = cast_column(l, decimal(DECIMAL_MAX_PRECISION, 0))
    if not r.dtype.is_decimal:
        r = cast_column(r, decimal(DECIMAL_MAX_PRECISION, 0))
    a = l.data.to(torch.int64)
    b = r.data.to(torch.int64)
    if op in ("+", "-"):
        s = max(ls, rs)
        a = a * (10 ** (s - ls))
        b = b * (10 ** (s - rs))
        out = a + b if op == "+" else a - b
        return CVec(decimal(DECIMAL_MAX_PRECISION, s), out, valid)
    if op == "*":
        return CVec(decimal(DECIMAL_MAX_PRECISION, ls + rs), a * b, valid)
    if op == "/":
        # decimal division computed in float64 (reference promotes too)
        fa = descale(a.to(torch.float64), ls)
        fb = descale(b.to(torch.float64), rs)
        ok = b != 0
        out = torch.where(ok, fa / torch.where(ok, fb, torch.ones_like(fb)), torch.zeros_like(fa))
        return CVec(FLOAT64, out, valid & ok)
    if op == "%":
        s = max(ls, rs)
        a = a * (10 ** (s - ls))
        b = b * (10 ** (s - rs))
        ok = b != 0
        sb = torch.where(ok, b, torch.ones_like(b))
        out = torch.sign(a) * torch.remainder(torch.abs(a), torch.abs(sb))
        return CVec(decimal(DECIMAL_MAX_PRECISION, s), out, valid & ok)
    raise PlanError(f"decimal op {op}")


def _like(l: CVec, r: CVec, negated: bool) -> CVec:
    """LIKE col vs literal pattern: compile the pattern once per distinct
    value of the column's dictionary (host), gather LUT on device."""
    pat_dict = r.dictionary
    assert pat_dict is not None and len(pat_dict) >= 1
    regex = _like_regex(str(pat_dict.values[0]))
    d = l.dictionary
    assert d is not None
    lut = derived(d, ("like", regex.pattern, negated), lambda: padded(
        d.predicate_lut(lambda s: bool(regex.match(s)) != negated)))
    codes = torch.clamp(l.data, 0, len(lut) - 1).to(torch.int64)
    return CVec(BOOL, device_table(lut, l.data.device)[codes], l.valid & r.valid)


def padded(lut: np.ndarray) -> np.ndarray:
    """A code-indexed table of at least one entry (an empty dictionary's
    columns hold code 0, masked)."""
    return lut if len(lut) else np.zeros(1, dtype=lut.dtype)


def _like_regex(pattern: str):
    import re

    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.S)


# ---------------------------------------------------------------------------
# unary / misc
# ---------------------------------------------------------------------------


@dataclass
class PhysNot(PhysicalExpr):
    expr: PhysicalExpr
    dtype: DataType = BOOL

    def children(self):
        return [self.expr]

    def evaluate(self, table):
        c = self.expr.evaluate(table)
        return CVec(BOOL, ~c.data.to(torch.bool), c.valid)


@dataclass
class PhysNegative(PhysicalExpr):
    expr: PhysicalExpr
    dtype: DataType = FLOAT64

    def children(self):
        return [self.expr]

    def evaluate(self, table):
        c = self.expr.evaluate(table)
        return CVec(c.dtype, -c.data, c.valid)


@dataclass
class PhysIsNull(PhysicalExpr):
    expr: PhysicalExpr
    negated: bool = False
    dtype: DataType = BOOL

    def children(self):
        return [self.expr]

    def evaluate(self, table):
        c = self.expr.evaluate(table)
        out = c.valid if self.negated else ~c.valid
        return CVec(BOOL, out, torch.ones_like(c.valid))


@dataclass
class PhysCast(PhysicalExpr):
    expr: PhysicalExpr
    dtype: DataType
    safe: bool = False

    def children(self):
        return [self.expr]

    def evaluate(self, table):
        return cast_column(self.expr.evaluate(table), self.dtype, safe=self.safe)

    def needs_host(self) -> bool:
        # a cast to a string formats the column's values on the host, and
        # its dictionary depends on them: it cannot join a fused stage,
        # whose output dictionaries are fixed when the stage is built
        frm = self.expr.dtype
        to_string = self.dtype.is_string and not frm.is_string and frm != NULLTYPE
        return to_string or super().needs_host()


@dataclass
class PhysCase(PhysicalExpr):
    base: Optional[PhysicalExpr]
    when_then: list[tuple[PhysicalExpr, PhysicalExpr]]
    else_expr: Optional[PhysicalExpr]
    dtype: DataType

    def children(self):
        out = [self.base] if self.base else []
        for w, t in self.when_then:
            out += [w, t]
        if self.else_expr:
            out.append(self.else_expr)
        return out

    def evaluate(self, table: Table) -> CVec:
        cap = table.capacity
        dev = table.device
        base = self.base.evaluate(table) if self.base is not None else None
        out = torch.zeros(cap, dtype=_tdt(self.dtype), device=dev)
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        decided = torch.zeros(cap, dtype=torch.bool, device=dev)
        out_dict: StringDict | None = None
        for w, t in self.when_then:
            wc = w.evaluate(table)
            if base is not None:
                bb, ww = (base, wc)
                if base.dtype.is_string:
                    bb, ww = harmonize_strings(base, wc)
                cond = (bb.data == ww.data) & bb.valid & ww.valid
            else:
                cond = wc.data.to(torch.bool) & wc.valid
            tv = cast_column(t.evaluate(table), self.dtype)
            if self.dtype.is_string:
                if out_dict is None:
                    out_dict = tv.dictionary
                else:
                    prev, tv = harmonize_strings(CVec(STRING, out, valid, out_dict), tv)
                    out_dict = prev.dictionary
                    out = prev.data
            take = cond & ~decided
            out = K.where_bits(take, tv.data.to(out.dtype), out)
            valid = torch.where(take, tv.valid, valid)
            decided = decided | take
        if self.else_expr is not None:
            ev = cast_column(self.else_expr.evaluate(table), self.dtype)
            if self.dtype.is_string and out_dict is not None:
                prev, ev = harmonize_strings(CVec(STRING, out, valid, out_dict), ev)
                out_dict = prev.dictionary
                out = prev.data
            out = K.where_bits(~decided, ev.data.to(out.dtype), out)
            valid = torch.where(~decided, ev.valid, valid)
        else:
            valid = valid & decided
        return CVec(self.dtype, out, valid, out_dict)


@dataclass
class PhysInList(PhysicalExpr):
    expr: PhysicalExpr
    values: list[ScalarValue]
    negated: bool = False
    dtype: DataType = BOOL

    def children(self):
        return [self.expr]

    def evaluate(self, table: Table) -> CVec:
        c = self.expr.evaluate(table)
        if c.dtype.is_string:
            d = c.dictionary
            assert d is not None
            strs = tuple(str(v.value) for v in self.values if v.value is not None)
            lut = derived(d, ("in",) + strs, lambda: _in_table(d, strs))
            codes = torch.clamp(c.data, 0, max(len(d) - 1, 0)).to(torch.int64)
            hit = device_table(lut, c.data.device)[codes]
        else:
            hit = torch.zeros_like(c.valid)
            for v in self.values:
                if v.value is None:
                    continue
                vv = v.value
                if c.dtype.is_decimal and v.dtype.is_decimal:
                    vv = vv * 10 ** (c.dtype.scale - v.dtype.scale)
                elif c.dtype.is_decimal:
                    vv = int(round(float(vv) * 10**c.dtype.scale))
                hit = hit | (c.data == vv)
        out = ~hit if self.negated else hit
        # SQL: x IN (..) is NULL if x is NULL, or on no match when the list
        # holds a NULL
        valid = c.valid
        if any(v.value is None for v in self.values):
            valid = valid & hit
        return CVec(BOOL, out, valid)


def _in_table(d: StringDict, strs: tuple) -> np.ndarray:
    """Per dictionary code, whether its string is one of ``strs``."""
    lut = np.zeros(max(len(d), 1), dtype=bool)
    for v in strs:
        code = d.code_of(v)
        if code is not None:
            lut[code] = True
    return lut


@dataclass
class PhysScalarFunction(PhysicalExpr):
    name: str
    args: list[PhysicalExpr]
    dtype: DataType

    def children(self):
        return list(self.args)

    def evaluate(self, table: Table) -> CVec:
        from ..functions.registry import dispatch_scalar

        arg_cols = [a.evaluate(table) for a in self.args]
        return dispatch_scalar(self.name, arg_cols, self.dtype, table.capacity, table.device)

    def needs_host(self) -> bool:
        from ..functions.registry import _ROW_FNS

        n = self.name.lower()
        # their dictionaries depend on the data: the distinct values (or
        # value combinations) are formatted on the host
        if n in ("to_hex", "chr", "concat", "concat_ws"):
            return True
        if n in _ROW_FNS and any(not isinstance(a, PhysLit) for a in self.args[1:]):
            return True
        return any(a.needs_host() for a in self.args)

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"
