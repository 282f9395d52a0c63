"""HashAggregateExec equivalent: the port's GROUP BY, whole.

Port of ``datafusion_tpu/ops/aggregate.py`` and of the aggregate half of
``datafusion_tpu/physical/stage_compiler.py`` (reference:
datafusion/src/physical_plan/hash_aggregate.rs, modes Partial/Final/Full,
the row-by-row ``group_aggregate_batch`` hot loop at :409).  No hash
table.  Single and partial modes run through one entry,
``HashAggregateExec.aggregate``, which the fused stages call too; it takes
one of three paths:
  * no group keys: each aggregate is the small-domain path's slot
    reduction with one slot that holds every live row;
  * small domain (dictionary or bool keys, and integer or date keys whose
    (min, range) a probe of the stage's source found small; domain <= 256;
    TPC-H Q1's returnflag x linestatus = 12): every row gets a slot id,
    every sum/count/avg over integer or decimal storage comes from ONE
    pass of the hand-written kernel ``ops/smalldomain.py`` (K1), and the
    other aggregates are masked [domain, N] reductions;
  * every other GROUP BY sorts the rows by their keys once
    (``group_rows``), derives group ids from the key boundaries and
    reduces each aggregate per segment (``segment_aggregate``); DISTINCT
    and user-defined aggregates always take this path.
Final mode merges partial states (``merge_states``): the merge of the
morsels of a host-resident table (``physical/morsel.py``) and of the tiles
of the cross-join aggregate.  A user-defined aggregate (a monoid, see
``functions/udf.py``) is a segmented scan of its ``step`` in the
reference's order, then its ``finalize``.  ``output_columns`` states the
output's names, types and dictionaries once, for the entry and for the
stages' dry run.

Aggregate state layout (partial columns per logical aggregate):
  count       -> [count:i64]                 final: sum
  sum         -> [sum:T, count:i64]          final: sum (count tracks null-ness)
  min/max     -> [min:T, count:i64]          final: min/max
  avg         -> [sum:f64, count:i64]        final: sum/count
  var/stddev  -> [n:i64, sum:f64, sumsq:f64] final: moments
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.table import Table, round_capacity
from ..device import torch_dtype
from ..errors import InternalError, PlanError
from ..exprs.physical import PhysicalExpr, descale
from ..functions.aggregates import aggregate_return_type
from ..types import Field, Schema
from ..types.dtypes import DataType, FLOAT64, INT64
from . import kernels as K
from .base import ExecutionPlan
from .smalldomain import MAX_COLS, smalldomain_sum_count

VARIANCE_FUNS = ("variance", "var", "var_samp", "var_pop", "stddev", "stddev_samp", "stddev_pop")

# domain limit for the small-domain path (K1 takes up to 256 slots)
FUSED_DOMAIN_LIMIT = 256


class PhysAggExpr:
    """One aggregate: function name + input expression (+ distinct flag)."""

    def __init__(
        self,
        fun: str,
        expr: PhysicalExpr | None,
        name: str,
        distinct: bool = False,
        udf=None,
    ):
        self.fun = fun.lower()
        if self.fun == "mean":
            self.fun = "avg"
        if self.fun == "approx_distinct":
            # hyperloglog_expressions.rs equivalent: exact distinct count is
            # a valid (and on this engine, cheap sort-based) approximation
            self.fun = "count"
            distinct = True
        self.expr = expr  # None => COUNT(*)
        self.name = name
        self.distinct = distinct
        self.udf = udf  # functions.udf.AggregateUDF when user-defined

    def return_type(self) -> DataType:
        if self.udf is not None:
            return self.udf.return_type
        if self.expr is None:
            return INT64
        return aggregate_return_type(self.fun, [self.expr.dtype])

    # ---- partial state schema ------------------------------------------------
    def state_fields(self) -> list[tuple[str, DataType]]:
        rt = self.return_type()
        f = self.fun
        if self.udf is not None:
            # one monoid accumulator + count (udaf.rs state_type)
            return [(f"{self.name}[acc]", rt), (f"{self.name}[count]", INT64)]
        if f == "count":
            return [(f"{self.name}[count]", INT64)]
        if f == "sum":
            return [(f"{self.name}[sum]", rt), (f"{self.name}[count]", INT64)]
        if f in ("min", "max"):
            t = self.expr.dtype
            return [(f"{self.name}[{f}]", t), (f"{self.name}[count]", INT64)]
        if f == "avg":
            return [(f"{self.name}[sum]", FLOAT64), (f"{self.name}[count]", INT64)]
        if f in VARIANCE_FUNS:
            return [
                (f"{self.name}[n]", INT64),
                (f"{self.name}[sum]", FLOAT64),
                (f"{self.name}[sumsq]", FLOAT64),
            ]
        if f in ("covar", "covar_samp", "covar_pop", "corr"):
            return [
                (f"{self.name}[n]", INT64),
                (f"{self.name}[sx]", FLOAT64),
                (f"{self.name}[sy]", FLOAT64),
                (f"{self.name}[sxy]", FLOAT64),
                (f"{self.name}[sxx]", FLOAT64),
                (f"{self.name}[syy]", FLOAT64),
            ]
        raise PlanError(f"aggregate '{self.fun}' not supported")

    def __repr__(self):
        d = "DISTINCT " if self.distinct else ""
        arg = repr(self.expr) if self.expr is not None else "*"
        return f"{self.fun}({d}{arg})"


class HashAggregateExec(ExecutionPlan):
    """mode: 'single' | 'partial' | 'final'.

    single : raw rows in, final values out
    partial: raw rows in, state columns out (for shuffle)
    final  : state columns in (schema = group keys + state), final values out

    DISTINCT aggregates have no scalar partial state (a per-partition
    distinct count over-counts values seen in several partitions).  The
    partial phase groups by (keys + distinct values) instead, emitting the
    deduplicated pairs as rows, and the final phase (``distinct_values``
    > 0) deduplicates the values again per group before aggregating them,
    while the other aggregates merge their states.  Final input layout
    with distinct_values=k: [group keys..., dv_0..dv_{k-1}, states...]."""

    def __init__(
        self,
        mode: str,
        group_expr: list[tuple[PhysicalExpr, str]],
        aggr_expr: list[PhysAggExpr],
        input: ExecutionPlan,
        distinct_values: int = 0,
    ):
        super().__init__()
        if mode not in ("single", "partial", "final"):
            raise InternalError(f"bad aggregate mode {mode}")
        if distinct_values and mode != "final":
            raise InternalError("distinct_values only applies to final mode")
        self.mode = mode
        self.group_expr = group_expr
        self.aggr_expr = aggr_expr
        self.input = input
        self.distinct_values = distinct_values
        # final mode: the output capacity per input signature (K.fit_learned)
        self._learned_caps: dict = {}

    def schema(self) -> Schema:
        fields = [Field(name, e.dtype, True) for e, name in self.group_expr]
        if self.mode == "partial":
            for a in self.aggr_expr:
                for sname, sdt in a.state_fields():
                    fields.append(Field(sname, sdt, True))
        else:
            for a in self.aggr_expr:
                fields.append(Field(a.name, a.return_type(), True))
        return Schema(fields)

    def children(self):
        return [self.input]

    def with_new_children(self, c):
        return HashAggregateExec(
            self.mode, self.group_expr, self.aggr_expr, c[0], self.distinct_values
        )

    def _execute(self) -> Table:
        t = self.input.execute()
        alive = torch.arange(t.capacity, device=t.device) < t.nrows_dev
        if self.mode == "final":
            # the output capacity is learned per input signature: a warm run
            # inside a speculation window reads no group count
            sig = (t.capacity, tuple(str(c.dtype) for c in t.columns),
                   tuple(id(c.dictionary) for c in t.columns))
            return K.fit_learned(merge_states(self, t, alive), self._learned_caps, sig)
        out = self.aggregate(t, alive)
        tgt = round_capacity(out.nrows)
        if tgt != out.capacity:
            out = out.with_capacity(tgt)
        return out

    def aggregate(self, t: Table, alive, cap: int | None = None, int_ranges=None) -> Table:
        """This aggregate over the rows of ``t`` where ``alive`` holds, at
        capacity ``cap`` (``t``'s by default; no shrink), with the
        dictionaries of ``output_columns``.  ``int_ranges``: {group key
        index: (min, range)} of the integer keys that a probe of the
        stage's source found small, which opens the small-domain path to
        them."""
        cap = t.capacity if cap is None else cap
        key_cols = [e.evaluate(t) for e, _ in self.group_expr]
        out_d, out_v, n = _aggregate_buffers(self, t, key_cols, alive, cap, int_ranges)
        names, dtypes, dicts = output_columns(self, t, key_cols)
        cols = [Column(dt, d, v, dic) for dt, d, v, dic in zip(dtypes, out_d, out_v, dicts)]
        return Table(names, cols, n, device=t.device)

    def _display_line(self):
        return (
            f"HashAggregateExec[{self.mode}]: "
            f"group={[n for _, n in self.group_expr]}, aggr={self.aggr_expr}"
        )


def output_columns(op: HashAggregateExec, t: Table, key_cols):
    """(names, dtypes, dictionaries) of ``op``'s output columns over the
    columns of ``t``: the group keys' (``key_cols``, evaluated over ``t``),
    then each aggregate's value, or its ``state_fields`` in partial mode.
    Min and max over strings keep the argument's dictionary, in the value
    or in the state's first column."""
    names = [name for _, name in op.group_expr]
    dtypes = [c.dtype for c in key_cols]
    dicts = [c.dictionary for c in key_cols]
    for a in op.aggr_expr:
        dic = None
        if a.fun in ("min", "max") and a.expr is not None and a.expr.dtype.is_string:
            dic = a.expr.evaluate(t).dictionary
        fields = a.state_fields() if op.mode == "partial" else [(a.name, a.return_type())]
        for j, (name, dt) in enumerate(fields):
            names.append(name)
            dtypes.append(dt)
            dicts.append(dic if j == 0 else None)
    return names, dtypes, dicts


def _aggregate_buffers(op: HashAggregateExec, t: Table, key_cols, alive, cap, int_ranges=None):
    """(datas, valids, row count) of ``op``'s output columns, in the order
    of ``output_columns``: the no-group, small-domain or sort path."""
    emit_state = op.mode == "partial"
    if not key_cols:
        out_cap = round_capacity(1)  # 1 output row
        out_d, out_v = [], []
        for a in op.aggr_expr:
            for data, valid in _eval_aggregate_nogroup(a, t, alive, out_cap, emit_state):
                out_d.append(data)
                out_v.append(valid)
        return out_d, out_v, 1
    domain = _small_domain(key_cols, op.aggr_expr, int_ranges)
    if domain is not None:
        return _fused_small_domain_aggregate(
            op, t, key_cols, domain, alive, cap, emit_state, int_ranges
        )
    return _sorted_aggregate(op, t, key_cols, alive, cap, emit_state)


def _small_domain(key_cols, aggr_expr, int_ranges=None) -> int | None:
    """Total direct-index domain if all keys are small dictionary strings
    or bools, or small-range integers whose (min, range) the stage probed
    (int_ranges: {key index: (min, range)})."""
    if any(a.distinct or a.udf is not None for a in aggr_expr):
        return None  # distinct/UDAF need the sort path
    total = 1
    for i, c in enumerate(key_cols):
        if c.dtype.is_string and c.dictionary is not None:
            total *= max(len(c.dictionary), 1) + 1  # +1 for NULL slot
        elif c.dtype.is_bool:
            total *= 3
        elif int_ranges is not None and i in int_ranges:
            total *= int_ranges[i][1] + 1
        else:
            return None
        if total > FUSED_DOMAIN_LIMIT:
            return None
    return total


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def group_rows(key_cols, alive):
    """Sort the rows by their group keys, NULLs first and dead rows
    (``alive`` False) last, and find the groups: (perm, ngroups, seg,
    kvalids, n).  ``perm`` is the sort's permutation, ``seg`` the sorted
    rows' Segments (each group's first row in sorted order is
    ``seg.first``), ``kvalids`` the keys' valid masks with the dead rows
    cleared and ``n`` the live rows.  The sort path of GROUP BY and the
    rolling window's partitions share it."""
    n = alive.sum()
    ordkeys = tuple(K.orderable_key(c.data, c.dtype, c.vrange) for c in key_cols)
    kvalids = tuple(c.valid & alive for c in key_cols)
    nk = len(key_cols)
    perm = K.lexsort_perm(ordkeys, kvalids, n, (False,) * nk, (True,) * nk, dead_mask=~alive)
    gid, ngroups = K.group_ids_sorted(*K.take(ordkeys, kvalids, perm), n)
    return perm, ngroups, K.segments(gid), kvalids, n


def _neutral(ordk: torch.Tensor, f: str) -> torch.Tensor:
    """The identity of min (f == "min") or max over ``ordk``'s dtype."""
    if ordk.is_floating_point():
        v = float("inf") if f == "min" else float("-inf")
    else:
        info = torch.iinfo(ordk.dtype)
        v = info.max if f == "min" else info.min
    # a fill on the device, not a copy from the host
    return torch.full((), v, dtype=ordk.dtype, device=ordk.device)


def segment_aggregate(a: PhysAggExpr, t: Table, perm, seg: K.Segments, cap, alive, ngroups,
                    emit_state: bool):
    """Compute one aggregate over sorted/grouped rows.

    ``perm`` is the group sort's permutation of ``t``'s rows (None when
    ``t`` is already in group order); ``seg`` the grouping's segments.
    Returns a list of state Columns (emit_state) or [final Column], each
    [cap] in segment order."""
    f = a.fun
    if a.distinct and f not in ("count", "sum", "avg", "min", "max"):
        raise PlanError(f"DISTINCT not supported for {f}")
    dev = seg.gid.device
    gvalid = torch.arange(cap, device=dev) < ngroups

    if a.expr is None:  # COUNT(*): the live rows are exactly the groups' rows
        cnt = torch.where(gvalid, seg.last - seg.first + 1, 0)
        return [Column(INT64, cnt, gvalid)]
    v = a.expr.evaluate(t)
    if perm is None:
        data, valid = v.data, v.valid & alive
    else:
        (data,), (valid,) = K.take((v.data,), (v.valid,), perm, alive)

    if a.distinct:
        # mask duplicate (group, value) pairs so each distinct value counts once
        data, valid = _distinct_mask(v, seg.gid, data, valid)

    def count():
        return K.segment_sum(valid.to(torch.int64), seg, cap)

    if a.udf is not None:
        # the user's monoid: a segmented scan of its step, read at each
        # group's last row (udaf.rs; state = accumulator + count)
        rt = a.return_type()
        acc = udaf_scan(a, data, valid, seg)
        cnt = count()
        if emit_state:
            return [Column(rt, acc, gvalid), Column(INT64, cnt, gvalid)]
        return [Column(rt, udaf_finalize(a, acc, cnt), gvalid & (cnt > 0))]

    if f == "count":
        return [Column(INT64, count(), gvalid)]

    if f == "sum":
        rt = a.return_type()
        dt = torch_dtype(rt.storage_np_dtype())
        acc = K.signed_view(data.to(dt))
        s = K.segment_sum(torch.where(valid, acc, torch.zeros((), dtype=acc.dtype, device=dev)), seg, cap)
        s = s.view(dt)
        cnt = count()
        sum_col = Column(rt, s, gvalid & (cnt > 0))
        if emit_state:
            return [sum_col, Column(INT64, cnt, gvalid)]
        return [sum_col]

    if f in ("min", "max"):
        t_in = v.dtype
        ordk = data if t_in.is_float else K.orderable_key(data, t_in, v.vrange)
        vals = torch.where(valid, ordk, _neutral(ordk, f))
        red = K.segment_min(vals, seg, cap) if f == "min" else K.segment_max(vals, seg, cap)
        if t_in.is_float:
            zero = signed_zeros(data, valid, f)
            red = zero_sign_fix(red, f, K.segment_sum(zero.to(torch.int64), seg, cap) > 0)
        cnt = count()
        out = red.to(torch_dtype(t_in.storage_np_dtype()))
        col = Column(t_in, out, gvalid & (cnt > 0), v.dictionary)
        if emit_state:
            return [col, Column(INT64, cnt, gvalid)]
        return [col]

    if f == "avg":
        fd = to_float(data, v.dtype)
        s = K.segment_sum(torch.where(valid, fd, 0.0), seg, cap)
        cnt = count()
        if emit_state:
            return [Column(FLOAT64, s, gvalid), Column(INT64, cnt, gvalid)]
        return [Column(FLOAT64, s / torch.clamp(cnt, min=1), gvalid & (cnt > 0))]

    if f in VARIANCE_FUNS:
        fd = to_float(data, v.dtype)
        n = count()
        s = K.segment_sum(torch.where(valid, fd, 0.0), seg, cap)
        ss = K.segment_sum(torch.where(valid, fd * fd, 0.0), seg, cap)
        if emit_state:
            return [Column(INT64, n, gvalid), Column(FLOAT64, s, gvalid), Column(FLOAT64, ss, gvalid)]
        out, ok = _finalize_var(f, n, s, ss)
        return [Column(FLOAT64, out, gvalid & ok)]

    raise PlanError(f"aggregate '{f}' not implemented")


def merge_states(op: "HashAggregateExec", t: Table, alive) -> Table:
    """Final values of ``op``'s aggregates from rows of its partial states
    (``t``: group keys, then ``op.distinct_values`` distinct value columns,
    then each non-distinct aggregate's ``state_fields``), grouped by the
    keys, over the rows where ``alive`` holds: the reference's
    ``_execute_final``, ``_merge_aggregate`` and
    ``_final_distinct_over_values``.  The group sort is stable, so states
    merge in the order of their rows, as the reference's do."""
    from ..exprs.physical import PhysCol

    cap = t.capacity
    dev = t.device
    nk = len(op.group_expr)
    ndv = op.distinct_values
    key_cols = t.columns[:nk]
    if key_cols:
        perm, ngroups, seg, kvalids, n = group_rows(key_cols, alive)
    else:
        n = alive.sum()
        perm = K.sort_perm((~alive,))
        ngroups = 1
        seg = K.segments(torch.where(torch.arange(cap, device=dev) < n, 0, cap - 1))
        kvalids = ()
    alive_s = torch.arange(cap, device=dev) < n
    gvalid = torch.arange(cap, device=dev) < ngroups
    names = [nm for _, nm in op.group_expr]
    cols = []
    if key_cols:
        cols = K.take_columns(key_cols, perm, gvalid, seg.first, valids=kvalids)

    def state(c):
        (d,), (v,) = K.take((c.data,), (c.valid,), perm, alive_s)
        return d, v

    idx = nk + ndv
    dvi = 0
    for a in op.aggr_expr:
        f = a.fun
        names.append(a.name)
        if a.distinct:
            if dvi >= ndv:
                raise PlanError(f"no mergeable partial state for DISTINCT {a.fun}")
            # the partial phase shipped deduplicated values: deduplicate
            # them again per group and aggregate the survivors
            dv = t.columns[nk + dvi]
            dvi += 1
            shim = PhysAggExpr(f, PhysCol("__dv", 0, dv.dtype), a.name, distinct=True)
            view = Table(["__dv"], [dv], 0, device=dev)
            cols.append(segment_aggregate(shim, view, perm, seg, cap, alive_s, ngroups, False)[0])
            continue
        st = t.columns[idx: idx + len(a.state_fields())]
        idx += len(st)
        if a.expr is None or f == "count":
            d, va = state(st[0])
            cols.append(Column(INT64, K.segment_sum(torch.where(va, d, 0), seg, cap), gvalid))
            continue
        if f in VARIANCE_FUNS:
            (nn, nv), (ss1, _), (ss2, _) = state(st[0]), state(st[1]), state(st[2])
            N = K.segment_sum(torch.where(nv, nn, 0), seg, cap)
            out, ok = _finalize_var(
                f, N, K.segment_sum(torch.where(nv, ss1, 0.0), seg, cap),
                K.segment_sum(torch.where(nv, ss2, 0.0), seg, cap),
            )
            cols.append(Column(FLOAT64, out, gvalid & ok))
            continue
        d, _ = state(st[0])
        c, cv = state(st[1])
        cnt = K.segment_sum(torch.where(cv, c, 0), seg, cap)
        if a.udf is not None:
            acc = udaf_scan(a, d, cv & (c > 0), seg)
            cols.append(Column(a.return_type(), udaf_finalize(a, acc, cnt), gvalid & (cnt > 0)))
        elif f == "sum":
            rt = a.return_type()
            acc = K.signed_view(d)
            s_ = K.segment_sum(torch.where(cv, acc, torch.zeros((), dtype=acc.dtype, device=dev)), seg, cap)
            cols.append(Column(rt, s_.view(d.dtype), gvalid & (cnt > 0)))
        elif f == "avg":
            s_ = K.segment_sum(torch.where(cv, d, 0.0), seg, cap)
            cols.append(Column(FLOAT64, s_ / torch.clamp(cnt, min=1), gvalid & (cnt > 0)))
        elif f in ("min", "max"):
            t_in = st[0].dtype
            has = cv & (c > 0)
            ordk = d if t_in.is_float else K.orderable_key(d, t_in)
            vals = torch.where(has, ordk, _neutral(ordk, f))
            red = K.segment_min(vals, seg, cap) if f == "min" else K.segment_max(vals, seg, cap)
            if t_in.is_float:
                zero = signed_zeros(d, has, f)
                red = zero_sign_fix(red, f, K.segment_sum(zero.to(torch.int64), seg, cap) > 0)
            out = red.to(torch_dtype(t_in.storage_np_dtype()))
            cols.append(Column(t_in, out, gvalid & (cnt > 0), st[0].dictionary))
        else:
            raise PlanError(f"merge for aggregate '{f}' not implemented")
    return Table(names, cols, ngroups, device=dev)


def udaf_scan(a: PhysAggExpr, data, valid, seg: K.Segments) -> torch.Tensor:
    """A user-defined aggregate's accumulator per group (in segment order,
    [cap]): its ``step`` folded over the valid values of each group, the
    invalid ones replaced by its ``zero``, as the reference's segmented
    scan folds them."""
    x = _udaf_inputs(a, data, valid)
    return K._segment_scan(x, seg.gid, a.udf.step)[seg.last]


def _udaf_inputs(a: PhysAggExpr, data, valid) -> torch.Tensor:
    sdt = torch_dtype(a.return_type().storage_np_dtype())
    zero = torch.full((), a.udf.zero, dtype=sdt, device=data.device)
    return torch.where(valid, data.to(sdt), zero)


def udaf_finalize(a: PhysAggExpr, acc, cnt) -> torch.Tensor:
    """A user-defined aggregate's value from its accumulator and count."""
    out = acc if a.udf.finalize is None else a.udf.finalize(acc, cnt)
    return out.to(torch_dtype(a.return_type().storage_np_dtype()))


def signed_zeros(x: torch.Tensor, valid: torch.Tensor, f: str) -> torch.Tensor:
    """The valid rows of x that decide the sign of a zero min (f == "min":
    the -0.0 rows) or max (the 0.0 rows)."""
    return valid & (x == 0) & (torch.signbit(x) == (f == "min"))


def zero_sign_fix(red: torch.Tensor, f: str, has: torch.Tensor) -> torch.Tensor:
    """A float min or max with the reference's signed zeros: XLA orders
    -0.0 below 0.0, where torch takes either.  ``has``: the group holds a
    row of ``signed_zeros``."""
    lo, hi = (-0.0, 0.0) if f == "min" else (0.0, -0.0)
    return torch.where(red == 0, torch.where(has, lo, hi).to(red.dtype), red)


def _distinct_mask(v, gid, data, valid):
    """Keep the first occurrence of each (group, value) pair; null out the
    rest.  Sorts rows by (gid, value) and detects boundaries, the same
    primitive as grouping itself (the reference uses per-group HashSets,
    distinct_expressions.rs)."""
    ordv = K.orderable_key(data, v.dtype)
    keys = torch.where(valid, ordv, _neutral(ordv, "min"))  # nulls sort last
    order = K.sort_perm((gid, keys))
    g2, d2, va2 = gid[order], ordv[order], valid[order]
    prev_same = (
        (g2 == torch.roll(g2, 1)) & (d2 == torch.roll(d2, 1)) & (va2 & torch.roll(va2, 1))
    )
    prev_same[:1].fill_(False)  # a fill, not a wait for a host copy
    keep = torch.empty_like(valid)
    keep[order] = va2 & ~prev_same  # back to the rows' own order
    return data, valid & keep


def _finalize_var(f, n, s, ss):
    """(value, defined) of a variance-family aggregate from its moments."""
    nf = n.to(torch.float64)
    mean = s / torch.clamp(nf, min=1.0)
    m2 = torch.clamp(ss - nf * mean * mean, min=0.0)
    pop = f.endswith("_pop")
    var = m2 / torch.clamp(nf if pop else nf - 1.0, min=1.0)
    out = torch.sqrt(var) if f.startswith("stddev") else var
    return out, n >= (1 if pop else 2)


def to_float(data, dtype):
    """A numeric column's values as float64, decimals descaled."""
    if dtype.is_decimal:
        return descale(data.to(torch.float64), dtype.scale)
    return data.to(torch.float64)

# ---------------------------------------------------------------------------
# sort path
# ---------------------------------------------------------------------------


def _sorted_aggregate(op, t, key_cols, alive, cap, emit_state):
    """The general GROUP BY: one stable sort of the rows by their group
    keys, dead rows (the filter mask included) last; group ids from the
    key boundaries; one segment reduction per aggregate state.  The
    reference carries every column through its sort as a payload; here
    the sort yields a permutation, and only the keys and the aggregates'
    inputs are gathered by it."""
    dev = alive.device
    perm, ngroups, seg, kvalids, n = group_rows(key_cols, alive)
    alive_sorted = torch.arange(cap, device=dev) < n
    gvalid_rows = torch.arange(cap, device=dev) < ngroups
    # each group's keys from its first row in sorted order
    kd, kv = K.take(tuple(c.data for c in key_cols), kvalids, perm, gvalid_rows, seg.first)
    out_d = list(kd)
    out_v = list(kv)
    for a in op.aggr_expr:
        for c in segment_aggregate(a, t, perm, seg, cap, alive_sorted, ngroups, emit_state):
            out_d.append(c.data)
            out_v.append(c.valid)
    return out_d, out_v, ngroups


# ---------------------------------------------------------------------------
# fused small-domain path
# ---------------------------------------------------------------------------


def _fused_small_domain_aggregate(
    op, t, key_cols, domain, alive, cap, emit_state, int_ranges=None
):
    dev = alive.device
    # slot id per row: sum(code_i * stride_i); codes are sorted dictionary
    # indices or offset integers, so arithmetic order == group sort order.
    # Code 0 is NULL; dead rows get slot `domain` (outside every slot).
    gid = torch.zeros(cap, dtype=torch.int32, device=dev)
    stride = 1
    radix = []  # (stride, base, an integer key's minimum or None) per key
    for i in reversed(range(len(key_cols))):
        c = key_cols[i]
        if c.dtype.is_string or c.dtype.is_bool:
            base = max(len(c.dictionary), 1) + 1 if c.dtype.is_string else 3
            mn = None
            code = c.data.to(torch.int32) + 1
        else:  # probed small-range integer
            mn, rng = int_ranges[i]
            base = rng + 1
            code = torch.clamp(c.data.to(torch.int64) - mn, 0, rng - 1).to(torch.int32) + 1
        gid = gid + torch.where(c.valid, code, 0) * stride
        radix.insert(0, (stride, base, mn))
        stride *= base
    gid = torch.where(alive, gid, torch.full_like(gid, domain)).contiguous()

    # every sum/count/avg over integer/decimal storage: ONE kernel pass
    pk = _kernel_precompute(op, t, gid, domain)

    slots = torch.arange(domain, dtype=torch.int64, device=dev)
    # rows per slot: a COUNT(*) item has them from the kernel already
    star = next((ai for ai, a in enumerate(op.aggr_expr) if a.expr is None and ai in pk), None)
    if star is not None:
        counts = pk[star][1]
    else:
        # (bincount would read the largest id on the host)
        counts = torch.zeros(domain + 1, dtype=torch.int64, device=dev).index_add_(
            0, gid.to(torch.int64), torch.ones(cap, dtype=torch.int64, device=dev)
        )[:domain]
    present = counts > 0
    dense = torch.cumsum(present.to(torch.int64), 0) - 1  # compacted group id
    ngroups = present.sum()

    # slot of each compacted group (a tiny domain-sized scatter)
    slot_of_group = torch.zeros(domain, dtype=torch.int64, device=dev).scatter_reduce_(
        0, dense.clamp(0, domain - 1), torch.where(present, slots, 0), "amax"
    )

    # at most `domain` groups can exist: emit small buffers
    out_cap = min(cap, round_capacity(domain))
    gvalid_row = torch.arange(out_cap, device=dev) < ngroups
    out_d, out_v = [], []
    # each group's key values, decoded from its slot id (code 0: NULL; an
    # integer key's value is its minimum + code - 1).
    # The reference gathers them from each slot's first row instead; on an
    # H100 that min-index scatter onto a dozen hot slots took ~40 % of
    # TPC-H Q1's time
    for c, (st, base, mn) in zip(key_cols, radix):
        code = torch.div(slot_of_group, st, rounding_mode="floor") % base
        val = code - 1 if mn is None else code - 1 + mn
        out_d.append(_pad_to(torch.where(code > 0, val, 0), out_cap, c.data.dtype))
        out_v.append(_pad_to(code > 0, out_cap, torch.bool) & gvalid_row)

    hit = None
    for ai, a in enumerate(op.aggr_expr):
        if ai in pk:
            slots_out = _slots_from_kernel(a, *pk[ai], emit_state=emit_state)
        else:
            if hit is None:
                hit = gid[None, :] == slots.to(torch.int32)[:, None]  # [D, N]
            slots_out = _eval_aggregate_slots(a, t, hit, emit_state)
        for data, valid in slots_out:
            # reorder [D] slot values into compacted group order, pad out
            out_d.append(_pad_to(K.gather(data, slot_of_group), out_cap, data.dtype))
            out_v.append(_pad_to(valid[slot_of_group], out_cap, torch.bool) & gvalid_row)
    return out_d, out_v, ngroups


def _kernel_agg_item(a: PhysAggExpr, t: Table):
    """(data_i64, mask, kind, scale) if `a` is computable from exact int64
    sums and counts, else None."""
    if a.distinct or a.udf is not None:
        return None
    if a.expr is None:  # COUNT(*)
        return (None, None, "count", 0)
    v = a.expr.evaluate(t)
    if a.fun == "count":
        return (None, v.valid, "count", 0)
    if not (v.dtype.is_integer or v.dtype.is_decimal):
        return None
    if a.fun == "sum" and a.return_type().storage_np_dtype() == np.int64:
        return (v.data.to(torch.int64), v.valid, "sum", 0)
    if a.fun == "avg":
        scale = v.dtype.scale if v.dtype.is_decimal else 0
        return (v.data.to(torch.int64), v.valid, "avg", scale)
    return None


def _kernel_precompute(op, t: Table, gid, domain: int):
    """Run K1 for every eligible aggregate, up to 8 columns per launch;
    returns {agg_index: (sum_slots, cnt_slots, kind, scale)}."""
    items = []
    for ai, a in enumerate(op.aggr_expr):
        it = _kernel_agg_item(a, t)
        if it is not None:
            items.append((ai, it))
    out = {}
    for lo in range(0, len(items), MAX_COLS):
        chunk = items[lo : lo + MAX_COLS]
        sums, cnts = smalldomain_sum_count(
            gid,
            [d if d is None else d.contiguous() for _, (d, _, _, _) in chunk],
            [m if m is None else m.contiguous() for _, (_, m, _, _) in chunk],
            domain,
        )
        for j, (ai, it) in enumerate(chunk):
            out[ai] = (sums[:, j], cnts[:, j], it[2], it[3])
    return out


def _slots_from_kernel(a, s_i64, cnt, kind, scale, emit_state):
    """Map kernel (sum, count) slots into _eval_aggregate_slots' output
    forms (state layouts must match ``state_fields`` exactly)."""
    cnt64 = cnt.to(torch.int64)
    ones = torch.ones_like(cnt64, dtype=torch.bool)
    has = cnt64 > 0
    if kind == "count":
        return [(cnt64, ones)]
    if kind == "sum":
        if emit_state:
            return [(s_i64, has), (cnt64, ones)]
        return [(s_i64, has)]
    # avg: float state/result, descaled for decimals (same as to_float)
    sf = descale(s_i64.to(torch.float64), scale)
    if emit_state:
        return [(sf, ones), (cnt64, ones)]
    return [(sf / torch.clamp(cnt64, min=1), has)]


def _eval_aggregate_slots(a: PhysAggExpr, t: Table, hit, emit_state):
    """Per-slot ([D]-shaped) aggregate values as (data, valid) pairs."""
    f = a.fun

    if a.expr is None:  # COUNT(*)
        cnt = hit.sum(dim=1)
        return [(cnt, torch.ones_like(cnt, dtype=torch.bool))]

    v = a.expr.evaluate(t)
    vv = hit & v.valid[None, :]  # [D, N] valid-and-in-slot
    cnt = vv.sum(dim=1)
    has = cnt > 0
    ones = torch.ones_like(cnt, dtype=torch.bool)

    if f == "count":
        return [(cnt, ones)]

    if f == "sum":
        dt = torch_dtype(a.return_type().storage_np_dtype())
        acc = K.signed_view(v.data.to(dt))
        zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
        s = torch.where(vv, acc[None, :], zero).sum(dim=1).view(dt)
        if emit_state:
            return [(s, has), (cnt, ones)]
        return [(s, has)]

    if f in ("min", "max"):
        t_in = v.dtype
        ordk = v.data if t_in.is_float else K.orderable_key(v.data, t_in)
        vals = torch.where(vv, ordk[None, :], _neutral(ordk, f))
        red = vals.amin(dim=1) if f == "min" else vals.amax(dim=1)
        if t_in.is_float:
            red = zero_sign_fix(red, f, (hit & signed_zeros(v.data, v.valid, f)[None, :]).any(dim=1))
        out = red.to(torch_dtype(t_in.storage_np_dtype()))
        if emit_state:
            return [(out, has), (cnt, ones)]
        return [(out, has)]

    if f == "avg":
        fd = to_float(v.data, v.dtype)
        s = torch.where(vv, fd[None, :], 0.0).sum(dim=1)
        if emit_state:
            return [(s, torch.ones_like(has)), (cnt, ones)]
        return [(s / torch.clamp(cnt, min=1), has)]

    if f in VARIANCE_FUNS:
        fd = to_float(v.data, v.dtype)
        s = torch.where(vv, fd[None, :], 0.0).sum(dim=1)
        ss = torch.where(vv, (fd * fd)[None, :], 0.0).sum(dim=1)
        if emit_state:
            return [(cnt, ones), (s, ones), (ss, ones)]
        return [_finalize_var(f, cnt, s, ss)]

    raise PlanError(f"aggregate '{f}' not implemented in fused path")


# ---------------------------------------------------------------------------
# no group keys
# ---------------------------------------------------------------------------


def _one(x: torch.Tensor, valid_scalar, dtype, out_cap):
    """One output row (padded to out_cap) as a (data, valid) pair."""
    data = torch.zeros(out_cap, dtype=dtype, device=x.device)
    data[:1].fill_(x.to(dtype))
    valid = torch.zeros(out_cap, dtype=torch.bool, device=x.device)
    # fills: assigning a host scalar copies it to the card and waits
    valid[:1].fill_(valid_scalar)
    return data, valid


def _eval_aggregate_nogroup(a: PhysAggExpr, t: Table, alive, out_cap, emit_state):
    """Aggregate over ALL live rows -> 1 output row (padded to out_cap),
    as (data, valid) pairs: the slot reduction with one slot that holds
    every live row, but for DISTINCT and user-defined aggregates."""
    if a.distinct:
        return _eval_aggregate_nogroup_distinct(a, t, alive, out_cap, emit_state)
    if a.udf is not None:
        # the user's monoid folded over every live valid value, in the
        # order of the reference's associative scan
        v = a.expr.evaluate(t)
        m = alive & v.valid
        x = _udaf_inputs(a, v.data, m)
        acc = K.assoc_scan(lambda p, q: (a.udf.step(p[0], q[0]),), (x,))[0][-1]
        cnt = m.sum()
        if emit_state:
            return [_one(acc, True, x.dtype, out_cap), _one(cnt, True, torch.int64, out_cap)]
        return [_one(udaf_finalize(a, acc, cnt), cnt > 0, x.dtype, out_cap)]
    return [
        (_pad_to(data, out_cap, data.dtype), _pad_to(valid, out_cap, torch.bool))
        for data, valid in _eval_aggregate_slots(a, t, alive[None, :], emit_state)
    ]


def _eval_aggregate_nogroup_distinct(a, t, alive, out_cap, emit_state):
    """COUNT/SUM/AVG(DISTINCT x) without groups: sort the values, count
    each run of equal values once."""
    v = a.expr.evaluate(t)
    dev = alive.device
    cap = alive.shape[0]  # the sort runs over the input rows
    ordk = K.orderable_key(v.data, v.dtype)
    m = alive & v.valid
    sk = torch.sort(K.sort_key(torch.where(m, ordk, _neutral(ordk, "min")))).values  # nulls last
    ar = torch.arange(cap, device=dev)
    firsts = (ar < m.sum()) & ((ar == 0) | (sk != torch.roll(sk, 1)))
    cnt = firsts.sum()
    f = a.fun
    if f == "count":
        return [_one(cnt, True, torch.int64, out_cap)]
    if f in ("sum", "avg"):
        vals = torch.where(firsts, sk, torch.zeros((), dtype=sk.dtype, device=dev))
        if f == "avg":
            s = vals.to(torch.float64).sum()
            if v.dtype.is_decimal:  # the orderable key is the scaled int
                s = descale(s, v.dtype.scale)
            return [_one(s / torch.clamp(cnt, min=1), cnt > 0, torch.float64, out_cap)]
        # accumulate at the RETURN width (keys may ride narrowed int32)
        dt = torch_dtype(a.return_type().storage_np_dtype())
        return [_one(K.signed_view(vals.to(dt)).sum(), cnt > 0, dt, out_cap)]
    if f in ("min", "max"):
        return _eval_aggregate_nogroup(
            PhysAggExpr(f, a.expr, a.name, False), t, alive, out_cap, emit_state
        )
    raise PlanError(f"DISTINCT {f} not supported")


def _pad_to(x, cap, dtype):
    n = x.shape[0]
    if n == cap:
        return x.to(dtype)
    if n > cap:
        return x[:cap].to(dtype)
    return torch.cat([x.to(dtype), torch.zeros(cap - n, dtype=dtype, device=x.device)])
