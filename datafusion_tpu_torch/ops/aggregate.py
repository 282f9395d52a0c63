"""HashAggregateExec equivalent: sort/segment-based vectorized GROUP BY.

Port of ``datafusion_tpu/ops/aggregate.py`` (reference:
datafusion/src/physical_plan/hash_aggregate.rs, modes Partial/Final/Full,
the row-by-row ``group_aggregate_batch`` hot loop at :409).  No hash table:
rows are sorted by their group keys, group ids come from boundary
detection + cumsum, and every aggregate is a segment reduction
(``_eval_aggregate``).  Single and partial modes run through the stage
compiler's aggregate (``physical.stage_compiler._traced_aggregate``): the
no-group path, the small-domain path, whose sums and counts come from the
hand-written kernel in ``ops/smalldomain.py``, and the sort path here.
The final-mode merge of partial states (two-phase aggregation across
devices) is ported in slice 7, user-defined aggregates in slice 5.

Aggregate state layout (partial columns per logical aggregate):
  count       -> [count:i64]                 final: sum
  sum         -> [sum:T, count:i64]          final: sum (count tracks null-ness)
  min/max     -> [min:T, count:i64]          final: min/max
  avg         -> [sum:f64, count:i64]        final: sum/count
  var/stddev  -> [n:i64, sum:f64, sumsq:f64] final: moments
"""

from __future__ import annotations

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

VARIANCE_FUNS = ("variance", "var", "var_samp", "var_pop", "stddev", "stddev_samp", "stddev_pop")


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
    """

    def __init__(
        self,
        mode: str,
        group_expr: list[tuple[PhysicalExpr, str]],
        aggr_expr: list[PhysAggExpr],
        input: ExecutionPlan,
    ):
        super().__init__()
        if mode not in ("single", "partial", "final"):
            raise InternalError(f"bad aggregate mode {mode}")
        self.mode = mode
        self.group_expr = group_expr
        self.aggr_expr = aggr_expr
        self.input = input

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
            self.mode, self.group_expr, self.aggr_expr, c[0]
        )

    def _execute(self) -> Table:
        t = self.input.execute()
        if self.mode == "final":
            raise NotImplementedError(
                "final-mode aggregation (merging partial states) is ported in slice 7"
            )
        out = self.aggregate(t, torch.arange(t.capacity, device=t.device) < t.nrows_dev)
        tgt = round_capacity(out.nrows)
        if tgt != out.capacity:
            out = out.with_capacity(tgt)
        return out

    def aggregate(self, t: Table, alive) -> Table:
        """This aggregate over the rows of ``t`` where ``alive`` holds, at
        ``t``'s capacity (no shrink)."""
        from ..physical.stage_compiler import _traced_aggregate

        out_d, out_v, n, meta = _traced_aggregate(self, t, alive, t.capacity)
        # min/max over strings keep the argument's dictionary, in their
        # value or in their partial state's first column
        dicts = {
            (a.name if self.mode != "partial" else a.state_fields()[0][0]): a.expr.evaluate(t).dictionary
            for a in self.aggr_expr
            if a.fun in ("min", "max") and a.expr is not None
        }
        meta = [(nm, dt, dicts.get(nm, dic)) for nm, dt, dic in meta]
        cols = [Column(dt, d, v, dic) for (nm, dt, dic), d, v in zip(meta, out_d, out_v)]
        return Table([nm for nm, _, _ in meta], cols, n, device=t.device)

    def _display_line(self):
        return (
            f"HashAggregateExec[{self.mode}]: "
            f"group={[n for _, n in self.group_expr]}, aggr={self.aggr_expr}"
        )


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _group_rows(key_cols, alive):
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
    gid, ngroups = K.group_ids_sorted(
        tuple(k[perm] for k in ordkeys), tuple(v[perm] for v in kvalids), n
    )
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


def _eval_aggregate(a: PhysAggExpr, t: Table, perm, seg: K.Segments, cap, alive, ngroups,
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
    if a.udf is not None:
        raise NotImplementedError("user-defined aggregates are ported in slice 5")

    v = a.expr.evaluate(t)
    if perm is None:
        data, valid = v.data, v.valid & alive
    else:
        data, valid = K.gather(v.data, perm), v.valid[perm] & alive

    if a.distinct:
        # mask duplicate (group, value) pairs so each distinct value counts once
        data, valid = _distinct_mask(v, seg.gid, data, valid)

    def count():
        return K.segment_sum(valid.to(torch.int64), seg, cap)

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
        fd = _to_float(data, v.dtype)
        s = K.segment_sum(torch.where(valid, fd, 0.0), seg, cap)
        cnt = count()
        if emit_state:
            return [Column(FLOAT64, s, gvalid), Column(INT64, cnt, gvalid)]
        return [Column(FLOAT64, s / torch.clamp(cnt, min=1), gvalid & (cnt > 0))]

    if f in VARIANCE_FUNS:
        fd = _to_float(data, v.dtype)
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
    (``t``: group keys, then each aggregate's ``state_fields``), grouped by
    the keys, over the rows where ``alive`` holds: the reference's
    ``_execute_final`` and ``_merge_aggregate``.  DISTINCT aggregates have
    no mergeable state and are refused."""
    cap = t.capacity
    dev = t.device
    nk = len(op.group_expr)
    key_cols = t.columns[:nk]
    if key_cols:
        perm, ngroups, seg, kvalids, n = _group_rows(key_cols, alive)
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
        kd, kv = K.take(tuple(c.data for c in key_cols), kvalids, perm[seg.first])
        cols = [Column(c.dtype, d, v & gvalid, c.dictionary) for c, d, v in zip(key_cols, kd, kv)]

    def state(c):
        return K.gather(c.data, perm), c.valid[perm] & alive_s

    idx = nk
    for a in op.aggr_expr:
        if a.distinct:
            raise PlanError(f"no mergeable partial state for DISTINCT {a.fun}")
        st = t.columns[idx: idx + len(a.state_fields())]
        idx += len(st)
        f = a.fun
        names.append(a.name)
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
        if f == "sum":
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


def _to_float(data, dtype):
    if dtype.is_decimal:
        return descale(data.to(torch.float64), dtype.scale)
    return data.to(torch.float64)
