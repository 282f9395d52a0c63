"""Whole-stage execution: run a linear operator chain as one fused pass.

Port of ``datafusion_tpu/physical/stage_compiler.py``.  The reference
traces Scan -> Filter/Projection -> Aggregate -> Sort into ONE jitted XLA
program; PyTorch runs eagerly, so here the same chain runs as a sequence
of tensor ops over the stage's buffers, keeping the reference's plan:
  * filters do NOT compact: the predicate folds into a row-validity mask
    carried to the aggregate; compaction happens at most once, where a
    sort or limit needs live rows at the front;
  * small-domain GROUP BY (dictionary/bool keys, and integer or date keys
    that a min/max probe of the source finds small; domain <= 256; TPC-H
    Q1's returnflag x linestatus = 12) gives every row a slot id, and
    every sum/count/avg over integer or decimal storage comes from ONE
    pass of the hand-written kernel ``ops/smalldomain.py`` (K1); the
    other aggregates are masked [domain, N] reductions;
  * every other GROUP BY sorts the rows by their keys once, derives group
    ids from the key boundaries and reduces each aggregate per segment
    (``ops/aggregate.py::_eval_aggregate``); DISTINCT aggregates always
    take this path;
  * no-group aggregates are plain masked reductions.
A stage that shrinks its output learns the capacity on its first run
(per input signature for a stage above a join); inside a speculation
window later runs truncate to it with an overflow flag instead of reading
the count, as the reference's learned stage capacities do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.table import Table, host_values, round_capacity
from ..device import torch_dtype
from ..errors import InternalError, PlanError
from ..exprs.physical import descale
from ..ops import kernels as K
from ..ops.aggregate import (
    VARIANCE_FUNS,
    HashAggregateExec,
    PhysAggExpr,
    _eval_aggregate,
    _finalize_var,
    _group_rows,
    _neutral,
    _to_float,
    _udaf_inputs,
    signed_zeros,
    udaf_finalize,
    zero_sign_fix,
)
from ..ops.base import ExecutionPlan
from ..ops.basic import FilterExec, GlobalLimitExec, MemoryExec, ProjectionExec, clamp_rows
from ..ops.smalldomain import MAX_COLS, smalldomain_sum_count
from ..ops.sort import SortExec
from ..ops.window import WindowAggExec

# domain limit for the fused small-domain path (K1 takes up to 256 slots)
FUSED_DOMAIN_LIMIT = 256


def node_exprs(node: ExecutionPlan):
    """The PhysicalExprs an operator evaluates."""
    if isinstance(node, FilterExec):
        return [node.predicate]
    if isinstance(node, ProjectionExec):
        return [e for e, _ in node.exprs]
    if isinstance(node, HashAggregateExec):
        return [e for e, _ in node.group_expr] + [
            a.expr for a in node.aggr_expr if a.expr is not None
        ]
    if isinstance(node, SortExec):
        return [s.expr for s in node.sort_exprs]
    if isinstance(node, WindowAggExec):
        out = []
        for w in node.window_exprs:
            out += list(w.args) + list(w.partition_by) + [s.expr for s in w.order_by]
        return out
    return []


def node_jit_safe(node: ExecutionPlan) -> bool:
    """False when any contained expression must read column data on the
    host (needs_host) — such operators cannot join a fused stage."""
    return not any(e.needs_host() for e in node_exprs(node))


def compilable(plan: ExecutionPlan) -> bool:
    """Is this subtree one fusable stage?

    Shape: [Limit?] [Sort?] [Proj*] [Agg? | Window?] (Filter|Proj)* Memory.
    A shared subtree (physical/dedup.py) is a stage boundary; the shared
    node itself may still head its own stage."""

    def ok(n):
        return node_jit_safe(n) and (n is plan or not getattr(n, "_dedup_shared", False))

    node = plan
    if isinstance(node, GlobalLimitExec) and ok(node):
        node = node.input
    if isinstance(node, SortExec) and ok(node):
        node = node.input
    while isinstance(node, ProjectionExec) and ok(node):
        node = node.input
    if isinstance(node, HashAggregateExec) and node.mode in ("single", "partial") and ok(node):
        node = node.input
    elif isinstance(node, WindowAggExec) and ok(node):
        node = node.input
    while isinstance(node, (FilterExec, ProjectionExec)) and ok(node):
        node = node.input
    return isinstance(node, MemoryExec) and not getattr(node, "_dedup_shared", False)


def _zeros(n: int, dtype, device) -> torch.Tensor:
    return torch.zeros(n, dtype=dtype, device=device)


class CompiledStage:
    """One fused stage: run(datas, valids, nrows) -> (datas, valids, nout).

    The stage's source is a MemoryExec leaf (a scan-rooted stage) or any
    subtree (``source_node``: a query tail fused above a join, a union or
    another stage, ``TailStageExec``).  Such a dynamic stage never runs its
    source itself: its input arrives per execution, so its output
    dictionaries are learned per input signature, and it skips the
    integer-key probe (each probe costs a host sync per key)."""

    def __init__(self, plan: ExecutionPlan, source_node: ExecutionPlan | None = None):
        self.plan = plan
        chain = []
        node = plan
        while node is not source_node and not isinstance(node, MemoryExec):
            chain.append(node)
            node = node.children()[0]
        self.source = node
        self.dynamic = not isinstance(node, MemoryExec)
        self.chain = list(reversed(chain))
        self.out_schema = plan.schema()
        self._dict_cache: dict = {}
        self._probe_cache: dict = {}
        self._learned_caps: dict = {}
        if self.dynamic:
            self.out_dicts = None
            self._probe_specs = None
        else:
            # output dictionaries, learned from a dry evaluation on the host
            self.out_dicts = self._infer_dicts(self.source.execute())
            # integer group keys that can take the small-domain path when a
            # min/max probe of the source finds a small range: only safe
            # when the aggregate sees source columns directly
            self._probe_specs = self._find_probe_specs()

    def _find_probe_specs(self):
        """[(group key index, source column index)] of the aggregate's
        integer and date keys, or None."""
        from ..exprs.physical import PhysCol

        agg = None
        below_ops = []
        for op in self.chain:
            if isinstance(op, HashAggregateExec):
                agg = op
                break
            below_ops.append(op)
        if agg is None or not agg.group_expr:
            return None
        if any(isinstance(op, ProjectionExec) for op in below_ops):
            return None
        specs = []
        for ki, (e, _) in enumerate(agg.group_expr):
            if not isinstance(e, PhysCol):
                continue
            if e.dtype.is_integer or e.dtype.kind == "date32":
                specs.append((ki, e.index))
        return specs or None

    def _probe_int_ranges(self, src: Table):
        """{key index: (min, range)} when every probed integer key's live
        source values span at most FUSED_DOMAIN_LIMIT values, else None.
        One host sync per key on a source's first run; cached per source
        buffer."""
        if not self._probe_specs:
            return None
        bufs = tuple(src.columns[ci].data for _, ci in self._probe_specs)
        ckey = tuple(id(b) for b in bufs)
        cached = self._probe_cache.get(ckey)
        if cached is not None and all(a is b for a, b in zip(cached[0], bufs)):
            return cached[1] or None
        ranges = {}
        alive = torch.arange(src.capacity, device=src.device) < src.nrows_dev
        big = torch.iinfo(torch.int64).max
        for ki, ci in self._probe_specs:
            c = src.columns[ci]
            m = c.valid & alive
            d = c.data.to(torch.int64)
            mn, mx = host_values(torch.stack([
                torch.where(m, d, big).amin(), torch.where(m, d, -big).amax()
            ]))
            if mn > mx:
                continue  # all-null key
            rng = mx - mn + 1
            if 0 < rng <= FUSED_DOMAIN_LIMIT:
                ranges[ki] = (mn, rng)
        # all int keys must be small for the fused path to engage
        if len(ranges) != len(self._probe_specs):
            ranges = {}
        # the cached buffers stay referenced, so their ids cannot be reused
        if len(self._probe_cache) > 64:
            self._probe_cache.clear()
        self._probe_cache[ckey] = (bufs, ranges)
        return ranges or None

    # ------------------------------------------------------------------
    def execute(self, shrink: bool = True, src: Table | None = None, ratchet: bool = False) -> Table:
        if src is None:
            src = self.source.execute()
        datas = tuple(c.data for c in src.columns)
        valids = tuple(c.valid for c in src.columns)
        ranges = None if self.dynamic else self._probe_int_ranges(src)
        out_d, out_v, nout = self._run(datas, valids, src.nrows_dev, base=src, int_ranges=ranges)
        cols = [
            Column(f.dtype, d, v, dic)
            for f, d, v, dic in zip(self.out_schema.fields, out_d, out_v, self._out_dicts(src))
        ]
        t = Table(self.out_schema.names(), cols, nout, device=src.device)
        if not shrink:
            return t
        # downstream operators run over capacity: right-size the buffers
        # they will see, learning the capacity per input signature for a
        # dynamic stage (``K.fit_learned``: growth flags and reruns exactly;
        # ``ratchet`` for the morsels of one scan, which share a signature)
        return K.fit_learned(t, self._learned_caps, self._cap_key(src), ratchet)

    def _cap_key(self, src: Table):
        """What a dynamic stage's learned output capacity depends on besides
        its data (a scan-rooted stage has one source)."""
        if not self.dynamic:
            return ()
        return (
            src.capacity,
            tuple(str(c.dtype) for c in src.columns),
            tuple(id(c.dictionary) for c in src.columns),
            tuple(K.vrange_narrows_i32(c.vrange) for c in src.columns),
        )

    def _out_dicts(self, src: Table):
        """The output dictionaries: fixed for a scan-rooted stage, cached
        per input signature (column types and dictionary identities) for a
        dynamic one.  An entry keeps its input dictionaries referenced, so
        their ids cannot be reused while it lives."""
        if self.out_dicts is not None:
            return self.out_dicts
        dicts = tuple(c.dictionary for c in src.columns)
        sig = (tuple(str(c.dtype) for c in src.columns), tuple(id(d) for d in dicts))
        cached = self._dict_cache.get(sig)
        if cached is not None and all(a is b for a, b in zip(cached[0], dicts)):
            return cached[1]
        out = self._infer_dicts(src)
        if len(self._dict_cache) > 64:
            self._dict_cache.clear()
        self._dict_cache[sig] = (dicts, out)
        return out

    # ------------------------------------------------------------------
    def _table_view(self, datas, valids, base: Table) -> Table:
        cols = [
            Column(c.dtype, d, v, c.dictionary, vrange=c.vrange)
            for c, d, v in zip(base.columns, datas, valids)
        ]
        return Table(list(base.names), cols, 0, device=base.device)

    def _infer_dicts(self, src: Table):
        t = self._stage_meta_table(src)
        return [c.dictionary for c in t.columns]

    def _stage_meta_table(self, src: Table) -> Table:
        """Tiny host evaluation (1 dead row, on the CPU) to learn output
        dictionaries."""
        cpu = torch.device("cpu")
        datas = tuple(_zeros(1, c.data.dtype, cpu) for c in src.columns)
        valids = tuple(_zeros(1, torch.bool, cpu) for c in src.columns)
        t = self._table_view(datas, valids, src)

        def meta_col(dt, dic=None):
            return Column(dt, _zeros(1, torch_dtype(dt.storage_np_dtype()), cpu),
                          _zeros(1, torch.bool, cpu), dic)

        for op in self.chain:
            if isinstance(op, ProjectionExec):
                cols = [e.evaluate(t) for e, _ in op.exprs]
                t = Table([n for _, n in op.exprs], cols, 0, device=cpu)
            elif isinstance(op, (FilterExec, SortExec, GlobalLimitExec)):
                pass  # schema/dictionaries unchanged
            elif isinstance(op, WindowAggExec):
                names, cols = list(t.names), list(t.columns)
                for w in op.window_exprs:
                    dic = None
                    if w.args and w.fun in ("lag", "lead", "first_value", "last_value",
                                            "nth_value", "min", "max"):
                        dic = w.args[0].evaluate(t).dictionary
                    names.append(w.name)
                    cols.append(meta_col(w.dtype, dic))
                t = Table(names, cols, 0, device=cpu)
            elif isinstance(op, HashAggregateExec):
                key_cols = [e.evaluate(t) for e, _ in op.group_expr]
                names = [n for _, n in op.group_expr]
                cols = list(key_cols)
                if op.mode == "partial":
                    for a in op.aggr_expr:
                        # a min/max state over strings keeps the argument's
                        # dictionary, for the final merge
                        dic = None
                        if a.fun in ("min", "max") and a.expr is not None:
                            dic = a.expr.evaluate(t).dictionary
                        for j, (sn, sd) in enumerate(a.state_fields()):
                            names.append(sn)
                            cols.append(meta_col(sd, dic if j == 0 else None))
                else:
                    for a in op.aggr_expr:
                        dic = None
                        if a.fun in ("min", "max") and a.expr is not None:
                            dic = a.expr.evaluate(t).dictionary
                        names.append(a.name)
                        cols.append(meta_col(a.return_type(), dic))
                t = Table(names, cols, 0, device=cpu)
        return t

    # ------------------------------------------------------------------
    def _run(self, datas, valids, nrows, base: Table, int_ranges=None):
        t = self._table_view(datas, valids, base)
        cur_d = list(datas)
        cur_v = list(valids)
        dev = base.device
        cap = cur_d[0].shape[0] if cur_d else 0
        alive = torch.arange(cap, device=dev) < nrows
        compacted = True  # live rows currently at the front
        n = nrows

        def compact():
            # one compaction: a stable sort keyed on ~alive moves the live
            # rows to the front of every column
            nonlocal cur_d, cur_v, alive, compacted, n
            nn = alive.sum()
            live_sorted = torch.arange(cap, device=dev) < nn
            _, moved = K.cosort((~alive,), tuple(cur_d) + tuple(cur_v))
            cur_d = list(moved[: len(cur_d)])
            cur_v = [v & live_sorted for v in moved[len(cur_d):]]
            alive = live_sorted
            n = nn
            compacted = True

        for op in self.chain:
            if isinstance(op, FilterExec):
                view = self._table_view(cur_d, cur_v, t)
                p = op.predicate.evaluate(view)
                # no compaction: fold the predicate into the row mask
                alive = alive & p.data.to(torch.bool) & p.valid
                compacted = False
            elif isinstance(op, ProjectionExec):
                view = self._table_view(cur_d, cur_v, t)
                outs = [e.evaluate(view) for e, _ in op.exprs]
                cur_d = [c.data for c in outs]
                cur_v = [c.valid for c in outs]
                t = Table([nm for _, nm in op.exprs], outs, 0, device=dev)
            elif isinstance(op, HashAggregateExec):
                view = self._table_view(cur_d, cur_v, t)
                cur_d, cur_v, n, meta = _traced_aggregate(op, view, alive, cap, int_ranges)
                cap = cur_d[0].shape[0] if cur_d else 0
                alive = torch.arange(cap, device=dev) < n
                compacted = True
                t = Table(
                    [nm for nm, _, _ in meta],
                    [
                        Column(dt, d, v, dic)
                        for (nm, dt, dic), d, v in zip(meta, cur_d, cur_v)
                    ],
                    0,
                    device=dev,
                )
            elif isinstance(op, SortExec):
                if not compacted:
                    compact()
                view = self._table_view(cur_d, cur_v, t)
                ordkeys, kvalids, descs, nfs = [], [], [], []
                for s in op.sort_exprs:
                    c = s.expr.evaluate(view)
                    ordkeys.append(K.orderable_key(c.data, c.dtype, c.vrange))
                    kvalids.append(c.valid)
                    descs.append(not s.ascending)
                    nfs.append(s.nulls_first)
                moved, _ = K.lexsort_apply(
                    tuple(ordkeys), tuple(kvalids),
                    tuple(cur_d) + tuple(cur_v),
                    n, tuple(descs), tuple(nfs),
                )
                cur_d = list(moved[: len(cur_d)])
                cur_v = list(moved[len(cur_d):])
                if op.fetch is not None:
                    n = clamp_rows(n, op.fetch)
                    alive = torch.arange(cap, device=dev) < n
            elif isinstance(op, GlobalLimitExec):
                if not compacted:
                    compact()
                n = clamp_rows(n, op.n)
                alive = torch.arange(cap, device=dev) < n
            elif isinstance(op, WindowAggExec):
                if not compacted:
                    compact()
                view = self._table_view(cur_d, cur_v, t)
                names, cols = op._traced_window(view, n, cap)
                cur_d = [c.data for c in cols]
                cur_v = [c.valid for c in cols]
                t = Table(names, cols, 0, device=dev)
            else:  # pragma: no cover
                raise InternalError(f"unfusable op {type(op).__name__}")

        if not compacted:
            compact()
        return tuple(cur_d), tuple(cur_v), n


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


def _agg_out_meta(op: HashAggregateExec, key_cols, emit_state):
    """(name, dtype, dictionary) per output column of an aggregate."""
    meta = [
        (name, kc.dtype, kc.dictionary)
        for kc, (_, name) in zip(key_cols, op.group_expr)
    ]
    for a in op.aggr_expr:
        if emit_state:
            for sn, sd in a.state_fields():
                meta.append((sn, sd, None))
        else:
            meta.append((a.name, a.return_type(), None))
    return meta


def _traced_aggregate(op: HashAggregateExec, t: Table, alive, cap, int_ranges=None):
    key_cols = [e.evaluate(t) for e, _ in op.group_expr]
    emit_state = op.mode == "partial"

    # ---- no group keys: plain masked reductions --------------------------
    if not key_cols:
        out_cap = round_capacity(1)  # 1 output row
        out_d, out_v = [], []
        for a in op.aggr_expr:
            for data, valid in _eval_aggregate_nogroup(a, t, alive, out_cap, emit_state):
                out_d.append(data)
                out_v.append(valid)
        return out_d, out_v, 1, _agg_out_meta(op, [], emit_state)

    domain = _small_domain(key_cols, op.aggr_expr, int_ranges)
    if domain is not None:
        return _fused_small_domain_aggregate(
            op, t, key_cols, domain, alive, cap, emit_state, int_ranges
        )
    return _sorted_aggregate(op, t, key_cols, alive, cap, emit_state)


def _sorted_aggregate(op, t, key_cols, alive, cap, emit_state):
    """The general GROUP BY: one stable sort of the rows by their group
    keys, dead rows (the filter mask included) last; group ids from the
    key boundaries; one segment reduction per aggregate state.  The
    reference carries every column through its sort as a payload; here
    the sort yields a permutation, and only the keys and the aggregates'
    inputs are gathered by it."""
    dev = alive.device
    perm, ngroups, seg, kvalids, n = _group_rows(key_cols, alive)
    alive_sorted = torch.arange(cap, device=dev) < n
    gvalid_rows = torch.arange(cap, device=dev) < ngroups
    # each group's keys from its first row in sorted order
    kd, kv = K.take(tuple(c.data for c in key_cols), kvalids, perm[seg.first])
    out_d = list(kd)
    out_v = [v & gvalid_rows for v in kv]
    agg_dicts = {}
    for a in op.aggr_expr:
        cols = _eval_aggregate(a, t, perm, seg, cap, alive_sorted, ngroups, emit_state)
        if a.fun in ("min", "max") and a.expr is not None and not emit_state:
            agg_dicts[a.name] = cols[0].dictionary
        for c in cols:
            out_d.append(c.data)
            out_v.append(c.valid)
    meta = _agg_out_meta(op, key_cols, emit_state)
    meta = [(nm, dt, agg_dicts.get(nm, dic)) for nm, dt, dic in meta]
    return out_d, out_v, ngroups, meta


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
    meta = _agg_out_meta(op, key_cols, emit_state)
    if not emit_state:
        # min/max over strings keep the argument's dictionary
        agg_dicts = {
            a.name: a.expr.evaluate(t).dictionary
            for a in op.aggr_expr
            if a.fun in ("min", "max") and a.expr is not None
        }
        meta = [(nm, dt, agg_dicts.get(nm, dic)) for nm, dt, dic in meta]
    return out_d, out_v, ngroups, meta


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
    forms (state layouts must match _agg_out_meta exactly)."""
    cnt64 = cnt.to(torch.int64)
    ones = torch.ones_like(cnt64, dtype=torch.bool)
    has = cnt64 > 0
    if kind == "count":
        return [(cnt64, ones)]
    if kind == "sum":
        if emit_state:
            return [(s_i64, has), (cnt64, ones)]
        return [(s_i64, has)]
    # avg: float state/result, descaled for decimals (same as _to_float)
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
        fd = _to_float(v.data, v.dtype)
        s = torch.where(vv, fd[None, :], 0.0).sum(dim=1)
        if emit_state:
            return [(s, torch.ones_like(has)), (cnt, ones)]
        return [(s / torch.clamp(cnt, min=1), has)]

    if f in VARIANCE_FUNS:
        fd = _to_float(v.data, v.dtype)
        s = torch.where(vv, fd[None, :], 0.0).sum(dim=1)
        ss = torch.where(vv, (fd * fd)[None, :], 0.0).sum(dim=1)
        if emit_state:
            return [(cnt, ones), (s, ones), (ss, ones)]
        return [_finalize_var(f, cnt, s, ss)]

    raise PlanError(f"aggregate '{f}' not implemented in fused path")


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
    as (data, valid) pairs."""
    f = a.fun
    dev = alive.device

    def one(x, valid_scalar, dtype):
        return _one(x, valid_scalar, dtype, out_cap)

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
            return [one(acc, True, x.dtype), one(cnt, True, torch.int64)]
        return [one(udaf_finalize(a, acc, cnt), cnt > 0, x.dtype)]

    if a.expr is None:
        return [one(alive.sum(), True, torch.int64)]

    v = a.expr.evaluate(t)
    m = alive & v.valid
    cnt = m.sum()
    has = cnt > 0

    if f == "count":
        return [one(cnt, True, torch.int64)]
    if f == "sum":
        dt = torch_dtype(a.return_type().storage_np_dtype())
        acc = K.signed_view(v.data.to(dt))
        s = torch.where(m, acc, torch.zeros((), dtype=acc.dtype, device=dev)).sum().view(dt)
        if emit_state:
            return [one(s, has, dt), one(cnt, True, torch.int64)]
        return [one(s, has, dt)]
    if f in ("min", "max"):
        t_in = v.dtype
        dt = torch_dtype(t_in.storage_np_dtype())
        ordk = v.data if t_in.is_float else K.orderable_key(v.data, t_in)
        vals = torch.where(m, ordk, _neutral(ordk, f))
        red = vals.amin() if f == "min" else vals.amax()
        if t_in.is_float:
            red = zero_sign_fix(red, f, signed_zeros(v.data, m, f).any())
        if emit_state:
            return [one(red, has, dt), one(cnt, True, torch.int64)]
        return [one(red, has, dt)]
    if f == "avg":
        s = torch.where(m, _to_float(v.data, v.dtype), 0.0).sum()
        if emit_state:
            return [one(s, True, torch.float64), one(cnt, True, torch.int64)]
        return [one(s / torch.clamp(cnt, min=1), has, torch.float64)]
    if f in VARIANCE_FUNS:
        fd = _to_float(v.data, v.dtype)
        s = torch.where(m, fd, 0.0).sum()
        ss = torch.where(m, fd * fd, 0.0).sum()
        if emit_state:
            return [
                one(cnt, True, torch.int64),
                one(s, True, torch.float64),
                one(ss, True, torch.float64),
            ]
        out, ok = _finalize_var(f, cnt, s, ss)
        return [one(out, ok, torch.float64)]
    raise PlanError(f"aggregate '{f}' not implemented in fused path")


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
