"""Whole-stage execution: run a linear operator chain as one fused pass.

Port of ``datafusion_tpu/physical/stage_compiler.py``.  The reference
traces Scan -> Filter/Projection -> Aggregate -> Sort into ONE jitted XLA
program; PyTorch runs eagerly, so here the same chain runs as a sequence
of tensor ops over the stage's buffers, keeping the reference's plan:
  * filters do NOT compact: the predicate folds into a row-validity mask
    carried to the aggregate; compaction happens at most once, where a
    sort or limit needs live rows at the front;
  * the aggregate is ``HashAggregateExec.aggregate`` (``ops/aggregate.py``
    chooses its no-group, small-domain or sort path) over the row mask;
    a scan-rooted stage probes the (min, range) of its integer and date
    group keys in the source, which opens the small-domain path to them.
A stage that shrinks its output learns the capacity on its first run
(per input signature for a stage above a join); inside a speculation
window later runs truncate to it with an overflow flag instead of reading
the count, as the reference's learned stage capacities do.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..columnar.table import Table, host_values
from ..device import torch_dtype
from ..errors import InternalError
from ..ops import kernels as K
from ..ops.aggregate import FUSED_DOMAIN_LIMIT, HashAggregateExec, output_columns
from ..ops.base import ExecutionPlan
from ..ops.basic import FilterExec, GlobalLimitExec, MemoryExec, ProjectionExec, clamp_rows
from ..ops.sort import SortExec
from ..ops.window import WindowAggExec


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


def stage_chain(plan: ExecutionPlan):
    """The longest fusable chain from ``plan`` down, top to bottom, and the
    node below it.

    Shape: [Limit?] [Sort?] [Proj*] [Agg? | Window?] (Filter|Proj)*.
    A shared subtree (physical/dedup.py) is a stage boundary; the shared
    node itself may still head its own chain."""

    def ok(n):
        return node_jit_safe(n) and (n is plan or not getattr(n, "_dedup_shared", False))

    chain = []
    node = plan
    if isinstance(node, GlobalLimitExec) and ok(node):
        chain.append(node)
        node = node.input
    if isinstance(node, SortExec) and ok(node):
        chain.append(node)
        node = node.input
    while isinstance(node, ProjectionExec) and ok(node):
        chain.append(node)
        node = node.input
    if isinstance(node, HashAggregateExec) and node.mode in ("single", "partial") and ok(node):
        chain.append(node)
        node = node.input
    elif isinstance(node, WindowAggExec) and ok(node):
        chain.append(node)
        node = node.input
    while isinstance(node, (FilterExec, ProjectionExec)) and ok(node):
        chain.append(node)
        node = node.input
    return chain, node


def compilable(plan: ExecutionPlan) -> bool:
    """Is this subtree one fusable stage: a ``stage_chain`` over a
    MemoryExec that is not shared?"""
    _, node = stage_chain(plan)
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
                # the keys as evaluated, then a blank column per value or state
                key_cols = [e.evaluate(t) for e, _ in op.group_expr]
                names, dtypes, dicts = output_columns(op, t, key_cols)
                nk = len(key_cols)
                cols = key_cols + [meta_col(dt, dic) for dt, dic in zip(dtypes[nk:], dicts[nk:])]
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
                t = op.aggregate(self._table_view(cur_d, cur_v, t), alive, cap, int_ranges)
                cur_d = [c.data for c in t.columns]
                cur_v = [c.valid for c in t.columns]
                n = t.nrows_dev
                cap = cur_d[0].shape[0] if cur_d else 0
                alive = torch.arange(cap, device=dev) < n
                compacted = True
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
