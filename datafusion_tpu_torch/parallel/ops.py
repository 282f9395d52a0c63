"""Distributed (SPMD) operator implementations.

Port of ``datafusion_tpu/parallel/ops.py``.  Each distributed operator is
one shard body run on every shard by ``collectives.run_spmd`` (the JAX
package jits one ``shard_map`` program per operator; here the mesh path
is eager):

  dist_filter / dist_project     local per shard (partition-local
                                 FilterExec/ProjectionExec)
  dist_aggregate                 partial local agg -> all-to-all re-key by
                                 group hash -> final local agg (reference:
                                 Partial/FinalPartitioned HashAggregate +
                                 hash RepartitionExec, planner.rs:526-601)
  dist_aggregate_exact           raw rows placed by group hash, exact
                                 single-device aggregate per shard
  dist_join                      all-to-all both sides by key hash -> local
                                 join (PartitionMode::Partitioned); the
                                 broadcast mode all-gathers the build side
                                 (PartitionMode::CollectLeft); the skew
                                 hybrid keeps hot probe rows local
  dist_sort                      sample -> range partition -> all-to-all ->
                                 local sort
  dist_window / _global          partition-hash placement, or range
                                 placement plus O(ndev) corrections
  dist_union / _limit / _skip    shard-wise, moving no row

Expressions evaluate on per-shard Table views; string dictionaries are
host objects shared by every shard.  Grouping takes the sort path
(``group_rows``), never the small-domain kernel.  Static capacities,
bucket sizes and their exact-deficit retries are the JAX package's.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.table import Table, round_capacity
from ..errors import ExecutionError, PlanError
from ..exprs.physical import PhysCol, PhysicalExpr
from ..ops import kernels as K
from ..ops.aggregate import (
    HashAggregateExec,
    PhysAggExpr,
    group_rows,
    merge_states,
    output_columns,
    segment_aggregate,
    to_float,
)
from ..ops.basic import _merge_dictionaries, concat_tables
from ..ops.join import _join_keys, _key_hash, _matches_per_probe, _side_columns
from ..types.dtypes import INT64
from .collectives import AllGather, Pmax, Psum, gather_columns, run_spmd
from .mesh import ShardedTable, pad_rows, segment_compaction, stack_counts
from .shuffle import (
    hash_dest,
    local_alive,
    shuffle_by_dest,
    shuffle_by_hash,
    shuffle_exchange_dest,
    shuffle_split,
)


def _attach_info(st: ShardedTable, **info) -> ShardedTable:
    """Record exchange statistics on the operator's output (mesh EXPLAIN
    ANALYZE; the analogue of the reference's repartition metrics,
    repartition.rs:58-100).  Bucket sizes, receive capacities and byte
    volumes are static; live row counts are added by the executor."""
    st.exchange_info = dict(info)
    return st


def _exchange_bytes(datas, ndev: int, bucket_cap: int) -> int:
    """Upper-bound bytes one shard sends through an all-to-all exchange:
    ndev * bucket_cap slots per column (data + 1-byte valid).  ``datas``:
    per column, its per-shard buffers."""
    return sum(ndev * bucket_cap * (d[0][:1].numel() * d[0].element_size() + 1) for d in datas)


def default_bucket(shard_cap: int, ndev: int) -> int:
    """Memory-scalable receive-bucket default (reference repartition.rs:
    285-330 holds only each partition's share, never the full table).

    Under uniform hashing each source shard sends ~shard_cap/ndev rows to
    each destination, so a 2x-margin bucket keeps every receive buffer at
    ndev*B ~= 2*shard_cap.  Skew shows up as shuffle overflow (exact
    max-deficit counts), which the dist_* operators right-size in ONE
    retry.  Clamped to shard_cap: a source shard never sends more than its
    own row count to one destination."""
    return min(round_capacity(max(-(-2 * shard_cap // ndev), 1)), round_capacity(shard_cap))


def _local_view(st: ShardedTable, datas, valids, dev) -> Table:
    """Per-shard Table view for expression evaluation.  nrows is not used
    by expression evaluation (masking is the operator's job): 0."""
    cols = [Column(dt, d, v, dic) for dt, dic, d, v in zip(st.dtypes, st.dicts, datas, valids)]
    return Table(list(st.names), cols, 0, device=dev)


def _sample_view(st: ShardedTable) -> Table:
    """A one-row all-NULL view with ``st``'s dictionaries, to learn an
    expression's output dictionary without touching shard data."""
    dev = st.mesh.home
    cols = [
        Column(dt, torch.zeros((1,) + tuple(d[0].shape[1:]), dtype=d[0].dtype, device=dev),
               torch.zeros(1, dtype=torch.bool, device=dev), dic)
        for dt, dic, d in zip(st.dtypes, st.dicts, st.datas)
    ]
    return Table(list(st.names), cols, 0, device=dev)


def _dev(st: ShardedTable, me: int) -> torch.device:
    return st.mesh.devices[me]


def _assemble(st: ShardedTable, names, dtypes, shard_cols: list, counts: list, cap: int,
              dicts=None) -> ShardedTable:
    """A ShardedTable from each local shard's output Columns and 0-dim
    count.  String columns whose shards carry different dictionaries (an
    expression that derives one from its data) are remapped onto one
    merged dictionary."""
    ncols = len(names)
    datas, valids, out_dicts = [], [], []
    for c in range(ncols):
        pieces = [cols[c] for cols in shard_cols]
        dic = pieces[0].dictionary if dicts is None else dicts[c]
        if dicts is None and any(p.dictionary is not dic for p in pieces[1:]):
            if not dtypes[c].is_string:
                raise ExecutionError(f"shards of column {names[c]} carry different dictionaries")
            pieces, dic = _merge_dictionaries(pieces)
        datas.append([p.data for p in pieces])
        valids.append([p.valid for p in pieces])
        out_dicts.append(dic)
    return st.with_columns(names, dtypes, out_dicts, datas, valids, counts, cap)


def _host_max(st: ShardedTable, per_shard: list) -> np.ndarray:
    """The element-wise max over every shard of small per-shard int64
    vectors, read on the host in one sync."""
    home = st.mesh.home
    return st.mesh.host_reduce(torch.stack([x.to(home, torch.int64).reshape(-1) for x in per_shard]))


def _i64(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=dev).reshape(())


# ---------------------------------------------------------------------------
# filter / project
# ---------------------------------------------------------------------------


def dist_filter(st: ShardedTable, pred: PhysicalExpr) -> ShardedTable:
    def body(me, datas, valids, n):
        t = _local_view(st, datas, valids, _dev(st, me))
        p = pred.evaluate(t)
        keep = p.data.to(torch.bool) & p.valid & local_alive(st.shard_cap, n)
        out_d, out_v, cnt = K.filter_compact(tuple(datas), tuple(valids), keep, n)
        return out_d, out_v, cnt

    res = run_spmd(st.mesh, body, st.shard_args(), "dist_filter")
    ncols = len(st.datas)
    return st.with_columns(
        st.names, st.dtypes, st.dicts,
        [[r[0][c] for r in res] for c in range(ncols)],
        [[r[1][c] for r in res] for c in range(ncols)],
        [r[2] for r in res], st.shard_cap,
    )


def dist_project(st: ShardedTable, exprs: list[tuple[PhysicalExpr, str]]) -> ShardedTable:
    def body(me, datas, valids, n):
        t = _local_view(st, datas, valids, _dev(st, me))
        return [e.evaluate(t) for e, _ in exprs]

    res = run_spmd(st.mesh, body, st.shard_args(), "dist_project")
    counts = [st.count(j) for j in range(len(res))]
    return _assemble(st, [n for _, n in exprs], [e.dtype for e, _ in exprs], res, counts, st.shard_cap)


# ---------------------------------------------------------------------------
# aggregate
# ---------------------------------------------------------------------------


def _merge_op(group_expr, aggr_expr, state_dtypes) -> HashAggregateExec:
    """The final-mode aggregate that merges the partial states: group keys
    are the state table's first columns, and DISTINCT aggregates merge as
    plain ones (their rows were placed so that each value lies on one
    shard)."""
    keys = [(PhysCol(n, i, state_dtypes[i]), n) for i, (_, n) in enumerate(group_expr)]
    aggs = [PhysAggExpr(a.fun, a.expr, a.name, False, a.udf) for a in aggr_expr]
    return HashAggregateExec("final", keys, aggs, None)


def _partial_states(a: PhysAggExpr, t, perm, seg, cap, alive, ngroups, grouped: bool):
    """One aggregate's partial state columns over grouped rows.  Without
    group keys COUNT(*) counts the live rows (an empty shard has one state
    row with count 0)."""
    if a.expr is None and not grouped:
        cnt = torch.zeros(cap, dtype=torch.int64, device=alive.device)
        cnt[:1] = alive.sum()
        ok = torch.arange(cap, device=alive.device) < 1
        return [Column(INT64, cnt, ok)]
    return segment_aggregate(a, t, perm, seg, cap, alive, ngroups, True)


def dist_aggregate(
    st: ShardedTable,
    group_expr: list[tuple[PhysicalExpr, str]],
    aggr_expr: list[PhysAggExpr],
    bucket_cap: int | None = None,
) -> ShardedTable:
    """partial local agg -> all-to-all by group-key hash -> final local agg.

    Global DISTINCT (no group keys): scalar partial states would over-count
    values repeated across shards, so rows first all-to-all by the hash of
    the DISTINCT argument: every copy of a value lands on ONE shard, the
    local dedup becomes a global dedup, and the partial states merge like
    non-distinct ones.  All DISTINCT aggregates must share one argument;
    grouped DISTINCT goes through dist_aggregate_exact instead."""
    distinct_aggs = [a for a in aggr_expr if a.distinct]
    pre_expr = None
    if distinct_aggs:
        dargs = {str(a.expr) for a in distinct_aggs}
        if group_expr or len(dargs) != 1 or any(a.expr is None for a in distinct_aggs):
            raise ExecutionError(
                "dist_aggregate: DISTINCT requires a single shared argument "
                "and no group keys (grouped DISTINCT uses row placement)"
            )
        pre_expr = distinct_aggs[0].expr
    ndev = st.ndev
    cap = st.shard_cap
    auto = bucket_cap is None
    B = bucket_cap or default_bucket(cap, ndev)
    nkeys = len(group_expr)

    _, state_dtypes, state_dicts = _output_columns(
        HashAggregateExec("partial", group_expr, aggr_expr, None), st
    )
    out_names, out_dtypes, dicts = _output_columns(
        HashAggregateExec("single", group_expr, aggr_expr, None), st
    )
    merge = _merge_op(group_expr, aggr_expr, state_dtypes)
    fcap = ndev * B if nkeys else cap

    def body(me, datas, valids, n):
        dev = _dev(st, me)
        t = _local_view(st, datas, valids, dev)
        nloc, pcap, pre_ovf = n, cap, _i64(0, dev)

        # ---- phase 0 (global DISTINCT only): place rows by value hash ----
        if pre_expr is not None:
            dv = pre_expr.evaluate(t)
            vhash = K.hash_columns([K.hashable_key(dv.data, dv.dtype)], [dv.valid])
            datas, valids, nloc, pre_ovf = yield from shuffle_by_hash(datas, valids, n, vhash, ndev, B)
            t = _local_view(st, datas, valids, dev)
            pcap = ndev * B

        # ---- phase 1: local partial aggregate ----------------------------
        alive = torch.arange(pcap, device=dev) < nloc
        key_cols = [e.evaluate(t) for e, _ in group_expr]
        part_d, part_v = [], []
        if key_cols:
            perm, ngroups, seg, kvalids, _ = group_rows(key_cols, alive)
            kd, kv = K.take(tuple(c.data for c in key_cols), kvalids, perm[seg.first])
            gvalid = torch.arange(pcap, device=dev) < ngroups
            part_d += list(kd)
            part_v += [v & gvalid for v in kv]
        else:
            perm = torch.arange(pcap, device=dev)
            seg = K.segments(torch.where(alive, 0, pcap - 1))
            ngroups = 1
        for a in aggr_expr:
            for c in _partial_states(a, t, perm, seg, pcap, alive, ngroups, bool(key_cols)):
                part_d.append(c.data)
                part_v.append(c.valid)

        # ---- phase 2: shuffle partial states by group-key hash -----------
        if nkeys:
            khash = K.hash_columns(
                [K.hashable_key(part_d[i], state_dtypes[i]) for i in range(nkeys)], part_v[:nkeys]
            )
            sh_d, sh_v, new_n, sh_ovf = yield from shuffle_by_hash(
                part_d, part_v, _i64(ngroups, dev), khash, ndev, B
            )
        else:
            # global aggregate: every shard's single state row, on every shard
            g = yield from gather_columns([d[:1] for d in part_d] + [v[:1] for v in part_v])
            k = len(part_d)
            sh_d = [pad_rows(x.reshape((ndev,) + tuple(x.shape[2:])), fcap) for x in g[:k]]
            sh_v = [pad_rows(x.reshape(ndev), fcap) for x in g[k:]]
            new_n, sh_ovf = _i64(ndev, dev), pre_ovf

        # ---- phase 3: local final aggregate over the states ---------------
        stt = Table(
            [f"s{i}" for i in range(len(sh_d))],
            [Column(dt, d, v, dic) for dt, dic, d, v in zip(state_dtypes, state_dicts, sh_d, sh_v)],
            new_n, device=dev,
        )
        fin = merge_states(merge, stt, torch.arange(fcap, device=dev) < new_n)
        out_n = fin.nrows_dev if nkeys else _i64(1 if me == 0 else 0, dev)
        return fin.columns, _i64(out_n, dev), sh_ovf

    res = run_spmd(st.mesh, body, st.shard_args(), "dist_aggregate")
    ovf = int(_host_max(st, [r[2] for r in res])[0])
    if ovf > 0:
        if not auto:
            raise ExecutionError("dist_aggregate: state shuffle overflow at pinned bucket_cap")
        # exact deficit: B + ovf can never overflow again
        return dist_aggregate(st, group_expr, aggr_expr, bucket_cap=round_capacity(B + ovf))
    out = _assemble(st, out_names, out_dtypes, [r[0] for r in res], [r[1] for r in res], fcap, dicts)
    k = len(out_names)
    return _attach_info(
        out,
        op="dist_aggregate",
        mode=(
            "partial+rekey+final" if nkeys
            else ("value_place+all_gather_states" if pre_expr is not None else "all_gather_states")
        ),
        bucket_cap=B,
        recv_cap=fcap,
        exchange_bytes=_exchange_bytes(out.datas[:k], ndev, B) if nkeys else 0,
    )


def _output_columns(op: HashAggregateExec, st: ShardedTable):
    """``output_columns`` of ``op`` over ``st``'s columns, learned on a
    one-row sample."""
    sample = _sample_view(st)
    keys = [e.evaluate(sample) for e, _ in op.group_expr]
    return output_columns(op, sample, keys)


def dist_aggregate_exact(st: ShardedTable, op, bucket_cap: int | None = None):
    """Aggregate with group-hash PLACEMENT instead of partial states:
    all-to-all raw rows by group-key hash (each group lands whole on one
    shard), then the single-device aggregate runs per shard, so semantics
    needing global sets per group (DISTINCT aggregates) are exact without
    shipping set states.  ``op`` is the single-device HashAggregateExec
    (mode 'single').  Returns (ShardedTable, overflow)."""
    group_expr, aggr_expr = op.group_expr, op.aggr_expr
    if not group_expr:
        raise ExecutionError(
            "dist_aggregate_exact: no group keys; one shard would hold "
            "every row (the executor's fallback gathers instead)"
        )
    ndev = st.ndev
    auto = bucket_cap is None
    B = bucket_cap or default_bucket(st.shard_cap, ndev)
    fcap = ndev * B
    out_names, out_dtypes, dicts = _output_columns(op, st)

    def body(me, datas, valids, n):
        dev = _dev(st, me)
        t = _local_view(st, datas, valids, dev)
        kcols = [e.evaluate(t) for e, _ in group_expr]
        khash = K.hash_columns([K.hashable_key(c.data, c.dtype) for c in kcols], [c.valid for c in kcols])
        sh_d, sh_v, new_n, ovf = yield from shuffle_by_hash(datas, valids, n, khash, ndev, B)
        t2 = _local_view(st, sh_d, sh_v, dev)
        alive2 = torch.arange(fcap, device=dev) < new_n
        out = op.aggregate(t2, alive2, fcap)
        cols = [Column(dt, c.data, c.valid) for dt, c in zip(out_dtypes, out.columns)]
        return cols, _i64(out.nrows_dev, dev), ovf

    res = run_spmd(st.mesh, body, st.shard_args(), "dist_aggregate_exact")
    ovf = int(_host_max(st, [r[2] for r in res])[0])
    if ovf > 0 and auto:
        # hot group key under raw-row placement: one exact-deficit retry
        st2, r_ovf = dist_aggregate_exact(st, op, bucket_cap=round_capacity(B + ovf))
        st2.exchange_info["retries"] = st2.exchange_info.get("retries", 0) + 1
        return st2, r_ovf
    st2 = _assemble(st, out_names, out_dtypes, [r[0] for r in res], [r[1] for r in res], fcap, dicts)
    _attach_info(
        st2, op="dist_aggregate_exact", mode="group_hash_placement", bucket_cap=B,
        recv_cap=fcap, retries=0, exchange_bytes=_exchange_bytes(st.datas, ndev, B),
    )
    return st2, ovf


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------


SKEW_NB = 1024  # hash-histogram buckets for hot-key detection


def _compact_cols(cols: list, keep: torch.Tensor, out_cap: int):
    """The rows of ``cols`` (Columns) where ``keep`` holds, packed to the
    front of ``out_cap`` slots, and their count."""
    sel = K.keep_index(keep, out_cap)
    cnt = keep.sum()
    live = torch.arange(out_cap, device=keep.device) < cnt
    return [
        Column(c.dtype, K.gather(c.data, sel), c.valid[sel] & live, c.dictionary)
        for c in cols
    ], cnt


def _segments_view(st: ShardedTable, gathered_d, gathered_v, counts, seg_cap: int, dev) -> Table:
    """All-gathered shard buffers ([ndev, seg_cap] per column, ``counts``
    live rows each) packed to the front, in shard order: the same table on
    every shard."""
    ndev = counts.shape[0]
    cap = ndev * seg_cap
    idx, live = segment_compaction(counts, seg_cap, cap)
    cols = [
        Column(dt, K.gather(d.reshape((cap,) + tuple(d.shape[2:])), idx), v.reshape(cap)[idx] & live, dic)
        for dt, dic, d, v in zip(st.dtypes, st.dicts, gathered_d, gathered_v)
    ]
    return Table(list(st.names), cols, counts.sum(), device=dev)


def dist_join(
    left: ShardedTable,
    right: ShardedTable,
    on: list[tuple[PhysicalExpr, PhysicalExpr]],
    join_type: str = "inner",
    filter: PhysicalExpr | None = None,
    fanout: int = 4,
    bucket_cap: int | None = None,
    out_cap: int | None = None,
    skew: bool = False,
    broadcast: bool = False,
) -> ShardedTable:
    """Partitioned hash join, all six join types (reference
    hash_join.rs:139-144 PartitionMode::Partitioned): all-to-all both sides
    by key hash, then a local six-type join per shard.  Hash placement puts
    every key on exactly ONE shard, so per-shard unmatched-row detection
    (outer joins' visited mask) is complete.

    ``filter`` is a residual predicate over the combined left++right
    schema.  Pair capacity per shard is fanout * probe capacity; on
    overflow the per-shard candidate totals right-size ONE retry.

    ``broadcast=True`` (CollectLeft, hash_join.rs:285): probes stay local
    and the whole build side replicates to every shard by all-gather; the
    replicated rows' visited mask is pmax'd and only shard 0 emits the
    unmatched ones.  ``skew=True``: a psum'd histogram over SKEW_NB hash
    buckets marks buckets whose global probe count exceeds
    total/(2*ndev) as HOT; hot probe rows stay local while their build
    rows replicate to every shard, the rest shuffles as usual."""
    ndev = left.ndev
    auto = bucket_cap is None
    Bl = bucket_cap or default_bucket(left.shard_cap, ndev)
    Br = bucket_cap or default_bucket(right.shard_cap, ndev)
    if skew and broadcast:
        raise ExecutionError("dist_join: skew and broadcast are exclusive")
    if skew:
        # [local-hot | nonhot-recv] probe region; [gathered-hot | nonhot-recv] build
        lcap2 = left.shard_cap + ndev * Bl
        rcap2 = ndev * right.shard_cap + ndev * Br
    elif broadcast:
        lcap2 = left.shard_cap
        rcap2 = ndev * right.shard_cap
    else:
        lcap2 = ndev * Bl
        rcap2 = ndev * Br
    pair_cap = out_cap if out_cap is not None else fanout * max(lcap2, 1)
    if join_type in ("semi", "anti"):
        final_cap = lcap2
    else:
        final_cap = pair_cap
        if join_type in ("left", "full"):
            final_cap += lcap2
        if join_type in ("right", "full"):
            final_cap += rcap2

    def body(me, la, ra):
        (ld, lv, ln), (rd, rv, rn) = la, ra
        dev = _dev(left, me)
        lt = _local_view(left, ld, lv, dev)
        rt = _local_view(right, rd, rv, dev)
        lkeys, rkeys = _join_keys(lt, rt, on)
        lhash = K.hash_columns([K.hashable_key(c.data, c.dtype) for c in lkeys], [c.valid for c in lkeys])
        rhash = K.hash_columns([K.hashable_key(c.data, c.dtype) for c in rkeys], [c.valid for c in rkeys])
        hot_build_n = None
        if broadcast:
            # probe side untouched; the build side replicated in shard order
            g = yield from gather_columns(list(rd) + list(rv) + [rn.reshape(1)])
            nr = len(rd)
            lt2 = Table(list(left.names), lt.columns, ln, device=dev)
            rt2 = _segments_view(right, g[:nr], g[nr: 2 * nr], g[-1].reshape(ndev), right.shard_cap, dev)
            hot_build_n = rt2.nrows_dev  # the whole build is replicated
            sh_ovf = _i64(0, dev)
        elif not skew:
            _, _, lmap, lnew, l_ovf, lpd, lpv = yield from shuffle_split(
                [], [], ld, lv, ln, lhash, ndev, Bl)
            _, _, rmap, rnew, r_ovf, rpd, rpv = yield from shuffle_split(
                [], [], rd, rv, rn, rhash, ndev, Br)
            lt2 = _mapped_view(left, lpd, lpv, lmap, lnew, dev)
            rt2 = _mapped_view(right, rpd, rpv, rmap, rnew, dev)
            sh_ovf = torch.maximum(l_ovf, r_ovf)
        else:
            lc0, rc0 = left.shard_cap, right.shard_cap
            l_alive0 = torch.arange(lc0, device=dev) < ln
            r_alive0 = torch.arange(rc0, device=dev) < rn
            lb = lhash & (SKEW_NB - 1)
            rb = rhash & (SKEW_NB - 1)
            hist = torch.zeros(SKEW_NB + 2, dtype=torch.int64, device=dev)
            hist.scatter_add_(0, torch.where(l_alive0, lb, SKEW_NB), torch.ones_like(lb))
            hist[SKEW_NB + 1] = ln
            hist = yield Psum(hist)
            total_l = hist[SKEW_NB + 1]
            thresh = torch.clamp(total_l // (2 * ndev), min=64)
            hot = hist[:SKEW_NB] > thresh
            lhot = hot[lb] & l_alive0
            rhot = hot[rb] & r_alive0
            # probe: hot rows stay local, the rest moves by hash
            sl_d, sl_v, lnew0, l_ovf = yield from shuffle_by_dest(
                ld, lv, l_alive0 & ~lhot, hash_dest(lhash, ndev), ndev, Bl)
            lh_d, lh_v, nhot_l = K.filter_compact(tuple(ld), tuple(lv), lhot, lc0)
            lt2 = _concat_regions(left, [(lh_d, lh_v, nhot_l, lc0), (sl_d, sl_v, lnew0, ndev * Bl)], dev)
            # build: hot rows replicate to every shard, FIRST (at [0, H) in
            # one order on every shard, which the visited pmax relies on)
            sr_d, sr_v, rnew0, r_ovf = yield from shuffle_by_dest(
                rd, rv, r_alive0 & ~rhot, hash_dest(rhash, ndev), ndev, Br)
            rh_d, rh_v, nhot_r = K.filter_compact(tuple(rd), tuple(rv), rhot, rc0)
            nr = len(rd)
            g = yield from gather_columns(list(rh_d) + list(rh_v) + [nhot_r.reshape(1)])
            ghot = _segments_view(right, g[:nr], g[nr: 2 * nr], g[-1].reshape(ndev), rc0, dev)
            rt2 = _concat_regions(right, [
                ([c.data for c in ghot.columns], [c.valid for c in ghot.columns], ghot.nrows_dev, ndev * rc0),
                (sr_d, sr_v, rnew0, ndev * Br),
            ], dev)
            hot_build_n = ghot.nrows_dev
            sh_ovf = torch.maximum(l_ovf, r_ovf)
        cols, cnt, stats = yield from _local_join(
            me, lt2, rt2, lcap2, rcap2, on, join_type, filter, pair_cap, final_cap, hot_build_n)
        return cols, cnt, torch.cat([stats, sh_ovf.reshape(1)])

    args = [(la, ra) for la, ra in zip(left.shard_args(), right.shard_args())]
    res = run_spmd(left.mesh, body, args, "dist_join")
    overflow, total, sh_ovf = (int(x) for x in _host_max(left, [r[2] for r in res]))
    if sh_ovf > 0:
        if not auto:
            raise ExecutionError("dist_join: exchange bucket overflow at pinned bucket_cap")
        # The exchange overflowed (skew): a destination would need
        # ndev*(B+ovf) receive slots; beyond 2x an input shard the key
        # distribution is HOT and the skew hybrid is the right plan (the
        # reference decides from statistics, planner.rs:753-851),
        # otherwise one exact-sized bucket retry restores balance.
        need = round_capacity(max(Bl, Br) + sh_ovf)
        hot = ndev * need > 2 * max(left.shard_cap, right.shard_cap)
        if hot and not skew:
            res2 = dist_join(left, right, on, join_type, filter, fanout, bucket_cap=None, skew=True)
        else:
            res2 = dist_join(left, right, on, join_type, filter, fanout, bucket_cap=need, skew=skew)
        res2.exchange_info["retries"] = res2.exchange_info.get("retries", 0) + 1
        return res2
    if overflow > 0:
        if out_cap is not None:
            raise ExecutionError("distributed join output overflow after resize")
        # right-size ONE retry from the exact per-shard candidate totals
        res2 = dist_join(
            left, right, on, join_type, filter, fanout, bucket_cap,
            out_cap=round_capacity(max(total, 1)), skew=skew, broadcast=broadcast,
        )
        res2.exchange_info["retries"] = res2.exchange_info.get("retries", 0) + 1
        return res2
    if join_type in ("semi", "anti"):
        names, dtypes, dicts = list(left.names), list(left.dtypes), list(left.dicts)
    else:
        names = list(left.names) + list(right.names)
        dtypes = list(left.dtypes) + list(right.dtypes)
        dicts = list(left.dicts) + list(right.dicts)
    out = _assemble(left, names, dtypes, [r[0] for r in res], [r[1] for r in res], final_cap, dicts)
    return _attach_info(
        out,
        op="dist_join",
        mode="broadcast" if broadcast else ("skew" if skew else "hash"),
        bucket_cap=(Bl, Br),
        recv_cap=(lcap2, rcap2),
        pair_cap=pair_cap,
        retries=0,
        exchange_bytes=(
            _exchange_bytes(right.datas, 1, ndev * right.shard_cap) if broadcast
            else _exchange_bytes(left.datas, ndev, Bl) + _exchange_bytes(right.datas, ndev, Br)
        ),
    )


def _mapped_view(st: ShardedTable, pay_d, pay_v, pmap, n, dev) -> Table:
    """A split shuffle's payload columns in packed order (``pmap``: the
    receive slot of each packed row)."""
    cap = pmap.shape[0]
    live = torch.arange(cap, device=dev) < n
    cols = [
        Column(dt, K.gather(d, pmap), v[pmap] & live, dic)
        for dt, dic, d, v in zip(st.dtypes, st.dicts, pay_d, pay_v)
    ]
    return Table(list(st.names), cols, n, device=dev)


def _concat_regions(st: ShardedTable, regions: list, dev) -> Table:
    """Regions (datas, valids, live count, capacity), each live at its
    front, packed in order into one table of their total capacity."""
    alive = torch.cat([torch.arange(c, device=dev) < n for _, _, n, c in regions])
    datas = [torch.cat([r[0][i] for r in regions]) for i in range(len(st.dtypes))]
    valids = [torch.cat([r[1][i] for r in regions]) for i in range(len(st.dtypes))]
    out_d, out_v, cnt = K.filter_compact(tuple(datas), tuple(valids), alive, alive.shape[0])
    cols = [Column(dt, d, v, dic) for dt, dic, d, v in zip(st.dtypes, st.dicts, out_d, out_v)]
    return Table(list(st.names), cols, cnt, device=dev)


def _local_join(me, lt, rt, lcap, rcap, on, join_type, filter, pair_cap, final_cap, hot_build_n):
    """One shard's join of its probe rows ``lt`` with its build rows ``rt``
    (both packed, capacities lcap/rcap) at the static pair capacity.  A
    generator: the right and full joins over replicated build rows (the
    first ``hot_build_n``) pmax their visited mask.  Returns (output
    Columns, count, [pair overflow, candidate total])."""
    dev = lt.device
    ln, rn = lt.nrows_dev, rt.nrows_dev
    lkeys, rkeys = _join_keys(lt, rt, on)
    sorted_hash, border = K.join_build_sort(_key_hash(rkeys), rn)
    l_alive = torch.arange(lcap, device=dev) < ln
    probe_ok = l_alive
    for c in lkeys:
        probe_ok = probe_ok & c.valid
    lo, counts = K.join_probe_counts_binary(sorted_hash, _key_hash(lkeys), probe_ok, rn)
    probe_idx, build_idx, pair_alive, total = K.join_expand(lo, counts, border, pair_cap)
    ok = K.verify_equal(
        tuple(K.orderable_key(c.data, c.dtype) for c in lkeys), tuple(c.valid for c in lkeys),
        tuple(K.orderable_key(c.data, c.dtype) for c in rkeys), tuple(c.valid for c in rkeys),
        probe_idx, build_idx, pair_alive,
    )
    if filter is not None:
        pair = Table(
            list(lt.names) + list(rt.names),
            _side_columns(lt, probe_idx, pair_alive) + _side_columns(rt, build_idx, pair_alive),
            0, device=dev,
        )
        fres = filter.evaluate(pair)
        ok = ok & fres.data.to(torch.bool) & fres.valid
    stats = torch.stack([torch.clamp(total - pair_cap, min=0), total]).to(torch.int64)

    if join_type in ("semi", "anti"):
        matched = _matches_per_probe(counts, ok) > 0
        keep = (matched if join_type == "semi" else ~matched) & l_alive
        cols, cnt = _compact_cols(lt.columns, keep, final_cap)
        return cols, cnt, stats
    li_parts, ri_parts, keep_parts = [probe_idx], [build_idx], [ok]
    if join_type in ("left", "full"):
        li_parts.append(torch.arange(lcap, device=dev))
        ri_parts.append(torch.full((lcap,), -1, dtype=torch.int64, device=dev))
        keep_parts.append(l_alive & ~(_matches_per_probe(counts, ok) > 0))
    if join_type in ("right", "full"):
        visited = torch.zeros(rcap, dtype=torch.int32, device=dev)
        visited.index_add_(0, build_idx, ok.to(torch.int32))
        visited = visited > 0
        r_alive = torch.arange(rcap, device=dev) < rn
        if hot_build_n is not None:
            # replicated build rows sit at [0, H) in one order on every
            # shard: visited if ANY shard matched it, emitted by shard 0
            in_hot = torch.arange(rcap, device=dev) < hot_build_n
            vis_glob = (yield Pmax(visited.to(torch.int32))) > 0
            visited = torch.where(in_hot, vis_glob, visited)
            r_alive = r_alive & (~in_hot | (me == 0))
        li_parts.append(torch.full((rcap,), -1, dtype=torch.int64, device=dev))
        ri_parts.append(torch.arange(rcap, device=dev))
        keep_parts.append(r_alive & ~visited)
    li, ri, keep = torch.cat(li_parts), torch.cat(ri_parts), torch.cat(keep_parts)
    sel = K.keep_index(keep, final_cap)
    cnt = keep.sum()
    live = torch.arange(final_cap, device=dev) < cnt
    return _side_columns(lt, li[sel], live) + _side_columns(rt, ri[sel], live), cnt, stats


# ---------------------------------------------------------------------------
# distributed ORDER BY: sample -> range partition -> all-to-all -> local sort
# ---------------------------------------------------------------------------

_SORT_SAMPLES = 64  # per shard


def _desc_key(k: torch.Tensor) -> torch.Tensor:
    return -k if k.is_floating_point() else torch.bitwise_not(k)


def dist_sort(st: ShardedTable, sort_exprs, bucket_cap: int | None = None):
    """Globally sort a sharded table: afterwards shard i's rows all order
    before shard i+1's and each shard is locally sorted, so reading shards
    in order yields the total order.

    The reference coalesces to one partition for ORDER BY; this is the
    TeraSort-style improvement: each shard samples its first sort key, the
    all-gathered samples define ndev-1 range boundaries, rows route to
    their range's shard with one all-to-all, and each shard sorts locally
    by the full key list.  Rows equal to a boundary all land on one shard
    (strict comparison), so ties never straddle shards.

    Returns (ShardedTable, overflow): overflow > 0 means a shard's range
    exceeded bucket_cap (heavy skew); retry with a bigger bucket_cap."""
    ndev = st.ndev
    ncols = len(st.datas)
    cap = st.shard_cap
    auto = bucket_cap is None
    B = bucket_cap or default_bucket(cap, ndev)
    s0 = sort_exprs[0]
    S = _SORT_SAMPLES
    fcap = ndev * B

    def body(me, datas, valids, n):
        dev = _dev(st, me)
        t = _local_view(st, datas, valids, dev)
        alive = local_alive(cap, n)
        # first-key total order: (null rank, transformed key)
        c0 = s0.expr.evaluate(t)
        k0 = K.orderable_key(c0.data, c0.dtype)
        if not s0.ascending:
            k0 = _desc_key(k0)
        nr0 = torch.where(c0.valid, 1, 0 if s0.nulls_first else 2).to(torch.int32)
        # S samples per shard, evenly spaced over its live rows in key order
        perm = K.sort_perm((~alive, nr0, k0))
        snr, sk = nr0[perm], K.gather(k0, perm)
        nlive = alive.sum()
        pos = torch.clamp((torch.arange(S, device=dev) * torch.clamp(nlive, min=1)) // S, 0, cap - 1)
        samp_nr = torch.where(torch.arange(S, device=dev) < torch.clamp(nlive, max=S), snr[pos], 3)
        samp_k = K.gather(sk, pos)
        all_nr, all_k = yield from gather_columns([samp_nr.to(torch.int32), samp_k])
        all_nr, all_k = all_nr.reshape(-1), all_k.reshape(-1)
        order = K.sort_perm((all_nr, all_k))
        all_nr, all_k = all_nr[order], K.gather(all_k, order)
        n_samp = (all_nr < 3).sum()
        bpos = torch.clamp(
            ((torch.arange(ndev - 1, device=dev) + 1) * torch.clamp(n_samp, min=1)) // ndev, 0, ndev * S - 1
        )
        b_nr, b_k = all_nr[bpos], K.gather(all_k, bpos)
        # shard = number of boundaries strictly below the row's key
        gt = (nr0[None, :] > b_nr[:, None]) | ((nr0[None, :] == b_nr[:, None]) & (k0[None, :] > b_k[:, None]))
        dest = gt.sum(0)
        key_cols = [s.expr.evaluate(t) for s in sort_exprs]
        ordkeys = [K.orderable_key(c.data, c.dtype) for c in key_cols]
        kd, kv, pay_d, pay_v, keep, new_n, ovf = yield from shuffle_exchange_dest(
            ordkeys, [c.valid for c in key_cols], datas, valids, alive, dest, ndev, B
        )
        moved, _ = K.lexsort_apply(
            tuple(kd), tuple(kv), tuple(pay_d) + tuple(pay_v), new_n,
            tuple(not s.ascending for s in sort_exprs), tuple(s.nulls_first for s in sort_exprs),
            dead_mask=~keep,
        )
        live = torch.arange(fcap, device=dev) < new_n
        cols = [Column(dt, d, v & live, dic)
                for dt, dic, d, v in zip(st.dtypes, st.dicts, moved[:ncols], moved[ncols:])]
        return cols, new_n, ovf

    res = run_spmd(st.mesh, body, st.shard_args(), "dist_sort")
    ovf = int(_host_max(st, [r[2] for r in res])[0])
    if ovf > 0 and auto:
        # sampled boundaries put more than B rows of one shard into one
        # range (value skew): ONE exact-deficit retry
        st2, r_ovf = dist_sort(st, sort_exprs, bucket_cap=round_capacity(B + ovf))
        st2.exchange_info["retries"] = st2.exchange_info.get("retries", 0) + 1
        return st2, r_ovf
    st2 = _assemble(st, st.names, st.dtypes, [r[0] for r in res], [r[1] for r in res], fcap, st.dicts)
    _attach_info(
        st2, op="dist_sort", mode="range", bucket_cap=B, recv_cap=fcap, retries=0,
        exchange_bytes=_exchange_bytes(st.datas, ndev, B),
    )
    return st2, ovf


# ---------------------------------------------------------------------------
# window functions on the mesh
# ---------------------------------------------------------------------------


def dist_window(st: ShardedTable, window_exprs, bucket_cap: int | None = None):
    """Partitioned window functions: all-to-all rows by PARTITION BY key
    hash (whole partitions land on one shard), then the single-device
    window (ops/window.py) per shard.  Windows without PARTITION BY go to
    dist_window_global.

    Returns (ShardedTable, overflow); output rows are in (partition,
    order) sorted order WITHIN each shard."""
    from ..ops.window import WindowAggExec

    w0 = window_exprs[0]
    if not w0.partition_by:
        raise ExecutionError("dist_window: window without PARTITION BY requires a total order")
    ndev = st.ndev
    auto = bucket_cap is None
    B = bucket_cap or default_bucket(st.shard_cap, ndev)
    fcap = ndev * B
    op = WindowAggExec(list(window_exprs), None)

    def body(me, datas, valids, n):
        dev = _dev(st, me)
        t = _local_view(st, datas, valids, dev)
        pcols = [p.evaluate(t) for p in w0.partition_by]
        phash = K.hash_columns([K.hashable_key(c.data, c.dtype) for c in pcols], [c.valid for c in pcols])
        sh_d, sh_v, new_n, ovf = yield from shuffle_by_hash(datas, valids, n, phash, ndev, B)
        _, out_cols = op._traced_window(_local_view(st, sh_d, sh_v, dev), new_n, fcap)
        return out_cols, new_n, ovf

    res = run_spmd(st.mesh, body, st.shard_args(), "dist_window")
    ovf = int(_host_max(st, [r[2] for r in res])[0])
    if ovf > 0 and auto:
        # hot PARTITION BY key: one exact-deficit retry
        st2, r_ovf = dist_window(st, window_exprs, bucket_cap=round_capacity(B + ovf))
        st2.exchange_info["retries"] = st2.exchange_info.get("retries", 0) + 1
        return st2, r_ovf
    names = list(st.names) + [w.name for w in window_exprs]
    dtypes = list(st.dtypes) + [w.dtype for w in window_exprs]
    dicts = list(st.dicts) + [_win_dict(w, st) for w in window_exprs]
    st2 = _assemble(st, names, dtypes, [r[0] for r in res], [r[1] for r in res], fcap, dicts)
    _attach_info(
        st2, op="dist_window", mode="partition_hash", bucket_cap=B, recv_cap=fcap, retries=0,
        exchange_bytes=_exchange_bytes(st.datas, ndev, B),
    )
    return st2, ovf


def _win_dict(w, st: ShardedTable):
    """Dictionary of a window output column: value-passing functions
    (first/last/nth_value, lag/lead, min/max) re-emit their argument's
    codes; everything else is numeric."""
    if w.fun in ("first_value", "last_value", "nth_value", "lag", "lead", "min", "max") and w.args:
        return w.args[0].evaluate(_sample_view(st)).dictionary
    return None


# ---------------------------------------------------------------------------
# UNION, LIMIT, OFFSET on the mesh
# ---------------------------------------------------------------------------


def dist_union(parts: list[ShardedTable], schema) -> ShardedTable:
    """Shard-wise UNION ALL: each shard concatenates its own segments of
    every input and packs them (UnionExec concatenates child partition
    lists, union.rs:34; the shard IS the partition here).  Casts and the
    string-dictionary merge are the single-device concat_tables'."""
    first = parts[0]

    def body(me, *shards):
        dev = _dev(first, me)
        tables = [
            Table(list(p.names), [Column(dt, d, v, dic) for dt, dic, d, v in zip(p.dtypes, p.dicts, sd, sv)],
                  n, device=dev)
            for p, (sd, sv, n) in zip(parts, shards)
        ]
        out = concat_tables(tables, schema)
        return out.columns, out.nrows_dev, out.capacity

    args = list(zip(*[p.shard_args() for p in parts]))
    res = run_spmd(first.mesh, body, args, "dist_union")
    out = _assemble(first, schema.names(), [f.dtype for f in schema.fields],
                    [r[0] for r in res], [r[1] for r in res], res[0][2])
    return _attach_info(out, op="dist_union", mode="shard_concat", recv_cap=out.shard_cap, exchange_bytes=0)


def dist_limit(st: ShardedTable, n: int) -> ShardedTable:
    """Global LIMIT without moving a row: to_table gathers in shard order,
    so the first N global rows are each shard's prefix of
    clip(N - rows on earlier shards, 0, local n).  One all-gather of the
    counts, then every shard truncates its live count (limit.rs:44)."""

    def body(me, datas, valids, cnt):
        counts = (yield AllGather(cnt.reshape(1))).reshape(-1)
        return torch.clamp(n - counts[:me].sum(), min=0, max=None).minimum(cnt)

    res = run_spmd(st.mesh, body, st.shard_args(), "dist_limit")
    return ShardedTable(list(st.names), list(st.dtypes), list(st.dicts), st.datas, st.valids,
                        stack_counts(res, st.mesh), st.mesh, st.shard_cap)


def dist_skip(st: ShardedTable, n: int) -> ShardedTable:
    """Global OFFSET (fork skip.rs:41): shard i drops clip(N - rows on
    earlier shards, 0, local n) rows from its front and repacks."""
    cap = st.shard_cap

    def body(me, datas, valids, cnt):
        counts = (yield AllGather(cnt.reshape(1))).reshape(-1)
        drop = torch.clamp(n - counts[:me].sum(), min=0).minimum(cnt)
        ar = torch.arange(cap, device=cnt.device)
        keep = (ar >= drop) & (ar < cnt)
        out_d, out_v, c = K.filter_compact(tuple(datas), tuple(valids), keep, cnt)
        return out_d, out_v, c

    res = run_spmd(st.mesh, body, st.shard_args(), "dist_skip")
    ncols = len(st.datas)
    return st.with_columns(
        st.names, st.dtypes, st.dicts,
        [[r[0][c] for r in res] for c in range(ncols)],
        [[r[1][c] for r in res] for c in range(ncols)],
        [r[2] for r in res], cap,
    )


# ---------------------------------------------------------------------------
# windows WITHOUT PARTITION BY on the mesh
# ---------------------------------------------------------------------------

_GLOBAL_WIN_AGGS = ("count", "sum", "avg", "mean", "min", "max")
_GLOBAL_WIN_FUNS = (
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
    "ntile", "lag", "lead", "first_value", "last_value", "nth_value",
) + _GLOBAL_WIN_AGGS

# explicit ROWS frames distribute with a static edge halo: bounded offsets
# up to this many rows cross shard boundaries
_DIST_FRAME_HALO = 128


def _frame_deltas(fr):
    """Signed row deltas (start, end) relative to the current row; None
    means unbounded."""

    def delta(b):
        if b.kind == "current":
            return 0
        if b.offset is None:
            return None
        off = int(b.offset)
        return -off if b.kind == "preceding" else off

    return delta(fr.start), delta(fr.end)


def _dist_frame_eligible(w) -> bool:
    """Mesh-native explicit frames: ROWS with bounded offsets <= the halo;
    RANGE frames over ONE numeric ORDER BY key, resolved by bisecting the
    halo-extended key plane with a device-side coverage flag.  GROUPS
    offsets and suffix frames gather."""
    if w.fun not in _GLOBAL_WIN_AGGS:
        return True  # frames apply only to aggregates
    fr = w.frame
    if fr.units == "range":
        if len(w.order_by) != 1:
            return False
        dt = w.order_by[0].expr.dtype
        if not (dt.is_integer or dt.is_float or dt.is_decimal or dt.kind in ("date32", "timestamp_us")):
            return False
        if fr.end.offset is None and fr.end.kind != "current":
            return False  # UNBOUNDED FOLLOWING end
        if fr.start.offset is None and fr.start.kind not in ("preceding", "current"):
            return False
        try:
            for b in (fr.start, fr.end):
                if b.offset is not None:
                    _range_value_offset(b.offset, dt)
        except Exception:
            return False  # offset incompatible with the key dtype
        return True
    if fr.units != "rows":
        return False
    a, b = _frame_deltas(fr)
    if b is None or abs(b) > _DIST_FRAME_HALO:
        return False
    if a is None:
        return b >= 0  # running frame [start of table, i+b]
    return abs(a) <= _DIST_FRAME_HALO


def _range_value_offset(x, dtype):
    """A RANGE offset on the SQL value axis in the ORDER BY key's storage
    units (decimal offsets scale by 10^s, integer keys need integral
    offsets), as ops/window.py converts them."""
    if dtype.is_decimal:
        v = Fraction(str(x)) * (10 ** dtype.scale)
        if v.denominator != 1:
            raise PlanError("RANGE offset finer than the ORDER BY decimal scale")
        return int(v)
    if dtype.is_float:
        return float(x)
    fx = float(x)
    if fx != int(fx):
        raise PlanError("RANGE offset must be an integer for integer ORDER BY keys")
    return int(fx)


def global_window_eligible(window_exprs) -> bool:
    """True when a no-PARTITION-BY window node can run mesh-native through
    dist_window_global: a host-side STRUCTURAL check (the executor gathers,
    the reference's SinglePartition plan, when it is False)."""
    from ..exprs.physical import PhysLit

    if any(w.partition_by for w in window_exprs):
        return False
    # every expr's ORDER BY must be a prefix of the longest one
    sigs = [tuple((str(s.expr), s.ascending, s.nulls_first) for s in w.order_by) for w in window_exprs]
    longest = max(sigs, key=len)
    if any(sig != longest[: len(sig)] for sig in sigs):
        return False
    for w, sig in zip(window_exprs, sigs):
        if w.frame is not None and not _dist_frame_eligible(w):
            return False
        if w.fun not in _GLOBAL_WIN_FUNS:
            return False
        if not sig and w.fun not in _GLOBAL_WIN_AGGS:
            return False  # ranking/value functions need a total order
        if w.fun in ("lag", "lead"):
            if len(w.args) > 1 and not isinstance(w.args[1], PhysLit):
                return False  # the offset must be static for the edge halo
            if len(w.args) > 1 and not (0 <= int(w.args[1].value.value or 0) <= 4096):
                return False
    return True


def _owner(j: torch.Tensor, ends: torch.Tensor, ndev: int) -> torch.Tensor:
    """The shard holding global row j: the first shard whose end exceeds j."""
    return torch.clamp((ends[None, :] <= j[:, None]).sum(1), 0, ndev - 1)


def _halo_ext(plane, fill, ctx, fill_lo=None):
    """A generator: the extended per-shard view of a row-aligned plane,
    ext[q] = the plane's value at GLOBAL row (row_off - H + q), q in
    [0, fcap + 2H), from all-gathered [ndev, H] head and tail edge planes
    (a frame spanning several tiny shards still resolves exactly).  Out
    of the table positions read ``fill`` (``fill_lo`` before row 0)."""
    H = _DIST_FRAME_HALO
    nloc, fcap, ndev, row_off = ctx["nloc"], ctx["fcap"], ctx["ndev"], ctx["row_off"]
    ends, offsets, N = ctx["ends"], ctx["offsets"], ctx["N"]
    dev = plane.device
    fillv = torch.full((), fill, dtype=plane.dtype, device=dev) if not torch.is_tensor(fill) else fill
    hidx = torch.arange(H, device=dev)
    if fcap < H:
        plane = torch.cat([plane, fillv.expand(H - fcap)])
    head = torch.where(hidx < nloc, plane[:H], fillv)
    tpos = nloc - H + hidx
    tail = torch.where(tpos >= 0, plane[torch.clamp(tpos, 0, plane.shape[0] - 1)], fillv)
    heads_all, tails_all = yield from gather_columns([head, tail])
    q = torch.arange(fcap + 2 * H, device=dev)
    j = row_off - H + q
    in_table = (j >= 0) & (j < N)
    is_local = (j >= row_off) & (j < row_off + nloc)
    s = _owner(j, ends, ndev)
    d_head = j - offsets[s]
    hv = heads_all[s, torch.clamp(d_head, 0, H - 1)]
    tv = tails_all[s, torch.clamp(H - (ends[s] - j), 0, H - 1)]
    remote = torch.where(d_head < H, hv, tv)
    local = plane[torch.clamp(j - row_off, 0, fcap - 1)]
    out = torch.where(is_local, local, remote)
    out = torch.where(in_table, out, fillv)
    if fill_lo is not None:
        out = torch.where(j < 0, torch.full((), fill_lo, dtype=out.dtype, device=dev), out)
    return out


def _key_limits(key: torch.Tensor):
    if key.is_floating_point():
        return float("inf"), float("-inf")
    info = torch.iinfo(key.dtype)
    return info.max, info.min


def _range_ext_bounds(w, t, ctx):
    """A generator: RANGE-with-offset frame bounds in halo-extended
    coordinates, a per-row bisect of the sorted ORDER BY key plane extended
    across shard edges (_halo_ext), the local engine's range bounds over a
    distributed plane.  Returns (lo_idx or None for running frames,
    hi_idx, overflow): overflow flags a live row whose value window
    reaches past the halo, or a NULL order key; the caller then gathers."""
    H = _DIST_FRAME_HALO
    fcap, nloc, alive, row_off, N = ctx["fcap"], ctx["nloc"], ctx["alive"], ctx["row_off"], ctx["N"]
    s = w.order_by[0]
    c = s.expr.evaluate(t)
    key = K.orderable_key(c.data, c.dtype)
    if s.ascending is False:
        key = -key  # frames live on the sort direction's axis
    extcap = fcap + 2 * H
    kmax, kmin = _key_limits(key)
    ext = yield from _halo_ext(key, kmax, ctx, fill_lo=kmin)
    # past the guaranteed coverage (H beyond this shard's live end) the
    # plane may read other shards: pin it to +max to keep it monotone; the
    # coverage flag catches windows that reach there
    qlim = H + nloc + H
    q = torch.arange(extcap, device=key.device)
    ext = torch.where(q < qlim, ext, torch.full((), kmax, dtype=ext.dtype, device=ext.device))

    def bisect(target, right):
        lo = torch.zeros(fcap, dtype=torch.int64, device=key.device)
        hi = torch.full((fcap,), extcap, dtype=torch.int64, device=key.device)
        for _ in range(int(np.ceil(np.log2(max(extcap, 2)))) + 1):
            mid = (lo + hi) // 2
            mv = ext[torch.clamp(mid, 0, extcap - 1)]
            go = (mv <= target) if right else (mv < target)
            lo = torch.where(go, mid + 1, lo)
            hi = torch.where(go, hi, mid)
        return lo

    def off(x):
        return _range_value_offset(x, c.dtype)

    fr = w.frame
    running = fr.start.kind == "preceding" and fr.start.offset is None
    lo_idx = None
    if not running:
        if fr.start.kind == "preceding":
            lo_idx = bisect(key - off(fr.start.offset), right=False)
        elif fr.start.kind == "current":
            lo_idx = bisect(key, right=False)
        else:
            lo_idx = bisect(key + off(fr.start.offset), right=False)
    if fr.end.kind == "current":
        hi_idx = bisect(key, right=True) - 1
    elif fr.end.kind == "following":
        hi_idx = bisect(key + off(fr.end.offset), right=True) - 1
    else:
        hi_idx = bisect(key - off(fr.end.offset), right=True) - 1
    flag = torch.zeros((), dtype=torch.bool, device=key.device)
    if lo_idx is not None:
        flag = flag | ((alive & (lo_idx == 0)).any() & (row_off - H > 0))
    flag = flag | ((alive & (hi_idx >= qlim - 1)).any() & (row_off + nloc < N))
    # NULL order keys break the plane's monotonicity: flag and gather
    flag = flag | (alive & ~c.valid).any()
    return lo_idx, hi_idx, flag


def _prefix_across(ctx, shard_total):
    """A generator: the sum of a per-shard scalar over the shards before
    this one."""
    g = (yield AllGather(shard_total.reshape(1))).reshape(-1)
    return g[: ctx["me"]].sum()


def _framed_window_aggregate(f, w, varg, mask, ctx):
    """A generator: an explicit frame over the mesh (no PARTITION BY).
    ROWS frames [i+a, i+b] read at most _DIST_FRAME_HALO rows beyond the
    shard edge through `_halo_ext`; RANGE frames bisect the halo-extended
    key plane; running frames add the preceding shards' totals.  Returns
    (data, valid, overflow flag)."""
    from ..ops.window import _range_minmax

    H = _DIST_FRAME_HALO
    fcap, alive = ctx["fcap"], ctx["alive"]
    dev = alive.device
    ar = torch.arange(fcap, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    if w.frame.units == "range":
        lo_idx, hi_idx, ovf = yield from _range_ext_bounds(w, ctx["t"], ctx)
        running = lo_idx is None
    else:
        a, b = _frame_deltas(w.frame)
        hi_idx = ar + H + b
        running = a is None
        lo_idx = None if running else ar + H + a

    def ext_sum(c, lo_i, hi_i):
        n = c.shape[0]
        hi_v = c[torch.clamp(hi_i, 0, n - 1)]
        zero = torch.zeros((), dtype=c.dtype, device=dev)
        lo_v = torch.where(lo_i - 1 >= 0, c[torch.clamp(lo_i - 1, 0, n - 1)], zero)
        return torch.where(hi_i >= lo_i, hi_v - lo_v, zero)

    start = torch.full((fcap,), H, dtype=torch.int64, device=dev)

    def framed_sum(x):
        cx = torch.cumsum((yield from _halo_ext(x, torch.zeros((), dtype=x.dtype, device=dev), ctx)), 0)
        if running:
            return (yield from _prefix_across(ctx, x.sum())) + ext_sum(cx, start, hi_idx)
        return ext_sum(cx, lo_idx, hi_idx)

    cnt = yield from framed_sum(mask.to(torch.int64))
    if f == "count":
        return cnt, alive, ovf
    has = cnt > 0
    if f in ("sum", "avg", "mean"):
        if f == "sum":
            acc = varg.data.to(_storage(w.dtype))
            x = torch.where(mask, acc, torch.zeros((), dtype=acc.dtype, device=dev))
        else:
            x = torch.where(mask, to_float(varg.data, varg.dtype), 0.0)
        s = yield from framed_sum(x)
        if f == "sum":
            return s, alive & has, ovf
        return s / torch.clamp(cnt, min=1), alive & has, ovf
    # min / max
    x, neutral = _minmax_plane(f, varg, mask)
    ext = yield from _halo_ext(x, neutral, ctx)
    extcap = fcap + 2 * H
    opfn = K.xla_minimum if f == "min" else K.xla_maximum
    if running:
        # prior shards reduce wholly; the ext's tail region is a subset of
        # them, so including it in the running reduce is idempotent
        red = x.amin() if f == "min" else x.amax()
        g = (yield AllGather(red.reshape(1))).reshape(-1)
        prior = _reduce_prior(g, ctx["me"], f, neutral)
        run = torch.cummin(ext, 0).values if f == "min" else torch.cummax(ext, 0).values
        out = opfn(prior, run[torch.clamp(hi_idx, 0, extcap - 1)])
    else:
        lo_p = torch.cat([lo_idx, lo_idx.new_zeros(2 * H)])
        hi_p = torch.cat([hi_idx, hi_idx.new_full((2 * H,), -1)])
        out = _range_minmax(ext, lo_p, hi_p, opfn, neutral, None)[:fcap]
    return out.to(_storage(varg.dtype)), alive & has, ovf


def _storage(dtype) -> torch.dtype:
    from ..device import torch_dtype

    return torch_dtype(dtype.storage_np_dtype())


def _minmax_plane(f, varg, mask):
    """(plane, neutral) of a min or max: float values, or integer orderable
    keys, with the masked-out rows at the reduction's identity."""
    if varg.dtype.is_float:
        neutral = float("inf") if f == "min" else float("-inf")
        x = torch.where(mask, varg.data, torch.full((), neutral, dtype=varg.data.dtype, device=mask.device))
    else:
        x = K.orderable_key(varg.data, varg.dtype)
        info = torch.iinfo(x.dtype)
        neutral = info.max if f == "min" else info.min
        x = torch.where(mask, x, torch.full((), neutral, dtype=x.dtype, device=mask.device))
    return x, neutral


def _reduce_prior(g, me, f, neutral):
    """The min (max) of the per-shard reductions ``g`` of the shards
    before ``me``; the identity when there are none."""
    prior = g[:me]
    if prior.numel() == 0:
        return torch.full((), neutral, dtype=g.dtype, device=g.device)
    return prior.amin() if f == "min" else prior.amax()


def dist_window_global(st: ShardedTable, window_exprs):
    """Windows WITHOUT PARTITION BY over the mesh, which the reference pins
    to a single partition (window_agg_exec.rs requires SinglePartition).

    With ORDER BY: range-partition the rows by the ORDER BY keys
    (dist_sort; ties co-locate because routing uses the first key only),
    evaluate every window per shard, then apply O(ndev)-sized collective
    corrections: ranking functions add row/dense-rank offsets, running
    aggregates add the preceding shards' totals, lag/lead exchange a
    static edge halo, first/nth_value broadcast the global head rows.
    Without ORDER BY (whole-table aggregates): per-shard totals all-reduce
    and no row moves.

    Returns (ShardedTable, overflow) like dist_window; overflow -1 means a
    RANGE frame's value window reached past the halo (the executor
    gathers)."""
    from ..ops.window import _peers

    if not global_window_eligible(window_exprs):
        raise ExecutionError("dist_window_global: structure not eligible")
    order_by = max((list(w.order_by) for w in window_exprs), key=len)
    ndev = st.ndev
    if order_by:
        sorted_st, s_ovf = dist_sort(st, order_by)
        if s_ovf > 0:
            return sorted_st, s_ovf
    else:
        sorted_st = st
    fcap = sorted_st.shard_cap

    def body(me, datas, valids, nloc):
        dev = _dev(st, me)
        t = _local_view(sorted_st, datas, valids, dev)
        ar = torch.arange(fcap, device=dev)
        alive = ar < nloc
        cnts = (yield AllGather(nloc.reshape(1))).reshape(-1)
        ends = torch.cumsum(cnts, 0)
        offsets = ends - cnts
        row_off = offsets[me]
        N = ends[ndev - 1]
        rn0 = row_off + ar
        ctx = dict(nloc=nloc, fcap=fcap, ndev=ndev, me=me, row_off=row_off, ends=ends,
                   offsets=offsets, N=N, alive=alive, t=t)
        peer_cache: dict = {}

        def peers(oby):
            """(boundary, peer start, peer end) for one ORDER BY list (a
            prefix of the global sort order)."""
            sig = tuple((str(s.expr), s.ascending, s.nulls_first) for s in oby)
            if sig not in peer_cache:
                boundary = torch.zeros(fcap, dtype=torch.bool, device=dev)
                if oby:
                    for s in oby:
                        c = s.expr.evaluate(t)
                        boundary = K._boundary_accum(boundary, K.orderable_key(c.data, c.dtype), c.valid)
                    # dead rows carry arbitrary keys: a boundary at the first
                    # dead row ends the last peer group at nloc - 1
                    boundary = boundary | (ar == nloc)
                    boundary[:1].fill_(True)
                    ps, pe = _peers(boundary)
                else:
                    boundary[:1].fill_(True)
                    ps = torch.zeros(fcap, dtype=torch.int64, device=dev)
                    pe = torch.clamp(nloc - 1, min=0).expand(fcap)
                peer_cache[sig] = (boundary, ps, pe)
            return peer_cache[sig]

        out_d, out_v = [], []
        frame_ovf = torch.zeros((), dtype=torch.bool, device=dev)
        for w in window_exprs:
            f = w.fun
            if f == "row_number":
                out_d.append((rn0 + 1).to(torch.uint64))
                out_v.append(alive)
                continue
            if f == "rank":
                _, ps, _ = peers(w.order_by)
                out_d.append((row_off + ps + 1).to(torch.uint64))
                out_v.append(alive)
                continue
            if f == "dense_rank":
                b, _, _ = peers(w.order_by)
                local_d = torch.cumsum(b.to(torch.int64), 0)
                d_off = yield from _prefix_across(ctx, (b & alive).sum())
                out_d.append((d_off + local_d).to(torch.uint64))
                out_v.append(alive)
                continue
            if f == "percent_rank":
                _, ps, _ = peers(w.order_by)
                grank = (row_off + ps).to(torch.float64)
                out_d.append(grank / torch.clamp(N - 1, min=1).to(torch.float64))
                out_v.append(alive)
                continue
            if f == "cume_dist":
                _, _, pe = peers(w.order_by)
                le = (row_off + pe + 1).to(torch.float64)
                out_d.append(le / torch.clamp(N, min=1).to(torch.float64))
                out_v.append(alive)
                continue
            if f == "ntile":
                nt = w.args[0].evaluate(t).data.to(torch.int64)
                out_d.append(((rn0 * nt) // torch.clamp(N, min=1) + 1).to(torch.uint64))
                out_v.append(alive)
                continue
            if f in ("lag", "lead"):
                v = w.args[0].evaluate(t)
                koff = int(w.args[1].value.value or 0) if len(w.args) > 1 else 1
                data, valid = yield from _shifted(v, koff, f == "lag", ctx)
                out_d.append(data)
                out_v.append(valid & alive)
                continue
            if f in ("first_value", "last_value", "nth_value"):
                v = w.args[0].evaluate(t)
                if f == "first_value":
                    src = torch.zeros((), dtype=torch.int64, device=dev)
                elif f == "last_value":
                    # the single-device engine reads the partition end:
                    # the global last row
                    src = N - 1
                else:
                    src = w.args[1].evaluate(t).data[0].to(torch.int64) - 1
                data, ok = yield from _global_row(v, src, ctx)
                out_d.append(data.expand(fcap).clone())
                out_v.append(alive & ok)
                continue
            # running / whole-table aggregates over the default frame
            # [global row 0, current peer end], or the whole table
            varg = w.args[0].evaluate(t) if w.args else None
            mask = (varg.valid & alive) if varg is not None else alive
            if w.frame is not None:
                d, v_, f_ovf = yield from _framed_window_aggregate(f, w, varg, mask, ctx)
                frame_ovf = frame_ovf | f_ovf
                out_d.append(d)
                out_v.append(v_)
                continue
            ordered = bool(w.order_by)
            pe = torch.clamp(peers(w.order_by)[2], 0, fcap - 1) if ordered else None

            def frame_sum(x):
                total = x.sum()
                if ordered:
                    return (yield from _prefix_across(ctx, total)) + torch.cumsum(x, 0)[pe]
                g = (yield AllGather(total.reshape(1))).reshape(-1)
                return g.sum().expand(fcap).clone()

            gcount = yield from frame_sum(mask.to(torch.int64))
            if f == "count":
                out_d.append(gcount)
                out_v.append(alive)
                continue
            has = gcount > 0
            if f == "sum":
                acc = varg.data.to(_storage(w.dtype))
                x = torch.where(mask, acc, torch.zeros((), dtype=acc.dtype, device=dev))
                out_d.append((yield from frame_sum(x)))
                out_v.append(alive & has)
                continue
            if f in ("avg", "mean"):
                x = torch.where(mask, to_float(varg.data, varg.dtype), 0.0)
                out_d.append((yield from frame_sum(x)) / torch.clamp(gcount, min=1))
                out_v.append(alive & has)
                continue
            if f in ("min", "max"):
                x, neutral = _minmax_plane(f, varg, mask)
                red = x.amin() if f == "min" else x.amax()
                g = (yield AllGather(red.reshape(1))).reshape(-1)
                if ordered:
                    opfn = K.xla_minimum if f == "min" else K.xla_maximum
                    run = torch.cummin(x, 0).values if f == "min" else torch.cummax(x, 0).values
                    out = opfn(_reduce_prior(g, me, f, neutral), run[pe])
                else:
                    out = (g.amin() if f == "min" else g.amax()).expand(fcap)
                out_d.append(out.to(_storage(varg.dtype)))
                out_v.append(alive & has)
                continue
            raise ExecutionError(f"dist_window_global: '{f}' unreachable")
        cols = list(t.columns) + [
            Column(w.dtype, d, v) for w, d, v in zip(window_exprs, out_d, out_v)
        ]
        return cols, nloc, frame_ovf.to(torch.int64)

    res = run_spmd(st.mesh, body, sorted_st.shard_args(), "dist_window_global")
    names = list(st.names) + [w.name for w in window_exprs]
    dtypes = list(st.dtypes) + [w.dtype for w in window_exprs]
    dicts = list(st.dicts) + [_win_dict(w, st) for w in window_exprs]
    st2 = _assemble(st, names, dtypes, [r[0] for r in res], [r[1] for r in res], fcap, dicts)
    _attach_info(
        st2, op="dist_window_global", mode="range_order" if order_by else "all_reduce",
        recv_cap=fcap, retries=0,
        exchange_bytes=_exchange_bytes(st.datas, ndev, fcap // ndev) if order_by else 0,
    )
    # RANGE-frame halo coverage: -1 when some row's value window reaches
    # past the exchanged halo (or a null order key breaks the bisect), a
    # DATA condition on which the executor gathers even in strict mode
    ovf = 0
    if any(w.frame is not None and w.frame.units == "range" for w in window_exprs if w.fun in _GLOBAL_WIN_AGGS):
        ovf = -1 if int(_host_max(st, [r[2] for r in res])[0]) > 0 else 0
    return st2, ovf


def _shifted(v, koff: int, lag: bool, ctx):
    """A generator: lag (lead) by ``koff`` rows over the global row order,
    the rows that cross a shard edge read from an all-gathered halo of
    every shard's last (first) E rows.  Returns (data, valid)."""
    nloc, fcap, ndev = ctx["nloc"], ctx["fcap"], ctx["ndev"]
    ends, offsets, row_off, N = ctx["ends"], ctx["offsets"], ctx["row_off"], ctx["N"]
    dev = v.data.device
    cnts = ends - offsets
    E = max(koff, 1)
    je = torch.arange(E, device=dev)
    ar = torch.arange(fcap, device=dev)
    rn0 = row_off + ar
    if lag:
        e_pos = nloc - E + je
        e_idx = torch.clamp(e_pos, 0, fcap - 1)
        g_d, g_v = yield from gather_columns([K.gather(v.data, e_idx), v.valid[e_idx] & (e_pos >= 0)])
        # buf[j] = the value at global row row_off - E + j
        p = row_off - E + je
        src_s = _owner(p, ends, ndev)
        j2 = p - offsets[src_s] - (cnts[src_s] - E)
    else:
        e_idx = torch.clamp(je, 0, fcap - 1)
        g_d, g_v = yield from gather_columns([K.gather(v.data, e_idx), v.valid[e_idx] & (je < nloc)])
        # buf[j] = the value at global row row_off + nloc + j
        p = row_off + nloc + je
        src_s = _owner(p, ends, ndev)
        j2 = p - offsets[src_s]
    j2c = torch.clamp(j2, 0, E - 1)
    buf_d = K.gather(g_d.reshape((ndev * E,) + tuple(g_d.shape[2:])), src_s * E + j2c)
    buf_v = g_v[src_s, j2c] & (j2 >= 0) & (j2 < E) & ((p >= 0) if lag else (p < N))
    if lag:
        src = ar - koff
        remote = src < 0
        rbuf = torch.clamp(src + E, 0, E - 1)
        rvalid = buf_v[rbuf] & (rn0 - koff >= 0)
        lvalid = v.valid[torch.clamp(src, 0, fcap - 1)] & (src >= 0)
    else:
        src = ar + koff
        remote = src >= nloc
        rbuf = torch.clamp(src - nloc, 0, E - 1)
        rvalid = buf_v[rbuf] & (rn0 + koff < N)
        lvalid = v.valid[torch.clamp(src, 0, fcap - 1)]
    src_c = torch.clamp(src, 0, fcap - 1)
    data = K.where_bits(remote, K.gather(buf_d, rbuf), K.gather(v.data, src_c))
    return data, torch.where(remote, rvalid, lvalid)


def _global_row(v, p, ctx):
    """A generator: column ``v``'s value at global row ``p`` (0-dim) on
    every shard, and whether that row exists and is valid."""
    nloc, fcap, row_off, N, me = ctx["nloc"], ctx["fcap"], ctx["row_off"], ctx["N"], ctx["me"]
    mine = (row_off <= p) & (p < row_off + nloc)
    li = torch.clamp(p - row_off, 0, fcap - 1).reshape(1)
    val = K.where_bits(mine, K.gather(v.data, li), torch.zeros_like(K.gather(v.data, li)))
    g_d, g_m, g_v = yield from gather_columns([val, mine.reshape(1), (mine & v.valid[li].reshape(())).reshape(1)])
    src_s = torch.argmax(g_m.reshape(-1).to(torch.int8))
    return K.gather(g_d.reshape((-1,) + tuple(g_d.shape[2:])), src_s.reshape(1)), g_v.any() & (p >= 0) & (p < N)
