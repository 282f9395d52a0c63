"""HashJoinExec / CrossJoinExec.

Port of ``datafusion_tpu/ops/join.py`` (reference: datafusion's
hash_join.rs and cross_join.rs).  No pointer-chasing hash table: the build
side is sorted by a 32-bit fold of a 64-bit key hash; each probe row finds
its run of equal hashes by binary search; the candidate pairs are expanded
(``kernels.join_expand``), verified on the key data (and on a residual
filter), and every join type derives from the verified pairs: inner keeps
them, semi and anti keep probe rows with or without one, and the outer
joins add the unmatched rows of one side or both, NULL-padded.

The exact path reads two counts on the host: the candidate total sizes the
expansion, and the verified count sizes the output.  It runs a join's
first time and after an overflow, and learns both capacities.  Inside a
speculation window (``kernels.py``) later runs size both from what it
learned, with no host read, and record an overflow flag; a join it has not
learned yet speculates at the probe's capacity when it is an inner, semi
or anti join over a small probe.  The reference's merge-rank probe, its
direct-compare path for tiny builds, its fan-out-free phase B and its JIT
caches are not carried over (checking each probe row's candidates in
place, over the probe's capacity, took more kernel time on the card than
expanding at the learned capacity: PERF.md).  A build table marked
``reused_build`` (the device side of a morsel-streamed join,
``physical/morsel.py``) keeps its hashed and sorted keys and its verify
keys, so every probe morsel after the first reuses them.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..columnar.table import Table, host_values, round_capacity
from ..errors import InternalError
from ..exprs.physical import PhysicalExpr, harmonize_strings
from ..types import Schema
from . import kernels as K
from .base import ExecutionPlan

JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti")

# below this capacity, padding costs less than the count sync a shrink needs
SHRINK_SYNC_MIN_CAP = 1 << 17

# (expansion capacity, output capacity) per join signature, learned by the
# exact path and read by speculative runs
_LEARNED: dict = {}


class HashJoinExec(ExecutionPlan):
    """Equi-join.  Probe side = left input, build side = right input.

    `on` pairs physical key exprs (left_expr, right_expr); `filter` is an
    optional residual predicate planned against the combined schema."""

    def __init__(
        self,
        left: ExecutionPlan,
        right: ExecutionPlan,
        on: list[tuple[PhysicalExpr, PhysicalExpr]],
        join_type: str = "inner",
        filter: PhysicalExpr | None = None,
    ):
        super().__init__()
        if join_type not in JOIN_TYPES:
            raise InternalError(f"bad join type {join_type}")
        self.left = left
        self.right = right
        self.on = on
        self.join_type = join_type
        self.filter = filter

    def schema(self) -> Schema:
        if self.join_type in ("semi", "anti"):
            return self.left.schema()
        return Schema(list(self.left.schema().fields) + list(self.right.schema().fields))

    def children(self):
        return [self.left, self.right]

    def with_new_children(self, c):
        return HashJoinExec(c[0], c[1], self.on, self.join_type, self.filter)

    def _execute(self) -> Table:
        lt = self.left.execute()
        rt = self.right.execute()
        # joins sort and probe at capacity: a large buffer around a small
        # live count (a selective filter) is worth one count sync, unless
        # its producer sized it from a learned capacity
        lt = lt.shrink_to_fit(only_if_above=SHRINK_SYNC_MIN_CAP)
        rt = rt.shrink_to_fit(only_if_above=SHRINK_SYNC_MIN_CAP)
        return join_tables(lt, rt, self.on, self.join_type, self.filter, self.metrics)

    def _display_line(self):
        on = ", ".join(f"{l!r}={r!r}" for l, r in self.on)
        f = f" filter={self.filter!r}" if self.filter is not None else ""
        return f"HashJoinExec[{self.join_type}]: on=[{on}]{f}"


def _join_keys(lt: Table, rt: Table, on):
    """Evaluate the key columns, string keys on one merged dictionary
    (``StringDict.merge`` memoizes, so identities stay stable)."""
    lkeys, rkeys = [], []
    for le, re_ in on:
        lc = le.evaluate(lt)
        rc = re_.evaluate(rt)
        if lc.dtype.is_string and rc.dtype.is_string:
            lc, rc = harmonize_strings(lc, rc)
        lkeys.append(lc)
        rkeys.append(rc)
    return lkeys, rkeys


def _key_hash(keys) -> torch.Tensor:
    return K.hash_fold32(K.hash_columns(
        [K.hashable_key(c.data, c.dtype) for c in keys], [c.valid for c in keys]
    ))


def _table_sig(t: Table):
    """What a join's learned capacities depend on besides its data: names,
    types, capacities, dictionaries and the int32 narrowing of each key."""
    return (
        tuple(t.names),
        tuple(
            (str(c.dtype), c.capacity, id(c.dictionary), K.vrange_narrows_i32(c.vrange))
            for c in t.columns
        ),
    )


def join_tables(lt: Table, rt: Table, on, join_type: str, filter, metrics=None) -> Table:
    """Equi-join of two tables: the exact path, or inside a speculation
    window the speculative one (module docstring)."""
    dev = lt.device
    lcap, rcap = lt.capacity, rt.capacity
    nl, nr = lt.nrows_dev, rt.nrows_dev
    key = (_table_sig(lt), _table_sig(rt), repr(on), join_type, repr(filter))
    spec = None
    if K.spec_active():
        spec = _LEARNED.get(key)
        if spec is None and join_type in ("inner", "semi", "anti") and lcap <= SHRINK_SYNC_MIN_CAP:
            # fan-out free joins (every TPC-H join's key side) fit the
            # probe's capacity; a larger probe would expand at a capacity
            # far above a selective join's pairs
            spec = (lcap, None)
    lkeys, rkeys = _join_keys(lt, rt, on)

    # ---- phase A: hash, sort the build side, probe --------------------------
    sorted_hash, build_order, rord, rval = _build_side(lt, rt, on, rkeys)
    probe_ok = torch.arange(lcap, device=dev) < nl
    for c in lkeys:
        probe_ok = probe_ok & c.valid
    lo, counts = K.join_probe_counts_binary(sorted_hash, _key_hash(lkeys), probe_ok, nr)
    stats = K.candidate_stats(counts)
    if spec is None:
        # one host read sizes the expansion
        total = host_values(stats)[0]
        if metrics is not None:
            metrics.counter("join_candidates").add(total)
        expand_cap, final_cap = total, None
        flag = None
    else:
        expand_cap, final_cap = spec
        flag = stats[0] > expand_cap

    # ---- phase B: expand, verify, materialize -------------------------------
    lord = tuple(K.orderable_key(c.data, c.dtype, c.vrange) for c in lkeys)
    lval = tuple(c.valid for c in lkeys)
    probe_idx, build_idx, pair_alive, _ = K.join_expand(lo, counts, build_order, expand_cap)
    ok = K.verify_equal(lord, lval, rord, rval, probe_idx, build_idx, pair_alive)
    if filter is not None:
        fres = filter.evaluate(_gather_pair_table(lt, rt, probe_idx, build_idx))
        ok = ok & fres.data.to(torch.bool) & fres.valid

    if join_type == "inner":
        li, ri, keep = probe_idx, build_idx, ok
    elif join_type in ("semi", "anti"):
        l_alive = torch.arange(lcap, device=dev) < nl
        li = torch.arange(lcap, device=dev)
        ri = None
        matched = _matches_per_probe(counts, ok) > 0
        keep = (matched if join_type == "semi" else ~matched) & l_alive
    else:
        # left / right / full outer: the matched pairs, then the unmatched
        # probe rows, then the unvisited build rows, NULL-padded (-1)
        li_parts, ri_parts, keep_parts = [probe_idx], [build_idx], [ok]
        if join_type in ("left", "full"):
            l_alive = torch.arange(lcap, device=dev) < nl
            li_parts.append(torch.arange(lcap, device=dev))
            ri_parts.append(torch.full((lcap,), -1, dtype=torch.int64, device=dev))
            keep_parts.append(l_alive & ~(_matches_per_probe(counts, ok) > 0))
        if join_type in ("right", "full"):
            visited = torch.zeros(rcap, dtype=torch.int32, device=dev)
            visited.index_add_(0, build_idx, ok.to(torch.int32))
            r_alive = torch.arange(rcap, device=dev) < nr
            li_parts.append(torch.full((rcap,), -1, dtype=torch.int64, device=dev))
            ri_parts.append(torch.arange(rcap, device=dev))
            keep_parts.append(r_alive & (visited == 0))
        li, ri, keep = torch.cat(li_parts), torch.cat(ri_parts), torch.cat(keep_parts)
    if keep.shape[0] == 0:
        # no candidates and no outer rows: one dead slot to gather from
        li = li.new_full((1,), -1)
        ri = None if ri is None else ri.new_full((1,), -1)
        keep = keep.new_zeros(1)

    if spec is None:
        # one host read sizes the output; learn both capacities
        cnt = host_values(keep.sum())
        out_cap = round_capacity(max(cnt, 1))
        if len(_LEARNED) > 4096:
            _LEARNED.clear()
        _LEARNED[key] = (round_capacity(max(total, 1)), out_cap)
    else:
        cnt = keep.sum()
        if final_cap is None:
            out_cap = round_capacity(keep.shape[0])
        else:
            # flag from the count before the clamp: the clamped count can
            # never exceed the capacity
            flag = flag | (cnt > final_cap)
            out_cap = final_cap
            cnt = torch.clamp(cnt, max=final_cap)
        K.spec_record(flag)
    sel = K.keep_index(keep, out_cap)
    live = torch.arange(out_cap, device=dev) < cnt
    # join outputs are row subsets of their inputs: value ranges carry over
    cols = K.take_columns(lt.columns, li, live, sel, vranges=True)
    names = list(lt.names)
    if ri is not None:
        cols += K.take_columns(rt.columns, ri, live, sel, vranges=True)
        names += list(rt.names)
    out = Table(names, cols, cnt, device=dev)
    # right-sized from a count or a learned capacity: a shrink learns nothing
    out._cap_learned = spec is None or final_cap is not None
    return out


def _build_side(lt: Table, rt: Table, on, rkeys):
    """(sorted hash, build order, verify keys, their valid masks) of the
    build side.  A build table marked ``reused_build`` keeps them, keyed on
    the join keys and the probe's dictionaries (string keys are remapped
    onto a dictionary merged with the probe's)."""
    reused = getattr(rt, "reused_build", False)
    key = (repr(on), tuple(id(c.dictionary) for c in lt.columns))
    memo = getattr(rt, "_join_prep", None) if reused else None
    if memo is not None and memo[0] == key:
        return memo[1]
    sorted_hash, build_order = K.join_build_sort(_key_hash(rkeys), rt.nrows_dev)
    prep = (
        sorted_hash,
        build_order,
        tuple(K.orderable_key(c.data, c.dtype, c.vrange) for c in rkeys),
        tuple(c.valid for c in rkeys),
    )
    if reused:
        rt._join_prep = (key, prep)
    return prep


def _matches_per_probe(counts: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Per probe row, how many of its candidate pairs verified, from prefix
    sums over the pairs (each probe row's pairs are contiguous).  Pairs
    past the expansion (an overflow, flagged) count as unverified."""
    n = ok.shape[0]
    cum = torch.cumsum(counts, 0)
    mc = torch.cat([ok.new_zeros(1, dtype=torch.int64), torch.cumsum(ok, 0)])
    return mc[torch.clamp(cum, max=n)] - mc[torch.clamp(cum - counts, max=n)]


def _gather_pair_table(lt: Table, rt: Table, probe_idx, build_idx) -> Table:
    """Both sides' columns at the candidate pairs, for a residual filter."""
    cols = K.take_columns(lt.columns, probe_idx) + K.take_columns(rt.columns, build_idx)
    return Table(list(lt.names) + list(rt.names), cols, probe_idx.shape[0], device=lt.device)


class CrossJoinExec(ExecutionPlan):
    """Cartesian product (cross_join.rs:52): index arithmetic."""

    def __init__(self, left: ExecutionPlan, right: ExecutionPlan):
        super().__init__()
        self.left = left
        self.right = right

    def schema(self) -> Schema:
        return Schema(list(self.left.schema().fields) + list(self.right.schema().fields))

    def children(self):
        return [self.left, self.right]

    def with_new_children(self, c):
        return CrossJoinExec(c[0], c[1])

    def _execute(self) -> Table:
        return cross_join_tables(self.left.execute(), self.right.execute())

    def _display_line(self):
        return "CrossJoinExec"


def cross_join_tables(lt: Table, rt: Table) -> Table:
    dev = lt.device
    # a side of one row known on the host (a scalar subquery's aggregate):
    # broadcast that row across the other side's buffers, no host sync
    for flip in (False, True):
        a, b = (lt, rt) if not flip else (rt, lt)
        if isinstance(b.nrows_dev, int) and b.nrows_dev == 1:
            alive = torch.arange(a.capacity, device=dev) < a.nrows_dev
            acols = [
                Column(c.dtype, c.data, c.valid & alive, c.dictionary, vrange=c.vrange)
                for c in a.columns
            ]
            bcols = [
                Column(
                    c.dtype,
                    c.data[:1].expand(a.capacity),
                    c.valid[:1].expand(a.capacity) & alive,
                    c.dictionary,
                )
                for c in b.columns
            ]
            l_out, r_out = (acols, bcols) if not flip else (bcols, acols)
            out = Table(list(lt.names) + list(rt.names), l_out + r_out, a.nrows_dev, device=dev)
            # a's buffers and row count: sized as a was (a consumer that
            # right-sizes its input reads no count for a learned one)
            out._cap_learned = a._cap_learned
            return out
    total = lt.nrows * rt.nrows
    out_cap = round_capacity(max(total, 1))
    r = torch.arange(out_cap, device=dev)
    nr = max(rt.nrows, 1)
    li = torch.clamp(r // nr, max=max(lt.capacity - 1, 0))
    ri = torch.clamp(r % nr, max=max(rt.capacity - 1, 0))
    alive = r < total
    cols = K.take_columns(lt.columns, li, alive) + K.take_columns(rt.columns, ri, alive)
    return Table(list(lt.names) + list(rt.names), cols, total, device=dev)
