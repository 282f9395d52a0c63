"""Core columnar primitives on torch tensors: sorting, gathering, grouping
and segment reductions.

Port of ``datafusion_tpu/ops/kernels.py``.  The reference carries payload
columns through one variadic XLA sort, packs gathers into int32 words and
batches the boundary reads of many reductions into one packed gather,
because gathers are slow on a TPU.  On a GPU a gather is cheap, so here a
sort computes one permutation (successive stable ``torch.sort`` passes
from the least significant key up) and the columns move by it in one
``take`` (``ops/take.py``, kernel K2 on the card).

Segment reductions assume SORTED dense group ids (0..ngroups-1 for live
rows, cap-1 for the trailing dead rows), the invariant every grouping
path produces.  Integer sums are one global cumsum read at the segment
ends, exact mod 2^64 like the reference; float sums, minima and maxima are
a segmented scan that restarts at each boundary, so each segment adds
only its own values, in the reference's associative-scan order (the same
bits as the reference, and from run to run).  The segment bounds come from binary searches
over the sorted ids, once per grouping (``segments``), with no host sync.

The join primitives hash the key columns (the reference's 64-bit mix,
computed in int64 with logical right shifts, bit for bit), sort the build
side by its folded hash once, find each probe row's run of equal hashes
by binary search, expand the candidate pairs into a given capacity and
verify them on the key data.  The speculation window (``spec_window``)
lets joins and stages size their outputs from learned capacities with
device-side overflow flags instead of host reads.
"""

from __future__ import annotations

import os
import threading
from typing import NamedTuple

import torch

from ..columnar.column import Column
from ..types.dtypes import DataType
from .take import take  # every caller moves rows through K.take

# ---------------------------------------------------------------------------
# key encoding
# ---------------------------------------------------------------------------


def vrange_narrows_i32(vrange) -> bool:
    """True when an ingest-recorded value range proves a 64-bit column's
    live values fit int32, so its sort key can run at 32-bit width."""
    return (
        vrange is not None
        and -(1 << 31) <= vrange[0]
        and vrange[1] < (1 << 31)
    )


def orderable_key(data: torch.Tensor, dtype: DataType, vrange=None) -> torch.Tensor:
    """Map a column's storage buffer to keys whose ascending order equals the
    column's SQL ordering (strings are order-isomorphic codes since
    dictionaries are sorted; floats sort as themselves).  Keys stay at
    32-bit width whenever order allows."""
    st = data.dtype
    if dtype.is_float:
        return data if st in (torch.float32, torch.float64) else data.to(torch.float64)
    if st == torch.int32:
        return data
    if st == torch.bool or st in (torch.int8, torch.int16, torch.uint8, torch.uint16):
        return data.to(torch.int32)
    if vrange_narrows_i32(vrange):
        return data.to(torch.int32)
    return data.to(torch.int64)


# ---------------------------------------------------------------------------
# unsigned storage
#
# torch (2.11, CUDA) has no gather, select, roll, compare, sort or
# arithmetic kernels for uint16/32/64.  Work that moves bits unchanged runs
# on the signed view of the same width; ordering and arithmetic convert
# first (``exprs/physical.py``).
# ---------------------------------------------------------------------------

_SIGNED_TWIN = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def signed_view(x: torch.Tensor) -> torch.Tensor:
    """x itself, or the same bits as the signed type of x's width for the
    unsigned types torch's CUDA kernels leave out."""
    s = _SIGNED_TWIN.get(x.dtype)
    return x if s is None else x.view(s)


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for every storage dtype."""
    return signed_view(x)[idx].view(x.dtype)


def where_bits(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where(mask, a, b) for two tensors of one storage dtype."""
    return torch.where(mask, signed_view(a), signed_view(b)).view(a.dtype)


# the signed type of each storage dtype torch's CUDA unique leaves out,
# and of each float: a unique over bits tells -0.0 from 0.0
_UNIQUE_BITS = {**_SIGNED_TWIN, torch.bool: torch.int8, torch.float16: torch.int16,
                torch.bfloat16: torch.int16, torch.float32: torch.int32, torch.float64: torch.int64}


def unique_bits(x: torch.Tensor):
    """(the distinct bit patterns of x as x's dtype, each row's index into
    them), both on x's device."""
    b = _UNIQUE_BITS.get(x.dtype)
    uniq, inv = torch.unique(x if b is None else x.view(b), return_inverse=True)
    return (uniq if b is None else uniq.view(x.dtype)), inv


# ---------------------------------------------------------------------------
# sorting & gathering
# ---------------------------------------------------------------------------


def sort_key(k: torch.Tensor) -> torch.Tensor:
    """A key that torch sorts as the reference's XLA sort does: bools as
    int8 (torch sorts no bools); floats with -0.0 as 0.0 and every NaN as
    the positive NaN.  XLA standardizes both before it compares; the
    card's radix sort would otherwise order them by their sign bits."""
    if k.dtype == torch.bool:
        return k.to(torch.int8)
    if k.is_floating_point():
        return torch.where(torch.isnan(k), float("nan"), k + 0.0)
    return k


def sort_perm(keys: tuple) -> torch.Tensor:
    """Stable lexicographic permutation: keys[0] is the most significant.
    One stable sort per key, least significant first."""
    cap = keys[0].shape[0]
    perm = torch.arange(cap, device=keys[0].device)
    for k in reversed([sort_key(k) for k in keys]):
        order = torch.sort(k[perm], stable=True).indices
        perm = perm[order]
    return perm


def take_columns(cols, idx: torch.Tensor, mask=None, sel=None, valids=None,
                 vranges: bool = False) -> list:
    """The columns ``cols`` at the rows ``idx`` (``idx[sel]`` with
    ``sel``), in one ``take``, each mask ANDed with ``mask`` (an index of
    -1 gives NULL).  ``valids`` stands in for the columns' own masks;
    ``vranges`` keeps their value ranges (the rows are a subset)."""
    cols = tuple(cols)
    datas, outv = take(tuple(c.data for c in cols),
                       tuple(c.valid for c in cols) if valids is None else tuple(valids),
                       idx, mask, sel)
    return [Column(c.dtype, d, v, c.dictionary, vrange=c.vrange if vranges else None)
            for c, d, v in zip(cols, datas, outv)]


def compact(datas: tuple, valids: tuple, keep: torch.Tensor, live: torch.Tensor):
    """The rows where ``keep`` holds at the front of fresh buffers, in
    order (a stable sort keyed on ``~keep``), each mask ANDed with
    ``live``, the first rows as many as ``keep`` holds."""
    return take(datas, valids, sort_perm((~keep,)), mask=live)


def filter_compact(datas: tuple, valids: tuple, keep: torch.Tensor, nrows):
    """Move rows where ``keep`` holds to the front of fresh buffers.

    Returns (datas, valids, count).  Dead rows (index >= nrows) are never
    kept; the count stays on the device."""
    ar = torch.arange(keep.shape[0], device=keep.device)
    keep = keep & (ar < nrows)
    cnt = keep.sum()
    out_d, out_v = compact(datas, valids, keep, ar < cnt)
    return out_d, out_v, cnt


def lexsort_apply(
    ordkeys: tuple,
    key_valids: tuple,
    payloads: tuple,
    nrows,
    descs: tuple,
    nulls_firsts: tuple,
    want_perm: bool = False,
    dead_mask: torch.Tensor | None = None,
):
    """Sort rows by (k1, k2, ...) with per-key direction and null placement,
    dead rows last, stable.  Returns (sorted_payloads, perm-or-None).

    The key sequence is [dead-last, nullrank_1, key_1, nullrank_2, key_2,
    ...], as in the reference."""
    cap = ordkeys[0].shape[0]
    dev = ordkeys[0].device
    keys = [
        torch.arange(cap, device=dev) >= nrows if dead_mask is None else dead_mask
    ]
    for k, v, desc, nf in zip(ordkeys, key_valids, descs, nulls_firsts):
        kk = k
        if desc:
            kk = -kk if kk.is_floating_point() else torch.bitwise_not(kk)
        rank = torch.where(
            v,
            torch.ones((), dtype=torch.int32, device=dev),
            torch.full((), 0 if nf else 2, dtype=torch.int32, device=dev),
        )
        keys.append(rank)
        keys.append(kk)
    perm = sort_perm(tuple(keys))
    moved, _ = take(payloads, (), perm)
    return moved, (perm if want_perm else None)


def lexsort_perm(
    ordkeys: tuple,
    key_valids: tuple,
    nrows,
    descs: tuple,
    nulls_firsts: tuple,
    dead_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Permutation form of `lexsort_apply`, for callers that gather other
    buffers by the sorted order."""
    _, perm = lexsort_apply(
        ordkeys, key_valids, (), nrows, descs, nulls_firsts,
        want_perm=True, dead_mask=dead_mask,
    )
    return perm


# ---------------------------------------------------------------------------
# grouping
# ---------------------------------------------------------------------------


def _boundary_accum(boundary: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    return boundary | (k != torch.roll(k, 1)) | (v != torch.roll(v, 1))


def _gid_from_boundary(boundary: torch.Tensor, nrows):
    """(gid, ngroups) without waiting for the device and without a copy
    from the host (a host count selects its row by a view)."""
    cap = boundary.shape[0]
    alive = torch.arange(cap, device=boundary.device) < nrows
    boundary = boundary.clone()
    boundary[:1].fill_(True)  # a fill: assigning a host scalar copies it to the card and waits
    gid = torch.cumsum(boundary & alive, 0) - 1
    if isinstance(nrows, int):
        ngroups = gid[nrows - 1] + 1 if nrows > 0 else gid.new_zeros(())
    else:
        last = torch.clamp(nrows - 1, min=0).to(torch.int64).reshape(1)
        ngroups = torch.where(nrows > 0, gid.gather(0, last)[0] + 1, 0)
    gid = torch.where(alive, gid, cap - 1)
    return gid, ngroups


def group_ids_sorted(sorted_keys: tuple, sorted_valids: tuple, nrows):
    """Given key columns already sorted by `lexsort_perm`, return
    (gid per row, ngroups).  A group boundary is any change in (key, valid)
    on any key column (so every NaN key row is a group of its own).  Dead
    rows get gid == cap-1 and are excluded by callers via ngroups."""
    cap = sorted_keys[0].shape[0]
    boundary = torch.zeros(cap, dtype=torch.bool, device=sorted_keys[0].device)
    for k, v in zip(sorted_keys, sorted_valids):
        boundary = _boundary_accum(boundary, k, v)
    return _gid_from_boundary(boundary, nrows)


class Segments(NamedTuple):
    """The segments of sorted dense group ids, found once per grouping and
    read by every reduction over it.  ``first`` and ``last`` hold the first
    and last row of each segment ordinal in [0, cap); only ordinals below
    the segment count are meaningful (callers mask by ngroups).  ``start``
    holds each row's segment's first row."""

    gid: torch.Tensor
    first: torch.Tensor
    last: torch.Tensor
    start: torch.Tensor


def segments(gid: torch.Tensor) -> Segments:
    """Segment bounds of sorted group ids by binary search (no scatter, no
    host sync)."""
    cap = gid.shape[0]
    ords = torch.arange(cap, dtype=gid.dtype, device=gid.device)
    first = torch.searchsorted(gid, ords).clamp_(max=cap - 1)
    last = (torch.searchsorted(gid, ords, right=True) - 1).clamp_(min=0)
    return Segments(gid, first, last, first[gid])


def assoc_scan(combine, elems: tuple) -> tuple:
    """Inclusive scan of the tuple of equal-length tensors ``elems`` under
    the associative ``combine(a_tuple, b_tuple)``, in the order of the
    reference's ``jax.lax.associative_scan``: adjacent pairs are combined,
    the halves scanned recursively and the even positions filled in.  A
    float scan therefore adds in the reference's order and gives its bits."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = assoc_scan(combine, combine(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems)))
    rest = tuple(e[2::2] for e in elems)
    even = combine(tuple(e[:-1] for e in odd) if n % 2 == 0 else odd, rest)
    out = []
    for e, ev, od in zip(elems, even, odd):
        x = torch.empty_like(e)
        x[0:1] = e[0:1]
        x[2::2] = ev
        x[1::2] = od
        out.append(x)
    return tuple(out)


def _segment_scan(values: torch.Tensor, gid: torch.Tensor, combine) -> torch.Tensor:
    """Running reduction within each run of equal sorted ``gid`` (restarts
    at the boundaries): the reference's ``_segment_scan``, an associative
    scan over (gid, value) pairs, with its order of operations."""

    def comb(a, b):
        return b[0], torch.where(a[0] == b[0], combine(a[1], b[1]), b[1])

    return assoc_scan(comb, (gid, values))[1]


def xla_minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum as XLA computes it: NaN propagates, and -0.0 is
    below 0.0 (torch returns either zero)."""
    m = torch.minimum(a, b)
    if not m.is_floating_point():
        return m
    neg = torch.signbit(a) | torch.signbit(b)
    return torch.where(m == 0, torch.where(neg, -0.0, 0.0).to(m.dtype), m)


def xla_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise maximum as XLA computes it (0.0 above -0.0)."""
    m = torch.maximum(a, b)
    if not m.is_floating_point():
        return m
    pos = ((a == 0) & ~torch.signbit(a)) | ((b == 0) & ~torch.signbit(b))
    return torch.where(m == 0, torch.where(pos, 0.0, -0.0).to(m.dtype), m)


def _wrap_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 wrapping arithmetic result -> ``dtype`` (uint64 by bitcast)."""
    return x.view(dtype) if dtype == torch.uint64 else x.to(dtype)


def segment_sum(values: torch.Tensor, seg: Segments, num_segments: int):
    if values.is_floating_point():
        out = _segment_scan(values, seg.gid, torch.add)[seg.last]
    else:
        # exact for ints, mod 2^64: one global cumsum, read after each
        # segment's last row minus before its first
        dt = values.dtype
        v = values.view(torch.int64) if dt == torch.uint64 else values.to(torch.int64)
        run = torch.cat([v.new_zeros(1), torch.cumsum(v, 0)])
        out = _wrap_to(run[seg.last + 1] - run[seg.first], dt)
    return out[:num_segments]


def segment_min(values: torch.Tensor, seg: Segments, num_segments: int):
    return _segment_scan(values, seg.gid, torch.minimum)[seg.last][:num_segments]


def segment_max(values: torch.Tensor, seg: Segments, num_segments: int):
    return _segment_scan(values, seg.gid, torch.maximum)[seg.last][:num_segments]


# ---------------------------------------------------------------------------
# hashing (the reference's splitmix64-style avalanche)
#
# The reference mixes in uint64.  torch has no uint64 shifts on the CPU and
# no uint64 arithmetic on the card, so the same bits are computed in int64:
# additions and multiplications wrap alike, a logical right shift is an
# arithmetic one with the sign bits masked off, and the constants are
# written as their signed values.
# ---------------------------------------------------------------------------

_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def hashable_key(data: torch.Tensor, dtype: DataType) -> torch.Tensor:
    """int64 key for hashing.  Floats go through their float32 bits, as in
    the reference: equal floats hash alike except -0.0 and 0.0, so those
    two never meet in a join, and NaN meets nothing (verification)."""
    if dtype.is_float:
        return data.to(torch.float32).view(torch.int32).to(torch.int64)
    if data.dtype == torch.uint64:
        return data.view(torch.int64)
    return data.to(torch.int64)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ _srl(x, 30)) * _MIX1
    x = (x ^ _srl(x, 27)) * _MIX2
    return x ^ _srl(x, 31)


def hash_columns(keys: list, valids: list) -> torch.Tensor:
    """One 64-bit hash per row (as int64 bits) over N int64 key columns.
    A NULL key hashes as a constant; exactness comes from verification."""
    h = torch.full(keys[0].shape, _GOLDEN, dtype=torch.int64, device=keys[0].device)
    for k, v in zip(keys, valids):
        kk = torch.where(v, k, _GOLDEN)
        h = _mix64(h ^ (kk + _GOLDEN + h * 64 + _srl(h, 2)))
    return h


def hash_fold32(h: torch.Tensor) -> torch.Tensor:
    """The reference's 32-bit fold, ``uint32(h ^ (h >> 32))``, moved into
    int32 by subtracting 2^31, so that it sorts as the uint32 sorts."""
    return (((h ^ _srl(h, 32)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


# ---------------------------------------------------------------------------
# join candidates (sorted-hash probe)
# ---------------------------------------------------------------------------

# the folded hash that dead build rows are pinned to (uint32 max, shifted)
HASH_PIN = (1 << 31) - 1


def join_build_sort(build_hash: torch.Tensor, nrows_build):
    """Sort the build side by hash, dead rows pinned to the largest hash so
    they sit at the end.  Returns (sorted_hash, build row order)."""
    cap = build_hash.shape[0]
    alive = torch.arange(cap, device=build_hash.device) < nrows_build
    h = torch.where(alive, build_hash, HASH_PIN)
    sorted_hash, order = torch.sort(h, stable=True)
    return sorted_hash, order


def join_probe_counts_binary(sorted_hash, probe_hash, probe_alive_valid, nrows_build):
    """Per probe row, the first position ``lo`` of its hash in the sorted
    build hashes and its candidate count, the length of that equal-hash run
    (clipped to the live build rows); dead and NULL-key probe rows get none.

    The reference reads the run's length from run lengths of the build side
    (``build_run_lengths``: cummax and cummin scans); on the card torch's
    cummax and cummin took 7.7 ms each over 8M rows, so here the run's end
    is a second binary search, with the same result."""
    lo = torch.searchsorted(sorted_hash, probe_hash)
    hi = torch.searchsorted(sorted_hash, probe_hash, right=True)
    hi = torch.clamp(hi, max=nrows_build) if isinstance(nrows_build, int) else torch.minimum(hi, nrows_build)
    lo = torch.minimum(lo, hi)
    counts = torch.where(probe_alive_valid, hi - lo, 0)
    lo = torch.where(probe_alive_valid, lo, 0)
    return lo, counts


def candidate_stats(counts: torch.Tensor) -> torch.Tensor:
    """[total, max] of the per-probe candidate counts, in int64."""
    if counts.numel() == 0:
        return counts.new_zeros(2, dtype=torch.int64)
    return torch.stack([counts.sum(dtype=torch.int64), counts.max().to(torch.int64)])


def join_expand(lo, counts, build_order, out_cap: int):
    """The candidate pairs in ``out_cap`` slots: probe rows in order, each
    with its run of build rows in sorted-hash order (the reference's run
    expansion).  Slot r's probe row is the number of cumulative counts at
    or below r (a binary search, no host read); slots at or past the
    total are dead.  Returns (probe_idx, build_idx, alive, total), total a
    0-dim int64 tensor that the caller compares with ``out_cap``.

    torch's ``repeat_interleave(..., output_size=)`` cannot stand in here:
    its CUDA kernel asserts on the device that the size equals the sum of
    the repeats, and that assert ends the process instead of flagging."""
    dev = counts.device
    cum = torch.cumsum(counts, 0)
    total = cum[-1] if cum.numel() else cum.new_zeros(())
    r = torch.arange(out_cap, device=dev)
    probe_idx = torch.searchsorted(cum, r, right=True).clamp_(max=max(counts.shape[0] - 1, 0))
    offset = r - (cum - counts)[probe_idx]
    build_pos = torch.clamp(lo[probe_idx] + offset, 0, build_order.shape[0] - 1)
    return probe_idx, build_order[build_pos], r < total, total.to(torch.int64)


def verify_equal(probe_keys, probe_valids, build_keys, build_valids, probe_idx, build_idx,
                 alive=None):
    """Exact key equality on candidate pairs: both sides non-null and
    equal on every key column (and the pair ``alive``)."""
    ok = (torch.ones(probe_idx.shape[0], dtype=torch.bool, device=probe_idx.device)
          if alive is None else alive)
    pk, pv = take(probe_keys, probe_valids, probe_idx)
    bk, bv = take(build_keys, build_valids, build_idx)
    for a, va, b, vb in zip(pk, pv, bk, bv):
        ok = ok & va & vb & (a == b)
    return ok


# ---------------------------------------------------------------------------
# speculative sizing
#
# A join's exact path reads two counts on the host (the candidate total
# sizes the expansion, the verified count the output), and a stage's
# shrink reads its output count.  Inside a speculation window they instead
# size their buffers from capacities an earlier exact run learned (or, for
# small fan-out-free joins, from the probe capacity) and record a
# device-side overflow flag.  The window's owner (``ExecutionContext.
# collect``) reads the sum of the flags once per query and reruns exactly
# when one is set.
# ---------------------------------------------------------------------------


class _Speculation(threading.local):
    """Per-thread speculation state (each thread's window and flags are its
    own).  ``DATAFUSION_TPU_NO_SPECULATIVE_JOINS`` set in the environment
    turns speculation off for threads that start afterwards."""

    def __init__(self):
        self.enabled = not os.environ.get("DATAFUSION_TPU_NO_SPECULATIVE_JOINS")
        self.window_depth = 0
        self.exact = False
        self.flags: list = []


SPECULATION = _Speculation()


def spec_active() -> bool:
    s = SPECULATION
    return s.enabled and s.window_depth > 0 and not s.exact


def spec_record(flag: torch.Tensor) -> None:
    """Record a 0-dim overflow flag (non-zero: overflowed)."""
    SPECULATION.flags.append(flag)


class _SpecWindow:
    def __enter__(self):
        SPECULATION.window_depth += 1
        if SPECULATION.window_depth == 1:
            SPECULATION.flags = []
        return self

    def __exit__(self, *exc):
        SPECULATION.window_depth -= 1
        return False

    def overflowed(self) -> bool:
        """One host read of the sum of the recorded flags; true: rerun
        exactly.  No flag recorded: no read."""
        from ..columnar.table import host_values

        flags, SPECULATION.flags = SPECULATION.flags, []
        if not flags:
            return False
        total = flags[0].to(torch.int32)
        for f in flags[1:]:
            total = total + f.to(torch.int32)
        return host_values(total) > 0


def spec_window() -> _SpecWindow:
    return _SpecWindow()


class _SpecExact:
    def __enter__(self):
        self._old = SPECULATION.exact
        SPECULATION.exact = True
        SPECULATION.flags = []
        return self

    def __exit__(self, *exc):
        SPECULATION.exact = self._old
        return False


def spec_exact() -> _SpecExact:
    return _SpecExact()


def fit_learned(t, learned: dict, key, ratchet: bool = False):
    """``t`` right-sized without a host read once its capacity is learned.
    Outside a speculation window, or on the first run, one count sync
    sizes the buffers to ``round_capacity`` and teaches ``learned[key]``;
    inside one, later runs truncate to the learned capacity and record an
    overflow flag (a count the host holds needs neither).  ``ratchet``: the
    learned capacity only grows (the morsels of one scan share a key, and
    the last, short one must not shrink it below the others)."""
    from ..columnar.table import Table, round_capacity

    n = t.nrows_dev
    cap = learned.get(key)
    if cap is not None and spec_active() and not isinstance(n, int):
        if cap < t.capacity:
            spec_record(n > cap)
            t = Table(t.names, [c.with_capacity(cap) for c in t.columns],
                      torch.clamp(n, max=cap), device=t.device)
        t._cap_learned = True
        return t
    tgt = round_capacity(t.nrows)  # one count sync
    if ratchet:
        tgt = max(tgt, learned.get(key, 0))
    if len(learned) > 64:
        learned.clear()
    learned[key] = tgt
    return t.with_capacity(tgt) if tgt < t.capacity else t


def learned_count(n, learned: dict, key, fit=None) -> int:
    """A host bound for the device count ``n``: outside a speculation
    window, or on the first run, ``n`` read on the host (and ``fit(n)``
    learned, ``n`` itself without ``fit``); inside one, the learned bound,
    with an overflow flag when ``n`` exceeds it."""
    cap = learned.get(key)
    if cap is not None and spec_active() and not isinstance(n, int):
        spec_record(n > cap)
        return cap
    if not isinstance(n, int):
        from ..columnar.table import host_values

        n = host_values(n)
    if len(learned) > 64:
        learned.clear()
    learned[key] = fit(n) if fit is not None else n
    return learned[key]


def keep_index(keep: torch.Tensor, out_cap: int) -> torch.Tensor:
    """The positions where ``keep`` holds, in order, in a vector of
    ``out_cap``; the slots past their count hold 0, and positions past
    ``out_cap`` (a speculative capacity that overflowed, which its caller
    flags) are dropped.  A stable partition without a sort or a host
    sync."""
    dev = keep.device
    pos = torch.cumsum(keep, 0) - 1
    dst = torch.where(keep & (pos < out_cap), pos, out_cap)
    idx = torch.zeros(out_cap + 1, dtype=torch.int64, device=dev)
    idx.scatter_(0, dst, torch.arange(keep.shape[0], device=dev))
    return idx[:out_cap]
