"""The torch port's grouping, segment and take primitives
(``datafusion_tpu_torch/ops/kernels.py``) against the JAX package's
(``datafusion_tpu/ops/kernels.py``) and numpy, on the CPU: twins of
tests/test_kernels.py for the ported primitives, plus the storage dtypes
a key or an aggregate can have.

Tolerances: integer results (group ids, counts, sums that wrap mod 2^64,
minima and maxima, positions, gathers) are exactly equal.  Float sums are
within rel 1e-12: both engines add each segment's own values, in another
order (XLA's associative scan tree vs the port's Hillis-Steele passes).
Float minima and maxima are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datafusion_tpu.ops import kernels as JK
from datafusion_tpu.types import dtypes as JT
from datafusion_tpu_torch.ops import kernels as K
from datafusion_tpu_torch.types import dtypes as T

REL = 1e-12

# the JAX package's segment reductions, compiled once per dtype and shape
# (run eagerly, their scans compile op by op, several seconds per dtype)
J_SUM, J_MIN, J_MAX = (
    jax.jit(f, static_argnums=2) for f in (JK.segment_sum, JK.segment_min, JK.segment_max)
)


@pytest.fixture(params=[0, 1, 2])
def rng(request):
    return np.random.default_rng(request.param)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sorted_gid(rng, cap, n, nseg):
    live = np.sort(rng.integers(0, nseg, n))
    # dense ids 0..k-1 for the live rows, cap-1 for the dead tail
    _, dense = np.unique(live, return_inverse=True)
    return np.concatenate([dense, np.full(cap - n, cap - 1)]).astype(np.int64)


def test_filter_compact_matches_numpy(rng):
    cap, n = 4096, 3000
    keep = rng.random(cap) > 0.6
    data = rng.integers(-(10**12), 10**12, cap)
    valid = rng.random(cap) > 0.1
    d, v, cnt = K.filter_compact((_t(data),), (_t(valid),), _t(keep), n)
    kept = keep[:n]
    cnt = int(cnt)
    assert cnt == kept.sum()
    assert np.array_equal(_np(d[0])[:cnt], data[:n][kept])
    assert np.array_equal(_np(v[0])[:cnt], valid[:n][kept])
    assert not _np(v[0])[cnt:].any()


def test_lexsort_perm_multi_key_with_nulls_matches_jax(rng):
    cap, n = 4096, 3500
    k1, k2 = rng.integers(0, 5, cap), rng.integers(0, 7, cap)
    v1, v2 = rng.random(cap) > 0.2, rng.random(cap) > 0.2
    args = ((True, False), (False, True))  # k1 DESC NULLS LAST, k2 ASC NULLS FIRST
    want = JK.lexsort_perm((jnp.asarray(k1), jnp.asarray(k2)), (jnp.asarray(v1), jnp.asarray(v2)),
                           np.int64(n), *args)
    got = K.lexsort_perm((_t(k1), _t(k2)), (_t(v1), _t(v2)), n, *args)
    assert np.array_equal(_np(got), _np(want))
    moved, perm = K.lexsort_apply((_t(k1), _t(k2)), (_t(v1), _t(v2)), (_t(np.arange(cap)),),
                                  n, *args, want_perm=True)
    assert np.array_equal(_np(moved[0]), _np(want)) and np.array_equal(_np(perm), _np(want))


def test_take_rows_and_take_match_numpy(rng):
    cap = 4096
    idx = rng.integers(0, cap, 777)
    datas = (rng.integers(-(10**9), 10**9, cap), rng.random(cap),
             rng.integers(0, 2**63, cap, dtype=np.uint64))
    valids = (rng.random(cap) > 0.5, rng.random(cap) > 0.3)
    d, v = K.take(tuple(_t(x) for x in datas), tuple(_t(x) for x in valids), _t(idx))
    assert len(d) == len(datas) and len(v) == len(valids)
    for got, src in zip(d + v, datas + valids):
        assert got.dtype == _t(src).dtype and np.array_equal(_np(got), src[idx])


def _gid_of_kind(rng, kind, cap=4096):
    """Sorted dense group ids of one shape: (gid, live rows)."""
    if kind == "dense":
        return _sorted_gid(rng, cap, 3700, 40), 3700
    if kind == "singletons":  # every live row a group of its own
        n = 3000
        return np.concatenate([np.arange(n), np.full(cap - n, cap - 1)]), n
    if kind == "one-segment":
        n = 2500
        return np.where(np.arange(cap) < n, 0, cap - 1), n
    if kind == "full-buffer":  # no dead tail
        return _sorted_gid(rng, cap, cap, 300), cap
    assert kind == "single-row"
    return np.where(np.arange(cap) < 1, 0, cap - 1), 1


@pytest.mark.parametrize("kind", ["dense", "singletons", "one-segment", "full-buffer", "single-row"])
def test_segments_match_jax_positions(rng, kind):
    """The port's binary-searched segment bounds equal the reference's
    sorted positions on every real segment; each row's start is its
    segment's first row; last - first + 1 is the segment's size."""
    gid, n = _gid_of_kind(rng, kind)
    gid = gid.astype(np.int64)
    seg = K.segments(_t(gid))
    jfirst, jlast = JK._segment_positions_impl(jnp.asarray(gid))
    nseg = int(gid[n - 1]) + 1
    first, last = _np(seg.first)[:nseg], _np(seg.last)[:nseg]
    assert np.array_equal(first, _np(jfirst)[:nseg]) and np.array_equal(last, _np(jlast)[:nseg])
    assert np.array_equal(last - first + 1, np.bincount(gid[:n], minlength=nseg))
    assert np.array_equal(_np(seg.start)[:n], first[gid[:n]])
    # entries past the real segments stay in gather range
    assert _np(seg.first).min() >= 0 and _np(seg.last).max() < len(gid)


def test_segment_sum_int_and_float_match_jax(rng):
    cap, n = 4096, 3700
    gid = _sorted_gid(rng, cap, n, 40)
    ints = rng.integers(-(10**12), 10**12, cap)
    floats = rng.random(cap) * 1e3 - 500
    seg = K.segments(_t(gid))
    si = _np(K.segment_sum(_t(ints), seg, cap))
    sf = _np(K.segment_sum(_t(floats), seg, cap))
    wi = _np(J_SUM(jnp.asarray(ints), jnp.asarray(gid), cap))
    wf = _np(J_SUM(jnp.asarray(floats), jnp.asarray(gid), cap))
    nseg = gid[n - 1] + 1
    assert np.array_equal(si[:nseg], wi[:nseg])
    assert np.allclose(sf[:nseg], wf[:nseg], rtol=REL, atol=0)
    for s in range(nseg):
        sel = gid == s
        assert si[s] == ints[sel].sum()
        assert np.isclose(sf[s], floats[sel].sum(), rtol=REL, atol=0)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "one-segment"])
def test_segment_sum_wraps_like_jax(rng, grouped):
    """+-2^62 values overflow int64 partial sums; both engines wrap mod 2^64."""
    cap, n = 4096, 4000
    gid = _sorted_gid(rng, cap, n, 5) if grouped else np.where(np.arange(cap) < n, 0, cap - 1)
    vals = rng.choice([2**62, -(2**62), 2**62 - 1, 3 * 2**61], cap).astype(np.int64)
    got = _np(K.segment_sum(_t(vals), K.segments(_t(gid)), cap))
    want = _np(J_SUM(jnp.asarray(vals), jnp.asarray(gid), cap))
    nseg = gid[n - 1] + 1
    assert np.array_equal(got[:nseg], want[:nseg])
    with np.errstate(over="ignore"):
        assert got[0] == vals[gid == 0].sum()


def test_segment_min_max_match_jax(rng):
    cap, n = 4096, 3900
    gid = _sorted_gid(rng, cap, n, 60)
    for vals in (rng.integers(-(10**15), 10**15, cap), rng.normal(size=cap)):
        for ours, theirs in ((K.segment_min, J_MIN), (K.segment_max, J_MAX)):
            got = _np(ours(_t(vals), K.segments(_t(gid)), cap))
            want = _np(theirs(jnp.asarray(vals), jnp.asarray(gid), cap))
            nseg = gid[n - 1] + 1
            assert np.array_equal(got[:nseg], want[:nseg])


def test_segment_positions_full_buffer():
    """An exactly full buffer (no dead tail): the last segment covers all
    its rows; the twin of the reference test of the same name."""
    seg = K.segments(torch.tensor([0, 0, 1, 1]))
    assert seg.first.tolist()[:2] == [0, 2] and seg.last.tolist()[:2] == [1, 3]
    assert K.segment_sum(torch.tensor([1, 2, 3, 4]), seg, 4).tolist()[:2] == [3, 7]
    assert K.segment_sum(torch.tensor([1.0, 2.0, 3.0, 4.0]), seg, 4).tolist()[:2] == [3.0, 7.0]
    assert K.segment_min(torch.tensor([4, 3, 2, 1]), seg, 4).tolist()[:2] == [3, 1]
    assert K.segment_max(torch.tensor([1, 2, 9, 4]), seg, 4).tolist()[:2] == [2, 9]
    one = K.segments(torch.zeros(8, dtype=torch.int64))
    assert int(K.segment_sum(torch.arange(8), one, 8)[0]) == 28
    seg2 = K.segments(torch.tensor([0, 0, 1, 3]))  # trailing dead row
    assert K.segment_sum(torch.tensor([1, 2, 3, 99]), seg2, 4).tolist()[:2] == [3, 3]


def test_group_ids_sorted_nan_and_signed_zero_keys_match_jax(rng):
    """NaN != NaN makes every NaN row its own group; -0.0 == 0.0 makes one."""
    cap, n = 4096, 3000
    valid = rng.random(cap) > 0.1
    # under a NULL the data is 0, as ingest stores it
    keys = np.where(valid, rng.choice([0.0, -0.0, 1.5, np.nan, -2.0], cap), 0.0)
    args = ((False,), (True,))
    perm = K.lexsort_perm((_t(keys),), (_t(valid),), n, *args)
    jperm = JK.lexsort_perm((jnp.asarray(keys),), (jnp.asarray(valid),), np.int64(n), *args)
    assert np.array_equal(_np(perm), _np(jperm))
    sk, sv = keys[_np(perm)], valid[_np(perm)]
    gid, ng = K.group_ids_sorted((_t(sk),), (_t(sv),), n)
    jgid, jng = JK.group_ids_sorted((jnp.asarray(sk),), (jnp.asarray(sv),), np.int64(n))
    assert int(ng) == int(jng) and np.array_equal(_np(gid), _np(jgid))
    live = sv[:n] & ~np.isnan(sk[:n])
    nan_rows = int((sv[:n] & np.isnan(sk[:n])).sum())
    assert int(ng) == len(np.unique(sk[:n][live])) + nan_rows + int((~sv[:n]).any())


# the storage dtypes of types/dtypes.py that a group key or an aggregate
# can have: sort, compare and cumsum must work for each
STORAGE_KINDS = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
                 "float32", "float64", "bool", "date32", "timestamp", "decimal"]


@pytest.mark.parametrize("kind", STORAGE_KINDS)
def test_grouping_primitives_per_storage_dtype_match_jax(kind):
    rng = np.random.default_rng(7)
    cap, n = 4096, 3500
    jdt = JT.decimal(15, 2) if kind == "decimal" else JT.DataType(kind)
    tdt = T.decimal(15, 2) if kind == "decimal" else T.DataType(kind)
    storage = jdt.storage_np_dtype()
    if storage == np.bool_:
        data = rng.random(cap) > 0.5
    elif storage.kind == "f":
        data = rng.choice([-2.5, 0.0, 1.0, 7.25], cap).astype(storage)
    elif storage == np.uint64:
        # values on both sides of 2^63, where the int64 key wraps
        data = rng.integers(0, 13, cap).astype(np.uint64) + np.uint64(2**63 - 6)
    else:
        data = (rng.integers(0, 13, cap) - (6 if storage.kind == "i" else 0)).astype(storage)
    valid = rng.random(cap) > 0.1
    tk = K.orderable_key(_t(data), tdt)
    jk = JK.orderable_key(jnp.asarray(data), jdt)
    assert np.array_equal(_np(tk), _np(jk))
    args = ((False,), (True,))
    perm = _np(K.lexsort_perm((tk,), (_t(valid),), n, *args))
    assert np.array_equal(perm, _np(JK.lexsort_perm((jk,), (jnp.asarray(valid),), np.int64(n), *args)))
    gid, ng = K.group_ids_sorted((tk[perm],), (_t(valid[perm]),), n)
    jgid, jng = JK.group_ids_sorted((jk[perm],), (jnp.asarray(valid[perm]),), np.int64(n))
    assert int(ng) == int(jng) and np.array_equal(_np(gid), _np(jgid))
    nseg = int(ng)
    if storage != np.bool_:
        sums = _t(data[perm]).to(torch.float64 if storage.kind == "f" else torch.int64)
        got = _np(K.segment_sum(sums, K.segments(gid), cap))[:nseg]
        want = _np(J_SUM(jnp.asarray(_np(sums)), jgid, cap))[:nseg]
        assert np.array_equal(got, want)
    for ours, theirs in ((K.segment_min, J_MIN), (K.segment_max, J_MAX)):
        got = _np(ours(tk[perm], K.segments(gid), cap))[:nseg]
        assert np.array_equal(got, _np(theirs(jk[perm], jgid, cap))[:nseg])
