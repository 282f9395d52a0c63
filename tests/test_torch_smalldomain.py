"""Kernel K1 of the torch port (datafusion_tpu_torch/ops/smalldomain.py):
its plain PyTorch version, which the CPU runs, against the JAX package's
Pallas kernel in interpreter mode (as tests/test_pallas.py runs it) and
against a numpy oracle; and the plan that hands the CUDA kernel distinct
work only (``plan_items``), run through the plain version and written back
through its item map as the kernel writes it.  Integer sums and counts:
exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from datafusion_tpu.ops.pallas_kernels import TILE_SUBLANES
from datafusion_tpu.ops.pallas_kernels import smalldomain_sum_count as jax_k1
from datafusion_tpu_torch.ops import smalldomain as SD

TILE = TILE_SUBLANES * 128


def _inputs(seed, n, domain, k, lo=-(10**14), hi=10**14):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, domain + 1, n).astype(np.int32)  # == domain: dead
    cols = [rng.integers(lo, hi, n, dtype=np.int64) for _ in range(k)]
    masks = [rng.random(n) > 0.2 for _ in range(k)]
    return gid, cols, masks


def _port(gid, cols, masks, domain):
    s, c = SD.smalldomain_sum_count(
        torch.from_numpy(gid),
        [None if x is None else torch.from_numpy(x) for x in cols],
        [None if m is None else torch.from_numpy(m) for m in masks],
        domain,
    )
    return s.numpy(), c.numpy()


def _through_plan(gid, cols, masks, domain):
    """What the CUDA kernel computes: the plain version over the plan's
    distinct sum and count columns, written back through the item map."""
    tg = torch.from_numpy(gid)
    tc = [None if x is None else torch.from_numpy(x) for x in cols]
    tm = [None if m is None else torch.from_numpy(m) for m in masks]
    plan = SD.plan_items(tc, tm)
    s, _ = SD.smalldomain_sum_count_plain(
        tg, [c for c, _ in plan.sum_cols], [m for _, m in plan.sum_cols], domain
    )
    _, c = SD.smalldomain_sum_count_plain(
        tg, [None] * len(plan.count_masks), plan.count_masks, domain
    )
    sums = np.zeros((domain, len(cols)), np.int64)
    counts = np.zeros((domain, len(cols)), np.int64)
    for j, (si, ci) in enumerate(zip(plan.item_sum, plan.item_cnt)):
        if si >= 0:
            sums[:, j] = s[:, si].numpy()
        counts[:, j] = c[:, ci].numpy()
    return plan, sums, counts


def _oracle(gid, cols, masks, domain):
    n = len(gid)
    sums = np.zeros((domain, len(cols)), np.int64)
    counts = np.zeros((domain, len(cols)), np.int64)
    live = (gid >= 0) & (gid < domain)
    for j, (c, m) in enumerate(zip(cols, masks)):
        sel = live & (np.ones(n, bool) if m is None else m)
        if c is not None:
            np.add.at(sums[:, j], gid[sel], c[sel])  # int64 wraps like the kernel
        np.add.at(counts[:, j], gid[sel], 1)
    return sums, counts


@pytest.mark.parametrize("ntiles,domain,k", [(1, 3, 1), (2, 5, 2), (1, 2, 3)])
def test_plain_equals_pallas_interpret(ntiles, domain, k):
    gid, cols, masks = _inputs(ntiles * 100 + domain * 10 + k, TILE * ntiles, domain, k)
    js, jc = jax_k1(
        jnp.asarray(gid),
        tuple(jnp.asarray(c) for c in cols),
        tuple(jnp.asarray(m) for m in masks),
        domain,
        interpret=True,
    )
    ps, pc = _port(gid, cols, masks, domain)
    np.testing.assert_array_equal(ps, np.asarray(js))
    np.testing.assert_array_equal(pc, np.asarray(jc))
    _, qs, qc = _through_plan(gid, cols, masks, domain)
    np.testing.assert_array_equal(qs, np.asarray(js))
    np.testing.assert_array_equal(qc, np.asarray(jc))


def test_all_dead_rows_equal_pallas_interpret():
    n = TILE
    gid = np.full(n, 9, np.int32)  # everything outside the domain
    cols, masks = [np.ones(n, np.int64)], [np.ones(n, bool)]
    js, jc = jax_k1(
        jnp.asarray(gid), (jnp.asarray(cols[0]),), (jnp.asarray(masks[0]),), 4,
        interpret=True,
    )
    ps, pc = _port(gid, cols, masks, 4)
    np.testing.assert_array_equal(ps, np.asarray(js))
    np.testing.assert_array_equal(pc, np.asarray(jc))
    assert ps.sum() == 0 and pc.sum() == 0


@pytest.mark.parametrize(
    "n,domain,lo,hi",
    [
        (50_000, 256, -(10**14), 10**14),  # the full domain, k = 8
        (40_000, 5, (1 << 62) - 1000, 1 << 62),  # int64 sums wrap
        (40_000, 5, -(1 << 62), -(1 << 62) + 1000),  # negative wrap
        (1_001, 7, -1000, 1000),  # N not a multiple of any tile
    ],
)
def test_plain_equals_numpy_oracle(n, domain, lo, hi):
    gid, cols, masks = _inputs(n + domain, n, domain, 8, lo, hi)
    gid[::97] = -3  # negative ids are dead too
    cols[2] = None  # count(x): a count-only item
    cols[7], masks[7] = None, None  # count(*)
    masks[5] = None  # a column without NULLs
    ps, pc = _port(gid, cols, masks, domain)
    os_, oc = _oracle(gid, cols, masks, domain)
    np.testing.assert_array_equal(ps, os_)
    np.testing.assert_array_equal(pc, oc)
    _, qs, qc = _through_plan(gid, cols, masks, domain)
    np.testing.assert_array_equal(qs, os_)
    np.testing.assert_array_equal(qc, oc)
    if abs(lo) > 1 << 61:  # the wrapping cases really wrapped
        exact = sum(int(x) for x in cols[0][(gid == 0) & masks[0]])
        assert int(ps[0, 0]) != exact
        assert (int(ps[0, 0]) - exact) % (1 << 64) == 0


def _q1_items(a, m):
    """TPC-H Q1's 8 items over value arrays a[0..4] (quantity, price, disc
    price, charge, discount) and masks m[0..4]: sum_qty, sum_base_price,
    sum_disc_price, sum_charge, avg_qty, avg_price, avg_disc, count(*).
    The sum and the avg of one column get the same tensor."""
    cols = [a[0], a[1], a[2], a[3], a[0], a[1], a[4], None]
    masks = [m[0], m[1], m[2], m[3], m[0], m[1], m[4], None]
    return cols, masks


# item pattern -> (items, sum columns, count columns, item_sum, item_cnt);
# a[i] are distinct value arrays, m[i] distinct masks
PLAN_CASES = {
    "same-tensor-twice": (lambda a, m: ([a[0], a[0]], [m[0], m[0]]), 1, 1, [0, 0], [0, 0]),
    "same-mask-two-columns": (lambda a, m: ([a[0], a[1]], [m[0], m[0]]), 2, 1, [0, 1], [0, 0]),
    "same-value-two-masks": (lambda a, m: ([a[0], a[0]], [m[0], m[1]]), 2, 2, [0, 1], [0, 1]),
    "null-masks": (lambda a, m: ([a[0], a[1], a[0]], [None, None, None]), 2, 1, [0, 1, 0], [0, 0, 0]),
    "count-star": (lambda a, m: ([None, a[0]], [None, None]), 1, 1, [-1, 0], [0, 0]),
    "count-of-a-column": (lambda a, m: ([None, a[0]], [m[0], m[0]]), 1, 1, [-1, 0], [0, 0]),
    "all-distinct": (lambda a, m: (a[:3], m[:3]), 3, 3, [0, 1, 2], [0, 1, 2]),
    "q1-items": (_q1_items, 5, 6, [0, 1, 2, 3, 0, 1, 4, -1], [0, 1, 2, 3, 0, 1, 4, 5]),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_dedups_and_maps_items_back(case):
    make, ns, nc, item_sum, item_cnt = PLAN_CASES[case]
    n, domain = 5_000, 12
    gid, a, m = _inputs(7, n, domain, 5)
    gid[::31] = -2
    cols, masks = make(a, m)
    plan, qs, qc = _through_plan(gid, cols, masks, domain)
    assert (len(plan.sum_cols), len(plan.count_masks)) == (ns, nc)
    assert (plan.item_sum, plan.item_cnt) == (item_sum, item_cnt)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    for (_, mask), c in zip(plan.sum_cols, plan.sum_cnt):  # a sum's mask is counted
        assert ptr(plan.count_masks[c]) == ptr(mask)
    ps, pc = _port(gid, cols, masks, domain)  # the plain version, item by item
    os_, oc = _oracle(gid, cols, masks, domain)
    np.testing.assert_array_equal(qs, ps)
    np.testing.assert_array_equal(qc, pc)
    np.testing.assert_array_equal(qs, os_)
    np.testing.assert_array_equal(qc, oc)


def test_q1_items_through_plan_equal_pallas_interpret():
    """Q1's item pattern, deduplicated, against the Pallas kernel handed
    every item apart (zeros for a count-only item, all-true for a null
    mask, as the reference's caller passes them)."""
    n, domain = TILE, 6  # Q1's six live slots
    gid, a, m = _inputs(12, n, domain, 5, 0, 10**9)
    cols, masks = _q1_items(a, m)
    js, jc = jax_k1(
        jnp.asarray(gid),
        tuple(jnp.asarray(np.zeros(n, np.int64) if c is None else c) for c in cols),
        tuple(jnp.asarray(np.ones(n, bool) if x is None else x) for x in masks),
        domain,
        interpret=True,
    )
    plan, qs, qc = _through_plan(gid, cols, masks, domain)
    assert (len(plan.sum_cols), len(plan.count_masks)) == (5, 6)
    np.testing.assert_array_equal(qs, np.asarray(js))
    np.testing.assert_array_equal(qc, np.asarray(jc))


def test_cpu_tensors_run_plain_without_launch():
    gid, cols, masks = _inputs(1, 1000, 3, 2)
    before = SD.smalldomain_sum_count.launches
    _port(gid, cols, masks, 3)
    assert SD.smalldomain_sum_count.launches == before


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU must launch the kernel or raise: a device the
    kernel does not take (here 'meta') raises instead of running plain."""
    gid = torch.zeros(8, dtype=torch.int32, device="meta")
    col = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        SD.smalldomain_sum_count(gid, [col], [None], 4)
