"""Exact grouped int64 sums and counts for a small group domain (kernel K1).

``smalldomain_sum_count`` replaces the TPU kernel
``datafusion_tpu/ops/pallas_kernels.py::smalldomain_sum_count`` (the one
``pl.pallas_call`` of the reference, :132-181), which the fused
small-domain GROUP BY (``ops/aggregate.py``) uses for every
sum, count and avg over integer or decimal storage: one pass over the rows
for all aggregates instead of one masked [domain, N] reduction each.

On a CUDA tensor it launches the hand-written kernel in
``csrc/smalldomain_sum_count.cu`` (design notes there); on a CPU tensor it
runs the plain PyTorch version, ``smalldomain_sum_count_plain``.  Both are
exact: int64 sums wrap mod 2^64, like the reference.

What bounds the kernel on an H100 is bytes: it reads the 4-byte group id
of all N rows, then 8 bytes per distinct value column and 1 per distinct
mask of each live row only, and writes 2 * domain * k int64 values.  The
kernel is handed distinct work only (``plan_items``): TPC-H Q1 passes one
tensor for the sum and the avg of a column, and ``count(*)`` is the row
count of each slot.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from ..device import capturing

MAX_DOMAIN = 256
MAX_COLS = 8


class Plan(NamedTuple):
    """What the kernel computes for k (value, mask) items, and where each
    item's outputs come from."""

    sum_cols: list  # distinct (value, mask or None) pairs, one sum column each
    sum_cnt: list  # per sum column: the count column of its mask
    count_masks: list  # distinct masks, one count column each (None: the live rows)
    item_sum: list  # per item: its sum column, or -1 for a count-only item
    item_cnt: list  # per item: its count column


def plan_items(cols, masks) -> Plan:
    """Each distinct (value, mask) pair is summed once and each distinct
    mask counted once; tensors are the same when their storage is
    (``data_ptr``), and a null mask counts the slot's live rows, as
    ``count(*)`` does."""
    sum_cols, sum_cnt, count_masks, item_sum, item_cnt = [], [], [], [], []
    sum_at, cnt_at = {}, {}

    def ptr(t):
        return None if t is None else t.data_ptr()

    for c, m in zip(cols, masks):
        key = ptr(m)
        if key not in cnt_at:
            cnt_at[key] = len(count_masks)
            count_masks.append(m)
        item_cnt.append(cnt_at[key])
        if c is None:
            item_sum.append(-1)
            continue
        key = (ptr(c), ptr(m))
        if key not in sum_at:
            sum_at[key] = len(sum_cols)
            sum_cols.append((c, m))
            sum_cnt.append(item_cnt[-1])
        item_sum.append(sum_at[key])
    return Plan(sum_cols, sum_cnt, count_masks, item_sum, item_cnt)


def smalldomain_sum_count(gid: torch.Tensor, cols, masks, domain: int):
    """Per (group slot, column): the wrapping int64 sum of the valid values
    and the int64 count of valid rows.

    gid    : [N] int32 group id per row (< 0 or >= domain: a dead row)
    cols   : k [N] int64 value columns; None for a count-only item
    masks  : k [N] bool validity masks; None where every row is valid
    domain : number of group slots
    Returns (sums [domain, k] int64, counts [domain, k] int64).

    On CUDA tensors this launches the kernel (at most 256 slots and 8
    columns, contiguous inputs) or raises; it never falls back to the
    plain version.  ``smalldomain_sum_count.launches`` counts the launches
    it makes; a launch recorded into a CUDA graph is not one, and a replay
    of the graph runs the kernel without calling this wrapper
    (``physical/query_compiler.py``).  The launcher calls only
    ``cudaGetDevice``, ``cudaDeviceGetAttribute`` and the launch on the
    given stream, so a graph can capture it."""
    cols, masks = list(cols), list(masks)
    if len(cols) != len(masks):
        raise ValueError("cols and masks must pair up")
    if gid.device.type == "cpu":
        return smalldomain_sum_count_plain(gid, cols, masks, domain)
    _check_cuda_args(gid, cols, masks, domain)
    k = len(cols)
    n = gid.shape[0]
    out = torch.zeros((2, domain, k), dtype=torch.int64, device=gid.device)
    sums, counts = out[0], out[1]
    if n == 0:
        return sums, counts
    plan = plan_items(cols, masks)

    def ptrs(ts):
        return (ctypes.c_void_p * MAX_COLS)(*[None if t is None else t.data_ptr() for t in ts])

    def idx(xs):
        return (ctypes.c_byte * MAX_COLS)(*xs)

    stream = torch.cuda.current_stream(gid.device).cuda_stream
    err = _launcher()(
        gid.data_ptr(), n, domain,
        len(plan.sum_cols), ptrs(c for c, _ in plan.sum_cols), idx(plan.sum_cnt),
        len(plan.count_masks), ptrs(plan.count_masks),
        k, idx(plan.item_sum), idx(plan.item_cnt),
        sums.data_ptr(), counts.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"smalldomain_sum_count launch failed: CUDA error {err}")
    if not capturing():
        # inside a CUDA graph capture the launch is recorded, not run; the
        # executor threads of a distributed context launch concurrently
        with _LAUNCHES_LOCK:
            smalldomain_sum_count.launches += 1
    return sums, counts


smalldomain_sum_count.launches = 0
_LAUNCHES_LOCK = threading.Lock()


@functools.cache
def _launcher():
    """The kernel's C launcher (built on first use), its signature set."""
    from ..build import load

    fn = load("smalldomain_sum_count").smalldomain_sum_count_launch
    fn.argtypes = [
        ctypes.c_void_p,  # gid
        ctypes.c_longlong,  # n
        ctypes.c_int,  # domain
        ctypes.c_int,  # ns
        ctypes.POINTER(ctypes.c_void_p),  # sum_vals[MAX_COLS]
        ctypes.POINTER(ctypes.c_byte),  # sum_cnt[MAX_COLS]
        ctypes.c_int,  # nc
        ctypes.POINTER(ctypes.c_void_p),  # cnt_masks[MAX_COLS]
        ctypes.c_int,  # k
        ctypes.POINTER(ctypes.c_byte),  # item_sum[MAX_COLS]
        ctypes.POINTER(ctypes.c_byte),  # item_cnt[MAX_COLS]
        ctypes.c_void_p,  # sums
        ctypes.c_void_p,  # counts
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(gid, cols, masks, domain):
    if gid.device.type != "cuda":
        raise ValueError(f"smalldomain_sum_count: unsupported device {gid.device}")
    if not 1 <= domain <= MAX_DOMAIN:
        raise ValueError(f"domain {domain} outside 1..{MAX_DOMAIN}")
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"{len(cols)} columns outside 1..{MAX_COLS}")
    n = gid.shape[0]

    def check(t, dtype, what):
        if t.device != gid.device:
            raise ValueError(f"{what} on {t.device}, gid on {gid.device}")
        if t.dtype != dtype or t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{what} must be [{n}] {dtype}, got {list(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")

    check(gid, torch.int32, "gid")
    for j, (c, m) in enumerate(zip(cols, masks)):
        if c is not None:
            check(c, torch.int64, f"cols[{j}]")
        if m is not None:
            check(m, torch.bool, f"masks[{j}]")


def smalldomain_sum_count_plain(gid: torch.Tensor, cols, masks, domain: int):
    """Plain PyTorch version: ``index_add_`` of the masked int64 values into
    a [domain + 1] buffer whose last slot takes the dead rows, then drops
    it."""
    dead = (gid < 0) | (gid >= domain)
    g = torch.where(dead, torch.full_like(gid, domain), gid).to(torch.int64)
    sums, counts = [], []
    for c, m in zip(cols, masks):
        s = torch.zeros(domain + 1, dtype=torch.int64, device=gid.device)
        n = torch.zeros(domain + 1, dtype=torch.int64, device=gid.device)
        if c is not None:
            v = c if m is None else torch.where(m, c, torch.zeros_like(c))
            s.index_add_(0, g, v)
        n.index_add_(0, g, torch.ones_like(g) if m is None else m.to(torch.int64))
        sums.append(s[:domain])
        counts.append(n[:domain])
    empty = torch.zeros((domain, 0), dtype=torch.int64, device=gid.device)
    return (
        torch.stack(sums, dim=1) if sums else empty,
        torch.stack(counts, dim=1) if counts else empty.clone(),
    )
