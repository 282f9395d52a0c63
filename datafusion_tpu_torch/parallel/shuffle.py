"""Distributed shuffle: hash-partition rows across mesh shards with one
all-to-all per column width.

Port of ``datafusion_tpu/parallel/shuffle.py``.  Replaces the reference's
two exchange mechanisms: RepartitionExec::Hash channels
(datafusion/src/physical_plan/repartition.rs:285-330) and Ballista's
ShuffleWriterExec/ShuffleReaderExec files.

Each shard lays its live rows out by destination in a [ndev, B] send
buffer, exchanges the buffers and the per-destination counts, and (unless
the caller asks otherwise) packs the received rows to the front.  B is a
static bucket capacity; B = shard_cap can never overflow.  Callers with a
smaller B check the returned overflow (the largest per-destination excess)
and retry with an exact-sized bucket.

The JAX package co-sorts every column by destination because a scatter
costs ~10x a payload-carrying sort on a TPU, and exchanges one column per
all_to_all.  On the card the rows' order by destination comes from a
running count and one scatter by (destination, rank within
destination), not a sort; columns of one width travel in one exchange
(``collectives.exchange_columns``), and the received rows are packed by
one gather (``mesh.segment_compaction``).

Every function here is a generator run inside a shard body
(``collectives.run_spmd``): call it with ``yield from``.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..ops import kernels as K
from .collectives import EXCHANGE_RANGE, AllToAll, exchange_columns
from .mesh import segment_compaction


def local_alive(cap: int, nrows_local: torch.Tensor) -> torch.Tensor:
    return torch.arange(cap, device=nrows_local.device) < nrows_local


def hash_dest(key_hash: torch.Tensor, ndev: int) -> torch.Tensor:
    """The destination shard of each row: the 64-bit hash (int64 bits) as
    an unsigned integer modulo ``ndev``, as the JAX package routes."""
    if ndev & (ndev - 1) == 0:
        return key_hash & (ndev - 1)
    half = K._srl(key_hash, 1)  # u = 2 * half + low bit, half >= 0
    return (2 * (half % ndev) + (key_hash & 1)) % ndev


@tracing.spanned(EXCHANGE_RANGE)
def _route(alive: torch.Tensor, dest: torch.Tensor, ndev: int, bucket: int):
    """The send layout: slot (s, k) of the [ndev * bucket] send buffer
    holds the k-th live row bound for shard s.  Each row's place in the
    stable order by destination (dead rows last) is a running count over
    the rows in destination-major order, one 1-D scan; one scatter by
    that place gives the order.  Returns (source row of each slot, slot
    live mask, rows sent to each shard (clamped to the bucket), overflow:
    the largest per-shard excess over the bucket)."""
    cap = dest.shape[0]
    dev = dest.device
    d = torch.where(alive, dest.to(torch.int64), ndev)
    run = torch.cumsum((torch.arange(ndev + 1, device=dev).unsqueeze(1) == d).view(-1), 0).view(ndev + 1, cap)
    place = run.gather(0, d.unsqueeze(0)).squeeze(0) - 1
    order = torch.empty_like(d).scatter_(0, place, torch.arange(cap, device=dev))
    ends = run[:ndev, -1]
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    counts = ends - starts
    p = torch.arange(ndev * bucket, device=dev)
    s, k = p // bucket, p % bucket
    src = order[torch.clamp(starts[s] + k, max=cap - 1)]
    sent = torch.clamp(counts, max=bucket)
    slot_live = k < sent[s]
    overflow = torch.clamp(counts.max() - bucket, min=0)
    return src, slot_live, sent, overflow


def _exchange(datas, valids, src, slot_live, sent, ndev: int, bucket: int):
    """Send the rows ``src`` of every column (valid masks cleared in dead
    slots) and the per-shard counts.  Returns (received datas, received
    valids, received counts [ndev]), uncompacted: shard s's rows sit in
    slots [s*bucket, s*bucket + counts[s])."""
    recv_counts = (yield AllToAll(sent.reshape(ndev, 1))).reshape(ndev)
    recv = yield from exchange_columns(_send_rows(datas, valids, src, slot_live), ndev, bucket)
    return recv[: len(datas)], recv[len(datas):], recv_counts


@tracing.spanned(EXCHANGE_RANGE)
def _send_rows(datas, valids, src, slot_live) -> list:
    return [K.gather(d, src) for d in datas] + [v[src] & slot_live for v in valids]


@tracing.spanned(EXCHANGE_RANGE)
def _compact(datas, valids, recv_counts, ndev: int, bucket: int):
    """Received rows packed to the front, and the receive slot of each
    packed row."""
    idx, live = segment_compaction(recv_counts, bucket, ndev * bucket)
    return [K.gather(d, idx) for d in datas], [v[idx] & live for v in valids], idx


def shuffle_by_hash(datas, valids, nrows_local, key_hash, ndev: int, bucket_cap: int):
    """Route row i to shard hash_dest(key_hash[i]).  Returns (datas',
    valids', nrows_local', overflow) with local capacity ndev * bucket_cap
    (counts are 0-dim tensors)."""
    alive = local_alive(key_hash.shape[0], nrows_local)
    return (yield from shuffle_by_dest(
        datas, valids, alive, hash_dest(key_hash, ndev), ndev, bucket_cap
    ))


def shuffle_by_dest(datas, valids, alive, dest, ndev: int, bucket_cap: int):
    """Route row i to shard dest[i] (in [0, ndev)); dead rows (alive False)
    are dropped.  Same return contract as shuffle_by_hash."""
    src, slot_live, sent, overflow = _route(alive, dest, ndev, bucket_cap)
    rd, rv, rc = yield from _exchange(datas, valids, src, slot_live, sent, ndev, bucket_cap)
    out_d, out_v, _ = _compact(rd, rv, rc, ndev, bucket_cap)
    return out_d, out_v, rc.sum(), overflow


def shuffle_split(key_datas, key_valids, pay_datas, pay_valids, nrows_local, key_hash,
                  ndev: int, bucket_cap: int):
    """Late-materialization split shuffle: the key columns arrive packed to
    the front, the payload columns arrive UNPACKED, with ``pos2[i]`` the
    receive slot of packed row i (callers gather payload rows through it).

    Returns (key_datas', key_valids', pos2, new_n, overflow, pay_recv_d,
    pay_recv_v); payload valids are cleared in dead slots, so a gather
    through pos2 of a live packed row is always safe."""
    alive = local_alive(key_hash.shape[0], nrows_local)
    return (yield from shuffle_split_dest(
        key_datas, key_valids, pay_datas, pay_valids, alive,
        hash_dest(key_hash, ndev), ndev, bucket_cap,
    ))


def shuffle_split_dest(key_datas, key_valids, pay_datas, pay_valids, alive, dest,
                       ndev: int, bucket_cap: int):
    """shuffle_split with an arbitrary destination map (0..ndev-1 for live
    rows)."""
    nk = len(key_datas)
    src, slot_live, sent, overflow = _route(alive, dest, ndev, bucket_cap)
    rd, rv, rc = yield from _exchange(
        list(key_datas) + list(pay_datas), list(key_valids) + list(pay_valids),
        src, slot_live, sent, ndev, bucket_cap,
    )
    kd, kv, pos2 = _compact(rd[:nk], rv[:nk], rc, ndev, bucket_cap)
    return kd, kv, pos2, rc.sum(), overflow, rd[nk:], rv[nk:]


def shuffle_exchange_dest(key_datas, key_valids, pay_datas, pay_valids, alive, dest,
                          ndev: int, bucket_cap: int):
    """Exchange WITHOUT receive packing: keys and payloads arrive
    slot-structured (shard s's rows in slots [s*bucket_cap,
    s*bucket_cap + n_s)), and the caller folds the packing into its own
    next sort through the returned ``keep`` mask.

    Returns (key_recv_d, key_recv_v, pay_recv_d, pay_recv_v, keep, new_n,
    overflow)."""
    nk = len(key_datas)
    src, slot_live, sent, overflow = _route(alive, dest, ndev, bucket_cap)
    rd, rv, rc = yield from _exchange(
        list(key_datas) + list(pay_datas), list(key_valids) + list(pay_valids),
        src, slot_live, sent, ndev, bucket_cap,
    )
    rowpos = torch.arange(ndev * bucket_cap, device=rc.device)
    keep = (rowpos % bucket_cap) < rc[rowpos // bucket_cap]
    return rd[:nk], rv[:nk], rd[nk:], rv[nk:], keep, rc.sum(), overflow
