"""SPMD shard bodies and their collectives: the port's counterpart of
``jax.shard_map`` and ``jax.lax``'s collectives.

A shard body is a Python generator ``body(me, *args)``: ``me`` is the
shard's index on the mesh axis (``jax.lax.axis_index``), and the body
yields a collective request whenever it needs the other shards, getting
the result back from the ``yield``::

    recv = yield AllToAll(send.view(ndev, B))

Helpers that exchange data (the shuffles) are generators too, called
with ``yield from``.  A body that needs no collective may be a plain
function.

``run_spmd`` drives one generator per shard from one controller: it steps
every shard to its next request, checks that all of them asked for the
same collective with the same shape and dtype, performs the collective
once and sends each shard its part.  A shard that finishes while another
waits, or requests that differ, raise ``InternalError`` naming the
operator and the shards; an exception in one shard closes the others and
reaches the caller.  Nothing waits on another thread, so nothing hangs.

Shards on one device exchange through one stacked copy (``torch.stack``
along the receiver's axis), not ndev^2 small copies; shards on several
devices meet on the first one and take their parts back with ``.to``.
All shards on a card run on the card's current stream.  Across processes
(``multihost.py``) the local shards meet here first, then one
``torch.distributed`` call per collective crosses the processes.
"""

from __future__ import annotations

import inspect

import torch

from .. import tracing
from ..errors import InternalError


class Collective:
    """A request a shard body yields; ``x`` is the shard's operand."""

    def __init__(self, x: torch.Tensor):
        self.x = x

    def signature(self) -> tuple:
        return (type(self).__name__, tuple(self.x.shape), self.x.dtype)

    def __repr__(self):
        name, shape, dtype = self.signature()
        return f"{name}({list(shape)}, {dtype})"


class AllToAll(Collective):
    """``x`` is [ndev, ...]: row d goes to shard d.  The result is
    [ndev, ...] whose row s came from shard s (``jax.lax.all_to_all``
    with split and concat axis 0)."""


class AllGather(Collective):
    """The result is [ndev, *x.shape]: row s is shard s's ``x``."""


class Psum(Collective):
    """The elementwise sum of every shard's ``x``."""


class Pmax(Collective):
    """The elementwise maximum of every shard's ``x``."""


# the span, and so the torch.profiler range while the tracer is on, of the
# exchanges' device work (the collectives' copies and the shuffles' layout
# and packing), for the share of a mesh query's kernel time they take
EXCHANGE_RANGE = "spmd.exchange"


def perform_local(reqs: list) -> list:
    """Each local shard's result of one collective among the local shards
    (the whole mesh in a single process)."""
    with tracing.span(EXCHANGE_RANGE):
        return _perform_local(reqs)


def _perform_local(reqs: list) -> list:
    xs = [r.x for r in reqs]
    devs = [x.device for x in xs]
    home = devs[0]
    if any(d != home for d in devs):
        xs = [x.to(home) for x in xs]
    kind = type(reqs[0])
    if kind is AllToAll:
        # out[d, s] = shard s's row d: one copy, each receiver a view
        out = torch.stack(xs, dim=1)
        parts = [out[d] for d in range(len(xs))]
    elif kind is AllGather:
        out = torch.stack(xs)
        parts = [out] * len(xs)
    elif kind is Psum:
        out = torch.stack(xs).sum(0, dtype=xs[0].dtype)
        parts = [out] * len(xs)
    elif kind is Pmax:
        out = torch.stack(xs).amax(0)
        parts = [out] * len(xs)
    else:
        raise InternalError(f"unknown collective {kind.__name__}")
    return [p if p.device == d else p.to(d) for p, d in zip(parts, devs)]


class CrossProcessMismatch(InternalError):
    """The processes of a multi-process mesh asked for different
    collectives (or one of them failed or finished first)."""


def run_spmd(mesh, body, args: list, name: str = "spmd") -> list:
    """Run ``body(me, *args[j])`` for each local shard j of ``mesh`` (``me``
    its global index) and return their results, in local shard order."""
    local = mesh.local_shards
    if len(args) != len(local):
        raise InternalError(f"{name}: {len(args)} argument sets for {len(local)} shards")
    gens, results = [], [None] * len(local)
    for j, me in enumerate(local):
        r = body(me, *args[j])
        if inspect.isgenerator(r):
            gens.append(r)
        else:
            gens.append(None)
            results[j] = r
    cross = mesh.cross
    sends = [None] * len(local)
    try:
        while any(g is not None for g in gens):
            reqs, finished = [None] * len(local), []
            for j, g in enumerate(gens):
                if g is None:
                    continue
                try:
                    reqs[j] = g.send(sends[j])
                except StopIteration as stop:
                    results[j] = stop.value
                    gens[j] = None
                    finished.append(j)
            waiting = [j for j, r in enumerate(reqs) if r is not None]
            if not waiting:
                break
            if len(waiting) != len(local):
                done = [local[j] for j in range(len(local)) if reqs[j] is None]
                raise InternalError(
                    f"{name}: shards {done} finished while shards "
                    f"{[local[j] for j in waiting]} wait at {reqs[waiting[0]]!r}"
                )
            sig = reqs[0].signature()
            odd = [local[j] for j, r in enumerate(reqs) if r.signature() != sig]
            if odd:
                raise InternalError(
                    f"{name}: shards {odd} ask for "
                    f"{[reqs[local.index(s)] for s in odd]} while shard "
                    f"{local[0]} asks for {reqs[0]!r}"
                )
            if cross is not None:
                cross.agree(name, sig)
            sends = perform_local(reqs) if cross is None else cross.perform(reqs)
        if cross is not None:
            cross.agree(name, ("done",))
    except BaseException as err:
        for g in gens:
            if g is not None:
                g.close()
        if cross is not None and not isinstance(err, CrossProcessMismatch):
            cross.abandon(name)
        raise
    return results


# ---------------------------------------------------------------------------
# packed exchanges: columns of one width travel in one collective
# ---------------------------------------------------------------------------

_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _width_groups(cols: list) -> dict:
    """Column positions grouped by (element size, trailing shape), in first
    appearance order (the same on every shard)."""
    groups: dict = {}
    for i, c in enumerate(cols):
        groups.setdefault((c.element_size(), tuple(c.shape[1:])), []).append(i)
    return groups


def exchange_columns(cols: list, ndev: int, bucket: int):
    """All-to-all of ``cols`` ([ndev * bucket, ...] each; rows
    [d*bucket, (d+1)*bucket) go to shard d), one collective per column
    width: the columns ride one stacked buffer as integer bits.  A
    generator (``yield from``); returns the received columns, [ndev *
    bucket, ...] each, rows [s*bucket, (s+1)*bucket) from shard s."""
    out = [None] * len(cols)
    for (size, tail), idx in _width_groups(cols).items():
        it = _INT_OF_SIZE[size]
        send = torch.stack([cols[i].view(it).reshape((ndev, bucket) + tail) for i in idx], dim=1)
        recv = yield AllToAll(send)
        for j, i in enumerate(idx):
            out[i] = recv[:, j].reshape((ndev * bucket,) + tail).view(cols[i].dtype)
    return out


def gather_columns(cols: list):
    """All-gather of ``cols``, one collective per column width.  A
    generator; returns [ndev, *shape] per column."""
    out = [None] * len(cols)
    for (size, tail), idx in _width_groups(cols).items():
        it = _INT_OF_SIZE[size]
        if len({cols[i].shape[0] for i in idx}) == 1:
            recv = yield AllGather(torch.stack([cols[i].view(it) for i in idx]))
            for j, i in enumerate(idx):
                out[i] = recv[:, j].view(cols[i].dtype)
        else:
            for i in idx:
                out[i] = (yield AllGather(cols[i].view(it))).view(cols[i].dtype)
    return out
