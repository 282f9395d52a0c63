"""Whole-query execution: a warm plan runs as one unit.

Port of ``datafusion_tpu/physical/query_compiler.py``.  The reference traces
a warm plan into one XLA program.  Here a warm plan becomes one CUDA graph
(``torch.cuda.CUDAGraph``): once every join and every fused stage has
learned its capacities (``ops/join.py``, ``physical/stage_compiler.py``),
the speculative path of the whole tree reads nothing on the host and has
static shapes, so its kernels, the hand-written ones included, are
captured once and replayed with one launch per query.

The collects of one cached plan (``ExecutionContext.collect``):
  1. the first runs node by node (exactly, or speculating at probe
     capacity) and learns the capacities;
  2. the second runs the speculative path eagerly with every host read
     refused (``columnar/table.py::BUILD``).  A read raises
     ``HostReadInWholeQuery`` naming its node, and the plan keeps running
     node by node; so this run decides, on the CPU and on the card alike,
     which plans become one unit.  It also fills the memos a capture reads
     (device tables) and loads every kernel once.  On the card it runs
     with torch's synchronization check set to raise, which catches the
     syncs hidden inside torch operations;
  3. on the card the third captures the plan into a graph on a side stream
     and replays it, and later collects only replay.  On the CPU, which
     has no graphs, every later collect runs the guarded speculative path
     eagerly, refusing fresh host-to-device copies as a capture would.

The overflow flags a run records are summed into one int32, an output of
the graph, which the window's owner reads once per query; a plan that
records no flag needs no read.  After an overflow the context drops the
graph (``invalidate``), reruns the query exactly, which relearns, and the
plan is checked and captured again.  A build that fails is dropped and
counted; after ``MAX_ATTEMPTS`` failures the plan stops trying.

Every graph on a device allocates from one memory pool
(``torch.cuda.MemPool``), so the pool holds about the largest plan's
working set and the outputs of each graph, not a working set per plan.
Sharing is safe because a graph's memory means something only from the
start of its replay to the end of the copies of its outputs, and these
never overlap with another graph's: every capture and every replay, with
the copies that follow it, runs on one stream per device, under one lock.
So a replay may overwrite what another graph left in the pool, never what
it still reads.  The copies are what a collect returns: two collects
share no buffer.  The leaves' tensors are read in place: the plan cache
keys on the catalog version, so a plan's tables live as long as its
graph, and the context releases the graphs of its cached plans when the
catalog changes (``release``).  When the card runs out of memory the
context releases every graph and the pool (``release_graphs``) and runs
the query again.  A morsel loop's graph of one morsel's work
(``PieceGraph``, ``physical/morsel.py``) follows the same rules.
"""

from __future__ import annotations

import os
import threading
import traceback
import weakref
from pathlib import Path

import torch

from .. import tracing
from ..columnar.column import Column
from ..columnar.table import BUILD, Table
from ..errors import HostReadInWholeQuery

# per device: the pool every graph allocates from and the stream every
# capture and replay runs on; the lock orders them (module docstring)
_POOLS: dict = {}
_STREAMS: dict = {}
_LOCK = threading.Lock()
# what holds a graph (a plan's state, a morsel loop's ``PieceGraph``), for
# ``release_graphs``
_HOLDING: weakref.WeakSet = weakref.WeakSet()
# per device: the last morsel loop's graph, kept until the next one is
# captured.  torch's pinned-memory allocator counts each pool's graphs too
# and refuses a capture into a pool whose graphs are all gone: so a pool
# is used again only while a graph keeps it (``_forget_pool``)
_RETAINED: dict = {}


def _pool(device: torch.device):
    if device not in _POOLS:
        with torch.cuda.device(device):
            _POOLS[device] = torch.cuda.MemPool()
    return _POOLS[device]


def _stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def _forget_pool(device) -> None:
    """Once no graph on ``device`` is held or retained, drop its pool: the
    allocator can then hand its memory back, and no capture goes into a
    pool that no graph keeps."""
    if device is not None and device not in _RETAINED and not any(wq.device == device for wq in _HOLDING):
        _POOLS.pop(device, None)


def pool_bytes(device) -> int:
    """Device memory the graphs' shared pool on ``device`` holds."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    pool = _POOLS.get(device)
    if pool is None:
        return 0
    return sum(
        s["total_size"] for s in torch.cuda.memory_snapshot()
        if tuple(s["segment_pool_id"]) == tuple(pool.id) and s["device"] == device.index
    )


def release_graphs() -> bool:
    """Drop every graph held (the plans' and a morsel loop's), and the
    pools, returning their memory to the card; the plans check and capture
    again on later collects.  Returns whether there was anything to drop."""
    held = list(_HOLDING)
    for wq in held:
        wq.invalidate()
    # a morsel loop's graph leaves its memory in the pool for the next loop
    pooled = bool(_POOLS)
    _RETAINED.clear()
    _POOLS.clear()
    if held or pooled:
        torch.cuda.empty_cache()
    return bool(held or pooled)


def capture(device, run, into: torch.Tensor | None = None):
    """``run()`` captured into a new CUDA graph on ``device``'s graph
    stream, from the shared pool, with every host read and fresh
    host-to-device copy refused (``BUILD``) and torch's synchronization
    check set to raise.  Returns (graph, what ``run`` returned, the int32
    sum of the overflow flags it recorded, or None); with ``into`` the
    graph also adds that sum to ``into``.  Call under ``_LOCK``.  Raises
    what ``run`` raises, and torch's refusal of an operation, the capture
    then abandoned."""
    from ..ops import kernels as K

    flags = K.SPECULATION.flags
    snap = len(flags)
    graph = torch.cuda.CUDAGraph()
    main = torch.cuda.current_stream(device)
    side = _stream(device)
    side.wait_stream(main)
    mode = torch.cuda.get_sync_debug_mode()
    BUILD.active = BUILD.strict = True
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(pool=_pool(device).id, capture_error_mode="thread_local")
            try:
                out = run()
                flag = None
                for f in flags[snap:]:
                    f = f.to(torch.int32)
                    flag = f if flag is None else flag + f
                if into is not None and flag is not None:
                    into += flag
            finally:
                del flags[snap:]
                graph.capture_end()
    finally:
        BUILD.active = BUILD.strict = False
        torch.cuda.set_sync_debug_mode(mode)
        main.wait_stream(side)
    return graph, out, flag


def replay(graph, out: Table, flag, device) -> Table:
    """Replay ``graph`` and copy its output table ``out`` out of the pool,
    before any other graph's replay can overwrite it (module docstring);
    a copy of ``flag``, when given, is recorded in the speculation
    window."""
    from ..ops import kernels as K

    main = torch.cuda.current_stream(device)
    side = _stream(device)
    with _LOCK:
        side.wait_stream(main)
        with torch.cuda.stream(side):
            graph.replay()
            cols = [
                Column(c.dtype, c.data.clone(), c.valid.clone(), c.dictionary, vrange=c.vrange)
                for c in out.columns
            ]
            n = out.nrows_dev
            n = n if isinstance(n, int) else n.clone()
            flag = None if flag is None else flag.clone()
        main.wait_stream(side)
    for t in [*(c.data for c in cols), *(c.valid for c in cols), n, flag]:
        if isinstance(t, torch.Tensor):
            # made on the side stream, read on the caller's
            t.record_stream(main)
    if flag is not None:
        K.spec_record(flag)
    t = Table(list(out.names), cols, n, device=out.device)
    t._cap_learned = True
    return t


class PieceGraph:
    """A CUDA graph of one piece of a plan's work that its caller captures
    and replays itself (a morsel's stage: ``physical/morsel.py``), under
    the whole-query graphs' rules: their stream, pool and lock.  The
    overflow flags its capture records are summed into ``flags`` at each
    replay (None when it records none), which the caller records once.
    Held, so ``release_graphs`` can drop it, from its capture until
    ``invalidate``."""

    def __init__(self, device, run):
        """Capture ``run()`` (``capture``; raises what it raises)."""
        self.device = device
        acc = torch.zeros((), dtype=torch.int32, device=device)
        with _LOCK:
            try:
                self.graph, self._out, flag = capture(device, run, into=acc)
            except BaseException:
                _forget_pool(device)
                raise
            _RETAINED[device] = self.graph
        self.flags = None if flag is None else acc
        _HOLDING.add(self)

    def replay(self) -> Table:
        return replay(self.graph, self._out, None, self.device)

    def invalidate(self):
        """Drop the graph (``_RETAINED`` may keep it until the next
        capture); its memory stays in the pool."""
        self.graph = self._out = None
        _HOLDING.discard(self)


def _discover_leaves(plan, out, seen):
    """Every MemoryExec reachable from ``plan``, including the sources of
    StageExec (whose children() is empty by design)."""
    from ..ops.basic import MemoryExec
    from .fuse import StageExec

    if id(plan) in seen:
        return
    seen.add(id(plan))
    if isinstance(plan, MemoryExec):
        out.append(plan)
        return
    if isinstance(plan, StageExec):
        _discover_leaves(plan._source, out, seen)
        return
    for c in plan.children():
        _discover_leaves(c, out, seen)


def _contains_untraceable(plan) -> bool:
    """True when the tree holds a node whose execution is host-driven (the
    morsel loops over a host table, a host table's scan, EXPLAIN's
    formatting), so that every build would fail: such a plan is never
    checked nor captured, and runs node by node outside the graphs' pool."""
    from ..datasource.host import HostMemoryExec
    from ..ops.basic import ExplainExec
    from .fuse import StageExec
    from .morsel import MorselJoinStageExec, MorselStageExec

    bad = (MorselStageExec, MorselJoinStageExec, HostMemoryExec, ExplainExec)
    seen: set = set()

    def walk(n) -> bool:
        if id(n) in seen:
            return False
        seen.add(id(n))
        if isinstance(n, bad):
            return True
        kids = list(n.children())
        if isinstance(n, StageExec):
            kids.append(n._source)
        return any(walk(c) for c in kids)

    return walk(plan)


# the guard's own frames, which name no caller
_GUARD_FRAMES = ("refuse_in_whole_query", "host_values", "host_numpy", "nrows")


def _where(e: BaseException) -> str:
    """The innermost frame of this package, the guard's own left out, that
    the exception passed: the read's call site."""
    here = Path(__file__).resolve().parents[1]
    frames = [
        f for f in traceback.extract_tb(e.__traceback__)
        if Path(f.filename).resolve().is_relative_to(here) and f.name not in _GUARD_FRAMES
    ]
    if not frames:
        return ""
    f = frames[-1]
    return f" (at {Path(f.filename).resolve().relative_to(here)}:{f.lineno} {f.name})"


class WholeQuery:
    """The whole-query state of one cached plan object (plans are cached
    per (SQL, catalog version), so one instance sees every warm run of its
    query)."""

    MAX_ATTEMPTS = 3

    def __init__(self, phys):
        # the plan holds this state (``phys._whole_query``); a weak
        # reference back keeps them out of a cycle, so a dropped plan frees
        # its graph at once
        self._phys = weakref.ref(phys)
        self.checked = False  # the guarded speculative run read nothing
        self.graph = None  # on the card: the captured graph
        self.pool_growth = 0  # bytes the shared pool grew by in the capture
        self.failure = None  # why the last build failed: "guard" or "cuda", and the message
        self._out = None  # the graph's output table and summed flag
        self._pins = None  # the device tables the graph reads, kept alive
        self._failures = 0
        leaves: list = []
        # (a dead plan's leaves are not looked at: a host table's would
        # materialize on the device)
        dead = _contains_untraceable(phys)
        if not dead:
            _discover_leaves(phys, leaves, set())
        self.device = leaves[0].table.device if leaves else None
        # constant plans (no table) gain nothing
        self._dead = dead or not leaves

    @property
    def is_program(self) -> bool:
        """The plan runs as one unit: a captured graph on the card, the
        checked speculative path on the CPU."""
        return self.checked and (self.graph is not None or self.device.type != "cuda")

    def invalidate(self):
        """Learned capacities are about to change, or the graph's memory is
        wanted: drop the graph; the next warm collects check and capture
        again."""
        self._drop()
        self._failures = 0

    def _drop(self):
        self.checked = False
        self.graph = None
        self.pool_growth = 0
        self._out = None
        self._pins = None
        _HOLDING.discard(self)
        _forget_pool(self.device)

    def execute(self) -> Table | None:
        """The plan's result as one unit, or None when the plan runs node
        by node this time."""
        from ..ops import kernels as K

        if self._dead or not K.spec_active():
            return None
        if not (self.checked and self.device.type == "cuda"):
            # the check; on the CPU also every later run
            return self._attempt(self._eager)
        if self.graph is None and not self._attempt(self._capture):
            return None
        return self._replay()

    def _attempt(self, build):
        """``build()``, or None when it reads the host (or, on the card,
        when torch refuses an operation inside the check or the capture):
        the flags it recorded are dropped and the failure kept."""
        from ..ops import kernels as K

        flags = K.SPECULATION.flags
        snap = len(flags)
        try:
            return build()
        except HostReadInWholeQuery as e:
            self.failure = ("guard", str(e) + _where(e))
        except RuntimeError as e:
            if self.device.type != "cuda":
                raise
            node = getattr(e, "node", None)
            self.failure = ("cuda", (f"{node}: {e}" if node else str(e)) + _where(e))
        del flags[snap:]
        self._drop()
        self._failures += 1
        self._dead = self._failures >= self.MAX_ATTEMPTS
        return None

    def _eager(self) -> Table:
        cuda = self.device.type == "cuda"
        BUILD.active = True
        BUILD.strict = self.checked
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = self._phys().execute()
        finally:
            BUILD.active = BUILD.strict = False
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
        self.checked = True
        out._cap_learned = True
        return out

    @tracing.spanned("dftpu.collect.capture")
    def _capture(self) -> bool:
        from ..exprs.physical import device_tables

        device = self.device
        with _LOCK:
            torch.cuda.synchronize(device)
            reserved = torch.cuda.memory_reserved(device)
            graph, out, flag = capture(device, lambda: self._phys().execute())
            torch.cuda.synchronize(device)
            self.pool_growth = torch.cuda.memory_reserved(device) - reserved
        self.graph = graph
        self._out = (out, flag)
        self._pins = device_tables()
        _HOLDING.add(self)
        weakref.finalize(self, _forget_pool, device)
        tracing.count("dftpu.graph.captures")
        tracing.count("dftpu.graph.pool_bytes", self.pool_growth)
        return True

    def _replay(self) -> Table:
        out, flag = self._out
        return replay(self.graph, out, flag, self.device)


def _enabled() -> bool:
    return not os.environ.get("DFTPU_NO_WHOLE_QUERY")


def try_whole_query(phys) -> Table | None:
    """For ``ExecutionContext.collect``: the result of a previously run
    plan as one unit, or None (the caller runs it node by node).
    ``DFTPU_NO_WHOLE_QUERY`` set in the environment turns this off."""
    if not _enabled():
        return None
    wq = getattr(phys, "_whole_query", None)
    if wq is None:
        # the first collect runs node by node and learns capacities
        phys._whole_query = WholeQuery(phys)
        return None
    return wq.execute()


def invalidate(phys) -> None:
    wq = getattr(phys, "_whole_query", None)
    if wq is not None:
        wq.invalidate()


def release(phys) -> None:
    """The plan is no longer cached: drop its graph now, its memory with
    it, and never build another."""
    wq = getattr(phys, "_whole_query", None)
    if wq is not None:
        wq._drop()
        wq._dead = True
