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
the query again.
"""

from __future__ import annotations

import os
import threading
import traceback
import weakref
from pathlib import Path

import torch

from ..columnar.column import Column
from ..columnar.table import BUILD, Table
from ..errors import HostReadInWholeQuery

# per device: the pool every graph allocates from and the stream every
# capture and replay runs on; the lock orders them (module docstring)
_POOLS: dict = {}
_STREAMS: dict = {}
_LOCK = threading.Lock()
# the plans' states that hold a graph, for ``release_graphs``
_HOLDING: "weakref.WeakSet[WholeQuery]" = weakref.WeakSet()


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
    """Once no graph on ``device`` is held, drop its pool: the allocator
    can then hand its memory back."""
    if device is not None and not any(wq.device == device for wq in _HOLDING):
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
    """Drop every plan's graph, and with the last one the pools, returning
    their memory to the card; the plans check and capture again on later
    collects.  Returns whether there was anything to drop."""
    held = list(_HOLDING)
    for wq in held:
        wq.invalidate()
    if held:
        torch.cuda.empty_cache()
    return bool(held)


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
    """True when the tree holds a node whose execution is host-driven
    (EXPLAIN's formatting; the morsel stages and host tables join this
    list when they are ported), so that every build would fail."""
    from ..ops.basic import ExplainExec
    from .fuse import StageExec

    seen: set = set()

    def walk(n) -> bool:
        if id(n) in seen:
            return False
        seen.add(id(n))
        if isinstance(n, ExplainExec):
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
        _discover_leaves(phys, leaves, set())
        self.device = leaves[0].table.device if leaves else None
        # constant plans (no table) gain nothing
        self._dead = not leaves or _contains_untraceable(phys)

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

    def _capture(self) -> bool:
        from ..exprs.physical import device_tables
        from ..ops import kernels as K

        device = self.device
        flags = K.SPECULATION.flags
        snap = len(flags)
        graph = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream(device)
        side = _stream(device)
        with _LOCK:
            torch.cuda.synchronize(device)
            reserved = torch.cuda.memory_reserved(device)
            side.wait_stream(main)
            BUILD.active = BUILD.strict = True
            try:
                with torch.cuda.stream(side):
                    graph.capture_begin(pool=_pool(device).id, capture_error_mode="thread_local")
                    try:
                        out = self._phys().execute()
                        flag = None
                        for f in flags[snap:]:
                            f = f.to(torch.int32)
                            flag = f if flag is None else flag + f
                    finally:
                        del flags[snap:]
                        graph.capture_end()
            finally:
                BUILD.active = BUILD.strict = False
                main.wait_stream(side)
            torch.cuda.synchronize(device)
            self.pool_growth = torch.cuda.memory_reserved(device) - reserved
        self.graph = graph
        self._out = (out, flag)
        self._pins = device_tables()
        _HOLDING.add(self)
        weakref.finalize(self, _forget_pool, device)
        return True

    def _replay(self) -> Table:
        from ..ops import kernels as K

        out, flag = self._out
        main = torch.cuda.current_stream(self.device)
        side = _stream(self.device)
        with _LOCK:
            # the outputs are copied before any other graph's replay can
            # overwrite the shared pool (module docstring)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self.graph.replay()
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
