"""Spans and counters at the layer boundaries of the port's main path.

Off by default, and switched only through this module: ``enable()`` and
``disable()``.  Off, ``span(...)`` returns one shared no-op object and
``count(...)`` returns at once: one module-level check each, no clock
read.  On, a span records its name, start and end
(``time.perf_counter_ns``), its parent (a per-thread stack) and the
request it belongs to; a counter adds to a named total of the current
request.  While ``torch.profiler`` records, each span also opens
``torch.profiler.record_function(name)``, so the profiler places it on the
same clock as the device's kernels.

A request is one query: ``ExecutionContext.sql`` assigns it, the
``DataFrame`` carries it to ``collect`` and the result ``Table`` to
``to_pydict``, so the spans of the three calls share it.  The spans
(``dftpu.`` names):

  dftpu.sql            ExecutionContext.sql; children .parse and .plan
  dftpu.collect        ExecutionContext.collect; children .plan (the plan
                       cache's key and lookup, and optimize and physical
                       planning on a miss) and .run
  dftpu.collect.capture  a plan's capture into a CUDA graph, inside .run
                       (``physical/query_compiler.py``)
  dftpu.sync           a host read of a device value (each ``HOST_SYNCS``
                       increment, ``columnar/table.py``)
  dftpu.morsel         one morsel of a morsel stage
  dftpu.morsel.capture  the capture of a morsel's work into a CUDA graph,
                       inside a dftpu.morsel (``physical/morsel.py``)
  dftpu.morsel.merge   a morsel stage's merge and finish
  dftpu.decode         Table.to_pydict; per column .copy (device to host)
                       and .convert (numpy to Python values)

and the counters of ``.run``: ``dftpu.collect.whole`` when the plan ran
as one unit, ``dftpu.collect.eager`` when it ran node by node, and
``dftpu.collect.rerun`` when an overflow reran it exactly; a capture's
``dftpu.graph.captures`` (one per graph captured) and
``dftpu.graph.pool_bytes`` (the bytes the graphs' shared pool grew by in
it); the morsels a morsel loop ran by a graph's replay,
``dftpu.morsel.replayed``, and node by node, ``dftpu.morsel.eager`` (the
first's share of their sum is the graphs' hit rate);
``dftpu.h2d.bytes``, the host rows copied to the device; and
``dftpu.take``, the calls that moved a table's rows through kernel K2's
wrapper (``ops/take.py``; a graph's replay counts none).  The
decode counts ``dftpu.decode.exact``: the result columns converted value
by value, their values being outside the whole-column conversions'
ranges (``columnar/column.py``).  No span or counter reads a device
value.

Records stay in memory, at most ``CAPACITY`` (the oldest go first);
``drain()`` returns and clears them.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

import torch

CAPACITY = 1 << 16

_on = False
_records: deque = deque(maxlen=CAPACITY)
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_local = threading.local()


class Span(NamedTuple):
    """A finished span; times in ``time.perf_counter_ns`` units."""

    id: int
    parent: int | None
    request: int | None
    name: str
    start_ns: int
    end_ns: int


class _Count(NamedTuple):
    request: int | None
    name: str
    n: int


class Records(NamedTuple):
    """What ``drain`` returns: the spans in the order they ended, and the
    counters' totals by (request, name)."""

    spans: list
    counters: dict


def enable() -> None:
    """Record spans and counters from now on."""
    global _on
    _on = True


def disable() -> None:
    """Record nothing from now on (what is recorded stays until drained)."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def new_request() -> int:
    """A new request id."""
    return next(_request_ids)


def drain() -> Records:
    """The spans and counters recorded since the last drain, cleared."""
    spans, counters = [], {}
    while True:
        try:
            r = _records.popleft()
        except IndexError:
            break
        if isinstance(r, Span):
            spans.append(r)
        else:
            key = (r.request, r.name)
            counters[key] = counters.get(key, 0) + r.n
    return Records(spans, counters)


class _Off:
    """The span while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _On:
    __slots__ = ("name", "request", "id", "parent", "start", "mark", "stack")

    def __init__(self, name: str, request):
        self.name, self.request = name, request

    def __enter__(self):
        self.start = time.perf_counter_ns()
        st = self.stack = _stack()
        self.parent = st[-1].id if st else None
        if self.request is None and st:
            self.request = st[-1].request
        self.id = next(_span_ids)
        st.append(self)
        self.mark = None
        if torch._C._autograd._profiler_enabled():
            self.mark = torch.profiler.record_function(self.name)
            self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        if self.mark is not None:
            self.mark.__exit__(*exc)
        self.stack.pop()
        end = time.perf_counter_ns()
        _records.append(Span(self.id, self.parent, self.request, self.name, self.start, end))
        return False


def span(name: str, request: int | None = None):
    """A context manager timing the work inside it as ``name``;
    ``request`` defaults to the enclosing span's."""
    if not _on:
        return _OFF
    return _On(name, request)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the current request (the
    innermost open span's)."""
    if not _on:
        return
    st = _stack()
    _records.append(_Count(st[-1].request if st else None, name, n))


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
