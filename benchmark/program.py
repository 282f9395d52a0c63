"""The port's own spans and counters (``datafusion_tpu_torch/tracing.py``)
as the benchmark reads them.

``summarize`` turns what one query recorded (``tracing.drain()`` after
the query) into the totals a per-layer metric reads, kept on the query's
``Call`` as ``program``; ``mean_per_query`` averages one of them over the
completed queries outside the profiled pass (``Trace.span_calls``), and
finds nothing in a run whose calls carry no ``program``.
``idle_by_span`` puts each idle stretch of the profiled pass down to the
innermost program span at its middle.

Nothing here imports the port: the records are plain tuples.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict

from .trace import merged

PREFIX = "dftpu."


def summarize(records) -> dict:
    """One query's records: seconds and count of each span name
    (``span_s``, ``span_n``), each counter's total (``counters``), and the
    seconds of ``dftpu.sync`` spans by the name of their root span
    (``sync_s``: the host's waits for the device in its ``sql``,
    ``collect`` or ``decode``)."""
    span_s: dict = defaultdict(float)
    span_n: dict = defaultdict(int)
    sync_s: dict = defaultdict(float)
    by_id = {s.id: s for s in records.spans}
    for s in records.spans:
        secs = (s.end_ns - s.start_ns) / 1e9
        span_s[s.name] += secs
        span_n[s.name] += 1
        if s.name == PREFIX + "sync":
            root = s
            while root.parent is not None and root.parent in by_id:
                root = by_id[root.parent]
            sync_s[root.name] += secs
    counters: dict = defaultdict(int)
    for (_, name), n in records.counters.items():
        counters[name] += n
    return {"span_s": dict(span_s), "span_n": dict(span_n), "counters": dict(counters),
            "sync_s": dict(sync_s)}


def program_calls(trace) -> list:
    """The completed queries outside the profiled pass that carry the
    port's records."""
    return [c for c in trace.span_calls() if getattr(c, "program", None) is not None]


def mean_per_query(trace, value) -> float | None:
    """The mean of ``value(program)`` over ``program_calls``; None when
    there are none."""
    calls = program_calls(trace)
    return sum(value(c.program) for c in calls) / len(calls) if calls else None


def span_ms(name: str):
    """``value`` for ``mean_per_query``: milliseconds in spans ``name``."""
    return lambda p: 1e3 * p["span_s"].get(name, 0.0)


def counter(name: str):
    """``value`` for ``mean_per_query``: the counter ``name``'s total."""
    return lambda p: p["counters"].get(name, 0)


def profiled_spans(prof) -> list:
    """(start, end, name) on the profiler's clock of every program span a
    finished ``torch.profiler.profile`` recorded (the tracer opens a
    ``record_function`` of the span's name while the profiler records)."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(PREFIX) and e.device_type() != torch.autograd.DeviceType.CUDA:
            s = e.start_ns()
            out.append((s, s + e.duration_ns(), e.name()))
    return out


def idle_by_span(profile, spans: list, top: int = 10) -> list:
    """[(name, seconds)] of the profiled pass's idle stretches (nothing on
    the device), each put down to the innermost program span at its
    middle, or ``between`` where there is none; the ``top`` largest.
    ``profile``: a ``trace.Profile``; ``spans``: (start, end, name) on the
    same clock.  Spans of one thread nest, so the innermost one holding a
    moment is the latest-started one that holds it."""
    busy = merged(profile.device, profile.start, profile.end)
    bounds = [profile.start] + [x for iv in busy for x in iv] + [profile.end]
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    out: dict = defaultdict(float)
    for s, e in zip(bounds[::2], bounds[1::2]):
        if e <= s:
            continue
        mid = (s + e) // 2
        label = "between"
        for i in range(bisect_right(starts, mid) - 1, -1, -1):
            if spans[i][1] > mid:
                label = spans[i][2]
                break
        out[label] += (e - s) / 1e9
    return sorted(out.items(), key=lambda kv: kv[1], reverse=True)[:top]
