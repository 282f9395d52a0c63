"""What a traced run records, and the arithmetic that every per-layer
metric shares.

Spans are the benchmark's own, around its calls into the port: for each
query of the window the seconds inside ``ctx.sql(text)`` (frontend), from
the call of ``.collect()`` to the end of a ``torch.cuda.synchronize()``
that only a traced run adds (collect), and inside ``to_pydict()``
(decode).  ``torch.profiler`` covers one whole pass of the mix inside the
window; the same spans are marked there with ``record_function``, so the
device's timeline and the host's share one clock.

Device time is the union of the intervals in which a kernel, a copy or a
fill ran on the card, so copies that overlap kernels count once.  The
idle share is the rest of the profiled pass's wall time.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("frontend", "collect", "decode")


@dataclass
class Call:
    """One query of the window."""

    query: str
    pass_no: int
    frontend_s: float = 0.0
    collect_s: float = 0.0
    decode_s: float = 0.0
    latency_s: float = 0.0
    rows: int | None = None
    error: str | None = None


@dataclass
class Profile:
    """The profiled pass on the profiler's clock (ns): its bounds, the
    device intervals (start, end, name, kind) and the host spans (start,
    end, "frontend q3").  ``queries``: the queries the pass ran."""

    start: int
    end: int
    queries: int
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def wall_s(self) -> float:
        return (self.end - self.start) / 1e9


@dataclass
class Trace:
    """A run as the metrics read it: ``calls``, every query of the window;
    ``window_s`` and ``setup_s``; ``profile``, the profiled pass (None in
    an untraced run) and ``profiled_pass``, its number."""

    calls: list
    window_s: float
    setup_s: float
    profile: Profile | None = None
    profiled_pass: int | None = None

    def span_calls(self) -> list:
        """The completed queries outside the profiled pass, whose host
        times the profiler slows."""
        return [c for c in self.calls if c.error is None and c.pass_no != self.profiled_pass]


def _kind(e) -> str:
    """What a profiler event is: ``kernel``, ``gpu_memcpy`` or ``gpu_memset``
    on the device, ``span`` for the benchmark's own annotations (on the
    host, where ``record_function`` ran), else ``other``.  By name, since
    the event's own activity type is not in every torch version."""
    name = e.name()
    cuda = e.device_type() == torch.autograd.DeviceType.CUDA
    if name == "pass" or name.split(" ")[0] in SPANS:
        return "other" if cuda else "span"
    if not cuda:
        return "other"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def read_profile(prof, queries: int) -> Profile:
    """The profiled pass of a finished ``torch.profiler.profile``: the
    ``pass`` annotation bounds it."""
    start = end = None
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind == "other":
            continue
        s = e.start_ns()
        iv = (s, s + e.duration_ns())
        if kind != "span":
            device.append((*iv, e.name(), kind))
        elif e.name() == "pass":
            start, end = iv
        else:
            host.append((*iv, e.name()))
    if start is None:
        raise AssertionError("the profiler's trace has no 'pass' annotation")
    return Profile(start, end, queries, device, host)


def merged(intervals, lo: int, hi: int) -> list:
    """The union of (start, end, ...) intervals clipped to [lo, hi], as
    sorted disjoint (start, end) pairs."""
    out: list = []
    for s, e, *_ in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(p: Profile) -> float:
    """Seconds of the pass in which something ran on the device."""
    return sum(e - s for s, e in merged(p.device, p.start, p.end)) / 1e9


def idle_gaps(p: Profile) -> list:
    """(seconds, label) of each stretch of the pass in which nothing ran on
    the device, labelled by the host span at its middle (``between`` when
    the host was in none)."""
    busy = merged(p.device, p.start, p.end)
    bounds = [p.start] + [x for iv in busy for x in iv] + [p.end]
    spans = sorted(p.host)  # one query's spans follow each other: none overlap
    starts = [hs for hs, _, _ in spans]
    out = []
    for s, e in zip(bounds[::2], bounds[1::2]):
        if e <= s:
            continue
        mid = (s + e) // 2
        i = bisect_right(starts, mid) - 1
        label = spans[i][2] if i >= 0 and mid < spans[i][1] else "between"
        out.append(((e - s) / 1e9, label))
    return out


def breakdown(p: Profile, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    longest idle gaps, each at most ``top``, in seconds."""
    by_name: dict = defaultdict(int)
    for s, e, name, _ in p.device:
        by_name[name[:120]] += e - s
    ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:top]
    gaps = sorted(idle_gaps(p), reverse=True)[:top]
    return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": [[label, s] for s, label in gaps]}
