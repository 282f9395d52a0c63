"""The metric arithmetic on synthetic spans and profiler intervals."""

import importlib
import math
import statistics

import pytest

from benchmark.trace import Call, Profile, Trace, breakdown, busy_s, idle_gaps, merged

MS = 1_000_000  # ns


def read(name, trace):
    return importlib.import_module(f"benchmark.metrics.{name}").read(trace)


def calls():
    out = []
    for p in range(3):
        for q, lat in (("q1", 0.010), ("q10", 0.800), ("q6", 0.005)):
            out.append(Call(q, p, frontend_s=0.002, collect_s=lat / 2, decode_s=lat / 2 - 0.002,
                            latency_s=lat, rows=4))
    out.append(Call("q3", 3, latency_s=0.050, error="RuntimeError: boom"))
    return out


def profile():
    # a pass of 100 ms running 2 queries: a copy 10-30 overlapping a kernel
    # 20-40, a kernel 60-70, a fill 65-68 inside it, a kernel past the end
    p = Profile(start=0, end=100 * MS, queries=2)
    p.device = [(10 * MS, 30 * MS, "Memcpy HtoD (Pinned -> Device)", "gpu_memcpy"),
                (20 * MS, 40 * MS, "gather_kernel", "kernel"),
                (60 * MS, 70 * MS, "sort_kernel", "kernel"),
                (65 * MS, 68 * MS, "Memset (Device)", "gpu_memset"),
                (95 * MS, 120 * MS, "gather_kernel", "kernel")]
    p.host = [(0, 45 * MS, "collect q6"), (45 * MS, 55 * MS, "decode q6"), (58 * MS, 90 * MS, "collect q1")]
    return p


def test_end_to_end():
    t = Trace(calls(), window_s=4.5, setup_s=31.25)
    assert read("queries_per_s", t) == pytest.approx(9 / 4.5)
    lat = [1e3 * c.latency_s for c in t.calls if c.error is None]
    assert read("geomean_ms", t) == pytest.approx(math.exp(sum(map(math.log, lat)) / 9))
    assert read("geomean_ms", t) == pytest.approx((10 * 800 * 5) ** (1 / 3))
    assert read("p95_ms", t) == pytest.approx(statistics.quantiles(lat, n=100, method="inclusive")[94])
    assert read("p95_ms", t) == 800.0
    assert read("setup_s", t) == 31.25


def test_spans_leave_out_the_profiled_pass_and_failures():
    t = Trace(calls(), 4.5, 30.0, profiled_pass=1)
    assert read("frontend_ms", t) == pytest.approx(2.0)
    assert read("collect_ms", t) == pytest.approx(1e3 * (0.005 + 0.4 + 0.0025) / 3)
    assert read("decode_ms", t) == pytest.approx(1e3 * (0.003 + 0.398 + 0.0005) / 3)
    assert read("frontend_ms", Trace([], 1.0, 1.0)) is None


def test_device_union_counts_overlaps_once():
    p = profile()
    assert merged(p.device, p.start, p.end) == [(10 * MS, 40 * MS), (60 * MS, 70 * MS), (95 * MS, 100 * MS)]
    assert busy_s(p) == pytest.approx(0.045)
    t = Trace(calls(), 4.5, 30.0, p, 1)
    assert read("device_idle_pct", t) == pytest.approx(55.0)  # not 100 * (1 - 0.063 / 0.1)
    assert read("kernel_ms", t) == pytest.approx(22.5)
    assert read("h2d_ms", t) == pytest.approx(10.0)


def test_readers_find_nothing_without_a_profile_or_a_copy():
    t = Trace(calls(), 4.5, 30.0)
    for name in ("device_idle_pct", "kernel_ms", "h2d_ms"):
        assert read(name, t) is None
    p = profile()
    p.device = [d for d in p.device if d[3] != "gpu_memcpy"]
    assert read("h2d_ms", Trace(calls(), 4.5, 30.0, p, 1)) is None


def test_idle_gaps_named_by_host_span():
    gaps = sorted(idle_gaps(profile()))
    assert gaps == [(pytest.approx(0.010), "collect q6"), (pytest.approx(0.020), "decode q6"),
                    (pytest.approx(0.025), "collect q1")]
    p = profile()
    p.host[-1] = (58 * MS, 80 * MS, "collect q1")  # the host left q1's span before the gap's middle
    assert sorted(idle_gaps(p))[-1] == (pytest.approx(0.025), "between")
    b = breakdown(profile(), top=2)
    assert b["device_ops"][0] == ["gather_kernel", pytest.approx(0.045)]
    assert [g[0] for g in b["idle_gaps"]] == ["collect q1", "decode q6"]
    assert len(b["device_ops"]) == 2
