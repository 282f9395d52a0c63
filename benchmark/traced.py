"""Run one cell as ``benchmark.run --trace 1`` does, with the port's tracer
(``datafusion_tpu_torch/tracing.py``) on for each query of the window,
and print its result line with the program's per-layer metrics added.

    python3 -m benchmark.traced --workload <cell> --seed <n> --seconds <s>

The tracer is on only around each query of the window (``sql``,
``collect``, ``to_pydict``), off for the warm-up and the reference; after
each query its records are drained and summarized on the query's
``Call`` (``program.summarize``).  Besides the lines of ``benchmark.run``
it prints to standard error:

* ``[tracer-cost]``: nanoseconds per ``span`` call with the tracer off
  and on, on this host;
* ``[tracer]``: spans and counter names per query;
* ``[idle-by-span]``: the profiled pass's idle seconds by the innermost
  program span at each idle stretch's middle (top 10).

The harness's own files are used as they are: this module wraps
``run.run_query`` and ``run.read_profile`` for the length of the run, and
takes the profiled pass to be the one whose queries ``run.window`` runs
annotated.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import program, run
from .trace import Trace

# the program's per-layer metrics, each read by metrics/<name>.py
METRICS = (("plan_ms", "ms"), ("graph_replay_pct", "%"), ("sync_wait_ms", "ms"),
           ("syncs_per_query", "syncs"), ("morsel_host_ms", "ms"), ("h2d_mb", "MB"),
           ("decode_copy_ms", "ms"), ("decode_convert_ms", "ms"))


def span_cost(n: int = 200_000) -> tuple[float, float]:
    """Nanoseconds per ``with tracing.span(...)`` off and on (on: without a
    profiler, the buffer full after its first 65,536 spans)."""
    from datafusion_tpu_torch import tracing

    def loop(k: int) -> float:
        t0 = time.perf_counter_ns()
        for _ in range(k):
            with tracing.span("dftpu.cost"):
                pass
        return (time.perf_counter_ns() - t0) / k

    off = loop(n)
    tracing.enable()
    try:
        on = sum(loop(10_000) for _ in range(n // 10_000)) / (n // 10_000)
    finally:
        tracing.disable()
        tracing.drain()
    return off, on


def traced_cell(workload: str, seed: int, seconds: float, device, sf: float | None = None) -> dict:
    """``run.run_cell``'s traced result with the program's metrics added;
    ``sf`` overrides the configuration's scale factor (tests)."""
    from datafusion_tpu_torch import tracing

    calls, seen = [], {}
    run_query, read_profile = run.run_query, run.read_profile

    def traced_query(ctx, name, text, pass_no, dev, traced, annotate):
        if pass_no < 0:  # warm-up
            return run_query(ctx, name, text, pass_no, dev, traced, annotate)
        if annotate:  # the window runs the profiled pass's queries annotated
            seen["pass"] = pass_no
        tracing.drain()
        tracing.enable()
        try:
            call, rows = run_query(ctx, name, text, pass_no, dev, traced, annotate)
        finally:
            tracing.disable()
        call.program = program.summarize(tracing.drain())
        calls.append(call)
        return call, rows

    def profile_and_spans(prof, queries):
        seen["spans"] = program.profiled_spans(prof)
        p = seen["profile"] = read_profile(prof, queries)
        # the profiler also puts each span on the device's timeline, as a
        # range over the kernels it launched: not device work
        n = len(p.device)
        p.device = [d for d in p.device if not d[2].startswith(program.PREFIX)]
        seen["ranges"] = n - len(p.device)
        return p

    run.run_query, run.read_profile = traced_query, profile_and_spans
    try:
        out = run.run_cell(workload, seed, seconds, True, device, sf=sf)
    finally:
        run.run_query, run.read_profile = run_query, read_profile
    tr = Trace(calls, 0.0, 0.0, None, seen.get("pass"))
    for name, unit in METRICS:
        v = run.reader(name).read(tr)
        if v is not None:
            out["metrics"][name] = {"value": v, "unit": unit}
    kept = program.program_calls(tr)
    if kept:
        spans = sum(sum(c.program["span_n"].values()) for c in kept) / len(kept)
        names = sum(len(c.program["counters"]) for c in kept) / len(kept)
        run.log(f"[tracer] {spans:.1f} spans and {names:.1f} counter names per query over {len(kept)} queries")
    if "profile" in seen:
        run.log(f"[tracer] profiled pass: {len(seen['spans'])} spans, {seen['ranges']} of their ranges "
                f"on the device's timeline left out of its device time")
        top = program.idle_by_span(seen["profile"], seen["spans"])
        run.log("[idle-by-span] " + ", ".join(f"{n} {s:.4f} s" for n, s in top))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    work, _, _ = run.cell(run.manifest(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        run.log(f"benchmark: the cell needs {work['chips']} CUDA card(s); no CPU fallback")
        return 2
    off, on = span_cost()
    run.log(f"[tracer-cost] {off:.1f} ns per span off, {on:.1f} ns on")
    out = traced_cell(args.workload, args.seed, args.seconds, torch.device("cuda", 0))
    found = run.forbidden_modules()
    if found:
        run.log(f"benchmark: the process loaded {found}: JAX and the JAX package may not be loaded")
        return 3
    for name, c in out["checks"].items():
        run.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
