"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. Makes the TPC-H tables of the cell's configuration from ``--seed``
   (``tpchgen.py``), on the card, and loads them into an
   ``ExecutionContext`` of the port (``ingest.py``): all on the card, or
   some tables host-resident and streamed in morsels.
2. Warms every query text of the cell's mix through the same call the
   window makes, ``config["warmup_collects"]`` times each.
3. Runs one closed-loop stream of the mix: pass after pass, each a new
   permutation of the mix's queries drawn from the seed, each query
   ``ctx.sql(text).collect().to_pydict()``; the window ends with the first
   pass that ends ``--seconds`` or more after it began, so every query type
   runs equally often.  A query's latency runs from the call to
   ``ctx.sql`` to the return of ``to_pydict()``.
4. With ``--trace 1``: a synchronize after each ``collect()``, spans
   around the three calls, and ``torch.profiler`` over the second pass.
5. After the window: reads the peak device memory, frees the port's
   state, runs the plain reference (``reference/``) on the card and holds
   every result of the window with under 1,000 rows, and the larger ones
   of every fourth pass (the passes drawn from the seed), to it
   (``compare.py``); every result's row count is held to it too.
6. Prints each compared number beside its limit as the last lines of
   standard error, and one JSON line as the last line of standard output:
   the cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
   and a ``breakdown`` (``--trace 1``).

Exits non-zero, printing no result, without a CUDA card or with fewer
cards than the cell asks for, and when the process has loaded JAX or the
JAX package.  Never falls back to the CPU.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# kernel caches of the program at fixed paths inside the checkout, so only
# the first run of a cell there builds
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / ".bench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / ".bench_cache" / "torch_extensions")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import ingest, reference, tpchgen  # noqa: E402
from .compare import compare  # noqa: E402
from .trace import Call, Trace, breakdown, busy_s, read_profile  # noqa: E402

# top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "datafusion_tpu", "bench")
# results with fewer rows are all compared; larger ones in every KEEP_EVERY-th pass
SMALL_ROWS = 1000
KEEP_EVERY = 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def manifest() -> dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def cell(m: dict, workload: str) -> tuple[dict, dict, dict]:
    """(the workload's entry, its configuration file, its mix file)."""
    work = next((w for w in m["workloads"] if w["name"] == workload), None)
    if work is None:
        raise SystemExit(f"unknown workload {workload!r}; known: {[w['name'] for w in m['workloads']]}")
    config = json.loads((HERE / "configs" / f"{work['config']}.json").read_text())
    mix = json.loads((HERE / "mixes" / f"{work['traffic']}.json").read_text())
    if mix.get("streams") != 1 or mix.get("loop") != "closed":
        raise SystemExit(f"mix {work['traffic']}: this harness runs one closed-loop stream")
    return work, config, mix


def metrics_for(m: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's metrics: end-to-end without tracing, per-layer with it."""
    group = m["per_layer"] if trace else m["end_to_end"]
    return [x for x in group if workload in x.get("workloads", [workload])]


def reader(metric: str):
    """The module that reads ``metric``: ``metrics/<name>.py``, the name
    taken up to its first dot, so ``geomean_ms.host_cpu`` is read as
    ``geomean_ms`` is, in the cells it lists."""
    return importlib.import_module(f"{__package__}.metrics.{metric.split('.')[0]}")


def query_text(name: str) -> str:
    return (HERE / "queries" / f"{name}.sql").read_text()


def forbidden_modules() -> list[str]:
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_query(ctx, name: str, text: str, pass_no: int, device, traced: bool, annotate: bool):
    """One query through the port's public path; (Call, rows or None)."""
    mark = torch.profiler.record_function if annotate else (lambda _: contextlib.nullcontext())
    call = Call(name, pass_no)
    rows = None
    t0 = time.perf_counter()
    try:
        with mark(f"frontend {name}"):
            df = ctx.sql(text)
        t1 = time.perf_counter()
        with mark(f"collect {name}"):
            table = df.collect()
            if traced:
                _sync(device)
        t2 = time.perf_counter()
        with mark(f"decode {name}"):
            rows = table.to_pydict()
        t3 = time.perf_counter()
        del table
        call.frontend_s, call.collect_s, call.decode_s = t1 - t0, t2 - t1, t3 - t2
        call.latency_s = t3 - t0
        call.rows = len(next(iter(rows.values()))) if rows else 0
    except Exception as e:  # a query that raises is a failed query; the stream goes on
        call.latency_s = time.perf_counter() - t0
        call.error = f"{type(e).__name__}: {e}"
        log(f"[window] {name} raised:\n{traceback.format_exc()}")
    return call, rows


def per_query(calls: list) -> str:
    """Each query's count and median, least and greatest latency (ms)."""
    out = []
    for q in dict.fromkeys(c.query for c in calls):
        ms = sorted(1e3 * c.latency_s for c in calls if c.query == q and c.error is None)
        if ms:
            out.append(f"{q} n={len(ms)} med={ms[len(ms) // 2]:.1f} min={ms[0]:.1f} max={ms[-1]:.1f}")
    return "; ".join(out)


def window(ctx, names: list, texts: dict, seconds: float, seed_u: int, device, traced: bool):
    """The closed-loop stream; (calls, window seconds, kept results
    {query: [rows]}, the profiled pass or None, its Profile or None)."""
    rng = np.random.default_rng([seed_u, 1])
    keep_at = int(rng.integers(0, KEEP_EVERY))
    profiled = 1 if traced else None
    calls, kept, profile = [], {q: [] for q in names}, None
    start = time.perf_counter()
    p = 0
    while True:
        order = [names[i] for i in rng.permutation(len(names))]
        prof = None
        if p == profiled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        with torch.profiler.record_function("pass") if prof else contextlib.nullcontext():
            for q in order:
                call, rows = run_query(ctx, q, texts[q], p, device, traced, prof is not None)
                calls.append(call)
                if rows is not None and (call.rows < SMALL_ROWS or p % KEEP_EVERY == keep_at):
                    kept[q].append(rows)
                del rows
        if prof is not None:
            _sync(device)
            prof.__exit__(None, None, None)
            profile = prof
        p += 1
        if time.perf_counter() - start >= seconds and (profiled is None or p > profiled):
            break
    window_s = time.perf_counter() - start
    if profile is not None:
        profile = read_profile(profile, len(names))
    return calls, window_s, kept, profiled, profile


def check(calls: list, kept: dict, names: list, data, device, limits: dict) -> dict:
    """Hold the window's results to the plain reference; returns the
    compared numbers, the failed count and the reference's seconds."""
    t0 = time.perf_counter()
    inputs = reference.Inputs(data, device)
    want = {q: reference.run(q, inputs) for q in names}
    inputs.close()
    ref_s = time.perf_counter() - t0
    wrong, err, first = 0, 0.0, ""
    for q in names:
        good: list = []
        for rows in kept[q]:
            if any(rows == g for g in good):
                continue
            v = compare(rows, want[q])
            err = max(err, v.float_err)
            if v.ok and v.float_err <= limits["float_rel_err"]:
                good.append(rows)
            else:
                wrong += 1
                first = first or f"{q}: {v.reason or f'float gap {v.float_err!r}'}"
    n_want = {q: len(w.values[0]) if w.limit is None else min(w.limit, len(w.values[0]))
              for q, w in want.items()}
    for c in calls:
        if c.error is None and c.rows != n_want[c.query]:
            wrong += 1
            first = first or f"{c.query}: {c.rows} rows, want {n_want[c.query]}"
    return {"wrong_results": wrong, "float_rel_err": err, "reason": first, "reference_s": ref_s}


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "?"
    except (OSError, subprocess.TimeoutExpired):
        return "?"


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device, sf: float | None = None,
             t0: float = T0) -> dict:
    """Run one cell on ``device`` and return its result line (a dict);
    ``sf`` overrides the configuration's scale factor (tests)."""
    m = manifest()
    work, config, mix = cell(m, workload)
    names = list(dict.fromkeys(mix["queries"]))
    texts = {q: query_text(q) for q in names}
    seed_u = int(seed) % (1 << 64)
    parts = {"imports": time.perf_counter() - t0}

    t = time.perf_counter()
    data = tpchgen.generate(config["scale_factor"] if sf is None else sf, seed_u, device)
    parts["generate"] = time.perf_counter() - t
    t = time.perf_counter()
    ctx = ingest.context(data, config, device)
    _sync(device)
    parts["ingest"] = time.perf_counter() - t
    t = time.perf_counter()
    warm_failed = 0
    for q in names:
        for _ in range(config["warmup_collects"]):
            call, _rows = run_query(ctx, q, texts[q], -1, device, False, False)
            warm_failed += call.error is not None
    _sync(device)
    parts["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0
    log("[setup] " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()) + f"; setup_s {setup_s:.3f}; "
        f"rows {dict((tb, data.nrows(tb)) for tb in data.tables)}; host tables {config['host_tables']}")
    before = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0

    calls, window_s, kept, profiled, profile = window(ctx, names, texts, seconds, seed_u, device, traced)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    after = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    passes = max(c.pass_no for c in calls) + 1
    log(f"[window] {len(calls)} queries in {passes} passes, {window_s:.3f} s; device memory "
        f"allocated {before} bytes before, {after} after, peak {peak}")
    log(f"[queries] {per_query(calls)}")
    log("[passes] seconds " + " ".join(f"{sum(c.latency_s for c in calls if c.pass_no == p):.3f}"
                                       for p in range(passes)))
    del ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = check(calls, kept, names, data, device, config["limits"])
    log(f"[reference] {checks['reference_s']:.3f} s; {sum(map(len, kept.values()))} results held to it "
        f"in full, the row counts of all {len(calls)}" + (f"; first fault: {checks['reason']}"
                                                          if checks["reason"] else ""))
    failed = sum(c.error is not None for c in calls) + checks["wrong_results"]
    tr = Trace(calls, window_s, setup_s, profile, profiled)
    values = {}
    for x in metrics_for(m, workload, traced):
        v = reader(x["name"]).read(tr)
        if v is not None:
            values[x["name"]] = {"value": v, "unit": x["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": work["chips"], "memory_peak_bytes": peak}
    if profile is not None:
        dev["busy_s"], dev["window_s"] = busy_s(profile), profile.wall_s
    limits = config["limits"]
    compared = {"wrong_results": {"value": checks["wrong_results"], "limit": limits["wrong_results"]},
                "float_rel_err": {"value": checks["float_rel_err"], "limit": limits["float_rel_err"]},
                "failed_queries": {"value": failed, "limit": 0},
                "warmup_failures": {"value": warm_failed, "limit": 0}}
    correct = (failed == 0 and warm_failed == 0 and bool(calls) and checks["wrong_results"] <= limits["wrong_results"]
               and checks["float_rel_err"] <= limits["float_rel_err"])
    out = {"correct": correct, "attempted": len(calls), "failed": failed, "metrics": values, "device": dev}
    if profile is not None:
        out["breakdown"] = breakdown(profile)
    out["checks"] = compared
    if device.type == "cuda":
        log(f"[card] {card_line()}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    work, _, _ = cell(manifest(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"benchmark: the cell needs {work['chips']} CUDA card(s), {n} available; no CPU fallback")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        log(f"benchmark: the process loaded {found}: JAX and the JAX package may not be loaded")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
