"""Drive the torch port (``datafusion_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (each raises, and the script exits non-zero, on failure):
  1. device  - a CUDA card must be present; prints its name and power limit
  2. build   - compiles every kernel under datafusion_tpu_torch/csrc with
               nvcc (one process per source, all at once); prints seconds,
               ptxas' registers / shared memory / spills and the shared
               atomic opcodes of the machine code
  3. kernels - each kernel against its plain PyTorch version on the card,
               at the main path's shapes and at edge cases (K1_CASES of
               datafusion_tpu_torch/ops/smalldomain_cases.py); exact
  4. main    - TPC-H Q1 at SF1 through ExecutionContext().sql(q1).collect(),
               checked against an independent numpy oracle, with every
               kernel's launch count read around the run; then K1 at the
               main path's own inputs, exact
  5. timing  - printed, never asserted: Q1 warm medians of 5 runs, five
               times over, and their spread; a profile of one warm Q1;
               each kernel's device time alone (torch.profiler, per launch
               over many launches) and around its wrapper (CUDA events),
               beside its byte bound, its plain version and the one-call
               PyTorch yardstick; K1 alone at a few other shapes
The last two lines are the kernels JSON line and the ok JSON line.
"""

from __future__ import annotations

import collections
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from datafusion_tpu_torch import ExecutionContext
from datafusion_tpu_torch.build import BUILD_LOG, build_all, library_path
from datafusion_tpu_torch.ops import smalldomain as SD
from datafusion_tpu_torch.ops.smalldomain_cases import K1_CASES
from datafusion_tpu_torch.physical import stage_compiler
from datafusion_tpu_torch.q1data import (
    LINESTATUSES,
    RETURNFLAGS,
    generate_lineitem_q1,
    lineitem_q1_arrays,
)
from datafusion_tpu_torch.queries import get_query_sql

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SF = 1.0
SEED = 7
Q1_BATCHES = 5  # Q1 warm timing: this many medians of 5 runs, after two warm-ups
Q1_SHIPDATE_MAX = int(np.datetime64("1998-09-02", "D").astype(np.int64))


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them; every
    number the script prints carries them, so it raises without them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"nvidia-smi failed (rc {out.returncode}): {out.stderr.strip()}")
    return lines[0]


def sass_ops(name: str) -> str:
    """How often each shared-memory atomic opcode occurs in the kernel
    library's machine code (cuobjdump -sass): a 64-bit shared atomicAdd
    shows as ATOMS.CAST.SPIN.64, a compare-and-swap loop."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    if not tool.exists():
        return "cuobjdump not found"
    out = subprocess.run([str(tool), "-sass", str(library_path(name))],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        return f"cuobjdump failed (rc {out.returncode})"
    ops = collections.Counter(re.findall(r"\b(ATOMS\.[A-Z0-9.]+)", out.stdout))
    return ", ".join(f"{op} x{n}" for op, n in sorted(ops.items()))


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: K1 against its plain version
# ---------------------------------------------------------------------------


def k1_check(name, gid, cols, masks, domain) -> int:
    sums, cnts = SD.smalldomain_sum_count(gid, cols, masks, domain)
    torch.cuda.synchronize()
    ps, pc = SD.smalldomain_sum_count_plain(gid, cols, masks, domain)
    err = max(
        int((sums - ps).abs().max()) if sums.numel() else 0,
        int((cnts - pc).abs().max()) if cnts.numel() else 0,
    )
    if not (torch.equal(sums, ps) and torch.equal(cnts, pc)):
        raise AssertionError(f"K1 {name}: kernel != plain (max abs err {err})")
    log(f"[kernels] smalldomain_sum_count {name}: N={gid.shape[0]} domain={domain} "
        f"k={len(cols)} exact")
    return err


def phase_kernels() -> int:
    rng = np.random.default_rng(SEED)
    err = 0
    for name, make in K1_CASES.items():
        args = make(rng)
        err = max(err, k1_check(name, *args))
        if name == "all-dead":
            s, c = SD.smalldomain_sum_count(*args)
            if int(s.abs().sum()) or int(c.sum()):
                raise AssertionError("K1 all-dead: non-zero output")
        del args
    return err


# K1 cases timed besides Q1's inputs (cell copies 8, 2 and 2)
K1_TIMED_CASES = ("8-copies-at-limit", "2-copies", "one-group-2-copies")


# ---------------------------------------------------------------------------
# phase 4: Q1 end to end
# ---------------------------------------------------------------------------


def q1_oracle(a: dict) -> dict:
    """TPC-H Q1 over the generator's storage arrays, in numpy: exact int64
    sums per group, avgs as float64."""
    m = a["l_shipdate"] <= Q1_SHIPDATE_MAX
    g = (a["l_returnflag"][m] * len(LINESTATUSES) + a["l_linestatus"][m]).astype(np.int64)
    ng = len(RETURNFLAGS) * len(LINESTATUSES)
    qty, price = a["l_quantity"][m], a["l_extendedprice"][m]
    disc, tax = a["l_discount"][m], a["l_tax"][m]
    vals = {  # (scaled int64 values, scale)
        "sum_qty": (qty, 2),
        "sum_base_price": (price, 2),
        "sum_disc_price": (price * (100 - disc), 4),
        "sum_charge": (price * (100 - disc) * (100 + tax), 6),
        "avg_qty": (qty, 2),
        "avg_price": (price, 2),
        "avg_disc": (disc, 2),
    }
    cnt = np.zeros(ng, np.int64)
    np.add.at(cnt, g, 1)
    live = np.nonzero(cnt)[0]
    out = {
        "l_returnflag": [RETURNFLAGS[i // len(LINESTATUSES)] for i in live],
        "l_linestatus": [LINESTATUSES[i % len(LINESTATUSES)] for i in live],
    }
    for name, (v, scale) in vals.items():
        s = np.zeros(ng, np.int64)
        np.add.at(s, g, v)
        if name.startswith("avg"):
            out[name] = [int(s[i]) / 10**scale / int(cnt[i]) for i in live]
        else:
            out[name] = [int(s[i]) / 10**scale for i in live]
    out["count_order"] = [int(cnt[i]) for i in live]
    return out


def check_q1(got: dict, want: dict) -> None:
    if list(got) != list(want):
        raise AssertionError(f"Q1 columns {list(got)} != {list(want)}")
    for k, w in want.items():
        g = got[k]
        if len(g) != len(w):
            raise AssertionError(f"Q1 {k}: {len(g)} rows, want {len(w)}")
        if k.startswith("avg"):
            for x, y in zip(g, w):
                if not np.isfinite(x) or abs(x - y) > 1e-12 * abs(y):
                    raise AssertionError(f"Q1 {k}: {g} vs oracle {w} (rel 1e-12)")
        elif g != w:
            raise AssertionError(f"Q1 {k}: {g} != oracle {w}")


class Recorder:
    """Keeps the arguments of the main path's first K1 call, so that the
    timing phase runs the kernel on exactly those tensors."""

    def __init__(self, fn):
        self.fn = fn
        self.args = None

    def __call__(self, gid, cols, masks, domain):
        if self.args is None:
            self.args = (gid, list(cols), list(masks), domain)
        return self.fn(gid, cols, masks, domain)


def phase_main(sql: str):
    t0 = time.perf_counter()
    table = generate_lineitem_q1(SF, SEED)  # on the card
    ctx = ExecutionContext()  # device=None: the CUDA card
    ctx.register_table("lineitem", table)
    torch.cuda.synchronize()
    log(f"[main] lineitem SF{SF}: {table.nrows} rows, capacity {table.capacity}, "
        f"set-up {time.perf_counter() - t0:.3f} s")
    rec = Recorder(stage_compiler.smalldomain_sum_count)
    stage_compiler.smalldomain_sum_count = rec
    try:
        SD.smalldomain_sum_count.launches = 0
        t0 = time.perf_counter()
        got = ctx.sql(sql).collect().to_pydict()
        cold = time.perf_counter() - t0
        launches = SD.smalldomain_sum_count.launches
    finally:
        stage_compiler.smalldomain_sum_count = rec.fn
    if launches < 1:
        raise AssertionError("Q1 did not launch smalldomain_sum_count")
    check_q1(got, q1_oracle(lineitem_q1_arrays(SF, SEED)))
    log(f"[main] Q1 SF{SF} matches the numpy oracle (exact sums/counts, avgs rel 1e-12); "
        f"smalldomain_sum_count launches={launches}; cold run {cold * 1e3:.3f} ms")
    return ctx, launches, rec.args


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------


def k1_bound_ms(gid, cols, masks, domain) -> float:
    """The bytes K1 must move at this run's data over the HBM rate: the
    group id of every row; a mask for each live row; a value for each live
    row its mask admits; the outputs.  A tensor passed for two items (Q1's
    sum and avg of one column) is read once, so it counts once."""
    live = (gid >= 0) & (gid < domain)
    nlive = int(live.sum())
    nbytes = 4 * gid.shape[0] + 2 * domain * len(cols) * 8
    seen = set()
    for c, m in zip(cols, masks):
        if m is not None and m.data_ptr() not in seen:
            seen.add(m.data_ptr())
            nbytes += nlive
        if c is not None and c.data_ptr() not in seen:
            seen.add(c.data_ptr())
            nbytes += 8 * (nlive if m is None else int((live & m).sum()))
    return nbytes / HBM_BYTES_PER_S * 1e3


def k1_library_call(gid, cols, masks, domain):
    """index_add_ of the stacked [N, k] masked values: the one PyTorch call
    computing the same sums (its inputs are prepared outside the timing)."""
    g = torch.where((gid >= 0) & (gid < domain), gid, torch.full_like(gid, domain)).long()
    stacked = torch.stack(
        [
            torch.zeros_like(gid, dtype=torch.int64) if c is None
            else (c if m is None else torch.where(m, c, torch.zeros_like(c)))
            for c, m in zip(cols, masks)
        ],
        dim=1,
    ).contiguous()
    out = torch.zeros((domain + 1, len(cols)), dtype=torch.int64, device=gid.device)
    return lambda: out.zero_().index_add_(0, g, stacked)


def kernel_only_ms(fn, kernel: str, iters: int = 200, tries: int = 3):
    """The device time of the kernel named ``kernel`` alone, per launch,
    from torch.profiler over ``iters`` calls of ``fn`` (after one warm-up):
    the wrapper's allocation, fill and host overhead are left out.  The
    profiler may drop a few kernel records; a window in which it kept
    fewer than 95 % of them is measured again, up to ``tries`` windows.
    Returns (ms, the launches it kept)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
        kept = sum(e.count for e in evs)
        if kept > iters:
            raise AssertionError(f"profiler saw {kept} launches of {kernel} in {iters} calls")
        if kept >= 0.95 * iters:
            return sum(e.self_device_time_total for e in evs) / 1e3 / kept, kept
        log(f"[timing] profiler kept {kept} of {iters} launches of {kernel}; measuring again")
    raise AssertionError(f"profiler kept under 95 % of {iters} launches of {kernel} "
                         f"in {tries} windows")


def profile_q1(ctx, sql: str, name_power: str) -> None:
    """Where one warm Q1 run spends device time, by operator."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctx.sql(sql).collect().to_pydict()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = list(prof.key_averages())
    # kernels are the events that ran on the card; the host-side operator
    # events repeat their kernels' device time
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] {name_power}: one warm Q1 (profiled) {wall:.3f} ms wall, "
        f"{busy:.3f} ms kernel time, device idle share {1 - busy / wall:.1%}")
    ops = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    for e in sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        if e.self_device_time_total <= 0:
            break
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms device  "
            f"{e.count:4d} calls  {e.key[:60]}")
    log(f"[profile]   {len(kernels)} distinct kernels, "
        f"{sum(e.count for e in kernels)} launches")


def time_k1_cases(name_power: str, kname: str) -> None:
    """K1 alone at shapes with fewer cell copies than Q1's 32: many slots,
    and all rows in one slot of 256 (the most contention), beside their
    byte bounds and the library call."""
    rng = np.random.default_rng(SEED)
    for name in K1_TIMED_CASES:
        args = K1_CASES[name](rng)
        ms, kept = kernel_only_ms(lambda: SD.smalldomain_sum_count(*args), kname)
        bound_ms = k1_bound_ms(*args)
        library_ms = cuda_ms(k1_library_call(*args), 5)
        log(f"[shapes] {name_power}: smalldomain_sum_count {name} (N={args[0].shape[0]}, "
            f"domain={args[3]}, k={len(args[1])}): {ms:.4f} ms kernel alone ({kept} of 200 "
            f"launches), byte bound {bound_ms:.4f} ms ({bound_ms / ms:.1%} of bound), "
            f"index_add_ {library_ms:.4f} ms")
        del args


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    name_power = card()
    log(f"[device] {name_power}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    secs = build_all()
    for k, s in secs.items():
        log(f"[build] {k}: {s:.3f} s")
        for line in BUILD_LOG.get(k, "").splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
        log(f"[build]   SASS: {sass_ops(k)}")

    err = phase_kernels()

    sql = get_query_sql(1)
    ctx, launches, args = phase_main(sql)
    err = max(err, k1_check("q1-main-path-inputs", *args))

    runs = []
    for i in range(2 + 5 * Q1_BATCHES):
        t0 = time.perf_counter()
        ctx.sql(sql).collect().to_pydict()
        torch.cuda.synchronize()
        if i >= 2:  # two warm-ups
            runs.append((time.perf_counter() - t0) * 1e3)
    medians = [statistics.median(runs[i : i + 5]) for i in range(0, len(runs), 5)]
    log(f"[timing] {name_power}: Q1 SF{SF} warm median {statistics.median(runs):.3f} ms over "
        f"{len(runs)} runs (min {min(runs):.3f}, max {max(runs):.3f}); medians of 5 runs "
        f"{['%.3f' % m for m in medians]}; runs {['%.3f' % r for r in runs]}")

    profile_q1(ctx, sql, name_power)

    kname = "smalldomain_sum_count_kernel"
    bound_ms = k1_bound_ms(*args)
    shape = f"N={args[0].shape[0]}, domain={args[3]}, k={len(args[1])}"
    ms, kept = kernel_only_ms(lambda: SD.smalldomain_sum_count(*args), kname, 400)
    wrapper_ms = cuda_ms(lambda: SD.smalldomain_sum_count(*args), 200)
    plain_ms = cuda_ms(lambda: SD.smalldomain_sum_count_plain(*args), 3)
    library_ms = cuda_ms(k1_library_call(*args), 5)
    log(f"[timing] {name_power}: smalldomain_sum_count at Q1 SF1 ({shape}): {ms:.4f} ms "
        f"kernel alone (torch.profiler, {kept} of 400 launches), {wrapper_ms:.4f} ms around the wrapper "
        f"(CUDA events, 200 calls); byte bound {bound_ms:.4f} ms ({bound_ms / ms:.1%} of bound); "
        f"plain {plain_ms:.4f} ms; index_add_ {library_ms:.4f} ms")
    time_k1_cases(name_power, kname)

    kernels = [{
        "name": "smalldomain_sum_count",
        "route": "cuda",
        "source": "datafusion_tpu_torch/csrc/smalldomain_sum_count.cu",
        "replaces": "datafusion_tpu/ops/pallas_kernels.py:167",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "ms_launches_kept": kept,
        "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "checked_against_plain": True,
    }]
    print(name_power)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
