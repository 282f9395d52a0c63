"""Compare two trees of the torch port on one CUDA card, in one call.

    python3 ab_trees.py --trees DIR_A DIR_B [--queries 3,5,9] [--sf 1]
                        [--blocks 1] [--runs 20] [--profiles 3]

Each directory holds a checkout of this repo (``git archive`` of a commit,
unpacked).  Each tree runs in a process of its own, in the order A B B A
(``--blocks`` times), so that a drift of the host's
speed hits both alike.  A process builds its tree's kernels, generates
TPC-H at ``--sf`` (seed 7), registers the eight tables on the card and,
per query: three collects (the cold run, the check, the capture of the
CUDA graph and its replay), then ``--profiles`` replays under
torch.profiler (kernel time: the device time of every kernel), then the
median of ``--runs`` warm collects decoded to rows, each ending in a
synchronize.  It prints one JSON line: per query the rows' digest, whether
a graph was captured, the kernel times, the warm median and the cold
run's peak device memory above what was allocated before it.

The last lines: the card's name and power limit, then per query and tree
the kernel times and warm medians of every process, the trees' medians of
both and B/A; the rows of both trees must be equal (exit 1 otherwise).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 7


def worker(tree: str, queries: list, sf: float, runs: int, profiles: int) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import datafusion_tpu_torch as D
    from datafusion_tpu_torch import ExecutionContext, tpchdata
    from datafusion_tpu_torch.build import build_all
    from datafusion_tpu_torch.queries import run_tpch

    if not Path(D.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {D.__file__}, not the tree {tree}")
    build_all()
    ctx = ExecutionContext()
    tpchdata.register_tpch(ctx, tpchdata.generate_tpch(sf, SEED))
    torch.cuda.synchronize()
    out = {}
    for q in queries:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rows = [run_tpch(ctx, q).to_pydict()]  # the cold run: peak memory above what was held
        torch.cuda.synchronize()
        cold_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        rows += [run_tpch(ctx, q).to_pydict() for _ in range(2)]
        if any(r != rows[0] for r in rows):
            raise AssertionError(f"Q{q}: the three collects differ")
        plans = ctx._plan_cache
        wq = getattr(plans[list(plans)[-1]], "_whole_query", None)
        kernel_ms = []
        for _ in range(profiles):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run_tpch(ctx, q).to_pydict()
                torch.cuda.synchronize()
            kernel_ms.append(sum(
                e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
            ) / 1e3)
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            run_tpch(ctx, q).to_pydict()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[q] = {
            "digest": hashlib.sha256(repr(sorted(zip(*rows[0].values()), key=repr)).encode()).hexdigest(),
            "graph": wq is not None and wq.graph is not None,
            "kernel_ms": kernel_ms,
            "warm_ms": statistics.median(times),
            "cold_peak_mib": cold_peak,
        }
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs=2, required=True)
    ap.add_argument("--queries", default="3,5,9")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--profiles", type=int, default=3)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    queries = [int(q) for q in args.queries.split(",")]
    if args.worker:
        print(json.dumps(worker(args.worker, queries, args.sf, args.runs, args.profiles)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("ab_trees: no CUDA device", file=sys.stderr)
        return 1
    trees = [str(Path(t).resolve()) for t in args.trees]
    names = {"A": trees[0], "B": trees[1]}
    results = {"A": [], "B": []}
    for _ in range(args.blocks):
        for which in ("A", "B", "B", "A"):
            cmd = [sys.executable, str(Path(__file__).resolve()), "--trees", *trees,
                   "--queries", args.queries, "--sf", str(args.sf), "--runs", str(args.runs),
                   "--profiles", str(args.profiles), "--worker", names[which]]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, capture_output=True, text=True, cwd=names[which],
                               env={**os.environ, "PYTHONPATH": str(Path(names[which]).resolve())})
            if p.returncode != 0:
                print(p.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"tree {which} ({names[which]}) failed, rc {p.returncode}")
            res = {int(q): v for q, v in json.loads(p.stdout.strip().splitlines()[-1]).items()}
            results[which].append(res)
            print(f"[ab] tree {which} ({names[which]}) ran in {time.perf_counter() - t0:.1f} s",
                  flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    same = True
    for q in queries:
        line = [f"Q{q}"]
        med = {}
        for w in ("A", "B"):
            ks = [statistics.median(r[q]["kernel_ms"]) for r in results[w]]
            ws = [r[q]["warm_ms"] for r in results[w]]
            med[w] = (statistics.median(ks), statistics.median(ws))
            line.append(f"{w}: graph {all(r[q]['graph'] for r in results[w])}, kernel ms per process "
                        f"{['%.3f' % k for k in ks]} (spread of each {[ '%.3f' % (max(r[q]['kernel_ms']) - min(r[q]['kernel_ms'])) for r in results[w]]}), "
                        f"warm ms {['%.3f' % x for x in ws]}, cold run's peak MiB above the held "
                        f"{['%.1f' % r[q]['cold_peak_mib'] for r in results[w]]}")
        digests = {r[q]["digest"] for w in ("A", "B") for r in results[w]}
        same &= len(digests) == 1
        line.append(f"B/A kernel {med['B'][0] / med['A'][0]:.3f}, warm {med['B'][1] / med['A'][1]:.3f}; "
                    f"rows {'equal' if len(digests) == 1 else 'DIFFER'}")
        print("; ".join(line), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
