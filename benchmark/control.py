"""The control of the comparison: the plain reference computed in float32
(every money value and mean; the configuration states exact decimals and
float64 means) put in the port's place, through the same check that
decides a run's ``correct``.  It must come out not correct.

    python3 -m benchmark.control --workload sf10_dev.nine --seeds 11,12,13

prints, per seed, each compared number of the check with the cell's
limit.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import reference, tpchgen
from .run import cell, check, manifest
from .trace import Call


def readings(workload: str, seed: int, device, sf: float | None = None) -> dict:
    """The check's numbers with the float32 reference's rows as the
    results of one pass of the cell's mix, at the cell's size (or ``sf``)."""
    _, config, mix = cell(manifest(), workload)
    names = list(dict.fromkeys(mix["queries"]))
    data = tpchgen.generate(config["scale_factor"] if sf is None else sf, int(seed) % (1 << 64), device)
    inputs = reference.Inputs(data, device, money="float32")
    rows = {q: reference.run(q, inputs).answer() for q in names}
    inputs.close()
    calls = [Call(q, 0, rows=len(next(iter(rows[q].values())))) for q in names]
    return check(calls, {q: [rows[q]] for q in names}, names, data, device, config["limits"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    limits = cell(manifest(), args.workload)[1]["limits"]
    for seed in map(int, args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0,
                          "wrong_results": r["wrong_results"], "float_rel_err": r["float_rel_err"],
                          "limits": limits, "first": r["reason"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
