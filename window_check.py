"""Every row of the window queries' full forms against the plain reference.

    python3 window_check.py --sf 10 --seed 3210000001 [--control] [--device cuda]

Draws the TPC-H tables of ``benchmark/tpchgen.py`` on the device, loads
them into the port as the benchmark's ``tpch_sf10_dev`` configuration
does (every table in device memory), runs the full form of W1-W4 and R1
(``datafusion_tpu_torch/queries/windows.py``: every row, without the
timed form's filter, ORDER BY and LIMIT) through
``ctx.sql(text).collect()``, and holds every row to the plain reference's
``full`` (``benchmark/reference/``) on the device: the rows matched by
the columns that identify a row, the NULL masks equal, exact columns
(keys, dates, ranks, decimal money as scaled integers) equal, and the
float column within the configuration's ``float_rel_err`` of
``max(|want|, 1)``.  The benchmark's own runs compare the timed forms
only, whose 100 rows lie in the first partitions; this covers the rest.

With ``--control`` the reference computed in float32 (money and means)
stands in the port's place; it must differ.  Prints one line per query
and exits 1 when a query differs from the reference (with ``--control``:
when none does).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import ingest, reference, tpchgen
from benchmark.reference import Dec
from benchmark.reference._window import lexsort
from datafusion_tpu_torch.queries import WINDOW_QUERIES, window_sql

HERE = Path(__file__).resolve().parent
CONFIG = json.loads((HERE / "benchmark" / "configs" / "tpch_sf10_dev.json").read_text())
FLOAT_LIMIT = CONFIG["limits"]["float_rel_err"]
MODULES = {name: name.lower() for name in WINDOW_QUERIES}


def _kinds(name: str) -> dict:
    return dict(reference.module(MODULES[name]).COLUMNS)


def port_columns(table, kinds: dict) -> dict:
    """{column: (values, valid)} of the port's result: decimals as their
    scaled integers at the reference's scale, strings as numpy objects,
    the rest as int64 or float64 tensors on the table's device."""
    n = table.nrows
    out = {}
    for name, c in zip(table.names, table.columns):
        name = name.split(".")[-1]
        data, valid = c.data[:n], c.valid[:n]
        kind = kinds[name]
        if kind == "str":
            data = np.asarray(c.dictionary.decode(data.cpu().numpy()), dtype=object)
        elif kind.startswith("decimal:"):
            if c.dtype.scale != int(kind[8:]):
                raise AssertionError(f"{name}: scale {c.dtype.scale}, want {kind}")
            data = data.to(torch.int64)
        elif kind == "float":
            data = data.to(torch.float64)
        else:
            data = data.view(torch.int64) if data.dtype == torch.uint64 else data.to(torch.int64)
        out[name] = (data, valid)
    return out


def reference_columns(x, name: str) -> dict:
    """{column: (values, valid)} of the reference's full form: decimals as
    scaled integers (float64 scaled values in the control), valid masks
    all true where the module gives none."""
    m = reference.module(MODULES[name])
    cols, valids = m.full(x)
    out = {}
    for (col, kind), v, ok in zip(m.COLUMNS, cols, valids):
        if isinstance(v, Dec):
            v = v.v if v.exact else v.v.to(torch.float64) * 10 ** v.scale
        elif isinstance(v, torch.Tensor):
            v = v.to(torch.float64) if kind == "float" else v.to(torch.int64)
        n = len(v)
        if ok is None:
            ok = torch.ones(n, dtype=torch.bool, device=x.device)
        out[col] = (v, ok)
    return out


def _order(cols: dict, keys, device) -> torch.Tensor:
    """The permutation that sorts ``cols``'s rows by the ``keys`` columns
    (strings through a sorted vocabulary of their values)."""
    ks = []
    for k in keys:
        v = cols[k][0]
        if isinstance(v, np.ndarray):
            vocab = np.unique(v.astype(str))
            v = torch.from_numpy(np.searchsorted(vocab, v.astype(str))).to(device)
        ks.append(v)
    return lexsort(*ks)


def _take(v, idx: torch.Tensor):
    return v[idx.cpu().numpy()] if isinstance(v, np.ndarray) else v[idx]


def differences(got: dict, want: dict, keys, kinds: dict, device) -> tuple[dict, float]:
    """({column: rows that differ}, the widest float gap): rows matched by
    the ``keys`` columns, the NULL masks and the values where valid."""
    if list(got) != list(want):
        raise AssertionError(f"columns {list(got)}, want {list(want)}")
    n = len(want[next(iter(want))][0])
    if len(got[next(iter(got))][0]) != n:
        return {"rows": abs(len(got[next(iter(got))][0]) - n)}, 0.0
    og, ow = _order(got, keys, device), _order(want, keys, device)
    bad, err = {}, 0.0
    for col, kind in kinds.items():
        gv, gok = _take(got[col][0], og), got[col][1][og]
        wv, wok = _take(want[col][0], ow), want[col][1][ow]
        both = gok & wok
        if isinstance(wv, np.ndarray):
            differ = torch.from_numpy(gv.astype(str) != wv.astype(str)).to(device) & both
        elif kind == "float":
            gap = (gv - wv).abs() / torch.clamp(wv.abs(), min=1.0)
            gap = torch.where(both, gap, torch.zeros_like(gap))
            err = max(err, float(gap.max()) if n else 0.0)
            differ = both & ~(gap <= FLOAT_LIMIT)
        else:
            differ = both & (gv.to(wv.dtype) != wv)
        k = int((differ | (gok != wok)).sum())
        if k:
            bad[col] = k
    return bad, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    t0 = time.perf_counter()
    data = tpchgen.generate(args.sf, args.seed, dev)
    ctx = None if args.control else ingest.context(data, CONFIG, dev)
    x = reference.Inputs(data, dev)
    ctrl = reference.Inputs(data, dev, money="float32") if args.control else None
    print(f"[window-check] SF{args.sf} seed {args.seed}: tables ready in {time.perf_counter() - t0:.1f} s; "
          f"lineitem {data.nrows('lineitem')} rows", flush=True)
    failed = []
    for name in WINDOW_QUERIES:
        kinds = _kinds(name)
        t0 = time.perf_counter()
        if ctrl is None:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            got = port_columns(ctx.sql(window_sql(name, False)).collect(), kinds)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        else:
            got = reference_columns(ctrl, name)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        want = reference_columns(x, name)
        bad, err = differences(got, want, WINDOW_QUERIES[name][2], kinds, dev)
        nrows = len(want[next(iter(want))][0])
        nulls = {c: int((~ok).sum()) for c, (_, ok) in want.items() if not bool(ok.all())}
        print(f"[window-check] {name}: {nrows} rows, NULLs {nulls}; "
              f"{'control' if ctrl is not None else 'port'} {run_s:.3f} s (peak {peak} bytes); "
              f"rows that differ by column {bad}; widest float gap {err!r} (limit {FLOAT_LIMIT})", flush=True)
        if bad or err > FLOAT_LIMIT:
            failed.append(name)
        del got, want
        x.close()
        if ctrl is not None:
            ctrl.close()
    print(f"[window-check] {'differ' if failed else 'all equal'}: {failed}", flush=True)
    return int(bool(failed) == (ctrl is None))


if __name__ == "__main__":
    sys.exit(main())
