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
  3b. take   - K2 (datafusion_tpu_torch/ops/take.py) at the column sets
               it moves in TPC-H at SF10 (Q7's widest join side, Q21's pair
               table, a stage's compaction of 2^26 rows), each with a
               monotone and a random index: bit for bit against its plain
               version on the card, then its time alone beside its byte
               bound (a source larger than L2 costs a 32-byte sector for
               each row read in a new sector, one that fits costs at most
               its size) and the per-column PyTorch form it replaced.
               Every later phase counts K2's launches per path, as K1's
               (the count set to 0 before each path's run, the launches
               of a graph's replay read by the profiler), and every phase
               that collects on the card must launch it; on the main path
               (Q1) and at SF10 device-resident K2 is held against its
               plain version, bit for bit, at the inputs of every call
               it makes
  4. main    - TPC-H Q1 at SF1 through ExecutionContext().sql(q1).collect(),
               four times: the cold run (node by node, learning
               capacities), the check (the speculative path with host
               reads refused), the capture of one CUDA graph with its
               first replay, and one replay under torch.profiler (printed
               with its top device ops); each against an independent numpy
               oracle.  K1's launches: the wrapper's count read around the
               four runs, plus the launches of K1 the profiler saw in the
               last replay, which must equal the calls the capture
               recorded; then K1 at the cold run's inputs and at the
               captured graph's, exact
               (datafusion_tpu_torch/physical/query_compiler.py)
  5. timing  - printed, never asserted: Q1 warm medians of 5 runs (graph
               replays), five times over, and their spread;
               each kernel's device time alone (torch.profiler, per launch
               over many launches) and around its wrapper (CUDA events),
               beside its byte bound, its plain version and the one-call
               PyTorch yardstick; K1 alone at a few other shapes
  6. sql     - the lineitem-only queries of datafusion_tpu_torch/queries
               (NAMED_QUERIES) at SF1 on the ten-column lineitem: the cold
               run, the check and the graph's replay each against a numpy
               oracle (keys, counts and decimal sums exact, floats rel
               1e-12); the plans the port on the CPU makes one unit (its
               CPU twins, at SF 0.1) must capture a graph; the path from
               K1's launch count (only `linenumber` takes the small-domain
               path); K1 against its plain version, exact, at the inputs of
               the cold run and of the capture; per query, printed: whether
               a graph was captured or which node read the host, warm
               medians of three paths in turns (graph replays; eager, with
               DFTPU_NO_WHOLE_QUERY set; exact, speculation off), kernel
               time and device idle share of one profiled replay (K1's
               launches in it must equal the capture's calls) and of one
               eager run, host syncs per warm run, the graph's growth of
               the shared graph pool and peak device memory; the top device
               ops of an eager q18_bigorders; the memory the pool holds
  7. f4      - the card's float64 sqrt against numpy's over 10^6 values,
               and a grouped stddev against the numpy oracle
  8. tpch    - the 22 TPC-H queries over the eight tables of
               datafusion_tpu_torch/tpchdata.py, through run_tpch: at SF 0.1
               each query's rows on the card equal the port's on the CPU
               over the same host arrays (keys, counts and decimals exact,
               floats rel 1e-12; in order where FULLY_ORDERED says so, else
               as multisets) in the cold run and three warm runs, K1 is
               launched by exactly the queries whose CPU run calls it
               (TPCH_K1_QUERIES), and the card captures a graph exactly
               where the CPU twin becomes one unit; at SF1 the generated
               tables must have the digests of the expected file
               (tests/data/torch_tpch_sf1_seed7.json.gz, the JAX package's
               rows at SF1, seed 7; datafusion_tpu_torch/queries/
               expected.py), and per query the cold run, the check, the
               replay and one collect each of the eager and the exact path
               must give the file's rows (exact columns exact, floats rel
               1e-12), the replay the check's rows too (Q3, Q12 and Q18
               also against numpy oracles), K1's
               path in the cold run and in the replay, and as in the sql
               phase: graph or guard message, warm medians of the three
               paths in turns (two rounds instead of four once the loop has
               run TPCH_BUDGET_S seconds), profiled replay and eager run,
               host syncs per warm run, pool and peak memory, each join's
               candidate pairs, and how many times one eager collect
               executes each node that shared-subtree deduplication marked
               (Q15's revenue0 view: once, or the phase fails); then the
               memory the shared graph pool holds with every graph, and
               after a table is registered again (which releases the
               cached plans' graphs); then the top device ops of an eager
               run of the join query with the most kernel time.  K1 is held
               against its plain version at every call's inputs, captured
               ones included
  9. window  - the window and rolling-window queries of
               datafusion_tpu_torch/queries/windows.py (the window shapes
               of TPC-DS Q67/Q70, Q51, Q47/Q57 and a RANGE offset frame,
               and a 7-day rolling sum) over the TPC-H tables: at SF 0.1
               (inside phase 8's check) each query's full and timed forms
               on the card equal the CPU's in three collects; at SF1 the
               full form against a numpy oracle (its peak memory printed),
               the timed form in the cold run, the check and the capture
               against the oracle's rows, a graph where the CPU twin is
               one unit (W1-W3 must capture), and as in the tpch phase:
               warm medians of three paths, syncs, decode, a profiled
               replay and eager run (its top ops), peak memory
 10. morsel  - TPC-H Q1 over a host-resident lineitem at SF10 (60,012,150
               rows pinned in host memory, streamed in 58 morsels of 2^20
               rows, datafusion_tpu_torch/datasource/host.py and
               physical/morsel.py): every collect against the numpy oracle
               and the same rows device-resident; K1 launched once per
               morsel, and held against its plain version at the first
               and the last (partial) morsel's inputs; warm collect times
               beside the device-resident table's graph, bytes uploaded
               and their rate beside a plain pinned copy of the same
               bytes, host syncs per collect and per morsel, a profiled
               collect's idle share and top device ops, pin and staging
               times, peak memory
 11. morsel-tpch - the 22 TPC-H queries at SF1 with lineitem
               host-resident against the device-resident tables and the
               expected file, in the cold run and 3 warm runs: rows
               equal; per query streamed or materialized, morsels, K1
               launches and warm eager ms
 12. files   - SF1 lineitem written as a '|'-delimited .tbl file and read
               by register_csv with a schema through the native loader
               (asserted), Q1 and Q6 against the device-resident rows; a
               Parquet round trip (device-resident and with morsel_rows=,
               the row groups Q6's filter prunes) where pyarrow is
               installed, else a line saying it did not run
 13. mesh    - run after phase 9, on its SF1 tables: the 22 TPC-H queries
               over make_mesh(8), eight logical shards on the card
               (datafusion_tpu_torch/parallel, run_tpch(ctx, q, mesh=)):
               each query cold and in three warm runs, strict (0
               fallbacks), against phase 8's single-device eager rows (Q1
               also against the numpy oracle), the cold and the last warm
               run against the expected file, K1 launched 0 times; per
               query its node modes (mesh, broadcast, gather), exchange
               bytes, cold and warm times beside the single-device eager
               median, peak memory and host syncs per run; the query with
               the most mesh time profiled (kernel time, idle share, top
               device ops, the exchanges' share of kernel time); Q1's and
               Q3's collect_partitioned(mesh=) against their collect; Q1
               over lineitem in host memory sharded by from_host (never
               materialized whole; against the expected file too).  One
               card: NVLink and several cards are not exercised
 14. distributed - run after phase 13, on phase 8's SF1 tables and
               single-device eager rows, alone (no other collect runs
               beside the executor threads): the Ballista TPC-H set (Q1,
               Q3, Q5, Q6, Q10, Q12; benchmarks/run.sh:22-26) through
               DistributedContext(num_executors=2, target_partitions=4)
               on the card (datafusion_tpu_torch/distributed), cold and
               in three warm runs, each against the single-device rows
               and the expected file (Q1 also against the numpy oracle),
               as is every run below; K1 launched once per
               scan task in every Q1 run and held against its plain
               version at one task's inputs; per query the stages and
               tasks, cold and warm ms beside the single-device eager
               median, spill bytes written and read, the seconds of the
               stage subtrees, of the device-to-host copies with the file
               writes, of the file reads with the host-to-device copies,
               of the final read, the executors' poll sleeps, and peak
               memory; the query with the most time profiled (idle share,
               top ops); Q1 and Q3 at target_partitions=16 (Ballista's
               shuffle.partitions default); Q1 and Q3 through a scheduler
               subprocess that sees no card and two executor subprocesses
               on the card over rpc.py, the tables in a spill directory;
               Q3 again through two executors with --mesh-devices 4
 15. cli     - run after phase 12, on its SF1 lineitem .tbl rewritten as a
               CSV: `python -m datafusion_tpu_torch.cli --format json -f`
               a script that registers it with CREATE EXTERNAL TABLE and
               runs Q1 and Q6, as a subprocess on the card; its JSON lines
               equal the same statements' output in this process
 16. sf10    - run last: bench/sf_check.py's configuration, TPC-H Q1, Q3,
               Q5, Q6, Q7, Q9, Q10, Q12 and Q18 at SF10 (seed 7) against
               the JAX package's rows (tests/data/torch_tpch_sf10_seed7
               .json.gz, written by tests/torch_expected_sf10.py): the
               generated tables must have the file's digests; then with
               lineitem and orders pinned in host memory and streamed in
               morsels of 2^20 rows, each query cold and in 2 warm
               collects, each against the file, its plan streaming and
               materializing the host tables as the JAX package's plan
               does, K1 once per morsel in Q1 and Q12 and held against its
               plain version at the first and last morsel's inputs; per
               query the scans, morsels, K1 launches, warm median, host
               syncs and peak memory per collect; then, after that
               context is released, all eight tables on the card: per
               query the cold run, the check, the capture and first replay
               and one eager and one exact collect against the file, K1 at
               every call's inputs (captured ones included), graph or
               guard, warm medians of the three paths, syncs, decode, pool
               and peak memory; K1 timed at Q1's N = 2^26 inputs beside its
               byte bound; the card's peak and the phase's seconds
Each phase prints its seconds ([phase] lines).  The [expected] lines, after
phase 15 and in phase 16, count the results that matched each expected
file, by path (each path must have compared every query it runs), and give
the file's sha256 and the checks' seconds.  The last two lines are the
kernels JSON line and the ok JSON line.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import hashlib
import io
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from datafusion_tpu_torch import ExecutionContext, tpchdata, tracing
from datafusion_tpu_torch.build import BUILD_LOG, build_all, library_path
from datafusion_tpu_torch.columnar.table import HOST_SYNCS
from datafusion_tpu_torch.cli import print_result
from datafusion_tpu_torch.datasource.host import HostTable
from datafusion_tpu_torch.device import capturing
from datafusion_tpu_torch.distributed import DistributedContext, TableStore, serde, shuffle_io
from datafusion_tpu_torch.distributed import exchange as X
from datafusion_tpu_torch.distributed.rpc import RpcSchedulerClient
from datafusion_tpu_torch.ops import aggregate
from datafusion_tpu_torch.ops import kernels as K
from datafusion_tpu_torch.ops import smalldomain as SD
from datafusion_tpu_torch.ops import take as TK
from datafusion_tpu_torch.ops.join import HashJoinExec
from datafusion_tpu_torch.ops.smalldomain_cases import K1_CASES
from datafusion_tpu_torch.parallel.collectives import EXCHANGE_RANGE
from datafusion_tpu_torch.parallel.executor import SpmdExecutor
from datafusion_tpu_torch.parallel.mesh import make_mesh
from datafusion_tpu_torch.physical import query_compiler as QC
from datafusion_tpu_torch.q1data import (
    LINESTATUSES,
    RETURNFLAGS,
    generate_lineitem,
    generate_lineitem_q1,
    lineitem_arrays,
    lineitem_q1_arrays,
)
from datafusion_tpu_torch.queries import (
    FULLY_ORDERED,
    WINDOW_QUERIES,
    NAMED_QUERIES,
    get_named_query,
    get_query_sql,
    run_tpch,
    run_tpch_spmd,
    window_sql,
)
from datafusion_tpu_torch.queries import expected

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SF = 1.0
SEED = 7
Q1_BATCHES = 5  # Q1 warm timing: this many medians of 5 runs, after two warm-ups
SQL_BATCHES = 4  # sql phase: rounds of 5 runs per path (graph, eager, exact)
TWIN_SF = 0.1  # the scale of the CPU twins that say which plans must capture
Q1_SHIPDATE_MAX = int(np.datetime64("1998-09-02", "D").astype(np.int64))
EPOCH = datetime.date(1970, 1, 1)
ROOT = Path(__file__).resolve().parent  # the subprocesses import the port from here
# the JAX package's rows of the 22 TPC-H queries at SF1, seed 7
# (tests/torch_expected_sf1.py writes it)
EXPECTED_FILE = ROOT / "tests" / "data" / "torch_tpch_sf1_seed7.json.gz"


def log(msg: str) -> None:
    print(msg, flush=True)


# K2's launches per path (TakeRecorder adds to it), as K1's are kept, and
# the sum of a phase's paths (phase_done)
K2_BY_PATH: dict = {}
K2_BY_PHASE: dict = {}
K2_CHECKED: dict = {}  # per path, the calls held against the plain version


def phase_done(name: str, t0: float) -> float:
    """Print a phase's seconds and K2's launches on its paths; returns the
    time the next phase starts."""
    now = time.perf_counter()
    K2_BY_PHASE[name] = sum(K2_BY_PATH.values()) - sum(K2_BY_PHASE.values())
    log(f"[phase] {name}: {now - t0:.3f} s; K2 launched {K2_BY_PHASE[name]} times on its paths")
    return now


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


# ---------------------------------------------------------------------------
# phase 3b: K2 at SF10's shapes
# ---------------------------------------------------------------------------

# (source rows, output rows, int64 columns, int32 columns, row mask, outer
# index): the column sets the port moves in TPC-H at SF10
K2_SHAPES = {
    # Q7's widest join output side: the probe's accumulated columns at li[sel]
    "q7-join-side": (1 << 25, 1 << 25, 11, 2, True, True),
    # Q21's residual filter: lineitem's four columns at each candidate pair
    "q21-pair-table": (1 << 26, 1 << 26, 2, 2, False, False),
    # a stage's compaction of 2^26 lineitem rows (Q3's, Q7's first stages)
    "compaction-2^26": (1 << 26, 1 << 26, 4, 1, True, False),
}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (a NaN equals the same NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def k2_inputs(shape, order: str, seed: int):
    """A K2 call at ``shape`` (K2_SHAPES) with a ``monotone`` index (a
    compaction's stable partition, a probe side's rows) or a ``random``
    one (a build side's rows), made on the card."""
    cap, n, n64, n32, masked, outer = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    datas = tuple(torch.randint(-(1 << 62), 1 << 62, (cap,), generator=g, device=dev) for _ in range(n64))
    datas += tuple(torch.randint(-(1 << 30), 1 << 30, (cap,), generator=g, device=dev,
                                 dtype=torch.int32) for _ in range(n32))
    valids = tuple(torch.rand(cap, generator=g, device=dev) > 0.1 for _ in datas)
    if order == "monotone":
        keep = torch.rand(cap, generator=g, device=dev) > 0.5
        idx = torch.cat([keep.nonzero()[:, 0], (~keep).nonzero()[:, 0]])[:n]
    else:
        idx = torch.randint(0, cap, (n,), generator=g, device=dev)
    sel = torch.sort(torch.randint(0, n, (n,), generator=g, device=dev)).values if outer else None
    mask = torch.arange(n, device=dev) < (n * 3) // 4 if masked else None
    return datas, valids, idx, mask, sel


def k2_bound_ms(datas, valids, idx, mask, sel) -> float:
    """The least bytes K2's work needs from HBM, over the HBM rate: the
    index, the row mask, each output row, and each source's rows read.  A
    source larger than L2 costs the 32-byte sectors a reader in output
    order fetches: a row in the sector of the row before it costs nothing
    more, any other its sectors (a scattered row costs a whole sector,
    rising rows their bytes).  A source that fits in L2 costs at most its
    size, read once: an order that reads it alone keeps it resident.  The
    outer index's reads of the index count the same way."""
    n = (idx if sel is None else sel).shape[0]
    j = torch.clamp(idx if sel is None else idx[sel], min=0)
    l2 = torch.cuda.get_device_properties(idx.device).L2_cache_size

    def read(t: torch.Tensor, stride: int, width: int, at: torch.Tensor) -> int:
        start = t.data_ptr() % 32 + at * stride
        first, last = start // 32, (start + width - 1) // 32
        fresh = torch.ones_like(first, dtype=torch.bool)
        fresh[1:] = (first[1:] != last[:-1]) & (first[1:] != first[:-1])
        sectors = 32 * int((fresh * (last - first + 1)).sum())
        size = (t.shape[0] - 1) * stride + width  # the source's bytes
        return min(sectors, size) if size <= l2 else sectors

    nbytes = 8 * n
    if sel is not None:
        nbytes += read(idx, 8, 8, sel)
    if mask is not None:
        nbytes += n
    for t in datas + valids:
        width = t.element_size() * math.prod(t.shape[1:])
        nbytes += read(t, t.stride(0) * t.element_size(), width, j) + n * width
    return nbytes / HBM_BYTES_PER_S * 1e3


def k2_equal(label: str, args, got) -> None:
    """K2's outputs ``got`` at ``args`` against the plain version's, bit
    for bit; the card's sync guard is lifted for the comparison (a
    whole-query check refuses host reads)."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        want = TK.take_plain(*args)
        bad = [i for i, (a, b) in enumerate(zip(got[0] + got[1], want[0] + want[1])) if not same_bits(a, b)]
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    if bad or len(got[0]) != len(want[0]) or len(got[1]) != len(want[1]):
        raise AssertionError(f"K2 {label}: outputs {bad} differ from the plain version")


def k2_launches(args) -> int:
    """The launches K2 makes for one call at ``args`` (the wrapper splits
    a table into launches of up to MAX_ITEMS buffers)."""
    datas, valids, idx, _, sel = args
    n = (idx if sel is None else sel).shape[0]
    items = len(datas) + len(valids)
    return -(-items // TK.MAX_ITEMS) if n and items else 0


class TakeRecorder:
    """Wraps ``K.take``, the route to K2 of every site that moves rows, for
    the runs of one path: K2's launch count is set to 0 on entry and added
    to ``K2_BY_PATH[path]`` on exit (a graph's replay runs K2 without the
    wrapper and adds nothing).  With ``check``, every call is held against
    the plain version bit for bit at its own inputs: at once outside a
    capture, where the comparison adds a sync and the plain version's
    buffers to the run; a call that a capture records is kept in
    ``captured`` (its buffers then stay out of the graph pool's reuse) and
    checked by ``check_captured`` after the graph's replay, when its
    tensors hold the replay's values."""

    def __init__(self, path: str, check: bool = False):
        self.path, self.check = path, check
        self.calls = self.checked = self.launches = self.recorded = 0
        self.captured = []

    def __enter__(self):
        self.fn, K.take = K.take, self
        TK.take.launches = 0
        return self

    def __exit__(self, *exc):
        K.take = self.fn
        self.launches = TK.take.launches
        K2_BY_PATH[self.path] = K2_BY_PATH.get(self.path, 0) + self.launches
        return False

    def __call__(self, datas, valids, idx, mask=None, sel=None):
        out = self.fn(datas, valids, idx, mask, sel)
        args = (tuple(datas), tuple(valids), idx, mask, sel)
        self.calls += 1
        if capturing():
            self.recorded += k2_launches(args)
            if self.check:
                self.captured.append(args)
        elif self.check:
            k2_equal(f"{self.path} call {self.calls}", args, out)
            self.checked += 1
            K2_CHECKED[self.path] = K2_CHECKED.get(self.path, 0) + 1
        return out

    def check_captured(self) -> int:
        """Each call the capture recorded, at its inputs now, against the
        plain version; returns how many."""
        n = len(self.captured)
        for i, args in enumerate(self.captured):
            k2_equal(f"{self.path} captured call {i}", args, self.fn(*args))
        self.checked += n
        K2_CHECKED[self.path] = K2_CHECKED.get(self.path, 0) + n
        self.captured = []
        return n


def phase_take(name_power: str) -> dict:
    """K2 at SF10's shapes (K2_SHAPES), with monotone and random indices:
    bit for bit against its plain version on the card, then alone
    (torch.profiler) beside its byte bound and the per-column PyTorch form
    it replaced (``take_plain``: an index kernel per buffer, the clamp, an
    AND per mask)."""
    timing = {}
    for name, shape in K2_SHAPES.items():
        for order in ("monotone", "random"):
            args = k2_inputs(shape, order, SEED)
            k2_equal(f"{name} {order}", args, TK.take(*args))
            items = len(args[0]) + len(args[1])
            ms, kept = kernel_only_ms(lambda: TK.take(*args), "take_kernel", 20)
            row = {"n": shape[1], "items": items, "ms": ms, "launches_kept": kept,
                   "bound_ms": k2_bound_ms(*args), "library_ms": cuda_ms(lambda: TK.take_plain(*args), 3)}
            timing[f"{name}-{order}"] = row
            log(f"[take] {name_power}: {name} {order} (n={row['n']}, {items} buffers"
                f"{', outer index' if args[4] is not None else ''}{', row mask' if args[3] is not None else ''}): "
                f"{ms:.4f} ms kernel alone ({kept} of 20 launches), byte bound {row['bound_ms']:.4f} ms "
                f"({row['bound_ms'] / ms:.1%} of bound); per-column PyTorch {row['library_ms']:.4f} ms "
                f"({row['library_ms'] / ms:.2f}x); bit for bit equal")
            del args
            torch.cuda.empty_cache()
    return timing


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
    cnt = np.bincount(g, minlength=ng)
    live = np.nonzero(cnt)[0]
    out = {
        "l_returnflag": [RETURNFLAGS[i // len(LINESTATUSES)] for i in live],
        "l_linestatus": [LINESTATUSES[i % len(LINESTATUSES)] for i in live],
    }
    # each group's rows once (a stable sort), then exact int64 sums per run
    order = np.argsort(g, kind="stable")
    starts = np.r_[0, np.cumsum(cnt)[:-1]][live]
    for name, (v, scale) in vals.items():
        s = np.zeros(ng, np.int64)
        s[live] = np.add.reduceat(v[order], starts)
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
    """Keeps the arguments of every K1 call a path makes, so that the
    kernel is held against its plain version, and timed, on exactly those
    tensors; ``args`` are the first call's."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    @property
    def args(self):
        return self.calls[0] if self.calls else None

    def __call__(self, gid, cols, masks, domain):
        self.calls.append((gid, list(cols), list(masks), domain))
        return self.fn(gid, cols, masks, domain)


def last_plan(ctx):
    """The physical plan ``ctx`` ran last."""
    plans = ctx._plan_cache
    return plans[list(plans)[-1]]


def whole_query(ctx):
    """The whole-query state of the plan ``ctx`` ran last
    (physical/query_compiler.py), or None."""
    return getattr(last_plan(ctx), "_whole_query", None) if ctx._plan_cache else None


def graph_state(wq) -> str:
    if wq is None:
        return "no whole-query state"
    if wq.graph is not None:
        return (f"CUDA graph captured, the shared pool grew by {wq.pool_growth / 2**20:.1f} MiB in its "
                f"capture and holds {QC.pool_bytes(wq.device) / 2**20:.1f} MiB")
    if wq.failure is None:
        return "not captured"
    return f"not captured ({wq.failure[0]}: {wq.failure[1]})"


def graphs_held(ctx) -> str:
    """The shared pool of the CUDA graphs of ``ctx``'s cached plans, beside
    the sum of what each capture grew it by (what pools of their own would
    have held at least)."""
    wqs = [getattr(p, "_whole_query", None) for p in ctx._plan_cache.values()]
    wqs = [w for w in wqs if w is not None and w.graph is not None]
    grown = sum(w.pool_growth for w in wqs)
    return (f"{len(wqs)} graphs held; their shared pool holds "
            f"{QC.pool_bytes(ctx.device) / 2**20:.1f} MiB; their captures grew it by "
            f"{grown / 2**20:.1f} MiB in all")


def require_capture(label: str, wq) -> None:
    """A plan the CPU twin makes one unit must capture a graph; a failure
    other than the guard's fails the script either way."""
    if wq is not None and wq.failure is not None and wq.failure[0] != "guard":
        raise AssertionError(f"{label}: the whole-query build failed outside the guard: {wq.failure}")
    if wq is None or wq.graph is None:
        raise AssertionError(f"{label}: the CPU twin becomes one unit, the card captured no graph "
                             f"({graph_state(wq)})")


@contextlib.contextmanager
def path(variant: str):
    """Run the context's collects as ``graph`` (the default: warm plans
    replay a CUDA graph), ``eager`` (DFTPU_NO_WHOLE_QUERY set: the
    speculative path node by node) or ``exact`` (speculation off: the exact
    path with its host reads)."""
    if variant == "eager":
        os.environ["DFTPU_NO_WHOLE_QUERY"] = "1"
    elif variant == "exact":
        K.SPECULATION.enabled = False
    try:
        yield
    finally:
        os.environ.pop("DFTPU_NO_WHOLE_QUERY", None)
        K.SPECULATION.enabled = True


PATHS = ("graph", "eager", "exact")


def warm_paths(run, batches: int) -> dict:
    """Milliseconds of warm calls of ``run`` on each path: ``batches``
    rounds, each a batch of 5 runs (after one untimed run) per path, the
    paths in turns (forward, then backward) so that drift of the host's
    speed hits them alike; every run ends in a synchronize."""
    runs = {p: [] for p in PATHS}
    for b in range(batches):
        for p in PATHS if b % 2 == 0 else PATHS[::-1]:
            with path(p):
                for i in range(6):
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    if i:
                        runs[p].append((time.perf_counter() - t0) * 1e3)
    return runs


def medians(runs: dict) -> str:
    return "; ".join(f"{p} {statistics.median(r):.3f} ms (5-run medians "
                     f"{['%.3f' % statistics.median(r[i:i + 5]) for i in range(0, len(r), 5)]})"
                     for p, r in runs.items())


def warm_syncs(run_collect, decode) -> tuple:
    """Host syncs of one warm collect, and of decoding its result."""
    s0 = HOST_SYNCS[0]
    out = run_collect()
    s1 = HOST_SYNCS[0]
    decode(out)
    return s1 - s0, HOST_SYNCS[0] - s1


def decode_ms(run_collect) -> float:
    """Median milliseconds of ``to_pydict()`` over one collected result
    (its row count read first): the host's share of a warm run that no
    graph removes."""
    t = run_collect()
    torch.cuda.synchronize()
    t.nrows
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        t.to_pydict()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_main(sql: str, name_power: str):
    """Q1 through collect(): the cold run (node by node, learning), the
    check (the speculative path, guarded), the capture of its CUDA graph
    with one replay, and one more replay under torch.profiler; every run
    against the numpy oracle.  K1's launches: the wrapper's count around
    all four (the cold run and the check launch it; a capture records
    it), plus the launches the profiler saw in the last replay, which must
    equal what the capture recorded."""
    t0 = time.perf_counter()
    table = generate_lineitem_q1(SF, SEED)  # on the card
    ctx = ExecutionContext()  # device=None: the CUDA card
    ctx.register_table("lineitem", table)
    torch.cuda.synchronize()
    log(f"[main] lineitem SF{SF}: {table.nrows} rows, capacity {table.capacity}, "
        f"set-up {time.perf_counter() - t0:.3f} s")
    want = q1_oracle(lineitem_q1_arrays(SF, SEED))
    rec = Recorder(aggregate.smalldomain_sum_count)
    aggregate.smalldomain_sum_count = rec
    times, rows, per_run, k2 = [], [], [], []
    try:
        SD.smalldomain_sum_count.launches = 0
        for _ in range(3):
            before = SD.smalldomain_sum_count.launches
            t0 = time.perf_counter()
            with TakeRecorder("q1", check=True) as k2_run:
                rows.append(ctx.sql(sql).collect().to_pydict())
            times.append((time.perf_counter() - t0) * 1e3)
            per_run.append(SD.smalldomain_sum_count.launches - before)
            k2.append(k2_run)
        k2[2].check_captured()
        got = {}
        prof = profiled_replay(lambda: got.update(ctx.sql(sql).collect().to_pydict()), "Q1",
                               len(rec.calls) - sum(per_run), k2_recorded=k2[2].recorded)
        rows.append(got)
        launches = SD.smalldomain_sum_count.launches + prof["k1_launches"]
        K2_BY_PATH["q1"] += prof["k2_launches"]
    finally:
        aggregate.smalldomain_sum_count = rec.fn
    for got in rows:
        check_q1(got, want)
    wq = whole_query(ctx)
    require_capture("Q1", wq)
    if per_run != [1, 1, 0] or len(rec.calls) != 3 or prof["k1_launches"] != 1:
        raise AssertionError(f"Q1: K1 launches per run {per_run} (cold, check, capture), "
                             f"{len(rec.calls)} calls, {prof['k1_launches']} in the profiled "
                             f"replay; want 1, 1, 0, three calls (one recorded) and 1")
    k2_runs = [r.launches for r in k2]
    if not (k2_runs[0] and k2_runs[1]) or k2_runs[2] or not k2[2].recorded \
            or any(r.checked != r.calls for r in k2):
        raise AssertionError(f"Q1: K2 launches per run {k2_runs} (cold, check, capture), "
                             f"{k2[2].recorded} recorded by the capture, calls {[r.calls for r in k2]}, "
                             f"checked {[r.checked for r in k2]}; want launches in the cold run and "
                             f"the check, none in the capture, and every call checked")
    log(f"[main] Q1 SF{SF}: the cold run, the check, the captured graph's replay and one more "
        f"replay match the numpy oracle (exact sums/counts, avgs rel 1e-12); {graph_state(wq)}; "
        f"smalldomain_sum_count launches={launches}: {per_run[0]} in the cold run, {per_run[1]} in "
        f"the check, {len(rec.calls) - sum(per_run)} recorded by the capture, "
        f"{prof['k1_launches']} run by the profiled replay (the capture's own replay is not "
        f"counted); take launches={K2_BY_PATH['q1']}: {k2_runs[0]} in the cold run, {k2_runs[1]} in "
        f"the check, {k2[2].recorded} recorded by the capture, {prof['k2_launches']} run by the "
        f"profiled replay; K2 equal to its plain version bit for bit at all {K2_CHECKED['q1']} calls' "
        f"inputs (the captured ones after the replay); runs {['%.3f' % t for t in times]} ms (K2's "
        f"checks inside the first two)")
    log(f"[profile] {name_power}: one warm Q1 replay (profiled) {prof['profiled_wall_ms']:.3f} ms wall, "
        f"{prof['kernel_ms']:.3f} ms kernel time in {prof['launches']} launches, device idle share "
        f"{prof['idle_share']:.1%}")
    for line in prof["top"]:
        log(f"[profile]   {line}")
    return ctx, launches, rec.calls[0], rec.calls[2]


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


def profile_run(run, top: int = 15) -> dict:
    """Where one call of ``run`` spends device time, under torch.profiler:
    wall and kernel time, launches, idle share and the ``top`` operators by
    device time, as printable lines."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = list(prof.key_averages())
    # kernels are the events that ran on the card; the host-side operator
    # events repeat their kernels' device time
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = sorted((e for e in events if e.device_type != torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.self_device_time_total, reverse=True)
    lines = [f"{e.self_device_time_total / 1e3:9.3f} ms device  {e.count:5d} calls  {e.key[:60]}"
             for e in ops[:top] if e.self_device_time_total > 0]
    lines.append(f"{len(kernels)} distinct kernels, {sum(e.count for e in kernels)} launches")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top_kernels = [f"{e.self_device_time_total / 1e3:9.3f} ms device  {e.count:5d} launches  {e.key[:70]}"
                   for e in kernels[:top]]
    return {"profiled_wall_ms": wall, "kernel_ms": busy, "idle_share": 1 - busy / wall,
            "launches": sum(e.count for e in kernels), "top": lines, "top_kernels": top_kernels,
            "kernel_counts": {e.key: e.count for e in kernels}}


K1_KERNEL = "smalldomain_sum_count_kernel"
K2_KERNEL = "take_kernel"


def profiled_replay(run, label: str, recorded: int, tries: int = 3, k2_recorded: int | None = None) -> dict:
    """One warm call of ``run`` (a replay of a captured graph) under
    torch.profiler (``profile_run``), with K1's launches counted among the
    kernels the card ran: they must equal the ``recorded`` K1 calls of the
    capture; K2's likewise, where ``k2_recorded`` gives the launches the
    capture recorded.  The profiler may drop a kernel record, so a replay
    that shows fewer is profiled again, up to ``tries`` times; one that
    shows more fails at once.  The dict gains ``k1_launches`` (and
    ``k2_launches``)."""
    want = {"K1": (K1_KERNEL, recorded)}
    if k2_recorded is not None:
        want["K2"] = (K2_KERNEL, k2_recorded)
    for _ in range(tries):
        prof = profile_run(run)
        seen = {k: sum(n for key, n in prof["kernel_counts"].items() if kernel in key)
                for k, (kernel, _) in want.items()}
        for k, (_, n) in want.items():
            if seen[k] > n:
                raise AssertionError(f"{label}: the replay ran {k} {seen[k]} times, the capture "
                                     f"recorded {n} launches")
        if all(seen[k] == n for k, (_, n) in want.items()):
            prof["k1_launches"] = seen["K1"]
            if "K2" in seen:
                prof["k2_launches"] = seen["K2"]
            return prof
        log(f"[profile] {label}: the profiler kept {seen} of the launches the graph holds "
            f"({ {k: n for k, (_, n) in want.items()} }); profiling again")
    raise AssertionError(f"{label}: {seen} launches in each of {tries} profiled replays, the "
                         f"capture recorded { {k: n for k, (_, n) in want.items()} }")


def profile_query(ctx, sql: str, label: str, name_power: str, top: int = 12) -> dict:
    """One warm run of ``sql`` profiled (``profile_run``), printed with its
    ``top`` operators."""
    prof = profile_run(lambda: ctx.sql(sql).collect().to_pydict(), top)
    log(f"[profile] {name_power}: one warm {label} (profiled) {prof['profiled_wall_ms']:.3f} ms wall, "
        f"{prof['kernel_ms']:.3f} ms kernel time, device idle share {prof['idle_share']:.1%}")
    if top:
        for line in prof["top"]:
            log(f"[profile]   {line}")
    return prof


def warm_runs(run, batches: int) -> list:
    """Milliseconds of ``batches`` * 5 warm calls of ``run``, after two
    warm-ups, each ending in a synchronize."""
    runs = []
    for i in range(2 + 5 * batches):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        if i >= 2:
            runs.append((time.perf_counter() - t0) * 1e3)
    return runs


def spread(runs: list) -> str:
    medians = [statistics.median(runs[i : i + 5]) for i in range(0, len(runs), 5)]
    return (f"warm median {statistics.median(runs):.3f} ms over {len(runs)} runs "
            f"(min {min(runs):.3f}, max {max(runs):.3f}); medians of 5 runs "
            f"{['%.3f' % m for m in medians]}")


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


# ---------------------------------------------------------------------------
# phase 6: the lineitem-only queries
# ---------------------------------------------------------------------------


def _days(iso: str) -> int:
    return int(np.datetime64(iso, "D").astype(np.int64))


def _grouped_int_sums(keys, vals):
    """(sorted distinct keys, exact int64 sum of vals per key)."""
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inv, vals)
    return uniq, sums


def sql_oracles(a: dict) -> dict:
    """Each named query over the generator's storage arrays, in numpy:
    decimals as exact scaled int64 sums, returned as to_pydict gives them
    (the int over 10**scale); dates as datetime.date; avgs as float64."""
    qty, price, disc = a["l_quantity"], a["l_extendedprice"], a["l_discount"]
    ship, ln, supp = a["l_shipdate"], a["l_linenumber"], a["l_suppkey"]
    out = {}

    m = ((ship >= _days("1994-01-01")) & (ship < _days("1995-01-01"))
         & (disc / 100 >= 0.06 - 0.01) & (disc / 100 <= 0.06 + 0.01) & (qty < 2400))
    out["q6"] = {"revenue": [int((price[m] * disc[m]).sum()) / 10**4]}

    m = (ship >= _days("1996-01-01")) & (ship < _days("1996-04-01"))
    keys, sums = _grouped_int_sums(supp[m], price[m] * (100 - disc[m]))
    out["q15_revenue"] = {"supplier_no": keys.tolist(),
                          "total_revenue": [int(v) / 10**4 for v in sums]}

    okey = a["l_orderkey"]  # rows come in order-key order
    starts = np.flatnonzero(np.r_[True, okey[1:] != okey[:-1]])
    sums = np.add.reduceat(qty, starts)
    big = sums > 300 * 100
    out["q18_bigorders"] = {"l_orderkey": okey[starts][big].tolist(),
                            "sum_qty": [int(v) / 100 for v in sums[big]]}

    lines = np.unique(ln).tolist()
    cols = {"l_linenumber": lines, "count_lines": [], "sum_qty": [], "avg_price": [],
            "first_ship": [], "max_disc": []}
    for v in lines:
        sel = ln == v
        n = int(sel.sum())
        cols["count_lines"].append(n)
        cols["sum_qty"].append(int(qty[sel].sum()) / 100)
        cols["avg_price"].append(int(price[sel].sum()) / 100 / n)
        cols["first_ship"].append(EPOCH + datetime.timedelta(days=int(ship[sel].min())))
        cols["max_disc"].append(int(disc[sel].max()) / 100)
    out["linenumber"] = cols

    pairs = np.unique(ln.astype(np.int64) << 32 | supp)
    keys, counts = np.unique(pairs >> 32, return_counts=True)
    out["distinct_supp"] = {"l_linenumber": keys.tolist(), "suppliers": counts.tolist()}

    m = np.isin(ln, (1, 2, 3))
    year = ship[m].astype("datetime64[D]").astype("datetime64[Y]").astype(np.int64) + 1970
    returned = np.where(a["l_returnflag"][m] == RETURNFLAGS.index("R"),
                        price[m] * (100 - disc[m]), 0)
    keys, sums = _grouped_int_sums(year, returned)
    _, counts = np.unique(year, return_counts=True)
    out["exprs"] = {"l_year": keys.tolist(), "returned_revenue": [int(v) / 10**4 for v in sums],
                    "lines": counts.tolist()}
    return out


# the float columns of the named queries (rel 1e-12); every other column
# is compared exactly
SQL_FLOAT_COLS = {"avg_price"}
# queries without ORDER BY: rows are compared in the order of this key
SQL_UNORDERED_KEY = {"q15_revenue": "supplier_no", "q18_bigorders": "l_orderkey",
                     "distinct_supp": "l_linenumber"}


def check_rows(name: str, got: dict, want: dict, float_cols=()) -> None:
    if list(got) != list(want):
        raise AssertionError(f"{name}: columns {list(got)} != {list(want)}")
    key = SQL_UNORDERED_KEY.get(name)
    if key is not None:
        order = sorted(range(len(got[key])), key=lambda i: got[key][i])
        got = {k: [v[i] for i in order] for k, v in got.items()}
    for k, w in want.items():
        g = got[k]
        if len(g) != len(w):
            raise AssertionError(f"{name} {k}: {len(g)} rows, want {len(w)}")
        if k in float_cols:
            bad = [(x, y) for x, y in zip(g, w) if not abs(x - y) <= 1e-12 * abs(y)]
        else:
            bad = [(x, y) for x, y in zip(g, w) if x != y]
        if bad:
            raise AssertionError(f"{name} {k}: {len(bad)} rows differ from the oracle, e.g. {bad[:3]}")


# queries whose GROUP BY takes the small-domain path, and so launch K1
SQL_K1_QUERIES = {"linenumber"}


def sql_twins() -> dict:
    """Which named queries the port on the CPU makes one unit (three
    collects over the lineitem at SF 0.1): the card must capture those."""
    ctx = ExecutionContext(device="cpu")
    ctx.register_table("lineitem", generate_lineitem(TWIN_SF, SEED, device="cpu"))
    out = {}
    for name in NAMED_QUERIES:
        for _ in range(3):
            ctx.sql(get_named_query(name)).collect()
        out[name] = whole_query(ctx).is_program
    return out


def phase_sql(name_power: str):
    """The named queries on the card at SF1: the cold run, the check and
    the captured graph's replay against the oracle; the path from K1's
    launch count; K1 against its plain version at the inputs the cold run
    and the capture handed it; warm medians of the three paths (graph,
    eager, exact) in turns; one profiled replay (kernel time, idle share,
    K1 inside it); host syncs per warm run; the graph's pool and peak
    memory.  Returns K1's launches per query (the three runs), its max abs
    error and the names of the inputs it was checked at."""
    t0 = time.perf_counter()
    twins = sql_twins()
    arrays = lineitem_arrays(SF, SEED)
    want = sql_oracles(arrays)
    table = generate_lineitem(SF, SEED)  # on the card
    ctx = ExecutionContext()
    ctx.register_table("lineitem", table)
    torch.cuda.synchronize()
    table_mb = sum(c.data.nbytes + c.valid.nbytes for c in table.columns) / 2**20
    log(f"[sql] lineitem SF{SF}: {table.nrows} rows x {len(table.columns)} columns, capacity "
        f"{table.capacity}, {table_mb:.1f} MiB on the card; CPU twins at SF{TWIN_SF}, oracles and "
        f"set-up {time.perf_counter() - t0:.3f} s; {torch.cuda.memory_allocated() / 2**20:.1f} MiB "
        f"allocated in all; one unit on the CPU: {[n for n, p in twins.items() if p]}")
    launches, err, checked = {}, 0, []
    for name in NAMED_QUERIES:
        sql = get_named_query(name)
        rec = Recorder(aggregate.smalldomain_sum_count)
        aggregate.smalldomain_sum_count = rec
        per_run, rows, secs, calls, k2 = [], [], [], [], []
        try:
            SD.smalldomain_sum_count.launches = 0
            for _ in range(3):  # cold, check, capture + replay
                before, ncalls = SD.smalldomain_sum_count.launches, len(rec.calls)
                t0 = time.perf_counter()
                with TakeRecorder(name) as k2_run:
                    rows.append(ctx.sql(sql).collect().to_pydict())
                secs.append((time.perf_counter() - t0) * 1e3)
                per_run.append(SD.smalldomain_sum_count.launches - before)
                calls.append(rec.calls[ncalls:])
                k2.append(k2_run)
            launches[name] = SD.smalldomain_sum_count.launches
        finally:
            aggregate.smalldomain_sum_count = rec.fn
        for got in rows:
            check_rows(name, got, want[name], SQL_FLOAT_COLS)
        wq = whole_query(ctx)
        if twins[name]:
            require_capture(name, wq)
        k1 = name in SQL_K1_QUERIES
        recorded = len(calls[2]) - per_run[2]  # the capture's calls, not launches
        if any((n > 0) != k1 for n in (per_run[0], per_run[1], recorded)) or per_run[2]:
            raise AssertionError(f"{name}: K1 launched {per_run} times (cold, check, capture), "
                                 f"{recorded} calls recorded by the capture; the "
                                 f"{'small-domain' if k1 else 'sort'} path should call it "
                                 f"{'once in each' if k1 else 'never'}, the capture launch none")
        for label, run_calls in (("inputs", calls[0]), ("captured-inputs", calls[2])):
            for i, args in enumerate(run_calls):
                checked.append(f"{name}-{label}-{i}")
                err = max(err, k1_check(checked[-1], *args))
        del rec, calls
        runs = warm_paths(lambda: ctx.sql(sql).collect().to_pydict(), SQL_BATCHES)
        syncs = warm_syncs(lambda: ctx.sql(sql).collect(), lambda t: t.to_pydict())
        dec = decode_ms(lambda: ctx.sql(sql).collect())
        base_mb = torch.cuda.memory_allocated() / 2**20
        torch.cuda.reset_peak_memory_stats()
        ctx.sql(sql).collect().to_pydict()
        torch.cuda.synchronize()
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        prof = profiled_replay(lambda: ctx.sql(sql).collect().to_pydict(), name, recorded,
                               k2_recorded=sum(r.recorded for r in k2))
        launches[name] += prof["k1_launches"]
        K2_BY_PATH[name] += prof["k2_launches"]
        with path("eager"):
            eager = profile_query(ctx, sql, name + " eager", name_power,
                                  top=12 if name == "q18_bigorders" else 0)
        log(f"[sql] {name_power}: {name} SF{SF} matches the numpy oracle ({len(rows[0][next(iter(rows[0]))])} "
            f"rows) in the cold run, the check and the replay; {graph_state(wq)}; K1 launches {per_run} "
            f"(cold, check, capture), {recorded} recorded by the capture, {prof['k1_launches']} run by "
            f"the profiled replay; K2 launches {[r.launches for r in k2]}, {sum(r.recorded for r in k2)} "
            f"recorded by the capture, {prof['k2_launches']} run by the profiled replay; "
            f"runs {['%.3f' % t for t in secs]} ms; {medians(runs)}; profiled replay: kernel time "
            f"{prof['kernel_ms']:.3f} ms in {prof['launches']} launches, device idle share "
            f"{prof['idle_share']:.1%}; profiled eager run: {eager['kernel_ms']:.3f} ms in "
            f"{eager['launches']} launches, idle {eager['idle_share']:.1%}; host syncs per warm run "
            f"{syncs[0]} (+{syncs[1]} to decode the result); decode {dec:.3f} ms; peak memory {peak_mb:.1f} MiB "
            f"({peak_mb - base_mb:.1f} MiB above the {base_mb:.1f} MiB allocated before the run, the "
            f"table's {table_mb:.1f} MiB among them)")
    log(f"[memory] {name_power}: sql phase, {graphs_held(ctx)}")
    del ctx, table
    torch.cuda.empty_cache()
    return launches, err, checked


# ---------------------------------------------------------------------------
# phase 7: fault F4 (float64 sqrt) on the card
# ---------------------------------------------------------------------------


def phase_f4(name_power: str) -> None:
    rng = np.random.default_rng(SEED)
    x = np.concatenate([[8.0, 2.0, 3.0, 0.5], rng.random(400_000) * 1e4,
                        rng.random(300_000), np.exp(rng.normal(0, 20, 299_996))])
    want = np.sqrt(x)
    got = torch.sqrt(torch.from_numpy(x).cuda()).cpu().numpy()
    differ = int((got != want).sum())
    ulps = float(np.max(np.abs(got - want) / np.spacing(want)))
    log(f"[f4] {name_power}: torch.sqrt on the card (float64) differs from numpy's correctly "
        f"rounded sqrt in {differ} of {len(x)} values (max {ulps:.0f} ulp); "
        f"sqrt(8.0) = {got[0]!r} (numpy {want[0]!r})")
    a = lineitem_arrays(SF, SEED)
    ctx = ExecutionContext()
    ctx.register_table("lineitem", generate_lineitem(SF, SEED))
    sql = ("SELECT l_linenumber, stddev(l_quantity) AS sd FROM lineitem "
           "GROUP BY l_linenumber ORDER BY l_linenumber")
    got = ctx.sql(sql).collect().to_pydict()
    lines = np.unique(a["l_linenumber"])
    want = [float(np.std(a["l_quantity"][a["l_linenumber"] == v] / 100, ddof=1)) for v in lines]
    if got["l_linenumber"] != lines.tolist():
        raise AssertionError(f"f4 stddev: keys {got['l_linenumber']} != {lines.tolist()}")
    rel = max(abs(g - w) / w for g, w in zip(got["sd"], want))
    if not rel <= 1e-12:
        raise AssertionError(f"f4 stddev: max rel err {rel:.3e} > 1e-12: {got['sd']} vs {want}")
    log(f"[f4] {name_power}: grouped stddev(l_quantity) at SF{SF} matches the numpy oracle, "
        f"max rel err {rel:.3e}")


# ---------------------------------------------------------------------------
# phase 8: the 22 TPC-H queries over the eight tables
# ---------------------------------------------------------------------------

TPCH_CHECK_SF = 0.1
# SF1 timing: this many rounds of 5 runs per path (warm_paths); once the
# SF1 loop has run TPCH_BUDGET_S seconds, TPCH_SHORT_BATCHES for the rest
TPCH_BATCHES = 4
TPCH_SHORT_BATCHES = 2
TPCH_BUDGET_S = 300.0
# the queries whose GROUP BY takes the small-domain path at SF 0.1 and SF1,
# and so launch K1: string keys of small dictionaries (Q1's flags, Q4's
# o_orderpriority, Q5's n_name, Q12's l_shipmode, Q22's country codes).  At
# SF 0.01 Q15's l_suppkey spans 10 values and Q21's s_name dictionary holds
# 100, under the domain limit of 256; at SF 0.1 they span 1,000.  The CPU
# tests hold the port's path to the JAX package's at SF 0.01; here the card's
# path is held to the CPU's at SF 0.1 and to this set at both scales.
TPCH_K1_QUERIES = {1, 4, 5, 12, 22}
TPCH_QUERIES = range(1, 23)
TPCH_JOINLESS = {1, 6}
TPCH_REL = 1e-12


def tpch_rows(got: dict) -> list:
    return list(zip(*got.values()))


def _same(x, y) -> bool:
    if isinstance(y, float) and isinstance(x, float):
        return x == y or (x != x and y != y) or abs(x - y) <= TPCH_REL * abs(y)
    return x == y


def _row_key(row) -> tuple:
    return tuple((v is None, f"{v:.9g}" if isinstance(v, float) else v) for v in row)


def check_tpch(label: str, got: dict, want: list, ordered: bool, order_spec=None) -> None:
    """Rows equal: keys, counts and decimals exactly, floats within rel
    1e-12; in order where ``ordered``, else as multisets.  With an
    ``order_spec`` [(column, descending)] the rows are compared as multisets
    and must be in that order (ties among equal sort keys are the engine's)."""
    rows = tpch_rows(got)
    if len(rows) != len(want):
        raise AssertionError(f"{label}: {len(rows)} rows, want {len(want)}")
    if order_spec:
        expected.check_order(label, rows, order_spec)
        ordered = False
    if not ordered:
        rows, want = sorted(rows, key=_row_key), sorted(want, key=_row_key)
    for i, (r, w) in enumerate(zip(rows, want)):
        if len(r) != len(w) or not all(_same(x, y) for x, y in zip(r, w)):
            raise AssertionError(f"{label}: row {i} {r} != {w}")


class ExpectedRows:
    """The JAX package's rows of TPC-H queries at one SF (``path``: the SF1
    file of the 22 queries, or the SF10 file of sf_check's nine;
    datafusion_tpu_torch/queries/expected.py) and the comparisons made
    with them: per path, the queries compared and how many times, and the
    seconds the checks took."""

    def __init__(self, path: Path = EXPECTED_FILE):
        t0 = time.perf_counter()
        self.path = path
        self.sha256 = hashlib.sha256(path.read_bytes()).hexdigest()
        self.doc = expected.load(path)
        self.sf = self.doc["sf"]
        expected.check_texts(self.doc, get_query_sql)
        self.queries = collections.defaultdict(set)
        self.count = collections.Counter()
        self.tables_checked = False
        self.seconds = time.perf_counter() - t0

    def check_tables(self, data: dict) -> None:
        """The generated tables must be the ones the file's rows come from."""
        t0 = time.perf_counter()
        expected.check_tables(data, self.doc)
        self.tables_checked = True
        self.seconds += time.perf_counter() - t0

    def check(self, where: str, q: int, got: dict) -> None:
        """Query q's rows on path ``where`` (a to_pydict()) equal the file's,
        under its column names and kinds, or this raises."""
        t0 = time.perf_counter()
        expected.compare(f"Q{q} SF{self.sf:g} {where} vs the JAX package's rows", got,
                         self.doc["queries"][str(q)])
        self.queries[where].add(q)
        self.count[where] += 1
        self.seconds += time.perf_counter() - t0

    def require(self, paths: dict) -> None:
        """Every path of ``paths`` ({path: queries}) compared every query."""
        if not self.tables_checked:
            raise AssertionError(f"the generated SF{self.sf:g} tables were never checked against the file")
        missing = {p: sorted(set(qs) - self.queries.get(p, set())) for p, qs in paths.items()}
        missing = {p: qs for p, qs in missing.items() if qs}
        if missing:
            raise AssertionError(f"queries never compared with the expected file, by path: {missing}")

    def line(self, name_power: str) -> str:
        return (f"[expected] {name_power}: the SF{self.sf:g} tables generated on this machine have the "
                f"file's digests ({sum(len(c) for c in self.doc['tables'].values())} columns of "
                f"{len(self.doc['tables'])} tables, numpy {np.__version__} here, "
                f"{self.doc['versions']['numpy']} for the file); {sum(self.count.values())} results "
                f"matched the file, {sum(len(qs) for qs in self.queries.values())} (path, query) pairs "
                f"over {len(self.queries)} paths: "
                f"{ {p: f'{len(self.queries[p])} queries, {self.count[p]} runs' for p in self.queries} }; "
                f"file {self.path.relative_to(ROOT)} sha256 {self.sha256}; the checks took "
                f"{self.seconds:.3f} s")


def _dec(x) -> np.ndarray:
    """A decimal(15,2) column of the generator as the loader stores it."""
    return np.round(np.asarray(x) * 100).astype(np.int64)


def _date(days: int) -> datetime.date:
    return EPOCH + datetime.timedelta(days=int(days))


def tpch_oracles(d: dict) -> dict:
    """Q3, Q12 and Q18 over the generator's arrays, in numpy, as row lists.
    The generator's keys are dense: order row i has o_orderkey 4i + 1 and
    customer row c has c_custkey c + 1, so each join is index arithmetic."""
    li, o, c = d["lineitem"], d["orders"], d["customer"]
    oidx = (li["l_orderkey"] - 1) // 4  # each line's order row
    price, disc, qty = _dec(li["l_extendedprice"]), _dec(li["l_discount"]), _dec(li["l_quantity"])
    out = {}

    cut = _days("1995-03-15")
    building = c["c_mktsegment"] == "BUILDING"
    order_ok = (o["o_orderdate"] < cut) & building[o["o_custkey"] - 1]
    m = (li["l_shipdate"] > cut) & order_ok[oidx]
    keys, sums = _grouped_int_sums(li["l_orderkey"][m], price[m] * (100 - disc[m]))
    rows = (keys - 1) // 4
    out[3] = [(int(k), int(s) / 10**4, _date(o["o_orderdate"][r]), int(o["o_shippriority"][r]))
              for k, s, r in zip(keys, sums, rows)]

    m = (np.isin(li["l_shipmode"], ["MAIL", "SHIP"]) & (li["l_commitdate"] < li["l_receiptdate"])
         & (li["l_shipdate"] < li["l_commitdate"]) & (li["l_receiptdate"] >= _days("1994-01-01"))
         & (li["l_receiptdate"] < _days("1995-01-01")))
    high = np.isin(o["o_orderpriority"][oidx[m]], ["1-URGENT", "2-HIGH"])
    modes = li["l_shipmode"][m]
    out[12] = [(mode, int((high & (modes == mode)).sum()), int((~high & (modes == mode)).sum()))
               for mode in sorted(set(modes))]

    okey = li["l_orderkey"]  # lines come in order-key order
    starts = np.flatnonzero(np.r_[True, okey[1:] != okey[:-1]])
    sums = np.add.reduceat(qty, starts)
    big = sums > 300 * 100
    keys = okey[starts][big]
    rows = (keys - 1) // 4
    cust = o["o_custkey"][rows]
    out[18] = [(c["c_name"][k - 1], int(k), int(ok), _date(o["o_orderdate"][r]),
                int(p) / 100, int(s) / 100)
               for k, ok, r, p, s in zip(cust, keys, rows, _dec(o["o_totalprice"])[rows], sums[big])]
    return out


# ORDER BY of the oracle-checked queries (Q18's too, though it compares as
# a multiset in the JAX package's benchmark)
TPCH_ORACLE_ORDER = {3: [(1, True), (2, False)], 12: [(0, False)], 18: [(4, True), (3, False)]}


def run_recorded(ctx, q: int, take: "TakeRecorder | None" = None):
    """One run of query q with every K1 call recorded and K1's launch count
    read around it: (rows, launches, recorder, seconds); with ``take``,
    K2's calls are recorded around it too."""
    rec = Recorder(aggregate.smalldomain_sum_count)
    aggregate.smalldomain_sum_count = rec
    try:
        SD.smalldomain_sum_count.launches = 0
        t0 = time.perf_counter()
        with take if take is not None else contextlib.nullcontext():
            got = run_tpch(ctx, q).to_pydict()
        secs = time.perf_counter() - t0
        launches = SD.smalldomain_sum_count.launches
    finally:
        aggregate.smalldomain_sum_count = rec.fn
    if launches and not rec.calls:
        raise AssertionError(f"Q{q}: K1 launched outside the stage compiler's call")
    return got, launches, rec, secs


def join_candidates(ctx, q: int) -> list:
    """Run query q once through its physical plan and read each join's
    candidate pairs (``join_candidates``) and type, in plan order."""
    out = []
    stmts = [s for s in get_query_sql(q).split(";") if s.strip()]
    for stmt in stmts:
        low = stmt.lower()
        if "create view" in low or "drop view" in low:
            ctx.sql(stmt)
            continue
        plan = ctx.create_physical_plan(ctx.optimize(ctx.create_logical_plan(stmt)))
        plan.execute()
        stack = [plan]
        while stack:
            node = stack.pop()
            if isinstance(node, HashJoinExec):
                out.append((node.join_type, node.metrics.counter("join_candidates").value))
            stack.extend(reversed(node.children()))
    return out


def shared_executions(ctx, q: int) -> list:
    """How many times one eager collect of query q executes each node that
    shared-subtree deduplication marked (physical/dedup.py): once each, or
    the check fails (Q15's revenue0 view)."""
    seen, stack, shared = set(), [last_plan(ctx)], []
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if getattr(node, "_dedup_shared", False):
            shared.append(node)
        stack.extend(node.children())
    before = [n.metrics.counter("executions").value for n in shared]
    with path("eager"):
        run_tpch(ctx, q).to_pydict()
    out = [(n._display_line(), n.metrics.counter("executions").value - b) for n, b in zip(shared, before)]
    if any(k != 1 for _, k in out):
        raise AssertionError(f"Q{q}: shared nodes executed {out} times in one collect, want once each")
    return out


def tpch_check(name_power: str) -> tuple:
    """SF 0.1: every query on the card against the port on the CPU over the
    same host arrays, with K1's path on the card held to the CPU's and K1
    against its plain version at each call's inputs; then three more
    collects on each device (the check, the capture and replay, a replay):
    the card captures a graph exactly where the CPU twin becomes one unit,
    and every replay gives the CPU's rows."""
    t0 = time.perf_counter()
    data = tpchdata.generate_tpch(TPCH_CHECK_SF, SEED)
    cpu, gpu = ExecutionContext(device="cpu"), ExecutionContext()
    tpchdata.register_tpch(cpu, data)
    tpchdata.register_tpch(gpu, data)
    log(f"[tpch] SF{TPCH_CHECK_SF}: {data['lineitem']['l_orderkey'].shape[0]} lineitem rows; "
        f"generated and registered on the card and the CPU in {time.perf_counter() - t0:.3f} s")
    err, checked, twins = 0, [], {}
    for q in TPCH_QUERIES:
        label = f"Q{q} SF{TPCH_CHECK_SF}"
        want, _, crec, csecs = run_recorded(cpu, q)
        for _ in range(3):
            run_tpch(cpu, q)
        twins[q] = whole_query(cpu).is_program
        got, launches, rec, gsecs = run_recorded(gpu, q)
        check_tpch(f"{label} card vs CPU", got, tpch_rows(want), q in FULLY_ORDERED)
        if (launches > 0) != bool(crec.calls) or (launches > 0) != (q in TPCH_K1_QUERIES):
            raise AssertionError(f"{label}: K1 launched {launches} times on the card; "
                                 f"the CPU run called it {len(crec.calls)} times")
        for i, args in enumerate(rec.calls):
            checked.append(f"tpch-q{q}-sf{TPCH_CHECK_SF}-inputs-{i}")
            err = max(err, k1_check(checked[-1], *args))
        for i in range(3):
            check_tpch(f"{label} warm run {i + 2} card vs CPU", run_tpch(gpu, q).to_pydict(),
                       tpch_rows(want), q in FULLY_ORDERED)
        wq = whole_query(gpu)
        if twins[q]:
            require_capture(label, wq)
        elif wq.graph is not None:
            raise AssertionError(f"{label}: the card captured a graph where the CPU twin runs node "
                                 f"by node ({whole_query(cpu).failure})")
        log(f"[tpch] {name_power}: {label} on the card equals the CPU "
            f"({len(tpch_rows(got))} rows, {'in order' if q in FULLY_ORDERED else 'as multisets'}) "
            f"in the cold run, the check and two replays; K1 launches {launches}; cold run card "
            f"{gsecs * 1e3:.3f} ms, CPU {csecs * 1e3:.3f} ms; CPU twin "
            f"{'one unit' if twins[q] else 'node by node: ' + str(whole_query(cpu).failure)}; "
            f"card {graph_state(wq)}")
    wtwins = window_check(cpu, gpu)
    del cpu, gpu
    torch.cuda.empty_cache()
    return err, checked, twins, wtwins


def phase_tpch(name_power: str, exp: ExpectedRows):
    """The 22 TPC-H queries: checked at SF 0.1 against the CPU (and their
    CPU twins), then at SF1 on the card, per query: the cold run, the check
    and the captured graph's replay (Q3, Q12 and Q18 against numpy oracles;
    the replay against the check's rows), K1's path and its inputs in the
    cold run and in the capture, warm medians of the three paths in turns,
    a profiled replay (K1 inside it) and a profiled eager run, host syncs
    per warm run, the graph's pool, peak memory and each join's candidates;
    the top device ops of the eager run of the join query with the most
    kernel time.  Returns K1's launches per query at SF1 (cold run and
    replay), its max abs error, the names of the inputs it was checked at,
    the SF1 context, per query the check's (single-device eager) rows and
    the eager path's warm median in ms, and Q1's numpy oracle (for the mesh
    phase).  The generated tables must have the expected file's digests,
    and the cold run, the check, the replay and one collect each of the
    eager and the exact path must give the file's rows (``exp``)."""
    err, checked, twins, wtwins = tpch_check(name_power)
    t0 = time.perf_counter()
    data = tpchdata.generate_tpch(SF, SEED)
    exp.check_tables(data)
    oracles = tpch_oracles(data)
    woracles = window_oracles(data)
    q1_want = tpch_q1_oracle(data["lineitem"])
    ctx = ExecutionContext()
    tpchdata.register_tpch(ctx, data)
    torch.cuda.synchronize()
    del data
    tables_mb = 0.0
    for name in ctx.tables():
        t = ctx.table(name).collect()
        tables_mb += sum(c.data.nbytes + c.valid.nbytes for c in t.columns) / 2**20
        del t
    log(f"[tpch] SF{SF}: eight tables, {tables_mb:.1f} MiB of column buffers on the card; "
        f"generated, oracles and registered in {time.perf_counter() - t0:.3f} s")
    launches, tops, single = {}, {}, {}
    loop0 = time.perf_counter()
    for q in TPCH_QUERIES:
        label = f"Q{q} SF{SF}"
        syncs0 = HOST_SYNCS[0]
        k2 = [TakeRecorder(f"tpch-q{q}") for _ in range(3)]  # cold, check, capture
        got, launches[f"tpch-q{q}"], rec, cold = run_recorded(ctx, q, k2[0])
        cold_syncs = HOST_SYNCS[0] - syncs0
        nrows = len(tpch_rows(got))
        if nrows == 0:
            raise AssertionError(f"{label}: no rows")
        if q in oracles:
            check_tpch(f"{label} vs numpy oracle", got, oracles[q], True, TPCH_ORACLE_ORDER[q])
        exp.check("cold", q, got)
        k1 = q in TPCH_K1_QUERIES
        if (launches[f"tpch-q{q}"] > 0) != k1:
            raise AssertionError(f"{label}: K1 launched {launches[f'tpch-q{q}']} times")
        for i, args in enumerate(rec.calls):
            checked.append(f"tpch-q{q}-sf{SF:g}-inputs-{i}")
            err = max(err, k1_check(checked[-1], *args))
        del rec
        eager_rows, _, _, check_secs = run_recorded(ctx, q, k2[1])
        single[q] = [tpch_rows(eager_rows), None]
        exp.check("check", q, eager_rows)
        replay_rows, glaunches, grec, capture_secs = run_recorded(ctx, q, k2[2])
        exp.check("replay", q, replay_rows)
        wq = whole_query(ctx)
        if twins[q]:
            require_capture(label, wq)
        check_tpch(f"{label} replay vs the check's eager rows", replay_rows, tpch_rows(eager_rows),
                   q in FULLY_ORDERED)
        if q in oracles:
            check_tpch(f"{label} replay vs numpy oracle", replay_rows, oracles[q], True,
                       TPCH_ORACLE_ORDER[q])
        recorded = 0
        if wq.graph is not None:
            recorded = len(grec.calls) - glaunches
            if glaunches or (recorded > 0) != k1:
                raise AssertionError(f"{label}: the capture launched K1 {glaunches} times and "
                                     f"recorded {recorded} calls")
            for i, args in enumerate(grec.calls):
                checked.append(f"tpch-q{q}-sf{SF:g}-captured-inputs-{i}")
                err = max(err, k1_check(checked[-1], *args))
        del grec, eager_rows, replay_rows, got
        late = time.perf_counter() - loop0 > TPCH_BUDGET_S
        batches = TPCH_SHORT_BATCHES if late else TPCH_BATCHES
        runs = warm_paths(lambda: run_tpch(ctx, q).to_pydict(), batches)
        single[q][1] = statistics.median(runs["eager"])
        for p in ("eager", "exact"):
            with path(p):
                exp.check(p, q, run_tpch(ctx, q).to_pydict())
        syncs = warm_syncs(lambda: run_tpch(ctx, q), lambda t: t.to_pydict())
        dec = decode_ms(lambda: run_tpch(ctx, q))
        base_mb = torch.cuda.memory_allocated() / 2**20
        torch.cuda.reset_peak_memory_stats()
        run_tpch(ctx, q).to_pydict()
        torch.cuda.synchronize()
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        if wq.graph is not None:
            prof = profiled_replay(lambda: run_tpch(ctx, q).to_pydict(), label, recorded,
                                   k2_recorded=sum(r.recorded for r in k2))
            if prof["k1_launches"]:
                launches[f"tpch-q{q}-graph"] = prof["k1_launches"]
            K2_BY_PATH[f"tpch-q{q}-graph"] = prof["k2_launches"]
        else:
            prof = profile_run(lambda: run_tpch(ctx, q).to_pydict())
        with path("eager"):
            eager = profile_run(lambda: run_tpch(ctx, q).to_pydict())
        if q not in TPCH_JOINLESS:
            tops[q] = eager
        cands = join_candidates(ctx, q)
        shared = shared_executions(ctx, q)
        if q == 15 and not shared:
            raise AssertionError("Q15: no shared node in the plan (revenue0 is used twice)")
        log(f"[tpch] {name_power}: {label} {nrows} rows"
            f"{' (cold run and replay match the numpy oracle)' if q in oracles else ''}; the cold run, "
            f"the check, the replay and an eager and an exact collect match the expected file; "
            f"{graph_state(wq)}; K1 launches cold {launches[f'tpch-q{q}']}, recorded by the capture "
            f"{recorded}, run by the profiled replay {prof.get('k1_launches', '-')}; K2 launches "
            f"{[r.launches for r in k2]} (cold, check, capture), recorded by the capture "
            f"{sum(r.recorded for r in k2)}, run by the profiled replay {prof.get('k2_launches', '-')}; "
            f"cold run {cold * 1e3:.3f} ms, {cold_syncs} host syncs; check {check_secs * 1e3:.3f} ms; "
            f"capture and replay {capture_secs * 1e3:.3f} ms; {medians(runs)}"
            f"{' (short: past the phase budget)' if late else ''}; runs "
            f"{ {p: ['%.3f' % r for r in v] for p, v in runs.items()} }; profiled replay "
            f"{prof['profiled_wall_ms']:.3f} ms wall, kernel time {prof['kernel_ms']:.3f} ms in "
            f"{prof['launches']} launches, device idle share {prof['idle_share']:.1%}; profiled eager "
            f"run {eager['profiled_wall_ms']:.3f} ms wall, {eager['kernel_ms']:.3f} ms in "
            f"{eager['launches']} launches, idle {eager['idle_share']:.1%}; host syncs per warm run "
            f"{syncs[0]} (+{syncs[1]} to decode the result); decode {dec:.3f} ms; peak memory {peak_mb:.1f} MiB "
            f"({peak_mb - base_mb:.1f} MiB above the {base_mb:.1f} MiB allocated before the run); "
            f"join candidates {cands}"
            f"{'; executions of each shared node in one eager collect ' + str(shared) if shared else ''}")
    log(f"[memory] {name_power}: tpch phase, {graphs_held(ctx)}")
    # a new catalog version releases the cached plans' graphs, and with the
    # last graph the pool (the allocator's other free blocks are returned
    # first, so the difference is the pool's)
    region = ctx.table("region").collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    ctx.register_table("region", region)
    torch.cuda.empty_cache()
    log(f"[memory] {name_power}: after re-registering a table: {graphs_held(ctx)}; reserved "
        f"{before / 2**20:.1f} -> {torch.cuda.memory_reserved() / 2**20:.1f} MiB")
    heavy = max(tops, key=lambda q: tops[q]["kernel_ms"])
    log(f"[tpch] {name_power}: top device ops of an eager run of Q{heavy} SF{SF}, the join query "
        f"with the most kernel time ({tops[heavy]['kernel_ms']:.3f} ms):")
    for line in tops[heavy]["top"]:
        log(f"[tpch]   {line}")
    phase_window(name_power, ctx, woracles, wtwins)
    log(f"[memory] {name_power}: after the window phase, {graphs_held(ctx)}")
    return launches, err, checked, ctx, single, q1_want


# ---------------------------------------------------------------------------
# phase 9: windows and rolling windows over the TPC-H tables
# ---------------------------------------------------------------------------

WINDOW_TIMED_ORDER = {  # (column, descending) of each timed form's ORDER BY
    "W1": [("o_custkey", False), ("rk", False), ("o_orderkey", False)],
    "W2": [("l_suppkey", False), ("l_shipdate", False), ("l_orderkey", False), ("l_linenumber", False)],
    "W3": [("l_partkey", False), ("l_orderkey", False), ("l_linenumber", False)],
    "W4": [("o_custkey", False), ("d", False), ("o_orderkey", False)],
}
WINDOW_CAPTURE = {"W1", "W2", "W3"}  # must capture one CUDA graph each
WINDOW_BATCHES = 3


def table_arrays(t) -> dict:
    """{column: (values, valid)} of a result table as numpy arrays (strings
    decoded), without building Python values row by row."""
    n = t.nrows
    out = {}
    for name, c in zip(t.names, t.columns):
        data, valid = c.data[:n].cpu().numpy(), c.valid[:n].cpu().numpy()
        if c.dtype.is_string:
            data = np.asarray(c.dictionary.decode(data), dtype=object)
        out[name.split(".")[-1]] = (data, valid)
    return out


def _rows_order(arrays: dict, keys) -> np.ndarray:
    return np.lexsort(tuple(arrays[k][0] for k in reversed(keys)))


def check_arrays(label: str, got: dict, want: dict, keys=None, floats=()) -> None:
    """Equal columns, valid masks and values: exact, but the float columns
    ``floats`` within rel 1e-12; rows matched by the ``keys`` columns when
    given (both sides sorted by them), else in order."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: columns {sorted(got)} != {sorted(want)}")
    n = len(next(iter(want.values()))[0])
    if len(next(iter(got.values()))[0]) != n:
        raise AssertionError(f"{label}: {len(next(iter(got.values()))[0])} rows, want {n}")
    og = _rows_order(got, keys) if keys else slice(None)
    ow = _rows_order(want, keys) if keys else slice(None)
    for col in want:
        gd, gv = got[col][0][og], got[col][1][og]
        wd, wv = want[col][0][ow], want[col][1][ow]
        if not np.array_equal(gv, wv):
            raise AssertionError(f"{label}: {col} NULLs differ at {np.flatnonzero(gv != wv)[:5]}")
        gd, wd = gd[wv], wd[wv]
        if col in floats:
            bad = ~(np.abs(gd.astype(np.float64) - wd) <= TPCH_REL * np.abs(wd))
        else:
            bad = gd != wd
        if bad.any():
            i = np.flatnonzero(bad)[:3]
            raise AssertionError(f"{label}: {col} differs at {i}: {gd[i]} vs {wd[i]}")


def _partition_starts(*sorted_keys) -> tuple:
    """(each sorted row's partition start, partition end) for partitions of
    equal leading keys."""
    n = len(sorted_keys[0])
    new = np.zeros(n, bool)
    new[:1] = True
    for k in sorted_keys:
        new[1:] |= k[1:] != k[:-1]
    idx = np.arange(n)
    start = np.maximum.accumulate(np.where(new, idx, 0))
    end_mark = np.r_[new[1:], True]
    end = np.minimum.accumulate(np.where(end_mark, idx, n)[::-1])[::-1]
    return start, end


def window_oracles(d: dict) -> dict:
    """Each window query's full result over the generator's arrays, in
    numpy, as {column: (values, valid)}: decimals as their scaled integers,
    dates as day numbers, as the engine stores them."""
    o, li = d["orders"], d["lineitem"]
    ones = lambda n: np.ones(n, bool)  # noqa: E731
    out = {}

    ck, ok, price = o["o_custkey"], o["o_orderkey"], _dec(o["o_totalprice"])
    order = np.lexsort((ok, -price, ck))
    cs, ps = ck[order], price[order]
    pstart, _ = _partition_starts(cs)
    peer_start, _ = _partition_starts(cs, ps)
    peers = np.cumsum(peer_start == np.arange(len(cs)))
    n = len(cs)
    out["W1"] = {"o_custkey": (cs, ones(n)), "o_orderkey": (ok[order], ones(n)),
                 "o_totalprice": (ps, ones(n)), "rk": (peer_start - pstart + 1, ones(n)),
                 "drk": (peers - peers[pstart] + 1, ones(n))}

    sk, lok, ln, sd = li["l_suppkey"], li["l_orderkey"], li["l_linenumber"], li["l_shipdate"]
    ep, qty = _dec(li["l_extendedprice"]), _dec(li["l_quantity"])
    order = np.lexsort((ln, lok, sd, sk))
    s = np.cumsum(ep[order])
    pstart, _ = _partition_starts(sk[order])
    n = len(order)
    out["W2"] = {"l_suppkey": (sk[order], ones(n)), "l_orderkey": (lok[order], ones(n)),
                 "l_linenumber": (ln[order], ones(n)), "l_shipdate": (sd[order], ones(n)),
                 "cume": (s - s[pstart] + ep[order][pstart], ones(n))}

    pk = li["l_partkey"]
    order = np.lexsort((ln, lok, sd, pk))
    q, p = qty[order], ep[order]
    pstart, pend = _partition_starts(pk[order])
    idx = np.arange(n)
    lo, hi = np.maximum(idx - 3, pstart), np.minimum(idx + 3, pend)
    qs = np.r_[0.0, np.cumsum(q / 100.0)]
    mn, mx = q.copy(), q.copy()
    for sh in range(-3, 4):
        j = np.clip(idx + sh, 0, n - 1)
        inside = (idx + sh >= lo) & (idx + sh <= hi)
        mn = np.where(inside, np.minimum(mn, q[j]), mn)
        mx = np.where(inside, np.maximum(mx, q[j]), mx)
    has_prev, has_next = idx > pstart, idx < pend
    out["W3"] = {"l_partkey": (pk[order], ones(n)), "l_orderkey": (lok[order], ones(n)),
                 "l_linenumber": (ln[order], ones(n)),
                 "avg_q": ((qs[hi + 1] - qs[lo]) / (hi - lo + 1), ones(n)),
                 "min_q": (mn, ones(n)), "max_q": (mx, ones(n)),
                 "prev_p": (np.where(has_prev, p[np.clip(idx - 1, 0, n - 1)], 0), has_prev),
                 "next_p": (np.where(has_next, p[np.clip(idx + 1, 0, n - 1)], 0), has_next)}

    day = o["o_orderdate"].astype(np.int64)
    order = np.lexsort((ok, day, ck))
    key = ck[order].astype(np.int64) * (1 << 20) + day[order]
    lo = np.searchsorted(key, key - 90, "left")
    hi = np.searchsorted(key, key, "right")
    c = np.r_[0, np.cumsum(price[order])]
    m = len(order)
    out["W4"] = {"o_custkey": (ck[order], ones(m)), "o_orderkey": (ok[order], ones(m)),
                 "d": (day[order], ones(m)), "o_totalprice": (price[order], ones(m)),
                 "spend90": (c[hi] - c[lo], ones(m))}

    modes = np.array(sorted(set(li["l_shipmode"])), dtype=object)
    mi = np.searchsorted(modes.astype(str), li["l_shipmode"].astype(str))
    days = np.arange(8036, 10562)
    di = li["l_shipdate"].astype(np.int64) - 8036
    inside = (di >= 0) & (di < len(days))
    sums = np.zeros((len(modes), len(days) + 1), np.int64)
    cnts = np.zeros((len(modes), len(days) + 1), np.int64)
    np.add.at(sums, (mi[inside], di[inside] + 1), ep[inside])
    np.add.at(cnts, (mi[inside], di[inside] + 1), 1)
    cs, cc = np.cumsum(sums, 1), np.cumsum(cnts, 1)
    j = np.arange(1, len(days) + 1)
    s7 = cs[:, j] - cs[:, np.maximum(j - 7, 0)]
    c7 = cc[:, j] - cc[:, np.maximum(j - 7, 0)]
    out["R1"] = {"l_shipmode": (np.repeat(modes, len(days)), ones(s7.size)),
                 "day": (np.tile(days, len(modes)), ones(s7.size)),
                 "s7": (s7.reshape(-1), c7.reshape(-1) > 0)}
    return out


WINDOW_FLOATS = {"avg_q"}


def timed_rows(name: str, full: dict) -> dict:
    """The rows of a timed form (its filter, ORDER BY and LIMIT 100) from
    the full form's rows."""
    if name == "R1":
        return full
    keep = np.ones(len(full[next(iter(full))][0]), bool)
    if name == "W1":
        keep = full["rk"][0] <= 3
    order = np.lexsort(tuple(full[c][0] for c, _ in reversed(WINDOW_TIMED_ORDER[name])))
    order = order[keep[order]][:100]
    return {c: (v[order], m[order]) for c, (v, m) in full.items()}


def window_check(cpu, gpu) -> dict:
    """SF 0.1: each window query's full and timed forms on the card equal
    the port's on the CPU over the same tables; returns which timed forms
    the CPU makes one unit (three collects), which the card must capture."""
    twins = {}
    for name in WINDOW_QUERIES:
        nrows = []
        for timed in (False, True):
            sql = window_sql(name, timed)
            want = table_arrays(cpu.sql(sql).collect())
            nrows.append(len(want[next(iter(want))][0]))
            for i in range(3):
                check_arrays(f"{name}{' timed' if timed else ''} SF{TPCH_CHECK_SF} card run {i + 1} vs "
                             f"CPU", table_arrays(gpu.sql(sql).collect()), want, None, WINDOW_FLOATS)
            if timed:
                for _ in range(2):
                    cpu.sql(sql).collect()
                twins[name] = whole_query(cpu).is_program
        log(f"[window] {name} SF{TPCH_CHECK_SF}: the card's rows equal the CPU's (full form "
            f"{nrows[0]} rows, timed form {nrows[1]}) in the cold run, the check and a replay; CPU "
            f"twin {'one unit' if twins[name] else 'node by node'}")
    return twins


def phase_window(name_power: str, ctx, oracles: dict, twins: dict) -> None:
    """W1-W4 and R1 at SF1 on the TPC-H context: the full form once against
    its numpy oracle (peak memory above what was allocated); the timed form
    in the cold run, the check and the capture against the oracle's rows;
    a graph where the CPU twin is one unit (W1-W3 must capture); warm
    medians of the three paths in turns, syncs per warm run, decode, a
    profiled replay and eager run, peak memory."""
    for name in WINDOW_QUERIES:
        want = oracles[name]
        full = window_sql(name, False)
        base_mb = torch.cuda.memory_allocated() / 2**20
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with TakeRecorder(f"window-{name}"):
            got = table_arrays(ctx.sql(full).collect())
        full_ms = (time.perf_counter() - t0) * 1e3
        full_peak = torch.cuda.max_memory_allocated() / 2**20
        check_arrays(f"{name} SF{SF} full form vs numpy oracle", got, want,
                     WINDOW_QUERIES[name][2], WINDOW_FLOATS)
        nfull = len(got[next(iter(got))][0])
        del got
        sql = window_sql(name, True)
        twant = timed_rows(name, want)
        secs, k2 = [], []
        for _ in range(3):  # cold, check, capture and replay
            t0 = time.perf_counter()
            with TakeRecorder(f"window-{name}") as k2_run:
                out = ctx.sql(sql).collect()
            k2.append(k2_run)
            check_arrays(f"{name} SF{SF} timed form vs numpy oracle", table_arrays(out), twant,
                         None, WINDOW_FLOATS)
            secs.append((time.perf_counter() - t0) * 1e3)
        wq = whole_query(ctx)
        if twins[name] or name in WINDOW_CAPTURE:
            require_capture(f"{name} SF{SF}", wq)
        runs = warm_paths(lambda: ctx.sql(sql).collect().to_pydict(), WINDOW_BATCHES)
        syncs = warm_syncs(lambda: ctx.sql(sql).collect(), lambda t: t.to_pydict())
        dec = decode_ms(lambda: ctx.sql(sql).collect())
        base2 = torch.cuda.memory_allocated() / 2**20
        torch.cuda.reset_peak_memory_stats()
        ctx.sql(sql).collect().to_pydict()
        torch.cuda.synchronize()
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        if wq.graph is not None:
            prof = profiled_replay(lambda: ctx.sql(sql).collect().to_pydict(), name, 0,
                                   k2_recorded=sum(r.recorded for r in k2))
            K2_BY_PATH[f"window-{name}"] += prof["k2_launches"]
        else:
            prof = profile_run(lambda: ctx.sql(sql).collect().to_pydict())
        with path("eager"):
            eager = profile_run(lambda: ctx.sql(sql).collect().to_pydict())
        log(f"[window] {name_power}: {name} SF{SF} full form ({nfull} rows) matches the numpy oracle, "
            f"{full_ms:.3f} ms cold, peak memory {full_peak:.1f} MiB ({full_peak - base_mb:.1f} MiB above "
            f"the {base_mb:.1f} MiB allocated); timed form ({len(twant[next(iter(twant))][0])} rows) "
            f"matches it in the cold run, the check and the replay; {graph_state(wq)}; K2 launches "
            f"{[r.launches for r in k2]} (cold, check, capture), {sum(r.recorded for r in k2)} recorded "
            f"by the capture, {prof.get('k2_launches', '-')} run by the profiled replay; runs "
            f"{['%.3f' % t for t in secs]} ms; {medians(runs)}; profiled replay "
            f"{prof['profiled_wall_ms']:.3f} ms wall, kernel time {prof['kernel_ms']:.3f} ms in "
            f"{prof['launches']} launches, device idle share {prof['idle_share']:.1%}; profiled eager run "
            f"{eager['profiled_wall_ms']:.3f} ms wall, {eager['kernel_ms']:.3f} ms in {eager['launches']} "
            f"launches, idle {eager['idle_share']:.1%}; host syncs per warm run {syncs[0]} "
            f"(+{syncs[1]} to decode the result); decode {dec:.3f} ms; peak memory {peak_mb:.1f} MiB "
            f"({peak_mb - base2:.1f} MiB above the {base2:.1f} MiB allocated before the run)")
        for line in eager["top"][:6]:
            log(f"[window]   {line}")


# ---------------------------------------------------------------------------
# phase 13: the 22 TPC-H queries at SF1 over an 8-shard mesh
# ---------------------------------------------------------------------------

MESH_SHARDS = 8
MESH_WARM = 3  # warm runs per query after the cold one


def tpch_q1_oracle(li: dict) -> dict:
    """``q1_oracle`` over the TPC-H generator's lineitem arrays."""
    return q1_oracle({
        "l_shipdate": li["l_shipdate"],
        "l_returnflag": np.searchsorted(RETURNFLAGS, li["l_returnflag"].astype(str)),
        "l_linestatus": np.searchsorted(LINESTATUSES, li["l_linestatus"].astype(str)),
        **{k: _dec(li[k]) for k in ("l_quantity", "l_extendedprice", "l_discount", "l_tax")},
    })


def mesh_modes(ex) -> dict:
    return dict(collections.Counter(m for _, m in ex.node_modes))


def mesh_run(ctx, q: int, mesh, k2_path: str | None = None):
    """One strict run of TPC-H query q over ``mesh`` through run_tpch_spmd:
    (rows, executor, seconds, host syncs); K2's launches are added to
    ``k2_path``, when given."""
    ex = SpmdExecutor(mesh, strict=True)
    s0 = HOST_SYNCS[0]
    t0 = time.perf_counter()
    with TakeRecorder(k2_path) if k2_path else contextlib.nullcontext():
        got = run_tpch_spmd(ctx, q, ex).to_pydict()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if ex.fallback_count:
        raise AssertionError(f"Q{q} on the mesh: {ex.fallback_count} fallbacks: {ex.node_modes}")
    return got, ex, secs, HOST_SYNCS[0] - s0


def exchange_ms(prof) -> float:
    """Device milliseconds of the kernels launched inside the exchanges'
    profiler ranges (the collectives' copies and the shuffles' layout and
    packing)."""
    return sum(e.device_time_total for e in prof.key_averages() if e.key == EXCHANGE_RANGE) / 1e3


def phase_mesh(name_power: str, ctx, single: dict, q1_want: dict, exp: ExpectedRows) -> dict:
    """The 22 TPC-H queries at SF1 over make_mesh(8), eight logical shards
    on the one card (parallel/*): each query cold, then MESH_WARM warm
    runs, all strict, each against the single-device eager rows of the
    tpch phase (Q1 also against the numpy oracle), the cold and the last
    warm run also against the expected file's rows (``exp``), with 0
    fallbacks and no K1 launch; per query its node modes, exchange bytes,
    cold time, warm median beside the single-device eager median, peak
    memory and host syncs per run; the query with the most mesh time
    profiled (kernel time, idle share, top device ops, the exchanges'
    share); Q1's and Q3's collect_partitioned against their collect; Q1
    over the lineitem held in host memory and sharded by
    ShardedTable.from_host (against the expected file too).  Returns K1's
    launches per mesh path (all 0)."""
    mesh = make_mesh(MESH_SHARDS)
    place = collections.Counter(str(d) for d in mesh.devices)
    if any(d.type != "cuda" for d in mesh.devices):
        raise AssertionError(f"make_mesh placed a shard off the card: {place}")
    log(f"[mesh] {name_power}: make_mesh({MESH_SHARDS}): {dict(place)} (NVLink and several cards "
        f"are not exercised: every exchange is a copy on one card)")
    launches, warm_ms = {}, {}
    for q in TPCH_QUERIES:
        want, single_ms = single[q]
        label = f"Q{q} SF{SF:g} mesh"
        SD.smalldomain_sum_count.launches = 0
        base_mb = torch.cuda.memory_allocated() / 2**20
        torch.cuda.reset_peak_memory_stats()
        got, ex, cold, cold_syncs = mesh_run(ctx, q, mesh, f"mesh-tpch-q{q}")
        check_tpch(f"{label} cold vs single-device", got, want, q in FULLY_ORDERED)
        exp.check("mesh cold", q, got)
        if q == 1:
            check_q1(got, q1_want)
        runs, syncs = [], []
        for i in range(MESH_WARM):
            got, ex, secs, n = mesh_run(ctx, q, mesh, f"mesh-tpch-q{q}")
            check_tpch(f"{label} warm run {i + 1} vs single-device", got, want, q in FULLY_ORDERED)
            runs.append(secs * 1e3)
            syncs.append(n)
        exp.check("mesh last warm", q, got)
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        launches[f"mesh-tpch-q{q}"] = SD.smalldomain_sum_count.launches
        if launches[f"mesh-tpch-q{q}"]:
            raise AssertionError(f"{label}: K1 launched {launches[f'mesh-tpch-q{q}']} times")
        warm_ms[q] = statistics.median(runs)
        xbytes = sum(d.get("exchange_bytes", 0) for d in ex.node_details)
        log(f"[mesh] {name_power}: {label} {len(want)} rows equal the single-device rows in the "
            f"cold run and {MESH_WARM} warm runs, and the expected file's in the cold and the last "
            f"(strict, 0 fallbacks, K1 launches 0); modes "
            f"{mesh_modes(ex)}; exchange bytes {xbytes} (bound per shard, summed over nodes); cold "
            f"{cold * 1e3:.3f} ms ({cold_syncs} host syncs); warm median {warm_ms[q]:.3f} ms (runs "
            f"{['%.3f' % r for r in runs]}, host syncs {syncs}); single-device eager median "
            f"{single_ms:.3f} ms; peak memory {peak_mb:.1f} MiB ({peak_mb - base_mb:.1f} MiB above "
            f"the {base_mb:.1f} MiB allocated before)")
    heavy = max(warm_ms, key=warm_ms.get)
    from torch.profiler import ProfilerActivity, profile

    # the exchanges' profiler ranges are the tracer's spans: on for this run
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mesh_run(ctx, heavy, mesh)
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        tracing.disable()
        tracing.drain()
    events = list(prof.key_averages())
    # (the tracer's spans show on the device's timeline too: not kernels)
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("dftpu.")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    xms = exchange_ms(prof)
    log(f"[mesh] {name_power}: Q{heavy} (the most mesh time) profiled: {wall:.3f} ms wall, kernel "
        f"time {busy:.3f} ms in {sum(e.count for e in kernels)} launches, device idle share "
        f"{1 - busy / wall:.1%}; the exchanges' kernels {xms:.3f} ms ({xms / max(busy, 1e-9):.1%} of kernel "
        f"time)")
    ops = sorted((e for e in events if e.device_type != torch.autograd.DeviceType.CUDA
                  and e.key != EXCHANGE_RANGE and not e.key.startswith("dftpu.")),
                 key=lambda e: e.self_device_time_total, reverse=True)
    for e in ops[:12]:
        log(f"[mesh]   {e.self_device_time_total / 1e3:9.3f} ms device  {e.count:5d} calls  {e.key[:60]}")

    # collect_partitioned builds its own executor: strict through the
    # environment, so a failing distributed operator raises there
    os.environ["DFTPU_SPMD_STRICT"] = "1"
    SD.smalldomain_sum_count.launches = 0
    for q in (1, 3):
        with TakeRecorder("mesh-collect-partitioned-q1-q3"):
            parts = ctx.sql(get_query_sql(q)).collect_partitioned(mesh=mesh)
        if len(parts) != MESH_SHARDS:
            raise AssertionError(f"Q{q} collect_partitioned: {len(parts)} parts")
        union = {i: list(c) for i, c in enumerate(zip(*(r for p in parts for r in tpch_rows(p.to_pydict()))))}
        check_tpch(f"Q{q} collect_partitioned union vs collect", union, single[q][0], False)
        log(f"[mesh] {name_power}: Q{q} SF{SF:g} collect_partitioned(mesh=): {MESH_SHARDS} parts of "
            f"{[p.nrows for p in parts]} rows; their union equals the collect")
    launches["mesh-collect-partitioned-q1-q3"] = SD.smalldomain_sum_count.launches

    # Q1 over lineitem in host memory: each shard receives only its slice
    hctx = ExecutionContext()
    for name in ctx.tables():
        t = ctx.table(name).collect()
        hctx.register_table(name, HostTable.from_table(t) if name == "lineitem" else t)
    materialized = []
    orig = HostTable.materialize
    HostTable.materialize = lambda self: materialized.append(self.nrows) or orig(self)
    SD.smalldomain_sum_count.launches = 0
    try:
        got, ex, secs, n = mesh_run(hctx, 1, mesh, "mesh-q1-host-resident")
    finally:
        HostTable.materialize = orig
    launches["mesh-q1-host-resident"] = SD.smalldomain_sum_count.launches
    if materialized or launches["mesh-q1-host-resident"]:
        raise AssertionError(f"Q1 host-resident on the mesh: materialized {materialized}, K1 "
                             f"{launches['mesh-q1-host-resident']}")
    if ("HostMemoryExec", "mesh") not in ex.node_modes:
        raise AssertionError(f"Q1 host-resident: no sharded host scan in {ex.node_modes}")
    check_tpch("Q1 host-resident mesh vs device-resident", got, single[1][0], True)
    check_q1(got, q1_want)
    exp.check("mesh host-resident lineitem", 1, got)
    log(f"[mesh] {name_power}: Q1 SF{SF:g} over the host-resident lineitem sharded by from_host: "
        f"equals the device-resident rows, the oracle and the expected file; the table never "
        f"materialized on the card as a whole; {secs * 1e3:.3f} ms, {n} host syncs")
    del hctx
    return launches


# ---------------------------------------------------------------------------
# phase 10: Q1 over a host-resident lineitem at SF10, streamed in morsels
# ---------------------------------------------------------------------------

# TPC-H's SF100 lineitem cut to SF10 for the time limit; the reference's
# DEFAULT_MORSEL_ROWS (datasource/host.py)
MORSEL_SF = 10.0
MORSEL_ROWS = 1 << 20
MORSEL_RUNS = 7  # warm collects timed


class EndsRecorder(Recorder):
    """A Recorder that keeps only the first and the latest call (a morsel
    loop calls K1 once per morsel)."""

    def __call__(self, gid, cols, masks, domain):
        out = super().__call__(gid, cols, masks, domain)
        if len(self.calls) > 2:
            del self.calls[1]
        return out


def plan_nodes(plan) -> list:
    """Every node of a physical plan, the sources of fused stages included."""
    from datafusion_tpu_torch.physical.fuse import StageExec

    seen, stack, out = set(), [plan], []
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        out.append(n)
        stack.extend(n.children())
        if isinstance(n, StageExec):
            stack.append(n._source)
    return out


def host_scans(plan) -> tuple:
    """(morsel stages, materialized host scans) of a plan: how its
    host-resident tables are read."""
    from datafusion_tpu_torch.datasource.host import HostMemoryExec
    from datafusion_tpu_torch.physical.morsel import MorselJoinStageExec, MorselStageExec

    nodes = plan_nodes(plan)
    streamed = [n for n in nodes if isinstance(n, (MorselStageExec, MorselJoinStageExec))]
    return streamed, [n for n in nodes if isinstance(n, HostMemoryExec)]


def morsels_run(plan) -> int:
    return sum(n.metrics.counter("morsels").value for n in host_scans(plan)[0])


def sync_warnings(run) -> tuple:
    """(result, number of synchronizing CUDA calls torch's sync check
    reports) of one call of ``run``."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def pinned_copy_ms(host, iters: int = 3) -> float:
    """The bound of a collect's uploads: one plain copy of every host
    column (pinned) to the card, CUDA events, median of ``iters``."""
    srcs = [torch.from_numpy(x) for x in host.datas + host.valids]
    dsts = [torch.empty_like(x, device="cuda") for x in srcs]
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for d, s in zip(dsts, srcs):
            d.copy_(s, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    del dsts
    return statistics.median(times)


def staging_ms(host) -> float:
    """What two pinned staging sets would add per collect instead of pinning
    once: a host copy of every morsel's bytes from pageable memory into a
    pinned staging buffer (one morsel's worth, reused)."""
    rows = host.morsel_rows
    cols = [np.array(x) for x in host.datas + host.valids]  # pageable copies
    stage = [torch.empty(rows, dtype=torch.from_numpy(c[:1]).dtype).pin_memory().numpy() for c in cols]
    t0 = time.perf_counter()
    for lo in range(0, host.nrows, rows):
        for c, b in zip(cols, stage):
            k = min(rows, host.nrows - lo)
            b[:k] = c[lo:lo + k]
    return (time.perf_counter() - t0) * 1e3


def phase_morsel(name_power: str) -> tuple:
    """TPC-H Q1 over a host-resident lineitem at SF10 (58 morsels of 2^20
    rows): every collect against the numpy oracle and the device-resident
    table's rows, K1 run once per morsel (launched, or replayed in the
    morsel graph of a warm collect) and held against its plain version at
    the first and the last (partial) morsel's inputs; warm
    timings beside the device-resident table's graph, bytes uploaded and
    their rate against a plain pinned copy, host syncs, idle share and top
    device ops of a profiled collect, pin and staging times, peak memory.
    Returns (K1 launches of one collect, max abs error, checked inputs)."""
    from datafusion_tpu_torch.q1data import _lineitem_table, lineitem_host_table

    t0 = time.perf_counter()
    a = lineitem_q1_arrays(MORSEL_SF, SEED)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = q1_oracle(a)
    oracle_s = time.perf_counter() - t0
    host = lineitem_host_table(a, MORSEL_ROWS)  # pinned for the card
    hctx = ExecutionContext()
    hctx.register_host_table("lineitem", host)
    sql = get_query_sql(1)
    log(f"[morsel] lineitem SF{MORSEL_SF:g} host-resident: {host.nrows} rows, {host.num_morsels} morsels "
        f"of {host.morsel_rows} rows, {host.nbytes / 2**30:.3f} GiB of data and masks in host memory; "
        f"generated in {gen_s:.3f} s, numpy oracle {oracle_s:.3f} s, pinned once in "
        f"{host.pin_seconds:.3f} s")

    rec = EndsRecorder(aggregate.smalldomain_sum_count)
    aggregate.smalldomain_sum_count = rec
    runs = []
    try:
        # the cold collect launches K1 for every morsel; the warm one for
        # the first, the rest run in the morsel graph's replays
        for label in ("cold", "warm"):
            SD.smalldomain_sum_count.launches = 0
            tracing.drain()
            tracing.enable()
            t0 = time.perf_counter()
            try:
                with TakeRecorder("q1-sf10-host-resident-collect"):
                    rows = hctx.sql(sql).collect().to_pydict()
            finally:
                tracing.disable()
            runs.append((time.perf_counter() - t0) * 1e3)
            replayed = sum(n for (_, c), n in tracing.drain().counters.items() if c == "dftpu.morsel.replayed")
            launches = SD.smalldomain_sum_count.launches
            check_q1(rows, want)
            if launches + replayed != host.num_morsels or (label == "cold") != (replayed == 0):
                raise AssertionError(f"Q1 SF{MORSEL_SF:g} host-resident {label} collect: K1 launched "
                                     f"{launches} times and replayed {replayed}, want once per morsel "
                                     f"({host.num_morsels})")
            if label == "cold":
                first, last = rec.calls[0], rec.calls[-1]
    finally:
        aggregate.smalldomain_sum_count = rec.fn
    streamed, materialized = host_scans(last_plan(hctx))
    if len(streamed) != 1 or materialized:
        raise AssertionError(f"Q1 SF{MORSEL_SF:g}: the plan does not stream ({streamed}, {materialized})")
    tail = host.nrows - (host.num_morsels - 1) * host.morsel_rows
    if not bool((last[0][tail:] >= last[3]).all()):
        raise AssertionError("Q1 SF10: the last morsel's tail rows are not dead in K1's input")
    err = max(k1_check("q1-sf10-morsel-first-inputs", *first),
              k1_check("q1-sf10-morsel-last-inputs", *last))
    checked = ["q1-sf10-morsel-first-inputs", "q1-sf10-morsel-last-inputs"]
    del rec, first, last

    syncs = warm_syncs(lambda: hctx.sql(sql).collect(), lambda t: t.to_pydict())
    res, warned = sync_warnings(lambda: hctx.sql(sql).collect())
    _, warned_decode = sync_warnings(res.to_pydict)
    base_mb = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(MORSEL_RUNS):
        t0 = time.perf_counter()
        out = hctx.sql(sql).collect()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    host_rows = out.to_pydict()
    check_q1(host_rows, want)
    prof = profile_run(lambda: hctx.sql(sql).collect().to_pydict(), 12)
    bound_ms = pinned_copy_ms(host)
    stage_ms = staging_ms(host)
    wall = statistics.median(walls)
    gbs = host.nbytes / wall / 1e6
    log(f"[morsel] {name_power}: Q1 SF{MORSEL_SF:g} host-resident, every collect (cold {runs[0]:.3f} ms, "
        f"warm {runs[1]:.3f} ms, {MORSEL_RUNS} timed) matches the numpy oracle (exact keys, counts and "
        f"decimal sums; avgs rel 1e-12); K1 ran once per morsel ({host.num_morsels}) in the cold and the "
        f"warm collect (launched, or in the morsel graph's replays), and equals its plain version at "
        f"the first and the last (partial) morsel's inputs of the cold collect")
    log(f"[morsel] {name_power}: Q1 SF{MORSEL_SF:g} warm collect median {wall:.3f} ms over {MORSEL_RUNS} "
        f"(runs {['%.3f' % w for w in walls]}); {host.nbytes} bytes uploaded per collect, "
        f"{gbs:.3f} GB/s; plain pinned copy of the same bytes {bound_ms:.3f} ms "
        f"({host.nbytes / bound_ms / 1e6:.3f} GB/s; the collect takes {wall / bound_ms:.2f}x it); "
        f"host syncs per collect {syncs[0]} (+{syncs[1]} to decode), {syncs[0] / host.num_morsels:.3f} "
        f"per morsel; synchronizing calls torch's sync check reports in a collect {warned} (+{warned_decode} "
        f"to decode); peak "
        f"device memory {peak_mb:.1f} MiB ({peak_mb - base_mb:.1f} MiB above the {base_mb:.1f} MiB "
        f"allocated); pinned once {host.pin_seconds:.3f} s, against {stage_ms:.3f} ms per collect of "
        f"host copies into a pinned staging morsel")
    log(f"[profile] {name_power}: one warm Q1 SF{MORSEL_SF:g} host-resident collect (profiled) "
        f"{prof['profiled_wall_ms']:.3f} ms wall, {prof['kernel_ms']:.3f} ms kernel time in "
        f"{prof['launches']} launches, device idle share {prof['idle_share']:.1%}")
    for line in prof["top"]:
        log(f"[profile]   {line}")

    # the same query over the same rows device-resident, one CUDA graph
    dctx = ExecutionContext()
    t0 = time.perf_counter()
    dctx.register_table("lineitem", _lineitem_table(a, None))
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    del a
    for _ in range(3):  # cold, check, capture and replay
        check_q1(dctx.sql(sql).collect().to_pydict(), want)
    require_capture(f"Q1 SF{MORSEL_SF:g} device-resident", whole_query(dctx))
    dev_rows = dctx.sql(sql).collect().to_pydict()
    check_q1(host_rows, dev_rows)
    graph = warm_runs(lambda: dctx.sql(sql).collect().to_pydict(), 1)
    log(f"[morsel] {name_power}: Q1 SF{MORSEL_SF:g} device-resident (uploaded in {up_s:.3f} s): the "
        f"host-resident rows equal its rows; graph replay median {statistics.median(graph):.3f} ms "
        f"(runs {['%.3f' % r for r in graph]}); host-resident / device-resident "
        f"{wall / statistics.median(graph):.2f}x")
    morsels = host.num_morsels
    del dctx, hctx, host
    torch.cuda.empty_cache()
    return morsels, err, checked


# ---------------------------------------------------------------------------
# phase 11: the 22 TPC-H queries at SF1 with lineitem host-resident
# ---------------------------------------------------------------------------


def host_lineitem_context(data: dict, morsel_rows: int, device=None):
    """The TPC-H tables of ``data`` on ``device``, lineitem host-resident in
    morsels of ``morsel_rows``."""

    ctx = ExecutionContext(device=device)
    tpchdata.register_tpch(ctx, {k: v for k, v in data.items() if k != "lineitem"})
    li = tpchdata.tpch_table(data["lineitem"], "cpu")
    ctx.register_host_table("lineitem", HostTable.from_table(li, morsel_rows, ctx.device))
    return ctx


def morsel_tpch(dctx, hctx, label: str, exp: ExpectedRows, warm: int = 3) -> dict:
    """Each TPC-H query on ``hctx`` (lineitem host-resident) against the
    device-resident ``dctx`` run once: rows equal in the cold run and every
    warm run, and the expected file's in each; per query (streamed stages, materialized
    scans, morsels of one collect, K1 launches of one collect, warm eager
    ms)."""
    out = {}
    for q in TPCH_QUERIES:
        want = tpch_rows(run_tpch(dctx, q).to_pydict())
        SD.smalldomain_sum_count.launches = 0
        with TakeRecorder(f"morsel-tpch-q{q}"):
            got = run_tpch(hctx, q).to_pydict()
        k1 = SD.smalldomain_sum_count.launches
        check_tpch(f"Q{q} {label} host-resident cold run vs device-resident", got, want, q in FULLY_ORDERED)
        exp.check("host-resident lineitem", q, got)
        plan = last_plan(hctx)
        streamed, materialized = host_scans(plan)
        times = []
        for _ in range(warm):
            m0 = morsels_run(plan)
            t0 = time.perf_counter()
            res = run_tpch(hctx, q)
            res.nrows
            if hctx.device.type == "cuda":
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            morsels = morsels_run(plan) - m0
            got = res.to_pydict()
            check_tpch(f"Q{q} {label} host-resident warm run vs device-resident", got, want,
                       q in FULLY_ORDERED)
            exp.check("host-resident lineitem", q, got)
        out[q] = (len(streamed), len(materialized), morsels, k1, statistics.median(times))
    return out


def phase_morsel_tpch(name_power: str, exp: ExpectedRows) -> None:
    """All 22 TPC-H queries at SF1, lineitem host-resident (morsels of
    2^20 rows), against the device-resident tables and the expected file:
    rows equal; per query, streamed or materialized, morsels, K1 launches and warm eager ms; the
    device memory of the materialized lineitem."""
    t0 = time.perf_counter()
    data = tpchdata.generate_tpch(SF, SEED)
    dctx = ExecutionContext()
    tpchdata.register_tpch(dctx, data)
    hctx = host_lineitem_context(data, MORSEL_ROWS)
    host = hctx._resolve_table("lineitem").host
    del data
    log(f"[morsel-tpch] SF{SF:g}: lineitem host-resident ({host.nrows} rows, {host.num_morsels} morsels, "
        f"{host.nbytes / 2**30:.3f} GiB pinned in {host.pin_seconds:.3f} s), the other seven tables and "
        f"a device-resident twin on the card; set up in {time.perf_counter() - t0:.3f} s")
    with path("eager"):  # the device-resident rows from plans run node by node
        info = morsel_tpch(dctx, hctx, f"SF{SF:g}", exp)
    for q, (ns, nm, morsels, k1, ms) in info.items():
        how = (f"streamed by {ns} morsel stage{'s' if ns > 1 else ''}" if ns else "")
        how += (", " if ns and nm else "") + (f"materialized ({nm} scan{'s' if nm > 1 else ''})" if nm else "")
        log(f"[morsel-tpch] {name_power}: Q{q} SF{SF:g} rows equal the device-resident tables' and the "
            f"expected file's in the cold run and 3 warm runs; {how or 'no lineitem scan'}; {morsels} "
            f"morsels per collect; K1 launches {k1}; warm eager median {ms:.3f} ms")
    mat = host._materialized
    mib = 0.0 if mat is None else sum(c.data.nbytes + c.valid.nbytes for c in mat.columns) / 2**20
    log(f"[morsel-tpch] {name_power}: streamed {sum(1 for v in info.values() if v[0])} queries, "
        f"materialized lineitem in {sum(1 for v in info.values() if v[1])}; the materialized copy holds "
        f"{mib:.1f} MiB on the card")
    del dctx, hctx, host, mat
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: file sources
# ---------------------------------------------------------------------------

LINEITEM_TBL_COLUMNS = (  # (name, storage form) in file order
    ("l_orderkey", "int"), ("l_suppkey", "int"), ("l_linenumber", "int"),
    ("l_quantity", "dec2"), ("l_extendedprice", "dec2"), ("l_discount", "dec2"), ("l_tax", "dec2"),
    ("l_returnflag", "flag"), ("l_linestatus", "status"), ("l_shipdate", "date"),
)


def _ascii_digits(v: np.ndarray, width: int) -> np.ndarray:
    """Non-negative integers as zero-padded ASCII digits, (n, width) uint8."""
    x = np.asarray(v, np.int64).copy()
    if (x < 0).any():
        raise ValueError("negative value in a fixed-width field")
    out = np.empty((len(x), width), np.uint8)
    for j in range(width - 1, -1, -1):
        out[:, j] = x % 10 + 48
        x //= 10
    if x.any():
        raise ValueError(f"a value is wider than {width} digits")
    return out


def write_tbl(path: str, a: dict) -> int:
    """Write ``lineitem_arrays``' columns as a '|'-delimited TPC-H .tbl file
    (a trailing delimiter, no header) with numpy: every field fixed-width,
    numbers zero-padded, so the rows are one byte matrix.  Returns its
    bytes."""
    n = len(a["l_quantity"])
    bar, nl = np.full((n, 1), ord("|"), np.uint8), np.full((n, 1), ord("\n"), np.uint8)
    dot = np.full((n, 1), ord("."), np.uint8)
    parts = []
    for name, kind in LINEITEM_TBL_COLUMNS:
        v = a[name]
        if kind == "int":
            parts.append(_ascii_digits(v, len(str(int(v.max())))))
        elif kind == "dec2":
            parts += [_ascii_digits(v // 100, len(str(int(v.max()) // 100))), dot, _ascii_digits(v % 100, 2)]
        elif kind in ("flag", "status"):
            letters = np.frombuffer("".join(RETURNFLAGS if kind == "flag" else LINESTATUSES).encode(), np.uint8)
            parts.append(letters[v][:, None])
        else:
            s = np.datetime_as_string(v.astype("datetime64[D]")).astype("S10")
            parts.append(np.frombuffer(s.tobytes(), np.uint8).reshape(n, 10))
        parts.append(bar)
    parts.append(nl)
    rows = np.concatenate(parts, axis=1)
    rows.tofile(path)
    return rows.size


def lineitem_tbl_schema():
    from datafusion_tpu_torch.types import Field, Schema
    from datafusion_tpu_torch.types.dtypes import DATE32, INT32, INT64, STRING, decimal

    kinds = {"int": INT64, "dec2": decimal(15, 2), "flag": STRING, "status": STRING, "date": DATE32}
    return Schema([Field(n, INT32 if n == "l_linenumber" else kinds[k]) for n, k in LINEITEM_TBL_COLUMNS])


FILE_QUERIES = {"q1": get_query_sql(1), "q6": get_named_query("q6")}


def files_check(tmp: str, a: dict, device=None, morsel_rows: int = MORSEL_ROWS, require_native=True) -> list:
    """The file-source paths over ``a`` (``lineitem_arrays``), each query's
    rows against the device-resident table's; returns printable lines."""
    from datafusion_tpu_torch.q1data import _lineitem_table

    dctx = ExecutionContext(device=device)
    dctx.register_table("lineitem", _lineitem_table(a, dctx.device))
    want = {k: tpch_rows(dctx.sql(q).collect().to_pydict()) for k, q in FILE_QUERIES.items()}
    lines = []
    tbl = os.path.join(tmp, "lineitem.tbl")
    t0 = time.perf_counter()
    nbytes = write_tbl(tbl, a)
    write_s = time.perf_counter() - t0
    fctx = ExecutionContext(device=device)
    fctx.register_csv("lineitem", tbl, lineitem_tbl_schema(), has_header=False, delimiter="|")
    prov = fctx._resolve_table("lineitem")
    t0 = time.perf_counter()
    prov.scan()
    load_s = time.perf_counter() - t0
    if require_native and prov.loader != "native":
        from datafusion_tpu_torch import native_lib

        raise AssertionError(f"the .tbl file was read by {prov.loader}, not the native loader "
                             f"({native_lib.BUILD_ERROR})")
    for k, q in FILE_QUERIES.items():
        check_tpch(f"{k} over the .tbl file vs device-resident", fctx.sql(q).collect().to_pydict(),
                   want[k], True)
    lines.append(f".tbl file of {len(a['l_quantity'])} rows, {nbytes} bytes written with numpy in "
                 f"{write_s:.3f} s; register_csv with a schema loaded it through the {prov.loader} loader "
                 f"in {load_s:.3f} s; Q1 and Q6 equal the device-resident rows")
    try:
        import pyarrow  # noqa: F401
    except ImportError:
        lines.append("pyarrow is not installed: the Parquet round trip (register_parquet device-resident "
                     "and with morsel_rows=, and Q6's row-group pruning) did not run")
        return lines
    pq_path = os.path.join(tmp, "lineitem.parquet")
    t0 = time.perf_counter()
    fctx.write_parquet(fctx.sql("SELECT * FROM lineitem ORDER BY l_shipdate"), pq_path)
    write_s = time.perf_counter() - t0
    pctx = ExecutionContext(device=device)
    pctx.register_parquet("lineitem", pq_path)
    mctx = ExecutionContext(device=device)
    mctx.register_parquet("lineitem", pq_path, morsel_rows=morsel_rows)
    for k, q in FILE_QUERIES.items():
        for c, how in ((pctx, "device-resident"), (mctx, "host-resident")):
            check_tpch(f"{k} over Parquet {how} vs device-resident", c.sql(q).collect().to_pydict(),
                       want[k], True)
    from datafusion_tpu_torch.logical.plan import TableScan
    from datafusion_tpu_torch.physical.pruning import PruningPredicate

    stack, filters = [pctx.optimize(pctx.sql(FILE_QUERIES["q6"]).logical_plan())], []
    while stack:
        node = stack.pop()
        filters += node.filters if isinstance(node, TableScan) else []
        stack.extend(node.inputs())
    stats, groups = pctx._resolve_table("lineitem")._row_group_stats()
    matched = int(PruningPredicate(filters).prune(stats).sum())
    pruned = len(groups) - matched
    host = mctx._resolve_table("lineitem").host
    lines.append(f"Parquet written (sorted by l_shipdate) in {write_s:.3f} s; register_parquet "
                 f"device-resident and with morsel_rows={morsel_rows} ({host.num_morsels} morsels) give "
                 f"the device-resident rows for Q1 and Q6; Q6's filter pruned {pruned} of "
                 f"{pruned + matched} row groups")
    return lines


def phase_files(name_power: str, tmp: str) -> None:
    """SF1 lineitem written as a .tbl file in ``tmp`` and loaded with
    register_csv and a schema through the native loader (asserted), Q1 and
    Q6 against the device-resident rows; a Parquet round trip where pyarrow
    is installed.  The .tbl stays for the cli phase."""
    a = lineitem_arrays(SF, SEED)
    for line in files_check(tmp, a):
        log(f"[files] {name_power}: {line}")


# ---------------------------------------------------------------------------
# phase 14: the distributed runtime
# ---------------------------------------------------------------------------

DIST_QUERIES = (1, 3, 5, 6, 10, 12)  # the Ballista TPC-H set, benchmarks/run.sh:22-26
DIST_WARM = 3  # warm runs per query after the cold one
DIST_PARTITIONS = 4
DIST_SHUFFLE_PARTITIONS = 16  # Ballista's ballista.shuffle.partitions default
DIST_MESH_DEVICES = 4
DIST_SPILLED = ("lineitem", "orders", "customer")  # the tables Q1 and Q3 read
DIST_TIMES = ("exec_s", "write_s", "read_s", "final_read_s", "poll_sleep_s", "await_sleep_s")
RPC = "datafusion_tpu_torch.distributed.rpc"


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dist_job(state, before: set) -> dict:
    """The stages, tasks and scan tasks of the one job not in ``before``."""
    (key,) = set(state.kv.keys("jobs/")) - before
    job = key.split("/", 1)[1]
    stages = [state.stage(job, sid) for sid in state.job(job)["stage_ids"]]
    return {"stages": len(stages), "tasks": sum(s["num_input_partitions"] for s in stages),
            "scan_tasks": sum(s["num_input_partitions"] for s in stages
                              if '"dist_scan"' in json.dumps(s["plan"]))}


def dist_run(dctx, q: int) -> dict:
    """One collect of TPC-H query q through the standalone cluster ``dctx``
    (rows decoded): its rows, ms, the job's shape, K1's launches (the
    count set to 0 just before) and the exchanges' seconds and bytes."""
    state = dctx.scheduler.state
    before = set(state.kv.keys("jobs/"))
    X.reset_times()
    SD.smalldomain_sum_count.launches = 0
    t0 = time.perf_counter()
    with TakeRecorder(f"distributed-q{q}"):
        got = dctx.sql(get_query_sql(q)).collect().to_pydict()
    _sync(dctx.device)
    ms = (time.perf_counter() - t0) * 1e3
    return {"rows": got, "ms": ms, "k1": SD.smalldomain_sum_count.launches, "times": dict(X.TIMES),
            **dist_job(state, before)}


def dist_check(label: str, run: dict, q: int, want: list, q1_want: dict, exp: ExpectedRows,
               where: str) -> None:
    check_tpch(label, run["rows"], want, q in FULLY_ORDERED)
    exp.check(where, q, run["rows"])
    if q == 1:
        check_q1(run["rows"], q1_want)
        if run["k1"] != run["scan_tasks"]:
            raise AssertionError(f"{label}: K1 launched {run['k1']} times for {run['scan_tasks']} scan tasks")


def dist_context(tables: dict, partitions: int, work_dir: str):
    dctx = DistributedContext(num_executors=2, target_partitions=partitions, work_dir=work_dir)
    for name, t in tables.items():
        dctx.register_table(name, t)
    return dctx


def dist_times(runs: list) -> str:
    med = {k: statistics.median(r["times"].get(k, 0.0) for r in runs) for k in DIST_TIMES}
    return ", ".join(f"{k[:-2]} {v:.3f} s" for k, v in med.items())


def dist_standalone(name_power: str, tables: dict, single: dict, q1_want: dict, tmp: str,
                    exp: ExpectedRows) -> tuple:
    """The six queries through the standalone cluster, then Q1 and Q3 at
    16 partitions.  Returns (K1 launches per path, K1's max abs error, the
    names of the inputs it was checked at)."""
    t0 = time.perf_counter()
    dctx = dist_context(tables, DIST_PARTITIONS, os.path.join(tmp, "p4"))
    dev = dctx.device
    log(f"[distributed] SF{SF:g}: DistributedContext(num_executors=2, target_partitions="
        f"{DIST_PARTITIONS}) on {dev}, phase 8's eight tables registered in {time.perf_counter() - t0:.3f} s")
    launches, err, checked, warm_ms = {}, 0, [], {}
    try:
        for q in DIST_QUERIES:
            want, single_ms = single[q]
            label = f"Q{q} SF{SF:g} distributed"
            base_mb = torch.cuda.memory_allocated() / 2**20
            torch.cuda.reset_peak_memory_stats()
            rec = Recorder(aggregate.smalldomain_sum_count)
            aggregate.smalldomain_sum_count = rec
            try:
                cold = dist_run(dctx, q)
            finally:
                aggregate.smalldomain_sum_count = rec.fn
            dist_check(f"{label} cold vs single-device", cold, q, want, q1_want, exp,
                       f"distributed x{DIST_PARTITIONS}")
            launches[f"distributed-q{q}"] = cold["k1"]
            if len(rec.calls) != cold["k1"]:
                raise AssertionError(f"{label}: {len(rec.calls)} K1 calls, {cold['k1']} launches")
            if q == 1:
                checked.append("distributed-q1-task-inputs")
                err = max(err, k1_check(checked[-1], *rec.args))
            del rec
            runs = []
            for i in range(DIST_WARM):
                runs.append(dist_run(dctx, q))
                dist_check(f"{label} warm run {i + 1} vs single-device", runs[-1], q, want, q1_want, exp,
                           f"distributed x{DIST_PARTITIONS}")
            peak_mb = torch.cuda.max_memory_allocated() / 2**20
            warm_ms[q] = statistics.median(r["ms"] for r in runs)
            w = runs[len(runs) // 2]
            log(f"[distributed] {name_power}: {label} {len(want)} rows equal the single-device rows "
                f"and the expected file's in the cold run and {DIST_WARM} warm runs"
                f"{' and the numpy oracle' if q == 1 else ''}; "
                f"{cold['stages']} stages, {cold['tasks']} tasks ({cold['scan_tasks']} scan); K1 launches "
                f"{cold['k1']} per run; cold {cold['ms']:.3f} ms, warm median {warm_ms[q]:.3f} ms (runs "
                f"{['%.3f' % r['ms'] for r in runs]}), single-device eager median {single_ms:.3f} ms "
                f"(x{warm_ms[q] / single_ms:.1f}); spill written {w['times'].get('write_bytes', 0)} B, read "
                f"{w['times'].get('read_bytes', 0)} B per run; warm medians: {dist_times(runs)} (stage, "
                f"write, read summed over tasks; sleeps summed over threads); peak memory {peak_mb:.1f} MiB "
                f"({peak_mb - base_mb:.1f} above the {base_mb:.1f} allocated before)")
        heavy = max(warm_ms, key=warm_ms.get)
        prof = profile_run(lambda: dist_run(dctx, heavy), top=12)
        log(f"[distributed] {name_power}: Q{heavy} (the most distributed time) profiled: "
            f"{prof['profiled_wall_ms']:.3f} ms wall, kernel time {prof['kernel_ms']:.3f} ms in "
            f"{prof['launches']} launches, device idle share {prof['idle_share']:.1%}; top kernels "
            f"(the executor threads' host operators are not in the trace):")
        for line in prof["top_kernels"]:
            log(f"[distributed]   {line}")
    finally:
        dctx.close()
    del dctx
    dctx = dist_context(tables, DIST_SHUFFLE_PARTITIONS, os.path.join(tmp, "p16"))
    try:
        for q in (1, 3):
            label = f"Q{q} SF{SF:g} distributed x{DIST_SHUFFLE_PARTITIONS}"
            runs = [dist_run(dctx, q) for _ in range(2)]
            for r, how in zip(runs, ("cold", "warm")):
                dist_check(f"{label} {how} vs single-device", r, q, single[q][0], q1_want, exp,
                           f"distributed x{DIST_SHUFFLE_PARTITIONS}")
            launches[f"distributed-x{DIST_SHUFFLE_PARTITIONS}-q{q}"] = runs[0]["k1"]
            log(f"[distributed] {name_power}: {label} equals the single-device rows and the expected "
                f"file's cold and warm; "
                f"{runs[0]['stages']} stages, {runs[0]['tasks']} tasks; K1 launches {runs[0]['k1']} per "
                f"run; cold {runs[0]['ms']:.3f} ms, warm {runs[1]['ms']:.3f} ms; spill written "
                f"{runs[1]['times'].get('write_bytes', 0)} B; {dist_times(runs[1:])}")
    finally:
        dctx.close()
    del dctx
    torch.cuda.empty_cache()
    return {k: n for k, n in launches.items() if n or k == "distributed-q1"}, err, checked


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rpc_proc(args: list, log_path: str, env: dict):
    with open(log_path, "wb") as f:
        return subprocess.Popen([sys.executable, "-m", RPC, *args], stdout=f, stderr=subprocess.STDOUT,
                                env=env, cwd=ROOT)


def _stop(procs: list) -> None:
    for p in procs:
        p.terminate()
    for p in procs:
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _log_tails(tmp: str) -> str:
    out = []
    for fn in sorted(os.listdir(tmp)):
        if fn.endswith(".log"):
            with open(os.path.join(tmp, fn), "rb") as f:
                out.append(f"--- {fn}:\n" + f.read()[-3000:].decode(errors="replace"))
    return "\n".join(out)


def rpc_query(client, ctx, q: int, dev, timeout_s: float = 300.0) -> tuple:
    """TPC-H query q planned on ``ctx`` and run by the cluster behind
    ``client``: (rows, ms)."""
    t0 = time.perf_counter()
    plan = ctx.optimize(ctx.create_logical_plan(get_query_sql(q)))
    job = client.execute_query(serde.plan_to_dict(plan))
    while True:
        status = client.get_job_status(job)
        if status["status"] == "COMPLETED":
            break
        if status["status"] == "FAILED":
            raise AssertionError(f"Q{q} job {job} failed: {status['error']}")
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"Q{q} job {job} did not finish in {timeout_s} s")
        time.sleep(0.005)
    out = shuffle_io.concat_read(status["final_paths"], status["final_schema"], dev)
    # unqualified display names, as DistributedContext returns them
    got = dict(zip([f.name for f in plan.schema().fields], out.to_pydict().values()))
    return got, (time.perf_counter() - t0) * 1e3


def dist_processes(name_power: str, ctx, tables: dict, single: dict, q1_want: dict, tmp: str,
                   exp: ExpectedRows) -> None:
    """Q1 and Q3 through a scheduler subprocess that sees no card and two
    executor subprocesses on the card, the tables in a spill directory;
    then Q3 through two executors over meshes of DIST_MESH_DEVICES
    shards."""
    dev = ctx.device
    work = os.path.join(tmp, "cluster")
    os.makedirs(work)
    port = _free_port()
    env = dict(os.environ, DFTPU_SPMD_STRICT="1")
    procs = []
    try:
        t0 = time.perf_counter()
        procs.append(_rpc_proc(["scheduler", "--port", str(port), "--work-dir", work, "--partitions",
                                str(DIST_PARTITIONS)], os.path.join(tmp, "scheduler.log"),
                               dict(env, CUDA_VISIBLE_DEVICES="")))
        client = None
        while client is None:
            try:
                client = RpcSchedulerClient(f"127.0.0.1:{port}")
                client.call("ping")
            except OSError:
                client = None
                if procs[0].poll() is not None or time.perf_counter() - t0 > 120:
                    raise AssertionError(f"the scheduler did not come up\n{_log_tails(tmp)}")
                time.sleep(0.1)
        for i in range(2):
            procs.append(_rpc_proc(["executor", "--scheduler", f"127.0.0.1:{port}", "--work-dir", work,
                                    "--id", f"exec-{i}"], os.path.join(tmp, f"exec{i}.log"), env))
        store = TableStore(spill_dir=os.path.join(work, "_tables"), device=dev)
        s0 = time.perf_counter()
        for name in DIST_SPILLED:
            store.put(name, tables[name])
        spill_s = time.perf_counter() - s0
        spill_b = sum(os.path.getsize(os.path.join(work, "_tables", f"{n}.dfs")) for n in DIST_SPILLED)
        for name, t in tables.items():
            client.register_table_schema(name, t.schema())
        log(f"[distributed] {name_power}: a scheduler subprocess (CUDA_VISIBLE_DEVICES empty) and 2 "
            f"executor subprocesses on the card over rpc.py; {', '.join(DIST_SPILLED)} spilled "
            f"({spill_b} B in {spill_s:.3f} s); up in {time.perf_counter() - t0:.3f} s")
        try:
            for q in (1, 3):
                runs = [rpc_query(client, ctx, q, dev) for _ in range(2)]
                for (got, _), how in zip(runs, ("cold", "warm")):
                    check_tpch(f"Q{q} multi-process {how} vs single-device", got, single[q][0],
                               q in FULLY_ORDERED)
                    exp.check("multi-process", q, got)
                    if q == 1:
                        check_q1(got, q1_want)
                log(f"[distributed] {name_power}: Q{q} SF{SF:g} multi-process equals the single-device "
                    f"rows and the expected file's cold and warm; cold {runs[0][1]:.3f} ms (the executors "
                    f"load the spilled "
                    f"tables), warm {runs[1][1]:.3f} ms; single-device eager {single[q][1]:.3f} ms")
            _stop(procs[1:])
            t0 = time.perf_counter()
            for i in range(2):
                procs.append(_rpc_proc(["executor", "--scheduler", f"127.0.0.1:{port}", "--work-dir",
                                        work, "--id", f"mesh-{i}", "--mesh-devices",
                                        str(DIST_MESH_DEVICES)], os.path.join(tmp, f"mesh{i}.log"), env))
            got, ms = rpc_query(client, ctx, 3, dev)
            check_tpch("Q3 multi-process mesh-slice vs single-device", got, single[3][0],
                       3 in FULLY_ORDERED)
            exp.check("multi-process mesh-slice", 3, got)
            log(f"[distributed] {name_power}: Q3 SF{SF:g} through 2 executor subprocesses with "
                f"--mesh-devices {DIST_MESH_DEVICES} (strict) equals the single-device rows and the "
                f"expected file's; "
                f"{ms:.3f} ms including their start and table loads "
                f"({(time.perf_counter() - t0) * 1e3:.3f} ms since they were started)")
        except Exception as e:
            raise AssertionError(f"{e}\n{_log_tails(tmp)}") from e
    finally:
        _stop(procs)


def phase_distributed(name_power: str, ctx, single: dict, q1_want: dict, exp: ExpectedRows) -> tuple:
    """Phase 14 (see the module docstring).  Nothing else runs beside the
    executor threads (distributed/executor.py): the tables are collected
    from ``ctx`` before the first executor starts, and ``ctx`` only plans
    while they run.  Returns (K1 launches per path, max abs error, the
    names of the inputs K1 was checked at)."""
    with path("eager"):  # a scan, node by node: no check or capture
        tables = {name: ctx.table(name).collect() for name in ctx.tables()}
    with tempfile.TemporaryDirectory() as tmp:
        launches, err, checked = dist_standalone(name_power, tables, single, q1_want, tmp, exp)
        dist_processes(name_power, ctx, tables, single, q1_want, tmp, exp)
    return launches, err, checked


# ---------------------------------------------------------------------------
# phase 15: the CLI
# ---------------------------------------------------------------------------

SQL_TYPES = {"int64": "BIGINT", "int32": "INT", "string": "VARCHAR", "date32": "DATE"}


def cli_script(csv: str) -> tuple:
    """The DDL that registers the lineitem CSV, and the script: the DDL,
    Q1 and Q6."""
    cols = ", ".join(f"{f.name} {SQL_TYPES.get(f.dtype.kind) or 'DECIMAL(15,2)'}"
                     for f in lineitem_tbl_schema().fields)
    ddl = f"CREATE EXTERNAL TABLE lineitem ({cols}) STORED AS CSV LOCATION '{csv}'"
    return ddl, ";\n".join([ddl, *FILE_QUERIES.values()]) + ";\n"


def cli_check(tmp: str, tbl: str, device=None) -> list:
    """The .tbl file rewritten as a CSV, the CLI run on a script over it as
    a subprocess (on ``device``: None is the card, "cpu" adds --cpu), and
    its JSON lines against the same statements' output here.  Returns
    printable lines."""
    csv = os.path.join(tmp, "lineitem.csv")
    raw = np.fromfile(tbl, np.uint8)
    raw[raw == ord("|")] = ord(",")
    raw.tofile(csv)
    ddl, script = cli_script(csv)
    path = os.path.join(tmp, "q1_q6.sql")
    with open(path, "w") as f:
        f.write(script)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "datafusion_tpu_torch.cli", "--format", "json", "-f", path,
                           *(["--cpu"] if device == "cpu" else [])],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
    got = [line for line in proc.stdout.splitlines() if line.startswith("[")]
    took = [line for line in proc.stdout.splitlines() if "rows in set" in line]
    ctx = ExecutionContext(device=device)
    ctx.sql(ddl)
    want = []
    for q in FILE_QUERIES.values():
        buf = io.StringIO()
        print_result(ctx.sql(q).collect(), "json", file=buf)
        want.append(buf.getvalue().strip())
    if got != want:
        raise AssertionError(f"the CLI's JSON {got} != in-process {want}")
    rows = [len(json.loads(g)) for g in got]
    return [f"python -m datafusion_tpu_torch.cli --format json -f <CREATE EXTERNAL TABLE over the SF{SF:g} "
            f"lineitem as CSV; {', '.join(FILE_QUERIES)}>: {secs:.3f} s as a subprocess; its JSON "
            f"({rows} rows) equals the in-process output; the CLI printed {took}"]


def phase_cli(name_power: str, tmp: str) -> None:
    for line in cli_check(tmp, os.path.join(tmp, "lineitem.tbl")):
        log(f"[cli] {name_power}: {line}")


# ---------------------------------------------------------------------------
# phase 16: TPC-H at SF10, sf_check's nine queries, host- and device-resident
# ---------------------------------------------------------------------------

SF10 = 10.0
SF10_QUERIES = (1, 3, 5, 6, 7, 9, 10, 12, 18)  # bench/sf_check.py's set
SF10_HOST_TABLES = ("lineitem", "orders")  # sf_check's --host-tables
SF10_WARM = 2  # warm host-resident collects per query after the cold one
SF10_BATCHES = 1  # device-resident: rounds of 5 warm runs per path
# K1 host-resident: once per morsel of the table Q1's stage and Q12's join
# stage stream
SF10_K1_HOST = {1: "lineitem", 12: "orders"}
# the JAX package's rows of the nine queries at SF10, seed 7, lineitem and
# orders host-resident (tests/torch_expected_sf10.py writes it)
SF10_EXPECTED_FILE = ROOT / "tests" / "data" / "torch_tpch_sf10_seed7.json.gz"


class Peak:
    """The card's peak allocation over a phase, across the per-run peak
    resets of its measurements."""

    def __init__(self):
        torch.cuda.reset_peak_memory_stats()
        self.mb = 0.0

    def reset(self) -> float:
        """The peak since the last reset (MiB); starts a new window."""
        mb = torch.cuda.max_memory_allocated() / 2**20
        self.mb = max(self.mb, mb)
        torch.cuda.reset_peak_memory_stats()
        return mb


def live_cuda(top: int = 5) -> str:
    """What is still allocated on the card: MiB, and the largest storages
    still referenced by a live tensor (shape and dtype of one tensor on
    each)."""
    import gc

    storages = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            storages.setdefault(st.data_ptr(), (st.nbytes(), tuple(o.shape), str(o.dtype)))
    big = sorted(storages.values(), reverse=True)[:top]
    return (f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated, "
            f"{sum(b for b, _, _ in storages.values()) / 2**20:.1f} MiB in {len(storages)} storages "
            f"that Python tensors reference; largest {[(f'{b / 2**20:.1f} MiB', sh, dt) for b, sh, dt in big]}")


def k1_checked(rec_calls, tag: str, checked: list) -> int:
    """K1 against its plain version at each recorded call's inputs."""
    err = 0
    for i, args in enumerate(rec_calls):
        checked.append(f"{tag}-{i}")
        err = max(err, k1_check(checked[-1], *args))
    return err


def sf10_host(name_power: str, tables: dict, exp: ExpectedRows, peak: Peak) -> tuple:
    """sf_check's configuration: lineitem and orders pinned in host memory
    and streamed in morsels of 2^20 rows, the other six tables on the card.
    Each query cold and in SF10_WARM warm collects, every one against the
    expected file, and each plan streams and materializes the host tables
    as the JAX package's plan does (the file's ``host_scans``); K1 once per
    lineitem morsel in Q1 and once per orders morsel in Q12, held against
    its plain version at the first and the last (partial) morsel's
    inputs.  Returns (K1 launches per query, max abs err, inputs checked)."""
    t0 = time.perf_counter()
    ctx = ExecutionContext()
    for name, t in tables.items():
        if name in SF10_HOST_TABLES:
            ctx.register_host_table(name, HostTable.from_table(t, MORSEL_ROWS, ctx.device))
        else:
            ctx.register_table(name, t.to(ctx.device))
    torch.cuda.synchronize()
    hosts = {n: ctx._resolve_table(n).host for n in SF10_HOST_TABLES}
    base_mb = torch.cuda.memory_allocated() / 2**20
    log(f"[sf10] host-resident: " + "; ".join(
        f"{n} {h.nrows} rows, {h.num_morsels} morsels of {h.morsel_rows}, {h.nbytes / 2**30:.3f} GiB "
        f"pinned in {h.pin_seconds:.3f} s" for n, h in hosts.items())
        + f"; the other six tables {base_mb:.1f} MiB on the card; set up in {time.perf_counter() - t0:.3f} s")
    err, checked, launches = 0, [], {}
    for q in SF10_QUERIES:
        label = f"Q{q} SF{SF10:g} host-resident"
        rec = EndsRecorder(aggregate.smalldomain_sum_count)
        aggregate.smalldomain_sum_count = rec
        try:
            SD.smalldomain_sum_count.launches = 0
            t0 = time.perf_counter()
            with TakeRecorder(f"sf10-q{q}-host"):
                got = run_tpch(ctx, q).to_pydict()
            cold = (time.perf_counter() - t0) * 1e3
            k1 = SD.smalldomain_sum_count.launches
        finally:
            aggregate.smalldomain_sum_count = rec.fn
        exp.check("host-resident cold", q, got)
        plan = last_plan(ctx)
        scans = expected.host_scans(plan)
        if scans != exp.doc["host_scans"][str(q)]:
            raise AssertionError(f"{label}: the plan reads its host tables as {scans}, the JAX "
                                 f"package's as {exp.doc['host_scans'][str(q)]}")
        if q in SF10_K1_HOST:
            streamed = hosts[SF10_K1_HOST[q]]
            if k1 != streamed.num_morsels:
                raise AssertionError(f"{label}: K1 launched {k1} times, want once per "
                                     f"{SF10_K1_HOST[q]} morsel ({streamed.num_morsels})")
            err = max(err, k1_checked(rec.calls, f"sf10-q{q}-host-first-and-last-morsel-inputs", checked))
        launches[f"sf10-q{q}-host-resident-cold"] = k1
        del rec, got
        times, morsels, syncs, peaks = [], [], [], []
        for _ in range(SF10_WARM):
            m0, s0 = morsels_run(plan), HOST_SYNCS[0]
            peak.reset()
            t0 = time.perf_counter()
            res = run_tpch(ctx, q)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            syncs.append(HOST_SYNCS[0] - s0)
            peaks.append(peak.reset() - base_mb)
            morsels.append(morsels_run(plan) - m0)
            exp.check("host-resident warm", q, res.to_pydict())
        del res
        log(f"[sf10] {name_power}: {label}: the cold run and {SF10_WARM} warm collects give the expected "
            f"file's rows; host scans as the JAX package's plan: {scans}; morsels per collect {morsels}; K1 launches {k1}; cold "
            f"{cold:.3f} ms; warm median {statistics.median(times):.3f} ms (runs "
            f"{['%.3f' % t for t in times]}); host syncs per collect {syncs}; peak device memory "
            f"{max(peaks):.1f} MiB above the {base_mb:.1f} MiB of tables; "
            f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated after the query")
    for n, h in hosts.items():
        if h._materialized is not None:
            log(f"[sf10] {name_power}: {n} was materialized on the card once, "
                f"{sum(c.data.nbytes + c.valid.nbytes for c in h._materialized.columns) / 2**20:.1f} MiB")
    del ctx, hosts, plan
    torch.cuda.empty_cache()
    return launches, err, checked


def sf10_device(name_power: str, tables: dict, exp: ExpectedRows, peak: Peak) -> tuple:
    """All eight SF10 tables on the card.  Per query: the cold run (learning
    capacities), the check (speculative, host reads refused), the capture
    and first replay of its CUDA graph, one eager and one exact collect,
    each against the expected file; K1 against its plain version at every
    call's inputs, captured ones included; warm medians of the three paths
    in turns, syncs, decode, the pool and the peak.  Returns (K1 launches
    per query, max abs err, inputs checked, Q1's K1 inputs)."""
    t0 = time.perf_counter()
    ctx = ExecutionContext()
    for name, t in tables.items():
        ctx.register_table(name, t.to(ctx.device))
    torch.cuda.synchronize()
    base_mb = torch.cuda.memory_allocated() / 2**20
    log(f"[sf10] device-resident: eight tables, {base_mb:.1f} MiB on the card; uploaded in "
        f"{time.perf_counter() - t0:.3f} s")
    err, checked, launches, q1_args = 0, [], {}, None
    for q in SF10_QUERIES:
        label = f"Q{q} SF{SF10:g} device-resident"
        peak.reset()
        path_k2 = f"sf10-q{q}-device"
        k2 = [TakeRecorder(path_k2, check=True) for _ in range(3)]  # cold, check, capture
        got, k1, rec, cold = run_recorded(ctx, q, k2[0])
        cold_peak = peak.reset() - base_mb
        exp.check("cold", q, got)
        if (k1 > 0) != (q in TPCH_K1_QUERIES):
            raise AssertionError(f"{label}: K1 launched {k1} times")
        err = max(err, k1_checked(rec.calls, f"sf10-q{q}-device-inputs", checked))
        if q == 1:
            q1_args = rec.calls[0]
        launches[f"sf10-q{q}-device-cold"] = k1
        del rec, got
        rows, _, _, check_s = run_recorded(ctx, q, k2[1])
        exp.check("check", q, rows)
        rows, glaunches, grec, capture_s = run_recorded(ctx, q, k2[2])
        exp.check("replay", q, rows)
        for r in k2:
            r.check_captured()
        wq = whole_query(ctx)
        if wq is not None and wq.failure is not None and wq.failure[0] != "guard":
            raise AssertionError(f"{label}: the whole-query build failed outside the guard: {wq.failure}")
        recorded = 0
        if wq is not None and wq.graph is not None:
            recorded = len(grec.calls) - glaunches
            if glaunches or (recorded > 0) != (q in TPCH_K1_QUERIES):
                raise AssertionError(f"{label}: the capture launched K1 {glaunches} times and "
                                     f"recorded {recorded} calls")
            err = max(err, k1_checked(grec.calls, f"sf10-q{q}-device-captured-inputs", checked))
        del grec, rows
        runs = warm_paths(lambda: run_tpch(ctx, q).to_pydict(), SF10_BATCHES)
        for p in ("eager", "exact"):
            with path(p), TakeRecorder(path_k2, check=True) as k2_run:
                exp.check(p, q, run_tpch(ctx, q).to_pydict())
            k2.append(k2_run)
        if (wq is not None and wq.graph is not None and k2[2].launches) or any(r.checked != r.calls for r in k2):
            raise AssertionError(f"{label}: K2 launches {[r.launches for r in k2]} (cold, check, capture, "
                                 f"eager, exact), calls {[r.calls for r in k2]}, checked "
                                 f"{[r.checked for r in k2]}; want none launched by the capture and "
                                 f"every call checked")
        syncs = warm_syncs(lambda: run_tpch(ctx, q), lambda t: t.to_pydict())
        dec = decode_ms(lambda: run_tpch(ctx, q))
        peak.reset()
        run_tpch(ctx, q).to_pydict()
        torch.cuda.synchronize()
        warm_peak = peak.reset() - base_mb
        log(f"[sf10] {name_power}: {label}: the cold run, the check, the replay and an eager and an "
            f"exact collect give the expected file's rows; {graph_state(wq)}; K1 launches cold {k1}, "
            f"recorded by the capture {recorded}; K2 launches {[r.launches for r in k2]} (cold, check, "
            f"capture, eager, exact), {sum(r.recorded for r in k2)} recorded by the capture, equal to "
            f"its plain version bit for bit at all {sum(r.checked for r in k2)} calls' inputs (the captured ones "
            f"after the replay; the checks run inside the cold run and the check); "
            f"cold {cold * 1e3:.3f} ms, check {check_s * 1e3:.3f} ms, "
            f"capture and replay {capture_s * 1e3:.3f} ms; {medians(runs)}; host syncs per warm run "
            f"{syncs[0]} (+{syncs[1]} to decode); decode {dec:.3f} ms; peak device memory above the "
            f"tables: cold run {cold_peak:.1f} MiB, warm run {warm_peak:.1f} MiB; "
            f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated after the query")
    log(f"[memory] {name_power}: sf10 device-resident, {graphs_held(ctx)}")
    del ctx
    torch.cuda.empty_cache()
    return launches, err, checked, q1_args


def phase_sf10(name_power: str) -> tuple:
    """sf_check's nine TPC-H queries at SF10, seed 7, against the JAX
    package's rows (SF10_EXPECTED_FILE): the generated tables must have
    the file's digests; then host-resident (``sf10_host``) and
    device-resident (``sf10_device``), each context released before the
    next; K1 timed at device-resident Q1's inputs beside its byte bound.
    Returns (K1 launches per path, max abs err, inputs checked, K1's SF10
    timing)."""
    t_phase = time.perf_counter()
    log(f"[sf10] {name_power}: left on the card by the earlier phases: {live_cuda()}")
    peak = Peak()
    exp = ExpectedRows(SF10_EXPECTED_FILE)
    t0 = time.perf_counter()
    data = tpchdata.generate_tpch(SF10, SEED)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exp.check_tables(data)
    digest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tables = {name: tpchdata.tpch_table(cols, "cpu") for name, cols in data.items()}
    nrows = {name: t.nrows for name, t in tables.items()}
    del data
    log(f"[sf10] SF{SF10:g} seed {SEED}: generated in {gen_s:.3f} s; the tables have the expected file's "
        f"digests (checked in {digest_s:.3f} s); encoded on the host in {time.perf_counter() - t0:.3f} s; "
        f"rows {nrows}")
    host_launches, err, checked = sf10_host(name_power, tables, exp, peak)
    log(f"[sf10] {name_power}: the host-resident context released: {live_cuda()}")
    dev_launches, dev_err, dev_checked, args = sf10_device(name_power, tables, exp, peak)
    del tables
    err = max(err, dev_err)
    checked += dev_checked
    kname = "smalldomain_sum_count_kernel"
    ms, kept = kernel_only_ms(lambda: SD.smalldomain_sum_count(*args), kname, 100)
    timing = {"N": args[0].shape[0], "domain": args[3], "k": len(args[1]), "ms": ms, "launches_kept": kept,
              "bound_ms": k1_bound_ms(*args), "plain_ms": cuda_ms(lambda: SD.smalldomain_sum_count_plain(*args), 2),
              "library_ms": cuda_ms(k1_library_call(*args), 2)}
    log(f"[timing] {name_power}: smalldomain_sum_count at Q1 SF{SF10:g} device-resident (N={timing['N']}, "
        f"domain={timing['domain']}, k={timing['k']}): {ms:.4f} ms kernel alone (torch.profiler, {kept} of "
        f"100 launches); byte bound {timing['bound_ms']:.4f} ms ({timing['bound_ms'] / ms:.1%} of bound); "
        f"plain {timing['plain_ms']:.4f} ms; index_add_ {timing['library_ms']:.4f} ms")
    del args
    torch.cuda.empty_cache()
    exp.require({p: SF10_QUERIES for p in ("host-resident cold", "host-resident warm", "cold", "check",
                                           "replay", "eager", "exact")})
    log(exp.line(name_power))
    log(f"[sf10] {name_power}: peak device memory over the phase {max(peak.mb, peak.reset()):.1f} MiB; "
        f"the phase took {time.perf_counter() - t_phase:.3f} s")
    return {**host_launches, **dev_launches}, err, checked, timing


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    name_power = card()
    log(f"[device] {name_power}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t_main = time.perf_counter()
    secs = build_all()
    for k, s in secs.items():
        log(f"[build] {k}: {s:.3f} s")
        for line in BUILD_LOG.get(k, "").splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
        log(f"[build]   SASS: {sass_ops(k)}")

    err = phase_kernels()
    t_phase = phase_done("build and kernels", t_main)
    take_timing = phase_take(name_power)
    t_phase = phase_done("take", t_phase)

    sql = get_query_sql(1)
    ctx, launches, args, captured = phase_main(sql, name_power)
    err = max(err, k1_check("q1-main-path-inputs", *args))
    err = max(err, k1_check("q1-main-path-captured-inputs", *captured))
    del captured

    runs = warm_runs(lambda: ctx.sql(sql).collect().to_pydict(), Q1_BATCHES)
    log(f"[timing] {name_power}: Q1 SF{SF} {spread(runs)}; runs {['%.3f' % r for r in runs]}")

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
    del ctx, args  # the Q1 table and K1's inputs: the sql phase measures memory
    torch.cuda.empty_cache()
    t_phase = phase_done("main and timing", t_phase)

    sql_launches, sql_err, sql_checked = phase_sql(name_power)
    err = max(err, sql_err)
    t_phase = phase_done("sql", t_phase)
    with TakeRecorder("f4"):
        phase_f4(name_power)
    t_phase = phase_done("f4", t_phase)
    exp = ExpectedRows()
    tpch_launches, tpch_err, tpch_checked, ctx, single, q1_want = phase_tpch(name_power, exp)
    err = max(err, tpch_err)
    sql_checked += tpch_checked
    t_phase = phase_done("tpch and window", t_phase)
    mesh_launches = phase_mesh(name_power, ctx, single, q1_want, exp)
    t_phase = phase_done("mesh", t_phase)
    dist_launches, dist_err, dist_checked = phase_distributed(name_power, ctx, single, q1_want, exp)
    err = max(err, dist_err)
    sql_checked += dist_checked
    del ctx, single
    torch.cuda.empty_cache()
    t_phase = phase_done("distributed", t_phase)
    morsel_launches, morsel_err, morsel_checked = phase_morsel(name_power)
    err = max(err, morsel_err)
    sql_checked += morsel_checked
    t_phase = phase_done("morsel", t_phase)
    phase_morsel_tpch(name_power, exp)
    t_phase = phase_done("morsel-tpch", t_phase)
    with tempfile.TemporaryDirectory() as tmp:
        with TakeRecorder("files"):
            phase_files(name_power, tmp)
        t_phase = phase_done("files", t_phase)
        with TakeRecorder("cli"):
            phase_cli(name_power, tmp)
        t_phase = phase_done("cli", t_phase)
    exp.require({
        **{p: TPCH_QUERIES for p in ("cold", "check", "replay", "eager", "exact", "mesh cold",
                                     "mesh last warm", "host-resident lineitem")},
        f"distributed x{DIST_PARTITIONS}": DIST_QUERIES,
        f"distributed x{DIST_SHUFFLE_PARTITIONS}": (1, 3),
        "multi-process": (1, 3),
        "multi-process mesh-slice": (3,),
        "mesh host-resident lineitem": (1,),
    })
    log(exp.line(name_power))
    sf10_launches, sf10_err, sf10_checked, sf10_timing = phase_sf10(name_power)
    err = max(err, sf10_err)
    sql_checked += sf10_checked
    phase_done("sf10", t_phase)
    log(f"[phase] all phases: {time.perf_counter() - t_main:.3f} s")
    by_path = {"q1": launches, **sql_launches, **{k: n for k, n in tpch_launches.items() if n},
               "q1-sf10-host-resident-collect": morsel_launches, **mesh_launches, **dist_launches,
               **{k: n for k, n in sf10_launches.items() if n}}

    kernels = [{
        "name": "smalldomain_sum_count",
        "route": "cuda",
        "source": "datafusion_tpu_torch/csrc/smalldomain_sum_count.cu",
        "replaces": "datafusion_tpu/ops/pallas_kernels.py:167",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": err,
        "ms": ms,
        "ms_launches_kept": kept,
        "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "sf10_q1_device": sf10_timing,
        "checked_against_plain": True,
        "checked_at": ["K1_CASES", "q1-main-path-inputs", "q1-main-path-captured-inputs",
                       *sql_checked],
    }]
    # K2 on every device path: each phase that collects on the card moves rows
    k2_phases = {k: n for k, n in K2_BY_PHASE.items() if k not in ("build and kernels", "take")}
    idle = sorted(k for k, n in K2_BY_PATH.items() if not n)
    log(f"[take] {name_power}: K2 launched {sum(K2_BY_PATH.values())} times on {len(K2_BY_PATH)} paths "
        f"(per phase {K2_BY_PHASE}); paths that moved no rows on the card: {idle}; held against its "
        f"plain version at every call of {K2_CHECKED}")
    if not all(k2_phases.values()) or not K2_CHECKED.get("q1"):
        raise AssertionError(f"K2 never launched in a phase that collects on the card: {k2_phases}")
    kernels.append({
        "name": "take",
        "route": "cuda",
        "source": "datafusion_tpu_torch/csrc/take.cu",
        "replaces": None,
        "launches": sum(K2_BY_PATH.values()),
        "launches_by_path": dict(K2_BY_PATH),
        "bound_by": "bytes",
        "sf10_shapes": take_timing,
        "checked_against_plain": True,
        "checked_at": [*take_timing, *(f"{k}: {n} calls" for k, n in K2_CHECKED.items())],
    })
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
