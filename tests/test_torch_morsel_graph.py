"""CUDA graphs of a morsel loop's per-morsel work (``physical/morsel.py``)
on the card: tests marked ``gpu``, skipped where there is none.  On the
card, without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_morsel_graph.py

TPC-H Q1, Q12 and Q18 at SF 0.05 with lineitem and orders host-resident in
morsels of 2^14 rows (19 and 5 morsels, each table's last one short): a
warm collect runs each loop's first morsel node by node, captures the
second and replays the graph for the rest, and its rows are those of the
cold, node by node collect, bit for bit, and of the device-resident
tables.  The counters say which morsels replayed, only while the tracer is
on.  A learned capacity shrunk under the replayed morsels' need reruns
the query exactly; a capture that fails finishes the loop node by node
and is counted, and after three failures the loop stops trying."""

import numpy as np
import pytest
import torch

from datafusion_tpu_torch import ExecutionContext, tpchdata, tracing
from datafusion_tpu_torch.columnar.table import BUILD, Table
from datafusion_tpu_torch.physical import morsel as M
from datafusion_tpu_torch.queries import run_tpch

MORSEL = 1 << 14


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tpch():
    return tpchdata.generate_tpch(0.05, 7)


def _contexts(data):
    """(device-resident context, context with lineitem and orders
    host-resident) on the card."""
    dctx = ExecutionContext()
    tpchdata.register_tpch(dctx, data)
    hctx = ExecutionContext()
    tpchdata.register_tpch(hctx, data)
    for name in ("lineitem", "orders"):
        hctx.register_host_table(name, tpchdata.tpch_table(data[name], "cpu"), morsel_rows=MORSEL)
    return dctx, hctx


def _loops(ctx) -> list:
    """The morsel nodes of the context's cached plans."""
    out, seen = [], set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        if isinstance(n, (M.MorselStageExec, M.MorselJoinStageExec)):
            out.append(n)
        for c in [*n.children(), *([n._source] if hasattr(n, "_source") else [])]:
            walk(c)

    for plan in ctx._plan_cache.values():
        walk(plan)
    return out


def _traced(fn):
    """``fn()`` with the tracer on: (its result, counters by name, spans)."""
    tracing.drain()
    tracing.enable()
    try:
        out = fn()
    finally:
        tracing.disable()
    rec = tracing.drain()
    counts = {}
    for (_, name), n in rec.counters.items():
        counts[name] = counts.get(name, 0) + n
    return out, counts, rec.spans


def _same_rows(got: dict, want: dict) -> bool:
    """Equal rows, floats within rel 1e-12 of max(|want|, 1): the morsels'
    partial means of Q1 may differ from one device-resident pass in the
    last bit."""
    return list(got) == list(want) and all(
        len(got[c]) == len(want[c]) and all(
            a == b or (isinstance(b, float) and abs(a - b) <= 1e-12 * max(abs(b), 1.0))
            for a, b in zip(got[c], want[c]))
        for c in want)


@pytest.mark.gpu
@pytest.mark.parametrize("q", [1, 12, 18])
def test_replayed_collects_equal_node_by_node_and_device(cuda, tpch, q):
    dctx, hctx = _contexts(tpch)
    want = run_tpch(hctx, q).to_pydict()  # cold: node by node
    assert _same_rows(want, run_tpch(dctx, q).to_pydict())
    loops = _loops(hctx)
    sizes = [n.host.num_morsels for n in loops]
    assert loops and all(s >= 4 and n.host.nrows % MORSEL for s, n in zip(sizes, loops))
    got, c, spans = _traced(lambda: [run_tpch(hctx, q).to_pydict() for _ in range(2)])
    assert got == [want, want]
    assert "dftpu.collect.rerun" not in c
    assert c["dftpu.morsel.eager"] == 2 * len(loops)
    assert c["dftpu.morsel.replayed"] == 2 * sum(s - 1 for s in sizes)
    assert all(n.capture_failures == 0 for n in loops)
    # one capture per loop and collect, inside a morsel's span
    ids = {s.id: s for s in spans}
    caps = [s for s in spans if s.name == "dftpu.morsel.capture"]
    assert len(caps) == 2 * len(loops) and {ids[s.parent].name for s in caps} == {"dftpu.morsel"}
    # the tracer off: the same rows, nothing recorded
    assert run_tpch(hctx, q).to_pydict() == want
    assert tracing.drain() == tracing.Records([], {})


def _skewed_host_context():
    """A host table of 5 morsels of 2^14 rows (the last short) whose first
    morsel passes 10 rows of ``WHERE f > 0`` and the others every row, on
    the card and on the CPU; the query groups by a unique key, so each
    morsel's partial aggregate holds one group per row it passes."""
    n = 5 * MORSEL - 5000
    rng = np.random.default_rng(5)
    f = np.ones(n, np.int64)
    f[10:MORSEL] = 0
    data = {"k": np.arange(n, dtype=np.int64), "f": f, "v": rng.integers(-1000, 1000, n)}
    out = []
    for dev in (None, "cpu"):
        ctx = ExecutionContext(device=dev)
        ctx.register_host_table("t", Table.from_pydict(data, device="cpu"), morsel_rows=MORSEL)
        out.append(ctx)
    return out


SKEWED = "SELECT k, sum(v) AS s FROM t WHERE f > 0 GROUP BY k ORDER BY k"


@pytest.mark.gpu
def test_capacity_shrunk_under_replayed_morsels_reruns_exactly(cuda):
    ctx, cpu = _skewed_host_context()
    want = cpu.sql(SKEWED).collect().to_pydict()
    for _ in range(2):  # cold (the later morsels overflow the first's capacity), warm
        assert ctx.sql(SKEWED).collect().to_pydict() == want
    (node,) = _loops(ctx)
    caps = node.stage._learned_caps
    assert caps and all(v == MORSEL for v in caps.values())
    for key in caps:
        caps[key] = 4096  # the first morsel's 10 groups fit, the others' do not
    got, c, _ = _traced(lambda: ctx.sql(SKEWED).collect().to_pydict())
    assert got == want
    # the speculative run: morsel 0 node by node, 1-4 replayed and flagged;
    # then the exact rerun, node by node
    assert c["dftpu.collect.rerun"] == 1
    assert c["dftpu.morsel.replayed"] == 4 and c["dftpu.morsel.eager"] == 1 + 5
    assert all(v == MORSEL for v in caps.values())


@pytest.mark.gpu
def test_failed_capture_finishes_node_by_node_and_counts(cuda, monkeypatch):
    ctx, cpu = _skewed_host_context()
    want = cpu.sql(SKEWED).collect().to_pydict()
    for _ in range(2):
        assert ctx.sql(SKEWED).collect().to_pydict() == want
    (node,) = _loops(ctx)
    execute = node.stage.execute

    def reads_the_host(*a, **kw):
        out = execute(*a, **kw)
        if BUILD.active:
            out.nrows  # a host read: refused inside a capture
        return out

    monkeypatch.setattr(node.stage, "execute", reads_the_host)
    # three collects try and fail; then the loop no longer tries
    assert M.MAX_CAPTURE_FAILURES == 3
    for failures, tried in ((1, 1), (2, 1), (3, 1), (3, 0)):
        got, c, spans = _traced(lambda: ctx.sql(SKEWED).collect().to_pydict())
        assert got == want
        assert c["dftpu.morsel.eager"] == 5 and "dftpu.morsel.replayed" not in c
        assert node.capture_failures == failures
        assert "HostReadInWholeQuery" in node.capture_failure
        assert sum(s.name == "dftpu.morsel.capture" for s in spans) == tried
