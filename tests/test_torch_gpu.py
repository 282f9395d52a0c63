"""Tests of the torch port that need a CUDA card (marked ``gpu``).

Where there is no card the ``cuda`` fixture skips them.  On the card,
without JAX (tests/conftest.py imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

They check kernel K1 against its plain PyTorch version at TPC-H Q1's
shapes and at edge cases (exact equality), among them every case of
``K1_CASES`` (``datafusion_tpu_torch/ops/smalldomain_cases.py``, which
``chip_smoke.py`` runs too); Q1 and the lineitem-only queries on the card
against the same queries on the CPU; and that on the card Q1 and the
small-domain GROUP BY launched K1, and the sort-path queries did not;
that a host table's pinned, side-stream morsel copies equal synchronous
uploads, that a warm morsel loop makes no host sync and launches K1 once
per morsel, that the native CSV/TBL loader is built and used, and that
the mesh places its shards on the cards and runs Q1 over 8 shards without
K1; that a standalone distributed cluster on the card gives the single
device's Q1 rows and launches K1 once per scan task, and that a spill
file written from the card holds the CPU's bytes.
"""

import numpy as np
import pytest
import torch

from datafusion_tpu_torch import ExecutionContext
from datafusion_tpu_torch.ops import smalldomain as SD
from datafusion_tpu_torch.ops.smalldomain_cases import K1_CASES
from datafusion_tpu_torch.q1data import generate_lineitem, generate_lineitem_q1
from datafusion_tpu_torch.queries import NAMED_QUERIES, get_named_query, get_query_sql


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, n, domain, k, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    gid = rng.integers(-1, domain + 1, n).astype(np.int32)  # -1, domain: dead
    cols = [torch.from_numpy(rng.integers(lo, hi, n, dtype=np.int64)).to(dev) for _ in range(k)]
    masks = [torch.from_numpy(rng.random(n) > 0.1).to(dev) for _ in range(k)]
    if k > 1:
        cols[-1], masks[-1] = None, None  # count(*)
        masks[0] = None
    return torch.from_numpy(gid).to(dev), cols, masks


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,domain,k,lo,hi",
    [
        (8_388_608, 12, 8, 0, 10**9),  # Q1 at SF1
        (1 << 20, 256, 8, -(10**14), 10**14),
        (1 << 20, 5, 3, (1 << 62) - 1000, 1 << 62),  # wraps
        (1_000_003, 7, 4, -1000, 1000),  # not a multiple of the block
        (0, 4, 2, 0, 10),
    ],
)
def test_k1_kernel_equals_plain(cuda, n, domain, k, lo, hi):
    gid, cols, masks = _inputs(cuda, n, domain, k, lo, hi)
    before = SD.smalldomain_sum_count.launches
    s, c = SD.smalldomain_sum_count(gid, cols, masks, domain)
    torch.cuda.synchronize()
    ps, pc = SD.smalldomain_sum_count_plain(gid, cols, masks, domain)
    assert torch.equal(s, ps) and torch.equal(c, pc)
    assert SD.smalldomain_sum_count.launches == before + (1 if n else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(K1_CASES))
def test_k1_smoke_cases_equal_plain(cuda, name):
    args = K1_CASES[name](np.random.default_rng(1))
    before = SD.smalldomain_sum_count.launches
    s, c = SD.smalldomain_sum_count(*args)
    torch.cuda.synchronize()
    ps, pc = SD.smalldomain_sum_count_plain(*args)
    assert torch.equal(s, ps) and torch.equal(c, pc)
    assert SD.smalldomain_sum_count.launches == before + 1


@pytest.mark.gpu
def test_k1_all_dead(cuda):
    gid = torch.full((65_536,), 9, dtype=torch.int32, device=cuda)
    col = torch.ones(65_536, dtype=torch.int64, device=cuda)
    s, c = SD.smalldomain_sum_count(gid, [col], [None], 4)
    assert int(s.abs().sum()) == 0 and int(c.sum()) == 0


@pytest.mark.gpu
def test_k1_refuses_what_it_does_not_take(cuda):
    gid, cols, masks = _inputs(cuda, 1000, 300, 2, 0, 10)
    with pytest.raises(ValueError):
        SD.smalldomain_sum_count(gid, cols, masks, 300)  # domain > 256
    with pytest.raises(ValueError):
        SD.smalldomain_sum_count(gid.long(), cols, masks, 4)  # int64 gid
    with pytest.raises(ValueError):
        SD.smalldomain_sum_count(gid, [cols[0]] * 9, [None] * 9, 4)  # k > 8
    with pytest.raises(ValueError):
        SD.smalldomain_sum_count(gid, [cols[0][:500]], [None], 4)  # wrong length
    with pytest.raises(ValueError):
        strided = torch.stack([cols[0], cols[0]], dim=1)[:, 0]
        SD.smalldomain_sum_count(gid, [strided], [None], 4)  # not contiguous


@pytest.mark.gpu
def test_q1_on_card_matches_cpu_and_launches_k1(cuda):
    sql = get_query_sql(1)
    cpu = ExecutionContext(device="cpu")
    cpu.register_table("lineitem", generate_lineitem_q1(0.01, device="cpu"))
    gpu = ExecutionContext()  # device=None: the card
    assert gpu.device.type == "cuda"
    gpu.register_table("lineitem", generate_lineitem_q1(0.01))
    SD.smalldomain_sum_count.launches = 0
    got = gpu.sql(sql).collect().to_pydict()
    assert SD.smalldomain_sum_count.launches > 0
    assert got == cpu.sql(sql).collect().to_pydict()


@pytest.mark.gpu
@pytest.mark.parametrize("name", NAMED_QUERIES)
def test_named_queries_on_card_match_cpu(cuda, name):
    """SF 0.1: l_suppkey spans 1,000 values, so only `linenumber` takes the
    small-domain path.  Keys, counts and sums equal the CPU's; floats
    (avg_price) within rel 1e-12."""
    sql = get_named_query(name)
    cpu = ExecutionContext(device="cpu")
    cpu.register_table("lineitem", generate_lineitem(0.1, device="cpu"))
    gpu = ExecutionContext()
    gpu.register_table("lineitem", generate_lineitem(0.1))
    SD.smalldomain_sum_count.launches = 0
    got = gpu.sql(sql).collect().to_pydict()
    assert (SD.smalldomain_sum_count.launches > 0) == (name == "linenumber")
    want = cpu.sql(sql).collect().to_pydict()
    assert list(got) == list(want)
    for k in want:
        if k == "avg_price":
            assert np.allclose(got[k], want[k], rtol=1e-12, atol=0)
        else:
            assert got[k] == want[k], k


def _mixed_table(device):
    """Every key and aggregate storage type the slice handles, NULLs, NaN
    and +-0.0 (made from a seed, the same on both devices)."""
    from datafusion_tpu_torch import Table
    from datafusion_tpu_torch.types.dtypes import DATE32, decimal

    rng = np.random.default_rng(5)
    n = 5000

    def nulls(col, p=0.1):
        return [None if z else v for z, v in zip(rng.random(n) < p, col)]

    day0 = np.datetime64("1995-01-01")
    data = {
        "s": nulls(list(rng.choice(["apple", "Banana", "cherry-pie", "date"], n))),
        "i": nulls([int(v) for v in rng.integers(-50, 50, n)]),
        "big": nulls([int(v) for v in rng.integers(0, 100_000, n)]),
        "u": rng.integers(0, 2**63, n, dtype=np.uint64) + np.uint64(2**62),
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "f32": rng.choice([0.5, -0.0, 0.0, 2.25], n).astype(np.float32),
        "f": nulls([float(v) for v in rng.choice([0.0, -0.0, 1.5, 2.25, -3.0], n)]),
        "d": nulls([float(v) for v in rng.integers(-10**5, 10**5, n) / 100]),
        "dt": nulls([day0 + int(v) for v in rng.integers(0, 2000, n)]),
        "w": [int(v) for v in rng.choice([2**62, -(2**62), 2**62 - 1], n)],
    }
    return Table.from_pydict(data, dtypes={"d": decimal(12, 2), "dt": DATE32}, device=device)


MIXED_ON_CARD = [
    "SELECT i, count(*) c, sum(d) sd, avg(d) ad, min(s) ms, max(dt) xd, sum(w) sw, stddev(i) si "
    "FROM t GROUP BY i ORDER BY i",
    "SELECT big, count(*) c, sum(w) sw, min(s) ms, avg(f) af FROM t GROUP BY big ORDER BY big",
    "SELECT u, count(*) c, sum(u) su, min(u) mu, max(i8) m8 FROM t GROUP BY u ORDER BY u LIMIT 50",
    "SELECT u - 1 AS a, u * 3 AS b, u < u + 1 AS c, u = u AS d, CASE WHEN i > 0 THEN u END AS e "
    "FROM t WHERE u > 5 ORDER BY u DESC LIMIT 40",
    "SELECT i8, f32, count(*) c, sum(i8) s8, min(f32) mf FROM t GROUP BY i8, f32 ORDER BY i8, f32",
    "SELECT g, count(*) c FROM (SELECT CASE WHEN f = 1.5 THEN (f - f) / (f - f) ELSE f END AS g "
    "FROM t) x GROUP BY g",
    "SELECT s, count(DISTINCT i) ci, sum(DISTINCT big) sb, avg(DISTINCT d) ad FROM t GROUP BY s ORDER BY s",
    "SELECT count(DISTINCT i) ci, sum(DISTINCT u) su, count(DISTINCT s) cs, sum(w) sw FROM t",
    "SELECT i, s FROM t ORDER BY i, s NULLS FIRST LIMIT 10 OFFSET 5",
    "SELECT s, count(*) c FROM (SELECT s FROM t WHERE i < 0 UNION ALL SELECT s FROM t "
    "WHERE big < 500) u GROUP BY s ORDER BY s",
    "SELECT CASE WHEN i > 5 THEN 'big' WHEN i < 0 THEN 'neg' END a, CASE WHEN f > 0 THEN d ELSE 0 END e, "
    "i IN (1, 2, 3) h, s IN ('date', 'nope') l, i NOT IN (1, NULL) q, CAST(i AS VARCHAR) ci, "
    "CAST(d AS VARCHAR) cd, dt + INTERVAL '13' MONTH m, extract(year from dt) y, "
    "date_trunc('quarter', dt) tq FROM t",
    "SELECT sqrt(big) q, sin(d) a, round(f) r, floor(d) fd, abs(i) ai, power(d, 2) p, upper(s) us, "
    "substr(s, 2, 3) ss, concat(s, '-', i) c, lpad(s, i, '*') lp, md5(s) m, coalesce(i, big) co, "
    "to_hex(big) h FROM t WHERE i >= 0",
]


@pytest.mark.gpu
@pytest.mark.parametrize("sql", MIXED_ON_CARD, ids=[f"q{i}" for i in range(len(MIXED_ON_CARD))])
def test_mixed_queries_on_card_match_cpu(cuda, sql):
    """Every device code path of the slice on the card: rows equal the
    CPU's; floats within rel 1e-12 (the card's math library and
    summation order), NaN equal to NaN, -0.0 told from 0.0 (the +-0.0
    group reports its first row's key, and the card's radix sort must not
    order -0.0 first, nor a NaN by its sign)."""
    cpu = ExecutionContext(device="cpu")
    cpu.register_table("t", _mixed_table("cpu"))
    gpu = ExecutionContext()
    gpu.register_table("t", _mixed_table(None))
    got = gpu.sql(sql).collect().to_pydict()
    want = cpu.sql(sql).collect().to_pydict()
    assert list(got) == list(want)
    for k in want:
        assert len(got[k]) == len(want[k]), k
        for x, y in zip(got[k], want[k]):
            if isinstance(y, float) and x is not None:
                assert (x != x and y != y) or abs(x - y) <= 1e-12 * max(abs(y), 1.0), (k, x, y)
                assert y != 0.0 or str(x) == str(y), (k, x, y)  # -0.0 told from 0.0
            else:
                assert x == y, (k, x, y)


EDGE_TABLES = {
    "empty": {"k": np.zeros(0, np.int64), "v": np.zeros(0, np.int64), "s": np.array([], dtype=object)},
    "one-row": {"k": [5], "v": [7], "s": ["a"]},
    "null-keys": {"k": [None, None, None], "v": [1, 2, 3], "s": [None, "b", None]},
}


@pytest.mark.gpu
@pytest.mark.parametrize("table", list(EDGE_TABLES))
def test_edge_tables_on_card_match_cpu(cuda, table):
    from datafusion_tpu_torch import Table

    sqls = [
        "SELECT k, count(*) c, sum(v) s, min(s) ms FROM t GROUP BY k ORDER BY k",
        "SELECT s, k, count(DISTINCT v) c FROM t WHERE v < 100 GROUP BY s, k ORDER BY s, k",
        "SELECT count(DISTINCT k) c, sum(DISTINCT v) s, sum(v) t FROM t",
        "SELECT k FROM t WHERE v > 1 UNION ALL SELECT k FROM t ORDER BY k LIMIT 5 OFFSET 1",
    ]
    cpu = ExecutionContext(device="cpu")
    cpu.register_table("t", Table.from_pydict(EDGE_TABLES[table], device="cpu"))
    gpu = ExecutionContext()
    gpu.register_table("t", Table.from_pydict(EDGE_TABLES[table]))
    for sql in sqls:
        assert gpu.sql(sql).collect().to_pydict() == cpu.sql(sql).collect().to_pydict(), sql


def _join_sides(edge, device):
    from datafusion_tpu_torch import Table
    from datafusion_tpu_torch.ops.basic import MemoryExec
    from datafusion_tpu_torch.types.dtypes import STRING

    from torch_join_cases import EDGE_SIDES

    execs = []
    for data in EDGE_SIDES[edge]:
        t = Table.from_pydict(data, dtypes={"rv": STRING} if "rv" in data else None, device=device)
        execs.append(MemoryExec(t, t.schema()))
    return execs


@pytest.mark.gpu
@pytest.mark.parametrize("edge", ["null-keys", "empty-build", "empty-probe", "fan-out"])
def test_join_edge_tables_on_card_match_cpu(cuda, edge):
    """Every join type on the join edge tables of test_torch_joins.py: NULL
    keys, an empty side, fan-out; rows in order equal the CPU's."""
    from datafusion_tpu_torch.exprs.physical import PhysCol
    from datafusion_tpu_torch.ops.join import HashJoinExec

    from torch_join_cases import JOIN_TYPES

    for jt in JOIN_TYPES:
        out = []
        for device in ("cpu", None):
            left, right = _join_sides(edge, device)
            lk, rk = (PhysCol(n, 0, s.schema().fields[0].dtype) for n, s in (("k", left), ("k2", right)))
            out.append(HashJoinExec(left, right, [(lk, rk)], jt).execute().to_pydict())
        assert out[1] == out[0], (edge, jt)


JOIN_SQL_ON_CARD = [
    "SELECT v, s, w, s2 FROM a JOIN b ON s = s2",
    "SELECT v, s, w, s2 FROM a FULL JOIN b ON s = s2",
    "SELECT v, w, u FROM a JOIN b ON u = u2",
    "SELECT v, w FROM a LEFT JOIN b ON x = y",
    "SELECT v, w FROM a RIGHT JOIN b ON u = u2 AND v < w",
    "SELECT v FROM a WHERE EXISTS (SELECT 1 FROM b WHERE b.s2 = a.s AND b.w > a.v)",
    "SELECT v FROM a WHERE s NOT IN (SELECT s2 FROM b WHERE s2 IS NOT NULL)",
    "SELECT v, w FROM a, b WHERE x <= y AND x >= y ORDER BY v, w",
    "SELECT w FROM b WHERE w > (SELECT avg(v) FROM a) ORDER BY w",
]


def _join_sql_tables(device):
    from datafusion_tpu_torch import Table

    u = np.array([0, 5, 2**63, 2**63 + 5, 2**64 - 1, 2**63 - 1], np.uint64)
    a = {"s": ["apple", "kiwi", "fig", None, "kiwi", "plum"], "v": [1, 2, 3, 4, 5, 6],
         "u": u, "x": [0.0, -0.0, 1.5, float("nan"), 2.0, None]}
    b = {"s2": ["kiwi", "fig", "date", "kiwi", None, "fig"], "w": [10, 20, 30, 40, 50, 0],
         "u2": u[::-1].copy(), "y": [-0.0, 0.0, 1.5, float("nan"), 2.0, 2.0]}
    return Table.from_pydict(a, device=device), Table.from_pydict(b, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("sql", JOIN_SQL_ON_CARD, ids=[f"j{i}" for i in range(len(JOIN_SQL_ON_CARD))])
def test_join_queries_on_card_match_cpu(cuda, sql):
    """String keys from two dictionaries, uint64 keys above 2^63, float keys
    with -0.0 and NaN (F7: hashed by their float32 bits on both devices),
    a residual filter, semi and null-aware anti joins, a cross join and a
    scalar subquery: rows in order equal the CPU's."""
    out = []
    for device in ("cpu", None):
        ctx = ExecutionContext(device=device)
        for name, t in zip("ab", _join_sql_tables(device)):
            ctx.register_table(name, t)
        out.append(ctx.sql(sql).collect().to_pydict())
    assert out[1] == out[0], sql


# ---- whole-query execution: CUDA graphs -------------------------------------


@pytest.fixture(scope="module")
def tpch_sf01():
    """The eight TPC-H tables at SF 0.1 on the card (a context of its own)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from datafusion_tpu_torch import tpchdata

    ctx = ExecutionContext()
    tpchdata.register_tpch(ctx, tpchdata.generate_tpch(0.1, 7))
    return ctx


def _wq(ctx):
    return ctx._plan_cache[list(ctx._plan_cache)[-1]]._whole_query


def _rows_close(got: dict, want: dict, label):
    assert list(got) == list(want), label
    for k in want:
        assert len(got[k]) == len(want[k]), (label, k)
        for x, y in zip(got[k], want[k]):
            if isinstance(y, float) and x is not None:
                assert x == y or abs(x - y) <= 1e-12 * max(abs(y), 1.0), (label, k, x, y)
            else:
                assert x == y, (label, k, x, y)


def _sorted_rows(got: dict) -> dict:
    """Columns of rows sorted as a multiset (the queries without a full
    ORDER BY may tie)."""
    rows = sorted(zip(*got.values()), key=lambda r: tuple((v is None, str(v)) for v in r))
    return {k: [r[i] for r in rows] for i, k in enumerate(got)}


@pytest.mark.gpu
@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_graph_replay_equals_eager_and_exact(tpch_sf01, q):
    """Each TPC-H query at SF 0.1: the first collect learns, the second
    runs the checked speculative path eagerly, the third captures a CUDA
    graph and replays it, the fourth replays it.  Every replay equals the
    eager speculative rows and the exact path's rows (speculation off).
    Every plan becomes one graph, as its CPU twin becomes one unit: Q16's
    null-aware NOT IN too, since its CrossJoinAggExec learns its tiling
    and tile counts on the first run."""
    from datafusion_tpu_torch.ops import kernels as K
    from datafusion_tpu_torch.queries import run_tpch

    ctx = tpch_sf01
    runs = [_sorted_rows(run_tpch(ctx, q).to_pydict()) for _ in range(4)]
    wq = _wq(ctx)
    assert wq.graph is not None, (q, wq.failure)
    K.SPECULATION.enabled = False
    try:
        exact = _sorted_rows(run_tpch(ctx, q).to_pydict())
    finally:
        K.SPECULATION.enabled = True
    for i, rows in enumerate(runs):
        _rows_close(rows, exact, (q, i))
    assert runs[3] == runs[2]  # two replays of one graph


def _overflow_tables(device):
    from datafusion_tpu_torch import Table

    rng = np.random.default_rng(7)
    f = {"k": rng.integers(0, 200, 5000), "x": rng.integers(0, 1000, 5000)}
    d = {"k": np.arange(200), "y": rng.integers(0, 50, 200)}
    return Table.from_pydict(f, device=device), Table.from_pydict(d, device=device)


@pytest.mark.gpu
def test_overflow_after_capture_drops_the_graph_and_captures_again(cuda):
    """Re-registered data (a new plan speculating at the old plan's learned
    capacities), then data rewritten in place under a captured graph: each
    overflow reruns exactly, gives the exact rows, drops the graph, and two
    collects later the plan is captured again."""
    sql = "SELECT count(*) AS c, sum(x) AS sx FROM f JOIN d ON f.k = d.k WHERE y < 25"
    cpu, gpu = ExecutionContext(device="cpu"), ExecutionContext()
    for ctx, dev in ((cpu, "cpu"), (gpu, None)):
        f, d = _overflow_tables(dev)
        ctx.register_table("f", f)
        ctx.register_table("d", d)
    want = cpu.sql(sql).collect().to_pydict()
    for _ in range(3):
        assert gpu.sql(sql).collect().to_pydict() == want
    assert _wq(gpu).graph is not None
    d0 = _overflow_tables(None)[1]
    from datafusion_tpu_torch import Table

    gpu.register_table("d", Table.from_pydict({"k": np.arange(200), "y": np.zeros(200, np.int64)}))
    for _ in range(3):
        assert gpu.sql(sql).collect().to_pydict()["c"] == [5000]
    wq = _wq(gpu)
    assert wq.graph is not None
    gpu.register_table("d", d0)
    for _ in range(3):
        assert gpu.sql(sql).collect().to_pydict() == want
    assert _wq(gpu).graph is not None
    # an outer join learns its capacities before it speculates; rewriting
    # the build side's keys in place, under the graph, outgrows them
    sql = "SELECT count(*) AS c, sum(y) AS sy FROM f LEFT JOIN d ON f.k = d.k"
    for ctx in (cpu, gpu):
        ctx.register_table("d", _overflow_tables("cpu" if ctx is cpu else None)[1])
        for _ in range(3):
            got = ctx.sql(sql).collect().to_pydict()
    wq = _wq(gpu)
    assert wq.graph is not None
    for ctx in (cpu, gpu):
        ctx.table("d").collect().column("k").data.zero_()
    want = cpu.sql(sql).collect().to_pydict()
    assert gpu.sql(sql).collect().to_pydict() == want
    assert wq.graph is None
    for _ in range(2):
        assert gpu.sql(sql).collect().to_pydict() == want
    assert wq.graph is not None and wq.failure is None


@pytest.mark.gpu
def test_repeat_interleave_with_a_short_output_size_asserts_on_the_card(cuda):
    """Why the speculative expansion does not use repeat_interleave: with an
    output_size below the sum of the repeats torch's CUDA kernel fails a
    device-side assert, which ends the process (run in a child)."""
    import subprocess
    import sys

    code = (
        "import torch\n"
        "c = torch.tensor([2, 2, 2], device='cuda')\n"
        "torch.repeat_interleave(torch.arange(3, device='cuda'), c, output_size=4)\n"
        "torch.cuda.synchronize()\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0, out.stdout
    assert "assert" in out.stderr.lower() or "device-side" in out.stderr.lower(), out.stderr[-2000:]


@pytest.mark.gpu
def test_speculative_expansion_flags_a_fan_out_above_its_capacity(cuda):
    """A fan-out above the learned capacity: the expansion fills its slots,
    reports the total, and the query flags and reruns exactly; the process
    goes on."""
    from datafusion_tpu_torch import Table
    from datafusion_tpu_torch.ops import kernels as K

    counts = torch.tensor([3, 0, 5, 4], device=cuda)
    lo = torch.tensor([0, 0, 3, 8], device=cuda)
    order = torch.arange(12, device=cuda)
    probe, build, alive, total = K.join_expand(lo, counts, order, 8)
    torch.cuda.synchronize()
    assert int(total) == 12 and int(alive.sum()) == 8
    assert probe.tolist() == [0, 0, 0, 2, 2, 2, 2, 2] and build.tolist() == [0, 1, 2, 3, 4, 5, 6, 7]
    n = 5000
    t = {"k": np.arange(n) % 100, "pv": np.arange(n)}
    u = {"k2": np.repeat(np.arange(100), 4), "bv": np.arange(400)}
    sql = "SELECT count(*) c, sum(pv) s, sum(bv) b FROM t JOIN u ON k = k2"
    ctx = ExecutionContext()
    ctx.register_table("t", Table.from_pydict(t))
    ctx.register_table("u", Table.from_pydict(u))
    got = ctx.sql(sql).collect().to_pydict()  # speculates at the probe's capacity
    torch.cuda.synchronize()
    assert got["c"] == [n * 4]
    assert got["s"] == [4 * int(np.arange(n).sum())]


@pytest.mark.gpu
def test_graphs_share_one_pool_and_replay_in_any_order(tpch_sf01):
    """Every graph allocates from one shared pool: replays of different
    plans interleaved in any order each give the plan's own rows, since a
    replay's outputs are copied before the next replay starts."""
    from datafusion_tpu_torch.physical import query_compiler as QC
    from datafusion_tpu_torch.queries import run_tpch

    ctx = tpch_sf01
    qs = (1, 3, 5, 6, 12, 18)
    want = {}
    for q in qs:
        for _ in range(3):
            want[q] = _sorted_rows(run_tpch(ctx, q).to_pydict())
        assert _wq(ctx).graph is not None, (q, _wq(ctx).failure)
    assert list(QC._POOLS) == [torch.device("cuda", torch.cuda.current_device())]
    assert QC.pool_bytes("cuda") > 0
    for q in (18, 1, 1, 6, 3, 12, 5, 18, 3, 6, 12, 5, 1):
        assert _sorted_rows(run_tpch(ctx, q).to_pydict()) == want[q], q


@pytest.mark.gpu
def test_a_new_catalog_version_releases_the_graphs(cuda):
    """Registering a table releases the cached plans' graphs at once; the
    next collects of the query capture a new one."""
    from datafusion_tpu_torch.physical import query_compiler as QC

    f, d = _overflow_tables(None)
    ctx = ExecutionContext()
    ctx.register_table("f", f)
    ctx.register_table("d", d)
    sql = "SELECT count(*) AS c, sum(x) AS sx FROM f JOIN d ON f.k = d.k WHERE y < 25"
    want = [ctx.sql(sql).collect().to_pydict() for _ in range(3)][0]
    wq = _wq(ctx)
    assert wq.graph is not None and wq in set(QC._HOLDING)
    ctx.register_table("d", d)
    assert wq.graph is None and wq not in set(QC._HOLDING) and not ctx._plan_cache
    for _ in range(3):
        assert ctx.sql(sql).collect().to_pydict() == want
    assert _wq(ctx).graph is not None and _wq(ctx) is not wq


# ---- windows and rolling windows --------------------------------------------


@pytest.fixture(scope="module")
def tpch_sf001_both():
    """The eight TPC-H tables at SF 0.01 in a context on the card and one
    on the CPU, from the same host arrays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from datafusion_tpu_torch import tpchdata

    data = tpchdata.generate_tpch(0.01, 7)
    gpu, cpu = ExecutionContext(), ExecutionContext(device="cpu")
    tpchdata.register_tpch(gpu, data)
    tpchdata.register_tpch(cpu, data, device="cpu")
    return gpu, cpu


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["W1", "W2", "W3", "W4", "R1"])
@pytest.mark.parametrize("timed", [False, True])
def test_window_queries_on_card_match_cpu_and_capture(tpch_sf001_both, name, timed):
    """The window queries of chip_smoke's window phase (queries/windows.py)
    at SF 0.01: four collects on the card (the cold run, the check, which
    runs with torch's sync check set to raise, the capture and its replay,
    a replay) equal the CPU's rows, and the plan is one CUDA graph."""
    from datafusion_tpu_torch.queries import window_sql

    gpu, cpu = tpch_sf001_both
    sql = window_sql(name, timed)
    want = cpu.sql(sql).collect().to_pydict()
    for i in range(4):
        _rows_close(gpu.sql(sql).collect().to_pydict(), want, (name, timed, i))
    wq = _wq(gpu)
    assert wq.checked and wq.graph is not None, (name, wq.failure)


@pytest.mark.gpu
def test_window_functions_on_card_match_cpu(cuda):
    """Every window function and frame kind over NULL, NaN, -0.0 and
    int64 values next to wrap-around, on the card against the CPU (the
    card's radix sort, cummax and nextafter against the CPU's)."""
    rng = np.random.default_rng(3)
    n = 5000
    data = {
        "g": [None if rng.random() < 0.05 else f"p{x}" for x in rng.integers(0, 40, n)],
        "k": [None if rng.random() < 0.05 else int(x) for x in rng.integers(-30, 30, n)],
        "v": [None if s < 0.05 else float("nan") if s < 0.1 else -0.0 if s < 0.15 else float(x)
              for s, x in zip(rng.random(n), rng.integers(-40, 40, n) / 8)],
        "w": [int(x) for x in rng.choice([2**62, -(2**62), (1 << 63) - 3, 5, -7], n)],
        "r": list(range(n)),
    }
    windows = [
        "rank() OVER (PARTITION BY g ORDER BY k)", "dense_rank() OVER (PARTITION BY g ORDER BY v)",
        "cume_dist() OVER (PARTITION BY g ORDER BY k DESC)", "ntile(4) OVER (PARTITION BY g ORDER BY r)",
        "lag(v, 2) OVER (PARTITION BY g ORDER BY r)", "nth_value(w, 2) OVER (PARTITION BY g ORDER BY r)",
        "sum(v) OVER (PARTITION BY g ORDER BY r ROWS BETWEEN 2 PRECEDING AND 2 FOLLOWING)",
        "sum(w) OVER (PARTITION BY g ORDER BY k RANGE BETWEEN 3 PRECEDING AND 1 FOLLOWING)",
        "min(v) OVER (PARTITION BY g ORDER BY k GROUPS BETWEEN 1 PRECEDING AND 1 FOLLOWING)",
        "max(v) OVER (PARTITION BY g ORDER BY v RANGE BETWEEN 1.5 PRECEDING AND 0.5 FOLLOWING)",
    ]
    gpu, cpu = ExecutionContext(), ExecutionContext(device="cpu")
    from datafusion_tpu_torch import Table

    gpu.register_table("t", Table.from_pydict(data))
    cpu.register_table("t", Table.from_pydict(data, device="cpu"))
    for w in windows:
        sql = f"SELECT g, k, v, w, r, {w} AS x FROM t"
        want = cpu.sql(sql).collect().to_pydict()
        for _ in range(3):
            got = gpu.sql(sql).collect().to_pydict()
            assert list(got) == list(want)
            for col in want:
                for a, b in zip(got[col], want[col]):
                    assert a == b or (a != a and b != b) or (
                        isinstance(b, float) and abs(a - b) <= 1e-12 * max(abs(b), 1.0)), (w, col, a, b)


# ---------------------------------------------------------------------------
# host-resident tables, morsels and file sources (datasource/host.py,
# physical/morsel.py, native_lib.py)
# ---------------------------------------------------------------------------


def _host_q1(rows: int, morsel_rows: int):
    """Q1's lineitem of about ``rows`` rows on the CPU, and the same rows
    as a host table for the card."""
    from datafusion_tpu_torch.datasource.host import HostTable

    t = generate_lineitem_q1(rows / 6_001_215, device="cpu")
    return t, HostTable.from_table(t, morsel_rows, device="cuda")


@pytest.mark.gpu
def test_pinned_streamed_morsels_equal_synchronous_uploads(cuda):
    """The morsels ``stream_morsels`` copies from pinned memory on its side
    stream, one ahead, equal the synchronous upload of the same rows, the
    last, partial morsel (its tail zeroed on the card) included."""
    t, host = _host_q1(300_000, 1 << 16)
    assert host.num_morsels == 5 and host.nrows % host.morsel_rows
    assert all(torch.from_numpy(d).is_pinned() for d in host.datas + host.valids)
    streamed = list(host.stream_morsels())
    torch.cuda.synchronize()
    for i, m in enumerate(streamed):
        lo = i * host.morsel_rows
        k = min(host.morsel_rows, host.nrows - lo)
        assert m.capacity == host.morsel_rows and m.nrows == k
        for c, src, want_v in zip(m.columns, host.datas, host.valids):
            want = torch.zeros(m.capacity, dtype=c.data.dtype)
            want[:k] = torch.from_numpy(src[lo:lo + k])
            valid = torch.zeros(m.capacity, dtype=torch.bool)
            valid[:k] = torch.from_numpy(want_v[lo:lo + k])
            assert torch.equal(c.data.cpu(), want) and torch.equal(c.valid.cpu(), valid)


@pytest.mark.gpu
def test_no_host_sync_between_morsels_of_an_aggregate_stage(cuda):
    """A warm collect of Q1 over a host table reads nothing on the host
    while its morsels run: torch's sync check set to raise stays quiet
    from the first morsel to the last, and K1 runs once per morsel."""
    from datafusion_tpu_torch.columnar.table import HOST_SYNCS
    from datafusion_tpu_torch.physical import morsel as M

    t, host = _host_q1(400_000, 1 << 16)
    ctx = ExecutionContext()
    ctx.register_host_table("lineitem", host)
    q1 = get_query_sql(1)
    cpu = ExecutionContext(device="cpu")  # the same morsels, so the same float sums
    cpu.register_host_table("lineitem", t, morsel_rows=host.morsel_rows)
    want = cpu.sql(q1).collect().to_pydict()
    for _ in range(2):  # cold (learns), then warm
        assert ctx.sql(q1).collect().to_pydict() == want
    seen = []
    orig = M.MorselStageExec._execute

    def guarded(self):
        gen = self.host.stream_morsels
        syncs0 = HOST_SYNCS[0]

        def watched():
            torch.cuda.set_sync_debug_mode("error")
            try:
                for m in gen():
                    yield m
            finally:
                torch.cuda.set_sync_debug_mode("default")
            seen.append(HOST_SYNCS[0] - syncs0)

        self.host.stream_morsels = watched
        try:
            return orig(self)
        finally:
            del self.host.stream_morsels

    M.MorselStageExec._execute = guarded
    try:
        before = SD.smalldomain_sum_count.launches
        got = ctx.sql(q1).collect().to_pydict()
        launches = SD.smalldomain_sum_count.launches - before
    finally:
        M.MorselStageExec._execute = orig
    assert got == want and seen == [0] and launches == host.num_morsels


@pytest.mark.gpu
def test_native_loader_is_built_and_used(cuda, tmp_path):
    """A TBL file with a schema loads through the native C++ loader, built
    at first use, onto the card."""
    from datafusion_tpu_torch import native_lib
    from datafusion_tpu_torch.types import Field, Schema
    from datafusion_tpu_torch.types.dtypes import DATE32, INT64, STRING, decimal

    p = tmp_path / "t.tbl"
    p.write_text("1|A|1995-01-02|10.50|\n2|B|1996-03-04|0.25|\n3|A|1997-05-06|1.00|\n")
    ctx = ExecutionContext()
    sch = Schema([Field("k", INT64), Field("f", STRING), Field("d", DATE32), Field("m", decimal(15, 2))])
    ctx.register_csv("t", str(p), sch, has_header=False, delimiter="|")
    got = ctx.sql("SELECT f, count(*) c, sum(m) s FROM t GROUP BY f ORDER BY f").collect()
    assert got.device.type == "cuda"
    assert got.to_pydict() == {"f": ["A", "B"], "c": [2, 1], "s": [11.5, 0.25]}
    assert ctx._resolve_table("t").loader == "native" and native_lib.get_lib() is not None


@pytest.mark.gpu
def test_make_mesh_places_every_shard_on_a_card(cuda):
    from datafusion_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    assert make_mesh().devices.size == n
    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    assert all(d.type == "cuda" and d.index == i % n for i, d in enumerate(mesh.devices))


@pytest.mark.gpu
def test_tpch_q1_on_an_8_shard_mesh_equals_single_device_without_k1(cuda):
    """TPC-H Q1 at SF 0.01 over 8 logical shards on the card: the single
    device's rows, strict with 0 fallbacks; the single device launches K1,
    the mesh (sort-path grouping) never does."""
    from datafusion_tpu_torch import tpchdata
    from datafusion_tpu_torch.parallel.executor import SpmdExecutor
    from datafusion_tpu_torch.parallel.mesh import make_mesh
    from datafusion_tpu_torch.queries import run_tpch, run_tpch_spmd

    ctx = ExecutionContext()
    tpchdata.register_tpch(ctx, tpchdata.generate_tpch(0.01, 7))
    before = SD.smalldomain_sum_count.launches
    want = run_tpch(ctx, 1).to_pydict()
    assert SD.smalldomain_sum_count.launches > before
    ex = SpmdExecutor(make_mesh(8), strict=True)
    before = SD.smalldomain_sum_count.launches
    got = run_tpch_spmd(ctx, 1, ex).to_pydict()
    assert SD.smalldomain_sum_count.launches == before
    assert ex.fallback_count == 0 and all(m == "mesh" for _, m in ex.node_modes)
    assert list(got) == list(want)
    for k in want:
        if k.startswith("avg"):
            assert np.allclose(got[k], want[k], rtol=1e-12, atol=0), k
        else:
            assert got[k] == want[k], k


@pytest.mark.gpu
def test_distributed_q1_on_the_card_launches_k1_once_per_scan_task(cuda):
    """TPC-H Q1 at SF 0.01 through DistributedContext (2 executor threads,
    4 partitions) on the card: the single device's rows, and K1 launched
    by each of the 4 scan tasks' partial aggregates, by nothing else."""
    from datafusion_tpu_torch import tpchdata
    from datafusion_tpu_torch.distributed import DistributedContext
    from datafusion_tpu_torch.queries import run_tpch

    data = tpchdata.generate_tpch(0.01, 7)
    ctx = ExecutionContext()
    tpchdata.register_tpch(ctx, data)
    want = run_tpch(ctx, 1).to_pydict()
    dctx = DistributedContext(num_executors=2, target_partitions=4)
    try:
        assert dctx.device.type == "cuda"
        tpchdata.register_tpch(dctx, data)
        before = SD.smalldomain_sum_count.launches
        out = dctx.sql(get_query_sql(1)).collect()
        assert SD.smalldomain_sum_count.launches == before + 4
    finally:
        dctx.close()
    assert out.device.type == "cuda"
    got = out.to_pydict()
    assert list(got) == list(want)
    for k in want:
        if k.startswith("avg"):
            assert np.allclose(got[k], want[k], rtol=1e-12, atol=0), k
        else:
            assert got[k] == want[k], k


@pytest.mark.gpu
def test_spill_file_from_the_card_equals_the_cpus(cuda, tmp_path):
    from datafusion_tpu_torch import Table
    from datafusion_tpu_torch.distributed import shuffle_io

    rng = np.random.default_rng(3)
    d = {"i": rng.integers(-9, 9, 5000), "f": rng.normal(size=5000),
         "s": [f"w{x}" for x in rng.integers(0, 30, 5000)]}
    paths = []
    for dev in ("cpu", cuda):
        paths.append(str(tmp_path / f"{torch.device(dev).type}.dfs"))
        shuffle_io.write_table(paths[-1], Table.from_pydict(d, device=dev))
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    back = shuffle_io.read_table(paths[0], cuda)
    assert back.device.type == "cuda" and back.to_pydict() == Table.from_pydict(d, device="cpu").to_pydict()
