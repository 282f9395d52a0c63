"""The sorted operators of the torch port (ops/sorted.py) against the JAX
package's on the CPU, on identical random buffers made from a numpy seed
(NULL and NaN keys, -0.0 and 0.0, int64 values next to wrap-around, empty
inputs): SortedAggregateExec over a sorted input, LastRowByUniqueKeyExec,
MergeSortExec and MergeJoinExec.  Keys, counts, integer sums, min and max
are exact (NaN equal to NaN, -0.0 told from 0.0); float sums rel 1e-12
(the engines add in other orders).  Also: a warm SortedAggregateExec
reads nothing on the host."""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from datafusion_tpu.columnar.table import Table as JTable
from datafusion_tpu.exprs.physical import PhysCol as JCol
from datafusion_tpu.ops import aggregate as JA, basic as JB, sort as JS, sorted as JSO
from datafusion_tpu.types.dtypes import FLOAT64, INT64, STRING

from datafusion_tpu_torch.exprs.physical import PhysCol as PCol
from datafusion_tpu_torch.ops import aggregate as PA, basic as PB, sort as PS, sorted as PSO

from torch_parity import assert_rows_equal, port_table


def _data(n: int, seed: int):
    rng = np.random.default_rng(seed)
    s = rng.random(n)
    f = [None if x < 0.05 else float("nan") if x < 0.1 else -0.0 if x < 0.15 else 0.0 if x < 0.2
         else float(v) for x, v in zip(s, rng.integers(-8, 8, n) / 2)]
    return {
        "k": [None if z else int(v) for z, v in zip(rng.random(n) < 0.1, rng.integers(0, 12, n))],
        "f": f,
        "w": [int(v) for v in rng.choice([2**62, -(2**62), (1 << 63) - 3, 7, -5], n)],
        "s": list(rng.choice(["x", "y", "zz"], n)),
    }


def _both(data):
    types = {"k": INT64, "f": FLOAT64, "w": INT64, "s": STRING, "y": INT64}
    jt = JTable.from_pydict(data, dtypes={c: types[c] for c in data})
    return JB.MemoryExec(jt, jt.schema()), (lambda t: PB.MemoryExec(t, t.schema()))(port_table(jt))


def _cols(mem, mod):
    s = mem.schema()
    return {f.name: mod(f.name, i, f.dtype) for i, f in enumerate(s.fields)}


def _rows(t) -> dict:
    return t.to_pydict()


AGGS = [("sum", "w"), ("count", "f"), ("min", "f"), ("max", "f"), ("avg", "w"), ("min", "s"),
        ("max", "w"), ("sum", "f")]


@pytest.mark.parametrize("key", ["k", "f", "s"])
@pytest.mark.parametrize("n", [0, 1, 700])
def test_sorted_aggregate_over_a_sort_matches_jax(key, n):
    jm, pm = _both(_data(n, 3))
    jc, pc = _cols(jm, JCol), _cols(pm, PCol)
    outs = []
    for mod_s, mod_a, mod_so, mem, c in ((JS, JA, JSO, jm, jc), (PS, PA, PSO, pm, pc)):
        srt = mod_s.SortExec([mod_s.PhysSortExpr(c[key], True, True)], mem)
        aggs = [mod_a.PhysAggExpr(f, c[a], f"{f}_{a}") for f, a in AGGS]
        outs.append(mod_so.SortedAggregateExec("single", [(c[key], key)], aggs, srt).execute())
    want, got = _rows(outs[0]), _rows(outs[1])
    if key == "f":
        # the group of 0.0 and -0.0: the JAX package's aggregate outside a
        # fused stage gives 0.0 for its minimum and maximum, its fused
        # stages (and the port everywhere) -0.0 and 0.0, so these two
        # compare by value here (reference fault F13)
        for c in ("min_f", "max_f"):
            assert got[c] == want[c]
            got[c] = want[c]
    assert_rows_equal(got, want, {"sum_f", "avg_w"})


@pytest.mark.parametrize("n", [0, 1, 700])
def test_last_row_and_merges_match_jax(n):
    data = _data(n, 5)
    jm, pm = _both(data)
    jm2, pm2 = _both(_data(max(n // 2, 1), 6))
    jc, pc = _cols(jm, JCol), _cols(pm, PCol)
    for key in (["k"], ["k", "s"]):
        idx = [jm.schema().names().index(k) for k in key]
        got, want = [], []
        for mod_s, mod_so, mem, mem2, c, out in ((JS, JSO, jm, jm2, jc, want), (PS, PSO, pm, pm2, pc, got)):
            specs = [mod_s.PhysSortExpr(c[k], True, False) for k in key]
            srt = mod_s.SortExec(specs, mem)
            out.append(_rows(mod_so.LastRowByUniqueKeyExec(srt, idx).execute()))
            for cls in (mod_so.MergeSortExec, mod_so.SortPreservingMergeExec, mod_so.MergeReSortExec):
                out.append(_rows(cls([srt, mod_s.SortExec(specs, mem2)], specs).execute()))
        for g, w in zip(got, want):
            assert_rows_equal(g, w)


@pytest.mark.parametrize("join_type", ["inner", "left", "right"])
def test_merge_join_matches_jax(join_type):
    jl, pl = _both(_data(300, 8))
    jr, pr = _both({"k": list(range(-2, 10)), "y": list(range(12))})
    outs = []
    for mod_so, l, r in ((JSO, jl, jr), (PSO, pl, pr)):
        cl = {f.name: i for i, f in enumerate(l.schema().fields)}
        col = JCol if mod_so is JSO else PCol
        on = [(col("k", cl["k"], l.schema().fields[cl["k"]].dtype),
               col("k", 0, r.schema().fields[0].dtype))]
        outs.append(_rows(mod_so.MergeJoinExec(l, r, on, join_type).execute()))
    key = lambda row: tuple((v is None, str(v)) for v in row)
    assert sorted(zip(*outs[1].values()), key=key) == sorted(zip(*outs[0].values()), key=key)


def test_warm_sorted_aggregate_reads_nothing_on_the_host():
    """SortedAggregateExec learns its output capacity on its first run; a
    later run inside a speculation window reads nothing on the host (the
    whole-query guard would raise) and gives the same rows."""
    from datafusion_tpu_torch.columnar.table import BUILD
    from datafusion_tpu_torch.ops import kernels as PK

    _, pm = _both(_data(700, 9))
    c = _cols(pm, PCol)
    plan = PSO.SortedAggregateExec(
        "single", [(c["k"], "k")], [PA.PhysAggExpr("sum", c["w"], "s")],
        PS.SortExec([PS.PhysSortExpr(c["k"], True, True)], pm),
    )
    with PK.spec_window():
        want = _rows(plan.execute())
    BUILD.active = True
    try:
        with PK.spec_window() as w:
            out = plan.execute()
    finally:
        BUILD.active = False
    assert not w.overflowed()
    assert _rows(out) == want and len(want["k"]) == 13
