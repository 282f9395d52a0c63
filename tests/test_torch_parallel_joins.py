"""The torch port's distributed join (datafusion_tpu_torch/parallel/ops.py
``dist_join``) against the JAX package's on the same inputs, on the CPU
(see test_torch_parallel.py for what compares and how): the six join
types in the partitioned, broadcast and skew modes at 8 shards, the
partitioned mode at 1 and 3 shards, and the overflow escalations."""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from torch_mesh import E, assert_same_shards, col, shards_rows, tables, one_torch_thread  # noqa: F401 (autouse fixture)

JOIN_TYPES = ["inner", "left", "right", "full", "semi", "anti"]
CASES = [(8, m) for m in ("hash", "broadcast", "skew")] + [(1, "hash"), (3, "hash")]


def _join_inputs():
    rng = np.random.default_rng(7)
    n = 500
    left = {
        "k": [f"key{int(i)}" if i % 7 else None for i in rng.integers(0, 40, n)],
        "v": rng.integers(0, 100, n).tolist(),
    }
    right = {"k2": [f"key{i}" for i in range(0, 60, 2)] + [None], "w": [i * 10 for i in range(31)]}
    return left, right


@pytest.mark.parametrize("n,mode", CASES)
@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_dist_join(n, mode, jt):
    left, right = _join_inputs()
    lts, rts = tables(left), tables(right)
    out = {}
    for name, e in E.items():
        mesh = e.make_mesh(n)
        lt, rt = lts[name], rts[name]
        resid = e.exp.PhysBinary(e.exp.PhysCol("v", 1, lt.columns[1].dtype), "<",
                                 e.exp.PhysCol("w", 3, rt.columns[1].dtype), e.dt.BOOL)
        res = e.ops.dist_join(
            e.mesh.ShardedTable.from_table(lt, mesh), e.mesh.ShardedTable.from_table(rt, mesh),
            [(col(e, lt, "k"), col(e, rt, "k2"))], jt, filter=resid if jt == "inner" else None,
            skew=mode == "skew", broadcast=mode == "broadcast",
        )
        out[name] = (shards_rows(res), res.exchange_info)
    assert_same_shards(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]


@pytest.mark.parametrize("bucket", [4096, None])
def test_dist_join_overflow_retries_as_the_reference(bucket):
    """A hot key: the pinned small bucket overflows and raises in both
    engines; the automatic one escalates the same way (the same mode,
    capacities and retry count), and the pair capacity retries too."""
    n = 40_000
    rng = np.random.default_rng(3)
    keys = np.where(rng.random(n) < 0.9, 0, rng.integers(1, 64, n)).astype(np.int64)
    left = {"k": keys, "v": rng.integers(0, 1000, n).astype(np.int64)}
    right = {"k2": np.arange(64, dtype=np.int64).repeat(3), "w": np.arange(192, dtype=np.int64)}
    lts, rts = tables(left), tables(right)
    out = {}
    for name, e in E.items():
        mesh = e.make_mesh(8)
        lt, rt = lts[name], rts[name]
        args = (e.mesh.ShardedTable.from_table(lt, mesh), e.mesh.ShardedTable.from_table(rt, mesh),
                [(col(e, lt, "k"), col(e, rt, "k2"))], "inner")
        try:
            res = e.ops.dist_join(*args, bucket_cap=bucket)
            out[name] = (sorted(zip(*res.to_table().to_pydict().values())), res.exchange_info,
                         np.asarray(res.nrows).tolist())
        except Exception as err:  # the pinned bucket: the same error in both
            out[name] = (type(err).__name__, str(err))
    assert out["port"] == out["jax"]


