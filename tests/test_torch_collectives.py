"""The torch port's SPMD controller (datafusion_tpu_torch/parallel/collectives.py)
on the CPU: each collective's results against numpy, the packed column
exchanges against one collective per column, and the faults a shard body
can make: a shard that finishes while others wait, or that asks for a
different collective or shape, raises at once naming the shards; an
exception in one shard reaches the caller and closes the others.  No test
here can hang: the controller waits on nothing."""

import numpy as np
import pytest
import torch

from datafusion_tpu_torch.errors import InternalError
from datafusion_tpu_torch.parallel.collectives import (
    AllGather,
    AllToAll,
    Pmax,
    Psum,
    exchange_columns,
    gather_columns,
    run_spmd,
)
from datafusion_tpu_torch.parallel.mesh import make_mesh

SHARDS = [8, 3, 1]


def operand(me: int, shape) -> np.ndarray:
    rng = np.random.default_rng(100 + me)
    return rng.integers(-1000, 1000, shape).astype(np.int64)


@pytest.mark.parametrize("n", SHARDS)
def test_collectives_against_numpy(n):
    mesh = make_mesh(n, device="cpu")
    xs = [operand(me, (n, 5)) for me in range(n)]

    def body(me, x):
        a2a = yield AllToAll(x)
        gat = yield AllGather(x[0])
        tot = yield Psum(x)
        top = yield Pmax(x)
        return me, a2a, gat, tot, top

    res = run_spmd(mesh, body, [(torch.from_numpy(x),) for x in xs], "test")
    stacked = np.stack(xs)  # [sender, receiver, 5]
    for me, (axis, a2a, gat, tot, top) in enumerate(res):
        assert axis == me
        np.testing.assert_array_equal(a2a.numpy(), stacked[:, me])
        np.testing.assert_array_equal(gat.numpy(), stacked[:, 0])
        np.testing.assert_array_equal(tot.numpy(), stacked.sum(0))
        np.testing.assert_array_equal(top.numpy(), stacked.max(0))


def test_packed_exchanges_equal_one_collective_per_column():
    """Columns of one width ride one stacked buffer as integer bits:
    bool, int32, float32 (with -0.0 and NaN), int64, float64 and uint64
    arrive bit for bit as a per-column all-to-all delivers them."""
    n, bucket = 4, 6
    mesh = make_mesh(n, device="cpu")

    def cols(me):
        r = np.random.default_rng(me)
        f32 = r.normal(size=n * bucket).astype(np.float32)
        f32[:2] = [-0.0, np.nan]
        return [
            torch.from_numpy(r.random(n * bucket) > 0.5),
            torch.from_numpy(r.integers(-9, 9, n * bucket).astype(np.int32)),
            torch.from_numpy(f32),
            torch.from_numpy(r.integers(-(2**62), 2**62, n * bucket)),
            torch.from_numpy(r.normal(size=n * bucket)),
            torch.from_numpy(r.integers(0, 2**63, n * bucket).astype(np.uint64) * 2),
            torch.from_numpy(r.integers(0, 5, (n * bucket, 3))),  # a list column
        ]

    def packed(me, *c):
        got = yield from exchange_columns(list(c), n, bucket)
        gat = yield from gather_columns([x[:2] for x in c])
        return got, gat

    def single(me, *c):
        got, gat = [], []
        for x in c:
            recv = yield AllToAll(x.reshape((n, bucket) + tuple(x.shape[1:])))
            got.append(recv.reshape(x.shape))
            gat.append((yield AllGather(x[:2])))
        return got, gat

    args = [tuple(cols(me)) for me in range(n)]
    for (pg, pa), (sg, sa) in zip(run_spmd(mesh, packed, args), run_spmd(mesh, single, args)):
        for p, s in zip(pg + pa, sg + sa):
            assert p.dtype == s.dtype and p.shape == s.shape
            assert torch.equal(p.view(torch.uint8), s.contiguous().view(torch.uint8))


def test_plain_function_bodies_run_without_collectives():
    mesh = make_mesh(3, device="cpu")
    assert run_spmd(mesh, lambda me, x: me * x, [(1,), (2,), (3,)]) == [0, 2, 6]


def test_a_shard_that_finishes_early_raises_at_once():
    mesh = make_mesh(4, device="cpu")
    closed = []

    def body(me):
        try:
            if me == 2:
                return "done"
            yield Psum(torch.ones(3))
            yield Psum(torch.ones(3))
        finally:
            closed.append(me)

    with pytest.raises(InternalError, match=r"dist_x: shards \[2\] finished while shards \[0, 1, 3\] wait"):
        run_spmd(mesh, body, [()] * 4, "dist_x")
    assert sorted(closed) == [0, 1, 2, 3]


@pytest.mark.parametrize("odd", ["kind", "shape", "dtype"])
def test_shards_asking_for_different_collectives_raise(odd):
    mesh = make_mesh(4, device="cpu")

    def body(me):
        x = torch.zeros(4, 2)
        if me == 3:
            if odd == "kind":
                yield AllGather(x)
            elif odd == "shape":
                yield AllToAll(torch.zeros(4, 3))
            else:
                yield AllToAll(x.to(torch.int64))
        else:
            yield AllToAll(x)

    with pytest.raises(InternalError, match=r"dist_y: shards \[3\] ask for"):
        run_spmd(mesh, body, [()] * 4, "dist_y")


def test_an_exception_in_one_shard_reaches_the_caller():
    mesh = make_mesh(4, device="cpu")
    closed = []

    def body(me):
        try:
            yield Psum(torch.ones(1))
            if me == 1:
                raise ValueError("shard 1 failed")
            yield Psum(torch.ones(1))
        finally:
            closed.append(me)

    with pytest.raises(ValueError, match="shard 1 failed"):
        run_spmd(mesh, body, [()] * 4, "dist_z")
    assert sorted(closed) == [0, 1, 2, 3]


def test_make_mesh_on_the_cpu_and_without_a_card():
    assert make_mesh(device="cpu").devices.size == 8
    mesh = make_mesh(3, device="cpu")
    assert [str(d) for d in mesh.devices] == ["cpu"] * 3 and mesh.local_shards == [0, 1, 2]
    if not torch.cuda.is_available():
        from datafusion_tpu_torch.errors import ExecutionError

        with pytest.raises(ExecutionError, match="no CUDA device"):
            make_mesh(8)
