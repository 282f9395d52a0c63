"""TPC-H over the SPMD mesh in the torch port: the core queries (aggregation,
multi-join + sort, semi, left, anti, distinct) at SF 0.002 on an 8-shard
CPU mesh.  Both engines run the port's query text on identical buffers
(``torch_parity.port_table``); the JAX package runs on its 8 virtual CPU
devices.  For each query:

  * the port's mesh rows equal the JAX package's mesh rows and the port's
    single-device rows (any order; floats within rel 1e-12);
  * every plan node lowers the same way in both engines (``node_modes``);
  * both run strict, with 0 fallbacks.

And the port's counterpart of test_morsel.py::
test_host_resident_tpch_on_mesh_never_materializes, on the port's query
text: Q1 and Q18 at SF 0.01 with lineitem host-resident, sharded by
``ShardedTable.from_host``, give the device-resident rows and never
materialize the table on one device.

The JAX package's own sweep (tests/test_spmd_tpch.py) reads query text it
does not carry (ROADMAP fault F1)."""

import jax

jax.config.update("jax_platforms", "cpu")

import functools

import pytest

import datafusion_tpu as J
from datafusion_tpu.parallel.executor import SpmdExecutor as JSpmd
from datafusion_tpu.parallel.mesh import make_mesh as jmesh

import datafusion_tpu_torch as D
from datafusion_tpu_torch.parallel.executor import SpmdExecutor as PSpmd
from datafusion_tpu_torch.parallel.mesh import make_mesh as pmesh
from datafusion_tpu_torch.queries import run_tpch, run_tpch_spmd

from torch_mesh import CORE, assert_same_rows, jax_tables, run_on_mesh, one_torch_thread  # noqa: F401 (autouse fixture)
from torch_parity import port_table


@functools.lru_cache(maxsize=1)
def contexts():
    jctx = J.ExecutionContext()
    pctx = D.ExecutionContext(device="cpu")
    for name, t in jax_tables().items():
        jctx.register_table(name, t)
        pctx.register_table(name, port_table(t))
    return jctx, pctx


@pytest.mark.parametrize("q", CORE)
def test_spmd_tpch_matches_jax_and_single_device(q):
    jctx, pctx = contexts()
    want, jex = run_on_mesh(jctx, q, jmesh(8), JSpmd)
    got, pex = run_on_mesh(pctx, q, pmesh(8, device="cpu"), PSpmd)
    # Q21's answer is empty at this scale (no qualifying Saudi supplier)
    assert (len(next(iter(want.values()))) > 0) == (q != 21)
    assert_same_rows(got, want)
    assert pex.node_modes == jex.node_modes, (pex.node_modes, jex.node_modes)
    assert pex.fallback_count == 0 and jex.fallback_count == 0
    assert_same_rows(got, run_tpch(pctx, q).to_pydict())


def test_run_tpch_on_a_mesh_entry_point():
    """``run_tpch(ctx, q, mesh=)`` (ctx.sql(...).collect(mesh=)) gives the
    single-device rows, and so does ``run_tpch_spmd`` through an explicit
    strict executor, whose node records show the broadcast join."""
    _, pctx = contexts()
    mesh = pmesh(8, device="cpu")
    for q in (3, 4):
        assert_same_rows(run_tpch(pctx, q, mesh=mesh).to_pydict(), run_tpch(pctx, q).to_pydict())
    ex = PSpmd(mesh, strict=True)
    got = run_tpch_spmd(pctx, 3, ex).to_pydict()
    assert_same_rows(got, run_tpch(pctx, 3).to_pydict())
    assert ex.fallback_count == 0 and any(m == "broadcast" for _, m in ex.node_modes)


def test_host_resident_tpch_on_mesh_never_materializes(monkeypatch):
    from datafusion_tpu_torch import tpchdata
    from datafusion_tpu_torch.datasource.host import HostTable

    data = tpchdata.generate_tpch(0.01, 7)
    dctx = D.ExecutionContext(device="cpu")
    tpchdata.register_tpch(dctx, data)
    hctx = D.ExecutionContext(device="cpu")
    tpchdata.register_tpch(hctx, data)
    hctx.register_host_table("lineitem", dctx.table("lineitem").collect(), morsel_rows=8192)
    materialized = []
    orig = HostTable.materialize
    monkeypatch.setattr(HostTable, "materialize", lambda self: materialized.append(self.nrows) or orig(self))
    mesh = pmesh(8, device="cpu")
    for q in (1, 18):
        ex = PSpmd(mesh, strict=True)
        got = run_tpch_spmd(hctx, q, ex).to_pydict()
        assert ("HostMemoryExec", "mesh") in ex.node_modes, ex.node_modes
        assert ex.fallback_count == 0
        assert_same_rows(got, run_tpch(dctx, q).to_pydict())
    assert not materialized, f"host table materialized on a single device: {materialized}"
