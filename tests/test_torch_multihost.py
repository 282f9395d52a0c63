"""Multi-process SPMD in the torch port (datafusion_tpu_torch/parallel/
multihost.py): 2 processes x 4 CPU shards joined over gloo, on the pattern
of tests/test_multihost.py.  Each process drives its own four shards of
one 8-shard global mesh; TPC-H Q1 (aggregation) and Q3 (joins, sort,
limit) at SF 0.002 over the mesh give the single-device rows in both
processes.  Then one process's shard bodies fail: the other process
raises at its next collective instead of hanging."""

import os
import socket
import subprocess
import sys

_WORKER = r"""
import os, sys
rank = int(sys.argv[1]); port = sys.argv[2]
os.environ["DFTPU_COORDINATOR"] = f"127.0.0.1:{port}"
os.environ["DFTPU_NUM_PROCESSES"] = "2"
os.environ["DFTPU_PROCESS_ID"] = str(rank)
sys.path.insert(0, sys.argv[3])
import torch
torch.set_num_threads(2)
from datafusion_tpu_torch import ExecutionContext, tpchdata
from datafusion_tpu_torch.errors import InternalError
from datafusion_tpu_torch.parallel import multihost
from datafusion_tpu_torch.parallel.collectives import Psum, run_spmd
from datafusion_tpu_torch.parallel.executor import SpmdExecutor
from datafusion_tpu_torch.queries import run_tpch, run_tpch_spmd
assert multihost.initialize(device="cpu", timeout_s=120)
assert multihost.process_info() == (rank, 2)
mesh = multihost.global_mesh(4)
assert mesh.devices.size == 8 and mesh.local_shards == list(range(4 * rank, 4 * rank + 4))
ctx = ExecutionContext(device="cpu")
tpchdata.register_tpch(ctx, tpchdata.generate_tpch(0.002, 7))
for q in (1, 3):
    ex = SpmdExecutor(mesh, strict=True)
    got = run_tpch_spmd(ctx, q, ex).to_pydict()
    want = run_tpch(ctx, q).to_pydict()
    assert ex.fallback_count == 0, ex.node_modes
    assert list(got) == list(want) and len(got[next(iter(got))]) > 0, q
    for k in want:
        for x, y in zip(got[k], want[k]):
            assert x == y or abs(x - y) <= 1e-12 * max(abs(y), 1.0), (q, k, x, y)

def body(me):
    total = yield Psum(torch.ones(2))
    assert float(total[0]) == 8.0
    if rank == 1:
        raise ValueError("rank 1 failed")
    yield Psum(torch.ones(2))

try:
    run_spmd(mesh, body, [()] * 4, "divergent")
except ValueError as e:
    assert rank == 1, e
except InternalError as e:
    assert rank == 0 and "failed" in str(e), e
else:
    raise AssertionError("no error")
print("MULTIHOST_OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_tpch_over_two_process_global_mesh(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    procs, logs = [], []
    for rank in range(2):
        log = open(tmp_path / f"rank{rank}.log", "wb")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(rank), str(port), repo],
            stdout=log, stderr=subprocess.STDOUT, cwd=repo,
        ))
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    for rank, p in enumerate(procs):
        out = (tmp_path / f"rank{rank}.log").read_bytes().decode(errors="replace")
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        assert "MULTIHOST_OK" in out, out[-4000:]
