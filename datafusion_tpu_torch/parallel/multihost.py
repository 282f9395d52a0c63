"""Multi-process SPMD bring-up: ``torch.distributed`` and a global mesh.

Port of ``datafusion_tpu/parallel/multihost.py``.  The reference scales
out as a networked Ballista cluster (a scheduler plus one executor process
per machine).  Here every process joins one ``torch.distributed`` process
group and drives its own shards of ONE global mesh; the SPMD operators
(parallel/ops.py) run unchanged.  Collectives are hierarchical: the local
shards meet in ``collectives.run_spmd``, then one ``torch.distributed``
call per collective crosses the processes (``all_to_all_single``,
``all_gather`` or ``all_reduce``).  Static shapes make every process's
operand the same size.  Before each collective the processes agree on it
(one small all-gather of its signature), so processes whose plans
diverge, or one that failed, raise instead of hanging.

Configuration from the environment, as the JAX package reads it:

  DFTPU_COORDINATOR    host:port of process 0's rendezvous
  DFTPU_NUM_PROCESSES  total process count
  DFTPU_PROCESS_ID     this process's rank

With none set, ``initialize()`` is a no-op and the single-process path
stays untouched.  The CPU shards use gloo, cards NCCL (one process per
card).  ``global_mesh(n_local)`` takes the shards per process (default:
one per card, 8 on the CPU).
"""

from __future__ import annotations

import atexit
import os
import zlib
from datetime import timedelta

import torch

from ..device import resolve_device
from .collectives import (
    _INT_OF_SIZE,
    AllGather,
    AllToAll,
    CrossProcessMismatch,
    Pmax,
    Psum,
)

_STATE = {"initialized": False, "device": None}


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
    timeout_s: float = 300.0,
) -> bool:
    """Join this process to the multi-process runtime.  Arguments default
    from DFTPU_COORDINATOR / DFTPU_NUM_PROCESSES / DFTPU_PROCESS_ID.
    ``device=None`` means the card (NCCL); "cpu" uses gloo.  Returns True
    when a multi-process runtime was (or already is) initialized, False for
    the single-process no-op.  Idempotent."""
    if _STATE["initialized"]:
        return True
    coordinator_address = coordinator_address or os.environ.get("DFTPU_COORDINATOR")
    if num_processes is None and os.environ.get("DFTPU_NUM_PROCESSES"):
        num_processes = int(os.environ["DFTPU_NUM_PROCESSES"])
    if process_id is None and os.environ.get("DFTPU_PROCESS_ID"):
        process_id = int(os.environ["DFTPU_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=timedelta(seconds=timeout_s),
    )
    _STATE.update(initialized=True, device=dev)
    # leave the group before the interpreter tears down: a gloo group still
    # alive at exit can abort the process after its work is done
    atexit.register(dist.destroy_process_group)
    return True


def process_info() -> tuple[int, int]:
    """(process_id, num_processes) of the joined runtime; (0, 1) when
    single-process."""
    if not _STATE["initialized"]:
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def local_device_count() -> int:
    """The shards this process drives in ``global_mesh`` by default: one
    per card, 8 on the CPU (the JAX test environment's virtual devices)."""
    dev = _STATE["device"] or torch.device("cpu")
    return 1 if dev.type == "cuda" else 8


def global_mesh(n_local: int | None = None):
    """A mesh over every process's shards: process r drives global shards
    [r*L, (r+1)*L).  The operator code is the single-process code."""
    from .mesh import Mesh

    rank, world = process_info()
    n = n_local or local_device_count()
    dev = _STATE["device"] or torch.device("cpu")
    cross = _Cross(world, rank, n, dev) if world > 1 else None
    return Mesh([dev] * (n * world), range(rank * n, (rank + 1) * n), cross)


class _Cross:
    """The cross-process half of a collective: every process holds
    ``nlocal`` shards and meets the others through torch.distributed."""

    def __init__(self, nproc: int, rank: int, nlocal: int, device):
        self.nproc, self.rank, self.nlocal, self.device = nproc, rank, nlocal, device

    # ---- agreement -----------------------------------------------------
    def _header(self, code: int, what) -> None:
        import torch.distributed as dist

        mine = torch.tensor([code, zlib.crc32(repr(what).encode())], dtype=torch.int64, device=self.device)
        got = [torch.empty_like(mine) for _ in range(self.nproc)]
        dist.all_gather(got, mine)
        odd = [p for p, g in enumerate(got) if not torch.equal(g, mine)]
        if odd:
            codes = {p: int(got[p][0]) for p in odd}
            raise CrossProcessMismatch(
                f"processes {odd} ({codes}: 0 collective, 1 finished, 2 failed) "
                f"disagree with process {self.rank} at {what!r}"
            )

    def agree(self, name: str, sig) -> None:
        self._header(1 if sig == ("done",) else 0, (name, sig))

    def abandon(self, name: str) -> None:
        """Tell the other processes that this one failed (they raise at
        their next agreement)."""
        try:
            self._header(2, (name, "failed"))
        except CrossProcessMismatch:
            pass

    # ---- data ----------------------------------------------------------
    def all_reduce(self, v: torch.Tensor, op: str) -> torch.Tensor:
        import torch.distributed as dist

        out = v.to(self.device).clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
        return out

    def perform(self, reqs: list) -> list:
        """Each local shard's result of one collective over every process."""
        import torch.distributed as dist

        xs = [r.x for r in reqs]
        devs = [x.device for x in xs]
        kind = type(reqs[0])
        dtype = xs[0].dtype
        P, L = self.nproc, self.nlocal
        if kind in (Psum, Pmax):
            s = torch.stack([x.to(self.device) for x in xs])
            out = s.sum(0, dtype=dtype) if kind is Psum else s.amax(0)
            dist.all_reduce(out, op=dist.ReduceOp.SUM if kind is Psum else dist.ReduceOp.MAX)
            parts = [out] * L
        else:
            it = _INT_OF_SIZE[xs[0].element_size()]
            s = torch.stack([x.to(self.device).view(it) for x in xs])  # [L, ...]
            if kind is AllToAll:
                tail = tuple(s.shape[2:])
                send = s.reshape((L, P, L) + tail).transpose(0, 1).contiguous()
                recv = torch.empty_like(send)
                dist.all_to_all_single(recv, send)  # [P src, L src, L dst, ...]
                recv = recv.reshape((P * L, L) + tail)
                parts = [recv[:, j].view(dtype) for j in range(L)]
            elif kind is AllGather:
                got = [torch.empty_like(s) for _ in range(P)]
                dist.all_gather(got, s.contiguous())
                out = torch.cat(got).view(dtype)
                parts = [out] * L
            else:
                raise CrossProcessMismatch(f"unknown collective {kind.__name__}")
        return [p if p.device == d else p.to(d) for p, d in zip(parts, devs)]
