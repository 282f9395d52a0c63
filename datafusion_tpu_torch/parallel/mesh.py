"""Device mesh + sharded tables: the engine's partition model.

Port of ``datafusion_tpu/parallel/mesh.py``.  Replaces the reference's
partition-per-Tokio-task model and Ballista's executor fleet: a partition
is one mesh shard of every column buffer; an exchange is a collective
(``collectives.py``) instead of RepartitionExec channels or Arrow Flight
shuffle files.

One mesh axis shards the row axis.  A ShardedTable holds one
tensor per column per shard, on that shard's device, plus a per-shard
live-row count; live rows sit at the FRONT of each shard (the same
compaction invariant as single-device Tables).  Several logical shards
may share one device (8 shards on one card, or on the CPU).

In a multi-process mesh (``multihost.py``) each process holds and drives
only its own shards (``Mesh.local_shards``); ``nrows`` then counts those,
and the host reads that must agree across processes (capacities,
overflow maxima, gathered results) cross the processes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..columnar.column import Column
from ..columnar.table import Table, host_numpy, round_capacity
from ..device import resolve_device
from ..ops import kernels as K
from .collectives import gather_columns, run_spmd

class Mesh:
    """``devices``: a numpy array of ``ndev`` torch devices, one per shard
    (repeated where shards share a device).  ``local_shards``: the global
    indices of the shards this process drives (all of them in a single
    process).  ``cross``: the cross-process transport, or None."""

    def __init__(self, devices, local_shards=None, cross=None):
        devs = list(devices)
        self.devices = np.empty(len(devs), dtype=object)
        for i, d in enumerate(devs):
            self.devices[i] = torch.device(d)
        n = len(devs)
        self.local_shards = list(range(n)) if local_shards is None else list(local_shards)
        self.cross = cross

    @property
    def ndev(self) -> int:
        return int(self.devices.size)

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard (where ``nrows`` lives)."""
        return self.devices[self.local_shards[0]]

    def host_reduce(self, x: torch.Tensor, op: str = "max") -> np.ndarray:
        """The max (or sum) over every shard of the mesh of the per-shard
        rows of ``x`` ([local shards, ...]) read on the host: one host
        sync, plus one cross-process reduction in a multi-process mesh."""
        x = x.to(torch.int64)
        v = x.amax(0) if op == "max" else x.sum(0)
        if self.cross is not None:
            v = self.cross.all_reduce(v, op)
        return host_numpy(v)

    def __repr__(self):
        return f"Mesh({self.ndev} shards on {sorted({str(d) for d in self.devices})})"


def make_mesh(n_devices: int | None = None, devices=None, device=None) -> Mesh:
    """A mesh of ``n_devices`` shards.  ``device=None`` means the CUDA
    cards (and raises with none): shards are placed round-robin over the
    visible cards, several logical shards per card where there are fewer
    cards; with no ``n_devices``, one shard per card.  On the CPU the
    default is 8 shards, as the JAX package's test environment has."""
    if devices is not None:
        return Mesh(devices)
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = (
            [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if dev.index is None else [dev]
        )
        n = n_devices or len(cards)
        return Mesh([cards[i % len(cards)] for i in range(n)])
    return Mesh([dev] * (n_devices or 8))


def segment_compaction(counts: torch.Tensor, seg_cap: int, out_cap: int):
    """The gather index that packs the live prefixes of ``len(counts)``
    segments of ``seg_cap`` slots (segment s holds ``counts[s]`` live rows
    from its start) to the front of ``out_cap`` slots, in segment order,
    and the live mask of the output.  A binary search over the prefix sums,
    no sort and no host read."""
    n = counts.shape[0]
    cum = torch.cumsum(counts, 0)
    r = torch.arange(out_cap, device=counts.device)
    s = torch.searchsorted(cum, r, right=True).clamp_(max=max(n - 1, 0))
    w = r - (cum - counts)[s]
    idx = torch.clamp(s * seg_cap + w, 0, max(n * seg_cap - 1, 0))
    return idx, r < cum[-1]


@dataclass
class ShardedTable:
    """Row-sharded table: ``datas[c][j]`` and ``valids[c][j]`` are column
    c's buffers on local shard j (``shard_cap`` rows, on that shard's
    device); ``nrows`` is an [local shards] int64 tensor of live-row counts
    on ``mesh.home``.  ``exchange_info`` carries the producing operator's
    exchange statistics (mesh EXPLAIN ANALYZE)."""

    names: list[str]
    dtypes: list
    dicts: list
    datas: list
    valids: list
    nrows: torch.Tensor
    mesh: Mesh
    shard_cap: int
    exchange_info: dict = field(default_factory=dict)

    @property
    def ndev(self) -> int:
        return self.mesh.ndev

    def count(self, j: int) -> torch.Tensor:
        """Local shard j's live-row count, a 0-dim tensor on its device."""
        n = self.nrows[j]
        d = self.mesh.devices[self.mesh.local_shards[j]]
        return n if n.device == d else n.to(d)

    def shard_args(self) -> list:
        """Per local shard: (column datas, column valids, row count)."""
        return [
            ([d[j] for d in self.datas], [v[j] for v in self.valids], self.count(j))
            for j in range(len(self.mesh.local_shards))
        ]

    def total_rows(self) -> int:
        return int(self.mesh.host_reduce(self.nrows.reshape(-1, 1), "sum")[0])

    def with_columns(self, names, dtypes, dicts, datas, valids, counts, shard_cap) -> "ShardedTable":
        """A table on the same mesh from per-shard results: ``datas[c][j]``
        and ``counts[j]`` (0-dim) per local shard j."""
        return ShardedTable(
            list(names), list(dtypes), list(dicts), datas, valids,
            stack_counts(counts, self.mesh), self.mesh, shard_cap,
        )

    # ---- host <-> device ------------------------------------------------
    @staticmethod
    def from_table(t: Table, mesh: Mesh) -> "ShardedTable":
        """Round-robin-block scatter a single-device Table onto the mesh
        (the reference's RepartitionExec::RoundRobinBatch): shard d holds
        rows [d*per, (d+1)*per), per = ceil(n / ndev), as in the JAX
        package.  The slices are cut on the table's device."""
        ndev = mesh.ndev
        n = t.nrows
        per = -(-max(n, 1) // ndev)
        shard_cap = round_capacity(per)
        counts = np.minimum(np.maximum(n - per * np.arange(ndev), 0), per)
        datas, valids = [], []
        for c in t.columns:
            datas.append(_block_shards(c.data, per, counts, shard_cap, mesh))
            valids.append(_block_shards(c.valid, per, counts, shard_cap, mesh))
        return ShardedTable(
            list(t.names), [c.dtype for c in t.columns], [c.dictionary for c in t.columns],
            datas, valids, _host_counts(counts, mesh), mesh, shard_cap,
        )

    @staticmethod
    def from_host(host, mesh: Mesh) -> "ShardedTable":
        """Shard a HOST-resident table (datasource/host.py HostTable)
        straight onto the mesh: each shard's device receives only its own
        N/ndev row slice, so the full table never materializes on any
        single device."""
        ndev = mesh.ndev
        n = host.nrows
        per = -(-max(n, 1) // ndev)
        shard_cap = round_capacity(per)
        counts = np.minimum(np.maximum(n - per * np.arange(ndev), 0), per)
        datas, valids = [], []
        for arrays, out in ((host.datas, datas), (host.valids, valids)):
            for a in arrays:
                col = []
                for g in mesh.local_shards:
                    lo, k = g * per, int(counts[g])
                    buf = torch.zeros((shard_cap,) + a.shape[1:], dtype=_torch_of(a), device=mesh.devices[g])
                    if k:
                        buf[:k].copy_(torch.from_numpy(a[lo: lo + k]))
                    col.append(buf)
                out.append(col)
        return ShardedTable(
            list(host.names), list(host.dtypes), list(host.dicts),
            datas, valids, _host_counts(counts, mesh), mesh, shard_cap,
        )

    def shrink(self, margin: int = 0) -> "ShardedTable":
        """Right-size shard capacity to the live-row maximum over the mesh.

        Distributed operators size outputs statically (join pair capacity
        = fanout * probe capacity, shuffle receive = ndev * bucket); without
        shrinking, capacities compound across a plan.  One host read of the
        counts; live rows are front-compacted, so each shard is a slice."""
        need = int(self.mesh.host_reduce(self.nrows.reshape(-1, 1))[0]) + margin
        newcap = round_capacity(max(need, 1))
        if newcap >= self.shard_cap:
            return self
        return ShardedTable(
            list(self.names), list(self.dtypes), list(self.dicts),
            [[x[:newcap] for x in d] for d in self.datas],
            [[x[:newcap] for x in v] for v in self.valids],
            self.nrows, self.mesh, newcap, dict(self.exchange_info),
        )

    def _gathered(self):
        """Every shard's columns and counts on ``mesh.home``: ([ndev, cap]
        per data column, [ndev, cap] per valid column, counts [ndev])."""
        ncols = len(self.datas)

        def body(me, datas, valids, n):
            got = yield from gather_columns(list(datas) + list(valids) + [n.reshape(1)])
            return got

        res = run_spmd(self.mesh, body, self.shard_args(), "gather")[0]
        home = self.mesh.home
        res = [x.to(home) for x in res]
        return res[:ncols], res[ncols: 2 * ncols], res[-1].reshape(-1)

    def shard_tables(self) -> list[Table]:
        """One single-device Table per shard (collect_partitioned contract:
        dataframe.rs returns per-partition batches), on ``mesh.home``."""
        gd, gv, counts = self._gathered()
        host = host_numpy(counts)
        out = []
        for i in range(self.ndev):
            n = int(host[i])
            cap = round_capacity(max(n, 1))
            cols = [
                Column(dt, pad_rows(d[i, :n], cap), pad_rows(v[i, :n], cap), dic)
                for dt, dic, d, v in zip(self.dtypes, self.dicts, gd, gv)
            ]
            out.append(Table(list(self.names), cols, n, device=self.mesh.home))
        return out

    def to_table(self) -> Table:
        """Gather all shards into one compacted Table on ``mesh.home``, in
        shard order."""
        gd, gv, counts = self._gathered()
        total = int(host_numpy(counts.sum()))
        cap = round_capacity(total)
        idx, live = segment_compaction(counts, self.shard_cap, cap)
        cols = [
            Column(dt, K.gather(d.reshape((-1,) + d.shape[2:]), idx), v.reshape(-1)[idx] & live, dic)
            for dt, dic, d, v in zip(self.dtypes, self.dicts, gd, gv)
        ]
        return Table(list(self.names), cols, total, device=self.mesh.home)


def stack_counts(counts: list, mesh: Mesh) -> torch.Tensor:
    """Per-local-shard 0-dim counts as the [local shards] int64 ``nrows``."""
    home = mesh.home
    return torch.stack([torch.as_tensor(c).to(home, torch.int64).reshape(()) for c in counts])


def _host_counts(counts: np.ndarray, mesh: Mesh) -> torch.Tensor:
    return torch.tensor([int(counts[g]) for g in mesh.local_shards], dtype=torch.int64, device=mesh.home)


def _block_shards(x: torch.Tensor, per: int, counts: np.ndarray, shard_cap: int, mesh: Mesh) -> list:
    """Shard g's block [g*per, g*per + counts[g]) of ``x`` at the front of
    ``shard_cap`` zeroed slots on its device, for each local shard g."""
    out = []
    for g in mesh.local_shards:
        lo, k = g * per, int(counts[g])
        buf = x.new_zeros((shard_cap,) + tuple(x.shape[1:]), device=mesh.devices[g])
        buf[:k] = x[lo: lo + k]
        out.append(buf)
    return out


def pad_rows(x: torch.Tensor, cap: int) -> torch.Tensor:
    """``x``'s rows at the front of ``cap`` zeroed rows."""
    out = x.new_zeros((cap,) + tuple(x.shape[1:]))
    out[: x.shape[0]] = x
    return out


def _torch_of(a: np.ndarray) -> torch.dtype:
    from ..device import torch_dtype

    return torch_dtype(a.dtype)
