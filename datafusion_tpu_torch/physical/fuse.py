"""FuseStages physical-optimizer rule: wrap maximal fusable subtrees in a
StageExec so they execute as one fused pass over the stage's buffers, and
a fusable query tail above any other input (a join, a union, another
stage) in a TailStageExec.

Port of ``datafusion_tpu/physical/fuse.py``.  Scan-rooted stages are
cached across queries by a structural signature (plan shape + source
column dtypes, capacities and dictionaries).  A window (WindowAggExec)
fuses where an aggregate would.  A subtree that ShareCommonSubtrees
(physical/dedup.py) marked as shared is a stage boundary: both of its
users see the same node, so its result memo is reused.  A chain over a
host-resident table streams its morsels (``MorselStageExec``), and so
does a join whose one side is a host table under filters and projections
(``MorselJoinStageExec``, physical/morsel.py).
"""

from __future__ import annotations

from ..columnar.table import Table
from ..datasource.host import HostMemoryExec
from ..ops import kernels as K
from ..ops.aggregate import HashAggregateExec
from ..ops.base import ExecutionPlan
from ..ops.basic import FilterExec, GlobalLimitExec, MemoryExec, ProjectionExec
from ..ops.join import SHRINK_SYNC_MIN_CAP, HashJoinExec
from ..ops.sort import SortExec
from ..ops.window import WindowAggExec
from .morsel import MorselJoinStageExec, MorselStageExec
from .stage_compiler import CompiledStage, compilable, node_jit_safe

_STAGE_CACHE: dict = {}


class StageExec(ExecutionPlan):
    def __init__(self, inner: ExecutionPlan, root: bool = False):
        super().__init__()
        self.inner = inner
        # a root stage feeds collect() directly: skip the output shrink and
        # its count sync — the collect slices by the (lazy) count
        self.root = root
        self.stage = CompiledStage(inner)
        # THIS plan's source scan: a cache hit swaps in a CompiledStage
        # built for an earlier (same-signature) plan, so execution must
        # feed the CURRENT table's buffers
        self._source = self.stage.source
        src = self._source.execute()
        sig = (
            inner.display(),
            tuple(
                (
                    str(c.dtype),
                    c.capacity,
                    id(c.dictionary),
                    K.vrange_narrows_i32(c.vrange),
                )
                for c in src.columns
            ),
        )
        cached = _STAGE_CACHE.get(sig)
        if cached is not None:
            self.stage = cached
        else:
            _STAGE_CACHE[sig] = self.stage

    def schema(self):
        return self.inner.schema()

    def children(self):
        return []

    def with_new_children(self, c):
        return self

    def _execute(self) -> Table:
        return self.stage.execute(shrink=not self.root, src=self._source.execute())

    def _display_line(self):
        r = " root" if self.root else ""
        return f"StageExec[fused x{len(self.stage.chain)}{r}]"


class TailStageExec(ExecutionPlan):
    """A fusable query tail (Limit?/Sort?/Proj*/Agg?/(Filter|Proj)*) above a
    non-fusable input: the input executes normally, then the whole tail
    runs as one fused pass, with no per-operator compactions or count
    syncs inside it."""

    def __init__(self, chain_plan: ExecutionPlan, input_exec: ExecutionPlan, root: bool = False):
        super().__init__()
        self.inner = chain_plan
        self.input_exec = input_exec
        self.root = root
        self.stage = CompiledStage(chain_plan, source_node=input_exec)

    def schema(self):
        return self.inner.schema()

    def children(self):
        return [self.input_exec]

    def with_new_children(self, c):
        return self

    def _execute(self) -> Table:
        # the tail's sorts and aggregates run at the input's capacity:
        # right-size a large, sparsely filled input first (one count sync,
        # skipped for an input sized from a learned capacity); the tail
        # learns its own output capacity per input signature
        t = self.input_exec.execute().shrink_to_fit(only_if_above=SHRINK_SYNC_MIN_CAP)
        return self.stage.execute(shrink=not self.root, src=t)

    def _display_line(self):
        r = " root" if self.root else ""
        return f"TailStageExec[fused x{len(self.stage.chain)}{r}]"


def _fusable_chain(plan: ExecutionPlan):
    """Longest fusable prefix (the grammar of `compilable`, any source).
    Returns (chain_top_to_bottom, source_below) or (None, None)."""

    def ok(n):
        # a shared subtree is a stage boundary; the shared node itself
        # (n is plan) may still head its own chain
        return node_jit_safe(n) and (n is plan or not getattr(n, "_dedup_shared", False))

    chain = []
    node = plan
    if isinstance(node, GlobalLimitExec) and ok(node):
        chain.append(node)
        node = node.input
    if isinstance(node, SortExec) and ok(node):
        chain.append(node)
        node = node.input
    while isinstance(node, ProjectionExec) and ok(node):
        chain.append(node)
        node = node.input
    if isinstance(node, HashAggregateExec) and node.mode in ("single", "partial") and ok(node):
        chain.append(node)
        node = node.input
    elif isinstance(node, WindowAggExec) and ok(node):
        chain.append(node)
        node = node.input
    while isinstance(node, (FilterExec, ProjectionExec)) and ok(node):
        chain.append(node)
        node = node.input
    return (chain, node) if chain else (None, None)


class FuseStages:
    name = "fuse_stages"

    def optimize(self, plan: ExecutionPlan) -> ExecutionPlan:
        return self._opt(plan, is_root=True)

    def _try_morsel_join(self, plan: ExecutionPlan, is_root: bool):
        """chain? -> HashJoin(host chain -> HostMemoryExec, other side):
        stream the host table's morsels through the join against the other
        side, which stays on the device (MorselJoinStageExec), for the join
        types that are sound per morsel."""
        chain, below = _fusable_chain(plan)
        if chain is None:
            chain, below = [], plan
        if not isinstance(below, HashJoinExec):
            return None
        if any(isinstance(op, WindowAggExec) for op in chain):
            return None  # per-morsel windows would split partitions
        for host_on_left, child, other in (
            (True, below.left, below.right),
            (False, below.right, below.left),
        ):
            types = (
                MorselJoinStageExec.HOST_LEFT_TYPES
                if host_on_left
                else MorselJoinStageExec.HOST_RIGHT_TYPES
            )
            if below.join_type not in types:
                continue
            hchain, hbelow = _fusable_chain(child)
            if hchain is None:
                hchain, hbelow = [], child
            if not isinstance(hbelow, HostMemoryExec):
                continue
            if not all(isinstance(op, (FilterExec, ProjectionExec)) for op in hchain):
                continue
            return MorselJoinStageExec(
                chain, below, hchain, hbelow, host_on_left,
                self._opt(other, False), root=is_root,
            )
        return None

    def _opt(self, plan: ExecutionPlan, is_root: bool) -> ExecutionPlan:
        # host-resident sources stream morsels through the fused stage;
        # checked before StageExec, which would materialize the whole
        # table (a HostMemoryExec is a MemoryExec)
        chain, below = _fusable_chain(plan)
        if (
            chain is not None
            and isinstance(below, HostMemoryExec)
            and not any(isinstance(op, WindowAggExec) for op in chain)
        ):
            return MorselStageExec(chain, below, root=is_root)
        mj = self._try_morsel_join(plan, is_root)
        if mj is not None:
            return mj
        if compilable(plan) and not isinstance(plan, MemoryExec):
            return StageExec(plan, root=is_root)
        # tail fusion: a fusable prefix above a non-fusable input (a join,
        # a union, an operator whose expressions read data on the host, a
        # stage the grammar ends below) still runs as one fused pass
        if chain is not None:
            inner = self._opt(below, False)
            rebuilt = inner
            for op in reversed(chain):
                rebuilt = op.with_new_children([rebuilt])
            return TailStageExec(rebuilt, inner, root=is_root)
        kids = plan.children()
        if not kids:
            return plan
        return plan.with_new_children([self._opt(c, False) for c in kids])
