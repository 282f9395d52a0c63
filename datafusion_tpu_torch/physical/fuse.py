"""FuseStages physical-optimizer rule: wrap maximal fusable subtrees in a
StageExec so they execute as one fused pass over the stage's buffers.

Port of ``datafusion_tpu/physical/fuse.py``.  Stages are cached across
queries by a structural signature (plan shape + source column dtypes,
capacities and dictionaries).  The reference also fuses a query tail
above a join or another non-scan input (``TailStageExec``, slice 3) and
streams host tables in morsels (slice 6); here such a tail runs unfused.
"""

from __future__ import annotations

from ..columnar.table import Table
from ..ops import kernels as K
from ..ops.base import ExecutionPlan
from ..ops.basic import MemoryExec
from .stage_compiler import CompiledStage, compilable

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


class FuseStages:
    name = "fuse_stages"

    def optimize(self, plan: ExecutionPlan) -> ExecutionPlan:
        return self._opt(plan, is_root=True)

    def _opt(self, plan: ExecutionPlan, is_root: bool) -> ExecutionPlan:
        if compilable(plan) and not isinstance(plan, MemoryExec):
            return StageExec(plan, root=is_root)
        # the reference fuses a tail above a non-scan input into a
        # TailStageExec; until that is ported (with joins, slice 3) such a
        # tail runs operator by operator, with the same results.  It sits
        # above an EmptyExec (`SELECT 1 + 1`, a count folded from
        # statistics), a UNION, an OFFSET, a stage the grammar ends below (a
        # grouping subquery, a projection over LIMIT) or an operator whose
        # expressions read column data on the host; joins and host tables
        # raise in the planner
        kids = plan.children()
        if not kids:
            return plan
        return plan.with_new_children([self._opt(c, False) for c in kids])
