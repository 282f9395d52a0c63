"""User-defined functions: ScalarUDF and AggregateUDF.

Reference equivalents: ScalarUDF (datafusion/src/physical_plan/
udf.rs:38), AggregateUDF (udaf.rs:44), registered through
ExecutionContext::register_udf/udaf (execution/context.rs:249,264).

Contracts (vectorized: the reference's row-oriented Accumulator trait
has no data-parallel equivalent).  A function's body receives torch
tensors, on the context's device, and returns torch tensors:

  ScalarUDF.fun(*data_tensors) -> data tensor (or (data, valid) to control
  null handling; by default a row is null when any argument is).  Each
  argument is a column's whole buffer ([capacity], the storage dtype of
  its type; dead and null rows hold arbitrary values).

  AggregateUDF is a commutative MONOID: `zero` identity + associative
  `step(acc, x) -> acc` on tensors, evaluated as a segmented scan of the
  group's values (``ops/kernels.py::_segment_scan``, in the reference's
  order), plus an optional `finalize(acc, count)` on tensors.  Its
  partial state is (accumulator, count), so it merges across the morsels
  of a host-resident table.  sum-of-squares, product, bit_or, bool_and,
  min-by-abs ... all fit; true sequential accumulators do not.

A UDF inside a fused stage or a captured CUDA graph must make only torch
operations on its arguments: no host reads (``.item()``, ``.tolist()``,
``.cpu()``) and no tensors copied from the host.  On the card the plan's
check runs with torch's synchronization check set to raise, so a UDF that
reads the host fails the check; the failure names the plan node that ran
it (``plan._whole_query.failure``), and the plan keeps running node by
node, where the read is allowed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..types.dtypes import DataType


@dataclass
class ScalarUDF:
    name: str
    input_types: list[DataType]
    return_type: DataType
    fun: Callable  # (*torch data tensors) -> data array | (data, valid)

    def __post_init__(self):
        self.name = self.name.lower()


@dataclass
class AggregateUDF:
    name: str
    input_type: DataType
    return_type: DataType
    zero: object  # identity element (python scalar)
    step: Callable  # (acc, x) -> acc ; associative + commutative
    finalize: Optional[Callable] = None  # (acc, count) -> value

    def __post_init__(self):
        self.name = self.name.lower()


def create_udf(name, input_types, return_type, fun) -> ScalarUDF:
    """Convenience mirroring datafusion::physical_plan::udf::create_udf."""
    return ScalarUDF(name, list(input_types), return_type, fun)


def create_udaf(name, input_type, return_type, zero, step, finalize=None) -> AggregateUDF:
    return AggregateUDF(name, input_type, return_type, zero, step, finalize)
