"""Engine error taxonomy.

Mirrors the reference's DataFusionError enum
(datafusion/src/error.rs:40-80): ArrowError, ParquetError,
IoError, SQL/parser errors, NotImplemented, Internal, Plan, Execution.
"""


class DataFusionError(Exception):
    """Base error for all engine failures."""


class PlanError(DataFusionError):
    """Error during logical/physical planning (reference: Plan variant)."""


class SchemaError(PlanError):
    """Unresolvable column / ambiguous reference / type mismatch."""


class ParserError(DataFusionError):
    """SQL tokenizer/parser error (reference: SQL(ParserError))."""


class ExecutionError(DataFusionError):
    """Runtime failure while executing a physical plan."""


class HostReadInWholeQuery(ExecutionError):
    """A node needed a value on the host (or a fresh host-to-device copy)
    while a warm plan was being built into one whole-query run
    (``physical/query_compiler.py``): such a plan keeps running node by
    node.  ``node`` names the innermost operator that was running."""

    def __init__(self, what: str):
        super().__init__(what)
        self.what = what
        self.node = None

    def __str__(self):
        return self.what if self.node is None else f"{self.node}: {self.what}"


class NotImplementedError_(DataFusionError):
    """Feature present in SQL surface but not yet supported."""


class InternalError(DataFusionError):
    """Invariant violation — a bug in the engine."""
