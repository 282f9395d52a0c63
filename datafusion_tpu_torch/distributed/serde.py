"""Plan serialization: logical and physical plans <-> JSON-able dicts.

Port of ``datafusion_tpu/distributed/serde.py``.  Equivalent of
Ballista's protobuf plan serde (ballista/rust/core/proto/ballista.proto:
50-690 and core/src/serde/{logical_plan,physical_plan}/): the contract
that every operator and expression must round-trip over the control
plane.  The scheduler receives logical plans (ExecuteQuery), and executors
receive physical stage plans (TaskDefinition), both as these dicts.  The
dicts are the JAX package's for the same plan, so either engine's
processes read the other's.

JSON (not protobuf) because the control plane is host-side Python; the
data plane never goes through serde.  No device travels on the wire:
``pplan_from_dict(..., device=)`` places the nodes that make tables (an
empty relation, a shuffle reader) on the receiving executor's device.
"""

from __future__ import annotations

from typing import Any, Callable

from ..errors import InternalError, PlanError
from ..logical import plan as L
from ..logical.dfschema import DFField, DFSchema
from ..logical.expr import (
    AggregateFunction,
    Alias,
    Between,
    BinaryExpr,
    Case,
    Cast,
    Column,
    Exists,
    Expr,
    InList,
    InSubquery,
    IsNotNull,
    IsNull,
    Literal,
    Negative,
    Not,
    OuterColumn,
    ScalarFunction,
    ScalarSubquery,
    SortExpr,
    Wildcard,
    WindowFrame,
    WindowFrameBound,
    WindowFunction,
)
from ..exprs import physical as P
from ..ops.aggregate import HashAggregateExec, PhysAggExpr
from ..ops.base import ExecutionPlan
from ..ops.basic import (
    EmptyExec,
    FilterExec,
    GlobalLimitExec,
    MemoryExec,
    ProjectionExec,
    SkipExec,
    UnionExec,
)
from ..ops.join import CrossJoinExec, HashJoinExec
from ..ops.joinagg import CrossJoinAggExec
from ..ops.sort import PhysSortExpr, SortExec
from ..ops.window import PhysWindowExpr, WindowAggExec
from ..types import Field, ScalarValue, Schema
from ..types.dtypes import DataType
from .exchange import (
    DistScanExec,
    ShuffleReaderExec,
    ShuffleWriterExec,
    UnresolvedShuffleExec,
)

# ---------------------------------------------------------------------------
# types / scalars / schemas
# ---------------------------------------------------------------------------


def dtype_to_dict(dt: DataType) -> dict:
    return {"kind": dt.kind, "precision": dt.precision, "scale": dt.scale, "tz": dt.tz}


def dtype_from_dict(d: dict) -> DataType:
    return DataType(d["kind"], d.get("precision", 0), d.get("scale", 0), d.get("tz"))


def scalar_to_dict(sv: ScalarValue) -> dict:
    return {"dtype": dtype_to_dict(sv.dtype), "value": sv.value}


def scalar_from_dict(d: dict) -> ScalarValue:
    return ScalarValue(dtype_from_dict(d["dtype"]), d["value"])


def schema_to_dict(s: Schema) -> dict:
    return {
        "fields": [
            {"name": f.name, "dtype": dtype_to_dict(f.dtype), "nullable": f.nullable}
            for f in s.fields
        ]
    }


def schema_from_dict(d: dict) -> Schema:
    return Schema(
        [
            Field(f["name"], dtype_from_dict(f["dtype"]), f["nullable"])
            for f in d["fields"]
        ]
    )


def dfschema_to_dict(s: DFSchema) -> dict:
    return {
        "fields": [
            {
                "name": f.name,
                "dtype": dtype_to_dict(f.dtype),
                "nullable": f.nullable,
                "qualifier": f.qualifier,
            }
            for f in s.fields
        ]
    }


def dfschema_from_dict(d: dict) -> DFSchema:
    return DFSchema(
        [
            DFField(
                f["name"], dtype_from_dict(f["dtype"]), f["nullable"], f.get("qualifier")
            )
            for f in d["fields"]
        ]
    )


# ---------------------------------------------------------------------------
# logical expressions (ballista.proto LogicalExprNode, :206-407 equivalent)
# ---------------------------------------------------------------------------


def expr_to_dict(e: Expr) -> Any:
    if isinstance(e, Column):
        return {"e": "column", "name": e.name, "relation": e.relation}
    if isinstance(e, Alias):
        return {"e": "alias", "expr": expr_to_dict(e.expr), "name": e.name}
    if isinstance(e, Literal):
        return {"e": "literal", "value": scalar_to_dict(e.value)}
    if isinstance(e, BinaryExpr):
        return {
            "e": "binary",
            "left": expr_to_dict(e.left),
            "op": e.op,
            "right": expr_to_dict(e.right),
        }
    if isinstance(e, Not):
        return {"e": "not", "expr": expr_to_dict(e.expr)}
    if isinstance(e, Negative):
        return {"e": "negative", "expr": expr_to_dict(e.expr)}
    if isinstance(e, IsNull):
        return {"e": "is_null", "expr": expr_to_dict(e.expr)}
    if isinstance(e, IsNotNull):
        return {"e": "is_not_null", "expr": expr_to_dict(e.expr)}
    if isinstance(e, Between):
        return {
            "e": "between",
            "expr": expr_to_dict(e.expr),
            "negated": e.negated,
            "low": expr_to_dict(e.low),
            "high": expr_to_dict(e.high),
        }
    if isinstance(e, Case):
        return {
            "e": "case",
            "expr": expr_to_dict(e.expr) if e.expr is not None else None,
            "when_then": [[expr_to_dict(w), expr_to_dict(t)] for w, t in e.when_then],
            "else": expr_to_dict(e.else_expr) if e.else_expr is not None else None,
        }
    if isinstance(e, Cast):
        return {
            "e": "cast",
            "expr": expr_to_dict(e.expr),
            "dtype": dtype_to_dict(e.dtype),
            "safe": e.safe,
        }
    if isinstance(e, InList):
        return {
            "e": "in_list",
            "expr": expr_to_dict(e.expr),
            "list": [expr_to_dict(x) for x in e.list_],
            "negated": e.negated,
        }
    if isinstance(e, ScalarFunction):
        return {
            "e": "scalar_fn",
            "name": e.name,
            "args": [expr_to_dict(a) for a in e.args],
        }
    if isinstance(e, AggregateFunction):
        return {
            "e": "aggregate_fn",
            "fun": e.fun,
            "args": [expr_to_dict(a) for a in e.args],
            "distinct": e.distinct,
        }
    if isinstance(e, WindowFunction):
        return {
            "e": "window_fn",
            "fun": e.fun,
            "args": [expr_to_dict(a) for a in e.args],
            "partition_by": [expr_to_dict(a) for a in e.partition_by],
            "order_by": [expr_to_dict(a) for a in e.order_by],
            "frame": _frame_to_dict(e.frame),
        }
    if isinstance(e, SortExpr):
        return {
            "e": "sort",
            "expr": expr_to_dict(e.expr),
            "ascending": e.ascending,
            "nulls_first": e.nulls_first,
        }
    if isinstance(e, Wildcard):
        return {"e": "wildcard", "qualifier": e.qualifier}
    if isinstance(e, OuterColumn):
        return {
            "e": "outer_column",
            "name": e.name,
            "relation": e.relation,
            "dtype": dtype_to_dict(e.dtype) if e.dtype is not None else None,
        }
    if isinstance(e, ScalarSubquery):
        return {"e": "scalar_subquery", "subquery": plan_to_dict(e.subquery)}
    if isinstance(e, InSubquery):
        return {
            "e": "in_subquery",
            "expr": expr_to_dict(e.expr),
            "subquery": plan_to_dict(e.subquery),
            "negated": e.negated,
        }
    if isinstance(e, Exists):
        return {
            "e": "exists",
            "subquery": plan_to_dict(e.subquery),
            "negated": e.negated,
        }
    raise PlanError(f"cannot serialize logical expr {type(e).__name__}")


def _frame_to_dict(f: WindowFrame | None):
    if f is None:
        return None
    return {
        "units": f.units,
        "start": {"kind": f.start.kind, "offset": f.start.offset},
        "end": {"kind": f.end.kind, "offset": f.end.offset},
    }


def _frame_from_dict(d) -> WindowFrame | None:
    if d is None:
        return None
    return WindowFrame(
        d["units"],
        WindowFrameBound(d["start"]["kind"], d["start"]["offset"]),
        WindowFrameBound(d["end"]["kind"], d["end"]["offset"]),
    )


def expr_from_dict(d: dict, resolver: Callable | None = None) -> Expr:
    k = d["e"]
    if k == "column":
        return Column(d["name"], d.get("relation"))
    if k == "alias":
        return Alias(expr_from_dict(d["expr"], resolver), d["name"])
    if k == "literal":
        return Literal(scalar_from_dict(d["value"]))
    if k == "binary":
        return BinaryExpr(
            expr_from_dict(d["left"], resolver), d["op"], expr_from_dict(d["right"], resolver)
        )
    if k == "not":
        return Not(expr_from_dict(d["expr"], resolver))
    if k == "negative":
        return Negative(expr_from_dict(d["expr"], resolver))
    if k == "is_null":
        return IsNull(expr_from_dict(d["expr"], resolver))
    if k == "is_not_null":
        return IsNotNull(expr_from_dict(d["expr"], resolver))
    if k == "between":
        return Between(
            expr_from_dict(d["expr"], resolver),
            d["negated"],
            expr_from_dict(d["low"], resolver),
            expr_from_dict(d["high"], resolver),
        )
    if k == "case":
        return Case(
            expr_from_dict(d["expr"], resolver) if d["expr"] is not None else None,
            [
                (expr_from_dict(w, resolver), expr_from_dict(t, resolver))
                for w, t in d["when_then"]
            ],
            expr_from_dict(d["else"], resolver) if d["else"] is not None else None,
        )
    if k == "cast":
        return Cast(
            expr_from_dict(d["expr"], resolver), dtype_from_dict(d["dtype"]), d["safe"]
        )
    if k == "in_list":
        return InList(
            expr_from_dict(d["expr"], resolver),
            [expr_from_dict(x, resolver) for x in d["list"]],
            d["negated"],
        )
    if k == "scalar_fn":
        return ScalarFunction(d["name"], [expr_from_dict(a, resolver) for a in d["args"]])
    if k == "aggregate_fn":
        return AggregateFunction(
            d["fun"], [expr_from_dict(a, resolver) for a in d["args"]], d["distinct"]
        )
    if k == "window_fn":
        return WindowFunction(
            d["fun"],
            [expr_from_dict(a, resolver) for a in d["args"]],
            [expr_from_dict(a, resolver) for a in d["partition_by"]],
            [expr_from_dict(a, resolver) for a in d["order_by"]],
            _frame_from_dict(d["frame"]),
        )
    if k == "sort":
        return SortExpr(
            expr_from_dict(d["expr"], resolver), d["ascending"], d["nulls_first"]
        )
    if k == "wildcard":
        return Wildcard(d.get("qualifier"))
    if k == "outer_column":
        return OuterColumn(
            d["name"],
            d.get("relation"),
            dtype_from_dict(d["dtype"]) if d["dtype"] is not None else None,
        )
    if k == "scalar_subquery":
        return ScalarSubquery(plan_from_dict(d["subquery"], resolver))
    if k == "in_subquery":
        return InSubquery(
            expr_from_dict(d["expr"], resolver),
            plan_from_dict(d["subquery"], resolver),
            d["negated"],
        )
    if k == "exists":
        return Exists(plan_from_dict(d["subquery"], resolver), d["negated"])
    raise PlanError(f"cannot deserialize logical expr kind '{k}'")


# ---------------------------------------------------------------------------
# logical plans (ballista.proto LogicalPlanNode, :50-205 equivalent)
# ---------------------------------------------------------------------------


def plan_to_dict(p: L.LogicalPlan) -> dict:
    if isinstance(p, L.TableScan):
        return {
            "p": "table_scan",
            "table_name": p.table_name,
            # catalog name of the provider (may differ from table_name when
            # the scan is aliased: SELECT ... FROM nation n1)
            "source_name": getattr(p.source, "registered_name", p.table_name),
            "schema": schema_to_dict(p.source.schema()),
            "projection": p.projection,
            "filters": [expr_to_dict(f) for f in p.filters],
            "limit": p.limit,
        }
    if isinstance(p, L.EmptyRelation):
        return {
            "p": "empty",
            "produce_one_row": p.produce_one_row,
            "schema": dfschema_to_dict(p.schema_),
        }
    if isinstance(p, L.Values):
        return {
            "p": "values",
            "values": [[expr_to_dict(e) for e in row] for row in p.values],
            "schema": dfschema_to_dict(p.schema_),
        }
    if isinstance(p, L.Projection):
        return {
            "p": "projection",
            "exprs": [expr_to_dict(e) for e in p.exprs],
            "input": plan_to_dict(p.input),
            "alias": p.alias,
        }
    if isinstance(p, L.Filter):
        return {
            "p": "filter",
            "predicate": expr_to_dict(p.predicate),
            "input": plan_to_dict(p.input),
        }
    if isinstance(p, L.Aggregate):
        return {
            "p": "aggregate",
            "input": plan_to_dict(p.input),
            "group_expr": [expr_to_dict(e) for e in p.group_expr],
            "aggr_expr": [expr_to_dict(e) for e in p.aggr_expr],
        }
    if isinstance(p, L.Extension):
        from ..logical.joinagg import CrossJoinAgg

        if isinstance(p.node, CrossJoinAgg):
            n = p.node
            return {
                "p": "cross_join_agg_logical",
                "left": plan_to_dict(n.left),
                "right": plan_to_dict(n.right),
                "condition": (
                    expr_to_dict(n.condition) if n.condition is not None else None
                ),
                "group_expr": [expr_to_dict(e) for e in n.group_expr],
                "aggr_expr": [expr_to_dict(e) for e in n.aggr_expr],
            }
    if isinstance(p, L.Window):
        return {
            "p": "window",
            "input": plan_to_dict(p.input),
            "window_expr": [expr_to_dict(e) for e in p.window_expr],
        }
    if isinstance(p, L.Sort):
        return {
            "p": "sort",
            "exprs": [expr_to_dict(e) for e in p.exprs],
            "input": plan_to_dict(p.input),
        }
    if isinstance(p, L.Join):
        return {
            "p": "join",
            "left": plan_to_dict(p.left),
            "right": plan_to_dict(p.right),
            "on": [[expr_to_dict(l), expr_to_dict(r)] for l, r in p.on],
            "join_type": p.join_type,
            "filter": expr_to_dict(p.filter) if p.filter is not None else None,
        }
    if isinstance(p, L.CrossJoin):
        return {
            "p": "cross_join",
            "left": plan_to_dict(p.left),
            "right": plan_to_dict(p.right),
        }
    if isinstance(p, L.Union):
        return {
            "p": "union",
            "inputs": [plan_to_dict(i) for i in p.inputs_],
            "alias": p.alias,
        }
    if isinstance(p, L.Distinct):
        return {"p": "distinct", "input": plan_to_dict(p.input)}
    if isinstance(p, L.Limit):
        return {"p": "limit", "n": p.n, "input": plan_to_dict(p.input)}
    if isinstance(p, L.Skip):
        return {"p": "skip", "n": p.n, "input": plan_to_dict(p.input)}
    if isinstance(p, L.Repartition):
        return {
            "p": "repartition",
            "input": plan_to_dict(p.input),
            "partitioning": p.partitioning,
            "n": p.n,
            "exprs": [expr_to_dict(e) for e in p.exprs] if p.exprs else [],
        }
    if isinstance(p, L.SubqueryAlias):
        return {"p": "subquery_alias", "input": plan_to_dict(p.input), "alias": p.alias}
    if isinstance(p, L.Explain):
        return {
            "p": "explain",
            "plan": plan_to_dict(p.plan),
            "verbose": p.verbose,
            "analyze": p.analyze,
        }
    raise PlanError(f"cannot serialize logical plan {type(p).__name__}")


def plan_from_dict(d: dict, resolver: Callable | None = None) -> L.LogicalPlan:
    """``resolver(table_name, schema)`` -> TableProvider for scan leaves."""
    k = d["p"]
    if k == "table_scan":
        schema = schema_from_dict(d["schema"])
        if resolver is None:
            raise PlanError("table_scan deserialization needs a table resolver")
        source = resolver(d.get("source_name") or d["table_name"], schema)
        return L.TableScan(
            d["table_name"],
            source,
            d.get("projection"),
            [expr_from_dict(f, resolver) for f in d["filters"]],
            d.get("limit"),
        )
    if k == "empty":
        return L.EmptyRelation(d["produce_one_row"], dfschema_from_dict(d["schema"]))
    if k == "values":
        return L.Values(
            [[expr_from_dict(e, resolver) for e in row] for row in d["values"]],
            dfschema_from_dict(d["schema"]),
        )
    if k == "projection":
        return L.Projection(
            [expr_from_dict(e, resolver) for e in d["exprs"]],
            plan_from_dict(d["input"], resolver),
            d.get("alias"),
        )
    if k == "filter":
        return L.Filter(
            expr_from_dict(d["predicate"], resolver), plan_from_dict(d["input"], resolver)
        )
    if k == "aggregate":
        return L.Aggregate(
            plan_from_dict(d["input"], resolver),
            [expr_from_dict(e, resolver) for e in d["group_expr"]],
            [expr_from_dict(e, resolver) for e in d["aggr_expr"]],
        )
    if k == "cross_join_agg_logical":
        from ..logical.joinagg import CrossJoinAgg

        left = plan_from_dict(d["left"], resolver)
        right = plan_from_dict(d["right"], resolver)
        cond = (
            expr_from_dict(d["condition"], resolver)
            if d["condition"] is not None
            else None
        )
        group = [expr_from_dict(e, resolver) for e in d["group_expr"]]
        aggr = [expr_from_dict(e, resolver) for e in d["aggr_expr"]]
        # the fused node's schema is exactly the Aggregate-over-join schema
        # (Filter does not change it)
        out_schema = L.Aggregate(L.CrossJoin(left, right), group, aggr).schema()
        return L.Extension(CrossJoinAgg(left, right, cond, group, aggr, out_schema))
    if k == "window":
        return L.Window(
            plan_from_dict(d["input"], resolver),
            [expr_from_dict(e, resolver) for e in d["window_expr"]],
        )
    if k == "sort":
        return L.Sort(
            [expr_from_dict(e, resolver) for e in d["exprs"]],
            plan_from_dict(d["input"], resolver),
        )
    if k == "join":
        return L.Join(
            plan_from_dict(d["left"], resolver),
            plan_from_dict(d["right"], resolver),
            [
                (expr_from_dict(l, resolver), expr_from_dict(r, resolver))
                for l, r in d["on"]
            ],
            d["join_type"],
            expr_from_dict(d["filter"], resolver) if d["filter"] is not None else None,
        )
    if k == "cross_join":
        return L.CrossJoin(
            plan_from_dict(d["left"], resolver), plan_from_dict(d["right"], resolver)
        )
    if k == "union":
        return L.Union([plan_from_dict(i, resolver) for i in d["inputs"]], d.get("alias"))
    if k == "distinct":
        return L.Distinct(plan_from_dict(d["input"], resolver))
    if k == "limit":
        return L.Limit(d["n"], plan_from_dict(d["input"], resolver))
    if k == "skip":
        return L.Skip(d["n"], plan_from_dict(d["input"], resolver))
    if k == "repartition":
        return L.Repartition(
            plan_from_dict(d["input"], resolver),
            d["partitioning"],
            d["n"],
            [expr_from_dict(e, resolver) for e in d["exprs"]] or None,
        )
    if k == "subquery_alias":
        return L.SubqueryAlias(plan_from_dict(d["input"], resolver), d["alias"])
    if k == "explain":
        return L.Explain(
            plan_from_dict(d["plan"], resolver), d["verbose"], d["analyze"]
        )
    raise PlanError(f"cannot deserialize logical plan kind '{k}'")


# ---------------------------------------------------------------------------
# physical expressions (ballista.proto PhysicalExprNode equivalent)
# ---------------------------------------------------------------------------


def pexpr_to_dict(e: P.PhysicalExpr) -> Any:
    if isinstance(e, P.PhysCol):
        return {"e": "col", "name": e.name, "index": e.index, "dtype": dtype_to_dict(e.dtype)}
    if isinstance(e, P.PhysLit):
        return {"e": "lit", "value": scalar_to_dict(e.value)}
    if isinstance(e, P.PhysBinary):
        return {
            "e": "bin",
            "left": pexpr_to_dict(e.left),
            "op": e.op,
            "right": pexpr_to_dict(e.right),
            "dtype": dtype_to_dict(e.dtype),
        }
    if isinstance(e, P.PhysNot):
        return {"e": "not", "expr": pexpr_to_dict(e.expr)}
    if isinstance(e, P.PhysNegative):
        return {"e": "neg", "expr": pexpr_to_dict(e.expr), "dtype": dtype_to_dict(e.dtype)}
    if isinstance(e, P.PhysIsNull):
        return {"e": "is_null", "expr": pexpr_to_dict(e.expr), "negated": e.negated}
    if isinstance(e, P.PhysCase):
        return {
            "e": "case",
            "base": pexpr_to_dict(e.base) if e.base is not None else None,
            "when_then": [[pexpr_to_dict(w), pexpr_to_dict(t)] for w, t in e.when_then],
            "else": pexpr_to_dict(e.else_expr) if e.else_expr is not None else None,
            "dtype": dtype_to_dict(e.dtype),
        }
    if isinstance(e, P.PhysCast):
        return {
            "e": "cast",
            "expr": pexpr_to_dict(e.expr),
            "dtype": dtype_to_dict(e.dtype),
            "safe": e.safe,
        }
    if isinstance(e, P.PhysInList):
        return {
            "e": "in_list",
            "expr": pexpr_to_dict(e.expr),
            "values": [scalar_to_dict(v) for v in e.values],
            "negated": e.negated,
        }
    if isinstance(e, P.PhysScalarFunction):
        return {
            "e": "fn",
            "name": e.name,
            "args": [pexpr_to_dict(a) for a in e.args],
            "dtype": dtype_to_dict(e.dtype),
        }
    raise PlanError(f"cannot serialize physical expr {type(e).__name__}")


def pexpr_from_dict(d: dict) -> P.PhysicalExpr:
    k = d["e"]
    if k == "col":
        return P.PhysCol(d["name"], d["index"], dtype_from_dict(d["dtype"]))
    if k == "lit":
        return P.PhysLit(scalar_from_dict(d["value"]))
    if k == "bin":
        return P.PhysBinary(
            pexpr_from_dict(d["left"]),
            d["op"],
            pexpr_from_dict(d["right"]),
            dtype_from_dict(d["dtype"]),
        )
    if k == "not":
        return P.PhysNot(pexpr_from_dict(d["expr"]))
    if k == "neg":
        return P.PhysNegative(pexpr_from_dict(d["expr"]), dtype_from_dict(d["dtype"]))
    if k == "is_null":
        return P.PhysIsNull(pexpr_from_dict(d["expr"]), d["negated"])
    if k == "case":
        return P.PhysCase(
            pexpr_from_dict(d["base"]) if d["base"] is not None else None,
            [(pexpr_from_dict(w), pexpr_from_dict(t)) for w, t in d["when_then"]],
            pexpr_from_dict(d["else"]) if d["else"] is not None else None,
            dtype_from_dict(d["dtype"]),
        )
    if k == "cast":
        return P.PhysCast(pexpr_from_dict(d["expr"]), dtype_from_dict(d["dtype"]), d["safe"])
    if k == "in_list":
        return P.PhysInList(
            pexpr_from_dict(d["expr"]),
            [scalar_from_dict(v) for v in d["values"]],
            d["negated"],
        )
    if k == "fn":
        return P.PhysScalarFunction(
            d["name"], [pexpr_from_dict(a) for a in d["args"]], dtype_from_dict(d["dtype"])
        )
    raise PlanError(f"cannot deserialize physical expr kind '{k}'")


def _sort_expr_to_dict(s: PhysSortExpr) -> dict:
    return {
        "expr": pexpr_to_dict(s.expr),
        "ascending": s.ascending,
        "nulls_first": s.nulls_first,
    }


def _sort_expr_from_dict(d: dict) -> PhysSortExpr:
    return PhysSortExpr(pexpr_from_dict(d["expr"]), d["ascending"], d["nulls_first"])


def _agg_expr_to_dict(a: PhysAggExpr) -> dict:
    return {
        "fun": a.fun,
        "expr": pexpr_to_dict(a.expr) if a.expr is not None else None,
        "name": a.name,
        "distinct": a.distinct,
    }


def _agg_expr_from_dict(d: dict) -> PhysAggExpr:
    return PhysAggExpr(
        d["fun"],
        pexpr_from_dict(d["expr"]) if d["expr"] is not None else None,
        d["name"],
        d["distinct"],
    )


def _window_expr_to_dict(w: PhysWindowExpr) -> dict:
    return {
        "fun": w.fun,
        "args": [pexpr_to_dict(a) for a in w.args],
        "partition_by": [pexpr_to_dict(a) for a in w.partition_by],
        "order_by": [_sort_expr_to_dict(s) for s in w.order_by],
        "name": w.name,
        "dtype": dtype_to_dict(w.dtype),
        "frame": _frame_to_dict(w.frame),
    }


def _window_expr_from_dict(d: dict) -> PhysWindowExpr:
    return PhysWindowExpr(
        d["fun"],
        [pexpr_from_dict(a) for a in d["args"]],
        [pexpr_from_dict(a) for a in d["partition_by"]],
        [_sort_expr_from_dict(s) for s in d["order_by"]],
        d["name"],
        dtype_from_dict(d["dtype"]),
        _frame_from_dict(d["frame"]),
    )


# ---------------------------------------------------------------------------
# physical plans (ballista.proto PhysicalPlanNode, :409-690 equivalent)
# ---------------------------------------------------------------------------


def pplan_to_dict(p: ExecutionPlan) -> dict:
    # fused-stage wrappers (physical/fuse.py) are pure local-execution
    # artifacts: ship the logical operator chain they wrap — the receiving
    # executor re-runs fusion on its own physical plan anyway
    from ..physical.fuse import StageExec, TailStageExec

    if isinstance(p, (StageExec, TailStageExec)):
        return pplan_to_dict(p.inner)
    if isinstance(p, DistScanExec):
        return {
            "p": "dist_scan",
            "table_name": p.table_name,
            "schema": schema_to_dict(p._schema),
            "projection": p.projection,
            "num_partitions": p.num_partitions,
            "partition": p.partition,
        }
    if isinstance(p, MemoryExec):
        name = getattr(p, "table_name", None)
        if not name:
            raise PlanError(
                "MemoryExec without a table name cannot be shipped; register "
                "the table or use DistScanExec"
            )
        return {
            "p": "dist_scan",
            "table_name": name,
            "schema": schema_to_dict(p._schema),
            "projection": p.projection,
            "num_partitions": 1,
            "partition": 0,
        }
    if isinstance(p, ProjectionExec):
        return {
            "p": "projection",
            "exprs": [[pexpr_to_dict(e), n] for e, n in p.exprs],
            "input": pplan_to_dict(p.input),
        }
    if isinstance(p, FilterExec):
        return {
            "p": "filter",
            "predicate": pexpr_to_dict(p.predicate),
            "input": pplan_to_dict(p.input),
        }
    if isinstance(p, HashAggregateExec):
        return {
            "p": "hash_aggregate",
            "mode": p.mode,
            "group": [[pexpr_to_dict(e), n] for e, n in p.group_expr],
            "aggr": [_agg_expr_to_dict(a) for a in p.aggr_expr],
            "input": pplan_to_dict(p.input),
            "distinct_values": p.distinct_values,
        }
    if isinstance(p, HashJoinExec):
        return {
            "p": "hash_join",
            "left": pplan_to_dict(p.left),
            "right": pplan_to_dict(p.right),
            "on": [[pexpr_to_dict(l), pexpr_to_dict(r)] for l, r in p.on],
            "join_type": p.join_type,
            "filter": pexpr_to_dict(p.filter) if p.filter is not None else None,
        }
    if isinstance(p, CrossJoinExec):
        return {
            "p": "cross_join",
            "left": pplan_to_dict(p.left),
            "right": pplan_to_dict(p.right),
        }
    if isinstance(p, CrossJoinAggExec):
        return {
            "p": "cross_join_agg",
            "left": pplan_to_dict(p.left),
            "right": pplan_to_dict(p.right),
            "condition": (
                pexpr_to_dict(p.condition) if p.condition is not None else None
            ),
            "group": [[pexpr_to_dict(e), n] for e, n in p.group_expr],
            "aggr": [_agg_expr_to_dict(a) for a in p.aggr_expr],
        }
    if isinstance(p, SortExec):
        return {
            "p": "sort",
            "exprs": [_sort_expr_to_dict(s) for s in p.sort_exprs],
            "input": pplan_to_dict(p.input),
            "fetch": p.fetch,
        }
    if isinstance(p, GlobalLimitExec):
        return {"p": "limit", "n": p.n, "input": pplan_to_dict(p.input)}
    if isinstance(p, SkipExec):
        return {"p": "skip", "n": p.n, "input": pplan_to_dict(p.input)}
    if isinstance(p, UnionExec):
        return {
            "p": "union",
            "inputs": [pplan_to_dict(i) for i in p.inputs],
            "schema": schema_to_dict(p._schema if hasattr(p, "_schema") else p.schema()),
        }
    if isinstance(p, WindowAggExec):
        return {
            "p": "window",
            "window_exprs": [_window_expr_to_dict(w) for w in p.window_exprs],
            "input": pplan_to_dict(p.input),
        }
    if isinstance(p, EmptyExec):
        return {
            "p": "empty",
            "schema": schema_to_dict(p.schema()),
            "produce_one_row": p.produce_one_row,
        }
    if isinstance(p, ShuffleWriterExec):
        return {
            "p": "shuffle_writer",
            "job_id": p.job_id,
            "stage_id": p.stage_id,
            "plan": pplan_to_dict(p.plan),
            "partition_exprs": (
                [pexpr_to_dict(e) for e in p.partition_exprs]
                if p.partition_exprs is not None
                else None
            ),
            "num_output_partitions": p.num_output_partitions,
            "input_partition": p.input_partition,
        }
    if isinstance(p, UnresolvedShuffleExec):
        return {
            "p": "unresolved_shuffle",
            "stage_id": p.stage_id,
            "schema": schema_to_dict(p._schema),
            "num_partitions": p.num_partitions,
        }
    if isinstance(p, ShuffleReaderExec):
        return {
            "p": "shuffle_reader",
            "paths": p.paths,
            "schema": schema_to_dict(p._schema),
        }
    raise PlanError(f"cannot serialize physical plan {type(p).__name__}")


def pplan_from_dict(d: dict, store=None, work_dir: str = "", device=None) -> ExecutionPlan:
    """``device``: where the plan's empty relations and shuffle readers
    put their tables (None: the card, resolved only when one runs)."""
    k = d["p"]
    if k == "dist_scan":
        return DistScanExec(
            d["table_name"],
            schema_from_dict(d["schema"]),
            d.get("projection"),
            d["num_partitions"],
            d.get("partition"),
            store,
        )
    if k == "projection":
        return ProjectionExec(
            [(pexpr_from_dict(e), n) for e, n in d["exprs"]],
            pplan_from_dict(d["input"], store, work_dir, device),
        )
    if k == "filter":
        return FilterExec(
            pexpr_from_dict(d["predicate"]), pplan_from_dict(d["input"], store, work_dir, device)
        )
    if k == "hash_aggregate":
        return HashAggregateExec(
            d["mode"],
            [(pexpr_from_dict(e), n) for e, n in d["group"]],
            [_agg_expr_from_dict(a) for a in d["aggr"]],
            pplan_from_dict(d["input"], store, work_dir, device),
            d.get("distinct_values", 0),
        )
    if k == "hash_join":
        return HashJoinExec(
            pplan_from_dict(d["left"], store, work_dir, device),
            pplan_from_dict(d["right"], store, work_dir, device),
            [(pexpr_from_dict(l), pexpr_from_dict(r)) for l, r in d["on"]],
            d["join_type"],
            pexpr_from_dict(d["filter"]) if d["filter"] is not None else None,
        )
    if k == "cross_join":
        return CrossJoinExec(
            pplan_from_dict(d["left"], store, work_dir, device),
            pplan_from_dict(d["right"], store, work_dir, device),
        )
    if k == "cross_join_agg":
        return CrossJoinAggExec(
            pplan_from_dict(d["left"], store, work_dir, device),
            pplan_from_dict(d["right"], store, work_dir, device),
            pexpr_from_dict(d["condition"]) if d["condition"] is not None else None,
            [(pexpr_from_dict(e), n) for e, n in d["group"]],
            [_agg_expr_from_dict(a) for a in d["aggr"]],
        )
    if k == "sort":
        return SortExec(
            [_sort_expr_from_dict(s) for s in d["exprs"]],
            pplan_from_dict(d["input"], store, work_dir, device),
            d.get("fetch"),
        )
    if k == "limit":
        return GlobalLimitExec(d["n"], pplan_from_dict(d["input"], store, work_dir, device))
    if k == "skip":
        return SkipExec(d["n"], pplan_from_dict(d["input"], store, work_dir, device))
    if k == "union":
        return UnionExec(
            [pplan_from_dict(i, store, work_dir, device) for i in d["inputs"]],
            schema_from_dict(d["schema"]),
        )
    if k == "window":
        return WindowAggExec(
            [_window_expr_from_dict(w) for w in d["window_exprs"]],
            pplan_from_dict(d["input"], store, work_dir, device),
        )
    if k == "empty":
        return EmptyExec(schema_from_dict(d["schema"]), d["produce_one_row"], device)
    if k == "shuffle_writer":
        return ShuffleWriterExec(
            d["job_id"],
            d["stage_id"],
            pplan_from_dict(d["plan"], store, work_dir, device),
            (
                [pexpr_from_dict(e) for e in d["partition_exprs"]]
                if d["partition_exprs"] is not None
                else None
            ),
            d["num_output_partitions"],
            work_dir,
            d["input_partition"],
        )
    if k == "unresolved_shuffle":
        return UnresolvedShuffleExec(
            d["stage_id"], schema_from_dict(d["schema"]), d["num_partitions"]
        )
    if k == "shuffle_reader":
        return ShuffleReaderExec(d["paths"], schema_from_dict(d["schema"]), device)
    raise PlanError(f"cannot deserialize physical plan kind '{k}'")
