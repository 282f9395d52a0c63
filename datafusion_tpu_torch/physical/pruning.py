"""PruningPredicate: prune containers (parquet row groups) by min/max stats.

Copy of ``datafusion_tpu/physical/pruning.py`` (reference:
datafusion/src/physical_optimizer/pruning.rs:90): compile a filter expression into a predicate over per-container
statistics arrays.  A container survives unless the statistics PROVE no row
in it can match — unknown statistics keep the container (conservative).

The evaluator runs on the host over numpy min/max/null_count arrays (one
element per row group); the surviving groups are the only ones read and
shipped to the device, so pruning happens before any transfer.
"""

from __future__ import annotations

import numpy as np

from ..logical.expr import (
    Alias,
    Between,
    BinaryExpr,
    Cast,
    Column,
    Expr,
    InList,
    IsNotNull,
    IsNull,
    Literal,
    Not,
)


class ContainerStats:
    """Per-column min/max/null_count arrays over N containers."""

    def __init__(self, n: int):
        self.n = n
        self.min: dict[str, np.ndarray] = {}
        self.max: dict[str, np.ndarray] = {}
        self.null_count: dict[str, np.ndarray] = {}
        self.known: dict[str, np.ndarray] = {}  # stats present per container
        self.num_rows: np.ndarray | None = None  # rows per container

    def set_column(self, name: str, mins, maxs, null_counts, known):
        self.min[name] = np.asarray(mins, dtype=object)
        self.max[name] = np.asarray(maxs, dtype=object)
        self.null_count[name] = np.asarray(null_counts)
        self.known[name] = np.asarray(known, dtype=bool)


class PruningPredicate:
    """keep = evaluate(filters, stats): boolean array over containers."""

    def __init__(self, filters: list[Expr]):
        self.filters = filters

    def prune(self, stats: ContainerStats) -> np.ndarray:
        keep = np.ones(stats.n, dtype=bool)
        for f in self.filters:
            k = _may_match(f, stats)
            keep &= k
        return keep


# Tri-state arrays: True = may match, False = provably no match.
# Unknown always widens to True.


def _all_true(n: int) -> np.ndarray:
    return np.ones(n, dtype=bool)


def _cmp(op, a, b) -> bool:
    try:
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
        if op == "=":
            return a == b
    except TypeError:
        return True
    return True


def _lit_value(e: Expr):
    if isinstance(e, Literal):
        return e.value.value
    if isinstance(e, Cast) and isinstance(e.expr, Literal):
        # common planner shape: CAST('1995-01-01' AS DATE)
        import torch

        from ..exprs.physical import cast_column, _const_column

        try:
            c = _const_column(1, e.expr.value, torch.device("cpu"))
            out = cast_column(c, e.dtype)
            v = out.data[:1].numpy()[0]
            return v.item() if hasattr(v, "item") else v
        except Exception:
            return None
    return None


def _col_name(e: Expr) -> str | None:
    if isinstance(e, Alias):
        return _col_name(e.expr)
    if isinstance(e, Column):
        return e.name
    return None


def _may_match(e: Expr, stats: ContainerStats) -> np.ndarray:
    n = stats.n
    if isinstance(e, BinaryExpr):
        if e.op == "and":
            return _may_match(e.left, stats) & _may_match(e.right, stats)
        if e.op == "or":
            return _may_match(e.left, stats) | _may_match(e.right, stats)
        # normalize: col OP lit
        col, lit, op = _col_name(e.left), _lit_value(e.right), e.op
        if col is None or lit is None:
            col2, lit2 = _col_name(e.right), _lit_value(e.left)
            if col2 is not None and lit2 is not None:
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
                if e.op in flip:
                    col, lit, op = col2, lit2, flip[e.op]
        if col is None or lit is None or col not in stats.min:
            return _all_true(n)
        mn, mx, known = stats.min[col], stats.max[col], stats.known[col]
        out = _all_true(n)
        for i in range(n):
            if not known[i]:
                continue
            lo, hi = mn[i], mx[i]
            if lo is None or hi is None:
                continue
            if op == "=":
                out[i] = _cmp("<=", lo, lit) and _cmp("<=", lit, hi)
            elif op in ("<", "<="):
                out[i] = _cmp(op, lo, lit)
            elif op in (">", ">="):
                out[i] = _cmp(op, hi, lit)
            elif op in ("!=", "<>"):
                # prunable only for single-valued containers (min==max==lit,
                # pruning.rs NotEq rewrite)
                if lo == hi and not _cmp("<", lo, lit) and not _cmp("<", lit, lo):
                    out[i] = False
            elif op == "like" and isinstance(lit, str):
                pre = _like_prefix(lit)
                if pre and isinstance(lo, str) and isinstance(hi, str):
                    # rows matching 'pre%' live in [pre, next(pre));
                    # container range [lo, hi] must overlap it
                    out[i] = hi >= pre and (
                        _next_prefix(pre) is None or lo < _next_prefix(pre)
                    )
        return out
    if isinstance(e, Between) and not e.negated:
        lo_ = BinaryExpr(e.expr, ">=", e.low)
        hi_ = BinaryExpr(e.expr, "<=", e.high)
        return _may_match(lo_, stats) & _may_match(hi_, stats)
    if isinstance(e, InList) and not e.negated:
        out = np.zeros(n, dtype=bool)
        for item in e.list_:
            out |= _may_match(BinaryExpr(e.expr, "=", item), stats)
            if out.all():
                break
        return out
    if isinstance(e, IsNull):
        col = _col_name(e.expr)
        if col is None or col not in stats.null_count:
            return _all_true(n)
        known = stats.known[col]
        nc = stats.null_count[col]
        out = _all_true(n)
        for i in range(n):
            if known[i] and nc[i] is not None:
                out[i] = nc[i] > 0
        return out
    if isinstance(e, IsNotNull):
        col = _col_name(e.expr)
        if col is None or col not in stats.null_count or stats.num_rows is None:
            return _all_true(n)
        nc = stats.null_count[col]
        out = _all_true(n)
        for i in range(n):
            if (
                stats.known[col][i]
                and nc[i] is not None
                and stats.num_rows[i] is not None
                and nc[i] >= stats.num_rows[i]
            ):
                out[i] = False  # all-null container: IS NOT NULL matches none
        return out
    if isinstance(e, Not):
        # push the negation into shapes we can evaluate (pruning.rs
        # rewrites via negated operators); anything else keeps the container
        inner = e.expr
        if isinstance(inner, IsNull):
            return _may_match(IsNotNull(inner.expr), stats)
        if isinstance(inner, IsNotNull):
            return _may_match(IsNull(inner.expr), stats)
        if isinstance(inner, BinaryExpr) and inner.op in _NEG_OP:
            return _may_match(
                BinaryExpr(inner.left, _NEG_OP[inner.op], inner.right), stats
            )
        if isinstance(inner, Between):
            return _may_match(
                Between(inner.expr, not inner.negated, inner.low, inner.high),
                stats,
            )
        return _all_true(n)
    if isinstance(e, Between) and e.negated:
        lo_ = BinaryExpr(e.expr, "<", e.low)
        hi_ = BinaryExpr(e.expr, ">", e.high)
        return _may_match(lo_, stats) | _may_match(hi_, stats)
    if isinstance(e, InList) and e.negated:
        # prunable only when the container is single-valued and that value
        # is in the list
        col = _col_name(e.expr)
        items = [_lit_value(x) for x in e.list_]
        if col is None or col not in stats.min or any(v is None for v in items):
            return _all_true(n)
        mn, mx, known = stats.min[col], stats.max[col], stats.known[col]
        out = _all_true(n)
        for i in range(n):
            if known[i] and mn[i] is not None and mn[i] == mx[i] and mn[i] in items:
                out[i] = False
        return out
    return _all_true(n)


_NEG_OP = {"=": "!=", "!=": "=", "<>": "=", "<": ">=", "<=": ">", ">": "<=", ">=": "<"}


def _like_prefix(pattern: str) -> str | None:
    """Literal prefix of a LIKE pattern up to the first wildcard; None when
    the pattern starts with a wildcard (no prunable prefix)."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch in "%_":
            break
        if ch == "\\" and i + 1 < len(pattern):
            i += 1
            ch = pattern[i]
        out.append(ch)
        i += 1
    return "".join(out) or None


def _next_prefix(pre: str) -> str | None:
    """Smallest string greater than every string with prefix `pre`."""
    b = list(pre)
    while b:
        c = b[-1]
        if ord(c) < 0x10FFFF:
            return "".join(b[:-1]) + chr(ord(c) + 1)
        b.pop()
    return None
