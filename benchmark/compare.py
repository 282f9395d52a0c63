"""The comparison that decides ``correct``: a query's rows as the port
decoded them (``Table.to_pydict``) against the plain reference's result.

The form is that of the port's expected-rows check
(``datafusion_tpu_torch/queries/expected.py``), copied here: each value
goes to a canonical form by its column's kind (a decimal to its scaled
integer, ``round(v * 10**scale)`` of the decoded float, and a date to its
ordinal), rows sort by their exact columns and then by their floats, and
exact columns must be equal.  A decimal past 2^53 is decoded from the
reference's integer exactly as the port decodes its own, so it is held at
float resolution.  A float column gives the widest relative gap,
``|got - want| / max(|want|, 1)``, which the caller holds to its limit.

An ordered query's rows must be in its ORDER BY order; rows that tie on
every ORDER BY column may come in any order.  Under a LIMIT of k the rows
must be k rows of the reference's result whose ORDER BY values are the
first k of the reference's, so a tie at the cut may be broken either way.

The standard library only: the comparison imports nothing of the port.
"""

from __future__ import annotations

import datetime
import math
from dataclasses import dataclass

# a decoded decimal must lie this close to a scaled integer (relative),
# or it was computed in floats
DECIMAL_REL = 1e-12


@dataclass
class Verdict:
    """``ok``: the exact parts agree (names, row count, exact columns,
    order); ``reason`` says where they do not; ``float_err`` is the
    widest relative gap of a float value (0.0 where there is none)."""

    ok: bool
    reason: str
    float_err: float


def _canonical(name: str, kind: str, values: list) -> tuple[list, str]:
    """The canonical values of one column, and what is wrong with them
    ('' when every value is of the column's kind)."""
    if kind == "str":
        bad = next((v for v in values if not isinstance(v, str)), None)
        return values, f"{name} holds {bad!r}" if bad is not None else ""
    if kind == "int":
        bad = next((v for v in values if type(v) is not int), None)
        return values, f"{name} holds {bad!r}" if bad is not None else ""
    if kind == "float":
        bad = next((v for v in values if type(v) is not float), None)
        return values, f"{name} holds {bad!r}" if bad is not None else ""
    if kind == "date":
        if any(type(v) is not datetime.date for v in values):
            return [0] * len(values), f"{name} holds a value that is not a date"
        return [v.toordinal() for v in values], ""
    if not kind.startswith("decimal:"):
        raise ValueError(f"unknown column kind {kind!r}")
    scale = 10 ** int(kind[8:])
    out, why = [], ""
    for v in values:
        if type(v) is int:
            out.append(v * scale)
            continue
        if type(v) is not float or not math.isfinite(v):
            out.append(0)
            why = why or f"{name} holds {v!r}"
            continue
        x = v * scale
        n = round(x)
        if abs(x - n) > DECIMAL_REL * max(abs(x), 1.0):
            why = why or f"{name} holds {v!r}, not a decimal of scale {kind[8:]}"
        out.append(n)
    return out, why


def _rows(cols: dict, columns: list) -> tuple[list, str]:
    canon, why = [], ""
    for name, kind in columns:
        c, w = _canonical(name, kind, cols[name])
        canon.append(c)
        why = why or w
    return list(zip(*canon)), why


def _order_key(spec: list):
    return lambda r: tuple(r[c] for c, _ in spec)


def _sort_by_spec(rows: list, spec: list) -> list:
    out = list(rows)
    for col, desc in reversed(spec):
        out.sort(key=lambda r: r[col], reverse=desc)
    return out


def _out_of_order(rows: list, spec: list) -> str:
    for i in range(1, len(rows)):
        for col, desc in spec:
            a, b = rows[i - 1][col], rows[i][col]
            if a == b:
                continue
            if (a < b) == desc:
                return f"rows {i - 1} and {i} out of order on column {col}"
            break
    return ""


def _float_err(g: float, w: float) -> float:
    if g == w:
        return 0.0
    if math.isnan(g) or math.isnan(w):
        return math.inf
    return abs(g - w) / max(abs(w), 1.0)


def compare(got: dict, want) -> Verdict:
    """``got``: {name: decoded values} in the port's column order; ``want``:
    a ``reference.Result``."""
    columns = [tuple(c) for c in want.columns]
    names = [n for n, _ in columns]
    if list(got) != names:
        return Verdict(False, f"columns {list(got)}, want {names}", 0.0)
    exact = [j for j, (_, k) in enumerate(columns) if k != "float"]
    floats = [j for j, (_, k) in enumerate(columns) if k == "float"]
    g_rows, why = _rows(got, columns)
    w_rows, w_why = _rows(want.decoded(), columns)
    if w_why and want.exact:
        raise AssertionError(f"the reference's own rows are malformed: {w_why}")
    spec = [tuple(s) for s in want.order_by]
    limit = want.limit
    n_want = len(w_rows) if limit is None else min(limit, len(w_rows))
    if len(g_rows) != n_want:
        return Verdict(False, f"{len(g_rows)} rows, want {n_want}", 0.0)
    # every fault is noted, and the float gap is measured all the same
    faults = [f for f in (why, _out_of_order(g_rows, spec) if spec else "") if f]
    err = 0.0
    if limit is None:
        key = lambda r: tuple(r[j] for j in exact + floats)  # noqa: E731
        bad = None
        for i, (g, w) in enumerate(zip(sorted(g_rows, key=key), sorted(w_rows, key=key))):
            if bad is None and any(g[j] != w[j] for j in exact):
                bad = f"row {i} of {n_want} (canonical order): {g} != {w}"
            for j in floats:
                err = max(err, _float_err(g[j], w[j]))
        faults += [bad] if bad else []
        return Verdict(not faults, faults[0] if faults else "", err)
    cut = sorted(map(_order_key(spec), _sort_by_spec(w_rows, spec)[:n_want]))
    if sorted(map(_order_key(spec), g_rows)) != cut:
        faults.append(f"the ORDER BY values of the {n_want} rows are not the first {n_want} of the "
                      f"reference's")
    by_exact = {tuple(w[j] for j in exact): w for w in w_rows}
    missing = [i for i, g in enumerate(g_rows) if tuple(g[j] for j in exact) not in by_exact]
    if missing:
        faults.append(f"row {missing[0]} is not a row of the reference's result: {g_rows[missing[0]]}")
    for g in g_rows:
        w = by_exact.get(tuple(g[j] for j in exact))
        for j in floats if w is not None else ():
            err = max(err, _float_err(g[j], w[j]))
    return Verdict(not faults, faults[0] if faults else "", err)
