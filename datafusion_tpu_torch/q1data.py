"""Fast lineitem-only generators (pure numpy): TPC-H Q1's seven columns,
and the lineitem of lineitem-only TPC-H work, which adds the order key,
supplier key and line number.

Q1's draws are the same, in the same order, as ``bench/q1data.py`` of the
JAX package, so a seed gives the same rows in both engines; the three
further columns are drawn after them from the same generator, shaped as
dbgen shapes them (orders of 1-7 lines, sparse order keys, rows in
order-key order).  Both build the torch engine's Tables on the given
device.
"""

from __future__ import annotations

import numpy as np

from .columnar.column import Column
from .columnar.dictionary import StringDict
from .columnar.table import Table, round_capacity
from .device import resolve_device
from .types.dtypes import DATE32, INT32, INT64, STRING, decimal

_EPOCH = np.datetime64("1970-01-01", "D")

LINEITEM_ROWS_SF1 = 6_001_215


def lineitem_q1_arrays(sf: float = 1.0, seed: int = 7) -> dict[str, np.ndarray]:
    """The seven Q1 columns as storage arrays: scaled-by-100 decimals,
    date32 days, and codes into the sorted dictionaries ("A","N","R") and
    ("F","O")."""
    return _q1_draws(np.random.default_rng(seed), int(LINEITEM_ROWS_SF1 * sf))


def lineitem_arrays(sf: float = 1.0, seed: int = 7) -> dict[str, np.ndarray]:
    """Q1's seven columns (the same values as ``lineitem_q1_arrays``) plus
    ``l_orderkey``, ``l_suppkey`` and ``l_linenumber``, shaped as dbgen
    shapes them: orders of 1-7 lines (uniform), order keys sparse (8 of
    every 32), rows in order-key order, line numbers 1..n within each
    order, supplier keys uniform over 1..10,000 * sf.  The last order is
    cut where the rows reach 6,001,215 * sf."""
    rng = np.random.default_rng(seed)
    n = int(LINEITEM_ROWS_SF1 * sf)
    out = _q1_draws(rng, n)
    per_order = rng.integers(1, 8, n // 4 + 8 * int(np.sqrt(n)) + 8)
    while per_order.sum() < n:  # never at these sizes; keeps n rows certain
        per_order = np.concatenate([per_order, rng.integers(1, 8, 1024)])
    order = np.repeat(np.arange(len(per_order)), per_order)[:n]
    first_row = np.repeat(np.cumsum(per_order) - per_order, per_order)[:n]
    out["l_orderkey"] = (order // 8) * 32 + order % 8 + 1
    out["l_suppkey"] = rng.integers(1, max(int(10_000 * sf), 1) + 1, n).astype(np.int64)
    out["l_linenumber"] = (np.arange(n) - first_row + 1).astype(np.int32)
    return out


def _q1_draws(rng, n: int) -> dict[str, np.ndarray]:
    qty = rng.integers(1, 51, n).astype(np.int64) * 100  # scaled(2)
    price = rng.integers(90_000, 10_500_000, n).astype(np.int64)  # scaled(2)
    disc = rng.integers(0, 11, n).astype(np.int64)  # scaled(2): 0.00-0.10
    tax = rng.integers(0, 9, n).astype(np.int64)
    ship_lo = (np.datetime64("1992-01-02", "D") - _EPOCH).astype(int)
    ship_hi = (np.datetime64("1998-12-01", "D") - _EPOCH).astype(int)
    shipdate = rng.integers(ship_lo, ship_hi, n).astype(np.int32)
    rf = rng.integers(0, 3, n).astype(np.int32)  # codes into sorted dict
    ls = rng.integers(0, 2, n).astype(np.int32)
    return {
        "l_quantity": qty,
        "l_extendedprice": price,
        "l_discount": disc,
        "l_tax": tax,
        "l_returnflag": rf,
        "l_linestatus": ls,
        "l_shipdate": shipdate,
    }


RETURNFLAGS = ("A", "N", "R")
LINESTATUSES = ("F", "O")


def generate_lineitem_q1(sf: float = 1.0, seed: int = 7, device=None) -> Table:
    """The Q1 lineitem table at scale factor ``sf`` on ``device`` (None:
    the CUDA card)."""
    return _lineitem_table(lineitem_q1_arrays(sf, seed), device)


def generate_lineitem(sf: float = 1.0, seed: int = 7, device=None) -> Table:
    """The ten-column lineitem of ``lineitem_arrays`` on ``device`` (None:
    the CUDA card)."""
    return _lineitem_table(lineitem_arrays(sf, seed), device)


def _lineitem_table(a: dict, device) -> Table:
    dev = resolve_device(device)
    n = len(a["l_quantity"])
    dec2 = decimal(15, 2)
    cap = round_capacity(n)
    rf_dict = StringDict(np.array(RETURNFLAGS, dtype=object))
    ls_dict = StringDict(np.array(LINESTATUSES, dtype=object))

    def col(dtype, name, dictionary=None):
        return Column.from_numpy(dtype, a[name], dictionary=dictionary, capacity=cap, device=dev)

    cols = {
        "l_quantity": col(dec2, "l_quantity"),
        "l_extendedprice": col(dec2, "l_extendedprice"),
        "l_discount": col(dec2, "l_discount"),
        "l_tax": col(dec2, "l_tax"),
        "l_returnflag": col(STRING, "l_returnflag", rf_dict),
        "l_linestatus": col(STRING, "l_linestatus", ls_dict),
        "l_shipdate": col(DATE32, "l_shipdate"),
    }
    for name, dtype in (("l_orderkey", INT64), ("l_suppkey", INT64), ("l_linenumber", INT32)):
        if name in a:
            cols[name] = col(dtype, name)
    return Table(list(cols), list(cols.values()), n, device=dev)
