"""The plain reference: each query of the mixes in plain PyTorch over the
generated tables (``benchmark.tpchgen``), one module per query.

A query module gives ``COLUMNS`` ([(name, kind)], kind ``int``, ``str``,
``date``, ``float`` or ``decimal:<scale>``), ``ORDER_BY`` ([(column,
descending)]), ``LIMIT`` (None or the row limit) and ``run(inputs)``,
which returns the result's columns in ``COLUMNS`` order.  The result is
the whole of it, in no particular order; the comparison applies the
ORDER BY and the LIMIT.

Joins find rows by binary search over the sorted key column, groups come
from ``torch.unique``, and money is exact: decimal(15,2) values are int64
cents, products carry the sum of their scales, sums are int64.  With
``money="float32"`` the same code computes every money value and every
mean in float32 instead: that is the control, which must fail the
comparison.  Imports nothing of the port.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np
import torch

from ..tpchgen import TpchData, days

MONEY = ("exact", "float32")


@dataclass
class Dec:
    """A column of decimal values at ``scale``: int64 scaled integers when
    exact, else float32 values."""

    v: torch.Tensor
    scale: int
    exact: bool

    def _one(self) -> "Dec":
        return Dec(torch.tensor(10 ** self.scale if self.exact else 1.0, dtype=self.v.dtype,
                                device=self.v.device), self.scale, self.exact)

    def one_minus(self) -> "Dec":
        return Dec(self._one().v - self.v, self.scale, self.exact)

    def one_plus(self) -> "Dec":
        return Dec(self._one().v + self.v, self.scale, self.exact)

    def __mul__(self, o: "Dec") -> "Dec":
        return Dec(self.v * o.v, self.scale + o.scale, self.exact)

    def __sub__(self, o: "Dec") -> "Dec":
        s = max(self.scale, o.scale)
        if not self.exact:
            return Dec(self.v - o.v, s, False)
        return Dec(self.v * 10 ** (s - self.scale) - o.v * 10 ** (s - o.scale), s, True)

    def __getitem__(self, idx) -> "Dec":
        return Dec(self.v[idx], self.scale, self.exact)

    def sum(self, inv: torch.Tensor, groups: int) -> "Dec":
        """Sums by group (``inv``: each row's group)."""
        out = torch.zeros(groups, dtype=self.v.dtype, device=self.v.device)
        return Dec(out.index_add_(0, inv, self.v), self.scale, self.exact)

    def total(self) -> "Dec":
        """The sum of the whole column, as a column of one value."""
        return Dec(self.v.sum().reshape(1), self.scale, self.exact)

    def mean(self, inv: torch.Tensor, groups: int, counts: torch.Tensor) -> torch.Tensor:
        """Means by group, as floats (float32 in the control)."""
        s = self.sum(inv, groups)
        if self.exact:
            return s.v.to(torch.float64) / 10 ** self.scale / counts.to(torch.float64)
        return s.v / counts.to(torch.float32)


class Inputs:
    """The generated tables on ``device`` for the reference: columns are
    copied there when first read and kept until ``close``."""

    def __init__(self, data: TpchData, device, money: str = "exact"):
        if money not in MONEY:
            raise ValueError(f"money must be one of {MONEY}, not {money!r}")
        self.data = data
        self.device = torch.device(device)
        self.exact = money == "exact"
        self._cols: dict[str, torch.Tensor] = {}
        self._sorted: dict[str, tuple] = {}
        self._table_of = {c: t for t, cols in data.tables.items() for c in cols}

    def close(self) -> None:
        self._cols.clear()
        self._sorted.clear()

    def col(self, name: str) -> torch.Tensor:
        if name not in self._cols:
            host = self.data.tables[self._table_of[name]][name]
            self._cols[name] = torch.from_numpy(host).to(self.device)
        return self._cols[name]

    def dec(self, name: str) -> Dec:
        """A decimal(15,2) column: cents, or float32 values in the control."""
        c = self.col(name)
        if self.exact:
            return Dec(c, 2, True)
        return Dec((c.to(torch.float64) / 100).to(torch.float32), 2, False)

    def lit(self, x: float, scale: int):
        """The constant ``x`` as a value of a decimal column at ``scale``."""
        return round(x * 10 ** scale) if self.exact else torch.tensor(x, dtype=torch.float32).item()

    def code(self, name: str, s: str) -> int:
        """The code of ``s`` in a string column (-1 where absent)."""
        v = self.data.vocab[name]
        i = int(np.searchsorted(v.astype(str), s))
        return i if i < len(v) and v[i] == s else -1

    def isin(self, name: str, codes: torch.Tensor, strings) -> torch.Tensor:
        want = torch.tensor([self.code(name, s) for s in strings], dtype=codes.dtype, device=self.device)
        return torch.isin(codes, want)

    def where(self, name: str, pred) -> torch.Tensor:
        """A bool table over the codes of a string column: ``pred(value)``."""
        lut = np.array([bool(pred(s)) for s in self.data.vocab[name]], dtype=bool)
        return torch.from_numpy(lut).to(self.device)

    def strings(self, name: str, codes: torch.Tensor) -> np.ndarray:
        return self.data.vocab[name][codes.cpu().numpy()]

    def lookup(self, key: str, probe: torch.Tensor, keys: torch.Tensor | None = None):
        """(row, hit): the row of the unique key column ``key`` (or of the
        given ``keys``, cached under that name) equal to each probe value,
        and whether there is one."""
        if key not in self._sorted:
            k = self.col(key) if keys is None else keys
            order = torch.argsort(k, stable=True)
            self._sorted[key] = (k[order], order)
        sk, order = self._sorted[key]
        pos = torch.searchsorted(sk, probe).clamp_(max=max(len(sk) - 1, 0))
        return order[pos], sk[pos] == probe

    def year(self, d: torch.Tensor) -> torch.Tensor:
        """The calendar year of each date (days since 1970-01-01)."""
        starts = torch.tensor([days(f"{y}-01-01") for y in range(1900, 2201)],
                              dtype=torch.int64, device=self.device)
        return torch.searchsorted(starts, d.to(torch.int64), right=True) - 1 + 1900

    def group(self, *keys: torch.Tensor):
        """(inverse, distinct keys): each row's group and each group's key
        columns, over non-negative integer keys."""
        if len(keys[0]) == 0:
            return torch.zeros(0, dtype=torch.int64, device=self.device), [k[:0] for k in keys]
        ranges = [int(k.max()) + 1 for k in keys]
        if float(np.prod([float(r) for r in ranges])) >= 2.0 ** 62:
            raise ValueError(f"group keys span {ranges}: too wide to combine")
        combined = torch.zeros_like(keys[0], dtype=torch.int64)
        for k, r in zip(keys, ranges):
            combined = combined * r + k.to(torch.int64)
        uniq, inv = torch.unique(combined, return_inverse=True)
        parts = []
        for r in reversed(ranges):
            parts.append(uniq % r)
            uniq = uniq // r
        return inv, parts[::-1]

    def counts(self, inv: torch.Tensor, groups: int) -> torch.Tensor:
        return torch.zeros(groups, dtype=torch.int64, device=self.device).index_add_(
            0, inv, torch.ones_like(inv))


@dataclass
class Result:
    """A query's whole result from the reference (or from the control),
    with its ORDER BY and LIMIT."""

    columns: list
    values: list
    order_by: list
    limit: int | None
    exact: bool

    def decoded(self) -> dict:
        """The rows as the port's ``Table.to_pydict`` decodes its own:
        strings, ints, ``datetime.date``, floats, and decimals as
        ``int(v) / 10**scale`` (the control's floats as they are)."""
        import datetime

        epoch = datetime.date(1970, 1, 1).toordinal()
        out = {}
        for (name, kind), v in zip(self.columns, self.values):
            if kind == "str":
                out[name] = list(v)
            elif kind == "int":
                out[name] = [int(x) for x in v]
            elif kind == "date":
                out[name] = [datetime.date.fromordinal(epoch + int(x)) for x in v]
            elif kind == "float":
                out[name] = [float(x) for x in v]
            elif self.exact:
                scale = 10 ** int(kind.split(":")[1])
                out[name] = [int(x) / scale for x in v]
            else:
                out[name] = [float(x) for x in v]
        return out


    def answer(self) -> dict:
        """The rows as the program answers them: in ORDER BY order, cut to
        the LIMIT, decoded (the control's rows in the program's place)."""
        order = list(range(len(self.values[0]) if self.values else 0))
        for col, desc in reversed(self.order_by):
            v = self.values[col]
            order.sort(key=v.__getitem__, reverse=desc)
        idx = np.array(order[: self.limit] if self.limit is not None else order, dtype=np.int64)
        return Result(self.columns, [v[idx] for v in self.values], self.order_by, None,
                      self.exact).decoded()


def _host(v) -> np.ndarray:
    if isinstance(v, Dec):
        v = v.v
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.asarray(v)


def module(query: str):
    """The reference module of ``query`` (``reference/<query>.py``)."""
    return importlib.import_module(f"{__name__}.{query}")


def run(query: str, inputs: Inputs) -> Result:
    m = module(query)
    values = [_host(v) for v in m.run(inputs)]
    if len(values) != len(m.COLUMNS) or len({len(v) for v in values}) > 1:
        raise AssertionError(f"{query}: the reference gave {len(values)} ragged columns")
    return Result(list(m.COLUMNS), values, list(m.ORDER_BY), m.LIMIT, inputs.exact)
