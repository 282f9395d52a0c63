"""Load the generated tables into an ``ExecutionContext`` of the port.

The columns go in through the port's own constructors from prepared
columns (``Column.from_numpy`` with a ``StringDict`` over the generator's
sorted vocabulary; ``HostTable`` for host-resident tables, pinned by the
port), as Arrow and file sources do: the benchmark times the queries over
in-memory tables, as DataFusion's ``--mem-table`` mode does, and not the
port's encoding of Python strings.
"""

from __future__ import annotations

from datafusion_tpu_torch import ExecutionContext
from datafusion_tpu_torch.columnar.column import Column
from datafusion_tpu_torch.columnar.dictionary import StringDict
from datafusion_tpu_torch.columnar.table import Table, round_capacity
from datafusion_tpu_torch.datasource.host import HostTable
from datafusion_tpu_torch.types.dtypes import DATE32, INT64, STRING, decimal

from .tpchgen import SCHEMA, TpchData

_DTYPES = {"int64": INT64, "decimal": decimal(15, 2), "date": DATE32, "string": STRING}


def _columns(data: TpchData, table: str):
    """(names, dtypes, host arrays, dictionaries) of one table."""
    names, dtypes, arrays, dicts = [], [], [], []
    for c, kind in SCHEMA[table]:
        names.append(c)
        dtypes.append(_DTYPES[kind])
        arrays.append(data.tables[table][c])
        dicts.append(StringDict(data.vocab[c]) if kind == "string" else None)
    return names, dtypes, arrays, dicts


def device_table(data: TpchData, table: str, device) -> Table:
    names, dtypes, arrays, dicts = _columns(data, table)
    n = data.nrows(table)
    cap = round_capacity(n)
    cols = [Column.from_numpy(dt, a, dictionary=dic, capacity=cap, device=device)
            for dt, a, dic in zip(dtypes, arrays, dicts)]
    return Table(names, cols, n, device=device)


def host_table(data: TpchData, table: str, morsel_rows: int, device) -> HostTable:
    names, dtypes, arrays, dicts = _columns(data, table)
    return HostTable(names, dtypes, arrays, [None] * len(names), dicts, data.nrows(table),
                     morsel_rows, device)


def context(data: TpchData, config: dict, device) -> ExecutionContext:
    """An ExecutionContext on ``device`` holding the eight tables: those in
    ``config["host_tables"]`` host-resident in morsels of
    ``config["morsel_rows"]`` rows, the others on the device."""
    ctx = ExecutionContext(device=device)
    host = set(config["host_tables"])
    for t in SCHEMA:
        if t in host:
            ctx.register_host_table(t, host_table(data, t, config["morsel_rows"], device),
                                    morsel_rows=config["morsel_rows"])
        else:
            ctx.register_table(t, device_table(data, t, device))
    return ctx
