"""The reference's rows of TPC-H queries in a canonical form, and the check
that holds an engine's rows to them.

An expected file holds the rows of ``tpchdata.generate_tpch(sf, seed)``
for the ``sf`` and ``seed`` it names: ``tests/data/torch_tpch_sf1_seed7.json.gz``
the 22 queries at SF1 (written by ``tests/torch_expected_sf1.py``), and
``tests/data/torch_tpch_sf10_seed7.json.gz`` ``bench/sf_check.py``'s nine
at SF10, run with lineitem and orders host-resident (written by
``tests/torch_expected_sf10.py``, which also records ``host_tables``,
``morsel_rows`` and, per query, ``host_scans`` of the JAX package's plan).
Each document holds:

* ``sf`` and ``seed``;
* ``tables``: ``table_digest`` of the generated arrays, so a reader knows
  its tables are the ones the rows came from;
* ``queries``: per query (``"1"``..``"22"``) an entry with ``sql_sha256``
  (``sql_digest`` of the query's text), ``rows`` (the count), ``ordered``
  and ``order_spec`` (``queries.FULLY_ORDERED`` and ``ORDER_SPECS``),
  ``columns`` ([name, kind] with kind ``int``, ``str``, ``date``, ``float``
  or ``decimal:<scale>``), and either ``values`` (the canonical rows, for
  results under ``FULL_ROWS`` rows) or ``column_digests`` (a SHA-256 of
  each exact column, by its index) plus ``floats`` (each float column in
  full, by its index);
* ``versions``: numpy's and the engine's that wrote it.

Canonical form: a decimal is its scaled integer (``round(v * 10**scale)``
of the decoded float: the integer itself below 2^53, and above it the same
function of the same integer in every engine that decodes as
``Column.to_pylist`` does), a date its ISO string; rows are sorted by their
exact columns, then by their float columns.  An ordered query's row order
is checked apart, on its ORDER BY columns (``order_spec``), because rows
that tie there may come in any order (Q3's and Q5's revenue).

The engine's column names must be the entry's, and each value of its
column's kind.  Tolerances (those of ``tests/torch_tpch.py`` against the
JAX package): exact columns exactly, floats within ``REL`` of
max(|want|, 1).

numpy and the standard library only: the port and ``chip_smoke.py`` read
it where neither JAX nor pandas is installed.
"""

from __future__ import annotations

import datetime
import gzip
import hashlib
import json
import math

import numpy as np

REL = 1e-12
FULL_ROWS = 1000  # results with at least this many rows are kept as digests
SEP = "\x1f"  # follows each string in a table digest
_CHUNK = 1 << 20


def _column_sha(a: np.ndarray) -> str:
    h = hashlib.sha256()
    if a.dtype.kind in "OU":
        for i in range(0, len(a), _CHUNK):
            h.update((SEP.join(a[i:i + _CHUNK].tolist()) + SEP).encode("utf-8"))
    else:
        h.update(np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<")).tobytes())
    return h.hexdigest()


def table_digest(data: dict) -> dict:
    """{table: {column: SHA-256 hex}} of ``generate_tpch``'s host arrays:
    strings as UTF-8 each followed by ``SEP``, numbers as their raw
    little-endian bytes."""
    return {t: {c: _column_sha(np.asarray(a)) for c, a in cols.items()} for t, cols in data.items()}


def check_tables(data: dict, doc: dict) -> None:
    """Raise unless ``data``'s digests are the file's, naming the first
    table and column that differ and both numpy versions."""
    got, want = table_digest(data), doc["tables"]
    for t in sorted(set(got) | set(want)):
        for c in sorted(set(got.get(t, {})) | set(want.get(t, {}))):
            if got.get(t, {}).get(c) != want.get(t, {}).get(c):
                raise AssertionError(
                    f"generated table {t} column {c} differs from the expected file's "
                    f"(numpy {np.__version__} here, {doc['versions']['numpy']} for the file)")


def check_texts(doc: dict, sql_of) -> None:
    """Raise unless each query's text (``sql_of(q)``) is the one the file's
    rows come from, naming the first that is not."""
    for q in sorted(doc["queries"], key=int):
        if sql_digest(sql_of(int(q))) != doc["queries"][q]["sql_sha256"]:
            raise AssertionError(f"the text of Q{q} is not the one the expected file's rows come from: "
                                 f"write the file again (tests/torch_expected_sf{doc['sf']:g}.py --write)")


def _converter(name: str, kind: str):
    """The canonical form of one value of column ``name``, raising on a
    value that is not of the column's ``kind``: an ``int`` column takes
    ints only, a decimal ints or floats within rel ``REL`` of a scaled
    integer (a decimal decoded as ``int(v) / 10**scale`` is), so a column
    computed in floats does not pass for one in decimals."""

    def bad(v):
        return AssertionError(f"column {name} is {kind} but holds {v!r} ({type(v).__name__})")

    def typed(types, f=lambda v: v):
        def g(v):
            if not isinstance(v, types) or isinstance(v, bool):
                raise bad(v)
            return f(v)
        return g

    if kind.startswith("decimal:"):
        scale = 10 ** int(kind[8:])

        def scaled(v):
            if isinstance(v, int):
                return v
            x = v * scale
            n = round(x)
            if abs(x - n) > REL * max(abs(x), 1.0):
                raise bad(v)
            return n
        return typed((int, float), scaled)
    if kind == "date":
        return typed((datetime.date, str), lambda v: v if isinstance(v, str) else v.isoformat())
    return typed({"float": float, "str": str, "int": int}[kind])


_PLAIN = {"int": int, "str": str, "float": float}  # kinds whose values are their canonical form


def _columns(rows: list, names: list, kinds: list) -> list:
    """The canonical values of ``rows``, column by column."""
    if not rows:
        return [[] for _ in kinds]
    out = []
    for col, name, kind in zip(zip(*rows), names, kinds):
        if kind in _PLAIN and set(map(type, col)) <= {_PLAIN[kind], type(None)}:
            out.append(list(col))  # already canonical: no value to convert or refuse
            continue
        f = _converter(name, kind)
        out.append([None if v is None else f(v) for v in col])
    return out


def _split(kinds: list) -> tuple:
    floats = [j for j, k in enumerate(kinds) if k == "float"]
    return [j for j, k in enumerate(kinds) if k != "float"], floats


def _sorted_rows(cols: list, kinds: list) -> list:
    exact, floats = _split(kinds)
    keys = [c if None not in c else [(1, 0) if v is None else (0, v) for v in c]
            for c in (cols[j] for j in exact + floats)]
    keys = list(zip(*keys))
    rows = list(zip(*cols))
    return [rows[i] for i in sorted(range(len(rows)), key=keys.__getitem__)]


def canonical(rows: list, columns: list) -> list:
    """``rows`` (tuples of decoded values) with each value in its column's
    canonical form (``columns`` [(name, kind)]), sorted by the exact
    columns, then by the float columns (NULLs last)."""
    names, kinds = zip(*columns) if columns else ((), ())
    return _sorted_rows(_columns(rows, names, kinds), kinds)


_JSON = json.JSONEncoder(ensure_ascii=False, separators=(",", ":"))


# the JSON text of a value of one type, without JSONEncoder's overhead
_JSON_OF_TYPE = {int: int.__repr__, str: json.encoder.encode_basestring}


def _sha(values) -> str:
    """SHA-256 of the values' JSON texts, each followed by a newline."""
    values = list(values)
    types = set(map(type, values))
    enc = _JSON_OF_TYPE.get(types.pop()) if len(types) == 1 else None
    text = "\n".join(map(enc or _JSON.encode, values))
    return hashlib.sha256((text + "\n" if values else "").encode("utf-8")).hexdigest()


def sql_digest(text: str) -> str:
    """SHA-256 of a query's text, kept in its entry: the rows are those of
    this text."""
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def entry(sql: str, rows: list, columns: list, ordered: bool, order_spec) -> dict:
    """The expected file's entry for one query's result: ``sql`` its text,
    ``rows`` decoded, ``columns`` [(name, kind)]."""
    exact, floats = _split([k for _, k in columns])
    canon = canonical(rows, columns)
    out = {"sql_sha256": sql_digest(sql), "rows": len(canon), "ordered": ordered,
           "order_spec": [list(s) for s in order_spec or []], "columns": [list(c) for c in columns]}
    if len(canon) < FULL_ROWS:
        out["values"] = [list(r) for r in canon]
    else:
        cols = list(zip(*canon))
        out["column_digests"] = {str(j): _sha(cols[j]) for j in exact}
        out["floats"] = {str(j): [r[j] for r in canon] for j in floats}
    return out


def _same_float(g, w) -> bool:
    if g is None or w is None:
        return g is w
    return g == w or (math.isnan(g) and math.isnan(w)) or abs(g - w) <= REL * max(abs(w), 1.0)


def check_order(label: str, rows: list, spec: list) -> None:
    """Raise unless ``rows`` are in the order of ``spec`` [(column,
    descending)]; rows that tie on every column of ``spec`` may come in
    any order."""
    for i in range(1, len(rows)):
        for col, desc in spec:
            a, b = rows[i - 1][col], rows[i][col]
            if a == b:
                continue
            if (a < b) == desc:
                raise AssertionError(f"{label}: rows {i - 1} and {i} out of order on column {col}: "
                                     f"{rows[i - 1]} then {rows[i]}")
            break


def compare(label: str, got: dict, want: dict) -> None:
    """Raise unless ``got`` ({name: decoded values}, in the engine's order)
    are the rows of the expected entry ``want``, under its column names and
    kinds: the first differing row, or the first exact column whose digest
    differs, and the row counts."""
    names = [n for n, _ in want["columns"]]
    kinds = [k for _, k in want["columns"]]
    if list(got) != names:
        raise AssertionError(f"{label}: columns {list(got)}, want {names}")
    rows = list(zip(*got.values()))
    if len(rows) != want["rows"]:
        raise AssertionError(f"{label}: {len(rows)} rows, want {want['rows']}")
    try:
        cols = _columns(rows, names, kinds)
    except AssertionError as e:
        raise AssertionError(f"{label}: {e}") from None
    if want["ordered"] and want["order_spec"]:
        check_order(label, list(zip(*cols)), want["order_spec"])
    exact, floats = _split(kinds)
    canon = _sorted_rows(cols, kinds)
    if "values" in want:
        for i, (r, w) in enumerate(zip(canon, want["values"])):
            bad = [names[j] for j in exact if r[j] != w[j]]
            bad += [names[j] for j in floats if not _same_float(r[j], w[j])]
            if bad:
                raise AssertionError(f"{label}: row {i} of {len(canon)} (canonical order) differs in "
                                     f"{bad}: {r} != {tuple(w)}")
        return
    canon_cols = list(zip(*canon))
    for j in exact:
        if _sha(canon_cols[j] if canon_cols else ()) != want["column_digests"][str(j)]:
            raise AssertionError(f"{label}: column {names[j]} differs from the expected digest "
                                 f"({len(canon)} rows, as expected)")
    for j in floats:
        for i, (r, w) in enumerate(zip(canon, want["floats"][str(j)])):
            if not _same_float(r[j], w):
                raise AssertionError(f"{label}: row {i} of {len(canon)} (canonical order), column "
                                     f"{names[j]}: {r[j]!r}, want {w!r} (row {r})")


# the table of a TPC-H column, by the column name's prefix
_TPCH_TABLE_OF_PREFIX = {"l": "lineitem", "o": "orders", "c": "customer", "ps": "partsupp",
                         "p": "part", "s": "supplier", "n": "nation", "r": "region"}
_STREAMS = ("MorselStageExec", "MorselJoinStageExec")


def host_scans(plan) -> list:
    """How a physical plan of either engine reads its host-resident TPC-H
    tables: sorted [kind, table] pairs, ``kind`` the class of each stage
    that streams a table's morsels, or ``materialized`` for a host scan
    that reads the table whole.  The plan is walked through its children
    and the sources of its fused stages."""
    seen, stack, out = set(), [plan], []
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        kind = type(n).__name__
        if kind in _STREAMS or kind == "HostMemoryExec":
            table = _TPCH_TABLE_OF_PREFIX.get(n.host.names[0].split("_")[0], n.host.names[0])
            out.append([kind if kind in _STREAMS else "materialized", table])
        stack.extend(n.children())
        if getattr(n, "_source", None) is not None:
            stack.append(n._source)
    return sorted(out)


def load(path) -> dict:
    with gzip.open(path, "rt", encoding="utf-8") as f:
        return json.load(f)


def write(path, doc: dict) -> None:
    """Write ``doc`` as gzipped JSON, byte for byte the same for the same
    document (sorted keys, no timestamp)."""
    raw = json.dumps(doc, ensure_ascii=False, sort_keys=True, separators=(",", ":")).encode("utf-8")
    with open(path, "wb") as f:
        f.write(gzip.compress(raw, compresslevel=9, mtime=0))
