"""Interactive SQL CLI: the datafusion-cli equivalent.

Port of ``datafusion_tpu/cli.py``.  As datafusion-cli/src/main.rs:36: a
readline REPL (or `-f` script / `-c` command mode) over an
ExecutionContext, with the same print formats as DataFusion's PrintFormat
enum (datafusion-cli/src/print_format.rs:29-34): table, csv, tsv, json,
ndjson; the output is the JAX package's byte for byte.

Usage:
  python -m datafusion_tpu_torch.cli                       # REPL
  python -m datafusion_tpu_torch.cli -f script.sql         # run a script
  python -m datafusion_tpu_torch.cli -c "SELECT 1"         # one command
  options: --format table|csv|tsv|json|ndjson  --quiet  --cpu

Queries run on the CUDA card, and the CLI fails at start where there is
none; ``--cpu`` runs them on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def format_table(names: list[str], rows: list[list]) -> str:
    """Pretty +---+ table (arrow::util::pretty equivalent)."""
    cells = [[_render(v) for v in row] for row in rows]
    widths = [len(n) for n in names]
    for row in cells:
        for i, c in enumerate(row):
            widths[i] = max(widths[i], len(c))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep]
    out.append("| " + " | ".join(n.ljust(w) for n, w in zip(names, widths)) + " |")
    out.append(sep)
    for row in cells:
        out.append("| " + " | ".join(c.ljust(w) for c, w in zip(row, widths)) + " |")
    out.append(sep)
    return "\n".join(out)


def _render(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return repr(v)
    return str(v)


def _json_value(v):
    import datetime as dt

    if isinstance(v, (dt.date, dt.datetime)):
        return v.isoformat()
    return v


def print_result(table, fmt: str, file=None):
    file = file if file is not None else sys.stdout
    d = table.to_pydict()
    names = list(d.keys())
    rows = [list(r) for r in zip(*d.values())] if names else []
    if fmt == "table":
        print(format_table(names, rows), file=file)
    elif fmt in ("csv", "tsv"):
        delim = "," if fmt == "csv" else "\t"
        print(delim.join(names), file=file)
        for r in rows:
            print(delim.join(_render(v) for v in r), file=file)
    elif fmt == "json":
        objs = [
            {n: _json_value(v) for n, v in zip(names, r)} for r in rows
        ]
        print(json.dumps(objs), file=file)
    elif fmt == "ndjson":
        for r in rows:
            print(
                json.dumps({n: _json_value(v) for n, v in zip(names, r)}), file=file
            )
    else:
        raise ValueError(f"unknown format {fmt}")


def run_statement(ctx, sql: str, fmt: str, quiet: bool):
    t0 = time.perf_counter()
    out = ctx.sql(sql).collect()
    elapsed = time.perf_counter() - t0
    if out.num_columns:
        print_result(out, fmt)
    if not quiet:
        print(f"{out.nrows} rows in set. Query took {elapsed:.3f} seconds.")


def split_statements(text: str) -> list[str]:
    """Split on ';' outside string literals."""
    stmts, cur, in_str = [], [], False
    for ch in text:
        if ch == "'":
            in_str = not in_str
        if ch == ";" and not in_str:
            s = "".join(cur).strip()
            if s:
                stmts.append(s)
            cur = []
        else:
            cur.append(ch)
    s = "".join(cur).strip()
    if s:
        stmts.append(s)
    return stmts


def repl(ctx, fmt: str, quiet: bool):
    try:
        import readline  # noqa: F401  (history + line editing)
    except ImportError:
        pass
    print("datafusion-tpu CLI. Type SQL, \\q to quit, \\d to list tables.")
    buf: list[str] = []
    while True:
        try:
            prompt = "> " if not buf else "  "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            return
        s = line.strip()
        if not buf and s in ("\\q", "quit", "exit"):
            return
        if not buf and s == "\\d":
            for name in ctx.tables():
                print(name)
            continue
        buf.append(line)
        if s.endswith(";"):
            text = "\n".join(buf)
            buf = []
            for stmt in split_statements(text):
                try:
                    run_statement(ctx, stmt, fmt, quiet)
                except Exception as e:
                    print(f"Error: {e}", file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="datafusion-tpu-cli")
    ap.add_argument("-f", "--file", help="run SQL statements from a file")
    ap.add_argument("-c", "--command", help="run a single SQL command")
    ap.add_argument(
        "--format",
        default="table",
        choices=["table", "csv", "tsv", "json", "ndjson"],
    )
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from .execution.context import ExecutionContext

    ctx = ExecutionContext(device="cpu" if args.cpu else None)
    if args.command:
        for stmt in split_statements(args.command):
            run_statement(ctx, stmt, args.format, args.quiet)
        return 0
    if args.file:
        with open(args.file) as f:
            text = f.read()
        for stmt in split_statements(text):
            run_statement(ctx, stmt, args.format, args.quiet)
        return 0
    repl(ctx, args.format, args.quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())
