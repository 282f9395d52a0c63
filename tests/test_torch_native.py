"""The port's native host runtime (datafusion_tpu_torch/native_lib.py, its
own copy of the C++ loader in datafusion_tpu_torch/csrc/dftpu_native.cpp,
built with g++ at first use): the twins of tests/test_native.py's six
tests that use no JAX, with the reference's own bodies (``torch_twins``),
and port versions of the rest: a registered CSV goes through the native
loader, and a CSV/TBL with a schema loads, host-resident too, where
pyarrow cannot be imported."""

import subprocess
import sys
from pathlib import Path

from torch_twins import twin_tests

import datafusion_tpu_torch as D
from datafusion_tpu_torch import native_lib

twin_tests(globals(), "test_native.py", [
    "test_native_csv_all_types", "test_native_csv_matches_pyarrow",
    "test_native_tbl_trailing_delimiter", "test_native_partition_matches_numpy",
    "test_native_csv_blank_lines", "test_native_csv_unterminated_quote_terminates",
])

ROOT = Path(__file__).resolve().parent.parent


def test_csv_datasource_uses_native(tmp_path):
    """End to end: a registered CSV (its schema inferred) loads through the
    native loader and queries return correct results."""
    p = tmp_path / "sales.csv"
    p.write_text("region,amount\neast,10\nwest,20\neast,5\n")
    ctx = D.ExecutionContext(device="cpu")
    ctx.register_csv("sales", str(p))
    out = ctx.sql("SELECT region, sum(amount) AS s FROM sales GROUP BY region ORDER BY region").collect()
    assert out.to_pydict() == {"region": ["east", "west"], "s": [15, 20]}
    assert ctx._resolve_table("sales").loader == "native"
    assert native_lib.library_path().exists()


def test_tbl_with_schema_needs_no_pyarrow(tmp_path):
    """pyarrow may be missing where the engine runs: a TBL file with a
    schema loads through the native loader without it, device-resident
    and host-resident, and CREATE EXTERNAL TABLE too."""
    p = tmp_path / "t.tbl"
    p.write_text("1|A|1995-01-02|10.50|\n2|B|1996-03-04|0.25|\n3|A|1997-05-06|1.00|\n")
    csv = tmp_path / "e.csv"
    csv.write_text(p.read_text().replace("|\n", "\n").replace("|", ","))
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\n"
        "import datafusion_tpu_torch as D\n"
        "from datafusion_tpu_torch.datasource.host import HostTable\n"
        "from datafusion_tpu_torch.types import Field, Schema\n"
        "from datafusion_tpu_torch.types.dtypes import DATE32, INT64, STRING, decimal\n"
        "sch = Schema([Field('k', INT64), Field('f', STRING), Field('d', DATE32), Field('m', decimal(15, 2))])\n"
        "ctx = D.ExecutionContext(device='cpu')\n"
        f"ctx.register_csv('t', {str(p)!r}, sch, has_header=False, delimiter='|')\n"
        "q = 'SELECT f, count(*) c, sum(m) s FROM t GROUP BY f ORDER BY f'\n"
        "want = {'f': ['A', 'B'], 'c': [2, 1], 's': [11.5, 0.25]}\n"
        "assert ctx.sql(q).collect().to_pydict() == want\n"
        "assert ctx._resolve_table('t').loader == 'native'\n"
        "ctx.register_host_table('h', ctx.sql('SELECT * FROM t').collect(), morsel_rows=2)\n"
        "assert ctx.sql(q.replace('FROM t', 'FROM h')).collect().to_pydict() == want\n"
        f"ctx.sql(\"CREATE EXTERNAL TABLE e (k BIGINT, f VARCHAR, d DATE, m DECIMAL(15, 2)) STORED AS CSV LOCATION '{csv}'\")\n"
        "assert ctx.sql('SELECT count(*) c, max(k) k FROM e').collect().to_pydict() == {'c': [3], 'k': [3]}\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
