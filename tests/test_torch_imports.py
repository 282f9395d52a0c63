"""Import hygiene of the torch port: neither datafusion_tpu_torch nor
chip_smoke.py imports jax, the JAX package (datafusion_tpu) or bench, and
the package loads and runs a query with jax made unimportable."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "datafusion_tpu", "bench"}
SOURCES = sorted((ROOT / "datafusion_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_are_found():
    assert len(SOURCES) > 40
    assert any(p.name == "smalldomain.py" for p in SOURCES)


def test_the_mesh_modules_are_checked():
    mesh = {p.name for p in SOURCES if p.parent.name == "parallel"}
    assert mesh >= {"collectives.py", "mesh.py", "shuffle.py", "ops.py", "executor.py", "multihost.py"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_package_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'datafusion_tpu', 'bench'):\n"
        "    sys.modules[m] = None\n"
        "import datafusion_tpu_torch as D\n"
        "import datafusion_tpu_torch.build, datafusion_tpu_torch.q1data\n"
        "ctx = D.ExecutionContext(device='cpu')\n"
        "ctx.register_table('t', D.Table.from_pydict({'g': ['a', 'b', 'a'], 'v': [1, 2, 3]}, device='cpu'))\n"
        "out = ctx.sql('SELECT g, sum(v) s FROM t GROUP BY g ORDER BY g').collect().to_pydict()\n"
        "assert out == {'g': ['a', 'b'], 's': [4, 2]}, out\n"
        "assert not any(m.startswith('jax') and sys.modules[m] is not None for m in sys.modules)\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_mesh_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'datafusion_tpu', 'bench'):\n"
        "    sys.modules[m] = None\n"
        "import datafusion_tpu_torch as D\n"
        "from datafusion_tpu_torch.parallel import multihost\n"
        "from datafusion_tpu_torch.parallel.mesh import make_mesh\n"
        "ctx = D.ExecutionContext(device='cpu')\n"
        "ctx.register_table('t', D.Table.from_pydict({'g': ['a', 'b', 'a'], 'v': [1, 2, 3]}, device='cpu'))\n"
        "df = ctx.sql('SELECT g, sum(v) s FROM t GROUP BY g ORDER BY g')\n"
        "assert df.collect(mesh=make_mesh(3, device='cpu')).to_pydict() == {'g': ['a', 'b'], 's': [4, 2]}\n"
        "assert not multihost.initialize()\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
