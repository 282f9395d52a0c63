"""What the benchmark's modules load, each in a fresh interpreter: the
harness loads no JAX and nothing of the JAX package or of ``bench``; the
plain reference, the generator and the comparison load nothing of the
port either.  Names are compared whole, up to the first dot, so the
port's ``datafusion_tpu_torch`` is not taken for ``datafusion_tpu``."""

import json
import subprocess
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
HARNESS_FORBIDDEN = {"jax", "jaxlib", "flax", "datafusion_tpu", "bench"}
REFERENCE_FORBIDDEN = HARNESS_FORBIDDEN | {"datafusion_tpu_torch"}
REFERENCE = sorted(p.stem for p in (CHECKOUT / "benchmark" / "reference").glob("q*.py"))


def loaded(*modules: str) -> set:
    code = ("import importlib, json, sys\n"
            f"for m in {list(modules)!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = loaded("benchmark.run", *(f"benchmark.metrics.{p.stem}"
                                     for p in (CHECKOUT / "benchmark" / "metrics").glob("*.py")
                                     if p.stem != "__init__"))
    assert "datafusion_tpu_torch" in mods and "torch" in mods
    assert not mods & HARNESS_FORBIDDEN, mods & HARNESS_FORBIDDEN


def test_reference_side_loads_nothing_of_the_port():
    mods = loaded("benchmark.tpchgen", "benchmark.compare", "benchmark.trace", "benchmark.reference",
                  *(f"benchmark.reference.{q}" for q in REFERENCE))
    assert len(REFERENCE) >= 12 and "torch" in mods
    assert not mods & REFERENCE_FORBIDDEN, mods & REFERENCE_FORBIDDEN


def test_whole_names_are_compared():
    sys.path.insert(0, str(CHECKOUT))
    try:
        from benchmark.run import FORBIDDEN
    finally:
        sys.path.remove(str(CHECKOUT))
    assert "datafusion_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "datafusion_tpu" in FORBIDDEN


def test_no_result_without_the_port_or_a_card(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, and here without a card, a run exits non-zero with no result."""
    import shutil

    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "sf10_dev.nine",
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
