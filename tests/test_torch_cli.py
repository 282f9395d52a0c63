"""The torch port's CLI on the CPU: the four tests of tests/test_cli.py
run their own bodies and assertions on the port (``torch_twins``), and
the CLI asked for the card where there is none fails, naming the device
(in a subprocess, outside the twins' CPU mapping, with no card visible and
jax unimportable)."""

import jax

jax.config.update("jax_platforms", "cpu")

import os
import subprocess
import sys
from pathlib import Path

from torch_twins import twin_tests

ROOT = Path(__file__).resolve().parent.parent

twin_tests(globals(), "test_cli.py", [
    "test_format_table", "test_print_formats", "test_split_statements", "test_command_mode",
])

_BLOCK_JAX = (
    "import sys\n"
    "for m in ('jax', 'jaxlib', 'datafusion_tpu', 'bench'):\n"
    "    sys.modules[m] = None\n"
    "from datafusion_tpu_torch.cli import main\n"
    "sys.exit(main(sys.argv[1:]))\n"
)


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-c", _BLOCK_JAX, *args], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1"),
    )


def test_cli_without_cpu_and_without_a_card_fails_naming_the_device():
    proc = _cli("--quiet", "-c", "SELECT 1 AS one")
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr, proc.stderr
    assert "| 1" not in proc.stdout


def test_cli_cpu_runs_with_jax_blocked():
    proc = _cli("--cpu", "--quiet", "--format", "csv", "-c", "SELECT 1 AS one, 'a' AS b")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == "one,b\n1,a\n"
