"""Run a reference test module's own tests against the torch port.

``twin_tests(namespace, "test_sql.py", names)`` loads ``tests/test_sql.py``
afresh while ``import datafusion_tpu...`` resolves to the port's module of
the same path, and puts the named tests (and the module's fixtures) into
``namespace``, the twin module's globals: pytest collects them there, and
each runs the reference's own body and assertions on the port.  The JAX
package runs the same tests from the reference's own file, so every twin
holds both engines to one oracle.

The twin module installs ``port_on_cpu`` as an autouse module fixture: for
the length of its tests, imports inside a test body resolve to the port too,
and ``device=None`` (the card) means the CPU, where the port runs its
kernels' plain versions.  Everything is restored afterwards; the JAX
package's modules stay loaded and untouched, so its tests in other modules
are unaffected (``--dist loadfile`` runs a module's tests together).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import pkgutil
import sys
from pathlib import Path

import pytest

import datafusion_tpu_torch as D
import datafusion_tpu_torch.device as pdevice

_TESTS = Path(__file__).resolve().parent
_REF, _PORT = "datafusion_tpu", "datafusion_tpu_torch"


def _is(name: str, pkg: str) -> bool:
    return name == pkg or name.startswith(pkg + ".")


def _port_modules() -> dict:
    for m in pkgutil.walk_packages(D.__path__, _PORT + "."):
        importlib.import_module(m.name)
    return {n: m for n, m in sys.modules.items() if _is(n, _PORT)}


@contextlib.contextmanager
def port_as_reference():
    """``import datafusion_tpu.X`` gives ``datafusion_tpu_torch.X``, and a
    device of None means the CPU, inside the block."""
    mods = _port_modules()
    saved = {n: sys.modules.pop(n) for n in list(sys.modules) if _is(n, _REF)}
    orig = pdevice.resolve_device

    def on_cpu(device=None):
        return orig("cpu" if device is None else device)

    patched = [m for m in mods.values() if getattr(m, "resolve_device", None) is orig]
    for n, m in mods.items():
        sys.modules[_REF + n[len(_PORT):]] = m
    for m in patched:
        m.resolve_device = on_cpu
    try:
        yield
    finally:
        for m in patched:
            m.resolve_device = orig
        for n in [n for n in sys.modules if _is(n, _REF)]:
            del sys.modules[n]
        sys.modules.update(saved)


@pytest.fixture(autouse=True, scope="module")
def port_on_cpu():
    with port_as_reference():
        yield


def twin_tests(namespace: dict, ref_file: str, names: list[str]) -> None:
    """Load ``tests/<ref_file>`` against the port and put its fixtures and
    the tests ``names`` into ``namespace``."""
    path = _TESTS / ref_file
    spec = importlib.util.spec_from_file_location(f"_port_twin_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    with port_as_reference():
        spec.loader.exec_module(mod)
    fixtures = {k: v for k, v in vars(mod).items()
                if hasattr(v, "_fixture_function_marker") or hasattr(v, "_pytestfixturefunction")}
    missing = [n for n in names if n not in vars(mod)]
    if missing:
        raise LookupError(f"{ref_file} has no {missing}")
    namespace.update(fixtures)
    namespace.update({n: getattr(mod, n) for n in names})
    namespace["port_on_cpu"] = port_on_cpu
