"""The benchmark of ``datafusion_tpu_torch`` on one NVIDIA H100.

One command runs one cell of ``BENCHMARK.json``::

    python3 -m benchmark.run --workload sf10_dev.nine --seed 7 --seconds 30 --trace 0

Everything a cell is made of sits in files found by name: the
configuration (``configs/<name>.json``), the traffic mix
(``mixes/<name>.json``), the query texts (``queries/<query>.sql``), the
plain reference of each query (``reference/<query>.py``) and each
per-layer metric (``metrics/<name>.py``).  The generator
(``tpchgen.py``), the comparison (``compare.py``) and the reading of the
profiler's trace (``trace.py``) are shared by every cell.

This package imports nothing of the JAX package; ``reference/``,
``tpchgen.py`` and ``compare.py`` import nothing of the port either.
"""
