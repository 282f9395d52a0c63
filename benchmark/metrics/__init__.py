"""One reader per metric of ``BENCHMARK.json``, found by the metric's name:
``read(trace)`` takes a ``trace.Trace`` and returns the metric's value,
or None where the run has nothing for it to read."""
