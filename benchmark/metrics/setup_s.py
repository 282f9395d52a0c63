"""Seconds from the start of the benchmark's process to its first timed
query: imports, generation, ingest and upload or pinning, kernel builds
or their cache, warm-up."""


def read(trace):
    return trace.setup_s
