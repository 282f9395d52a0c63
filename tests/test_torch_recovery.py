"""Twins of tests/test_recovery.py on the torch port on the CPU: its three
tests (scheduler state that outlives a restart, the NDJSON source, a lost
delivery requeued on the next poll) run the reference's own bodies and
assertions on the port (``torch_twins``)."""

import jax

jax.config.update("jax_platforms", "cpu")

from torch_mesh import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_twins import twin_tests

twin_tests(globals(), "test_recovery.py", [
    "test_scheduler_state_survives_restart", "test_ndjson_datasource",
    "test_lost_delivery_requeues_on_next_poll",
])
