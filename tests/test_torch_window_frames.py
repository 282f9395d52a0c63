"""Twins of tests/test_window_frames.py: its 21 window frames (ROWS,
RANGE and GROUPS, with and without offsets, and the defaults) on the torch
port on the CPU against sqlite, with the reference's own body
(``torch_twins``)."""

from torch_twins import twin_tests

twin_tests(globals(), "test_window_frames.py", ["test_window_frames_vs_sqlite"])
