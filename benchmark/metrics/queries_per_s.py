"""Queries completed in the window over the window's seconds."""


def read(trace):
    done = sum(c.error is None for c in trace.calls)
    return done / trace.window_s if done and trace.window_s > 0 else None
