"""Queries answered a second over the whole window (closed loop)."""


def read(run):
    return run.attempted / run.window_s if run.window_s > 0 else None
