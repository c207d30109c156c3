"""Share of the queries sent (padding rows left out) that the first rung
certified, over the window, in %: the port's ``first_shot_rows`` over
its ``real_rows``."""

from benchmark.program_counters import window_counts


def read(run):
    counts = window_counts()
    if counts is None or not counts.get("real_rows"):
        return None
    return 100.0 * counts.get("first_shot_rows", 0) / counts["real_rows"]
