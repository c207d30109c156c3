"""The port's own counters (``deltapq_tpu_torch.tracing``), for the
readers of ``program_counter`` metrics.

``run.py`` zeroes the launch counts, and with them every counter of the
port's registry, just before the window opens, so a reader that runs
after the window reads the window's counts.  A tree of the port without
the registry gives None, and so do the readers."""

from __future__ import annotations

from typing import Optional


def window_counts() -> Optional[dict]:
    """Every counter of the port's registry, or None where the port has
    none."""
    try:
        from deltapq_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()["counters"]


def per_batch(run, name: str) -> Optional[float]:
    """Counter ``name`` over the window's batches (0 where it never
    moved), or None without a registry or a batch."""
    counts = window_counts()
    if counts is None or not run.calls:
        return None
    return counts.get(name, 0) / run.calls
