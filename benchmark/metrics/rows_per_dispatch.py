"""Rows a server dispatch over the window: ``rows_served / dispatches``
of ``CoalescingServer``'s counters."""


def read(run):
    n = run.counters.get("dispatches", 0)
    return run.counters["rows_served"] / n if n else None
