"""Terminal exact scans a batch (the port's ``terminal_scans`` counter
over the window's batches): batches whose certificate still failed for
some row, padding included, after the ladder's last rung."""

from benchmark.program_counters import per_batch


def read(run):
    return per_batch(run, "terminal_scans")
