"""Bytes a batch copies from the host to the card in the engine's
``prepare`` (the port's ``h2d_bytes`` counter over the window's
batches): the padded queries for the table, the scan's query operand and
the certificate's inputs."""

from benchmark.program_counters import per_batch


def read(run):
    return per_batch(run, "h2d_bytes")
