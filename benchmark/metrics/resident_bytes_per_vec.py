"""Device bytes the index holds after set-up and warm-up, less those held
before it was built (``torch.cuda.memory_allocated``), over its rows."""


def read(run):
    if run.device.type != "cuda" or run.resident_bytes <= 0:
        return None
    return run.resident_bytes / run.n_rows
