"""Process start to the first timed call: inputs made on the card, the
index build and the warm-up (the reference runs after the window)."""


def read(run):
    return run.setup_s
