"""Share of the traced slice in which no operation ran on the device:
1 - (union of device activity) / slice, in %."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
