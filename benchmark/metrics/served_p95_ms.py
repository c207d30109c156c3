"""95th percentile (nearest rank) over every request of the window, from
its scheduled send time to its answer, in ms; a request never answered
counts as the longest wait (the window plus the drain)."""

import math

from benchmark.generators.open_poisson import DRAIN_S


def read(run):
    lat = sorted(list(run.latencies) + [run.seconds + DRAIN_S] * run.failed)
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3 if lat else None
