"""Rerank kernel launches a batch over the window
(``kernels.build.launch_counts()['rerank']``): 1 for the first rung plus
one for each further rung of the ladder that fired."""


def read(run):
    n = run.counters.get("launches", {}).get("rerank", 0)
    return n / run.calls if n and run.calls else None
