"""The scan's least time over its device time a batch, in %.

The scan kernels are those whose profiler names contain an entry of
``scan_roofline.json`` (or of any ``scan_roofline.*.json`` beside it).
Work of one batch: 2 N B D operations at the configuration's
``scan_precision`` (the kernel's operands), or the bytes
``roofline.scan_bytes`` counts at 3.35 TB/s from the tile stream the
engine holds, whichever takes longer; N and B are the real rows and
queries, not the padding.
Time: the traced slice's scan kernel seconds over their launches."""

import json
from pathlib import Path

from benchmark import roofline


def kernels():
    names = []
    for p in sorted(Path(__file__).parent.glob("scan_roofline*.json")):
        names += json.loads(p.read_text())["kernels"]
    return names


def read(run):
    tr = run.trace
    if tr is None:
        return None
    pats = kernels()
    secs = launches = 0
    for name, (s, n) in tr.device_ops.items():
        if any(p in name for p in pats):
            secs += s
            launches += n
    if not launches or secs <= 0:
        return None
    cfg = run.config
    b, d = run.traffic["batch"], cfg["D"]
    stream = run.counters.get("scan_stream_bytes", 0)
    if stream <= 0:
        return None
    ops = roofline.scan_ops(run.n_rows, b, d, cfg["scan_precision"])
    nbytes = roofline.scan_bytes(stream, run.n_rows, b, d, cfg["M"])
    least, _ = roofline.bound_s(
        nbytes, ops, roofline.scan_peak_kind(cfg["scan_precision"]))
    return 100.0 * least / (secs / launches)
