"""Find the knee of a served cell: one set-up, then the open-loop
generator at each of a few fixed rates, in one process.

    python3 -m benchmark.sweep --workload sift1m.serve --config sift1m \
        --traffic serve_poisson --seed 5 --seconds 8 --rates 40000,60000,80000

The cell need not be in ``BENCHMARK.json``: its configuration, traffic
and cell files are named here.

One JSON line a rate: the offered and the answered rate (queries a
second over the span from the first send to the last answer), the served
p50 / p95 / p99 in ms, the p95 of the first and the last quarter of the
requests (a backlog that grows shows as the last far above the first),
and the generator's lateness.  The knee is the highest rate that is
answered as fast as it is offered without a growing backlog; a cell is
then set at about four fifths of it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import numpy as np
import torch

from . import data
from .run import Session, cell_spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True,
                    help="the cell file, workloads/<name>.json")
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--drain", type=float, default=15.0,
                    help="seconds to await answers past each rate's window")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from deltapq_tpu_torch.index import DeltaPQIndex

    dev = torch.device("cuda", 0)
    spec = cell_spec({"name": args.workload, "config": args.config,
                      "traffic": args.traffic, "chips": 1})
    gen = importlib.import_module(
        f"benchmark.generators.{spec['traffic']['kind']}")
    s = Session(spec, args.seed, args.seconds, False, dev)
    inputs = data.make_inputs(s.config, s.traffic, args.seed, dev)
    s.queries = inputs["queries"]
    s.index = DeltaPQIndex(inputs["codewords"], inputs["codes"],
                           engine=s.config["engine"], device=dev)
    gen.warmup(s)
    base = dict(s.traffic)
    for rate in (float(x) for x in args.rates.split(",")):
        s.traffic = dict(base, rate_qps=rate)
        s.latencies, s.notes, s.counters = [], {}, {}
        s.failed = 0
        gen.run(s, drain_s=args.drain)
        lat = np.asarray(s.latencies) * 1e3
        q = len(lat) // 4
        if not len(lat):
            print(json.dumps({"rate_qps": rate, "failed": s.failed}))
            break
        print(json.dumps({
            "rate_qps": rate, "answered_qps": s.notes["answered_qps"],
            "failed": s.failed, "dispatch_ms_p50": s.notes["dispatch_ms_p50"],
            "dispatch_ms_max": s.notes["dispatch_ms_max"],
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "p95_first_quarter_ms": float(np.percentile(lat[:q], 95)),
            "p95_last_quarter_ms": float(np.percentile(lat[-q:], 95)),
            "rows_per_dispatch": (s.counters["rows_served"]
                                  / max(1, s.counters["dispatches"])),
            "lateness_p99_ms": s.notes["lateness_p99_ms"]}), flush=True)
        if s.failed:
            break       # a backlog left over would load the next rate
    gen.stop(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
