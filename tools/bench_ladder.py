"""Time the per-query ladder kernel beside the batch ladder it replaces on
the main path, on a benchmark cell's own index and queries.

    python3 tools/bench_ladder.py --workload sift1m.batch --seed 7 \\
        [--reps 50]

Builds the cell as ``benchmark.run`` does (its data, index and warm-up, a
1-s window), then on one batch of the cell's queries through the index's
engine times, each over ``--reps`` batches:

- ``ladder_ms``: ``fk.fused_ladder`` alone (the kernel), CUDA events, and
  ``plain_ladder_ms`` its plain version (``fused_ladder_ref``, a tenth of
  the batches);
- ``mins_ms``: the minima it takes (``fk.ladder_mins``, its kernel), and
  ``plain_mins_ms`` the plain version of the same (``pool_mins_nb``, a
  transposing copy, then scale2), CUDA events;
- ``per_query_select_ms``: the engine's ``select`` stage on the per-query
  route, host clock, synchronised;
- ``batch_select_ms``: the same stage with the route forced to the batch
  ladder (``fused_select_esc``: B2 ``csrc/rerank.cu`` a rung), host clock;
- the rungs, the status counts of the batch, ``ladder`` launches on the
  per-query route and ``rerank`` launches on the batch route.

Both stages' results are held equal (distances bit for bit).  Prints one
JSON line.  Card only.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import run as brun  # noqa: E402  (sets the host threads)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from deltapq_tpu_torch.kernels import build  # noqa: E402
from deltapq_tpu_torch.ops import fused as pfused  # noqa: E402
from deltapq_tpu_torch.ops import fused_kernels as fk  # noqa: E402


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _wall_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def measure(s, reps: int) -> dict:
    """The timings on one batch of the session's queries."""
    eng = s.index._fused_engine
    b = s.traffic["batch"]
    table, qop, uq, cert, bq = eng.prepare(s.queries[:b])
    q2, err_r, scale2 = cert
    mins, echo = eng.scan(qop, uq)
    pool, n_units, rungs = pfused.rung_plan(mins.shape[0], s.top_k,
                                            table.shape[0], eng.ns_hint)

    def plain_mins():
        m = fk.pool_mins_nb(mins, pool)
        return m * scale2 if scale2 is not None else m

    def ladder_mins():
        return fk.ladder_mins(mins, pool, scale2)

    mins_bn = ladder_mins()

    def ladder():
        return fk.fused_ladder(mins_bn, q2, table, echo, eng.n_valid,
                               s.top_k, rungs, pool, err_r=err_r,
                               row_to_db=eng.row_to_db)

    def plain_ladder():
        return fk.fused_ladder_ref(mins_bn, q2, table, echo, eng.n_valid,
                                   s.top_k, rungs, pool, err_r=err_r,
                                   row_to_db=eng.row_to_db)

    def select():
        return eng.select(table, cert, mins, echo, bq, s.top_k)

    build.reset_launch_counts()
    _, _, status = fk.ladder_views(ladder(), table.shape[0], s.top_k)
    st = status.cpu().numpy()
    d_pq, _ = select()
    launches = build.launch_counts()["ladder"]
    out = {"rungs": list(rungs), "pool": pool, "B": int(table.shape[0]),
           "top_k": s.top_k, "n_units": n_units,
           "status": {str(k): int(v) for k, v in
                      zip(*np.unique(st, return_counts=True))},
           "ladder_per_query_route": launches,
           "ladder_ms": _events_ms(ladder, reps),
           "plain_ladder_ms": _events_ms(plain_ladder, max(reps // 10, 1)),
           "mins_ms": _events_ms(ladder_mins, reps),
           "plain_mins_ms": _events_ms(plain_mins, reps),
           "per_query_select_ms": _wall_ms(select, reps)}
    route = pfused._per_query_route
    pfused._per_query_route = lambda *a: False
    try:
        build.reset_launch_counts()
        d_b, _ = select()
        out["rerank_batch_route"] = build.launch_counts()["rerank"]
        out["batch_select_ms"] = _wall_ms(select, reps)
    finally:
        pfused._per_query_route = route
    out["distances_equal"] = bool(torch.equal(d_pq, d_b))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = brun.load_spec(args.workload)
    gen = importlib.import_module(
        f"benchmark.generators.{spec['traffic']['kind']}")
    warmup, st = gen.warmup, {}

    def warmup_w(s):
        warmup(s)
        st["timings"] = measure(s, args.reps)

    gen.warmup = warmup_w
    try:
        out = brun.run_cell(args.workload, args.seed, 1.0, False,
                            torch.device("cuda", 0), spec)
    finally:
        gen.warmup = warmup
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "card": torch.cuda.get_device_name(0),
                      "correct": out["correct"], **st["timings"]}),
          flush=True)
    return 0 if st["timings"]["distances_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
