"""The control of ``correct``: the reference put in the program's place,
one step below the stated precision, must come out not correct.

    python3 -m benchmark.control --workload sift1m.batch --seeds 1,2,3

For each seed it makes the cell's inputs as a run does, answers as many
queries as a run checks (the cell's sampled calls times the batch, or
for served traffic times the mean request) with ``reference.control_topk``
(the f32 ADC table's cross term at TF32 instead of full f32), and prints
the compared numbers beside the cell's limits, one JSON line a seed.
Needs the card, as a run does; ``benchmark/tests/test_bench_control.py``
holds the same at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import check, data, reference
from .run import load_spec


def control_numbers(spec: dict, seed: int, device) -> dict:
    cfg, traffic = spec["config"], spec["traffic"]
    k = traffic.get("top_k", cfg["k"])
    inputs = data.make_inputs(cfg, traffic, seed, device)
    calls = spec["cell"]["check"]["sample_calls"]
    per_call = traffic.get("batch") or float(np.mean(traffic["sizes"]))
    n = min(len(inputs["queries"]), int(calls * per_call))
    rng = np.random.default_rng([int(seed) % 2 ** 64, 31])
    rows = rng.choice(len(inputs["queries"]), n, replace=False)
    q = inputs["queries"][rows]
    d, i = reference.control_topk(inputs["codewords"], inputs["codes"], q,
                                  k, device)
    return check.compare(inputs["codewords"], inputs["codes"], q, d, i, k,
                         device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = load_spec(args.workload)
    limits = spec["cell"]["limits"]
    for seed in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        nums = control_numbers(spec, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": nums, "limits": limits,
                          "correct": check.verdict(nums, limits),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
