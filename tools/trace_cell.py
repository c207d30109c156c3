"""Run one benchmark cell with the port's spans on, and read them.

    python3 tools/trace_cell.py --workload sift1m.batch --seed 7 \\
        --seconds 40 [--spans 0] [--profile 2]

Runs ``benchmark.run.run_cell`` untraced on the card, as ``python3 -m
benchmark.run --trace 0`` does, with ``deltapq_tpu_torch.tracing``
enabled before the index is built (``--spans 0`` leaves it off: the
untraced rate of the same process).  It wraps only the generator's
``warmup`` and ``run``: the registry's snapshot after warm-up holds the
set-up spans (``run_cell`` resets the registry before the window), the
one at the window's end the window's.  ``--profile S`` then runs S more
seconds of the same batches through the index under ``torch.profiler``,
spans on, and labels the card's ten longest idle gaps there with the
innermost program span over each (``benchmark.tracing.summarize`` over
the program's ranges alone).  Standard output: the result line as
``benchmark.run`` prints it, then one JSON object ``spans``:

- ``setup``: ``tree_edges_s``, ``tree_layout_s``, ``tree_serialize_s``
  (the ``index.build.*`` spans), ``engine_tiles_s`` (``engine.build``),
  ``edge_combos`` (the counter: combinations the edge search drew),
  and the harness's ``index_build_s`` and ``setup_s``;
- ``window``: calls, seconds, queries a second, the mean call wall, and
  per batch ``facade_ms`` (``index.search``'s self time and
  ``index.finish``), ``prepare_ms``, ``scan_ms``, ``select_host_ms``
  (the ``engine.select`` subtree less its waits: ``engine.ladder`` on the
  per-query ladder, ``engine.rung`` on the batch ladder), ``device_wait_ms``
  (every ``engine.wait``), ``query_self_ms``, ``sum_self_ms`` (every
  span's self time), the counters a batch and ``first_shot_share``;
- ``profile``: its calls, seconds, queries a second and labelled gaps;
- ``snapshot``: the window's whole snapshot.
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
from benchmark import tracing as btracing  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from deltapq_tpu_torch import tracing  # noqa: E402

PROGRAM_SPANS = ("index.search", "index.finish", "engine.query",
                 "engine.prepare", "engine.scan", "engine.select",
                 "engine.ladder", "engine.rung", "engine.terminal",
                 "engine.wait")


def per_batch(snap: dict, calls: int) -> dict:
    """The per-batch span and counter numbers of a snapshot over
    ``calls`` batches."""
    sp = snap["spans"]

    def total(n):
        return sp.get(n, (0, 0.0, 0.0))[1]

    def own(n):
        return sp.get(n, (0, 0.0, 0.0))[2]

    ms = 1e3 / max(calls, 1)
    out = {"facade_ms": (own("index.search") + total("index.finish")) * ms,
           "prepare_ms": total("engine.prepare") * ms,
           "scan_ms": total("engine.scan") * ms,
           "select_host_ms": (own("engine.select") + own("engine.ladder")
                              + own("engine.rung")
                              + own("engine.terminal")) * ms,
           "device_wait_ms": total("engine.wait") * ms,
           "query_self_ms": own("engine.query") * ms,
           "sum_self_ms": sum(own(n) for n in PROGRAM_SPANS) * ms}
    c = snap["counters"]
    for k in ("h2d_bytes", "rungs", "rung_rows", "terminal_scans",
              "real_rows", "first_shot_rows"):
        out[f"{k}_per_batch"] = c.get(k, 0) / max(calls, 1)
    if c.get("real_rows"):
        out["first_shot_share"] = 100.0 * c.get("first_shot_rows", 0) \
            / c["real_rows"]
    return out


def profile(s, seconds: float) -> dict:
    """``seconds`` of the window's batches through ``s.index`` under
    ``torch.profiler``, spans on: the rate and the labelled idle gaps."""
    b, nq = s.traffic["batch"], len(s.queries)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if s.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    tracing.enable()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(btracing.SLICE):
            t0, i = time.perf_counter(), 0
            while time.perf_counter() - t0 < seconds:
                s.index.search(s.queries[(np.arange(b) + i * b) % nq],
                               top_k=s.top_k)
                i += 1
            if s.device.type == "cuda":
                torch.cuda.synchronize(s.device)
            secs = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name, e.device_type == cuda, float(e.time_range.start),
               float(e.time_range.end)) for e in prof.events()]
    tr = btracing.summarize(
        e for e in events
        if (e[1] and not e[0].startswith(btracing.SPANS))
        or (not e[1] and (e[0] == btracing.SLICE
                          or e[0].startswith(("index.", "engine.")))))
    return {"calls": i, "seconds": secs, "qps": i * b / secs,
            "idle_share": 100.0 * (1 - tr.busy_s / tr.window_s),
            "gaps": [[lab, sec] for sec, lab in tr.gaps]}


def main(argv=None, device=None, spec=None) -> int:
    """``device`` and ``spec`` (a cut-down cell) serve a rehearsal on the
    CPU; by default the cell runs as declared, on the card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--profile", type=float, default=0.0)
    args = ap.parse_args(argv)
    spec = spec or brun.load_spec(args.workload)
    gen = importlib.import_module(
        f"benchmark.generators.{spec['traffic']['kind']}")
    st = {}
    warmup, run = gen.warmup, gen.run

    def warmup_w(s):
        warmup(s)
        snap = tracing.snapshot()
        st["setup"], st["edge_combos"] = (
            snap["spans"], snap["counters"].get("edge_combos"))

    def run_w(s):
        run(s)
        st["window"], st["session"] = tracing.snapshot(), s
        if args.profile > 0:
            st["profile"] = profile(s, args.profile)

    if device is None:
        if not torch.cuda.is_available():
            print("needs a CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    gen.warmup, gen.run = warmup_w, run_w
    if args.spans:
        tracing.enable()
    try:
        out = brun.run_cell(args.workload, args.seed, args.seconds, False,
                            device, spec)
    finally:
        tracing.disable()
        gen.warmup, gen.run = warmup, run
    s, setup = st["session"], st["setup"]
    b = spec["traffic"]["batch"]

    def setup_s(name):
        return setup.get(name, (0, 0.0))[1]

    res = {"setup": {"tree_edges_s": setup_s("index.build.edges"),
                     "tree_layout_s": setup_s("index.build.layout"),
                     "tree_serialize_s": setup_s("index.build.serialize"),
                     "engine_tiles_s": setup_s("engine.build"),
                     "edge_combos": st["edge_combos"],
                     "index_build_s": s.index_build_s,
                     "setup_s": s.setup_s},
           "window": dict(calls=s.calls, seconds=s.window_s,
                          qps=s.calls * b / s.window_s,
                          call_wall_ms=1e3 * float(np.mean(s.latencies)),
                          **per_batch(st["window"], s.calls)),
           "profile": st.get("profile"), "snapshot": st["window"],
           "spans_on": bool(args.spans)}
    print(json.dumps(out), flush=True)
    print(json.dumps({"spans": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
