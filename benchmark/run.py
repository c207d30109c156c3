"""Run one cell of the benchmark once, on one card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs on the card from ``--seed``
(``data.make_inputs``), builds ``DeltaPQIndex(codewords, codes)`` and warms
up every shape the traffic uses.  The window then drives the traffic's
generator for ``--seconds``.  After it closes the program's state is
freed and a sample of the answers, drawn from the seed, is held to the
plain reference (``check.py``).  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones, each
read by ``metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit, which also end standard error.

The process keeps to one host thread in NumPy's and torch's CPU pools, so
that a run's host work does not depend on how busy the host's other cores
are.  Without a CUDA device, or with fewer than the cell asks for, it
prints no result and exits 2.  If ``jax``, ``jaxlib``, ``flax`` or ``deltapq_tpu``
is loaded when the window has closed, it names them and exits 3.
"""

from __future__ import annotations

import os

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"      # before NumPy and torch start their pools

import argparse
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, data
from .tracing import Tracer, span, wrap_method


def _process_start() -> float:
    """``time.perf_counter()`` at this process's start (from /proc), or
    now where /proc is not there."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


PROC_START = _process_start()
HERE = Path(__file__).resolve().parent
BENCHMARK_JSON = HERE.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "deltapq_tpu")
#: the profiled slice of a traced run: from this share of the window, for
#: at most TRACE_S seconds and at most this share of the window
TRACE_START, TRACE_SHARE, TRACE_S = 0.3, 0.4, 2.0


def load(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell_spec(entry: dict, end_to_end=(), per_layer=()) -> dict:
    """A cell's spec from its entry (``name``, ``config``, ``traffic``)
    and the metrics it reports, with its configuration, traffic and cell
    files."""
    return {"entry": entry,
            "config": load("configs", entry["config"]),
            "traffic": load("traffic", entry["traffic"]),
            "cell": load("workloads", entry["name"]),
            "end_to_end": list(end_to_end), "per_layer": list(per_layer)}


def load_spec(cell: str) -> dict:
    """A cell's spec as ``BENCHMARK.json`` declares it."""
    with open(BENCHMARK_JSON) as f:
        bench = json.load(f)
    entry = {w["name"]: w for w in bench["workloads"]}.get(cell)
    if entry is None:
        raise SystemExit(f"no workload {cell!r} in {BENCHMARK_JSON.name}")
    return cell_spec(
        entry, [m for m in bench["end_to_end"] if _applies(m, cell)],
        [m for m in bench["per_layer"] if _applies(m, cell)])


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "benchmark.metrics." + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Session:
    """One run: the program under test, the traffic, what the window
    recorded and the sample of answers kept for the check."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool,
                 device: torch.device):
        self.spec = spec
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.top_k = self.traffic.get("top_k", self.config["k"])
        self.seed, self.seconds, self.traced = seed, seconds, trace
        self.device = device
        self.tracer = Tracer(trace, TRACE_START * seconds,
                             min(TRACE_S, TRACE_SHARE * seconds), device)
        self.index = None
        self.server = None
        self.futures: list = []
        self.queries: Optional[np.ndarray] = None
        self.latencies: List[float] = []
        self.attempted = self.failed = self.calls = 0
        self.window_start = self.window_s = 0.0
        self.setup_s = self.index_build_s = 0.0
        self.resident_bytes = 0
        self.n_rows = 0
        self.counters: Dict[str, float] = {}
        self.notes: Dict[str, object] = {}
        self._sample: list = []
        self._seen = 0
        self._rng = np.random.default_rng([int(seed) % 2 ** 64, 29])
        self.sample_calls = int(spec["cell"]["check"]["sample_calls"])

    clock = staticmethod(time.perf_counter)

    @property
    def trace(self):
        return self.tracer.trace

    def search_k(self, q: np.ndarray, k: int):
        with span("index.search", self.traced):
            return self.index.search(q, top_k=k)

    def search(self, q: np.ndarray):
        return self.search_k(q, self.top_k)

    def offer_sample(self, rows: np.ndarray, answer) -> None:
        """Reservoir sample over the window's calls (drawn from the
        seed): ``answer`` is (dists, ids) or a future of them."""
        if self._seen < self.sample_calls:
            self._sample.append((rows, answer))
        else:
            j = int(self._rng.integers(0, self._seen + 1))
            if j < self.sample_calls:
                self._sample[j] = (rows, answer)
        self._seen += 1

    def sampled_answers(self):
        """(query rows [Q], dists [Q, k], ids [Q, k]) of the sample's
        answered calls."""
        rows, ds, ids = [], [], []
        for r, a in self._sample:
            if hasattr(a, "result"):
                if (a.cancelled() or not a.done()
                        or a.exception() is not None):
                    continue
                a = a.result()
            rows.append(r)
            ds.append(a[0])
            ids.append(a[1])
        return np.concatenate(rows), np.concatenate(ds), np.concatenate(ids)


#: the engine tensors a compressed scan streams: its tiles
STREAM_TENSORS = ("row_data", "vals", "meta", "ovf")


def device_tensors(obj, prefix: str = "", depth: int = 2) -> Dict[str, int]:
    """Bytes of each device tensor an object holds in its attributes,
    looked for ``depth`` objects deep, largest first."""
    out: Dict[str, int] = {}
    for k, v in vars(obj).items():
        items = (enumerate(v) if isinstance(v, (tuple, list))
                 else [(None, v)])
        for i, t in items:
            name = prefix + k + ("" if i is None else f"[{i}]")
            if isinstance(t, torch.Tensor):
                if t.device.type != "cpu":
                    out[name] = t.numel() * t.element_size()
            elif (depth > 1 and hasattr(t, "__dict__")
                  and not isinstance(t, type)):
                out.update(device_tensors(t, name + ".", depth - 1))
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mem(device) -> int:
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def _gpu_info(device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        return out[device.index or 0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             spec: Optional[dict] = None) -> dict:
    """One run of ``cell``; returns the result line's object."""
    from deltapq_tpu_torch.index import DeltaPQIndex
    from deltapq_tpu_torch.kernels import build

    device = torch.device(device)
    spec = spec or load_spec(cell)
    gen = importlib.import_module(
        f"benchmark.generators.{spec['traffic']['kind']}")
    s = Session(spec, seed, seconds, trace, device)
    cfg = s.config

    t = time.perf_counter()
    inputs = data.make_inputs(cfg, s.traffic, seed, device)
    s.queries = inputs["queries"]
    s.n_rows = len(inputs["codes"])
    t_data = time.perf_counter() - t
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    mem0 = _mem(device)

    t = time.perf_counter()
    s.index = DeltaPQIndex(inputs["codewords"], inputs["codes"],
                           engine=cfg["engine"], device=device)
    s.index_build_s = time.perf_counter() - t
    t = time.perf_counter()
    gen.warmup(s)
    s.tracer.prime()
    _sync(device)
    t_warm = time.perf_counter() - t
    s.resident_bytes = _mem(device) - mem0
    engine = s.index._fused_engine
    held = device_tensors(s.index)
    s.counters["scan_stream_bytes"] = sum(
        held.get(f"_fused_engine.{n}", 0) for n in STREAM_TENSORS)
    log("resident by tensor (B): " + json.dumps(held))
    if trace and engine is not None:
        for stage in ("prepare", "scan", "select"):
            wrap_method(engine, stage, f"engine.{stage}")
    build.reset_launch_counts()

    gen.run(s)
    s.setup_s = s.window_start - PROC_START
    s.counters["launches"] = build.launch_counts()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"set-up {s.setup_s:.3f} s: inputs {t_data:.3f}, index "
        f"{s.index_build_s:.3f}, warm-up {t_warm:.3f}; engine "
        f"{s.index._engine_resolved or cfg['engine']}; first-shot "
        f"{getattr(engine, 'last_exact_frac', None)}; ns_hint "
        f"{getattr(engine, 'ns_hint', None)}")
    if s.notes:
        log("window: " + json.dumps(s.notes))

    # the program's state goes before the reference runs
    if s.server is not None:
        gen.stop(s)
    rows, d_got, i_got = s.sampled_answers()
    s.index = s.server = engine = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = check.compare(inputs["codewords"], inputs["codes"],
                            s.queries[rows], d_got, i_got, s.top_k, device)
    limits = spec["cell"]["limits"]
    correct = check.verdict(numbers, limits) and s.failed == 0
    log(f"checked {len(rows)} queries of {len(s._sample)} sampled calls")

    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        v = reader(m["name"])(s)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(spec["entry"].get("chips", 1)),
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(s.attempted),
           "failed": int(s.failed), "metrics": metrics, "device": dev}
    if trace:
        tr = s.trace
        dev["busy_s"] = tr.busy_s if tr else 0.0
        dev["window_s"] = tr.window_s if tr else 0.0
        if tr is not None:
            ops = sorted(tr.device_ops.items(), key=lambda kv: -kv[1][0])
            out["breakdown"] = {
                "device_ops": [[n, v[0]] for n, v in ops[:10]],
                "idle_gaps": [[n, sec] for sec, n in tr.gaps[:10]]}
            log(f"trace: {tr.calls} calls in {tr.window_s:.4f} s, device "
                f"busy {tr.busy_s:.4f} s, {len(tr.device_ops)} device ops, "
                f"read in {s.tracer.read_s:.2f} s")
    log(f"card: {_gpu_info(device)}")
    out["checks"] = {n: {"value": numbers[n], "limit": limits[n]}
                     for n in check.NUMBERS}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)
    chips = int(spec["entry"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), spec)
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & set(FORBIDDEN))
    if found:
        log(f"loaded in the measuring process: {', '.join(found)}")
        return 3
    for n, c in out["checks"].items():
        log(f"{n} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
