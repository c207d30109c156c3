"""Consolidated engine benchmark: every plain-scan engine on one card.

Usage:  python3 -m deltapq_tpu_torch.bench_engines [N] [B]

Counterpart of ``tools/bench_engines.py``: the same workload recipe
(seed 0: random codewords, ``synth.clustered_codes``, B random queries;
M=8, K=256, Ds=16, top-10), the same engines under the same names, one
line per engine with ms/batch and QPS.  A batch is the table build plus
the engine's scan and selection; batches are timed with CUDA events
around a synchronised run (the JAX tool's salted difference quotient
works around a dispatch cache this card does not have).  An engine that
fails, fails the run.

The tile-dictionary engine needs at most 64 distinct values per tile and
subspace.  On this unordered workload that does not hold, as in the JAX
tool, and its line says so.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import resolve_device
from .ops.adc import adc_query_topk, adc_table, pad_codes
from .ops.adc_kernels import (adc_dists_pallas, adc_topk_packed,
                              adc_topk_pallas, adc_topk_tiledict,
                              build_tile_dict)
from .ops.decoded import DecodedEngine, decoded_topk
from .ops.topk import smallest_k
from .synth import clustered_codes

M, K, DS, TOP_K = 8, 256, 16, 10
PAD = 65536


def workload(n: int, b: int, seed: int = 0
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(codewords f32 [M, K, Ds], codes u8 [n, M], queries f32 [b, D])
    from one generator, in the JAX tool's order."""
    rng = np.random.default_rng(seed)
    cw = rng.normal(size=(M, K, DS)).astype(np.float32)
    codes = clustered_codes(n, M, K, rng=rng)
    q = rng.normal(size=(b, M * DS)).astype(np.float32)
    return cw, codes, q


def cuda_ms(fn: Callable, reps: int) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls (warm)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def engines(cw: np.ndarray, codes_np: np.ndarray, device=None,
            all_modes: bool = False) -> Dict[str, Optional[Callable]]:
    """name -> query function (queries [B, D] on the device -> (dists,
    ids)), in the JAX tool's order.  The tile-dictionary entry is None
    when the dictionary does not fit the rows as they are ordered.
    ``all_modes`` adds the entry points the JAX
    tool leaves out: the distance matrix with ``smallest_k``, and the
    other precisions of the argmin and packed scans."""
    dev = resolve_device(device)
    n = len(codes_np)
    cwd = torch.from_numpy(cw).to(dev)
    codes = torch.from_numpy(pad_codes(codes_np, PAD)).to(dev)
    out: Dict[str, Optional[Callable]] = {}
    out["xla-gather"] = lambda q: adc_query_topk(
        adc_table(cwd, q), codes, n, TOP_K, PAD)
    out["pallas-argmin-f32"] = lambda q: adc_topk_pallas(
        adc_table(cwd, q), codes, n, TOP_K, 4096, "f32")
    out["pallas-packed-bf16x2"] = lambda q: adc_topk_packed(
        adc_table(cwd, q), codes, n, TOP_K, 4096, "bf16x2")
    if all_modes:
        out["dists-smallest_k"] = lambda q: smallest_k(
            adc_dists_pallas(adc_table(cwd, q), codes)[:, :n], TOP_K)
        for prec in ("bf16", "bf16x2"):
            out[f"pallas-argmin-{prec}"] = lambda q, prec=prec: \
                adc_topk_pallas(adc_table(cwd, q), codes, n, TOP_K, 4096,
                                prec)
        for prec in ("f32", "bf16"):
            out[f"pallas-packed-{prec}"] = lambda q, prec=prec: \
                adc_topk_packed(adc_table(cwd, q), codes, n, TOP_K, 4096,
                                prec)
    built = build_tile_dict(pad_codes(codes_np, PAD), tile_n=2048,
                            max_dict=64)
    out["pallas-tiledict-f32"] = None
    if built is not None:
        dicts, idx, width = built
        idx_d = torch.from_numpy(idx).to(dev)
        dicts_d = torch.from_numpy(dicts).to(dev)
        print(f"tiledict width: {width}", flush=True)
        out["pallas-tiledict-f32"] = lambda q: adc_topk_tiledict(
            adc_table(cwd, q), idx_d, dicts_d, codes, n, TOP_K, 2048)
    eng = DecodedEngine(cw, codes_np, device=dev)
    for prec, rr in (("bf16x2", True), ("bf16x2", False), ("bf16", False)):
        out[f"decoded-{prec}-rerank={rr}"] = (
            lambda q, prec=prec, rr=rr: decoded_topk(
                eng.xhat_hi, eng.xhat_lo, eng.precomp, adc_table(cwd, q),
                eng.codes, q, n, TOP_K, prec, False, rr))
    return out


def main(argv=None) -> Dict[str, float]:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 1_048_576
    b = int(argv[1]) if len(argv) > 1 else 128
    dev = resolve_device(None)
    cw, codes_np, q = workload(n, b)
    qd = torch.from_numpy(q).to(dev)
    print(f"{torch.cuda.get_device_name(dev)}: N={n}, B={b}, M={M}, K={K}, "
          f"top-{TOP_K}", flush=True)
    results = {}
    for name, fn in engines(cw, codes_np, dev).items():
        if fn is None:
            print(f"{name}: the tile dictionary does not fit this "
                  f"workload's row order (more than 64 distinct values in "
                  f"a tile's subspace); not run", flush=True)
            continue
        ms = cuda_ms(lambda: fn(qd), 3 if name == "xla-gather" else 6)
        results[name] = ms / 1e3
        print(f"{name}: {ms:.3f} ms/batch  QPS {b / ms * 1e3:.0f}",
              flush=True)
    return results


if __name__ == "__main__":
    main()
