"""The port's multi-device layer across every card of one host: a check
that needs two or more cards, beside ``chip_smoke.py``, which needs one.

First one process over all the cards (``make_mesh()``: a shard a card),
then one NCCL process a card (``init_distributed``, world = the card
count, each process a one-shard mesh of its card).  On N=1,048,576
delta-compressible random codes (M=8, K=256, Ds=16; B=512, top-10) the
sharded slot-tile engine (timed), the sharded plain, pipelined and
decoded queries and the DP Lloyd step each answer exactly as the exact
scan, or as the same mesh's shards run on one card.  Raises on any
difference.

Usage: ``python3 multicard_check.py`` from the repository root, on a
host with two or more cards.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from deltapq_tpu_torch.kernels import build
from deltapq_tpu_torch.ops.adc import adc_query_topk, adc_table, pad_codes
from deltapq_tpu_torch.parallel.dryrun import dryrun_multichip
from deltapq_tpu_torch.parallel.fused_sharded import ShardedCompressedEngine
from deltapq_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_rows
from deltapq_tpu_torch.parallel.pipeline import pipelined_query
from deltapq_tpu_torch.parallel.runtime import init_distributed
from deltapq_tpu_torch.parallel.sharded import (
    make_dp_lloyd_step, sharded_query_decoded, sharded_query_plain)

M, K, DS, N, B, TOP_K, N_BATCHES = 8, 256, 16, 1 << 20, 512, 10, 5


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def workload():
    """Codebook, codes (repeated rows and sparse flips), their lexsort
    order, four batches of queries near database rows; from seed 0."""
    rng = np.random.default_rng(0)
    cw = (rng.normal(size=(M, K, DS)) * 3).astype(np.float32)
    base = rng.integers(0, K, size=(N, M))
    codes = np.repeat(base, rng.integers(1, 6, size=N), axis=0)[:N]
    flip = rng.random(codes.shape) < 0.15
    codes = np.where(flip, rng.integers(0, K, codes.shape), codes
                     ).astype(np.uint8)
    rows = codes[rng.integers(0, N, 4 * B)]
    q = (np.concatenate([cw[m][rows[:, m]] for m in range(M)], 1)
         + rng.normal(size=(4 * B, M * DS)).astype(np.float32))
    return cw, codes, np.lexsort(codes.T[::-1]), q


def exact_dists(cw, codes, q, dev) -> np.ndarray:
    table = adc_table(torch.from_numpy(cw).to(dev),
                      torch.from_numpy(q).to(dev))
    c = torch.from_numpy(pad_codes(codes, 16384)).to(dev)
    return adc_query_topk(table, c, len(codes), TOP_K, 16384)[0].cpu().numpy()


def lloyd_input():
    return np.random.default_rng(1).normal(size=(M, 20000, DS)).astype(
        np.float32)


def one_process(cards: int) -> None:
    cw, codes, order, q = workload()
    dev0 = torch.device("cuda", 0)
    mesh = make_mesh()
    check(len(set(mesh.devices)) == cards, f"mesh {mesh.devices}")
    ref = exact_dists(cw, codes, q[:B], dev0)
    e = ShardedCompressedEngine(cw, codes[order], mesh, row_to_db=order)
    e.warmup(batch_sizes=(B,), top_k=TOP_K)
    build.reset_launch_counts()
    walls = []
    for _ in range(N_BATCHES):
        torch.cuda.synchronize()
        t = time.perf_counter()
        d, _ = e.query(q[:B], top_k=TOP_K)
        walls.append(time.perf_counter() - t)
        check(np.array_equal(d, ref), "the sharded engine is not exact")
    c = build.launch_counts()
    check(c["delta_mins_bf16"] == cards * N_BATCHES
          and c["rerank"] >= cards * N_BATCHES, f"launches {c}")
    wall = float(np.mean(walls))
    print(f"one process, {cards} cards: ShardedCompressedEngine bf16, "
          f"{N_BATCHES} batches of B={B}: host wall {wall * 1e3:.4f} "
          f"ms/batch -> {B / wall:.1f} QPS, first-shot "
          f"{e.last_exact_frac:.4f}, launches B5 {c['delta_mins_bf16']} / "
          f"B2 {c['rerank']}; distances bit-equal to adc_query_topk",
          flush=True)
    d, _ = sharded_query_plain(cw, q[:B], codes, mesh=mesh)
    check(np.array_equal(d, ref), "sharded_query_plain")
    pd, pi = pipelined_query(cw, q, codes, mesh, top_k=TOP_K, batch_size=B)
    for b0 in range(0, 4 * B, B):
        sd, si = sharded_query_plain(cw, q[b0:b0 + B], codes, mesh=mesh)
        check(np.array_equal(pd[b0:b0 + B], sd)
              and np.array_equal(pi[b0:b0 + B], si), "pipelined_query")
    d, _ = sharded_query_decoded(cw, q[:B], codes, mesh=mesh)
    check(np.array_equal(d, ref), "sharded_query_decoded")
    x = lloyd_input()
    _, dist = make_dp_lloyd_step(mesh)(shard_rows(mesh, x, dim=1),
                                       torch.from_numpy(cw))
    _, dist1 = make_dp_lloyd_step(make_mesh(1, devices=[dev0]))(
        [torch.from_numpy(x).to(dev0)], torch.from_numpy(cw))
    check(abs(float(dist) - float(dist1)) <= 1e-5 * abs(float(dist1)),
          "DP Lloyd distortion")
    print(f"one process, {cards} cards: sharded plain, pipelined and "
          f"decoded queries bit-equal to adc_query_topk; DP Lloyd "
          f"distortion {float(dist):.6g} (one card {float(dist1):.6g})",
          flush=True)
    dryrun_multichip(cards)


def worker(rank: int, world: int, port: int) -> None:
    """One NCCL process of one card: its one-shard mesh spans the world;
    every result equals the same shards run on its card alone."""
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    check(init_distributed(f"127.0.0.1:{port}", world, rank,
                           device=dev) == world, "world size")
    try:
        cw, codes, order, q = workload()
        mesh = make_mesh(1, device=dev)
        alone = Mesh(devices=(dev,) * mesh.size)
        check(mesh.size == world and mesh.group is not None, "mesh")

        def results(m):
            c, dist = make_dp_lloyd_step(m)(
                shard_rows(m, lloyd_input(), dim=1), torch.from_numpy(cw))
            return (*sharded_query_plain(cw, q[:B], codes, mesh=m),
                    *ShardedCompressedEngine(cw, codes[order], m,
                                             row_to_db=order).query(q[:B]),
                    c.cpu().numpy(), dist.cpu().numpy())

        got, one_card = results(mesh), results(alone)
        check(all(np.array_equal(a, b) for a, b in zip(got, one_card)),
              "a world result differs from the one-card result")
        check(np.array_equal(got[2], exact_dists(cw, codes, q[:B], dev)),
              "the sharded engine is not exact")
    finally:
        torch.distributed.destroy_process_group()
    print(f"rank {rank} of {world} (NCCL): sharded plain query, sharded "
          f"engine and DP Lloyd step equal to the same {world} shards on "
          f"one card; the engine bit-equal to adc_query_topk", flush=True)


def main() -> int:
    cards = torch.cuda.device_count()
    check(cards >= 2, f"{cards} cards: this check needs two or more")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t = time.perf_counter()
    build.build(force=True)
    build.library()
    print(f"kernel build {time.perf_counter() - t:.1f} s", flush=True)
    one_process(cards)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(cards),
         str(port)], cwd=os.path.dirname(os.path.abspath(__file__)))
        for r in range(cards)]
    try:
        rcs = [p.wait(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(rcs == [0] * cards, f"worker exit codes {rcs}")
    print(f"multicard_check: {cards} cards OK", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        worker(*(int(a) for a in sys.argv[1:4]))
        sys.exit(0)
    sys.exit(main())
