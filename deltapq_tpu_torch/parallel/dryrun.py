"""A dry run of the multi-device layer at small sizes.

Counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``: the sharded plain query, the pipelined batch
stream, the sharded slot-tile engine, the dedup tier and the chunked
tier over the mesh, and one data-parallel Lloyd step, each checked
against its single-shard counterpart.

Usage: ``python3 -m deltapq_tpu_torch.parallel.dryrun [n_shards]`` (on
the card; ``dryrun_multichip(n, device="cpu")`` on the CPU).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..bigscale import ChunkedCompressedEngine
from ..ops.adc import adc_table, query_plain
from ..ops.fused import DedupCompressedEngine
from .fused_sharded import ShardedCompressedEngine
from .mesh import make_mesh, shard_rows
from .pipeline import make_pipelined_query_fn
from .sharded import make_dp_lloyd_step, make_sharded_query_fn


def _close(a, b, what):
    if not np.allclose(a, b, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"{what} differs from the single-shard result")


def dryrun_multichip(n_devices: int, device=None) -> str:
    """Every sharded path over ``make_mesh(n_devices, device=device)``;
    raises on a wrong result, returns the summary line it prints."""
    mesh = make_mesh(n_devices, device=device)
    dev0 = mesh.devices[0]
    rng = np.random.default_rng(0)
    M, K, Ds = 8, 16, 4
    B, top_k = 4, 3
    per_shard = 256
    N = per_shard * mesh.size

    # ---- sharded query step (codes split along the database axis) ----
    cw_np = rng.normal(size=(M, K, Ds)).astype(np.float32)
    codewords = torch.from_numpy(cw_np).to(dev0)
    queries = torch.from_numpy(
        rng.normal(size=(B, M * Ds)).astype(np.float32)).to(dev0)
    codes = rng.integers(0, K, size=(N, M)).astype(np.uint8)
    codes_sh = shard_rows(mesh, codes)
    qfn = make_sharded_query_fn(mesh, top_k, tile_n=per_shard)
    d, i = qfn(adc_table(codewords, queries), codes_sh, N)
    assert d.shape == (B, top_k) and i.shape == (B, top_k)
    ref = query_plain(cw_np, queries.cpu().numpy(), codes, top_k=top_k,
                      engine="xla", device=dev0)[0]
    _close(d.cpu().numpy(), ref, "the sharded query")

    # ---- pipelined batch stream (merge of batch i-1 beside batch i's
    # table build + scan) ----
    NB = 3
    qb = torch.from_numpy(
        rng.normal(size=(NB, B, M * Ds)).astype(np.float32)).to(dev0)
    pfn = make_pipelined_query_fn(mesh, top_k, tile_n=per_shard)
    pd, _ = pfn(codewords, qb, codes_sh, N)
    assert pd.shape == (NB, B, top_k)
    d0, _ = qfn(adc_table(codewords, qb[0]), codes_sh, N)
    _close(pd[0].cpu().numpy(), d0.cpu().numpy(), "pipelined batch 0")

    # ---- sharded slot-tile engine (tiles split on tile boundaries) ----
    n_rows = 1024 * mesh.size
    base_code = rng.integers(0, K, size=(1, M))
    codes_scan = np.repeat(base_code, n_rows, axis=0).astype(np.uint8)
    flip = rng.integers(0, M, size=n_rows)
    codes_scan[np.arange(n_rows), flip] = rng.integers(0, K, size=n_rows)
    qsmall = rng.normal(size=(4, M * Ds)).astype(np.float32)
    sd, _ = ShardedCompressedEngine(cw_np, codes_scan, mesh).query(
        qsmall, top_k=3)
    scan_ref, _ = query_plain(cw_np, qsmall, codes_scan, top_k=3,
                              engine="xla", device=dev0)
    _close(sd, scan_ref, "the sharded slot-tile engine")

    # ---- dedup tier over the mesh: distinct codes sharded, row
    # expansion on the host ----
    distinct = rng.integers(0, K, size=(128, M)).astype(np.uint8)
    codes_dup = distinct[rng.integers(0, 128, size=512 * mesh.size)]
    dd_eng = DedupCompressedEngine(cw_np, codes_dup, mesh=mesh)
    assert dd_eng.n_unique <= 128
    dd, _ = dd_eng.query(qsmall, top_k=3)
    _close(dd, query_plain(cw_np, qsmall, codes_dup, top_k=3, engine="xla",
                           device=dev0)[0], "the sharded dedup tier")

    # ---- chunked tier over the mesh: each chunk's tiles sharded,
    # chunks merged on the host ----
    ch_eng = ChunkedCompressedEngine(cw_np, codes_scan, chunk_rows=1024,
                                     mesh=mesh)
    assert len(ch_eng.chunks) >= 2
    cd, _ = ch_eng.query(qsmall, top_k=3)
    _close(cd, scan_ref, "the sharded chunked tier")

    # ---- data-parallel training step (Lloyd update, summed) ----
    n_train = 64 * mesh.size
    x = rng.normal(size=(M, n_train, Ds)).astype(np.float32)
    centers = x[:, :K, :].copy()
    step = make_dp_lloyd_step(mesh)
    new_c, distortion = step(shard_rows(mesh, x, dim=1),
                             torch.from_numpy(centers))
    one = make_dp_lloyd_step(make_mesh(1, devices=[dev0]))
    ref_c, ref_dist = one([torch.from_numpy(x).to(dev0)],
                          torch.from_numpy(centers))
    _close(new_c.cpu().numpy(), ref_c.cpu().numpy(), "the DP Lloyd step")
    assert new_c.shape == (M, K, Ds) and np.isfinite(float(distortion))
    line = (f"dryrun_multichip({mesh.size}) on {dev0}: sharded query + "
            f"pipelined batch stream + sharded slot-tile engine + sharded "
            f"dedup tier + sharded chunked tier + DP Lloyd step OK "
            f"(distortion={float(distortion):.3f}, single shard "
            f"{float(ref_dist):.3f})")
    print(line)
    return line


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
