"""The port's multi-device layer (``deltapq_tpu_torch/parallel``) against
the JAX package's, on the same NumPy inputs.

The JAX side runs on the 8-device CPU mesh of ``tests/conftest.py``,
its Pallas kernels in interpret mode as ``tests/test_sharded.py`` runs
them; the port's side on meshes of repeated CPU shards
(``make_mesh(S, device="cpu")``), its kernels through their plain
versions.  Distances: rtol 1e-5, atol 1e-4 against JAX (table ulps
between the frameworks' f32 matmuls), bit-equal to the port's own exact
scan where the port is exact; ids equal up to f64-audited ties.

Run as a script (``python tests/test_torch_parallel.py RANK WORLD
PORT``), this file is the worker of the two-process gloo test: two
processes with two CPU shards each form one 4-shard mesh.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from deltapq_tpu_torch.ops.adc import (adc_query_topk, adc_table,  # noqa: E402
                                       pad_codes, query_plain)
from deltapq_tpu_torch.parallel import (  # noqa: E402
    ShardedCompressedEngine, init_distributed, make_dp_lloyd_step,
    make_mesh, pad_to_shards, pipelined_query, replicated, shard_rows,
    sharded_query_decoded, sharded_query_plain)
from deltapq_tpu_torch.parallel.mesh import Mesh  # noqa: E402

M, K, DS = 8, 16, 4
N, B, TOPK = 6000, 32, 10
CPU = "cpu"


def _inputs(seed=7, n=N, b=B):
    """Codebook, delta-compressible codes (repeated rows and sparse
    flips) and queries near database rows, from a seed."""
    rng = np.random.default_rng(seed)
    cw = (rng.normal(size=(M, K, DS)) * 3 + 1).astype(np.float32)
    base = rng.integers(0, K, size=(n, M))
    codes = np.repeat(base, rng.integers(1, 6, size=n), axis=0)[:n]
    flip = rng.random(codes.shape) < 0.15
    codes = np.where(flip, rng.integers(0, K, codes.shape), codes
                     ).astype(np.uint8)
    rows = codes[rng.integers(0, n, b)]
    q = (np.concatenate([cw[m][rows[:, m]] for m in range(M)], 1)
         + rng.normal(size=(b, M * DS)).astype(np.float32))
    return cw, codes, q


def _exact(cw, codes, q, top_k=TOPK):
    """The port's exact scan over the same table: (dists, ids)."""
    table = adc_table(torch.from_numpy(cw), torch.from_numpy(q))
    c = torch.from_numpy(pad_codes(codes, 1024))
    d, i = adc_query_topk(table, c, len(codes), top_k, 1024)
    return d.numpy(), i.numpy()


def _worker(rank: int, world: int, port: int) -> None:
    """One process of the gloo test: init_distributed, a 4-shard mesh of
    two local CPU shards a process, and three sharded paths, each equal
    to the same path on a single-process 4-shard mesh."""
    torch.set_num_threads(1)
    assert init_distributed(f"127.0.0.1:{port}", world, rank,
                            device=CPU) == world
    mesh = make_mesh(2, device=CPU)
    assert mesh.size == 2 * world and mesh.group is not None
    alone = Mesh(devices=(torch.device(CPU),) * mesh.size)
    cw, codes, q = _inputs(n=3000, b=8)

    d, i = sharded_query_plain(cw, q, codes, top_k=5, mesh=mesh, tile_n=256)
    d1, i1 = sharded_query_plain(cw, q, codes, top_k=5, mesh=alone,
                                 tile_n=256)
    assert np.array_equal(d, d1) and np.array_equal(i, i1)
    assert np.array_equal(d, _exact(cw, codes, q, 5)[0])

    rng = np.random.default_rng(1)
    x = rng.normal(size=(M, 512, DS)).astype(np.float32)
    centers = torch.from_numpy(rng.normal(size=(M, K, DS)).astype(
        np.float32))
    c, dist = make_dp_lloyd_step(mesh)(shard_rows(mesh, x, dim=1), centers)
    c1, dist1 = make_dp_lloyd_step(alone)(shard_rows(alone, x, dim=1),
                                          centers)
    assert torch.equal(c, c1) and torch.equal(dist, dist1)

    order = np.lexsort(codes.T[::-1])
    e = ShardedCompressedEngine(cw, codes[order], mesh, row_to_db=order)
    e1 = ShardedCompressedEngine(cw, codes[order], alone, row_to_db=order)
    d, i = e.query(q, top_k=5)
    d1, i1 = e1.query(q, top_k=5)
    assert np.array_equal(d, d1) and np.array_equal(i, i1)
    assert e.last_exact_frac == e1.last_exact_frac
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: OK", flush=True)


if __name__ == "__main__":
    _worker(*(int(a) for a in sys.argv[1:4]))
    sys.exit(0)

# the test functions below compare with the JAX package; the worker above
# runs without it
import jax  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from deltapq_tpu import bigscale as jbig  # noqa: E402
from deltapq_tpu import cli as jcli  # noqa: E402
from deltapq_tpu.ops import fused as jfused  # noqa: E402
from deltapq_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from deltapq_tpu.parallel import \
    pad_to_shards as j_pad_to_shards  # noqa: E402
from deltapq_tpu.parallel import sharded as jsharded  # noqa: E402
from deltapq_tpu.parallel.fused_sharded import \
    ShardedCompressedEngine as JShardedEngine  # noqa: E402
from deltapq_tpu.parallel.pipeline import \
    pipelined_query as j_pipelined  # noqa: E402
from deltapq_tpu.parallel.sharded_tree import (  # noqa: E402
    build_sharded_pack as j_build_pack,
    build_sharded_trees as j_build_trees,
    sharded_query_compressed as j_sq_compressed)
from deltapq_tpu_torch import bigscale as pbig  # noqa: E402
from deltapq_tpu_torch import cli as pcli  # noqa: E402
from deltapq_tpu_torch.io import (write_codes, write_codewords,  # noqa: E402
                                  write_vecs)
from deltapq_tpu_torch.ops.fused import DedupCompressedEngine  # noqa: E402
from deltapq_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from deltapq_tpu_torch.parallel.sharded_tree import (  # noqa: E402
    build_sharded_pack, build_sharded_trees, sharded_query_compressed)
from deltapq_tpu_torch.profiling import Metrics  # noqa: E402

from _torch_port import assert_ids_up_to_ties  # noqa: E402

SHARDS = [2, 4]


@pytest.fixture(scope="module")
def data():
    cw, codes, q = _inputs()
    table = adc_table(torch.from_numpy(cw), torch.from_numpy(q)).numpy()
    return dict(cw=cw, codes=codes, q=q, table=table,
                exact=_exact(cw, codes, q))


def _check(data, d, i, jd=None, ji=None, codes=None, table=None,
           top_k=TOPK):
    """Distances bit-equal to the port's exact scan; against the JAX
    results (when given) rtol 1e-5, atol 1e-4; ids up to f64 ties."""
    codes = data["codes"] if codes is None else codes
    table = data["table"] if table is None else table
    ed, ei = (data["exact"] if codes is data["codes"] and top_k == TOPK
              else _exact(data["cw"], codes, data["q"], top_k))
    assert np.array_equal(d, ed)
    assert_ids_up_to_ties(table, codes, i, ei, top_k)
    if jd is not None:
        np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-5, atol=1e-4)
        assert_ids_up_to_ties(table, codes, i, np.asarray(ji), top_k)


def test_make_mesh_places_shards_round_robin():
    m = make_mesh(4, device=CPU)
    assert m.devices == (torch.device(CPU),) * 4 and m.size == 4
    assert m.shard_ids() == [0, 1, 2, 3] and m.group is None
    assert m.axis_names == ("shard",)
    m = make_mesh(3, devices=["cpu", "meta"], axis_name="rows")
    assert [d.type for d in m.devices] == ["cpu", "meta", "cpu"]
    assert m.axis_names == ("rows",)
    assert make_mesh(device=CPU).devices == (torch.device(CPU),)
    # the card by default, not probed: cuda:0 without one
    assert make_mesh(2).devices[0].type == "cuda"
    with pytest.raises(ValueError):
        make_mesh(0, device=CPU)


def test_shard_rows_replicated_and_padding():
    mesh = make_mesh(4, device=CPU)
    x = np.arange(30).reshape(10, 3)
    xp = pad_to_shards(x, 4, fill=-1)
    assert np.array_equal(xp, j_pad_to_shards(x, 4, fill=-1))
    parts = shard_rows(mesh, xp)
    assert [p.shape for p in parts] == [(3, 3)] * 4
    assert np.array_equal(torch.cat(parts).numpy(), xp)
    cols = shard_rows(mesh, np.zeros((2, 8, 5)), dim=1)
    assert [p.shape for p in cols] == [(2, 2, 5)] * 4
    with pytest.raises(ValueError, match="pad"):
        shard_rows(mesh, x)
    reps = replicated(mesh, x)
    assert len(reps) == 4 and all(r is reps[0] for r in reps)


def test_init_distributed_without_a_group():
    assert init_distributed() == 1
    with pytest.raises(ValueError):
        init_distributed("127.0.0.1:1", num_processes=2)


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_query_plain_matches_jax(data, S):
    d, i = sharded_query_plain(data["cw"], data["q"], data["codes"],
                               top_k=TOPK, mesh=make_mesh(S, device=CPU))
    jd, ji = jsharded.sharded_query_plain(data["cw"], data["q"],
                                          data["codes"], top_k=TOPK,
                                          mesh=jmake_mesh(S))
    _check(data, d, i, jd, ji)
    qd, qi = query_plain(data["cw"], data["q"], data["codes"], top_k=TOPK,
                         engine="xla", device=CPU)
    assert np.array_equal(d, qd)


@pytest.mark.parametrize("S", SHARDS)
def test_pipelined_query_matches_jax(data, S):
    """Batch for batch equal to ``sharded_query_plain`` on that batch,
    and to the JAX pipeline."""
    mesh = make_mesh(S, device=CPU)
    d, i = pipelined_query(data["cw"], data["q"], data["codes"], mesh,
                           top_k=TOPK, batch_size=8)
    for b0 in range(0, B, 8):
        sd, si = sharded_query_plain(data["cw"], data["q"][b0:b0 + 8],
                                     data["codes"], top_k=TOPK, mesh=mesh)
        assert np.array_equal(d[b0:b0 + 8], sd)
        assert np.array_equal(i[b0:b0 + 8], si)
    jd, ji = j_pipelined(data["cw"], data["q"], data["codes"],
                         jmake_mesh(S), top_k=TOPK, batch_size=8)
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-5, atol=1e-4)
    assert_ids_up_to_ties(data["table"], data["codes"], i, np.asarray(ji),
                          TOPK)


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_query_decoded_matches_jax(data, S):
    d, i = sharded_query_decoded(data["cw"], data["q"], data["codes"],
                                 top_k=TOPK, mesh=make_mesh(S, device=CPU))
    jd, ji = jsharded.sharded_query_decoded(data["cw"], data["q"],
                                            data["codes"], top_k=TOPK,
                                            mesh=jmake_mesh(S))
    _check(data, d, i, jd, ji)


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_query_compressed_matches_jax(data, S):
    """Per-shard trees and the stacked pack byte-equal to the JAX
    package's; the level-wise query within rtol 1e-5 of the exact scan
    (another summation order) and of the JAX one."""
    codes, cw = data["codes"][:3000], data["cw"]
    trees, sizes = build_sharded_trees(codes, K, S, cw)
    jtrees, jsizes = j_build_trees(codes, K, S, cw)
    bases = np.arange(S, dtype=np.int32) * -(-len(codes) // S)
    pack, jpack = (build_sharded_pack(trees, bases, sizes),
                   j_build_pack(jtrees, bases, jsizes))
    for name in ("root_idx", "db_to_lm", "n_local", "row_base"):
        assert np.array_equal(getattr(pack, name), getattr(jpack, name))
    for lv, jlv in zip(pack.levels, jpack.levels):
        assert all(np.array_equal(a, b) for a, b in zip(lv, jlv))
    assert (pack.n_pad, pack.lm_size, pack.level_skew) == (
        jpack.n_pad, jpack.lm_size, jpack.level_skew)
    d, i = sharded_query_compressed(cw, codes, data["q"], top_k=TOPK,
                                    mesh=make_mesh(S, device=CPU))
    jd, ji = j_sq_compressed(cw, codes, data["q"], top_k=TOPK,
                             mesh=jmake_mesh(S))
    ed, ei = _exact(cw, codes, data["q"])
    np.testing.assert_allclose(d, ed, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-5, atol=1e-4)
    assert_ids_up_to_ties(data["table"], codes, i, ei, TOPK)


_JAX_ENGINE, _JAX_PLAIN = {}, {}


def _jax_engine_results(data, S, codes, order):
    key = (S, len(codes))
    if key not in _JAX_ENGINE:
        je = JShardedEngine(data["cw"], codes[order], jmake_mesh(S),
                            row_to_db=order)
        jd, ji = je.query(data["q"], top_k=TOPK)
        _JAX_ENGINE[key] = (np.asarray(jd), np.asarray(ji),
                            je.last_exact_frac, je.bytes_per_vec())
    return _JAX_ENGINE[key]


def _jax_exact(data, S, codes):
    """The JAX package's exact sharded scan over the same codes,
    codebook and queries (no certificate: every row scanned)."""
    key = (S, len(codes))
    if key not in _JAX_PLAIN:
        _JAX_PLAIN[key] = tuple(np.asarray(a) for a in
                                jsharded.sharded_query_plain(
                                    data["cw"], data["q"], codes,
                                    top_k=TOPK, mesh=jmake_mesh(S)))
    return _JAX_PLAIN[key]


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("precision", ["bf16", "int8", "int16"])
def test_sharded_engine_matches_jax(data, S, precision):
    """Exact at every precision and shard count (ladder + terminal
    scan per shard): held to the JAX package's exact sharded scan
    always, and to the JAX engine (bf16, its only mode) where its first
    shot certified every query.  Where it did not, the JAX engine
    returns uncertified rows (its one fixed rung, no ladder), no better
    than the exact ones.  On these inputs the JAX engine certifies every
    query at S=2 and none at S=4, so both branches run."""
    codes = data["codes"]
    order = np.lexsort(codes.T[::-1])
    e = ShardedCompressedEngine(data["cw"], codes[order],
                                make_mesh(S, device=CPU), row_to_db=order,
                                precision=precision)
    assert len(e.shards) == S and e.precision == precision
    assert all(s.precision == precision for s, _ in e.shards)
    d, i = e.query(data["q"], top_k=TOPK)
    assert 0.0 <= e.last_exact_frac <= 1.0
    _check(data, d, i, *_jax_exact(data, S, codes))
    jd, ji, jfrac, jbpv = _jax_engine_results(data, S, codes, order)
    assert (jfrac == 1.0) == (S == 2), jfrac
    if jfrac == 1.0:
        _check(data, d, i, jd, ji)
    else:
        assert np.all(jd[:, -1] >= d[:, -1] - 1e-4)
    assert e.bytes_per_vec() == pytest.approx(jbpv)


def test_sharded_engine_empty_last_shard(data):
    """2,500 rows are three tiles: over four shards the last holds only
    a padding tile (no valid row), launches nothing and gives +inf rows;
    the merged result stays exact."""
    codes = data["codes"][:2500]
    order = np.lexsort(codes.T[::-1])
    e = ShardedCompressedEngine(data["cw"], codes[order],
                                make_mesh(4, device=CPU), row_to_db=order)
    assert [s.n_valid for s, _ in e.shards] == [1024, 1024, 452, 0]
    assert [base for _, base in e.shards] == [0, 1024, 2048, 3072]
    d, i = e.query(data["q"], top_k=TOPK)
    _check(data, d, i, *_jax_exact(data, 4, codes), codes=codes)
    jd, ji, jfrac, _ = _jax_engine_results(data, 4, codes, order)
    if jfrac == 1.0:
        _check(data, d, i, jd, ji, codes=codes)
    # fewer rows than top_k: +inf and -1 after the real rows
    few = data["codes"][:6]
    e = ShardedCompressedEngine(data["cw"], few, make_mesh(2, device=CPU))
    d, i = e.query(data["q"][:4], top_k=TOPK)
    assert np.all(np.isfinite(d[:, :6])) and np.all(np.isinf(d[:, 6:]))
    assert np.all(i[:, 6:] == -1) and np.all(np.sort(i[:, :6], 1)
                                             == np.arange(6))


def test_sharded_engine_exact_where_the_first_shot_fails(data):
    """First rungs forced to one unit a shard: the certificate fails,
    the ladder and the terminal scan run, and the result is exact --
    where the JAX engine would return the first rung's rows."""
    codes = data["codes"]
    order = np.lexsort(codes.T[::-1])
    e = ShardedCompressedEngine(data["cw"], codes[order],
                                make_mesh(4, device=CPU), row_to_db=order)
    for s, _ in e.shards:
        s.ns_hint = 1
    d, i = e.query(data["q"], top_k=TOPK)
    assert e.last_exact_frac < 1.0
    _check(data, d, i)


def test_shard_axis_must_name_the_mesh_axis(data):
    """``shard_axis`` names the mesh's axis or raises ValueError, as
    JAX's ``shard_map`` refuses an axis its mesh lacks."""
    codes = data["codes"][:2048]
    mesh = make_mesh(2, device=CPU, axis_name="rows")
    with pytest.raises(ValueError, match="rows"):
        pbig.ChunkedCompressedEngine(data["cw"], codes, mesh=mesh)
    with pytest.raises(ValueError, match="rows"):
        DedupCompressedEngine(data["cw"], codes, mesh=mesh)
    e = DedupCompressedEngine(data["cw"], codes, mesh=mesh,
                              shard_axis="rows")
    d, i = e.query(data["q"], top_k=TOPK)
    _check(data, d, i, codes=codes)


@pytest.mark.parametrize("S", SHARDS)
def test_dp_lloyd_step_matches_jax(S):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(M, 512, DS)).astype(np.float32)
    centers = rng.normal(size=(M, K, DS)).astype(np.float32)
    mesh = make_mesh(S, device=CPU)
    c, dist = make_dp_lloyd_step(mesh)(shard_rows(mesh, x, dim=1),
                                       torch.from_numpy(centers))
    jmesh = jmake_mesh(S)
    jc, jdist = jsharded.make_dp_lloyd_step(jmesh)(
        jax.device_put(x, NamedSharding(jmesh, P(None, "shard", None))),
        centers)
    # centres compared where the labels cannot differ: a row whose two
    # nearest centres are within 1e-3 may go to either, in f32
    d2 = ((x[:, :, None, :].astype(np.float64) - centers[:, None]) ** 2
          ).sum(-1)
    two = np.argsort(d2, axis=2)[:, :, :2]
    gap = np.take_along_axis(d2, two[:, :, 1:], 2) - np.take_along_axis(
        d2, two[:, :, :1], 2)
    keep = np.ones((M, K), bool)
    mm, rr = np.nonzero(gap[:, :, 0] < 1e-3)
    keep[mm, two[mm, rr, 0]] = keep[mm, two[mm, rr, 1]] = False
    assert keep.mean() > 0.9
    np.testing.assert_allclose(c.numpy()[keep], np.asarray(jc)[keep],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(dist), float(jdist), rtol=1e-5)
    one = make_dp_lloyd_step(make_mesh(1, device=CPU))
    c1, dist1 = one([torch.from_numpy(x)], torch.from_numpy(centers))
    np.testing.assert_allclose(c.numpy(), c1.numpy(), rtol=1e-5, atol=1e-6)


def test_chunked_from_saved_mesh_on_a_jax_directory(data, tmp_path):
    """A directory the JAX package saved (int8, three chunks) reopened
    with ``mesh=``: each chunk a sharded engine at the saved precision,
    exact; the JAX ``from_saved(mesh=)`` runs bf16 sharded chunks with
    no ladder instead."""
    codes = data["codes"][:3000]
    order = np.lexsort(codes.T[::-1])
    jeng = jbig.ChunkedCompressedEngine(data["cw"], codes[order],
                                        row_to_db=order, chunk_rows=1024)
    jeng.save(str(tmp_path / "jax"))
    jd, ji = jeng.query(data["q"], top_k=TOPK)
    back = pbig.ChunkedCompressedEngine.from_saved(
        str(tmp_path / "jax"), mmap=True, mesh=make_mesh(2, device=CPU))
    assert back.resident and len(back.chunks) == 3
    assert all(c.precision == "int8" and len(c.shards) == 2
               for c in back.chunks)
    d, i = back.query(data["q"], top_k=TOPK)
    _check(data, d, i, jd, ji, codes=codes)
    assert len(back.last_exact_fracs) == 3
    # and the mesh engine saves a directory both packages reopen
    back.save(str(tmp_path / "port"))
    again = pbig.ChunkedCompressedEngine.from_saved(str(tmp_path / "port"),
                                                    device=CPU)
    d2, _ = again.query(data["q"], top_k=TOPK)
    assert np.array_equal(d2, d)
    jd2, _ = jbig.ChunkedCompressedEngine.from_saved(
        str(tmp_path / "port")).query(data["q"], top_k=TOPK)
    np.testing.assert_allclose(np.asarray(jd2), d, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("S", SHARDS)
def test_chunked_engine_mesh_matches_jax(data, S):
    codes = data["codes"][:4096]
    e = pbig.ChunkedCompressedEngine(data["cw"], codes, chunk_rows=2048,
                                     precision="bf16",
                                     mesh=make_mesh(S, device=CPU))
    e.warmup(batch_sizes=(B,), top_k=TOPK)
    d, i = e.query(data["q"], top_k=TOPK)
    je = jbig.ChunkedCompressedEngine(data["cw"], codes, chunk_rows=2048)
    jd, ji = je.query(data["q"], top_k=TOPK)
    _check(data, d, i, jd, ji, codes=codes)


@pytest.mark.parametrize("S", SHARDS)
def test_dedup_mesh_matches_jax(data, S):
    rng = np.random.default_rng(3)
    distinct = data["codes"][rng.choice(N, 1500, replace=False)]
    codes = distinct[rng.integers(0, len(distinct), size=5000)]
    e = DedupCompressedEngine(data["cw"], codes,
                              mesh=make_mesh(S, device=CPU))
    assert isinstance(e.engine, ShardedCompressedEngine)
    assert e._codes_pad is None and e.engine.precision == "int8"
    d, i = e.query(data["q"], top_k=TOPK)
    je = jfused.DedupCompressedEngine(data["cw"], codes)
    jd, ji = je.query(data["q"], top_k=TOPK)
    _check(data, d, i, jd, ji, codes=codes)


def test_cli_shards_matches_jax(tmp_path):
    """``query -shards 2`` of both CLIs on one dataset of integer
    vectors and codewords (every distance exact in f32): equal
    distances, ids up to ties, and equal to the port's unsharded
    ``-engine xla``."""
    from deltapq_tpu_torch.ops.encode import pq_encode

    rng = np.random.default_rng(5)
    m, k, ds, n = 4, 16, 2, 3000
    centres = rng.integers(100, 600, size=(12, m * ds))
    base = np.clip(centres[rng.integers(0, 12, n)]
                   + rng.integers(-80, 81, size=(n, m * ds)), 0, 699
                   ).astype(np.float32)
    q = np.clip(centres[rng.integers(0, 12, 20)]
                + rng.integers(-80, 81, size=(20, m * ds)), 0, 699
                ).astype(np.float32)
    cw = np.stack([base[rng.choice(n, k, replace=False),
                        j * ds:(j + 1) * ds] for j in range(m)])
    codes = pq_encode(torch.from_numpy(cw), base).numpy()
    root = str(tmp_path)
    write_vecs(os.path.join(root, "query.fvecs"), q)
    write_codewords(os.path.join(root, f"M{m}K{k}codewords.txt"), cw)
    write_codes(os.path.join(root, f"codes.bin.plain.M{m}K{k}N{n}"), codes)
    res = {}
    for name, mod, extra, kw in (
            ("jax", jcli, ["-shards", "2"], {}),
            ("port", pcli, ["-shards", "2"], dict(device=torch.device(CPU))),
            ("xla", pcli, ["-engine", "xla"], dict(device=torch.device(CPU)))):
        ns = mod.build_parser().parse_args(
            ["-dataset", root, "-task", "query", "-ext", "fvecs", "-m",
             str(m), "-k", str(k), "-topk", "10", *extra])
        for a, v in kw.items():
            setattr(ns, a, v)
        res[name] = tuple(np.asarray(r) for r in mod.task_query(ns,
                                                                Metrics()))
    table = ((q.reshape(len(q), m, 1, ds) - cw[None]) ** 2).sum(3)
    assert np.array_equal(res["port"][0], res["jax"][0])
    assert np.array_equal(res["port"][0], res["xla"][0])
    for other in ("jax", "xla"):
        assert_ids_up_to_ties(table, codes, res["port"][1], res[other][1], 10)


def test_dryrun_multichip_on_cpu():
    assert "OK" in dryrun_multichip(4, device=CPU)


def test_two_process_gloo():
    """Two processes join one gloo group (each binding 127.0.0.1);
    two CPU shards each make a 4-shard mesh; the sharded plain query,
    one DP Lloyd step and ``ShardedCompressedEngine`` equal their
    single-process 4-shard results in both (this file's ``_worker``).
    The workers are killed and the test fails past 120 s."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("gloo workers did not finish within 120 s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "rank 0: OK" in outs[0] and "rank 1: OK" in outs[1]


def _delta_fn_operands(data, S, n_rows):
    """The operands of the JAX ``make_sharded_delta_query_fn`` step, as
    its ``ShardedCompressedEngine`` builds them: slot tiles of the
    lexsorted codes padded to a shard multiple, the centered grouped
    bf16 queries, q2, the exact tables."""
    from deltapq_tpu.ops import fused_pallas as jfp
    from deltapq_tpu_torch.ops import fused_kernels as fk
    from deltapq_tpu_torch.ops.delta_tiles import (TILE, _full_planes,
                                                   build_delta_tiles)
    from deltapq_tpu_torch.ops.fused import rung_plan

    codes = data["codes"][:n_rows]
    order = np.lexsort(codes.T[::-1])
    tiles = build_delta_tiles(codes[order])
    rd, ovf = tiles.row_data, tiles.ovf
    nt = rd.shape[0]
    nt_pad = -(-nt // S) * S
    if nt_pad != nt:
        rd = np.concatenate([rd, np.zeros((nt_pad - nt,) + rd.shape[1:],
                                          rd.dtype)])
        rd[nt:, :tiles.n_planes, 0] = _full_planes(M)
        ovf = np.concatenate([ovf, np.zeros((nt_pad - nt,) + ovf.shape[1:],
                                            ovf.dtype)])
    cw, D = data["cw"], M * DS
    q = np.zeros((128, 128), np.float32)
    q[:B, :D] = data["q"]
    mu = np.zeros(128, np.float32)
    mu[:D] = fk.codebook_center(cw)
    qc = q - mu[None, :]
    qk = fk.pack_query_grouped(qc[:, :D], M, DS)
    table = adc_table(torch.from_numpy(cw), torch.from_numpy(q[:, :D]))
    plan = rung_plan(nt_pad // S * TILE // fk.SUB, TOPK, 128)
    port = (torch.from_numpy(qk).to(torch.bfloat16).t().contiguous(),
            torch.from_numpy((qc * qc).sum(axis=1)), table,
            fk.build_blockdiag_codebook(cw, center=mu[:D]), rd, ovf,
            tiles.n_valid)
    jax_ops = (jax.numpy.asarray(qk.astype(jax.numpy.bfloat16).T),
               jax.numpy.asarray((qc * qc).sum(axis=1)),
               jax.numpy.asarray(table.numpy()),
               jax.numpy.asarray(jfp.build_blockdiag_codebook(
                   cw, center=mu[:D])), rd, ovf, tiles.n_valid)
    return codes, order, tiles.S, plan.rungs[0], plan.pool, port, jax_ops


@pytest.mark.parametrize("S", SHARDS)
def test_make_sharded_delta_query_fn_matches_jax(data, S):
    """One fixed rung a shard, no ladder: the distances agree with the
    JAX step (rtol 1e-5, atol 1e-4) and, certified here, equal the exact
    scan; the rows agree up to audited ties."""
    from deltapq_tpu.parallel.fused_sharded import \
        make_sharded_delta_query_fn as j_make_fn
    from deltapq_tpu_torch.parallel.fused_sharded import \
        make_sharded_delta_query_fn

    codes, order, S_slots, ns, pool, port, jops = _delta_fn_operands(
        data, S, N)
    fn = make_sharded_delta_query_fn(make_mesh(S, device=CPU), TOPK, ns,
                                     pool, S_slots, Ds=DS)
    d, rows, ok = fn(*port)
    jmesh = jmake_mesh(S)
    shard = NamedSharding(jmesh, P("shard"))
    jd, jrows, jok = j_make_fn(jmesh, TOPK, ns, pool, S_slots)(
        *jops[:4], jax.device_put(jops[4], shard),
        jax.device_put(jops[5], shard), jax.numpy.int32(jops[6]))
    d, rows, ok = d[:B].numpy(), rows[:B].numpy(), ok[:B].numpy()
    jd, jrows, jok = (np.asarray(jd)[:B], np.asarray(jrows)[:B],
                      np.asarray(jok)[:B])
    # 6,000 rows are six tiles: at S=4 the last shard holds only padding
    # tiles.  The JAX step scans it and its certificate there is NaN
    # (an infinite fence), so no query certifies; the port's skips it.
    if S == 2:
        assert ok.all() and jok.all()
    else:
        assert ok.all() and not jok.any()
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)
    ed, _ = data["exact"]
    assert np.array_equal(d, ed)
    assert_ids_up_to_ties(data["table"], data["codes"], order[rows],
                          order[jrows], TOPK)


def test_make_sharded_delta_query_fn_skips_padding_shards(data,
                                                          monkeypatch):
    """2,500 rows are three tiles: over four shards the last holds only
    padding and launches nothing; the merged result agrees with the JAX
    step, which scans it (no query certifies in either: shard 2's 452
    rows are fewer units than the rung takes, so its fence is +inf)."""
    from deltapq_tpu.parallel.fused_sharded import \
        make_sharded_delta_query_fn as j_make_fn
    from deltapq_tpu_torch.ops import fused_kernels as fk
    from deltapq_tpu_torch.parallel.fused_sharded import \
        make_sharded_delta_query_fn

    codes, order, S_slots, ns, pool, port, jops = _delta_fn_operands(
        data, 4, 2500)
    calls = []
    scan = fk.fused_delta_mins
    monkeypatch.setattr(fk, "fused_delta_mins",
                        lambda *a, **k: calls.append(a[4]) or scan(*a, **k))
    fn = make_sharded_delta_query_fn(make_mesh(4, device=CPU), TOPK, ns,
                                     pool, S_slots, Ds=DS)
    d, rows, ok = fn(*port)
    assert calls == [1024, 1024, 452]
    jmesh = jmake_mesh(4)
    shard = NamedSharding(jmesh, P("shard"))
    jd, jrows, jok = j_make_fn(jmesh, TOPK, ns, pool, S_slots)(
        *jops[:4], jax.device_put(jops[4], shard),
        jax.device_put(jops[5], shard), jax.numpy.int32(jops[6]))
    assert not ok.any() and not np.asarray(jok).any()
    d, rows = d[:B].numpy(), rows[:B].numpy()
    np.testing.assert_allclose(d, np.asarray(jd)[:B], rtol=1e-5, atol=1e-4)
    assert 0 <= rows.min() and rows.max() < 2500
    assert_ids_up_to_ties(data["table"], codes, order[rows],
                          order[np.asarray(jrows)[:B]], TOPK)
