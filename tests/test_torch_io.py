"""The port's file layer (``config``, ``io/``, ``profiling``) against the
JAX package's: every reader and writer round-trips, the two packages
write the same bytes from the same NumPy arrays, and each reads the
other's files."""

import json
import os

import numpy as np
import pytest

from deltapq_tpu import config as jconfig
from deltapq_tpu import io as jio
from deltapq_tpu import profiling as jprof
from deltapq_tpu.io import vecs as jvecs
from deltapq_tpu_torch import config as pconfig
from deltapq_tpu_torch import io as pio
from deltapq_tpu_torch import profiling as pprof
from deltapq_tpu_torch.io import vecs as pvecs


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _vecs(rng, ext, n=300, d=12):
    x = rng.normal(size=(n, d)) * 40 + 100
    return (x.clip(0, 255).astype(np.uint8) if ext == "bvecs"
            else x.astype(np.float32))


@pytest.mark.parametrize("ext", ["fvecs", "bvecs"])
def test_vecs_round_trip_and_readers(tmp_path, ext):
    rng = np.random.default_rng(1)
    x = _vecs(rng, ext)
    p = str(tmp_path / f"a.{ext}")
    pio.write_vecs(p, x)
    assert pio.num_vectors(p, ext) == len(x)
    assert pio.read_dim(p) == x.shape[1]
    got = pio.read_vecs(p, ext)
    assert got.dtype == np.float32
    assert np.array_equal(got, x.astype(np.float32))
    raw = pio.read_vecs(p, ext, as_float=False)
    assert raw.dtype == x.dtype and np.array_equal(raw, x)
    # top_n and offset
    assert np.array_equal(pio.read_vecs(p, ext, top_n=7, offset=290),
                          x[290:297].astype(np.float32))
    assert np.array_equal(pio.read_vecs(p, ext, top_n=50, offset=280),
                          x[280:].astype(np.float32))
    # batches, capped at top_n
    parts = list(pio.iter_vec_batches(p, ext, batch_size=64, top_n=250))
    assert [len(b) for b in parts] == [64, 64, 64, 58]
    assert np.array_equal(np.concatenate(parts), x[:250].astype(np.float32))
    # rows by seek offset, duplicates fanned back out
    ids = np.array([[5, 0, 5], [299, 17, 5]])
    assert np.array_equal(pvecs.read_vecs_at(p, ids, ext),
                          x[ids].astype(np.float32))
    with pytest.raises(ValueError):
        pvecs.read_vecs_at(p, np.array([-1]), ext)


@pytest.mark.parametrize("ext", ["fvecs", "bvecs"])
def test_vecs_bytes_equal_both_ways(tmp_path, ext):
    rng = np.random.default_rng(2)
    x = _vecs(rng, ext)
    pj, pp = str(tmp_path / f"j.{ext}"), str(tmp_path / f"p.{ext}")
    jio.write_vecs(pj, x)
    pio.write_vecs(pp, x)
    assert _bytes(pj) == _bytes(pp)
    # each package reads the other's file
    assert np.array_equal(pio.read_vecs(pj, ext), jio.read_vecs(pp, ext))
    ids = np.array([3, 250, 3])
    assert np.array_equal(pvecs.read_vecs_at(pj, ids, ext),
                          jvecs.read_vecs_at(pp, ids, ext))
    for a, b in zip(pio.iter_vec_batches(pj, ext, batch_size=100),
                    jio.iter_vec_batches(pp, ext, batch_size=100)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("K,with_id", [(256, False), (256, True),
                                       (32, False), (1024, False)])
def test_codes_bytes_equal_both_ways(tmp_path, K, with_id):
    rng = np.random.default_rng(K)
    dtype = np.uint8 if K <= 256 else np.uint16
    codes = rng.integers(0, K, size=(500, 8)).astype(dtype)
    ids = rng.permutation(500).astype(np.int32) if with_id else None
    pj, pp = str(tmp_path / "j"), str(tmp_path / "p")
    jio.write_codes(pj, codes, ids)
    pio.write_codes(pp, codes, ids)
    assert _bytes(pj) == _bytes(pp)
    for read, path in ((pio.read_codes, pj), (jio.read_codes, pp)):
        c, i = read(path, M=8, K=K, with_id=with_id)
        assert c.dtype == dtype and np.array_equal(c, codes)
        assert (i is None) if ids is None else np.array_equal(i, ids)
    c, _ = pio.read_codes(pj, M=8, K=K, with_id=with_id, top_n=40)
    assert np.array_equal(c, codes[:40])
    if K > 256:
        with pytest.raises(NotImplementedError):
            pio.write_codes(pp, codes, np.arange(500))
    with pytest.raises(TypeError):
        pio.write_codes(pp, codes.astype(np.int32))


def test_codewords_bytes_equal_both_ways(tmp_path):
    rng = np.random.default_rng(4)
    cw = (rng.normal(size=(4, 16, 3)) * 7).astype(np.float32)
    pj, pp = str(tmp_path / "j.txt"), str(tmp_path / "p.txt")
    jio.write_codewords(pj, cw)
    pio.write_codewords(pp, cw)
    assert _bytes(pj) == _bytes(pp)
    assert np.array_equal(pio.read_codewords(pj), cw)
    assert np.array_equal(jio.read_codewords(pp), cw)
    bad = str(tmp_path / "bad.txt")
    with open(pp) as f, open(bad, "w") as g:
        g.write(f.read().replace("1:\n", "7:\n", 1))
    with pytest.raises(ValueError):
        pio.read_codewords(bad)


def test_groundtruth_bytes_equal_both_ways(tmp_path):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 10000, size=(12, 10))
    d = rng.random((12, 10)).astype(np.float32) * 100
    pj, pp = str(tmp_path / "j.txt"), str(tmp_path / "p.txt")
    jio.write_groundtruth(pj, ids, d)
    pio.write_groundtruth(pp, ids, d)
    assert _bytes(pj) == _bytes(pp)
    for read, path in ((pio.read_groundtruth, pj),
                       (jio.read_groundtruth, pp)):
        gi, gd = read(path)
        order = np.argsort(d, axis=1, kind="stable")
        assert np.array_equal(gi, np.take_along_axis(ids, order, axis=1))
        assert np.array_equal(gd, np.take_along_axis(d, order, axis=1))


def test_artifact_cache_and_config_key(tmp_path):
    calls = []

    def fn():
        calls.append(1)
        return {"a": np.arange(5), "b": np.ones((2, 2), np.float32)}

    assert pio.config_key(M=8, K=256, h=1) == jio.config_key(M=8, K=256,
                                                             h=1)
    cache = pio.ArtifactCache(str(tmp_path / "cache"))
    key = pio.config_key(M=8)
    first = cache.get_or_compute("edges", key, fn)
    second = cache.get_or_compute("edges", key, fn)
    assert len(calls) == 1
    for k in first:
        assert np.array_equal(first[k], second[k])
    # the JAX package's cache reads the port's file
    jc = jio.ArtifactCache(str(tmp_path / "cache"))
    got = jc.get_or_compute("edges", key, lambda: {})
    assert np.array_equal(got["a"], np.arange(5))
    off = pio.ArtifactCache(str(tmp_path / "off"), enabled=False)
    off.get_or_compute("edges", key, fn)
    assert len(calls) == 2 and not os.path.exists(str(tmp_path / "off"))


@pytest.mark.parametrize("M,K,dim", [(8, 256, 128), (16, 256, 960),
                                     (4, 1024, 30), (12, 16, 7)])
@pytest.mark.parametrize("h,method,diff", [(1, 1, None), (2, 2, 4),
                                           (1, 3, None)])
def test_config_filenames_equal(M, K, dim, h, method, diff):
    pc, jc = pconfig.PQConfig(M, K, dim), jconfig.PQConfig(M, K, dim)
    assert (pc.padded_dim, pc.Ds, pc.code_dtype, pc.log2_K,
            pc.code_bytes_per_vec) == (jc.padded_dim, jc.Ds, jc.code_dtype,
                                       jc.log2_K, jc.code_bytes_per_vec)
    pt, jt = pconfig.TreeConfig(diff, h, method), jconfig.TreeConfig(
        diff, h, method)
    assert pt.resolved_diff(M) == jt.resolved_diff(M)
    assert pt.max_height(M) == jt.max_height(M)
    for n in (None, 1000000):
        assert pconfig.codes_filename(pc, n) == jconfig.codes_filename(jc, n)
    assert pconfig.codewords_filename(pc) == jconfig.codewords_filename(jc)
    for with_id in (False, True):
        for f in ("edges_filename", "tree_nodes_filename",
                  "compressed_codes_filename"):
            assert getattr(pconfig, f)(pc, pt, 3000, with_id) == \
                getattr(jconfig, f)(jc, jt, 3000, with_id)
        assert pconfig.codes_filename(pc, 5, with_id) == \
            jconfig.codes_filename(jc, 5, with_id)
    assert pconfig.diff_index_filename(pc, 77) == \
        jconfig.diff_index_filename(jc, 77)
    assert pconfig.groundtruth_filename(10, 100) == \
        jconfig.groundtruth_filename(10, 100)
    assert pconfig.QueryConfig() == pconfig.QueryConfig(
        **vars(jconfig.QueryConfig()))
    assert vars(pconfig.ShardConfig()) == vars(jconfig.ShardConfig())
    with pytest.raises(ValueError):
        pconfig.PQConfig(M=0)


def test_metrics_dump_equal(tmp_path):
    runs, synced = [], []
    for prof in (jprof, pprof):
        m = prof.Metrics()
        with m.stage("scan", sync=lambda: synced.append(1)):
            pass
        m.set("recall", 0.5)
        m.set("hist", [1, 2])
        m.data["time_scan_s"] = 0.25          # the clock differs per run
        runs.append(m.dump(str(tmp_path / f"{prof.__name__}.json")))
    assert runs[0] == runs[1] and synced == [1, 1]
    assert json.loads(runs[1]) == {"hist": [1, 2], "recall": 0.5,
                                   "time_scan_s": 0.25}
    mem = pprof.host_mem_usage()
    assert set(mem) == {"vm_kb", "rss_kb"} and mem["rss_kb"] > 0
    # without a card there is nothing to report, and no error
    assert isinstance(pprof.device_mem_stats(), dict)
