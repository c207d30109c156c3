"""The port's CLI against the JAX CLI, task by task, on one dataset.

The dataset's vectors and codewords hold integers below 700, so every
squared distance of encode, groundtruth and the ADC tables is an
integer below 2^24, exact in f32 in any summation order: the two
packages compute the same numbers, and their files are compared byte
for byte.  Both CLIs start from one codewords file (written once); the
port's ``learn`` is held to the JAX one by its k-means distortion.
"""

import contextlib
import io
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deltapq_tpu import cli as jcli
from deltapq_tpu.io import read_codewords as j_read_codewords
from deltapq_tpu.ops import pq_learn as j_learn
from deltapq_tpu_torch import cli as pcli
from deltapq_tpu_torch.eval.metrics import recall_at_k
from deltapq_tpu_torch.io import (read_codes, read_groundtruth, read_vecs,
                                  write_codewords, write_vecs)
from deltapq_tpu_torch.ops.encode import pq_decode, pq_encode
from deltapq_tpu_torch.profiling import Metrics

from _torch_port import CPU, assert_ids_up_to_ties

M, K, DS = 8, 32, 2
N_BASE, N_Q = 2000, 40
COMMON = ["-ext", "fvecs", "-m", str(M), "-k", str(K)]
CODES = f"codes.bin.plain.M{M}K{K}N{N_BASE}"
#: the pipeline, in order; combine merges the code file with itself.
#: The tasks that print recall, mAP and accuracy scan with ``pallas``:
#: the base holds rows with equal codes, so exact distance ties are
#: common, and these metrics depend on which of the tied ids a scan
#: keeps.  Both packages' ``pallas`` scans keep the lower id (their
#: ``xla`` scans may differ there, ROADMAP C; the test below holds
#: their ids equal up to ties).
PIPELINE = [
    ("encode",), ("groundtruth", "-topk", "10"),
    ("query", "-topk", "10", "-engine", "pallas"),
    ("recall", "-topk", "10", "-engine", "pallas"), ("approx_tree",),
    ("approx_tree", "-method", "3"),
    ("query_compressed", "-topk", "10", "-engine", "xla"),
    ("query_compressed", "-topk", "10", "-engine", "xla", "-method", "3"),
    ("approx_with_id",), ("diff_index",), ("diff_scan", "-topk", "5"),
    ("mAP", "-topk", "10", "-engine", "pallas"),
    ("accuracy", "-topk", "10", "-engine", "pallas"),
    ("update", "-query_size", "100"), ("rand_sample", "-rand_sample", "50"),
    ("combine", "-src_a", "@" + CODES, "-src_b", "@" + CODES),
]
#: every file the pipeline writes
WRITTEN = [
    CODES, f"groundtruth/N{N_BASE}Top10.txt",
    f"M{M}K{K}H1_Approx_Edges_N{N_BASE}.npz",
    f"M{M}K{K}H1_Approx_Edges_clique_N{N_BASE}.npz",
    f"M{M}K{K}_Approx_compressed_codes_opt_N{N_BASE}",
    f"M{M}K{K}_Approx_compressed_codes_opt_N{N_BASE}.soa.npz",
    f"M{M}K{K}_Approx_compressed_codes_opt_clique_N{N_BASE}",
    f"M{M}K{K}_Approx_compressed_codes_opt_clique_N{N_BASE}.soa.npz",
    f"M{M}K{K}_Approx_compressed_codes_opt_with_id_N{N_BASE}.soa.npz",
    f"M{M}K{K}_diff_index_N{N_BASE}", f"codes.bin.plain.M{M}K{K}N{2 * N_BASE}",
]


def _dataset(root):
    """Clustered integer vectors (base, learn, query) sharing centres,
    and integer codewords cut from learn rows."""
    rng = np.random.default_rng(5)
    centers = rng.integers(100, 600, size=(24, M * DS))

    def mk(n):
        a = rng.integers(0, len(centers), n)
        x = centers[a] + rng.integers(-80, 81, size=(n, M * DS))
        return np.clip(x, 0, 699).astype(np.float32)

    os.makedirs(root)
    write_vecs(os.path.join(root, "base.fvecs"), mk(N_BASE))
    learn = mk(1000)
    write_vecs(os.path.join(root, "learn.fvecs"), learn)
    write_vecs(os.path.join(root, "query.fvecs"), mk(N_Q))
    pick = rng.choice(len(learn), K, replace=False)
    cw = np.stack([learn[pick, m * DS:(m + 1) * DS] for m in range(M)])
    write_codewords(os.path.join(root, f"M{M}K{K}codewords.txt"), cw)


def _run(main, root, step, **kw):
    """stdout of one CLI call (``step`` = task, flags...; ``@`` stands
    for the dataset directory), that directory written as ``DS``."""
    task, *extra = step
    argv = ["-dataset", root, "-task", task, *COMMON,
            *[a.replace("@", root + os.sep) for a in extra]]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, **kw)
    assert rc == 0
    return out.getvalue().replace(root, "DS")


def _args(main_mod, root, task, *extra, **attrs):
    """Parsed flags of one task over the N_BASE rows (after the pipeline
    the combined file, twice as long, is the default)."""
    ns = main_mod.build_parser().parse_args(
        ["-dataset", root, "-task", task, *COMMON, "-N", str(N_BASE),
         *extra])
    for k, v in attrs.items():
        setattr(ns, k, v)
    return ns


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs through the whole pipeline, each on its own copy of one
    dataset directory; returns (jax dir, port dir, {step: (jax stdout,
    port stdout)})."""
    tmp = tmp_path_factory.mktemp("cli")
    src = str(tmp / "src")
    _dataset(src)
    jdir, pdir = str(tmp / "jax"), str(tmp / "port")
    shutil.copytree(src, jdir)
    shutil.copytree(src, pdir)
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's ADC kernel on the CPU: Pallas in interpret
        # mode, as its own tests run it
        orig = pl.pallas_call
        mp.setattr(pl, "pallas_call",
                   lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        for step in PIPELINE:
            outs[" ".join(step)] = (_run(jcli.main, jdir, step),
                                    _run(pcli.main, pdir, step, device=CPU))
    return jdir, pdir, outs


def _printed(text):
    """Printed lines that do not depend on the clock or the process:
    no msec/query line, and the metrics JSON without times and memory."""
    lines = []
    for line in text.splitlines():
        if "[msec/query]" in line:
            continue
        if line.startswith("{"):
            m = json.loads(line)
            line = {k: v for k, v in m.items()
                    if not k.startswith("time_") and k not in ("vm_kb",
                                                                "rss_kb")}
        lines.append(line)
    return lines


@pytest.mark.parametrize("name", WRITTEN)
def test_written_files_equal(runs, name):
    jdir, pdir, _ = runs
    a, b = os.path.join(jdir, name), os.path.join(pdir, name)
    if name.endswith(".npz"):
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, k
                assert np.array_equal(za[k], zb[k]), k
    else:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_the_same_files_are_written(runs):
    jdir, pdir, _ = runs
    listing = [sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
               for root in (jdir, pdir)]
    assert listing[0] == listing[1]
    assert set(WRITTEN) <= set(listing[1])


@pytest.mark.parametrize("step", [" ".join(s) for s in PIPELINE])
def test_printed_lines_equal(runs, step):
    """Every task prints the same lines (recall, mAP, accuracy, B/vec,
    edge and diff counts, the metrics JSON), clock aside."""
    jout, pout = runs[2][step]
    assert _printed(pout) == _printed(jout)


@pytest.mark.parametrize("task,engine", [
    ("query", "xla"), ("query_compressed", "xla"), ("diff_scan", "auto")])
def test_query_results_match_jax(runs, task, engine):
    jdir, pdir, _ = runs
    with contextlib.redirect_stdout(io.StringIO()):
        jd, ji = getattr(jcli, f"task_{task}")(
            _args(jcli, jdir, task, "-engine", engine), Metrics())
        pd, pi = getattr(pcli, f"task_{task}")(
            _args(pcli, pdir, task, "-engine", engine,
                  device=torch.device(CPU)), Metrics())
    jd, ji = np.asarray(jd), np.asarray(ji)
    # integer tables: the sums are exact, in any order
    assert np.array_equal(pd, jd)
    cw = j_read_codewords(os.path.join(pdir, f"M{M}K{K}codewords.txt"))
    q = read_vecs(os.path.join(pdir, "query.fvecs"))
    table = ((q.reshape(len(q), M, 1, DS) - cw[None]) ** 2).sum(3)
    codes, _ = read_codes(os.path.join(pdir, CODES), M=M, K=K)
    assert_ids_up_to_ties(table, codes, pi, ji, 10)


@pytest.mark.parametrize("engine", ["pallas", "decoded", "fused",
                                    "fused_codes", "fused_compressed",
                                    "fused_dedup"])
def test_query_engines_agree(runs, engine):
    """Each ``-engine`` (its kernels' plain versions on the CPU) against
    ``xla``: the same distances, ids up to ties; ``decoded`` by its
    recall, as its bf16 scan has no exactness contract of its own."""
    _, pdir, _ = runs
    res = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for e in ("xla", engine):
            res[e] = pcli.task_query(
                _args(pcli, pdir, "query", "-topk", "10", "-engine", e,
                      "-batch", "16", device=torch.device(CPU)), Metrics())
    (xd, xi), (d, i) = res["xla"], res[engine]
    codes, _ = read_codes(os.path.join(pdir, CODES), M=M, K=K)
    if engine == "decoded":
        hits = [len(set(a) & set(b)) for a, b in zip(i, xi)]
        assert np.mean(hits) >= 9.0
        return
    assert np.array_equal(d, xd)
    cw = j_read_codewords(os.path.join(pdir, f"M{M}K{K}codewords.txt"))
    q = read_vecs(os.path.join(pdir, "query.fvecs"))
    table = ((q.reshape(len(q), M, 1, DS) - cw[None]) ** 2).sum(3)
    assert_ids_up_to_ties(table, codes, i, xi, 10)


def test_batcher_equals_one_batch(runs):
    """``len(q) > -batch`` goes through ``ContinuousBatcher`` (the tail
    batch padded with repeated rows) and gives the one-batch answer."""
    _, pdir, _ = runs
    with contextlib.redirect_stdout(io.StringIO()):
        one = pcli.task_query(_args(pcli, pdir, "query", "-engine", "xla",
                                    "-batch", "128",
                                    device=torch.device(CPU)), Metrics())
        many = pcli.task_query(_args(pcli, pdir, "query", "-engine", "xla",
                                     "-batch", "16",
                                     device=torch.device(CPU)), Metrics())
    assert np.array_equal(one[0], many[0]) and np.array_equal(one[1],
                                                              many[1])
    assert many[0].shape == (N_Q, 10)


def test_recall_is_recomputed_from_the_groundtruth(runs):
    _, pdir, outs = runs
    with contextlib.redirect_stdout(io.StringIO()):
        _, i = pcli.task_query(_args(pcli, pdir, "query", "-topk", "10",
                                     "-engine", "pallas",
                                     device=torch.device(CPU)), Metrics())
    gt, _ = read_groundtruth(os.path.join(pdir, "groundtruth",
                                          f"N{N_BASE}Top10.txt"))
    printed = json.loads(
        outs["recall -topk 10 -engine pallas"][1].splitlines()[-1])
    assert printed["recall"] == recall_at_k(i, gt, k=10) > 0.3


def test_force_0_skips_a_second_build(runs, capsys):
    _, pdir, _ = runs
    for task, said in (("encode", "REMINDER"),
                       ("approx_tree", "No need to rebuild"),
                       ("learn", "skipping")):
        pcli.main(["-dataset", pdir, "-task", task, *COMMON, "-N",
                   str(N_BASE)], device=CPU)
        assert said in capsys.readouterr().out


def test_shards_raise(runs):
    """``-shards N`` raises no more: the plain scan sharded over N CPU
    shards gives ``-engine xla``'s distances, ids up to ties."""
    _, pdir, _ = runs
    with contextlib.redirect_stdout(io.StringIO()):
        xd, xi = pcli.task_query(_args(pcli, pdir, "query", "-topk", "10",
                                       "-engine", "xla",
                                       device=torch.device(CPU)), Metrics())
        for shards in ("2", "4"):
            d, i = pcli.task_query(_args(pcli, pdir, "query", "-topk", "10",
                                         "-shards", shards,
                                         device=torch.device(CPU)),
                                   Metrics())
            assert np.array_equal(d, xd)
            cw = j_read_codewords(os.path.join(pdir, f"M{M}K{K}codewords.txt"))
            q = read_vecs(os.path.join(pdir, "query.fvecs"))
            table = ((q.reshape(len(q), M, 1, DS) - cw[None]) ** 2).sum(3)
            codes, _ = read_codes(os.path.join(pdir, CODES), M=M, K=K)
            assert_ids_up_to_ties(table, codes, i, xi, 10)
    assert pcli.main(["-dataset", pdir, "-task", "query", *COMMON, "-N",
                      str(N_BASE), "-shards", "2"], device=CPU) == 0


def test_unknown_task_is_refused(runs, capsys):
    assert pcli.main(["-dataset", runs[1], "-task", "nope", *COMMON],
                     device=CPU) == 2


def test_learn(tmp_path):
    """The port's learn: a codewords file the JAX package reads, the
    right shape, the same bytes for the same seed, and a k-means
    distortion within 1.25x of the JAX learn's on the same pool."""
    paths = []
    for run in ("a", "b"):
        root = str(tmp_path / run)
        _dataset(root)
        os.remove(os.path.join(root, f"M{M}K{K}codewords.txt"))
        _run(pcli.main, root, ("learn", "-train_size", "800"), device=CPU)
        paths.append(os.path.join(root, f"M{M}K{K}codewords.txt"))
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    cw = j_read_codewords(paths[0])
    assert cw.shape == (M, K, DS)
    learn = read_vecs(os.path.join(str(tmp_path / "a"), "learn.fvecs"))
    rng = np.random.default_rng(0)
    rng.shuffle(learn)
    pool = learn[:800]
    jcw = np.asarray(j_learn(jax.random.PRNGKey(0), pool, M=M, K=K,
                             max_iters=1000, tol=1.0, n_init=3))

    def distortion(c):
        ct = torch.from_numpy(np.array(c, np.float32))
        x = pq_decode(ct, pq_encode(ct, pool)).numpy()
        return float(((x - pool) ** 2).sum())

    assert distortion(cw) <= 1.25 * distortion(jcw)


def test_main_needs_the_card_by_default(runs):
    """No device named: the card; without one, nothing runs on the CPU
    in its place (the numpy-only ``update`` included)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default works")
    with pytest.raises((RuntimeError, AssertionError)):
        pcli.main(["-dataset", runs[1], "-task", "update", *COMMON])

