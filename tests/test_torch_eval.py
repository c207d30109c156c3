"""``deltapq_tpu_torch/eval``: the metrics (a NumPy copy) and
``exact_topk`` against the JAX package's."""

import numpy as np
import pytest

from deltapq_tpu import eval as jeval
from deltapq_tpu_torch import eval as peval

from _torch_port import CPU


@pytest.fixture(scope="module")
def results():
    rng = np.random.default_rng(3)
    nq, k, n = 40, 10, 500
    gt = np.stack([rng.permutation(n)[:k] for _ in range(nq)])
    ret = gt.copy()
    swap = rng.random((nq, k)) < 0.3
    ret[swap] = rng.integers(0, n, swap.sum())
    gt_d = np.sort(rng.random((nq, k)).astype(np.float32), axis=1)
    ret_d = gt_d * (1 + rng.random((nq, k)).astype(np.float32) * 0.2)
    return dict(ret=ret, gt=gt, ret_d=ret_d, gt_d=gt_d)


@pytest.mark.parametrize("k", [None, 1, 5])
def test_recall_at_k(results, k):
    assert peval.recall_at_k(results["ret"], results["gt"], k) == \
        jeval.recall_at_k(results["ret"], results["gt"], k)
    assert peval.recall_at_k(results["gt"], results["gt"], k) == 1.0


def test_top1_accuracy(results):
    assert peval.top1_accuracy(results["ret"], results["gt"]) == \
        jeval.top1_accuracy(results["ret"], results["gt"])


@pytest.mark.parametrize("ratios", [False, True])
def test_mean_average_precision(results, ratios):
    extra = (results["ret_d"], results["gt_d"]) if ratios else ()
    got = peval.mean_average_precision(results["ret"], results["gt"], *extra)
    assert got == jeval.mean_average_precision(results["ret"],
                                               results["gt"], *extra)
    assert ("avg_ratio" in got) == ratios


@pytest.mark.parametrize("eps", [1.0, 1.1])
def test_epsilon_recall(results, eps):
    assert peval.epsilon_recall(results["ret_d"], results["gt_d"], eps) == \
        jeval.epsilon_recall(results["ret_d"], results["gt_d"], eps)


def test_true_distances_and_evaluate(results):
    rng = np.random.default_rng(4)
    base = rng.normal(size=(500, 12)).astype(np.float32)
    q = rng.normal(size=(40, 12)).astype(np.float32)
    td = peval.true_distances(base, q, results["ret"])
    assert np.array_equal(td, jeval.true_distances(base, q, results["ret"]))
    args = (results["ret"], results["ret_d"], results["gt"],
            results["gt_d"])
    assert peval.evaluate(*args, base=base, queries=q) == \
        jeval.evaluate(*args, base=base, queries=q)


def test_code_hamming_hist():
    from deltapq_tpu.eval.metrics import code_hamming_hist as jhist
    from deltapq_tpu_torch.eval.metrics import code_hamming_hist

    rng = np.random.default_rng(5)
    a = rng.integers(0, 4, size=(200, 8))
    b = rng.integers(0, 4, size=(200, 8))
    assert np.array_equal(code_hamming_hist(a, b), jhist(a, b))


@pytest.mark.parametrize("dtype,tile", [(np.float32, 300), (np.uint8, 1000),
                                        (np.float32, 65536)])
def test_exact_topk_matches_jax(dtype, tile):
    rng = np.random.default_rng(6)
    base = (rng.normal(size=(2500, 24)) * 20 + 60).clip(0, 255).astype(dtype)
    q = (rng.normal(size=(9, 24)) * 20 + 60).astype(np.float32)
    jd, ji = jeval.exact_topk(q, base, top_k=20, tile_n=tile)
    d, i = peval.exact_topk(q, base, top_k=20, tile_n=tile, device=CPU)
    # |q|^2 - 2 q.x + |x|^2 in f32: the matmul's summation order differs
    np.testing.assert_allclose(d, jd, rtol=1e-4, atol=0.5)
    f64 = ((q[:, None, :].astype(np.float64)
            - base[None].astype(np.float64)) ** 2).sum(2)
    assert peval.recall_at_k(i, np.argsort(f64, axis=1)[:, :20]) > 0.98
    assert peval.recall_at_k(i, ji) > 0.98
    # a streamed database gives the same answer as the array
    it = (base[s:s + 700] for s in range(0, len(base), 700))
    d2, i2 = peval.exact_topk(q, it, top_k=20, device=CPU)
    np.testing.assert_allclose(d2, d, rtol=1e-4, atol=0.5)
