"""The port's DeltaTree build and DFS layout against the JAX package's
(NumPy in both): same edges, root and heights, same DFS order."""

import numpy as np
import pytest

from deltapq_tpu.tree.build import find_edges_by_diff as j_find
from deltapq_tpu.tree.layout import build_layout as j_layout
from deltapq_tpu_torch.synth import chain_codes
from deltapq_tpu_torch.tree.build import find_edges_by_diff
from deltapq_tpu_torch.tree.layout import build_layout

from _torch_port import structured_codes


def _codes(kind, M, K):
    if kind == "chain":
        return chain_codes(3000, M=M, K=K, seed=3)
    return structured_codes(np.random.default_rng(11), 4000, M, K)


@pytest.mark.parametrize("kind,M,K,method", [
    ("structured", 8, 256, 1), ("structured", 8, 256, 2),
    ("structured", 4, 32, 1), ("chain", 8, 256, 1),
    ("structured", 12, 16, 1)])
def test_edges_and_dfs_equal(kind, M, K, method):
    codes = _codes(kind, M, K)
    a = j_find(codes, K=K, method=method)
    b = find_edges_by_diff(codes, K=K, method=method)
    assert np.array_equal(a.edges, b.edges)
    assert a.root_id == b.root_id and a.n_diffs == b.n_diffs
    assert np.array_equal(a.heights, b.heights)
    assert np.array_equal(a.finalists, b.finalists)
    ta = j_layout(codes, a.edges, a.root_id, K=K, tables="skip")
    tb = build_layout(codes, b.edges, b.root_id, K=K, tables="skip")
    for name in ("vec_id", "parent_pos", "depth", "diff_num", "diff_off",
                 "diff_m", "diff_to", "child_pos_start", "child_num",
                 "max_dist", "max_dist2p"):
        x, y = getattr(ta, name), getattr(tb, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert np.array_equal(tb.decode_codes(), codes)      # lossless


def test_unported_options_raise():
    codes = _codes("structured", 4, 32)
    with pytest.raises(NotImplementedError):
        find_edges_by_diff(codes, K=32, method=3)
    res = find_edges_by_diff(codes, K=32)
    # the table-driven build is ported: without codewords or tables it
    # refuses, as the JAX package's does
    with pytest.raises(ValueError):
        build_layout(codes, res.edges, res.root_id, K=32, tables=None)
