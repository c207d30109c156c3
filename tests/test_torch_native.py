"""The port's native C++ library (``deltapq_tpu_torch/native``) against
the JAX package's and against the port's own Python loops, on the
fixture of ``tests/test_native.py``: the same source, byte-equal
outputs, its own build directory, concurrent builds."""

import fcntl
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from deltapq_tpu import native as jnative
from deltapq_tpu.native import build as jbuild
from deltapq_tpu.tree import build_layout as j_build_layout
from deltapq_tpu.tree import find_edges_by_diff as j_find
from deltapq_tpu.tree import serialize_dtc as j_serialize_dtc
from deltapq_tpu_torch import native as pnative
from deltapq_tpu_torch.native import build as pbuild
from deltapq_tpu_torch.tree import layout as player
from deltapq_tpu_torch.tree import serialize as pser
from deltapq_tpu_torch.tree.build import find_edges_by_diff
from deltapq_tpu_torch.tree.traverse import scan_compressed

ROOT = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ unavailable")


@pytest.fixture(scope="module", autouse=True)
def jax_native_loaded():
    """Load the JAX package's library before the parity tests, under a
    lock shared by the test processes of this host.  Every process
    builds it to the same ``libdtc_native.so.tmp`` and renames that in,
    so pytest-xdist workers that collect ``tests/test_native.py`` at once
    (its ``have_native()`` builds at import) race: a worker whose rename
    finds the file already moved marks the library failed for good.  By
    the time tests run every collection has ended and the library is
    built, so a worker that lost the race loads it here."""
    lock = os.path.join(tempfile.gettempdir(),
                        "deltapq_tpu_native_build.lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            if jbuild._lib is None:
                jbuild._failed = False
            jbuild.get_lib()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


@pytest.fixture(scope="module")
def fx():
    rng = np.random.default_rng(9)
    n, M, K = 1200, 8, 16
    base = rng.integers(0, K, size=(30, M))
    codes = base[rng.integers(0, 30, n)]
    mut = rng.random((n, M)) < 0.1
    codes = np.where(mut, rng.integers(0, K, size=(n, M)), codes)
    codes = codes.astype(np.uint8)
    cw = rng.normal(size=(M, K, 4)).astype(np.float32)
    res = find_edges_by_diff(codes, K=K)
    tree = player.build_layout(codes, res.edges, res.root_id, K=K,
                               codewords=cw)
    stream = np.frombuffer(pser.serialize_dtc(tree), np.uint8)
    jres = j_find(codes, K=K)
    jtree = j_build_layout(codes, jres.edges, jres.root_id, K=K,
                           codewords=cw)
    assert stream.tobytes() == j_serialize_dtc(jtree)
    return codes, cw, tree, stream


def test_source_byte_equal_to_jax():
    a = (ROOT / "deltapq_tpu/native/dtc_native.cpp").read_bytes()
    assert pbuild.SRC.read_bytes() == a


def test_library_lands_under_build():
    assert pnative.have_native()
    lib = pbuild.lib_path()
    assert lib.exists()
    assert lib.parent.parent == ROOT / "deltapq_tpu_torch" / "_build"
    assert lib.parent.name.startswith("native-")
    assert not list(pbuild.SRC.parent.glob("*.so*"))


def test_two_processes_build_at_once(tmp_path):
    """Two fresh interpreters build a private copy of the source at the
    same moment (force=True, one target path) and both load it."""
    code = (
        "import sys, ctypes, pathlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from deltapq_tpu_torch.native import build as b\n"
        f"b.BUILD_DIR = pathlib.Path({str(tmp_path)!r})\n"
        "lib = b.build(force=True)\n"
        "b._bind(ctypes.CDLL(str(lib)))\n"
        "print('ok', lib)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.startswith("ok")
    libs = list(tmp_path.rglob("*.so"))
    assert len(libs) == 1 and not list(tmp_path.rglob("*.tmp"))


def test_decode_equal_to_jax_and_python(fx):
    codes, cw, tree, stream = fx
    nat = pnative.dtc_decode_native(stream, tree.n, tree.M)
    assert np.array_equal(nat, jnative.dtc_decode_native(stream, tree.n,
                                                         tree.M))
    assert np.array_equal(nat, pser.decode_dtc_to_codes(
        stream, tree.n, tree.M, use_native=False))
    assert np.array_equal(nat, pser.decode_dtc_to_codes(stream, tree.n,
                                                        tree.M))
    back = np.empty_like(codes)
    back[tree.vec_id.astype(np.int64)] = nat
    assert np.array_equal(back, codes)


def test_parse_equal_to_jax_and_python(fx):
    codes, cw, tree, stream = fx
    nat = pnative.dtc_parse_native(stream, tree.n, tree.M)
    jnat = jnative.dtc_parse_native(stream, tree.n, tree.M)
    py = pser.deserialize_dtc(stream, tree.n, tree.M, use_native=False)
    via = pser.deserialize_dtc(stream, tree.n, tree.M)
    for a, b, c, d in zip(nat, jnat, py, via):
        assert a.dtype == b.dtype == c.dtype == d.dtype
        assert np.array_equal(a, b) and np.array_equal(a, c)
        assert np.array_equal(a, d)


def test_scan_equal_to_jax_and_python_oracle(fx):
    codes, cw, tree, stream = fx
    rng = np.random.default_rng(1)
    M, K, Ds = cw.shape
    qs = rng.normal(size=(M, Ds)).astype(np.float32)
    table = ((qs[:, None, :] - cw) ** 2).sum(-1).astype(np.float32)
    d, i = pnative.scan_query_native(stream, tree.n, M, K, table, 10)
    jd, ji = jnative.scan_query_native(stream, tree.n, M, K, table, 10)
    assert d.tobytes() == jd.tobytes() and np.array_equal(i, ji)
    d_py, i_py = scan_compressed(stream, tree.n, M, table, 10)
    np.testing.assert_allclose(d, d_py, rtol=1e-5, atol=1e-5)
    assert set(i.tolist()) == set(np.asarray(i_py).tolist())


def test_dfs_layout_equal_to_jax_and_python(fx):
    codes, cw, tree, stream = fx
    n = tree.n
    parents = np.full(n, -1, np.int64)
    pos = tree.parent_pos[1:].astype(np.int64)
    parents[tree.vec_id[1:].astype(np.int64)] = tree.vec_id[pos]
    pos_of = np.empty(n, np.int64)
    pos_of[tree.vec_id.astype(np.int64)] = np.arange(n)
    child = np.flatnonzero(parents >= 0)
    par = parents[child]
    order = np.lexsort((pos_of[child], par))
    child_sorted = child[order].astype(np.uint32)
    offsets = np.concatenate([[0], np.cumsum(np.bincount(par[order],
                                                         minlength=n))])
    out = pnative.dfs_layout_native(n, child_sorted, offsets, tree.root_id)
    jout = jnative.dfs_layout_native(n, child_sorted, offsets, tree.root_id)
    for a, b in zip(out, jout):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(out[0], tree.vec_id)
    py = player._dfs_python(n, child_sorted.astype(np.int64),
                            offsets.astype(np.int64), tree.root_id)
    for a, b in zip(out[:3], py):
        assert np.array_equal(a, b)


def test_diff_index_decode_equal_to_jax_and_python(fx):
    codes = fx[0]
    stream = np.frombuffer(pser.serialize_diff_index(codes), np.uint8)
    nat = pnative.diff_index_decode_native(stream, len(codes), 8)
    assert np.array_equal(nat, jnative.diff_index_decode_native(
        stream, len(codes), 8))
    assert np.array_equal(nat, pser.decode_diff_index(stream, len(codes), 8))
    assert np.array_equal(nat, codes)


def test_build_layout_takes_the_native_dfs(fx, monkeypatch):
    """With the library present the Python DFS never runs, and the tree
    equals the one the Python DFS builds."""
    codes, cw, tree, stream = fx
    res = find_edges_by_diff(codes, K=16)

    def refuse(*a):
        raise AssertionError("the Python DFS ran")

    with monkeypatch.context() as m:
        m.setattr(player, "_dfs_python", refuse)
        t_nat = player.build_layout(codes, res.edges, res.root_id, K=16,
                                    codewords=cw)
    monkeypatch.setattr(player, "dfs_layout_native", lambda *a: None)
    t_py = player.build_layout(codes, res.edges, res.root_id, K=16,
                               codewords=cw)
    for name in ("vec_id", "parent_pos", "depth", "diff_to", "child_num"):
        a, b = getattr(t_nat, name), getattr(t_py, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_native_error_raises(fx):
    """A malformed stream raises ValueError through the decoders; the
    Python loops run only when the library is unavailable."""
    codes, cw, tree, stream = fx
    with pytest.raises(ValueError):
        pser.decode_dtc_to_codes(stream[:len(stream) // 2], tree.n, tree.M)
    with pytest.raises(ValueError):
        pser.deserialize_dtc(stream[:len(stream) // 2], tree.n, tree.M)
