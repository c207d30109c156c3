"""The port's stream-tile builder against the JAX package's: the tiles
must be byte-identical, so both packages scan the same bytes."""

import numpy as np
import pytest
import torch

from deltapq_tpu.ops import stream_tiles as jst
from deltapq_tpu.ops.delta_tiles import _mask_planes as j_mask_planes
from deltapq_tpu_torch.ops import stream_tiles as pst
from deltapq_tpu_torch.ops.fused_kernels import decode_stream_tiles_torch

from _torch_port import structured_codes


@pytest.mark.parametrize("n,M,K", [(5000, 8, 256), (1024, 8, 256),
                                   (1, 8, 256), (1025, 4, 32),
                                   (3000, 16, 256), (777, 4, 32)])
def test_stream_tiles_byte_equal(n, M, K):
    codes = structured_codes(np.random.default_rng(n + M), n, M, K)
    a = jst.build_stream_tiles(codes)
    b = pst.build_stream_tiles(codes)
    for name in ("row_data", "vals", "meta"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name
    assert (a.n_valid, a.M, a.e_max) == (b.n_valid, b.M, b.e_max)
    assert a.bytes_per_vec() == b.bytes_per_vec()
    assert np.array_equal(pst.decode_stream_tiles(b), codes)


@pytest.mark.parametrize("M", [4, 8, 13])
def test_mask_planes_equal(M):
    bits = np.random.default_rng(M).random((300, M)) < 0.4
    assert np.array_equal(pst._mask_planes(bits), j_mask_planes(bits))


def test_window_and_capacity_equal():
    for M in (4, 8, 16):
        for e in (8, 1000, 9000):
            assert pst.window_groups(M, e) == jst.window_groups(M, e)
    with pytest.raises(ValueError):
        pst.check_stream_capacity(2 ** 31)


@pytest.mark.parametrize("M", [4, 8])
def test_torch_decode_matches_numpy_oracle(M):
    codes = structured_codes(np.random.default_rng(7), 4100, M, 256)
    st = pst.build_stream_tiles(codes)
    got = decode_stream_tiles_torch(torch.from_numpy(st.row_data),
                                    torch.from_numpy(st.vals),
                                    torch.from_numpy(st.meta), M)
    assert np.array_equal(got[:len(codes)].numpy(), codes)
    # padding rows repeat the last row
    assert (got[len(codes):].numpy() == codes[-1]).all()
