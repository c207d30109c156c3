"""The port's flagship step (``deltapq_tpu_torch.entry``) against the
JAX package's (``__graft_entry__.entry``, its Pallas kernels in
interpret mode) at their own shapes: the same inputs, distances within
rtol 1e-5, atol 1e-4, rows up to f64-audited ties, and exact where the
certificate holds."""

import numpy as np
import torch

import __graft_entry__ as jentry
from deltapq_tpu_torch import entry as pentry
from deltapq_tpu_torch.ops.adc import adc_query_topk, adc_table
from deltapq_tpu_torch.ops.delta_tiles import decode_delta_tiles, DeltaTiles

from _torch_port import CPU, assert_ids_up_to_ties


def test_entry_matches_jax():
    fwd, args = pentry.entry(device=CPU)
    d, rows, ok = pentry.step(*args)
    jfwd, jargs = jentry.entry()
    jd, jrows = (np.asarray(a) for a in jfwd(*jargs))
    for a, j in zip(args, jargs):                     # the same inputs
        a = a.float() if a.dtype == torch.bfloat16 else a
        assert np.array_equal(a.numpy(), np.asarray(j).astype(a.numpy().dtype))
    d2, rows2 = fwd(*args)
    assert torch.equal(d2, d) and torch.equal(rows2, rows)
    d, rows, ok = d.numpy(), rows.numpy(), ok.numpy()
    assert d.shape == (pentry.B, pentry.TOP_K) == jd.shape
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)
    rd, ovf = args[4].numpy(), args[5].numpy()
    tiles = DeltaTiles(row_data=rd, ovf=ovf, n_valid=pentry.N, M=pentry.M,
                       S=rd.shape[1] - 1, Cap=ovf.shape[2])
    codes = decode_delta_tiles(tiles)
    table = adc_table(args[0], args[1])
    assert_ids_up_to_ties(table.numpy(), codes, rows, jrows, pentry.TOP_K)
    ed, _ = adc_query_topk(table, torch.from_numpy(codes), pentry.N,
                           pentry.TOP_K, 1024)
    assert ok.mean() > 0.9
    assert np.array_equal(d[ok], ed.numpy()[ok])
