"""Where the port's API had drifted from the JAX package's: the dedup
tier's lazily built inner engine, ``StreamTiles.n_tiles`` / ``n_pad``,
and ``use_native`` on the DTC decoders."""

import inspect

import numpy as np

from deltapq_tpu.ops import fused as jfused
from deltapq_tpu.ops import stream_tiles as jst
from deltapq_tpu.tree import serialize as jser
from deltapq_tpu_torch.ops import fused as pfused
from deltapq_tpu_torch.ops import stream_tiles as pst
from deltapq_tpu_torch.tree import serialize as pser

from _torch_port import CPU, codebook, structured_codes


def test_dedup_engine_is_built_on_first_access():
    rng = np.random.default_rng(0)
    cw = codebook(rng, 8, 16, 4)
    codes = structured_codes(rng, 3000, 8, 16)
    q = rng.normal(size=(8, 32)).astype(np.float32)
    e = pfused.DedupCompressedEngine(cw, codes, device=CPU)
    je = jfused.DedupCompressedEngine(cw, codes)
    assert e._codes_pad is not None and e._engine is None
    d, i = e.query(q, top_k=5)
    assert e._engine is None                      # the query never built it
    inner, jinner = e.engine, je.engine
    assert isinstance(inner, pfused.FusedCompressedEngine)
    assert inner.precision == "int8" == jinner.precision
    assert e.engine is inner                      # built once
    assert inner.n_valid == jinner.n_valid == e.n_unique
    assert np.array_equal(inner.tiles.row_data, np.asarray(jinner.tiles.row_data))
    d2, i2 = e.query(q, top_k=5)                  # still exact-all
    assert np.array_equal(d, d2) and np.array_equal(i, i2)
    assert e.bytes_per_vec() == je.bytes_per_vec()


def test_stream_tiles_count_and_padding():
    codes = structured_codes(np.random.default_rng(1), 2500, 8, 256)
    t, jt = pst.build_stream_tiles(codes), jst.build_stream_tiles(codes)
    assert t.n_tiles == jt.n_tiles == 3
    assert t.n_pad == jt.n_pad == 3 * pst.TILE


def test_decoders_take_use_native():
    for name in ("deserialize_dtc", "decode_dtc_to_codes"):
        p = inspect.signature(getattr(pser, name)).parameters["use_native"]
        jp = inspect.signature(getattr(jser, name)).parameters["use_native"]
        assert p.default is True and jp.default is True
