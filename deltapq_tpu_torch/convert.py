"""Carry engine and index state across from the JAX package.

``deltapq_tpu.ops.fused.FusedCompressedEngine.save`` writes an ``.npz``
with ``codewords``, ``row_data``, ``n_valid``, ``M``, ``fmt``,
``row_to_db`` and the tiles' own arrays: ``vals``, ``meta``, ``e_max``
for stream tiles, ``ovf``, ``S``, ``Cap`` for slot tiles.  A file without
``fmt`` holds slot tiles (the engines of the first format wrote none), as
the JAX ``load`` reads it.  ``load_jax_engine`` builds the port's engine
from those arrays, on the same tiles, so the two engines can be held
against each other.

The JAX file does not record its precision (its ``load`` rebuilds at
bf16); the port's own ``save`` adds ``precision`` and ``load`` honours
it.  Both engine functions take ``precision=None`` by default: the
file's own precision, or int16 (the port's default) for a file without
one.

``deltapq_tpu.index.DeltaPQIndex.save`` writes a directory that the
port's ``DeltaPQIndex.load`` reads as it is (``load_jax_index``).
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np

from . import resolve_device
from .index import DeltaPQIndex
from .ops.adc_kernels import TileDictEngine
from .ops.decoded import DecodedEngine
from .ops.delta_tiles import DeltaTiles
from .ops.fused import FusedCompressedEngine
from .ops.stream_tiles import StreamTiles


def engine_state_from_numpy(d: Mapping[str, np.ndarray],
                            precision: Optional[str] = None,
                            device=None) -> FusedCompressedEngine:
    """Port engine from the arrays a JAX (or port) ``save`` wrote.
    ``precision=None`` takes the file's own, else int16."""
    fmt = str(d["fmt"]) if "fmt" in d else "slots"
    if precision is None:
        precision = str(d["precision"]) if "precision" in d else "int16"
    if fmt == "stream":
        tiles = StreamTiles(row_data=np.asarray(d["row_data"]),
                            vals=np.asarray(d["vals"]),
                            meta=np.asarray(d["meta"], np.int32),
                            n_valid=int(d["n_valid"]), M=int(d["M"]),
                            e_max=int(d["e_max"]))
    elif fmt == "slots":
        tiles = DeltaTiles(row_data=np.asarray(d["row_data"]),
                           ovf=np.asarray(d["ovf"]),
                           n_valid=int(d["n_valid"]), M=int(d["M"]),
                           S=int(d["S"]), Cap=int(d["Cap"]))
    else:
        raise ValueError(f"unknown delta-tile format {fmt!r}")
    rtd = np.asarray(d["row_to_db"])
    return FusedCompressedEngine.from_tiles(
        np.asarray(d["codewords"], np.float32), tiles,
        row_to_db=rtd if len(rtd) else None, precision=precision,
        device=device)


def load_jax_engine(path: str, precision: Optional[str] = None,
                    device=None) -> FusedCompressedEngine:
    """Read an engine ``.npz`` (``np.savez`` appends the suffix)."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        return engine_state_from_numpy(dict(z), precision=precision,
                                       device=device)


def load_jax_index(path: str, device=None) -> DeltaPQIndex:
    """Open an index directory the JAX package saved (``index.npz``,
    ``config.json``, ``compressed.dtc``, ``tree_soa.npz``): the port
    reads that layout as it is, so this is ``DeltaPQIndex.load``."""
    return DeltaPQIndex.load(path, device=device)


def load_jax_decoded_engine(path: str, device=None) -> DecodedEngine:
    """Open a decoded cache the JAX package's ``DecodedEngine.save``
    wrote: the port keeps that ``.npz`` layout, so this is
    ``DecodedEngine.load``."""
    return DecodedEngine.load(path, device=device)


def tile_dict_state_from_numpy(codewords, dicts, idx, codes_reordered,
                               row_to_db, n_valid: int, tile_n: int = 2048,
                               device=None) -> TileDictEngine:
    """A ``TileDictEngine`` from the arrays of the JAX engine (its
    ``codewords``, ``dicts``, ``idx``, ``codes_reordered``, ``row_to_db``
    and ``n_valid``), so both engines answer from the same state."""
    eng = TileDictEngine.__new__(TileDictEngine)
    eng.device = resolve_device(device)
    eng.n_valid = int(n_valid)
    eng.order = np.asarray(row_to_db, np.int64)[:eng.n_valid]
    eng.ok = True
    eng._set_state(codewords, np.asarray(dicts), np.asarray(idx),
                   np.asarray(codes_reordered), np.asarray(row_to_db),
                   tile_n)
    return eng
