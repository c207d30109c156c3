"""Reference-format file I/O: TEXMEX vectors, codes, codewords,
groundtruth and the staged-artifact cache (NumPy copies of
``deltapq_tpu/io``)."""

from .vecs import (read_vecs, read_vecs_at, write_vecs, iter_vec_batches,
                   num_vectors, read_dim)
from .codewords import read_codewords, write_codewords
from .codes import read_codes, write_codes
from .groundtruth import read_groundtruth, write_groundtruth
from .artifacts import ArtifactCache, config_key

__all__ = [
    "read_vecs", "read_vecs_at", "write_vecs", "iter_vec_batches",
    "num_vectors", "read_dim",
    "read_codewords", "write_codewords", "read_codes", "write_codes",
    "read_groundtruth", "write_groundtruth", "ArtifactCache", "config_key",
]
