"""The reference's legacy bit-interleaved store and prefix-tree query
(counterpart of ``deltapq_tpu/legacy``)."""

from .prefix_tree import (BitVecsStore, dichotomize_codewords,
                          interleave_codes, deinterleave_codes,
                          prefix_tree_query)

__all__ = ["BitVecsStore", "dichotomize_codewords", "interleave_codes",
           "deinterleave_codes", "prefix_tree_query"]
