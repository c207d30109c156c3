"""The decoded cache: PQ codes -> bf16 x^ rows for the decoded tier.

A copy of ``build_decoded_cache`` from ``deltapq_tpu/ops/decoded.py``
(the rest of that module, ``DecodedEngine``, is not ported yet: ROADMAP
A10).  NumPy has no bf16, so the rounding is a torch cast, which rounds
to nearest even as ``ml_dtypes`` does; the tests hold hi and lo
bit-equal to the JAX package's.

The ADC distance decomposes exactly: dist[n, b] = ||q_b||^2 + ||x^_n||^2
- 2 x^_n . q_b, with x^_n the concatenated centroids of row n.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def build_decoded_cache(codewords: np.ndarray, codes: np.ndarray,
                        batch: int = 262144, center=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Returns (xhat_hi bf16 [N, D], xhat_lo bf16 [N, D], precomp f32
    [N]) with the two bf16 arrays as CPU tensors: hi + lo reproduces
    the f32 decoded vector to ~2^-18 relative.  ``center`` (f32 [D]) is
    subtracted before the bf16 split; precomp stays the uncentered
    norm."""
    codewords = np.asarray(codewords, np.float32)
    M, K, Ds = codewords.shape
    c2 = np.sum(codewords * codewords, axis=2)  # [M, K]
    n = codes.shape[0]
    D = M * Ds
    hi = torch.empty((n, D), dtype=torch.bfloat16)
    lo = torch.empty((n, D), dtype=torch.bfloat16)
    precomp = np.zeros(n, np.float32)
    for off in range(0, n, batch):
        c = np.asarray(codes[off:off + batch]).astype(np.int64)
        x = np.empty((len(c), D), np.float32)
        for m in range(M):
            x[:, m * Ds:(m + 1) * Ds] = codewords[m][c[:, m]]
            precomp[off:off + batch] += c2[m][c[:, m]]
        if center is not None:
            x = x - center[None, :]
        xt = torch.from_numpy(x)
        h = xt.to(torch.bfloat16)
        hi[off:off + batch] = h
        lo[off:off + batch] = (xt - h.to(torch.float32)).to(torch.bfloat16)
    return hi, lo, precomp
