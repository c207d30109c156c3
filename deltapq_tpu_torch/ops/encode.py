"""PQ encoding: nearest centroid per subspace, in plain PyTorch.

Counterpart of ``deltapq_tpu/ops/encode.py``: per subspace the distance
matrix is a matmul and the code is an argmin over K, ties to the lowest
centroid id.
"""

from __future__ import annotations

import numpy as np
import torch

from .adc import no_tf32


def _encode_batch(codewords: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """codewords f32 [M, K, Ds], x f32 [n, M*Ds] -> codes [n, M] int64."""
    M, K, Ds = codewords.shape
    xs = x.reshape(x.shape[0], M, Ds)
    # d2 = |x|^2 - 2 x.c + |c|^2; |x|^2 is constant in k
    with no_tf32():
        cross = torch.einsum("nmd,mkd->nmk", xs, codewords)
    c2 = torch.sum(codewords * codewords, dim=2)
    return torch.argmin(c2[None] - 2.0 * cross, dim=2)


def pq_encode(codewords: torch.Tensor, vecs, batch_size: int = 131072
              ) -> torch.Tensor:
    """Encode vectors (NumPy array or tensor) -> PQ codes [N, M] on the
    codewords' device: uint8 for K <= 256, int32 above.  Short vectors
    are zero-padded; batches bound device memory."""
    M, K, Ds = codewords.shape
    D = M * Ds
    dev = codewords.device
    out_dtype = torch.uint8 if K <= 256 else torch.int32
    if vecs.shape[1] > D:
        raise ValueError(f"vector dim {vecs.shape[1]} > codebook dim {D}")
    chunks = []
    for off in range(0, vecs.shape[0], batch_size):
        xb = vecs[off:off + batch_size]
        if not isinstance(xb, torch.Tensor):
            xb = torch.from_numpy(np.ascontiguousarray(xb))
        xb = xb.to(device=dev, dtype=torch.float32)
        if xb.shape[1] < D:
            xb = torch.nn.functional.pad(xb, (0, D - xb.shape[1]))
        chunks.append(_encode_batch(codewords, xb).to(out_dtype))
    if not chunks:
        return torch.empty((0, M), dtype=out_dtype, device=dev)
    return torch.cat(chunks, dim=0)


def pq_decode(codewords: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct vectors [N, M*Ds] from codes [N, M]."""
    M = codewords.shape[0]
    idx = codes.to(torch.int64)
    return torch.cat([codewords[m][idx[:, m]] for m in range(M)], dim=1)
