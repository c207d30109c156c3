"""Decoded-cache ADC engine: PQ codes -> bf16 x^ rows, scanned by dense
matrix products.

Counterpart of ``deltapq_tpu/ops/decoded.py``.  The ADC distance
decomposes exactly (quadratic expansion):

    dist[n, b] = sum_m T[b, m, codes[n, m]]
               = ||q_b||^2 + precomp[n] - 2 * (x^_n . q_b)

with x^_n the concatenated centroids of row n and ``precomp[n] = sum_m
||c_{m, codes[n, m]}||^2``.  The scan is a dense [B, D] x [D, N] product
with no gathers at query time; it costs D*4 bytes a vector (bf16 hi +
lo) against M bytes of codes.  The JAX package computes this tier in
XLA, outside any Pallas kernel, so here it is plain PyTorch: its matrix
products go to ``torch.mm``.

Exactness: the products of bf16 pairs are exact in f32 and are summed in
f32, which gives the cross term to ~2^-18 relative at ``"bf16x2"``; the
shortlist is then reranked with exact f32 table lookups, so reported
distances equal the plain ADC scan's.

``build_decoded_cache`` is a copy of the JAX function.  NumPy has no
bf16, so the rounding is a torch cast, which rounds to nearest even as
``ml_dtypes`` does; the tests hold hi and lo bit-equal to the JAX
package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from .adc import adc_table, no_tf32, pad_codes
from .adc_kernels import _exact_dists_for_ids


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


_mm_out_dtype: Optional[bool] = None     # torch.mm takes out_dtype (CUDA)


def _cross_f32(q: torch.Tensor, xhat: torch.Tensor) -> torch.Tensor:
    """q [B, D] bf16 x xhat [N, D] bf16 -> f32 [B, N] with the bf16
    products summed in f32.  ``torch.mm`` of two bf16 tensors rounds its
    result to bf16, so on a card the product is asked for an f32 result
    where this PyTorch's ``torch.mm`` takes ``out_dtype``; otherwise, and
    on the CPU, both operands are widened and multiplied in f32 with TF32
    off.  Both sum the same exact products; only the order differs."""
    global _mm_out_dtype
    if q.device.type == "cuda" and _mm_out_dtype is not False:
        try:
            out = torch.mm(q, xhat.t(), out_dtype=torch.float32)
            _mm_out_dtype = True
            return out
        except TypeError:
            if _mm_out_dtype:
                raise
            _mm_out_dtype = False        # this PyTorch has no out_dtype
    with no_tf32():
        return torch.mm(q.to(torch.float32), xhat.to(torch.float32).t())


def decoded_topk(xhat_hi: torch.Tensor, xhat_lo: torch.Tensor,
                 precomp: torch.Tensor, table: torch.Tensor,
                 codes: torch.Tensor, queries: torch.Tensor, n_valid: int,
                 top_k: int, precision: str = "bf16x2",
                 exact_select: bool = False, rerank: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full decoded-tier query: whole-array matmul + shortlist + rerank.

    xhat_* [N_pad, D] bf16; precomp [N_pad] f32 with **+inf on padding
    rows** (the validity mask folded into the distance assembly); table
    [B, M, K] (for the exact rerank); codes [N_pad, M]; queries [B, D]
    f32.  Returns (dists [B, top_k] f32 ascending, ids i32).

    precision: "bf16x2" -- three bf16 products reproduce the f32 cross
    term to ~2^-18 relative; "bf16" -- one product, ~2^-8 shortlisting
    error.  rerank=True recomputes the shortlist's distances with exact
    f32 table lookups; rerank=False reports the matmul-domain distances.
    The shortlist of min(max(16 * top_k, 64), 2048, N) rows is selected
    exactly whatever ``exact_select`` says (the JAX function's default
    is an approximate accelerator op of the TPU)."""
    if precision not in ("bf16x2", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    N = xhat_hi.shape[0]
    shortlist = min(max(16 * top_k, 64), 2048, N)

    q_hi = queries.to(torch.bfloat16)
    q_lo = (queries - q_hi.to(torch.float32)).to(torch.bfloat16)
    q2 = torch.sum(queries * queries, dim=1)               # [B]

    d = _cross_f32(q_hi, xhat_hi)                          # [B, N]
    if precision == "bf16x2":
        d.add_(_cross_f32(q_lo, xhat_hi))
        d.add_(_cross_f32(q_hi, xhat_lo))
    # in place: d is the one [B, N] f32 array this function holds
    d = d.mul_(-2.0).add_(precomp[None, :]).add_(q2[:, None])
    cand_d, cand_i = torch.topk(d, shortlist, dim=1, largest=False,
                                sorted=True)
    del d
    if not rerank:
        return cand_d[:, :top_k], cand_i[:, :top_k].to(torch.int32)

    # exact rerank of the shortlist: one gather sum in ascending m
    exact = _exact_dists_for_ids(table, codes, cand_i)
    exact = torch.where(torch.isfinite(cand_d), exact,
                        torch.full_like(exact, float("inf")))
    srt, pos = torch.sort(exact, dim=1, stable=True)
    return (srt[:, :top_k],
            torch.gather(cand_i, 1, pos[:, :top_k]).to(torch.int32))


class DecodedEngine:
    """Stateful wrapper holding the device-resident decoded cache."""

    def __init__(self, codewords: np.ndarray, codes: np.ndarray,
                 precision: str = "bf16x2", device=None):
        self.device = resolve_device(device)
        codewords = np.asarray(codewords, np.float32)
        self.n_valid = codes.shape[0]
        self.precision = precision
        codes_p = pad_codes(np.asarray(codes), 1024)
        hi, lo, pre = build_decoded_cache(codewords, codes_p)
        pre[self.n_valid:] = np.inf  # fold validity mask into precomp
        self._set_state(codewords, hi, lo, pre, codes_p)

    def _set_state(self, codewords, hi, lo, pre, codes_p):
        dev = self.device
        self.codewords = torch.from_numpy(
            np.ascontiguousarray(codewords, np.float32)).to(dev)
        M, K, Ds = self.codewords.shape
        self.D = M * Ds
        self.xhat_hi = hi.to(dev)
        self.xhat_lo = lo.to(dev)
        self.precomp = torch.from_numpy(np.ascontiguousarray(pre)).to(dev)
        self.codes = torch.from_numpy(np.ascontiguousarray(codes_p)).to(dev)

    def query(self, queries: np.ndarray, top_k: int = 10
              ) -> Tuple[np.ndarray, np.ndarray]:
        q = np.asarray(queries, np.float32)
        if q.shape[1] < self.D:
            q = np.pad(q, ((0, 0), (0, self.D - q.shape[1])))
        qd = torch.from_numpy(q).to(self.device)
        table = adc_table(self.codewords, qd)
        d, i = decoded_topk(self.xhat_hi, self.xhat_lo, self.precomp,
                            table, self.codes, qd, self.n_valid, top_k,
                            self.precision)
        return d.cpu().numpy(), i.cpu().numpy()

    def save(self, path: str) -> None:
        """Persist the decoded cache in the JAX package's ``.npz`` layout
        (bf16 stored as ``uint16`` views), so each package loads the
        other's file."""
        np.savez(path,
                 xhat_hi=self.xhat_hi.cpu().view(torch.int16).numpy()
                 .view(np.uint16),
                 xhat_lo=self.xhat_lo.cpu().view(torch.int16).numpy()
                 .view(np.uint16),
                 precomp=self.precomp.cpu().numpy(),
                 codes=self.codes.cpu().numpy(),
                 codewords=self.codewords.cpu().numpy(),
                 n_valid=self.n_valid, precision=self.precision)

    @classmethod
    def load(cls, path: str, device=None) -> "DecodedEngine":
        with np.load(path, allow_pickle=False) as z:
            self = cls.__new__(cls)
            self.device = resolve_device(device)
            self.n_valid = int(z["n_valid"])
            self.precision = str(z["precision"])
            hi, lo = (torch.from_numpy(z[k].view(np.int16))
                      .view(torch.bfloat16) for k in ("xhat_hi", "xhat_lo"))
            self._set_state(z["codewords"], hi, lo, z["precomp"],
                            z["codes"])
        return self
