"""The benchmark's inputs, made on the device from the seed.

Vectors are Gaussian mixtures (a configuration's ``data`` block: centres
drawn normal times ``scale``, each row a centre plus N(0, sigma^2)
noise), as ``bench.py``'s ``sift_like`` recipe and ``chip_smoke.py``
phase 14's near-distinct GIST recipe draw them.  The codebook is learned
by plain k-means (Lloyd) on held-out learn rows and the base is encoded
with it.  Every step is deterministic for a seed on a given device: the
cluster sums are one-hot matrix products, not atomic adds.

Plain torch only; nothing of the program is imported here.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import numpy as np
import torch

#: one stream of random numbers per kind of draw, so that adding a draw
#: to one traffic mix leaves every other draw of the seed unchanged
STREAMS = {"centres": 1, "base": 2, "learn": 3, "queries": 4,
           "ood_centres": 5, "ood_queries": 6, "kmeans": 7}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator for one stream of one seed (any integer seed)."""
    mixed = (int(seed) * 1_000_003 + STREAMS[stream] * 7_919) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """f32 matrix products at full f32 precision (TF32 off), restored on
    exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def centres(gen, n: int, dim: int, scale: float, device) -> torch.Tensor:
    return torch.randn(n, dim, generator=gen, device=device) * scale


def draw(gen, c: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """``n`` rows: a centre of ``c`` drawn uniformly, plus noise."""
    pick = torch.randint(0, c.shape[0], (n,), generator=gen,
                         device=c.device)
    noise = torch.randn(n, c.shape[1], generator=gen, device=c.device)
    return c[pick] + noise * sigma


def _assign(xs: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
    """Nearest codeword per subspace: xs [M, r, Ds], cw [M, K, Ds] ->
    labels [M, r]."""
    c2 = (cw * cw).sum(-1)                                   # [M, K]
    d = torch.baddbmm(c2[:, None, :], xs, cw.transpose(1, 2), alpha=-2.0)
    return d.argmin(-1)


def learn_codebook(x: torch.Tensor, M: int, K: int, iters: int,
                   gen: torch.Generator, chunk: int = 65536
                   ) -> torch.Tensor:
    """Plain PQ k-means: ``iters`` Lloyd iterations per subspace from K
    distinct learn rows.  An empty cluster keeps its codeword.  Returns
    codewords f32 [M, K, Ds]."""
    n, D = x.shape
    if D % M:
        raise ValueError(f"D={D} is not a multiple of M={M}")
    Ds = D // M
    xs = x.reshape(n, M, Ds).transpose(0, 1).contiguous()    # [M, n, Ds]
    init = torch.randperm(n, generator=gen, device=x.device)[:K]
    cw = xs[:, init, :].clone()
    with full_f32():
        for _ in range(iters):
            sums = torch.zeros_like(cw)
            counts = torch.zeros(M, K, device=x.device)
            for r0 in range(0, n, chunk):
                xb = xs[:, r0:r0 + chunk]
                oh = torch.nn.functional.one_hot(
                    _assign(xb, cw), K).to(torch.float32)    # [M, r, K]
                sums += torch.bmm(oh.transpose(1, 2), xb)
                counts += oh.sum(1)
            cw = torch.where(counts[..., None] > 0,
                             sums / counts.clamp(min=1)[..., None], cw)
    return cw


def encode(x: torch.Tensor, cw: torch.Tensor, chunk: int = 65536
           ) -> torch.Tensor:
    """PQ codes u8 [n, M] of rows x [n, D] under codewords [M, K, Ds]."""
    M, K, Ds = cw.shape
    out = torch.empty(x.shape[0], M, dtype=torch.uint8, device=x.device)
    with full_f32():
        for r0 in range(0, x.shape[0], chunk):
            xb = x[r0:r0 + chunk].reshape(-1, M, Ds).transpose(0, 1)
            out[r0:r0 + chunk] = _assign(xb.contiguous(), cw).t().to(
                torch.uint8)
    return out


def make_inputs(config: dict, traffic: dict, seed: int, device
                ) -> Dict[str, np.ndarray]:
    """Everything both sides get, as host arrays: ``codewords`` f32 [M, K,
    Ds], ``codes`` u8 [N, M] (database order) and ``queries`` f32 [nq, D].

    The mixture has one centre per ``rows_per_centre`` base rows.  Learn
    rows and queries are held-out draws of it, or with the traffic's
    ``queries: "ood"`` the queries are drawn around fresh centres (one per
    ``ood_rows_per_centre`` queries) from a stream of their own.  Device
    memory the draws took is released before returning."""
    dev = torch.device(device)
    dat = config["data"]
    D, M, K = config["D"], config["M"], config["K"]
    n_centres = max(1, config["n_base"] // dat["rows_per_centre"])
    c = centres(generator(seed, "centres", dev), n_centres, D,
                dat["scale"], dev)
    learn = draw(generator(seed, "learn", dev), c, config["n_learn"],
                 dat["sigma"])
    cw = learn_codebook(learn, M, K, config["kmeans_iters"],
                        generator(seed, "kmeans", dev))
    del learn
    base = draw(generator(seed, "base", dev), c, config["n_base"],
                dat["sigma"])
    codes = encode(base, cw)
    del base
    nq = traffic.get("n_queries", config["n_queries"])
    if traffic.get("queries", "held_out") == "ood":
        c = centres(generator(seed, "ood_centres", dev),
                    max(1, nq // traffic["ood_rows_per_centre"]), D,
                    dat["scale"], dev)
        q = draw(generator(seed, "ood_queries", dev), c, nq, dat["sigma"])
    else:
        q = draw(generator(seed, "queries", dev), c, nq, dat["sigma"])
    out = {"codewords": cw.cpu().numpy(), "codes": codes.cpu().numpy(),
           "queries": q.cpu().numpy()}
    del c, q, cw, codes
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out
