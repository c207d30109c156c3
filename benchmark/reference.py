"""The plain reference: exact ADC top-k, and the lower-precision control.

Plain torch; it imports nothing of the program and takes nothing the
program made.  From the benchmark's own codewords [M, K, Ds], codes
[N, M] (database order) and queries [Q, D]:

- ``exact_topk``: the top-k by the ADC distance sum_m ||q_m - c_m,code||^2,
  computed in float64 from direct differences, over blocks of queries
  and rows so that it fits beside nothing else;
- ``dists_of``: the same float64 distance of given ids, to judge the ids
  a search returned;
- ``control_topk``: the reference put in the program's place one step
  below the precision the configurations state (an f32 table whose cross
  term is a matrix product with TF32 off): the cross term's operands
  rounded to TF32 (10 mantissa bits, nearest even), as a TF32 matrix
  product takes them, with f32 sums and an f32 top-k.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _table64(cw: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[Qb, M, K] float64 squared distances of query slices to codewords."""
    M, K, Ds = cw.shape
    diff = q.reshape(-1, M, 1, Ds) - cw[None]
    return (diff * diff).sum(-1)


def _gather_sum(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[Qb, R]: sum over m of table[:, m, codes[:, m]], ascending m."""
    idx = codes.to(torch.int64)
    acc = torch.zeros(table.shape[0], codes.shape[0], dtype=table.dtype,
                      device=table.device)
    for m in range(table.shape[1]):
        acc += table[:, m, :].index_select(1, idx[:, m])
    return acc


def _blocks(n: int, size: int):
    for s in range(0, n, size):
        yield s, min(n, s + size)


def _topk_blocks(table_fn, codes: torch.Tensor, n_q: int, k: int,
                 q_block: int, r_block: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k over row blocks for each block of queries."""
    dev = codes.device
    d_out, i_out = [], []
    for q0, q1 in _blocks(n_q, q_block):
        table = table_fn(q0, q1)
        best_d = torch.full((q1 - q0, 0), float("inf"), dtype=table.dtype,
                            device=dev)
        best_i = torch.zeros((q1 - q0, 0), dtype=torch.int64, device=dev)
        for r0, r1 in _blocks(codes.shape[0], r_block):
            d = _gather_sum(table, codes[r0:r1])
            ids = torch.arange(r0, r1, device=dev).expand(q1 - q0, -1)
            d = torch.cat([best_d, d], 1)
            ids = torch.cat([best_i, ids], 1)
            kk = min(k, d.shape[1])
            best_d, pos = torch.topk(d, kk, dim=1, largest=False,
                                     sorted=True)
            best_i = torch.gather(ids, 1, pos)
        d_out.append(best_d)
        i_out.append(best_i)
    return torch.cat(d_out), torch.cat(i_out)


def exact_topk(codewords: np.ndarray, codes: np.ndarray,
               queries: np.ndarray, k: int, device,
               q_block: int = 256, r_block: int = 65536
               ) -> Tuple[np.ndarray, np.ndarray]:
    """float64 exact ADC top-k: (dists [Q, k] ascending, ids [Q, k])."""
    dev = torch.device(device)
    cw = torch.from_numpy(np.asarray(codewords)).to(dev, torch.float64)
    q = torch.from_numpy(np.asarray(queries)).to(dev, torch.float64)
    c = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
    q_block = max(1, min(q_block, (1 << 28) // max(1, cw.numel())))
    d, i = _topk_blocks(lambda a, b: _table64(cw, q[a:b]), c, len(q), k,
                        q_block, r_block)
    return d.cpu().numpy(), i.cpu().numpy()


def dists_of(codewords: np.ndarray, codes: np.ndarray, queries: np.ndarray,
             ids: np.ndarray, device, q_block: int = 256) -> np.ndarray:
    """float64 ADC distance of each id in ids [Q, k] to its query (ids
    outside [0, N) read +inf)."""
    dev = torch.device(device)
    cw = torch.from_numpy(np.asarray(codewords)).to(dev, torch.float64)
    q = torch.from_numpy(np.asarray(queries)).to(dev, torch.float64)
    c = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
    ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(dev)
    ok = (ids_t >= 0) & (ids_t < c.shape[0])
    safe = torch.where(ok, ids_t, torch.zeros_like(ids_t))
    q_block = max(1, min(q_block, (1 << 28) // max(1, cw.numel())))
    out = []
    for q0, q1 in _blocks(len(q), q_block):
        table = _table64(cw, q[q0:q1])                     # [Qb, M, K]
        rows = c[safe[q0:q1]].to(torch.int64)              # [Qb, k, M]
        vals = table.gather(2, rows.permute(0, 2, 1))      # [Qb, M, k]
        acc = torch.zeros(q1 - q0, ids_t.shape[1], dtype=torch.float64,
                          device=dev)
        for mm in range(cw.shape[0]):
            acc += vals[:, mm, :]
        out.append(acc)
    d = torch.cat(out)
    d = torch.where(ok, d, torch.full_like(d, float("inf")))
    return d.cpu().numpy()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties to even),
    still stored as f32."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _table_control(cw: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[Qb, M, K] f32: ||q_m||^2 - 2 q_m.c + ||c||^2 with the cross term's
    operands at TF32."""
    M, K, Ds = cw.shape
    qs = q.reshape(-1, M, Ds)
    q2 = (qs * qs).sum(-1)
    c2 = (cw * cw).sum(-1)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cross = torch.bmm(round_tf32(qs).transpose(0, 1),
                          round_tf32(cw).transpose(1, 2)).transpose(0, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return q2[:, :, None] - 2.0 * cross + c2[None]


def control_topk(codewords: np.ndarray, codes: np.ndarray,
                 queries: np.ndarray, k: int, device,
                 q_block: int = 512, r_block: int = 65536
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The control: (dists [Q, k] f32, ids [Q, k]) from TF32 tables."""
    dev = torch.device(device)
    cw = torch.from_numpy(np.asarray(codewords, np.float32)).to(dev)
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(dev)
    c = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
    d, i = _topk_blocks(lambda a, b: _table_control(cw, q[a:b]), c,
                        len(q), k, q_block, r_block)
    return d.cpu().numpy(), i.cpu().numpy()
