"""Fused-scan engines: the query tiers, in PyTorch + CUDA.

Counterpart of ``deltapq_tpu/ops/fused.py``.  Every engine reports exact
f32 ADC distances, bit-equal to ``adc_query_topk`` over the same table,
and carries a per-query exactness certificate:

======================  ============  =================================
engine                  resident      scan kernel
======================  ============  =================================
FusedDecodedEngine      D*2 + M B/vec bf16 x^ rows, ``fused_decoded_mins``
FusedCodesEngine        M B/vec       u8 codes, ``fused_codes_mins``
FusedCompressedEngine   ~1+diffs/row  stream tiles, ``fused_stream_mins``
                        (1+S)+bank    fmt="slots": v1 slot tiles,
                                      ``fused_delta_mins``
DedupCompressedEngine   distinct      ``exact_all_topk`` (<= 64K
                        codes only    distinct), else a compressed
                                      engine over the distinct codes
                                      (chunked above ``chunked_min_rows``)
======================  ============  =================================

Each batch of the fused tiers:

1. ``prepare``: ``adc_table`` (exact f32 tables) and the centered query
   operands -- bf16, or the int8 values / int16 digits quantized on the
   host in NumPy as in the JAX package, so the operand is bit-identical
   between the packages -- plus the certificate inputs (q2, err_r,
   scale2);
2. ``scan``: the tier's kernel -> 32-row subtile minima (and the codes
   the rerank reads);
3. ``select``: ``fused_select_esc`` -- unit selection, exact rerank
   (CUDA rerank kernel), the certificate, the ladder (ns, 2ns, 8ns, cap)
   and the terminal exact scan; the JAX package's ``lax.cond`` rungs
   become host checks of ``ok.all()`` -- then scan rows -> database ids.

Every precision of the JAX package (int8, int16, bf16) is ported, for
M <= 16 (the GIST shape M=16, Ds=60 runs with two mask planes and the
grouped query layout of ``fused_kernels.group_geometry``).
``bigscale.py`` holds the chunked engine, ``parallel/fused_sharded.py``
the sharded one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device, tracing
from .adc import adc_query_topk, adc_table, adc_tile_dists
from .decoded import build_decoded_cache
from .delta_tiles import build_delta_tiles
from .stream_tiles import TILE, StreamTiles, build_stream_tiles
from . import fused_kernels as fk


def _pad_queries(queries: np.ndarray, d_pad: int, b_mult: int = 128
                 ) -> Tuple[np.ndarray, int]:
    q = np.asarray(queries, np.float32)
    b = q.shape[0]
    b_pad = -(-b // b_mult) * b_mult
    out = np.zeros((b_pad, d_pad), np.float32)
    out[:b, :q.shape[1]] = q
    return out, b


def _row_ids_i32(ids) -> np.ndarray:
    """Row-id map for the device-side gather: i32 on device; ids must
    stay below 2^31 (split larger indexes into chunks)."""
    a = np.asarray(ids)
    if len(a) and int(a.max()) >= 2 ** 31:
        raise ValueError(
            f"row id {int(a.max())} overflows the engine's i32 id map "
            f"(cap 2^31); split the index into chunks")
    return a.astype(np.int32)


def _pool_for(ns_total: int) -> int:
    """Min-pool factor for the selection epilogue: the candidate unit is
    SUB*pool rows, coarser as N grows (the fence stays valid at any
    pool; a coarser fence only costs escalations)."""
    if ns_total <= 32768:        # <= 1M rows
        return 1
    if ns_total <= 131072:       # <= 4M rows
        return 2
    if ns_total <= 1048576:      # <= 32M rows
        return 4
    return 8


def _default_n_sub(top_k: int, n_units: int, unit: int) -> int:
    """Candidate unit count: ~50x over-provision of top_k rows (at
    least 512 rows), bounded to the database."""
    want = -(-max(50 * top_k, 512) // unit)
    return int(max(2, min(want, max(n_units - 1, 1))))


def _all_ok(ok: torch.Tensor) -> bool:
    """The host's read of ``ok.all()``: a wait for the device."""
    with tracing.span("engine.wait"):
        return bool(ok.all())


def fused_select_esc(mins_nb, q2, table, codes_dev, n_valid, top_k,
                     rungs, pool, err_r=None, scale2=None,
                     final_exact=False):
    """Selection + escalation: ``rungs`` is an ascending tuple of
    candidate-unit counts; rung 1 always runs, and each later rung runs
    only while some query's certificate still fails (one host check of
    ``ok.all()`` per rung).  With ``final_exact`` the queries that fail
    every rung take the terminal full exact scan over the decoded codes,
    so results are exact by construction.  Returns (d, rows, ok, ok1):
    ``ok`` the final certificate, ``ok1`` the first-shot one.  Counts
    ``rungs`` run and ``terminal_scans``."""
    mins_bn = fk.pool_mins_nb(mins_nb, pool)
    if scale2 is not None:
        mins_bn = mins_bn * scale2

    def rung(ns):
        tracing.count("rungs")
        with tracing.span("engine.rung", ns=ns):
            return fk.select_rerank(mins_bn, q2, table, codes_dev, n_valid,
                                    top_k, ns, pool, prepooled=True,
                                    err_r=err_r)

    d, rows, ok = rung(rungs[0])
    ok1 = ok
    for ns in rungs[1:]:
        if _all_ok(ok):
            break
        d, rows, ok = rung(ns)
    if final_exact and not _all_ok(ok):
        tracing.count("terminal_scans")
        with tracing.span("engine.terminal"):
            # biggest scan tile (<= 16384 rows) dividing the padded rows
            tile_n = TILE
            while (tile_n * 2 <= 16384
                   and codes_dev.shape[0] % (tile_n * 2) == 0):
                tile_n *= 2
            d_s, r_s = adc_query_topk(table, codes_dev, n_valid, top_k,
                                      tile_n)
            d = torch.where(ok[:, None], d, d_s)
            rows = torch.where(ok[:, None], rows, r_s)
    return d, rows, ok, ok1


#: adaptive certificate calibration: grow the first rung when the
#: measured first-shot pass rate falls below GROW_BELOW
ADAPT_GROW_BELOW = 0.35
ADAPT_TARGET = 0.6


def _select_with_escalation(mins_nb, q2, table, codes_dev, n_valid,
                            top_k, n_sub=None, err_r=None, scale2=None,
                            engine=None, b=None):
    """Select + rerank with the full ladder (ns, 2ns, 8ns, cap) and the
    terminal exact scan.  The first rung comes from ``n_sub``, else
    ``engine.ns_hint`` (per-index calibration), else
    ``_default_n_sub``; ``ns_hint`` doubles when the first-shot rate
    collapses.  The cap rung's rows shrink as B grows (its [B, S]
    intermediates).  The first-shot certificate is read once: its rate
    over every row, padding included, drives the ``ns_hint`` rule; with
    ``b``, the caller's real rows, the counters ``real_rows`` and
    ``first_shot_rows`` (those of them certified at rung 1) grow.
    Returns (d, rows, ok1, first_frac): ``ok1`` [B] the first-shot
    certificate, ``first_frac`` its rate."""
    ns_total = mins_nb.shape[0]
    pool = _pool_for(ns_total)
    n_units = -(-ns_total // pool)
    unit = fk.SUB * pool
    hint = getattr(engine, "ns_hint", None) if engine is not None \
        else None
    ns = n_sub or hint or _default_n_sub(top_k, n_units, unit)
    ns = min(ns, max(n_units - 1, 1))
    b_cols = int(mins_nb.shape[1])
    cap_rows = max(8192, 65536 * 512 // max(b_cols, 512))
    ns_cap = min(max(n_units - 1, 1), max(ns, cap_rows // unit))
    rungs = tuple(dict.fromkeys(
        [ns, min(ns * 2, ns_cap), min(ns * 8, ns_cap), ns_cap]))
    d, rows, ok, ok1 = fused_select_esc(
        mins_nb, q2, table, codes_dev, n_valid, top_k, rungs, pool,
        err_r=err_r, scale2=scale2, final_exact=True)
    with tracing.span("engine.wait"):
        ok1_host = ok1.cpu()
    first_frac = float(ok1_host.to(torch.float32).mean())
    if b is not None:
        tracing.count("real_rows", b)
        tracing.count("first_shot_rows", int(ok1_host[:b].sum()))
    if (engine is not None and n_sub is None
            and first_frac < ADAPT_GROW_BELOW and ns < ns_cap):
        engine.ns_hint = min(ns * 2, ns_cap)
    return d, rows, ok1, first_frac


def _int8_codeword_radius(codewords: np.ndarray, mu: np.ndarray,
                          scale: float) -> float:
    """Max over codes of the exact L2 norm of the int8 codeword
    quantization error (step scale): sqrt(sum_m max_k ||c_mk -
    scale*round(c_mk/scale)||^2), the codeword side of the int8
    certificate radius."""
    cw = np.asarray(codewords, np.float32)
    M, K, Ds = cw.shape
    cwc = cw - mu[:M * Ds].reshape(M, 1, Ds)
    err = cwc - scale * np.rint(cwc / scale)
    per_mk = np.sum(err * err, axis=2)             # [M, K]
    return float(np.sqrt(per_mk.max(axis=1).sum()))


def _int16_codeword_radius(codewords: np.ndarray, mu: np.ndarray,
                           scale: float) -> float:
    """Max over codes of the exact L2 norm of the int16 codeword
    quantization error (step scale/128): the codeword side of the
    certificate radius."""
    cw = np.asarray(codewords, np.float32)
    M, K, Ds = cw.shape
    cwc = cw - mu[:M * Ds].reshape(M, 1, Ds)
    A = np.clip(np.rint(cwc * (128.0 / scale)), -16256, 16256)
    err = cwc - (scale / 128.0) * A
    per_mk = np.sum(err * err, axis=2)             # [M, K]
    return float(np.sqrt(per_mk.max(axis=1).sum()))


def _setup_precision(self, codewords: np.ndarray, precision: str):
    """Codebook operands per precision tier (int8, int16, bf16), on
    ``self.device``; ``compact`` holds the kernels' operands on a CUDA
    device."""
    if precision in ("int8", "int16"):
        quantize, radius = (
            (fk.quantize_blockdiag_int8, _int8_codeword_radius)
            if precision == "int8" else
            (fk.quantize_blockdiag_int16, _int16_codeword_radius))
        cwq, self.scale = quantize(codewords, center=self.mu[:self.D])
        self.cwbd = torch.from_numpy(cwq).to(self.device)
        self.err_c = radius(codewords, self.mu, self.scale)
    elif precision == "bf16":
        self.scale = None
        self.cwbd = fk.build_blockdiag_codebook(
            codewords, center=self.mu[:self.D]).to(self.device)
    else:
        raise NotImplementedError(
            f"precision {precision!r}: int8, int16 and bf16 are ported")
    self.compact = (fk.compact_codebook(self.cwbd, self.M, self.Ds,
                                        precision)
                    if self.device.type == "cuda" else None)


def _h2d(t: torch.Tensor, device) -> torch.Tensor:
    """A batch's host tensor on ``device``; its bytes count as
    ``h2d_bytes``."""
    tracing.count("h2d_bytes", t.numel() * t.element_size())
    return t.to(device)


def _mins_query_args(qc: np.ndarray, precision: str, scale, device):
    """Centered grouped-layout queries [B, G*Dg_pad] -> (kernel q
    operand, headroom u [1, B] f32 or None, exact query rounding radius
    e_q [B] or None), on ``device``.  (The JAX function also returns an
    ``invalid`` mask, None in every mode.)

    int8 and int16: each query is quantized at ``scale * u_b`` with
    ``u_b = max(1, max|qc_b| / (127 scale))`` (nothing clips), int8 as
    one value at step ``scale*u`` (q [G*Dg_pad, B] int8), int16 as dual
    base-128 digits at step ``scale*u/128`` (q [2*G*Dg_pad, B] int8).
    Host NumPy, as in the JAX package, so the operand is bit-identical
    between the packages.  bf16: q [G*Dg_pad, B] bf16 (the cast rounds
    to nearest even, as ``ml_dtypes`` does)."""
    if precision == "bf16":
        q = torch.from_numpy(np.ascontiguousarray(qc, np.float32))
        return _h2d(q.to(torch.bfloat16).t().contiguous(), device), None, None
    if precision not in ("int8", "int16"):
        raise NotImplementedError(
            f"precision {precision!r}: int8, int16 and bf16 are ported")
    amax = np.abs(qc).max(axis=1)
    u = np.maximum(1.0, amax / (127.0 * scale)).astype(np.float32)
    if precision == "int8":
        qq = np.clip(np.rint(qc / (scale * u[:, None])),
                     -127, 127).astype(np.int8)
        e_q = np.linalg.norm(
            qc - (scale * u[:, None]) * qq.astype(np.float32),
            axis=1).astype(np.float32)
        return (_h2d(torch.from_numpy(np.ascontiguousarray(qq.T)), device),
                _h2d(torch.from_numpy(u.reshape(1, -1)), device),
                _h2d(torch.from_numpy(e_q), device))
    Aq = np.clip(np.rint(qc * (128.0 / (scale * u[:, None]))),
                 -16256, 16256)
    qa = np.clip(np.rint(Aq / 128.0), -127, 127)
    qb = Aq - 128.0 * qa                              # in [-64, 64]
    e_q = np.linalg.norm(
        qc - (scale * u[:, None] / 128.0) * Aq,
        axis=1).astype(np.float32)
    qop = np.concatenate([qa, qb], axis=1).astype(np.int8)
    return (_h2d(torch.from_numpy(np.ascontiguousarray(qop.T)), device),
            _h2d(torch.from_numpy(u.reshape(1, -1)), device),
            _h2d(torch.from_numpy(e_q), device))


def _quantized_query_stats(self, qop, uq, eq):
    """(q2, err_r, scale2) of the int8 / int16 certificate domains: q2
    is the quantized query norm, err_r = ||e_q|| + the codeword radius,
    and for int16 + 1e-4 (the kernel's f32 digit-combination rounding;
    the int8 scan is exact in f32)."""
    div = 128.0 if self.precision == "int16" else 1.0
    s_eff = self.scale / div
    scale2 = torch.tensor(s_eff * s_eff, dtype=torch.float32,
                          device=qop.device)
    uqv = uq[0]
    err_r = eq + torch.tensor(self.err_c, dtype=torch.float32)
    if self.precision == "int16":
        GD = qop.shape[0] // 2
        Aq = (128.0 * qop[:GD].to(torch.float32)
              + qop[GD:].to(torch.float32))
        err_r = err_r + torch.tensor(1e-4, dtype=torch.float32)
    else:
        Aq = qop.to(torch.float32)
    q2 = scale2 * uqv * uqv * torch.sum(Aq * Aq, dim=0)
    return q2, err_r, scale2


def _q2(qc: np.ndarray, device) -> torch.Tensor:
    """||qc_b||^2 in f32 on ``device``: the bf16 certificate's q2."""
    q = _h2d(torch.from_numpy(np.ascontiguousarray(qc, np.float32)), device)
    return torch.sum(q * q, dim=1)


class _FusedEngine:
    """What the fused tiers share: the batch's three stages (``prepare``,
    ``scan``, ``select``, separate so a caller can time each), the
    certificate calibration and the warmup.  A subclass holds
    ``codewords`` (a tensor on ``device``), ``M``, ``K``, ``Ds``, ``D``,
    ``d_pad``, ``mu``, ``n_valid``, ``row_to_db`` and ``precision``, and
    defines ``scan``."""

    row_to_db: Optional[torch.Tensor] = None

    def _query_operands(self, qc: np.ndarray):
        """Centered padded queries [B_pad, d_pad] -> (q operand, u,
        certificate inputs (q2, err_r, scale2))."""
        qk = fk.pack_query_grouped(qc[:, :self.D], self.M, self.Ds)
        qop, uq, eq = _mins_query_args(qk, self.precision, self.scale,
                                       self.device)
        if self.precision in ("int8", "int16"):
            return qop, uq, _quantized_query_stats(self, qop, uq, eq)
        return qop, uq, (_q2(qc, self.device), None, None)

    def prepare(self, queries: np.ndarray):
        """Stage 1: exact tables + query operands.  Returns (table, qop,
        uq, cert, b)."""
        with tracing.span("engine.prepare"):
            q, b = _pad_queries(queries, self.d_pad)
            table = adc_table(self.codewords,
                              _h2d(torch.from_numpy(q[:, :self.D]),
                                   self.device))
            qop, uq, cert = self._query_operands(q - self.mu[None, :])
            return table, qop, uq, cert, b

    def scan(self, qop, uq):
        """Stage 2: the tier's kernel -> (mins [NS, B], codes for the
        rerank, in scan order)."""
        raise NotImplementedError

    def select(self, table, cert, mins, codes_echo, b: int,
               top_k: int = 10, n_sub: Optional[int] = None):
        """Stage 3: selection, rerank, ladder, terminal scan and the id
        map.  Returns (dists [b, top_k], ids [b, top_k]) on the device."""
        with tracing.span("engine.select"):
            q2, err_r, scale2 = cert
            d, rows, _, self.last_exact_frac = _select_with_escalation(
                mins, q2, table, codes_echo, self.n_valid, top_k, n_sub,
                err_r=err_r, scale2=scale2, engine=self, b=b)
            if self.row_to_db is not None:
                mapped = self.row_to_db[
                    torch.clamp(rows, 0, self.n_valid - 1)]
                rows = torch.where(rows >= 0, mapped.to(rows.dtype), rows)
            return d[:b], rows[:b]

    def query(self, queries: np.ndarray, top_k: int = 10,
              n_sub: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k: (dists [B, top_k] f32, ids [B, top_k] int64)."""
        with tracing.span("engine.query"):
            table, qop, uq, cert, b = self.prepare(queries)
            mins, codes_echo = self.scan(qop, uq)
            d, rows = self.select(table, cert, mins, codes_echo, b, top_k,
                                  n_sub)
            with tracing.span("engine.wait"):
                return d.cpu().numpy(), rows.cpu().numpy()

    def _warmup_queries(self, b: int, seed: int = 0) -> np.ndarray:
        """Data-like queries (a decoded row + jitter): degenerate
        queries sit in tie pileups and would drag the warmup through
        the terminal exact scan."""
        rng = np.random.default_rng(seed)
        cw = self.codewords.cpu().numpy()
        base = cw[np.arange(self.M), 0].reshape(-1)
        sd = float(cw.std()) or 1.0
        q = base[None, :] + rng.normal(
            size=(int(b), self.D)).astype(np.float32) * sd
        return q.astype(np.float32)

    def calibrate(self, top_k: int = 10, b: int = 128,
                  target: float = ADAPT_TARGET, rounds: int = 6
                  ) -> float:
        """Size ``ns_hint`` (the first rung) on sampled data-like query
        batches until the first-shot certificate rate clears ``target``.
        Returns the final measured first-shot rate."""
        q = self._warmup_queries(b, seed=17)
        frac = 0.0
        for _ in range(rounds):
            before = getattr(self, "ns_hint", None)
            self.query(q, top_k=top_k)
            frac = self.last_exact_frac
            if frac >= target:
                break
            if getattr(self, "ns_hint", None) in (None, before):
                # the adaptive step did not fire: take one doubling
                ns_total = -(-self.n_valid // fk.SUB)
                pool = _pool_for(ns_total)
                n_units = -(-ns_total // pool)
                unit = fk.SUB * pool
                cur = before or _default_n_sub(top_k, n_units, unit)
                cap = min(max(n_units - 1, 1), max(cur, 65536 // unit))
                if cur >= cap:
                    break
                self.ns_hint = min(cur * 2, cap)
        return frac

    def warmup(self, batch_sizes=(512,), top_k: int = 10,
               calibrate: bool = True) -> None:
        """Calibrate the first rung, then run one batch of each size."""
        if calibrate:
            self.calibrate(top_k=top_k)
        for b in batch_sizes:
            self.query(self._warmup_queries(b), top_k=top_k)


def _common_init(self, codewords, device):
    """Codebook fields every fused engine holds."""
    codewords = _np_f32(codewords)
    M, K, Ds = codewords.shape
    self.device = resolve_device(device)
    self.codewords = torch.from_numpy(codewords).to(self.device)
    self.M, self.K, self.Ds = M, K, Ds
    self.D = M * Ds
    self.d_pad = -(-self.D // 128) * 128
    self.mu = np.zeros(self.d_pad, np.float32)
    self.mu[:self.D] = fk.codebook_center(codewords)
    return codewords


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``.  A read-only array (a memory-mapped
    chunk) is copied once into pageable host memory first: torch takes
    only writable NumPy arrays."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _codes_tensor(codes: np.ndarray, n_pad: int, K: int) -> torch.Tensor:
    """Codes zero-padded to n_pad rows as the kernels take them: u8, or
    int32 for K > 256."""
    codes = np.asarray(codes)
    out = np.zeros((n_pad, codes.shape[1]),
                   np.uint8 if K <= 256 else np.int32)
    out[:len(codes)] = codes
    return torch.from_numpy(out)


class FusedDecodedEngine(_FusedEngine):
    """Decoded-cache tier: bf16 x^ rows resident (D*2 B/vec, tiled
    ``tile`` rows at a time), the padded codes resident for the rerank
    (M B/vec).  Also the index's tier for K > 256."""

    def __init__(self, codewords, codes: np.ndarray, tile: int = 8192,
                 device=None):
        codewords = _common_init(self, codewords, device)
        codes = np.asarray(codes)
        self.n_valid = codes.shape[0]
        hi, _lo, _pre = build_decoded_cache(codewords, codes,
                                            center=self.mu[:self.D])
        if self.d_pad != self.D:
            hi = torch.cat([hi, torch.zeros((len(hi), self.d_pad - self.D),
                                            dtype=hi.dtype)], dim=1)
        self.xt = fk.pack_xhat_tiles(hi, tile=tile).to(self.device)
        self.codes = _codes_tensor(codes, self.xt.shape[0] * tile,
                                   self.K).to(self.device)

    def _query_operands(self, qc: np.ndarray):
        q = torch.from_numpy(np.ascontiguousarray(qc, np.float32))
        qop = _h2d(q.to(torch.bfloat16).t().contiguous(), self.device)
        return qop, None, (_q2(qc, self.device), None, None)

    def scan(self, qop, uq):
        with tracing.span("engine.scan"):
            return (fk.fused_decoded_mins(qop, self.xt, self.n_valid),
                    self.codes)


class FusedCodesEngine(_FusedEngine):
    """u8-codes tier: M bytes/vec resident; the kernel gathers x^ from
    the codebook.  ``order`` gives the scan order (row i of the scan is
    database row ``order[i]``)."""

    def __init__(self, codewords, codes: np.ndarray,
                 order: Optional[np.ndarray] = None,
                 precision: str = "bf16", device=None):
        codewords = _common_init(self, codewords, device)
        if self.K > 256:
            raise NotImplementedError(
                "the codes tier requires K <= 256; use FusedDecodedEngine "
                "for wider codes")
        codes = np.asarray(codes)
        self.n_valid = codes.shape[0]
        if order is not None:
            codes = codes[np.asarray(order, np.int64)]
            self.row_to_db = torch.from_numpy(
                _row_ids_i32(order)).to(self.device)
        n_pad = -(-self.n_valid // TILE) * TILE
        self.codes = _codes_tensor(codes, n_pad, self.K).to(self.device)
        self.precision = precision
        _setup_precision(self, codewords, precision)

    def scan(self, qop, uq):
        with tracing.span("engine.scan"):
            return fk.fused_codes_mins(qop, self.cwbd, self.codes,
                                       self.n_valid, u=uq,
                                       compact=self.compact,
                                       mode=self.precision)


class FusedCompressedEngine(_FusedEngine):
    """Compressed tier; the whole decode happens inside the scan kernel
    and the rerank reads the kernel's decoded-codes echo, so no plain
    code array stays resident.

    ``fmt="stream"`` (default): packed stream tiles (~1 + diffs/row
    B/vec), scanned by ``fused_stream_mins``.  ``fmt="slots"``: the v1
    fixed-slot tiles (``delta_tiles.py``: S value slots a row plus an
    overflow bank; ``S=None`` picks the smallest), scanned by
    ``fused_delta_mins``; every file saved without ``fmt`` is of this
    kind.

    Build from scan-ordered codes (with ``row_to_db`` mapping scan rows
    to database ids), from a DeltaTree (DFS order = tile order) or from
    pre-built tiles.  ``device`` holds every tensor of the engine.  The
    port's default precision is int16 (the benchmark's); the JAX
    package's is bf16, which ``DeltaPQIndex`` asks for.

    ``pipelined=True`` scans stream tiles with the pipelined stream
    kernel (``fused_stream_mins(pipelined=True)``: M <= 8, int8 or bf16;
    the JAX package switches it on with an environment variable).  It is
    not written to a saved engine.
    """

    def __init__(self, codewords, codes_scan: np.ndarray,
                 row_to_db: Optional[np.ndarray] = None,
                 precision: str = "int16", fmt: str = "stream",
                 S: Optional[int] = None, device=None,
                 pipelined: bool = False):
        codes_scan = np.asarray(codes_scan)
        if fmt == "stream":
            tiles = build_stream_tiles(codes_scan)
        elif fmt == "slots":
            tiles = build_delta_tiles(codes_scan, S=S)
        else:
            raise ValueError(f"unknown delta-tile format {fmt!r}")
        self._init(codewords, tiles, row_to_db, precision, device,
                   pipelined)

    def _init(self, codewords, tiles, row_to_db, precision, device,
              pipelined=False):
        codewords = _common_init(self, codewords, device)
        if self.K > 256:
            raise NotImplementedError("the compressed tier requires "
                                      "K <= 256")
        self.tiles = tiles
        if hasattr(tiles, "ovf"):                 # slot tiles
            self.fmt = "slots"
            self.ovf = _upload(tiles.ovf, self.device)
        else:
            self.fmt = "stream"
            self.vals = _upload(tiles.vals, self.device)
            self.meta = _upload(tiles.meta, self.device)
        self.row_data = _upload(tiles.row_data, self.device)
        self.n_valid = tiles.n_valid
        self.precision = precision
        self.pipelined = bool(pipelined)
        if self.pipelined and (self.fmt != "stream" or self.M > 8
                               or precision == "int16"):
            raise NotImplementedError(
                "pipelined=True takes stream tiles with M <= 8 at int8 or "
                "bf16")
        _setup_precision(self, codewords, precision)
        self.row_to_db = (_upload(_row_ids_i32(row_to_db), self.device)
                          if row_to_db is not None else None)

    @classmethod
    def from_tree(cls, codewords, tree, precision: str = "int16",
                  fmt: str = "stream", S: Optional[int] = None,
                  device=None, pipelined: bool = False
                  ) -> "FusedCompressedEngine":
        codes_db = tree.decode_codes()
        order = tree.vec_id.astype(np.int64)
        return cls(codewords, codes_db[order], row_to_db=order,
                   precision=precision, fmt=fmt, S=S, device=device,
                   pipelined=pipelined)

    @classmethod
    def from_tiles(cls, codewords, tiles,
                   row_to_db: Optional[np.ndarray] = None,
                   precision: str = "int16", device=None,
                   pipelined: bool = False) -> "FusedCompressedEngine":
        """Engine over pre-built ``StreamTiles`` or ``DeltaTiles``
        (construction = upload)."""
        self = cls.__new__(cls)
        self._init(codewords, tiles, row_to_db, precision, device,
                   pipelined)
        return self

    def bytes_per_vec(self) -> float:
        return self.tiles.bytes_per_vec()

    def scan(self, qop, uq):
        """Stage 2: the tile format's kernel -> (mins [NS, B], codes
        echo)."""
        with tracing.span("engine.scan"):
            if self.fmt == "slots":
                return fk.fused_delta_mins(
                    qop, self.cwbd, self.row_data, self.ovf, self.n_valid,
                    self.tiles.S, u=uq, compact=self.compact,
                    mode=self.precision)
            return fk.fused_stream_mins(
                qop, self.cwbd, self.row_data, self.vals, self.meta,
                self.n_valid, self.M, u=uq, compact=self.compact,
                mode=self.precision, pipelined=self.pipelined)

    def save(self, path: str) -> None:
        """Persist the tiles, mapping and precision (the JAX package's
        layout plus ``precision``)."""
        common = dict(row_data=self.tiles.row_data, n_valid=self.n_valid,
                      M=self.M, fmt=self.fmt, precision=self.precision,
                      codewords=self.codewords.cpu().numpy(),
                      row_to_db=(self.row_to_db.cpu().numpy()
                                 if self.row_to_db is not None
                                 else np.zeros(0, np.int32)))
        if self.fmt == "stream":
            np.savez(path, vals=self.tiles.vals, meta=self.tiles.meta,
                     e_max=self.tiles.e_max, **common)
        else:
            np.savez(path, ovf=self.tiles.ovf, S=self.tiles.S,
                     Cap=self.tiles.Cap, **common)

    @classmethod
    def load(cls, path: str, device=None) -> "FusedCompressedEngine":
        """Reopen a saved engine at its saved precision (a file without
        ``precision`` -- one the JAX package wrote -- loads at int16, and
        one without ``fmt`` as slot tiles; see
        ``convert.load_jax_engine``)."""
        from ..convert import load_jax_engine

        return load_jax_engine(path, device=device)


def exact_all_topk(table: torch.Tensor, codes_pad: torch.Tensor,
                   n_valid: int, top_k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 ADC top-k over a small code array: every row's distance
    (``adc_tile_dists``, ascending m from 0.0, so the distances are
    bit-equal to ``adc_query_topk``'s), rows >= n_valid at +inf, then
    one ``topk``.  The JAX package runs this as a one-hot bf16-digit
    matmul in XLA; here it is plain PyTorch.  Returns (dists [B, top_k],
    rows [B, top_k])."""
    d = adc_tile_dists(table, codes_pad)
    rows = torch.arange(codes_pad.shape[0], device=d.device)
    d = torch.where((rows < n_valid)[None, :], d,
                    torch.full_like(d, float("inf")))
    return torch.topk(d, top_k, dim=1, largest=False, sorted=True)


class DedupCompressedEngine:
    """Duplicate-code-collapsed tier: identical codes have identical ADC
    distances, so each DISTINCT code is scanned once and row ids are
    expanded at result time (top-k distinct codes by exact distance
    cover >= top_k rows).  Up to ``EXACT_ALL_MAX_ROWS`` distinct codes a
    query reranks all of them (``exact_all_topk``); above, a compressed
    engine scans the distinct codes at ``precision`` (int8 by default,
    as in the JAX package), and above ``chunked_min_rows`` distinct
    codes that engine is a ``bigscale.ChunkedCompressedEngine`` with
    resident chunks.  The row expansion (sorted permutation + CSR
    counts) lives on the host.  With ``mesh`` (a ``parallel.mesh.Mesh``)
    the distinct codes split over the mesh's shards: the inner engine is
    a ``ShardedCompressedEngine`` at ``precision``, built at once, and
    no query takes the exact-all branch; ``shard_axis`` must name the
    mesh's axis (ValueError otherwise).
    """

    EXACT_ALL_MAX_ROWS = 65536
    CHUNKED_MIN_ROWS = 32 * 1024 * 1024

    def __init__(self, codewords, codes_db: np.ndarray,
                 precision: str = "int8", fmt: str = "stream",
                 chunked_min_rows: int = CHUNKED_MIN_ROWS,
                 mesh=None, shard_axis: str = "shard", device=None):
        codes_db = np.asarray(codes_db)
        cwf = _np_f32(codewords)
        self.device = (mesh.devices[0] if mesh is not None
                       else resolve_device(device))
        self.codewords = torch.from_numpy(cwf).to(self.device)
        self.M, _, self.Ds = cwf.shape
        self.D = self.M * self.Ds
        self.d_pad = -(-self.D // 128) * 128
        order = np.lexsort(codes_db.T[::-1])
        sc = codes_db[order]
        new = np.ones(len(sc), bool)
        if len(sc) > 1:
            new[1:] = np.any(sc[1:] != sc[:-1], axis=1)
        self.starts = np.flatnonzero(new)
        self.counts = np.diff(np.append(self.starts, len(sc)))
        self.order = order
        self.n_rows = len(codes_db)
        self._unique_codes = sc[new]
        self._precision, self._fmt = precision, fmt
        self._chunked_min_rows = chunked_min_rows
        self._mesh = mesh
        self._engine = None
        self._codes_pad = None
        if mesh is not None:
            from ..parallel.mesh import check_axis

            check_axis(mesh, shard_axis)
        if mesh is None and self.n_unique <= self.EXACT_ALL_MAX_ROWS:
            n_pad = -(-self.n_unique // 1024) * 1024
            self._codes_pad = _codes_tensor(
                self._unique_codes, n_pad, cwf.shape[1]).to(self.device)
        else:
            self.engine  # built at once: every query path needs it

    @property
    def engine(self):
        """The inner engine over the distinct codes, built on first
        access: a ``ShardedCompressedEngine`` with a mesh, a
        ``ChunkedCompressedEngine`` above ``chunked_min_rows`` distinct
        codes, else a ``FusedCompressedEngine``, each at ``precision``.
        In the exact-all regime no query touches it."""
        if self._engine is None:
            cwf = self.codewords.cpu().numpy()
            if self._mesh is not None:
                from ..parallel.fused_sharded import ShardedCompressedEngine

                self._engine = ShardedCompressedEngine(
                    cwf, self._unique_codes, self._mesh,
                    precision=self._precision)
            elif self.n_unique > self._chunked_min_rows:
                from ..bigscale import ChunkedCompressedEngine

                self._engine = ChunkedCompressedEngine(
                    cwf, self._unique_codes, precision=self._precision,
                    resident=True, device=self.device)
            else:
                self._engine = FusedCompressedEngine(
                    cwf, self._unique_codes, precision=self._precision,
                    fmt=self._fmt, device=self.device)
        return self._engine

    @property
    def n_unique(self) -> int:
        return len(self.starts)

    def bytes_per_vec(self) -> float:
        """Device-resident tile bytes of the distinct codes amortized
        over ALL rows: the inner engine's, or in the exact-all regime
        the stream tiles it would build."""
        if self._engine is not None:
            return (self._engine.bytes_per_vec() * self.n_unique
                    / max(self.n_rows, 1))
        return (build_stream_tiles(self._unique_codes).nbytes()
                / max(self.n_rows, 1))

    def query(self, queries: np.ndarray, top_k: int = 10
              ) -> Tuple[np.ndarray, np.ndarray]:
        ku = min(top_k, self.n_unique)
        if self._codes_pad is not None:
            q, b = _pad_queries(np.asarray(queries, np.float32),
                                self.d_pad)
            table = adc_table(self.codewords,
                              torch.from_numpy(q[:, :self.D]).to(
                                  self.device))
            d_u, i_u = exact_all_topk(table, self._codes_pad,
                                      self.n_unique, ku)
            d_u, i_u = d_u[:b].cpu().numpy(), i_u[:b].cpu().numpy()
        else:
            d_u, i_u = self.engine.query(queries, top_k=ku)
        return self.expand(d_u, i_u, top_k)

    def warmup(self, batch_sizes=(512,), top_k: int = 10) -> None:
        rng = np.random.default_rng(0)
        for b in batch_sizes:
            q = rng.normal(size=(int(b), self.D)).astype(np.float32)
            self.query(q, top_k=top_k)

    def expand(self, d_u: np.ndarray, i_u: np.ndarray, top_k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Unique-code results (d_u [B, ku], i_u [B, ku] unique ids, -1
        padding) -> per-row (d [B, top_k], ids [B, top_k]): output slot f
        maps to the unique j whose cumulative row count first exceeds f;
        a code's duplicate rows surface in ``order`` order."""
        d_u, i_u = np.asarray(d_u), np.asarray(i_u, np.int64)
        B, ku = i_u.shape
        cnt = np.where(i_u >= 0,
                       self.counts[np.clip(i_u, 0, None)], 0)
        csum = np.cumsum(cnt, axis=1)                      # inclusive
        f = np.arange(top_k)
        j = (csum[:, :, None] <= f[None, None, :]).sum(axis=1)
        valid = (j < ku) & (f[None, :] < csum[:, -1:])
        jc = np.minimum(j, ku - 1)
        prev = np.concatenate(
            [np.zeros((B, 1), csum.dtype), csum[:, :-1]], axis=1)
        within = f[None, :] - np.take_along_axis(prev, jc, axis=1)
        u = np.take_along_axis(i_u, jc, axis=1)
        idx = (self.starts[np.clip(u, 0, None)]
               + np.clip(within, 0, None))
        ids = self.order[np.minimum(idx, len(self.order) - 1)]
        d = np.take_along_axis(d_u, jc, axis=1)
        return (np.where(valid, d, np.inf).astype(np.float32),
                np.where(valid, ids, -1))


def _np_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().astype(np.float32)
    return np.asarray(a, np.float32)
