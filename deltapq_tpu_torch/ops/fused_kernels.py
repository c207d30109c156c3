"""Fused scan kernels and the selection epilogue, in PyTorch + CUDA.

Counterpart of ``deltapq_tpu/ops/fused_pallas.py`` (the module of the
port whose name differs: its kernels are CUDA C++, not Pallas).

Hand-written Hopper kernels, each with a plain PyTorch version in this
module and a launch count in ``kernels.build.launch_counts()``:

* ``fused_stream_mins`` -> ``csrc/stream_mins.cu`` (replaces
  ``_stream_mins_kernel``): decode stream tiles, the scan, 32-row
  subtile minima and the decoded-codes echo, on the tensor cores at
  every shape (``scan_tail_form``: ``mma.sync`` tails with queries staged
  from ``transpose_queries(q)`` at M <= 8 with M*Ds <= 128, the gathered
  ``wgmma`` tail of ``csrc/wide_mma.cuh`` beyond); with ``pipelined=True`` ->
  ``csrc/stream_mins_pipelined.cu`` (replaces
  ``_stream_mins_pipelined_kernel``): the same function on the same
  ``mma.sync`` tail, a block walking a run of tiles with the next tile's
  mask plane and value window copied in while it scans;
* ``fused_codes_mins`` -> ``csrc/codes_mins.cu`` (replaces
  ``_codes_mins_kernel``): the scan on resident u8 codes, on the tensor
  cores at every shape with the stream kernel's tails (at the wide
  shapes the ``wgmma`` tail's A operand is gathered from
  ``padded_codebook`` by the codes);
* ``fused_delta_mins`` -> ``csrc/delta_mins.cu`` (replaces
  ``_delta_mins_kernel``): decode v1 slot tiles (mask plane, S value
  slots, overflow bank), then the codes kernel's tails;
* ``fused_decoded_mins`` -> ``csrc/decoded_mins.cu`` (replaces
  ``_decoded_mins_kernel``): bf16 x^ . q with f32 sums over resident
  decoded rows, on the tensor cores (``wgmma``);
* ``rerank_table_sums`` -> ``csrc/rerank.cu`` (replaces
  ``_rerank_kernel``): exact ascending-m f32 table sums.

Each wrapper takes the plain version for a tensor on the CPU and, for a
CUDA tensor, launches its kernel or raises: there is no fallback.

The scan kernels take their mode explicitly (``mode=``, the engine's
precision), where the JAX package takes a static ``int16=`` flag and
reads int8 against bf16 from the operand types:

* ``"int16"``: codebook and queries as two base-128 int8 digits, q
  [2*G*Dg, B] int8 (all a-planes, then all b-planes), cwbd [G*Mg*K,
  2*Dg] int8 (a | b side by side), per-query headroom u;
* ``"int8"``: one int8 digit, q [G*Dg, B] int8, cwbd [G*Mg*K, Dg]
  int8, u;
* ``"bf16"``: q [G*Dg, B] bf16, cwbd [G*Mg*K, Dg] bf16, no u.

(G, Mg, Dg) is ``group_geometry(M, Ds)``: one group for M <= 8, two
groups of 8 subspaces for the GIST shape M=16.  The operands keep the JAX
package's grouped layout; the CUDA kernels read it as it is and band the
work their own way (``csrc/scan_tail.cuh``, ``csrc/wide_mma.cuh``).  A call whose operand types
or shapes do not match its mode raises.  The
distance decomposition, the digit arithmetic and the exactness
certificate are the JAX package's; see the docstrings there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import build
from .adc import no_tf32

TILE = 1024   # rows per stream / codes tile
SUB = 32      # rows per subtile-min
#: tiles per chunk of the plain scans (bounds their [rows, B] work)
REF_CHUNK_TILES = 64
#: scan modes -> the CUDA kernels' mode argument
MODES = {"int16": 0, "bf16": 1, "int8": 2}
#: widest query row the wide scan tails stage in shared memory, per digit
#: plane, each subspace padded to 16 bytes (GIST: 16 x 64 at int8 and
#: int16, 16 x 128 at bf16)
WIDE_ROW_BYTES = 2048

# --------------------------------------------------------------------------
# Host half: codebook and query operands (NumPy, as in the JAX package)
# --------------------------------------------------------------------------

def codebook_center(codewords: np.ndarray) -> np.ndarray:
    """Global centering vector mu [D]: the concatenated per-subspace
    centroid means (squared-L2 distances are translation-invariant)."""
    return np.asarray(codewords, np.float32).mean(axis=1).reshape(-1)


def group_geometry(M: int, Ds: int) -> Tuple[int, int, int]:
    """(G groups, Mg subspaces/group, Dg_pad padded group width) of the
    block-diagonal decode; M <= 8 is one group with D padded to 128."""
    G = (M + 7) // 8
    Mg = -(-M // G)
    Dg_pad = -(-(Mg * Ds) // 128) * 128
    return G, Mg, Dg_pad


def pack_query_grouped(qc: np.ndarray, M: int, Ds: int) -> np.ndarray:
    """Centered queries [B, D] f32 -> kernel layout [B, G*Dg_pad]."""
    qc = np.asarray(qc, np.float32)
    B, D = qc.shape
    G, Mg, Dg_pad = group_geometry(M, Ds)
    out = np.zeros((B, G * Dg_pad), np.float32)
    for g in range(G):
        lo = g * Mg * Ds
        hi = min((g + 1) * Mg * Ds, D)
        out[:, g * Dg_pad:g * Dg_pad + (hi - lo)] = qc[:, lo:hi]
    return out


def build_blockdiag_codebook(codewords: np.ndarray,
                             center: Optional[np.ndarray] = None,
                             dtype: torch.dtype = torch.bfloat16
                             ) -> torch.Tensor:
    """[M, K, Ds] f32 -> grouped block-diagonal [G*Mg*K, Dg_pad] decode
    matrix (minus ``center`` when given), a CPU tensor of ``dtype``:
    bf16 by default, as the JAX package's (NumPy has no bf16; the cast
    rounds to nearest even, as ``ml_dtypes`` does).  The int16
    quantizer takes the f32 form."""
    M, K, Ds = codewords.shape
    cw = np.asarray(codewords, np.float32)
    if center is not None:
        cw = cw - center.reshape(M, 1, Ds)
    G, Mg, Dg_pad = group_geometry(M, Ds)
    out = np.zeros((G * Mg * K, Dg_pad), np.float32)
    for m in range(M):
        g, mi = divmod(m, Mg)
        out[(g * Mg + mi) * K:(g * Mg + mi + 1) * K,
            mi * Ds:(mi + 1) * Ds] = cw[m]
    return torch.from_numpy(out).to(dtype)


def _blockdiag_f32(cwbd_or_cw, center):
    if cwbd_or_cw.ndim == 3:
        return build_blockdiag_codebook(cwbd_or_cw, center=center,
                                        dtype=torch.float32).numpy()
    return np.asarray(cwbd_or_cw, np.float32)


def quantize_blockdiag_int8(cwbd_or_cw, center=None):
    """Codebook -> ([MKs, Dg] int8 block-diagonal decode matrix, scale):
    values quantize symmetrically at scale = max|c|/127."""
    cwbd = _blockdiag_f32(cwbd_or_cw, center)
    scale = max(float(np.abs(cwbd).max()) / 127.0, 1e-12)
    q = np.clip(np.rint(cwbd / scale), -127, 127).astype(np.int8)
    return q, scale


def quantize_blockdiag_int16(cwbd_or_cw, center=None):
    """Codebook -> ([MKs, 2*Dg] int8 dual-digit decode matrix, scale):
    A = round(c*128/scale) split into a = round(A/128) in [-127, 127]
    and b = A - 128a in [-64, 64]."""
    cwbd = _blockdiag_f32(cwbd_or_cw, center)
    scale = max(float(np.abs(cwbd).max()) / 127.0, 1e-12)
    A = np.clip(np.rint(cwbd * (128.0 / scale)), -16256, 16256)
    a = np.clip(np.rint(A / 128.0), -127, 127)
    b = A - 128.0 * a
    out = np.concatenate([a, b], axis=1).astype(np.int8)
    return out, scale


def _codebook_k(cwbd: torch.Tensor, M: int) -> int:
    """K of a grouped block-diagonal codebook [G*Mg*K, width]."""
    G = (M + 7) // 8
    return cwbd.shape[0] // (G * -(-M // G))


def compact_codebook(cwbd: torch.Tensor, M: int, Ds: int, mode: str
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                Optional[torch.Tensor]]:
    """The scan kernels' codebook operands, built once per engine from
    the block-diagonal ``cwbd``: (cw, nrm, cw_pad) -- the nonzero blocks
    (each codeword's own Ds dims), per-codeword norms, and at the wide
    shapes (``narrow_shape`` false) ``padded_codebook(cw, M, Ds, mode)``
    for the tensor-core wide tail (None at the narrow shapes).

    * int16 (``cwbd`` [G*Mg*K, 2*Dg] int8): ``cw`` [2, M, K, Ds/4]
      int32, the a- then b-digit planes, four int8 digits per word;
      ``nrm`` [M, K] int64, sum of A^2 with A = 128a + b, exact;
    * int8 (``cwbd`` [G*Mg*K, Dg] int8): ``cw`` [M, K, Ds/4] int32, four
      int8 values per word; ``nrm`` [M, K] int32, sum of c^2, exact;
    * bf16 (``cwbd`` [G*Mg*K, Dg] bf16): ``cw`` [M, K, Ds/2] int32, two
      bf16 values per word; ``nrm`` [M, K] f32, sum of the squared bf16
      values.

    Subspace m's codewords are rows m*K .. (m+1)*K of ``cwbd`` and its
    dims sit at columns (m % Mg)*Ds .. inside its own group's rows.
    """
    width = cwbd.shape[1]
    K = _codebook_k(cwbd, M)
    _, Mg, _ = group_geometry(M, Ds)
    dev = cwbd.device
    cols = ((torch.arange(M, device=dev) % Mg)[:, None] * Ds
            + torch.arange(Ds, device=dev)[None, :])        # [M, Ds]
    idx = cols[:, None, :].expand(M, K, Ds)
    bd = cwbd[:M * K].reshape(M, K, width)
    if mode == "bf16":
        if Ds % 2:
            raise NotImplementedError("the bf16 scan kernels need Ds even")
        x = torch.gather(bd, 2, idx).contiguous()
        xf = x.to(torch.float32)
        cw, nrm = x.view(torch.int32), (xf * xf).sum(dim=2)
    elif Ds % 4:
        raise NotImplementedError(f"the {mode} scan kernels need "
                                  f"Ds % 4 == 0")
    elif mode == "int8":
        x = torch.gather(bd, 2, idx).contiguous()
        xi = x.to(torch.int32)
        cw = x.view(torch.int32)
        nrm = (xi * xi).sum(dim=2, dtype=torch.int32)
    elif mode == "int16":
        Dg = width // 2
        a = torch.gather(bd[:, :, :Dg], 2, idx)
        b = torch.gather(bd[:, :, Dg:], 2, idx)
        cw = torch.stack([a, b]).contiguous().view(torch.int32)
        A = 128 * a.to(torch.int64) + b.to(torch.int64)
        nrm = (A * A).sum(dim=2)
    else:
        raise NotImplementedError(f"scan mode {mode!r} is not ported")
    pad = None if narrow_shape(M, Ds) else padded_codebook(cw, M, Ds, mode)
    return cw, nrm, pad


def wide_sub_bytes(Ds: int, mode: str) -> int:
    """SP: the bytes of one subspace's codeword (of one digit plane at
    int16) in the wide tensor-core tail's padded operands -- its Ds
    values (one byte each, two at bf16) rounded up to whole 16-byte
    pieces (GIST, Ds=60: 64 bytes at int8 and int16, 128 at bf16)."""
    return -(-(Ds * (2 if mode == "bf16" else 1)) // 16) * 16


def padded_codebook(cw: torch.Tensor, M: int, Ds: int, mode: str
                    ) -> torch.Tensor:
    """The compact codebook ``cw`` (``compact_codebook``'s int32 words)
    -> u8 [planes, M, K, SP]: each codeword's bytes, zero-padded to
    ``wide_sub_bytes(Ds, mode)``, so that piece c of codeword k of
    subspace m starts on a 16-byte boundary at ((m*K + k)*SP + 16c) and
    a row of x^ is M whole-piece copies.  int16 has two planes (a-digits,
    then b-digits), int8 and bf16 one."""
    planes = 2 if mode == "int16" else 1
    sub = Ds * (2 if mode == "bf16" else 1)
    raw = cw.contiguous().view(torch.uint8).reshape(planes, M, -1, sub)
    out = torch.zeros(raw.shape[:3] + (wide_sub_bytes(Ds, mode),),
                      dtype=torch.uint8, device=cw.device)
    out[..., :sub] = raw
    return out


def pad_transpose_queries(q: torch.Tensor, M: int, Ds: int, mode: str
                          ) -> torch.Tensor:
    """The scan kernels' query operand q [planes*G*Dg, B] (grouped
    layout) -> [B, planes*M*SPv] in q's type, the wide tensor-core
    tail's query operand: query b's subspace m of plane p at elements
    (p*M + m)*SPv .. + Ds, zero to SPv = SP / element size -- the
    padding of ``padded_codebook``, so a 16-byte piece of a query row
    meets the same piece of every x^ row."""
    planes = 2 if mode == "int16" else 1
    G, Mg, Dg = group_geometry(M, Ds)
    B = q.shape[1]
    dev = q.device
    m = torch.arange(M, device=dev)
    start = (m // Mg) * Dg + (m % Mg) * Ds                      # [M]
    idx = (torch.arange(planes, device=dev)[:, None, None] * (G * Dg)
           + start[None, :, None]
           + torch.arange(Ds, device=dev)[None, None, :])       # [p, M, Ds]
    x = q[idx.reshape(-1)].reshape(planes, M, Ds, B).permute(3, 0, 1, 2)
    spv = wide_sub_bytes(Ds, mode) // q.element_size()
    out = torch.zeros((B, planes, M, spv), dtype=q.dtype, device=dev)
    out[..., :Ds] = x
    return out.reshape(B, planes * M * spv)


def pack_xhat_tiles(xhat: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """[N, D] bf16 -> [nT, tile, D] bf16 (zero rows pad N to tile)."""
    n, d = xhat.shape
    n_pad = -(-n // tile) * tile
    if n_pad != n:
        xhat = torch.cat([xhat, torch.zeros((n_pad - n, d),
                                            dtype=xhat.dtype,
                                            device=xhat.device)])
    return xhat.reshape(n_pad // tile, tile, d).contiguous()


# --------------------------------------------------------------------------
# The shared scan tail (plain version) and its operand checks
# --------------------------------------------------------------------------

def _scan_mode(q: torch.Tensor, cwbd: torch.Tensor, M: int, mode: str
               ) -> int:
    """Check the operands against the scan ``mode``; returns the
    kernels' mode code.  int16 codebooks are [2*Dg]-wide (two digit
    planes, so a multiple of 256), int8 and bf16 ones [Dg]-wide; q has
    one such block of rows per subspace group."""
    if mode not in MODES:
        raise NotImplementedError(f"scan mode {mode!r}: the int16, int8 "
                                  f"and bf16 scans are ported")
    want = torch.bfloat16 if mode == "bf16" else torch.int8
    if q.dtype != want or cwbd.dtype != want:
        raise ValueError(f"{mode} scan: q and cwbd must be {want}, got q "
                         f"{q.dtype}, cwbd {cwbd.dtype}")
    if not 1 <= M <= 16:
        raise NotImplementedError("the scan kernels take M <= 16 (two "
                                  "subspace groups, two mask planes)")
    width = cwbd.shape[1]
    G = (M + 7) // 8
    if (G * width != q.shape[0] or cwbd.shape[0] % (G * -(-M // G))
            or width % (256 if mode == "int16" else 128)):
        raise ValueError(f"cwbd {tuple(cwbd.shape)} does not match "
                         f"q {tuple(q.shape)}, M={M} in {mode} mode")
    return MODES[mode]


def _scan_tail_ref(codes: torch.Tensor, q: torch.Tensor,
                   cwbd: torch.Tensor, n_valid: int, M: int, mode: str,
                   u: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, float, float]:
    """Plain version of the scan tail: codes [n_rows, M] -> (mins
    [n_rows/32, B] f32, max pre, cross bound).  The two maxima scale the
    f32 round-off tolerance of a kernel held against this:

    * int16 (q [2*Dg, B] int8): the digit products run as f32 matmuls
      with TF32 off and are exact (every partial sum is an integer below
      2^24); the bound is max |u*cross|;
    * int8 (q [Dg, B] int8): pre = sum x^2 and cross = x . q are
      integers below 127^2 * M*Ds < 2^24 (M*Ds <= 1040; the GIST shape
      has 960), exact in f32 in any order, then
      cross*u and pre - 2 cross round once each, in the JAX order -- a
      kernel matches this bit for bit; the bound is max |u*cross|;
    * bf16 (q [Dg, B] bf16): x^ and q hold bf16 values, whose products
      are exact in f32; the bound is sqrt(max pre) * max ||q_b||, which
      bounds sum |x^ q| (Cauchy-Schwarz), the size that the f32 sums'
      round-off scales with.

    With G = 2 subspace groups (M > 8) each group's rows decode against
    its own [Mg*K, width] block of ``cwbd`` and meet its own rows of q;
    the groups' x^ are laid side by side and the sums run over the whole
    row at once (the TPU kernel adds the groups' pre and cross in f32).

    Work goes in chunks of ``REF_CHUNK_TILES`` tiles (a quarter of that
    at G = 2) to bound the [rows, B] and [rows, G*Dg] intermediates.
    """
    code = _scan_mode(q, cwbd, M, mode)
    D2, B = q.shape
    dev = q.device
    n_rows = codes.shape[0]
    K = _codebook_k(cwbd, M)
    G = (M + 7) // 8
    Mg = -(-M // G)
    width = cwbd.shape[1]
    bd = cwbd.to(torch.float32).reshape(G * Mg, K, width)
    qf = q.to(torch.float32)
    if code == MODES["int16"]:
        Dg = width // 2
        qa, qb = qf[:G * Dg], qf[G * Dg:]
    if u is None:
        u = torch.ones((1, B), dtype=torch.float32, device=dev)
    mins = torch.empty((n_rows // SUB, B), dtype=torch.float32, device=dev)
    pre_max = 0.0
    cross_max = 0.0
    step = (REF_CHUNK_TILES if G == 1 else REF_CHUNK_TILES // 4) * TILE
    with no_tf32():
        for r0 in range(0, n_rows, step):
            c = codes[r0:r0 + step].to(torch.int64)
            # block-diagonal decode, a group at a time: exactly one
            # subspace is nonzero per column, so the sum over m is exact
            xg = []
            for g in range(G):
                ms = torch.arange(g * Mg, min((g + 1) * Mg, M), device=dev)
                xg.append(bd[ms[None, :], c[:, ms]].sum(dim=1))
            if code == MODES["int16"]:
                xa = torch.cat([x[:, :Dg] for x in xg], dim=1)
                xb = torch.cat([x[:, Dg:] for x in xg], dim=1)
                del xg
                A = 128.0 * xa + xb
                pre = torch.sum(A * A, dim=1, keepdim=True)
                caa = xa @ qa
                p2 = xa @ qb + xb @ qa
                cbb = xb @ qb
                cross = ((16384.0 * caa + 128.0 * p2) + cbb) * u
            else:
                x = torch.cat(xg, dim=1) if G > 1 else xg[0]
                del xg
                pre = torch.sum(x * x, dim=1, keepdim=True)
                cross = x @ qf
                if code == MODES["int8"]:
                    cross = cross * u
            if code != MODES["bf16"]:
                cross_max = max(cross_max, float(cross.abs().max()))
            d = pre - 2.0 * cross
            rows = r0 + torch.arange(c.shape[0], device=dev)
            d = torch.where((rows < n_valid)[:, None], d,
                            torch.full_like(d, float("inf")))
            mins[r0 // SUB:(r0 + c.shape[0]) // SUB] = \
                d.reshape(-1, SUB, B).amin(dim=1)
            pre_max = max(pre_max, float(pre.max()))
    if code == MODES["bf16"]:
        cross_max = pre_max ** 0.5 * float(torch.linalg.vector_norm(
            qf, dim=0).max())
    return mins, pre_max, cross_max


def _check_operands(tensors: dict, dtypes: dict, device) -> None:
    for name, t in tensors.items():
        if t.device != device or not t.is_contiguous() \
                or t.dtype != dtypes[name]:
            raise ValueError(f"{name}: need a contiguous {dtypes[name]} "
                             f"tensor on {device}, got {t.dtype} on "
                             f"{t.device}")


def _compact_operands(q, cwbd, M, compact, u, mode):
    """Device operands of the scan-tail kernels: (cw, nrm, cw_pad, u,
    Ds), with their types and shapes checked against the mode."""
    code = MODES[mode]
    if compact is None:
        raise ValueError("the CUDA scan kernels need compact="
                         "compact_codebook(cwbd, M, Ds, mode)")
    cw, nrm, cw_pad = compact
    B = q.shape[1]
    K = _codebook_k(cwbd, M)
    if code == MODES["bf16"]:
        Ds = 2 * cw.shape[-1]
        want = (M, K, Ds // 2)
        nrm_dtype = torch.float32
        u = torch.ones((1, B), dtype=torch.float32, device=q.device)
    else:
        Ds = 4 * cw.shape[-1]
        want = ((2, M, K, Ds // 4) if code == MODES["int16"]
                else (M, K, Ds // 4))
        nrm_dtype = torch.int64 if code == MODES["int16"] else torch.int32
        if u is None:
            u = torch.ones((1, B), dtype=torch.float32, device=q.device)
    _check_operands(dict(cw=cw, nrm=nrm, u=u),
                    dict(cw=torch.int32, nrm=nrm_dtype, u=torch.float32),
                    q.device)
    G, Mg, Dg_pad = group_geometry(M, Ds)
    planes = 2 if code == MODES["int16"] else 1
    pad_shape = (planes, M, K, wide_sub_bytes(Ds, mode))
    if (tuple(cw.shape) != want or tuple(nrm.shape) != (M, K)
            or q.shape[0] != planes * G * Dg_pad or K > 256
            or u.numel() != B
            or (cw_pad is None) != narrow_shape(M, Ds)
            or (cw_pad is not None and (
                tuple(cw_pad.shape) != pad_shape
                or cw_pad.dtype != torch.uint8 or cw_pad.device != q.device
                or not cw_pad.is_contiguous()))):
        raise ValueError("scan kernel operand shapes disagree with the "
                         "mode")
    if M * pad_shape[3] > WIDE_ROW_BYTES:
        raise NotImplementedError(
            f"the scan kernels stage a query row of at most "
            f"{WIDE_ROW_BYTES} bytes a plane (M={M}, Ds={Ds})")
    if code == MODES["int8"] and M * Ds * 127 * 127 >= 2 ** 24:
        raise NotImplementedError(
            f"the int8 scan is exact in f32 only while 127^2 * M*Ds < "
            f"2^24 (M*Ds <= 1040); got M*Ds = {M * Ds}")
    return cw, nrm, cw_pad, u, Ds


def _launch_name(kernel: str, mode: str) -> str:
    """Launch-count key of a scan kernel in a mode (the names the earlier
    modes were counted under stay)."""
    first = {"stream_mins": "int16", "codes_mins": "bf16",
             "delta_mins": "int16", "stream_mins_pipelined": None}[kernel]
    return kernel if mode == first else f"{kernel}_{mode}"


# --------------------------------------------------------------------------
# B1: stream decode + scan + subtile mins
# --------------------------------------------------------------------------

def decode_stream_tiles_torch(row_data: torch.Tensor, vals: torch.Tensor,
                              meta: torch.Tensor, M: int) -> torch.Tensor:
    """Plain decode of stream tiles to codes [nT*TILE, M] int64 (the
    arithmetic of ``stream_tiles.decode_stream_tiles``, on any device)."""
    nt, P, T = row_data.shape
    planes = row_data.to(torch.int64)
    bit = torch.stack([(planes[:, m // 8, :] >> (m % 8)) & 1
                       for m in range(M)], dim=2)          # [nT, T, M]
    rank = torch.cumsum(bit, dim=2) - bit
    nd = bit.sum(dim=2)
    off = torch.cumsum(nd, dim=1) - nd
    base = meta[0].to(torch.int64) * 1024 + meta[1].to(torch.int64)
    p = base[:, None, None] + off[:, :, None] + rank
    flat = vals.reshape(-1)
    v = flat[(p // 1024) * 1024 + (p % 8) * 128 + (p // 8) % 128]
    rows = torch.arange(T, device=row_data.device)[None, :, None]
    last = torch.where(bit == 1, rows, -1)
    last = torch.cummax(last, dim=1).values                # row 0 is full
    H = torch.gather(v.to(torch.int64), 1, last)
    return H.reshape(nt * T, M)


def narrow_shape(M: int, Ds: int) -> bool:
    """Whether the scan kernels take their narrow tails (one subspace
    group whose row fits a thread's registers) for this shape."""
    return M <= 8 and M * Ds <= 128


def scan_tail_form(kernel: str, M: int, Ds: int) -> str:
    """The tail a scan kernel runs at (M, Ds), picked by shape alone:

    * ``"mma"``: the narrow shapes of every scan kernel -- ``MmaTail``
      (``mma.sync``), queries from ``transpose_queries(q)``;
    * ``"wgmma"``: the wide shapes of ``stream_mins``, ``codes_mins`` and
      ``delta_mins`` -- the gathered ``wgmma`` tail
      (``csrc/wide_mma.cuh``), queries from ``pad_transpose_queries``,
      codebook ``padded_codebook``.

    ``stream_mins_pipelined`` has the narrow form alone and raises
    ``NotImplementedError`` at a wide shape."""
    if kernel not in ("stream_mins", "codes_mins", "delta_mins",
                      "stream_mins_pipelined"):
        raise ValueError(f"no scan kernel {kernel!r}")
    if narrow_shape(M, Ds):
        return "mma"
    if kernel == "stream_mins_pipelined":
        raise NotImplementedError(
            "the pipelined stream kernel takes M <= 8 and M*Ds <= 128")
    return "wgmma"


def scan_queries(kernel: str, q: torch.Tensor, M: int, Ds: int, mode: str
                 ) -> torch.Tensor:
    """The query operand a scan kernel's tail reads (see
    ``scan_tail_form``)."""
    if scan_tail_form(kernel, M, Ds) == "mma":
        return transpose_queries(q)
    return pad_transpose_queries(q, M, Ds, mode)


def transpose_queries(q: torch.Tensor) -> torch.Tensor:
    """The scan kernels' query operand q [planes*Dg, B] -> [B, planes*Dg]
    contiguous: a query's values lie side by side (int16: its a-digits,
    then its b-digits), so the stream kernel stages a block of queries
    with whole 16-byte copies and the decoded kernel reads q [D, B] as
    the K-major operand [B, D] of its tensor-core product."""
    return q.t().contiguous()


def _check_stream_args(q, cwbd, row_data, M, mode, pipelined=False
                       ) -> int:
    code = _scan_mode(q, cwbd, M, mode)
    if row_data.dtype != torch.uint8 or row_data.shape[1] != (M + 7) // 8:
        raise ValueError("row_data must be u8 [nT, ceil(M/8), TILE]")
    if pipelined and (mode == "int16" or M > 8):
        raise NotImplementedError(
            "the pipelined stream kernel takes one subspace group "
            "(M <= 8) at int8 or bf16, as the TPU kernel it replaces")
    return code


def fused_stream_mins_ref(q: torch.Tensor, cwbd: torch.Tensor,
                          row_data: torch.Tensor, vals: torch.Tensor,
                          meta: torch.Tensor, n_valid: int, M: int,
                          u: Optional[torch.Tensor] = None, *, mode: str,
                          pipelined: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     float, float]:
    """Plain PyTorch version of ``fused_stream_mins``, pipelined or not
    (the function is the same).

    Returns (mins [nT*32, B] f32, codes [nT*TILE, M] u8, max pre, cross
    bound); see ``_scan_tail_ref`` for the two maxima."""
    _check_stream_args(q, cwbd, row_data, M, mode, pipelined)
    codes = decode_stream_tiles_torch(row_data, vals, meta, M)
    mins, pre_max, cross_max = _scan_tail_ref(codes, q, cwbd, n_valid, M,
                                              mode, u=u)
    return mins, codes.to(torch.uint8), pre_max, cross_max


def _launch_scan(kernel, mode, q, cwbd, M, compact, u, nt, fn):
    """Shared launch of a scan-tail kernel: checks the codebook operands
    against the mode, allocates the mins [nT*32, B] f32, calls ``fn(qt,
    cw, cw_pad, nrm, u, Ds, mins, stream)`` (the C entry point with the
    kernel's own operands bound; ``qt`` is ``scan_queries``'s operand),
    raises on a failed launch and counts it.  ``qt`` lives until the
    launch has been enqueued, and the allocator hands its memory on only
    in stream order."""
    cw, nrm, cw_pad, u, Ds = _compact_operands(q, cwbd, M, compact, u,
                                               mode)
    qt = scan_queries(kernel, q, M, Ds, mode)
    mins = torch.empty((nt * (TILE // SUB), q.shape[1]),
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(fn(qt.data_ptr(), cw.data_ptr(),
                   None if cw_pad is None else cw_pad.data_ptr(),
                   nrm.data_ptr(), u.data_ptr(), Ds, mins.data_ptr(),
                   stream), kernel)
    build.count(_launch_name(kernel, mode))
    return mins


def fused_stream_mins(q: torch.Tensor, cwbd: torch.Tensor,
                      row_data: torch.Tensor, vals: torch.Tensor,
                      meta: torch.Tensor, n_valid: int, M: int,
                      u: Optional[torch.Tensor] = None,
                      compact: Optional[tuple] = None,
                      *, mode: str, pipelined: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stream tier scan in ``mode`` ("int16", "int8" or "bf16"; the
    operands of each in the module docstring).  row_data [nT, P, TILE]
    u8 (P = ceil(M/8) mask planes); vals [A, 8, 128] u8; meta [2, nT]
    i32.  Returns (mins [nT*32, B] f32, decoded codes [nT*TILE, M] u8).

    On CUDA tensors this launches ``csrc/stream_mins.cu``, or with
    ``pipelined=True`` ``csrc/stream_mins_pipelined.cu`` (M <= 8, D <=
    128, int8 or bf16; anything else raises, where the JAX package goes
    back to its serial kernel without a word); ``compact`` is
    ``compact_codebook(cwbd, M, Ds, mode)`` (the kernels need Ds, which
    ``cwbd`` does not carry).  On CPU tensors it runs the plain version.
    """
    code = _check_stream_args(q, cwbd, row_data, M, mode, pipelined)
    if q.device.type == "cpu":
        return fused_stream_mins_ref(q, cwbd, row_data, vals, meta,
                                     n_valid, M, u=u, mode=mode,
                                     pipelined=pipelined)[:2]
    _check_operands(dict(q=q, row_data=row_data, vals=vals, meta=meta),
                    dict(q=q.dtype, row_data=torch.uint8,
                         vals=torch.uint8, meta=torch.int32), q.device)
    D2, B = q.shape
    nt = row_data.shape[0]
    if row_data.shape[2] != TILE or tuple(meta.shape) != (2, nt):
        raise ValueError("stream kernel operand shapes disagree")
    codes = torch.empty((nt * TILE, M), dtype=torch.uint8, device=q.device)
    K = _codebook_k(cwbd, M)
    if pipelined:
        if (vals.dim() != 3 or tuple(vals.shape[1:]) != (8, 128)
                or row_data.data_ptr() % 16 or vals.data_ptr() % 16):
            raise ValueError("the pipelined stream kernel copies 16-byte "
                             "pieces: vals [A, 8, 128] and 16-byte aligned "
                             "row_data and vals required")

        def launch(qt, cw, cw_pad, nrm, u_, Ds, out, stream):
            return build.library().stream_mins_pipelined_launch(
                qt, cw, nrm, row_data.data_ptr(), vals.data_ptr(),
                meta.data_ptr(), u_, out, codes.data_ptr(), B, D2, nt,
                vals.shape[0], int(n_valid), M, K, Ds, code, stream)

        return _launch_scan("stream_mins_pipelined", mode, q, cwbd,
                            M, compact, u, nt, launch), codes

    def launch(qt, cw, cw_pad, nrm, u_, Ds, out, stream):
        return build.library().stream_mins_launch(
            qt, cw, cw_pad, nrm,
            row_data.data_ptr(), vals.data_ptr(), meta.data_ptr(), u_, out,
            codes.data_ptr(), B, D2 // (2 if code == 0 else 1), nt,
            int(n_valid), M, K, Ds, code, stream)

    return _launch_scan("stream_mins", mode, q, cwbd, M, compact, u,
                        nt, launch), codes


# --------------------------------------------------------------------------
# B3: codes tier (resident u8 codes + the scan tail)
# --------------------------------------------------------------------------

def _check_codes_args(q, cwbd, codes, mode) -> int:
    n_pad, M = codes.shape
    code = _scan_mode(q, cwbd, M, mode)
    if codes.dtype != torch.uint8 or n_pad % TILE:
        raise ValueError("codes must be u8 [N_pad, M], N_pad % 1024 == 0")
    return code


def fused_codes_mins_ref(q: torch.Tensor, cwbd: torch.Tensor,
                         codes: torch.Tensor, n_valid: int,
                         u: Optional[torch.Tensor] = None, *, mode: str
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    float, float]:
    """Plain PyTorch version of ``fused_codes_mins``: (mins, codes echo,
    max pre, cross bound); see ``_scan_tail_ref``."""
    _check_codes_args(q, cwbd, codes, mode)
    mins, pre_max, cross_max = _scan_tail_ref(codes, q, cwbd, n_valid,
                                              codes.shape[1], mode, u=u)
    return mins, codes, pre_max, cross_max


def fused_codes_mins(q: torch.Tensor, cwbd: torch.Tensor,
                     codes: torch.Tensor, n_valid: int,
                     u: Optional[torch.Tensor] = None,
                     compact: Optional[tuple] = None,
                     *, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codes tier scan: q and cwbd as in ``fused_stream_mins``; codes
    [N_pad, M] u8.  Returns (mins [N_pad/32, B] f32, codes echo): the
    echo is ``codes`` itself (the kernel's input, unchanged).

    On CUDA tensors this launches ``csrc/codes_mins.cu``; on CPU tensors
    it runs the plain version."""
    code = _check_codes_args(q, cwbd, codes, mode)
    if q.device.type == "cpu":
        return fused_codes_mins_ref(q, cwbd, codes, n_valid, u=u,
                                    mode=mode)[:2]
    n_pad, M = codes.shape
    _check_operands(dict(q=q, codes=codes),
                    dict(q=q.dtype, codes=torch.uint8), q.device)
    D2, B = q.shape
    nt = n_pad // TILE
    mins = _launch_scan(
        "codes_mins", mode, q, cwbd, M, compact, u, nt,
        lambda qt, cw, cw_pad, nrm, u_, Ds, out, stream:
        build.library().codes_mins_launch(
            qt, cw, cw_pad, nrm, codes.data_ptr(), u_, out, B,
            D2 // (2 if code == 0 else 1), nt, int(n_valid), M,
            _codebook_k(cwbd, M), Ds, code, stream))
    return mins, codes


# --------------------------------------------------------------------------
# B5: slot-tile decode + scan + subtile mins
# --------------------------------------------------------------------------

def decode_delta_tiles_torch(row_data: torch.Tensor, ovf: torch.Tensor,
                             S: int, M: int) -> torch.Tensor:
    """Plain decode of slot tiles to codes [nT*TILE, M] int64 (the
    arithmetic of the TPU kernel's decode, on any device): a row with
    more than S set mask bits is an overflow row and takes its full code
    from the overflow bank at its overflow rank (0 past ``Cap``, as the
    TPU's one-hot scatter gives); another row's j-th set bit takes value
    slot j; the rest is forward-filled down the tile."""
    nt, PS, T = row_data.shape
    Cap = ovf.shape[2]
    P = (M + 7) // 8
    rd = row_data.to(torch.int64)
    bit = torch.stack([(rd[:, m // 8, :] >> (m % 8)) & 1
                       for m in range(M)], dim=1)          # [nT, M, T]
    rank = torch.cumsum(bit, dim=1) - bit
    is_ovf = bit.sum(dim=1, keepdim=True) > S               # [nT, 1, T]
    ovf_rank = torch.cumsum(is_ovf.to(torch.int64), dim=2) - is_ovf.to(
        torch.int64)
    slot = torch.gather(rd, 1, P + rank.clamp(0, S - 1))   # [nT, M, T]
    ov = torch.gather(ovf.to(torch.int64), 2,
                      ovf_rank.clamp(0, Cap - 1).expand(nt, M, T))
    ov = torch.where(ovf_rank < Cap, ov, torch.zeros_like(ov))
    H = torch.where(is_ovf, ov, torch.where(bit == 1, slot, -1))
    rows = torch.arange(T, device=row_data.device)[None, None, :]
    last = torch.cummax(torch.where(H >= 0, rows, -1), dim=2).values
    H = torch.gather(H, 2, last.clamp_min(0))              # row 0 is full
    return H.transpose(1, 2).reshape(nt * T, M)


def _check_delta_args(q, cwbd, row_data, ovf, S, mode) -> int:
    M = ovf.shape[1]
    code = _scan_mode(q, cwbd, M, mode)
    if (row_data.dtype != torch.uint8 or ovf.dtype != torch.uint8
            or row_data.shape[1] != (M + 7) // 8 + S
            or row_data.shape[2] != TILE
            or ovf.shape[0] != row_data.shape[0] or not 1 <= S < M):
        raise ValueError("slot tiles: row_data u8 [nT, ceil(M/8)+S, TILE] "
                         "and ovf u8 [nT, M, Cap] with 1 <= S < M required")
    return code


def fused_delta_mins_ref(q: torch.Tensor, cwbd: torch.Tensor,
                         row_data: torch.Tensor, ovf: torch.Tensor,
                         n_valid: int, S: int,
                         u: Optional[torch.Tensor] = None, *, mode: str
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    float, float]:
    """Plain PyTorch version of ``fused_delta_mins``:
    (mins [nT*32, B] f32, codes [nT*TILE, M] u8, max pre, cross bound);
    see ``_scan_tail_ref``."""
    _check_delta_args(q, cwbd, row_data, ovf, S, mode)
    M = ovf.shape[1]
    codes = decode_delta_tiles_torch(row_data, ovf, S, M)
    mins, pre_max, cross_max = _scan_tail_ref(codes, q, cwbd, n_valid, M,
                                              mode, u=u)
    return mins, codes.to(torch.uint8), pre_max, cross_max


def fused_delta_mins(q: torch.Tensor, cwbd: torch.Tensor,
                     row_data: torch.Tensor, ovf: torch.Tensor,
                     n_valid: int, S: int,
                     u: Optional[torch.Tensor] = None,
                     compact: Optional[tuple] = None,
                     *, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot-tile scan (``delta_tiles.py``, M <= 16): row_data [nT, P+S,
    TILE] u8 (P = ceil(M/8) mask planes + S value slots), ovf [nT, M,
    Cap] u8 overflow bank; q, cwbd, u and ``mode`` as in ``fused_stream_mins``.  Returns
    (mins [nT*32, B] f32, decoded codes [nT*TILE, M] u8).

    On CUDA tensors this launches ``csrc/delta_mins.cu``; on CPU tensors
    it runs the plain version."""
    code = _check_delta_args(q, cwbd, row_data, ovf, S, mode)
    if q.device.type == "cpu":
        return fused_delta_mins_ref(q, cwbd, row_data, ovf, n_valid, S,
                                    u=u, mode=mode)[:2]
    _check_operands(dict(q=q, row_data=row_data, ovf=ovf),
                    dict(q=q.dtype, row_data=torch.uint8, ovf=torch.uint8),
                    q.device)
    D2, B = q.shape
    nt, M, Cap = ovf.shape
    codes = torch.empty((nt * TILE, M), dtype=torch.uint8, device=q.device)
    mins = _launch_scan(
        "delta_mins", mode, q, cwbd, M, compact, u, nt,
        lambda qt, cw, cw_pad, nrm, u_, Ds, out, stream:
        build.library().delta_mins_launch(
            qt, cw, cw_pad, nrm, row_data.data_ptr(), ovf.data_ptr(), u_,
            out, codes.data_ptr(), B, D2 // (2 if code == 0 else 1), nt,
            int(n_valid), M, _codebook_k(cwbd, M), Ds, S, Cap, code,
            stream))
    return mins, codes


# --------------------------------------------------------------------------
# B4: decoded tier (resident bf16 x^ rows)
# --------------------------------------------------------------------------

def _check_decoded_args(q, xt):
    if q.dtype != torch.bfloat16 or xt.dtype != torch.bfloat16 \
            or xt.dim() != 3 or xt.shape[2] != q.shape[0] \
            or xt.shape[1] % SUB:
        raise ValueError("decoded scan: q [D, B] bf16 and xt [nT, tile, D] "
                         "bf16 with tile % 32 == 0 required")


def fused_decoded_mins_ref(q: torch.Tensor, xt: torch.Tensor,
                           n_valid: int
                           ) -> Tuple[torch.Tensor, float, float]:
    """Plain version of ``fused_decoded_mins``: (mins, max pre, cross
    bound), the bound as in the bf16 mode of ``_scan_tail_ref``."""
    _check_decoded_args(q, xt)
    D, B = q.shape
    x_all = xt.reshape(-1, D)
    n_rows = x_all.shape[0]
    qf = q.to(torch.float32)
    mins = torch.empty((n_rows // SUB, B), dtype=torch.float32,
                       device=q.device)
    pre_max = 0.0
    step = REF_CHUNK_TILES * TILE
    with no_tf32():
        for r0 in range(0, n_rows, step):
            x = x_all[r0:r0 + step].to(torch.float32)
            pre = torch.sum(x * x, dim=1, keepdim=True)
            d = pre - 2.0 * (x @ qf)
            rows = r0 + torch.arange(x.shape[0], device=q.device)
            d = torch.where((rows < n_valid)[:, None], d,
                            torch.full_like(d, float("inf")))
            mins[r0 // SUB:(r0 + x.shape[0]) // SUB] = \
                d.reshape(-1, SUB, B).amin(dim=1)
            pre_max = max(pre_max, float(pre.max()))
    cross_max = pre_max ** 0.5 * float(torch.linalg.vector_norm(
        qf, dim=0).max())
    return mins, pre_max, cross_max


def fused_decoded_mins(q: torch.Tensor, xt: torch.Tensor, n_valid: int
                       ) -> torch.Tensor:
    """Subtile minima [N_pad/32, B] of ``pre - 2 cross`` over the whole
    database: q [D, B] bf16, xt [nT, tile, D] bf16; rows >= n_valid map
    to +inf.  On CUDA tensors this launches ``csrc/decoded_mins.cu``; on
    CPU tensors it runs the plain version."""
    _check_decoded_args(q, xt)
    if q.device.type == "cpu":
        return fused_decoded_mins_ref(q, xt, n_valid)[0]
    _check_operands(dict(q=q, xt=xt),
                    dict(q=torch.bfloat16, xt=torch.bfloat16), q.device)
    D, B = q.shape
    n_rows = xt.shape[0] * xt.shape[1]
    if D % 8 or D > 2048:
        raise NotImplementedError(
            "the decoded kernel takes D % 8 == 0 and D <= 2048")
    # the kernel reads both operands with a row's D values side by side
    qt = transpose_queries(q)
    if qt.data_ptr() % 16 or xt.data_ptr() % 16:
        raise ValueError("the decoded kernel copies 16-byte pieces: q and "
                         "xt must be 16-byte aligned")
    mins = torch.empty((n_rows // SUB, B), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.library().decoded_mins_launch(
        qt.data_ptr(), xt.data_ptr(), mins.data_ptr(), B, D, n_rows,
        int(n_valid), stream)
    build.check(err, "decoded_mins")
    build.count("decoded_mins")
    return mins


# --------------------------------------------------------------------------
# B2: exact rerank table sums
# --------------------------------------------------------------------------

def rerank_table_sums_ref(tab_flat: torch.Tensor, cand_codes: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version: sum_m T[b, m, code] added in ascending m from 0.0
    (bit-equal to the plain scan)."""
    B, MK = tab_flat.shape
    _, M, S = cand_codes.shape
    K = MK // M
    acc = torch.zeros((B, S), dtype=torch.float32, device=tab_flat.device)
    for m in range(M):
        acc = acc + torch.gather(tab_flat[:, m * K:(m + 1) * K], 1,
                                 cand_codes[:, m, :].to(torch.int64))
    return acc


def rerank_table_sums(tab_flat: torch.Tensor, cand_codes: torch.Tensor
                      ) -> torch.Tensor:
    """tab_flat [B, M*K] f32; cand_codes [B, M, S] u8 (int32 for K > 256)
    -> exact f32 distances [B, S]."""
    B, MK = tab_flat.shape
    Bc, M, S = cand_codes.shape
    if Bc != B or MK % M or tab_flat.dtype != torch.float32 \
            or cand_codes.dtype not in (torch.uint8, torch.int32):
        raise ValueError("rerank: tab_flat [B, M*K] f32 and cand_codes "
                         "[B, M, S] u8/i32 required")
    if tab_flat.device.type == "cpu":
        return rerank_table_sums_ref(tab_flat, cand_codes)
    if cand_codes.device != tab_flat.device or MK > 12288 \
            or not (tab_flat.is_contiguous()
                    and cand_codes.is_contiguous()):
        raise ValueError("rerank: contiguous operands on one device, "
                         "M*K <= 12288 required")
    out = torch.empty((B, S), dtype=torch.float32, device=tab_flat.device)
    stream = torch.cuda.current_stream(tab_flat.device).cuda_stream
    err = build.library().rerank_launch(
        tab_flat.data_ptr(), cand_codes.data_ptr(), out.data_ptr(),
        B, M, MK // M, S, cand_codes.element_size(), stream)
    build.check(err, "rerank")
    build.count("rerank")
    return out


# --------------------------------------------------------------------------
# Selection epilogue
# --------------------------------------------------------------------------

def _fence_margin(fence: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """bf16-domain error allowance for the certificate (bf16 mode)."""
    return 0.02 * (torch.abs(fence) + q2 + 1.0)


def pool_mins_nb(mins_nb: torch.Tensor, pool: int) -> torch.Tensor:
    """Min-pool kernel-layout mins [NS, B] by ``pool`` along NS, then
    transpose -> [B, NS/pool]."""
    NS, B = mins_nb.shape
    pad = (-NS) % pool
    if pad:
        mins_nb = torch.cat(
            [mins_nb, torch.full((pad, B), float("inf"),
                                 dtype=mins_nb.dtype,
                                 device=mins_nb.device)], dim=0)
    if pool == 1:
        return mins_nb.t().contiguous()
    return mins_nb.reshape(-1, pool, B).amin(dim=1).t().contiguous()


def _smallest(x: torch.Tensor, k: int):
    """(values, indices) of the k smallest along the last axis,
    ascending (``lax.top_k`` of the negation)."""
    return torch.topk(x, k, dim=-1, largest=False, sorted=True)


def _select_units(mins: torch.Tensor, n_sub: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick the ``n_sub`` candidate units and the exactness fence from
    pooled mins [B, NU]: every unit not in ``sub_ids`` has min >= fence.
    Large NU runs the two-level exact selection (coarse groups of 16,
    then units inside the selected groups)."""
    B, NU = mins.shape
    C = 16
    nc = min(max(4 * n_sub, 64), NU // C - 1)
    if NU <= 16384 or nc < 1 or nc * C <= n_sub:
        v, sub_ids = _smallest(mins, n_sub + 1)
        return sub_ids[:, :n_sub], v[:, n_sub]
    pad = (-NU) % C
    if pad:
        mins = torch.cat([mins, torch.full((B, pad), float("inf"),
                                           dtype=mins.dtype,
                                           device=mins.device)], dim=1)
    mc = mins.reshape(B, -1, C)                          # [B, NC, C]
    cmins = mc.amin(dim=2)                               # [B, NC]
    cv, cids = _smallest(cmins, nc + 1)
    cfence = cv[:, nc]
    cids = cids[:, :nc]
    fine = torch.gather(mc, 1, cids[:, :, None].expand(B, nc, C))
    fv, fpos = _smallest(fine.reshape(B, nc * C), n_sub + 1)
    ffence = fv[:, n_sub]
    fpos = fpos[:, :n_sub]
    sub_ids = (torch.gather(cids, 1, fpos // C) * C + fpos % C)
    return sub_ids, torch.minimum(cfence, ffence)


def select_rerank(mins: torch.Tensor, q2: torch.Tensor,
                  table: torch.Tensor, codes: torch.Tensor, n_valid: int,
                  top_k: int, n_sub: int, pool: int = 1,
                  prepooled: bool = False,
                  err_r: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Candidate selection + exact rerank.

    mins [B, NS] subtile minima (+inf on padding); q2 [B]; table
    [B, M, K] exact f32 ADC tables; codes [N_pad, M] u8 in scan order --
    the scan kernel's decoded-codes echo, so no plain code array stays
    resident.  Returns (dists [B, top_k] exact f32 ascending, rows
    [B, top_k] scan-order row ids, ok [B] exactness certificate)."""
    B, NS = mins.shape
    M, K = table.shape[1], table.shape[2]
    dev = mins.device
    unit = SUB * pool
    if pool > 1 and not prepooled:
        pad = (-NS) % pool
        if pad:
            mins = torch.cat([mins, torch.full((B, pad), float("inf"),
                                               dtype=mins.dtype,
                                               device=dev)], dim=1)
        mins = mins.reshape(B, -1, pool).amin(dim=2)
    S = n_sub * unit
    sub_ids, fence = _select_units(mins, n_sub)
    rows = (sub_ids[:, :, None] * unit
            + torch.arange(unit, device=dev)[None, None, :]).reshape(B, S)
    # block-granular gather of the candidates' codes: B*n_sub contiguous
    # unit-row slices of the echo
    n_units_total = codes.shape[0] // unit
    safe_units = torch.clamp(sub_ids, 0, n_units_total - 1)
    cw = codes.reshape(n_units_total, unit * M)[safe_units]
    cand = cw.reshape(B, S, M).transpose(1, 2).contiguous()  # [B, M, S]
    exact = rerank_table_sums(table.reshape(B, M * K).contiguous(), cand)
    exact = torch.where(rows < n_valid, exact,
                        torch.full_like(exact, float("inf")))
    k_eff = min(top_k, S)
    d, pos = _smallest(exact, k_eff)
    out_rows = torch.gather(rows, 1, pos)
    if k_eff < top_k:
        pad = top_k - k_eff
        d = torch.cat([d, torch.full((B, pad), float("inf"),
                                     dtype=d.dtype, device=dev)], dim=1)
        out_rows = torch.cat([out_rows, torch.full(
            (B, pad), -1, dtype=out_rows.dtype, device=dev)], dim=1)
    if err_r is not None:
        # quantized-domain certificate: every row of an unselected unit
        # has true distance >= (sqrt(fence + q2) - err_r)^2
        ft = torch.clamp_min(fence + q2, 0.0)
        root = torch.clamp_min(torch.sqrt(ft) - err_r, 0.0)
        ok = d[:, k_eff - 1] <= root * root
    else:
        ok = (d[:, k_eff - 1] - q2) <= fence - _fence_margin(fence, q2)
    return d, out_rows, ok
