"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are bound with ``ctypes``:
``nvcc`` compiles every source in ``csrc/`` for Hopper (``sm_90a``) at
first use -- one ``nvcc -c`` process per source, all started together --
and links the objects into one shared library in ``_build/<hash>/``
inside the package, where ``<hash>`` covers the sources, the headers and
the flags, so a stale library is never loaded after a source changes.
Nothing is built when the module is imported; the CPU tests import it
freely.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an
exception, so a refused launch never passes silently.  Each wrapper then
calls ``count`` with its kernel's name: ``LAUNCHES`` counts the kernel
launches (never the plain versions), so a caller can show which kernels
a path ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libdeltapq_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures: every pointer and the stream are ``c_void_p`` (a plain
#: int would be cut to 32 bits), every size ``c_int``.
SIGNATURES = {
    # qt, cw, cw_pad, nrm, row_data, vals, meta, u, mins, codes_out,
    # B, Dg, nT, n_valid, M, K, Ds, mode, stream
    "stream_mins_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, cw, nrm, row_data, vals, meta, u, mins, codes_out,
    # B, Dg, nT, n_groups, n_valid, M, K, Ds, mode, stream
    "stream_mins_pipelined_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # qt, cw, cw_pad, nrm, codes, u, mins,
    # B, Dg, nT, n_valid, M, K, Ds, mode, stream
    "codes_mins_launch": [_P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # qt, cw, cw_pad, nrm, row_data, ovf, u, mins, codes_out,
    # B, Dg, nT, n_valid, M, K, Ds, S, Cap, mode, stream
    "delta_mins_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # qt, xt, mins, B, D, n_rows, n_valid, stream
    "decoded_mins_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
    # tab, codes, out_d, out_i, B, M, K, n_pad, tile_n, n_valid, top_k,
    # code_bytes, prec, stream
    "adc_topk_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _P],
    # tab, codes, out, B, M, K, n, rows, QC, code_bytes, stream
    "adc_dists_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # tab, codes, out, B, M, K, n_pad, tile_n, n_valid, top_k, QC,
    # code_bytes, prec, stream
    "adc_topk_packed_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _P],
    # tab, idx, dict, out, B, M, K, D, n_pad, tile_n, n_valid, top_k, QC,
    # stream
    "adc_topk_tiledict_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _P],
    # tab, cand, out, B, M, K, S, code_bytes, stream
    "rerank_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
}


@dataclass
class BuildInfo:
    path: Path
    seconds: float      # nvcc wall time; 0.0 when a cached library loaded
    log: str            # nvcc's output (``-Xptxas -v`` register report)


_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def nvcc_path() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the "
                           "CUDA kernels cannot be built on this host")
    return cand


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands concurrently; returns [(cmd, returncode, log)]."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    out = []
    for c, p in procs:
        log, _ = p.communicate()
        out.append((c, p.returncode, log))
    return out


def build(force: bool = False) -> BuildInfo:
    """Compile ``csrc/*.cu`` into the hashed build directory (or reuse
    a library already built from the same sources and flags)."""
    out_dir = BUILD_DIR / _digest()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    if lib.exists() and not force:
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(lib, 0.0, log)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.tmp"
    objs, cmds = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{tag}.o"
        objs.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    results = _run_all(cmds)
    log = "".join(out for _, _, out in results)
    failed = [(c, rc, out) for c, rc, out in results if rc != 0]
    if not failed:
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                "-shared", "-o", str(tmp), *map(str, objs)]
        (c, rc, out), = _run_all([link])
        log += out
        if rc != 0:
            failed = [(c, rc, out)]
    secs = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        c, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(c)}\n{out}")
    log_path.write_text(log)
    os.replace(tmp, lib)          # atomic: concurrent builds agree
    return BuildInfo(lib, secs, log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from a launch."""
    if err != 0:
        msg = library().kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: error {err} "
                           f"({msg})")


#: kernel launches made by the wrappers (not by the plain versions), one
#: key per kernel and scan mode: stream_mins (int16), codes_mins (bf16),
#: delta_mins (int16), adc_topk (f32) and adc_topk_packed (f32) carry
#: their first mode's bare name
LAUNCHES = {"stream_mins": 0, "stream_mins_bf16": 0, "stream_mins_int8": 0,
            "stream_mins_pipelined_int8": 0, "stream_mins_pipelined_bf16": 0,
            "codes_mins": 0, "codes_mins_int16": 0, "codes_mins_int8": 0,
            "delta_mins": 0, "delta_mins_int8": 0, "delta_mins_bf16": 0,
            "decoded_mins": 0, "adc_topk": 0, "rerank": 0,
            "adc_topk_bf16": 0, "adc_topk_bf16x2": 0, "adc_dists": 0,
            "adc_topk_packed": 0, "adc_topk_packed_bf16": 0,
            "adc_topk_packed_bf16x2": 0, "adc_topk_tiledict": 0}


def count(kernel: str) -> None:
    """Record one launch of ``kernel``; a wrapper calls it after
    ``check`` passed, and nowhere else."""
    LAUNCHES[kernel] += 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)
