"""Build and load the native shared library (g++ -O3, cached).

The library lands in ``_build/native-<hash>/libdtc_native.so`` inside
the package, where ``<hash>`` covers the source and the flags, so a
stale library is never loaded after either changes; nothing is written
next to the source.  Each process compiles to a temporary name of its
own and renames it into place, so processes that build at once (test
workers) never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "dtc_native.cpp"
BUILD_DIR = SRC.parent.parent / "_build"
LIB_NAME = "libdtc_native.so"
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def lib_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}" / LIB_NAME


def build(force: bool = False) -> Path:
    """Compile the library (or reuse the one already built from the same
    source and flags).  Raises ``OSError`` or
    ``subprocess.SubprocessError`` when g++ is missing or fails."""
    lib = lib_path()
    if lib.exists() and not force:
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"{LIB_NAME}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_u32p = ctypes.POINTER(ctypes.c_uint32)
    c_f32p = ctypes.POINTER(ctypes.c_float)
    ll, i = ctypes.c_longlong, ctypes.c_int
    sigs = {
        "dtc_decode": [c_u8p, ll, ll, i, c_u8p],
        "dtc_parse": [c_u8p, ll, ll, i, c_u8p, c_u8p, c_i64p, c_u8p],
        "dfs_layout": [ll, c_u32p, c_i64p, ctypes.c_uint32, c_u32p, c_i32p,
                       c_u8p, c_i64p],
        "scan_query": [c_u8p, ll, i, i, c_f32p, i, c_f32p, c_i64p],
        "diff_index_decode": [c_u8p, ll, ll, i, c_u8p],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.restype = ll
        fn.argtypes = args
    return lib


def _build() -> bool:
    """Compile afresh; False when g++ is missing or fails."""
    try:
        build(force=True)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if not lib_path().exists() and not _build():
            _failed = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(lib_path())))
        except OSError:
            _failed = True
        return _lib


def have_native() -> bool:
    return get_lib() is not None
