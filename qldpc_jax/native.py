"""ctypes bindings to the native bit-packed GF(2) library (native/gf2.cpp).

The shared library is not committed: it is built from native/gf2.cpp on
first use when a C++ compiler is available (``python -m qldpc_jax.native``
builds it explicitly). Every entry point except ``osd0`` has a NumPy
fallback, so the framework works without the native layer.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["available", "build", "rank", "rref", "solve", "osd0", "nullspace"]

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SRC_PATH = _NATIVE_DIR / "gf2.cpp"
_LIB_PATH = _NATIVE_DIR / "libqldpc_gf2.so"
_lib = None
_tried = False


def build() -> Path:
    """Compile native/gf2.cpp into native/libqldpc_gf2.so.

    The library is written to a temporary name and renamed into place, so
    concurrent first uses (test workers) never load a half-written file."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found to build native/gf2.cpp")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_NATIVE_DIR)
    os.close(fd)
    try:
        subprocess.run(
            [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-o", tmp,
             str(_SRC_PATH)],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _LIB_PATH


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        if not _LIB_PATH.exists() or (
            _LIB_PATH.stat().st_mtime < _SRC_PATH.stat().st_mtime
        ):
            build()
        lib = ctypes.CDLL(str(_LIB_PATH))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    c = ctypes.c_int
    lib.gf2_rank.argtypes = [u8, c, c]
    lib.gf2_rank.restype = c
    lib.gf2_rref.argtypes = [u8, u8, c, c, i32]
    lib.gf2_rref.restype = c
    lib.gf2_solve.argtypes = [u8, u8, c, c, u8]
    lib.gf2_solve.restype = c
    lib.gf2_osd0.argtypes = [u8, u8, f64, u8, c, c, u8]
    lib.gf2_osd0.restype = c
    lib.gf2_nullspace.argtypes = [u8, c, c, u8]
    lib.gf2_nullspace.restype = c
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _as_u8(M) -> np.ndarray:
    return np.ascontiguousarray((np.asarray(M) % 2).astype(np.uint8))


def rank(M) -> int:
    lib = _load()
    M = _as_u8(M)
    if lib is None:
        from qldpc_jax.codes import gf2

        return gf2.rank(M)
    m, n = M.shape
    return int(lib.gf2_rank(M, m, n))


def rref(M, b=None):
    """Full RREF of [M | b]; returns (R, b_reduced, pivot_cols)."""
    lib = _load()
    M = _as_u8(M).copy()
    m, n = M.shape
    bb = _as_u8(b).copy().ravel() if b is not None else np.zeros(m, np.uint8)
    if lib is None:
        from qldpc_jax.codes import gf2

        R, piv = gf2.row_reduce(np.hstack([M, bb[:, None]]), ncols=n)
        return R[:, :n], R[:, n], piv
    piv = np.full(m, -1, np.int32)
    r = int(lib.gf2_rref(M, bb, m, n, piv))
    return M, bb, [int(c) for c in piv[:r]]


def solve(H, s):
    lib = _load()
    H = _as_u8(H)
    s = _as_u8(s).ravel()
    if lib is None:
        from qldpc_jax.codes import gf2

        return gf2.solve(H, s)
    m, n = H.shape
    x = np.zeros(n, np.uint8)
    ok = int(lib.gf2_solve(H, s, m, n, x))
    return x if ok else None


def osd0(H, syndrome, llr, hard):
    """Native OSD-0 (reference semantics, decoding/OSD.py:3-28)."""
    lib = _load()
    H = _as_u8(H)
    m, n = H.shape
    syndrome = _as_u8(syndrome).ravel()
    hard = _as_u8(hard).ravel()
    llr = np.ascontiguousarray(np.asarray(llr, np.float64).ravel())
    if lib is None:
        raise RuntimeError("native gf2 library unavailable")
    sol = np.zeros(n, np.uint8)
    lib.gf2_osd0(H, syndrome, llr, hard, m, n, sol)
    return sol


def nullspace(M) -> np.ndarray:
    lib = _load()
    M = _as_u8(M)
    if lib is None:
        from qldpc_jax.codes import gf2

        return gf2.null_space(M)
    m, n = M.shape
    r = int(lib.gf2_rank(M, m, n))
    basis = np.zeros(((n - r), n), np.uint8)
    if n - r:
        lib.gf2_nullspace(M, m, n, basis)
    return basis


if __name__ == "__main__":
    print(build())
    sys.exit(0)
