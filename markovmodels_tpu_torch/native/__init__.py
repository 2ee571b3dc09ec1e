"""C++ native host runtime (ctypes bindings).

The device compute path is PyTorch with hand-written CUDA kernels; this
package is the *host* native layer, the port's own copy of
``markovmodels_tpu/native`` — the counterpart to the reference's native surface
(CUSPARSE conversions, reference src/linalg.jl:12-67, and GPU array-assembly
routines :69-157). It accelerates the AOT graph compiler: COO→CSR semiring
assembly, CSR transpose, segment ⊕-reduction, and OpenFST-text parsing.

The shared library is compiled from ``src/mm_native.cpp`` with g++ on first
use and cached (keyed on a source hash) under
``~/.cache/markovmodels_tpu_torch``, apart from the JAX package's build.
Everything degrades gracefully: if the toolchain or build is unavailable,
``available()`` is False and callers keep their vectorized-numpy fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

__all__ = [
    "available",
    "coo_to_csr",
    "csr_transpose",
    "segment_reduce",
    "parse_fst_text",
    "ADD_OPS",
]

_SRC = os.path.join(os.path.dirname(__file__), "src", "mm_native.cpp")
_CXXFLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp"]

# semiring-name -> native MMAddOp code (mm_native.cpp). bool's ⊕ is max on
# {0,1} values, so it shares the tropical code.
ADD_OPS = {"log": 0, "tropical": 1, "bool": 1, "prob": 2}

_lib = None
_tried = False

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _cache_dir() -> str:
    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    d = os.path.join(base, "markovmodels_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_CXXFLAGS).encode()).hexdigest()[:16]
    so = os.path.join(_cache_dir(), f"mm_native_{digest}.so")
    if os.path.exists(so):
        return so
    for extra in (["-march=native"], []):  # retry without -march=native
        tmp = tempfile.mktemp(suffix=".so", dir=_cache_dir())
        cmd = ["g++", *_CXXFLAGS, *extra, "-o", tmp, _SRC]
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if r.returncode == 0:
            os.replace(tmp, so)  # atomic: concurrent builders race safely
            return so
    return None


def _get():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("MM_TPU_NO_NATIVE"):
        return None
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    c = ctypes.c_int64
    i32 = ctypes.c_int32
    lib.mm_coo_to_csr.restype = c
    lib.mm_coo_to_csr.argtypes = [c, c, _I64, _I64, _F64, i32, _I64, _I64, _F64]
    lib.mm_csr_transpose.restype = i32
    lib.mm_csr_transpose.argtypes = [c, c, c, _I64, _I64, _F64, _I64, _I64, _F64]
    lib.mm_segment_reduce.restype = i32
    lib.mm_segment_reduce.argtypes = [c, _I64, _F64, i32, ctypes.c_double, _F64]
    lib.mm_fst_text_count.restype = i32
    lib.mm_fst_text_count.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(c), ctypes.POINTER(c)
    ]
    lib.mm_fst_text_fill.restype = i32
    lib.mm_fst_text_fill.argtypes = [
        ctypes.c_char_p, _I64, _I64, _I64, _I64, _F64, _I64, _F64
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _get() is not None


def coo_to_csr(rows, cols, data, nrows: int, sr_name: str):
    """(indptr, col_indices, values) with duplicates ⊕-coalesced; or None."""
    lib = _get()
    if lib is None or sr_name not in ADD_OPS:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.float64)
    nnz = len(rows)
    indptr = np.empty(nrows + 1, dtype=np.int64)
    out_cols = np.empty(nnz, dtype=np.int64)
    out_data = np.empty(nnz, dtype=np.float64)
    n = lib.mm_coo_to_csr(
        nnz, nrows, rows, cols, data, ADD_OPS[sr_name], indptr, out_cols, out_data
    )
    if n < 0:
        raise ValueError("mm_coo_to_csr: coordinates out of range")
    return indptr, out_cols[:n].copy(), out_data[:n].copy()


def csr_transpose(shape, indptr, indices, data):
    """Transpose a unique-coordinate CSR matrix; returns arrays or None."""
    lib = _get()
    if lib is None:
        return None
    m, n = shape
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.float64)
    out_indptr = np.empty(n + 1, dtype=np.int64)
    out_indices = np.empty(len(indices), dtype=np.int64)
    out_data = np.empty(len(data), dtype=np.float64)
    if lib.mm_csr_transpose(
        m, n, len(indices), indptr, indices, data, out_indptr, out_indices, out_data
    ) != 0:
        raise ValueError("mm_csr_transpose: indices out of range")
    return out_indptr, out_indices, out_data


def segment_reduce(indptr, contrib, sr_name: str, zero: float):
    """Per-row ⊕-reduce of CSR-grouped contributions; or None."""
    lib = _get()
    if lib is None or sr_name not in ADD_OPS:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    contrib = np.ascontiguousarray(contrib, dtype=np.float64)
    out = np.empty(len(indptr) - 1, dtype=np.float64)
    if lib.mm_segment_reduce(
        len(indptr) - 1, indptr, contrib, ADD_OPS[sr_name], zero, out
    ) != 0:
        raise ValueError("mm_segment_reduce: bad op")
    return out


def parse_fst_text(path: str):
    """Parse an OpenFST text graph (reference misc/benchmark format).

    Returns dict with arrays ``src dst ilabel olabel weight`` (arcs) and
    ``final_state final_weight``; or None when the native lib is unavailable
    (callers fall back to a Python parser).
    """
    lib = _get()
    if lib is None:
        return None
    n_arcs = ctypes.c_int64()
    n_fin = ctypes.c_int64()
    p = path.encode()
    if lib.mm_fst_text_count(p, ctypes.byref(n_arcs), ctypes.byref(n_fin)) != 0:
        raise FileNotFoundError(path)
    na, nf = n_arcs.value, n_fin.value
    src = np.empty(na, np.int64)
    dst = np.empty(na, np.int64)
    ilab = np.empty(na, np.int64)
    olab = np.empty(na, np.int64)
    w = np.empty(na, np.float64)
    fstate = np.empty(nf, np.int64)
    fw = np.empty(nf, np.float64)
    if lib.mm_fst_text_fill(p, src, dst, ilab, olab, w, fstate, fw) != 0:
        raise FileNotFoundError(path)
    return {
        "src": src, "dst": dst, "ilabel": ilab, "olabel": olab, "weight": w,
        "final_state": fstate, "final_weight": fw,
    }
