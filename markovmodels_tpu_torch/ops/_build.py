"""Build and load the CUDA kernels of the port.

The sources under ``csrc/`` have a plain C interface.  At first use each is
compiled with nvcc for Hopper (``sm_90a``), all at once in parallel, and the
objects are linked into one shared library under
``build/markovmodels_tpu_torch/`` at the root of the checkout, named by a
hash of the sources and flags, and bound with ctypes.  A build or load
failure raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["library", "build_dir", "error_string", "PTXAS_LOG"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("block_scan.cu", "banded_scan.cu", "dense_scan.cu",
            "vit_scan.cu", "rec_walk.cu")
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None
PTXAS_LOG = ""  # register / shared-memory report of the last build

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of each C entry point (pointers and the stream as c_void_p)
_SIGNATURES = {
    "mm_block_fwd": [_P] * 11 + [_I] * 8 + [_P] * 13,
    "mm_block_recompute": [_P] * 10 + [_I] * 8 + [_P] * 7,
    "mm_block_bwd": [_P] * 12 + [_I] * 7 + [_P] * 10,
    "mm_block_ctas": [_I] * 4,
    "mm_banded_fwd": [_P] * 12 + [_I, _P],
    "mm_banded_bwd": [_P] * 9 + [_I, _P],
    "mm_banded_smem": [_I] * 4,
    "mm_dense_fwd": [_P] * 6 + [_I] * 2 + [_P] * 4 + [_I] * 6 + [_P] * 9,
    "mm_dense_bwd": [_P] * 6 + [_I] * 2 + [_P] * 6 + [_I] * 5 + [_P] * 8,
    "mm_dense_trop": [_P] * 6 + [_I] * 2 + [_P] * 4 + [_I] * 7 + [_P] * 8,
    "mm_vit_fwd": [_P] * 10 + [_I] * 6 + [_P] * 8 + [ctypes.c_longlong, _P],
    "mm_vit_fwd_noid": ([_P] * 11 + [_I] * 8 + [_P] * 3 + [_I] + [_P] * 5
                        + [ctypes.c_longlong, _P]),
    "mm_vit_ctas": [_I] * 5,
    "mm_vit_layout": [_I] * 3 + [_P],
    "mm_vit_walk": [_P] * 8 + [_I] * 11 + [_P] * 2,
    "mm_rec_walk": [_P] * 7 + [_I] * 7 + [_P] * 3,
}


def build_dir() -> Path:
    """``build/markovmodels_tpu_torch`` at the root of the checkout."""
    return _CSRC.parents[2] / "build" / "markovmodels_tpu_torch"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    home = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    if nvcc is None and os.path.exists(home):
        nvcc = home
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _LIB, PTXAS_LOG
    if _LIB is not None:
        return _LIB
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in sorted(os.listdir(_CSRC)):
        h.update(name.encode() + (_CSRC / name).read_bytes())
    out = build_dir() / f"libmm_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        nvcc = _nvcc()
        objs = [tmp.with_name(f"{tmp.name}.{Path(s).stem}.o") for s in _SOURCES]
        jobs = [subprocess.Popen([nvcc, *_FLAGS, "-c", "-o", str(o),
                                  str(_CSRC / s)],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for s, o in zip(_SOURCES, objs)]
        logs = [j.communicate()[0] for j in jobs]
        link = None
        if all(j.returncode == 0 for j in jobs):
            link = subprocess.run(
                [nvcc, *_FLAGS[:2], "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
        for o in objs:
            o.unlink(missing_ok=True)
        if link is None or link.returncode != 0:
            codes = [j.returncode for j in jobs] + (
                [link.returncode] if link else [])
            raise RuntimeError(f"nvcc failed ({codes}):\n" + "".join(logs))
        PTXAS_LOG = "".join(logs)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.mm_error_string.argtypes = [ctypes.c_int]
    lib.mm_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def error_string(code: int) -> str:
    return f"{library().mm_error_string(code).decode()} (cudaError {code})"
