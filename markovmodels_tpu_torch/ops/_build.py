"""Build and load the CUDA kernels of the port.

The sources under ``csrc/`` have a plain C interface.  They are compiled
with nvcc for Hopper (``sm_90a``) into a shared library under
``build/markovmodels_tpu_torch/`` at the root of the checkout, named by a
hash of the sources and flags, at first use, and bound with ctypes.  A build
or load failure raises; there is no fallback.
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
_SOURCES = ("block_scan.cu",)
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None
PTXAS_LOG = ""  # register / shared-memory report of the last build

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of each C entry point (pointers and the stream as c_void_p)
_SIGNATURES = {
    "mm_block_fwd": [_P] * 8 + [_I] * 3 + [_P] * 10,
    "mm_block_recompute": [_P] * 8 + [_I] * 3 + [_P] * 4,
    "mm_block_bwd": [_P] * 9 + [_I] * 4 + [_P] * 6,
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
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp),
               *(str(_CSRC / s) for s in _SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}"
            )
        PTXAS_LOG = res.stdout + res.stderr
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
