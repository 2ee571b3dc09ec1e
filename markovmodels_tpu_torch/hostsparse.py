"""Host-side sparse linear algebra over semirings.

This is the TPU build's analog of the reference's L1 layer: Julia
``SparseArrays`` generic semiring mul on CPU plus the GPU assembly routines of
reference src/linalg.jl (blockdiag :73-131, vcat :137-157, SpMV :159-233).
Here it only serves the *ahead-of-time graph compiler* — device-side math
lives in ``ops/`` as JAX/Pallas code — so clarity beats raw speed; the numeric
path is still fully vectorized numpy.

Two value domains:
  * numeric ``Semiring`` (semiring.py): float64 ndarrays, vectorized ufuncs;
  * ``PySemiring`` (labels.py): object ndarrays, python loops (used only for
    label-lifted computations on small graphs).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from . import native
from .labels import PySemiring
from .semiring import Semiring

# Below this nnz the vectorized-numpy path wins (no ctypes marshalling) and
# stays the reference implementation the native path is tested against.
_NATIVE_MIN_NNZ = 4096

__all__ = [
    "SpVec",
    "SpMat",
    "spvec_from_pairs",
    "spvec_from_dense",
    "spmat_from_coo",
    "spmat_from_dense",
    "blockdiag",
    "transpose",
    "spmv",
    "spmv_t",
    "row_reduce",
    "scale_rows",
    "scale_cols",
    "getcol",
    "submatrix",
    "findnz",
]


def _is_numeric(sr) -> bool:
    return isinstance(sr, Semiring)


def _empty_data(sr, n):
    if _is_numeric(sr):
        return np.empty(n, dtype=np.float64)
    return np.empty(n, dtype=object)


def _dense_zeros(sr, shape):
    if _is_numeric(sr):
        return sr.zeros(shape)
    out = np.empty(shape, dtype=object)
    # loop-fill: object zeros may themselves be array-like (e.g. the
    # append-concat semirings' tuple values), which `out[...] =` would
    # try to broadcast
    for i in range(out.size):
        out.flat[i] = sr.zero
    return out


@dataclasses.dataclass
class SpVec:
    """Sparse vector: sorted unique indices + stored values.

    Stored entries may hold semiring-zero values ("stored zeros"); structure is
    preserved like Julia SparseArrays (the reference's tests count nnz to catch
    stored-zero regressions, reference test/test_fsms.jl:96-98).
    """

    length: int
    indices: np.ndarray  # (nnz,) int64, sorted ascending, unique
    data: np.ndarray  # (nnz,) float64 or object

    @property
    def nnz(self) -> int:
        return int(len(self.indices))

    def to_dense(self, sr):
        out = _dense_zeros(sr, self.length)
        out[self.indices] = self.data
        return out

    def copy(self) -> "SpVec":
        return SpVec(self.length, self.indices.copy(), self.data.copy())


@dataclasses.dataclass
class SpMat:
    """CSR sparse matrix with semiring-valued entries."""

    shape: tuple
    indptr: np.ndarray  # (m+1,) int64
    indices: np.ndarray  # (nnz,) int64 col ids, sorted within each row
    data: np.ndarray  # (nnz,) float64 or object

    @property
    def nnz(self) -> int:
        return int(len(self.indices))

    def row_ids(self) -> np.ndarray:
        """Expand indptr to a per-entry row-index array."""
        counts = np.diff(self.indptr)
        return np.repeat(np.arange(self.shape[0], dtype=np.int64), counts)

    def to_dense(self, sr):
        out = _dense_zeros(sr, self.shape)
        out[self.row_ids(), self.indices] = self.data
        return out

    def copy(self) -> "SpMat":
        return SpMat(self.shape, self.indptr.copy(), self.indices.copy(), self.data.copy())


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def _combine_dups(keys, data, sr):
    """Combine duplicate sorted keys with semiring ⊕; keys must be sorted."""
    if len(keys) == 0:
        return np.zeros(0, dtype=bool), data
    newgroup = np.empty(len(keys), dtype=bool)
    newgroup[0] = True
    newgroup[1:] = keys[1:] != keys[:-1]
    if newgroup.all():
        return newgroup, data
    starts = np.flatnonzero(newgroup)
    if _is_numeric(sr):
        combined = sr.npy_add.reduceat(data, starts)
    else:
        combined = np.empty(len(starts), dtype=object)
        bounds = np.append(starts, len(keys))
        for g in range(len(starts)):
            acc = data[bounds[g]]
            for k in range(bounds[g] + 1, bounds[g + 1]):
                acc = sr.add(acc, data[k])
            combined[g] = acc
    return newgroup, combined


def spvec_from_pairs(pairs, length, sr) -> SpVec:
    """Build from (index, value) pairs; duplicates combined with ⊕."""
    if not pairs:
        return SpVec(length, np.zeros(0, dtype=np.int64), _empty_data(sr, 0))
    idx = np.asarray([p[0] for p in pairs], dtype=np.int64)
    data = _empty_data(sr, len(pairs))
    for k, p in enumerate(pairs):
        data[k] = p[1]
    order = np.argsort(idx, kind="stable")
    idx, data = idx[order], data[order]
    newgroup, combined = _combine_dups(idx, data, sr)
    return SpVec(length, idx[newgroup], combined)


def spvec_from_dense(x, sr) -> SpVec:
    x = np.asarray(x)
    if _is_numeric(sr):
        nz = np.flatnonzero(~sr.is_zero(x))
    else:
        nz = np.array([i for i in range(len(x)) if not sr.is_zero(x[i])], dtype=np.int64)
    return SpVec(len(x), nz.astype(np.int64), x[nz].copy())


def spmat_from_coo(rows, cols, data, shape, sr) -> SpMat:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if not isinstance(data, np.ndarray) or (
        _is_numeric(sr) and data.dtype != np.float64
    ):
        d = _empty_data(sr, len(rows))
        for k in range(len(rows)):
            d[k] = data[k]
        data = d
    m, n = shape
    if _is_numeric(sr) and len(rows) >= _NATIVE_MIN_NNZ:
        res = native.coo_to_csr(rows, cols, data, m, sr.name)
        if res is not None:
            return SpMat((m, n), *res)
    keys = rows * n + cols
    order = np.argsort(keys, kind="stable")
    rows, cols, data, keys = rows[order], cols[order], data[order], keys[order]
    newgroup, combined = _combine_dups(keys, data, sr)
    rows, cols = rows[newgroup], cols[newgroup]
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return SpMat((m, n), indptr, cols, combined)


def spmat_from_dense(x, sr) -> SpMat:
    x = np.asarray(x)
    m, n = x.shape
    if _is_numeric(sr):
        rr, cc = np.nonzero(~sr.is_zero(x))
    else:
        pos = [(i, j) for i in range(m) for j in range(n) if not sr.is_zero(x[i, j])]
        rr = np.array([p[0] for p in pos], dtype=np.int64)
        cc = np.array([p[1] for p in pos], dtype=np.int64)
    return spmat_from_coo(rr, cc, x[rr, cc].copy(), (m, n), sr)


def spmat_zeros(shape, sr) -> SpMat:
    return SpMat(
        tuple(shape),
        np.zeros(shape[0] + 1, dtype=np.int64),
        np.zeros(0, dtype=np.int64),
        _empty_data(sr, 0),
    )


def spdiag(v, sr) -> SpMat:
    """Diagonal matrix from a dense vector (keeps all entries, incl. zeros)."""
    n = len(v)
    idx = np.arange(n, dtype=np.int64)
    if _is_numeric(sr):
        d = np.asarray(v, dtype=np.float64).copy()
    else:
        d = _empty_data(sr, n)
        for k in range(n):
            d[k] = v[k]
    return SpMat((n, n), np.arange(n + 1, dtype=np.int64), idx, d)


# ---------------------------------------------------------------------------
# structural ops (assembly) — analog of reference src/linalg.jl:69-157
# ---------------------------------------------------------------------------

def blockdiag(mats: Sequence[SpMat], sr) -> SpMat:
    m = sum(a.shape[0] for a in mats)
    n = sum(a.shape[1] for a in mats)
    indptr = np.zeros(m + 1, dtype=np.int64)
    indices = []
    datas = []
    roff, coff, nzoff = 0, 0, 0
    for a in mats:
        indptr[roff + 1 : roff + a.shape[0] + 1] = a.indptr[1:] + nzoff
        indices.append(a.indices + coff)
        datas.append(a.data)
        roff += a.shape[0]
        coff += a.shape[1]
        nzoff += a.nnz
    indices = np.concatenate(indices) if indices else np.zeros(0, dtype=np.int64)
    data = (
        np.concatenate(datas)
        if datas
        else _empty_data(sr, 0)
    )
    return SpMat((m, n), indptr, indices, data)


def vcat_spvec(vecs: Sequence[SpVec], sr) -> SpVec:
    length = sum(v.length for v in vecs)
    idx, datas = [], []
    off = 0
    for v in vecs:
        idx.append(v.indices + off)
        datas.append(v.data)
        off += v.length
    return SpVec(
        length,
        np.concatenate(idx) if idx else np.zeros(0, dtype=np.int64),
        np.concatenate(datas) if datas else _empty_data(sr, 0),
    )


def transpose(a: SpMat, sr) -> SpMat:
    if _is_numeric(sr) and a.nnz >= _NATIVE_MIN_NNZ:
        res = native.csr_transpose(a.shape, a.indptr, a.indices, a.data)
        if res is not None:
            return SpMat((a.shape[1], a.shape[0]), *res)
    rows = a.row_ids()
    return spmat_from_coo(a.indices, rows, a.data, (a.shape[1], a.shape[0]), sr)


def findnz(a: SpMat):
    return a.row_ids(), a.indices, a.data


def getcol(a: SpMat, j: int, sr):
    """Dense j-th column."""
    out = _dense_zeros(sr, a.shape[0])
    rows = a.row_ids()
    mask = a.indices == j
    out[rows[mask]] = a.data[mask]
    return out


def submatrix(a: SpMat, rstop: int, cstop: int, sr) -> SpMat:
    """Leading principal block a[:rstop, :cstop] (contiguous ranges only)."""
    rows, cols, data = findnz(a)
    mask = (rows < rstop) & (cols < cstop)
    return spmat_from_coo(rows[mask], cols[mask], data[mask], (rstop, cstop), sr)


# ---------------------------------------------------------------------------
# semiring matvec / reductions — analog of reference src/linalg.jl:159-338
# ---------------------------------------------------------------------------

def _seg_reduce(sr, contrib, indptr, m):
    """Per-row ⊕-reduction of CSR-grouped contributions."""
    if _is_numeric(sr) and len(contrib) >= _NATIVE_MIN_NNZ:
        res = native.segment_reduce(
            indptr, np.asarray(contrib, dtype=np.float64), sr.name, sr.zero
        )
        if res is not None:
            return res
    out = _dense_zeros(sr, m)
    counts = np.diff(indptr)
    nonempty = counts > 0
    if len(contrib) == 0 or not nonempty.any():
        return out
    if _is_numeric(sr):
        starts = indptr[:-1][nonempty]
        out[nonempty] = sr.npy_add.reduceat(contrib, starts)
    else:
        for i in np.flatnonzero(nonempty):
            acc = contrib[indptr[i]]
            for k in range(indptr[i] + 1, indptr[i + 1]):
                acc = sr.add(acc, contrib[k])
            out[i] = acc
    return out


def _mul_elem(sr, a, b):
    if _is_numeric(sr):
        return sr.mul(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64))
    out = np.empty(len(a), dtype=object)
    for k in range(len(a)):
        out[k] = sr.mul(a[k], b[k])
    return out


def spmv(a: SpMat, x, sr):
    """Dense y = A ⊗ x  (y[i] = ⊕_j A[i,j] ⊗ x[j]); x dense."""
    contrib = _mul_elem(sr, a.data, np.asarray(x)[a.indices])
    return _seg_reduce(sr, contrib, a.indptr, a.shape[0])


def spmv_t(a: SpMat, x, sr):
    """Dense y = Aᵀ ⊗ x (y[j] = ⊕_i A[i,j] ⊗ x[i]); x dense."""
    rows = a.row_ids()
    contrib = _mul_elem(sr, a.data, np.asarray(x)[rows])
    out = _dense_zeros(sr, a.shape[1])
    if _is_numeric(sr):
        sr.npy_add.at(out, a.indices, contrib)
    else:
        for k in range(len(contrib)):
            j = a.indices[k]
            out[j] = sr.add(out[j], contrib[k])
    return out


def row_reduce(a: SpMat, sr):
    """Dense per-row ⊕-sum (stored entries only)."""
    return _seg_reduce(sr, a.data, a.indptr, a.shape[0])


def scale_rows(a: SpMat, v, sr) -> SpMat:
    """diag(v) ⊗ A : entry (i,j) ↦ v[i] ⊗ a_ij, structure preserved."""
    return SpMat(a.shape, a.indptr.copy(), a.indices.copy(),
                 _mul_elem(sr, np.asarray(v)[a.row_ids()], a.data))


def scale_cols(a: SpMat, v, sr) -> SpMat:
    """A ⊗ diag(v) : entry (i,j) ↦ a_ij ⊗ v[j], structure preserved."""
    return SpMat(a.shape, a.indptr.copy(), a.indices.copy(),
                 _mul_elem(sr, a.data, np.asarray(v)[a.indices]))
