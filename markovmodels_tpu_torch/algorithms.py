"""Total-sum algorithms (reference src/algorithms.jl).

Partial sums over all paths by power iteration; also the representation-
independent FSM-equality oracle used throughout the test-suite (reference
test/test_fsms.jl:9-16): two FSMs are considered equal when their total
weight sums and total label sums agree for all path lengths up to
``max(num_states)``.
"""
from __future__ import annotations

import numpy as np

from . import hostsparse as hs
from .fsm import FSM
from .labels import UNION_CONCAT, LabelSet

__all__ = [
    "totalcumsum",
    "totalsum",
    "totalweightsum",
    "totallabelsum",
    "fsmequal",
]


def totalcumsum(alpha, T: hs.SpMat, omega, n: int, sr):
    """Σ_{k=1..n} αᵀ T^{k-1} ω — total weight of paths of ≤ n states
    (reference src/algorithms.jl:8-16)."""
    v = alpha
    total = sr.dot(v, omega)
    for _ in range(1, n):
        v = hs.spmv_t(T, v, sr)
        total = sr.add(total, sr.dot(v, omega))
    return total


def totalsum(alpha, T: hs.SpMat, omega, n: int, sr):
    """αᵀ T^{n-1} ω — total weight of paths of exactly n states
    (reference src/algorithms.jl:23-29)."""
    v = alpha
    for _ in range(1, n):
        v = hs.spmv_t(T, v, sr)
    return sr.dot(v, omega)


def totalweightsum(fsm: FSM, n: int = None):
    """(reference src/algorithms.jl:36)"""
    if n is None:
        n = fsm.num_states
    return totalcumsum(fsm.alpha, fsm.T, fsm.omega, n, fsm.sr)


def totallabelsum(fsm: FSM, n: int = None):
    """Lift to the union-concat label semiring and total-sum: the set of label
    sequences over all accepting paths of ≤ n states
    (reference src/algorithms.jl:43-51)."""
    if n is None:
        n = fsm.num_states
    sr, L = fsm.sr, UNION_CONCAT
    S = fsm.num_states
    alpha, omega = fsm.alpha, fsm.omega

    alpha_l = np.empty(S, dtype=object)
    for i in range(S):
        alpha_l[i] = (
            LabelSet([tuple(fsm.labels[i])]) if not sr.is_zero(alpha[i]) else L.zero
        )
    omega_l = np.empty(S, dtype=object)
    for i in range(S):
        omega_l[i] = L.one if not sr.is_zero(omega[i]) else L.zero

    # tobinary(T) * spdiagm(λ): arc into state j carries {λ_j}
    # (structural lift — stored entries keep their arc, reference utils.jl:9-12).
    T = fsm.T
    data_l = np.empty(T.nnz, dtype=object)
    for k, j in enumerate(T.indices):
        data_l[k] = LabelSet([tuple(fsm.labels[int(j)])])
    T_l = hs.SpMat(T.shape, T.indptr.copy(), T.indices.copy(), data_l)

    return totalcumsum(alpha_l, T_l, omega_l, n, L)


def fsmequal(fsm1: FSM, fsm2: FSM, atol: float = 1e-8) -> bool:
    """Algebraic equality oracle (reference test/test_fsms.jl:9-16)."""
    n = max(fsm1.num_states, fsm2.num_states)
    if totallabelsum(fsm1, n) != totallabelsum(fsm2, n):
        return False
    w1 = totalweightsum(fsm1, n)
    w2 = totalweightsum(fsm2, n)
    if np.isinf(w1) and np.isinf(w2) and np.sign(w1) == np.sign(w2):
        return True
    return bool(np.isclose(w1, w2, atol=atol, rtol=1e-6))
