"""Exact float64 host oracles (numpy and scipy only).

The port's own copy of the oracles of the repository's benchmark
(``bench.py``: ``host_oracle``, ``host_viterbi_score`` and
``_validate_paths_full``, public here as ``validate_paths``), so that the
port checks itself against float64 ground truth without importing the
benchmark or the JAX package.  Every function takes a host ``FSM``, its
state->pdf map ``spdf`` (the phony final state last) and numpy inputs.
"""
from __future__ import annotations

import numpy as np

from . import hostsparse as hs

__all__ = ["host_oracle", "host_viterbi_score", "validate_paths"]


def host_oracle(fsm, spdf, num_pdfs, lhs, lengths):
    """Exact float64 forward-backward (scipy sparse, prob domain with
    per-frame rescaling) — independent of the device code path.  Returns
    (logZ (B,), posteriors (B, N, P))."""
    import scipy.sparse as sp

    rows, cols, data = hs.findnz(fsm.T_hat)
    S1 = len(fsm.alpha_hat)
    w = np.exp(np.asarray(data, dtype=np.float64))
    Tt = sp.csr_matrix((w, (cols, rows)), shape=(S1, S1))
    Tm = sp.csr_matrix((w, (rows, cols)), shape=(S1, S1))
    a0 = np.exp(np.asarray(fsm.alpha_hat, dtype=np.float64))
    B, N, P = lhs.shape
    logZ = []
    posts = np.zeros((B, N, P))
    for b in range(B):
        L = int(lengths[b])

        def emis(t):
            e = np.zeros(S1)
            if t < L:
                e[: S1 - 1] = np.exp(lhs[b, t])[spdf[: S1 - 1]]
            else:
                e[S1 - 1] = 1.0
            return e

        A = np.zeros((L + 1, S1))
        v, shift = a0.copy(), 0.0
        for t in range(L + 1):
            v = (v if t == 0 else Tt @ v) * emis(t)
            m = v.max()
            if m > 0:
                v /= m
                shift += np.log(m)
            A[t] = v
        val = v[S1 - 1]
        logZ.append(np.log(val) + shift if val > 0 else -np.inf)
        bb = np.zeros(S1)
        bb[S1 - 1] = 1.0
        for t in range(L, -1, -1):
            y = bb if t == L else Tm @ bb
            m = y.max()
            if m > 0:
                y = y / m
            g = A[t] * y
            if t < L:
                gp = np.zeros(num_pdfs + 1)
                np.add.at(gp, spdf[: S1 - 1], g[: S1 - 1])
                gp[num_pdfs] += g[S1 - 1]
                tot = gp.sum()
                posts[b, t] = gp[:num_pdfs] / (tot if tot > 0 else 1.0)
            bb = y * emis(t)
    return np.array(logZ), posts


def host_viterbi_score(fsm, spdf, num_pdfs, lhs, lengths):
    """Exact float64 max-plus forward (best-path scores only)."""
    rows, cols, data = hs.findnz(fsm.T_hat)
    data = np.asarray(data, dtype=np.float64)
    S1 = len(fsm.alpha_hat)
    a0 = np.asarray(fsm.alpha_hat, dtype=np.float64)
    scores = []
    for b in range(lhs.shape[0]):
        L = int(lengths[b])
        v = a0.copy()
        for t in range(L + 1):
            if t > 0:
                y = np.full(S1, -np.inf)
                np.maximum.at(y, cols, data + v[rows])
                v = y
            e = np.full(S1, -np.inf)
            if t < L:
                e[: S1 - 1] = lhs[b, t][spdf[: S1 - 1]]
            else:
                e[S1 - 1] = 0.0
            v = v + e
        scores.append(v[S1 - 1])
    return np.array(scores)


def validate_paths(fsm, spdf, lhs, lengths, states, score, atol=2e-3):
    """f64 walk of each decoded path: weight must equal the device score
    (f32 accumulation tolerance over N frames).  Vectorized arc lookup
    (sorted int64 (src, dst) keys + searchsorted) so walking a whole
    decoded batch (128 x 700 frames) costs milliseconds.  Returns the
    largest gap; raises ``AssertionError`` past ``atol``."""
    rows, cols, data = hs.findnz(fsm.T_hat)
    S1 = len(fsm.alpha_hat)
    keys = rows.astype(np.int64) * (S1 + 1) + cols
    order = np.argsort(keys)
    keys = keys[order]
    vals = np.asarray(data, dtype=np.float64)[order]

    def arc_w(i, j):
        """Vectorized arc weights; -inf where the arc does not exist
        (catches invalid decoded paths)."""
        k = np.asarray(i, dtype=np.int64) * (S1 + 1) + np.asarray(j)
        pos = np.minimum(np.searchsorted(keys, k), len(keys) - 1)
        return np.where(keys[pos] == k, vals[pos], -np.inf)

    a0 = np.asarray(fsm.alpha_hat, dtype=np.float64)
    lhs = np.asarray(lhs)
    gap = 0.0
    for b in range(lhs.shape[0]):
        L = int(lengths[b])
        path = np.asarray(states[b, :L])
        w = (
            a0[path[0]]
            + float(lhs[b, np.arange(L), spdf[path]].astype(np.float64).sum())
            + float(arc_w(path[:-1], path[1:]).sum())
            + float(arc_w(path[L - 1 : L], [S1 - 1])[0])
        )
        gap = max(gap, abs(w - float(score[b])))
    assert gap < atol, f"decoded path weight vs device score: {gap}"
    return gap
