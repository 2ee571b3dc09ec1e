"""FSM operations — the ahead-of-time graph compiler.

Algebraic formulations follow the reference (src/fsmops.jl): union/cat by
block assembly, composition by the ``blockdiag(Tⁱ) + Ω·T₁·Aᵀ`` replacement
construction, weight propagation by power iteration, determinization by
label-grouped powerset construction, and Brzozowski minimization.  All of this
runs on the host ahead of time; the compiled graphs are then lowered to
device-friendly padded arrays by ``inference.compile``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from . import hostsparse as hs
from .fsm import FSM
from .labels import Label, label_mul, show_label
from .semiring import Semiring

__all__ = [
    "union",
    "rawunion",
    "concat",
    "reverse",
    "renorm",
    "compose",
    "propagate",
    "determinize",
    "minimize",
]


def _check_same_sr(fsms: Sequence[FSM]):
    sr = fsms[0].sr
    for f in fsms[1:]:
        if f.sr is not sr:
            raise ValueError("FSMs must share the same semiring")
    return sr


def union(*fsms: FSM) -> FSM:
    """Union of FSMs sharing one virtual final state
    (reference src/fsmops.jl:8-17)."""
    sr = _check_same_sr(fsms)
    alpha = np.concatenate([f.alpha for f in fsms])
    omega = np.concatenate([f.omega for f in fsms])
    T = hs.blockdiag([f.T for f in fsms], sr)
    labels = [l for f in fsms for l in f.labels]
    return FSM.from_parts(alpha, T, omega, labels, sr)


def rawunion(*fsms: FSM) -> FSM:
    """Stack *extended* storages: B independent FSMs in one structure, each
    keeping its own virtual final state — the reference's batching primitive
    (src/fsmops.jl:28-36).  The virtual ``.omega``/``.T`` accessors are not
    meaningful on the result (same caveat as the reference); use it only with
    ``inference.compile``.
    """
    sr = _check_same_sr(fsms)
    alpha_hat = np.concatenate([f.alpha_hat for f in fsms])
    T_hat = hs.blockdiag([f.T_hat for f in fsms], sr)
    labels = [l for f in fsms for l in f.labels]
    return FSM(sr, alpha_hat, T_hat, labels)


def concat(*fsms: FSM) -> FSM:
    """Concatenation; bridge block is the outer product ω₁·α₂ᵀ
    (reference src/fsmops.jl:44-54).  Named ``concat`` (the reference uses
    ``Base.cat``)."""
    sr = _check_same_sr(fsms)

    def cat2(f1: FSM, f2: FSM) -> FSM:
        s1, s2 = f1.num_states, f2.num_states
        alpha = np.concatenate([f1.alpha, sr.zeros(s2)])
        omega = np.concatenate([sr.zeros(s1), f2.omega])
        r1, c1, d1 = hs.findnz(f1.T)
        r2, c2, d2 = hs.findnz(f2.T)
        w1, a2 = f1.omega, f2.alpha
        wi = np.flatnonzero(~sr.is_zero(w1))
        aj = np.flatnonzero(~sr.is_zero(a2))
        br = np.repeat(wi, len(aj))
        bc = np.tile(aj, len(wi))
        bd = sr.mul(w1[br], a2[bc])
        rows = np.concatenate([r1, br, r2 + s1])
        cols = np.concatenate([c1, bc + s1, c2 + s1])
        data = np.concatenate([d1, bd, d2])
        T = hs.spmat_from_coo(rows, cols, data, (s1 + s2, s1 + s2), sr)
        return FSM.from_parts(alpha, T, omega, list(f1.labels) + list(f2.labels), sr)

    out = fsms[0]
    for f in fsms[1:]:
        out = cat2(out, f)
    return out


def reverse(fsm: FSM) -> FSM:
    """Reversal: swap α↔ω, transpose T (reference src/fsmops.jl:62-64)."""
    return FSM.from_parts(
        fsm.omega, hs.transpose(fsm.T, fsm.sr), fsm.alpha, fsm.labels, fsm.sr
    )


def renorm(fsm: FSM) -> FSM:
    """Per-state local normalization (reference src/fsmops.jl:71-80)."""
    sr = fsm.sr
    if not sr.divisible:
        raise ValueError(f"semiring {sr.name!r} is not divisible")
    T, omega, alpha = fsm.T, fsm.omega, fsm.alpha
    Z = sr.divide(sr.one, sr.add(hs.row_reduce(T, sr), omega))
    return FSM.from_parts(
        sr.divide(alpha, sr.sum(alpha)),
        hs.scale_rows(T, Z, sr),
        sr.mul(omega, Z),
        fsm.labels,
        sr,
    )


def compose(fsm1: FSM, fsms) -> FSM:
    """Replacement composition: substitute each state i of ``fsm1`` with
    sub-FSM ``fsms[i]`` (reference src/fsmops.jl:103-121).

    ``fsms`` is either a sequence of length ``fsm1.num_states`` or a dict
    keyed by 1-atom labels; in the dict case state i selects
    ``fsms[Label(last atom of fsm1.labels[i])]`` (reference src/fsmops.jl:117-119).
    """
    if isinstance(fsms, dict):
        missing = {lab[-1] for lab in fsm1.labels if Label(lab[-1]) not in fsms}
        if missing:
            raise KeyError(
                f"compose: no sub-FSM for label(s) {sorted(map(str, missing))}; "
                f"dict provides {sorted(show_label(k) for k in fsms)}"
            )
        fsms = [fsms[Label(lab[-1])] for lab in fsm1.labels]
    fsms = list(fsms)
    if len(fsms) != fsm1.num_states:
        raise ValueError("need one sub-FSM per state of fsm1")
    sr = fsm1.sr
    _check_same_sr([fsm1] + fsms)

    sizes = np.array([f.num_states for f in fsms], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    total = int(offs[-1])

    # weighted vcat of sub-α / sub-ω (reference _weighted_sparse_vcat :82-96)
    def weighted_vcat(x, subvecs):
        out = sr.zeros(total)
        for i in range(len(subvecs)):
            if not sr.is_zero(x[i]):
                out[offs[i] : offs[i + 1]] = sr.mul(x[i], subvecs[i])
        return out

    alpha = weighted_vcat(fsm1.alpha, [f.alpha for f in fsms])
    omega = weighted_vcat(fsm1.omega, [f.omega for f in fsms])

    rows, cols, data = [], [], []
    for i, f in enumerate(fsms):
        r, c, d = hs.findnz(f.T)
        rows.append(r + offs[i])
        cols.append(c + offs[i])
        data.append(d)

    # bridge block Ω·T₁·Aᵀ: each arc (p→q, w) of fsm1 expands to arcs from
    # final states of sub-FSM p to initial states of sub-FSM q.  Fully
    # vectorized (one np pass over all bridge arcs): for a pipeline-scale
    # LM ∘ HMM composition the bridge dominates the arc count, and a
    # per-arc Python loop here would dwarf every other compile cost.
    r1, c1, d1 = hs.findnz(fsm1.T)
    a_cat = np.concatenate([f.alpha for f in fsms])  # raw sub-α, offset layout
    w_cat = np.concatenate([f.omega for f in fsms])
    anz_g = np.flatnonzero(~sr.is_zero(a_cat))  # global nz positions
    wnz_g = np.flatnonzero(~sr.is_zero(w_cat))
    na = np.diff(np.searchsorted(anz_g, offs))  # nz α count per sub-FSM
    nw = np.diff(np.searchsorted(wnz_g, offs))
    a_start = np.searchsorted(anz_g, offs[:-1])
    w_start = np.searchsorted(wnz_g, offs[:-1])
    if len(r1):
        counts = nw[r1] * na[c1]  # bridge arcs per fsm1 arc
        total_b = int(counts.sum())
        if total_b:
            arc_id = np.repeat(np.arange(len(r1)), counts)
            starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
            l = np.arange(total_b) - starts[arc_id]
            na_e = na[c1][arc_id]
            gr = wnz_g[w_start[r1][arc_id] + l // na_e]
            gc = anz_g[a_start[c1][arc_id] + l % na_e]
            bd = sr.mul(sr.mul(w_cat[gr], d1[arc_id]), a_cat[gc])
            rows.append(gr)
            cols.append(gc)
            data.append(bd)

    T = hs.spmat_from_coo(
        np.concatenate(rows) if rows else [],
        np.concatenate(cols) if cols else [],
        np.concatenate(data) if data else np.zeros(0),
        (total, total),
        sr,
    )

    labels = [
        label_mul(lab1, labs)
        for lab1, f in zip(fsm1.labels, fsms)
        for labs in f.labels
    ]
    return FSM.from_parts(alpha, T, omega, labels, sr)


def propagate(fsm: FSM) -> FSM:
    """Push path mass through arcs by power iteration
    (reference src/fsmops.jl:128-143): A = Σₙ diag(vₙ)·T with v₁ = α,
    vₙ₊₁ = Tᵀvₙ, and o = Σₙ ω ⊙ vₙ.  The accumulated matrix shares T's
    sparsity, so only the value array accumulates."""
    sr = fsm.sr
    T, alpha, omega = fsm.T, fsm.alpha, fsm.omega
    rows = T.row_ids()
    v = alpha.copy()
    data = sr.mul(v[rows], T.data)
    o = sr.mul(omega, v)
    for _ in range(1, fsm.num_states):
        v = hs.spmv_t(T, v, sr)
        data = sr.add(data, sr.mul(v[rows], T.data))
        o = sr.add(o, sr.mul(omega, v))
    A = hs.SpMat(T.shape, T.indptr.copy(), T.indices.copy(), data)
    return FSM.from_parts(alpha, A, o, fsm.labels, sr)


def determinize(fsm: FSM, match: Callable = None) -> FSM:
    """Label-grouped powerset determinization (reference src/fsmops.jl:158-220).

    New states are sets of original states sharing a label; an arc from set s
    with label l goes to the set of all l-labelled successors of s with weight
    ⊕ over all contributing arcs.  ``match(l1, l2)`` widens label equality.
    """
    sr = fsm.sr
    S = fsm.num_states
    alpha, omega = fsm.alpha, fsm.omega
    labels = fsm.labels

    if match is None:
        lab_key = lambda lab: lab
    else:
        reps: list = []

        def lab_key(lab):
            for r in reps:
                if match(lab, r):
                    return r
            reps.append(lab)
            return lab

    state_key = [lab_key(l) for l in labels]

    # adjacency: out-arcs grouped per src state (CSR rows are already
    # src-sorted — slice views, no per-arc Python loop)
    rows, cols, data = hs.findnz(fsm.T)
    rp = fsm.T.indptr
    out_arcs = [
        list(zip(cols[rp[i] : rp[i + 1]].tolist(), data[rp[i] : rp[i + 1]]))
        for i in range(S)
    ]

    # initial sets: group value-nonzero initial states by label
    init_groups: dict = {}
    for i in np.flatnonzero(~sr.is_zero(alpha)):
        init_groups.setdefault(state_key[int(i)], []).append(int(i))

    from collections import deque

    newstates: dict = {}  # set(tuple) -> [iw, fw]; insertion ordered
    newarcs: dict = {}  # set -> list[(destset, w)]
    queue: deque = deque()
    for _, members in init_groups.items():
        s = tuple(sorted(members))
        newstates[s] = [
            sr.add_reduce(alpha[list(s)]),
            sr.add_reduce(omega[list(s)]),
        ]
        queue.append(s)

    while queue:
        s = queue.popleft()
        dest_sets: dict = {}
        dest_ws: dict = {}
        for u in s:
            for t, w in out_arcs[u]:
                k = state_key[t]
                dest_sets.setdefault(k, set()).add(t)
                dest_ws[k] = sr.add(dest_ws.get(k, sr.zero), w)
        for k, members in dest_sets.items():
            ns = tuple(sorted(members))
            newarcs.setdefault(s, []).append((ns, dest_ws[k]))
            if ns not in newstates:
                newstates[ns] = [sr.zero, sr.add_reduce(omega[list(ns)])]
                queue.append(ns)

    idx = {s: i for i, s in enumerate(newstates)}
    newlabels = [labels[s[0]] for s in newstates]
    initws, finalws, arcs = [], [], []
    for s, (iw, fw) in newstates.items():
        if not sr.is_zero(iw):
            initws.append((idx[s], iw))
        if not sr.is_zero(fw):
            finalws.append((idx[s], fw))
        for ns, w in newarcs.get(s, []):
            arcs.append(((idx[s], idx[ns]), w))
    return FSM.from_pairs(initws, arcs, finalws, newlabels, sr)


def minimize(fsm: FSM, match: Callable = None) -> FSM:
    """Brzozowski minimization (reference src/fsmops.jl:229)."""
    return reverse(determinize(reverse(determinize(fsm, match)), match))
