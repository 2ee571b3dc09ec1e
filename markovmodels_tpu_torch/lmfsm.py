"""N-gram counting and language-model FSM construction
(reference src/lmfsm.jl).

``totalngramsum`` computes, for every n-gram of state labels realized by a
window of exactly ``order`` states (with a phony pad chain so sentence-initial
shorter n-grams are captured, reference src/lmfsm.jl:27-35), the triple

    (initial weight, interior path weight, final weight)

summed over all realizing paths.  The reference does this by decorating the
FSM with a nested product semiring and running ``totalsum``
(src/lmfsm.jl:37-59); here the same quantity is computed by an explicit
dynamic program over (state, n-gram) cells, which is algebraically identical
(the decorated semiring is the free semiring over per-path terms).

``language_model_fsm`` then builds the n-gram history-state LM automaton and
renormalizes it — the LF-MMI denominator phonotactic LM
(reference src/lmfsm.jl:81-119, examples/prepare-lfmmi-graphs.jl:219).
"""
from __future__ import annotations

import numpy as np

from .fsm import FSM
from .fsmops import concat, renorm
from .labels import Label, append_concat_over, product_semiring
from . import hostsparse as hs

__all__ = [
    "totalngramsum",
    "totalngramsum_lifted",
    "language_model_fsm",
    "merge_ngrams",
]


def totalngramsum(fsm: FSM, order: int) -> dict:
    """n-gram statistics of ``fsm``: dict ngram-tuple -> (iw, w, fw).

    Last-label restriction + pad chain per the reference
    (src/lmfsm.jl:17-35); cross-checked against the label-semiring-lifted
    construction in totalngramsum_lifted."""
    sr = fsm.sr
    fsm = _pad_last_label(fsm, order)
    S = fsm.num_states
    alpha, omega = fsm.alpha, fsm.omega
    labs = fsm.labels
    rows, cols, data = hs.findnz(fsm.T)

    # DP over paths of exactly `order` states.  Cell (state, ngram) holds
    # [Σ iw, Σ w, Σ 1] over paths of the current length ending at `state`
    # realizing `ngram`; components extend independently under path extension
    # because iw = α(start), w = ⊗ arc weights, mult counts paths.
    cur = [
        {tuple(labs[s]): [alpha[s], sr.one, sr.one]} for s in range(S)
    ]
    for _ in range(order - 1):
        nxt: list[dict] = [dict() for _ in range(S)]
        for s, t, w_arc in zip(rows, cols, data):
            s, t = int(s), int(t)
            lab_t = tuple(labs[t])
            cell = nxt[t]
            for g, (iw, w, mult) in cur[s].items():
                ng = g + lab_t
                acc = cell.get(ng)
                w2 = sr.mul(w, w_arc)
                if acc is None:
                    cell[ng] = [iw, w2, mult]
                else:
                    acc[0] = sr.add(acc[0], iw)
                    acc[1] = sr.add(acc[1], w2)
                    acc[2] = sr.add(acc[2], mult)
        cur = nxt

    ngrams: dict = {}
    for s in range(S):
        om = omega[s]
        for g, (iw, w, mult) in cur[s].items():
            a, b, c = ngrams.get(g, (sr.zero, sr.zero, sr.zero))
            # per-path final weight is ω(end); Σ over paths = mult ⊗ ω.
            ngrams[g] = (sr.add(a, iw), sr.add(b, w), sr.add(c, sr.mul(mult, om)))
    return ngrams


def _pad_last_label(fsm: FSM, order: int) -> FSM:
    """Shared preamble of both n-gram counters: keep only the last label
    atom per state, prepend the order-1 empty-labelled pad chain."""
    sr = fsm.sr
    labels = [Label(lab[-1]) if len(lab) else Label() for lab in fsm.labels]
    fsm = FSM(fsm.sr, fsm.alpha_hat, fsm.T_hat, labels)
    if order > 1:
        n = order - 1
        pad = FSM.from_pairs(
            [(0, sr.one)],
            [((i, i + 1), sr.one) for i in range(n - 1)],
            [(n - 1, sr.one)],
            [Label()] * n,
            sr,
        )
        fsm = concat(pad, fsm)
    return fsm


def totalngramsum_lifted(fsm: FSM, order: int) -> dict:
    """The reference's own construction of ``totalngramsum`` — decorate the
    FSM with the nested product semiring

        S = Product(Product(AppendConcat{Label}, K), Product(K, K))
            (label sequence, interior weight) x (initial weight, final weight)

    lifted into an AppendConcat-of-S collection semiring, and run the
    ``totalsum`` power iteration for exactly ``order`` steps (reference
    src/lmfsm.jl:10-73).  Exponential in path count — this is the *oracle*
    the DP redesign (totalngramsum) is cross-checked against on cyclic
    weighted graphs; use totalngramsum for real workloads.
    """
    from .algorithms import totalsum

    K = fsm.sr
    fsm = _pad_last_label(fsm, order)
    S = fsm.num_states
    labs = fsm.labels
    alpha, omega = fsm.alpha, fsm.omega

    T1 = product_semiring(append_concat_over(None), K)
    T2 = product_semiring(K, K)
    Ssr = product_semiring(T1, T2)
    outer = append_concat_over(Ssr, name="append_concat_S")

    # every state is lifted — zero α/ω ride INSIDE the product element
    # (iw/fw components) so interior windows are still enumerated, exactly
    # as the reference's dense zip over the sparse α/ω (src/lmfsm.jl:41-52)
    alpha_l = np.empty(S, dtype=object)
    for i in range(S):
        alpha_l[i] = ((((tuple(labs[i]),), K.one), (alpha[i], K.one)),)
    omega_l = np.empty(S, dtype=object)
    for i in range(S):
        omega_l[i] = ((T1.one, (K.one, omega[i])),)

    # structural lift keeps the CSR layout (arc into j carries λ_j)
    T = fsm.T
    data_l = np.empty(T.nnz, dtype=object)
    for k, (j, w) in enumerate(zip(T.indices, T.data)):
        data_l[k] = ((((tuple(labs[int(j)]),), w), T2.one),)
    T_l = hs.SpMat(T.shape, T.indptr.copy(), T.indices.copy(), data_l)

    stats = totalsum(alpha_l, T_l, omega_l, order, outer)

    ngrams: dict = {}
    for ((seqs, w), (iw, fw)) in stats:
        # seqs holds exactly one concatenated label; hostsparse.spmv_t
        # right-multiplies (mul(arc, prefix)), so the sequence comes out
        # reversed — exactly the reference's Julia situation
        # (src/lmfsm.jl:62-66): reverse it back.
        ngram = tuple(reversed(seqs[0]))
        a, b, c = ngrams.get(ngram, (K.zero, K.zero, K.zero))
        ngrams[ngram] = (K.add(a, iw), K.add(b, w), K.add(c, fw))
    return ngrams


def merge_ngrams(a: dict, b: dict, sr) -> dict:
    """⊕-merge two n-gram stat dicts (the reference's distributed reduction
    ``mergewith((x,y) -> x .+ y)``, examples/prepare-lfmmi-graphs.jl:109)."""
    out = dict(a)
    for g, (iw, w, fw) in b.items():
        if g in out:
            x, y, z = out[g]
            out[g] = (sr.add(x, iw), sr.add(y, w), sr.add(z, fw))
        else:
            out[g] = (iw, w, fw)
    return out


def language_model_fsm(ngrams: dict, sr) -> FSM:
    """History-state n-gram LM FSM from n-gram stats, renormalized
    (reference src/lmfsm.jl:81-119)."""
    states: dict = {}
    initstates: dict = {}
    finalstates: dict = {}
    arcs: dict = {}

    order = max((len(g) for g in ngrams), default=0)

    def state_of(h):
        if h not in states:
            states[h] = len(states)
        return states[h]

    for ngram, (iw, w, fw) in ngrams.items():
        L = len(ngram)
        if L == 1 and not sr.is_zero(iw):
            i = state_of(ngram)
            initstates[ngram] = sr.add(initstates.get(ngram, sr.zero), iw)
            if not sr.is_zero(fw):
                finalstates[ngram] = sr.add(finalstates.get(ngram, sr.zero), fw)
        elif L > 1:
            src = ngram[: min(order, L) - 1]
            dest = ngram[max(0, L - order + 1) :]
            si, di = state_of(src), state_of(dest)
            arcs[(si, di)] = sr.add(arcs.get((si, di), sr.zero), w)
            if not sr.is_zero(fw):
                finalstates[dest] = sr.add(finalstates.get(dest, sr.zero), fw)

    labels = [None] * len(states)
    for h, i in states.items():
        labels[i] = tuple(h)

    fsm = FSM.from_pairs(
        [(states[h], v) for h, v in initstates.items()],
        [((i, j), v) for (i, j), v in arcs.items()],
        [(states[h], v) for h, v in finalstates.items()],
        labels,
        sr,
    )
    return renorm(fsm)
