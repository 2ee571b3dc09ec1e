"""Benchmark workload graphs.

``make_lm_hmm_graph`` builds an LF-MMI denominator graph at the BASELINE
target scale — an n-gram phonotactic LM over V phones composed with
left-to-right HMMs (the structure produced by the reference pipeline,
examples/prepare-lfmmi-graphs.jl:219) — directly in the compiler's preferred
*plane-major* state layout:

    state(h, k) = k * H + h,    h = first_phone * V + second_phone

so that HMM-internal arcs are constant-offset bands (self: 0, chain: +H) and
the cross-HMM trigram arcs tile into exact 128-source/128-destination dense
blocks for the blocked GMS operator (ops/blocked.py).  V=128 with a full
trigram gives ≈2.18M arcs / ≈49k states / 384 pdfs.
"""
from __future__ import annotations

import numpy as np

from . import hostsparse as hs
from .fsm import FSM
from .labels import Label
from .semiring import LOG

__all__ = [
    "make_lm_hmm_graph",
    "make_lm_hmm_graph_via_compose",
    "make_backoff_lm_hmm_graph",
]


def make_lm_hmm_graph(
    V: int = 128,
    hmm_states: int = 3,
    keep: float = 1.0,
    seed: int = 0,
):
    """Return (fsm, state_pdf, num_pdfs, info) for a trigram-LM ∘ HMM
    denominator graph.

    ``keep`` < 1 randomly prunes trigram arcs (renormalizing the rest),
    exercising the GMS tier/residue paths with uneven blocks.
    """
    rng = np.random.default_rng(seed)
    H = V * V
    K = hmm_states
    S = K * H  # + phony added by FSM.from_parts

    def idx(h, k):
        return k * H + h

    rows, cols, data = [], [], []

    # HMM-internal band arcs: self-loops (offset 0) and chain (offset +H)
    all_h = np.arange(H, dtype=np.int64)
    for k in range(K):
        rows.append(idx(all_h, k))
        cols.append(idx(all_h, k))
        data.append(np.full(H, np.log(0.5)))
    for k in range(K - 1):
        rows.append(idx(all_h, k))
        cols.append(idx(all_h, k + 1))
        data.append(np.full(H, np.log(0.5)))

    # cross-HMM trigram arcs: exit(a,b) -> entry(b,c), weight 0.5·P(c|a,b)
    # histories h=(a,b) at a*V+b; successors (b,c) at b*V+c.
    a_g, b_g, c_g = np.meshgrid(
        np.arange(V), np.arange(V), np.arange(V), indexing="ij"
    )
    src_h = (a_g * V + b_g).ravel()
    dst_h = (b_g * V + c_g).ravel()
    logp = np.log(
        rng.dirichlet(np.ones(V), size=H).astype(np.float64)
    ).ravel()  # P(c | a,b) per (a,b) row
    if keep < 1.0:
        mask = rng.uniform(size=len(src_h)) < keep
        src_h, dst_h, logp = src_h[mask], dst_h[mask], logp[mask]
    # LM exit mass: 0.45 to successors, 0.05 to final
    rows.append(idx(src_h, K - 1))
    cols.append(idx(dst_h, 0))
    data.append(np.log(0.45) + logp)

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    data = np.concatenate(data)

    alpha = np.full(S, -np.inf)
    # start in entry states of histories with first phone 0 ("<s>")
    start = idx(np.arange(V, dtype=np.int64), 0)  # (0, c) histories
    alpha[start] = -np.log(V)
    omega = np.full(S, -np.inf)
    omega[idx(all_h, K - 1)] = np.log(0.05)

    # pdf of state (h=(a,b), k) = second_phone(h) * K + k
    second = np.tile(np.arange(V), V)  # h -> b
    state_pdf = np.empty(S + 1, dtype=np.int32)
    for k in range(K):
        state_pdf[k * H : (k + 1) * H] = second * K + k
    num_pdfs = V * K
    state_pdf[S] = num_pdfs

    labels = [Label(int(p)) for p in state_pdf[:S]]
    T = hs.spmat_from_coo(rows, cols, data, (S, S), LOG)
    fsm = FSM.from_parts(alpha, T, omega, labels, LOG)
    info = dict(states=S + 1, arcs=fsm.T_hat.nnz, pdfs=num_pdfs, V=V)
    return fsm, state_pdf, num_pdfs, info


def make_backoff_lm_hmm_graph(
    V: int = 128,
    hmm_states: int = 3,
    keep: float = 0.1,
    backoff_mass: float = 0.3,
    seed: int = 0,
    layout: str = "embedded",
):
    """LF-MMI denominator with a *backoff* trigram LM — the reference's
    actual WSJ workload shape (a pruned 3-gram at ~9% of full trigram
    density with backoff structure, reference misc/benchmark/README.md:5-6)
    at the 2M-panel benchmark scale.

    LM structure per history (a, b):
      * kept trigram arcs (a, b) -> (b, c) for a ~``keep`` subset of
        successors c, carrying (1 - backoff_mass) of the transition mass;
      * one backoff arc (a, b) -> B(b) carrying ``backoff_mass``;
      * from the backoff state B(b), a full bigram row B(b) -> (b, c).

    ``layout`` is the point of this generator:

    * ``'embedded'`` (the TPU-first design): B(b) occupies the diagonal
      history slot (b, b) — real backoff LMs subsume the rare (b, b)
      trigram context into backoff anyway.  Every backoff destination
      (b, b) and every bigram row then lives INSIDE the dense trigram
      tier's affine index pattern (dst slot 384·c + b in the pdf-grouped
      layout), so the whole backoff family lowers onto the fused Pallas
      fast path unchanged: pruning sparsifies the panel *weights* while
      the *index structure* stays static and lane-aligned.  A strided
      'diag' gather/scatter tier (ops/blocked.py descriptors) is what the
      separate layout below would need — but a lane-UNALIGNED single-row
      stride cannot be expressed as TPU vector slices at all (Mosaic has
      no dynamic single-lane indexing); choosing a layout that makes the
      family lane-aligned is the TPU answer, not a more general kernel.
    * ``'separate'``: B(b) states appended after the V² histories — the
      layout the reference pipeline's ``LanguageModelFSM(ngrams) ∘ hmms``
      route produces (reference examples/prepare-lfmmi-graphs.jl:218-223).
      Its pdf groups have V+1 states (V histories sharing pdf (b, k) plus
      B(b)), so a plain uniform pdf-grouped layout would need cmax = V+1 —
      not 128-lane alignable, and its tiers degrade to gather/scatter
      ("4 tiers" is merely the FIRST rejected predicate).  Since round 5,
      ``compile_fsm``'s capped/overflow canonicalization (``ov_cap``)
      keeps cmax = V, parks the backoff states in overflow lane-groups,
      and lifts their arcs into structured families — so this layout now
      reaches the SAME fused path; compiled with ``reorder='none'`` it
      still shows the old cliff with a named reason.  bench.py times both
      layouts and gates their parity.

    Returns (fsm, state_pdf, num_pdfs, info); ``info['real_arcs']`` counts
    stored arcs, ``info['panel_slots']`` the dense-tier slots they occupy
    on the fused path (~``keep`` density).
    """
    rng = np.random.default_rng(seed)
    H = V * V
    K = hmm_states
    sep = layout == "separate"
    if layout not in ("embedded", "separate"):
        raise ValueError(f"unknown layout {layout!r}")
    nB = V if sep else 0  # separate backoff states
    Ht = H + nB
    S = K * Ht

    def idx(h, k):
        return k * Ht + h

    rows, cols, data = [], [], []
    all_h = np.arange(Ht, dtype=np.int64)
    for k in range(K):
        rows.append(idx(all_h, k))
        cols.append(idx(all_h, k))
        data.append(np.full(Ht, np.log(0.5)))
    for k in range(K - 1):
        rows.append(idx(all_h, k))
        cols.append(idx(all_h, k + 1))
        data.append(np.full(Ht, np.log(0.5)))

    a_id = np.repeat(np.arange(V), V)  # h -> a
    b_id = np.tile(np.arange(V), V)  # h -> b
    bk_of = (H + np.arange(V)) if sep else (np.arange(V) * V + np.arange(V))

    # kept trigram arcs: per history row (a, b), ~keep of the successors c
    # survive with renormalized mass (1 - backoff_mass); diagonal histories
    # (b, b) are the backoff states in the embedded layout and get the
    # bigram row instead
    p3 = rng.dirichlet(np.ones(V), size=H)  # P(c | a, b)
    kept = rng.uniform(size=(H, V)) < keep
    kept[np.arange(H), b_id] = False  # (b, c=b) target is B(b)'s slot
    is_bk_row = np.zeros(H, dtype=bool)
    if not sep:
        is_bk_row[bk_of] = True
    kept[is_bk_row] = False
    # every history keeps >= 1 successor so renormalization is defined
    none = ~kept.any(axis=1) & ~is_bk_row
    if none.any():
        fix = np.argmax(
            np.where(np.arange(V)[None, :] == b_id[none, None], 0.0,
                     p3[none]), axis=1
        )
        kept[np.flatnonzero(none), fix] = True
    psum = (p3 * kept).sum(axis=1)
    hh, cc = np.nonzero(kept)
    w3 = (
        np.log(0.45) + np.log1p(-backoff_mass)
        + np.log(p3[hh, cc]) - np.log(psum[hh])
    )
    rows.append(idx(hh, K - 1))
    cols.append(idx(b_id[hh] * V + cc, 0))
    data.append(w3)
    n_tri = len(hh)

    # backoff arcs (a, b) -> B(b)
    tri_h = np.flatnonzero(~is_bk_row)
    rows.append(idx(tri_h, K - 1))
    cols.append(idx(bk_of[b_id[tri_h]], 0))
    data.append(np.full(len(tri_h), np.log(0.45) + np.log(backoff_mass)))

    # bigram rows B(b) -> (b, c): full successor distribution; the c = b
    # column lands on B(b) itself (the truncated (b, b) context)
    p2 = rng.dirichlet(np.ones(V), size=V)  # P(c | b)
    bb, cc2 = np.nonzero(p2 > 0)
    dst2 = bb * V + cc2
    if not sep:
        pass  # (b, c=b) IS bk_of[b] already (diagonal slot)
    else:
        diag = cc2 == bb
        dst2 = np.where(diag, bk_of[cc2], dst2)
    rows.append(idx(bk_of[bb], K - 1))
    cols.append(idx(dst2, 0))
    data.append(np.log(0.45) + np.log(p2[bb, cc2]))

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    data = np.concatenate(data)

    alpha = np.full(S, -np.inf)
    start = idx(np.arange(V, dtype=np.int64), 0)  # histories (0, c)
    alpha[start] = -np.log(V)
    omega = np.full(S, -np.inf)
    omega[idx(all_h, K - 1)] = np.log(0.05)

    second = np.concatenate([b_id, np.arange(nB)]) if sep else b_id
    state_pdf = np.empty(S + 1, dtype=np.int32)
    for k in range(K):
        state_pdf[k * Ht : (k + 1) * Ht] = second * K + k
    num_pdfs = V * K
    state_pdf[S] = num_pdfs

    labels = [Label(int(p)) for p in state_pdf[:S]]
    T = hs.spmat_from_coo(rows, cols, data, (S, S), LOG)
    fsm = FSM.from_parts(alpha, T, omega, labels, LOG)
    info = dict(
        states=S + 1,
        real_arcs=fsm.T_hat.nnz,
        panel_slots=K * H * V if not sep else None,
        kept_trigram=n_tri,
        density=n_tri / (H * V),
        pdfs=num_pdfs,
        V=V,
        layout=layout,
    )
    return fsm, state_pdf, num_pdfs, info


def make_lm_hmm_graph_via_compose(V: int = 128, hmm_states: int = 3,
                                  seed: int = 0):
    """The SAME stochastic trigram-LM ∘ HMM denominator as
    :func:`make_lm_hmm_graph` (identical arcs/weights under a state
    permutation, proven in tests/test_workload_compose.py) — but built
    through the graph compiler's own pipeline route: an H-state LM FSM
    composed with per-history HMM sub-FSMs via ``fsmops.compose``
    (reference examples/prepare-lfmmi-graphs.jl:218-223).

    Compose lays sub-FSM states out h-major (state (h, k) at h·K + k),
    the generator plane-major (k·H + h).  Both orders canonicalize to the
    SAME pdf-grouped device layout inside ``inference.compile_fsm``
    (reorder='pdf'), so compiler-produced graphs reach the fused Pallas
    fast path identically — bench.py gates this.

    Returns (fsm, state_pdf, num_pdfs, info); ``state_pdf`` is derived
    from the composed labels, exactly as the pipeline derives its state
    maps (reference examples/prepare-lfmmi-graphs.jl:15-23).
    """
    from .fsmops import compose

    rng = np.random.default_rng(seed)
    H = V * V
    K = hmm_states

    # LM over histories h=(a,b): arcs (a,b) -> (b,c) with 0.45*P(c|a,b)
    a_g, b_g, c_g = np.meshgrid(
        np.arange(V), np.arange(V), np.arange(V), indexing="ij"
    )
    src_h = (a_g * V + b_g).ravel()
    dst_h = (b_g * V + c_g).ravel()
    logp = np.log(rng.dirichlet(np.ones(V), size=H).astype(np.float64)).ravel()
    T = hs.spmat_from_coo(src_h, dst_h, np.log(0.45) + logp, (H, H), LOG)
    alpha = np.full(H, -np.inf)
    alpha[:V] = -np.log(V)  # histories (0, c)
    omega = np.full(H, np.log(0.05))
    # LM labels are the identity so composed labels equal the HMM pdf labels
    lm = FSM.from_parts(alpha, T, omega, [Label()] * H, LOG)

    # one left-to-right HMM per history, emitting pdfs second(h)*K + k
    second = np.tile(np.arange(V), V)
    hmm_rows = np.concatenate([np.arange(K), np.arange(K - 1)])
    hmm_cols = np.concatenate([np.arange(K), np.arange(1, K)])
    hmm_w = np.full(2 * K - 1, np.log(0.5))
    Th = hs.spmat_from_coo(hmm_rows, hmm_cols, hmm_w, (K, K), LOG)
    a_h = np.full(K, -np.inf)
    a_h[0] = 0.0
    o_h = np.full(K, -np.inf)
    o_h[K - 1] = 0.0  # exit weight folded into LM arc/final weights

    hmms = [
        FSM.from_parts(
            a_h, Th, o_h,
            [Label(int(second[h]) * K + k) for k in range(K)], LOG,
        )
        for h in range(H)
    ]
    fsm = compose(lm, hmms)
    num_pdfs = V * K
    S1 = len(fsm.alpha_hat)
    state_pdf = np.array(
        [l[-1] if l else num_pdfs for l in fsm.labels] + [num_pdfs],
        dtype=np.int32,
    )
    info = dict(states=S1, arcs=fsm.T_hat.nnz, pdfs=num_pdfs, V=V)
    return fsm, state_pdf, num_pdfs, info
