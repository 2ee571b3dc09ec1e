"""Viterbi decoding and max-state posteriors.

PyTorch counterpart of ``markovmodels_tpu/viterbi.py``, its routes picked
as the JAX package picks them:

* ``_viterbi_single`` for 'segment', 'ell' and 'banded' graphs and, per
  graph, for every stacked graph (one sequence per graph; stacked 'banded'
  numerators make this forced alignment): the log-domain tropical scan
  over the graph's edges (or an 'ell' graph's arc lists) keeps an int32
  backpointer per frame and state, the largest source among tied maxima,
  then a walk back from the phony final state.  It runs in plain PyTorch
  on every device, as the JAX package runs it outside any Pallas kernel;

for 'dense' and 'block' graphs the at-scale routes (``_viterbi_scale``):

* the **compressed-backpointer decode** (``_viterbi_scale_bp``) for 'block'
  graphs with a single affine tier whose uint8 id stream fits the JAX
  package's 6 GB budget: ONE tropical forward sweep records, per frame and
  state, the winning *candidate id* (a uint8: the in-degree of every state
  is tier width + band count < 255) and per frame the argmax of the rank-1
  ω arcs into the phony final state; the backtrace is a walk that decodes
  one id per frame and sequence.  A capped layout's overflow families (the
  separate-state backoff graph) add an out-family id on the core rows and
  a per-group encoding on the overflow rows, decoded through the tables
  ``ov_dec`` and ``ovout``.  On the GPU the sweep is the hand-written CUDA
  kernel K7 (its family branch for such a graph) and the walk a small CUDA
  kernel (ops/vit_scan.py);
* the **chunk-recompute decode** (``_viterbi_scale``'s own body) for every
  'dense' graph and for the 'block' graphs the first route refuses
  (several tiers, or an id stream past the budget): a tropical forward
  keeps a checkpoint at the start of every K-frame chunk (all frames, one
  chunk, when they fit 4 GB), then the walk goes back one chunk at a time,
  recomputing the chunk's alphas from its checkpoint and taking the state
  of frame t as the best in-arc source of the state of frame t + 1 (the
  ω arc's source at t = L - 1).  On the GPU the sweeps are K6t
  (ops/dense_scan.py, the tropical instantiation of the dense K6a) or K7n
  (ops/vit_scan.py, K7 without the ids), the walk W2 (ops/vit_scan.py).
  With one chunk the port keeps the first sweep's alphas instead of
  sweeping again (the JAX package recomputes them, the same values).

CPU tensors take the plain PyTorch twins.  The decode is the same in
both domains: a log-domain graph compiles to the same arrays, and the
rescaled max recursion is exact, so it takes the same kernels (JAX's K7
admission has no domain predicate either).  A float64 graph keeps
float64 from the emissions to the score, on the card through the float64
instantiations of K7, K7n, K6t and W2.  A general Ĉ's state emits the max
over its pdf set (JAX ``inference.py:931-938``); on the card such a graph
raises ``NotImplementedError`` before any launch (``_unported_decode``):
K7, K7n and K6t take one pdf per state.  A CUDA tensor whose graph a
kernel refuses raises, naming the first refused predicate: nothing falls
back to a plain route on the card.

``maxstateposteriors`` is the tropical α⊙β of every state and frame,
normalised by the best score (reference ``maxstateposteriors``).
"""
from __future__ import annotations

import dataclasses
import logging

import torch

from .inference import (_CARD_TODO, CompiledFSM, _alpha0, _check_call,
                        _colmax_safe, _combine_shift, _final_val, _log_final,
                        _make_elhs, _make_matvec)
from .ops import dense_scan, vit_scan
from .ops.blocked import block_max_arg_supported
from .ops.emissions import prepare_emissions

__all__ = ["viterbi", "best_path", "maxstateposteriors"]

# the JAX package's budget: the uint8 id stream of the compressed-backpointer
# decode, the int32 backpointers of ``_viterbi_single``, and the (B, N, Sp)
# output of ``maxstateposteriors``
_BP_MEM_BYTES = 6 << 30
_FULL_MEM_BYTES = 4 << 30  # one chunk when every frame's alphas fit this

_LOG = logging.getLogger("markovmodels_tpu_torch")


def _unported_decode(cf: CompiledFSM):
    """Why no decode kernel takes this graph, or None: a general Ĉ (the
    max over each state's pdfs).  Such a graph decodes through the plain
    twins on its lifted inputs (:func:`_plain_inputs`) on the CPU and
    raises on the card (:func:`viterbi`)."""
    if cf.multi_pdf:
        return ("general multi-pdf C-hat graph (K7, K7n and K6t take one "
                "pdf per state)")
    return None


def _plain_decode(cf: CompiledFSM) -> bool:
    """True when the 'dense' / 'block' decode runs on the plain twins
    whatever the device: a graph of :func:`_unported_decode` (the CPU
    only: :func:`viterbi` refuses it on the card first)."""
    return _unported_decode(cf) is not None


def _pdf_sets(cf: CompiledFSM):
    """(Sp, Dmax) int64: each state's pdfs from the binary Ĉᵀ, padded with
    P1 (a zero row); cached on the graph."""
    sets = cf._cache.get("pdf_sets")
    if sets is None:
        oh = cf.pdf_onehot.T > 0  # (Sp, P1)
        cnt = oh.sum(dim=1)
        dmax = max(int(cnt.max()), 1)
        rank = torch.cumsum(oh.long(), dim=1) - 1
        sets = torch.full((oh.shape[0], dmax), oh.shape[1], dtype=torch.long,
                          device=oh.device)
        st, pd = torch.nonzero(oh, as_tuple=True)
        sets[st, rank[st, pd]] = pd
        cf._cache["pdf_sets"] = sets
    return sets


def _plain_inputs(cf: CompiledFSM, lhs, lengths):
    """(graph, ext, mshift) for the plain twins: the emissions in the
    graph's dtype (prepare_emissions); for a general Ĉ lifted to the
    states, ext (Nf, Sp, B) the max over each state's pdf set (0 for a
    state without one), with a view of the graph whose states are their
    own pdfs."""
    ext, mshift = prepare_emissions(lhs, lengths, lhs.shape[2],
                                    cf.alpha_hat.dtype)
    if not cf.multi_pdf:
        return cf, ext, mshift
    sets = _pdf_sets(cf)
    ext_z = torch.nn.functional.pad(ext, (0, 0, 0, 1))  # row P1: zeros
    lift = ext_z[:, sets[:, 0]]
    for d in range(1, sets.shape[1]):
        lift = torch.maximum(lift, ext_z[:, sets[:, d]])
    ident = torch.arange(cf.padded_states, dtype=torch.int32,
                         device=cf.device)
    return dataclasses.replace(cf, state_pdf=ident, _cache={}), lift, mshift


def _bp_vit_reject_reason(cf: CompiledFSM, lhs):
    """None when the compressed-backpointer decode (_viterbi_scale_bp) can
    run, else the first rejected predicate, the JAX package's in its
    order: block strategy, rank-1 ω split, single affine tier (candidate
    ids fit uint8; with overflow families ``ov_lo`` / ``cmax`` from the
    layout, as the JAX package passes them, and the port's two family
    predicates of ``block_max_arg_reason``), and the (Nf, Sp, B) uint8 id
    stream within the JAX package's 6 GB budget (so both packages take the
    same route for the same call).  Only ``lhs.shape`` is read."""
    if cf.strategy != "block":
        return f"strategy {cf.strategy!r} != 'block'"
    if cf.omega_prob is None:
        return "no rank-1 omega split"
    if "bp_max_arg" not in cf._cache:  # a property of the graph
        span = vit_scan.ov_span(cf)
        ov = {} if span is None else dict(
            ov_lo=span[0], cmax=span[2], ov_hi=span[0] + span[1] * span[2])
        cf._cache["bp_max_arg"] = block_max_arg_supported(
            cf.block_fwd, cf.block_fwd_offsets, **ov)
    if not cf._cache["bp_max_arg"]:
        return ("operator not a single affine tier (+ supported overflow "
                "families) with uint8-range candidate ids")
    B, N, _ = lhs.shape
    need = (N + 1) * cf.padded_states * B
    if need > _BP_MEM_BYTES:
        return (f"uint8 backpointer stream ~{need / 1e9:.1f} GB exceeds "
                f"the {_BP_MEM_BYTES / 1e9:.0f} GB budget (chunk-recompute "
                "decode used instead, ~2x slower)")
    return None


def _viterbi_scale_bp(cf: CompiledFSM, lhs, lengths):
    """The compressed-backpointer decode: K7's sweep, then the walk (their
    plain twins for CPU tensors, for every graph the route admits; a graph
    of :func:`_unported_decode` on its own inputs).  Returns (states (B,
    N) int32 in host state ids, score (B,))."""
    B, N, P = lhs.shape
    if _plain_decode(cf):
        cfv, ext, mshift = _plain_inputs(cf, lhs, lengths)
        bps, fins, vfin, shift, ksum = vit_scan.viterbi_fwd_plain(cfv, ext,
                                                                  mshift)
        states = vit_scan.walk_plain(vit_scan.walk_tables(cf), bps, fins,
                                     lengths)
        score = _combine_shift(_log_final(vfin), ksum, shift).to(lhs.dtype)
        return cf.orig_state[states.long()].T.contiguous(), score
    if lhs.device.type == "cuda":
        reason = vit_scan.vit_scan_reject_reason(cf, B, n_frames=N,
                                                 device=lhs.device)
        if reason is not None:
            raise NotImplementedError(
                f"the fused Viterbi sweep (K7) refuses this graph: {reason}; "
                "the JAX package's XLA form of the sweep is not ported to "
                "the card (ROADMAP queue 1 item 16)")
    ext, mshift = prepare_emissions(lhs, lengths, P, cf.alpha_hat.dtype)
    bps, fins, vfin, shift, ksum = vit_scan.viterbi_fwd(cf, ext, mshift)
    score = _combine_shift(_log_final(vfin), ksum, shift).to(lhs.dtype)
    states = vit_scan.walk(vit_scan.walk_tables(cf), bps, fins, lengths)
    states = cf.orig_state[states.long()].T.contiguous()  # (B, N)
    return states, score


def _chunk_frames(cf: CompiledFSM, lhs, chunk_size) -> int:
    """K, the frames of a chunk: all Nf frames when their (Sp, B) alphas
    fit 4 GB at 4 bytes a value, else 64, or ``chunk_size``: the JAX
    package's rule, whose 4 bytes hold in float64 too (JAX
    ``viterbi.py:434``), so that both packages chunk alike; the kernels'
    admissions count the real bytes."""
    B, N, _ = lhs.shape
    Nf = N + 1
    if chunk_size is None:
        est = Nf * cf.padded_states * B * 4
        chunk_size = Nf if est <= _FULL_MEM_BYTES else 64
    return max(1, min(int(chunk_size), Nf))


def _sweeps(cf: CompiledFSM, B: int, Nf: int, K: int, device,
            plain: bool = False):
    """The tropical sweeps of the recompute decode on ``device``, as
    (sweep, checkpoints), the kernels' or, with ``plain`` (a graph of
    :func:`_unported_decode`; ``cf`` then from :func:`_plain_inputs`), their
    plain twins:

    * sweep(a, s, t0, ext, mshift, acc) -> (states, scales, a_last,
      s_last): the frames of ``ext`` from the state ``a`` (unscaled) with
      scale ``s`` at global frame t0, every frame's state kept;
    * checkpoints(a0, s0, ext, mshift, acc) -> ([(a, s)] at the start of
      each K-frame chunk, a_last, s_last): the whole sweep, only the
      chunks' first states kept.

    ``acc`` (3, B) carries ksum, the shift and its compensation.  On a
    CUDA device the kernels' admissions run first and raise, naming the
    first refused predicate."""
    C = -(-Nf // K)
    if cf.strategy == "dense":
        if device.type == "cuda" and not plain:
            reason = dense_scan.dense_scan_reject_reason(
                cf, B, n_frames=K - 1, device=device, tropical=True)
            if reason is not None:
                raise ValueError("the tropical dense sweep (K6t) refuses "
                                 f"this graph: {reason}")
        if plain:  # the probability operator in the graph's dtype
            wf = torch.exp(cf.dense_fwd_max)[:, None] * cf.dense_fwd_exp
            kop = dense_scan.DenseOp(
                Sp=cf.padded_states, P1=cf.num_pdfs + 1,
                fin=int(cf.final_state), alpha0=torch.exp(cf.alpha_hat),
                wf=wf, wb=wf, spdf=cf.state_pdf, perm=None, off=None,
                pf=None, pb=None)
            trop = dense_scan.trop_sweep_plain
        else:
            kop = dense_scan.trop_operator(cf)
            trop = dense_scan.trop_sweep

        def sweep(a, s, t0, ext, mshift, acc=None):
            return trop(kop, a, s, ext, mshift, first=t0 == 0, acc=acc)[:4]

        def checkpoints(a, s, ext, mshift, acc):
            cks = []
            for c in range(C):
                cks.append((a, s))
                _, _, a, s, _ = trop(
                    kop, a, s, ext[c * K:(c + 1) * K],
                    mshift[c * K:(c + 1) * K], first=c == 0, save=False,
                    acc=acc)
            return cks, a, s
        return sweep, checkpoints

    if cf.omega_prob is None:
        raise NotImplementedError(
            "the chunk-recompute decode of a 'block' graph without its "
            "rank-1 omega split is not ported")
    if device.type == "cuda" and not plain:
        reason = vit_scan.vit_scan_reject_reason(
            cf, B, n_frames=Nf - 1, device=device, saved=max(K, Nf // K))
        if reason is not None:
            raise ValueError("the id-free Viterbi sweep (K7n) refuses this "
                             f"graph: {reason} (ROADMAP queue 1 item 16)")
    fwd = vit_scan.viterbi_fwd_plain if plain else vit_scan.viterbi_fwd

    def sweep(a, s, t0, ext, mshift, acc=None):
        return fwd(cf, ext, mshift, ids=False, a0=a, s0=s, t0=t0,
                   acc=acc)[:4]

    def checkpoints(a, s, ext, mshift, acc):
        save, scales, a_last, s_last, _ = fwd(
            cf, ext, mshift, ids=False, a0=a, s0=s, stride=K, acc=acc)
        cks = [(a, s)] + [(save[c], scales[c]) for c in range(C - 1)]
        return cks, a_last, s_last
    return sweep, checkpoints


def _viterbi_recompute(cf: CompiledFSM, lhs, lengths, chunk_size=None):
    """The chunk-recompute decode of a 'dense' or 'block' graph: the
    forward (one sweep that keeps every frame when there is one chunk,
    else one that keeps each chunk's first state), then per chunk in
    reverse its alphas recomputed from the checkpoint and W2's walk.
    Returns (states (B, N) int32 in host state ids, score (B,))."""
    B, N, P = lhs.shape
    Sp, Nf, fin = cf.padded_states, N + 1, int(cf.final_state)
    K = _chunk_frames(cf, lhs, chunk_size)
    C = -(-Nf // K)
    plain = _plain_decode(cf)
    if plain:
        cfv, ext, mshift = _plain_inputs(cf, lhs, lengths)
        walk = vit_scan.rec_walk_plain
    else:
        cfv, (ext, mshift) = cf, prepare_emissions(lhs, lengths, P,
                                                   cf.alpha_hat.dtype)
        walk = vit_scan.rec_walk
    sweep, checkpoints = _sweeps(cfv, B, Nf, K, lhs.device, plain)
    wt = vit_scan.rec_walk_tables(cf)
    dt = ext.dtype
    a0 = torch.exp(cf.alpha_hat)[:, None].expand(Sp, B).contiguous()
    s0 = torch.ones(B, device=lhs.device, dtype=dt)
    acc = torch.zeros((3, B), device=lhs.device, dtype=dt)
    if C == 1:
        states, scales, a_last, s_last = sweep(a0, s0, 0, ext, mshift, acc)
    else:
        cks, a_last, s_last = checkpoints(a0, s0, ext, mshift, acc)
    score = _combine_shift(_log_final(a_last[fin] * s_last), acc[0],
                           acc[1]).to(lhs.dtype)
    path = torch.empty((Nf, B), dtype=torch.int32, device=lhs.device)
    s = torch.full((B,), fin, dtype=torch.int32, device=lhs.device)
    for c in reversed(range(C)):
        t0, t1 = c * K, min((c + 1) * K, Nf)
        if C > 1:
            states, scales, _, _ = sweep(*cks[c], t0, ext[t0:t1],
                                         mshift[t0:t1])
        path[t0:t1] = walk(wt, states, scales, lengths, t0, s)
        s = path[t0]
    return cf.orig_state[path[:N].long()].T.contiguous(), score


def _viterbi_scale(cf: CompiledFSM, lhs, lengths, chunk_size=None):
    """'dense' / 'block' graphs: the compressed-backpointer decode where it
    applies, the chunk-recompute decode otherwise (a 'block' graph that
    leaves the first route logs the reason once, as the JAX package
    does)."""
    reason = _bp_vit_reject_reason(cf, lhs)
    if reason is None:
        return _viterbi_scale_bp(cf, lhs, lengths)
    logged = cf._cache.setdefault("vit_recompute_logged", set())
    if cf.strategy == "block" and reason not in logged:
        logged.add(reason)
        _LOG.warning("block-strategy Viterbi fell back to chunk-recompute: "
                     "%s", reason)
    return _viterbi_recompute(cf, lhs, lengths, chunk_size)


def _trop_forward(cf: CompiledFSM, lhs, lengths, keep, arg=True):
    """The log-domain tropical forward of ``_viterbi_single`` and
    ``maxstateposteriors`` (one graph shared by the batch, or a stacked
    graph's column g through graph g): per frame y = T̂ᵀ ⊗ x over the
    graph's edges (an 'ell' graph's arc lists) with its backpointers, plus
    the emissions, shifted by the column max; ``keep(t, x, shift, bp)``
    sees every frame (``bp`` None at frame 0, and in every frame without
    ``arg``, which computes no backpointer).  Returns (score (B,), the
    emissions ``elhs``, the frame-major log-likelihoods)."""
    B, N, _ = lhs.shape
    dt = lhs.dtype
    mv = _make_matvec(cf, "fwd", dt, op="max", arg=arg)
    elhs = _make_elhs(cf, lengths, dt, trop=True)
    lhs_tm = torch.nn.functional.pad(lhs.permute(1, 0, 2),
                                     (0, 0, 0, 0, 0, 1))
    x, shift = _alpha0(cf, dt, B), lhs.new_zeros(B)
    for t in range(N + 1):
        bp = None
        if t > 0:
            x, bp = mv(x) if arg else (mv(x), None)
        x = x + elhs(lhs_tm[t], t)
        m = _colmax_safe(x)
        x, shift = x - m[None, :], shift + m
        keep(t, x, shift, bp)
    return _final_val(cf, B)(x, shift), elhs, lhs_tm


def _viterbi_single(cf: CompiledFSM, lhs, lengths):
    """The log-domain tropical scan with int32 backpointers (the JAX
    package's ``_viterbi_single``), then the walk back from the phony
    final state.  Returns (states (B, N) int32 in host state ids, score
    (B,))."""
    B, N, P = lhs.shape
    Sp, Nf = cf.padded_states, N + 1
    need = 4 * Nf * Sp * B  # every frame's int32 backpointers (Nf, Sp, B)
    if need > _BP_MEM_BYTES:
        raise ValueError(
            f"viterbi int32 backpointer stream ~{need / 1e9:.1f} GB "
            f"(Nf={Nf} x Sp={Sp} x B={B}) exceeds the "
            f"{_BP_MEM_BYTES / 1e9:.0f} GB budget for the "
            f"{cf.strategy!r} strategy; compile the graph with "
            "strategy='block' (or 'dense') to use the at-scale "
            "chunk-recompute decoder instead")
    bps = torch.empty((Nf, Sp, B), dtype=torch.int32, device=lhs.device)

    def keep(t, x, shift, bp):
        if bp is not None:
            bps[t] = bp

    score, _, _ = _trop_forward(cf, lhs, lengths, keep)
    # an index the JAX package's gather would wrap (negative) or clamp (out
    # of range) is read so
    bcol = torch.arange(B, device=lhs.device)
    states = torch.empty((N, B), dtype=torch.int32, device=lhs.device)
    s = torch.as_tensor(cf.final_state, device=lhs.device).long().expand(B)
    for t in range(Nf - 1, 0, -1):
        i = torch.where(s < 0, s + Sp, s).clamp(0, Sp - 1)
        states[t - 1] = bps[t][i, bcol]
        s = states[t - 1].long()
    # host ids through orig_state (a graph's own column when stacked); an
    # index outside the graph reads the int32 minimum, as jnp.take's fill
    orig = cf.orig_state.T if cf.batched else cf.orig_state[:, None]
    i = states.long()
    i = torch.where(i < 0, i + Sp, i)
    host = orig.expand(Sp, B).gather(0, i.clamp(0, Sp - 1))
    host = torch.where((i >= 0) & (i < Sp), host,
                       torch.full_like(host, torch.iinfo(torch.int32).min))
    return host.T.contiguous(), score


def viterbi(cf: CompiledFSM, lhs, lengths=None, *, chunk_size=None):
    """Best-path decode.  Returns (state sequence (B, N) int32, score (B,)).

    ``lhs``: (B, N, P) log-likelihoods on the graph's device; ``lengths``:
    (B,) frame counts, clamped to N.  States are host state ids (through
    ``orig_state``).  For frames past each utterance's length the decode
    sits on the phony final state, so returned entries there equal the
    phony state id; mask with ``lengths`` when consuming.  An infeasible
    sequence scores -inf.  A stacked graph decodes one sequence per graph
    (B = G), each through its own graph.  ``chunk_size``: the frames per
    chunk of the chunk-recompute decode (by default all of them when their
    alphas fit 4 GB, else 64); the other decodes ignore it."""
    lhs, lengths = _check_call(cf, lhs, lengths)
    todo = _unported_decode(cf) if lhs.device.type == "cuda" else None
    if todo is not None:
        raise NotImplementedError(f"Viterbi of a {todo} on the card "
                                  f"({_CARD_TODO})")
    if not cf.batched and cf.strategy in ("dense", "block"):
        return _viterbi_scale(cf, lhs, lengths, chunk_size)
    return _viterbi_single(cf, lhs, lengths)


best_path = viterbi


def maxstateposteriors(cf: CompiledFSM, lhs, lengths=None):
    """Per-state max-posterior scores (tropical α⊙β), (B, N, Sp) in the log
    domain, normalised by the Viterbi score, so that the best path's
    states score 0 (the reference's historical ``maxstateposteriors``,
    test/test_algorithms.jl:262-284), with the Viterbi scores (B,).  The
    tropical scans run over the graph's edges (an 'ell' graph's arc lists)
    on every device, one sequence per graph for a stacked graph.  States
    are the compiled slots.  The result and the alphas it keeps are (B, N,
    Sp) each: past the 6 GB budget the call raises ``ValueError`` before
    it allocates."""
    lhs, lengths = _check_call(cf, lhs, lengths)
    B, N, P = lhs.shape
    Sp, Nf, dt = cf.padded_states, N + 1, lhs.dtype
    need = Nf * Sp * B * lhs.element_size()
    if need > _BP_MEM_BYTES:
        raise ValueError(
            f"maxstateposteriors keeps ~{need / 1e9:.1f} GB of (Nf={Nf} x "
            f"Sp={Sp} x B={B}) scores, past the {_BP_MEM_BYTES / 1e9:.0f} GB "
            "budget; decode with viterbi, or split the batch")
    A = lhs.new_empty((Nf, Sp, B))
    ashift = lhs.new_empty((Nf, B))

    def keep(t, x, shift, bp):
        A[t], ashift[t] = x, shift

    score, elhs, lhs_tm = _trop_forward(cf, lhs, lengths, keep, arg=False)
    bmv = _make_matvec(cf, "bwd", dt, op="max", arg=False)
    bb = torch.zeros_like(A[0])
    for t in reversed(range(Nf)):  # A[t] becomes frame t's result
        y = torch.zeros_like(bb) if t == Nf - 1 else bmv(bb)
        bb = y + elhs(lhs_tm[t], t)
        A[t] = A[t] + ashift[t][None, :] + y - score[None, :]
    return A[:N].permute(2, 0, 1), score
