"""Viterbi decoding: the best path of a 'dense' or 'block' graph.

PyTorch counterpart of ``markovmodels_tpu/viterbi.py``'s at-scale routes,
picked as the JAX package picks them (``_viterbi_scale``):

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

CPU tensors take the plain PyTorch twins.  A CUDA tensor whose graph a
kernel refuses raises, naming the first refused predicate: nothing falls
back to a plain route on the card.  Routes of the JAX package that are not
ported yet raise ``NotImplementedError`` naming the route: the vmapped
``_viterbi_single`` of batched graphs, and ``_viterbi_single`` for the
'segment' / 'ell' strategies.
"""
from __future__ import annotations

import logging

import torch

from .inference import CompiledFSM, _combine_shift, _log_final
from .ops import dense_scan, vit_scan
from .ops.blocked import block_max_arg_supported
from .ops.emissions import prepare_emissions

__all__ = ["viterbi", "best_path"]

_BP_MEM_BYTES = 6 << 30  # the JAX package's budget for the uint8 id stream
_FULL_MEM_BYTES = 4 << 30  # one chunk when every frame's alphas fit this

_LOG = logging.getLogger("markovmodels_tpu_torch")

_SINGLE_TODO = ("_viterbi_single is not ported yet (ROADMAP queue 11, with "
                "queue 1 item 10)")


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
    plain twins for CPU tensors, for every graph the route admits).
    Returns (states (B, N) int32 in host state ids, score (B,))."""
    B, N, P = lhs.shape
    if lhs.device.type == "cuda":
        reason = vit_scan.vit_scan_reject_reason(cf, B, n_frames=N,
                                                 device=lhs.device)
        if reason is not None:
            raise NotImplementedError(
                f"the fused Viterbi sweep (K7) refuses this graph: {reason}; "
                "the JAX package's XLA form of the sweep is not ported to "
                "the card (ROADMAP queue 11)")
    ext, mshift = prepare_emissions(lhs, lengths, P)
    bps, fins, vfin, shift, ksum = vit_scan.viterbi_fwd(cf, ext, mshift)
    score = _combine_shift(_log_final(vfin), ksum, shift).to(lhs.dtype)
    states = vit_scan.walk(vit_scan.walk_tables(cf), bps, fins, lengths)
    states = cf.orig_state[states.long()].T.contiguous()  # (B, N)
    return states, score


def _chunk_frames(cf: CompiledFSM, lhs, chunk_size) -> int:
    """K, the frames of a chunk: all Nf frames when their (Sp, B) float32
    alphas fit 4 GB, else 64 (the JAX package's rule), or ``chunk_size``."""
    B, N, _ = lhs.shape
    Nf = N + 1
    if chunk_size is None:
        est = Nf * cf.padded_states * B * 4
        chunk_size = Nf if est <= _FULL_MEM_BYTES else 64
    return max(1, min(int(chunk_size), Nf))


def _sweeps(cf: CompiledFSM, B: int, Nf: int, K: int, device):
    """The tropical sweeps of the recompute decode on ``device``, as
    (sweep, checkpoints):

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
        if device.type == "cuda":
            reason = dense_scan.dense_scan_reject_reason(
                cf, B, n_frames=K - 1, device=device)
            if reason is not None:
                raise ValueError("the tropical dense sweep (K6t) refuses "
                                 f"this graph: {reason}")
        kop = dense_scan.trop_operator(cf)

        def sweep(a, s, t0, ext, mshift, acc=None):
            return dense_scan.trop_sweep(kop, a, s, ext, mshift,
                                         first=t0 == 0, acc=acc)[:4]

        def checkpoints(a, s, ext, mshift, acc):
            cks = []
            for c in range(C):
                cks.append((a, s))
                _, _, a, s, _ = dense_scan.trop_sweep(
                    kop, a, s, ext[c * K:(c + 1) * K],
                    mshift[c * K:(c + 1) * K], first=c == 0, save=False,
                    acc=acc)
            return cks, a, s
        return sweep, checkpoints

    if cf.omega_prob is None:
        raise NotImplementedError(
            "the chunk-recompute decode of a 'block' graph without its "
            "rank-1 omega split is not ported")
    if device.type == "cuda":
        reason = vit_scan.vit_scan_reject_reason(
            cf, B, n_frames=Nf - 1, device=device, saved=max(K, Nf // K))
        if reason is not None:
            raise ValueError("the id-free Viterbi sweep (K7n) refuses this "
                             f"graph: {reason}")

    def sweep(a, s, t0, ext, mshift, acc=None):
        return vit_scan.viterbi_fwd(cf, ext, mshift, ids=False, a0=a, s0=s,
                                    t0=t0, acc=acc)[:4]

    def checkpoints(a, s, ext, mshift, acc):
        save, scales, a_last, s_last, _ = vit_scan.viterbi_fwd(
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
    sweep, checkpoints = _sweeps(cf, B, Nf, K, lhs.device)
    ext, mshift = prepare_emissions(lhs, lengths, P)
    wt = vit_scan.rec_walk_tables(cf)
    a0 = torch.exp(cf.alpha_hat)[:, None].expand(Sp, B).contiguous()
    s0 = torch.ones(B, device=lhs.device)
    acc = torch.zeros((3, B), device=lhs.device)
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
        path[t0:t1] = vit_scan.rec_walk(wt, states, scales, lengths, t0, s)
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


def viterbi(cf: CompiledFSM, lhs, lengths=None, *, chunk_size=None):
    """Best-path decode.  Returns (state sequence (B, N) int32, score (B,)).

    ``lhs``: (B, N, P) log-likelihoods on the graph's device; ``lengths``:
    (B,) frame counts, clamped to N.  States are host state ids (through
    ``orig_state``).  For frames past each utterance's length the decode
    sits on the phony final state, so returned entries there equal the
    phony state id; mask with ``lengths`` when consuming.  An infeasible
    sequence scores -inf.  ``chunk_size``: the frames per chunk of the
    chunk-recompute decode (by default all of them when their alphas fit
    4 GB, else 64); the compressed-backpointer decode ignores it."""
    lhs = torch.as_tensor(lhs)
    if lhs.ndim != 3:
        raise ValueError("lhs must have shape (B, N, P)")
    if lhs.device != cf.device:
        raise ValueError(f"lhs is on {lhs.device}, the graph on {cf.device}")
    B, N, P = lhs.shape
    if P != cf.num_pdfs:
        raise ValueError(f"lhs has {P} pdfs, graph expects {cf.num_pdfs}")
    if lengths is None:
        lengths = torch.full((B,), N, dtype=torch.int32, device=lhs.device)
    lengths = torch.clamp(
        torch.as_tensor(lengths).to(device=lhs.device, dtype=torch.int32),
        max=N,
    )
    if cf.batched:
        raise NotImplementedError(
            f"Viterbi of a batched {cf.strategy!r} graph (the vmapped "
            f"per-graph decode): {_SINGLE_TODO}")
    if cf.strategy in ("dense", "block"):
        return _viterbi_scale(cf, lhs, lengths, chunk_size)
    raise NotImplementedError(
        f"Viterbi of a {cf.strategy!r} graph: {_SINGLE_TODO}")


best_path = viterbi
