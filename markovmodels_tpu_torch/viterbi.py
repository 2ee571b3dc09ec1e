"""Viterbi decoding: the best path of a 'block' graph.

PyTorch counterpart of ``markovmodels_tpu/viterbi.py``.  The ported route
is the JAX package's at-scale design for 'block' graphs with a single
affine tier (``_viterbi_scale_bp``): ONE tropical forward sweep records,
per frame and state, the winning *candidate id* (a uint8: the in-degree of
every state is tier width + band count < 255) and per frame the argmax of
the rank-1 ω arcs into the phony final state; the backtrace is then a
walk that decodes one id per frame and sequence.  On the GPU the sweep is
the hand-written CUDA kernel K7 and the walk a small CUDA kernel
(ops/vit_scan.py); CPU tensors take their plain PyTorch twins.

Routes of the JAX package that are not ported yet raise
``NotImplementedError`` naming the route and the refused predicate; there
is no fallback: the overflow-family decode of a capped layout, the
chunk-recompute decode ('dense' graphs and 'block' graphs the
compressed-backpointer decode refuses), the vmapped
``_viterbi_single`` of batched graphs, and ``_viterbi_single`` for the
'segment' / 'ell' strategies.
"""
from __future__ import annotations

import torch

from .inference import CompiledFSM, _combine_shift, _log_final
from .ops import vit_scan
from .ops.blocked import block_max_arg_supported
from .ops.emissions import prepare_emissions

__all__ = ["viterbi", "best_path"]

_BP_MEM_BYTES = 6 << 30  # the JAX package's budget for the uint8 id stream

_RECOMPUTE_TODO = ("the chunk-recompute Viterbi decode is not ported yet "
                   "(ROADMAP queue 11)")
_SINGLE_TODO = ("_viterbi_single is not ported yet (ROADMAP queue 11, with "
                "queue 1 item 10)")
_OV_TODO = ("the overflow-family decode (K7's family branch and its decode "
            "tables) is not ported yet (ROADMAP queue 11)")


def _bp_vit_reject_reason(cf: CompiledFSM, lhs):
    """None when the compressed-backpointer decode (_viterbi_scale_bp) can
    run, else the first rejected predicate, the JAX package's in its
    order: block strategy, rank-1 ω split, single affine tier (candidate
    ids fit uint8), and the (Nf, Sp, B) uint8 id stream within the JAX
    package's 6 GB budget (so both packages take the same route for the
    same call).  Only ``lhs.shape`` is read."""
    if cf.strategy != "block":
        return f"strategy {cf.strategy!r} != 'block'"
    if cf.omega_prob is None:
        return "no rank-1 omega split"
    if not block_max_arg_supported(cf.block_fwd, cf.block_fwd_offsets):
        return ("operator not a single affine tier (+ supported overflow "
                "families) with uint8-range candidate ids")
    B, N, _ = lhs.shape
    need = (N + 1) * cf.padded_states * B
    if need > _BP_MEM_BYTES:
        return (f"uint8 backpointer stream ~{need / 1e9:.1f} GB exceeds "
                f"the {_BP_MEM_BYTES / 1e9:.0f} GB budget ({_RECOMPUTE_TODO})")
    return None


def _viterbi_scale_bp(cf: CompiledFSM, lhs, lengths):
    """The compressed-backpointer decode: K7's sweep, then the walk.
    Returns (states (B, N) int32 in host state ids, score (B,))."""
    B, N, P = lhs.shape
    reason = vit_scan.vit_scan_reject_reason(cf, B, n_frames=N,
                                             device=lhs.device)
    if reason is not None:
        raise NotImplementedError(
            f"the fused Viterbi sweep (K7) refuses this graph: {reason}; "
            "the JAX package's XLA form of the sweep is not ported yet "
            "(ROADMAP queue 11)")
    ext, mshift = prepare_emissions(lhs, lengths, P)
    bps, fins, vfin, shift, ksum = vit_scan.viterbi_fwd(cf, ext, mshift)
    score = _combine_shift(_log_final(vfin), ksum, shift).to(lhs.dtype)
    states = vit_scan.walk(vit_scan.walk_tables(cf), bps, fins, lengths)
    states = cf.orig_state[states.long()].T.contiguous()  # (B, N)
    return states, score


def _viterbi_scale(cf: CompiledFSM, lhs, lengths):
    """'dense' / 'block' graphs: the compressed-backpointer decode where it
    applies; the chunk-recompute decode otherwise (not ported yet).  The
    JAX package decodes a capped layout's overflow families in its
    compressed-backpointer form; the port does not yet."""
    if cf.strategy == "block" and cf.block_fwd.ov_w:
        raise NotImplementedError(
            f"Viterbi of a graph with overflow families (ov_layout "
            f"{cf.ov_layout}): {_OV_TODO}")
    reason = _bp_vit_reject_reason(cf, lhs)
    if reason is not None:
        raise NotImplementedError(
            f"the compressed-backpointer decode refuses this graph: "
            f"{reason}; {_RECOMPUTE_TODO}")
    return _viterbi_scale_bp(cf, lhs, lengths)


def viterbi(cf: CompiledFSM, lhs, lengths=None):
    """Best-path decode.  Returns (state sequence (B, N) int32, score (B,)).

    ``lhs``: (B, N, P) log-likelihoods on the graph's device; ``lengths``:
    (B,) frame counts, clamped to N.  States are host state ids (through
    ``orig_state``).  For frames past each utterance's length the decode
    sits on the phony final state, so returned entries there equal the
    phony state id; mask with ``lengths`` when consuming.  An infeasible
    sequence scores -inf.  The JAX package's ``chunk_size`` belongs to its
    chunk-recompute decode, which is not ported."""
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
        return _viterbi_scale(cf, lhs, lengths)
    raise NotImplementedError(
        f"Viterbi of a {cf.strategy!r} graph: {_SINGLE_TODO}")


best_path = viterbi
