"""Compiled FSMs, the batched forward-backward and the LF-MMI loss.

PyTorch counterpart of ``markovmodels_tpu/inference.py``: every strategy
('dense', 'block', 'banded', 'ell', 'segment'), both domains ('prob' and
'log'), float32 or float64, one pdf per state or a general Ĉ:

* ``compile_fsm`` lowers a host ``FSM`` to a :class:`CompiledFSM` of
  tensors ('dense': exp-shifted (Sp, Sp) operators with their row maxima,
  the default for graphs of up to 4,096 states; 'block': pdf-grouped
  relabeling, COO edge arrays, blocked operator, rank-1 ω split; 'banded':
  per-offset arc bands and the ω split; 'ell': padded incoming-arc lists;
  'segment': the COO edge arrays alone), equal to the JAX package's
  arrays; ``stack`` (alias ``batch``) stacks graphs of any strategy but
  'block', e.g. the per-utterance numerator lattices;
* ``pdfposteriors`` / ``forward`` run the scans.  Probability-domain
  'dense', 'block' and stacked 'banded' graphs take the plain PyTorch scan
  for CPU tensors and the hand-written kernels for CUDA tensors
  (``ops/dense_scan.py`` for one shared 'dense' graph,
  ``ops/block_scan.py`` for one shared 'block' graph,
  ``ops/banded_scan.py`` for stacked 'banded' graphs, one sequence each;
  each float32 or float64), and raise, naming the first rejected
  predicate, for a 'dense' or 'banded' graph those kernels do not accept.
  The routes that the JAX package runs outside any Pallas kernel take
  their plain PyTorch scan on every device (``_plain_everywhere``,
  decided from the graph before any launch): the log-space scan
  ``_fb_run`` of log-domain graphs and of 'segment' / 'ell' graphs, and
  the per-graph route of stacked graphs, one sequence per graph, that the
  stacked probability-domain scans do not take.  On the card, a general-Ĉ
  graph and a 'block' graph that the fused kernels refuse for a predicate
  of the JAX package's admission take the plain probability-domain scan
  ``_fb_prob``, the counterpart of the XLA route the JAX package sends
  them to (``_plain_on_card``, decided from the graph and the batch
  before any launch; a 'block' graph logs the refused predicate once); a
  'block' graph that only the port's own predicates refuse raises;
* ``logmarginal`` and ``lfmmi_loss`` are differentiable in ``lhs``: the
  gradient of logZ is the posterior matrix the scan already computed, so
  autograd never differentiates the scan.  This is the LF-MMI training
  step: ``lfmmi_loss(num, den, lhs, lengths).sum().backward()``;
* ``expand``, ``alpha_recursion`` and ``beta_recursion`` are the
  reference's likelihood expansion and full (unrescaled) log-domain
  messages.

Layouts at the public functions are the JAX package's: ``lhs`` (B, N, P),
``lengths`` (B,), results (posteriors (B, N, P), logZ (B,)).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from . import hostsparse as hs
from .fsm import FSM
from .ops import banded_scan, block_scan, dense_scan
from .ops import semiring_ops as sops
from .ops.block_scan import _pow2_exponent, _pow2_scale
from .ops.blocked import (BlockOperator, block_matvec, build_block_operator,
                          family_grids, round_bf16)
from .ops.emissions import prepare_emissions

__all__ = [
    "CompiledFSM",
    "compile_fsm",
    "compiled_from_numpy",
    "stack",
    "batch",
    "pdfposteriors",
    "forward",
    "logmarginal",
    "lfmmi_loss",
    "fast_path_report",
    "expand",
    "alpha_recursion",
    "beta_recursion",
]

_MODES_TODO = ("ROADMAP queue 1 item 9, its remainder: precision 'bf16' with "
               "dtype float64, which the JAX package defines only by what "
               "XLA's CPU ignores")
_STRATEGIES = ("dense", "block", "banded", "ell", "segment")
_DOMAINS = ("prob", "log")


def _round_up(x, m):
    return -(-x // m) * m


@dataclasses.dataclass
class CompiledFSM:
    """Device representation of one FSM (or a stacked batch of FSMs of any
    strategy but 'block').

    Shapes below are for a single graph (``batched=False``); a stacked batch
    adds a leading graph axis G to every tensor field.  ``Sp`` is the padded
    state count; real states come first.  Static metadata (counts,
    descriptors, layout, an unstacked graph's final state) is plain Python,
    so nothing on the hot path reads a device scalar back to the host.
    """

    # (Sp,) log-domain initial weights of the extended graph [α; zero]
    alpha_hat: torch.Tensor
    # index of the phony final state: an int, or (G,) int32 when stacked
    final_state: "int | torch.Tensor"
    # (Sp,) int32 pdf index per state; phony & padding -> num_pdfs
    state_pdf: torch.Tensor
    # COO edges of T̂ sorted by destination / by source (log weights)
    fwd_src: torch.Tensor
    fwd_dst: torch.Tensor
    fwd_w: torch.Tensor
    bwd_src: torch.Tensor
    bwd_dst: torch.Tensor
    bwd_w: torch.Tensor
    # one-hot Ĉᵀ (P+1, Sp) when the layout is not pdf-grouped, else None
    pdf_onehot: Optional[torch.Tensor]
    # 'block': blocked gather-matmul-scatter operators of the S×S core
    block_fwd: Optional[BlockOperator]
    block_bwd: Optional[BlockOperator]
    # (Sp,) probabilities of the arcs into the phony final state (ω column);
    # None for 'dense', whose operator holds that column
    omega_prob: Optional[torch.Tensor]
    # (Sp,) int32 original state id per (possibly reordered) slot; -1 pad
    orig_state: torch.Tensor
    # 'banded': (nO, Sp) arc probabilities per offset of banded_offsets,
    # indexed by destination (fwd) / by source (bwd)
    banded_fwd: Optional[torch.Tensor] = None
    banded_bwd: Optional[torch.Tensor] = None
    # 'dense': (Sp, Sp) float32 exp(W - row_max) contracted over axis 1
    # (fwd W[j, i] = T̂[i, j], bwd W[i, j] = T̂[i, j]; 0 for absent arcs)
    # and the (Sp,) row maxima (-inf for an empty row)
    dense_fwd_exp: Optional[torch.Tensor] = None
    dense_fwd_max: Optional[torch.Tensor] = None
    dense_bwd_exp: Optional[torch.Tensor] = None
    dense_bwd_max: Optional[torch.Tensor] = None
    # 'ell': (Sp, D) int32 padded incoming-arc sources (0 pads) and their
    # log weights (-inf pads), fwd by destination, bwd by source
    ell_fwd_src: Optional[torch.Tensor] = None
    ell_fwd_w: Optional[torch.Tensor] = None
    ell_bwd_src: Optional[torch.Tensor] = None
    ell_bwd_w: Optional[torch.Tensor] = None
    num_states: int = 0  # S+1 (incl. phony, excl. padding); Sp when stacked
    num_pdfs: int = 0  # real pdfs P (phony pdf id = P)
    strategy: str = "block"
    batched: bool = False
    precision: str = "high"
    domain: str = "prob"
    block_fwd_offsets: tuple = ()
    block_bwd_offsets: tuple = ()
    # (cmax, lim): pdf p owns slots [p*cmax, (p+1)*cmax), lim = (P+1)*cmax
    pdf_group: tuple = ()
    multi_pdf: bool = False
    ov_layout: tuple = ()
    # arc offsets (dst - src) of the 'banded' strategy, sorted
    banded_offsets: tuple = ()
    # derived per-graph tensors (e.g. the kernels' operator), per device
    _cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def padded_states(self) -> int:
        return self.alpha_hat.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.alpha_hat.device

    def to(self, device) -> "CompiledFSM":
        """A copy with every tensor on ``device``."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "_cache":
                v = {}
            elif isinstance(v, (torch.Tensor, BlockOperator)):
                v = v.to(device)
            kw[f.name] = v
        return CompiledFSM(**kw)


def compile_fsm(
    fsm: FSM,
    state_pdf,
    num_pdfs: int,
    *,
    strategy: str = "auto",
    dtype=torch.float32,
    precision: str = "high",
    domain: str = "prob",
    reorder: str = "auto",
    ov_cap: int | None = None,
    device="cuda",
) -> CompiledFSM:
    """Lower a host FSM to its device representation on ``device``: the
    card by default, the CPU only when asked (``device="cpu"``).  Without a
    card a CUDA ``device`` raises.

    ``state_pdf``: int array of length ``num_states + 1`` mapping each state
    (the phony final state included, mapped to ``num_pdfs``) to a pdf id,
    or a binary ``hostsparse`` Ĉ of shape (num_states + 1, num_pdfs + 1).
    A Ĉ whose rows do not all hold one pdf compiles in general-Ĉ mode
    (``multi_pdf``, reference src/inference.jl:7-8), with the JAX package's
    rules: 'dense' or 'block' only, the probability domain only, host state
    order, the phony row on the phony pdf alone, and (P+1)·Sp ≤ 64 Mi for
    the binary Ĉᵀ; a state's emission is the sum (Viterbi: the max) over
    its pdf set, a frame's posteriors are normalised by their pdf-space
    total.  No kernel takes such a graph: it runs the plain scan on every
    device, as the JAX package runs it in XLA (``_plain_on_card``).

    ``strategy``: 'auto' (the JAX package's default: 'dense' for graphs of
    up to 4,096 states including the phony one, else 'block'), 'dense'
    (exp-shifted (Sp, Sp) operators, e.g. a WSJ-sized LF-MMI denominator),
    'block' (one large shared graph, e.g. the 2M-arc denominator) or
    'banded' (a low-bandwidth lattice whose arcs sit on at most 8 distinct
    (dst - src) offsets, e.g. a numerator: self-loop and chain bands; more
    offsets raise ``ValueError``), 'ell' (padded incoming-arc lists, for
    low and uniform in-degree) or 'segment' (the COO edge list alone, any
    sparsity); the last two run the log-space scan on every device.
    ``domain``: 'prob' (the rescaled probability-domain scans) or 'log'
    (the log-space scan of any strategy, the reference's log semiring,
    run on every device as the JAX package runs it, outside any kernel);
    the compiled arrays are the same in both.
    ``reorder`` ('block' only, as in the JAX package): 'pdf' renumbers
    states into a uniform pdf-grouped layout (pdf p owns slots
    [p*cmax, (p+1)*cmax)); 'auto' does so when the padding inflation is
    acceptable; 'none' keeps the host order.
    ``ov_cap`` ('block' only): cap on the per-pdf slot count of the
    reordered layout.  When some pdf owns more states than the cap (a
    *separate-state* backoff LM ∘ HMM graph, where pdf (b, k) is shared by
    the V histories (·, b) and the backoff state B(b)), the states beyond
    the first ``cap`` of each pdf move, in host order, to an overflow region
    of cap-wide lane-groups with per-lane pdfs (``ov_layout = (cap, nOv)``),
    and their arcs compile into overflow families (ops/blocked.py).  The
    default (None) caps at 128 whenever the largest pdf owns more than 128
    states and not a multiple of 128.
    ``dtype``: float32 or float64, the dtype of every float array (the
    one-hot Ĉᵀ stays float32, as in the JAX package).  A float64 graph
    takes float64 log-likelihoods and computes in float64 end to end: on
    the card a 'block' graph through the float64 instantiation of K2-K4,
    a 'dense' one through K6a/K6b's, a stack of 'banded' graphs through
    K5a/K5b's, and its decode through K7's, K7n's, K6t's and W2's.
    ``precision``: 'high' and 'f32' both mean full float32; 'bf16' (the
    mixed-precision scan) runs the tier product of 'block' graphs and the
    operator product of 'dense' graphs on bf16 operands with float32 sums,
    everything else in float32.  The compiled arrays are the same in every
    mode, as in the JAX package, which casts at the call.

    Not ported yet (raises ``NotImplementedError``): precision 'bf16' with
    float64.
    """
    device = _target_device(device)
    S1 = len(fsm.alpha_hat)
    C_multi = None
    if isinstance(state_pdf, hs.SpMat):
        counts = np.diff(state_pdf.indptr)
        if (counts == 1).all():
            state_pdf = state_pdf.indices
        else:
            # general Ĉ (reference src/inference.jl:7-8): the emissions
            # and the posterior reduction run through the binary Ĉᵀ
            C_multi = state_pdf
            if C_multi.shape != (S1, num_pdfs + 1):
                raise ValueError(
                    f"general Ĉ must have shape ({S1}, {num_pdfs + 1})")
            # a representative pdf per state (empty rows -> phony pdf);
            # the scans read the binary Ĉᵀ instead
            rep = np.full(S1, num_pdfs, dtype=np.int32)
            nz = counts > 0
            rep[nz] = C_multi.indices[C_multi.indptr[:-1][nz]]
            state_pdf = rep
    state_pdf = np.asarray(state_pdf, dtype=np.int32)
    if state_pdf.shape != (S1,):
        raise ValueError(f"state_pdf must have shape ({S1},)")
    if strategy == "auto":
        strategy = "dense" if S1 <= 4096 else "block"
    if C_multi is not None:
        if strategy not in ("dense", "block"):
            raise ValueError(
                "general Ĉ requires the 'dense' or 'block' strategy")
        if domain != "prob":
            raise ValueError("general Ĉ requires domain='prob'")
        reorder = "none"  # the pdf-grouped layout assumes one pdf per state
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    if domain not in _DOMAINS:
        raise ValueError(f"unknown domain {domain!r}")
    if dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"dtype {dtype} ({_MODES_TODO})")
    if precision not in ("high", "f32", "bf16"):
        raise NotImplementedError(
            f"precision {precision!r}: the ported precisions are 'high', "
            "'f32' and 'bf16' (ROADMAP queue 1 item 9)")
    if precision == "bf16" and dtype == torch.float64:
        raise NotImplementedError(f"precision 'bf16' with dtype float64 "
                                  f"({_MODES_TODO})")
    if reorder not in ("auto", "pdf", "none"):
        raise ValueError(f"unknown reorder mode {reorder!r}")

    rows, cols, data = hs.findnz(fsm.T_hat)
    E = len(rows)
    alpha_in = np.asarray(fsm.alpha_hat, dtype=np.float64)

    # --- optional uniform pdf-grouped relabeling --------------------------
    pdf_group = ()
    ov_layout = ()
    ov_region = None
    orig = None
    if reorder != "none" and strategy == "block":
        P1 = num_pdfs + 1
        counts = np.bincount(state_pdf[: S1 - 1], minlength=P1)
        cmax = max(int(counts.max()), 1)
        cap = ov_cap
        if cap is None and cmax > 128 and cmax % 128:
            # exactly 128: the padded tail is 128 slots and the kernels'
            # plan needs tail % cap == 0
            cap = 128
        if cap is not None and cap < cmax:
            # capped layout with an overflow region (see ``ov_cap``)
            order = np.argsort(state_pdf[: S1 - 1], kind="stable")
            grp = state_pdf[: S1 - 1][order].astype(np.int64)
            pos = np.arange(S1 - 1) - np.searchsorted(grp, grp)
            uni = (pos < cap) & (grp < num_pdfs)
            n_over = int((~uni).sum())
            nOv = -(-n_over // cap)
            lim_u = num_pdfs * cap
            fin_ov = lim_u + nOv * cap
            ov_ok = fin_ov + 1 <= max(
                int(1.5 * _round_up(S1, 128)), _round_up(S1, 128) + 128
            )
            if ov_ok and nOv > 0:
                perm = np.empty(S1, dtype=np.int64)
                perm[order[uni]] = grp[uni] * cap + pos[uni]
                # overflow states keep host order (it keeps the graph's
                # structural families, e.g. plane-major backoff states)
                ov_ids = np.sort(order[~uni])
                perm[ov_ids] = lim_u + np.arange(n_over)
                perm[S1 - 1] = fin_ov
                rows, cols = perm[rows], perm[cols]
                alpha_full = np.full(fin_ov + 1, -np.inf)
                alpha_full[perm] = alpha_in
                alpha_in = alpha_full
                spdf_full = np.full(fin_ov + 1, num_pdfs, dtype=np.int32)
                spdf_full[perm] = state_pdf
                state_pdf = spdf_full
                orig = np.full(fin_ov + 1, -1, dtype=np.int32)
                orig[perm] = np.arange(S1, dtype=np.int32)
                final_idx = fin_ov
                S_eff = fin_ov + 1
                ov_layout = (cap, nOv)
                ov_region = (lim_u, fin_ov, cap)
        lim = P1 * cmax
        inflation_ok = lim + 1 <= max(
            int(1.5 * _round_up(S1, 128)), _round_up(S1, 128) + 128
        )
        if not ov_layout and (reorder == "pdf" or inflation_ok):
            order = np.argsort(state_pdf[: S1 - 1], kind="stable")
            grp = state_pdf[: S1 - 1][order].astype(np.int64)
            pos = np.arange(S1 - 1) - np.searchsorted(grp, grp)
            perm = np.empty(S1, dtype=np.int64)
            perm[order] = grp * cmax + pos
            perm[S1 - 1] = num_pdfs * cmax  # phony leads its own group
            rows, cols = perm[rows], perm[cols]
            alpha_full = np.full(lim, -np.inf)
            alpha_full[perm] = alpha_in
            alpha_in = alpha_full
            state_pdf = np.repeat(np.arange(P1, dtype=np.int32), cmax)
            orig = np.full(lim, -1, dtype=np.int32)
            orig[perm] = np.arange(S1, dtype=np.int32)
            final_idx = num_pdfs * cmax
            S_eff = lim
            pdf_group = (cmax, lim)
    if not pdf_group and not ov_layout:
        final_idx = S1 - 1
        S_eff = S1

    Sp = _round_up(S_eff, 128 if strategy in ("dense", "block") else 8)
    Ep = max(_round_up(E, 8), 8)

    alpha_hat = np.full(Sp, -np.inf, dtype=np.float64)
    alpha_hat[:S_eff] = alpha_in
    spdf = np.full(Sp, num_pdfs, dtype=np.int32)
    spdf[:S_eff] = state_pdf
    if orig is None:
        orig = np.full(Sp, -1, dtype=np.int32)
        orig[:S1] = np.arange(S1, dtype=np.int32)
    else:
        orig = np.concatenate([orig, np.full(Sp - S_eff, -1, dtype=np.int32)])

    def edge_arrays(gather, seg, w):
        order = np.lexsort((gather, seg))
        g = np.full(Ep, Sp - 1, dtype=np.int32)
        s = np.full(Ep, Sp - 1, dtype=np.int32)
        ww = np.full(Ep, -np.inf, dtype=np.float64)
        g[:E] = gather[order]
        s[:E] = seg[order]
        ww[:E] = w[order]
        return g, s, ww

    fwd_src, fwd_dst, fwd_w = edge_arrays(rows, cols, data)
    bwd_src, bwd_dst, bwd_w = edge_arrays(cols, rows, data)

    # one-hot Ĉᵀ (float32 in every dtype, as in the JAX package) for the
    # posterior reduction when the layout is not pdf-grouped (with it, the
    # reduction is a reshape-sum); with a general Ĉ it is the binary Ĉᵀ,
    # several ones per column, through which the emissions run too
    pdf_onehot = None
    if not pdf_group and Sp * (num_pdfs + 1) <= 64 * 1024 * 1024:
        oh = np.zeros((num_pdfs + 1, Sp), dtype=np.float32)
        oh[spdf, np.arange(Sp)] = 1.0
        if C_multi is not None:
            fin_cols = C_multi.indices[
                C_multi.indptr[S1 - 1]:C_multi.indptr[S1]]
            if len(fin_cols) != 1 or fin_cols[0] != num_pdfs:
                raise ValueError("Ĉ phony row must map to the phony pdf")
            oh[:, :S1] = 0.0
            scol = np.repeat(np.arange(S1), np.diff(C_multi.indptr))
            oh[C_multi.indices, scol] = 1.0
        pdf_onehot = torch.from_numpy(oh)
    elif C_multi is not None:
        raise ValueError(
            "general Ĉ needs the one-hot reduction matrix; "
            f"(P+1)·Sp = {(num_pdfs + 1) * Sp} exceeds the size limit")

    # rank-1 split: arcs into the phony final state (the ω column of the
    # extended matrix) are handled analytically, so the block operators
    # stay scatter-free on the S×S core and the bands cover the core only
    to_fin = cols == final_idx
    om = np.zeros(Sp, dtype=np.float64)
    np.add.at(om, rows[to_fin], np.exp(data[to_fin]))
    crows, ccols, cdata = rows[~to_fin], cols[~to_fin], data[~to_fin]
    # every float array in ``dtype``, rounded once from float64
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    fl = lambda x: torch.from_numpy(np.asarray(x, dtype=np_dtype))
    kw = dict(block_fwd=None, block_bwd=None, banded_fwd=None,
              banded_bwd=None, block_fwd_offsets=(), block_bwd_offsets=(),
              banded_offsets=(), omega_prob=fl(om))
    if strategy in ("ell", "segment"):
        kw["omega_prob"] = None  # no rank-1 split: the scan reads the edges
    if strategy == "ell":

        def ell(gather, seg, w):
            """Padded incoming-arc lists: edges sorted by segment (stable),
            each edge's slot its rank within the segment."""
            D = max(int(np.bincount(seg, minlength=S1).max()) if E else 0, 1)
            es = np.zeros((Sp, D), dtype=np.int32)
            ew = np.full((Sp, D), -np.inf, dtype=np.float64)
            if E:
                order = np.argsort(seg, kind="stable")
                segs = seg[order]
                slot = np.arange(E) - np.searchsorted(segs, segs)
                es[segs, slot] = gather[order]
                ew[segs, slot] = w[order]
            return torch.from_numpy(es), fl(ew)

        kw["ell_fwd_src"], kw["ell_fwd_w"] = ell(rows, cols, data)
        kw["ell_bwd_src"], kw["ell_bwd_w"] = ell(cols, rows, data)
    elif strategy == "dense":
        # the whole extended matrix, ω column included (no rank-1 split)
        kw["omega_prob"] = None
        for name, dst, src in (("fwd", cols, rows), ("bwd", rows, cols)):
            W = np.full((Sp, Sp), -np.inf, dtype=np_dtype)
            W[dst, src] = data  # fwd: W[j, i] = T̂[i, j]
            exp_w, row_max = sops.make_dense_operator(
                torch.from_numpy(W))
            kw[f"dense_{name}_exp"], kw[f"dense_{name}_max"] = exp_w, row_max
    elif strategy == "block":
        if len(np.unique(rows[to_fin])) != int(to_fin.sum()):
            raise ValueError(
                "parallel arcs into the final state would break the "
                "tropical reuse of omega_prob"
            )
        kw["block_fwd"], kw["block_fwd_offsets"] = build_block_operator(
            crows, ccols, cdata, Sp, dtype=np_dtype, ov_region=ov_region)
        kw["block_bwd"], kw["block_bwd_offsets"] = build_block_operator(
            ccols, crows, cdata, Sp, dtype=np_dtype, ov_region=ov_region)
    elif strategy == "banded":
        # every core arc on one of <= 8 shared offsets (the JAX package's
        # banded branch has no parallel-arc check; neither has this one)
        offs = np.unique(ccols - crows) if len(crows) else np.zeros(0, int)
        if len(offs) > 8:
            raise ValueError(
                f"'banded' strategy: {len(offs)} distinct arc offsets "
                "(> 8) — this graph is not a low-bandwidth lattice; use "
                "'dense' or 'block'"
            )
        bf = np.zeros((max(len(offs), 1), Sp), dtype=np.float64)
        bb = np.zeros_like(bf)
        for oi, off in enumerate(offs):
            sel = (ccols - crows) == off
            bf[oi, ccols[sel]] = np.exp(cdata[sel])
            bb[oi, crows[sel]] = np.exp(cdata[sel])
        kw["banded_fwd"], kw["banded_bwd"] = fl(bf), fl(bb)
        kw["banded_offsets"] = tuple(int(o) for o in offs)

    cf = CompiledFSM(
        alpha_hat=fl(alpha_hat),
        final_state=int(final_idx),
        state_pdf=torch.from_numpy(spdf),
        fwd_src=torch.from_numpy(fwd_src),
        fwd_dst=torch.from_numpy(fwd_dst),
        fwd_w=fl(fwd_w),
        bwd_src=torch.from_numpy(bwd_src),
        bwd_dst=torch.from_numpy(bwd_dst),
        bwd_w=fl(bwd_w),
        pdf_onehot=pdf_onehot,
        orig_state=torch.from_numpy(orig),
        num_states=S1,
        num_pdfs=int(num_pdfs),
        strategy=strategy,
        precision=precision,
        domain=domain,
        pdf_group=pdf_group,
        multi_pdf=C_multi is not None,
        ov_layout=ov_layout,
        **kw,
    )
    return cf if device.type == "cpu" else cf.to(device)


def _target_device(device) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device without a
    card (the compiled graph never stays on the CPU unasked)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"compile to {device}: no CUDA card is available (pass "
            "device='cpu' to compile for the CPU)")
    return device


def compiled_from_numpy(fields: dict, meta: dict, *,
                        device="cuda") -> CompiledFSM:
    """Build a CompiledFSM from another representation's arrays: ``fields``
    maps each data field name to numpy arrays (``block_fwd`` / ``block_bwd``
    to None or any object with BlockOperator's attributes holding numpy
    arrays; ``final_state`` to a scalar, or a (G,) array for a stacked
    graph), ``meta`` maps the metadata field names to their values.  Lets
    both packages run the identical operator.  The graph lands on
    ``device``: the card by default, the CPU only when asked."""
    device = _target_device(device)
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))

    def op(o):
        if o is None:
            return None
        return BlockOperator(
            band_w=t(o.band_w),
            tiers=tuple(tuple(t(x) for x in tier) for tier in o.tiers),
            res_src=t(o.res_src),
            res_dst=t(o.res_dst),
            res_w=t(o.res_w),
            ov_w=tuple(t(w) for w in getattr(o, "ov_w", ())),
        )

    def plain(v):
        """Metadata as plain Python (numpy ints -> int, lists -> tuples)."""
        if isinstance(v, (list, tuple)):
            return tuple(plain(x) for x in v)
        if isinstance(v, np.integer):
            return int(v)
        return v

    names = [f.name for f in dataclasses.fields(CompiledFSM)]
    kw = {}
    for name in ("alpha_hat", "state_pdf", "fwd_src", "fwd_dst", "fwd_w",
                 "bwd_src", "bwd_dst", "bwd_w", "pdf_onehot", "omega_prob",
                 "orig_state", "banded_fwd", "banded_bwd", "dense_fwd_exp",
                 "dense_fwd_max", "dense_bwd_exp", "dense_bwd_max",
                 "ell_fwd_src", "ell_fwd_w", "ell_bwd_src", "ell_bwd_w"):
        kw[name] = t(fields.get(name))
    fin = np.asarray(fields["final_state"])
    kw["final_state"] = int(fin) if fin.ndim == 0 else t(fin)
    kw["block_fwd"] = op(fields.get("block_fwd"))
    kw["block_bwd"] = op(fields.get("block_bwd"))
    for name, v in meta.items():
        if name in names:
            kw[name] = plain(v)
    cf = CompiledFSM(**kw)
    if cf.strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {cf.strategy!r}")
    if cf.domain not in _DOMAINS:
        raise ValueError(f"unknown domain {cf.domain!r}")
    if cf.alpha_hat.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"dtype {cf.alpha_hat.dtype} "
                                  f"({_MODES_TODO})")
    if cf.precision == "bf16" and cf.alpha_hat.dtype == torch.float64:
        raise NotImplementedError(f"precision 'bf16' with dtype float64 "
                                  f"({_MODES_TODO})")
    return cf if device.type == "cpu" else cf.to(device)


def stack(cfsms) -> CompiledFSM:
    """Stack unbatched CompiledFSMs of one strategy into one batched graph
    (reference ``batch``, src/inference.jl:28-36): every tensor gains a
    leading graph axis, padded to the largest graph (initial weights -inf,
    state pdfs to the phony pdf, padding edges to weight -inf inside each
    graph's own state range, orig_state -1, one-hot columns 0).  'banded':
    ω is padded with 0 and the band offsets become the union of the graphs'
    offsets with zero bands where a graph lacks one.  'dense': each (Sp, Sp)
    operator is padded with 0 and each row max with -inf.  'ell': the
    incoming-arc lists are padded to the largest in-degree (source 0,
    weight -inf), then to the largest state count.  Run one sequence per
    graph (B = G) through ``pdfposteriors``.  The stack lies on its inputs'
    device, keeps their dtype (all float32 or all float64) and takes the
    first graph's precision and domain; it is in general-Ĉ mode when any of
    its graphs is.

    'block' raises ``ValueError`` as in the JAX package (the blocked scans
    share one large graph across the batch)."""
    cfsms = list(cfsms)
    if any(c.batched for c in cfsms):
        raise ValueError("can only stack unbatched CompiledFSMs")
    strategy = cfsms[0].strategy
    num_pdfs = cfsms[0].num_pdfs
    if any(c.strategy != strategy or c.num_pdfs != num_pdfs for c in cfsms):
        raise ValueError("stack requires matching strategy and num_pdfs")
    if strategy == "block":
        raise ValueError("stack does not support the 'block' strategy")

    Sp = max(c.padded_states for c in cfsms)
    Ep = max(c.fwd_src.shape[-1] for c in cfsms)

    def fstack(name, size, fill, dims=1):
        """Stack field ``name``, its last ``dims`` axes padded to size."""
        rows = []
        for c in cfsms:
            x = getattr(c, name)
            rows.append(torch.nn.functional.pad(
                x, (0, size - x.shape[-1]) * dims, value=fill))
        return torch.stack(rows)

    kw = dict(banded_fwd=None, banded_bwd=None, omega_prob=None,
              banded_offsets=())
    if strategy == "banded":
        offsets = tuple(sorted({o for c in cfsms for o in c.banded_offsets}))
        if len(offsets) > 8:
            raise ValueError(
                f"stack: union of banded offsets has {len(offsets)} entries "
                "(> 8)")

        def bands(name):
            out = torch.zeros((len(cfsms), max(len(offsets), 1), Sp),
                              dtype=getattr(cfsms[0], name).dtype,
                              device=cfsms[0].device)
            for g, c in enumerate(cfsms):
                src = getattr(c, name)
                for i, o in enumerate(offsets):
                    if o in c.banded_offsets:
                        j = c.banded_offsets.index(o)
                        out[g, i, : src.shape[1]] = src[j]
            return out

        kw.update(banded_fwd=bands("banded_fwd"),
                  banded_bwd=bands("banded_bwd"),
                  omega_prob=fstack("omega_prob", Sp, 0.0),
                  banded_offsets=offsets)
    elif strategy == "dense":
        for d in ("fwd", "bwd"):
            kw[f"dense_{d}_exp"] = fstack(f"dense_{d}_exp", Sp, 0.0, 2)
            kw[f"dense_{d}_max"] = fstack(f"dense_{d}_max", Sp,
                                          -float("inf"))
    elif strategy == "ell":
        pad = torch.nn.functional.pad
        for d in ("fwd", "bwd"):
            D = max(getattr(c, f"ell_{d}_src").shape[-1] for c in cfsms)
            for name, fill in (("src", 0), ("w", -float("inf"))):
                kw[f"ell_{d}_{name}"] = torch.stack([
                    pad(x, (0, D - x.shape[1], 0, Sp - x.shape[0]),
                        value=fill)
                    for x in (getattr(c, f"ell_{d}_{name}") for c in cfsms)])

    onehot = None
    if all(c.pdf_onehot is not None for c in cfsms):
        onehot = fstack("pdf_onehot", Sp, 0.0)
    return CompiledFSM(
        alpha_hat=fstack("alpha_hat", Sp, -float("inf")),
        final_state=torch.tensor([c.final_state for c in cfsms],
                                 dtype=torch.int32, device=cfsms[0].device),
        state_pdf=fstack("state_pdf", Sp, num_pdfs),
        fwd_src=fstack("fwd_src", Ep, 0),
        fwd_dst=fstack("fwd_dst", Ep, Sp - 1),
        fwd_w=fstack("fwd_w", Ep, -float("inf")),
        bwd_src=fstack("bwd_src", Ep, 0),
        bwd_dst=fstack("bwd_dst", Ep, Sp - 1),
        bwd_w=fstack("bwd_w", Ep, -float("inf")),
        pdf_onehot=onehot,
        block_fwd=None,
        block_bwd=None,
        orig_state=fstack("orig_state", Sp, -1),
        num_states=Sp,
        num_pdfs=num_pdfs,
        strategy=strategy,
        batched=True,
        precision=cfsms[0].precision,
        domain=cfsms[0].domain,
        # the JAX package's stack drops the flag, and its per-graph scan
        # then reads the representative pdfs; the port keeps it
        multi_pdf=any(c.multi_pdf for c in cfsms),
        **kw,
    )


batch = stack  # the reference's name (src/inference.jl exports ``batch``)


# ---------------------------------------------------------------------------
# plain probability-domain scan (the CPU path)
# ---------------------------------------------------------------------------

# Cody-Waite split of ln 2: LN2_HI has 9 mantissa bits, so k·LN2_HI is
# exact in float32 for integer |k| < 2^15; k·LN2_LO carries the rest, the
# float32 one (as the JAX package's) or, in float64, the float64 one (the
# float32 rounding of LN2_LO, 1.6e-12, would cost ~3e-9 in logZ at N=700)
_LN2_HI = float(np.float32(0.693359375))
_LN2_LO = float(np.float32(np.log(2.0) - 0.693359375))
_LN2_LO64 = float(np.log(2.0) - 0.693359375)


def _combine_shift(logv, ksum, shift):
    """logZ = logv + ksum·ln2 + shift with the ksum·ln2 product split so the
    dominant term is exact (ksum is an exactly-accumulated integer)."""
    hi = torch.tensor(_LN2_HI, dtype=logv.dtype, device=logv.device)
    lo = torch.tensor(_LN2_LO64 if logv.dtype == torch.float64 else _LN2_LO,
                      dtype=logv.dtype, device=logv.device)
    return ((logv + ksum * lo) + shift) + ksum * hi


def _combine_f64(vfin, ksum, shift, dtype):
    """logZ of the CUDA routes: log v + ksum·ln2 + shift combined in
    float64 and returned in ``dtype``.  Over 700 frames ksum·ln2 and the
    shift pass 1,024, where one float32 rounding of their sum is 1.2e-4."""
    return _combine_shift(_log_final(vfin.double(), vfin.dtype),
                          ksum.double(), shift.double()).to(dtype)


def _kahan_add(s, c, x):
    """Compensated accumulation: returns updated (sum, compensation)."""
    y = x - c
    t = s + y
    return t, (t - s) - y


def _log_final(v, dtype=None):
    """log v where v > 0, else -inf.  The clamp inside the log keeps its
    unused branch finite, by the dtype v was computed in (``dtype``,
    default v's): 1e-38 for float32 (the JAX package's), the smallest
    normal float64 for float64, so a float64 final value far below 1e-38
    keeps its log."""
    tiny = (torch.finfo(torch.float64).tiny
            if (dtype or v.dtype) == torch.float64 else 1e-38)
    return torch.where(v > 0, torch.log(torch.clamp(v, min=tiny)),
                       torch.full_like(v, -float("inf")))


def _make_eprob(cf: CompiledFSM, lengths, dtype):
    """(lhs_t (B, P), t) -> (e (Sp, B) in [0, 1], m_l (B,) log-shift) in
    the scan's ``dtype``.  A general Ĉ's state sums its pdf set: Ĉᵀ·ext,
    where padding and phony columns carry the phony pdf (the JAX
    package's ``_make_eprob``, ``inference.py:939-948``), in ``dtype``."""
    Sp = cf.padded_states
    is_ph = torch.zeros((Sp, 1), dtype=dtype, device=cf.device)
    is_ph[cf.final_state] = 1.0
    oh_t = cf.pdf_onehot.T.to(dtype).contiguous() if cf.multi_pdf else None

    def eprob(lhs_t, t):
        active = t < lengths  # (B,)
        m_l = lhs_t.amax(dim=1)
        el = torch.exp(lhs_t - m_l[:, None])
        ph = (~active).to(lhs_t.dtype)[None, :]
        ext = torch.cat([el.T * active[None, :], ph], dim=0)  # (P1, B)
        if cf.multi_pdf:
            x = oh_t @ ext
        elif cf.pdf_group:
            cmax, lim = cf.pdf_group
            x = ext.repeat_interleave(cmax, dim=0)
            x = torch.nn.functional.pad(x, (0, 0, 0, Sp - lim))
        else:
            x = ext[cf.state_pdf.long()]
            x = torch.where(active[None, :], x, is_ph)
        return x, torch.where(active, m_l, torch.zeros_like(m_l))

    return eprob


def _dense_bf16_operator(exp_w, row_max):
    """The operand the K6 kernels multiply for a bf16 'dense' graph: the
    probability operator exp(row_max) ⊙ exp_w (ops/dense_scan.py
    ``kernel_operator``), rounded to bf16.  (The JAX XLA route rounds
    exp_w alone on a TPU and nothing on the CPU, where DEFAULT precision
    is float32; the port rounds what its kernels round.)"""
    return round_bf16(torch.exp(row_max)[..., None] * exp_w)


def _make_prob_matvecs(cf: CompiledFSM):
    """Probability-domain matvecs of one (unstacked) graph: 'dense' as the
    JAX package's XLA path computes it, y = exp(row_max) ⊙ (exp_w @ a), or
    for a bf16 graph the product of the K6 kernels' bf16 operands;
    'banded' and 'block' with the rank-1 ω column: y[fin] = ω·a forward
    (ω[fin] = 1 covers the phony self-loop), y += ω ⊙ a[fin] backward, the
    'block' tier on bf16 operands for a bf16 graph."""
    bf16 = cf.precision == "bf16"
    if cf.strategy == "dense" and bf16:
        wf = _dense_bf16_operator(cf.dense_fwd_exp, cf.dense_fwd_max)
        wb = _dense_bf16_operator(cf.dense_bwd_exp, cf.dense_bwd_max)
        return (lambda a: wf @ round_bf16(a), lambda b: wb @ round_bf16(b))
    if cf.strategy == "dense":
        scale_f = torch.exp(cf.dense_fwd_max)[:, None]  # -inf rows -> 0
        scale_b = torch.exp(cf.dense_bwd_max)[:, None]
        return (lambda a: scale_f * (cf.dense_fwd_exp @ a),
                lambda b: scale_b * (cf.dense_bwd_exp @ b))
    if cf.strategy == "banded":
        kop = banded_scan.kernel_operator(cf)  # G = 1: shared by all columns
        return (lambda a: banded_scan.fwd_matvec_plain(kop, a),
                lambda b: banded_scan.bwd_matvec_plain(kop, b))
    fin = cf.final_state
    gf = family_grids(cf.block_fwd, cf.block_fwd_offsets, cf.device)
    gb = family_grids(cf.block_bwd, cf.block_bwd_offsets, cf.device)

    def fwd(a):
        y = block_matvec(cf.block_fwd, cf.block_fwd_offsets, a, bf16=bf16,
                         grids=gf)
        y[fin] = cf.omega_prob @ a
        return y

    def bwd(a):
        y = block_matvec(cf.block_bwd, cf.block_bwd_offsets, a, bf16=bf16,
                         grids=gb)
        return y + cf.omega_prob[:, None] * a[fin][None, :]

    return fwd, bwd


@dataclasses.dataclass
class _ProbKernels:
    """Pluggable pieces of the probability-domain forward-backward scan
    (the JAX package's ``_ProbKernels``): one skeleton, ``_fbp_run``, runs
    a single graph shared by the batch and a stack of graphs, one column
    each."""

    alpha0: torch.Tensor  # (Sp,) shared or (Sp, B) per-column probabilities
    fwd_pmv: callable  # (Sp, B) -> (Sp, B) probability matvec T̂ᵀ
    bwd_pmv: callable  # (Sp, B) -> (Sp, B) probability matvec T̂
    eprob: callable  # (lhs_t (B, P), t) -> (e (Sp, B), m_l (B,))
    # (alpha_t, beta_t) (Sp, B) -> (s (P+1, B), tot (B,)): the pdf sums of
    # gamma = alpha_t ⊙ beta_t and its total
    pdf_reduce: callable
    final_val: callable  # (a, ksum, shift) -> (B,) logZ


def _fbp_run(kern: _ProbKernels, lhs, chunk_size, want_posts, num_pdfs,
             dtype=None):
    """Chunk-checkpointed probability-domain scan over a kernel bundle: the
    state is carried as max-normalised probabilities with an exact
    power-of-two exponent sum and a Kahan-compensated emission shift, per
    frame, in ``dtype`` (default: lhs's).  lhs: (B, N, P); returns
    (posts (B, N, P) or None, logZ (B,)) in lhs's dtype."""
    out_dtype = lhs.dtype
    if dtype is not None:
        lhs = lhs.to(dtype)
    B, N, P = lhs.shape
    P1 = num_pdfs + 1
    Sl = kern.alpha0.shape[0]
    Nf = N + 1
    K = min(chunk_size, Nf)
    C = -(-Nf // K)
    Npad = C * K
    lhs_tm = torch.nn.functional.pad(lhs.permute(1, 0, 2),
                                     (0, 0, 0, 0, 0, Npad - N))

    def fstep(carry, t):
        a, ksum, shift, comp = carry
        p = a if t == 0 else kern.fwd_pmv(a)
        e, m_l = kern.eprob(lhs_tm[t], t)
        y = p * e
        k = _pow2_exponent(y.amax(dim=0))
        shift, comp = _kahan_add(shift, comp, m_l)
        return y * _pow2_scale(k)[None, :], ksum + k, shift, comp

    def bstep(bb, a_t, t):
        y = torch.ones_like(bb) if t == Npad - 1 else kern.bwd_pmv(bb)
        y = y * _pow2_scale(_pow2_exponent(y.amax(dim=0)))[None, :]
        s, tot = kern.pdf_reduce(a_t, y)
        posts_t = s / torch.where(tot > 0, tot, torch.ones_like(tot))[None, :]
        e, _ = kern.eprob(lhs_tm[t], t)
        return y * e, posts_t

    zeros = lhs.new_zeros(B)
    a0 = kern.alpha0 if kern.alpha0.dim() == 2 else kern.alpha0[:, None]
    carry = (a0.expand(Sl, B).to(lhs.dtype), zeros, zeros, zeros)
    bounds = []
    for t in range(Npad):
        if t % K == 0:
            bounds.append(carry)
        carry = fstep(carry, t)
    aF, kF, shiftF, _ = carry
    logZ = kern.final_val(aF, kF, shiftF).to(out_dtype)
    if not want_posts:
        return None, logZ
    posts = lhs.new_empty((Npad, P1, B), dtype=out_dtype)
    bb = torch.ones((Sl, B), dtype=lhs.dtype, device=lhs.device)
    for c in reversed(range(C)):
        carry = bounds[c]
        alphas = []
        for t in range(c * K, (c + 1) * K):
            carry = fstep(carry, t)
            alphas.append(carry[0])
        for j in reversed(range(K)):
            bb, posts[c * K + j] = bstep(bb, alphas[j], c * K + j)
    return posts.permute(2, 0, 1)[:, :N, :P], logZ


# float64 state for 'banded' lattices: alpha and beta, each normalised to
# max 1, sit at opposite ends of a long lattice (ops/banded_scan.py)
_STATE_DTYPE = {"banded": torch.float64}


def _fb_prob(cf: CompiledFSM, lhs, lengths, chunk_size, want_posts):
    """Plain probability-domain scan of one graph shared by the batch, its
    state in lhs's dtype (float64 for a 'banded' graph): the graph's, or
    float64 log-likelihoods on a float32 graph."""
    B = lhs.shape[0]
    P1 = cf.num_pdfs + 1
    dtype = _STATE_DTYPE.get(cf.strategy, lhs.dtype)
    fwd_pmv, bwd_pmv = _make_prob_matvecs(cf)
    onehot = (None if cf.pdf_onehot is None
              else cf.pdf_onehot.to(dtype).contiguous())

    def pdf_reduce(a, y):
        gamma = a * y
        if cf.pdf_group:
            cmax, lim = cf.pdf_group
            s = gamma[:lim].reshape(P1, cmax, B).sum(dim=1)
            return s, s.sum(dim=0)
        if onehot is not None:
            s = onehot @ gamma
            # a general Ĉ's state adds to several pdfs: the frame's total
            # is the pdf-space sum (JAX ``inference.py:996-998``)
            return s, (s if cf.multi_pdf else gamma).sum(dim=0)
        s = gamma.new_zeros((P1, B)).index_add_(0, cf.state_pdf.long(), gamma)
        return s, gamma.sum(dim=0)

    kern = _ProbKernels(
        alpha0=torch.exp(cf.alpha_hat),
        fwd_pmv=fwd_pmv,
        bwd_pmv=bwd_pmv,
        eprob=_make_eprob(cf, lengths, dtype),
        pdf_reduce=pdf_reduce,
        final_val=lambda a, ksum, shift: _combine_shift(
            _log_final(a[cf.final_state]), ksum, shift),
    )
    return _fbp_run(kern, lhs, chunk_size, want_posts, cf.num_pdfs, dtype)


def _make_stacked_eprob(spdf, lengths):
    """(lhs_t (G, P), t) -> (e (Sp, G), m_l (G,)) for stacked graphs, one
    sequence per graph: a per-column gather by each graph's state pdfs
    ``spdf`` (Sp, G).  Past a sequence's end only the phony pdf emits: the
    phony state and the padding states, whose probability is always 0."""

    def eprob(lhs_t, t):
        active = t < lengths  # (G,)
        m_l = lhs_t.amax(dim=1)
        el = torch.exp(lhs_t - m_l[:, None])
        ph = (~active).to(lhs_t.dtype)[None, :]
        ext = torch.cat([el.T * active[None, :], ph], dim=0)  # (P1, G)
        return (ext.gather(0, spdf),
                torch.where(active, m_l, torch.zeros_like(m_l)))

    return eprob


def _fb_prob_banded_stacked(cf: CompiledFSM, lhs, lengths, chunk_size,
                            want_posts):
    """Plain scan of stacked 'banded' graphs, one sequence per graph: the
    graph axis is the column axis of the (Sp, G) state.  Per-graph bands,
    ω, α and final state ride the columns (the kernels' operator layout),
    emissions are a per-column gather of each graph's state pdfs, and the
    pdf reduction a per-column scatter-add.  The state is float64, as in
    the kernels (ops/banded_scan.py)."""
    kop = banded_scan.kernel_operator(cf)
    spdf = kop.spdf.long()
    P1 = kop.P1

    def pdf_reduce(a, y):
        gamma = a * y
        s = gamma.new_zeros((P1, gamma.shape[1])).scatter_add_(0, spdf, gamma)
        return s, gamma.sum(dim=0)

    def final_val(a, ksum, shift):
        v = a.gather(0, kop.fin.long()[None, :])[0]
        return _combine_shift(_log_final(v), ksum, shift)

    kern = _ProbKernels(
        alpha0=kop.a0,
        fwd_pmv=lambda a: banded_scan.fwd_matvec_plain(kop, a),
        bwd_pmv=lambda b: banded_scan.bwd_matvec_plain(kop, b),
        eprob=_make_stacked_eprob(spdf, lengths),
        pdf_reduce=pdf_reduce,
        final_val=final_val,
    )
    return _fbp_run(kern, lhs, chunk_size, want_posts, cf.num_pdfs,
                    _STATE_DTYPE["banded"])


def _fb_prob_dense_stacked(cf: CompiledFSM, lhs, lengths, chunk_size,
                           want_posts):
    """The per-graph route of stacked 'dense' graphs, one sequence per
    graph: the JAX package vmaps its plain scan over the graphs
    (``inference.py:1580-1588``); here the graph axis is the column axis of
    the (Sp, G) state and each column is multiplied by its own graph's
    operator (one batched matmul per frame).  Emissions are a per-column
    gather of each graph's state pdfs, the pdf reduction a per-graph
    one-hot product (every 'dense' graph carries its one-hot Ĉᵀ; in
    general-Ĉ mode the emissions are each graph's Ĉᵀ·ext and a frame's
    total its pdf-space sum).  Stacked bf16 graphs multiply the bf16
    operands of the K6 kernels, as one such graph does on the plain
    path."""
    fin = torch.as_tensor(cf.final_state, device=cf.device).long()
    onehot = cf.pdf_onehot.to(lhs.dtype)  # (G, P1, Sp)

    def pmv(expw, row_max):
        if cf.precision == "bf16":
            w = _dense_bf16_operator(expw, row_max)
            return lambda a: torch.bmm(
                w, round_bf16(a).T[:, :, None])[:, :, 0].T
        scale = torch.exp(row_max).T  # (Sp, G); -inf rows -> 0
        # column g: scale[:, g] ⊙ (expw[g] @ a[:, g])
        return lambda a: scale * torch.bmm(expw, a.T[:, :, None])[:, :, 0].T

    def pdf_reduce(a, y):
        gamma = a * y
        s = torch.bmm(onehot, gamma.T[:, :, None])[:, :, 0].T
        return s, (s if cf.multi_pdf else gamma).sum(dim=0)

    def final_val(a, ksum, shift):
        v = a.gather(0, fin[None, :])[0]
        return _combine_shift(_log_final(v), ksum, shift)

    eprob = _make_stacked_eprob(cf.state_pdf.long().T, lengths)
    if cf.multi_pdf:
        oh_t = onehot.transpose(1, 2).contiguous()  # (G, Sp, P1)

        def eprob(lhs_t, t):
            active = t < lengths  # (G,)
            m_l = lhs_t.amax(dim=1)
            el = torch.exp(lhs_t - m_l[:, None])
            ext = torch.cat([el.T * active[None, :],
                             (~active).to(lhs_t.dtype)[None, :]], dim=0)
            return (torch.bmm(oh_t, ext.T[:, :, None])[:, :, 0].T,
                    torch.where(active, m_l, torch.zeros_like(m_l)))

    kern = _ProbKernels(
        alpha0=torch.exp(cf.alpha_hat).T,
        fwd_pmv=pmv(cf.dense_fwd_exp, cf.dense_fwd_max),
        bwd_pmv=pmv(cf.dense_bwd_exp, cf.dense_bwd_max),
        eprob=eprob,
        pdf_reduce=pdf_reduce,
        final_val=final_val,
    )
    return _fbp_run(kern, lhs, chunk_size, want_posts, cf.num_pdfs)


# ---------------------------------------------------------------------------
# the log-space scan (the JAX package's ``_fb_run``), single or per graph
# ---------------------------------------------------------------------------

def _cached(cf: CompiledFSM, key, build):
    """A derived tensor of the graph, built once per graph object."""
    v = cf._cache.get(key)
    if v is None:
        v = cf._cache[key] = build()
    return v


def _num_graphs(cf: CompiledFSM) -> int:
    return cf.alpha_hat.shape[0] if cf.batched else 1


def _flat_matvec(mv, G, Sp, arg):
    """A stacked graph's matvec from ``mv`` of its block-diagonal union
    (one column, graph g's states at rows [g·Sp, (g+1)·Sp), indices offset
    per graph): x (Sp, G), column g graph g's state, -> (Sp, G), and with
    ``arg`` (``mv`` returns backpointers) the backpointers as local
    sources."""
    if not arg:
        return lambda x: mv(x.T.reshape(-1, 1)).reshape(G, Sp).T

    def mv_max(x):
        y, bp = mv(x.T.reshape(-1, 1))
        bp = bp.reshape(G, Sp)
        off = (torch.arange(G, dtype=torch.int32, device=bp.device)
               * Sp)[:, None]
        # an empty segment's int32 minimum stays as it is
        return y.reshape(G, Sp).T, torch.where(bp >= 0, bp - off, bp).T
    return mv_max


def _make_matvec(cf: CompiledFSM, direction: str, dtype, op="logsumexp",
                 arg=True):
    """y = T̂ᵀ ⊗ x ('fwd') or T̂ ⊗ x ('bwd') over a log-domain state (Sp, B)
    in ``dtype``: 'dense' through its exp-shifted operator, 'ell' through
    its incoming-arc lists, every other strategy through its edge arrays
    (the JAX package's ``_make_matvec``).  ``op='max'`` is the tropical
    form (the JAX package's ``_trop_matvec``: the arc lists of an 'ell'
    graph, else the edges) and returns (y, backpointer (Sp, B) int32), or
    y alone without ``arg`` (no backpointer is computed).  A stacked
    graph's column g is graph g's state."""
    Sp, G = cf.padded_states, _num_graphs(cf)
    arg = arg and op == "max"
    if op != "max" and cf.strategy == "dense":
        e = getattr(cf, f"dense_{direction}_exp").to(dtype)
        m = getattr(cf, f"dense_{direction}_max").to(dtype)
        return lambda x: sops.dense_log_matvec(e, m, x, cf.precision)
    if cf.strategy == "ell":
        src = getattr(cf, f"ell_{direction}_src").long()
        w = getattr(cf, f"ell_{direction}_w").to(dtype)
        if not cf.batched:
            return lambda x: sops.ell_matvec(src, w, x, op=op, arg=arg)
        off = torch.arange(G, device=src.device)[:, None, None] * Sp
        src = (src + off).reshape(G * Sp, -1)
        w = w.reshape(G * Sp, -1)
        return _flat_matvec(
            lambda x: sops.ell_matvec(src, w, x, op=op, arg=arg), G, Sp, arg)

    def edges():
        s, d = (getattr(cf, f"{direction}_{n}").long() for n in ("src", "dst"))
        if cf.batched:
            off = torch.arange(G, device=s.device)[:, None] * Sp
            s, d = (s + off).reshape(-1), (d + off).reshape(-1)
        return s, d, sops.segment_lengths(d, G * Sp)

    src, dst, lengths = _cached(cf, f"edges_{direction}", edges)
    w = getattr(cf, f"{direction}_w").to(dtype).reshape(-1)

    def mv(x):
        return sops.segment_matvec(src, dst, w, x, G * Sp, op=op,
                                   lengths=lengths, arg=arg)
    return _flat_matvec(mv, G, Sp, arg) if cf.batched else mv


def _make_elhs(cf: CompiledFSM, lengths, dtype, trop: bool = False):
    """(lhs_t (B, P), t) -> (Sp, B): the expanded per-frame log-likelihood
    column (reference ``expand``, src/inference.jl:38-60), a stacked
    graph's column g through graph g's state pdfs.  Past a sequence's end
    the phony state emits 0 and every other state -inf.  ``trop=True`` is
    the tropical lift: a general Ĉ's state emits the max over its pdf set.
    The log-domain sum recursions refuse a general Ĉ, as the JAX package's
    do."""
    if cf.multi_pdf and not trop:
        raise NotImplementedError(
            "log-domain recursions do not support general Ĉ; use the "
            "prob-domain pdfposteriors path")
    Sp = cf.padded_states
    fin = torch.as_tensor(cf.final_state, device=cf.device).long()
    is_phony = (torch.arange(Sp, device=cf.device)[:, None]
                == fin.reshape(1, -1))
    idle = torch.zeros(is_phony.shape, dtype=dtype, device=cf.device)
    idle[~is_phony] = -float("inf")
    spdf = cf.state_pdf.long()
    mask = cf.pdf_onehot > 0 if cf.multi_pdf else None  # ([G,] P1, Sp)

    def elhs(lhs_t, t):
        # (P1, B); the phony pdf's row -inf
        ext = torch.nn.functional.pad(lhs_t.T, (0, 0, 0, 1),
                                      value=-float("inf"))
        if mask is not None and cf.batched:
            x = torch.where(mask, ext.T[:, :, None], -float("inf")).amax(1).T
        elif mask is not None:
            x = torch.where(mask[:, :, None], ext[:, None, :],
                            -float("inf")).amax(0)
        elif cf.batched:
            x = ext.gather(0, spdf.T)
        else:
            x = ext[spdf]
        return torch.where((t < lengths)[None, :], x, idle)

    return elhs


def _colmax_safe(y):
    return sops._safe(y.amax(dim=0))


def _make_pdf_reduce(cf: CompiledFSM, dtype):
    """gamma (Sp, B) log-domain -> (P+1, B) per-frame normalised pdf
    posteriors, Ĉᵀ(α⊙β) (the JAX package's ``_pdf_reduce``): through the
    one-hot Ĉᵀ in the probability domain after a per-column shift, or
    without one (a pdf-grouped layout) a per-pdf logsumexp."""
    P1 = cf.num_pdfs + 1
    if cf.pdf_onehot is not None:
        onehot = cf.pdf_onehot.to(dtype)

        def reduce(gamma):
            g = torch.exp(gamma - _colmax_safe(gamma)[None, :])
            if cf.batched:
                s = (onehot @ g.T[:, :, None])[:, :, 0].T
            else:
                s = onehot @ g
            tot = g.sum(dim=0)
            return s / torch.where(tot > 0, tot, torch.ones_like(tot))[None]
        return reduce

    G = _num_graphs(cf)
    ids = cf.state_pdf.long().reshape(G, -1)
    ids = (ids + torch.arange(G, device=ids.device)[:, None] * P1).reshape(-1)
    order = torch.argsort(ids, stable=True)
    ids = ids[order]
    lengths = sops.segment_lengths(ids, G * P1)

    def reduce(gamma):
        if cf.batched:  # the union of the graphs' states, one column
            gpdf = sops.segment_logsumexp(
                gamma.T.reshape(-1, 1)[order], ids, G * P1, True,
                lengths).reshape(G, P1).T
        else:
            gpdf = sops.segment_logsumexp(gamma[order], ids, P1, True,
                                          lengths)
        norm = sops._safe(sops.masked_logsumexp(gpdf, dim=0))
        return torch.exp(gpdf - norm[None, :])
    return reduce


@dataclasses.dataclass
class _Kernels:
    """The pluggable pieces of the log-space scan (the JAX package's
    ``_Kernels``), over (Sp, B) log-domain states; a stacked graph's
    column g is graph g's."""

    alpha0: torch.Tensor  # (Sp, B) initial extended weights
    fwd_mv: callable  # (Sp, B) -> (Sp, B): y = T̂ᵀ ⊗ x
    bwd_mv: callable  # (Sp, B) -> (Sp, B): y = T̂ ⊗ x
    elhs: callable  # (lhs_t (B, P), t) -> (Sp, B) expanded likelihoods
    pdf_posts: callable  # gamma (Sp, B) -> (P+1, B) normalised posteriors
    final_val: callable  # (x (Sp, B), shift (B,)) -> (B,) logZ


def _alpha0(cf: CompiledFSM, dtype, B: int):
    """(Sp, B) initial log weights: the graph's in every column, or a
    stacked graph's column g graph g's."""
    a = cf.alpha_hat.T if cf.batched else cf.alpha_hat[:, None]
    return a.to(dtype).expand(cf.padded_states, B)


def _final_val(cf: CompiledFSM, B: int):
    """(x (Sp, B), shift (B,)) -> x[final, b] + shift[b], a stacked graph's
    column by its own final state."""
    fin = torch.as_tensor(cf.final_state, device=cf.device).long()
    fin = fin.expand(B)[None, :]
    return lambda x, shift: x.gather(0, fin)[0] + shift


def _make_kernels(cf: CompiledFSM, lengths, dtype, B: int) -> _Kernels:
    return _Kernels(
        alpha0=_alpha0(cf, dtype, B),
        fwd_mv=_make_matvec(cf, "fwd", dtype),
        bwd_mv=_make_matvec(cf, "bwd", dtype),
        elhs=_make_elhs(cf, lengths, dtype),
        pdf_posts=_make_pdf_reduce(cf, dtype),
        final_val=_final_val(cf, B),
    )


def _fb_run(kern: _Kernels, lhs, chunk_size, want_posts, num_pdfs):
    """The log-space forward(-backward) scan (the JAX package's
    ``_fb_run``): per frame the state is shifted by its column max, the
    shifts summed with Kahan compensation, and logZ read as x[final] +
    shift.  One chunk (``chunk_size`` >= N + 1) keeps every frame's alphas;
    else the forward keeps each chunk's first state and the backward
    recomputes a chunk's alphas from it.  lhs: (B, N, P); returns (posts
    (B, N, P) or None, logZ (B,)), in lhs's dtype."""
    B, N, P = lhs.shape
    Nf = N + 1
    K = min(chunk_size, Nf)
    C = -(-Nf // K)
    Npad = C * K
    lhs_tm = torch.nn.functional.pad(lhs.permute(1, 0, 2),
                                     (0, 0, 0, 0, 0, Npad - N))

    def fstep(carry, t):
        x, shift, comp = carry
        y = x if t == 0 else kern.fwd_mv(x)
        y = y + kern.elhs(lhs_tm[t], t)
        m = _colmax_safe(y)
        shift, comp = _kahan_add(shift, comp, m)
        return y - m[None, :], shift, comp

    def bstep(bb, a_t, t):
        y = torch.zeros_like(bb) if t == Npad - 1 else kern.bwd_mv(bb)
        y = y - _colmax_safe(y)[None, :]
        return y + kern.elhs(lhs_tm[t], t), kern.pdf_posts(a_t + y)

    zeros = lhs.new_zeros(B)
    carry = (kern.alpha0, zeros, zeros)
    bounds, alphas = [], []
    for t in range(Npad):
        if t % K == 0:
            bounds.append(carry)
        carry = fstep(carry, t)
        if C == 1 and want_posts:
            alphas.append(carry[0])
    xF, shiftF, _ = carry
    logZ = kern.final_val(xF, shiftF)
    if not want_posts:
        return None, logZ
    posts = lhs.new_empty((Npad, num_pdfs + 1, B))
    bb = torch.zeros_like(xF)
    for c in reversed(range(C)):
        if C > 1:
            carry, alphas = bounds[c], []
            for t in range(c * K, (c + 1) * K):
                carry = fstep(carry, t)
                alphas.append(carry[0])
        for j in reversed(range(K)):
            bb, posts[c * K + j] = bstep(bb, alphas[j], c * K + j)
    return posts.permute(2, 0, 1)[:, :N, :num_pdfs], logZ


def _fb_log(cf: CompiledFSM, lhs, lengths, chunk_size, want_posts):
    """The log-space scan of one graph shared by the batch, or of a stacked
    graph with one sequence per graph, in lhs's dtype."""
    kern = _make_kernels(cf, lengths, lhs.dtype, lhs.shape[0])
    return _fb_run(kern, lhs, chunk_size, want_posts, cf.num_pdfs)


# ---------------------------------------------------------------------------
# the CUDA kernels and the dispatcher
# ---------------------------------------------------------------------------

def _fb_dense_cuda(cf: CompiledFSM, lhs, lengths, want_posts):
    """The hand-written CUDA dense scan (ops/dense_scan.py): one forward
    sweep (K6a) keeping every frame's state, then one backward sweep (K6b);
    ``chunk_size`` does not apply, as on the JAX package's fused path."""
    B, N, P = lhs.shape
    ext, mshift = prepare_emissions(lhs, lengths, P, cf.alpha_hat.dtype)
    posts, vfin, shift, ksum = dense_scan.dense_fused_fb(cf, ext, mshift,
                                                         want_posts)
    logZ = _combine_f64(vfin, ksum, shift, lhs.dtype)
    if not want_posts:
        return None, logZ
    return posts.permute(2, 0, 1)[:, :N, :P], logZ


def _fb_block_cuda(cf: CompiledFSM, lhs, lengths, want_posts, chunk_size):
    """The hand-written CUDA scan (ops/block_scan.py): one forward sweep
    with chunk checkpoints, then per chunk a recompute and a backward."""
    B, N, P = lhs.shape
    ext, mshift = prepare_emissions(lhs, lengths, P, cf.alpha_hat.dtype)
    posts, vfin, shift, ksum = block_scan.block_fused_fb(
        cf, ext, mshift, want_posts, chunk=min(chunk_size, N + 1)
    )
    logZ = _combine_f64(vfin, ksum, shift, lhs.dtype)
    if not want_posts:
        return None, logZ
    return posts.permute(2, 0, 1)[:, :N, :P], logZ


def _fb_banded_cuda(cf: CompiledFSM, lhs, lengths, want_posts):
    """The hand-written CUDA stacked-banded scan (ops/banded_scan.py): one
    forward sweep (K5a) and one backward sweep (K5b), each one launch."""
    B, N, P = lhs.shape
    posts, vfin, shift, ksum = banded_scan.banded_fused_fb(cf, lhs, lengths,
                                                           want_posts)
    logZ = _combine_shift(_log_final(vfin), ksum, shift).to(lhs.dtype)
    if not want_posts:
        return None, logZ
    return posts.permute(2, 0, 1)[:, :N, :P], logZ


# per strategy: (admission, the scan's name, its fast-path report line)
_CUDA_SCANS = {
    "dense": (dense_scan.dense_scan_reject_reason, "dense scan",
              "cuda-dense-scan (hand-written CUDA kernels K6a/K6b)"),
    "block": (block_scan.block_scan_reject_reason, "blocked scan",
              "cuda-block-scan (hand-written CUDA kernels K2-K4)"),
    "banded": (banded_scan.banded_scan_reject_reason, "stacked banded scan",
               "cuda-banded-scan (hand-written CUDA kernels K5a/K5b, one "
               "CTA or cluster per graph)"),
}


def _kernel_route(cf: CompiledFSM, device, batch_size: int,
                  n_frames: int | None = None) -> bool:
    """The dispatch rule after ``_plain_everywhere`` and
    ``_plain_on_card``: False (plain scan) for CPU tensors, True (CUDA
    kernels of the graph's strategy) for CUDA tensors with a graph the
    kernels accept; raises for a CUDA tensor with any other graph (a
    'dense' or 'banded' one, or a 'block' one that only the port's own
    predicates refuse), naming the first rejected predicate, and for any
    other device."""
    device = torch.device(device)
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no forward-backward path for device {device}")
    reject, name, _ = _CUDA_SCANS[cf.strategy]
    reason = reject(cf, batch_size, n_frames=n_frames, device=device)
    if reason is not None:
        raise ValueError(f"the CUDA {name} rejects this graph: {reason}")
    return True


_OUTSIDE = "on every device: the JAX package runs this route outside any " \
    "Pallas kernel"
_LOG = logging.getLogger("markovmodels_tpu_torch")


def _plain_everywhere(cf: CompiledFSM):
    """The one rule for the routes that take a plain PyTorch scan on every
    device, as the JAX package runs them outside any Pallas kernel:
    (scan, the route's report line), or None for a graph whose route
    depends on the device.  Decided from the graph's domain, strategy and
    stacking alone, before any launch:

    * a log-domain graph of any strategy, and a 'segment' or 'ell' graph,
      take the log-space scan ``_fb_run`` (JAX ``_fb_single`` sends them
      to its ``_fb_run``; its Pallas admissions refuse ``domain != 'prob'``,
      and K2-K7 compute the rescaled probability-domain recursion, which
      the caller of ``domain='log'`` did not ask for);
    * stacked probability-domain 'dense' graphs take the per-graph
      probability-domain scan (the JAX package's dense kernels reject
      batched graphs, and its vmap lands on the XLA scan).

    A stacked graph runs one sequence per graph, the graph axis as the
    column axis of one (Sp, G) state.  Stacked probability-domain 'banded'
    graphs are the one stacked route with kernels (K5a/K5b)."""
    if cf.domain == "log" or cf.strategy in ("segment", "ell"):
        what = (f"stacked {cf.strategy!r} graphs, one column per graph"
                if cf.batched else f"one {cf.strategy!r} graph")
        return _fb_log, (f"plain torch log-space scan ({what}, domain "
                         f"{cf.domain!r}; {_OUTSIDE})")
    if cf.batched and cf.strategy == "dense":
        return _fb_prob_dense_stacked, (
            "plain torch per-graph scan (stacked 'dense' graphs, one column "
            f"per graph, {_OUTSIDE})")
    return None


def _plain_on_card(cf: CompiledFSM, device, batch_size: int,
                   n_frames: int | None = None):
    """The one rule for the graphs that take the plain probability-domain
    scan ``_fb_prob`` on the card, where the JAX package's Pallas kernels
    decline them and its ``_fb_single`` runs its XLA scan ``_fb_prob``:
    the first predicate the port's kernels refuse, or None (a CPU device,
    or a graph that a kernel takes or whose refusal raises).  Decided from
    the graph and the runtime batch before any launch, after
    ``_plain_everywhere``:

    * a 'block' graph that K2-K4 refuse for a predicate of the JAX
      package's admission (two tiers, the one-hot reduction of
      ``reorder='none'``, a generic gather/scatter, a general Ĉ, a working
      set past the card's memory, where JAX's is past its VMEM budget), as
      JAX ``_fb_single`` sends every 'block' graph its fused scan declines
      to XLA;
    * a general-Ĉ 'dense' graph (the fused kernels of both packages take
      one pdf per state; JAX ``_pallas_dense_reject_reason``).

    A 'block' graph that the JAX package's fused scan admits but one of
    the port's own predicates refuses (the kernels' limits, the bf16 tier
    tile, co-residency) and a 'dense' graph with one pdf per state that
    K6a/K6b refuse still raise."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if cf.strategy == "block":
        reason, shared = block_scan.block_scan_admission(
            cf, batch_size, n_frames=n_frames, device=device)
        return reason if shared else None
    if cf.strategy == "dense" and cf.multi_pdf:
        return dense_scan.dense_scan_reject_reason(
            cf, batch_size, n_frames=n_frames, device=device)
    return None


def _plain_on_card_line(cf: CompiledFSM, reason: str) -> str:
    return (f"plain torch scan on the card (one {cf.strategy!r} graph; the "
            "JAX package runs it in its XLA scan, no kernel takes it): "
            f"{reason}")


def _log_plain_on_card(cf: CompiledFSM, reason: str):
    """A 'block' graph off the fused kernels names the predicate once per
    graph and reason (JAX ``inference.py:1492-1501`` warns at trace
    time)."""
    logged = cf._cache.setdefault("plain_on_card_logged", set())
    if cf.strategy == "block" and reason not in logged:
        logged.add(reason)
        _LOG.warning("block-strategy graph fell off the fused fast path: "
                     "%s", reason)


def fast_path_report(cf: CompiledFSM, batch_size: int, *, device=None) -> str:
    """One-line explanation of the path ``pdfposteriors`` takes for this
    graph at the RUNTIME batch ``batch_size`` on ``device`` (default: the
    graph's device): for a CUDA device the kernels, or the plain route on
    the card with the first predicate the kernels refuse, or, for a
    'dense' or 'banded' graph the kernels refuse and a 'block' graph that
    only the port's own predicates refuse, that predicate
    (``pdfposteriors`` then raises with the same reason)."""
    device = torch.device(cf.device if device is None else device)
    plain = _plain_everywhere(cf)
    if plain is not None:
        return plain[1]
    if device.type == "cpu":
        what = ("stacked 'banded' graphs, one column per graph"
                if cf.batched else f"one {cf.strategy!r} graph")
        return f"plain torch scan ({what}; CPU tensors take the plain path)"
    reason = _plain_on_card(cf, device, batch_size)
    if reason is not None:
        return _plain_on_card_line(cf, reason)
    try:
        _kernel_route(cf, device, batch_size)
    except ValueError as e:
        return f"error - {e}"
    if cf.strategy == "banded":
        return (f"{_CUDA_SCANS['banded'][2]}; "
                f"{banded_scan.instantiations(cf)}")
    if cf.alpha_hat.dtype == torch.float64:
        return f"{_CUDA_SCANS[cf.strategy][2]}; float64 instantiation"
    return _CUDA_SCANS[cf.strategy][2]


_FULL_MEM_BYTES = 4 << 30  # keep saved alphas below ~4 GB


def _auto_chunk(cf: CompiledFSM, lhs):
    """Full-memory mode (one chunk) when all alphas fit under 4 GB, else
    chunk checkpointing with 64-frame chunks (the JAX package's rule; a
    stacked graph counts one column per graph, as the JAX rule does)."""
    Nf = lhs.shape[-2] + 1
    batch = 1 if cf.batched else lhs.shape[0]
    est = Nf * cf.padded_states * batch * lhs.element_size()
    return Nf if est <= _FULL_MEM_BYTES else 64


def _check_call(cf: CompiledFSM, lhs, lengths):
    """The checks every entry point makes of its inputs; returns (lhs,
    lengths as (B,) int32 clamped to N on lhs's device)."""
    lhs = torch.as_tensor(lhs)
    if lhs.ndim != 3:
        raise ValueError("lhs must have shape (B, N, P)")
    if lhs.device != cf.device:
        raise ValueError(f"lhs is on {lhs.device}, the graph on {cf.device}")
    B, N, P = lhs.shape
    if P != cf.num_pdfs:
        raise ValueError(f"lhs has {P} pdfs, graph expects {cf.num_pdfs}")
    if cf.alpha_hat.dtype == torch.float64 and lhs.dtype != torch.float64:
        raise ValueError(f"lhs is {lhs.dtype}, the graph float64: a float64 "
                         "graph takes float64 log-likelihoods")
    if cf.batched and cf.strategy == "block":
        raise ValueError("a batched 'block' graph: stack does not build one")
    if cf.batched and B != cf.alpha_hat.shape[0]:
        # the JAX package's vmap over the graphs fails on the sizes too
        raise ValueError(
            f"a stacked graph of {cf.alpha_hat.shape[0]} graphs at batch "
            f"{B}: a stacked graph takes one sequence per graph")
    if lengths is None:
        lengths = torch.full((B,), N, dtype=torch.int32, device=lhs.device)
    # clamp: a length beyond the frame count would keep the recursion off
    # the phony final state forever (logZ = -inf)
    lengths = torch.clamp(
        torch.as_tensor(lengths).to(device=lhs.device, dtype=torch.int32),
        max=N,
    )
    return lhs, lengths


def _dispatch(cf: CompiledFSM, lhs, lengths, chunk_size, want_posts):
    lhs, lengths = _check_call(cf, lhs, lengths)
    B, N, _ = lhs.shape
    if chunk_size is None:
        chunk_size = _auto_chunk(cf, lhs)
    plain = _plain_everywhere(cf)
    if plain is not None:
        return plain[0](cf, lhs, lengths, chunk_size, want_posts)
    reason = _plain_on_card(cf, lhs.device, B, N)
    if reason is not None:
        _log_plain_on_card(cf, reason)
        return _fb_prob(cf, lhs, lengths, chunk_size, want_posts)
    if _kernel_route(cf, lhs.device, B, N):
        if cf.strategy == "dense":
            return _fb_dense_cuda(cf, lhs, lengths, want_posts)
        if cf.strategy == "banded":
            return _fb_banded_cuda(cf, lhs, lengths, want_posts)
        return _fb_block_cuda(cf, lhs, lengths, want_posts, chunk_size)
    if cf.batched:
        return _fb_prob_banded_stacked(cf, lhs, lengths, chunk_size,
                                       want_posts)
    return _fb_prob(cf, lhs, lengths, chunk_size, want_posts)


def pdfposteriors(cf: CompiledFSM, lhs, lengths=None, *,
                  chunk_size: int | None = None):
    """Batched LF-MMI posterior computation.

    ``lhs``: (B, N, P) log-likelihoods on the graph's device; ``lengths``:
    (B,) frame counts.  Returns (posteriors (B, N, P), logZ (B,)).
    Posteriors are exactly zero past each sequence length.  A stacked
    graph takes one sequence per graph (B = G; another batch raises
    ``ValueError``).  Not differentiable: use :func:`logmarginal` /
    :func:`lfmmi_loss`."""
    return _dispatch(cf, lhs, lengths, chunk_size, True)


def forward(cf: CompiledFSM, lhs, lengths=None, *,
            chunk_size: int | None = None):
    """Forward pass only: log-marginals logZ (B,)."""
    return _dispatch(cf, lhs, lengths, chunk_size, False)[1]


class _LogMarginal(torch.autograd.Function):
    """logZ of ``pdfposteriors`` with d logZ / d lhs = the posteriors it
    already computed (the standard LF-MMI identity), so the scan itself is
    never differentiated.  The graph's tensors never require grad; the
    lengths and the graph get no gradient."""

    @staticmethod
    def forward(ctx, lhs, cf, lengths, chunk_size):
        posts, logZ = pdfposteriors(cf, lhs.detach(), lengths,
                                    chunk_size=chunk_size)
        ctx.save_for_backward(posts)
        return logZ

    @staticmethod
    def backward(ctx, grad_out):
        (posts,) = ctx.saved_tensors
        return grad_out[:, None, None] * posts, None, None, None


def logmarginal(cf: CompiledFSM, lhs, lengths=None, *,
                chunk_size: int | None = None):
    """Differentiable total log-marginal log p(X | graph), (B,); its
    gradient in ``lhs`` is the pdf posteriors."""
    return _LogMarginal.apply(torch.as_tensor(lhs), cf, lengths, chunk_size)


def lfmmi_loss(num_cf: CompiledFSM, den_cf: CompiledFSM, lhs, lengths=None,
               *, chunk_size: int | None = None):
    """LF-MMI objective per utterance: -(log p_num - log p_den), (B,).

    ``num_cf`` is typically a stacked batch of per-utterance 'banded'
    numerator graphs, ``den_cf`` the shared denominator graph ('dense' up
    to 4,096 states under the default strategy, e.g. a WSJ-sized
    denominator, else 'block').
    Differentiable in ``lhs`` with gradient γ_den - γ_num."""
    num = logmarginal(num_cf, lhs, lengths, chunk_size=chunk_size)
    den = logmarginal(den_cf, lhs, lengths, chunk_size=chunk_size)
    return den - num


# ---------------------------------------------------------------------------
# reference-parity conveniences
# ---------------------------------------------------------------------------

def expand(V, seqlength=None):
    """Likelihood expansion (reference ``expand``, src/inference.jl:38-60):
    (P, N) -> (P+1, N+1), the phony-pdf row -inf inside the sequence and 0
    past it, the real rows -inf past ``seqlength``.  The scans apply this
    masking per frame; this standalone form is for API parity and host
    oracles."""
    V = torch.as_tensor(V)
    P, N = V.shape
    if seqlength is None:
        seqlength = N
    out = V.new_full((P + 1, N + 1), -float("inf"))
    active = torch.arange(N + 1, device=V.device) < seqlength
    out[:P, :N] = V
    out = torch.where(active[None, :], out,
                      torch.full_like(out, -float("inf")))
    out[P] = torch.where(active, torch.full_like(out[P], -float("inf")),
                         torch.zeros_like(out[P]))
    return out


def _full_recursion(cf: CompiledFSM, lhs, lengths, direction: str):
    """Every frame's unrescaled log-domain message, (B, N+1, Sp)."""
    lhs, lengths = _check_call(cf, lhs, lengths)
    B, N, _ = lhs.shape
    Nf = N + 1
    kern = _make_kernels(cf, lengths, lhs.dtype, B)
    lhs_tm = torch.nn.functional.pad(lhs.permute(1, 0, 2),
                                     (0, 0, 0, 0, 0, 1))
    ys = lhs.new_empty((Nf, cf.padded_states, B))
    if direction == "alpha":
        y = kern.alpha0
        for t in range(Nf):
            y = (y if t == 0 else kern.fwd_mv(y)) + kern.elhs(lhs_tm[t], t)
            ys[t] = y
    else:
        bb = torch.zeros_like(ys[0])
        for t in reversed(range(Nf)):
            ys[t] = torch.zeros_like(bb) if t == Nf - 1 else kern.bwd_mv(bb)
            bb = ys[t] + kern.elhs(lhs_tm[t], t)
    return ys.permute(2, 0, 1)


def alpha_recursion(cf: CompiledFSM, lhs, lengths=None):
    """Full forward messages α (B, N+1, Sp), the reference's
    ``αrecursion`` (src/inference.jl:62-74), unrescaled, in the log domain
    through the graph's log-space matvec on every device; for moderate N
    and S (``pdfposteriors`` never keeps them)."""
    return _full_recursion(cf, lhs, lengths, "alpha")


def beta_recursion(cf: CompiledFSM, lhs, lengths=None):
    """Full backward messages β (B, N+1, Sp), the reference's
    ``βrecursion`` (src/inference.jl:99-110)."""
    return _full_recursion(cf, lhs, lengths, "beta")
