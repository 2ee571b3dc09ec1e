"""Compiled FSMs and the batched LF-MMI denominator forward-backward.

PyTorch counterpart of ``markovmodels_tpu/inference.py`` for the 'block'
strategy in the probability domain:

* ``compile_fsm`` lowers a host ``FSM`` to a :class:`CompiledFSM` of
  tensors (pdf-grouped relabeling, COO edge arrays, blocked operator, rank-1
  ω split), bit-identical to the JAX package's arrays;
* ``pdfposteriors`` / ``forward`` run the chunk-checkpointed
  probability-domain scan.  CPU tensors take the plain PyTorch scan; CUDA
  tensors take the hand-written kernels of ``ops/block_scan.py`` and raise,
  naming the first rejected predicate, for a graph those kernels do not
  accept.  Nothing falls back quietly.

Layouts at the public functions are the JAX package's: ``lhs`` (B, N, P),
``lengths`` (B,), results (posteriors (B, N, P), logZ (B,)).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from markovmodels_tpu import hostsparse as hs
from markovmodels_tpu.fsm import FSM

from .ops import block_scan
from .ops.block_scan import _pow2_exponent, _pow2_scale
from .ops.blocked import BlockOperator, block_matvec, build_block_operator
from .ops.emissions import prepare_emissions

__all__ = [
    "CompiledFSM",
    "compile_fsm",
    "compiled_from_numpy",
    "pdfposteriors",
    "forward",
    "fast_path_report",
]

_BLOCK_TODO = "ROADMAP: port the remaining strategies and precision modes"


def _round_up(x, m):
    return -(-x // m) * m


@dataclasses.dataclass
class CompiledFSM:
    """Device representation of one FSM for the 'block' strategy.

    ``Sp`` is the padded state count; real states come first.  Static
    metadata (final state, counts, descriptors, layout) is plain Python, so
    nothing on the hot path reads a device scalar back to the host.
    """

    # (Sp,) log-domain initial weights of the extended graph [α; zero]
    alpha_hat: torch.Tensor
    # index of the phony final state
    final_state: int
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
    # blocked gather-matmul-scatter operators of the S×S core
    block_fwd: BlockOperator
    block_bwd: BlockOperator
    # (Sp,) probabilities of the arcs into the phony final state (ω column)
    omega_prob: torch.Tensor
    # (Sp,) int32 original state id per (possibly reordered) slot; -1 pad
    orig_state: torch.Tensor
    num_states: int = 0  # S+1 (incl. phony, excl. padding)
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
    strategy: str = "block",
    dtype=torch.float32,
    precision: str = "high",
    domain: str = "prob",
    reorder: str = "auto",
    ov_cap: int | None = None,
) -> CompiledFSM:
    """Lower a host FSM to the 'block' device representation (on the CPU;
    move it with ``.to(device)``).

    ``state_pdf``: int array of length ``num_states + 1`` mapping each state
    (the phony final state included, mapped to ``num_pdfs``) to a pdf id,
    or a binary ``hostsparse`` Ĉ with one pdf per state.

    ``reorder``: 'pdf' renumbers states into a uniform pdf-grouped layout
    (pdf p owns slots [p*cmax, (p+1)*cmax)); 'auto' does so when the
    padding inflation is acceptable; 'none' keeps the host order.
    ``precision``: 'high' and 'f32' both mean full float32.

    Not ported yet (raise ``NotImplementedError``): other strategies,
    float64, general multi-pdf Ĉ, precision 'bf16', the log domain and the
    capped overflow layout.
    """
    S1 = len(fsm.alpha_hat)
    if strategy == "auto":
        strategy = "dense" if S1 <= 4096 else "block"
    if strategy != "block":
        raise NotImplementedError(f"strategy {strategy!r} ({_BLOCK_TODO})")
    if dtype != torch.float32:
        raise NotImplementedError(f"dtype {dtype} ({_BLOCK_TODO})")
    if precision not in ("high", "f32"):
        raise NotImplementedError(f"precision {precision!r} ({_BLOCK_TODO})")
    if domain != "prob":
        raise NotImplementedError(f"domain {domain!r} ({_BLOCK_TODO})")
    if isinstance(state_pdf, hs.SpMat):
        if not (np.diff(state_pdf.indptr) == 1).all():
            raise NotImplementedError(
                f"general multi-pdf Ĉ ({_BLOCK_TODO})"
            )
        state_pdf = state_pdf.indices
    state_pdf = np.asarray(state_pdf, dtype=np.int32)
    if state_pdf.shape != (S1,):
        raise ValueError(f"state_pdf must have shape ({S1},)")
    if reorder not in ("auto", "pdf", "none"):
        raise ValueError(f"unknown reorder mode {reorder!r}")

    rows, cols, data = hs.findnz(fsm.T_hat)
    E = len(rows)
    alpha_in = np.asarray(fsm.alpha_hat, dtype=np.float64)

    # --- optional uniform pdf-grouped relabeling --------------------------
    pdf_group = ()
    orig = None
    if reorder != "none":
        P1 = num_pdfs + 1
        counts = np.bincount(state_pdf[: S1 - 1], minlength=P1)
        cmax = max(int(counts.max()), 1)
        cap = ov_cap
        if cap is None and cmax > 128 and cmax % 128:
            cap = 128
        if cap is not None and cap < cmax:
            grp = np.sort(state_pdf[: S1 - 1]).astype(np.int64)
            pos = np.arange(S1 - 1) - np.searchsorted(grp, grp)
            n_over = int((~((pos < cap) & (grp < num_pdfs))).sum())
            nOv = -(-n_over // cap)
            fin_ov = num_pdfs * cap + nOv * cap
            if nOv > 0 and fin_ov + 1 <= max(
                int(1.5 * _round_up(S1, 128)), _round_up(S1, 128) + 128
            ):
                raise NotImplementedError(
                    "capped pdf-grouped layout with an overflow region "
                    "(ROADMAP: port the overflow families)"
                )
        lim = P1 * cmax
        inflation_ok = lim + 1 <= max(
            int(1.5 * _round_up(S1, 128)), _round_up(S1, 128) + 128
        )
        if reorder == "pdf" or inflation_ok:
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
    if not pdf_group:
        final_idx = S1 - 1
        S_eff = S1

    Sp = _round_up(S_eff, 128)
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

    # one-hot Ĉᵀ for the posterior reduction when the layout is not
    # pdf-grouped (with it, the reduction is a reshape-sum)
    pdf_onehot = None
    if not pdf_group and Sp * (num_pdfs + 1) <= 64 * 1024 * 1024:
        oh = np.zeros((num_pdfs + 1, Sp), dtype=np.float32)
        oh[spdf, np.arange(Sp)] = 1.0
        pdf_onehot = torch.from_numpy(oh)

    # rank-1 split: arcs into the phony final state (the ω column of the
    # extended matrix) are handled analytically, so the block operators
    # stay scatter-free on the S×S core
    to_fin = cols == final_idx
    om = np.zeros(Sp, dtype=np.float64)
    np.add.at(om, rows[to_fin], np.exp(data[to_fin]))
    if len(np.unique(rows[to_fin])) != int(to_fin.sum()):
        raise ValueError(
            "parallel arcs into the final state would break the "
            "tropical reuse of omega_prob"
        )
    crows, ccols, cdata = rows[~to_fin], cols[~to_fin], data[~to_fin]
    block_fwd, fwd_meta = build_block_operator(crows, ccols, cdata, Sp)
    block_bwd, bwd_meta = build_block_operator(ccols, crows, cdata, Sp)

    f32 = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float32))
    return CompiledFSM(
        alpha_hat=f32(alpha_hat),
        final_state=int(final_idx),
        state_pdf=torch.from_numpy(spdf),
        fwd_src=torch.from_numpy(fwd_src),
        fwd_dst=torch.from_numpy(fwd_dst),
        fwd_w=f32(fwd_w),
        bwd_src=torch.from_numpy(bwd_src),
        bwd_dst=torch.from_numpy(bwd_dst),
        bwd_w=f32(bwd_w),
        pdf_onehot=pdf_onehot,
        block_fwd=block_fwd,
        block_bwd=block_bwd,
        omega_prob=f32(om),
        orig_state=torch.from_numpy(orig),
        num_states=S1,
        num_pdfs=int(num_pdfs),
        precision=precision,
        block_fwd_offsets=fwd_meta,
        block_bwd_offsets=bwd_meta,
        pdf_group=pdf_group,
    )


def compiled_from_numpy(fields: dict, meta: dict) -> CompiledFSM:
    """Build a CompiledFSM from another representation's arrays: ``fields``
    maps each data field name to numpy arrays (``block_fwd`` / ``block_bwd``
    to any object with BlockOperator's attributes holding numpy arrays),
    ``meta`` maps the metadata field names to their values.  Lets both
    packages run the identical operator."""
    t = lambda x: None if x is None else torch.from_numpy(np.array(x))

    def op(o):
        if getattr(o, "ov_w", ()):
            raise NotImplementedError(
                "overflow families (ROADMAP: port the overflow families)"
            )
        return BlockOperator(
            band_w=t(o.band_w),
            tiers=tuple(tuple(t(x) for x in tier) for tier in o.tiers),
            res_src=t(o.res_src),
            res_dst=t(o.res_dst),
            res_w=t(o.res_w),
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
                 "orig_state"):
        kw[name] = t(fields.get(name))
    kw["final_state"] = int(np.asarray(fields["final_state"]))
    kw["block_fwd"] = op(fields["block_fwd"])
    kw["block_bwd"] = op(fields["block_bwd"])
    for name, v in meta.items():
        if name in names:
            kw[name] = plain(v)
    cf = CompiledFSM(**kw)
    if cf.strategy != "block":
        raise NotImplementedError(f"strategy {cf.strategy!r} ({_BLOCK_TODO})")
    return cf


# ---------------------------------------------------------------------------
# plain probability-domain scan (the CPU path)
# ---------------------------------------------------------------------------

# Cody-Waite split of ln 2: LN2_HI has 9 mantissa bits, so k·LN2_HI is
# exact in float32 for integer |k| < 2^15; k·LN2_LO carries the rest.
_LN2_HI = float(np.float32(0.693359375))
_LN2_LO = float(np.float32(np.log(2.0) - 0.693359375))


def _combine_shift(logv, ksum, shift):
    """logZ = logv + ksum·ln2 + shift with the ksum·ln2 product split so the
    dominant term is exact (ksum is an exactly-accumulated integer)."""
    hi = torch.tensor(_LN2_HI, dtype=logv.dtype, device=logv.device)
    lo = torch.tensor(_LN2_LO, dtype=logv.dtype, device=logv.device)
    return ((logv + ksum * lo) + shift) + ksum * hi


def _kahan_add(s, c, x):
    """Compensated accumulation: returns updated (sum, compensation)."""
    y = x - c
    t = s + y
    return t, (t - s) - y


def _log_final(v):
    return torch.where(v > 0, torch.log(torch.clamp(v, min=1e-38)),
                       torch.full_like(v, -float("inf")))


def _make_eprob(cf: CompiledFSM, lengths):
    """(lhs_t (B, P), t) -> (e (Sp, B) in [0, 1], m_l (B,) log-shift)."""
    Sp = cf.padded_states
    is_ph = torch.zeros((Sp, 1), dtype=cf.alpha_hat.dtype, device=cf.device)
    is_ph[cf.final_state] = 1.0

    def eprob(lhs_t, t):
        active = t < lengths  # (B,)
        m_l = lhs_t.amax(dim=1)
        el = torch.exp(lhs_t - m_l[:, None])
        ph = (~active).to(lhs_t.dtype)[None, :]
        ext = torch.cat([el.T * active[None, :], ph], dim=0)  # (P1, B)
        if cf.pdf_group:
            cmax, lim = cf.pdf_group
            x = ext.repeat_interleave(cmax, dim=0)
            x = torch.nn.functional.pad(x, (0, 0, 0, Sp - lim))
        else:
            x = ext[cf.state_pdf.long()]
            x = torch.where(active[None, :], x, is_ph)
        return x, torch.where(active, m_l, torch.zeros_like(m_l))

    return eprob


def _make_prob_matvecs(cf: CompiledFSM):
    """Probability-domain matvecs with the rank-1 ω column."""
    fin = cf.final_state

    def fwd(a):
        y = block_matvec(cf.block_fwd, cf.block_fwd_offsets, a)
        y[fin] = cf.omega_prob @ a  # ω[fin] = 1 covers the phony self-loop
        return y

    def bwd(a):
        y = block_matvec(cf.block_bwd, cf.block_bwd_offsets, a)
        return y + cf.omega_prob[:, None] * a[fin][None, :]

    return fwd, bwd


def _fb_prob(cf: CompiledFSM, lhs, lengths, chunk_size, want_posts):
    """Plain probability-domain scan: the state is carried as max-normalised
    probabilities with an exact power-of-two exponent sum and a
    Kahan-compensated emission shift, per frame."""
    B, N, P = lhs.shape
    fwd_pmv, bwd_pmv = _make_prob_matvecs(cf)
    eprob = _make_eprob(cf, lengths)
    P1 = P + 1
    fin = cf.final_state

    def pdf_reduce(gamma):
        if cf.pdf_group:
            cmax, lim = cf.pdf_group
            s = gamma[:lim].reshape(P1, cmax, B).sum(dim=1)
            return s, s.sum(dim=0)
        if cf.pdf_onehot is not None:
            return cf.pdf_onehot @ gamma, gamma.sum(dim=0)
        s = gamma.new_zeros((P1, B)).index_add_(0, cf.state_pdf.long(), gamma)
        return s, gamma.sum(dim=0)

    Sl = cf.padded_states
    Nf = N + 1
    K = min(chunk_size, Nf)
    C = -(-Nf // K)
    Npad = C * K
    lhs_tm = torch.nn.functional.pad(lhs.permute(1, 0, 2),
                                     (0, 0, 0, 0, 0, Npad - N))

    def fstep(carry, t):
        a, ksum, shift, comp = carry
        p = a if t == 0 else fwd_pmv(a)
        e, m_l = eprob(lhs_tm[t], t)
        y = p * e
        k = _pow2_exponent(y.amax(dim=0))
        shift, comp = _kahan_add(shift, comp, m_l)
        return y * _pow2_scale(k)[None, :], ksum + k, shift, comp

    def bstep(bb, a_t, t):
        y = torch.ones_like(bb) if t == Npad - 1 else bwd_pmv(bb)
        y = y * _pow2_scale(_pow2_exponent(y.amax(dim=0)))[None, :]
        s, tot = pdf_reduce(a_t * y)
        posts_t = s / torch.where(tot > 0, tot, torch.ones_like(tot))[None, :]
        e, _ = eprob(lhs_tm[t], t)
        return y * e, posts_t

    zeros = lhs.new_zeros(B)
    carry = (torch.exp(cf.alpha_hat)[:, None].expand(Sl, B).to(lhs.dtype),
             zeros, zeros, zeros)
    bounds = []
    for t in range(Npad):
        if t % K == 0:
            bounds.append(carry)
        carry = fstep(carry, t)
    aF, kF, shiftF, _ = carry
    logZ = _combine_shift(_log_final(aF[fin]), kF, shiftF)
    if not want_posts:
        return None, logZ
    posts = lhs.new_empty((Npad, P1, B))
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


# ---------------------------------------------------------------------------
# the CUDA kernels and the dispatcher
# ---------------------------------------------------------------------------

def _fb_block_cuda(cf: CompiledFSM, lhs, lengths, want_posts, chunk_size):
    """The hand-written CUDA scan (ops/block_scan.py): one forward sweep
    with chunk checkpoints, then per chunk a recompute and a backward."""
    B, N, P = lhs.shape
    ext, mshift = prepare_emissions(lhs, lengths, P)
    posts, vfin, shift, ksum = block_scan.block_fused_fb(
        cf, ext, mshift, want_posts, chunk=min(chunk_size, N + 1)
    )
    logZ = _combine_shift(_log_final(vfin), ksum, shift)
    if not want_posts:
        return None, logZ
    return posts.permute(2, 0, 1)[:, :N, :P], logZ


def _kernel_route(cf: CompiledFSM, device, batch_size: int,
                  n_frames: int | None = None) -> bool:
    """The dispatch rule: False (plain scan) for CPU tensors, True (CUDA
    kernels) for CUDA tensors with a graph the kernels accept; raises for a
    CUDA tensor with any other graph, naming the first rejected predicate,
    and for any other device."""
    device = torch.device(device)
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no forward-backward path for device {device}")
    reason = block_scan.block_scan_reject_reason(
        cf, batch_size, n_frames=n_frames, device=device
    )
    if reason is not None:
        raise ValueError(
            f"the CUDA blocked scan rejects this graph: {reason}"
        )
    return True


def fast_path_report(cf: CompiledFSM, batch_size: int, *, device=None) -> str:
    """One-line explanation of the path ``pdfposteriors`` takes for this
    graph at the RUNTIME batch ``batch_size`` on ``device`` (default: the
    graph's device) and, for a CUDA device, the first predicate the kernels
    reject (``pdfposteriors`` then raises with the same reason)."""
    device = torch.device(cf.device if device is None else device)
    if device.type == "cpu":
        return "plain torch scan (CPU tensors take the plain path)"
    try:
        _kernel_route(cf, device, batch_size)
    except ValueError as e:
        return f"error - {e}"
    return "cuda-block-scan (hand-written CUDA kernels K2-K4)"


_FULL_MEM_BYTES = 4 << 30  # keep saved alphas below ~4 GB


def _auto_chunk(cf: CompiledFSM, lhs):
    """Full-memory mode (one chunk) when all alphas fit under 4 GB, else
    chunk checkpointing with 64-frame chunks (the JAX package's rule)."""
    Nf = lhs.shape[-2] + 1
    est = Nf * cf.padded_states * lhs.shape[0] * lhs.element_size()
    return Nf if est <= _FULL_MEM_BYTES else 64


def _dispatch(cf: CompiledFSM, lhs, lengths, chunk_size, want_posts):
    lhs = torch.as_tensor(lhs)
    if lhs.ndim != 3:
        raise ValueError("lhs must have shape (B, N, P)")
    if lhs.device != cf.device:
        raise ValueError(f"lhs is on {lhs.device}, the graph on {cf.device}")
    B, N, P = lhs.shape
    if P != cf.num_pdfs:
        raise ValueError(f"lhs has {P} pdfs, graph expects {cf.num_pdfs}")
    if chunk_size is None:
        chunk_size = _auto_chunk(cf, lhs)
    if lengths is None:
        lengths = torch.full((B,), N, dtype=torch.int32, device=lhs.device)
    # clamp: a length beyond the frame count would keep the recursion off
    # the phony final state forever (logZ = -inf)
    lengths = torch.clamp(
        torch.as_tensor(lengths).to(device=lhs.device, dtype=torch.int32),
        max=N,
    )
    if _kernel_route(cf, lhs.device, B, N):
        return _fb_block_cuda(cf, lhs, lengths, want_posts, chunk_size)
    return _fb_prob(cf, lhs, lengths, chunk_size, want_posts)


def pdfposteriors(cf: CompiledFSM, lhs, lengths=None, *,
                  chunk_size: int | None = None):
    """Batched LF-MMI posterior computation.

    ``lhs``: (B, N, P) log-likelihoods on the graph's device; ``lengths``:
    (B,) frame counts.  Returns (posteriors (B, N, P), logZ (B,)).
    Posteriors are exactly zero past each sequence length."""
    return _dispatch(cf, lhs, lengths, chunk_size, True)


def forward(cf: CompiledFSM, lhs, lengths=None, *,
            chunk_size: int | None = None):
    """Forward pass only: log-marginals logZ (B,)."""
    return _dispatch(cf, lhs, lengths, chunk_size, False)[1]
