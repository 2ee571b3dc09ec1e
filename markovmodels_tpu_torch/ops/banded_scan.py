"""Stacked-banded forward-backward on the GPU: hand-written CUDA kernels with
plain PyTorch twins.

Counterpart of ``markovmodels_tpu/ops/pallas_banded.py``.  G independent
'banded' graphs (the LF-MMI numerator lattices: self-loop and chain bands)
are stacked, one sequence per graph, and run as one (Sp, G) probability
state:

* K5a ``fwd_sweep``: the forward sweep over all Nf = N + 1 frames (replaces
  ``_run``'s forward ``pallas_call``, ``_make_fwd_kernel``).  Per frame and
  graph: nO zero-filled shifted multiply-adds with the graph's bands, the
  rank-1 omega dot REPLACING the graph's final row, the emission, and an
  exact power-of-two rescale; the sums of the exponents and of the
  emission shift.  It writes every frame's rescaled alpha (Nf, Sp, G) and
  v_final, shift and ksum (G,): logZ = log(v_final) + ksum·ln2 + shift;
* K5b ``backward``: the reverse sweep (replaces ``_make_bwd_kernel``):
  beta through the transposed bands PLUS omega·beta[fin], gamma = alpha ⊙
  beta, and the per-frame pdf posteriors (Nf, P1, G), normalised by the
  state sum of gamma.

One repair against the Pallas kernels: the state (alpha, beta, and so
gamma) and the logZ pieces are float64, while the inputs and the
posteriors stay float32.  alpha and beta are each normalised to max 1 per frame, and
on a long lattice their masses sit at opposite ends (alpha runs ahead of
the sequence, beta behind it): for the 78-state numerators at N = 700 both
factors at the posterior's peak fall to 1e-27 .. 1e-40 in mid-sequence and
their product to ~1e-54.  In float32 the product underflows, and every
posterior of those frames is lost (the JAX package's banded paths lose
about half the frames there), and the factors lose mantissa bits in the
subnormal range.  (The float64 logZ pieces keep |logZ| ~ 10^3 exact to
~1e-10 before its final float32 rounding; the Pallas kernel's Kahan sum
is not needed.)

Unlike the Pallas kernels, which take a pre-gathered (Nf, Sp, G) emission
stream and return raw gamma because Mosaic has no per-lane gather, K5a and
K5b gather each state's emission from ``ext`` (Nf, P1, G) and reduce gamma
to pdf posteriors in their own bodies: no (Nf, Sp, G) emission or gamma
stream is written.  The twins compute the same (``torch.gather`` and
``scatter_add``).  The CUDA source is ``csrc/banded_scan.cu``; ``_build.py``
compiles it with nvcc at first use.  Each wrapper takes its plain version
for CPU tensors and launches the kernel for CUDA tensors; anything else
raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .block_scan import (_check, _p, _pow2_exponent, _pow2_scale, _raise_on,
                         _route, _stream)
from .emissions import prepare_emissions

__all__ = [
    "banded_scan_reject_reason",
    "BandedOp",
    "kernel_operator",
    "fwd_matvec_plain",
    "bwd_matvec_plain",
    "fwd_sweep",
    "backward",
    "fwd_sweep_plain",
    "backward_plain",
    "banded_fused_fb",
    "LAUNCHES",
    "reset_launch_counts",
]

# launches of each CUDA kernel entry point, counted by its wrapper
LAUNCHES = {"banded_fwd": 0, "banded_bwd": 0}

_MAX_BANDS = 8  # offsets a kernel takes (compile_fsm's cap)
_WARPS_PER_BLOCK = 4  # graphs per CTA, one warp each (WPB in the .cu)
_SMEM_BYTES = 232448  # dynamic shared memory one CTA may use on Hopper


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

def _smem_words(Sp: int, nO: int, P1: int) -> int:
    """Shared-memory words per warp of K5b, the larger kernel: one frame's
    float64 pdf sums, the float64 state double buffer, the bands, omega
    and the state->pdf map (csrc/banded_scan.cu, ``bwd_smem_words``)."""
    return 2 * P1 + ((4 * Sp + (max(nO, 1) + 2) * Sp + 1) & ~1)


def banded_scan_reject_reason(cf, B: int, *, n_frames: int | None = None,
                              device=None):
    """None when the CUDA stacked-banded scan accepts this graph at batch
    ``B``, else a one-line reason naming the FIRST rejected predicate.

    The predicates shared with the JAX package's ``banded_scan_supported``
    come first, in its order and words.  Its TPU rules (graph count a
    multiple of 128 lanes, the 96 MB VMEM and 4 GB HBM caps) are not
    copied: a warp owns one graph, so any G works.  The CUDA design adds
    two of its own: one warp's state, bands, omega, pdf map and pdf sums
    must fit the shared memory of a CTA of four warps, and the (Nf, P1, G)
    emission and posterior streams plus the (Nf, Sp, G) float64 alphas,
    each sized by its dtype, must fit the free memory of ``device`` when
    that is a CUDA device (checked where a card is present)."""
    if not cf.batched or cf.strategy != "banded":
        return "not a stacked 'banded' CompiledFSM"
    if cf.domain != "prob":
        return f"domain {cf.domain!r} != 'prob'"
    if cf.multi_pdf:
        return "general multi-pdf C-hat"
    if cf.alpha_hat.dtype != torch.float32:
        return (f"operator dtype {cf.alpha_hat.dtype} (fused kernels are "
                "f32)")
    G = cf.alpha_hat.shape[0]
    if B != G:
        return f"batch {B} != graph count {G} (one sequence per graph)"
    Sp = cf.padded_states
    if any(abs(o) >= Sp for o in cf.banded_offsets):
        return "band offset exceeds padded state count"
    nO = len(cf.banded_offsets)
    if nO > _MAX_BANDS:
        return f"{nO} band offsets (kernel supports at most {_MAX_BANDS})"
    P1 = cf.num_pdfs + 1
    smem = _WARPS_PER_BLOCK * _smem_words(Sp, nO, P1) * 4
    if smem > _SMEM_BYTES:
        return (f"shared-memory working set {smem} B for Sp = {Sp}, "
                f"{nO} offsets, {P1} pdfs exceeds a CTA's {_SMEM_BYTES} B")
    if (device is not None and torch.device(device).type == "cuda"
            and torch.cuda.is_available() and n_frames is not None):
        f = cf.alpha_hat.element_size()
        Nf = n_frames + 1
        need = (2 * Nf * P1 * G + Nf * G) * f + Nf * Sp * G * 8
        free = torch.cuda.mem_get_info(torch.device(device))[0]
        if need > free:
            return (f"emission, alpha and posterior streams ~{need / 1e9:.1f}"
                    f" GB exceed the card's {free / 1e9:.1f} GB free "
                    f"(Sp = {Sp}, G = {G}, N = {n_frames})")
    return None


# ---------------------------------------------------------------------------
# the kernels' operator: per-graph parameters with the graph axis last
# ---------------------------------------------------------------------------

class BandedOp(NamedTuple):
    Sp: int
    G: int  # graphs (1 for an unstacked graph shared by every column)
    P1: int  # pdfs + 1 (the phony pdf last)
    offsets: tuple  # band offsets (dst - src), sorted
    a0: torch.Tensor  # (Sp, G) initial probabilities
    bf: torch.Tensor  # (nO, Sp, G) forward bands, dst-indexed
    bb: torch.Tensor  # (nO, Sp, G) backward bands, src-indexed
    om: torch.Tensor  # (Sp, G) omega: arcs into the phony state
    fin: torch.Tensor  # (G,) int32 phony final state per graph
    spdf: torch.Tensor  # (Sp, G) int32 pdf of each state


def kernel_operator(cf) -> BandedOp:
    """The banded scan's operator of a 'banded' CompiledFSM, stacked or
    not, built once per graph (cached on it).  An unstacked graph gets
    G = 1, which broadcasts over the batch columns in the plain matvecs."""
    kop = cf._cache.get("banded_scan")
    if kop is None:
        one = not cf.batched
        lift = (lambda x: x[None]) if one else (lambda x: x)
        nO = max(len(cf.banded_offsets), 1)
        fin = torch.as_tensor(cf.final_state, dtype=torch.int32,
                              device=cf.device).reshape(-1)
        bands = lambda b: lift(b).reshape(-1, nO, cf.padded_states).permute(
            1, 2, 0).contiguous()
        kop = BandedOp(
            Sp=cf.padded_states,
            G=1 if one else cf.alpha_hat.shape[0],
            P1=cf.num_pdfs + 1,
            offsets=tuple(cf.banded_offsets),
            a0=torch.exp(lift(cf.alpha_hat)).T.contiguous(),
            bf=bands(cf.banded_fwd),
            bb=bands(cf.banded_bwd),
            om=lift(cf.omega_prob).T.contiguous(),
            fin=fin.contiguous(),
            spdf=lift(cf.state_pdf).T.contiguous(),
        )
        cf._cache["banded_scan"] = kop
    return kop


# ---------------------------------------------------------------------------
# plain PyTorch twins (the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

def _shift_rows(x, off: int):
    """out[s] = x[s - off], zero where s - off is outside [0, Sp)."""
    if off == 0:
        return x
    out = torch.zeros_like(x)
    if off > 0:
        out[off:] = x[:-off]
    else:
        out[:off] = x[-off:]
    return out


def _fin_row(kop: BandedOp, B: int):
    return kop.fin.long()[None, :].expand(1, B)


def fwd_matvec_plain(kop: BandedOp, a):
    """y = Σ_o bf[o] ⊙ shift(a, off_o), then y[fin] = ω·a (ω[fin] = 1
    carries the phony self-loop).  ``a`` (Sp, B) with B = G, or any B for
    an unstacked graph (G = 1)."""
    y = torch.zeros_like(a)
    for o, off in enumerate(kop.offsets):
        y = y + kop.bf[o] * _shift_rows(a, off)
    yfin = (kop.om * a).sum(dim=0)
    return y.scatter(0, _fin_row(kop, a.shape[1]), yfin[None, :])


def bwd_matvec_plain(kop: BandedOp, b):
    """y = Σ_o bb[o] ⊙ shift(b, -off_o) + ω ⊙ b[fin]."""
    y = torch.zeros_like(b)
    for o, off in enumerate(kop.offsets):
        y = y + kop.bb[o] * _shift_rows(b, -off)
    bfin = b.gather(0, _fin_row(kop, b.shape[1]))
    return y + kop.om * bfin


def _emission(kop: BandedOp, ext_t):
    """(P1, G) -> (Sp, G): each state's pdf row of its own graph."""
    return ext_t.gather(0, kop.spdf.long())


def fwd_sweep_plain(kop: BandedOp, ext, mshift, save_alphas: bool = True):
    """Plain twin of K5a over all Nf frames of ``ext`` (Nf, P1, G) and
    ``mshift`` (Nf, 1, G).  Returns (alphas (Nf, Sp, G) rescaled, or None,
    vfin (G,), shift (G,), ksum (G,)), all float64."""
    Nf, _, G = ext.shape
    f64 = torch.float64
    alphas = (ext.new_empty((Nf, kop.Sp, G), dtype=f64) if save_alphas
              else None)
    a = kop.a0.double()
    ksum, shift = ext.new_zeros(G, dtype=f64), ext.new_zeros(G, dtype=f64)
    for t in range(Nf):
        y = a if t == 0 else fwd_matvec_plain(kop, a)
        y = y * _emission(kop, ext[t])
        k = _pow2_exponent(y.amax(dim=0))
        a = y * _pow2_scale(k)[None, :]
        if save_alphas:
            alphas[t] = a
        ksum = ksum + k
        shift = shift + mshift[t, 0]
    vfin = a.gather(0, kop.fin.long()[None, :])[0]
    return alphas, vfin, shift, ksum


def backward_plain(kop: BandedOp, ext, alphas):
    """Plain twin of K5b: frames Nf-1 .. 0 from beta = 1 over the float64
    ``alphas``.  Returns posts (Nf, P1, G) float32: gamma = alpha ⊙ beta
    summed per pdf, over its state sum (0 where that is 0)."""
    Nf, P1, G = ext.shape
    posts = ext.new_empty((Nf, P1, G))
    spdf = kop.spdf.long()
    b = None
    for t in reversed(range(Nf)):
        y = torch.ones_like(alphas[t]) if t == Nf - 1 else bwd_matvec_plain(
            kop, b)
        g = alphas[t] * y
        s = g.new_zeros((P1, G)).scatter_add_(0, spdf, g)
        tot = g.sum(dim=0)
        posts[t] = s / torch.where(tot > 0, tot, torch.ones_like(tot))
        bn = y * _emission(kop, ext[t])
        b = bn * _pow2_scale(_pow2_exponent(bn.amax(dim=0)))[None, :]
    return posts


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _imeta(kop: BandedOp, Nf: int) -> np.ndarray:
    """Host int64 descriptor read by csrc/banded_scan.cu (layout: Meta)."""
    offs = list(kop.offsets) + [0] * (_MAX_BANDS - len(kop.offsets))
    return np.array([kop.Sp, kop.G, kop.P1, Nf, len(kop.offsets), *offs],
                    dtype=np.int64)


def _check_op(kop: BandedOp, dev):
    nO = max(len(kop.offsets), 1)
    for name, t, shape in (("a0", kop.a0, (kop.Sp, kop.G)),
                           ("bf", kop.bf, (nO, kop.Sp, kop.G)),
                           ("bb", kop.bb, (nO, kop.Sp, kop.G)),
                           ("om", kop.om, (kop.Sp, kop.G))):
        _check(name, t, shape, dev)
    _check("fin", kop.fin, (kop.G,), dev, torch.int32)
    _check("spdf", kop.spdf, (kop.Sp, kop.G), dev, torch.int32)


def fwd_sweep(kop: BandedOp, ext, mshift, save_alphas: bool = True):
    """K5a: the forward sweep over all Nf frames.  Same outputs as
    :func:`fwd_sweep_plain`."""
    if not _route(ext, "banded-scan"):
        return fwd_sweep_plain(kop, ext, mshift, save_alphas)
    from . import _build

    Nf, P1, G = ext.shape
    dev = ext.device
    _check_op(kop, dev)
    _check("ext", ext, (Nf, kop.P1, kop.G), dev)
    _check("mshift", mshift, (Nf, 1, kop.G), dev)
    meta = _imeta(kop, Nf)
    alphas = (torch.empty((Nf, kop.Sp, G), device=dev, dtype=torch.float64)
              if save_alphas else None)
    vfin, shift, ksum = (torch.empty(G, device=dev, dtype=torch.float64)
                         for _ in range(3))
    with torch.cuda.device(dev):  # the library launches on it
        rc = _build.library().mm_banded_fwd(
            _p(kop.a0), _p(kop.bf), _p(kop.om), _p(kop.fin), _p(kop.spdf),
            _p(ext), _p(mshift), ctypes.c_void_p(meta.ctypes.data),
            _p(alphas) if save_alphas else None, _p(vfin), _p(shift),
            _p(ksum), _stream(dev),
        )
    _raise_on(rc, "mm_banded_fwd")
    LAUNCHES["banded_fwd"] += 1
    return alphas, vfin, shift, ksum


def backward(kop: BandedOp, ext, alphas):
    """K5b: the reverse sweep and the pdf posteriors.  Same output as
    :func:`backward_plain`."""
    if not _route(ext, "banded-scan"):
        return backward_plain(kop, ext, alphas)
    from . import _build

    Nf, P1, G = ext.shape
    dev = ext.device
    _check_op(kop, dev)
    _check("ext", ext, (Nf, kop.P1, kop.G), dev)
    _check("alphas", alphas, (Nf, kop.Sp, kop.G), dev, torch.float64)
    meta = _imeta(kop, Nf)
    posts = torch.empty((Nf, P1, G), device=dev)  # every entry written
    with torch.cuda.device(dev):
        rc = _build.library().mm_banded_bwd(
            _p(kop.bb), _p(kop.om), _p(kop.fin), _p(kop.spdf), _p(ext),
            _p(alphas), ctypes.c_void_p(meta.ctypes.data), _p(posts),
            _stream(dev),
        )
    _raise_on(rc, "mm_banded_bwd")
    LAUNCHES["banded_bwd"] += 1
    return posts


# ---------------------------------------------------------------------------
# the fused scan
# ---------------------------------------------------------------------------

def banded_fused_fb(cf, lhs, lengths, want_posts: bool):
    """Stacked-banded forward-backward of ``lhs`` (G, N, P) with ``lengths``
    (G,), one sequence per graph.  Returns (posts (Nf, P1, G) or None,
    v_final (G,), shift (G,), ksum (G,)): logZ = log(v_final) + ksum·ln2 +
    shift.  The contract of ``pallas_banded.banded_fused_fb``, with the
    three logZ pieces in float64."""
    B, N, P = lhs.shape
    reason = banded_scan_reject_reason(cf, B, n_frames=N, device=lhs.device)
    if reason is not None:
        raise ValueError(f"stacked banded scan rejected this graph: {reason}")
    kop = kernel_operator(cf)
    ext, mshift = prepare_emissions(lhs, lengths, P)
    alphas, vfin, shift, ksum = fwd_sweep(kop, ext, mshift, want_posts)
    if not want_posts:
        return None, vfin, shift, ksum
    return backward(kop, ext, alphas), vfin, shift, ksum
