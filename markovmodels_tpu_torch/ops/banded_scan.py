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
  state sum of gamma.  A graph's posteriors are non-zero only at its own
  pdfs: K5b sums each of them in the fixed state order of the host plan
  ``pdf_plan`` (built once per graph), scales the sums by one reciprocal
  of the frame's gamma sum, and writes only those; the rest of the output
  is zeroed once per call.

Each kernel has three instantiations (``_modes``, named by
``instantiations`` in ``fast_path_report``): the narrow one (one warp runs
a graph's chain, up to 1,024 states in registers) where its rings fit a
CTA's shared memory; the wide one (the chain on eight warps, five states a
thread in registers and the state exchanged through shared memory, up to
1,280 states), which writes the alphas graph-major, (Nf, G, Sp) in memory,
returned as their (Nf, Sp, G) view; and the global one (the same frames on
the same threads, the state in global memory), which takes any lattice
whose streams fit the card's memory.  No stack is refused for its length.

One repair against the Pallas kernels: the state (alpha, beta, and so
gamma) and the logZ pieces are float64, while the inputs and the
posteriors keep the graph's dtype: float32, or float64 for a float64
stack (each kernel's float64 instantiation, counted in ``LAUNCHES_F64``).
alpha and beta are each normalised to max 1 per frame, and
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
``scatter_add``; the plan's order changes only the last bits of the
posteriors).  The CUDA source is ``csrc/banded_scan.cu``; ``_build.py``
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
    "pdf_plan",
    "plan_fields",
    "fwd_matvec_plain",
    "bwd_matvec_plain",
    "fwd_sweep",
    "backward",
    "fwd_sweep_plain",
    "backward_plain",
    "gammas_plain",
    "banded_fused_fb",
    "LAUNCHES",
    "LAUNCHES_F64",
    "reset_launch_counts",
]

# launches of each CUDA kernel entry point, counted by its wrapper: the
# float32 instantiations in LAUNCHES, the float64 ones (a float64 stack)
# in LAUNCHES_F64
LAUNCHES = {"banded_fwd": 0, "banded_bwd": 0}
LAUNCHES_F64 = dict(LAUNCHES)

_MAX_BANDS = 8  # offsets a kernel takes (compile_fsm's cap)
_DEPTH = 8  # frames fetched ahead of the chain (DEPTH in the .cu)
_POST_WARPS = 2  # K5b's posterior warps (POST_WARPS in the .cu)
_YRING = 8  # frames of beta between K5b's warps (YRING in the .cu)
_NARROW_STATES = 32 * 32  # 32 lanes x MAX_J states in registers (the .cu)
_WDEPTH = 4  # the wide instantiation's DEPTH (WDEPTH in the .cu)
_WT = 256  # the wide and global chains' threads (WT in the .cu)
_WIDE_J = (4, 5)  # states per wide chain thread (dispatch_wj)
_WREG = 3  # offsets whose weights a wide thread holds in registers
_WPOST = 6  # the wide K5b's posterior warps (WPOST)
_WRING = 8  # frames of gamma between its warps (WRING)
_LONG = 32  # a plan entry of more states is summed by a warp (LONG)
_SMEM_BYTES = 232448  # dynamic shared memory one CTA may use on Hopper
# the instantiations a launch takes (Mode in the .cu), by name
NARROW, WIDE, GLOBAL = "narrow", "wide", "global"


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = LAUNCHES_F64[k] = 0


def _counts(dtype):
    return LAUNCHES_F64 if dtype == torch.float64 else LAUNCHES


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

def _mode_words(Sp: int, nO: int, mode: str, tw: int = 1) -> tuple:
    """Shared-memory words (4 bytes) of one CTA of K5a and of K5b, one graph
    each, in instantiation ``mode``, with inputs of ``tw`` words (1
    float32, 2 float64; csrc/banded_scan.cu, ``fwd_smem_words``,
    ``bwd_smem_words``).  Narrow K5a: the float64 state double buffer,
    bands (one zero band when nO = 0), omega and alpha ring, two mbarriers
    per ring slot, then the emission and shift rings (the inputs' type).
    Narrow K5b: the state double buffer, the bands, omega, the beta ring,
    and per posterior warp gamma and an alpha ring (float64), two
    mbarriers per beta slot and per emission slot, the emission ring and
    the plan's state order.  Wide K5a: the unscaled state double buffer,
    the weights of the offsets past the third and the warps' partial dots
    (float64), two mbarriers per ring slot, the emission ring (a slot per
    frame holds the emission of each of the graph's distinct pdfs, at most
    Sp) and the shift ring, the distinct pdfs, each state's entry among
    them and the warps' keys (int).  Wide K5b: the state double buffer,
    those weights, the alpha ring, the gamma ring and its warps' partial
    sums (float64), two mbarriers per emission slot and per gamma slot,
    the emission ring, the distinct pdfs, each state's entry, the entries'
    ranges of the plan's order, each state's position in it and the warps'
    keys.  The global instantiation takes none (a few static words)."""
    if mode == GLOBAL:
        return 0, 0
    ww = _WT // 32
    if mode == WIDE:
        nx, D, R = max(nO - _WREG, 0), _WDEPTH, _WRING
        fwd = (2 * ((2 + nx) * Sp + 2 * ww) + 4 * D + tw * (D * Sp + D)
               + 2 * Sp + 2 * ww)
        bwd = (2 * ((2 + nx + D + R) * Sp + R * ww) + 4 * (D + R)
               + tw * D * Sp + 4 * Sp + 1 + 2 * ww)
        return fwd, bwd
    nb, D, R, W = max(nO, 1), _DEPTH, _YRING, _POST_WARPS
    fwd = 2 * (2 + nb + 1 + D) * Sp + 4 * D + tw * (D * Sp + D)
    bwd = (2 * (2 + nb + 1 + R + W * (1 + D)) * Sp + 4 * (R + D)
           + tw * D * Sp + Sp)
    return fwd, bwd


def _modes(Sp: int, nO: int, tw: int = 1) -> tuple:
    """The instantiations K5a and K5b take (``fwd_mode``, ``bwd_mode`` in
    the .cu): the narrow one where its states fit in registers (1,024) and
    its shared memory in a CTA's; else the wide one where its states fit
    (5 per thread of 256: 1,280) and its shared memory; else the global
    one, whose state lives in global memory and which takes any lattice
    the card's memory holds."""
    out = []
    for k in (0, 1):
        if (Sp <= _NARROW_STATES
                and 4 * _mode_words(Sp, nO, NARROW, tw)[k] <= _SMEM_BYTES):
            out.append(NARROW)
        elif (Sp <= _WT * _WIDE_J[-1]
              and 4 * _mode_words(Sp, nO, WIDE, tw)[k] <= _SMEM_BYTES):
            out.append(WIDE)
        else:
            out.append(GLOBAL)
    return tuple(out)


def _wide(Sp: int, nO: int, tw: int = 1) -> tuple:
    """Whether K5a and K5b take an instantiation other than the narrow
    one (the wide or the global one)."""
    return tuple(m != NARROW for m in _modes(Sp, nO, tw))


def _smem_words(Sp: int, nO: int, tw: int = 1) -> tuple:
    """Shared-memory words of one CTA of K5a and of K5b, each in the
    instantiation its launch takes (``mm_banded_smem``)."""
    fm, bm = _modes(Sp, nO, tw)
    return (_mode_words(Sp, nO, fm, tw)[0], _mode_words(Sp, nO, bm, tw)[1])


def _wide_j(Sp: int) -> int:
    """States per chain thread of the wide instantiations at Sp states
    (``dispatch_wj``): thread i owns states i, i + 256, ..., the smallest
    instantiated count that covers Sp."""
    need = -(-Sp // _WT)
    return next((j for j in _WIDE_J if j >= need), _WIDE_J[-1])


def _words(dtype) -> int:
    """Shared-memory words of one input value: 2 for float64, else 1."""
    return 2 if dtype == torch.float64 else 1


def instantiations(cf) -> str:
    """Which instantiation of K5a and of K5b a stacked 'banded' graph
    takes, in words, for ``fast_path_report``: narrow (one warp, the state
    in registers), wide (eight warps, the state on chip) or global (eight
    warps, the state in global memory)."""
    Sp, nO = cf.padded_states, len(cf.banded_offsets)
    tw = _words(cf.alpha_hat.dtype)
    fm, bm = _modes(Sp, nO, tw)
    f64 = ", float64" if tw == 2 else ""
    return f"K5a {fm}, K5b {bm} (Sp = {Sp}, {nO} offsets{f64})"


def banded_scan_reject_reason(cf, B: int, *, n_frames: int | None = None,
                              device=None):
    """None when the CUDA stacked-banded scan accepts this graph at batch
    ``B``, else a one-line reason naming the FIRST rejected predicate.

    The predicates shared with the JAX package's ``banded_scan_supported``
    come first, in its order and words.  Its TPU rules (graph count a
    multiple of 128 lanes, the 96 MB VMEM and 4 GB HBM caps) are not
    copied: a CTA owns one graph, so any G works, and a lattice of any
    length runs (the narrow instantiation up to 1,024 states where its
    shared memory fits, the wide one up to 2,048 where its own fits, the
    global one past them: ``_modes``).  The CUDA design adds one predicate
    of its own: the (Nf, P1, G) emission and posterior streams, the
    (Nf, Sp, G) float64 alphas (each sized by its dtype) and the global
    instantiation's float64 scratch (state, gamma and the graphs'
    constants, (G, 6 + nO, Sp)) must fit the free
    memory of ``device`` when that is a CUDA device (checked where a card
    is present).  The kernels take a float32 or a float64 stack (the JAX
    package's take float32 only), every float array of it in one
    dtype."""
    if not cf.batched or cf.strategy != "banded":
        return "not a stacked 'banded' CompiledFSM"
    if cf.domain != "prob":
        return f"domain {cf.domain!r} != 'prob'"
    if cf.multi_pdf:
        return "general multi-pdf C-hat"
    dts = {t.dtype for t in (cf.alpha_hat, cf.banded_fwd, cf.banded_bwd,
                             cf.omega_prob)}
    if len(dts) > 1 or cf.alpha_hat.dtype not in (torch.float32,
                                                  torch.float64):
        return (f"operator dtype {cf.alpha_hat.dtype} with "
                f"{cf.banded_fwd.dtype} bands (the kernels take float32 or "
                "float64 throughout)")
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
    if (device is not None and torch.device(device).type == "cuda"
            and torch.cuda.is_available() and n_frames is not None):
        f = cf.alpha_hat.element_size()
        Nf = n_frames + 1
        need = ((2 * Nf * P1 * G + Nf * G) * f + Nf * Sp * G * 8
                + (6 + nO) * Sp * G * 8)
        free = torch.cuda.mem_get_info(torch.device(device))[0]
        if need > free:
            return (f"emission, alpha, posterior and state streams "
                    f"~{need / 1e9:.1f} GB exceed the card's "
                    f"{free / 1e9:.1f} GB free (Sp = {Sp}, G = {G}, "
                    f"N = {n_frames})")
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
    plan: torch.Tensor  # (G, 3·Sp + 2) int32: K5b's pdf plan (pdf_plan)


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
        spdf = lift(cf.state_pdf).T.contiguous()
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
            spdf=spdf,
            plan=torch.from_numpy(pdf_plan(spdf.cpu().numpy())).to(
                cf.device),
        )
        cf._cache["banded_scan"] = kop
    return kop


def pdf_plan(spdf: np.ndarray) -> np.ndarray:
    """K5b's plan of the posteriors from the (Sp, G) state->pdf map: per
    graph g one int32 row [n, pdf[Sp], seg[Sp + 1], state[Sp]] with the
    graph's n distinct pdfs ascending in pdf[:n], and for pdf[e] its states
    state[seg[e]:seg[e + 1]] in ascending order (padding states under
    their own pdf, the phony one); seg[n:] = Sp.  Every state of the graph
    appears once, so a sum over each pdf's states in this order is K5b's
    fixed summation order."""
    Sp, G = spdf.shape
    out = np.zeros((G, 3 * Sp + 2), dtype=np.int32)
    for g in range(G):
        order = np.argsort(spdf[:, g], kind="stable")
        pdfs, starts = np.unique(spdf[order, g], return_index=True)
        n = len(pdfs)
        out[g, 0] = n
        out[g, 1:1 + n] = pdfs
        out[g, 1 + Sp:2 + 2 * Sp] = Sp
        out[g, 1 + Sp:1 + Sp + n] = starts
        out[g, 2 + 2 * Sp:] = order
    return out


def plan_fields(plan: torch.Tensor, Sp: int):
    """(n (G,), pdf (G, Sp), seg (G, Sp + 1), state (G, Sp)): the parts
    of :func:`pdf_plan`'s rows."""
    return (plan[:, 0], plan[:, 1:1 + Sp], plan[:, 1 + Sp:2 + 2 * Sp],
            plan[:, 2 + 2 * Sp:])


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


def gammas_plain(kop: BandedOp, ext, alphas):
    """K5b's recursion in plain PyTorch: (t, gamma (Sp, G) float64) for
    t = Nf-1 .. 0, from beta = 1 over the float64 ``alphas``."""
    b = None
    for t in reversed(range(ext.shape[0])):
        y = (torch.ones_like(alphas[t]) if b is None
             else bwd_matvec_plain(kop, b))
        yield t, alphas[t] * y
        bn = y * _emission(kop, ext[t])
        b = bn * _pow2_scale(_pow2_exponent(bn.amax(dim=0)))[None, :]


def backward_plain(kop: BandedOp, ext, alphas, dtype=None):
    """Plain twin of K5b.  Returns posts (Nf, P1, G) in ``dtype``, by
    default ext's, as K5b writes them (float64 keeps float32 inputs'
    posteriors before K5b's float32 cast): gamma = alpha ⊙ beta summed per
    pdf, over its state sum (0 where that is 0)."""
    Nf, P1, G = ext.shape
    posts = ext.new_empty((Nf, P1, G), dtype=dtype or ext.dtype)
    spdf = kop.spdf.long()
    for t, g in gammas_plain(kop, ext, alphas):
        s = g.new_zeros((P1, G)).scatter_add_(0, spdf, g)
        tot = g.sum(dim=0)
        posts[t] = s / torch.where(tot > 0, tot, torch.ones_like(tot))
    return posts


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _imeta(kop: BandedOp, Nf: int, gm: bool = False) -> np.ndarray:
    """Host int64 descriptor read by csrc/banded_scan.cu (layout: Meta,
    then whether the alphas are graph-major)."""
    offs = list(kop.offsets) + [0] * (_MAX_BANDS - len(kop.offsets))
    return np.array([kop.Sp, kop.G, kop.P1, Nf, len(kop.offsets), *offs,
                     int(gm)], dtype=np.int64)


def _check_op(kop: BandedOp, dev):
    """The operator's tensors on ``dev``, every float one in a0's dtype
    (float32 or float64, the instantiation a launch takes)."""
    nO = max(len(kop.offsets), 1)
    dt = kop.a0.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"a0: expected float32 or float64, got {dt}")
    for name, t, shape in (("a0", kop.a0, (kop.Sp, kop.G)),
                           ("bf", kop.bf, (nO, kop.Sp, kop.G)),
                           ("bb", kop.bb, (nO, kop.Sp, kop.G)),
                           ("om", kop.om, (kop.Sp, kop.G))):
        _check(name, t, shape, dev, dt)
    _check("fin", kop.fin, (kop.G,), dev, torch.int32)
    _check("spdf", kop.spdf, (kop.Sp, kop.G), dev, torch.int32)
    _check("plan", kop.plan, (kop.G, 3 * kop.Sp + 2), dev, torch.int32)


def _kernel_modes(kop: BandedOp) -> tuple:
    return _modes(kop.Sp, len(kop.offsets), _words(kop.a0.dtype))


def fwd_sweep(kop: BandedOp, ext, mshift, save_alphas: bool = True):
    """K5a: the forward sweep over all Nf frames.  Same outputs as
    :func:`fwd_sweep_plain`.  ``ext`` and ``mshift`` in the operator's
    dtype.  The wide and global instantiations write the alphas
    graph-major, (Nf, G, Sp) in memory, returned as the (Nf, Sp, G) view
    of it (K5b reads either layout)."""
    if not _route(ext, "banded-scan"):
        return fwd_sweep_plain(kop, ext, mshift, save_alphas)
    from . import _build

    Nf, P1, G = ext.shape
    dev, dt = ext.device, kop.a0.dtype
    _check_op(kop, dev)
    _check("ext", ext, (Nf, kop.P1, kop.G), dev, dt)
    _check("mshift", mshift, (Nf, 1, kop.G), dev, dt)
    mode = _kernel_modes(kop)[0]
    gm = mode != NARROW
    meta = _imeta(kop, Nf, gm)
    alphas = None
    if save_alphas:
        shape = (Nf, G, kop.Sp) if gm else (Nf, kop.Sp, G)
        alphas = torch.empty(shape, device=dev, dtype=torch.float64)
    vfin, shift, ksum = (torch.empty(G, device=dev, dtype=torch.float64)
                         for _ in range(3))
    scratch = (torch.empty((G, 4 + len(kop.offsets), kop.Sp), device=dev,
                           dtype=torch.float64)
               if mode == GLOBAL else None)
    with torch.cuda.device(dev):  # the library launches on it
        rc = _build.library().mm_banded_fwd(
            _p(kop.a0), _p(kop.bf), _p(kop.om), _p(kop.fin), _p(kop.spdf),
            _p(kop.plan), _p(ext), _p(mshift),
            ctypes.c_void_p(meta.ctypes.data),
            _p(alphas) if save_alphas else None, _p(vfin), _p(shift),
            _p(ksum), None if scratch is None else _p(scratch),
            int(dt == torch.float64), _stream(dev),
        )
    _raise_on(rc, "mm_banded_fwd")
    _counts(dt)["banded_fwd"] += 1
    if gm and save_alphas:
        alphas = alphas.permute(0, 2, 1)
    return alphas, vfin, shift, ksum


def backward(kop: BandedOp, ext, alphas):
    """K5b: the reverse sweep and the pdf posteriors.  Same output as
    :func:`backward_plain` (each graph's pdf sums in its plan's order),
    in the operator's dtype.  ``alphas`` (Nf, Sp, G) contiguous, or the
    view of graph-major memory that the wide K5a returns (the narrow K5b
    reads a contiguous copy of that)."""
    if not _route(ext, "banded-scan"):
        return backward_plain(kop, ext, alphas)
    from . import _build

    Nf, P1, G = ext.shape
    dev, dt = ext.device, kop.a0.dtype
    _check_op(kop, dev)
    _check("ext", ext, (Nf, kop.P1, kop.G), dev, dt)
    mode = _kernel_modes(kop)[1]
    gm = mode != NARROW and not alphas.is_contiguous()
    if gm:
        _check("alphas (graph-major)", alphas.permute(0, 2, 1),
               (Nf, kop.G, kop.Sp), dev, torch.float64)
    else:
        alphas = alphas.contiguous()
        _check("alphas", alphas, (Nf, kop.Sp, kop.G), dev, torch.float64)
    meta = _imeta(kop, Nf, gm)
    # zeroed, then written
    posts = torch.empty((Nf, P1, G), device=dev, dtype=dt)
    scratch = (torch.empty((G, 6 + len(kop.offsets), kop.Sp), device=dev,
                           dtype=torch.float64)
               if mode == GLOBAL else None)
    with torch.cuda.device(dev):
        rc = _build.library().mm_banded_bwd(
            _p(kop.bb), _p(kop.om), _p(kop.fin), _p(kop.spdf), _p(kop.plan),
            _p(ext), _p(alphas), ctypes.c_void_p(meta.ctypes.data),
            _p(posts), None if scratch is None else _p(scratch),
            int(dt == torch.float64), _stream(dev),
        )
    _raise_on(rc, "mm_banded_bwd")
    _counts(dt)["banded_bwd"] += 1
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
    ext, mshift = prepare_emissions(lhs, lengths, P, cf.alpha_hat.dtype)
    alphas, vfin, shift, ksum = fwd_sweep(kop, ext, mshift, want_posts)
    if not want_posts:
        return None, vfin, shift, ksum
    return backward(kop, ext, alphas), vfin, shift, ksum
