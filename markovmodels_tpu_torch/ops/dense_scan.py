"""Dense forward-backward on the GPU: hand-written CUDA kernels with plain
PyTorch twins.

Counterpart of ``markovmodels_tpu/ops/pallas_scan.py`` and of the JAX
package's ``_fb_prob_pallas`` (``inference.py:1314``).  One shared 'dense'
graph (every graph of up to 4,096 states under ``compile_fsm``'s 'auto'
rule, e.g. an LF-MMI denominator) runs over a (Sp, B) probability state:

* K6a ``fwd_sweep``: the forward sweep over all Nf = N + 1 frames (replaces
  ``fused_forward``'s ``pallas_call``, ``_make_fwd_kernel``).  Per frame
  a' = (Wp @ a) ⊙ e_t with e_t[s, b] = ext[t, pdf(s), b], an exact
  power-of-two rescale per column, the sum of the exponents and the
  Kahan-compensated emission shift; frame 0 skips the product.  It keeps
  every frame's state for the backward, or only a two-slot ring when no
  posteriors are wanted (the TPU kernel's 1-frame alpha ring);
* K6b ``backward``: the reverse sweep (replaces ``fused_backward``'s
  ``pallas_call``, ``_make_bwd_kernel``): y = Wp_b @ beta (ones at the last
  frame), gamma = alpha ⊙ y, the per-frame pdf posteriors (Ĉᵀγ) / Σγ, and
  beta = y ⊙ e_t.

The TPU kernels' one-hot matrices (``OH_state @ ext_t`` and ``oh_pdf @ γ``)
are a TPU device for a gather and a segment sum.  Here the emission is a
gather by the state->pdf map, and the pdf sums run over each pdf's states in
increasing state order (a CSR list built once per graph): deterministic,
no atomics.

State convention shared by kernels and twins (that of ops/block_scan.py):
a state is stored unscaled together with a per-column power-of-two scale
``s`` (B,), applied when the next frame reads it.  Power-of-two scaling is
exact, so the normalised values equal those of rescaling in place.  The
backward rescales beta = y ⊙ e by the power of two below its column max,
where the TPU kernel divides y by its column max before the emission; the
posteriors are normalised per frame, so both give the same posteriors up
to rounding.

A ``precision='bf16'`` graph keeps its operators in bf16 (half the bytes
streamed per frame) and multiplies them by the state rounded to bf16 on
the tensor cores, with float32 sums: the JAX kernels' single-pass
DEFAULT-precision product (``pallas_scan.py:55-59``, ``_mm``).  The
emission gather, the pdf sums and everything else stay float32, as the
TPU kernels' one-hot products do (``pallas_scan.py:146``, ``:190``,
``:193``).  The state is rounded unscaled; rounding commutes with the
power-of-two scale in the normal range, so it rounds the mantissas of the
scaled state the JAX kernel rounds.

The CUDA source is ``csrc/dense_scan.cu``; ``_build.py`` compiles it with
nvcc at first use.  Each wrapper takes its plain version for CPU tensors
and launches the kernel for CUDA tensors; anything else raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .block_scan import (_check, _p, _pow2_exponent, _pow2_scale, _raise_on,
                         _route, _stream)
from .blocked import round_bf16

__all__ = [
    "make_dense_operator",
    "dense_scan_reject_reason",
    "DenseOp",
    "kernel_operator",
    "fwd_sweep",
    "backward",
    "fwd_sweep_plain",
    "backward_plain",
    "dense_fused_fb",
    "LAUNCHES",
    "LAUNCHES_BF16",
    "reset_launch_counts",
]

# launches of each CUDA kernel entry point, counted by its wrapper: the
# float32 instantiations in LAUNCHES, the bf16 ones (a precision='bf16'
# graph's tensor-core product) in LAUNCHES_BF16
LAUNCHES = {"dense_fwd": 0, "dense_bwd": 0}
LAUNCHES_BF16 = dict(LAUNCHES)

_TILE_ROWS = 32  # operator rows per CTA (TR in csrc/dense_scan.cu)
_TILE_COLS = 128  # batch columns per CTA (TB)
_TILE_K = 32  # contraction depth per shared-memory stage (TK)
_MAX_SPLIT = 8  # contraction parts per row tile


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = LAUNCHES_BF16[k] = 0


def make_dense_operator(dense_w: torch.Tensor):
    """The exp-shifted operator of the dense strategy (the JAX package's
    ``semiring_ops.make_dense_operator``).  ``dense_w``: (S, S) float32 log
    weights, -inf for absent arcs, contracted over axis 1 (W[j, i] = weight
    of arc i -> j forward).  Returns (exp_w, row_max): exp_w = exp(W -
    row_max) with 0 for absent arcs, row_max = -inf for an empty row."""
    row_max = dense_w.amax(dim=1)
    safe = torch.where(torch.isfinite(row_max), row_max,
                       torch.zeros_like(row_max))
    exp_w = torch.where(torch.isfinite(dense_w),
                        torch.exp(dense_w - safe[:, None]),
                        torch.zeros_like(dense_w))
    return exp_w, row_max


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

def _device_bytes(cf, B: int, n_frames: int) -> int:
    """Device bytes of one run beyond the compiled graph: the kernels' two
    (Sp, Sp) operators (bf16 for a bf16 graph, else float32), every
    frame's state and scale (kept in full, as the TPU kernel keeps its
    alphas), the (Nf, P1, B) emission and posterior streams, the
    backward's beta pair and gamma, all float32."""
    Sp, P1, Nf = cf.padded_states, cf.num_pdfs + 1, n_frames + 1
    op = 2 if cf.precision == "bf16" else 4
    return (op * 2 * Sp * Sp
            + 4 * (Nf * (Sp + 1) * B + 2 * Nf * P1 * B + 3 * Sp * B))


def _free_bytes(device):
    """Free memory of a CUDA ``device``, or None where there is no card."""
    if (device is None or torch.device(device).type != "cuda"
            or not torch.cuda.is_available()):
        return None
    return torch.cuda.mem_get_info(torch.device(device))[0]


def dense_scan_reject_reason(cf, B: int, *, n_frames: int | None = None,
                             device=None):
    """None when the CUDA dense scan accepts this graph at batch ``B``,
    else a one-line reason naming the FIRST rejected predicate.

    The predicates shared with the JAX package's
    ``_pallas_dense_reject_reason`` come first, in its order and words
    (strategy, domain, one-hot present, not batched, not multi-pdf,
    float32).  Its TPU rules (backend, the VMEM budget of
    ``pallas_scan_supported``) are not copied: the operator streams from
    device memory every frame, and the kernels' shared memory (41 KB per
    CTA) does not depend on the graph or the batch.  Instead the padded
    state count must be a multiple of the kernels' 32-row tile, and the
    device bytes of a run (``_device_bytes``) must fit the free memory of
    ``device`` when that is a CUDA device (checked where a card is
    present)."""
    if cf.strategy != "dense":
        return f"strategy {cf.strategy!r} != 'dense'"
    if cf.domain != "prob":
        return f"domain {cf.domain!r} != 'prob'"
    if cf.pdf_onehot is None:
        return "no pdf one-hot reduction matrix"
    if cf.batched:
        return "batched CompiledFSM"
    if cf.multi_pdf:
        return "general multi-pdf C-hat"
    if cf.alpha_hat.dtype != torch.float32:
        dt = str(cf.alpha_hat.dtype).removeprefix("torch.")
        return f"operator dtype {dt} (the CUDA kernels are f32)"
    Sp = cf.padded_states
    if Sp % _TILE_ROWS or Sp % _TILE_K:
        return (f"padded states {Sp} not a multiple of the kernels' "
                f"{_TILE_ROWS}-row tile")
    free = _free_bytes(device)
    if free is not None and n_frames is not None:
        need = _device_bytes(cf, B, n_frames)
        if need > free:
            return (f"device memory: operators, states and streams "
                    f"~{need / 1e9:.1f} GB exceed the card's "
                    f"{free / 1e9:.1f} GB free (Sp = {Sp}, B = {B}, "
                    f"N = {n_frames})")
    return None


# ---------------------------------------------------------------------------
# the kernels' operator
# ---------------------------------------------------------------------------

class DenseOp(NamedTuple):
    Sp: int
    P1: int  # pdfs + 1 (the phony pdf last)
    fin: int  # phony final state
    alpha0: torch.Tensor  # (Sp,) initial probabilities
    # (Sp, Sp) probability operator, y = wf @ a forward; float32, or bf16
    # for a precision='bf16' graph
    wf: torch.Tensor
    wb: torch.Tensor  # (Sp, Sp) its backward counterpart, the same dtype
    spdf: torch.Tensor  # (Sp,) int32 pdf of each state
    # the real states sorted by pdf (stable), int32; padding states, whose
    # alpha is always 0, are left out of the pdf sums
    perm: torch.Tensor
    off: torch.Tensor  # (P1 + 1,) int32: pdf p owns perm[off[p]:off[p+1]]


def kernel_operator(cf) -> DenseOp:
    """The dense scan's operator of an unstacked 'dense' CompiledFSM, built
    once per graph (cached on it).  The probability operators fold
    exp(row_max) back into the exp-shifted matrices exactly as the JAX
    package's ``_fb_prob_pallas`` does (``inference.py:1327-1328``), and
    are stored in bf16 for a bf16 graph."""
    kop = cf._cache.get("dense_scan")
    if kop is None:
        wdt = torch.bfloat16 if cf.precision == "bf16" else torch.float32
        spdf = cf.state_pdf.to(torch.int32)
        P1 = cf.num_pdfs + 1
        real = torch.nonzero(cf.orig_state >= 0)[:, 0]
        perm = real[torch.sort(spdf[real].long(), stable=True).indices]
        counts = torch.bincount(spdf[real].long(), minlength=P1)
        off = torch.zeros(P1 + 1, dtype=torch.int64, device=cf.device)
        off[1:] = torch.cumsum(counts, 0)
        kop = DenseOp(
            Sp=cf.padded_states,
            P1=P1,
            fin=int(cf.final_state),
            alpha0=torch.exp(cf.alpha_hat).contiguous(),
            wf=(torch.exp(cf.dense_fwd_max)[:, None]
                * cf.dense_fwd_exp).to(wdt).contiguous(),
            wb=(torch.exp(cf.dense_bwd_max)[:, None]
                * cf.dense_bwd_exp).to(wdt).contiguous(),
            spdf=spdf.contiguous(),
            perm=perm.to(torch.int32).contiguous(),
            off=off.to(torch.int32).contiguous(),
        )
        cf._cache["dense_scan"] = kop
    return kop


# ---------------------------------------------------------------------------
# plain PyTorch twins (the kernels' reference)
# ---------------------------------------------------------------------------

def _product(w):
    """a -> w @ a in float32: with a bf16 operator, the state is rounded to
    bf16 too (the kernels' tensor-core product)."""
    if w.dtype == torch.bfloat16:
        wf = w.float()
        return lambda a: wf @ round_bf16(a)
    return lambda a: w @ a


def fwd_sweep_plain(kop: DenseOp, a0, ext, mshift, save_alphas: bool = True):
    """Plain twin of K6a over all Nf frames of ``ext`` (Nf, P1, B) and
    ``mshift`` (Nf, 1, B) from ``a0`` (Sp, B).  Returns (alphas (Nf, Sp, B)
    unscaled or None, ascale (Nf, B) or None, a_last (Sp, B), s_last (B,),
    ksum (B,), shift (B,)): logZ = log(a_last[fin] · s_last) + ksum·ln2 +
    shift."""
    Nf, _, B = ext.shape
    spdf = kop.spdf.long()
    alphas = a0.new_empty((Nf, kop.Sp, B)) if save_alphas else None
    ascale = a0.new_empty((Nf, B)) if save_alphas else None
    a, s = a0, a0.new_ones(B)
    ksum, shift, comp = (a0.new_zeros(B) for _ in range(3))
    prod = _product(kop.wf)
    for t in range(Nf):
        e = ext[t].index_select(0, spdf)
        y = a * e if t == 0 else prod(a) * s[None, :] * e
        k = _pow2_exponent(y.amax(dim=0))
        a, s = y, _pow2_scale(k)
        if save_alphas:
            alphas[t], ascale[t] = a, s
        ksum = ksum + k
        # Kahan-compensated accumulation of the factored emission shift
        xc = mshift[t, 0] - comp
        tsum = shift + xc
        comp = (tsum - shift) - xc
        shift = tsum
    return alphas, ascale, a, s, ksum, shift


def backward_plain(kop: DenseOp, ext, alphas, ascale):
    """Plain twin of K6b: frames Nf-1 .. 0 from beta = 1 over the forward's
    ``alphas`` (Nf, Sp, B) with their scales ``ascale`` (Nf, B).  Returns
    posts (Nf, P1, B): gamma = alpha ⊙ y summed per pdf over its state sum
    (0 where that is 0)."""
    Nf, P1, B = ext.shape
    spdf = kop.spdf.long()
    posts = ext.new_empty((Nf, P1, B))
    b = s = None
    prod = _product(kop.wb)
    for t in reversed(range(Nf)):
        y = (torch.ones_like(alphas[t]) if t == Nf - 1
             else prod(b) * s[None, :])
        g = alphas[t] * ascale[t][None, :] * y
        sums = g.new_zeros((P1, B)).index_add_(0, spdf, g)
        tot = g.sum(dim=0)
        posts[t] = sums / torch.where(tot > 0, tot, torch.ones_like(tot))
        b = y * ext[t].index_select(0, spdf)
        s = _pow2_scale(_pow2_exponent(b.amax(dim=0)))
    return posts


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_op(kop: DenseOp, dev):
    """The operator's tensors; returns 1 for bf16 operators (the
    tensor-core product), 0 for float32 ones."""
    _check("alpha0", kop.alpha0, (kop.Sp,), dev)
    wdt = kop.wf.dtype
    if wdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"wf: operator dtype {wdt} (the kernels take "
                         "float32 or bfloat16)")
    for name, t in (("wf", kop.wf), ("wb", kop.wb)):
        _check(name, t, (kop.Sp, kop.Sp), dev, wdt)
    for name, t, shape in (("spdf", kop.spdf, (kop.Sp,)),
                           ("perm", kop.perm, tuple(kop.perm.shape)),
                           ("off", kop.off, (kop.P1 + 1,))):
        _check(name, t, shape, dev, torch.int32)
    return int(wdt == torch.bfloat16)


def _split_k(Sp: int, B: int, n_sm: int) -> int:
    """Contraction parts per row tile (split-K): the count, at most
    _MAX_SPLIT with at least 4 stages of _TILE_K terms per part, whose CTAs
    fill whole waves of one CTA per SM best; the smallest on a tie.  At
    Sp = 3,200, B = 128 on 132 SMs: 5 parts, 500 CTAs."""
    tiles = Sp // _TILE_ROWS * -(-B // _TILE_COLS)
    stages = Sp // _TILE_K
    best, best_fill = 1, 0.0
    for parts in range(1, _MAX_SPLIT + 1):
        if stages // parts < 4:
            break
        n = tiles * parts
        fill = n / (-(-n // n_sm) * n_sm)
        if fill > best_fill + 1e-9:
            best, best_fill = parts, fill
    return best


def _split_buffers(Sp: int, B: int, dev):
    """(parts, partial products, zeroed tickets) of the step kernels."""
    parts = _split_k(Sp, B,
                     torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty((parts, Sp, B) if parts > 1 else (1,), device=dev)
    tickets = torch.zeros(Sp // _TILE_ROWS * -(-B // _TILE_COLS),
                          dtype=torch.int32, device=dev)
    return parts, partial, tickets


def fwd_sweep(kop: DenseOp, a0, ext, mshift, save_alphas: bool = True):
    """K6a: the forward sweep over all Nf frames.  Same outputs as
    :func:`fwd_sweep_plain`."""
    if not _route(ext, "dense-scan"):
        return fwd_sweep_plain(kop, a0, ext, mshift, save_alphas)
    from . import _build

    Nf, P1, B = ext.shape
    Sp, dev = kop.Sp, ext.device
    bf16 = _check_op(kop, dev)
    _check("a0", a0, (Sp, B), dev)
    _check("ext", ext, (Nf, kop.P1, B), dev)
    _check("mshift", mshift, (Nf, 1, B), dev)
    slots = Nf if save_alphas else 2  # every frame, or a ping-pong pair
    states = torch.empty((slots, Sp, B), device=dev)
    scales = torch.empty((slots, B), device=dev)
    ksum, shift, comp = (torch.zeros(B, device=dev) for _ in range(3))
    part = torch.empty((Sp // _TILE_ROWS, B), device=dev)
    parts, partial, tickets = _split_buffers(Sp, B, dev)
    with torch.cuda.device(dev):  # the library launches on it
        rc = _build.library().mm_dense_fwd(
            _p(kop.wf), _p(kop.spdf), _p(a0), _p(ext), _p(mshift), Sp,
            kop.P1, B, Nf, slots, parts, bf16, _p(states), _p(scales),
            _p(ksum), _p(shift), _p(comp), _p(part), _p(partial),
            _p(tickets), _stream(dev),
        )
    _raise_on(rc, "mm_dense_fwd")
    (LAUNCHES_BF16 if bf16 else LAUNCHES)["dense_fwd"] += 1
    last = (Nf - 1) % slots
    return (states if save_alphas else None,
            scales if save_alphas else None,
            states[last], scales[last], ksum, shift)


def backward(kop: DenseOp, ext, alphas, ascale):
    """K6b: the reverse sweep and the pdf posteriors.  Same output as
    :func:`backward_plain`."""
    if not _route(ext, "dense-scan"):
        return backward_plain(kop, ext, alphas, ascale)
    from . import _build

    Nf, P1, B = ext.shape
    Sp, dev = kop.Sp, ext.device
    bf16 = _check_op(kop, dev)
    _check("ext", ext, (Nf, kop.P1, B), dev)
    _check("alphas", alphas, (Nf, Sp, B), dev)
    _check("ascale", ascale, (Nf, B), dev)
    work = torch.empty((2, Sp, B), device=dev)
    bscale = torch.empty((2, B), device=dev)
    gamma = torch.empty((Sp, B), device=dev)
    posts = torch.empty((Nf, P1, B), device=dev)  # every entry written
    part = torch.empty((2, Sp // _TILE_ROWS, B), device=dev)
    parts, partial, tickets = _split_buffers(Sp, B, dev)
    with torch.cuda.device(dev):
        rc = _build.library().mm_dense_bwd(
            _p(kop.wb), _p(kop.spdf), _p(kop.perm), _p(kop.off), _p(ext),
            _p(alphas), _p(ascale), Sp, kop.P1, B, Nf, parts, bf16, _p(work),
            _p(bscale), _p(gamma), _p(posts), _p(part), _p(partial),
            _p(tickets), _stream(dev),
        )
    _raise_on(rc, "mm_dense_bwd")
    (LAUNCHES_BF16 if bf16 else LAUNCHES)["dense_bwd"] += 1
    return posts


# ---------------------------------------------------------------------------
# the fused scan
# ---------------------------------------------------------------------------

def dense_fused_fb(cf, ext, mshift, want_posts: bool):
    """Run the dense scan.  ``ext``/``mshift`` from
    ops.emissions.prepare_emissions ((Nf, P1, B) / (Nf, 1, B)).  Returns
    (posts (Nf, P1, B) or None, v_final (B,), shift (B,), ksum (B,)):
    logZ = log(v_final) + ksum·ln2 + shift.  As in the JAX package's fused
    path every frame's state is kept for the backward (no chunking); a
    forward-only run keeps none."""
    Nf, P1, B = ext.shape
    reason = dense_scan_reject_reason(cf, B, n_frames=Nf - 1,
                                      device=ext.device)
    if reason is not None:
        raise ValueError(f"dense scan rejected this graph: {reason}")
    kop = kernel_operator(cf)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    alphas, ascale, a_last, s_last, ksum, shift = fwd_sweep(
        kop, a0, ext, mshift, save_alphas=want_posts)
    vfin = a_last[kop.fin] * s_last
    if not want_posts:
        return None, vfin, shift, ksum
    return backward(kop, ext, alphas, ascale), vfin, shift, ksum
