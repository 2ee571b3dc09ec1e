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
  beta = y ⊙ e_t;
* K6t ``trop_sweep``: the tropical forward of the chunk-recompute Viterbi
  decode (``markovmodels_tpu/viterbi.py``'s ``_viterbi_scale`` on
  ``_trop_prob_matvec``, XLA there): y[j] = max_i Wp[j, i]·a[i], then the
  emission and the rescale as K6a, over one chunk of frames from a given
  state and scale, keeping every frame's state or a two-slot ring.  It is
  K6a's kernel with each FMA a multiply and a max (exact: the max does not
  depend on order, and an all-zero tile gives products of 0 against a state
  >= 0, as the dense Wp does).  Its operator is in the graph's dtype in
  every precision mode (:func:`trop_operator`): the JAX package reads
  ``dense_fwd_exp`` unrounded to bf16.

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

A float64 graph (``compile_fsm(dtype=torch.float64)``, which the JAX
package runs in XLA: its Pallas kernels take float32) takes each kernel's
float64 instantiation: the operators, states, scales, emissions, partial
sums and posteriors all float64, the column maxima on a double's 64 bits.
It is held to the float64 twins here; the JAX package's float64 'dense'
route rounds each frame's product to float32 (``preferred_element_type``).

A ``precision='bf16'`` graph keeps its operators in bf16 (half the bytes
streamed per frame) and multiplies them by the state rounded to bf16 on
the tensor cores, with float32 sums: the JAX kernels' single-pass
DEFAULT-precision product (``pallas_scan.py:55-59``, ``_mm``).  The
emission gather, the pdf sums and everything else stay float32, as the
TPU kernels' one-hot products do (``pallas_scan.py:146``, ``:190``,
``:193``).  The state is rounded unscaled; rounding commutes with the
power-of-two scale in the normal range, so it rounds the mantissas of the
scaled state the JAX kernel rounds.

Each kernel is one persistent, block-sparse launch per sweep: the host
plan (:func:`tile_plan`, built once per graph with the operator) packs the
operator's non-zero 32 x 32 tiles and cuts them into one range of equal
tile count per CTA; the CTAs keep their tiles in shared memory (or stream
them, where a range does not fit) and run the frame loop inside the kernel
with one grid barrier per frame.  A zero tile adds exact zeros to the
non-negative state, so the kernels compute the dense product up to
summation order; the plain twins stay the dense product.

The CUDA source is ``csrc/dense_scan.cu``; ``_build.py`` compiles it with
nvcc at first use.  Each wrapper takes its plain version for CPU tensors
and launches the kernel for CUDA tensors; anything else raises.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .block_scan import (_check, _kahan_step, _p, _pow2_exponent,
                         _pow2_scale, _raise_on, _route, _stream)
from .blocked import round_bf16

__all__ = [
    "dense_scan_reject_reason",
    "DenseOp",
    "TilePlan",
    "tile_plan",
    "dense_op",
    "kernel_operator",
    "fwd_sweep",
    "backward",
    "fwd_sweep_plain",
    "backward_plain",
    "dense_fused_fb",
    "trop_operator",
    "trop_sweep",
    "trop_sweep_plain",
    "smem_bytes",
    "LAUNCHES",
    "LAUNCHES_BF16",
    "LAUNCHES_F64",
    "reset_launch_counts",
]

# launches of each CUDA kernel entry point, counted by its wrapper: the
# float32 instantiations in LAUNCHES, the bf16 ones (a precision='bf16'
# graph's tensor-core product) in LAUNCHES_BF16, the float64 ones (a float64
# graph) in LAUNCHES_F64; K6t has no bf16 instantiation
LAUNCHES_BF16 = {"dense_fwd": 0, "dense_bwd": 0}
LAUNCHES = {**LAUNCHES_BF16, "dense_trop": 0}
LAUNCHES_F64 = dict(LAUNCHES)

_TILE = 32  # operator tile edge (TR = TK in csrc/dense_scan.cu)
_TILE_COLS = 128  # batch columns per column block (TB)
_CTAS_PER_SM = 2  # co-resident CTAs per SM of the persistent grid
_SMS = 132  # SMs of an H100 SXM: the plan's grid where there is no card


def reset_launch_counts():
    for counts in (LAUNCHES, LAUNCHES_BF16, LAUNCHES_F64):
        for k in counts:
            counts[k] = 0


def _counts(prec: int) -> dict:
    """The launch counter of an instantiation (:func:`_check_op`'s code)."""
    return (LAUNCHES, LAUNCHES_BF16, LAUNCHES_F64)[prec]


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

def _device_bytes(cf, B: int, n_frames: int) -> int:
    """Device bytes of one run beyond the compiled graph, every buffer
    sized by its dtype: the kernels' two (Sp, Sp) operators (bf16 for a
    bf16 graph, else the graph's dtype), every frame's state and scale
    (kept in full, as the TPU kernel keeps its alphas), the (Nf, P1, B)
    emission and posterior streams, the backward's beta pair and gamma, in
    the graph's dtype (float32, or float64)."""
    Sp, P1, Nf = cf.padded_states, cf.num_pdfs + 1, n_frames + 1
    f = cf.alpha_hat.element_size()
    op = 2 if cf.precision == "bf16" else f
    return (op * 2 * Sp * Sp
            + f * (Nf * (Sp + 1) * B + 2 * Nf * P1 * B + 3 * Sp * B))


def _free_bytes(device):
    """Free memory of a CUDA ``device``, or None where there is no card."""
    if (device is None or torch.device(device).type != "cuda"
            or not torch.cuda.is_available()):
        return None
    return torch.cuda.mem_get_info(torch.device(device))[0]


def dense_scan_reject_reason(cf, B: int, *, n_frames: int | None = None,
                             device=None, tropical: bool = False):
    """None when the CUDA dense scan accepts this graph at batch ``B``,
    else a one-line reason naming the FIRST rejected predicate.

    The predicates shared with the JAX package's
    ``_pallas_dense_reject_reason`` come first, in its order and words
    (strategy, domain, one-hot present, not batched, not multi-pdf), but
    for the dtype: float32 and float64 graphs both run (the TPU kernels
    take float32); precision 'bf16' with float64, which ``compile_fsm``
    refuses, is refused here too (ROADMAP queue 1 item 9's remainder).
    Its TPU rules (backend, the VMEM budget of ``pallas_scan_supported``)
    are not copied: each CTA keeps its range of the operator's non-zero
    tiles in shared memory where that fits (4.5 KB a tile in float32, 2 KB
    in bf16, 9 KB in float64, beside 34-82 KB of stages, :func:`smem_bytes`;
    at most 227 KB per CTA) and streams them every frame where it does not,
    so no operator is too large or too dense.  Instead the padded state
    count must be a multiple of the kernels' 32-row tile, and the device
    bytes of a run (``_device_bytes``) must fit the free memory of
    ``device`` when that is a CUDA device (checked where a card is
    present).  With ``tropical`` (the admission of K6t, the Viterbi
    sweep) the domain is not checked: the max recursion is exact under
    rescaling, and a log-domain graph compiles to the same arrays."""
    if cf.strategy != "dense":
        return f"strategy {cf.strategy!r} != 'dense'"
    if cf.domain != "prob" and not tropical:
        return f"domain {cf.domain!r} != 'prob'"
    if cf.pdf_onehot is None:
        return "no pdf one-hot reduction matrix"
    if cf.batched:
        return "batched CompiledFSM"
    if cf.multi_pdf:
        return "general multi-pdf C-hat"
    if cf.alpha_hat.dtype not in (torch.float32, torch.float64):
        dt = str(cf.alpha_hat.dtype).removeprefix("torch.")
        return f"operator dtype {dt} (the CUDA kernels are f32 or f64)"
    if cf.precision == "bf16" and cf.alpha_hat.dtype == torch.float64:
        return ("precision 'bf16' with dtype float64 (ROADMAP queue 1 item "
                "9, its remainder)")
    Sp = cf.padded_states
    if Sp % _TILE:
        return (f"padded states {Sp} not a multiple of the kernels' "
                f"{_TILE}-row tile")
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

class TilePlan(NamedTuple):
    """The host plan of one direction's operator for K6a/K6b (built by
    :func:`tile_plan`).  The operator's T non-zero 32 x 32 tiles, judged in
    the dtype the kernel reads, in (row tile, k tile) order; the list is
    cut into G contiguous ranges of equal tile count, one per CTA of the
    persistent grid.  A CTA walks its range as segments: the part of one
    row tile that lies in it, or a row tile without a non-zero tile."""
    # (T, 1024): float32 or float64 tiles row-major, or bf16 tiles in the
    # mma.sync m16n8k16 A-fragment order [row half][k half][lane][4 words]
    tiles: torch.Tensor
    tile_k: torch.Tensor  # (T,) int32 k tile of each packed tile
    # (Sp / 32 + 1,) int32: row tile r owns packed tiles [row_ptr[r],
    # row_ptr[r+1]), in increasing k
    row_ptr: torch.Tensor
    lo: torch.Tensor  # (G + 1,) int32: CTA c owns tiles [lo[c], lo[c+1])
    seg_ptr: torch.Tensor  # (G + 1,) int32: CTA c's segments
    # (segments, 4) int32: (row tile, first tile, end tile, partial slot);
    # slot -1: the row tile lies in this range alone
    segs: torch.Tensor
    # (Sp / 32, 2) int32: a straddling row tile's first partial slot and
    # its partials (one per range, added in range order); (-1, 0) otherwise
    rt_parts: torch.Tensor
    n_partials: int  # partial slots
    max_tiles: int  # the largest range


def tile_plan(w: torch.Tensor, n_ctas: int) -> TilePlan:
    """The plan of the (Sp, Sp) operator ``w`` (float32 or bf16) over a
    grid of ``n_ctas`` CTAs.  Built on ``w``'s device; the segment lists
    on the host."""
    Sp, T_ = w.shape[0], _TILE
    n = Sp // T_
    blocks = w.reshape(n, T_, n, T_).transpose(1, 2)  # (row, k, 32, 32)
    nz = (blocks != 0).any(dim=3).any(dim=2)
    rt_idx, kt_idx = torch.nonzero(nz, as_tuple=True)  # row-major order
    tiles = blocks[rt_idx, kt_idx]
    T = tiles.shape[0]
    if w.dtype == torch.bfloat16:
        # row = mb*16 + h*8 + g, col = ks*16 + c*8 + q*2 + e  ->
        # [mb][ks][lane = g*4 + q][register c*2 + h][e]
        tiles = tiles.reshape(T, 2, 2, 8, 2, 2, 4, 2).permute(
            0, 1, 4, 3, 6, 5, 2, 7)
    tiles = tiles.reshape(T, T_ * T_).contiguous()

    counts = nz.sum(dim=1).cpu().numpy()
    row_ptr = np.zeros(n + 1, np.int64)
    row_ptr[1:] = np.cumsum(counts)
    lo = np.arange(n_ctas + 1, dtype=np.int64) * T // n_ctas
    rt_of = np.repeat(np.arange(n), counts)
    segs = [[] for _ in range(n_ctas)]
    owners = [[] for _ in range(n)]  # (CTA, segment) per row tile, in order
    for c in range(n_ctas):
        a, b = int(lo[c]), int(lo[c + 1])
        for rt in (np.unique(rt_of[a:b]) if a < b else ()):
            owners[rt].append((c, len(segs[c])))
            segs[c].append([rt, max(a, row_ptr[rt]), min(b, row_ptr[rt + 1]),
                            -1])
    rt_parts = np.tile(np.array([-1, 0], np.int64), (n, 1))
    slot = 0
    for rt, own in enumerate(owners):
        if len(own) > 1:
            rt_parts[rt] = (slot, len(own))
            for k, (c, i) in enumerate(own):
                segs[c][i][3] = slot + k
            slot += len(own)
    for i, rt in enumerate(np.flatnonzero(counts == 0)):
        c = i % n_ctas
        segs[c].append([rt, lo[c + 1], lo[c + 1], -1])
    seg_ptr = np.zeros(n_ctas + 1, np.int64)
    seg_ptr[1:] = np.cumsum([len(x) for x in segs])
    flat = np.array([x for c in segs for x in c], np.int64).reshape(-1, 4)

    def i32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32,
                               device=w.device).contiguous()

    return TilePlan(tiles=tiles, tile_k=kt_idx.to(torch.int32).contiguous(),
                    row_ptr=i32(row_ptr), lo=i32(lo), seg_ptr=i32(seg_ptr),
                    segs=i32(flat), rt_parts=i32(rt_parts), n_partials=slot,
                    max_tiles=int(np.diff(lo).max()))


def smem_bytes(pl: TilePlan) -> tuple:
    """(resident, streaming): the dynamic shared memory of one CTA of the
    plan's launch, as csrc/dense_scan.cu's ``Layout::bytes`` counts it,
    with the largest range's tiles kept on chip, or streamed through the
    two-stage ring beside the state blocks.  A tile and a 32 x 128 state
    stage take 4 bytes a value in float32 and 8 in float64 (their rows
    padded by 4 values); bf16 tiles are packed fragments (2 KB), their
    stages bf16 row pairs, beside the float32 accumulator scratch."""
    if pl.tiles.dtype == torch.bfloat16:
        tile, stage = _TILE * _TILE * 2, _TILE // 2 * (_TILE_COLS + 8) * 4
        scr = _TILE * (_TILE_COLS + 4) * 4
    else:
        f = pl.tiles.element_size()
        tile, stage, scr = _TILE * (_TILE + 4) * f, _TILE * _TILE_COLS * f, 0
    return (pl.max_tiles * tile + 2 * stage + scr,
            2 * (stage + tile) + scr)


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
    pf: TilePlan  # the kernels' plans of wf and wb
    pb: TilePlan


def _grid(device) -> int:
    """CTAs of the persistent grid: _CTAS_PER_SM per SM of ``device``'s
    card, or of an H100 where ``device`` is no card."""
    if torch.device(device).type == "cuda":
        return _CTAS_PER_SM * torch.cuda.get_device_properties(
            device).multi_processor_count
    return _CTAS_PER_SM * _SMS


def dense_op(alpha0, wf, wb, spdf, real, P1: int, fin: int) -> DenseOp:
    """A DenseOp from its probability operators ``wf``/``wb`` (Sp, Sp),
    initial probabilities ``alpha0`` (Sp,), the pdf of each state ``spdf``
    (Sp,) and the indices ``real`` of the real states (the others are
    padding); the plans for the persistent grid of ``wf``'s device."""
    n_ctas = _grid(wf.device)
    spdf = spdf.to(torch.int32).contiguous()
    perm = real[torch.sort(spdf[real].long(), stable=True).indices]
    counts = torch.bincount(spdf[real].long(), minlength=P1)
    off = torch.zeros(P1 + 1, dtype=torch.int64, device=spdf.device)
    off[1:] = torch.cumsum(counts, 0)
    return DenseOp(Sp=wf.shape[0], P1=P1, fin=fin,
                   alpha0=alpha0.contiguous(), wf=wf.contiguous(),
                   wb=wb.contiguous(), spdf=spdf,
                   perm=perm.to(torch.int32).contiguous(),
                   off=off.to(torch.int32).contiguous(),
                   pf=tile_plan(wf, n_ctas), pb=tile_plan(wb, n_ctas))


def kernel_operator(cf) -> DenseOp:
    """The dense scan's operator of an unstacked 'dense' CompiledFSM, built
    once per graph (cached on it).  The probability operators fold
    exp(row_max) back into the exp-shifted matrices exactly as the JAX
    package's ``_fb_prob_pallas`` does (``inference.py:1327-1328``), in the
    graph's dtype (float32, or float64), and are stored in bf16 for a bf16
    graph; their plans judge the tiles in that dtype."""
    kop = cf._cache.get("dense_scan")
    if kop is None:
        wdt = (torch.bfloat16 if cf.precision == "bf16"
               else cf.alpha_hat.dtype)
        kop = dense_op(
            torch.exp(cf.alpha_hat),
            (torch.exp(cf.dense_fwd_max)[:, None]
             * cf.dense_fwd_exp).to(wdt),
            (torch.exp(cf.dense_bwd_max)[:, None]
             * cf.dense_bwd_exp).to(wdt),
            cf.state_pdf, torch.nonzero(cf.orig_state >= 0)[:, 0],
            cf.num_pdfs + 1, int(cf.final_state))
        cf._cache["dense_scan"] = kop
    return kop


def trop_operator(cf) -> DenseOp:
    """K6t's operator: the forward probability operator in the graph's
    dtype with its tile plan judged in that dtype, in every precision mode;
    for a float64 graph the operator that ``viterbi._sweeps``' plain branch
    builds.  For a 'high' graph (float32 or float64) that is
    :func:`kernel_operator`'s; a bf16 graph (float32) gets its own (cached),
    whose backward fields repeat the forward ones (K6t reads only the
    forward ones)."""
    if cf.precision != "bf16":
        return kernel_operator(cf)
    kop = cf._cache.get("dense_trop")
    if kop is None:
        wf = torch.exp(cf.dense_fwd_max)[:, None] * cf.dense_fwd_exp
        kop = dense_op(torch.exp(cf.alpha_hat), wf, wf, cf.state_pdf,
                       torch.nonzero(cf.orig_state >= 0)[:, 0],
                       cf.num_pdfs + 1, int(cf.final_state))
        cf._cache["dense_trop"] = kop
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


_TROP_ELEMS = 1 << 22  # (Sp, Sp, columns) products per step of the twin


def _trop_product(w, a):
    """y[j, b] = max_i w[j, i]·a[i, b] (each product one float32
    rounding), a few columns at a time so that the (Sp, Sp, columns)
    products stay under _TROP_ELEMS elements."""
    Sp, B = a.shape
    step = max(1, _TROP_ELEMS // max(w.numel(), 1))
    return torch.cat([(w[:, :, None] * a[None, :, c0 : c0 + step]).amax(dim=1)
                      for c0 in range(0, B, step)], dim=1)


def trop_sweep_plain(kop: DenseOp, a0, s0, ext, mshift, *, first: bool,
                     save: bool = True, acc=None):
    """Plain twin of K6t over the Nf frames of ``ext`` (Nf, P1, B) and
    ``mshift`` (Nf, 1, B) from ``a0`` (Sp, B) unscaled with its scale
    ``s0`` (B,).  Frame 0 skips the product when ``first`` (the decode's
    global frame 0: y = a0 ⊙ e, ``s0`` then 1).  ``acc`` (3, B): ksum,
    shift and its Kahan compensation, carried on in place (zeros when
    None).  Returns (states (Nf, Sp, B) unscaled or None, scales (Nf, B)
    or None, a_last (Sp, B), s_last (B,), acc)."""
    Nf, _, B = ext.shape
    spdf = kop.spdf.long()
    acc = a0.new_zeros((3, B)) if acc is None else acc
    states = a0.new_empty((Nf, kop.Sp, B)) if save else None
    scales = a0.new_empty((Nf, B)) if save else None
    a, s = a0, s0
    for t in range(Nf):
        e = ext[t].index_select(0, spdf)
        y = (a * e if first and t == 0
             else _trop_product(kop.wf, a) * s[None, :] * e)
        k = _pow2_exponent(y.amax(dim=0))
        a, s = y, _pow2_scale(k)
        if save:
            states[t], scales[t] = a, s
        _kahan_step(acc, k, mshift[t, 0])
    return states, scales, a, s, acc


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_PREC = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def _value_dtype(prec: int):
    """The dtype of every value of a launch of instantiation ``prec``."""
    return torch.float64 if prec == 2 else torch.float32


def _check_op(kop: DenseOp, dev):
    """The operator's tensors and plans; returns the instantiation code the
    entry points take: 0 float32, 1 bf16 operators (the tensor-core
    product, float32 values), 2 float64 throughout."""
    wdt = kop.wf.dtype
    if wdt not in _PREC:
        raise ValueError(f"wf: operator dtype {wdt} (the kernels take "
                         "float32, bfloat16 or float64)")
    prec = _PREC[wdt]
    _check("alpha0", kop.alpha0, (kop.Sp,), dev, _value_dtype(prec))
    for name, t in (("wf", kop.wf), ("wb", kop.wb)):
        _check(name, t, (kop.Sp, kop.Sp), dev, wdt)
    for name, t, shape in (("spdf", kop.spdf, (kop.Sp,)),
                           ("perm", kop.perm, tuple(kop.perm.shape)),
                           ("off", kop.off, (kop.P1 + 1,))):
        _check(name, t, shape, dev, torch.int32)
    n_rt = kop.Sp // _TILE
    for d, pl in (("pf", kop.pf), ("pb", kop.pb)):
        T, G = pl.tile_k.numel(), pl.lo.numel() - 1
        _check(f"{d}.tiles", pl.tiles, (T, _TILE * _TILE), dev, wdt)
        for name, t, shape in (("tile_k", pl.tile_k, (T,)),
                               ("lo", pl.lo, (G + 1,)),
                               ("seg_ptr", pl.seg_ptr, (G + 1,)),
                               ("segs", pl.segs, (pl.segs.shape[0], 4)),
                               ("rt_parts", pl.rt_parts, (n_rt, 2))):
            _check(f"{d}.{name}", t, shape, dev, torch.int32)
    return prec


def _plan_args(pl: TilePlan):
    return (_p(pl.tiles), _p(pl.tile_k), _p(pl.lo), _p(pl.seg_ptr),
            _p(pl.segs), _p(pl.rt_parts), pl.lo.numel() - 1, pl.max_tiles)


def _cm_offset(Sp: int, B: int, prec: int) -> int:
    """The int32 word where the sync buffer's three column-max rows start:
    after the barrier's two words and the row tiles' tickets, at the next
    even word for float64 (its rows are 64-bit words)."""
    base = 2 + Sp // _TILE * -(-B // _TILE_COLS)
    return base + base % 2 if prec == 2 else base


def _scratch(kop: DenseOp, pl: TilePlan, B: int, prec: int, dev):
    """(partial, zeroed sync words, bf16 state pairs or None) of one
    launch: the plan's partial slots in the values' dtype; the barrier,
    the row tiles' tickets and three column-max rows (32-bit words, 64-bit
    in float64)."""
    partial = torch.empty((max(pl.n_partials, 1), _TILE, B), device=dev,
                          dtype=_value_dtype(prec))
    rows = 6 * B if prec == 2 else 3 * B
    sync = torch.zeros(_cm_offset(kop.Sp, B, prec) + rows, dtype=torch.int32,
                       device=dev)
    xb = (_p(torch.empty((2, kop.Sp // 2, B), dtype=torch.int32, device=dev))
          if prec == 1 else None)
    return partial, sync, xb


def fwd_sweep(kop: DenseOp, a0, ext, mshift, save_alphas: bool = True):
    """K6a: the forward sweep over all Nf frames, one launch.  Same
    outputs as :func:`fwd_sweep_plain`."""
    if not _route(ext, "dense-scan"):
        return fwd_sweep_plain(kop, a0, ext, mshift, save_alphas)
    from . import _build

    Nf, P1, B = ext.shape
    Sp, dev = kop.Sp, ext.device
    prec = _check_op(kop, dev)
    vdt = _value_dtype(prec)
    _check("a0", a0, (Sp, B), dev, vdt)
    _check("ext", ext, (Nf, kop.P1, B), dev, vdt)
    _check("mshift", mshift, (Nf, 1, B), dev, vdt)
    slots = Nf if save_alphas else 2  # every frame, or a ping-pong pair
    states = torch.empty((slots, Sp, B), device=dev, dtype=vdt)
    scales = torch.empty((slots, B), device=dev, dtype=vdt)
    ksum, shift, comp = (torch.zeros(B, device=dev, dtype=vdt)
                         for _ in range(3))
    partial, sync, xb = _scratch(kop, kop.pf, B, prec, dev)
    with torch.cuda.device(dev):  # the library launches on it
        rc = _build.library().mm_dense_fwd(
            *_plan_args(kop.pf), _p(kop.spdf), _p(a0), _p(ext), _p(mshift),
            Sp, kop.P1, B, Nf, slots, prec, _p(states), _p(scales),
            _p(ksum), _p(shift), _p(comp), _p(partial), _p(sync), xb,
            _stream(dev),
        )
    _raise_on(rc, "mm_dense_fwd")
    _counts(prec)["dense_fwd"] += 1
    last = (Nf - 1) % slots
    return (states if save_alphas else None,
            scales if save_alphas else None,
            states[last], scales[last], ksum, shift)


def backward(kop: DenseOp, ext, alphas, ascale):
    """K6b: the reverse sweep and the pdf posteriors, one launch.  Same
    output as :func:`backward_plain`."""
    if not _route(ext, "dense-scan"):
        return backward_plain(kop, ext, alphas, ascale)
    from . import _build

    Nf, P1, B = ext.shape
    Sp, dev = kop.Sp, ext.device
    prec = _check_op(kop, dev)
    vdt = _value_dtype(prec)
    _check("ext", ext, (Nf, kop.P1, B), dev, vdt)
    _check("alphas", alphas, (Nf, Sp, B), dev, vdt)
    _check("ascale", ascale, (Nf, B), dev, vdt)
    work = torch.empty((2, Sp, B), device=dev, dtype=vdt)
    gamma = torch.empty((2, Sp, B), device=dev, dtype=vdt)
    # every entry written
    posts = torch.empty((Nf, P1, B), device=dev, dtype=vdt)
    part = torch.empty((2, Sp // _TILE, B), device=dev, dtype=vdt)
    partial, sync, xb = _scratch(kop, kop.pb, B, prec, dev)
    with torch.cuda.device(dev):
        rc = _build.library().mm_dense_bwd(
            *_plan_args(kop.pb), _p(kop.spdf), _p(kop.perm), _p(kop.off),
            _p(ext), _p(alphas), _p(ascale), Sp, kop.P1, B, Nf, prec,
            _p(work), _p(gamma), _p(posts), _p(part), _p(partial), _p(sync),
            xb, _stream(dev),
        )
    _raise_on(rc, "mm_dense_bwd")
    _counts(prec)["dense_bwd"] += 1
    return posts


def trop_sweep(kop: DenseOp, a0, s0, ext, mshift, *, first: bool,
               save: bool = True, acc=None):
    """K6t: the tropical forward over the Nf frames of ``ext``, one launch.
    Same arguments and outputs as :func:`trop_sweep_plain`; ``kop`` is
    :func:`trop_operator`'s (float32, or float64 for a float64 graph)."""
    if not _route(ext, "dense-tropical-sweep"):
        return trop_sweep_plain(kop, a0, s0, ext, mshift, first=first,
                                save=save, acc=acc)
    from . import _build

    Nf, P1, B = ext.shape
    Sp, dev = kop.Sp, ext.device
    prec = _check_op(kop, dev)
    if prec == 1:
        raise ValueError("K6t takes a float32 or float64 operator "
                         "(trop_operator)")
    vdt = _value_dtype(prec)
    _check("a0", a0, (Sp, B), dev, vdt)
    _check("s0", s0, (B,), dev, vdt)
    _check("ext", ext, (Nf, kop.P1, B), dev, vdt)
    _check("mshift", mshift, (Nf, 1, B), dev, vdt)
    acc = torch.zeros((3, B), device=dev, dtype=vdt) if acc is None else acc
    _check("acc", acc, (3, B), dev, vdt)
    slots = Nf if save else 2
    states = torch.empty((slots, Sp, B), device=dev, dtype=vdt)
    scales = torch.empty((slots, B), device=dev, dtype=vdt)
    partial, sync, _ = _scratch(kop, kop.pf, B, prec, dev)
    if not first:
        # the column max the first frame reads (the third row, as the
        # value's bits): 1 / s0, whose scale is s0
        w = 2 if prec == 2 else 1  # int32 words per value
        at = _cm_offset(Sp, B, prec) + 2 * B * w
        sync[at : at + B * w] = (1.0 / s0).view(torch.int32)
    with torch.cuda.device(dev):
        rc = _build.library().mm_dense_trop(
            *_plan_args(kop.pf), _p(kop.spdf), _p(a0), _p(ext), _p(mshift),
            Sp, kop.P1, B, Nf, slots, int(first), int(prec == 2),
            _p(states), _p(scales), _p(acc[0]), _p(acc[1]), _p(acc[2]),
            _p(partial), _p(sync), _stream(dev),
        )
    _raise_on(rc, "mm_dense_trop")
    _counts(prec)["dense_trop"] += 1
    last = (Nf - 1) % slots
    return (states if save else None, scales if save else None,
            states[last], scales[last], acc)


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
