"""Fused tropical Viterbi sweep (K7) and the backtrace walk on the GPU:
hand-written CUDA kernels with plain PyTorch twins.

Counterpart of ``_make_vit_kernel`` / ``vit_scan_supported`` /
``block_fused_viterbi_fwd`` in ``markovmodels_tpu/ops/pallas_block.py`` and
of the walk of ``markovmodels_tpu/viterbi.py``'s ``_viterbi_scale_bp``.
One shared 'block' graph (the 2M-arc denominator) runs over a (Sp, B)
probability state in the max-product semiring:

* K7 ``viterbi_fwd``: one forward sweep over all frames, one persistent
  cooperative launch whose CTAs take every frame's work items from the
  queue of :func:`vit_plan`.  Per frame and main-region state [0, R·W) it
  records the winning uint8 candidate id (< Sm: tier source position,
  Sm + oi: band offset oi, 255: no incoming mass), per frame the argmax
  source of the rank-1 ω arcs into the phony final state, and at the end
  the final value, the Kahan-compensated emission shift and the
  power-of-two exponent sum;
* ``walk``: the backtrace, one thread per sequence, decoding the ids to
  source states through the tier's destination inverse and the band
  offsets (the JAX package leaves this walk to XLA).

and for the chunk-recompute decode (``markovmodels_tpu/viterbi.py``'s
``_viterbi_scale``, XLA there), which takes every 'dense' graph and the
'block' graphs the compressed-backpointer decode refuses:

* K7n ``viterbi_fwd(..., ids=False)``: K7 without the ids (the tier keeps
  its max only, no id and no ω argmax stored), from a given state and
  scale at a given global frame, saving every frame's state (a chunk's
  recompute) or every stride-th one (the first sweep's checkpoints), the
  phony row included, unscaled with its scale.  Its twin is also the CPU
  route for any 'block' graph, multi-tier ones included;
* W2 ``rec_walk``: the walk of one chunk, one warp per sequence: the state
  of frame t is the best in-arc source of the state of frame t + 1 under
  the frame's alphas (log α + w over the dst-sorted edge list, ties to the
  largest position), the ω arc's source at t = L - 1, the phony state past
  the length.  Shared with the 'dense' decode (ops/dense_scan.py K6t).

The CUDA sources are ``csrc/vit_scan.cu``; ``_build.py`` compiles them with
nvcc at first use.  Each wrapper takes its plain twin for CPU tensors and
launches the kernel for CUDA tensors; anything else raises.

Values: the state is stored unscaled with a per-column power-of-two scale
applied when the next frame reads it, as in K2 (ops/block_scan.py).  The
read gives exactly K7's rescaled state (a product by a power of two is
exact), so the products, and hence the ids, are K7's.  The exponent comes
from the float's exponent bits (``frexp``); the JAX kernel's
``floor(log2 m)`` may differ by one next to a power of two, which moves
only where the scale sits (compare scores, not ``ksum``).

The kernel finds each tier output's max before its id: the value-only max
over groups of g consecutive source positions (g = 8, the library's
``mm_vit_layout``), the running value
and group moving only where a group's max is strictly greater, then the
first position of the winning group whose product equals the max.  It
gives the ids of "strict >, smallest position among equal maxima" bit for
bit (``tests/test_torch_vit_plan.py`` holds a torch emulation of the rule
to ``block_matvec_max_arg`` and to the JAX kernel).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import block_scan as bs
from .blocked import block_matvec, block_matvec_max_arg, tier_dst_inverse

__all__ = [
    "vit_scan_reject_reason",
    "viterbi_fwd",
    "viterbi_fwd_plain",
    "walk_tables",
    "walk",
    "walk_plain",
    "rec_walk_tables",
    "rec_walk",
    "rec_walk_plain",
    "vit_plan",
    "LAUNCHES",
    "reset_launch_counts",
]

# launches of each CUDA kernel entry point, counted by its wrapper
LAUNCHES = {"vit_fwd": 0, "vit_walk": 0, "vit_fwd_noid": 0, "rec_walk": 0}

_NO_CAND = 255
# the JAX kernel's tier chunk (pallas_block._VIT_KC): kept as an admission
# predicate so that both packages take the same route for the same graph
_VIT_KC = 8


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _main_region(cf) -> int:
    """R·W: the states K7 records ids for; the tail [R·W, Sp) holds the
    phony final state (and padding), whose only arcs are the ω ones."""
    (W, R, _, _), _ = bs._full_plan_explain(cf)
    return R * W


def layout(B: int, n_frames: int) -> tuple:
    """(scratch bytes, g) of K7 at batch ``B`` over ``n_frames`` frames,
    from the library (``mm_vit_layout``): the zeroed scratch the sweep
    carves its per-frame column maxima, omega keys, queue positions and
    barrier words from, and the tier candidates per max group."""
    from . import _build

    out = (ctypes.c_longlong * 2)()
    bs._raise_on(_build.library().mm_vit_layout(B, n_frames + 1, out),
                 "mm_vit_layout")
    return int(out[0]), int(out[1])


def _device_bytes(cf, B: int, n_frames: int, saved=None) -> int:
    """Device bytes of one K7 sweep, every buffer sized by its dtype: the
    uint8 id stream (K7n: ``saved`` frames of state and scale instead),
    the initial state and the ping-pong pair, the emissions, the operator
    with its transposed panels, and the scratch (:func:`layout`)."""
    Sp, P1 = cf.padded_states, cf.num_pdfs + 1
    f = cf.alpha_hat.element_size()
    Nf = n_frames + 1
    op = cf.block_fwd
    tens = [cf.omega_prob, cf.alpha_hat, op.tiers[0][2], op.tiers[0][2]]
    if op.band_w is not None:
        tens.append(op.band_w)
    need = sum(t.numel() * t.element_size() for t in tens)
    if saved is None:
        need += Nf * _main_region(cf) * B  # ids
    else:
        need += saved * (Sp + 1) * B * f  # saved states and scales
    need += 3 * Sp * B * f + Nf * (P1 + 1) * B * f
    need += layout(B, n_frames)[0]
    return need


def vit_scan_reject_reason(cf, B: int, *, n_frames: int | None = None,
                           device=None, saved: int | None = None):
    """None when K7 accepts this graph, else a one-line reason naming the
    FIRST rejected predicate.  The predicates are the JAX package's
    (``vit_scan_supported``) in its order: the blocked scan's (ported in
    ``block_scan_reject_reason``), no overflow families, uint8 candidate
    ids, the tier-chunk divisibility; instead of its VMEM budget, the
    working set (``_device_bytes``) must fit the memory of ``device`` when
    that is a CUDA device (checked where a card is present).  With
    ``saved`` (K7n, which saves that many frames' states and stores no
    id) the id predicate is skipped and the working set counts the saved
    states in place of the ids."""
    reason = bs.block_scan_reject_reason(cf, B, tier_dtype=torch.float32)
    if reason is not None:
        return reason
    (_, _, pf, _), _ = bs._full_plan_explain(cf)
    if cf.block_fwd.ov_w:
        return "overflow families (no tropical sweep for them yet)"
    nO = len(pf["band_offsets"])
    if saved is None and pf["Sm"] + nO >= _NO_CAND:
        return (f"tier width {pf['Sm']} + {nO} band offsets: candidate ids "
                "do not fit a uint8")
    if not (pf["K"] % _VIT_KC == 0 or pf["K"] < _VIT_KC):
        return f"{pf['K']} tier blocks not a multiple of {_VIT_KC}"
    if (device is not None and n_frames is not None
            and torch.device(device).type == "cuda"
            and torch.cuda.is_available()):
        need = _device_bytes(cf, B, n_frames, saved)
        have = torch.cuda.get_device_properties(
            torch.device(device)).total_memory
        if need > have:
            return (f"device working set ~{need / 1e9:.1f} GB exceeds the "
                    f"card's {have / 1e9:.1f} GB (Sp = {cf.padded_states}, "
                    f"B = {B}, {n_frames} frames)")
    return None


def _check_graph(cf, B: int, n_frames: int, device, saved=None):
    reason = vit_scan_reject_reason(cf, B, n_frames=n_frames, device=device,
                                    saved=saved)
    if reason is not None:
        raise ValueError(f"the Viterbi sweep rejects this graph: {reason}")


# ---------------------------------------------------------------------------
# the host plan of the persistent sweep
# ---------------------------------------------------------------------------

class VitPlan(NamedTuple):
    """The queue of K7's work items, the same in every frame: one row tile
    of the forward operator (the tier tiles, then the 64-row band tiles, in
    the order of ``block_scan._row_tiles``) times one 64-column tile, coded
    tile·ncb + column tile: every tier item, then every band item, each in
    tile, then column-tile order (``block_scan._queue`` with no spread:
    the tier items interleaved with the band items, or taken first by one
    CTA of each SM, measured slower, PERF.md §6).  Each entry also carries
    the first row of a band tile whose rows are consecutive (-1 for any
    other tile).  The CTAs of the persistent grid take the items in queue
    order; which CTA runs an item shows in no result (the frame's two
    reductions are maxima)."""
    ncb: int  # 64-column tiles: ceil(B / 64)
    queue: torch.Tensor  # (n_tiles * ncb, 2) int32: item, first row or -1


def vit_plan(kop, B: int) -> VitPlan:
    """K7's queue for batch ``B``, built once per shape of the forward
    operator's tiles and cached on ``kop``."""
    kd = kop.fwd
    counts = bs._tile_counts(kd, B)
    key = ("vit_plan",) + counts
    pl = kop.plans.get(key)
    if pl is None:
        queue, _ = bs._queue(kd, B, 0.0)
        pl = VitPlan(ncb=counts[0], queue=bs._i32(queue, kd.W.device))
        kop.plans[key] = pl
    return pl


def _panels_t(kop) -> torch.Tensor:
    """(K, D, Sm4) the float32 tier panels transposed, each destination's
    column contiguous and zero-padded to a multiple of 4 positions (K7
    copies them to shared memory 16 bytes at a time); cached on ``kop``."""
    Wt = kop.plans.get("vit_panels")
    if Wt is None:
        K, Sm, D = kop.fwd.W.shape
        Wt = kop.fwd.W.new_zeros((K, D, -(-Sm // 4) * 4), dtype=torch.float32)
        Wt[:, :, :Sm] = kop.fwd.W.transpose(1, 2)
        kop.plans["vit_panels"] = Wt
    return Wt


def _vit_grid(kop, device, B: int, ids: bool = True) -> int:
    """CTAs of K7's (``ids``) or K7n's persistent grid: as many as can be
    co-resident on the CUDA ``device`` at batch ``B`` (the library asks the
    occupancy API with the dynamic shared memory of that batch; cached on
    ``kop``)."""
    from . import _build

    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = ("vit_grid", idx, B, ids)
    if key not in kop.plans:
        with torch.cuda.device(idx):
            n = _build.library().mm_vit_ctas(int(B % 4 == 0), int(ids), B)
        if n < 0:
            bs._raise_on(-n, "mm_vit_ctas")
        if n == 0:
            raise ValueError("the persistent K7 kernel cannot keep its CTAs "
                             f"co-resident on {device}")
        kop.plans[key] = n
    return kop.plans[key]


# ---------------------------------------------------------------------------
# plain PyTorch twins (the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

def _save_slot(f: int, stride: int) -> int:
    """The slot K7n saves launch frame f in, or -1."""
    return (f + 1) // stride - 1 if (f + 1) % stride == 0 else -1


def _noid_plain(cf, ext, mshift, a0, s0, t0, stride, acc):
    """K7n's twin (see :func:`viterbi_fwd_plain`), and the plain sweep of
    any 'block' graph with a rank-1 ω split: without K7's plan (several
    tiers) nothing is masked, which changes no value (no core arc leaves
    the tail of phony and padding states)."""
    Nf, _, B = ext.shape
    Sp, fin = cf.padded_states, cf.final_state
    plan, _ = bs._full_plan_explain(cf)
    RW = plan[0] * plan[1] if plan is not None else Sp
    spdf = cf.state_pdf.long()
    om = cf.omega_prob[:, None]
    n_save = Nf // stride
    save = ext.new_empty((n_save, Sp, B))
    save_scale = ext.new_empty((n_save, B))
    acc = ext.new_zeros((3, B)) if acc is None else acc
    a = a0 * s0[None, :]  # the scaled state the next frame reads
    for f in range(Nf):
        if t0 + f == 0:
            p = a
        else:
            x = a.clone()
            x[RW:] = 0.0  # the kernel's tier and bands read [0, RW) only
            y = block_matvec(cf.block_fwd, cf.block_fwd_offsets, x,
                             op_kind="max")
            p = torch.zeros_like(a)
            p[:RW] = y[:RW]
            p[fin] = (om * a).amax(dim=0)  # the rank-1 ω arcs
        u = p * ext[f].index_select(0, spdf)
        k = bs._pow2_exponent(u.amax(dim=0))
        sc = bs._pow2_scale(k)
        a = u * sc[None, :]
        slot = _save_slot(f, stride)
        if slot >= 0:
            save[slot], save_scale[slot] = u, sc
        bs._kahan_step(acc, k, mshift[f, 0])
    return save, save_scale, u, sc, acc


def viterbi_fwd_plain(cf, ext, mshift, *, ids: bool = True, a0=None,
                      s0=None, t0: int = 0, stride: int = 1, acc=None):
    """Plain twin of K7 (``ids``) and of K7n.  ``ext`` / ``mshift`` from
    ops.emissions.prepare_emissions ((Nf, P1, B) / (Nf, 1, B)).

    K7 returns (bps (Nf, R·W, B) uint8, fins (Nf, B) int32, vfin (B,),
    shift (B,), ksum (B,)); the best-path score is log(vfin) + ksum·ln2 +
    shift.

    K7n (``ids=False``) runs global frames t0 .. t0 + Nf - 1 (frame 0
    skips the product only where t0 is 0) from ``a0`` (Sp, B) unscaled
    with the scale ``s0`` (B,) (by default the initial probabilities with
    scale 1), and saves frame f, unscaled with its phony row, when
    (f + 1) % ``stride`` == 0, in slot (f + 1) // stride - 1.  ``acc``
    (3, B): ksum, shift and its Kahan compensation, carried on in place
    (zeros when None).  Returns (save (Nf // stride, Sp, B), save_scale
    (Nf // stride, B), a_last (Sp, B) unscaled, s_last (B,), acc): the
    score is log(a_last[fin]·s_last) + ksum·ln2 + shift, the same final
    value, scale, ksum and shift as K7 from the same start."""
    if not ids:
        if a0 is None:
            a0 = torch.exp(cf.alpha_hat)[:, None].expand(
                cf.padded_states, ext.shape[2])
        s0 = torch.ones_like(ext[0, 0]) if s0 is None else s0
        return _noid_plain(cf, ext, mshift, a0, s0, t0, stride, acc)
    Nf, _, B = ext.shape
    _check_graph(cf, B, Nf - 1, None)
    RW = _main_region(cf)
    Sp, fin = cf.padded_states, cf.final_state
    cmax = cf.pdf_group[0]
    om = cf.omega_prob[:, None]
    a = torch.exp(cf.alpha_hat)[:, None].expand(Sp, B)  # scale 1
    flat = torch.arange(Sp, dtype=torch.int32, device=ext.device)[:, None]
    bps = torch.empty((Nf, RW, B), dtype=torch.uint8, device=ext.device)
    fins = torch.empty((Nf, B), dtype=torch.int32, device=ext.device)
    ksum, shift, comp = (ext.new_zeros(B) for _ in range(3))
    for t in range(Nf):
        # rank-1 ω arcs into the phony state: value and smallest argmax
        omc = om * a
        fin_v = omc.amax(dim=0)
        fins[t] = torch.where(omc == fin_v, flat, Sp).amin(dim=0)
        x = a.clone()
        x[RW:] = 0.0  # the tier and the bands read the main region only
        y, cand = block_matvec_max_arg(cf.block_fwd, cf.block_fwd_offsets, x)
        bps[t] = cand[:RW].to(torch.uint8)
        if t == 0:
            p = a
        else:
            p = torch.zeros_like(a)
            p[:RW] = y[:RW]
            p[fin] = fin_v
        u = p * ext[t].repeat_interleave(cmax, dim=0)
        k = bs._pow2_exponent(u.amax(dim=0))
        a = u * bs._pow2_scale(k)[None, :]
        ksum = ksum + k
        # Kahan-compensated accumulation of the factored emission shift
        xc = mshift[t, 0] - comp
        tsum = shift + xc
        comp = (tsum - shift) - xc
        shift = tsum
    return bps, fins, a[fin], shift, ksum


class WalkTables(NamedTuple):
    """Decode tables of the backtrace, built once per graph."""

    k_of: torch.Tensor  # (Sp,) int32 tier block writing each state, -1
    sidx: torch.Tensor  # (K·Sm,) int32 tier source of (k, position)
    offs: torch.Tensor  # (max(nO, 1),) int32 band offsets
    K: int
    Sm: int
    nO: int
    fin: int


def walk_tables(cf) -> WalkTables:
    """The walk's decode tables for a graph K7 accepts (cached on it)."""
    wt = cf._cache.get("vit_walk")
    if wt is None:
        dev = cf.alpha_hat.device
        sidx = cf.block_fwd.tiers[0][0]
        K, Sm = sidx.shape
        offs = np.asarray(cf.block_fwd_offsets[0], dtype=np.int32)
        nO = len(offs)
        wt = WalkTables(
            k_of=torch.from_numpy(tier_dst_inverse(
                cf.block_fwd, cf.padded_states)).to(dev),
            sidx=sidx.reshape(-1).to(device=dev, dtype=torch.int32)
            .contiguous(),
            offs=torch.from_numpy(offs if nO else np.zeros(1, np.int32))
            .to(dev),
            K=K, Sm=Sm, nO=nO, fin=int(cf.final_state),
        )
        cf._cache["vit_walk"] = wt
    return wt


def walk_plain(wt: WalkTables, bps, fins, lengths):
    """Plain twin of the walk.  From the phony final state at frame Nf-1
    back to frame 1: decode the id of the current state (255 outside the
    main region) to its source; at t == length the source is the frame's
    ω argmax, past the length the phony state.  Returns (Nf-1, B) int32
    states in compiled numbering (frame t-1's state at row t-1)."""
    Nf, RW, B = bps.shape
    Sp = wt.k_of.shape[0]
    L = lengths.long()
    bcol = torch.arange(B, device=bps.device)
    s = torch.full((B,), wt.fin, dtype=torch.long, device=bps.device)
    states = torch.empty((Nf - 1, B), dtype=torch.int32, device=bps.device)
    for t in range(Nf - 1, 0, -1):
        c = bps[t][s.clamp(max=RW - 1), bcol].long()
        c = torch.where(s < RW, c, _NO_CAND)
        k = wt.k_of[s.clamp(0, Sp - 1)].long().clamp(0, wt.K - 1)
        tier_src = wt.sidx[k * wt.Sm + c.clamp(0, wt.Sm - 1)].long()
        band_src = s - wt.offs[(c - wt.Sm).clamp(0, len(wt.offs) - 1)].long()
        src = torch.where(c < wt.Sm, tier_src, band_src)
        src = torch.where(c == _NO_CAND, wt.fin, src)
        s = torch.where(t == L, fins[t].long(), src)
        s = torch.where(t > L, wt.fin, s)
        states[t - 1] = s
    return states


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def viterbi_fwd(cf, ext, mshift, *, ids: bool = True, a0=None, s0=None,
                t0: int = 0, stride: int = 1, acc=None):
    """K7 (``ids``) or K7n: the fused tropical sweep over all Nf frames of
    ``ext``, one cooperative launch.  Same inputs and outputs as
    :func:`viterbi_fwd_plain`.  A ``precision='bf16'`` graph decodes with
    its float32 panels, exactly as a 'high' one: the TPU K7 ignores the
    precision (``pallas_block.py:1169``)."""
    kw = dict(a0=a0, s0=s0, t0=t0, stride=stride, acc=acc)
    if not bs._route(ext, "Viterbi-sweep"):
        return viterbi_fwd_plain(cf, ext, mshift, ids=ids, **kw)
    if not ids:
        return _noid_fwd(cf, ext, mshift, **kw)
    from . import _build

    Nf, P1, B = ext.shape
    dev = ext.device
    _check_graph(cf, B, Nf - 1, dev)
    kop = bs.kernel_operator(cf, torch.float32)  # f32 panels on any graph
    Sp, RW = kop.Sp, _main_region(cf)
    bs._check_op(kop, kop.fwd, dev)
    bs._check("ext", ext, (Nf, kop.P1, B), dev)
    bs._check("mshift", mshift, (Nf, 1, B), dev)
    meta = bs._imeta(kop, kop.fwd)
    pl, Wt = vit_plan(kop, B), _panels_t(kop)
    G = _vit_grid(kop, dev, B)
    a0 = kop.alpha0[:, None].expand(Sp, B).contiguous()
    bps = torch.empty((Nf, RW, B), dtype=torch.uint8, device=dev)
    fins = torch.empty((Nf, B), dtype=torch.int32, device=dev)
    work = torch.empty((2, Sp, B), device=dev)
    scale, ksum, shift, comp = (torch.zeros(B, device=dev) for _ in range(4))
    # zeroed scratch, carved by the library (int64 words: 8-byte aligned)
    n_scratch = layout(B, Nf - 1)[0]
    scratch = torch.zeros(-(-n_scratch // 8), dtype=torch.int64, device=dev)
    kd = kop.fwd
    with torch.cuda.device(dev):  # the library launches on it
        rc = _build.library().mm_vit_fwd(
            bs._p(a0), bs._p(ext), bs._p(mshift), bs._p(kd.band_w),
            bs._p(Wt), bs._p(kop.omega), bs._p(kd.band_rows),
            ctypes.c_void_p(meta.ctypes.data), bs._p(pl.queue),
            pl.queue.shape[0], G, B, Nf, RW, bs._p(work), bs._p(bps),
            bs._p(fins), bs._p(scale), bs._p(ksum), bs._p(shift),
            bs._p(comp), bs._p(scratch), n_scratch, bs._stream(dev),
        )
    bs._raise_on(rc, "mm_vit_fwd")
    LAUNCHES["vit_fwd"] += 1
    vfin = work[(Nf - 1) % 2, kop.fin] * scale
    return bps, fins, vfin, shift, ksum


def _noid_fwd(cf, ext, mshift, *, a0, s0, t0, stride, acc):
    """K7n on CUDA tensors (:func:`viterbi_fwd` with ``ids=False``)."""
    from . import _build

    if t0 < 0 or stride < 1:
        raise ValueError(f"t0 {t0}, stride {stride}: need t0 >= 0, "
                         "stride >= 1")
    Nf, P1, B = ext.shape
    dev = ext.device
    n_save = Nf // stride
    _check_graph(cf, B, Nf - 1, dev, saved=n_save)
    kop = bs.kernel_operator(cf, torch.float32)
    Sp, RW = kop.Sp, _main_region(cf)
    bs._check_op(kop, kop.fwd, dev)
    bs._check("ext", ext, (Nf, kop.P1, B), dev)
    bs._check("mshift", mshift, (Nf, 1, B), dev)
    if a0 is None:
        a0 = kop.alpha0[:, None].expand(Sp, B).contiguous()
    s0 = torch.ones(B, device=dev) if s0 is None else s0
    acc = torch.zeros((3, B), device=dev) if acc is None else acc
    bs._check("a0", a0, (Sp, B), dev)
    bs._check("s0", s0, (B,), dev)
    bs._check("acc", acc, (3, B), dev)
    meta = bs._imeta(kop, kop.fwd)
    pl, Wt = vit_plan(kop, B), _panels_t(kop)
    G = _vit_grid(kop, dev, B, ids=False)
    save = torch.empty((n_save, Sp, B), device=dev)
    save_scale = torch.empty((n_save, B), device=dev)
    work = torch.empty((2, Sp, B), device=dev) if stride > 1 else None
    scale = torch.zeros(B, device=dev)
    n_scratch = layout(B, Nf - 1)[0]
    scratch = torch.zeros(-(-n_scratch // 8), dtype=torch.int64, device=dev)
    kd = kop.fwd
    ptr = lambda t: None if t is None else bs._p(t)
    with torch.cuda.device(dev):
        rc = _build.library().mm_vit_fwd_noid(
            bs._p(a0), bs._p(s0), bs._p(ext), bs._p(mshift),
            bs._p(kd.band_w), bs._p(Wt), bs._p(kop.omega),
            bs._p(kd.band_rows), ctypes.c_void_p(meta.ctypes.data),
            bs._p(pl.queue), pl.queue.shape[0], G, B, Nf, RW, t0, stride,
            ptr(work), ptr(save), ptr(save_scale), n_save, bs._p(scale),
            bs._p(acc[0]), bs._p(acc[1]), bs._p(acc[2]), bs._p(scratch),
            n_scratch, bs._stream(dev),
        )
    bs._raise_on(rc, "mm_vit_fwd_noid")
    LAUNCHES["vit_fwd_noid"] += 1
    a_last = save[Nf - 1] if stride == 1 else work[(Nf - 1) % 2]
    return save, save_scale, a_last, scale, acc


def walk(wt: WalkTables, bps, fins, lengths):
    """The backtrace walk, one CUDA thread per sequence.  Same inputs and
    output as :func:`walk_plain`; ``lengths`` (B,) int32."""
    if not bs._route(bps, "Viterbi-walk"):
        return walk_plain(wt, bps, fins, lengths)
    from . import _build

    Nf, RW, B = bps.shape
    dev = bps.device
    bs._check("bps", bps, (Nf, RW, B), dev, torch.uint8)
    bs._check("fins", fins, (Nf, B), dev, torch.int32)
    bs._check("lengths", lengths, (B,), dev, torch.int32)
    for name, t in (("k_of", wt.k_of), ("sidx", wt.sidx), ("offs", wt.offs)):
        bs._check(name, t, t.shape, dev, torch.int32)
    Sp = wt.k_of.shape[0]
    states = torch.empty((Nf - 1, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().mm_vit_walk(
            bs._p(bps), bs._p(fins), bs._p(lengths), bs._p(wt.k_of),
            bs._p(wt.sidx), bs._p(wt.offs), Nf, RW, B, Sp, wt.K, wt.Sm,
            wt.nO, wt.fin, bs._p(states), bs._stream(dev),
        )
    bs._raise_on(rc, "mm_vit_walk")
    LAUNCHES["vit_walk"] += 1
    return states


# ---------------------------------------------------------------------------
# W2: the walk of the chunk-recompute decode
# ---------------------------------------------------------------------------

class RecWalkTables(NamedTuple):
    """The in-arc lists the recompute walk reads, built once per graph
    (the JAX package's ``_viterbi_scale``, ``viterbi.py:445-471``)."""

    rowptr: torch.Tensor  # (Sp + 1,) int32 over the dst-sorted edges
    src: torch.Tensor  # (E,) int32 source of each edge
    w: torch.Tensor  # (E,) float32 log weight of each edge
    omega: torch.Tensor  # (Sp,) probabilities of the arcs into fin
    dmax: int  # in-arcs a state takes: the largest in-degree but fin's
    fin: int


def rec_walk_tables(cf) -> RecWalkTables:
    """The walk's tables of a 'dense' or 'block' graph (cached on it).
    Dmax leaves out the phony final state (its in-arcs are the ω arcs,
    taken at t = L - 1 from ``omega``) and row Sp - 1 (where the padding
    edges park); ``omega`` is the rank-1 ω column of a 'block' graph and
    the phony row of the probability operator of a 'dense' one."""
    wt = cf._cache.get("rec_walk")
    if wt is None:
        Sp, fin = cf.padded_states, int(cf.final_state)
        dst = cf.fwd_dst.cpu().numpy()
        rowptr = np.searchsorted(dst, np.arange(Sp + 1)).astype(np.int32)
        indeg = np.diff(rowptr)
        indeg[fin] = 0
        indeg[Sp - 1] = 0
        if cf.strategy == "dense":
            omega = torch.exp(cf.dense_fwd_max[fin]) * cf.dense_fwd_exp[fin]
        else:
            omega = cf.omega_prob
        dev = cf.alpha_hat.device
        wt = RecWalkTables(
            rowptr=torch.from_numpy(rowptr).to(dev),
            src=cf.fwd_src.to(device=dev, dtype=torch.int32).contiguous(),
            w=cf.fwd_w.to(device=dev, dtype=torch.float32).contiguous(),
            omega=omega.to(torch.float32).contiguous(),
            dmax=max(int(indeg.max()), 1), fin=fin)
        cf._cache["rec_walk"] = wt
    return wt


def rec_walk_plain(wt: RecWalkTables, states, scales, lengths, t0: int,
                   s_next):
    """Plain twin of W2: the states of frames t0 .. t0 + nK - 1 from the
    chunk's unscaled alphas ``states`` (nK, Sp, B) with their ``scales``
    (nK, B), walking back from ``s_next`` (B,), the states of frame
    t0 + nK.  Per frame (s the state of t + 1): the best of the first Dmax
    in-arcs of s by log(α·scale) + w (the scale before the log, as the JAX
    package's scaled α), ties to the largest position, the phony state
    where all are -inf (or s is it); at t = L - 1 the argmax of
    (α·scale)·ω over all states, ties to the largest; past the length the
    phony state.  Returns (nK, B) int32 in compiled numbering."""
    nK, Sp, B = states.shape
    E = wt.src.shape[0]
    dev = states.device
    L = lengths.long()
    bcol = torch.arange(B, device=dev)[:, None]
    offs = torch.arange(wt.dmax, device=dev)
    out = torch.empty((nK, B), dtype=torch.int32, device=dev)
    s = s_next.long()
    rowptr = wt.rowptr.long()
    for i in reversed(range(nK)):
        t = t0 + i
        a = states[i] * scales[i][None, :]
        rp = rowptr[s]
        cnt = torch.where(s == wt.fin, 0, rowptr[s + 1] - rp)
        eidx = (rp[:, None] + offs[None, :]).clamp(max=E - 1)
        src = wt.src[eidx].long()  # (B, Dmax)
        av = a[src, bcol]
        valid = (offs[None, :] < cnt[:, None]) & (av > 0)
        cand = torch.where(valid, torch.log(av) + wt.w[eidx],
                           torch.full_like(av, -float("inf")))
        best = wt.dmax - 1 - cand.flip(1).argmax(dim=1)
        st = src.gather(1, best[:, None])[:, 0]
        st = torch.where(cand.amax(dim=1) == -float("inf"), wt.fin, st)
        last = t == L - 1
        if bool(last.any()):
            oc = a * wt.omega[:, None]
            st = torch.where(last, Sp - 1 - oc.flip(0).argmax(dim=0), st)
        st = torch.where(t >= L, wt.fin, st)
        out[i] = st
        s = st
    return out


def rec_walk(wt: RecWalkTables, states, scales, lengths, t0: int, s_next):
    """W2: the walk of one chunk, one CUDA warp per sequence.  Same inputs
    and output as :func:`rec_walk_plain`; ``lengths`` and ``s_next`` (B,)
    int32."""
    if not bs._route(states, "recompute-walk"):
        return rec_walk_plain(wt, states, scales, lengths, t0, s_next)
    from . import _build

    nK, Sp, B = states.shape
    dev = states.device
    bs._check("states", states, (nK, Sp, B), dev)
    bs._check("scales", scales, (nK, B), dev)
    for name, t in (("lengths", lengths), ("s_next", s_next)):
        bs._check(name, t, (B,), dev, torch.int32)
    for name, t in (("rowptr", wt.rowptr), ("src", wt.src)):
        bs._check(name, t, t.shape, dev, torch.int32)
    bs._check("w", wt.w, wt.src.shape, dev)
    bs._check("omega", wt.omega, (Sp,), dev)
    if wt.rowptr.shape != (Sp + 1,) or t0 < 0:
        raise ValueError(f"rowptr {tuple(wt.rowptr.shape)} for {Sp} states, "
                         f"t0 {t0}")
    out = torch.empty((nK, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.library().mm_rec_walk(
            bs._p(states), bs._p(scales), bs._p(lengths), bs._p(wt.rowptr),
            bs._p(wt.src), bs._p(wt.w), bs._p(wt.omega), nK, t0, Sp, B,
            wt.dmax, wt.fin, bs._p(s_next), bs._p(out), bs._stream(dev),
        )
    bs._raise_on(rc, "mm_rec_walk")
    LAUNCHES["rec_walk"] += 1
    return out
