"""Blocked forward-backward scan on the GPU: hand-written CUDA kernels with
plain PyTorch twins.

Counterpart of ``markovmodels_tpu/ops/pallas_block.py``.  One shared graph
(the LF-MMI denominator) runs over a (Sp, B) probability state:

* K2 ``fwd_sweep``: the forward sweep over all frames, keeping one state
  checkpoint per chunk and the pieces of logZ (replaces ``_run_slice``'s
  forward ``pallas_call``, ``_make_fwd_kernel``); one persistent
  cooperative launch per sweep, whose CTAs run the work items
  :func:`fwd_plan` gives them;
* K3 ``recompute``: re-runs one chunk's forward frames from its checkpoint
  and keeps every frame's alpha (replaces ``_make_recompute_kernel``); one
  such launch per chunk;
* K4 ``backward``: the reverse sweep over one chunk: beta carry,
  gamma = alpha * beta reduced over pdf groups, posteriors normalised per
  frame (replaces ``_make_bwd_kernel``); one persistent cooperative launch
  per chunk, whose CTAs run the work items :func:`bwd_plan` gives them.

All three are built on one blocked matvec (band offsets + one affine tier +
the rank-1 omega split + the overflow families of a capped layout), the
counterpart of ``_make_matvec``.  Two layouts run: the uniform pdf-grouped
one (pdf p owns rows [p·cmax, (p+1)·cmax)) and the capped one of a
separate-state backoff graph (``ov_layout``: P uniform groups, then nOv
overflow groups whose rows each carry their own pdf, then the tail, which
belongs to the phony pdf).  The kernels read every row's pdf from one
table and pull the overflow families as per-row lists of (source, weight)
terms.  The kernels come in three value types: float32, bf16 tier panels
(a ``precision='bf16'`` graph), and float64 throughout (a float64 graph,
which the TPU kernel declines; the instantiation code ``_prec``).  The CUDA
sources are ``csrc/block_scan.cu``; ``_build.py`` compiles them with nvcc at
first use.  Each wrapper takes its plain version for CPU tensors and
launches the kernel for CUDA tensors; anything else raises.

State convention shared by kernels and twins: a carried state is stored
unscaled together with a per-column power-of-two scale ``s`` (B,).  The
next frame applies ``s`` when it reads the state, so rescaling costs no
extra pass.  Power-of-two scaling is exact, so this gives the same values
as rescaling in place every frame; the exponent comes from the float's
exponent bits (``frexp``), never from a rounded log2.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .blocked import family_grid, round_bf16
from .emissions import pad_emissions

__all__ = [
    "block_scan_admission",
    "block_scan_reject_reason",
    "kernel_operator",
    "fwd_plan",
    "bwd_plan",
    "fwd_sweep",
    "recompute",
    "backward",
    "fwd_sweep_plain",
    "recompute_plain",
    "backward_plain",
    "block_fused_fb",
    "LAUNCHES",
    "LAUNCHES_BF16",
    "LAUNCHES_F64",
    "reset_launch_counts",
]

# launches of each CUDA kernel entry point, counted by its wrapper: the
# float32 instantiations in LAUNCHES, the bf16 ones (a precision='bf16'
# graph's tensor-core tier) in LAUNCHES_BF16, the float64 ones (a float64
# graph) in LAUNCHES_F64
LAUNCHES = {"block_fwd": 0, "block_recompute": 0, "block_bwd": 0}
LAUNCHES_BF16 = dict(LAUNCHES)
LAUNCHES_F64 = dict(LAUNCHES)

_TILE_ROWS = 64  # state rows per CUDA tile (TR in csrc/block_scan.cu)
# rows with at least this many family terms get a tile of their own, whose
# threads split the terms (csrc/block_scan.cu heavy_terms)
_HEAVY_TERMS = 16
_MAX_BANDS = 8  # band offsets a kernel takes (build_block_operator's cap)
_BF16_K = 16  # contraction depth of one bf16 tensor-core step (mma k16)
# K4's persistent grid where there is no card to ask: the uniform layout's
# 4 CTAs per SM (bwd_blocks in csrc/block_scan.cu) on the 132 SMs of an
# H100; K2's and K3's: 3 per SM (FWD_BLOCKS)
_CTAS_PER_SM = 4
_FWD_CTAS_PER_SM = 3
_SMS = 132
# the share of K4's band items among which its tier items are spread in the
# queue (the rest of the band items come last; 0.3 measured best on three
# of the four graph and precision pairs, PERF.md §6)
_TIER_SPAN = 0.3
# the same for K2 and K3 (0.1 measured better than 0.3 and 0, PERF.md §6)
_FWD_TIER_SPAN = 0.1
# copies of each frame's column max that K2-K4 spread their atomics over (CM
# in csrc/block_scan.cu)
_CM_COPIES = 16


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = LAUNCHES_BF16[k] = LAUNCHES_F64[k] = 0


def _counts(tier_dtype):
    return {torch.bfloat16: LAUNCHES_BF16,
            torch.float64: LAUNCHES_F64}.get(tier_dtype, LAUNCHES)


def _prec(tier_dtype) -> int:
    """The instantiation code the entry points take for the panels' dtype:
    0 float32, 1 bf16 panels (the rest float32), 2 float64 throughout."""
    return {torch.bfloat16: 1, torch.float64: 2}.get(tier_dtype, 0)


# ---------------------------------------------------------------------------
# static plan extraction (same predicates, in the same order, as the JAX
# package, so both name the same first rejected predicate)
# ---------------------------------------------------------------------------

def _dir_plan_explain(op, meta, W, R, cmax):
    """Per-direction tier plan as (plan, None), or (None, reason) naming
    the first rejected predicate.  Flat state r·W + g·cmax + c; supported
    tier forms: gather 'affine_k_major' with scatter 'affine_d_pad' /
    'affine_d', or gather 'affine_s_major' with scatter 'affine_k_pad' /
    'contig', every window aligned to pdf-group boundaries."""
    band_offsets, tier_descs = meta[0], meta[1]
    if op.res_src is not None:
        return None, "residue edges present (blocks with too many sources)"
    if len(op.tiers) != 1:
        return None, f"{len(op.tiers)} tiers (kernel supports exactly 1)"
    sidx, didx, Wt = op.tiers[0]
    gdesc, ddesc = tier_descs[0]
    K, Sm = sidx.shape
    D = didx.shape[1]
    plan = dict(band_offsets=tuple(band_offsets), K=K, Sm=Sm, D=D)
    for off in band_offsets:
        if off % cmax or abs(off) >= W:
            return None, (
                f"band offset {off} not a multiple of the pdf-group size "
                f"{cmax} inside row width {W}"
            )

    if gdesc[0] == "affine_k_major":
        _, gb, dk, gc0 = gdesc
        c = gb + gc0
        if dk != W or c // W != 0 or (c % W) % cmax + Sm > cmax:
            return None, (
                f"k-major gather window (base {c}, stride {dk}) not aligned "
                f"to one pdf group of the (R, {W}) state rows"
            )
        plan["g"] = ("row", (c % W) // cmax, (c % W) % cmax)
    elif gdesc[0] == "affine_s_major":
        _, gb, ds, gc0 = gdesc
        if (ds != W or gb % W or gb // W + Sm > R or gc0 % cmax
                or K != cmax):
            return None, (
                f"s-major gather window (base {gb}, stride {ds}) not a "
                f"row-aligned lane column of the (R, {W}) state rows"
            )
        plan["g"] = ("col", gb // W, gc0 // cmax)
    else:
        return None, f"non-affine tier gather pattern {gdesc[0]!r}"

    if ddesc[0] in ("affine_d_pad", "affine_d"):
        base = ddesc[1]
        dd = W if ddesc[0] == "affine_d" else ddesc[2]
        c0 = 0 if ddesc[0] == "affine_d" else ddesc[3]
        if dd != W or base % W or base // W + D > R or c0 % cmax or K != cmax:
            return None, (
                f"d-affine scatter window (base {base}, stride {dd}) not a "
                f"row-aligned lane column of the (R, {W}) state rows"
            )
        plan["s"] = ("col", base // W, c0 // cmax)
    elif ddesc[0] in ("affine_k_pad", "contig"):
        if ddesc[0] == "contig":
            base, dk2, c02 = ddesc[1], D, 0
        else:
            _, base, dk2, c02 = ddesc
        c = base + c02
        if dk2 != W or c // W != 0 or (c % W) % cmax + D > cmax:
            return None, (
                f"k-affine scatter window (base {c}, stride {dk2}) not "
                f"aligned to one pdf group of the (R, {W}) state rows"
            )
        plan["s"] = ("row", (c % W) // cmax, (c % W) % cmax)
    else:
        return None, f"non-affine tier scatter pattern {ddesc[0]!r}"
    return plan, None


def _ov_plan(descs, W, R, cmax):
    """Validate overflow-family descriptors (ops/blocked.py _ov_families)
    against the (R, W) grid.  Returns (plans, None) or (None, reason); each
    plan is (kind, form, (rg, gg), (rb, gb), D) with the ov group at grid
    cell (rg, gg) and the core-side window/column anchored at (rb, gb)."""
    plans = []
    for desc in descs:
        kind, g0, form, base, stride, D = desc
        if g0 % cmax or (g0 % W) % cmax:
            return None, f"ov group base {g0} not lane-group aligned"
        rg, gg = g0 // W, (g0 % W) // cmax
        if rg >= R:
            return None, f"ov group row {rg} outside the {R}-row grid"
        if (base % W) % cmax:
            return None, f"ov family base {base} not lane-group aligned"
        rb, gb = base // W, (base % W) // cmax
        if form == "win":
            if stride != W:
                return None, f"ov window stride {stride} != row width {W}"
            if D != cmax:
                return None, f"ov window width {D} != lane-group size {cmax}"
            if rb + cmax > R:
                return None, "ov window rows overrun the grid"
        elif form == "col":
            if D > 1 and stride != W:
                return None, f"ov column stride {stride} != row width {W}"
            if rb + D > R:
                return None, "ov column rows overrun the grid"
        else:
            return None, f"unknown ov family form {form!r}"
        plans.append((kind, form, (rg, gg), (rb, gb), D))
    return tuple(plans), None


def _full_plan_explain(cf):
    """((W, R, plan_fwd, plan_bwd), None) or (None, reason).  Plans carry
    an 'ov' tuple of overflow-family plans (empty for uniform layouts)."""
    ops = (cf.block_fwd, cf.block_bwd)
    metas = (cf.block_fwd_offsets, cf.block_bwd_offsets)
    W = None
    for op, meta in zip(ops, metas):
        if op.res_src is not None:
            return None, "residue edges present"
        if len(op.tiers) != 1:
            return None, f"{len(op.tiers)} tiers (kernel supports exactly 1)"
        for desc in meta[1][0]:
            if desc[0] in ("affine_k_major", "affine_s_major",
                           "affine_k_pad", "affine_d_pad"):
                W = desc[2]
                break
    if not W:
        return None, "no affine tier descriptor to derive the row width from"
    if W % 128:
        return None, f"tier stride {W} not a multiple of 128 lanes"
    Sp = cf.padded_states
    if cf.pdf_group:
        cmax, lim = cf.pdf_group
        nOv = 0
    elif cf.ov_layout:
        cmax, nOv = cf.ov_layout
    else:
        return None, "no pdf-grouped or overflow layout"
    if W % cmax:
        return None, f"row width {W} not a multiple of pdf-group size {cmax}"
    fin = cf.final_state
    Rk = max(cf.block_fwd.tiers[0][0].shape[0],
             cf.block_bwd.tiers[0][0].shape[0])
    R = fin // W if (fin % W == 0 and fin // W >= Rk) else Rk
    if R * W > Sp:
        return None, f"R*W = {R * W} exceeds padded states {Sp}"
    tail = Sp - R * W
    if fin < R * W:
        return None, "phony final state not in the tail region"
    if tail % cmax or tail <= 0 or tail % 128:
        return None, f"tail size {tail} not lane/pdf-group aligned"
    Gp = W // cmax
    if nOv:
        P = cf.num_pdfs
        if R * Gp != P + nOv:
            return None, (f"overflow grid has {R * Gp} lane-groups, layout "
                          f"expects P + nOv = {P + nOv}")
        if P % Gp:
            return None, (f"uniform region ({P} groups) does not end on a "
                          f"row boundary (Gp = {Gp})")
    pf, rf = _dir_plan_explain(cf.block_fwd, cf.block_fwd_offsets, W, R, cmax)
    if pf is None:
        return None, f"forward operator: {rf}"
    pb, rb = _dir_plan_explain(cf.block_bwd, cf.block_bwd_offsets, W, R, cmax)
    if pb is None:
        return None, f"backward operator: {rb}"
    for plan, meta, dname in ((pf, metas[0], "forward"),
                              (pb, metas[1], "backward")):
        ovd = meta[3] if len(meta) > 3 else ()
        if ovd and not nOv:
            return None, f"{dname} operator: ov families without ov layout"
        ovp, ro = _ov_plan(ovd, W, R, cmax)
        if ovp is None:
            return None, f"{dname} operator: {ro}"
        plan["ov"] = ovp
    # band weights must vanish on the tail (the rank-1 ω split owns it)
    for meta in metas:
        if len(meta) <= 2:
            return None, "legacy operator metadata without band extent"
        if meta[2] > R * W:
            return None, "band weights extend into the tail region"
    return (W, R, pf, pb), None


def _tier_affine(meta, K, D):
    """Index maps of a direction's single tier as ints:
    src(k, s) = g0 + k·gk + s·gs and dst(k, d) = d0 + k·dk + d·dd, read
    from its gather/scatter descriptors (ops/blocked.py)."""
    gdesc, ddesc = meta[1][0]
    if gdesc[0] == "affine_k_major":  # view (K, dk)[:, c0:c0+Sm]
        _, base, dk, c0 = gdesc
        g = (base + c0, dk, 1)
    elif gdesc[0] == "affine_s_major":  # view (Sm, ds)[:, c0:c0+K], swapped
        _, base, ds, c0 = gdesc
        g = (base + c0, 1, ds)
    else:
        raise ValueError(f"non-affine tier gather {gdesc[0]!r}")
    if ddesc[0] == "contig":  # base + k·D + d
        d = (ddesc[1], D, 1)
    elif ddesc[0] == "affine_d":  # base + k + d·K
        d = (ddesc[1], 1, K)
    elif ddesc[0] == "affine_k_pad":  # view (K, dk)[:, c0:c0+D]
        _, base, dk, c0 = ddesc
        d = (base + c0, dk, 1)
    elif ddesc[0] == "affine_d_pad":  # view (D, dd)[:, c0:c0+K], swapped
        _, base, dd, c0 = ddesc
        d = (base + c0, 1, dd)
    else:
        raise ValueError(f"non-affine tier scatter {ddesc[0]!r}")
    return g, d


def _dir_index_maps(op, meta):
    """((g0, gk, gs), (d0, dk, dd), src_rows (K, Sm), dst_rows (K, D))."""
    K, Sm = op.tiers[0][0].shape
    D = op.tiers[0][1].shape[1]
    g, d = _tier_affine(meta, K, D)
    k = np.arange(K, dtype=np.int64)[:, None]
    src = g[0] + k * g[1] + np.arange(Sm, dtype=np.int64)[None, :] * g[2]
    dst = d[0] + k * d[1] + np.arange(D, dtype=np.int64)[None, :] * d[2]
    return g, d, src, dst


def _ov_bounds(cf):
    """(ov_lo, ov_hi): the overflow rows [P·cmax, (P+nOv)·cmax) of a capped
    layout, (Sp, Sp) for a uniform one."""
    if not cf.ov_layout:
        return cf.padded_states, cf.padded_states
    cmax, nOv = cf.ov_layout
    return cf.num_pdfs * cmax, (cf.num_pdfs + nOv) * cmax


def _row_pdf(cf) -> np.ndarray:
    """The pdf of every state row as the kernels read it: row j // cmax in
    the uniform groups, each overflow row its own pdf, the phony pdf P in
    the tail (the JAX kernel's emission and posterior layout)."""
    Sp = cf.padded_states
    rows = np.arange(Sp, dtype=np.int64)
    if cf.pdf_group:
        return (rows // cf.pdf_group[0]).astype(np.int32)
    ov_lo, ov_hi = _ov_bounds(cf)
    pdf = np.full(Sp, cf.num_pdfs, dtype=np.int32)
    pdf[:ov_lo] = rows[:ov_lo] // cf.ov_layout[0]
    pdf[ov_lo:ov_hi] = cf.state_pdf[ov_lo:ov_hi].cpu().numpy()
    return pdf


def _family_terms(op, meta, cid_of=None):
    """A direction's overflow families as (dst, src, w) terms sorted by
    destination, then source; zero weights dropped (they add exact
    zeros).  'in' terms land on overflow rows, 'out' terms on core rows.
    With ``cid_of`` (a function of (descriptor index, descriptor, weight
    shape) giving an int array of that shape) also each term's value of
    it, a fourth array in the same order (K7's candidate ids)."""
    dst, src, w = [np.zeros(0, np.int64)] * 2 + [np.zeros(0, np.float32)]
    cid = np.zeros(0, np.int64)
    for i, (desc, Wf) in enumerate(zip(meta[3] if len(meta) > 3 else (),
                                       op.ov_w)):
        kind, g0, form = desc[:3]
        Wn = Wf.detach().cpu().numpy()
        block = Wn.shape[-1]
        grid = family_grid(desc, block)
        lanes = np.arange(block, dtype=np.int64)
        lane = g0 + (lanes[None, :] if form == "col" else lanes[:, None])
        lane = np.broadcast_to(lane, grid.shape)
        d, s_ = (lane, grid) if kind == "in" else (grid, lane)
        nz = Wn != 0
        dst = np.concatenate([dst, d[nz]])
        src = np.concatenate([src, s_[nz]])
        w = np.concatenate([w, Wn[nz]])
        if cid_of is not None:
            cid = np.concatenate([cid, np.broadcast_to(
                cid_of(i, desc, Wn.shape), Wn.shape)[nz]])
    order = np.lexsort((src, dst))
    if cid_of is not None:
        return dst[order], src[order], w[order], cid[order]
    return dst[order], src[order], w[order]


def _dir_rows(op, meta, Sp):
    """A direction's host tables: (src_map, dst_map, tier src rows (K, Sm),
    tier dst rows (K, D), family terms (dst, src, w), band rows, heavy
    rows).  Heavy rows are the rows outside the tier with at least
    _HEAVY_TERMS family terms (the overflow rows of an 'in' window or a
    deep 'in' column) and take a tile each; band rows are the other rows
    the tier does not write, in increasing order.  A tier row pulls its
    terms in its tier tile, so every row has exactly one tile."""
    g, d, src, dst = _dir_index_maps(op, meta)
    fam = _family_terms(op, meta)
    n_terms = np.bincount(fam[0], minlength=Sp)
    n_terms[dst.ravel()] = 0
    heavy = np.flatnonzero(n_terms >= _HEAVY_TERMS)
    band = np.setdiff1d(np.arange(Sp), np.concatenate([dst.ravel(), heavy]))
    return g, d, src, dst, fam, band, heavy


def _row_tiles(dst, band, heavy, Sp):
    """The step kernel's tile of every state row: one tile per heavy row,
    then the tier tiles, then 64-row band tiles."""
    K, D = dst.shape
    nh, dt = len(heavy), -(-D // _TILE_ROWS)
    tile = np.empty(Sp, dtype=np.int64)
    tile[heavy] = np.arange(nh)
    tile[dst] = (nh + np.arange(K)[:, None] * dt
                 + (np.arange(D) // _TILE_ROWS)[None, :])
    tile[band] = nh + K * dt + np.arange(len(band)) // _TILE_ROWS
    return tile


def _posterior_tiles(kop):
    """Most tiles of the backward step that add into one pdf's posterior;
    overflow rows excluded (they take a fixed-order sum)."""
    kd = kop.bwd
    tile = _row_tiles(*(t.cpu().numpy() for t in
                        (kd.dst_rows, kd.band_rows, kd.heavy_rows)), kop.Sp)
    rows = np.arange(kop.Sp)
    keep = (rows < kop.ov_lo) | (rows >= kop.ov_hi)
    n = int(tile.max()) + 1
    pdf = kop.row_pdf.cpu().numpy()[keep].astype(np.int64)
    pairs = np.unique(pdf * n + tile[keep])
    return int(np.bincount(pairs // n).max())


def _kernel_checks(cf, W, R):
    """Port-specific predicates on top of the plan (None or a reason),
    computed once per CompiledFSM.  The last one reads the kernels' own
    tables: it builds the cached :func:`kernel_operator` that the launches
    use."""
    key = ("kernel_checks", W, R)
    if key not in cf._cache:
        cf._cache[key] = _kernel_checks_uncached(cf, W, R)
    return cf._cache[key]


def _kernel_checks_uncached(cf, W, R):
    Sp = cf.padded_states
    if cf.pdf_group and cf.pdf_group[1] != Sp:
        return (f"pdf-grouped layout ({cf.pdf_group[1]} slots) does not "
                f"fill the padded states ({Sp})")
    ov_lo, ov_hi = _ov_bounds(cf)
    for dname, op, meta in (("forward", cf.block_fwd, cf.block_fwd_offsets),
                            ("backward", cf.block_bwd, cf.block_bwd_offsets)):
        if len(meta[0]) > _MAX_BANDS:
            return f"{dname} operator: more than {_MAX_BANDS} band offsets"
        _, _, src, dst = _dir_index_maps(op, meta)
        if src.min() < 0 or src.max() >= Sp or dst.min() < 0 or dst.max() >= Sp:
            return f"{dname} operator: tier window outside the state range"
        if len(np.unique(dst)) != dst.size:
            return f"{dname} operator: tier writes a state row twice"
        # JAX's plan checks alignment only: each family's group must lie
        # in the overflow region and its core side inside the R·W grid
        for desc, Wf in zip(meta[3] if len(meta) > 3 else (), op.ov_w):
            g0 = desc[1]
            if g0 < ov_lo or g0 + Wf.shape[-1] > ov_hi:
                return (f"{dname} operator: ov group base {g0} outside the "
                        f"overflow region [{ov_lo}, {ov_hi})")
            grid = family_grid(desc, Wf.shape[-1])
            if grid.min() < 0 or grid.max() >= R * W:
                return (f"{dname} operator: ov family window outside the "
                        f"grid [0, {R * W})")
    n = _posterior_tiles(kernel_operator(cf))
    if n > 2:
        return (f"a pdf's posterior gathers from {n} row tiles (more than 2 "
                "atomic float adds depend on their order)")
    return None


def _working_set_bytes(cf, B, n_frames, chunk):
    """Device bytes of one fused run, every buffer sized by the dtype the
    kernels get: the tier panels 2 bytes for a bf16 graph, every value
    (states, emissions, bands, family weights, omega partials, column
    maxima) 8 bytes for a float64 graph."""
    Sp, P1 = cf.padded_states, cf.num_pdfs + 1
    f = cf.alpha_hat.element_size()
    tens = [cf.omega_prob, cf.alpha_hat]
    for op in (cf.block_fwd, cf.block_bwd):
        tens += [t for t in (op.band_w,) if t is not None]
        tens += list(op.ov_w)
    need = sum(t.numel() * t.element_size() for t in tens)
    kop = kernel_operator(cf)
    need += sum(kd.W.numel() * kd.W.element_size()
                for kd in (kop.fwd, kop.bwd))
    ov_lo, ov_hi = _ov_bounds(cf)
    # the per-row pdf table and family-term offsets (int32, both
    # directions), the terms (an int32 source and a weight per family
    # weight at most), the per-pdf overflow-lane lists
    n_w = sum(t.numel() for op in (cf.block_fwd, cf.block_bwd)
              for t in op.ov_w)
    need += 4 * (3 * (Sp + 1) + n_w + P1 + 1 + (ov_hi - ov_lo)) + f * n_w
    K = min(chunk, n_frames + 1) if n_frames else chunk
    # K4's per-frame scratch over the chunk: the overflow rows' gammas, the
    # column maxima (as unsigned words of the value's width), the per-item
    # column sums of gamma, the queue positions; its queue
    n_items = -(-B // _TILE_ROWS) * int(_imeta(kop, kop.bwd)[_N_TILES])
    need += f * K * (B * (ov_hi - ov_lo + _CM_COPIES)
                     + _TILE_ROWS * n_items) + 4 * K
    need += 4 * n_items
    C = -(-(n_frames + 1) // K) if n_frames else 1
    # K2's over the sweep: the column maxima, the queue positions, the two
    # sets of per-tile omega partials; its queue
    n_tf = int(_imeta(kop, kop.fwd)[_N_TILES])
    need += (f * C * K * _CM_COPIES * B + 4 * C * K + 2 * f * n_tf * B
             + 4 * 2 * n_tf * -(-B // _TILE_ROWS))
    # a0 + ping-pong pair + last state + two betas, the chunk's alphas,
    # the checkpoints, and emissions + posteriors over all padded frames
    need += (6 + K + C) * Sp * B * f
    need += 2 * C * K * P1 * B * f
    return need


def block_scan_reject_reason(cf, B: int, *, n_frames: int | None = None,
                             chunk: int = 64, device=None, tier_dtype=None,
                             tropical: bool = False):
    """None when the CUDA blocked scan accepts this graph, else a one-line
    reason naming the FIRST rejected predicate (the first element of
    :func:`block_scan_admission`)."""
    return block_scan_admission(cf, B, n_frames=n_frames, chunk=chunk,
                                device=device, tier_dtype=tier_dtype,
                                tropical=tropical)[0]


def block_scan_admission(cf, B: int, *, n_frames: int | None = None,
                         chunk: int = 64, device=None, tier_dtype=None,
                         tropical: bool = False):
    """(reason, shared): the FIRST predicate of the CUDA blocked scan that
    this graph fails (None when the scan accepts it), and whether the JAX
    package's admission has that predicate too (a graph it refuses there
    runs in its XLA scan).

    The shared predicates are the JAX package's (the domain from
    ``_pallas_block_reject_reason``, the rest from
    ``block_scan_reject_reason``), in its order, up to its plan, but for
    the dtype: float32 and float64 graphs both run (the TPU kernel takes
    float32).  With ``tropical`` (the admission of the Viterbi sweeps K7 /
    K7n, as JAX's ``vit_scan_supported`` calls ``block_scan_reject_reason``)
    the domain is not checked: the max recursion is exact under rescaling,
    and a log-domain graph compiles to the same arrays.  Then come the
    port's own predicates, which the JAX package does not have
    (``shared`` False): the kernels' limits (``_kernel_checks``), panels in
    bf16 (a ``precision='bf16'`` graph, unless ``tier_dtype`` names the
    dtype the caller launches with) that the tensor-core tier tile cannot
    stage, and, on a CUDA ``device`` where a card is present, CTAs of the
    persistent K2-K4 that cannot be co-resident.  Last, in the place of
    the JAX package's VMEM budget and shared with it, the working set
    (every buffer sized by its dtype, see ``_working_set_bytes``) must fit
    the card's memory (checked where a card is present)."""
    if cf.domain != "prob" and not tropical:  # JAX's first predicate
        return f"domain {cf.domain!r} != 'prob'", True
    if cf.strategy != "block":
        return f"strategy {cf.strategy!r} != 'block'", True
    if cf.batched:
        return ("batched CompiledFSM (the fused scan targets one shared "
                "graph)"), True
    if cf.alpha_hat.dtype not in (torch.float32, torch.float64):
        return (f"operator dtype {cf.alpha_hat.dtype} (the CUDA kernels "
                "are f32 or f64)"), True
    if not cf.pdf_group and not cf.ov_layout:
        return ("no uniform pdf-grouped layout (compile_fsm reorder "
                "declined or disabled)"), True
    if cf.omega_prob is None:
        return "no rank-1 omega split", True
    if cf.multi_pdf:
        return ("general multi-pdf C-hat (fused scan needs one pdf per "
                "state)"), True
    if cf.pdf_group:
        cmax, lim = cf.pdf_group
        if (cf.num_pdfs + 1) * cmax != lim:
            return "pdf-grouped layout not uniform over all pdfs", True
    plan, reason = _full_plan_explain(cf)
    if plan is None:
        return reason, True
    reason = _kernel_checks(cf, plan[0], plan[1])
    if reason is not None:
        return reason, False
    tier_dtype = tier_dtype or _tier_dtype(cf)
    if tier_dtype == torch.bfloat16:
        reason = _bf16_tile_reason(kernel_operator(cf))
        if reason is not None:
            return reason, False
    if (device is not None and torch.device(device).type == "cuda"
            and torch.cuda.is_available()):
        kop = kernel_operator(cf)
        for name, grid in (("K2/K3", _fwd_grid), ("K4", _bwd_grid)):
            if grid(kop, torch.device(device), B, tier_dtype) <= 0:
                return (f"the persistent {name} kernel cannot keep its CTAs "
                        "co-resident on this card (cooperative launch "
                        "unsupported or no CTA fits an SM)"), False
        need = _working_set_bytes(cf, B, n_frames, chunk)
        have = torch.cuda.get_device_properties(torch.device(device)).total_memory
        if need > have:
            return (f"device working set ~{need / 1e9:.1f} GB exceeds the "
                    f"card's {have / 1e9:.1f} GB (Sp = {cf.padded_states}, "
                    f"B = {B})"), True
    return None, True


def _bf16_tile_reason(kop):
    """None when the bf16 tier tile (csrc/block_scan.cu tier_tile_bf16) can
    stage both directions' panels, else the predicate it fails: the
    tensor-core product consumes whole 16-deep steps of the contraction."""
    for dname, kd in (("forward", kop.fwd), ("backward", kop.bwd)):
        Sm = kd.W.shape[1]
        if Sm % _BF16_K:
            return (f"{dname} operator: bf16 tier depth Sm = {Sm} not a "
                    f"multiple of the tensor-core step {_BF16_K}")
    return None


# ---------------------------------------------------------------------------
# the kernels' operator: per-direction band + tier tensors and index maps
# ---------------------------------------------------------------------------

class KernelDir(NamedTuple):
    offsets: tuple  # band offsets (dst - src)
    band_w: torch.Tensor  # (nO, Sp) in the graph's dtype, nO may be 0
    W: torch.Tensor  # (K, Sm, D) tier panels, f32, bf16 or f64 (_tier_dtype)
    src_map: tuple  # (g0, gk, gs): src(k, s) = g0 + k·gk + s·gs
    dst_map: tuple  # (d0, dk, dd): dst(k, d) = d0 + k·dk + d·dd
    src_rows: torch.Tensor  # (K, Sm) int64, the same map as an index
    dst_rows: torch.Tensor  # (K, D) int64
    band_rows: torch.Tensor  # (nband,) int32: rows the tier never writes
    heavy_rows: torch.Tensor  # (nheavy,) int32: rows with a tile each
    # overflow families as per-row lists of (source, weight) terms, in a
    # fixed order: row j's terms are fam_src/fam_w[fam_ptr[j]:fam_ptr[j+1]]
    fam_ptr: torch.Tensor  # (Sp + 1,) int32
    fam_src: torch.Tensor  # (nfam,) int32
    fam_w: torch.Tensor  # (nfam,) in the graph's dtype
    fam_dst: torch.Tensor  # (nfam,) int64, the row of each term


class KernelOp(NamedTuple):
    Sp: int
    P1: int  # pdfs + 1 (the phony pdf last)
    cmax: int  # states per pdf group (lane-group width)
    fin: int  # phony final state
    alpha0: torch.Tensor  # (Sp,) initial probabilities
    omega: torch.Tensor  # (Sp,) rank-1 arcs into the phony state
    fwd: KernelDir
    bwd: KernelDir
    row_pdf: torch.Tensor  # (Sp,) int32 pdf of each row (_row_pdf)
    # overflow rows [ov_lo, ov_hi) (ov_lo = ov_hi = Sp: uniform layout);
    # K4 sums their gammas into each pdf in a fixed order after the tile
    # sums: pdf p's rows are ov_lo + ovp_lane[ovp_ptr[p]:ovp_ptr[p+1]]
    ov_lo: int
    ov_hi: int
    ovp_ptr: torch.Tensor  # (P1 + 1,) int32
    ovp_lane: torch.Tensor  # (ov_hi - ov_lo,) int32, increasing per pdf
    # the host plans of K2-K4 (fwd_plan, bwd_plan), built once per shape of
    # a direction's tiles and column tiles, and their grids per device
    plans: dict


def _i32(x, device):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)


def _tier_dtype(cf):
    """The dtype of the tier panels the K2-K4 kernels get: bf16 for a
    ``precision='bf16'`` graph (the JAX package casts its f32 panels at
    the call, pallas_block.py:1089-1093), else the graph's, float32 or
    float64."""
    return torch.bfloat16 if cf.precision == "bf16" else cf.alpha_hat.dtype


def _kernel_dir(op, meta, Sp, device, dtype):
    g, d, src, dst, (fdst, fsrc, fw), band, heavy = _dir_rows(op, meta, Sp)
    nO = len(meta[0])
    band_w = (op.band_w if op.band_w is not None
              else torch.zeros((0, Sp), dtype=dtype))
    return KernelDir(
        offsets=tuple(int(o) for o in meta[0]),
        band_w=band_w.to(device=device, dtype=dtype).reshape(nO, Sp)
        .contiguous(),
        W=op.tiers[0][2].to(device=device, dtype=dtype).contiguous(),
        src_map=tuple(int(v) for v in g),
        dst_map=tuple(int(v) for v in d),
        src_rows=torch.from_numpy(src).to(device),
        dst_rows=torch.from_numpy(dst).to(device),
        band_rows=_i32(band, device),
        heavy_rows=_i32(heavy, device),
        fam_ptr=_i32(np.searchsorted(fdst, np.arange(Sp + 1)), device),
        fam_src=_i32(fsrc, device),
        fam_w=torch.from_numpy(np.ascontiguousarray(fw)).to(device=device,
                                                            dtype=dtype),
        fam_dst=torch.from_numpy(fdst).to(device),
    )


def kernel_operator(cf, tier_dtype=None) -> KernelOp:
    """The fused scan's operator for a graph whose plan passed, built once
    per CompiledFSM and panel dtype (cached on it).  ``tier_dtype``: the
    panels' dtype, by default ``_tier_dtype(cf)``; K7 asks for float32 on
    every float32 graph (the TPU K7 ignores the precision).  A bf16
    operator shares every table but the panels with the float32 one; a
    float64 graph's operator is float64 throughout (every value the
    kernels read: panels, bands, family weights, omega, alpha0)."""
    tier_dtype = tier_dtype or _tier_dtype(cf)
    key = ("block_scan", tier_dtype)
    kop = cf._cache.get(key)
    dtype = cf.alpha_hat.dtype
    if kop is None and tier_dtype != dtype:
        base = kernel_operator(cf, dtype)
        kop = base._replace(**{
            d: getattr(base, d)._replace(
                W=getattr(base, d).W.to(tier_dtype).contiguous())
            for d in ("fwd", "bwd")})
    elif kop is None:
        Sp = cf.padded_states
        dev = cf.alpha_hat.device
        P1 = cf.num_pdfs + 1
        row_pdf = _row_pdf(cf)
        ov_lo, ov_hi = _ov_bounds(cf)
        lane_pdf = row_pdf[ov_lo:ov_hi]
        lanes = np.argsort(lane_pdf, kind="stable")
        kop = KernelOp(
            Sp=Sp,
            P1=P1,
            cmax=(cf.pdf_group or cf.ov_layout)[0],
            fin=cf.final_state,
            alpha0=torch.exp(cf.alpha_hat).contiguous(),
            omega=cf.omega_prob.contiguous(),
            fwd=_kernel_dir(cf.block_fwd, cf.block_fwd_offsets, Sp, dev,
                            dtype),
            bwd=_kernel_dir(cf.block_bwd, cf.block_bwd_offsets, Sp, dev,
                            dtype),
            row_pdf=_i32(row_pdf, dev),
            ov_lo=ov_lo,
            ov_hi=ov_hi,
            ovp_ptr=_i32(np.searchsorted(lane_pdf[lanes], np.arange(P1 + 1)),
                         dev),
            ovp_lane=_i32(lanes, dev),
            plans={},
        )
    cf._cache[key] = kop
    return kop


# ---------------------------------------------------------------------------
# the host plans of K2-K4: the queues of work items of the persistent grids
# ---------------------------------------------------------------------------

class BwdPlan(NamedTuple):
    """The queue of K4's work items, the same in every frame of a chunk.
    An item is one row tile of the backward step (heavy rows first, then
    the tier tiles, then the 64-row band tiles, the order of
    :func:`_row_tiles`) times one 64-column tile, coded tile·ncb + column
    tile.  The CTAs of the persistent grid take the items in queue order,
    each the next one as it finishes the last (an atomic position per
    frame), so which CTA runs an item changes from run to run; nothing
    that is summed depends on it: each item's column sums of gamma are
    kept apart and added in tile order after the chunk.  Each entry also
    carries the first row of a band tile whose rows are consecutive (-1
    for any other tile), so that the kernel needs no row list for it."""
    ncb: int  # 64-column tiles: ceil(B / 64)
    queue: torch.Tensor  # (n_tiles * ncb, 2) int32: item, first row or -1


class FwdPlan(NamedTuple):
    """The queue of K2's and K3's work items in every frame, in K4's order
    (see :class:`BwdPlan`) with the tier items spread among the first
    _FWD_TIER_SPAN of the band items.  Each item's column max and its
    tile's partial of omega · y are kept apart from the others', so which
    CTA runs an item shows in no result.  The phony final row's tile
    (``fin_tile``, in :func:`_row_tiles`'s order, with its first row
    ``fin_row0`` or -1) has its partial taken again by the next frame's
    finalize from the final rows."""
    ncb: int
    queue: torch.Tensor  # (n_tiles * ncb, 2) int32
    fin_tile: int
    fin_row0: int


def _first_rows(kd: KernelDir, nh: int, nt: int, n_tiles: int):
    """The first row of each band tile whose rows are consecutive, -1 for
    every other tile (the kernels then need no row list for it)."""
    rows = kd.band_rows.cpu().numpy().astype(np.int64)
    row0 = np.full(n_tiles, -1, np.int64)
    for t in range(-(-len(rows) // _TILE_ROWS)):
        r = rows[t * _TILE_ROWS:(t + 1) * _TILE_ROWS]
        if (np.diff(r) == 1).all():
            row0[nh + nt + t] = r[0]
    return row0


def _tile_counts(kd: KernelDir, B: int):
    """(ncb, heavy tiles, tier tiles, all row tiles) of a direction."""
    nh, nband = kd.heavy_rows.numel(), kd.band_rows.numel()
    nt = kd.W.shape[0] * -(-kd.W.shape[2] // _TILE_ROWS)
    return -(-B // _TILE_ROWS), nh, nt, nh + nt + -(-nband // _TILE_ROWS)


def _queue(kd: KernelDir, B: int, span: float):
    """(queue (n_tiles * ncb, 2) int64, first row of each tile or -1) of a
    direction: the heavy rows first (the longest items), then the tier and
    band items interleaved, the tier items spread evenly among the first
    ``span`` of the band items, so that every SM multiplies and streams at
    the same time and the queue ends on short band items; each kind in
    tile, then column tile order."""
    ncb, nh, nt, n_tiles = _tile_counts(kd, B)
    item = np.arange(n_tiles * ncb)  # tile item // ncb, column % ncb
    tier = (item >= nh * ncb) & (item < (nh + nt) * ncb)
    band = item >= (nh + nt) * ncb
    pos = np.zeros(len(item))  # where each item falls in the queue
    pos[tier] = span * np.arange(tier.sum()) / max(tier.sum(), 1)
    pos[band] = np.arange(band.sum()) / max(band.sum(), 1)
    pos[~(tier | band)] = -1.0  # heavy rows first
    order = np.lexsort((band, pos))
    row0 = _first_rows(kd, nh, nt, n_tiles)
    return np.stack([order, row0[order // ncb]], axis=1), row0


def bwd_plan(kop: KernelOp, B: int) -> BwdPlan:
    """K4's queue for batch ``B`` (:func:`_queue` with _TIER_SPAN), built
    once per shape and cached on ``kop``."""
    counts = _tile_counts(kop.bwd, B)
    key = ("bwd_plan",) + counts
    pl = kop.plans.get(key)
    if pl is None:
        queue, _ = _queue(kop.bwd, B, _TIER_SPAN)
        pl = BwdPlan(ncb=counts[0], queue=_i32(queue, kop.row_pdf.device))
        kop.plans[key] = pl
    return pl


def fwd_plan(kop: KernelOp, B: int) -> FwdPlan:
    """K2's and K3's queue for batch ``B`` (:func:`_queue` with
    _FWD_TIER_SPAN) and the phony row's tile, built once per shape and
    cached on ``kop``."""
    kd = kop.fwd
    counts = _tile_counts(kd, B)
    key = ("fwd_plan",) + counts
    pl = kop.plans.get(key)
    if pl is None:
        queue, row0 = _queue(kd, B, _FWD_TIER_SPAN)
        tile = _row_tiles(*(t.cpu().numpy() for t in
                            (kd.dst_rows, kd.band_rows, kd.heavy_rows)),
                          kop.Sp)
        fin_tile = int(tile[kop.fin])
        pl = FwdPlan(ncb=counts[0], queue=_i32(queue, kop.row_pdf.device),
                     fin_tile=fin_tile, fin_row0=int(row0[fin_tile]))
        kop.plans[key] = pl
    return pl


def _coop_grid(kop: KernelOp, device, B: int, tier_dtype, bwd: bool) -> int:
    """CTAs of the persistent grid of K4 (``bwd``) or K2/K3: as many as can
    be co-resident on the CUDA ``device`` for this instantiation (the
    library asks the occupancy API; cached on ``kop``), or _CTAS_PER_SM
    (K4) or _FWD_CTAS_PER_SM per SM of an H100 elsewhere (a plan to
    inspect, never to launch)."""
    device = torch.device(device)
    if device.type != "cuda":
        return (_CTAS_PER_SM if bwd else _FWD_CTAS_PER_SM) * _SMS
    from . import _build

    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    kd = kop.bwd if bwd else kop.fwd
    fam = kd.fam_dst.numel() > 0 or kop.ov_lo < kop.ov_hi
    # each instantiation its own: the float64 one holds more registers and
    # shared memory per CTA, so fewer fit an SM
    key = ("grid", idx, int(bwd), B % 4 == 0, fam, _prec(tier_dtype))
    if key not in kop.plans:
        with torch.cuda.device(idx):
            n = _build.library().mm_block_ctas(*(int(v) for v in key[2:]))
        if n < 0:
            _raise_on(-n, "mm_block_ctas")
        kop.plans[key] = n
    return kop.plans[key]


def _bwd_grid(kop: KernelOp, device, B: int, tier_dtype) -> int:
    """CTAs of K4's persistent grid (:func:`_coop_grid`)."""
    return _coop_grid(kop, device, B, tier_dtype, True)


def _fwd_grid(kop: KernelOp, device, B: int, tier_dtype) -> int:
    """CTAs of K2's and K3's persistent grid (:func:`_coop_grid`)."""
    return _coop_grid(kop, device, B, tier_dtype, False)


# ---------------------------------------------------------------------------
# plain PyTorch twins (the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

def _pow2_exponent(m):
    """floor(log2 m) from the exponent bits (exact), 0 where m == 0,
    clamped at -126 (float32) or -1022 (float64) so that 2^-k stays a
    finite normal number of m's dtype."""
    _, e = torch.frexp(m)
    lo = -1022.0 if m.dtype == torch.float64 else -126.0
    k = (e - 1).to(m.dtype).clamp(min=lo)
    return torch.where(m > 0, k, torch.zeros_like(m))


def _pow2_scale(k):
    """2^-k in k's dtype for integer-valued k in [-126, 126] (float32) or
    [-1022, 1022] (float64), built from its exponent bits (exact on every
    device, unlike exp2)."""
    if k.dtype == torch.float64:
        return ((1023 - k.to(torch.int64)) << 52).view(torch.float64)
    return ((127 - k.to(torch.int32)) << 23).view(torch.float32)


def _kahan_step(acc, k, msh):
    """acc (3, B) = (ksum, shift, comp) advanced by one frame's exponent
    ``k`` and emission shift ``msh``, in place, in the kernels' order (the
    Viterbi sweeps' twins, ops/dense_scan.py and ops/vit_scan.py)."""
    acc[0] += k
    xc = msh - acc[2]
    tsum = acc[1] + xc
    acc[2] = (tsum - acc[1]) - xc
    acc[1] = tsum


def _matvec_plain(kd: KernelDir, x):
    """K1's plain twin: y = band(x) + tier(x) + families(x) over the
    direction's core.  With bf16 panels the tier is the f32 product of the
    panels and the gathered rows, both rounded to bf16 (the kernel's
    tensor-core product, JAX's DEFAULT-precision dot), summed in s order
    one elementwise step at a time: a bf16 rounding of the next state
    turns a last-bit difference into 2^-8 of a term, so the sum order must
    not depend on how a library splits a product over threads; the bands
    and the families stay f32, as in the JAX package's ``apply_ov``."""
    y = torch.zeros_like(x)
    for o, off in enumerate(kd.offsets):
        # band edge src = dst - off; wrapped rows carry zero weight
        y += kd.band_w[o][:, None] * torch.roll(x, off, dims=0)
    Xg = x[kd.src_rows]
    if kd.W.dtype == torch.bfloat16:
        W, Xg = kd.W.float(), round_bf16(Xg)
        Y = x.new_zeros((W.shape[0], W.shape[2], x.shape[1]))
        for s in range(W.shape[1]):
            Y.addcmul_(W[:, s, :, None], Xg[:, s, None, :])
    else:
        Y = torch.einsum("ksd,ksb->kdb", kd.W, Xg)
    y.index_add_(0, kd.dst_rows.reshape(-1), Y.reshape(-1, x.shape[1]))
    if kd.fam_dst.numel():
        y.index_add_(0, kd.fam_dst,
                     kd.fam_w[:, None] * x[kd.fam_src.long()])
    return y


def _emissions(kop: KernelOp, e_t):
    """(P1, B) emissions of one frame -> (Sp, B), each row its pdf's."""
    return e_t[kop.row_pdf.long()]


def _fwd_frame_plain(kop: KernelOp, a, s, e_t, first: bool):
    """One forward frame: y = (M a)·s ⊙ e with y[fin] = (ω·a)·s ⊙ e, or
    y = a ⊙ e on frame 0.  Returns (y unscaled, its exponent k (B,)); the
    new scale is 2^-k."""
    e = _emissions(kop, e_t)
    if first:
        y = a * e
    else:
        y = _matvec_plain(kop.fwd, a) * s
        y[kop.fin] = (kop.omega @ a) * s
        y = y * e
    return y, _pow2_exponent(y.amax(dim=0))


def fwd_sweep_plain(kop: KernelOp, a0, ext, mshift, chunk: int):
    """Plain twin of K2.  Returns (bounds (C, Sp, B) unscaled checkpoints,
    bscale (C, B), a_last (Sp, B), s_last (B,), ksum (B,), shift (B,))."""
    Npad, _, B = ext.shape
    C = Npad // chunk
    bounds = a0.new_empty((C, kop.Sp, B))
    bscale = a0.new_empty((C, B))
    a, s = a0, a0.new_ones(B)
    ksum, shift, comp = (a0.new_zeros(B) for _ in range(3))
    for t in range(Npad):
        if t % chunk == 0:
            bounds[t // chunk] = a
            bscale[t // chunk] = s
        a, k = _fwd_frame_plain(kop, a, s, ext[t], t == 0)
        s = _pow2_scale(k)
        ksum = ksum + k
        # Kahan-compensated accumulation of the factored emission shift
        xc = mshift[t, 0] - comp
        tsum = shift + xc
        comp = (tsum - shift) - xc
        shift = tsum
    return bounds, bscale, a, s, ksum, shift


def recompute_plain(kop: KernelOp, bound, bscale, ext_c, t0: int):
    """Plain twin of K3: frames t0 .. t0+K-1 from a checkpoint.  Returns
    (alphas (K, Sp, B) unscaled, ascale (K, B))."""
    K = ext_c.shape[0]
    alphas = bound.new_empty((K,) + bound.shape)
    ascale = bscale.new_empty((K,) + bscale.shape)
    a, s = bound, bscale
    for j in range(K):
        a, k = _fwd_frame_plain(kop, a, s, ext_c[j], t0 + j == 0)
        s = _pow2_scale(k)
        alphas[j], ascale[j] = a, s
    return alphas, ascale


def backward_plain(kop: KernelOp, beta, bscale, alphas, ascale, ext_c,
                   t0: int, npad: int):
    """Plain twin of K4: the reverse sweep over frames t0+K-1 .. t0.
    Returns (posts (K, P1, B), beta_out (Sp, B) unscaled, bscale_out)."""
    K = ext_c.shape[0]
    B = beta.shape[1]
    posts = beta.new_empty((K, kop.P1, B))
    b, s = beta, bscale
    for j in reversed(range(K)):
        if t0 + j == npad - 1:
            y = torch.ones_like(b)
        else:
            y = (_matvec_plain(kop.bwd, b)
                 + kop.omega[:, None] * b[kop.fin][None, :]) * s
        g = alphas[j] * ascale[j] * y
        sp = g.new_zeros((kop.P1, B)).index_add_(0, kop.row_pdf.long(), g)
        tot = sp.sum(dim=0)
        posts[j] = sp / torch.where(tot > 0, tot, torch.ones_like(tot))
        b = y * _emissions(kop, ext_c[j])
        s = _pow2_scale(_pow2_exponent(b.amax(dim=0)))
    return posts, b, s


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_N_TILES = 23  # index of the tile count in _imeta's descriptor


def _imeta(kop: KernelOp, kd: KernelDir) -> np.ndarray:
    """Host int64 descriptor read by csrc/block_scan.cu (layout: Meta)."""
    K, Sm, D = kd.W.shape
    nband = kd.band_rows.numel()
    nfam, nheavy = kd.fam_dst.numel(), kd.heavy_rows.numel()
    n_tiles = K * -(-D // _TILE_ROWS) + -(-nband // _TILE_ROWS) + nheavy
    offs = list(kd.offsets) + [0] * (_MAX_BANDS - len(kd.offsets))
    return np.array(
        [kop.Sp, kop.P1, kop.cmax, kop.fin, len(kd.offsets), *offs,
         K, Sm, D, *kd.src_map, *kd.dst_map, nband, n_tiles,
         kop.ov_lo, kop.ov_hi, nfam, nheavy],
        dtype=np.int64,
    )


def _ilayout(kop: KernelOp, kd: KernelDir) -> np.ndarray:
    """Host int64 array of the layout tables' device addresses, read by
    csrc/block_scan.cu (layout: Layout)."""
    tables = (kop.row_pdf, kd.fam_ptr, kd.fam_src, kd.fam_w, kop.ovp_ptr,
              kop.ovp_lane, kd.heavy_rows)
    # an empty table (uniform layout) passes an address that is never read
    return np.array([(t if t.numel() else kop.row_pdf).data_ptr()
                     for t in tables], dtype=np.int64)


def _route(x: torch.Tensor, kernel: str = "blocked-scan") -> bool:
    """True for the CUDA kernel, False for the plain twin (CPU tensors)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {x.device}")
    return True


def _check(name, t, shape, dev, dtype=torch.float32):
    if t.device != dev:
        raise ValueError(f"{name}: expected a tensor on {dev}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_op(kop: KernelOp, kd: KernelDir, dev, tier_dtype=torch.float32):
    """The operator's tensors on ``dev``: the values in the dtype of the
    instantiation (float64 for float64 panels, else float32), the panels
    in ``tier_dtype``, the tables int32."""
    vdt = _value_dtype(tier_dtype)
    for name, t in (("alpha0", kop.alpha0), ("omega", kop.omega),
                    ("band_w", kd.band_w), ("fam_w", kd.fam_w)):
        _check(name, t, t.shape, dev, vdt)
    _check("W", kd.W, kd.W.shape, dev, tier_dtype)
    for name, t in (("band_rows", kd.band_rows), ("row_pdf", kop.row_pdf),
                    ("fam_ptr", kd.fam_ptr), ("fam_src", kd.fam_src),
                    ("heavy_rows", kd.heavy_rows),
                    ("ovp_ptr", kop.ovp_ptr), ("ovp_lane", kop.ovp_lane)):
        _check(name, t, t.shape, dev, torch.int32)


def _tier_check(kop: KernelOp, kd: KernelDir):
    """The panel dtype of a K2-K4 launch: float32, float64 (the float64
    instantiation), or bf16 that the tensor-core tier tile can stage (the
    entry points' ``prec`` code, :func:`_prec`); anything else raises."""
    if kd.W.dtype == torch.bfloat16:
        reason = _bf16_tile_reason(kop)
        if reason is not None:
            raise ValueError(f"bf16 tier tile: {reason}")
    elif kd.W.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"W: tier panels of dtype {kd.W.dtype} (the "
                         "kernels take float32, bfloat16 or float64)")
    return kd.W.dtype


def _value_dtype(wdt):
    """The dtype of every value of a launch with panels of ``wdt``."""
    return torch.float64 if wdt == torch.float64 else torch.float32


def _p(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(rc: int, entry: str):
    if rc != 0:
        from . import _build

        raise RuntimeError(f"{entry} failed: {_build.error_string(rc)}")


# zeroed words of the forward's grid barrier (SYNC_GEN + 1 in
# csrc/block_scan.cu)
_FWD_SYNC_WORDS = 33


def _fwd_launch(kop: KernelOp, dev, B: int, T: int):
    """What K2's and K3's launch shares: the panel dtype, its checks, the
    descriptors, the queue, the grid and the per-frame scratch of T frames:
    the two sets of per-tile omega partials, and (one zeroed int32 block)
    the grid barrier's words, every frame's column max (the value's bits,
    _CM_COPIES copies, two words each for float64) and every frame's queue
    position."""
    wdt = _tier_check(kop, kop.fwd)
    _check_op(kop, kop.fwd, dev, wdt)
    G = _fwd_grid(kop, dev, B, wdt)
    if G <= 0:
        raise ValueError("the persistent K2/K3 kernel cannot keep its CTAs "
                         f"co-resident on {dev}")
    pl = fwd_plan(kop, B)
    meta, lay = _imeta(kop, kop.fwd), _ilayout(kop, kop.fwd)
    vdt = _value_dtype(wdt)
    part = torch.empty((2, int(meta[_N_TILES]), B), device=dev, dtype=vdt)
    # float64's column maxima start on an 8-byte boundary
    n_sync = _FWD_SYNC_WORDS + (vdt == torch.float64)
    n_cm = T * _CM_COPIES * B * (vdt.itemsize // 4)
    words = torch.zeros(n_sync + n_cm + T, dtype=torch.int32, device=dev)
    at = lambda n: ctypes.c_void_p(words.data_ptr() + 4 * n)
    kd = kop.fwd
    args = (_p(kd.band_w), _p(kd.W), _p(kop.omega), _p(kd.band_rows),
            ctypes.c_void_p(meta.ctypes.data),
            ctypes.c_void_p(lay.ctypes.data), _p(pl.queue),
            pl.queue.shape[0], G, pl.fin_tile, pl.fin_row0)
    scratch = (_p(part), at(n_sync), at(n_sync + n_cm), _p(words))
    # the host arrays and buffers live until the launch has been queued
    return wdt, args, scratch, (meta, lay, part, words)


def fwd_sweep(kop: KernelOp, a0, ext, mshift, chunk: int):
    """K2: forward sweep over all Npad frames (Npad a multiple of
    ``chunk``), one cooperative launch whose CTAs take the items of
    :func:`fwd_plan` from a queue in every frame.  Same outputs as
    :func:`fwd_sweep_plain`."""
    if not _route(a0):
        return fwd_sweep_plain(kop, a0, ext, mshift, chunk)
    from . import _build

    Npad, P1, B = ext.shape
    Sp = kop.Sp
    dev = a0.device
    if Npad % chunk:
        raise ValueError(f"{Npad} frames not a multiple of chunk {chunk}")
    vdt = _value_dtype(kop.fwd.W.dtype)
    _check("a0", a0, (Sp, B), dev, vdt)
    _check("ext", ext, (Npad, kop.P1, B), dev, vdt)
    _check("mshift", mshift, (Npad, 1, B), dev, vdt)
    wdt, args, scratch, keep = _fwd_launch(kop, dev, B, Npad)
    C = Npad // chunk
    new = lambda *shape: torch.empty(shape, device=dev, dtype=vdt)
    work, a_last = new(2, Sp, B), new(Sp, B)
    bounds, bscale, scale = new(C, Sp, B), new(C, B), new(B)
    ones = torch.ones(B, device=dev, dtype=vdt)
    ksum, shift, comp = (torch.zeros(B, device=dev, dtype=vdt)
                         for _ in range(3))
    with torch.cuda.device(dev):  # the library launches on it
        rc = _build.library().mm_block_fwd(
            _p(a0), _p(ones), _p(ext), _p(mshift), *args, B, Npad, chunk,
            _prec(wdt), _p(work), _p(a_last), _p(bounds),
            _p(bscale), _p(scale), _p(ksum), _p(shift), _p(comp), *scratch,
            _stream(dev),
        )
    _raise_on(rc, "mm_block_fwd")
    _counts(wdt)["block_fwd"] += 1
    return bounds, bscale, a_last, scale, ksum, shift


def recompute(kop: KernelOp, bound, bscale, ext_c, t0: int):
    """K3: one chunk's forward frames from its checkpoint, one cooperative
    launch.  Same outputs as :func:`recompute_plain`."""
    if not _route(bound):
        return recompute_plain(kop, bound, bscale, ext_c, t0)
    from . import _build

    K, P1, B = ext_c.shape
    Sp = kop.Sp
    dev = bound.device
    vdt = _value_dtype(kop.fwd.W.dtype)
    _check("bound", bound, (Sp, B), dev, vdt)
    _check("bscale", bscale, (B,), dev, vdt)
    _check("ext", ext_c, (K, kop.P1, B), dev, vdt)
    wdt, args, scratch, keep = _fwd_launch(kop, dev, B, K)
    alphas = torch.empty((K, Sp, B), device=dev, dtype=vdt)
    ascale = torch.empty((K, B), device=dev, dtype=vdt)
    with torch.cuda.device(dev):
        rc = _build.library().mm_block_recompute(
            _p(bound), _p(bscale), _p(ext_c), *args, B, t0, K,
            _prec(wdt), _p(alphas), _p(ascale), *scratch,
            _stream(dev),
        )
    _raise_on(rc, "mm_block_recompute")
    _counts(wdt)["block_recompute"] += 1
    return alphas, ascale


def backward(kop: KernelOp, beta, bscale, alphas, ascale, ext_c, t0: int,
             npad: int):
    """K4: the reverse sweep over one chunk, one cooperative launch whose
    CTAs take the items of :func:`bwd_plan` from a queue in every frame.
    Same outputs as :func:`backward_plain`."""
    if not _route(beta):
        return backward_plain(kop, beta, bscale, alphas, ascale, ext_c, t0,
                              npad)
    from . import _build

    K, P1, B = ext_c.shape
    Sp = kop.Sp
    dev = beta.device
    wdt = _tier_check(kop, kop.bwd)
    _check_op(kop, kop.bwd, dev, wdt)
    vdt = _value_dtype(wdt)
    _check("beta", beta, (Sp, B), dev, vdt)
    _check("bscale", bscale, (B,), dev, vdt)
    _check("alphas", alphas, (K, Sp, B), dev, vdt)
    _check("ascale", ascale, (K, B), dev, vdt)
    _check("ext", ext_c, (K, kop.P1, B), dev, vdt)
    G = _bwd_grid(kop, dev, B, wdt)
    if G <= 0:
        raise ValueError("the persistent K4 kernel cannot keep its CTAs "
                         f"co-resident on {dev}")
    pl = bwd_plan(kop, B)
    n_items = pl.queue.shape[0]
    meta, lay = _imeta(kop, kop.bwd), _ilayout(kop, kop.bwd)
    new = lambda *shape: torch.empty(shape, device=dev, dtype=vdt)
    # accumulated atomically
    posts = torch.zeros((K, kop.P1, B), device=dev, dtype=vdt)
    # every frame's overflow-row gammas and per-item column sums of gamma,
    # read by the normalisation after the chunk's last frame
    ovg = new(K, max(kop.ov_hi - kop.ov_lo, 1), B)
    csum = new(K, n_items, _TILE_ROWS)
    # the grid barrier's counter and generation, every frame's column max
    # of beta (the value's bits, _CM_COPIES copies, two words each for
    # float64), every frame's queue position
    n_cm = K * _CM_COPIES * B * (vdt.itemsize // 4)
    words = torch.zeros(2 + n_cm + K, dtype=torch.int32, device=dev)
    work, beta_out, scale = new(2, Sp, B), new(Sp, B), new(B)
    kd = kop.bwd
    with torch.cuda.device(dev):
        rc = _build.library().mm_block_bwd(
            _p(beta), _p(bscale), _p(alphas), _p(ascale), _p(ext_c),
            _p(kd.band_w), _p(kd.W), _p(kop.omega), _p(kd.band_rows),
            ctypes.c_void_p(meta.ctypes.data),
            ctypes.c_void_p(lay.ctypes.data), _p(pl.queue), n_items, G, B,
            t0, K, npad, _prec(wdt), _p(work),
            _p(beta_out), _p(scale), _p(posts), _p(ovg), _p(csum),
            ctypes.c_void_p(words.data_ptr() + 8),
            ctypes.c_void_p(words.data_ptr() + 4 * (2 + n_cm)), _p(words),
            _stream(dev),
        )
    _raise_on(rc, "mm_block_bwd")
    _counts(wdt)["block_bwd"] += 1
    return posts, beta_out, scale


# ---------------------------------------------------------------------------
# the chunked scan
# ---------------------------------------------------------------------------

def block_fused_fb(cf, ext, mshift, want_posts, *, chunk=64):
    """Run the blocked scan.  ``ext``/``mshift`` from
    ops.emissions.prepare_emissions ((Nf, P1, B) / (Nf, 1, B)).  Returns
    (posts (Npad, P1, B) or None, v_final (B,), shift (B,), ksum (B,)):
    logZ = log(v_final) + ksum·ln2 + shift.

    The whole batch runs in one pass: no batch slicing.  The chunk loop
    (reversed: recompute a chunk's alphas, then sweep it backwards) is a
    Python loop over K3 and K4."""
    Nf, P1, B = ext.shape
    reason = block_scan_reject_reason(cf, B, n_frames=Nf - 1, chunk=chunk,
                                      device=ext.device)
    if reason is not None:
        raise ValueError(f"blocked scan rejected this graph: {reason}")
    kop = kernel_operator(cf)
    K = min(chunk, Nf)
    C = -(-Nf // K)
    Npad = C * K
    ext, mshift = pad_emissions(ext, mshift, Npad)
    a0 = kop.alpha0[:, None].expand(kop.Sp, B).contiguous()
    bounds, bscale, a_last, s_last, ksum, shift = fwd_sweep(
        kop, a0, ext, mshift, K
    )
    vfin = a_last[kop.fin] * s_last
    if not want_posts:
        return None, vfin, shift, ksum
    posts = ext.new_empty((Npad, kop.P1, B))
    beta = torch.ones_like(a0)
    bsc = ext.new_ones(B)
    for c in reversed(range(C)):
        sl = slice(c * K, (c + 1) * K)
        alphas, ascale = recompute(kop, bounds[c], bscale[c], ext[sl], c * K)
        posts[sl], beta, bsc = backward(kop, beta, bsc, alphas, ascale,
                                        ext[sl], c * K, Npad)
    return posts, vfin, shift, ksum
