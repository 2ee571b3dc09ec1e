"""Blocked forward-backward scan on the GPU: hand-written CUDA kernels with
plain PyTorch twins.

Counterpart of ``markovmodels_tpu/ops/pallas_block.py``.  One shared graph
(the LF-MMI denominator) runs over a (Sp, B) probability state:

* K2 ``fwd_sweep``: the forward sweep over all frames, keeping one state
  checkpoint per chunk and the pieces of logZ (replaces ``_run_slice``'s
  forward ``pallas_call``, ``_make_fwd_kernel``);
* K3 ``recompute``: re-runs one chunk's forward frames from its checkpoint
  and keeps every frame's alpha (replaces ``_make_recompute_kernel``);
* K4 ``backward``: the reverse sweep over one chunk: beta carry,
  gamma = alpha * beta reduced over pdf groups, posteriors normalised per
  frame (replaces ``_make_bwd_kernel``).

All three are built on one blocked matvec (band offsets + one affine tier +
the rank-1 omega split), the counterpart of ``_make_matvec``.  The CUDA
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

from .emissions import pad_emissions

__all__ = [
    "block_scan_reject_reason",
    "kernel_operator",
    "fwd_sweep",
    "recompute",
    "backward",
    "fwd_sweep_plain",
    "recompute_plain",
    "backward_plain",
    "block_fused_fb",
    "LAUNCHES",
    "reset_launch_counts",
]

# launches of each CUDA kernel entry point, counted by its wrapper
LAUNCHES = {"block_fwd": 0, "block_recompute": 0, "block_bwd": 0}

_TILE_ROWS = 64  # state rows per CUDA tile (TR in csrc/block_scan.cu)
_MAX_BANDS = 8  # band offsets a kernel takes (build_block_operator's cap)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _full_plan_explain(cf):
    """((W, R, plan_fwd, plan_bwd), None) or (None, reason)."""
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
    if not cf.pdf_group:
        if cf.ov_layout:
            return None, ("overflow layout (ROADMAP: port the overflow "
                          "families)")
        return None, "no pdf-grouped or overflow layout"
    cmax, lim = cf.pdf_group
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
    pf, rf = _dir_plan_explain(cf.block_fwd, cf.block_fwd_offsets, W, R, cmax)
    if pf is None:
        return None, f"forward operator: {rf}"
    pb, rb = _dir_plan_explain(cf.block_bwd, cf.block_bwd_offsets, W, R, cmax)
    if pb is None:
        return None, f"backward operator: {rb}"
    for plan, meta, dname in ((pf, metas[0], "forward"),
                              (pb, metas[1], "backward")):
        if len(meta) > 3 and meta[3]:
            return None, f"{dname} operator: ov families without ov layout"
        plan["ov"] = ()
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


def _kernel_checks(cf):
    """Port-specific predicates on top of the plan (None or a reason)."""
    Sp = cf.padded_states
    cmax, lim = cf.pdf_group
    if lim != Sp:
        return (f"pdf-grouped layout ({lim} slots) does not fill the "
                f"padded states ({Sp})")
    for dname, op, meta in (("forward", cf.block_fwd, cf.block_fwd_offsets),
                            ("backward", cf.block_bwd, cf.block_bwd_offsets)):
        if len(meta[0]) > _MAX_BANDS:
            return f"{dname} operator: more than {_MAX_BANDS} band offsets"
        _, _, src, dst = _dir_index_maps(op, meta)
        if src.min() < 0 or src.max() >= Sp or dst.min() < 0 or dst.max() >= Sp:
            return f"{dname} operator: tier window outside the state range"
        if len(np.unique(dst)) != dst.size:
            return f"{dname} operator: tier writes a state row twice"
    return None


def _working_set_bytes(cf, B, n_frames, chunk):
    """Device bytes of one fused run, every buffer sized by its dtype."""
    Sp, P1 = cf.padded_states, cf.num_pdfs + 1
    f = cf.alpha_hat.element_size()
    tens = [cf.omega_prob, cf.alpha_hat]
    for op in (cf.block_fwd, cf.block_bwd):
        tens += [t for t in (op.band_w, op.tiers[0][2]) if t is not None]
    need = sum(t.numel() * t.element_size() for t in tens)
    K = min(chunk, n_frames + 1) if n_frames else chunk
    C = -(-(n_frames + 1) // K) if n_frames else 1
    # a0 + ping-pong pair + last state + two betas, the chunk's alphas,
    # the checkpoints, and emissions + posteriors over all padded frames
    need += (6 + K + C) * Sp * B * f
    need += 2 * C * K * P1 * B * f
    return need


def block_scan_reject_reason(cf, B: int, *, n_frames: int | None = None,
                             chunk: int = 64, device=None):
    """None when the CUDA blocked scan accepts this graph, else a one-line
    reason naming the FIRST rejected predicate.  The predicates up to the
    plan are the JAX package's, in its order.  Instead of its VMEM budget,
    the working set (every buffer sized by its dtype, see
    ``_working_set_bytes``) must fit the memory of ``device`` when that is
    a CUDA device (checked where a card is present)."""
    if cf.strategy != "block":
        return f"strategy {cf.strategy!r} != 'block'"
    if cf.batched:
        return "batched CompiledFSM (the fused scan targets one shared graph)"
    if cf.alpha_hat.dtype != torch.float32:
        return (f"operator dtype {cf.alpha_hat.dtype} (fused kernels are "
                "f32)")
    if not cf.pdf_group and not cf.ov_layout:
        return ("no uniform pdf-grouped layout (compile_fsm reorder "
                "declined or disabled)")
    if cf.omega_prob is None:
        return "no rank-1 omega split"
    if cf.multi_pdf:
        return "general multi-pdf C-hat (fused scan needs one pdf per state)"
    if cf.pdf_group:
        cmax, lim = cf.pdf_group
        if (cf.num_pdfs + 1) * cmax != lim:
            return "pdf-grouped layout not uniform over all pdfs"
    plan, reason = _full_plan_explain(cf)
    if plan is None:
        return reason
    reason = _kernel_checks(cf)
    if reason is not None:
        return reason
    if (device is not None and torch.device(device).type == "cuda"
            and torch.cuda.is_available()):
        need = _working_set_bytes(cf, B, n_frames, chunk)
        have = torch.cuda.get_device_properties(torch.device(device)).total_memory
        if need > have:
            return (f"device working set ~{need / 1e9:.1f} GB exceeds the "
                    f"card's {have / 1e9:.1f} GB (Sp = {cf.padded_states}, "
                    f"B = {B})")
    return None


# ---------------------------------------------------------------------------
# the kernels' operator: per-direction band + tier tensors and index maps
# ---------------------------------------------------------------------------

class KernelDir(NamedTuple):
    offsets: tuple  # band offsets (dst - src)
    band_w: torch.Tensor  # (nO, Sp) f32, nO may be 0
    W: torch.Tensor  # (K, Sm, D) f32 tier panels
    src_map: tuple  # (g0, gk, gs): src(k, s) = g0 + k·gk + s·gs
    dst_map: tuple  # (d0, dk, dd): dst(k, d) = d0 + k·dk + d·dd
    src_rows: torch.Tensor  # (K, Sm) int64, the same map as an index
    dst_rows: torch.Tensor  # (K, D) int64
    band_rows: torch.Tensor  # (nband,) int32: rows the tier never writes


class KernelOp(NamedTuple):
    Sp: int
    P1: int  # pdf groups = num_pdfs + 1 (the phony pdf last)
    cmax: int  # states per pdf group
    fin: int  # phony final state
    alpha0: torch.Tensor  # (Sp,) initial probabilities
    omega: torch.Tensor  # (Sp,) rank-1 arcs into the phony state
    fwd: KernelDir
    bwd: KernelDir


def _kernel_dir(op, meta, Sp, device):
    g, d, src, dst = _dir_index_maps(op, meta)
    band_rows = np.setdiff1d(np.arange(Sp, dtype=np.int64), dst.ravel())
    nO = len(meta[0])
    band_w = (op.band_w if op.band_w is not None
              else torch.zeros((0, Sp), dtype=torch.float32))
    return KernelDir(
        offsets=tuple(int(o) for o in meta[0]),
        band_w=band_w.to(device=device, dtype=torch.float32).reshape(nO, Sp)
        .contiguous(),
        W=op.tiers[0][2].to(device=device, dtype=torch.float32).contiguous(),
        src_map=tuple(int(v) for v in g),
        dst_map=tuple(int(v) for v in d),
        src_rows=torch.from_numpy(src).to(device),
        dst_rows=torch.from_numpy(dst).to(device),
        band_rows=torch.from_numpy(band_rows.astype(np.int32)).to(device),
    )


def kernel_operator(cf) -> KernelOp:
    """The fused scan's operator for an accepted graph, built once per
    CompiledFSM (cached on it)."""
    kop = cf._cache.get("block_scan")
    if kop is None:
        Sp = cf.padded_states
        dev = cf.alpha_hat.device
        kop = KernelOp(
            Sp=Sp,
            P1=cf.num_pdfs + 1,
            cmax=cf.pdf_group[0],
            fin=cf.final_state,
            alpha0=torch.exp(cf.alpha_hat).contiguous(),
            omega=cf.omega_prob.contiguous(),
            fwd=_kernel_dir(cf.block_fwd, cf.block_fwd_offsets, Sp, dev),
            bwd=_kernel_dir(cf.block_bwd, cf.block_bwd_offsets, Sp, dev),
        )
        cf._cache["block_scan"] = kop
    return kop


# ---------------------------------------------------------------------------
# plain PyTorch twins (the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------

def _pow2_exponent(m):
    """floor(log2 m) from the exponent bits (exact), 0 where m == 0,
    clamped at -126 so that 2^-k stays a finite float32."""
    _, e = torch.frexp(m)
    k = (e - 1).to(m.dtype).clamp(min=-126.0)
    return torch.where(m > 0, k, torch.zeros_like(m))


def _pow2_scale(k):
    """2^-k for integer-valued float32 k in [-126, 126], built from its
    exponent bits (exact on every device, unlike exp2)."""
    return ((127 - k.to(torch.int32)) << 23).view(torch.float32)


def _matvec_plain(kd: KernelDir, x):
    """K1's plain twin: y = band(x) + tier(x) over the direction's core."""
    y = torch.zeros_like(x)
    for o, off in enumerate(kd.offsets):
        # band edge src = dst - off; wrapped rows carry zero weight
        y += kd.band_w[o][:, None] * torch.roll(x, off, dims=0)
    Y = torch.einsum("ksd,ksb->kdb", kd.W, x[kd.src_rows])
    y.index_add_(0, kd.dst_rows.reshape(-1), Y.reshape(-1, x.shape[1]))
    return y


def _fwd_frame_plain(kop: KernelOp, a, s, e_t, first: bool):
    """One forward frame: y = (M a)·s ⊙ e with y[fin] = (ω·a)·s ⊙ e, or
    y = a ⊙ e on frame 0.  Returns (y unscaled, its exponent k (B,)); the
    new scale is 2^-k."""
    e = e_t.repeat_interleave(kop.cmax, dim=0)
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
        sp = g.reshape(kop.P1, kop.cmax, B).sum(dim=1)
        tot = sp.sum(dim=0)
        posts[j] = sp / torch.where(tot > 0, tot, torch.ones_like(tot))
        b = y * ext_c[j].repeat_interleave(kop.cmax, dim=0)
        s = _pow2_scale(_pow2_exponent(b.amax(dim=0)))
    return posts, b, s


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _imeta(kop: KernelOp, kd: KernelDir) -> np.ndarray:
    """Host int64 descriptor read by csrc/block_scan.cu (layout: Meta)."""
    K, Sm, D = kd.W.shape
    nband = kd.band_rows.numel()
    n_tiles = K * -(-D // _TILE_ROWS) + -(-nband // _TILE_ROWS)
    offs = list(kd.offsets) + [0] * (_MAX_BANDS - len(kd.offsets))
    return np.array(
        [kop.Sp, kop.P1, kop.cmax, kop.fin, len(kd.offsets), *offs,
         K, Sm, D, *kd.src_map, *kd.dst_map, nband, n_tiles],
        dtype=np.int64,
    )


def _route(x: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain twin (CPU tensors)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no blocked-scan kernel for device {x.device}")
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


def _check_op(kop: KernelOp, kd: KernelDir, dev):
    for name, t in (("alpha0", kop.alpha0), ("omega", kop.omega),
                    ("band_w", kd.band_w), ("W", kd.W)):
        _check(name, t, t.shape, dev)
    _check("band_rows", kd.band_rows, kd.band_rows.shape, dev, torch.int32)


def _p(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(rc: int, entry: str):
    if rc != 0:
        from . import _build

        raise RuntimeError(f"{entry} failed: {_build.error_string(rc)}")


def fwd_sweep(kop: KernelOp, a0, ext, mshift, chunk: int):
    """K2: forward sweep over all Npad frames (Npad a multiple of
    ``chunk``).  Same outputs as :func:`fwd_sweep_plain`."""
    if not _route(a0):
        return fwd_sweep_plain(kop, a0, ext, mshift, chunk)
    from . import _build

    Npad, P1, B = ext.shape
    Sp = kop.Sp
    if Npad % chunk:
        raise ValueError(f"{Npad} frames not a multiple of chunk {chunk}")
    _check_op(kop, kop.fwd, a0.device)
    _check("a0", a0, (Sp, B), a0.device)
    _check("ext", ext, (Npad, kop.P1, B), a0.device)
    _check("mshift", mshift, (Npad, 1, B), a0.device)
    meta = _imeta(kop, kop.fwd)
    C = Npad // chunk
    new = lambda *shape: torch.empty(shape, device=a0.device,
                                     dtype=torch.float32)
    work, a_last = new(2, Sp, B), new(Sp, B)
    bounds, bscale = new(C, Sp, B), new(C, B)
    scale = torch.ones(B, device=a0.device)
    ksum, shift, comp = (torch.zeros(B, device=a0.device) for _ in range(3))
    part = new(2, int(meta[-1]), B)
    kd = kop.fwd
    with torch.cuda.device(a0.device):  # the library launches on it
        rc = _build.library().mm_block_fwd(
            _p(a0), _p(ext), _p(mshift), _p(kd.band_w), _p(kd.W),
            _p(kop.omega), _p(kd.band_rows), ctypes.c_void_p(meta.ctypes.data),
            B, Npad, chunk, _p(work), _p(a_last), _p(bounds), _p(bscale),
            _p(scale), _p(ksum), _p(shift), _p(comp), _p(part),
            _stream(a0.device),
        )
    _raise_on(rc, "mm_block_fwd")
    LAUNCHES["block_fwd"] += 1
    return bounds, bscale, a_last, scale, ksum, shift


def recompute(kop: KernelOp, bound, bscale, ext_c, t0: int):
    """K3: one chunk's forward frames from its checkpoint.  Same outputs
    as :func:`recompute_plain`."""
    if not _route(bound):
        return recompute_plain(kop, bound, bscale, ext_c, t0)
    from . import _build

    K, P1, B = ext_c.shape
    Sp = kop.Sp
    _check_op(kop, kop.fwd, bound.device)
    _check("bound", bound, (Sp, B), bound.device)
    _check("bscale", bscale, (B,), bound.device)
    _check("ext", ext_c, (K, kop.P1, B), bound.device)
    meta = _imeta(kop, kop.fwd)
    alphas = torch.empty((K, Sp, B), device=bound.device)
    ascale = torch.empty((K, B), device=bound.device)
    part = torch.empty((2, int(meta[-1]), B), device=bound.device)
    kd = kop.fwd
    with torch.cuda.device(bound.device):
        rc = _build.library().mm_block_recompute(
            _p(bound), _p(bscale), _p(ext_c), _p(kd.band_w), _p(kd.W),
            _p(kop.omega), _p(kd.band_rows), ctypes.c_void_p(meta.ctypes.data),
            B, t0, K, _p(alphas), _p(ascale), _p(part), _stream(bound.device),
        )
    _raise_on(rc, "mm_block_recompute")
    LAUNCHES["block_recompute"] += 1
    return alphas, ascale


def backward(kop: KernelOp, beta, bscale, alphas, ascale, ext_c, t0: int,
             npad: int):
    """K4: the reverse sweep over one chunk.  Same outputs as
    :func:`backward_plain`."""
    if not _route(beta):
        return backward_plain(kop, beta, bscale, alphas, ascale, ext_c, t0,
                              npad)
    from . import _build

    K, P1, B = ext_c.shape
    Sp = kop.Sp
    dev = beta.device
    _check_op(kop, kop.bwd, dev)
    _check("beta", beta, (Sp, B), dev)
    _check("bscale", bscale, (B,), dev)
    _check("alphas", alphas, (K, Sp, B), dev)
    _check("ascale", ascale, (K, B), dev)
    _check("ext", ext_c, (K, kop.P1, B), dev)
    meta = _imeta(kop, kop.bwd)
    posts = torch.zeros((K, kop.P1, B), device=dev)  # accumulated atomically
    work = torch.empty((2, Sp, B), device=dev)
    beta_out = torch.empty((Sp, B), device=dev)
    scale = bscale.clone()
    part = torch.empty((2, int(meta[-1]), B), device=dev)
    kd = kop.bwd
    with torch.cuda.device(dev):
        rc = _build.library().mm_block_bwd(
            _p(beta), _p(alphas), _p(ascale), _p(ext_c), _p(kd.band_w),
            _p(kd.W), _p(kop.omega), _p(kd.band_rows),
            ctypes.c_void_p(meta.ctypes.data), B, t0, K, npad, _p(work),
            _p(beta_out), _p(scale), _p(posts), _p(part), _stream(dev),
        )
    _raise_on(rc, "mm_block_bwd")
    LAUNCHES["block_bwd"] += 1
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
