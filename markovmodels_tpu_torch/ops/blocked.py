"""Blocked gather-matmul-scatter (GMS) operator for large sparse graphs.

PyTorch counterpart of ``markovmodels_tpu/ops/blocked.py``.  The lowering
itself is host numpy and mirrors the JAX package line for line, so both
packages build bit-identical operators from the same edge list:

* a **band** part: edge offsets (dst - src) shared by many states (HMM
  self-loops and chain arcs in the plane-major layout), applied as shifted
  elementwise multiply-adds;
* a **blocked** part: destinations tiled into blocks of 128, each block's
  union of sources gathered into a dense (Smax, 128) weight panel, so the
  update is a batched matrix product;
* a **residue**: edges of blocks with too many distinct sources, applied
  as a plain scatter-add.

``block_matvec(..., op_kind="max")`` is the tropical (max-product) form,
the matvec of the chunk-recompute Viterbi decode's plain sweep;
``block_matvec_max_arg`` adds the winning candidate id of every
destination, the matvec of the K7 sweep's plain twin (ops/vit_scan.py).

Weights are stored as probabilities.  With an overflow region (the capped
pdf-grouped layout ``compile_fsm`` gives a separate-state backoff graph),
the arcs touching it are lifted into structured **overflow families**
(lane-aligned source or destination columns and windows, see
``_fit_in_family``); ``block_matvec`` applies them in either mode, and
``block_matvec_max_arg(..., ov_span=)`` tracks their candidate ids in the
per-group encoding of ``_ov_cand_layout``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "BlockOperator",
    "build_block_operator",
    "block_matvec",
    "block_max_arg_supported",
    "block_max_arg_reason",
    "tier_dst_inverse",
    "block_matvec_max_arg",
    "family_grid",
    "round_bf16",
]


class BlockOperator(NamedTuple):
    """Edge-set parts as tensors; the static metadata (band offsets, tier
    descriptors, band extent) travels beside it as plain Python tuples."""

    band_w: Optional[torch.Tensor]  # (nOffsets, Sp) probabilities
    tiers: tuple  # of (src_idx (K, Sm), dst_idx (K, D), W (K, Sm, D))
    res_src: Optional[torch.Tensor]  # (R,)
    res_dst: Optional[torch.Tensor]
    res_w: Optional[torch.Tensor]
    ov_w: tuple = ()

    def to(self, device) -> "BlockOperator":
        mv = lambda t: None if t is None else t.to(device)
        return BlockOperator(
            band_w=mv(self.band_w),
            tiers=tuple(tuple(mv(x) for x in t) for t in self.tiers),
            res_src=mv(self.res_src),
            res_dst=mv(self.res_dst),
            res_w=mv(self.res_w),
            ov_w=tuple(mv(w) for w in self.ov_w),
        )


def _affine_params(idx: np.ndarray):
    """Return (base, dk, dm) if idx[k, m] == base + k*dk + m*dm, else None."""
    K, M = idx.shape
    base = int(idx[0, 0])
    dk = int(idx[1, 0] - idx[0, 0]) if K > 1 else 1
    dm = int(idx[0, 1] - idx[0, 0]) if M > 1 else 1
    expect = base + np.arange(K)[:, None] * dk + np.arange(M)[None, :] * dm
    return (base, dk, dm) if np.array_equal(idx, expect) else None


def _window(base, rows, stride, width, limit):
    """Fit the strided view x[base' : base' + rows*stride].reshape(rows,
    stride)[:, col0:col0+width] inside [0, limit): returns (base', col0) or
    None.  col0 shifts the window left when the naive view would overrun."""
    col0 = max(0, base + rows * stride - limit)
    base2 = base - col0
    if base2 >= 0 and col0 + width <= stride and base2 + rows * stride <= limit:
        return base2, col0
    return None


def _gather_desc(idx: np.ndarray, limit: int):
    """Classify a (K, Sm) gather index pattern:
      ('affine_k_major', base, dk, col0)  view (K, dk)[:, col0:col0+Sm]
      ('affine_s_major', base, ds, col0)  view (Sm, ds)[:, col0:col0+K] swap
      ('diag', base, dm)                  K == 1, arbitrary stride
      ('gather',)
    """
    p = _affine_params(idx)
    if p is not None:
        base, dk, dm = p
        K, Sm = idx.shape
        if dm == 1 and dk >= Sm and base >= 0:
            w = _window(base, K, dk, Sm, limit)
            if w is not None:
                return ("affine_k_major", w[0], dk, w[1])
        if dk == 1 and dm >= K and base >= 0:
            w = _window(base, Sm, dm, K, limit)
            if w is not None:
                return ("affine_s_major", w[0], dm, w[1])
        if K == 1 and dm > 1 and base >= 0 and base + (Sm - 1) * dm < limit:
            return ("diag", base, dm)
    return ("gather",)


def _scatter_desc(idx: np.ndarray, limit: int):
    """Classify a (K, D) scatter index pattern:
      ('contig', base)                  idx = base + k*D + d
      ('affine_d', base)                idx = base + k + d*K
      ('affine_k_pad', base, dk, col0)  view (K, dk)[:, col0:+D]
      ('affine_d_pad', base, dd, col0)  view (D, dd)[:, col0:+K] swap
      ('diag', base, dd)                K == 1, arbitrary stride
      ('scatter',)
    """
    p = _affine_params(idx)
    if p is not None:
        base, dk, dd = p
        K, D = idx.shape
        if dk == D and dd == 1 and 0 <= base and base + K * D <= limit:
            return ("contig", base)
        if dk == 1 and dd == K and 0 <= base and base + D * K <= limit:
            return ("affine_d", base)
        if dd == 1 and dk > D and base >= 0:
            w = _window(base, K, dk, D, limit)
            if w is not None:
                return ("affine_k_pad", w[0], dk, w[1])
        if dk == 1 and dd > K and base >= 0:
            w = _window(base, D, dd, K, limit)
            if w is not None:
                return ("affine_d_pad", w[0], dd, w[1])
        if K == 1 and dd > 1 and base >= 0 and base + (D - 1) * dd < limit:
            return ("diag", base, dd)
    return ("scatter",)


def _fit_in_family(srcs, lanes, w, block, Sp, dtype, max_col=512):
    """Fit the in-edges of one overflow lane-group (dst lane ``l`` receives
    from ``srcs``) into a structured family:

      ('col', base, stride, D): src = base + r·stride + l, r ∈ [0, D); a
          lane-aligned column of D source rows; W (D, block), W[r, l].
      ('win', base, stride, block): src ∈ [base + l·stride, +block); one
          contiguous source window per lane; W (block, block), W[l, pos].

    Returns (desc, W) or None (the edges then take the tier grouping)."""
    vals = srcs - lanes
    u = np.unique(vals)
    if len(u) <= max_col:
        d = np.diff(u)
        if len(u) == 1 or (d > 0).all() and (d == d[0]).all():
            stride = int(d[0]) if len(u) > 1 else 0
            base = int(u[0])
            if base >= 0 and base + (len(u) - 1) * stride + block <= Sp:
                r = np.searchsorted(u, vals)
                W = np.zeros((len(u), block), dtype=dtype)
                W[r, lanes] = w
                return ("col", base, stride, len(u)), W
    ul = np.unique(lanes)
    if len(ul) >= 2:
        order = np.lexsort((srcs, lanes))
        first = np.searchsorted(lanes[order], ul)
        mins = srcs[order][first]  # min src per present lane
        dl = int(ul[1] - ul[0])
        if (int(mins[1]) - int(mins[0])) % dl == 0:
            stride = (int(mins[1]) - int(mins[0])) // dl
            base = int(mins[0]) - int(ul[0]) * stride
            pos = srcs - (base + lanes * stride)
            if (
                stride > 0
                and base >= 0
                and (pos >= 0).all()
                and (pos < block).all()
                and base + (block - 1) * stride + block <= Sp
            ):
                W = np.zeros((block, block), dtype=dtype)
                W[lanes, pos] = w
                return ("win", base, stride, block), W
    return None


def _fit_out_family(dsts, lanes, w, block, Sp, dtype, max_col=512):
    """Mirror of :func:`_fit_in_family` for the out-edges of an overflow
    lane-group (src lane ``l`` feeds ``dsts``).  Called nowhere, in the
    JAX package either (``_fit_families`` fits both kinds with
    ``_fit_in_family``); kept so that this module mirrors that one."""
    return _fit_in_family(dsts, lanes, w, block, Sp, dtype, max_col)


def _fit_families(other, lanes, w, block, Sp, dtype):
    """Fit one lane-group's edges into 1-2 families: ([(desc, W)],
    leftover_mask).  When one fit fails, split by (other - lane) value
    multiplicity: column families repeat one value across most lanes,
    window families scatter them."""
    fam = _fit_in_family(other, lanes, w, block, Sp, dtype)
    if fam is not None:
        return [fam], np.zeros(len(other), dtype=bool)
    vals = other - lanes
    u, inv, cnt = np.unique(vals, return_inverse=True, return_counts=True)
    nlanes = max(len(np.unique(lanes)), 2)
    colish = cnt[inv] >= max(2, nlanes // 2)
    fams = []
    left = np.zeros(len(other), dtype=bool)
    for mask in (colish, ~colish):
        if not mask.any():
            continue
        f = _fit_in_family(other[mask], lanes[mask], w[mask], block, Sp,
                           dtype)
        if f is not None:
            fams.append(f)
        else:
            left |= mask
    return fams, left


def _ov_families(src, dst, w, ov_lo, ov_hi, block, Sp, dtype):
    """Classify the edges touching the overflow region [ov_lo, ov_hi) into
    per-group families.  Returns (descs, weights, leftover_mask,
    touching_mask); each desc is ('in'|'out', group_base, form, base,
    stride, D); leftover edges take the tier grouping."""
    descs, weights = [], []
    leftover = np.zeros(len(src), dtype=bool)
    is_in = (dst >= ov_lo) & (dst < ov_hi)
    is_out = (src >= ov_lo) & (src < ov_hi) & ~is_in
    for kind, mask, key, oth in (
        ("in", is_in, dst, src),
        ("out", is_out, src, dst),
    ):
        if not mask.any():
            continue
        for g in np.unique(key[mask] // block):
            g0 = int(g) * block
            sel = mask & (key >= g0) & (key < g0 + block)
            fams, left = _fit_families(
                oth[sel], key[sel] - g0, w[sel], block, Sp, dtype
            )
            for desc, W in fams:
                descs.append((kind, g0) + desc)
                weights.append(W)
            if left.any():
                idx = np.flatnonzero(sel)
                leftover[idx[left]] = True
    touching = is_in | is_out
    return descs, weights, leftover, touching


def family_grid(desc, block):
    """The core-side state of each weight of an overflow family, shaped as
    its W: 'col' (D, block) grid[r, l] = base + r·stride + l; 'win'
    (block, block) grid[l, j] = base + l·stride + j."""
    _, _, form, base, stride, D = desc
    lanes = np.arange(block)
    if form == "col":
        return base + np.arange(D)[:, None] * stride + lanes[None, :]
    return base + lanes[:, None] * stride + lanes[None, :]


_BLOCK = 128  # destination (or source) block width of the tiers
_TIER_SIZES = (128, 256, 512)  # panel heights a block's source set may take
_BAND_MAX = 8  # most shared offsets kept as bands


def build_block_operator(src, dst, w_log, num_states: int, *,
                         dtype=np.float32, ov_region=None):
    """Build (BlockOperator, meta) from a COO edge list of T̂, with
    meta = (band_offsets, tier_descs, band_nz_hi, ov_descs), weights in
    ``dtype`` (numpy float32 or float64: the graph's), and the JAX
    package's default block, tier and band sizes.

    ``w_log``: log-domain weights; stored as exp().  ``num_states``: padded
    state count Sp (multiple of 128).  ``ov_region``: optional (ov_lo,
    ov_hi, lane_w), the overflow slots of a capped layout and its lane-group
    width: arcs touching them become overflow families (``ov_w`` and
    ``meta[3]``) where they fit one, else take the tier grouping; band arcs
    cover the region like any other states.
    """
    block, tier_sizes, band_max = _BLOCK, _TIER_SIZES, _BAND_MAX
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.exp(np.asarray(w_log, dtype=np.float64)).astype(dtype)
    Sp = num_states
    assert Sp % block == 0

    # --- band extraction ------------------------------------------------
    offs = dst - src
    uniq, counts = np.unique(offs, return_counts=True)
    thresh = max(Sp // 8, 64)
    cand = uniq[counts >= thresh]
    if len(cand) > band_max:
        cand = cand[np.argsort(-counts[np.isin(uniq, cand)])][:band_max]
    band_offsets = tuple(int(o) for o in sorted(cand))
    in_band = np.isin(offs, cand) if band_offsets else np.zeros(len(offs), bool)

    band_w = None
    if band_offsets:
        band_w = np.zeros((len(band_offsets), Sp), dtype=dtype)
        omap = {o: i for i, o in enumerate(band_offsets)}
        bo = offs[in_band]
        bd = dst[in_band]
        bw = w[in_band]
        oi = np.array([omap[int(o)] for o in bo], dtype=np.int64)
        band_w[oi, bd] = bw

    src, dst, w = src[~in_band], dst[~in_band], w[~in_band]

    # --- overflow families ----------------------------------------------
    ov_descs, ov_weights = (), ()
    if ov_region is not None and len(src):
        ov_lo, ov_hi, lane_w = ov_region
        assert ov_lo % lane_w == 0
        ds, ws, leftover, touching = _ov_families(
            src, dst, w, ov_lo, ov_hi, lane_w, Sp, dtype
        )
        ov_descs, ov_weights = tuple(ds), tuple(ws)
        keep = ~touching | leftover
        src, dst, w = src[keep], dst[keep], w[keep]

    # --- blocked part ---------------------------------------------------
    def pad_unique(u, size):
        """Pad a sorted unique index list to ``size`` entries, continuing an
        affine stride with zero-weight slots when possible (keeps near-affine
        blocks on the affine descriptors), else zero padding."""
        out = np.zeros(size, dtype=np.int64)
        out[: len(u)] = u
        pad = size - len(u)
        if pad and len(u) >= 2:
            d = np.diff(u)
            if (d == d[0]).all() and d[0] > 0:
                ext = u[-1] + d[0] * np.arange(1, pad + 1)
                if ext[-1] < Sp:
                    out[len(u):] = ext
        return out

    def group(src, dst, w, by):
        """Tile edges into 128-wide blocks along ``by`` ('dst' grouped:
        dense (tier_srcs x block) panels; 'src' grouped: (block x tier_dsts)).
        Returns ({tier: [(sidx, didx, W)]}, overflow edges)."""
        key = dst if by == "dst" else src
        other = src if by == "dst" else dst
        order = np.lexsort((other, key))
        s, d, ww, kk, oo = (
            src[order], dst[order], w[order], key[order] // block,
            other[order],
        )
        acc = {}
        over = []
        starts = np.searchsorted(kk, np.arange(Sp // block))
        ends = np.searchsorted(kk, np.arange(Sp // block) + 1)
        for b in range(Sp // block):
            lo, hi = starts[b], ends[b]
            if lo == hi:
                continue
            uoth = np.unique(oo[lo:hi])
            # affine gap-fill onto the minimal grid anchored at the residue
            # class, only while it stays within the raw set's tier size
            if len(uoth) >= 2:
                du = np.diff(uoth)
                g = int(np.gcd.reduce(du))
                tier0 = next(
                    (t for t in tier_sizes if len(uoth) <= t), None
                )
                if g > 0 and tier0 is not None:
                    start = int(uoth[0]) % g
                    span = (int(uoth[-1]) - start) // g + 1
                    if span > len(uoth) and span <= tier0:
                        uoth = start + g * np.arange(span, dtype=np.int64)
            tier = next((t for t in tier_sizes if len(uoth) <= t), None)
            if tier is None:
                over.append((s[lo:hi], d[lo:hi], ww[lo:hi]))
                continue
            pos = np.searchsorted(uoth, oo[lo:hi])
            inblk = (key[order][lo:hi] - b * block).astype(np.int64)
            pad = tier - len(uoth)
            if pad and len(uoth) >= 2:
                du = np.diff(uoth)
                affine = (du == du[0]).all() and du[0] > 0
                if affine and uoth[-1] + du[0] * pad >= Sp:
                    # keep the exact length: an odd-width affine descriptor
                    # beats a zero-padded one that degrades to a gather
                    tier = len(uoth)
            upad = pad_unique(uoth, tier)
            acc.setdefault(tier, [])
            if by == "dst":
                W = np.zeros((tier, block), dtype=dtype)
                W[pos, inblk] = ww[lo:hi]
                sidx = upad.astype(np.int32)
                didx = (b * block + np.arange(block)).astype(np.int32)
            else:
                W = np.zeros((block, tier), dtype=dtype)
                W[inblk, pos] = ww[lo:hi]
                sidx = (b * block + np.arange(block)).astype(np.int32)
                didx = upad.astype(np.int32)
            acc[tier].append((sidx, didx, W))
        return acc, over

    def stack_tiers(accs):
        out = []
        for acc in accs:
            for t, items in acc.items():
                if not items:
                    continue
                out.append(
                    (
                        np.stack([x[0] for x in items]),
                        np.stack([x[1] for x in items]),
                        np.stack([x[2] for x in items]),
                    )
                )
        return out

    def all_affine(ts):
        return all(
            _gather_desc(sidx, Sp)[0] != "gather"
            and _scatter_desc(didx, Sp)[0] != "scatter"
            for sidx, didx, _ in ts
        )

    def majority_lane_split(esrc, edst, ew):
        """Mask of edges whose destination lane (dst % block) is their
        source block's modal lane: isolates the dominant structural family
        when mixed families destroy each other's affine patterns."""
        blk = esrc // block
        lane = edst % block
        pair = blk * block + lane
        up, cnt = np.unique(pair, return_counts=True)
        ub = up // block
        order = np.lexsort((-cnt, ub))
        first = np.searchsorted(ub[order], np.unique(ub))
        modal = {int(ub[order][f]): int(up[order][f] % block) for f in first}
        return np.array(
            [lane[i] == modal[int(blk[i])] for i in range(len(esrc))]
        )

    def dense_pool(esrc, edst, ew, max_side=512):
        """Collapse a small leftover edge family into one dense
        (1, Su, Du) tier.  Returns the tier or None."""
        us = np.unique(esrc)
        ud = np.unique(edst)
        if len(us) > max_side or len(ud) > max_side:
            return None
        ps = np.searchsorted(us, esrc)
        pd = np.searchsorted(ud, edst)
        W = np.zeros((1, len(us), len(ud)), dtype=dtype)
        W[0, ps, pd] = ew
        return (
            us[None, :].astype(np.int32),
            ud[None, :].astype(np.int32),
            W,
        )

    tiers_np = []
    res = []
    if len(src):
        acc_d, over = group(src, dst, w, "dst")
        tiers_np = stack_tiers([acc_d])
        if over:
            osrc = np.concatenate([o[0] for o in over])
            odst = np.concatenate([o[1] for o in over])
            ow = np.concatenate([o[2] for o in over])
            acc_s, over2 = group(osrc, odst, ow, "src")
            src_tiers = stack_tiers([acc_s])
            if not (all_affine(src_tiers) and not over2):
                maj = majority_lane_split(osrc, odst, ow)
                if maj.any() and not maj.all():
                    acc_m, over_m = group(osrc[maj], odst[maj], ow[maj],
                                          "src")
                    maj_tiers = stack_tiers([acc_m])
                    rest = (osrc[~maj], odst[~maj], ow[~maj])
                    pool = dense_pool(*rest)
                    if all_affine(maj_tiers) and not over_m and pool is not None:
                        src_tiers = maj_tiers + [pool]
                        over2 = []
            tiers_np.extend(src_tiers)
            res = over2

    tier_descs = tuple(
        (_gather_desc(sidx, Sp), _scatter_desc(didx, Sp))
        for sidx, didx, _ in tiers_np
    )
    tiers = tuple(
        (torch.from_numpy(s_), torch.from_numpy(d_), torch.from_numpy(W_))
        for s_, d_, W_ in tiers_np
    )

    res_src = res_dst = res_w = None
    if res:
        res_src = torch.from_numpy(
            np.concatenate([r[0] for r in res]).astype(np.int32))
        res_dst = torch.from_numpy(
            np.concatenate([r[1] for r in res]).astype(np.int32))
        res_w = torch.from_numpy(np.concatenate([r[2] for r in res]))

    # highest state row with any nonzero band weight + 1 (static metadata)
    band_nz_hi = 0
    if band_w is not None:
        nz = np.flatnonzero(band_w.any(axis=0))
        band_nz_hi = int(nz[-1]) + 1 if len(nz) else 0

    op = BlockOperator(
        band_w=torch.from_numpy(band_w) if band_w is not None else None,
        tiers=tiers,
        res_src=res_src,
        res_dst=res_dst,
        res_w=res_w,
        ov_w=tuple(torch.from_numpy(W_) for W_ in ov_weights),
    )
    return op, (band_offsets, tier_descs, band_nz_hi, ov_descs)


def round_bf16(x):
    """x rounded to bfloat16 (to nearest even) and back to float32: the
    operands of a bf16 tensor-core product, whose products are then exact
    in float32."""
    return x.to(torch.bfloat16).float()


def _tier_max(W, Xg):
    """Per (k, d, b): the largest product W[k, s, d]·Xg[k, s, b] over s,
    chunked over k so that the (k, Sm, D, B) products stay under
    _MAXARG_ELEMS (the JAX package's broadcast-max, which XLA fuses)."""
    K, Sm, D = W.shape
    B = Xg.shape[2]
    kc = max(1, _MAXARG_ELEMS // max(Sm * D * B, 1))
    return torch.cat([(W[k0 : k0 + kc, :, :, None]
                       * Xg[k0 : k0 + kc, :, None, :]).amax(dim=1)
                      for k0 in range(0, K, kc)])


def _scatter(y, idx, src, op_kind):
    """y[idx] ⊕= src row by row: a sum, or the max (tropical)."""
    if op_kind == "max":
        return y.scatter_reduce_(0, idx[:, None].expand_as(src), src, "amax")
    return y.index_add_(0, idx, src)


def block_matvec(op: BlockOperator, meta, x, *, bf16: bool = False,
                 op_kind: str = "sum"):
    """Probability-domain y = T̂ᵀ ⊗ x (or T̂ ⊗ x for the reversed operator):
    y[j, b] = ⊕_e w[e] · x[src[e], b] over the op's edges.  x: (Sp, B).

    ``meta``: (band_offsets, tier_descs, band_nz_hi, ov_descs) from
    build_block_operator.  ``op_kind``: 'sum' (the probability semiring) or
    'max' (the tropical semiring in the probability domain: every tier,
    band, residue and overflow-family term combined by max, the JAX
    package's ``op_kind="max"``).  The tier contraction runs in the
    dtype of the operator and ``x`` (float64 throughout for a float64
    graph), float32 in full (the caller keeps
    ``torch.backends.cuda.matmul.allow_tf32`` off on the GPU); with
    ``bf16`` (a ``precision='bf16'`` graph, sum only) its
    two operands, the panels and the gathered rows, are rounded to bf16
    first, as the kernels' tensor-core tier does (ops/block_scan.py
    ``_matvec_plain``).
    """
    if op_kind not in ("sum", "max"):
        raise ValueError(f"op_kind {op_kind!r} is neither 'sum' nor 'max'")
    if bf16 and op_kind == "max":
        raise ValueError("the tropical matvec takes float32 operands only")
    trop = op_kind == "max"
    combine = torch.maximum if trop else torch.add
    band_offsets, tier_descs = meta[0], meta[1]
    Sp, B = x.shape
    y = torch.zeros_like(x)
    if op.band_w is not None:
        for oi, off in enumerate(band_offsets):
            # band edge src = dst - off; wrapped rolls hit zero weights
            xs = x if off == 0 else torch.roll(x, off, dims=0)
            y = combine(y, op.band_w[oi][:, None] * xs)
    for (sidx, didx, W), (gdesc, ddesc) in zip(op.tiers, tier_descs):
        K, Sm = sidx.shape
        D = didx.shape[1]
        if gdesc[0] == "affine_s_major":
            _, base, ds, c0 = gdesc
            view = x[base : base + Sm * ds]
            Xg = view.reshape(Sm, ds, B)[:, c0 : c0 + K].transpose(0, 1)
        elif gdesc[0] == "affine_k_major":
            _, base, dk, c0 = gdesc
            view = x[base : base + K * dk]
            Xg = view.reshape(K, dk, B)[:, c0 : c0 + Sm]
        else:
            Xg = x[sidx.reshape(-1).long()].reshape(K, Sm, B)
        if bf16:
            W, Xg = round_bf16(W), round_bf16(Xg)
        Y = _tier_max(W, Xg) if trop else torch.einsum("ksd,ksb->kdb", W, Xg)
        if ddesc[0] == "contig":
            base = ddesc[1]
            sl = y[base : base + K * D]
            sl.copy_(combine(sl, Y.reshape(-1, B)))
        elif ddesc[0] == "affine_d":
            base = ddesc[1]
            sl = y[base : base + K * D]
            sl.copy_(combine(sl, Y.transpose(0, 1).reshape(-1, B)))
        elif ddesc[0] in ("affine_k_pad", "affine_d_pad"):
            # strided row-chunks: a column window of a (rows, stride, B)
            # view of y, updated in place
            _, base, stride, c0 = ddesc
            if ddesc[0] == "affine_k_pad":
                rows, width, Yv = K, D, Y
            else:
                rows, width, Yv = D, K, Y.transpose(0, 1)
            seg = y[base : base + rows * stride].view(rows, stride, B)
            win = seg[:, c0 : c0 + width]
            win.copy_(combine(win, Yv))
        else:
            _scatter(y, didx.reshape(-1).long(), Y.reshape(-1, B), op_kind)
    if op.res_src is not None:
        contrib = op.res_w[:, None] * x[op.res_src.long()]
        _scatter(y, op.res_dst.long(), contrib, op_kind)
    # overflow families: 'in' sums a column or a window into each lane of
    # the group, 'out' scatters each lane of the group into its column or
    # window
    ov_descs = meta[3] if len(meta) > 3 else ()
    for desc, W in zip(ov_descs, op.ov_w):
        kind, g0, form = desc[:3]
        block = W.shape[-1]
        grid = torch.from_numpy(family_grid(desc, block)).to(x.device)
        if kind == "in":
            prod = W[:, :, None] * x[grid.reshape(-1)].reshape(
                grid.shape + (B,))
            dim = 0 if form == "col" else 1
            red = prod.amax(dim=dim) if trop else prod.sum(dim=dim)
            sl = y[g0 : g0 + block]
            sl.copy_(combine(sl, red))
        else:
            xg = x[g0 : g0 + block]  # (block, B)
            # 'col': y[base + r·stride + l] ⊕= W[r, l] · x[g0 + l]
            # 'win': y[base + l·stride + j] ⊕= W[l, j] · x[g0 + l]
            xb = xg[None, :, :] if form == "col" else xg[:, None, :]
            _scatter(y, grid.reshape(-1),
                     (W[:, :, None] * xb).reshape(-1, B), op_kind)
    return y


# ---------------------------------------------------------------------------
# tropical matvec with winning-candidate ids (the Viterbi bp sweep)
# ---------------------------------------------------------------------------

_SCATTER_WINDOWS = ("contig", "affine_d", "affine_k_pad", "affine_d_pad")
_NO_CAND = 255  # candidate id of a destination without incoming mass
_MAXARG_ELEMS = 1 << 25  # (k, Sm, D, B) products per tier chunk


def _ov_cand_layout(meta, ov_lo, cmax, ov_hi=None):
    """The candidate-id layout of the overflow groups in the uint8 id
    stream (the JAX package's ``_ov_cand_layout``).  Overflow destinations
    take no tier and no out-family candidate, so their id space starts at
    0: each group's 'in' families take consecutive ranges [cum, cum +
    size) in descriptor order (size cmax for a window, D for a column),
    and the band offsets follow at [C_g, C_g + nO).  Returns ({group base:
    [(desc, cum), ...]}, {group base: C_g}).

    Unlike the JAX package, which ignores ``ov_lo`` here, every 'in'
    family's group must lie in the overflow rows [ov_lo, ov_hi) (no upper
    bound when ``ov_hi`` is None): ValueError otherwise."""
    fam, csize = {}, {}
    for desc in (meta[3] if len(meta) > 3 else ()):
        kind, g0, form, base, stride, D = desc
        if kind != "in":
            continue
        if g0 < ov_lo or (ov_hi is not None and g0 + cmax > ov_hi):
            raise ValueError(f"'in' family group {g0} outside the overflow "
                             f"rows [{ov_lo}, {ov_hi})")
        cum = csize.get(g0, 0)
        fam.setdefault(g0, []).append((desc, cum))
        csize[g0] = cum + (cmax if form == "win" else D)
    return fam, csize


def block_max_arg_reason(op: BlockOperator, meta, ov_lo=None, cmax=None,
                         ov_hi=None, *, ids: bool = True):
    """None when block_matvec_max_arg can run, else the first predicate
    that fails: one tier, no residue, a window-expressible scatter (to
    track the winning candidate), and every candidate id fitting a uint8
    below the 255 'none' marker.

    With overflow families (``ov_lo`` / ``cmax`` from the compile's
    ov_layout; the JAX package's predicates in its order): core
    destinations encode tier [0, Sm) + bands [Sm, Sm + nO) + one
    out-family id Sm + nO, so Sm + nO + 1 < 255; the tier writes no
    overflow row; every group's in-families and bands fit, C_g + nO < 255
    (``_ov_cand_layout``); and no destination takes two out-family
    candidates, across families or within one.  Two predicates are the
    port's own: every 'in' group lies in [ov_lo, ov_hi) (the JAX package
    ignores ``ov_lo`` there), and every out-family destination is a core
    row (below ``ov_lo``: on an overflow row the id Sm + nO would fall in
    that group's in-family range, where the walk would decode it to a
    bogus source).  ``ids=False`` (the id-free sweep K7n) skips the
    predicates on the ids' range."""
    if op.res_src is not None:
        return "residue edges present"
    if len(op.tiers) != 1:
        return f"{len(op.tiers)} tiers (candidate ids need exactly 1)"
    _, ddesc = meta[1][0]
    if ddesc[0] not in _SCATTER_WINDOWS:
        return f"tier scatter {ddesc[0]!r} not window-expressible"
    Sm = op.tiers[0][0].shape[1]
    nO = len(meta[0])
    if not op.ov_w:
        if ids and Sm + nO >= _NO_CAND:
            return (f"tier width {Sm} + {nO} band offsets: candidate ids do "
                    "not fit a uint8")
        return None
    if ov_lo is None or cmax is None:
        return "overflow families without the layout's ov_lo and cmax"
    if ids and Sm + nO + 1 >= _NO_CAND:
        return (f"tier width {Sm} + {nO} band offsets + the out-family id: "
                "candidate ids do not fit a uint8")
    if int(op.tiers[0][1].max()) >= ov_lo:
        return "the tier writes an overflow row"
    descs = meta[3]
    for d in descs:
        if d[0] == "in" and (d[1] < ov_lo or (ov_hi is not None
                                               and d[1] + cmax > ov_hi)):
            return (f"'in' family group {d[1]} outside the overflow rows "
                    f"[{ov_lo}, {ov_hi})")
    _, csize = _ov_cand_layout(meta, ov_lo, cmax, ov_hi)
    big = [g for g, C in csize.items() if C + nO >= _NO_CAND]
    if ids and big:
        return (f"overflow group {big[0]}: {csize[big[0]]} in-family + {nO} "
                "band candidates do not fit a uint8")
    dsts = [family_grid(d, cmax).ravel() for d in descs if d[0] == "out"]
    if dsts:
        dsts = np.concatenate(dsts)  # within one family and across them
        if len(np.unique(dsts)) != len(dsts):
            return "a destination takes two out-family candidates"
        if dsts.max() >= ov_lo:
            return "an out-family writes an overflow row"
    return None


def block_max_arg_supported(op: BlockOperator, meta, ov_lo=None, cmax=None,
                            ov_hi=None) -> bool:
    """True when block_matvec_max_arg can run (the JAX package's
    predicate; :func:`block_max_arg_reason` names the first that fails).
    A graph it refuses takes the chunk-recompute decode."""
    return block_max_arg_reason(op, meta, ov_lo, cmax, ov_hi) is None


def tier_dst_inverse(op: BlockOperator, num_states: int) -> np.ndarray:
    """Host-side inverse of the single tier's destination map: k_of[d] =
    the tier block writing state d (-1 if none).  Used by the backpointer
    decode (src = sidx[k_of[d], cand])."""
    didx = op.tiers[0][1]
    didx = (didx.cpu().numpy() if isinstance(didx, torch.Tensor)
            else np.asarray(didx))
    k_of = np.full(num_states, -1, dtype=np.int32)
    K, D = didx.shape
    k_of[didx.reshape(-1)] = np.repeat(np.arange(K, dtype=np.int32), D)
    return k_of


def _tier_max_arg(W, Xg):
    """Per (k, d, b): the largest product W[k, s, d]·Xg[k, s, b] over s and
    the SMALLEST s attaining it (the CUDA kernel's tie rule).  Chunked over
    k so that the (k, Sm, D, B) products stay under _MAXARG_ELEMS."""
    K, Sm, D = W.shape
    B = Xg.shape[2]
    kc = max(1, _MAXARG_ELEMS // max(Sm * D * B, 1))
    s_ids = torch.arange(Sm, dtype=torch.int32, device=Xg.device)
    s_ids = s_ids.view(1, Sm, 1, 1)
    Y = Xg.new_empty((K, D, B))
    A = torch.empty((K, D, B), dtype=torch.int32, device=Xg.device)
    for k0 in range(0, K, kc):
        prod = W[k0 : k0 + kc, :, :, None] * Xg[k0 : k0 + kc, :, None, :]
        y = prod.amax(dim=1)
        Y[k0 : k0 + kc] = y
        A[k0 : k0 + kc] = torch.where(prod == y[:, None], s_ids,
                                      Sm).amin(dim=1)
    return Y, A


def block_matvec_max_arg(op: BlockOperator, meta, x, ov_span=None):
    """Tropical y = T̂ᵀ ⊗max x with per-destination winning-candidate ids.

    Returns (y (Sp, B), cand (Sp, B) int32): cand < Sm is a tier source
    position (src = sidx[k_of[dst], cand]); Sm <= cand < Sm + nO is a band
    offset index (src = dst - band_offsets[cand - Sm]); 255 = no incoming
    mass.  Requires block_max_arg_supported.  The rank-1 ω column (phony
    final state) is NOT applied here: the decoder resolves it separately.

    ``ov_span`` = (ov_lo, nOv, cmax) takes the overflow families (required
    when the operator has them): a core destination's out-family candidate
    is Sm + nO; an overflow destination of group g takes the group's own
    encoding (``_ov_cand_layout``): its in-families at [0, C_g) in
    descriptor order (cum + the column row r, or cum + the window position
    j), its bands at C_g + oi.  The ids are written in this final encoding
    (the JAX package stages in-family ids above 255 and remaps them after
    the sweep's matvec: the same ids).

    Ties follow the CUDA kernel (K7), not XLA's reduction order: bands in
    offset order with a strict >, within the tier the smallest source
    position among equal maxima, the tier merged into the bands with a
    strict > (so a zero column keeps 255), then the families in
    descriptor order, each merged with a strict >, with the smallest index
    within a family.
    """
    band_offsets, tier_descs = meta[0], meta[1]
    if op.ov_w and ov_span is None:
        raise ValueError(
            "operator has overflow families; pass ov_span=(ov_lo, nOv, "
            "cmax) or their contributions would be silently dropped")
    Sp, B = x.shape
    sidx, didx, W = op.tiers[0]
    gdesc, ddesc = tier_descs[0]
    K, Sm = sidx.shape
    D = didx.shape[1]

    y = torch.zeros_like(x)
    cand = torch.full((Sp, B), _NO_CAND, dtype=torch.int32, device=x.device)
    if op.band_w is not None:
        for oi, off in enumerate(band_offsets):
            # band edge src = dst - off; wrapped rolls hit zero weights
            xs = x if off == 0 else torch.roll(x, off, dims=0)
            prod = op.band_w[oi][:, None] * xs
            upd = prod > y
            y = torch.where(upd, prod, y)
            cand = torch.where(upd, torch.full_like(cand, Sm + oi), cand)

    # tier gather (affine views when available, as block_matvec)
    if gdesc[0] == "affine_s_major":
        _, base, ds, c0 = gdesc
        view = x[base : base + Sm * ds]
        Xg = view.reshape(Sm, ds, B)[:, c0 : c0 + K].transpose(0, 1)
    elif gdesc[0] == "affine_k_major":
        _, base, dk, c0 = gdesc
        view = x[base : base + K * dk]
        Xg = view.reshape(K, dk, B)[:, c0 : c0 + Sm]
    else:
        Xg = x[sidx.reshape(-1).long()].reshape(K, Sm, B)
    Y, A = _tier_max_arg(W, Xg)

    # tier merge of (value, cand) through the affine window, strict >
    if ddesc[0] in ("contig", "affine_d"):
        base = ddesc[1]
        if ddesc[0] == "affine_d":
            Y, A = Y.transpose(0, 1), A.transpose(0, 1)
        win_y = y[base : base + K * D]
        win_c = cand[base : base + K * D]
        Yv, Av = Y.reshape(-1, B), A.reshape(-1, B)
    else:  # affine_k_pad / affine_d_pad: strided row-chunk window
        _, base, stride, c0 = ddesc
        if ddesc[0] == "affine_k_pad":
            rows, width, Yv, Av = K, D, Y, A
        else:
            rows, width, Yv, Av = D, K, Y.transpose(0, 1), A.transpose(0, 1)
        win_y = y[base : base + rows * stride].view(rows, stride, B)[
            :, c0 : c0 + width]
        win_c = cand[base : base + rows * stride].view(rows, stride, B)[
            :, c0 : c0 + width]
    sel = Yv > win_y
    win_y.copy_(torch.where(sel, Yv, win_y))
    win_c.copy_(torch.where(sel, Av, win_c))
    if ov_span is not None and op.ov_w:
        _ov_max_arg(op, meta, x, y, cand, ov_span, Sm)
    return y, cand


def _ov_max_arg(op, meta, x, y, cand, ov_span, Sm):
    """The overflow families of :func:`block_matvec_max_arg`, in place:
    first the overflow groups' band ids moved to C_g + oi (the tier writes
    no overflow row), then each family in descriptor order."""
    ov_lo, nOv, cmax = ov_span
    nO = len(meta[0])
    fam, csize = _ov_cand_layout(meta, ov_lo, cmax, ov_lo + nOv * cmax)
    for gi in range(nOv):
        g0 = ov_lo + gi * cmax
        seg = cand[g0 : g0 + cmax]
        band = (seg >= Sm) & (seg < Sm + nO)
        seg.copy_(torch.where(band, seg - Sm + csize.get(g0, 0), seg))
    B = x.shape[1]
    cum = {}
    for desc, W in zip(meta[3], op.ov_w):
        kind, g0, form = desc[:3]
        grid = torch.from_numpy(family_grid(desc, cmax)).to(x.device)
        if kind == "in":
            id0 = cum.get(g0, 0)
            cum[g0] = id0 + (cmax if form == "win" else desc[5])
            prod = W[:, :, None] * x[grid.reshape(-1)].reshape(
                grid.shape + (B,))
            dim = 0 if form == "col" else 1  # the column's r, the window's j
            val = prod.amax(dim=dim)
            idx = torch.arange(prod.shape[dim], dtype=torch.int32,
                               device=x.device)
            idx = idx.view((-1, 1, 1) if dim == 0 else (1, -1, 1))
            arg = torch.where(prod == val.unsqueeze(dim), idx,
                              prod.shape[dim]).amin(dim=dim)
            cur, curc = y[g0 : g0 + cmax], cand[g0 : g0 + cmax]
            sel = val > cur
            cur.copy_(torch.where(sel, val, cur))
            curc.copy_(torch.where(sel, id0 + arg, curc))
        else:
            xg = x[g0 : g0 + cmax]  # (block, B)
            # 'col': y[base + r·stride + l] ⊕= W[r, l] · x[g0 + l]
            # 'win': y[base + l·stride + j] ⊕= W[l, j] · x[g0 + l]
            xb = xg[None, :, :] if form == "col" else xg[:, None, :]
            flat = (W[:, :, None] * xb).reshape(-1, B)
            dst = grid.reshape(-1)
            sel = flat > y[dst]
            y[dst] = torch.where(sel, flat, y[dst])
            cand[dst] = torch.where(sel, Sm + nO, cand[dst])
